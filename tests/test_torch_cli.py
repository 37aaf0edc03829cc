"""The port's CLI (``libflate_tpu_torch.cli.main``, in process) against
the reference's (``libflate_tpu.cli.main``) on the same files.

``--engine serial`` and ``--stream`` encodes are byte-identical to the
reference CLI's (``--engine serial``; its ``--stream`` encoders are the
serial ``BlockStreamer``); decodes give the reference's plaintext.
``--engine cpu`` runs the device paths on CPU tensors and equals the
port's own one-shots, which ``test_torch_containers.py`` holds to the
reference.  Errors are one line from ``run()``.
"""
import gzip
import sys
import zlib

import numpy as np
import pytest

from libflate_tpu import cli as ref_cli
from libflate_tpu_torch import cli as port_cli
from libflate_tpu_torch.formats import gzip as port_gzip
from libflate_tpu_torch.formats import pgzf as port_pgzf
from libflate_tpu_torch.formats import zlib as port_zlib


def _data() -> bytes:
    rng = np.random.default_rng(21)
    words = [bytes(rng.integers(97, 123, rng.integers(2, 8), dtype=np.uint8))
             for _ in range(60)]
    return b" ".join(words[int(i)] for i in rng.zipf(1.4, 2500) % 60)[:6000]


DATA = _data()
SERIAL_ENCODES = [["gzip-encode"], ["zlib-encode"],
                  ["pgzf-encode", "--member-size", "2048"]]


@pytest.fixture
def files(tmp_path):
    src = tmp_path / "in.txt"
    src.write_bytes(DATA)
    return tmp_path, src


def _run(main, args, out):
    assert main(args + []) == 0
    return out.read_bytes()


@pytest.mark.parametrize("cmd", SERIAL_ENCODES, ids=lambda c: c[0])
def test_serial_encodes_match_reference_cli(files, cmd):
    tmp, src = files
    got = _run(port_cli.main, ["-i", str(src), "-o", str(tmp / "p"),
                               "--engine", "serial"] + cmd, tmp / "p")
    want = _run(ref_cli.main, ["-i", str(src), "-o", str(tmp / "r"),
                               "--engine", "serial"] + cmd, tmp / "r")
    assert got == want
    back = zlib.decompress(got) if cmd[0] == "zlib-encode" else \
        gzip.decompress(got)
    assert back == DATA


@pytest.mark.parametrize("cmd", ["gzip-encode", "zlib-encode"])
def test_stream_encodes_match_reference_cli(files, cmd):
    tmp, src = files
    got = _run(port_cli.main, ["-i", str(src), "-o", str(tmp / "p"),
                               "--engine", "serial", "--stream", cmd],
               tmp / "p")
    want = _run(ref_cli.main, ["-i", str(src), "-o", str(tmp / "r"),
                               "--stream", cmd], tmp / "r")
    assert got == want


@pytest.mark.parametrize("stream", [False, True])
@pytest.mark.parametrize("cmd", ["gzip-decode", "gzip-decode-multi",
                                 "zlib-decode"])
def test_decodes_match_reference_cli(files, cmd, stream):
    """Two gzip members (the single-member decoders read the first), a
    zlib stream; ``--stream`` through the chunked decoders."""
    tmp, src = files
    packed = tmp / "packed"
    if cmd.startswith("gzip"):
        packed.write_bytes(gzip.compress(DATA) + gzip.compress(DATA[:99]))
    else:
        packed.write_bytes(zlib.compress(DATA))
    extra = ["--stream"] if stream else []
    got = _run(port_cli.main, ["-i", str(packed), "-o", str(tmp / "p"),
                               "--engine", "serial"] + extra + [cmd],
               tmp / "p")
    want = _run(ref_cli.main, ["-i", str(packed), "-o", str(tmp / "r"),
                               "--engine", "serial"] + extra + [cmd],
                tmp / "r")
    assert got == want
    assert got == (DATA + DATA[:99] if cmd.endswith("multi") else DATA)


def test_cpu_engine_equals_the_one_shots(tmp_path):
    """gzip and zlib encodes on the cpu engine equal the port's one-shot
    (the zlib body is the gzip member's); the pgzf encode carries the LS
    index and stdlib gzip reads it; gzip-decode and pgzf-decode give the
    plaintext back."""
    data = DATA[:2000]
    src = tmp_path / "in"
    src.write_bytes(data)
    base = ["-i", str(src), "--engine", "cpu"]
    gz = _run(port_cli.main, base + ["-o", str(tmp_path / "g"),
                                     "gzip-encode"], tmp_path / "g")
    assert gz == port_gzip.compress(data, engine="cpu")
    zs = _run(port_cli.main, base + ["-o", str(tmp_path / "z"),
                                     "zlib-encode"], tmp_path / "z")
    assert zs[2:-4] == gz[10:-8] and zlib.decompress(zs) == data
    pg = _run(port_cli.main, base + ["-o", str(tmp_path / "f"),
                                     "pgzf-encode", "--member-size", "1024"],
              tmp_path / "f")
    assert gzip.decompress(pg) == data
    assert port_pgzf.index_members(pg) is not None and b"LS" in pg[:64]
    for packed, cmd in ((tmp_path / "g", "gzip-decode"),
                        (tmp_path / "f", "pgzf-decode")):
        got = _run(port_cli.main, ["-i", str(packed), "-o",
                                   str(tmp_path / "o"), "--engine", "cpu",
                                   cmd], tmp_path / "o")
        assert got == data


def test_serial_pgzf_decode_and_copy(files):
    tmp, src = files
    packed = tmp / "f"
    packed.write_bytes(port_pgzf.compress(DATA, 2048, engine="serial"))
    assert _run(port_cli.main, ["-i", str(packed), "-o", str(tmp / "o"),
                                "--engine", "serial", "pgzf-decode"],
                tmp / "o") == DATA
    assert _run(port_cli.main, ["-i", str(src), "-o", str(tmp / "c"),
                                "copy"], tmp / "c") == DATA


@pytest.mark.parametrize("case", ["bogus_engine", "corrupt", "not_gzip"])
def test_run_reports_errors_in_one_line(files, case, monkeypatch, capsys):
    tmp, src = files
    bad = tmp / "bad"
    gz = bytearray(gzip.compress(DATA))
    gz[-6] ^= 1
    bad.write_bytes(bytes(gz) if case == "corrupt" else DATA)
    args = {"bogus_engine": ["-i", str(src), "--engine", "bogus",
                             "gzip-encode"],
            "corrupt": ["-i", str(bad), "--engine", "serial", "gzip-decode"],
            "not_gzip": ["-i", str(bad), "--engine", "serial",
                         "gzip-decode"]}[case]
    codes = []
    for mod in (port_cli, ref_cli):
        monkeypatch.setattr(sys, "argv", ["prog", "-o", str(tmp / "o")]
                            + args)
        codes.append(mod.run())
        err = capsys.readouterr().err.strip().splitlines()
        assert len(err) == 1 and err[0].startswith("error: ")
    assert codes == [1, 1]
