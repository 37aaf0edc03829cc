"""The port's whole decode slice vs the reference and stdlib gzip.

``decompress_to_device(device="cpu")`` runs every kernel's plain
version.  It is held against the reference's ``_run_sync_chain`` (Pallas
interpret mode, once per module) on the small fixture, fed identical
state through ``convert.from_reference_group``, and against stdlib gzip
on both committed fixtures.  Also: the fixtures themselves, the error
cases, the CUDA guard, and an import of the whole package with JAX
blocked.
"""
import gzip
import hashlib
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from libflate_tpu_torch.formats.gzip import GzipError  # noqa: E402
from libflate_tpu_torch import convert  # noqa: E402
from libflate_tpu_torch.formats import pgzf as port  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
DATA = ROOT / "tests" / "data"
FIXTURES = ["pgzf_sync_zipf_small.pgz", "pgzf_sync_zipf_2m.pgz"]


@pytest.fixture(scope="module")
def interpret():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LIBFLATE_PALLAS_INTERPRET", "1")
        yield


@pytest.fixture(scope="module")
def small():
    return (DATA / FIXTURES[0]).read_bytes()


@pytest.fixture(scope="module")
def ref_chain(interpret, small):
    """The reference's group and its (plain, n_out, err, crc_f)."""
    from libflate_tpu.formats import pgzf as ref_pgzf
    (prep,) = ref_pgzf._prepare_sync_device(small)
    return prep, tuple(np.asarray(a) for a in
                       ref_pgzf._run_sync_chain(prep))


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_is_gzip_and_sync_indexed(name):
    from libflate_tpu.formats import pgzf as ref_pgzf
    data = (DATA / name).read_bytes()
    assert len(gzip.decompress(data)) > 0
    groups = ref_pgzf._prepare_sync_device(data)
    assert groups and all(g["k_tok"] == 256 for g in groups)
    script = (ROOT / "scripts" / "make_pgzf_sync_fixture.py").read_text()
    assert hashlib.sha256(data).hexdigest() in script


def test_chain_matches_reference(ref_chain):
    prep, (w_plain, w_n, w_err, w_crc) = ref_chain
    plain, n_out, err, crc_f = port._run_sync_chain(
        convert.from_reference_group(prep))
    assert plain.dtype == torch.uint8
    assert plain.shape == (prep["bsz"], prep["member_cap"])
    np.testing.assert_array_equal(plain.numpy(), w_plain)
    np.testing.assert_array_equal(n_out.numpy(), w_n)
    np.testing.assert_array_equal(err.numpy(), w_err)
    np.testing.assert_array_equal(crc_f.numpy(), w_crc)


def test_port_staging_chain_matches_reference(ref_chain, small):
    _prep, (w_plain, w_n, w_err, w_crc) = ref_chain
    (g,) = port._prepare_sync_device(small, "cpu")
    plain, n_out, err, crc_f = port._run_sync_chain(g)
    np.testing.assert_array_equal(plain.numpy(), w_plain)
    np.testing.assert_array_equal(crc_f.numpy(), w_crc)


@pytest.mark.parametrize("name", FIXTURES)
def test_decompress_to_device_cpu_matches_gzip(name):
    data = (DATA / name).read_bytes()
    out, lengths = port.decompress_to_device(data, verify=True,
                                             device="cpu")
    assert out.device.type == lengths.device.type == "cpu"
    assert out.dtype == torch.uint8 and lengths.dtype == torch.int32
    live = torch.arange(out.shape[1])[None, :] < lengths[:, None]
    assert out[live].numpy().tobytes() == gzip.decompress(data)
    assert not out[~live].any()


def test_groups_with_different_tables_are_joined(small):
    """Two streams with different tables decode as two groups, padded
    to one member_cap and concatenated."""
    big = (DATA / FIXTURES[1]).read_bytes()
    data = small + big[:port.index_members(big)[1].end]
    assert len(port._prepare_sync_device(data, "cpu")) == 2
    out, lengths = port.decompress_to_device(data, verify=True,
                                             device="cpu")
    assert out.shape == (6, 65536)
    live = torch.arange(out.shape[1])[None, :] < lengths[:, None]
    assert out[live].numpy().tobytes() == gzip.decompress(data)


def test_crc_mismatch_raises(small):
    bad = bytearray(small)
    end = port.index_members(small)[0].end
    bad[end - 8] ^= 1                     # first member's CRC trailer
    with pytest.raises(GzipError, match="member 0"):
        port.decompress_to_device(bytes(bad), verify=True, device="cpu")
    port.decompress_to_device(bytes(bad), verify=False, device="cpu")


def test_stream_without_sync_index_is_not_ported():
    """Streams without the LS index that the speculative path does not
    take either (the name is from before the foreign-stream path was
    ported) now decode as the reference decodes them, through
    ``_foreign_to_device``: the reference's native-engine PGZF (LF index,
    per-member tables) and stdlib gzip, into rows of the next power of two
    (at least 1024) of the largest member; the empty stream raises the
    reference's ValueError."""
    from libflate_tpu import native
    from libflate_tpu.formats import pgzf as ref_pgzf
    if not native.available():
        pytest.skip("native engine unavailable")
    stream = ref_pgzf.compress(b"abc" * 5000, member_size=4096,
                               engine="native")
    for data, shape in ((stream, (4, 4096)),
                        (gzip.compress(b"abc"), (1, 1024))):
        out, lengths = port.decompress_to_device(data, verify=True,
                                                 device="cpu")
        plain = gzip.decompress(data)
        assert out.shape == shape and int(lengths.sum()) == len(plain)
        live = torch.arange(out.shape[1])[None, :] < lengths[:, None]
        assert out[live].numpy().tobytes() == plain
    with pytest.raises(ValueError):
        port.decompress_to_device(b"", device="cpu")


def test_cuda_device_without_cuda_raises(monkeypatch, small):
    """No silent CPU fallback: device="cuda" needs CUDA."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    called = []
    monkeypatch.setattr(port, "_prepare_sync_device",
                        lambda *a: called.append(a))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.decompress_to_device(small, device="cuda")
    assert not called


_NO_JAX = """
import importlib, pkgutil, sys
class _Block:
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "libflate_tpu"):
            raise ImportError(f"{top} is blocked")
sys.meta_path.insert(0, _Block())
import libflate_tpu_torch as pkg
mods = [m.name for m in
        pkgutil.walk_packages(pkg.__path__, "libflate_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
from libflate_tpu_torch.formats import pgzf
stream = open(sys.argv[1], "rb").read()
out, lengths = pgzf.decompress_to_device(stream, verify=True, device="cpu")
import torch
spec_out, spec_len = pgzf.decompress_to_device(
    chip_smoke.strip_sync_index(stream), verify=True, device="cpu")
assert torch.equal(spec_out, out) and torch.equal(spec_len, lengths)
data = bytes(range(256)) * 8 + b"abc" * 2000
import gzip
assert gzip.decompress(pgzf.compress(data, 1024, device="cpu")) == data
# host output through the sync and generic branches, and inflate_device
import os, zlib
assert pgzf.decompress(stream, device="cpu") == gzip.decompress(stream)
os.environ["LIBFLATE_NO_SYNC"] = os.environ["LIBFLATE_NO_SPEC"] = "1"
assert pgzf.decompress(stream, device="cpu") == gzip.decompress(stream)
del os.environ["LIBFLATE_NO_SYNC"], os.environ["LIBFLATE_NO_SPEC"]
from libflate_tpu_torch.ops.deflate_decode import inflate_device
raw = zlib.compressobj(6, zlib.DEFLATED, -15, 1)
raw = raw.compress(data[:3000]) + raw.flush()
assert bytes(inflate_device(raw, device="cpu").data) == data[:3000]
# the foreign-stream path: stdlib gzip (no index) and a stored member
import numpy as np
rnd = np.random.default_rng(0).integers(0, 256, 3000, np.uint8).tobytes()
for foreign in (gzip.compress(data) + gzip.compress(rnd),
                pgzf.compress(rnd, 1024, device="cpu")):
    f_out, f_len = pgzf.decompress_to_device(foreign, verify=True,
                                             device="cpu")
    f_live = torch.arange(f_out.shape[1])[None, :] < f_len[:, None]
    assert f_out[f_live].numpy().tobytes() == gzip.decompress(foreign)
from libflate_tpu_torch.serial.deflate import EncodeOptions
chain8 = EncodeOptions(matcher="chain", max_chain=8, lcp_rounds=8)
assert gzip.decompress(pgzf.compress(data, 1024, options=chain8,
                                     device="cpu")) == data
import os
os.environ["LIBFLATE_DEVICE_MATCHER"] = "hash"
assert gzip.decompress(pgzf.compress(data, 1024, device="cpu")) == data
# the generic engine: the three containers on "cpu", pgzf's fixed-block
# and per-member routes, the gzip fallback for a member over 1 MiB
from libflate_tpu_torch.formats import deflate, gzip as fgzip, zlib as fzlib
assert zlib.decompress(deflate.compress(data, engine="cpu"), -15) == data
assert deflate.decompress(zlib.compress(data)[2:-4], engine="cpu") == data
assert fzlib.decompress(fzlib.compress(data, engine="cpu"),
                        engine="cpu") == data
assert fgzip.decompress(fgzip.compress(data, engine="cpu"),
                        engine="cpu") == data
for opts in (EncodeOptions(block_type="fixed"), EncodeOptions(matcher="none"),
             EncodeOptions(block_type="stored")):
    assert gzip.decompress(pgzf.compress(data, 1024, options=opts,
                                         device="cpu")) == data
big = gzip.compress(rnd * 400, compresslevel=0)
assert pgzf.decompress(big, device="cpu") == rnd * 400
# the serial engine, the streaming facades, chunked, lz77 and the CLI
import io, tempfile
from libflate_tpu_torch import chunked, cli, finish, lz77
from libflate_tpu_torch.serial import deflate as sdeflate
assert bytes(sdeflate.inflate(sdeflate.deflate(data)).data) == data
enc = fgzip.Encoder(engine="cpu")
for i in range(0, len(data), 1000):
    enc.write(data[i:i + 1000])
one = enc.getvalue()
assert one == fgzip.compress(data, engine="cpu")
assert fgzip.Decoder(one, engine="cpu").read() == data
assert fgzip.MultiDecoder(io.BytesIO(one + one)).read() == data * 2
zenc = fzlib.Encoder(engine="serial", flush_mode=fzlib.FlushMode.SYNC)
zenc.write(data[:500]); zenc.flush(); zenc.write(data[500:])
assert zlib.decompress(zenc.getvalue()) == data
dec = chunked.ChunkedGzipDecoder()
assert b"".join(dec.feed(one[i:i + 7]) for i in range(0, len(one), 7)) == data
assert lz77.decode(lz77.encode(data)) == data
assert finish.Finish(1).into_result() == 1
with tempfile.TemporaryDirectory() as tmp:
    src, gz, back = (os.path.join(tmp, n) for n in ("s", "s.gz", "back"))
    open(src, "wb").write(data)
    for engine in ("cpu", "serial"):
        assert cli.main(["-i", src, "-o", gz, "--engine", engine,
                         "gzip-encode"]) == 0
        assert gzip.decompress(open(gz, "rb").read()) == data
        assert cli.main(["-i", gz, "-o", back, "--engine", engine,
                         "--stream", "gzip-decode"]) == 0
        assert open(back, "rb").read() == data
# the native engine: pgzf's two native routes (the C index walk, and
# stdlib gzip through the gzip container), the registry, the CLI, and
# the stage timer
from libflate_tpu_torch import backend, native
from libflate_tpu_torch.utils.profiling import StageTimer
nat = pgzf.compress(data, 1024, engine="native", n_threads=2)
assert nat == pgzf.compress(data, 1024, engine="native", n_threads=1)
assert gzip.decompress(nat) == data
assert pgzf.decompress(nat, engine="native") == data
assert pgzf.decompress(gzip.compress(data), engine="native") == data
assert fgzip.decompress(fgzip.compress(data, engine="native"),
                        engine="native") == data
assert backend.get("native").crc32(data) == zlib.crc32(data)
with tempfile.TemporaryDirectory() as tmp:
    src, pz, back = (os.path.join(tmp, n) for n in ("s", "s.pgz", "back"))
    open(src, "wb").write(data)
    assert cli.main(["-i", src, "-o", pz, "--engine", "native",
                     "pgzf-encode"]) == 0
    assert cli.main(["-i", pz, "-o", back, "--engine", "native",
                     "pgzf-decode"]) == 0
    assert open(back, "rb").read() == data
timer = StageTimer()
with timer.stage("x"):
    pass
assert timer.report().startswith("x ")
# the sharded codec on a host mesh, the entry step, one process's
# multi-process encode
from libflate_tpu_torch import graft_entry
from libflate_tpu_torch.parallel import mesh, multihost, sharding
import contextlib
with contextlib.redirect_stdout(io.StringIO()) as said:
    graft_entry.dryrun_multichip(2, devices=["cpu"] * 2)
assert "round-trip bit-exact" in said.getvalue()
fn, args = graft_entry.entry("cpu")
assert fn(*args)[0].shape[0] == 8
assert multihost.compress_multihost(data, 1024, engine="native") == nat
assert len(mesh.make_mesh(2, devices=["cpu"] * 4)) == 2
assert sharding.combine_shard_crcs([zlib.crc32(data)], [len(data)]) == \
    zlib.crc32(data)
blocked = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "jaxlib", "libflate_tpu")]
assert not blocked, blocked
print(len(mods), int(lengths.sum()))
"""


def test_imports_and_runs_with_jax_blocked(small):
    """Every port module and chip_smoke.py import, decode (through the
    sync path, with the LS index stripped the speculative path, and stdlib
    gzip and stored members the foreign-stream path with its host token
    decoder; to bytes by ``decompress`` through its sync and generic
    branches and, for a member over 1 MiB, the gzip container; a raw
    stream by ``inflate_device``), encode (by default, in chain-8 quality
    mode, with the hash matcher, with fixed blocks, literals only and
    stored blocks), run the raw DEFLATE, zlib and gzip containers on
    the "cpu" engine, the serial engine, the streaming façades (a gzip
    round trip on "cpu", a sync-flushed zlib stream on "serial",
    ``MultiDecoder`` on a file-like source), the chunked gzip decoder, the
    public LZ77 API, ``Finish`` and the CLI (``gzip-encode`` and a
    ``--stream`` ``gzip-decode`` on "cpu" and "serial"), the native engine
    (pgzf's native encode and both native decode routes, the gzip
    container and a CLI round trip on it), the stage timer, the sharded
    codec's dry run on a host mesh, the entry step and one process's
    multi-process encode, with both JAX and the reference package
    blocked."""
    res = subprocess.run(
        [sys.executable, "-c", _NO_JAX, str(DATA / FIXTURES[0])],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    n_mods, n_bytes = map(int, res.stdout.split())
    assert n_mods >= 44
    assert n_bytes == len(gzip.decompress(small))
