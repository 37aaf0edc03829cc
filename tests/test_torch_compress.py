"""The port's whole encode slice on the CPU (every kernel's plain
version) against the committed reference stream.

``tests/data/pgzf_encode_small.pgz`` is the reference's device encode
of ``small_corpus()`` at 1 KiB members, written by
``scripts/make_pgzf_encode_fixture.py``: two batches (the second padded
to 128 members), an overflow re-encode at cap 512 and stored members.
``pgzf_encode_zipf_2m.pgz`` is the zipf corpus at 8 KiB members.
``compress(..., device="cpu")`` must reproduce it byte for byte; stdlib
gzip and the port's own ``decompress_to_device`` must read it back.
"""
import gzip
import hashlib
import importlib.util
import pathlib

import pytest
import torch

from libflate_tpu_torch.formats import pgzf

ROOT = pathlib.Path(__file__).resolve().parent.parent
DATA = ROOT / "tests" / "data"
SCRIPT = ROOT / "scripts" / "make_pgzf_encode_fixture.py"


def _fixture_script():
    spec = importlib.util.spec_from_file_location("make_fixture", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def small():
    data = _fixture_script().small_corpus()
    return data, pgzf.compress(data, member_size=1024, device="cpu")


@pytest.mark.parametrize("name", ["pgzf_encode_small.pgz",
                                  "pgzf_encode_zipf_2m.pgz"])
def test_fixture_is_recorded_in_its_script(name):
    stream = (DATA / name).read_bytes()
    assert hashlib.sha256(stream).hexdigest() in SCRIPT.read_text()
    assert len(gzip.decompress(stream)) > 0


def test_compress_matches_reference_stream(small):
    _data, stream = small
    assert stream == (DATA / "pgzf_encode_small.pgz").read_bytes()


def test_compress_matches_8k_member_reference_stream():
    """The committed stream at the largest member size the reference
    could write on the CPU in interpret mode (8 KiB, two batches)."""
    ref = (DATA / "pgzf_encode_zipf_2m.pgz").read_bytes()
    assert pgzf.compress(gzip.decompress(ref), member_size=8192,
                         device="cpu") == ref


def test_stream_shape_batches_overflow_and_stored(small):
    data, stream = small
    refs = pgzf.index_members(stream)
    assert len(refs) == -(-len(data) // 1024) == 134      # two batches
    hdrs = [pgzf.fgzip.Header.decode(stream, r.start)[0] for r in refs]
    stored = [i for i, h in enumerate(hdrs) if pgzf._parse_sync(h) is None]
    assert stored == [130, 131, 132, 133]                 # random bytes
    for i in stored:                                      # BTYPE 00
        assert stream[refs[i].body] & 6 == 0


def test_gzip_round_trip(small):
    data, stream = small
    assert gzip.decompress(stream) == data


def test_decompress_to_device_round_trip(small):
    """The whole stream, stored members included (the foreign-stream
    path), and its first batch alone (the sync path) read back."""
    data, stream = small
    refs = pgzf.index_members(stream)
    for part, plain in ((stream, data),
                        (stream[:refs[127].end], data[:128 * 1024])):
        out, lengths = pgzf.decompress_to_device(part, verify=True,
                                                 device="cpu")
        live = torch.arange(out.shape[1])[None, :] < lengths[:, None]
        assert out[live].numpy().tobytes() == plain


def test_empty_input_is_one_stored_member():
    stream = pgzf.compress(b"", member_size=1024, device="cpu")
    assert gzip.decompress(stream) == b""
    assert len(pgzf.index_members(stream)) == 1


@pytest.mark.parametrize("size", [0, 1000, 512, 3 * 1024 + 1, 2 ** 17,
                                  "1024"])
def test_bad_member_size_raises(size):
    """Sizes the reference's dynamic branch refuses with the sort matcher:
    not a positive int, not a multiple of 512, a sort of fewer than 1024
    keys, more than 65536 positions."""
    with pytest.raises(ValueError, match="member_size"):
        pgzf.compress(b"abc", member_size=size, device="cpu")


def test_cuda_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    called = []
    monkeypatch.setattr(pgzf, "encode_batch", lambda *a, **k: called.append(a))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pgzf.compress(b"abc" * 1000, member_size=1024, device="cuda")
    assert not called
