"""The port's foreign-stream decode against the reference and stdlib gzip.

Streams that neither the sync path nor the speculative path takes
(stdlib gzip, fixed and stored blocks, per-member tables) decode through
``_foreign_to_device``: the host token decode of
``libflate_tpu_torch.native`` (a copy of the reference's C token
inflate), then the expansion and CRC on the device, here the CPU.

The token decode is held against the reference's
``libflate_tpu.native.inflate_tokens`` / ``inflate_tokens_batch``
(plain C on both sides, so every case is cheap).  The decode is held
against the reference's ``decompress_to_device`` on three one- and
two-member inputs and on the error cases (every reference call runs
once, in one module-scoped fixture, with its Pallas kernels in interpret
mode: ~35 s with a cold compile cache), and against stdlib gzip and the
reference's shape rule on the whole ``pgzf_encode_small.pgz`` (the
reference takes ~20 s on it, so it is not run there).
"""
import gzip
import pathlib
import struct
import zlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from libflate_tpu_torch import native as port_native  # noqa: E402
from libflate_tpu_torch.formats import pgzf as port  # noqa: E402

DATA = pathlib.Path(__file__).resolve().parent / "data"
SMALL = DATA / "pgzf_encode_small.pgz"


def _text() -> bytes:
    return gzip.decompress((DATA / "pgzf_sync_zipf_small.pgz").read_bytes())


def _gzip_of(body: bytes, plain: bytes) -> bytes:
    """A stdlib-layout gzip member (10-byte header) around a raw DEFLATE
    body."""
    return (b"\x1f\x8b\x08\x00\x00\x00\x00\x00\x00\x03" + body
            + struct.pack("<II", zlib.crc32(plain), len(plain)))


def _fixed_member() -> bytes:
    plain = _text()[:20000]
    c = zlib.compressobj(6, zlib.DEFLATED, -15, 8, zlib.Z_FIXED)
    return _gzip_of(c.compress(plain) + c.flush(), plain)


def _stored_member() -> bytes:
    """The port's own encode of 1024 incompressible bytes: one stored
    member of 1,057 bytes (the reference's ``compress`` writes the
    same)."""
    raw = np.random.default_rng(1024).integers(0, 256, 1024, np.uint8)
    stream = port.compress(raw.tobytes(), member_size=1024, device="cpu")
    assert len(stream) == 1057
    return stream


def _two_members() -> bytes:
    rng = np.random.default_rng(0)
    return (gzip.compress(b"x" * 5000, mtime=0)
            + gzip.compress(rng.integers(0, 256, 1500, np.uint8).tobytes(),
                            mtime=0))


SINGLE = {
    "gzip_level1": lambda: gzip.compress(_text(), 1, mtime=0),
    "gzip_level6": lambda: gzip.compress(_text(), 6, mtime=0),
    "gzip_level9": lambda: gzip.compress(_text(), 9, mtime=0),
    "fixed_huffman": _fixed_member,
    "stored_1057": _stored_member,
}


def _body(stream: bytes) -> int:
    return port.fgzip.Header.decode(stream, 0)[1]


@pytest.mark.parametrize("name", sorted(SINGLE))
def test_token_decode_matches_reference(name):
    """One member: equal tokens, plaintext size and end bit."""
    from libflate_tpu import native as ref_native
    stream = SINGLE[name]()
    body = _body(stream)
    got = port_native.inflate_tokens(stream, body, 1 << 17)
    want = ref_native.inflate_tokens(stream, body, 1 << 17)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    assert got[1] == len(gzip.decompress(stream))
    assert (got[2] + 7) // 8 == len(stream) - 8 - body


def test_token_decode_cap_and_errors_match_reference():
    """Too small a token cap gives None (grow and retry); a reserved
    block type raises DeflateError, on both sides."""
    from libflate_tpu import native as ref_native
    stream = SINGLE["gzip_level6"]()
    body = _body(stream)
    assert port_native.inflate_tokens(stream, body, 64) is None
    assert ref_native.inflate_tokens(stream, body, 64) is None
    bad = bytearray(stream)
    bad[body] |= 0b110                       # BTYPE 3
    with pytest.raises(Exception) as want:
        ref_native.inflate_tokens(bytes(bad), body, 1 << 17)
    with pytest.raises(Exception) as got:
        port_native.inflate_tokens(bytes(bad), body, 1 << 17)
    assert type(got.value).__name__ == type(want.value).__name__ \
        == "DeflateError"
    assert str(got.value) == str(want.value)


def test_batch_token_decode_matches_reference():
    """The member bodies of ``pgzf_encode_small.pgz`` (shared-table
    dynamic members and four stored ones) as one threaded batch."""
    from libflate_tpu import native as ref_native
    stream = SMALL.read_bytes()
    refs = port.index_members(stream)
    args = (stream, [r.body for r in refs], [r.end - 8 for r in refs], 2048)
    toks, counts, osz = port_native.inflate_tokens_batch(*args)
    r_toks, r_counts, r_osz = ref_native.inflate_tokens_batch(*args)
    np.testing.assert_array_equal(counts, r_counts)
    np.testing.assert_array_equal(osz, r_osz)
    for i, n in enumerate(counts):
        np.testing.assert_array_equal(toks[i, :n], r_toks[i, :n])
    assert int(osz.sum()) == len(gzip.decompress(stream))


TINY = {"gzip_abc": lambda: gzip.compress(b"abc", mtime=0),
        "two_members": _two_members,
        "stored_1057": _stored_member}


def _crc_flipped():
    bad = bytearray(gzip.compress(b"abc", mtime=0))
    bad[-8] ^= 1
    return bytes(bad)


def _bad_block_type():
    bad = bytearray(gzip.compress(b"abc", mtime=0))
    bad[10] |= 0b110
    return bytes(bad)


ERRORS = {
    "crc_mismatch": (_crc_flipped, "GzipError"),
    "member_over_1mib": (lambda: gzip.compress(b"\0" * ((1 << 20) + 1),
                                               mtime=0), "ImportError"),
    "truncated_trailer": (lambda: gzip.compress(b"abc", mtime=0)[:-4],
                          "GzipError"),
    "bad_block_type": (_bad_block_type, "DeflateError"),
    "empty": (lambda: b"", "ValueError"),
}


def _error_name(fn, data):
    try:
        fn(data)
    except Exception as e:          # noqa: BLE001 - the class is the result
        return type(e).__name__
    return None


@pytest.fixture(scope="module")
def reference():
    """Every call of the reference's decompress_to_device that the tests
    below compare with, in one interpret-mode pass: ``decodes``, the
    (out, lengths) of each TINY input with verify=True, as numpy arrays;
    ``errors``, the exception class name for each ERRORS input with
    verify=True; ``crc_unverified``, the rows of the flipped-CRC member
    with verify=False."""
    from libflate_tpu.formats import pgzf as ref
    got = {"decodes": {}, "errors": {}}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LIBFLATE_PALLAS_INTERPRET", "1")
        for name, make in TINY.items():
            out, lengths = ref.decompress_to_device(make(), verify=True)
            got["decodes"][name] = (np.asarray(out), np.asarray(lengths))
        for name, (make, _want) in ERRORS.items():
            got["errors"][name] = _error_name(
                lambda d: ref.decompress_to_device(d, verify=True), make())
        got["crc_unverified"] = np.asarray(
            ref.decompress_to_device(_crc_flipped(), verify=False)[0])
    return got


@pytest.mark.parametrize("name", sorted(TINY))
def test_decompress_matches_reference(reference, name):
    """The same (out, lengths): equal shapes, dtypes and bytes."""
    out, lengths = port.decompress_to_device(TINY[name](), verify=True,
                                             device="cpu")
    want_out, want_len = reference["decodes"][name]
    assert out.dtype == torch.uint8 and lengths.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), want_out)
    np.testing.assert_array_equal(lengths.numpy(), want_len)


def test_whole_small_encode_matches_gzip():
    """``pgzf_encode_small.pgz`` whole (LF-indexed, stored members
    130-133): rows of 1024 (the reference's rule), equal to gzip."""
    stream = SMALL.read_bytes()
    out, lengths = port.decompress_to_device(stream, verify=True,
                                             device="cpu")
    plain = gzip.decompress(stream)
    assert out.shape == (134, 1024)
    assert lengths.tolist() == [1024] * 133 + [len(plain) - 133 * 1024]
    live = torch.arange(out.shape[1])[None, :] < lengths[:, None]
    assert out[live].numpy().tobytes() == plain
    assert not out[~live].any()


def test_stdlib_levels_and_fixed_members_match_gzip():
    """Un-indexed members of every kind in one stream, walked by their
    end bits: rows to the next power of two of the largest member."""
    parts = [SINGLE[k]() for k in sorted(SINGLE)]
    stream = b"".join(parts)
    out, lengths = port.decompress_to_device(stream, verify=True,
                                             device="cpu")
    sizes = [len(gzip.decompress(p)) for p in parts]
    assert lengths.tolist() == sizes
    assert out.shape == (5, 1 << (max(sizes) - 1).bit_length())
    live = torch.arange(out.shape[1])[None, :] < lengths[:, None]
    assert out[live].numpy().tobytes() == gzip.decompress(stream)


@pytest.mark.parametrize("name", sorted(ERRORS))
def test_errors_match_reference(reference, name):
    """Each malformed input raises the reference's exception type."""
    make, want = ERRORS[name]
    assert reference["errors"][name] == want
    assert _error_name(lambda d: port.decompress_to_device(
        d, verify=True, device="cpu"), make()) == want


def test_crc_mismatch_passes_without_verify(reference):
    """The flipped CRC: GzipError naming the member with verify=True (the
    reference's type, in ``reference["errors"]``); with verify=False the
    reference's rows."""
    data = _crc_flipped()
    assert reference["errors"]["crc_mismatch"] == "GzipError"
    with pytest.raises(port.fgzip.GzipError, match="member 0"):
        port.decompress_to_device(data, verify=True, device="cpu")
    out, lengths = port.decompress_to_device(data, verify=False,
                                             device="cpu")
    np.testing.assert_array_equal(out.numpy(), reference["crc_unverified"])
    assert lengths.tolist() == [3]
