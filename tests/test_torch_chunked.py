"""The port's chunked decoders against the reference's
(``libflate_tpu.chunked``): the same streams fed in one-byte, odd and
seeded random pieces give the same plaintext, headers and errors.
"""
import gzip
import zlib

import numpy as np
import pytest

from libflate_tpu import chunked as ref
from libflate_tpu.serial.deflate import EncodeOptions, deflate
from libflate_tpu_torch import chunked as port


def _data(n: int) -> bytes:
    rng = np.random.default_rng(11)
    return bytes(rng.integers(0, 30, n, dtype=np.uint8)) + b"ab" * 400


DATA = _data(2500)
RAW = {
    "dynamic": deflate(DATA, EncodeOptions(block_size=900)),
    "fixed": deflate(DATA, EncodeOptions(block_type="fixed")),
    "stored": deflate(DATA, EncodeOptions(block_type="stored",
                                          matcher="none")),
    "zlib_level9": zlib.compress(DATA, 9)[2:-4],
}
SIZES = {"one": [1], "odd": [1, 2, 3, 5, 8, 13], "random": list(
    np.random.default_rng(2).integers(1, 400, 30))}


def _feed(dec, stream: bytes, sizes) -> bytes:
    out, pos, i = bytearray(), 0, 0
    while pos < len(stream):
        n = int(sizes[i % len(sizes)])
        out += dec.feed(stream[pos:pos + n])
        pos, i = pos + n, i + 1
    dec.finish()
    return bytes(out)


def _outcome(make, stream, sizes):
    dec = make()
    try:
        return ("ok", _feed(dec, stream, sizes))
    except Exception as e:                  # the class and the message
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("sizes", sorted(SIZES))
@pytest.mark.parametrize("kind", sorted(RAW))
def test_deflate_feeds_match_reference(kind, sizes):
    got = _outcome(port.ChunkedDeflateDecoder, RAW[kind], SIZES[sizes])
    assert got == ("ok", DATA)
    assert got == _outcome(ref.ChunkedDeflateDecoder, RAW[kind],
                           SIZES[sizes])


@pytest.mark.parametrize("sizes", sorted(SIZES))
def test_gzip_and_zlib_feeds_match_reference(sizes):
    two = gzip.compress(DATA) + gzip.compress(DATA[:700], mtime=3)
    for multi, want in ((True, DATA + DATA[:700]), (False, DATA)):
        got = _outcome(lambda: port.ChunkedGzipDecoder(multi=multi), two,
                       SIZES[sizes])
        assert got == ("ok", want)
        assert got == _outcome(lambda: ref.ChunkedGzipDecoder(multi=multi),
                               two, SIZES[sizes])
    zs = zlib.compress(DATA, 6)
    assert (_outcome(port.ChunkedZlibDecoder, zs, SIZES[sizes])
            == _outcome(ref.ChunkedZlibDecoder, zs, SIZES[sizes])
            == ("ok", DATA))


def _bad_streams():
    gz = gzip.compress(DATA)
    crc = bytearray(gz)
    crc[-6] ^= 1
    size = bytearray(gz)
    size[-2] ^= 1
    body = bytearray(gz)
    body[len(gz) // 2] ^= 0x33
    zs = bytearray(zlib.compress(DATA))
    zs[-1] ^= 1
    return {"gzip_cut": ("gzip", gz[:len(gz) // 2]),
            "gzip_crc": ("gzip", bytes(crc)),
            "gzip_isize": ("gzip", bytes(size)),
            "gzip_body": ("gzip", bytes(body)),
            "gzip_magic": ("gzip", b"\x1f\x8c" + gz[2:]),
            "zlib_adler": ("zlib", bytes(zs)),
            "zlib_header": ("zlib", b"\x78\x00" + bytes(zs[2:])),
            "raw_reserved": ("deflate", b"\x07" + RAW["dynamic"][1:]),
            "raw_cut": ("deflate", RAW["fixed"][:10])}


BAD = _bad_streams()


@pytest.mark.parametrize("case", sorted(BAD))
def test_errors_match_reference(case):
    kind, stream = BAD[case]
    name = {"gzip": "ChunkedGzipDecoder", "zlib": "ChunkedZlibDecoder",
            "deflate": "ChunkedDeflateDecoder"}[kind]
    for sizes in ([1], [64]):
        got = _outcome(getattr(port, name), stream, sizes)
        assert got[0] != "ok"
        assert got == _outcome(getattr(ref, name), stream, sizes)


def test_state_and_header_across_feeds():
    gz = gzip.compress(DATA, mtime=9)
    dec, want = port.ChunkedGzipDecoder(), ref.ChunkedGzipDecoder()
    got = dec.feed(gz[:5]) + dec.feed(gz[5:40])
    assert dec.header is None or dec.header.mtime == 9
    got += dec.feed(gz[40:])
    dec.finish()
    assert got == DATA
    want.feed(gz)
    assert dec.header.encode() == want.header.encode()
