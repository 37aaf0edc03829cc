"""The raw DEFLATE, zlib and gzip containers and pgzf's new routes on the
port's "cpu" engine, against the reference's "tpu" engine (its CPU run:
the sort branch and the XLA fields), byte for byte, with the same error
types; and the two repaired faults of ``pgzf.decompress``: a stream cut
inside its first block header raises EOFError, and a member over 1 MiB
that only the foreign token decode would take decodes through the gzip
container.  Every reference call runs once, in the module fixture.
"""
import gzip
import struct
import zlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from libflate_tpu_torch import native  # noqa: E402
from libflate_tpu_torch.formats import deflate, pgzf  # noqa: E402
from libflate_tpu_torch.formats import gzip as fgzip  # noqa: E402
from libflate_tpu_torch.formats import zlib as fzlib  # noqa: E402
from libflate_tpu_torch.serial.deflate import EncodeOptions  # noqa: E402

RNG = np.random.default_rng(21)
TEXT = b"a container of text, and more text for the matcher. " * 400
INPUTS = {
    "empty": b"",
    "one": b"x",
    "text": TEXT,
    # two 64 KiB blocks: the second one final
    "two blocks": TEXT * 3 + RNG.integers(0, 256, 20000, np.uint8).tobytes(),
}
#: (container, options name) -> the port's options and the reference's
OPTIONS = {"default": {}, "fixed": {"block_type": "fixed"},
           "stored": {"block_type": "stored"}, "none": {"matcher": "none"},
           "window 1024": {"window_size": 1024}}
PGZF_CASES = {"fixed": {"block_type": "fixed"}, "none": {"matcher": "none"},
              "stored": {"block_type": "stored"},
              "none fixed": {"matcher": "none", "block_type": "fixed"}}
PGZF_DATA = TEXT[:9000] + RNG.integers(0, 256, 5000, np.uint8).tobytes() \
    + b"q" * 3000
CUT = gzip.compress(bytes(range(256)) * 300, mtime=0)[:12]
BIG_PLAIN = RNG.integers(0, 256, 2 << 20, np.uint8).tobytes()
#: a stdlib gzip stream whose second member is 2 MiB of stored blocks
BIG = gzip.compress(b"a small member", mtime=0) + gzip.compress(
    BIG_PLAIN, compresslevel=0, mtime=0)


def _bad_streams():
    good_gz = gzip.compress(TEXT, mtime=0)
    good_zl = zlib.compress(TEXT)
    crc = bytearray(good_gz)
    crc[-8] ^= 1
    isize = bytearray(good_gz)
    isize[-1] ^= 1
    adler = bytearray(good_zl)
    adler[-1] ^= 1
    return {
        ("gzip", "bad magic"): b"\x1f\x8c" + good_gz[2:],
        ("gzip", "crc mismatch"): bytes(crc),
        ("gzip", "isize mismatch"): bytes(isize),
        ("gzip", "truncated trailer"): good_gz[:-3],
        ("gzip", "truncated header"): good_gz[:6],
        ("zlib", "bad method"): b"\x79" + good_zl[1:],
        ("zlib", "bad fcheck"): good_zl[:1] + bytes([good_zl[1] ^ 1])
        + good_zl[2:],
        ("zlib", "adler mismatch"): bytes(adler),
        ("zlib", "truncated trailer"): good_zl[:-2],
        ("deflate", "reserved block type"): b"\x07\x00",
    }


def _outcome(fn):
    try:
        return fn()
    except Exception as e:          # noqa: BLE001 - the class is the result
        return type(e).__name__


@pytest.fixture(scope="module")
def ref():
    import libflate_tpu.ops.pipeline  # noqa: F401 - registers "tpu"
    from libflate_tpu.formats import deflate as rdeflate
    from libflate_tpu.formats import gzip as rgzip
    from libflate_tpu.formats import pgzf as rpgzf
    from libflate_tpu.formats import zlib as rzlib
    from libflate_tpu.serial.deflate import EncodeOptions as RefOptions
    mods = {"deflate": rdeflate, "zlib": rzlib, "gzip": rgzip}
    out = {}
    for cname, mod in mods.items():
        for iname, data in INPUTS.items():
            out[cname, iname] = mod.compress(data, engine="tpu")
        for oname, kw in OPTIONS.items():
            out[cname, oname] = mod.compress(TEXT, RefOptions(**kw),
                                             engine="tpu")
    for level in ("none", "fast", "balance", "best"):
        out["gzip level", level] = rgzip.compress(
            TEXT, rgzip.EncodeOptions(level), engine="tpu")
    for (cname, what), data in _bad_streams().items():
        out["error", cname, what] = _outcome(
            lambda d=data, m=mods[cname]: m.decompress(d, engine="tpu"))
    out["zlib members"] = _outcome(lambda: rzlib.decompress_stream(
        zlib.compress(TEXT) + b"tail", 0, engine="tpu").end_pos)
    out["gzip members"] = [(m.data, m.trailer.crc32, m.end_pos)
                           for m in rgzip.decompress_members(
                               gzip.compress(b"ab") + gzip.compress(TEXT),
                               engine="tpu")]
    for name, kw in PGZF_CASES.items():
        out["pgzf", name] = rpgzf.compress(PGZF_DATA, member_size=4096,
                                           options=RefOptions(**kw),
                                           engine="tpu")
    out["cut"] = _outcome(lambda: rpgzf.decompress(CUT))
    out["big"] = rpgzf.decompress(BIG)
    return out


@pytest.mark.parametrize("container", ["deflate", "zlib", "gzip"])
@pytest.mark.parametrize("name", list(INPUTS))
def test_compress_matches_reference(ref, container, name):
    mod = {"deflate": deflate, "zlib": fzlib, "gzip": fgzip}[container]
    got = mod.compress(INPUTS[name], engine="cpu")
    assert got == ref[container, name]
    wbits = {"deflate": -15, "zlib": 15, "gzip": 31}[container]
    assert zlib.decompress(got, wbits) == INPUTS[name]
    if len(INPUTS[name]) <= len(TEXT):
        # the plain decode steps a token at a time: small inputs only
        assert mod.decompress(got, engine="cpu") == INPUTS[name]


@pytest.mark.parametrize("container", ["deflate", "zlib", "gzip"])
@pytest.mark.parametrize("name", list(OPTIONS))
def test_compress_options_match_reference(ref, container, name):
    mod = {"deflate": deflate, "zlib": fzlib, "gzip": fgzip}[container]
    got = mod.compress(TEXT, EncodeOptions(**OPTIONS[name]), engine="cpu")
    assert got == ref[container, name]
    wbits = {"deflate": -15, "zlib": 15, "gzip": 31}[container]
    assert zlib.decompress(got, wbits) == TEXT


@pytest.mark.parametrize("level", ["none", "fast", "balance", "best"])
def test_gzip_levels_match_reference(ref, level):
    got = fgzip.compress(TEXT, fgzip.EncodeOptions(level), engine="cpu")
    assert got == ref["gzip level", level]
    assert fgzip.Header.decode(got)[0].xfl == \
        fgzip.CompressionLevel.xfl(level)


@pytest.mark.parametrize("key", list(_bad_streams()))
def test_errors_match_reference(ref, key):
    cname, what = key
    mod = {"deflate": deflate, "zlib": fzlib, "gzip": fgzip}[cname]
    got = _outcome(lambda: mod.decompress(_bad_streams()[key],
                                          engine="cpu"))
    assert got == ref["error", cname, what]
    assert got in ("GzipError", "ZlibError", "EOFError", "DeflateError")


def test_decompress_reads_stdlib_streams():
    assert deflate.decompress(zlib.compress(TEXT, 9)[2:-4],
                              engine="cpu") == TEXT
    assert fzlib.decompress(zlib.compress(TEXT, 1), engine="cpu") == TEXT
    two = gzip.compress(b"first") + gzip.compress(TEXT)
    assert fgzip.decompress(two, engine="cpu") == b"first"
    assert fgzip.decompress(two, engine="cpu", multi=True) == \
        b"first" + TEXT


def test_member_and_stream_extents_match_reference(ref):
    stream = zlib.compress(TEXT) + b"tail"
    assert fzlib.decompress_stream(stream, 0, engine="cpu").end_pos == \
        ref["zlib members"] == len(stream) - 4
    members = fgzip.decompress_members(
        gzip.compress(b"ab") + gzip.compress(TEXT), engine="cpu")
    assert [(m.data, m.trailer.crc32, m.end_pos) for m in members] == \
        ref["gzip members"]


def test_header_builder_and_trailer():
    h = (fgzip.HeaderBuilder().mtime(7).os(fgzip.Os.NTFS).text().verify()
         .filename(b"f").comment(b"c").finish())
    got = fgzip.compress(b"abc", header=h, engine="cpu")
    back = fgzip.decompress_members(got, engine="cpu")[0]
    assert (back.header.mtime, back.header.os, back.header.filename,
            back.header.comment) == (7, 11, b"f", b"c")
    assert back.trailer == fgzip.Trailer(zlib.crc32(b"abc"), 3)
    assert gzip.decompress(got) == b"abc"
    assert fzlib.Header.decode(fzlib.Header(
        fzlib.Lz77WindowSize.KB1, fzlib.CompressionLevel.SLOWEST).encode()
    )[0] == fzlib.Header(fzlib.Lz77WindowSize.KB1,
                         fzlib.CompressionLevel.SLOWEST)


@pytest.mark.parametrize("name", list(PGZF_CASES))
def test_pgzf_routes_match_reference(ref, name):
    got = pgzf.compress(PGZF_DATA, member_size=4096,
                        options=EncodeOptions(**PGZF_CASES[name]),
                        device="cpu")
    assert got == ref["pgzf", name]
    assert gzip.decompress(got) == PGZF_DATA
    assert pgzf.decompress(got, device="cpu") == PGZF_DATA
    assert len(pgzf.index_members(got)) == 5


def test_pgzf_refuses_unknown_block_type():
    with pytest.raises(ValueError, match="block_type"):
        pgzf.compress(b"abc", 1024, options=EncodeOptions(block_type="x"),
                      device="cpu")


def test_cut_stream_raises_eof_error(ref):
    """A stream without the LF index, cut inside its first block header:
    EOFError, as the reference; the token decoder's own return code."""
    assert ref["cut"] == "EOFError"
    with pytest.raises(EOFError):
        pgzf.decompress(CUT, device="cpu")
    with pytest.raises(EOFError):
        native.inflate_tokens(CUT, 10, 1024)
    # a bad code is still a DeflateError
    with pytest.raises(Exception, match="token decode failed"):
        native.inflate_tokens(b"\x07" + b"\x00" * 8, 0, 1024)


def test_member_over_1mib_decodes_through_gzip_container(ref, monkeypatch):
    """The foreign path refuses the 2 MiB member (ImportError); the gzip
    container on the "cpu" engine decodes the stream, as the
    reference's last route does."""
    calls = []
    real = fgzip.decompress

    def spy(data, engine=None, multi=False):
        calls.append((engine, multi))
        return real(data, engine=engine, multi=multi)

    monkeypatch.setattr(fgzip, "decompress", spy)
    with pytest.raises(ImportError):
        pgzf._decompress_foreign(BIG, None, True, pgzf._device("cpu"))
    out = pgzf.decompress(BIG, device="cpu")
    assert out == ref["big"] == b"a small member" + BIG_PLAIN
    assert calls == [("cpu", True)]
    # a corrupt trailer in that route is the container's GzipError
    bad = bytearray(BIG)
    bad[-5] ^= 1
    with pytest.raises(fgzip.GzipError):
        pgzf.decompress(bytes(bad), device="cpu")


def test_indexed_member_over_1mib_takes_the_fallback():
    """An LF-indexed stream whose member is over 1 MiB: every device
    branch refuses it, the gzip container decodes it."""
    body = zlib.compressobj(0, zlib.DEFLATED, -15)
    body = body.compress(BIG_PLAIN[:(1 << 20) + 5]) + body.flush()
    plain = BIG_PLAIN[:(1 << 20) + 5]
    member = bytearray(pgzf._member_header(0) + body
                       + struct.pack("<II", zlib.crc32(plain), len(plain)))
    struct.pack_into("<I", member, pgzf._SIZE_OFFSET, len(member))
    assert pgzf.index_members(bytes(member)) is not None
    assert pgzf.decompress(bytes(member), device="cpu") == plain
