"""The port's native host engine (``libflate_tpu_torch.native``, its own
copy of the reference's C++ library) against the reference's
(``libflate_tpu.native``) on the same inputs.

Each of the 13 binding functions gives the reference's outputs, and the
reference's error type and message on every error code a crafted stream
reaches (-1 .. -12 but -11, which no decoder returns).  The one pinned
difference: ``inflate_tokens`` raises EOFError where its input ends
inside the body, the reference DeflateError; and the port's encoder frees
its per-thread token buffer, which the reference leaks on every batch
call.  Then the routes over it:
``pgzf.compress`` / ``decompress(engine="native")``, the ``native``
engine of the registry under the containers, the façades and the CLI,
the build's failure, and ``utils/profiling.py`` with pgzf's trace hooks.
Everything here runs in seconds on the CPU.
"""
import contextlib
import gzip
import io
import json
import pathlib
import zlib

import numpy as np
import pytest

from libflate_tpu import native as R
from libflate_tpu_torch import native as P

DATA = pathlib.Path(__file__).parent / "data"

pytestmark = pytest.mark.skipif(not R.available(),
                                reason="the reference's native engine "
                                       "did not build")


def _text(n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 123, rng.integers(2, 9), np.uint8))
             for _ in range(300)]
    return b" ".join(words[int(i)] for i in rng.zipf(1.3, n) % 300)[:n]


_RNG = np.random.default_rng(16)
INPUTS = {
    "empty": b"",
    "one": b"x",
    "text": _text(20000, 1),
    "random": _RNG.integers(0, 256, 5000, np.uint8).tobytes(),
    "zeros": bytes(70000),
    "multi_block": _text(300000, 2),
    "runs": b"ab" * 3000 + bytes(range(256)) * 20 + b"z" * 1000,
}


def _raw(data: bytes, level: int = 6, strategy: int = 0,
         mem_level: int = 8) -> bytes:
    c = zlib.compressobj(level, zlib.DEFLATED, -15, mem_level, strategy)
    return c.compress(data) + c.flush()


#: raw DEFLATE streams of every kind: stored, fixed, dynamic, many blocks
RAW = {}
for _name, _data in INPUTS.items():
    RAW[f"{_name}_stored"] = _raw(_data, 0)
    RAW[f"{_name}_l6"] = _raw(_data, 6)
    RAW[f"{_name}_fixed"] = _raw(_data, 6, zlib.Z_FIXED)
    RAW[f"{_name}_greedy"] = R.deflate_greedy(_data, block_size=16384)
RAW["multi_block_l9_mem1"] = _raw(INPUTS["multi_block"], 9, 0, 1)
RAW["text_l1"] = _raw(INPUTS["text"], 1)


def _norm(v):
    if isinstance(v, np.ndarray):
        return ("array", v.dtype.str, v.shape, v.tobytes())
    if isinstance(v, (list, tuple)):
        return type(v).__name__, [_norm(x) for x in v]
    return v


def _call(fn, *args, **kw):
    """("ok", normalised result) or ("err", type name, message)."""
    try:
        return "ok", _norm(fn(*args, **kw))
    except Exception as e:                 # noqa: BLE001 - compared below
        return "err", type(e).__name__, str(e)


def _same(name: str, *args, **kw):
    got = _call(getattr(P, name), *args, **kw)
    want = _call(getattr(R, name), *args, **kw)
    assert got == want
    return got


# ---------------------------------------------------------------------------
# Crafted streams for the decoders' error codes
# ---------------------------------------------------------------------------
def _bits(*fields) -> bytes:
    """LSB-first bit fields ``(value, width)``; ``("h", code, width)`` is
    a Huffman code, written from its first bit; 8 zero bytes of padding
    keep the decoder off the end of its input."""
    acc = n = 0
    for f in fields:
        if f[0] == "h":
            _, code, width = f
            value = int(f"{code:0{width}b}"[::-1], 2)
        else:
            value, width = f
        acc |= value << n
        n += width
    return acc.to_bytes((n + 7) // 8, "little") + bytes(8)


_DYN = ((1, 1), (2, 2))           # BFINAL, BTYPE=2
_FIXED = ((1, 1), (1, 2))         # BFINAL, BTYPE=1
_HDR0 = ((0, 5), (0, 5), (0, 4))  # HLIT 257, HDIST 1, HCLEN 4 (16,17,18,0)

ERRORS = {
    # -1: the input ends
    "eof_empty": (b"", -1),
    "eof_stored": (bytes([1, 10, 0, 0xF5, 0xFF]) + b"ab", -1),
    "eof_body": (RAW["text_l6"][:len(RAW["text_l6"]) // 2], -1),
    # -2
    "hlit_287": (_bits(*_DYN, (30, 5), (0, 5), (0, 4)), -2),
    "hdist_31": (_bits(*_DYN, (0, 5), (30, 5), (0, 4)), -2),
    # -3: an empty code-length code
    "no_clen_code": (_bits(*_DYN, *_HDR0, (0, 3), (0, 3), (0, 3), (0, 3)),
                     -3),
    # -4: code 16 first (16 and 0 take one bit each: 0 is "0", 16 "1")
    "repeat_first": (_bits(*_DYN, *_HDR0, (1, 3), (0, 3), (0, 3), (1, 3),
                           ("h", 1, 1), (0, 2)), -4),
    # -5: two runs of 138 zeros overrun 258 lengths (18 is "1", 0 "0")
    "repeat_overflow": (_bits(*_DYN, *_HDR0, (0, 3), (0, 3), (1, 3), (1, 3),
                              ("h", 1, 1), (127, 7), ("h", 1, 1), (127, 7)),
                        -5),
    # -6: 258 zero lengths: no end-of-block code
    "no_eob": (_bits(*_DYN, *_HDR0, (0, 3), (0, 3), (1, 3), (1, 3),
                     ("h", 1, 1), (127, 7), ("h", 1, 1), (109, 7)), -6),
    # -7
    "stored_nlen": (bytes([1, 1, 0, 0, 0, 0x41]), -7),
    # -9
    "reserved_type": (bytes([0b111]), -9),
    # -10: the fixed code's symbol 286
    "fixed_286": (_bits(*_FIXED, ("h", 0b11000110, 8)), -10),
    # -12: a match at the first byte (length symbol 257, distance 1)
    "far_distance": (_bits(*_FIXED, ("h", 0b0000001, 7), ("h", 0, 5)), -12),
}


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_checksums_match_reference(name):
    data = INPUTS[name]
    for fn in ("crc32", "adler32"):
        assert _same(fn, data)[1] == getattr(zlib, fn)(data)
        assert _same(fn, data, 0x12345678)[1] == getattr(zlib, fn)(
            data, 0x12345678)


@pytest.mark.parametrize("name", sorted(RAW))
def test_inflate_matches_reference(name):
    stream = RAW[name]
    got = _same("inflate", stream)
    assert got[1][1][0] == zlib.decompress(stream, -15)
    # the output buffer regrows 4x from a small start
    _same("inflate", stream, initial_cap=64)


@pytest.mark.parametrize("name", sorted(ERRORS))
def test_inflate_errors_match_reference(name):
    stream, code = ERRORS[name]
    got = _same("inflate", stream)
    assert got[0] == "err"
    assert got[1] == ("EOFError" if code == -1 else "DeflateError")
    assert got[2] == R._ERRORS[code]


def test_inflate_output_too_large_matches_reference():
    """-8 on every one of the 8 regrowths from ``initial_cap=1``."""
    got = _same("inflate", RAW["zeros_l6"], initial_cap=1)
    assert got == ("err", "DeflateError", "output too large")


@pytest.mark.parametrize("name", sorted(INPUTS))
@pytest.mark.parametrize("kw", [
    {}, {"block_size": 4096}, {"lazy": True}, {"lazy": True, "max_chain": 32},
    {"final": False, "block_size": 65536, "max_chain": 8}],
    ids=["default", "bs4096", "lazy", "lazy_chain32", "notfinal_chain8"])
def test_deflate_greedy_matches_reference(name, kw):
    got = _same("deflate_greedy", INPUTS[name], **kw)
    if kw.get("final", True):
        assert zlib.decompress(got[1], -15) == INPUTS[name]


def _bodies(names):
    streams = [RAW[n] for n in names]
    offs = np.zeros(len(streams) + 1, np.uint64)
    np.cumsum([len(s) for s in streams], out=offs[1:])
    return b"".join(streams), offs


BATCH = ["text_l6", "text_fixed", "text_stored", "runs_greedy",
         "multi_block_l9_mem1", "one_l6", "empty_l6"]


def test_parse_dyn_headers_matches_reference():
    _same("parse_dyn_headers", *_bodies(BATCH))
    got = _same("parse_dyn_headers", bytes([0b111, 0, 0]),
                np.array([0, 3], np.uint64))
    assert got == ("err", "DeflateError", "bad block header in member 0")
    bad = RAW["text_l6"] + ERRORS["hlit_287"][0]
    _same("parse_dyn_headers", bad,
          np.array([0, len(RAW["text_l6"]), len(bad)], np.uint64))


@pytest.mark.parametrize("n_threads", [0, 1, 3])
def test_inflate_batch_matches_reference(n_threads):
    bodies, offs = _bodies(BATCH)
    sizes = np.array([len(zlib.decompress(RAW[n], -15)) for n in BATCH],
                     np.uint64)
    got = _same("inflate_batch", bodies, offs, sizes, n_threads=n_threads)
    assert got[1][1][0] == b"".join(zlib.decompress(RAW[n], -15)
                                    for n in BATCH)
    cut = np.array(offs)
    cut[3:] -= np.uint64(5)
    assert _same("inflate_batch", bodies[:int(cut[-1])], cut, sizes,
                 n_threads=1)[0] == "err"
    wrong = sizes.copy()
    wrong[2] += np.uint64(1)
    assert _same("inflate_batch", bodies, offs, wrong)[2] == \
        "decode failed in member 2"


def _gzip_members(n: int) -> bytes:
    return b"".join(gzip.compress(INPUTS["text"][i * 997:(i + 3) * 997],
                                  mtime=0) for i in range(n))


LF_STREAMS = {
    "native_65536": (DATA / "native_pgzf_65536.pgz").read_bytes(),
    "native_1024": (DATA / "native_pgzf_1024.pgz").read_bytes(),
    "device_small": (DATA / "pgzf_encode_small.pgz").read_bytes(),
}


@pytest.mark.parametrize("name", sorted(LF_STREAMS) + ["stdlib_gzip",
                                                       "cut"])
def test_pgzf_index_and_inflate_batch_at_match_reference(name):
    stream = (_gzip_members(3) if name == "stdlib_gzip"
              else LF_STREAMS["native_1024"][:-100] if name == "cut"
              else LF_STREAMS[name])
    idx = _same("pgzf_index", stream)
    if name in ("stdlib_gzip", "cut"):
        assert idx == ("ok", None)
        return
    starts, ends, _crcs, isizes = R.pgzf_index(stream)
    for n_threads in (0, 2):
        got = _same("inflate_batch_at", stream, starts, ends, isizes,
                    n_threads=n_threads)
        assert got[1][1][0] == gzip.decompress(stream)
    bad = isizes.copy()
    bad[-1] += np.uint64(3)
    assert _same("inflate_batch_at", stream, starts, ends, bad)[0] == "err"


TOKEN_CASES = {
    "stdlib_gzip": (_gzip_members(1), 10),
    "fixed": (RAW["text_fixed"], 0),
    "stored": (RAW["random_stored"], 0),
    "multi_block": (RAW["multi_block_l9_mem1"], 0),
    "greedy": (RAW["runs_greedy"], 0),
}


@pytest.mark.parametrize("name", sorted(TOKEN_CASES))
def test_inflate_tokens_matches_reference(name):
    stream, start = TOKEN_CASES[name]
    got = _same("inflate_tokens", stream, start, 1 << 19)
    assert got[0] == "ok"
    assert _same("inflate_tokens", stream, start, 16) == ("ok", None)


@pytest.mark.parametrize("name", sorted(ERRORS))
def test_inflate_tokens_errors(name):
    """Equal errors, but for input that ends inside the body: EOFError in
    the port (its decoders' own code), DeflateError in the reference."""
    stream, code = ERRORS[name]
    got = _call(P.inflate_tokens, stream, 0, 1 << 12)
    want = _call(R.inflate_tokens, stream, 0, 1 << 12)
    if code == -1:
        assert got == ("err", "EOFError", "truncated deflate stream")
        assert want == ("err", "DeflateError",
                        "token decode failed (rc -1)")
    else:
        assert got == want == ("err", "DeflateError",
                               f"token decode failed (rc {code})")


@pytest.mark.parametrize("n_threads", [0, 1, 4])
def test_inflate_tokens_batch_matches_reference(n_threads):
    stream = LF_STREAMS["device_small"]
    starts, ends, _c, _s = R.pgzf_index(stream)
    _same("inflate_tokens_batch", stream, starts, ends, 2048,
          n_threads=n_threads)
    # too small a budget, and a cut member: on one thread, the first
    # failing member is the one named (threads race to report one)
    assert _same("inflate_tokens_batch", stream, starts, ends, 64,
                 n_threads=1)[2] == "token decode failed in member 0"
    cut = ends.copy()
    cut[5] -= np.uint64(40)
    assert _same("inflate_tokens_batch", stream, starts, cut, 2048,
                 n_threads=1)[2] == "token decode failed in member 5"


@pytest.mark.parametrize("member", [1024, 4096, 65536])
@pytest.mark.parametrize("kw", [{}, {"lazy": True, "max_chain": 16},
                                {"block_size": 8192}],
                         ids=["greedy", "lazy_chain16", "bs8192"])
def test_deflate_batch_matches_reference(member, kw):
    data = INPUTS["multi_block"][:150000]
    offs = np.minimum(np.arange(0, len(data) + member, member),
                      len(data)).astype(np.uint64)
    offs = np.unique(offs)
    runs = [_same("deflate_batch", data, offs, n_threads=t, **kw)
            for t in (0, 1, 4)]
    assert runs[0] == runs[1] == runs[2]


def test_deflate_batch_frees_its_thread_buffers():
    """Each call starts new threads; the encoder's per-thread token buffer
    (6 bytes a position of ``block_size``) is freed when its thread exits.
    The reference's copy keeps it, ~2 MiB a call here (~220 MiB over these
    100 calls)."""
    def rss_mib():
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * 4096 / 2**20
    data = np.random.default_rng(5).integers(0, 256, 8 << 16,
                                             np.uint8).tobytes()
    offs = np.arange(0, (8 << 16) + 1, 65536, dtype=np.uint64)
    P.deflate_batch(data, offs, n_threads=8)
    before = rss_mib()
    for _ in range(100):
        P.deflate_batch(data, offs, n_threads=8)
    assert rss_mib() - before < 80


def _tokens(stream_names):
    rows = [R.inflate_tokens(RAW[n], 0, 1 << 19)[0] for n in stream_names]
    width = max(len(r) for r in rows) + 7
    packed = np.zeros((len(rows), width), np.int32)
    for i, r in enumerate(rows):
        packed[i, :len(r)] = r
    counts = np.array([len(r) for r in rows], np.int64)
    sizes = np.array([len(zlib.decompress(RAW[n], -15)) for n in stream_names],
                     np.uint64)
    return packed, counts, sizes


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "pairs"])
def test_expand_batch_matches_reference(packed):
    names = ["text_l6", "runs_greedy", "zeros_fixed", "random_stored"]
    toks, counts, sizes = _tokens(names)
    a, b = (toks, None) if packed else (toks & 511, toks >> 9)
    got = _same("expand_batch", a, b, counts, sizes)
    assert got[1][1][0] == b"".join(zlib.decompress(RAW[n], -15)
                                    for n in names)
    far = toks.copy()
    far[1, 0] = 3 | (1 << 9)                 # a match before any byte
    a, b = (far, None) if packed else (far & 511, far >> 9)
    assert _same("expand_batch", a, b, counts, sizes)[2] == \
        "token expansion failed in member 1"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_splice_matches_reference(seed):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, (5, 40), dtype=np.uint64
                         ).astype(np.uint32)
    bits = rng.integers(0, 40 * 32, 5).astype(np.int64)
    bits[0] = 0
    _same("splice", words, bits)


# ---------------------------------------------------------------------------
# pgzf's native routes
# ---------------------------------------------------------------------------
PLAIN = gzip.decompress(LF_STREAMS["native_65536"])     # 192 KiB


def _opts(matcher):
    from libflate_tpu.serial.deflate import EncodeOptions as RO
    from libflate_tpu_torch.serial.deflate import EncodeOptions as PO
    if matcher is None:
        return None, None
    kw = {"matcher": matcher}
    if matcher == "chain":
        kw["max_chain"] = 24
    return PO(**kw), RO(**kw)


@pytest.mark.parametrize("member", [1024, 65024, 65536])
@pytest.mark.parametrize("matcher", [None, "greedy", "lazy", "chain"])
def test_pgzf_compress_native_matches_reference(member, matcher):
    from libflate_tpu.formats import pgzf as rp
    from libflate_tpu_torch.formats import pgzf as pp
    data = PLAIN[:48 << 10] if member == 1024 else PLAIN
    po, ro = _opts(matcher)
    want = rp.compress(data, member, options=ro, engine="native")
    for n_threads in (1, 4):
        assert pp.compress(data, member, options=po, engine="native",
                           n_threads=n_threads) == want
    assert gzip.decompress(want) == data


def test_pgzf_compress_native_equals_committed_streams():
    from libflate_tpu_torch.formats import pgzf as pp
    for name, member in (("native_pgzf_65536.pgz", 65536),
                         ("native_pgzf_1024.pgz", 1024),
                         ("native_pgzf_65024.pgz", 65024)):
        stream = (DATA / name).read_bytes()
        assert pp.compress(gzip.decompress(stream), member,
                           engine="native") == stream
    raw = (DATA / "native_deflate_lazy_chain.bin").read_bytes()
    assert P.deflate_greedy(zlib.decompress(raw, -15), block_size=65536,
                            lazy=True, max_chain=32) == raw


def _flip_crc(stream: bytes, member_end: int) -> bytes:
    b = bytearray(stream)
    b[member_end - 8] ^= 0x40
    return bytes(b)


def _decode_cases():
    lf = LF_STREAMS["native_65536"]
    first_end = int(R.pgzf_index(lf)[1][0]) + 8
    gz = _gzip_members(4)
    return {
        "lf": lf,
        "lf_device": LF_STREAMS["device_small"],
        "stdlib_gzip": gz,
        "lf_flipped_crc": _flip_crc(lf, first_end),
        "stdlib_flipped_crc": _flip_crc(gz, len(gzip.compress(
            INPUTS["text"][:3 * 997], mtime=0))),
        "lf_cut": lf[:-1000],
        "stdlib_cut": gz[:-30],
        "empty": b"",
    }


DECODE_CASES = _decode_cases()


@pytest.mark.parametrize("python_index", [False, True],
                         ids=["c_index", "python_index"])
@pytest.mark.parametrize("name", sorted(DECODE_CASES))
def test_pgzf_decompress_native_matches_reference(name, python_index,
                                                  monkeypatch):
    """The reference's plaintext or its error, type and message; with
    ``python_index`` the C walk is refused on both sides, so LF streams
    take the Python index and ``inflate_batch``."""
    from libflate_tpu.formats import pgzf as rp
    from libflate_tpu_torch.formats import pgzf as pp
    if python_index:
        monkeypatch.setattr(R, "pgzf_index", lambda data: None)
        monkeypatch.setattr(P, "pgzf_index", lambda data: None)
    stream = DECODE_CASES[name]
    got = _call(pp.decompress, stream, engine="native", n_threads=2)
    want = _call(rp.decompress, stream, engine="native", n_threads=2)
    assert got == want
    if "flipped" in name or "cut" in name:
        assert got[0] == "err"
    else:
        assert got == ("ok", gzip.decompress(stream))
    if name.startswith("lf") and "flipped" in name:
        assert got[2].startswith("gzip CRC mismatch in member 0: stream "
                                 "says 0x")


def test_pgzf_engine_names():
    from libflate_tpu_torch.formats import pgzf as pp
    with pytest.raises(ValueError, match="engine must be"):
        pp.compress(b"abc", 1024, engine="tpu")
    with pytest.raises(ValueError, match="engine must be"):
        pp.decompress(gzip.compress(b"abc"), engine="bogus")


# ---------------------------------------------------------------------------
# The registry, the containers, the façades, the CLI
# ---------------------------------------------------------------------------
def test_registry_order_and_default():
    from libflate_tpu_torch import backend
    assert backend.names() == ["cpu", "cuda", "native", "serial"]
    assert backend._default == "cuda"
    assert backend.get("native").name == "native"


def _ref_and_port(kind):
    import libflate_tpu.formats as rf

    import libflate_tpu_torch.formats as pf
    __import__(f"libflate_tpu.formats.{kind}")
    __import__(f"libflate_tpu_torch.formats.{kind}")
    return getattr(rf, kind), getattr(pf, kind)


OPTION_CASES = {
    "default": {},
    "chain": {"matcher": "chain", "max_chain": 16},
    "greedy_eager": {"matcher": "greedy", "lazy": False},
    "fixed": {"block_type": "fixed"},
    "stored": {"block_type": "stored"},
    "none": {"matcher": "none"},
}


@pytest.mark.parametrize("kind", ["deflate", "zlib", "gzip"])
@pytest.mark.parametrize("opt", sorted(OPTION_CASES))
def test_containers_on_native_match_reference(kind, opt):
    """One-shot encode and decode on the ``native`` engine; ``options``
    are raw DEFLATE options (the reference's containers take them as
    such too)."""
    from libflate_tpu.serial.deflate import EncodeOptions as RO
    from libflate_tpu_torch.serial.deflate import EncodeOptions as PO
    rmod, pmod = _ref_and_port(kind)
    data = INPUTS["text"][:6000] if opt in ("fixed", "none", "stored") \
        else INPUTS["text"]
    kw = OPTION_CASES[opt]
    want = _call(rmod.compress, data, options=RO(**kw) if kw else None,
                 engine="native")
    got = _call(pmod.compress, data, options=PO(**kw) if kw else None,
                engine="native")
    assert got == want and got[0] == "ok"
    assert _call(pmod.decompress, got[1], engine="native") == \
        _call(rmod.decompress, got[1], engine="native") == ("ok", data)


@pytest.mark.parametrize("kind", ["deflate", "zlib", "gzip"])
def test_container_errors_on_native_match_reference(kind):
    rmod, pmod = _ref_and_port(kind)
    stream = rmod.compress(INPUTS["text"], engine="native")
    for bad in (stream[:len(stream) // 2], stream[:-1] + b"\x00",
                b"\x1f\x8b\x08" + bytes(12)):
        assert _call(pmod.decompress, bad, engine="native") == \
            _call(rmod.decompress, bad, engine="native")


@pytest.mark.parametrize("kind", ["gzip", "zlib"])
def test_encoder_on_native_matches_reference(kind):
    """The façade on an explicit engine buffers, as the reference's does:
    the same bytes as its ``Encoder(engine="native")``."""
    rmod, pmod = _ref_and_port(kind)
    data = INPUTS["multi_block"][:100000]
    outs = []
    for mod in (pmod, rmod):
        enc = mod.Encoder(engine="native")
        for i in range(0, len(data), 7777):
            enc.write(data[i:i + 7777])
        outs.append(enc.finish() if kind == "zlib" else enc.getvalue())
    if kind == "zlib":
        outs = [o.getvalue() if hasattr(o, "getvalue") else o for o in outs]
    assert outs[0] == outs[1]
    dec = pmod.Decoder(io.BytesIO(outs[0]))
    assert dec.read() == data


CLI_RUNS = [
    (["gzip-encode"], "plain"), (["zlib-encode"], "plain"),
    (["pgzf-encode", "--member-size", "4096"], "plain"),
    (["--stream", "gzip-encode"], "plain"),
    (["gzip-decode"], "gz"), (["gzip-decode-multi"], "gz2"),
    (["zlib-decode"], "zz"), (["pgzf-decode"], "pgz"),
]


@pytest.mark.parametrize("run", CLI_RUNS, ids=lambda r: " ".join(r[0]))
def test_cli_native_matches_reference(tmp_path, run):
    """``main(argv)`` of both CLIs with ``--engine native``.  The
    reference's ``--stream`` encoders ignore ``--engine`` (the serial
    ``BlockStreamer``); the port's buffer and encode on the engine named,
    so its ``--stream gzip-encode`` equals the reference's one-shot."""
    from libflate_tpu import cli as ref_cli
    from libflate_tpu_torch import cli as port_cli
    cmd, src_kind = run
    data = INPUTS["text"]
    src = tmp_path / "src"
    src.write_bytes({
        "plain": data, "gz": gzip.compress(data),
        "gz2": gzip.compress(data) + gzip.compress(data[:99]),
        "zz": zlib.compress(data),
        "pgz": LF_STREAMS["native_1024"]}[src_kind])
    outs = []
    for tag, mod in (("p", port_cli), ("r", ref_cli)):
        argv = cmd if mod is port_cli else [c for c in cmd
                                            if c != "--stream"]
        assert mod.main(["-i", str(src), "-o", str(tmp_path / tag),
                         "--engine", "native", *argv]) == 0
        outs.append((tmp_path / tag).read_bytes())
    assert outs[0] == outs[1] and outs[0]


def test_cli_help_names_native(capsys):
    from libflate_tpu_torch import cli as port_cli
    with pytest.raises(SystemExit):
        port_cli.main(["--help"])
    assert "cuda (default) | cpu | native | serial" in \
        capsys.readouterr().out.replace("\n", " ").replace("  ", " ")


# ---------------------------------------------------------------------------
# The build
# ---------------------------------------------------------------------------
def test_one_library_built_from_the_port_source():
    so = P.library_path()
    assert so.parent == P.BUILD_DIR and so.name.startswith("libflate_native-")
    P.load()
    assert so.exists()
    src = pathlib.Path(P.__file__).parent
    assert sorted(p.name for p in src.glob("*.cpp")) == ["libflate_native.cpp"]


def test_broken_source_raises_with_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "libflate_native.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(P, "_SRC", bad)
    monkeypatch.setattr(P, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(P, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as e:
        P.crc32(b"abc")
    assert "error" in str(e.value) and "libflate_native.cpp" in str(e.value)
    assert not list((tmp_path / "build").glob("*"))


def test_native_without_a_compiler_is_not_available(tmp_path, monkeypatch):
    from libflate_tpu_torch import backend
    monkeypatch.setattr(P, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(P, "_lib", None)
    monkeypatch.setattr(P.shutil, "which", lambda name: None)
    assert not P.available()
    with pytest.raises(RuntimeError, match="not available"):
        backend.get("native")
    from libflate_tpu_torch.formats import pgzf as pp
    with pytest.raises(RuntimeError, match="not available"):
        pp.decompress(LF_STREAMS["native_1024"], engine="native")


# ---------------------------------------------------------------------------
# utils/profiling.py and pgzf's trace hooks
# ---------------------------------------------------------------------------
def test_stage_timer_report_matches_reference():
    from libflate_tpu.utils.profiling import StageTimer as RT

    from libflate_tpu_torch.utils.profiling import StageTimer as PT
    reports = []
    for cls in (PT, RT):
        t = cls()
        with t.stage("a"):
            pass
        with t.stage("b"):
            pass
        t.times.update({"a": 0.25, "b": 1.5, "c": 0.003})
        t.counts.update({"a": 2, "b": 1, "c": 7})
        reports.append(t.report())
    assert reports[0] == reports[1]
    assert reports[0].splitlines()[0].startswith("b ")


def test_block_until_ready_returns_its_tree():
    import torch

    from libflate_tpu_torch.utils.profiling import block_until_ready
    tree = {"a": [torch.zeros(3), (torch.ones(2), 5)]}
    assert block_until_ready(tree) is tree


SYNC_SMALL = (DATA / "pgzf_sync_zipf_small.pgz").read_bytes()
SYNC_STAGES = ("header+ls parse", "block headers", "host staging",
               "sync kernel", "expand+crc", "D2H join")


def test_trace_unset_changes_nothing(monkeypatch, capsys):
    from libflate_tpu_torch.formats import pgzf as pp
    monkeypatch.delenv("LIBFLATE_TRACE", raising=False)
    assert pp._tracer() is None
    assert isinstance(pp._maybe_stage(None, "stage"),
                      contextlib.nullcontext)
    assert pp.decompress(SYNC_SMALL, device="cpu") == \
        gzip.decompress(SYNC_SMALL)
    assert capsys.readouterr().err == ""


def test_trace_stage_report_of_the_sync_decode(monkeypatch, capsys):
    from libflate_tpu_torch.formats import pgzf as pp
    monkeypatch.setenv("LIBFLATE_TRACE", "1")
    assert pp.decompress(SYNC_SMALL, device="cpu") == \
        gzip.decompress(SYNC_SMALL)
    err = capsys.readouterr().err.splitlines()
    assert err[0] == "[libflate-trace] sync decode"
    assert sorted(line.split("  ")[0].strip() for line in err[1:]) == \
        sorted(SYNC_STAGES)


def test_trace_torch_writes_a_profiler_trace(monkeypatch, capsys, tmp_path):
    from libflate_tpu_torch.formats import pgzf as pp
    monkeypatch.setenv("LIBFLATE_TRACE", "torch")
    monkeypatch.setenv("LIBFLATE_TRACE_DIR", str(tmp_path))
    assert pp.decompress(SYNC_SMALL, device="cpu") == \
        gzip.decompress(SYNC_SMALL)
    (trace,) = tmp_path.glob("libflate-*.pt.trace.json")
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("sync" in str(e.get("name", "")) or e.get("ph") == "X"
               for e in events)
    assert "[libflate-trace]" not in capsys.readouterr().err


def test_trace_torch_default_dir_follows_tmpdir(monkeypatch, tmp_path):
    import tempfile

    from libflate_tpu_torch.formats import pgzf as pp
    monkeypatch.setenv("LIBFLATE_TRACE", "torch")
    monkeypatch.delenv("LIBFLATE_TRACE_DIR", raising=False)
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(tempfile, "tempdir", None)
    assert pp.decompress(SYNC_SMALL, device="cpu") == \
        gzip.decompress(SYNC_SMALL)
    (trace,) = (tmp_path / "libflate_trace").glob("libflate-*.pt.trace.json")
    assert json.loads(trace.read_text())["traceEvents"]
