"""The port's generic device decode against the reference's, on the CPU.

``decode_symbols`` (its plain version here) against the reference's
``decode_symbols_chunked`` and ``decode_symbols`` on every case of
``chip_smoke.decode_hard_cases`` (zlib bodies of 2-8 KiB, streams cut at
max_tokens, start bits off the word, a table hole, an incomplete code,
the fixed code's 286 / 287 and an empty final block, random words under
any-int32 tables, tables past the kernel's on-chip subtable area): all
five outputs equal.  ``compact_tables_plain``, the model of the kernel's
on-chip tables, looked up at every one of the 2^15 indices of the hard
cases' tables, the generic shard's and random int32 tables.  ``tables_from_lengths`` on
dynamic, fixed, empty-distance and over-subscribed alphabets;
``expand_tokens_device`` with and without history, with an overflow and
a distance past the history; ``inflate_device`` on multi-block, stored,
fixed and corrupt streams: the same bytes and end bit, or the same
exception type.  Every reference call runs once, in the module fixture.
"""
import functools
import struct
import zlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from chip_smoke import decode_hard_cases, generic_shard  # noqa: E402
from libflate_tpu_torch.ops import deflate_decode as port  # noqa: E402
from libflate_tpu_torch.ops.huffman import tables_from_lengths  # noqa: E402

#: cases also held against the reference's unchunked ``decode_symbols``
ONE_CHUNK = ("zlib bodies", "fixed code: 286 / 287, empty final block")


def _stream_tables(case):
    """(B, 2**15) litlen and distance tables, one row a stream, numpy."""
    _w, _s, lit, dist, tabs, _mt, _ch = case
    if tabs is None:
        lt, dt = tables_from_lengths(torch.from_numpy(lit),
                                     torch.from_numpy(dist))
        return lt.numpy(), dt.numpy()
    if len(tabs) == 2:
        return tabs
    return tabs[0][tabs[2]], tabs[1][tabs[2]]


def _port_args(case):
    words, starts, lit, dist, tabs, _mt, _ch = case
    if tabs is None:
        lt, dt = tables_from_lengths(torch.from_numpy(lit),
                                     torch.from_numpy(dist))
        tidx = None
    else:
        lt, dt = torch.from_numpy(tabs[0]), torch.from_numpy(tabs[1])
        tidx = torch.from_numpy(tabs[2]) if len(tabs) > 2 else None
    return torch.from_numpy(words), torch.from_numpy(starts), lt, dt, tidx


def _alphabets():
    """name -> ((B, N) litlen, (B, 30) distance) code lengths."""
    rng = np.random.default_rng(5)
    bodies = []
    for n in (3000, 9000):
        text = bytes(rng.integers(97, 107, n, np.uint8))
        c = zlib.compressobj(9, zlib.DEFLATED, -15)
        bodies.append(c.compress(text) + c.flush())
    from libflate_tpu_torch.serial.deflate import parse_block_headers
    from libflate_tpu_torch.spec import constants as C
    lit, dist, _s, flags = parse_block_headers(bodies)
    assert (flags == 5).all()
    fixed = (C.fixed_litlen_lengths()[None, :],
             C.fixed_dist_lengths()[None, :])
    empty = (lit[:1, :286].copy(), np.zeros((1, 30), np.int32))
    wild = (rng.integers(0, 16, (3, 286)).astype(np.int32),
            rng.integers(0, 16, (3, 30)).astype(np.int32))
    return {"dynamic": (lit, dist), "fixed": fixed, "empty distances": empty,
            "over-subscribed": wild}


def _history_tokens():
    """Two rows of tokens against a 1000-byte history (hist_cap 2048):
    literals, matches into the history, an overlapping run; row 1 adds a
    match 3 bytes past the history's start."""
    rng = np.random.default_rng(9)
    hist = np.zeros((2, 2048), np.uint8)
    hist[:, -1000:] = rng.integers(0, 256, 1000, np.uint8)
    toks = [(65, 0), (10, 500), (20, 1), (258, 1001), (5, 7), (66, 0)]
    a = np.zeros((2, 16), np.int32)
    b = np.zeros((2, 16), np.int32)
    for i, (x, y) in enumerate(toks):
        a[:, i], b[:, i] = x, y
    a[1, 6], b[1, 6] = 4, 1000 + 300 + 3       # 300 bytes written so far
    return a, b, np.array([6, 7], np.int32), hist, np.array([1000, 1000],
                                                             np.int32)


def _raw(data: bytes, level: int = 6, mem: int = 8,
         strategy: int = zlib.Z_DEFAULT_STRATEGY) -> bytes:
    c = zlib.compressobj(level, zlib.DEFLATED, -15, mem, strategy)
    return c.compress(data) + c.flush()


def _inflate_streams():
    rng = np.random.default_rng(11)
    vocab = [bytes(rng.integers(97, 123, rng.integers(3, 9), np.uint8))
             for _ in range(120)]
    text = b" ".join(vocab[i] for i in rng.integers(0, 120, 900))[:4000]
    multi = _raw(text, 6, 1)                    # memLevel 1: many blocks
    c = zlib.compressobj(6, zlib.DEFLATED, -15)
    stored = (c.compress(text[:1500]) + c.flush(zlib.Z_FULL_FLUSH)
              + b"\x01" + struct.pack("<HH", 700, 700 ^ 0xFFFF)
              + text[1500:2200])
    flipped = bytearray(multi)
    flipped[len(flipped) // 2] ^= 0x55
    bad_len = b"\x01" + struct.pack("<HH", 5, 5) + b"abcde"
    return {"multi-block": multi, "stored block": stored,
            "fixed block": _raw(text[:1500], 6, 8, zlib.Z_FIXED),
            "flipped byte": bytes(flipped),
            "truncated": _raw(text[:300])[:-5],
            "reserved block type": b"\x07\x00",
            "stored LEN/NLEN mismatch": bad_len}


def _outcome(fn, data):
    try:
        res = fn(data)
    except (ValueError, EOFError) as e:
        return type(e).__name__
    return bytes(res.data), res.end_bit


@pytest.fixture(scope="module")
def cases():
    return decode_hard_cases()


@pytest.fixture(scope="module")
def ref(cases):
    """Every reference call of this file."""
    from libflate_tpu.ops import deflate_decode as R
    out = {"chunked": {}, "one_chunk": {}, "tables": {}}
    for name, case in cases.items():
        words, starts, *_rest, max_tokens, chunk = case
        lt, dt = _stream_tables(case)
        args = (jnp.asarray(words.view(np.uint32)), jnp.asarray(starts),
                jnp.asarray(lt), jnp.asarray(dt))
        out["chunked"][name] = [np.asarray(x) for x in
                                R.decode_symbols_chunked(*args, max_tokens,
                                                         chunk)]
        if name in ONE_CHUNK:
            out["one_chunk"][name] = [np.asarray(x) for x in
                                      R.decode_symbols(*args, max_tokens)]
    for name, (lit, dist) in _alphabets().items():
        out["tables"][name] = [np.asarray(x) for x in R.tables_from_lengths(
            jnp.asarray(lit), jnp.asarray(dist))]
    a, b, nt, _e, _r = out["chunked"]["zlib bodies"]
    out["expand"] = {
        cap: [np.asarray(x) for x in R.expand_tokens_device(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(nt), cap)]
        for cap in (8192, 4096)}
    ha, hb, hn, hist, hlen = _history_tokens()
    out["expand_history"] = [np.asarray(x) for x in R.expand_tokens_device(
        jnp.asarray(ha), jnp.asarray(hb), jnp.asarray(hn), 512,
        jnp.asarray(hist), jnp.asarray(hlen), 2048)]
    out["inflate"] = {name: _outcome(R.inflate_device, data)
                      for name, data in _inflate_streams().items()}
    return out


def test_hard_cases_cover_what_they_name(ref):
    """The cases reach what they are for: a cut budget (err with every
    slot written, or no error when the chunked scan runs past it), a bad
    code, 286 / 287 as length 258, an empty block, an EOB."""
    r = ref["chunked"]
    assert not r["zlib bodies"][4].any()
    assert r["cut at max_tokens, one chunk"][4].all()
    assert (r["cut at max_tokens, one chunk"][2] == 300).all()
    assert not r["cut at max_tokens, chunked"][4].any()
    assert r["table hole"][4].all()
    a, b, n, _end, err = r["fixed code: 286 / 287, empty final block"]
    assert list(a[0, :5]) == [97, 258, 258, 3, 98] and list(n) == [5, 0]
    assert not err.any()
    assert r["incomplete code"][4].any() and not r["incomplete code"][4].all()


@pytest.mark.parametrize("name", list(decode_hard_cases()))
def test_decode_symbols_plain_matches_reference_chunked(cases, ref, name):
    words, starts, lt, dt, tidx = _port_args(cases[name])
    *_, max_tokens, chunk = cases[name]
    got = port.decode_symbols(words, starts, lt, dt, max_tokens, chunk, tidx)
    for g, w in zip(got, ref["chunked"][name]):
        np.testing.assert_array_equal(g.numpy(), w.astype(g.numpy().dtype))


@pytest.mark.parametrize("name", ONE_CHUNK)
def test_decode_symbols_plain_matches_reference_unchunked(cases, ref, name):
    """``chunk=max_tokens`` is the reference's ``decode_symbols``."""
    words, starts, lt, dt, tidx = _port_args(cases[name])
    *_, max_tokens, _chunk = cases[name]
    got = port.decode_symbols(words, starts, lt, dt, max_tokens, max_tokens,
                              tidx)
    for g, w in zip(got, ref["one_chunk"][name]):
        np.testing.assert_array_equal(g.numpy(), w.astype(g.numpy().dtype))


def test_decode_symbols_rejects_bad_arguments():
    w = torch.zeros((2, 8), dtype=torch.int32)
    s = torch.zeros(2, dtype=torch.int32)
    t = torch.zeros((2, 1 << 15), dtype=torch.int32)
    with pytest.raises(ValueError):
        port.decode_symbols(w, s, t[:1], t[:1], 10)
    with pytest.raises(ValueError):
        port.decode_symbols(w, s.to(torch.int64), t, t, 10)
    with pytest.raises(ValueError):
        port.decode_symbols(w, s, t, t, 10,
                            table_idx=torch.zeros(3, dtype=torch.int32))


@pytest.mark.parametrize("start,tidx", [
    ((0, -1), None), ((0, 5), (0, 2)), ((0, 5), (-1, 0))])
def test_decode_symbols_rejects_out_of_range_values(start, tidx):
    """A negative start bit or a table index outside [0, T) would send the
    kernel's reads outside the row or the tables: both routes refuse it."""
    w = torch.zeros((2, 8), dtype=torch.int32)
    t = torch.zeros((2, 1 << 15), dtype=torch.int32)
    idx = None if tidx is None else torch.tensor(tidx, dtype=torch.int32)
    with pytest.raises(ValueError, match="start_bit must be >= 0"):
        port.decode_symbols(w, torch.tensor(start, dtype=torch.int32), t, t,
                            10, table_idx=idx)


@pytest.mark.parametrize("name", list(_alphabets()))
def test_tables_from_lengths_match_reference(ref, name):
    lit, dist = _alphabets()[name]
    got = tables_from_lengths(torch.from_numpy(lit), torch.from_numpy(dist))
    for g, w in zip(got, ref["tables"][name]):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), w)
    if name == "empty distances":
        assert not got[1].any()


@pytest.mark.parametrize("cap", [8192, 4096])
def test_expand_tokens_device_matches_reference(ref, cap):
    """Without history; at 4096 two rows overflow."""
    a, b, nt = (torch.tensor(x) for x in ref["chunked"]["zlib bodies"][:3])
    got = port.expand_tokens_device(a, b, nt, cap)
    for g, w in zip(got, ref["expand"][cap]):
        np.testing.assert_array_equal(g.numpy(), w)
    assert bool(got[2].any()) == (cap == 4096)


def test_expand_tokens_device_with_history_matches_reference(ref):
    """Matches into a right-aligned history and an overlapping run; the
    second row's last match reaches 3 bytes before the history."""
    ha, hb, hn, hist, hlen = _history_tokens()
    got = port.expand_tokens_device(
        torch.from_numpy(ha), torch.from_numpy(hb), torch.from_numpy(hn),
        512, torch.from_numpy(hist), torch.from_numpy(hlen), 2048)
    for g, w in zip(got, ref["expand_history"]):
        np.testing.assert_array_equal(g.numpy(), w)
    assert got[2].tolist() == [False, True]


@pytest.mark.parametrize("name", list(_inflate_streams()))
def test_inflate_device_matches_reference(ref, name):
    data = _inflate_streams()[name]
    got = _outcome(lambda d: port.inflate_device(d, device="cpu"), data)
    assert got == ref["inflate"][name]
    if not isinstance(got, str):
        assert got[0] == zlib.decompressobj(-15).decompress(data)


def test_inflate_device_cuda_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.inflate_device(_raw(b"abc"), device="cuda")


@functools.lru_cache(maxsize=1)
def _layout_tables():
    """name -> [(kind, 2**15 int32 table)]: every stream's tables of each
    hard case, four generic-shard members' and random int32 tables."""
    import gzip
    import pathlib
    from libflate_tpu_torch.formats import pgzf
    from libflate_tpu_torch.serial.deflate import parse_block_headers
    out = {}
    for name, case in decode_hard_cases().items():
        lt, dt = _stream_tables(case)
        out[name] = [(k, torch.from_numpy(np.ascontiguousarray(t)))
                     for tabs, k in ((lt, "lit"), (dt, "dist")) for t in tabs]
    data = pathlib.Path(__file__).parent / "data" / "pgzf_sync_zipf_2m.pgz"
    shard = generic_shard(gzip.decompress(data.read_bytes())[:4 * 65536])
    bodies = [shard[r.body:r.end - 8] for r in pgzf.index_members(shard)]
    lit, dist, _s, _f = parse_block_headers(bodies)
    lt, dt = tables_from_lengths(torch.from_numpy(lit), torch.from_numpy(dist))
    out["generic shard"] = [(k, t) for tabs, k in ((lt, "lit"), (dt, "dist"))
                            for t in tabs]
    rng = np.random.default_rng(23)
    out["random int32"] = [
        (k, torch.from_numpy(rng.integers(-2**31, 2**31 - 1, 1 << 15,
                                          dtype=np.int64).astype(np.int32)))
        for k in ("lit", "dist", "lit")]
    return out


def _decode_view(entries: np.ndarray, kind: str):
    """What the decode reads of raw entries, from the RFC's rows: (width,
    is a length, the literal / EOB symbol or the length's base and extra
    bits) for litlen; (width, base, extra bits) for distance."""
    from libflate_tpu_torch.spec import constants as C
    e = entries.astype(np.int64)
    if kind == "lit":
        sym = e >> 4
        li = np.clip(sym - 257, 0, 28)
        is_len = sym > 256
        return (e & 15, is_len, np.where(is_len, C.LENGTH_BASE[li], sym),
                np.where(is_len, C.LENGTH_EXTRA[li], 0))
    ds = np.clip(e >> 4, 0, 29)
    return e & 15, C.DIST_BASE[ds], C.DIST_EXTRA[ds]


def _merged_view(merged: np.ndarray, kind: str):
    """The same fields read back from merged entries, as the kernel reads
    them."""
    v = merged.astype(np.int64)
    if kind == "lit":
        is_len = v > port.MAX_LITERAL
        return (v & 15, is_len, np.where(is_len, (v >> 7) & 511, v >> 4),
                np.where(is_len, (v >> 4) & 7, 0))
    return v & 15, v >> 8, (v >> 4) & 15


@pytest.mark.parametrize("name", list(decode_hard_cases())
                         + ["generic shard", "random int32"])
def test_compact_tables_plain_lookup_at_every_index(name):
    """The on-chip layout model: a lookup through the root, the
    subtables and, past the slots, the table itself gives every one of
    the 2^15 indices the merged entry of ``table[idx]``, and the merged
    entry keeps all the decode reads of the raw one.  Random int32 tables
    make every prefix non-uniform."""
    idx = torch.arange(1 << 15)
    for kind, table in _layout_tables()[name]:
        layout = port.compact_tables_plain(table, kind)
        root_bits, cap = port.COMPACT[kind]
        got = port.compact_lookup_plain(layout, table, kind, idx)
        merged = port.merged_entries_plain(table, kind)
        np.testing.assert_array_equal(got.numpy(), merged.numpy())
        for g, w in zip(_merged_view(got.numpy(), kind),
                        _decode_view(table.numpy(), kind)):
            np.testing.assert_array_equal(g, w)
        ext = merged.view(1 << (15 - root_bits), 1 << root_bits)
        uniform = (ext == ext[:1]).all(dim=0)
        assert layout["n"] == int((~uniform).sum())
        assert layout["sub"].shape == (min(layout["n"], cap),
                                       1 << (15 - root_bits))
        np.testing.assert_array_equal(layout["root"][uniform].numpy(),
                                      ext[0][uniform].numpy())
        if name == "random int32":
            assert layout["n"] == 1 << root_bits


def test_past_subtable_cases_overflow_the_slots(ref):
    """The two overflow cases reach the device-memory path: the 11-bit
    literal code has 100 non-uniform litlen prefixes, more than the
    slots, and 14 distance ones, within them; it decodes its 700 tokens
    and the EOB; the any-int32 tables have every prefix non-uniform and
    run to the step budget."""
    tabs = _layout_tables()
    code = "past the on-chip subtables: 11-bit literal codes"
    wild = "every prefix non-uniform: any-int32 tables, no zero width"
    ns = [(k, port.compact_tables_plain(t, k)["n"]) for k, t in tabs[code]]
    assert ns == [("lit", 100), ("lit", 100), ("dist", 14), ("dist", 14)]
    assert 100 > port.COMPACT["lit"][1] and 14 <= port.COMPACT["dist"][1]
    for kind, t in tabs[wild]:
        assert port.compact_tables_plain(t, kind)["n"] == \
            1 << port.COMPACT[kind][0]
    _a, _b, n, _e, err = ref["chunked"][code]
    assert list(n) == [700, 700] and not err.any()
    _a, _b, n, _e, err = ref["chunked"][wild]
    assert list(n) == [512, 512] and err.all()
