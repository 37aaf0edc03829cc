"""The speculative decode's kernels (plain versions) and glue vs the
reference, bit-exact.

The reference runs on the CPU with Pallas in interpret mode, its backend
check satisfied, and its fused jit (``_spec_fused_jit``) replaced by the
same stages called one by one, which is cheaper to run here; every stage
is recorded.  Inputs: the 4 members of ``pgzf_sync_zipf_small.pgz`` with
the LS index stripped (P = 14336 bit positions), the three hand-built
shared-table streams of ``test_pallas_interpret.py``, and random ``nxt``
arrays for the chunk exits.  The port's inputs come from the reference's
through ``convert.from_reference_spec_inputs``.  Tolerance 0: integers.
"""
import contextlib
import pathlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from chip_smoke import strip_sync_index  # noqa: E402
from libflate_tpu_torch import convert  # noqa: E402
from libflate_tpu_torch.formats import pgzf as port  # noqa: E402
from libflate_tpu_torch.ops import decode  # noqa: E402
from libflate_tpu_torch.ops import deflate_decode as dd  # noqa: E402

DATA = pathlib.Path(__file__).resolve().parent / "data"


@contextlib.contextmanager
def reference_spec(record: list):
    """The reference's pgzf module with its speculative path runnable on
    the CPU; each group's stages are appended to ``record``."""
    from jax.experimental import pallas as pl

    from libflate_tpu import native
    from libflate_tpu.formats import pgzf as ref
    from libflate_tpu.ops import deflate_decode as ref_dd
    from libflate_tpu.ops import pallas_decode as pd
    if not native.available():
        pytest.skip("the reference's header parse needs its C engine")
    orig = pl.pallas_call

    def interpret(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    def staged(words, lit_t, dist_t, starts_g, out_cap):
        tok, nxt = pd.speculative_decode_positions(words, lit_t, dist_t)
        exits = pd.chunk_exit_maps(nxt)
        entries = jax.vmap(ref_dd.chain_entries)(jnp.transpose(exits[0]),
                                                 starts_g)
        emit = pd.walk_emit(nxt, tok, jnp.transpose(entries)[None])
        out = ref_dd.tokens_from_emit_packed(emit[0], out_cap + 2)
        record.append({k: np.asarray(v) for k, v in dict(
            words=words, lit_t=lit_t, dist_t=dist_t, starts_g=starts_g,
            tok=tok, nxt=nxt, exits=exits, entries=entries, emit=emit,
            packed=out[0], nt=out[1], err=out[2]).items()})
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pd.pl, "pallas_call", interpret)
        mp.setattr(jax, "default_backend", lambda: "tpu")
        mp.setattr(ref, "_spec_fused_jit", lambda: staged)
        yield ref


@pytest.fixture(scope="module")
def stripped():
    return strip_sync_index((DATA / "pgzf_sync_zipf_small.pgz").read_bytes())


@pytest.fixture(scope="module")
def reference(stripped):
    """The reference's ``_spec_token_groups`` on the stripped fixture:
    (its one group's recorded stages, its yielded packed and nt)."""
    record = []
    with reference_spec(record) as ref:
        refs = ref.index_members(stripped)
        ((packed, nt, group, cap),) = list(ref._spec_token_groups(stripped,
                                                                  refs))
    (rec,) = record
    rec["n"] = len(group)
    return rec, np.asarray(packed), np.asarray(nt), cap


def _shared_streams():
    """Three shared-table member bodies (random, text, runs) and their
    first-symbol bits, as ``test_pallas_interpret.py:61-97`` builds them."""
    from libflate_tpu.serial.bitio import BitReader, BitWriter
    from libflate_tpu.serial.deflate import (_encode_tokens,
                                             read_dynamic_header_lengths,
                                             token_histograms,
                                             write_dynamic_header)
    from libflate_tpu.serial.huffman import HuffmanEncoder, package_merge
    from libflate_tpu.serial.lz77 import greedy_tokens
    rng = np.random.default_rng(1)
    chunks = [bytes(rng.integers(0, 30, 1200, dtype=np.uint8)),
              (b"speculative decode payload " * 60)[:1200],
              b"\x00" * 600 + b"abcabcabc" * 60]
    tokens = [greedy_tokens(c) for c in chunks]
    lit_freq = np.zeros(286, np.int64)
    dist_freq = np.zeros(30, np.int64)
    for t in tokens:
        lf, df = token_histograms(t)
        lit_freq += lf
        dist_freq += df
    ll = package_merge(lit_freq, 12)
    dl = package_merge(dist_freq, 8)
    bodies, starts = [], []
    for toks in tokens:
        w = BitWriter()
        w.write_bits(1, 1)
        w.write_bits(2, 2)
        write_dynamic_header(w, ll, dl)
        _encode_tokens(w, toks, HuffmanEncoder(ll), HuffmanEncoder(dl))
        bodies.append(w.getvalue())
        r = BitReader(bodies[-1])
        r.read_bits(3)
        read_dynamic_header_lengths(r)
        starts.append(r.bit_position)
    return bodies, starts, ll, dl


@pytest.fixture(scope="module")
def hand_built(reference):
    """The reference's position decode and chunk exits on the three
    hand-built streams, at the fixture's word count (one compile), with
    the codes of 'a' and of distance code 1 taken out of the tables, so
    that bad codes occur."""
    from libflate_tpu.ops.huffman import decode_table
    rec0 = reference[0]
    w = rec0["words"].shape[1]
    bodies, starts, ll, dl = _shared_streams()
    words = np.zeros((1, w, 128), np.uint32)
    for k, body in enumerate(bodies):
        arr = np.frombuffer(body + b"\x00" * ((-len(body)) % 4), "<u4")
        assert len(arr) <= w - 8
        words[0, :len(arr), k] = arr
    starts_g = np.zeros(128, np.int32)
    starts_g[:3] = starts
    lit_t = np.array(decode_table(jnp.asarray(ll), 12), np.int32)
    dist_t = np.array(decode_table(jnp.asarray(dl), 8), np.int32)
    lit_t[(lit_t >> 4) == ord("a")] = 0
    dist_t[(dist_t >> 4) == 1] = 0
    with reference_spec([]):
        from libflate_tpu.ops import pallas_decode as pd
        tok, nxt = pd.speculative_decode_positions(
            jnp.asarray(words), jnp.asarray(lit_t), jnp.asarray(dist_t))
        exits = pd.chunk_exit_maps(nxt)
    return {"words": words, "lit_t": lit_t, "dist_t": dist_t,
            "starts_g": starts_g, "tok": np.asarray(tok),
            "nxt": np.asarray(nxt), "exits": np.asarray(exits), "n": 3}


def _lanes(x, n):
    """A reference (1, rows, 128) array as the port's (n, rows)."""
    return np.asarray(x)[0].T[:n]


def _inputs(rec):
    return convert.from_reference_spec_inputs(
        rec["words"], rec["lit_t"], rec["dist_t"], rec["starts_g"], rec["n"])


@pytest.fixture(params=["fixture", "hand_built"])
def rec(request, reference):
    if request.param == "fixture":
        return reference[0]
    return request.getfixturevalue("hand_built")


def test_decode_positions_match_reference(rec):
    x = _inputs(rec)
    tok, nxt = decode.speculative_decode_positions(x["words"], x["lit_t"],
                                                   x["dist_t"])
    assert tok.dtype == nxt.dtype == torch.int32
    np.testing.assert_array_equal(tok.numpy(), _lanes(rec["tok"], rec["n"]))
    np.testing.assert_array_equal(nxt.numpy(), _lanes(rec["nxt"], rec["n"]))
    assert ((tok.numpy() & decode.EOB_FLAG) != 0).any()
    if rec["n"] == 3:
        assert ((tok.numpy() & decode.BAD_FLAG) != 0).any()


def test_chunk_exit_maps_match_reference(rec):
    got = decode.chunk_exit_maps(torch.from_numpy(_lanes(rec["nxt"],
                                                         rec["n"]).copy()))
    np.testing.assert_array_equal(got.numpy(), _lanes(rec["exits"],
                                                      rec["n"]))


def test_chunk_exit_maps_match_reference_on_random_orbits(reference):
    """Jumps of 1-48 bits (the TPU kernel's MAX_JUMP), fixed points, and
    jumps landing exactly on chunk edges: the backward sweep equals the
    TPU kernel's in-tile doubling and 7-group select."""
    from libflate_tpu.ops import pallas_decode as pd
    p_total = reference[0]["nxt"].shape[1]
    rng = np.random.default_rng(7)
    pos = np.arange(p_total)[:, None]
    nxt = pos + rng.integers(1, 49, (p_total, 128))
    nxt = np.where(rng.random((p_total, 128)) < 0.05, pos, nxt)
    edge = (pos // 512 + 1) * 512
    near = (edge - pos <= 48) & (rng.random((p_total, 128)) < 0.3)
    nxt = np.where(near, edge, nxt)[None].astype(np.int32)
    with reference_spec([]):
        want = np.asarray(pd.chunk_exit_maps(jnp.asarray(nxt)))
    got = decode.chunk_exit_maps(torch.from_numpy(nxt[0].T.copy()))
    np.testing.assert_array_equal(got.numpy(), want[0].T)
    assert (want[0] == nxt[0]).mean() < 0.2


def test_chunk_exit_maps_match_reference_on_group_edges(reference):
    """Jumps of 1-48 bits that land on the last position of a 32-position
    group, on every offset of the next group, and on the chunk end and
    one either side; whole chunks of one-bit jumps (31 in-group steps)."""
    from libflate_tpu.ops import pallas_decode as pd
    p_total = reference[0]["nxt"].shape[1]
    rng = np.random.default_rng(11)
    pos = np.arange(p_total)[:, None]
    group_edge = (pos // 32 + 1) * 32 + rng.integers(-1, 32, (p_total, 128))
    chunk_end = (pos // 512 + 1) * 512 + rng.integers(-1, 2, (p_total, 128))
    kind = rng.integers(0, 3, (p_total, 128))
    nxt = np.select([kind == 0, kind == 1],
                    [group_edge, chunk_end],
                    pos + rng.integers(1, 49, (p_total, 128)))
    nxt = np.where((nxt - pos >= 1) & (nxt - pos <= 48), nxt,
                   pos + rng.integers(1, 49, (p_total, 128)))
    nxt[:1024, :2] = pos[:1024] + 1
    nxt = nxt[None].astype(np.int32)
    with reference_spec([]):
        want = np.asarray(pd.chunk_exit_maps(jnp.asarray(nxt)))
    got = decode.chunk_exit_maps(torch.from_numpy(nxt[0].T.copy()))
    np.testing.assert_array_equal(got.numpy(), want[0].T)
    assert (want[0, :512, 0] == 512).all()
    assert (want[0] != nxt[0]).mean() > 0.5


def test_chain_entries_match_reference(reference):
    rec = reference[0]
    x = _inputs(rec)
    exits = torch.from_numpy(_lanes(rec["exits"], rec["n"]).copy())
    got = dd.chain_entries(exits, x["starts"])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), rec["entries"][:rec["n"]])


def test_walk_emit_matches_reference(reference):
    rec = reference[0]
    n = rec["n"]
    nxt, tok = (torch.from_numpy(_lanes(rec[k], n).copy())
                for k in ("nxt", "tok"))
    got = decode.walk_emit(nxt, tok,
                           torch.from_numpy(rec["entries"][:n].copy()))
    np.testing.assert_array_equal(got.numpy(), _lanes(rec["emit"], n))


def test_walk_emit_matches_reference_on_random_orbits(reference):
    """Orbits the decode never makes: jumps of 1-48, backward jumps and
    3-cycles inside a chunk (128-step overflows), fixed points, a chunk
    whose 128th token is a terminal, entries at -5, at P + 5, in the next
    chunk and anywhere.  The reference's kernel runs in interpret mode at
    the fixture's P, all 128 lanes."""
    from libflate_tpu.ops import pallas_decode as pd
    p_total = reference[0]["nxt"].shape[1]
    nc = p_total // 512
    rng = np.random.default_rng(9)
    pos = np.arange(p_total)[:, None]
    base = pos // 512 * 512
    nxt = pos + rng.integers(1, 49, (p_total, 128))
    back = np.maximum(pos - rng.integers(1, 60, (p_total, 128)), base)
    nxt = np.where(rng.random((p_total, 128)) < 0.05, back, nxt)
    nxt = np.where(rng.random((p_total, 128)) < 0.01, pos, nxt)
    for c in range(0, nc, 3):                   # 3-cycles
        p = c * 512 + 100
        nxt[p:p + 3] = np.array([p + 1, p + 2, p])[:, None]
    nxt[512:639, 0] = np.arange(513, 640)       # 127 steps, then
    nxt[639, 0] = 639                           # a terminal
    tok = rng.integers(0, 1 << 27, (p_total, 128))
    cb = np.arange(nc)[:, None] * 512 + np.zeros((1, 128), np.int64)
    anywhere = rng.integers(-5, p_total + 5, (nc, 128))
    ent = np.stack([cb, np.full_like(cb, -5), np.full_like(cb, p_total + 5),
                    cb + 512 + anywhere % 512, anywhere])
    ent = np.take_along_axis(ent, rng.integers(0, 5, (1, nc, 128)), 0)[0]
    ent[0, 0], ent[1, 0] = 100, 512
    nxt, tok, ent = (x[None].astype(np.int32) for x in (nxt, tok, ent))
    with reference_spec([]):
        want = np.asarray(pd.walk_emit(jnp.asarray(nxt), jnp.asarray(tok),
                                       jnp.asarray(ent)))
    got = decode.walk_emit(torch.from_numpy(nxt[0].T.copy()),
                           torch.from_numpy(tok[0].T.copy()),
                           torch.from_numpy(ent[0].T.copy()))
    np.testing.assert_array_equal(got.numpy(), want[0].T)
    flags = want[0].reshape(nc, decode.EMIT_ROWS, 128)[:, decode.MAX_EMIT]
    assert flags[0, 0] == -1 and flags[1, 0] == 0 and (flags == 0).any()
    assert (want[0].reshape(nc, decode.EMIT_ROWS, 128)[1, :decode.MAX_EMIT,
                                                        0] >= 0).all()


def test_tokens_from_emit_packed_matches_reference(reference):
    rec, packed, nt, cap = reference
    n = rec["n"]
    got = dd.tokens_from_emit_packed(
        torch.from_numpy(_lanes(rec["emit"], n).copy()), cap + 2)
    for g, want in zip(got, (packed, nt, rec["err"])):
        np.testing.assert_array_equal(g.numpy(), want[:n])
    assert not rec["err"][:n].any()


def test_tokens_from_emit_packed_error_rules_match_reference():
    """Synthetic emit rows: a clean member, a marked BAD token, no EOB, an
    overflowed chunk, and more tokens than slots (added into the last)."""
    from libflate_tpu.ops import deflate_decode as ref_dd
    rng = np.random.default_rng(3)
    nc = 4
    emit = np.full((128, nc, decode.EMIT_ROWS), -1, np.int32)
    emit[:, :, decode.MAX_EMIT:] = 0
    emit[:5, :, :40] = rng.integers(0, 1 << 25, (5, nc, 40))
    emit[:5, nc - 1, 40] = decode.EOB_FLAG
    emit[1, 2, 7] |= decode.BAD_FLAG
    emit[2, nc - 1, 40] = 17                       # no EOB
    emit[3, 1, decode.MAX_EMIT] = -1                # overflow stripe
    emit = emit.reshape(128, -1)
    want = ref_dd.tokens_from_emit_packed(jnp.asarray(emit.T), 100)
    got = dd.tokens_from_emit_packed(torch.from_numpy(emit[:5].copy()), 100)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w)[:5])
    assert got[2].tolist() == [False, True, True, True, False]
    assert got[1][0] == 160 and got[0][0, 99] != 0


def test_spec_token_groups_match_reference(stripped, reference):
    _rec, packed, nt, cap = reference
    refs = port.index_members(stripped)
    ((got_p, got_nt, group, got_cap),) = list(
        port._spec_token_groups(stripped, refs, "cpu"))
    assert group == [0, 1, 2, 3] and got_cap == cap
    np.testing.assert_array_equal(got_nt.numpy(), nt[:4])
    np.testing.assert_array_equal(got_p.numpy(), packed[:4])
    assert got_nt.tolist() == [1524, 1164, 1421, 1013]


def test_staging_matches_reference_inputs(stripped, reference):
    rec = reference[0]
    (st,) = list(port._spec_groups(stripped, port.index_members(stripped),
                                   "cpu"))
    for k, v in _inputs(rec).items():
        np.testing.assert_array_equal(st[k].numpy(), v.numpy())


@pytest.mark.parametrize("call", [
    lambda: decode.speculative_decode_positions(
        torch.zeros((2, 21), dtype=torch.int32),
        torch.zeros(4096, dtype=torch.int32),
        torch.zeros(256, dtype=torch.int32)),
    lambda: decode.chunk_exit_maps(torch.zeros((2, 500), dtype=torch.int32)),
    lambda: decode.walk_emit(torch.zeros((2, 512), dtype=torch.int32),
                             torch.zeros((2, 512), dtype=torch.int32),
                             torch.zeros((2, 2), dtype=torch.int32)),
    lambda: dd.chain_entries(torch.zeros((2, 512), dtype=torch.int32),
                             torch.zeros(3, dtype=torch.int32))])
def test_wrappers_reject_bad_shapes(call):
    with pytest.raises(ValueError):
        call()
