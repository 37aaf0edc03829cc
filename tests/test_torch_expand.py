"""Port vs reference: rank + mod-collapse, pointer chase, expand_members.

The reference (``device_expand.expand_members``, which runs the
``pallas_rank`` and ``pallas_expand`` kernels, and ``rank_emit_src``
alone) runs once per module in Pallas interpret mode, on one batch of
seven members at out_cap 2048; the port's plain versions must give
identical arrays.  Tokens come from the JAX-free serial greedy tokenizer
on seeded corpora.
"""
import bisect

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from libflate_tpu.serial.lz77 import greedy_tokens  # noqa: E402
from libflate_tpu_torch.ops import device_expand as port_de  # noqa: E402
from libflate_tpu_torch.ops import expand as port_ex  # noqa: E402
from libflate_tpu_torch.ops import rank as port_rank  # noqa: E402

OUT_CAP = 2048
T_CAP = 1024


@pytest.fixture(scope="module")
def interpret():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LIBFLATE_PALLAS_INTERPRET", "1")
        yield


def _corpus(n, seed):
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 123, rng.integers(3, 10),
                                dtype=np.uint8)) for _ in range(200)]
    return b"\n".join(words[int(i)] for i in
                      rng.zipf(1.4, n // 3) % 200)[:n]


def _pack(tokens, t_cap):
    arr = np.zeros((t_cap,), np.int32)
    for i, (a, b) in enumerate(tokens):
        arr[i] = (a & 511) | (b << 9)
    return arr, len(tokens)


@pytest.fixture(scope="module")
def members():
    """Seven members of one batch: text, a shorter text, a dist-1 run, a
    dist-3 run, then the error cases of tests/test_device_expand.py (a
    distance past the member's start, an output past out_cap) and a
    member with no tokens."""
    pieces = [_corpus(OUT_CAP, 1), _corpus(OUT_CAP - 301, 2),
              b"q" + b"a" * 2000, b"xyz" * 600]
    packed = np.zeros((len(pieces) + 3, T_CAP), np.int32)
    n_tok = np.zeros((len(pieces) + 3,), np.int32)
    for i, data in enumerate(pieces):
        packed[i], n_tok[i] = _pack(greedy_tokens(data), T_CAP)
    packed[4:6, 0] = ord("x")
    packed[4, 1] = 5 | (3 << 9)                 # dist 3 > history 1
    packed[5, 1:64] = 258 | (1 << 9)            # 1 + 63 * 258 > OUT_CAP
    n_tok[4:6] = [2, 64]
    return pieces, packed, n_tok


@pytest.fixture(scope="module")
def ref(interpret, members):
    """Reference outputs: expand_members on the batch, and rank_emit_src
    alone on the batch's rank inputs.  expand_members' bytes are the
    reference resolve kernel's output for the reference rank output."""
    from libflate_tpu.ops.device_expand import expand_members
    from libflate_tpu.ops.pallas_rank import rank_emit_src

    _, packed, n_tok = members
    expanded = tuple(map(np.asarray, expand_members(
        jnp.asarray(packed), jnp.asarray(n_tok), OUT_CAP)))
    starts, pk, valid, n_out, _err = port_de.rank_inputs(
        torch.from_numpy(packed), torch.from_numpy(n_tok), OUT_CAP)
    rank = tuple(np.array(a) for a in rank_emit_src(
        jnp.asarray(starts.numpy()), jnp.asarray(pk.numpy()),
        jnp.asarray(valid.numpy()), jnp.asarray(n_out.numpy()), OUT_CAP))
    return {"expand": expanded, "rank": rank,
            "rank_inputs": (starts, pk, valid, n_out)}


def _m(length, dist):
    return length | dist << 9


@pytest.fixture(scope="module")
def edge_ref(interpret):
    """The rank kernel's hard cases, one reference call: an overflowing
    member (1,490 starts clipped to out_cap - 1), 100 zero-length matches
    at one start (the reference's 128-wide in-bucket search bounds how
    many it can take), no tokens, distance-1 runs of 258 bytes with n_out ending
    inside the second 1024-position vreg, a bad distance, and random
    tokens with n_out cut mid-row."""
    from libflate_tpu.ops.pallas_rank import rank_emit_src

    rng = np.random.default_rng(5)
    text = [int(x) for x in rng.integers(97, 123, 400)]
    mixed = [text[i] if rng.random() < 0.5
             else _m(int(rng.integers(3, 40)), int(rng.integers(1, 300)))
             for i in range(400)]
    members = [[ord("x")] + [_m(258, 1)] * 1500,
               [97, 98, 99] + [_m(0, 2)] * 100 + [122, _m(258, 1)],
               [],
               [ord("a")] + [_m(258, 1)] * 7,
               [ord("a"), _m(5, 3)] + text[:50],
               mixed]
    packed = np.zeros((len(members), 2048), np.int32)
    for i, m in enumerate(members):
        packed[i, :len(m)] = m
    n_tok = np.array([len(m) for m in members], np.int32)
    starts, pk, valid, n_out, _err = port_de.rank_inputs(
        torch.from_numpy(packed), torch.from_numpy(n_tok), OUT_CAP)
    n_out[5] = min(int(n_out[5]), 1500)
    args = (starts, pk, valid, n_out)
    want = tuple(np.array(a) for a in rank_emit_src(
        *(jnp.asarray(a.numpy()) for a in args), OUT_CAP))
    return args, want


def test_rank_emit_src_plain_matches_reference_on_hard_cases(edge_ref):
    args, want = edge_ref
    assert int((args[0][0] == OUT_CAP - 1).sum()) > 1400
    for got, w in zip(port_rank.rank_emit_src(*args, OUT_CAP), want):
        np.testing.assert_array_equal(got.numpy(), w)


@pytest.fixture(scope="module")
def bucket_ref(interpret):
    """One reference ``rank_emit_src`` call on ``chip_smoke.
    rank_hard_cases``: rows that hold more than 128 token starts (124,
    300 and 2,000 zero-length matches, the last past the vreg's 2048-slot
    window) and a first token moved 5 positions on."""
    import chip_smoke
    from libflate_tpu.ops.pallas_rank import rank_emit_src

    *args, out_cap = chip_smoke.rank_hard_cases(torch.device("cpu"))
    assert out_cap == OUT_CAP
    want = tuple(np.array(a) for a in rank_emit_src(
        *(jnp.asarray(a.numpy()) for a in args), OUT_CAP))
    return args, want


def test_rank_emit_src_plain_matches_reference_past_128_starts(bucket_ref):
    args, want = bucket_ref
    got = port_rank.rank_emit_src(*args, OUT_CAP)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    # the search's bound shows: a plain covering rank differs
    assert not np.array_equal(want[0], np.asarray(
        _rank_oracle(*args, OUT_CAP, covering=True)[0]))


def _ref_slot(st, p):
    """The slot ``pallas_rank._rank_one`` reads for position p, one
    position at a time: row r = p // 128 counts at most 128 of the
    starts from C = #{starts < 128 r} on (whole 16-slot blocks, then a
    binary search in the block) inside its vreg's 2048-slot window, and
    reads the slot from the row of lane 0's id or the next one.  ``st``
    holds the sentinel starts (sorted: a valid prefix), padded past the
    window."""
    r, v = p // 128, p // 1024
    c = bisect.bisect_left(st, 128 * r)
    base = max(bisect.bisect_left(st, 1024 * v) - 1, 0) // 1024 * 1024

    def window(k):
        f = c - base + k
        return st[base + min(f // 128, 15) * 128 + f % 128]

    def local_id(q):
        fh = sum(1 for m in range(8) if window(16 * m + 15) <= q)
        off = 0
        for step in (8, 4, 2, 1):
            if window(min(16 * fh + off + step - 1, 127)) <= q:
                off += step
        return c - base - 1 + (128 if fh == 8 else 16 * fh + off)

    li, qa = local_id(p), local_id(128 * r) >> 7
    row = min(max(qa if li >> 7 == qa else qa + 1, 0), 15)
    return base + row * 128 + (li & 127)


def _rank_oracle(starts, pk, valid, n_out, out_cap, covering=False):
    """(src, lit) one position at a time, each from the slot
    :func:`_ref_slot` picks: the last valid token whose start is <= p
    wherever no 128-position row holds more than 128 starts.  With
    ``covering``, that token everywhere (slot 0 where there is none)."""
    starts, pk, valid, n_out = (np.asarray(x, np.int64)
                                for x in (starts, pk, valid, n_out))
    bsz, t = starts.shape
    src = np.zeros((bsz, out_cap), np.int64)
    lit = np.zeros((bsz, out_cap), np.int64)
    for b in range(bsz):
        st = [int(s) if ok else out_cap + 2
              for s, ok in zip(starts[b], valid[b])] + [out_cap + 2] * 4096
        tk = [int(x) for x in pk[b]] + [0] * 4096
        for p in range(out_cap):
            if covering:
                i = max(bisect.bisect_right(st[:t], p) - 1, 0)
            else:
                i = _ref_slot(st, p) if p < n_out[b] else 0
            s, d = st[i], (tk[i] >> 9) & 0xFFFF
            if p >= n_out[b]:
                src[b, p] = p
            elif d == 0:
                src[b, p], lit[b, p] = p, tk[i] & 255
            else:
                src[b, p] = min(max((p - s) % d + s - d, 0), out_cap - 1)
    return src, lit


_ORACLE_CASES = {
    "clipped_overflow": ([[ord("x")] + [_m(258, 1)] * 30], 1000, None),
    "zero_length_past_a_bucket": (
        [[97, 98, 99] + [_m(0, 2)] * 300 + [122, _m(258, 1)]], 1024, None),
    "zero_length_past_the_window": (
        [[97] + [_m(0, 1)] * 2500 + [_m(9, 1)] * 300], 3072, None),
    "no_tokens": ([[], [ord("z")]], 1024, None),
    "n_out_mid_row": ([[ord("a")] + [_m(258, 1)] * 20] * 3, 4097,
                      [0, 1234, 4097]),
    "distance_1_runs": ([[ord("a")] + [_m(258, 1)] * 7,
                         [ord("b"), ord("c")] + [_m(100, 2)] * 9], 2048,
                        None),
    "bad_distance": ([[ord("a"), _m(5, 3), _m(40, 300)] + [98] * 20], 1024,
                     None),
}


@pytest.mark.parametrize("case", sorted(_ORACLE_CASES))
def test_rank_emit_src_plain_matches_a_position_walk(case):
    """The plain rank against a position-by-position rendering of the
    reference's search, on inputs past its 128-wide bound (more than 128
    starts in one row, more than its window holds) or that the kernel's
    tiles split."""
    members, out_cap, n_out = _ORACLE_CASES[case]
    t_cap = max(len(m) for m in members) + 5
    packed = np.zeros((len(members), t_cap), np.int32)
    for i, m in enumerate(members):
        packed[i, :len(m)] = m
    n_tok = torch.tensor([len(m) for m in members], dtype=torch.int32)
    args = list(port_de.rank_inputs(torch.from_numpy(packed), n_tok,
                                    out_cap)[:4])
    if n_out is not None:
        args[3] = torch.tensor(n_out, dtype=torch.int32)
    got = port_rank.rank_emit_src(*args, out_cap)
    for g, w in zip(got, _rank_oracle(*args, out_cap)):
        np.testing.assert_array_equal(g.numpy(), w)


def test_rank_emit_src_plain_matches_a_position_walk_on_random_tables():
    """Random valid prefixes with repeated starts, a first token after
    position 0, random distances and n_out."""
    rng = np.random.default_rng(9)
    bsz, t, out_cap = 4, 300, 1500
    step = rng.integers(0, 9, (bsz, t))
    starts = (np.cumsum(step, 1) - step + (np.arange(bsz) == 1)[:, None]
              * 3).astype(np.int32)
    pk = rng.integers(0, 2 ** 25, (bsz, t)).astype(np.int32)
    pk = np.where(rng.random((bsz, t)) < 0.3, pk & 511, pk)
    valid = np.arange(t)[None, :] < rng.integers(0, t + 1, (bsz, 1))
    n_out = rng.integers(-5, out_cap + 5, bsz).astype(np.int32)
    args = [torch.from_numpy(np.ascontiguousarray(x))
            for x in (starts, pk, valid, n_out)]
    got = port_rank.rank_emit_src(*args, out_cap)
    for g, w in zip(got, _rank_oracle(*args, out_cap)):
        np.testing.assert_array_equal(g.numpy(), w)


def test_rank_emit_src_plain_matches_reference(ref):
    src, lit = port_rank.rank_emit_src(*ref["rank_inputs"], OUT_CAP)
    assert src.dtype == lit.dtype == torch.int32
    np.testing.assert_array_equal(src.numpy(), ref["rank"][0])
    np.testing.assert_array_equal(lit.numpy(), ref["rank"][1])


def test_resolve_bytes_plain_matches_reference(ref):
    got = port_ex.resolve_bytes(torch.from_numpy(ref["rank"][0]),
                                torch.from_numpy(ref["rank"][1]))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), ref["expand"][0])


@pytest.mark.parametrize("seed", range(3))
def test_resolve_bytes_random_pointers(seed):
    """Random backward pointers against a sequential loop: each byte is
    its source's byte, or its literal at a fixpoint."""
    rng = np.random.default_rng(seed)
    n = 3000
    pos = np.arange(n)
    src = np.where(rng.random((2, n)) < 0.2, pos,
                   (rng.random((2, n)) * pos).astype(np.int64))
    lit = rng.integers(0, 256, (2, n))
    want = np.zeros((2, n), np.uint8)
    for p in range(n):
        want[:, p] = np.where(src[:, p] == p, lit[:, p],
                              want[np.arange(2), src[:, p]])
    got = port_ex.resolve_bytes(torch.from_numpy(src.astype(np.int32)),
                                torch.from_numpy(lit.astype(np.int32)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_expand_members_matches_reference_and_data(ref, members):
    pieces, packed, n_tok = members
    out, n_out, err = port_de.expand_members(
        torch.from_numpy(packed), torch.from_numpy(n_tok), OUT_CAP)
    w_out, w_n, w_err = ref["expand"]
    np.testing.assert_array_equal(out.numpy(), w_out)
    np.testing.assert_array_equal(n_out.numpy(), w_n)
    np.testing.assert_array_equal(err.numpy(), w_err)
    for i, data in enumerate(pieces):
        assert out[i, :len(data)].numpy().tobytes() == data
        assert not out[i, len(data):].any()


def test_expand_members_error_flags(ref, members):
    """bad_dist and overflow flag their own members only."""
    _, packed, n_tok = members
    _, n_out, err = port_de.expand_members(
        torch.from_numpy(packed), torch.from_numpy(n_tok), OUT_CAP)
    assert err.tolist() == [False] * 4 + [True, True, False]
    assert ref["expand"][2].tolist() == err.tolist()
    assert n_out.tolist()[4:] == [6, OUT_CAP, 0]


def test_resolve_bytes_non_match_pointers_give_zero():
    src = torch.tensor([[0, 0, 5, 1, -1, 3]], dtype=torch.int32)
    lit = torch.tensor([[65, 66, 67, 68, 69, 70]], dtype=torch.int32)
    got = port_ex.resolve_bytes(src, lit)
    assert got.tolist() == [[65, 65, 0, 65, 0, 65]]


def test_wrappers_reject_mismatched_shapes():
    z = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        port_ex.resolve_bytes(z, z[:1])
    with pytest.raises(ValueError):
        port_rank.rank_emit_src(z, z, z.bool(), torch.zeros(3), 1024)
