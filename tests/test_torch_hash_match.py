"""The port's hash matcher (plain version of its kernel) vs the
reference's ``pallas_lz77`` in Pallas interpret mode, bit for bit, at the
reference's own test shape of 128 members x 2048 positions.

Half the members are text, one is random bytes, and the rest carry
synthetic ids drawn from few buckets, so that many 8-position steps hold
four or more ids with the same low bucket bits: the kernel's insert-drop
rule then decides which candidates exist.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from libflate_tpu_torch.ops import hash_match as hm  # noqa: E402

B, N = 128, 2048


def _blocks():
    rng = np.random.default_rng(4)
    blocks = np.zeros((B, N), np.uint8)
    for i in range(B):
        piece = rng.integers(97, 107, 300, dtype=np.uint8).tobytes() * 10
        blocks[i] = np.frombuffer(piece[:N], np.uint8)
    blocks[1] = rng.integers(0, 256, N, dtype=np.uint8)
    return blocks


def _synthetic_ids(h):
    """Members 64..127: ids from 9 buckets (3 low-3-bit values x 3) and
    2 fingerprints."""
    rng = np.random.default_rng(5)
    bucket = (rng.integers(0, 3, (B // 2, N)) * 8
              + rng.integers(0, 3, (B // 2, N)))
    fp = rng.integers(0, 2, (B // 2, N))
    h = h.copy()
    h[B // 2:] = (bucket | (fp << hm.B_BITS)).astype(np.int32)
    return h


def _sequential(v, newest: int | None):
    """One member's candidates by a plain Python walk of the table rules;
    ``newest``: how many of a step's positions with the same low bucket
    bits are inserted (None: all)."""
    tbl, out = {}, np.full(len(v), -1)
    for base in range(0, len(v), 8):
        step = [int(x) for x in v[base:base + 8]]
        for j, x in enumerate(step):
            slot = tbl.get(x & 4095)
            if slot is not None and slot[1] == x >> 12:
                out[base + j] = slot[0]
            for i in range(j):
                if step[i] == x:
                    out[base + j] = base + i
        for j, x in enumerate(step):
            later = sum((y & 7) == (x & 7) for y in step[j + 1:])
            if newest is None or later < newest:
                tbl[x & 4095] = (base + j, x >> 12)
    return out


def _reformulated(ids):
    """Candidates without a table walk, as the kernel computes them: (1)
    each position's writer flag from its step's 8 ids alone; (2) the
    latest writer of its bucket in an earlier step, by a stable sort on
    the bucket and an exclusive running max of writer positions in each
    bucket's run (a step's writer is the last position of its (step,
    bucket) run, so the exclusive max leaves the own step out); (3) that
    writer's fingerprint against the position's (a negative one never
    matches, as the plain version's slot is then negative); (4) the step
    override: the latest earlier position of the step with an equal id."""
    v = ids.astype(np.int64)
    bsz, n = v.shape
    steps = v.reshape(bsz, n // 8, 8)
    later = np.arange(8)[None, :] > np.arange(8)[:, None]       # [j, i]
    low, bucket = steps & 7, steps & 4095
    newer_low = ((low[..., :, None] == low[..., None, :]) & later).sum(-1)
    newer_bucket = ((bucket[..., :, None] == bucket[..., None, :])
                    & later).any(-1)
    writer = ((newer_low < 3) & ~newer_bucket).reshape(bsz, n)
    fp = v >> 12
    out = np.empty((bsz, n), np.int64)
    for m in range(bsz):
        order = np.argsort(v[m] & 4095, kind="stable")
        run = np.cumsum(np.r_[True, np.diff((v[m] & 4095)[order]) != 0])
        wpos = np.where(writer[m][order], order, -1)
        incl = np.maximum.accumulate(run * (n + 1) + wpos + 1) - run * (n + 1)
        incl = np.maximum(incl - 1, -1)           # -1: none in the run yet
        excl = np.where(np.r_[True, run[1:] != run[:-1]], -1,
                        np.r_[-1, incl[:-1]])
        q = np.empty(n, np.int64)
        q[order] = excl
        fq = np.where(q >= 0, fp[m][np.maximum(q, 0)], -1)
        out[m] = np.where((q >= 0) & (fq >= 0) & (fq == fp[m]), q, -1)
    earlier = np.arange(8)[None, :] < np.arange(8)[:, None]     # [j, i]
    same = (steps[..., :, None] == steps[..., None, :]) & earlier
    prev = np.where(same, np.arange(8), -1).max(-1)
    base = (np.arange(n // 8) * 8)[None, :, None]
    return np.where(prev >= 0, base + prev, out.reshape(steps.shape)).reshape(
        bsz, n)


def _adversarial_ids():
    """(4, 4096) ids: all equal; 1-3 buckets with equal low bits (4-8
    positions of a step share them); one bucket, ids differing only in
    fp; any int32 (negative and >= 2^14 fingerprints among them)."""
    rng = np.random.default_rng(9)
    n = 4096
    wild = rng.integers(-2**31, 2**31, n)
    wild[::2] = (rng.integers(0, 3, n // 2)
                 | rng.choice([-2, -1, 0, 1, 1 << 14, 1 << 19], n // 2) << 12)
    ids = np.stack([np.full(n, 5 | 9 << 12),
                    rng.integers(0, 3, n) * 8 + 16
                    | rng.integers(0, 2, n) << 12,
                    77 | rng.integers(0, 3, n) << 12,
                    wild])
    return (ids & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


@pytest.fixture(scope="module")
def reference():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LIBFLATE_PALLAS_INTERPRET", "1")
        from libflate_tpu.ops import pallas_lz77 as ref
        blocks = _blocks()
        h = np.asarray(ref._keys_hashes(jnp.asarray(blocks))).T.copy()
        ids = _synthetic_ids(h)
        cand = np.asarray(ref.hash_candidates(jnp.asarray(ids.T))).T
        masked = np.asarray(ref.prefix_candidates_pallas(
            jnp.asarray(blocks), window=1024))
    return blocks, h, ids, cand, masked


def test_keys_hashes_match_reference(reference):
    blocks, h, _ids, _cand, _m = reference
    got = hm.keys_hashes(torch.from_numpy(blocks))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), h)


def test_hash_candidates_plain_matches_reference(reference):
    _b, _h, ids, cand, _m = reference
    got = hm.hash_candidates(torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), cand)


@pytest.mark.parametrize("member", [0, 1, B // 2, B - 1])
def test_insert_drop_rule_decides_the_candidates(reference, member):
    """A plain walk that inserts only the three newest positions per low
    bucket bits gives the reference's candidates; on the synthetic ids
    (steps with >= 4 equal low bits) inserting every position does not."""
    _b, _h, ids, cand, _m = reference
    v = ids[member]
    np.testing.assert_array_equal(_sequential(v, 3), cand[member])
    if member >= B // 2:
        low = (v & 7).reshape(N // 8, 8)
        assert max((low == u).sum(axis=1).max() for u in range(8)) >= 4
        assert (_sequential(v, None) != cand[member]).any()


def test_prefix_candidates_match_reference(reference):
    blocks, _h, _ids, _cand, masked = reference
    got = hm.prefix_candidates(torch.from_numpy(blocks), window=1024)
    np.testing.assert_array_equal(got.numpy(), masked)
    idx = np.arange(N)[None, :]
    assert ((masked < idx) | (masked == -1)).all()


@pytest.mark.parametrize("shape", [(2, 1020), (2, 2 ** 17 + 8)])
def test_bad_lengths_raise(shape):
    with pytest.raises(ValueError, match="hash_candidates"):
        hm.hash_candidates(torch.zeros(shape, dtype=torch.int32))


def test_reformulation_matches_reference_and_plain(reference):
    """The parallel reformulation the kernel is built on gives the
    reference's candidates at its own test shape."""
    _b, _h, ids, cand, _m = reference
    got = _reformulated(ids)
    np.testing.assert_array_equal(got, cand)
    np.testing.assert_array_equal(
        got, hm.hash_candidates_plain(torch.from_numpy(ids)).numpy())


def test_reformulation_matches_plain_on_adversarial_ids():
    ids = _adversarial_ids()
    want = hm.hash_candidates_plain(torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(_reformulated(ids), want)
    assert (want >= 0).sum(axis=1).min() > 0
