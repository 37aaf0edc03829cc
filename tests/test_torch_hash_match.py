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
