"""The port's gather kernel (plain version) vs the reference's
``gather_rows`` and ``_compose_cand`` in Pallas interpret mode.

The indices are a chain level's: the sort matcher's candidates of four
2 KiB members, composed with themselves, so they are window-local like
the main path's; a few are out of range to hit the clip.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from libflate_tpu_torch.ops import gather  # noqa: E402
from libflate_tpu_torch.ops import sort_match as sm  # noqa: E402

N = 2048


@pytest.fixture(scope="module")
def chain():
    rng = np.random.default_rng(21)
    words = [bytes(rng.integers(97, 105, rng.integers(3, 7),
                                dtype=np.uint8)) for _ in range(40)]
    text = b"\n".join(words[int(i)] for i in rng.zipf(1.3, 4000) % 40)
    rows = np.frombuffer(text[:4 * N], np.uint8).reshape(4, N).copy()
    cand, _m = sm.sort_candidates(torch.from_numpy(rows))
    return cand.numpy()


@pytest.fixture(scope="module")
def reference(chain):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LIBFLATE_PALLAS_INTERPRET", "1")
        from libflate_tpu.ops.pallas_gather import flatten_rows, gather_rows
        from libflate_tpu.ops.pipeline import _compose_cand
        idx = chain.copy()
        idx[:, 5::97] = N + 7                       # clipped to N - 1
        idx[:, 9::89] = -3                          # clipped to 0
        table = jnp.asarray(chain)
        flat = np.asarray(gather_rows(flatten_rows(table),
                                      flatten_rows(jnp.asarray(idx))))
        level2 = np.asarray(_compose_cand(table, table, 1024))
        level3 = np.asarray(_compose_cand(table, jnp.asarray(level2), 1024))
    return idx, flat.reshape(4, N), level2, level3


def test_gather_rows_plain_matches_reference(chain, reference):
    idx, want, _l2, _l3 = reference
    got = gather.gather_rows(torch.from_numpy(chain), torch.from_numpy(idx))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_fused_chain_step_matches_compose_cand(chain, reference):
    _idx, _flat, level2, level3 = reference
    table = torch.from_numpy(chain)
    got2 = gather.gather_rows(table, table, window=1024)
    got3 = gather.gather_rows(table, got2, window=1024)
    np.testing.assert_array_equal(got2.numpy(), level2)
    np.testing.assert_array_equal(got3.numpy(), level3)
    assert (level2 >= 0).mean() > 0.3 and (level3 < level2).any()


def test_gather_rows_rejects_bad_tables():
    with pytest.raises(ValueError, match="gather_rows"):
        gather.gather_rows(torch.zeros((2, 8), dtype=torch.int64),
                           torch.zeros((2, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match="gather_rows"):
        gather.gather_rows(torch.zeros((2, 8), dtype=torch.int32),
                           torch.zeros((3, 4), dtype=torch.int32))


@pytest.fixture(scope="module")
def two_tables():
    """gather_two's inputs at B = 2, R = N = 64, win 16: each 8-row group
    of indices has a window start (multiples of 8 from 0 to R - win) and
    indices inside it, on its edges and outside it, negative and past the
    table included, and the reference's outputs in interpret mode."""
    rng = np.random.default_rng(15)
    bsz, rows, n, win = 2, 64, 64, 16
    tab_a = rng.integers(-2**31, 2**31 - 1, (bsz, rows, 128), np.int64)
    tab_b = rng.integers(0, 1000, (bsz, rows, 128), np.int64)
    lo = rng.integers(0, (rows - win) // 8 + 1, (bsz, n // 8)) * 8
    lo[:, 0], lo[:, 1] = 0, rows - win
    row = np.repeat(lo, 8, axis=1)[:, :, None] + rng.integers(
        -3, win + 3, (bsz, n, 128))
    idx = row * 128 + rng.integers(0, 128, (bsz, n, 128))
    idx[:, :, 5] = lo.repeat(8, axis=1) * 128 - 1             # below
    idx[:, :, 6] = (lo.repeat(8, axis=1) + win) * 128         # just past
    idx[:, :, 7] = (lo.repeat(8, axis=1) + win) * 128 - 1     # last inside
    idx[0, 3, :4] = [-1, -129, rows * 128, 2**31 - 1]
    args = [a.astype(np.int32) for a in (tab_a, tab_b, idx, lo)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LIBFLATE_PALLAS_INTERPRET", "1")
        from libflate_tpu.ops.pallas_gather import gather_two
        want = gather_two(*(jnp.asarray(a) for a in args), win=win)
    return args, [np.asarray(w) for w in want], win


def test_gather_two_plain_matches_reference(two_tables):
    args, want, win = two_tables
    got = gather.gather_two(*(torch.from_numpy(a) for a in args), win=win)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), w)
    hit = want[1] != 0
    assert 0.5 < hit.mean() < 0.95 and (~hit[:, :, 5:7]).all()


def test_gather_two_rejects_bad_arguments():
    t = torch.zeros((2, 64, 128), dtype=torch.int32)
    i = torch.zeros((2, 64, 128), dtype=torch.int32)
    lo = torch.zeros((2, 8), dtype=torch.int32)
    for call in (lambda: gather.gather_two(t, t, i, lo, win=12),
                 lambda: gather.gather_two(t, t, i, lo, win=72),
                 lambda: gather.gather_two(t, t[:, :56], i, lo),
                 lambda: gather.gather_two(t, t, i, lo[:, :7])):
        with pytest.raises(ValueError, match="gather_two"):
            call()
