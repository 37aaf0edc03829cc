"""The port's content-sort matcher and length stage vs the reference.

The reference's ``sort_candidates`` (bitonic sort + back-scan kernel,
then the ``sort_pairs`` unsort, in Pallas interpret mode) runs once per
module at n = 1024 — phase A of its network only; larger n costs minutes
of XLA:CPU compile in interpret mode.  The port's plain versions of its
two kernels (``sort_keys``, ``scan_emit``) must give the same
``(cand, m)`` bit for bit, and ``lengths_stage`` the same lengths as the
reference's ``_lengths_stage`` on the sort matcher's branch.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from libflate_tpu_torch import convert  # noqa: E402
from libflate_tpu_torch.ops import pipeline as port_pipe  # noqa: E402
from libflate_tpu_torch.ops import sort_match as sm  # noqa: E402

N = 1024


def _rows(seed: int) -> tuple[np.ndarray, np.ndarray]:
    """Four 1 KiB members: Zipf words, a run-heavy row, a short member
    (zero tail) and random bytes."""
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 103, rng.integers(3, 8),
                                dtype=np.uint8)) for _ in range(30)]
    text = b"".join(words[int(i)] for i in rng.zipf(1.3, 1200) % 30)
    rows = np.zeros((4, N), np.uint8)
    rows[0] = np.frombuffer(text[:N], np.uint8)
    rows[1] = np.repeat(rng.integers(0, 4, N // 16, dtype=np.uint8), 16)
    rows[2, :700] = np.frombuffer(text[N:N + 700], np.uint8)
    rows[3] = rng.integers(0, 256, N, dtype=np.uint8)
    return rows, np.array([N, N, 700, N - 5], np.int32)


@pytest.fixture(scope="module")
def reference():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LIBFLATE_PALLAS_INTERPRET", "1")
        from libflate_tpu.ops.sort_match import sort_candidates
        rows, n_valid = _rows(3)
        cand, m = map(np.asarray, sort_candidates(jnp.asarray(rows)))
    return rows, n_valid, cand, m


def test_sort_keys_plain_is_a_stable_signed_sort():
    rng = np.random.default_rng(0)
    key = rng.integers(-4, 4, (3, 2048), dtype=np.int64).astype(np.int32)
    key[1] = rng.integers(-2 ** 31, 2 ** 31, 2048, dtype=np.int64)
    sk, sp = sm.sort_keys(torch.from_numpy(key))
    for b in range(3):
        order = np.lexsort((np.arange(2048), key[b]))
        np.testing.assert_array_equal(sp[b].numpy(), order)
        np.testing.assert_array_equal(sk[b].numpy(), key[b][order])


def test_prefix_keys_pad_to_a_power_of_two():
    blocks = torch.tensor([[1, 2, 3, 4, 5, 6]], dtype=torch.uint8)
    key = sm.prefix_keys(torch.nn.functional.pad(blocks, (0, 1530)))
    assert key.shape == (1, 2048)
    assert int(key[0, 0]) == 0x01020304 - 2 ** 31
    assert int(key[0, 4]) == 0x05060000 - 2 ** 31
    assert (key[0, 1536:] == 2 ** 31 - 1).all()


def test_candidates_match_reference(reference):
    rows, _, cand, m = reference
    got_c, got_m = sm.sort_candidates(torch.from_numpy(rows))
    np.testing.assert_array_equal(got_c.numpy(), cand)
    np.testing.assert_array_equal(got_m.numpy(), m)
    assert (cand >= 0).mean() > 0.5 and m.max() == sm.M_EXACT


def test_lengths_stage_matches_reference(reference):
    from libflate_tpu.ops.pipeline import _lengths_stage
    rows, n_valid, cand, m = reference
    w_c, w_l = map(np.asarray, _lengths_stage(
        jnp.asarray(rows), jnp.asarray(n_valid), jnp.asarray(cand),
        lazy=True, use_kernel=True, window=32768, chain=1,
        m4=jnp.asarray(m), m_exact=sm.M_EXACT, lcp_rounds=None))
    t = convert.from_reference_batch(
        {"blocks": rows, "n_valid": n_valid, "cand": cand, "m": m})
    got_c, got_l = port_pipe.lengths_stage(t["blocks"], t["n_valid"],
                                           t["cand"], t["m"])
    np.testing.assert_array_equal(got_c.numpy(), w_c)
    np.testing.assert_array_equal(got_l.numpy(), w_l)
    assert w_l.max() > sm.M_EXACT           # runs pass the 16-byte cap


@pytest.mark.parametrize("n,ctas,smem", [
    (1024, 1, 12288), (2048, 1, 24576), (3072, 1, 36864), (8192, 1, 98304),
    (9216, 2, 98304), (16384, 2, 98304), (65536, 8, 98304)])
def test_sort_geometry_one_cluster_per_member(n, ctas, smem):
    """ceil(n / 8192) CTAs of up to 8192 keys each, keys and uint16
    positions twice in dynamic shared memory; the last CTA may hold
    fewer (9216 = 8192 + 1024)."""
    assert sm.sort_geometry(n) == (ctas, smem)
    assert (ctas - 1) * sm.SORT_TILE < n <= ctas * sm.SORT_TILE


@pytest.mark.parametrize("n", [0, 512, 1000, 66560, 131072])
def test_sort_geometry_rejects_what_the_kernel_cannot_sort(n):
    with pytest.raises(ValueError, match="multiple of 1024"):
        sm.sort_geometry(n)


@pytest.mark.parametrize("n_pad,n,tile,smem", [
    (65536, 65536, 4096, 65552 + 8 * 4104),
    (1024, 1024, 1024, 1040 + 8 * 1032), (4096, 3000, 4096, 3024 + 8 * 4104)])
def test_scan_geometry_stages_the_member_and_a_tile(n_pad, n, tile, smem):
    """The member's bytes with at least 16 zero bytes after them, rounded
    to 16, then the tile's keys and positions and the 8-slot halo; two
    blocks fit in an SM's 228 KB at the main path's shape."""
    assert sm.scan_geometry(n_pad, n) == (tile, smem)
    assert 2 * (sm.scan_geometry(65536, 65536)[1] + 1024) <= 228 * 1024


@pytest.mark.parametrize("n_pad,n", [(131072, 65537), (1024, 2048)])
def test_scan_geometry_rejects_what_the_kernel_cannot_scan(n_pad, n):
    with pytest.raises(ValueError, match="needs n <= n_pad"):
        sm.scan_geometry(n_pad, n)


def test_wrappers_refuse_other_devices():
    key = torch.zeros((2, 1024), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        sm.sort_keys(key)
    with pytest.raises(ValueError, match="unsupported device"):
        sm.scan_emit(key, key, torch.zeros((2, 1024), dtype=torch.uint8,
                                           device="meta"))
