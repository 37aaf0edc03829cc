"""The port's LCP kernel (plain version) vs the reference's
``match_lengths_pallas`` in Pallas interpret mode, bit for bit.

Four 16 KiB members (16 row groups, so the reference's swept band is
narrower than the member): text, a chunk repeated 3,000 bytes later, a
chunk repeated 9,000 bytes later, and a short member.  The candidates
are the sort matcher's at window 32768 with every fifth one moved to a
random earlier position, so many lie outside the 4096-byte band that the
kernel sweeps; with the sort matcher's exact prefix ``m4`` those keep
their 16 bytes, without it they read zero words.  A third case is the
quality mode's chain-level call (no ``m4``, 8 rounds, window 32768),
whose band is the whole member here (16 groups).  The reference runs
once per case, module-scoped.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from libflate_tpu_torch.ops import lcp  # noqa: E402
from libflate_tpu_torch.ops import sort_match as sm  # noqa: E402

N = 16384
WINDOW = 4096


def _inputs():
    rng = np.random.default_rng(13)
    words = [bytes(rng.integers(97, 110, rng.integers(2, 9),
                                dtype=np.uint8)) for _ in range(60)]
    text = b" ".join(words[int(i)] for i in rng.zipf(1.2, 9000) % 60)
    rows = np.zeros((4, N), np.uint8)
    rows[0] = np.frombuffer(text[:N], np.uint8)
    for r, dist in ((1, 3000), (2, 9000)):
        noise = rng.integers(0, 256, N, dtype=np.uint8)
        noise[dist:] = noise[:N - dist]
        noise[dist + 500::1500] ^= 0x5A             # break the long runs
        rows[r] = noise
    rows[3, :10000] = np.frombuffer(text[N:N + 10000], np.uint8)
    n_valid = np.array([N, N, N, 10000], np.int32)
    cand, m4 = sm.sort_candidates(torch.from_numpy(rows), window=32768)
    cand, m4 = cand.numpy().copy(), m4.numpy()
    pos = np.arange(N)[None, :].repeat(4, 0)
    moved = (rng.random((4, N)) < 0.2) & (pos > 0)
    cand[moved] = (rng.random(moved.sum()) * pos[moved]).astype(np.int32)
    return rows, n_valid, cand, m4


@pytest.fixture(scope="module")
def reference():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LIBFLATE_PALLAS_INTERPRET", "1")
        from libflate_tpu.ops.pallas_lcp import match_lengths_pallas
        rows, n_valid, cand, m4 = _inputs()
        args = (jnp.asarray(rows), jnp.asarray(cand), jnp.asarray(n_valid))
        plain = np.asarray(match_lengths_pallas(
            *args, max_rounds=6, window=WINDOW))
        with_m4 = np.asarray(match_lengths_pallas(
            *args, max_rounds=8, window=WINDOW, m4=jnp.asarray(m4),
            m_exact=sm.M_EXACT))
        chain = np.asarray(match_lengths_pallas(*args, max_rounds=8,
                                                window=32768))
    return rows, n_valid, cand, m4, {"none": plain, "m4": with_m4,
                                     "chain": chain}


@pytest.mark.parametrize("case", ["none", "m4", "chain"])
def test_match_lengths_plain_matches_reference(reference, case):
    rows, n_valid, cand, m4, want = reference
    t = [torch.from_numpy(a) for a in (rows, cand, n_valid, m4)]
    kw = {"none": {"max_rounds": 6, "window": WINDOW},
          "m4": {"max_rounds": 8, "window": WINDOW, "m4": t[3],
                 "m_exact": sm.M_EXACT},
          "chain": {"max_rounds": 8, "window": 32768}}[case]
    got = lcp.match_lengths(t[0], t[1], t[2], **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want[case])


def test_band_rule_is_exercised(reference):
    """Candidates outside the swept band exist, and with m4 they keep
    their exact 16 bytes where a true LCP would be longer."""
    rows, n_valid, cand, m4, want = reference
    e = np.arange(N)[None, :]
    t = e // 1024
    cs = np.clip(t - (WINDOW // 1024), 0, N // 1024 - WINDOW // 1024 - 2)
    outside = (cand >= 0) & (cand < cs * 1024)
    assert outside.sum() > 1000
    kept = outside & (m4 == 16) & (n_valid[:, None] - e >= 16)
    assert kept.sum() > 100 and (want["m4"][kept] == 16).all()
    assert want["m4"].max() > 16 and want["none"].max() == 24


def test_lengths_never_pass_the_limits(reference):
    rows, n_valid, cand, _m4, want = reference
    e = np.arange(N)[None, :]
    lim = np.clip(np.minimum(258, n_valid[:, None] - e), 0, None)
    for got in want.values():
        assert (got <= lim).all() and (got[cand < 0] == 0).all()


@pytest.mark.parametrize("kw", [{"window": 1000}, {"m_exact": 6},
                                {"m_exact": 28}])
def test_bad_window_or_m_exact_raises(kw):
    blocks = torch.zeros((1, 1024), dtype=torch.uint8)
    cand = torch.zeros((1, 1024), dtype=torch.int32)
    with pytest.raises(ValueError, match="match_lengths"):
        lcp.match_lengths(blocks, cand, torch.tensor([1024]),
                          m4=cand, **kw)
