"""The port's greedy parse vs the reference's ``parse_tokens_pallas``.

The reference runs its exits and walk-emit kernels in Pallas interpret
mode once per module, at its smallest batch: 128 members of 1 KiB (two
512-position chunks each).  Both sides get identical inputs: the match
lengths of seeded text, runs, short members and random bytes (which
overflow the 384-slot budget).  The port's plain versions of its two
kernels must give the same token slots, counts and overflow flags.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from libflate_tpu_torch.ops import parse  # noqa: E402
from libflate_tpu_torch.ops import pipeline as port_pipe  # noqa: E402

B, N, CAP = 128, 1024, 384


def _batch():
    rng = np.random.default_rng(7)
    words = [bytes(rng.integers(97, 123, rng.integers(2, 9),
                                dtype=np.uint8)) for _ in range(200)]
    rows = np.zeros((B, N), np.uint8)
    n_valid = np.full(B, N, np.int32)
    for i in range(B):
        kind = i % 4
        if kind == 0:
            text = b" ".join(words[int(j)] for j in
                             rng.zipf(1.2, 600) % 200)
            rows[i] = np.frombuffer(text[:N], np.uint8)
        elif kind == 1:
            rows[i] = np.repeat(rng.integers(0, 3, N // 8, dtype=np.uint8), 8)
        elif kind == 2:
            n_valid[i] = int(rng.integers(0, N))
            rows[i, :n_valid[i]] = rng.integers(97, 100, n_valid[i])
        else:
            rows[i] = rng.integers(0, 256, N, dtype=np.uint8)
    blocks, nv = torch.from_numpy(rows), torch.from_numpy(n_valid)
    cand, lengths = port_pipe.lengths_stage(
        blocks, nv, *port_pipe.sort_candidates(blocks))
    return blocks, nv, cand, lengths


@pytest.fixture(scope="module")
def case():
    blocks, nv, cand, lengths = _batch()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LIBFLATE_PALLAS_INTERPRET", "1")
        from libflate_tpu.ops.pallas_parse import parse_tokens_pallas
        ref = tuple(map(np.asarray, parse_tokens_pallas(
            *(jnp.asarray(t.numpy()) for t in (blocks, nv, cand, lengths)),
            CAP)))
    return (blocks, nv, cand, lengths), ref


def test_parse_tokens_match_reference(case):
    args, (w_a, w_b, w_valid, w_cnt, w_ovf) = case
    a, b, valid, cnt, ovf = parse.parse_tokens(*args, CAP)
    np.testing.assert_array_equal(a.numpy(), w_a)
    np.testing.assert_array_equal(b.numpy(), w_b)
    np.testing.assert_array_equal(valid.numpy(), w_valid)
    np.testing.assert_array_equal(cnt.numpy(), w_cnt)
    np.testing.assert_array_equal(ovf.numpy(), w_ovf)
    assert w_ovf.any() and not w_ovf.all()
    assert a.shape == (B, N * CAP // 512)


def test_parse_at_cap_512_never_overflows(case):
    args, _ = case
    a, b, valid, cnt, ovf = parse.parse_tokens(*args, 512)
    assert not ovf.any()
    _blocks, nv, _cand, lengths = args
    # every valid byte is covered by exactly one token
    covered = torch.where(valid & (b > 0), a, valid.to(torch.int32)).sum(1)
    np.testing.assert_array_equal(covered.numpy(), nv.numpy())


def test_chunk_exits_land_past_the_chunk(case):
    blocks, nv, cand, lengths = case[0]
    jump, _tok = parse.parse_inputs(blocks, nv, cand, lengths)
    ex = parse.chunk_exits(jump).to(torch.int64)
    p = torch.arange(N)[None, :]
    end = (p // 512 + 1) * 512
    assert bool(((ex >= end) & (ex <= end + 257)).all())
