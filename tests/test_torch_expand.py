"""Port vs reference: rank + mod-collapse, pointer chase, expand_members.

The reference (``device_expand.expand_members``, which runs the
``pallas_rank`` and ``pallas_expand`` kernels, and ``rank_emit_src``
alone) runs once per module in Pallas interpret mode, on one batch of
seven members at out_cap 2048; the port's plain versions must give
identical arrays.  Tokens come from the JAX-free serial greedy tokenizer
on seeded corpora.
"""
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
