"""The port's one-pass pack (plain version) vs the reference's two
kernels: ``pack_slots`` (each 256-field chunk into an aligned word
column) then ``stitch_cols_pallas`` (columns OR-ed into member rows),
both in Pallas interpret mode at their smallest shape, 1024 slot-chunks
(8 members x 128 chunks), with empty chunks and shared boundary words.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from libflate_tpu_torch.ops import pack  # noqa: E402

B, N_CH, F_CH = 8, 128, 256


def _fields():
    rng = np.random.default_rng(11)
    f = N_CH * F_CH
    values = rng.integers(-2 ** 31, 2 ** 31, (B, f),
                          dtype=np.int64).astype(np.int32)
    # interleaved (f1 <= 17, f2 <= 21) pairs: the shared-table widths
    widths = np.empty((B, f), np.int32)
    widths[:, 0::2] = rng.integers(0, 18, (B, f // 2))
    widths[:, 1::2] = np.where(rng.random((B, f // 2)) < 0.5, 0,
                               rng.integers(0, 22, (B, f // 2)))
    widths[:, 3 * F_CH:5 * F_CH] = 0           # two empty chunks
    widths[1] = 0                               # an empty member
    widths[2, :F_CH * 7 + 3] = 1                # narrow chunks
    return values, widths


@pytest.fixture(scope="module")
def reference():
    values, widths = _fields()
    starts, bits = (t.numpy().astype(np.int64)
                    for t in pack.chunk_starts(torch.from_numpy(widths)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LIBFLATE_PALLAS_INTERPRET", "1")
        from libflate_tpu.ops.pallas_pack import pack_slots
        from libflate_tpu.ops.pallas_stitch import stitch_cols_pallas
        cols = pack_slots(jnp.asarray(values.reshape(-1, F_CH)),
                          jnp.asarray(widths.reshape(-1, F_CH)),
                          jnp.asarray((starts[:, :-1] & 31).reshape(-1)))
        cols = cols.reshape(B, N_CH, -1)
        word0 = starts[:, :-1] >> 5
        nw = int(np.max((starts[:, 1:] + 31) // 32 - word0))
        w_out = -(-(int(bits.max()) // 32 + 2) // 128) * 128
        rows = np.asarray(stitch_cols_pallas(
            cols[:, :, :nw], jnp.asarray(word0.astype(np.int32)), w_out))
    return values, widths, starts, rows


def test_pack_stitch_matches_reference(reference):
    values, widths, starts, rows = reference
    got = pack.pack_stitch(torch.from_numpy(values),
                           torch.from_numpy(widths),
                           torch.from_numpy(starts[:, :-1].astype(np.int32)),
                           rows.shape[1])
    np.testing.assert_array_equal(got.numpy().view(np.uint32), rows)
    assert not rows[1].any() and rows[0].any()


def test_pack_chunks_sizes_rows_to_the_longest_member(reference):
    values, widths, starts, rows = reference
    words, st, bits = pack.pack_chunks(torch.from_numpy(values[:, :-5]),
                                       torch.from_numpy(widths[:, :-5]))
    assert words.shape[1] == (int(bits.max()) + 31) // 32 + 1
    assert st.shape == (B, N_CH + 1)
    np.testing.assert_array_equal(st[:, :-1].numpy(), starts[:, :-1])
    np.testing.assert_array_equal(bits.numpy(),
                                  widths[:, :-5].sum(1))
