"""The port's one-pass pack (plain version) vs the reference's two
kernels: ``pack_slots`` (each 256-field chunk into an aligned word
column) then ``stitch_cols_pallas`` (columns OR-ed into member rows),
both in Pallas interpret mode at their smallest shape, 1024 slot-chunks
(8 members x 128 chunks), with empty chunks and shared boundary words;
then the pack kernel's hard cases (4 members x 256 chunks).
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


def _hard_fields():
    """Width 32 and negative widths, word-aligned chunk starts, runs of
    zero width and all-zero chunks, chunks inside one word, and a member
    of nothing.  The reference takes widths in [0, 32] and at most 155
    words a chunk, so it gets the widths clamped, as the port reads
    them."""
    rng = np.random.default_rng(12)
    b, n_ch = 4, 256
    f = n_ch * F_CH
    values = rng.integers(-2 ** 31, 2 ** 31, (b, f),
                          dtype=np.int64).astype(np.int32)
    widths = rng.integers(-4, 18, (b, f)).astype(np.int32)
    widths[0, ::17] = 32
    fours = np.repeat(rng.random((f // 4,)) < 0.3, 4)
    widths[1] = np.where(fours, 32, 8)           # every chunk start % 32 == 0
    widths[2] = 0
    widths[2, ::F_CH] = 5                         # a chunk in one word
    widths[2, 3::F_CH] = 9
    widths[2, 40 * F_CH:41 * F_CH] = rng.integers(0, 18, F_CH)
    widths[3] = 0                                 # a member of nothing
    return values, widths


@pytest.fixture(scope="module")
def hard_reference():
    values, widths = _hard_fields()
    b, f = values.shape
    clamped = np.clip(widths, 0, 32)
    starts, bits = (t.numpy().astype(np.int64)
                    for t in pack.chunk_starts(torch.from_numpy(clamped)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LIBFLATE_PALLAS_INTERPRET", "1")
        from libflate_tpu.ops.pallas_pack import pack_slots
        from libflate_tpu.ops.pallas_stitch import stitch_cols_pallas
        cols = pack_slots(jnp.asarray(values.reshape(-1, F_CH)),
                          jnp.asarray(clamped.reshape(-1, F_CH)),
                          jnp.asarray((starts[:, :-1] & 31).reshape(-1)))
        cols = cols.reshape(b, f // F_CH, -1)
        word0 = starts[:, :-1] >> 5
        nw = int(np.max((starts[:, 1:] + 31) // 32 - word0))
        w_out = -(-(int(bits.max()) // 32 + 2) // 128) * 128
        rows = np.asarray(stitch_cols_pallas(
            cols[:, :, :nw], jnp.asarray(word0.astype(np.int32)), w_out))
    return values, widths, starts, rows


@pytest.mark.parametrize("cut", [None, 1000, 129])
def test_pack_stitch_matches_reference_on_hard_cases(hard_reference, cut):
    """The plain pack equals the reference's pack + stitch; with w_out
    cut short, the rows are the reference's first w_out words."""
    values, widths, starts, rows = hard_reference
    w_out = rows.shape[1] if cut is None else cut
    got = pack.pack_stitch(torch.from_numpy(values),
                           torch.from_numpy(widths),
                           torch.from_numpy(starts[:, :-1].astype(np.int32)),
                           w_out)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  rows[:, :w_out])
    assert not (starts[1] % 32).any() and not rows[3].any()


def _pack_oracle(values, widths, starts, w_out):
    """Rows built with one Python integer per member: every field OR-ed
    in at its bit, then cut into w_out words."""
    bsz, f = values.shape
    rows = np.zeros((bsz, w_out), np.uint32)
    for r in range(bsz):
        acc = 0
        for c in range(f // F_CH):
            pos = int(starts[r, c])
            for j in range(c * F_CH, (c + 1) * F_CH):
                w = min(max(int(widths[r, j]), 0), 32)
                acc |= (int(values[r, j]) & ((1 << w) - 1)) << pos
                pos += w
        for k in range(w_out):
            rows[r, k] = (acc >> (32 * k)) & 0xFFFFFFFF
    return rows


def _oracle_case(case):
    rng = np.random.default_rng(len(case))
    bsz = 1 if case == "one_member" else 3
    f = 4 * F_CH
    values = rng.integers(-2 ** 31, 2 ** 31, (bsz, f),
                          dtype=np.int64).astype(np.int32)
    widths = rng.integers(0, 18, (bsz, f)).astype(np.int32)
    if case == "zero_runs":
        widths[:, 10:200] = 0
        widths[:, F_CH:2 * F_CH] = 0              # an all-zero chunk
        widths[2] = 0                             # a member of nothing
    elif case == "width_32":
        widths[:, ::3] = 32
    elif case == "negative_widths":
        widths = rng.integers(-40, 33, (bsz, f)).astype(np.int32)
    elif case == "word_aligned":
        widths[:] = np.where(rng.random((bsz, f)) < 0.5, 32, 0)
    elif case == "one_word_chunks":
        widths[:] = 0
        widths[:, ::F_CH] = 7
        widths[:, 9::F_CH] = 3
    clamped = np.clip(widths, 0, 32)
    starts, bits = (t.numpy().astype(np.int64)
                    for t in pack.chunk_starts(torch.from_numpy(clamped)))
    starts = starts[:, :-1]
    if case == "gaps":                            # unused bits between chunks
        starts = starts + 37 * np.arange(starts.shape[1])[None, :]
    w_out = int(starts[:, -1].max() + clamped[:, -F_CH:].sum(1).max()) // 32 + 2
    if case == "cut_short":
        w_out = int(bits.min()) // 64
    return values, widths, starts.astype(np.int32), w_out


@pytest.mark.parametrize("case", [
    "zero_runs", "width_32", "negative_widths", "word_aligned",
    "one_word_chunks", "gaps", "cut_short", "one_member"])
def test_pack_stitch_plain_matches_a_bit_by_bit_oracle(case):
    """The plain pack against rows built bit by bit in Python integers,
    on the kernel's hard cases and on chunk starts with gaps between
    chunks, which the wrapper admits and the encode never makes."""
    values, widths, starts, w_out = _oracle_case(case)
    got = pack.pack_stitch(*(torch.from_numpy(x)
                             for x in (values, widths, starts)), w_out)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  _pack_oracle(values, widths, starts, w_out))
