"""The port's encode host glue vs the reference: package-merge code
lengths, canonical and bit-reversed codes, the dynamic header fields and
the padded-layout sync offsets, on seeded histograms and tokens,
including the edge cases (one active symbol, no distance, all 286
litlen symbols active, the code-length-code limit of 7).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from libflate_tpu_torch.ops import deflate_encode as de  # noqa: E402
from libflate_tpu_torch.ops import huffman, pipeline  # noqa: E402


def _hists():
    rng = np.random.default_rng(5)
    zipf = np.bincount(rng.zipf(1.4, 20000) % 286, minlength=286)
    flat = np.ones(286, np.int64)
    flat[rng.integers(0, 286, 40)] += rng.integers(1, 5, 40)
    one = np.zeros(286, np.int64)
    one[256] = 128
    ties = np.zeros(286, np.int64)
    ties[rng.choice(286, 60, replace=False)] = 7
    return {"zipf": zipf, "all286": flat, "one": one, "ties": ties,
            "steep": 2 ** np.minimum(np.arange(286), 29)}


HISTS = _hists()


@pytest.mark.parametrize("name", sorted(HISTS))
@pytest.mark.parametrize("limit", [7, 10, 15])
def test_package_merge_matches_reference(name, limit):
    from libflate_tpu.ops.huffman import package_merge_lengths
    freqs = HISTS[name]
    if limit == 7:                      # the code-length-code alphabet
        freqs = freqs[:19]
    want = np.asarray(package_merge_lengths(jnp.asarray(freqs, jnp.int32),
                                            limit))
    got = huffman.package_merge_lengths(freqs, limit)
    np.testing.assert_array_equal(got, want)
    assert got.max() <= limit


@pytest.mark.parametrize("name", sorted(HISTS))
def test_codes_match_reference(name):
    from libflate_tpu.ops.huffman import (canonical_codes_jax,
                                          package_merge_lengths,
                                          reverse_codes_jax)
    lengths = np.asarray(package_merge_lengths(
        jnp.asarray(HISTS[name], jnp.int32), 10))
    codes = np.asarray(canonical_codes_jax(jnp.asarray(lengths)))
    np.testing.assert_array_equal(huffman.canonical_codes(lengths), codes)
    np.testing.assert_array_equal(
        huffman.reverse_codes(codes, lengths),
        np.asarray(reverse_codes_jax(jnp.asarray(codes),
                                     jnp.asarray(lengths))))


@pytest.mark.parametrize("name", ["zipf", "all286", "one", "ties"])
@pytest.mark.parametrize("dist", ["none", "some"])
def test_dynamic_header_fields_match_reference(name, dist):
    from libflate_tpu.ops.deflate_encode import dynamic_header_fields
    lit = huffman.package_merge_lengths(HISTS[name], 10)
    dfreq = np.zeros(30, np.int64)
    dfreq[0] = 1
    if dist == "some":
        dfreq[[0, 3, 4, 17, 29]] = [5, 9, 1, 1, 30]
    dl = huffman.package_merge_lengths(dfreq, 8)
    want = dynamic_header_fields(jnp.asarray(lit), jnp.asarray(dl),
                                 jnp.int32(1))
    got = de.dynamic_header_fields(lit, dl, 1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_rle_code_lengths_match_reference():
    from libflate_tpu.ops.deflate_encode import rle_code_lengths_jax
    rng = np.random.default_rng(9)
    seq = np.repeat(rng.integers(0, 4, 60), rng.integers(1, 160, 60))[:316]
    seq = np.pad(seq, (0, 316 - len(seq)))
    for g, w in zip(de.rle_code_lengths(seq),
                    rle_code_lengths_jax(jnp.asarray(seq, jnp.int32))):
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("cap", [384, 512])
def test_sync_offsets_padded_match_reference(cap):
    from libflate_tpu.ops.pipeline import _sync_offsets_padded
    rng = np.random.default_rng(cap)
    bsz, nc = 6, 4
    m = nc * cap
    counts = rng.integers(0, cap + 1, (bsz, nc))
    counts[0] = 0                              # a member with no token
    counts[1] = cap                            # full chunks
    valid = np.arange(cap)[None, None, :] < counts[:, :, None]
    valid = valid.reshape(bsz, m)
    f0 = de.N_HEADER_FIELDS + de.N_LENGTH_FIELDS
    widths = rng.integers(0, 22, (bsz, f0 + 2 * m + 1)).astype(np.int32)
    tok = widths[:, f0:f0 + 2 * m].reshape(bsz, m, 2)
    tok[~valid] = 0
    want = np.asarray(_sync_offsets_padded(jnp.asarray(widths),
                                           jnp.asarray(valid), 256, cap))
    got = pipeline.sync_offsets_padded(torch.from_numpy(widths),
                                       torch.from_numpy(valid), 256, cap)
    np.testing.assert_array_equal(got.numpy(), want)
