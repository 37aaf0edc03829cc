"""Port vs reference: flat Huffman decode tables.

The reference (``libflate_tpu.ops.huffman``) runs under jit on the CPU;
the port (``libflate_tpu_torch.ops.huffman``) is numpy host glue.  Tables
are integer data, so they must be identical.
"""
import pathlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from libflate_tpu.ops import huffman as ref  # noqa: E402
from libflate_tpu_torch.ops import huffman as port  # noqa: E402

SMALL = (pathlib.Path(__file__).parent / "data"
         / "pgzf_sync_zipf_small.pgz")


def _valid_lengths(seed: int, n: int, limit: int) -> np.ndarray:
    """Seeded length-limited optimal code lengths (always Kraft-valid)."""
    rng = np.random.default_rng(seed)
    freqs = rng.integers(0, 60, n) * (rng.random(n) < 0.7)
    freqs[:2] += 1                                   # >= 2 active symbols
    return np.asarray(ref.package_merge_lengths(
        jnp.asarray(freqs, jnp.int32), limit))


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("n,limit,table_bits", [
    (286, 10, 10), (286, 12, 12), (30, 8, 8), (286, 15, 10)])
def test_decode_table_random_valid_lengths(seed, n, limit, table_bits):
    lengths = _valid_lengths(seed, n, limit)
    want = np.asarray(ref.decode_table(jnp.asarray(lengths), table_bits))
    got = port.decode_table(lengths, table_bits)
    assert got.dtype == port.torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("lengths", [
    np.ones(30, np.int64),                        # over-subscribed
    np.zeros(30, np.int64),                       # empty code
    np.r_[np.zeros(29, np.int64), 1],             # one symbol
], ids=["oversubscribed", "empty", "single"])
def test_decode_table_invalid_length_sets(lengths):
    want = np.asarray(ref.decode_table(jnp.asarray(lengths), 8))
    np.testing.assert_array_equal(port.decode_table(lengths, 8).numpy(),
                                  want)


def test_fixture_tables_match_reference_staging():
    """The port's staging builds the reference's tables for the fixture."""
    from libflate_tpu.formats import pgzf as ref_pgzf
    from libflate_tpu_torch.formats import pgzf as port_pgzf

    data = SMALL.read_bytes()
    want = ref_pgzf._prepare_sync_device(data)
    got = port_pgzf._prepare_sync_device(data, "cpu")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["root_bits"] == w["root_bits"]
        np.testing.assert_array_equal(g["lit_t"].numpy(),
                                      np.asarray(w["lit_t"]))
        np.testing.assert_array_equal(g["dist_t"].numpy(),
                                      np.asarray(w["dist_t"]))
