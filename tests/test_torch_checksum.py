"""Port vs reference: member CRC-32 f-values and their host finish.

``crc32_f_rows`` (GF(2) bit-matrix products in float32) must give the
reference's int32 bit patterns exactly, and ``crc32_from_padded_f`` the
zlib CRC of each row's live bytes.
"""
import zlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from libflate_tpu.ops import checksum as ref  # noqa: E402
from libflate_tpu_torch.ops import checksum as port  # noqa: E402


def _rows(seed, bsz, n):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, (bsz, n), dtype=np.uint8)
    lens = rng.integers(0, n + 1, bsz)
    lens[0] = n
    data[np.arange(n)[None, :] >= lens[:, None]] = 0     # zero padding
    return data, lens


@pytest.mark.parametrize("n", [1024, 1000, 4096, 64, 3])
def test_crc32_f_rows_matches_reference(n):
    data, _ = _rows(n, 3, n)
    want = np.asarray(ref.crc32_f_rows(jnp.asarray(data)))
    got = port.crc32_f_rows(torch.from_numpy(data))
    assert got.dtype == torch.int32 and got.shape == (3,)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [1024, 4096])
def test_crc32_from_padded_f_matches_reference_and_zlib(n):
    data, lens = _rows(7 + n, 5, n)
    f = port.crc32_f_rows(torch.from_numpy(data)).numpy()
    got = port.crc32_from_padded_f(f, lens, n)
    np.testing.assert_array_equal(got, ref.crc32_from_padded_f(f, lens, n))
    for row, ln, crc in zip(data, lens, got):
        assert int(crc) == zlib.crc32(row[:ln].tobytes())


def test_crc32_f_rows_in_member_slices(monkeypatch):
    """Slicing the members to bound memory changes nothing."""
    data, _ = _rows(11, 6, 2048)
    whole = port.crc32_f_rows(torch.from_numpy(data))
    monkeypatch.setattr(port, "_SLICE_BYTES", 1)
    np.testing.assert_array_equal(
        port.crc32_f_rows(torch.from_numpy(data)).numpy(), whole.numpy())


def test_init_term_and_inverse_shift_match_reference():
    for n in (0, 1, 63, 64, 4096, 65535):
        assert port._init_term(n) == ref._init_term(n)
    for pad in (1, 37, 1024):
        np.testing.assert_array_equal(port._inv_shift_cols(pad),
                                      ref._inv_shift_cols(pad))
