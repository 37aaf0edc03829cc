"""Port vs reference: member CRC-32 f-values, their host finish, and
Adler-32.

On CPU tensors ``crc32_f_rows`` runs its plain version (GF(2) bit-matrix
products in float32) and must give the reference's int32 bit patterns
exactly, and ``crc32_from_padded_f`` the zlib CRC of each row's live
bytes.  The CUDA kernels of ``csrc/checksum.cu`` run only on the card;
here a numpy model of each kernel's decomposition (the CRC's runs, tiles,
tree folds with the shift operators the kernel receives and the tail; the
Adler chunks at aligned addresses, the bytes around them and the sums
mod 65521) is held to the reference and to zlib.
"""
import functools
import zlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from libflate_tpu.ops import checksum as ref  # noqa: E402
from libflate_tpu.utils import checksum as ref_ck  # noqa: E402
from libflate_tpu_torch.ops import checksum as port  # noqa: E402
from libflate_tpu_torch.spec.constants import ADLER32_MOD  # noqa: E402


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


# --- the CRC kernel's decomposition ------------------------------------
def _tables():
    return port.kernel_constants()[:8 * 256].reshape(8, 256)


def _ops():
    return port.kernel_constants()[8 * 256:].reshape(port.LEVELS, 32)


def _apply(cols, v):
    """The operator with columns ``cols`` applied to every register of v:
    the XOR of the columns whose bit is set."""
    bits = (v[..., None] >> np.arange(32, dtype=np.uint32)) & 1
    return np.bitwise_xor.reduce(np.where(bits == 1, cols, np.uint32(0)),
                                 axis=-1).astype(np.uint32)


def _tree(v, unit_log):
    """(..., T) registers of 2^unit_log bytes each, T a power of two ->
    the register of their span: adjacent pairs, left moved over right."""
    ops, level = _ops(), unit_log
    while v.shape[-1] > 1:
        v = _apply(ops[level], v[..., 0::2]) ^ v[..., 1::2]
        level += 1
    return v[..., 0]


def _run_registers(runs):
    """(M, R) uint8 -> (M,) registers from 0, slice-by-8 as the kernel
    steps them (8 bytes: two little-endian words)."""
    t = _tables()
    c = np.zeros(runs.shape[0], np.uint32)
    words = np.ascontiguousarray(runs).view("<u4")
    for k in range(0, words.shape[1], 2):
        x, w1 = words[:, k] ^ c, words[:, k + 1]
        c = (t[7][x & 255] ^ t[6][(x >> 8) & 255] ^ t[5][(x >> 16) & 255]
             ^ t[4][x >> 24] ^ t[3][w1 & 255] ^ t[2][(w1 >> 8) & 255]
             ^ t[1][(w1 >> 16) & 255] ^ t[0][w1 >> 24])
    return c


def _crc_kernel_model(data, run_log, threads, base=0):
    """f-values of (B, N) contiguous rows from address ``base``, as
    ``lf_crc32_rows`` computes them with runs of 2^run_log bytes and
    ``threads`` runs a tile: each row read as whole tiles ending at its
    last aligned address (bytes before the row zero), run registers,
    the tile tree, the tiles folded q a thread then the tree, the tail."""
    bsz, n = data.shape
    t0 = _tables()[0]
    tile_log = run_log + threads.bit_length() - 1
    tile = 1 << tile_log
    tiles = max(1, -(-((n + 15) & ~15) // tile))
    flat = data.reshape(-1)
    out = []
    for b in range(bsz):
        a = base + b * n
        e_al = (a + n) & ~15
        start = e_al - tiles * tile
        assert start <= a
        span = np.zeros(tiles * tile, np.uint8)
        if e_al > a:
            span[a - start:] = flat[a - base:e_al - base]
        regs = _run_registers(span.reshape(tiles * threads, -1))
        tile_regs = _tree(regs.reshape(tiles, threads), run_log)
        if tiles == 1:
            v = tile_regs[0]
        else:
            q_log = 0
            while threads << q_log < tiles:
                q_log += 1
            padded = np.concatenate([
                np.zeros((threads << q_log) - tiles, np.uint32),
                tile_regs]).reshape(threads, 1 << q_log)
            acc = np.zeros(threads, np.uint32)
            for j in range(1 << q_log):
                acc = _apply(_ops()[tile_log], acc) ^ padded[:, j]
            v = _tree(acc, tile_log + q_log)
        v = np.uint32(v)
        for x in range(max(a, e_al), a + n):
            v = t0[(v ^ flat[x - base]) & 255] ^ (v >> np.uint32(8))
        out.append(v)
    return np.array(out, np.uint32).view(np.int32)


@functools.lru_cache(maxsize=None)
def _ref_rows(n, bsz):
    data = np.random.default_rng(100 + n + bsz).integers(
        0, 256, (bsz, n), dtype=np.uint8)
    return data, np.asarray(ref.crc32_f_rows(jnp.asarray(data)))


@pytest.mark.parametrize("geometry", [(8, 256), (6, 32)],
                         ids=["runs256x256", "runs64x32"])
@pytest.mark.parametrize("bsz", [1, 3])
@pytest.mark.parametrize("n", [1, 3, 63, 64, 65, 1000, 4096, 65536])
def test_crc_kernel_decomposition_matches_reference(n, bsz, geometry):
    """The kernel's geometry (runs of 256 bytes, 256 a tile) and a small
    one (runs of 64, 32 a tile: rows of 4096 and 65536 take 2-33 tiles,
    folded q = 1-2 a thread), rows from an aligned address and from one
    5 bytes on."""
    data, want = _ref_rows(n, bsz)
    for base in (0, 5):
        np.testing.assert_array_equal(
            _crc_kernel_model(data, *geometry, base=base), want)
    np.testing.assert_array_equal(port.crc32_f_rows_plain(
        torch.from_numpy(data)).numpy(), want)


def test_kernel_constants_are_the_tables_and_shift_operators():
    np.testing.assert_array_equal(_tables(), ref_ck.CRC_TABLE8)
    for level in (0, 1, 6, 8, 16, 20):
        np.testing.assert_array_equal(
            _ops()[level], ref_ck._shift_operator(1 << level))
    assert port.crc_tiles(0) == port.crc_tiles(65536) == 1
    assert port.crc_tiles(65537) == 2
    assert port.crc_tiles((64 << 20) + 3) == 1025


# --- the Adler kernel's decomposition ----------------------------------
def _adler_kernel_model(data, base=0, blocks=4, threads=256):
    """Adler-32 of n bytes at address ``base`` as ``lf_adler32`` sums
    them: 16-byte chunks at aligned addresses spread over the threads of
    ``blocks`` blocks, the bytes before and after them one a thread of
    block 0, each thread's sums in 64 bits reduced mod 65521, the blocks'
    sums mod 65521, then A = 1 + sum and B = n + sum."""
    m, n = ADLER32_MOD, len(data)
    if n == 0:
        return 1
    head = min(n, (16 - base % 16) % 16)
    n_body = (n - head) // 16
    tail0 = head + 16 * n_body
    g = blocks * threads
    sa, sb = np.zeros(g, np.uint64), np.zeros(g, np.uint64)
    body = data[head:tail0].reshape(n_body, 16).astype(np.uint64)
    ca = body.sum(axis=1)
    cb = (body * np.arange(16, 0, -1, dtype=np.uint64)).sum(axis=1)
    j = np.arange(n_body, dtype=np.int64)
    coef = ((n - head - 16 * j - 16) % m).astype(np.uint64)
    np.add.at(sa, j % g, ca)
    np.add.at(sb, j % g, cb + coef * ca)
    for k in [*range(head), *range(tail0, n)]:
        t = k if k < head else head + k - tail0
        sa[t] += np.uint64(data[k])
        sb[t] += np.uint64(data[k]) * np.uint64((n - k) % m)
    part_a = (sa % m).reshape(blocks, threads).sum(axis=1) % m
    part_b = (sb % m).reshape(blocks, threads).sum(axis=1) % m
    a = (1 + int(part_a.sum())) % m
    b = (n % m + int(part_b.sum())) % m
    return (b << 16) | a


@pytest.mark.parametrize("n", [0, 1, 1023, 1024, 1025, 5552,
                               (3 << 20) + 5])
def test_adler_kernel_decomposition_matches_reference_and_zlib(n):
    """At 3 MiB the weighted sum passes 2^32 many times over: only the
    reductions mod 65521 keep it."""
    data = np.random.default_rng(200 + n).integers(0, 256, n, np.uint8)
    want = zlib.adler32(data.tobytes())
    assert int(ref.adler32_jax(jnp.asarray(data))) == want
    for base in (0, 7):
        for blocks in (1, 3):
            assert _adler_kernel_model(data, base, blocks) == want
    assert port.adler32_device_plain(torch.from_numpy(data)) == want


def test_cpu_tensors_run_the_plain_versions():
    data, want = _ref_rows(1000, 3)
    port.crc32_f_rows.launches = port.adler32_device.launches = 0
    rows = torch.from_numpy(data)
    np.testing.assert_array_equal(port.crc32_f_rows(rows).numpy(), want)
    assert port.crc32_device(rows[0]) == zlib.crc32(data[0].tobytes())
    port.crc32_batch(rows, [1000, 999, 0])
    assert port.adler32_device(rows[1]) == zlib.adler32(data[1].tobytes())
    assert port.crc32_f_rows.launches == port.adler32_device.launches == 0
    meta = torch.empty((2, 8), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        port.crc32_f_rows(meta)
    with pytest.raises(ValueError, match="unsupported device"):
        port.adler32_device(meta[0])
