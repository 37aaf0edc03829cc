"""The port's ``parallel/mesh.py``, ``parallel/sharding.py`` and
``graft_entry.py`` against the reference's ``parallel/`` on the CPU.

The reference runs on the conftest's eight virtual CPU devices; the port
on ``make_mesh(m, devices=["cpu"] * 8)``, mesh sizes 1, 2 and 8.  The
inputs are the reference tests' (8 x 2048 bytes of 0..15 from
``np.random.default_rng(0)``, and ``default_rng(1)`` for the dry run's
shared-table path).  Every comparison is exact: the outputs are integers
and bytes.

The shared-table sync encode at 8 rows is held against the reference's
XLA route (its CPU run): on its TPU branch (``_use_pallas`` patched on,
Pallas in interpret mode) the reference refuses a batch of 8, because its
histogram kernel takes exactly 128 rows (``pallas_hist.py:83``), and the
test pins that refusal.  On inputs where every member has a match, the
two branches' statistics are the same (they differ only by the dummy
distance count of a member without matches).  At 128 rows the sync encode
is held against the port's unsharded ``encode_batch``.  Every reference
call runs once, in the module fixture.
"""
import functools
import zlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from libflate_tpu_torch import graft_entry  # noqa: E402
from libflate_tpu_torch.ops import pipeline  # noqa: E402
from libflate_tpu_torch.ops.deflate_decode import decode_symbols  # noqa: E402
from libflate_tpu_torch.ops.hist import dist_symbol, length_symbol  # noqa: E402
from libflate_tpu_torch.ops.huffman import tables_from_lengths  # noqa: E402
from libflate_tpu_torch.ops.tables import DIST_EXTRA, LEN_EXTRA  # noqa: E402
from libflate_tpu_torch.parallel import sharding as port  # noqa: E402
from libflate_tpu_torch.parallel.mesh import (BLOCK_AXIS, Mesh,  # noqa: E402
                                              block_sharding, make_mesh,
                                              replicated)
from libflate_tpu_torch.serial.bitio import BitReader  # noqa: E402
from libflate_tpu_torch.serial.deflate import \
    read_dynamic_header_lengths  # noqa: E402

BSZ, N, K = 8, 2048, 32
MESH_SIZES = (1, 2, 8)


def _mesh(m: int) -> Mesh:
    return make_mesh(m, devices=["cpu"] * 8)


def _batch(seed: int):
    rng = np.random.default_rng(seed)
    blocks = rng.integers(0, 16, (BSZ, N), dtype=np.uint8)
    return (blocks, np.full((BSZ,), N, np.int32), np.ones((BSZ,), np.int32))


def _chunk_table(words, bits, cnt, offsets):
    """The dry run's chunk table of a shared-table encode: (rows (C, W)
    uint32, start bits (C,), counts (C,), litlen (1, 286) and distance
    (1, 30) lengths)."""
    lit, dist, _starts, rows, _ = graft_entry._member_words(words, bits)
    max_nc = max(1, int(-(-cnt.max() // K)))
    last = offsets.shape[1] - 1
    j = np.arange(max_nc)
    ch_bits = offsets[:, np.minimum(j, last)].reshape(-1).astype(np.int32)
    ch_cnts = np.clip(cnt[:, None].astype(np.int64) - j[None, :] * K, 0,
                      K).reshape(-1).astype(np.int32)
    return (np.repeat(rows, max_nc, axis=0), ch_bits, ch_cnts, lit[:1],
            dist[:1])


@functools.lru_cache(maxsize=None)
def _skewed_block():
    """A raw DEFLATE stream whose first block is dynamic with a litlen
    code longer than the sync kernel's 12-bit root: (rows (C, W) uint32,
    start bits, counts, (1, 286), (1, 30) lengths), C = 16 chunks of at
    most K tokens from its token boundaries."""
    rng = np.random.default_rng(5)
    plain = bytes(np.minimum(rng.geometric(0.45, 40000), 40).astype(
        np.uint8) + 64)
    co = zlib.compressobj(9, zlib.DEFLATED, -15, 9)
    raw = co.compress(plain) + co.flush()
    r = BitReader(raw)
    r.read_bits(1)
    assert r.read_bits(2) == 2
    lit, dist = read_dynamic_header_lengths(r)
    start = r.bit_position
    words = np.frombuffer(raw + b"\x00" * ((-len(raw)) % 4 + 8),
                          np.uint8).view("<u4")
    w = torch.from_numpy(words.view(np.int32).copy())[None]
    lt, dt = tables_from_lengths(torch.from_numpy(lit[None]),
                                 torch.from_numpy(dist[None]))
    n_tok = 16 * K
    a, b, _nt, _end, _err = decode_symbols(
        w, torch.tensor([start], dtype=torch.int32), lt, dt, n_tok,
        chunk=n_tok)
    a, b = a[0].to(torch.int64), b[0].to(torch.int64)
    is_match = b > 0
    # each token's bits: its litlen code (and extra bits), its distance
    # code and extra bits
    sym = torch.where(is_match, length_symbol(a), a)
    width = torch.from_numpy(lit.astype(np.int64))[sym]
    dsym = dist_symbol(b.clamp(min=1))
    width += torch.where(is_match, torch.from_numpy(LEN_EXTRA.astype(
        np.int64))[(sym - 257).clamp(0, 28)] + torch.from_numpy(
        dist.astype(np.int64))[dsym] + torch.from_numpy(DIST_EXTRA.astype(
            np.int64))[dsym], 0)
    tok_bits = start + torch.cumsum(width, 0) - width
    c = np.arange(16)
    ch_bits = tok_bits[c * K].numpy().astype(np.int32)
    ch_cnts = np.array([K - 3 * (i % 5) for i in c], np.int32)
    rows = np.repeat(words[None], 16, axis=0)
    return rows, ch_bits, ch_cnts, lit[None], dist[None]


@pytest.fixture(scope="module")
def ref():
    """Every reference call of this file."""
    import libflate_tpu.ops.pipeline as rp
    from libflate_tpu.parallel import sharding as R
    from libflate_tpu.parallel.mesh import make_mesh as ref_mesh

    mesh = ref_mesh(8)
    out = {}
    blocks, nv, bf = _batch(0)
    out["blocks"] = R.encode_blocks_sharded(blocks, nv, bf, mesh)
    lit, dist, starts, rows, _ = graft_entry._member_words(*out["blocks"])
    out["members"] = R.decode_members_sharded(rows, starts, lit, dist, N,
                                              mesh)
    blocks1, nv1, bf1 = _batch(1)
    out["sync"] = R.encode_sync_sharded(blocks1, nv1, bf1, K, mesh)
    table = _chunk_table(*out["sync"])
    out["sync decode"] = R.decode_sync_sharded(*table, K, mesh)
    out["long code"] = R.decode_sync_sharded(*_skewed_block(), K, mesh)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LIBFLATE_PALLAS_INTERPRET", "1")
        mp.setattr(rp, "_use_pallas", lambda: True)
        jax.clear_caches()
        with pytest.raises(AssertionError):
            R.encode_sync_sharded(blocks1, nv1, bf1, K, mesh)
    jax.clear_caches()
    return out


def test_mesh_devices_and_shards():
    mesh = _mesh(2)
    assert len(mesh) == 2 and mesh.shape == {BLOCK_AXIS: 2}
    assert [d.type for d in mesh] == ["cpu", "cpu"]
    x = np.arange(12).reshape(6, 2)
    parts = block_sharding(mesh).shard(x)
    assert [p.shape for p in parts] == [(3, 2), (3, 2)]
    assert np.array_equal(torch.cat(parts).numpy(), x)
    assert all(np.array_equal(p.numpy(), x)
               for p in replicated(mesh).shard(x))
    with pytest.raises(ValueError, match="multiple of the mesh size 4"):
        block_sharding(_mesh(4)).split(np.zeros((6, 2)))
    # uint32 words travel as their int32 bit patterns
    w = np.array([[0xFFFFFFFF]], np.uint32)
    assert block_sharding(_mesh(1)).shard(w)[0].dtype == torch.int32


def test_make_mesh_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.encode_blocks_sharded(*_batch(0))


@pytest.mark.parametrize("m", MESH_SIZES)
def test_encode_blocks_sharded_matches_reference(ref, m):
    blocks, nv, bf = _batch(0)
    words, bits = port.encode_blocks_sharded(blocks, nv, bf, _mesh(m))
    r_words, r_bits = ref["blocks"]
    assert words.dtype == np.uint32 and bits.dtype == np.int32
    assert np.array_equal(words, r_words) and np.array_equal(bits, r_bits)
    unsharded = pipeline.encode_batch_generic(
        torch.from_numpy(blocks), torch.from_numpy(nv), bf, "dynamic")
    assert np.array_equal(words, unsharded[0].numpy().view(np.uint32))
    for i, body in enumerate(graft_entry._member_words(words, bits)[4]):
        assert zlib.decompress(body, -15) == blocks[i].tobytes()


def test_encode_blocks_sharded_hash_branch_from_the_whole_batch(
        monkeypatch):
    """On the card a batch of 128 takes the hash candidates on every
    shard, however many shards; each shard on its own would take the
    sort."""
    branches = []
    real = port.encode_batch_generic

    def spy(blocks, n_valid, bfinal, block_type, hash_branch=False):
        branches.append(hash_branch)
        return real(blocks, n_valid, bfinal, block_type, hash_branch)

    monkeypatch.setattr(port, "use_kernel_branches", lambda d: True)
    monkeypatch.setattr(port, "encode_batch_generic", spy)
    rng = np.random.default_rng(2)
    blocks = rng.integers(0, 8, (128, 512), dtype=np.uint8)
    nv = np.full((128,), 512, np.int32)
    bf = np.ones((128,), np.int32)
    words, bits = port.encode_blocks_sharded(blocks, nv, bf, _mesh(4))
    assert branches == [True] * 4
    whole = real(torch.from_numpy(blocks), torch.from_numpy(nv), bf,
                 "dynamic", True)
    assert np.array_equal(words, whole[0].numpy().view(np.uint32))
    assert np.array_equal(bits, whole[1].numpy())
    branches.clear()
    port.encode_blocks_sharded(blocks[:8], nv[:8], bf[:8], _mesh(4))
    assert branches == [False] * 4


@pytest.mark.parametrize("m", MESH_SIZES)
def test_decode_members_sharded_matches_reference(ref, m):
    lit, dist, starts, rows, _ = graft_entry._member_words(*ref["blocks"])
    got = port.decode_members_sharded(rows, starts, lit, dist, N, _mesh(m))
    for g, r in zip(got, ref["members"]):
        assert g.dtype == r.dtype and np.array_equal(g, r)
    assert np.array_equal(got[0], _batch(0)[0]) and not got[2].any()


@pytest.mark.parametrize("m", MESH_SIZES)
def test_encode_sync_sharded_matches_reference(ref, m):
    got = port.encode_sync_sharded(*_batch(1), K, _mesh(m))
    r_words, r_bits, r_cnt, r_off = ref["sync"]
    w = got[0].shape[1]
    assert np.array_equal(got[0], r_words[:, :w])
    assert not r_words[:, w:].any()
    for g, r in zip(got[1:], (r_bits, r_cnt, r_off)):
        assert g.dtype == np.int32 and np.array_equal(g, r)


@pytest.mark.parametrize("m", (1, 4))
def test_encode_sync_sharded_at_128_rows_equals_encode_batch(m):
    rng = np.random.default_rng(3)
    blocks = rng.integers(0, 16, (128, 1024), dtype=np.uint8)
    nv = np.full((128,), 1024, np.int32)
    nv[-3:] = [0, 5, 700]
    for i in range(128):
        blocks[i, nv[i]:] = 0
    want = pipeline.encode_batch(torch.from_numpy(blocks),
                                 torch.from_numpy(nv), K)
    got = port.encode_sync_sharded(blocks, nv, np.ones(128, np.int32), K,
                                   _mesh(m))
    for g, key in zip(got, ("words", "bits", "n_tokens", "offsets")):
        assert np.array_equal(g, want[key].numpy().astype(g.dtype))


def test_encode_sync_sharded_member_without_match():
    """The code is the batch's: a member without a match adds no dummy
    distance of its own (the histogram kernel's rule), whatever shard it
    lands on."""
    blocks, nv, bf = _batch(1)
    blocks[3] = np.arange(N) % 251
    outs = [port.encode_sync_sharded(blocks, nv, bf, K, _mesh(m))
            for m in MESH_SIZES]
    for o in outs[1:]:
        assert all(np.array_equal(x, y) for x, y in zip(o, outs[0]))


@pytest.mark.parametrize("m", MESH_SIZES)
def test_decode_sync_sharded_matches_reference(ref, m):
    table = _chunk_table(*ref["sync"])
    got = port.decode_sync_sharded(*table, K, _mesh(m))
    assert got.dtype == np.int32
    assert np.array_equal(got, ref["sync decode"])


@pytest.mark.parametrize("m", MESH_SIZES)
def test_decode_sync_sharded_code_longer_than_the_roots(ref, m):
    rows, bits, cnts, lit, dist = _skewed_block()
    assert lit.max() > 12
    got = port.decode_sync_sharded(rows, bits, cnts, lit, dist, K, _mesh(m))
    assert np.array_equal(got, ref["long code"])
    assert (got[np.arange(K)[None, :] >= cnts[:, None]] == 0).all()
    assert got[np.arange(K)[None, :] < cnts[:, None]].all()


def test_combine_shard_crcs():
    data = np.random.default_rng(1).integers(0, 256, 8192,
                                             dtype=np.uint8).tobytes()
    shards = [data[i:i + 1024] for i in range(0, len(data), 1024)]
    crcs = [zlib.crc32(s) for s in shards]
    assert port.combine_shard_crcs(crcs, [1024] * 8) == zlib.crc32(data)
    assert port.combine_shard_crcs([], []) == 0


def test_dryrun_multichip_on_a_host_mesh():
    graft_entry.dryrun_multichip(8, devices=["cpu"] * 8)


def test_entry_step_on_the_host():
    fn, args = graft_entry.entry("cpu")
    words, bits = fn(*args)
    assert words.shape[0] == 8
    blocks = args[0].numpy()
    from libflate_tpu_torch.ops.deflate_encode import splice_blocks_host
    body = splice_blocks_host(words.numpy().view(np.uint32), bits.numpy())
    assert zlib.decompress(body, -15) == blocks.tobytes()
