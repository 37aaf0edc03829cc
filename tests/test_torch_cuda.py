"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda`` and skipped where torch sees no CUDA device.  On a GPU
host (the repository's conftest imports JAX, which that host lacks)::

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_cuda.py -q

Every comparison is exact equality: the codec is integer.
"""
import gzip
import pathlib
import struct
import zlib

import numpy as np
import pytest
import torch

import chip_smoke
from chip_smoke import (decode_hard_cases, generic_shard, member_codes,
                        poison_ls, strip_sync_index)
from libflate_tpu_torch.formats import pgzf
from libflate_tpu_torch.ops import (checksum, decode, deflate_decode,
                                    deflate_encode, device_expand, expand,
                                    fields, gather, hist, lcp, pack, parse,
                                    pipeline, rank)
from libflate_tpu_torch.ops import hash_match as hm
from libflate_tpu_torch.ops import sort_match as sm
from libflate_tpu_torch.ops import sync_decode as sd

pytestmark = pytest.mark.cuda

DATA = pathlib.Path(__file__).parent / "data"


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def group(dev):
    (g,) = pgzf._prepare_sync_device(
        (DATA / "pgzf_sync_zipf_small.pgz").read_bytes(), dev)
    return g


def _sd_args(g, lit=None, root_bits=None):
    return (g["words"], g["start_bits"], g["counts"],
            g["lit_t"] if lit is None else lit, g["dist_t"], g["k_tok"],
            root_bits or g["root_bits"])


def test_sync_decode_kernel_matches_plain(group):
    args = _sd_args(group)
    got = sd.sync_decode(*args)
    assert got.is_cuda
    torch.testing.assert_close(got, sd.sync_decode_plain(*args),
                               rtol=0, atol=0)


def test_sync_decode_kernel_invalid_entries_and_wide_root(group):
    bad = group["lit_t"].clone()
    bad[(bad >> 4) == ord("\n")] = 0
    args = _sd_args(group, lit=bad)
    torch.testing.assert_close(sd.sync_decode(*args),
                               sd.sync_decode_plain(*args), rtol=0, atol=0)
    wide = _sd_args(group, lit=group["lit_t"].repeat(4), root_bits=12)
    torch.testing.assert_close(sd.sync_decode(*wide),
                               sd.sync_decode(*_sd_args(group)),
                               rtol=0, atol=0)


def test_sync_decode_kernel_reads_zero_past_the_stream(dev):
    """Slots that start near the end read zero words, as the plain
    version does, and never fault."""
    words = torch.randint(-2**31, 2**31 - 1, (5,), dtype=torch.int32,
                          device=dev)
    start = torch.tensor([0, 100, 150, 159], dtype=torch.int64, device=dev)
    cnt = torch.full((4,), 256, dtype=torch.int32, device=dev)
    lit = torch.randint(0, 4096, (1 << 10,), dtype=torch.int32, device=dev)
    dist = torch.randint(0, 512, (256,), dtype=torch.int32, device=dev)
    args = (words, start, cnt, lit, dist, 256, 10)
    torch.testing.assert_close(sd.sync_decode(*args),
                               sd.sync_decode_plain(*args), rtol=0, atol=0)


def _sync_random_case(dev, k: int, root_bits: int, seed: int = 0):
    """Random stream words and seeded tables (invalid entries, symbols
    286 / 287 and above, negative words), 1003 slots (not a multiple of
    the block) starting at every residue mod 32, some within 6 bytes of
    the stream's end or past it, with counts of 0, of K and above K."""
    rng = np.random.default_rng(seed + 1000 * k + root_bits)
    n_words, s = 4000, 1003
    words = rng.integers(-2**31, 2**31, n_words).astype(np.int32)
    start = rng.integers(0, n_words * 32, s) // 32 * 32 + np.arange(s) % 32
    end = n_words * 32
    start[-40:] = end - rng.integers(0, 48, 40)          # last 6 bytes
    start[-3:] = [end, end + 5, end + 100]               # past the end
    counts = rng.integers(0, k + 1, s)
    counts[::7] = 0
    counts[1::7] = k + rng.integers(1, 9, len(counts[1::7]))
    counts[2::7] = k
    n = 1 << root_bits
    sym = rng.integers(0, 288, n)
    sym[rng.random(n) < 0.1] = rng.choice([286, 287, 300, 4000], 1)[0]
    lit = sym << 4 | rng.integers(1, 16, n)
    lit[rng.random(n) < 0.05] = 0
    lit[rng.random(n) < 0.02] = -rng.integers(1, 2**31)
    dist = rng.integers(0, 32, 256) << 4 | rng.integers(0, 16, 256)
    dist[:3] = [0, -17, 29 << 4]
    t = [torch.from_numpy(x).to(dev) for x in (
        words, start.astype(np.int64), counts.astype(np.int32),
        lit.astype(np.int32), dist.astype(np.int32))]
    return (*t, k, root_bits)


@pytest.mark.parametrize("root_bits", [7, 10, 12])
@pytest.mark.parametrize("k", [1, 31, 32, 33, 256])
def test_sync_decode_kernel_random_streams_match_plain(dev, k, root_bits):
    args = _sync_random_case(dev, k, root_bits)
    got = sd.sync_decode(*args)
    assert got.shape == (1003, k)
    _eq(got, sd.sync_decode_plain(*args))
    assert (got != 0).any() and (got[::7] == 0).all()


def test_sync_decode_kernel_main_path_shape(dev):
    """The chip_smoke shard: 1024 members x 65 slots = 66,560 slots."""
    stream = (DATA / "pgzf_sync_zipf_2m.pgz").read_bytes() * 32
    (g,) = pgzf._prepare_sync_device(stream, dev)
    args = _sd_args(g)
    assert g["start_bits"].numel() == 66560 and g["k_tok"] == 256
    _eq(sd.sync_decode(*args), sd.sync_decode_plain(*args))


def test_sync_decode_and_hist_kernel_info(dev):
    """Both kernels compile without spills and report their geometry:
    two-warp sync blocks, the main path's 66,560 slots all resident at
    once at every root; one sub-histogram a warp."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for rb in (7, 10, 12):
        info = sd.kernel_info(rb)
        assert info["spill_bytes"] == 0 and info["threads"] == 64
        assert info["dynamic_smem"] == 4 << rb
        assert info["blocks_per_sm"] * sms * 64 >= 66560
    h = hist.kernel_info()
    assert h["spill_bytes"] == 0 and h["blocks_per_sm"] >= 1
    assert h["dynamic_smem"] == 0 and h["threads"] % 32 == 0
    assert h["sub_histograms"] == h["threads"] // 32
    assert h["static_smem"] >= 4 * 320 * h["sub_histograms"]


def test_rank_and_resolve_kernels_match_plain(group):
    toks = sd.sync_decode(*_sd_args(group))
    cap = group["member_cap"]
    args = device_expand.rank_inputs(toks.view(group["bsz"], -1),
                                     group["n_tokens"], cap)[:4] + (cap,)
    src, lit = rank.rank_emit_src(*args)
    src_p, lit_p = rank.rank_emit_src_plain(*args)
    torch.testing.assert_close(src, src_p, rtol=0, atol=0)
    torch.testing.assert_close(lit, lit_p, rtol=0, atol=0)
    torch.testing.assert_close(expand.resolve_bytes(src, lit),
                               expand.resolve_bytes_plain(src, lit),
                               rtol=0, atol=0)


def test_rank_kernel_error_rows_match_plain(dev):
    packed = torch.zeros((3, 64), dtype=torch.int32, device=dev)
    packed[:, 0] = ord("x")
    packed[0, 1] = 5 | (3 << 9)
    packed[1, 1:] = 258 | (1 << 9)
    n_tok = torch.tensor([2, 64, 0], dtype=torch.int32, device=dev)
    out, n_out, err = device_expand.expand_members(packed, n_tok, 1024)
    args = device_expand.rank_inputs(packed, n_tok, 1024)[:4] + (1024,)
    src_p, lit_p = rank.rank_emit_src_plain(*args)
    torch.testing.assert_close(rank.rank_emit_src(*args)[0], src_p,
                               rtol=0, atol=0)
    torch.testing.assert_close(out, expand.resolve_bytes_plain(src_p, lit_p),
                               rtol=0, atol=0)
    assert err.tolist() == [True, True, False]


def _match(length: int, dist: int) -> int:
    return length | dist << 9


def _rank_members(out_cap: int, seed: int) -> list:
    """Token lists of the rank kernel's hard cases at ``out_cap``."""
    tile = rank.kernel_info()["tile"]
    rng = np.random.default_rng(seed)
    text = [int(x) for x in rng.integers(97, 123, out_cap)]
    mixed = [text[i] if rng.random() < 0.5
             else _match(int(rng.integers(3, 259)), int(rng.integers(1, 400)))
             for i in range(out_cap // 3 + 1)]
    return [
        # overflow: thousands of starts clipped to out_cap - 1
        [ord("x")] + [_match(258, 1)] * (out_cap // 258 + 3000),
        # more than TILE zero-length matches at one start, then a run
        [97, 98, 99] + [_match(0, 2)] * (tile + 904) + [122,
                                                        _match(258, 1)],
        [],                                        # n_tokens = 0
        # distance-1 runs of 258 bytes across every tile edge
        [ord("a")] + [_match(258, 1)] * (out_cap // 258 + 1),
        [ord("a"), _match(5, 3)] + text[:50],      # a bad distance
        mixed,
    ]


def _rank_args(dev, members, out_cap: int, n_out=None):
    t_cap = max(len(m) for m in members) + 7
    packed = torch.zeros((len(members), t_cap), dtype=torch.int32)
    for i, m in enumerate(members):
        packed[i, :len(m)] = torch.tensor(m, dtype=torch.int32)
    n_tok = torch.tensor([len(m) for m in members], dtype=torch.int32)
    args = list(device_expand.rank_inputs(packed, n_tok, out_cap)[:4])
    if n_out is not None:
        args[3] = torch.tensor(n_out, dtype=torch.int32)
    return [a.to(dev) for a in args] + [out_cap]


@pytest.mark.parametrize("out_cap", [1000, 1024, 4097, 70000])
def test_rank_kernel_hard_cases_match_plain(dev, out_cap):
    """Clipped and zero-length duplicate starts (more than a tile of
    them), an empty member, 258-byte distance-1 runs over the tile edges,
    a bad distance, and out_caps the main path never uses."""
    args = _rank_args(dev, _rank_members(out_cap, out_cap), out_cap)
    for got, want in zip(rank.rank_emit_src(*args),
                         rank.rank_emit_src_plain(*args)):
        _eq(got, want)


@pytest.mark.parametrize("out_cap", [2048, 3 * 4096 + 100, 16384])
def test_rank_kernel_past_128_starts_matches_plain(dev, out_cap):
    """Inputs past the reference's 128-wide search, where both versions
    follow its bounded search: 124 and 300 zero-length matches in one
    row, 2,000 past the 2048-slot window, no token covering the first
    positions, and the same members moved into later tiles."""
    base = chip_smoke.rank_hard_cases(dev)
    cases = [base] if out_cap == 2048 else []
    if out_cap != 2048:
        members = [[97] * (out_cap // 3) + [_match(0, 2)] * 300
                   + [_match(258, 1)],
                   [98] * 4095 + [_match(0, 1)] * 1500 + [99] * 50,
                   [_match(0, 3)] * 129 + [100] * 10]
        cases.append(_rank_args(dev, members, out_cap))
        shifted = _rank_args(dev, members, out_cap)
        shifted[0] = (shifted[0] + 7).clamp(max=out_cap - 1)
        cases.append(shifted)
    for args in cases:
        for got, want in zip(rank.rank_emit_src(*args),
                             rank.rank_emit_src_plain(*args)):
            _eq(got, want)


def test_rank_kernel_n_out_mid_tile_matches_plain(dev):
    """Tiles that are part live, part padding, wholly padding, and
    n_out outside [0, out_cap]."""
    tile = rank.kernel_info()["tile"]
    out_cap = 3 * tile + 100
    members = _rank_members(out_cap, 7)[3:] * 2 + [[ord("q")]]
    n_out = [0, 1, tile - 1, tile + 1234, out_cap - 3,
             out_cap + 5, -4]
    args = _rank_args(dev, members, out_cap, n_out)
    for got, want in zip(rank.rank_emit_src(*args),
                         rank.rank_emit_src_plain(*args)):
        _eq(got, want)


@pytest.mark.parametrize("seed", range(4))
def test_rank_kernel_random_tables_match_plain(dev, seed):
    """Random valid prefixes with repeated starts, random distances
    (many before the member), random n_out, B = 1024 at seed 0."""
    g = torch.Generator(device=dev).manual_seed(seed)
    bsz, t, out_cap = (1024, 2048, 8192) if seed == 0 else (5, 3000, 10000)
    step = torch.randint(0, 9, (bsz, t), generator=g, device=dev,
                         dtype=torch.int32)
    starts = (torch.cumsum(step, 1, dtype=torch.int32) - step)
    starts[1:2] += 3                               # no token at position 0
    pk = torch.randint(0, 2**25, (bsz, t), generator=g, device=dev,
                       dtype=torch.int32)
    pk = torch.where(torch.rand((bsz, t), generator=g, device=dev) < 0.3,
                     pk & 511, pk)
    n_valid = torch.randint(0, t + 1, (bsz, 1), generator=g, device=dev)
    valid = torch.arange(t, device=dev)[None, :] < n_valid
    n_out = torch.randint(-10, out_cap + 10, (bsz,), generator=g,
                          device=dev, dtype=torch.int32)
    args = (starts, pk, valid, n_out, out_cap)
    for got, want in zip(rank.rank_emit_src(*args),
                         rank.rank_emit_src_plain(*args)):
        _eq(got, want)


def test_rank_kernel_extreme_starts_match_plain(dev):
    """Starts far below 0 and near 2**31 (p - s wraps in int32, as in
    the plain version), a first token that starts after position 0, an
    invalid slot inside a tile, and a distance of 65535."""
    starts = torch.tensor([[-2**31 + 2, -2**31 + 5, 7, 100],
                           [3, 9, 9, 2**31 - 1],
                           [5000, 5001, 9000, 9001]], dtype=torch.int32)
    pk = torch.tensor([[_match(3, 7), _match(4, 65535), _match(5, 2), 97]]
                      * 3, dtype=torch.int32)
    valid = torch.tensor([[True, True, True, False], [True] * 4,
                          [True, True, False, False]])
    n_out = torch.tensor([4100, 9000, 12000], dtype=torch.int32)
    args = [a.to(dev) for a in (starts, pk, valid, n_out)] + [12288]
    for got, want in zip(rank.rank_emit_src(*args),
                         rank.rank_emit_src_plain(*args)):
        _eq(got, want)


def test_rank_and_pack_kernel_info(dev):
    """Both kernels (and the rank's reference-search kernel) compile
    without spills, fit on an SM with static shared memory only, and
    report the geometry they were built with: a rank tile of whole
    4-position runs over whole warps, one pack chunk a warp."""
    rk, pc = rank.kernel_info(), pack.kernel_info()
    for info in (rk, pc):
        assert info["spill_bytes"] == 0 and info["blocks_per_sm"] >= 1
        assert 0 < info["static_smem"] <= 48 * 1024
        assert info["dynamic_smem"] == 0 and info["threads"] % 32 == 0
    assert rk["tile"] % (4 * rk["threads"]) == 0 and rk["ref_spill_bytes"] == 0
    assert pc["threads"] == 32 * pc["chunks_per_block"]


@pytest.mark.parametrize("n", [3000, 4096, 70000])
def test_resolve_kernel_random_pointers_match_plain(dev, n):
    g = torch.Generator(device=dev).manual_seed(n)
    pos = torch.arange(n, device=dev)[None, :].expand(3, n)
    back = (torch.rand((3, n), generator=g, device=dev) * pos).long()
    src = torch.where(torch.rand((3, n), generator=g, device=dev) < 0.1,
                      pos, back)
    src[2, 7::50] += 9                    # some forward (corrupt) pointers
    src[2, 11::50] = -1
    lit = torch.randint(0, 256, (3, n), generator=g, device=dev)
    src, lit = src.int(), lit.int()
    torch.testing.assert_close(expand.resolve_bytes(src, lit),
                               expand.resolve_bytes_plain(src, lit),
                               rtol=0, atol=0)


def test_resolve_kernel_deep_chains(dev):
    """3-byte matches each copying the previous one: the longest chase."""
    n = 8192
    p = torch.arange(n, dtype=torch.int32, device=dev)
    src = torch.where(p < 3, p, p - 3)[None, :]
    lit = torch.full((1, n), 7, dtype=torch.int32, device=dev)
    lit[0, :3] = torch.tensor([1, 2, 3], device=dev)
    out = expand.resolve_bytes(src, lit)
    assert out[0].tolist() == [1, 2, 3] * (n // 3) + [1, 2][:n % 3]


def _resolve_rows(dev, bsz, n, seed, far=True):
    """(src, lit): a tenth literals, the rest pointing back at most 2 KiB,
    with pointers 32,768-33,100 back (the byte ring's edge) and, with
    ``far``, 33,800-60,000 back (past it: global memory) mixed in."""
    g = torch.Generator(device=dev).manual_seed(seed)
    pos = torch.arange(n, device=dev)[None, :].expand(bsz, n)

    def rnd(lo, hi):
        return torch.randint(lo, hi, (bsz, n), generator=g, device=dev)

    src = torch.where(rnd(0, 10) == 0, pos, (pos - rnd(1, 2048)).clamp(0))
    for lo, hi, on in ((32768, 33101, True), (33800, 60000, far)):
        back = pos - rnd(lo, hi)
        if on:
            src = torch.where((rnd(0, 8) == 0) & (back >= 0), back, src)
    return src.int(), rnd(0, 1 << 20).int()


def _resolve_eq(src, lit):
    got = expand.resolve_bytes(src, lit)
    assert got.is_cuda and got.shape == src.shape
    _eq(got, expand.resolve_bytes_plain(src, lit))


def test_resolve_kernel_info(dev):
    """No spills; the byte ring holds a DEFLATE pointer's reach (32,768 +
    257) before a tile; several members run on an SM at once."""
    info = expand.kernel_info()
    assert info["spill_bytes"] == 0 and info["blocks_per_sm"] >= 2
    assert info["ring_bytes"] - info["tile"] >= 32768 + 257
    assert info["ring_bytes"] % info["tile"] == 0 and info["stages"] >= 2
    assert info["dynamic_smem"] == (info["stages"] * info["tile"] * 8
                                    + info["ring_bytes"])


@pytest.mark.parametrize("n", [1, 15, 16, 17, 1000, 1023, 1024, 1025, 2047,
                               3072, 4095, 4096, 4097, 5121, 8192, 34816,
                               34817, 70000])
def test_resolve_kernel_tile_and_stage_edges(dev, n):
    """Row lengths below, at and across a tile, the stage ring and the
    byte ring (aligned rows take 16-byte copies and stores, others 4-byte
    copies and byte stores), with forward and negative pointers."""
    src, lit = _resolve_rows(dev, 3, n, n)
    src[1, 5::41] += 3
    src[2, 9::37] = -1 - src[2, 9::37]
    _resolve_eq(src, lit)


@pytest.mark.parametrize("n", [65536, 70000])
def test_resolve_kernel_corrupt_pointers_in_first_and_last_tile(dev, n):
    src, lit = _resolve_rows(dev, 2, n, 7)
    for t0 in (0, (n - 1) // 1024 * 1024):
        src[0, t0 + 3:t0 + 900:7] = n + 5                       # forward
        src[0, t0 + 5:t0 + 900:11] -= n                          # negative
        idx = torch.arange(t0 + 1, min(t0 + 900, n), 5, device=dev)
        src[1, idx] = (idx + 1).clamp(max=n - 1).int()          # p + 1
    _resolve_eq(src, lit)


@pytest.mark.parametrize("back", [1, 1000, 1024, 1025, 32768, 33025, 40000])
def test_resolve_kernel_chains_through_every_tile(dev, back):
    """Every position copies the one ``back`` before it: chains from the
    last tile down to the first, inside the tile (back 1), across one or
    two tiles, at the ring's reach and past it."""
    n = 65536
    p = torch.arange(n, dtype=torch.int32, device=dev)
    src = torch.where(p < back, p, p - back)[None, :]
    lit = (p * 7 + 3)[None, :]
    _resolve_eq(src, lit)


def test_resolve_kernel_unaligned_tensors(dev):
    """Rows that start off a 16-byte boundary take the 4-byte copies."""
    bsz, n = 2, 8192
    src, lit = _resolve_rows(dev, bsz, n, 11)
    flat = torch.empty(2 * bsz * n + 1, dtype=torch.int32, device=dev)
    s2 = flat[1:bsz * n + 1].view(bsz, n)
    l2 = flat[bsz * n + 1:].view(bsz, n)
    s2.copy_(src)
    l2.copy_(lit)
    assert s2.is_contiguous() and s2.data_ptr() % 16 != 0
    _resolve_eq(s2, l2)


@pytest.mark.parametrize("bsz", [1, 128, 1024])
def test_resolve_kernel_members(dev, bsz):
    """One member, a stripped-decode group of 128 and a 64 MiB shard's
    1024, at 65,536 positions each."""
    src, lit = _resolve_rows(dev, bsz, 65536, bsz, far=bsz < 1024)
    _resolve_eq(src, lit)


@pytest.mark.parametrize("name", ["pgzf_sync_zipf_small.pgz",
                                  "pgzf_sync_zipf_2m.pgz"])
def test_decompress_to_device_on_cuda(dev, name, monkeypatch):
    data = (DATA / name).read_bytes()

    def no_plain(*a, **k):
        raise AssertionError("a CUDA tensor reached a plain version")

    for mod, fn in ((sd, "sync_decode_plain"), (rank, "rank_emit_src_plain"),
                    (expand, "resolve_bytes_plain")):
        monkeypatch.setattr(mod, fn, no_plain)
    before = [sd.sync_decode.launches, rank.rank_emit_src.launches,
              expand.resolve_bytes.launches]
    out, lengths = pgzf.decompress_to_device(data, verify=True,
                                             device="cuda")
    after = [sd.sync_decode.launches, rank.rank_emit_src.launches,
             expand.resolve_bytes.launches]
    assert out.is_cuda and lengths.is_cuda
    assert all(a == b + 1 for a, b in zip(after, before))
    live = (torch.arange(out.shape[1], device=dev)[None, :]
            < lengths[:, None])
    assert bytes(out[live].cpu().numpy()) == gzip.decompress(data)
    assert not out[~live].any()
    np.testing.assert_array_equal(lengths.cpu().numpy() > 0, True)


def _foreign_stdlib():
    """Stdlib gzip members at levels 1, 6 and 9 and a member of random
    bytes (stored blocks), no index."""
    plain = gzip.decompress((DATA / "pgzf_sync_zipf_2m.pgz").read_bytes())
    rng = np.random.default_rng(6)
    parts = [(plain[:65536], 1), (plain[65536:150000], 6),
             (plain[150000:151000], 9),
             (rng.integers(0, 256, 5000, dtype=np.uint8).tobytes(), 6)]
    return b"".join(gzip.compress(p, compresslevel=lv) for p, lv in parts)


@pytest.mark.parametrize("make", [
    _foreign_stdlib,
    lambda: (DATA / "pgzf_encode_small.pgz").read_bytes()],
    ids=["stdlib_gzip", "pgzf_encode_small"])
def test_foreign_decompress_to_device_on_cuda(dev, make, monkeypatch):
    """The foreign-stream path on the card: rank and resolve launched
    once, no plain version reached, rows equal to stdlib gzip's."""
    data = make()

    def no_plain(*a, **k):
        raise AssertionError("a CUDA tensor reached a plain version")

    for mod, fn in ((rank, "rank_emit_src_plain"),
                    (expand, "resolve_bytes_plain")):
        monkeypatch.setattr(mod, fn, no_plain)
    before = [rank.rank_emit_src.launches, expand.resolve_bytes.launches]
    out, lengths = pgzf.decompress_to_device(data, verify=True,
                                             device="cuda")
    after = [rank.rank_emit_src.launches, expand.resolve_bytes.launches]
    assert out.is_cuda and lengths.is_cuda
    assert all(a == b + 1 for a, b in zip(after, before))
    live = (torch.arange(out.shape[1], device=dev)[None, :]
            < lengths[:, None])
    assert bytes(out[live].cpu().numpy()) == gzip.decompress(data)
    assert not out[~live].any()


# ---- encode kernels --------------------------------------------------------


def _eq(got, want):
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.fixture(scope="module")
def enc_batch(dev):
    """128 members of 4 KiB: text, runs, a short member, random bytes."""
    plain = gzip.decompress((DATA / "pgzf_sync_zipf_2m.pgz").read_bytes())
    n = 4096
    rows = np.frombuffer(plain[:128 * n], np.uint8).reshape(128, n).copy()
    rng = np.random.default_rng(0)
    rows[1] = np.repeat(rng.integers(0, 3, n // 64, dtype=np.uint8), 64)
    rows[2, 1000:] = 0
    rows[3] = rng.integers(0, 256, n, dtype=np.uint8)
    nv = np.full(128, n, np.int32)
    nv[2] = 1000
    return (torch.from_numpy(rows).to(dev), torch.from_numpy(nv).to(dev))


def _skewed_text(dev, g, bsz: int, n: int) -> torch.Tensor:
    """(bsz, n) uint8 of a 13-letter alphabet, Zipf-like: keys whose
    bytes take few values, so a radix digit takes few values too."""
    alphabet = torch.tensor(list(b" etaoinshrdlu"), dtype=torch.uint8,
                            device=dev)
    weights = 1.0 / torch.arange(1, 14, device=dev) ** 1.2
    idx = torch.multinomial(weights, bsz * n, replacement=True, generator=g)
    return alphabet[idx].view(bsz, n)


def _sort_case(dev, n: int, pattern: str) -> torch.Tensor:
    bsz = 128 if n == 65536 else 4
    g = torch.Generator(device=dev).manual_seed(n)
    rnd = torch.randint(-2 ** 31, 2 ** 31 - 1, (bsz, n), generator=g,
                        device=dev, dtype=torch.int64).to(torch.int32)
    if pattern == "random":
        return rnd
    if pattern == "few":                    # many ties: stability
        return rnd % 5
    if pattern == "equal":
        return torch.full_like(rnd, -7)
    if pattern == "descending":
        down = torch.arange(n - 1, -1, -1, device=dev) * 65537 - 2 ** 31
        return down.to(torch.int32).expand(bsz, n).contiguous()
    text = _skewed_text(dev, g, bsz, n)
    if pattern == "text":
        return sm.prefix_keys(text)[:, :n].contiguous()
    assert pattern == "padding"             # a padding tail after text
    text[:, 5::97] = 0xFF                   # keys equal to the padding key
    text[:, 3::101] = 0xFF
    text[:, 4::101] = 0xFF
    text[:, 6::101] = 0xFF
    keys = sm.prefix_keys(text[:, :n // 4 + 5])
    return torch.nn.functional.pad(keys[:, :n // 4 + 5],
                                   (0, n - n // 4 - 5), value=2 ** 31 - 1)


@pytest.mark.parametrize("pattern", ["random", "few", "equal", "descending",
                                     "text", "padding"])
@pytest.mark.parametrize("n", [1024, 2048, 3072, 8192, 16384, 65536])
def test_sort_keys_kernel_matches_plain(dev, n, pattern):
    """Every cluster size the main path and the tests give (1, 2 and 8
    CTAs), B = 128 at the main path's n = 65536."""
    key = _sort_case(dev, n, pattern)
    before = sm.sort_keys.launches
    got = sm.sort_keys(key)
    assert sm.sort_keys.launches == before + 1
    want = sm.sort_keys_plain(key)
    _eq(got[0], want[0])
    _eq(got[1], want[1])


@pytest.mark.parametrize("n", [1024, 3000, 65536])
def test_scan_emit_kernel_matches_plain_across_tiles(dev, n):
    """Rows whose equal-key runs are longer than a scan tile (4096 slots),
    so a tile's first slots score predecessors from the 8-slot halo; at
    n = 1024 one tile; n = 3000 stages the bytes one by one and pads the
    keys to 4096 slots."""
    plain = gzip.decompress((DATA / "pgzf_sync_zipf_2m.pgz").read_bytes())
    g = torch.Generator(device=dev).manual_seed(n)
    rows = torch.frombuffer(bytearray(plain[:8 * n]),
                            dtype=torch.uint8).view(8, n).to(dev)
    rows[0] = torch.tensor(list(b"ab"), dtype=torch.uint8,
                           device=dev).repeat(n // 2 + 1)[:n]
    rows[1] = torch.tensor(list(b"abcab"), dtype=torch.uint8,
                           device=dev).repeat(n // 5 + 1)[:n]
    rows[2] = 0
    rows[3] = 0xFF                          # keys equal to the padding key
    rows[4] = _skewed_text(dev, g, 1, n)[0]
    rows[5] = torch.randint(0, 256, (n,), generator=g, device=dev,
                            dtype=torch.int32).to(torch.uint8)
    keys = sm.prefix_keys(rows)
    sk, sp = sm.sort_keys(keys)
    tile = sm.scan_geometry(keys.shape[1], n)[0]
    if keys.shape[1] > tile:
        assert bool((sk[:, tile] == sk[:, tile - 1]).any())
    for got, want in zip(sm.scan_emit(sk, sp, rows),
                         sm.scan_emit_plain(sk, sp, rows)):
        _eq(got, want)


def test_match_kernels_match_plain(enc_batch):
    blocks, _nv = enc_batch
    keys = sm.prefix_keys(blocks)
    sk, sp = sm.sort_keys(keys)
    for got, want in zip(sm.scan_emit(sk, sp, blocks),
                         sm.scan_emit_plain(sk, sp, blocks)):
        _eq(got, want)


@pytest.mark.parametrize("cap", [384, 512])
def test_parse_kernels_match_plain(enc_batch, cap):
    blocks, nv = enc_batch
    cand, lengths = pipeline.lengths_stage(blocks, nv,
                                           *sm.sort_candidates(blocks))
    jump, tok = parse.parse_inputs(blocks, nv, cand, lengths)
    ex = parse.chunk_exits(jump)
    _eq(ex, parse.chunk_exits_plain(jump))
    for got, want in zip(parse.walk_emit(jump, tok, ex, cap),
                         parse.walk_emit_plain(jump, tok, ex, cap)):
        _eq(got, want)


def _parse_case(dev, bsz: int, n: int, kind: str, seed: int):
    """(jump, tok) of ``bsz`` members of ``n`` positions: all literals
    (jump = p + 1, the longest walk), all 258-byte matches, or a mix;
    member i > 0 has holes (tok = -1) from ``n - 700 * i``."""
    rng = np.random.default_rng(seed)
    idx = np.arange(n)[None, :]
    if kind == "literals":
        ln = np.ones((bsz, n), np.int64)
    elif kind == "max_matches":
        ln = np.full((bsz, n), 258)
    else:
        ln = np.where(rng.random((bsz, n)) < 0.3,
                      rng.integers(3, 259, (bsz, n)), 1)
    jump = np.minimum(idx + ln, n).astype(np.int32)
    tok = (rng.integers(0, 256, (bsz, n))
           | rng.integers(0, 32768, (bsz, n)) << 9).astype(np.int32)
    n_valid = np.maximum(n - 700 * np.arange(bsz), 1)
    tok[idx >= n_valid[:, None]] = -1
    return (torch.from_numpy(jump).to(dev), torch.from_numpy(tok).to(dev))


@pytest.mark.parametrize("cap", [384, 512])
@pytest.mark.parametrize("kind", ["literals", "max_matches", "mixed"])
@pytest.mark.parametrize("bsz,n", [(3, 1024), (8, 65536)])
def test_parse_kernels_match_plain_on_orbits(dev, bsz, n, kind, cap):
    """Both kernels bit-identical to their plain versions on hand-made
    orbits, with holes; all literals overflow a 384-slot chunk."""
    jump, tok = _parse_case(dev, bsz, n, kind, seed=n + len(kind) + cap)
    ex = parse.chunk_exits(jump)
    _eq(ex, parse.chunk_exits_plain(jump))
    out, ovf = parse.walk_emit(jump, tok, ex, cap)
    out_p, ovf_p = parse.walk_emit_plain(jump, tok, ex, cap)
    _eq(out, out_p)
    _eq(ovf, ovf_p)
    if kind == "literals":
        assert bool(ovf[0].all()) == (cap < 512)


def test_walk_emit_on_two_devices(dev):
    """The walk's shared-memory limit is raised on each device it runs on:
    after a launch on the first card, a launch on the second (the current
    device there) still takes its 164 KB of dynamic shared memory."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    for i in (0, 1):
        d = torch.device("cuda", i)
        with torch.cuda.device(d):
            jump, tok = _parse_case(d, 2, 65536, "mixed", seed=i)
            ex = parse.chunk_exits(jump)
            _eq(ex, parse.chunk_exits_plain(jump))
            for got, want in zip(parse.walk_emit(jump, tok, ex, 384),
                                 parse.walk_emit_plain(jump, tok, ex, 384)):
                assert got.device == d
                _eq(got, want)


def test_parse_kernel_info(dev):
    """Both parse kernels compile without spills and fit on an SM at the
    main path's shape (the walk stages 127 chunk heads, 16 slot rows and
    the entries)."""
    info = parse.kernel_info(65536)
    for k in ("chunk_exits", "walk_emit"):
        assert info[k]["spill_bytes"] == 0 and info[k]["blocks_per_sm"] >= 1
    assert info["walk_emit"]["dynamic_smem"] == 4 * (128 + 16 * 512
                                                     + 127 * 258)


def test_hist_fields_pack_kernels_match_plain(enc_batch):
    blocks, nv = enc_batch
    a, b, valid, _cnt, _ovf = pipeline.tokenize(blocks, nv)
    _eq(hist.token_hist(a, b, valid), hist.token_hist_plain(a, b, valid))
    stats = pipeline.shared_stats(a, b, valid)
    tables = fields.field_tables(*stats[2:], blocks.device)
    a_h = torch.where(valid, a, -1)
    f = fields.token_fields(a_h, b, tables)
    for got, want in zip(f, fields.token_fields_plain(a_h, b, tables)):
        _eq(got, want)
    header = deflate_encode.dynamic_header_fields(*stats[:2])
    values, widths = deflate_encode.assemble_fields(
        header, f, stats[2][256], stats[3][256])
    pad = (-values.shape[1]) % pack.F_CH
    values = torch.nn.functional.pad(values, (0, pad)).contiguous()
    widths = torch.nn.functional.pad(widths, (0, pad)).contiguous()
    starts, bits = pack.chunk_starts(widths)
    w_out = (int(bits.max()) + 31) // 32 + 1
    _eq(pack.pack_stitch(values, widths, starts[:, :-1], w_out),
        pack.pack_stitch_plain(values, widths, starts[:, :-1], w_out))


def _hist_case(dev, kind: str, n: int):
    rng = np.random.default_rng(n)
    a = rng.integers(0, 256, n)
    b = np.where(rng.random(n) < 0.3, rng.integers(1, 32769, n), 0)
    a = np.where(b > 0, rng.integers(3, 259, n), a)
    valid = rng.random(n) < 0.9
    if kind == "one_literal":                  # every slot in bin 101
        a, b, valid = np.full(n, 101), np.zeros(n), np.ones(n, bool)
    elif kind == "one_match":                  # two bins, every slot
        a, b, valid = np.full(n, 258), np.full(n, 1), np.ones(n, bool)
    elif kind == "invalid":
        valid[:] = False
    elif kind == "runs":                       # live prefixes, then holes
        valid = np.arange(n) % 64 < 20
    elif kind == "out_of_range":
        a = rng.integers(-2**31, 2**31, n)
        b = np.where(rng.random(n) < 0.5, 0, rng.integers(-2**31, 2**31, n))
        b[::5] = rng.integers(32769, 2**31, len(b[::5]))
        a[1::5] = rng.integers(-600, 600, len(a[1::5]))
    return [torch.from_numpy(x).to(dev) for x in (
        a.astype(np.int32), b.astype(np.int32), valid)]


@pytest.mark.parametrize("n", [0, 1, 3, 4, 4097, 128 * 49152 + 5])
@pytest.mark.parametrize("kind", ["mixed", "one_literal", "one_match",
                                  "invalid", "runs", "out_of_range"])
def test_hist_kernel_hard_cases_match_plain(dev, kind, n):
    """Contention on one bin, no valid slot, valid slots in runs (whole
    groups of four invalid ones skip a and b), a and b outside the
    encoder's range, sizes not a multiple of 4 slots; two calls in a row
    give the same bins (the kernel leaves its state zero)."""
    a, b, valid = _hist_case(dev, kind, n)
    first = hist.token_hist(a, b, valid)
    _eq(first, hist.token_hist_plain(a, b, valid))
    _eq(hist.token_hist(a, b, valid), first)
    if kind == "invalid":
        assert int(first.sum()) == 0


@pytest.mark.parametrize("n", [5, 4097, 128 * 49152 + 3])
def test_hist_kernel_any_int32_matches_plain(dev, n):
    """Slots over all of int32, 30% valid: the reference's packing and
    bin decode (no clamp) in both versions."""
    g = torch.Generator(device=dev).manual_seed(n)
    a, b = (torch.randint(-2**31, 2**31 - 1, (n,), generator=g, device=dev,
                          dtype=torch.int32) for _ in range(2))
    b = torch.where(torch.rand(n, generator=g, device=dev) < 0.5, 0, b)
    valid = torch.rand(n, generator=g, device=dev) < 0.3
    first = hist.token_hist(a, b, valid)
    _eq(first, hist.token_hist_plain(a, b, valid))
    _eq(hist.token_hist(a, b, valid), first)


@pytest.mark.parametrize("offsets", [(1, 0, 0), (0, 2, 0), (0, 0, 3),
                                     (3, 1, 2), (4, 4, 4)])
def test_hist_kernel_unaligned_views_match_plain(dev, offsets):
    """a, b and valid as views whose data pointers are off 16 (4 for
    valid) bytes: the scalar path; offsets of 4 slots keep the vector
    path with a ragged tail."""
    n = 100_003
    a, b, valid = _hist_case(dev, "mixed", n + 4)
    views = [t[o:o + n] for t, o in zip((a, b, valid), offsets)]
    _eq(hist.token_hist(*views), hist.token_hist_plain(*views))



def _fields_case(dev, bsz: int, m: int, seed: int, deflate_tables=True):
    """Tokens with holes, out-of-range lengths and distances, per-member
    counts 0 / below M / M, and random tables in DEFLATE's ranges (one
    row a member, and the first row alone as the shared table)."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, (bsz, m))
    b = np.where(rng.random((bsz, m)) < 0.4, rng.integers(1, 32769, (bsz, m)),
                 0)
    a = np.where(b > 0, rng.integers(3, 259, (bsz, m)), a)
    a[rng.random((bsz, m)) < 0.1] = -1
    wild = rng.random((bsz, m)) < 0.05
    a[wild] = rng.integers(-600, 600, int(wild.sum()))
    b[wild] = rng.integers(-40000, 40000, int(wild.sum()))
    a.reshape(-1)[:6] = [0, 2, 258, 259, 255, 256]
    b.reshape(-1)[:6] = [1, 32768, 40000, 5, 0, -7]
    nt = rng.integers(0, m + 1, bsz)
    nt[:3] = [m, 0, m // 3][:bsz]
    lit_w = rng.integers(0, 16, (bsz, 288))
    dist_w = rng.integers(0, 16, (bsz, 30))
    lit_rev = rng.integers(0, 1 << 15, (bsz, 288))
    dist_rev = rng.integers(0, 1 << 15, (bsz, 30))
    per = fields.field_tables(lit_rev, lit_w, dist_rev, dist_w, dev)
    t = [torch.from_numpy(x.astype(np.int32)).to(dev) for x in (a, b, nt)]
    return t[0], t[1], t[2], per


@pytest.mark.parametrize("bsz,m", [(1, 4096), (1, 8191), (3, 2050),
                                   (130, 6000), (128, 49152)])
@pytest.mark.parametrize("form", ["shared", "shared_counts", "per_member",
                                  "per_member_counts"])
def test_fields_kernel_forms_match_plain(dev, bsz, m, form):
    """The shared (N_TABLE,) and per-member (B, N_TABLE) tables, with and
    without counts; M % 4 != 0 takes the scalar path; B = 1; the encode's
    128 x 49152."""
    a, b, nt, per = _fields_case(dev, bsz, m, seed=bsz + m)
    tables = per if form.startswith("per_member") else per[0]
    counts = nt if form.endswith("counts") else None
    got = fields.token_fields(a, b, tables, counts)
    for x, y in zip(got, fields.token_fields_plain(a, b, tables, counts)):
        _eq(x, y)
    if counts is not None:
        past = (torch.arange(m, device=dev)[None, :]
                >= counts.to(torch.int64)[:, None])
        assert not got[1][past].any() and not got[3][past].any()


@pytest.mark.parametrize("offsets", [(1, 0), (0, 3), (2, 2), (4, 4)])
@pytest.mark.parametrize("per_member", [False, True])
def test_fields_kernel_unaligned_views_match_plain(dev, offsets, per_member):
    """a and b as views off a 16-byte boundary: the scalar path; offsets
    of 4 slots keep the vector path."""
    bsz, m = 5, 3000
    a, b, nt, per = _fields_case(dev, bsz, m + 4, seed=7)
    views = [t.reshape(-1)[o:o + bsz * m].view(bsz, m)
             for t, o in zip((a, b), offsets)]
    tables = per if per_member else per[0]
    counts = nt.clamp(max=m) if per_member else None
    got = fields.token_fields(*views, tables, counts)
    for x, y in zip(got, fields.token_fields_plain(*views, tables, counts)):
        _eq(x, y)


def test_fields_kernel_per_member_tables_at_the_encode_batch(enc_batch):
    """Each member's own package-merge tables from its own histogram, and
    its count of valid slots, on the tokens of a real batch compacted to
    a prefix (the generic engine's form)."""
    blocks, nv = enc_batch
    a, b, valid, _cnt, _ovf = pipeline.tokenize(blocks, nv)
    order = torch.argsort((~valid).to(torch.int8), dim=1, stable=True)
    a_c, b_c = (torch.gather(x, 1, order) for x in (a, b))
    nt = valid.sum(dim=1).to(torch.int32)
    tables = fields.field_tables(*member_codes(a_c, b_c, nt), blocks.device)
    got = fields.token_fields(a_c, b_c, tables, nt)
    for x, y in zip(got, fields.token_fields_plain(a_c, b_c, tables, nt)):
        _eq(x, y)
    assert int((got[1] > 0).sum()) == int(nt.sum())


def test_fields_kernel_info(dev):
    info = fields.kernel_info()
    assert info["spill_bytes"] == 0 and info["blocks_per_sm"] >= 4
    assert info["tile_slots"] == info["threads"] * 16
    assert info["static_smem"] >= (256 + 259 + 30) * 4

def _pack_widths(kind: str, bsz: int, f: int, g) -> torch.Tensor:
    dev = g.device
    w = torch.randint(-3, 33, (bsz, f), generator=g, device=dev,
                      dtype=torch.int32)
    if kind == "zero_runs":                       # runs and whole chunks
        w[:, pack.F_CH:3 * pack.F_CH] = 0
        w[:, 5 * pack.F_CH + 7:5 * pack.F_CH + 200] = 0
        w[0] = 0                                   # a member of nothing
    elif kind == "width32":
        w = torch.where(w > 16, 32, w.clamp(min=0))
    elif kind == "negative":
        w = torch.where(w > 20, -w, w)
    elif kind == "aligned":                        # every start % 32 == 0
        fours = (w[:, ::4] > 16).repeat_interleave(4, dim=1)
        w = torch.where(fours, 32, 8).to(torch.int32)
    elif kind == "one_word":                       # a chunk in one word
        w = torch.zeros_like(w)
        w[:, ::pack.F_CH] = 5
        w[:, 3::pack.F_CH] = 9
    return w


@pytest.mark.parametrize("bsz,n_ch", [(1, 386), (128, 8)])
@pytest.mark.parametrize("kind", ["random", "zero_runs", "width32",
                                  "negative", "aligned", "one_word"])
@pytest.mark.parametrize("cut", [False, True])
def test_pack_kernel_hard_cases_match_plain(dev, bsz, n_ch, kind, cut):
    """Zero-width runs and chunks, width 32 and negative widths (0),
    word-aligned and unaligned chunk starts, chunks inside one word, and
    w_out cut short (words past it dropped)."""
    g = torch.Generator(device=dev).manual_seed(n_ch)
    f = n_ch * pack.F_CH
    values = torch.randint(-2**31, 2**31 - 1, (bsz, f), generator=g,
                           device=dev, dtype=torch.int64).int()
    widths = _pack_widths(kind, bsz, f, g)
    starts, bits = pack.chunk_starts(widths.clamp(0, 32))
    w_out = (int(bits.max()) + 31) // 32 + 1
    if cut:
        w_out = max(w_out // 3, 1)
    got = pack.pack_stitch(values, widths, starts[:, :-1], w_out)
    _eq(got, pack.pack_stitch_plain(values, widths, starts[:, :-1], w_out))
    if kind == "aligned":
        assert int((starts % 32).abs().sum()) == 0


def test_pack_kernel_gaps_and_unaligned_tensors_match_plain(dev):
    """Chunks with gaps between them, and values / widths whose data
    pointer is not 16-byte aligned (the wrapper copies them)."""
    g = torch.Generator(device=dev).manual_seed(3)
    bsz, n_ch = 3, 4
    f = n_ch * pack.F_CH
    buf = torch.zeros((2 * bsz * f + 1,), dtype=torch.int32, device=dev)
    values = buf[1:bsz * f + 1].view(bsz, f)
    widths = buf[bsz * f + 1:].view(bsz, f)
    values.copy_(torch.randint(-2**31, 2**31 - 1, (bsz, f), generator=g,
                               device=dev, dtype=torch.int64))
    widths.copy_(torch.randint(0, 33, (bsz, f), generator=g, device=dev))
    assert values.data_ptr() % 16 and widths.data_ptr() % 16
    starts = torch.tensor([[7, 9000, 20000, 40000]] * bsz, dtype=torch.int32,
                          device=dev)
    w_out = 40000 // 32 + 300
    _eq(pack.pack_stitch(values, widths, starts, w_out),
        pack.pack_stitch_plain(values, widths, starts, w_out))


@pytest.mark.parametrize("name,member", [("pgzf_encode_small.pgz", 1024),
                                         ("pgzf_encode_zipf_2m.pgz", 8192)])
def test_compress_on_cuda_matches_reference_stream(dev, monkeypatch, name,
                                                   member):
    ref = (DATA / name).read_bytes()
    plain = gzip.decompress(ref)
    kernels = (sm.sort_keys, sm.scan_emit, parse.chunk_exits,
               parse.walk_emit, hist.token_hist, fields.token_fields,
               pack.pack_stitch)
    before = [k.launches for k in kernels]
    for mod, fn in ((sm, "sort_keys_plain"), (sm, "scan_emit_plain"),
                    (parse, "chunk_exits_plain"), (parse, "walk_emit_plain"),
                    (hist, "token_hist_plain"),
                    (fields, "token_fields_plain"),
                    (pack, "pack_stitch_plain")):
        monkeypatch.setattr(mod, fn, lambda *a, **k: (_ for _ in ()).throw(
            AssertionError("a CUDA tensor reached a plain version")))
    assert pgzf.compress(plain, member_size=member, device="cuda") == ref
    assert all(k.launches > b for k, b in zip(kernels, before))


# ---- encode options: LCP, gather and hash kernels ---------------------------


@pytest.fixture(scope="module")
def lcp_rows(dev):
    """8 members of 64 KiB of the zipf text, with their sort candidates
    at window 32768 (a fifth moved to random earlier positions) and the
    exact prefixes."""
    plain = gzip.decompress((DATA / "pgzf_sync_zipf_2m.pgz").read_bytes())
    n = 65536
    rows = torch.frombuffer(bytearray(plain[:8 * n]),
                            dtype=torch.uint8).view(8, n).to(dev)
    cand, m4 = sm.sort_candidates(rows)
    g = torch.Generator(device=dev).manual_seed(3)
    pos = torch.arange(n, device=dev)[None, :].expand(8, n)
    moved = torch.rand((8, n), generator=g, device=dev) < 0.2
    rnd = (torch.rand((8, n), generator=g, device=dev) * pos).int()
    cand = torch.where(moved & (pos > 0), rnd, cand)
    nv = torch.tensor([n] * 7 + [40000], dtype=torch.int32, device=dev)
    return rows, nv, cand, m4


@pytest.mark.parametrize("n,window", [(16384, 4096), (65536, 32768),
                                      (65536, 8192), (1024, 32768),
                                      (4096, 32768)])
@pytest.mark.parametrize("with_m4", [False, True])
def test_lcp_kernel_matches_plain(lcp_rows, n, window, with_m4):
    """n = 1024 (one group) and 4096 at window 32768 sweep the whole
    member (``win_groups == groups``)."""
    rows, nv, cand, m4 = lcp_rows
    args = (rows[:, :n].contiguous(), cand[:, :n].contiguous(),
            nv.clamp(max=n))
    kw = ({"max_rounds": 8, "window": window, "m4": m4[:, :n].contiguous(),
           "m_exact": sm.M_EXACT} if with_m4
          else {"max_rounds": 6, "window": window})
    got = lcp.match_lengths(*args, **kw)
    assert got.is_cuda
    _eq(got, lcp.match_lengths_plain(*args, **kw))


def test_lcp_kernel_info(dev):
    """No spills; the chain level's band (34 groups) and the sort
    matcher's (10) leave room for several blocks on an SM."""
    wide, narrow = lcp.kernel_info(65536, 32768), lcp.kernel_info(65536,
                                                                   8192)
    for info in (wide, narrow):
        assert info["spill_bytes"] == 0 and info["blocks_per_sm"] >= 3
        assert info["slice"] % 1024 == 0 and info["threads"] % 32 == 0
    span = (34 + wide["slice"] // 1024 - 1) * 1024 + 16
    assert wide["dynamic_smem"] == span + 8 * wide["slice"]
    assert narrow["dynamic_smem"] < wide["dynamic_smem"]


@pytest.fixture(scope="module")
def lcp_batch(dev):
    """128 members of 64 KiB (the 2 MiB zipf text four times) and their
    level-2 chain candidates, as the quality mode's lengths stage makes
    them."""
    plain = gzip.decompress((DATA / "pgzf_sync_zipf_2m.pgz").read_bytes())
    n = 65536
    rows = torch.frombuffer(bytearray(plain * 4), dtype=torch.uint8).view(
        128, n).to(dev)
    cand, _m4 = sm.sort_candidates(rows)
    return rows, gather.gather_rows(cand, cand, window=32768)


def test_lcp_kernel_chain_level_at_full_batch(lcp_batch):
    """The quality mode's chain-level call (no m4, 8 rounds, window 32768)
    at the main path's 128 x 65536."""
    rows, level2 = lcp_batch
    nv = torch.full((128,), 65536, dtype=torch.int32, device=rows.device)
    kw = {"max_rounds": 8, "window": 32768}
    got = lcp.match_lengths(rows, level2, nv, **kw)
    _eq(got, lcp.match_lengths_plain(rows, level2, nv, **kw))
    assert int((got == 32).sum()) > 1000 and int((got < 32).sum()) > 1000


def _lcp_case(lcp_rows, case):
    """(rows, cand, n_valid, max_rounds) of one hard case on the fixture's
    8 members: n_valid 0 or 40000; 70 rounds on a member whose second
    half repeats its first (the 258 cap decides); candidates at or after
    e, spread over the whole row (most outside the band), or any int32
    (negative and >= n among them); or rows, candidates and m4 given as
    views 4 bytes past a 16-byte boundary, which the wrapper copies."""
    rows, nv, cand, _m4 = lcp_rows
    dev = rows.device
    bsz, n = rows.shape
    g = torch.Generator(device=dev).manual_seed(17)
    pos = torch.arange(n, device=dev)[None, :].expand(bsz, n)
    rounds = 8
    if case == "n_valid_0":
        nv = torch.zeros_like(nv)
    elif case == "n_valid_40000":
        nv = torch.full_like(nv, 40000)
    elif case == "rounds_70":
        rows = rows.clone()
        rows[1, 40000:50000] = rows[1, 20000:30000]
        cand = cand.clone()
        cand[1, 40000:50000] = torch.arange(20000, 30000, device=dev,
                                            dtype=torch.int32)
        rounds = 70
    elif case == "after":
        cand = (pos + torch.randint(0, 2000, (bsz, n), generator=g,
                                    device=dev)).int()
    elif case == "spread":
        cand = torch.randint(0, n, (bsz, n), generator=g, device=dev,
                             dtype=torch.int32)
    elif case == "wild":
        cand = torch.randint(-2**31, 2**31 - 1, (bsz, n), generator=g,
                             device=dev, dtype=torch.int64).int()
        edge = torch.tensor([-5, -1, n - 1, n, n + 5], device=dev,
                            dtype=torch.int32)
        pick = torch.randint(0, 5, (bsz, n), generator=g, device=dev)
        cand = torch.where(torch.rand((bsz, n), generator=g, device=dev)
                           < 0.3, edge[pick], cand)
    elif case == "unaligned":
        rows, cand = (_unaligned(t) for t in (rows, cand))
    return rows, cand.contiguous(), nv, rounds


def _unaligned(t):
    """A view of ``t``'s values that starts 4 bytes past a 16-byte
    boundary."""
    step = 4 // t.element_size()
    buf = torch.empty(t.numel() + step, dtype=t.dtype, device=t.device)
    view = buf[step:].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16 and view.is_contiguous()
    return view


@pytest.mark.parametrize("case", ["n_valid_0", "n_valid_40000", "rounds_70",
                                  "after", "spread", "wild", "unaligned"])
@pytest.mark.parametrize("with_m4", [False, True])
def test_lcp_kernel_hard_cases(lcp_rows, case, with_m4):
    rows, cand, nv, rounds = _lcp_case(lcp_rows, case)
    kw = {"max_rounds": rounds, "window": 32768}
    if with_m4:
        m4 = lcp_rows[3]
        kw.update(m4=_unaligned(m4) if case == "unaligned" else m4,
                  m_exact=sm.M_EXACT, window=8192)
    got = lcp.match_lengths(rows, cand, nv, **kw)
    _eq(got, lcp.match_lengths_plain(rows, cand, nv, **kw))
    if case == "rounds_70" and not with_m4:
        assert int((got[1, 40000:49000] == 258).sum()) > 8000


@pytest.mark.parametrize("m_exact", [4, 16, 24])
@pytest.mark.parametrize("window", [8192, 32768])
def test_lcp_kernel_first_rounds(lcp_rows, m_exact, window):
    """first_round 1, 4 and 6: m4 is the whole-member prefix capped at
    m_exact, a tenth of it moved up or down (negative among them)."""
    rows, nv, cand, _m4 = lcp_rows
    dev = rows.device
    g = torch.Generator(device=dev).manual_seed(m_exact)
    m4 = lcp.match_lengths_plain(rows, cand, nv, max_rounds=m_exact // 4,
                                 window=65536).clamp(max=m_exact)
    shift = torch.randint(-6, 7, m4.shape, generator=g, device=dev)
    m4 = torch.where(torch.rand(m4.shape, generator=g, device=dev) < 0.1,
                     m4 + shift, m4).int()
    kw = {"max_rounds": 10, "window": window, "m4": m4, "m_exact": m_exact}
    got = lcp.match_lengths(rows, cand, nv, **kw)
    _eq(got, lcp.match_lengths_plain(rows, cand, nv, **kw))
    assert int((got > m_exact).sum()) > 100


@pytest.mark.parametrize("window", [None, 2048])
def test_gather_kernel_matches_plain(lcp_rows, window):
    _rows, _nv, cand, _m4 = lcp_rows
    idx = cand.clone()
    idx[:, 5::97] = cand.shape[1] + 7
    _eq(gather.gather_rows(cand, idx, window),
        gather.gather_rows_plain(cand, idx, window))


def test_hash_kernel_matches_plain(lcp_rows):
    rows, _nv, _cand, _m4 = lcp_rows
    h = hm.keys_hashes(rows[:, :8192])
    g = torch.Generator(device=rows.device).manual_seed(5)
    few = (torch.randint(0, 3, h[4:].shape, generator=g, device=rows.device)
           * 8 + torch.randint(0, 3, h[4:].shape, generator=g,
                               device=rows.device))
    h[4:] = few | (torch.randint(0, 2, h[4:].shape, generator=g,
                                 device=rows.device) << hm.B_BITS)
    got = hm.hash_candidates(h)
    assert got.is_cuda
    _eq(got, hm.hash_candidates_plain(h))


def _hash_ids(dev, kind, bsz, n, seed):
    """(B, n) int32 ids of one kind: ``text`` (``keys_hashes`` of the
    zipf text), ``equal`` (every id the same), ``low`` (1-3 buckets with
    equal low bits, so 4-8 positions of a step share them, 2
    fingerprints), ``fp`` (one bucket, ids that differ only in fp),
    ``wild`` (any int32, negative and >= 2^14 fingerprints among them),
    ``edges`` (a bucket written only at the last step of each warp's chunk
    and looked up at the first step of the chunks after the next)."""
    rng = np.random.default_rng(seed)
    if kind == "text":
        plain = gzip.decompress((DATA / "pgzf_sync_zipf_2m.pgz").read_bytes())
        reps = -(-bsz * n // len(plain))
        rows = np.frombuffer((plain * reps)[:bsz * n], np.uint8)
        return hm.keys_hashes(torch.from_numpy(rows.copy()).view(
            bsz, n).to(dev))
    if kind == "equal":
        ids = np.full((bsz, n), 5 | 9 << 12)
    elif kind == "low":
        ids = (rng.integers(0, 3, (bsz, n)) * 8 + 16
               | rng.integers(0, 2, (bsz, n)) << 12)
    elif kind == "fp":
        ids = 77 | rng.integers(0, 3, (bsz, n)) << 12
    elif kind == "wild":
        ids = rng.integers(-2**31, 2**31, (bsz, n))
        ids[:, ::2] = (rng.integers(0, 3, (bsz, (n + 1) // 2))
                       | rng.choice([-2, -1, 0, 1, 1 << 14, 1 << 19],
                                    (bsz, (n + 1) // 2)) << 12)
    else:
        ids = rng.integers(100, 4000, (bsz, n)) | 1 << 12
        chunk = hm.kernel_info(n)["chunk"]
        for c0 in range(0, n, chunk):
            ids[:, min(c0 + chunk, n) - 8:min(c0 + chunk, n)] = 77 | 5 << 12
            if c0 + 2 * chunk < n:
                ids[:, c0 + 2 * chunk] = 77 | 5 << 12
    return torch.from_numpy((ids & 0xFFFFFFFF).astype(np.uint32).view(
        np.int32)).to(dev)


@pytest.mark.parametrize("n", [8, 2048, 65536, 131072])
@pytest.mark.parametrize("kind", ["text", "equal", "low", "fp", "wild",
                                  "edges"])
def test_hash_kernel_id_kinds(dev, kind, n):
    h = _hash_ids(dev, kind, 1, n, n)
    got = hm.hash_candidates(h)
    assert got.is_cuda
    _eq(got, hm.hash_candidates_plain(h))


@pytest.mark.parametrize("kind", ["text", "low"])
def test_hash_kernel_128_members(dev, kind):
    """The hash profile's batch: 128 members of 65,536 positions."""
    h = _hash_ids(dev, kind, 128, 65536, 9)
    _eq(hm.hash_candidates(h), hm.hash_candidates_plain(h))


def test_hash_kernel_info(dev):
    """No spills; one block a member fits an SM; the chunks cover the
    member in whole 32-position rounds."""
    for n in (8, 65536, 131072):
        info = hm.kernel_info(n)
        assert info["spill_bytes"] == 0 and info["blocks_per_sm"] >= 1
        assert info["chunk"] % 32 == 0 and info["chunk"] * info["warps"] >= n
        assert info["dynamic_smem"] >= info["warps"] * 4096 * 4
    with pytest.raises(RuntimeError, match="lf_hash_info"):
        hm.kernel_info(12)


@pytest.mark.parametrize("matcher,knobs", [
    ("sort", {"lcp_rounds": 8}), ("sort", {"chain": 8, "lcp_rounds": 8}),
    ("sort", {"chain": 3, "window": 2048, "lazy": False}),
    ("hash", {}), ("hash", {"chain": 4})])
def test_lengths_stage_on_cuda_matches_cpu(enc_batch, matcher, knobs):
    blocks, nv = enc_batch
    if matcher == "hash":
        cand, m4 = hm.prefix_candidates(blocks,
                                        knobs.get("window", 32768)), None
    else:
        cand, m4 = sm.sort_candidates(blocks, knobs.get("window", 32768))
    got = pipeline.lengths_stage(blocks, nv, cand, m4, **knobs)
    want = pipeline.lengths_stage(
        blocks.cpu(), nv.cpu(), cand.cpu(),
        None if m4 is None else m4.cpu(), **knobs)
    for a, b in zip(got, want):
        _eq(a.cpu(), b)


@pytest.mark.parametrize("name,member,options,matcher", [
    ("pgzf_encode_chain8_small.pgz", 1024,
     {"matcher": "chain", "max_chain": 8, "lcp_rounds": 8}, "sort"),
    ("pgzf_encode_chain8_w2048_8k.pgz", 8192,
     {"matcher": "chain", "max_chain": 8, "lcp_rounds": 8,
      "window_size": 2048}, "sort"),
    ("pgzf_encode_hash_small.pgz", 1024, None, "hash")])
def test_compress_options_on_cuda_match_reference_streams(
        dev, monkeypatch, name, member, options, matcher):
    from libflate_tpu_torch.serial.deflate import EncodeOptions
    monkeypatch.setenv("LIBFLATE_DEVICE_MATCHER", matcher)
    ref = (DATA / name).read_bytes()
    kernels = ((lcp.match_lengths,)
               + ((gather.gather_rows,) if options else ())
               + ((hm.hash_candidates,) if matcher == "hash" else ()))
    before = [k.launches for k in kernels]
    for mod, fn in ((lcp, "match_lengths_plain"),
                    (gather, "gather_rows_plain"),
                    (hm, "hash_candidates_plain")):
        monkeypatch.setattr(mod, fn, lambda *a, **k: (_ for _ in ()).throw(
            AssertionError("a CUDA tensor reached a plain version")))
    opts = EncodeOptions(**options) if options else None
    assert pgzf.compress(gzip.decompress(ref), member_size=member,
                         options=opts, device="cuda") == ref
    assert all(k.launches > b for k, b in zip(kernels, before))


# ---- speculative decode and gather_two -------------------------------------

SPEC_KERNELS = (decode.speculative_decode_positions, decode.chunk_exit_maps,
                deflate_decode.chain_entries, decode.walk_emit)


@pytest.fixture(scope="module")
def spec_group(dev):
    """The 32 members of the 2 MiB fixture with the LS index stripped,
    staged as the speculative path stages them (P = 178176)."""
    data = strip_sync_index((DATA / "pgzf_sync_zipf_2m.pgz").read_bytes())
    (st,) = list(pgzf._spec_groups(data, pgzf.index_members(data), dev))
    return st


def _spec_stages(st, lit_t=None, dist_t=None):
    lit = st["lit_t"] if lit_t is None else lit_t
    dist = st["dist_t"] if dist_t is None else dist_t
    tok, nxt = decode.speculative_decode_positions(st["words"], lit, dist)
    for got, want in zip((tok, nxt), decode.speculative_decode_positions_plain(
            st["words"], lit, dist)):
        _eq(got, want)
    ex = decode.chunk_exit_maps(nxt)
    _eq(ex, decode.chunk_exit_maps_plain(nxt))
    ent = deflate_decode.chain_entries(ex, st["starts"])
    _eq(ent, deflate_decode.chain_entries_plain(ex, st["starts"]))
    emit = decode.walk_emit(nxt, tok, ent)
    _eq(emit, decode.walk_emit_plain(nxt, tok, ent))
    return tok, emit


def test_spec_kernels_match_plain(spec_group):
    tok, emit = _spec_stages(spec_group)
    assert tok.is_cuda and int((emit >= 0).sum()) > 100000


def test_spec_kernels_with_bad_codes_match_plain(spec_group):
    """A litlen table with holes: bad codes, terminals mid-chunk."""
    lit = spec_group["lit_t"].clone()
    lit[(lit >> 4) == ord("e")] = 0
    tok, _emit = _spec_stages(spec_group, lit)
    assert bool(((tok & decode.BAD_FLAG) != 0).any())


def test_spec_kernels_with_bad_distance_codes_match_plain(spec_group):
    """A distance table with holes (a length before one is bad), entries
    whose symbol is past 29 or negative (clamped) and of every width."""
    dist = spec_group["dist_t"].clone()
    dsym = dist >> 4
    dist[dsym == 1] = 0
    dist[dsym == 3] = (31 << 4) | (dist[dsym == 3] & 15)
    dist[dsym == 5] = -(7 << 4) | 9
    dist[dsym == 7] = (dist[dsym == 7] & ~15) | 15
    tok, _emit = _spec_stages(spec_group, dist_t=dist)
    is_len = ((tok & 511) > 2) & (((tok >> 9) & 65535) > 0)
    assert bool(((tok & decode.BAD_FLAG) != 0).any())
    assert bool(is_len.any())


def _spec_tables(dev, kind, seed):
    """(lit_t, dist_t): DEFLATE-shaped entries with holes, or any int32
    (negative symbols, symbols past the alphabets, end-of-block codes,
    zero widths)."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def ints(n, lo, hi):
        return torch.randint(lo, hi, (n,), generator=g, device=dev)

    if kind == "deflate":
        lit = ints(4096, 0, 300) << 4 | ints(4096, 1, 16)
        dist = ints(256, 0, 32) << 4 | ints(256, 1, 16)
    else:
        lit, dist = ints(4096, -2**31, 2**31), ints(256, -2**31, 2**31)
        lit = torch.where(ints(4096, 0, 10) == 0, 256 << 4 | ints(4096, 0, 16),
                          lit)
    lit = torch.where(ints(4096, 0, 5) == 0, 0, lit)
    dist = torch.where(ints(256, 0, 5) == 0, 0, dist)
    return lit.int(), dist.int()


@pytest.mark.parametrize("kind", ["deflate", "any"])
@pytest.mark.parametrize("bsz,n_words", [(1, 20), (3, 36), (130, 148)])
def test_spec_decode_kernel_on_random_words_and_tables(dev, bsz, n_words,
                                                       kind):
    """Random member words under random tables: P of one chunk, 2
    chunks, and 130 members of 9; with more than one member, the first
    row is all zeros and the last all ones."""
    g = torch.Generator(device=dev).manual_seed(n_words)
    words = torch.randint(-2**31, 2**31, (bsz, n_words), generator=g,
                          device=dev).int()
    if bsz > 1:
        words[0] = 0
        words[-1] = -1
    lit, dist = _spec_tables(dev, kind, seed=bsz)
    got = decode.speculative_decode_positions(words, lit, dist)
    want = decode.speculative_decode_positions_plain(words, lit, dist)
    for x, y in zip(got, want):
        _eq(x, y)
    tok, nxt = got
    assert bool(((tok & decode.BAD_FLAG) != 0).any())
    assert bool(((tok & decode.EOB_FLAG) != 0).any()) or kind == "deflate"
    _eq(decode.chunk_exit_maps(nxt), decode.chunk_exit_maps_plain(nxt))


def _exit_orbits(dev, bsz, p_total, seed):
    """nxt with forward jumps of 1-600, backward jumps, fixed points,
    jumps onto the last position of the group and every offset of the
    next group, onto the chunk end and one either side, any int32; in
    member 0, chunk 0 is one orbit (nxt = p + 1, 31 steps a group)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    pos = torch.arange(p_total, device=dev)[None, :].expand(bsz, p_total)

    def ints(lo, hi):
        return torch.randint(lo, hi, (bsz, p_total), generator=g, device=dev)

    choices = torch.stack([
        pos + ints(1, 601), pos - ints(1, 600), pos,
        (pos // 32 + 1) * 32 + ints(-1, 32),
        (pos // 512 + 1) * 512 + ints(-1, 2),
        ints(-2**31, 2**31)])
    kind = torch.multinomial(
        torch.tensor([30., 15, 5, 30, 15, 5], device=dev), bsz * p_total,
        replacement=True, generator=g).view(1, bsz, p_total)
    nxt = torch.gather(choices, 0, kind)[0].int()
    nxt[0, :512] = torch.arange(1, 513, device=dev, dtype=torch.int32)
    return nxt


@pytest.mark.parametrize("bsz,p_total", [(1, 512), (3, 4096), (130, 4096),
                                         (128, 178176)])
def test_spec_chunk_exits_kernel_on_hard_orbits(dev, bsz, p_total):
    nxt = _exit_orbits(dev, bsz, p_total, seed=bsz)
    got = decode.chunk_exit_maps(nxt)
    _eq(got, decode.chunk_exit_maps_plain(nxt))
    assert int(got[0, 0]) == 512
    _eq(decode.chunk_exit_maps(_unaligned(nxt)), got)


def test_spec_chunk_exits_and_walk_on_random_orbits(dev):
    """Jumps of 1-48, fixed points, jumps onto chunk edges, random
    entries (overflowing chunks included)."""
    g = torch.Generator(device=dev).manual_seed(11)
    bsz, p_total = 5, 4096
    pos = torch.arange(p_total, device=dev)[None, :].expand(bsz, p_total)
    nxt = pos + torch.randint(1, 49, (bsz, p_total), generator=g, device=dev)
    nxt = torch.where(torch.rand((bsz, p_total), generator=g, device=dev)
                      < 0.02, pos, nxt)
    edge = (pos // 512 + 1) * 512
    near = (edge - pos <= 48) & (torch.rand((bsz, p_total), generator=g,
                                            device=dev) < 0.3)
    nxt = torch.where(near, edge, nxt).int()
    nxt[0] = torch.clamp(pos[0] + 2, max=p_total).int()      # overflow
    tok = torch.randint(0, 1 << 27, (bsz, p_total), generator=g, device=dev,
                        dtype=torch.int32)
    ex = decode.chunk_exit_maps(nxt)
    _eq(ex, decode.chunk_exit_maps_plain(nxt))
    ent = torch.randint(-5, p_total + 5, (bsz, p_total // 512), generator=g,
                        device=dev, dtype=torch.int32)
    _eq(decode.walk_emit(nxt, tok, ent), decode.walk_emit_plain(nxt, tok,
                                                                ent))
    starts = torch.randint(0, 600, (bsz,), generator=g, device=dev,
                           dtype=torch.int32)
    _eq(deflate_decode.chain_entries(ex, starts),
        deflate_decode.chain_entries_plain(ex, starts))


def _hard_orbits(dev, bsz, p_total, seed):
    """(nxt, tok, entries) with forward jumps of 1-48, backward jumps and
    3-cycles inside a chunk (128-step overflows), fixed points
    (terminals), and in member 0 a chunk whose 128th token is a
    terminal; entries at chunk starts, at -5 and P + 5, in the next
    chunk, and anywhere."""
    g = torch.Generator(device=dev).manual_seed(seed)
    nc = p_total // 512
    pos = torch.arange(p_total, device=dev)[None, :].expand(bsz, p_total)
    base = pos // 512 * 512

    def coin(p):
        return torch.rand((bsz, p_total), generator=g, device=dev) < p

    def jump(lo, hi):
        return torch.randint(lo, hi, (bsz, p_total), generator=g, device=dev)

    nxt = pos + jump(1, 49)
    nxt = torch.where(coin(0.05), torch.maximum(pos - jump(1, 60), base),
                      nxt)
    nxt = torch.where(coin(0.01), pos, nxt)
    nxt = nxt.int()
    for c in range(0, nc, 3):                  # a 3-cycle in every 3rd chunk
        p = c * 512 + 100
        nxt[:, p], nxt[:, p + 1], nxt[:, p + 2] = p + 1, p + 2, p
    last = min(nc - 1, 1)                      # 127 steps, then a terminal
    nxt[0, last * 512:last * 512 + 127] = torch.arange(
        last * 512 + 1, last * 512 + 128, device=dev, dtype=torch.int32)
    nxt[0, last * 512 + 127] = last * 512 + 127
    tok = torch.randint(0, 1 << 27, (bsz, p_total), generator=g, device=dev,
                        dtype=torch.int32)
    cb = torch.arange(nc, device=dev)[None, :].expand(bsz, nc) * 512
    kind = torch.randint(0, 5, (bsz, nc), generator=g, device=dev)
    anywhere = torch.randint(-5, p_total + 5, (bsz, nc), generator=g,
                             device=dev)
    ent = torch.stack([cb, torch.full_like(cb, -5),
                       torch.full_like(cb, p_total + 5),
                       cb + 512 + anywhere % 512, anywhere])
    ent = torch.gather(ent, 0, kind[None])[0].int()
    ent[0, last] = last * 512
    if nc > 2:
        ent[0, 0] = 100                        # on chunk 0's 3-cycle
    return nxt, tok, ent


@pytest.mark.parametrize("bsz,p_total", [(1, 512), (5, 4096),
                                         (128, 178176)])
def test_spec_walk_kernel_on_hard_orbits(dev, bsz, p_total):
    """The walk's stages, partial last stages and the persistent grid's
    strides: P = 512 with one member (one chunk), 8 chunks, and the main
    path's 128 x 348 chunks."""
    nxt, tok, ent = _hard_orbits(dev, bsz, p_total, seed=p_total)
    got = decode.walk_emit(nxt, tok, ent)
    _eq(got, decode.walk_emit_plain(nxt, tok, ent))
    rows = got.view(bsz, -1, decode.EMIT_ROWS)
    last = min(rows.shape[1] - 1, 1)
    assert bool((rows[0, last, :decode.MAX_EMIT] >= 0).all())
    assert int(rows[0, last, decode.MAX_EMIT]) == 0
    if rows.shape[1] > 2:
        assert int(rows[0, 0, decode.MAX_EMIT]) == -1


def test_spec_walk_kernel_unaligned_views(dev):
    """Views that start 4 bytes past a 16-byte boundary are copied to
    aligned memory before the launch."""
    nxt, tok, ent = _hard_orbits(dev, 3, 2048, seed=4)
    _eq(decode.walk_emit(_unaligned(nxt), _unaligned(tok), ent),
        decode.walk_emit_plain(nxt, tok, ent))


def test_spec_decode_kernel_info(dev):
    info = decode.kernel_info("speculative_decode_positions")
    assert info["spill_bytes"] == 0
    assert info["blocks_per_sm"] * info["threads"] == 2048
    assert (info["threads"] * info["positions_per_thread"]
            == info["chunks_per_step"] * 512)
    assert info["static_smem"] >= (4096 + 256) * 4


def test_spec_exits_kernel_info(dev):
    info = decode.kernel_info("chunk_exit_maps")
    assert info["spill_bytes"] == 0 and info["blocks_per_sm"] >= 4
    assert info["threads"] == 32 * info["chunks_per_block"]
    assert info["static_smem"] == info["chunks_per_block"] * 512 * 4


def test_spec_walk_kernel_info(dev):
    info = decode.kernel_info()
    assert info["spill_bytes"] == 0 and info["blocks_per_sm"] >= 4
    assert info["threads"] // 32 == info["chunks_per_stage"]
    assert info["static_smem"] >= info["stages"] * info[
        "chunks_per_stage"] * 512 * 8


@pytest.mark.parametrize("name", ["pgzf_sync_zipf_small.pgz",
                                  "pgzf_sync_zipf_2m.pgz"])
def test_spec_decompress_to_device_on_cuda(dev, name, monkeypatch):
    synced = (DATA / name).read_bytes()
    data = strip_sync_index(synced)
    for mod, fn in ((decode, "speculative_decode_positions_plain"),
                    (decode, "chunk_exit_maps_plain"),
                    (decode, "walk_emit_plain"),
                    (deflate_decode, "chain_entries_plain")):
        monkeypatch.setattr(mod, fn, lambda *a, **k: (_ for _ in ()).throw(
            AssertionError("a CUDA tensor reached a plain version")))
    before = [k.launches for k in SPEC_KERNELS + (sd.sync_decode,)]
    out, lengths = pgzf.decompress_to_device(data, verify=True,
                                             device="cuda")
    after = [k.launches for k in SPEC_KERNELS + (sd.sync_decode,)]
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1, 1, 0]
    sync_out, sync_len = pgzf.decompress_to_device(synced, device="cuda")
    _eq(out, sync_out)
    _eq(lengths, sync_len)
    live = (torch.arange(out.shape[1], device=dev)[None, :]
            < lengths[:, None])
    assert bytes(out[live].cpu().numpy()) == gzip.decompress(synced)


@pytest.mark.parametrize("rows,n", [(64, 64), (512, 512)])
def test_gather_two_kernel_matches_plain(dev, rows, n):
    g = torch.Generator(device=dev).manual_seed(rows)
    bsz, win = 16, 16
    tabs = [torch.randint(-2**31, 2**31 - 1, (bsz, rows, 128), generator=g,
                          device=dev, dtype=torch.int64).int()
            for _ in range(2)]
    lo = (torch.randint(0, (rows - win) // 8 + 1, (bsz, n // 8),
                        generator=g, device=dev) * 8).int()
    idx = ((lo.repeat_interleave(8, dim=1)[:, :, None]
            + torch.randint(-3, win + 3, (bsz, n, 128), generator=g,
                            device=dev)) * 128
           + torch.randint(0, 128, (bsz, n, 128), generator=g,
                           device=dev)).int()
    idx[0, 0, :3] = torch.tensor([-1, rows * 128, 2**31 - 1], device=dev)
    got = gather.gather_two(*tabs, idx, lo, win=win)
    for x, y in zip(got, gather.gather_two_plain(*tabs, idx, lo, win=win)):
        _eq(x, y)


def _gather_two_case(dev, bsz, rows, n, win, seed):
    """Windows at random 8-row starts, and at 0 and R - win; indices one
    to three rows either side of the window, negative ones, ones past the
    table and lo_rows beyond [0, R - win] (the hit test uses lo as given,
    the rows are read from lo clamped)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    tabs = [torch.randint(-2**31, 2**31 - 1, (bsz, rows, 128), generator=g,
                          device=dev, dtype=torch.int64).int()
            for _ in range(2)]
    lo = (torch.randint(0, (rows - win) // 8 + 1, (bsz, n // 8), generator=g,
                        device=dev) * 8).int()
    lo[:, 0], lo[:, -1] = 0, rows - win
    if n >= 32:
        lo[:, 1], lo[:, 2], lo[:, 3] = -8, rows - win + 8, -2**31
    idx = ((lo.to(torch.int64).repeat_interleave(8, dim=1)[:, :, None]
            + torch.randint(-3, win + 3, (bsz, n, 128), generator=g,
                            device=dev)) * 128
           + torch.randint(0, 128, (bsz, n, 128), generator=g, device=dev))
    idx = idx.clamp(-2**31, 2**31 - 1).int()
    idx[0, 0, :4] = torch.tensor([-1, -129, rows * 128, 2**31 - 1],
                                 device=dev)
    return (*tabs, idx, lo)


@pytest.mark.parametrize("rows,n,win", [(8, 8, 8), (64, 64, 8),
                                        (64, 128, 16), (512, 512, 16),
                                        (512, 64, 64), (128, 64, 128),
                                        (512, 32, 512)])
@pytest.mark.parametrize("bsz", [1, 3])
def test_gather_two_kernel_windows_match_plain(dev, bsz, rows, n, win):
    """Windows staged in shared memory (8, 16, 64 rows) and too large to
    stage (win = R: direct loads); R = 8."""
    args = _gather_two_case(dev, bsz, rows, n, win, seed=rows + n + win)
    got = gather.gather_two(*args, win=win)
    for x, y in zip(got, gather.gather_two_plain(*args, win=win)):
        _eq(x, y)
    assert bool((got[0] != 0).any())


@pytest.mark.parametrize("win", [16, 128])
def test_gather_two_kernel_unaligned_views(dev, win):
    """Tables and indices that start 4 bytes past a 16-byte boundary are
    copied to aligned memory before the launch."""
    ta, tb, idx, lo = _gather_two_case(dev, 2, 128, 64, win, seed=win)
    views = [_unaligned(t) for t in (ta, tb, idx)]
    got = gather.gather_two(*views, lo, win=win)
    for x, y in zip(got, gather.gather_two_plain(ta, tb, idx, lo, win=win)):
        _eq(x, y)


def test_gather_two_kernel_info(dev):
    staged = gather.kernel_info("gather_two", 16)
    direct = gather.kernel_info("gather_two", 128)
    assert staged["staged"] == 1 and direct["staged"] == 0
    assert staged["dynamic_smem"] == 2 * 16 * 128 * 4
    assert staged["max_staged_win"] == 64
    for info in (staged, direct):
        assert info["spill_bytes"] == 0 and info["blocks_per_sm"] >= 4


def _decode_args(case, dev):
    """A ``decode_hard_cases`` entry as ``decode_symbols`` arguments on
    ``dev``."""
    from libflate_tpu_torch.ops.huffman import tables_from_lengths
    words, starts, lit, dist, tabs, max_tokens, chunk = case
    if tabs is None:
        lt, dt = tables_from_lengths(torch.from_numpy(lit).to(dev),
                                     torch.from_numpy(dist).to(dev))
        tidx = None
    else:
        lt, dt = (torch.from_numpy(t).to(dev) for t in tabs[:2])
        tidx = torch.from_numpy(tabs[2]).to(dev) if len(tabs) > 2 else None
    return (torch.from_numpy(words).to(dev), torch.from_numpy(starts).to(dev),
            lt, dt, max_tokens, chunk, tidx)


def test_decode_symbols_kernel_matches_plain_on_hard_cases(dev):
    """Table holes, an incomplete code, the fixed code's 286 / 287, an
    empty final block, streams cut at max_tokens (chunked and not),
    start bits off the word, random words under any-int32 tables with a
    table index: all five outputs bit-identical."""
    for name, case in decode_hard_cases().items():
        args = _decode_args(case, dev)
        before = deflate_decode.decode_symbols.launches
        got = deflate_decode.decode_symbols(*args)
        assert deflate_decode.decode_symbols.launches == before + 1
        want = deflate_decode.decode_symbols_plain(*args)
        for g, w in zip(got, want):
            assert g.is_cuda and torch.equal(g, w), name


def test_decode_symbols_kernel_at_member_width(dev):
    """Four 64 KiB members of the generic shard (zlib level 9 bodies)."""
    plain = gzip.decompress((DATA / "pgzf_sync_zipf_2m.pgz").read_bytes())
    shard = generic_shard(plain[:4 * 65536])
    refs = pgzf.index_members(shard)
    bodies = [shard[r.body:r.end - 8] for r in refs]
    from libflate_tpu_torch.ops.huffman import tables_from_lengths
    from libflate_tpu_torch.serial.deflate import parse_block_headers
    lit, dist, starts, flags = parse_block_headers(bodies)
    assert (flags == 5).all()
    words = np.zeros((4, 4 * (65536 // 4 + 512)), np.uint8)
    for i, b in enumerate(bodies):
        words[i, :len(b)] = np.frombuffer(b, np.uint8)
    lt, dt = tables_from_lengths(torch.from_numpy(lit).to(dev),
                                 torch.from_numpy(dist).to(dev))
    args = (torch.from_numpy(words.view("<i4")).to(dev),
            torch.from_numpy(starts.astype(np.int32)).to(dev), lt, dt,
            65538)
    got = deflate_decode.decode_symbols(*args)
    want = deflate_decode.decode_symbols_plain(*args)
    for g, w in zip(got, want):
        _eq(g, w)
    assert not got[4].any()


def _compact_row_words():
    """The words of one row of ``lf_decode_compact_tables``' dump, from
    ``COMPACT``: each kind's root and subtable area, then the two
    non-uniform counts."""
    return sum((1 << r) + (cap << (15 - r))
               for r, cap in deflate_decode.COMPACT.values()) + 2


def test_decode_symbols_kernel_info(dev):
    """A warp a stream, the compact tables (``COMPACT``) on chip, no
    spills, and at least 8 streams an SM: the 1024 generic members fit
    one wave on 132 SMs."""
    info = deflate_decode.kernel_info()
    assert info["spill_bytes"] == 0 and info["threads"] == 32
    assert info["dynamic_smem"] == 0
    assert info["static_smem"] >= 4 * (_compact_row_words() - 2)
    assert info["streams_per_sm"] >= 8
    assert info["regs"] * 32 * info["streams_per_sm"] <= 65536
    assert ((info["static_smem"] + info["dynamic_smem"])
            * info["streams_per_sm"] <= 228 * 1024)


def _compact_dump(lt, dt):
    """The kernel's own build of each (T, 2^15) table pair, as a list of
    T ``{"lit": layout, "dist": layout}`` in ``compact_tables_plain``'s
    form (subtables cut to the slots in use).  The dump refuses a row
    width other than the kernel's, so a geometry apart from ``COMPACT``
    fails here; two guard rows past the T rows must stay as written."""
    from libflate_tpu_torch import _build
    lt, dt = lt.contiguous(), dt.contiguous()
    assert lt.data_ptr() % 16 == 0 and dt.data_ptr() % 16 == 0
    n, w = lt.shape[0], _compact_row_words()
    out = torch.full((n + 2, w), -7, dtype=torch.int32, device=lt.device)
    _build.launch("lf_decode_compact_tables", lt.data_ptr(), dt.data_ptr(),
                  n, w, out.data_ptr())
    out = out.cpu()
    assert (out[n:] == -7).all()
    layouts = []
    for row in out[:n]:
        layout, at = {}, 0
        for kind, (r, cap) in deflate_decode.COMPACT.items():
            root, sub = row[at:at + (1 << r)], row[
                at + (1 << r):at + (1 << r) + (cap << (15 - r))]
            layout[kind] = {"root": root, "sub": sub.view(cap, -1)}
            at += (1 << r) + (cap << (15 - r))
        for k, kind in enumerate(deflate_decode.COMPACT):
            layout[kind]["n"] = int(row[at + k])
            cut = min(layout[kind]["n"], deflate_decode.COMPACT[kind][1])
            layout[kind]["sub"] = layout[kind]["sub"][:cut]
        layouts.append(layout)
    return layouts


def test_decode_compact_tables_dump_refuses_another_row_width(dev):
    from libflate_tpu_torch import _build
    t = torch.zeros((1, 1 << 15), dtype=torch.int32, device=dev)
    out = torch.zeros((1, _compact_row_words() + 1), dtype=torch.int32,
                      device=dev)
    with pytest.raises(RuntimeError):
        _build.launch("lf_decode_compact_tables", t.data_ptr(), t.data_ptr(),
                      1, _compact_row_words() - 1, out.data_ptr())
    assert not out.any()


def _compact_eq(got, want):
    for kind in ("lit", "dist"):
        assert got[kind]["n"] == want[kind]["n"], kind
        for part in ("root", "sub"):
            assert torch.equal(got[kind][part].cpu(),
                               want[kind][part].cpu()), (kind, part)


@pytest.mark.parametrize("source", ["hard cases", "generic members",
                                    "random int32"])
def test_decode_compact_tables_kernel_matches_plain(dev, source):
    """The kernel's own build of the on-chip tables (roots, subtables and
    the non-uniform counts, also past the slots) equals the plain model's
    layout, table by table."""
    from libflate_tpu_torch.ops.huffman import tables_from_lengths
    pairs = []
    if source == "hard cases":
        for case in decode_hard_cases().values():
            _w, _s, lt, dt, _mt, _ch, _ti = _decode_args(case, dev)
            pairs.append((lt, dt))
    elif source == "generic members":
        plain = gzip.decompress((DATA / "pgzf_sync_zipf_2m.pgz").read_bytes())
        shard = generic_shard(plain)
        from libflate_tpu_torch.serial.deflate import parse_block_headers
        lit, dist, _st, _fl = parse_block_headers(
            [shard[r.body:r.end - 8] for r in pgzf.index_members(shard)])
        pairs.append(tables_from_lengths(torch.from_numpy(lit).to(dev),
                                         torch.from_numpy(dist).to(dev)))
    else:
        g = np.random.default_rng(31)
        pairs.append(tuple(torch.from_numpy(g.integers(
            -2**31, 2**31 - 1, (5, 1 << 15), dtype=np.int64).astype(
                np.int32)).to(dev) for _ in range(2)))
    for lt, dt in pairs:
        got = _compact_dump(lt, dt)
        assert len(got) == lt.shape[0]
        for g_, lt_, dt_ in zip(got, lt.cpu(), dt.cpu()):
            _compact_eq(g_, {
                "lit": deflate_decode.compact_tables_plain(lt_, "lit"),
                "dist": deflate_decode.compact_tables_plain(dt_, "dist")})
        if source == "random int32":
            assert all(x[k]["n"] == 1 << r
                       for x in got
                       for k, (r, _cap) in deflate_decode.COMPACT.items())


@pytest.mark.parametrize("table_idx", [False, True])
def test_decode_symbols_kernel_past_the_subtables(dev, table_idx):
    """Every root prefix non-uniform: 8 streams of random words under
    any-int32 tables with no zero width, 4,000 tokens each, so that the
    prefixes in the subtable slots (``COMPACT``) read them on chip and the
    rest the tables in device memory; with a table index, 3 table pairs
    shared by the 8 streams."""
    g = np.random.default_rng(37)
    n_tab = 3 if table_idx else 8
    lt, dt = (torch.from_numpy(g.integers(
        -2**31, 2**31 - 1, (n_tab, 1 << 15), dtype=np.int64).astype(
            np.int32) | 1).to(dev) for _ in range(2))
    words = torch.from_numpy(g.integers(
        -2**31, 2**31 - 1, (8, 3000), dtype=np.int64).astype(
            np.int32)).to(dev)
    starts = torch.from_numpy(g.integers(0, 3000 * 32, 8).astype(
        np.int32)).to(dev)
    tidx = (torch.from_numpy(g.integers(0, n_tab, 8).astype(np.int32))
            .to(dev) if table_idx else None)
    args = (words, starts, lt, dt, 4000, 1024, tidx)
    before = deflate_decode.decode_symbols.launches
    got = deflate_decode.decode_symbols(*args)
    assert deflate_decode.decode_symbols.launches == before + 1
    want = deflate_decode.decode_symbols_plain(*args)
    for g_, w_ in zip(got, want):
        _eq(g_, w_)
    assert (got[2] == 4096).all() and got[4].all()


@pytest.mark.parametrize("table_idx", [False, True])
def test_decode_symbols_kernel_1024_streams(dev, table_idx):
    """1024 streams in one launch (the generic branch's member count):
    the hard cases' zlib bodies, each of the 4 repeated 256 times, with a
    table pair a stream or the 4 pairs named by a table index."""
    words, starts, lt, dt, max_tokens, chunk, _ti = _decode_args(
        decode_hard_cases()["zlib bodies"], dev)
    rep = torch.arange(1024, device=dev) % 4
    if table_idx:
        tidx = rep.to(torch.int32)
    else:
        lt, dt, tidx = lt[rep].contiguous(), dt[rep].contiguous(), None
    args = (words[rep], starts[rep], lt, dt, max_tokens, chunk, tidx)
    before = deflate_decode.decode_symbols.launches
    got = deflate_decode.decode_symbols(*args)
    assert deflate_decode.decode_symbols.launches == before + 1
    want = deflate_decode.decode_symbols_plain(*args)
    for g_, w_ in zip(got, want):
        _eq(g_, w_)
    assert not got[4].any() and (got[2][:4] > 1000).all()


def _guarded(shape, dtype, dev, fill):
    """A zeroed tensor of ``shape`` inside a buffer whose 4 KiB on each
    side hold ``fill``; returns (tensor, buffer, pad elements)."""
    n = int(np.prod(shape))
    pad = 4096 // torch.empty((), dtype=dtype).element_size()
    buf = torch.full((pad + n + pad,), fill, dtype=dtype, device=dev)
    buf[pad:pad + n] = 0
    return buf[pad:pad + n].view(shape), buf, pad


def _decode_guarded(words, starts, lt, dt, max_tokens, chunk, tidx):
    """``lf_decode_symbols`` launched on outputs between guard zones: the
    five outputs, and whether every guard still holds its fill."""
    from libflate_tpu_torch import _build
    dev, bsz = words.device, words.shape[0]
    outs = [_guarded((bsz, max_tokens), torch.int32, dev, 0x5A5A5A5A),
            _guarded((bsz, max_tokens), torch.int32, dev, 0x5A5A5A5A),
            _guarded((bsz,), torch.int32, dev, 0x5A5A5A5A),
            _guarded((bsz,), torch.int32, dev, 0x5A5A5A5A),
            _guarded((bsz,), torch.uint8, dev, 0x5A)]
    w, sb, lt, dt = (x.contiguous() for x in (words, starts, lt, dt))
    assert lt.data_ptr() % 16 == 0 and dt.data_ptr() % 16 == 0
    _build.launch("lf_decode_symbols", w.data_ptr(), w.shape[1],
                  sb.data_ptr(), lt.data_ptr(), dt.data_ptr(),
                  0 if tidx is None else tidx.contiguous().data_ptr(), bsz,
                  max_tokens, deflate_decode._decode_steps(max_tokens, chunk),
                  *(o[0].data_ptr() for o in outs))
    torch.cuda.synchronize()
    held = all(bool((buf[:pad] == buf[0]).all()
                    and (buf[-pad:] == buf[0]).all())
               for _o, buf, pad in outs)
    res = [o[0] for o in outs]
    res[4] = res[4].bool()
    return res, held


@pytest.mark.parametrize("case", ["hard cases", "1024 streams"])
def test_decode_symbols_kernel_writes_only_its_outputs(dev, case):
    """Every output between 4 KiB guard zones: after the launch the
    zones hold what they held and the outputs equal the plain version's.
    On each hard case (streams cut at max_tokens, run to the step budget,
    past the subtable slots, with a table index), and on 1024 streams in
    one launch: the zlib bodies cut at 300 tokens, and random words under
    any-int32 tables with a table index, which stop at any step."""
    if case == "hard cases":
        runs = [_decode_args(c, dev) for c in decode_hard_cases().values()]
    else:
        words, starts, lt, dt, _mt, chunk, _ti = _decode_args(
            decode_hard_cases()["zlib bodies"], dev)
        rep = torch.arange(1024, device=dev) % 4
        g = np.random.default_rng(41)
        rnd = torch.from_numpy(g.integers(
            -2**31, 2**31 - 1, (1024, 64), dtype=np.int64).astype(
                np.int32)).to(dev)
        tabs = [torch.from_numpy(g.integers(
            -2**31, 2**31 - 1, (7, 1 << 15), dtype=np.int64).astype(
                np.int32)).to(dev) for _ in range(2)]
        runs = [(words[rep], starts[rep], lt, dt, 300, chunk,
                 rep.to(torch.int32)),
                (rnd, torch.from_numpy(g.integers(0, 64 * 32, 1024).astype(
                    np.int32)).to(dev), tabs[0], tabs[1], 40, 16,
                 torch.from_numpy(g.integers(0, 7, 1024).astype(
                     np.int32)).to(dev))]
    for args in runs:
        got, held = _decode_guarded(*args)
        assert held
        want = deflate_decode.decode_symbols_plain(*args)
        for g_, w_ in zip(got, want):
            _eq(g_, w_)


def test_rank_kernel_repeated_launches_agree(group):
    """The rank kernel gives the same (src, lit) launch after launch on
    the same inputs, 64 times, between launches of the generic decode
    (which leaves its tables in the SMs' shared memory), each equal to
    the plain version's."""
    toks = sd.sync_decode(*_sd_args(group))
    cap = group["member_cap"]
    args = device_expand.rank_inputs(toks.view(group["bsz"], -1),
                                     group["n_tokens"], cap)[:4] + (cap,)
    src_p, lit_p = rank.rank_emit_src_plain(*args)
    dec = _decode_args(decode_hard_cases()["zlib bodies"], toks.device)
    for i in range(64):
        if i % 8 == 0:
            deflate_decode.decode_symbols(*dec)
        src, lit = rank.rank_emit_src(*args)
        assert torch.equal(src, src_p) and torch.equal(lit, lit_p), i


def test_sync_decode_debug_kernel_matches_plain(group):
    """The debug form: its plain version's tokens and marks, and the
    default kernel's tokens under the marks; at the staged depth no token
    of the clean fixture is marked, at 32 words some are."""
    base = _sd_args(group)
    plain_default = sd.sync_decode(*base, debug=False)
    for d_words, marked in ((group["d_words"], False), (32, True)):
        before = (sd.sync_decode.launches, sd.sync_decode.debug_launches)
        got = sd.sync_decode(*base, debug=True, d_words=d_words)
        assert (sd.sync_decode.launches,
                sd.sync_decode.debug_launches) == (before[0], before[1] + 1)
        _eq(got, sd.sync_decode_plain(*base, debug=True, d_words=d_words))
        _eq(got & ~sd.DEBUG_POISON, plain_default)
        assert bool(((got & sd.DEBUG_POISON) != 0).any()) == marked


def test_sync_decode_debug_flag_on_a_poisoned_index(dev, monkeypatch):
    """K raised to 1024 in the first member's LS index: the debug form
    marks tokens as its plain version does, and decompress raises
    DeflateError with LIBFLATE_DEBUG_CHECKS=1; the clean stream decodes
    with it set."""
    from libflate_tpu_torch.serial.deflate import DeflateError
    small = (DATA / "pgzf_sync_zipf_small.pgz").read_bytes()
    bad = poison_ls(small)
    g = pgzf._prepare_sync_device(bad, dev)[0]
    args = _sd_args(g)
    got = sd.sync_decode(*args, debug=True, d_words=g["d_words"])
    _eq(got, sd.sync_decode_plain(*args, debug=True, d_words=g["d_words"]))
    assert ((got & sd.DEBUG_POISON) != 0).any()
    monkeypatch.setenv("LIBFLATE_DEBUG_CHECKS", "1")
    assert pgzf.decompress(small, device="cuda") == gzip.decompress(small)
    with pytest.raises(DeflateError, match="invariant"):
        pgzf.decompress(bad, device="cuda")


def _decompress_streams():
    small = (DATA / "pgzf_sync_zipf_small.pgz").read_bytes()
    enc = (DATA / "pgzf_encode_small.pgz").read_bytes()
    plain = gzip.decompress(enc)
    return {"sync": small, "shared": strip_sync_index(small),
            "generic": generic_shard(plain[:40000], 8192),
            "foreign": gzip.compress(plain[:30000]) + gzip.compress(b"x"),
            "sync with stored members": enc}


@pytest.mark.parametrize("name", ["sync", "shared", "generic", "foreign",
                                  "sync with stored members"])
def test_decompress_on_cuda_each_branch(dev, name):
    data = _decompress_streams()[name]
    before = deflate_decode.decode_symbols.launches
    out = pgzf.decompress(data, verify=True, device="cuda")
    assert out == gzip.decompress(data)
    assert out == pgzf.decompress(data, verify=True, device="cpu")
    assert (deflate_decode.decode_symbols.launches > before) == (
        name == "generic")


def test_decompress_on_cuda_generic_branch_forced(dev, monkeypatch):
    monkeypatch.setenv("LIBFLATE_NO_SYNC", "1")
    monkeypatch.setenv("LIBFLATE_NO_SPEC", "1")
    data = (DATA / "pgzf_sync_zipf_small.pgz").read_bytes()
    before = deflate_decode.decode_symbols.launches
    assert pgzf.decompress(data, device="cuda") == gzip.decompress(data)
    assert deflate_decode.decode_symbols.launches == before + 1


def test_inflate_device_on_cuda(dev):
    import zlib
    plain = gzip.decompress((DATA / "pgzf_encode_small.pgz").read_bytes())
    c = zlib.compressobj(6, zlib.DEFLATED, -15, 1)
    multi = c.compress(plain[:60000]) + c.flush()
    c = zlib.compressobj(6, zlib.DEFLATED, -15)
    # a dynamic block, then a final stored block at the byte boundary
    stored = (c.compress(plain[:5000]) + c.flush(zlib.Z_FULL_FLUSH)
              + b"\x01" + struct.pack("<HH", 4000, 4000 ^ 0xFFFF)
              + plain[5000:9000])
    for raw, want in ((multi, plain[:60000]), (stored, plain[:9000])):
        res = deflate_decode.inflate_device(raw, device="cuda")
        assert bytes(res.data) == want
        assert res.end_bit == deflate_decode.inflate_device(
            raw, device="cpu").end_bit


# ---------------------------------------------------------------------------
# the generic device engine: the "cuda" engine against the committed
# reference streams and the "cpu" engine, with its kernels counted
# ---------------------------------------------------------------------------
def _generic_counts():
    ks = (hm.hash_candidates, fields.token_fields, parse.chunk_exits,
          parse.walk_emit, deflate_decode.decode_symbols)
    return {chip_smoke.kname(k): k.launches for k in ks}


@pytest.mark.parametrize("name", list(chip_smoke.DEFLATE_FIXTURES))
def test_generic_engine_matches_committed_streams(dev, name, monkeypatch):
    kind, opts, size = chip_smoke.DEFLATE_FIXTURES[name]
    want = (DATA / name).read_bytes()
    plain = chip_smoke.fixture_plain(kind, want)
    before = _generic_counts()
    got = chip_smoke.deflate_fixture_stream(kind, opts, size, plain, "cuda")
    after = _generic_counts()
    assert got == want
    literal = opts.get("matcher") == "none"
    assert (after["hash_match.hash_candidates"]
            > before["hash_match.hash_candidates"]) == (
        size == 1024 and not literal)
    # every block's fields, fixed or dynamic, literal or not
    assert after["fields.token_fields"] > before["fields.token_fields"]
    assert (after["parse.walk_emit"] > before["parse.walk_emit"]) == \
        (not literal)
    # the cpu engine with the kernel branches on writes the same stream
    monkeypatch.setattr(pipeline, "use_kernel_branches", lambda d: True)
    monkeypatch.setattr(pgzf, "use_kernel_branches", lambda d: True)
    assert chip_smoke.deflate_fixture_stream(kind, opts, size, plain,
                                             "cpu") == want
    monkeypatch.undo()
    before = _generic_counts()
    assert chip_smoke.deflate_fixture_decode(kind, got, "cuda") == plain
    assert _generic_counts()["deflate_decode.decode_symbols"] > \
        before["deflate_decode.decode_symbols"]


@pytest.mark.parametrize("kw", [{}, {"block_type": "fixed"},
                                {"block_type": "auto"},
                                {"matcher": "none"}])
def test_generic_engine_sort_branch_equals_cpu_engine(dev, kw):
    from libflate_tpu_torch.formats import deflate as fdeflate
    from libflate_tpu_torch.serial.deflate import EncodeOptions
    plain = gzip.decompress((DATA / "pgzf_encode_small.pgz").read_bytes())
    opts = EncodeOptions(block_size=8192, **kw)
    got = fdeflate.compress(plain, opts, engine="cuda")
    assert got == fdeflate.compress(plain, opts, engine="cpu")
    assert zlib.decompress(got, -15) == plain


def test_generic_engine_checksums_on_cuda(dev):
    from libflate_tpu_torch import backend
    eng = backend.get("cuda")
    assert backend.get(None) is eng
    blob = np.random.default_rng(5).integers(0, 256, 1 << 20,
                                             np.uint8).tobytes()
    assert eng.crc32(blob) == zlib.crc32(blob)
    assert eng.adler32(blob) == zlib.adler32(blob)
    assert eng.crc32(blob[7:], zlib.crc32(blob[:7])) == zlib.crc32(blob)
    assert eng.adler32(blob[7:], zlib.adler32(blob[:7])) == \
        zlib.adler32(blob)


def test_decompress_repaired_faults_on_cuda(dev):
    big = np.random.default_rng(6).integers(0, 256, 2 << 20,
                                            np.uint8).tobytes()
    stream = gzip.compress(b"small", mtime=0) + gzip.compress(
        big, compresslevel=0, mtime=0)
    assert pgzf.decompress(stream, device="cuda") == b"small" + big
    with pytest.raises(EOFError):
        pgzf.decompress(gzip.compress(bytes(range(256)) * 300)[:12],
                        device="cuda")


@pytest.mark.parametrize("name,member,matcher", [
    ("65024_hash", 65024, "hash"), ("131072_hash", 131072, "hash"),
    ("1536_hash", 1536, "hash")])
def test_odd_member_size_end_to_end(dev, name, member, matcher,
                                    monkeypatch):
    """pgzf at member sizes that are not a multiple of 1024, byte-identical
    to the reference streams; read back by ``decompress`` on the card,
    the encode's kernels launched."""
    monkeypatch.setenv("LIBFLATE_DEVICE_MATCHER", matcher)
    ref = (DATA / f"pgzf_encode_odd_{name}.pgz").read_bytes()
    plain = gzip.decompress(ref)
    hist.token_hist.launches = fields.token_fields.launches = 0
    assert pgzf.compress(plain, member_size=member, device="cuda") == ref
    assert hist.token_hist.launches >= 1 and fields.token_fields.launches >= 1
    assert pgzf.decompress(ref, device="cuda") == plain


def test_native_library_builds_on_the_card_host(dev):
    from libflate_tpu_torch import native
    native.load()
    assert native.library_path().exists()
    assert native.crc32(b"123456789") == 0xCBF43926


@pytest.mark.parametrize("name", list(chip_smoke.NATIVE_FIXTURES))
def test_native_streams_equal_committed_fixtures(dev, name):
    """The native engine on the card's host writes the committed
    reference streams (``scripts/make_native_fixture.py``) at one thread
    and at one a core."""
    from libflate_tpu_torch import native
    want = (DATA / name).read_bytes()
    member = chip_smoke.NATIVE_FIXTURES[name]
    if member is None:
        assert native.deflate_greedy(zlib.decompress(want, -15),
                                     **chip_smoke.NATIVE_GREEDY_KW) == want
        return
    plain = gzip.decompress(want)
    for n_threads in (0, 1):
        assert pgzf.compress(plain, member, engine="native",
                             n_threads=n_threads) == want
    assert pgzf.decompress(want, engine="native") == plain


def test_native_decodes_the_device_stream(dev):
    """A stream the card wrote (LF and LS indices, shared tables) decodes
    on the native engine through the C index walk, and member by member
    through ``native.inflate``."""
    plain = gzip.decompress((DATA / "pgzf_sync_zipf_small.pgz").read_bytes())
    stream = pgzf.compress(plain, member_size=4096, device="cuda")
    assert pgzf.decompress(stream, engine="native") == plain
    assert chip_smoke.native_members(stream) == plain


@pytest.fixture(scope="module")
def shard_batch(dev):
    """128 members of 4096 bytes of the small sync fixture's plaintext,
    the last three cut short."""
    plain = gzip.decompress((DATA / "pgzf_sync_zipf_small.pgz").read_bytes())
    n = 4096
    plain = plain * -(-128 * n // len(plain))
    blocks = np.frombuffer(plain[:128 * n], np.uint8).reshape(128, n).copy()
    nv = np.full((128,), n, np.int32)
    nv[-3:] = [0, 17, 3000]
    for i in range(128):
        blocks[i, nv[i]:] = 0
    return blocks, nv


@pytest.mark.parametrize("n_shards", [1, 4])
def test_sharded_encodes_equal_unsharded_calls_on_a_logical_mesh(
        dev, shard_batch, n_shards):
    """On ``[cuda:0] * 4`` (four logical shards on one card) and on the
    one-card mesh, the block encode takes the hash candidates on every
    shard and equals the unsharded hash-branch encode; the shared-table
    sync encode (the histogram summed across shards) equals
    ``encode_batch`` on the whole batch; both decode back on the card."""
    from libflate_tpu_torch.parallel import sharding
    from libflate_tpu_torch.parallel.mesh import make_mesh
    blocks, nv = shard_batch
    mesh = make_mesh(n_shards, devices=[dev] * n_shards)
    bf = np.ones((128,), np.int32)
    blocks_d = torch.from_numpy(blocks).to(dev)
    nv_d = torch.from_numpy(nv).to(dev)
    hm.hash_candidates.launches = 0
    words, bits = sharding.encode_blocks_sharded(blocks, nv, bf, mesh)
    assert hm.hash_candidates.launches == n_shards
    w_ref, b_ref = pipeline.encode_batch_generic(blocks_d, nv_d, bf,
                                                 "dynamic", True)
    assert np.array_equal(words, w_ref.cpu().numpy().view(np.uint32))
    assert np.array_equal(bits, b_ref.cpu().numpy())
    want = pipeline.encode_batch(blocks_d, nv_d, 256)
    hist.token_hist.launches = 0
    got = sharding.encode_sync_sharded(blocks, nv, bf, 256, mesh)
    assert hist.token_hist.launches == n_shards
    for g, key in zip(got, ("words", "bits", "n_tokens", "offsets")):
        assert np.array_equal(g, want[key].cpu().numpy().astype(g.dtype))
    # the block encode's members decode back through the sharded decode
    from libflate_tpu_torch import graft_entry
    lit, dist, starts, rows, _ = graft_entry._member_words(words, bits)
    deflate_decode.decode_symbols.launches = 0
    out, n_out, err = sharding.decode_members_sharded(rows, starts, lit,
                                                      dist, 4096, mesh)
    assert deflate_decode.decode_symbols.launches == n_shards
    assert not err.any() and np.array_equal(n_out, nv)
    # bytes past a member's n_out are the expansion's, not zeros
    live = np.arange(4096)[None, :] < nv[:, None]
    assert np.array_equal(out[live], blocks[live])


def test_dryrun_multichip_on_a_logical_mesh(dev):
    from libflate_tpu_torch import graft_entry
    for k in (sd.sync_decode, rank.rank_emit_src, expand.resolve_bytes,
              deflate_decode.decode_symbols):
        k.launches = 0
    graft_entry.dryrun_multichip(4, devices=[dev] * 4)
    assert sd.sync_decode.launches >= 4
    assert rank.rank_emit_src.launches == 4
    assert expand.resolve_bytes.launches == 4
    assert deflate_decode.decode_symbols.launches == 4


# --- csrc/checksum.cu: CRC-32 f-values and Adler-32 ---------------------
def _bytes_on(dev, shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, shape, dtype=np.uint8)).to(dev)


@pytest.mark.parametrize("bsz", [1, 3])
@pytest.mark.parametrize("n", [1, 3, 63, 64, 65, 1000, 4096, 65536,
                               (1 << 20) + 1])
def test_crc32_f_rows_kernel_matches_plain(dev, n, bsz):
    """Bit-identical at every shape: rows of 3 or 1000 bytes start off
    the 16-byte grid, 1 MiB + 1 takes 17 tiles and the fold pass."""
    rows = _bytes_on(dev, (bsz, n), n + bsz)
    before = checksum.crc32_f_rows.launches
    got = checksum.crc32_f_rows(rows)
    assert checksum.crc32_f_rows.launches == before + 1
    _eq(got, checksum.crc32_f_rows_plain(rows))
    lens = [n] * bsz
    np.testing.assert_array_equal(
        checksum.crc32_from_padded_f(got.cpu().numpy(), lens, n),
        [zlib.crc32(r.tobytes()) for r in rows.cpu().numpy()])


def test_crc32_f_rows_kernel_long_row_and_edges(dev):
    """One (1, 64 MiB + 3) row (1025 tiles, 4 a thread in the fold), B =
    0, N = 0, a non-contiguous slice, a row from an odd address."""
    big = _bytes_on(dev, (1, (64 << 20) + 3), 7)
    got = checksum.crc32_f_rows(big)
    _eq(got, checksum.crc32_f_rows_plain(big))
    assert checksum.crc32_device(big[0]) == zlib.crc32(
        big.cpu().numpy().tobytes())
    for empty in (torch.empty((0, 100), dtype=torch.uint8, device=dev),
                  torch.empty((3, 0), dtype=torch.uint8, device=dev)):
        before = checksum.crc32_f_rows.launches
        _eq(checksum.crc32_f_rows(empty),
            torch.zeros(empty.shape[0], dtype=torch.int32, device=dev))
        assert checksum.crc32_f_rows.launches == before
    wide = _bytes_on(dev, (3, 3000), 8)
    for view in (wide[:, 5:1005], wide.t()[:1000].t(), wide[1:, 1:]):
        assert not view.is_contiguous()
        _eq(checksum.crc32_f_rows(view), checksum.crc32_f_rows_plain(view))
    flat = _bytes_on(dev, (200001,), 9)
    for off in (1, 3, 15):
        assert flat[off:].data_ptr() % 16 == off
        assert checksum.crc32_device(flat[off:]) == zlib.crc32(
            flat[off:].cpu().numpy().tobytes())


def test_crc32_f_rows_kernel_repeated_launches_agree(dev):
    rows = _bytes_on(dev, (128, 65536), 10)
    want = checksum.crc32_f_rows_plain(rows)
    outs = [checksum.crc32_f_rows(rows) for _ in range(48)]
    torch.cuda.synchronize()
    for got in outs:
        _eq(got, want)


@pytest.mark.parametrize("bsz,n", [(3, 65536), (3, 200000), (2, 1000)])
def test_checksum_kernels_write_only_their_outputs(dev, bsz, n):
    """The CRC's out and tile scratch and the Adler's partial sums and
    word between 4 KiB guard zones: the zones hold, the outputs are
    the plain versions'."""
    from libflate_tpu_torch import _build
    rows = _bytes_on(dev, (bsz, n), n)
    tiles = checksum.crc_tiles(n)
    out, obuf, opad = _guarded((bsz,), torch.int32, dev, 0x5A5A5A5A)
    scr, sbuf, spad = _guarded((bsz * tiles,), torch.int32, dev,
                               0x5A5A5A5A)
    _build.launch("lf_crc32_rows", rows.data_ptr(), bsz, n, tiles,
                  checksum._constants_on(rows.device).data_ptr(),
                  scr.data_ptr(), out.data_ptr())
    part, pbuf, ppad = _guarded((2 * 3,), torch.int32, dev, 0x5A5A5A5A)
    word, wbuf, wpad = _guarded((1,), torch.int32, dev, 0x5A5A5A5A)
    flat = rows.view(-1)[1:]
    _build.launch("lf_adler32", flat.data_ptr(), flat.numel(), 3,
                  part.data_ptr(), word.data_ptr())
    torch.cuda.synchronize()
    for buf, pad in ((obuf, opad), (sbuf, spad), (pbuf, ppad),
                     (wbuf, wpad)):
        assert bool((buf[:pad] == 0x5A5A5A5A).all()
                    and (buf[-pad:] == 0x5A5A5A5A).all())
    _eq(out, checksum.crc32_f_rows_plain(rows))
    assert int(word.item()) & 0xFFFFFFFF == zlib.adler32(
        flat.cpu().numpy().tobytes())


@pytest.mark.parametrize("n", [0, 1, 1023, 1024, 1025, 5552, (3 << 20) + 5,
                               64 << 20])
def test_adler32_device_kernel_matches_zlib(dev, n):
    data = _bytes_on(dev, (n + 7,), n)
    for off in (0, 7):
        view = data[off:off + n]
        want = zlib.adler32(view.cpu().numpy().tobytes())
        before = checksum.adler32_device.launches
        assert checksum.adler32_device(view) == want
        assert checksum.adler32_device.launches == before + (n > 0)
        if n <= 1 << 20:
            assert checksum.adler32_device_plain(view) == want


def test_checksum_kernel_info(dev):
    for k in ("crc_tiles", "crc_fold", "adler_partial", "adler_fold"):
        info = checksum.kernel_info(k)
        assert info["spill_bytes"] == 0 and info["threads"] == 256
        assert info["blocks_per_sm"] >= 1
    assert checksum.kernel_info("crc_tiles")["static_smem"] <= 48 * 1024
    assert checksum.kernel_info()["tile_bytes"] == checksum.CRC_TILE
    assert checksum.kernel_info()["levels"] == checksum.LEVELS
