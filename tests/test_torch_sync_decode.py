"""Port vs reference: sync-indexed symbol decode.

The reference kernel (``pallas_sync_decode.sync_decode``) runs once per
module in Pallas interpret mode on the small fixture; the port's plain
version must give identical tokens, both from the reference's own staged
state (carried over with ``convert.from_reference_group``) and from the
port's own staging (the stream as words + absolute start bits).
"""
import pathlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from libflate_tpu_torch import convert  # noqa: E402
from libflate_tpu_torch.formats import pgzf as port_pgzf  # noqa: E402
from libflate_tpu_torch.ops import sync_decode as sd  # noqa: E402

SMALL = (pathlib.Path(__file__).parent / "data"
         / "pgzf_sync_zipf_small.pgz")


@pytest.fixture(scope="module")
def interpret():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LIBFLATE_PALLAS_INTERPRET", "1")
        yield


def _ref_tokens(prep, lit_t):
    from libflate_tpu.ops import pallas_sync_decode as psd
    out = psd.sync_decode(prep["staged"], prep["sb"], prep["counts"],
                          jax.numpy.asarray(lit_t), prep["dist_t"],
                          prep["k_tok"], root_bits=prep["root_bits"])
    return psd.gather_tokens(np.asarray(out), prep["bsz"] * prep["max_nc"],
                             prep["k_tok"])


@pytest.fixture(scope="module")
def ref(interpret):
    """(reference group, its tokens (S, K), tokens with a damaged table)."""
    from libflate_tpu.formats import pgzf as ref_pgzf
    (prep,) = ref_pgzf._prepare_sync_device(SMALL.read_bytes())
    lit_t = np.asarray(prep["lit_t"])
    # invalid entries (width 0) wherever the most common literal sits:
    # slots stall on it, exactly as the reference kernel does
    bad = lit_t.copy()
    bad[(bad >> 4) == ord("\n")] = 0
    return prep, _ref_tokens(prep, lit_t), bad, _ref_tokens(prep, bad)


def _port_decode(g, lit_t=None, root_bits=None):
    return sd.sync_decode(g["words"], g["start_bits"], g["counts"],
                          g["lit_t"] if lit_t is None else lit_t,
                          g["dist_t"], g["k_tok"],
                          root_bits or g["root_bits"]).numpy()


def test_plain_matches_reference_on_reference_staging(ref):
    prep, want, _bad, _ = ref
    g = convert.from_reference_group(prep)
    got = _port_decode(g)
    assert got.shape == want.shape == (prep["bsz"] * prep["max_nc"],
                                       sd.SYNC_TOKENS)
    assert (got != 0).any()
    np.testing.assert_array_equal(got, want)


def test_plain_matches_reference_on_port_staging(ref):
    prep, want, _bad, _ = ref
    (g,) = port_pgzf._prepare_sync_device(SMALL.read_bytes(), "cpu")
    assert (g["bsz"], g["max_nc"]) == (prep["bsz"], prep["max_nc"])
    np.testing.assert_array_equal(_port_decode(g), want)


def test_invalid_table_entries_match_reference(ref):
    prep, want, bad, want_bad = ref
    g = convert.from_reference_group(prep)
    got = _port_decode(g, lit_t=torch.from_numpy(bad))
    assert not np.array_equal(want_bad, want)
    np.testing.assert_array_equal(got, want_bad)


def test_widest_root_gives_same_tokens(ref):
    """A 12-bit root over the same <=10-bit codes decodes identically."""
    prep, want, _bad, _ = ref
    g = convert.from_reference_group(prep)
    reps = 1 << (12 - prep["root_bits"])
    wide = g["lit_t"].repeat(reps)
    np.testing.assert_array_equal(_port_decode(g, wide, 12), want)


def test_counts_bound_each_slot(ref):
    prep, want, _bad, _ = ref
    g = convert.from_reference_group(prep)
    cnt = g["counts"] // 2
    got = sd.sync_decode(g["words"], g["start_bits"], cnt, g["lit_t"],
                         g["dist_t"], g["k_tok"], g["root_bits"]).numpy()
    keep = np.arange(sd.SYNC_TOKENS)[None, :] < cnt.numpy()[:, None]
    np.testing.assert_array_equal(got, np.where(keep, want, 0))


def test_stream_words_bit_order():
    w = sd.stream_words(b"\x01\x02\x03\x04\x05", "cpu")
    assert w.dtype == torch.int32
    assert w.tolist() == [0x04030201, 0x05]


def test_wrapper_rejects_bad_arguments():
    w = torch.zeros(4, dtype=torch.int32)
    sb = torch.zeros(2, dtype=torch.int64)
    cnt = torch.zeros(2, dtype=torch.int32)
    lit = torch.zeros(1 << 10, dtype=torch.int32)
    dist = torch.zeros(256, dtype=torch.int32)
    with pytest.raises(ValueError):
        sd.sync_decode(w, sb.to(torch.int32), cnt, lit, dist)
    with pytest.raises(ValueError):
        sd.sync_decode(w, sb, cnt, lit, dist, root_bits=13)
    with pytest.raises(ValueError):
        sd.sync_decode(w.to("meta"), sb, cnt, lit, dist)


def _merged_decode(words, start_bits, counts, lit_table, dist_table,
                   k_tokens, root_bits):
    """The kernel's step in torch: two lookups in :func:`kernel_tables`'
    merged words, the extra bits from the low window word and from the
    32 bits at the distance code, as ``csrc/sync_decode.cu`` takes them."""
    lit_m, dist_m = (t.to(torch.int64)
                     for t in sd.kernel_tables(lit_table, dist_table))
    bytes_ = words.view(torch.uint8)
    cursor = start_bits.clone()
    cnt = counts.to(torch.int64)
    out = torch.zeros((cursor.numel(), k_tokens), dtype=torch.int32)
    for i in range(k_tokens):
        win = sd._window(bytes_, cursor)
        lo = win & 0xFFFFFFFF
        e = lit_m[lo & ((1 << root_bits) - 1)]
        width, nx = e & 15, (e >> 4) & 7
        a = ((e >> 7) & 511) + ((lo >> width) & ((1 << nx) - 1))
        k2 = width + nx
        d = (win >> k2) & 0xFFFFFFFF
        de = dist_m[d & 255]
        dw, dnx = de & 15, (de >> 4) & 15
        b = (de >> 8) + ((d >> dw) & ((1 << dnx) - 1))
        is_len = (e >> 16) != 0
        tok = a | torch.where(is_len, b, 0) << 9
        active = i < cnt
        out[:, i] = torch.where(active, tok, 0).to(torch.int32)
        cursor += torch.where(active, torch.where(is_len, k2 + dw + dnx,
                                                  width), 0)
    return out


def _random_tables(seed: int, root_bits: int):
    """Seeded litlen / distance roots: valid-looking entries, invalid ones
    (width 0), symbols 286 / 287 and above, negative words."""
    rng = np.random.default_rng(seed)
    n = 1 << root_bits
    sym = rng.integers(0, 288, n)
    sym[rng.random(n) < 0.1] = rng.choice([286, 287, 300, 4000], 1)[0]
    lit = (sym << 4 | rng.integers(1, 16, n)).astype(np.int64)
    lit[rng.random(n) < 0.05] = 0
    lit[rng.random(n) < 0.02] = rng.integers(-2**31, 0)
    dist = (rng.integers(0, 32, 256) << 4 | rng.integers(0, 16, 256))
    dist[:3] = [0, -17, 29 << 4]
    return (torch.from_numpy(lit.astype(np.int32)),
            torch.from_numpy(dist.astype(np.int32)))


@pytest.mark.parametrize("case", ["fixture", "invalid", "root12", "random"])
def test_merged_tables_decode_as_plain(ref, case):
    """Decoding through the kernel's merged tables gives exactly
    sync_decode_plain's tokens (held against the reference above)."""
    prep, want, bad, _ = ref
    g = convert.from_reference_group(prep)
    lit, dist, rb = g["lit_t"], g["dist_t"], g["root_bits"]
    if case == "invalid":
        lit = torch.from_numpy(bad)
    elif case == "root12":
        lit, rb = lit.repeat(1 << (12 - rb)), 12
    elif case == "random":
        lit, dist = _random_tables(7, rb)
    args = (g["words"], g["start_bits"], g["counts"], lit, dist,
            g["k_tok"], rb)
    plain = sd.sync_decode_plain(*args).numpy()
    if case in ("fixture", "root12"):
        np.testing.assert_array_equal(plain, want)
    np.testing.assert_array_equal(_merged_decode(*args).numpy(), plain)


def test_kernel_tables_fields():
    lit = torch.tensor([0, 65 << 4 | 8, 256 << 4 | 7, 257 << 4 | 7,
                        285 << 4 | 8, 286 << 4 | 9, 287 << 4 | 9, -1],
                       dtype=torch.int32)
    dist = torch.tensor([0, 4 << 4 | 5, 29 << 4 | 5, 31 << 4 | 5, -17],
                        dtype=torch.int32)
    lit_m, dist_m = sd.kernel_tables(lit, dist)
    # (width, extra count, base, is-length) of each merged litlen word
    got = [(int(e) & 15, int(e) >> 4 & 7, int(e) >> 7 & 511, int(e) >> 16)
           for e in lit_m]
    assert got == [(0, 0, 0, 0), (8, 0, 65, 0), (7, 0, 256, 0),
                   (7, 0, 3, 1), (8, 0, 258, 1), (9, 0, 258, 1),
                   (9, 0, 258, 1), (15, 0, 0, 0)]
    got = [(int(e) & 15, int(e) >> 4 & 15, int(e) >> 8) for e in dist_m]
    assert got == [(0, 0, 1), (5, 1, 5), (5, 13, 24577), (5, 13, 24577),
                   (15, 0, 1)]
