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
