"""The encode options on the port (every kernel's plain version) vs the
reference.

``lengths_stage`` against the reference's ``_lengths_stage`` on its
kernel branch (``use_kernel=True``, Pallas interpret mode) in each
configuration the options reach, fed identical candidates; ``compress``
with options against the committed reference streams
``pgzf_encode_chain8_small.pgz`` (the quality mode:
``EncodeOptions(matcher="chain", max_chain=8, lcp_rounds=8)``) and
``pgzf_encode_hash_small.pgz`` (``LIBFLATE_DEVICE_MATCHER=hash``), both
written by ``scripts/make_pgzf_encode_fixture.py``; ``device_knobs``
against ``_device_knobs``; and the options the port refuses.
"""
import gzip
import hashlib
import pathlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from libflate_tpu_torch import convert  # noqa: E402
from libflate_tpu_torch.formats import pgzf  # noqa: E402
from libflate_tpu_torch.ops import hash_match as hm  # noqa: E402
from libflate_tpu_torch.ops import pipeline  # noqa: E402
from libflate_tpu_torch.ops import sort_match as sm  # noqa: E402
from libflate_tpu_torch.serial.deflate import EncodeOptions  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
DATA = ROOT / "tests" / "data"
SCRIPT = ROOT / "scripts" / "make_pgzf_encode_fixture.py"
N = 4096

#: name -> (matcher, lengths_stage knobs)
CONFIGS = {
    "sort_lcp8": ("sort", {"lcp_rounds": 8}),
    "sort_lcp2": ("sort", {"lcp_rounds": 2}),
    "sort_chain3": ("sort", {"chain": 3}),
    "sort_chain8_lcp8_w2048": ("sort", {"chain": 8, "lcp_rounds": 8,
                                        "window": 2048}),
    "sort_greedy": ("sort", {"lazy": False}),
    "hash_chain1": ("hash", {}),
}


def _rows():
    """Four 4 KiB members: Zipf text, text with a 200-byte motif
    repeated at long range, a run-heavy member, and a short member."""
    rng = np.random.default_rng(8)
    words = [bytes(rng.integers(97, 104, rng.integers(2, 8),
                                dtype=np.uint8)) for _ in range(40)]
    text = b" ".join(words[int(i)] for i in rng.zipf(1.25, 3000) % 40)
    motif = bytes(rng.integers(97, 123, 200, dtype=np.uint8))
    rows = np.zeros((4, N), np.uint8)
    rows[0] = np.frombuffer(text[:N], np.uint8)
    far = (motif + text[N:N + 1300]) * 3
    rows[1] = np.frombuffer(far[:N], np.uint8)
    rows[2] = np.repeat(rng.integers(0, 4, N // 32, dtype=np.uint8), 32)
    rows[3, :3000] = np.frombuffer(text[2 * N:2 * N + 3000], np.uint8)
    return rows, np.array([N, N, N, 3000], np.int32)


@pytest.fixture(scope="module")
def stage():
    """The inputs and, per configuration, the reference's (cand,
    lengths)."""
    from libflate_tpu.ops.pipeline import _lengths_stage
    rows, n_valid = _rows()
    blocks = torch.from_numpy(rows)
    inputs = {}
    for window in (32768, 2048):
        cand, m4 = sm.sort_candidates(blocks, window=window)
        inputs["sort", window] = (cand.numpy(), m4.numpy())
    inputs["hash", 32768] = (hm.prefix_candidates(blocks).numpy(), None)
    want = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LIBFLATE_PALLAS_INTERPRET", "1")
        for name, (matcher, kw) in CONFIGS.items():
            window = kw.get("window", 32768)
            cand, m4 = inputs[matcher, window]
            want[name] = tuple(map(np.asarray, _lengths_stage(
                jnp.asarray(rows), jnp.asarray(n_valid), jnp.asarray(cand),
                lazy=kw.get("lazy", True), use_kernel=True, window=window,
                chain=kw.get("chain", 1),
                m4=None if m4 is None else jnp.asarray(m4),
                m_exact=sm.M_EXACT if m4 is not None else 4,
                lcp_rounds=kw.get("lcp_rounds"))))
    return rows, n_valid, inputs, want


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_lengths_stage_matches_reference(stage, name):
    rows, n_valid, inputs, want = stage
    matcher, kw = CONFIGS[name]
    cand, m4 = inputs[matcher, kw.get("window", 32768)]
    got_c, got_l = pipeline.lengths_stage(
        torch.from_numpy(rows), torch.from_numpy(n_valid),
        torch.from_numpy(cand), None if m4 is None else torch.from_numpy(m4),
        **kw)
    np.testing.assert_array_equal(got_c.numpy(), want[name][0])
    np.testing.assert_array_equal(got_l.numpy(), want[name][1])


def test_lcp_rounds_at_or_below_the_exact_prefix_is_the_default(stage):
    """lcp_rounds=2 skips the kernel (2 <= 16 // 4) and does not cap the
    sort matcher's lengths at 8: it equals the default."""
    rows, n_valid, inputs, want = stage
    cand, m4 = (torch.from_numpy(a) for a in inputs["sort", 32768])
    _c, default = pipeline.lengths_stage(
        torch.from_numpy(rows), torch.from_numpy(n_valid), cand, m4)
    np.testing.assert_array_equal(default.numpy(), want["sort_lcp2"][1])
    assert want["sort_lcp2"][1].max() > 8
    assert (want["sort_lcp8"][1] >= default.numpy()).sum() > 0
    assert want["sort_lcp8"][1].max() > want["sort_lcp2"][1][
        cand.numpy() != np.arange(N) - 1].max()


def _compress_fixture(name: str, options=None, member: int = 1024):
    ref = (DATA / name).read_bytes()
    return ref, pgzf.compress(gzip.decompress(ref), member_size=member,
                              options=options, device="cpu")


@pytest.mark.parametrize("name", ["pgzf_encode_chain8_small.pgz",
                                  "pgzf_encode_hash_small.pgz",
                                  "pgzf_encode_chain8_w2048_8k.pgz"])
def test_fixture_is_recorded_in_its_script(name):
    stream = (DATA / name).read_bytes()
    assert hashlib.sha256(stream).hexdigest() in SCRIPT.read_text()


def test_compress_chain8_matches_reference_stream():
    from libflate_tpu.serial.deflate import EncodeOptions as RefOptions
    opts = convert.from_reference_options(
        RefOptions(matcher="chain", max_chain=8, lcp_rounds=8))
    assert opts == EncodeOptions(matcher="chain", max_chain=8, lcp_rounds=8)
    ref, got = _compress_fixture("pgzf_encode_chain8_small.pgz", opts)
    assert got == ref
    default = (DATA / "pgzf_encode_small.pgz").read_bytes()
    assert len(ref) < len(default)


def test_compress_chain8_8k_members_window_2048_matches_reference_stream():
    """Eight LCP row groups per member, so the swept band is narrower
    than the member on the chain levels too."""
    ref, got = _compress_fixture(
        "pgzf_encode_chain8_w2048_8k.pgz",
        EncodeOptions(matcher="chain", max_chain=8, lcp_rounds=8,
                      window_size=2048), member=8192)
    assert got == ref


def test_compress_hash_matches_reference_stream(monkeypatch):
    monkeypatch.setenv("LIBFLATE_DEVICE_MATCHER", "hash")
    ref, got = _compress_fixture("pgzf_encode_hash_small.pgz")
    assert got == ref


@pytest.mark.parametrize("kw", [
    {}, {"matcher": "greedy"}, {"matcher": "lazy", "lazy": False},
    {"matcher": "chain", "max_chain": 0}, {"matcher": "chain"},
    {"window_size": 4096, "parse_cap": 512},
    {"lcp_rounds": 0}, {"matcher": "none", "lcp_rounds": 3}])
def test_device_knobs_match_reference(kw):
    from libflate_tpu.ops.pipeline import _device_knobs
    from libflate_tpu.serial.deflate import EncodeOptions as RefOptions
    ref = RefOptions(**kw)
    assert pipeline.device_knobs(EncodeOptions(**kw)) == _device_knobs(ref)
    assert pipeline.device_knobs(ref) == _device_knobs(ref)
    assert convert.from_reference_options(ref) == EncodeOptions(**kw)


@pytest.mark.parametrize("kw,match", [
    ({"block_type": "bogus"}, "unknown block_type"),
    ({"block_type": "huffman"}, "unknown block_type"),
    ({"matcher": "lz4"}, "unknown matcher"),
    ({"matcher": "bogus"}, "unknown matcher"),
    ({"window_size": 1000}, "window_size"),
    ({"window_size": 65536}, "window_size")])
def test_unported_options_raise(kw, match):
    with pytest.raises(ValueError, match=match):
        pgzf.compress(b"abc" * 500, member_size=1024,
                      options=EncodeOptions(**kw), device="cpu")


def test_unknown_device_matcher_raises(monkeypatch):
    monkeypatch.setenv("LIBFLATE_DEVICE_MATCHER", "xla")
    with pytest.raises(ValueError, match="LIBFLATE_DEVICE_MATCHER"):
        pgzf.compress(b"abc" * 500, member_size=1024, device="cpu")
