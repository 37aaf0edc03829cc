"""The generic device engine's encode half on the CPU, exact against the
reference: checksums, the bit pack, the LZ77 tokenizer's stages, the
block fields, and ``deflate_device`` on both of the reference's branches.

The reference's TPU branches (the hash kernel for a batch of 128 blocks,
the per-block token-field kernel for dynamic blocks) are off on the CPU
(``_use_pallas()`` is False there).  The port's side of them is the "cpu"
engine with ``use_kernel_branches`` patched on; the reference's side is
the committed streams of ``scripts/make_deflate_device_fixture.py``,
which runs them in Pallas interpret mode with ``_use_pallas`` patched to
True (its interpret-mode hash kernel takes ~30 s to compile here): the
``hash_ref`` streams of four kinds of data at 128 blocks of 1024 bytes
(``N_HASH``), and every ``chip_smoke.DEFLATE_FIXTURES`` stream.  The sort
branch runs unpatched at 10 blocks, its reference calls once, in a module
fixture.
"""
import pathlib
import zlib

import numpy as np
import pytest
import torch

import chip_smoke

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from libflate_tpu_torch import backend  # noqa: E402
from libflate_tpu_torch.formats import pgzf  # noqa: E402
from libflate_tpu_torch.ops import (bitpack, checksum,  # noqa: E402
                                    deflate_encode, lz77, pipeline)
from libflate_tpu_torch.serial.deflate import EncodeOptions  # noqa: E402
from libflate_tpu_torch.utils import checksum as host_ck  # noqa: E402

DATA = pathlib.Path(__file__).resolve().parent / "data"
N = 2048                      # block width of the stage tests
N_HASH = 1024                 # block width of the 128-block hash batch
CHECK_LENGTHS = (0, 1, 3, 63, 64, 65, 1023, 4097, 10001)
#: deflate_device settings of the sort branch (10 blocks of 4096)
SORT_CASES = {"dynamic": {}, "fixed": {"block_type": "fixed"},
              "none": {"matcher": "none"},
              "none fixed": {"matcher": "none", "block_type": "fixed"},
              "stored": {"block_type": "stored"},
              "auto": {"block_type": "auto"}}
HASH_CASES = ("dynamic", "fixed", "pgzf fixed")


def _hard_blocks():
    """(6, N) rows and their n_valid: text; an all-literal (random)
    512-chunk between text; 258-byte matches across the chunk ends at
    512 / 1024 / 1536; text cut inside a chunk (n_valid 700); one
    repeated byte; a period-20 pattern (nearly every position still
    extends after 3 rounds: more than N // 8 survivors)."""
    rng = np.random.default_rng(7)
    text = (b"the quick brown fox jumps over the lazy dog; " * 60)[:N]
    rows = np.zeros((6, N), np.uint8)
    rows[0] = np.frombuffer(text, np.uint8)
    rows[1] = rows[0]
    rows[1, 512:1024] = rng.integers(0, 256, 512)
    piece = rng.integers(0, 256, 300).astype(np.uint8)
    for start in (300, 800, 1300):
        rows[2, start - 300:start] = piece
        rows[2, start:start + 300] = piece
    rows[2, 1700:] = rng.integers(0, 256, N - 1700)
    rows[3, :700] = rows[0, :700]
    rows[4] = 0x5A
    rows[5] = np.frombuffer((bytes(range(65, 85)) * 200)[:N], np.uint8)
    n_valid = np.array([N, N, N, 700, N, N - 5], np.int32)
    for i, nv in enumerate(n_valid):
        rows[i, nv:] = 0
    return rows, n_valid


def _sort_data() -> bytes:
    rng = np.random.default_rng(1)
    return (b"the quick brown fox jumps over the lazy dog. " * 300
            + rng.integers(0, 256, 6000, dtype=np.uint8).tobytes()
            + b"a" * 5000
            + rng.integers(97, 100, 12000, dtype=np.uint8).tobytes())


def _hash_data() -> bytes:
    """The plaintext of the ``hash_ref`` streams: 128 blocks of N_HASH
    bytes, less 100 (text, random, one byte, four letters, in turn)."""
    return zlib.decompress((DATA / "deflate_device_kinds.bin").read_bytes(),
                           -15)


def _ref_options(kw):
    from libflate_tpu.serial.deflate import EncodeOptions as RefOptions
    return RefOptions(**kw)


@pytest.fixture(scope="module")
def ref():
    """The reference's stage outputs on the hard blocks, its checksums
    and pack, and its sort-branch streams."""
    from libflate_tpu.ops import bitpack as rbp
    from libflate_tpu.ops import checksum as rck
    from libflate_tpu.ops import deflate_encode as rde
    from libflate_tpu.ops import lz77 as rlz
    from libflate_tpu.ops import pipeline as rpl
    rows, n_valid = _hard_blocks()
    out = {"rows": rows, "n_valid": n_valid}
    d, nv = jnp.asarray(rows), jnp.asarray(n_valid)
    cand = jax.jit(jax.vmap(rlz.prefix_candidates))(d)
    out["cand"] = np.asarray(cand)
    masked = jnp.where(jnp.arange(N)[None, :] < nv[:, None], cand, -1)
    for mr in (None, 6):
        out[f"lengths {mr}"] = np.asarray(jax.jit(jax.vmap(
            lambda x, c, mr=mr: rlz.match_lengths(x, c, max_rounds=mr)))(
            d, masked))
    out["marks"] = np.asarray(jax.vmap(rlz.greedy_parse_marks)(
        jnp.asarray(out["lengths None"])))
    a, b, cnt = jax.vmap(lambda x, n: rlz.tokenize_block(x, n, N + 1))(d, nv)
    out["tokens"] = tuple(np.asarray(x) for x in (a, b, cnt))
    a6, b6, cnt6 = jax.vmap(lambda x, n, c: rlz.tokenize_block_from_cand(
        x, n, N + 1, c, max_rounds=6))(d, nv, cand)
    out["tokens 6"] = tuple(np.asarray(x) for x in (a6, b6, cnt6))
    bfinal = jnp.asarray(np.arange(6) % 2, jnp.int32)
    for bt in ("dynamic", "fixed"):
        out[f"fields {bt}"] = tuple(np.asarray(x) for x in jax.vmap(
            lambda x, y, z, f, bt=bt: rde.encode_block_fields(x, y, z, f,
                                                              bt))(
            a, b, cnt, bfinal))
    rng = np.random.default_rng(11)
    widths = rng.integers(0, 29, (3, 1000)).astype(np.int32)
    widths[1, ::3] = 0
    values = (rng.integers(0, 1 << 28, (3, 1000))
              & ((1 << widths) - 1)).astype(np.int32)
    out["pack in"] = (values, widths)
    out["pack"] = tuple(np.asarray(x) for x in jax.vmap(rbp.pack_fields)(
        jnp.asarray(values), jnp.asarray(widths)))
    rng = np.random.default_rng(12)
    blobs = {n: rng.integers(0, 256, n, np.uint8).tobytes()
             for n in CHECK_LENGTHS}
    out["blobs"] = blobs
    out["crc"] = {n: int(rck.crc32_jax(jnp.asarray(np.frombuffer(
        b, np.uint8)))) for n, b in blobs.items()}
    out["adler"] = {n: int(rck.adler32_jax(jnp.asarray(np.frombuffer(
        b, np.uint8)))) for n, b in blobs.items()}
    big = blobs[10001]
    out["crc combine"] = int(rck.crc32_combine_jax(
        jnp.uint32(zlib.crc32(big[:4097])), jnp.uint32(zlib.crc32(big[4097:])),
        len(big) - 4097))
    out["adler combine"] = int(rck.adler32_combine_jax(
        jnp.uint32(zlib.adler32(big[:4097])),
        jnp.uint32(zlib.adler32(big[4097:])), len(big) - 4097))
    right = np.zeros((4, 128), np.uint8)
    lens = [0, 1, 77, 128]
    for i, ln in enumerate(lens):
        if ln:
            right[i, 128 - ln:] = np.frombuffer(blobs[10001][:ln], np.uint8)
    out["crc batch in"] = (right, lens)
    out["crc batch"] = np.asarray(rck.crc32_batch_jax(jnp.asarray(right),
                                                      lens))
    data = _sort_data()
    out["sort"] = {name: rpl.deflate_device(data, _ref_options(kw),
                                            device_block_size=4096)
                   for name, kw in SORT_CASES.items()}
    return out


@pytest.fixture(scope="module")
def hash_ref():
    """The reference's TPU-branch streams of ``_hash_data()`` at 128
    blocks of N_HASH: deflate_device dynamic and fixed, and pgzf.compress
    with fixed blocks (the script's ``KIND_FIXTURES``)."""
    return {name: (DATA / f"deflate_device_kinds{suffix}").read_bytes()
            for name, suffix in (("dynamic", ".bin"),
                                 ("fixed", "_fixed.bin"),
                                 ("pgzf fixed", "_fixed.pgz"))}


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("n", CHECK_LENGTHS)
def test_checksums_match_zlib_and_reference(ref, n):
    blob = ref["blobs"][n]
    t = _t(np.frombuffer(blob, np.uint8).copy())
    assert checksum.crc32_device(t) == zlib.crc32(blob) == ref["crc"][n]
    assert checksum.adler32_device(t) == zlib.adler32(blob) == \
        ref["adler"][n]
    assert host_ck.crc32(blob) == zlib.crc32(blob)
    assert host_ck.adler32(blob, 7) == zlib.adler32(blob, 7)
    for eng in ("cpu",):
        e = backend.get(eng)
        assert e.crc32(blob[n // 2:], zlib.crc32(blob[:n // 2])) == \
            zlib.crc32(blob)
        assert e.adler32(blob[n // 2:], zlib.adler32(blob[:n // 2])) == \
            zlib.adler32(blob)


def test_checksum_combines_match_reference(ref):
    big = ref["blobs"][10001]
    c1, c2 = zlib.crc32(big[:4097]), zlib.crc32(big[4097:])
    a1, a2 = zlib.adler32(big[:4097]), zlib.adler32(big[4097:])
    n2 = len(big) - 4097
    assert host_ck.crc32_combine(c1, c2, n2) == zlib.crc32(big) == \
        ref["crc combine"]
    assert int(checksum.crc32_combine_device(torch.tensor(c1),
                                             torch.tensor(c2), n2)) == \
        ref["crc combine"]
    assert host_ck.adler32_combine(a1, a2, n2) == zlib.adler32(big) == \
        ref["adler combine"]
    assert int(checksum.adler32_combine_device(torch.tensor(a1),
                                               torch.tensor(a2), n2)) == \
        ref["adler combine"]
    assert host_ck.crc32_combine(c1, c2, 0) == c1


def test_crc32_batch_matches_reference(ref):
    right, lens = ref["crc batch in"]
    got = checksum.crc32_batch(_t(right), lens)
    np.testing.assert_array_equal(got, ref["crc batch"])
    assert got[0] == 0 and got[1] == zlib.crc32(ref["blobs"][10001][:1])


def test_pack_fields_matches_reference(ref):
    values, widths = ref["pack in"]
    words, bits = bitpack.pack_fields_batch(_t(values), _t(widths))
    want_words, want_bits = ref["pack"]
    np.testing.assert_array_equal(bits.numpy(), want_bits)
    np.testing.assert_array_equal(words.numpy().view(np.uint32), want_words)
    one, total = bitpack.pack_fields(_t(values[0]), _t(widths[0]))
    assert total == int(want_bits[0])
    assert bitpack.words_to_bytes(one).numpy().tobytes() == \
        want_words[0].astype("<u4").tobytes()


def test_prefix_candidates_match_reference(ref):
    got = lz77.prefix_candidates(_t(ref["rows"]))
    np.testing.assert_array_equal(got.numpy(), ref["cand"])


@pytest.mark.parametrize("max_rounds", [None, 6])
def test_match_lengths_match_reference(ref, max_rounds):
    nv = ref["n_valid"]
    cand = np.where(np.arange(N)[None, :] < nv[:, None], ref["cand"], -1)
    got = lz77.match_lengths(_t(ref["rows"]), _t(cand),
                             max_rounds=max_rounds).numpy()
    want = ref[f"lengths {max_rounds}"]
    np.testing.assert_array_equal(got, want)
    # the hard cases are there: more survivors after 3 rounds than the
    # reference's sparse slots, 258-byte matches (at 6 rounds: 24)
    assert (want[5] > 12).sum() > max(256, N // 8)
    longest = 258 if max_rounds is None else 24
    assert (want[2] == longest).sum() > 0 and (want[4] == longest).sum() > 0


def test_greedy_parse_marks_match_reference(ref):
    got = lz77.greedy_parse_marks(_t(ref["lengths None"]))
    np.testing.assert_array_equal(got.numpy(), ref["marks"])
    # the all-literal chunk: every position a token start
    assert ref["marks"][1, 600:1000].all()


@pytest.mark.parametrize("rounds", [None, 6])
def test_tokenize_matches_reference(ref, rounds):
    rows, nv = _t(ref["rows"]), _t(ref["n_valid"])
    if rounds is None:
        got = lz77.tokenize_block(rows, nv, N + 1)
        want = ref["tokens"]
    else:
        got = lz77.tokenize_block_from_cand(rows, nv, N + 1,
                                            _t(ref["cand"]), max_rounds=6)
        want = ref["tokens 6"]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert int(want[2][3]) < 700 and int(want[2][4]) < 20


@pytest.mark.parametrize("block_type", ["dynamic", "fixed"])
def test_encode_block_fields_match_reference(ref, block_type):
    a, b, cnt = (_t(x) for x in ref["tokens"])
    values, widths = deflate_encode.encode_block_fields(
        a, b, cnt, np.arange(6) % 2, block_type)
    want_v, want_w = ref[f"fields {block_type}"]
    np.testing.assert_array_equal(widths.numpy(), want_w)
    # a width-0 field carries no bits (the reference leaves the value of
    # an empty token slot in place)
    mask = (1 << want_w.astype(np.int64)) - 1
    np.testing.assert_array_equal(values.numpy() & mask, want_v & mask)


@pytest.mark.parametrize("name", list(SORT_CASES))
def test_deflate_device_sort_branch_matches_reference(ref, name):
    data = _sort_data()
    got = pipeline.deflate_device(data, EncodeOptions(**SORT_CASES[name]),
                                  device_block_size=4096, device="cpu")
    assert got == ref["sort"][name]
    assert zlib.decompress(got, -15) == data


@pytest.mark.parametrize("name", HASH_CASES)
def test_kernel_branches_match_reference(hash_ref, monkeypatch, name):
    """The hash candidates and (dynamic) the per-block token-field
    kernel's plain version, the reference's TPU branches."""
    monkeypatch.setattr(pipeline, "use_kernel_branches", lambda d: True)
    monkeypatch.setattr(pgzf, "use_kernel_branches", lambda d: True)
    data = _hash_data()
    if name == "pgzf fixed":
        got = pgzf.compress(data, member_size=N_HASH,
                            options=EncodeOptions(block_type="fixed"),
                            device="cpu")
        assert zlib.decompress(got, 31) == data[:N_HASH]
    else:
        opts = EncodeOptions(block_type=name)
        got = pipeline.deflate_device(data, opts, device_block_size=N_HASH,
                                      device="cpu")
        assert zlib.decompress(got, -15) == data
    assert got == hash_ref[name]


def test_kernel_branches_differ_from_sort_branch(hash_ref):
    """The hash branch is a different stream: the patch matters."""
    sort = pipeline.deflate_device(_hash_data(), None,
                                   device_block_size=N_HASH, device="cpu")
    assert sort != hash_ref["dynamic"]


def test_engine_registry():
    assert backend.names() == ["cpu", "cuda", "native", "serial"]
    assert backend.get("cpu").name == "cpu"
    with pytest.raises(KeyError):
        backend.get("tpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="not available"):
            backend.get(None)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pipeline.deflate_device(b"abc", device="cuda")


@pytest.mark.parametrize("name", list(chip_smoke.DEFLATE_FIXTURES))
def test_committed_reference_streams(name, monkeypatch):
    """The port's "cpu" engine with the kernel branches on writes every
    committed reference stream of ``scripts/make_deflate_device_fixture.py``
    (the reference's TPU branches), and reads it back."""
    monkeypatch.setattr(pipeline, "use_kernel_branches", lambda d: True)
    monkeypatch.setattr(pgzf, "use_kernel_branches", lambda d: True)
    kind, opts, size = chip_smoke.DEFLATE_FIXTURES[name]
    want = (DATA / name).read_bytes()
    plain = chip_smoke.fixture_plain(kind, want)
    assert chip_smoke.deflate_fixture_stream(kind, opts, size, plain,
                                             "cpu") == want
    if kind == "pgzf":
        assert chip_smoke.deflate_fixture_decode(kind, want, "cpu") == plain
