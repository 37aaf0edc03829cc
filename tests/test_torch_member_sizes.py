"""PGZF member sizes that are not a multiple of 1024 (and the refused
ones) against the reference's dynamic kernel branch.

The reference streams ``tests/data/pgzf_encode_odd_*.pgz`` come from
``scripts/make_pgzf_encode_fixture.py --odd``: the reference's device
encode in Pallas interpret mode on its TPU kernel branches, on
``small_corpus()``, with the hash matcher (the reference's interpreted
sort does not finish at 2048 keys; with the sort matcher an odd size
differs only in the candidates, whose kernel the card tests hold to its
plain version at such widths).  The port's ``compress(device="cpu")`` must give the
same bytes; the 512-byte stream is held on its first batch (128
members: a batch's bytes depend on its own members only), and the
65024- and 131072-byte ones (a batch of 128 full-width rows each, tens
of seconds on the CPU) on the card only (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phases 8 and 11a), which keeps this file to seconds.
Where the reference refuses a size, while it traces (``jax.eval_shape``:
nothing runs), the port raises ValueError naming the reason.
"""
import gzip
import pathlib
import struct

import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from libflate_tpu_torch.formats import pgzf  # noqa: E402
from libflate_tpu_torch.serial.deflate import EncodeOptions  # noqa: E402

DATA = pathlib.Path(__file__).parent / "data"
#: fixture name -> (member size, LIBFLATE_DEVICE_MATCHER, members held)
ODD = {"1536_hash": (1536, "hash", None), "512_hash": (512, "hash", 128)}


def _members(stream: bytes, n: int | None) -> bytes:
    refs = pgzf.index_members(stream)
    return stream if n is None else stream[:refs[n - 1].end]


@pytest.mark.parametrize("name", sorted(ODD))
def test_odd_member_size_matches_reference(name, monkeypatch):
    member, matcher, n = ODD[name]
    monkeypatch.setenv("LIBFLATE_DEVICE_MATCHER", matcher)
    ref = (DATA / f"pgzf_encode_odd_{name}.pgz").read_bytes()
    want = _members(ref, n)
    plain = gzip.decompress(want)
    assert struct.unpack_from("<I", want, pgzf.index_members(want)[0].end
                              - 4)[0] == member
    got = pgzf.compress(plain, member_size=member, device="cpu")
    assert got == want
    assert pgzf.decompress(got, device="cpu") == plain


def _reference_refuses(member: int, matcher: str) -> bool:
    """Whether the reference's kernel branch refuses ``member`` while it
    traces: the parse (positions % 512) or the candidate stage."""
    from libflate_tpu.ops.pallas_lz77 import prefix_candidates_pallas
    from libflate_tpu.ops.pallas_parse import parse_chunk_exits
    from libflate_tpu.ops.sort_match import sort_candidates
    cand = sort_candidates if matcher == "sort" else prefix_candidates_pallas
    try:
        jax.eval_shape(parse_chunk_exits,
                       jax.ShapeDtypeStruct((member, 128), jnp.int32))
        jax.eval_shape(cand, jax.ShapeDtypeStruct((128, member), jnp.uint8))
    except AssertionError:
        return True
    return False


@pytest.mark.parametrize("member,matcher,reason", [
    (1000, "sort", "multiple of 512"), (1000, "hash", "multiple of 512"),
    (512, "sort", "1024 keys"), (131072, "sort", "16-bit"),
    (262144, "hash", "131072")])
def test_refused_sizes_match_reference(member, matcher, reason,
                                       monkeypatch):
    monkeypatch.setenv("LIBFLATE_PALLAS_INTERPRET", "1")
    assert _reference_refuses(member, matcher)
    monkeypatch.setenv("LIBFLATE_DEVICE_MATCHER", matcher)
    with pytest.raises(ValueError, match=reason):
        pgzf.compress(b"x" * 3000, member_size=member, device="cpu")


@pytest.mark.parametrize("member,matcher", [(1536, "sort"), (2560, "sort"),
                                            (512, "hash"), (131072, "hash")])
def test_taken_sizes_match_reference(member, matcher, monkeypatch):
    monkeypatch.setenv("LIBFLATE_PALLAS_INTERPRET", "1")
    assert not _reference_refuses(member, matcher)
    monkeypatch.setenv("LIBFLATE_DEVICE_MATCHER", matcher)
    pgzf._check_member_size(member, "dynamic")


@pytest.mark.parametrize("opts,member,ok", [
    ({"block_type": "stored"}, 777, True),
    ({"matcher": "none"}, 1, True),
    ({"block_type": "fixed"}, 1000, True),
    ({"block_type": "fixed"}, 131073, False),
    ({"block_type": "auto"}, 0, False)])
def test_route_sizes(opts, member, ok):
    """Stored blocks and ``matcher="none"`` take any size >= 1; fixed and
    auto blocks (the hash candidates of a batch of 128) up to 131072."""
    data = bytes(range(256)) * 5 if member > 1 else b"tiny"
    if not ok:
        with pytest.raises(ValueError):
            pgzf.compress(data, member_size=member,
                          options=EncodeOptions(**opts), device="cpu")
        return
    stream = pgzf.compress(data, member_size=member,
                           options=EncodeOptions(**opts), device="cpu")
    assert gzip.decompress(stream) == data
    assert len(pgzf.index_members(stream)) == -(-len(data) // member)
