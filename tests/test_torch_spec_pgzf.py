"""The port's speculative decode branch end to end, against stdlib gzip
and the reference.

``decompress_to_device(device="cpu")`` on streams without the LS sync
index: the committed fixtures with the index stripped, equal to gzip's
plaintext; which branch a stream takes (spies on ``_spec_to_device`` and
``_run_sync_chain``: the launch counters count CUDA launches only); and
the error cases, each with the reference's exception.  The reference runs
its speculative path on the CPU as ``test_torch_spec_decode.py`` sets it
up, on hand-built one-member streams of at most 2048 bit positions.
"""
import gzip
import pathlib
import struct
import zlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from chip_smoke import strip_sync_index  # noqa: E402
from libflate_tpu_torch.formats import pgzf as port  # noqa: E402
from test_torch_spec_decode import reference_spec  # noqa: E402

DATA = pathlib.Path(__file__).resolve().parent / "data"
SMALL = DATA / "pgzf_sync_zipf_small.pgz"


def _dynamic_body(tokens) -> bytes:
    """One final dynamic block of ``tokens`` ((a, b) pairs), written with
    the reference's serial helpers, codes limited to 12/8 bits."""
    from libflate_tpu.serial.bitio import BitWriter
    from libflate_tpu.serial.deflate import (_encode_tokens, token_histograms,
                                             write_dynamic_header)
    from libflate_tpu.serial.huffman import HuffmanEncoder, package_merge
    lit_freq, dist_freq = token_histograms(tokens)
    if not dist_freq.any():
        dist_freq[0] = 1
    ll, dl = package_merge(lit_freq, 12), package_merge(dist_freq, 8)
    w = BitWriter()
    w.write_bits(1, 1)
    w.write_bits(2, 2)
    write_dynamic_header(w, ll, dl)
    _encode_tokens(w, tokens, HuffmanEncoder(ll), HuffmanEncoder(dl))
    return w.getvalue()


def _member(body: bytes, plain: bytes) -> bytes:
    """A PGZF member with the LF index and no LS index."""
    m = bytearray(port._member_header(0)) + body
    m += struct.pack("<II", zlib.crc32(plain), len(plain))
    struct.pack_into("<I", m, port._SIZE_OFFSET, len(m))
    return bytes(m)


TEXT = (b"the quick brown fox jumps over the lazy dog; " * 6
        + b"pack my box with five dozen liquor jugs")


@pytest.fixture(scope="module")
def text_member():
    from libflate_tpu.serial.lz77 import greedy_tokens
    return _member(_dynamic_body(greedy_tokens(TEXT)), TEXT)


def _outcome(fn, data):
    """(exception class name, message) or the decoded plaintext."""
    try:
        out, lengths = fn(data)
    except (ImportError, ValueError) as e:
        return type(e).__name__, str(e)
    out, lengths = np.asarray(out), np.asarray(lengths)
    return b"".join(out[i, :lengths[i]].tobytes() for i in range(len(out)))


def _reference(data):
    with reference_spec([]) as ref:
        return _outcome(lambda d: ref.decompress_to_device(d, verify=True),
                        data)


def _port(data):
    return _outcome(lambda d: port.decompress_to_device(d, verify=True,
                                                        device="cpu"), data)


@pytest.fixture()
def spies(monkeypatch):
    calls = {"spec": 0, "sync": 0}
    spec, sync = port._spec_to_device, port._run_sync_chain

    def spy_spec(*a):
        calls["spec"] += 1
        return spec(*a)

    def spy_sync(*a):
        calls["sync"] += 1
        return sync(*a)

    monkeypatch.setattr(port, "_spec_to_device", spy_spec)
    monkeypatch.setattr(port, "_run_sync_chain", spy_sync)
    return calls


@pytest.mark.parametrize("name", ["pgzf_sync_zipf_small.pgz",
                                  "pgzf_sync_zipf_2m.pgz"])
def test_stripped_stream_takes_spec_path_and_matches_gzip(spies, name):
    data = (DATA / name).read_bytes()
    stripped = strip_sync_index(data)
    assert len(stripped) < len(data) and port.index_members(stripped)
    assert gzip.decompress(stripped) == gzip.decompress(data)
    out, lengths = port.decompress_to_device(stripped, verify=True,
                                             device="cpu")
    assert spies == {"spec": 1, "sync": 0}
    assert out.dtype == torch.uint8 and lengths.dtype == torch.int32
    live = torch.arange(out.shape[1])[None, :] < lengths[:, None]
    assert out[live].numpy().tobytes() == gzip.decompress(data)
    assert not out[~live].any()


def test_sync_indexed_stream_takes_sync_path(spies):
    port.decompress_to_device(SMALL.read_bytes(), verify=True, device="cpu")
    assert spies == {"spec": 0, "sync": 1}


def _tokens(groups, data):
    """The first group's (packed, n_tokens) as lists, or the (class name,
    message) of the error that stops the speculative decode."""
    try:
        packed, nt, group, _cap = next(groups(data, port.index_members(data)))
    except (ImportError, ValueError) as e:
        return type(e).__name__, str(e)
    n = len(group)
    return np.asarray(packed)[:n].tolist(), np.asarray(nt)[:n].tolist()


@pytest.mark.parametrize("bit,error", [
    (None, None),
    (165, ("DeflateError", "bad block header in member 0")),
    (201, ("DeflateError", "speculative decode failed in member 0")),
    (603, ("DeflateError", "speculative decode failed in member 0")),
    (228, ("DeflateError", "bad back-reference in device expansion")),
    (267, ("GzipError", "gzip CRC mismatch in member 0"))])
def test_flipped_bit_matches_reference(text_member, bit, error):
    """One flipped bit of the body (none: the clean member): the port's
    speculative tokens, or the error that stops them, equal the
    reference's staged composition's; the port's decode then gives the
    plaintext or the error named (the reference's expansion, which would
    decide the last two, takes ~1 min in interpret mode, and is held
    against the port's in ``test_torch_pgzf.py``)."""
    data = bytearray(text_member)
    if bit is not None:
        data[port.index_members(text_member)[0].body + bit // 8] ^= \
            1 << (bit % 8)
    data = bytes(data)
    with reference_spec([]) as ref:
        want = _tokens(lambda d, r: ref._spec_token_groups(d, r), data)
    got = _tokens(lambda d, r: port._spec_token_groups(d, r, "cpu"), data)
    assert got == want
    assert _port(data) == (TEXT if error is None else error)
    if error is not None:
        with pytest.raises((OSError, EOFError, zlib.error)):
            gzip.decompress(data)


def test_overflow_rule_matches_reference():
    """A valid member with more than 128 tokens in one 512-bit chunk (a
    literal, then 200 matches of 258 at distance 1, 2 bits each): gzip
    reads it, the reference's speculative decode flags it, and so does
    the port (ROADMAP Queue 3)."""
    plain = b"\x00" * (1 + 200 * 258)
    stream = _member(_dynamic_body([(0, 0)] + [(258, 1)] * 200), plain)
    assert gzip.decompress(stream) == plain
    want = _reference(stream)
    assert want == ("DeflateError", "speculative decode failed in member 0")
    assert _port(stream) == want


def _tables_differ():
    small = strip_sync_index(SMALL.read_bytes())
    big = strip_sync_index((DATA / "pgzf_sync_zipf_2m.pgz").read_bytes())
    return small + big[:port.index_members(big)[0].end]


@pytest.mark.parametrize("make,why", [
    (lambda: strip_sync_index((DATA / "pgzf_encode_small.pgz")
                              .read_bytes()), "non-uniform member layout"),
    (_tables_differ, "tables differ within a group")])
def test_streams_the_spec_path_refuses(spies, make, why, monkeypatch):
    """A stored member, or two tables in one group of 128: ImportError
    in the reference's speculative staging and in the port's, which then,
    as the reference does, hands the stream to the foreign-stream path:
    the rows equal gzip's plaintext."""
    data = make()
    with reference_spec([]) as ref:
        with pytest.raises(ImportError, match=why):
            next(ref._spec_token_groups(data, ref.index_members(data)))
    with pytest.raises(ImportError, match=why):
        next(port._spec_token_groups(data, port.index_members(data), "cpu"))
    foreign = []
    real_foreign = port._foreign_to_device
    monkeypatch.setattr(port, "_foreign_to_device",
                        lambda *a: foreign.append(a[2]) or real_foreign(*a))
    out, lengths = port.decompress_to_device(data, verify=True,
                                             device="cpu")
    assert spies == {"spec": 1, "sync": 0}
    assert len(foreign) == 1 and foreign[0] is not None     # indexed
    live = torch.arange(out.shape[1])[None, :] < lengths[:, None]
    assert out[live].numpy().tobytes() == gzip.decompress(data)


def test_empty_stream_is_import_error(spies):
    """The name is from before the foreign-stream path was ported: the
    empty stream now raises the reference's ValueError (an empty member
    index is not None, so the speculative staging reduces an empty
    array)."""
    with pytest.raises(ValueError):
        port.decompress_to_device(b"", device="cpu")
    assert spies == {"spec": 1, "sync": 0}
