"""The port's host-output ``pgzf.decompress`` against stdlib gzip and the
reference, on the CPU.

``decompress(device="cpu")`` on a sync-indexed stream (the first 64 KiB
member of ``pgzf_sync_zipf_2m.pgz``), the same stripped of its LS index, LF-indexed members with
their own tables (zlib bodies), a stdlib gzip stream, the small encode
reference stream (stored members 130-133) and the empty stream; each
branch against the reference's branch where that runs on the CPU: the
sync branch in Pallas interpret mode (``LIBFLATE_PALLAS_INTERPRET=1``, as
``tests/test_sync_decode.py`` runs it), the generic branch in plain XLA,
the shared branch with its backend check patched (as
``test_torch_spec_pgzf.py`` does, on hand-built members of at most 2048
bit positions).  Also: which branch a stream takes, with and without
``LIBFLATE_NO_SYNC`` / ``LIBFLATE_NO_SPEC``; the debug checks
(``LIBFLATE_DEBUG_CHECKS=1``) on the reference test's corrupted LS delta
and on an LS index that poisons the kernel; the error types of a flipped
body byte, a flipped CRC and a truncated trailer.  Every reference call
runs once, in the module fixture.
"""
import gzip
import pathlib

import pytest

jax = pytest.importorskip("jax")

from chip_smoke import generic_shard, poison_ls, strip_sync_index  # noqa: E402
from libflate_tpu_torch.formats import gzip as port_gzip  # noqa: E402
from libflate_tpu_torch.formats import pgzf as port  # noqa: E402
from libflate_tpu_torch.serial.deflate import DeflateError  # noqa: E402
from test_torch_spec_decode import reference_spec  # noqa: E402
from test_torch_spec_pgzf import TEXT, _dynamic_body, _member  # noqa: E402

DATA = pathlib.Path(__file__).resolve().parent / "data"
BRANCHES = ("_decompress_sync", "_decompress_shared", "_decompress_generic",
            "_decompress_foreign")


def _flip(data: bytes, pos: int, mask: int = 0xFF) -> bytes:
    out = bytearray(data)
    out[pos] ^= mask
    return bytes(out)


def _ls_flip(stream: bytes) -> bytes:
    """The reference test's corruption: the high byte of the first
    member's first LS delta flipped (``tests/test_sync_decode.py:185``)."""
    return _flip(stream, stream.find(b"LS") + 4 + 15)


@pytest.fixture(scope="module")
def streams():
    small = (DATA / "pgzf_sync_zipf_small.pgz").read_bytes()
    enc = (DATA / "pgzf_encode_small.pgz").read_bytes()
    big = (DATA / "pgzf_sync_zipf_2m.pgz").read_bytes()
    sync = big[:port.index_members(big)[0].end]
    lf = generic_shard(gzip.decompress(enc)[:6000], 2048)
    from libflate_tpu.serial.lz77 import greedy_tokens
    member = _member(_dynamic_body(greedy_tokens(TEXT)), TEXT)
    lf_refs = port.index_members(lf)
    body_mid = (lf_refs[1].body + lf_refs[1].end - 8) // 2
    return {
        "sync": sync, "stripped": strip_sync_index(sync), "generic": lf,
        "gzip": gzip.compress(TEXT) + gzip.compress(b"x" * 5000),
        "encode_small": enc, "small": small, "shared": member * 2,
        "flipped body": _flip(lf, body_mid, 0x10),
        "flipped crc": _flip(lf, lf_refs[2].end - 6),
        "truncated trailer": lf[:lf_refs[0].end - 4],
        "ls flip": _ls_flip(small), "poisoned": poison_ls(small)}


def _outcome(fn, data):
    try:
        return bytes(fn(data))
    except (ImportError, ValueError, EOFError) as e:
        return type(e).__name__


@pytest.fixture(scope="module")
def ref(streams):
    """Every reference call of this file."""
    import libflate_tpu.ops.pipeline  # noqa: F401  (registers engine "tpu")
    from libflate_tpu.formats import pgzf as R

    def branch(name):
        return lambda d: getattr(R, name)(d, R.index_members(d), True)

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        # the reference reads the flag when it traces: the debug calls
        # come first, and the caches go before the default kernel runs
        mp.setenv("LIBFLATE_PALLAS_INTERPRET", "1")
        mp.setenv("LIBFLATE_DEBUG_CHECKS", "1")
        for name in ("small", "ls flip"):
            out[f"debug {name}"] = _outcome(
                branch("_decompress_sync_device"), streams[name])
        with pytest.raises(ValueError) as e:
            branch("_decompress_sync_device")(streams["poisoned"])
        out["debug poisoned"] = f"{type(e.value).__name__}: {e.value}"
        mp.delenv("LIBFLATE_DEBUG_CHECKS")
        jax.clear_caches()
        out["sync"] = _outcome(branch("_decompress_sync_device"),
                               streams["sync"])
    for name in ("generic", "encode_small", "flipped body", "flipped crc"):
        out[f"generic {name}"] = _outcome(branch("_decompress_device"),
                                          streams[name])
    for name in ("flipped body", "flipped crc", "truncated trailer",
                 "ls flip"):
        out[f"decompress {name}"] = _outcome(
            lambda d: R.decompress(d, engine="tpu"), streams[name])
    with reference_spec([]) as R2:
        out["shared"] = _outcome(
            lambda d: R2._decompress_shared_device(d, R2.index_members(d),
                                                   True), streams["shared"])
    return out


def _port(data, **kw):
    return _outcome(lambda d: port.decompress(d, device="cpu", **kw), data)


@pytest.mark.parametrize("name", ["sync", "stripped", "generic", "gzip",
                                  "encode_small", "small", "shared"])
def test_decompress_matches_gzip(streams, name):
    data = streams[name]
    assert _port(data) == gzip.decompress(data)
    assert _port(data, verify=False) == gzip.decompress(data)


def test_empty_stream_raises_value_error():
    """As the reference's shared branch does on a TPU backend."""
    with pytest.raises(ValueError):
        port.decompress(b"", device="cpu")


def test_sync_branch_matches_reference(streams, ref):
    data = streams["sync"]
    assert ref["sync"] == gzip.decompress(data)
    assert port._decompress_sync(data, port.index_members(data), True,
                                 port._device("cpu")) == ref["sync"]


@pytest.mark.parametrize("name", ["generic", "encode_small"])
def test_generic_branch_matches_reference(streams, ref, name):
    data = streams[name]
    assert port._decompress_generic(data, port.index_members(data), True,
                                    port._device("cpu")) \
        == ref[f"generic {name}"] == gzip.decompress(data)


def test_shared_branch_matches_reference(streams, ref):
    data = streams["shared"]
    assert port._decompress_shared(data, port.index_members(data), True,
                                   port._device("cpu")) \
        == ref["shared"] == gzip.decompress(data)


@pytest.mark.parametrize("name,env,taken", [
    ("small", {}, ["sync"]),
    ("small", {"LIBFLATE_NO_SYNC": "1"}, ["shared"]),
    ("small", {"LIBFLATE_NO_SYNC": "1", "LIBFLATE_NO_SPEC": "1"},
     ["generic"]),
    ("stripped", {}, ["sync", "shared"]),
    ("generic", {}, ["sync", "shared", "generic"]),
    ("generic", {"LIBFLATE_NO_SPEC": "1"}, ["sync", "generic"]),
    ("gzip", {}, ["foreign"]),
])
def test_branch_taken(streams, monkeypatch, name, env, taken):
    """Which branches a stream tries, in the reference's order; the last
    one decodes it."""
    calls = []
    for b in BRANCHES:
        real = getattr(port, b)

        def spy(*a, _real=real, _b=b):
            calls.append(_b.rsplit("_", 1)[1])
            return _real(*a)
        monkeypatch.setattr(port, b, spy)
    for k in ("LIBFLATE_NO_SYNC", "LIBFLATE_NO_SPEC"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert port.decompress(streams[name], device="cpu") \
        == gzip.decompress(streams[name])
    assert calls == taken


def test_debug_checks(streams, ref, monkeypatch):
    """With LIBFLATE_DEBUG_CHECKS=1 the clean stream decodes; an LS index
    at K=1024 (every chunk's cursor runs past its staged window) raises
    the reference's DeflateError from the sync branch; the reference
    test's own flip (a chunk start past the body) drops the sync branch
    with ImportError in both, and ``decompress`` decodes the stream by the
    next branch, as the reference's does."""
    monkeypatch.setenv("LIBFLATE_DEBUG_CHECKS", "1")
    dev = port._device("cpu")

    def sync(d):
        return port._decompress_sync(d, port.index_members(d), True, dev)

    assert _outcome(sync, streams["small"]) == ref["debug small"] \
        == gzip.decompress(streams["small"])
    assert _outcome(sync, streams["ls flip"]) == ref["debug ls flip"] \
        == "ImportError"
    assert ref["debug poisoned"].startswith("DeflateError: sync kernel "
                                            "invariant violated")
    with pytest.raises(DeflateError, match="invariant violated"):
        sync(streams["poisoned"])
    with pytest.raises(DeflateError, match="invariant violated"):
        port.decompress(streams["poisoned"], device="cpu")
    assert _port(streams["ls flip"]) == ref["decompress ls flip"] \
        == gzip.decompress(streams["small"])
    monkeypatch.delenv("LIBFLATE_DEBUG_CHECKS")
    # without the checks the poisoned tokens fail the expansion instead
    with pytest.raises(DeflateError, match="token expansion failed"):
        sync(streams["poisoned"])


@pytest.mark.parametrize("name", ["flipped body", "flipped crc"])
def test_generic_branch_errors_match_reference(streams, ref, name):
    data = streams[name]
    got = _outcome(lambda d: port._decompress_generic(
        d, port.index_members(d), True, port._device("cpu")), data)
    assert got == ref[f"generic {name}"]
    assert got in ("DeflateError", "GzipError")


@pytest.mark.parametrize("name", ["flipped body", "flipped crc",
                                  "truncated trailer"])
def test_error_types_match_reference(streams, ref, name):
    got = _port(streams[name])
    assert got == ref[f"decompress {name}"]
    assert got in ("DeflateError", "GzipError", "EOFError")


def test_flipped_crc_passes_without_verify(streams):
    data = streams["flipped crc"]
    assert _port(data, verify=False) == gzip.decompress(streams["generic"])
    with pytest.raises(port_gzip.GzipError, match="CRC"):
        port.decompress(data, device="cpu")


def test_cuda_device_without_cuda_raises(monkeypatch, streams):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    called = []
    for b in BRANCHES:
        monkeypatch.setattr(port, b, lambda *a: called.append(a))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.decompress(streams["small"], device="cuda")
    assert not called
