"""PGZF on the device (counterpart of ``libflate_tpu/formats/pgzf.py``).

Encode: :func:`compress` (``compress``, ``:153-206``, and
``_compress_device``, ``:241-418``) turns the reference's
``EncodeOptions`` into device knobs, cuts the input into members, encodes
batches of 128 on the device (``ops/pipeline.encode_batch``, or for fixed
blocks ``ops/pipeline.encode_batch_generic``) and assembles the members
on the host: bit splice, member CRC, the "LF" member-size and "LS"
sync-index header subfields, and the stored fallback for incompressible
members.  ``matcher="none"`` and stored blocks go member by member
through the gzip container and ``_reheader`` (``:197-206``, ``:233``),
as does every member with ``engine="serial"`` (the serial host engine).

Decode: :func:`decompress_to_device` (``:752-825``) with
``_prepare_sync_device`` (``:973-1079``), ``_run_sync_chain`` (``:1082``)
and ``_sync_to_plain`` (``:1116-1151``): sync decode -> expand_members ->
CRC f-values.  Shared-table streams without the LS index take the
speculative branch, ``_spec_to_device`` (``:935-970``) and
``_spec_token_groups`` (``:1186-1261``, the fused jit ``:1154-1183`` as
``_spec_chain``): position decode -> chunk exits -> chain entries -> walk
-> compaction -> expand_members -> CRC f-values.  Any other gzip stream
takes the foreign-stream bridge, ``_foreign_to_device`` (``:833-932``):
the host token decode of :mod:`..native`, then expand_members -> CRC
f-values.

Host output: :func:`decompress` (``:452-512``, its device half) returns
bytes through the reference's three device branches in its order: the
sync branch ``_decompress_sync`` (``_decompress_sync_device``,
``:540-749``: members the sync kernel cannot take go through the foreign
token decode), the shared-table branch ``_decompress_shared``
(``_decompress_shared_device``, ``:1264-1301``) and the generic branch
``_decompress_generic`` (``_decompress_device``, ``:1304-1443``: each
member's own tables, ``ops/deflate_decode.decode_symbols``); a branch's
ImportError falls through to the next, the last to the foreign path,
and the foreign path's to the gzip container on the device's engine
(``:508-511``).  Every branch ends in one device-to-host copy of the rows.

``engine="native"`` takes the reference's host routes instead (its
``_compress_native``, ``:209-230``, and the threaded decodes, ``:465-493``,
``:515-537``) on the port's C library (:mod:`..native`).  The trace hooks
(``:101-131``) read ``LIBFLATE_TRACE``: "torch" wraps the device encode
and the sync branch in a ``torch.profiler`` trace, any other value times
the sync branch's stages.

The host helpers — member index, LS sync index, chunk spans, member
header — are the port's own copies of the reference's (``:38-74``,
``:76-101``, ``:126-144``, ``:425-449``).
"""
from __future__ import annotations

import contextlib
import os
import struct
import sys
import zlib
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.checksum import crc32_batch, crc32_f_rows, \
    crc32_from_padded_f
from ..ops.decode import chunk_exit_maps, speculative_decode_positions, \
    walk_emit
from ..ops.deflate_decode import chain_entries, decode_symbols, \
    tokens_from_emit_packed
from ..ops.deflate_encode import splice_blocks_host
from ..ops.device_expand import expand_members
from ..ops.huffman import decode_table, tables_from_lengths
from ..ops.pipeline import device_knobs, encode_batch, \
    encode_batch_generic, matcher, use_kernel_branches
from ..ops.sync_decode import DEBUG_POISON, SYNC_TOKENS, \
    debug_checks, staged_words, stream_words, sync_decode
from ..serial.deflate import DeflateError, deflate_stored, \
    parse_block_headers
from ..spec import constants as C
from . import gzip as fgzip

INDEX_ID = b"LF"
SYNC_ID = b"LS"
DEFAULT_MEMBER_SIZE = 64 * 1024
DEV_BATCH = 128           # members per device encode batch: one shared table


@dataclass
class MemberRef:
    start: int          # byte offset of the member
    end: int            # byte offset one past the member
    body: int           # byte offset of the DEFLATE payload


def _member_header(member_len_placeholder: int, mtime: int = 0,
                   sync_payload: bytes | None = None) -> bytes:
    """Indexed member header: LF (member size) first, at a fixed offset
    (``_SIZE_OFFSET``) so the member can be patched in place, then the
    optional LS sync index."""
    subs = [fgzip.ExtraSubField(INDEX_ID,
                                struct.pack("<I", member_len_placeholder))]
    if sync_payload is not None:
        subs.append(fgzip.ExtraSubField(SYNC_ID, sync_payload))
    return fgzip.Header(mtime=mtime, os=C.GZIP_OS_UNIX,
                        extra=fgzip.ExtraField(subs)).encode()


_HEADER_LEN = len(_member_header(0))
_SIZE_OFFSET = _HEADER_LEN - 4          # the u32 ends the LF subfield


def _lf_member(body: bytes, crc: int, isize: int,
               sync_payload: bytes | None = None) -> bytes:
    """One indexed member: the LF (and LS, where given) header, ``body``,
    then the CRC-32 and ISIZE trailer, with LF patched to its size."""
    member = bytearray(_member_header(0, sync_payload=sync_payload))
    member += body
    member += struct.pack("<II", crc, isize)
    struct.pack_into("<I", member, _SIZE_OFFSET, len(member))
    return bytes(member)


def _sync_payload(k: int, n_tokens: int, offsets: np.ndarray):
    """The "LS" subfield: u8 version=1 | u8 flags=0 | u16 K | u32
    n_tokens | u32 first_bit | u16 n_chunks | u16 deltas[n_chunks-1]
    (LE), the deltas being bit distances between chunk starts.  None when
    a delta does not fit 16 bits."""
    n_chunks = max(0, -(-n_tokens // k))
    first_bit = int(offsets[0])
    deltas64 = (np.diff(offsets[:n_chunks]).astype(np.int64)
                if n_chunks > 1 else np.zeros(0, np.int64))
    if len(deltas64) and int(deltas64.max()) > 0xFFFF:
        return None
    return (struct.pack("<BBHIIH", 1, 0, k, n_tokens, first_bit, n_chunks)
            + deltas64.astype("<u2").tobytes())


def _tracer():
    """A StageTimer when ``LIBFLATE_TRACE`` is set to anything but "torch"
    (``utils.profiling``); else None.  Under "torch" the profiler trace
    alone runs: a stage's synchronisation would show in it."""
    if os.environ.get("LIBFLATE_TRACE") in (None, "", "torch"):
        return None
    from ..utils.profiling import StageTimer
    return StageTimer()


def _maybe_stage(timer, name: str, device=None):
    """``timer``'s stage ``name``, ending when ``device``'s queued work has
    finished; a null context when ``timer`` is None."""
    if timer is None:
        return contextlib.nullcontext()
    return _synced_stage(timer, name, device)


@contextlib.contextmanager
def _synced_stage(timer, name: str, device):
    with timer.stage(name):
        yield
        if device is not None and device.type == "cuda":
            torch.cuda.synchronize(device)


def _trace_report(timer, label: str) -> None:
    if timer:
        print(f"[libflate-trace] {label}\n{timer.report()}",
              file=sys.stderr, flush=True)


def _maybe_torch_trace():
    """``LIBFLATE_TRACE=torch`` wraps the call in ``utils.profiling.
    device_trace`` at ``LIBFLATE_TRACE_DIR`` (``libflate_trace`` under
    the temp directory by default); any other value keeps the StageTimer
    alone."""
    if os.environ.get("LIBFLATE_TRACE") != "torch":
        return contextlib.nullcontext()
    from ..utils.profiling import device_trace
    return device_trace(os.environ.get("LIBFLATE_TRACE_DIR") or None)


def _parse_sync(hdr: "fgzip.Header"):
    """Parse an LS subfield; None when absent, foreign or malformed."""
    if hdr.extra is None:
        return None
    for sub in hdr.extra.subfields:
        if sub.id != SYNC_ID or len(sub.data) < 14:
            continue
        ver, _flags, k, n_tokens, first_bit, n_chunks = struct.unpack_from(
            "<BBHIIH", sub.data, 0)
        if ver != 1 or k == 0 or k > 1024:
            return None
        if len(sub.data) != 14 + 2 * max(0, n_chunks - 1):
            return None
        deltas = np.frombuffer(sub.data, "<u2", offset=14)
        return k, n_tokens, first_bit, n_chunks, deltas
    return None


def _chunk_spans(sync, ref: MemberRef):
    """Validated (starts, ends, counts) int64 arrays of one member's LS
    chunks: bit offsets relative to the body and tokens per chunk.
    Raises ImportError on a corrupt or empty index."""
    k, n_tokens, first_bit, n_chunks, deltas = sync
    body_bits = (ref.end - 8 - ref.body) * 8
    if n_chunks <= 0 or n_tokens <= 0 or n_chunks != -(-n_tokens // k):
        raise ImportError("empty or inconsistent sync index")
    starts = np.zeros(n_chunks, np.int64)
    starts[0] = first_bit
    if n_chunks > 1:
        starts[1:] = first_bit + np.cumsum(deltas.astype(np.int64))
    ends = np.empty(n_chunks, np.int64)
    ends[:-1] = starts[1:]
    ends[-1] = body_bits
    if (ends < starts).any() or starts[-1] >= body_bits:
        raise ImportError("corrupt sync index")
    counts = np.minimum(k, n_tokens - k * np.arange(n_chunks, dtype=np.int64))
    return starts, ends, counts


def index_members(data: bytes) -> list[MemberRef] | None:
    """Walk the LF index without decoding; None if any member lacks it."""
    refs = []
    pos = 0
    while pos < len(data):
        try:
            hdr, body = fgzip.Header.decode(data, pos)
        except (fgzip.GzipError, EOFError):
            return None
        size = None
        if hdr.extra is not None:
            for sub in hdr.extra.subfields:
                if sub.id == INDEX_ID and len(sub.data) == 4:
                    (size,) = struct.unpack("<I", sub.data)
        if size is None or size <= 0 or pos + size > len(data):
            return None
        refs.append(MemberRef(pos, pos + size, body))
        pos += size
    return refs


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        from .. import require_cuda
        require_cuda()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


#: the largest member the hash matcher's kernel packs (17-bit positions:
#: the reference's ``pallas_lz77.py:194``)
HASH_MAX_MEMBER = 1 << 17


def _check_member_size(member_size, route: str) -> None:
    """ValueError unless the reference's route takes ``member_size``:

    * "members" (stored blocks, ``matcher="none"``): any size >= 1;
    * "generic" (fixed / auto blocks: the hash candidates of a batch of
      128): up to 131072 (``pallas_lz77.py:194``);
    * "dynamic" (the shared-table kernel branch): a multiple of 512 (the
      parse's 512-position chunks, ``pallas_parse.py:106``); with the
      sort matcher from 1024 to 65536 once padded to a power of two (a
      sort of at least 1024 keys, ``pallas_sort.py:292``, positions in
      16 bits, ``sort_match.py:68``), with the hash matcher up to
      131072.
    """
    if not isinstance(member_size, int) or member_size < 1:
        raise ValueError(f"member_size must be a positive int, got "
                         f"{member_size!r}")
    if route == "members":
        return
    if member_size > HASH_MAX_MEMBER:
        raise ValueError(f"member_size {member_size} exceeds 131072, the "
                         "hash matcher's 17-bit position packing")
    if route == "generic":
        return
    if member_size % 512:
        raise ValueError(f"member_size {member_size} is not a multiple of "
                         "512: the greedy parse works in 512-position "
                         "chunks")
    if matcher() == "sort":
        if member_size <= 512:
            raise ValueError(f"member_size {member_size}: the sort matcher "
                             "sorts at least 1024 keys a member")
        if member_size > 65536:
            raise ValueError(f"member_size {member_size} exceeds 65536, the "
                             "sort matcher's 16-bit positions (the hash "
                             "matcher, LIBFLATE_DEVICE_MATCHER=hash, takes "
                             "up to 131072)")


def _encode_knobs(options) -> dict:
    """The device knobs of a shared-table encode's ``options``;
    ValueError for an unknown matcher or a bad window."""
    if options is None:
        return {}
    matcher = getattr(options, "matcher", "greedy")
    if matcher not in ("greedy", "lazy", "chain"):
        raise ValueError(f"unknown matcher {matcher!r}")
    knobs = device_knobs(options)
    window = knobs.get("window", C.MAX_DISTANCE)
    if window % 1024 or not 1024 <= window <= C.MAX_DISTANCE:
        raise ValueError(f"window_size must be a multiple of 1024 up to "
                         f"32768, got {window}")
    return knobs


def compress(data: bytes, member_size: int = DEFAULT_MEMBER_SIZE,
             options=None, device="cuda", engine: str | None = None,
             n_threads: int = 0) -> bytes:
    """Compress into an indexed multi-member gzip stream.

    Byte-identical to the reference's device encode
    (``pgzf.compress(data, member_size, options=options, engine="tpu")``
    on its TPU kernel branches) for every ``member_size`` that encode
    takes; other sizes raise ValueError naming the reason
    (:func:`_check_member_size`).  ``options`` is an ``EncodeOptions``
    (the port's or the reference's); its ``block_type`` and ``matcher``
    choose the route, as in the reference:

    * "dynamic" (the default): the shared-table sync encode, for member
      sizes that are multiples of 512 (from 1024 to 65536 with the sort
      matcher, up to 131072 with the hash matcher).
      ``matcher="chain"`` with ``max_chain``, ``lcp_rounds``,
      ``window_size`` (a multiple of 1024 up to 32768), ``lazy`` and
      ``parse_cap`` set the device knobs; ``matcher`` "greedy" and "lazy"
      change nothing.  The candidates come from the sort matcher, or from
      the hash matcher under ``LIBFLATE_DEVICE_MATCHER=hash``; a size that
      is not a multiple of 1024 takes the match lengths from the torch
      glue rounds, without the sort matcher's exact prefix, as the
      reference's XLA LCP does.  Members are encoded in batches of 128
      sharing one Huffman code, with the LS sync index; a batch whose
      parse overflows the chunk budget (384 slots, or ``parse_cap``) is
      encoded again at 512;
    * "fixed" or "auto": the generic engine's batch encode, 128 members a
      batch, each member one block with its own code (the fixed code, or
      for "auto" whichever of fixed and its own dynamic code is smaller),
      no LS index, members up to 131072 bytes; the knobs are not read;
    * ``matcher="none"`` or ``block_type="stored"``: member by member
      through :func:`..formats.gzip.compress` on the device's engine,
      re-headed with the LF index; any member size.

    ``engine="native"`` takes the reference's ``_compress_native``
    instead: every member a raw DEFLATE body of the C library's
    ``deflate_batch`` on ``n_threads`` host threads (0: one a core), the
    same bytes whatever ``n_threads``, with the reference's matcher
    mapping: "greedy" is greedy with one candidate, "lazy" lazy with one,
    "chain" lazy over ``max_chain``-deep hash chains, and no options (or
    any other matcher) lazy over chains 128 deep; any member size.
    ``engine="serial"`` takes the reference's last route, member by
    member through :func:`..formats.gzip.compress` on the serial host
    engine, re-headed with the LF index (any member size).  ``device`` is
    not read on either.

    A coded member that is not smaller than stored blocks is written
    stored (no LS index).  Any stock gzip reader decodes the result.

    Runs on ``device`` ("cuda" unless the caller asks for "cpu", which
    runs every kernel's plain version) for ``engine`` None or "auto".
    With ``LIBFLATE_TRACE=torch`` the device routes run inside a
    ``torch.profiler`` trace written to ``LIBFLATE_TRACE_DIR``.  Raises
    ValueError for an unknown matcher, ``block_type``, ``engine`` or
    ``LIBFLATE_DEVICE_MATCHER`` value, a bad window or member size;
    RuntimeError for "cuda" without CUDA or "native" without the C
    library; DeflateError if a coded field breaks the pack invariant (an
    internal error).
    """
    data = bytes(data)
    if engine == "native":
        _check_member_size(member_size, "members")
        return _compress_native(data, member_size, options, n_threads)
    if engine == "serial":
        _check_member_size(member_size, "members")
        return _compress_members(data, member_size, options, "serial")
    if engine not in (None, "auto"):
        raise ValueError(f"pgzf.compress: engine must be None, 'auto', "
                         f"'native' or 'serial', got {engine!r}")
    dev = _device(device)
    matcher_name = (getattr(options, "matcher", "greedy") if options
                    else "greedy")
    block_type = (getattr(options, "block_type", "dynamic") if options
                  else "dynamic")
    if matcher_name == "none" or block_type == "stored":
        _check_member_size(member_size, "members")
        return _compress_members(data, member_size, options, dev.type)
    if block_type in ("fixed", "auto"):
        _check_member_size(member_size, "generic")
        with _maybe_torch_trace():
            return _compress_generic(data, member_size, block_type, dev)
    if block_type != "dynamic":
        raise ValueError(f"unknown block_type {block_type!r}")
    _check_member_size(member_size, "dynamic")
    knobs = _encode_knobs(options)
    with _maybe_torch_trace():
        return _compress_shared(data, member_size, knobs, dev)


def _compress_shared(data: bytes, member_size: int, knobs: dict,
                     dev) -> bytes:
    """The shared-table sync encode of :func:`compress`: batches of 128
    members through ``encode_batch``, then :func:`_assemble`."""
    raw = np.frombuffer(data, np.uint8)
    n_members = max(1, -(-len(raw) // member_size))
    n_batches = -(-n_members // DEV_BATCH)
    n_valid = np.zeros(n_batches * DEV_BATCH, np.int32)
    n_valid[:n_members] = np.minimum(
        member_size, len(raw) - member_size * np.arange(n_members))
    bodies: list[bytes] = []
    crcs, cnts, offs = [], [], []
    for g in range(n_batches):
        sl = slice(g * DEV_BATCH, (g + 1) * DEV_BATCH)
        rows = np.zeros((DEV_BATCH, member_size), np.uint8)
        chunk = raw[g * DEV_BATCH * member_size:
                    (g + 1) * DEV_BATCH * member_size]
        rows.reshape(-1)[:len(chunk)] = chunk
        blocks = torch.from_numpy(rows).to(dev)
        nv = torch.from_numpy(n_valid[sl]).to(dev)
        out = encode_batch(blocks, nv, SYNC_TOKENS, **knobs)
        if bool(out["overflow"].any()):
            # a literal-dense chunk blew the slot budget: its words are
            # incomplete; 512 slots always fit a 512-position chunk
            out = encode_batch(blocks, nv, SYNC_TOKENS,
                               **{**knobs, "cap": 512})
        if bool(out["wide"].any()):
            raise DeflateError(
                "internal: field width exceeds the pack kernel's "
                "slot-depth invariant (single field > 28 bits or "
                "adjacent pair > 38)")
        bits = out["bits"].cpu().numpy()
        words = out["words"].cpu().numpy().view(np.uint32)
        for i in range(min(DEV_BATCH, n_members - g * DEV_BATCH)):
            bodies.append(splice_blocks_host(words[i:i + 1],
                                             bits[i:i + 1]))
        crcs.append(crc32_from_padded_f(out["crc_f"].cpu().numpy(),
                                        n_valid[sl], member_size))
        cnts.append(out["n_tokens"].cpu().numpy())
        offs.extend(out["offsets"].cpu().numpy())
    crcs_all, cnts_all = np.concatenate(crcs), np.concatenate(cnts)
    syncs = [_sync_payload(SYNC_TOKENS, int(cnts_all[i]), offs[i])
             if int(cnts_all[i]) > 0 else None for i in range(n_members)]
    return _assemble(data, member_size, bodies, crcs_all, syncs)


def _assemble(data: bytes, member_size: int, bodies, crcs, syncs) -> bytes:
    """The indexed members: header (LF, and LS where given), body (stored
    blocks where the coded body is not smaller), CRC and ISIZE."""
    out = bytearray()
    for i, body in enumerate(bodies):
        plain = data[i * member_size:(i + 1) * member_size]
        sync_payload = syncs[i]
        stored_size = len(plain) + 5 * max(1, -(-len(plain)
                                                // C.MAX_STORED_BLOCK))
        if len(body) >= stored_size:
            # incompressible member: stored blocks beat entropy coding
            body = deflate_stored(plain)
            sync_payload = None
        out += _lf_member(body, int(crcs[i]), len(plain), sync_payload)
    return bytes(out)


def _native_matcher(options) -> tuple[bool, int]:
    """(lazy, max_chain) of the reference's native route for ``options``
    (``libflate_tpu/formats/pgzf.py:172-185``)."""
    name = getattr(options, "matcher", "") if options else ""
    if name == "chain":
        return True, getattr(options, "max_chain", 128)
    if name in ("greedy", "lazy"):
        return name == "lazy", 1
    return True, 128


def _compress_native(data: bytes, member_size: int, options,
                     n_threads: int = 0) -> bytes:
    """The reference's ``_compress_native``: the members' raw DEFLATE
    bodies and CRCs from the C library's threaded ``deflate_batch``, each
    behind an LF-indexed header (no LS index, no stored fallback)."""
    from .. import backend, native
    backend.get("native")                   # RuntimeError when unavailable
    lazy, max_chain = _native_matcher(options)
    n = len(data)
    n_members = max(1, -(-n // member_size))
    offs = np.minimum(np.arange(n_members + 1, dtype=np.uint64)
                      * np.uint64(member_size), np.uint64(n))
    bodies, crcs = native.deflate_batch(data, offs, n_threads=n_threads,
                                        lazy=lazy, max_chain=max_chain)
    return b"".join(_lf_member(body, int(crcs[i]), int(offs[i + 1] - offs[i]))
                    for i, body in enumerate(bodies))


def _compress_generic(data: bytes, member_size: int, block_type: str,
                      device) -> bytes:
    """``_compress_device``'s non-sync branch: batches of 128 members
    through the generic engine's batch encode (every member a final block;
    on the card the hash candidates, as for the reference's batch of
    128), CRCs of the right-aligned rows, no LS index."""
    raw = np.frombuffer(data, np.uint8)
    n_members = max(1, -(-len(raw) // member_size))
    n_valid = np.minimum(member_size, len(raw) - member_size * np.arange(
        n_members)).astype(np.int32)
    hash_branch = use_kernel_branches(device)
    bodies, crcs = [], []
    for s0 in range(0, n_members, DEV_BATCH):
        nv = n_valid[s0:s0 + DEV_BATCH]
        rows = np.zeros((len(nv), member_size), np.uint8)
        right = np.zeros_like(rows)
        for k, ln in enumerate(nv):
            chunk = raw[(s0 + k) * member_size:(s0 + k) * member_size + ln]
            rows[k, :ln] = chunk
            right[k, member_size - ln:] = chunk
        words, bits = encode_batch_generic(
            torch.from_numpy(rows).to(device),
            torch.from_numpy(nv).to(device), np.ones(len(nv), np.int32),
            block_type, hash_branch)
        bits = bits.cpu().numpy()
        words = words[:, :int(bits.max(initial=0) + 31) // 32].cpu(
            ).numpy().view(np.uint32)
        bodies += [splice_blocks_host(words[k:k + 1], bits[k:k + 1])
                   for k in range(len(nv))]
        crcs.append(crc32_batch(torch.from_numpy(right).to(device), nv))
    return _assemble(data, member_size, bodies, np.concatenate(crcs),
                     [None] * n_members)


def _compress_members(data: bytes, member_size: int, options,
                      engine: str) -> bytes:
    """Member by member through the gzip container on ``engine``, each
    re-headed with the LF index (``matcher="none"`` and stored blocks on
    the device's engine, and every member on ``serial``: the reference's
    route when its device encode refuses them)."""
    out = bytearray()
    for i in range(0, max(len(data), 1), member_size):
        plain = fgzip.compress(data[i:i + member_size], options=options,
                               engine=engine)
        crc, isize = struct.unpack("<II", plain[-8:])
        out += _lf_member(plain[10:-8], crc, isize)
    return bytes(out)


def decompress_to_device(data: bytes, verify: bool = False,
                         device="cuda"):
    """Decode a shared-table PGZF stream into memory on ``device``.

    Returns ``(out, lengths)``: ``out`` is a (n_members, member_cap)
    uint8 tensor, row i holding member i's plaintext in
    ``out[i, :lengths[i]]`` and zeros after it; ``lengths`` is (n_members,)
    int32.  Both live on ``device``.  ``verify=True`` checks every
    member's CRC-32, computed from the decoded rows, against its trailer.

    A stream whose every member carries the LS sync index takes the sync
    path.  Otherwise an LF-indexed stream of single dynamic blocks whose
    groups of 128 members share one code table (litlen codes of at most
    12 bits, distance codes of at most 8) takes the speculative path.
    Any other gzip stream (stdlib gzip, pigz, stored or fixed blocks,
    per-member tables) takes the foreign-stream path,
    :func:`_foreign_to_device`: a host token decode, then the same
    expansion and CRC f-values on ``device``.

    Raises ImportError for a member larger than 1 MiB, DeflateError for a
    malformed block, a member the speculative decode cannot follow, or a
    corrupt back-reference, GzipError for a CRC or size mismatch or a
    truncated trailer, ValueError for an empty stream (as the reference
    does), and RuntimeError for ``device="cuda"`` without CUDA or a failed
    build of the host token decoder.
    """
    dev = _device(device)
    data = bytes(data)
    try:
        groups = _prepare_sync_device(data, dev)
    except ImportError:
        refs = index_members(data)
        if refs is not None:
            try:
                return _spec_to_device(data, refs, verify, dev)
            except ImportError:
                pass
        return _foreign_to_device(data, verify, refs, dev)[:2]
    plains, lens = [], []
    for prep in groups:
        plain, n_out, err, crc_f = _run_sync_chain(prep)
        if bool(err.any()):
            raise DeflateError("bad back-reference in device expansion")
        if verify:
            crcs = crc32_from_padded_f(crc_f.cpu().numpy(), prep["isizes"],
                                       prep["member_cap"])
            for i in range(len(crcs)):
                if int(crcs[i]) != int(prep["crcs_expected"][i]):
                    raise fgzip.GzipError(
                        f"gzip CRC mismatch in member "
                        f"{prep['member0'] + i}")
        plains.append(plain)
        lens.append(prep["isizes"])
    lengths = torch.from_numpy(np.concatenate(lens).astype(np.int32)).to(dev)
    if len(plains) == 1:
        return plains[0], lengths
    cap = max(p.shape[1] for p in plains)
    return (torch.cat([torch.nn.functional.pad(p, (0, cap - p.shape[1]))
                       for p in plains]), lengths)


def _member_trailers(data: bytes, refs: list[MemberRef]):
    """(expected CRCs (B,) uint32, ISIZEs (B,) int64) from the trailers."""
    crcs = np.zeros((len(refs),), np.uint32)
    isizes = np.zeros((len(refs),), np.int64)
    for i, ref in enumerate(refs):
        crcs[i], isizes[i] = struct.unpack_from("<II", data, ref.end - 8)
    return crcs, isizes


def _member_syncs(data: bytes, refs: list[MemberRef]) -> list:
    """Each member's parsed LS index, None where it has none."""
    return [_parse_sync(fgzip.Header.decode(data, r.start)[0])
            for r in refs]


def _prepare_sync_device(data: bytes, device) -> list[dict]:
    """Host-side staging for the device decode chain of a stream whose
    every member is sync-decodable: contiguous groups sharing one code
    table and chunk size (:func:`_stage_sync_groups`).  Raises
    ImportError if ANY member is not sync-decodable."""
    refs = index_members(data)
    if not refs:
        raise ImportError("no member index")
    crcs_all, isizes_all = _member_trailers(data, refs)
    syncs = _member_syncs(data, refs)
    if any(s is None for s in syncs):
        raise ImportError("stream is not fully sync-indexed")

    lit_ls, dist_ls, starts64, flags = parse_block_headers(
        [data[r.body:r.end - 8] for r in refs])
    if not ((flags == 5).all() and int(lit_ls.max()) <= 12
            and int(dist_ls.max()) <= 8):
        raise ImportError("not a sync-decodable shared-table stream")
    if any(int(s[2]) != int(b) for s, b in zip(syncs, starts64)):
        raise ImportError("sync index disagrees with block header")

    # contiguous groups with identical tables and chunk size
    bounds = [0]
    for i in range(1, len(refs)):
        if not _same_sync_group(i, bounds[-1], lit_ls, dist_ls, syncs):
            bounds.append(i)
    bounds.append(len(refs))
    return _stage_sync_groups(
        data, refs, [list(range(g0, g1)) for g0, g1 in
                     zip(bounds[:-1], bounds[1:])],
        syncs, lit_ls, dist_ls, isizes_all, crcs_all, device)


def _same_sync_group(i: int, j: int, lit_ls, dist_ls, syncs) -> bool:
    """Members i and j share their code lengths and chunk size."""
    return bool((lit_ls[i] == lit_ls[j]).all()
                and (dist_ls[i] == dist_ls[j]).all()
                and syncs[i][0] == syncs[j][0])


def _stage_sync_groups(data: bytes, refs: list[MemberRef],
                       groups: list[list[int]], syncs, lit_ls, dist_ls,
                       isizes, crcs, device) -> list[dict]:
    """Stage each group of sync-decodable members for one sync decode.

    Member j of a group gets the chunk slots ``[j*max_nc, (j+1)*max_nc)``
    (padding slots decode 0 tokens), so the token rows come out
    member-major.  The stream goes to the device once, as words; each
    slot carries its absolute start bit.  A group also keeps the
    reference's staging depth ``d_words`` for the debug form.  Raises
    ImportError for a corrupt or empty LS index.
    """
    member_cap = int(max((isizes[i] for g in groups for i in g), default=1))
    member_cap = 1 << max(10, (max(member_cap, 1) - 1).bit_length())
    words = stream_words(data, device)
    out = []
    for group in groups:
        bsz = len(group)
        k_tok = syncs[group[0]][0]
        spans = [_chunk_spans(syncs[i], refs[i]) for i in group]
        max_nc = max(len(sp[0]) for sp in spans)
        start_bits = np.zeros((bsz * max_nc,), np.int64)
        counts = np.zeros((bsz * max_nc,), np.int32)
        for j, (i, (starts, _ends, counts_i)) in enumerate(
                zip(group, spans)):
            s0 = j * max_nc
            start_bits[s0:s0 + len(starts)] = refs[i].body * 8 + starts
            counts[s0:s0 + len(starts)] = counts_i
        d_words = staged_words(
            np.concatenate([refs[i].body * 8 + sp[0]
                            for i, sp in zip(group, spans)]),
            np.concatenate([refs[i].body * 8 + sp[1]
                            for i, sp in zip(group, spans)]))
        rb = max(int(np.max(lit_ls[group[0]][:C.MAX_LITLEN_SYMBOLS])), 7)
        out.append({
            "words": words,
            "start_bits": torch.from_numpy(start_bits).to(device),
            "counts": torch.from_numpy(counts).to(device),
            "lit_t": decode_table(lit_ls[group[0]][:C.MAX_LITLEN_SYMBOLS],
                                  rb, device),
            "dist_t": decode_table(dist_ls[group[0]], 8, device),
            "k_tok": k_tok, "root_bits": rb, "d_words": d_words,
            "bsz": bsz, "max_nc": max_nc, "member_cap": member_cap,
            "n_tokens": torch.tensor([int(syncs[i][1]) for i in group],
                                     dtype=torch.int32, device=device),
            "isizes": isizes[group],
            "crcs_expected": crcs[group],
            "member0": group[0], "members": group,
        })
    return out


def _run_sync_chain(prep: dict):
    """The device decode chain after staging: sync decode -> expansion ->
    CRC f-values.  Returns (plain, n_out, err, crc_f) on the group's
    device."""
    toks = sync_decode(prep["words"], prep["start_bits"], prep["counts"],
                       prep["lit_t"], prep["dist_t"], prep["k_tok"],
                       root_bits=prep["root_bits"], debug=False)
    return _sync_to_plain(toks, prep["bsz"], prep["max_nc"], prep["k_tok"],
                          prep["n_tokens"], prep["member_cap"])


def _sync_to_plain(toks, bsz: int, max_nc: int, k_tok: int, n_tokens,
                   member_cap: int):
    """Slot-major tokens -> plaintext rows, error flags and CRC f-values.
    Member j's slots are contiguous, so its token row is a view."""
    packed = toks.view(bsz, max_nc * k_tok)
    plain, n_out, err = expand_members(packed, n_tokens, member_cap)
    return plain, n_out, err, crc32_f_rows(plain)


#: largest foreign member the device expansion takes; larger members
#: raise ImportError (callers take a host decoder)
_FOREIGN_MEMBER_CAP = 1 << 20


def _foreign_to_device(data: bytes, verify: bool,
                       refs: list[MemberRef] | None, device,
                       truncated=fgzip.GzipError):
    """decompress_to_device for foreign streams: members with their own
    dynamic, fixed or stored blocks, with or without the LF index, from
    any writer (stdlib gzip, pigz, the port's own stored members).

    The entropy decode runs on the host, in the port's C token decoder
    (:mod:`..native`): LF-indexed members as one threaded batch, others
    one at a time, each member's extent taken from its end bit.  The
    tokens then go through the sync path's expansion and CRC f-values on
    ``device``.  Output shapes follow the reference's rule: tokens padded
    to a multiple of 1024, rows to a power of two of at least 1024.
    Returns (rows, (B,) int32 lengths, the trailers' CRCs); an
    un-indexed member without its trailer raises ``truncated``.
    """
    packed, nt, sizes, crcs_expected, out_cap = _foreign_tokens(
        data, refs, truncated)
    plain, _n_out, err = expand_members(torch.from_numpy(packed).to(device),
                                        torch.from_numpy(nt).to(device),
                                        out_cap)
    if bool(err.any()):
        raise DeflateError("bad back-reference in device expansion")
    if verify:
        crcs = crc32_from_padded_f(crc32_f_rows(plain).cpu().numpy(),
                                   np.asarray(sizes, np.int64), out_cap)
        for i in range(len(sizes)):
            if int(crcs[i]) != int(crcs_expected[i]):
                raise fgzip.GzipError(f"gzip CRC mismatch in member {i}")
    return plain, torch.from_numpy(np.asarray(sizes, np.int64).astype(
        np.int32)).to(device), crcs_expected


def _foreign_tokens(data: bytes, refs: list[MemberRef] | None,
                    truncated=fgzip.GzipError):
    """The host half of :func:`_foreign_to_device`: (packed (B, t_cap)
    int32 tokens, n_tokens (B,) int32, sizes, expected CRCs) of every
    member, from the trailers and the C token decoder, and the width of
    the plaintext rows, out_cap.  An un-indexed member without its
    trailer raises ``truncated`` (the reference's ``_foreign_to_device``
    raises GzipError there, its host decoder EOFError)."""
    from .. import native

    if refs is not None:
        # indexed: extents are known, so the token decode runs threaded
        sizes, crcs_expected = [], []
        for ref in refs:
            c, s = struct.unpack_from("<II", data, ref.end - 8)
            sizes.append(s)
            crcs_expected.append(c)
        if max(sizes, default=0) > _FOREIGN_MEMBER_CAP:
            raise ImportError("foreign member too large for the "
                              "device expansion footprint")
        t_cap = max(1024, -(-max(max(sizes), 1) // 1024) * 1024)
        packed, counts, osz = native.inflate_tokens_batch(
            data, [r.body for r in refs], [r.end - 8 for r in refs], t_cap)
        if (osz.astype(np.int64) != np.asarray(sizes)).any():
            raise fgzip.GzipError("gzip ISIZE mismatch")
        return (packed, counts.astype(np.int32), sizes, crcs_expected,
                _foreign_out_cap(sizes))
    # un-indexed: extents come from the token decoder's end bit
    sizes, crcs_expected, toks_l = [], [], []
    pos = 0
    while pos < len(data):
        _hdr, body = fgzip.Header.decode(data, pos)
        cap = 1 << 17
        while True:
            r = native.inflate_tokens(data, body, cap)
            if r is not None:
                break
            cap *= 4
            if cap > (len(data) - body) * 9 + 4096:
                raise DeflateError("token decode cap overrun")
        toks, osize, eb = r
        end_byte = body + (eb + 7) // 8
        if end_byte + 8 > len(data):
            raise truncated("truncated gzip member (missing trailer)")
        crc_exp, isize = struct.unpack_from("<II", data, end_byte)
        if isize != (osize & 0xFFFFFFFF):
            raise fgzip.GzipError(
                f"gzip ISIZE mismatch in member {len(sizes)}")
        if osize > _FOREIGN_MEMBER_CAP:
            raise ImportError("foreign member too large for the "
                              "device expansion footprint")
        sizes.append(osize)
        crcs_expected.append(crc_exp)
        toks_l.append(toks)
        pos = end_byte + 8
    if not toks_l:
        raise ImportError("empty stream")
    t_cap = max(1024, -(-max(len(t) for t in toks_l) // 1024) * 1024)
    packed = np.zeros((len(toks_l), t_cap), np.int32)
    nt = np.zeros((len(toks_l),), np.int32)
    for i, t in enumerate(toks_l):
        packed[i, :len(t)] = t
        nt[i] = len(t)
    return packed, nt, sizes, crcs_expected, _foreign_out_cap(sizes)


def _foreign_out_cap(sizes: list[int]) -> int:
    """The reference's row width: a power of two of at least 1024 that
    holds the largest member."""
    return 1 << max(10, (max(max(sizes), 1) - 1).bit_length())


def _spec_to_device(data: bytes, refs: list[MemberRef], verify: bool,
                    device):
    """decompress_to_device for shared-table streams without the LS
    index: speculative decode to tokens (:func:`_spec_token_groups`),
    then the sync path's expansion and CRC f-values."""
    crcs_expected, isizes = _member_trailers(data, refs)
    plains, lens = [], []
    for packed, nt, group, cap in _spec_token_groups(data, refs, device):
        plain, _n_out, err = expand_members(packed, nt, cap)
        if bool(err.any()):
            raise DeflateError("bad back-reference in device expansion")
        if verify:
            crcs = crc32_from_padded_f(crc32_f_rows(plain).cpu().numpy(),
                                       isizes[group], cap)
            for k, i in enumerate(group):
                if int(crcs[k]) != int(crcs_expected[i]):
                    raise fgzip.GzipError(f"gzip CRC mismatch in member {i}")
        plains.append(plain)
        lens.append(isizes[group])
    lengths = torch.from_numpy(np.concatenate(lens).astype(np.int32)).to(
        device)
    return (plains[0] if len(plains) == 1 else torch.cat(plains)), lengths


def _spec_groups(data: bytes, refs: list[MemberRef], device):
    """Host-side staging of the speculative decode, one group of 128
    members at a time.

    Every member must be one final dynamic block with litlen codes of at
    most 12 bits and distance codes of at most 8, and the members of a
    group ``[g0, g0 + 128)`` must share their code lengths; else
    ImportError (raised for a group only when it is reached, as the
    reference does).  Each member's body goes to its own row of words,
    zero-padded to ``w`` words, ``w`` set by the stream's largest body;
    its 512-bit chunk grid starts at body bit 0.  Yields dicts with the
    group's ``words`` (B, w) int32, ``lit_t`` / ``dist_t``, ``starts``
    (B,) int32 (the first symbol's bit), member indices ``group`` and
    ``out_cap``.
    """
    bodies = [data[r.body:r.end - 8] for r in refs]
    isizes = np.array([struct.unpack_from("<I", data, r.end - 4)[0]
                       for r in refs], np.int64)
    out_cap = 1 << max(10, (int(isizes.max(initial=1)) - 1).bit_length())
    lit_ls, dist_ls, starts64, flags = parse_block_headers(bodies)
    if not (flags == (1 | (C.BTYPE_DYNAMIC << 1))).all():
        raise ImportError("non-uniform member layout")
    if int(lit_ls.max()) > 12 or int(dist_ls.max()) > 8:
        raise ImportError("code lengths exceed the 12/8-bit roots")
    # the reference's W = 4 (mod 64), P = 32W - 128 (a multiple of 2048)
    w = max(len(b) for b in bodies) // 4 + 8
    w = ((w - 4 + 63) // 64) * 64 + 4
    for g0 in range(0, len(refs), DEV_BATCH):
        group = list(range(g0, min(g0 + DEV_BATCH, len(refs))))
        if not ((lit_ls[group] == lit_ls[g0]).all()
                and (dist_ls[group] == dist_ls[g0]).all()):
            raise ImportError("tables differ within a group")
        words = np.zeros((len(group), 4 * w), np.uint8)
        for k, i in enumerate(group):
            words[k, :len(bodies[i])] = np.frombuffer(bodies[i], np.uint8)
        yield {
            "words": torch.from_numpy(words.view("<i4")).to(device),
            "lit_t": decode_table(lit_ls[g0], 12, device),
            "dist_t": decode_table(dist_ls[g0], 8, device),
            "starts": torch.from_numpy(starts64[group].astype(np.int32)).to(
                device),
            "group": group, "out_cap": out_cap,
        }


def _spec_chain(words, lit_t, dist_t, starts, out_cap: int):
    """The speculative kernels after staging: position decode -> chunk
    exits -> chain entries -> walk -> compaction.  Returns (packed (B,
    out_cap + 2), n_tokens (B,), err (B,)) on the group's device."""
    tok, nxt = speculative_decode_positions(words, lit_t, dist_t)
    entries = chain_entries(chunk_exit_maps(nxt), starts)
    return tokens_from_emit_packed(walk_emit(nxt, tok, entries), out_cap + 2)


def _spec_token_groups(data: bytes, refs: list[MemberRef], device):
    """Speculative shared-table decode to device tokens, per group of 128
    members.  Yields (packed (B, out_cap + 2) int32, n_tokens (B,),
    member indices, out_cap).  Raises ImportError when the stream does
    not fit the kernels and DeflateError naming the first member of a
    group whose decode failed."""
    for st in _spec_groups(data, refs, device):
        packed, nt, err = _spec_chain(st["words"], st["lit_t"],
                                      st["dist_t"], st["starts"],
                                      st["out_cap"])
        bad = np.flatnonzero(err.cpu().numpy())
        if len(bad):
            raise DeflateError(f"speculative decode failed in member "
                               f"{st['group'][int(bad[0])]}")
        yield packed, nt, st["group"], st["out_cap"]


def decompress(data: bytes, verify: bool = True, device="cuda",
               engine: str | None = None, n_threads: int = 0) -> bytes:
    """Decompress a gzip stream on ``device`` and return its plaintext.

    The counterpart of the reference's ``decompress`` on its device
    branches, tried in its order: an LF-indexed stream takes the sync
    branch (members with the LS index; unless ``LIBFLATE_NO_SYNC`` is
    set, read at each call), then the shared-table speculative branch
    (unless ``LIBFLATE_NO_SPEC``), then the generic branch (each member's
    own tables: members that are one final dynamic or fixed block decode
    with ``decode_symbols`` on the card).  A branch that cannot take the
    stream raises ImportError, and the next one tries; a stream without
    the LF index, or one none of them takes, goes through the
    foreign-stream path (host token decode, device expansion).  Members
    a branch cannot take decode by the foreign token decode too.  A
    stream with a member larger than the foreign path's 1 MiB ends in the
    reference's last route: :func:`..formats.gzip.decompress` with
    ``multi=True`` on the device's engine (``ops/deflate_decode.
    inflate_device``, a block at a time), which verifies every CRC
    whatever ``verify`` says.

    ``verify=True`` checks every member's CRC-32: from CRC f-values of
    the device rows, and with zlib's CRC on members that the foreign
    token decode read.  With ``LIBFLATE_DEBUG_CHECKS=1`` the sync branch
    runs the kernel's debug-checks form and raises DeflateError if a
    chunk's cursor left the window the reference would have staged.

    ``engine="native"`` takes the reference's host routes in its order:
    the C library walks the LF index and decodes every member in place on
    ``n_threads`` host threads (0: one a core), CRCs checked when
    ``verify``; a stream the walk refuses but the Python index takes
    decodes by the library's ``inflate_batch``; a stream without the LF
    index by :func:`..formats.gzip.decompress` with ``multi=True`` on the
    ``native`` engine.  ``engine="serial"`` takes the reference's route for
    the serial engine: :func:`..formats.gzip.decompress` with
    ``multi=True``, every CRC verified.  ``device`` is not read on either.

    ``LIBFLATE_TRACE`` set to "torch" runs the sync branch inside a
    ``torch.profiler`` trace written to ``LIBFLATE_TRACE_DIR``
    (``libflate_trace`` under the temp directory, ``TMPDIR``, by
    default); any other non-empty value prints the sync branch's stage
    times to stderr.

    Raises DeflateError for a malformed or corrupt member (an invalid
    Huffman code, a bad back-reference), GzipError for a CRC or size
    mismatch or a truncated trailer, EOFError for a stream cut inside a
    body, ValueError for an empty stream or an unknown ``engine``, and
    RuntimeError for ``device="cuda"`` without CUDA or "native" without
    the C library.
    """
    data = bytes(data)
    if engine == "native":
        return _decompress_native_routes(data, verify, n_threads)
    if engine == "serial":
        return fgzip.decompress(data, engine="serial", multi=True)
    if engine not in (None, "auto"):
        raise ValueError(f"pgzf.decompress: engine must be None, 'auto', "
                         f"'native' or 'serial', got {engine!r}")
    dev = _device(device)
    refs = index_members(data)
    if refs is not None:
        if not os.environ.get("LIBFLATE_NO_SYNC"):
            try:
                with _maybe_torch_trace():
                    return _decompress_sync(data, refs, verify, dev)
            except ImportError:
                pass
        if not os.environ.get("LIBFLATE_NO_SPEC"):
            try:
                return _decompress_shared(data, refs, verify, dev)
            except ImportError:
                pass
        try:
            return _decompress_generic(data, refs, verify, dev)
        except ImportError:
            pass
    try:
        return _decompress_foreign(data, refs, verify, dev)
    except ImportError:
        # a member past the device expansion's 1 MiB: the gzip container
        # on the device's engine, a block at a time
        return fgzip.decompress(data, engine=dev.type, multi=True)


def _decompress_native_routes(data: bytes, verify: bool,
                              n_threads: int) -> bytes:
    """``decompress(engine="native")``: the reference's three host routes
    (``libflate_tpu/formats/pgzf.py:465-493``, ``:515-537``)."""
    from .. import backend, native
    backend.get("native")                   # RuntimeError when unavailable
    idx = native.pgzf_index(data)
    if idx is not None:
        # the C walk of the LF index, the bodies decoded in place
        starts, ends, crcs_expected, isizes = idx
        out, crcs = native.inflate_batch_at(data, starts, ends, isizes,
                                            n_threads=n_threads)
    else:
        refs = index_members(data)
        if refs is None:
            return fgzip.decompress(data, engine="native", multi=True)
        bodies = b"".join(data[r.body:r.end - 8] for r in refs)
        offs = np.zeros(len(refs) + 1, np.uint64)
        np.cumsum([r.end - 8 - r.body for r in refs], out=offs[1:])
        crcs_expected, isizes = _member_trailers(data, refs)
        out, crcs = native.inflate_batch(bodies, offs, isizes,
                                         n_threads=n_threads)
    if verify and (crcs != crcs_expected).any():
        bad = int(np.argmax(crcs != crcs_expected))
        raise fgzip.GzipError(
            f"gzip CRC mismatch in member {bad}: stream says "
            f"{int(crcs_expected[bad]):#010x}, computed "
            f"{int(crcs[bad]):#010x}")
    return out


def _join_rows(n_members: int, parts, device):
    """One device-to-host copy of every member's plaintext.

    ``parts``: (member indices, (b, cap) uint8 rows on ``device``, (b,)
    int64 lengths).  Returns (the members' bytes joined in member order,
    (n_members + 1,) int64 offsets of each member in them)."""
    lens = np.zeros((n_members,), np.int64)
    for ids, _rows, ln in parts:
        lens[ids] = ln
    offs = np.zeros((n_members + 1,), np.int64)
    np.cumsum(lens, out=offs[1:])
    if not parts:
        return b"", offs
    if len(parts) == 1 and list(parts[0][0]) == list(range(n_members)):
        rows = parts[0][1]
    else:
        rows = torch.zeros((n_members, max(p[1].shape[1] for p in parts)),
                           dtype=torch.uint8, device=device)
        for ids, part, _ln in parts:
            rows[torch.as_tensor(ids, device=device),
                 :part.shape[1]] = part
    live = (torch.arange(rows.shape[1], device=device)[None, :]
            < torch.from_numpy(lens).to(device)[:, None])
    return rows[live].cpu().numpy().tobytes(), offs


def _check_crcs(rows, lens, crcs_expected, ids, cap: int) -> None:
    """GzipError naming the first member whose row's CRC-32 (from its
    f-value) differs from its trailer."""
    got = crc32_from_padded_f(crc32_f_rows(rows).cpu().numpy(),
                              np.asarray(lens, np.int64), cap)
    for k, i in enumerate(ids):
        if int(got[k]) != int(crcs_expected[k]):
            raise fgzip.GzipError(f"gzip CRC mismatch in member {i}")


def _check_host_crcs(out: bytes, offs, crcs_expected, ids) -> None:
    """GzipError naming the first of the foreign-decoded members ``ids``
    whose zlib CRC-32 differs from its trailer."""
    view = memoryview(out)
    for i in ids:
        if zlib.crc32(view[offs[i]:offs[i + 1]]) != int(crcs_expected[i]):
            raise fgzip.GzipError(f"gzip CRC mismatch in member {i}")


def _host_rows(data: bytes, refs: list[MemberRef], ids, device):
    """Members ``ids`` through the foreign token decode (the host C
    decoder) and the device expansion: ((b, cap) uint8 rows, (b,) int64
    decoded sizes).  DeflateError for a malformed body, ImportError for
    a member past the expansion's 1 MiB."""
    from .. import native
    bodies = [(refs[i].body, refs[i].end - 8) for i in ids]
    # a token takes at least one bit
    t_cap = max(1024, -(-max(8 * (e - b) + 8 for b, e in bodies)
                        // 1024) * 1024)
    packed, counts, osz = native.inflate_tokens_batch(
        data, [b for b, _ in bodies], [e for _, e in bodies], t_cap)
    sizes = osz.astype(np.int64)
    if int(sizes.max()) > _FOREIGN_MEMBER_CAP:
        raise ImportError("foreign member too large for the device "
                          "expansion footprint")
    rows, _n, err = expand_members(
        torch.from_numpy(packed).to(device),
        torch.from_numpy(counts.astype(np.int32)).to(device),
        _foreign_out_cap([int(x) for x in sizes]))
    if bool(err.any()):
        raise DeflateError(f"bad back-reference in member "
                           f"{ids[int(np.argmax(err.cpu().numpy()))]}")
    return rows, sizes


def _decompress_foreign(data: bytes, refs, verify: bool, device) -> bytes:
    """The foreign-stream path to bytes: :func:`_foreign_to_device`, one
    copy back, zlib's CRC.  A missing trailer raises EOFError, as the
    reference's host decoder does."""
    rows, lengths, crcs = _foreign_to_device(data, False, refs, device,
                                             truncated=EOFError)
    n = len(crcs)
    out, offs = _join_rows(n, [(range(n), rows, lengths.cpu().numpy())],
                           device)
    if verify:
        _check_host_crcs(out, offs, crcs, range(n))
    return out


def _decompress_sync(data: bytes, refs: list[MemberRef], verify: bool,
                     device) -> bytes:
    """The sync branch (``_decompress_sync_device``): members with an LS
    index, one final dynamic block, codes of at most 12 / 8 bits and a
    first bit that matches the header decode with the sync kernel, a
    launch per group of consecutive such members sharing tables and K;
    the others through the foreign token decode.  ImportError before any
    decode when no member qualifies, or for a corrupt LS index.  With
    ``LIBFLATE_TRACE`` set, each stage is timed (ending when the card is
    done) and the report goes to stderr."""
    timer = _tracer()
    n = len(refs)
    with _maybe_stage(timer, "header+ls parse"):
        crcs, isizes = _member_trailers(data, refs)
        syncs = _member_syncs(data, refs)
    if not any(s is not None for s in syncs):
        raise ImportError("no sync index present")
    with _maybe_stage(timer, "block headers"):
        lit_ls, dist_ls, starts64, flags = parse_block_headers(
            [data[r.body:r.end - 8] for r in refs])
    device_ok = np.array(
        [s is not None and flags[i] == 1 | (C.BTYPE_DYNAMIC << 1)
         and int(lit_ls[i].max()) <= 12 and int(dist_ls[i].max()) <= 8
         and int(s[1]) > 0 and int(s[2]) == int(starts64[i])
         for i, s in enumerate(syncs)], bool)
    dev_idx = [int(i) for i in np.flatnonzero(device_ok)]
    if not dev_idx:
        raise ImportError("no sync-decodable members")
    host_idx = [int(i) for i in np.flatnonzero(~device_ok)]
    parts = []
    if host_idx:
        with _maybe_stage(timer, "host members", device):
            rows, sizes = _host_rows(data, refs, host_idx, device)
        parts.append((host_idx, rows, sizes))

    groups: list[list[int]] = []
    for i in dev_idx:
        if groups and _same_sync_group(i, groups[-1][0], lit_ls, dist_ls,
                                       syncs):
            groups[-1].append(i)
        else:
            groups.append([i])
    debug = debug_checks()
    with _maybe_stage(timer, "host staging", device):
        preps = _stage_sync_groups(data, refs, groups, syncs, lit_ls,
                                   dist_ls, isizes, crcs, device)
    for prep in preps:
        with _maybe_stage(timer, "sync kernel", device):
            toks = sync_decode(prep["words"], prep["start_bits"],
                               prep["counts"], prep["lit_t"],
                               prep["dist_t"], prep["k_tok"],
                               root_bits=prep["root_bits"], debug=debug,
                               d_words=prep["d_words"])
        if debug:
            marked = ((toks & DEBUG_POISON) != 0).any(dim=1)
            if bool(marked.any()):
                raise DeflateError(
                    f"sync kernel invariant violated (cursor escaped its "
                    f"staged window) in chunk slot "
                    f"{int(torch.argmax(marked.to(torch.int8)))} — corrupt "
                    f"LS index or bitstream")
        with _maybe_stage(timer, "expand+crc", device):
            plain, n_out, err, crc_f = _sync_to_plain(
                toks, prep["bsz"], prep["max_nc"], prep["k_tok"],
                prep["n_tokens"], prep["member_cap"])
            bad = err.cpu().numpy() | (n_out.cpu().numpy()
                                       != prep["isizes"])
            if bad.any():
                raise DeflateError(f"token expansion failed in member "
                                   f"{prep['members'][int(np.argmax(bad))]}")
            if verify:
                got = crc32_from_padded_f(crc_f.cpu().numpy(),
                                          prep["isizes"], prep["member_cap"])
                for k, i in enumerate(prep["members"]):
                    if int(got[k]) != int(prep["crcs_expected"][k]):
                        raise fgzip.GzipError(
                            f"gzip CRC mismatch in member {i}")
        parts.append((prep["members"], plain, prep["isizes"]))

    with _maybe_stage(timer, "D2H join", device):
        out, offs = _join_rows(n, parts, device)
    if verify and host_idx:
        with _maybe_stage(timer, "host members crc"):
            for i in host_idx:
                if offs[i + 1] - offs[i] != int(isizes[i]):
                    raise fgzip.GzipError(
                        f"gzip ISIZE mismatch in member {i}")
            _check_host_crcs(out, offs, crcs, host_idx)
    _trace_report(timer, "sync decode")
    return out


def _decompress_shared(data: bytes, refs: list[MemberRef], verify: bool,
                       device) -> bytes:
    """The shared-table branch (``_decompress_shared_device``):
    :func:`_spec_to_device` and one copy back.  ImportError where the
    speculative decode cannot take the stream."""
    rows, lengths = _spec_to_device(data, refs, verify, device)
    n = len(refs)
    return _join_rows(n, [(range(n), rows, lengths.cpu().numpy())],
                      device)[0]


def _decompress_generic(data: bytes, refs: list[MemberRef], verify: bool,
                        device) -> bytes:
    """The generic branch (``_decompress_device``): every member that is
    one final dynamic or fixed block decodes with its own tables (built
    once for each distinct set of code lengths) in one ``decode_symbols``
    launch (``max_tokens = out_cap + 2``) and one expansion; the others
    through the foreign token decode.  ImportError
    when a body exceeds the reference's word budget (``out_cap // 4 +
    512`` words a row)."""
    n = len(refs)
    crcs, isizes = _member_trailers(data, refs)
    bodies = [data[r.body:r.end - 8] for r in refs]
    max_body = max((len(b) for b in bodies), default=0)
    lit_ls, dist_ls, starts64, flags = parse_block_headers(bodies)
    device_ok = ((flags == 1 | (C.BTYPE_DYNAMIC << 1))
                 | (flags == 1 | (C.BTYPE_FIXED << 1)))
    host_idx = [int(i) for i in np.flatnonzero(~device_ok)]
    parts = []
    if host_idx:
        rows, sizes = _host_rows(data, refs, host_idx, device)
        for k, i in enumerate(host_idx):
            if int(sizes[k]) != int(isizes[i]):
                raise fgzip.GzipError(f"gzip ISIZE mismatch in member {i}")
        parts.append((host_idx, rows, sizes))

    out_cap = int(isizes.max(initial=1)) or 1
    out_cap = 1 << max(8, (out_cap - 1).bit_length())
    n_words = out_cap // 4 + 512
    if max_body > 4 * (n_words - 2):
        raise ImportError("member body exceeds device word budget")
    dev_idx = [int(i) for i in np.flatnonzero(device_ok)]
    if dev_idx:
        words = np.zeros((len(dev_idx), 4 * n_words), np.uint8)
        for k, i in enumerate(dev_idx):
            words[k, :len(bodies[i])] = np.frombuffer(bodies[i], np.uint8)
        # members with equal code lengths share one pair of tables
        uniq, inv = np.unique(np.concatenate(
            [lit_ls[dev_idx], dist_ls[dev_idx]], axis=1), axis=0,
            return_inverse=True)
        lit_t, dist_t = tables_from_lengths(
            torch.from_numpy(uniq[:, :lit_ls.shape[1]]).to(device),
            torch.from_numpy(uniq[:, lit_ls.shape[1]:]).to(device))
        a, b, nt, _end, err = decode_symbols(
            torch.from_numpy(words.view("<i4")).to(device),
            torch.from_numpy(starts64[dev_idx].astype(np.int32)).to(device),
            lit_t, dist_t, out_cap + 2,
            table_idx=torch.from_numpy(
                inv.reshape(-1).astype(np.int32)).to(device))
        del lit_t, dist_t
        err_np = err.cpu().numpy()
        if err_np.any():
            raise DeflateError(f"invalid Huffman code in member "
                               f"{dev_idx[int(np.argmax(err_np))]}")
        plain, n_out, xerr = expand_members(a | b << 9, nt, out_cap)
        del a, b
        xerr_np = xerr.cpu().numpy()
        if xerr_np.any():
            raise DeflateError(f"bad back-reference in member "
                               f"{dev_idx[int(np.argmax(xerr_np))]}")
        n_out_np = n_out.cpu().numpy()
        for k, i in enumerate(dev_idx):
            if int(n_out_np[k]) != int(isizes[i]):
                raise fgzip.GzipError(
                    f"gzip ISIZE mismatch in member {i}: "
                    f"{int(isizes[i])} != {int(n_out_np[k])}")
        if verify:
            _check_crcs(plain, isizes[dev_idx], crcs[dev_idx], dev_idx,
                        out_cap)
        parts.append((dev_idx, plain, isizes[dev_idx]))
    out, offs = _join_rows(n, parts, device)
    if verify and host_idx:
        _check_host_crcs(out, offs, crcs, host_idx)
    return out
