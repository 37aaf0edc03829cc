#!/usr/bin/env python3
"""Run the PyTorch port's main paths once on one CUDA card and check them.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):

1. environment: card name and power limit, torch / CUDA / nvcc versions;
   no CUDA means exit 1 before anything runs;
2. build the thirteen CUDA sources from ``libflate_tpu_torch/csrc`` with
   one nvcc per source, all at once, for sm_90a, and the native host
   library (``libflate_tpu_torch/native/libflate_native.cpp``) with g++;
   print the checksum kernels' registers, shared memory and resident
   blocks (``checksum.kernel_info``), the sort
   matcher's and the parse's registers, shared memory and resident
   clusters / blocks at n = 65536, and the rank's, the pack's, the
   histogram's, the token fields', the two-table gather's (windows 16
   and 128), the resolve's, the hash matcher's (at n = 65536), the
   LCP's (at n = 65536, windows 32768 and 8192), the speculative position
   decode's, chunk exits' and walk's and (at the shard's root bits) the
   sync decode's;
3. decode input: ``tests/data/pgzf_sync_zipf_2m.pgz`` repeated 32 times,
   a 64 MiB-plaintext shard of 1024 sync-indexed 64 KiB members; stdlib
   gzip is the oracle; the host staging time is printed;
4. each decode kernel against its plain PyTorch version on the card, at
   the shard's own shapes: tokens, (src, lit) and bytes must be identical;
   the rank kernel's inputs and outputs are kept on the host, and after
   5d, 5g, 8, 9's timings and 9's launches alone the run fails, naming
   the phase, if any of them changed (a launch wrote outside its outputs);
   4b. the speculative decode's four kernels against their plain versions
   on the first group (128 members) of the shard with its LS index
   stripped (``strip_sync_index``), at the main path's shapes, and
   ``gather_two`` (on no path) at B = 128, R = N = 512, bit-exact;
5. the decode main path ``decompress_to_device(verify=True,
   device="cuda")``, counted: plaintext equal to the oracle, every
   member's CRC checked, and each decode kernel's launch count above 0;
   the CRC f-values kernel (``checksum.crc32_f_rows``) counted on this
   path and on 5b, 5c and 7;
   5b. the speculative main path: the stripped shard through the same
   call, counted: each speculative kernel once per group of 128 members
   (8), the sync kernel never, rows equal to the sync path's and gzip's;
   5c. the foreign-stream path, counted: the 64 MiB plaintext cut into
   1024 members of 64 KiB, each written by stdlib ``gzip.compress``
   (per-member dynamic tables, no index: walked by end bits), and the
   committed ``pgzf_encode_small.pgz`` (LF-indexed, stored members 130-133:
   one threaded batch), each equal to ``gzip.decompress`` with every CRC
   checked; rank, resolve and the CRC launched, the sync and speculative
   kernels
   not;
   5d. ``decode_symbols`` (the generic decode, ``csrc/inflate.cu``)
   against its plain version, all five outputs bit-identical, on
   ``decode_hard_cases`` (a table hole, an incomplete code, the fixed
   code's 286 / 287, an empty final block, streams cut at max_tokens,
   start bits off the word, random words under any-int32 tables, tables
   past the kernel's on-chip subtable area) and on 64 members of the
   generic shard (the 64 MiB as 1024 LF-indexed members of zlib level-9
   bodies) at full width; its ``kernel_info`` (no spills, at least 8
   streams an SM); how many of the 1024 members' tables pass the
   kernel's on-chip subtable slots;
   5e. the sync kernel's debug-checks form against its plain version on
   the decode shard (no mark, the default kernel's tokens) and on the
   shard with its first LS index poisoned (``poison_ls``: marked as the
   plain version marks); ``decompress`` with ``LIBFLATE_DEBUG_CHECKS=1``
   decodes the clean shard through the debug form (counted), raises
   DeflateError on the poisoned one, and decodes the reference test's
   flipped delta by the next branch;
   5f. ``decompress(verify=True, device="cuda")`` of the sync shard, the
   stripped shard, the generic shard (all 1024 members through one
   ``decode_symbols`` launch), the 1024 stdlib-gzip members and
   ``pgzf_encode_small.pgz``, each equal to gzip, counted, with the
   branches tried, the host clock (median of 3) and the peak device
   memory; ``decode_symbols``' time inside the generic branch;
   5g. ``inflate_device`` on 1 MiB of raw DEFLATE in memLevel-1 blocks
   and on a dynamic block followed by a stored block, equal to zlib;
6. encode input: that 64 MiB plaintext, 8 batches of 128 members of
   64 KiB; each encode kernel against its plain version on the card at
   the first batch's full shapes (128 x 65536), bit-exact;
   the token fields also in their per-member form (each member's own
   package-merged tables, its tokens compacted to a prefix of its valid
   count, ``n_tokens``);
   6b. the encode options' kernels against their plain versions on the
   same batch, bit-exact: the LCP as the quality mode calls it (sort
   matcher's exact prefix, 8 rounds, window 8192; and on a chain level's
   candidates, no prefix, 8 rounds, window 32768) and as the hash
   profile does (hash candidates, 6 rounds), one chain level's gather,
   the hash table;
   6c. the checksum kernels (``csrc/checksum.cu``) against their plain
   versions, bit-exact: ``crc32_f_rows`` on the decode shard's rows (phase
   4's resolve output, 1024 x 65,536), on one speculative group's rows
   (phase 4b's group expanded) and on the first encode batch's blocks,
   and ``adler32_device`` on each of the three flattened;
7. the encode main path ``compress(device="cuda")`` of the 64 MiB,
   counted: every encode kernel launched (the sort and the scan once per
   batch, here and in the quality mode), the stream read back by stdlib
   gzip and by the port's ``decompress_to_device``; then, counted the
   same way, (7b) the quality mode ``options=EncodeOptions(
   matcher="chain", max_chain=8, lcp_rounds=8)`` with ``match_lengths``
   and ``gather_rows``, and (7c) the hash profile
   (``LIBFLATE_DEVICE_MATCHER=hash``, all 8 batches) with
   ``hash_candidates`` and ``match_lengths``, each ratio beside the
   default's; (7d) the default encode with its LS index stripped through
   the speculative path, counted as in 5b;
8. byte identity with every committed reference stream
   (``tests/data/pgzf_encode_*.pgz``, written by the JAX reference, each
   with the options and matcher it was written with);
9. timing with CUDA events (kernels, plain versions, yardsticks, among
   them ``torch.searchsorted`` of every output position, the search half
   of the rank kernel only, which is printed beside it and is not its
   ``library_ms``; the CRC f-values kernel on the decode shard's rows and
   the Adler-32 kernel on its 64 MiB, each also launched alone, 48 back
   to back; the sync decode, rank, resolve, histogram, pack,
   hash, LCP (its three calls), token fields (also per member),
   two-table gather and speculative position decode, chunk
   exit and walk kernels also launched alone, 48 back to back, on the
   same inputs and cycling through four copies of them (more bytes than
   L2 holds), the resolve
   also on the first 128 members (one stripped-decode group), beside the
   pack's row memset, and the sync decode's time per token step; the
   resolve's, the hash kernel's, the token fields' (both forms), the
   two-table gather's (tables once, and each group's window rows, as
   its design reads them), each LCP call's, the speculative
   position decode's, chunk exits' and walk's bounds (the walk's from the
   32-byte sectors its visits touch) and half marks; the
   sync, speculative and foreign decode chains, the chains of the three
   encode modes; ``decode_symbols`` at 1024 generic members, alone, with
   its bytes bound (each stream's tables read once) and its latency
   bounds (the longest stream's dependent table loads times one dependent
   shared load, this design's, and times one dependent L2 load, each
   measured by a one-thread chase), its ``kernel_info``; ``chain_entries``'
   latency bound (the longest orbit's entered chunks times a dependent L2
   load); the debug form) and on the host clock (the end-to-end calls, host staging
   and the foreign path's host token decode split out), each with the
   card's name and power limit.

10. the generic device engine (``ops/pipeline.deflate_device`` and the
   containers on the ``cuda`` engine): (10a) byte identity with every
   committed reference stream (``DEFLATE_FIXTURES``, written by
   ``scripts/make_deflate_device_fixture.py`` from the JAX reference's
   TPU branches), each read back by stdlib zlib / gzip and by the port's
   engine, with its kernels counted; (10b) the 8 MiB batch (phase 6's
   first 128 x 64 KiB): its hash candidates equal phase 6b's (the kernel
   against its plain version there), the per-member ``token_fields`` on
   its tokens, and ``parse.chunk_exits`` / ``parse.walk_emit`` at cap
   512 on the jump arrays the hash branch and the sort branch build from
   it, each against its plain version; (10c) the main path
   ``deflate.compress(8 MiB, engine="cuda")`` counted (``hash_candidates``,
   ``token_fields``, the parse kernels once each), read back by zlib and
   by ``deflate.decompress(engine="cuda")`` (128 ``decode_symbols``
   launches), and ``decode_symbols`` on the stream's first block, at the
   token budget ``inflate_device`` gives it, against its plain version
   (timed by the host clock and by CUDA events, wrapper and launch);
   (10d) the 64 MiB through the sort branch, counted; (10e)
   ``gzip.compress`` / ``zlib.compress`` of 8 MiB and the engine's
   ``crc32`` / ``adler32`` of 64 MiB against the standard library, with
   the checksum kernels counted; (10f)
   ``pgzf.compress(64 MiB, block_type="fixed")``, ``hash_candidates``
   launched 8 times, read back by gzip and ``pgzf.decompress``; (10g) a
   stdlib gzip stream with a 2 MiB stored member through
   ``pgzf.decompress(device="cuda")`` (the gzip fallback) and a stream
   cut in its first block header raising EOFError; (10h) host-clock times
   (median of 3) of those calls, the 8 MiB batch's stages (CUDA events)
   and peak device memory, each with the card's name and power limit.
   The launches of the main-path runs (the 8 MiB and 64 MiB compresses,
   the 8 MiB decode, pgzf fixed blocks) are added to each counted
   kernel's row: ``hash_candidates``, ``token_fields``, the parse
   kernels and ``decode_symbols``; 10e's checksum launches to the
   checksum kernels' rows.

11. the host surface over the ``cuda`` engine: (11a) odd member sizes:
   the first batch of 128 x 65024-byte members (``ODD_MEMBER``, 127 x
   512, the glue LCP) through each encode kernel against its plain
   version, ``pgzf.compress(64 MiB, member_size=65024)`` counted (each
   kernel at least once a batch, no LCP, gather or hash kernel), read
   back by stdlib gzip and ``pgzf.decompress``, and 1000 / 512 / 131072
   refused with ValueError (the odd-size reference streams are phase 8's);
   (11b) the façades: ``gzip.Encoder`` of 8 MiB in 1 MiB writes equal to
   ``gzip.compress`` with the same launches, a SYNC-flushed zlib stream
   read by stdlib zlib, ``Decoder`` / ``MultiDecoder`` on two members, a
   flipped byte's salvage equal to the serial engine's ``.partial``;
   (11c) the serial engine on 1 MiB, ``BlockStreamer`` in 64 KiB writes
   equal to the one-shot, the chunked gzip decoder over the 8 MiB stream
   in 4 KiB feeds (one timed run); (11d) the CLI as a subprocess, each
   timed once (``--engine cuda``:
   gzip-encode, gzip-decode, pgzf-encode, pgzf-decode; ``--stream``
   gzip-encode / gzip-decode), each verified by stdlib gzip; (11e)
   ``token_hist`` on slots over all of int32 and ``rank_emit_src`` on
   ``rank_hard_cases`` (past the reference's 128-wide search), each
   against its plain version, and both on the main path's inputs again,
   each launched 48 times; (11f) every call's host clock (median of 3;
   one run for the chunked decoder and each CLI subprocess) and peak
   device memory, with the card's name and power limit.

12. the native host engine (no kernel): ``pgzf.compress(engine=
   "native")`` and ``native.deflate_greedy`` byte-identical to the
   committed ``tests/data/native_*`` streams (pgzf at ``n_threads`` 0 and
   1); the ``native`` and ``cuda`` engines' ``crc32`` / ``adler32`` of the
   64 MiB against zlib; ``native.inflate`` member by member (walked by end
   bits) and ``pgzf.decompress(engine="native")`` of the device stream
   (phase 7) and of the 1024 stdlib-gzip members (phase 5c), then of
   their first 256 and 512 (the gzip container's member walk, quadratic
   in the stream), against the plaintext; ``pgzf.compress(64 MiB, 65536, engine="native")`` at
   ``n_threads`` 0 and 1 (equal bytes, read back by stdlib gzip and the
   native decode) and ``deflate.compress`` / ``decompress`` of 8 MiB on
   ``native``; each on the host clock (median of 3) with the ratios, the
   host CPU's model and ``os.cpu_count()`` beside the card's name and
   power limit.

13. the sharded codec (``parallel/``) and the graft entry points: (13a)
   on ``make_mesh()`` (the card) and on ``make_mesh(4, devices=[cuda:0]
   * 4)`` (four logical shards of it), phase 6's first batch (128 x 64
   KiB): ``encode_blocks_sharded`` equal to the unsharded
   ``encode_batch_generic`` (the hash branch, chosen by the whole batch),
   every member read back by zlib; ``decode_members_sharded`` of it equal
   to the plaintext; ``encode_sync_sharded`` equal to ``encode_batch``'s
   words, bits, counts and offsets; ``decode_sync_sharded`` of its chunk
   table equal to the unsharded ``sync_decode`` on the members end to end
   (and expanding to the plaintext); ``combine_shard_crcs`` equal to
   zlib's CRC; each call counted, every shard's kernels launched; (13b)
   ``graft_entry.dryrun_multichip(4, devices=[cuda:0] * 4)``, counted;
   (13c) ``graft_entry.dryrun_multihost(2, device="cuda")`` on the 64
   MiB: two worker processes over gloo, both on cuda:0, 512 members
   each, the stream byte-identical to phase 7's, ``decompress_multihost``
   equal to the input and ``corpus_crc32_multihost`` to zlib's in both,
   the workers' launches counted; (13d) host-clock times (median of 3)
   of those calls and the unsharded ones, with the card's name and power
   limit.  Phase 13's launches are added to each kernel's row.

Kernels are keyed by module and function (``parse.walk_emit`` and
``decode.walk_emit`` are two kernels).

The last lines are the kernels' JSON summary, the card's name and power
limit as nvidia-smi reports them, and ``{"ok": true, "device": ...}``.
"""
from __future__ import annotations

import contextlib
import gzip
import json
import os
import pathlib
import statistics
import struct
import subprocess
import sys
import time
import zlib

import torch

ROOT = pathlib.Path(__file__).resolve().parent
DATA = ROOT / "tests" / "data"
FIXTURE = DATA / "pgzf_sync_zipf_2m.pgz"
COPIES = 32
HBM_BYTES_PER_MS = 3.35e12 / 1e3      # H100 SXM data sheet, 80 GB HBM3
COLD_COPIES = 4                        # input copies for the cold timings
#: the quality mode of the reference's bench: EncodeOptions fields
QUALITY = {"matcher": "chain", "max_chain": 8, "lcp_rounds": 8}
#: reference stream -> (EncodeOptions fields, LIBFLATE_DEVICE_MATCHER) it
#: was written with; others: the defaults
REFERENCE_OPTIONS = {
    "pgzf_encode_chain8_small.pgz": (QUALITY, "sort"),
    "pgzf_encode_chain8_w2048_8k.pgz": ({**QUALITY, "window_size": 2048},
                                        "sort"),
    "pgzf_encode_hash_small.pgz": (None, "hash"),
    "pgzf_encode_odd_1536_hash.pgz": (None, "hash"),
    "pgzf_encode_odd_512_hash.pgz": (None, "hash"),
    "pgzf_encode_odd_65024_hash.pgz": (None, "hash"),
    "pgzf_encode_odd_131072_hash.pgz": (None, "hash"),
}
#: phase 11a's member size: the largest non-multiple of 1024 that the
#: reference's dynamic kernel branch takes with the sort matcher (127 x
#: 512; it refuses sizes that are not multiples of 512)
ODD_MEMBER = 65024
#: the generic engine's committed reference streams, written by
#: scripts/make_deflate_device_fixture.py: name -> (call, EncodeOptions
#: fields, deflate_device's block size or pgzf's member size)
DEFLATE_FIXTURES = {
    # 3 blocks of 64 KiB: the sort candidates, the token-field kernel
    "deflate_device_sort.bin": ("deflate", {}, None),
    # 128 blocks of 1 KiB: the hash kernel and the token-field kernel
    "deflate_device_hash.bin": ("deflate", {}, 1024),
    "deflate_device_fixed.bin": ("deflate", {"block_type": "fixed"}, 1024),
    "deflate_device_none.bin": ("deflate", {"matcher": "none"}, None),
    "deflate_device_member.gz": ("gzip", {}, None),
    "deflate_device_stream.zlib": ("zlib", {}, None),
    # 134 members of 1 KiB, two batches: the hash kernel, fixed blocks
    "deflate_device_fixed.pgz": ("pgzf", {"block_type": "fixed"}, 1024),
}


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def device_matcher(name: str):
    """Run the block with ``LIBFLATE_DEVICE_MATCHER=name``."""
    old = os.environ.get("LIBFLATE_DEVICE_MATCHER")
    os.environ["LIBFLATE_DEVICE_MATCHER"] = name
    try:
        yield
    finally:
        if old is None:
            del os.environ["LIBFLATE_DEVICE_MATCHER"]
        else:
            os.environ["LIBFLATE_DEVICE_MATCHER"] = old


def strip_sync_index(stream: bytes) -> bytes:
    """``stream`` with the "LS" sync index taken out of every member
    header: each member gets the plain LF-indexed header and its LF size
    is patched; bodies and trailers stay as they are.  Such a stream
    takes ``decompress_to_device``'s speculative path."""
    from libflate_tpu_torch.formats import pgzf
    out = bytearray()
    for ref in pgzf.index_members(stream):
        member = bytearray(pgzf._member_header(0))
        member += stream[ref.body:ref.end]
        struct.pack_into("<I", member, pgzf._SIZE_OFFSET, len(member))
        out += member
    return bytes(out)


def lf_member(body: bytes, plain: bytes) -> bytes:
    """A PGZF member: the port's LF-indexed header, ``body`` and the CRC /
    ISIZE trailer of ``plain``."""
    from libflate_tpu_torch.formats import pgzf
    member = bytearray(pgzf._member_header(0)) + body
    member += struct.pack("<II", zlib.crc32(plain), len(plain))
    struct.pack_into("<I", member, pgzf._SIZE_OFFSET, len(member))
    return bytes(member)


def generic_shard(plain: bytes, member: int = 65536) -> bytes:
    """``plain`` as LF-indexed members of ``member`` bytes, each body a raw
    DEFLATE stream of ``zlib.compressobj(9, DEFLATED, -15)`` (the bodies
    stdlib ``gzip.compress`` writes): per-member tables, no LS index, the
    stream that ``pgzf.decompress``'s generic branch takes."""
    out = []
    for i in range(0, len(plain), member):
        c = zlib.compressobj(9, zlib.DEFLATED, -15)
        chunk = plain[i:i + member]
        out.append(lf_member(c.compress(chunk) + c.flush(), chunk))
    return b"".join(out)


def poison_ls(stream: bytes) -> bytes:
    """``stream`` with its first member's LS index claiming K = 1024 tokens
    a chunk (and as many tokens as keeps its chunk count): every chunk
    then decodes four real chunks, and its cursor leaves the window the
    reference stages for it, which the sync kernel's debug-checks form
    marks.  (Flipping the high byte of the first delta, as the
    reference's own test does, leaves a start past the body: both sides
    drop the sync branch with ImportError before decoding.)"""
    ls = stream.find(b"LS") + 4
    n_chunks = struct.unpack_from("<H", stream, ls + 12)[0]
    out = bytearray(stream)
    struct.pack_into("<HI", out, ls + 2, 1024, 1024 * n_chunks)
    return bytes(out)


def _bit_words(fields, shift: int = 0):
    """(little-endian int32 words of the fields, LSB first, after
    ``shift`` zero bits, with 2 zero words after them; their bit count)."""
    import numpy as np
    v, n = 0, shift
    for value, width in fields:
        v |= value << n
        n += width
    raw = v.to_bytes(-(-n // 32) * 4 + 8, "little")
    return np.frombuffer(raw, "<i4").copy(), n


def _fixed_code(sym: int):
    """The fixed litlen code of ``sym`` as an LSB-first field."""
    if sym < 144:
        code, width = 0x30 + sym, 8
    elif sym < 256:
        code, width = 0x190 + sym - 144, 9
    elif sym < 280:
        code, width = sym - 256, 7
    else:
        code, width = 0xC0 + sym - 280, 8
    return int(f"{code:0{width}b}"[::-1], 2), width


def decode_hard_cases():
    """Inputs on which ``decode_symbols`` and its plain version must agree
    bit for bit: name -> (words (B, W) int32, start_bit (B,) int32,
    litlen and distance code lengths (B, 288), (B, 30) or None for the
    tables given, tables or None, max_tokens, chunk).  numpy, from fixed
    seeds."""
    import numpy as np
    from libflate_tpu_torch.serial.deflate import parse_block_headers
    rng = np.random.default_rng(13)
    vocab = [bytes(rng.integers(97, 123, rng.integers(3, 9), np.uint8))
             for _ in range(300)]
    texts = [b" ".join(vocab[i] for i in rng.integers(0, 300, n // 5))[:n]
             for n in (2048, 5000, 8192, 3000)]
    bodies = []
    for t in texts:
        c = zlib.compressobj(9, zlib.DEFLATED, -15)
        bodies.append(c.compress(t) + c.flush())
    lit, dist, starts, _flags = parse_block_headers(bodies)
    w = max(len(b) for b in bodies) // 4 + 8
    rows = np.zeros((len(bodies), 4 * w), np.uint8)
    for i, b in enumerate(bodies):
        rows[i, :len(b)] = np.frombuffer(b, np.uint8)
    zl = (rows.view("<i4"), starts.astype(np.int32), lit, dist, None, 9000,
          4096)
    cases = {"zlib bodies": zl,
             "cut at max_tokens, chunked": zl[:5] + (300, 4096),
             "cut at max_tokens, one chunk": zl[:5] + (300, 300)}
    # the same bodies shifted by 13 bits: no start bit word-aligned
    shifted = np.zeros((len(bodies), 4 * w + 4), np.uint8)
    for i, b in enumerate(bodies):
        v = int.from_bytes(b, "little") << 13
        shifted[i, :len(b) + 2] = np.frombuffer(
            v.to_bytes(len(b) + 2, "little"), np.uint8)
    cases["start bits off the word"] = (shifted.view("<i4"),
                                        starts.astype(np.int32) + 13,
                                        lit, dist, None, 9000, 4096)
    # a table hole: the most common literal's entries zeroed (width 0)
    from libflate_tpu_torch.ops.huffman import tables_from_lengths
    import torch
    lt, dt = tables_from_lengths(torch.from_numpy(lit), torch.from_numpy(dist))
    lt = lt.numpy().copy()
    lt[(lt >> 4) == ord("e")] = 0
    cases["table hole"] = (zl[0], zl[1], None, None, (lt, dt.numpy()),
                           9000, 4096)
    # fixed blocks: 286 and 287 (length 258, no extra bits), a literal,
    # a distance with extra bits, the EOB; an empty final block
    def dcode(n):                       # a fixed 5-bit distance code
        return int(f"{n:05b}"[::-1], 2), 5

    fields = [(1, 1), (1, 2), _fixed_code(97), _fixed_code(286), dcode(0),
              _fixed_code(287), dcode(3), _fixed_code(257), dcode(5),
              (1, 1), _fixed_code(98), _fixed_code(256)]
    fx, _ = _bit_words(fields, 5)
    em, _ = _bit_words([(1, 1), (1, 2), _fixed_code(256)])
    fw = max(len(fx), len(em))
    fixed_words = np.zeros((2, fw), np.int32)
    fixed_words[0, :len(fx)], fixed_words[1, :len(em)] = fx, em
    fl = np.zeros((2, 288), np.int32)
    fl[:] = [8] * 144 + [9] * 112 + [7] * 24 + [8] * 8
    cases["fixed code: 286 / 287, empty final block"] = (
        fixed_words, np.array([8, 3], np.int32), fl,
        np.full((2, 30), 5, np.int32), None, 64, 4096)
    # an incomplete code (only 'a', 'b' and the EOB: one code word free)
    # read on random bits, and random words under any-int32 tables
    inc = np.zeros((3, 288), np.int32)
    inc[:, [97, 98, 256]] = [1, 2, 3]
    rnd = rng.integers(-2**31, 2**31 - 1, (3, 40), dtype=np.int64).astype(
        np.int32)
    cases["incomplete code"] = (rnd, np.array([0, 7, 100], np.int32), inc,
                                np.full((3, 30), 5, np.int32), None, 400,
                                128)
    any_tabs = tuple(rng.integers(-2**31, 2**31 - 1, (2, 1 << 15),
                                  dtype=np.int64).astype(np.int32)
                     for _ in range(2))
    cases["random words, any-int32 tables, table_idx"] = (
        rnd, np.array([0, 31, 600], np.int32), None, None,
        any_tabs + (np.array([1, 0, 1], np.int32),), 300, 100)
    cases.update(_past_subtable_cases())
    return cases


def _past_subtable_cases():
    """Two ``decode_hard_cases`` entries whose tables overflow the
    kernel's on-chip subtable area (``deflate_decode.COMPACT``).  A
    complete litlen code whose literals 0-199 take 11 bits (more
    non-uniform litlen prefixes than the slots) with 28 distance codes of
    10 bits (within the distance slots), over 700 random tokens and the
    EOB, from bit 0 and bit 21; and any-int32 tables with no zero width
    (every prefix non-uniform) under random words, which run to the step
    budget and past the row's end."""
    import numpy as np
    from libflate_tpu_torch.serial.huffman import canonical_codes, \
        reverse_bits
    from libflate_tpu_torch.spec import constants as C
    rng = np.random.default_rng(17)
    lit = np.zeros(288, np.int32)
    lit[:200], lit[200:240], lit[240:265], lit[265:286] = 11, 6, 7, 8
    dist = np.zeros(30, np.int32)
    dist[:28], dist[28], dist[29] = 10, 1, 2
    lcodes, dcodes = canonical_codes(lit), canonical_codes(dist)

    def code(codes, lens, sym):
        return reverse_bits(int(codes[sym]), int(lens[sym])), int(lens[sym])

    def extra(n_bits):
        return int(rng.integers(0, 1 << n_bits)), n_bits

    rows = []
    for shift in (0, 21):
        fields = []
        for _ in range(700):
            if rng.random() < 0.7:
                fields.append(code(lcodes, lit, int(rng.integers(0, 256))))
                continue
            li, ds = int(rng.integers(0, 29)), int(rng.integers(0, 30))
            fields += [code(lcodes, lit, 257 + li),
                       extra(int(C.LENGTH_EXTRA[li])),
                       code(dcodes, dist, ds), extra(int(C.DIST_EXTRA[ds]))]
        fields.append(code(lcodes, lit, 256))
        rows.append(_bit_words(fields, shift)[0])
    words = np.zeros((2, max(len(r) for r in rows)), np.int32)
    for i, r in enumerate(rows):
        words[i, :len(r)] = r
    wild = tuple(rng.integers(-2**31, 2**31 - 1, (2, 1 << 15),
                              dtype=np.int64).astype(np.int32) | 1
                 for _ in range(2))
    rnd = rng.integers(-2**31, 2**31 - 1, (2, 200), dtype=np.int64).astype(
        np.int32)
    return {
        "past the on-chip subtables: 11-bit literal codes":
            (words, np.array([0, 21], np.int32), np.stack([lit, lit]),
             np.stack([dist, dist]), None, 1000, 256),
        "every prefix non-uniform: any-int32 tables, no zero width":
            (rnd, np.array([3, 40], np.int32), None, None, wild, 500, 128)}


def first_block_decode_args(stream: bytes, dev):
    """``decode_symbols``' operands for the first block (fixed or
    dynamic) of a raw DEFLATE stream, as ``inflate_device``'s first
    attempt gives them: ((words, start_bit, lit_table, dist_table),
    max_tokens)."""
    import numpy as np

    from libflate_tpu_torch.ops import deflate_decode
    from libflate_tpu_torch.ops.huffman import tables_from_lengths
    from libflate_tpu_torch.serial.bitio import BitReader
    from libflate_tpu_torch.serial.deflate import read_dynamic_header_lengths
    from libflate_tpu_torch.spec import constants as C
    r = BitReader(stream)
    r.read_bits(1)
    btype = r.read_bits(2)
    if btype == C.BTYPE_DYNAMIC:
        lit_l, dist_l = read_dynamic_header_lengths(r)
    elif btype == C.BTYPE_FIXED:
        lit_l, dist_l = C.fixed_litlen_lengths(), C.fixed_dist_lengths()
    else:
        raise ValueError("the first block is not a Huffman block")
    words = torch.from_numpy(deflate_decode._bytes_to_words(stream).view(
        np.int32).copy()).to(dev)[None, :]
    start = torch.tensor([r.bit_position], dtype=torch.int32, device=dev)
    tables = tables_from_lengths(torch.from_numpy(lit_l[None, :]).to(dev),
                                 torch.from_numpy(dist_l[None, :]).to(dev))
    _cap, max_tokens = deflate_decode.token_budget(len(stream))
    return (words, start) + tuple(tables), max_tokens


def fixture_plain(kind: str, stream: bytes) -> bytes:
    """A DEFLATE_FIXTURES call's stream decoded by the standard library."""
    if kind in ("gzip", "pgzf"):
        return gzip.decompress(stream)
    return zlib.decompress(stream, -15 if kind == "deflate" else 15)


def deflate_fixture_stream(kind: str, options: dict, size, plain: bytes,
                           device: str) -> bytes:
    """The port's stream of a DEFLATE_FIXTURES entry on ``device`` ("cuda"
    or "cpu"): ``deflate_device`` at ``size``-byte blocks, a container on
    the device's engine, or pgzf at ``size``-byte members."""
    from libflate_tpu_torch.formats import gzip as fgzip
    from libflate_tpu_torch.formats import pgzf
    from libflate_tpu_torch.formats import zlib as fzlib
    from libflate_tpu_torch.ops import pipeline
    from libflate_tpu_torch.serial.deflate import EncodeOptions
    opts = EncodeOptions(**options) if options else None
    if kind == "deflate":
        return pipeline.deflate_device(plain, opts, device_block_size=size,
                                       device=device)
    if kind == "gzip":
        return fgzip.compress(plain, opts, engine=device)
    if kind == "zlib":
        return fzlib.compress(plain, opts, engine=device)
    return pgzf.compress(plain, member_size=size, options=opts,
                         device=device)


def deflate_fixture_decode(kind: str, stream: bytes, device: str) -> bytes:
    """A DEFLATE_FIXTURES stream decoded by the port on ``device``."""
    from libflate_tpu_torch.formats import deflate as fdeflate
    from libflate_tpu_torch.formats import gzip as fgzip
    from libflate_tpu_torch.formats import pgzf
    from libflate_tpu_torch.formats import zlib as fzlib
    if kind == "deflate":
        return fdeflate.decompress(stream, engine=device)
    if kind == "gzip":
        return fgzip.decompress(stream, engine=device)
    if kind == "zlib":
        return fzlib.decompress(stream, engine=device)
    return pgzf.decompress(stream, device=device)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def cuda_ms(fn, reps: int) -> float:
    """Median of ``reps`` single-call CUDA-event timings."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def cuda_ms_many(fns, n: int) -> float:
    """CUDA-event time of ``n`` calls back to back, cycling through
    ``fns``, over ``n``: the host time of a call hides behind the
    device's work on the ones before."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for i in range(n):
        fns[i % len(fns)]()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n


def kname(fn) -> str:
    """A kernel wrapper's key: its module's last name and its own
    (``parse.walk_emit`` and ``decode.walk_emit`` are two kernels)."""
    return f"{fn.__module__.rsplit('.', 1)[-1]}.{fn.__name__}"


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def walk_visits(nxt: torch.Tensor, entries: torch.Tensor) -> torch.Tensor:
    """(B, P) bool: the positions the speculative walks visit (the walk of
    ``decode.walk_emit_plain``, marking each position it emits from)."""
    from libflate_tpu_torch.ops import decode
    bsz, p_total = nxt.shape
    nc = p_total // decode.CHAIN_CHUNK
    dev = nxt.device
    base = torch.arange(nc, device=dev)[None, :] * decode.CHAIN_CHUNK
    member = torch.arange(bsz, device=dev)[:, None].expand(bsz, nc)
    nxt64, cur = nxt.to(torch.int64), entries.to(torch.int64)
    seen = torch.zeros((bsz, p_total), dtype=torch.bool, device=dev)
    for _ in range(decode.MAX_EMIT):
        inside = (cur >= base) & (cur < base + decode.CHAIN_CHUNK)
        at = cur.clamp(0, p_total - 1)
        seen[member[inside], at[inside]] = True
        nv = torch.gather(nxt64, 1, at)
        cur = torch.where(inside, torch.where(nv == cur, 0x7FFFFFF0, nv),
                          cur)
    return seen


def member_codes(a: torch.Tensor, b: torch.Tensor, n_tokens: torch.Tensor):
    """Each member's own codes, as the generic engine builds them: the
    histogram of its first ``n_tokens`` slots, package-merged to at most
    15 bits; (lit_rev, lit_w) (B, 286) and (dist_rev, dist_w) (B, 30)."""
    import numpy as np
    from libflate_tpu_torch.ops import deflate_encode, hist
    from libflate_tpu_torch.ops.huffman import package_merge_lengths
    live = (torch.arange(a.shape[1], device=a.device)[None, :]
            < n_tokens[:, None])
    codes = [[], [], [], []]
    for k in range(a.shape[0]):
        lit, dist = hist.shared_histograms(a[k:k + 1], b[k:k + 1],
                                           live[k:k + 1])
        for i, x in enumerate(
                deflate_encode.encoder_tables(package_merge_lengths(
                    lit.cpu().numpy(), 15))
                + deflate_encode.encoder_tables(package_merge_lengths(
                    dist.cpu().numpy(), 15))):
            codes[i].append(x)
    return [np.stack(c) for c in codes]


def check_one_sort_per_batch(counts: dict, n_batches: int, what: str):
    """The sort matcher launches its sort and its scan once per batch."""
    for k in ("sort_match.sort_keys", "sort_match.scan_emit"):
        if counts[k] != n_batches:
            raise AssertionError(f"{what}: {k} launched {counts[k]} times "
                                 f"for {n_batches} batches")


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: CUDA is not available")
    from libflate_tpu_torch import _build, native
    from libflate_tpu_torch.formats import pgzf
    from libflate_tpu_torch.ops import (checksum, decode, deflate_decode,
                                        deflate_encode, device_expand,
                                        expand, fields, gather, hist, lcp,
                                        pack, parse, pipeline, rank)
    from libflate_tpu_torch.ops import hash_match as hm
    from libflate_tpu_torch.ops import sort_match as sm
    from libflate_tpu_torch.ops import sync_decode as sd
    from libflate_tpu_torch.serial.deflate import EncodeOptions
    quality = EncodeOptions(**QUALITY)

    # 1. environment
    card_line = card()
    name = torch.cuda.get_device_name(0)
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    log(f"card: {card_line}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, {nvcc[-1]}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # 2. build
    t = time.perf_counter()
    so = _build.build(verbose=True)
    _build.load()
    log(f"built {so.name} from {len(_build.sources())} sources in "
        f"{time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    native.load()
    log(f"built {native.library_path().name} with g++ in "
        f"{time.perf_counter() - t:.2f} s")
    log(f"match.cu at n=65536: {json.dumps(sm.kernel_info(65536))} "
        f"[{card_line}]")
    log(f"parse.cu at n=65536: {json.dumps(parse.kernel_info(65536))} "
        f"[{card_line}]")
    log(f"rank.cu: {json.dumps(rank.kernel_info())} [{card_line}]")
    log(f"pack.cu: {json.dumps(pack.kernel_info())} [{card_line}]")
    log(f"fields.cu token_hist: {json.dumps(hist.kernel_info())} "
        f"[{card_line}]")
    log(f"fields.cu token_fields: {json.dumps(fields.kernel_info())} "
        f"[{card_line}]")
    log(f"gather.cu gather_two: window 16 "
        f"{json.dumps(gather.kernel_info('gather_two', 16))}, window 128 "
        f"{json.dumps(gather.kernel_info('gather_two', 128))} [{card_line}]")
    log(f"resolve.cu: {json.dumps(expand.kernel_info())} [{card_line}]")
    log(f"hash.cu at n=65536: {json.dumps(hm.kernel_info(65536))} "
        f"[{card_line}]")
    log(f"lcp.cu at n=65536: window 32768 (chain levels, hash) "
        f"{json.dumps(lcp.kernel_info(65536, 32768))}, window 8192 (sort "
        f"m4) {json.dumps(lcp.kernel_info(65536, 8192))} [{card_line}]")
    log("checksum.cu: " + ", ".join(
        f"{k} {json.dumps(checksum.kernel_info(k))}"
        for k in ("crc_tiles", "crc_fold", "adler_partial", "adler_fold"))
        + f" [{card_line}]")
    log("spec_decode.cu: " + ", ".join(
        f"{k} {json.dumps(decode.kernel_info(k))}"
        for k in ("speculative_decode_positions", "chunk_exit_maps",
                  "walk_emit")) + f" [{card_line}]")

    # 3. decode input and oracle
    stream = FIXTURE.read_bytes() * COPIES
    oracle = gzip.decompress(stream)
    log(f"decode input: {len(stream)} stream bytes, {len(oracle)} "
        f"plaintext bytes")
    stage_s = []
    for _ in range(3):
        t = time.perf_counter()
        groups = pgzf._prepare_sync_device(stream, dev)
        torch.cuda.synchronize()
        stage_s.append(time.perf_counter() - t)
    log(f"decode host staging (member index, LS spans, block-header parse "
        f"of {len(pgzf.index_members(stream))} members, upload): "
        f"{statistics.median(stage_s) * 1e3:.2f} ms median of 3")

    # 4. decode kernels against their plain versions
    if len(groups) != 1:
        raise AssertionError(f"expected one table group, got {len(groups)}")
    g = groups[0]
    bsz, cap = g["bsz"], g["member_cap"]
    sd_info = sd.kernel_info(g["root_bits"])
    log(f"sync_decode.cu at root_bits={g['root_bits']}: "
        f"{json.dumps(sd_info)} [{card_line}]")
    sd_args = (g["words"], g["start_bits"], g["counts"], g["lit_t"],
               g["dist_t"], g["k_tok"], g["root_bits"])
    toks = sd.sync_decode(*sd_args)
    toks_plain = sd.sync_decode_plain(*sd_args)
    rk_args = device_expand.rank_inputs(
        toks.view(bsz, -1), g["n_tokens"], cap)[:4] + (cap,)
    src, lit = rank.rank_emit_src(*rk_args)
    src_p, lit_p = rank.rank_emit_src_plain(*rk_args)
    out = expand.resolve_bytes(src, lit)
    out_p = expand.resolve_bytes_plain(src, lit)
    torch.cuda.synchronize()
    errs = {kname(sd.sync_decode): max_abs_err(toks, toks_plain),
            kname(rank.rank_emit_src): max(max_abs_err(src, src_p),
                                           max_abs_err(lit, lit_p)),
            kname(expand.resolve_bytes): max_abs_err(out, out_p)}
    log(f"decode kernels vs plain at slots={toks.shape[0]} K={g['k_tok']} "
        f"root_bits={g['root_bits']} members={bsz} member_cap={cap}: "
        f"max_abs_err {errs}")
    if any(errs.values()):
        raise AssertionError(f"a kernel disagrees with its plain version: "
                             f"{errs}")
    del toks_plain, src_p, lit_p, out_p
    # the rank kernel's inputs and outputs, kept on the host: the phases
    # that follow only read them, and the check of the kernels launched
    # alone (phase 9) compares with them, so a launch that writes outside
    # its own outputs shows here, named by the phase it came in
    held = [(k, t, t.cpu()) for k, t in zip(
        ("starts", "pk", "valid", "n_out", "src", "lit"),
        (*rk_args[:4], src, lit))]

    def check_held(after: str) -> None:
        moved = [k for k, t, h in held if not torch.equal(t.cpu(), h)]
        if moved:
            raise AssertionError(
                f"phase 4's rank {', '.join(moved)} changed by {after}: a "
                f"launch wrote outside its outputs")

    # 4b. the speculative decode's kernels against their plain versions on
    # the first group (128 members) of the shard with its LS index
    # stripped, at the main path's shapes; gather_two at B = 128, R = N =
    # 512 on random tables (nothing calls it on a path)
    spec_stream = strip_sync_index(stream)
    spec_refs = pgzf.index_members(spec_stream)
    spec_stage_s = []
    for _ in range(3):
        t = time.perf_counter()
        spec_groups = list(pgzf._spec_groups(spec_stream, spec_refs, dev))
        torch.cuda.synchronize()
        spec_stage_s.append(time.perf_counter() - t)
    st = spec_groups[0]
    sp_args = (st["words"], st["lit_t"], st["dist_t"])
    s_tok, s_nxt = decode.speculative_decode_positions(*sp_args)
    s_tok_p, s_nxt_p = decode.speculative_decode_positions_plain(*sp_args)
    s_ex = decode.chunk_exit_maps(s_nxt)
    s_ex_p = decode.chunk_exit_maps_plain(s_nxt)
    s_ent = deflate_decode.chain_entries(s_ex, st["starts"])
    s_ent_p = deflate_decode.chain_entries_plain(s_ex, st["starts"])
    s_emit = decode.walk_emit(s_nxt, s_tok, s_ent)
    s_emit_p = decode.walk_emit_plain(s_nxt, s_tok, s_ent)
    gen = torch.Generator(device=dev).manual_seed(15)
    g2_b, g2_r, g2_win = 128, 512, 16
    g2_tabs = [torch.randint(-2**31, 2**31 - 1, (g2_b, g2_r, 128),
                             generator=gen, device=dev, dtype=torch.int64)
               .to(torch.int32) for _ in range(2)]
    g2_lo = (torch.randint(0, (g2_r - g2_win) // 8 + 1, (g2_b, g2_r // 8),
                           generator=gen, device=dev) * 8).to(torch.int32)
    g2_idx = ((g2_lo.repeat_interleave(8, dim=1)[:, :, None]
               + torch.randint(-2, g2_win + 2, (g2_b, g2_r, 128),
                               generator=gen, device=dev)) * 128
              + torch.randint(0, 128, (g2_b, g2_r, 128), generator=gen,
                              device=dev)).to(torch.int32)
    g2_args = (*g2_tabs, g2_idx, g2_lo)
    g2 = gather.gather_two(*g2_args, win=g2_win)
    g2_p = gather.gather_two_plain(*g2_args, win=g2_win)
    torch.cuda.synchronize()
    spec_errs = {
        kname(decode.speculative_decode_positions): max(
            max_abs_err(s_tok, s_tok_p), max_abs_err(s_nxt, s_nxt_p)),
        kname(decode.chunk_exit_maps): max_abs_err(s_ex, s_ex_p),
        kname(deflate_decode.chain_entries): max_abs_err(s_ent, s_ent_p),
        kname(decode.walk_emit): max_abs_err(s_emit, s_emit_p),
        kname(gather.gather_two): max(max_abs_err(x, y)
                                      for x, y in zip(g2, g2_p))}
    errs.update(spec_errs)
    s_rows = s_emit.view(s_emit.shape[0], -1, decode.EMIT_ROWS)
    log(f"speculative decode kernels vs plain at members={s_tok.shape[0]} "
        f"words={st['words'].shape[1]} positions={s_tok.shape[1]} "
        f"chunks={s_ent.shape[1]}; gather_two at B={g2_b} R=N={g2_r} "
        f"win={g2_win}: max_abs_err {spec_errs} (tokens emitted "
        f"{int((s_rows[:, :, :decode.MAX_EMIT] >= 0).sum())}, overflowed "
        f"chunks {int((s_rows[:, :, decode.MAX_EMIT] != 0).sum())}, "
        f"gather_two hits {int((g2_p[0] != 0).sum())} of {g2_idx.numel()})")
    log(f"speculative host staging (_spec_groups: block-header parse of "
        f"{len(spec_refs)} members, {len(spec_groups)} groups of word rows, "
        f"upload): {statistics.median(spec_stage_s) * 1e3:.2f} ms median "
        f"of 3")
    if any(spec_errs.values()):
        raise AssertionError(f"a kernel disagrees with its plain version: "
                             f"{spec_errs}")
    del s_tok_p, s_nxt_p, s_ex_p, s_ent_p, s_emit_p, g2_p

    # 5. the decode main path, counted
    crc_k = checksum.crc32_f_rows
    dec_kernels = (sd.sync_decode, rank.rank_emit_src, expand.resolve_bytes,
                   crc_k)
    enc_kernels = (sm.sort_keys, sm.scan_emit, parse.chunk_exits,
                   parse.walk_emit, hist.token_hist, fields.token_fields,
                   pack.pack_stitch)
    opt_kernels = (lcp.match_lengths, gather.gather_rows, hm.hash_candidates)
    spec_kernels = (decode.speculative_decode_positions,
                    decode.chunk_exit_maps, deflate_decode.chain_entries,
                    decode.walk_emit)
    all_kernels = (dec_kernels + enc_kernels + opt_kernels + spec_kernels
                   + (gather.gather_two, checksum.adler32_device))
    for k in all_kernels:
        k.launches = 0
    plain_dev, lengths = pgzf.decompress_to_device(stream, verify=True,
                                                   device="cuda")
    torch.cuda.synchronize()
    launches = {kname(k): k.launches for k in dec_kernels}
    log(f"decode main path launches: {launches}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the path did not run: {launches}")
    # the CRC f-values kernel runs on every path: its row sums the runs
    crc_runs = {"decode": crc_k.launches}
    if plain_dev.shape != (bsz, cap) or plain_dev.dtype != torch.uint8:
        raise AssertionError(f"bad output {plain_dev.shape} "
                             f"{plain_dev.dtype}")
    live = (torch.arange(cap, device=dev)[None, :]
            < lengths.to(torch.int64)[:, None])
    if bytes(plain_dev[live].cpu().numpy()) != oracle:
        raise AssertionError("decoded plaintext differs from stdlib gzip")
    if bool(plain_dev[~live].any()):
        raise AssertionError("nonzero bytes past a member's length")
    log(f"decode main path: {len(oracle)} bytes equal to stdlib gzip, "
        f"{bsz} member CRCs verified on the port")

    def spec_main_path(synced: bytes, plain: bytes, sync_rows, what: str):
        """decompress_to_device of ``synced`` with its LS index stripped,
        counted: each speculative kernel once per group of 128 members,
        the sync kernel never; the rows equal the sync path's and gzip's.
        Returns the counts."""
        stripped = strip_sync_index(synced)
        n_groups = -(-len(pgzf.index_members(stripped)) // pgzf.DEV_BATCH)
        for k in all_kernels:
            k.launches = 0
        rows, lens = pgzf.decompress_to_device(stripped, verify=True,
                                               device="cuda")
        torch.cuda.synchronize()
        counts = {kname(k): k.launches for k in spec_kernels}
        log(f"{what} launches: {counts}, sync_decode "
            f"{sd.sync_decode.launches}, crc32_f_rows {crc_k.launches}")
        if (set(counts.values()) != {n_groups}
                or sd.sync_decode.launches != 0):
            raise AssertionError(f"expected each speculative kernel "
                                 f"{n_groups} times and no sync decode")
        if crc_k.launches < 1:
            raise AssertionError(f"{what}: crc32_f_rows did not run")
        crc_runs[what] = crc_k.launches
        if not torch.equal(rows, sync_rows):
            raise AssertionError(f"{what}: rows differ from the sync path's")
        live_ = (torch.arange(rows.shape[1], device=dev)[None, :]
                 < lens.to(torch.int64)[:, None])
        if bytes(rows[live_].cpu().numpy()) != plain:
            raise AssertionError(f"{what}: plaintext differs from gzip's")
        if bool(rows[~live_].any()):
            raise AssertionError(f"{what}: nonzero bytes past a length")
        log(f"{what}: {len(stripped)} stream bytes without the LS index "
            f"-> {len(plain)} bytes equal to stdlib gzip and to the sync "
            f"path's rows, {rows.shape[0]} member CRCs verified")
        return counts

    # 5b. the speculative main path on the shard, LS index stripped
    launches.update(spec_main_path(stream, oracle, plain_dev,
                                   "speculative decode main path"))
    del plain_dev, live

    # 5c. the foreign-stream path, counted: 1024 stdlib-gzip members of 64
    # KiB without an index, and the small encode with its stored members
    t = time.perf_counter()
    foreign = b"".join(gzip.compress(oracle[i:i + 65536])
                       for i in range(0, len(oracle), 65536))
    log(f"foreign input: {len(oracle)} bytes as "
        f"{-(-len(oracle) // 65536)} stdlib gzip members -> {len(foreign)} "
        f"bytes, written in {time.perf_counter() - t:.2f} s")
    foreign_streams = {
        "1024 stdlib gzip members of 64 KiB, no index": foreign,
        "pgzf_encode_small.pgz, stored members 130-133":
            (DATA / "pgzf_encode_small.pgz").read_bytes()}
    fg_kernels = (rank.rank_emit_src, expand.resolve_bytes, crc_k)
    for what, fstream in foreign_streams.items():
        fplain = gzip.decompress(fstream)
        for k in all_kernels:
            k.launches = 0
        rows, lens = pgzf.decompress_to_device(fstream, verify=True,
                                               device="cuda")
        torch.cuda.synchronize()
        counts = {kname(k): k.launches for k in fg_kernels}
        others = {kname(k): k.launches for k in all_kernels
                  if k not in fg_kernels and k.launches}
        log(f"foreign decode ({what}) launches: {counts}, other kernels "
            f"{others}")
        if min(counts.values()) < 1 or others:
            raise AssertionError(f"foreign decode ({what}): expected rank, "
                                 f"resolve and the CRC only: {counts} "
                                 f"{others}")
        crc_runs[f"foreign decode ({what})"] = crc_k.launches
        live_ = (torch.arange(rows.shape[1], device=dev)[None, :]
                 < lens.to(torch.int64)[:, None])
        if bytes(rows[live_].cpu().numpy()) != fplain:
            raise AssertionError(f"foreign decode ({what}): plaintext "
                                 f"differs from gzip's")
        if bool(rows[~live_].any()):
            raise AssertionError(f"foreign decode ({what}): nonzero bytes "
                                 f"past a length")
        log(f"foreign decode ({what}): {len(fstream)} stream bytes -> "
            f"{len(fplain)} bytes in rows {tuple(rows.shape)}, equal to "
            f"stdlib gzip, {rows.shape[0]} member CRCs verified")
    del rows, live_

    # 5d. decode_symbols against its plain version: the hard cases, and 64
    # members of the generic shard at full width (64 KiB members)
    from libflate_tpu_torch.ops.huffman import tables_from_lengths
    from libflate_tpu_torch.serial.deflate import DeflateError, \
        parse_block_headers
    t = time.perf_counter()
    generic = generic_shard(oracle)
    gen_refs = pgzf.index_members(generic)
    log(f"generic input: {len(oracle)} bytes as {len(gen_refs)} "
        f"LF-indexed members of zlib level-9 bodies -> {len(generic)} bytes, "
        f"written in {time.perf_counter() - t:.2f} s")
    gen_bodies = [generic[r.body:r.end - 8] for r in gen_refs]
    g_lit, g_dist, g_starts, g_flags = parse_block_headers(gen_bodies)
    if not (g_flags == 5).all() or int(g_lit.max()) > 15:
        raise AssertionError("a generic member is not one final dynamic "
                             "block")
    g_words = torch.zeros((len(gen_bodies), 4 * (65536 // 4 + 512)),
                          dtype=torch.uint8)
    for i, b_ in enumerate(gen_bodies):
        g_words[i, :len(b_)] = torch.frombuffer(bytearray(b_),
                                                dtype=torch.uint8)
    g_lt, g_dt = tables_from_lengths(torch.from_numpy(g_lit).to(dev),
                                     torch.from_numpy(g_dist).to(dev))
    ds_args = (g_words.view(torch.int32).to(dev),
               torch.from_numpy(g_starts.astype("int32")).to(dev), g_lt,
               g_dt, 65538)
    ds_err = 0
    for what, case in decode_hard_cases().items():
        w_, sb_, lit_, dist_, tabs_, mt_, ch_ = case
        if tabs_ is None:
            lt_, dt_ = tables_from_lengths(torch.from_numpy(lit_).to(dev),
                                           torch.from_numpy(dist_).to(dev))
            ti_ = None
        else:
            lt_, dt_ = (torch.from_numpy(x).to(dev) for x in tabs_[:2])
            ti_ = (torch.from_numpy(tabs_[2]).to(dev) if len(tabs_) > 2
                   else None)
        hargs = (torch.from_numpy(w_).to(dev), torch.from_numpy(sb_).to(dev),
                 lt_, dt_, mt_, ch_, ti_)
        got = deflate_decode.decode_symbols(*hargs)
        want = deflate_decode.decode_symbols_plain(*hargs)
        e_ = max(max_abs_err(x, y) for x, y in zip(got, want))
        log(f"decode_symbols vs plain, hard case {what}: max_abs_err {e_} "
            f"(n_tokens {got[2].tolist()}, err {got[4].tolist()})")
        ds_err = max(ds_err, e_)
    sub = tuple(x[:64] for x in ds_args[:4]) + (65538,)
    got = deflate_decode.decode_symbols(*sub)
    want = deflate_decode.decode_symbols_plain(*sub)
    e_ = max(max_abs_err(x, y) for x, y in zip(got, want))
    log(f"decode_symbols vs plain at 64 generic members x "
        f"{sub[0].shape[1]} words, max_tokens 65538: max_abs_err {e_} "
        f"(tokens {int(got[2].sum())}, errors {int(got[4].sum())})")
    ds_err = max(ds_err, e_)
    errs[kname(deflate_decode.decode_symbols)] = ds_err
    if ds_err or bool(got[4].any()):
        raise AssertionError("decode_symbols disagrees with its plain "
                             "version or failed on a generic member")
    ds_info = deflate_decode.kernel_info()
    log(f"inflate.cu decode_symbols: {json.dumps(ds_info)} [{card_line}]")
    if ds_info["spill_bytes"] or ds_info["streams_per_sm"] < 8:
        raise AssertionError(f"decode_symbols: {ds_info}")
    # the kernel's on-chip tables (the card tests hold its build to the
    # plain model): how many prefixes of the 1024 members' tables need a
    # subtable, and how many tables pass the slots
    for tab, t_ in (("lit", g_lt), ("dist", g_dt)):
        root_bits, slot_cap = deflate_decode.COMPACT[tab]
        ext = deflate_decode.merged_entries_plain(t_, tab).view(
            t_.shape[0], -1, 1 << root_bits)
        n_nonu = (ext != ext[:, :1]).any(dim=1).sum(dim=1)
        log(f"compact {tab} tables of the {t_.shape[0]} generic members: "
            f"non-uniform prefixes max {int(n_nonu.max())}, mean "
            f"{float(n_nonu.double().mean()):.2f}, "
            f"{int((n_nonu > slot_cap).sum())} tables past the {slot_cap} "
            f"slots")
        del ext, n_nonu
    del got, want, sub
    check_held("phase 5d (decode_symbols)")

    # 5e. the sync kernel's debug-checks form against its plain version on
    # the decode shard: no mark on the clean stream, the default kernel's
    # tokens; a poisoned LS index marked and refused by decompress
    dbg_args = sd_args
    dbg = sd.sync_decode(*dbg_args, debug=True, d_words=g["d_words"])
    dbg_p = sd.sync_decode_plain(*dbg_args, debug=True, d_words=g["d_words"])
    dbg_name = kname(sd.sync_decode) + "[debug]"
    errs[dbg_name] = max_abs_err(dbg, dbg_p)
    n_marked = int(((dbg & sd.DEBUG_POISON) != 0).sum())
    if errs[dbg_name] or n_marked or not torch.equal(dbg, toks):
        raise AssertionError(f"debug form: max_abs_err {errs[dbg_name]}, "
                             f"{n_marked} marks on the clean shard")
    bad_stream = poison_ls(stream)
    bg = pgzf._prepare_sync_device(bad_stream, dev)[0]
    bad_args = (bg["words"], bg["start_bits"], bg["counts"], bg["lit_t"],
                bg["dist_t"], bg["k_tok"], bg["root_bits"])
    bad_tok = sd.sync_decode(*bad_args, debug=True, d_words=bg["d_words"])
    bad_err = max_abs_err(bad_tok, sd.sync_decode_plain(
        *bad_args, debug=True, d_words=bg["d_words"]))
    bad_marks = int(((bad_tok & sd.DEBUG_POISON) != 0).sum())
    errs[dbg_name] = max(errs[dbg_name], bad_err)
    log(f"sync_decode debug form vs plain: clean shard (d_words "
        f"{g['d_words']}) max_abs_err 0, 0 marks, tokens equal to the "
        f"default kernel's; first member's LS index at K=1024 (d_words "
        f"{bg['d_words']}): max_abs_err {bad_err}, {bad_marks} tokens marked "
        f"in {int(((bad_tok & sd.DEBUG_POISON) != 0).any(dim=1).sum())} "
        f"slots; {json.dumps(sd.kernel_info(g['root_bits'], debug=True))} "
        f"[{card_line}]")
    if bad_err or not bad_marks:
        raise AssertionError("debug form: the poisoned index was not marked "
                             "as the plain version marks it")
    del dbg_p, bad_tok, bg
    os.environ["LIBFLATE_DEBUG_CHECKS"] = "1"
    try:
        for k in all_kernels:
            k.launches = 0
        sd.sync_decode.debug_launches = 0
        if pgzf.decompress(stream, verify=True, device="cuda") != oracle:
            raise AssertionError("debug checks: the clean shard differs")
        launches[dbg_name] = sd.sync_decode.debug_launches
        if launches[dbg_name] < 1 or sd.sync_decode.launches:
            raise AssertionError("debug checks: the debug form did not run")
        try:
            pgzf.decompress(bad_stream, verify=True, device="cuda")
            raise AssertionError("debug checks: the poisoned index decoded")
        except DeflateError as e:
            log(f"debug checks: the poisoned index raises DeflateError "
                f"({e})")
        # the reference test's flip leaves a chunk start past the body:
        # the sync branch drops the stream and the next branch decodes it
        flipped = bytearray(stream)
        flipped[stream.find(b"LS") + 4 + 15] ^= 0xFF
        if pgzf.decompress(bytes(flipped), device="cuda") != oracle:
            raise AssertionError("debug checks: the flipped delta differs")
        log("debug checks: the reference test's flipped LS delta falls "
            "through the sync branch and decodes equal to gzip")
    finally:
        del os.environ["LIBFLATE_DEBUG_CHECKS"]
    del bad_stream, flipped

    # 5f. pgzf.decompress(verify=True) on the card at full width, counted:
    # the branch taken, the host clock (median of 3), the peak memory
    branch_log: list = []
    real_branches = {}
    for b_name in ("_decompress_sync", "_decompress_shared",
                   "_decompress_generic", "_decompress_foreign"):
        real_branches[b_name] = getattr(pgzf, b_name)

        def spy(*a_, _f=real_branches[b_name], _n=b_name, **k_):
            branch_log.append(_n)
            return _f(*a_, **k_)
        setattr(pgzf, b_name, spy)
    ds_rows: list = []
    real_ds = pgzf.decode_symbols

    def ds_spy(*a_, **k_):
        ds_rows.append(a_[0].shape[0])
        return real_ds(*a_, **k_)
    pgzf.decode_symbols = ds_spy
    dec_streams = {
        "sync shard (64 MiB)": stream,
        "shared shard, LS index stripped": spec_stream,
        "generic shard (1024 zlib level-9 bodies)": generic,
        "1024 stdlib gzip members, no index": foreign,
        "pgzf_encode_small.pgz": (DATA / "pgzf_encode_small.pgz").read_bytes()}
    dec_results = {}
    for what, dstream in dec_streams.items():
        want = oracle if len(dstream) > 1 << 20 else gzip.decompress(dstream)
        for k in all_kernels + (deflate_decode.decode_symbols,):
            k.launches = 0
        branch_log.clear()
        ds_rows.clear()
        if pgzf.decompress(dstream, verify=True, device="cuda") != want:
            raise AssertionError(f"decompress ({what}) differs from gzip")
        counts = {kname(k): k.launches for k in
                  all_kernels + (deflate_decode.decode_symbols,)
                  if k.launches}
        taken = list(branch_log)
        walls = []
        torch.cuda.reset_peak_memory_stats()
        for _ in range(3):
            t = time.perf_counter()
            pgzf.decompress(dstream, verify=True, device="cuda")
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
        dec_results[what] = (statistics.median(walls),
                             torch.cuda.max_memory_allocated(), len(want))
        log(f"decompress({what}, verify=True): branches tried {taken}, "
            f"launches {counts}, decode_symbols rows {ds_rows[:1]}; host "
            f"clock {dec_results[what][0] * 1e3:.2f} ms median of 3, "
            f"{len(want) / dec_results[what][0] / 1e9:.3f} GB/s of "
            f"plaintext, peak {dec_results[what][1] / 2**20:.0f} MiB; equal "
            f"to gzip, every CRC checked [{card_line}]")
        if what.startswith("generic"):
            launches[kname(deflate_decode.decode_symbols)] = counts.get(
                kname(deflate_decode.decode_symbols), 0)
            if (taken[-1] != "_decompress_generic"
                    or ds_rows[:1] != [len(gen_refs)]):
                raise AssertionError(f"generic shard: branches {taken}, "
                                     f"decode_symbols rows {ds_rows[:1]}")
            log(f"generic shard: all {ds_rows[0]} of {len(gen_refs)} "
                f"members took decode_symbols")
    # the decode_symbols launch inside the generic branch, by CUDA events
    in_branch: list = []

    def ds_timed(*a_, **k_):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        res = real_ds(*a_, **k_)
        e1.record()
        torch.cuda.synchronize()
        in_branch.append(e0.elapsed_time(e1))
        return res
    pgzf.decode_symbols = ds_timed
    for _ in range(3):
        pgzf.decompress(generic, verify=True, device="cuda")
    pgzf.decode_symbols = real_ds
    for b_name, fn in real_branches.items():
        setattr(pgzf, b_name, fn)
    log(f"decode_symbols in the generic branch (wrapper, zeroed outputs "
        f"and the launch; 1024 rows): {statistics.median(in_branch):.4f} ms "
        f"median of 3 [{card_line}]")

    # 5g. inflate_device: 1 MiB of raw DEFLATE in small blocks (memLevel 1:
    # matches reach into earlier blocks), and a stream with a stored block
    c_ = zlib.compressobj(6, zlib.DEFLATED, -15, 1)
    multi = c_.compress(oracle[:1 << 20]) + c_.flush()
    c_ = zlib.compressobj(6, zlib.DEFLATED, -15)
    mixed = (c_.compress(oracle[:40000]) + c_.flush(zlib.Z_FULL_FLUSH)
             + b"\x01" + struct.pack("<HH", 30000, 30000 ^ 0xFFFF)
             + oracle[40000:70000])
    for what, raw_, want in (("1 MiB, memLevel 1", multi, oracle[:1 << 20]),
                             ("dynamic block + stored block", mixed,
                              oracle[:70000])):
        deflate_decode.decode_symbols.launches = 0
        t = time.perf_counter()
        res = deflate_decode.inflate_device(raw_, device="cuda")
        torch.cuda.synchronize()
        took = time.perf_counter() - t
        if bytes(res.data) != want or res.end_bit > 8 * len(raw_):
            raise AssertionError(f"inflate_device ({what}) differs")
        log(f"inflate_device({what}): {len(raw_)} bytes -> {len(want)} "
            f"bytes equal to zlib, {deflate_decode.decode_symbols.launches} "
            f"blocks through decode_symbols, end bit {res.end_bit}, "
            f"{took * 1e3:.2f} ms [{card_line}]")
    check_held("phases 4b-5g (the decode paths)")

    # 6. encode kernels against their plain versions, first batch
    data = oracle
    ms_enc = 65536
    n_b = pgzf.DEV_BATCH
    blocks = torch.frombuffer(bytearray(data[:n_b * ms_enc]),
                              dtype=torch.uint8).view(n_b, ms_enc).to(dev)
    nv = torch.full((n_b,), ms_enc, dtype=torch.int32, device=dev)
    keys = sm.prefix_keys(blocks)
    sk, sp = sm.sort_keys(keys)
    sk_p, sp_p = sm.sort_keys_plain(keys)
    cand, m4 = sm.scan_emit(sk, sp, blocks)
    cand_p, m4_p = sm.scan_emit_plain(sk, sp, blocks)
    cand2, lens = pipeline.lengths_stage(blocks, nv, cand, m4)
    jump, tok = parse.parse_inputs(blocks, nv, cand2, lens)
    ex = parse.chunk_exits(jump)
    ex_p = parse.chunk_exits_plain(jump)
    pcap = pipeline.PARSE_CAP
    slots, ovf = parse.walk_emit(jump, tok, ex, pcap)
    slots_p, ovf_p = parse.walk_emit_plain(jump, tok, ex, pcap)
    valid = slots >= 0
    a = torch.where(valid, slots & 511, 0)
    b = torch.where(valid, slots >> 9, 0)
    bins = hist.token_hist(a, b, valid)
    bins_p = hist.token_hist_plain(a, b, valid)
    stats = pipeline.shared_stats(a, b, valid)
    header = deflate_encode.dynamic_header_fields(*stats[:2])
    tables = fields.field_tables(*stats[2:], dev)
    a_h = torch.where(valid, a, -1)
    fv = fields.token_fields(a_h, b, tables)
    fv_p = fields.token_fields_plain(a_h, b, tables)
    # the per-member form: the batch's tokens compacted to a prefix of
    # each member's valid count, each member with its own tables
    pm_nt = valid.sum(dim=1).to(torch.int32)
    pm_order = torch.argsort((~valid).to(torch.int8), dim=1, stable=True)
    pm_a, pm_b = (torch.gather(x, 1, pm_order) for x in (a, b))
    del pm_order
    pm_tables = fields.field_tables(*member_codes(pm_a, pm_b, pm_nt), dev)
    pm_args = (pm_a, pm_b, pm_tables, pm_nt)
    pm_fv = fields.token_fields(*pm_args)
    pm_fv_p = fields.token_fields_plain(*pm_args)
    values, widths = deflate_encode.assemble_fields(
        header, fv, stats[2][256], stats[3][256])
    fpad = (-values.shape[1]) % pack.F_CH
    values = torch.nn.functional.pad(values, (0, fpad)).contiguous()
    widths = torch.nn.functional.pad(widths, (0, fpad)).contiguous()
    starts, bits = pack.chunk_starts(widths)
    cstarts = starts[:, :-1].contiguous()
    w_out = (int(bits.max()) + 31) // 32 + 1
    words = pack.pack_stitch(values, widths, cstarts, w_out)
    words_p = pack.pack_stitch_plain(values, widths, cstarts, w_out)
    torch.cuda.synchronize()
    pm_err = max(max_abs_err(x, y) for x, y in zip(pm_fv, pm_fv_p))
    enc_errs = {
        kname(sm.sort_keys): max(max_abs_err(sk, sk_p),
                                 max_abs_err(sp, sp_p)),
        kname(sm.scan_emit): max(max_abs_err(cand, cand_p),
                                 max_abs_err(m4, m4_p)),
        kname(parse.chunk_exits): max_abs_err(ex, ex_p),
        kname(parse.walk_emit): max(max_abs_err(slots, slots_p),
                                    max_abs_err(ovf, ovf_p)),
        kname(hist.token_hist): max_abs_err(bins, bins_p),
        kname(fields.token_fields): max(pm_err, max(
            max_abs_err(x, y) for x, y in zip(fv, fv_p))),
        kname(pack.pack_stitch): max_abs_err(words, words_p)}
    errs.update(enc_errs)
    log(f"encode kernels vs plain at members={n_b} n={ms_enc} "
        f"slots={a.shape[1]} fields={values.shape[1]} words={w_out}: "
        f"max_abs_err {enc_errs} "
        f"(tokens {int(valid.sum())}, overflow {bool(ovf.any())}); "
        f"token_fields per-member form ({tuple(pm_tables.shape)} tables, "
        f"counts {int(pm_nt.min())}-{int(pm_nt.max())}, widths up to "
        f"{int(pm_tables[:, fields._LIT_W:fields._DIST_REV].max())} / "
        f"{int(pm_tables[:, fields._DIST_W:fields._LEN_CODE].max())}): "
        f"max_abs_err {pm_err}")
    if any(errs.values()):
        raise AssertionError(f"a kernel disagrees with its plain version: "
                             f"{errs}")
    del sk_p, sp_p, cand_p, m4_p, ex_p, slots_p, fv_p, words_p, pm_fv_p

    # 6b. the encode options' kernels against their plain versions, same
    # batch: LCP as the quality mode calls it (sort m4, lcp_rounds=8, the
    # 8192 tail window) and as the hash profile does (no m4, 6 rounds),
    # one chain level's gather, the hash table of the batch
    lcp_args = (blocks, cand, nv)
    lcp_kw = {"max_rounds": 8, "window": pipeline.LCP_TAIL_WINDOW,
              "m4": m4, "m_exact": sm.M_EXACT}
    ln8 = lcp.match_lengths(*lcp_args, **lcp_kw)
    ln8_p = lcp.match_lengths_plain(*lcp_args, **lcp_kw)
    ids = hm.keys_hashes(blocks)
    hcand_raw = hm.hash_candidates(ids)
    hcand_raw_p = hm.hash_candidates_plain(ids)
    hcand = hm.prefix_candidates(blocks)
    hlcp_args = (blocks, hcand, nv)
    hlcp_kw = {"max_rounds": pipeline.KERNEL_LCP_ROUNDS, "window": 32768}
    ln6 = lcp.match_lengths(*hlcp_args, **hlcp_kw)
    ln6_p = lcp.match_lengths_plain(*hlcp_args, **hlcp_kw)
    level2 = gather.gather_rows(cand, cand, window=32768)
    level2_p = gather.gather_rows_plain(cand, cand, window=32768)
    # a chain level of the quality mode: no m4, lcp_rounds=8, window 32768
    clcp_args = (blocks, level2, nv)
    clcp_kw = {"max_rounds": 8, "window": 32768}
    lnc = lcp.match_lengths(*clcp_args, **clcp_kw)
    lnc_p = lcp.match_lengths_plain(*clcp_args, **clcp_kw)
    torch.cuda.synchronize()
    lcp_errs = {"sort m4": max_abs_err(ln8, ln8_p),
                "chain level": max_abs_err(lnc, lnc_p),
                "hash": max_abs_err(ln6, ln6_p)}
    errs.update({
        kname(lcp.match_lengths): max(lcp_errs.values()),
        kname(gather.gather_rows): max_abs_err(level2, level2_p),
        kname(hm.hash_candidates): max_abs_err(hcand_raw, hcand_raw_p)})
    log(f"option kernels vs plain at members={n_b} n={ms_enc}: "
        f"match_lengths (sort m4, 8 rounds, window 8192; chain level 2, "
        f"no m4, 8 rounds, window 32768; hash cand, 6 rounds, window "
        f"32768) {lcp_errs}, gather_rows (chain level 2) "
        f"{errs['gather.gather_rows']}, hash_candidates "
        f"{errs['hash_match.hash_candidates']} (lengths > 16: "
        f"{int((ln8 > 16).sum())}; chain-level lengths 32: "
        f"{int((lnc == 32).sum())}; hash cand >= 0: "
        f"{int((hcand >= 0).sum())}; level-2 cand >= 0: "
        f"{int((level2 >= 0).sum())})")
    if any(errs.values()):
        raise AssertionError(f"a kernel disagrees with its plain version: "
                             f"{errs}")
    del ln8_p, ln6_p, lnc_p, level2_p, hcand_raw_p

    # 6c. the checksum kernels against their plain versions: the CRC
    # f-values of the decode shard's rows (phase 4's resolve output), of
    # one speculative group's rows (phase 4b's group expanded) and of the
    # first encode batch's blocks; Adler-32 of each of them flattened
    o_cap = st["out_cap"]
    s_packed, s_nt, _ = deflate_decode.tokens_from_emit_packed(s_emit,
                                                               o_cap + 2)
    s_plain = device_expand.expand_members(s_packed, s_nt, o_cap)[0]
    ck_errs = {}
    for what, rows_ in (("decode shard", out), ("speculative group", s_plain),
                        ("encode batch", blocks)):
        f_k = checksum.crc32_f_rows(rows_)
        f_p = checksum.crc32_f_rows_plain(rows_)
        ad_k = checksum.adler32_device(rows_.reshape(-1))
        ad_p = checksum.adler32_device_plain(rows_.reshape(-1))
        ck_errs[f"{what} {tuple(rows_.shape)}"] = {
            kname(checksum.crc32_f_rows): max_abs_err(f_k, f_p),
            kname(checksum.adler32_device): abs(ad_k - ad_p)}
    for k in (checksum.crc32_f_rows, checksum.adler32_device):
        errs[kname(k)] = max(e[kname(k)] for e in ck_errs.values())
    log(f"checksum kernels vs plain: max_abs_err {ck_errs}")
    if any(errs.values()):
        raise AssertionError(f"a kernel disagrees with its plain version: "
                             f"{errs}")

    # 7. the encode main path, counted
    for k in all_kernels:
        k.launches = 0
    enc_stream = pgzf.compress(data, member_size=ms_enc, device="cuda")
    torch.cuda.synchronize()
    enc_launches = {kname(k): k.launches for k in enc_kernels}
    launches.update(enc_launches)
    log(f"encode main path launches: {enc_launches}")
    if min(enc_launches.values()) < 1:
        raise AssertionError(f"a kernel of the path did not run: "
                             f"{enc_launches}")
    n_batches = -(-len(data) // (n_b * ms_enc))
    check_one_sort_per_batch(enc_launches, n_batches, "encode main path")
    log(f"encode main path crc32_f_rows launches: {crc_k.launches}")
    if crc_k.launches < 1:
        raise AssertionError("encode main path: crc32_f_rows did not run")
    crc_runs["encode"] = crc_k.launches
    if gzip.decompress(enc_stream) != data:
        raise AssertionError("stdlib gzip does not read back the encode")
    back, back_len = pgzf.decompress_to_device(enc_stream, verify=True,
                                               device="cuda")
    live = (torch.arange(back.shape[1], device=dev)[None, :]
            < back_len.to(torch.int64)[:, None])
    if bytes(back[live].cpu().numpy()) != data:
        raise AssertionError("the port's decode does not read back the "
                             "encode")
    ratio = len(enc_stream) / len(data)
    log(f"encode main path: {len(data)} bytes -> {len(enc_stream)} bytes "
        f"(ratio {ratio:.6f}), read back by stdlib gzip and by "
        f"decompress_to_device(verify=True)")
    # 7d. the speculative main path on the encode, LS index stripped
    spec_main_path(enc_stream, data, back,
                   "speculative decode of the default encode")
    del back, live

    def read_back(stream: bytes, what: str) -> None:
        if gzip.decompress(stream) != data:
            raise AssertionError(f"stdlib gzip does not read back {what}")
        back, back_len = pgzf.decompress_to_device(stream, verify=True,
                                                   device="cuda")
        live = (torch.arange(back.shape[1], device=dev)[None, :]
                < back_len.to(torch.int64)[:, None])
        if bytes(back[live].cpu().numpy()) != data:
            raise AssertionError(f"the port's decode does not read back "
                                 f"{what}")

    def run_counted(kernels, what: str, per_batch: bool = False,
                    **kw) -> bytes:
        for k in all_kernels:
            k.launches = 0
        with device_matcher(kw.pop("matcher", "sort")):
            stream = pgzf.compress(data, member_size=ms_enc, device="cuda",
                                   **kw)
        torch.cuda.synchronize()
        counts = {kname(k): k.launches for k in kernels}
        log(f"{what} launches: {counts}")
        if min(counts.values()) < 1:
            raise AssertionError(f"a kernel of the path did not run: "
                                 f"{counts}")
        if per_batch:
            check_one_sort_per_batch(counts, n_batches, what)
        read_back(stream, what)
        log(f"{what}: {len(data)} bytes -> {len(stream)} bytes (ratio "
            f"{len(stream) / len(data):.6f}, default {ratio:.6f}), read "
            f"back by stdlib gzip and by decompress_to_device(verify=True)")
        return stream

    # 7b. the quality mode, counted
    q_stream = run_counted(enc_kernels + (lcp.match_lengths,
                                          gather.gather_rows),
                           "quality mode (chain 8, lcp_rounds 8)",
                           per_batch=True, options=quality)
    for k in (lcp.match_lengths, gather.gather_rows):
        launches[kname(k)] = k.launches
    # 7c. the hash profile at full depth (8 batches), counted
    h_stream = run_counted(enc_kernels[2:] + (hm.hash_candidates,
                                              lcp.match_lengths),
                           "hash profile (LIBFLATE_DEVICE_MATCHER=hash, 8 "
                           "batches)", matcher="hash")
    launches[kname(hm.hash_candidates)] = hm.hash_candidates.launches
    # nothing calls gather_two: 0 in every run
    launches[kname(gather.gather_two)] = gather.gather_two.launches

    # 8. byte identity with the committed reference streams
    refs = sorted(DATA.glob("pgzf_encode_*.pgz"))
    if not refs:
        raise AssertionError("no committed reference stream")
    for path in refs:
        ref = path.read_bytes()
        plain = gzip.decompress(ref)
        first = pgzf.index_members(ref)[0]
        member = struct.unpack_from("<I", ref, first.end - 4)[0]
        opts, matcher = REFERENCE_OPTIONS.get(path.name, (None, "sort"))
        options = EncodeOptions(**opts) if opts else None
        with device_matcher(matcher):
            got = pgzf.compress(plain, member_size=member, options=options,
                                device="cuda")
        if got != ref:
            raise AssertionError(f"compress differs from {path.name}")
        log(f"{path.name}: {len(plain)} bytes at member_size {member}, "
            f"{matcher} matcher, {options} -> {len(ref)} bytes, "
            f"byte-identical to the reference")

    check_held("phases 6-8 (the encode paths)")

    # 9. timing
    n_dec = len(oracle)
    torch.cuda.reset_peak_memory_stats()
    chain_ms = cuda_ms(lambda: pgzf._run_sync_chain(g), 11)
    peak = torch.cuda.max_memory_allocated()
    walls = []
    for _ in range(5):
        t = time.perf_counter()
        pgzf.decompress_to_device(stream, verify=True, device="cuda")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    e2e_s = statistics.median(walls)

    spec_src = "libflate_tpu_torch/csrc/spec_decode.cu"
    n_chunks = s_ent.shape[1]
    entered = int(((s_ent.to(torch.int64) >> 9)
                   == torch.arange(n_chunks, device=dev)[None, :]).sum())
    emitted = int((s_rows[:, :, :decode.MAX_EMIT] >= 0).sum())
    # the greedy walk's entry chain reads one exit per chunk after the first
    walk_entries = jump.shape[0] * (jump.shape[1] // parse.CHUNK - 1)
    sym = torch.cat([
        torch.where(b > 0, hist.length_symbol(a.clamp(3, 258)), a)[valid],
        hist.DIST_BIN0 + hist.dist_symbol(b[valid & (b > 0)])])
    # rank: the valid prefix of starts, pk and valid (the slots past it
    # are not needed), n_out, and src and lit written once
    rank_bytes = (int(rk_args[2].sum()) * (4 + 4 + 1)
                  + nbytes(rk_args[3], src, lit))
    # pack: every width, the 32-byte sectors of values that hold a nonzero
    # width (a zero-width field's value is not needed), the starts, words
    live_sectors = int((widths.view(-1, 8) > 0).any(dim=1).sum())
    pack_bytes = nbytes(widths, cstarts, words) + 32 * live_sectors
    # hist: every valid byte, the 32-byte sectors of a and of b that hold a
    # valid slot (an invalid slot's a and b are not needed), the bins
    v_flat = valid.reshape(-1).to(torch.uint8)
    v_flat = torch.nn.functional.pad(v_flat, (0, (-v_flat.numel()) % 8))
    hist_sectors = int(v_flat.view(-1, 8).any(dim=1).sum())
    hist_bytes = nbytes(valid, bins) + 2 * 32 * hist_sectors
    # the speculative walk: the 32-byte sectors of tok and of nxt that hold
    # a position a walk visits, entries, the emit written once
    visited = walk_visits(s_nxt, s_ent)
    walk_sectors = int(visited.view(visited.shape[0], -1, 8).any(dim=2)
                       .sum())
    walk_bytes = 2 * 32 * walk_sectors + nbytes(s_ent, s_emit)
    log(f"data-dependent bounds: rank reads {int(rk_args[2].sum())} valid "
        f"of {rk_args[2].numel()} token slots, {rank_bytes} bytes "
        f"(every slot: {nbytes(*rk_args[:4], src, lit)}); pack reads "
        f"{live_sectors} of {values.numel() // 8} value sectors, "
        f"{pack_bytes} bytes (every value: "
        f"{nbytes(values, widths, cstarts, words)}); token_hist reads a and "
        f"b in {hist_sectors} of {v_flat.numel() // 8} sectors, "
        f"{hist_bytes} bytes (every slot: {nbytes(a, b, valid, bins)}); "
        f"speculative walk_emit visits {int(visited.sum())} positions "
        f"({emitted} tokens emitted) in {walk_sectors} of "
        f"{visited.numel() // 8} sectors of tok and of nxt, {walk_bytes} "
        f"bytes (whole chunks, as the kernel stages them: "
        f"{nbytes(s_nxt, s_tok, s_ent, s_emit)})")
    rows = [
        # name, source, replaces, kernel, plain, library, bytes, reps
        (kname(sd.sync_decode), "libflate_tpu_torch/csrc/sync_decode.cu",
         "libflate_tpu/ops/pallas_sync_decode.py:80",
         lambda: sd.sync_decode(*sd_args),
         lambda: sd.sync_decode_plain(*sd_args), None,
         nbytes(*sd_args[:5], toks), 20, 2),
        (kname(rank.rank_emit_src), "libflate_tpu_torch/csrc/rank.cu",
         "libflate_tpu/ops/pallas_rank.py:150",
         lambda: rank.rank_emit_src(*rk_args),
         lambda: rank.rank_emit_src_plain(*rk_args), None,
         rank_bytes, 20, 3),
        (kname(expand.resolve_bytes), "libflate_tpu_torch/csrc/resolve.cu",
         "libflate_tpu/ops/pallas_expand.py:74",
         lambda: expand.resolve_bytes(src, lit),
         lambda: expand.resolve_bytes_plain(src, lit), None,
         nbytes(src, lit, out), 20, 3),
        (kname(sm.sort_keys), "libflate_tpu_torch/csrc/match.cu",
         "libflate_tpu/ops/pallas_sort.py:66",
         lambda: sm.sort_keys(keys), lambda: sm.sort_keys_plain(keys),
         lambda: torch.sort(keys, dim=1, stable=True),
         nbytes(keys, sk, sp), 10, 3),
        (kname(sm.scan_emit), "libflate_tpu_torch/csrc/match.cu",
         "libflate_tpu/ops/pallas_sort.py:212",
         lambda: sm.scan_emit(sk, sp, blocks),
         lambda: sm.scan_emit_plain(sk, sp, blocks), None,
         nbytes(sk, sp, blocks, cand, m4), 10, 3),
        (kname(parse.chunk_exits), "libflate_tpu_torch/csrc/parse.cu",
         "libflate_tpu/ops/pallas_parse.py:57",
         lambda: parse.chunk_exits(jump),
         lambda: parse.chunk_exits_plain(jump), None,
         nbytes(jump, ex), 10, 2),
        # reads jump and tok whole and one exit per chunk on the entry chain
        (kname(parse.walk_emit), "libflate_tpu_torch/csrc/parse.cu",
         "libflate_tpu/ops/pallas_parse.py:143",
         lambda: parse.walk_emit(jump, tok, ex, pcap),
         lambda: parse.walk_emit_plain(jump, tok, ex, pcap), None,
         nbytes(jump, tok, slots, ovf) + 4 * walk_entries, 10, 2),
        (kname(hist.token_hist), "libflate_tpu_torch/csrc/fields.cu",
         "libflate_tpu/ops/pallas_hist.py:46",
         lambda: hist.token_hist(a, b, valid),
         lambda: hist.token_hist_plain(a, b, valid),
         lambda: torch.bincount(sym, minlength=hist.BINS),
         hist_bytes, 20, 3),
        (kname(fields.token_fields), "libflate_tpu_torch/csrc/fields.cu",
         "libflate_tpu/ops/pallas_fields.py:120",
         lambda: fields.token_fields(a_h, b, tables),
         lambda: fields.token_fields_plain(a_h, b, tables), None,
         nbytes(a_h, b, tables, *fv), 20, 3),
        (kname(pack.pack_stitch), "libflate_tpu_torch/csrc/pack.cu",
         "libflate_tpu/ops/pallas_pack.py:61",
         lambda: pack.pack_stitch(values, widths, cstarts, w_out),
         lambda: pack.pack_stitch_plain(values, widths, cstarts, w_out),
         None, pack_bytes, 20, 3),
        (kname(lcp.match_lengths), "libflate_tpu_torch/csrc/lcp.cu",
         "libflate_tpu/ops/pallas_lcp.py:72",
         lambda: lcp.match_lengths(*lcp_args, **lcp_kw),
         lambda: lcp.match_lengths_plain(*lcp_args, **lcp_kw), None,
         nbytes(blocks, cand, m4, nv, ln8), 20, 3),
        (kname(gather.gather_rows), "libflate_tpu_torch/csrc/gather.cu",
         "libflate_tpu/ops/pallas_gather.py:41",
         lambda: gather.gather_rows(cand, cand, window=32768),
         lambda: gather.gather_rows_plain(cand, cand, window=32768),
         lambda: torch.gather(cand, 1, cand_idx),
         nbytes(cand, cand, level2), 20, 3),
        (kname(hm.hash_candidates), "libflate_tpu_torch/csrc/hash.cu",
         "libflate_tpu/ops/pallas_lz77.py:52",
         lambda: hm.hash_candidates(ids),
         lambda: hm.hash_candidates_plain(ids), None,
         nbytes(ids, hcand_raw), 10, 1),
        (kname(decode.speculative_decode_positions), spec_src,
         "libflate_tpu/ops/pallas_decode.py:96",
         lambda: decode.speculative_decode_positions(*sp_args),
         lambda: decode.speculative_decode_positions_plain(*sp_args), None,
         nbytes(*sp_args, s_tok, s_nxt), 20, 3),
        (kname(decode.chunk_exit_maps), spec_src,
         "libflate_tpu/ops/pallas_decode.py:158",
         lambda: decode.chunk_exit_maps(s_nxt),
         lambda: decode.chunk_exit_maps_plain(s_nxt), None,
         nbytes(s_nxt, s_ex), 20, 2),
        # the reference's XLA scan, not a Pallas kernel; it reads one exit
        # per chunk the orbit enters
        (kname(deflate_decode.chain_entries), spec_src,
         "libflate_tpu/ops/deflate_decode.py:374",
         lambda: deflate_decode.chain_entries(s_ex, st["starts"]),
         lambda: deflate_decode.chain_entries_plain(s_ex, st["starts"]),
         None, 4 * entered + nbytes(st["starts"], s_ent), 20, 2),
        # reads the sectors of tok and nxt that hold a visited position
        (kname(decode.walk_emit), spec_src,
         "libflate_tpu/ops/pallas_decode.py:271",
         lambda: decode.walk_emit(s_nxt, s_tok, s_ent),
         lambda: decode.walk_emit_plain(s_nxt, s_tok, s_ent), None,
         walk_bytes, 20, 2),
        (kname(gather.gather_two), "libflate_tpu_torch/csrc/gather.cu",
         "libflate_tpu/ops/pallas_gather.py:135",
         lambda: gather.gather_two(*g2_args, win=g2_win),
         lambda: gather.gather_two_plain(*g2_args, win=g2_win),
         lambda: [torch.gather(t_, 1, g2_flat) for t_ in g2_flat_tabs],
         nbytes(*g2_args, *g2), 20, 3),
    ]
    cand_idx = cand.to(torch.int64).clamp(min=0)
    g2_flat = g2_idx.view(g2_b, -1).to(torch.int64).clamp(0, g2_r * 128 - 1)
    g2_flat_tabs = [t_.view(g2_b, -1) for t_ in g2_tabs]
    # decode_symbols at the generic branch's shapes: the stream words from
    # each start word to one past the end word, the start bits, every
    # output once, and each stream's table pair read once (the design
    # builds its on-chip tables from them)
    ds_out = deflate_decode.decode_symbols(*ds_args)
    torch.cuda.synchronize()
    ds_bytes = (int((((ds_out[3].to(torch.int64) >> 5)
                      - (ds_args[1].to(torch.int64) >> 5) + 2) * 4).sum())
                + nbytes(ds_args[1], *ds_out, *ds_args[2:4]))
    rows.append(
        (kname(deflate_decode.decode_symbols),
         "libflate_tpu_torch/csrc/inflate.cu",
         "libflate_tpu/ops/deflate_decode.py:81",
         lambda: deflate_decode.decode_symbols(*ds_args),
         lambda: deflate_decode.decode_symbols_plain(*ds_args), None,
         ds_bytes, 5, 1))
    rows.append(
        (dbg_name, "libflate_tpu_torch/csrc/sync_decode.cu",
         "libflate_tpu/ops/pallas_sync_decode.py:80",
         lambda: sd.sync_decode(*sd_args, debug=True, d_words=g["d_words"]),
         lambda: sd.sync_decode_plain(*sd_args, debug=True,
                                      d_words=g["d_words"]), None,
         nbytes(*sd_args[:5], toks), 20, 2))
    # the checksum kernels: the CRC f-values of the decode shard's rows
    # (each row read once, a register written a row), Adler-32 of its 64
    # MiB (read once, one word written)
    crc_f = checksum.crc32_f_rows(out)
    ad_in = out.view(-1)
    rows += [
        (kname(checksum.crc32_f_rows), "libflate_tpu_torch/csrc/checksum.cu",
         "libflate_tpu/ops/checksum.py:170",
         lambda: checksum.crc32_f_rows(out),
         lambda: checksum.crc32_f_rows_plain(out), None,
         nbytes(out, crc_f), 20, 3),
        (kname(checksum.adler32_device),
         "libflate_tpu_torch/csrc/checksum.cu",
         "libflate_tpu/ops/checksum.py:288",
         lambda: checksum.adler32_device(ad_in),
         lambda: checksum.adler32_device_plain(ad_in), None,
         nbytes(ad_in) + 4, 20, 3)]
    launches[kname(checksum.crc32_f_rows)] = sum(crc_runs.values())
    launches[kname(checksum.adler32_device)] = 0     # phase 10 adds its runs
    log(f"crc32_f_rows main-path launches: {crc_runs}")
    summary = []
    for name_, source, replaces, kfn, pfn, lfn, moved, reps, preps in rows:
        ms = cuda_ms(kfn, reps)
        plain_ms = cuda_ms(pfn, preps)
        lib_ms = cuda_ms(lfn, reps) if lfn is not None else None
        bound = moved / HBM_BYTES_PER_MS
        summary.append({"name": name_, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name_],
                        "max_abs_err": errs[name_], "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound,
                        "bound_by": "bytes", "library_ms": lib_ms})
        log(f"{name_}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bound:.4f} ms ({moved} bytes), library "
            f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'} "
            f"[{card_line}]")
    row = {r["name"]: r for r in summary}
    # decode_symbols' latency bounds: the longest stream's chain of
    # dependent table loads (a litlen entry a token, a distance entry a
    # match, the EOB's entry) times the latency of one dependent load:
    # in L2 (the first design's tables), measured by one thread chasing a
    # random cycle of 2^22 int32 (16 MiB, inside the L2) with L2-only
    # loads; in shared memory (this design's), by one thread chasing a
    # random cycle of 4096 int32 staged there
    def chase_ns(entry: str, n: int, hops: int) -> float:
        order = torch.randperm(n, device=dev)
        nxt = torch.empty(n, dtype=torch.int32, device=dev)
        nxt[order] = torch.roll(order, -1).to(torch.int32)
        sink = torch.zeros(1, dtype=torch.int32, device=dev)
        return cuda_ms(lambda: _build.launch(
            entry, nxt.data_ptr(), hops, sink.data_ptr()), 3) * 1e6 / hops
    ns_hop = chase_ns("lf_load_chase", 1 << 22, 1 << 20)
    ns_smem = chase_ns("lf_smem_chase", 4096, 1 << 22)
    ds_loads = int((ds_out[2].to(torch.int64)
                    + (ds_out[1] > 0).sum(dim=1) + 1).max())
    ds_lat_ms = ds_loads * ns_hop / 1e6
    ds_smem_ms = ds_loads * ns_smem / 1e6
    ds_w, ds_sb, ds_lt, ds_dt = (x.contiguous() for x in ds_args[:4])
    ds_a = torch.zeros_like(ds_out[0])
    ds_bb = torch.zeros_like(ds_out[1])
    ds_n, ds_e = torch.empty_like(ds_out[2]), torch.empty_like(ds_out[3])
    ds_r = torch.empty_like(ds_out[4])
    ds_alone = cuda_ms_many([lambda: _build.launch(
        "lf_decode_symbols", ds_w.data_ptr(), ds_w.shape[1], ds_sb.data_ptr(),
        ds_lt.data_ptr(), ds_dt.data_ptr(), 0, ds_w.shape[0], 65538,
        deflate_decode._decode_steps(65538, deflate_decode.DECODE_CHUNK),
        ds_a.data_ptr(), ds_bb.data_ptr(), ds_n.data_ptr(), ds_e.data_ptr(),
        ds_r.data_ptr())], 48)
    dsr = row[kname(deflate_decode.decode_symbols)]
    half = "reaches" if ds_alone <= 2 * ds_smem_ms else "misses"
    log(f"decode_symbols at {ds_w.shape[0]} members: kernel "
        f"{dsr['ms']:.4f} ms, alone {ds_alone:.4f} ms (48 launches), bytes "
        f"bound {dsr['bound_ms']:.4f} ms ({ds_bytes} bytes, each stream's "
        f"table pair read once), latency bounds (longest stream: "
        f"{ds_loads} dependent table loads) {ds_smem_ms:.4f} ms in shared "
        f"memory ({ns_smem:.2f} ns a dependent shared load, measured; the "
        f"design's bound: alone it {half} half of it) and {ds_lat_ms:.4f} "
        f"ms in L2 ({ns_hop:.2f} ns a dependent L2 load, measured); tokens "
        f"{int(ds_out[2].sum())}, longest stream {int(ds_out[2].max())}; "
        f"{json.dumps(deflate_decode.kernel_info())} [{card_line}]")
    # chain_entries' latency bound: each member's orbit takes one
    # dependent exit load a chunk it enters; the longest member's count
    # times a dependent L2 load
    ce_loads = int(((s_ent.to(torch.int64) >> 9) == torch.arange(
        s_ent.shape[1], device=dev)[None, :]).sum(dim=1).max())
    ce_lat_ms = ce_loads * ns_hop / 1e6
    cer = row[kname(deflate_decode.chain_entries)]
    ce_alone = cuda_ms_many([lambda: deflate_decode.chain_entries(
        s_ex, st["starts"])], 48)
    log(f"chain_entries latency bound {ce_lat_ms:.4f} ms (longest member's "
        f"orbit enters {ce_loads} of {s_ent.shape[1]} chunks x "
        f"{ns_hop:.2f} ns a dependent L2 load); kernel {cer['ms']:.4f} ms, "
        f"alone {ce_alone:.4f} ms (48 launches), bytes bound "
        f"{cer['bound_ms']:.4f} ms; alone it "
        f"{'reaches' if ce_alone <= 2 * ce_lat_ms else 'misses'} half of "
        f"the latency bound [{card_line}]")
    del ds_out, ds_a, ds_bb
    # the checksum kernels alone, 48 back to back on the same inputs: the
    # CRC's launch (no allocation; pass 2 only for rows over one tile) and
    # the Adler's two launches without the read-back of its word
    ck_tiles = checksum.crc_tiles(out.shape[1])
    ck_scr = torch.empty(out.shape[0] * ck_tiles, dtype=torch.int32,
                         device=dev)
    ck_consts = checksum._constants_on(dev)
    crc_alone = cuda_ms_many([lambda: _build.launch(
        "lf_crc32_rows", out.data_ptr(), out.shape[0], out.shape[1],
        ck_tiles, ck_consts.data_ptr(),
        ck_scr.data_ptr() if ck_tiles > 1 else None, crc_f.data_ptr())], 48)
    ad_blocks = checksum.adler_blocks(ad_in.numel())
    ad_part = torch.empty(2 * ad_blocks, dtype=torch.int32, device=dev)
    ad_word = torch.empty(1, dtype=torch.int32, device=dev)
    adler_alone = cuda_ms_many([lambda: _build.launch(
        "lf_adler32", ad_in.data_ptr(), ad_in.numel(), ad_blocks,
        ad_part.data_ptr(), ad_word.data_ptr())], 48)
    for k_, alone_, info_ in (
            (checksum.crc32_f_rows, crc_alone, ("crc_tiles", "crc_fold")),
            (checksum.adler32_device, adler_alone,
             ("adler_partial", "adler_fold"))):
        r_ = row[kname(k_)]
        log(f"{kname(k_)}: kernel {r_['ms']:.4f} ms, alone {alone_:.4f} ms "
            f"(48 launches), plain {r_['plain_ms']:.4f} ms, bound "
            f"{r_['bound_ms']:.4f} ms; alone it "
            f"{'reaches' if alone_ <= 2 * r_['bound_ms'] else 'misses'} "
            f"half of the bound; " + ", ".join(
                f"{i} {json.dumps(checksum.kernel_info(i))}" for i in info_)
            + f" [{card_line}]")
    if (max_abs_err(crc_f, checksum.crc32_f_rows_plain(out))
            or int(ad_word.item()) & 0xFFFFFFFF
            != checksum.adler32_device_plain(ad_in)):
        raise AssertionError("a checksum kernel launched alone disagrees "
                             "with its plain version")
    del ck_scr, ad_part, ad_word
    check_held("phase 9's timed launches")
    # the search half of rank_emit_src alone: every position searched in
    # the sentinel starts; not library_ms, since it computes neither src
    # nor lit, and the port never calls it
    rk_sent = rank._sentinel_starts(rk_args[0], rk_args[2], cap)
    rk_pos = torch.arange(cap, dtype=torch.int32, device=dev).expand(
        rk_sent.shape[0], cap).contiguous()
    search_ms = cuda_ms(
        lambda: torch.searchsorted(rk_sent, rk_pos, right=True), 20)
    rnk = row[kname(rank.rank_emit_src)]
    log(f"rank yardstick: torch.searchsorted(right=True) of every output "
        f"position {tuple(rk_pos.shape)} in the starts {search_ms:.4f} ms "
        f"(the search half of rank_emit_src only, not its library_ms); "
        f"rank_emit_src {rnk['ms']:.4f} ms, bound {rnk['bound_ms']:.4f} "
        f"[{card_line}]")
    del rk_sent, rk_pos
    # the sync decode, histogram, rank, resolve, pack and hash kernels
    # launched alone back to back (outputs allocated once; the pack's rows
    # zeroed once, which its plain stores and atomicOr then leave as they
    # are; the histogram's state stays zero between launches), beside the
    # pack's row memset: on the same inputs each time (warm: part of them
    # stays in the 50 MB L2), and cycling through COLD_COPIES copies of the
    # inputs (cold: a launch's inputs were last read three launches and
    # > 100 MB before); the resolve also on the first 128 members alone
    src_a, lit_a = torch.empty_like(src), torch.empty_like(lit)
    out_a, hcand_a = torch.empty_like(out), torch.empty_like(hcand_raw)
    n_grp = pgzf.DEV_BATCH
    out_g_a = torch.empty_like(out[:n_grp])
    words_a = torch.zeros_like(words)
    toks_a, bins_a = torch.empty_like(toks), torch.empty_like(bins)
    sd_rows = torch.from_numpy(sd.ROWS).to(dev)
    hist_state = hist.kernel_state()

    def sync_alone(w_, sb_, cnt_):
        return lambda: _build.launch(
            "lf_sync_decode", w_.data_ptr(), w_.numel(), sb_.data_ptr(),
            cnt_.data_ptr(), g["lit_t"].data_ptr(), g["dist_t"].data_ptr(),
            sd_rows.data_ptr(), g["root_bits"], toks_a.data_ptr(),
            sb_.numel(), g["k_tok"])

    def hist_alone(a_, b_, v_):
        return lambda: _build.launch(
            "lf_token_hist", a_.data_ptr(), b_.data_ptr(),
            v_.view(torch.uint8).data_ptr(), a_.numel(), bins_a.data_ptr(),
            hist_state.data_ptr())

    rk_flags = rank.tile_flags(bsz, cap, dev)

    def rank_alone(st_, pk_, va_, no_):
        return lambda: _build.launch(
            "lf_rank_emit_src", st_.data_ptr(), va_.data_ptr(),
            pk_.data_ptr(), no_.data_ptr(), src_a.data_ptr(),
            lit_a.data_ptr(), rk_flags.data_ptr(), bsz, st_.shape[1], cap)

    def resolve_alone(s_, l_, o_):
        return lambda: _build.launch(
            "lf_resolve_bytes", s_.data_ptr(), l_.data_ptr(), o_.data_ptr(),
            s_.shape[0], s_.shape[1])

    def hash_alone(h_):
        return lambda: _build.launch(
            "lf_hash_candidates", h_.data_ptr(), hcand_a.data_ptr(),
            h_.shape[0], h_.shape[1])

    def pack_alone(v_, w_, s_):
        return lambda: _build.launch(
            "lf_pack_stitch", v_.data_ptr(), w_.data_ptr(), s_.data_ptr(),
            words_a.data_ptr(), v_.shape[0], v_.shape[1] // pack.F_CH,
            w_out)

    # the three LCP calls: (name, kernel output, its arguments); an m4 of
    # None passes the candidates in its place, as the wrapper does
    lcp_calls = [("sort m4", ln8, lcp_args, lcp_kw),
                 ("chain level", lnc, clcp_args, clcp_kw),
                 ("hash", ln6, hlcp_args, hlcp_kw)]
    lcp_outs = {k: torch.empty_like(o_) for k, o_, _a, _k in lcp_calls}

    def lcp_alone(call, kw_, blk_, c_, m_, nv_):
        wg, first = lcp._band(blk_.shape[1], kw_["window"], m_,
                              kw_.get("m_exact", 4))
        m_ = c_ if m_ is None else m_
        return lambda: _build.launch(
            "lf_match_lengths", blk_.data_ptr(), c_.data_ptr(),
            m_.data_ptr(), nv_.data_ptr(), lcp_outs[call].data_ptr(),
            blk_.shape[0], blk_.shape[1], kw_["max_rounds"], wg, first)

    fields_a = [torch.empty_like(a_h) for _ in range(4)]
    pm_fields_a = [torch.empty_like(pm_a) for _ in range(4)]

    def fields_alone(a_, b_, t_, nt_, outs_):
        """As the wrapper launches it: the shared row and no counts as one
        flat row, else a row a member."""
        rows_ = a_.shape[0] if nt_ is not None or t_.dim() == 2 else 1
        return lambda: _build.launch(
            "lf_token_fields", a_.data_ptr(), b_.data_ptr(), t_.data_ptr(),
            fields.N_TABLE if t_.dim() == 2 else 0,
            None if nt_ is None else nt_.data_ptr(), rows_,
            a_.numel() // rows_, *(o_.data_ptr() for o_ in outs_))

    g2_out_a = [torch.empty_like(g2_idx) for _ in range(2)]

    def gather_two_alone(ta_, tb_, ix_, lo_):
        return lambda: _build.launch(
            "lf_gather_two", ta_.data_ptr(), tb_.data_ptr(), ix_.data_ptr(),
            lo_.data_ptr(), g2_out_a[0].data_ptr(), g2_out_a[1].data_ptr(),
            g2_b, g2_r, ix_.shape[1] * 128, g2_win)

    walk_a = torch.empty_like(s_emit)
    dec_tok_a, dec_nxt_a = torch.empty_like(s_tok), torch.empty_like(s_nxt)
    exits_a = torch.empty_like(s_ex)
    spec_rows = torch.from_numpy(decode.ROWS).to(dev)

    def spec_decode_alone(w_):
        return lambda: _build.launch(
            "lf_spec_decode", w_.data_ptr(), st["lit_t"].data_ptr(),
            st["dist_t"].data_ptr(), spec_rows.data_ptr(),
            dec_tok_a.data_ptr(), dec_nxt_a.data_ptr(), w_.shape[0],
            w_.shape[1])

    def exits_alone(n_):
        return lambda: _build.launch(
            "lf_spec_chunk_exits", n_.data_ptr(), exits_a.data_ptr(),
            n_.shape[0], n_.shape[1])

    def walk_alone(n_, t_, e_):
        return lambda: _build.launch(
            "lf_spec_walk_emit", n_.data_ptr(), t_.data_ptr(), e_.data_ptr(),
            walk_a.data_ptr(), n_.shape[0], n_.shape[1])

    rk_copies = [[x.clone() for x in rk_args[:4]] for _ in range(COLD_COPIES)]
    pk_copies = [[x.clone() for x in (values, widths, cstarts)]
                 for _ in range(COLD_COPIES)]
    sd_copies = [[x.clone() for x in sd_args[:3]] for _ in range(COLD_COPIES)]
    hs_copies = [[x.clone() for x in (a, b, valid)]
                 for _ in range(COLD_COPIES)]
    rs_copies = [[x.clone() for x in (src, lit)] for _ in range(COLD_COPIES)]
    rg_copies = [[x[:n_grp].clone() for x in (src, lit)]
                 for _ in range(COLD_COPIES)]
    hh_copies = [ids.clone() for _ in range(COLD_COPIES)]
    lc_copies = [{k: [blocks.clone(), a_[1].clone(),
                      None if kw_.get("m4") is None else kw_["m4"].clone(),
                      nv.clone()] for k, _o, a_, kw_ in lcp_calls}
                 for _ in range(COLD_COPIES)]
    wk_copies = [[x.clone() for x in (s_nxt, s_tok, s_ent)]
                 for _ in range(COLD_COPIES)]
    sw_copies = [st["words"].clone() for _ in range(COLD_COPIES)]
    tf_copies = [[x.clone() for x in (a_h, b)] for _ in range(COLD_COPIES)]
    g2_copies = [[x.clone() for x in g2_args] for _ in range(COLD_COPIES)]
    alone = {
        "sync_decode warm": [sync_alone(*sd_args[:3])],
        "sync_decode cold": [sync_alone(*c) for c in sd_copies],
        "token_hist warm": [hist_alone(a, b, valid)],
        "token_hist cold": [hist_alone(*c) for c in hs_copies],
        "rank_emit_src warm": [rank_alone(*rk_args[:4])],
        "rank_emit_src cold": [rank_alone(*c) for c in rk_copies],
        "resolve_bytes warm": [resolve_alone(src, lit, out_a)],
        "resolve_bytes cold": [resolve_alone(*c, out_a) for c in rs_copies],
        f"resolve_bytes {n_grp} members warm": [resolve_alone(
            rg_copies[0][0], rg_copies[0][1], out_g_a)],
        f"resolve_bytes {n_grp} members cold": [
            resolve_alone(*c, out_g_a) for c in rg_copies],
        "hash_candidates warm": [hash_alone(ids)],
        "hash_candidates cold": [hash_alone(c) for c in hh_copies],
        "pack_stitch warm": [pack_alone(values, widths, cstarts)],
        "pack_stitch cold": [pack_alone(*c) for c in pk_copies],
        "pack rows memset": [lambda: torch.zeros_like(words)],
        "spec walk_emit warm": [walk_alone(s_nxt, s_tok, s_ent)],
        "spec walk_emit cold": [walk_alone(*c) for c in wk_copies],
        "spec decode_positions warm": [spec_decode_alone(st["words"])],
        "spec decode_positions cold": [spec_decode_alone(c)
                                       for c in sw_copies],
        "spec chunk_exit_maps warm": [exits_alone(s_nxt)],
        "spec chunk_exit_maps cold": [exits_alone(c[0]) for c in wk_copies],
        "token_fields warm": [fields_alone(a_h, b, tables, None, fields_a)],
        "token_fields cold": [fields_alone(*c, tables, None, fields_a)
                              for c in tf_copies],
        "token_fields per-member warm": [fields_alone(*pm_args,
                                                      pm_fields_a)],
        "gather_two warm": [gather_two_alone(*g2_args)],
        "gather_two cold": [gather_two_alone(*c) for c in g2_copies],
    }
    for k, _o, a_, kw_ in lcp_calls:
        alone[f"match_lengths {k} warm"] = [lcp_alone(
            k, kw_, a_[0], a_[1], kw_.get("m4"), a_[2])]
        alone[f"match_lengths {k} cold"] = [lcp_alone(k, kw_, *c[k])
                                            for c in lc_copies]
    alone_ms = {k: cuda_ms_many(fns, 12 * COLD_COPIES)
                for k, fns in alone.items()}
    torch.cuda.synchronize()
    same = {"rank": torch.equal(src_a, src) and torch.equal(lit_a, lit),
            "pack": torch.equal(words_a, words),
            "sync_decode": torch.equal(toks_a, toks),
            "token_hist": torch.equal(bins_a, bins),
            "resolve": torch.equal(out_a, out),
            "resolve 128": torch.equal(out_g_a, out[:n_grp]),
            "hash": torch.equal(hcand_a, hcand_raw),
            "spec walk": torch.equal(walk_a, s_emit),
            "spec decode": (torch.equal(dec_tok_a, s_tok)
                            and torch.equal(dec_nxt_a, s_nxt)),
            "spec exits": torch.equal(exits_a, s_ex),
            "token_fields": all(torch.equal(x, y)
                                for x, y in zip(fields_a, fv)),
            "token_fields per member": all(
                torch.equal(x, y) for x, y in zip(pm_fields_a, pm_fv)),
            "gather_two": all(torch.equal(x, y)
                              for x, y in zip(g2_out_a, g2))}
    same.update({f"match_lengths {k}": torch.equal(lcp_outs[k], o_)
                 for k, o_, _a, _k in lcp_calls})
    if not all(same.values()):
        check_held("the kernels launched alone")
        raise AssertionError("a kernel launched alone gave other outputs: "
                             + ", ".join(k for k, v in same.items() if not v)
                             + " (phase 4's rank inputs and outputs held)")
    log(f"launched alone, {12 * COLD_COPIES} back to back, ms per launch: "
        + ", ".join(f"{k} {v:.4f}" for k, v in alone_ms.items())
        + f" [{card_line}]")
    held.clear()
    del src_a, lit_a, words_a, rk_copies, pk_copies, toks_a, sd_copies
    del hs_copies, rs_copies, rg_copies, hh_copies, out_a, out_g_a, hcand_a
    del lc_copies, wk_copies, walk_a, lcp_outs, sw_copies
    del dec_tok_a, dec_nxt_a, exits_a, fields_a, pm_fields_a, g2_out_a
    # the fields' and gather's copies go now, so the chains' peaks below
    # count the same live tensors as before those kernels were timed alone
    for key in [key for key in alone
                if key.startswith(("token_fields", "gather_two"))]:
        del alone[key]
    del tf_copies, g2_copies
    # the resolve and the hash kernel against their bounds (resolve: src
    # and lit read, the bytes written, 9 bytes a position; hash: the ids
    # read, the candidates written, 8 bytes a position; the hash kernel's
    # scratch, a code word a position kept in `out` between its passes,
    # written and read back once, is given apart) and half marks (twice
    # the bound)
    res_r, hsh_r = row[kname(expand.resolve_bytes)], row[kname(
        hm.hash_candidates)]
    grp_bound = nbytes(src[:n_grp], lit[:n_grp], out[:n_grp]) / \
        HBM_BYTES_PER_MS

    def mark(ms: float, bound: float) -> str:
        return f"{ms:.4f} ms ({'met' if ms <= 2 * bound else 'missed'})"

    log(f"resolve_bytes at {bsz} x {cap}: bound {res_r['bound_ms']:.4f} ms "
        f"({nbytes(src, lit, out)} bytes), half mark "
        f"{2 * res_r['bound_ms']:.4f} ms: row "
        f"{mark(res_r['ms'], res_r['bound_ms'])}, alone warm "
        f"{mark(alone_ms['resolve_bytes warm'], res_r['bound_ms'])}, cold "
        f"{mark(alone_ms['resolve_bytes cold'], res_r['bound_ms'])}; at "
        f"{n_grp} x {cap}: bound {grp_bound:.4f} ms, alone warm "
        f"{mark(alone_ms[f'resolve_bytes {n_grp} members warm'], grp_bound)}"
        f", cold "
        f"{mark(alone_ms[f'resolve_bytes {n_grp} members cold'], grp_bound)}"
        f" [{card_line}]")
    log(f"hash_candidates at {tuple(ids.shape)}: bound "
        f"{hsh_r['bound_ms']:.4f} ms ({nbytes(ids, hcand_raw)} bytes; "
        f"scratch traffic apart: {2 * nbytes(hcand_raw)} bytes, the codes "
        f"in out, {2 * nbytes(hcand_raw) / HBM_BYTES_PER_MS:.4f} ms if none "
        f"stayed in L2), half mark {2 * hsh_r['bound_ms']:.4f} ms: row "
        f"{mark(hsh_r['ms'], hsh_r['bound_ms'])}, alone warm "
        f"{mark(alone_ms['hash_candidates warm'], hsh_r['bound_ms'])}, cold "
        f"{mark(alone_ms['hash_candidates cold'], hsh_r['bound_ms'])} "
        f"[{card_line}]")
    # token_fields: a and b read, four outputs written, the table row(s)
    # read once; the per-member form also reads its counts.  gather_two:
    # idx, lo_rows and both tables read once, both outputs written; the
    # staged design reads each group's window rows, so it is also given
    # against that count
    tf_r = row[kname(fields.token_fields)]
    pm_bytes = nbytes(*pm_args, *pm_fv)
    pm_bound = pm_bytes / HBM_BYTES_PER_MS
    pm_ms = cuda_ms(lambda: fields.token_fields(*pm_args), 20)
    pm_plain_ms = cuda_ms(lambda: fields.token_fields_plain(*pm_args), 3)
    log(f"token_fields at {tuple(a_h.shape)}: bound {tf_r['bound_ms']:.4f} "
        f"ms ({nbytes(a_h, b, tables, *fv)} bytes), half mark "
        f"{2 * tf_r['bound_ms']:.4f} ms: row "
        f"{mark(tf_r['ms'], tf_r['bound_ms'])}, alone warm "
        f"{mark(alone_ms['token_fields warm'], tf_r['bound_ms'])}, cold "
        f"{mark(alone_ms['token_fields cold'], tf_r['bound_ms'])}; "
        f"per-member form (tables {tuple(pm_tables.shape)}, counts): bound "
        f"{pm_bound:.4f} ms ({pm_bytes} bytes), row {mark(pm_ms, pm_bound)}"
        f", alone warm "
        f"{mark(alone_ms['token_fields per-member warm'], pm_bound)}, plain "
        f"{pm_plain_ms:.4f} ms [{card_line}]")
    g2_r_ = row[kname(gather.gather_two)]
    g2_win_bytes = (nbytes(g2_idx, g2_lo, *g2)
                    + 2 * g2_lo.numel() * g2_win * 128 * 4)
    log(f"gather_two at B={g2_b} R=N={g2_r} win={g2_win}: bound "
        f"{g2_r_['bound_ms']:.4f} ms (tables once: "
        f"{nbytes(*g2_args, *g2)} bytes), each group's window rows "
        f"{g2_win_bytes / HBM_BYTES_PER_MS:.4f} ms ({g2_win_bytes} bytes); "
        f"half mark {2 * g2_r_['bound_ms']:.4f} ms: row "
        f"{mark(g2_r_['ms'], g2_r_['bound_ms'])}, alone warm "
        f"{mark(alone_ms['gather_two warm'], g2_r_['bound_ms'])}, cold "
        f"{mark(alone_ms['gather_two cold'], g2_r_['bound_ms'])}; "
        f"torch.gather twice {g2_r_['library_ms']:.4f} ms [{card_line}]")
    del pm_args, pm_a, pm_b, pm_tables, pm_nt, pm_fv
    # each LCP call beside its bound (blocks, candidates, m4 where given,
    # n_valid read once, the lengths written once); the JSON row is the
    # sort-m4 call
    for k, o_, a_, kw_ in lcp_calls:
        l_bytes = nbytes(*a_, *([kw_["m4"]] if "m4" in kw_ else []), o_)
        lb = l_bytes / HBM_BYTES_PER_MS
        k_ms = cuda_ms(lambda: lcp.match_lengths(*a_, **kw_), 20)
        p_ms = cuda_ms(lambda: lcp.match_lengths_plain(*a_, **kw_), 3)
        log(f"lcp.match_lengths [{k}: {'m4, ' if 'm4' in kw_ else 'no m4, '}"
            f"{kw_['max_rounds']} rounds, window {kw_['window']}]: kernel "
            f"{mark(k_ms, lb)}, plain {p_ms:.4f} ms, bound {lb:.4f} ms "
            f"({l_bytes} bytes), half mark "
            f"{2 * lb:.4f} ms; alone warm "
            f"{mark(alone_ms[f'match_lengths {k} warm'], lb)}, cold "
            f"{mark(alone_ms[f'match_lengths {k} cold'], lb)} [{card_line}]")
    wlk = row[kname(decode.walk_emit)]
    log(f"spec walk_emit at {tuple(s_nxt.shape)} ({s_ent.numel()} chunks): "
        f"bound {wlk['bound_ms']:.4f} ms ({walk_bytes} bytes, the visited "
        f"sectors), half mark {2 * wlk['bound_ms']:.4f} ms: row "
        f"{mark(wlk['ms'], wlk['bound_ms'])}, alone warm "
        f"{mark(alone_ms['spec walk_emit warm'], wlk['bound_ms'])}, cold "
        f"{mark(alone_ms['spec walk_emit cold'], wlk['bound_ms'])}; whole "
        f"chunks {nbytes(s_nxt, s_tok, s_ent, s_emit) / HBM_BYTES_PER_MS:.4f}"
        f" ms [{card_line}]")
    # the position decode (words and tables read, tok and nxt written)
    # and the chunk exits (nxt read, exits written) against their bounds
    for k, alone_k in ((decode.speculative_decode_positions,
                        "spec decode_positions"),
                       (decode.chunk_exit_maps, "spec chunk_exit_maps")):
        r_ = row[kname(k)]
        log(f"{kname(k)} at {tuple(s_nxt.shape)}: bound "
            f"{r_['bound_ms']:.4f} ms, half mark {2 * r_['bound_ms']:.4f} "
            f"ms: row {mark(r_['ms'], r_['bound_ms'])}, alone warm "
            f"{mark(alone_ms[f'{alone_k} warm'], r_['bound_ms'])}, cold "
            f"{mark(alone_ms[f'{alone_k} cold'], r_['bound_ms'])} "
            f"[{card_line}]")
    sdr = row[kname(sd.sync_decode)]
    k_tok = g["k_tok"]

    def sync_step_ns(n_slots: int) -> float:
        """ns a step of the first ``n_slots`` slots, launched alone at K
        and at K / 4: the difference over 3K / 4 steps drops the fixed
        cost (launch, table build, last flush)."""
        ms = []
        for k_ in (k_tok, k_tok // 4):
            o_ = torch.empty((n_slots, k_), dtype=torch.int32, device=dev)
            w_, sb_, cnt_ = sd_args[:3]
            ms.append(cuda_ms_many([lambda: _build.launch(
                "lf_sync_decode", w_.data_ptr(), w_.numel(), sb_.data_ptr(),
                cnt_.data_ptr(), g["lit_t"].data_ptr(),
                g["dist_t"].data_ptr(), sd_rows.data_ptr(), g["root_bits"],
                o_.data_ptr(), n_slots, k_)], 24))
        return (ms[0] - ms[1]) / (k_tok - k_tok // 4) * 1e6

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_sd, sd_block = toks.shape[0], sd_info["threads"]
    log(f"sync_decode per token step (K = {k_tok}, {n_sd} slots in "
        f"lockstep): row {sdr['ms'] / k_tok * 1e6:.1f} ns, alone warm "
        f"{alone_ms['sync_decode warm'] / k_tok * 1e6:.1f} ns, alone cold "
        f"{alone_ms['sync_decode cold'] / k_tok * 1e6:.1f} ns; bound "
        f"{sdr['bound_ms']:.4f} ms; a step without the fixed cost (alone, K "
        f"against K / 4): {sync_step_ns(n_sd):.1f} ns at the main path's "
        f"{-(-n_sd // (sd_block * sms)) * sd_block // 32} warps a SM, "
        f"{sync_step_ns(sd_block * sms):.1f} ns at {sd_block // 32} warps a "
        f"SM ({sd_block * sms} slots) [{card_line}]")
    srt, scn = row[kname(sm.sort_keys)], row[kname(sm.scan_emit)]
    log(f"sort matcher: sort_keys {srt['ms']:.4f} ms against torch.sort("
        f"stable=True) {srt['library_ms']:.4f} ms (ratio "
        f"{srt['ms'] / srt['library_ms']:.3f}), bound {srt['bound_ms']:.4f}; "
        f"scan_emit {scn['ms']:.4f} ms, bound {scn['bound_ms']:.4f} "
        f"[{card_line}]")
    log(f"decode device chain (sync decode -> expand -> CRC f-values): "
        f"{chain_ms:.4f} ms median of 11, {n_dec / chain_ms / 1e6:.3f} "
        f"GB/s of plaintext, peak {peak / 2**20:.0f} MiB [{card_line}]")
    stages = {
        "sync_decode": lambda: sd.sync_decode(*sd_args),
        "rank_inputs (torch glue)": lambda: device_expand.rank_inputs(
            toks.view(bsz, -1), g["n_tokens"], cap),
        "rank_emit_src": lambda: rank.rank_emit_src(*rk_args),
        "resolve_bytes": lambda: expand.resolve_bytes(src, lit),
        "crc32_f_rows": lambda: checksum.crc32_f_rows(out),
    }
    breakdown = {k: cuda_ms(fn, 5) for k, fn in stages.items()}
    log("decode chain stages, ms: " + ", ".join(
        f"{k} {v:.4f}" for k, v in breakdown.items()) + f" [{card_line}]")
    log(f"end to end decompress_to_device(verify=True), host staging "
        f"included: {e2e_s * 1e3:.2f} ms median of 5, "
        f"{n_dec / e2e_s / 1e9:.3f} GB/s of plaintext [{card_line}]")

    # the speculative path: its device chain over the 8 staged groups, one
    # group's stages, and the end to end on the stripped shard
    def spec_device_chain():
        for grp in spec_groups:
            packed, nt, _err = pgzf._spec_chain(
                grp["words"], grp["lit_t"], grp["dist_t"], grp["starts"],
                grp["out_cap"])
            rows_, _n, _e = device_expand.expand_members(packed, nt,
                                                         grp["out_cap"])
            checksum.crc32_f_rows(rows_)

    torch.cuda.reset_peak_memory_stats()
    spec_chain_ms = cuda_ms(spec_device_chain, 5)
    spec_peak = torch.cuda.max_memory_allocated()
    spec_walls = []
    for _ in range(5):
        t = time.perf_counter()
        pgzf.decompress_to_device(spec_stream, verify=True, device="cuda")
        torch.cuda.synchronize()
        spec_walls.append(time.perf_counter() - t)
    spec_e2e_s = statistics.median(spec_walls)
    spec_stage_ms = statistics.median(spec_stage_s) * 1e3
    spec_stages = {
        "speculative_decode_positions":
            lambda: decode.speculative_decode_positions(*sp_args),
        "chunk_exit_maps": lambda: decode.chunk_exit_maps(s_nxt),
        "chain_entries": lambda: deflate_decode.chain_entries(
            s_ex, st["starts"]),
        "walk_emit": lambda: decode.walk_emit(s_nxt, s_tok, s_ent),
        "tokens_from_emit_packed (torch glue)":
            lambda: deflate_decode.tokens_from_emit_packed(s_emit,
                                                           o_cap + 2),
        "expand_members (glue, rank, resolve)":
            lambda: device_expand.expand_members(s_packed, s_nt, o_cap),
        "crc32_f_rows": lambda: checksum.crc32_f_rows(s_plain),
    }
    spec_breakdown = {k: cuda_ms(fn, 5) for k, fn in spec_stages.items()}
    log(f"speculative device chain (4 kernels, compaction, expand, CRC "
        f"f-values; {len(spec_groups)} groups): {spec_chain_ms:.4f} ms "
        f"median of 5 per 64 MiB, {n_dec / spec_chain_ms / 1e6:.3f} GB/s of "
        f"plaintext, peak {spec_peak / 2**20:.0f} MiB [{card_line}]")
    log("speculative stages for one group of 128 members, ms: " + ", ".join(
        f"{k} {v:.4f}" for k, v in spec_breakdown.items())
        + f" [{card_line}]")
    log(f"end to end decompress_to_device(verify=True) of the stripped "
        f"shard: {spec_e2e_s * 1e3:.2f} ms median of 5, "
        f"{n_dec / spec_e2e_s / 1e9:.3f} GB/s of plaintext; its host "
        f"staging (_spec_groups) {spec_stage_ms:.2f} ms (median of 3 on its "
        f"own), the rest {spec_e2e_s * 1e3 - spec_stage_ms:.2f} ms; the "
        f"sync path "
        f"{e2e_s * 1e3:.2f} ms in this run [{card_line}]")

    torch.cuda.reset_peak_memory_stats()
    batch_ms = cuda_ms(lambda: pipeline.encode_batch(blocks, nv, 256), 5)
    enc_peak = torch.cuda.max_memory_allocated()
    enc_stages = {
        "prefix_keys (glue)": lambda: sm.prefix_keys(blocks),
        "sort_keys": lambda: sm.sort_keys(keys),
        "scan_emit": lambda: sm.scan_emit(sk, sp, blocks),
        "lengths_stage (glue)": lambda: pipeline.lengths_stage(
            blocks, nv, cand, m4),
        "parse_inputs (glue)": lambda: parse.parse_inputs(
            blocks, nv, cand2, lens),
        "chunk_exits": lambda: parse.chunk_exits(jump),
        "walk_emit": lambda: parse.walk_emit(jump, tok, ex, pcap),
        "shared_stats (hist + host codes)": lambda: pipeline.shared_stats(
            a, b, valid),
        "token_fields": lambda: fields.token_fields(a_h, b, tables),
        "shared_assemble (glue)": lambda: deflate_encode.assemble_fields(
            header, fv, stats[2][256], stats[3][256]),
        "chunk_starts (glue)": lambda: pack.chunk_starts(widths),
        "pack_stitch": lambda: pack.pack_stitch(values, widths, cstarts,
                                                w_out),
        "sync_offsets_padded (glue)": lambda: pipeline.sync_offsets_padded(
            widths[:, :-fpad or None], valid, 256, pcap),
        "crc32_f_rows": lambda: checksum.crc32_f_rows(blocks),
    }
    enc_breakdown = {k: cuda_ms(fn, 5) for k, fn in enc_stages.items()}
    log(f"encode device chain per batch (128 x 64 KiB = 8 MiB, "
        f"encode_batch): {batch_ms:.4f} ms median of 5, "
        f"{n_b * ms_enc / batch_ms / 1e6:.3f} GB/s of input, peak "
        f"{enc_peak / 2**20:.0f} MiB [{card_line}]")
    log("encode batch stages, ms: " + ", ".join(
        f"{k} {v:.4f}" for k, v in enc_breakdown.items())
        + f" [{card_line}]")

    device_s = [0.0]
    real_encode_batch = pgzf.encode_batch

    def timed_encode_batch(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = real_encode_batch(*args, **kw)
        torch.cuda.synchronize()
        device_s[0] += time.perf_counter() - t0
        return res

    def end_to_end(what: str, ratio_: float, matcher: str = "sort",
                   options=None) -> None:
        """Median of 3 host-clock compress calls of the 64 MiB, split
        into the encode_batch calls and the host."""
        pgzf.encode_batch = timed_encode_batch
        walls, dev_parts = [], []
        with device_matcher(matcher):
            for _ in range(3):
                device_s[0] = 0.0
                t = time.perf_counter()
                pgzf.compress(data, member_size=ms_enc, options=options,
                              device="cuda")
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t)
                dev_parts.append(device_s[0])
        pgzf.encode_batch = real_encode_batch
        i_med = walls.index(statistics.median(walls))
        enc_s, enc_dev = walls[i_med], dev_parts[i_med]
        log(f"end to end compress(64 MiB, {what}, device='cuda'): "
            f"{enc_s * 1e3:.2f} ms median of 3, "
            f"{len(data) / enc_s / 1e9:.3f} GB/s of input; encode_batch "
            f"calls {enc_dev * 1e3:.2f} ms, host staging and assembly "
            f"{(enc_s - enc_dev) * 1e3:.2f} ms; ratio {ratio_:.6f} "
            f"[{card_line}]")

    end_to_end("default", ratio)

    # the foreign path: host token decode, device chain (expand + CRC
    # f-values on the uploaded tokens), end to end
    for what, fstream in foreign_streams.items():
        frefs = pgzf.index_members(fstream)
        host_s = []
        for _ in range(3):
            t = time.perf_counter()
            ftok = pgzf._foreign_tokens(fstream, frefs)
            host_s.append(time.perf_counter() - t)
        fpacked, fnt, fsizes, _crcs, fcap = ftok
        fpacked_d = torch.from_numpy(fpacked).to(dev)
        fnt_d = torch.from_numpy(fnt).to(dev)
        f_chain_ms = cuda_ms(lambda: checksum.crc32_f_rows(
            device_expand.expand_members(fpacked_d, fnt_d, fcap)[0]), 5)
        f_walls = []
        for _ in range(3):
            t = time.perf_counter()
            pgzf.decompress_to_device(fstream, verify=True, device="cuda")
            torch.cuda.synchronize()
            f_walls.append(time.perf_counter() - t)
        f_plain = sum(fsizes)
        how = ("indexed: one threaded batch" if frefs
               else "walked by end bits")
        log(f"foreign decode ({what}), {len(fsizes)} members, tokens "
            f"{tuple(fpacked.shape)}, rows of {fcap}: host token decode "
            f"{statistics.median(host_s) * 1e3:.2f} ms median of 3 ({how}) "
            f"[{card_line}]")
        log(f"foreign decode ({what}): device chain (expand_members + "
            f"crc32_f_rows) {f_chain_ms:.4f} ms median of 5, "
            f"{f_plain / f_chain_ms / 1e6:.3f} GB/s of plaintext "
            f"[{card_line}]")
        log(f"foreign decode ({what}): end to end decompress_to_device("
            f"verify=True) {statistics.median(f_walls) * 1e3:.2f} ms median "
            f"of 3, {f_plain / statistics.median(f_walls) / 1e9:.3f} GB/s of "
            f"plaintext [{card_line}]")
        del fpacked_d, fnt_d

    # the option paths: one batch's chain, its new stages, end to end
    q_knobs = pipeline.device_knobs(quality)
    with device_matcher("hash"):
        opt_batches = {
            "hash profile": cuda_ms(
                lambda: pipeline.encode_batch(blocks, nv, 256), 5)}
    opt_batches["quality mode"] = cuda_ms(
        lambda: pipeline.encode_batch(blocks, nv, 256, **q_knobs), 5)
    opt_stages = {
        "quality lengths_stage (8 LCP + 7 gather launches, glue)":
            lambda: pipeline.lengths_stage(blocks, nv, cand, m4, **q_knobs),
        "hash prefix_candidates (keys glue + kernel + mask)":
            lambda: hm.prefix_candidates(blocks),
        "hash keys_hashes (glue)": lambda: hm.keys_hashes(blocks),
        "hash lengths_stage (1 LCP launch, glue)":
            lambda: pipeline.lengths_stage(blocks, nv, hcand),
        "match_lengths, hash candidates, 6 rounds, window 32768":
            lambda: lcp.match_lengths(*hlcp_args, **hlcp_kw),
        "match_lengths, chain level 2, 8 rounds, window 32768":
            lambda: lcp.match_lengths(*clcp_args, **clcp_kw),
    }
    opt_breakdown = {k: cuda_ms(fn, 5) for k, fn in opt_stages.items()}
    log("option batch chains (encode_batch, 128 x 64 KiB), ms: " + ", ".join(
        f"{k} {v:.4f}" for k, v in opt_batches.items()) + f" [{card_line}]")
    log("option stages, ms: " + ", ".join(
        f"{k} {v:.4f}" for k, v in opt_breakdown.items())
        + f"; hash-candidate LCP bound "
        f"{nbytes(blocks, hcand, nv, ln6) / HBM_BYTES_PER_MS:.4f} ms "
        f"[{card_line}]")
    end_to_end("quality mode: chain 8, lcp_rounds 8",
               len(q_stream) / len(data), options=quality)
    end_to_end("hash profile", len(h_stream) / len(data), matcher="hash")

    # 10. the generic device engine: deflate_device and the raw DEFLATE,
    # zlib and gzip containers on the "cuda" engine, pgzf's fixed-block
    # route, and decompress's two repaired faults
    generic_engine(dev, card_line, data, blocks, nv, hcand, errs, row)

    # 11. the host surface over the cuda engine: odd member sizes, the
    # streaming facades, the serial engine and chunked decoders, the CLI,
    # and the two repaired kernels on their hard inputs
    port_surface(dev, card_line, data, rk_args, (a, b, valid), errs, row)

    # 12. the native engine on the card's host: the committed reference
    # streams, the checksums, both decode routes, host-clock times
    native_engine(card_line, data, enc_stream, foreign)

    # 13. the sharded codec on one card and on four logical shards of it,
    # the dry runs, two processes over gloo
    parallel_paths(dev, card_line, data, blocks, nv, enc_stream, row)

    print(json.dumps({"kernels": summary}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


def generic_engine(dev, card_line: str, data: bytes, blocks, nv, hcand,
                   errs: dict, row: dict) -> None:
    """Phase 10.  ``data``: the 64 MiB encode input; ``blocks``, ``nv``:
    its first 128 x 64 KiB (phase 6's batch, the 8 MiB here); ``hcand``:
    their hash candidates (phase 6b, the kernel held against its plain
    version there).  Adds the main-path launches and the per-member token
    fields' error to ``row`` / ``errs``."""
    import numpy as np

    from libflate_tpu_torch import _build, backend
    from libflate_tpu_torch.formats import deflate as fdeflate
    from libflate_tpu_torch.formats import gzip as fgzip
    from libflate_tpu_torch.formats import pgzf
    from libflate_tpu_torch.formats import zlib as fzlib
    from libflate_tpu_torch.ops import (bitpack, checksum, deflate_decode,
                                        deflate_encode, fields, lz77, parse,
                                        pipeline)
    from libflate_tpu_torch.ops import hash_match as hm
    from libflate_tpu_torch.serial.deflate import EncodeOptions
    eng = backend.get("cuda")
    h_, f_, ce_, we_ = (hm.hash_candidates, fields.token_fields,
                        parse.chunk_exits, parse.walk_emit)
    ds_ = deflate_decode.decode_symbols
    counted_kernels = (h_, f_, ce_, we_, ds_)

    def counted(fn):
        """``fn()`` with every count set to 0 before it; (result, counts)."""
        for k in counted_kernels:
            k.launches = 0
        res = fn()
        torch.cuda.synchronize()
        return res, {kname(k): k.launches for k in counted_kernels}

    def need(counts: dict, what: str, **want) -> None:
        """Each ``want`` count exactly (None: at least 1)."""
        for key, n in want.items():
            got = counts[kname({"hash": h_, "fields": f_, "exits": ce_,
                                "walk": we_, "decode": ds_}[key])]
            if (n is None and got < 1) or (n is not None and got != n):
                raise AssertionError(f"{what}: {key} launched {got} times, "
                                     f"want {'>= 1' if n is None else n}: "
                                     f"{counts}")

    def host_ms(fn, reps: int = 3) -> float:
        walls = []
        for _ in range(reps):
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
        return statistics.median(walls) * 1e3

    # 10a. byte identity with the committed reference streams, each read
    # back by stdlib zlib and by the port's engine
    for fname, (kind, fopts, size) in DEFLATE_FIXTURES.items():
        want = (DATA / fname).read_bytes()
        fplain = fixture_plain(kind, want)
        got, counts = counted(lambda: deflate_fixture_stream(
            kind, fopts, size, fplain, "cuda"))
        if got != want:
            raise AssertionError(f"the cuda engine differs from {fname}")
        literal = fopts.get("matcher") == "none"
        need(counts, fname, hash=(None if size == 1024 and not literal
                                  else 0), fields=None,
             exits=0 if literal else None, walk=0 if literal else None)
        back, dcounts = counted(lambda: deflate_fixture_decode(kind, got,
                                                               "cuda"))
        if back != fplain:
            raise AssertionError(f"the port's decode of {fname} differs")
        need(dcounts, f"{fname} decode", decode=None)
        log(f"{fname}: {kind} {fopts} at {size}: {len(fplain)} -> "
            f"{len(want)} bytes byte-identical to the reference, read back "
            f"by zlib and by the cuda engine; launches {counts}, decode "
            f"{dcounts}")

    # 10b. the 8 MiB batch's kernels against their plain versions
    p8 = data[:8 << 20]
    hc8 = hm.prefix_candidates(blocks)
    if not torch.equal(hc8, hcand):
        raise AssertionError("hash candidates differ from phase 6b's")
    a8, b8, cnt8 = pipeline.tokenize_tail(blocks, nv, hc8)
    lit_l8, dist_l8 = deflate_encode.block_code_lengths(
        *deflate_encode.token_histograms(a8, b8, cnt8))
    t8 = fields.field_tables(*deflate_encode.block_tables(lit_l8, dist_l8),
                             dev)
    f8 = fields.token_fields(a8, b8, t8, cnt8)
    f8_p = fields.token_fields_plain(a8, b8, t8, cnt8)
    torch.cuda.synchronize()
    f8_err = max(max_abs_err(x, y) for x, y in zip(f8, f8_p))
    errs[kname(f_)] = max(errs[kname(f_)], f8_err)
    row[kname(f_)]["max_abs_err"] = errs[kname(f_)]
    log(f"generic 8 MiB batch ({tuple(blocks.shape)}): hash candidates "
        f"equal to phase 6b's (kernel vs plain there: max_abs_err "
        f"{errs[kname(h_)]}); per-member token_fields on {tuple(a8.shape)} "
        f"tokens (counts {int(cnt8.min())}-{int(cnt8.max())}, code widths "
        f"up to {int(lit_l8.max())} / {int(dist_l8.max())}): max_abs_err "
        f"{f8_err}")
    if f8_err:
        raise AssertionError("token_fields disagrees with its plain version")
    del f8, f8_p
    # the parse kernels at cap 512 on the jump arrays of the generic
    # tokenizer (lz77.token_lengths, then parse.parse_inputs, as
    # parse_tokens builds them): the hash branch's 6 LCP rounds and the
    # sort branch's exact lengths
    for branch, pcand, rounds in (
            ("hash", hc8, pipeline.KERNEL_LCP_ROUNDS),
            ("sort", lz77.prefix_candidates(blocks), None)):
        gcand, glen = lz77.token_lengths(blocks, nv, pcand,
                                         max_rounds=rounds)
        gjump, gtok = parse.parse_inputs(blocks, nv, gcand, glen)
        gex = parse.chunk_exits(gjump)
        gex_p = parse.chunk_exits_plain(gjump)
        gout, govf = parse.walk_emit(gjump, gtok, gex, parse.CHUNK)
        gout_p, govf_p = parse.walk_emit_plain(gjump, gtok, gex, parse.CHUNK)
        torch.cuda.synchronize()
        ex_err = max_abs_err(gex, gex_p)
        wk_err = max(max_abs_err(gout, gout_p), max_abs_err(govf, govf_p))
        for k, e in ((ce_, ex_err), (we_, wk_err)):
            errs[kname(k)] = max(errs[kname(k)], e)
            row[kname(k)]["max_abs_err"] = errs[kname(k)]
        log(f"generic {branch} branch parse at cap {parse.CHUNK} on "
            f"{tuple(gjump.shape)} jumps ({int((gout >= 0).sum())} tokens, "
            f"lengths up to {int(glen.max())}, overflow "
            f"{int(govf.sum())}): chunk_exits max_abs_err {ex_err}, "
            f"walk_emit max_abs_err {wk_err}")
        if ex_err or wk_err:
            raise AssertionError(f"the parse kernels disagree with their "
                                 f"plain versions on the {branch} branch")
        del gcand, glen, gjump, gtok, gex, gex_p, gout, gout_p

    # 10c. the main path, counted: deflate.compress of 8 MiB, 128 blocks
    s8, c8 = counted(lambda: fdeflate.compress(p8, engine="cuda"))
    need(c8, "compress(8 MiB)", hash=1, fields=1, exits=1, walk=1)
    if zlib.decompress(s8, -15) != p8:
        raise AssertionError("zlib does not read back the 8 MiB stream")
    back8, d8 = counted(lambda: fdeflate.decompress(s8, engine="cuda"))
    if back8 != p8:
        raise AssertionError("the cuda engine does not read back 8 MiB")
    need(d8, "decompress(8 MiB)", decode=128)
    log(f"generic main path deflate.compress(8 MiB, engine='cuda'): "
        f"launches {c8}; {len(p8)} -> {len(s8)} bytes (ratio "
        f"{len(s8) / len(p8):.6f}), read back by zlib and by "
        f"deflate.decompress(engine='cuda') (launches {d8})")
    # decode_symbols on the stream's first block at inflate_device's
    # budget, against its plain version
    ds_in, ds_mt = first_block_decode_args(s8, dev)
    t = time.perf_counter()
    ds_k = ds_(*ds_in, ds_mt)
    torch.cuda.synchronize()
    ds_k_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    ds_p = deflate_decode.decode_symbols_plain(*ds_in, ds_mt)
    torch.cuda.synchronize()
    ds_p_ms = (time.perf_counter() - t) * 1e3
    ds_err = max(max_abs_err(x, y) for x, y in zip(ds_k, ds_p))
    errs[kname(ds_)] = max(errs[kname(ds_)], ds_err)
    row[kname(ds_)]["max_abs_err"] = errs[kname(ds_)]
    # CUDA events: the wrapper (its two zeroed 64 MiB outputs) and the
    # launch alone on the same outputs
    ds_ev_ms = cuda_ms(lambda: ds_(*ds_in, ds_mt), 3)
    ds_o = [torch.zeros_like(ds_k[0]), torch.zeros_like(ds_k[1]),
            torch.empty_like(ds_k[2]), torch.empty_like(ds_k[3]),
            torch.empty_like(ds_k[4])]
    ds_in_c = [x.contiguous() for x in ds_in]
    ds_launch_ms = cuda_ms(lambda: _build.launch(
        "lf_decode_symbols", ds_in_c[0].data_ptr(), ds_in_c[0].shape[1],
        ds_in_c[1].data_ptr(), ds_in_c[2].data_ptr(), ds_in_c[3].data_ptr(),
        0, 1, ds_mt, deflate_decode._decode_steps(
            ds_mt, deflate_decode.DECODE_CHUNK),
        *(x.data_ptr() for x in ds_o)), 3)
    log(f"decode_symbols on the 8 MiB stream's first block at the budget "
        f"inflate_device gives it ({ds_mt} token slots, {int(ds_k[2][0])} "
        f"tokens, err {bool(ds_k[4][0])}): max_abs_err {ds_err}; kernel "
        f"{ds_k_ms:.2f} ms, plain {ds_p_ms:.2f} ms (host clock, one call); "
        f"CUDA events, median of 3: wrapper {ds_ev_ms:.4f} ms, launch "
        f"alone {ds_launch_ms:.4f} ms [{card_line}]")
    del ds_o, ds_in_c
    if ds_err or bool(ds_k[4][0]):
        raise AssertionError("decode_symbols disagrees with its plain "
                             "version on the 8 MiB stream's first block")
    del ds_in, ds_k, ds_p

    # 10d. 64 MiB, 1024 blocks: the sort branch
    s64, c64 = counted(lambda: fdeflate.compress(data, engine="cuda"))
    need(c64, "compress(64 MiB)", hash=0, fields=8, exits=8, walk=8)
    if zlib.decompress(s64, -15) != data:
        raise AssertionError("zlib does not read back the 64 MiB stream")
    log(f"generic deflate.compress(64 MiB, engine='cuda'), sort branch: "
        f"launches {c64}; {len(data)} -> {len(s64)} bytes (ratio "
        f"{len(s64) / len(data):.6f}), read back by zlib")

    # 10e. the containers and the engine's checksums, the checksum
    # kernels counted
    ck_kernels = (checksum.crc32_f_rows, checksum.adler32_device)
    for k in ck_kernels:
        k.launches = 0
    g8 = fgzip.compress(p8, engine="cuda")
    z8 = fzlib.compress(p8, engine="cuda")
    if (gzip.decompress(g8) != p8 or zlib.decompress(z8) != p8
            or g8[10:-8] != s8 or z8[2:-4] != s8):
        raise AssertionError("a container's 8 MiB stream is wrong")
    if (eng.crc32(data) != zlib.crc32(data)
            or eng.adler32(data) != zlib.adler32(data)
            or eng.crc32(data[1:], zlib.crc32(data[:1]))
            != zlib.crc32(data)):
        raise AssertionError("the cuda engine's checksums differ from zlib")
    torch.cuda.synchronize()
    ck_counts = {kname(k): k.launches for k in ck_kernels}
    if min(ck_counts.values()) < 1:
        raise AssertionError(f"a checksum kernel did not run: {ck_counts}")
    log(f"gzip.compress / zlib.compress(8 MiB, engine='cuda'): {len(g8)} / "
        f"{len(z8)} bytes, read back by stdlib, bodies equal to the raw "
        f"stream; engine crc32 / adler32 of 64 MiB equal to zlib's "
        f"(launches {ck_counts})")

    # 10f. pgzf with fixed blocks: 8 batches of 128 members
    fixed = EncodeOptions(block_type="fixed")
    sf, cf = counted(lambda: pgzf.compress(data, options=fixed,
                                           device="cuda"))
    need(cf, "pgzf.compress(64 MiB, fixed)", hash=8, fields=8, exits=8,
         walk=8)
    if gzip.decompress(sf) != data:
        raise AssertionError("stdlib gzip does not read back pgzf fixed")
    backf, df = counted(lambda: pgzf.decompress(sf, device="cuda"))
    if backf != data:
        raise AssertionError("pgzf.decompress does not read back pgzf fixed")
    log(f"pgzf.compress(64 MiB, block_type='fixed', device='cuda'): "
        f"launches {cf}; {len(sf)} bytes (ratio {len(sf) / len(data):.6f}), "
        f"read back by stdlib gzip and pgzf.decompress(device='cuda') "
        f"(launches {df})")

    # 10g. the repaired faults: a member over 1 MiB (the gzip container
    # on the cuda engine), a stream cut in its first block header
    big_plain = data[:2 << 20]
    big = gzip.compress(b"a small member", mtime=0) + gzip.compress(
        big_plain, compresslevel=0, mtime=0)
    big_back, bc = counted(lambda: pgzf.decompress(big, device="cuda"))
    if big_back != b"a small member" + big_plain:
        raise AssertionError("the 2 MiB stored member decodes wrong")
    need(bc, "2 MiB stored member", decode=1)
    cut = gzip.compress(bytes(range(256)) * 300, mtime=0)[:12]
    try:
        pgzf.decompress(cut, device="cuda")
    except EOFError:
        pass
    else:
        raise AssertionError("the cut stream did not raise EOFError")
    log(f"pgzf.decompress(device='cuda'): a stdlib stream with a 2 MiB "
        f"stored member decodes through the gzip fallback (launches {bc}); "
        f"the stream cut inside its first block header raises EOFError")

    # 10h. times, each with the card
    for k in counted_kernels:
        row[kname(k)]["launches"] += sum(c[kname(k)]
                                         for c in (c8, c64, cf, d8))
    for k in ck_kernels:
        row[kname(k)]["launches"] += ck_counts[kname(k)]
    # peaks above what is allocated before the calls
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ms8 = host_ms(lambda: fdeflate.compress(p8, engine="cuda"))
    peak8 = torch.cuda.max_memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    ms64 = host_ms(lambda: fdeflate.compress(data, engine="cuda"))
    peak64 = torch.cuda.max_memory_allocated() - base
    bf = np.ones(128, np.int32)
    stages = {
        "tokenize (hash kernel, 6 LCP rounds, parse kernels, compaction)":
            lambda: pipeline.tokenize_batch_any(blocks, nv, True),
        "fields (histograms, 384 package-merge and header calls, "
        "token_fields)": lambda: deflate_encode.encode_block_fields(
            a8, b8, cnt8, bf),
    }
    # the glue and host pieces inside them (hash kernel, parse kernels and
    # token_fields have rows of their own)
    cand6 = torch.where(torch.arange(blocks.shape[1], device=dev)[None, :]
                        < nv[:, None], hc8, -1)
    sort_cand = lz77.prefix_candidates(blocks)
    hist8 = deflate_encode.token_histograms(a8, b8, cnt8)
    lens8 = deflate_encode.block_code_lengths(*hist8)
    tabs8 = deflate_encode.block_tables(*lens8)
    fields8 = fields.token_fields(a8, b8, t8, cnt8)
    hdr8 = deflate_encode.dynamic_headers(*lens8, bf)
    pieces = {
        "keys_hashes (glue)": lambda: hm.keys_hashes(blocks),
        "match_lengths, 6 rounds (glue)": lambda: lz77.match_lengths(
            blocks, cand6, max_rounds=6),
        "sort branch prefix_candidates (glue: torch.sort)":
            lambda: lz77.prefix_candidates(blocks),
        "sort branch match_lengths, exact (glue)":
            lambda: lz77.match_lengths(blocks, sort_cand),
        "compaction (glue)": lambda: lz77.compact_tokens(
            a8, b8, torch.ones_like(a8, dtype=torch.bool), a8.shape[1]),
        "token_histograms (glue)": lambda: deflate_encode.token_histograms(
            a8, b8, cnt8),
        "package-merge, 256 calls (host)":
            lambda: deflate_encode.block_code_lengths(*hist8),
        "dynamic headers, 128 with 128 package-merge calls (host)":
            lambda: deflate_encode.dynamic_headers(*lens8, bf),
        "code tables, 256 (host)": lambda: deflate_encode.block_tables(
            *lens8),
        "field_tables upload": lambda: fields.field_tables(*tabs8, dev),
        "assemble_fields (glue)": lambda: deflate_encode.assemble_fields(
            hdr8, fields8, tabs8[0][:, 256], tabs8[1][:, 256]),
    }
    stage_ms = {k: cuda_ms(fn, 3) for k, fn in stages.items()}
    piece_ms = {k: cuda_ms(fn, 3) for k, fn in pieces.items()}
    del sort_cand, cand6, fields8
    vals8, wids8 = deflate_encode.encode_block_fields(a8, b8, cnt8, bf)
    stage_ms["pack (bitpack glue)"] = cuda_ms(
        lambda: bitpack.pack_fields_batch(vals8, wids8), 3)
    words8, bits8 = bitpack.pack_fields_batch(vals8, wids8)
    bits8 = bits8.cpu().numpy()
    words8 = words8[:, :int(bits8.max()) // 32 + 1].cpu().numpy().view(
        np.uint32)
    stage_ms["splice (host)"] = host_ms(
        lambda: deflate_encode.splice_blocks_host(words8, bits8))
    gz_ms = host_ms(lambda: fgzip.compress(p8, engine="cuda"))
    zl_ms = host_ms(lambda: fzlib.compress(p8, engine="cuda"))
    de_ms = host_ms(lambda: fdeflate.decompress(s8, engine="cuda"))
    crc_ms = host_ms(lambda: eng.crc32(data))
    adl_ms = host_ms(lambda: eng.adler32(data))
    pf_ms = host_ms(lambda: pgzf.compress(data, options=fixed,
                                          device="cuda"))
    log(f"generic deflate.compress(8 MiB, engine='cuda'), hash branch: "
        f"{ms8:.2f} ms median of 3 (host clock), ratio "
        f"{len(s8) / len(p8):.6f}, peak {peak8 / 2**20:.0f} MiB; 64 MiB, "
        f"sort branch: {ms64:.2f} ms, ratio {len(s64) / len(data):.6f}, "
        f"peak {peak64 / 2**20:.0f} MiB (peaks above the {base / 2**20:.0f} "
        f"MiB allocated before) [{card_line}]")
    log("generic _encode_batch stages at 128 x 64 KiB, ms: " + ", ".join(
        f"{k} {v:.4f}" for k, v in stage_ms.items()) + f" [{card_line}]")
    log("generic stage pieces at 128 x 64 KiB, ms: " + ", ".join(
        f"{k} {v:.4f}" for k, v in piece_ms.items()) + f" [{card_line}]")
    log(f"containers, ms median of 3 (host clock): gzip.compress(8 MiB) "
        f"{gz_ms:.2f}, zlib.compress(8 MiB) {zl_ms:.2f}, "
        f"deflate.decompress(8 MiB stream, 128 blocks) {de_ms:.2f}, engine "
        f"crc32(64 MiB) {crc_ms:.2f}, adler32(64 MiB) {adl_ms:.2f}; "
        f"pgzf.compress(64 MiB, fixed) {pf_ms:.2f} [{card_line}]")


def rank_hard_cases(dev):
    """rank_emit_src inputs past the reference's 128-wide search, at out_cap
    2048: three literals, 124 zero-length matches, a literal and a 258-byte
    match (the smallest such input); 300 zero-length matches at one start;
    2,000 at position 3, past the 2048-slot window; the first member's
    starts moved 5 on (no token covers positions 0-4)."""
    from libflate_tpu_torch.ops import device_expand

    def m(length, dist):
        return length | dist << 9

    members = [[97, 98, 99] + [m(0, 2)] * 124 + [122, m(258, 1)],
               [97, 98] + [m(0, 1)] * 300 + [m(30, 2)] + [120] * 40,
               [97, 98, 99] + [m(0, 3)] * 2000 + [m(200, 3)] * 5,
               [97, 98, 99] + [m(0, 2)] * 124 + [122, m(258, 1)]]
    packed = torch.zeros((len(members), 2100), dtype=torch.int32)
    for i, toks in enumerate(members):
        packed[i, :len(toks)] = torch.tensor(toks, dtype=torch.int32)
    n_tok = torch.tensor([len(t) for t in members], dtype=torch.int32)
    starts, pk, valid, n_out, _err = device_expand.rank_inputs(
        packed, n_tok, 2048)
    starts[3] = (starts[3] + 5).clamp(max=2047)
    return tuple(x.to(dev) for x in (starts, pk, valid, n_out)) + (2048,)


def odd_batch_vs_plain(blocks, nv) -> dict:
    """The dynamic encode's kernels on one batch of odd-size members, each
    against its plain version on that batch's own inputs: max_abs_err by
    kernel (the LCP is the torch glue at these widths)."""
    from libflate_tpu_torch.ops import (deflate_encode, fields, hist, pack,
                                        parse, pipeline)
    from libflate_tpu_torch.ops import sort_match as sm
    keys = sm.prefix_keys(blocks)
    sk, sp = sm.sort_keys(keys)
    e = {kname(sm.sort_keys): max(
        max_abs_err(x, y) for x, y in zip((sk, sp), sm.sort_keys_plain(keys)))}
    cand, m4 = sm.scan_emit(sk, sp, blocks)
    e[kname(sm.scan_emit)] = max(max_abs_err(x, y) for x, y in zip(
        (cand, m4), sm.scan_emit_plain(sk, sp, blocks)))
    cand2, lens = pipeline.lengths_stage(blocks, nv, cand, m4)
    jump, tok = parse.parse_inputs(blocks, nv, cand2, lens)
    ex = parse.chunk_exits(jump)
    e[kname(parse.chunk_exits)] = max_abs_err(ex, parse.chunk_exits_plain(
        jump))
    slots, ovf = parse.walk_emit(jump, tok, ex, pipeline.PARSE_CAP)
    e[kname(parse.walk_emit)] = max(max_abs_err(x, y) for x, y in zip(
        (slots, ovf), parse.walk_emit_plain(jump, tok, ex,
                                            pipeline.PARSE_CAP)))
    valid = slots >= 0
    a = torch.where(valid, slots & 511, 0)
    b = torch.where(valid, slots >> 9, 0)
    e[kname(hist.token_hist)] = max_abs_err(hist.token_hist(a, b, valid),
                                            hist.token_hist_plain(a, b, valid))
    stats = pipeline.shared_stats(a, b, valid)
    header = deflate_encode.dynamic_header_fields(*stats[:2])
    tables = fields.field_tables(*stats[2:], blocks.device)
    a_h = torch.where(valid, a, -1)
    fv = fields.token_fields(a_h, b, tables)
    e[kname(fields.token_fields)] = max(max_abs_err(x, y) for x, y in zip(
        fv, fields.token_fields_plain(a_h, b, tables)))
    values, widths = deflate_encode.assemble_fields(
        header, fv, stats[2][256], stats[3][256])
    fpad = (-values.shape[1]) % pack.F_CH
    values = torch.nn.functional.pad(values, (0, fpad)).contiguous()
    widths = torch.nn.functional.pad(widths, (0, fpad)).contiguous()
    starts, bits = pack.chunk_starts(widths)
    cstarts = starts[:, :-1].contiguous()
    w_out = (int(bits.max()) + 31) // 32 + 1
    e[kname(pack.pack_stitch)] = max_abs_err(
        pack.pack_stitch(values, widths, cstarts, w_out),
        pack.pack_stitch_plain(values, widths, cstarts, w_out))
    torch.cuda.synchronize()
    return e


def port_surface(dev, card_line: str, data: bytes, rk_args, hist_args,
                 errs: dict, row: dict) -> None:
    """Phase 11.  ``data``: the 64 MiB encode input; ``rk_args``: the
    decode shard's rank inputs (phase 4); ``hist_args``: phase 6's encode
    batch slots (a, b, valid).  Adds the odd-size encode's launches and
    the repaired kernels' errors to ``row`` / ``errs``."""
    import io

    import numpy as np

    from libflate_tpu_torch import chunked
    from libflate_tpu_torch.formats import deflate as fdeflate
    from libflate_tpu_torch.formats import gzip as fgzip
    from libflate_tpu_torch.formats import pgzf
    from libflate_tpu_torch.formats import zlib as fzlib
    from libflate_tpu_torch.ops import (deflate_decode, expand, fields,
                                        gather, hist, lcp, pack, parse, rank)
    from libflate_tpu_torch.ops import hash_match as hm
    from libflate_tpu_torch.ops import sort_match as sm
    from libflate_tpu_torch.ops import sync_decode as sd
    from libflate_tpu_torch.serial import deflate as sdeflate
    odd_kernels = (sm.sort_keys, sm.scan_emit, parse.chunk_exits,
                   parse.walk_emit, hist.token_hist, fields.token_fields,
                   pack.pack_stitch)
    kernels = odd_kernels + (lcp.match_lengths, gather.gather_rows,
                             hm.hash_candidates, sd.sync_decode,
                             rank.rank_emit_src, expand.resolve_bytes,
                             deflate_decode.decode_symbols)
    times: dict = {}

    def counted(fn):
        for k in kernels:
            k.launches = 0
        res = fn()
        torch.cuda.synchronize()
        return res, {kname(k): k.launches for k in kernels if k.launches}

    def timed(what: str, fn, reps: int = 3):
        """``fn()`` ``reps`` times: the first result, and the median host
        time and the peak device memory above what was allocated before
        into ``times``."""
        walls, out = [], None
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        for i in range(reps):
            t = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
            if i == 0:
                out = res
        times[what] = (statistics.median(walls) * 1e3,
                       (torch.cuda.max_memory_allocated() - base) / 2**20)
        return out

    # 11a. odd member sizes: the first batch's kernels against their plain
    # versions, the 64 MiB counted, read back, the reference streams
    n_b = pgzf.DEV_BATCH
    ob = torch.frombuffer(bytearray(data[:n_b * ODD_MEMBER]),
                          dtype=torch.uint8).view(n_b, ODD_MEMBER).to(dev)
    onv = torch.full((n_b,), ODD_MEMBER, dtype=torch.int32, device=dev)
    odd_errs = odd_batch_vs_plain(ob, onv)
    del ob
    for k, e in odd_errs.items():
        errs[k] = max(errs[k], e)
        row[k]["max_abs_err"] = errs[k]
    log(f"odd member size {ODD_MEMBER}: the first batch's kernels vs plain "
        f"at {n_b} x {ODD_MEMBER}: max_abs_err {odd_errs}")
    if any(odd_errs.values()):
        raise AssertionError("a kernel disagrees with its plain version at "
                             "the odd member size")
    s_odd, c_odd = counted(lambda: pgzf.compress(
        data, member_size=ODD_MEMBER, device="cuda"))
    n_batches = -(-((len(data) + ODD_MEMBER - 1) // ODD_MEMBER) // n_b)
    # at least once a batch (a batch that overflows the parse cap runs
    # again at 512); the match lengths are the glue's at this width
    if (any(c_odd.get(kname(k), 0) < n_batches for k in odd_kernels)
            or any(c_odd.get(kname(k), 0) for k in
                   (lcp.match_lengths, gather.gather_rows,
                    hm.hash_candidates))):
        raise AssertionError(f"odd-size compress launches {c_odd}: want "
                             f"each of {[kname(k) for k in odd_kernels]} "
                             f"at least {n_batches} times and no LCP, "
                             f"gather or hash kernel")
    if gzip.decompress(s_odd) != data:
        raise AssertionError("stdlib gzip does not read back the odd-size "
                             "stream")
    back, c_back = counted(lambda: pgzf.decompress(s_odd, device="cuda"))
    if back != data:
        raise AssertionError("pgzf.decompress does not read back the "
                             "odd-size stream")
    for k in odd_kernels:
        row[kname(k)]["launches"] += c_odd[kname(k)]
    log(f"pgzf.compress(64 MiB, member_size={ODD_MEMBER}, device='cuda'): "
        f"launches {c_odd}; {len(data)} -> {len(s_odd)} bytes (ratio "
        f"{len(s_odd) / len(data):.6f}), read back by stdlib gzip and by "
        f"pgzf.decompress(device='cuda') (launches {c_back})")
    timed("pgzf.compress(64 MiB, 65024-byte members)", lambda: pgzf.compress(
        data, member_size=ODD_MEMBER, device="cuda"))
    timed("pgzf.decompress(65024-byte members)", lambda: pgzf.decompress(
        s_odd, device="cuda"))
    for bad in (1000, 512, 131072):
        try:
            pgzf.compress(data[:4096], member_size=bad, device="cuda")
        except ValueError as e:
            log(f"member_size {bad}: ValueError: {e}")
        else:
            raise AssertionError(f"member_size {bad} was not refused")
    del s_odd, back

    # 11b. the facades at full width on the cuda engine
    p8 = data[:8 << 20]
    g8, c_g8 = counted(lambda: fgzip.compress(p8, engine="cuda"))

    def gzip_encoder():
        enc = fgzip.Encoder(engine="cuda")
        for i in range(0, len(p8), 1 << 20):
            enc.write(p8[i:i + (1 << 20)])
        return enc.getvalue()

    ge8, c_ge8 = counted(gzip_encoder)
    if ge8 != g8 or c_ge8 != c_g8:
        raise AssertionError(f"gzip.Encoder differs from gzip.compress: "
                             f"launches {c_ge8} vs {c_g8}")
    timed("gzip.Encoder(cuda), 8 MiB in 1 MiB writes", gzip_encoder)

    def zlib_sync():
        enc = fzlib.Encoder(engine="cuda", flush_mode=fzlib.FlushMode.SYNC)
        for i in range(0, len(p8), 1 << 20):
            enc.write(p8[i:i + (1 << 20)])
            if i + (1 << 20) == 4 << 20:
                enc.flush()
        return enc.getvalue()

    zs8 = timed("zlib.Encoder(cuda, SYNC flush at 4 MiB), 8 MiB", zlib_sync)
    if zlib.decompress(zs8) != p8 or b"\x00\x00\xff\xff" not in zs8:
        raise AssertionError("stdlib zlib does not read the sync-flushed "
                             "stream")
    tail = data[8 << 20:(8 << 20) + (256 << 10)]
    two = g8 + gzip.compress(tail, mtime=0)

    def read_with_header(cls):
        dec = cls(two, engine="cuda")
        return dec.header.mtime, dec.read()

    dec1 = timed("gzip.Decoder(cuda), 8 MiB member",
                 lambda: read_with_header(fgzip.Decoder))
    decm = timed("gzip.MultiDecoder(cuda), 8 MiB + 256 KiB members",
                 lambda: read_with_header(fgzip.MultiDecoder))
    if dec1 != (0, p8) or decm != (0, p8 + tail):
        raise AssertionError("gzip.Decoder / MultiDecoder read wrong bytes")
    raw8 = g8[10:-8]
    for pos in range(len(raw8) // 2, len(raw8)):
        flipped = bytearray(raw8)
        flipped[pos] ^= 0x10
        try:
            zlib.decompress(bytes(flipped), -15)
        except zlib.error:
            break
    flipped = bytes(flipped)
    salv = timed("deflate.Decoder(cuda) of the 8 MiB with a byte flipped "
                 "(serial salvage)", lambda: fdeflate.Decoder(
                     flipped, engine="cuda"))
    try:
        sdeflate.inflate(flipped)
        serial_partial = None
    except (sdeflate.DeflateError, EOFError) as e:
        serial_partial = e.partial
    try:
        salv.read()
    except (sdeflate.DeflateError, EOFError) as e:
        read_error = type(e).__name__
    else:
        raise AssertionError("deflate.Decoder.read() did not raise")
    if salv.unread_decoded_data() != serial_partial:
        raise AssertionError("the salvage differs from the serial .partial")
    log(f"facades on cuda: gzip.Encoder of 8 MiB in 1 MiB writes equals "
        f"gzip.compress ({len(g8)} bytes, launches {c_ge8}); the SYNC "
        f"zlib stream ({len(zs8)} bytes) read by stdlib zlib; Decoder / "
        f"MultiDecoder on two members read back; the stream flipped at "
        f"byte {pos} of {len(raw8)}: read() raises {read_error}, salvage "
        f"{len(serial_partial)} bytes, equal to the serial .partial")

    # 11c. the host paths: the serial engine, BlockStreamer, chunked
    p1 = data[:1 << 20]
    s1 = timed("serial deflate(1 MiB)", lambda: sdeflate.deflate(p1))
    b1 = timed("serial inflate(1 MiB stream)", lambda: bytes(
        sdeflate.inflate(s1).data))

    def streamer():
        bs = fdeflate.BlockStreamer()
        out = [bs.feed(p1[i:i + 65536]) for i in range(0, len(p1), 65536)]
        return b"".join(out) + bs.finish()

    st1 = timed("BlockStreamer(1 MiB in 64 KiB writes)", streamer)
    if b1 != p1 or st1 != s1 or zlib.decompress(s1, -15) != p1:
        raise AssertionError("the serial engine's 1 MiB round trip failed")

    def chunked_feed():
        dec = chunked.ChunkedGzipDecoder()
        out = [dec.feed(ge8[i:i + 4096]) for i in range(0, len(ge8), 4096)]
        dec.finish()
        return b"".join(out)

    # one run: ~19 s a call on the card's host
    if timed("ChunkedGzipDecoder, 8 MiB stream in 4 KiB feeds [1 run]",
             chunked_feed, reps=1) != p8:
        raise AssertionError("the chunked decoder read wrong bytes")
    log(f"host paths: serial deflate / inflate of 1 MiB ({len(s1)} bytes, "
        f"ratio {len(s1) / len(p1):.6f}), BlockStreamer in 64 KiB writes "
        f"equal to the one-shot, the chunked gzip decoder over the 8 MiB "
        f"stream in 4 KiB feeds")

    # 11d. the CLI as a subprocess on the 8 MiB corpus
    import tempfile
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        tmp = pathlib.Path(tmp)
        src = tmp / "corpus"
        src.write_bytes(p8)
        runs = [("gzip-encode", src, "g.gz", []),
                ("gzip-decode", "g.gz", "g.out", []),
                ("pgzf-encode", src, "p.pgz", []),
                ("pgzf-decode", "p.pgz", "p.out", []),
                ("gzip-encode", src, "s.gz", ["--stream"]),
                ("gzip-decode", "s.gz", "s.out", ["--stream"])]
        for cmd, inp, out, extra in runs:
            inp = inp if isinstance(inp, pathlib.Path) else tmp / inp
            argv = [sys.executable, "-m", "libflate_tpu_torch.cli", "-i",
                    str(inp), "-o", str(tmp / out), "--engine", "cuda",
                    *extra, cmd]

            def run_cli(argv=argv):
                res = subprocess.run(argv, cwd=ROOT, capture_output=True,
                                     text=True, timeout=300)
                if res.returncode:
                    raise AssertionError(f"{argv[3:]} exit "
                                         f"{res.returncode}: {res.stderr}")

            # one run each: 12-33 s a subprocess on the card's host
            timed(f"cli {' '.join(extra + [cmd])} (subprocess) [1 run]",
                  run_cli, reps=1)
            blob = (tmp / out).read_bytes()
            ok = (gzip.decompress(blob) == p8 if out.endswith(("gz", "pgz"))
                  else blob == p8)
            if not ok:
                raise AssertionError(f"cli {cmd} {extra}: wrong output")
        log("cli on the 8 MiB corpus, --engine cuda: gzip-encode, "
            "gzip-decode, pgzf-encode, pgzf-decode, and --stream "
            "gzip-encode / gzip-decode, each exit 0, verified by stdlib "
            "gzip")

    # 11e. the repaired kernels against their plain versions: token_hist
    # on slots over all of int32, rank_emit_src past the reference's
    # 128-wide search; both on the main path's inputs again; each alone
    gen = np.random.default_rng(15)
    shp = tuple(hist_args[0].shape)
    h_any = [torch.from_numpy(gen.integers(-2**31, 2**31, shp).astype(
        np.int32)).to(dev) for _ in range(2)]
    h_any[1] = torch.where(torch.from_numpy(gen.random(shp) < 0.5).to(dev),
                           0, h_any[1])
    h_any.append(torch.from_numpy(gen.random(shp) < 0.3).to(dev))
    rk_hard = rank_hard_cases(dev)
    rep = {}
    for what, args in (("int32 slots", h_any), ("main path", hist_args)):
        rep[f"token_hist {what}"] = max_abs_err(
            hist.token_hist(*args), hist.token_hist_plain(*args))
    for what, args in (("past 128 starts", rk_hard), ("main path", rk_args)):
        rep[f"rank_emit_src {what}"] = max(
            max_abs_err(x, y) for x, y in zip(rank.rank_emit_src(*args),
                                              rank.rank_emit_src_plain(*args)))
    torch.cuda.synchronize()
    for k in (hist.token_hist, rank.rank_emit_src):
        e = max(v for key, v in rep.items() if key.startswith(k.__name__))
        errs[kname(k)] = max(errs[kname(k)], e)
        row[kname(k)]["max_abs_err"] = errs[kname(k)]
    alone = {
        "token_hist int32 slots": lambda: hist.token_hist(*h_any),
        "token_hist main path": lambda: hist.token_hist(*hist_args),
        "rank_emit_src past 128 starts": lambda: rank.rank_emit_src(
            *rk_hard),
        "rank_emit_src main path": lambda: rank.rank_emit_src(*rk_args)}
    alone_ms = {k: cuda_ms_many([fn], 48) for k, fn in alone.items()}
    log(f"repaired kernels vs plain: max_abs_err {rep}; launched 48 times "
        f"back to back, ms per call (wrapper included): " + ", ".join(
            f"{k} {v:.4f}" for k, v in alone_ms.items())
        + f" [{card_line}]")
    if any(rep.values()):
        raise AssertionError("a repaired kernel disagrees with its plain "
                             "version")

    # 11f. host-clock times, median of 3 ("[1 run]": one), with the peak
    # device memory
    log("phase 11 host clock, median of 3 ([1 run]: one run), ms (peak "
        "device memory above "
        "the allocation before, MiB): " + "; ".join(
            f"{k} {ms:.2f} ({peak:.0f})" for k, (ms, peak) in times.items())
        + f" [{card_line}]")


#: the native engine's committed reference streams, written by
#: scripts/make_native_fixture.py: name -> pgzf member size, or None for
#: the raw ``deflate_greedy`` stream (its arguments in NATIVE_GREEDY_KW)
NATIVE_FIXTURES = {
    "native_pgzf_65536.pgz": 65536,
    "native_pgzf_1024.pgz": 1024,
    "native_pgzf_65024.pgz": 65024,
    "native_deflate_lazy_chain.bin": None,
}
NATIVE_GREEDY_KW = {"block_size": 65536, "lazy": True, "max_chain": 32}


def host_cpu() -> str:
    """The host CPU as /proc/cpuinfo names it: its "model name" and the
    vendor, family, model, stepping and clock fields that are there (some
    kernels report the name as "unknown"), its architecture and its core
    counts."""
    import platform
    fields: dict = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                fields.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    model = "; ".join(f"{k} {fields[k]}" for k in (
        "model name", "vendor_id", "cpu family", "model", "stepping",
        "cpu MHz", "CPU implementer", "CPU part") if k in fields)
    return (f"{model or 'no /proc/cpuinfo'} ({platform.machine()}), "
            f"os.cpu_count() {os.cpu_count()}, usable "
            f"{len(os.sched_getaffinity(0))}")


def native_members(stream: bytes, window: int = 1 << 17,
                   ends: list | None = None) -> bytes:
    """Every gzip member of ``stream`` through ``native.inflate``, walked
    by its end bit (no index); a member body is read from a ``window``
    -byte slice.  Each member's end offset is appended to ``ends`` when
    given."""
    from libflate_tpu_torch import native
    from libflate_tpu_torch.formats import gzip as fgzip
    out, pos = [], 0
    while pos < len(stream):
        _hdr, body = fgzip.Header.decode(stream, pos)
        plain, end_bit = native.inflate(stream[body:body + window])
        isize = struct.unpack_from("<I", stream, body + (end_bit + 7) // 8
                                   + 4)[0]
        if isize != len(plain) & 0xFFFFFFFF:
            raise AssertionError(f"member at {pos}: ISIZE {isize}, decoded "
                                 f"{len(plain)}")
        out.append(plain)
        pos = body + (end_bit + 7) // 8 + 8
        if ends is not None:
            ends.append(pos)
    return b"".join(out)


def native_engine(card_line: str, data: bytes, dev_stream: bytes,
                  foreign: bytes) -> None:
    """Phase 12.  ``data``: the 64 MiB plaintext; ``dev_stream``: its
    device encode (phase 7); ``foreign``: it as 1024 stdlib-gzip members
    (phase 5c).  Raises on any mismatch."""
    from libflate_tpu_torch import backend, native
    from libflate_tpu_torch.formats import deflate as fdeflate
    from libflate_tpu_torch.formats import pgzf

    t_phase = time.perf_counter()
    cpu = host_cpu()
    log(f"phase 12 host: {cpu}; library {native.library_path().name} "
        f"[{card_line}]")
    # committed reference streams, at one thread and one a core
    for fname, member in NATIVE_FIXTURES.items():
        want = (DATA / fname).read_bytes()
        if member is None:
            plain = zlib.decompress(want, -15)
            got = [native.deflate_greedy(plain, **NATIVE_GREEDY_KW)]
        else:
            plain = gzip.decompress(want)
            got = [pgzf.compress(plain, member, engine="native",
                                 n_threads=t) for t in (0, 1)]
            if pgzf.decompress(want, engine="native") != plain:
                raise AssertionError(f"{fname}: native decode differs")
        if any(g != want for g in got):
            raise AssertionError(f"{fname}: the native engine's stream "
                                 f"differs from the committed one")
    log(f"native streams byte-identical to {sorted(NATIVE_FIXTURES)} "
        f"(pgzf at n_threads 0 and 1)")

    times: dict = {}

    def timed(what: str, fn, plain_bytes: int):
        """The first of 3 calls' results; the median host time and the
        rate in plaintext bytes into ``times``."""
        walls, out = [], None
        for i in range(3):
            t = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
            if i == 0:
                out = res
        ms = statistics.median(walls) * 1e3
        times[what] = (ms, plain_bytes / ms / 1e3)
        return out

    # checksums against zlib, beside the cuda engine's
    eng = {n: backend.get(n) for n in ("native", "cuda")}
    for fn in ("crc32", "adler32"):
        want = getattr(zlib, fn)(data)
        for n, e in eng.items():
            got = timed(f"{n} {fn}(64 MiB)", lambda e=e: getattr(e, fn)(data),
                        len(data))
            if got != want:
                raise AssertionError(f"{n} {fn} {got:#x} != zlib {want:#x}")
    # the decoders against stdlib gzip on the device stream and the 1024
    # stdlib-gzip members: member by member, then pgzf's native routes
    for what, stream in (("device stream", dev_stream),
                         ("1024 stdlib gzip members", foreign)):
        ends: list = []                     # the last loop's: foreign's
        if native_members(stream, ends=ends) != data:
            raise AssertionError(f"native.inflate of the {what} differs")
        got = timed(f"pgzf.decompress(native) of the {what}",
                    lambda stream=stream: pgzf.decompress(stream,
                                                          engine="native"),
                    len(data))
        if got != data:
            raise AssertionError(f"pgzf.decompress(native) of the {what} "
                                 f"differs")
    # the gzip container's member walk (no index) over the first 256 and
    # 512 of those members: its time grows with the square of the stream
    for n in (256, 512):
        part, plain = foreign[:ends[n - 1]], data[:n << 16]
        if timed(f"pgzf.decompress(native) of the first {n} stdlib gzip "
                 f"members", lambda part=part: pgzf.decompress(
                     part, engine="native"), len(plain)) != plain:
            raise AssertionError(f"pgzf.decompress(native) of the first {n} "
                                 f"stdlib gzip members differs")
    # the native pgzf encode, one thread a core and one thread
    streams = {t: timed(f"pgzf.compress(64 MiB, 65536, native, n_threads="
                        f"{t})", lambda t=t: pgzf.compress(
                            data, 65536, engine="native", n_threads=t),
                        len(data))
               for t in (0, 1)}
    if streams[0] != streams[1]:
        raise AssertionError("n_threads 0 and 1 give different streams")
    nat = streams[0]
    if gzip.decompress(nat) != data:
        raise AssertionError("stdlib gzip does not read the native stream")
    if timed("pgzf.decompress(native) of the native stream",
             lambda: pgzf.decompress(nat, engine="native"),
             len(data)) != data:
        raise AssertionError("pgzf.decompress(native) of its own stream")
    p8 = data[:8 << 20]
    d8 = timed("deflate.compress(8 MiB, native)",
               lambda: fdeflate.compress(p8, engine="native"), len(p8))
    if zlib.decompress(d8, -15) != p8:
        raise AssertionError("zlib does not read the native deflate stream")
    if timed("deflate.decompress(native) of it",
             lambda: fdeflate.decompress(d8, engine="native"),
             len(p8)) != p8:
        raise AssertionError("deflate.decompress(native) differs")
    log(f"native engine: pgzf.compress(64 MiB, 65536) {len(data)} -> "
        f"{len(nat)} bytes (ratio {len(nat) / len(data):.6f}); "
        f"deflate.compress(8 MiB) -> {len(d8)} bytes (ratio "
        f"{len(d8) / len(p8):.6f}); native.inflate member by member and "
        f"pgzf.decompress(native) equal gzip on the device stream and the "
        f"1024 stdlib gzip members")
    log("phase 12 host clock, median of 3, ms (MB/s of plaintext): "
        + "; ".join(f"{k} {ms:.2f} ({rate:.1f})"
                    for k, (ms, rate) in times.items())
        + f" [{card_line}] [{cpu}]")
    log(f"phase 12 took {time.perf_counter() - t_phase:.1f} s")


def parallel_paths(dev, card_line: str, data: bytes, blocks, nv,
                   enc_stream: bytes, row: dict) -> None:
    """Phase 13.  ``data``: the 64 MiB; ``blocks`` / ``nv``: phase 6's
    first batch (128 x 64 KiB) on the card; ``enc_stream``: phase 7's
    one-process ``pgzf.compress`` of ``data``.  Adds the counted
    launches of the sharded calls, the dry runs and the multi-process
    workers to ``row``.  Raises AssertionError naming the sub-phase."""
    import numpy as np

    from libflate_tpu_torch import graft_entry
    from libflate_tpu_torch.ops import (deflate_decode, device_expand,
                                        expand, fields, hist, lcp, pack,
                                        parse, pipeline, rank)
    from libflate_tpu_torch.ops import hash_match as hm
    from libflate_tpu_torch.ops import sort_match as sm
    from libflate_tpu_torch.ops import sync_decode as sd
    from libflate_tpu_torch.ops.huffman import decode_table
    from libflate_tpu_torch.parallel import sharding
    from libflate_tpu_torch.parallel.mesh import make_mesh
    t_phase = time.perf_counter()
    kernels = (sm.sort_keys, sm.scan_emit, parse.chunk_exits,
               parse.walk_emit, hist.token_hist, fields.token_fields,
               pack.pack_stitch, hm.hash_candidates, lcp.match_lengths,
               deflate_decode.decode_symbols, sd.sync_decode,
               rank.rank_emit_src, expand.resolve_bytes)
    totals = {kname(k): 0 for k in kernels}
    times: dict = {}

    def counted(what: str, fn, need: dict):
        """``fn()`` with every count at 0 before and read after; each
        kernel of ``need`` launched that many times (None: at least
        once)."""
        for k in kernels:
            k.launches = 0
        res = fn()
        torch.cuda.synchronize()
        counts = {kname(k): k.launches for k in kernels if k.launches}
        for k, n in counts.items():
            totals[k] += n
        bad = {kname(k): counts.get(kname(k), 0) for k, n in need.items()
               if (counts.get(kname(k), 0) < 1 if n is None
                   else counts.get(kname(k), 0) != n)}
        if bad:
            raise AssertionError(f"phase {what}: kernel launches {bad}, "
                                 f"expected {need} (all: {counts})")
        log(f"phase {what} launches: {counts}")
        return res

    def timed(what: str, fn, reps: int = 3) -> None:
        walls = []
        for _ in range(reps):
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
        times[what] = statistics.median(walls) * 1e3

    # 13a. one card and four logical shards on it, phase 6's first batch
    blocks_h, nv_h = blocks.cpu().numpy(), nv.cpu().numpy()
    n_b, width = blocks_h.shape
    bf = np.ones(n_b, np.int32)
    k_tok = sd.SYNC_TOKENS
    w_gen, b_gen = pipeline.encode_batch_generic(
        blocks, nv, bf, "dynamic", pipeline.use_kernel_branches(dev))
    w_gen = w_gen.cpu().numpy().view(np.uint32)
    b_gen = b_gen.cpu().numpy()
    want = {k: v.cpu().numpy() for k, v in
            pipeline.encode_batch(blocks, nv, k_tok).items()}
    meshes = {"one card": make_mesh(),
              "4 logical shards": make_mesh(4, devices=[dev] * 4)}
    for label, mesh in meshes.items():
        m = len(mesh)
        what = f"13a ({label}, {m} shard{'s' if m > 1 else ''})"
        words, bits = counted(
            f"{what} encode_blocks_sharded",
            lambda: sharding.encode_blocks_sharded(blocks_h, nv_h, bf, mesh),
            {hm.hash_candidates: m, fields.token_fields: None,
             parse.walk_emit: None})
        if not (np.array_equal(words, w_gen) and np.array_equal(bits, b_gen)):
            raise AssertionError(f"phase {what}: encode_blocks_sharded "
                                 f"differs from encode_batch_generic")
        lit, dist, starts, rows, bodies = graft_entry._member_words(words,
                                                                    bits)
        for i, body in enumerate(bodies):
            if zlib.decompress(body, -15) != blocks_h[i].tobytes():
                raise AssertionError(f"phase {what}: zlib does not read "
                                     f"member {i}")
        out, n_out, err = counted(
            f"{what} decode_members_sharded",
            lambda: sharding.decode_members_sharded(rows, starts, lit, dist,
                                                    width, mesh),
            {deflate_decode.decode_symbols: m})
        if err.any() or not (np.array_equal(n_out, nv_h)
                             and np.array_equal(out, blocks_h)):
            raise AssertionError(f"phase {what}: decode_members_sharded is "
                                 f"not the plaintext")
        got = counted(
            f"{what} encode_sync_sharded",
            lambda: sharding.encode_sync_sharded(blocks_h, nv_h, bf, k_tok,
                                                 mesh),
            {sm.sort_keys: m, sm.scan_emit: m, hist.token_hist: m,
             fields.token_fields: m, pack.pack_stitch: m})
        for g, key in zip(got, ("words", "bits", "n_tokens", "offsets")):
            if not np.array_equal(g, want[key].astype(g.dtype)):
                raise AssertionError(f"phase {what}: encode_sync_sharded's "
                                     f"{key} differ from encode_batch's")
        # the sync decode: a chunk table of the shared-table members
        # against the unsharded kernel on the members end to end
        words2, bits2, cnt2, offs2 = got
        lit2, dist2, _s, rows2, bodies2 = graft_entry._member_words(words2,
                                                                    bits2)
        max_nc = -(-int(cnt2.max()) // k_tok)
        j = np.minimum(np.arange(max_nc), offs2.shape[1] - 1)
        ch_bits = offs2[:, j].reshape(-1)
        ch_cnts = np.clip(cnt2[:, None].astype(np.int64)
                          - np.arange(max_nc)[None, :] * k_tok, 0,
                          k_tok).reshape(-1).astype(np.int32)
        ch_rows = np.repeat(rows2, max_nc, axis=0)
        toks = counted(
            f"{what} decode_sync_sharded",
            lambda: sharding.decode_sync_sharded(ch_rows, ch_bits, ch_cnts,
                                                 lit2[:1], dist2[:1], k_tok,
                                                 mesh),
            {sd.sync_decode: m})
        body_off = np.cumsum([0] + [len(b_) for b_ in bodies2[:-1]])
        rb = max(int(lit2.max()), 7)
        whole = sd.sync_decode(
            sd.stream_words(b"".join(bodies2), dev),
            torch.from_numpy((body_off[:, None] * 8 + offs2[:, j]).reshape(
                -1).astype(np.int64)).to(dev),
            torch.from_numpy(ch_cnts).to(dev),
            decode_table(lit2[0], rb, dev), decode_table(dist2[0], 8, dev),
            k_tok, rb, debug=False)
        if not np.array_equal(toks, whole.cpu().numpy()):
            raise AssertionError(f"phase {what}: decode_sync_sharded "
                                 f"differs from the unsharded sync_decode")
        back, _n, berr = device_expand.expand_members(
            whole.view(n_b, -1), torch.from_numpy(cnt2).to(dev), width)
        if bool(berr.any()) or not np.array_equal(back.cpu().numpy(),
                                                  blocks_h):
            raise AssertionError(f"phase {what}: the sync tokens do not "
                                 f"expand to the plaintext")
        crcs = [zlib.crc32(blocks_h[i, :nv_h[i]].tobytes())
                for i in range(n_b)]
        if sharding.combine_shard_crcs(crcs, [int(x) for x in nv_h]) != \
                zlib.crc32(data[:n_b * width]):
            raise AssertionError(f"phase {what}: combine_shard_crcs")
        log(f"phase {what}: encode_blocks_sharded equal to "
            f"encode_batch_generic (hash branch), every member read by zlib;"
            f" decode_members_sharded the plaintext; encode_sync_sharded "
            f"equal to encode_batch (words, bits, counts, offsets); "
            f"decode_sync_sharded of {len(ch_bits)} chunks equal to the "
            f"unsharded sync_decode; combine_shard_crcs equal to zlib")
        timed(f"encode_blocks_sharded [{label}]",
              lambda: sharding.encode_blocks_sharded(blocks_h, nv_h, bf, mesh))
        timed(f"decode_members_sharded [{label}]",
              lambda: sharding.decode_members_sharded(rows, starts, lit, dist,
                                                      width, mesh))
        timed(f"encode_sync_sharded [{label}]",
              lambda: sharding.encode_sync_sharded(blocks_h, nv_h, bf, k_tok,
                                                   mesh))
        timed(f"decode_sync_sharded [{label}]",
              lambda: sharding.decode_sync_sharded(
                  ch_rows, ch_bits, ch_cnts, lit2[:1], dist2[:1], k_tok,
                  mesh))
        del ch_rows, rows2, rows, out
    timed("encode_batch_generic, unsharded, words to the host",
          lambda: pipeline.encode_batch_generic(
              blocks, nv, bf, "dynamic", True)[0].cpu())
    timed("encode_batch, unsharded, words to the host",
          lambda: pipeline.encode_batch(blocks, nv, k_tok)["words"].cpu())

    # 13b. the dry run over four logical shards on the card
    counted("13b dryrun_multichip(4, [cuda:0] * 4)",
            lambda: graft_entry.dryrun_multichip(4, devices=[dev] * 4),
            {deflate_decode.decode_symbols: 4, sd.sync_decode: 8,
             rank.rank_emit_src: 4, expand.resolve_bytes: 4,
             hist.token_hist: 4, pack.pack_stitch: 4})
    timed("dryrun_multichip(4, [cuda:0] * 4)",
          lambda: graft_entry.dryrun_multichip(4, devices=[dev] * 4))

    # 13c. two processes over gloo, both on cuda:0, 512 members each
    def multihost():
        stream, launches = graft_entry.dryrun_multihost(
            2, device="cuda", data=data, member_size=65536, timeout=300)
        if stream != enc_stream:
            raise AssertionError("phase 13c: the two-process stream differs "
                                 "from phase 7's one-process stream")
        return launches

    walls = []
    for i in range(3):
        t = time.perf_counter()
        got = multihost()
        walls.append(time.perf_counter() - t)
        if i == 0:
            launches = got
    times["dryrun_multihost(2, cuda), 64 MiB"] = statistics.median(
        walls) * 1e3
    need = [kname(k) for k in (sm.sort_keys, sm.scan_emit, parse.chunk_exits,
                               parse.walk_emit, hist.token_hist,
                               fields.token_fields, pack.pack_stitch,
                               sd.sync_decode, rank.rank_emit_src,
                               expand.resolve_bytes)]
    if any(launches.get(k, 0) < 1 for k in need):
        raise AssertionError(f"phase 13c: a kernel of the path did not run "
                             f"in the workers: {launches}")
    for k in totals:
        totals[k] += launches.get(k, 0)
    log(f"phase 13c dryrun_multihost(2, cuda) on {len(data)} bytes: stream "
        f"byte-identical to phase 7's, decompress_multihost equal to the "
        f"input and corpus_crc32_multihost equal to zlib in both workers; "
        f"the workers' launches: "
        f"{ {k: v for k, v in launches.items() if v} }")
    for k, n in totals.items():
        row[k]["launches"] += n
    log(f"phase 13 launches added to the kernels' rows: "
        f"{ {k: n for k, n in totals.items() if n} }")
    # 13d. host-clock times
    log("phase 13 host clock, median of 3, ms: " + "; ".join(
        f"{k} {ms:.2f}" for k, ms in times.items()) + f" [{card_line}]")
    log(f"phase 13 took {time.perf_counter() - t_phase:.1f} s")


if __name__ == "__main__":
    main()
