"""PGZF device decode (counterpart of ``libflate_tpu/formats/pgzf.py``:
``decompress_to_device`` (``:752-825``), ``_prepare_sync_device``
(``:973-1079``), ``_run_sync_chain`` (``:1082``) and ``_sync_to_plain``
(``:1116-1151``)).

The host half — member index, LS sync-index parsing, chunk spans, the
native header parser — is the reference's own JAX-free code.  The device
half is this package's: sync decode -> expand_members -> CRC f-values, on
the device the caller names.  Streams without the LS index (the
reference's speculative and foreign-stream bridges) are not ported yet.
"""
from __future__ import annotations

import struct

import numpy as np
import torch

from libflate_tpu.formats import gzip as fgzip
from libflate_tpu.formats.pgzf import (_chunk_spans, _parse_sync,
                                       index_members)
from libflate_tpu.serial.deflate import DeflateError
from libflate_tpu.spec import constants as C

from ..ops.checksum import crc32_f_rows, crc32_from_padded_f
from ..ops.device_expand import expand_members
from ..ops.huffman import decode_table
from ..ops.sync_decode import stream_words, sync_decode


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        from .. import require_cuda
        require_cuda()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def decompress_to_device(data: bytes, verify: bool = False,
                         device="cuda"):
    """Decode a sync-indexed PGZF stream into memory on ``device``.

    Returns ``(out, lengths)``: ``out`` is a (n_members, member_cap)
    uint8 tensor, row i holding member i's plaintext in
    ``out[i, :lengths[i]]`` and zeros after it; ``lengths`` is (n_members,)
    int32.  Both live on ``device``.  ``verify=True`` checks every
    member's CRC-32, computed from the decoded rows, against its trailer.

    Raises ImportError for a stream this path does not take (no LS sync
    index, not shared-table, no native header parser), DeflateError for
    a corrupt back-reference, GzipError for a CRC mismatch, and
    RuntimeError for ``device="cuda"`` without CUDA.
    """
    dev = _device(device)
    data = bytes(data)
    try:
        groups = _prepare_sync_device(data, dev)
    except ImportError as e:
        raise ImportError(f"{e}; the speculative and foreign-stream device "
                          "paths are not ported yet") from e
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


def decompress_host(data: bytes) -> bytes:
    """Plaintext from the reference's threaded native (C++) engine: the
    JAX-free host oracle for :func:`decompress_to_device`."""
    from libflate_tpu import native
    from libflate_tpu.formats.pgzf import decompress
    if not native.available():
        raise ImportError("the native engine did not build")
    return decompress(data, engine="native", verify=True)


def _prepare_sync_device(data: bytes, device) -> list[dict]:
    """Host-side staging for the device decode chain.

    Parses the LS index and the block headers, splits members into
    contiguous groups sharing one code table and chunk size, and gives
    member j of a group the chunk slots ``[j*max_nc, (j+1)*max_nc)``
    (padding slots decode 0 tokens), so the token rows come out
    member-major.  The stream goes to the device once, as words; each
    slot carries its absolute start bit.  Raises ImportError if ANY member
    is not sync-decodable.
    """
    refs = index_members(data)
    if not refs:
        raise ImportError("no member index")
    n_all = len(refs)
    isizes_all = np.zeros((n_all,), np.int64)
    crcs_all = np.zeros((n_all,), np.uint32)
    syncs: list = [None] * n_all
    for i, ref in enumerate(refs):
        crcs_all[i], isizes_all[i] = struct.unpack_from(
            "<II", data, ref.end - 8)
        hdr, _ = fgzip.Header.decode(data, ref.start)
        syncs[i] = _parse_sync(hdr)
    if any(s is None for s in syncs):
        raise ImportError("stream is not fully sync-indexed")

    from libflate_tpu import native
    if not native.available():
        raise ImportError("needs the native header parser")
    bodies = b"".join(data[r.body:r.end - 8] for r in refs)
    offs_b = np.zeros(n_all + 1, np.uint64)
    for i, r in enumerate(refs):
        offs_b[i + 1] = offs_b[i] + (r.end - 8 - r.body)
    lit_ls, dist_ls, starts64, flags = native.parse_dyn_headers(
        bodies, offs_b)
    if not ((flags == 5).all() and int(lit_ls.max()) <= 12
            and int(dist_ls.max()) <= 8):
        raise ImportError("not a sync-decodable shared-table stream")

    # contiguous groups with identical tables and chunk size
    bounds = [0]
    for i in range(1, n_all):
        if not ((lit_ls[i] == lit_ls[bounds[-1]]).all()
                and (dist_ls[i] == dist_ls[bounds[-1]]).all()
                and syncs[i][0] == syncs[bounds[-1]][0]):
            bounds.append(i)
    bounds.append(n_all)

    member_cap = int(isizes_all.max(initial=1))
    member_cap = 1 << max(10, (member_cap - 1).bit_length())

    words = stream_words(data, device)
    groups = []
    for g0, g1 in zip(bounds[:-1], bounds[1:]):
        bsz = g1 - g0
        k_tok = syncs[g0][0]
        nc = np.zeros((bsz,), np.int64)
        for j, i in enumerate(range(g0, g1)):
            if int(syncs[i][2]) != int(starts64[i]):
                raise ImportError("sync index disagrees with block header")
            nc[j] = -(-int(syncs[i][1]) // k_tok)
        max_nc = int(nc.max(initial=1))
        start_bits = np.zeros((bsz * max_nc,), np.int64)
        counts = np.zeros((bsz * max_nc,), np.int32)
        for j, i in enumerate(range(g0, g1)):
            starts, _ends, counts_i = _chunk_spans(syncs[i], refs[i])
            s0 = j * max_nc
            start_bits[s0:s0 + len(starts)] = refs[i].body * 8 + starts
            counts[s0:s0 + len(starts)] = counts_i
        rb = max(int(np.max(lit_ls[g0][:C.MAX_LITLEN_SYMBOLS])), 7)
        groups.append({
            "words": words,
            "start_bits": torch.from_numpy(start_bits).to(device),
            "counts": torch.from_numpy(counts).to(device),
            "lit_t": decode_table(lit_ls[g0][:C.MAX_LITLEN_SYMBOLS], rb,
                                  device),
            "dist_t": decode_table(dist_ls[g0], 8, device),
            "k_tok": k_tok, "root_bits": rb,
            "bsz": bsz, "max_nc": max_nc, "member_cap": member_cap,
            "n_tokens": torch.tensor([int(syncs[i][1]) for i in
                                      range(g0, g1)], dtype=torch.int32,
                                     device=device),
            "isizes": isizes_all[g0:g1],
            "crcs_expected": crcs_all[g0:g1],
            "member0": g0,
        })
    return groups


def _run_sync_chain(prep: dict):
    """The device decode chain after staging: sync decode -> expansion ->
    CRC f-values.  Returns (plain, n_out, err, crc_f) on the group's
    device."""
    toks = sync_decode(prep["words"], prep["start_bits"], prep["counts"],
                       prep["lit_t"], prep["dist_t"], prep["k_tok"],
                       root_bits=prep["root_bits"])
    return _sync_to_plain(toks, prep["bsz"], prep["max_nc"], prep["k_tok"],
                          prep["n_tokens"], prep["member_cap"])


def _sync_to_plain(toks, bsz: int, max_nc: int, k_tok: int, n_tokens,
                   member_cap: int):
    """Slot-major tokens -> plaintext rows, error flags and CRC f-values.
    Member j's slots are contiguous, so its token row is a view."""
    packed = toks.view(bsz, max_nc * k_tok)
    plain, n_out, err = expand_members(packed, n_tokens, member_cap)
    return plain, n_out, err, crc32_f_rows(plain)
