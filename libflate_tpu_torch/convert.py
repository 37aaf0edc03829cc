"""Carry the reference's state across to the port.

:func:`from_reference_batch` turns the reference's per-batch encode
intermediates (numpy arrays) into the port's tensors, so each encode
stage can be fed exactly the reference's input.
:func:`from_reference_group` turns one group dict of the reference's
``libflate_tpu.formats.pgzf._prepare_sync_device`` (numpy or jax arrays)
into the dict that :func:`libflate_tpu_torch.formats.pgzf._run_sync_chain`
takes, on a given device, so both sides decode identical state.  The
reference stages each chunk slot as a column of ``D`` words in its TPU
layout ``(P, D*8, 128)``; the port reads one flat word stream with an
absolute start bit per slot, so the columns are laid end to end and slot
s starts at bit ``s*D*32 + sb[s]``.
:func:`from_reference_spec_inputs` turns the inputs of the reference's
speculative decode (``_spec_fused_jit``: lane-major words, tables, first
symbols) into the port's member-major ones.
:func:`from_reference_options` copies the reference's ``EncodeOptions``
into the port's.  Nothing here imports JAX.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

SUBLANES, LANES = 8, 128          # the reference's slot tiling


def from_reference_group(prep: dict, device="cpu") -> dict:
    staged = np.asarray(prep["staged"]).view(np.uint32)
    p_, rows, lanes = staged.shape
    d_words = rows // SUBLANES
    n_slots = prep["bsz"] * prep["max_nc"]
    # slot (p, sub, lane) owns staged[p, r*8+sub, lane] for r < D
    cols = staged.reshape(p_, d_words, SUBLANES, lanes).transpose(
        0, 2, 3, 1).reshape(p_ * SUBLANES * lanes, d_words)[:n_slots]
    sb = np.asarray(prep["sb"]).reshape(-1)[:n_slots].astype(np.int64)
    counts = np.asarray(prep["counts"]).reshape(-1)[:n_slots]
    start_bits = np.arange(n_slots, dtype=np.int64) * d_words * 32 + sb

    def tensor(a, dtype):
        return torch.from_numpy(np.array(a)).to(device, dtype)

    return {
        "words": tensor(cols.reshape(-1).view(np.int32), torch.int32),
        "start_bits": tensor(start_bits, torch.int64),
        "counts": tensor(counts.astype(np.int32), torch.int32),
        "lit_t": tensor(np.asarray(prep["lit_t"], np.int32), torch.int32),
        "dist_t": tensor(np.asarray(prep["dist_t"], np.int32), torch.int32),
        "n_tokens": tensor(np.asarray(prep["n_tokens"], np.int32),
                           torch.int32),
        **{k: prep[k] for k in ("k_tok", "root_bits", "bsz", "max_nc",
                                "member_cap", "isizes", "crcs_expected",
                                "member0")},
    }


def from_reference_spec_inputs(words, lit_t, dist_t, starts_g,
                               n_members: int, device="cpu") -> dict:
    """The reference's speculative-decode inputs -> the port's.

    words (1, W, 128) uint32 (member k in lane k), lit_t (4096,), dist_t
    (256,), starts_g (128,) -> a dict of ``words`` (n_members, W) int32,
    ``lit_t``, ``dist_t`` int32 and ``starts`` (n_members,) int32 on
    ``device``: the keyword arguments of ``formats.pgzf._spec_chain``
    without ``out_cap``.  The padding lanes are dropped.
    """
    lanes = np.asarray(words).view(np.uint32)[0].T[:n_members]

    def tensor(a):
        return torch.from_numpy(np.array(a)).to(device, torch.int32)

    return {"words": tensor(lanes.view(np.int32)),
            "lit_t": tensor(np.asarray(lit_t, np.int32)),
            "dist_t": tensor(np.asarray(dist_t, np.int32)),
            "starts": tensor(np.asarray(starts_g, np.int32)[:n_members])}


def from_reference_options(options):
    """The reference's ``EncodeOptions`` -> the port's, field by field
    (None stays None)."""
    if options is None:
        return None
    from .serial.deflate import EncodeOptions
    return EncodeOptions(**{f.name: getattr(options, f.name)
                            for f in dataclasses.fields(EncodeOptions)})


#: encode intermediates by name -> the dtype the port's stages take
_BATCH_DTYPES = {"blocks": torch.uint8, "n_valid": torch.int32,
                 "cand": torch.int32, "m": torch.int32,
                 "lengths": torch.int32, "a": torch.int32,
                 "b": torch.int32, "valid": torch.bool,
                 "n_tokens": torch.int32}


def from_reference_batch(arrays: dict, device="cpu") -> dict:
    """Reference encode intermediates -> port tensors on ``device``.

    Takes any of ``blocks`` (B, n), ``n_valid`` (B,), the matcher's
    ``cand`` and ``m``, ``lengths``, the padded tokens ``a``, ``b`` and
    ``valid`` (B, M), the token counts ``n_tokens`` (B,), and the tables
    ``lit_rev``, ``lit_w``, ``dist_rev``, ``dist_w``: shared (286 or 288
    and 30 entries) or one row a member ((B, 286 or 288) and (B, 30), as
    ``token_fields_pallas`` takes them); the tables become the one
    ``tables`` operand of ``ops/fields.token_fields``, (N_TABLE,) or
    (B, N_TABLE).
    """
    from .ops.fields import field_tables
    out = {k: torch.from_numpy(np.array(v)).to(device, _BATCH_DTYPES[k])
           for k, v in arrays.items() if k in _BATCH_DTYPES}
    names = ("lit_rev", "lit_w", "dist_rev", "dist_w")
    if all(k in arrays for k in names):
        out["tables"] = field_tables(*(np.asarray(arrays[k]) for k in names),
                                     device)
    return out
