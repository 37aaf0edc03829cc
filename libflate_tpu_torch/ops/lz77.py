"""The generic engine's LZ77 tokenizer, batched over blocks (counterpart
of ``libflate_tpu/ops/lz77.py``: ``prefix_candidates`` (``:43``),
``match_lengths`` (``:82``), ``greedy_parse_marks`` (``:172``),
``tokenize_block`` and ``tokenize_block_from_cand`` (``:252-316``)).

Every function takes (B, n) rows, one block a row, and gives each row
what the reference gives that block alone:

1. candidates: the previous position with the same 3-byte key, from a
   stable sort of the 24-bit keys (positions without a full key get
   unique sentinel keys), masked to the window;
2. match lengths: the common prefix with the candidate, grown 4 bytes a
   round, capped at ``min(258, n - p)``.  Three rounds on every position,
   then the survivors only (the reference's sparse rounds; it bounds
   them at ``max(256, n // 8)`` and finishes the rest densely, the same
   lengths), ``max_rounds - 3`` more or, without ``max_rounds``, until
   none extends;
3. greedy parse: ``p += len[p] if len[p] >= 3 else 1`` from 0, by the
   port's parse kernels (``ops/parse``: chunk exits, then each 512-chunk
   walked from its entry, ``cap = 512`` so that no chunk overflows),
   whose emitted positions are the reference's token starts;
4. tokens: the dist-1 run-length rule, the ``n_valid`` clamps, and the
   tokens compacted to a prefix of ``max_tokens = n + 1`` slots.

Glue in torch ops, apart from the parse kernels.
"""
from __future__ import annotations

import torch

from ..spec import constants as C
from .parse import CHUNK, chunk_exits, parse_tokens, walk_emit


def prefix_candidates(data: torch.Tensor, window: int = C.MAX_DISTANCE
                      ) -> torch.Tensor:
    """(B, n) uint8 -> (B, n) int32: the previous position with an equal
    3-byte key within ``window``, else -1."""
    bsz, n = data.shape
    dev = data.device
    d = torch.nn.functional.pad(data.to(torch.int64), (0, 2))
    key = (d[:, :-2] << 16) | (d[:, 1:-1] << 8) | d[:, 2:]
    idx = torch.arange(n, dtype=torch.int64, device=dev)[None, :]
    key = torch.where(idx >= n - 2, (1 << 24) + idx, key)
    key_sorted, order = torch.sort(key, dim=1, stable=True)
    prev_sorted = torch.nn.functional.pad(order[:, :-1], (1, 0), value=-1)
    same = torch.zeros_like(key_sorted, dtype=torch.bool)
    same[:, 1:] = key_sorted[:, 1:] == key_sorted[:, :-1]
    cand = torch.empty_like(order).scatter_(
        1, order, torch.where(same, prev_sorted, -1))
    cand = torch.where((cand >= 0) & (idx - cand <= window), cand, -1)
    return cand.to(torch.int32)


def _words4(data: torch.Tensor) -> torch.Tensor:
    """(B, n) uint8 -> (B * n,) int64 little-endian 4-byte words at each
    position of the flattened rows; bytes past a row's end read 0."""
    d = torch.nn.functional.pad(data.to(torch.int64), (0, 3))
    return (d[:, :-3] | (d[:, 1:-2] << 8) | (d[:, 2:-1] << 16)
            | (d[:, 3:] << 24)).reshape(-1)


def _extend(w4, ln, active, pos, cnd, lim):
    """One 4-byte round on flat positions: the equal leading bytes of
    the words at ``cnd + ln`` and ``pos + ln`` (inside the row while the
    lane is active; an idle lane's read is clamped and unused)."""
    last = w4.shape[0] - 1
    x = w4[(cnd + ln).clamp(max=last)] ^ w4[(pos + ln).clamp(max=last)]
    full = x == 0
    tz = torch.where(full, 4, torch.where(
        (x & 0xFF) != 0, 0, torch.where(
            (x & 0xFFFF) != 0, 1, torch.where((x & 0xFFFFFF) != 0, 2, 3))))
    ln = torch.minimum(ln + torch.where(active, tz, 0), lim)
    return ln, active & full & (ln < lim)


def match_lengths(data: torch.Tensor, cand: torch.Tensor,
                  max_match: int = C.MAX_MATCH,
                  max_rounds: int | None = None) -> torch.Tensor:
    """(B, n) common-prefix lengths with the candidates, 0 where
    ``cand < 0``, capped at ``min(max_match, n - p)`` and at
    ``max(3, max_rounds)`` rounds of 4 bytes (exact without
    ``max_rounds``)."""
    bsz, n = data.shape
    dev = data.device
    w4 = _words4(data)
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    base = (torch.arange(bsz, dtype=torch.int64, device=dev) * n)[:, None]
    pos = (base + idx[None, :]).reshape(-1)
    c64 = cand.to(torch.int64).reshape(-1)
    cnd = torch.where(c64 >= 0, c64, 0) + (pos - idx.repeat(bsz))
    lim = torch.clamp(n - idx, max=max_match).repeat(bsz)
    ln = torch.zeros_like(pos)
    active = c64 >= 0
    for _ in range(3):
        ln, active = _extend(w4, ln, active, pos, cnd, lim)
    rounds = 64 if max_rounds is None else max(0, max_rounds - 3)
    sur = torch.nonzero(active).reshape(-1)
    if rounds and sur.numel():
        s_ln, s_act = ln[sur], active[sur]
        s_pos, s_cnd, s_lim = pos[sur], cnd[sur], lim[sur]
        for _ in range(rounds):
            s_ln, s_act = _extend(w4, s_ln, s_act, s_pos, s_cnd, s_lim)
            if not bool(s_act.any()):
                break
        ln[sur] = s_ln
    return torch.where(c64 >= 0, ln, 0).view(bsz, n).to(torch.int32)


def _padded(x: torch.Tensor) -> torch.Tensor:
    """(B, n) -> (B, n rounded up to 512), zero-padded."""
    return torch.nn.functional.pad(x, (0, (-x.shape[1]) % CHUNK))


def greedy_parse_marks(lengths: torch.Tensor,
                       min_match: int = C.MIN_MATCH) -> torch.Tensor:
    """(B, n) match lengths (at most 258) -> (B, n) bool token starts of
    the greedy walk ``p += len[p] if len[p] >= min_match else 1``."""
    bsz, n = lengths.shape
    ln = _padded(lengths.to(torch.int32))
    n_pad = ln.shape[1]
    idx = torch.arange(n_pad, dtype=torch.int32, device=ln.device)[None, :]
    jump = torch.clamp(idx + torch.where(ln >= min_match, ln, 1),
                       max=n_pad).to(torch.int32).contiguous()
    tok = idx.expand(bsz, n_pad).contiguous()
    out, _ovf = walk_emit(jump, tok, chunk_exits(jump), CHUNK)
    marks = torch.zeros((bsz, n_pad + 1), dtype=torch.bool,
                        device=ln.device)
    marks.scatter_(1, torch.where(out >= 0, out, n_pad).to(torch.int64),
                   True)
    return marks[:, :n]


def _rle_lengths(data, idx, cand, lengths, max_match):
    """Dist-1 matches are exact by arithmetic: LCP(p, p - 1) = run end -
    p, whatever the round cap."""
    neq = torch.ones_like(data, dtype=torch.bool)
    neq[:, :-1] = data[:, 1:] != data[:, :-1]
    n = data.shape[1]
    first_neq = torch.flip(torch.cummin(torch.flip(
        torch.where(neq, idx, n), [1]), dim=1).values, [1])
    rle_len = (first_neq + 1 - idx).clamp(0, max_match)
    prev_eq = torch.zeros_like(neq)
    prev_eq[:, 1:] = ~neq[:, :-1]
    is_rle = (cand == idx - 1) & prev_eq
    return torch.where(is_rle, torch.maximum(lengths, rle_len), lengths)


def compact_tokens(a, b, valid, max_tokens: int):
    """Padded token slots (holes: ``valid`` False) -> (a, b) (B,
    max_tokens) int32 with each row's tokens in a prefix, zeros after,
    and the (B,) int32 counts."""
    bsz = a.shape[0]
    rank = torch.cumsum(valid.to(torch.int64), dim=1) - 1
    slot = torch.where(valid, rank, max_tokens)
    out_a = torch.zeros((bsz, max_tokens + 1), dtype=torch.int32,
                        device=a.device)
    out_b = torch.zeros_like(out_a)
    out_a.scatter_(1, slot, a.to(torch.int32))
    out_b.scatter_(1, slot, b.to(torch.int32))
    return (out_a[:, :max_tokens], out_b[:, :max_tokens],
            valid.sum(dim=1, dtype=torch.int32))


def token_lengths(data: torch.Tensor, n_valid: torch.Tensor,
                  cand: torch.Tensor, max_match: int = C.MAX_MATCH,
                  max_rounds: int | None = None):
    """The parse's inputs: (cand, lengths), (B, n) int32, the candidates
    masked to ``n_valid`` and their match lengths after the dist-1 rule
    and the clamps (0 below 3)."""
    n = data.shape[1]
    idx = torch.arange(n, dtype=torch.int32, device=data.device)[None, :]
    nv = n_valid.to(torch.int32)[:, None]
    cand = torch.where(idx < nv, cand.to(torch.int32), -1)
    lengths = match_lengths(data, cand, max_match, max_rounds)
    lengths = _rle_lengths(data, idx, cand, lengths, max_match)
    lengths = torch.minimum(lengths, (nv - idx).clamp(min=0))
    return cand, torch.where(lengths >= C.MIN_MATCH, lengths, 0).to(
        torch.int32)


def tokenize_block_from_cand(data: torch.Tensor, n_valid: torch.Tensor,
                             max_tokens: int, cand: torch.Tensor,
                             max_match: int = C.MAX_MATCH,
                             max_rounds: int | None = None):
    """The tokenizer after the candidates: (a, b, n_tokens), a and b
    (B, max_tokens) int32 (a literal byte, or a length with b its
    distance), n_tokens (B,) int32.  ``data`` is zero-padded past each
    row's ``n_valid``."""
    cand, lengths = token_lengths(data, n_valid, cand, max_match,
                                  max_rounds)
    a, b, valid, _cnt, _ovf = parse_tokens(
        _padded(data), n_valid, _padded(cand), _padded(lengths), CHUNK)
    return compact_tokens(a, b, valid, max_tokens)


def tokenize_block(data: torch.Tensor, n_valid: torch.Tensor,
                   max_tokens: int, window: int = C.MAX_DISTANCE,
                   max_match: int = C.MAX_MATCH):
    """The whole tokenizer on sort candidates (exact lengths)."""
    return tokenize_block_from_cand(data, n_valid, max_tokens,
                                    prefix_candidates(data, window),
                                    max_match)
