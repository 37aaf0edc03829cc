"""Read a shard into device memory: the program's decoder (the traffic's
``entry``, called as ``entry(stream, verify=True, device=...)``), which
returns a (members, cap) uint8 row tensor and the (members,) lengths on
the device.  The check copies each kept call's rows to the host and holds
every member's row and length to the plaintexts that the reference of the
configuration's container reads from the same stream, which must join to
the shard the benchmark made."""
from __future__ import annotations

import numpy as np


def call(ctx, k: int):
    return ctx.entry()(ctx.streams[k], verify=True, device=ctx.device)


def keep(ctx, out):
    rows, lengths = out
    return rows.cpu().numpy(), lengths.cpu().numpy()


def stream_bytes(ctx, k: int, out) -> int:
    """The compressed bytes the call read."""
    return len(ctx.streams[k])


def check(ctx, kept) -> dict:
    from flatebench.reference import compare
    want, bad = ctx.expected_members()
    wrong = sum(compare.rows_wrong(rows, lens, want[k])
                for _i, k, (rows, lens) in kept)
    return {"inputs_wrong": bad, "members_wrong": wrong}


def _last_byte_dropped(ctx, k: int):
    """The reference's decode of the stream into device rows, with the last
    byte of the last non-empty member left out."""
    import torch
    want = ctx.reference().plaintexts(ctx.streams[k])
    last = max(i for i, w in enumerate(want) if w)
    want[last] = want[last][:-1]
    cap = 1 << max(10, (max(len(w) for w in want) - 1).bit_length())
    rows = np.zeros((len(want), cap), np.uint8)
    for i, w in enumerate(want):
        rows[i, :len(w)] = np.frombuffer(w, np.uint8)
    lens = np.array([len(w) for w in want], np.int32)
    return (torch.from_numpy(rows).to(ctx.device),
            torch.from_numpy(lens).to(ctx.device))


#: the plain reference in the program's place, each breaking one guarantee
CONTROLS = {"last_byte_dropped": _last_byte_dropped}
