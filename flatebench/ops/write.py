"""Write a shard: the program's encoder (the traffic's ``entry``, called as
``entry(shard, member_size=..., options=..., device=...)``) on the
plaintext the benchmark made.  The check holds every member of each kept
stream to the reference of the configuration's container, the sync index
of ``ls_members`` of them, drawn from the seed, to the token walk, and
the size of the members' bodies to zlib's at level 9 on the same
slices."""
from __future__ import annotations

import numpy as np


def _options(ctx):
    opts = ctx.config.get("encode_options")
    if not opts:
        return None
    from libflate_tpu_torch.serial.deflate import EncodeOptions
    return EncodeOptions(**opts)


def call(ctx, k: int):
    return ctx.entry()(ctx.shards[k], member_size=ctx.config["member_size"],
                       options=_options(ctx), device=ctx.device)


def keep(ctx, out):
    return out


def stream_bytes(ctx, k: int, out) -> int:
    """The compressed bytes the call wrote."""
    return len(out)


def check(ctx, kept) -> dict:
    """``members_wrong`` and ``ls_wrong`` summed over the kept streams;
    ``body_excess``, the largest over them of the members' body bytes
    over zlib's at level 9 on the same slices, less 1."""
    ref = ctx.reference()
    ms, k_tok = ctx.config["member_size"], ctx.config["sync_tokens"]
    rng = np.random.default_rng([ctx.seed % (1 << 63), 2])
    tot = {"members_wrong": 0, "ls_wrong": 0, "body_excess": 0.0}
    best = {}
    for _i, k, stream in kept:
        n = max(1, -(-len(ctx.shards[k]) // ms))
        pick = {0, n - 1} | {int(j) for j in rng.choice(
            n, size=min(n, ctx.traffic["ls_members"]), replace=False)}
        r = ref.check_written(stream, ctx.shards[k], ms, k_tok, sorted(pick))
        for key in ("members_wrong", "ls_wrong"):
            tot[key] += r[key]
        if k not in best:
            best[k] = ref.zlib_body_bytes(ctx.shards[k], ms, level=9)
        tot["body_excess"] = max(tot["body_excess"],
                                 ref.body_bytes(stream) / best[k] - 1.0)
    return tot


def _no_sync_index(ctx, k: int):
    return ctx.reference().write_members(
        ctx.shards[k], ctx.config["member_size"], level=6)


def _stored_members(ctx, k: int):
    return ctx.reference().write_members(
        ctx.shards[k], ctx.config["member_size"], level=0)


def _fixed_code(ctx, k: int):
    from libflate_tpu_torch.serial.deflate import EncodeOptions
    return ctx.entry()(ctx.shards[k], member_size=ctx.config["member_size"],
                       options=EncodeOptions(block_type="fixed"),
                       device=ctx.device)


#: in the program's place, each breaking one guarantee: the reference's
#: zlib members with no LS index; the reference's members as stored
#: blocks; the program's own lower-effort path, every member one block
#: in the fixed Huffman code (no LS index either)
CONTROLS = {"no_sync_index": _no_sync_index,
            "stored_members": _stored_members,
            "fixed_code": _fixed_code}
