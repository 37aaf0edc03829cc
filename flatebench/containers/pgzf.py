"""PGZF input streams, written by the program's own encoder
(``libflate_tpu_torch.formats.pgzf.compress``) with the configuration's
member size and encode options."""
from __future__ import annotations


def write_inputs(shards, config: dict, device: str) -> list[bytes]:
    from libflate_tpu_torch.formats import pgzf
    from libflate_tpu_torch.serial.deflate import EncodeOptions

    opts = config.get("encode_options")
    options = EncodeOptions(**opts) if opts else None
    return [pgzf.compress(s, member_size=config["member_size"],
                          options=options, device=device) for s in shards]
