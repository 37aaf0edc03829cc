"""The ``native`` engine of :mod:`..backend` (counterpart of
``libflate_tpu/native/engine.py``): raw DEFLATE through the C library.

Dynamic blocks with the greedy or chain matcher go to
:func:`deflate_greedy` (lazy when the matcher is "chain" or
``options.lazy`` is set, hash chains ``max_chain`` deep for "chain", else
one candidate); every other option goes to the serial engine's
``deflate``.  Inflate, CRC-32 and Adler-32 run in the library.
"""
from __future__ import annotations

from . import adler32, available, crc32, deflate_greedy, inflate


def _deflate(data, opts=None):
    from ..serial.deflate import EncodeOptions
    opts = opts or EncodeOptions()
    if opts.block_type == "dynamic" and opts.matcher in ("greedy", "chain"):
        return deflate_greedy(
            bytes(data), block_size=opts.block_size,
            lazy=opts.matcher == "chain" or bool(opts.lazy),
            max_chain=opts.max_chain if opts.matcher == "chain" else 1)
    from ..serial.deflate import deflate as serial_deflate
    return serial_deflate(bytes(data), opts)


def _inflate(data):
    from ..serial.deflate import InflateResult
    out, end_bit = inflate(bytes(data))
    return InflateResult(bytearray(out), end_bit)


def native_engine():
    """The engine record that :mod:`..backend` registers as ``native``."""
    from ..backend import Engine
    return Engine(
        name="native",
        deflate=_deflate,
        inflate=_inflate,
        crc32=lambda data, crc=0: crc32(bytes(data), crc),
        adler32=lambda data, adler=1: adler32(bytes(data), adler),
        available=available,
    )
