"""Raw DEFLATE one-shots on an engine (counterpart of
``libflate_tpu/formats/deflate.py:19-38``, ``compress`` and
``decompress``).  ``engine`` names an engine of :mod:`..backend`:
"cuda" (the default) or "cpu".
"""
from __future__ import annotations

from .. import backend as _backend
from ..serial.deflate import DeflateError, EncodeOptions, InflateResult

__all__ = ["DeflateError", "EncodeOptions", "InflateResult", "compress",
           "decompress"]


def compress(data: bytes, options: EncodeOptions | None = None,
             engine: str | None = None) -> bytes:
    """One-shot raw DEFLATE compression."""
    return bytes(_backend.get(engine).deflate(data, options))


def decompress(data: bytes, engine: str | None = None) -> bytes:
    """One-shot raw DEFLATE decompression."""
    return bytes(_backend.get(engine).inflate(data).data)
