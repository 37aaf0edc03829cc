"""Engine registry: which engine does the raw DEFLATE byte work for the
containers (counterpart of ``libflate_tpu/backend.py`` and of the "tpu"
engine's registration, ``libflate_tpu/ops/pipeline.py:891-918``).

An engine is a set of functions with one contract: ``deflate(data,
options)`` -> raw DEFLATE bytes, ``inflate(data)`` -> an
``InflateResult`` (``data``, ``end_bit``), ``crc32(data, crc=0)`` and
``adler32(data, adler=1)`` -> int.  Four are registered, in this order:

* ``cuda`` (the default): the generic device engine on the card,
  ``ops/pipeline.deflate_device`` and ``ops/deflate_decode.inflate_device``,
  the checksums on the card with host combines;
* ``cpu``: the same functions on CPU tensors (every kernel's plain
  version, the glue branches);
* ``serial``: the host codec in plain Python and numpy
  (``serial/deflate.py``, ``utils/checksum.py``), the reference's
  ``serial`` engine;
* ``native``: the threaded C++ host codec (``native/engine.py``, the
  library of ``native/libflate_native.cpp``), the reference's ``native``
  engine; available where a C++ compiler is on ``PATH`` or the library
  is built.

``get(None)`` and ``get("auto")`` are ``cuda``, which raises
RuntimeError where CUDA is not available.  This departs from the
reference, whose ``get(None)`` prefers ``native`` and then ``serial``:
the port's entry points run on the card unless the caller asks for the
host, so ``native`` and ``serial`` run only when they are named.
``engine="native"`` gives the reference's default bytes; the default
gives the reference's ``engine="tpu"`` bytes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional


@dataclass
class Engine:
    name: str
    #: (data, EncodeOptions) -> compressed bytes (raw DEFLATE stream)
    deflate: Callable
    #: (data) -> InflateResult (with .data and .end_bit)
    inflate: Callable
    crc32: Callable
    adler32: Callable
    available: Callable[[], bool] = lambda: True


_engines: dict[str, Engine] = {}
_default: Optional[str] = None


def register(engine: Engine) -> None:
    """Add ``engine``; the first one registered is the default."""
    _engines[engine.name] = engine
    global _default
    if _default is None:
        _default = engine.name


def get(name: str | None = None) -> Engine:
    """The engine ``name``; None or "auto": the default (``cuda``).
    KeyError for an unknown name, RuntimeError for an engine that is not
    available here."""
    if name in (None, "auto"):
        name = _default
    e = _engines.get(name)
    if e is None:
        raise KeyError(f"no such backend engine: {name!r} "
                       f"(registered: {sorted(_engines)})")
    if not e.available():
        raise RuntimeError(f"backend engine {name!r} is not available")
    return e


def names() -> list[str]:
    return sorted(_engines)


def device_engine(device: str) -> Engine:
    """The generic device engine on ``device`` ("cuda" or "cpu")."""
    import numpy as np
    import torch

    from .ops.checksum import adler32_device, crc32_device
    from .ops.deflate_decode import inflate_device
    from .ops.pipeline import deflate_device
    from .utils import checksum as ck

    def tensor(data):
        if device == "cuda":
            from . import require_cuda
            require_cuda()
        return torch.from_numpy(np.frombuffer(bytes(data), np.uint8).copy()
                                ).to(device)

    def crc32(data, crc=0):
        v = crc32_device(tensor(data))
        return ck.crc32_combine(crc, v, len(data)) if crc else v

    def adler32(data, adler=1):
        v = adler32_device(tensor(data))
        return ck.adler32_combine(adler, v, len(data)) if adler != 1 else v

    return Engine(
        name=device,
        deflate=lambda data, opts=None: deflate_device(bytes(data), opts,
                                                       device=device),
        inflate=lambda data: inflate_device(bytes(data), device=device),
        crc32=crc32,
        adler32=adler32,
        available=(lambda: torch.cuda.is_available()) if device == "cuda"
        else (lambda: True),
    )


register(device_engine("cuda"))
register(device_engine("cpu"))


def serial_engine() -> Engine:
    """The host codec: ``serial/deflate.py`` and the table-driven
    checksums of ``utils/checksum.py``."""
    from .serial import deflate as sd
    from .utils import checksum as ck

    return Engine(
        name="serial",
        deflate=lambda data, opts=None: sd.deflate(bytes(data), opts),
        inflate=lambda data: sd.inflate(bytes(data)),
        crc32=lambda data, crc=0: ck.crc32(bytes(data), crc),
        adler32=lambda data, adler=1: ck.adler32(bytes(data), adler),
    )


register(serial_engine())


from .native.engine import native_engine  # noqa: E402 - needs Engine

register(native_engine())
