"""Raw DEFLATE: the one-shots on an engine and the streaming
``Encoder`` / ``Decoder`` façades (the port's copy of
``libflate_tpu/formats/deflate.py``).  ``engine`` names an engine of
:mod:`..backend`: "cuda" (the default), "cpu" or "serial".

The façades route as the reference's do, with one translation: the
reference streams through :class:`BlockStreamer` when ``engine`` is None
(its default engines are host engines) and buffers everything for an
explicit engine; the port streams when the engine it resolves is
``serial`` and buffers everything for any other (``cuda``, the default,
and ``cpu``), which encodes the whole input at ``finish()``.
"""
from __future__ import annotations

import io

from .. import backend as _backend
from ..serial.deflate import DeflateError, EncodeOptions, InflateResult
from ..spec.constants import DEFAULT_BLOCK_SIZE, MAX_STORED_BLOCK

__all__ = ["DeflateError", "EncodeOptions", "InflateResult",
           "DEFAULT_BLOCK_SIZE", "compress", "decompress", "BlockStreamer",
           "Encoder", "Decoder"]


def compress(data: bytes, options: EncodeOptions | None = None,
             engine: str | None = None) -> bytes:
    """One-shot raw DEFLATE compression."""
    return bytes(_backend.get(engine).deflate(data, options))


def decompress(data: bytes, engine: str | None = None) -> bytes:
    """One-shot raw DEFLATE decompression."""
    return bytes(_backend.get(engine).inflate(data).data)


def streams(engine: str | None) -> bool:
    """Whether a façade on ``engine`` streams through
    :class:`BlockStreamer`: the engine it resolves is ``serial``."""
    return _backend.get(engine).name == "serial"


class BlockStreamer:
    """Incremental DEFLATE block emitter with O(block_size) memory.

    Buffers at most one block of input; once more than ``block_size``
    bytes are pending, completed blocks are entropy-coded on the host and
    their finished bytes drained at once.  Output is byte-identical to
    the serial engine's one-shot ``deflate()`` for any write chunking,
    because both split input at the same block boundaries and reset
    LZ77 state per block.
    """

    def __init__(self, options: EncodeOptions | None = None) -> None:
        from ..serial.bitio import BitWriter
        self._opts = options or EncodeOptions()
        self._w = BitWriter()
        self._pending = bytearray()

    def feed(self, data: bytes) -> bytes:
        """Absorb input; return whatever compressed bytes completed."""
        from ..serial.deflate import _write_compressed, _write_stored
        self._pending += data
        bs = (MAX_STORED_BLOCK if self._opts.block_type == "stored"
              else self._opts.block_size)
        while len(self._pending) > bs:
            chunk = bytes(self._pending[:bs])
            del self._pending[:bs]
            if self._opts.block_type == "stored":
                _write_stored(self._w, chunk, final=False)
            else:
                _write_compressed(self._w, self._opts.tokenize(chunk),
                                  self._opts.block_type == "dynamic",
                                  final=False)
        return self._w.take_bytes()

    def sync_flush(self) -> bytes:
        """Emit pending input as non-final blocks + the sync marker."""
        from ..serial.deflate import (_write_compressed, _write_stored,
                                      sync_flush_marker)
        chunk = bytes(self._pending)
        self._pending.clear()
        if chunk:
            if self._opts.block_type == "stored":
                _write_stored(self._w, chunk, final=False)
            else:
                _write_compressed(self._w, self._opts.tokenize(chunk),
                                  self._opts.block_type == "dynamic",
                                  final=False)
        sync_flush_marker(self._w)
        return self._w.take_bytes()

    def finish(self) -> bytes:
        """Emit the remainder as the final block; byte-aligns the tail."""
        from ..serial.deflate import _write_compressed, _write_stored
        chunk = bytes(self._pending)
        self._pending.clear()
        if self._opts.block_type == "stored":
            _write_stored(self._w, chunk, final=True)
        else:
            _write_compressed(self._w, self._opts.tokenize(chunk),
                              self._opts.block_type == "dynamic",
                              final=True)
        self._w.align_byte()
        return self._w.take_bytes()


class Encoder:
    """Streaming raw DEFLATE encoder.

    On the ``serial`` engine writes stream through :class:`BlockStreamer`
    (O(block_size) memory; the output equals the serial one-shot
    ``compress()``); on any other engine the input is buffered and handed
    whole to that engine's ``deflate`` at :meth:`finish`.
    """

    def __init__(self, sink=None, options: EncodeOptions | None = None,
                 engine: str | None = None) -> None:
        self._sink = sink if sink is not None else io.BytesIO()
        self._engine = engine
        self._options = options
        if streams(engine):
            self._streamer = BlockStreamer(options)
        else:
            self._streamer = None
            self._buf = bytearray()
        self._finished = False

    def write(self, data: bytes) -> int:
        if self._finished:
            raise ValueError("write after finish")
        if self._streamer is None:
            self._buf += data
        else:
            out = self._streamer.feed(bytes(data))
            if out:
                self._sink.write(out)
        return len(data)

    def finish(self):
        if not self._finished:
            self._finished = True
            if self._streamer is None:
                self._sink.write(compress(bytes(self._buf), self._options,
                                          self._engine))
            else:
                self._sink.write(self._streamer.finish())
        return self._sink

    def getvalue(self) -> bytes:
        self.finish()
        return self._sink.getvalue()


class Decoder:
    """Read-style façade with partial-output salvage.

    The stream is decoded whole on ``engine``.  On a DeflateError or
    EOFError :meth:`read` raises it, and :meth:`unread_decoded_data`
    gives what decoded cleanly before the error: the error's
    ``.partial`` where the engine attached one (``serial`` does), else
    the serial engine's ``.partial`` from a second read of the stream,
    which only recovers those bytes.
    """

    def __init__(self, data: bytes, engine: str | None = None) -> None:
        self._error: Exception | None = None
        try:
            self._result = _backend.get(engine).inflate(bytes(data))
            self._data = bytes(self._result.data)
        except (DeflateError, EOFError) as e:
            self._error = e
            partial = getattr(e, "partial", None)
            if partial is None:
                from ..serial.deflate import inflate as _serial_inflate
                try:
                    _serial_inflate(bytes(data))
                    partial = b""
                except Exception as se:
                    partial = getattr(se, "partial", b"")
            self._data = bytes(partial)
        self._pos = 0

    def read(self, n: int = -1) -> bytes:
        if self._error is not None:
            raise self._error
        if n < 0:
            n = len(self._data) - self._pos
        out = self._data[self._pos:self._pos + n]
        self._pos += len(out)
        return out

    def unread_decoded_data(self) -> bytes:
        return self._data[self._pos:]
