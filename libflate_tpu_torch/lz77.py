"""Public LZ77 API (the port's copy of ``libflate_tpu/lz77.py``): the
enum-style ``Code`` view of the serial tokens, the compression levels,
the encoders ``DefaultLz77Encoder`` (``DefaultLz77EncoderBuilder``
configures one) and ``NoCompressionLz77Encoder``, ``Lz77Decoder``, and
the one-shots ``encode`` / ``decode``, as libflate's ``libflate_lz77``
crate offers them.  The tokens are ``serial/lz77.py``'s.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass

from .serial.lz77 import (chain_tokens, expand_tokens, greedy_tokens,
                          literal_tokens)
from .spec.constants import (MAX_DISTANCE, MAX_MATCH, MIN_MATCH,
                             WINDOW_SIZE as MAX_WINDOW_SIZE)

MAX_LENGTH = MAX_MATCH


class CompressionLevel(enum.Enum):
    """libflate: libflate_lz77/src/lib.rs:46-58."""
    NONE = "none"
    FAST = "fast"
    BALANCE = "balance"
    BEST = "best"

    def matcher(self) -> str:
        return {"none": "none", "fast": "greedy",
                "balance": "greedy", "best": "chain"}[self.value]


@dataclass(frozen=True)
class Code:
    """Literal or back-pointer (libflate: lib.rs:28-42 Code enum)."""
    length: int
    backward_distance: int = 0

    @classmethod
    def literal(cls, byte: int) -> "Code":
        return cls(byte, 0)

    @classmethod
    def pointer(cls, length: int, distance: int) -> "Code":
        if not (MIN_MATCH <= length <= MAX_LENGTH):
            raise ValueError(f"pointer length {length} out of range")
        if not (1 <= distance <= MAX_DISTANCE):
            raise ValueError(f"pointer distance {distance} out of range")
        return cls(length, distance)

    @property
    def is_literal(self) -> bool:
        return self.backward_distance == 0


class Lz77Encode:
    """Encoder protocol (libflate: trait Lz77Encode lib.rs:83-107).

    Implementations buffer input via :meth:`encode` and emit Code lists
    from :meth:`flush`."""

    def encode(self, data: bytes, sink: list) -> None:
        raise NotImplementedError

    def flush(self, sink: list) -> None:
        raise NotImplementedError

    def compression_level(self) -> CompressionLevel:
        raise NotImplementedError

    def window_size(self) -> int:
        return MAX_WINDOW_SIZE


class DefaultLz77Encoder(Lz77Encode):
    """Buffering greedy/chain encoder (libflate: DefaultLz77Encoder,
    libflate_lz77/src/default.rs — incl. the flush cadence at
    window_size*8 buffered bytes)."""

    def __init__(self, window_size: int = MAX_WINDOW_SIZE,
                 max_length: int = MAX_LENGTH,
                 level: CompressionLevel = CompressionLevel.BALANCE) -> None:
        self._window = window_size
        self._max_length = max_length
        self._level = level
        self._buf = bytearray()

    def encode(self, data: bytes, sink: list) -> None:
        self._buf += data
        if len(self._buf) >= self._window * 8:
            self.flush(sink)

    def flush(self, sink: list) -> None:
        data = bytes(self._buf)
        self._buf.clear()
        if not data:
            return
        if self._level.matcher() == "chain":
            toks = chain_tokens(data, self._window, self._max_length)
        else:
            toks = greedy_tokens(data, self._window, self._max_length)
        sink.extend(Code(a, b) for a, b in toks)

    def compression_level(self) -> CompressionLevel:
        return self._level

    def window_size(self) -> int:
        return self._window


class DefaultLz77EncoderBuilder:
    """libflate: libflate_lz77/src/default.rs:202-249."""

    def __init__(self) -> None:
        self._window = MAX_WINDOW_SIZE
        self._max_length = MAX_LENGTH
        self._level = CompressionLevel.BALANCE

    def window_size(self, size: int) -> "DefaultLz77EncoderBuilder":
        self._window = min(size, MAX_WINDOW_SIZE)
        return self

    def max_length(self, length: int) -> "DefaultLz77EncoderBuilder":
        self._max_length = min(length, MAX_LENGTH)
        return self

    def level(self, level: CompressionLevel) -> "DefaultLz77EncoderBuilder":
        self._level = level
        return self

    def build(self) -> DefaultLz77Encoder:
        return DefaultLz77Encoder(self._window, self._max_length,
                                  self._level)


class NoCompressionLz77Encoder(Lz77Encode):
    """Literal-only encoder (libflate: lib.rs:111-145); signals the
    DEFLATE layer to use stored blocks via compression_level NONE."""

    def __init__(self) -> None:
        self._buf = bytearray()

    def encode(self, data: bytes, sink: list) -> None:
        sink.extend(Code(b, 0) for b in data)

    def flush(self, sink: list) -> None:
        pass

    def compression_level(self) -> CompressionLevel:
        return CompressionLevel.NONE


class Lz77Decoder:
    """Stateful token expander with a sliding history window
    (libflate: Lz77Decoder lib.rs:148-242)."""

    def __init__(self) -> None:
        self._buffer = bytearray()
        self._offset = 0

    def decode(self, code: Code) -> None:
        if code.is_literal:
            self._buffer.append(code.length)
        else:
            if code.backward_distance > len(self._buffer):
                raise ValueError(
                    f"back-pointer distance {code.backward_distance} "
                    f"exceeds decoded history")
            start = len(self._buffer) - code.backward_distance
            for k in range(code.length):
                self._buffer.append(self._buffer[start + k])
        self._truncate_old()

    def _truncate_old(self) -> None:
        # keep at most 4x window; preserve the last window for matches
        if len(self._buffer) > 4 * MAX_WINDOW_SIZE:
            drop = len(self._buffer) - MAX_WINDOW_SIZE
            drop = min(drop, self._offset)
            if drop:
                del self._buffer[:drop]
                self._offset -= drop

    def read(self, n: int = -1) -> bytes:
        avail = len(self._buffer) - self._offset
        if n < 0 or n > avail:
            n = avail
        out = bytes(self._buffer[self._offset:self._offset + n])
        self._offset += n
        return out

    @property
    def buffer(self) -> bytes:
        return bytes(self._buffer[self._offset:])


def encode(data: bytes, level: CompressionLevel = CompressionLevel.BALANCE,
           window_size: int = MAX_DISTANCE) -> list[Code]:
    """Tokenize ``data`` at the given level."""
    matcher = level.matcher()
    if matcher == "none":
        toks = literal_tokens(data)
    elif matcher == "greedy":
        toks = greedy_tokens(data, window_size)
    else:
        toks = chain_tokens(data, window_size)
    return [Code(a, b) for a, b in toks]


def decode(codes: list[Code]) -> bytes:
    """Expand tokens back to bytes (libflate: Lz77Decoder)."""
    return bytes(expand_tokens([(c.length, c.backward_distance)
                                for c in codes]))
