"""Completion protocol (the port's copy of ``libflate_tpu/finish.py``):
``Finish`` (a value with an optional error), ``AutoFinish`` and
``AutoFinishUnchecked`` (encoders finished on leaving a ``with`` block),
as libflate's ``finish`` module offers them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Generic, Optional, TypeVar

T = TypeVar("T")
E = TypeVar("E")


@dataclass
class Finish(Generic[T, E]):
    """Result-with-value: (inner, maybe-error); libflate's ``Finish``."""
    inner: T
    error: Optional[E] = None

    def into_result(self) -> T:
        if self.error is not None:
            raise self.error            # type: ignore[misc]
        return self.inner

    def unwrap(self) -> tuple[T, Optional[E]]:
        return self.inner, self.error

    def as_inner(self) -> T:
        return self.inner

    def map(self, fn) -> "Finish":
        return Finish(fn(self.inner), self.error)


class AutoFinish:
    """Context manager that finishes on exit; raises if finish fails."""

    def __init__(self, encoder: Any) -> None:
        self.inner = encoder

    def __enter__(self) -> Any:
        return self.inner

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.inner.finish()


class AutoFinishUnchecked(AutoFinish):
    """Like AutoFinish but swallows finish-time errors."""

    def __exit__(self, exc_type, exc, tb) -> None:
        try:
            self.inner.finish()
        except Exception:
            pass
