"""Comparison of a decode's outputs with the reference's member
plaintexts."""
from __future__ import annotations

import numpy as np


def rows_wrong(rows: np.ndarray, lengths: np.ndarray, want) -> int:
    """Members whose row is missing or extra, whose length differs, whose
    first ``length`` bytes differ from the plaintext, or whose row is not
    zero past it.  ``rows`` is (n, cap) uint8, ``lengths`` (n,)."""
    wrong = abs(len(rows) - len(want)) + (len(lengths) != len(rows))
    for i in range(min(len(rows), len(lengths), len(want))):
        w = np.frombuffer(want[i], np.uint8)
        n = int(lengths[i])
        wrong += not (n == len(w) and n <= rows.shape[1]
                      and np.array_equal(rows[i, :n], w)
                      and not rows[i, n:].any())
    return wrong


def bytes_wrong(out: bytes, want) -> int:
    """Members whose slice of the returned plaintext differs from theirs,
    one more when the lengths differ."""
    wrong, pos = int(len(out) != sum(len(w) for w in want)), 0
    for w in want:
        wrong += out[pos:pos + len(w)] != w
        pos += len(w)
    return wrong
