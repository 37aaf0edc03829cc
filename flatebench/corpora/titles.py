"""Synthetic enwiki titles, one per line (the recipe of the repository's
``bench.make_corpus``, vectorised).

The vocabulary is ``vocab`` words of ``word_len_min``..``word_len_max``
characters drawn from ``alphabet``, made from the configuration's
``vocab_seed``.  A title is a word drawn by Zipf(``zipf_s``) rank modulo
the vocabulary size; with probability ``pair_share`` it is joined to the
next drawn word by ``_``.  Titles end in a newline.  The text is made as
pieces of ``piece_bytes``, each its own stream of titles drawn from the
configuration's ``text_seed``, cut at its size.

The corpus is one fixed text, as the upstream benchmark's file is: a
run's seed only rotates the pieces (the harness's business), which keeps
every 8 MiB encode batch of 128 members, and so the work, the same.  Text
drawn from the run's seed changed the work: whether any of a text's 32
encode batches overflows its parse budget and is encoded twice, which
moved the write's peak device memory between 451 and 596 MiB by seed.
How ``text_seed`` was chosen: ``flatebench/text_survey.py``.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

_BLOCK_TITLES = 1 << 20


def residue_probs(n: int, s: float, terms: int = 64) -> np.ndarray:
    """P(k mod n == r) for k ~ Zipf(s) on 1, 2, ...: the sum over the class
    {r, r + n, ...} (r = 0 takes n, 2n, ...), its first ``terms`` members
    summed and the rest by the midpoint integral."""
    base = np.arange(n, dtype=np.float64)
    base[0] = n
    tot = np.zeros(n)
    for j in range(terms):
        tot += (base + n * j) ** -s
    tot += (base + n * (terms - 0.5)) ** (1.0 - s) / (n * (s - 1.0))
    return tot / tot.sum()


def alias_table(p: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Walker's alias table (Vose's construction) of the distribution p."""
    n = len(p)
    scaled = p * n
    prob = np.ones(n)
    alias = np.arange(n)
    small = [i for i in range(n) if scaled[i] < 1.0]
    large = [i for i in range(n) if scaled[i] >= 1.0]
    while small and large:
        s, g = small.pop(), large.pop()
        prob[s], alias[s] = scaled[s], g
        scaled[g] -= 1.0 - scaled[s]
        (small if scaled[g] < 1.0 else large).append(g)
    return prob, alias


class Titles:
    """The generator of one configuration's corpus parameters."""

    def __init__(self, params: dict):
        vrng = np.random.default_rng(params["vocab_seed"])
        alphabet = np.frombuffer(params["alphabet"].encode(), np.uint8)
        n = params["vocab"]
        lens = vrng.integers(params["word_len_min"],
                             params["word_len_max"] + 1, n)
        letters = vrng.choice(alphabet, int(lens.sum()))
        # two variants a word: word + "\n" (ids 2w) and word + "_" (2w + 1)
        self.vlen = np.repeat(lens + 1, 2).astype(np.int32)
        self.vstart = (np.cumsum(self.vlen) - self.vlen).astype(np.int32)
        table = np.empty(int(self.vlen.sum()), np.uint8)
        wstart = np.cumsum(lens) - lens
        for sep, v in ((ord("\n"), 0), (ord("_"), 1)):
            dst = self.vstart[v::2]
            idx = np.repeat(dst - wstart, lens) + np.arange(int(lens.sum()))
            table[idx] = letters
            table[dst + lens] = sep
        self.table = table
        probs = residue_probs(n, params["zipf_s"])
        self.prob, self.alias = alias_table(probs)
        self.pair_share = params["pair_share"]
        self.mean_title = float((probs * (lens + 1)).sum()
                                * (1 + self.pair_share))

    def ids(self, rng: np.random.Generator, n_titles: int) -> np.ndarray:
        """The variant ids of ``n_titles`` titles: word w followed by a
        newline is 2w, by "_" (the first word of a pair) 2w + 1."""
        pair = rng.random(n_titles) < self.pair_share
        per = 1 + pair.astype(np.int64)
        n_words = int(per.sum())
        k = rng.integers(0, len(self.prob), n_words)
        words = np.where(rng.random(n_words) < self.prob[k], k,
                         self.alias[k])
        first = np.cumsum(per) - per
        ids = 2 * words
        ids[first[pair]] += 1
        return ids

    def text(self, ids: np.ndarray) -> np.ndarray:
        """The bytes of the variants ``ids``, one after another."""
        lens = self.vlen[ids]
        offs = np.cumsum(lens, dtype=np.int32) - lens
        src = np.repeat(self.vstart[ids] - offs, lens)
        src += np.arange(len(src), dtype=np.int32)
        return self.table[src]

    def shard(self, rng: np.random.Generator, n_bytes: int) -> bytes:
        """``n_bytes`` of titles from ``rng``."""
        parts, have = [], 0
        while have < n_bytes:
            want = min(_BLOCK_TITLES,
                       int((n_bytes - have) / self.mean_title * 1.02) + 64)
            b = self.text(self.ids(rng, want))
            parts.append(b)
            have += len(b)
        return np.concatenate(parts)[:n_bytes].tobytes()


def make(params: dict, n_pieces: int, piece_bytes: int, threads: int = 8):
    """``n_pieces`` pieces of ``piece_bytes``, each from its own stream of
    ``text_seed`` (the same bytes whatever ``threads``)."""
    gen = Titles(params)
    streams = np.random.SeedSequence(params["text_seed"]).spawn(n_pieces)
    with ThreadPoolExecutor(max(1, min(threads, n_pieces))) as ex:
        return list(ex.map(
            lambda s: gen.shard(np.random.default_rng(s), piece_bytes),
            streams))
