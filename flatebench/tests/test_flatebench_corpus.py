"""The titles generator: deterministic by seed, exact sizes, the recipe's
word statistics."""
import json

import numpy as np

from flatebench import harness
from flatebench.corpora import titles

PARAMS = harness.load_json(
    harness.ROOT / "flatebench/configs/titles-pgzf64k.json")["corpus"]


def test_the_text_is_fixed_by_the_configuration():
    a = titles.make(PARAMS, 3, 50_000)
    assert a == titles.make(PARAMS, 3, 50_000, threads=1)
    assert a != titles.make(dict(PARAMS, text_seed=1), 3, 50_000)
    assert len({bytes(s) for s in a}) == 3


def test_the_seed_rotates_the_pieces():
    a = harness.piece_order(2**31 + 3, 32)
    assert a == harness.piece_order(2**31 + 3, 32)
    assert a == list(range(a[0], 32)) + list(range(a[0]))
    assert len({tuple(harness.piece_order(s, 32)) for s in range(6)}) > 1
    assert sorted(harness.piece_order(2**40 + 9, 32)) == list(range(32))


def test_sizes_are_exact():
    for n in (1, 1000, 1 << 20):
        shards = titles.make(PARAMS, 2, n)
        assert [len(s) for s in shards] == [n, n]


def test_residue_probabilities_match_hurwitz_zeta():
    from scipy.special import zeta
    n, s = 60000, 1.3
    r = np.arange(n, dtype=np.float64)
    want = np.where(r == 0, zeta(s, 1.0), zeta(s, np.maximum(r, 1) / n))
    want /= want.sum()
    got = titles.residue_probs(n, s)
    assert np.allclose(got, want, rtol=1e-6)
    assert abs(got.sum() - 1) < 1e-12


def test_alias_table_draws_the_distribution():
    p = titles.residue_probs(100, 1.3)
    prob, alias = titles.alias_table(p)
    rng = np.random.default_rng(0)
    k = rng.integers(0, 100, 2_000_000)
    draws = np.where(rng.random(len(k)) < prob[k], k, alias[k])
    freq = np.bincount(draws, minlength=100) / len(draws)
    assert np.abs(freq - p).max() < 2e-3


def test_words_follow_the_recipe():
    gen = titles.Titles(PARAMS)
    ids = gen.ids(np.random.default_rng(11), 400_000)
    words = ids // 2
    probs = titles.residue_probs(PARAMS["vocab"], PARAMS["zipf_s"])
    freq = np.bincount(words, minlength=PARAMS["vocab"]) / len(words)
    assert np.abs(freq[:10] - probs[:10]).max() < 3e-3
    assert abs(freq[1] - 0.2543) < 3e-3             # 1 / zeta(1.3)
    # half the titles are pairs: a third of the words end in "_"
    assert abs((ids % 2).mean() - 1 / 3) < 3e-3
    lens = gen.vlen[::2] - 1
    assert lens.min() == 3 and lens.max() == 11
    text = gen.text(ids[:5000]).tobytes()
    assert text == b"".join(
        gen.table[gen.vstart[i]:gen.vstart[i] + gen.vlen[i]].tobytes()
        for i in ids[:5000])
    assert set(text) <= set(PARAMS["alphabet"].encode()) | {ord("\n")}
    assert text.count(b"\n") == 5000 - (ids[:5000] % 2).sum()


def test_configs_agree_on_the_corpus():
    a = harness.load_json(harness.ROOT / "flatebench/configs/titles-bgzf.json")
    b = harness.load_json(
        harness.ROOT / "flatebench/configs/titles-pgzf64k.json")
    assert json.dumps(a["corpus"]) == json.dumps(b["corpus"])
    assert a["corpus_bytes"] == b["corpus_bytes"] == 32 * 8 * 2**20
    assert a["corpus_bytes"] % a["corpus"]["piece_bytes"] == 0
    # a piece is one encode batch of 128 members, so a rotation keeps
    # every batch of the write
    assert b["corpus"]["piece_bytes"] == 128 * b["member_size"]
