"""The port's histogram and token-field kernels (plain versions) vs the
reference.

* ``shared_histograms_pallas`` (Pallas interpret mode, once per module)
  at 128 x 2048 token slots: the batch-global litlen/distance counts,
  END_OF_BLOCK per member and the dummy-distance rule, also with slots
  whose a and b lie outside what the encoder emits.
* The token fields against the reference's XLA twin ``token_fields_xla``
  called as ``_shared_tokens_xla`` calls it (``token_fields_pallas``
  passes no interpret flag, so it cannot run on the CPU), hole slots
  included.
* The per-member form (one table row a member, token counts) against
  ``token_fields_pallas`` itself, its ``pl.pallas_call`` forced into
  interpret mode, at 3 x 2048 slots with each member's own package-merge
  tables; ``field_tables``' range checks and ``convert``'s per-member
  tables.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from libflate_tpu_torch import convert  # noqa: E402
from libflate_tpu_torch.ops import deflate_encode as de  # noqa: E402
from libflate_tpu_torch.ops import fields, hist  # noqa: E402
from libflate_tpu_torch.ops.huffman import package_merge_lengths  # noqa

B, M = 128, 2048


def _tokens(seed: int, matches: bool = True):
    rng = np.random.default_rng(seed)
    valid = rng.random((B, M)) < 0.8
    valid[5] = False                          # an empty (padding) member
    is_m = (rng.random((B, M)) < 0.4) & matches
    a = np.where(is_m, rng.integers(3, 259, (B, M)),
                 rng.integers(0, 256, (B, M)))
    a[:, :3] = [3, 258, 257]                  # length-code corners
    dist = np.where(rng.random((B, M)) < 0.5,
                    rng.integers(1, 33, (B, M)),
                    rng.integers(1, 32769, (B, M)))
    dist[:, :4] = [1, 32768, 4, 5]
    b = np.where(is_m, dist, 0)
    a, b = np.where(valid, a, 0), np.where(valid, b, 0)
    return a.astype(np.int32), b.astype(np.int32), valid


def _out_of_range(seed: int):
    """``_tokens`` plus slots outside the encoder's range: invalid slots
    carrying any a and b, literals in [288, 512) and [-224, 0), and
    negative b (a literal).  Valid matches with any a and b, and
    literals anywhere in int32, are
    ``test_token_hist_clamps_what_the_encoder_never_emits``'s."""
    a, b, valid = _tokens(seed)
    rng = np.random.default_rng(seed)
    junk = rng.random((B, M)) < 0.1
    valid[junk] = False
    a[junk] = rng.integers(-2**31, 2**31 - 1, int(junk.sum()))
    b[junk] = rng.integers(-2**31, 2**31 - 1, int(junk.sum()))
    lit = ~junk & (rng.random((B, M)) < 0.1)
    valid[lit] = True
    a[lit] = rng.choice([288, 300, 511, -1, -100, -224], int(lit.sum()))
    b[lit] = rng.choice([0, -1, -40000], int(lit.sum()))
    return a, b, valid


def _any_int32(seed: int):
    """(128, 2048) slots with a and b anywhere in int32, 30% valid, and
    the corners of the length and distance arithmetic."""
    rng = np.random.default_rng(seed)
    a = rng.integers(-2**31, 2**31, (B, M))
    b = np.where(rng.random((B, M)) < 0.5, 0,
                 rng.integers(-2**31, 2**31, (B, M)))
    a[:, 1::7] = rng.integers(-700, 700, (B, len(range(1, M, 7))))
    b[:, 2::7] = rng.integers(32000, 70000, (B, len(range(2, M, 7))))
    corners = [-2**31, -2**31 + 2, 2**31 - 1, 0, 2, 3, 258, 259, 600,
               511, 512, 1023, 131 + 512]
    a[0, :len(corners)] = corners
    b[0, :len(corners)] = [1, 5, 2**31 - 1, 32769, 40000, 65536, 1, 2,
                           5, 0, 0, 0, 0]
    valid = rng.random((B, M)) < 0.3
    valid[0, :len(corners)] = True
    return a.astype(np.int32), b.astype(np.int32), valid


def _padded(a, b):
    """One member of slots, padded to the reference kernel's 128 lanes
    with empty members."""
    n = len(a)
    out = [np.zeros((B, n), np.int32), np.zeros((B, n), np.int32),
           np.zeros((B, n), bool)]
    out[0][0], out[1][0], out[2][0] = a, b, True
    return tuple(out)


@pytest.fixture(scope="module")
def ref_hist_any():
    """``shared_histograms_pallas`` (interpret mode) on the seven slots
    of the Queue 3 entry and on ``_any_int32`` slots."""
    cases = [_padded([600, 1, -5, 10, 600, -300, 7],
                     [5, 5, 9, 40000, 0, 0, -3]), _any_int32(6)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LIBFLATE_PALLAS_INTERPRET", "1")
        from libflate_tpu.ops.pallas_hist import shared_histograms_pallas
        out = [tuple(map(np.asarray, shared_histograms_pallas(
            *(jnp.asarray(x) for x in case)))) for case in cases]
    return cases, out


@pytest.fixture(scope="module")
def ref_hist():
    cases = [_tokens(1), _tokens(2, matches=False), _out_of_range(4)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LIBFLATE_PALLAS_INTERPRET", "1")
        from libflate_tpu.ops.pallas_hist import shared_histograms_pallas
        out = [tuple(map(np.asarray, shared_histograms_pallas(
            *(jnp.asarray(x) for x in case)))) for case in cases]
    return cases, out


@pytest.mark.parametrize("which", [0, 1, 2])
def test_shared_histograms_match_reference(ref_hist, which):
    cases, out = ref_hist
    t = convert.from_reference_batch(dict(zip("a b valid".split(),
                                              cases[which])))
    lit, dist = hist.shared_histograms(t["a"], t["b"], t["valid"])
    np.testing.assert_array_equal(lit.numpy(), out[which][0])
    np.testing.assert_array_equal(dist.numpy(), out[which][1])
    if which == 1:                            # no match: the dummy code
        assert dist.tolist() == [1] + [0] * 29


def test_token_hist_clamps_what_the_encoder_never_emits(ref_hist_any):
    """Slots the encoder never emits (valid matches with any length and
    distance, literals anywhere in int32) count where the reference's
    packing puts them; the port clamps nothing.  The seven slots: length
    600 -> symbol 283, distance 40000 -> 28, literal 600 -> bin 88 and
    distance bin 0 (600 >> 9 == 1), -5 and -300 in no bin."""
    cases, out = ref_hist_any
    for (a, b, valid), (want_lit, want_dist) in zip(cases, out):
        ta, tb, tv = (torch.from_numpy(x) for x in (a, b, valid))
        lit, dist = hist.shared_histograms(ta, tb, tv)
        np.testing.assert_array_equal(lit.numpy(), want_lit)
        np.testing.assert_array_equal(dist.numpy(), want_dist)
    bins = hist.token_hist(*(torch.from_numpy(x[0]) for x in cases[0]))
    assert bins[283] == 1 and bins[88] == 1 and bins[288 + 28] == 1
    assert bins[288] == 1                       # from the literal 600


def test_symbol_arithmetic_matches_the_tables():
    from libflate_tpu_torch.spec import constants as C
    ln = torch.arange(3, 259)
    np.testing.assert_array_equal(hist.length_symbol(ln).numpy(),
                                  C.LENGTH_TO_CODE[3:])
    d = torch.arange(1, 32769)
    np.testing.assert_array_equal(hist.dist_symbol(d).numpy(),
                                  C.DIST_TO_CODE[1:])
    np.testing.assert_array_equal(fields._dist_code(d).numpy(),
                                  C.DIST_TO_CODE[1:])


def _tables(a, b, valid):
    lit, dist = hist.shared_histograms(a, b, valid)
    lit_rev, lit_w = de.encoder_tables(package_merge_lengths(lit.numpy(), 10))
    dist_rev, dist_w = de.encoder_tables(
        package_merge_lengths(dist.numpy(), 8))
    return lit_rev, lit_w, dist_rev, dist_w


def test_token_fields_match_reference_with_holes():
    from libflate_tpu.ops.pipeline import _shared_tokens_xla
    a, b, valid = _tokens(3)
    tabs = _tables(*(torch.from_numpy(x) for x in (a, b, valid)))
    want = _shared_tokens_xla(jnp.asarray(a), jnp.asarray(b),
                              jnp.asarray(valid),
                              *(jnp.asarray(t) for t in tabs))
    t = convert.from_reference_batch(dict(
        a=a, b=b, valid=valid, lit_rev=tabs[0], lit_w=tabs[1],
        dist_rev=tabs[2], dist_w=tabs[3]))
    tv = t["valid"]
    got = fields.token_fields(torch.where(tv, t["a"], -1), t["b"],
                              t["tables"])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[1][~tv] == 0).all() and (got[3][~tv] == 0).all()
    assert int(got[1].max()) <= 10 + 5 and int(got[3].max()) <= 8 + 13


# ---- the per-member form: per-member tables and token counts --------------

PB, PM = 3, 2048


def _per_member_tokens():
    """Three members of 2048 slots: counts M, below M and 0, holes
    (a = -1) inside and past the counts, matches of every length corner."""
    rng = np.random.default_rng(12)
    is_m = rng.random((PB, PM)) < 0.4
    a = np.where(is_m, rng.integers(3, 259, (PB, PM)),
                 rng.integers(0, 256, (PB, PM)))
    b = np.where(is_m, rng.integers(1, 32769, (PB, PM)), 0)
    a[:, :4], b[:, :4] = [3, 258, 257, 65], [1, 32768, 4, 0]
    a[rng.random((PB, PM)) < 0.05] = -1
    a[1, 1500:1510] = -1                      # holes past the count
    n_tokens = np.array([PM, 1203, 0])
    return a.astype(np.int32), b.astype(np.int32), n_tokens.astype(np.int32)


@pytest.fixture(scope="module")
def ref_per_member():
    """The reference's ``token_fields_pallas`` (Pallas interpret mode) with
    each member's tables built as ``_fields_batch_pallas`` builds them."""
    from jax.experimental import pallas as pl

    import libflate_tpu.ops.pallas_fields as pf
    from libflate_tpu.ops.deflate_encode import (_encoder_tables,
                                                 token_histograms_jax)
    from libflate_tpu.ops.huffman import package_merge_lengths as pm_jax
    a, b, nt = _per_member_tokens()
    lit_f, dist_f = jax.vmap(token_histograms_jax)(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(nt))
    lit_rev, lit_w = jax.vmap(_encoder_tables)(
        jax.vmap(lambda f: pm_jax(f, 15))(lit_f))
    dist_rev, dist_w = jax.vmap(_encoder_tables)(
        jax.vmap(lambda f: pm_jax(f, 15))(dist_f))
    lit_rev288 = jnp.pad(lit_rev, ((0, 0), (0, 2)))
    lit_w288 = jnp.pad(lit_w, ((0, 0), (0, 2)))

    def interpret(*args, **kw):
        return orig(*args, **{**kw, "interpret": True})

    orig = pl.pallas_call
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pf.pl, "pallas_call", interpret)
        want = pf.token_fields_pallas.__wrapped__(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(nt), lit_rev288,
            lit_w288, dist_rev, dist_w)
    tabs = dict(lit_rev=lit_rev, lit_w=lit_w, dist_rev=dist_rev,
                dist_w=dist_w)
    return ((a, b, nt), {k: np.asarray(v) for k, v in tabs.items()},
            [np.asarray(w) for w in want])


def test_token_fields_per_member_match_reference(ref_per_member):
    (a, b, nt), tabs, want = ref_per_member
    assert tabs["lit_rev"].shape == (PB, 286)
    t = convert.from_reference_batch(dict(a=a, b=b, n_tokens=nt, **tabs))
    assert t["tables"].shape == (PB, fields.N_TABLE)
    got = fields.token_fields(t["a"], t["b"], t["tables"], t["n_tokens"])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    # the count and the holes both mask: member 2 is empty, member 1
    # stops at its count
    assert not got[1][2].any() and not got[1][1, 1203:].any()
    assert int((got[1] > 0).sum()) == int(((a >= 0) & (
        np.arange(PM)[None, :] < nt[:, None])).sum())


def test_token_fields_per_member_rows_are_the_shared_form(ref_per_member):
    """Row k of the per-member operand gives member k what the shared
    operand built from member k's tables gives it."""
    (a, b, nt), tabs, _want = ref_per_member
    t = convert.from_reference_batch(dict(a=a, b=b, n_tokens=nt, **tabs))
    got = fields.token_fields(t["a"], t["b"], t["tables"])
    for k in range(PB):
        row = fields.field_tables(*(tabs[n][k] for n in (
            "lit_rev", "lit_w", "dist_rev", "dist_w")), "cpu")
        torch.testing.assert_close(t["tables"][k], row, rtol=0, atol=0)
        shared = fields.token_fields(t["a"][k], t["b"][k], row)
        for g, s in zip(got, shared):
            torch.testing.assert_close(g[k], s, rtol=0, atol=0)


@pytest.mark.parametrize("which,value", [("lit_w", 16), ("dist_w", 99),
                                         ("lit_w", -1), ("lit_rev", 1 << 15),
                                         ("dist_rev", -3)])
def test_field_tables_refuse_codes_outside_deflate(which, value):
    """The kernel's merged entries hold widths <= 15 and codes < 2**15;
    a table outside that is refused before any upload, shared or per
    member."""
    tabs = {"lit_rev": np.zeros((2, 288), np.int32),
            "lit_w": np.full((2, 288), 8, np.int32),
            "dist_rev": np.zeros((2, 30), np.int32),
            "dist_w": np.full((2, 30), 5, np.int32)}
    tabs[which][1, 7] = value
    order = ("lit_rev", "lit_w", "dist_rev", "dist_w")
    with pytest.raises(ValueError):
        fields.field_tables(*(tabs[k] for k in order), "cpu")
    with pytest.raises(ValueError):
        fields.field_tables(*(tabs[k][1] for k in order), "cpu")
    fields.field_tables(*(tabs[k][0] for k in order), "cpu")


def test_token_fields_refuse_mismatched_forms():
    a = torch.zeros((3, 8), dtype=torch.int32)
    shared = fields.field_tables(np.zeros(288), np.ones(288), np.zeros(30),
                                 np.ones(30), "cpu")
    with pytest.raises(ValueError):           # a row a member, 2 rows
        fields.token_fields(a, a, shared[None].expand(2, -1))
    with pytest.raises(ValueError):           # counts of the wrong length
        fields.token_fields(a, a, shared, torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError):           # counts need (B, M) tokens
        fields.token_fields(a[0], a[0], shared,
                            torch.zeros(1, dtype=torch.int32))
