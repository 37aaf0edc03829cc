"""Each cell's operation through the whole harness on the CPU at a small
size, past the look for a card: sound runs come out correct, and the
controls and the faults planted under the timed path come out not
correct."""
import numpy as np
import pytest

from flatebench.reference import pgzf as ref_pgzf

CELLS = ["titles-pgzf64k.write", "titles-pgzf64k.read", "titles-bgzf.read",
         "titles-pgzf64k.read_bytes"]
CONTROLS = [("titles-pgzf64k.write", "no_sync_index", "ls_wrong"),
            ("titles-pgzf64k.write", "stored_members", "body_excess"),
            ("titles-pgzf64k.write", "fixed_code", "ls_wrong"),
            ("titles-pgzf64k.read", "last_byte_dropped", "members_wrong"),
            ("titles-bgzf.read", "last_byte_dropped", "members_wrong"),
            ("titles-pgzf64k.read_bytes", "last_byte_dropped",
             "members_wrong")]


def _compared(res):
    return {k: v["value"] for k, v in res["compared"].items()}


def _over(res):
    """The compared numbers over their limits."""
    return {k for k, v in res["compared"].items() if v["value"] > v["limit"]}


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(small, cell):
    rc, res, err = small(cell)
    assert rc == 0 and res["correct"] is True, err
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert not _over(res)
    exact = {k: v for k, v in _compared(res).items() if k != "body_excess"}
    assert set(exact.values()) == {0}
    if cell.endswith("write"):
        assert 0 < _compared(res)["body_excess"] < 0.6
    assert list(res)[-1] == "compared"
    assert "compared calls_failed 0 limit 0" in err
    want = {"setup_s", "host_cpu_s_per_GB", "plain_GBps"} | (
        {"stream_ratio"} if cell.endswith("write") else set())
    assert set(res["metrics"]) == want


@pytest.mark.parametrize("cell,control,number", CONTROLS,
                         ids=[f"{c}-{k}" for c, k, _ in CONTROLS])
def test_control_is_not_correct(small, cell, control, number):
    rc, res, _err = small(cell, control=control)
    assert rc == 0 and res["correct"] is False
    assert number in _over(res)


def _half_stream(stream):
    ms = ref_pgzf.walk(stream)
    return stream[:ms[len(ms) // 2].start]


def _huffman_only_stream(stream):
    """The same members coded with no matches (zlib's Huffman-only
    strategy): a write whose matcher is dropped."""
    import zlib
    plain = b"".join(ref_pgzf.plaintexts(stream))
    size = len(ref_pgzf.plaintexts(stream)[0])
    return ref_pgzf.write_members(plain, size, 6, zlib.Z_HUFFMAN_ONLY)


def _altered_stream(stream):
    m = ref_pgzf.walk(stream)[0]
    out = bytearray(stream)
    out[(m.body + m.body_end) // 2] ^= 0x04
    return bytes(out)


def _half_rows(out):
    rows, lens = out
    return rows[:len(rows) // 2], lens[:len(lens) // 2]


def _altered_rows(out):
    rows, lens = out
    rows = rows.clone()
    rows[0, 7] ^= 1
    return rows, lens


def _half_bytes(out):
    return out[:len(out) // 2]


def _altered_bytes(out):
    return out[:7] + bytes([out[7] ^ 1]) + out[8:]


FAULTS = {
    "compress": [_half_stream, _altered_stream, _huffman_only_stream],
    "decompress_to_device": [_half_rows, _altered_rows],
    "decompress": [_half_bytes, _altered_bytes],
}
FAULT_CASES = [(c, w) for c in CELLS for w in (0, 1)] + [
    ("titles-pgzf64k.write", 2)]
FAULT_NAMES = ["half_left_out", "answer_altered", "matches_dropped"]


@pytest.mark.parametrize("cell,which", FAULT_CASES,
                         ids=[f"{FAULT_NAMES[w]}-{c}" for c, w in
                              FAULT_CASES])
def test_fault_under_the_timed_path_is_not_correct(small, monkeypatch, cell,
                                                   which):
    from flatebench.tests.conftest import small_cell
    from libflate_tpu_torch.formats import pgzf
    name = small_cell(cell).traffic["entry"].split(":")[1]
    fault = FAULTS[name][which]
    real = getattr(pgzf, name)
    monkeypatch.setattr(pgzf, name, lambda *a, **k: fault(real(*a, **k)))
    rc, res, _err = small(cell)
    assert rc == 0 and res["correct"] is False
    assert ("body_excess" if which == 2 else "members_wrong") in _over(res)


def test_traced_run_reports_the_layer_metrics(small):
    rc, res, err = small("titles-pgzf64k.read", trace=1)
    assert rc == 0 and res["correct"] is True, err
    # no card: the readers of device activity find a window and no device
    # time, so no roofline
    assert set(res["metrics"]) == {"host_ms_per_call", "launches_per_call",
                                   "device_idle_pct"}
    assert res["device"]["busy_s"] == 0.0
    assert res["breakdown"]["device_ops"] == []
    assert res["breakdown"]["idle_gaps"]


def test_checked_calls_are_drawn_from_the_seed():
    from flatebench import harness
    tr = {"checked_from_first": 16, "checked_calls": 4}
    a = harness.sample_calls(2**31 + 99, tr)
    assert a == harness.sample_calls(2**31 + 99, tr) and len(a) == 3
    assert all(0 <= i < 16 for i in a)
    assert any(harness.sample_calls(s, tr) != a for s in range(5))
    assert np.iinfo(np.int64).max > 2**40      # seeds past 32 bits
    assert harness.sample_calls(2**40 + 1, tr)
