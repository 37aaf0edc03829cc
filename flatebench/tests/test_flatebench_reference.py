"""The plain reference: the token walk against the LS index the program
writes and against zlib's streams, and the written-stream and row checks
on broken inputs."""
import struct
import zlib

import numpy as np
import pytest

from flatebench.corpora import titles
from flatebench.reference import compare, deflate_walk, pgzf as ref_pgzf
from flatebench.tests.test_flatebench_corpus import PARAMS

PLAIN = titles.make(PARAMS, 1, 3 * 4096 + 700)[0]


@pytest.fixture(scope="module")
def stream():
    from libflate_tpu_torch.formats import pgzf
    return pgzf.compress(PLAIN, member_size=4096, device="cpu")


def test_token_walk_names_every_sync_chunk(stream):
    ms = ref_pgzf.walk(stream)
    assert len(ms) == 4
    assert all(ref_pgzf.sync_index_ok(stream, m, 256) for m in ms)
    assert ref_pgzf.check_written(stream, PLAIN, 4096, 256, range(4)) == \
        {"members_wrong": 0, "ls_wrong": 0}


def test_token_walk_counts_zlib_tokens():
    # zlib's one-block streams: the walk ends at the end-of-block code,
    # whose bit the body's length bounds
    for level in (1, 6, 9):
        c = zlib.compressobj(level, zlib.DEFLATED, -15, 9)
        body = c.compress(PLAIN[:8192]) + c.flush()
        starts, eob = deflate_walk.token_starts(body)
        assert len(starts) > 100 and (starts[1:] > starts[:-1]).all()
        assert len(body) - 2 <= eob // 8 < len(body)


def _flip_ls_delta(stream):
    m = ref_pgzf.walk(stream)[1]
    out = bytearray(stream)
    ls = out.index(b"LS", m.start)
    pos = ls + 4 + 14               # the first delta
    out[pos] ^= 1
    return bytes(out)


def test_check_written_finds_each_fault(stream):
    ms = ref_pgzf.walk(stream)
    every = range(len(ms))
    assert ref_pgzf.check_written(_flip_ls_delta(stream), PLAIN, 4096, 256,
                                  every)["ls_wrong"] == 1
    half = stream[:ms[2].start]
    assert ref_pgzf.check_written(half, PLAIN, 4096, 256, [0])[
        "members_wrong"] == 2
    bad = bytearray(stream)
    bad[ms[0].body_end] ^= 1            # the first member's CRC
    assert ref_pgzf.check_written(bytes(bad), PLAIN, 4096, 256, [0])[
        "members_wrong"] == 1
    bad = bytearray(stream)
    bad[(ms[3].body + ms[3].body_end) // 2] ^= 0x10
    assert ref_pgzf.check_written(bytes(bad), PLAIN, 4096, 256, [])[
        "members_wrong"] == 1
    assert ref_pgzf.check_written(b"junk", PLAIN, 4096, 256, [0]) == \
        {"members_wrong": 5, "ls_wrong": 1}


def test_writer_without_sync_index_fails_only_the_ls_check():
    s = ref_pgzf.write_members(PLAIN, 4096)
    assert ref_pgzf.check_written(s, PLAIN, 4096, 256, range(4)) == \
        {"members_wrong": 0, "ls_wrong": 4}


def test_stored_members_pass_the_member_checks_and_not_the_size():
    s = ref_pgzf.write_members(PLAIN, 4096, level=0)
    ms = ref_pgzf.walk(s)
    assert all(ref_pgzf.is_stored(s, m) for m in ms)
    assert ref_pgzf.check_written(s, PLAIN, 4096, 256, range(4)) == \
        {"members_wrong": 0, "ls_wrong": 0}
    # a stored block adds 5 bytes to its bytes
    assert ref_pgzf.body_bytes(s) == len(PLAIN) + 5 * len(ms)
    best = ref_pgzf.zlib_body_bytes(PLAIN, 4096, level=9)
    assert best == ref_pgzf.zlib_body_bytes(PLAIN, 4096, level=9, threads=1)
    assert best < 0.5 * len(PLAIN)
    assert ref_pgzf.body_bytes(b"junk") == 0


def test_rows_and_bytes_comparisons():
    want = [b"abc", b"de", b""]
    rows = np.zeros((3, 1024), np.uint8)
    rows[0, :3] = list(b"abc")
    rows[1, :2] = list(b"de")
    lens = np.array([3, 2, 0])
    assert compare.rows_wrong(rows, lens, want) == 0
    r = rows.copy()
    r[1, 5] = 1                         # not zero past the length
    assert compare.rows_wrong(r, lens, want) == 1
    assert compare.rows_wrong(rows[:2], lens[:2], want) == 1
    assert compare.rows_wrong(rows, np.array([3, 1, 0]), want) == 1
    assert compare.bytes_wrong(b"abcde", want) == 0
    assert compare.bytes_wrong(b"abcdf", want) == 1
    assert compare.bytes_wrong(b"abcd", want) == 2


def test_sync_index_layout_is_the_documented_one(stream):
    m = ref_pgzf.walk(stream)[0]
    ls = m.subfields[b"LS"]
    ver, flags, k, n, first, chunks = struct.unpack_from("<BBHIIH", ls)
    assert (ver, flags, k) == (1, 0, 256)
    assert chunks == -(-n // 256) and len(ls) == 14 + 2 * (chunks - 1)
