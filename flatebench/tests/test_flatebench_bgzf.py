"""The BGZF writer: stdlib gzip reads it back, every member's BC subfield
holds BSIZE, the file ends in the EOF member; the reference walks it; and
the program's foreign path reads it, the EOF member included."""
import gzip
import struct

import numpy as np

from flatebench.containers import bgzf
from flatebench.reference import bgzf as ref_bgzf, members

DATA = bytes(np.random.default_rng(3).integers(97, 105, 200_000,
                                               dtype=np.uint8))


def test_gzip_reads_it_back():
    s = bgzf.write(DATA, 65280)
    assert gzip.decompress(s) == DATA
    assert s.endswith(bgzf.EOF_BLOCK) and len(bgzf.EOF_BLOCK) == 28
    assert gzip.decompress(bgzf.EOF_BLOCK) == b""


def test_members_carry_bsize_and_the_htslib_header():
    s = bgzf.write(DATA, 65280)
    pos, sizes = 0, []
    while pos < len(s):
        assert s[pos:pos + 4] == b"\x1f\x8b\x08\x04"
        assert s[pos + 8:pos + 10] == b"\x00\xff"        # XFL 0, OS 255
        xlen, = struct.unpack_from("<H", s, pos + 10)
        assert xlen == 6 and s[pos + 12:pos + 16] == b"BC\x02\x00"
        bsize, = struct.unpack_from("<H", s, pos + 16)
        isize, = struct.unpack_from("<I", s, pos + bsize + 1 - 4)
        sizes.append(isize)
        pos += bsize + 1
    assert pos == len(s)
    assert sizes == [65280, 65280, 65280, 200_000 - 3 * 65280, 0]


def test_threads_do_not_change_the_bytes():
    assert bgzf.write(DATA, 4096, threads=1) == bgzf.write(DATA, 4096)


def test_reference_walks_it_and_refuses_a_missing_eof():
    s = bgzf.write(DATA, 65280)
    want = [DATA[i:i + 65280] for i in range(0, len(DATA), 65280)] + [b""]
    assert ref_bgzf.plaintexts(s) == want
    # no EOF member; a data member's CRC flipped
    for bad in (s[:-28], s[:-36] + bytes([s[-36] ^ 1]) + s[-35:]):
        try:
            ref_bgzf.plaintexts(bad)
        except ValueError:
            continue
        raise AssertionError("accepted a broken file")
    assert [m.end - m.start for m in ref_bgzf.walk(s)][-1] == 28
    assert isinstance(ref_bgzf.walk(s)[0], members.Member)


def test_the_programs_foreign_path_reads_it_eof_member_included():
    from libflate_tpu_torch.formats import pgzf
    s = bgzf.write(DATA, 65280)
    rows, lens = pgzf.decompress_to_device(s, verify=True, device="cpu")
    assert lens.tolist() == [65280, 65280, 65280, 4160, 0]
    assert rows.shape == (5, 65536)
    assert not rows[4].any()
    assert pgzf.decompress(s, verify=True, device="cpu") == DATA
