"""The port's serial engine against the reference's (``libflate_tpu.serial``).

Seeded inputs of a few KiB; every comparison is exact: streams
byte-identical, plaintext, end bits, error classes and the ``.partial``
bytes a failed inflate carries.  Both sides are plain Python, so no
reference kernel runs here.
"""
import zlib

import numpy as np
import pytest

from libflate_tpu.serial import deflate as ref_deflate
from libflate_tpu.serial import huffman as ref_huffman
from libflate_tpu.serial import lz77 as ref_lz77
from libflate_tpu_torch import backend
from libflate_tpu_torch.serial import deflate as port_deflate
from libflate_tpu_torch.serial import huffman as port_huffman
from libflate_tpu_torch.serial import lz77 as port_lz77
from libflate_tpu_torch.serial.bitio import BitReader, BitWriter


def _text(n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 123, rng.integers(2, 9), dtype=np.uint8))
             for _ in range(120)]
    out = b" ".join(words[int(i)] for i in rng.zipf(1.3, n // 3) % 120)
    return (out + bytes(rng.integers(0, 256, 300, dtype=np.uint8)))[:n]


DATA = _text(6000, 1) + b"z" * 700 + _text(1500, 2)


@pytest.mark.parametrize("window", [32768, 1024])
@pytest.mark.parametrize("matcher", ["greedy", "chain", "none"])
@pytest.mark.parametrize("block_type", ["stored", "fixed", "dynamic"])
def test_deflate_matches_reference(block_type, matcher, window):
    """Multi-block streams (3000-byte blocks) of each block type under
    each matcher and two windows."""
    kw = dict(block_type=block_type, matcher=matcher, window_size=window,
              block_size=3000, max_chain=8)
    got = port_deflate.deflate(DATA, port_deflate.EncodeOptions(**kw))
    want = ref_deflate.deflate(DATA, ref_deflate.EncodeOptions(**kw))
    assert got == want
    res = port_deflate.inflate(got)
    assert bytes(res.data) == DATA
    assert zlib.decompress(got, -15) == DATA


def _inflate_outcome(mod, stream):
    try:
        res = mod.inflate(stream)
        return ("ok", bytes(res.data), res.end_bit)
    except Exception as e:                  # the class and .partial
        return (type(e).__name__, getattr(e, "partial", None), str(e))


def _corruptions():
    stream = ref_deflate.deflate(DATA, ref_deflate.EncodeOptions(
        block_size=3000))
    fixed = ref_deflate.deflate(DATA, ref_deflate.EncodeOptions(
        block_type="fixed"))
    cases = {"whole": stream, "cut_mid": stream[:len(stream) // 2],
             "cut_header": stream[:3], "empty": b"",
             "reserved_type": bytes([0b111]) + stream[1:]}
    for k, pos in enumerate((40, len(stream) // 3, len(stream) - 30)):
        flipped = bytearray(stream)
        flipped[pos] ^= 0x5A
        cases[f"flip_{k}"] = bytes(flipped)
    flipped = bytearray(fixed)
    flipped[len(fixed) // 2] ^= 0xFF
    cases["flip_fixed"] = bytes(flipped)
    stored = ref_deflate.deflate(DATA[:100], ref_deflate.EncodeOptions(
        block_type="stored"))
    cases["stored_nlen"] = stored[:3] + bytes([stored[3] ^ 1]) + stored[4:]
    return cases


CORRUPT = _corruptions()


@pytest.mark.parametrize("case", sorted(CORRUPT))
def test_inflate_and_partial_match_reference(case):
    """Output and end bit, or the error class, message and ``.partial``
    on truncated and corrupt streams."""
    stream = CORRUPT[case]
    assert (_inflate_outcome(port_deflate, stream)
            == _inflate_outcome(ref_deflate, stream))


def test_inflate_max_output_matches_reference():
    stream = ref_deflate.deflate(DATA, ref_deflate.EncodeOptions(
        block_size=2000))
    for limit in (1000, 5000, len(DATA)):
        outcome = []
        for mod in (port_deflate, ref_deflate):
            try:
                outcome.append(bytes(mod.inflate(stream, limit).data))
            except mod.DeflateError as e:
                outcome.append((str(e), e.partial))
        assert outcome[0] == outcome[1]


def test_package_merge_and_codes_match_reference():
    rng = np.random.default_rng(3)
    for n, limit in ((286, 15), (30, 15), (19, 7), (286, 10), (2, 1),
                     (1, 15), (0, 15)):
        freqs = rng.integers(0, 1000, n) * (rng.random(n) < 0.7)
        freqs[:min(n, 3)] = [1] * min(n, 3)
        got = port_huffman.package_merge(freqs, limit)
        np.testing.assert_array_equal(
            got, ref_huffman.package_merge(freqs, limit))
        np.testing.assert_array_equal(port_huffman.canonical_codes(got),
                                      ref_huffman.canonical_codes(got))
    with pytest.raises(port_huffman.HuffmanError):
        port_huffman.package_merge(np.ones(300), 8)


@pytest.mark.parametrize("tokenizer", ["greedy", "chain", "literal"])
def test_tokenizers_and_expand_match_reference(tokenizer):
    calls = {"greedy": lambda m: m.greedy_tokens(DATA, 4096, 200),
             "chain": lambda m: m.chain_tokens(DATA, 32768, 258, 16, True),
             "literal": lambda m: m.literal_tokens(DATA)}[tokenizer]
    toks = calls(port_lz77)
    assert toks == calls(ref_lz77)
    assert port_lz77.expand_tokens(toks) == DATA


def test_bit_writer_and_reader_state():
    w = BitWriter()
    w.write_bits(5, 3)
    w.write_code(0b1101, 4)
    w.align_byte()
    w.write_bytes(b"xy")
    blob = w.getvalue()
    r = BitReader(blob)
    assert r.read_bits(3) == 5
    st = r.state()
    first = r.read_bits(4)
    r.restore(st)
    assert r.read_bits(4) == first == 0b1011
    r.align_byte()
    assert r.read_bytes(2) == b"xy"


def test_serial_engine_registered():
    """``serial`` runs only when named: ``get(None)`` stays ``cuda``."""
    eng = backend.get("serial")
    assert bytes(eng.inflate(eng.deflate(DATA)).data) == DATA
    assert eng.crc32(DATA) == zlib.crc32(DATA)
    assert eng.adler32(DATA, 7) == zlib.adler32(DATA, 7)
    assert backend._default == "cuda"
    assert "serial" in backend.names()
