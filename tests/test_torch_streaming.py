"""The port's streaming façades against the reference's.

* The three ``Encoder``s on the ``serial`` engine, written in four
  chunkings, byte-identical to the reference's ``Encoder(engine=None)``
  (its ``BlockStreamer`` route); zlib also with SYNC flushes.
* On the ``cpu`` engine (the buffered route), equal to the port's own
  one-shot ``compress(engine="cpu")``, which ``test_torch_containers.py``
  holds to the reference's device engine.
* ``Decoder`` / ``MultiDecoder`` on bytes and on ``io.BytesIO`` with
  ``header``; ``deflate.Decoder``'s partial-output salvage.

Inputs are a few KiB, made from a seed.
"""
import gzip
import io
import zlib

import numpy as np
import pytest

from libflate_tpu.formats import deflate as ref_deflate
from libflate_tpu.formats import gzip as ref_gzip
from libflate_tpu.formats import zlib as ref_zlib
from libflate_tpu.serial.deflate import EncodeOptions as RefOptions
from libflate_tpu_torch.formats import deflate as port_deflate
from libflate_tpu_torch.formats import gzip as port_gzip
from libflate_tpu_torch.formats import zlib as port_zlib
from libflate_tpu_torch.serial.deflate import EncodeOptions


def _data(n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 123, rng.integers(2, 8), dtype=np.uint8))
             for _ in range(80)]
    return b" ".join(words[int(i)] for i in rng.zipf(1.3, n // 3) % 80)[:n]


DATA = _data(9000, 4)
CHUNKINGS = {"one": [len(DATA)], "odd": [1, 7, 300, 4095],
             "block": [2000], "random": list(
                 np.random.default_rng(5).integers(1, 3000, 20))}
MODULES = {"deflate": (port_deflate, ref_deflate),
           "zlib": (port_zlib, ref_zlib), "gzip": (port_gzip, ref_gzip)}


def _write_all(enc, sizes) -> bytes:
    pos, i = 0, 0
    while pos < len(DATA):
        n = int(sizes[i % len(sizes)])
        enc.write(DATA[pos:pos + n])
        pos, i = pos + n, i + 1
    return enc.getvalue()


@pytest.mark.parametrize("chunking", sorted(CHUNKINGS))
@pytest.mark.parametrize("fmt", sorted(MODULES))
def test_serial_encoders_match_reference(fmt, chunking):
    """Blocks of 2500 bytes, so writes cross block boundaries."""
    port, ref = MODULES[fmt]
    opts = dict(block_size=2500)
    got = _write_all(port.Encoder(options=EncodeOptions(**opts),
                                  engine="serial"), CHUNKINGS[chunking])
    want = _write_all(ref.Encoder(options=RefOptions(**opts)),
                      CHUNKINGS[chunking])
    assert got == want
    assert got == _write_all(port.Encoder(options=EncodeOptions(**opts),
                                          engine="serial"), [len(DATA)])


def test_zlib_sync_flush_matches_reference():
    """SYNC flushes on the serial engine, and on the cpu engine (the
    buffered segments go through a serial streamer segment, as in the
    reference with an explicit engine)."""
    def run(mod, **kw):
        enc = mod.Encoder(flush_mode=mod.FlushMode.SYNC, **kw)
        for cut in (0, 1000, 1000, 5000):
            enc.write(DATA[cut:cut + 1500])
            enc.flush()
        enc.write(DATA[6500:])
        return enc.getvalue()

    got = run(port_zlib, engine="serial")
    assert got == run(ref_zlib)
    assert b"\x00\x00\xff\xff" in got
    cpu = run(port_zlib, engine="cpu")
    assert zlib.decompress(cpu) == zlib.decompress(got)


def test_zlib_sync_segment_longer_than_a_block():
    """A SYNC flush on a buffering engine with more than ``block_size``
    bytes buffered: the port writes every block of the serial segment,
    where the reference (explicit engine) drops all but the segment's
    last, so its stream does not decode."""
    def run(mod, options, engine):
        enc = mod.Encoder(options=options, flush_mode=mod.FlushMode.SYNC,
                          engine=engine)
        enc.write(DATA[:4500])
        enc.flush()
        enc.write(DATA[4500:6000])
        return enc.getvalue()

    got = run(port_zlib, EncodeOptions(block_size=1000), "cpu")
    assert zlib.decompress(got) == DATA[:6000]
    with pytest.raises(zlib.error):
        zlib.decompress(run(ref_zlib, RefOptions(block_size=1000), "serial"))


@pytest.fixture(scope="module")
def cpu_body():
    """The cpu engine's one-shot raw DEFLATE stream of the input."""
    return port_deflate.compress(DATA[:3000], engine="cpu")


@pytest.mark.parametrize("fmt", sorted(MODULES))
def test_cpu_encoders_equal_the_one_shot(fmt, cpu_body):
    """The buffered route: the whole input to the engine at finish, the
    container around the one-shot's body."""
    port, _ = MODULES[fmt]
    data = DATA[:3000]
    enc = port.Encoder(engine="cpu")
    for i in range(0, len(data), 700):
        enc.write(data[i:i + 700])
    got = enc.getvalue()
    if fmt == "deflate":
        assert got == cpu_body
    elif fmt == "gzip":
        assert got == (port_gzip.Header(mtime=0).encode() + cpu_body
                       + port_gzip.Trailer(zlib.crc32(data),
                                           len(data)).encode())
    else:
        assert got == (port_zlib.Header().encode() + cpu_body
                       + zlib.adler32(data).to_bytes(4, "big"))


@pytest.mark.parametrize("source", ["bytes", "file"])
def test_decoders_match_reference(source):
    """Decoder (header and plaintext), MultiDecoder over two members,
    zlib Decoder, on bytes (serial engine) and on a file-like source
    (the chunked decoders, whatever the engine)."""
    hdr = ref_gzip.HeaderBuilder().mtime(7).filename(b"f.txt").finish()
    one = ref_gzip.compress(DATA, header=hdr)
    two = one + gzip.compress(DATA[:999])
    zs = zlib.compress(DATA, 9)

    def wrap(b):
        return b if source == "bytes" else io.BytesIO(b)

    kw = {"engine": "serial"} if source == "bytes" else {"engine": "cpu"}
    dec = port_gzip.Decoder(wrap(one), **kw)
    want = ref_gzip.Decoder(wrap(one))
    assert dec.header.encode() == want.header.encode()
    assert dec.header.filename == b"f.txt"
    assert dec.read(100) + dec.read() == want.read() == DATA
    assert port_gzip.MultiDecoder(wrap(two), **kw).read() == DATA + DATA[:999]
    assert port_gzip.Decoder(wrap(two), **kw).read() == DATA
    zd = port_zlib.Decoder(wrap(zs), **kw)
    assert zd.header.encode() == ref_zlib.Decoder(wrap(zs)).header.encode()
    assert zd.read() == DATA


def test_file_like_decoder_errors_match_reference():
    bad = bytearray(gzip.compress(DATA))
    bad[-6] ^= 1                                   # the CRC
    for mod in (port_gzip, ref_gzip):
        with pytest.raises(mod.GzipError):
            mod.Decoder(io.BytesIO(bytes(bad))).read()
        with pytest.raises(EOFError):
            mod.Decoder(io.BytesIO(gzip.compress(DATA)[:50])).read()


@pytest.mark.parametrize("engine", ["serial", "cpu"])
def test_deflate_decoder_salvage_matches_reference(engine):
    """A byte flipped mid-stream: ``read()`` raises the engine's error,
    and the salvage is the serial engine's ``.partial``, as the
    reference's is."""
    good = ref_deflate.compress(DATA, RefOptions(block_size=2000))
    for pos in range(len(good) // 3, len(good)):   # the first flip that
        stream = bytearray(good)                    # cuts the output short
        stream[pos] ^= 0x40
        stream = bytes(stream)
        if 0 < len(ref_deflate.Decoder(stream).unread_decoded_data()) < \
                len(DATA) // 2 + 2000:
            break
    dec = port_deflate.Decoder(stream, engine=engine)
    want = ref_deflate.Decoder(stream, engine="serial")
    assert dec.unread_decoded_data() == want.unread_decoded_data()
    assert 0 < len(dec.unread_decoded_data()) < len(DATA)
    with pytest.raises((port_deflate.DeflateError, EOFError)):
        dec.read()
    ok = port_deflate.Decoder(ref_deflate.compress(DATA), engine=engine)
    assert ok.read(10) + ok.read() == DATA


def test_encoder_write_after_finish():
    for mod in (port_deflate, port_gzip, port_zlib):
        enc = mod.Encoder(engine="serial")
        enc.write(b"abc")
        enc.finish()
        with pytest.raises(ValueError):
            enc.write(b"x")
