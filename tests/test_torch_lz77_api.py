"""The port's public LZ77 API and completion protocol against the
reference's (``libflate_tpu.lz77``, ``libflate_tpu.finish``): the same
inputs give the same codes, bytes and errors.
"""
import numpy as np
import pytest

from libflate_tpu import finish as ref_finish
from libflate_tpu import lz77 as ref
from libflate_tpu_torch import finish as port_finish
from libflate_tpu_torch import lz77 as port


def _data() -> bytes:
    rng = np.random.default_rng(8)
    return (bytes(rng.integers(97, 103, 3000, dtype=np.uint8)) + b"q" * 600
            + bytes(rng.integers(0, 256, 200, dtype=np.uint8)))


DATA = _data()


def _codes(codes):
    return [(c.length, c.backward_distance) for c in codes]


@pytest.mark.parametrize("level", ["NONE", "FAST", "BALANCE", "BEST"])
def test_encode_decode_match_reference(level):
    got = port.encode(DATA, getattr(port.CompressionLevel, level))
    assert _codes(got) == _codes(ref.encode(DATA, getattr(
        ref.CompressionLevel, level)))
    assert port.decode(got) == DATA


def test_default_encoder_and_its_options_match_reference():
    def run(mod, window):
        enc = (mod.DefaultLz77EncoderBuilder().window_size(window)
               .max_length(10_000).level(mod.CompressionLevel.BEST).build())
        sink: list = []
        for i in range(0, len(DATA), 777):        # the flush cadence
            enc.encode(DATA[i:i + 777], sink)
        enc.flush(sink)
        return (_codes(sink), enc.window_size(),
                enc.compression_level().name)

    for window in (256, 4096, 1 << 30):
        assert run(port, window) == run(ref, window)
    sink: list = []
    port.DefaultLz77Encoder().encode(b"aaaaa", sink)
    assert sink == [] or port.decode(sink)
    enc = port.DefaultLz77Encoder()
    enc.encode(b"aaaaa", sink)
    enc.flush(sink)
    assert _codes(sink) == [(97, 0), (4, 1)]


def test_no_compression_encoder_and_decoder_match_reference():
    for mod in (port, ref):
        enc = mod.NoCompressionLz77Encoder()
        sink: list = []
        enc.encode(b"abc", sink)
        assert all(c.is_literal for c in sink)
        assert enc.compression_level() is mod.CompressionLevel.NONE
        dec = mod.Lz77Decoder()
        dec.decode(mod.Code.literal(97))
        dec.decode(mod.Code.pointer(4, 1))
        assert dec.read() == b"aaaaa" and dec.read() == b""


@pytest.mark.parametrize("bad", ["short", "far", "past_history"])
def test_errors_match_reference(bad):
    def run(mod):
        try:
            if bad == "short":
                mod.Code.pointer(2, 1)
            elif bad == "far":
                mod.Code.pointer(3, 40000)
            else:
                mod.Lz77Decoder().decode(mod.Code.pointer(3, 5))
        except ValueError as e:
            return str(e)
        return None

    got = run(port)
    assert got is not None and got == run(ref)


def test_finish_matches_reference():
    for mod in (port_finish, ref_finish):
        ok = mod.Finish("v")
        assert ok.into_result() == "v" and ok.unwrap() == ("v", None)
        bad = mod.Finish("w", ValueError("boom"))
        with pytest.raises(ValueError, match="boom"):
            bad.into_result()

    class Enc:
        done = 0

        def finish(self):
            Enc.done += 1
            return self

    for mod in (port_finish, ref_finish):
        with mod.AutoFinish(Enc()):
            pass
        with mod.AutoFinishUnchecked(Enc()):
            pass
    assert Enc.done == 4
