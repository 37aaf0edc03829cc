"""Command-line tool (the port's copy of ``libflate_tpu/cli.py``)::

    python -m libflate_tpu_torch.cli [-i IN] [-o OUT] [-v]
        [--engine cuda|cpu|native|serial] [--stream] SUBCOMMAND

Subcommands: copy, byte-read, gzip-decode, gzip-decode-multi,
gzip-encode, zlib-decode, zlib-encode, pgzf-encode, pgzf-decode.  "-"
means stdin / stdout.  ``--engine`` names the engine of
:mod:`.backend` the codecs run on: ``cuda`` (the default), ``cpu``,
``native`` (the threaded C++ host codec) or ``serial``.  ``pgzf-encode``
/ ``pgzf-decode`` run on the card for ``cuda`` and on CPU tensors for
``cpu`` (``device=``), and take the reference's host routes for
``native`` and ``serial`` (``engine=``).

``--stream`` runs the gzip / zlib codecs through the streaming façades:
a decoder pulls the input CHUNK bytes at a time through the host chunked
decoders (bounded memory, whatever the engine); an encoder streams in
bounded memory on ``serial`` and, on any other engine, buffers the
input and encodes it whole at the end.  The default mode reads whole
files.
"""
from __future__ import annotations

import argparse
import contextlib
import sys

_CHUNK = 1 << 20


def _read_input(path: str) -> bytes:
    if path == "-":
        return sys.stdin.buffer.read()
    with open(path, "rb") as f:
        return f.read()


def _write_output(path: str, data: bytes) -> None:
    if path == "-":
        sys.stdout.buffer.write(data)
        sys.stdout.buffer.flush()
    else:
        with open(path, "wb") as f:
            f.write(data)


@contextlib.contextmanager
def _open_in(path: str):
    if path == "-":
        yield sys.stdin.buffer
    else:
        with open(path, "rb") as f:
            yield f


@contextlib.contextmanager
def _open_out(path: str):
    if path == "-":
        yield sys.stdout.buffer
        sys.stdout.buffer.flush()
    else:
        with open(path, "wb") as f:
            yield f


def _pump(reader, writer) -> None:
    """io::copy — bounded-memory copy through a read()-style object."""
    while True:
        piece = reader.read(_CHUNK)
        if not piece:
            return
        writer.write(piece)


def _run_streaming(args) -> int:
    """Bounded-memory paths for copy/byte-read/gzip/zlib subcommands."""
    from .formats import gzip as fgzip, zlib as fzlib

    engine = args.engine
    with _open_in(args.input) as src, _open_out(args.output) as dst:
        if args.cmd == "copy":
            _pump(src, dst)
        elif args.cmd == "byte-read":
            unit = max(1, args.unit)
            while src.read(unit):
                pass
        elif args.cmd in ("gzip-decode", "gzip-decode-multi"):
            dec = (fgzip.MultiDecoder if args.cmd.endswith("multi")
                   else fgzip.Decoder)(src)
            if args.verbose:
                print(f"header: {dec.header}", file=sys.stderr)
            _pump(dec, dst)
        elif args.cmd == "zlib-decode":
            dec = fzlib.Decoder(src)
            if args.verbose:
                print(f"header: {dec.header}", file=sys.stderr)
            _pump(dec, dst)
        elif args.cmd == "gzip-encode":
            enc = fgzip.Encoder(sink=dst, engine=engine)
            _pump(src, _WriteAdapter(enc))
            enc.finish()
        elif args.cmd == "zlib-encode":
            enc = fzlib.Encoder(sink=dst, engine=engine)
            _pump(src, _WriteAdapter(enc))
            enc.finish()
        else:
            print(f"error: --stream does not support {args.cmd}",
                  file=sys.stderr)
            return 2
    return 0


class _WriteAdapter:
    """Minimal writer wrapper so _pump can feed an Encoder."""

    def __init__(self, enc) -> None:
        self._enc = enc

    def write(self, data: bytes) -> int:
        return self._enc.write(data)


def _pgzf_route(engine: str) -> dict:
    """pgzf's keyword for ``--engine``: ``device`` for "cuda" / "cpu",
    the reference's host routes for "native" and "serial"."""
    if engine in ("cuda", "cpu"):
        return {"device": engine}
    if engine in ("native", "serial"):
        return {"engine": engine}
    raise ValueError(f"pgzf takes --engine cuda, cpu, native or serial, "
                     f"got {engine!r}")


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="libflate-tpu-torch",
        description="DEFLATE / GZIP / ZLIB codec tool on a CUDA card")
    p.add_argument("-i", "--input", default="-")
    p.add_argument("-o", "--output", default="-")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--engine", default="cuda",
                   help="cuda (default) | cpu | native | serial")
    p.add_argument("--stream", action="store_true",
                   help="bounded-memory streaming codecs (chunked "
                        "decoders / BlockStreamer encoder)")
    sub = p.add_subparsers(dest="cmd", required=True)
    sub.add_parser("copy")
    br = sub.add_parser("byte-read")
    br.add_argument("--unit", type=int, default=1)
    sub.add_parser("gzip-decode")
    sub.add_parser("gzip-decode-multi")
    sub.add_parser("gzip-encode")
    sub.add_parser("zlib-decode")
    sub.add_parser("zlib-encode")
    pe = sub.add_parser("pgzf-encode")
    pe.add_argument("--member-size", type=int, default=64 * 1024)
    sub.add_parser("pgzf-decode")

    args = p.parse_args(argv)

    if args.stream:
        return _run_streaming(args)

    data = _read_input(args.input)

    from .formats import gzip as fgzip, pgzf, zlib as fzlib

    if args.cmd == "copy":
        out = data
    elif args.cmd == "byte-read":
        # parity: reads input unit bytes at a time, discards (throughput
        # probe); output is empty
        unit = max(1, args.unit)
        for _ in range(0, len(data), unit):
            pass
        out = b""
    elif args.cmd == "gzip-decode":
        dec = fgzip.Decoder(data, engine=args.engine)
        if args.verbose:
            print(f"header: {dec.header}", file=sys.stderr)
        out = dec.read()
    elif args.cmd == "gzip-decode-multi":
        out = fgzip.decompress(data, engine=args.engine, multi=True)
    elif args.cmd == "gzip-encode":
        out = fgzip.compress(data, engine=args.engine)
    elif args.cmd == "zlib-decode":
        dec = fzlib.Decoder(data, engine=args.engine)
        if args.verbose:
            print(f"header: {dec.header}", file=sys.stderr)
        out = dec.read()
    elif args.cmd == "zlib-encode":
        out = fzlib.compress(data, engine=args.engine)
    elif args.cmd == "pgzf-encode":
        out = pgzf.compress(data, member_size=args.member_size,
                            **_pgzf_route(args.engine))
    elif args.cmd == "pgzf-decode":
        out = pgzf.decompress(data, **_pgzf_route(args.engine))
    else:  # pragma: no cover
        p.error(f"unknown command {args.cmd}")

    _write_output(args.output, out)
    return 0


def run() -> int:
    """Entry point with clean one-line error reporting."""
    try:
        return main()
    except BrokenPipeError:
        return 0
    except (ValueError, OSError, EOFError, KeyError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(run())
