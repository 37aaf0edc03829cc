"""The CUDA build glue, checked where no CUDA toolkit exists.

The kernels compile only on a GPU host; here the tests pin what the
Python side assumes about them: the sources it builds, the C signatures
it declares to ctypes, that each source compiles in its own nvcc
process, and that a missing nvcc raises instead of falling back.
"""
import pathlib
import re
import subprocess

import pytest

from libflate_tpu_torch import _build

_C_TYPES = {"const void*": "p", "void*": "p", "int": "i", "int64_t": "q"}


def _c_signatures():
    sigs = {}
    for src in _build.sources():
        text = src.read_text()
        for name, params in re.findall(
                r'extern "C" int (lf_\w+)\(([^)]*)\)', text):
            types = [re.sub(r"\s*\w+$", "", p.strip())
                     for p in params.split(",")]
            sigs[name] = "".join(_C_TYPES[t] for t in types)
    return sigs


def test_sources_are_the_three_kernels():
    """The decode's three kernel sources are built (the encode's four
    are pinned by the next test)."""
    names = {s.name for s in _build.sources()}
    assert {"rank.cu", "resolve.cu", "sync_decode.cu"} <= names


def test_sources_are_the_seven_kernel_files():
    """The seven sources of the decode and default-encode main paths
    (the encode options' three are pinned by the next test)."""
    names = {s.name for s in _build.sources()}
    assert {"fields.cu", "match.cu", "pack.cu", "parse.cu", "rank.cu",
            "resolve.cu", "sync_decode.cu"} <= names


def test_sources_are_the_ten_kernel_files():
    """The ten sources of the decode, the encode and its options (the
    speculative decode's is pinned by the next test)."""
    names = {s.name for s in _build.sources()}
    assert {"fields.cu", "gather.cu", "hash.cu", "lcp.cu", "match.cu",
            "pack.cu", "parse.cu", "rank.cu", "resolve.cu",
            "sync_decode.cu"} <= names


def test_sources_are_the_eleven_kernel_files():
    """The eleven sources of the device-output paths (the generic decode's
    is pinned by the next test)."""
    names = {s.name for s in _build.sources()}
    assert {"fields.cu", "gather.cu", "hash.cu", "lcp.cu", "match.cu",
            "pack.cu", "parse.cu", "rank.cu", "resolve.cu",
            "spec_decode.cu", "sync_decode.cu"} <= names


def test_sources_are_the_twelve_kernel_files():
    """The twelve sources of every path (the checksums' is pinned by the
    next test)."""
    names = {s.name for s in _build.sources()}
    assert {"fields.cu", "gather.cu", "hash.cu", "inflate.cu", "lcp.cu",
            "match.cu", "pack.cu", "parse.cu", "rank.cu", "resolve.cu",
            "spec_decode.cu", "sync_decode.cu"} <= names


def test_sources_are_the_thirteen_kernel_files():
    names = sorted(s.name for s in _build.sources())
    assert names == ["checksum.cu", "fields.cu", "gather.cu", "hash.cu",
                     "inflate.cu", "lcp.cu", "match.cu", "pack.cu",
                     "parse.cu", "rank.cu", "resolve.cu", "spec_decode.cu",
                     "sync_decode.cu"]


def test_ctypes_signatures_match_the_c_entry_points():
    sigs = _c_signatures()
    assert sigs == _build._SIGNATURES
    assert {sigs[k] for k in ("lf_crc32_rows", "lf_adler32",
                              "lf_checksum_info")} == {
        "piqqpppp", "pqippp", "ip"}


def test_library_is_named_by_source_hash():
    so = _build.library_path()
    assert so.parent == _build.BUILD_DIR
    assert re.fullmatch(r"libflate_cuda-[0-9a-f]{12}\.so", so.name)
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_build_runs_one_nvcc_per_source_then_links(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    started = []

    class FakeProc:
        returncode = 0

        def __init__(self, cmd, **kw):
            started.append(cmd)
            pathlib.Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")

        def communicate(self):
            assert len(started) == n_cu     # all started before any wait
            return "", ""

    def fake_run(cmd, **kw):
        pathlib.Path(cmd[cmd.index("-o") + 1]).write_bytes(b"so")
        return subprocess.CompletedProcess(cmd, 0, "", "")

    n_cu = sum(s.suffix == ".cu" for s in _build.sources())
    monkeypatch.setattr(_build.subprocess, "Popen", FakeProc)
    monkeypatch.setattr(_build.subprocess, "run", fake_run)
    so = _build.build()
    assert so.read_bytes() == b"so" and so.parent == tmp_path
    assert [c[c.index("-c") + 1] for c in started] == [
        str(s) for s in _build.sources() if s.suffix == ".cu"]
    assert not list(tmp_path.glob("*.o"))
