"""The CUDA build glue, checked where no CUDA toolkit exists.

The kernels compile only on a GPU host; here the tests pin what the
Python side assumes about them: the sources it builds, the C signatures
it declares to ctypes, and that a missing nvcc raises instead of falling
back.
"""
import re

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
    names = sorted(s.name for s in _build.sources())
    assert names == ["rank.cu", "resolve.cu", "sync_decode.cu"]


def test_ctypes_signatures_match_the_c_entry_points():
    assert _c_signatures() == _build._SIGNATURES


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
