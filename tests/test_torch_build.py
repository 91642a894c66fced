"""The kernel build's host logic (groove_tpu_torch/kernels/build.py) and the
wrappers' device rule, on a host without nvcc or a GPU: the library name
follows the sources and the shared headers, a missing compiler is
reported, and a tensor that is neither on the CPU nor on a CUDA device is
refused instead of falling back to a twin."""

from __future__ import annotations

import pytest
import torch

from groove_tpu_torch.kernels import build
from groove_tpu_torch.ops import drums


def test_library_path_follows_sources(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "a.cu").write_text("// one\n")
    (src / "h.cuh").write_text("// shared\n")
    monkeypatch.setattr(build, "CSRC", src)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    first = build.library_path()
    assert first == build.library_path()
    assert first.parent == tmp_path / "out"
    (src / "a.cu").write_text("// two\n")
    second = build.library_path()
    assert second != first
    (src / "h.cuh").write_text("// changed\n")
    assert build.library_path() not in (first, second)


def test_sources_are_the_packaged_kernels():
    names = [p.name for p in build.sources()]
    assert names == ["biquad.cu", "comb_stream.cu", "drums.cu", "lp24.cu",
                     "lp24_stream.cu", "scan1.cu", "scan_stream.cu",
                     "serial.cu"]
    assert [p.name for p in build.headers()] == ["tdf2.cuh", "tiled.cuh"]
    for p in build.sources():
        text = p.read_text()
        assert 'extern "C"' in text and "cudaGetLastError" in text


def test_missing_nvcc_is_reported(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "DEFAULT_CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc()
    (tmp_path / "bin").mkdir()
    (tmp_path / "bin" / "nvcc").write_text("")
    assert build.nvcc() == str(tmp_path / "bin" / "nvcc")


def test_drum_wrapper_refuses_other_devices():
    table = torch.zeros((1, 2, 256), device="meta")
    hits = [torch.zeros((1, 1), dtype=torch.int32, device="meta")] * 4
    with pytest.raises(RuntimeError, match="unsupported device"):
        drums.accumulate_hits(table, torch.zeros(1, dtype=torch.int32),
                              *hits, torch.zeros((1, 1)), n_frames=64)


def test_signatures_cover_every_entry_point():
    text = "".join(p.read_text() for p in build.sources())
    assert text.count('extern "C"') == len(build.SIGNATURES)
    for name, argtypes in build.SIGNATURES.items():
        head = text[text.index(f'extern "C" int {name}('):]
        params = head[:head.index(")")].count(",") + 1
        assert params == len(argtypes), name
