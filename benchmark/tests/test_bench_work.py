"""The frozen work arithmetic equals chip_smoke.py's at the kernel
table's shapes."""

import importlib.util
import math

import pytest
import torch

from benchmark import work

REPO = work.__file__.rsplit("/benchmark/", 1)[0]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_work", f"{REPO}/chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.SM_CLOCK_HZ = work.SM_CLOCK_HZ
    return mod


SHAPES = [(2, 441024), (2, 7938048), (64, 65536), (12, 4096), (12, 8384),
          (5, 32589)]
KINDS = ["K2", "K3", "K4", "K5", "K6", "K9", "K7", "K8", "S3", "S4",
         "serial"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("rows,n", SHAPES)
def test_iir_work(smoke, kind, rows, n):
    for coef, state in ((0.0, 0), (4.0 * rows * n / 64, 2)):
        assert work.iir_work(kind, rows, n, coef, state) == \
            smoke.iir_work(kind, rows, n, coef, state)


@pytest.mark.parametrize("rows,n", SHAPES)
def test_bounds(smoke, rows, n):
    w = work.iir_work("K2", rows, n, 0.0)
    assert work.bounds(*w) == smoke.bounds(*w)


@pytest.mark.parametrize("shape,axis", [((2, 441024), -1),
                                        ((2, 7938048), -1),
                                        ((360, 64, 552), 1), ((2, 4096), 0)])
def test_scan_work(smoke, shape, axis):
    x = torch.empty(shape)
    a = torch.empty(shape[axis]).expand(shape) if axis == -1 else 0.5
    for mode in (work.LINEAR, work.MAX_DECAY):
        assert work.scan_work(x, a, 1.0, axis, mode) == \
            smoke.scan_work(x, a, 1.0, axis, mode)


def test_drum_work(smoke):
    from groove_tpu_torch.ops.drums import CHUNK

    n = 3 * 65536 + 64
    hits = smoke.dense_hits(n, "cpu")
    assert work.drum_work(hits, n, CHUNK) == smoke.drum_work(hits, n)


def test_geometry_is_the_programs():
    from groove_tpu_torch.ops.iir_kernels import geometry

    for n in (4096, 65536, 441024, 7938048, 100):
        for br in (True, False):
            assert work.geometry(n, br) == geometry(n, br)


def test_entry_points_exist():
    import importlib

    for path, name in work.ENTRY_POINTS:
        assert callable(getattr(importlib.import_module(path), name))


def test_stream_work_matches_stream_calls(smoke):
    """S1's and S2's work as chip_smoke's stream_calls counts them."""
    n, rows = 262144, 2
    x = torch.empty(rows, n)
    g = torch.empty(n)
    hx = torch.empty(rows, 1927)
    io = 8.0 * x.numel() + smoke.distinct_bytes(g) + 2 * 2 * rows * 1927 * 4
    assert work._comb_stream(x, hx, hx, g) == (
        io, 2.0 * x.numel(), 2.0 * math.ceil(n / 1927))
    w = work._scan_stream(x, 0.5, 1.0, 0.0, work.MAX_DECAY)
    assert w[2] == 2.0 * (n // 64)
