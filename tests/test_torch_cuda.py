"""The CUDA kernels of groove_tpu_torch against their plain torch twins on
a card, bit for bit: K1 (drums), K3 (lp24), K2 (refined lp24), K6 (lp24
with per-sample or static denominators), K4/K5/K9 (one biquad section with
block-rate, static or per-sample coefficients), the serial scan and the
stream kernels K7/K8 (K3/K2 with carried state; chained calls equal one
call), plus short renders of the slices and of a streamed Welsh song on
the card against the same renders on the CPU.

These tests need an NVIDIA GPU (marker `cuda`; they skip without one) and
import no jax, so the machine with the card runs them:

    python -m pytest tests/test_torch_cuda.py -q
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from groove_tpu_torch.compiler.song import compile_song
from groove_tpu_torch.engine.render import Renderer
from groove_tpu_torch.engine.stream import StreamingRenderer
from groove_tpu_torch.ops import biquad_kernels, drums, iir, iir_kernels
from groove_tpu_torch.project.paths import Paths
from groove_tpu_torch.project.schema import SongSettings
from groove_tpu_torch.testing import synth

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _sweep(rows: int, low: float, n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    nb = -(-n // 64)
    cut = (low * (20000.0 / low) ** np.linspace(0.0, 1.0, nb) ** 3)
    gain, secs = iir.lp24_sections(cut.astype(np.float32), np.float32(0.707),
                                   44100.0)
    x = (rng.standard_normal((rows, n)) * 0.3).astype(np.float32)
    x = torch.from_numpy(x * np.repeat(gain, 64)[:n])
    secs = [tuple(torch.from_numpy(np.ascontiguousarray(
        np.broadcast_to(c, (rows, nb)))) for c in sec) for sec in secs]
    return x, secs


@pytest.mark.parametrize("refined", [False, True], ids=["K3", "K2"])
@pytest.mark.parametrize("rows,n,low", [(2, 57216, 25.0), (16, 16384, 2000.0),
                                        (3, 5000, 300.0)])
def test_lp24_kernel_matches_twin(cuda_device, refined, rows, n, low):
    x, secs = _sweep(rows, low, n)
    fn = (iir_kernels.lp24_refined_blockrate if refined
          else iir_kernels.lp24_blockrate)
    key = "lp24_refined" if refined else "lp24"
    before = iir_kernels.LAUNCHES[key]
    y = fn(x.to(cuda_device), [tuple(c.to(cuda_device) for c in s)
                               for s in secs])
    torch.cuda.synchronize()
    assert iir_kernels.LAUNCHES[key] == before + 1
    assert torch.equal(y.cpu(), fn(x, secs))


def _hits(n: int, count: int, seed: int = 1):
    rng = np.random.default_rng(seed)
    table = (rng.standard_normal((6, 2, 70000)) * 0.5).astype(np.float32)
    lengths = rng.integers(100, 69999, 6)
    for s, ln in enumerate(lengths):
        table[s, :, ln:] = 0.0
    on = np.sort(rng.integers(0, n // 64, count)) * 64
    slots = rng.integers(-1, 6, count).astype(np.int32)
    vels = rng.integers(1, 128, count).astype(np.float32)
    meta = drums.prepare_hits(slots, on, np.full(count, 2**30), vels,
                              lengths, n)
    return (torch.from_numpy(drums.prepare_table(table)),
            [torch.from_numpy(m) for m in meta])


@pytest.mark.parametrize("n,count", [(4096, 20), (441000, 400),
                                     (3 * drums.CHUNK + 64, 300)])
def test_drum_kernel_matches_twin(cuda_device, n, count):
    table, meta = _hits(n, count)
    before = drums.LAUNCHES["drums"]
    y = drums.accumulate_hits(table.to(cuda_device),
                              *[m.to(cuda_device) for m in meta], n_frames=n)
    torch.cuda.synchronize()
    assert drums.LAUNCHES["drums"] == before + 1
    assert torch.equal(y.cpu(), drums.accumulate_hits(table, *meta,
                                                      n_frames=n))


def test_wrappers_refuse_bad_inputs(cuda_device):
    x, secs = _sweep(2, 500.0, 4096)
    with pytest.raises(TypeError):
        iir_kernels.lp24_blockrate(x.double().to(cuda_device), secs)
    table, meta = _hits(4096, 5)
    with pytest.raises(ValueError):
        drums.accumulate_hits(table.to(cuda_device), *meta, n_frames=4096)


def _noise(shape, seed: int = 0) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal(shape) * 0.3)
                            .astype(np.float32))


def _lowpass(count: int, low: float, high: float, q: float = 0.707):
    """Five low-pass coefficient arrays [count] sweeping low -> high."""
    cut = np.geomspace(low, high, count).astype(np.float32)
    return tuple(torch.from_numpy(np.ascontiguousarray(c)) for c in
                 iir.rbj_low_pass(cut, np.float32(q), 44100.0))


def _check(fn, counter, key, x, coefs, device):
    """One counted launch on the card, bitwise equal to the CPU twin."""
    before = counter[key]
    y = fn(x.to(device), tuple(c.to(device) if torch.is_tensor(c) else c
                               for c in coefs))
    torch.cuda.synchronize()
    assert counter[key] == before + 1
    assert torch.equal(y.cpu(), fn(x, coefs))


@pytest.mark.parametrize("shape", [(2, 57216), (16, 16384), (2, 3, 5000)])
def test_biquad_blockrate_kernel_matches_twin(cuda_device, shape):
    """K4 through an automated sweep that rests near 25 Hz."""
    nb = -(-shape[-1] // 64)
    coefs = tuple(c.expand(*shape[:-1], nb) for c in
                  _lowpass(nb, 25.0, 8000.0))
    _check(biquad_kernels.biquad_blockrate, biquad_kernels.LAUNCHES,
           "biquad_blockrate", _noise(shape), coefs, cuda_device)


@pytest.mark.parametrize("shape,cutoff,q", [
    ((2, 57216), 1000.0, 1.5), ((16, 16384), 300.0, 0.707),
    ((2, 3, 5000), 1000.0, 20.0)])
def test_biquad_scalar_kernel_matches_twin(cuda_device, shape, cutoff, q):
    coefs = iir.rbj_peaking_eq(cutoff, q, 6.0, 44100.0)
    _check(biquad_kernels.biquad_scalar, biquad_kernels.LAUNCHES,
           "biquad_scalar", _noise(shape, 1), coefs, cuda_device)


@pytest.mark.parametrize("shape", [(2, 57216), (3, 5000)])
def test_biquad_per_sample_kernel_matches_twin(cuda_device, shape):
    """K9 with per-sample coefficients shared by the rows (stride 0)."""
    coefs = _lowpass(shape[-1], 200.0, 12000.0)
    _check(biquad_kernels.biquad_per_sample, biquad_kernels.LAUNCHES,
           "biquad_per_sample", _noise(shape, 2), coefs, cuda_device)


@pytest.mark.parametrize("per_sample", [False, True],
                         ids=["static", "per-sample"])
@pytest.mark.parametrize("shape", [(2, 57216), (3, 5000), (2, 4999)])
def test_serial_kernel_matches_twin(cuda_device, shape, per_sample):
    """n = 4999 leaves the rows unaligned for the kernel's float4 tiles:
    the wrapper pads them."""
    if per_sample:
        coefs = _lowpass(shape[-1], 25.0, 400.0)
    else:
        coefs = iir.rbj_high_pass(40.0, 0.707, 44100.0)
    _check(biquad_kernels.biquad_serial, biquad_kernels.LAUNCHES,
           "biquad_serial", _noise(shape, 3), coefs, cuda_device)


@pytest.mark.parametrize("mode", ["static", "per-sample", "broadcast"])
@pytest.mark.parametrize("shape", [(2, 57216), (3, 5000)])
def test_lp24_cascade_kernel_matches_twin(cuda_device, shape, mode):
    """K6: static denominators (by value), per-sample ones per row, and
    per-sample ones shared by the rows (read with row stride 0)."""
    n = shape[-1]
    if mode == "static":
        _, secs = iir.lp24_sections(8000.0, 0.707, 44100.0)
    else:
        cut = np.geomspace(60.0, 15000.0, n).astype(np.float32)
        _, secs = iir.lp24_sections(cut, np.float32(0.9), 44100.0)
        secs = [tuple(torch.from_numpy(np.ascontiguousarray(c)) for c in s)
                for s in secs]
        if mode == "per-sample":
            secs = [tuple(c.expand(shape).contiguous() for c in s)
                    for s in secs]
    x = _noise(shape, 4)
    before = iir_kernels.LAUNCHES["lp24_cascade"]
    dev = [tuple(c.to(cuda_device) if torch.is_tensor(c) else c for c in s)
           for s in secs]
    y = iir_kernels.lp24_cascade(x.to(cuda_device), dev)
    torch.cuda.synchronize()
    assert iir_kernels.LAUNCHES["lp24_cascade"] == before + 1
    assert torch.equal(y.cpu(), iir_kernels.lp24_cascade(x, secs))


def test_biquad_wrappers_refuse_bad_inputs(cuda_device):
    coefs = iir.rbj_low_pass(1000.0, 0.707, 44100.0)
    for fn in (biquad_kernels.biquad_scalar, biquad_kernels.biquad_serial):
        with pytest.raises(TypeError):
            fn(_noise((2, 4096)).double().to(cuda_device), coefs)


@pytest.mark.parametrize("make", [synth.north_star_project,
                                  synth.high_sweep_project,
                                  synth.filter_bank_project],
                         ids=["north-star", "high-sweep", "filter-bank"])
def test_short_slice_on_card_equals_cpu(cuda_device, tmp_path, make):
    assets = synth.write_assets(tmp_path, max_seconds=0.4)
    compiled = compile_song(SongSettings.from_json(make()),
                            Paths(roots=[assets]))
    on_card = Renderer(compiled, cuda_device).render()
    assert np.array_equal(on_card, Renderer(compiled, "cpu").render())


@pytest.mark.parametrize("refined", [False, True], ids=["K7", "K8"])
@pytest.mark.parametrize("rows,n,low", [(12, 4096, 120.0), (3, 16384, 25.0),
                                        (64, 65536, 500.0)])
def test_stream_kernel_matches_twin_and_chains(cuda_device, refined, rows, n,
                                               low):
    """From a carried state (the exit of a first call), each stream kernel
    equals its twin; two chained half calls equal one call, y and
    state."""
    x, secs = _sweep(rows, low, 2 * n, seed=5)
    fn = (iir_kernels.lp24_refined_blockrate_stream if refined
          else iir_kernels.lp24_blockrate_stream)
    key = "lp24_refined_stream" if refined else "lp24_stream"
    width = iir_kernels.STATE_ROWS[key]

    def part(a, b, dev):
        return (x[:, a:b].contiguous().to(dev),
                [tuple(c[:, a // 64:b // 64].contiguous().to(dev)
                       for c in s) for s in secs])

    _, st0 = fn(*part(0, n, "cpu"), torch.zeros(rows, width))
    before = iir_kernels.LAUNCHES[key]
    y, st = fn(*part(n, 2 * n, cuda_device), st0.to(cuda_device))
    torch.cuda.synchronize()
    assert iir_kernels.LAUNCHES[key] == before + 1
    y_cpu, st_cpu = fn(*part(n, 2 * n, "cpu"), st0)
    assert torch.equal(y.cpu(), y_cpu) and torch.equal(st.cpu(), st_cpu)
    h = n + n // 2
    ya, sa = fn(*part(n, h, cuda_device), st0.to(cuda_device))
    yb, sb = fn(*part(h, 2 * n, cuda_device), sa)
    assert torch.equal(torch.cat([ya, yb], 1), y) and torch.equal(sb, st)


def test_welsh_stream_on_card_equals_cpu(cuda_device):
    """A 1 s Welsh analogue streamed in 4096-frame slices on the card: the
    CPU twins' render bit for bit, and the card's one-segment render."""
    compiled = compile_song(SongSettings.from_json(
        synth.welsh_project(1, 240.0)), Paths(roots=[]))
    sliced = type("Sliced", (StreamingRenderer,), {"WELSH_SLICED": True})
    before = dict(iir_kernels.LAUNCHES)
    r = sliced(compiled, cuda_device, segment_frames=4096)
    on_card = r.render(quantize=True)
    got = {k: iir_kernels.LAUNCHES[k] - before[k]
           for k in ("lp24_stream", "lp24_refined_stream")}
    assert got == r.planned_launches()
    assert np.array_equal(on_card, sliced(compiled, "cpu", 4096).render(
        quantize=True))
    one = -(-compiled.n_frames // 64) * 64
    assert np.array_equal(on_card, sliced(compiled, cuda_device, one).render(
        quantize=True))
