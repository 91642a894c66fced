"""The CUDA kernels of groove_tpu_torch against their plain torch twins on
a card, bit for bit: K1 (drums; dense hits that overflow a tile's list,
one allocation, a captured graph), K3 (lp24), K2 (refined lp24), K6 (lp24
with per-sample or static denominators), K4/K5/K9 (one biquad section with
block-rate, static or per-sample coefficients), the serial scan and the
stream kernels K7/K8 (K3/K2 with carried state, one launch of
csrc/lp24_stream.cu per call: chained calls equal one call, many tiles
with a short last one, strided coefficient views, the earlier multi-launch
route, two allocations per call, a captured CUDA graph's replay), K4, K5,
K9, K2, K3 and K6 (static and per-sample) on their shared-memory tiles
(csrc/tiled.cuh) against their twins and their earlier multi-launch routes
over block, tile and alignment edges, every in-block length, zero-stride
and unaligned coefficients, rows cut into segments, a non-default stream
and a captured graph, the first-order scan (csrc/scan1.cu: both modes,
number, per-element and row-broadcast coefficients, the time axis and
block space, lengths off its chunk, a lane of many chained blocks, products
of a through denormals, lane counts on both sides of the layouts' border,
calls queued back to back, a captured graph replayed; the FM modulator
phase's shapes), the unsliced stream's carried-state kernels S1-S4
(ops/stream_kernels.py: scan_stream, comb_stream, biquad_state,
biquad_serial_state against their twins, chained calls = one call on the
card; S1 and S2 also at their plans' edge shapes and replayed from a
captured graph), plus short renders of the slices, of a streamed Welsh song and
of the same song offline, of the kitchen-sink and perf-1 analogues, of
the FM and instruments analogues, of a MIDI file, and of the 10-second
kitchen-sink and 2-second sidechain analogues streamed unsliced, on the
card against the same renders on the CPU; and the bounce's fetch into
page-locked memory: y.cpu().numpy()'s bits, shape, dtype and strides,
an array of its own each call, its counters, the pageable fallback.

These tests need an NVIDIA GPU (marker `cuda`; they skip without one) and
import no jax, so the machine with the card runs them:

    python -m pytest tests/test_torch_cuda.py -q
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from groove_tpu_torch.compiler.song import compile_song
from groove_tpu_torch.engine.render import Renderer
from groove_tpu_torch.engine.stream import StreamingRenderer
from groove_tpu_torch.ops import (biquad_kernels, drums, iir, iir_kernels,
                                  scan_kernels)
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


def _dense_hits(n: int, seed: int = 3):
    """Hits every 64 frames over rows longer than a 65536-frame chunk, a
    fifth of them gated short: some 1,000 hits cover a 2048-frame tile, so
    its list (256 entries) overflows four times."""
    rng = np.random.default_rng(seed)
    lengths = np.array([66100, 70000, 30000, 700])
    table = (rng.standard_normal((4, 2, 70000)) * 0.5).astype(np.float32)
    for s, ln in enumerate(lengths):
        table[s, :, ln:] = 0.0
    on = np.arange(0, n, 64)
    gate = np.where(rng.random(len(on)) < 0.2,
                    rng.integers(1, 5000, len(on)), 2**30)
    meta = drums.prepare_hits(rng.integers(0, 4, len(on)).astype(np.int32),
                              on, gate,
                              rng.integers(1, 128, len(on)).astype(np.float32),
                              lengths, n)
    return (torch.from_numpy(drums.prepare_table(table)),
            [torch.from_numpy(m) for m in meta])


@pytest.mark.parametrize("n", [3 * drums.CHUNK + 64, 2 * drums.CHUNK + 4001])
def test_drum_kernel_dense_hits_match_twin(cuda_device, n):
    """Dense hits: every tile's list overflows more than once; n a
    multiple neither of the tile nor of 4 in the second case."""
    table, meta = _dense_hits(n)
    assert int(meta[0].max()) == 1024
    before = drums.LAUNCHES["drums"]
    y = drums.accumulate_hits(table.to(cuda_device),
                              *[m.to(cuda_device) for m in meta], n_frames=n)
    torch.cuda.synchronize()
    assert drums.LAUNCHES["drums"] == before + 1
    assert torch.equal(y.cpu(), drums.accumulate_hits(table, *meta,
                                                      n_frames=n))


def test_drum_kernel_allocates_once_and_replays(cuda_device):
    """A call allocates y and nothing else, and can be captured in a CUDA
    graph: the replay on changed hit velocities equals the eager call."""
    n = 441000
    table, meta = _hits(n, 400)
    table = table.to(cuda_device)
    meta = [m.to(cuda_device) for m in meta]
    y = drums.accumulate_hits(table, *meta, n_frames=n)
    torch.cuda.synchronize()
    count = "allocation.all.allocated"
    before = torch.cuda.memory_stats(cuda_device)[count]
    drums.accumulate_hits(table, *meta, n_frames=n)
    assert torch.cuda.memory_stats(cuda_device)[count] == before + 1
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y_g = drums.accumulate_hits(table, *meta, n_frames=n)
    meta[-1].mul_(0.5)
    graph.replay()
    torch.cuda.synchronize()
    y_e = drums.accumulate_hits(table, *meta, n_frames=n)
    assert torch.equal(y_g, y_e) and not torch.equal(y_e, y)


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


def _stream_case(refined: bool, rows: int, n: int, low: float, device):
    """(wrapper, key, x, sections, carried state) on `device`: the second
    half of a 2n sweep with the state its first half leaves (CPU twins)."""
    x, secs = _sweep(rows, low, 2 * n, seed=6)
    fn = (iir_kernels.lp24_refined_blockrate_stream if refined
          else iir_kernels.lp24_blockrate_stream)
    key = "lp24_refined_stream" if refined else "lp24_stream"
    cut = lambda a, b: [tuple(c[:, a // 64:b // 64].contiguous()  # noqa: E731
                              for c in s) for s in secs]
    _, st = fn(x[:, :n].contiguous(), cut(0, n),
               torch.zeros(rows, iir_kernels.STATE_ROWS[key]))
    assert float(st.abs().max()) > 0.0
    return (fn, key, x[:, n:].contiguous().to(device),
            [tuple(c.to(device) for c in s) for s in cut(n, 2 * n)],
            st.to(device))


TILE = iir_kernels.STREAM_TILE


@pytest.mark.parametrize("refined", [False, True], ids=["K7", "K8"])
@pytest.mark.parametrize("rows,n", [(12, 2 * TILE + 192), (5, 64),
                                    (8, TILE), (3, 7 * TILE + 64)])
def test_stream_kernel_tiles_match_twin_and_earlier_route(cuda_device,
                                                          refined, rows, n):
    """One launch walks the row in shared-memory tiles, the last one
    short: equal to the CPU twin and to the earlier multi-launch route, y
    and state, from a carried state."""
    fn, key, x, secs, st = _stream_case(refined, rows, n, 40.0, cuda_device)
    before = iir_kernels.LAUNCHES[key]
    y, st2 = fn(x, secs, st)
    torch.cuda.synchronize()
    assert iir_kernels.LAUNCHES[key] == before + 1
    y_cpu, st_cpu = fn(x.cpu(), [tuple(c.cpu() for c in s) for s in secs],
                       st.cpu())
    assert torch.equal(y.cpu(), y_cpu) and torch.equal(st2.cpu(), st_cpu)
    y_old, st_old = iir_kernels._stream_earlier(refined, x, secs, st)
    assert torch.equal(y, y_old) and torch.equal(st2, st_old)
    assert iir_kernels.LAUNCHES[key] == before + 1


@pytest.mark.parametrize("refined", [False, True], ids=["K7", "K8"])
def test_stream_kernel_reads_strided_coefficients(cuda_device, refined):
    """Row-broadcast (stride 0) and column-sliced coefficient views give
    the bits of their contiguous copies; no copy is made for them."""
    fn, _, x, secs, st = _stream_case(refined, 6, TILE + 128, 60.0,
                                      cuda_device)
    shared = [tuple(c[0] for c in s) for s in secs]  # one row for all
    y, st2 = fn(x, [tuple(c.expand(6, -1) for c in s) for s in shared], st)
    y_c, st_c = fn(x, [tuple(c.expand(6, -1).contiguous() for c in s)
                       for s in shared], st)
    assert torch.equal(y, y_c) and torch.equal(st2, st_c)
    wide = [tuple(torch.cat([c, c], 1) for c in s) for s in secs]
    nb = secs[0][0].shape[1]
    y_s, st_s = fn(x, [tuple(c[:, nb:] for c in s) for s in wide], st)
    y_w, st_w = fn(x, secs, st)
    assert torch.equal(y_s, y_w) and torch.equal(st_s, st_w)


@pytest.mark.parametrize("refined", [False, True], ids=["K7", "K8"])
def test_stream_kernel_call_allocates_twice_and_replays(cuda_device,
                                                        refined):
    """A call on the render's kind of arguments makes two allocations (y
    and the exported state) and can be captured in a CUDA graph: the
    replay on new input bits equals the eager call."""
    fn, _, x, secs, st = _stream_case(refined, 12, TILE, 120.0, cuda_device)
    fn(x, secs, st)  # the library is loaded
    torch.cuda.synchronize()
    count = "allocation.all.allocated"
    before = torch.cuda.memory_stats(cuda_device)[count]
    y, st2 = fn(x, secs, st)
    assert torch.cuda.memory_stats(cuda_device)[count] == before + 2
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y_g, st_g = fn(x, secs, st)
    x.mul_(0.5)
    st.copy_(st2)
    graph.replay()
    torch.cuda.synchronize()
    y_e, st_e = fn(x, secs, st)
    assert torch.equal(y_g, y_e) and torch.equal(st_g, st_e)
    assert not torch.equal(y_e, y)


def _tiled_case(name: str, rows: int, n: int, kind: str):
    """(wrapper, earlier route, counter, key, x, coefficients) on the CPU;
    kind: 'full' a curve per row, 'row' one curve for all rows (stride 0
    along rows), 'time' one value per row held for all time (stride 0
    along time). K5 and K6 take static coefficients (by value): kind does
    not apply. K9 and K6s (K6 with per-sample denominators) take one
    coefficient set per sample, swept 200 Hz -> 12 kHz and 60 Hz -> 15 kHz
    at q 0.9."""
    nb = -(-n // 64)
    if name == "K5":
        return (biquad_kernels.biquad_scalar,
                lambda x, c: biquad_kernels._launch(*biquad_kernels._prepare(
                    x, c, iir_kernels.SCALAR)).reshape(x.shape),
                biquad_kernels.LAUNCHES, "biquad_scalar",
                _noise((rows, n), 10),
                iir.rbj_peaking_eq(300.0, 2.0, 6.0, 44100.0))
    if name == "K6":
        gain, secs = iir.lp24_sections(300.0, 0.9, 44100.0)
        return (iir_kernels.lp24_cascade,
                lambda x, c: iir_kernels._cascade_earlier(x, c, False),
                iir_kernels.LAUNCHES, "lp24_cascade",
                _noise((rows, n), 9) * float(gain), secs)
    if name == "K4":
        x = _noise((rows, n), 7)
        coefs = _lowpass(nb, 25.0, 8000.0, q=2.0)
        args = (biquad_kernels.biquad_blockrate,
                biquad_kernels._blockrate_earlier, biquad_kernels.LAUNCHES,
                "biquad_blockrate")
    elif name == "K9":
        nb = n
        x = _noise((rows, n), 11)
        coefs = _lowpass(n, 200.0, 12000.0)
        args = (biquad_kernels.biquad_per_sample,
                biquad_kernels._per_sample_earlier, biquad_kernels.LAUNCHES,
                "biquad_per_sample")
    elif name == "K6s":
        nb = n
        cut = np.geomspace(60.0, 15000.0, n).astype(np.float32)
        gain, secs = iir.lp24_sections(cut, np.float32(0.9), 44100.0)
        x = _noise((rows, n), 12) * torch.from_numpy(gain)
        coefs = [tuple(torch.from_numpy(np.ascontiguousarray(c)) for c in s)
                 for s in secs]
        args = (iir_kernels.lp24_cascade,
                lambda x, c: iir_kernels._cascade_earlier(x, c, False),
                iir_kernels.LAUNCHES, "lp24_cascade")
    else:
        x, secs = _sweep(1, 25.0, n, seed=8)
        x = x.expand(rows, n) * torch.linspace(0.5, 1.0, rows)[:, None]
        coefs = [tuple(c[0] for c in s) for s in secs]
        if name == "K2":
            args = (iir_kernels.lp24_refined_blockrate,
                    iir_kernels._refined_earlier, iir_kernels.LAUNCHES,
                    "lp24_refined")
        else:
            args = (iir_kernels.lp24_blockrate,
                    lambda x, c: iir_kernels._cascade_earlier(x, c, True),
                    iir_kernels.LAUNCHES, "lp24")

    def view(c):
        # every row reads whole coefficient sets of the one curve, so each
        # stays a stable filter
        if kind == "row":
            return c.expand(rows, nb)
        if kind == "time":
            held = c[(nb // 2 + torch.arange(rows)) % nb]
            return held.reshape(rows, 1).expand(rows, nb)
        return torch.stack([torch.roll(c, 3 * r) for r in range(rows)])

    if name in ("K4", "K9"):
        coefs = tuple(view(c) for c in coefs)
    else:
        coefs = [tuple(view(c) for c in s) for s in coefs]
    return (*args, x.contiguous(), coefs)


def _to(coefs, device):
    if isinstance(coefs, tuple):
        return tuple(_moved(c, device) for c in coefs)
    return [tuple(_moved(c, device) for c in s) for s in coefs]


def _moved(c, device):
    """c on `device` with its strides kept (a broadcast stays stride 0); a
    static coefficient as it is."""
    if not torch.is_tensor(c):
        return c
    base = torch.empty_strided(c.shape, c.stride(), dtype=c.dtype,
                               device=device)
    if 0 in c.stride():
        small = c[tuple(slice(0, 1) if s == 0 else slice(None)
                        for s in c.stride())]
        return small.to(device).expand(c.shape)
    return base.copy_(c)


TILED_SHAPES = [(2, 441024, "row"), (64, 65536, "row"), (5, 32589, "row"),
                (5, 32589, "time"), (3, 1, "full"), (2, 4096, "full"),
                (2, 4097, "full"), (3, 127 * 128 + 1, "full"),
                (2, 128 * 128 - 1, "time"),
                # long enough for K2 to cut its chains into two segments
                (2, 1100003, "row")]


@pytest.mark.parametrize("name", ["K4", "K5", "K9", "K2", "K3", "K6",
                                  "K6s"])
@pytest.mark.parametrize("rows,n,kind", TILED_SHAPES)
def test_tiled_kernel_matches_twin_and_earlier_route(cuda_device, name, rows,
                                                     n, kind):
    """One counted launch of the tiled kernels equals the CPU twin and the
    earlier multi-launch route bit for bit: the 10-second and the wide
    shape, n off the in-block length, off a tile and off 16-byte row
    alignment, every in-block length, zero-stride coefficients."""
    fn, earlier, counts, key, x, coefs = _tiled_case(name, rows, n, kind)
    xd, cd = x.to(cuda_device), _to(coefs, cuda_device)
    before = counts[key]
    y = fn(xd, cd)
    torch.cuda.synchronize()
    assert counts[key] == before + 1
    assert torch.equal(y.cpu(), fn(x, coefs))
    y_old = earlier(xd, cd)
    torch.cuda.synchronize()
    assert torch.equal(y, y_old)
    assert counts[key] == before + 1


@pytest.mark.parametrize("name", ["K4", "K9", "K2", "K3", "K6s"])
def test_tiled_kernel_reads_strided_coefficients(cuda_device, name):
    """Zero-stride views along rows or time, and column slices of a wider
    array, give the bits of their contiguous copies. A per-sample slice
    starts one sample in (off 16-byte alignment: staged 4 bytes at a
    time)."""
    single = name in ("K4", "K9")
    for kind in ("row", "time"):
        fn, _, _, _, x, coefs = _tiled_case(name, 6, 20000, kind)
        xd, cd = x.to(cuda_device), _to(coefs, cuda_device)
        flat = cd if single else [c for s in cd for c in s]
        assert all(0 in c.stride() for c in flat)
        dense = (tuple(c.contiguous() for c in cd) if single
                 else [tuple(c.contiguous() for c in s) for s in cd])
        assert torch.equal(fn(xd, cd), fn(xd, dense))
    fn, _, _, _, x, coefs = _tiled_case(name, 3, 20000, "full")
    xd, cd = x.to(cuda_device), _to(coefs, cuda_device)
    off = 1 if name in ("K9", "K6s") else -(-20000 // 64)
    wide = lambda c: torch.cat([c[:, :off], c], 1)[:, off:]  # noqa: E731
    sliced = (tuple(wide(c) for c in cd) if single
              else [tuple(wide(c) for c in s) for s in cd])
    assert not (sliced[0] if single else sliced[0][3]).is_contiguous()
    assert torch.equal(fn(xd, sliced), fn(xd, cd))


@pytest.mark.parametrize("n", [50000, 2200000], ids=["short", "long"])
@pytest.mark.parametrize("name,allocations", [("K4", 2), ("K5", 2), ("K9", 2),
                                              ("K2", 3), ("K3", 3), ("K6", 3),
                                              ("K6s", 3)])
def test_tiled_kernel_on_another_stream_and_in_a_graph(cuda_device, name,
                                                       allocations, n):
    """A call launches on the current stream, whichever it is (a long K2,
    K3 or K6 call forks its chains onto streams of the library's and joins
    them again); it allocates its outputs and one scratch buffer and nothing
    else; captured in a CUDA graph, its replay on new input bits equals
    the eager call."""
    fn, _, _, _, x, coefs = _tiled_case(name, 4 if n < 10**6 else 2, n, "row")
    xd, cd = x.to(cuda_device), _to(coefs, cuda_device)
    y = fn(xd, cd)
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        y_side = fn(xd, cd)
    side.synchronize()
    assert torch.equal(y_side, y)
    count = "allocation.all.allocated"
    before = torch.cuda.memory_stats(cuda_device)[count]
    fn(xd, cd)
    assert torch.cuda.memory_stats(cuda_device)[count] == before + allocations
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y_g = fn(xd, cd)
    xd.mul_(0.5)
    graph.replay()
    torch.cuda.synchronize()
    y_e = fn(xd, cd)
    assert torch.equal(y_g, y_e) and not torch.equal(y_e, y)


@pytest.mark.parametrize("n,ln", [(1, 16), (200, 16), (256, 16), (257, 32),
                                  (1000, 32), (1024, 32)])
def test_static_lp24_at_short_in_block_lengths(cuda_device, n, ln):
    """Static K6 at the in-block lengths only it takes (16 and 32: one
    coefficient set a block, the 4-chunk swizzle at 16) equals the CPU twin
    and the earlier route, and the tiled kernel counts its launch."""
    assert iir_kernels.geometry(n, blockrate=False)[0] == ln
    fn, earlier, counts, key, x, secs = _tiled_case("K6", 3, n, "")
    xd = x.to(cuda_device)
    before = counts[key]
    y = fn(xd, secs)
    torch.cuda.synchronize()
    assert counts[key] == before + 1
    assert torch.equal(y.cpu(), fn(x, secs))
    assert torch.equal(y, earlier(xd, secs))
    assert counts[key] == before + 1


@pytest.mark.parametrize("name", ["K9", "K6s"])
@pytest.mark.parametrize("n,ln", [(1, 16), (200, 16), (256, 16), (257, 32),
                                  (1000, 32), (1024, 32)])
def test_per_sample_at_short_in_block_lengths(cuda_device, name, n, ln):
    """K9 and per-sample K6 at the short in-block lengths (16 and 32: two
    and four ring stages a tile, the 4-chunk swizzle at 16) equal the CPU
    twin and the earlier route, and the tiled kernel counts its launch."""
    assert iir_kernels.geometry(n, blockrate=False)[0] == ln
    fn, earlier, counts, key, x, coefs = _tiled_case(name, 3, n, "full")
    xd, cd = x.to(cuda_device), _to(coefs, cuda_device)
    before = counts[key]
    y = fn(xd, cd)
    torch.cuda.synchronize()
    assert counts[key] == before + 1
    assert torch.equal(y.cpu(), fn(x, coefs))
    assert torch.equal(y, earlier(xd, cd))
    assert counts[key] == before + 1


@pytest.mark.parametrize("n,ln", [(1, 16), (200, 16), (257, 32),
                                  (1024, 32), (4000, 64), (57216, 128)])
def test_biquad_scalar_at_every_in_block_length(cuda_device, n, ln):
    """K5 on biquad_tiled at every in-block length a static section takes
    (16 and 32: one coefficient set a block, the 4-chunk swizzle at 16)
    equals the CPU twin and its earlier route, biquad_scan, and counts its
    launch."""
    assert iir_kernels.geometry(n, blockrate=False)[0] == ln
    fn, earlier, counts, key, x, coefs = _tiled_case("K5", 3, n, "")
    xd = x.to(cuda_device)
    before = counts[key]
    y = fn(xd, coefs)
    torch.cuda.synchronize()
    assert counts[key] == before + 1
    assert torch.equal(y.cpu(), fn(x, coefs))
    assert torch.equal(y, earlier(xd, coefs))
    assert counts[key] == before + 1


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


@pytest.mark.parametrize("cap", [None, 500_000], ids=["whole", "chunked"])
def test_welsh_offline_on_card_equals_cpu(cuda_device, cap):
    """A 2 s Welsh analogue offline on the card (whole buckets, or row
    chunks of a small cap): the CPU twins' render with the same cap bit
    for bit, with the planned K2/K3 launches."""
    compiled = compile_song(SongSettings.from_json(
        synth.welsh_project(2, 240.0)), Paths(roots=[]))
    r = Renderer(compiled, cuda_device, note_chunk_elems=cap)
    before = dict(iir_kernels.LAUNCHES)
    on_card = r.render()
    got = {k: iir_kernels.LAUNCHES[k] - before[k]
           for k in ("lp24_refined", "lp24")}
    assert got == r.welsh_launches() and sum(got.values()) >= 2
    cpu = Renderer(compiled, "cpu", note_chunk_elems=r.note_chunk_elems)
    assert np.array_equal(on_card, cpu.render())


# ---- the first-order scan (csrc/scan1.cu) ----------------------------------

@pytest.mark.parametrize("mode", [scan_kernels.LINEAR, scan_kernels.MAX_DECAY],
                         ids=["linear", "max-decay"])
@pytest.mark.parametrize("coef", ["number", "per-element", "row-broadcast"])
@pytest.mark.parametrize("shape,axis", [((2, 57216), -1), ((3, 5000), -1),
                                        ((2, 4999), -1), ((2, 300, 75), -2),
                                        ((2, 40, 1927), -2)])
def test_scan1_kernel_matches_twin(cuda_device, mode, coef, shape, axis):
    """The time axis with n a multiple of the chunk or not, and block
    space [R, nb, D] scanned over nb (lanes x steps through strides);
    coefficients by value, per element, or one row read with stride 0."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    if mode == scan_kernels.MAX_DECAY:
        x = x.abs()
    if coef == "number":
        a, b = 0.999, 0.25
    else:
        row = shape if coef == "per-element" else shape[1:]
        a = torch.from_numpy(rng.uniform(0.9, 0.9999, row).astype(np.float32))
        b = 1.0 - a
        if coef == "row-broadcast":
            a, b = a.expand(shape), b.expand(shape)
    def on(v):
        return v.to(cuda_device) if torch.is_tensor(v) else v
    before = scan_kernels.LAUNCHES["scan1"]
    y = scan_kernels.scan1(x.to(cuda_device), on(a), on(b), axis=axis,
                           mode=mode)
    torch.cuda.synchronize()
    assert scan_kernels.LAUNCHES["scan1"] == before + 1
    assert torch.equal(y.cpu(), scan_kernels.scan1(x, a, b, axis=axis,
                                                   mode=mode))


def _scan_inputs(shape, mode, low, seed):
    """x (|x| for max_decay) and per-element a in [low, 0.99999), b = 1 - a:
    with low 0.3 the products of a pass through denormals to 0 within a
    chunk."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    if mode == scan_kernels.MAX_DECAY:
        x = x.abs()
    a = torch.from_numpy(rng.uniform(low, 0.99999, shape).astype(np.float32))
    return x, a, 1.0 - a


def _scan_on_card(cuda_device, x, a, b, axis, mode):
    before = scan_kernels.LAUNCHES["scan1"]
    y = scan_kernels.scan1(x.to(cuda_device), a.to(cuda_device),
                           b.to(cuda_device), axis=axis, mode=mode)
    torch.cuda.synchronize()
    assert scan_kernels.LAUNCHES["scan1"] == before + 1
    return y.cpu()


@pytest.mark.parametrize("mode", [scan_kernels.LINEAR, scan_kernels.MAX_DECAY],
                         ids=["linear", "max-decay"])
@pytest.mark.parametrize("low", [0.99, 0.3], ids=["slow", "denormal"])
def test_scan1_kernel_chains_many_blocks(cuda_device, mode, low):
    """A lane long enough for many chained blocks ([2, 2**21 + 37]: 2,049
    chunks of 1,024, 17 spans a lane, the last chunk short) with
    per-sample coefficients = the twin bit for bit."""
    n = 2**21 + 37
    p = scan_kernels.plan(2, n, 1, 3)
    assert p.layout == scan_kernels.TIME and p.spans == 17
    x, a, b = _scan_inputs((2, n), mode, low, seed=21)
    assert torch.equal(_scan_on_card(cuda_device, x, a, b, -1, mode),
                       scan_kernels.scan1(x, a, b, mode=mode))


@pytest.mark.parametrize("mode", [scan_kernels.LINEAR, scan_kernels.MAX_DECAY],
                         ids=["linear", "max-decay"])
@pytest.mark.parametrize("shape,axis", [
    ((1, 20000), -1), ((2, 20000), -1), ((3, 20000), -1), ((31, 9000), -1),
    ((1, 20000, 2), -2), ((1, 20000, 31), -2), ((1, 2000, 32), -2),
    ((1, 2000, 75), -2)])
def test_scan1_kernel_lane_counts(cuda_device, mode, shape, axis):
    """R * D lanes in {1, 2, 3, 31, 32, 75} on both sides of the layouts'
    border (time axis below 32 lanes side by side: [R, n] rows, or D
    lanes read step stride D; block space from 32), every lane several
    spans long, per-element coefficients, = the twin bit for bit."""
    x, a, b = _scan_inputs(shape, mode, 0.9, seed=sum(shape))
    rsd = (shape[0], shape[1], shape[2] if len(shape) == 3 else 1)
    p = scan_kernels.plan(*rsd, 3)
    assert p.spans >= 2
    assert p.layout == (scan_kernels.LANES if rsd[2] >= 32
                        else scan_kernels.TIME)
    assert torch.equal(_scan_on_card(cuda_device, x, a, b, axis, mode),
                       scan_kernels.scan1(x, a, b, axis=axis, mode=mode))


def test_scan1_back_to_back_calls(cuda_device):
    """Calls queued one after the other on one stream, no synchronisation
    between them (each resets its own ticket and flags on the stream; a
    later call may reuse an earlier call's scratch), = their twins."""
    cases = [(scan_kernels.LINEAR, (2, 300000), -1),
             (scan_kernels.MAX_DECAY, (2, 300000), -1),
             (scan_kernels.LINEAR, (2, 4000, 75), -2),
             (scan_kernels.LINEAR, (2, 300000), -1)]
    inputs = [(mode, axis, *_scan_inputs(shape, mode, 0.95, seed=i))
              for i, (mode, shape, axis) in enumerate(cases)]
    outs = []
    for mode, axis, x, a, b in inputs:
        outs.append(scan_kernels.scan1(
            x.to(cuda_device), a.to(cuda_device), b.to(cuda_device),
            axis=axis, mode=mode))
    torch.cuda.synchronize()
    for (mode, axis, x, a, b), y in zip(inputs, outs):
        assert torch.equal(y.cpu(), scan_kernels.scan1(x, a, b, axis=axis,
                                                       mode=mode))


def test_scan1_graph_replay_equals_eager(cuda_device):
    """Two calls (time axis and block space) captured in one CUDA graph,
    replayed twice on new inputs: each replay = the eager calls on the
    same inputs (the memset before each launch is part of the graph)."""
    mode = scan_kernels.LINEAR
    x, a, b = (t.to(cuda_device) for t in _scan_inputs((2, 400000), mode,
                                                       0.95, seed=5))
    xb, ab, bb = (t.to(cuda_device) for t in _scan_inputs((2, 3000, 1927),
                                                          mode, 0.9, seed=6))

    def calls():
        return (scan_kernels.scan1(x, a, b, mode=mode),
                scan_kernels.scan1(xb, ab, bb, axis=-2, mode=mode))

    calls()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        y, yb = calls()
    for scale in (0.5, -2.0):
        x.mul_(scale)
        xb.mul_(scale)
        g.replay()
        torch.cuda.synchronize()
        want, want_b = calls()
        assert torch.equal(y, want) and torch.equal(yb, want_b)
        assert torch.equal(y.cpu(), scan_kernels.scan1(
            x.cpu(), a.cpu(), b.cpu(), mode=mode))


def test_scan1_wrapper_refuses_bad_inputs(cuda_device):
    x = torch.ones(2, 4096, device=cuda_device)
    with pytest.raises(TypeError):
        scan_kernels.scan1(x.double(), 0.5)
    with pytest.raises(ValueError):
        scan_kernels.scan1(x, torch.full((4096,), 0.5))  # a on the CPU


@pytest.mark.parametrize("make, scans",
                         [(lambda: synth.kitchen_sink_project(1), 16),
                          (lambda: synth.perf1_project(8), 6)],
                         ids=["kitchen-sink", "perf-1"])
def test_effect_analogues_on_card_equal_cpu(cuda_device, tmp_path, make,
                                            scans):
    """About 2 s of each analogue: every effect kind on the card, the
    scans launched as planned (two for each smoothing compressor, six for
    each reverb), = the CPU twins' render bit for bit."""
    assets = synth.write_assets(tmp_path, max_seconds=0.4)
    compiled = compile_song(SongSettings.from_json(make()),
                            Paths(roots=[assets]))
    r = Renderer(compiled, cuda_device)
    before = scan_kernels.LAUNCHES["scan1"]
    on_card = r.render()
    assert scan_kernels.LAUNCHES["scan1"] - before == scans
    assert np.array_equal(on_card, Renderer(compiled, "cpu").render())


# ---- FM, the other instruments and SMF import (offline) --------------------

@pytest.mark.parametrize("shape,axis", [((6, 64, 553), 1), ((6, 553), -1),
                                        ((1440, 64, 31), 1),
                                        ((360, 40000), -1)],
                         ids=["in-block", "block-prefix", "few-blocks",
                              "flat"])
def test_scan1_at_the_fm_phase_shapes(cuda_device, shape, axis):
    """The modulator phase's sums (models/fm.modulator_phase): the in-block
    sums of [rows, nb, 64] handed over as [rows, 64, nb] along axis 1
    (block space; 31 blocks take the time axis), the block prefix
    [rows, nb] and a flat row, with a = 1 by value: kernel = twin."""
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.uniform(0.0, 0.05, shape).astype(np.float32))
    if axis == 1:
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
    before = scan_kernels.LAUNCHES["scan1"]
    y = scan_kernels.scan1(x.to(cuda_device), 1.0, axis=axis)
    torch.cuda.synchronize()
    assert scan_kernels.LAUNCHES["scan1"] == before + 1
    assert torch.equal(y.cpu(), scan_kernels.scan1(x, 1.0, axis=axis))


def test_fm_render_with_a_ratio_curve_on_card_equals_cpu(cuda_device):
    """The FM analogue (3 s: host tables, and a ratio curve integrated on
    scan1) on the card, whole and in row chunks of a small cap: the CPU
    twins' render bit for bit, scan1 launched as planned."""
    compiled = compile_song(SongSettings.from_json(synth.fm_project(2)),
                            Paths(roots=[]))
    for cap in (None, 200_000):
        r = Renderer(compiled, cuda_device, note_chunk_elems=cap)
        before = scan_kernels.LAUNCHES["scan1"]
        on_card = r.render()
        assert scan_kernels.LAUNCHES["scan1"] - before == \
            r.fm_launches()["scan1"] >= 2
        cpu = Renderer(compiled, "cpu", note_chunk_elems=r.note_chunk_elems)
        assert np.array_equal(on_card, cpu.render())


def test_instruments_on_card_equal_cpu(cuda_device, tmp_path):
    """The instruments analogue (4 s: the 48 kHz kit, sampler, calculator,
    oscillators with a frequency trip and noise, envelope, toy) on the
    card = the CPU twins' render bit for bit; K1 is not launched (the kit
    resamples)."""
    assets = synth.write_instrument_assets(tmp_path)
    compiled = compile_song(SongSettings.from_json(
        synth.instruments_project(2)), Paths(roots=[assets]))
    before = drums.LAUNCHES["drums"]
    on_card = Renderer(compiled, cuda_device).render()
    assert drums.LAUNCHES["drums"] == before
    assert np.abs(on_card).max() > 0.05
    assert np.array_equal(on_card, Renderer(compiled, "cpu").render())


def test_midi_file_on_card_equals_cpu(cuda_device, tmp_path):
    """An 8 s MIDI file (drum channel: K1; two GM programs: Welsh patches
    on K2/K3) on the card = the CPU twins' render bit for bit."""
    from groove_tpu_torch.compiler.song import compile_midi_file

    assets = synth.write_welsh_patches(synth.write_assets(
        tmp_path, max_seconds=0.4))
    path = tmp_path / "song.mid"
    path.write_bytes(synth.midi_song(4))
    compiled = compile_midi_file(path, Paths(roots=[assets]))
    r = Renderer(compiled, cuda_device)
    before = drums.LAUNCHES["drums"]
    on_card = r.render()
    assert drums.LAUNCHES["drums"] == before + 1
    cpu = Renderer(compiled, "cpu", note_chunk_elems=r.note_chunk_elems)
    assert np.array_equal(on_card, cpu.render())


# ---- the carried-state kernels of the unsliced stream (S1-S4) -------------

def _stream_kernel_calls(S: int, seed: int = 11):
    """name -> (wrapper, args on the CPU, per-time args): each S1-S4 call
    on seeded inputs of S frames, from a carried state."""
    from groove_tpu_torch.ops import stream_kernels as sk

    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.standard_normal((2, S)) * 0.3)
                         .astype(np.float32))
    a = torch.from_numpy(rng.uniform(0.9, 0.999, S).astype(np.float32))
    y0 = torch.tensor([0.1, -0.2])
    hx = torch.from_numpy((rng.standard_normal((2, 1927)) * 0.1)
                          .astype(np.float32))
    st = (torch.tensor([0.01, 0.02]), torch.tensor([0.0, -0.01]))
    nb = S // 64
    cut = np.geomspace(200.0, 8000.0, nb).astype(np.float32)
    cb = [torch.from_numpy(np.asarray(c, np.float32))
          for c in iir.rbj_low_pass(cut, np.float32(0.707), 44100.0)]
    hp = [float(c) for c in iir.rbj_high_pass(40.0, 0.707, 44100.0)]
    lp = [float(c) for c in iir.rbj_low_pass(1000.0, 0.707, 44100.0)]
    return {
        "S1 linear": lambda v: sk.scan_stream(v(x), v(a), 1 - v(a), v(y0)),
        "S1 max_decay": lambda v: sk.scan_stream(
            v(x).abs(), 0.999, 1.0, v(y0).abs(), sk.MAX_DECAY),
        "S2 comb": lambda v: sk.comb_stream(v(x), v(hx), 0.5 * v(hx), 0.8),
        "S2 comb per-sample": lambda v: sk.comb_stream(
            v(x), v(hx), 0.5 * v(hx), v(a)),
        "S2 allpass": lambda v: sk.allpass_stream(v(x), v(hx[:, :75]), 0.7),
        "S3 scalar": lambda v: sk.biquad_state(v(x), lp,
                                               tuple(map(v, st))),
        "S3 block": lambda v: sk.biquad_state(v(x), [v(c) for c in cb],
                                              tuple(map(v, st))),
        "S4 serial": lambda v: sk.biquad_serial_state(
            v(x[:, :8192]), hp, tuple(map(v, st))),
    }


def _flat_out(out) -> torch.Tensor:
    items = []
    for t in out:
        items += list(t) if isinstance(t, tuple) else [t]
    return torch.cat([t.reshape(-1).cpu() for t in items])


@pytest.mark.parametrize("name", list(_stream_kernel_calls(64)))
@pytest.mark.parametrize("S", [64, 4096, 65536 + 3 * 64])
def test_stream_kernels_match_twins(cuda_device, name, S):
    """S1-S4 on the card = their CPU twins bit for bit (outputs and
    exported state), each call one counted launch."""
    from groove_tpu_torch.ops import stream_kernels as sk

    call = _stream_kernel_calls(S)[name]
    before = sum(sk.LAUNCHES.values())
    on_card = call(lambda t: t.to(cuda_device))
    torch.cuda.synchronize()
    assert sum(sk.LAUNCHES.values()) == before + 1
    assert torch.equal(_flat_out(on_card), _flat_out(call(lambda t: t)))


def test_stream_kernels_chain_on_card(cuda_device):
    """Calls chained through the carried state = one call, on the card:
    S1 and S3 at 64-multiple cuts, S2 at cuts no multiple of its delay."""
    from groove_tpu_torch.ops import stream as sops

    rng = np.random.default_rng(12)
    S = 3 * 4096
    x = torch.from_numpy((rng.standard_normal((2, S)) * 0.3)
                         .astype(np.float32)).to(cuda_device)
    cuts = [0, 64, 4160, 9000 // 64 * 64, S]
    cb = [torch.from_numpy(np.asarray(c, np.float32)).to(cuda_device)
          for c in iir.rbj_low_pass(
              np.geomspace(100.0, 9000.0, S // 64).astype(np.float32),
              np.float32(2.0), 44100.0)]
    z2 = torch.zeros(2, device=cuda_device)
    hz = torch.zeros(2, 1310, device=cuda_device)
    y1, _ = sops.max_decay_stream(x.abs(), 0.999, z2)
    y3, s3 = sops.biquad_stream(x, cb, (z2, z2))
    y2, _, h2 = sops.comb_feedback_stream(x, hz, hz, 0.8)
    parts1, parts2, parts3 = [], [], []
    p1, st3, hx, hy = z2, (z2, z2), hz, hz
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        a, p1 = sops.max_decay_stream(x[:, lo:hi].abs(), 0.999, p1)
        b, st3 = sops.biquad_stream(x[:, lo:hi],
                                    [c[lo // 64:hi // 64] for c in cb], st3)
        parts1.append(a)
        parts3.append(b)
    for lo, hi in zip([0, 100, 2000, 7777], [100, 2000, 7777, S]):
        c, hx, hy = sops.comb_feedback_stream(x[:, lo:hi], hx, hy, 0.8)
        parts2.append(c)
    assert torch.equal(torch.cat(parts1, 1), y1)
    assert torch.equal(torch.cat(parts3, 1), y3)
    assert all(torch.equal(a, b) for a, b in zip(st3, s3))
    assert torch.equal(torch.cat(parts2, 1), y2) and torch.equal(hy, h2)


def _offset(t: torch.Tensor) -> torch.Tensor:
    """t's values in a contiguous tensor whose data starts 4 bytes past a
    16-byte boundary."""
    base = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = base[1:].view(t.shape)
    out.copy_(t)
    return out


def _edge_case(name: str):
    """name -> the call on seeded inputs (wrapper, args), for the S1/S2
    plans' edge shapes: spans of 128 blocks with a short last one, rows
    and coefficients off 16 bytes (the cp.async routes), contiguous
    all-pass tiles cut across periods, S < D, lane groups through the
    tensor map with the periods past it by copies, odd and multiple-of-4
    delays, no map (S % 4), a partial last lane group."""
    from groove_tpu_torch.ops import delayfx
    from groove_tpu_torch.ops import stream_kernels as sk

    kind, *rest = name.split()
    rng = np.random.default_rng(len(name))
    if kind.startswith("S1"):
        S = 64 * int(rest[0])
        x = torch.from_numpy((rng.standard_normal((2, S)) * 0.3)
                             .astype(np.float32))
        a = torch.from_numpy(rng.uniform(0.9, 0.9995, (2, S))
                             .astype(np.float32))
        if "broadcast" in rest:
            a = a[0]
        u = _offset if "unaligned" in rest else (lambda t: t)
        y0 = torch.tensor([0.2, -0.1])
        if "max" in rest:
            return lambda v: sk.scan_stream(u(v(x).abs()), u(v(a)), 1.0,
                                            v(y0).abs(), sk.MAX_DECAY)
        return lambda v: sk.scan_stream(u(v(x)), u(v(a)), u(1 - v(a)),
                                        v(y0))
    D, S = int(rest[0]), int(rest[1])
    x = torch.from_numpy((rng.standard_normal((2, S)) * 0.3)
                         .astype(np.float32))
    h = torch.from_numpy((rng.standard_normal((2, D)) * 0.1)
                         .astype(np.float32))
    u = _offset if "unaligned" in rest else (lambda t: t)
    if kind == "S2a":
        return lambda v: sk.allpass_stream(u(v(x)), v(h), delayfx.ALLPASS_G)
    g = 0.83
    if "g" in rest:
        g = torch.from_numpy(rng.uniform(0.5, 0.9, S).astype(np.float32))
    if "g-rows" in rest:
        g = torch.from_numpy(rng.uniform(0.5, 0.9, (2, S))
                             .astype(np.float32))
    gv = (lambda v: u(v(g))) if torch.is_tensor(g) else (lambda v: g)
    return lambda v: sk.comb_stream(u(v(x)), v(h), 0.5 * v(h), gv(v))


EDGE_CASES = [
    "S1 129", "S1 300", "S1 300 broadcast", "S1 300 max broadcast",
    "S1 300 unaligned", "S1 300 max unaligned",
    "S2a 75 55248", "S2a 75 50", "S2a 75 55248 unaligned", "S2a 221 40000",
    "S2c 1927 255364 g", "S2c 1927 255364", "S2c 1928 15424 g-rows",
    "S2c 1310 15727 g", "S2c 300 12000", "S2c 1100 900 g",
    "S2c 1927 255364 g unaligned",
]


@pytest.mark.parametrize("name", EDGE_CASES)
def test_carried_kernels_edge_shapes(cuda_device, name):
    """S1 and S2 at their plans' edge shapes on the card = the CPU twins
    bit for bit (y and the carried state), one counted launch each."""
    from groove_tpu_torch.ops import stream_kernels as sk

    call = _edge_case(name)
    before = sum(sk.LAUNCHES.values())
    on_card = call(lambda t: t.to(cuda_device))
    torch.cuda.synchronize()
    assert sum(sk.LAUNCHES.values()) == before + 1
    assert torch.equal(_flat_out(on_card), _flat_out(call(lambda t: t)))


def test_carried_kernels_chain_and_replay_on_card(cuda_device):
    """The automated comb (odd D, lane groups through the tensor map) and
    the all-pass chained over cuts off their delays' grid = one call; S1
    and S2 captured in a CUDA graph and replayed = the eager calls (the
    ticket words zeroed by a memset inside the graph)."""
    from groove_tpu_torch.ops import delayfx
    from groove_tpu_torch.ops import stream_kernels as sk

    rng = np.random.default_rng(21)
    S = 4 * 1927 * 12 + 300
    x = torch.from_numpy((rng.standard_normal((2, S)) * 0.3)
                         .astype(np.float32)).to(cuda_device)
    g = torch.from_numpy(rng.uniform(0.5, 0.9, S).astype(np.float32)).to(
        cuda_device)
    hz = torch.zeros(2, 1927, device=cuda_device)
    y, _, hy = sk.comb_stream(x, hz, hz, g)
    ya, hw = sk.allpass_stream(x, hz[:, :75], delayfx.ALLPASS_G)
    parts, partsa, hx2, hy2, hw2 = [], [], hz, hz, hz[:, :75]
    cuts = [0, 1000, 1000 + 4 * 1927 * 5 + 3, S - 77, S]
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        c, hx2, hy2 = sk.comb_stream(x[:, lo:hi], hx2, hy2, g[lo:hi])
        d, hw2 = sk.allpass_stream(x[:, lo:hi], hw2, delayfx.ALLPASS_G)
        parts.append(c)
        partsa.append(d)
    assert torch.equal(torch.cat(parts, 1), y) and torch.equal(hy2, hy)
    assert torch.equal(torch.cat(partsa, 1), ya) and torch.equal(hw2, hw)

    n = 64 * 300
    a = torch.from_numpy(rng.uniform(0.9, 0.999, n).astype(np.float32)).to(
        cuda_device)
    y0 = torch.tensor([0.1, 0.2], device=cuda_device)
    calls = lambda: (sk.scan_stream(x[:, :n].abs(), a, 1 - a, y0),  # noqa
                     sk.comb_stream(x, hz, hz, g))
    eager = calls()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = calls()
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(_flat_out(captured), _flat_out(eager))


@pytest.mark.parametrize("make, measures, bpm",
                         [(synth.kitchen_sink_project, 5, 120.0),
                          (synth.sidechain_project, 1, 240.0)],
                         ids=["kitchen-sink-10s", "sidechain-2s"])
def test_unsliced_stream_on_card_equals_cpu(cuda_device, tmp_path, make,
                                            measures, bpm):
    """A song streamed unsliced in 4096-frame segments on the card (the
    kitchen-sink analogue 10 s, the sidechain analogue 2 s): the planned
    launches, the CPU twins' render bit for bit, and the card's
    one-segment render bit for bit."""
    from groove_tpu_torch.ops import stream_kernels as sk

    assets = synth.write_assets(tmp_path, max_seconds=0.4)
    compiled = compile_song(SongSettings.from_json(make(measures, bpm)),
                            Paths(roots=[assets]))
    r = StreamingRenderer(compiled, cuda_device, segment_frames=4096)
    before = dict(sk.LAUNCHES)
    on_card = r.render(quantize=True)
    got = {k: v - before[k] for k, v in sk.LAUNCHES.items()
           if v != before[k]}
    assert got == {k: v for k, v in r.planned_launches().items()
                   if k in sk.LAUNCHES}
    assert np.array_equal(on_card, StreamingRenderer(
        compiled, "cpu", 4096).render(quantize=True))
    one = -(-compiled.n_frames // 64) * 64
    assert np.array_equal(on_card, StreamingRenderer(
        compiled, cuda_device, one).render(quantize=True))


# ---- live playback (engine/livesong.py, engine/live.py) ---------------------

@pytest.fixture(scope="module")
def live_assets(tmp_path_factory):
    return synth.write_live_assets(tmp_path_factory.mktemp("live"))


@pytest.fixture(scope="module")
def live_song(live_assets):
    return compile_song(SongSettings.from_json(synth.live_project(1)),
                        Paths(roots=[live_assets]))


@pytest.mark.parametrize("mode,block,seconds",
                         [("live", 64, 0.3), ("play", 64, 0.1),
                          ("live", 4096, 1.0), ("play", 4096, 1.0)])
def test_live_blocks_on_card_equal_cpu(cuda_device, live_song, mode, block,
                                       seconds):
    """The live analogue played by the scripted performance through
    LiveSongService (MIDI bytes through a pipe) on the card and on the
    CPU twins: bit for bit, and the card's launches = live_launches()."""
    from groove_tpu_torch.engine.livesong import LiveSongRenderer
    from groove_tpu_torch.ops import stream_kernels as sk

    sched = synth.block_schedule(synth.live_performance(seconds), block,
                                 int(seconds * 44100) // block)
    outs = []
    for device in (cuda_device, "cpu"):
        r = LiveSongRenderer(live_song, block_frames=block,
                             play_song=mode == "play", device=device)
        before = {**sk.LAUNCHES, **scan_kernels.LAUNCHES}
        outs.append(synth.play_live(r, sched))
        if str(device) != "cpu":
            got = {k: v - before[k] for k, v in {
                **sk.LAUNCHES, **scan_kernels.LAUNCHES}.items()
                if v != before[k]}
            plan = r.live_launches()
            assert got == {k: v * len(sched) for k, v in plan.items()
                           if k in before}
    assert np.abs(outs[1]).max() > 0.01
    np.testing.assert_array_equal(outs[0], outs[1])


def test_live_one_block_is_the_whole_performance_on_card(cuda_device,
                                                         live_assets):
    """Notes from frame 0 (offs later): 64 blocks of 64 frames = one block
    of 4096 on the card, bit for bit, and = the CPU twins' (the pad's
    noise off: it is keyed per block; the free-running oscillator muted:
    its phase origin is taken per block)."""
    from groove_tpu_torch.engine.livesong import FAR, LiveSongRenderer

    project = synth.live_project(1)
    pad = project["devices"][0]["instrument"][1]["welsh-raw"][1]
    pad.update({"noise": 0.0, "oscillator-2": {
        "waveform": "sine", "tune": {"float": 2.0}, "mix-pct": 0.8}})
    project["patch-cables"] = [c for c in project["patch-cables"]
                               if c[0] != "osc"]
    song = compile_song(SongSettings.from_json(project),
                        Paths(roots=[live_assets]))
    chord = [(0, 48), (0, 55), (1, 64), (2, 60), (9, 35), (9, 42), (3, 69)]
    offs = {48: 1024, 55: 2048, 64: 640, 60: 3008, 69: 1536}

    def small(device):
        r = LiveSongRenderer(song, device=device)
        for ch, key in chord:
            r.note_on(ch, key, 100)
        out = []
        for b in range(64):
            for ch, key in chord:
                if offs.get(key) == b * 64:
                    r.note_off(ch, key)
            out.append(r.render_block())
        return np.concatenate(out)

    big = LiveSongRenderer(song, block_frames=4096, device=cuda_device)
    for ch, key in chord:
        big.note_on(ch, key, 100)
    for u, pool in big._pools.items():
        for v in range(big.n_voices):
            k = int(pool["keys"][v])
            if pool["on"][v] < FAR and k in offs \
                    and song.devices[u].kind != "drumkit":
                pool["off"][v] = offs[k]
    whole = big.render_block()
    blocks = small(cuda_device)
    assert np.abs(whole).max() > 0.01
    np.testing.assert_array_equal(blocks, whole)
    np.testing.assert_array_equal(blocks, small("cpu"))


def test_live_welsh_voice_on_card_equals_cpu(cuda_device, tmp_path):
    """live_window_block (S3 for both sections, scan1 for the phases) and
    live_render_block through LiveSynth, card = CPU twins bit for bit,
    4 blocks of 64 = 1 block of 256."""
    from groove_tpu_torch.engine.live import LiveSynth
    from groove_tpu_torch.models import welsh
    from groove_tpu_torch.project.patches import WelshPatchSettings

    params = WelshPatchSettings.from_json_str(json.dumps(
        synth.LIVE_PAD)).derive_welsh_voice_params()
    rng = np.random.default_rng(0)
    keys = torch.from_numpy(rng.integers(40, 80, 8).astype(np.int32))
    vels = torch.from_numpy(rng.uniform(30, 127, 8).astype(np.float32))
    on = torch.tensor([0, 0, 0, 64, 64, 128, 2**30, 0], dtype=torch.int32)
    off = torch.full((8,), 2**30, dtype=torch.int32)
    off[0] = 200
    prev = keys.float() - 2.0
    outs = {}
    for device in (cuda_device, "cpu"):
        st = welsh.live_window_state_init(8, device)
        parts = []
        for b in range(6):
            m, st = welsh.live_window_block(
                params, st, keys.to(device), vels.to(device), on.to(device),
                off.to(device), 64 * b, 64, 44100.0,
                prev_keys=prev.to(device))
            parts.append(m.cpu())
        outs[str(device)] = torch.cat(parts)
    assert torch.equal(outs["cpu"], outs[str(cuda_device)])
    paths = Paths(roots=[synth.write_welsh_patches(
        tmp_path, {"pad": synth.LIVE_PAD})])
    synths = [LiveSynth("pad", n_voices=4, paths=paths, device=d)
              for d in (cuda_device, "cpu")]
    got = []
    for s in synths:
        s.note_on(60, 100)
        s.note_on(67, 90)
        blocks = [s.render_block() for _ in range(5)]
        s.note_off(60)
        blocks += [s.render_block() for _ in range(5)]
        got.append(np.concatenate(blocks))
    np.testing.assert_array_equal(got[0], got[1])


def test_s3_at_the_live_shape(cuda_device):
    """S3 at [8, 64] in BLOCK mode with state (one coefficient set a row,
    [8, 1]): kernel = twin bit for bit, chained calls = one call."""
    from groove_tpu_torch.ops import stream_kernels as sk

    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((8, 256)).astype(np.float32)
                         ).to(cuda_device)
    _, secs = iir.lp24_sections(
        torch.from_numpy(rng.uniform(200, 8000, (8, 4)).astype(np.float32)
                         ).to(cuda_device),
        torch.full((8, 4), 0.9, device=cuda_device), 44100.0)
    st = (torch.from_numpy(rng.standard_normal(8).astype(np.float32) * .1)
          .to(cuda_device), torch.zeros(8, device=cuda_device))
    sec = secs[0]
    first = tuple(c[:, :1] for c in sec)
    assert sk._coef_mode(first, 64) == iir_kernels.BLOCK
    y, s2 = sk.biquad_state(x[:, :64], first, st)
    yp, sp = sk.biquad_state_plain(x[:, :64], first, st)
    assert torch.equal(y, yp) and all(torch.equal(a, b)
                                      for a, b in zip(s2, sp))
    whole, sw = sk.biquad_state(x, sec, st)
    parts, s = [], st
    for b in range(4):
        yb, s = sk.biquad_state(x[:, 64 * b:64 * b + 64],
                                tuple(c[:, b:b + 1] for c in sec), s)
        parts.append(yb)
    assert torch.equal(torch.cat(parts, 1), whole)
    assert all(torch.equal(a, b) for a, b in zip(s, sw))


# ---- the engine service on the card (front ends) ---------------------------

def test_service_wav_is_render_quantized_on_card(cuda_device, tmp_path,
                                                 monkeypatch):
    """EngineService on the card: render-wav (the float render quantized on
    the host by io.wav) writes render_quantized's int16 (quantized on the
    device) byte for byte, which the CLI's --wav writes; no error event."""
    from groove_tpu_torch.engine.service import EngineService
    from groove_tpu_torch.io.wav import write_wav_16bit_stereo

    assets = synth.write_assets(tmp_path / "assets", max_seconds=0.4)
    monkeypatch.setenv("GROOVE_ASSETS", str(assets))
    song = synth.write_project(tmp_path / "ks.json",
                               synth.kitchen_sink_project(1))
    events = []
    svc = EngineService(on_event=lambda k, d: events.append((k, d)),
                        use_audio=False, device=cuda_device)
    try:
        svc.open_project(song)
        svc.render_wav(tmp_path / "service.wav")
        assert svc.sync()
        compiled = svc.ensure_compiled()
    finally:
        svc.shutdown()
    assert not [d for k, d in events if k == "error"], events
    q = Renderer(compiled, cuda_device).render_quantized()
    write_wav_16bit_stereo(tmp_path / "device.wav", q, 44100)
    assert (tmp_path / "service.wav").read_bytes() == \
        (tmp_path / "device.wav").read_bytes()
    assert np.abs(q).max() > 1000


def test_service_worker_render_equals_main_thread(cuda_device, tmp_path,
                                                  monkeypatch):
    """rendered_samples renders on the service's worker thread (its own
    current stream, the kernel library loaded there first): the master,
    one instrument alone and a loop bounce equal the same renders made on
    the main thread, bit for bit."""
    from groove_tpu_torch.engine.service import EngineService
    from groove_tpu_torch.kernels import build

    assets = synth.write_assets(tmp_path / "assets", max_seconds=0.4)
    monkeypatch.setenv("GROOVE_ASSETS", str(assets))
    song = synth.write_project(tmp_path / "ns.json",
                               synth.north_star_project(1))
    monkeypatch.setattr(build, "_lib", None)  # the worker loads it
    svc = EngineService(use_audio=False, device=cuda_device)
    try:
        svc.open_project(song)
        master = svc.rendered_samples()
        drums = svc.rendered_samples(device="drums")
        svc.set_loop(1.0, 3.0)
        looped = svc.rendered_samples(loop_iterations=2)
        compiled = svc.ensure_compiled()
    finally:
        svc.shutdown()
    r = Renderer(compiled, cuda_device)
    assert np.array_equal(master, r.render())
    alone = r._render_instrument(r.inputs, compiled.devices["drums"],
                                 compiled.n_frames)
    assert np.array_equal(drums, alone.cpu().numpy().T)
    want = np.concatenate(list(StreamingRenderer(compiled, cuda_device)
                               .stream_loop(1.0, 3.0, iterations=2)))
    assert np.array_equal(looped, want) and np.abs(master).max() > 0.05


# ---- the bounce's fetch into page-locked memory ----------------------------

@pytest.fixture(scope="module")
def kitchen_sink(tmp_path_factory):
    assets = synth.write_assets(tmp_path_factory.mktemp("ks-assets"),
                                max_seconds=0.4)
    return compile_song(SongSettings.from_json(synth.kitchen_sink_project(1)),
                        Paths(roots=[assets]))


def _bounce(r, quantized: bool):
    return r.render_quantized() if quantized else r.render()


@pytest.mark.parametrize("quantized", [True, False],
                         ids=["render_quantized", "render"])
def test_pinned_fetch_equals_the_pageable_read(cuda_device, kitchen_sink,
                                               quantized):
    """The fetch lands in page-locked memory and gives what
    y.cpu().numpy() gives, bit for bit, with its shape, dtype and
    strides."""
    from groove_tpu_torch.io.wav import quantize_16bit

    r = Renderer(kitchen_sink, cuda_device)
    out = _bounce(r, quantized)
    y = r.render_device()
    want = (quantize_16bit(y) if quantized else y).cpu().numpy()
    assert isinstance(out.base, torch.Tensor) and out.base.is_pinned()
    assert out.dtype == want.dtype == (np.int16 if quantized
                                       else np.float32)
    assert out.shape == want.shape == (kitchen_sink.n_frames, 2)
    assert out.strides == want.strides
    assert np.array_equal(out, want)


def test_pinned_fetches_are_arrays_of_their_own(cuda_device, kitchen_sink):
    """Three bounces held at once share no memory, and the first is
    unchanged after the third."""
    r = Renderer(kitchen_sink, cuda_device)
    first = r.render_quantized()
    kept = first.copy()
    second = r.render_quantized()
    third = r.render_quantized()
    for a, b in ((first, second), (first, third), (second, third)):
        assert not np.shares_memory(a, b)
    assert np.array_equal(first, kept)
    assert np.array_equal(second, kept) and np.array_equal(third, kept)
    assert np.abs(kept).max() > 1000


@pytest.mark.parametrize("quantized", [True, False],
                         ids=["render_quantized", "render"])
def test_pinned_fetch_counts_on_the_card(cuda_device, kitchen_sink,
                                         quantized):
    """Under recording() each bounce's fetch counts fetch_pinned 1,
    fetch_pageable 0 and the bounce one host sync."""
    from groove_tpu_torch.utils import profiling

    r = Renderer(kitchen_sink, cuda_device)
    _bounce(r, quantized)
    for _ in range(2):
        with profiling.recording() as rec:
            _bounce(r, quantized)
        spans = rec.closed()
        (fetch,) = [s for s in spans if s.name == "fetch"]
        assert fetch.counts.get("fetch_pinned") == 1
        assert fetch.counts.get("fetch_pageable", 0) == 0
        assert profiling.host_syncs(spans) == 1 and rec.orphans == {}


def test_fetch_falls_back_to_the_pageable_read(cuda_device, kitchen_sink,
                                               monkeypatch):
    """Where no page-locked memory can be had the card's bounce is read
    pageable, counted as fetch_pageable, with the same bits."""
    from groove_tpu_torch.engine import render as render_mod
    from groove_tpu_torch.utils import profiling

    r = Renderer(kitchen_sink, cuda_device)
    pinned = r.render_quantized()
    monkeypatch.setattr(render_mod, "_pinned_like", lambda y: None)
    with profiling.recording() as rec:
        out = r.render_quantized()
    (fetch,) = [s for s in rec.closed() if s.name == "fetch"]
    assert fetch.counts == {"fetch_pageable": 1, "host_syncs": 1}
    assert not (isinstance(out.base, torch.Tensor) and out.base.is_pinned())
    assert out.strides == pinned.strides and np.array_equal(out, pinned)
