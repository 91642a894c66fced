"""On-card smoke run of groove_tpu_torch: the offline render (drumkit ->
effect filters -> mix -> 16-bit WAV) and the segment-streamed render of
sliced Welsh voices on one CUDA device, through the hand-written kernels
K1 (drums), K2 (refined lp24), K3 (lp24, block-rate denominators), K6
(lp24, per-sample or static denominators), K4/K5/K9 (one biquad section
with block-rate, static or per-sample coefficients), the serial scan, and
K7/K8 (K3/K2 with carried state: the sliced Welsh cascades, one launch of
csrc/lp24_stream.cu per call).

    python3 chip_smoke.py

Phases, one JSON line each:
  1. environment: versions, device, nvidia-smi name and power limit;
  2. build: nvcc of groove_tpu_torch/csrc into one library under
     build/groove_tpu_torch, one process per source, all at once;
  3. kernels against their plain torch twins on the card, at the main
     path's shapes ([2, n] for 10 s of the songs; [64, 65536]): max
     difference (they must agree bit for bit, as the tests require) and
     median CUDA-event times of kernel and twin; then each kernel alone at
     the 3-minute songs' shapes, beside its bound. K7 and K8 are held
     to their twins on the inputs the sliced Welsh render gives them (one
     4096-frame segment of the 10-second Welsh analogue, with the carried
     state of that segment), at [64, 65536] from a carried state and at
     [12, 2 tiles + 192] (many shared-memory tiles, the last one short,
     row-broadcast coefficients), and two chained half calls must equal
     one call (y and state). At each of these shapes the one-launch kernel
     is also timed in turns with the earlier multi-launch route
     (ms, earlier_ms; they must agree bit for bit), beside the time of an
     empty kernel launched the same way (launch_floor_ms) and the
     kernel's device time (device_ms: a captured CUDA graph of 20 calls,
     replayed); a captured graph of one call must replay to the eager
     call's bits. K4, K5, K9, K2, K3 and K6 with static and with
     per-sample denominators (csrc/tiled.cuh's shared-memory tiles; K9's
     and per-sample K6's coefficients staged beside the tile) are held bit
     for bit to their twins and to their earlier multi-launch routes at
     the 10-second shape, at [64, 65536] and at [5, 32589] (n a multiple
     neither of the in-block length nor of a tile, coefficients broadcast
     through a zero stride), K5, K9 and per-sample K6 also on short rows
     at the in-block lengths 16 and 32, and timed in turns with the
     earlier routes there and at the 3-minute size
     (kernel_vs_earlier_route: ms, earlier_ms, and the card alone,
     device_ms and earlier_device_ms), a captured graph's replay equal to
     the eager call; per-sample K6 (a cutoff swept 60 Hz -> 15 kHz at q
     0.9) is held to its twin at the 3-minute size too. The chain
     walker's cycles per step come from an instrumented build
     (groove_tpu_torch/kernels/stage_cycles.py) at the 3-minute size.
     K1 (csrc/drums.cu's tiled, culled kernel) is also held
     to its twin on dense hits (every 64 frames, rows longer than a chunk:
     each tile's hit list overflows several times) at [2, 3 * 65536 + 64],
     and timed at the 3-minute size as a whole call (ms) and on the card
     alone from a captured graph (device_ms);
  4. the main path through the CLI (groove_tpu_torch.cli.main --wav
     --perf), each run with the launch counts set to 0 just before it and
     read just after: the 3-minute north-star analogue (K1 + K2), the same
     song with the cutoff kept above 2 kHz (K1 + K3), and the 3-minute
     filter-bank analogue (every route of the effect filters: K1, K5, K4,
     K4 twice for "refine", the serial scan, K6 and K3); then the ops entry
     points that no render path reaches, on the filter bank's output:
     iir.biquad_best with per-sample coefficients (K9) and iir.lp24_apply
     with a per-sample cutoff (K6, one launch); then the 3-minute
     Welsh analogue through the CLI's --stream --sliced at 4096-frame
     segments (every Welsh device sliced, K7 and K8 launched once per
     segment and bucket, as the renderer plans), and K7 and K8 alone on
     the inputs of one of its segments, beside their bounds. Render time,
     x realtime, peak device memory, WAV size and peak, launch counts;
  5. outputs: each 3-minute WAV's shape and peak; the north-star and
     high-sweep WAVs against the CPU render of the same song (the twins)
     bit for bit, and a 10-second filter-bank render through the CLI
     against the twins' (the serial scan's twin is a Python loop over
     time, too slow for 3 minutes on the CPU); the 10-second Welsh
     analogue streamed as one segment and as 4096-frame segments (bit
     for bit), and its card WAV against the CPU twins' stream.
Then the kernel summary line, the nvidia-smi line, and the result line.
Without a CUDA device it exits non-zero before printing any result.
Synthetic assets and outputs go to build/chip_smoke/ in this checkout.

Bounds: bound_ms is the largest of three times: the bytes a call must
move (inputs read once, outputs written once) over 3.35 TB/s; its
floating-point operations over 67 TFLOP/s (H100 SXM float32, NVIDIA's
data sheet); and the algorithm's serial dependency chain (chain_ms:
dependent float operations, 4 cycles each at the SM clock that
nvidia-smi reports as clocks.max.sm), which binds these few-row
recurrences. bound_by is "bytes" when the first binds, else "operations".
"""

import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

SONG_MEASURES = 90   # 3 minutes at 120 bpm
SONG_BPM = 120.0
CHECK_MEASURES = 5   # 10 s: the kernel-vs-twin shapes
WIDE = (64, 65536)   # many rows: the other kernel-vs-twin shape

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
DEPENDENT_OP_CYCLES = 4
SM_CLOCK_HZ = None  # nvidia-smi's clocks.max.sm, read in main()

# name -> (source, the TPU kernel or XLA scan it replaces)
KERNELS = {
    "drums": ("groove_tpu_torch/csrc/drums.cu",
              "groove_tpu/ops/pallas_drums.py:119"),
    "lp24_refined": ("groove_tpu_torch/csrc/lp24.cu",
                     "groove_tpu/ops/pallas_iir.py:1021"),
    "lp24": ("groove_tpu_torch/csrc/lp24.cu",
             "groove_tpu/ops/pallas_iir.py:661"),
    "lp24_cascade": ("groove_tpu_torch/csrc/lp24.cu",
                     "groove_tpu/ops/pallas_iir.py:561"),
    "biquad_blockrate": ("groove_tpu_torch/csrc/biquad.cu",
                         "groove_tpu/ops/pallas_iir.py:632"),
    "biquad_scalar": ("groove_tpu_torch/csrc/biquad.cu",
                      "groove_tpu/ops/pallas_iir.py:538"),
    "biquad_per_sample": ("groove_tpu_torch/csrc/biquad.cu",
                          "groove_tpu/ops/pallas_iir.py:513"),
    "biquad_serial": ("groove_tpu_torch/csrc/serial.cu",
                      "groove_tpu/ops/iir.py:213"),
    "lp24_stream": ("groove_tpu_torch/csrc/lp24_stream.cu",
                    "groove_tpu/ops/pallas_iir.py:448"),
    "lp24_refined_stream": ("groove_tpu_torch/csrc/lp24_stream.cu",
                            "groove_tpu/ops/pallas_iir.py:1082"),
}
KIND = {"lp24_refined": "K2", "lp24": "K3", "lp24_cascade": "K6",
        "biquad_blockrate": "K4", "biquad_scalar": "K5",
        "biquad_per_sample": "K9", "biquad_serial": "serial",
        "lp24_stream": "K7", "lp24_refined_stream": "K8"}
STREAM_KERNELS = ("lp24_stream", "lp24_refined_stream")
WELSH_SEGMENT = 4096  # the sliced render's segment (frames)
WELSH_AT = 40        # the segment of the 10-second song held to the twins

# launches per render of each song, by kernel (the route plan)
PER_RENDER = {
    "north-star": {"drums": 1, "lp24_refined": 1},
    "high-sweep": {"drums": 1, "lp24": 1},
    "filter-bank": {"drums": 1, "biquad_scalar": 1, "biquad_blockrate": 5,
                    "biquad_serial": 1, "lp24_cascade": 1, "lp24": 1},
}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def require(ok: bool, what: str) -> None:
    """Fail the run (non-zero exit, no result line) unless `ok`."""
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def cuda_ms(fn, reps: int, warmup: bool = True) -> tuple[float, object]:
    """Median CUDA-event milliseconds of `reps` calls (after one warm-up
    unless warmup is False) and the last result."""
    import torch

    out = fn() if warmup else None
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times), out


def bounds(nbytes: float, flops: float, chain_ops: float) -> dict:
    """The card's least time for the work: the largest of the bytes over
    the HBM rate, the operations over the float32 peak and the dependency
    chain's time."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / F32_FLOPS_PER_S * 1e3
    chain = chain_ops * DEPENDENT_OP_CYCLES / SM_CLOCK_HZ * 1e3
    return {"bytes": nbytes, "flops": flops, "chain_ops": chain_ops,
            "bytes_ms": by_bytes, "flops_ms": by_ops, "chain_ms": chain,
            "bound_ms": max(by_bytes, by_ops, chain),
            "bound_by": ("bytes" if by_bytes >= max(by_ops, chain)
                         else "operations")}


def compare(name, kernel_fn, plain_fn, peak_ref, work, reps=20,
            graph=False):
    """Time kernel and twin on the same card inputs; they must be equal.
    The twin runs once: it repeats the kernel's arithmetic as a loop of
    torch calls and measures launch overhead, not a competitor. A stream
    kernel returns (y, state'): both are compared. With `graph`, also the
    kernel's time on the card alone (device_ms, graph_ms)."""
    import torch

    ms, y = cuda_ms(kernel_fn, reps)
    extra = {"device_ms": graph_ms(kernel_fn)} if graph else {}
    plain_ms, y_plain = cuda_ms(plain_fn, 1, warmup=False)
    shape = list((y[0] if isinstance(y, tuple) else y).shape)
    if isinstance(y, tuple):
        y, y_plain = (torch.cat([t.reshape(-1) for t in v])
                      for v in (y, y_plain))
    err = float((y - y_plain).abs().max())
    peak = max(1.0, float(peak_ref))
    db = 20.0 * (torch.log10(torch.tensor(err / peak + 1e-30)).item())
    return {"name": name, "shape": shape, "max_abs_err": err,
            "err_dbfs": db, "bitwise": bool(torch.equal(y, y_plain)),
            "ms": ms, "plain_ms": plain_ms, **extra, **bounds(*work)}


def iir_work(kind: str, rows: int, n: int, coef_bytes: float,
             state_rows: int = 0) -> tuple:
    """(bytes, flops, chain ops) of one IIR kernel call on [rows, n]: x
    read and y written once, the coefficients once, a carried state
    [rows, state_rows] read and written once (K7, K8). Float operations
    per sample of one section: 13 in phase 1 and 5-6 in the combine (K2
    and K8 add 13 for the defect, 7 for the correction scan and 6 for its
    combine); per ln-block 8 in phase 2. A section's chain is 2 dependent
    operations per in-block step and 3 per phase-2 step; the serial
    scan's is 4 per sample (9 operations). K7 and K8 are K3 and K2 with
    ln pinned to 64. A cascade's chains can run as a wavefront along time
    (chain j needs its predecessor only up to the block it has reached),
    so the function's dependency chain is one chain of nb steps and every
    pass's in-block scans, whatever the row's length and however a
    kernel cuts it."""
    from groove_tpu_torch.ops.iir_kernels import CBLOCK, geometry

    io = 2.0 * rows * n * 4 + coef_bytes + 2.0 * rows * state_rows * 4
    if kind == "serial":
        return io, 9.0 * rows * n, 4.0 * n
    if kind in ("K7", "K8"):
        ln, nb = CBLOCK, n // CBLOCK
    else:
        ln, nb, _ = geometry(n, blockrate=kind in ("K2", "K3", "K4"))
    per_sample = {"K4": 19, "K5": 19, "K9": 19, "K3": 36, "K6": 36,
                  "K2": 88, "K7": 36, "K8": 88}[kind]
    passes = (2 if kind in ("K2", "K3", "K6", "K7", "K8") else 1) \
        * (2 if kind in ("K2", "K8") else 1)
    flops = rows * (per_sample * n + 8 * nb * passes)
    chain = 2 * ln * passes + 3 * nb
    return io, float(flops), float(chain)


def coef_bytes(coefs) -> float:
    """Bytes of the distinct coefficient values a call reads (a row
    broadcast with stride 0 counts once; by-value scalars count 0)."""
    import torch

    total = 0.0
    for c in coefs:
        if torch.is_tensor(c) and c.dim() > 0:
            total += float((c if c.stride()[0] else c[0]).numel() * 4)
    return total


def iir_call_work(name: str, x, coefs) -> tuple:
    from groove_tpu_torch.ops.iir_kernels import STATE_ROWS

    flat = ([c for sec in coefs for c in sec[3:]] if name.startswith("lp24")
            else list(coefs))
    return iir_work(KIND[name], x.shape[0], x.shape[-1], coef_bytes(flat),
                    STATE_ROWS.get(name, 0))


class Capture:
    """While active, keeps copies of the arguments (x, sections, state) of
    call number `at` (from 0) of each stream kernel, so that the kernels
    can be rerun alone and against their twins on the render's own
    inputs. The wrappers call the kernels as they are, counts included."""

    def __init__(self, at: int):
        self.at = at
        self.calls = dict.fromkeys(STREAM_KERNELS, 0)
        self.args: dict = {}

    def __enter__(self):
        from groove_tpu_torch.ops import iir_kernels

        self.saved = {k: getattr(iir_kernels, wrapper(k))
                      for k in STREAM_KERNELS}
        for k, fn in self.saved.items():
            setattr(iir_kernels, wrapper(k), self._wrap(k, fn))
        return self

    def _wrap(self, key, fn):
        def call(x, sections, state):
            if self.calls[key] == self.at:
                self.args[key] = (
                    x.clone(), [tuple(c.contiguous().clone() for c in sec)
                                for sec in sections], state.clone())
            self.calls[key] += 1
            return fn(x, sections, state)
        return call

    def __exit__(self, *exc):
        from groove_tpu_torch.ops import iir_kernels

        for k, fn in self.saved.items():
            setattr(iir_kernels, wrapper(k), fn)


def wrapper(key: str) -> str:
    """The ops/iir_kernels wrapper of a stream kernel's launch count."""
    return {"lp24_stream": "lp24_blockrate_stream",
            "lp24_refined_stream": "lp24_refined_blockrate_stream"}[key]


def stream_twin(key: str, x, sections, state):
    """The stream kernel's plain twin on the same (card) inputs."""
    from groove_tpu_torch.ops import iir_kernels

    x2, den, st = iir_kernels.stream_args(
        x, sections, state, iir_kernels.STATE_ROWS[key])
    plain = (iir_kernels.lp24_refined_blockrate_stream_plain
             if key == "lp24_refined_stream"
             else iir_kernels.lp24_blockrate_stream_plain)
    return plain(x2, *(-d for d in den), st)


def in_turns(fn_a, fn_b, reps: int) -> tuple:
    """Median CUDA-event milliseconds of two functions timed in turns (a,
    b, b, a; `reps` calls a turn) on the same card in the same run, and
    their last results."""
    ta1, out_a = cuda_ms(fn_a, reps)
    tb1, out_b = cuda_ms(fn_b, reps)
    tb2, _ = cuda_ms(fn_b, reps)
    ta2, _ = cuda_ms(fn_a, reps)
    return (ta1 + ta2) / 2.0, (tb1 + tb2) / 2.0, out_a, out_b


GRAPH_CALLS = 20  # calls in the captured graph that times the device alone


def stream_kernel_check(key: str, x, sections, state) -> dict:
    """The one-launch stream kernel beside the earlier multi-launch route
    on the same inputs: both timed in turns as whole wrapper calls, equal
    bit for bit (y and state); an empty kernel launched the same way; a
    captured CUDA graph of one call, replayed, equal to the eager call;
    and the kernel's device time from a captured graph of GRAPH_CALLS
    calls."""
    import torch
    from groove_tpu_torch.ops import iir_kernels

    kern = getattr(iir_kernels, wrapper(key))
    refined = key == "lp24_refined_stream"
    ms, earlier_ms, new, old = in_turns(
        lambda: kern(x, sections, state),
        lambda: iir_kernels._stream_earlier(refined, x, sections, state), 20)
    floor_ms, _ = cuda_ms(lambda: iir_kernels.launch_floor(x.device), 50)
    one = torch.cuda.CUDAGraph()
    with torch.cuda.graph(one):
        y_g, st_g = kern(x, sections, state)
    y_g.zero_()
    st_g.zero_()
    one.replay()
    torch.cuda.synchronize()
    many = torch.cuda.CUDAGraph()
    with torch.cuda.graph(many):
        for _ in range(GRAPH_CALLS):
            kern(x, sections, state)
    graph_ms, _ = cuda_ms(many.replay, 10)
    return {"name": key, "shape": list(x.shape), "ms": ms,
            "earlier_ms": earlier_ms, "launch_floor_ms": floor_ms,
            "device_ms": graph_ms / GRAPH_CALLS,
            "equals_earlier_route": all(
                torch.equal(a, b) for a, b in zip(new, old)),
            "graph_replay_equals_eager": bool(
                torch.equal(y_g, new[0]) and torch.equal(st_g, new[1])),
            **bounds(*iir_call_work(key, x, sections))}


TILED = {"biquad_blockrate": "K4", "biquad_scalar": "K5",
         "biquad_per_sample": "K9", "lp24_refined": "K2", "lp24": "K3",
         "lp24_cascade": "K6"}
ODD = (5, 2 * 127 * 128 + 77)  # rows, n: no multiple of 128 nor of a tile


def graph_ms(fn, reps: int = 5) -> float:
    """Milliseconds of one call of `fn` on the card alone: a captured CUDA
    graph of GRAPH_CALLS calls, replayed `reps` times (median), over
    GRAPH_CALLS. `fn` has run eagerly before."""
    import torch

    many = torch.cuda.CUDAGraph()
    with torch.cuda.graph(many):
        for _ in range(GRAPH_CALLS):
            fn()
    ms = cuda_ms(many.replay, reps)[0] / GRAPH_CALLS
    del many
    return ms


def coefficient_mode(name: str, coefs) -> str:
    """How a tiled kernel call takes its coefficients: "static" (by value),
    "block" (one set per 64 frames) or "per-sample"."""
    from groove_tpu_torch.ops.iir_kernels import is_scalar

    if name in ("biquad_blockrate", "lp24_refined", "lp24"):
        return "block"
    flat = [c for sec in coefs for c in sec[3:]] \
        if name == "lp24_cascade" else list(coefs)
    return "static" if all(is_scalar(c) for c in flat) else "per-sample"


def tiled_kernel_check(name: str, x, coefs) -> dict:
    """K4, K5, K9, K2, K3 or K6 beside its earlier multi-launch route on
    the same inputs: both timed in turns as whole wrapper calls, equal bit
    for bit; a captured CUDA graph of one call, replayed on a changed
    input, equal to the eager call; the device time of each route from a
    captured graph of GRAPH_CALLS calls (device_ms, earlier_device_ms)."""
    import torch
    from groove_tpu_torch.ops import biquad_kernels as bk
    from groove_tpu_torch.ops import iir_kernels

    kern, earlier = {
        "biquad_blockrate": (bk.biquad_blockrate, bk._blockrate_earlier),
        "biquad_scalar": (bk.biquad_scalar, lambda a, c: bk._launch(
            *bk._prepare(a, c, bk.SCALAR))),
        "biquad_per_sample": (bk.biquad_per_sample, bk._per_sample_earlier),
        "lp24_refined": (iir_kernels.lp24_refined_blockrate,
                         iir_kernels._refined_earlier),
        "lp24": (iir_kernels.lp24_blockrate,
                 lambda a, c: iir_kernels._cascade_earlier(a, c, True)),
        "lp24_cascade": (iir_kernels.lp24_cascade,
                         lambda a, c: iir_kernels._cascade_earlier(a, c,
                                                                   False))
    }[name]
    ms, earlier_ms, new, old = in_turns(lambda: kern(x, coefs),
                                        lambda: earlier(x, coefs), 10)
    xg = x.clone()
    one = torch.cuda.CUDAGraph()
    with torch.cuda.graph(one):
        y_g = kern(xg, coefs)
    xg.mul_(0.5)
    one.replay()
    torch.cuda.synchronize()
    y_half = kern(xg, coefs)
    device = [graph_ms(lambda f=fn: f(x, coefs)) for fn in (kern, earlier)]
    return {"name": name, "coefficients": coefficient_mode(name, coefs),
            "shape": list(x.shape), "ms": ms,
            "earlier_ms": earlier_ms, "device_ms": device[0],
            "earlier_device_ms": device[1],
            "equals_earlier_route": bool(torch.equal(new, old)),
            "graph_replay_equals_eager": bool(
                torch.equal(y_g, y_half) and not torch.equal(y_half, new)),
            **bounds(*iir_call_work(name, x, coefs))}


def chains(key: str, x, sections, state) -> bool:
    """Two chained half calls equal one call, y and state."""
    import torch
    from groove_tpu_torch.ops import iir_kernels

    fn = getattr(iir_kernels, wrapper(key))
    h = x.shape[-1] // 2
    y, st = fn(x, sections, state)
    ya, sa = fn(x[:, :h].contiguous(),
                [tuple(c[:, :h // 64] for c in s) for s in sections], state)
    yb, sb = fn(x[:, h:].contiguous(),
                [tuple(c[:, h // 64:] for c in s) for s in sections], sa)
    return bool(torch.equal(torch.cat([ya, yb], 1), y)
                and torch.equal(sb, st))


def drum_work(hits, n: int) -> tuple:
    """(bytes, flops, chain ops) of one K1 call on `hits` (the table and
    the prepare_hits arrays, as the kernel takes them): the table and hit
    lists read once, [2, n] written once; a multiply and an add per
    channel for every sample of every hit that lands in the timeline."""
    import numpy as np

    from groove_tpu_torch.ops.drums import CHUNK

    _, counts, _, starts, shifts, limits, _ = (t.cpu().numpy() for t in hits)
    listed = np.arange(limits.shape[1])[None, :] < counts[:, None]
    on = (np.arange(len(counts), dtype=np.int64)[:, None] * CHUNK + starts
          + 64 * shifts.astype(np.int64))
    span = np.clip(np.minimum(limits, n - on), 0, None)
    nbytes = 2.0 * n * 4 + sum(float(t.numel() * t.element_size())
                               for t in hits)
    return nbytes, 4.0 * float(span[listed].sum()), 0.0


def dense_hits(n: int, device) -> list:
    """Hits every 64 frames over rows longer than a 65536-frame chunk (a
    fifth gated short), from numpy seed 0: some 1,000 hits cover each
    2048-frame tile, so its list overflows several times."""
    import numpy as np
    import torch

    from groove_tpu_torch.ops import drums

    rng = np.random.default_rng(0)
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
    return [torch.from_numpy(a).to(device)
            for a in (drums.prepare_table(table), *meta)]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from groove_tpu_torch import cli
    from groove_tpu_torch.compiler.song import compile_song
    import numpy as np

    from groove_tpu_torch.engine.render import Renderer
    from groove_tpu_torch.engine.stream import StreamingRenderer
    from groove_tpu_torch.io.wav import read_wav
    from groove_tpu_torch.kernels import build
    from groove_tpu_torch.ops import biquad_kernels as bk
    from groove_tpu_torch.ops import drums, iir_kernels
    from groove_tpu_torch.ops import iir as tiir
    from groove_tpu_torch.project.paths import Paths
    from groove_tpu_torch.project.schema import SongSettings
    from groove_tpu_torch.testing import synth

    global SM_CLOCK_HZ
    dev = torch.device("cuda", 0)

    def smi(query: str) -> str:
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
            timeout=60).stdout.strip().splitlines()[0]

    name_power = smi("name,power.limit")
    clock = smi("clocks.max.sm")
    require(clock.endswith(" MHz") and clock.split()[0].isdigit(),
            f"nvidia-smi clocks.max.sm reads {clock!r}")
    SM_CLOCK_HZ = float(clock.split()[0]) * 1e6
    emit("environment", python=sys.version.split()[0],
         torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=name_power,
         max_sm_clock_hz=SM_CLOCK_HZ)

    info = build.build()
    build.library()
    ptxas = [ln.strip() for ln in info["log"].splitlines()
             if "registers" in ln]
    emit("build", seconds=info["seconds"], library=info["path"],
         ptxas=ptxas)

    work = ROOT / "build" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    assets = synth.write_assets(work / "assets")
    paths = Paths(roots=[assets])
    counters = (drums.LAUNCHES, iir_kernels.LAUNCHES, bk.LAUNCHES)

    def launches() -> dict:
        return {k: v for c in counters for k, v in c.items()}

    def zero_launches() -> None:
        for c in counters:
            for k in c:
                c[k] = 0

    def renderer(project, measures: int):
        song = SongSettings.from_json(project(measures, SONG_BPM))
        return Renderer(compile_song(song, paths), device=dev)

    def drum_bus(r):
        hits = [r.inputs[f"drums/{k}"] for k in (
            "ptable", "hcounts", "hslots", "hstarts", "hshifts", "hlimits",
            "hvels")]
        return hits, drums.accumulate_hits(*hits, n_frames=r.c.n_frames)

    def lp24_inputs(r, bus):
        """The north-star filter's input and block-rate sections, as the
        Renderer hands them to K2/K3."""
        x = bus * tiir.upsample_hold(r.inputs["low-pass-1/fc/gain"],
                                     r.c.n_frames)
        fs = r.inputs["low-pass-1/fc/secs"]
        return x, [tuple(fs[i, j].expand(2, -1) for j in range(5))
                   for i in range(2)]

    def sweep(n: int, rows: int = 0):
        """Per-sample low-pass coefficients, 200 Hz -> 12 kHz (K9); with
        rows, each a [rows, n] row broadcast (stride 0)."""
        co = tiir.rbj_low_pass(
            torch.logspace(2.3, 4.08, n, dtype=torch.float64).float()
            .to(dev), 0.707, 44100.0)
        return tuple(c.expand(rows, -1) for c in co) if rows else co

    def lp24_sweep(x):
        """x times the gain of, and the sections of, an lp24 whose cutoff
        sweeps 60 Hz -> 15 kHz at q 0.9 over x's length (K6's per-sample
        mode), each coefficient a [rows, n] row broadcast (stride 0)."""
        rows, n = x.shape
        cut = torch.from_numpy(np.geomspace(60.0, 15000.0, n)
                               .astype(np.float32)).to(dev)
        gain, secs = tiir.lp24_sections(cut, 0.9, 44100.0)
        return x * gain, [tuple(c.expand(rows, -1) for c in sec)
                          for sec in secs]

    def per_sample(res: dict) -> dict:
        return {**res, "coefficients": "per-sample"}

    def bank_calls(r, bus):
        """name -> (kernel, twin, x, coefficients): each filter-bank route's
        kernel with the input and coefficients the render gives it, and
        K9 with a per-sample sweep."""
        sr = float(r.c.sample_rate)
        bank = synth.FILTER_BANK
        peq, hp, lp = (bank[u][1] for u in ("peq", "hp40", "lp24-8k"))
        co = r.inputs["bp-sweep/fc/coefs"]
        gain, secs = tiir.lp24_sections(lp["cutoff"], lp["passband-ripple"],
                                        sr)
        return {
            "biquad_scalar": (bk.biquad_scalar, bk.biquad_scalar_plain, bus,
                              tiir.rbj_peaking_eq(peq["cutoff"], peq["q"],
                                                  peq["db-gain"], sr)),
            "biquad_blockrate": (bk.biquad_blockrate,
                                 bk.biquad_blockrate_plain, bus,
                                 tuple(co[j].expand(2, -1)
                                       for j in range(5))),
            "biquad_serial": (bk.biquad_serial, bk.biquad_serial_plain, bus,
                              tiir.rbj_high_pass(hp["cutoff"], hp["q"], sr)),
            "lp24_cascade": (iir_kernels.lp24_cascade,
                             iir_kernels.lp24_cascade_plain,
                             bus * float(gain), secs),
            "biquad_per_sample": (bk.biquad_per_sample,
                                  bk.biquad_per_sample_plain, bus,
                                  sweep(bus.shape[-1])),
        }

    # ---- 3. kernels vs twins at the main path's shapes --------------------
    results = []
    r = renderer(synth.north_star_project, CHECK_MEASURES)
    hits, bus = drum_bus(r)
    n = r.c.n_frames
    results.append(compare(
        "drums", lambda: drums.accumulate_hits(*hits, n_frames=n),
        lambda: drums.accumulate_hits_plain(*hits, n_frames=n),
        bus.abs().max(), drum_work(hits, n), graph=True))
    nd = 3 * drums.CHUNK + 64
    dense = dense_hits(nd, dev)
    results.append(compare(
        "drums", lambda: drums.accumulate_hits(*dense, n_frames=nd),
        lambda: drums.accumulate_hits_plain(*dense, n_frames=nd), 1.0,
        drum_work(dense, nd), graph=True))
    del dense
    x, secs = lp24_inputs(r, bus)
    twins = (("lp24_refined", iir_kernels.lp24_refined_blockrate,
              iir_kernels.lp24_refined_blockrate_plain),
             ("lp24", iir_kernels.lp24_blockrate,
              iir_kernels.lp24_blockrate_plain))
    x2, den = iir_kernels._prepare(x, secs, 64)
    for name, kern, plain in twins:
        results.append(compare(name, lambda k=kern: k(x, secs),
                               lambda p=plain: p(x2, *den), x.abs().max(),
                               iir_call_work(name, x, secs)))
    rb = renderer(synth.filter_bank_project, CHECK_MEASURES)
    _, bus_b = drum_bus(rb)
    for name, (kern, plain, xb, co) in bank_calls(rb, bus_b).items():
        results.append(compare(name, lambda k=kern, a=xb, c=co: k(a, c),
                               lambda p=plain, a=xb, c=co: p(a, c),
                               xb.abs().max(), iir_call_work(name, xb, co)))
    # the refine route's first solve: static coefficients held per block
    q20 = synth.FILTER_BANK["lp12-q20"][1]
    held = tuple(torch.full((2, -(-n // 64)), float(c), device=dev)
                 for c in tiir.rbj_low_pass(q20["cutoff"], q20["q"],
                                            float(rb.c.sample_rate)))
    results.append(compare(
        "biquad_blockrate", lambda: bk.biquad_blockrate(bus_b, held),
        lambda: bk.biquad_blockrate_plain(bus_b, held), bus_b.abs().max(),
        iir_call_work("biquad_blockrate", bus_b, held)))
    bank = bank_calls(rb, bus_b)
    xps, ps = lp24_sweep(bus_b)
    results.append(per_sample(compare(
        "lp24_cascade", lambda: iir_kernels.lp24_cascade(xps, ps),
        lambda: iir_kernels.lp24_cascade_plain(xps, ps), xps.abs().max(),
        iir_call_work("lp24_cascade", xps, ps))))
    tiled_checks = [
        tiled_kernel_check("lp24_refined", x, secs),
        tiled_kernel_check("biquad_blockrate", bus_b,
                           bank["biquad_blockrate"][3]),
        tiled_kernel_check("biquad_scalar", *bank["biquad_scalar"][2:]),
        tiled_kernel_check("biquad_per_sample",
                           *bank["biquad_per_sample"][2:]),
        tiled_kernel_check("lp24", x, secs),
        tiled_kernel_check("lp24_cascade", *bank["lp24_cascade"][2:]),
        tiled_kernel_check("lp24_cascade", xps, ps)]
    del r, rb, hits, bus, bus_b, x, secs, x2, den, held, bank, xps, ps

    # [64, 65536]: many rows through sweeps that rest near 25 Hz
    g = torch.Generator().manual_seed(0)
    rows, nn = WIDE
    t = torch.linspace(0.0, 1.0, nn // 64, dtype=torch.float64) ** 3
    cut_b = (25.0 * 800.0 ** t).float()
    gain_w, secs_w = tiir.lp24_sections(cut_b.numpy(), 0.707, 44100.0)
    xw = (torch.randn(rows, nn, generator=g) * 0.3).to(dev)
    xg = xw * tiir.upsample_hold(torch.from_numpy(gain_w).to(dev), nn)
    sw = [tuple(torch.from_numpy(c).to(dev).expand(rows, -1) for c in sec)
          for sec in secs_w]
    xw2, denw = iir_kernels._prepare(xg, sw, 64)
    for name, kern, plain in twins:
        results.append(compare(name, lambda k=kern: k(xg, sw),
                               lambda p=plain: p(xw2, *denw),
                               xg.abs().max(), iir_call_work(name, xg, sw)))
    _, lp8k = tiir.lp24_sections(8000.0, 0.707, 44100.0)
    wide = (("biquad_blockrate", bk.biquad_blockrate,
             bk.biquad_blockrate_plain,
             tuple(c.to(dev).expand(rows, -1) for c in
                   tiir.rbj_low_pass(cut_b.to(dev), 0.707, 44100.0))),
            ("biquad_scalar", bk.biquad_scalar, bk.biquad_scalar_plain,
             tiir.rbj_peaking_eq(1000.0, 1.5, 6.0, 44100.0)),
            ("biquad_per_sample", bk.biquad_per_sample,
             bk.biquad_per_sample_plain, sweep(nn)),
            ("biquad_serial", bk.biquad_serial, bk.biquad_serial_plain,
             tiir.rbj_high_pass(40.0, 0.707, 44100.0)),
            ("lp24_cascade", iir_kernels.lp24_cascade,
             iir_kernels.lp24_cascade_plain, lp8k))
    for name, kern, plain, co in wide:
        results.append(compare(name, lambda k=kern, c=co: k(xw, c),
                               lambda p=plain, c=co: p(xw, c),
                               xw.abs().max(), iir_call_work(name, xw, co)))
    xwp, psw = lp24_sweep(xw)
    results.append(per_sample(compare(
        "lp24_cascade", lambda: iir_kernels.lp24_cascade(xwp, psw),
        lambda: iir_kernels.lp24_cascade_plain(xwp, psw), xwp.abs().max(),
        iir_call_work("lp24_cascade", xwp, psw))))
    # K5, K9 and per-sample K6 on short rows: the in-block lengths 16
    # (n <= 256) and 32 (<= 1024)
    peq = wide[1][3]
    short = [xw[:4, :k].contiguous() for k in (200, 1000)]
    short_ps = [(xs, sweep(xs.shape[1], 4), *lp24_sweep(xs)) for xs in short]
    for xs in short:
        results.append(compare(
            "biquad_scalar", lambda a=xs: bk.biquad_scalar(a, peq),
            lambda a=xs: bk.biquad_scalar_plain(a, peq), xs.abs().max(),
            iir_call_work("biquad_scalar", xs, peq)))
    for xs, co9, xsp, pss in short_ps:
        results.append(compare(
            "biquad_per_sample", lambda a=xs, c=co9: bk.biquad_per_sample(a, c),
            lambda a=xs, c=co9: bk.biquad_per_sample_plain(a, c),
            xs.abs().max(), iir_call_work("biquad_per_sample", xs, co9)))
        results.append(per_sample(compare(
            "lp24_cascade",
            lambda a=xsp, c=pss: iir_kernels.lp24_cascade(a, c),
            lambda a=xsp, c=pss: iir_kernels.lp24_cascade_plain(a, c),
            xsp.abs().max(), iir_call_work("lp24_cascade", xsp, pss))))
    # the tiled kernels beside their earlier routes at [64, 65536], and at
    # ODD with the row-broadcast (stride 0) coefficient views
    orows, on = ODD
    xo = xg[:orows, :on].contiguous()
    so = [tuple(c[:orows, :-(-on // 64)] for c in sec) for sec in sw]
    co = tuple(c[:orows, :-(-on // 64)] for c in wide[0][3])
    co9 = sweep(on, orows)
    xop, pso = lp24_sweep(xw[:orows, :on].contiguous())
    require(so[0][3].stride(0) == 0 and co[0].stride(0) == 0
            and co9[0].stride(0) == 0 and pso[0][3].stride(0) == 0,
            "the odd shape's coefficients are not broadcast views")
    xo2, deno = iir_kernels._prepare(xo, so, 64)
    results.append(compare(
        "lp24_refined", lambda: iir_kernels.lp24_refined_blockrate(xo, so),
        lambda: iir_kernels.lp24_refined_blockrate_plain(xo2, *deno),
        xo.abs().max(), iir_call_work("lp24_refined", xo, so)))
    results.append(compare(
        "biquad_blockrate", lambda: bk.biquad_blockrate(xo, co),
        lambda: bk.biquad_blockrate_plain(xo, co), xo.abs().max(),
        iir_call_work("biquad_blockrate", xo, co)))
    results.append(compare(
        "lp24", lambda: iir_kernels.lp24_blockrate(xo, so),
        lambda: iir_kernels.lp24_blockrate_plain(xo2, *deno),
        xo.abs().max(), iir_call_work("lp24", xo, so)))
    results.append(compare(
        "lp24_cascade", lambda: iir_kernels.lp24_cascade(xo, lp8k),
        lambda: iir_kernels.lp24_cascade_plain(xo, lp8k), xo.abs().max(),
        iir_call_work("lp24_cascade", xo, lp8k)))
    results.append(compare(
        "biquad_scalar", lambda: bk.biquad_scalar(xo, peq),
        lambda: bk.biquad_scalar_plain(xo, peq), xo.abs().max(),
        iir_call_work("biquad_scalar", xo, peq)))
    results.append(compare(
        "biquad_per_sample", lambda: bk.biquad_per_sample(xo, co9),
        lambda: bk.biquad_per_sample_plain(xo, co9), xo.abs().max(),
        iir_call_work("biquad_per_sample", xo, co9)))
    results.append(per_sample(compare(
        "lp24_cascade", lambda: iir_kernels.lp24_cascade(xop, pso),
        lambda: iir_kernels.lp24_cascade_plain(xop, pso), xop.abs().max(),
        iir_call_work("lp24_cascade", xop, pso))))
    tiled_checks += [
        tiled_kernel_check("lp24_refined", xg, sw),
        tiled_kernel_check("biquad_blockrate", xw, wide[0][3]),
        tiled_kernel_check("biquad_scalar", xw, peq),
        tiled_kernel_check("biquad_per_sample", xw, wide[2][3]),
        tiled_kernel_check("lp24", xg, sw),
        tiled_kernel_check("lp24_cascade", xw, lp8k),
        tiled_kernel_check("lp24_cascade", xwp, psw),
        tiled_kernel_check("lp24_refined", xo, so),
        tiled_kernel_check("biquad_blockrate", xo, co),
        tiled_kernel_check("biquad_scalar", xo, peq),
        tiled_kernel_check("biquad_per_sample", xo, co9),
        tiled_kernel_check("lp24", xo, so),
        tiled_kernel_check("lp24_cascade", xo, lp8k),
        tiled_kernel_check("lp24_cascade", xop, pso),
        *(tiled_kernel_check("biquad_scalar", xs, peq) for xs in short),
        *(check for xs, co9s, xsp, pss in short_ps for check in (
            tiled_kernel_check("biquad_per_sample", xs, co9s),
            tiled_kernel_check("lp24_cascade", xsp, pss)))]
    del xo, so, co, xo2, deno, short, co9, xop, pso, short_ps, xwp, psw
    # K7 and K8 at [64, 65536] from the state a first call carries out
    # and at [12, 2 tiles + 192]: many shared-memory tiles, the last one
    # short, the coefficients still the row-broadcast (stride 0) views
    chained = {}
    beside_earlier = []
    tiles_n = 2 * iir_kernels.STREAM_TILE + 192
    xt = xg[:12, :tiles_n].contiguous()
    st_t = [tuple(c[:12, :tiles_n // 64] for c in sec) for sec in sw]
    for key in STREAM_KERNELS:
        kern = getattr(iir_kernels, wrapper(key))
        zero = torch.zeros((rows, iir_kernels.STATE_ROWS[key]), device=dev)
        _, st_w = kern(xg, sw, zero)
        carried = st_w[:12].contiguous()
        for a, co, st in ((xg, sw, st_w), (xt, st_t, carried)):
            results.append(compare(
                key, lambda k=kern, v=(a, co, st): k(*v),
                lambda k=key, v=(a, co, st): stream_twin(k, *v),
                a.abs().max(), iir_call_work(key, a, co)))
            beside_earlier.append(stream_kernel_check(key, a, co, st))
        chained[(key, tuple(xg.shape))] = chains(key, xg, sw, st_w)
    del xt, st_t
    del xw, xg, xw2, denw, sw, wide

    # K7 and K8 on the sliced Welsh render's own inputs: segment WELSH_AT
    # of the 10-second Welsh analogue streamed at 4096-frame segments,
    # with the state carried into that segment
    sliced = type("SlicedStreamingRenderer", (StreamingRenderer,),
                  {"WELSH_SLICED": True})
    welsh10 = compile_song(SongSettings.from_json(
        synth.welsh_project(CHECK_MEASURES, SONG_BPM)), paths)
    with Capture(at=WELSH_AT) as cap:
        welsh10_q = sliced(welsh10, dev, WELSH_SEGMENT).render(quantize=True)
    for key in STREAM_KERNELS:
        x, secs, st = cap.args[key]
        kern = getattr(iir_kernels, wrapper(key))
        results.insert(0, compare(
            key, lambda k=kern, a=(x, secs, st): k(*a),
            lambda k=key, a=(x, secs, st): stream_twin(k, *a),
            x.abs().max(), iir_call_work(key, x, secs)))
        chained[(key, tuple(x.shape))] = chains(key, x, secs, st)
        beside_earlier.insert(0, stream_kernel_check(key, x, secs, st))
    del cap, x, secs, st
    for res in beside_earlier:
        emit("stream_kernel_vs_earlier_route", **res)
        require(res["equals_earlier_route"], f"{res['name']} differs from "
                f"the earlier route at {res['shape']}")
        require(res["graph_replay_equals_eager"], f"{res['name']}: a "
                f"captured graph's replay differs at {res['shape']}")
    for (key, shape), ok in chained.items():
        emit("chained_calls", name=key, shape=list(shape), equal_to_one_call=ok)
        require(ok, f"{key}: chained half calls differ from one call at "
                f"{shape}")
    main_shape = {}  # each kernel at the main path's shape: its first result
    for res in results:
        main_shape.setdefault(res["name"], res)
    for res in results:
        emit("kernel_vs_twin", **res)
        require(res["bitwise"], f"{res['name']} differs from its twin "
                f"at {res['shape']}")

    # each kernel alone at the 3-minute songs' shapes
    r = renderer(synth.north_star_project, SONG_MEASURES)
    hits, bus = drum_bus(r)
    n = r.c.n_frames
    x, secs = lp24_inputs(r, bus)
    alone = [("drums", lambda: drums.accumulate_hits(*hits, n_frames=n),
              drum_work(hits, n)),
             ("lp24_refined",
              lambda: iir_kernels.lp24_refined_blockrate(x, secs),
              iir_call_work("lp24_refined", x, secs)),
             ("lp24", lambda: iir_kernels.lp24_blockrate(x, secs),
              iir_call_work("lp24", x, secs))]
    rb = renderer(synth.filter_bank_project, SONG_MEASURES)
    _, bus_b = drum_bus(rb)
    for name, (kern, _, xb, co) in bank_calls(rb, bus_b).items():
        alone.append((name, lambda k=kern, a=xb, c=co: k(a, c),
                      iir_call_work(name, xb, co)))
    for name, fn, wk in alone:
        ms, _ = cuda_ms(fn, 5)
        # K1 on the card alone too (the tiled kernels' device_ms is in
        # their kernel_vs_earlier_route lines)
        extra = {"device_ms": graph_ms(fn)} if name == "drums" else {}
        emit("kernel_at_song_size", name=name, frames=n, ms=ms, **extra,
             **bounds(*wk))
    # per-sample K6 alone and against its twin at the 3-minute size
    xps, ps = lp24_sweep(bus_b)
    ms, _ = cuda_ms(lambda: iir_kernels.lp24_cascade(xps, ps), 5)
    emit("kernel_at_song_size", name="lp24_cascade", frames=n, ms=ms,
         coefficients="per-sample",
         **bounds(*iir_call_work("lp24_cascade", xps, ps)))
    res = per_sample(compare(
        "lp24_cascade", lambda: iir_kernels.lp24_cascade(xps, ps),
        lambda: iir_kernels.lp24_cascade_plain(xps, ps), xps.abs().max(),
        iir_call_work("lp24_cascade", xps, ps), reps=5))
    emit("kernel_vs_twin", **res)
    require(res["bitwise"], f"per-sample lp24_cascade differs from its twin "
            f"at {res['shape']}")
    bank = bank_calls(rb, bus_b)
    tiled_checks += [
        tiled_kernel_check("lp24_refined", x, secs),
        tiled_kernel_check("biquad_blockrate", bus_b,
                           bank["biquad_blockrate"][3]),
        tiled_kernel_check("biquad_scalar", *bank["biquad_scalar"][2:]),
        tiled_kernel_check("biquad_per_sample",
                           *bank["biquad_per_sample"][2:]),
        tiled_kernel_check("lp24", x, secs),
        tiled_kernel_check("lp24_cascade", *bank["lp24_cascade"][2:]),
        tiled_kernel_check("lp24_cascade", xps, ps)]
    del r, rb, hits, bus, bus_b, x, secs, alone, bank, xps, ps, res
    for res in tiled_checks:
        emit("kernel_vs_earlier_route", kind=TILED[res["name"]], **res)
        require(res["equals_earlier_route"], f"{res['name']} differs from "
                f"its earlier route at {res['shape']}")
        require(res["graph_replay_equals_eager"], f"{res['name']}: a "
                f"captured graph's replay differs at {res['shape']}")
    # the chain walker's cycles per step and a tile's cycles by stage, from
    # an instrumented build, at the 3-minute size
    from groove_tpu_torch.kernels import stage_cycles
    prof_dir = build.BUILD_DIR / "stage_cycles"
    prof_dir.mkdir(parents=True, exist_ok=True)
    prof = stage_cycles.build_tiled_profile(prof_dir)
    for kind in ("K4", "K5", "K9", "K2", "K3", "K6", "K6s"):
        res = stage_cycles.tiled_cycles(prof, kind, 2, n)
        emit("chain_cycles", **res)
        per_step = res["cycles_per_chain_step"]["chain"]
        require(0.0 < per_step < 64.0, f"{kind}: the chain takes {per_step} "
                "cycles a step (the earlier walker took about 64)")

    # ---- 4. the main path through the CLI --------------------------------
    projects = {"north-star": synth.north_star_project,
                "high-sweep": synth.high_sweep_project,
                "filter-bank": synth.filter_bank_project}
    files = {name: synth.write_project(work / f"{name}.json",
                                       make(SONG_MEASURES, SONG_BPM))
             for name, make in projects.items()}
    os.environ["GROOVE_ASSETS"] = str(assets)
    totals = dict.fromkeys(launches(), 0)
    per_song = {}
    for name, path in files.items():
        zero_launches()
        torch.cuda.reset_peak_memory_stats(dev)
        perf = []
        rc = cli.main([str(path), "--wav", "--perf", "--out-dir",
                       str(work / "out"), "--device", "cuda"],
                      perf_out=perf)
        got = launches()
        require(rc == 0 and len(perf) == 1, f"cli failed on {name}")
        for k in totals:
            totals[k] += got[k]
        wav = Path(perf[0]["wav"])
        audio, rate = read_wav(wav)
        per_song[name] = (perf[0], audio)
        emit("slice", project=name, frames=perf[0]["frames"],
             seconds_of_audio=perf[0]["frames"] / rate,
             setup_s=perf[0]["setup_s"],
             first_render_s=perf[0]["first_render_s"],
             render_s=perf[0]["render_s"], xrt=perf[0]["xrt"],
             max_memory_allocated=torch.cuda.max_memory_allocated(dev),
             wav_bytes=wav.stat().st_size,
             wav_peak=float(abs(audio).max()),
             launches={k: v for k, v in got.items() if v})
        # --perf renders twice: once cold, once steady
        want = {k: 2 * PER_RENDER[name].get(k, 0) for k in got}
        require(got == want, f"{name} launched {got}, planned {want}")
    # K9 is on no render path: the ops entry point iir.biquad_best with
    # per-sample coefficients, on the filter bank's output
    out = torch.from_numpy(per_song["filter-bank"][1].T.copy()).to(dev)
    coefs = sweep(out.shape[-1])
    zero_launches()
    y = tiir.biquad_best(out, coefs)
    torch.cuda.synchronize()
    got = launches()
    for k in totals:
        totals[k] += got[k]
    finite = bool(torch.isfinite(y).all())
    emit("ops_entry_point", call="iir.biquad_best, per-sample coefficients",
         shape=list(y.shape), finite=finite,
         launches={k: v for k, v in got.items() if v})
    require(got["biquad_per_sample"] == 1 and finite,
            f"biquad_best per-sample launched {got}")
    # and iir.lp24_apply with a per-sample cutoff (K6 in its per-sample
    # mode), 60 Hz -> 15 kHz at q 0.9
    cut = np.geomspace(60.0, 15000.0, out.shape[-1]).astype(np.float32)
    zero_launches()
    y = tiir.lp24_apply(out, cut, np.float32(0.9), 44100.0)
    torch.cuda.synchronize()
    got = launches()
    for k in totals:
        totals[k] += got[k]
    finite = bool(torch.isfinite(y).all())
    emit("ops_entry_point", call="iir.lp24_apply, per-sample cutoff",
         shape=list(y.shape), finite=finite,
         launches={k: v for k, v in got.items() if v})
    require(got == {**dict.fromkeys(got, 0), "lp24_cascade": 1} and finite,
            f"lp24_apply per-sample launched {got}")
    del out, coefs, y, cut

    # the 3-minute Welsh analogue, segment-streamed with sliced voices
    wpath = synth.write_project(work / "welsh.json", synth.welsh_project(
        SONG_MEASURES, SONG_BPM))
    wc = compile_song(SongSettings.from_project_file(wpath), paths)
    welsh_devices = sorted(u for u, d in wc.devices.items()
                           if d.kind in ("welsh", "welsh-raw"))
    zero_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    perf = []
    with Capture(at=-(-wc.n_frames // WELSH_SEGMENT) // 2) as cap:
        rc = cli.main([str(wpath), "--wav", "--perf", "--stream", "--sliced",
                       "--segment-frames", str(WELSH_SEGMENT), "--device",
                       "cuda", "--out-dir", str(work / "out")],
                      perf_out=perf)
    got = launches()
    require(rc == 0 and len(perf) == 1, "cli failed on welsh")
    for k in totals:
        totals[k] += got[k]
    stream_info = perf[0]["stream"]
    wav = Path(perf[0]["wav"])
    audio, rate = read_wav(wav)
    per_song["welsh"] = (perf[0], audio)
    emit("slice", project="welsh", frames=perf[0]["frames"],
         seconds_of_audio=perf[0]["frames"] / rate,
         setup_s=perf[0]["setup_s"], render_s=perf[0]["render_s"],
         xrt=perf[0]["xrt"],
         max_memory_allocated=torch.cuda.max_memory_allocated(dev),
         wav_bytes=wav.stat().st_size, wav_peak=float(abs(audio).max()),
         launches={k: v for k, v in got.items() if v}, **stream_info)
    require(stream_info["sliced"] == welsh_devices,
            f"welsh: sliced {stream_info['sliced']} of {welsh_devices}")
    want = {k: stream_info["planned_launches"].get(k, 0) for k in got}
    require(got == want, f"welsh launched {got}, planned {want}")
    # K7 and K8 alone on the inputs of one of its segments
    for key in STREAM_KERNELS:
        x, secs, st = cap.args[key]
        res = stream_kernel_check(key, x, secs, st)
        emit("kernel_at_song_size", frames=x.shape[-1], rows=x.shape[0],
             **res)
        require(res["equals_earlier_route"]
                and res["graph_replay_equals_eager"],
                f"{key} on the 3-minute song's segment: {res}")
    del cap, x, secs, st

    # ---- 5. outputs: right shape, audible, equal to the twins' render -----
    for name, (perf, audio) in per_song.items():
        require(audio.shape == (perf["frames"], 2),
                f"{name}: WAV shape {audio.shape}")
        peak = float(abs(audio).max())
        require(0.05 < peak < 1.0, f"{name}: WAV peak {peak}")
    checks = {name: files[name] for name in ("north-star", "high-sweep")}
    checks["filter-bank-10s"] = synth.write_project(
        work / "filter-bank-10s.json",
        synth.filter_bank_project(CHECK_MEASURES, SONG_BPM))
    for name, path in checks.items():
        if name in per_song:
            audio = per_song[name][1]
        else:
            perf = []
            rc = cli.main([str(path), "--wav", "--out-dir",
                           str(work / "out"), "--device", "cuda"],
                          perf_out=perf)
            require(rc == 0, f"cli failed on {name}")
            audio = read_wav(Path(perf[0]["wav"]))[0]
        song = SongSettings.from_project_file(path)
        t0 = time.perf_counter()
        q_cpu = Renderer(compile_song(song, paths),
                         device="cpu").render_quantized()
        cpu_s = time.perf_counter() - t0
        q_gpu = (audio * 32768.0).round().astype(q_cpu.dtype)
        diff = int(abs(q_gpu.astype("int32") - q_cpu).max())
        emit("check", project=name, frames=len(q_cpu),
             cpu_twin_render_s=cpu_s, max_lsb_diff_vs_cpu_twins=diff)
        require(diff == 0, f"{name}: card render differs from the twins")
    # the 10-second Welsh analogue: one segment equals 4096-frame segments
    # on the card, and the card's streamed WAV equals the CPU twins'
    one = sliced(welsh10, dev, -(-welsh10.n_frames // 64) * 64).render(
        quantize=True)
    one_equal = bool(np.array_equal(one, welsh10_q))
    w10 = synth.write_project(work / "welsh-10s.json", synth.welsh_project(
        CHECK_MEASURES, SONG_BPM))
    perf = []
    rc = cli.main([str(w10), "--wav", "--stream", "--sliced",
                   "--segment-frames", str(WELSH_SEGMENT), "--device",
                   "cuda", "--out-dir", str(work / "out")], perf_out=perf)
    require(rc == 0, "cli failed on welsh-10s")
    audio = read_wav(Path(perf[0]["wav"]))[0]
    auto = type("AutoStreamingRenderer", (StreamingRenderer,),
                {"WELSH_SLICED": "auto"})
    t0 = time.perf_counter()
    q_cpu = auto(compile_song(SongSettings.from_project_file(w10), paths),
                 "cpu", WELSH_SEGMENT).render(quantize=True)
    cpu_s = time.perf_counter() - t0
    q_gpu = (audio * 32768.0).round().astype(q_cpu.dtype)
    diff = int(abs(q_gpu.astype("int32") - q_cpu).max())
    emit("check", project="welsh-10s", frames=len(q_cpu),
         cpu_twin_render_s=cpu_s, max_lsb_diff_vs_cpu_twins=diff,
         one_segment_equals_4096_frame_segments=one_equal)
    require(one_equal, "welsh-10s: one segment differs from 4096-frame "
            "segments on the card")
    require(diff == 0, "welsh-10s: card stream differs from the twins")

    kernels = []
    for name, (src, rep) in KERNELS.items():
        res = main_shape[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": totals[name], "max_abs_err": res["max_abs_err"],
            "ms": res["ms"], "plain_ms": res["plain_ms"],
            "bound_ms": res["bound_ms"], "bound_by": res["bound_by"],
            "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(name_power)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
