"""On-card smoke run of groove_tpu_torch: the offline render (drumkit ->
effect filters -> mix -> 16-bit WAV; whole-timeline Welsh and FM voices,
the sampler, calculator, resampled drumkit, oscillators, envelope and toy
instruments; a MIDI file) and the segment-streamed render of sliced
Welsh voices on one CUDA device,
through the hand-written kernels
K1 (drums), K2 (refined lp24), K3 (lp24, block-rate denominators), K6
(lp24, per-sample or static denominators), K4/K5/K9 (one biquad section
with block-rate, static or per-sample coefficients), the serial scan,
K7/K8 (K3/K2 with carried state: the sliced Welsh cascades, one launch of
csrc/lp24_stream.cu per call), scan1 (csrc/scan1.cu, the first-order
scans of the compressor's follower, the reverb's combs and all-passes,
and FM's automated modulator phase), and the unsliced segment-streamed
render's carried-state kernels S1 (csrc/scan_stream.cu: the follower's
peak hold and one-pole), S2 (csrc/comb_stream.cu: the reverb's combs and
all-passes), S3 (csrc/biquad.cu biquad_tiled_state: one filter section
at 64-frame blocks) and S4 (csrc/serial.cu biquad_serial_state: the
serial scan), each with its state carried in and out.

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
     alone from a captured graph (device_ms). scan1 is held to its twin
     in both modes (max_decay, linear) with coefficients by value and per
     sample, on the 10-second kitchen-sink analogue's drum bus [2, n]
     (the compressor's follower), in block space at the shortest and
     longest delay (D = 75: the 1.7 ms all-pass; D = 1927: the 43.7 ms
     comb, automated gains) and at a length that is no multiple of its
     chunk; then alone at the 3-minute size beside its bound (the
     per-sample follower and the D = 1927 comb held to the twin bit for
     bit there too), and torch's prototype associative_scan timed on the
     linear mode's per-sample inputs at 10 s and at 3 minutes
     (library_ms, where it runs); scan1 at the FM analogue's
     modulator-phase shapes (the ratio voice's in-block sums [rows, 64,
     nb] along axis 1, its block prefix [rows, nb], and the in-block sums
     on the layout not taken, [rows, nb, 64] along its last axis) against
     its twin bit for bit at 10 s and 3 minutes, beside its bound;
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
     the inputs of one of its segments, beside their bounds; then the same
     song offline through the CLI's --wav (whole-timeline Welsh voices:
     K2 for the pad's and K3 for the lead's span buckets, the launches the
     Renderer's plan gives, Renderer.welsh_launches, required to be one
     of each a render), and K2 and K3 alone on its packets (the render's
     own inputs, captured in a render of their own), beside their bounds
     and held to their twins bit for bit on sampled rows; then the
     3-minute kitchen-sink analogue (every effect kind: compressors,
     delays, choruses, reverbs, the toy, the stateless chain and a static
     lp24; K1, K6 and scan1 as PER_RENDER plans them) and the
     3-minute perf-1 analogue (two Welsh voices, an arpeggiator and the
     kit at 1024 bpm through gain, limiter, bitcrusher, lp24, reverb and
     lp12 chains: K1, K2, K3, K5, K6 and scan1); the 3-minute FM
     analogue (a pad under a beta trip on traced phases, a lead under a
     depth trip on host phase tables, a voice under a ratio trip on
     scan1: fm_routes prints which bucket takes which route), the
     3-minute instruments analogue (the 707 kit at 48 kHz, a sampler on
     a 48 kHz WAV, the calculator, four oscillators, the envelope
     instrument, the toy: no kernel) and a 162-second MIDI file (a drum
     channel on K1, two GM programs on Welsh patches: K2/K3), each with
     its launches against PER_RENDER (the Renderers' fm_launches and
     welsh_launches plans). Render time, x realtime, peak device memory,
     WAV size and peak, launch counts; the FM analogue's steady render
     in synchronised stages (profile_offline.staged_render: the
     scatter's share); an unknown instrument kind warns and renders
     silence; each note batch's own peak bytes per element (bucket_peaks)
     of the FM, Welsh and MIDI songs, held under the card's element cap
     (engine/render.NOTE_PEAK_BYTES_PER_ELEM);
  5. outputs: each 3-minute WAV's shape and peak; the north-star and
     high-sweep WAVs against the CPU render of the same song (the twins)
     bit for bit, and a 10-second filter-bank render through the CLI
     against the twins' (the serial scan's twin is a Python loop over
     time, too slow for 3 minutes on the CPU); the 10-second Welsh
     analogue streamed as one segment and as 4096-frame segments (bit
     for bit), and its card WAV against the CPU twins' stream; the
     3-minute Welsh analogue offline against its stream (dBFS, within
     -80); the 10-second Welsh analogue offline on the card against the
     CPU twins' offline render with the card's element cap, bit for bit;
     10-second kitchen-sink, perf-1, FM and instruments analogues and an
     8-second MIDI file through the CLI against the CPU twins' renders,
     bit for bit.
  6. (run before 5's checks, which include its WAVs) the unsliced
     segment-streamed render (groove_tpu_torch.engine.stream,
     every instrument and effect kind with its carried state): S1-S4
     against their twins bit for bit at a 10-second and a 3-minute shape
     (the 3-minute S4 against its twin on its last 10 seconds from the
     state the kernel carried there), many chained calls equal to one
     call, each alone beside its bound, torch's associative_scan beside
     S1 (library); the 3-minute kitchen-sink and filter-bank analogues
     through `cli --wav --perf --stream` at the default 262144-frame
     segments (launches against the renderer's plan: x realtime, set-up,
     peak device memory); the 10-second kitchen-sink, instruments, FM,
     sidechain and filter-bank analogues streamed on the card at one
     segment and at 4096-frame segments (the same bits), their CLI WAVs
     equal to the CPU twins' (0 LSB); a `--loop` bounce on the card equal
     to the CPU twins' bounce.
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
scan1's chain is the function's, not the kernel's: a scan of S steps
combines in ceil(log2 S) levels of 2 dependent operations (scan_work).
"""

import contextlib
import io
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
    # iir.one_pole's associative scan (and dynamics.max_decay's, :46)
    "scan1": ("groove_tpu_torch/csrc/scan1.cu",
              "groove_tpu/ops/iir.py:630"),
    # the XLA scans of groove_tpu/ops/stream.py (no Pallas kernel there):
    # one_pole_stream (and max_decay_stream, :385), comb_feedback_stream
    # (and its automated form, :275, and allpass_stream, :302),
    # biquad_stream, biquad_serial_stream
    "scan_stream": ("groove_tpu_torch/csrc/scan_stream.cu",
                    "groove_tpu/ops/stream.py:114"),
    "comb_stream": ("groove_tpu_torch/csrc/comb_stream.cu",
                    "groove_tpu/ops/stream.py:253"),
    "biquad_stream": ("groove_tpu_torch/csrc/biquad.cu",
                      "groove_tpu/ops/stream.py:44"),
    "biquad_serial_stream": ("groove_tpu_torch/csrc/serial.cu",
                             "groove_tpu/ops/stream.py:63"),
}
KIND = {"lp24_refined": "K2", "lp24": "K3", "lp24_cascade": "K6",
        "biquad_blockrate": "K4", "biquad_scalar": "K5",
        "biquad_per_sample": "K9", "biquad_serial": "serial",
        "lp24_stream": "K7", "lp24_refined_stream": "K8", "scan1": "scan1",
        "scan_stream": "S1", "comb_stream": "S2", "biquad_stream": "S3",
        "biquad_serial_stream": "S4"}
STREAM_SEGMENT = 262144  # the CLI's default segment (frames)
STREAM_KERNELS = ("lp24_stream", "lp24_refined_stream")
WELSH_SEGMENT = 4096  # the sliced render's segment (frames)
WELSH_AT = 40        # the segment of the 10-second song held to the twins

# launches per render of each song, by kernel (the route plan)
PER_RENDER = {
    "north-star": {"drums": 1, "lp24_refined": 1},
    "high-sweep": {"drums": 1, "lp24": 1},
    "filter-bank": {"drums": 1, "biquad_scalar": 1, "biquad_blockrate": 5,
                    "biquad_serial": 1, "lp24_cascade": 1, "lp24": 1},
    # scan1: two for each smoothing compressor, six for each reverb
    # (2 and 2; 1 reverb); perf-1's K2/K3 come from its Welsh plan
    "kitchen-sink": {"drums": 1, "lp24_cascade": 1, "scan1": 16},
    "perf-1": {"drums": 1, "lp24_cascade": 1, "biquad_scalar": 1,
               "scan1": 6},
}
PERF1_MEASURES = 768  # 3 minutes at 1024 bpm
PERF1_CHECK_MEASURES = 43  # 10 s
# FM's, the instruments' and the MIDI file's plans are their Renderers'
# (fm_launches, welsh_launches); the instruments launch no kernel
PER_RENDER["instruments"] = {}
MIDI_MEASURES = 90  # 162 s: 45 measures at 120 bpm, 45 at 150
MIDI_CHECK_MEASURES = 4  # 8 s


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
    ln pinned to 64, S3 is K4/K5 with ln pinned to 64 and S4 the serial
    scan, both with the state (s1, s2) carried. A cascade's chains can run as a wavefront along time
    (chain j needs its predecessor only up to the block it has reached),
    so the function's dependency chain is one chain of nb steps and every
    pass's in-block scans, whatever the row's length and however a
    kernel cuts it."""
    from groove_tpu_torch.ops.iir_kernels import CBLOCK, geometry

    io = 2.0 * rows * n * 4 + coef_bytes + 2.0 * rows * state_rows * 4
    if kind in ("serial", "S4"):
        return io, 9.0 * rows * n, 4.0 * n
    if kind in ("K7", "K8", "S3"):
        ln, nb = CBLOCK, n // CBLOCK
    else:
        ln, nb, _ = geometry(n, blockrate=kind in ("K2", "K3", "K4"))
    per_sample = {"K4": 19, "K5": 19, "K9": 19, "K3": 36, "K6": 36,
                  "K2": 88, "K7": 36, "K8": 88, "S3": 19}[kind]
    passes = (2 if kind in ("K2", "K3", "K6", "K7", "K8") else 1) \
        * (2 if kind in ("K2", "K8") else 1)
    flops = rows * (per_sample * n + 8 * nb * passes)
    chain = 2 * ln * passes + 3 * nb
    return io, float(flops), float(chain)


def distinct_bytes(c) -> float:
    """Bytes of the distinct values of a coefficient tensor (dimensions
    read with stride 0 count once; a number or a 0-dim tensor, passed by
    value, counts 0)."""
    import numpy as np
    import torch

    if not torch.is_tensor(c) or c.dim() == 0:
        return 0.0
    return 4.0 * float(np.prod([n for n, st in zip(c.shape, c.stride())
                                if st != 0]))


def coef_bytes(coefs) -> float:
    """Bytes of the distinct coefficient values a call reads (a row
    broadcast with stride 0 counts once; by-value scalars count 0)."""
    return sum(distinct_bytes(c) for c in coefs)


def iir_call_work(name: str, x, coefs) -> tuple:
    from groove_tpu_torch.ops.iir_kernels import STATE_ROWS

    flat = ([c for sec in coefs for c in sec[3:]] if name.startswith("lp24")
            else list(coefs))
    return iir_work(KIND[name], x.shape[0], x.shape[-1], coef_bytes(flat),
                    STATE_ROWS.get(name, 0))


class Capture:
    """While active, keeps copies of the arguments (x, sections and, for a
    stream kernel, the state) of call number `at` (from 0) of each kernel
    in `keys`, so that the kernels can be rerun alone and against their
    twins on the render's own inputs. The wrappers call the kernels as
    they are, counts included."""

    def __init__(self, at: int, keys=STREAM_KERNELS):
        self.at = at
        self.calls = dict.fromkeys(keys, 0)
        self.args: dict = {}

    def __enter__(self):
        from groove_tpu_torch.ops import iir_kernels

        self.saved = {k: getattr(iir_kernels, wrapper(k))
                      for k in self.calls}
        for k, fn in self.saved.items():
            setattr(iir_kernels, wrapper(k), self._wrap(k, fn))
        return self

    def _wrap(self, key, fn):
        import torch

        def call(x, sections, *rest):
            if self.calls[key] == self.at:
                self.args[key] = (
                    x.clone(), [tuple(c.contiguous().clone() for c in sec)
                                for sec in sections],
                    *(t.clone() for t in rest if torch.is_tensor(t)))
            self.calls[key] += 1
            return fn(x, sections, *rest)
        return call

    def __exit__(self, *exc):
        from groove_tpu_torch.ops import iir_kernels

        for k, fn in self.saved.items():
            setattr(iir_kernels, wrapper(k), fn)


def wrapper(key: str) -> str:
    """The ops/iir_kernels wrapper of an lp24 kernel's launch count."""
    return {"lp24_stream": "lp24_blockrate_stream",
            "lp24_refined_stream": "lp24_refined_blockrate_stream",
            "lp24": "lp24_blockrate",
            "lp24_refined": "lp24_refined_blockrate"}[key]


def stream_twin(key: str, x, sections, state):
    """The stream kernel's plain twin on the same (card) inputs."""
    from groove_tpu_torch.ops import iir_kernels

    x2, den, st = iir_kernels.stream_args(
        x, sections, state, iir_kernels.STATE_ROWS[key])
    plain = (iir_kernels.lp24_refined_blockrate_stream_plain
             if key == "lp24_refined_stream"
             else iir_kernels.lp24_blockrate_stream_plain)
    return plain(x2, *(-d for d in den), st)


SAMPLED_ROWS = 4  # rows_vs_twin: this many at the start, middle and end


def rows_vs_twin(key: str, x, sections, y) -> dict:
    """A K2/K3 call on many rows ([rows, n] -> y) against the plain twin
    on a sample of its rows (the first, middle and last SAMPLED_ROWS, the
    whole span): rows are independent, so the twin needs only those."""
    import torch
    from groove_tpu_torch.ops import iir_kernels

    rows = x.shape[0]
    idx = sorted({min(max(r, 0), rows - 1) for base in
                  (0, rows // 2 - SAMPLED_ROWS // 2, rows - SAMPLED_ROWS)
                  for r in range(base, base + SAMPLED_ROWS)})
    pick = torch.tensor(idx, device=x.device)
    secs = [tuple(c[pick] if torch.is_tensor(c) and c.dim()
                  and c.shape[0] == rows else c for c in sec)
            for sec in sections]
    x2, den = iir_kernels._prepare(x[pick], secs, 64)
    plain = (iir_kernels.lp24_refined_blockrate_plain
             if key == "lp24_refined" else iir_kernels.lp24_blockrate_plain)
    plain_ms, y_plain = cuda_ms(lambda: plain(x2, *den), 1, warmup=False)
    got = y[pick]
    err = float((got - y_plain).abs().max())
    return {"name": key, "shape": list(x.shape), "rows_compared": idx,
            "max_abs_err": err, "bitwise": bool(torch.equal(got, y_plain)),
            "plain_ms": plain_ms}


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


def scan_work(x, a, b, axis: int, mode: int) -> tuple:
    """(bytes, flops, chain ops) of one scan1 call: x read and y written
    once, each coefficient's distinct values once; 3 float operations an
    element in the linear mode (b x, a y, the add), 2 in max_decay (a y,
    the max). The chain is the function's least, whatever algorithm the
    kernel runs: an associative scan of S steps in ceil(log2 S) combine
    levels, each 2 dependent operations (a multiply, then the add or the
    max), after the linear mode's b x."""
    import math

    from groove_tpu_torch.ops.scan_kernels import LINEAR

    steps = x.shape[axis]
    linear = mode == LINEAR
    io = 8.0 * x.numel() + distinct_bytes(a) + (distinct_bytes(b)
                                                if linear else 0.0)
    levels = math.ceil(math.log2(max(steps, 2)))
    return (io, (3.0 if linear else 2.0) * x.numel(),
            2.0 * levels + (1.0 if linear else 0.0))


def scan_calls(r, bus) -> list:
    """scan1's calls on a kitchen-sink analogue's drum bus, as its effects
    make them: (label, x, a, b, axis, mode), scan1's arguments in order.
    The compressor's follower on the time axis [2, n] (attack smoothing
    with per-sample and number coefficients; peak hold with a number r
    and with the release trip's per-sample r), an all-pass (D = 75) and
    an automated comb (D = 1927) in block space, and a length that is no
    multiple of the chunk. The first call is the one the kernels line
    reports and torch's associative_scan is timed on (library_scan)."""
    import numpy as np

    from groove_tpu_torch.ops import delayfx, dynamics, iir
    from groove_tpu_torch.ops.scan_kernels import LINEAR, MAX_DECAY

    sr = float(r.c.sample_rate)
    n = bus.shape[-1]
    mag = bus.abs()
    trip = iir.upsample_hold(r.inputs["comp-trip/auto/release"], n)
    r_num = dynamics._follower_coef(0.25, sr)
    r_ps = dynamics._follower_coef(trip, sr)
    a_num = dynamics._follower_coef(0.01, sr)
    a_ps = dynamics._follower_coef(trip * 0.1, sr)
    ap, _ = delayfx._block_view(bus, 75)
    comb, _ = delayfx._block_view(bus, 1927)
    sec = iir.upsample_hold(r.inputs["reverb-trip/auto/seconds"], n)
    gb, _ = delayfx._block_view(delayfx.reverb_comb_g(sec, 1927, sr), 1927)
    odd = mag[:, :100003].contiguous()
    one = np.float32(1.0)
    return [
        ("linear, per-sample a and b", mag, a_ps, 1.0 - a_ps, -1, LINEAR),
        ("linear, number a and b", mag, a_num, one - a_num, -1, LINEAR),
        ("max_decay, number r", mag, r_num, 1.0, -1, MAX_DECAY),
        ("max_decay, per-sample r", mag, r_ps, 1.0, -1, MAX_DECAY),
        ("linear, block space D = 75", ap, 0.7, 1.0, -2, LINEAR),
        ("linear, block space D = 1927, per-sample a",
         delayfx._shift_block(comb), gb, 1.0, -2, LINEAR),
        ("max_decay, n = 100003", odd, r_num, 1.0, -1, MAX_DECAY),
    ]


def library_scan(x, a, b) -> dict:
    """torch's prototype associative_scan (torch._higher_order_ops) on the
    linear scan's inputs: one call over (a, b x) with the reference's
    combine. combine_mode "pointwise" (compiled) where it runs, else
    "generic". A yardstick only: the port never calls it."""
    import torch

    from torch._higher_order_ops import associative_scan

    def combine(e1, e2):
        return (e2[0] * e1[0], e2[0] * e1[1] + e2[1])

    aa = (a if torch.is_tensor(a) else torch.full_like(x, float(a)))
    aa = aa.expand_as(x).contiguous()
    bx = b * x
    errors = []
    for mode in ("pointwise", "generic"):
        try:
            ms, y = cuda_ms(lambda m=mode: associative_scan(
                combine, (aa, bx), dim=-1, combine_mode=m)[1], 5)
            return {"library_ms": ms,
                    "library_call": f"associative_scan ({mode})",
                    "library_out": y}
        except Exception as e:  # a prototype: record why it did not run
            errors.append(f"{mode}: {type(e).__name__}: {str(e)[:300]}")
    return {"library_ms": None, "library_errors": errors}


def stream_calls(bus, ks, fb, sr: float) -> list:
    """S1-S4's calls as the unsliced stream makes them, on a drum bus
    [2, n] (n a multiple of 64) of the kitchen-sink analogue's Renderer
    `ks`, with the filter-bank analogue's Renderer `fb` for a block-rate
    coefficient table: the follower's attack one-pole (per-sample a) and
    its peak hold (number r), the automated reverb's longest comb (D =
    1927, per-sample g) and its short all-pass (D = 75), the band-pass
    sweep's table (S3 block-rate), a static peaking EQ (S3 scalar) and
    the 40 Hz high-pass (S4), each from a nonzero carried state. Each
    entry: (label, name, run, state0, work) with run(lo, hi, state,
    plain) -> (y, state') over frames lo:hi, on the kernel or its twin
    (S4's twin on the CPU: a loop over samples)."""
    import math

    import torch

    from groove_tpu_torch.ops import delayfx, dynamics, iir
    from groove_tpu_torch.ops import stream_kernels as sk
    from groove_tpu_torch.ops.scan_kernels import LINEAR, MAX_DECAY

    n = bus.shape[-1]
    rows = bus.shape[0]
    mag = bus.abs()
    trip = iir.upsample_hold(ks.inputs["comp-trip/auto/release"], n)
    a_ps = dynamics._follower_coef(trip * 0.1, sr)
    r_num = dynamics._follower_coef(0.25, sr)
    sec = iir.upsample_hold(ks.inputs["reverb-trip/auto/seconds"], n)
    g = delayfx.reverb_comb_g(sec, 1927, sr)
    co = fb.inputs["bp-sweep/fc/coefs"][:, :n // 64]
    peq = iir.rbj_peaking_eq(1000.0, 1.5, 6.0, sr)
    hp = iir.rbj_high_pass(40.0, 0.707, sr)
    pair = (bus[:, 1] * 0.01, bus[:, 2] * 0.01)
    hx = bus[:, 1000:1000 + 1927].contiguous()

    def flat(y, st):
        return (y, *st)

    def s1(fn_a, mode):
        def run(lo, hi, st, plain):
            f = sk.scan_stream_plain if plain else sk.scan_stream
            a = fn_a(lo, hi)
            b = 1 - a if mode == LINEAR else 1.0
            y, last = f(mag[:, lo:hi], a, b, st[0], mode)
            return y, (last,)
        return run

    def comb(lo, hi, st, plain):
        f = sk.comb_stream_plain if plain else sk.comb_stream
        y, h1, h2 = f(bus[:, lo:hi], st[0], st[1], g[lo:hi])
        return y, (h1, h2)

    def allpass(lo, hi, st, plain):
        f = sk.allpass_stream_plain if plain else sk.allpass_stream
        y, h = f(bus[:, lo:hi], st[0], delayfx.ALLPASS_G)
        return y, (h,)

    def s3(coefs):
        def run(lo, hi, st, plain):
            f = sk.biquad_state_plain if plain else sk.biquad_state
            c = [v[lo // 64:hi // 64] if torch.is_tensor(v) else v
                 for v in coefs]
            return f(bus[:, lo:hi], c, st)
        return run

    def s4(lo, hi, st, plain):
        if not plain:
            return sk.biquad_serial_state(bus[:, lo:hi], hp, st)
        y, st2 = sk.biquad_serial_state_plain(
            bus[:, lo:hi].cpu(), hp, tuple(t.cpu() for t in st))
        return y.to(bus.device), tuple(t.to(bus.device) for t in st2)

    numel = float(bus.numel())
    comb_io = 8.0 * numel + distinct_bytes(g) + 2 * 2 * rows * 1927 * 4.0
    ap_io = 8.0 * numel + 2 * rows * 75 * 4.0
    return [
        ("follower attack, per-sample a", "scan_stream",
         s1(lambda lo, hi: a_ps[lo:hi], LINEAR), (mag[:, 0] * 0.5,),
         scan_work(mag, a_ps, 1 - a_ps, -1, LINEAR)),
        ("peak hold, number r", "scan_stream",
         s1(lambda lo, hi: r_num, MAX_DECAY), (mag[:, 0] * 0.5,),
         scan_work(mag, r_num, 1.0, -1, MAX_DECAY)),
        ("comb D = 1927, per-sample g", "comb_stream", comb,
         (hx, 0.5 * hx), (comb_io, 2.0 * numel,
                          2.0 * math.ceil(math.log2(max(n // 1927, 2))))),
        ("all-pass D = 75", "comb_stream", allpass,
         (bus[:, 3000:3075].contiguous(),),
         (ap_io, 5.0 * numel, 2.0 * math.ceil(math.log2(n // 75)) + 2.0)),
        ("block-rate table (band-pass sweep)", "biquad_stream",
         s3([co[j] for j in range(5)]), pair,
         iir_work("S3", rows, n, coef_bytes([co[j] for j in range(5)]), 2)),
        ("static (peaking EQ)", "biquad_stream", s3(peq), pair,
         iir_work("S3", rows, n, 0.0, 2)),
        ("serial (high-pass 40 Hz)", "biquad_serial_stream", s4, pair,
         iir_work("S4", rows, n, 0.0, 2)),
    ]


def stream_call_check(call, cuts, twin_window: int | None = None,
                      reps: int = 20) -> dict:
    """One S1-S4 call (stream_calls) over its whole bus: against its twin
    bit for bit (over the whole bus, or with twin_window, over its last
    twin_window frames from the state the kernel's chained calls carried
    to them), and chained calls cut at `cuts` (from the carried state)
    equal to one call, y and state."""
    import torch

    label, name, run, st0, work = call
    n = cuts[-1]

    def flat(out):
        return torch.cat([out[0].reshape(-1), *(t.reshape(-1)
                                                for t in out[1])])

    whole = run(0, n, st0, False)
    ys, st, entry = [], st0, {}
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        entry[lo] = st
        y, st = run(lo, hi, st, False)
        ys.append(y)
    chained = bool(torch.equal(torch.cat(ys, -1), whole[0])
                   and all(torch.equal(a, b) for a, b in zip(st, whole[1])))
    if twin_window is None:
        res = compare(name, lambda: flat(run(0, n, st0, False)),
                      lambda: flat(run(0, n, st0, True)),
                      whole[0].abs().max(), work, reps=reps)
    else:
        # from the state the kernel carried into frame lo
        lo = max(0, n - twin_window) // 64 * 64
        st_lo = run(0, lo, st0, False)[1] if lo else st0
        tail = run(lo, n, st_lo, False)
        t0 = time.perf_counter()
        twin = run(lo, n, st_lo, True)
        plain_s = time.perf_counter() - t0
        ms, _ = cuda_ms(lambda: run(0, n, st0, False), reps)
        a, b = flat(tail), flat(twin)
        res = {"name": name, "shape": list(whole[0].shape),
               "max_abs_err": float((a - b).abs().max()),
               "bitwise": bool(torch.equal(a, b)) and bool(torch.equal(
                   tail[0], whole[0][..., lo:])), "ms": ms,
               "plain_ms": plain_s * 1e3,
               "twin_window": [lo, n], **bounds(*work)}
    return {**res, "shape": list(whole[0].shape), "call": label,
            "chained_equal_one_call": chained, "cuts": len(cuts) - 1}


def fm_phase_calls(r) -> list:
    """scan1's calls for the FM analogue's automated modulator phase, as
    models/fm.modulator_phase makes them on the ratio voice's bucket:
    (label, x, a, b, axis, mode). The in-block sums of [rows, nb, 64]
    handed over as [rows, 64, nb] along axis 1 (block space) and the
    block prefix [rows, nb] on the time axis; then the in-block sums on
    the layout not taken, [rows, nb, 64] along its last axis (one
    64-step lane a thread block), for the record."""
    import torch

    from groove_tpu_torch.models import fm
    from groove_tpu_torch.ops.scan_kernels import LINEAR, scan1

    u, b = "ratio-voice", "ratio-voice/b0"
    span = r._buckets[u][0]
    dev = r.device
    ratio = fm._note_curve(r.inputs[f"{u}/auto/ratio"],
                           r._host_on[f"{b}/on"], span)
    f_c = r.inputs[f"{b}/hc/f1"][:, None]
    inc = torch.div(ratio * f_c, torch.full((), float(r.c.sample_rate),
                                            device=dev))
    rows = inc.shape[0]
    inc3 = inc.reshape(rows, span // fm.CBLOCK, fm.CBLOCK)
    incl = fm.in_block_sums(inc3)
    blk = incl[..., -1].contiguous()
    return [
        ("fm in-block sums, [rows, 64, nb] on axis 1",
         inc3.transpose(1, 2), 1.0, 1.0, 1, LINEAR),
        ("fm block prefix, [rows, nb]", blk, 1.0, 1.0, -1, LINEAR),
        ("fm in-block sums, [rows, nb, 64] on its last axis (not taken)",
         inc3, 1.0, 1.0, -1, LINEAR),
    ]


def fm_routes(r) -> list:
    """Each FM bucket's phase route in Renderer r's plan: the ratio curve
    (scan1), host phase tables, or traced phases past the tables' cap."""
    out = []
    for u, spans in r._buckets.items():
        for j, span in enumerate(spans):
            b = f"{u}/b{j}"
            route = ("ratio curve (scan1)"
                     if "ratio" in r.c.devices[u].automation
                     else "host phase tables" if f"{b}/hc/phm" in r.inputs
                     else "traced, past the tables' cap")
            out.append({"device": u, "bucket": j, "span": span,
                        "rows": int(r._host_on[f"{b}/on"].shape[0]),
                        "route": route})
    return out


def bucket_peaks(r) -> list:
    """Each note batch's own peak device bytes in one render of Renderer r
    (its packet's or chunk's live intermediates, the synchronised peak
    above what was allocated before it), over its elements (rows x
    span): the quantity NOTE_PEAK_BYTES_PER_ELEM bounds."""
    import torch

    out = []
    for name in ("_cascade_packet", "_chunked_mono"):
        fn = getattr(r, name)

        def call(inputs, b, *a, _fn=fn, _name=name, **kw):
            span = a[1] if _name == "_cascade_packet" else a[0]
            rows = int(r._host_on[f"{b}/on"].shape[0])
            rows = min(rows, max(1, r.note_chunk_elems // span))
            torch.cuda.synchronize(r.device)
            torch.cuda.reset_peak_memory_stats(r.device)
            base = torch.cuda.memory_allocated(r.device)
            y = _fn(inputs, b, *a, **kw)
            torch.cuda.synchronize(r.device)
            peak = torch.cuda.max_memory_allocated(r.device) - base
            out.append({"batch": b, "rows": rows, "span": span,
                        "peak_bytes": peak,
                        "bytes_per_element": peak / (rows * span)})
            return y

        setattr(r, name, call)
    r.render()
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from groove_tpu_torch import cli, profile_offline
    from groove_tpu_torch.compiler.song import compile_midi_file, \
        compile_song
    import numpy as np

    from groove_tpu_torch.engine.render import (NOTE_PEAK_BYTES_PER_ELEM,
                                                Renderer, note_chunk_cap)
    from groove_tpu_torch.engine.stream import StreamingRenderer
    from groove_tpu_torch.io.wav import quantize_16bit, read_wav
    from groove_tpu_torch.kernels import build
    from groove_tpu_torch.ops import biquad_kernels as bk
    from groove_tpu_torch.ops import drums, iir_kernels, scan_kernels
    from groove_tpu_torch.ops import stream_kernels as sk
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
    synth.write_instrument_assets(assets)
    synth.write_welsh_patches(assets)
    paths = Paths(roots=[assets])
    counters = (drums.LAUNCHES, iir_kernels.LAUNCHES, bk.LAUNCHES,
                scan_kernels.LAUNCHES, sk.LAUNCHES)

    def launches() -> dict:
        return {k: v for c in counters for k, v in c.items()}

    def zero_launches() -> None:
        for c in counters:
            for k in c:
                c[k] = 0

    def renderer(project, measures: int):
        song = SongSettings.from_json(project(measures, SONG_BPM))
        return Renderer(compile_song(song, paths), device=dev)

    def scan_check(label, *call):
        return {**compare(
            "scan1", lambda: scan_kernels.scan1(*call),
            lambda: scan_kernels.scan1_plain(*call), call[0].abs().max(),
            scan_work(*call)), "call": label, "axis": call[3]}

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

    # scan1 on the 10-second kitchen-sink analogue's drum bus: the
    # compressor's follower, an all-pass and a comb in block space, a
    # length off the chunk; torch's associative_scan on the first call's
    # inputs (library_ms), the call whose result main_shape keeps
    library = {}
    rk = renderer(synth.kitchen_sink_project, CHECK_MEASURES)
    _, bus_k = drum_bus(rk)
    for i, (label, *call) in enumerate(scan_calls(rk, bus_k)):
        results.append(scan_check(label, *call))
        if i == 0:
            lib = library_scan(*call[:3])
            if lib["library_ms"] is not None:
                y = scan_kernels.scan1(*call)
                lib["library_max_abs_err_vs_kernel"] = float(
                    (lib.pop("library_out") - y).abs().max())
            emit("library", name="scan1", call=label,
                 shape=list(call[0].shape), ms=results[-1]["ms"], **lib)
            library["scan1"] = lib["library_ms"]
    del rk, bus_k
    # scan1 at the 10-second FM analogue's modulator-phase shapes
    rf = renderer(synth.fm_project, CHECK_MEASURES)
    for label, *call in fm_phase_calls(rf):
        results.append(scan_check(label, *call))
    del rf
    # S1-S4 on the 10-second kitchen-sink drum bus, from carried states:
    # each against its twin bit for bit (S4's twin on the CPU), chained
    # calls cut off the 64-frame grid's neighbours equal to one call;
    # torch's associative_scan beside S1's first call (library)
    rk = renderer(synth.kitchen_sink_project, CHECK_MEASURES)
    rb = renderer(synth.filter_bank_project, CHECK_MEASURES)
    _, bus_k = drum_bus(rk)
    n10 = bus_k.shape[-1] // 64 * 64
    bus_k = bus_k[:, :n10].contiguous()
    cuts10 = [0, 64, 4096, 3 * 4096 + 64, n10 // 2 // 64 * 64, n10]
    stream_checks = []
    for i, call in enumerate(stream_calls(bus_k, rk, rb,
                                          float(rk.c.sample_rate))):
        res = stream_call_check(call, cuts10)
        results.append(res)
        stream_checks.append(res)
        if i == 0:
            x_s1 = bus_k.abs()
            trip = tiir.upsample_hold(rk.inputs["comp-trip/auto/release"],
                                      n10)
            from groove_tpu_torch.ops import dynamics as tdyn
            a_ps = tdyn._follower_coef(trip * 0.1, float(rk.c.sample_rate))
            lib = library_scan(x_s1, a_ps, 1 - a_ps)
            lib.pop("library_out", None)
            emit("library", name="scan_stream", call=call[0],
                 shape=list(x_s1.shape), ms=res["ms"], **lib)
            library["scan_stream"] = lib["library_ms"]
    del rk, rb, bus_k

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
    # scan1 alone at the 3-minute size: the compressor's follower and the
    # reverb's longest comb on the 3-minute kitchen-sink drum bus; the
    # per-sample follower and the comb also against the twin on the card,
    # and torch's associative_scan on the follower's inputs
    rk = renderer(synth.kitchen_sink_project, SONG_MEASURES)
    _, bus_k = drum_bus(rk)
    for i, (label, *call) in enumerate(scan_calls(rk, bus_k)):
        if label.endswith("100003") or label.endswith("D = 75"):
            continue
        fn = (lambda c=call: scan_kernels.scan1(*c))
        if label.startswith("linear, per-sample") or "1927" in label:
            res = {**scan_check(label, *call), "frames": rk.c.n_frames,
                   "device_ms": graph_ms(fn)}
            emit("kernel_at_song_size", **res)
            require(res["bitwise"], f"scan1 differs from its twin at 3 "
                    f"minutes ({label}): {res['max_abs_err']}")
        else:
            ms, _ = cuda_ms(fn, 5)
            emit("kernel_at_song_size", name="scan1", call=label,
                 shape=list(call[0].shape), frames=rk.c.n_frames, ms=ms,
                 device_ms=graph_ms(fn), **bounds(*scan_work(*call)))
        if i == 0:
            lib = library_scan(*call[:3])
            if lib["library_ms"] is not None:
                lib["library_max_abs_err_vs_kernel"] = float(
                    (lib.pop("library_out") - fn()).abs().max())
            emit("library", name="scan1", call=label, frames=rk.c.n_frames,
                 shape=list(call[0].shape), **lib)
    del rk, bus_k
    # scan1 at the 3-minute FM analogue's modulator-phase shapes, against
    # the twin too
    rf = renderer(synth.fm_project, SONG_MEASURES)
    for label, *call in fm_phase_calls(rf):
        res = {**scan_check(label, *call), "frames": rf.c.n_frames,
               "device_ms": graph_ms(lambda c=call: scan_kernels.scan1(*c))}
        emit("kernel_at_song_size", **res)
        require(res["bitwise"], f"scan1 differs from its twin at 3 "
                f"minutes ({label}): {res['max_abs_err']}")
    del rf
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
    # S1-S4 alone at the 3-minute size, against their twins (S4's on its
    # last 10 seconds from the state the kernel carried there) and chained
    # at the CLI's 262144-frame segments
    rk = renderer(synth.kitchen_sink_project, SONG_MEASURES)
    _, bus_k = drum_bus(rk)
    n3 = bus_k.shape[-1] // 64 * 64
    bus_k = bus_k[:, :n3].contiguous()
    cuts3 = [*range(0, n3, STREAM_SEGMENT), n3]
    for call in stream_calls(bus_k, rk, rb, float(rk.c.sample_rate)):
        window = 441000 if call[1] == "biquad_serial_stream" else None
        res = stream_call_check(call, cuts3, twin_window=window, reps=5)
        res["frames"] = n3
        stream_checks.append(res)
        emit("kernel_at_song_size", **res)
    del rk, bus_k
    for res in stream_checks:
        emit("stream_kernel_check", **res)
        require(res["bitwise"], f"{res['name']} ({res['call']}) differs "
                f"from its twin at {res['shape']}: {res['max_abs_err']}")
        require(res["chained_equal_one_call"], f"{res['name']} "
                f"({res['call']}): chained calls differ from one call at "
                f"{res['shape']}")
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
    files["kitchen-sink"] = synth.write_project(
        work / "kitchen-sink.json",
        synth.kitchen_sink_project(SONG_MEASURES, SONG_BPM))
    files["perf-1"] = synth.write_project(
        work / "perf-1.json", synth.perf1_project(PERF1_MEASURES))
    files["fm"] = synth.write_project(
        work / "fm.json", synth.fm_project(SONG_MEASURES, SONG_BPM))
    files["instruments"] = synth.write_project(
        work / "instruments.json",
        synth.instruments_project(SONG_MEASURES, SONG_BPM))
    files["midi"] = work / "midi.mid"
    files["midi"].write_bytes(synth.midi_song(MIDI_MEASURES, SONG_BPM))
    # perf-1's Welsh cascades: its Renderer's plan
    plan = Renderer(compile_song(SongSettings.from_project_file(
        files["perf-1"]), paths), dev)
    PER_RENDER["perf-1"] = {**PER_RENDER["perf-1"], **{
        k: v for k, v in plan.welsh_launches().items() if v}}
    # FM's modulator-phase scans and each bucket's phase route
    plan = Renderer(compile_song(SongSettings.from_project_file(
        files["fm"]), paths), dev)
    PER_RENDER["fm"] = plan.fm_launches()
    routes = fm_routes(plan)
    emit("fm_routes", buckets=routes, planned_per_render=PER_RENDER["fm"])
    require({e["route"] for e in routes} == {
        "ratio curve (scan1)", "host phase tables",
        "traced, past the tables' cap"}, f"fm routes: {routes}")
    # the MIDI file: K1 for the drum channel, its Welsh patches' cascades
    plan = Renderer(compile_midi_file(files["midi"], paths), dev)
    PER_RENDER["midi"] = {"drums": 1, **{
        k: v for k, v in plan.welsh_launches().items() if v}}
    del plan
    os.environ["GROOVE_ASSETS"] = str(assets)
    totals = dict.fromkeys(launches(), 0)
    per_song = {}
    peak_per_elem = {}  # song -> bucket_peaks of its note batches
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
        peak = torch.cuda.max_memory_allocated(dev)
        emit("slice", project=name, frames=perf[0]["frames"],
             seconds_of_audio=perf[0]["frames"] / rate,
             setup_s=perf[0]["setup_s"],
             first_render_s=perf[0]["first_render_s"],
             render_s=perf[0]["render_s"], xrt=perf[0]["xrt"],
             max_memory_allocated=peak,
             wav_bytes=wav.stat().st_size,
             wav_peak=float(abs(audio).max()),
             launches={k: v for k, v in got.items() if v},
             planned_per_render=PER_RENDER[name])
        # --perf renders twice: once cold, once steady
        want = {k: 2 * PER_RENDER[name].get(k, 0) for k in got}
        require(got == want, f"{name} launched {got}, planned {want}")
    # the FM analogue's steady render in synchronised stages (the
    # scatter's share), as profile_offline stages it
    fm_song = compile_song(SongSettings.from_project_file(files["fm"]), paths)
    rf = Renderer(fm_song, dev)
    rf.render_quantized()
    staged_s, stages = profile_offline.staged_render(rf)
    emit("stages", project="fm", staged_ms=staged_s * 1e3,
         stages_ms={k: v * 1e3 for k, v in stages.items()},
         scatter_share=stages["scatter"] / staged_s)
    del rf
    # each note batch's own peak bytes per element, of the FM analogue's
    # and the MIDI file's buckets
    for name, song in (("fm", fm_song),
                       ("midi", compile_midi_file(files["midi"], paths))):
        peak_per_elem[name] = bucket_peaks(Renderer(song, dev))
        emit("bucket_peaks", project=name, batches=peak_per_elem[name])
    # an instrument of a kind no renderer knows: a warning and silence
    # (the device's toy plays 0.0, so the song is the CLI's WAV)
    ri = Renderer(synth.unknown_instrument(compile_song(
        SongSettings.from_project_file(files["instruments"]), paths)), dev)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        q = ri.render_quantized()
    warned = "unknown instrument kind mystery-instrument; silent" \
        in err.getvalue()
    same = bool(np.array_equal(
        q, (per_song["instruments"][1] * 32768.0).round().astype(q.dtype)))
    emit("check", project="instruments, an unknown instrument kind",
         warned=warned, equals_the_cli_wav=same)
    require(warned and same, "an unknown instrument kind did not warn "
            "and render silence")
    del ri, q
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

    # the same song offline: whole-timeline Welsh voices, each span bucket
    # one K2 (pad) or K3 (lead) launch over all of its notes. The plan of
    # the 3-minute analogue is one bucket a voice (PERF.md section 4).
    planned = Renderer(wc, dev).welsh_launches()
    require(planned == {"lp24_refined": 1, "lp24": 1},
            f"welsh offline plans {planned}, not one K2 and one K3 launch")
    PER_RENDER["welsh-offline"] = planned
    zero_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    perf = []
    rc = cli.main([str(wpath), "--wav", "--perf", "--device", "cuda",
                   "--out-dir", str(work / "out-offline")], perf_out=perf)
    got = launches()
    peak_bytes = torch.cuda.max_memory_allocated(dev)
    require(rc == 0 and len(perf) == 1, "cli failed on welsh offline")
    for k in totals:
        totals[k] += got[k]
    wav = Path(perf[0]["wav"])
    audio, rate = read_wav(wav)
    per_song["welsh-offline"] = (perf[0], audio)
    pad_elems = max(span * sum(c for _, c in members)
                    for span, members in Renderer(wc, "cpu")._wm_plan)
    emit("slice", project="welsh-offline", frames=perf[0]["frames"],
         seconds_of_audio=perf[0]["frames"] / rate,
         setup_s=perf[0]["setup_s"],
         first_render_s=perf[0]["first_render_s"],
         render_s=perf[0]["render_s"], xrt=perf[0]["xrt"],
         max_memory_allocated=peak_bytes,
         largest_bucket_elements=pad_elems,
         peak_over_largest_bucket_elements=peak_bytes / pad_elems,
         wav_bytes=wav.stat().st_size, wav_peak=float(abs(audio).max()),
         launches={k: v for k, v in got.items() if v},
         planned_per_render=planned)
    # --perf renders twice: once cold, once steady
    want = {k: 2 * planned.get(k, 0) for k in got}
    require(got == want, f"welsh offline launched {got}, planned {want}")
    peak_per_elem["welsh"] = bucket_peaks(Renderer(wc, dev))
    emit("bucket_peaks", project="welsh-offline",
         batches=peak_per_elem["welsh"])
    # K2 and K3 alone on the inputs of the song's packets, captured in a
    # render of their own (the copies stay out of the render's peak): the
    # whole call timed, and sampled rows held to the twin bit for bit
    with Capture(at=0, keys=("lp24_refined", "lp24")) as cap:
        Renderer(wc, dev).render()
    for key in ("lp24_refined", "lp24"):
        x, secs = cap.args.pop(key)
        fn = getattr(iir_kernels, wrapper(key))
        ms, y = cuda_ms(lambda f=fn, a=x, c=secs: f(a, c), 5)
        emit("kernel_at_song_size", name=key, rows=x.shape[0],
             frames=x.shape[-1], ms=ms,
             device_ms=graph_ms(lambda f=fn, a=x, c=secs: f(a, c)),
             **bounds(*iir_call_work(key, x, secs)))
        res = rows_vs_twin(key, x, secs, y)
        emit("kernel_vs_twin", **res)
        require(res["bitwise"], f"{key} at [{x.shape[0]}, {x.shape[-1]}]: "
                f"sampled rows differ from the twin: {res}")
    del cap, x, secs, y

    # the card's element cap: NOTE_PEAK_BYTES_PER_ELEM must cover the
    # largest bucket's peak bytes per element of every song measured
    largest = {name: max(b["bytes_per_element"] for b in batches)
               for name, batches in peak_per_elem.items()}
    emit("element_cap", largest_bytes_per_element=largest,
         note_peak_bytes_per_elem=NOTE_PEAK_BYTES_PER_ELEM,
         note_chunk_elems=note_chunk_cap(dev))
    require(max(largest.values()) <= NOTE_PEAK_BYTES_PER_ELEM,
            f"peak bytes per element {largest} above the cap's "
            f"{NOTE_PEAK_BYTES_PER_ELEM}")

    # ---- 6. the unsliced segment-streamed render ---------------------------
    # the 3-minute kitchen-sink and filter-bank analogues through the CLI's
    # --stream at its default 262144-frame segments, each run with the
    # counts set to 0 just before it and read just after: S1-S4 launched
    # as the renderer plans them
    stream_got = dict.fromkeys(sk.LAUNCHES, 0)
    for name in ("kitchen-sink", "filter-bank"):
        zero_launches()
        torch.cuda.reset_peak_memory_stats(dev)
        perf = []
        rc = cli.main([str(files[name]), "--wav", "--perf", "--stream",
                       "--device", "cuda", "--out-dir",
                       str(work / "out-stream")], perf_out=perf)
        got = launches()
        require(rc == 0 and len(perf) == 1, f"cli failed on {name} "
                "streamed")
        for k in totals:
            totals[k] += got[k]
        for k in stream_got:
            stream_got[k] += got[k]
        info = perf[0]["stream"]
        wav = Path(perf[0]["wav"])
        audio, rate = read_wav(wav)
        per_song[f"{name}-stream"] = (perf[0], audio)
        emit("slice", project=f"{name}-stream", frames=perf[0]["frames"],
             seconds_of_audio=perf[0]["frames"] / rate,
             setup_s=perf[0]["setup_s"], render_s=perf[0]["render_s"],
             xrt=perf[0]["xrt"],
             max_memory_allocated=torch.cuda.max_memory_allocated(dev),
             wav_bytes=wav.stat().st_size, wav_peak=float(abs(audio).max()),
             launches={k: v for k, v in got.items() if v},
             offline_render_s=per_song[name][0]["render_s"], **info)
        want = {k: info["planned_launches"].get(k, 0) for k in got}
        require(got == want, f"{name} streamed launched {got}, planned "
                f"{want}")
        offline = per_song[name][1]
        db = 20.0 * float(np.log10(abs(audio - offline).max()
                                   / max(1.0, float(abs(offline).max()))
                                   + 1e-30))
        lsb = int(abs((audio * 32768.0).round()
                      - (offline * 32768.0).round()).max())
        emit("check", project=name, offline_vs_streamed_dbfs=db,
             offline_vs_streamed_max_lsb=lsb)
        if name == "kitchen-sink":
            require(db <= -80.0, f"{name}: offline reads {db:.1f} dBFS "
                    "against the stream")
    require(all(v > 0 for v in stream_got.values()),
            f"the streamed renders left a carried-state kernel unlaunched: "
            f"{stream_got}")
    # 10-second songs streamed unsliced on the card: the CLI's WAV at
    # 4096-frame segments (launches as planned), equal to a one-segment
    # render on the card and to the CPU twins' (one segment: the same bits
    # at every segmentation) to the LSB
    short = {"kitchen-sink": synth.kitchen_sink_project,
             "instruments": synth.instruments_project,
             "fm": synth.fm_project, "sidechain": synth.sidechain_project,
             "filter-bank": synth.filter_bank_project,
             "welsh-patches": synth.welsh_patch_project}
    for name, make in short.items():
        path = synth.write_project(work / f"{name}-10s-stream.json",
                                   make(CHECK_MEASURES, SONG_BPM))
        song = compile_song(SongSettings.from_project_file(path), paths)
        zero_launches()
        perf = []
        rc = cli.main([str(path), "--wav", "--stream", "--segment-frames",
                       "4096", "--device", "cuda", "--out-dir",
                       str(work / "out-stream")], perf_out=perf)
        got = launches()
        require(rc == 0, f"cli failed on {name}-10s streamed")
        for k in totals:
            totals[k] += got[k]
        want = {k: perf[0]["stream"]["planned_launches"].get(k, 0)
                for k in got}
        require(got == want, f"{name}-10s streamed launched {got}, planned "
                f"{want}")
        audio = read_wav(Path(perf[0]["wav"]))[0]
        one_seg = -(-song.n_frames // 64) * 64
        one = StreamingRenderer(song, dev, one_seg).render(quantize=True)
        t0 = time.perf_counter()
        q_cpu = StreamingRenderer(song, "cpu", one_seg).render(quantize=True)
        cpu_s = time.perf_counter() - t0
        q_gpu = (audio * 32768.0).round().astype(q_cpu.dtype)
        diff = int(abs(q_gpu.astype("int32") - q_cpu).max())
        one_equal = bool(np.array_equal(one, q_gpu))
        emit("check", project=f"{name}-10s-stream", frames=len(q_cpu),
             launches={k: v for k, v in got.items() if v},
             one_segment_equals_4096_frame_segments=one_equal,
             cpu_twin_render_s=cpu_s, max_lsb_diff_vs_cpu_twins=diff,
             wav_peak=float(abs(audio).max()))
        require(one_equal, f"{name}-10s: one segment differs from "
                "4096-frame segments on the card")
        require(diff == 0 and abs(q_gpu).max() > 300,
                f"{name}-10s: card stream differs from the twins by {diff} "
                "LSB")
    # a loop bounce on the card: [0, 8 beats) then two passes of [2, 8)
    # beats of the 10-second sidechain analogue, the CPU twins' bounce
    loop_path = work / "sidechain-10s-stream.json"
    perf = []
    rc = cli.main([str(loop_path), "--loop", "2", "8", "--loop-iterations",
                   "2", "--segment-frames", "16384", "--device", "cuda",
                   "--out-dir", str(work / "out-loop")], perf_out=perf)
    require(rc == 0 and perf[0]["frames"] == perf[0]["expected_frames"],
            f"loop bounce: {perf}")
    audio = read_wav(Path(perf[0]["wav"]))[0]
    song = compile_song(SongSettings.from_project_file(loop_path), paths)
    want = np.concatenate(list(StreamingRenderer(song, "cpu", 16384)
                               .stream_loop(2, 8, iterations=2)))
    q_cpu = quantize_16bit(torch.from_numpy(want)).numpy().astype(np.int32)
    q_gpu = (audio * 32768.0).round().astype(np.int32)
    diff = int(abs(q_gpu - q_cpu).max())
    emit("check", project="sidechain-10s-loop", frames=perf[0]["frames"],
         loop_frames=perf[0]["loop_frames"],
         expected_frames=perf[0]["expected_frames"],
         max_lsb_diff_vs_cpu_twins=diff)
    require(diff == 0, f"loop bounce differs from the twins by {diff} LSB")

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
    checks["kitchen-sink-10s"] = synth.write_project(
        work / "kitchen-sink-10s.json",
        synth.kitchen_sink_project(CHECK_MEASURES, SONG_BPM))
    checks["perf-1-10s"] = synth.write_project(
        work / "perf-1-10s.json", synth.perf1_project(PERF1_CHECK_MEASURES))
    checks["fm-10s"] = synth.write_project(
        work / "fm-10s.json", synth.fm_project(CHECK_MEASURES, SONG_BPM))
    checks["instruments-10s"] = synth.write_project(
        work / "instruments-10s.json",
        synth.instruments_project(CHECK_MEASURES, SONG_BPM))
    checks["midi-10s"] = work / "midi-10s.mid"
    checks["midi-10s"].write_bytes(synth.midi_song(MIDI_CHECK_MEASURES,
                                                   SONG_BPM))
    card_cap = note_chunk_cap(dev)  # it decides how Welsh sums group
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
        compiled = compile_midi_file(path, paths) if path.suffix == ".mid" \
            else compile_song(SongSettings.from_project_file(path), paths)
        t0 = time.perf_counter()
        q_cpu = Renderer(compiled, device="cpu",
                         note_chunk_elems=card_cap).render_quantized()
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
    # the 3-minute Welsh analogue offline against its stream: the cascade
    # regroups between the stream's 64-frame grid and the whole windows
    streamed, offline = per_song["welsh"][1], per_song["welsh-offline"][1]
    lsb = int(abs((streamed * 32768.0).round()
                  - (offline * 32768.0).round()).max())
    db = 20.0 * float(np.log10(abs(streamed - offline).max()
                               / max(1.0, float(abs(streamed).max()))
                               + 1e-30))
    emit("check", project="welsh", offline_vs_streamed_dbfs=db,
         offline_vs_streamed_max_lsb=lsb)
    require(db <= -80.0, f"welsh: offline reads {db:.1f} dBFS against "
            "the stream")
    # a short Welsh song offline on the card and on the CPU twins, both
    # with the card's element cap (it decides how the timeline's sums
    # group)
    card = Renderer(welsh10, dev)
    t0 = time.perf_counter()
    q_cpu = Renderer(welsh10, "cpu", note_chunk_elems=card.note_chunk_elems
                     ).render_quantized()
    cpu_s = time.perf_counter() - t0
    q_gpu = card.render_quantized()
    diff = int(abs(q_gpu.astype("int32") - q_cpu).max())
    emit("check", project="welsh-10s-offline", frames=len(q_cpu),
         note_chunk_elems=card.note_chunk_elems,
         launches_per_render=card.welsh_launches(),
         cpu_twin_render_s=cpu_s, max_lsb_diff_vs_cpu_twins=diff,
         wav_peak=float(abs(q_gpu).max()) / 32768.0)
    require(diff == 0 and abs(q_gpu).max() > 1000,
            f"welsh-10s offline: card render differs from the twins by "
            f"{diff} LSB")
    del card

    kernels = []
    for name, (src, rep) in KERNELS.items():
        res = main_shape[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": totals[name], "max_abs_err": res["max_abs_err"],
            "ms": res["ms"], "plain_ms": res["plain_ms"],
            "bound_ms": res["bound_ms"], "bound_by": res["bound_by"],
            "library_ms": library.get(name)})
    print(json.dumps({"kernels": kernels}))
    print(name_power)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
