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
at 64-frame blocks; also the live Welsh voices' two filter sections) and
S4 (csrc/serial.cu biquad_serial_state: the serial scan), each with its
state carried in and out; and live playback from MIDI bytes through the
whole song graph, a block at a time.

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
     of the FM, Welsh and MIDI songs and of the Welsh voice branches the
     analogue leaves out (testing/synth.WELSH_VARIANTS: a gliding lead, a
     lead under a pitch LFO on host phase tables, a unison pad), held
     under the card's element cap (engine/render.NOTE_PEAK_BYTES_PER_ELEM);
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
     call, each alone beside its bound (S1 and S2 also on the card alone,
     device_ms), torch's associative_scan beside S1 and S2 at 10 s and 3
     minutes (library: S2's in block space, the tail as chunk 0); the
     3-minute kitchen-sink and filter-bank analogues
     through `cli --wav --perf --stream` at the default 262144-frame
     segments (launches against the renderer's plan: x realtime, set-up,
     peak device memory); the 10-second kitchen-sink, instruments, FM,
     sidechain and filter-bank analogues streamed on the card at one
     segment and at 4096-frame segments (the same bits), their CLI WAVs
     equal to the CPU twins' (0 LSB); a `--loop` bounce on the card equal
     to the CPU twins' bounce.
  7. live playback (engine/livesong.py): the live analogue
     (testing/synth.live_project: a Welsh pad with a noise oscillator and
     an S&H LFO, an FM voice, the 707 kit, a sampler, an envelope
     instrument and a free-running oscillator through a compressor and a
     limiter (S1), a reverb (S2), a delay, filters on S3 and S4, a
     sidechain link, a send and a trip) played through LiveSongService by
     the scripted performance (testing/synth.live_performance), its MIDI
     bytes through a pipe, the sink a list: 2 s at 64-frame blocks and
     10 s at 4096, live input only and along with the song. Each run with
     the launch counts set to 0 just before it and read just after,
     against the renderer's live_launches() plan; each block's wall
     milliseconds (median, p99) against its realtime; torch operations a
     block (by device) and the card's busy time (a profiler); S3 at the
     live shape [8, 64] (the pad's filter section, BLOCK mode with state)
     against its twin with its time and bound; the pipelined pull equal
     to the plain pull; the native null sink for 2 s at 64 frames (its
     underruns); then every run against the CPU twins' render of the same
     performance, bit for bit (rendered meanwhile by two background
     processes, `chip_smoke.py --live-twin`, with no card visible; a
     difference names the first device whose block output parts).
  8. the front ends (frontends_phase: the engine service, the web GUI,
     cli --debug), run before 7.
  9. multi-device and timeline-sharded rendering (parallel_phase, run
     before 7; the card's one device as logical shards): the 3-minute
     kitchen sink through parallel.multidevice.MultiDeviceRenderer on
     every visible device (within 1e-6 of the peak of Renderer,
     render_quantized = the host quantization, the CLI's WAV to 1 LSB,
     launches = its sub-renderers' = PER_RENDER; steady ms beside
     Renderer's; the host synchronisations each component's dispatch
     makes, of five songs, by source line); the same song through
     parallel.meshrender.MeshRenderer on 4 shards (auto iterations K:
     within 2e-4 of the peak of the stream, (K + 1) x 4 steps, launches
     (K + 1) x 4 x a segment's plan; steady ms beside cli --stream's);
     parallel.timeshard.biquad_timesharded on 4 shards of a 10-second
     sweep against one S3 chain (bar TIMESHARD_BAR_DB; 8 S3 launches);
     parallel.mesh.sharded_welsh_mix_step, 8 tracks on 4 shards, against
     the plain loop (1e-4); the 3-minute Welsh analogue through cli
     --stream --sliced at 4096 frames with
     StreamingRenderer.WELSH_SLICE_MERGE: the unmerged WAV's bits, one
     K7 and one K8 a segment, steady seconds beside the unmerged run's.
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
S1's and S2's are the serial order the stream pins (stream_calls): S / 64
and ceil(S / D) steps of 2 dependent operations.
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

START = time.monotonic()
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
# the Welsh voice branches whose note batches bucket_peaks also measures
# (testing/synth.WELSH_VARIANTS), and their lengths in measures: the
# pitch-LFO lead at 40 (80 s), where its bucket takes the host phase
# tables (its 3-minute bucket is past welsh.HOST_PHASE_MAX_ELEMS)
WELSH_VARIANT_MEASURES = {"glide": SONG_MEASURES, "pitch-lfo": 40,
                          "unison": SONG_MEASURES}


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


def library_drums(hits, n: int) -> dict:
    """Tensor.index_add_ as K1's library call: every hit's window (its
    table row times vel / 127, cut at its limit and at n), prepared
    before the timing as one [2, m] array with its m target frames, added
    into a zeroed [2, n] along the time axis. The order of its atomic adds
    is the card's, so it is not bitwise the kernel. A yardstick only: the
    port never calls it."""
    import torch

    from groove_tpu_torch.ops.drums import CHUNK

    table, counts, slots, starts, shifts, limits, vels = hits
    cnt, sl, st, sh, li = (t.cpu().tolist()
                           for t in (counts, slots, starts, shifts, limits))
    scale = vels / torch.full_like(vels, 127.0)
    wins, idx = [], []
    for c, count in enumerate(cnt):
        for i in range(count):
            on = c * CHUNK + st[c][i] + 64 * sh[c][i]
            ln = min(li[c][i], n - on)
            if ln > 0:
                wins.append(table[sl[c][i], :, :ln] * scale[c, i])
                idx.append(torch.arange(on, on + ln, device=table.device))
    values, index = torch.cat(wins, 1), torch.cat(idx)

    def call():
        out = torch.zeros((2, n), dtype=torch.float32, device=table.device)
        return out.index_add_(1, index, values)

    ms, y = cuda_ms(call, 20)
    return {"library_ms": ms, "library_call": "Tensor.index_add_ (dim 1)",
            "library_out": y, "windows": len(wins),
            "window_elements": int(values.shape[1])}


def library_scan(x, a, b, dim: int = -1) -> dict:
    """torch's prototype associative_scan (torch._higher_order_ops) on the
    linear scan's inputs: one call over (a, b x) along `dim` with the
    reference's combine. combine_mode "pointwise" (compiled) where it
    runs, else "generic". A yardstick only: the port never calls it."""
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
                combine, (aa, bx), dim=dim, combine_mode=m)[1], 5)
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
    (S4's twin on the CPU: a loop over samples).

    S1's and S2's chains are the order the stream pins, not a log-depth
    scan's (scan_work's, which scan1 keeps: nothing pins its order). Their
    state is one value (S1: y entering a 64-block) or the last D samples
    (S2), and any 64-multiple cut must give the bits of one call, so every
    block's map applies to the value its predecessor left, never composed
    with it first (that would round differently): S1 is S / 64 steps of
    two dependent operations (a multiply, then the add or the max), after
    the linear mode's b x; S2 is ceil(S / D) steps of two a lane (the
    multiply by g, then the add)."""
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

    b_ps = 1 - a_ps

    def s1(fn_a, fn_b, mode):
        def run(lo, hi, st, plain):
            f = sk.scan_stream_plain if plain else sk.scan_stream
            y, last = f(mag[:, lo:hi], fn_a(lo, hi), fn_b(lo, hi), st[0],
                        mode)
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

    def s1_work(a, b, mode):
        io, flops, _ = scan_work(mag, a, b, -1, mode)
        return io, flops, 2.0 * (n // 64) + (1.0 if mode == LINEAR else 0.0)

    return [
        ("follower attack, per-sample a", "scan_stream",
         s1(lambda lo, hi: a_ps[lo:hi], lambda lo, hi: b_ps[lo:hi], LINEAR),
         (mag[:, 0] * 0.5,), s1_work(a_ps, b_ps, LINEAR)),
        ("peak hold, number r", "scan_stream",
         s1(lambda lo, hi: r_num, lambda lo, hi: 1.0, MAX_DECAY),
         (mag[:, 0] * 0.5,), s1_work(r_num, 1.0, MAX_DECAY)),
        ("comb D = 1927, per-sample g", "comb_stream", comb,
         (hx, 0.5 * hx), (comb_io, 2.0 * numel,
                          2.0 * math.ceil(n / 1927))),
        ("all-pass D = 75", "comb_stream", allpass,
         (bus[:, 3000:3075].contiguous(),),
         (ap_io, 5.0 * numel, 2.0 * math.ceil(n / 75))),
        ("block-rate table (band-pass sweep)", "biquad_stream",
         s3([co[j] for j in range(5)]), pair,
         iir_work("S3", rows, n, coef_bytes([co[j] for j in range(5)]), 2)),
        ("static (peaking EQ)", "biquad_stream", s3(peq), pair,
         iir_work("S3", rows, n, 0.0, 2)),
        ("serial (high-pass 40 Hz)", "biquad_serial_stream", s4, pair,
         iir_work("S4", rows, n, 0.0, 2)),
    ]


def chunk_scan_inputs(x, tail, g, D: int):
    """(a, b) of the delay lines' recurrence in block space, [R, nc + 1, D]
    with the carried tail as chunk 0, the form the offline path gives
    scan1: the comb's y_c = g_c y_(c-1) + x_(c-1) (tail = (hx, hy), x_-1 =
    hx, y_-1 = hy) or the all-pass's w_c = g w_(c-1) + x_c (tail = (hw,),
    g a number). torch's associative_scan over dim 1 of (a, b) is the
    library yardstick of S2 (library_scan(b, a, 1.0, dim=1)); the
    all-pass's y, an elementwise pass after it, is not timed."""
    import torch

    R, S = x.shape
    nc = -(-S // D)
    pad = lambda t: torch.nn.functional.pad(t, (0, nc * D - S))  # noqa
    xc = pad(x).reshape(R, nc, D)
    zero = torch.zeros((R, 1, D), dtype=x.dtype, device=x.device)
    if len(tail) == 2:  # comb
        gc = pad(g.expand(R, S).contiguous()).reshape(R, nc, D)
        prev = torch.cat([tail[0][:, None], xc[:, :-1]], 1)
        return (torch.cat([zero, gc], 1),
                torch.cat([tail[1][:, None], prev], 1))
    a = torch.full((R, nc, D), float(g), dtype=x.dtype, device=x.device)
    return torch.cat([zero, a], 1), torch.cat([tail[0][:, None], xc], 1)


def stream_library(r, bus, size: str) -> dict:
    """torch's associative_scan beside S1 and S2 on a kitchen-sink drum
    bus (Renderer `r`): the follower's attack one-pole over the bus, and
    the automated comb (D = 1927) and the all-pass (D = 75) in block space
    (chunk_scan_inputs), from stream_calls' carried tails. Emits a
    "library" phase each; returns {name: the first call's library_ms}."""
    from groove_tpu_torch.ops import delayfx, dynamics, iir

    sr = float(r.c.sample_rate)
    n = bus.shape[-1]
    trip = iir.upsample_hold(r.inputs["comp-trip/auto/release"], n)
    a_ps = dynamics._follower_coef(trip * 0.1, sr)
    sec = iir.upsample_hold(r.inputs["reverb-trip/auto/seconds"], n)
    hx = bus[:, 1000:1000 + 1927].contiguous()
    calls = [
        ("scan_stream", "follower attack, per-sample a",
         (bus.abs(), a_ps, 1 - a_ps)),
        ("comb_stream", "comb D = 1927, per-sample g (block space)",
         (*chunk_scan_inputs(bus, (hx, 0.5 * hx),
                             delayfx.reverb_comb_g(sec, 1927, sr),
                             1927)[::-1], 1.0, 1)),
        ("comb_stream", "all-pass D = 75 (block space)",
         (*chunk_scan_inputs(bus, (bus[:, 3000:3075].contiguous(),),
                             delayfx.ALLPASS_G, 75)[::-1], 1.0, 1))]
    out = {}
    for name, label, args in calls:
        lib = library_scan(*args)
        lib.pop("library_out", None)
        emit("library", name=name, call=label, size=size,
             shape=list(args[0].shape), **lib)
        out.setdefault(name, lib["library_ms"])
    return out


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
        if name in ("scan_stream", "comb_stream"):
            res["device_ms"] = graph_ms(lambda: run(0, n, st0, False))
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
    handed over as [rows, 64, nb] along axis 1 (block space), the block
    prefix [rows, nb] on the time axis and the sum of what its rounding
    lost (fm.exclusive_mod1); then the in-block sums on
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
    y = scan1(blk, 1.0)
    lost = blk - (y - torch.nn.functional.pad(y[..., :-1], (1, 0)))
    return [
        ("fm in-block sums, [rows, 64, nb] on axis 1",
         inc3.transpose(1, 2), 1.0, 1.0, 1, LINEAR),
        ("fm block prefix, [rows, nb]", blk, 1.0, 1.0, -1, LINEAR),
        ("fm block prefix's rounding, [rows, nb]", lost, 1.0, 1.0, -1,
         LINEAR),
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


# ---- 7. live playback -------------------------------------------------------
# (mode, frames a block, seconds of audio): the live analogue
# (testing/synth.live_project) played by the scripted performance, live
# input only and along with the song, at the audio callback's 64 frames and
# in the lookahead mode's 4096
LIVE_RUNS = (("live", 64, 2.0), ("play", 64, 2.0), ("live", 4096, 10.0),
             ("play", 4096, 10.0))
LIVE_MEASURES = 2   # the sequenced song: 4 s at 120 bpm, so the 10-second
#                     play-along switches to live input at its end
# the CPU twins' renders of LIVE_RUNS, in background processes started
# before phase 3 (one process a group, one torch thread each)
LIVE_TWIN_GROUPS = ((("play", 64, 2.0),),
                    (("live", 64, 2.0), ("live", 4096, 10.0),
                     ("play", 4096, 10.0)))
LIVE_PROFILE_BLOCKS = 16  # blocks counted for operations and device time


def live_compiled(assets):
    from groove_tpu_torch.compiler.song import compile_song
    from groove_tpu_torch.project.paths import Paths
    from groove_tpu_torch.project.schema import SongSettings
    from groove_tpu_torch.testing import synth

    return compile_song(SongSettings.from_json(
        synth.live_project(LIVE_MEASURES)), Paths(roots=[assets]))


def live_schedule(block: int, seconds: float) -> list:
    from groove_tpu_torch.testing import synth

    return synth.block_schedule(synth.live_performance(seconds), block,
                                int(seconds * 44100) // block)


def tap_digests(taps: dict) -> dict:
    """Each device's output of a block as a short hash of its bytes."""
    import hashlib

    return {u: hashlib.sha1(t.detach().cpu().numpy().tobytes()
                            ).hexdigest()[:16] for u, t in taps.items()}


def live_twin_main(argv) -> int:
    """--live-twin ASSETS OUT MODE:BLOCK:SECONDS...: render LIVE_RUNS'
    performances on the CPU twins (one torch thread) into OUT: the audio
    (.npy) and each block's per-device digests and the seconds it took
    (.json)."""
    import numpy as np
    import torch

    from groove_tpu_torch.engine.livesong import LiveSongRenderer
    from groove_tpu_torch.testing import synth

    torch.set_num_threads(1)
    assets, out = Path(argv[0]), Path(argv[1])
    compiled = live_compiled(assets)
    for job in argv[2:]:
        mode, block, seconds = job.split(":")
        block, seconds = int(block), float(seconds)
        r = LiveSongRenderer(compiled, block_frames=block,
                             play_song=mode == "play", device="cpu")
        r.taps = {}
        digests = []
        t0 = time.perf_counter()
        audio = synth.play_live(
            r, live_schedule(block, seconds),
            after_block=lambda: digests.append(tap_digests(r.taps)))
        took = time.perf_counter() - t0
        np.save(out / f"{mode}-{block}.npy", audio)
        (out / f"{mode}-{block}.json").write_text(json.dumps(
            {"seconds": took, "digests": digests}))
    return 0


def start_live_twins(work: Path, assets: Path) -> tuple:
    """Start LIVE_TWIN_GROUPS' CPU processes (no card visible to them);
    returns (output directory, processes). They are stopped at exit."""
    import atexit

    out = work / "live-twins"
    out.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    procs = []
    for k, group in enumerate(LIVE_TWIN_GROUPS):
        log = open(out / f"worker-{k}.log", "w")
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--live-twin",
             str(assets), str(out)]
            + [f"{m}:{b}:{sec}" for m, b, sec in group],
            env=env, stdout=log, stderr=subprocess.STDOUT, cwd=str(ROOT)))

    def stop():
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    atexit.register(stop)
    return out, procs


class OpCount:
    """Counts the torch operations dispatched on CUDA tensors inside it
    (views included; the hand kernels' ctypes launches are not torch
    operations)."""

    def __enter__(self):
        import torch
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils._pytree import tree_leaves

        counter = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                if any(isinstance(t, torch.Tensor) and t.is_cuda
                       for t in tree_leaves((args, kwargs, out))):
                    counter.n += 1
                return out

        self.n = 0
        self._mode = Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)


FRONTEND_TEMPO = 132.0   # the tempo the service and the web GUI set
FRONTEND_LOOP = (8.0, 16.0)  # the loop range bounced twice (beats)
FRONTEND_PLAY_S = 2.0    # seconds of playback through the null sink
FRONTEND_PIANO = (0, 60, 110)  # the piano strip's note: channel, key, vel
FRONTEND_LIVE_BLOCKS = 32  # 64-frame blocks in one /api/audio/live chunk


def frontends_phase(dev, work: Path, files: dict, per_song: dict,
                    zero_launches, launches, totals) -> None:
    """Phase 8: the interactive front ends on the card, at the 3-minute
    size. EngineService(device="cuda", use_audio=True) on the kitchen-sink
    analogue's project file: render-wav = the CLI's --wav byte for byte,
    with the launches PER_RENDER plans (counts set to 0 just before, read
    just after); set_tempo then render-wav = a fresh Renderer's
    render_quantized at the new tempo; a loop bounce = StreamingRenderer.
    stream_loop called directly; one instrument on the worker = the main
    thread's _render_instrument; play, then stop, through the native null
    sink. The web GUI in process on port 0 over the Welsh analogue: state,
    a tempo command, /api/audio = the CLI's WAV at that tempo, and the
    first chunk of /api/audio/live after a piano note = the CPU twins'
    LiveSongRenderer, 64-frame blocks (S3 and scan1 launched). The CLI's
    --debug --quiet --mp3 on the north star. One "frontends" line: each
    check's result and milliseconds; any "error" event fails the run."""
    import json as json_
    import threading
    import urllib.request

    import numpy as np

    from groove_tpu_torch import cli
    from groove_tpu_torch.compiler.song import compile_song
    from groove_tpu_torch.engine.livesong import LiveSongRenderer
    from groove_tpu_torch.engine.render import Renderer
    from groove_tpu_torch.engine.service import EngineService
    from groove_tpu_torch.engine.stream import StreamingRenderer
    from groove_tpu_torch.gui.web import WebGui, make_server
    from groove_tpu_torch.io import native
    from groove_tpu_torch.io.wav import _chunk_to_i2, write_wav_16bit_stereo
    from groove_tpu_torch.project.schema import SongSettings
    from groove_tpu_torch.testing import synth
    from groove_tpu_torch.utils.profiling import sync

    fe = work / "frontends"
    fe.mkdir(parents=True, exist_ok=True)
    os.environ["GROOVE_TPU_PREFS"] = str(fe / "prefs.json")
    require(native.available(), "the native audio library did not build")
    checks = {}
    t_phase = time.perf_counter()

    def check(name: str, ok: bool, t0: float, **facts) -> None:
        checks[name] = {"ok": bool(ok),
                        "ms": (time.perf_counter() - t0) * 1e3, **facts}

    def wav_bytes(path: Path, samples) -> bytes:
        write_wav_16bit_stereo(path, samples, 44100)
        return path.read_bytes()

    # the service on the card, its sink's consumed frames recorded
    consumed = []

    class Recorded(native.AudioService):
        def stop(self):
            consumed.append(self.frames_consumed())
            super().stop()

    events = []
    native_service = native.AudioService
    native.AudioService = Recorded
    svc = EngineService(on_event=lambda k, d: events.append((k, d)),
                        use_audio=True, device=dev)
    try:
        # 1. render-wav = cli --wav of the same project, launches as planned
        t0 = time.perf_counter()
        svc.open_project(files["kitchen-sink"])
        require(svc.sync(), "service: open timed out")
        compiled = svc.ensure_compiled()
        zero_launches()
        svc.render_wav(fe / "service.wav")
        require(svc.sync(), "service: render-wav timed out")
        sync(dev)
        got = launches()
        for k in totals:
            totals[k] += got[k]
        cli_wav = Path(per_song["kitchen-sink"][0]["wav"]).read_bytes()
        first = (fe / "service.wav").read_bytes()
        want = {k: PER_RENDER["kitchen-sink"].get(k, 0) for k in got}
        check("service_wav_equals_cli_wav", first == cli_wav, t0,
              bytes=len(first), launches={k: v for k, v in got.items() if v},
              planned=PER_RENDER["kitchen-sink"],
              launches_as_planned=got == want)
        require(got == want, f"service render launched {got}, planned {want}")
        # 2. a tempo change, rendered again = a fresh Renderer at it
        t0 = time.perf_counter()
        svc.set_tempo(FRONTEND_TEMPO)
        svc.render_wav(fe / "service-tempo.wav")
        require(svc.sync(), "service: tempo render timed out")
        second = (fe / "service-tempo.wav").read_bytes()
        song = SongSettings.from_project_file(files["kitchen-sink"])
        song.clock.bpm = FRONTEND_TEMPO
        fresh = Renderer(compile_song(song), dev).render_quantized()
        check("tempo_render_equals_a_fresh_renderer",
              second != first
              and second == wav_bytes(fe / "fresh.wav", fresh), t0,
              bpm=FRONTEND_TEMPO, frames=len(fresh))
        # 3. a loop bounce = stream_loop called directly
        t0 = time.perf_counter()
        svc.set_loop(*FRONTEND_LOOP)
        zero_launches()
        svc.render_loop_wav(fe / "loop.wav", iterations=2)
        require(svc.sync(), "service: loop bounce timed out")
        sync(dev)
        got = launches()
        compiled = svc.ensure_compiled()
        zero_launches()
        direct = np.concatenate(list(StreamingRenderer(compiled, dev)
                                     .stream_loop(*FRONTEND_LOOP,
                                                  iterations=2)))
        sync(dev)
        direct_got = launches()
        stream_names = ("scan_stream", "comb_stream", "biquad_stream")
        same = (fe / "loop.wav").read_bytes() \
            == wav_bytes(fe / "direct-loop.wav", direct)
        check("loop_bounce_equals_stream_loop",
              same and got == direct_got
              and all(got[k] > 0 for k in stream_names), t0,
              bytes_equal=same, launches_equal=got == direct_got,
              loop_beats=list(FRONTEND_LOOP), frames=len(direct),
              launches={k: v for k, v in got.items() if v})
        # 4. one instrument on the worker = the main thread's render
        t0 = time.perf_counter()
        iso = svc.rendered_samples(device="drums")
        r = Renderer(compiled, dev)
        alone = r._render_instrument(r.inputs, compiled.devices["drums"],
                                     compiled.n_frames).cpu().numpy().T
        check("isolated_instrument_equals_main_thread",
              iso is not None and np.array_equal(iso, alone)
              and float(abs(alone).max()) > 0.01, t0, device="drums",
              frames=len(alone))
        del r
        # 5. play, then stop, through the native null sink
        t0 = time.perf_counter()
        svc.clear_loop()
        svc.play()
        deadline = time.monotonic() + 120.0
        while not svc.is_playing() and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(FRONTEND_PLAY_S)
        svc.stop()
        require(svc.sync(), "service: stop timed out")
        kinds = [k for k, _ in events]
        check("play_and_stop_through_the_null_sink",
              "playback-started" in kinds and "playback-stopped" in kinds
              and len(consumed) == 1
              and consumed[0] > 0.5 * FRONTEND_PLAY_S * 44100, t0,
              frames_consumed=consumed[:1], seconds=FRONTEND_PLAY_S)
    finally:
        svc.shutdown()
        native.AudioService = native_service
    errors = [d for k, d in events if k == "error"]
    require(not errors, f"the service reported errors: {errors}")

    # 6. the web GUI over the Welsh analogue
    welsh = synth.welsh_project(SONG_MEASURES, SONG_BPM)
    welsh_path = synth.write_project(fe / "welsh.json", welsh)
    before = set(threading.enumerate())
    gui = WebGui(use_audio=False, device=dev)
    srv = make_server(gui, 0)
    server = threading.Thread(target=srv.serve_forever, daemon=True)
    server.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"

    def get(path: str) -> bytes:
        with urllib.request.urlopen(base + path, timeout=600) as resp:
            return resp.read()

    def cmd(name: str, **a) -> dict:
        req = urllib.request.Request(
            base + "/api/cmd", data=json_.dumps({"cmd": name, **a}).encode(),
            method="POST")
        with urllib.request.urlopen(req, timeout=600) as resp:
            return json_.loads(resp.read())

    try:
        t0 = time.perf_counter()
        ok = cmd("open", path=str(welsh_path))["ok"]
        ok = ok and cmd("bpm", value=FRONTEND_TEMPO)["ok"]
        state = json_.loads(get("/api/state"))
        check("web_state_and_tempo_command",
              ok and state["bpm"] == FRONTEND_TEMPO
              and state["title"] == welsh["title"], t0,
              tracks=len(state["tracks"]))
        t0 = time.perf_counter()
        audio = get("/api/audio")
        at_tempo = synth.write_project(
            fe / "welsh-at-tempo.json",
            {**welsh, "clock": {**welsh["clock"], "bpm": FRONTEND_TEMPO}})
        rc = cli.main([str(at_tempo), "--wav", "--quiet", "--device",
                       str(dev), "--out-dir", str(fe / "cli")])
        cli_wav = (fe / "cli" / "welsh-at-tempo.wav").read_bytes()
        check("web_audio_equals_cli_wav", rc == 0 and audio == cli_wav, t0,
              bytes=len(audio))
        t0 = time.perf_counter()
        live = gui.live_renderer()
        channel, key, vel = FRONTEND_PIANO
        ok = cmd("note_on", key=key, velocity=vel, channel=channel)["ok"]
        zero_launches()
        with urllib.request.urlopen(base + "/api/audio/live",
                                    timeout=600) as resp:
            head = resp.read(44)
            pcm = resp.read(4 * 64 * FRONTEND_LIVE_BLOCKS)
        got = launches()
        card_ms = (time.perf_counter() - t0) * 1e3
        twin = LiveSongRenderer(gui.model.svc.ensure_compiled(), n_voices=8,
                                device="cpu")
        twin.note_on(channel, key, vel)
        want = _chunk_to_i2(np.concatenate(
            [twin.render_block() for _ in range(FRONTEND_LIVE_BLOCKS)]))
        block = np.frombuffer(pcm, "<i2").reshape(-1, 2)
        same = bool(np.array_equal(block, want))
        check("web_live_chunk_equals_cpu_twins",
              ok and head[:4] == b"RIFF" and live.device == dev and same
              and abs(block).max() > 0
              and got["biquad_stream"] > 0 and got["scan1"] > 0, t0,
              pcm_equal=same,
              blocks=FRONTEND_LIVE_BLOCKS, block_frames=64,
              card_chunk_ms=card_ms, peak_lsb=int(abs(block).max()),
              launches={k: v for k, v in got.items() if v})
    finally:
        srv.shutdown()
        srv.server_close()
        gui.model.svc.shutdown()
        # the live listener's request thread renders on until it finds its
        # connection closed: no launch of it may land in a later count
        for t in set(threading.enumerate()) - before:
            t.join(timeout=120.0)
    require(not set(threading.enumerate()) - before,
            "the web GUI's threads did not end")
    errors = [d for k, d in gui.model.events if k == "error"]
    require(not errors, f"the web GUI reported errors: {errors}")

    # 7. cli --debug --quiet --mp3 on the north star
    t0 = time.perf_counter()
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main([str(files["north-star"]), "--wav", "--debug",
                       "--quiet", "--mp3", "--device", str(dev), "--out-dir",
                       str(fe / "debug")])
    rows = [ln.split() for ln in out.getvalue().splitlines()]
    north = compile_song(SongSettings.from_project_file(files["north-star"]))
    debug_wav = (fe / "debug" / "north-star.wav").read_bytes()
    check("cli_debug_quiet_mp3",
          rc == 0 and [r[1] for r in rows] == list(north.order)
          and all(r[-1] == "ms" and float(r[-2]) >= 0 for r in rows)
          and err.getvalue().strip() == "MP3 output is not yet implemented"
          and debug_wav == Path(per_song["north-star"][0]["wav"]).read_bytes(),
          t0, rows={r[1]: float(r[-2]) for r in rows})
    emit("frontends", checks=checks,
         seconds=time.perf_counter() - t_phase)
    failed = [k for k, v in checks.items() if not v["ok"]]
    require(not failed, f"frontends: {failed} failed: "
            f"{ {k: checks[k] for k in failed} }")


def live_phase(dev, work: Path, assets: Path, twins, zero_launches,
               launches, totals) -> None:
    """Phase 7: the live analogue on the card through LiveSongService (the
    performance's MIDI bytes through a pipe, the sink a list): LIVE_RUNS
    with each block's wall milliseconds (median, p99) against the block's
    realtime, the launches against the renderer's live_launches() plan
    (counts set to 0 just before, read just after), torch operations and
    kernel launches a block and the card's busy time (LIVE_PROFILE_BLOCKS
    blocks); S3 at the live shape [8, 64] against its twin; the pipelined
    pull against the plain one; the native null sink for 2 s at 64 frames
    (underruns); then each run against the CPU twins' render of the same
    performance (the background processes), bit for bit, naming the first
    device whose output parts where they differ."""
    import numpy as np
    import torch

    from groove_tpu_torch.engine.livesong import (LiveSongRenderer,
                                                  LiveSongService)
    from groove_tpu_torch.io import native
    from groove_tpu_torch.ops import stream_kernels as sk
    from groove_tpu_torch.testing import synth

    compiled = live_compiled(assets)
    sr = float(compiled.sample_rate)
    cards = {}
    for mode, block, seconds in LIVE_RUNS:
        t0 = time.perf_counter()
        r = LiveSongRenderer(compiled, block_frames=block,
                             play_song=mode == "play", device=dev)
        setup_s = time.perf_counter() - t0
        sched = live_schedule(block, seconds)
        n_blocks = len(sched)
        played = sum(1 for k in range(n_blocks)
                     if mode == "play" and k * block < r.plan_frames)
        want = {}
        for flag, count in ((True, played), (False, n_blocks - played)):
            for k, v in r.live_launches(flag).items():
                want[k] = want.get(k, 0) + v * count
        times = []
        zero_launches()
        audio = synth.play_live(r, sched, times=times)
        got = {k: v for k, v in launches().items() if v}
        for k in totals:
            totals[k] += got.get(k, 0)
        cards[(mode, block)] = audio
        ms = np.asarray(times) * 1e3
        budget = block / sr * 1e3
        peak = float(np.abs(audio).max())
        emit("live", mode=mode, block_frames=block, blocks=n_blocks,
             seconds_of_audio=n_blocks * block / sr, setup_s=setup_s,
             block_ms_median=float(np.median(ms)),
             block_ms_p99=float(np.percentile(ms, 99)),
             block_ms_max=float(ms.max()), realtime_ms=budget,
             xrt=budget / float(np.median(ms)),
             over_realtime_share=float((ms > budget).mean()),
             launches=got, planned_launches=want,
             play_blocks=played, peak=peak)
        require(got == want, f"live {mode} {block}: launched {got}, "
                f"planned {want}")
        require(bool(np.isfinite(audio).all()) and 0.01 < peak < 1.0,
                f"live {mode} {block}: peak {peak}")
        # torch operations a block by device, then kernel launches and the
        # card's busy time a block, each on the performance's first blocks
        # played again by a fresh renderer (in the same mode; its
        # constructor rendered a warm-up block)
        more = sched[:LIVE_PROFILE_BLOCKS]
        r = LiveSongRenderer(compiled, block_frames=block,
                             play_song=mode == "play", device=dev)
        by_device: dict = {}

        def counted(fn):
            def run(device, *args, **kw):
                n0 = ops.n
                out = fn(device, *args, **kw)
                by_device[device.uvid] = by_device.get(device.uvid, 0) \
                    + ops.n - n0
                return out
            return run

        r._render_instrument_seg = counted(r._render_instrument_seg)
        r._apply_effect_seg = counted(r._apply_effect_seg)
        with OpCount() as ops:
            synth.play_live(r, more[:LIVE_PROFILE_BLOCKS // 2])
        counted_blocks = len(more[:LIVE_PROFILE_BLOCKS // 2])
        r = LiveSongRenderer(compiled, block_frames=block,
                             play_song=mode == "play", device=dev)
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        t0 = time.perf_counter()
        with prof:
            synth.play_live(r, more)
        wall = time.perf_counter() - t0
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_us = sum(e.time_range.elapsed_us() for e in events)
        n_prof = len(more)
        emit("live_profile", mode=mode, block_frames=block,
             blocks=n_prof, torch_ops_per_block=ops.n / counted_blocks,
             torch_ops_per_block_by_device={
                 u: v / counted_blocks for u, v in sorted(
                     by_device.items(), key=lambda kv: -kv[1])},
             device_events_per_block=len(events) / n_prof,
             device_busy_ms_per_block=(busy_us / 1e3 / n_prof
                                       if events else "not measured"),
             wall_ms_per_block=wall * 1e3 / n_prof,
             device_idle_share=(1.0 - busy_us / 1e6 / wall
                                if events else "not measured"))

    # S3 at the live shape: the pad's first filter section of a block
    captured = []
    plain_call = sk.biquad_state

    def capture(x, coefs, state):
        if tuple(x.shape) == (8, 64) and not captured:
            captured.append((x.clone(), tuple(c.clone() for c in coefs),
                             tuple(t.clone() for t in state)))
        return plain_call(x, coefs, state)

    r = LiveSongRenderer(compiled, block_frames=64, device=dev)
    for key in (48, 55, 60, 64):
        r.note_on(synth.LIVE_CHANNELS["pad"], key, 100)
    for _ in range(8):
        r.render_block()
    sk.biquad_state = capture
    try:
        r.render_block()
    finally:
        sk.biquad_state = plain_call
    require(len(captured) == 1, "no S3 call at [8, 64] in a live block")
    x, secs, st = captured[0]

    def flat(out):
        return (out[0], *out[1])

    res = compare("biquad_stream",
                  lambda: flat(sk.biquad_state(x, secs, st)),
                  lambda: flat(sk.biquad_state_plain(x, secs, st)),
                  x.abs().max(), iir_work("S3", 8, 64, coef_bytes(secs), 2),
                  reps=200, graph=True)
    emit("stream_kernel_check", call="the live Welsh pad's filter "
         "section, BLOCK mode with state", mode=sk._coef_mode(secs, 64),
         **res)
    require(res["bitwise"], f"S3 at [8, 64] differs from its twin: {res}")

    # the pipelined pull against the plain pull, timed
    for block, n in ((64, 100), (4096, 12)):
        outs, per = [], []
        for pipelined in (False, True):
            r = LiveSongRenderer(compiled, block_frames=block, device=dev)
            for ch, key in ((0, 48), (0, 55), (1, 64), (9, 35), (2, 60),
                            (3, 69)):
                r.note_on(ch, key, 100)
            pull = r.render_block_pipelined if pipelined else r.render_block
            t0 = time.perf_counter()
            outs.append(np.concatenate([pull() for _ in range(n)]))
            per.append((time.perf_counter() - t0) * 1e3 / n)
        equal = bool(np.array_equal(outs[0], outs[1]))
        emit("live_pipelined", block_frames=block, blocks=n,
             plain_ms_per_block=per[0], pipelined_ms_per_block=per[1],
             equal=equal)
        require(equal, f"pipelined pull differs at {block} frames")

    # the native null sink, paced at realtime, for 2 s at 64 frames
    if native.available():
        r = LiveSongRenderer(compiled, block_frames=64, device=dev)
        r_fd, w_fd = os.pipe()
        svc = LiveSongService(r, midi_source=os.fdopen(r_fd, "rb",
                                                       buffering=0))
        events = synth.live_performance(2.0)
        t0 = time.perf_counter()
        for frame, msg in events:
            wait = t0 + frame / sr - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            os.write(w_fd, msg)
        time.sleep(max(0.0, t0 + 2.0 - time.perf_counter()))
        consumed = svc._audio.frames_consumed()
        underruns = svc.underruns()
        blocks = svc.blocks_rendered
        os.close(w_fd)
        svc.stop()
        emit("live_native", seconds=2.0, block_frames=64,
             frames_consumed=consumed, blocks_rendered=blocks,
             underruns=underruns, events=svc.events_handled)
        require(consumed >= 1.5 * sr and svc.events_handled == len(events),
                f"native sink consumed {consumed} frames, "
                f"{svc.events_handled} of {len(events)} events")
    else:
        emit("live_native", available=False)

    # the CPU twins' renders of the same performances, bit for bit
    out_dir, procs = twins
    for p in procs:
        try:  # within the run's 1200 seconds
            p.wait(timeout=max(10.0, 1080.0 - (time.monotonic() - START)))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
        require(p.returncode == 0, f"a live CPU twin process failed: see "
                f"{out_dir}")
    for mode, block, seconds in LIVE_RUNS:
        twin = np.load(out_dir / f"{mode}-{block}.npy")
        meta = json.loads((out_dir / f"{mode}-{block}.json").read_text())
        card = cards[(mode, block)]
        equal = card.shape == twin.shape and bool(np.array_equal(card, twin))
        emit("live_check", mode=mode, block_frames=block,
             frames=len(twin), cpu_twin_render_s=meta["seconds"],
             bit_for_bit=equal)
        if not equal:
            k = int(np.argmax(np.abs(card - twin).max(-1) > 0)) // block
            r = LiveSongRenderer(compiled, block_frames=block,
                                 play_song=mode == "play", device=dev)
            r.taps = {}
            mine = []
            synth.play_live(r, live_schedule(block, seconds)[:k + 1],
                            after_block=lambda: mine.append(
                                tap_digests(r.taps)))
            parts = [u for u in compiled.order
                     if u in mine[k] and mine[k][u]
                     != meta["digests"][k].get(u)]
            first = parts[0] if parts else "the mix"
            kind = compiled.devices[first].kind \
                if first in compiled.devices else "the main mixer's sum"
            require(False, f"live {mode} {block}: the card differs from "
                    f"the CPU twins from block {k}, first in {first} "
                    f"({kind})")


# ---- 9. multi-device and timeline-sharded rendering -----------------------
MESH_SHARDS = 4  # logical shards of the mesh and the time-sharded biquad
TIMESHARD_FRAMES = 441344  # 10 s, a multiple of 4 shards x 64
# biquad_timesharded against one S3 chain over the whole signal, dBFS of
# its peak: measured on the CPU twins (equal bits at this size, the state
# of a shard 2.5 s long forgotten below float32), held to -120
TIMESHARD_BAR_DB = -120.0
MIX_TRACKS = 8  # sharded_welsh_mix_step: 8 tracks on MESH_SHARDS shards


def host_syncs(fn) -> dict:
    """The host synchronisations `fn` makes (torch's sync debug mode), by
    the port's innermost source line that makes each one."""
    import collections
    import traceback
    import warnings

    import torch

    sites = collections.Counter()

    def hook(message, category, filename, lineno, file=None, line=None):
        frames = [f for f in traceback.extract_stack()
                  if "groove_tpu_torch" in f.filename]
        where = (f"{Path(frames[-1].filename).relative_to(ROOT)}:"
                 f"{frames[-1].lineno}" if frames
                 else f"{Path(filename).name}:{lineno}")
        sites[where] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode(1)
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return dict(sites)


def parallel_phase(dev, work: Path, files: dict, per_song: dict, paths,
                   zero_launches, launches, totals) -> None:
    """Phase 9: groove_tpu_torch/parallel/ and the merged sliced-Welsh
    cascade on the card, every device a logical shard of cuda:0 (the
    machine has one card). Each run's launches are counted from zero just
    before it and read just after; every check fails the run."""
    import numpy as np
    import torch

    from groove_tpu_torch import cli
    from groove_tpu_torch.compiler.song import compile_song
    from groove_tpu_torch.engine.render import Renderer
    from groove_tpu_torch.engine.stream import StreamingRenderer
    from groove_tpu_torch.io.wav import read_wav
    from groove_tpu_torch.models import welsh
    from groove_tpu_torch.models.voices import scatter_notes
    from groove_tpu_torch.ops import iir
    from groove_tpu_torch.ops import stream as sops
    from groove_tpu_torch.parallel.mesh import sharded_welsh_mix_step
    from groove_tpu_torch.parallel.meshrender import MeshRenderer
    from groove_tpu_torch.parallel.multidevice import MultiDeviceRenderer
    from groove_tpu_torch.parallel.timeshard import biquad_timesharded
    from groove_tpu_torch.project.schema import SongSettings
    from groove_tpu_torch.testing import synth
    from groove_tpu_torch.utils.profiling import sync

    t_phase = time.perf_counter()

    def counted(fn):
        zero_launches()
        out = fn()
        sync(dev)
        got = launches()
        for k in totals:
            totals[k] += got[k]
        return out, {k: v for k, v in got.items() if v}

    def compiled(path):
        return compile_song(SongSettings.from_project_file(path), paths)

    def steady_ms(fn, reps: int = 3) -> float:
        fn()
        best = float("inf")
        for _ in range(reps):
            sync(dev)
            t0 = time.perf_counter()
            fn()
            sync(dev)
            best = min(best, (time.perf_counter() - t0) * 1e3)
        return best

    # 1. the 3-minute kitchen sink through MultiDeviceRenderer on every
    # visible device
    ks = compiled(files["kitchen-sink"])
    single = Renderer(ks, dev)
    md = MultiDeviceRenderer(ks)
    f_single = single.render()
    f_multi = md.render()
    peak = max(1.0, float(np.abs(f_single).max()))
    rel = float(np.abs(f_multi - f_single).max()) / peak
    q, got = counted(md.render_quantized)
    host = np.clip(np.trunc(f_multi.astype(np.float64) * 32767.0),
                   -32768, 32767).astype(np.int16)
    wav = np.round(per_song["kitchen-sink"][1] * 32768.0).astype(np.int32)
    lsb = int(np.abs(wav - q).max())
    plan: dict = {}
    for _, _, r in md.assignments:
        _, alone = counted(r.render_quantized)
        for k, v in alone.items():
            plan[k] = plan.get(k, 0) + v
    ms_single, ms_multi = (steady_ms(single.render_quantized),
                           steady_ms(md.render_quantized))
    # the first use of torch's sync debug mode reports one synchronisation
    # of its own, outside any render: recorded apart
    syncs = {"(no work)": {"sites": host_syncs(lambda: None)}}
    for name, path in (("kitchen-sink", files["kitchen-sink"]),
                       ("perf-1-10s", work / "perf-1-10s.json"),
                       ("fm", files["fm"]),
                       ("instruments", files["instruments"]),
                       ("welsh", work / "welsh.json")):
        m = md if name == "kitchen-sink" else \
            MultiDeviceRenderer(compiled(path), [dev])
        m.render_device()
        syncs[name] = {"components": len(m.assignments), "sites": host_syncs(
            lambda m=m: [r.render_device() for _, _, r in m.assignments])}
    emit("parallel", check="multidevice kitchen sink",
         devices=[str(d) for d in md.devices],
         components=len(md.assignments), max_err_over_peak=rel,
         quantized_equals_host=bool(np.array_equal(q, host)),
         max_lsb_vs_cli_wav=lsb, launches=got, sub_renderer_launches=plan,
         planned_per_render=PER_RENDER["kitchen-sink"],
         steady_ms=ms_multi, single_renderer_steady_ms=ms_single,
         host_syncs_in_dispatch=syncs)
    require(rel <= 1e-6, f"multidevice: {rel} of the peak from Renderer")
    require(np.array_equal(q, host), "multidevice: render_quantized is not "
            "the host quantization")
    require(lsb <= 1, f"multidevice: {lsb} LSB from the CLI's WAV")
    require(got == plan == PER_RENDER["kitchen-sink"],
            f"multidevice launched {got}, its sub-renderers {plan}")
    del single, md, f_single, f_multi

    # 2. the same song through MeshRenderer on MESH_SHARDS logical shards
    stream = StreamingRenderer(ks, dev, STREAM_SEGMENT).render()
    mr = MeshRenderer(ks, [dev] * MESH_SHARDS)
    steps = [0]
    step = mr.stream.step

    def counting_step(*a):
        steps[0] += 1
        return step(*a)

    mr.stream.step = counting_step
    out, got = counted(mr.render)
    n_steps = steps[0]
    rounds = mr.iterations + 1
    want = {k: rounds * MESH_SHARDS * v
            for k, v in mr.stream.segment_launches().items()}
    peak = max(1.0, float(np.abs(stream).max()))
    rel = float(np.abs(out - stream).max()) / peak
    ms_mesh = steady_ms(mr.render_quantized, reps=2)
    emit("parallel", check="mesh kitchen sink", shards=MESH_SHARDS,
         shard_frames=mr.S, iterations=mr.iterations, steps=n_steps,
         max_err_over_peak=rel, launches=got, planned=want,
         steady_ms=ms_mesh,
         cli_stream_render_ms=per_song["kitchen-sink-stream"][0]["render_s"]
         * 1e3)
    require(n_steps == rounds * MESH_SHARDS,
            f"mesh: {n_steps} steps, not {rounds} x {MESH_SHARDS}")
    require(rel < 2e-4, f"mesh: {rel} of the peak from the stream")
    require(got == want, f"mesh launched {got}, planned {want}")
    del mr, out, stream, ks

    # 3. biquad_timesharded on MESH_SHARDS shards of a 10-second sweep
    n = TIMESHARD_FRAMES
    x = np.random.default_rng(3).standard_normal(n).astype(np.float32)
    cutoff = np.geomspace(200.0, 6000.0, n).astype(np.float32)
    coefs = iir.rbj_low_pass(cutoff, 0.707, 44100.0)
    y, got = counted(lambda: biquad_timesharded(
        torch.from_numpy(x), coefs, [dev] * MESH_SHARDS))
    xd = torch.from_numpy(x).to(dev)[None]
    cd = tuple(torch.from_numpy(c).to(dev) for c in coefs)
    zero = torch.zeros(1, device=dev)
    chain = sops.biquad_stream(xd, cd, (zero, zero))[0][0]
    err = float((y - chain).abs().max())
    peak = max(1.0, float(chain.abs().max()))
    db = 20.0 * float(np.log10(err / peak + 1e-30))
    ms_ts, ms_chain, _, _ = in_turns(
        lambda: biquad_timesharded(xd[0], cd, [dev] * MESH_SHARDS),
        lambda: sops.biquad_stream(xd, cd, (zero, zero)), 5)
    emit("parallel", check="timesharded biquad", frames=n,
         shards=MESH_SHARDS, max_abs_err=err, err_dbfs=db,
         bar_dbfs=TIMESHARD_BAR_DB, bitwise=bool(torch.equal(y, chain)),
         launches=got, ms=ms_ts, one_chain_ms=ms_chain)
    require(db <= TIMESHARD_BAR_DB, f"timeshard: {db:.1f} dBFS from one "
            "S3 chain")
    require(got == {"biquad_stream": 2 * MESH_SHARDS},
            f"timeshard launched {got}")
    del x, y, xd, cd, chain

    # 4. sharded_welsh_mix_step: 8 tracks on MESH_SHARDS shards against
    # the plain loop (tests/test_parallel.py's shapes), the Welsh
    # analogue's lead
    voice = compiled(work / "welsh.json").devices["lead"].voice
    n_frames, span, sr = 1024, 512, 44100.0
    rng = np.random.default_rng(0)
    keys = rng.integers(48, 72, (MIX_TRACKS, 2)).astype(np.int32)
    vels = np.full((MIX_TRACKS, 2), 127.0, np.float32)
    gates = np.full((MIX_TRACKS, 2), 256, np.int32)
    ons = np.tile(np.array([[0, 256]], np.int32), (MIX_TRACKS, 1))
    gains = np.linspace(0.2, 0.9, MIX_TRACKS).astype(np.float32)
    step = sharded_welsh_mix_step(voice, n_frames, span, sr,
                                  [dev] * MESH_SHARDS)
    sharded, got = counted(lambda: step(keys, vels, gates, ons, gains))
    mix = torch.zeros((2, n_frames), device=dev)
    for t in range(MIX_TRACKS):
        mono = welsh.render_notes(
            voice, torch.from_numpy(keys[t]).to(dev),
            torch.from_numpy(vels[t]).to(dev),
            torch.from_numpy(gates[t]).to(dev), span, sr)
        track = iir.biquad_best(scatter_notes(mono, ons[t], n_frames),
                                iir.rbj_low_pass(8000.0, 0.707, sr))
        mix = mix + torch.stack([track, track]) * float(gains[t])
    err = float((sharded - mix).abs().max())
    emit("parallel", check="sharded welsh mix step", tracks=MIX_TRACKS,
         shards=MESH_SHARDS, max_abs_err=err,
         mix_peak=float(mix.abs().max()), launches=got)
    require(err < 1e-4 and float(mix.abs().max()) > 0.1,
            f"sharded welsh mix: {err} from the plain loop")

    # 5. the 3-minute Welsh analogue streamed sliced with the merged
    # cascade: the unmerged WAV's bits, one K7 and one K8 a segment
    StreamingRenderer.WELSH_SLICE_MERGE = True
    try:
        perf = []
        rc, got = counted(lambda: cli.main(
            [str(work / "welsh.json"), "--wav", "--perf", "--stream",
             "--sliced", "--segment-frames", str(WELSH_SEGMENT), "--device",
             "cuda", "--out-dir", str(work / "out-merged")], perf_out=perf))
    finally:
        StreamingRenderer.WELSH_SLICE_MERGE = False
    require(rc == 0 and len(perf) == 1, "cli failed on welsh merged")
    info = perf[0]["stream"]
    segs = info["segments"]
    want = {"lp24_stream": segs, "lp24_refined_stream": segs}
    audio = read_wav(Path(perf[0]["wav"]))[0]
    same = bool(np.array_equal(audio, per_song["welsh"][1]))
    emit("parallel", check="welsh merged sliced stream", segments=segs,
         launches=got, planned_launches=info["planned_launches"],
         equals_unmerged_wav=same, render_s=perf[0]["render_s"],
         unmerged_render_s=per_song["welsh"][0]["render_s"])
    require(got == want == info["planned_launches"],
            f"welsh merged launched {got}, planned "
            f"{info['planned_launches']}, want {want}")
    require(same, "welsh merged: the WAV differs from the unmerged one")
    emit("parallel", seconds=time.perf_counter() - t_phase)


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
    live_assets = synth.write_live_assets(work / "live-assets")
    live_twins = start_live_twins(work, live_assets)
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
    library = {}
    r = renderer(synth.north_star_project, CHECK_MEASURES)
    hits, bus = drum_bus(r)
    n = r.c.n_frames
    results.append(compare(
        "drums", lambda: drums.accumulate_hits(*hits, n_frames=n),
        lambda: drums.accumulate_hits_plain(*hits, n_frames=n),
        bus.abs().max(), drum_work(hits, n), graph=True))
    # Tensor.index_add_ on the same hits' prepared windows (library_ms)
    lib = library_drums(hits, n)
    lib["library_max_abs_err_vs_kernel"] = float(
        (lib.pop("library_out") - bus).abs().max())
    emit("library", name="drums", shape=[2, n], ms=results[-1]["ms"], **lib)
    library["drums"] = lib["library_ms"]
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
    # torch's associative_scan beside S1 and S2 (library; stream_library)
    rk = renderer(synth.kitchen_sink_project, CHECK_MEASURES)
    rb = renderer(synth.filter_bank_project, CHECK_MEASURES)
    _, bus_k = drum_bus(rk)
    n10 = bus_k.shape[-1] // 64 * 64
    bus_k = bus_k[:, :n10].contiguous()
    cuts10 = [0, 64, 4096, 3 * 4096 + 64, n10 // 2 // 64 * 64, n10]
    stream_checks = []
    for call in stream_calls(bus_k, rk, rb, float(rk.c.sample_rate)):
        res = stream_call_check(call, cuts10)
        results.append(res)
        stream_checks.append(res)
    library.update(stream_library(rk, bus_k, "10 s"))
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
    stream_library(rk, bus_k, "3 min")
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
    # and the MIDI file's buckets, and of the Welsh voice branches the
    # analogue leaves out: a gliding lead, a lead under a pitch LFO (host
    # phase tables), a unison pad
    variants = {f"welsh-{name}": compile_song(SongSettings.from_json(
        synth.welsh_variant_project(name, measures, SONG_BPM)), paths)
        for name, measures in WELSH_VARIANT_MEASURES.items()}
    for name, song in (("fm", fm_song),
                       ("midi", compile_midi_file(files["midi"], paths)),
                       *variants.items()):
        peak_per_elem[name] = bucket_peaks(Renderer(song, dev))
        emit("bucket_peaks", project=name, batches=peak_per_elem[name])
    del variants
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

    frontends_phase(dev, work, files, per_song, zero_launches, launches,
                    totals)
    parallel_phase(dev, work, files, per_song, paths, zero_launches, launches,
                   totals)
    live_phase(dev, work, live_assets, live_twins, zero_launches, launches,
               totals)

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
    if sys.argv[1:2] == ["--live-twin"]:
        sys.exit(live_twin_main(sys.argv[2:]))
    sys.exit(main())
