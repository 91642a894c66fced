"""Calibrate StreamingRenderer.SLICE_COST_CUDA on a card: the relative
per-sample cost of the sliced Welsh cascade in the _slice_wins work model.

The 3-minute Welsh analogue (testing/synth.welsh_project) is streamed on
the card forced-sliced (WELSH_SLICED True: K7/K8, each note's slice a
segment) and unsliced (every overlapping note's whole window a segment:
K2/K3) at each segment length; each render is timed in steady state
(after a first, warm-up render), host clock around a render that ends in
a synchronisation. The model counts, over the Welsh devices' notes,
unsliced work U = sum span * ceil((span + S) / S) and sliced work
c * W with W = sum (span + S), so the measured time ratio fits

    c_eff = (t_sliced / t_unsliced) * U / W

at each S, as groove_tpu's SLICE_COST_TPU was fitted
(groove_tpu/engine/stream.py:250-269). Prints one JSON line per render
and per fit, then the card's name and power limit.

    python -m groove_tpu_torch.slice_cost [--measures 90] \\
        [--segments 16384 65536] [--reps 2]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np


def model_work(r) -> tuple[float, float]:
    """(U, W) of the work model over every Welsh device with notes."""
    U = W = 0.0
    for dev in r.c.devices.values():
        if dev.kind not in ("welsh", "welsh-raw") or dev.voice is None \
                or dev.notes is None or not dev.notes.count:
            continue
        on = np.asarray(dev.notes.on_frames, np.int64)
        off = np.asarray(dev.notes.off_frames, np.int64)
        tail = int(np.ceil(r._note_tail(dev) * r.c.sample_rate))
        span = np.minimum((off - on) + tail + 1, r.c.n_frames)
        U += float(np.sum(span * np.ceil((span + r.S) / r.S)))
        W += float(np.sum(span + r.S))
    return U, W


def steady_seconds(r, reps: int) -> float:
    """The fastest of `reps` full streamed renders (int16, batched
    fetches), after one warm-up render."""
    import torch

    r.render(batch_segments=8, quantize=True)
    best = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize(r.device)
        t0 = time.perf_counter()
        r.render(batch_segments=8, quantize=True)
        torch.cuda.synchronize(r.device)
        best = min(best, time.perf_counter() - t0)
    return best


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--measures", type=int, default=90)
    p.add_argument("--segments", type=int, nargs="+",
                   default=[16384, 65536])
    p.add_argument("--reps", type=int, default=2)
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("slice_cost: no CUDA device", file=sys.stderr)
        return 1
    from groove_tpu_torch.compiler.song import compile_song
    from groove_tpu_torch.engine.stream import StreamingRenderer
    from groove_tpu_torch.project.paths import Paths
    from groove_tpu_torch.project.schema import SongSettings
    from groove_tpu_torch.testing import synth

    dev = torch.device("cuda", 0)
    song = compile_song(SongSettings.from_json(
        synth.welsh_project(args.measures, 120.0)), Paths(roots=[]))
    audio_s = song.n_frames / song.sample_rate
    sliced = type("Sliced", (StreamingRenderer,), {"WELSH_SLICED": True})
    fits = {}
    for S in args.segments:
        times = {}
        for mode, cls in (("unsliced", StreamingRenderer),
                          ("sliced", sliced)):
            r = cls(song, dev, segment_frames=S)
            t = steady_seconds(r, args.reps)
            times[mode] = t
            print(json.dumps({"render": mode, "segment_frames": S,
                              "seconds": t, "xrt": audio_s / t,
                              "sliced": sorted(r._sliced)}), flush=True)
        U, W = model_work(StreamingRenderer(song, dev, segment_frames=S))
        fits[S] = times["sliced"] / times["unsliced"] * U / W
        print(json.dumps({"fit": "c_eff", "segment_frames": S,
                          "unsliced_work": U, "sliced_work_per_c": W,
                          "time_ratio": times["sliced"] / times["unsliced"],
                          "c_eff": fits[S]}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
