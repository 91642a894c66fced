"""Device busy share of a segment-streamed render on one CUDA card.

    python -m groove_tpu_torch.profile_stream [--segments 64] [--skip 32]
    python -m groove_tpu_torch.profile_stream --song kitchen-sink \
        --unsliced --segment-frames 262144

Streams a 3-minute analogue (90 measures at 120 bpm, int16 fetch): the
Welsh song (testing/synth.welsh_project; sliced voices unless --unsliced)
or the kitchen sink (testing/synth.kitchen_sink_project, every effect
kind, on synthetic drum assets written under build/profile_stream/), in
--segment-frames segments (4096 by default). It skips the first `--skip`
segments (warm-up: kernel build, allocator) and traces the next
`--segments` with torch.profiler; a song of fewer segments than that is
rendered once whole to warm up, and then traced whole. Prints one JSON
line: the card's name and power limit (nvidia-smi), the traced wall time,
the card's busy time (the union of its kernel and copy intervals), the
idle share, the segments per second, the device time by kernel name (top
12), and the device time and launch count of this package's own kernels
(csrc/, by name, whether or not they reach the top 12). Needs a CUDA
device; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

OWN_KERNEL = re.compile(r"(\w+_kernel(?:<[^()]*>)?)\(")


def _union_us(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def device_summary(prof, top: int = 12):
    """(device events, the card's busy microseconds, the top `top` kernel
    names by device microseconds) of a torch.profiler trace."""
    events = [e for e in prof.events() if e.device_type.name == "CUDA"]
    busy_us = _union_us([(e.time_range.start, e.time_range.end)
                         for e in events])
    by_name: dict = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start)
    return events, busy_us, sorted(by_name.items(),
                                   key=lambda kv: -kv[1])[:top]


def main(argv=None) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    args = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    args.add_argument("--song", choices=("welsh", "kitchen-sink"),
                      default="welsh")
    args.add_argument("--unsliced", action="store_true",
                      help="render Welsh voices whole-window, not sliced")
    args.add_argument("--segment-frames", type=int, default=4096)
    args.add_argument("--segments", type=int, default=64)
    args.add_argument("--skip", type=int, default=32)
    a = args.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_stream: no CUDA device", file=sys.stderr)
        return 1
    from groove_tpu_torch.compiler.song import compile_song
    from groove_tpu_torch.engine.stream import StreamingRenderer
    from groove_tpu_torch.project.paths import Paths
    from groove_tpu_torch.project.schema import SongSettings
    from groove_tpu_torch.testing import synth

    if a.song == "welsh":
        project, roots = synth.welsh_project(90, 120.0), []
    else:
        assets = synth.write_assets(Path(__file__).resolve().parents[1]
                                    / "build" / "profile_stream")
        project, roots = synth.kitchen_sink_project(90, 120.0), [assets]
    compiled = compile_song(SongSettings.from_json(project),
                            Paths(roots=roots))
    renderer = StreamingRenderer if a.unsliced else type(
        "SlicedStreamingRenderer", (StreamingRenderer,),
        {"WELSH_SLICED": True})
    r = renderer(compiled, "cuda", segment_frames=a.segment_frames)
    skip, segments = a.skip, a.segments
    if skip + segments > r.n_segs:
        r.render(quantize=True)  # warm-up, then the whole song
        skip, segments = 0, r.n_segs
    chunks = r.stream(quantize=True, prefetch_segments=4)
    for _ in range(skip):
        next(chunks)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(segments):
            next(chunks)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    chunks.close()
    device_events, busy_us, top = device_summary(prof)
    span_us = (max(e.time_range.end for e in device_events)
               - min(e.time_range.start for e in device_events)
               if device_events else 0.0)
    own = {}
    for e in device_events:
        found = None if "at::" in e.name else OWN_KERNEL.search(e.name)
        if found:  # csrc/ kernels: tdf2:: or an anonymous namespace
            ms, count = own.get(found.group(1), (0.0, 0))
            own[found.group(1)] = (
                ms + (e.time_range.end - e.time_range.start) / 1e3,
                count + 1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps({
        "song": a.song, "sliced": not a.unsliced,
        "segments": segments, "segment_frames": r.S,
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "wall_ms": wall_s * 1e3, "device_span_ms": span_us / 1e3,
        "device_busy_ms": busy_us / 1e3,
        "idle_share": 1.0 - busy_us / (wall_s * 1e6),
        "segments_per_s": segments / wall_s,
        "device_events": len(device_events),
        "top_kernels_ms": {k: v / 1e3 for k, v in top},
        "own_kernels_ms_and_launches": own}))
    return 0 if device_events else 1


if __name__ == "__main__":
    sys.exit(main())
