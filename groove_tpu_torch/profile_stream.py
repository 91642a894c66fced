"""Device busy share of the segment-streamed Welsh render on one CUDA card.

    python -m groove_tpu_torch.profile_stream [--segments 64] [--skip 32]

Streams the 3-minute Welsh analogue (testing/synth.welsh_project, 90
measures at 120 bpm, sliced voices, 4096-frame segments, int16 fetch),
skips the first `--skip` segments (warm-up: kernel build, allocator), and
traces the next `--segments` with torch.profiler. Prints one JSON line:
the traced wall time, the card's busy time (the union of its kernel and
copy intervals), the idle share, the segments per second, and the device
time by kernel name (top 12). Needs a CUDA device; exits non-zero without
one.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


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


def main(argv=None) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    args = argparse.ArgumentParser(description=__doc__.splitlines()[0])
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

    compiled = compile_song(SongSettings.from_json(
        synth.welsh_project(90, 120.0)), Paths(roots=[]))
    sliced = type("SlicedStreamingRenderer", (StreamingRenderer,),
                  {"WELSH_SLICED": True})
    r = sliced(compiled, "cuda", segment_frames=4096)
    chunks = r.stream(quantize=True, prefetch_segments=4)
    for _ in range(a.skip):
        next(chunks)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(a.segments):
            next(chunks)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    chunks.close()
    device_events = [e for e in prof.events()
                     if e.device_type.name == "CUDA"]
    intervals = [(e.time_range.start, e.time_range.end)
                 for e in device_events]
    busy_us = _union_us(intervals)
    span_us = (max(b for _, b in intervals) - min(a for a, _ in intervals)
               if intervals else 0.0)
    by_name: dict = {}
    for e in device_events:
        by_name[e.name] = by_name.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    print(json.dumps({
        "segments": a.segments, "segment_frames": r.S,
        "device": torch.cuda.get_device_name(0),
        "wall_ms": wall_s * 1e3, "device_span_ms": span_us / 1e3,
        "device_busy_ms": busy_us / 1e3,
        "idle_share": 1.0 - busy_us / (wall_s * 1e6),
        "segments_per_s": a.segments / wall_s,
        "device_events": len(device_events),
        "top_kernels_ms": {k: v / 1e3 for k, v in top}}))
    return 0 if device_events else 1


if __name__ == "__main__":
    sys.exit(main())
