"""Where the time of the offline Welsh render goes, on one CUDA card.

    python -m groove_tpu_torch.profile_offline [--measures 90]

Renders the Welsh analogue (testing/synth.welsh_project, 90 measures at
120 bpm: 3 minutes) offline to int16 on the card, once to warm up, then:

  1. one steady render_quantized traced with torch.profiler: wall time,
     the card's busy time (the union of its kernel and copy intervals),
     the idle share, the device time by kernel name (top 12);
  2. one render with each stage of the Welsh path ended by a
     synchronisation and timed on the host clock: the voices up to the
     cascade (welsh.render_notes_parts), the cascades (welsh.apply_cascade,
     K2/K3), the timeline scatter (voices.scatter_notes, one in-place add
     per note) and the rest (the voice and synth DCA, the mix, the int16
     quantizer and the fetch), with the steady unsynchronised render's
     time beside them.

Prints one JSON line. Needs a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from contextlib import contextmanager


@contextmanager
def _timed(stages: dict, module, name: str, key: str):
    """While active, every call of module.name is synchronised on both
    sides and its host seconds added to stages[key]."""
    import torch

    fn = getattr(module, name)

    def call(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        stages[key] += time.perf_counter() - t0
        return out

    setattr(module, name, call)
    try:
        yield
    finally:
        setattr(module, name, fn)


def main(argv=None) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    args = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    args.add_argument("--measures", type=int, default=90)
    a = args.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_offline: no CUDA device", file=sys.stderr)
        return 1
    from groove_tpu_torch.compiler.song import compile_song
    from groove_tpu_torch.engine import render
    from groove_tpu_torch.models import welsh
    from groove_tpu_torch.profile_stream import device_summary
    from groove_tpu_torch.project.paths import Paths
    from groove_tpu_torch.project.schema import SongSettings
    from groove_tpu_torch.testing import synth

    compiled = compile_song(SongSettings.from_json(
        synth.welsh_project(a.measures, 120.0)), Paths(roots=[]))
    r = render.Renderer(compiled, "cuda")
    r.render_quantized()  # warm-up: kernel build, allocator
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r.render_quantized()
    steady_s = time.perf_counter() - t0

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        r.render_quantized()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    device_events, busy_us, top = device_summary(prof)

    stages = dict.fromkeys(("voices", "cascade", "scatter"), 0.0)
    with _timed(stages, welsh, "render_notes_parts", "voices"), \
            _timed(stages, welsh, "apply_cascade", "cascade"), \
            _timed(stages, render, "scatter_notes", "scatter"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r.render_quantized()
        staged_s = time.perf_counter() - t0
    stages["rest"] = staged_s - sum(stages.values())
    print(json.dumps({
        "frames": compiled.n_frames, "plan": r._wm_plan,
        "device": torch.cuda.get_device_name(0),
        "steady_ms": steady_s * 1e3,
        "traced_wall_ms": wall_s * 1e3, "device_busy_ms": busy_us / 1e3,
        "idle_share": 1.0 - busy_us / (wall_s * 1e6),
        "device_events": len(device_events),
        "top_kernels_ms": {k: v / 1e3 for k, v in top},
        "staged_ms": staged_s * 1e3,
        "stages_ms": {k: v * 1e3 for k, v in stages.items()}}))
    return 0 if device_events else 1


if __name__ == "__main__":
    sys.exit(main())
