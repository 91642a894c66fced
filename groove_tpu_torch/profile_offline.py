"""Where the time of an offline render goes, on one CUDA card.

    python -m groove_tpu_torch.profile_offline [--song welsh] [--measures N]

Renders a 3-minute analogue of testing/synth offline to int16 on the
card: --song welsh (welsh_project, 90 measures at 120 bpm; the default),
kitchen-sink (kitchen_sink_project, 90 at 120), perf-1 (perf1_project,
768 at 1024) or fm (fm_project, 90 at 120), with the synthetic 707 kit
written under
build/profile_offline. Once to warm up, then:

  1. one steady render_quantized traced with torch.profiler: wall time,
     the card's busy time (the union of its kernel and copy intervals),
     the idle share, the device time by kernel name (top 12);
  2. one render with each stage ended by a synchronisation and timed
     on the host clock (staged_render): the Welsh voices up to the
     cascade (welsh.render_notes_parts), the cascades (welsh.apply_cascade,
     K2/K3), the FM voices (fm.render_notes), the timeline scatter
     (voices.scatter_notes, one in-place add per note) and the rest (the
     mix, the int16 quantizer and the fetch), with the steady
     unsynchronised render's time beside them; the instruments' own work
     (Renderer._render_instrument: DCAs, drums, the stages inside it
     counted apart) and each effect kind (Renderer._apply_effect) are
     stages of their own.

Prints one JSON line. Needs a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from contextlib import contextmanager
from pathlib import Path


ROOT = Path(__file__).resolve().parents[1]
# --song -> (testing/synth maker, measures for 3 minutes, bpm)
SONGS = {"welsh": ("welsh_project", 90, 120.0),
         "kitchen-sink": ("kitchen_sink_project", 90, 120.0),
         "perf-1": ("perf1_project", 768, 1024.0),
         "fm": ("fm_project", 90, 120.0)}


# inner seconds of each timed call in progress, outermost first
_OPEN: list = []


@contextmanager
def _timed(stages: dict, owner, name: str, key):
    """While active, every call of owner.name is synchronised on both
    sides and its host seconds added to stages[key] (key a string, or a
    function of the call's arguments), less the seconds of the timed
    calls made inside it (an FM device's voices and scatter inside its
    _render_instrument), which count in their own stages."""
    import torch

    fn = getattr(owner, name)

    def call(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _OPEN.append(0.0)
        try:
            out = fn(*a, **kw)
            torch.cuda.synchronize()
        finally:
            inner = _OPEN.pop()
        seconds = time.perf_counter() - t0
        if _OPEN:
            _OPEN[-1] += seconds
        k = key(a) if callable(key) else key
        stages[k] = stages.get(k, 0.0) + seconds - inner
        return out

    setattr(owner, name, call)
    try:
        yield
    finally:
        setattr(owner, name, fn)


def staged_render(r) -> tuple[float, dict]:
    """One render_quantized of Renderer r with its stages synchronised:
    (seconds, {stage: seconds}). Stages: the Welsh voices up to the
    cascade, the cascades, the FM voices (fm.render_notes), the timeline
    scatter, each instrument's own work (Renderer._render_instrument,
    less the stages inside it), each effect kind, and the rest."""
    import torch

    from groove_tpu_torch.engine import render
    from groove_tpu_torch.models import fm, welsh

    stages = dict.fromkeys(("voices", "cascade", "fm voices", "scatter",
                            "instruments"), 0.0)
    with _timed(stages, welsh, "render_notes_parts", "voices"), \
            _timed(stages, welsh, "apply_cascade", "cascade"), \
            _timed(stages, fm, "render_notes", "fm voices"), \
            _timed(stages, render, "scatter_notes", "scatter"), \
            _timed(stages, r, "_render_instrument", "instruments"), \
            _timed(stages, r, "_apply_effect", lambda a: a[1].kind):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r.render_quantized()
        staged_s = time.perf_counter() - t0
    stages["rest"] = staged_s - sum(stages.values())
    return staged_s, stages


def main(argv=None) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    args = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    args.add_argument("--song", choices=sorted(SONGS), default="welsh")
    args.add_argument("--measures", type=int, default=None)
    a = args.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_offline: no CUDA device", file=sys.stderr)
        return 1
    from groove_tpu_torch.compiler.song import compile_song
    from groove_tpu_torch.engine import render
    from groove_tpu_torch.profile_stream import device_summary
    from groove_tpu_torch.project.paths import Paths
    from groove_tpu_torch.project.schema import SongSettings
    from groove_tpu_torch.testing import synth

    make, measures, bpm = SONGS[a.song]
    assets = synth.write_assets(ROOT / "build" / "profile_offline")
    compiled = compile_song(SongSettings.from_json(getattr(synth, make)(
        a.measures or measures, bpm)), Paths(roots=[assets]))
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

    staged_s, stages = staged_render(r)
    print(json.dumps({
        "song": a.song, "frames": compiled.n_frames, "plan": r._wm_plan,
        "fm_buckets": r._buckets,
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
