"""Per-device render profiling (port of groove_tpu/utils/profiling.py):
the reference's dipstick instrumentation (orchestration/src/metrics.rs,
per-entity audio timers printed after a performance), as `cli --debug`
prints it.

`profile_render` times each device of a Renderer on its own: each
instrument's `_render_instrument`, then each effect's `_apply_effect` on
its realised input (the sum of its sources' outputs), each the best of
three calls with the device synchronised before and after the call.
`trace` wraps torch.profiler where the reference wraps jax.profiler."""

from __future__ import annotations

import contextlib
import time

import torch


def sync(device: torch.device) -> None:
    """Wait for `device`'s queued work (nothing to wait for on the
    CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(device: torch.device, fn, reps: int = 3):
    """(best seconds of `reps` synchronised calls after one warm-up, the
    last call's output)."""
    out = fn()
    best = float("inf")
    for _ in range(reps):
        sync(device)
        t0 = time.perf_counter()
        out = fn()
        sync(device)
        best = min(best, time.perf_counter() - t0)
    return best, out


def profile_render(renderer) -> list[tuple[str, float]]:
    """[(row name, seconds)] for every instrument and effect of the
    Renderer's song, in render order: instruments timed on their note
    batches, effects on their realised inputs."""
    c = renderer.c
    n = c.n_frames
    rows: list[tuple[str, float]] = []
    outputs: dict[str, torch.Tensor] = {}
    inputs = renderer.inputs
    for uvid in c.order:
        dev = c.devices[uvid]
        if dev.role == "instrument":
            seconds, outputs[uvid] = _timed(
                renderer.device,
                lambda d=dev: renderer._render_instrument(inputs, d, n))
            rows.append((f"instrument {uvid} ({dev.kind})", seconds))
            continue
        acc = renderer._zeros(n)
        for s in c.sinks.get(uvid, []):
            if s in outputs:
                acc = acc + outputs[s]
        if dev.role == "controller" \
                and dev.kind != "signal-passthrough-controller":
            continue
        seconds, outputs[uvid] = _timed(
            renderer.device,
            lambda d=dev, x=acc: renderer._apply_effect(inputs, d, x, n, {}))
        rows.append((f"effect {uvid} ({dev.kind})", seconds))
    return rows


@contextlib.contextmanager
def trace(trace_dir: str | None):
    """A torch.profiler trace (CPU and, where present, CUDA activity)
    exported as a Chrome trace into trace_dir, when one is given."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, \
        tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(trace_dir))):
        yield
