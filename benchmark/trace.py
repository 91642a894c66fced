"""Spans the benchmark opens around the program's layers and kernel
entry points, and the reduction of a torch.profiler trace to the card's
busy time, its idle gaps and each kernel call's device time.

Spans are torch.profiler.record_function ranges named "bench:<layer>"
(the entry's SPANS) and "bench.k<i>:<entry point>" (work.ENTRY_POINTS,
one a call, its work counted from its arguments as it is made; the drum
layer's hit lists, which the render keeps, are read after the window).
A kernel span's device time is that of the device operations whose
launch (the runtime call, linked to the operation by its correlation id)
lies inside the span on the host, on whatever stream they ran: the
profiler's own device_time_total of a record_function range misses the
kernels the program launches through ctypes."""

from __future__ import annotations

import bisect
import importlib
import re
from contextlib import ExitStack, contextmanager

from benchmark import work

# the CUDA runtime and driver calls that launch device work
RUNTIME = re.compile(r"^(cuda|cu)[A-Z]")


def _owner(path: str):
    """The module or class named by a dotted path."""
    try:
        return importlib.import_module(path)
    except ImportError:
        mod, _, cls = path.rpartition(".")
        return getattr(importlib.import_module(mod), cls)


@contextmanager
def _patched(owner, name: str, wrap):
    fn = getattr(owner, name)
    setattr(owner, name, wrap(fn))
    try:
        yield
    finally:
        setattr(owner, name, fn)


def union_seconds(intervals) -> float:
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


class Spans:
    """While active, opens a span around each of `spans` ((module or
    class path, attribute, layer name)) and each kernel entry point, and
    counts the entry points' calls: self.calls[i] = the call's work, or
    a function that counts it (work.count)."""

    def __init__(self, spans):
        self.spans = spans
        self.calls: list = []
        self._depth = 0

    def __enter__(self):
        import torch

        self._stack = ExitStack()
        for path, name, layer in self.spans:
            def wrap(fn, layer=layer):
                def call(*a, **kw):
                    with torch.profiler.record_function("bench:" + layer):
                        return fn(*a, **kw)
                return call
            self._stack.enter_context(_patched(_owner(path), name, wrap))
        for (path, name) in work.ENTRY_POINTS:
            def wrap(fn, key=(path, name)):
                def call(*a, **kw):
                    if self._depth:
                        return fn(*a, **kw)
                    i = len(self.calls)
                    self.calls.append(work.count(key, a, kw))
                    self._depth += 1
                    try:
                        with torch.profiler.record_function(
                                f"bench.k{i}:{key[1]}"):
                            return fn(*a, **kw)
                    finally:
                        self._depth -= 1
                return call
            self._stack.enter_context(_patched(_owner(path), name, wrap))
        return self

    def __exit__(self, *exc):
        self._stack.close()


def reduce(prof, spans: Spans, top: int = 10) -> dict:
    """The trace of the traced window (its calls' spans, "bench:call"):
    the card's busy seconds (the union of its
    kernel and copy intervals), the device operations that took the most
    time, the longest idle gaps named by the innermost benchmark span open
    on the host as each began, and the kernel entry points' least and
    device seconds."""
    events = list(prof.events())
    # the profiler mirrors each record_function range on the device
    # ("gpu_user_annotation"): not an operation of the card
    dev = [e for e in events if e.device_type.name == "CUDA"
           and not e.name.startswith("bench")]
    host = [e for e in events if e.device_type.name == "CPU"]
    calls = [e for e in host if e.name == "bench:call"]
    if calls:
        lo = min(e.time_range.start for e in calls)
        hi = max(e.time_range.end for e in calls)
    else:
        lo = hi = 0.0
    ivs = sorted((e.time_range.start, e.time_range.end) for e in dev
                 if e.time_range.end > e.time_range.start)
    busy_us = union_seconds(ivs)
    by_name: dict = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start)
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    # idle gaps inside the window, named by the innermost open span
    named = [e for e in host if e.name.startswith("bench")]
    gaps, end = [], lo
    for a, b in ivs + [(hi, hi)]:
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    gap_by: dict = {}
    for a, b in gaps:
        open_ = [e for e in named
                 if e.time_range.start <= a < e.time_range.end]
        name = (min(open_, key=lambda e: e.time_range.end
                    - e.time_range.start).name.split(":", 1)[-1]
                if open_ else "host, outside any span")
        gap_by[name] = gap_by.get(name, 0.0) + (b - a)
    idle_gaps = sorted(gap_by.items(), key=lambda kv: -kv[1])[:top]
    # each kernel entry point's device time: the device operations whose
    # launch (the runtime call, linked by its correlation id) lies inside
    # the entry point's span on the host
    kspans = sorted((e.time_range.start, e.time_range.end,
                     int(e.name[len("bench.k"):].split(":", 1)[0]))
                    for e in host if e.name.startswith("bench.k"))
    launched = {e.id: e.time_range.start for e in host
                if RUNTIME.match(e.name)}
    starts = [s for s, _, _ in kspans]
    device_s: dict = {}
    for e in dev:
        t = launched.get(e.id)
        if t is None:
            continue
        j = bisect.bisect_right(starts, t) - 1
        if j >= 0 and t <= kspans[j][1]:
            i = kspans[j][2]
            device_s[i] = device_s.get(i, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e6
    least = dev_total = 0.0
    for i, w in enumerate(spans.calls):
        if i in device_s and device_s[i] > 0:
            least += work.least_seconds(w() if callable(w) else w)
            dev_total += device_s[i]
    return {"busy_s": busy_us / 1e6, "device_events": len(dev),
            "device_ops": [[k, v / 1e6] for k, v in device_ops],
            "idle_gaps": [[k, v / 1e6] for k, v in idle_gaps],
            "kernel_least_s": least, "kernel_device_s": dev_total,
            "kernel_calls": len(spans.calls),
            "kernel_calls_timed": len(device_s)}
