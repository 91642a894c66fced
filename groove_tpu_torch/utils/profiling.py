"""The port's tracing: spans and counters recorded inside the program,
the per-device render profile of `cli --debug` (port of
groove_tpu/utils/profiling.py, the reference's dipstick instrumentation:
orchestration/src/metrics.rs, per-entity audio timers printed after a
performance) and the Chrome-trace exporter of `cli --trace-dir`.

Spans. The program opens a span at each layer boundary (`span`):

    compile   compiler/song.compile_song; children devices, events,
              notes, automation, order
    render    Renderer.render_quantized / render / render_device;
              children graph (the enqueue of the song graph: instrument,
              effect and mix, the Welsh and FM paths' voices, cascade and
              scatter), quantize, fetch
    stream    StreamingRenderer.stream / render / render_scan /
              stream_loop; children state, inputs and step (one a
              segment; step's children as graph's), quantize and fetch
              (one a fetched batch)
    block     LiveSongRenderer.render_block / render_block_pipelined;
              children inputs, step, copy, fetch
    kernel    a kernel entry point (ops/iir_kernels.dispatch, the choke
              point of the IIR, biquad, scan and stream kernels, and
              ops/drums.accumulate_hits); kind = its LAUNCHES key

A span is (name, attrs, request, parent, start_ns, end_ns) with attrs
kind (a device or kernel kind), uvid, frames and bytes. Its parent is the
innermost span open on its thread; a span opened with none open is a
root and starts a new request id, which its descendants share. A
counter (`count`) adds to the innermost open span's `counts`, or to
`Recorder.orphans` when none is open: "host_syncs" (`host_sync`), and
on the bounce's `fetch` "fetch_pinned" or "fetch_pageable", 1 as its
result lands in page-locked or pageable host memory.

When it records. Only while a torch.profiler session is active
(torch.autograd._profiler_enabled()) or inside `recording()`. It keeps
the spans of the current session in memory and drops them when the next
session starts; a session that torch.profiler began is noticed at the
first span opened in it, and its end at the first span opened after it,
so two profiler sessions with no span opened between them read as one.
It keeps at most CAP spans a session (`Recorder.dropped` counts the rest).
Off, opening a span costs one flag check and one C call, allocates nothing
and opens no profiler range.

One clock. Spans are stamped with time.time_ns(), the clock (the Unix
epoch, CLOCK_REALTIME) on which torch.profiler stamps its events: an
event's time_range is in microseconds from
prof.profiler.kineto_results.trace_start_ns(), so a span lies at
(start_ns - trace_start_ns) / 1e3 on the profiler's timeline, beside the
card's operations (tests/test_torch_tracing.py holds it there to 100 us).

Profiler ranges. The program opens a torch.profiler.record_function range
for each span only inside its own exporter, `trace`: under a profiler it
did not start it opens none, since the profiler mirrors every range on the
card ("gpu_user_annotation") and a reader of that trace would take the
ranges for device work.

`profile_render` times each device of a Renderer on its own: each
instrument's `_render_instrument`, then each effect's `_apply_effect` on
its realised input (the sum of its sources' outputs), each the best of
three calls with the device synchronised before and after the call."""

from __future__ import annotations

import contextlib
import itertools
import threading
import time

import torch

CAP = 200_000  # spans kept a session

now_ns = time.time_ns  # torch.profiler's clock (see above)
_profiler_on = torch.autograd._profiler_enabled

# True while recording() or trace() runs, or while a profiler session the
# recorder has seen is thought active: span() looks no further when False
# and no profiler is on
_gate = False


class Span:
    """One span; a context manager while open."""

    __slots__ = ("name", "kind", "uvid", "frames", "bytes", "request",
                 "parent", "start_ns", "end_ns", "counts", "_range")

    def __init__(self, name, kind, uvid, frames, nbytes):
        self.name = name
        self.kind = kind
        self.uvid = uvid
        self.frames = frames
        self.bytes = nbytes
        self.request = None
        self.parent = None
        self.start_ns = None
        self.end_ns = None
        self.counts = None
        self._range = None

    def _begin(self, stack):
        if stack:
            self.parent = stack[-1]
            self.request = self.parent.request
        else:
            self.request = next(RECORDER._requests)
        if RECORDER.ranges:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self.start_ns = now_ns()

    def _end(self):
        self.end_ns = now_ns()
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None

    def _pop(self, stack):
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)

    def __enter__(self):
        stack = RECORDER._stack()
        self._begin(stack)
        stack.append(self)
        return self

    def __exit__(self, typ, value, tb):
        self._pop(RECORDER._stack())
        self._end()
        return False


class _Off:
    """The span handed out while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, typ, value, tb):
        return False


_OFF = _Off()


class Recorder:
    """The spans of the current session, in the order they opened."""

    def __init__(self, cap: int = CAP):
        self.cap = cap
        self.spans: list[Span] = []
        self.orphans: dict = {}   # counts made with no span open
        self.dropped = 0
        self.live = False         # a session is recording
        self.forced = 0           # recording()/trace() contexts open
        self.ranges = False       # trace() is exporting
        self._local = threading.local()
        self._requests = itertools.count(1)

    def _stack(self) -> list:
        s = getattr(self._local, "stack", None)
        if s is None:
            s = self._local.stack = []
        return s

    def begin(self) -> None:
        """Start a new session: drop the last one's spans."""
        global _gate
        self.spans = []
        self.orphans = {}
        self.dropped = 0
        self.live = True
        _gate = True

    def _open(self, name, kind, uvid, frames, nbytes):
        global _gate
        if not (self.forced or _profiler_on()):
            # the profiler session that opened the gate has ended
            self.live = False
            _gate = False
            return _OFF
        if not self.live:
            self.begin()
        if len(self.spans) >= self.cap:
            self.dropped += 1
            return _OFF
        s = Span(name, kind, uvid, frames, nbytes)
        self.spans.append(s)
        return s

    def _add(self, counter: str, n) -> None:
        if not (self.forced or _profiler_on()):
            return
        stack = self._stack()
        if stack:
            c = stack[-1].counts
            if c is None:
                c = stack[-1].counts = {}
        else:
            c = self.orphans
        c[counter] = c.get(counter, 0) + n

    def closed(self) -> list[Span]:
        """The session's spans that have ended."""
        return [s for s in self.spans if s.end_ns is not None]


RECORDER = Recorder()


def span(name: str, kind=None, uvid=None, frames=None, bytes=None):
    """A span around a `with` block (see the module docstring); a no-op
    when nothing records."""
    if _gate or _profiler_on():
        return RECORDER._open(name, kind, uvid, frames, bytes)
    return _OFF


def spanned(name: str, gen, kind=None, uvid=None, frames=None):
    """Iterate `gen` inside one span that runs from the first `next` to
    exhaustion (or close). The span is the parent of what `gen` opens,
    and is on its thread's stack only while `gen` runs: the consumer's
    own spans between items are not its children. Whether it records is
    decided at the first `next`."""
    s = span(name, kind, uvid, frames)
    if s is _OFF:
        yield from gen
        return
    s._begin(RECORDER._stack())
    try:
        while True:
            stack = RECORDER._stack()
            stack.append(s)
            try:
                item = next(gen)
            except StopIteration:
                return
            finally:
                s._pop(stack)
            yield item
    finally:
        gen.close()
        s._end()


def _to_numpy(t):
    return t.cpu().numpy()


def count(counter: str, n: int = 1) -> None:
    """Add n to `counter` in the innermost open span (`Recorder.orphans`
    when none is open); nothing when nothing records."""
    if _gate or _profiler_on():
        RECORDER._add(counter, n)


def host_sync(obj, read=_to_numpy):
    """read(obj), counted as one host sync ("host_syncs") in the innermost
    open span: a call in which the host waits for the card's queue. By
    default obj.cpu().numpy(); else torch.Tensor.item, torch.Tensor.tolist,
    an event's or a stream's synchronize, torch.cuda.synchronize, a copy
    from pageable host memory to the card. The fetch sites count on every
    device (the CPU tests see them); the other sites come here only on a
    card."""
    count("host_syncs")
    return read(obj)


def card_read(t: torch.Tensor, read=_to_numpy):
    """read(t), a host sync when t lives on a card (reading a host
    tensor waits for nothing)."""
    return host_sync(t, read) if t.is_cuda else read(t)


def sync(device: torch.device) -> None:
    """Wait for `device`'s queued work (nothing to wait for on the
    CPU); counted as a host sync."""
    if device.type == "cuda":
        host_sync(device, torch.cuda.synchronize)


@contextlib.contextmanager
def recording():
    """Record spans inside this block (a new session), whether or not a
    profiler runs; yields the Recorder."""
    global _gate
    RECORDER.begin()
    RECORDER.forced += 1
    try:
        yield RECORDER
    finally:
        RECORDER.forced -= 1
        if not RECORDER.forced and not _profiler_on():
            RECORDER.live = False
            _gate = False


def requests(spans=None) -> dict:
    """request id -> its spans in open order (the root first)."""
    out: dict = {}
    for s in RECORDER.closed() if spans is None else spans:
        out.setdefault(s.request, []).append(s)
    return out


def host_syncs(spans) -> int:
    """The host syncs counted in spans."""
    return sum((s.counts or {}).get("host_syncs", 0) for s in spans)


def summary(spans=None) -> list[tuple]:
    """[(name, spans, host ms, self ms, host_syncs)] by span name, the
    most self time first. Self time is a span's time less its children's
    (a thread's children do not overlap)."""
    spans = RECORDER.closed() if spans is None else spans
    child_ns: dict = {}
    for s in spans:
        if s.parent is not None:
            child_ns[id(s.parent)] = child_ns.get(id(s.parent), 0) \
                + s.end_ns - s.start_ns
    rows: dict = {}
    for s in spans:
        dur = s.end_ns - s.start_ns
        r = rows.setdefault(s.name, [0, 0, 0, 0])
        r[0] += 1
        r[1] += dur
        r[2] += max(dur - child_ns.get(id(s), 0), 0)
        r[3] += (s.counts or {}).get("host_syncs", 0)
    return sorted(((k, n, t / 1e6, st / 1e6, h)
                   for k, (n, t, st, h) in rows.items()),
                  key=lambda r: -r[3])


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
    exported as a Chrome trace into trace_dir, when one is given, with a
    record_function range for each of the program's spans (on the card's
    timeline too, as "gpu_user_annotation"); the spans stay in RECORDER
    for `summary`."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, \
        tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(trace_dir))), \
            recording():
        RECORDER.ranges = True
        try:
            yield
        finally:
            RECORDER.ranges = False
