"""The port's spans and counters (groove_tpu_torch/utils/profiling.py) on
the kitchen-sink analogue at 2 measures: nothing recorded, nothing
allocated and no profiler range opened with tracing off; under
`recording()` the span trees of a bounce, a stream, a streamed scan and
loop, live blocks and the compile, their request ids, and host syncs
equal to the fetch sites reached; under torch.profiler the recorder on,
no range of the program's among the profiler's events, and the root
span converted onto the profiler's timeline within 100 us of a range
around the call; `trace` and `cli --trace-dir` writing a Chrome trace
with the spans' names; the same int16 output with recording on and off;
a CPU bounce's fetch counted as a pageable read (`fetch_pageable`) with
the array y.cpu().numpy() gives. The `cuda` test holds host_syncs to the
synchronising operations torch's sync debug mode reports on a card:

    python -m pytest tests/test_torch_tracing.py -q -m cuda
"""

from __future__ import annotations

import collections
import json
import tracemalloc
import traceback
import warnings

import numpy as np
import pytest
import torch

from groove_tpu_torch.compiler.song import compile_song
from groove_tpu_torch.engine import render as render_mod
from groove_tpu_torch.engine.render import Renderer
from groove_tpu_torch.engine.stream import StreamingRenderer
from groove_tpu_torch.io.wav import quantize_16bit
from groove_tpu_torch.project.paths import Paths
from groove_tpu_torch.project.schema import SongSettings
from groove_tpu_torch.testing import synth
from groove_tpu_torch.utils import profiling

SEGMENT = 65536  # 2 measures: 3 segments
BATCH = 2        # 2 fetched batches
PROGRAM = {"compile", "devices", "events", "notes", "automation", "order",
           "render", "graph", "instrument", "effect", "mix", "kernel",
           "quantize", "fetch", "stream", "state", "inputs", "step"}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def song(tmp_path_factory):
    root = synth.write_assets(tmp_path_factory.mktemp("assets"),
                              max_seconds=0.2)
    return SongSettings.from_json(synth.kitchen_sink_project(2)), root


def _compile(song):
    settings, root = song
    return compile_song(settings, Paths(roots=[root]))


@pytest.fixture(scope="module")
def compiled(song):
    return _compile(song)


def _stream(r):
    return list(r.stream(batch_segments=BATCH, quantize=True))


def _tree_ok(spans):
    """One request: every span's parent opened before it in the same
    request and encloses it in time."""
    ids = {id(s) for s in spans}
    for s in spans[1:]:
        assert s.request == spans[0].request
        assert id(s.parent) in ids
        assert s.parent.start_ns <= s.start_ns <= s.end_ns \
            <= s.parent.end_ns
    assert spans[0].parent is None


def _children(spans, parent):
    return [s.name for s in spans if s.parent is parent]


def test_nothing_recorded_when_off(compiled, monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a profiler range opened with tracing off")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    with profiling.recording():
        pass
    r = Renderer(compiled, "cpu")
    r.render_quantized()
    _stream(StreamingRenderer(compiled, "cpu", segment_frames=SEGMENT))
    assert not profiling._gate
    assert profiling.RECORDER.spans == []
    assert profiling.RECORDER.orphans == {}


def test_a_span_off_allocates_nothing():
    def spans():
        for _ in range(1000):
            with profiling.span("effect", kind="gain", uvid="g"):
                profiling.host_sync(None, bool)
    spans()
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        spans()
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [d for d in after.compare_to(before, "filename")
             if d.size_diff > 0
             and d.traceback[0].filename == profiling.__file__]
    assert grown == []


def test_a_bounce_is_one_request(compiled):
    r = Renderer(compiled, "cpu")
    with profiling.recording() as rec:
        y = r.render_quantized()
    reqs = profiling.requests()
    assert len(reqs) == 1
    (spans,) = reqs.values()
    _tree_ok(spans)
    root = spans[0]
    assert root.name == "render" and root.frames == compiled.n_frames
    assert _children(spans, root) == ["graph", "quantize", "fetch"]
    graph = spans[1]
    names = collections.Counter(s.name for s in spans)
    devices = [u for u in compiled.order
               if compiled.devices[u].role != "controller"
               or compiled.devices[u].kind == "signal-passthrough-controller"]
    effects = [u for u in devices if compiled.devices[u].role != "instrument"]
    assert names["effect"] == len(effects)
    assert names["instrument"] == len(devices) - len(effects)
    assert set(_children(spans, graph)) == {"instrument", "mix", "effect"}
    kinds = {s.kind for s in spans if s.name == "effect"}
    assert {"compressor", "delay", "chorus", "reverb"} <= kinds
    kernels = [s for s in spans if s.name == "kernel"]
    assert {"drums", "scan1", "lp24_cascade"} <= {s.kind for s in kernels}
    assert all(s.parent.name in ("instrument", "effect") for s in kernels)
    fetch = spans[-1]
    assert fetch.name == "fetch" and fetch.bytes == y.nbytes
    # the one fetch site a bounce reaches on the CPU, a pageable read
    assert fetch.counts == {"host_syncs": 1, "fetch_pageable": 1}
    assert profiling.host_syncs(spans) == 1 and rec.orphans == {}


@pytest.mark.parametrize("quantized", [True, False],
                         ids=["render_quantized", "render"])
def test_a_cpu_fetch_is_a_pageable_read(compiled, quantized):
    """On the CPU the fetch takes the pageable read: fetch_pageable 1 and
    no fetch_pinned on its span, and the array y.cpu().numpy() gives,
    with its shape, dtype and strides."""
    r = Renderer(compiled, "cpu")
    bounce = r.render_quantized if quantized else r.render
    with profiling.recording() as rec:
        out = bounce()
    (fetch,) = [s for s in rec.closed() if s.name == "fetch"]
    assert fetch.counts.get("fetch_pageable") == 1
    assert fetch.counts.get("fetch_pinned", 0) == 0
    assert fetch.counts.get("host_syncs") == 1 and rec.orphans == {}
    y = r.render_device()
    want = (quantize_16bit(y) if quantized else y).cpu().numpy()
    assert out.dtype == want.dtype == (np.int16 if quantized
                                       else np.float32)
    assert out.shape == want.shape == (compiled.n_frames, 2)
    assert out.strides == want.strides
    assert np.array_equal(out, want)


def test_the_fetch_counters_are_free_when_off(compiled):
    """Off, neither the bounces nor a bare count record anything."""
    r = Renderer(compiled, "cpu")
    with profiling.recording():
        pass
    r.render_quantized()
    r.render()
    profiling.count("fetch_pinned")
    assert not profiling._gate
    assert profiling.RECORDER.spans == [] and profiling.RECORDER.orphans == {}


def test_a_count_lands_in_the_innermost_span_or_the_orphans():
    with profiling.recording() as rec:
        profiling.count("fetch_pageable")
        with profiling.span("render"):
            with profiling.span("fetch"):
                profiling.count("fetch_pinned")
                profiling.count("fetch_pinned", 2)
    assert rec.orphans == {"fetch_pageable": 1}
    render, fetch = rec.closed()
    assert render.counts is None and fetch.counts == {"fetch_pinned": 3}


def test_pinned_like_keeps_the_layout_or_gives_none(monkeypatch):
    """The pinned destination has y's shape, dtype and strides where the
    host has page-locked memory (a CUDA build with a card); None where it
    raises, as on a CPU-only build."""
    y = torch.arange(10, dtype=torch.int16).reshape(2, 5).T
    h = render_mod._pinned_like(y)
    if torch.cuda.is_available():
        assert h.is_pinned() and h.device.type == "cpu"
        assert (h.shape, h.stride(), h.dtype) \
            == (y.shape, y.stride(), y.dtype)
    else:
        assert h is None

    def refuse(*a, **kw):
        raise RuntimeError("no page-locked memory")
    monkeypatch.setattr(torch, "empty_like", refuse)
    assert render_mod._pinned_like(y) is None


def test_a_stream_is_one_request(compiled):
    r = StreamingRenderer(compiled, "cpu", segment_frames=SEGMENT)
    assert r.n_segs == 3
    with profiling.recording() as rec:
        _stream(r)
    reqs = profiling.requests()
    assert len(reqs) == 1
    (spans,) = reqs.values()
    _tree_ok(spans)
    root = spans[0]
    assert root.name == "stream"
    batches = -(-r.n_segs // BATCH)
    assert collections.Counter(_children(spans, root)) == {
        "state": 1, "inputs": r.n_segs, "step": r.n_segs,
        "quantize": batches, "fetch": batches}
    steps = [s for s in spans if s.name == "step"]
    assert all({"instrument", "effect", "mix"}
               <= set(_children(spans, s)) for s in steps)
    # one host sync a fetched batch, none anywhere else
    assert [s.counts for s in spans if s.counts] \
        == [{"host_syncs": 1}] * batches
    assert all(s.name == "fetch" for s in spans if s.counts)
    assert rec.orphans == {}


def test_render_scan_and_loop_are_requests(compiled):
    r = StreamingRenderer(compiled, "cpu", segment_frames=SEGMENT)
    with profiling.recording():
        r.render_scan()
        list(r.stream_loop(0.0, 4.0, iterations=1))
    reqs = list(profiling.requests().values())
    assert [spans[0].name for spans in reqs] == ["stream", "stream"]
    for spans in reqs:
        _tree_ok(spans)
    scan, loop = reqs
    assert profiling.host_syncs(scan) == 1
    fetches = sum(s.name == "fetch" for s in loop)
    assert fetches == sum(s.name == "step" for s in loop) >= 2
    assert profiling.host_syncs(loop) == fetches


def test_live_blocks_are_requests(compiled):
    from groove_tpu_torch.engine.livesong import LiveSongRenderer

    r = LiveSongRenderer(compiled, device="cpu")
    r.render_block()
    with profiling.recording():
        r.render_block()
        r.render_block_pipelined()
        r.render_block_pipelined()
    reqs = list(profiling.requests().values())
    assert [_children(spans, spans[0]) for spans in reqs] == [
        ["inputs", "step", "fetch"],
        ["inputs", "step", "inputs", "step", "fetch"],
        ["inputs", "step", "fetch"]]
    for spans in reqs:
        _tree_ok(spans)
        assert spans[0].name == "block" and spans[0].frames == 64
        assert profiling.host_syncs(spans) == 1


def test_compile_phases(song):
    with profiling.recording():
        _compile(song)
    (spans,) = profiling.requests().values()
    assert spans[0].name == "compile"
    assert _children(spans, spans[0]) == ["devices", "events", "notes",
                                          "automation", "order"]


def test_a_consumer_span_is_no_child_of_a_generator(compiled):
    r = StreamingRenderer(compiled, "cpu", segment_frames=SEGMENT)
    with profiling.recording():
        for _ in r.stream(batch_segments=1, quantize=True):
            with profiling.span("consumer"):
                pass
    roots = [spans[0].name for spans in profiling.requests().values()]
    assert roots.count("stream") == 1 and roots.count("consumer") == 3


def test_under_the_profiler_on_its_clock_without_ranges(compiled):
    from torch.profiler import ProfilerActivity, profile, record_function

    r = Renderer(compiled, "cpu")
    r.render_quantized()
    with profiling.recording():
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert profiling._gate or torch.autograd._profiler_enabled()
        with record_function("test:call"):
            r.render_quantized()
    reqs = list(profiling.requests().values())
    assert len(reqs) == 1 and reqs[0][0].name == "render"
    names = {e.name for e in prof.events()}
    assert "test:call" in names and not names & PROGRAM
    (call,) = [e for e in prof.events() if e.name == "test:call"]
    t0 = prof.profiler.kineto_results.trace_start_ns()
    root = reqs[0][0]
    start_us = (root.start_ns - t0) / 1e3
    end_us = (root.end_ns - t0) / 1e3
    assert call.time_range.start - 100 <= start_us <= end_us \
        <= call.time_range.end + 100
    # the session's spans stay after it, until the next one begins
    r.render_quantized()
    assert len(profiling.requests()) == 1
    with profile(activities=[ProfilerActivity.CPU]):
        r.render_quantized()
        r.render_quantized()
    assert len(profiling.requests()) == 2


def test_trace_writes_the_spans(compiled, tmp_path):
    r = Renderer(compiled, "cpu")
    with profiling.trace(str(tmp_path)):
        r.render_quantized()
    (path,) = tmp_path.glob("*.json")
    names = {str(e.get("name")).lower()
             for e in json.loads(path.read_text())["traceEvents"]}
    assert {"render", "graph", "instrument", "effect", "mix", "kernel",
            "quantize", "fetch"} <= names
    assert not profiling.RECORDER.ranges
    rows = {row[0]: row for row in profiling.summary()}
    assert rows["fetch"][4] == 1 and rows["render"][1] == 1


def test_the_output_is_the_same_recorded(compiled):
    r = Renderer(compiled, "cpu")
    s = StreamingRenderer(compiled, "cpu", segment_frames=SEGMENT)
    off = r.render_quantized(), np.concatenate(_stream(s))
    with profiling.recording():
        on = r.render_quantized(), np.concatenate(_stream(s))
    assert on[0].dtype == np.int16 and on[1].dtype == np.int16
    assert np.array_equal(off[0], on[0])
    assert np.array_equal(off[1], on[1])


def _syncs_reported(fn) -> tuple[int, list]:
    """(host syncs the recorder counted, the synchronising operations
    torch's sync debug mode reported, each as its stack's last frames)
    for one call of fn."""
    found = []

    def hook(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" in str(message):
            found.append([f"{f.filename}:{f.lineno} {f.name}"
                          for f in traceback.extract_stack()[-6:-1]])

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with profiling.recording() as rec:
                fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    counted = profiling.host_syncs(rec.closed()) \
        + rec.orphans.get("host_syncs", 0)
    return counted, found


@pytest.mark.cuda
def test_host_syncs_are_every_sync_on_the_card(song):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    c = _compile(song)
    r = Renderer(c, "cuda")
    s = StreamingRenderer(c, "cuda", segment_frames=SEGMENT)
    # warm-up: the kernel library's build and first launches
    r.render_quantized()
    _stream(s)
    torch.cuda.synchronize()
    for fn in (r.render_quantized, lambda: _stream(s)):
        counted, found = _syncs_reported(fn)
        assert counted == len(found) >= 1, found


def test_cli_trace_dir(song, tmp_path, monkeypatch, capsys):
    """cli --trace-dir: the file's processing traced into a Chrome trace,
    a table of the spans by name, and the same WAV as without it."""
    from groove_tpu_torch import cli

    monkeypatch.setenv("GROOVE_ASSETS", str(song[1]))
    proj = synth.write_project(tmp_path / "ks.json",
                               synth.kitchen_sink_project(2))
    base = [str(proj), "--wav", "--device", "cpu", "-q", "--out-dir"]
    assert cli.main(base + [str(tmp_path / "plain")]) == 0
    capsys.readouterr()
    assert cli.main(base + [str(tmp_path / "traced"), "--trace-dir",
                            str(tmp_path / "trace")]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == f"Trace: {tmp_path / 'trace'}"
    rows = {r.split()[0]: r.split()[1:] for r in lines[2:]}
    assert {"compile", "render", "graph", "effect", "kernel",
            "fetch"} <= set(rows)
    assert rows["render"][0] == "1" and rows["fetch"][-1] == "1"
    assert len(list((tmp_path / "trace").glob("*.json"))) == 1
    assert (tmp_path / "traced" / "ks.wav").read_bytes() \
        == (tmp_path / "plain" / "ks.wav").read_bytes()
