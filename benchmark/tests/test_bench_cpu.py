"""Each cell run through the harness on the CPU at two measures: the
program against the plain reference, the control in bfloat16 failing
the comparison, and the timed path broken underneath in each way a cell
can be broken, seen as not correct."""

import copy

import numpy as np
import pytest
import torch

from benchmark import check, manifest
from benchmark.kit import write_kit
from benchmark.reference.render import render as reference
from benchmark.run import run

M = manifest.load()
CELLS = [w["name"] for w in M["workloads"]]
# measures that keep a CPU run to seconds: 4 s of the kitchen sink
SMALL = {"kitchen-sink": 2}
# the stream cut into 65536-frame segments, so 2 measures carry state
# across segments
SMALL_TRAFFIC = {"stream": {"segment_frames": 65536, "batch_segments": 2}}


@pytest.fixture(scope="module")
def manifest_path():
    return manifest.MANIFEST


def small(cell):
    w = {x["name"]: x for x in M["workloads"]}[cell]
    return ({"measures": SMALL[w["config"]]},
            SMALL_TRAFFIC.get(w["traffic"], {}))


def cpu_run(path, cell, seed=2147483647 + 12345, trace=False):
    over, traffic = small(cell)
    return run(cell, seed, 0.2, trace, device="cpu", overrides=over,
               traffic_overrides=traffic, manifest_path=path)[0]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_cpu(cell, manifest_path):
    res = cpu_run(manifest_path, cell)
    assert res["correct"], res["check"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    # the cell's end-to-end metrics: set-up and its rate at least (no
    # card peak here, no tail from one call)
    want = {m["name"] for m in manifest.Cell(M, cell).end_to_end}
    assert "setup_s" in res["metrics"] and len(res["metrics"]) >= 2
    assert set(res["metrics"]) <= want
    assert list(res)[-1] == "check"
    assert res["check"]["frames"]["value"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_cell_traced_on_the_cpu(cell, manifest_path):
    res = cpu_run(manifest_path, cell, seed=7, trace=True)
    assert res["correct"], res["check"]
    assert "compile_s" in res["metrics"]
    assert res["device"]["window_s"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell, tmp_path):
    """The reference with every device's output stored in bfloat16, put
    in the program's place, is not correct under the cell's limits."""
    c = manifest.Cell(M, cell)
    over, _ = small(cell)
    cfg = {**c.config, **over}
    for seed in (3, 4):
        assets = write_kit(tmp_path / str(seed), seed, cfg["kit"])
        song = c.maker.project(cfg, seed)
        ref = reference(song, assets)
        control = reference(song, assets, round_to="bfloat16")
        ok, shown = check.judge(check.compare(control, ref), c.limits)
        assert not ok, shown


def _alter_offline(monkeypatch):
    from groove_tpu_torch.engine.render import Renderer

    fn = Renderer.render_quantized

    def altered(self):
        y = fn(self).copy()
        y[len(y) // 2, 0] = np.int16(int(y[len(y) // 2, 0]) // 2 + 9000)
        return y
    monkeypatch.setattr(Renderer, "render_quantized", altered)


def _alter_stream(monkeypatch):
    from groove_tpu_torch.engine.stream import StreamingRenderer

    fn = StreamingRenderer.stream

    def altered(self, *a, **kw):
        for i, chunk in enumerate(fn(self, *a, **kw)):
            if i == 0:
                chunk = chunk.copy()
                chunk[len(chunk) // 2, 1] = np.int16(
                    int(chunk[len(chunk) // 2, 1]) // 2 + 9000)
            yield chunk
    monkeypatch.setattr(StreamingRenderer, "stream", altered)


def _half_left_out(monkeypatch):
    """Every second segment of a step rendered as silence."""
    from groove_tpu_torch.engine.stream import StreamingRenderer

    fn = StreamingRenderer.step
    calls = {"n": 0}

    def half(self, state, xs, S):
        y = fn(self, state, xs, S)
        calls["n"] += 1
        return torch.zeros_like(y) if calls["n"] % 2 == 0 else y
    monkeypatch.setattr(StreamingRenderer, "step", half)


def _state_unchanged(monkeypatch):
    """Each segment rendered from the state the stream began with."""
    from groove_tpu_torch.engine.stream import StreamingRenderer

    fn = StreamingRenderer.step

    def stale(self, state, xs, S):
        return fn(self, copy.deepcopy(state), xs, S)
    monkeypatch.setattr(StreamingRenderer, "step", stale)


FAULTS = [("kitchen-sink.offline", _alter_offline),
          ("kitchen-sink.stream", _alter_stream),
          ("kitchen-sink.stream", _half_left_out),
          ("kitchen-sink.stream", _state_unchanged)]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_broken_path_is_not_correct(cell, fault, monkeypatch,
                                    manifest_path):
    fault(monkeypatch)
    res = cpu_run(manifest_path, cell, seed=11)
    assert not res["correct"], res["check"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell, card, manifest_path):
    """One short run of each cell on the card at its full size."""
    res = run(cell, 2147483659, 2.0, False, manifest_path=manifest_path)[0]
    assert res["correct"], res["check"]
    assert res["device"]["platform"] == "gpu"
