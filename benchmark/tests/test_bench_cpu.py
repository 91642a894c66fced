"""Each cell run through the harness on the CPU at about 4 s of its
song: the program against the cell's plain reference, the
control in bfloat16 failing the comparison, and the timed path broken
underneath in each way a cell of its entry can be broken, seen as not
correct. Cells are taken by configuration and traffic mix, so a cell
added as files is tested here too."""

import copy
import math

import numpy as np
import pytest
import torch

from benchmark import check, manifest
from benchmark.kit import write_kit
from benchmark.run import run

M = manifest.load()
CELLS = [w["name"] for w in M["workloads"]]
ENTRY = {cell: manifest.Cell(M, cell).traffic["entry"] for cell in CELLS}
# seconds of song that keep a CPU run to seconds
CPU_SECONDS = 4
# by entry: the stream cut into 65536-frame segments, so a few seconds
# of song carry state across segments
SMALL_ENTRY = {"stream": {"segment_frames": 65536, "batch_segments": 2}}


@pytest.fixture(scope="module")
def manifest_path():
    return manifest.MANIFEST


def small(cell):
    """(configuration overrides, traffic overrides) that keep a CPU run
    to seconds: the whole measures that hold CPU_SECONDS of the song at
    its tempo and time signature, and no more than the song has."""
    c = manifest.Cell(M, cell)
    clock = c.maker.project(c.config, 0)["clock"]
    beats = clock.get("time-signature", [4, 4])[0]
    measures = min(int(c.config["measures"]),
                   math.ceil(CPU_SECONDS * clock["bpm"] / (60 * beats)))
    return ({"measures": measures}, SMALL_ENTRY.get(ENTRY[cell], {}))


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
    rate = int(cfg["sample_rate"])
    for seed in (3, 4):
        assets = write_kit(tmp_path / str(seed), seed, cfg["kit"])
        song = c.maker.project(cfg, seed)
        ref = c.reference(song, assets, rate)
        control = c.reference(song, assets, rate, round_to="bfloat16")
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


# each fault by the entry it breaks, attached to every cell of that entry
FAULTS = [(cell, fault)
          for entry, fault in (("offline", _alter_offline),
                               ("stream", _alter_stream),
                               ("stream", _half_left_out),
                               ("stream", _state_unchanged))
          for cell in CELLS if ENTRY[cell] == entry]


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
