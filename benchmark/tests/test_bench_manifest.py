"""Every entry of BENCHMARK.json resolves to its files by name, and the
manifest keeps the contract's shape."""

import json
import re

import pytest

from benchmark import manifest
from benchmark.reference.render import render as shared_render

M = manifest.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in M["workloads"]]


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["paths"] == ["benchmark"]
    assert 1 <= M["run_seconds"] <= 51
    assert len(json.dumps(M)) < 64 * 1024


def test_names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in M[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    metric_names = [m["name"] for m in M["end_to_end"] + M["per_layer"]]
    assert len(metric_names) == len(set(metric_names))
    # reference/<config>.py shares its folder with the shared reference:
    # no configuration takes a shared file's name, and every other file
    # there is a configuration's
    shared = {"__init__", "render", "song"}
    configs = {c["name"] for c in M["configs"]}
    assert not configs & shared
    assert {p.stem for p in (manifest.HERE / "reference").glob("*.py")} \
        <= shared | configs


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    c = manifest.Cell(M, cell)
    assert callable(c.maker.project)
    # the configuration's own reference where it has one, else the shared
    own = manifest.HERE / "reference" / f"{c.workload['config']}.py"
    assert callable(c.reference)
    assert (c.reference is shared_render) == (not own.exists())
    assert hasattr(c.entry, "Entry") and hasattr(c.entry, "SPANS")
    assert set(c.limits) == {"max_lsb", "rms_lsb"}
    for m in c.end_to_end + c.per_layer:
        reader = c.reader(m["name"])
        assert callable(reader.read)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer


@pytest.mark.parametrize("config", [c["name"] for c in M["configs"]])
def test_config_file(config):
    entry = {c["name"]: c for c in M["configs"]}[config]
    data = json.loads((manifest.HERE.parent / entry["file"]).read_text())
    assert data["name"] == config
    assert entry["reduced"] == data["reduced"] == []
    assert data["assumed"]
    assert len(entry["source"]) <= 200
    assert any(w["config"] == config for w in M["workloads"])


def test_metrics_point_at_end_to_end_metrics():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in M["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for m in M["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", CELLS):
            assert w in e2e[m["moves"]].get("workloads", CELLS)
