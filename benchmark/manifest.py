"""BENCHMARK.json and the files it names, found by name: a cell's
configuration (configs/<config>.json and its song maker
configs/<config>.py), the configuration's plain reference
(reference/<config>.py where it has one of its own, else the shared
reference/render.py), its traffic mix (traffic/<traffic>.json), the
mix's entry (entries/<entry>.py), the cell's limits (limits/<cell>.json)
and each metric's reader (metrics/<metric>.py)."""

from __future__ import annotations

import importlib.util
import json
from functools import cached_property
from pathlib import Path

HERE = Path(__file__).resolve().parent
MANIFEST = HERE.parent / "BENCHMARK.json"


def load(path=None) -> dict:
    return json.loads(Path(path or MANIFEST).read_text())


def module(path: Path, name: str):
    """Import the Python file `path` as module `name`."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _slug(name: str) -> str:
    return "".join(c if c.isalnum() else "_" for c in name)


class Cell:
    """One workload of the manifest and everything it names."""

    def __init__(self, manifest: dict, workload: str, root: Path = HERE):
        cells = {w["name"]: w for w in manifest["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.root = Path(root)
        self.workload = cells[workload]
        self.name = workload
        self.config_entry = {c["name"]: c for c in manifest["configs"]}[
            self.workload["config"]]
        self.config = json.loads(
            (self.root.parent / self.config_entry["file"]).read_text())
        self.maker = module(
            self.root / "configs" / f"{self.workload['config']}.py",
            f"benchmark_config_{_slug(self.workload['config'])}")
        self.traffic = json.loads(
            (self.root / "traffic" / f"{self.workload['traffic']}.json")
            .read_text())
        self.entry = module(
            self.root / "entries" / f"{self.traffic['entry']}.py",
            f"benchmark_entry_{_slug(self.traffic['entry'])}")
        self.limits = json.loads(
            (self.root / "limits" / f"{workload}.json").read_text())
        self.end_to_end = [m for m in manifest["end_to_end"]
                           if workload in m.get("workloads", [workload])]
        self.per_layer = [m for m in manifest["per_layer"]
                          if workload in m.get("workloads", [workload])]

    @cached_property
    def reference(self):
        """The configuration's plain reference, `render(project, assets,
        sample_rate, round_to=None) -> int16 [n, 2]` (round_to="bfloat16"
        is the control): reference/<config>.py's `render` where that file
        exists, else the shared reference's. Loaded on first use, so a
        run's set-up does not pay for it."""
        path = self.root / "reference" / f"{self.workload['config']}.py"
        if path.exists():
            return module(path, "benchmark_reference_"
                          + _slug(self.workload["config"])).render
        from benchmark.reference.render import render

        return render

    def reader(self, metric: str):
        return module(self.root / "metrics" / f"{metric}.py",
                      f"benchmark_metric_{_slug(metric)}")
