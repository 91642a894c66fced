"""A later change adds a cell and a metric as new files plus manifest
entries, and edits no file the benchmark has: shown in a temporary copy
of the benchmark, run on the CPU in a process of its own."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
REPO = HERE.parent

TOY = '''"""A throwaway song: the kit into one gain."""


def project(cfg, seed):
    beat = [35 if i % 4 == 0 else 42 for i in range(16)]
    return {"title": "toy", "clock": {"bpm": cfg["bpm"],
                                      "time-signature": [4, 4]},
            "devices": [{"instrument": ["drums", {"drumkit": [
                {"midi-in": 9}, {"name": cfg["kit"]["name"]}]}]},
                {"effect": ["g", {"gain": {"ceiling": 0.5}}]}],
            "patch-cables": [["drums", "g", "main-mixer"]],
            "patterns": [{"id": "b", "note-value": "sixteenth",
                          "notes": [beat]}],
            "tracks": [{"id": "t", "midi-channel": 9,
                        "patterns": ["b"] * cfg["measures"]}]}
'''
METRIC = '''"""calls_per_window: calls the traced window made."""

NEEDS = ()


def read(obs):
    return float(len(obs["call_s"]))
'''
RUNNER = """
import json, sys
from benchmark.run import run
res, lines = run("toy.offline", 5, 0.2, bool(int(sys.argv[1])),
                 device="cpu")
print(json.dumps(res))
"""


def test_a_cell_and_a_metric_are_added_as_files(tmp_path):
    copy = tmp_path / "checkout"
    shutil.copytree(HERE, copy / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(copy): p.read_bytes()
              for p in (copy / "benchmark").rglob("*") if p.is_file()}
    m = json.loads((REPO / "BENCHMARK.json").read_text())
    (copy / "benchmark" / "configs" / "toy.py").write_text(TOY)
    (copy / "benchmark" / "configs" / "toy.json").write_text(json.dumps({
        "name": "toy", "measures": 1, "bpm": 120.0, "sample_rate": 44100,
        "kit": {"name": "707", "sample_rate": 44100, "max_seconds": 0.3,
                "short_seconds": 0.2}, "assumed": ["a test"],
        "reduced": []}))
    (copy / "benchmark" / "limits" / "toy.offline.json").write_text(
        json.dumps({"max_lsb": 0, "rms_lsb": 0}))
    (copy / "benchmark" / "metrics" / "calls_per_window.py").write_text(
        METRIC)
    m["configs"].append({"name": "toy", "source": "a test",
                         "file": "benchmark/configs/toy.json",
                         "reduced": [], "why": "a test"})
    m["workloads"].append({"name": "toy.offline", "config": "toy",
                           "traffic": "offline", "chips": 1, "why": "test"})
    for e in m["end_to_end"]:
        if "workloads" in e:
            e["workloads"].append("toy.offline")
    m["per_layer"].append({"name": "calls_per_window", "unit": "calls",
                           "better": "higher", "source": "host_clock",
                           "layer": "engine.render", "moves": "xrt",
                           "workloads": ["toy.offline"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(m))
    env = {"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin"}
    for trace in (0, 1):
        out = subprocess.run([sys.executable, "-c", RUNNER, str(trace)],
                             cwd=copy, env=env, capture_output=True,
                             text=True, timeout=300)
        assert out.returncode == 0, out.stderr[-3000:]
        res = json.loads(out.stdout.strip().splitlines()[-1])
        assert res["correct"], res
        if trace:
            assert res["metrics"]["calls_per_window"]["value"] >= 1
        else:
            assert "xrt" in res["metrics"]
    after = {p.relative_to(copy): p.read_bytes()
             for p in (copy / "benchmark").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items()
               if "__pycache__" not in k.parts)
