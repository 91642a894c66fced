"""A later change adds a cell and a metric, or a configuration with a
device the shared reference refuses and its own reference, as new files
plus manifest entries, and edits no file the benchmark has: shown in a
temporary copy of the benchmark, run on the CPU in processes of their
own."""

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
TOY2 = '''"""A throwaway song the shared reference refuses: the kit through a
static 12 dB low-pass into one gain."""


def project(cfg, seed):
    beat = [35 if i % 4 == 0 else 38 if i % 4 == 2 else 42
            for i in range(16)]
    return {"title": "toy2", "clock": {"bpm": cfg["bpm"],
                                       "time-signature": [4, 4]},
            "devices": [{"instrument": ["drums", {"drumkit": [
                {"midi-in": 9}, {"name": cfg["kit"]["name"]}]}]},
                {"effect": ["lp", {"filter-low-pass-12db": {
                    "cutoff": 2500.0, "q": 0.9}}]},
                {"effect": ["g", {"gain": {"ceiling": 0.5}}]}],
            "patch-cables": [["drums", "lp", "g", "main-mixer"]],
            "patterns": [{"id": "b", "note-value": "sixteenth",
                          "notes": [beat]}],
            "tracks": [{"id": "t", "midi-channel": 9,
                        "patterns": ["b"] * cfg["measures"]}]}
'''
TOY2_REFERENCE = '''"""toy2's plain reference: the shared one, and a static
filter-low-pass-12db from its stated behaviour, the cookbook low-pass
biquad in float64: w0 = 2 pi cutoff / rate, alpha = sin(w0) / (2 q),
b = (1 - cos w0) / 2 x [1, 2, 1], a = [1 + alpha, -2 cos w0, 1 - alpha]."""

import numpy as np

from benchmark.reference import render as shared


class Song(shared.Song):
    def effect(self, uvid, kind, params, x):
        if kind != "filter-low-pass-12db":
            return super().effect(uvid, kind, params, x)
        from scipy.signal import lfilter

        cutoff = self.block_param(uvid, "cutoff", 1000.0)
        q = self.block_param(uvid, "q", 0.707)
        if not (isinstance(cutoff, float) and isinstance(q, float)):
            raise NotImplementedError("reference: an automated lp12")
        w0 = 2.0 * np.pi * cutoff / self.rate
        alpha = np.sin(w0) / (2.0 * max(q, 1e-3))
        c = np.cos(w0)
        return lfilter([(1.0 - c) / 2.0, 1.0 - c, (1.0 - c) / 2.0],
                       [1.0 + alpha, -2.0 * c, 1.0 - alpha], x, axis=-1)


def render(project, assets, sample_rate=44100, round_to=None):
    y = Song(project, assets, sample_rate, round_to).output(shared.MAIN)
    return np.clip(np.trunc(y * shared.I16), -32768,
                   32767).astype(np.int16).T
'''
FLAX_AT_RUN_TIME = '''

_render = render


def render(*args, **kwargs):
    import flax  # noqa: F401

    return _render(*args, **kwargs)
'''
METRIC = '''"""calls_per_window: calls the traced window made."""

NEEDS = ()


def read(obs):
    return float(len(obs["call_s"]))
'''
RUNNER = """
import json, sys
from benchmark.run import run
res, lines = run(sys.argv[1], 5, 0.2, bool(int(sys.argv[2])),
                 device="cpu")
print(json.dumps(res))
"""
ENV = {"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin"}


def checkout(tmp_path):
    """A copy of benchmark/: (its root, its files as they were, the
    manifest to extend)."""
    copy = tmp_path / "checkout"
    shutil.copytree(HERE, copy / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(copy): p.read_bytes()
              for p in (copy / "benchmark").rglob("*") if p.is_file()}
    return copy, before, json.loads((REPO / "BENCHMARK.json").read_text())


def add_config(copy, m, name, song, limits):
    """A one-measure configuration `name` with its song, and its offline
    cell with `limits`."""
    bench = copy / "benchmark"
    (bench / "configs" / f"{name}.py").write_text(song)
    (bench / "configs" / f"{name}.json").write_text(json.dumps({
        "name": name, "measures": 1, "bpm": 120.0,
        "sample_rate": 44100,
        "kit": {"name": "707", "sample_rate": 44100, "max_seconds": 0.3,
                "short_seconds": 0.2}, "assumed": ["a test"],
        "reduced": []}))
    (bench / "limits" / f"{name}.offline.json").write_text(
        json.dumps(limits))
    m["configs"].append({"name": name, "source": "a test",
                         "file": f"benchmark/configs/{name}.json",
                         "reduced": [], "why": "a test"})
    m["workloads"].append({"name": f"{name}.offline", "config": name,
                           "traffic": "offline", "chips": 1, "why": "test"})


def run_cell(copy, cell, trace):
    return subprocess.run([sys.executable, "-c", RUNNER, cell, str(trace)],
                          cwd=copy, env=ENV, capture_output=True,
                          text=True, timeout=300)


def unchanged(copy, before) -> bool:
    after = {p.relative_to(copy): p.read_bytes()
             for p in (copy / "benchmark").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    return all(after[k] == v for k, v in before.items()
               if "__pycache__" not in k.parts)


def test_a_cell_and_a_metric_are_added_as_files(tmp_path):
    copy, before, m = checkout(tmp_path)
    add_config(copy, m, "toy", TOY, {"max_lsb": 0, "rms_lsb": 0})
    (copy / "benchmark" / "metrics" / "calls_per_window.py").write_text(
        METRIC)
    for e in m["end_to_end"]:
        if "workloads" in e:
            e["workloads"].append("toy.offline")
    m["per_layer"].append({"name": "calls_per_window", "unit": "calls",
                           "better": "higher", "source": "host_clock",
                           "layer": "engine.render", "moves": "xrt",
                           "workloads": ["toy.offline"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(m))
    for trace in (0, 1):
        out = run_cell(copy, "toy.offline", trace)
        assert out.returncode == 0, out.stderr[-3000:]
        res = json.loads(out.stdout.strip().splitlines()[-1])
        assert res["correct"], res
        if trace:
            assert res["metrics"]["calls_per_window"]["value"] >= 1
        else:
            assert "xrt" in res["metrics"]
    assert unchanged(copy, before)


def test_a_configuration_brings_its_own_reference(tmp_path):
    """toy2's song puts a 12 dB low-pass, which the shared reference
    refuses, after the kit: reference/toy2.py carries the cell, and the
    benchmark's own tests take it up by configuration and traffic."""
    copy, before, m = checkout(tmp_path)
    # between the program's 1 LSB / 0.0071 rms and the control's least,
    # 18 / 0.86, on seeds 3, 4, 5, 7, 11 and 2**31 + 12345
    add_config(copy, m, "toy2", TOY2, {"max_lsb": 4, "rms_lsb": 0.25})
    ref = copy / "benchmark" / "reference" / "toy2.py"
    ref.write_text(TOY2_REFERENCE)
    for e in m["end_to_end"] + m["per_layer"]:
        if e["name"] in ("xrt", "render_p90_ms", "dispatch_ms",
                         "fetch_wait_ms", "host_syncs"):
            e["workloads"].append("toy2.offline")
    (copy / "BENCHMARK.json").write_text(json.dumps(m))
    for trace in (0, 1):
        out = run_cell(copy, "toy2.offline", trace)
        assert out.returncode == 0, out.stderr[-3000:]
        res = json.loads(out.stdout.strip().splitlines()[-1])
        assert res["correct"], res
        if trace:
            assert res["metrics"]["host_syncs"]["value"] == 1
        else:
            assert "xrt" in res["metrics"]
    tests = subprocess.run(
        [sys.executable, "-m", "pytest", "-v", "-p", "no:cacheprovider",
         "benchmark/tests/test_bench_cpu.py",
         "benchmark/tests/test_bench_tracing.py",
         "benchmark/tests/test_bench_manifest.py", "-k", "toy2"],
        cwd=copy, env=ENV, capture_output=True, text=True, timeout=600)
    assert tests.returncode == 0, tests.stdout[-3000:]
    for case in ("cell_on_the_cpu[toy2.offline]",
                 "cell_traced_on_the_cpu[toy2.offline]",
                 "control_fails[toy2.offline]",
                 "broken_path_is_not_correct[toy2.offline-alter_offline]",
                 "a_traced_run_reports_them[toy2.offline]",
                 "cell_resolves[toy2.offline]", "config_file[toy2]"):
        assert f"::test_{case} PASSED" in tests.stdout, case
    assert unchanged(copy, before)
    # a reference that loads a forbidden module at run time, here a stub
    # flax in the checkout, ends the run before any result
    (copy / "flax").mkdir()
    (copy / "flax" / "__init__.py").write_text("")
    ref.write_text(TOY2_REFERENCE + FLAX_AT_RUN_TIME)
    out = run_cell(copy, "toy2.offline", 0)
    assert out.returncode != 0 and not out.stdout.strip(), out.stdout
    assert "the process holds flax" in out.stderr, out.stderr[-3000:]
    # without its own file the cell falls to the shared reference
    ref.unlink()
    out = run_cell(copy, "toy2.offline", 0)
    assert out.returncode != 0
    assert ("NotImplementedError: reference: no effect "
            "filter-low-pass-12db") in out.stderr, out.stderr[-3000:]
