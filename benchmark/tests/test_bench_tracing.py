"""The per-layer metrics read from the program's own spans and counters
(metrics/_program_spans.py): a --trace 1 run of each cell on the CPU at
two measures reports each as a number; given an empty recorder, or a
program without one, each reader gives nothing."""

import pytest

from benchmark import manifest
from benchmark.tests.test_bench_cpu import cpu_run

M = manifest.load()
PROGRAM = {"kitchen-sink.offline": ("dispatch_ms", "fetch_wait_ms",
                                    "host_syncs"),
           "kitchen-sink.stream": ("dispatch_ms.stream", "inputs_ms.stream",
                                   "fetch_wait_ms.stream",
                                   "host_syncs.stream")}
READERS = [m for names in PROGRAM.values() for m in names]


def test_the_metrics_are_in_the_manifest():
    per_layer = {m["name"]: m for m in M["per_layer"]}
    for cell, names in PROGRAM.items():
        for name in names:
            assert per_layer[name]["workloads"] == [cell]
            assert per_layer[name]["better"] == "lower"


@pytest.mark.parametrize("cell", list(PROGRAM))
def test_a_traced_run_reports_them(cell):
    res = cpu_run(manifest.MANIFEST, cell, seed=2**31 + 77, trace=True)
    assert res["correct"], res["check"]
    for name in PROGRAM[cell]:
        value = res["metrics"][name]["value"]
        assert isinstance(value, float | int) and value >= 0, name
    syncs = res["metrics"][PROGRAM[cell][-1]]["value"]
    if cell == "kitchen-sink.offline":
        assert syncs == 1   # the fetch
    else:
        assert 0 < syncs < 1  # a fetch a batch of segments


@pytest.mark.parametrize("name", READERS)
def test_an_empty_recorder_reads_nothing(name, monkeypatch):
    from groove_tpu_torch.utils import profiling

    reader = manifest.Cell(M, [c for c, n in PROGRAM.items()
                               if name in n][0]).reader(name)
    with profiling.recording():
        pass
    assert reader.read({}) is None
    monkeypatch.delattr(profiling, "RECORDER")
    assert reader.read({}) is None
