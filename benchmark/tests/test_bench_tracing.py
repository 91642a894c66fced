"""The per-layer metrics read from the program's own spans and counters
(metrics/_program_spans.py): a --trace 1 run on the CPU, at
test_bench_cpu's size, of each cell that lists them reports each as a
number; given an empty recorder, or a program without one, each reader
gives nothing. The metrics are keyed by the entry whose spans they
read, so a cell of that entry added as files is tested here too."""

import pytest

from benchmark import manifest
from benchmark.tests.test_bench_cpu import ENTRY, cpu_run

M = manifest.load()
PROGRAM = {"offline": ("dispatch_ms", "fetch_wait_ms", "host_syncs"),
           "stream": ("dispatch_ms.stream", "inputs_ms.stream",
                      "fetch_wait_ms.stream", "host_syncs.stream")}
READERS = [m for names in PROGRAM.values() for m in names]
PER_LAYER = {m["name"]: m for m in M["per_layer"]}
# (cell, entry) for every cell that one of the entry's metrics lists
TRACED = sorted({(cell, entry) for entry, names in PROGRAM.items()
                 for name in names
                 for cell in PER_LAYER[name]["workloads"]})


def test_the_metrics_are_in_the_manifest():
    for entry, names in PROGRAM.items():
        for name in names:
            assert PER_LAYER[name]["workloads"]
            assert all(ENTRY[c] == entry
                       for c in PER_LAYER[name]["workloads"]), name
            assert PER_LAYER[name]["better"] == "lower"


@pytest.mark.parametrize("cell,entry", TRACED,
                         ids=[cell for cell, _ in TRACED])
def test_a_traced_run_reports_them(cell, entry):
    res = cpu_run(manifest.MANIFEST, cell, seed=2**31 + 77, trace=True)
    assert res["correct"], res["check"]
    got = {n: res["metrics"][n]["value"] for n in PROGRAM[entry]
           if cell in PER_LAYER[n]["workloads"]}
    for name, value in got.items():
        assert isinstance(value, float | int) and value >= 0, name
    syncs = got.get(PROGRAM[entry][-1])
    if syncs is not None:
        # a bounce: its one fetch; a stream: a fetch a batch of segments
        assert syncs == 1 if entry == "offline" else 0 < syncs < 1


@pytest.mark.parametrize("name", READERS)
def test_an_empty_recorder_reads_nothing(name, monkeypatch):
    from groove_tpu_torch.utils import profiling

    reader = manifest.Cell(M, PER_LAYER[name]["workloads"][0]).reader(name)
    with profiling.recording():
        pass
    assert reader.read({}) is None
    monkeypatch.delattr(profiling, "RECORDER")
    assert reader.read({}) is None
