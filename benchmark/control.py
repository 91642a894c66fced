"""Readings that set a cell's limits: the program's numbers over many
seeds and the control's, at the cell's own size, in one process.

    python3 -m benchmark.control --workloads kitchen-sink.offline,kitchen-sink.stream \
        --seeds 1,2,3 [--program 0] [--control 1]

For each seed it writes the kit, makes the song, renders the plain
reference once, and then (--program 1, on the card) holds one
steady call of each workload's entry to it, and (--control 1) the
control: the reference with every device's output stored in bfloat16,
the step below the float32 the configurations state. One JSON line a
seed and workload. The workloads must share a configuration."""

from __future__ import annotations

import argparse
import gc
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path


def main(argv=None) -> int:
    a = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    a.add_argument("--workloads", required=True)
    a.add_argument("--seeds", required=True)
    a.add_argument("--program", type=int, default=1)
    a.add_argument("--control", type=int, default=0)
    args = a.parse_args(argv)
    import numpy as np
    import torch

    from benchmark import check, manifest
    from benchmark.kit import write_kit

    m = manifest.load()
    cells = [manifest.Cell(m, w) for w in args.workloads.split(",")]
    cfg = cells[0].config
    if any(c.config["name"] != cfg["name"] for c in cells):
        raise SystemExit("control: the workloads must share a config")
    reference = cells[0].reference
    if args.program and not torch.cuda.is_available():
        raise SystemExit("control: the program's readings need a card")
    for seed in (int(s) for s in args.seeds.split(",")):
        work_dir = Path(tempfile.mkdtemp(prefix="groove-control-"))
        try:
            assets = write_kit(work_dir, seed, cfg["kit"])
            song = cells[0].maker.project(cfg, seed)
            outs = {}
            if args.program:
                from groove_tpu_torch.compiler.song import compile_song
                from groove_tpu_torch.project.paths import Paths
                from groove_tpu_torch.project.schema import SongSettings

                compiled = compile_song(SongSettings.from_json(song),
                                        Paths(roots=[assets]))
                for c in cells:
                    entry = c.entry.Entry(compiled, "cuda", c.traffic)
                    entry.call()
                    outs[c.name] = np.concatenate(
                        entry.chunks(entry.call()))
                    del entry
                del compiled
                gc.collect()
                torch.cuda.empty_cache()
            t0 = time.perf_counter()
            ref = reference(song, assets, int(cfg["sample_rate"]))
            ref_s = time.perf_counter() - t0
            for c in cells:
                if c.name in outs:
                    print(json.dumps({
                        "workload": c.name, "seed": seed, "side": "program",
                        "reference_s": ref_s,
                        **check.compare(outs[c.name], ref)}), flush=True)
            if args.control:
                control = reference(song, assets, int(cfg["sample_rate"]),
                                    round_to="bfloat16")
                for c in cells:
                    print(json.dumps({
                        "workload": c.name, "seed": seed, "side": "control",
                        **check.compare(control, ref)}), flush=True)
        finally:
            shutil.rmtree(work_dir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
