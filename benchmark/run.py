"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up writes the seeded kit under $TMPDIR, makes the song from the
cell's configuration and the seed, compiles it with the program's
compile_song, builds the traffic mix's entry on the card and warms it up
with one call; set-up ends there. The window then calls the entry back to
back for --seconds (with --trace 1: the traffic's trace_calls calls under
torch.profiler, then its synchronised stages and operation counts, as the
cell's per-layer metrics need them). Once the window has closed and the
program's state is freed, one call's output, drawn from the seed, is held
to the plain reference (benchmark/reference, float64 NumPy on the host).
The first call of the kernel library, which builds it in a fresh
checkout, is timed apart within set-up (setup_parts). The last
line of standard output is one JSON object: correct, attempted, failed,
metrics, device (and with --trace 1, breakdown) and last the numbers
compared with their limits, which also close standard error.

Needs a CUDA card; exits non-zero, printing no result, without one.
"""

from __future__ import annotations

import time

_T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import shutil  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "groove_tpu")


def process_age() -> float:
    """Seconds since this process started (from /proc), or since this
    module was imported where /proc is missing."""
    try:
        start = float(Path("/proc/self/stat").read_text()
                      .rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return uptime - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_IMPORT


def forbidden_modules() -> list:
    """Modules loaded whose top-level name is jax, jaxlib, flax or the
    JAX package (compared whole: groove_tpu_torch is not groove_tpu)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def set_cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the program builds its library into build/groove_tpu_torch there)."""
    os.environ["TRITON_CACHE_DIR"] = str(CHECKOUT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CHECKOUT / "build"
                                             / "torch_extensions")


def _sync(device: str) -> None:
    import torch

    if device == "cuda":
        torch.cuda.synchronize()


def run(workload: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", overrides: dict | None = None,
        traffic_overrides: dict | None = None,
        manifest_path=None) -> tuple[dict, list]:
    """One run of `workload`: (the result object, the lines that close
    standard error). `overrides` and `traffic_overrides` replace keys of
    the configuration and the traffic mix (the tests run a cell at a
    measure or two on the CPU)."""
    import torch

    from benchmark import check, manifest
    from benchmark.kit import write_kit
    from benchmark.opcount import OpCount
    from benchmark.trace import Spans, reduce

    cell = manifest.Cell(manifest.load(manifest_path), workload)
    cfg = {**cell.config, **(overrides or {})}
    traffic = {**cell.traffic, **(traffic_overrides or {})}
    rng = random.Random(seed)
    needs = set()
    readers = {}
    for m in (cell.end_to_end if not trace else cell.per_layer):
        readers[m["name"]] = cell.reader(m["name"])
        needs |= set(getattr(readers[m["name"]], "NEEDS", ()))

    work_dir = Path(tempfile.mkdtemp(prefix="groove-bench-"))
    try:
        # ---- set-up ------------------------------------------------------
        from groove_tpu_torch.compiler.song import compile_song
        from groove_tpu_torch.project.paths import Paths
        from groove_tpu_torch.project.schema import SongSettings

        assets = write_kit(work_dir / "assets", seed, cfg["kit"])
        project = cell.maker.project(cfg, seed)
        t0 = time.perf_counter()
        cold = False
        if device == "cuda":
            # the program's kernel library: built here in a checkout's
            # first run, loaded from build/groove_tpu_torch/ after
            from groove_tpu_torch.kernels import build

            cold = not build.library_path().exists()
            build.library()
        library_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        compiled = compile_song(SongSettings.from_json(project),
                                Paths(roots=[assets]),
                                sample_rate=int(cfg["sample_rate"]))
        compile_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        entry = cell.entry.Entry(compiled, device, traffic)
        out = entry.call()
        _sync(device)
        warmup_s = time.perf_counter() - t0
        setup_s = process_age()
        setup_peak = (torch.cuda.max_memory_allocated()
                      if device == "cuda" else 0)
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()

        # ---- the window -------------------------------------------------
        sample_rate = int(cfg["sample_rate"])
        call_s, frames, failed, kept, prof_obs = [], 0, 0, None, None
        n_frames = compiled.n_frames

        def one():
            nonlocal frames, failed, kept
            t = time.perf_counter()
            out = entry.call()
            call_s.append(time.perf_counter() - t)
            chunks = entry.chunks(out)
            got = sum(len(c) for c in chunks)
            if got != n_frames or any(c.dtype.name != "int16"
                                      or c.shape[1:] != (2,)
                                      for c in chunks):
                failed += 1
            frames += got
            # one call's output, drawn from the seed (reservoir of one)
            if rng.randrange(len(call_s)) == 0:
                kept = chunks

        if not trace:
            start = time.perf_counter()
            while time.perf_counter() - start < seconds:
                one()
            window_s = time.perf_counter() - start
        else:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if device == "cuda" else [])
            spans = Spans(cell.entry.SPANS)
            with spans, profile(activities=activities) as prof:
                start = time.perf_counter()
                for _ in range(int(traffic["trace_calls"])):
                    with torch.profiler.record_function("bench:call"):
                        one()
                    if time.perf_counter() - start >= seconds:
                        break
                _sync(device)
                window_s = time.perf_counter() - start
            prof_obs = reduce(prof, spans)
        peak = (torch.cuda.max_memory_allocated()
                if device == "cuda" else 0)
        obs = {"setup_s": setup_s, "compile_s": compile_s,
               "peak_bytes": peak, "sample_rate": sample_rate,
               "window_s": window_s, "frames": frames, "call_s": call_s,
               "trace": prof_obs, "segments": entry.segments()}
        if trace and "staged" in needs and device == "cuda":
            obs["staged"] = [entry.staged()
                             for _ in range(int(traffic["staged_calls"]))]
        if trace and "ops" in needs:
            with OpCount(device) as count:
                entry.call()
            obs["ops_per_call"] = count.n
        attempted = len(call_s)

        # ---- free the program's state, then the reference ---------------
        program_out = np.concatenate(kept) if kept else None
        del entry, compiled, out
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        reference = cell.reference

        t0 = time.perf_counter()
        ref_out = reference(project, assets, sample_rate)
        reference_s = time.perf_counter() - t0
        # after the last of the program and the configuration's reference,
        # which a later change adds as a file: neither may load jax
        found = forbidden_modules()
        if found:
            raise SystemExit("benchmark: the process holds "
                             + ", ".join(found))
        numbers = (check.compare(program_out, ref_out)
                   if program_out is not None
                   else {"frames": -float(len(ref_out))})
        ok, shown = check.judge(numbers, cell.limits)
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)

    metrics = {}
    for m in (cell.end_to_end if not trace else cell.per_layer):
        value = readers[m["name"]].read(obs)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                    else "cpu"),
           "count": int(cell.workload["chips"]),
           "memory_peak_bytes": max(peak, setup_peak)}
    result = {"correct": bool(ok and failed == 0),
              "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace and prof_obs is not None:
        dev["busy_s"] = prof_obs["busy_s"]
        dev["window_s"] = window_s
        result["breakdown"] = {"device_ops": prof_obs["device_ops"],
                               "idle_gaps": prof_obs["idle_gaps"]}
    # set-up's parts; a cold kernel_library_s is the build
    result["setup_parts"] = {"kernel_library_s": library_s,
                             "library_built": cold,
                             "compile_s": compile_s, "warmup_s": warmup_s}
    result["check"] = shown
    q = (statistics.quantiles(call_s, n=4) if len(call_s) > 1
         else call_s * 3)
    lines = [f"reference: {reference_s} s",
             "setup_parts: " + json.dumps(result["setup_parts"]),
             f"calls: {len(call_s)}, quartiles of a call's seconds "
             f"{q[0]} {q[1]} {q[2]}, min {min(call_s)} max {max(call_s)}"]
    if prof_obs is not None:
        lines.append("trace: " + json.dumps(
            {k: v for k, v in prof_obs.items()
             if k not in ("device_ops", "idle_gaps")}))
    lines += [f"check {k}: {v['value']} limit {v['limit']}"
              for k, v in shown.items()]
    return result, lines


def main(argv=None) -> int:
    a = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    a.add_argument("--workload", required=True)
    a.add_argument("--seed", type=int, required=True)
    a.add_argument("--seconds", type=float, required=True)
    a.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = a.parse_args(argv)
    set_cache_dirs()
    import torch

    from benchmark import manifest

    chips = int(next(w["chips"] for w in manifest.load()["workloads"]
                     if w["name"] == args.workload))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: {args.workload} needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    torch.set_num_threads(1)  # one process, one host thread: steadier
    result, lines = run(args.workload, args.seed, args.seconds,
                        bool(args.trace))
    found = forbidden_modules()
    if found:
        print("benchmark: the process holds " + ", ".join(found),
              file=sys.stderr)
        return 3
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
