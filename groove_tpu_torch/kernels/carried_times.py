"""Card times of the unsliced stream's S1 and S2 calls (csrc/scan_stream.cu,
csrc/comb_stream.cu) at the shapes the streamed render gives them.

    python -m groove_tpu_torch.kernels.carried_times [--reps 20]

Times, on seeded stereo inputs of one 262144-frame segment, 10 s (441,024
frames) and 3 minutes (7,938,048 frames) at 44.1 kHz: the follower's
attack one-pole (S1 linear, per-sample a and b, one row read by both
rows), its peak hold (S1 max_decay, a number), the automated reverb's
longest comb (S2, D = 1927, per-sample g), the static reverb's shortest
comb (D = 1310, a number) and the two all-passes (D = 221, 75). Each call
gives `ms` (CUDA events around one call, the median of --reps after one
warm-up) and `device_ms` (a captured CUDA graph of 20 calls, replayed 5
times, the median over 20: the card alone). Prints one JSON line with the
card's name and power limit (nvidia-smi). Needs a CUDA device; exits
non-zero without one.

With --stages, it also builds csrc/scan_stream.cu and csrc/comb_stream.cu
each alone with their stage stamps (STAGE_STAMPS, csrc/stage.cuh) and
runs the 3-minute calls on them once: for S1, each span's staging and
fold (us from the block's start), its wait for the entry value after
the previous span published (us, the handoff), its walk (SM cycles a
chain step) and its output; for S2, each block's SM cycles a tile
waiting for the tile, issuing the next copies (the mover) and walking.

The package timed is the one `import groove_tpu_torch` finds: run the file
by its path with PYTHONPATH set to another checkout (a parent commit
unpacked beside this one),

    PYTHONPATH=<checkout> python groove_tpu_torch/kernels/carried_times.py

to time that checkout's kernels on the same inputs in the same call to the
card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

SIZES = {"segment": 262144, "10 s": 441024, "3 min": 7938048}
GRAPH_CALLS = 20


def calls(n: int, device):
    """label -> a zero-argument call of the wrapper, on seeded inputs."""
    import numpy as np
    import torch

    from groove_tpu_torch.ops import stream_kernels as sk

    rng = np.random.default_rng(n % 1000)
    x = torch.from_numpy((rng.standard_normal((2, n)) * 0.3)
                         .astype(np.float32)).to(device)
    mag = x.abs()
    a = torch.from_numpy(rng.uniform(0.9, 0.999, n).astype(np.float32)
                         ).to(device)
    b = 1 - a
    y0 = torch.tensor([0.1, 0.2], device=device)
    g = a * 0.8
    h = {d: torch.from_numpy((rng.standard_normal((2, d)) * 0.1)
                             .astype(np.float32)).to(device)
         for d in (75, 221, 1310, 1927)}
    hy = {d: 0.5 * t for d, t in h.items()}
    return {
        "S1 follower attack (linear, per-sample a, b)":
            lambda: sk.scan_stream(mag, a, b, y0, sk.LINEAR),
        "S1 peak hold (max_decay, number r)":
            lambda: sk.scan_stream(mag, 0.9995, 1.0, y0, sk.MAX_DECAY),
        "S2 comb D = 1927, per-sample g":
            lambda: sk.comb_stream(x, h[1927], hy[1927], g),
        "S2 comb D = 1310, number g":
            lambda: sk.comb_stream(x, h[1310], hy[1310], 0.83),
        "S2 all-pass D = 221": lambda: sk.allpass_stream(x, h[221], 0.5),
        "S2 all-pass D = 75": lambda: sk.allpass_stream(x, h[75], 0.5),
    }


def events_ms(fn, reps: int) -> float:
    import torch

    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def graph_ms(fn) -> float:
    import torch

    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_CALLS):
            fn()
    ms = events_ms(graph.replay, 5) / GRAPH_CALLS
    del graph
    return ms


def stamped(name: str):
    """csrc/<name>.cu built alone with STAGE_STAMPS into build/, bound as
    the kernel library's <name> entry, and its stamp setter."""
    import ctypes

    from groove_tpu_torch.kernels import build

    out = build.BUILD_DIR / f"stamps_{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-DSTAGE_STAMPS", "-I",
                    str(build.CSRC), "-shared", "-o", str(out),
                    str(build.CSRC / f"{name}.cu")], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    getattr(lib, name).argtypes = build.SIGNATURES[name]
    getattr(lib, name).restype = ctypes.c_int
    lib.stage_stamps.argtypes = [ctypes.c_void_p]
    lib.stage_stamps.restype = ctypes.c_int
    return lib


def _median(v) -> float:
    return float(statistics.median(v)) if len(v) else float("nan")


def stage_times(dev) -> list:
    """Stage timings of the 3-minute S1 and S2 calls (see --stages)."""
    import ctypes

    import torch

    from groove_tpu_torch.kernels import build
    from groove_tpu_torch.ops import stream_kernels as sk

    n = SIZES["3 min"]
    out = []
    for name, labels in (("scan_stream", ("S1",)), ("comb_stream", ("S2",))):
        lib = stamped(name)
        real = build.library
        build.library = lambda lib=lib: lib
        try:
            for label, fn in calls(n, dev).items():
                if not label.startswith(labels):
                    continue
                stamps = torch.zeros(8 * 4096, dtype=torch.int64,
                                     device=dev)
                assert lib.stage_stamps(ctypes.c_void_p(
                    stamps.data_ptr())) == 0
                fn()
                torch.cuda.synchronize()
                out.append({"call": label, "frames": n,
                            **_summary(name, label,
                                       stamps.view(-1, 8).cpu(), n)})
        finally:
            build.library = real
    return out


def _summary(name: str, label: str, st, n: int) -> dict:
    """What the stamps of one call say (stage_times)."""
    from groove_tpu_torch.ops import stream_kernels as sk

    if name == "scan_stream":
        streams = 3 if "per-sample" in label else 1
        p = sk.scan_plan(2, n, streams)
        st = st[:p.blocks].double()
        t0 = float(st[:, 0].min())
        rows = [st[i::2] for i in range(2)]  # ticket t: row t % 2
        handoff = [float(r[k, 3] - r[k - 1, 4]) / 1e3 for r in rows
                   for k in range(1, p.spans)]
        steps = [p.span] * (p.spans - 1) + [n // 64 - p.span * (p.spans
                                                                 - 1)]
        cyc = [float(r[k, 6]) / steps[k] for r in rows
               for k in range(p.spans)]
        return {"spans": p.spans, "span": p.span,
                "staged_us": _median((st[:, 1] - st[:, 0]) / 1e3),
                "folded_us": _median((st[:, 2] - st[:, 1]) / 1e3),
                "handoff_us": _median(handoff),
                "walk_cycles_a_step": _median(cyc),
                "walk_us": _median((st[:, 4] - st[:, 3]) / 1e3),
                "output_us": _median((st[:, 5] - st[:, 4]) / 1e3),
                "wall_us": float(st[:, 5].max() - t0) / 1e3}
    D = int(label.split("D = ")[1].split(",")[0])
    p = sk.comb_plan(2, n, D, 2 if "per-sample" in label else 1)
    st = st[:p.blocks].double()
    per = {k: _median(st[:, i] / p.tiles)
           for k, i in (("wait", 2), ("issue", 3), ("walk", 4))}
    return {"blocks": p.blocks, "tiles": p.tiles, "periods": p.periods,
            "cycles_a_tile": per,
            "walk_cycles_a_step": per["walk"] / p.periods,
            "wall_us": float(st[:, 1].max() - st[:, 0].min()) / 1e3}


def main(argv=None) -> int:
    import torch

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--stages", action="store_true",
                   help="also the 3-minute calls' stage timings")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("carried_times: no CUDA device", file=sys.stderr)
        return 1
    import groove_tpu_torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    out = []
    for size, n in SIZES.items():
        for label, fn in calls(n, dev).items():
            out.append({"size": size, "frames": n, "call": label,
                        "ms": events_ms(fn, args.reps),
                        "device_ms": graph_ms(fn)})
        torch.cuda.empty_cache()
    stages = stage_times(dev) if args.stages else None
    print(json.dumps({"package": groove_tpu_torch.__file__,
                      "device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi, "calls": out, "stages": stages}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
