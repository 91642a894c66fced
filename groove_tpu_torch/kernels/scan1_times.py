"""scan1's time on the card at the calls the kitchen-sink analogue makes.

    python -m groove_tpu_torch.kernels.scan1_times

Times whichever groove_tpu_torch is imported. Run as a file with
PYTHONPATH set to another checkout of the port (an earlier commit
unpacked by `git archive`, say), it times that checkout's scan1 on the
same inputs, built into that checkout's own build directory:

    PYTHONPATH=<checkout> python groove_tpu_torch/kernels/scan1_times.py

The calls (numpy seed 0, the analogue's shapes and layouts): the
compressor's follower on the time axis [2, n] (linear with a per-sample
a, one row read by both, and b = 1 - a; linear with numbers; max_decay
with a number r and with a per-sample r), the reverb's all-pass (D = 75,
a = 0.7) and its longest comb (D = 1927, a per-sample gain read through
the block view) in block space, at n = 441,024 (10 s) and 7,938,048
(3 minutes). One JSON line per call: ms (median of 20 whole wrapper
calls, CUDA events), device_ms (a captured CUDA graph of 20 calls,
replayed 5 times: the median over 20), the wrapper's launches, and at
10 s whether the kernel equals the twin bit for bit. The first line
names the card and its power limit (nvidia-smi) and the package timed.

    python -m groove_tpu_torch.kernels.scan1_times --timeline

builds csrc/scan1.cu with its timeline stamps (SCAN1_STAMPS, and a setter
for the stamps' array: thread 0 of
each block reads the global timer at its start, when its chunks are
scanned, when the carry is in hand, when its carry-out is published and
when it is done) into build/groove_tpu_torch/scan1_timeline/ and prints,
for the same calls at 3 minutes and the follower at 10 s, the kernel's
span from the first block's start to the last block's end and the
medians (and 90th percentiles) of each stage over the blocks: scanning
(start to scanned), waiting for the carry, folding and publishing, the
second scan that writes y, and a hand-over (a span's carry published to
the next span's carry in hand); `carry_at_last_span_us` is when the
lane's last span had its carry; `cycles`: the medians over the blocks of
thread 0's SM cycles waiting for tiles, walking them, draining them,
folding and issuing the copies. Needs a CUDA device; exits non-zero
without one.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys

SIZES = (("10 s", 441024), ("3 min", 7938048))
GRAPH_CALLS = 20


def calls(n: int, device) -> list:
    """(label, x, a, b, axis, mode): scan1's arguments in order."""
    import numpy as np
    import torch

    from groove_tpu_torch.ops.scan_kernels import LINEAR, MAX_DECAY

    rng = np.random.default_rng(0)

    def on(a):
        return torch.from_numpy(a.astype(np.float32)).to(device)

    x = on(np.abs(rng.standard_normal((2, n))) * 0.3)
    a_ps = on(rng.uniform(0.99, 0.99999, n))
    r_ps = on(rng.uniform(0.9999, 0.99999, n))

    def block(d: int):
        nb = -(-n // d)
        return torch.nn.functional.pad(x, (0, nb * d - n)).reshape(2, nb, d)

    comb = block(1927)
    gb = on(rng.uniform(0.5, 0.9, comb.shape[1:]))
    one = np.float32(1.0)
    return [
        ("linear, per-sample a and b", x, a_ps, 1.0 - a_ps, -1, LINEAR),
        ("linear, number a and b", x, np.float32(0.999),
         one - np.float32(0.999), -1, LINEAR),
        ("max_decay, number r", x, np.float32(0.9999), 1.0, -1, MAX_DECAY),
        ("max_decay, per-sample r", x, r_ps, 1.0, -1, MAX_DECAY),
        ("linear, block space D = 75", block(75), 0.7, 1.0, -2, LINEAR),
        ("linear, block space D = 1927, per-sample a", comb, gb, 1.0, -2,
         LINEAR),
    ]


def cuda_ms(fn, reps: int) -> float:
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

    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(GRAPH_CALLS):
            fn()
    ms = cuda_ms(g.replay, 5) / GRAPH_CALLS
    del g
    return ms


def timeline_library():
    """csrc/scan1.cu built alone with its stamps, bound as the kernel
    library (scan1 and scan1_init) plus scan1_stamps."""
    from groove_tpu_torch.kernels import build
    from groove_tpu_torch.ops.scan_kernels import STAGE_BYTES

    out = build.BUILD_DIR / "scan1_timeline"
    out.mkdir(parents=True, exist_ok=True)
    src, so = out / "scan1_stamps.cu", out / "scan1_stamps.so"
    src.write_text(
        '#define SCAN1_STAMPS\n#include "scan1.cu"\n'
        '__global__ void set_stamps(long long* p) {\n'
        '  g_scan1_stamps = p;\n}\n'
        'extern "C" int scan1_stamps(void* p) {\n'
        '  set_stamps<<<1, 1>>>(static_cast<long long*>(p));\n'
        '  return (int)cudaDeviceSynchronize();\n}\n')
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
                    "-shared", "-o", str(so), str(src)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    for name in ("scan1", "scan1_init"):
        getattr(lib, name).argtypes = build.SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    lib.scan1_stamps.argtypes = [ctypes.c_void_p]
    lib.scan1_stamps.restype = ctypes.c_int
    err = lib.scan1_init(STAGE_BYTES)
    if err:
        raise RuntimeError(f"scan1_init failed: CUDA error {err}")
    return lib


def timeline(lib, call) -> dict:
    """One call's stages over its blocks, from the stamps (microseconds)."""
    import numpy as np
    import torch

    from groove_tpu_torch.ops import scan_kernels as sk

    x, a, b, axis, mode = call
    rsd = sk._canonical(x.shape, axis)
    streams = 1 + torch.is_tensor(a) + (mode == sk.LINEAR
                                        and torch.is_tensor(b))
    p = sk.plan(*rsd, streams)
    stamps = torch.zeros(p.blocks * 16, dtype=torch.int64, device=x.device)
    err = lib.scan1_stamps(ctypes.c_void_p(stamps.data_ptr()))
    if err:
        raise RuntimeError(f"scan1_stamps failed: CUDA error {err}")
    sk.scan1(x, a, b, axis=axis, mode=mode)  # warm
    stamps.zero_()
    sk.scan1(x, a, b, axis=axis, mode=mode)
    torch.cuda.synchronize()
    all_ = stamps.view(p.blocks, 16).cpu().numpy().astype(np.float64)
    st, cycles = all_[:, :5], all_[:, 8:13]
    st = (st - st[:, 0].min()) / 1e3
    groups = p.blocks // p.spans

    def stat(v) -> list:
        return [float(np.median(v)), float(np.percentile(v, 90))]

    later = np.arange(groups, p.blocks)  # tickets with a previous span
    return {
        "plan": {"layout": p.layout, "chunk": p.chunk, "spans": p.spans,
                 "blocks": p.blocks, "threads": p.threads,
                 "stages": p.stages},
        "kernel_us": float(st[:, 4].max()),
        "last_start_us": float(st[:, 0].max()),
        "scan_us": stat(st[:, 1] - st[:, 0]),
        "wait_us": stat(st[:, 2] - st[:, 1]),
        "fold_us": stat(st[:, 3] - st[:, 2]),
        "write_us": stat(st[:, 4] - st[:, 3]),
        "handover_us": (stat(st[later, 2] - st[later - groups, 3])
                        if len(later) else None),
        "carry_at_last_span_us": float(st[-groups:, 2].max()),
        "cycles": {k: float(np.median(cycles[:, i])) for i, k in enumerate(
            ("tile_wait", "walk", "drain", "fold", "issue"))},
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("scan1_times: no CUDA device", file=sys.stderr)
        return 1
    import groove_tpu_torch
    from groove_tpu_torch.ops import scan_kernels

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"package": groove_tpu_torch.__file__,
                      "device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi}), flush=True)
    dev = torch.device("cuda", 0)
    if "--timeline" in sys.argv[1:]:
        from groove_tpu_torch.kernels import build

        build._lib = timeline_library()
        for size, n in SIZES:
            for label, *call in calls(n, dev):
                if size == "10 s" and not label.startswith("linear, per"):
                    continue
                print(json.dumps({"size": size, "call": label,
                                  **timeline(build._lib, call)}), flush=True)
        return 0
    for size, n in SIZES:
        for label, *call in calls(n, dev):
            def fn(c=call):
                return scan_kernels.scan1(*c[:3], axis=c[3], mode=c[4])

            before = scan_kernels.LAUNCHES["scan1"]
            y = fn()
            torch.cuda.synchronize()
            row = {"size": size, "call": label, "shape": list(call[0].shape),
                   "launches": scan_kernels.LAUNCHES["scan1"] - before,
                   "ms": cuda_ms(fn, 20), "device_ms": graph_ms(fn)}
            if n == SIZES[0][1]:
                row["equals_twin"] = bool(torch.equal(
                    y, scan_kernels.scan1_plain(*call[:3], axis=call[3],
                                                mode=call[4])))
            print(json.dumps(row), flush=True)
            del y
    return 0


if __name__ == "__main__":
    sys.exit(main())
