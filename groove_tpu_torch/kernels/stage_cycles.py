"""Where the cycles go inside the kernels that run from shared memory: the
stream kernel (csrc/lp24_stream.cu), the chain walker (csrc/tdf2.cuh) and
the tiled scans of K4, K5, K2, K3 and static K6 (csrc/tiled.cuh).

    python -m groove_tpu_torch.kernels.stage_cycles

Builds instrumented copies of the sources (clock64 stamps taken by one
thread of block 0 and summed in a device array) and prints one JSON line
per case.
  Stream kernel: a stamp after every __syncthreads(), around the next
    tile's fetch and around the wait for the current one; K7 and K8 at
    [12, 4096] (one tile, a sliced render's segment) and [64, 65536] (16
    tiles a row): SM cycles per tile by stage (both sections summed), the
    kernel's cycles and nanoseconds by the global timer, and the clock
    that follows from them.
  Chain floor: one thread's cycles per chain step from registers only,
    and walking a stage resident in shared memory with nobody else about.
  Chain walker: stamps around the walker's wait for a stage, its walk and
    its hand-back; cycles per chain step (walking, waiting, whole chain)
    of row 0, summed over the chains of one K4 or K5 call (one chain), one
    K2 call (four) and one K3 or K6 call (two) at [2, 441024],
    [2, 7938048] and [64, 65536].
  Tiled scans: a stamp after every __syncthreads() and at the end of each
    kernel; the cycles of tile 0's stages (fill, scans, drain) in the same
    calls.
The stamps cost a few hundred cycles a tile themselves. The copies and
their libraries go to build/groove_tpu_torch/stage_cycles/. Needs a CUDA
device and nvcc; exits non-zero without a device.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys

STAGES = ("wait_for_tile", "phase1", "chain", "combine", "defect",
          "correction_scan", "correction_chain", "second_combine",
          "fetch_start", "fetch_wait")
N_SLOTS = 16  # stage sums, then [14] kernel cycles and [15] nanoseconds
CASES = ((12, 4096), (64, 65536))

_STAMP = """
__device__ long long g_prof[16];
#define STAMP(k)                                      \\
  do {                                                \\
    if (threadIdx.x == 0 && blockIdx.x == 0) {        \\
      long long now = clock64();                      \\
      g_prof[k] += now - last;                        \\
      last = now;                                     \\
    }                                                 \\
  } while (0)
"""
_READ = """
extern "C" int prof_read(long long* out, int reset) {
  cudaDeviceSynchronize();
  cudaMemcpyFromSymbol(out, g_prof, sizeof(long long) * 16);
  if (reset) {
    long long zero[16] = {};
    cudaMemcpyToSymbol(g_prof, zero, sizeof(zero));
  }
  return (int)cudaGetLastError();
}
"""
_BEGIN = """  long long last = clock64(), c0 = last;
  unsigned long long g0;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(g0));
"""
_END = """  if (threadIdx.x == 0 && blockIdx.x == 0) {
    unsigned long long g1;
    asm volatile("mov.u64 %0, %globaltimer;" : "=l"(g1));
    g_prof[14] += clock64() - c0;
    g_prof[15] += (long long)(g1 - g0);
  }
"""


def instrument(source: str) -> str:
    """The kernel source with stamps: slots 0-7 after the kernel's eight
    __syncthreads() in order, 8 after the next tile's fetch is started, 9
    after the wait for the current tile's group."""
    head, body = source.split("template <bool kRefined>\n__global__", 1)
    kern, rest = body.split("__global__ void empty_kernel", 1)
    count = [0]

    def stamp(match):
        count[0] += 1
        return f"{match.group(0)} STAMP({count[0] - 1});"

    kern = re.sub(r"__syncthreads\(\);", stamp, kern)
    if count[0] != 8:
        raise RuntimeError(f"expected 8 barriers in the kernel, found "
                           f"{count[0]}: bring STAGES up to date")
    first = "  fetch(xr, den, row, n, 0, smem, coef);\n"
    nxt = "      fetch(xr, den, row, n, t + 1, smem, coef);\n"
    wait = "      cp_async_wait<1>();\n"
    last = "  if (tid < kRows) state_out[row * kRows + tid] = st[tid];\n"
    for anchor in (first, nxt, wait, last):
        if kern.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once: {anchor!r}")
    kern = kern.replace(first, _BEGIN + first)
    kern = kern.replace(nxt, nxt.rstrip("\n") + " STAMP(8);\n")
    kern = kern.replace(wait, wait.rstrip("\n") + " STAMP(9);\n")
    kern = kern.replace(last, _END + last)
    return (head + _STAMP + "template <bool kRefined>\n__global__" + kern
            + "__global__ void empty_kernel" + rest + _READ)


# ---------------------------------------------------------------------------
# The chain walker and the tiled scans

CHAIN_STAGES = ("wait", "walk", "hand_back", "chain")
TILED_STAGES = (
    "maps.fill", "maps.scan",
    "combine.fill", "combine.scan", "combine.drain",
    "defect_scan.fill", "defect_scan.edges", "defect_scan.scan",
    "refine_next.fill", "refine_next.edges", "refine_next.scan",
    "refine_next.drain",
    "refine_last.fill", "refine_last.edges", "refine_last.scan",
    "refine_last.drain",
    # K3 and K6: section A's combine with section B's phase 1
    "combine_next.fill", "combine_next.scan", "combine_next.drain")
# first slot of each tiled kernel, and how many barriers its body holds
_TILED_KERNELS = (("maps_kernel", "0", 1),
                  ("combine_kernel", "(kNext ? 16 : 2)", 2),
                  ("defect_scan_kernel", "5", 2),
                  ("refine_kernel", "(kNext ? 8 : 12)", 3))
TILED_CASES = ((2, 441024), (2, 7938048), (64, 65536))

_CHAIN_DECL = """
static __device__ unsigned long long g_chain[4];
#define CSTAMP(k)                        \\
  do {                                   \\
    if (blockIdx.x == 0) {               \\
      long long now = clock64();         \\
      atomicAdd(&g_chain[k], (unsigned long long)(now - last)); \\
      last = now;                        \\
    }                                    \\
  } while (0)
"""
_TILED_DECL = f"""
static __device__ long long g_tile[{len(TILED_STAGES)}];
#define TSTAMP(k)                                     \\
  do {{                                                \\
    if (threadIdx.x == 0 && blockIdx.x == 0) {{        \\
      long long now = clock64();                      \\
      g_tile[k] += now - last;                        \\
      last = now;                                     \\
    }}                                                 \\
  }} while (0)
"""
_TILED_READ = """
extern "C" int NAME(long long* chain, long long* tile, int reset) {
  cudaDeviceSynchronize();
  cudaMemcpyFromSymbol(chain, tdf2::g_chain, sizeof(long long) * 4);
  cudaMemcpyFromSymbol(tile, tiled::g_tile, sizeof(tiled::g_tile));
  if (reset) {
    long long zero[32] = {};
    cudaMemcpyToSymbol(tdf2::g_chain, zero, sizeof(long long) * 4);
    cudaMemcpyToSymbol(tiled::g_tile, zero, sizeof(tiled::g_tile));
  }
  return (int)cudaGetLastError();
}
"""


def _once(text: str, anchor: str, new: str) -> str:
    if text.count(anchor) != 1:
        raise RuntimeError(f"anchor not found once: {anchor!r}")
    return text.replace(anchor, new)


def instrument_chain(source: str) -> str:
    """csrc/tdf2.cuh with the walker stamped: slot 0 the waits for a
    filled stage, 1 the walks, 2 the hand-backs, 3 the whole chain (row 0
    only)."""
    text = _once(source, "struct __align__(16) ChainStage {",
                 _CHAIN_DECL + "struct __align__(16) ChainStage {")
    text = _once(text, "    for (int t = 0; t < ntiles; ++t) {\n"
                 "      const int b = t % kChainStages, use = t / "
                 "kChainStages;\n      mbar_wait<false>(&full[b], use & 1);\n",
                 "    long long last = clock64(), c0 = last;\n"
                 "    for (int t = 0; t < ntiles; ++t) {\n"
                 "      const int b = t % kChainStages, use = t / "
                 "kChainStages;\n      mbar_wait<false>(&full[b], use & 1);"
                 " CSTAMP(0);\n")
    walk = ("      chain_walk(stage[b], min(kChainTile, steps - t * "
            "kChainTile), s1, s2);\n")
    text = _once(text, walk, walk.rstrip("\n") + " CSTAMP(1);\n")
    back = "      mbar_arrive(&empty[b]);\n    }\n"
    return _once(text, back,
                 "      mbar_arrive(&empty[b]); CSTAMP(2);\n    }\n"
                 "    if (blockIdx.x == 0)\n"
                 "      atomicAdd(&g_chain[3],\n"
                 "                (unsigned long long)(clock64() - c0));\n")


def instrument_tiled(source: str) -> str:
    """csrc/tiled.cuh with each kernel stamped after every barrier and at
    its end (TILED_STAGES; thread 0 of block 0, so tile 0 of row 0)."""
    text = _once(source, "// Phase 1 of one section: the block maps",
                 _TILED_DECL + "// Phase 1 of one section: the block maps")
    for name, base, barriers in _TILED_KERNELS:
        start = text.index(f"    {name}(")
        end = text.index("\n}\n", start)
        body = text[start:end]
        body = _once(body, "  extern __shared__ __align__(16) float tile[];\n",
                     "  extern __shared__ __align__(16) float tile[];\n"
                     "  long long last = clock64();\n")
        if body.count("__syncthreads();") != barriers:
            raise RuntimeError(f"{name}: expected {barriers} barriers: bring "
                               "TILED_STAGES up to date")
        for i in range(barriers):
            body = body.replace("__syncthreads();\n",
                                f"__syncthreads(); TSTAMP({base} + {i});\r", 1)
        body = body.replace("\r", "\n")
        text = (text[:start] + body + f"\n  TSTAMP({base} + {barriers});"
                + text[end:])
    return text


def build_tiled_profile(out):
    """Instrumented copies of tdf2.cuh, tiled.cuh, biquad.cu and lp24.cu in
    `out`, compiled into one library with a reader per source."""
    from groove_tpu_torch.kernels import build

    (out / "tdf2.cuh").write_text(
        instrument_chain((build.CSRC / "tdf2.cuh").read_text()))
    (out / "tiled.cuh").write_text(
        instrument_tiled((build.CSRC / "tiled.cuh").read_text()))
    for src, reader in (("biquad.cu", "prof_read_biquad"),
                        ("lp24.cu", "prof_read_lp24")):
        (out / src).write_text((build.CSRC / src).read_text()
                               + _TILED_READ.replace("NAME", reader))
    subprocess.run(
        [build.nvcc(), *build.NVCC_FLAGS, "-I", str(out), "-shared", "-o",
         str(out / "tiled_prof.so"), str(out / "biquad.cu"),
         str(out / "lp24.cu")], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out / "tiled_prof.so"))
    for name in ("biquad_tiled", "lp24_refined_tiled", "lp24_tiled"):
        getattr(lib, name).argtypes = build.SIGNATURES[name]
    for name in ("prof_read_biquad", "prof_read_lp24"):
        getattr(lib, name).argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_int]
    return lib


def tiled_cycles(lib, kernel: str, rows: int, n: int) -> dict:
    """One instrumented K4, K5, K2, K3 or static K6 call at [rows, n] (the
    last of three): the walker's cycles per chain step and tile 0's cycles
    by stage."""
    import torch

    from groove_tpu_torch.ops import iir_kernels

    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    x = (torch.randn(rows, n, generator=gen) * 0.1).to(dev)
    ln = iir_kernels.geometry(n, blockrate=kernel not in ("K5", "K6"))[0]
    count = -(-n // 64)
    lp24 = (-1.9, 0.95, -1.8, 0.9)  # a1a, a2a, a1b, a2b
    if kernel in ("K4", "K5"):  # b0, b1, b2, a1, a2: block mode, by value
        values, outputs, pairs, carries = (0.3, 0.6, 0.3, -1.9, 0.95), 1, 2, 0
        read, chains = lib.prof_read_biquad, 1
        if kernel == "K4":
            entry = lambda x, *a: lib.biquad_tiled(  # noqa: E731
                iir_kernels.BLOCK, x, *a[:7], *[0.0] * 5, *a[7:])
        else:
            entry = lambda x, *a: lib.biquad_tiled(  # noqa: E731
                iir_kernels.SCALAR, x, *[None] * 6, 1, *values, *a[7:])
    elif kernel == "K2":
        values, outputs, pairs, carries = lp24, 2, 5, 4
        entry, read, chains = (lib.lp24_refined_tiled, lib.prof_read_lp24, 4)
    else:  # K3 (block mode) and K6 (static, by value): lp24_tiled
        values, outputs, pairs, carries = lp24, 2, 2, 2
        read, chains = lib.prof_read_lp24, 2
        if kernel == "K3":
            entry = lambda x, *a: lib.lp24_tiled(  # noqa: E731
                iir_kernels.BLOCK, x, *a[:6], 0.0, 0.0, 0.0, 0.0, *a[6:])
        else:
            entry = lambda x, *a: lib.lp24_tiled(  # noqa: E731
                iir_kernels.SCALAR, x, None, None, None, None, None, 1,
                *lp24, *a[6:])
    co = [torch.full((rows, count), v, device=dev) for v in values]
    outs, _scratch, ptrs = iir_kernels.tiled_buffers(x, ln, outputs, pairs,
                                                    carries)
    chain = (ctypes.c_longlong * 4)()
    tile = (ctypes.c_longlong * len(TILED_STAGES))()
    for _ in range(3):
        read(chain, tile, 1)
        err = entry(x.data_ptr(), *(c.data_ptr() for c in co),
                    iir_kernels.strides_of(co), count,
                    *(o.data_ptr() for o in outs), *ptrs, rows, n, ln, 0)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        read(chain, tile, 0)
    steps = chains * -(-n // ln)
    return {"kernel": kernel, "shape": [rows, n],
            "device": torch.cuda.get_device_name(0), "chains": chains,
            "steps_per_chain": steps // chains,
            "cycles_per_chain_step": {
                name: chain[i] / steps for i, name in enumerate(CHAIN_STAGES)},
            "tile_cycles": {name: tile[i]
                            for i, name in enumerate(TILED_STAGES) if tile[i]}}


# The walker's floor: one thread's chain steps with nothing in their way.
_FLOOR = r"""
#include "tdf2.cuh"
using namespace tdf2;

// out[0]: cycles of `n` chain steps whose map and offset stay in registers;
// out[1]: cycles of `reps` walks of a stage that is resident in shared
// memory (chain_walk: loads and kept states, no barrier, no mover).
__global__ void floor_kernel(const float* in, float* sink, long long* out,
                             int n, int reps, int cnt) {
  __shared__ ChainStage st;
  for (int i = threadIdx.x; i < kChainTile; i += blockDim.x) {
    st.m[i] = make_float4(in[0], in[1], in[2], in[3]);
    st.c[i] = make_float2(in[4], in[5]);
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  const float4 m = make_float4(in[0], in[1], in[2], in[3]);
  const float c1 = in[4], c2 = in[5];
  float s1 = in[6], s2 = in[7];
  long long t0 = clock64();
#pragma unroll 16
  for (int i = 0; i < n; ++i) chain_step(m, c1, c2, s1, s2);
  long long t1 = clock64();
  for (int r = 0; r < reps; ++r) chain_walk(st, cnt, s1, s2);
  long long t2 = clock64();
  sink[0] = s1 + s2 + st.keep[1].x;
  out[0] = t1 - t0;
  out[1] = t2 - t1;
}

extern "C" int chain_floor(double* per_step) {
  const float h[8] = {0.9f, -0.1f, 0.1f, 0.8f, 0.01f, 0.02f, 0.3f, 0.2f};
  const int n = 1 << 16, reps = 64;
  float *in, *sink;
  long long *out, cycles[2];
  cudaMalloc(&in, sizeof(h));
  cudaMalloc(&sink, sizeof(float));
  cudaMalloc(&out, sizeof(cycles));
  cudaMemcpy(in, h, sizeof(h), cudaMemcpyHostToDevice);
  for (int warm = 0; warm < 2; ++warm)
    floor_kernel<<<1, 64>>>(in, sink, out, n, reps, kChainTile);
  cudaMemcpy(cycles, out, sizeof(cycles), cudaMemcpyDeviceToHost);
  cudaFree(in);
  cudaFree(sink);
  cudaFree(out);
  per_step[0] = (double)cycles[0] / n;
  per_step[1] = (double)cycles[1] / ((double)reps * kChainTile);
  return (int)cudaGetLastError();
}
"""


def chain_floor(out) -> dict:
    """Cycles per chain step of one thread with nothing in its way: from
    registers only (the arithmetic's floor on this card) and walking a
    stage that is resident in shared memory (csrc/tdf2.cuh's chain_walk
    without barriers or movers)."""
    import torch

    from groove_tpu_torch.kernels import build

    (out / "floor.cu").write_text(_FLOOR)
    subprocess.run(
        [build.nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-shared",
         "-o", str(out / "floor.so"), str(out / "floor.cu")],
        check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out / "floor.so"))
    lib.chain_floor.argtypes = [ctypes.c_void_p]
    per_step = (ctypes.c_double * 2)()
    err = lib.chain_floor(per_step)
    if err:
        raise RuntimeError(f"chain_floor failed: CUDA error {err}")
    return {"kernel": "chain_floor",
            "device": torch.cuda.get_device_name(0),
            "cycles_per_step_from_registers": per_step[0],
            "cycles_per_step_resident_stage": per_step[1]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("stage_cycles: no CUDA device", file=sys.stderr)
        return 1
    from groove_tpu_torch.kernels import build
    from groove_tpu_torch.ops import iir_kernels

    out = build.BUILD_DIR / "stage_cycles"
    out.mkdir(parents=True, exist_ok=True)
    print(json.dumps(chain_floor(out)), flush=True)
    tiled = build_tiled_profile(out)
    for kernel in ("K4", "K5", "K2", "K3", "K6"):
        for rows, n in TILED_CASES:
            print(json.dumps(tiled_cycles(tiled, kernel, rows, n)),
                  flush=True)
    (out / "prof.cu").write_text(
        instrument((build.CSRC / "lp24_stream.cu").read_text()))
    subprocess.run(
        [build.nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-shared",
         "-o", str(out / "prof.so"), str(out / "prof.cu")],
        check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out / "prof.so"))
    lib.lp24_stream.argtypes = build.SIGNATURES["lp24_stream"]
    lib.lp24_stream_init.argtypes = build.SIGNATURES["lp24_stream_init"]
    lib.prof_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    err = lib.lp24_stream_init(iir_kernels.stream_smem_bytes(False),
                               iir_kernels.stream_smem_bytes(True))
    if err:
        raise RuntimeError(f"lp24_stream_init failed: CUDA error {err}")
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    buf = (ctypes.c_longlong * N_SLOTS)()
    for refined in (False, True):
        for rows, n in CASES:
            x = (torch.randn(rows, n, generator=gen) * 0.1).to(dev)
            den = [torch.full((rows, n // 64), v, device=dev)
                   for v in (-1.9, 0.95, -1.8, 0.9)]
            st = torch.zeros(rows, 20 if refined else 4, device=dev)
            y, st2 = torch.empty_like(x), torch.empty_like(st)
            for _ in range(3):  # the last of three calls is read
                lib.prof_read(buf, 1)
                err = lib.lp24_stream(
                    refined, x.data_ptr(), *(d.data_ptr() for d in den),
                    *(v for d in den for v in d.stride()), st.data_ptr(),
                    st2.data_ptr(), y.data_ptr(), rows, n, 0)
                if err:
                    raise RuntimeError(f"launch failed: CUDA error {err}")
                lib.prof_read(buf, 0)
            tiles = -(-n // iir_kernels.STREAM_TILE)
            print(json.dumps({
                "kernel": "K8" if refined else "K7", "shape": [rows, n],
                "device": torch.cuda.get_device_name(0), "tiles": tiles,
                "cycles_per_tile": {name: buf[i] / tiles
                                    for i, name in enumerate(STAGES)},
                "kernel_cycles": buf[14], "kernel_ns": buf[15],
                "sm_ghz": buf[14] / max(buf[15], 1)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
