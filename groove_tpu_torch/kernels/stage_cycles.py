"""Where a tile's time goes inside the stream kernel (csrc/lp24_stream.cu).

    python -m groove_tpu_torch.kernels.stage_cycles

Builds an instrumented copy of the kernel source (a clock64 stamp after
every __syncthreads(), around the next tile's fetch and around the wait
for the current one, taken by thread 0 of block 0 and summed in a device
array), runs K7 and K8 at [12, 4096] (one tile, a sliced render's
segment) and [64, 65536] (16 tiles a row), and prints one JSON line per
case: SM cycles per tile by stage (both sections summed), the kernel's
cycles and nanoseconds by the global timer, and the clock that follows
from them. The stamps cost a few hundred cycles a tile themselves. The
copy and its library go to build/groove_tpu_torch/stage_cycles/. Needs a
CUDA device and nvcc; exits non-zero without a device.
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("stage_cycles: no CUDA device", file=sys.stderr)
        return 1
    from groove_tpu_torch.kernels import build
    from groove_tpu_torch.ops import iir_kernels

    out = build.BUILD_DIR / "stage_cycles"
    out.mkdir(parents=True, exist_ok=True)
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
