"""Build and bind the CUDA kernels of groove_tpu_torch/csrc.

`nvcc` compiles every csrc/*.cu into one shared library with a plain C
interface, for sm_90a (Hopper), loaded with ctypes. The build happens at
first use, into build/groove_tpu_torch/ at the repository root: one nvcc
process per source, all started at once, then one link. The library is
cached by a hash of the sources, the shared headers (csrc/*.cuh) and the
flags. -fmad=false keeps multiplies and adds separately rounded, as in
the plain torch twins, so the kernels can be held to them bitwise.

    python -m groove_tpu_torch.kernels.build   # build now, print ptxas
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "groove_tpu_torch"
DEFAULT_CUDA_HOME = "/usr/local/cuda"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_F = ctypes.c_float
# C entry points: name -> argtypes (every entry returns cudaGetLastError())
SIGNATURES = {
    "lp24_cascade": ([_I, _I] + [_P] * 5 + [_F] * 4 + [_I64] * 3 + [_P] * 12
                     + [_I, _I64, _I64, _I, _P]),
    "lp24_refined_tiled": ([_P] * 6 + [_I64] + [_P] * 9
                           + [_I, _I64, _I, _P]),
    "lp24_tiled": ([_I] + [_P] * 6 + [_I64] + [_F] * 4 + [_P] * 6
                   + [_I, _I64, _I, _P]),
    "lp24_stream_init": [_I, _I],
    "lp24_stream": [_I] + [_P] * 5 + [_I64] * 8 + [_P] * 3 + [_I, _I64, _P],
    "launch_floor": [_P],
    "biquad_scan": ([_I] + [_P] * 6 + [_F] * 5 + [_I64] * 3 + [_P] * 7
                    + [_I, _I64, _I64, _I, _P]),
    "biquad_tiled": ([_I] + [_P] * 7 + [_I64] + [_F] * 5 + [_P] * 4
                     + [_I, _I64, _I, _P]),
    "biquad_serial_scan": ([_I] + [_P] * 6 + [_F] * 5 + [_I64] * 3 + [_P]
                           + [_I, _I64, _I64, _P]),
    "drums_accumulate": [_P, _I] + [_P] * 6 + [_I, _I, _I, _P, _I64, _P],
    "biquad_tiled_state": ([_I] + [_P] * 7 + [_I64] + [_F] * 5 + [_P] * 6
                           + [_I, _I64, _P]),
    "biquad_serial_state": ([_I] + [_P] * 6 + [_F] * 5 + [_I64] * 3 + [_P]
                            + [_I, _I64, _I64] + [_P] * 3),
    "scan_stream": ([_I, _P, _I64] + [_P, _F, _I64] * 2 + [_P] * 4
                    + [_I, _I64, _I, _P]),
    "comb_stream": ([_I, _P, _P, _F, _I64, _F, _F] + [_P] * 5
                    + [_I, _I64, _I64, _P]),
    "scan1_init": [_I],
    "scan1": ([_I, _P] + [_I64] * 3 + ([_P, _F] + [_I64] * 3) * 2
              + [_P, _P] + [_I64] * 4 + [_I] * 3 + [_P]),
}

_lib = None
_LOAD_LOCK = threading.Lock()


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def headers() -> list[Path]:
    return sorted(CSRC.glob("*.cuh"))


def nvcc() -> str:
    """The nvcc of $CUDA_HOME, /usr/local/cuda or PATH."""
    for home in (os.environ.get("CUDA_HOME"), DEFAULT_CUDA_HOME):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in [*sources(), *headers()]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libgroove_kernels_{h.hexdigest()[:16]}.so"


def build() -> dict:
    """Compile unless the hashed library exists. Returns {"path",
    "seconds", "log"} (log: nvcc's output, ptxas register counts
    included; empty when cached)."""
    out = library_path()
    if out.exists():
        return {"path": str(out), "seconds": 0.0, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in sources()]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [compiler, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(obj),
         str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for src, obj in zip(sources(), objs)]
    log = "".join(f"== {src.name}\n{proc.communicate()[0]}"
                  for src, proc in zip(sources(), procs))
    failed = [src.name for src, proc in zip(sources(), procs)
              if proc.returncode != 0]
    if not failed:
        link = subprocess.run(
            [compiler, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
             *map(str, objs)], capture_output=True, text=True)
        log += link.stdout + link.stderr
        if link.returncode != 0:
            failed.append("link")
    seconds = time.perf_counter() - t0
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(f"nvcc failed: {', '.join(failed)}\n{log}")
    os.replace(tmp, out)
    return {"path": str(out), "seconds": seconds, "log": log}


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use). Loading it allows
    the stream kernels and scan1's time-axis kernel their dynamic shared
    memory, once, so that no call has to (csrc/lp24_stream.cu
    lp24_stream_init, csrc/scan1.cu scan1_init). The first use may come
    from any thread (the engine service's worker, a web request): one
    thread builds and loads while the others wait."""
    global _lib
    if _lib is not None:
        return _lib
    with _LOAD_LOCK:
        if _lib is not None:
            return _lib
        from groove_tpu_torch.ops.iir_kernels import stream_smem_bytes
        from groove_tpu_torch.ops.scan_kernels import STAGE_BYTES

        lib = ctypes.CDLL(build()["path"])
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        err = lib.lp24_stream_init(stream_smem_bytes(False),
                                   stream_smem_bytes(True))
        if err:
            raise RuntimeError(f"lp24_stream_init failed: CUDA error {err}")
        err = lib.scan1_init(STAGE_BYTES)
        if err:
            raise RuntimeError(f"scan1_init failed: CUDA error {err}")
        _lib = lib
    return _lib


if __name__ == "__main__":
    info = build()
    print(info["log"])
    print(f"{info['path']} ({info['seconds']:.1f} s)")
