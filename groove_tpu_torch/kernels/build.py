"""Build and bind the CUDA kernels of groove_tpu_torch/csrc.

`nvcc` compiles every csrc/*.cu into one shared library with a plain C
interface, for sm_90a (Hopper), loaded with ctypes. The build happens at
first use, into build/groove_tpu_torch/ at the repository root, and is
cached by a hash of the sources and flags. -fmad=false keeps multiplies
and adds separately rounded, as in the plain torch twins, so the kernels
can be held to them bitwise.

    python -m groove_tpu_torch.kernels.build   # build now, print ptxas
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "groove_tpu_torch"
DEFAULT_CUDA_HOME = "/usr/local/cuda"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
# C entry points: name -> argtypes (every entry returns cudaGetLastError())
SIGNATURES = {
    "lp24_cascade": [_I] + [_P] * 15 + [_I, _I64, _I64, _I, _I, _P],
    "drums_accumulate": [_P, _I] + [_P] * 6 + [_I, _I, _I, _P, _I64, _P],
}

_lib = None


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


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
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libgroove_kernels_{h.hexdigest()[:16]}.so"


def build() -> dict:
    """Compile unless the hashed library exists. Returns {"path",
    "seconds", "log"} (log: nvcc's output, ptxas register counts
    included; empty when cached)."""
    out = library_path()
    if out.exists():
        return {"path": str(out), "seconds": 0.0, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return {"path": str(out), "seconds": seconds, "log": log}


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build()["path"])
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


if __name__ == "__main__":
    info = build()
    print(info["log"])
    print(f"{info['path']} ({info['seconds']:.1f} s)")
