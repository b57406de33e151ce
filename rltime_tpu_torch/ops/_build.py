"""Build and load the port's CUDA kernels (nvcc + ctypes, no torch headers).

`load()` compiles `rltime_tpu_torch/csrc/union_gather.cu` with nvcc for
Hopper (`sm_90a`) into a shared library with a plain C interface, at
first use, under `build/rltime_tpu_torch/` at the repository root, named
by a hash of the source and flags, and loads it with ctypes. A missing
nvcc raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "union_gather.cu"
BUILD_DIR = _PKG.parent / "build" / "rltime_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lib = None


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = os.path.join(home, "bin", "nvcc")
        nvcc = cand if os.path.isfile(cand) else None
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
            "the union-gather CUDA kernel cannot be built")
    return nvcc


def library_path() -> Path:
    """Where the built library for the current source and flags lives."""
    key = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"union_gather_{key}.so"


def build() -> Path:
    """Compile the kernel library unless it is already built."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [_find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)   # atomic: concurrent builders never see a partial file
    return so


def load() -> ctypes.CDLL:
    """Build if needed, then load once per process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.union_gather.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
        lib.union_gather.restype = ctypes.c_int
        _lib = lib
    return _lib
