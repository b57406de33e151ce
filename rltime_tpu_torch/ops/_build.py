"""Build and load the port's CUDA kernels (nvcc + ctypes, no torch headers).

Every `rltime_tpu_torch/csrc/*.cu` is compiled with nvcc for Hopper
(`sm_90a`) into its own shared library with a plain C interface, at
first use, under `build/rltime_tpu_torch/<key>/` at the repository
root. `<key>` is a hash of all the sources and the flags, so an edit to
any source rebuilds them all. The nvcc processes of one build run
together, one per source. `load(name)` returns the loaded library of
`csrc/<name>.cu`. A missing nvcc or a failed build raises: there is no
fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "rltime_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_PTR, _I64 = ctypes.c_void_p, ctypes.c_int64
# Library (source stem) -> C entry point -> argument types. Every entry
# point returns a cudaError_t (0 on success).
ENTRY_POINTS = {
    # (out_t, out_tn, storage, done, env, col, B, F, n, lead, T,
    #  row_bytes, stream)
    "union_gather": {"union_stack_gather": [
        _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _I64, _I64, _I64, _I64, _I64,
        _I64, _PTR]},
    # (segments, num, env, col, B, stream)
    "window_gather": {"window_gather_multi": [
        _PTR, _I64, _PTR, _PTR, _I64, _PTR]},
}

_libs: Dict[str, ctypes.CDLL] = {}


def sources() -> Dict[str, Path]:
    """Kernel name (file stem) -> source path, for every csrc/*.cu."""
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = os.path.join(home, "bin", "nvcc")
        nvcc = cand if os.path.isfile(cand) else None
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
            "the port's CUDA kernels cannot be built")
    return nvcc


def build_dir(srcs: Dict[str, Path]) -> Path:
    """Where the libraries for these sources and the flags live."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name, path in srcs.items():
        h.update(name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / h.hexdigest()[:16]


def build() -> Dict[str, Path]:
    """Compile every kernel library that is not built yet, all nvcc
    processes at once. Returns name -> library path."""
    srcs = sources()
    out = build_dir(srcs)
    libs = {name: out / f"{name}.so" for name in srcs}
    todo = [name for name, path in libs.items() if not path.exists()]
    if not todo:
        return libs
    nvcc = _find_nvcc()
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        tmp = out / f"{name}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(srcs[name])]
        procs[name] = (tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    errors = []
    for name, (tmp, cmd, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed ({proc.returncode}): "
                          f"{' '.join(cmd)}\n{log}")
        else:
            # atomic: a concurrent build never sees a partial file
            os.replace(tmp, libs[name])
    if errors:
        raise RuntimeError("\n".join(errors))
    return libs


def load(name: str) -> ctypes.CDLL:
    """Build if needed, then load `csrc/<name>.cu`'s library once per
    process."""
    if name not in _libs:
        path = build()[name]
        lib = ctypes.CDLL(str(path))
        for entry, argtypes in ENTRY_POINTS[name].items():
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _libs[name] = lib
    return _libs[name]
