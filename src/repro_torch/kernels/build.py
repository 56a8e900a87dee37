"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface and loaded with ``ctypes`` — no PyTorch
headers, so a build takes seconds.  The first call that needs a kernel
builds every source at once (one ``nvcc`` process per source, started
together) into ``_build/`` next to this file, or into
``$REPRO_TORCH_BUILD_DIR``.  A library is rebuilt when its source or flags
change (the file name carries their hash).  Nothing here runs at import.

``LAUNCHES`` counts kernel launches per kernel name; each wrapper adds one
where it launches its kernel and nowhere else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
SOURCES = ("spike_hist", "ema_scan", "flash_attention", "rmsnorm",
           "ssm_scan")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

LAUNCHES: dict[str, int] = {name: 0 for name in SOURCES}
BUILD_INFO: dict[str, object] = {}     # build seconds + ptxas report

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()

_P, _I, _I64, _D, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                        ctypes.c_double, ctypes.c_float)
_SIGNATURES = {
    "spike_hist": {
        f"spike_hist_{t}": (_P, _I64, _I64, _P, _P, _P, _P, _I, _I, _D, _P,
                            _I, _P, _I, _P, _I64, _I, _I, _I, _I, _P)
        for t in ("f64", "f32")
    },
    "ema_scan": {
        "ema_scan_f32": (_P, _P, _I64, _I64, _F, _F, _P),
        "ema_blocks_f64": (_P, _P, _P, _P, _I64, _I64, _I64, _P, _P, _I, _P,
                           _P, _P, _D, _D, _P),
    },
    "flash_attention": {
        f"flash_attention_{t}": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                 *(_I64,) * 12, _I, _P)
        for t in ("bf16", "f32")
    },
    "rmsnorm": {
        f"rmsnorm_{x}_{s}": (_P, _P, _P, _I64, _I, _F, _I, _I, _P)
        for x in ("f32", "bf16") for s in ("f32", "bf16")
    },
    "ssm_scan": {
        f"ssm_scan_{x}_{d}": (*(_P,) * 9, _I, _I, _I, _I, _P)
        for x in ("f32", "bf16") for d in ("f32", "bf16")
    },
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def build_dir() -> str:
    return os.environ.get("REPRO_TORCH_BUILD_DIR",
                          os.path.join(os.path.dirname(
                              os.path.abspath(__file__)), "_build"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the repro_torch CUDA kernels")


def _lib_path(name: str) -> str:
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(build_dir(), f"{name}-{digest.hexdigest()[:16]}.so")


def build_all() -> dict[str, str]:
    """Compile every source that is not built yet, all in parallel; returns
    name -> library path.  Raises with nvcc's output if a build fails."""
    out = build_dir()
    os.makedirs(out, exist_ok=True)
    paths = {name: _lib_path(name) for name in SOURCES}
    todo = {n: p for n, p in paths.items() if not os.path.exists(p)}
    if not todo:
        return paths
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name, path in todo.items():
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path)
    failed = []
    for name, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        BUILD_INFO[f"{name}_ptxas"] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, path)
    BUILD_INFO["seconds"] = time.perf_counter() - t0
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library for kernel source ``name`` (built on first
    use)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            paths = build_all()
            lib = ctypes.CDLL(paths[name])
            for fn, argtypes in _SIGNATURES[name].items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
    return _libs[name]


def check(status: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{what} launch failed with CUDA error {status}")
