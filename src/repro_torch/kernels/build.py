"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface and loaded with ``ctypes`` — no PyTorch
headers, so a build takes seconds.  The first call that needs a kernel
builds every source at once (one ``nvcc`` process per source, started
together) into ``_build/`` next to this file, or into
``$REPRO_TORCH_BUILD_DIR``.  A library is rebuilt when its source, a header
it includes (``#include "x.cuh"`` from ``csrc/``, followed recursively) or
the flags change: the file name carries their hash.  Nothing here runs at
import.

``LAUNCHES`` counts kernel launches per kernel name (the sources' names,
and ``rmsnorm_bwd`` for the backward entry points of ``rmsnorm.cu``); each
wrapper adds one (``launched``) where it launches its kernel and nowhere
else.  ``rank_counts`` counts one thread's launches apart, for ranks that
are threads of one process.

Where a wrapper runs follows its tensors (``device_of``): on the CPU its
plain twin, on a CUDA device its kernel (or it raises), on ``meta`` neither
(the wrapper allocates the card path's outputs on meta and returns them,
for a dry run of a step that moves no data).  Each wrapper allocates its
outputs before it branches, the same on every device, and runs the launch,
the twin or nothing inside ``counted``: an active cost counter
(``repro_torch.analysis.cost.CostCounter``) skips the ops inside and
charges the call its kernel's work (``Work``) and workspace instead, so a
step counts the same on the CPU, on meta and on the card.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from typing import Callable, NamedTuple

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
SOURCES = ("spike_hist", "ema_scan", "flash_attention",
           "flash_attention_bwd", "rmsnorm", "ssm_scan", "ssm_scan_bwd")
KERNELS = SOURCES + ("rmsnorm_bwd",)
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

# the streaming multiprocessors of the card the meta and CPU counts stand
# for, an H100 SXM (``analysis.hardware.H100.sms`` states the same data
# sheet; the kernels keep their own copy and import nothing of analysis)
H100_SMS = 132

LAUNCHES: dict[str, int] = {name: 0 for name in KERNELS}
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
        f"flash_attention_{t}": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                 _I, *(_I64,) * 12, _I, _P)
        for t in ("bf16", "f32")
    },
    "flash_attention_bwd": {      # both take bwd_plan's dK/dV split
        f"flash_attention_bwd_{t}": (*(_P,) * 10, *(_I,) * 8, _P)
        for t in ("f32", "bf16")
    },
    "rmsnorm": {
        **{f"rmsnorm_{x}_{s}": (_P, _P, _P, _I64, _I, _F, _I, _I, _P)
           for x in ("f32", "bf16") for s in ("f32", "bf16")},
        **{f"rmsnorm_bwd_{x}_{s}": (*(_P,) * 7, _I64, _I, _F, _I, _I, _I64,
                                    *(_I,) * 6, _P)
           for x in ("f32", "bf16") for s in ("f32", "bf16")},
    },
    "ssm_scan": {
        f"ssm_scan_{x}_{d}": (*(_P,) * 9, _I, _I, _I, _I, _P)
        for x in ("f32", "bf16") for d in ("f32", "bf16")
    },
    "ssm_scan_bwd": {
        f"ssm_scan_bwd_{x}_{d}": (*(_P,) * 16, *(_I,) * 5, _P)
        for x in ("f32", "bf16") for d in ("f32", "bf16")
    },
}


_rank = threading.local()
_count_lock = threading.Lock()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launched(name: str) -> None:
    """Count one launch of kernel ``name``: in ``LAUNCHES`` (under a lock,
    since the ranks of a ``LocalGroup`` are threads) and, while the calling
    thread has ``rank_counts`` open, in its own counts."""
    with _count_lock:
        LAUNCHES[name] += 1
    own = getattr(_rank, "counts", None)
    if own is not None:
        own[name] += 1


@contextlib.contextmanager
def rank_counts():
    """The launches of the calling thread alone (one rank of a
    ``LocalGroup``) while the context is open, as a dict by kernel."""
    counts = {name: 0 for name in KERNELS}
    outer = getattr(_rank, "counts", None)
    _rank.counts = counts
    try:
        yield counts
    finally:
        _rank.counts = outer


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


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def sources_of(name: str) -> list[str]:
    """``<name>.cu`` and every header it includes by quotes, recursively
    (file names in ``CSRC``), the source first."""
    files, todo = [], [f"{name}.cu"]
    while todo:
        f = todo.pop(0)
        if f not in files:
            files.append(f)
            with open(os.path.join(CSRC, f)) as fh:
                todo.extend(_INCLUDE.findall(fh.read()))
    return files


def _lib_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sources_of(name):
        with open(os.path.join(CSRC, f), "rb") as fh:
            digest.update(f.encode() + b"\0" + fh.read())
    return os.path.join(build_dir(), f"{name}-{digest.hexdigest()[:16]}.so")


def nvcc_command(source: str, out: str) -> list[str]:
    """nvcc with the port's flags, compiling ``source`` (a path) into the
    shared library ``out``; ``CSRC`` is on the include path, so a copy of a
    source elsewhere finds its headers."""
    return [_nvcc(), *NVCC_FLAGS, "-I", CSRC, "-o", out, source]


def build_all() -> dict[str, str]:
    """Compile every source that is not built yet, all in parallel; returns
    name -> library path.  Raises with nvcc's output if a build fails."""
    out = build_dir()
    os.makedirs(out, exist_ok=True)
    paths = {name: _lib_path(name) for name in SOURCES}
    todo = {n: p for n, p in paths.items() if not os.path.exists(p)}
    if not todo:
        return paths
    # wall time of the build itself (BUILD_INFO), never in a kernel's output
    t0 = time.perf_counter()  # minoslint: disable=W301
    procs = {}
    for name, path in todo.items():
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = nvcc_command(os.path.join(CSRC, f"{name}.cu"), tmp)
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
    # (the build's wall time again: a report, not an output)
    BUILD_INFO["seconds"] = time.perf_counter() - t0  # minoslint: disable=W301
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


def wants_grad(*ts) -> bool:
    """Grad mode is on and one of ``ts`` (tensors or None) requires grad."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


def device_of(what: str, ts) -> str:
    """Where a kernel call on tensors ``ts`` runs: ``"cpu"`` (the plain
    twin), ``"cuda"`` (the kernel, on one CUDA device) or ``"meta"`` (no
    launch).  Raises for tensors on several devices or on any other, and
    for CUDA or meta inputs that want a gradient: a kernel's output has no
    ``grad_fn`` and would cut the graph (``ops`` routes those through the
    kernels' ``autograd.Function``s)."""
    devices = {t.device for t in ts}
    kind = next(iter(devices)).type if len(devices) == 1 else None
    if kind == "cpu":
        return kind
    if kind not in ("cuda", "meta"):
        raise ValueError(f"{what} runs on cuda, cpu or meta with every "
                         f"tensor on one device, not "
                         f"{sorted(map(str, devices))}")
    if wants_grad(*ts):
        raise RuntimeError(f"{what}: an input requires grad, and the "
                           f"kernel's output would cut the graph; call it "
                           f"through repro_torch.kernels.ops")
    return kind


class Work(NamedTuple):
    """One kernel call's work, as its bound counts it: operations (of which
    ``tensor_flops`` on the tensor cores), exps, and bytes (each input read
    once, each output written once); and the bytes of workspace the call
    allocates for itself (``scratch``, live only while it runs)."""
    flops: float
    bytes: float
    exps: float = 0.0
    tensor_flops: float = 0.0
    scratch: int = 0


def work(counts: dict, scratch: int = 0) -> Work:
    """``Work`` of a work function's ``dict(bytes=, exps=, flops=)``."""
    return Work(counts["flops"], counts["bytes"], counts["exps"],
                scratch=scratch)


def counter():
    """The innermost active dispatch mode that counts kernel calls (it has
    ``kernel_call``), or None."""
    if not torch._C._len_torch_dispatch_stack():
        return None
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if hasattr(mode, "kernel_call"):
            return mode
    return None


_NOTHING = contextlib.nullcontext()


def counted(name: str, work_of: Callable[[], Work]):
    """The context of one call of kernel ``name`` (the launch, the twin on
    the CPU, or nothing on meta): with a counter active, it ignores the ops
    inside and charges the call ``work_of()`` (asked only then); else
    nothing."""
    c = counter()
    return _NOTHING if c is None else c.kernel_call(name, work_of)


def sms(device: torch.device) -> int:
    """Streaming multiprocessors the launch plans are made for: the CUDA
    device's own, else an H100's (the card the meta and CPU counts
    stand for)."""
    return sm_count(device.index if device.index is not None
                    else torch.cuda.current_device()) \
        if device.type == "cuda" else H100_SMS


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index`` (asked once)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def check(status: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{what} launch failed with CUDA error {status}")
