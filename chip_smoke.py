"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

What it does (every phase fails the run if it fails), in this order save
that phases 9 and 10 run right after phases 6 and 7, and phase 12 right
after phase 5:

  1. prints the card's name and power limit (``nvidia-smi``);
  2. builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
     (``nvcc``, ``sm_90a``; the build directory is emptied first) and prints
     the build time;
  3. kernel phase — holds each kernel against its plain PyTorch version on
     the card at the fleet path's shapes: ``spike_hist`` in float64 on a
     10,000 x 256 block with six bin sizes and values on and within 1e-12
     of every bin edge (counts exactly equal), in float32 at jobs = 1
     (exactly equal); ``ema_scan`` against its plain float32 version and
     against the float64 prefix doubling (tolerances below); the engine's
     blocked float64 EMA (``ema_scan_blocks``) against its plain twin,
     exactly, at the edge lengths (1, 255, 256, 257, 512, 4 x 256 + 3 and
     empty rows) for alpha 0.5, 1.0 and 0.999 with and without state, 300
     ragged rows, and the main path's three forms (a group advance of
     (10,000, 256), a snapshot of 42 pending views of 4-250 samples, a
     builder's (1, 256) ingest), each timed beside the eager composition it
     replaced and the bound; and times the
     kernels, their plain versions and the bound of each, a builder commit
     ((1, 256) float64 with ``divisor=`` and ``out=``, equal to the divide,
     bin, cast and add it replaced) and a diagnostic build of the
     histogram kernel with its divides replaced by multiplies (marked WRONG
     where its counts differ; never used by the port);
  4. card-vs-host phase — a small fleet (the micro zoo, 300 jobs) through the
     port on the card and on the CPU: reference-library traces, the
     engine's histograms and EMA state (filtered by the blocked EMA kernel
     on the card) must be bitwise equal, and so must every decision;
  5. main path — ``benchmarks/bench_fleet_scale.py``'s full configuration
     through the port on the card: ``build_reference_library`` (28
     workloads x 9 frequencies), 10,000 jobs of ``fleet_job_mix(seed=11)``
     on a zero-variability 64-device inventory, ``admit_many`` +
     ``run(mux)`` with ``repack="tick"``, a budget squeeze-and-release under
     ``count_classifier_calls``, and the bench's ground-truth budget check
     with every trace EMA-filtered on the card (``spikes.ema_filter``).  The
     decision counts must equal ``results/fleet_scale.json`` and every
     kernel must have launched during this phase, ``ema_scan`` in each of
     the library build, the fleet drive and the ground truth (counted
     apart);
  6. LM kernel phase — prints the flash library's ptxas report (registers,
     shared memory, spills) and the count of HGMMA (warpgroup MMA)
     instructions in its SASS (``cuobjdump -sass``), and fails if there is
     none; ``flash_attention`` (bfloat16 causal at glm4-9b's heads: b=4 x
     s=1024, the serving path's ragged s=1000 and s=2048, a cached-prefill
     sq < skv case, float32, head_dim 64 and 32, and q, k, v read through
     the strides of a packed QKV tensor) and ``rmsnorm`` (bfloat16 at
     (4096, 4096), the prefill rows (4000, 4096) and the decode rows
     (4, 4096); float32) against their plain versions on the card; times
     each kernel, its plain version and the one PyTorch call that computes
     the same function (``scaled_dot_product_attention``, ``rms_norm``) at
     the serving path's shapes (flash at (4, 1000), (4, 1024) and (1, 2048),
     each with its bound); rmsnorm at the decode rows with and without
     programmatic dependent launch (pdl), the decode chain (81 pairs of a
     residual add and a norm, as one glm4-9b forward, for the kernel with
     and without pdl, ``rms_norm`` and the adds alone) and the host
     microseconds per ``ops.rmsnorm`` call;
  7. LM card-vs-host phase — the reduced glm4-9b (2 layers) with the same
     seeded weights on the card (kernels) and on the CPU (plain versions):
     prefill logits within 1e-4 with float32 parameters and within rtol
     2e-2 + atol 5e-2 with bfloat16 ones; teacher-forced decode logits and
     the caches (bfloat16 for both, as in the reference) within the latter;
  8. serving path — full-width glm4-9b (40 layers, 9.4 B bfloat16
     parameters, the port's seeded init) answers two requests through
     ``ServeEngine.generate``: 4 x 1000-token prompts and 1 x 2048, 32 new
     tokens each.  Tokens must be in range, every step's logits finite, and
     the kernels must have launched exactly as the model dictates (40 flash
     launches per prefill, 81 rmsnorm launches per forward, no scan);
  9. SSM kernel phase — prints ``ssm_scan``'s ptxas report and, per
     kernel, its SASS mix (``MUFU.EX2``, ``FFMA``, ``FMUL``, ``LDS``,
     ``SHFL``, ``BAR`` from ``cuobjdump -sass``; fails without an
     ``MUFU.EX2``); ``ssm_scan`` against its plain version on the card
     (y and h_last): bf16 and float32 at the prefill shapes (4, 1024, 8192,
     16) and (1, 2048, 8192, 16), the decode shape (4, 1, 8192, 16) with
     h0, 5-step tail blocks (s = 1029, at b = 4 and 2), a ragged case and
     ``tests/test_kernels.py``'s shapes, within that file's tolerances; the
     state advanced in place (h_out = h0, at (4, 1), (1, 1) and (2, 100))
     and the skip term left out as the model calls it; times of the kernel
     and the plain version, and the bound, at the serving path's prefill
     and decode shapes;
 10. Mamba card-vs-host phase — the reduced falcon-mamba-7b (2 layers) with
     the same seeded weights on the card and on the CPU, float32 and
     bfloat16 parameters: prefill logits, 8 teacher-forced decode steps and
     the state and conv caches within 1e-4 (float32) or rtol 2e-2 + atol
     5e-2 (bfloat16);
 11. Mamba serving path — full-width falcon-mamba-7b (64 layers, 7.3 B
     bfloat16 parameters, the port's seeded init; the glm4-9b engine is
     released first) answers 4 x 1024 and 1 x 2048 prompts, 32 new tokens
     each: tokens in range, logits finite, exactly 64 scan and 65 rmsnorm
     launches per forward (33 forwards a request) and no flash launch;
 12. session path — the outcome targets through
     ``repro_torch.api.MinosSession`` on the card, each ported from its
     bench (``benchmarks/`` is not imported) and held to its json:
     ``bench_fleet.py --smoke`` (``results/fleet.json``),
     ``bench_chaos.py --smoke``'s seeded fail / degrade / restore / fail
     schedule (``results/chaos.json``; the same drive on the host must
     leave bitwise the same engine columns), ``bench_recovery.py --smoke``
     (a child process drives the durable session on the card and SIGKILLs
     itself; this process resumes the store on the card:
     ``results/recovery.json``, 0 classifier calls) and
     ``bench_online_cap.py``'s 28 workloads on phase 5's library
     (``results/online_cap.json``); then phase 5's 10,000 jobs through
     ``submit_many`` + ``run()`` without and with a journal
     (``SCALE_SNAPSHOT_EVERY``), each with ``fleet_scale.json``'s counts
     (``repacks`` follows the session's per-decision cadence and is printed
     only), and a resume of that store with 0 classifier calls and every
     decision and plan equal to the live session's.  ``spike_hist`` and
     ``ema_scan`` must launch in every part (counted apart, the drains
     after a re-profile and after the resume included).

The line before the last is the per-kernel JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a usable CUDA card the script
exits non-zero and prints no result.  Options: ``--trace`` adds one more
fleet drive and one more request of each served model under
``torch.profiler`` (device busy share, top operators, ``spike_hist``'s and
the blocked EMA's device time in the fleet drive, device ops per builder
commit and per blocked-EMA call of each form, which must be 1);
``--fleet-kernels-only``, ``--lm-kernels-only`` and ``--ssm-kernel-only``
build the kernels and run phase 3, 6 or 9 alone,
without a result line (for work on a kernel); ``--session-only`` builds
them and the 28-workload library and runs phase 12 alone; ``--out DIR`` writes
the measurements (``chip_smoke.json``) and the trace tables
(``trace_summary.txt``, ``trace_serve_<arch>.txt``) into DIR.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.device import resolve_device  # noqa: E402

# H100 SXM data-sheet peaks (HBM3 bandwidth; fp64 and fp32 outside the
# tensor cores; bf16 dense on the tensor cores); exp on the special-function
# units: 16 a clock per SM (CUDA guide, compute capability 9.0) x 132 SMs x
# the 1,980 MHz boost clock
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"f64": 34e12, "f32": 67e12, "bf16_tensor": 989e12,
            "sfu_exp": 16 * 132 * 1.98e9}

BINS = (0.05, 0.1, 0.15, 0.2, 0.25, 0.5)
FLEET = {"tpu-v5e": 32, "tpu-v5p": 16, "tpu-v6e": 16}
GATES = dict(min_confidence=0.2, min_fraction=0.1, min_spike_samples=50)
EMA_F32_TOL = 1e-5          # x max|x|: f32 rounding of an alpha=0.5 filter
SUSTAIN_WINDOW = 50

GLM = "glm4-9b"
# tests/test_kernels.py's tolerances (bf16 rounding of the output, f32
# rounding of a softmax / mean of squares in another order)
KERNEL_TOL = {torch.bfloat16: dict(rtol=2e-2, atol=2e-2),
              torch.float32: dict(rtol=3e-5, atol=3e-5)}
# tests/test_torch_models.py's tolerances for a whole model's logits/caches
LM_TOL = {torch.bfloat16: dict(rtol=2e-2, atol=5e-2),
          torch.float32: dict(rtol=1e-4, atol=1e-4)}
REQUESTS = ((4, 1000), (1, 2048))          # (batch, prompt tokens)
NEW_TOKENS = 32

MAMBA = "falcon-mamba-7b"
MAMBA_REQUESTS = ((4, 1024), (1, 2048))    # multiples of 128, as the
                                           # reference's prefill needs
# tests/test_kernels.py's ssm_scan tolerances: bf16 rounding of the output,
# float32 sums over the states in another order
SSM_TOL = {torch.bfloat16: dict(rtol=2e-2, atol=2e-2),
           torch.float32: dict(rtol=2e-4, atol=2e-4)}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def cuda_time_ms(fn, iters: int, flush: torch.Tensor | None = None) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls (CUDA events around
    each call), with the 50 MB L2 cache flushed before each call when
    ``flush`` is given.  The card first spins for ~25 ms so that the host
    enqueues every call before the card reaches it: the events then time
    the card's work, not the host's launch overhead (a call that syncs
    inside, like the plain versions, still includes its host gaps)."""
    fn()
    torch.cuda.synchronize()
    events = []
    torch.cuda._sleep(50_000_000)
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def chain_time_ms(fn, iters: int, flush: torch.Tensor) -> float:
    """Mean device time of one call of ``fn`` (a chain of many launches)
    between two events, the L2 flushed before it; before each call the
    card spins for ~20 ms, so that the host has enqueued the whole chain
    before the card reaches it."""
    fn()
    total = 0.0
    for _ in range(iters):
        torch.cuda.synchronize()
        torch.cuda._sleep(40_000_000)
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / iters


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------
def edge_values() -> torch.Tensor:
    from repro_torch.core.spikes import SPIKE_LO, num_bins
    edges = torch.tensor([SPIKE_LO + k * c for c in BINS
                          for k in range(num_bins(c) + 1)],
                         dtype=torch.float64)
    up = torch.nextafter(edges, torch.full_like(edges, 10.0))
    down = torch.nextafter(edges, torch.full_like(edges, -10.0))
    return torch.cat([edges, up, down, edges + 1e-12, edges - 1e-12])


def kernel_phase(dev, flush) -> dict:
    from repro_torch.core.spikes import num_bins
    from repro_torch.kernels import (build, ema_scan_plain, ema_scan_rows,
                                     spike_hist_batch, spike_hist_batch_plain)
    nb = tuple(num_bins(c) for c in BINS)
    rng = np.random.default_rng(0)
    r = rng.uniform(0.0, 2.5, (10_000, 256))
    r[rng.random(r.shape) < 0.05] = -np.inf       # the engine's padding
    edges = edge_values().numpy()
    r.reshape(-1)[:len(edges)] = edges
    r.reshape(-1)[-len(edges):] = edges[::-1]
    rt = torch.from_numpy(r).to(dev)
    got = spike_hist_batch(rt, BINS, nb)
    want = spike_hist_batch_plain(rt, BINS, nb)
    torch.cuda.synchronize()
    err64 = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    if err64 != 0:
        raise AssertionError(f"spike_hist f64 disagrees with its plain "
                             f"version by {err64} counts")
    # float32 at jobs = 1 (ops.spike_hist's path), bin width (hi-lo)/n
    r32 = torch.from_numpy(rng.uniform(0.0, 2.2, (1, 4000))
                           .astype(np.float32)).to(dev)
    for n in (15, 30, 6):
        w = 1.5 / n
        a = spike_hist_batch(r32, (w,), (n,))
        b = spike_hist_batch_plain(r32, (w,), (n,))
        if not torch.equal(a, b):
            raise AssertionError(f"spike_hist f32 (n_bins={n}) disagrees "
                                 f"with its plain version")
    # ema_scan: against the plain f32 version and the f64 prefix doubling
    from repro_torch.core import spikes
    x64 = torch.from_numpy(rng.uniform(50.0, 300.0, 4_000)).to(dev)
    x32 = x64.to(torch.float32)
    k = ema_scan_rows(x32)
    p = ema_scan_plain(x32)
    ref64 = spikes.ema_filter(x64, backend="torch")
    torch.cuda.synchronize()
    err_plain = float((k - p).abs().max())
    err_f64 = float((k.to(torch.float64) - ref64).abs().max())
    tol = EMA_F32_TOL * float(x64.abs().max())
    if not (err_plain <= tol and err_f64 <= tol):
        raise AssertionError(f"ema_scan off: {err_plain} vs plain, {err_f64}"
                             f" vs f64, tolerance {tol}")
    rows_k = ema_scan_rows(torch.stack([x32, x32.flip(0)]))
    if not torch.equal(rows_k[0], k):
        raise AssertionError("ema_scan rows are not independent")
    log(f"kernel check: spike_hist f64 10000x256x6 bins max|err|={err64} "
        f"(exact), f32 jobs=1 exact; ema_scan n=4000 max|err| {err_plain:.3e}"
        f" vs plain f32, {err_f64:.3e} vs f64 (tolerance {tol:.3e})")
    before = dict(build.LAUNCHES)
    # timings at the fleet path's shapes, L2 flushed before every call
    t_hist1 = cuda_time_ms(lambda: spike_hist_batch(r32, (0.1,), (15,)), 30,
                           flush)            # jobs = 1 (ops.spike_hist)
    hist1_bytes = r32.numel() * 4 + 15 * 4
    hist1_bound = max(hist1_bytes / HBM_BYTES_PER_S,
                      r32.numel() * 2 / PEAK_OPS["f32"]) * 1e3
    log(f"spike_hist f32 jobs=1 (1, {r32.shape[1]}), 15 bins: kernel "
        f"{t_hist1:.4f} ms, bound {hist1_bound:.6f} ms ({hist1_bytes} B)")
    t_hist = cuda_time_ms(lambda: spike_hist_batch(rt, BINS, nb), 30, flush)
    t_hist_warm = cuda_time_ms(lambda: spike_hist_batch(rt, BINS, nb), 30)
    t_hist_plain = cuda_time_ms(
        lambda: spike_hist_batch_plain(rt, BINS, nb), 10, flush)
    commit = builder_commit(dev, flush, r[0] * 197.0, 197.0, nb)
    diag = divide_diagnostic(rt, nb, flush, t_hist)
    build.LAUNCHES.update(before)          # timing launches do not count
    n_spike = int((rt >= 0.5).sum())
    return {"spike_hist": dict(err=err64, ms=t_hist, plain_ms=t_hist_plain,
                               warm_ms=t_hist_warm, jobs1_ms=t_hist1,
                               jobs1_bound_ms=hist1_bound,
                               shape=list(rt.shape), n_spike=n_spike,
                               numel=rt.numel(), commit=commit,
                               divide_as_multiply=diag),
            "ema_scan": dict(err=err_plain, err_f64=err_f64),
            "ema_blocks": ema_blocks_phase(dev, flush)}


def builder_commit(dev, flush, power: np.ndarray, tdp: float, nb) -> dict:
    """One ``ProfileBuilder._commit`` of 256 float64 samples of power: the
    fused launch (divide by the TDP, bin, add into the float64 histograms)
    against the composition it replaced (divide, bin, cast, add), equal
    histograms required; times and the bound."""
    from repro_torch.core import spikes
    from repro_torch.kernels import spike_hist_batch
    arr = torch.from_numpy(power).to(dev)
    tdp_t = spikes.scalar(tdp, arr)
    hist = torch.zeros(sum(nb), dtype=torch.float64, device=dev)
    steps = torch.zeros_like(hist)

    def fused():
        spike_hist_batch(arr[None, :], BINS, nb, lo=spikes.SPIKE_LO,
                         divisor=tdp_t, out=hist[None, :])

    def composed():
        steps.add_(spike_hist_batch(arr[None, :] / tdp_t, BINS, nb,
                                    lo=spikes.SPIKE_LO)[0]
                   .to(torch.float64))
    fused()
    composed()
    torch.cuda.synchronize()
    if not torch.equal(hist, steps):
        raise AssertionError("the fused builder commit differs from divide, "
                             "bin, cast and add")
    n = arr.numel()
    nbytes = n * 8 + 8 + 2 * sum(nb) * 8      # samples, TDP, histograms r+w
    n_spike = int((arr / tdp_t >= spikes.SPIKE_LO).sum())
    ops = 2 * n + n_spike * (1 + 2 * len(BINS))
    bound = max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS["f64"]) * 1e3
    out = dict(shape=[1, n], ms=cuda_time_ms(fused, 50, flush),
               composed_ms=cuda_time_ms(composed, 50, flush),
               bound_ms=bound, bytes=nbytes, ops=ops)
    log(f"spike_hist builder commit (1, {n}) f64, divisor + out: fused "
        f"{out['ms']:.4f} ms, divide/bin/cast/add {out['composed_ms']:.4f} "
        f"ms, bound {bound:.6f} ms ({nbytes} B)")
    return out


# the diagnostic variant of csrc/spike_hist.cu: each bin size's divide
# replaced by a multiply with its reciprocal (WRONG at the bin edges: it is
# there to time what the float64 divides cost, never shipped)
DIVIDE_AS_MULTIPLY = [
    ("s_size[threadIdx.x] = static_cast<T>(a.sizes[threadIdx.x]);",
     "s_size[threadIdx.x] = static_cast<T>(1.0 / a.sizes[threadIdx.x]);"),
    ("const T q = shifted / s_size[b];", "const T q = shifted * s_size[b];"),
    ("sz[b] = static_cast<T>(a.sizes[b]);",
     "sz[b] = static_cast<T>(1.0 / a.sizes[b]);"),
    ("q = shifted / sz[b];", "q = shifted * sz[b];")]


def build_variants(source: str, variants: dict) -> dict:
    """name -> loaded library of ``csrc/<source>.cu`` with that name's text
    substitutions (``[[old, new], ...]``), each built with the port's nvcc
    flags into ``<build dir>/variants``, all at once; prints each build's
    registers (ptxas).  Raises if a substitution does not apply or a build
    fails."""
    import ctypes
    from repro_torch.kernels import build
    with open(os.path.join(build.CSRC, f"{source}.cu")) as f:
        src = f.read()
    out = os.path.join(build.build_dir(), "variants")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for name, subs in variants.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise ValueError(f"variant {name}: {old!r} not in "
                                 f"{source}.cu")
            text = text.replace(old, new)
        cu = os.path.join(out, f"{source}_{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = cu[:-3] + ".so"
        procs[name] = (subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        try:
            text, _ = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if proc.returncode:
            raise RuntimeError(f"variant {name} does not build:\n{text}")
        regs = sorted({ln.split("Used")[1].split(",")[0].strip()
                       for ln in text.splitlines() if "Used" in ln})
        log(f"{source} variant {name}: built, {', '.join(regs)}")
        lib = ctypes.CDLL(so)
        for fn, argtypes in build._SIGNATURES[source].items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def divide_diagnostic(rt, nb, flush, t_base: float) -> dict:
    """The divide-as-multiply variant through the same wrapper at the
    engine's shape: its time beside the shipped kernel's (and again after
    it, in turns), and whether its counts still equal the plain version's."""
    from repro_torch.kernels import build, spike_hist_batch
    from repro_torch.kernels import spike_hist_batch_plain
    lib = build_variants("spike_hist", {
        "divide_as_multiply": DIVIDE_AS_MULTIPLY})["divide_as_multiply"]
    shipped = build.library("spike_hist")

    def run():
        return spike_hist_batch(rt, BINS, nb)
    build._libs["spike_hist"] = lib
    try:
        exact = torch.equal(run(), spike_hist_batch_plain(rt, BINS, nb))
        t_var = cuda_time_ms(run, 30, flush)
    finally:
        build._libs["spike_hist"] = shipped
    t_again = cuda_time_ms(run, 30, flush)
    log(f"spike_hist divide as multiply (diagnostic"
        f"{'' if exact else ', WRONG'}): {t_var:.4f} ms against the "
        f"shipped kernel's {t_base:.4f} / {t_again:.4f} ms (before / after)")
    return dict(ms=t_var, base_ms=[t_base, t_again], exact=exact)


# the blocked float64 EMA's edge lengths: one sample, a block and one either
# side, two blocks, four blocks and three, and empty rows among them
EMA_EDGE_LENGTHS = (1, 255, 256, 0, 257, 512, 4 * 256 + 3, 0)


def ema_forms(dev) -> dict:
    """The profiling engine's three blocked-EMA call forms at the main path's
    shapes, each as ``kernel`` (the call the port makes), ``plain`` (the
    plain twin on the same inputs) and ``composed`` (the eager
    ``ema_filter_block`` composition the call site ran before), with the
    bytes and float64 operations of the work:

      * ``group``: a ``_advance_group`` of 10,000 rows, one 256-sample block
        each out of (10,000, 300) buffers, states read from and written to
        the engine's slot column;
      * ``snapshot``: a ``snapshot_batch`` of 42 slots' pending views, 4-250
        samples each with state, read at their slots;
      * ``ingest``: a ``ProfileBuilder`` chunk of 256 samples through
        ``_BlockedEMA.ingest`` (the reference library's build)."""
    from repro_torch.kernels import (ema_filter_block, ema_scan_blocks,
                                     ema_scan_blocks_plain)
    from repro_torch.pipeline.builder import _BlockedEMA
    rng = np.random.default_rng(23)
    cap = 16_384                       # the engine's capacity on the path
    col = torch.from_numpy(rng.uniform(0.0, 400.0, cap)).to(dev)
    hcol = torch.ones(cap, dtype=torch.bool, device=dev)
    forms = {}

    buf = torch.from_numpy(rng.uniform(0.0, 400.0, (10_000, 300))).to(dev)
    idx = torch.from_numpy(rng.permutation(cap)[:10_000]).to(dev)
    group = dict(n=256, index=idx, state_out=col, has_out=hcol)

    def group_composed():              # the eager _advance_group
        filt = torch.empty((10_000, 256), dtype=torch.float64, device=dev)
        out = ema_filter_block(buf[:, :256], col[idx], 0.5, 0.5)
        filt[:, :256] = out
        col[idx] = out[:, -1]
        hcol[idx] = True
    forms["group"] = dict(
        shape=[10_000, 256], rows=10_000, samples=10_000 * 256,
        row_bytes=8 + 8 + 8 + 1,       # index, state read and written, flag
        kernel=lambda: ema_scan_blocks(buf, col, True, 0.5, **group),
        plain=lambda: ema_scan_blocks_plain(buf, col, True, 0.5, **group),
        composed=group_composed)

    lengths = rng.integers(4, 251, 42)
    offs = np.concatenate([[0], np.cumsum(lengths)])
    xs = torch.from_numpy(rng.uniform(0.0, 400.0, int(offs[-1]))).to(dev)
    slots = rng.permutation(cap)[:42]
    sidx = torch.from_numpy(slots).to(dev)
    snap = dict(offsets=offs, index=sidx)
    pieces = [(int(a), int(b), int(s)) for a, b, s in
              zip(offs, offs[1:], slots)]

    def snapshot_composed():           # the eager per-slot pending view
        for a, b, s in pieces:
            ema_filter_block(torch.cat([xs[a:b]]), col[s], 0.5, 0.5)
    forms["snapshot"] = dict(
        shape=[42, int(lengths.min()), int(lengths.max())], rows=42,
        samples=int(offs[-1]), row_bytes=8 + 8 + 1 + 8,   # + its bounds
        kernel=lambda: ema_scan_blocks(xs, col, hcol, 0.5, **snap),
        plain=lambda: ema_scan_blocks_plain(xs, col, hcol, 0.5, **snap),
        composed=snapshot_composed)

    chunk = torch.from_numpy(rng.uniform(0.0, 400.0, 256)).to(dev)
    ema = _BlockedEMA()
    ema.ingest(chunk)                  # from here on every block has state
    st0 = col[7]
    forms["ingest"] = dict(
        shape=[1, 256], rows=1, samples=256, row_bytes=8 + 8,
        kernel=lambda: ema.ingest(chunk),
        plain=lambda: ema_scan_blocks_plain(chunk, st0, True, 0.5),
        composed=lambda: ema_filter_block(torch.cat([chunk]), st0, 0.5, 0.5))
    for f in forms.values():
        f["bytes"] = f["samples"] * 16 + f["rows"] * f["row_bytes"]
        f["ops"] = f["samples"] * 17 + f["rows"] * 2   # 8 doubling steps
        f["bound_ms"] = max(f["bytes"] / HBM_BYTES_PER_S,
                            f["ops"] / PEAK_OPS["f64"]) * 1e3
    return forms


def ema_blocks_check(dev) -> int:
    """``ema_scan_blocks`` against its plain twin on the card, exactly
    (``torch.equal``, the written state and flag columns included): the
    edge lengths at alpha 0.5, 1.0 and 0.999 with no state, every row's
    state and every other row's; one row with and without a 0-dim state
    (the builder's form); 300 ragged rows (bounds copied to the card); and
    the main path's three forms.  Returns the number of cases."""
    from repro_torch.kernels import ema_scan_blocks, ema_scan_blocks_plain
    rng = np.random.default_rng(29)
    n_cases = 0

    def check(what, x, state, has, alpha, commit=False, **kw):
        nonlocal n_cases
        got = []
        for fn in (ema_scan_blocks, ema_scan_blocks_plain):
            c = h = None
            if commit:
                c = state.clone()
                h = has.clone() if isinstance(has, torch.Tensor) else \
                    torch.zeros(state.numel(), dtype=torch.bool, device=dev)
            out = fn(x, state if c is None else c,
                     h if isinstance(has, torch.Tensor) and commit else has,
                     alpha, state_out=c, has_out=h, **kw)
            got.append([out] + ([c, h] if commit else []))
        torch.cuda.synchronize()
        for a, b in zip(*got):
            if not torch.equal(a, b):
                raise AssertionError(f"ema_scan_blocks {what} differs from "
                                     f"its plain version")
        n_cases += 1

    def ragged(lengths, cap):
        offs = np.concatenate([[0], np.cumsum(lengths)])
        x = torch.from_numpy(rng.uniform(0.0, 400.0, int(offs[-1]))).to(dev)
        col = torch.from_numpy(rng.uniform(0.0, 400.0, cap)).to(dev)
        idx = torch.from_numpy(rng.permutation(cap)[:len(lengths)]).to(dev)
        return x, col, idx, offs

    for alpha in (0.5, 1.0, 0.999):
        x, col, idx, offs = ragged(EMA_EDGE_LENGTHS, 64)
        check(f"edges alpha={alpha} no state", x, None, False, alpha,
              offsets=offs)
        for mode in ("all", "mixed"):
            has = torch.ones(64, dtype=torch.bool, device=dev)
            if mode == "mixed":
                has[idx[::2]] = False
            for commit in (False, True):
                check(f"edges alpha={alpha} {mode} state", x, col, has,
                      alpha, commit=commit, offsets=offs, index=idx)
        for n in EMA_EDGE_LENGTHS:
            row = x[:n]
            check(f"one row n={n} alpha={alpha}", row, None, False, alpha)
            check(f"one row n={n} alpha={alpha} with state", row, col[3],
                  True, alpha)
    x, col, idx, offs = ragged(rng.integers(0, 601, 300), 512)
    check("300 ragged rows", x, col, True, 0.5, commit=True, offsets=offs,
          index=idx)
    buf = torch.from_numpy(rng.uniform(0.0, 400.0, (10_000, 300))).to(dev)
    col = torch.from_numpy(rng.uniform(0.0, 400.0, 16_384)).to(dev)
    idx = torch.from_numpy(rng.permutation(16_384)[:10_000]).to(dev)
    for has in (False, True):
        check(f"group (10000, 256) has={has}", buf, col, has, 0.5,
              commit=True, n=256, index=idx)
    x, col, idx, offs = ragged(rng.integers(4, 251, 42), 16_384)
    has = torch.ones(16_384, dtype=torch.bool, device=dev)
    check("snapshot 42 x 4-250", x, col, has, 0.5, offsets=offs, index=idx)
    check("finalize 42 x 4-250", x, col, has, 0.5, commit=True,
          offsets=offs, index=idx)
    check("ingest (1, 256)", buf[0, :256], col[5], True, 0.5)
    return n_cases


def ema_blocks_phase(dev, flush) -> dict:
    """The blocked float64 EMA: the exact checks, then each main-path form's
    kernel, plain twin and old composition timed with the L2 flushed, beside
    the bound."""
    from repro_torch.kernels import build
    n_cases = ema_blocks_check(dev)
    log(f"kernel check: ema_scan_blocks f64 equals its plain version exactly "
        f"(torch.equal) in {n_cases} cases: edge lengths, alpha 0.5 / 1.0 / "
        f"0.999, with and without state, 300 ragged rows, the main path's "
        f"shapes")
    before = dict(build.LAUNCHES)
    out = {"cases": n_cases}
    for name, f in ema_forms(dev).items():
        r = dict(shape=f["shape"], bytes=f["bytes"], ops=f["ops"],
                 bound_ms=f["bound_ms"],
                 ms=cuda_time_ms(f["kernel"], 50, flush),
                 composed_ms=cuda_time_ms(f["composed"], 20, flush),
                 plain_ms=cuda_time_ms(f["plain"], 10, flush))
        out[name] = r
        log(f"ema_scan_blocks {name} {r['shape']} f64: kernel {r['ms']:.4f} "
            f"ms, old composition {r['composed_ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.6f} ms "
            f"({r['bytes']} B)")
    build.LAUNCHES.update(before)          # timing launches do not count
    return out


def device_ops(fn, n: int) -> dict:
    """Device operations (kernels, memsets, copies) by name that ``n`` calls
    of ``fn`` ran, counted by ``torch.profiler``: only those that started
    inside a marked window around the calls, with one call before and one
    after it (a profile has been seen to drop an event at its edge).  The
    card idles 10 ms between each edge of the window and the nearest
    launch, since the device's timestamps are placed on the host's clock
    only approximately (a neighbour's kernel was once counted in)."""
    from torch.profiler import (ProfilerActivity, profile,
                                record_function)
    cuda = torch.autograd.DeviceType.CUDA
    gap = 0.01
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
        time.sleep(gap)
        with record_function("counted calls"):
            time.sleep(gap)
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            time.sleep(gap)
        time.sleep(gap)
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    win = next(e for e in events if e.name == "counted calls"
               and e.device_type != cuda)
    ops: dict[str, int] = {}
    for e in events:
        if e.device_type == cuda and e.name != "counted calls" and \
                win.time_range.start <= e.time_range.start \
                <= win.time_range.end:
            ops[e.name] = ops.get(e.name, 0) + 1
    return ops


def ema_call_ops(dev, card: str, n: int = 20) -> dict:
    """Device operations per blocked-EMA call of each main-path form over
    ``n`` calls (``device_ops``): the kernel's (must be 1) and the old
    composition's."""
    out = {}
    for name, f in ema_forms(dev).items():
        per = {kind: sum(device_ops(f[kind], n).values()) / n
               for kind in ("kernel", "composed")}
        out[name] = per
        log(f"trace [{card}]: device ops per EMA call, {name}: kernel "
            f"{per['kernel']:g}, old composition {per['composed']:g}")
        if per["kernel"] != 1:
            raise AssertionError(f"a blocked-EMA call ({name}) ran "
                                 f"{per['kernel']} device ops, not 1")
    return out


def time_ema(dev, flush, n: int) -> tuple[float, float, float]:
    """Kernel and plain times of ``ema_scan`` on one trace of ``n`` samples,
    and the kernel's max |error| against the plain version there."""
    from repro_torch.kernels import build, ema_scan_plain, ema_scan_rows
    x = torch.from_numpy(np.random.default_rng(1).uniform(50, 300, n)
                         .astype(np.float32)).to(dev)
    before = dict(build.LAUNCHES)
    err = float((ema_scan_rows(x) - ema_scan_plain(x)).abs().max())
    if err > EMA_F32_TOL * 300:
        raise AssertionError(f"ema_scan at n={n} off by {err}")
    t = cuda_time_ms(lambda: ema_scan_rows(x), 50, flush)
    t_plain = cuda_time_ms(lambda: ema_scan_plain(x), 20, flush)
    build.LAUNCHES.update(before)
    return t, t_plain, err


# ---------------------------------------------------------------------------
# phases 4-5: the fleet path
# ---------------------------------------------------------------------------
def drive_fleet(lib, streams, counts, n_jobs, device, with_jobs=None):
    """bench_fleet_scale's drive through the port; returns the fleet, its
    result, the final packing, classifier calls on repack, timings and the
    per-group ground-truth inputs."""
    from repro_torch.core.classify import count_classifier_calls
    from repro_torch.fleet import (DeviceInventory, FleetCapController,
                                   FleetTelemetryMux, VariabilityModel)
    from repro_torch.telemetry import stream_telemetry
    inventory = DeviceInventory.generate(counts, VariabilityModel.none(),
                                         seed=7)
    jobs = with_jobs if with_jobs is not None else \
        [(streams[i % len(streams)], 32) for i in range(n_jobs)]
    assigned = [(s, chips, inventory[i % len(inventory)])
                for i, (s, chips) in enumerate(jobs)]
    nameplate = sum(chips * dev.nameplate_w for _, chips, dev in assigned)
    budget = 0.75 * nameplate
    seeds = {name: 500 + i for i, name in
             enumerate(sorted({s.name for s, _, _ in assigned}))}
    telemetry = {}
    for stream, _, dev in assigned:
        key = (stream.name, dev.model)
        if key not in telemetry:
            meta, chunks = stream_telemetry(
                stream, 1.0, dev.power_model(), seed=seeds[stream.name],
                target_duration=0.4, chunk_samples=256)
            telemetry[key] = (meta, list(chunks))
    fleet = FleetCapController(lib, budget_w=budget, provision_quantile="p99",
                               repack="tick", device=device, **GATES)
    mux = FleetTelemetryMux()
    t0 = time.perf_counter()
    job_ids = fleet.admit_many(
        dict(device=dev, meta=telemetry[(s.name, dev.model)][0], chips=c,
             job_id=f"j{i:05d}:{s.name}")
        for i, (s, c, dev) in enumerate(assigned))
    sync(device)
    t_admit = time.perf_counter() - t0
    for (s, _, dev), job_id in zip(assigned, job_ids):
        meta, chunks = telemetry[(s.name, dev.model)]
        mux.add_job(job_id, meta, chunks, device_id=dev.device_id)
    result = fleet.run(mux)
    sync(device)
    elapsed = time.perf_counter() - t0
    calls = count_classifier_calls(fleet.clf)
    fleet.set_budget(budget * 0.9)
    fleet.set_budget(budget)
    final = fleet.repacks[-1]
    return dict(fleet=fleet, result=result, final=final, calls=calls["n"],
                admit_s=t_admit, run_s=elapsed - t_admit, elapsed=elapsed,
                assigned=assigned, seeds=seeds, budget=budget)


def decision_key(d):
    s = d.selection
    return (d.target, d.cap, d.early, d.fraction, d.n_samples, d.device_id,
            s.bin_size, s.power_neighbor, s.util_neighbor, s.power_distance,
            s.util_distance, s.f_pwr, s.f_perf, d.confidence)


def card_vs_host_phase(dev) -> None:
    from repro_torch.kernels import build
    from repro_torch.pipeline import ReferenceLibrary, stream_profile_workload
    from repro_torch.telemetry import TPUPowerModel, kernel_stream as ks
    streams = [ks.micro_gemm(), ks.micro_spmv_memory(),
               ks.micro_spmv_compute(), ks.micro_idle_burst(),
               ks.micro_stencil()]
    model = TPUPowerModel()
    runs = {}
    build.reset_launches()
    for device in (dev, "cpu"):
        lib = ReferenceLibrary(
            (stream_profile_workload(s, model, (0.6, 0.8, 1.0),
                                     model.spec.tdp_w, seed=i,
                                     target_duration=1.0, device=device)
             for i, s in enumerate(streams)), built_on=model.spec.name,
            device=device)
        runs[str(device)] = (lib, drive_fleet(
            lib, streams, {"tpu-v5e": 4, "tpu-v5p": 2}, 300, device))
    (lib_c, card), (lib_h, host) = runs[str(dev)], runs["cpu"]
    if lib_c.fingerprint() != lib_h.fingerprint():
        raise AssertionError("reference traces built on the card differ "
                             "from the host's")
    for c in lib_c.bin_sizes:
        if not torch.equal(lib_c.spike_matrix(c).cpu(), lib_h.spike_matrix(c)):
            raise AssertionError(f"library spike matrix {c} differs")
    engine_columns_equal(card["fleet"].engine, host["fleet"].engine,
                         "the micro fleet")
    if build.LAUNCHES["ema_scan"] == 0:
        raise AssertionError("the micro fleet on the card ran no EMA kernel")
    dc, dh = card["result"].decisions, host["result"].decisions
    if [decision_key(d) for d in dc.values()] != \
            [decision_key(d) for d in dh.values()]:
        raise AssertionError("decisions on the card differ from the host's")
    if [p.job_id for p in card["final"].placed] != \
            [p.job_id for p in host["final"].placed]:
        raise AssertionError("placements on the card differ from the host's")
    log(f"card vs host: micro fleet of 300 jobs, {len(dc)} decisions, "
        f"library traces, engine histograms and EMA state bitwise equal "
        f"(blocked EMA on the card: {build.LAUNCHES['ema_scan']} launches)")


def ground_truth(run, dev) -> tuple[int, float, int]:
    """The bench's sustained-budget check; every group's trace is filtered
    on the card through ``spikes.ema_filter`` (the EMA kernel).  Returns the
    violations, the peak sustained watts and the median trace length."""
    from repro_torch.core import spikes
    from repro_torch.telemetry import simulate
    placed = {p.job_id: p for p in run["final"].placed}
    group_chips: dict[tuple, int] = {}
    for i, (stream, chips, d) in enumerate(run["assigned"]):
        plan = placed.get(f"j{i:05d}:{stream.name}")
        if plan is None:
            continue
        key = (stream.name, d.model, plan.cap)
        group_chips[key] = group_chips.get(key, 0) + plan.chips
    streams = {s.name: s for s, _, _ in run["assigned"]}
    models = {d.model: d.power_model() for _, _, d in run["assigned"]}
    traces = []
    for (name, model, cap), n_chips in sorted(group_chips.items()):
        sim = simulate(streams[name], cap, models[model],
                       seed=run["seeds"][name], target_duration=0.4)
        raw = torch.from_numpy(sim.power_raw).to(dev)
        filt = spikes.trim_idle(spikes.ema_filter(raw),
                                torch.from_numpy(sim.busy).to(dev))
        traces.append(filt * n_chips)
    n = max(len(t) for t in traces)
    agg = torch.zeros(n, dtype=torch.float64, device=dev)
    for t in traces:
        reps = -(-n // len(t))
        agg += t.repeat(reps)[:n]                 # np.resize semantics
    kernel = torch.full((1, 1, SUSTAIN_WINDOW), 1.0 / SUSTAIN_WINDOW,
                        dtype=torch.float64, device=dev)
    sustained = torch.nn.functional.conv1d(agg[None, None], kernel)[0, 0]
    return (int((sustained > run["budget"]).sum()), float(sustained.max()),
            int(np.median([len(t) for t in traces])))


def main_path(dev, want: dict):
    """Returns the reference library built on the card and the measurements;
    raises unless the counts equal ``want`` (results/fleet_scale.json)."""
    from repro_torch.kernels import build
    from repro_torch.pipeline import build_reference_library
    from repro_torch.telemetry import TPUPowerModel
    from repro_torch.telemetry.workloads import fleet_job_mix
    build.reset_launches()
    t0 = time.perf_counter()
    lib = build_reference_library(TPUPowerModel(), target_duration=3.0,
                                  device=dev)
    torch.cuda.synchronize()
    t_lib = time.perf_counter() - t0
    ema_lib = build.LAUNCHES["ema_scan"]
    log(f"reference library: {len(lib)} profiles x 9 frequencies built on "
        f"the card in {t_lib:.3f} s")
    run = drive_fleet(lib, None, FLEET, 10_000, dev,
                      with_jobs=fleet_job_mix(10_000, seed=11))
    ema_fleet = build.LAUNCHES["ema_scan"] - ema_lib
    t0 = time.perf_counter()
    violations, peak, ema_n = ground_truth(run, dev)
    torch.cuda.synchronize()
    t_truth = time.perf_counter() - t0
    launches = {k: build.LAUNCHES[k] for k in ("spike_hist", "ema_scan")}
    # the blocked f64 EMA of the library's builders and of the fleet's
    # engine; the ground truth's traces through the f32 entry
    ema_split = {"library": ema_lib, "fleet": ema_fleet,
                 "ground_truth": launches["ema_scan"] - ema_lib - ema_fleet}
    res, final = run["result"], run["final"]
    got = {"decisions": len(res.decisions),
           "early_decisions": res.early_decisions,
           "repacks": res.repacks, "chunks_dropped": res.chunks_dropped,
           "placed": len(final.placed), "deferred": len(final.deferred),
           "clf_calls_on_repack": run["calls"],
           "budget_violations": violations}
    for key, value in got.items():
        if value != want[key]:
            raise AssertionError(f"{key}: port on the card {value}, "
                                 f"results/fleet_scale.json {want[key]}")
    rel = abs(final.planned_power_w - want["planned_power_w"]) \
        / want["planned_power_w"]
    if rel > 1e-9:
        raise AssertionError(f"planned_power_w {final.planned_power_w} vs "
                             f"{want['planned_power_w']} (rel {rel:.2e})")
    for name, n in {**launches, **{f"ema_scan ({k})": v
                                   for k, v in ema_split.items()}}.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"main path")
    jobs_per_s = len(run["assigned"]) / run["elapsed"]
    log(f"main path: ema_scan launches {json.dumps(ema_split)}")
    log(f"main path: {json.dumps(got)} planned_power_w="
        f"{final.planned_power_w!r} (json {want['planned_power_w']}); "
        f"peak sustained {peak!r} W (json {want['peak_sustained_w']})")
    return lib, dict(got, planned_power_w=final.planned_power_w,
                peak_sustained_w=peak, library_s=t_lib,
                admit_s=run["admit_s"], run_s=run["run_s"],
                jobs_per_s=jobs_per_s, truth_s=t_truth, launches=launches,
                ema_launches=ema_split,
                engine_slots=run["fleet"].engine.capacity, ema_n=ema_n,
                row_loop_s=run["fleet"].engine.row_loop_s,
                repack_s=run["fleet"].repack_s)


def trace_phase(lib, dev, card: str, out: str | None) -> dict:
    """The fleet drive once more under ``torch.profiler``: the card's busy
    share of admit + run, and the operators that take the most device and
    host time (tables written to ``out/trace_summary.txt``)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.telemetry.workloads import fleet_job_mix
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run = drive_fleet(lib, None, FLEET, 10_000, dev,
                          with_jobs=fleet_job_mix(10_000, seed=11))
        torch.cuda.synchronize()
    ka = prof.key_averages()
    # kernels and copies only: operator rows repeat their kernels' time
    device_us = sum(e.self_device_time_total for e in ka
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    busy = device_us / 1e6 / run["elapsed"]
    log(f"trace [{card}]: admit+run {run['elapsed']:.3f} s under the "
        f"profiler, device busy {device_us / 1e6:.3f} s = {busy:.2%} "
        f"(idle {1 - busy:.2%})")
    hist = [e for e in ka if e.device_type == torch.autograd.DeviceType.CUDA
            and "spike_hist" in e.key]
    hist_us = sum(e.self_device_time_total for e in hist)
    hist_n = sum(e.count for e in hist)
    log(f"trace [{card}]: spike_hist in admit+run: {hist_us / 1e3:.3f} ms of "
        f"device time over {hist_n} launches")
    ema = [e for e in ka if e.device_type == torch.autograd.DeviceType.CUDA
           and "ema_blocks" in e.key]
    ema_us = sum(e.self_device_time_total for e in ema)
    ema_n = sum(e.count for e in ema)
    log(f"trace [{card}]: ema_scan f64 blocks in admit+run: "
        f"{ema_us / 1e3:.3f} ms of device time over {ema_n} launches")
    if out is not None:
        by_dev = ka.table(sort_by="self_device_time_total", row_limit=15)
        by_cpu = ka.table(sort_by="self_cpu_time_total", row_limit=15)
        with open(os.path.join(out, "trace_summary.txt"), "w") as f:
            f.write(f"{card}\nadmit+run {run['elapsed']:.3f} s traced, "
                    f"device busy {device_us / 1e6:.3f} s ({busy:.3%}); "
                    f"spike_hist {hist_us:.1f} us over {hist_n} launches; "
                    f"ema_scan f64 blocks {ema_us:.1f} us over {ema_n} "
                    f"launches\n\n"
                    f"{by_dev}\n\n{by_cpu}\n")
    return dict(spike_hist_device_us=hist_us, spike_hist_launches=hist_n,
                ema_blocks_device_us=ema_us, ema_blocks_launches=ema_n)


def builder_commit_ops(dev, card: str, n: int = 20) -> dict:
    """Device operations (kernels, memsets, copies) per
    ``ProfileBuilder._commit`` of 256 samples over ``n`` commits of one
    builder on the card (``device_ops``)."""
    import itertools
    from repro_torch.pipeline import ProfileBuilder
    from repro_torch.telemetry import TraceMeta
    meta = TraceMeta(name="commit", domain="t", sample_dt=1e-3,
                     n_samples=256 * (n + 1), exec_time=1.0, app_sm_util=0.5,
                     app_dram_util=0.5)
    builder = ProfileBuilder(meta, 197.0, device=dev)
    arrs = itertools.cycle(
        [torch.from_numpy(np.random.default_rng(i).uniform(0, 400, 256))
         .to(dev) for i in range(n + 1)])
    ops = device_ops(lambda: builder._commit(next(arrs)), n)
    per = sum(ops.values()) / n
    log(f"trace [{card}]: device ops per builder commit {per:g} "
        f"({json.dumps(ops)} over {n} commits)")
    if per != 1:
        raise AssertionError(f"a builder commit ran {per} device ops, not 1")
    return dict(per_commit=per, ops=ops, commits=n)


# ---------------------------------------------------------------------------
# phases 6-8: the dense-LM serving path
# ---------------------------------------------------------------------------
def close(got: torch.Tensor, want: torch.Tensor, tol: dict, what: str) -> float:
    """max |got - want|; raises unless |got - want| <= atol + rtol |want|."""
    got, want = got.float(), want.float().to(got.device)
    err = (got - want).abs()
    if not bool((err <= tol["atol"] + tol["rtol"] * want.abs()).all()):
        raise AssertionError(f"{what}: max|err| {float(err.max()):.3e} beyond"
                             f" rtol {tol['rtol']} + atol {tol['atol']}")
    return float(err.max())


def attn_inputs(dev, b, sq, skv, dtype, seed, H=None, KV=None, dh=None):
    """q, k, v of normal values; glm4-9b's heads unless given."""
    from repro_torch.configs import ARCHS
    cfg = ARCHS[GLM]
    H, KV, dh = (H or cfg.num_heads, KV or cfg.num_kv_heads,
                 dh or cfg.head_dim)
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=dev).to(dtype)
            for shape in ((b, sq, H, dh), (b, skv, KV, dh), (b, skv, KV, dh))]


def packed_attn_inputs(dev, b, s, H, KV, dh, seed):
    """q, k, v as head slices of one packed (b, s, H + 2 KV, dh) tensor, as
    a fused QKV projection leaves them: strided, not contiguous."""
    g = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn((b, s, H + 2 * KV, dh), generator=g, device=dev)
    return list(qkv.to(torch.bfloat16).split([H, KV, KV], dim=2))


def build_report(source: str, ops: tuple[str, ...]) -> dict:
    """ptxas's registers / shared memory / spills for the library built
    from ``source`` and, per kernel, the count of each opcode in ``ops`` in
    its SASS (``cuobjdump -sass``; an opcode counts with any suffix, so
    LDS counts every width but not LDSM)."""
    from repro_torch.kernels import build
    ptxas = [ln.strip() for ln in
             str(build.BUILD_INFO.get(f"{source}_ptxas", "")).splitlines()
             if any(w in ln for w in ("Used", "spill", "Compiling entry",
                                      "arning", "Performance"))]
    bindir = os.path.dirname(build._nvcc())
    sass = subprocess.run([os.path.join(bindir, "cuobjdump"), "-sass",
                           build.build_all()[source]],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    by_kernel, name = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            name = ln.split("Function :")[1].strip()
            by_kernel[name] = dict.fromkeys(ops, 0)
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                     ln)
        if m is None or name is None:
            continue
        for key in ops:
            if m.group(1) == key or m.group(1).startswith(key + "."):
                by_kernel[name][key] += 1
    filt = os.path.join(bindir, "cu++filt")
    if os.path.exists(filt) and by_kernel:
        names = list(by_kernel)
        plain = subprocess.run([filt, *names], capture_output=True,
                               text=True, timeout=60).stdout.splitlines()
        if len(plain) == len(names):
            by_kernel = {p.strip(): by_kernel[n]
                         for n, p in zip(names, plain)}
    return dict(ptxas=ptxas, sass=by_kernel)


def lm_kernel_phase(dev, flush, card: str) -> dict:
    """Both LM kernels against their plain versions, then timings of the
    kernel, the plain version and the library call at the serving path's
    shapes (launches made here do not count)."""
    import torch.nn.functional as F
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import (attn_work, build, flash_attention,
                                     flash_attention_plain, rmsnorm,
                                     rmsnorm_plain)
    cfg = ARCHS[GLM]
    H, KV, dh, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    report = build_report("flash_attention", ("HGMMA",))
    report["hgmma_by_kernel"] = {k: c["HGMMA"]
                                 for k, c in report.pop("sass").items()}
    report["hgmma"] = sum(report["hgmma_by_kernel"].values())
    for ln in report["ptxas"]:
        log(f"  flash_attention ptxas: {ln}")
    log(f"  flash_attention SASS: {report['hgmma']} HGMMA instructions "
        f"{json.dumps(report['hgmma_by_kernel'])}")
    if report["hgmma"] == 0:
        raise AssertionError("the flash_attention library has no HGMMA "
                             "(wgmma) instruction")
    before = dict(build.LAUNCHES)
    fa_err, rn_err = 0.0, 0.0
    # glm4-9b's heads at the serving shapes, a cached-prefill sq < skv case,
    # float32; then every other head_dim the kernel is built for, and q, k,
    # v read through the strides of a packed QKV tensor
    cases = [((4, 1024, 1024, torch.bfloat16), {}),
             ((4, 1000, 1000, torch.bfloat16), {}),
             ((1, 2048, 2048, torch.bfloat16), {}),
             ((2, 100, 1000, torch.bfloat16), {}),
             ((1, 1000, 1000, torch.float32), {}),
             ((2, 300, 300, torch.bfloat16), dict(H=16, KV=4, dh=64)),
             ((2, 200, 333, torch.bfloat16), dict(H=8, KV=8, dh=32)),
             ((2, 1000, 1000, torch.bfloat16), dict(packed=True))]
    for (b, sq, skv, dtype), kw in cases:
        if kw.get("packed"):
            q, k, v = packed_attn_inputs(dev, b, sq, H, KV, dh, sq + 1)
        else:
            q, k, v = attn_inputs(dev, b, sq, skv, dtype, sq + skv, **kw)
        got = flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        what = (f"flash_attention b={b} sq={sq} skv={skv} H={q.shape[2]} "
                f"KV={k.shape[2]} dh={q.shape[3]} {dtype}"
                f"{' packed qkv strides' if kw.get('packed') else ''}")
        err = close(got, flash_attention_plain(q, k, v, causal=True),
                    KERNEL_TOL[dtype], what)
        fa_err = max(fa_err, err)
        log(f"{what}: max|err| {err:.3e} vs plain")

    g = torch.Generator(device=dev).manual_seed(5)
    for n, dtype in ((4096, torch.bfloat16), (4000, torch.bfloat16),
                     (4, torch.bfloat16), (4096, torch.float32)):
        x = (torch.randn((n, d), generator=g, device=dev) * 3).to(dtype)
        sc = (1 + 0.1 * torch.randn(d, generator=g, device=dev)).to(dtype)
        got = rmsnorm(x, sc, cfg.norm_eps)
        torch.cuda.synchronize()
        err = close(got, rmsnorm_plain(x, sc, cfg.norm_eps),
                    KERNEL_TOL[dtype], f"rmsnorm ({n}, {d}) {dtype}")
        rn_err = max(rn_err, err)
        log(f"rmsnorm check ({n}, {d}) {dtype}: max|err| {err:.3e} vs plain")

    # timings at the serving path's prefill shapes: the kernel, the plain
    # version (first shape only) and scaled_dot_product_attention; a first
    # timing is thrown away (the first in a process reads high)
    q, k, v = attn_inputs(dev, 4, 1000, 1000, torch.bfloat16, 6)
    cuda_time_ms(lambda: flash_attention(q, k, v), 20, flush)
    shapes = []
    for b, s in ((4, 1000), (4, 1024), (1, 2048)):
        q, k, v = attn_inputs(dev, b, s, s, torch.bfloat16, 7 + s)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                             enable_gqa=True).transpose(1, 2)
        close(lib, flash_attention_plain(q, k, v, causal=True),
              KERNEL_TOL[torch.bfloat16], "scaled_dot_product_attention")
        flops, nbytes = attn_work(b, s, s, H, KV, dh, 2)
        t_ops = flops / PEAK_OPS["bf16_tensor"]
        t_bytes = nbytes / HBM_BYTES_PER_S
        r = dict(b=b, s=s, flops=flops, bytes=nbytes,
                 bound_ms=max(t_ops, t_bytes) * 1e3,
                 bound_by="operations" if t_ops > t_bytes else "bytes",
                 ms=cuda_time_ms(lambda: flash_attention(q, k, v), 20, flush),
                 library_ms=cuda_time_ms(
                     lambda: F.scaled_dot_product_attention(
                         qt, kt, vt, is_causal=True, enable_gqa=True),
                     20, flush))
        if not shapes:
            r["plain_ms"] = cuda_time_ms(
                lambda: flash_attention_plain(q, k, v), 5, flush)
        r["tflops"] = flops / r["ms"] * 1e-9
        log(f"flash_attention bf16 b={b} s={s} H={H} KV={KV} dh={dh} causal "
            f"[{card}]: kernel {r['ms']:.4f} ms ({r['tflops']:.1f} TFLOP/s, "
            f"{r['bound_ms'] / r['ms']:.1%} of the bound), "
            f"scaled_dot_product_attention {r['library_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({flops:.4e} flop, {nbytes:.4e} B; "
            f"{r['bound_by']})"
            + (f", plain {r['plain_ms']:.4f} ms" if "plain_ms" in r else ""))
        shapes.append(r)
    first = shapes[0]
    fa = dict(err=fa_err, shape=[first["b"], first["s"], H, KV, dh],
              shapes=shapes, build=report,
              **{k: first[k] for k in ("ms", "plain_ms", "library_ms",
                                       "flops", "bytes", "bound_ms",
                                       "bound_by")})

    b, s = REQUESTS[0]        # the prefill norm over 4,000 rows, decode over 4
    rows = b * s
    x = torch.randn((rows, d), generator=g, device=dev).to(torch.bfloat16)
    sc = (1 + 0.1 * torch.randn(d, generator=g, device=dev)).to(
        torch.bfloat16)
    xd = x[:b].contiguous()
    eps = cfg.norm_eps
    rn = dict(ms=cuda_time_ms(lambda: rmsnorm(x, sc, eps), 50, flush),
              plain_ms=cuda_time_ms(lambda: rmsnorm_plain(x, sc, eps), 20,
                                    flush),
              library_ms=cuda_time_ms(
                  lambda: F.rms_norm(x, (d,), weight=sc, eps=eps), 50, flush),
              decode_ms=cuda_time_ms(lambda: rmsnorm(xd, sc, eps), 50, flush),
              decode_library_ms=cuda_time_ms(
                  lambda: F.rms_norm(xd, (d,), weight=sc, eps=eps), 50,
                  flush))
    close(F.rms_norm(x, (d,), weight=sc, eps=eps), rmsnorm_plain(x, sc, eps),
          KERNEL_TOL[torch.bfloat16], "rms_norm")
    x1 = x[:1].contiguous()
    rn.update(one_row_ms=cuda_time_ms(lambda: rmsnorm(x1, sc, eps), 50, flush),
              one_row_library_ms=cuda_time_ms(
                  lambda: F.rms_norm(x1, (d,), weight=sc, eps=eps), 50, flush),
              decode=rmsnorm_decode(dev, flush, card, d, eps))
    nbytes = 2.0 * (2 * rows * d + d)
    flops = 4.0 * rows * d            # square, add; two multiplies
    rn.update(err=rn_err, bytes=nbytes, flops=flops, shape=[rows, d],
              bound_ms=max(nbytes / HBM_BYTES_PER_S,
                           flops / PEAK_OPS["f32"]) * 1e3,
              bound_by="bytes")
    log(f"rmsnorm bf16 ({rows}, {d}) [{card}]: kernel {rn['ms']:.4f} ms, "
        f"plain {rn['plain_ms']:.4f} ms, rms_norm {rn['library_ms']:.4f} ms,"
        f" bound {rn['bound_ms']:.4f} ms ({nbytes:.4e} B); decode rows "
        f"({b}, {d}): kernel {rn['decode_ms']:.4f} ms, rms_norm "
        f"{rn['decode_library_ms']:.4f} ms; one row (1, {d}): kernel "
        f"{rn['one_row_ms']:.4f} ms, rms_norm {rn['one_row_library_ms']:.4f}"
        f" ms")
    build.LAUNCHES.update(before)          # check/timing launches do not count
    return {"flash_attention": fa, "rmsnorm": rn}


DECODE_PAIRS = 81                # rmsnorm launches in one glm4-9b forward


def rmsnorm_decode(dev, flush, card: str, d: int, eps: float) -> dict:
    """rmsnorm at the decode rows: one flushed launch at (4, d) and (1, d),
    with and without programmatic dependent launch (pdl); the decode chain
    (DECODE_PAIRS pairs of a residual add h = h + y and y = rmsnorm(h,
    scale_l), one event pair around the chain, L2 flushed before it) for the
    kernel with and without pdl, for ``F.rms_norm`` and for the adds alone;
    and the host microseconds per ``ops.rmsnorm`` call as ``Norm`` makes
    it (pdl)."""
    import torch.nn.functional as F
    from repro_torch.kernels import rmsnorm, rmsnorm_plain, rmsnorm_rows
    bf16 = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(8)
    h0 = torch.randn((4, d), generator=g, device=dev).to(bf16)
    scales = [(1 + 0.1 * torch.randn(d, generator=g, device=dev)).to(bf16)
              for _ in range(DECODE_PAIRS)]
    out = {"single": {}, "chain_ms_per_pair": {}}
    for n in (4, 1):
        x = h0[:n].contiguous()
        want = rmsnorm_plain(x, scales[0], eps)
        for pdl in (False, True):
            key = f"{n}x{d}{' pdl' if pdl else ''}"
            close(rmsnorm_rows(x, scales[0], eps, pdl=pdl), want,
                  KERNEL_TOL[bf16], f"rmsnorm {key}")
            out["single"][key] = cuda_time_ms(
                lambda: rmsnorm_rows(x, scales[0], eps, pdl=pdl), 50, flush)

    def chain(norm):
        def run():
            h, y = h0, h0
            for sc in scales:
                h = h + y
                y = norm(h, sc)
            return y
        return run
    norms = {"kernel": lambda h, sc: rmsnorm_rows(h, sc, eps),
             "kernel pdl": lambda h, sc: rmsnorm_rows(h, sc, eps, pdl=True),
             "rms_norm": lambda h, sc: F.rms_norm(h, (d,), weight=sc,
                                                  eps=eps),
             "adds alone": lambda h, sc: h0}
    plain = chain(lambda h, sc: rmsnorm_plain(h, sc, eps))()
    ends = {}
    for name, norm in norms.items():
        ends[name] = chain(norm)()
        out["chain_ms_per_pair"][name] = chain_time_ms(
            chain(norm), 10, flush) / DECODE_PAIRS
    for name in ("kernel", "kernel pdl"):
        close(ends[name], plain, LM_TOL[bf16], f"rmsnorm decode chain {name}")
    if not torch.equal(ends["kernel"], ends["kernel pdl"]):
        raise AssertionError("the decode chain differs with programmatic "
                             "dependent launch")
    # host time per call, the card kept busy so that the queue never blocks
    host = {}
    x = h0
    for name, fn in (("ops.rmsnorm", lambda: rmsnorm(x, scales[0], eps,
                                                     pdl=True)),
                     ("rms_norm", lambda: F.rms_norm(x, (d,),
                                                     weight=scales[0],
                                                     eps=eps))):
        spent = 0.0
        for _ in range(4):
            torch.cuda.synchronize()
            torch.cuda._sleep(50_000_000)
            t0 = time.perf_counter()
            for _ in range(500):
                fn()
            spent += time.perf_counter() - t0
        torch.cuda.synchronize()
        host[name] = spent / 2000 * 1e6
    out["host_us_per_call"] = host
    log(f"rmsnorm single launches (ms) [{card}]: "
        + ", ".join(f"{k} {v:.4f}" for k, v in out["single"].items()))
    log(f"rmsnorm decode chain, {DECODE_PAIRS} pairs of add + norm on (4, "
        f"{d}) bf16, ms per pair [{card}]: "
        + ", ".join(f"{k} {v:.4f}" for k, v in
                    out["chain_ms_per_pair"].items()))
    log(f"rmsnorm host us per call at (4, {d}), 2000 calls [{card}]: "
        + ", ".join(f"{k} {v:.2f}" for k, v in host.items()))
    return out


def lm_card_vs_host_phase(dev) -> None:
    """Reduced glm4-9b with the same weights: kernels on the card against
    the plain versions on the CPU, prefill and teacher-forced decode."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import build
    from repro_torch.serve import ServeEngine
    cfg = ARCHS[GLM].reduced(num_layers=2)
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 100))
    for dtype in (torch.float32, torch.bfloat16):
        host = ServeEngine(cfg, max_len=120, device="cpu", dtype=dtype)
        host.init_params(0)
        card = ServeEngine(cfg, max_len=120, device=dev, dtype=dtype)
        card.model.load_state_dict(host.model.state_dict())
        tol = LM_TOL[dtype]
        # the host first: its logits, caches and greedy tokens
        lh, ch = host.model.prefill({"tokens": tokens})
        ch = host._pad_caches(ch, 2)
        host_logits, fed = [lh], []
        for i in range(8):
            fed.append(torch.argmax(host_logits[-1], dim=-1))
            lh, ch = host.model.decode_step(ch, fed[-1], 100 + i)
            host_logits.append(lh)
        # then the card, fed the host's tokens
        before = dict(build.LAUNCHES)
        lc, cc = card.model.prefill({"tokens": tokens})
        cc = card._pad_caches(cc, 2)
        card_logits = [lc]
        for i in range(8):
            lc, cc = card.model.decode_step(cc, fed[i].to(dev), 100 + i)
            card_logits.append(lc)
        if build.LAUNCHES["flash_attention"] - before["flash_attention"] \
                != 2 or build.LAUNCHES["rmsnorm"] - before["rmsnorm"] \
                != 5 * 9:
            raise AssertionError("the reduced LM on the card did not run "
                                 "its kernels")
        # the decode caches and decode softmax weights are bf16 for either
        # parameter dtype, as in the reference: one bf16 rounding that
        # falls differently moves the logits by more than 1e-4
        errs = [close(card_logits[0], host_logits[0], tol,
                      f"prefill logits {dtype}")]
        bf16 = LM_TOL[torch.bfloat16]
        errs += [close(c, h, bf16, f"decode logits {dtype} step {i}")
                 for i, (c, h) in enumerate(zip(card_logits[1:],
                                                host_logits[1:]))]
        for key in ("k", "v"):
            errs.append(close(cc["l0_attn"][key], ch["l0_attn"][key], bf16,
                              f"cache {key} {dtype}"))
        build.LAUNCHES.update(before)
        log(f"LM card vs host: reduced {GLM} (2 layers) {dtype}, 2 x 100 "
            f"prompt: prefill logits max|err| {errs[0]:.3e} (tolerance rtol "
            f"{tol['rtol']} + atol {tol['atol']}); 8 teacher-forced decode "
            f"steps and bf16 caches max|err| {max(errs[1:]):.3e} (rtol "
            f"{bf16['rtol']} + atol {bf16['atol']})")


# ---------------------------------------------------------------------------
# phases 9-11: the Mamba serving path
# ---------------------------------------------------------------------------
def scan_inputs(dev, b, s, di, ds, xdtype, dtdtype, seed, h0=False):
    """tests/test_kernels.py's distributions for ssm_scan on the card:
    x, dt (b, s, di) in their dtypes, A (di, ds), B, C (b, s, ds), D (di,)
    float32, and a float32 h0 when asked."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def n(*shape):
        return torch.randn(shape, generator=g, device=dev)
    x = (n(b, s, di) * 0.5).to(xdtype)
    dt = torch.nn.functional.softplus(n(b, s, di) * 0.2 - 1).to(dtdtype)
    args = [x, dt, -torch.exp(n(di, ds) * 0.3), n(b, s, ds) * 0.5,
            n(b, s, ds) * 0.5, 1 + 0.1 * n(di)]
    return args, (n(b, di, ds) if h0 else None)


def scan_bound(work: dict) -> dict:
    """The least time of one scan from ``kernels.scan_work``'s counts: its
    bytes over the memory rate or its exps over the special-function
    units' rate and its other float32 operations over the float32 rate,
    whichever is larger."""
    times = {"bytes": work["bytes"] / HBM_BYTES_PER_S,
             "operations": max(work["exps"] / PEAK_OPS["sfu_exp"],
                               work["flops"] / PEAK_OPS["f32"])}
    bound_by = max(times, key=times.get)
    return dict(work, bound_by=bound_by, bound_ms=times[bound_by] * 1e3)


SASS_OPS = ("MUFU.EX2", "FFMA", "FMUL", "LDS", "SHFL", "BAR")


def ssm_kernel_phase(dev, flush, card: str) -> dict:
    """ssm_scan's ptxas report and SASS mix, the kernel against its plain
    version on the card (y and h_last), then the kernel's and the plain
    version's times and the bound at the serving path's shapes (launches
    made here do not count)."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import build, scan_work, ssm_scan, ssm_scan_plain
    cfg = ARCHS[MAMBA]
    di, ds = cfg.d_inner, cfg.ssm_state
    bf16, f32 = torch.bfloat16, torch.float32
    report = build_report("ssm_scan", SASS_OPS)
    for ln in report["ptxas"]:
        log(f"  ssm_scan ptxas: {ln}")
    for name, counts in report["sass"].items():
        log(f"  ssm_scan SASS {name}: {json.dumps(counts)}")
    if not any(c["MUFU.EX2"] for c in report["sass"].values()):
        raise AssertionError("the ssm_scan library has no MUFU.EX2")
    before = dict(build.LAUNCHES)
    err = 0.0
    cases = [(4, 1024, di, ds, bf16, f32, False),   # the model's prefill
             (4, 1024, di, ds, f32, f32, False),
             (1, 2048, di, ds, bf16, f32, False),   # batch 1
             (1, 2048, di, ds, f32, f32, False),
             (4, 1, di, ds, f32, f32, True),        # the model's decode
             (4, 1029, di, ds, bf16, f32, True),    # a 5-step tail block
             (2, 1029, 1024, ds, bf16, bf16, True),  # (eight and four
             (2, 1029, 1024, ds, f32, f32, False),   # states a thread)
             (3, 77, 1000, ds, bf16, f32, True),    # ragged s and di
             (1, 64, 128, 8, f32, f32, False),      # tests/test_kernels.py
             (2, 128, 256, 16, f32, f32, False),
             (1, 96, 384, 16, f32, f32, False),
             (1, 64, 128, 8, bf16, bf16, False),
             (2, 128, 256, 16, bf16, bf16, False),
             (1, 96, 384, 16, bf16, bf16, False)]
    for i, (b, s, d_i, d_s, xdt, dtdt, with_h0) in enumerate(cases):
        args, h0 = scan_inputs(dev, b, s, d_i, d_s, xdt, dtdt, 20 + i,
                               with_h0)
        y, h = ssm_scan(*args, h0=h0)
        torch.cuda.synchronize()
        y_p, h_p = ssm_scan_plain(*args, h0=h0)
        what = f"ssm_scan ({b}, {s}, {d_i}, {d_s}) x {xdt} dt {dtdt}" + \
            (" with h0" if with_h0 else "")
        e_y = close(y, y_p, SSM_TOL[xdt], f"{what}: y")
        e_h = close(h, h_p, SSM_TOL[f32], f"{what}: h_last")
        err = max(err, e_y, e_h)
        log(f"{what}: max|err| y {e_y:.3e}, h_last {e_h:.3e} vs plain")
    # the skip term left out and the state advanced in place, as the model
    # calls the kernel in prefill and decode
    for b, s, seed in ((4, 1, 40), (1, 1, 41), (2, 100, 42)):
        args, h0 = scan_inputs(dev, b, s, di, ds, f32, f32, seed, True)
        y_d, h_d = ssm_scan(*args, h0=h0)
        state = h0.clone()
        y_i, _ = ssm_scan(*args, h0=state, h_out=state)
        y_0, _ = ssm_scan(*args[:5], None, h0=h0)
        torch.cuda.synchronize()
        if not (torch.equal(state, h_d) and torch.equal(y_i, y_d)):
            raise AssertionError(f"ssm_scan ({b}, {s}) with h_out = h0 "
                                 f"differs")
        close(y_0 + args[5] * args[0], y_d, SSM_TOL[f32],
              f"ssm_scan ({b}, {s}) without D")
        y_p, h_p = ssm_scan_plain(*args, h0=h0)
        err = max(err, close(y_i, y_p, SSM_TOL[f32],
                             f"ssm_scan ({b}, {s}) in place: y"),
                  close(state, h_p, SSM_TOL[f32],
                        f"ssm_scan ({b}, {s}) in place: h_last"))
        log(f"ssm_scan ({b}, {s}, {di}, {ds}) with h_out = h0: equal to a "
            f"fresh h_out, within tolerance of plain; without D within "
            f"tolerance")

    # timings at the serving path's shapes: prefill as the model calls it
    # (x bf16, dt float32, no skip term), and one decode step; a first
    # timing is thrown away (the first in a process reads high)
    out = {"err": err, "build": report}
    for key, (b, s) in (("prefill", MAMBA_REQUESTS[0]),
                        ("prefill_b1", MAMBA_REQUESTS[1])):
        args, _ = scan_inputs(dev, b, s, di, ds, bf16, f32, 50)
        args[5] = None
        if key == "prefill":
            cuda_time_ms(lambda: ssm_scan(*args), 20, flush)
        work = scan_bound(scan_work(b, s, di, ds, 2, 4, skip=False,
                                    h0=False))
        out[key] = dict(
            shape=[b, s, di, ds],
            ms=cuda_time_ms(lambda: ssm_scan(*args), 20, flush),
            plain_ms=cuda_time_ms(lambda: ssm_scan_plain(*args), 3, flush),
            **work)
    args, h0 = scan_inputs(dev, 4, 1, di, ds, f32, f32, 51, True)
    out["decode"] = dict(
        shape=[4, 1, di, ds],
        ms=cuda_time_ms(lambda: ssm_scan(*args, h0=h0, h_out=h0), 50,
                        flush),
        plain_ms=cuda_time_ms(lambda: ssm_scan_plain(*args, h0=h0), 20,
                              flush),
        **scan_bound(scan_work(4, 1, di, ds, 4, 4, skip=True, h0=True)))
    build.LAUNCHES.update(before)          # check/timing launches do not count
    for key in ("prefill", "prefill_b1", "decode"):
        r = out[key]
        log(f"ssm_scan {key} {tuple(r['shape'])} [{card}]: kernel "
            f"{r['ms']:.4f} ms ({r['bound_ms'] / r['ms']:.1%} of the bound),"
            f" plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}: {r['bytes']:.4e} B, {r['exps']:.4e} exp, "
            f"{r['flops']:.4e} flop)")
    return out


def mamba_card_vs_host_phase(dev) -> None:
    """Reduced falcon-mamba-7b with the same weights: the kernels on the
    card against the plain versions on the CPU, prefill, teacher-forced
    decode and both caches."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import build
    from repro_torch.serve import ServeEngine
    cfg = ARCHS[MAMBA].reduced(num_layers=2)
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 100))
    for dtype in (torch.float32, torch.bfloat16):
        host = ServeEngine(cfg, max_len=120, device="cpu", dtype=dtype)
        host.init_params(0)
        card = ServeEngine(cfg, max_len=120, device=dev, dtype=dtype)
        card.model.load_state_dict(host.model.state_dict())
        tol = LM_TOL[dtype]
        lh, ch = host.model.prefill({"tokens": tokens})
        ch = host._pad_caches(ch, 2)
        host_logits, fed = [lh], []
        for i in range(8):
            fed.append(torch.argmax(host_logits[-1], dim=-1))
            lh, ch = host.model.decode_step(ch, fed[-1], 100 + i)
            host_logits.append(lh)
        before = dict(build.LAUNCHES)
        lc, cc = card.model.prefill({"tokens": tokens})
        cc = card._pad_caches(cc, 2)
        card_logits = [lc]
        for i in range(8):
            lc, cc = card.model.decode_step(cc, fed[i].to(dev), 100 + i)
            card_logits.append(lc)
        got = {k: build.LAUNCHES[k] - before[k]
               for k in ("ssm_scan", "rmsnorm", "flash_attention")}
        if got != {"ssm_scan": 2 * 9, "rmsnorm": 3 * 9,
                   "flash_attention": 0}:
            raise AssertionError(f"the reduced {MAMBA} on the card launched "
                                 f"{got}")
        # no bf16 cache with float32 parameters here (the state is float32
        # and the conv window takes x's dtype), so decode is held to the
        # parameters' tolerance too
        errs = [close(c, h, tol, f"{MAMBA} logits {dtype} step {i}")
                for i, (c, h) in enumerate(zip(card_logits, host_logits))]
        for key in ("state", "conv"):
            if cc["l0_mamba"][key].dtype != ch["l0_mamba"][key].dtype:
                raise AssertionError(f"cache {key}: "
                                     f"{cc['l0_mamba'][key].dtype} on the "
                                     f"card, {ch['l0_mamba'][key].dtype} "
                                     f"on the host")
            errs.append(close(cc["l0_mamba"][key], ch["l0_mamba"][key], tol,
                              f"{MAMBA} cache {key} {dtype}"))
        build.LAUNCHES.update(before)
        log(f"Mamba card vs host: reduced {MAMBA} (2 layers) {dtype}, 2 x "
            f"100 prompt: prefill logits max|err| {errs[0]:.3e}, 8 "
            f"teacher-forced decode steps {max(errs[1:9]):.3e}, state and "
            f"conv caches {max(errs[9:]):.3e} (tolerance rtol {tol['rtol']}"
            f" + atol {tol['atol']})")



def glm_launches(cfg, n_requests: int) -> dict:
    """What glm4-9b dictates: one flash launch per layer and prefill, one
    rmsnorm per norm (two a layer and the final one) and forward."""
    return {"flash_attention": cfg.num_layers * n_requests,
            "rmsnorm": (2 * cfg.num_layers + 1) * (1 + NEW_TOKENS)
            * n_requests, "ssm_scan": 0}


def mamba_launches(cfg, n_requests: int) -> dict:
    """What falcon-mamba-7b dictates: one scan and one rmsnorm per layer
    and forward (prefill and every decode step), the final rmsnorm, no
    attention."""
    forwards = (1 + NEW_TOKENS) * n_requests
    return {"ssm_scan": cfg.num_layers * forwards,
            "rmsnorm": (cfg.num_layers + 1) * forwards,
            "flash_attention": 0}


def serve_phase(dev, card: str, arch: str, requests, dictates,
                trace_out: str | None, trace: bool) -> dict:
    """Full-width ``arch`` answers ``requests`` through
    ServeEngine.generate; the launch counts are reset just before and read
    just after, and must equal ``dictates(cfg, len(requests))``."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import build
    from repro_torch.serve import ServeEngine
    cfg = ARCHS[arch]
    t0 = time.perf_counter()
    engine = ServeEngine(cfg, max_len=max(s for _, s in requests)
                         + NEW_TOKENS + 4, device=dev)
    engine.init_params(0)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(p.numel() for p in engine.model.parameters())
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
               for b, s in requests]
    torch.cuda.reset_peak_memory_stats(dev)
    build.reset_launches()
    results = []
    for tokens in prompts:
        before = dataclasses.replace(engine.stats)
        t0 = time.perf_counter()
        out = engine.generate({"tokens": tokens}, NEW_TOKENS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        b, s = tokens.shape
        if out.shape != (b, NEW_TOKENS) or out.min() < 0 or \
                out.max() >= cfg.vocab_size:
            raise AssertionError(f"request {b} x {s}: tokens {out.shape} "
                                 f"out of range [{out.min()}, {out.max()}]")
        first = engine.stats.first_token_s - before.first_token_s
        rest = engine.stats.next_tokens_s - before.next_tokens_s
        results.append(dict(batch=b, prompt=s, wall_s=wall,
                            first_token_ms=first * 1e3,
                            decode_ms_per_step=rest / (NEW_TOKENS - 1) * 1e3,
                            tokens_per_s=b * NEW_TOKENS / (first + rest),
                            first_tokens=out[:, :4].tolist()))
    want = dictates(cfg, len(requests))
    launches = {k: build.LAUNCHES[k] for k in want}
    peak = torch.cuda.max_memory_allocated(dev)
    if launches != want:
        raise AssertionError(f"{arch} serving path launches {launches}, the "
                             f"model dictates {want}")
    log(f"serving path [{card}]: {arch} full width, {n_params} parameters "
        f"(bf16), seeded init {t_init:.3f} s; launches {json.dumps(launches)}"
        f"; peak memory {peak / 2**30:.3f} GiB")
    for r in results:
        log(f"  request {r['batch']} x {r['prompt']} -> {NEW_TOKENS} tokens "
            f"[{card}]: first token {r['first_token_ms']:.3f} ms, decode "
            f"{r['decode_ms_per_step']:.3f} ms/step, {r['tokens_per_s']:.2f} "
            f"tokens/s, wall {r['wall_s']:.3f} s")
    if trace:
        trace_serve(engine, prompts[0], card, trace_out)
    return dict(requests=results, launches=launches, peak_bytes=peak,
                n_params=n_params, init_s=t_init)


def trace_serve(engine, tokens, card: str, out: str | None) -> None:
    """One more request under ``torch.profiler``: device busy share and
    device time by kernel (table in ``out/trace_serve_<arch>.txt``)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.generate({"tokens": tokens}, NEW_TOKENS)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
    ka = prof.key_averages()
    kernels = [e for e in ka
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    shares = {}
    for e in kernels:
        name = e.key.lower()
        group = ("flash_attention" if "fa_bf16" in name else
                 "rmsnorm" if "rmsnorm" in name else
                 "ssm_scan decode" if "ssm_scan_step" in name else
                 "ssm_scan" if "ssm_scan" in name else
                 "gemm" if any(t in name for t in ("gemm", "xmma", "cutlass",
                                                    "gemv", "splitk",
                                                    "nvjet")) else
                 "other")
        shares[group] = shares.get(group, 0.0) + e.self_device_time_total
    parts = ", ".join(f"{k} {v / 1e3:.3f} ms ({v / device_us:.1%})"
                      for k, v in sorted(shares.items(), key=lambda x: -x[1]))
    log(f"trace serve {engine.cfg.name} [{card}]: request "
        f"{tokens.shape[0]} x {tokens.shape[1]} -> {NEW_TOKENS} tokens in "
        f"{elapsed:.3f} s under the profiler, device busy {device_us / 1e6:.3f} s = "
        f"{device_us / 1e6 / elapsed:.2%}; by kernel: {parts}")
    if out is not None:
        with open(os.path.join(out, f"trace_serve_{engine.cfg.name}.txt"),
                  "w") as f:
            f.write(f"{card}\n{elapsed:.3f} s traced, device busy "
                    f"{device_us / 1e6:.3f} s\n{parts}\n\n"
                    f"{ka.table(sort_by='self_device_time_total', row_limit=25)}"
                    f"\n")


# ---------------------------------------------------------------------------
# phase 12: the session path (MinosSession, its store, the fleet's failures)
# ---------------------------------------------------------------------------
SESSION_BUDGET_FRACTION = 0.75     # the benches' oversubscription target
CHAOS_CHUNK_SAMPLES = 100          # bench_chaos / bench_recovery chunks
RECOVERY_FAIL_FRACTION = 0.40      # bench_recovery: fail at 40 % of chunks
RECOVERY_CRASH_FRACTION = 0.55     # ... and SIGKILL at 55 %
ONLINE_FRACTIONS = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0)
# journal records between snapshots in the 10,000-job stored run: its
# ~20,000 records (admits and decisions) give two cadence snapshots, where
# the store's default of 25 would write ~800 snapshots of up to 10,000 jobs
SCALE_SNAPSHOT_EVERY = 10_000


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def take_launches() -> dict:
    """The profiling kernels' launch counts since the last call, which
    sets them to 0 again (every part of the phase starts from 0)."""
    from repro_torch.kernels import build
    got = {k: build.LAUNCHES[k] for k in ("spike_hist", "ema_scan")}
    build.reset_launches()
    return got


def micro_streams():
    from repro_torch.telemetry import kernel_stream as ks
    return [ks.micro_gemm(), ks.micro_spmv_memory(), ks.micro_spmv_compute(),
            ks.micro_idle_burst(), ks.micro_stencil()]


def micro_library(device, target_duration: float):
    """The benches' smoke library: the five micro streams at 0.6/0.8/1.0."""
    from repro_torch.api import (ReferenceLibrary, TPUPowerModel,
                                 stream_profile_workload)
    model = TPUPowerModel()
    return ReferenceLibrary(
        (stream_profile_workload(s, model, (0.6, 0.8, 1.0), model.spec.tdp_w,
                                 seed=i, target_duration=target_duration,
                                 device=device)
         for i, s in enumerate(micro_streams())),
        built_on=model.spec.name, device=device)


def smoke_assignment(counts: dict, jobs):
    """The benches' round-robin placement on a seeded variability-on
    inventory and their 75 %-of-nameplate budget."""
    from repro_torch.api import DeviceInventory, VariabilityModel
    inventory = DeviceInventory.generate(counts, VariabilityModel(), seed=7)
    assigned = [(s, chips, inventory[i % len(inventory)])
                for i, (s, chips) in enumerate(jobs)]
    nameplate = sum(chips * dev.nameplate_w for _, chips, dev in assigned)
    return inventory, assigned, SESSION_BUDGET_FRACTION * nameplate


def sustained_violations(report, assigned, inventory, budget, seed0: int,
                         target_duration: float, job_id) -> tuple[int, float]:
    """The benches' ground truth: every placed job re-simulated at its cap
    on its final device, the time-aligned aggregate's 50-sample rolling
    mean held to the budget.  Returns (violations, peak sustained W)."""
    from repro_torch.api import simulate
    placed = {p.job_id: p for p in report.schedule.placed}
    traces = []
    for i, (stream, _, _) in enumerate(assigned):
        plan = placed.pop(job_id(i, stream), None)
        if plan is None:
            continue
        dev = inventory.get(plan.device_id)
        tr = simulate(stream, plan.cap, dev.power_model(), seed=seed0 + i,
                      target_duration=target_duration)
        traces.append(plan.chips * tr.power_filtered)
    if placed:
        raise AssertionError(f"unmatched placed plans: {sorted(placed)}")
    n = max(len(t) for t in traces)
    agg = np.sum([np.resize(t, n) for t in traces], axis=0)
    sustained = np.convolve(agg, np.ones(SUSTAIN_WINDOW) / SUSTAIN_WINDOW,
                            mode="valid")
    return int(np.sum(sustained > budget)), float(sustained.max())


def short_id(i: int, stream) -> str:
    return f"j{i:02d}:{stream.name}"


def session_fleet_smoke(device) -> dict:
    """``bench_fleet.py --smoke`` through the port's ``MinosSession``."""
    from repro_torch.api import MinosSession
    streams = micro_streams()
    lib = micro_library(device, 1.0)
    inventory, assigned, budget = smoke_assignment(
        {"tpu-v5e": 2, "tpu-v5p": 1},
        [(s, 4 * (i % 3 + 1)) for i, s in enumerate(streams)])
    take_launches()
    session = MinosSession(lib, inventory=inventory, budget_w=budget,
                           objective="powercentric", quantile="p99",
                           min_confidence=0.2, device=device)
    for i, (stream, chips, dev) in enumerate(assigned):
        session.submit(stream, device=dev, chips=chips,
                       job_id=short_id(i, stream), seed=500 + i,
                       target_duration=1.0)
    report = session.run()
    sync(device)
    launches = take_launches()
    violations, _ = sustained_violations(report, assigned, inventory, budget,
                                         500, 1.0, short_id)
    return dict(early_decisions=report.early_decisions,
                repacks=report.repacks, chunks_dropped=report.chunks_dropped,
                placed=len(report.schedule.placed),
                deferred=len(report.schedule.deferred),
                planned_power_w=round(report.schedule.planned_power_w, 1),
                budget_violations=violations, launches=launches)


def chaos_schedule(total_chunks: int, assigned, seed: int):
    """bench_chaos's seeded schedule: kill one loaded device a quarter of
    the way in, degrade another at half, restore the first at 70 %, kill a
    second at 80 %."""
    rng = np.random.default_rng(seed)
    loaded = sorted({dev.device_id for _, _, dev in assigned})
    victims = [loaded[int(rng.integers(len(loaded)))]]
    rest = [d for d in loaded if d not in victims]
    degraded = rest[int(rng.integers(len(rest)))]
    second = [d for d in rest if d != degraded]
    victims.append(second[int(rng.integers(len(second)))])
    return [(int(0.25 * total_chunks), "fail", victims[0]),
            (int(0.50 * total_chunks), "degrade", degraded),
            (int(0.70 * total_chunks), "restore", victims[0]),
            (int(0.80 * total_chunks), "fail", victims[1])]


def session_chaos_smoke(device) -> dict:
    """``bench_chaos.py --smoke`` through the port's ``MinosSession``:
    seeded fail / degrade / restore / fail mid-stream, the mid-profile
    migrants re-profiled, then the session drained (its straggler monitor
    sends the drain down the per-chunk path).  Returns the counts, the
    session, and the launches of the drain after the re-profiling."""
    from repro_torch.api import (FleetTelemetryMux, MinosSession,
                                 StragglerMonitor, count_classifier_calls,
                                 stream_telemetry)
    streams = micro_streams()
    lib = micro_library(device, 1.0)
    inventory, assigned, budget = smoke_assignment(
        {"tpu-v5e": 3, "tpu-v5p": 2},
        [(s, 4 * (i % 3 + 1)) for i, s in enumerate(streams)])
    take_launches()
    session = MinosSession(lib, inventory=inventory, budget_w=budget,
                           objective="powercentric", quantile="p99",
                           min_confidence=0.2,
                           stragglers=StragglerMonitor(), device=device)
    mux = FleetTelemetryMux()
    handles = {}
    for i, (stream, chips, dev) in enumerate(assigned):
        meta, chunks = stream_telemetry(
            stream, 1.0, dev.power_model(), seed=700 + i,
            target_duration=1.0, chunk_samples=CHAOS_CHUNK_SAMPLES,
            device_id=dev.device_id)
        handle = session.submit(meta, device=dev, chips=chips,
                                job_id=short_id(i, stream))
        handles[handle.job_id] = handle
        mux.add_job(handle.job_id, meta, chunks)
    total = sum(-(-h.meta.n_samples // CHAOS_CHUNK_SAMPLES)
                for h in handles.values())
    pending = chaos_schedule(total, assigned, seed=23)
    calls = count_classifier_calls(session.classifier)
    chaos_calls = 0
    failed_now: set[str] = set()

    def apply(action, device_id):
        nonlocal chaos_calls
        n0 = calls["n"]
        if action == "fail":
            session.fail_device(device_id)
            mux.drop_device(device_id)
            failed_now.add(device_id)
        elif action == "degrade":
            session.degrade_device(device_id)
        else:
            session.restore_device(device_id)
            failed_now.discard(device_id)
        chaos_calls += calls["n"] - n0

    for n, fchunk in enumerate(mux):
        while pending and n >= pending[0][0]:
            apply(*pending.pop(0)[1:])
        if fchunk.device_id in failed_now:
            continue
        handles[fchunk.job_id].feed(fchunk.chunk)
    for _, action, device_id in pending:
        apply(action, device_id)
    reprofiled = 0
    for i, (stream, _, _) in enumerate(assigned):
        handle = handles[short_id(i, stream)]
        if not handle.decided and handle.fraction == 0.0:
            handle.reprofile(stream, seed=900 + i, target_duration=1.0,
                             chunk_samples=CHAOS_CHUNK_SAMPLES)
            reprofiled += 1
    sync(device)
    before_restart = take_launches()
    report = session.run()
    sync(device)
    after_restart = take_launches()
    violations, _ = sustained_violations(report, assigned, inventory, budget,
                                         700, 1.0, short_id)
    return dict(failures=report.failures, migrations=report.migrations,
                reprofiled_jobs=reprofiled, repacks=report.repacks,
                placed=len(report.schedule.placed),
                deferred=len(report.schedule.deferred),
                planned_power_w=round(report.schedule.planned_power_w, 1),
                classifier_calls_chaos=chaos_calls,
                budget_violations=violations,
                device_health=session.device_health,
                launches={k: before_restart[k] + after_restart[k]
                          for k in before_restart},
                launches_after_restart=after_restart, session=session)


def recovery_setup(device):
    """bench_recovery's smoke scenario, identical in the crashing child
    and the resuming parent."""
    streams = micro_streams()
    lib = micro_library(device, 1.0)
    inventory, assigned, budget = smoke_assignment(
        {"tpu-v5e": 3, "tpu-v5p": 2},
        [(s, 4 * (i % 3 + 1)) for i, s in enumerate(streams)])
    return lib, inventory, assigned, budget


def recovery_child(store: str, device) -> None:
    """The crash target: drive the durable session, fail the first job's
    device at 40 % of the chunks, SIGKILL this process at 55 %."""
    import signal
    from repro_torch.api import (FleetTelemetryMux, MinosSession,
                                 stream_telemetry)
    lib, inventory, assigned, budget = recovery_setup(device)
    session = MinosSession(lib, inventory=inventory, budget_w=budget,
                           min_confidence=0.2, store=store, device=device)
    mux = FleetTelemetryMux()
    handles = {}
    for i, (stream, chips, dev) in enumerate(assigned):
        meta, chunks = stream_telemetry(
            stream, 1.0, dev.power_model(), seed=700 + i,
            target_duration=1.0, chunk_samples=CHAOS_CHUNK_SAMPLES,
            device_id=dev.device_id)
        handle = session.submit(meta, device=dev, chips=chips,
                                job_id=short_id(i, stream))
        handles[handle.job_id] = handle
        mux.add_job(handle.job_id, meta, chunks)
    total = sum(-(-h.meta.n_samples // CHAOS_CHUNK_SAMPLES)
                for h in handles.values())
    fail_at = int(RECOVERY_FAIL_FRACTION * total)
    crash_at = int(RECOVERY_CRASH_FRACTION * total)
    victim = assigned[0][2].device_id
    failed = False
    for n, fchunk in enumerate(mux):
        if n >= crash_at:
            sync(device)
            os.kill(os.getpid(), signal.SIGKILL)     # the crash under test
        if not failed and n >= fail_at:
            session.fail_device(victim)
            mux.drop_device(victim)
            failed = True
        if failed and fchunk.device_id == victim:
            continue
        handles[fchunk.job_id].feed(fchunk.chunk)
    raise AssertionError("stream drained before the scheduled crash")


def session_recovery_smoke(device, workdir: str) -> dict:
    """``bench_recovery.py --smoke``: a child process drives the port's
    durable session on ``device`` and SIGKILLs itself; this process resumes
    the store on ``device`` with the classifier spied, re-profiles the jobs
    that were mid-profile and drains the session."""
    import signal
    from repro_torch.api import MinosSession, count_classifier_calls
    store = os.path.join(workdir, "recovery-store")
    shutil.rmtree(store, ignore_errors=True)
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--recovery-child",
         store, "--child-device", str(device)], timeout=600)
    if proc.returncode != -signal.SIGKILL:
        raise AssertionError(f"recovery child exited {proc.returncode}, "
                             f"not by SIGKILL")
    lib, inventory, assigned, budget = recovery_setup(device)
    clf = lib.classifier()
    calls = count_classifier_calls(clf)
    t0 = time.perf_counter()
    session = MinosSession.resume(store, references=clf, device=device)
    sync(device)
    resume_ms = (time.perf_counter() - t0) * 1e3
    resume_calls = calls["n"]
    decided = [jid for jid, h in session.jobs.items() if h.decided]
    take_launches()
    reprofiled = 0
    for i, (stream, _, _) in enumerate(assigned):
        handle = session.jobs[short_id(i, stream)]
        if not handle.decided:
            handle.reprofile(stream, seed=900 + i, target_duration=1.0,
                             chunk_samples=CHAOS_CHUNK_SAMPLES)
            reprofiled += 1
    report = session.run()
    session.close()
    sync(device)
    launches = take_launches()
    with open(os.path.join(store, "journal.jsonl"), "rb") as f:
        journal_records = sum(1 for _ in f)
    violations, _ = sustained_violations(report, assigned, inventory, budget,
                                         700, 1.0, short_id)
    return dict(classifier_calls_resume=resume_calls,
                decisions_recovered=len(decided), reprofiled_jobs=reprofiled,
                migrations=report.migrations,
                placed=len(report.schedule.placed),
                deferred=len(report.schedule.deferred),
                planned_power_w=round(report.schedule.planned_power_w, 1),
                budget_violations=violations, resume_ms=resume_ms,
                journal_records=journal_records,
                launches_after_restart=launches)


def session_online_cap(lib, device) -> dict:
    """``bench_online_cap.py``'s full run: each of the 28 zoo workloads
    submitted to one port session (``profile_to_completion``) and fed
    chunk by chunk, Algorithm 1 on the partial profile at each tenth of the
    trace against the completed profile's caps, the confidence gate riding
    along."""
    from repro_torch.api import (MinosSession, TPUPowerModel,
                                 reference_streams, select_optimal_freq,
                                 stream_telemetry)
    model = TPUPowerModel()
    streams = reference_streams()
    take_launches()
    session = MinosSession(lib, objective="powercentric", actuator="none",
                           min_confidence=0.2, device=device)
    clf = session.classifier
    agree = {obj: {f: 0 for f in ONLINE_FRACTIONS}
             for obj in ("powercentric", "perfcentric")}
    rows = []

    def caps(sel):
        return {"powercentric": sel.f_pwr, "perfcentric": sel.f_perf}

    for i, stream in enumerate(streams):
        meta, chunks = stream_telemetry(stream, 1.0, model, seed=1000 + i,
                                        target_duration=4.0)
        job = session.submit(meta, profile_to_completion=True)
        partial, next_f = {}, 0
        for chunk in chunks:
            job.feed(chunk)
            while next_f < len(ONLINE_FRACTIONS) and \
                    job.fraction >= ONLINE_FRACTIONS[next_f] - 1e-12:
                partial[ONLINE_FRACTIONS[next_f]] = caps(
                    select_optimal_freq(job.snapshot(), clf))
                next_f += 1
        gate = job.decision(finalize=False)
        final = caps(select_optimal_freq(job.profile(), clf))
        for f in ONLINE_FRACTIONS[next_f:]:
            partial[f] = final
        conv = {}
        for obj in agree:
            conv_f = 1.0
            for f in reversed(ONLINE_FRACTIONS):
                if partial[f][obj] != final[obj]:
                    break
                conv_f = f
            conv[obj] = conv_f
            for f in ONLINE_FRACTIONS:
                agree[obj][f] += partial[f][obj] == final[obj]
        rows.append({
            "target": meta.name, "final_cap": final, "converged_at": conv,
            "gate_fraction": None if gate is None else round(gate.fraction, 3),
            "gate_confidence": None if gate is None
            else round(gate.confidence, 3),
            "gate_cap_matches": None if gate is None
            else gate.cap == final["powercentric"]})
    sync(device)
    n = len(streams)
    gated = [r for r in rows if r["gate_fraction"] is not None]
    return {
        "agreement_curve": {obj: {str(f): round(agree[obj][f] / n, 4)
                                  for f in ONLINE_FRACTIONS}
                            for obj in agree},
        "agreement_at_half": {obj: round(agree[obj][0.5] / n, 4)
                              for obj in agree},
        "controller_gate": {
            "decided_early": len(gated), "n_targets": n,
            "mean_fraction": round(float(np.mean(
                [r["gate_fraction"] for r in gated])), 3),
            "cap_match_rate": round(float(np.mean(
                [r["gate_cap_matches"] for r in gated])), 3)},
        "per_workload": rows, "launches": take_launches()}


def session_scale(lib, device, store_dir: str | None) -> dict:
    """``bench_fleet_scale``'s 10,000 jobs through ``MinosSession``:
    ``submit_many`` (round-robin over the 64-device inventory) + ``run()``,
    with a journal in ``store_dir`` when given."""
    from repro_torch.api import (DeviceInventory, MinosSession, SessionStore,
                                 VariabilityModel, fleet_job_mix,
                                 stream_telemetry, to_dict)
    inventory = DeviceInventory.generate(FLEET, VariabilityModel.none(),
                                         seed=7)
    jobs = fleet_job_mix(10_000, seed=11)
    assigned = [(s, c, inventory[i % len(inventory)])
                for i, (s, c) in enumerate(jobs)]
    budget = 0.75 * sum(c * d.nameplate_w for _, c, d in assigned)
    seeds = {name: 500 + i for i, name in
             enumerate(sorted({s.name for s, _, _ in assigned}))}
    telemetry = {}
    for stream, _, dev in assigned:
        key = (stream.name, dev.model)
        if key not in telemetry:
            meta, chunks = stream_telemetry(
                stream, 1.0, dev.power_model(), seed=seeds[stream.name],
                target_duration=0.4, chunk_samples=256)
            telemetry[key] = (meta, list(chunks))
    store, snapshots = None, [0]
    if store_dir is not None:
        shutil.rmtree(store_dir, ignore_errors=True)
        store = SessionStore.create(store_dir,
                                    snapshot_every=SCALE_SNAPSHOT_EVERY)
        flush = store.flush_snapshot

        def counted_flush(*args, **kw):
            wrote = flush(*args, **kw)
            snapshots[0] += bool(wrote)
            return wrote
        store.flush_snapshot = counted_flush
    sync(device)
    take_launches()
    t0 = time.perf_counter()
    session = MinosSession(lib, inventory=inventory, budget_w=budget,
                           quantile="p99", store=store, device=device,
                           **GATES)
    session.submit_many(
        [telemetry[(s.name, d.model)] for s, _, d in assigned],
        chips=[c for _, c, _ in assigned],
        job_ids=[f"j{i:05d}:{s.name}" for i, (s, _, _) in
                 enumerate(assigned)])
    report = session.run()
    sync(device)
    elapsed = time.perf_counter() - t0
    fleet = session._fleet
    out = dict(decisions=len(report.decisions),
               early_decisions=report.early_decisions,
               repacks=report.repacks, chunks_dropped=report.chunks_dropped,
               placed=len(report.schedule.placed),
               deferred=len(report.schedule.deferred),
               planned_power_w=report.schedule.planned_power_w,
               jobs_per_s=len(assigned) / elapsed, seconds=elapsed,
               launches=take_launches(),
               state={jid: (to_dict(j.decision), to_dict(j.plan)
                            if j.plan is not None else None)
                      for jid, j in fleet.jobs.items()})
    if store is not None:
        out["journal_records"] = store.journal.last_seq
        session.close()
        out["snapshots_written"] = snapshots[0]
        out["journal_bytes"] = sum(
            os.path.getsize(os.path.join(store_dir, f))
            for f in os.listdir(store_dir) if f.startswith("journal"))
        out["snapshot_files"] = sorted(
            f for f in os.listdir(store_dir) if f.startswith("snapshot"))
        out["snapshot_bytes"] = sum(
            os.path.getsize(os.path.join(store_dir, f))
            for f in out["snapshot_files"])
    return out


def session_scale_resume(lib, device, store_dir: str, live: dict) -> dict:
    """Resume the 10,000-job store on ``device`` with the classifier spied:
    0 calls, every decision and plan equal to the live session's."""
    from repro_torch.api import MinosSession, count_classifier_calls, to_dict
    clf = lib.classifier()
    calls = count_classifier_calls(clf)
    sync(device)
    t0 = time.perf_counter()
    session = MinosSession.resume(store_dir, references=clf, device=device)
    sync(device)
    seconds = time.perf_counter() - t0
    got = {jid: (to_dict(j.decision), to_dict(j.plan)
                 if j.plan is not None else None)
           for jid, j in session._fleet.jobs.items()}
    session.close()
    if calls["n"] != 0:
        raise AssertionError(f"resume of the 10,000-job store classified "
                             f"{calls['n']} times")
    if got != live["state"]:
        bad = [jid for jid in live["state"] if got.get(jid)
               != live["state"][jid]]
        raise AssertionError(f"resumed decisions/plans differ from the "
                             f"live session's for {len(bad)} jobs "
                             f"(first {bad[:3]})")
    return dict(seconds=seconds, classifier_calls=calls["n"],
                jobs=len(got))


def engine_columns_equal(card, host, what: str) -> None:
    """Every column of the engine ``card`` bitwise equal to ``host``'s
    after the same drive (slot recycling after migrations and re-profiles
    included)."""
    for name in ("_hist_all", "_ema_state", "_ema_has", "_energy", "_busy",
                 "_next_index", "_n_pending", "_n_committed", "_seen_busy",
                 "_live", "_tdp"):
        if not torch.equal(getattr(card, name).cpu(), getattr(host, name)):
            raise AssertionError(f"engine column {name} on the card differs "
                                 f"from the host's after {what}")


def check_counts(what: str, got: dict, want: dict, keys) -> None:
    for key in keys:
        if got[key] != want[key]:
            raise AssertionError(f"{what}: {key} is {got[key]!r} through the "
                                 f"port's session, {want[key]!r} in the "
                                 f"reference's results")


def check_launches(what: str, launches: dict) -> None:
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{what}: kernel {name} was not launched")


def session_phase(dev, card: str, lib, want_scale: dict,
                  workdir: str) -> dict:
    """Phase 12: the outcome targets through the port's ``MinosSession`` on
    the card, the 10,000-job session with and without a journal, its
    resume, and the kernels' launches in each part."""
    t_phase = time.perf_counter()
    results = {}
    with open(os.path.join(ROOT, "results", "fleet.json")) as f:
        want = json.load(f)
    got = session_fleet_smoke(dev)
    check_counts("fleet.json", got, want,
                 ("early_decisions", "repacks", "chunks_dropped", "placed",
                  "deferred", "planned_power_w", "budget_violations"))
    check_launches("fleet.json drive", got["launches"])
    results["fleet"] = got
    log(f"session fleet.json smoke: {json.dumps(got)}")

    with open(os.path.join(ROOT, "results", "chaos.json")) as f:
        want = json.load(f)
    got = session_chaos_smoke(dev)
    host = session_chaos_smoke("cpu")
    engine_columns_equal(got.pop("session")._fleet.engine,
                         host.pop("session")._fleet.engine,
                         "the chaos schedule")
    check_counts("chaos.json", got, want,
                 ("failures", "migrations", "reprofiled_jobs", "repacks",
                  "placed", "deferred", "planned_power_w",
                  "classifier_calls_chaos", "budget_violations",
                  "device_health"))
    check_launches("chaos.json drive", got["launches"])
    check_launches("chaos.json drain after the re-profile",
                   got["launches_after_restart"])
    results["chaos"] = got
    log(f"session chaos.json smoke: {json.dumps(got)}; engine columns "
        f"bitwise equal to the host's after the schedule")

    with open(os.path.join(ROOT, "results", "recovery.json")) as f:
        want = json.load(f)
    got = session_recovery_smoke(dev, workdir)
    check_counts("recovery.json", got, want,
                 ("classifier_calls_resume", "decisions_recovered",
                  "reprofiled_jobs", "migrations", "placed", "deferred",
                  "planned_power_w", "budget_violations"))
    check_launches("recovery.json drain after the resume",
                   got["launches_after_restart"])
    results["recovery"] = got
    log(f"session recovery.json smoke: {json.dumps(got)}")

    with open(os.path.join(ROOT, "results", "online_cap.json")) as f:
        want = json.load(f)
    t0 = time.perf_counter()
    got = session_online_cap(lib, dev)
    got["seconds"] = time.perf_counter() - t0
    check_counts("online_cap.json", got, want,
                 ("agreement_curve", "agreement_at_half", "controller_gate",
                  "per_workload"))
    check_launches("online_cap.json drive", got["launches"])
    results["online_cap"] = {k: v for k, v in got.items()
                             if k != "per_workload"}
    log(f"session online_cap.json (28 workloads): "
        f"{json.dumps(results['online_cap'])}")

    scale = {}
    for mode, store_dir in (("plain", None),
                            ("journal", os.path.join(workdir, "scale-store"))):
        got = session_scale(lib, dev, store_dir)
        check_counts(f"fleet_scale.json ({mode})", got, want_scale,
                     ("decisions", "early_decisions", "chunks_dropped",
                      "placed", "deferred"))
        rel = abs(got["planned_power_w"] - want_scale["planned_power_w"]) \
            / want_scale["planned_power_w"]
        if rel > 1e-9:
            raise AssertionError(f"fleet_scale.json ({mode}): planned_power_w"
                                 f" {got['planned_power_w']} (rel {rel:.2e})")
        check_launches(f"10,000-job session ({mode})", got["launches"])
        scale[mode] = got
    if scale["plain"]["state"] != scale["journal"]["state"]:
        raise AssertionError("the journaled 10,000-job session decided "
                             "differently from the plain one")
    resume = session_scale_resume(lib, dev, os.path.join(workdir,
                                                         "scale-store"),
                                  scale["journal"])
    for got in scale.values():
        got.pop("state")
    results["scale"] = dict(scale, resume=resume,
                            snapshot_every=SCALE_SNAPSHOT_EVERY)
    for mode, got in scale.items():
        log(f"session 10,000 jobs ({mode}) [{card}]: "
            f"{got['jobs_per_s']:.1f} jobs/s ({got['seconds']:.3f} s), "
            f"{json.dumps({k: v for k, v in got.items() if k not in ('jobs_per_s', 'seconds')})}")
    log(f"session 10,000-job resume [{card}]: {resume['seconds']:.3f} s, "
        f"{resume['classifier_calls']} classifier calls, {resume['jobs']} "
        f"jobs' decisions and plans equal to the live session's")
    results["launches"] = {
        "fleet": results["fleet"]["launches"],
        "chaos": results["chaos"]["launches"],
        "chaos_after_restart": results["chaos"]["launches_after_restart"],
        "recovery_after_resume": results["recovery"]["launches_after_restart"],
        "online_cap": results["online_cap"]["launches"],
        "scale_plain": scale["plain"]["launches"],
        "scale_journal": scale["journal"]["launches"]}
    log(f"phase 12 launches: {json.dumps(results['launches'])}")
    results["seconds"] = time.perf_counter() - t_phase
    log(f"phase 12 (session path): {results['seconds']:.3f} s [{card}]")
    return results


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", action="store_true",
                    help="one more fleet drive and one more request of each "
                         "served model under torch.profiler")
    ap.add_argument("--out", default=None,
                    help="directory for chip_smoke.json / trace_summary.txt")
    ap.add_argument("--ssm-kernel-only", action="store_true",
                    help="build the kernels and run phase 9 alone (checks, "
                         "timings, ssm_scan's ptxas and SASS report); "
                         "prints no result line")
    ap.add_argument("--fleet-kernels-only", action="store_true",
                    help="build the kernels and run phase 3 alone (checks, "
                         "timings, the builder commit and its device ops, "
                         "the divide diagnostic); prints no result line")
    ap.add_argument("--lm-kernels-only", action="store_true",
                    help="build the kernels and run phase 6 alone (checks, "
                         "timings, the flash library's ptxas and SASS "
                         "report); prints no result line")
    ap.add_argument("--session-only", action="store_true",
                    help="build the kernels and the 28-workload library and "
                         "run phase 12 alone (the session path); prints no "
                         "result line")
    ap.add_argument("--recovery-child", metavar="STORE",
                    help=argparse.SUPPRESS)   # phase 12's crash target
    ap.add_argument("--child-device", default="cuda",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.recovery_child:
        recovery_child(args.recovery_child, resolve_device(args.child_device))
        return 1                              # unreachable: SIGKILL
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(card)
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    from repro_torch.kernels import build
    shutil.rmtree(build.build_dir(), ignore_errors=True)
    t0 = time.perf_counter()
    build.build_all()
    log(f"kernel build: {time.perf_counter() - t0:.3f} s "
        f"(every source in parallel, nvcc sm_90a) [{card}]")
    for key, report in build.BUILD_INFO.items():
        if key.endswith("_ptxas"):      # registers / smem / spills per kernel
            for line in str(report).splitlines():
                if "Used" in line or "spill" in line:
                    log(f"  {key[:-6]}: {line.strip()}")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    if args.out is not None:
        os.makedirs(args.out, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False    # float32 stays float32
    torch.backends.cudnn.allow_tf32 = False

    if args.fleet_kernels_only:
        kp = kernel_phase(dev, flush)
        kp["builder_commit_ops"] = builder_commit_ops(dev, card)
        kp["ema_call_ops"] = ema_call_ops(dev, card)
        if args.out is not None:
            with open(os.path.join(args.out, "fleet_kernels.json"), "w") as f:
                json.dump({"card": card, "fleet_kernels": kp}, f, indent=1)
        log("phase 3 alone (--fleet-kernels-only): no result line")
        return 0
    if args.lm_kernels_only:
        lp = lm_kernel_phase(dev, flush, card)
        if args.out is not None:
            with open(os.path.join(args.out, "lm_kernels.json"), "w") as f:
                json.dump({"card": card, "lm_kernels": lp}, f, indent=1)
        log("phase 6 alone (--lm-kernels-only): no result line")
        return 0
    if args.ssm_kernel_only:
        ssp = ssm_kernel_phase(dev, flush, card)
        if args.out is not None:
            with open(os.path.join(args.out, "ssm_kernel.json"), "w") as f:
                json.dump({"card": card, "ssm_kernel": ssp}, f, indent=1)
        log("phase 9 alone (--ssm-kernel-only): no result line")
        return 0
    workdir = tempfile.mkdtemp(prefix="chip-smoke-")
    try:
        return run_phases(args, dev, card, kind, flush, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def run_phases(args, dev, card: str, kind: str, flush: torch.Tensor,
               workdir: str) -> int:
    """Phases 3-12 (the whole run, or phase 12 alone with
    ``--session-only``); prints the result lines."""
    with open(os.path.join(ROOT, "results", "fleet_scale.json")) as f:
        want = json.load(f)
    if args.session_only:
        from repro_torch.pipeline import build_reference_library
        from repro_torch.telemetry import TPUPowerModel
        lib = build_reference_library(TPUPowerModel(), target_duration=3.0,
                                      device=dev)
        ses = session_phase(dev, card, lib, want, workdir)
        if args.out is not None:
            with open(os.path.join(args.out, "session.json"), "w") as f:
                json.dump({"card": card, "session": ses}, f, indent=1)
        log("phase 12 alone (--session-only): no result line")
        return 0
    kp = kernel_phase(dev, flush)
    # the first profiler session of the process: a later one (after the
    # serving traces) recorded no device activity for these small launches
    commit_ops = builder_commit_ops(dev, card) if args.trace else None
    ema_ops = ema_call_ops(dev, card) if args.trace else None
    lp = lm_kernel_phase(dev, flush, card)
    ssp = ssm_kernel_phase(dev, flush, card)
    card_vs_host_phase(dev)
    lm_card_vs_host_phase(dev)
    mamba_card_vs_host_phase(dev)
    lib, mp = main_path(dev, want)
    log(f"fleet timings [{card}]: library {mp['library_s']:.3f} s, admit "
        f"{mp['admit_s']:.3f} s, run {mp['run_s']:.3f} s (of it: engine "
        f"per-row loop {mp['row_loop_s']:.3f} s, packing "
        f"{mp['repack_s']:.3f} s), {mp['jobs_per_s']:.1f} jobs/s, ground "
        f"truth {mp['truth_s']:.3f} s")
    ses = session_phase(dev, card, lib, want, workdir)
    log(f"session vs direct controller [{card}]: 10,000 jobs at "
        f"{ses['scale']['plain']['jobs_per_s']:.1f} jobs/s (no journal), "
        f"{ses['scale']['journal']['jobs_per_s']:.1f} jobs/s (journal), "
        f"phase 5's controller {mp['jobs_per_s']:.1f} jobs/s")
    sp = serve_phase(dev, card, GLM, REQUESTS, glm_launches, args.out,
                     args.trace)
    torch.cuda.empty_cache()        # the glm4-9b engine is gone: release it
    msp = serve_phase(dev, card, MAMBA, MAMBA_REQUESTS, mamba_launches,
                      args.out, args.trace)
    torch.cuda.empty_cache()

    # kernel records: bounds from this run's inputs
    sh = kp["spike_hist"]
    rows, cols = sh["shape"]
    hist_bytes = sh["numel"] * 8 + rows * sum(
        int(round(1.5 / c)) for c in BINS) * 4
    hist_ops = sh["numel"] + sh["n_spike"] * (1 + len(BINS))
    hist_bound = max(hist_bytes / HBM_BYTES_PER_S,
                     hist_ops / PEAK_OPS["f64"]) * 1e3
    ema_n = mp["ema_n"]               # the main path's median trace length
    t_ema, t_ema_plain, err_ema = time_ema(dev, flush, ema_n)
    ema_bound = max(ema_n * 8 / HBM_BYTES_PER_S,
                    ema_n * 3 / PEAK_OPS["f32"]) * 1e3
    eb = kp["ema_blocks"]             # the engine's group advance leads
    kernels = [
        {"name": "spike_hist", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/spike_hist.cu",
         "replaces": "src/repro/kernels/spike_hist.py:92",
         "launches": mp["launches"]["spike_hist"], "max_abs_err": sh["err"],
         "ms": sh["ms"], "plain_ms": sh["plain_ms"], "bound_ms": hist_bound,
         "bound_by": "bytes", "library_ms": None},
        {"name": "ema_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ema_scan.cu",
         "replaces": "src/repro/kernels/ema_scan.py:49",
         "launches": mp["launches"]["ema_scan"],
         "max_abs_err": max(kp["ema_scan"]["err"], err_ema),
         "ms": eb["group"]["ms"], "plain_ms": eb["group"]["plain_ms"],
         "bound_ms": eb["group"]["bound_ms"], "bound_by": "bytes",
         "library_ms": None, "shape": eb["group"]["shape"],
         "launches_by_stage": mp["ema_launches"],
         "shapes": [dict(form=k, **{f: eb[k][f] for f in
                                    ("shape", "ms", "composed_ms", "plain_ms",
                                     "bound_ms")})
                    for k in ("group", "snapshot", "ingest")],
         "f32": {"n": ema_n, "ms": t_ema, "plain_ms": t_ema_plain,
                 "bound_ms": ema_bound}},
    ]
    for name, replaces in (
            ("flash_attention", "src/repro/kernels/flash_attention.py:68"),
            ("rmsnorm", "src/repro/kernels/rmsnorm.py:18")):
        r = lp[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces, "launches": sp["launches"][name],
            "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
    for rec in kernels[:2]:             # phase 12's parts, counted apart
        rec["launches_session"] = {part: n[rec["name"]] for part, n in
                                   ses["launches"].items()}
    kernels[2]["shapes"] = [            # flash at every timed prefill shape
        {k: r[k] for k in ("b", "s", "ms", "library_ms", "bound_ms",
                           "bound_by")}
        for r in lp["flash_attention"]["shapes"]]
    pre = ssp["prefill"]              # the first request's prefill scan
    kernels.append({
        "name": "ssm_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssm_scan.cu",
        "replaces": "src/repro/kernels/ssm_scan.py:51",
        "launches": msp["launches"]["ssm_scan"], "max_abs_err": ssp["err"],
        "ms": pre["ms"], "plain_ms": pre["plain_ms"],
        "bound_ms": pre["bound_ms"], "bound_by": pre["bound_by"],
        "library_ms": None})
    log(f"spike_hist f64 {rows}x{cols}, 6 bin sizes [{card}]: kernel "
        f"{sh['ms']:.4f} ms (L2 flushed; {sh['warm_ms']:.4f} ms warm), plain "
        f"{sh['plain_ms']:.4f} ms, bound {hist_bound:.4f} ms "
        f"({hist_bytes} B)")
    log(f"ema_scan f32 n={ema_n} [{card}]: kernel {t_ema:.4f} ms, plain "
        f"{t_ema_plain:.4f} ms, bound {ema_bound:.6f} ms")
    for k in ("group", "snapshot", "ingest"):
        log(f"ema_scan f64 blocks, {k} {eb[k]['shape']} [{card}]: kernel "
            f"{eb[k]['ms']:.4f} ms, old composition {eb[k]['composed_ms']:.4f}"
            f" ms, bound {eb[k]['bound_ms']:.6f} ms")
    fleet_trace = dict(trace_phase(lib, dev, card, args.out),
                       builder_commit=commit_ops,
                       ema_call_ops=ema_ops) if args.trace else None
    if args.out is not None:
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump({"card": card, "kernels": kernels, "main_path": mp,
                       "session": ses, "fleet_trace": fleet_trace,
                       "lm_kernels": lp, "serve": sp, "ssm_kernel": ssp,
                       "serve_mamba": msp}, f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
