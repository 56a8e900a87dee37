"""Time variants of the port's CUDA kernels on one NVIDIA GPU.

    python3 tools/kernel_variants.py tools/kernel_variants.json --out DIR

The JSON file maps a kernel source (``rmsnorm``, ``spike_hist``,
``ssm_scan``, ``ema_scan``) to named lists of text substitutions of
``src/repro_torch/kernels/csrc/<source>.cu``
(``{"rmsnorm": {"name": [[old, new], ...]}}``), or to
``{"subs": [...], "set": {"_NAME": value}}`` to also set constants of the
kernel's Python module (``repro_torch.kernels.<source>``, e.g. a layout
threshold) for that variant; the unmodified source runs as ``base``.  A
variant that needs code the shipped source lacks carries it in its
substitution text.  Each source's variants are built at once with the
port's nvcc flags (``chip_smoke.build_variants``), swapped in as the
library behind the port's wrapper, checked against the plain version at
every case (a variant that changes the result is marked WRONG, which is
what a diagnostic variant is for) and timed twice, in turns, with
``chip_smoke.cuda_time_ms`` (L2 flushed before each call) at the shapes of
the serving path (rmsnorm: glm4-9b's prefill and decode rows; ssm_scan:
falcon-mamba-7b's prefill (4, 1024) and (1, 2048) and a decode step) and
of the fleet path (spike_hist: the engine's blocks, ``ops.spike_hist``'s
trace and a builder commit; ema_scan: the blocked float64 EMA's group
advance, snapshot and builder ingest, ``chip_smoke.ema_forms``, and rows
of 16 blocks).  ``--sources`` runs only the named sources of the file.  ``F.rms_norm``, a ``zero_`` of a (4, 4096)
tensor (the timing's floor) and a ``copy_`` of (4000, 4096) bf16 (the
bytes of the prefill norm) are timed once, and the SM clock is read while
each source's base runs its first case.  Results go to
``DIR/kernel_variants.json``.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.core import spikes  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import (rmsnorm_plain, rmsnorm_rows,  # noqa: E402
                                 spike_hist_batch, spike_hist_batch_plain,
                                 ssm_scan_plain)
from repro_torch.kernels.ssm_scan import ssm_scan_bsd  # noqa: E402

D = 4096
RMSNORM_ROWS = (4000, 2048, 256, 4, 1)   # glm4-9b's prefill and decode rows


def rmsnorm_cases(dev):
    """(label, run, check) at glm4-9b's width in bfloat16."""
    g = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn((4000, D), generator=g, device=dev).to(torch.bfloat16)
    sc = (1 + 0.1 * torch.randn(D, generator=g, device=dev)).to(
        torch.bfloat16)
    cases = []
    for n in RMSNORM_ROWS:
        xn = x[:n].contiguous()
        want = rmsnorm_plain(xn, sc)

        def run(xn=xn):
            return rmsnorm_rows(xn, sc, 1e-5)

        def ok(run=run, want=want):
            return bool(torch.allclose(
                run().float(), want.float(),
                **cs.KERNEL_TOL[torch.bfloat16]))
        cases.append((f"({n}, {D})", run, ok))
    return cases


def spike_hist_cases(dev):
    """(label, run, check): the engine's blocks, ops.spike_hist's single
    float32 trace, and a builder commit (divisor and out)."""
    rng = np.random.default_rng(0)
    nb = tuple(spikes.num_bins(c) for c in cs.BINS)
    cases = []
    for rows, cols, dtype, sizes, counts in (
            (10_000, 256, torch.float64, cs.BINS, nb),
            (300, 256, torch.float64, cs.BINS, nb),
            (1, 4000, torch.float32, (0.1,), (15,))):
        r = rng.uniform(0.0, 2.5, (rows, cols))
        r[rng.random(r.shape) < 0.05] = -np.inf
        edges = cs.edge_values().numpy()
        r.reshape(-1)[:min(len(edges), r.size)] = edges[:r.size]
        t = torch.from_numpy(r).to(dev, dtype)
        want = spike_hist_batch_plain(t, sizes, counts)

        def run(t=t, sizes=sizes, counts=counts):
            return spike_hist_batch(t, sizes, counts)

        def ok(run=run, want=want):
            return bool(torch.equal(run(), want))
        cases.append((f"({rows}, {cols}) {str(dtype)[6:]}", run, ok))
    arr = torch.from_numpy(rng.uniform(0.0, 400.0, 256)).to(dev)
    tdp = spikes.scalar(197.0, arr)
    hist = torch.zeros(sum(nb), dtype=torch.float64, device=dev)

    def commit():
        return spike_hist_batch(arr[None, :], cs.BINS, nb, divisor=tdp,
                                out=hist[None, :])

    def commit_ok():
        h = torch.zeros_like(hist)
        spike_hist_batch(arr[None, :], cs.BINS, nb, divisor=tdp,
                         out=h[None, :])
        return bool(torch.equal(h, spike_hist_batch_plain(
            arr[None, :] / tdp, cs.BINS, nb)[0].to(torch.float64)))
    cases.append(("commit (1, 256) float64", commit, commit_ok))
    return cases


def ssm_scan_cases(dev):
    """(label, run, check) at falcon-mamba-7b's width (d_inner 8192,
    d_state 16): prefill with x bf16, dt float32 and no skip term, as the
    model calls it, and a decode step (4, 1) with h_out = h0."""
    di, ds = 8192, 16
    cases = []
    for b, s, xdt in ((4, 1024, torch.bfloat16), (1, 2048, torch.bfloat16),
                      (4, 1, torch.float32)):
        ins, h0 = cs.scan_inputs(dev, b, s, di, ds, xdt, torch.float32, 50,
                                 h0=s == 1)
        if s > 1:
            ins[5] = None
        y_p, h_p = ssm_scan_plain(*ins, h0=h0)
        state = None if h0 is None else h0.clone()

        def run(ins=ins, state=state):     # decode advances state in place
            if state is None:
                return ssm_scan_bsd(*ins)
            return ssm_scan_bsd(*ins, h0=state, h_out=state)

        def ok(run=run, y_p=y_p, h_p=h_p, xdt=xdt, h0=h0, state=state):
            if state is not None:
                state.copy_(h0)
            y, h = run()
            return bool(torch.allclose(y.float(), y_p.float(),
                                       **cs.SSM_TOL[xdt])
                        and torch.allclose(h, h_p,
                                           **cs.SSM_TOL[torch.float32]))
        cases.append((f"({b}, {s})", run, ok))
    return cases


def ema_scan_cases(dev):
    """(label, run, check): the blocked float64 EMA's three main-path forms
    (``chip_smoke.ema_forms``) and (300, 4096) rows of 16 blocks each (what
    the next block's prefetch is for); the check is phase 3's exact
    comparison with the plain twin (``chip_smoke.ema_blocks_check``)."""
    from repro_torch.kernels import ema_scan_blocks
    rng = np.random.default_rng(31)
    big = torch.from_numpy(rng.uniform(0.0, 400.0, (300, 4096))).to(dev)

    def ok():
        try:
            return cs.ema_blocks_check(dev) > 0
        except AssertionError:
            return False
    forms = cs.ema_forms(dev)
    cases = [(f"{name} {f['shape']}", f["kernel"], ok if i == 0 else
              (lambda: True)) for i, (name, f) in enumerate(forms.items())]
    cases.append(("(300, 4096)", lambda: ema_scan_blocks(big), lambda: True))
    return cases


def clock_under_load(run) -> str:
    """The SM clock, its maximum and the power draw while ``run`` is
    queued back to back for about half a second."""
    start = time.perf_counter()
    run()
    torch.cuda.synchronize()
    once = max(time.perf_counter() - start, 1e-5)
    for _ in range(min(int(0.5 / once) + 1, 20_000)):
        run()
    time.sleep(0.1)
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    torch.cuda.synchronize()
    return clocks


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", help="JSON file of named substitutions")
    ap.add_argument("--out", default=None, help="directory for the results")
    ap.add_argument("--sources", nargs="*", default=None,
                    help="run only these sources of the file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device available", file=sys.stderr)
        return 1
    with open(args.variants) as f:
        spec = json.load(f)
    if args.sources is not None:
        spec = {k: v for k, v in spec.items() if k in args.sources}
    card = cs.card_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    small = torch.zeros((4, D), device=dev)
    src = torch.zeros((4000, D), device=dev, dtype=torch.bfloat16)
    dst = torch.empty_like(src)
    result = {"card": card,
              "floor_ms": cs.cuda_time_ms(small.zero_, 50, flush),
              "copy_ms": cs.cuda_time_ms(lambda: dst.copy_(src), 50, flush)}
    print(f"floor (zero_ of 4 x {D}, L2 flushed) {result['floor_ms']:.4f} "
          f"ms; copy_ of (4000, {D}) bf16 (rmsnorm's bytes) "
          f"{result['copy_ms']:.4f} ms", flush=True)
    g = torch.Generator(device=dev).manual_seed(9)
    for n in (4000, 2048, 4, 1):
        x = torch.randn((n, D), generator=g, device=dev).to(torch.bfloat16)
        sc = torch.ones(D, device=dev, dtype=torch.bfloat16)
        t = cs.cuda_time_ms(lambda: torch.nn.functional.rms_norm(
            x, (D,), weight=sc, eps=1e-5), 50, flush)
        result[f"rms_norm ({n}, {D})"] = t
        print(f"F.rms_norm ({n}, {D}) bf16 {t:.4f} ms", flush=True)
    makers = {"rmsnorm": rmsnorm_cases, "spike_hist": spike_hist_cases,
              "ssm_scan": ssm_scan_cases, "ema_scan": ema_scan_cases}
    for source, variants in spec.items():
        shipped = build.library(source)
        module = importlib.import_module(f"repro_torch.kernels.{source}")
        settings, subs = {"base": {}}, {}
        for name, spec_v in variants.items():
            if isinstance(spec_v, dict):      # {"subs": [...], "set": {...}}
                subs[name] = spec_v.get("subs", [])
                settings[name] = spec_v.get("set", {})
            else:
                subs[name], settings[name] = spec_v, {}
        built = cs.build_variants(source, {k: v for k, v in subs.items()
                                           if v})
        libs = {"base": shipped, **{name: built.get(name, shipped)
                                    for name in subs}}
        cases = makers[source](dev)
        times = {name: [] for name in libs}
        correct = {}
        for rep in range(2):
            for name, lib in libs.items():
                build._libs[source] = lib
                kept = {k: getattr(module, k) for k in settings[name]}
                for k, v in settings[name].items():
                    setattr(module, k, v)
                try:
                    correct[name] = all(ok() for _, _, ok in cases)
                    row = [cs.cuda_time_ms(run, 30, flush)
                           for _, run, _ in cases]
                finally:
                    build._libs[source] = shipped
                    for k, v in kept.items():
                        setattr(module, k, v)
                times[name].append(row)
                print(f"rep {rep} {source} {name:>24} [{card}]: "
                      + "  ".join(f"{label} {t:.4f}" for (label, _, _), t
                                  in zip(cases, row))
                      + ("" if correct[name] else "  WRONG"), flush=True)
        clocks = clock_under_load(cases[0][1])
        print(f"{source}: SM clock, max clock, power under the base's "
              f"{cases[0][0]}: {clocks}", flush=True)
        result[source] = {"cases": [label for label, _, _ in cases],
                          "ms": times, "correct": correct,
                          "clocks_under_load": clocks}
    if args.out is not None:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "kernel_variants.json"), "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
