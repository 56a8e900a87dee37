"""Time variants of the selective-scan kernel on one NVIDIA GPU.

    python3 tools/ssm_scan_variants.py tools/ssm_scan_variants.json --out DIR

Each variant is ``src/repro_torch/kernels/csrc/ssm_scan.cu`` with a list of
text substitutions (``{"name": [[old, new], ...]}`` in the JSON file); the
unmodified source runs as ``base``.  Every variant is built with the
port's nvcc flags (all in parallel, into ``<build dir>/variants``), checked
against ``ssm_scan_plain`` (a variant that changes the math is marked
WRONG, which is what a diagnostic variant is for), and timed twice, in
turns, at the falcon-mamba-7b serving shapes: prefill (4, 1024) and
(1, 2048) with x bf16, dt float32 and no skip term, and a decode step
(4, 1) with h_out = h0, with ``chip_smoke.cuda_time_ms`` (L2 flushed before
each call).  It also times ``zero_`` of a (4, 8192) tensor, the floor of
that timing, and samples the SM clock while the base prefill runs.
Results go to ``DIR/ssm_scan_variants.json``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build, ssm_scan_plain  # noqa: E402

NAMES = {torch.float32: "f32", torch.bfloat16: "bf16"}
SHAPES = ((4, 1024, torch.bfloat16), (1, 2048, torch.bfloat16),
          (4, 1, torch.float32))


def build_variants(variants: dict) -> dict:
    """name -> loaded library; raises if a substitution does not apply or
    a build fails."""
    src = open(os.path.join(build.CSRC, "ssm_scan.cu")).read()
    out = os.path.join(build.build_dir(), "variants")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for name, subs in {"base": [], **variants}.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise ValueError(f"variant {name}: {old!r} not in the source")
            text = text.replace(old, new)
        cu = os.path.join(out, f"ssm_scan_{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = cu[:-3] + ".so"
        procs[name] = (subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name} does not build:\n{log}")
        regs = sorted({ln.split("Used")[1].split(",")[0].strip()
                       for ln in log.splitlines() if "Used" in ln})
        print(f"{name}: built, {', '.join(regs)}", flush=True)
        lib = ctypes.CDLL(so)
        for fn, argtypes in build._SIGNATURES["ssm_scan"].items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def call(lib, x, dt, A, B, C, D, h0, y, h) -> None:
    fn = getattr(lib, f"ssm_scan_{NAMES[x.dtype]}_{NAMES[dt.dtype]}")
    b, s, di = x.shape
    build.check(fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                   C.data_ptr(), 0 if D is None else D.data_ptr(),
                   0 if h0 is None else h0.data_ptr(), y.data_ptr(),
                   h.data_ptr(), b, s, di, A.shape[1],
                   torch.cuda.current_stream().cuda_stream), "variant")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", help="JSON file of named substitutions")
    ap.add_argument("--out", default=None, help="directory for the results")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ssm_scan_variants: no CUDA device available", file=sys.stderr)
        return 1
    with open(args.variants) as f:
        variants = json.load(f)
    card = cs.card_line()
    print(card, flush=True)
    libs = build_variants(variants)
    dev = torch.device("cuda", 0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    di, ds = 8192, 16
    cases = []
    for b, s, xdt in SHAPES:
        ins, h0 = cs.scan_inputs(dev, b, s, di, ds, xdt, torch.float32, 50,
                                 h0=s == 1)
        if s > 1:
            ins[5] = None               # the model's prefill: no skip term
        cases.append((b, s, xdt, ins, h0, *ssm_scan_plain(*ins, h0=h0)))
    small = torch.zeros((4, di), device=dev)
    result = {"card": card, "floor_ms": cs.cuda_time_ms(small.zero_, 50,
                                                        flush),
              "ms": {name: [] for name in libs}, "correct": {}}
    print(f"floor (zero_ of 4 x {di}, L2 flushed) "
          f"{result['floor_ms']:.4f} ms", flush=True)
    for rep in range(2):
        for name, lib in libs.items():
            row, ok_all = [], True
            for b, s, xdt, ins, h0, y_p, h_p in cases:
                y = torch.empty_like(ins[0])
                h = torch.empty((b, di, ds), device=dev)
                state = None if h0 is None else h0.clone()
                call(lib, *ins, state, y, h if state is None else state)
                torch.cuda.synchronize()
                ok_all &= bool(
                    torch.allclose(y.float(), y_p.float(),
                                   **cs.SSM_TOL[xdt])
                    and torch.allclose(h if state is None else state, h_p,
                                       **cs.SSM_TOL[torch.float32]))
                out_h = h if state is None else state
                row.append(cs.cuda_time_ms(
                    lambda: call(lib, *ins, state, y, out_h),
                    20 if s > 1 else 50, flush))
            result["ms"][name].append(row)
            result["correct"][name] = ok_all
            print(f"rep {rep} {name:>20} [{card}]: " + "  ".join(
                f"({b}, {s}) {t:.4f} ms" for (b, s, _), t in zip(SHAPES, row))
                + ("" if ok_all else "  WRONG"), flush=True)
    b, s, xdt, ins, _, _, _ = cases[0]
    y = torch.empty_like(ins[0])
    h = torch.empty((b, di, ds), device=dev)
    for _ in range(2000):               # ~0.4 s of work queued
        call(libs["base"], *ins, None, y, h)
    time.sleep(0.2)
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    torch.cuda.synchronize()
    result["clocks_under_load"] = clocks
    print(f"SM clock, max clock, power under the base prefill: {clocks}")
    if args.out is not None:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "ssm_scan_variants.json"),
                  "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
