"""Serving launcher: batched prefill + decode with the ServeEngine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch glm4-9b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b \\
        --smoke --device cpu --prompt-len 16 --tokens 8

The full configuration runs on the card by default, with the port's seeded
init (no checkpoint); ``--smoke`` takes the reduced configuration.  The
dense and ssm families are ported.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS
from repro_torch.serve import ServeEngine


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    cfg = ARCHS[args.arch]
    if args.smoke:
        cfg = cfg.reduced()
    engine = ServeEngine(cfg, max_len=args.prompt_len + args.tokens + 4,
                         device=args.device)
    engine.init_params(args.seed)
    rng = np.random.default_rng(args.seed)
    batch = {"tokens": rng.integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32)}
    sync = torch.cuda.synchronize if engine.device.type == "cuda" \
        else (lambda: None)
    sync()
    t0 = time.perf_counter()
    out = engine.generate(batch, args.tokens)
    sync()
    elapsed = time.perf_counter() - t0
    print("generated token ids:\n", out)
    print(f"prefill_tokens={engine.stats.prefill_tokens} "
          f"decode_steps={engine.stats.decode_steps} "
          f"seconds={elapsed:.3f} device={engine.device}")


if __name__ == "__main__":
    main()
