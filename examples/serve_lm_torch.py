"""Serve a small model with batched requests on the PyTorch port: prefill
once, then decode token by token from the engine's padded caches, on the
card (its flash-attention, RMSNorm and selective-scan kernels) or on the
CPU.

    PYTHONPATH=src python examples/serve_lm_torch.py --tokens 24
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu

It prints the lines ``examples/serve_lm.py`` prints for the reference
package: the request, the first request's sampled ids (drawn from a
``torch.Generator``, so not the reference's ids) and the engine's counts
with the wall time.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS
from repro_torch.serve import ServeEngine


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="glm4-9b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=24)
    ap.add_argument("--device", default="cuda",
                    help="where the model runs: cuda (default) or cpu")
    args = ap.parse_args()

    cfg = ARCHS[args.arch].reduced()
    engine = ServeEngine(cfg, max_len=args.prompt_len + args.tokens + 4,
                         device=args.device)
    engine.init_params(0)

    rng = np.random.default_rng(0)
    b, s, d = args.batch, args.prompt_len, cfg.d_model
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s))
             .astype(np.int32)}
    if cfg.family == "vlm":
        batch["image_embeds"] = rng.standard_normal(
            (b, cfg.num_image_tokens, d)).astype(np.float32) * 0.02
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (b, s, d)).astype(np.float32) * 0.02

    t0 = time.perf_counter()
    out = engine.generate(batch, args.tokens, greedy=False,
                          generator=torch.Generator(engine.device)
                          .manual_seed(1))
    dt = time.perf_counter() - t0
    print(f"arch={args.arch} (reduced) batch={args.batch} "
          f"prompt={args.prompt_len} generated={args.tokens}")
    print("sampled ids (first request):", out[0].tolist())
    print(f"prefill tokens: {engine.stats.prefill_tokens}  "
          f"decode steps: {engine.stats.decode_steps}  "
          f"wall: {dt:.2f}s ({args.batch*args.tokens/dt:.1f} tok/s incl. "
          f"compile)")


if __name__ == "__main__":
    main()
