"""Serving launcher: batched prefill + decode with the ServeEngine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch glm4-9b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch granite-moe-3b-a800m
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v2-236b \\
        --smoke --device cpu --prompt-len 16 --tokens 8
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch llama-3.2-vision-11b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-medium

The full configuration runs on the card by default, with the port's seeded
init (no checkpoint); ``--smoke`` takes the reduced configuration.  Every
family is ported: dense, moe (MoE and MLA: granite-moe-3b-a800m,
deepseek-v2-236b), ssm, hybrid (jamba-1.5-large-398b), vlm
(llama-3.2-vision-11b, whose batch carries ``image_embeds`` (batch,
num_image_tokens, d_model)) and audio (the whisper-medium encoder-decoder,
``frames`` (batch, prompt_len, d_model)); both stub inputs are
``standard_normal * 0.02`` from the seed's generator, as the reference's
launcher draws them.  A configuration whose
bfloat16 weights exceed the device's memory (deepseek-v2-236b and
jamba-1.5-large-398b at full size) is refused before anything is
allocated.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.serve import ServeEngine


def device_memory_bytes(device: torch.device) -> int:
    """The card's memory, or the host's for the CPU."""
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def check_fits(cfg: ModelConfig, device: torch.device) -> None:
    """Raise ``ValueError`` when the bfloat16 weights alone exceed the
    device."""
    need, have = 2 * cfg.param_count(), device_memory_bytes(device)
    if need > have:
        raise ValueError(
            f"{cfg.name}: {need / 1e9:.1f} GB of bfloat16 weights do not fit "
            f"in the {have / 1e9:.1f} GB of {device}; pass --smoke for the "
            f"reduced configuration")


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
    check_fits(cfg, resolve_device(args.device))
    engine = ServeEngine(cfg, max_len=args.prompt_len + args.tokens + 4,
                         device=args.device)
    engine.init_params(args.seed)
    rng = np.random.default_rng(args.seed)
    batch = {"tokens": rng.integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["image_embeds"] = rng.standard_normal(
            (args.batch, cfg.num_image_tokens, cfg.d_model)).astype(
                np.float32) * 0.02
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (args.batch, args.prompt_len, cfg.d_model)).astype(
                np.float32) * 0.02
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
