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
    PYTHONPATH=src python -m repro_torch.launch.serve --arch command-r-35b \\
        --tp 4 --group nccl
    PYTHONPATH=src python -m repro_torch.launch.serve --arch command-r-35b \\
        --smoke --tp 2 --group local --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch jamba-1.5-large-398b --smoke --tp 4 --group nccl
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch llama-3.2-vision-11b --tp 4 --group nccl
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-medium \\
        --tp 4 --group nccl --prompt-len 1500
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v2-236b \\
        --smoke --tp 2 --group local --device cpu

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

``--tp N`` serves any family over a (1, N) mesh with the reference's
tensor-parallel layouts: dense, moe (granite-moe-3b-a800m, and
deepseek-v2-236b's MLA: heads cut in prefill, the latent caches and the
row-parallel decode cut over the sequence and d_model), ssm
(falcon-mamba-7b), hybrid (jamba-1.5-large-398b), vlm
(llama-3.2-vision-11b: its cross layers over the whole image embeddings,
their caches cut over the image tokens) and audio (whisper-medium: the
encoder over the frames, the cross caches cut over them).  ``--group``
chooses how the ranks run, and is required with it: ``nccl`` spawns N
processes, rank r on card r (the kernels built once, before the spawn);
``local`` runs N threads of this process, rank r on card r % (the cards
there are), or on the CPU with ``--device cpu``.  ``check_fits`` then
counts the weights a card holds: its ranks' blocks of both layouts (a MoE
block's experts twice, ``ep``'s whole experts and ``ep_decode``'s d_ff
columns), and names a rank's bytes when it refuses.  The whole
jamba-1.5-large-398b (797 GB in bfloat16, 374 GB a rank at ``--tp 4``)
and the whole deepseek-v2-236b (488 GB, 243 GB a rank at ``--tp 4``:
``ep``'s 40 whole experts and ``ep_decode``'s quarter of all 160) fit no
host of 4 or 8 80 GB cards and are refused; ``--smoke`` serves
their reductions (``chip_smoke.py`` phases 24 and 25 serve 8 of their
layers at full width over 4 cards).
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
from repro_torch.launch.mesh import tp_mesh
from repro_torch.models.common import Topo
from repro_torch.models.parallel import LocalGroup, run_local, spawn
from repro_torch.serve import ServeEngine


def device_memory_bytes(device: torch.device) -> int:
    """The card's memory, or the host's for the CPU."""
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def rank_weight_bytes(cfg: ModelConfig, tp: int = 1) -> int:
    """Bytes of the bfloat16 weights one rank holds: on one device the
    config's count; over tp ranks, rank 0's engine's parameters (its
    prefill and decode models, a shared block once), counted on meta."""
    if tp == 1:
        return 2 * cfg.param_count()
    eng = ServeEngine(cfg, 1, device="meta", topo=Topo(tp_mesh(tp)),
                      group=LocalGroup.make(tp)[0])
    params = {id(p): p for m in (eng.model, eng.decode_model)
              for p in m.parameters()}
    return 2 * sum(p.numel() for p in params.values())


def check_fits(cfg: ModelConfig, device: torch.device, tp: int = 1,
               ranks_per_device: int = 1) -> None:
    """Raise ``ValueError`` when the bfloat16 weights alone exceed the
    device: ``ranks_per_device`` ranks of a (1, tp) mesh on it."""
    rank = rank_weight_bytes(cfg, tp)
    need = ranks_per_device * rank
    have = device_memory_bytes(device)
    if need > have:
        per = f" ({rank / 1e9:.1f} GB a rank of {tp})" if tp > 1 else ""
        raise ValueError(
            f"{cfg.name}: {need / 1e9:.1f} GB of bfloat16 weights{per} do "
            f"not fit in the {have / 1e9:.1f} GB of {device}; pass --smoke "
            f"for the reduced configuration")


def make_batch(cfg: ModelConfig, batch: int, prompt_len: int,
               seed: int) -> dict:
    """The launcher's request: tokens uniform in the vocabulary, and the
    vlm's or whisper's stub embeddings, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(
        0, cfg.vocab_size, (batch, prompt_len)).astype(np.int32)}
    if cfg.family == "vlm":
        out["image_embeds"] = rng.standard_normal(
            (batch, cfg.num_image_tokens, cfg.d_model)).astype(
                np.float32) * 0.02
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal(
            (batch, prompt_len, cfg.d_model)).astype(np.float32) * 0.02
    return out


def serve_rank(group, cfg: ModelConfig, max_len: int, seed: int,
               batch: dict, tokens: int) -> dict:
    """One rank of ``--tp``, on the group's device: its engine, the seeded
    init, one request; the ids, the seconds and the stats."""
    dev = group.device
    engine = ServeEngine(cfg, max_len=max_len, device=dev,
                         topo=Topo(tp_mesh(group.size)), group=group)
    engine.init_params(seed)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    out = engine.generate(batch, tokens)
    sync()
    return {"ids": out, "seconds": time.perf_counter() - t0,
            "stats": engine.stats, "device": str(dev)}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--group", choices=("nccl", "local"))
    args = ap.parse_args()

    cfg = ARCHS[args.arch]
    if args.smoke:
        cfg = cfg.reduced()
    max_len = args.prompt_len + args.tokens + 4
    batch = make_batch(cfg, args.batch, args.prompt_len, args.seed)
    if args.tp > 1:
        serve_tp(args, cfg, max_len, batch)
        return
    check_fits(cfg, resolve_device(args.device))
    engine = ServeEngine(cfg, max_len=max_len, device=args.device)
    engine.init_params(args.seed)
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


def serve_tp(args, cfg: ModelConfig, max_len: int, batch: dict) -> None:
    """``--tp``: every rank serves the request; their ids must agree."""
    if args.group is None:
        raise SystemExit("--tp needs --group nccl (a process a card) or "
                         "--group local (threads of this process)")
    dev = resolve_device(args.device)
    if args.group == "nccl":
        if dev.type != "cuda" or torch.cuda.device_count() < args.tp:
            raise SystemExit(f"--group nccl needs {args.tp} cards, this "
                             f"host has {torch.cuda.device_count()}")
        check_fits(cfg, torch.device("cuda", 0), args.tp)
        ranks = spawn(serve_rank, args.tp, "nccl", args=(
            cfg, max_len, args.seed, batch, args.tokens))
    else:
        devices = [dev] if dev.type != "cuda" else \
            [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        check_fits(cfg, devices[0], args.tp, -(-args.tp // len(devices)))
        ranks = run_local(lambda g: serve_rank(
            g, cfg, max_len, args.seed, batch, args.tokens), args.tp,
            devices)
    for r in ranks[1:]:
        if not np.array_equal(r["ids"], ranks[0]["ids"]):
            raise RuntimeError("the ranks generated different ids")
    stats = ranks[0]["stats"]
    print("generated token ids:\n", ranks[0]["ids"])
    print(f"prefill_tokens={stats.prefill_tokens} "
          f"decode_steps={stats.decode_steps} "
          f"seconds={max(r['seconds'] for r in ranks):.3f} tp={args.tp} "
          f"group={args.group} devices="
          f"{','.join(r['device'] for r in ranks)}")


if __name__ == "__main__":
    main()
