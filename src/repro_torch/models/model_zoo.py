"""Model zoo entry point: build a model for an architecture config, and the
input specs and random batches of an (arch x shape) cell."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.common import ONE_DEVICE, Topo
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.transformer import LM


def build_model(cfg: ModelConfig, topo: Topo = ONE_DEVICE,
                 kind: str = "train", *, device="cuda", dtype=None,
                 group=None) -> LM | EncDecLM:
    """The model of ``cfg`` in ``kind``'s layouts under ``topo``; with a
    ``group`` (``models.parallel``), that rank's blocks of it
    (``transformer.rank_group``)."""
    if cfg.is_encoder_decoder:
        return EncDecLM(cfg, topo, kind, device=device, dtype=dtype,
                        group=group)
    return LM(cfg, topo, kind, device=device, dtype=dtype, group=group)


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """(shape, dtype) of every model input of this cell, as the reference's
    ``input_specs``: ``decode`` one int32 token a sequence; ``train`` and
    ``prefill`` (batch, seq) int32 tokens (``train`` also labels), with
    bfloat16 stub modality embeddings for the vlm and audio families."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"tokens": ((b,), torch.int32)}
    specs = {"tokens": ((b, s), torch.int32)}
    if shape.kind == "train":
        specs["labels"] = ((b, s), torch.int32)
    if cfg.family == "vlm":
        specs["image_embeds"] = ((b, cfg.num_image_tokens, cfg.d_model),
                                 torch.bfloat16)
    if cfg.family == "audio":
        specs["frames"] = ((b, s, cfg.d_model), torch.bfloat16)
    return specs


def make_batch(cfg: ModelConfig, shape: ShapeConfig,
               generator: torch.Generator) -> dict:
    """A random batch matching ``input_specs``, drawn from ``generator`` on
    its device in sorted name order: integers uniform in [0, vocab_size),
    floats normal * 0.02 (drawn in float32, then cast).  The reference
    draws from ``jax.random`` keys, whose bits the port cannot reproduce
    (ROADMAP queue 3)."""
    out = {}
    for name, (dims, dtype) in sorted(input_specs(cfg, shape).items()):
        if dtype == torch.int32:
            out[name] = torch.randint(0, cfg.vocab_size, dims,
                                      generator=generator,
                                      device=generator.device,
                                      dtype=torch.int32)
        else:
            out[name] = (torch.randn(dims, generator=generator,
                                     device=generator.device,
                                     dtype=torch.float32)
                         .to(dtype) * 0.02)
    return out
