"""Model zoo entry point: build a model for an architecture config."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ONE_DEVICE, Topo
from repro_torch.models.transformer import LM


def build_model(cfg: ModelConfig, topo: Topo = ONE_DEVICE,
                kind: str = "train", *, device="cuda", dtype=None) -> LM:
    if cfg.is_encoder_decoder:
        raise NotImplementedError(
            "the encoder-decoder model is not ported yet (ROADMAP queue 1: "
            "MoE, MLA, VLM and enc-dec serving)")
    return LM(cfg, topo, kind, device=device, dtype=dtype)
