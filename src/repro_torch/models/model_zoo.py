"""Model zoo entry point: build a model for an architecture config."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ONE_DEVICE, Topo
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.transformer import LM


def build_model(cfg: ModelConfig, topo: Topo = ONE_DEVICE,
                kind: str = "train", *, device="cuda",
                dtype=None) -> LM | EncDecLM:
    if cfg.is_encoder_decoder:
        return EncDecLM(cfg, topo, kind, device=device, dtype=dtype)
    return LM(cfg, topo, kind, device=device, dtype=dtype)
