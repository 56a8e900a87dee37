"""Architecture registry: ``get_config(name)`` / ``--arch <id>`` support."""
from __future__ import annotations

from repro_torch.configs.base import (
    MeshConfig,
    ModelConfig,
    MULTI_POD,
    RunConfig,
    ShapeConfig,
    SINGLE_POD,
    SMOKE_MESH,
)
from repro_torch.configs.shapes import ALL_SHAPES, SHAPES, shape_applicable

from repro_torch.configs.falcon_mamba_7b import CONFIG as _falcon_mamba
from repro_torch.configs.glm4_9b import CONFIG as _glm4
from repro_torch.configs.command_r_35b import CONFIG as _command_r
from repro_torch.configs.phi3_medium_14b import CONFIG as _phi3
from repro_torch.configs.qwen2_5_14b import CONFIG as _qwen25
from repro_torch.configs.llama_3_2_vision_11b import CONFIG as _llama_vision
from repro_torch.configs.jamba_1_5_large_398b import CONFIG as _jamba
from repro_torch.configs.deepseek_v2_236b import CONFIG as _deepseek
from repro_torch.configs.granite_moe_3b_a800m import CONFIG as _granite
from repro_torch.configs.whisper_medium import CONFIG as _whisper

ARCHS: dict[str, ModelConfig] = {
    c.name: c
    for c in (
        _falcon_mamba,
        _glm4,
        _command_r,
        _phi3,
        _qwen25,
        _llama_vision,
        _jamba,
        _deepseek,
        _granite,
        _whisper,
    )
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def all_cells() -> list[tuple[ModelConfig, ShapeConfig, bool, str]]:
    """Every (arch x shape) cell with its applicability flag + skip reason."""
    cells = []
    for cfg in ARCHS.values():
        for shape in ALL_SHAPES:
            ok, reason = shape_applicable(cfg.family, shape)
            cells.append((cfg, shape, ok, reason))
    return cells


__all__ = [
    "ARCHS",
    "ALL_SHAPES",
    "SHAPES",
    "MeshConfig",
    "ModelConfig",
    "MULTI_POD",
    "RunConfig",
    "ShapeConfig",
    "SINGLE_POD",
    "SMOKE_MESH",
    "all_cells",
    "get_config",
    "shape_applicable",
]
