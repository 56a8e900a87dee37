"""Learning-rate schedules."""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import RunConfig


def warmup_cosine(cfg: RunConfig, step, device=None) -> torch.Tensor:
    """The reference's schedule as a float32 scalar on ``device`` (step's
    device if it is a tensor): linear warmup to ``learning_rate`` over
    ``warmup_steps``, then a cosine from 1 to 0.1 of it by
    ``total_steps``, every operation in float32."""
    f32 = torch.float32
    if isinstance(step, torch.Tensor):
        device = step.device if device is None else device
        step = step.to(device=device, dtype=f32)
    else:
        step = torch.tensor(step, dtype=f32, device=device)

    def c(x):
        return torch.tensor(x, dtype=f32, device=step.device)

    warm = c(cfg.learning_rate) * torch.minimum(
        step / c(max(cfg.warmup_steps, 1)), c(1.0))
    prog = torch.clamp((step - c(cfg.warmup_steps)) /
                       c(max(cfg.total_steps - cfg.warmup_steps, 1)),
                       0.0, 1.0)
    cos = c(0.5) * (c(1.0) + torch.cos(c(math.pi) * prog))
    decayed = c(cfg.learning_rate) * (c(0.1) + c(0.9) * cos)
    return torch.where(step < c(cfg.warmup_steps), warm, decayed)
