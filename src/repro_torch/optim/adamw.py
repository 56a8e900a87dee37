"""AdamW with global-norm clipping and optional low-precision moments.

The reference's update, float32 operation for operation: the moments and
the parameter in float32, the bias corrections from an int32 step, the
weight decay inside ``delta``, the clip scale cast to each gradient's
dtype.  ``torch.optim.AdamW`` applies the decay in another order, so it is
not used.  A state is ``{"m": {name: tensor}, "v": {...}, "step": int32
scalar tensor}`` keyed as the parameters; ``adamw_update`` writes the
parameters and moments in place (a train state of billions of parameters
has no room for a second copy) and works through each leaf a slice at a
time, which bounds its float32 temporaries.  Every division is by a
tensor: PyTorch turns a division of a CUDA tensor by a Python float into a
multiply by its reciprocal, which rounds otherwise.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.models.common import DTYPES

_SLICE = 1 << 26                      # elements of a leaf updated at once


def init_opt_state(params: dict[str, torch.Tensor],
                   moment_dtype: str = "float32") -> dict:
    dt = DTYPES[moment_dtype]
    first = next(iter(params.values()))
    return {
        "m": {k: torch.zeros(p.shape, dtype=dt, device=p.device)
              for k, p in params.items()},
        "v": {k: torch.zeros(p.shape, dtype=dt, device=p.device)
              for k, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=first.device),
    }


def global_norm(tree: dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum, leaf by leaf in the dict's order, of each leaf's
    float32 sum of squares."""
    sq = None
    for g in tree.values():
        s = torch.sum(torch.square(g.to(torch.float32)))
        sq = s if sq is None else sq + s
    return torch.sqrt(sq)


def clip_by_global_norm(grads: dict[str, torch.Tensor], max_norm: float):
    """(grads * min(1, max_norm / max(norm, 1e-9)), norm), the scale cast
    to each gradient's dtype as in the reference."""
    norm = global_norm(grads)
    one = torch.ones((), dtype=torch.float32, device=norm.device)
    scale = torch.minimum(one, torch.full_like(norm, max_norm) /
                          torch.clamp(norm, min=1e-9))
    return {k: g * scale.to(g.dtype) for k, g in grads.items()}, norm


@torch.no_grad()
def adamw_update(params: dict[str, torch.Tensor],
                 grads: dict[str, torch.Tensor], opt: dict, cfg: RunConfig,
                 lr: torch.Tensor) -> tuple[dict, dict]:
    """One AdamW step at learning rate ``lr`` (a float32 scalar tensor):
    writes the parameters and the moments in place and returns them as
    ``(params, {"m", "v", "step": step + 1})``."""
    step = opt["step"] + 1
    f32 = torch.float32
    dev = step.device
    b1, b2, eps = cfg.beta1, cfg.beta2, cfg.eps
    sf = step.to(f32)
    c1 = 1.0 - torch.tensor(b1, dtype=f32, device=dev) ** sf
    c2 = 1.0 - torch.tensor(b2, dtype=f32, device=dev) ** sf
    lr = lr.to(device=dev, dtype=f32)
    for k, p in params.items():
        g, m, v = grads[k], opt["m"][k], opt["v"][k]
        pf, gf_all, mf, vf = (t.view(-1) for t in (p, g, m, v))
        for i in range(0, pf.numel(), _SLICE):
            sl = slice(i, i + _SLICE)
            gf = gf_all[sl].to(f32)
            m_new = b1 * mf[sl].to(f32) + (1 - b1) * gf
            v_new = b2 * vf[sl].to(f32) + (1 - b2) * gf * gf
            p32 = pf[sl].to(f32)
            delta = (m_new / c1) / (torch.sqrt(v_new / c2) + eps) \
                + cfg.weight_decay * p32
            pf[sl] = (p32 - lr * delta).to(p.dtype)
            mf[sl] = m_new.to(m.dtype)
            vf[sl] = v_new.to(v.dtype)
    return params, {"m": opt["m"], "v": opt["v"], "step": step}
