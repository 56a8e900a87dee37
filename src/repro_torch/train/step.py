"""Train-step factory: microbatched gradient accumulation + AdamW.

A train state is ``{"params": {name: parameter}, "opt": {"m": {...}, "v":
{...}, "step": int32 scalar}}``, keyed by the model's state-dict names.  The
parameters are the model's own ``nn.Parameter``s (gradients on), updated in
place by the step.  ``state_tree`` and ``load_state`` carry a state to and
from the reference's tree (``params/layers/...`` stacked over the periods,
``opt/m``, ``opt/v``, ``opt/step``), the layout of both packages'
checkpoints.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.models.common import ONE_DEVICE, Topo
from repro_torch.models.convert import STACKED, flatten, params_to_jax
from repro_torch.optim import (adamw_update, clip_by_global_norm,
                               init_opt_state, warmup_cosine)


def init_state(model, run_cfg: RunConfig,
               generator: torch.Generator) -> dict:
    """The model's seeded init (in place) and zero moments."""
    model.init_params(generator)
    return make_state(dict(model.named_parameters()), run_cfg)


def make_state(params: dict[str, torch.Tensor], run_cfg: RunConfig) -> dict:
    """The train state over ``params`` (made trainable in place) with zero
    AdamW moments in ``run_cfg.moment_dtype``."""
    for p in params.values():
        p.requires_grad_(True)
    return {"params": params,
            "opt": init_opt_state(params, run_cfg.moment_dtype)}


def state_tree(state: dict) -> dict:
    """The state in the reference's tree.  A stacked leaf is the list of
    its per-layer tensors (``ckpt.save`` stacks it one leaf at a time on the
    host, so the state is never copied whole)."""
    opt = state["opt"]
    return {"params": params_to_jax(state["params"], stack=False),
            "opt": {"m": params_to_jax(opt["m"], stack=False),
                    "v": params_to_jax(opt["v"], stack=False),
                    "step": opt["step"]}}


def _copy_into(dst: dict[str, torch.Tensor], tree: dict, what: str) -> None:
    """Copy a reference tree (stacked leaves split by layer) into the
    tensors of ``dst`` in place; every leaf must be there, with its dtype."""
    seen = set()
    for path, t in flatten(tree).items():
        stack, _, rest = path.partition(".")
        names = [f"{stack}.{i}.{rest}" for i in range(t.shape[0])] \
            if stack in STACKED else [path]
        parts = list(t) if stack in STACKED else [t]
        for name, part in zip(names, parts):
            if name not in dst:
                raise KeyError(f"{what}: {name} is not in the model")
            if dst[name].dtype != part.dtype or dst[name].shape != part.shape:
                raise ValueError(
                    f"{what}: {name} is {part.dtype} {tuple(part.shape)} in "
                    f"the checkpoint, {dst[name].dtype} "
                    f"{tuple(dst[name].shape)} in the model")
            with torch.no_grad():
                dst[name].copy_(part)
            seen.add(name)
    missing = sorted(set(dst) - seen)
    if missing:
        raise KeyError(f"{what}: the checkpoint lacks {missing[:4]}")


def load_state(model, tree: dict, run_cfg: RunConfig) -> dict:
    """A state for ``model`` from a reference tree (a restored checkpoint):
    the parameters copied into the model's own, the moments onto its
    device."""
    params = dict(model.named_parameters())
    _copy_into(params, tree["params"], "params")
    for p in params.values():
        p.requires_grad_(True)
    opt = init_opt_state(params, run_cfg.moment_dtype)
    _copy_into(opt["m"], tree["opt"]["m"], "opt/m")
    _copy_into(opt["v"], tree["opt"]["v"], "opt/v")
    opt["step"].copy_(torch.as_tensor(tree["opt"]["step"]))
    return {"params": params, "opt": opt}


def _split_microbatches(batch: dict, n: int) -> list[dict]:
    return [{k: x.reshape(n, x.shape[0] // n, *x.shape[1:])[i]
             for k, x in batch.items()} for i in range(n)]


def make_train_step(model, run_cfg: RunConfig,
                    topo: Topo = ONE_DEVICE) -> Callable:
    """Returns step(state, batch) -> (state, metrics): the gradient of
    ``model.loss`` (over ``run_cfg.microbatches`` microbatches summed in
    bfloat16 buffers and divided by their count, as the reference's ``g0``
    accumulates), clipped to ``grad_clip``, then AdamW at
    ``warmup_cosine``'s rate.  Metrics: loss, grad_norm, lr, aux_loss
    (float32 scalars on the device)."""

    def grads_of(params: dict, batch: dict):
        total, metrics = model.loss(batch)
        names = list(params)
        grads = torch.autograd.grad(total, [params[n] for n in names],
                                    allow_unused=True)
        grads = {n: torch.zeros_like(params[n]) if g is None else g
                 for n, g in zip(names, grads)}
        return total.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads

    def step(state: dict, batch: dict):
        params = state["params"]
        n_mb = run_cfg.microbatches
        if n_mb > 1:
            gsum = {n: torch.zeros(p.shape, dtype=torch.bfloat16,
                                   device=p.device)
                    for n, p in params.items()}
            lsum = None
            for mb in _split_microbatches(batch, n_mb):
                loss, metrics, grads = grads_of(params, mb)
                for n, g in grads.items():
                    gsum[n] += g.to(torch.bfloat16)
                lsum = loss if lsum is None else lsum + loss
                del grads
            # tensor divisors: the reference divides truly, and PyTorch
            # would multiply a CUDA tensor by a Python number's reciprocal
            loss = lsum / torch.tensor(n_mb, dtype=torch.float32,
                                       device=lsum.device)
            div = torch.tensor(n_mb, dtype=torch.bfloat16,
                               device=lsum.device)
            grads = {n: g / div for n, g in gsum.items()}
            del gsum
        else:
            loss, metrics, grads = grads_of(params, batch)
        grads, gnorm = clip_by_global_norm(grads, run_cfg.grad_clip)
        lr = warmup_cosine(run_cfg, state["opt"]["step"])
        params, opt = adamw_update(params, grads, state["opt"], run_cfg, lr)
        del grads
        metrics = dict(metrics)
        metrics.update(loss=loss, grad_norm=gnorm, lr=lr)
        return {"params": params, "opt": opt}, metrics

    return step
