"""Train-step factory: microbatched gradient accumulation + AdamW.

A train state is ``{"params": {name: parameter}, "opt": {"m": {...}, "v":
{...}, "step": int32 scalar}}``, keyed by the model's state-dict names.  The
parameters are the model's own ``nn.Parameter``s (gradients on), updated in
place by the step.  ``state_tree`` and ``load_state`` carry a state to and
from the reference's tree (``params/layers/...`` stacked over the periods,
``opt/m``, ``opt/v``, ``opt/step``), the layout of both packages'
checkpoints.

On a rank of a (1, tp) mesh (a model built with a ``group``) the state
holds the rank's blocks.  The step sums over the ranks the gradients
that are each rank's share of a parameter it holds whole
(``model.grad_shares``: a norm scale on the rank's run of the sequence,
k and v's biases under the rank's heads), clips to the norm of the whole
tree (``optim.global_norm`` over the ranks) and runs AdamW on the blocks,
so every rank's parameters and moments are its blocks of one device's
and the replicated ones hold the same bits on every rank.
``save_state`` gathers the blocks one leaf at a time and rank 0 writes
the reference's tree; ``load_state`` cuts each rank's blocks from it
(``Topo.shard_slices``), so a checkpoint moves between one device and
any tp.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import RunConfig
from repro_torch.models.common import ONE_DEVICE, Topo
from repro_torch.models.convert import STACKED, flatten, params_to_jax
from repro_torch.models.parallel import LocalGroup
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


class _Whole:
    """A rank's block of one tensor, gathered whole when called: the
    whole tensor on the host on rank 0, None on the others.  Every rank
    calls its own in the same order."""

    def __init__(self, block: torch.Tensor, index: list, shape: tuple,
                 group) -> None:
        self.block, self.index, self.shape, self.group = (block, index,
                                                          shape, group)

    @torch.no_grad()
    def __call__(self) -> torch.Tensor | None:
        parts = self.group.all_gather(self.block.detach()[None], 0)
        if self.group.rank:
            return None
        whole = parts.new_empty(self.shape)
        for part, index in zip(parts, self.index):
            whole[index] = part
        return whole.cpu()


def state_tree(state: dict, model=None) -> dict:
    """The state in the reference's tree.  A stacked leaf is the list of
    its per-layer tensors (``ckpt.save`` stacks it one leaf at a time on the
    host, so the state is never copied whole).  With a ``model`` on a rank,
    a block is a function that gathers its tensor whole (``_Whole``)."""
    group = None if model is None else model.group
    if group is not None:
        defs = model.param_defs().defs
        index = [model.blocks(q) for q in range(group.size)]
        cut = set(model.cut_params())

        def whole(tree: dict) -> dict:
            return {n: _Whole(t, [ix[n] for ix in index], defs[n].shape,
                              group) if n in cut else t
                    for n, t in tree.items()}
    else:
        def whole(tree: dict) -> dict:
            return tree
    opt = state["opt"]
    return {"params": params_to_jax(whole(state["params"]), stack=False),
            "opt": {"m": params_to_jax(whole(opt["m"]), stack=False),
                    "v": params_to_jax(whole(opt["v"]), stack=False),
                    "step": opt["step"]}}


def save_state(state: dict, model, directory: str, step: int) -> None:
    """``ckpt.save`` of the state in the reference's tree; on a rank, every
    rank gathers the blocks with the others, leaf by leaf, and rank 0
    writes."""
    tree = state_tree(state, model)
    group = model.group
    if group is None or group.rank == 0:
        ckpt.save(tree, directory, step)
        return
    for leaf in ckpt.leaves(tree).values():
        for part in leaf if isinstance(leaf, list) else [leaf]:
            if callable(part):
                part()


def _copy_into(dst: dict[str, torch.Tensor], tree: dict, what: str,
               blocks: dict | None = None) -> None:
    """Copy a reference tree (stacked leaves split by layer; a leaf may be
    a function that reads it) into the tensors of ``dst`` in place, each
    cut to its block where ``blocks`` gives one; every leaf must be there,
    with its dtype."""
    seen = set()
    for path, t in flatten(tree).items():
        t = t() if callable(t) else t
        stack, _, rest = path.partition(".")
        names = [f"{stack}.{i}.{rest}" for i in range(t.shape[0])] \
            if stack in STACKED else [path]
        parts = list(t) if stack in STACKED else [t]
        for name, part in zip(names, parts):
            if name not in dst:
                raise KeyError(f"{what}: {name} is not in the model")
            if blocks is not None:
                part = part[blocks[name]]
            if dst[name].dtype != part.dtype or dst[name].shape != part.shape:
                raise ValueError(
                    f"{what}: {name} is {part.dtype} {tuple(part.shape)} in "
                    f"the checkpoint, {dst[name].dtype} "
                    f"{tuple(dst[name].shape)} in the model")
            with torch.no_grad():
                dst[name].copy_(part)
            seen.add(name)
        del t, parts
    missing = sorted(set(dst) - seen)
    if missing:
        raise KeyError(f"{what}: the checkpoint lacks {missing[:4]}")


def load_state(model, tree: dict, run_cfg: RunConfig) -> dict:
    """A state for ``model`` from a reference tree (a restored checkpoint,
    whose leaves may be functions that read them): the parameters copied
    into the model's own, the moments onto its device; on a rank, its
    blocks."""
    blocks = None if model.group is None else model.blocks()
    params = dict(model.named_parameters())
    _copy_into(params, tree["params"], "params", blocks)
    for p in params.values():
        p.requires_grad_(True)
    opt = init_opt_state(params, run_cfg.moment_dtype)
    _copy_into(opt["m"], tree["opt"]["m"], "opt/m", blocks)
    _copy_into(opt["v"], tree["opt"]["v"], "opt/v", blocks)
    step = tree["opt"]["step"]
    opt["step"].copy_(torch.as_tensor(step() if callable(step) else step))
    return {"params": params, "opt": opt}


def _split_microbatches(batch: dict, n: int) -> list[dict]:
    return [{k: x.reshape(n, x.shape[0] // n, *x.shape[1:])[i]
             for k, x in batch.items()} for i in range(n)]


def sum_shares(grads: dict[str, torch.Tensor], names: list[str],
               group) -> None:
    """Sum the gradients ``names`` over the ranks in place: in float32, one
    all-reduce of them all flattened, each rounded once to its dtype."""
    if not names:
        return
    flat = group.all_reduce(torch.cat([grads[n].reshape(-1).to(
        torch.float32) for n in names]))
    for n, g in zip(names, flat.split([grads[n].numel() for n in names])):
        grads[n] = g.view(grads[n].shape).to(grads[n].dtype)


def make_train_step(model, run_cfg: RunConfig, topo: Topo = ONE_DEVICE,
                    group=None) -> Callable:
    """Returns step(state, batch) -> (state, metrics): the gradient of
    ``model.loss`` (over ``run_cfg.microbatches`` microbatches summed in
    bfloat16 buffers and divided by their count, as the reference's ``g0``
    accumulates), clipped to ``grad_clip``, then AdamW at
    ``warmup_cosine``'s rate.  Metrics: loss, grad_norm, lr, aux_loss
    (float32 scalars on the device).  On a rank (``group``: the model's
    own, its default), every rank steps with the same whole batch: the
    gradients that are the rank's share (``model.grad_shares``) are
    summed over the ranks after the microbatches, and the norm is the
    whole tree's."""
    if group is None:
        group = model.group
    elif group is not model.group:
        raise ValueError("make_train_step: the group must be the model's")
    if isinstance(group, LocalGroup) and group.device.type == "cuda":
        raise ValueError(
            "LocalGroup threads on a card cannot train: autograd runs a "
            "card's backward on one thread of its own, where the ranks' "
            "collectives would wait for each other; run the ranks as "
            "processes (models.parallel.spawn)")
    cut = model.cut_params() if group is not None else ()

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
        if group is not None:
            sum_shares(grads, model.grad_shares(batch["tokens"].shape[1]),
                       group)
        grads, gnorm = clip_by_global_norm(grads, run_cfg.grad_clip, group,
                                           cut)
        lr = warmup_cosine(run_cfg, state["opt"]["step"])
        params, opt = adamw_update(params, grads, state["opt"], run_cfg, lr)
        del grads
        metrics = dict(metrics)
        metrics.update(loss=loss, grad_norm=gnorm, lr=lr)
        return {"params": params, "opt": opt}, metrics

    return step
