"""Shared model plumbing: parameter definitions, seeded init, topology.

The reference shards every tensor over a device mesh through logical axes.
The port runs on one card, so ``Topo`` keeps only what decides a code path:
``axis_size`` (1 for every logical axis, so layouts are chosen as the
reference chooses them on a one-device mesh) and no sharding constraints.

Parameters are described by ``ParamDef``s and collected by a
``ParamStore``, as in the reference; the modules of ``layers``,
``attention`` and ``transformer`` materialise their own defs as
``nn.Parameter``s (``ParamModule``) and ``init_param_`` fills them from an
explicit ``torch.Generator``.  The reference draws from ``jax.random`` keys,
so the same seed gives other numbers here; the parity tests carry the
reference's values over with ``models.convert.params_from_jax``.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable

import torch
import torch.utils.checkpoint
from torch import nn

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass(frozen=True)
class Topo:
    """One device: every logical axis has size 1, nothing is sharded."""

    def axis_size(self, logical: str) -> int:
        if logical not in ("batch", "fsdp", "tp", "seq_tp", "all", "none"):
            raise KeyError(f"unknown logical axis {logical!r}")
        return 1


ONE_DEVICE = Topo()


@dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]       # logical axis per dim (metadata)
    # normal | zeros | ones | mamba_a | mamba_dt
    init: str = "normal"
    scale: float | None = None         # None -> 1/sqrt(fan_in)
    dtype: str = "bfloat16"

    def fan_in(self) -> int:
        return self.shape[0] if self.shape else 1


class ParamStore:
    """Collects ``ParamDef``s keyed by '/'-separated paths."""

    def __init__(self) -> None:
        self.defs: dict[str, ParamDef] = {}

    def add(self, path: str, d: ParamDef) -> None:
        if path in self.defs:
            raise ValueError(f"duplicate param {path}")
        self.defs[path] = d

    def stacked(self, n: int, prefix: str, sub: "ParamStore") -> None:
        """Add all of ``sub``'s params with a leading stacking dim of ``n``."""
        for path, d in sub.defs.items():
            self.add(f"{prefix}/{path}", dataclasses.replace(
                d, shape=(n, *d.shape), axes=(None, *d.axes)))

    def _nest(self, leaves: dict[str, Any]) -> dict[str, Any]:
        tree: dict[str, Any] = {}
        for path, v in leaves.items():
            parts = path.split("/")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = v
        return tree

    def init(self, generator: torch.Generator,
             dtype: torch.dtype | None = None) -> dict[str, Any]:
        """Fresh tensors for every def, in sorted path order, on the
        generator's device, as a nested dict."""
        leaves = {}
        for path in sorted(self.defs):
            d = self.defs[path]
            t = torch.empty(d.shape, dtype=dtype or DTYPES[d.dtype],
                            device=generator.device)
            leaves[path] = init_param_(t, d, generator)
        return self._nest(leaves)

    def num_params(self) -> int:
        return sum(math.prod(d.shape) for d in self.defs.values())


@torch.no_grad()
def init_param_(t: torch.Tensor, d: ParamDef,
                generator: torch.Generator) -> torch.Tensor:
    """Fill ``t`` in place as the reference's ``_init_param`` draws ``d``:
    normal * (scale or 1/sqrt(fan_in)) in float32, zeros, ones, or the
    Mamba inits (``mamba_a``: log(1..d_state) along the last dim;
    ``mamba_dt``: the inverse softplus of a log-uniform dt in [1e-3, 1e-1]);
    cast to ``t``'s dtype."""
    if d.init == "zeros":
        return t.zero_()
    if d.init == "ones":
        return t.fill_(1.0)
    if d.init == "mamba_a":
        n = t.shape[-1]
        a = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                   device=t.device))
        return t.copy_(a.expand(t.shape))
    if d.init == "mamba_dt":
        u = torch.rand(t.shape, generator=generator, dtype=torch.float32,
                       device=t.device)
        dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
        return t.copy_(dt + torch.log(-torch.expm1(-dt)))
    if d.init != "normal":
        raise ValueError(f"unknown init {d.init!r}")
    scale = d.scale if d.scale is not None \
        else 1.0 / math.sqrt(max(d.fan_in(), 1))
    # float32 draws a slice at a time (the same draws for every dtype), so a
    # large bf16 table needs no float32 copy of itself
    flat = t.view(-1)
    step = 1 << 26
    for i in range(0, flat.numel(), step):
        dst = flat[i:i + step]
        part = dst if dst.dtype == torch.float32 else torch.empty_like(
            dst, dtype=torch.float32)
        part.normal_(0.0, 1.0, generator=generator).mul_(scale)
        if part is not dst:
            dst.copy_(part)
    return t


class ParamModule(nn.Module):
    """An ``nn.Module`` whose parameters are materialised from ``ParamDef``s
    registered by its ``register(store)`` under paths relative to it."""

    def _materialize(self, device: torch.device,
                     dtype: torch.dtype | None) -> None:
        store = ParamStore()
        self.register(store)
        self.defs = store.defs
        for path, d in store.defs.items():
            self.register_parameter(path, nn.Parameter(
                torch.empty(d.shape, dtype=dtype or DTYPES[d.dtype],
                            device=device), requires_grad=False))

    def register(self, store: ParamStore) -> None:
        raise NotImplementedError


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       vocab_size: int) -> torch.Tensor:
    """Mean cross-entropy over the tokens whose label lies in
    [0, vocab_size), on float32 logits (the reference's
    ``cross_entropy_loss``).  The reference takes the gold logit by a
    one-hot contraction (for vocab-sharded logits); a gather of the same
    element gives the same float32 value without a (tokens, vocab) one-hot.
    """
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    labels = labels.long()
    inside = (labels >= 0) & (labels < logits.shape[-1])
    gold = torch.gather(logits, -1, torch.where(inside, labels, 0)[..., None])
    gold = torch.where(inside, gold[..., 0], 0.0)
    mask = ((labels >= 0) & (labels < vocab_size)).to(torch.float32)
    loss = (lse - gold) * mask
    return loss.sum() / torch.clamp(mask.sum(), min=1.0)


def maybe_remat(fn: Callable, enabled: bool) -> Callable:
    """``fn`` recomputed in the backward instead of saving its activations
    (the reference's ``jax.checkpoint`` with ``nothing_saveable``)."""
    if not enabled:
        return fn

    def remat(*args):
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)
    return remat
