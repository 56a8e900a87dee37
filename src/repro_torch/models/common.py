"""Shared model plumbing: logical-axis sharding, parameter definitions,
seeded init.

Logical axes map to mesh axes as in the reference (``Topo``):

* ``"batch"`` and ``"fsdp"`` -> ``("pod", "data")``, ``"tp"`` and
  ``"seq_tp"`` -> ``"model"``, ``"all"`` -> all three, ``"none"`` -> ();
* every application is divisibility-checked: a dim that the mesh axes do
  not divide falls back to a shorter run of them (dropping the leading
  axis), and finally to replication, never to an error.

A pspec is a plain tuple of mesh-axis names, tuples of them or ``None``,
trailing ``None``s trimmed, as the reference's ``PartitionSpec`` holds
them.  ``axis_size``, ``resolve`` and ``pspec`` take any mesh; the port
runs one layout of blocks, a (1, tp) mesh (data 1, model tp), and
``shard_slices`` gives a rank's block of a tensor there.  ``ONE_DEVICE``
is the (1, 1) mesh: every block is the whole tensor.

Parameters are described by ``ParamDef``s and collected by a
``ParamStore``, as in the reference; the modules of ``layers``,
``attention`` and ``transformer`` materialise their own defs as
``nn.Parameter``s (``ParamModule``), on a rank of a (1, tp) mesh as that
rank's blocks, and ``init_param_`` fills them from an explicit
``torch.Generator``.  The reference draws from ``jax.random`` keys, so the
same seed gives other numbers here; the parity tests carry the
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

from repro_torch.configs.base import MeshConfig

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


Pspec = tuple          # entries: a mesh axis, a tuple of them, or None

# the sharding the port does not run yet: ROADMAP.md, queue 1
NOT_RUN = "(ROADMAP.md queue 1: sharding not yet ported)"


@dataclass(frozen=True)
class Topo:
    """A mesh and the reference's logical -> physical axis rules."""

    mesh_cfg: MeshConfig

    def axis_size(self, logical: str) -> int:
        n = 1
        for a in self._phys(logical):
            n *= self.mesh_cfg.shape[self.mesh_cfg.axis_names.index(a)]
        return n

    def _phys(self, logical: str) -> tuple[str, ...]:
        names = self.mesh_cfg.axis_names
        if logical in ("batch", "fsdp"):
            return tuple(a for a in ("pod", "data") if a in names)
        if logical in ("tp", "seq_tp"):
            return tuple(a for a in ("model",) if a in names)
        if logical == "all":
            return tuple(a for a in ("pod", "data", "model") if a in names)
        if logical == "none":
            return ()
        raise KeyError(f"unknown logical axis {logical!r}")

    def resolve(self, logical: str | None,
                dim_size: int) -> tuple[str, ...] | None:
        """Physical axes for a dim, or None if not divisible / unsharded;
        a multi-axis logical falls back to a suffix of its axes when the
        full product does not divide."""
        if logical is None:
            return None
        phys = self._phys(logical)
        while phys:
            n = 1
            for a in phys:
                n *= self.mesh_cfg.shape[self.mesh_cfg.axis_names.index(a)]
            if n > 0 and dim_size % n == 0:
                return phys
            phys = phys[1:]
        return None

    def pspec(self, axes: tuple[str | None, ...],
              shape: tuple[int, ...]) -> Pspec:
        entries: list = []
        for logical, dim in zip(axes, shape):
            phys = self.resolve(logical, dim)
            if phys is None:
                entries.append(None)
            elif len(phys) == 1:
                entries.append(phys[0])
            else:
                entries.append(phys)
        while entries and entries[-1] is None:
            entries.pop()
        return tuple(entries)

    # -- a rank's block on a (1, tp) mesh ----------------------------------
    @property
    def tp(self) -> int:
        """The ranks of the (1, tp) mesh the port runs; raises
        ``NotImplementedError`` for a mesh with data (or pod) > 1."""
        if self.axis_size("batch") != 1:
            raise NotImplementedError(
                f"the port shards over (1, tp) meshes only, not "
                f"{dict(zip(self.mesh_cfg.axis_names, self.mesh_cfg.shape))}"
                f" {NOT_RUN}")
        return self.axis_size("tp")

    def shard_slices(self, pspec: Pspec, shape: tuple[int, ...],
                     rank: int) -> tuple[slice, ...]:
        """The index of rank ``rank``'s block of a tensor of ``shape``
        laid out by ``pspec``: each dim that names "model" is cut into
        ``tp`` equal runs, the others are whole."""
        tp = self.tp
        if not 0 <= rank < tp:
            raise ValueError(f"rank {rank} outside a mesh of {tp} ranks")
        out = []
        for i, dim in enumerate(shape):
            entry = pspec[i] if i < len(pspec) else None
            names = entry if isinstance(entry, tuple) else (entry,)
            if "model" in names:
                n = dim // tp
                out.append(slice(rank * n, (rank + 1) * n))
            else:
                out.append(slice(0, dim))
        return tuple(out)


ONE_DEVICE = Topo(MeshConfig((1, 1), ("data", "model")))


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


def block_shape(index: tuple) -> tuple[int, ...]:
    """The shape of a block: a dim's entry is a slice, or a list of the
    indices it takes where the block is not one run (``MambaBlock``'s
    ``w_in``)."""
    return tuple(len(s) if isinstance(s, list) else s.stop - s.start
                 for s in index)


class ParamModule(nn.Module):
    """An ``nn.Module`` whose parameters are materialised from ``ParamDef``s
    registered by its ``register(store)`` under paths relative to it.

    With a ``group`` (a rank of a (1, tp) mesh, ``models.parallel``) each
    parameter is that rank's block of its def by ``topo``; without one, the
    whole tensor.  ``defs`` keep the whole shapes either way."""

    def _materialize(self, device: torch.device, dtype: torch.dtype | None,
                     topo: Topo = ONE_DEVICE, group=None) -> None:
        store = ParamStore()
        self.register(store)
        self.defs = store.defs
        self.topo, self.tp_group = topo, group
        for path, d in store.defs.items():
            shape = d.shape if group is None else block_shape(
                self.block(path))
            self.register_parameter(path, nn.Parameter(
                torch.empty(shape, dtype=dtype or DTYPES[d.dtype],
                            device=device), requires_grad=False))

    def block(self, path: str, rank: int | None = None) -> tuple:
        """Rank ``rank``'s index (this rank's by default) into the whole
        tensor of parameter ``path`` (``whole[index]`` is the block)."""
        d = self.defs[path]
        return self.topo.shard_slices(
            self.topo.pspec(d.axes, d.shape), d.shape,
            self.tp_group.rank if rank is None else rank)

    def split(self, path: str) -> bool:
        """On a rank, parameter ``path`` is cut (a dim that the mesh
        divides); else every rank holds it whole."""
        return self.tp_group is not None and \
            tuple(getattr(self, path).shape) != self.defs[path].shape

    def grad_shares(self, seq_sharded: bool) -> list[str]:
        """The parameters this rank holds whole whose gradient on it is
        only its share of the whole gradient, for the train step to sum
        over the ranks: with the residual cut over the sequence
        (``seq_sharded``), every one (the rank's products cover its run of
        the sequence); with a replicated residual, none (each rank computes
        the whole product)."""
        return [p for p in self.defs if not self.split(p)] \
            if seq_sharded else []

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
