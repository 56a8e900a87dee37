"""Mixture-of-Experts with GShard-style capacity-limited dispatch.

The reference groups the tokens into (G, S) groups, routes each group with
a float32 softmax and top-k, gives every expert C = ceil(S·k·cf / E) slots
a group, fills them pass by pass (the j-th choices of every token, in token
order, after the (j-1)-th), and drops what finds no slot: a dropped choice
adds nothing, so a token whose choices are all dropped passes through the
residual unchanged.  Its dispatch and combine are one-hot einsums over
(G, S, E, C); the port keeps the same slots as indices: every slot holds at
most one token, so dispatch is an exact scatter of token rows into the
(E, G, C, d) expert input, and combine gathers each token's (at most k)
expert rows and sums them in float32.  Routing, dispatch and combine are
jnp in the reference (no Pallas kernel) and plain PyTorch here; the expert
products are ``torch.bmm`` (cuBLAS on the card).

The four placements (``ep``, ``gathered``, ``ep_decode``, ``tp_decode``)
decide how the reference shards; on one card they name the same tensors.
They also size the token groups: the reference cuts the T tokens into
groups of ``T // n_shards`` (at most ``group_size``), with ``n_shards`` the
size of the placement's token axis under its ``Topo``: 1 for ``ep``,
``ep_decode`` and ``tp_decode`` on a (1, tp) mesh, but tp for ``gathered``
(token axis ``"all"``), so ``gathered``'s routing, and the tokens it drops,
follow the mesh (``group``).

On a rank of a (1, tp) mesh (a ``group``) the block holds its blocks by
the reference's pspecs:

* ``ep`` (prefill, tp divides E): E/tp whole experts;
* ``ep_decode`` (decode; its experts axis ``fsdp`` has size 1 here),
  ``tp_decode`` and ``gathered`` (prefill, tp does not divide E): every
  expert's d_ff/tp columns of ``w_gate`` and ``w_up`` and rows of
  ``w_down``;
* the shared experts' ``ws_*`` column- then row-parallel, the router
  whole.

Every rank routes all of a group's tokens (a sequence-sharded input is
gathered first), so the capacity slots, a cumsum in token order across a
group, are the reference's; the routing is the same on every rank, bit for
bit, as every rank computes it from the same bits.  A rank dispatches only
to the experts it holds and runs its part of their products.  ``ep``
holds whole experts: it combines its terms as float32 partials, which
the ranks sum in float32 and round once, onto the rank's run of the
sequence or whole (``layers.reduce_partials``).  The d_ff-cut placements
leave float32 partials of ``w_down``: the ranks sum each token's (at most
k) expert rows in float32 (onto the rank's run, or whole) and round each
row to the activations' dtype, as the unsharded block's products round
each expert's output, before the combine.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import (ONE_DEVICE, ParamDef, ParamModule,
                                       ParamStore)
from repro_torch.models.layers import (bmm_f32, matmul_f32, reduce_partials,
                                       whole_output)

PLACEMENTS = ("ep", "gathered", "ep_decode", "tp_decode")


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``F.one_hot(idx, n)`` (int64) as its CUDA path computes it, a scatter
    of ones into zeros, on every device: on the CPU ``F.one_hot`` first
    checks the indices on the host, on meta it compares, so a step would
    count other ops on each."""
    return torch.zeros(idx.shape + (n,), dtype=torch.int64,
                       device=idx.device).scatter_(-1, idx[..., None], 1)


class Route(NamedTuple):
    """The routing of (G, S) groups: for each token's j-th choice, its
    expert ``topi`` (G, S, k), its slot ``pos`` in that expert's group
    capacity, and its combine weight ``weight`` (float32; 0 where the choice
    found no slot).  ``aux`` is the load-balancing loss."""
    topi: torch.Tensor
    pos: torch.Tensor
    weight: torch.Tensor
    aux: torch.Tensor

    @property
    def dispatched(self) -> torch.Tensor:
        """The choices that reach an expert: the reference's
        ``dispatch = combine > 0``."""
        return self.weight > 0


class MoE(ParamModule):
    def __init__(self, name: str, d_model: int, num_experts: int, top_k: int,
                 d_ff: int, num_shared: int = 0, group_size: int = 256,
                 capacity_factor: float = 1.25, placement: str = "ep", *,
                 device, dtype=None, topo=ONE_DEVICE, group=None):
        super().__init__()
        if placement not in PLACEMENTS:
            raise ValueError(f"unknown placement {placement!r}")
        self.name, self.d_model, self.d_ff = name, d_model, d_ff
        self.num_experts, self.top_k = num_experts, top_k
        self.num_shared, self.group_size = num_shared, group_size
        self.capacity_factor, self.placement = capacity_factor, placement
        self._materialize(device, dtype, topo, group)

    @property
    def token_axis(self) -> str | None:
        """The logical axis the reference shards the token groups over."""
        return {"ep": "batch", "gathered": "all", "ep_decode": None,
                "tp_decode": "batch"}[self.placement]

    def group(self, tokens: int) -> int:
        """Tokens a group: ``group_size``, or the tokens of one shard of the
        token axis under ``topo`` if fewer, snapped down to a divisor of
        ``tokens``."""
        shards = self.topo.axis_size(self.token_axis) \
            if self.token_axis else 1
        S = min(self.group_size, max(tokens // max(shards, 1), 1))
        while S > 1 and tokens % S:
            S -= 1
        return S

    def capacity(self, group_tokens: int) -> int:
        c = math.ceil(group_tokens * self.top_k * self.capacity_factor
                      / self.num_experts)
        return max(c, 1)

    def register(self, store: ParamStore) -> None:
        d, E, f = self.d_model, self.num_experts, self.d_ff
        ax_in, ax_out, ax_sh_in, ax_sh_out = {
            "ep": (("tp", "fsdp", None), ("tp", None, "fsdp"),
                   ("fsdp", "tp"), ("tp", "fsdp")),
            "gathered": ((None, "fsdp", "tp"), (None, "tp", "fsdp"),
                         ("fsdp", "tp"), ("tp", "fsdp")),
            "ep_decode": (("fsdp", None, "tp"), ("fsdp", "tp", None),
                          (None, "tp"), ("tp", None)),
            "tp_decode": ((None, None, "tp"), (None, "tp", None),
                          (None, "tp"), ("tp", None)),
        }[self.placement]
        store.add("router", ParamDef((d, E), (None, None), scale=0.02))
        store.add("w_gate", ParamDef((E, d, f), ax_in))
        store.add("w_up", ParamDef((E, d, f), ax_in))
        store.add("w_down", ParamDef((E, f, d), ax_out))
        if self.num_shared:
            fs = self.num_shared * f
            store.add("ws_gate", ParamDef((d, fs), ax_sh_in))
            store.add("ws_up", ParamDef((d, fs), ax_sh_in))
            store.add("ws_down", ParamDef((fs, d), ax_sh_out))

    # ------------------------------------------------------------------
    def _probs(self, xg: torch.Tensor) -> torch.Tensor:
        """Router probabilities (..., E) float32.  The reference takes the
        logits as float32 products of the activation-dtype operands; both
        operands upcast give the same products exactly."""
        logits = xg.to(torch.float32) @ self.router.to(xg.dtype).to(
            torch.float32)
        return torch.softmax(logits, dim=-1)

    def _route(self, xg: torch.Tensor) -> Route:
        """xg (G, S, d) -> the slots of every token's top-k choices."""
        G, S, _ = xg.shape
        E, k = self.num_experts, self.top_k
        C = self.capacity(S)
        probs = self._probs(xg)                                  # (G, S, E)
        # lax.top_k puts the lower index first on ties: a stable sort does
        v, i = torch.sort(probs, dim=-1, descending=True, stable=True)
        topv, topi = v[..., :k], i[..., :k]
        topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)

        # aux load-balancing loss (Switch) from the first choices
        frac_tokens = _one_hot(topi[..., 0], E).to(torch.float32).mean(
            dim=(0, 1))
        aux = E * torch.sum(frac_tokens * probs.mean(dim=(0, 1)))

        counts = torch.zeros((G, E), dtype=torch.int64, device=xg.device)
        pos = torch.empty_like(topi)
        for j in range(k):
            mask = _one_hot(topi[..., j], E)                    # (G, S, E)
            before = counts[:, None, :] + torch.cumsum(mask, dim=1) - mask
            pos[..., j] = before.gather(-1, topi[..., j:j + 1])[..., 0]
            keep = pos[..., j] < C
            counts = counts + (mask * keep[..., None]).sum(dim=1)
        weight = torch.where(pos < C, topv, torch.zeros_like(topv))
        return Route(topi, pos, weight, aux)

    def _experts(self, xe: torch.Tensor) -> torch.Tensor:
        """xe (E, n, d) -> (E, n, d): each expert's SwiGLU on its rows; on a
        rank that holds d_ff columns, float32 partials of ``w_down``."""
        g = torch.bmm(xe, self.w_gate)
        u = torch.bmm(xe, self.w_up)
        h = F.silu(g.to(torch.float32)).to(xe.dtype) * u
        if self.split("w_down") and not self._expert_cut:
            return bmm_f32(h, self.w_down)
        return torch.bmm(h, self.w_down)

    def _shared(self, x: torch.Tensor, seq_sharded: bool) -> torch.Tensor:
        """The shared experts on x (b, s, d) whole; on a rank their d_ff
        columns, then ``ws_down``'s partials summed (onto the rank's run of
        the sequence when ``seq_sharded``)."""
        g = x @ self.ws_gate
        u = x @ self.ws_up
        h = F.silu(g.to(torch.float32)).to(x.dtype) * u
        if self.split("ws_down"):
            return reduce_partials(matmul_f32(h, self.ws_down),
                                   self.tp_group, seq_sharded, h.dtype)
        return whole_output(h @ self.ws_down, self.tp_group, seq_sharded)

    @property
    def _expert_cut(self) -> bool:
        """On a rank, the experts axis is cut (``ep``): it holds E/tp."""
        return self.split("w_gate") and \
            self.w_gate.shape[0] != self.num_experts

    def forward(self, x: torch.Tensor, seq_sharded: bool = False):
        """x (b, s, d) or (b, d) -> (out of x's shape, aux loss); on a rank,
        x and the output are the rank's run of the sequence when
        ``seq_sharded``."""
        grp = self.tp_group
        if grp is not None and seq_sharded:
            x = grp.all_gather(x, 1)
        two_d = x.dim() == 2
        xs = x[:, None, :] if two_d else x
        b, s, d = xs.shape
        T = b * s
        S = self.group(T)
        G, C = T // S, self.capacity(S)
        xg = xs.reshape(G, S, d)
        r = self._route(xg)
        if self._expert_cut:     # the choices of the experts held here
            held = self.block("w_gate")[0]
            E = held.stop - held.start
            sel = r.dispatched & (r.topi >= held.start) & \
                (r.topi < held.stop)
            expert = r.topi - held.start
        else:
            E, sel, expert = self.num_experts, r.dispatched, r.topi
        # slot (e, g, c) of the (E, G, C) expert input, row-major; the
        # choices that reach no expert here all write one spare row past
        # the end (so no boolean indexing, which would wait for the card)
        n_slots = E * G * C
        group = torch.arange(G, device=x.device)[:, None, None]
        slot = (expert * G + group) * C + r.pos
        dst = torch.where(sel, slot, n_slots).reshape(-1)
        xe = xg.new_zeros((n_slots + 1, d))
        xe[dst] = xg.reshape(T, 1, d).expand(T, self.top_k, d).reshape(-1, d)
        ye = self._experts(xe[:n_slots].view(E, G * C, d)).reshape(n_slots, d)
        # combine: the weights in the experts' dtype, the (at most k) terms
        # of a token summed in float32
        w = r.weight.to(x.dtype).to(torch.float32)
        rows = ye[torch.where(sel, slot, 0)].to(torch.float32)  # (G,S,k,d)
        if self.split("w_down") and not self._expert_cut:
            # each expert row's float32 partials summed over the ranks,
            # then rounded as the unsharded product rounds it
            k = self.top_k
            rows, sel, w = (t.reshape(b, s, k, *t.shape[3:])
                            for t in (rows, sel, w))
            rows = grp.reduce_scatter(rows, 1) if seq_sharded \
                else grp.all_reduce(rows)
            rows = rows.to(x.dtype).to(torch.float32)
            if seq_sharded:
                n = s // grp.size
                sel, w = (t.narrow(1, grp.rank * n, n) for t in (sel, w))
                s = n
        terms = torch.where(sel[..., None], w[..., None] * rows,
                            torch.zeros((), device=x.device))
        partial = terms.sum(dim=-2).reshape(b, s, d)
        if self._expert_cut:           # the ranks' terms, summed
            out = reduce_partials(partial, grp, seq_sharded, x.dtype)
        elif self.split("w_down"):     # the rank's rows, whole or its run
            out = partial.to(x.dtype)
        else:
            out = whole_output(partial.to(x.dtype), grp, seq_sharded)
        if self.num_shared:
            out = out + self._shared(xs, seq_sharded)
        if two_d:
            out = out[:, 0, :]
        return out, r.aux
