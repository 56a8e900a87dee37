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
decide only how the reference shards; on one card they name the same
tensors and are kept as metadata.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import ParamDef, ParamModule, ParamStore

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
                 device, dtype=None):
        super().__init__()
        if placement not in PLACEMENTS:
            raise ValueError(f"unknown placement {placement!r}")
        self.name, self.d_model, self.d_ff = name, d_model, d_ff
        self.num_experts, self.top_k = num_experts, top_k
        self.num_shared, self.group_size = num_shared, group_size
        self.capacity_factor, self.placement = capacity_factor, placement
        self._materialize(device, dtype)

    def group(self, tokens: int) -> int:
        """Tokens a group: ``group_size`` snapped down to a divisor of
        ``tokens`` (one card: one token shard)."""
        S = min(self.group_size, tokens)
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
        """xe (E, n, d) -> (E, n, d): each expert's SwiGLU on its rows."""
        g = torch.bmm(xe, self.w_gate)
        u = torch.bmm(xe, self.w_up)
        h = F.silu(g.to(torch.float32)).to(xe.dtype) * u
        return torch.bmm(h, self.w_down)

    def _shared(self, x: torch.Tensor) -> torch.Tensor:
        g = x @ self.ws_gate
        u = x @ self.ws_up
        h = F.silu(g.to(torch.float32)).to(x.dtype) * u
        return h @ self.ws_down

    def forward(self, x: torch.Tensor):
        """x (b, s, d) or (b, d) -> (out of x's shape, aux loss)."""
        two_d = x.dim() == 2
        xs = x[:, None, :] if two_d else x
        b, s, d = xs.shape
        T = b * s
        S = self.group(T)
        G, E, C = T // S, self.num_experts, self.capacity(S)
        xg = xs.reshape(G, S, d)
        r = self._route(xg)
        sel = r.dispatched                                       # (G, S, k)
        # slot (e, g, c) of the (E, G, C) expert input, row-major; the
        # choices that reach no expert all write one spare row past the end
        # (so no boolean indexing, which would wait for the card)
        n_slots = E * G * C
        group = torch.arange(G, device=x.device)[:, None, None]
        slot = (r.topi * G + group) * C + r.pos
        dst = torch.where(sel, slot, n_slots).reshape(-1)
        xe = xg.new_zeros((n_slots + 1, d))
        xe[dst] = xg.reshape(T, 1, d).expand(T, self.top_k, d).reshape(-1, d)
        ye = self._experts(xe[:n_slots].view(E, G * C, d)).reshape(n_slots, d)
        # combine: the weights in the experts' dtype, the (at most k) terms
        # of a token summed in float32
        w = r.weight.to(ye.dtype).to(torch.float32)
        rows = ye[torch.where(sel, slot, 0)].to(torch.float32)  # (G,S,k,d)
        terms = torch.where(sel[..., None], w[..., None] * rows,
                            torch.zeros((), device=x.device))
        out = terms.sum(dim=2).to(ye.dtype).reshape(b, s, d)
        if self.num_shared:
            out = out + self._shared(xs)
        if two_d:
            out = out[:, 0, :]
        return out, r.aux
