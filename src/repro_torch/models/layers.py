"""Core layers: norms, RoPE, MLPs, embeddings/logits.

Each layer is an ``nn.Module`` that owns the parameters the reference's
``register`` declares (same names, shapes and dtypes), on one device.  The
RMSNorm goes through ``ops.rmsnorm`` (the CUDA kernel on the card, its
backward a kernel too); the rest is plain PyTorch, as it is jnp in the
reference.  ``chunked_ce_loss`` is the training loss over the logits head.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.common import (ParamDef, ParamModule, ParamStore,
                                       cross_entropy_loss, maybe_remat)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted dtype of the two, as jnp promotes a
    float32 activation through a bfloat16 weight (the vlm's image
    embeddings, the enc-dec's frames)."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return x @ w


class Norm(ParamModule):
    def __init__(self, name: str, dim: int, kind: str = "rmsnorm",
                 eps: float = 1e-5, *, device, dtype=None):
        super().__init__()
        if kind not in ("rmsnorm", "layernorm"):
            raise ValueError(f"unknown norm {kind!r}")
        self.name, self.dim, self.kind, self.eps = name, dim, kind, eps
        self._materialize(device, dtype)

    def register(self, store: ParamStore) -> None:
        store.add("scale", ParamDef((self.dim,), (None,), init="ones"))
        if self.kind == "layernorm":
            store.add("bias", ParamDef((self.dim,), (None,), init="zeros"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "rmsnorm":
            # PDL loads the scale before the kernel ahead of it finishes: a
            # frozen weight is safe, a trained one (the optimizer writes it
            # between steps) is not
            training = torch.is_grad_enabled() and self.scale.requires_grad
            return ops.rmsnorm(x, self.scale, self.eps, pdl=not training)
        xf = x.to(torch.float32)
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + self.eps)
        return (y * self.scale.to(torch.float32)
                + self.bias.to(torch.float32)).to(x.dtype)


def rope_freqs(dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq) integer."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., None].to(torch.float32) * freqs
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


class Mlp(ParamModule):
    """SwiGLU or GELU MLP."""

    def __init__(self, name: str, d_model: int, d_ff: int,
                 activation: str = "swiglu", *, device, dtype=None):
        super().__init__()
        if activation not in ("swiglu", "gelu"):
            raise ValueError(f"unknown activation {activation!r}")
        self.name, self.d_model, self.d_ff = name, d_model, d_ff
        self.activation = activation
        self._materialize(device, dtype)

    def register(self, store: ParamStore) -> None:
        d, f = self.d_model, self.d_ff
        if self.activation == "swiglu":
            store.add("w_gate", ParamDef((d, f), ("fsdp", "tp")))
        store.add("w_up", ParamDef((d, f), ("fsdp", "tp")))
        store.add("w_down", ParamDef((f, d), ("tp", "fsdp")))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.activation == "swiglu":
            g = matmul(x, self.w_gate)
            u = matmul(x, self.w_up)
            h = F.silu(g.to(torch.float32)).to(x.dtype) * u
        else:
            u = matmul(x, self.w_up)
            h = F.gelu(u.to(torch.float32), approximate="tanh").to(x.dtype)
        return matmul(h, self.w_down)


class Embedding(ParamModule):
    def __init__(self, name: str, vocab: int, d_model: int, tie: bool = False,
                 *, device, dtype=None):
        super().__init__()
        self.name, self.vocab, self.d_model, self.tie = name, vocab, d_model, tie
        self._materialize(device, dtype)

    def register(self, store: ParamStore) -> None:
        store.add("table", ParamDef((self.vocab, self.d_model), ("tp", "fsdp"),
                                    scale=1.0))
        if not self.tie:
            store.add("head", ParamDef((self.d_model, self.vocab),
                                       ("fsdp", "tp")))

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return F.embedding(tokens, self.table)

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        """float32 logits, the head cast to float32 as in the reference
        (with TF32 off, PyTorch's default for matmuls, so the product stays
        float32 on the card)."""
        w = self.table.T if self.tie else self.head
        return h.to(torch.float32) @ w.to(torch.float32)


def chunked_ce_loss(embedding: Embedding, h: torch.Tensor,
                    labels: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Cross-entropy over sequence chunks (the reference's choice of 512,
    256, 128 or 64 tokens), each chunk's float32 logits recomputed in the
    backward rather than saved, so they never exist at full length; the
    chunks' means summed in order and divided by their count."""
    s = h.shape[1]
    chunk = s
    for c in (512, 256, 128, 64):
        if s % c == 0 and s > c:
            chunk = c
            break
    nc = s // chunk

    def body(h_c, l_c):
        return cross_entropy_loss(embedding.logits(h_c), l_c, vocab_size)

    body = maybe_remat(body, True)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(nc):
        sl = slice(i * chunk, (i + 1) * chunk)
        total = total + body(h[:, sl], labels[:, sl])
    # a tensor divisor: a Python one becomes a reciprocal multiply on the card
    return total / torch.tensor(nc, dtype=torch.float32, device=h.device)
