"""Core layers: norms, RoPE, MLPs, embeddings/logits.

Each layer is an ``nn.Module`` that owns the parameters the reference's
``register`` declares (same names, shapes, dtypes and logical axes).  The
RMSNorm goes through ``ops.rmsnorm`` (the CUDA kernel on the card, its
backward a kernel too); the rest is plain PyTorch, as it is jnp in the
reference.  ``chunked_ce_loss`` is the training loss over the logits head.

On a rank of a (1, tp) mesh (a ``group``, ``models.parallel``) the layers
hold their blocks by the reference's pspecs and run the collectives the
reference's layouts imply, Megatron with a sequence-sharded residual:

* ``Embedding``: the vocabulary cut into tp runs; a masked local lookup,
  then a sum over the ranks onto the rank's run of the sequence
  (``reduce_scatter``) or, for a replicated residual, whole
  (``all_reduce``); a token's row is non-zero on one rank only, so the sum
  is exact;
* ``Embedding.logits``: the float32 product on the rank's vocabulary
  columns, then ``all_gather`` over the vocabulary;
* ``Mlp``: ``w_gate``/``w_up`` column-parallel and ``w_down``
  row-parallel over d_ff, the input gathered over the sequence first;
* ``Norm``: its kernel on the rank's rows (the scale is replicated).

A row-parallel product's partials are taken in float32 (``matmul_f32``:
bfloat16 operands, float32 accumulation, not rounded) and summed over the
ranks in float32, then rounded once to the activations' dtype
(``reduce_partials``), where the unsharded product rounds its float32
accumulation once.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.common import (ONE_DEVICE, ParamDef, ParamModule,
                                       ParamStore, cross_entropy_loss,
                                       maybe_remat)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted dtype of the two, as jnp promotes a
    float32 activation through a bfloat16 weight (the vlm's image
    embeddings, the enc-dec's frames)."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return x @ w


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in float32: the operands' products summed in float32 and
    not rounded to their dtype (on the card one GEMM with a float32
    output; on the host the operands widened, which is exact)."""
    if x.dtype == w.dtype == torch.float32:
        return x @ w
    if x.device.type == "cuda" and x.dtype == w.dtype:
        out = torch.mm(x.reshape(-1, x.shape[-1]), w,
                       out_dtype=torch.float32)
        return out.reshape(*x.shape[:-1], w.shape[-1])
    return x.to(torch.float32) @ w.to(torch.float32)


def bmm_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``torch.bmm(x, w)`` in float32, as ``matmul_f32``: one batched GEMM
    with a float32 output on the card, the operands widened on the
    host."""
    if x.dtype == w.dtype == torch.float32:
        return torch.bmm(x, w)
    if x.device.type == "cuda" and x.dtype == w.dtype:
        return torch.bmm(x, w, out_dtype=torch.float32)
    return torch.bmm(x.to(torch.float32), w.to(torch.float32))


def reduce_partials(partial: torch.Tensor, group, seq_sharded: bool,
                    dtype: torch.dtype) -> torch.Tensor:
    """A row-parallel product's float32 partials (b, s, d) or (b, d)
    summed over the ranks in float32, onto the rank's run of the sequence
    (``seq_sharded``) or whole, then rounded to ``dtype``."""
    out = group.reduce_scatter(partial, 1) if seq_sharded \
        else group.all_reduce(partial)
    return out.to(dtype)


def seq_run(x: torch.Tensor, group) -> torch.Tensor:
    """The rank's run of x's sequence (dim 1)."""
    n = x.shape[1] // group.size
    return x.narrow(1, group.rank * n, n)


def whole_output(out: torch.Tensor, group,
                 seq_sharded: bool) -> torch.Tensor:
    """A product that no rank cut, computed whole on every rank: on a rank,
    its run of the sequence when ``seq_sharded``."""
    return seq_run(out, group) if group is not None and seq_sharded else out


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
    """SwiGLU or GELU MLP; ``zero3`` gives its weights the reference's
    fsdp axis (off in decode layouts)."""

    def __init__(self, name: str, d_model: int, d_ff: int,
                 activation: str = "swiglu", zero3: bool = True, *, device,
                 dtype=None, topo=ONE_DEVICE, group=None):
        super().__init__()
        if activation not in ("swiglu", "gelu"):
            raise ValueError(f"unknown activation {activation!r}")
        self.name, self.d_model, self.d_ff = name, d_model, d_ff
        self.activation, self.zero3 = activation, zero3
        self._materialize(device, dtype, topo, group)

    def register(self, store: ParamStore) -> None:
        d, f = self.d_model, self.d_ff
        fs = "fsdp" if self.zero3 else None
        if self.activation == "swiglu":
            store.add("w_gate", ParamDef((d, f), (fs, "tp")))
        store.add("w_up", ParamDef((d, f), (fs, "tp")))
        store.add("w_down", ParamDef((f, d), ("tp", fs)))

    def forward(self, x: torch.Tensor,
                seq_sharded: bool = False) -> torch.Tensor:
        """x (b, s, d) or (b, d); on a rank, ``seq_sharded`` says that x
        holds the rank's run of the sequence (and so does the output)."""
        grp = self.tp_group
        if grp is not None and seq_sharded:
            x = grp.all_gather(x, 1)
        if self.activation == "swiglu":
            g = matmul(x, self.w_gate)
            u = matmul(x, self.w_up)
            h = F.silu(g.to(torch.float32)).to(x.dtype) * u
        else:
            u = matmul(x, self.w_up)
            h = F.gelu(u.to(torch.float32), approximate="tanh").to(x.dtype)
        if not self.split("w_down"):      # d_ff not cut: whole products
            return whole_output(matmul(h, self.w_down), grp, seq_sharded)
        return reduce_partials(matmul_f32(h, self.w_down), grp, seq_sharded,
                               torch.promote_types(h.dtype,
                                                   self.w_down.dtype))


class Embedding(ParamModule):
    def __init__(self, name: str, vocab: int, d_model: int, tie: bool = False,
                 *, device, dtype=None, topo=ONE_DEVICE, group=None):
        super().__init__()
        self.name, self.vocab, self.d_model, self.tie = name, vocab, d_model, tie
        self._materialize(device, dtype, topo, group)

    def register(self, store: ParamStore) -> None:
        store.add("table", ParamDef((self.vocab, self.d_model), ("tp", "fsdp"),
                                    scale=1.0))
        if not self.tie:
            store.add("head", ParamDef((self.d_model, self.vocab),
                                       ("fsdp", "tp")))

    def embed(self, tokens: torch.Tensor,
              seq_sharded: bool = False) -> torch.Tensor:
        """tokens (b, s) or (b,) -> (b, s, d) or (b, d); on a rank, the
        rank's run of the sequence when ``seq_sharded``, else whole."""
        g = self.tp_group
        if not self.split("table"):
            return whole_output(F.embedding(tokens, self.table), g,
                                seq_sharded)
        rows = self.block("table")[0]
        local = tokens - rows.start
        mine = (local >= 0) & (local < self.table.shape[0])
        out = F.embedding(torch.where(mine, local, 0), self.table)
        out = torch.where(mine[..., None], out, 0)
        return g.reduce_scatter(out, 1) if seq_sharded else g.all_reduce(out)

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        """float32 logits, the head cast to float32 as in the reference
        (with TF32 off, PyTorch's default for matmuls, so the product stays
        float32 on the card); on a rank, h is whole and so are the logits,
        gathered over the vocabulary."""
        w = self.table.T if self.tie else self.head
        out = h.to(torch.float32) @ w.to(torch.float32)
        cut = self.split("table" if self.tie else "head")
        return self.tp_group.all_gather(out, -1) if cut else out


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
