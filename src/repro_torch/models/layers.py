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
  columns, then ``all_gather`` over the vocabulary; the training loss
  (``chunked_ce_loss``) keeps the rank's columns and reduces the
  softmax's max, its sum and the gold logit over the ranks instead, as
  the reference's ``cross_entropy_loss`` is written for vocab-sharded
  logits;
* ``Mlp``: ``w_gate``/``w_up`` column-parallel and ``w_down``
  row-parallel over d_ff, the input gathered over the sequence first;
* ``Norm``: its kernel on the rank's rows (the scale is replicated).

Under autograd the collectives are ``models.parallel``'s ``gather``,
``scatter``, ``reduce`` and ``replicate``, so each rank's backward runs
their conjugates: a replicated activation that enters cut weights is
gathered over the sequence (its gradient reduce-scattered) or, for a
replicated residual, ``replicate``d (its gradient all-reduced).  A
replicated parameter whose gradient on a rank is its share of the whole
(a norm scale on the rank's run of the sequence, a bias that meets the
rank's heads only) is named by ``ParamModule.grad_shares`` and summed by
the train step.

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
from repro_torch.models.common import (NOT_RUN, ONE_DEVICE, ParamDef,
                                       ParamModule, ParamStore,
                                       cross_entropy_loss, maybe_remat)
from repro_torch.models.parallel import gather, reduce, replicate, scatter


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted dtype of the two, as jnp promotes a
    float32 activation through a bfloat16 weight (the vlm's image
    embeddings, the enc-dec's frames)."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return x @ w


class _MatmulF32(torch.autograd.Function):
    """``torch.mm`` with a float32 output (which autograd cannot
    differentiate); its backward takes the gradient in the operands'
    dtype, as the rounded product's backward receives it (the partials'
    gradient is a gradient of that dtype, widened, unless the ranks summed
    it: then it rounds once), and runs the two products of one card's
    backward."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        return torch.mm(x2, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        g = g.to(x2.dtype)
        return g @ w.T, x2.T @ g


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in float32: the operands' products summed in float32 and
    not rounded to their dtype (on the card one GEMM with a float32
    output; on the host the operands widened, which is exact)."""
    if x.dtype == w.dtype == torch.float32:
        return x @ w
    if x.device.type == "cuda" and x.dtype == w.dtype:
        out = _MatmulF32.apply(x.reshape(-1, x.shape[-1]), w)
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
    out = scatter(partial, group, 1) if seq_sharded \
        else reduce(partial, group)
    return out.to(dtype)


def seq_run(x: torch.Tensor, group) -> torch.Tensor:
    """The rank's run of x's sequence (dim 1).  Under autograd a rank's
    gradient of x covers its run only: its share of the whole, which the
    ranks' reduce-scatter of the gathered input sums, or, for a
    parameter, the train step (``ParamModule.grad_shares``)."""
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
            x = gather(x, grp, 1)
        elif self.split("w_down"):
            x = replicate(x, grp)
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
        return scatter(out, g, 1) if seq_sharded else reduce(out, g)

    @property
    def head_cut(self) -> bool:
        """On a rank, the logits' head holds the rank's vocabulary
        columns."""
        return self.split("table" if self.tie else "head")

    def rank_logits(self, h: torch.Tensor) -> torch.Tensor:
        """float32 logits, the head cast to float32 as in the reference
        (with TF32 off, PyTorch's default for matmuls, so the product stays
        float32 on the card); on a rank whose head is cut, its vocabulary
        columns."""
        w = self.table.T if self.tie else self.head
        return h.to(torch.float32) @ w.to(torch.float32)

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        """float32 logits (``rank_logits``); on a rank, h is whole and so
        are the logits, gathered over the vocabulary."""
        out = self.rank_logits(h)
        return self.tp_group.all_gather(out, -1) if self.head_cut else out


def vocab_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                        vocab_size: int, lo: int, group) -> torch.Tensor:
    """``cross_entropy_loss`` over logits cut over the vocabulary: this
    rank's columns [lo, lo + logits.shape[-1]).  The max (without a
    gradient, as ``logsumexp`` takes it), the sum of exponentials and the
    gold logit are reduced over the ranks, so every rank holds the loss,
    and each its columns' gradient."""
    logits = logits.to(torch.float32)
    m = group.all_reduce(logits.detach().amax(-1), "max")
    lse = torch.log(reduce(torch.exp(logits - m[..., None]).sum(-1),
                           group)) + m
    local = labels.long() - lo
    inside = (local >= 0) & (local < logits.shape[-1])
    gold = torch.gather(logits, -1, torch.where(inside, local, 0)[..., None])
    gold = reduce(torch.where(inside, gold[..., 0], 0.0), group)
    mask = ((labels >= 0) & (labels < vocab_size)).to(torch.float32)
    loss = (lse - gold) * mask
    return loss.sum() / torch.clamp(mask.sum(), min=1.0)


def chunked_ce_loss(embedding: Embedding, h: torch.Tensor,
                    labels: torch.Tensor, vocab_size: int,
                    seq_sharded: bool = False) -> torch.Tensor:
    """Cross-entropy over sequence chunks (the reference's choice of 512,
    256, 128 or 64 tokens), each chunk's float32 logits recomputed in the
    backward rather than saved, so they never exist at full length; the
    chunks' means summed in order and divided by their count.  On a rank
    (whose h is its run of the sequence when ``seq_sharded``) h is
    gathered whole, each chunk's logits are the rank's vocabulary columns
    (``vocab_cross_entropy``), and the collectives of a chunk run again
    in its recomputation, in the same order on every rank."""
    g = embedding.tp_group
    if g is not None:
        if not embedding.head_cut:
            raise NotImplementedError(
                f"a vocabulary of {embedding.vocab} that {g.size} ranks do "
                f"not divide {NOT_RUN}")
        h = gather(h, g, 1) if seq_sharded else replicate(h, g)
        lo = embedding.block("table" if embedding.tie else "head")[
            0 if embedding.tie else 1].start
    s = h.shape[1]
    chunk = s
    for c in (512, 256, 128, 64):
        if s % c == 0 and s > c:
            chunk = c
            break
    nc = s // chunk

    def body(h_c, l_c):
        if g is None:
            return cross_entropy_loss(embedding.logits(h_c), l_c,
                                      vocab_size)
        return vocab_cross_entropy(embedding.rank_logits(h_c), l_c,
                                   vocab_size, lo, g)

    body = maybe_remat(body, True)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(nc):
        sl = slice(i * chunk, (i + 1) * chunk)
        total = total + body(h[:, sl], labels[:, sl])
    # a tensor divisor: a Python one becomes a reciprocal multiply on the card
    return total / torch.tensor(nc, dtype=torch.float32, device=h.device)
