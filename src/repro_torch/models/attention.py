"""Attention blocks: GQA with prefill through the flash kernel, and
DeepSeek-V2's latent attention (MLA); decode in plain PyTorch against a
cache.

The reference computes prefill attention with its jnp ``chunked_attention``
and names the Pallas kernel as the TPU execution path; the port's GQA
prefill calls ``ops.flash_attention`` (the CUDA kernel on the card, the
exact softmax on the CPU), which computes the same function in float32
without the jnp path's bfloat16 rounding of ``q * scale`` and of the
softmax weights.  ``decode_attention`` is jnp in the reference and plain
PyTorch here, rounding where the reference rounds.

A cross-attention block (``is_cross``: the vlm's gated layers, the
enc-dec decoder's) projects k and v from a fixed ``memory`` (image
embeddings, the encoder's output) without RoPE and attends to all of it
through the kernel, non-causal with sq != skv; its decode projects q alone
and reads the memory's cache, which it leaves as it is.  A float32 memory
through bfloat16 weights promotes the projections to float32, as jnp does,
and the attention then runs in float32 on q widened exactly, the output
cast back to q's dtype.

MLA's prefill attends with a q/k width (``qk_nope + qk_rope``) other than
its value width; the reference runs it through ``chunked_attention``, which
allows that, while its Pallas kernel (and the port's) takes one head dim
for q, k and v.  So it is the one attention path without the kernel:
``latent_prefill_attention`` is plain PyTorch that rounds where the
reference rounds.  Its latent RMS norm is the ``rmsnorm`` kernel's
function and goes through ``ops.rmsnorm``.

The weight layouts (``megatron``, ``fsdp_sp``, ``decode_rp``) decide how
the reference shards; on one card they name the same tensors.  On a rank
of a (1, tp) mesh (a ``group``) a GQA block holds its blocks by the
reference's pspecs and runs two of them:

* ``megatron`` (prefill): the normed residual gathered over the sequence;
  q on the rank's heads, k and v on the rank's run of ``head_dim`` and
  gathered over it before RoPE (the rotation needs whole heads); the
  rank's flash kernel launch on its heads against the KV heads they read;
  ``wo`` row-parallel over the heads, its float32 partials
  reduce-scattered onto the rank's run of the sequence.  The caches it
  returns are whole.  A cross block projects k and v from the whole
  memory the same way, without RoPE or the causal mask.
* ``decode_rp``: ``wq``/``wk``/``wv`` cut over d_model, so the rank's run
  of x gives partial q, k, v, summed over the ranks in float32; the new
  token's k and v written by the rank whose run of the cache holds
  position t; ``decode_attention`` over the sequence-sharded cache; ``wo``
  cut over its output d, gathered after.  A cross block sums q alone and
  attends to every position of its memory cache (the rank's run of it,
  or all of it where tp does not divide the memory).

The replicated biases are added once: ``bq`` sliced to the rank's heads
and ``bk`` / ``bv`` after the gather in ``megatron``, ``bq`` / ``bk`` /
``bv`` after the sum and ``bo`` after the gather in ``decode_rp``, ``bo``
to the rank's reduce-scattered rows in ``megatron``.

MLA on a rank (``MLAttention``): ``megatron`` cuts ``wq``, ``w_kvb`` and
``wo`` over the heads, and every rank computes the whole latent (the
caches) with its whole ``w_kva``; ``decode_rp`` cuts ``wq`` and ``w_kva``
over d_model (their partials summed in float32 before the latent norm),
``w_kvb`` over its last dim (a rank may hold only k_nope columns or only
value columns) and ``wo`` over its output d, and reduces the scores'
softmax and the latent output over the sequence-sharded caches.

Training runs ``megatron`` over the ranks (``LM.loss``): the
collectives above are ``models.parallel``'s autograd ones, so the
gathers' gradients are reduce-scattered and the partials' gathered back;
with a replicated residual (a length tp does not divide) x enters the
rank's heads through ``replicate``, its gradient summed over the ranks.
The flash forward and its backward kernel run on the rank's heads, as
many launches a layer as on one card.  The biases of q, k and v, and a
``wk`` / ``wv`` held whole where tp does not divide head_dim, meet the
rank's heads only: their gradients are shares (``grad_shares``) that the
train step sums over the ranks (ranks that read one KV head add into the
same columns).

``fsdp_sp`` (heads that tp does not divide) over ranks is not ported
(ROADMAP.md queue 1).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models.common import (NOT_RUN, ONE_DEVICE, ParamDef,
                                       ParamModule, ParamStore)
from repro_torch.models.layers import (apply_rope, bmm_f32, matmul,
                                       matmul_f32, reduce_partials,
                                       whole_output)
from repro_torch.models.parallel import gather, replicate

_NEG = -1e30


def softmax_values(s: torch.Tensor, v: torch.Tensor, spec: str,
                   group=None) -> torch.Tensor:
    """float32 scores ``s`` (scaled and masked, keys on the last dim)
    softmaxed and applied to the values ``v`` by ``torch.einsum(spec, p,
    v)``, float32 out; the weights ``p / l`` rounded to ``v``'s dtype
    where the reference rounds them.  With a ``group`` the keys are the
    rank's run of a sequence-sharded cache: the max and the sum are
    reduced over the ranks, and the local products with v summed in
    float32."""
    m = s.amax(dim=-1, keepdim=True)
    if group is not None:
        m = group.all_reduce(m, "max")
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    if group is not None:
        l = group.all_reduce(l)
    o = torch.einsum(spec, (p / l).to(v.dtype).to(torch.float32),
                     v.to(torch.float32))
    return o if group is None else group.all_reduce(o)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, t: int,
                     softmax_scale: float | None = None, group=None,
                     lo: int = 0) -> torch.Tensor:
    """q (b, H, dh) against caches (b, S, KV, dh) at positions <= t; the
    caches hold positions [lo, lo + S).  With a ``group`` they are the
    rank's run of a sequence-sharded cache: the scores stay local and
    ``softmax_values`` reduces the softmax and the output over the
    ranks."""
    b, H, dh = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    scale = softmax_scale if softmax_scale is not None else dh ** -0.5
    qg = (q * scale).reshape(b, KV, H // KV, dh)
    s = torch.einsum("bkpd,bskd->bkps", qg.to(torch.float32),
                     k_cache.to(torch.float32))
    pos = torch.arange(lo, lo + S, device=q.device)
    s = s.masked_fill(pos > t, _NEG)
    o = softmax_values(s, v_cache, "bkps,bskd->bkpd", group)
    return o.reshape(b, H, dh).to(q.dtype)


def rank_kv_heads(H: int, KV: int, tp: int, rank: int):
    """The KV heads that q heads [rank H/tp, (rank + 1) H/tp) read under
    GQA (head h reads h // (H / KV)): a slice when the kernel's own map of
    the local heads onto it (h' // (H_local / KV_local)) pairs them right,
    else an index of one KV head per q head."""
    hl, g = H // tp, H // KV
    kv = [(rank * hl + h) // g for h in range(hl)]
    lo, n = kv[0], kv[-1] - kv[0] + 1
    if hl % n == 0 and all(kv[h] == lo + h // (hl // n) for h in range(hl)):
        return slice(lo, lo + n)
    return torch.tensor(kv)


class Attention(ParamModule):
    def __init__(self, name: str, d_model: int, num_heads: int,
                 num_kv_heads: int, head_dim: int, layout: str,
                 rope_theta: float = 10_000.0, use_rope: bool = True,
                 qkv_bias: bool = False, out_bias: bool = False,
                 causal: bool = True, is_cross: bool = False, *, device,
                 dtype=None, topo=ONE_DEVICE, group=None):
        super().__init__()
        self.name, self.d_model = name, d_model
        self.num_heads, self.num_kv_heads = num_heads, num_kv_heads
        self.head_dim, self.layout = head_dim, layout
        self.rope_theta, self.use_rope = rope_theta, use_rope
        self.qkv_bias, self.out_bias = qkv_bias, out_bias
        self.causal, self.is_cross = causal, is_cross
        if group is not None and layout == "fsdp_sp":
            raise NotImplementedError(f"{name}: {layout} over ranks "
                                      f"{NOT_RUN}")
        self._materialize(device, dtype, topo, group)

    def register(self, store: ParamStore) -> None:
        d, H, KV, dh = (self.d_model, self.num_heads, self.num_kv_heads,
                        self.head_dim)
        if self.layout == "megatron":
            ax_q, ax_kv, ax_o = (("fsdp", "tp", None), ("fsdp", None, "tp"),
                                 ("tp", None, "fsdp"))
        elif self.layout == "fsdp_sp":
            ax_q, ax_kv, ax_o = (("fsdp", None, "tp"), ("fsdp", None, "tp"),
                                 (None, "tp", "fsdp"))
        else:  # decode_rp
            ax_q, ax_kv, ax_o = (("tp", None, None), ("tp", None, None),
                                 (None, None, "tp"))
        store.add("wq", ParamDef((d, H, dh), ax_q))
        store.add("wk", ParamDef((d, KV, dh), ax_kv))
        store.add("wv", ParamDef((d, KV, dh), ax_kv))
        store.add("wo", ParamDef((H, dh, d), ax_o))
        if self.qkv_bias:
            store.add("bq", ParamDef((H, dh), (None, None), init="zeros"))
            store.add("bk", ParamDef((KV, dh), (None, None), init="zeros"))
            store.add("bv", ParamDef((KV, dh), (None, None), init="zeros"))
        if self.out_bias:
            store.add("bo", ParamDef((d,), (None,), init="zeros"))

    def grad_shares(self, seq_sharded: bool) -> list[str]:
        """``ParamModule.grad_shares``; with a replicated residual too,
        the biases of q, k and v and a replicated ``wk`` / ``wv``: each
        rank's heads read only their part of them."""
        whole = super().grad_shares(True)
        return whole if seq_sharded else [p for p in whole if p != "bo"]

    # -- projections -----------------------------------------------------
    @staticmethod
    def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """einsum("bsd,dhk->bshk") as one matmul."""
        d, h, k = w.shape
        return matmul(x, w.reshape(d, h * k)).unflatten(-1, (h, k))

    def _q(self, x: torch.Tensor) -> torch.Tensor:
        q = self._proj(x, self.wq)
        return q + self.bq if self.qkv_bias else q

    def _qkv(self, x: torch.Tensor, memory: torch.Tensor | None = None):
        src = memory if self.is_cross else x
        k = self._proj(src, self.wk)
        v = self._proj(src, self.wv)
        if self.qkv_bias:
            k = k + self.bk
            v = v + self.bv
        return self._q(x), k, v

    def _out(self, o: torch.Tensor) -> torch.Tensor:
        H, dh, d = self.wo.shape
        out = matmul(o.flatten(-2), self.wo.reshape(H * dh, d))
        if self.out_bias:
            out = out + self.bo
        return out

    # -- full-sequence forward (prefill) ---------------------------------
    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                return_kv: bool = False, memory: torch.Tensor | None = None,
                seq_sharded: bool = False):
        """x (b, s, d), positions (s,) [, memory (b, sm, d) for a cross
        block] -> (b, s, d) [and (k, v)].  On a rank: x and the output are
        the rank's run of the sequence when ``seq_sharded``, and k, v whole
        (b, s, KV, dh)."""
        if self.is_cross and memory is None:
            raise ValueError(f"{self.name}: a cross-attention block needs "
                             f"memory")
        if self.tp_group is not None:
            return self._megatron(x, positions, return_kv, seq_sharded,
                                  memory)
        q, k, v = self._qkv(x, memory)
        if self.use_rope and not self.is_cross:
            q = apply_rope(q, positions, self.rope_theta)
            k = apply_rope(k, positions, self.rope_theta)
        dt = torch.promote_types(q.dtype, k.dtype)
        o = ops.flash_attention(q.to(dt), k.to(dt), v.to(dt),
                                causal=self.causal and not self.is_cross)
        out = self._out(o.to(q.dtype))
        if return_kv:
            return out, (k, v)
        return out

    def _megatron(self, x: torch.Tensor, positions: torch.Tensor,
                  return_kv: bool, seq_sharded: bool,
                  memory: torch.Tensor | None):
        g = self.tp_group
        x = gather(x, g, 1) if seq_sharded else replicate(x, g)
        heads = self.block("wq")[1]
        q = self._proj(x, self.wq)
        if self.qkv_bias:
            q = q + self.bq[heads]
        src = memory if self.is_cross else x
        k = self._proj(src, self.wk)
        v = self._proj(src, self.wv)
        if self.split("wk"):                     # the rank's run of head_dim
            k = gather(k, g, -1)
            v = gather(v, g, -1)
        if self.qkv_bias:
            k = k + self.bk
            v = v + self.bv
        if self.use_rope and not self.is_cross:
            q = apply_rope(q, positions, self.rope_theta)
            k = apply_rope(k, positions, self.rope_theta)
        kv = rank_kv_heads(self.num_heads, self.num_kv_heads, g.size,
                           g.rank)
        dt = torch.promote_types(q.dtype, k.dtype)
        o = ops.flash_attention(q.to(dt), k[:, :, kv].to(dt),
                                v[:, :, kv].to(dt),
                                causal=self.causal and not self.is_cross)
        o = o.to(q.dtype)
        H, dh, d = self.wo.shape
        partial = matmul_f32(o.flatten(-2), self.wo.reshape(H * dh, d))
        out = reduce_partials(partial, g, seq_sharded,
                              torch.promote_types(o.dtype, self.wo.dtype))
        if self.out_bias:
            out = out + self.bo
        return (out, (k, v)) if return_kv else out

    # -- single-token decode against the cache ---------------------------
    def decode(self, x: torch.Tensor, t: int, k_cache: torch.Tensor,
               v_cache: torch.Tensor, lo: int | None = None,
               update_cache: bool = True):
        """x (b, d) at position t.  Writes this token's k and v into the
        caches (b, S, KV, dh) in place at position t, then attends to
        positions <= t.  A cross block projects q alone and attends to
        the whole memory cache, left as it is.  Returns (out (b, d),
        (k_cache, v_cache)).  On a rank the caches hold positions
        [lo, lo + S) of a sequence-sharded cache, or (``lo`` None) all
        of it."""
        if self.tp_group is not None:
            return self._decode_rp(x, t, k_cache, v_cache, lo)
        if self.is_cross:
            q = self._q(x[:, None])
            o = decode_attention(q[:, 0], k_cache, v_cache,
                                 k_cache.shape[1] - 1)
            return self._out(o), (k_cache, v_cache)
        q, k, v = self._qkv(x[:, None])
        if self.use_rope:
            pos = torch.full((1,), t, dtype=torch.int64, device=x.device)
            q = apply_rope(q, pos, self.rope_theta)
            k = apply_rope(k, pos, self.rope_theta)
        if update_cache:
            k_cache[:, t] = k[:, 0].to(k_cache.dtype)
            v_cache[:, t] = v[:, 0].to(v_cache.dtype)
        o = decode_attention(q[:, 0], k_cache, v_cache, t)
        return self._out(o), (k_cache, v_cache)

    def _decode_rp(self, x: torch.Tensor, t: int, k_cache: torch.Tensor,
                   v_cache: torch.Tensor, lo: int | None):
        g = self.tp_group
        H, KV, dh = self.num_heads, self.num_kv_heads, self.head_dim
        own = (self.wq,) if self.is_cross else (self.wq, self.wk, self.wv)
        ws = [w.reshape(w.shape[0], -1) for w in own]
        dt = torch.promote_types(x.dtype, self.wq.dtype)
        if self.split("wq"):                     # the rank's run of d_model
            rows = self.block("wq")[0]
            qkv = g.all_reduce(torch.cat([matmul_f32(x[:, rows], w)
                                          for w in ws], -1)).to(dt)
        else:
            qkv = torch.cat([matmul(x, w) for w in ws], -1)
        start = 0 if lo is None else lo
        if self.is_cross:     # every memory position, nothing written
            q = qkv.unflatten(-1, (H, dh))
            if self.qkv_bias:
                q = q + self.bq
            t = start + k_cache.shape[1] - 1
        else:
            q, k, v = qkv.split([H * dh, KV * dh, KV * dh], -1)
            q, k, v = (q.unflatten(-1, (H, dh)), k.unflatten(-1, (KV, dh)),
                       v.unflatten(-1, (KV, dh)))
            if self.qkv_bias:
                q, k, v = q + self.bq, k + self.bk, v + self.bv
            if self.use_rope:
                pos = torch.full((1,), t, dtype=torch.int64, device=x.device)
                q = apply_rope(q[:, None], pos, self.rope_theta)[:, 0]
                k = apply_rope(k[:, None], pos, self.rope_theta)[:, 0]
            if start <= t < start + k_cache.shape[1]:
                k_cache[:, t - start] = k.to(k_cache.dtype)
                v_cache[:, t - start] = v.to(v_cache.dtype)
        o = decode_attention(q, k_cache, v_cache, t,
                             group=None if lo is None else g, lo=start)
        out = matmul(o.flatten(-2), self.wo.reshape(H * dh, -1))
        if self.split("wo"):                     # the rank's output columns
            out = g.all_gather(out, -1)
        if self.out_bias:
            out = out + self.bo
        return out, (k_cache, v_cache)


class MLAttention(ParamModule):
    """DeepSeek-V2 latent attention: k and v decompressed from a normalised
    latent ``c`` (kv_lora_rank wide) and a shared rope key; decode caches
    ``c`` and the rope key and attends in the latent space (absorbed)."""

    def __init__(self, name: str, d_model: int, num_heads: int,
                 kv_lora_rank: int, qk_nope_dim: int, qk_rope_dim: int,
                 v_head_dim: int, layout: str, rope_theta: float = 10_000.0,
                 norm_eps: float = 1e-5, *, device, dtype=None,
                 topo=ONE_DEVICE, group=None):
        super().__init__()
        self.name, self.d_model, self.num_heads = name, d_model, num_heads
        self.kv_lora_rank, self.qk_nope_dim = kv_lora_rank, qk_nope_dim
        self.qk_rope_dim, self.v_head_dim = qk_rope_dim, v_head_dim
        self.layout, self.rope_theta, self.norm_eps = (layout, rope_theta,
                                                       norm_eps)
        self._materialize(device, dtype, topo, group)

    @property
    def qk_dim(self) -> int:
        return self.qk_nope_dim + self.qk_rope_dim

    def register(self, store: ParamStore) -> None:
        d, H = self.d_model, self.num_heads
        lora, rope = self.kv_lora_rank, self.qk_rope_dim
        if self.layout == "megatron":
            ax_q, ax_kva = ("fsdp", "tp", None), ("fsdp", None)
            ax_kvb, ax_o = (None, "tp", None), ("tp", None, "fsdp")
        else:  # decode: heads replicated, row-parallel in d
            ax_q, ax_kva = ("tp", None, None), ("tp", None)
            ax_kvb, ax_o = (None, None, "tp"), (None, None, "tp")
        store.add("wq", ParamDef((d, H, self.qk_dim), ax_q))
        store.add("w_kva", ParamDef((d, lora + rope), ax_kva))
        store.add("kv_norm", ParamDef((lora,), (None,), init="ones"))
        store.add("w_kvb", ParamDef((lora, H, self.qk_nope_dim
                                     + self.v_head_dim), ax_kvb))
        store.add("wo", ParamDef((H, self.v_head_dim, d), ax_o))

    def _norm(self, c: torch.Tensor) -> torch.Tensor:
        # the kernel takes contiguous rows; kv_norm is a weight
        return ops.rmsnorm(c.contiguous(), self.kv_norm, self.norm_eps,
                           pdl=True)

    def _latent(self, x: torch.Tensor):
        """x (b, s, d) -> normalised latent c (b, s, lora) in x's dtype, and
        the rope key before rope (b, s, rope)."""
        kva = x @ self.w_kva
        c, k_rope = kva.split([self.kv_lora_rank, self.qk_rope_dim], dim=-1)
        return self._norm(c), k_rope

    # -- full-sequence forward (prefill) ---------------------------------
    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                return_kv: bool = False, seq_sharded: bool = False):
        """x (b, s, d), positions (s,) -> (b, s, d) [and the caches' rows
        (c (b, s, lora), roped k_rope (b, s, rope))].  On a rank: x and
        the output are the rank's run of the sequence when
        ``seq_sharded``, q, k and v the rank's heads, the caches' rows
        whole."""
        g = self.tp_group
        if g is not None and seq_sharded:
            x = g.all_gather(x, 1)
        b, s, _ = x.shape
        q = Attention._proj(x, self.wq)
        H = q.shape[2]                            # the rank's heads
        q_nope, q_rope = q.split([self.qk_nope_dim, self.qk_rope_dim], dim=-1)
        q_rope = apply_rope(q_rope, positions, self.rope_theta)
        c, k_rope = self._latent(x)
        k_rope = apply_rope(k_rope[:, :, None, :], positions, self.rope_theta)
        kvb = Attention._proj(c, self.w_kvb)
        k_nope, v = kvb.split([self.qk_nope_dim, self.v_head_dim], dim=-1)
        k = torch.cat([k_nope, k_rope.expand(b, s, H, self.qk_rope_dim)],
                      dim=-1)
        qf = torch.cat([q_nope, q_rope], dim=-1)
        o = latent_prefill_attention(qf, k, v, self.qk_dim ** -0.5)
        H_, dv, d = self.wo.shape
        if g is None or not self.split("wo"):
            out = whole_output(o.flatten(-2) @ self.wo.reshape(H_ * dv, d),
                               g, seq_sharded)
        else:                         # row-parallel over the rank's heads
            out = reduce_partials(
                matmul_f32(o.flatten(-2), self.wo.reshape(H_ * dv, d)), g,
                seq_sharded, torch.promote_types(o.dtype, self.wo.dtype))
        if return_kv:
            return out, (c, k_rope[:, :, 0, :])
        return out

    # -- single-token decode, absorbed ------------------------------------
    def decode(self, x: torch.Tensor, t: int, c_cache: torch.Tensor,
               rope_cache: torch.Tensor, lo: int | None = None):
        """x (b, d) at position t.  Writes this token's latent and rope key
        into the caches (b, S, lora) and (b, S, rope) in place at t, then
        scores and reads values in the latent space: W_UK absorbed into q,
        W_UV applied after.  Returns (out (b, d), (c_cache, rope_cache)).
        On a rank (``decode_rp``) the caches hold positions [lo, lo + S) of
        sequence-sharded caches, or (``lo`` None) all of them; the
        softmax's max and sum and the latent output are then reduced over
        the ranks."""
        g = self.tp_group
        b, d = x.shape
        H, nope, dv = self.num_heads, self.qk_nope_dim, self.v_head_dim
        lora, rope = self.kv_lora_rank, self.qk_rope_dim
        ws = (self.wq.reshape(self.wq.shape[0], -1), self.w_kva)
        if self.split("wq"):                     # the rank's run of d_model
            rows = self.block("wq")[0]
            qkva = g.all_reduce(torch.cat([matmul_f32(x[:, rows], w)
                                           for w in ws], -1)).to(
                torch.promote_types(x.dtype, self.wq.dtype))
        else:
            qkva = torch.cat([matmul(x, w) for w in ws], -1)
        q, kva = qkva.split([H * self.qk_dim, lora + rope], -1)
        q_nope, q_rope = q.unflatten(-1, (H, self.qk_dim)).split(
            [nope, rope], dim=-1)
        pos = torch.full((1,), t, dtype=torch.int64, device=x.device)
        q_rope = apply_rope(q_rope[:, None], pos, self.rope_theta)[:, 0]
        c_new, k_rope_new = kva.split([lora, rope], dim=-1)
        c_new = self._norm(c_new)                # on the whole latent
        k_rope_new = apply_rope(k_rope_new[:, None, None, :], pos,
                                self.rope_theta)[:, 0, 0, :]
        start = 0 if lo is None else lo
        if start <= t < start + c_cache.shape[1]:
            c_cache[:, t - start] = c_new.to(c_cache.dtype)
            rope_cache[:, t - start] = k_rope_new.to(rope_cache.dtype)
        if self.split("w_kvb"):
            # the rank's run of w_kvb's last dim (k_nope columns, value
            # columns, or both): q_eff's float32 partial over its k_nope
            # columns (q is zero on the value columns), summed once
            cols = self.block("w_kvb")[2]
            qn = torch.nn.functional.pad(q_nope, (0, dv))[..., cols]
            w = self.w_kvb.permute(1, 2, 0)                  # (H, n, lora)
            q_eff = g.all_reduce(bmm_f32(qn.transpose(0, 1), w)
                                 ).transpose(0, 1).to(q_nope.dtype)
        else:                                    # absorb W_UK
            q_eff = torch.einsum("bhn,rhn->bhr", q_nope,
                                 self.w_kvb[..., :nope])
        seq = None if lo is None else g          # the caches are cut
        f32 = torch.float32
        s = (torch.einsum("bhr,bsr->bhs", q_eff.to(f32), c_cache.to(f32))
             + torch.einsum("bhr,bsr->bhs", q_rope.to(f32),
                            rope_cache.to(f32)))
        s = s * (self.qk_dim ** -0.5)
        posv = torch.arange(start, start + c_cache.shape[1], device=x.device)
        s = s.masked_fill(posv > t, _NEG)
        o_lat = softmax_values(s, c_cache, "bhs,bsr->bhr", seq).to(x.dtype)
        if self.split("w_kvb"):
            # each rank's columns of o_lat · w_kvb, gathered: the values are
            # the last dv of them (a (b, H, nope + dv) activation, never a
            # weight)
            o = g.all_gather(torch.einsum("bhr,rhn->bhn", o_lat,
                                          self.w_kvb), -1)[..., nope:]
        else:                                    # absorb W_UV
            o = torch.einsum("bhr,rhv->bhv", o_lat, self.w_kvb[..., nope:])
        out = matmul(o.reshape(b, H * dv), self.wo.reshape(H * dv, -1))
        if self.split("wo"):                     # the rank's output columns
            out = g.all_gather(out, -1)
        return out, (c_cache, rope_cache)


def latent_prefill_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, scale: float) -> torch.Tensor:
    """Causal softmax attention, q, k (b, s, H, dq) and v (b, s, H, dv) ->
    (b, s, H, dv) in q's dtype, rounding where the reference's
    ``chunked_attention`` rounds: ``q * scale`` and the softmax weights to
    the inputs' dtypes; scores, sums and the output in float32."""
    f32 = torch.float32
    s_len = q.shape[1]
    qs = (q * scale).to(q.dtype)
    scores = torch.einsum("bqhd,bkhd->bhqk", qs.to(f32), k.to(f32))
    pos = torch.arange(s_len, device=q.device)
    scores = scores.masked_fill(pos[:, None] < pos[None, :], _NEG)
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1)                                            # (b, H, q)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).to(f32), v.to(f32))
    o = o / torch.clamp(l, min=1e-20).transpose(1, 2)[..., None]
    return o.to(q.dtype)
