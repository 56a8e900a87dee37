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
  returns are whole.
* ``decode_rp``: ``wq``/``wk``/``wv`` cut over d_model, so the rank's run
  of x gives partial q, k, v, summed over the ranks in float32; the new
  token's k and v written by the rank whose run of the cache holds
  position t; ``decode_attention`` over the sequence-sharded cache; ``wo``
  cut over its output d, gathered after.

``fsdp_sp`` (heads that tp does not divide), cross-attention and MLA under
tp > 1 are not ported (ROADMAP queue 1, item 3).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models.common import (NOT_RUN, ONE_DEVICE, ParamDef,
                                       ParamModule, ParamStore)
from repro_torch.models.layers import (apply_rope, matmul, matmul_f32,
                                       reduce_partials)

_NEG = -1e30


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, t: int,
                     softmax_scale: float | None = None, group=None,
                     lo: int = 0) -> torch.Tensor:
    """q (b, H, dh) against caches (b, S, KV, dh) at positions <= t; the
    caches hold positions [lo, lo + S).  With a ``group`` they are the
    rank's run of a sequence-sharded cache: the scores stay local, their
    max and the softmax's sum are reduced over the ranks, the weights
    ``p / l`` rounded to the cache's dtype where the reference rounds them,
    and the local products with v summed over the ranks in float32."""
    b, H, dh = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    scale = softmax_scale if softmax_scale is not None else dh ** -0.5
    qg = (q * scale).reshape(b, KV, H // KV, dh)
    s = torch.einsum("bkpd,bskd->bkps", qg.to(torch.float32),
                     k_cache.to(torch.float32))
    pos = torch.arange(lo, lo + S, device=q.device)
    s = s.masked_fill(pos > t, _NEG)
    m = s.amax(dim=-1, keepdim=True)
    if group is not None:
        m = group.all_reduce(m, "max")
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    if group is not None:
        l = group.all_reduce(l)
    o = torch.einsum("bkps,bskd->bkpd",
                     (p / l).to(v_cache.dtype).to(torch.float32),
                     v_cache.to(torch.float32))
    if group is not None:
        o = group.all_reduce(o)
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
        if group is not None and (is_cross or layout == "fsdp_sp"):
            raise NotImplementedError(
                f"{name}: {'cross-attention' if is_cross else layout} "
                f"over ranks {NOT_RUN}")
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
        if self.tp_group is not None:
            return self._megatron(x, positions, return_kv, seq_sharded)
        if self.is_cross and memory is None:
            raise ValueError(f"{self.name}: a cross-attention block needs "
                             f"memory")
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
                  return_kv: bool, seq_sharded: bool):
        g = self.tp_group
        if seq_sharded:
            x = g.all_gather(x, 1)
        heads = self.block("wq")[1]
        q = self._proj(x, self.wq)
        if self.qkv_bias:
            q = q + self.bq[heads]
        k = self._proj(x, self.wk)
        v = self._proj(x, self.wv)
        if self.split("wk"):                     # the rank's run of head_dim
            k = g.all_gather(k, -1)
            v = g.all_gather(v, -1)
        if self.qkv_bias:
            k = k + self.bk
            v = v + self.bv
        if self.use_rope:
            q = apply_rope(q, positions, self.rope_theta)
            k = apply_rope(k, positions, self.rope_theta)
        kv = rank_kv_heads(self.num_heads, self.num_kv_heads, g.size,
                           g.rank)
        o = ops.flash_attention(q, k[:, :, kv], v[:, :, kv],
                                causal=self.causal)
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
        ws = [w.reshape(w.shape[0], -1) for w in (self.wq, self.wk, self.wv)]
        dt = torch.promote_types(x.dtype, self.wq.dtype)
        if self.split("wq"):                     # the rank's run of d_model
            rows = self.block("wq")[0]
            qkv = g.all_reduce(torch.cat([matmul_f32(x[:, rows], w)
                                          for w in ws], -1)).to(dt)
        else:
            qkv = torch.cat([matmul(x, w) for w in ws], -1)
        q, k, v = qkv.split([H * dh, KV * dh, KV * dh], -1)
        q, k, v = (q.unflatten(-1, (H, dh)), k.unflatten(-1, (KV, dh)),
                   v.unflatten(-1, (KV, dh)))
        if self.qkv_bias:
            q, k, v = q + self.bq, k + self.bk, v + self.bv
        if self.use_rope:
            pos = torch.full((1,), t, dtype=torch.int64, device=x.device)
            q = apply_rope(q[:, None], pos, self.rope_theta)[:, 0]
            k = apply_rope(k[:, None], pos, self.rope_theta)[:, 0]
        start = 0 if lo is None else lo
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
                 norm_eps: float = 1e-5, *, device, dtype=None):
        super().__init__()
        self.name, self.d_model, self.num_heads = name, d_model, num_heads
        self.kv_lora_rank, self.qk_nope_dim = kv_lora_rank, qk_nope_dim
        self.qk_rope_dim, self.v_head_dim = qk_rope_dim, v_head_dim
        self.layout, self.rope_theta, self.norm_eps = (layout, rope_theta,
                                                       norm_eps)
        self._materialize(device, dtype)

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

    def _latent(self, x: torch.Tensor):
        """x (b, s, d) -> normalised latent c (b, s, lora) in x's dtype, and
        the rope key before rope (b, s, rope)."""
        kva = x @ self.w_kva
        c, k_rope = kva.split([self.kv_lora_rank, self.qk_rope_dim], dim=-1)
        # the kernel takes contiguous rows; kv_norm is a weight
        c = ops.rmsnorm(c.contiguous(), self.kv_norm, self.norm_eps,
                        pdl=True)
        return c, k_rope

    # -- full-sequence forward (prefill) ---------------------------------
    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                return_kv: bool = False):
        """x (b, s, d), positions (s,) -> (b, s, d) [and the caches' rows
        (c (b, s, lora), roped k_rope (b, s, rope))]."""
        b, s, _ = x.shape
        H = self.num_heads
        q = Attention._proj(x, self.wq)
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
        out = o.flatten(-2) @ self.wo.reshape(H_ * dv, d)
        if return_kv:
            return out, (c, k_rope[:, :, 0, :])
        return out

    # -- single-token decode, absorbed ------------------------------------
    def decode(self, x: torch.Tensor, t: int, c_cache: torch.Tensor,
               rope_cache: torch.Tensor):
        """x (b, d) at position t.  Writes this token's latent and rope key
        into the caches (b, S, lora) and (b, S, rope) in place at t, then
        scores and reads values in the latent space: W_UK absorbed into q,
        W_UV applied after.  Returns (out (b, d), (c_cache, rope_cache))."""
        b, d = x.shape
        H, nope = self.num_heads, self.qk_nope_dim
        q = Attention._proj(x[:, None], self.wq)[:, 0]          # (b, H, qk)
        q_nope, q_rope = q.split([nope, self.qk_rope_dim], dim=-1)
        pos = torch.full((1,), t, dtype=torch.int64, device=x.device)
        q_rope = apply_rope(q_rope[:, None], pos, self.rope_theta)[:, 0]
        c_new, k_rope_new = self._latent(x[:, None])
        k_rope_new = apply_rope(k_rope_new[:, :, None, :], pos,
                                self.rope_theta)[:, :, 0, :]
        c_cache[:, t] = c_new[:, 0].to(c_cache.dtype)
        rope_cache[:, t] = k_rope_new[:, 0].to(rope_cache.dtype)
        wk, wv = self.w_kvb.split([nope, self.v_head_dim], dim=-1)
        q_eff = torch.einsum("bhn,rhn->bhr", q_nope, wk)        # absorb W_UK
        f32 = torch.float32
        s = (torch.einsum("bhr,bsr->bhs", q_eff.to(f32), c_cache.to(f32))
             + torch.einsum("bhr,bsr->bhs", q_rope.to(f32),
                            rope_cache.to(f32)))
        s = s * (self.qk_dim ** -0.5)
        posv = torch.arange(c_cache.shape[1], device=x.device)
        s = s.masked_fill(posv > t, _NEG)
        pr = torch.exp(s - s.amax(dim=-1, keepdim=True))
        pr = pr / pr.sum(dim=-1, keepdim=True)
        o_lat = torch.einsum("bhs,bsr->bhr", pr.to(c_cache.dtype).to(f32),
                             c_cache.to(f32)).to(x.dtype)
        o = torch.einsum("bhr,rhv->bhv", o_lat, wv)              # absorb W_UV
        out = o.reshape(b, H * self.v_head_dim) @ self.wo.reshape(
            H * self.v_head_dim, d)
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
