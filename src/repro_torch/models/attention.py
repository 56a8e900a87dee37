"""GQA attention block: prefill through the flash kernel, decode in plain
PyTorch against a KV cache.

The reference computes prefill attention with its jnp ``chunked_attention``
and names the Pallas kernel as the TPU execution path; the port's prefill
calls ``ops.flash_attention`` (the CUDA kernel on the card, the exact
softmax on the CPU), which computes the same function in float32 without
the jnp path's bfloat16 rounding of ``q * scale`` and of the softmax
weights.  ``decode_attention`` is jnp in the reference and plain PyTorch
here, rounding where the reference rounds.

The weight layouts (``megatron``, ``fsdp_sp``, ``decode_rp``) decide only
how the reference shards; on one card they name the same tensors and are
kept as metadata.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models.common import ParamDef, ParamModule, ParamStore
from repro_torch.models.layers import apply_rope

_NEG = -1e30


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, t: int,
                     softmax_scale: float | None = None) -> torch.Tensor:
    """q (b, H, dh) against caches (b, S, KV, dh) at positions <= t."""
    b, H, dh = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    scale = softmax_scale if softmax_scale is not None else dh ** -0.5
    qg = (q * scale).reshape(b, KV, H // KV, dh)
    s = torch.einsum("bkpd,bskd->bkps", qg.to(torch.float32),
                     k_cache.to(torch.float32))
    pos = torch.arange(S, device=q.device)
    s = s.masked_fill(pos > t, _NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkps,bskd->bkpd",
                     (p / l).to(v_cache.dtype).to(torch.float32),
                     v_cache.to(torch.float32))
    return o.reshape(b, H, dh).to(q.dtype)


class Attention(ParamModule):
    def __init__(self, name: str, d_model: int, num_heads: int,
                 num_kv_heads: int, head_dim: int, layout: str,
                 rope_theta: float = 10_000.0, use_rope: bool = True,
                 qkv_bias: bool = False, out_bias: bool = False,
                 causal: bool = True, is_cross: bool = False, *, device,
                 dtype=None):
        super().__init__()
        if is_cross:
            raise NotImplementedError(
                "cross-attention is not ported yet (ROADMAP queue 1: MoE, "
                "MLA, VLM and enc-dec serving)")
        self.name, self.d_model = name, d_model
        self.num_heads, self.num_kv_heads = num_heads, num_kv_heads
        self.head_dim, self.layout = head_dim, layout
        self.rope_theta, self.use_rope = rope_theta, use_rope
        self.qkv_bias, self.out_bias = qkv_bias, out_bias
        self.causal, self.is_cross = causal, is_cross
        self._materialize(device, dtype)

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
        return (x @ w.reshape(d, h * k)).unflatten(-1, (h, k))

    def _qkv(self, x: torch.Tensor):
        q = self._proj(x, self.wq)
        k = self._proj(x, self.wk)
        v = self._proj(x, self.wv)
        if self.qkv_bias:
            q = q + self.bq
            k = k + self.bk
            v = v + self.bv
        return q, k, v

    def _out(self, o: torch.Tensor) -> torch.Tensor:
        H, dh, d = self.wo.shape
        out = o.flatten(-2) @ self.wo.reshape(H * dh, d)
        if self.out_bias:
            out = out + self.bo
        return out

    # -- full-sequence forward (prefill) ---------------------------------
    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                return_kv: bool = False):
        """x (b, s, d), positions (s,) -> (b, s, d) [and (k, v)]."""
        q, k, v = self._qkv(x)
        if self.use_rope:
            q = apply_rope(q, positions, self.rope_theta)
            k = apply_rope(k, positions, self.rope_theta)
        o = ops.flash_attention(q, k, v, causal=self.causal)
        out = self._out(o)
        if return_kv:
            return out, (k, v)
        return out

    # -- single-token decode against the cache ---------------------------
    def decode(self, x: torch.Tensor, t: int, k_cache: torch.Tensor,
               v_cache: torch.Tensor, update_cache: bool = True):
        """x (b, d) at position t.  Writes this token's k and v into the
        caches (b, S, KV, dh) in place at position t, then attends to
        positions <= t.  Returns (out (b, d), (k_cache, v_cache))."""
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


class MLAttention(ParamModule):
    """DeepSeek-V2 latent attention: not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "MLA attention is not ported yet (ROADMAP queue 1: MoE, MLA, VLM "
            "and enc-dec serving)")
