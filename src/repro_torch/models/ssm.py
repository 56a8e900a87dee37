"""Mamba-1 selective-SSM block (falcon-mamba; jamba's mamba layers).

The reference computes the scan in jnp (a ``lax.scan`` over time inside a
``lax.scan`` over 128-token chunks) and names the Pallas ``ssm_scan`` kernel
as its TPU execution path; the port's prefill and decode both call
``ops.ssm_scan`` (the CUDA kernel on the card, the plain float32 loop on
the CPU).  Both ``scan_impl`` values compute the same function and take the
kernel; the reference's 128-token ``chunk`` has no counterpart.  The
in/x/dt/out projections, the causal depthwise conv, softplus and gating are
plain PyTorch, as they are jnp in the reference.

Rounding follows the reference: prefill scans without the skip term, gets
y in the activation dtype (the reference casts each chunk's scan output),
then adds D * x in float32; decode keeps y in float32.  The prefill scans
the whole sequence in one launch, so it takes any length (the reference's
needs s <= 128 or a multiple of 128).  Decode updates the caches in place:
the kernel writes the new state over the cached one, and the conv window
shifts by one token.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.common import ParamDef, ParamModule, ParamStore

SCAN_IMPLS = ("sequential", "associative")


class MambaBlock(ParamModule):
    def __init__(self, name: str, d_model: int, d_inner: int, d_state: int,
                 d_conv: int, dt_rank: int, layout: str = "megatron",
                 scan_impl: str = "sequential", *, device, dtype=None):
        super().__init__()
        if scan_impl not in SCAN_IMPLS:
            raise ValueError(f"unknown scan_impl {scan_impl!r}")
        self.name, self.d_model, self.d_inner = name, d_model, d_inner
        self.d_state, self.d_conv, self.dt_rank = d_state, d_conv, dt_rank
        self.layout, self.scan_impl = layout, scan_impl
        self._materialize(device, dtype)

    @property
    def _fsdp(self) -> str | None:
        return None if self.layout == "decode_rp" else "fsdp"

    def register(self, store: ParamStore) -> None:
        d, di, ds, dr, K = (self.d_model, self.d_inner, self.d_state,
                            self.dt_rank, self.d_conv)
        store.add("w_in", ParamDef((d, 2 * di), (self._fsdp, "tp")))
        store.add("conv_w", ParamDef((K, di), (None, "tp"), scale=0.5))
        store.add("conv_b", ParamDef((di,), ("tp",), init="zeros"))
        store.add("w_x", ParamDef((di, dr + 2 * ds), ("tp", None)))
        store.add("w_dt", ParamDef((dr, di), (None, "tp")))
        store.add("dt_bias", ParamDef((di,), ("tp",), init="mamba_dt"))
        store.add("A_log", ParamDef((di, ds), ("tp", None), init="mamba_a"))
        store.add("D", ParamDef((di,), ("tp",), init="ones"))
        store.add("w_out", ParamDef((di, d), ("tp", self._fsdp)))

    # ------------------------------------------------------------------
    def _conv(self, x: torch.Tensor) -> torch.Tensor:
        """Causal depthwise conv along seq via K shifted adds. x: (b,s,di)."""
        K, s = self.d_conv, x.shape[1]
        pad = F.pad(x, (0, 0, K - 1, 0))
        out = self.conv_b.to(x.dtype)[None, None, :] * torch.ones_like(x)
        for k in range(K):
            out = out + pad[:, k:k + s, :] * self.conv_w[k][None, None, :]
        return out

    def _ssm_raw(self, x: torch.Tensor):
        """x (b, s, di) post-conv post-silu -> (dt (b, s, di) float32, B, C
        (b, s, ds) float32)."""
        xdb = x @ self.w_x
        dt_raw, B, C = xdb.split([self.dt_rank, self.d_state, self.d_state],
                                 dim=-1)
        dt = dt_raw @ self.w_dt + self.dt_bias
        # the kernel takes dt contiguous; a product with the strided dt_raw
        # may come out strided on the card
        dt = F.softplus(dt.to(torch.float32)).contiguous()
        return dt, B.to(torch.float32), C.to(torch.float32)

    def _a(self) -> torch.Tensor:
        return -torch.exp(self.A_log.to(torch.float32))          # (di, ds)

    # -- full-sequence forward (prefill) ---------------------------------
    def forward(self, h: torch.Tensor, return_state: bool = False):
        """h (b, s, d) -> (b, s, d) [and (h_last (b, di, ds) float32, conv
        tail: the last K-1 pre-conv inputs (b, K-1, di))]."""
        s = h.shape[1]
        x_pre, z = (h @ self.w_in).chunk(2, dim=-1)
        x = F.silu(self._conv(x_pre).to(torch.float32)).to(h.dtype)
        dt, B, C = self._ssm_raw(x)
        y, h_last = ops.ssm_scan(x, dt, self._a(), B, C, None)
        y = y.to(torch.float32) + self.D.to(torch.float32) \
            * x.to(torch.float32)
        y = (y * F.silu(z.to(torch.float32))).to(h.dtype)
        out = y @ self.w_out
        if return_state:
            # a copy, so the cache holds no view of the whole x_pre; a
            # prompt shorter than K-1 tokens leaves zeros where no token was
            K = self.d_conv
            tail = x_pre[:, max(s - (K - 1), 0):, :]
            tail = F.pad(tail, (0, 0, K - 1 - tail.shape[1], 0)).clone()
            return out, (h_last, tail)
        return out

    # -- single-token decode ---------------------------------------------
    def decode(self, h: torch.Tensor, t: int, state: torch.Tensor,
               conv_state: torch.Tensor):
        """h (b, d); state (b, di, ds) float32 and conv_state (b, K-1, di),
        both updated in place (the conv window is computed in the promoted
        dtype of the cache and x, as the reference's concatenation does,
        and stored in the cache's).  Returns (out (b, d), (state,
        conv_state))."""
        x, z = (h @ self.w_in).chunk(2, dim=-1)                  # (b, di)
        window = torch.cat([conv_state, x[:, None, :]], dim=1)   # (b, K, di)
        conv_state.copy_(window[:, 1:])
        x = torch.einsum("bki,ki->bi", window,
                         self.conv_w.to(window.dtype)) + self.conv_b
        x = F.silu(x.to(torch.float32)).to(h.dtype)
        dt, B, C = self._ssm_raw(x[:, None, :])
        # the einsum may leave x strided; the kernel takes it contiguous
        xf = x.to(torch.float32).contiguous()
        y, _ = ops.ssm_scan(xf[:, None, :], dt, self._a(), B, C, self.D,
                            h0=state, h_out=state)
        y = (y[:, 0] * F.silu(z.to(torch.float32))).to(h.dtype)
        return y @ self.w_out, (state, conv_state)
