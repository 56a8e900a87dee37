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
then adds D * x in float32; decode keeps y in float32.

Training runs the same prefill forward under grad: ``ops.ssm_scan`` then
goes through ``SSMScanFn``, whose backward is the ``ssm_scan_bwd`` kernel
(it recomputes the states from the saved inputs, as the reference's
per-chunk remat does).  The gradients reach ``A_log`` through ``-exp``,
``dt_bias`` and ``w_dt`` through softplus, B and C through ``w_x``, and x
through the scan, the skip term and ``w_x``; the rest is autograd over
the plain PyTorch around the kernel.  The prefill scans
the whole sequence in one launch, so it takes any length (the reference's
needs s <= 128 or a multiple of 128).  Decode updates the caches in place:
the kernel writes the new state over the cached one, and the conv window
shifts by one token.

On a rank of a (1, tp) mesh (a ``group``, ``models.parallel``) the block
is cut over ``d_inner``, the reference's pspecs: the ``megatron`` prefill
layout and the ``decode_rp`` decode layout give the same blocks on a
(1, tp) mesh, so prefill and decode share them.  Rank r holds channels
[r di/tp, (r + 1) di/tp): those of ``conv_w``, ``conv_b``, ``w_dt``,
``dt_bias``, ``A_log`` and ``D``, and the matching rows of ``w_x`` and
``w_out``.  ``w_in`` is (d, 2 di), x and z side by side; its pspec cuts
the 2 di columns into tp runs, which would give a rank x columns only (or
z columns only), so the rank's block is instead two runs, the x and the z
columns of its own channels (``block``; the pspec stays the reference's).
The conv and the scan run on the rank's channels (``ops.ssm_scan`` on
(b, s, di/tp, ds) and the decode kernel on (b, 1, di/tp, ds)); ``w_x`` and
``w_out`` contract over ``d_inner``, so their float32 partials are summed
over the ranks in float32 and rounded once (``dt_raw``, B and C whole on
every rank, the output onto the rank's run of the sequence when the
residual is sequence-sharded, whose input the block gathers first: the
scan needs the whole sequence).  The caches are the rank's channels.
Training runs the same blocks (``LM.loss``): the sequence gathered with
its gradient reduce-scattered back (or, for a replicated residual, the
input ``replicate``d), ``x_proj``'s partials summed and their gradient
summed over the ranks in turn (every rank's channels read ``dt_raw``, B
and C), and ``SSMScanFn``'s forward and backward kernels on the rank's
``d_inner / tp`` channels.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.common import (ONE_DEVICE, ParamDef, ParamModule,
                                       ParamStore)
from repro_torch.models.layers import (matmul_f32, reduce_partials,
                                       whole_output)
from repro_torch.models.parallel import gather, reduce, replicate

SCAN_IMPLS = ("sequential", "associative")


class MambaBlock(ParamModule):
    def __init__(self, name: str, d_model: int, d_inner: int, d_state: int,
                 d_conv: int, dt_rank: int, layout: str = "megatron",
                 scan_impl: str = "sequential", *, device, dtype=None,
                 topo=ONE_DEVICE, group=None):
        super().__init__()
        if scan_impl not in SCAN_IMPLS:
            raise ValueError(f"unknown scan_impl {scan_impl!r}")
        self.name, self.d_model, self.d_inner = name, d_model, d_inner
        self.d_state, self.d_conv, self.dt_rank = d_state, d_conv, dt_rank
        self.layout, self.scan_impl = layout, scan_impl
        self._materialize(device, dtype, topo, group)

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

    def block(self, path: str, rank: int | None = None) -> tuple:
        """As ``ParamModule.block``, but ``w_in``'s columns are the x and
        the z columns of the rank's channels (``conv_b``'s block): two
        runs, given as a list of indices."""
        index = super().block(path, rank)
        if path != "w_in":
            return index
        ch, di = super().block("conv_b", rank)[0], self.d_inner
        if ch.stop - ch.start == di:        # the channels are not cut
            return index[:1] + (slice(0, 2 * di),)
        return index[:1] + (list(range(ch.start, ch.stop))
                            + list(range(di + ch.start, di + ch.stop)),)

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
        if self.split("w_x"):       # the rank's channels: partials
            g = self.tp_group       # summed; their gradient too (whole)
            xdb = replicate(reduce(matmul_f32(x, self.w_x), g), g).to(
                x.dtype)
        else:
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

    def _out(self, y: torch.Tensor, seq_sharded: bool) -> torch.Tensor:
        """y @ w_out; on a rank its float32 partials summed over the ranks
        (onto the rank's run of the sequence when ``seq_sharded``)."""
        if self.split("w_out"):
            return reduce_partials(matmul_f32(y, self.w_out),
                                   self.tp_group, seq_sharded, y.dtype)
        return whole_output(y @ self.w_out, self.tp_group, seq_sharded)

    # -- full-sequence forward (prefill) ---------------------------------
    def forward(self, h: torch.Tensor, return_state: bool = False,
                seq_sharded: bool = False):
        """h (b, s, d) -> (b, s, d) [and (h_last (b, di, ds) float32, conv
        tail: the last K-1 pre-conv inputs (b, K-1, di))].  On a rank, h
        and the output are the rank's run of the sequence when
        ``seq_sharded``, and the state and the tail its channels."""
        if self.tp_group is not None and seq_sharded:
            h = gather(h, self.tp_group, 1)
        elif self.split("w_x"):
            h = replicate(h, self.tp_group)
        s = h.shape[1]
        x_pre, z = (h @ self.w_in).chunk(2, dim=-1)
        x = F.silu(self._conv(x_pre).to(torch.float32)).to(h.dtype)
        dt, B, C = self._ssm_raw(x)
        y, h_last = ops.ssm_scan(x, dt, self._a(), B, C, None)
        y = y.to(torch.float32) + self.D.to(torch.float32) \
            * x.to(torch.float32)
        y = (y * F.silu(z.to(torch.float32))).to(h.dtype)
        out = self._out(y, seq_sharded)
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
        and stored in the cache's); on a rank, both its channels.  Returns
        (out (b, d), (state, conv_state))."""
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
        return self._out(y, False), (state, conv_state)
