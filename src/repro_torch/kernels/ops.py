"""Public wrappers with the reference ``repro.kernels.ops`` signatures.

Each takes torch tensors and runs where the tensors lie: the CUDA kernel for
tensors on the card, the plain PyTorch version for tensors on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ema_scan import ema_scan_rows
from repro_torch.kernels.flash_attention import flash_attention_bshd
from repro_torch.kernels.rmsnorm import rmsnorm_rows
from repro_torch.kernels.spike_hist import spike_hist_batch
from repro_torch.kernels.ssm_scan import ssm_scan_bsd


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (b, sq, H, dh); k/v: (b, skv, KV, dh) -> (b, sq, H, dh)."""
    return flash_attention_bshd(q, k, v, causal=causal)


def ssm_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, D: torch.Tensor | None, *,
             h0: torch.Tensor | None = None,
             h_out: torch.Tensor | None = None):
    """x, dt: (b, s, di); A: (di, ds); B, C: (b, s, ds); D: (di,) ->
    (y (b, s, di) in x's dtype, h_last (b, di, ds) float32), as the
    reference's ``ref.ssm_scan_ref``.  ``D=None`` leaves out the skip term;
    ``h0`` is the starting state and ``h_out`` receives h_last in place."""
    return ssm_scan_bsd(x, dt, A, B, C, D, h0, h_out)


def spike_hist(power: torch.Tensor, tdp: float, n_bins: int = 15,
               lo: float = 0.5, hi: float = 2.0) -> torch.Tensor:
    """Power samples (W) -> normalized float32 spike vector (n_bins,).

    As the reference: relative power in float32, bin width
    ``(hi - lo) / n_bins``, counts divided by their total (zeros stay
    zeros)."""
    if power.dim() != 1:
        raise ValueError(f"spike_hist takes one (n,) trace, got shape "
                         f"{tuple(power.shape)}")
    rel = power.to(torch.float32) / torch.tensor(
        tdp, dtype=torch.float32, device=power.device)
    counts = spike_hist_batch(rel.contiguous()[None, :], ((hi - lo) / n_bins,),
                              (n_bins,), lo=lo)[0].to(torch.float32)
    total = counts.sum()
    return torch.where(total > 0, counts / torch.where(total > 0, total, 1.0),
                       counts)


def ema_scan(power: torch.Tensor, alpha: float = 0.5) -> torch.Tensor:
    """Power samples (W) -> EMA-filtered float32 samples (the paper's
    alpha = 0.5 filter)."""
    return ema_scan_rows(power.to(torch.float32).contiguous(), alpha=alpha)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5, *,
            pdl: bool = False) -> torch.Tensor:
    """RMSNorm over the last dim of ``x`` (any leading dims).  ``pdl``: see
    ``rmsnorm_rows``; only for a ``scale`` no kernel just before writes."""
    shape = x.shape
    return rmsnorm_rows(x.reshape(-1, shape[-1]), scale, eps,
                        pdl=pdl).reshape(shape)
