"""Public wrappers with the reference ``repro.kernels.ops`` signatures.

Both take torch tensors and run where the tensor lies: the CUDA kernel for a
tensor on the card, the plain PyTorch version for a tensor on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ema_scan import ema_scan_rows
from repro_torch.kernels.spike_hist import spike_hist_batch


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
