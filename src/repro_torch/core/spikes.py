"""Power-trace processing + spike-distribution vectors (paper §4.1, §5.3.1).

Pipeline (exactly the paper's):
  1. instantaneous power from the energy accumulator: P_inst = de/dt
  2. EMA filter with alpha = 0.5
  3. trim idle head/tail via the busy-cycles counter
  4. spike detection at P >= 0.5*TDP, relative magnitude r = P/TDP
  5. bin r into [0.5, 2.0) with width c; normalize -> spike vector v

Traces are float64 torch tensors.  ``ema_filter`` and ``trim_idle`` also
take NumPy arrays for the host-side telemetry simulator.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device

SPIKE_LO = 0.5
SPIKE_HI = 2.0


def power_from_energy(energy_counter: torch.Tensor,
                      sample_dt_s: float) -> torch.Tensor:
    """P_inst ~= delta_e / delta_t from an accumulating energy counter (J)."""
    e = energy_counter.to(torch.float64)
    return torch.diff(e) / scalar(sample_dt_s, e)


def ema_filter(power, alpha: float = 0.5, backend: str | None = None,
               device=DEFAULT_DEVICE):
    """P_filt(t) = alpha*P(t) + (1-alpha)*P_filt(t-1)   (paper uses 0.5).

    The recurrence (filter state seeded with P(0)) is evaluated without a
    per-sample loop by prefix-doubling: with w = 1-alpha and c = alpha*P
    (c_0 = P_0, absorbing the seed state), the fixpoint of
    ``out[s:] += w^s * out[:-s]`` for s = 1, 2, 4, ... is exactly
    out_i = sum_j c_j w^(i-j); the loop stops once w^s underflows to 0.

    ``backend`` selects the implementation:

      * ``"numpy"`` — float64 on the host, NumPy in and out (the telemetry
        simulator's path);
      * ``"torch"`` — the same float64 prefix doubling in PyTorch;
      * ``"cuda"``  — the float32 EMA kernel (``kernels.ema_scan``), result
        widened to float64;
      * ``None``    — ``"cuda"`` for a tensor on the card, ``"torch"``
        otherwise.

    A tensor is filtered where it lies; anything else is moved to ``device``
    (default: the card) first.
    """
    if backend not in (None, "numpy", "torch", "cuda"):
        raise ValueError(f"unknown ema backend {backend!r}")
    if backend == "numpy":
        return _ema_numpy(np.asarray(power, np.float64), alpha)
    if isinstance(power, torch.Tensor):
        p = power.to(torch.float64)
    else:
        p = torch.as_tensor(np.asarray(power, np.float64),
                            device=resolve_device(device))
    if len(p) == 0:
        return p.clone()
    if backend == "cuda" or (backend is None and p.device.type == "cuda"):
        from repro_torch.kernels.ops import ema_scan
        return ema_scan(p, alpha=alpha).to(torch.float64)
    w = 1.0 - alpha
    out = p * alpha
    out[0] = p[0]
    shift, decay = 1, w
    while shift < len(out) and decay != 0.0:
        # separate multiply and add: never a fused multiply-add
        out[shift:].add_(out[:-shift] * decay)
        shift *= 2
        decay *= decay
    return out


def _ema_numpy(power: np.ndarray, alpha: float) -> np.ndarray:
    if len(power) == 0:
        return np.empty(0, np.float64)
    w = 1.0 - alpha
    out = alpha * power
    out[0] = power[0]
    shift, decay = 1, w
    while shift < len(out) and decay != 0.0:
        out[shift:] += decay * out[:-shift]
        shift *= 2
        decay *= decay
    return out


def trim_idle(power, busy):
    """Keep samples between the first and last non-zero busy-counter reading
    (tensors or NumPy arrays)."""
    if isinstance(power, torch.Tensor):
        nz = torch.nonzero(busy > 0).flatten().tolist()
    else:
        nz = np.nonzero(busy > 0)[0]
    if len(nz) == 0:
        return power[:0]
    return power[int(nz[0]):int(nz[-1]) + 1]


def num_bins(bin_size: float) -> int:
    # Python's round: 1.5 / 0.2 = 7.5 rounds to 8, as in the reference
    return int(round((SPIKE_HI - SPIKE_LO) / bin_size))


def scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-dim float64 tensor on ``like``'s device.  Dividing by it keeps the
    IEEE divide on the card, where a Python-float divisor becomes a multiply
    by its reciprocal (one ulp off the host's quotient)."""
    return torch.tensor(float(x), dtype=torch.float64, device=like.device)


def spike_counts(r: torch.Tensor, bin_sizes) -> torch.Tensor:
    """Counts of the relative magnitudes ``r`` (one float64 row) in every
    histogram of ``bin_sizes``, side by side — one spike-histogram kernel
    launch on the card."""
    from repro_torch.kernels.spike_hist import spike_hist_batch
    sizes = tuple(float(c) for c in bin_sizes)
    return spike_hist_batch(r.contiguous()[None, :], sizes,
                            tuple(num_bins(c) for c in sizes),
                            lo=SPIKE_LO)[0].to(torch.float64)


def spike_vector(power: torch.Tensor, tdp: float,
                 bin_size: float = 0.1) -> torch.Tensor:
    """Normalized spike-magnitude distribution vector v (paper §4.1.1)."""
    p = power.to(torch.float64)
    h = spike_counts(p / scalar(tdp, p), (bin_size,))
    tot = h.sum()
    if tot.item() == 0:
        return torch.zeros_like(h)
    return h / tot


def p_quantiles(traces: torch.Tensor, q: float) -> list[float]:
    """Row-wise ``np.percentile(traces, q, axis=1)`` (linear method),
    bit-identical to NumPy: rows are sorted on their device, and the two
    bracketing order statistics are interpolated on the host with NumPy's
    own formula."""
    n = traces.shape[1]
    qf = float(q) / 100.0
    virtual = (n - 1) * qf
    lo_i = int(np.floor(virtual))
    if virtual >= n - 1:
        lo_i = hi_i = n - 1
    else:
        hi_i = lo_i + 1
    s = torch.sort(traces.to(torch.float64), dim=1).values
    pair = s[:, [lo_i, hi_i]].cpu().numpy()
    a, b = pair[:, 0], pair[:, 1]
    gamma = np.float64(virtual - np.floor(virtual)) if virtual < n - 1 \
        else np.float64(virtual - (n - 1))
    diff = b - a
    out = a + diff * gamma
    if gamma >= 0.5:
        out = b - diff * (1 - gamma)
    return out.tolist()


def p_quantile(power: torch.Tensor, tdp: float, q: float = 90.0) -> float:
    """q-th percentile of power relative to TDP (p90/p95/p99 in the paper)."""
    if len(power) == 0:
        return 0.0
    return p_quantiles(power[None, :], q)[0] / tdp


def mean_power_rel(power: torch.Tensor, tdp: float) -> float:
    """Mean power relative to TDP (the Guerreiro et al. feature)."""
    if len(power) == 0:
        return 0.0
    return float(power.to(torch.float64).mean().item()) / tdp
