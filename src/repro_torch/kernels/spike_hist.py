"""Spike-magnitude histograms of many rows for several bin sizes at once.

``spike_hist_batch`` bins a ``(rows, F)`` block of relative power values
(padding: ``-inf``, never counted) into every requested histogram in one
launch of the CUDA kernel ``csrc/spike_hist.cu`` and returns the counts as a
``(rows, sum(n_bins))`` int32 tensor, the histograms side by side in the
order of ``bin_sizes``.  Per sample: counted only if ``r >= lo``; bin
``min(trunc((r - lo) / c), n - 1)``, computed in the block's own dtype —
float64 for the profiling engine and the builder, float32 for
``ops.spike_hist``.

``spike_hist_batch_plain`` is the same function in plain PyTorch.  The
wrapper takes it for a CPU tensor only; for a CUDA tensor it launches the
kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

_MAX_SIZES = 16          # csrc/spike_hist.cu kMaxSizes
_MAX_TOTAL_BINS = 8192   # shared-memory counters of one CTA (32 KB)
_TARGET_CTAS = 132 * 8   # enough CTAs in flight to fill the card's 132 SMs
_THREADS = 256

_tables: dict[tuple, tuple[torch.Tensor, torch.Tensor]] = {}


def _check_layout(bin_sizes, n_bins) -> tuple[tuple, tuple, tuple]:
    sizes = tuple(float(c) for c in bin_sizes)
    n_bins = tuple(int(n) for n in n_bins)
    if not 1 <= len(sizes) <= _MAX_SIZES:
        raise ValueError(f"spike_hist takes 1..{_MAX_SIZES} bin sizes, "
                         f"got {len(sizes)}")
    if len(n_bins) != len(sizes):
        raise ValueError(f"{len(sizes)} bin sizes but {len(n_bins)} bin "
                         f"counts")
    if any(not c > 0 for c in sizes) or any(n < 1 for n in n_bins):
        raise ValueError(f"bin sizes must be positive and bin counts >= 1: "
                         f"{sizes}, {n_bins}")
    offsets = [0]
    for n in n_bins:
        offsets.append(offsets[-1] + n)
    if offsets[-1] > _MAX_TOTAL_BINS:
        raise ValueError(f"{offsets[-1]} bins in all; the kernel keeps at "
                         f"most {_MAX_TOTAL_BINS} counters per row")
    return sizes, n_bins, tuple(offsets)


def _check_block(r) -> None:
    if not isinstance(r, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(r).__name__}")
    if r.dim() != 2:
        raise ValueError(f"expected a (rows, samples) block, got shape "
                         f"{tuple(r.shape)}")
    if r.dtype not in (torch.float64, torch.float32):
        raise TypeError(f"spike_hist takes float64 or float32, got {r.dtype}")


def spike_hist_batch_plain(r: torch.Tensor, bin_sizes, n_bins,
                           lo: float = 0.5) -> torch.Tensor:
    """Plain PyTorch twin of the kernel (same arithmetic, same dtype)."""
    _check_block(r)
    sizes, n_bins, offsets = _check_layout(bin_sizes, n_bins)
    rows, total = r.shape[0], offsets[-1]
    lo_t = torch.tensor(lo, dtype=r.dtype, device=r.device)
    keep = r >= lo_t
    row_idx = torch.nonzero(keep)[:, 0]
    shifted = r[keep] - lo_t
    counts = torch.zeros(rows * total, dtype=torch.int64, device=r.device)
    for c, n, off in zip(sizes, n_bins, offsets):
        # a 0-dim tensor divisor keeps the IEEE divide on the card (a Python
        # float divisor becomes a multiply by its reciprocal there)
        q = shifted / torch.tensor(c, dtype=r.dtype, device=r.device)
        b = q.to(torch.int64).clamp_max_(n - 1)
        counts += torch.bincount(row_idx * total + off + b,
                                 minlength=rows * total)
    return counts.view(rows, total).to(torch.int32)


def _device_tables(device, sizes, offsets):
    key = (device, sizes, offsets)
    t = _tables.get(key)
    if t is None:
        t = (torch.tensor(sizes, dtype=torch.float64, device=device),
             torch.tensor(offsets, dtype=torch.int32, device=device))
        _tables[key] = t
    return t


def spike_hist_batch(r: torch.Tensor, bin_sizes, n_bins,
                     lo: float = 0.5) -> torch.Tensor:
    """(rows, F) float64/float32 -> (rows, sum(n_bins)) int32 counts."""
    _check_block(r)
    if r.device.type == "cpu":
        return spike_hist_batch_plain(r, bin_sizes, n_bins, lo)
    if r.device.type != "cuda":
        raise ValueError(f"spike_hist runs on cuda or cpu, not {r.device}")
    if not r.is_contiguous():
        raise ValueError("spike_hist needs a contiguous block")
    sizes, n_bins, offsets = _check_layout(bin_sizes, n_bins)
    rows, F = r.shape
    total = offsets[-1]
    out = torch.zeros((rows, total), dtype=torch.int32, device=r.device)
    if rows == 0 or F == 0:
        return out
    if rows > 2**31 - 1:
        raise ValueError(f"spike_hist takes at most 2**31-1 rows, got {rows}")
    lib = build.library("spike_hist")
    fn = lib.spike_hist_f64 if r.dtype == torch.float64 \
        else lib.spike_hist_f32
    sizes_t, offsets_t = _device_tables(r.device, sizes, offsets)
    # split a row over several CTAs only when rows alone cannot fill the card
    col_splits = max(1, min(-(-_TARGET_CTAS // rows), -(-F // _THREADS),
                            65535))
    stream = torch.cuda.current_stream(r.device).cuda_stream
    build.check(fn(r.data_ptr(), rows, F, sizes_t.data_ptr(),
                   offsets_t.data_ptr(), len(sizes), float(lo),
                   out.data_ptr(), total, col_splits, stream), "spike_hist")
    build.LAUNCHES["spike_hist"] += 1
    return out
