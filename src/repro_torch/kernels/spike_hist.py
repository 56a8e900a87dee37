"""Spike-magnitude histograms of many rows for several bin sizes at once.

``spike_hist_batch`` bins a ``(rows, F)`` block of relative power values
(padding: ``-inf``, never counted) into every requested histogram in one
launch of the CUDA kernel ``csrc/spike_hist.cu`` and returns the counts as a
``(rows, sum(n_bins))`` int32 tensor, the histograms side by side in the
order of ``bin_sizes``.  Per sample: counted only if ``r >= lo``; bin
``min(trunc((r - lo) / c), n - 1)``, computed in the block's own dtype —
float64 for the profiling engine and the builder, float32 for
``ops.spike_hist``.

Two keywords fold the work around a histogram into its launch:
``divisor=`` (a 0-dim or per-row tensor of the block's dtype) bins
``r / divisor``, one IEEE divide as ``torch.div``; ``out=`` (a float64
``(R, sum(n_bins))`` tensor, with ``rows=`` an optional int64 index) adds
row i's counts into ``out[rows[i]]`` (or ``out[i]``) as ``index_add_``
does, a repeated index included, and returns ``out``.

``spike_hist_batch_plain`` is the same function in plain PyTorch.  The
wrapper takes it for a CPU tensor only; for a CUDA tensor it launches the
kernel or raises; for a meta tensor it allocates the counts and launches
nothing.  ``hist_work`` counts the bytes and operations of one call.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.kernels import build

_MAX_SIZES = 16          # csrc/spike_hist.cu kMaxSizes
_MAX_TOTAL_BINS = 8192   # shared-memory counters of one CTA (32 KB)
_WARP_BINS = 1024        # counters of one warp, eight sets a CTA (32 KB)
_TARGET_CTAS = 132 * 8   # enough CTAs in flight to fill the card's 132 SMs
_WARP_ROWS = _TARGET_CTAS  # rows from which a warp owns a row
_WARPS = 8               # csrc/spike_hist.cu kWarps
_MIN_COLS = 4096         # samples a CTA at least takes of a split row

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


def _check_extras(r, total, out, rows, divisor) -> None:
    """``out`` float64 (R, total) on r's device, contiguous; ``rows`` int64,
    one per row of r (without it, R = r's rows); ``divisor`` r's dtype, 0-dim
    or one per row."""
    n = r.shape[0]
    if out is not None:
        if not isinstance(out, torch.Tensor) or out.dtype != torch.float64 \
                or out.dim() != 2 or out.shape[1] != total \
                or not out.is_contiguous() or out.device != r.device:
            raise ValueError(f"spike_hist out must be a contiguous float64 "
                             f"(R, {total}) tensor on {r.device}")
        if rows is None and out.shape[0] != n:
            raise ValueError(f"spike_hist out has {out.shape[0]} rows for a "
                             f"block of {n}; give rows=")
    if rows is not None:
        if out is None:
            raise ValueError("spike_hist rows= needs out=")
        if not isinstance(rows, torch.Tensor) or rows.dtype != torch.int64 \
                or rows.shape != (n,) or rows.device != r.device:
            raise ValueError(f"spike_hist rows must be an int64 ({n},) "
                             f"tensor on {r.device}")
    if divisor is not None:
        if not isinstance(divisor, torch.Tensor) \
                or divisor.dtype != r.dtype \
                or divisor.shape not in ((), (n,)) \
                or divisor.device != r.device:
            raise ValueError(f"spike_hist divisor must be a 0-dim or ({n},) "
                             f"{r.dtype} tensor on {r.device}")


def _hist_layout(rows: int, F: int, total: int) -> tuple[int, int]:
    """(warps that share a row's counters, CTAs a row is split over).  A
    warp owns a row while the rows alone fill the card (``_WARP_ROWS``) and
    its counters fit eight times in a CTA; else the eight warps of a CTA
    share a row, and a long row of a block too short to fill the card is
    split over CTAs of at least ``_MIN_COLS`` samples."""
    if total <= _WARP_BINS and rows >= _WARP_ROWS:
        return 1, 1
    splits = max(1, min(-(-_TARGET_CTAS // max(rows, 1)),
                        -(-F // _MIN_COLS), 65535))
    return _WARPS, splits


def spike_hist_batch_plain(r: torch.Tensor, bin_sizes, n_bins,
                           lo: float = 0.5, *, out: torch.Tensor | None = None,
                           rows: torch.Tensor | None = None,
                           divisor: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """Plain PyTorch twin of the kernel (same arithmetic, same dtype)."""
    _check_block(r)
    sizes, n_bins, offsets = _check_layout(bin_sizes, n_bins)
    _check_extras(r, offsets[-1], out, rows, divisor)
    if divisor is not None:
        r = r / (divisor[:, None] if divisor.dim() else divisor)
    counts = _plain_counts(r, lo, sizes, n_bins, offsets)
    if out is None:
        return counts
    idx = rows if rows is not None else torch.arange(r.shape[0],
                                                     device=r.device)
    return out.index_add_(0, idx, counts.to(torch.float64))


def _plain_counts(r, lo, sizes, n_bins, offsets) -> torch.Tensor:
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


# the kinds of a size in the quotient plan
DIVIDE, FROM_BASE, FROM_SHIFTED = 0, 1, 2


def _quotient_plan(sizes, dtype) -> tuple[tuple[int, int, float], ...]:
    """The order in which the kernel takes the bin sizes and how it gets
    each size's quotient q = (r - lo) / c with the bits of the IEEE divide,
    as (size index, kind, scale) in that order.  DIVIDE divides, and its
    quotient becomes the base; FROM_BASE multiplies the base by the exact
    power of two c_base / c (fl(0.1) is exactly 2 fl(0.05)); FROM_SHIFTED
    multiplies r - lo by 1 / c when c is a power of two.  A size's family
    (its divided base, then the sizes scaled from it) is taken together,
    the FROM_SHIFTED sizes last.  Scaling by a power of two is exact and
    commutes with the divide's rounding (a quotient too small for that is
    below 1 either way, one too large is clipped to the last bin either
    way), so every quotient, and every bin, is the one the divide gives.
    Sizes are taken in the kernel's dtype."""
    vals = [float(np.float32(c)) if dtype == torch.float32 else float(c)
            for c in sizes]
    plan: list[tuple[int, int, float]] = []
    shifted: list[tuple[int, int, float]] = []
    done: set[int] = set()
    for b, c in enumerate(vals):
        if b in done:
            continue
        m, e = math.frexp(c)
        if abs(e) > 100:                         # keep the scales in range
            plan.append((b, DIVIDE, 1.0))
        # frexp's mantissa is exact: m is 0.5 exactly when c = 2**(e - 1)
        elif m == 0.5:  # minoslint: disable=W501
            shifted.append((b, FROM_SHIFTED, math.ldexp(1.0, 1 - e)))
            continue
        else:
            plan.append((b, DIVIDE, 1.0))
            for k in range(b + 1, len(vals)):
                mk, ek = math.frexp(vals[k])
                if k not in done and mk == m and abs(ek) <= 100:
                    plan.append((k, FROM_BASE, math.ldexp(1.0, e - ek)))
                    done.add(k)
    return tuple(plan + shifted)


def _plan_code(plan) -> int:
    """The plan's kinds, two bits a size in the order taken: the kernel is
    compiled for the usual codes (csrc/spike_hist.cu)."""
    return sum(kind << 2 * i for i, (_, kind, _) in enumerate(plan))


def _device_tables(device, dtype, sizes, offsets):
    """The kernel's per-size tables on ``device``, in the plan's order:
    sizes and scales (float64), first counters and last bin indices
    (int32); and the plan's code.  Made once per layout."""
    key = (device, dtype, sizes, offsets)
    t = _tables.get(key)
    if t is None:
        plan = _quotient_plan(sizes, dtype)
        order = [b for b, _, _ in plan]
        t = (torch.tensor([sizes[b] for b in order], dtype=torch.float64,
                          device=device),
             *torch.tensor([[offsets[b] for b in order],
                            [offsets[b + 1] - offsets[b] - 1 for b in order]],
                           dtype=torch.int32, device=device),
             torch.tensor([scale for _, _, scale in plan],
                          dtype=torch.float64, device=device),
             _plan_code(plan))
        _tables[key] = t
    return t


def hist_work(rows: int, F: int, elem: int, n_sizes: int, total: int,
              n_spike: int, *, divisor: int = 0, out: bool = False,
              index: bool = False) -> dict:
    """Bytes and operations of one call on a (rows, F) block of ``elem``
    bytes an element with ``n_sizes`` bin sizes of ``total`` bins in all:
    the samples (and ``divisor``'s elements) read once, then the int32
    counts written, or with ``out`` the float64 histograms read and written
    (with ``index``, the int64 row index read).  Operations: a compare a
    sample (and its divide by the divisor), then for each of the
    ``n_spike`` samples at or above ``lo`` a subtract and, per size, its
    quotient and its bin."""
    nbytes = rows * F * elem + divisor * elem + (
        rows * total * 4 if not out
        else 2 * rows * total * 8 + (rows * 8 if index else 0))
    ops = rows * F * (2 if divisor else 1) + n_spike * (1 + 2 * n_sizes)
    return dict(bytes=nbytes, exps=0, flops=ops)


def _work(r, lo, sizes, total, out, rows, divisor, where) -> build.Work:
    """``hist_work`` of one call; the samples at or above ``lo`` counted
    from the data (on meta there is none: every sample counts)."""
    n, F = r.shape
    if where == "meta":
        n_spike = n * F
    else:
        rel = r if divisor is None else r / (
            divisor[:, None] if divisor.dim() else divisor)
        n_spike = int((rel >= lo).sum())
    return build.work(hist_work(
        n, F, r.element_size(), len(sizes), total, n_spike,
        divisor=0 if divisor is None else divisor.numel(),
        out=out is not None, index=rows is not None))


def spike_hist_batch(r: torch.Tensor, bin_sizes, n_bins, lo: float = 0.5,
                     *, out: torch.Tensor | None = None,
                     rows: torch.Tensor | None = None,
                     divisor: torch.Tensor | None = None) -> torch.Tensor:
    """(rows, F) float64/float32 -> (rows, sum(n_bins)) int32 counts, or
    ``out`` with the counts added (see the module's docstring)."""
    _check_block(r)
    where = build.device_of("spike_hist", (r,))
    if where == "cuda" and not r.is_contiguous():
        raise ValueError("spike_hist needs a contiguous block")
    sizes, n_bins, offsets = _check_layout(bin_sizes, n_bins)
    total = offsets[-1]
    _check_extras(r, total, out, rows, divisor)
    n, F = r.shape
    if n > 2**31 - 1:
        raise ValueError(f"spike_hist takes at most 2**31-1 rows, got {n}")
    group, splits = _hist_layout(n, F, total)
    if out is None:
        # a row split over CTAs adds into cleared counters; else the kernel
        # writes every counter itself
        result = torch.empty((n, total), dtype=torch.int32, device=r.device) \
            if splits == 1 and n * F > 0 else \
            torch.zeros((n, total), dtype=torch.int32, device=r.device)
    else:
        result = out
    if n == 0 or F == 0:
        return result
    with build.counted("spike_hist", lambda: _work(
            r, lo, sizes, total, out, rows, divisor, where)):
        if where == "cpu":
            got = spike_hist_batch_plain(r, sizes, n_bins, lo, out=out,
                                         rows=rows, divisor=divisor)
            if out is None:
                result.copy_(got)
        elif where == "cuda":
            lib = build.library("spike_hist")
            fn = lib.spike_hist_f64 if r.dtype == torch.float64 \
                else lib.spike_hist_f32
            sizes_t, starts_t, tops_t, scales_t, code = _device_tables(
                r.device, r.dtype, sizes, offsets)
            vectorized = r.data_ptr() % 16 == 0 \
                and F * r.element_size() % 16 == 0
            stream = torch.cuda.current_stream(r.device).cuda_stream
            build.check(fn(r.data_ptr(), n, F, sizes_t.data_ptr(),
                           starts_t.data_ptr(), tops_t.data_ptr(),
                           scales_t.data_ptr(), len(sizes), code, float(lo),
                           0 if divisor is None else divisor.data_ptr(),
                           int(divisor is not None and divisor.dim() == 1),
                           result.data_ptr(), int(out is not None),
                           0 if rows is None else rows.data_ptr(),
                           result.shape[0], total, group, splits,
                           int(vectorized), stream), "spike_hist")
            build.launched("spike_hist")
    return result
