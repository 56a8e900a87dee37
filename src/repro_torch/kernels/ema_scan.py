"""First-order EMA filters: out_t = alpha*x_t + (1-alpha)*out_{t-1}.

Two entries, both through the CUDA kernels of ``csrc/ema_scan.cu``:

* ``ema_scan_rows`` filters each row of a ``(rows, n)`` (or one ``(n,)``)
  float32 tensor, with the state seeded as out_{-1} = x_0.
  ``ema_scan_plain`` is the same function in plain PyTorch (float32 prefix
  doubling, separate multiply and add).
* ``ema_scan_blocks`` is the profiling engine's blocked float64 EMA: each
  row is cut into blocks of ``EMA_BLOCK`` samples at fixed positions from
  the row's start, each block is ``ema_filter_block`` (prefix doubling
  seeded with the carried filter value), and the carry is the block's last
  value, so the result does not depend on where a stream's chunks break.
  Many rows, uniform or ragged, each with its own carried state, go in one
  launch.  ``ema_scan_blocks_plain`` is its plain twin, bit-identical to the
  kernel and to the reference's NumPy blocks.

A wrapper takes the plain version for a CPU tensor only; for a CUDA tensor
it launches the kernel or raises; for a meta tensor it allocates the output
and launches nothing.  ``ema_rows_work`` and ``ema_blocks_work`` count the
bytes and operations of one call.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import build

EMA_BLOCK = 256
_INLINE_ROWS = 255     # csrc/ema_scan.cu kInlineRows: ragged rows whose
                       # bounds are passed in the launch itself


def _check(x) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(x).__name__}")
    if x.dim() not in (1, 2):
        raise ValueError(f"ema_scan takes (n,) or (rows, n), got shape "
                         f"{tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"ema_scan takes float32, got {x.dtype}")


def ema_scan_plain(x: torch.Tensor, alpha: float = 0.5) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: float32, row-wise."""
    _check(x)
    w = 1.0 - alpha
    rows = x.reshape(-1, x.shape[-1]) if x.dim() == 2 else x[None]
    out = rows * alpha
    if out.shape[1]:
        out[:, 0] += rows[:, 0] * w              # seed state out_{-1} = x_0
    shift, decay = 1, w
    while shift < out.shape[1] and decay != 0.0:
        out[:, shift:] += out[:, :-shift] * decay
        shift *= 2
        decay *= decay
    return out.reshape(x.shape)


def ema_rows_work(rows: int, n: int) -> dict:
    """Bytes and float32 operations of one ``ema_scan_rows`` call: each
    sample read and its filtered value written (4 bytes each); a multiply,
    a multiply and an add a sample."""
    return dict(bytes=8 * rows * n, exps=0, flops=3 * rows * n)


def ema_blocks_work(samples: int, rows: int, row_bytes: int) -> dict:
    """Bytes and float64 operations of one ``ema_scan_blocks`` call over
    ``samples`` samples in ``rows`` rows: each sample read and written (8
    bytes each) and ``row_bytes`` a row (its slot index, state and flag
    read and written, its ragged bounds); 17 operations a sample (the
    seeding multiply and eight doubling steps of a multiply and an add) and
    2 a row (the carried state's multiply and add)."""
    return dict(bytes=samples * 16 + rows * row_bytes, exps=0,
                flops=samples * 17 + rows * 2)


def ema_scan_rows(x: torch.Tensor, alpha: float = 0.5) -> torch.Tensor:
    """float32 (n,) or (rows, n) -> EMA-filtered float32 of the same shape."""
    _check(x)
    if not 0.0 < alpha <= 1.0:
        raise ValueError(f"alpha must be in (0, 1], got {alpha}")
    where = build.device_of("ema_scan", (x,))
    if where == "cuda" and not x.is_contiguous():
        raise ValueError("ema_scan needs a contiguous tensor")
    out = torch.empty_like(x)
    rows = 1 if x.dim() == 1 else x.shape[0]
    n = x.shape[-1]
    if rows == 0 or n == 0:
        return out
    with build.counted("ema_scan",
                       lambda: build.work(ema_rows_work(rows, n))):
        if where == "cpu":
            out.copy_(ema_scan_plain(x, alpha))
        elif where == "cuda":
            lib = build.library("ema_scan")
            stream = torch.cuda.current_stream(x.device).cuda_stream
            build.check(lib.ema_scan_f32(x.data_ptr(), out.data_ptr(), rows,
                                         n, float(alpha), float(1.0 - alpha),
                                         stream), "ema_scan")
            build.LAUNCHES["ema_scan"] += 1
    return out


# ---------------------------------------------------------------------------
# the profiling engine's blocked float64 EMA
# ---------------------------------------------------------------------------
def ema_filter_block(p: torch.Tensor, state, alpha: float, w: float,
                     has: torch.Tensor | None = None) -> torch.Tensor:
    """One fixed-position EMA block via prefix doubling along the last axis
    (one block or a (k, block) stack): the reference's
    ``repro.pipeline.builder._ema_filter_block``.  ``state`` is the carried
    filter value (a tensor broadcasting against ``p[..., 0]``, or ``None``
    at trace start); ``has``, a bool tensor like ``p[..., 0]``, selects the
    rows that carry one (the others seed with ``p[..., 0]``).  The doubling
    step is a multiply then an add, never a fused multiply-add."""
    out = p * alpha
    if state is None:
        out[..., 0] = p[..., 0]            # batch seeding: out_0 = p_0
    elif has is None:
        out[..., 0] += state * w
    else:
        out[..., 0] = torch.where(has, out[..., 0] + state * w, p[..., 0])
    shift, decay = 1, w
    n = out.shape[-1]
    while shift < n and decay != 0.0:
        out[..., shift:].add_(out[..., :-shift] * decay)
        shift *= 2
        decay *= decay
    return out


def _blocks_args(x, state, has, alpha, n, offsets, index, state_out,
                 has_out, block):
    """Check the arguments; returns (rows, n, host offsets or None)."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(x).__name__}")
    if x.dtype != torch.float64:
        raise TypeError(f"ema_scan_blocks takes float64, got {x.dtype}")
    if not 0.0 < alpha <= 1.0:
        raise ValueError(f"alpha must be in (0, 1], got {alpha}")
    if int(block) <= 0:
        raise ValueError(f"block must be positive, got {block}")
    if offsets is not None:
        if x.dim() != 1 or n is not None:
            raise ValueError("ragged rows (offsets=) take one flat (total,) "
                             "tensor and no n")
        if not x.is_contiguous():
            raise ValueError("ema_scan_blocks needs contiguous samples")
        offs = np.ascontiguousarray(offsets, np.int64).reshape(-1)
        if len(offs) < 1 or offs[0] != 0 or np.any(np.diff(offs) < 0):
            raise ValueError("offsets must start at 0 and never decrease")
        if offs[-1] > x.shape[0]:
            raise ValueError(f"offsets run past the end: {int(offs[-1])} > "
                             f"{x.shape[0]} samples")
        rows, n = len(offs) - 1, None
    else:
        if x.dim() not in (1, 2):
            raise ValueError(f"ema_scan_blocks takes (n,), (rows, n) or flat "
                             f"samples with offsets, got {tuple(x.shape)}")
        if x.shape[-1] > 1 and x.stride(-1) != 1:
            raise ValueError("ema_scan_blocks needs contiguous samples along "
                             "each row")
        m = x.shape[-1]
        n = m if n is None else int(n)
        if not 0 <= n <= m:
            raise ValueError(f"n={n} outside the rows' {m} samples")
        rows, offs = (1 if x.dim() == 1 else x.shape[0]), None
    # without index= every column holds one entry per row
    per_row = rows if index is None else None
    if state is None:
        if not isinstance(has, bool) or has:
            raise ValueError("has= needs a state")
    else:
        _check_column(state, torch.float64, "state", x.device, per_row)
        if not isinstance(has, bool):
            _check_column(has, torch.bool, "has", x.device, per_row)
    if index is not None:
        _check_column(index, torch.int64, "index", x.device, rows)
    if (state_out is None) != (has_out is None):
        raise ValueError("state_out= and has_out= go together")
    if state_out is not None:
        _check_column(state_out, torch.float64, "state_out", x.device,
                      per_row)
        _check_column(has_out, torch.bool, "has_out", x.device, per_row)
    return rows, n, offs


def _check_column(t, dtype, what, device, numel) -> None:
    if not isinstance(t, torch.Tensor) or t.dtype != dtype:
        raise TypeError(f"{what} must be a {dtype} tensor")
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, the samples on {device}")
    if t.dim() > 1 or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous column")
    if numel is not None and t.numel() != numel:
        raise ValueError(f"{what} has {t.numel()} entries for {numel} rows")


def ema_scan_blocks_plain(x: torch.Tensor, state=None, has=False,
                          alpha: float = 0.5, *, n: int | None = None,
                          offsets=None, index: torch.Tensor | None = None,
                          state_out: torch.Tensor | None = None,
                          has_out: torch.Tensor | None = None,
                          block: int = EMA_BLOCK) -> torch.Tensor:
    """Plain PyTorch twin of ``ema_scan_blocks``: the rows padded on the
    right to whole blocks (bit-safe: a doubling step only adds earlier
    positions into later ones), then ``ema_filter_block`` over each column
    of blocks with the carry."""
    rows, n, offs = _blocks_args(x, state, has, alpha, n, offsets, index,
                                 state_out, has_out, block)
    block = int(block)
    w = 1.0 - alpha
    if offs is None:
        lens = np.full(rows, n, np.int64)
        src = x.reshape(rows, -1)[:, :n]
    else:
        lens = np.diff(offs)
    nblk = -(-int(lens.max(initial=0)) // block)
    width = nblk * block
    if offs is None and n == width:
        padded = src
    else:
        padded = torch.zeros((rows, width), dtype=x.dtype, device=x.device)
        if offs is None:
            padded[:, :n] = src
        else:
            pos = torch.from_numpy(np.repeat(np.arange(rows) * width - offs[:-1],
                                             lens)
                                   + np.arange(int(offs[-1]))).to(x.device)
            padded.view(-1)[pos] = x[:offs[-1]]
    slots = torch.arange(rows, device=x.device) if index is None else index
    # gathered copies: state_out may be state itself
    carry = None if has is False else state.reshape(-1)[slots]
    sel = None if isinstance(has, bool) else has.reshape(-1)[slots]
    filt = torch.empty_like(padded)
    for b in range(nblk):
        blk = padded[:, b * block:(b + 1) * block]
        out = ema_filter_block(blk, carry, alpha, w,
                               sel if b == 0 else None)
        carry = out[:, -1]
        filt[:, b * block:(b + 1) * block] = out
    live = np.flatnonzero(lens)               # rows with a last value
    if state_out is not None and len(live):
        at = torch.from_numpy(live).to(x.device)
        last = filt[at, torch.from_numpy(lens[live] - 1).to(x.device)]
        state_out[slots[at]] = last
        has_out[slots[at]] = True
    if offs is None:
        return filt[:, :n].reshape(x.shape[:-1] + (n,))
    return filt.view(-1)[pos]


def ema_scan_blocks(x: torch.Tensor, state=None, has=False,
                    alpha: float = 0.5, *, n: int | None = None,
                    offsets=None, index: torch.Tensor | None = None,
                    state_out: torch.Tensor | None = None,
                    has_out: torch.Tensor | None = None,
                    block: int = EMA_BLOCK) -> torch.Tensor:
    """The blocked float64 EMA over many rows in one launch.

    Rows, each starting at a block boundary:
      * ``x`` of shape ``(n,)`` or ``(rows, m)``: uniform rows, the first
        ``n`` (default: all) samples of each, unit stride along a row;
      * ``x`` flat ``(total,)`` with ``offsets``, a host sequence of
        ``rows + 1`` bounds from 0: ragged rows (length 0 allowed).
    ``state`` (float64) and ``has`` (bool tensor, or one bool for every
    row) give each row's carried filter value and whether it has one, read
    at the row's slot: ``index[row]`` when ``index`` is given, else the row
    (a single row may pass a 0-dim ``state``).  With ``state_out`` and
    ``has_out``, each row of at least one sample writes its last filtered
    value and ``True`` at its slot (they may be ``state`` and ``has``
    themselves; slots must then differ between rows).  Returns the filtered
    samples: ``(n,)`` / ``(rows, n)``, or flat in the ragged layout.
    """
    rows, n, offs = _blocks_args(x, state, has, alpha, n, offsets, index,
                                 state_out, has_out, block)
    where = build.device_of("ema_scan", (x,))
    if where != "cpu" and int(block) != EMA_BLOCK:
        raise ValueError(f"the kernel filters blocks of {EMA_BLOCK} samples, "
                         f"not {block}")
    host_offs = off_t = None
    if offs is None:
        out = torch.empty(x.shape[:-1] + (n,), dtype=x.dtype, device=x.device)
    else:
        out = torch.empty(int(offs[-1]), dtype=x.dtype, device=x.device)
    if rows == 0 or out.numel() == 0:
        return out
    # a row's own bytes: slot index, state (and flag) read, state and flag
    # written, ragged bounds
    row_bytes = (8 * (index is not None) + 8 * (state is not None)
                 + (not isinstance(has, bool)) + 9 * (state_out is not None)
                 + 8 * (offs is not None))
    with build.counted("ema_scan", lambda: build.work(ema_blocks_work(
            out.numel(), rows, row_bytes))):
        if where == "cpu":
            out.copy_(ema_scan_blocks_plain(
                x, state, has, alpha, n=n, offsets=offsets, index=index,
                state_out=state_out, has_out=has_out, block=block))
        elif where == "cuda":
            if offs is not None and rows <= _INLINE_ROWS:
                host_offs = offs.ctypes.data      # copied into the launch
            elif offs is not None:
                # through pinned memory: the copy neither syncs the host nor
                # reuses the buffer before the card has read it
                off_t = torch.from_numpy(offs).pin_memory().to(
                    x.device, non_blocking=True)
            lib = build.library("ema_scan")
            stream = torch.cuda.current_stream(x.device).cuda_stream
            ptr = (lambda t: None if t is None else t.data_ptr())
            build.check(lib.ema_blocks_f64(
                x.data_ptr(), out.data_ptr(), host_offs, ptr(off_t), rows,
                n or 0, x.stride(0) if x.dim() == 2 else 0, ptr(state),
                None if isinstance(has, bool) else has.data_ptr(),
                int(has is True), ptr(index), ptr(state_out), ptr(has_out),
                float(alpha), float(1.0 - alpha), stream), "ema_scan")
            build.LAUNCHES["ema_scan"] += 1
    return out
