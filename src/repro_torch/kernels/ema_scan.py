"""First-order EMA filter over float32 traces.

``ema_scan_rows`` filters each row of a ``(rows, n)`` (or one ``(n,)``)
float32 tensor, out_t = alpha*x_t + (1-alpha)*out_{t-1} with the state
seeded as out_{-1} = x_0, through the CUDA kernel ``csrc/ema_scan.cu``.
``ema_scan_plain`` is the same function in plain PyTorch (float32 prefix
doubling, separate multiply and add).  The wrapper takes the plain version
for a CPU tensor only; for a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build


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


def ema_scan_rows(x: torch.Tensor, alpha: float = 0.5) -> torch.Tensor:
    """float32 (n,) or (rows, n) -> EMA-filtered float32 of the same shape."""
    _check(x)
    if not 0.0 < alpha <= 1.0:
        raise ValueError(f"alpha must be in (0, 1], got {alpha}")
    if x.device.type == "cpu":
        return ema_scan_plain(x, alpha)
    if x.device.type != "cuda":
        raise ValueError(f"ema_scan runs on cuda or cpu, not {x.device}")
    if not x.is_contiguous():
        raise ValueError("ema_scan needs a contiguous tensor")
    out = torch.empty_like(x)
    rows = 1 if x.dim() == 1 else x.shape[0]
    n = x.shape[-1]
    if rows == 0 or n == 0:
        return out
    lib = build.library("ema_scan")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    build.check(lib.ema_scan_f32(x.data_ptr(), out.data_ptr(), rows, n,
                                 float(alpha), float(1.0 - alpha), stream),
                "ema_scan")
    build.LAUNCHES["ema_scan"] += 1
    return out
