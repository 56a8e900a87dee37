"""RMSNorm over the rows of an ``(n, d)`` block.

``rmsnorm_rows`` computes ``x * rsqrt(mean(x**2) + eps) * scale`` per row
with float32 statistics and casts the result to ``x``'s dtype, through the
CUDA kernel ``csrc/rmsnorm.cu`` (a CTA a row, x read once).
``x`` is float32 or bfloat16, ``scale`` a ``(d,)`` float32 or bfloat16
vector.
``rmsnorm_plain`` is the same function in plain PyTorch, the twin of the
reference's ``ref.rmsnorm_ref``.  The wrapper takes the plain version for a
CPU tensor only; for a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_SIZES = {torch.float32: 4, torch.bfloat16: 2}
_VEC_BYTES = 16


def _check(x, scale) -> None:
    for name, t in (("x", x), ("scale", scale)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"rmsnorm: {name} must be a torch.Tensor, got "
                            f"{type(t).__name__}")
        if t.dtype not in _NAMES:
            raise TypeError(f"rmsnorm takes float32 or bfloat16, got "
                            f"{name} {t.dtype}")
    if x.dim() != 2:
        raise ValueError(f"rmsnorm_rows takes (n, d), got {tuple(x.shape)}")
    if scale.shape != (x.shape[1],):
        raise ValueError(f"rmsnorm scale must be ({x.shape[1]},), got "
                         f"{tuple(scale.shape)}")


def _kernel(xdtype, sdtype):
    """The library's entry point for (x dtype, scale dtype)."""
    lib = build.library("rmsnorm")
    return getattr(lib, f"rmsnorm_{_NAMES[xdtype]}_{_NAMES[sdtype]}")


def _raw_stream(device) -> int:
    """The current CUDA stream's handle: through the one-call accessor where
    this PyTorch has it (a decode step calls the wrapper 81 times)."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(device.index if device.index is not None
                   else torch.cuda.current_device())
    return torch.cuda.current_stream(device).cuda_stream


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch twin of the kernel (float32 statistics)."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)
            * scale.to(torch.float32)).to(x.dtype)


def rmsnorm_rows(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5,
                 *, pdl: bool = False) -> torch.Tensor:
    """(n, d) float32/bfloat16 -> (n, d) of the same dtype.

    ``pdl=True`` launches the kernel with programmatic dependent launch: it
    may start, and load ``scale``, while the kernel before it on the stream
    is still running, and waits for that kernel only before it reads ``x``.
    So it is for a ``scale`` that no kernel just before this call writes, a
    weight (``models.layers.Norm``); a decode step's chain of residual adds
    and norms is faster with it (``PERF.md``)."""
    _check(x, scale)
    dev, sdev = x.device, scale.device
    if dev.type == "cpu" and sdev.type == "cpu":
        return rmsnorm_plain(x, scale, eps)
    if dev.type != "cuda" or sdev != dev:
        raise ValueError(f"rmsnorm runs on cuda or cpu with x and scale on "
                         f"one device, not {dev} and {sdev}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm needs contiguous x and scale")
    n, d = x.shape
    if n > 2**31 - 1 or d > 2**31 - 1:
        raise ValueError(f"rmsnorm takes fewer than 2**31 rows and columns, "
                         f"got {tuple(x.shape)}")
    out = torch.empty_like(x)
    vectorized = (d % (_VEC_BYTES // _SIZES[x.dtype]) == 0
                  and x.data_ptr() % _VEC_BYTES == 0
                  and out.data_ptr() % _VEC_BYTES == 0
                  and scale.data_ptr() % _VEC_BYTES == 0)
    build.check(_kernel(x.dtype, scale.dtype)(
        x.data_ptr(), scale.data_ptr(), out.data_ptr(), n, d, float(eps),
        int(vectorized), int(pdl), _raw_stream(dev)), "rmsnorm")
    build.LAUNCHES["rmsnorm"] += 1
    return out
