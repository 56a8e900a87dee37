"""RMSNorm over the rows of an ``(n, d)`` block.

``rmsnorm_rows`` computes ``x * rsqrt(mean(x**2) + eps) * scale`` per row
with float32 statistics and casts the result to ``x``'s dtype, through the
CUDA kernel ``csrc/rmsnorm.cu`` (one CTA per row).  ``x`` is float32 or
bfloat16, ``scale`` a ``(d,)`` float32 or bfloat16 vector.
``rmsnorm_plain`` is the same function in plain PyTorch, the twin of the
reference's ``ref.rmsnorm_ref``.  The wrapper takes the plain version for a
CPU tensor only; for a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16"}
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


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch twin of the kernel (float32 statistics)."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)
            * scale.to(torch.float32)).to(x.dtype)


def rmsnorm_rows(x: torch.Tensor, scale: torch.Tensor,
                 eps: float = 1e-5) -> torch.Tensor:
    """(n, d) float32/bfloat16 -> (n, d) of the same dtype."""
    _check(x, scale)
    if x.device.type == "cpu" and scale.device.type == "cpu":
        return rmsnorm_plain(x, scale, eps)
    if x.device.type != "cuda" or scale.device != x.device:
        raise ValueError(f"rmsnorm runs on cuda or cpu with x and scale on "
                         f"one device, not {x.device} and {scale.device}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm needs contiguous x and scale")
    n, d = x.shape
    if n > 2**31 - 1 or d > 2**31 - 1:
        raise ValueError(f"rmsnorm takes fewer than 2**31 rows and columns, "
                         f"got {tuple(x.shape)}")
    out = torch.empty_like(x)
    vec = _VEC_BYTES // x.element_size()
    vectorized = (d % vec == 0 and x.data_ptr() % _VEC_BYTES == 0
                  and out.data_ptr() % _VEC_BYTES == 0)
    lib = build.library("rmsnorm")
    fn = getattr(lib, f"rmsnorm_{_NAMES[x.dtype]}_{_NAMES[scale.dtype]}")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    build.check(fn(x.data_ptr(), scale.data_ptr(), out.data_ptr(), n, d,
                   float(eps), int(vectorized), stream), "rmsnorm")
    build.LAUNCHES["rmsnorm"] += 1
    return out
