"""RMSNorm over the rows of an ``(n, d)`` block.

``rmsnorm_rows`` computes ``x * rsqrt(mean(x**2) + eps) * scale`` per row
with float32 statistics and casts the result to ``x``'s dtype, through the
CUDA kernel ``csrc/rmsnorm.cu`` (a CTA a row, x read once).
``x`` is float32 or bfloat16, ``scale`` a ``(d,)`` float32 or bfloat16
vector.
``rmsnorm_plain`` is the same function in plain PyTorch, the twin of the
reference's ``ref.rmsnorm_ref``.  The wrapper takes the plain version for a
CPU tensor only; for a CUDA tensor it launches the kernel or raises.

The gradient: ``rmsnorm_bwd(x, scale, dy, eps)`` returns ``(dx, dscale)``
(dx in x's dtype; dscale summed over the rows in float32, in scale's dtype)
through the backward entry points of ``csrc/rmsnorm.cu`` (launch counter
``rmsnorm_bwd``), or ``rmsnorm_bwd_plain`` for CPU tensors.
``RMSNormFn`` is the ``torch.autograd.Function`` over the two, which
``ops.rmsnorm`` takes when a gradient is wanted; under grad mode
``rmsnorm_rows`` refuses a CUDA input that requires grad.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_SIZES = {torch.float32: 4, torch.bfloat16: 2}
_VEC_BYTES = 16
_BWD_MAX_CHUNKS = 8 * 256          # rmsnorm.cu: kChunks x kThreads


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


def rmsnorm_bwd_plain(x: torch.Tensor, scale: torch.Tensor,
                      dy: torch.Tensor, eps: float = 1e-5):
    """The backward's formulas in plain PyTorch: with r = rsqrt(mean(x^2)
    + eps), x^ = x r and g = dy scale, dx = r (g - x^ mean(g x^)) and
    dscale = sum over rows of dy x^, in float32; cast to x's and scale's
    dtypes."""
    xf = x.to(torch.float32)
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    xh = xf * r
    gy = dy.to(torch.float32)
    g = gy * scale.to(torch.float32)
    mean = torch.mean(g * xh, dim=-1, keepdim=True)
    return ((r * (g - xh * mean)).to(x.dtype),
            (gy * xh).sum(0).to(scale.dtype))


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
    if not build.on_card("rmsnorm", (x, scale)):
        return rmsnorm_plain(x, scale, eps)
    dev = x.device
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


def rmsnorm_bwd(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                eps: float = 1e-5):
    """(dx, dscale) of ``rmsnorm_rows`` at (x, scale) given the output's
    gradient dy (n, d) in x's dtype."""
    _check(x, scale)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"rmsnorm_bwd: dy {tuple(dy.shape)} {dy.dtype} does "
                         f"not match x {tuple(x.shape)} {x.dtype}")
    if not build.on_card("rmsnorm_bwd", (x, scale, dy)):
        return rmsnorm_bwd_plain(x, scale, dy, eps)
    x, scale, dy = x.contiguous(), scale.contiguous(), dy.contiguous()
    n, d = x.shape
    vec = _VEC_BYTES // _SIZES[x.dtype]
    vectorized = d % vec == 0 and all(
        t.data_ptr() % _VEC_BYTES == 0 for t in (x, scale, dy))
    if -(-d // (vec if vectorized else 1)) > _BWD_MAX_CHUNKS:
        raise ValueError(f"rmsnorm_bwd keeps at most {_BWD_MAX_CHUNKS} "
                         f"chunks of a row in registers, got d={d}")
    dx = torch.empty_like(x)
    if vectorized and dx.data_ptr() % _VEC_BYTES:
        raise ValueError("rmsnorm_bwd: dx is not 16-byte aligned")
    dscale = torch.empty_like(scale)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    blocks = max(1, min(n, 2 * sms))
    partial = torch.empty((blocks, d), dtype=torch.float32, device=x.device)
    fn = getattr(build.library("rmsnorm"),
                 f"rmsnorm_bwd_{_NAMES[x.dtype]}_{_NAMES[scale.dtype]}")
    build.check(fn(x.data_ptr(), scale.data_ptr(), dy.data_ptr(),
                   dx.data_ptr(), partial.data_ptr(), dscale.data_ptr(), n, d,
                   float(eps), int(vectorized), blocks,
                   _raw_stream(x.device)), "rmsnorm_bwd")
    build.LAUNCHES["rmsnorm_bwd"] += 1
    return dx, dscale


class RMSNormFn(torch.autograd.Function):
    """RMSNorm over the rows of (n, d) whose backward is ``rmsnorm_bwd``
    (the kernel on the card, the plain twin on the CPU)."""

    @staticmethod
    def forward(ctx, x, scale, eps: float, pdl: bool):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return rmsnorm_rows(x, scale, eps, pdl=pdl)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_bwd(x, scale, dy, ctx.eps)
        return (dx if ctx.needs_input_grad[0] else None,
                dscale if ctx.needs_input_grad[1] else None, None, None)
