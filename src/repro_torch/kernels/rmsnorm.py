"""RMSNorm over the rows of an ``(n, d)`` block.

``rmsnorm_rows`` computes ``x * rsqrt(mean(x**2) + eps) * scale`` per row
with float32 statistics and casts the result to ``x``'s dtype, through the
CUDA kernel ``csrc/rmsnorm.cu`` (a CTA a row, x read once).
``x`` is float32 or bfloat16, ``scale`` a ``(d,)`` float32 or bfloat16
vector.
``rmsnorm_plain`` is the same function in plain PyTorch, the twin of the
reference's ``ref.rmsnorm_ref``.  The wrapper takes the plain version for a
CPU tensor only; for a CUDA tensor it launches the kernel or raises; for a
meta tensor it allocates the output and launches nothing.  ``norm_work``
and ``norm_bwd_work`` count the bytes and operations of one call.

The gradient: ``rmsnorm_bwd(x, scale, dy, eps)`` returns ``(dx, dscale)``
(dx in x's dtype; dscale summed over the rows in float32, in scale's dtype)
through the backward entry points of ``csrc/rmsnorm.cu`` (launch counter
``rmsnorm_bwd``, one launch a call), or ``rmsnorm_bwd_plain`` for CPU
tensors.  ``bwd_plan`` is that launch's plan (warps a row, ring stages,
CTAs and their runs of rows, shared memory), in Python so that the CPU
tests reach it.
``RMSNormFn`` is the ``torch.autograd.Function`` over the two, which
``ops.rmsnorm`` takes when a gradient is wanted; under grad mode
``rmsnorm_rows`` refuses a CUDA input that requires grad.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import build

_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_SIZES = {torch.float32: 4, torch.bfloat16: 2}
_VEC_BYTES = 16
# rmsnorm.cu's backward constants (kBwdThreads, kBwdMaxChunks, kBwdMinCtas,
# kBwdMaxStages, kBwdHeader, kBwdColSmem; a test reads them from the source)
BWD_THREADS = 256
BWD_MAX_CHUNKS = 8                 # of a row, a thread: its dscale partial
BWD_MIN_CTAS = 2                   # CTAs an SM the registers are kept for
BWD_MAX_STAGES = 8
BWD_HEADER = 256
BWD_COL_SMEM = 1024
_BWD_STAGES = 3                    # the ring depth the plan asks first
_BWD_COL_RUN = 16                  # partials a thread adds one after another
# an H100 SM's shared memory, the most one CTA may ask for, and what the SM
# keeps for each resident CTA (bytes)
_SMEM_SM, _SMEM_CTA, _SMEM_RESERVED = 233_472, 232_448, 1024


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


def norm_work(n: int, d: int, x_bytes: int, s_bytes: int) -> dict:
    """Bytes and float32 operations of one forward call: x read and the
    output written at ``x_bytes`` an element, scale read once at
    ``s_bytes``; four operations an element (square, add; two
    multiplies)."""
    return dict(bytes=2 * n * d * x_bytes + d * s_bytes, exps=0,
                flops=4 * n * d)


def norm_bwd_work(n: int, d: int, x_bytes: int, s_bytes: int) -> dict:
    """Least bytes and float32 operations of one backward call: x and dy
    read and dx written at ``x_bytes`` an element, scale read and dscale
    written at ``s_bytes``; eleven operations an element (x^2 and its sum,
    x^ = x r, g = dy scale, g x^ and its sum, dx = r (g - x^ mean), dy x^
    and its sum over the rows)."""
    return dict(bytes=3 * n * d * x_bytes + 2 * d * s_bytes, exps=0,
                flops=11 * n * d)


def _aligned(t: torch.Tensor) -> bool:
    """16-byte aligned data: on the card its address; elsewhere its offset
    in its storage (the card's allocator aligns a storage to 512 bytes)."""
    if t.device.type == "cuda":
        return t.data_ptr() % _VEC_BYTES == 0
    return t.storage_offset() * t.element_size() % _VEC_BYTES == 0


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
    where = build.device_of("rmsnorm", (x, scale))
    n, d = x.shape
    if where != "cpu":
        if not (x.is_contiguous() and scale.is_contiguous()):
            raise ValueError("rmsnorm needs contiguous x and scale")
        if n > 2**31 - 1 or d > 2**31 - 1:
            raise ValueError(f"rmsnorm takes fewer than 2**31 rows and "
                             f"columns, got {tuple(x.shape)}")
    out = torch.empty_like(x)
    with build.counted("rmsnorm", lambda: build.work(norm_work(
            n, d, x.element_size(), scale.element_size()))):
        if where == "cpu":
            out.copy_(rmsnorm_plain(x, scale, eps))
        elif where == "cuda":
            vectorized = (d % (_VEC_BYTES // _SIZES[x.dtype]) == 0
                          and x.data_ptr() % _VEC_BYTES == 0
                          and out.data_ptr() % _VEC_BYTES == 0
                          and scale.data_ptr() % _VEC_BYTES == 0)
            build.check(_kernel(x.dtype, scale.dtype)(
                x.data_ptr(), scale.data_ptr(), out.data_ptr(), n, d,
                float(eps), int(vectorized), int(pdl),
                _raw_stream(x.device)), "rmsnorm")
            build.launched("rmsnorm")
    return out


def _align(nbytes: int) -> int:
    return -(-nbytes // 128) * 128


def bwd_smem(d: int, rows_per_step: int, stages: int, x_size: int,
             s_size: int) -> int:
    """Dynamic shared memory of the backward kernel (``bwd_smem`` in
    ``rmsnorm.cu``): the header, scale, then the largest of the ring
    (``stages`` x the step's rows of x and of dy), the step's groups'
    float32 dscale partials and the column sums' chunk sums."""
    ring = 2 * stages * _align(rows_per_step * d * x_size)
    return BWD_HEADER + _align(d * s_size) + max(
        ring, _align(4 * rows_per_step * d), BWD_COL_SMEM)


@dataclasses.dataclass(frozen=True)
class NormBwdPlan:
    """One launch of the backward kernel: ``ctas`` CTAs of ``per``
    consecutive rows (the last fewer), ``rows_per_step`` rows a step, one
    to each group of ``warps`` warps, a thread at most ``chunks`` chunks of
    ``vec`` elements of its row; a ring of ``stages`` steps of x and dy
    (``stage_bytes`` a step; 0 stages: rows read from device memory);
    ``smem_bytes`` of dynamic shared memory, ``ctas_per_sm`` resident an
    SM.  dscale: each CTA sums ``cols`` of its columns, ``col_width`` at a
    time, each over ``col_chunks`` runs of consecutive CTAs' partials
    (``per_chunk`` a run), then the runs' sums in order."""
    rows: int
    d: int
    vec: int
    warps: int
    rows_per_step: int
    chunks: int
    stages: int
    stage_bytes: int
    smem_bytes: int
    ctas_per_sm: int
    ctas: int
    per: int
    cols: int
    col_width: int
    col_chunks: int

    @property
    def per_chunk(self) -> int:
        """CTAs' partials a thread adds one after another."""
        return -(-self.ctas // self.col_chunks)

    @property
    def partial_floats(self) -> int:
        """float32 scratch: a partial a CTA."""
        return self.ctas * self.d


def bwd_plan(n: int, d: int, x_size: int, s_size: int, vectorized: bool,
             sms: int) -> NormBwdPlan:
    """The backward's launch on a card of ``sms`` SMs for ``n`` rows of
    ``d`` elements of ``x_size`` bytes (scale of ``s_size``).  A row's
    chunks (16 bytes vectorized, else an element) go to the group of
    warps that leaves the fewest threads idle, the larger group on a tie;
    the CTAs an SM and the ring's stages are the most that fit in shared
    memory, CTAs first; the grid is persistent (and co-resident: the
    launch is cooperative), each CTA a run of rows.  dscale's columns are
    split evenly over the CTAs; a column's partials go to runs of at most
    ``_BWD_COL_RUN`` CTAs, a thread each, as many columns at once as the
    CTA's threads allow.  Raises for a row wider than ``BWD_MAX_CHUNKS``
    chunks a thread."""
    vec = _VEC_BYTES // x_size if vectorized else 1
    chunks = d // vec
    best = None
    for warps in (8, 4, 2, 1):
        nc = -(-chunks // (32 * warps))
        idle = nc * 32 * warps - chunks
        if nc <= BWD_MAX_CHUNKS and (best is None or idle < best[0]):
            best = (idle, warps, nc)
    if best is None:
        raise ValueError(
            f"rmsnorm_bwd keeps at most {BWD_MAX_CHUNKS} chunks of {vec} "
            f"element(s) a thread, {BWD_MAX_CHUNKS * BWD_THREADS * vec} "
            f"elements a row; got d={d}")
    _, warps, nc = best
    rows_per_step = BWD_THREADS // 32 // warps
    # (rows of BWD_MAX_CHUNKS chunks a thread fit two stages at one CTA)
    cpsm, stages = next(
        (c, st) for c in range(BWD_MIN_CTAS, 0, -1)
        for st in (range(_BWD_STAGES, 1, -1) if vectorized else (0,))
        if bwd_smem(d, rows_per_step, st, x_size, s_size)
        <= min(_SMEM_CTA, _SMEM_SM // c - _SMEM_RESERVED))
    smem = bwd_smem(d, rows_per_step, stages, x_size, s_size)
    per = -(-n // (sms * cpsm))
    ctas = -(-n // per)
    cols = -(-d // ctas)
    col_chunks = min(-(-ctas // _BWD_COL_RUN), BWD_THREADS)
    col_width = min(cols, BWD_THREADS // col_chunks)
    return NormBwdPlan(n, d, vec, warps, rows_per_step, nc, stages,
                       2 * rows_per_step * d * x_size, smem, cpsm, ctas, per,
                       cols, col_width, col_chunks)


_tickets: dict[tuple[int, int], torch.Tensor] = {}


def _ticket_counters(device, stream: int) -> torch.Tensor:
    """The grid barrier's two int32 counters, at 0, one pair a device and
    stream (the kernel sets them back to 0 when it is done)."""
    key = (device.index, stream)
    if key not in _tickets:
        _tickets[key] = torch.zeros(2, dtype=torch.int32, device=device)
    return _tickets[key]


def rmsnorm_bwd(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                eps: float = 1e-5):
    """(dx, dscale) of ``rmsnorm_rows`` at (x, scale) given the output's
    gradient dy (n, d) in x's dtype."""
    _check(x, scale)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"rmsnorm_bwd: dy {tuple(dy.shape)} {dy.dtype} does "
                         f"not match x {tuple(x.shape)} {x.dtype}")
    where = build.device_of("rmsnorm_bwd", (x, scale, dy))
    x, scale, dy = x.contiguous(), scale.contiguous(), dy.contiguous()
    n, d = x.shape
    dx = torch.empty_like(x)
    if n == 0:
        return dx, torch.zeros_like(scale)
    dscale = torch.empty_like(scale)
    vectorized = d % (_VEC_BYTES // _SIZES[x.dtype]) == 0 and all(
        map(_aligned, (x, scale, dy, dx)))

    def make_plan():
        return bwd_plan(n, d, _SIZES[x.dtype], _SIZES[scale.dtype],
                        vectorized, build.sms(x.device))
    with build.counted("rmsnorm_bwd", lambda: build.work(norm_bwd_work(
            n, d, x.element_size(), scale.element_size()),
            4 * make_plan().partial_floats)):
        if where == "cpu":
            for out, got in zip((dx, dscale),
                                rmsnorm_bwd_plain(x, scale, dy, eps)):
                out.copy_(got)
        elif where == "cuda":
            plan = make_plan()
            partial = torch.empty(plan.partial_floats, dtype=torch.float32,
                                  device=x.device)
            stream = _raw_stream(x.device)
            tickets = _ticket_counters(x.device, stream)
            fn = getattr(build.library("rmsnorm"),
                         f"rmsnorm_bwd_{_NAMES[x.dtype]}_"
                         f"{_NAMES[scale.dtype]}")
            build.check(fn(x.data_ptr(), scale.data_ptr(), dy.data_ptr(),
                           dx.data_ptr(), partial.data_ptr(),
                           tickets.data_ptr(), dscale.data_ptr(), n, d,
                           float(eps), int(vectorized), plan.ctas, plan.per,
                           plan.warps, plan.stages, plan.cols,
                           plan.col_width, plan.col_chunks, plan.smem_bytes,
                           stream), "rmsnorm_bwd")
            build.launched("rmsnorm_bwd")
    return dx, dscale


class RMSNormFn(torch.autograd.Function):
    """RMSNorm over the rows of (n, d) whose backward is ``rmsnorm_bwd``
    (the kernel on the card, the plain twin on the CPU, shapes alone on
    meta)."""

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
