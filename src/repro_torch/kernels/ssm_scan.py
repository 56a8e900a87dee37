"""Mamba-1 selective scan over ``(b, s, di)`` sequences.

``ssm_scan_bsd(x, dt, A, B, C, D, h0, h_out)`` runs, per sequence and
channel, h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t and
y_t = C_t . h_t (+ D * x_t), with the state in float32, through the CUDA
kernel ``csrc/ssm_scan.cu``, and returns ``(y, h_last)``: y ``(b, s, di)``
in x's dtype, h_last ``(b, di, ds)`` float32.  x is float32 or bfloat16 and
dt float32 or bfloat16, both contiguous (on either device) and used as
they are; A ``(di, ds)``, B and C ``(b, s, ds)``, D ``(di,)`` and h0
``(b, di, ds)`` are small and taken as float32.  ``D=None`` leaves out the
skip term, ``h0=None`` starts from a zero state, and ``h_out`` (float32,
contiguous; it may be h0 itself) receives h_last in place.  Any s and di;
1 <= ds <= 128.

``ssm_scan_plain`` is the same function in plain PyTorch, the twin of the
reference's ``ref.ssm_scan_ref``.  The wrapper takes it for CPU tensors
only; for CUDA tensors it launches the kernel or raises.  ``scan_work``
counts the bytes, exps and other float32 operations of one call.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16"}
MAX_STATE = 128                   # 32 lanes of 4 states in the kernel


def scan_work(b: int, s: int, di: int, ds: int, x_bytes: int,
              dt_bytes: int, skip: bool, h0: bool) -> dict:
    """Bytes, exps and other float32 operations of one call: x, dt, B, C,
    A (and D, h0) read once, y and h_last written once, at ``x_bytes`` and
    ``dt_bytes`` an element of x (and y) and dt; per (step, channel, state)
    one exp and six float32 operations (dt*A, decay*h, dtx*B, add, C*h,
    add), per (step, channel) dt*x (and the skip term's multiply-add)."""
    nbytes = (b * s * di * (2 * x_bytes + dt_bytes) + 2 * b * s * ds * 4
              + di * ds * 4 + b * di * ds * 4 * (2 if h0 else 1)
              + (di * 4 if skip else 0))
    exps = b * s * di * ds
    flops = 6 * exps + b * s * di * (3 if skip else 1)
    return dict(bytes=nbytes, exps=exps, flops=flops)


def _check(x, dt, A, B, C, D, h0, h_out) -> None:
    named = (("x", x), ("dt", dt), ("A", A), ("B", B), ("C", C), ("D", D),
             ("h0", h0), ("h_out", h_out))
    for name, t in named:
        if t is None and name in ("D", "h0", "h_out"):
            continue
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"ssm_scan: {name} must be a torch.Tensor, got "
                            f"{type(t).__name__}")
        if t.dtype not in _NAMES:
            raise TypeError(f"ssm_scan takes float32 or bfloat16, got "
                            f"{name} {t.dtype}")
    if x.dim() != 3 or dt.shape != x.shape:
        raise ValueError(f"ssm_scan: x and dt must be one (b, s, di) shape, "
                         f"got {tuple(x.shape)} and {tuple(dt.shape)}")
    b, s, di = x.shape
    if A.dim() != 2 or A.shape[0] != di:
        raise ValueError(f"ssm_scan: A must be ({di}, ds), got "
                         f"{tuple(A.shape)}")
    ds = A.shape[1]
    if not 1 <= ds <= MAX_STATE:
        raise ValueError(f"ssm_scan takes 1 <= ds <= {MAX_STATE}, got {ds}")
    for name, t, shape in (("B", B, (b, s, ds)), ("C", C, (b, s, ds)),
                           ("D", D, (di,)), ("h0", h0, (b, di, ds)),
                           ("h_out", h_out, (b, di, ds))):
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"ssm_scan: {name} must be {shape}, got "
                             f"{tuple(t.shape)}")
    if h_out is not None and h_out.dtype != torch.float32:
        raise TypeError(f"ssm_scan: h_out must be float32, got "
                        f"{h_out.dtype}")
    # the kernel's layout, held on the CPU too so that the CPU tests see it
    if not (x.is_contiguous() and dt.is_contiguous()):
        raise ValueError("ssm_scan needs contiguous x and dt")
    if h_out is not None and not h_out.is_contiguous():
        raise ValueError("ssm_scan needs a contiguous h_out")


def ssm_scan_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor,
                   D: torch.Tensor | None = None,
                   h0: torch.Tensor | None = None,
                   h_out: torch.Tensor | None = None):
    """Plain PyTorch twin of the kernel (``ref.py:28``): a float32 loop
    over time.  Returns ``(y, h_last)``."""
    _check(x, dt, A, B, C, D, h0, h_out)
    b, s, di = x.shape
    xf, dtf = x.to(torch.float32), dt.to(torch.float32)
    Af, Bf, Cf = (t.to(torch.float32) for t in (A, B, C))
    h = torch.zeros((b, di, A.shape[1]), dtype=torch.float32,
                    device=x.device) if h0 is None else h0.to(torch.float32)
    ys = []
    for t in range(s):
        a = torch.exp(dtf[:, t, :, None] * Af[None])             # (b, di, ds)
        u = (dtf[:, t] * xf[:, t])[:, :, None] * Bf[:, t, None, :]
        h = a * h + u
        ys.append(torch.einsum("bin,bn->bi", h, Cf[:, t]))
    y = torch.stack(ys, dim=1) if ys else torch.zeros_like(xf)
    if D is not None:
        y = y + D.to(torch.float32)[None, None] * xf
    if h_out is not None:
        h = h_out.copy_(h)
    return y.to(x.dtype), h


def ssm_scan_bsd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor,
                 D: torch.Tensor | None = None,
                 h0: torch.Tensor | None = None,
                 h_out: torch.Tensor | None = None):
    """x, dt (b, s, di); A (di, ds); B, C (b, s, ds); D (di,) or None;
    h0, h_out (b, di, ds) or None -> (y (b, s, di), h_last (b, di, ds))."""
    _check(x, dt, A, B, C, D, h0, h_out)
    given = [t for t in (x, dt, A, B, C, D, h0, h_out) if t is not None]
    devices = {t.device for t in given}
    if devices == {torch.device("cpu")}:
        return ssm_scan_plain(x, dt, A, B, C, D, h0, h_out)
    if len(devices) != 1 or x.device.type != "cuda":
        raise ValueError(f"ssm_scan runs on cuda or cpu with every tensor on "
                         f"one device, not {sorted(map(str, devices))}")
    b, s, di = x.shape
    ds = A.shape[1]
    if b > 65535 or max(s, di) > 2**31 - 1:
        raise ValueError(f"ssm_scan: shape {tuple(x.shape)} exceeds the "
                         f"kernel's grid")
    Af, Bf, Cf = (t.to(torch.float32).contiguous() for t in (A, B, C))
    Df = None if D is None else D.to(torch.float32).contiguous()
    h0f = None if h0 is None else h0.to(torch.float32).contiguous()
    y = torch.empty_like(x)
    h_last = h_out if h_out is not None else torch.empty(
        (b, di, ds), dtype=torch.float32, device=x.device)
    fn = getattr(build.library("ssm_scan"),
                 f"ssm_scan_{_NAMES[x.dtype]}_{_NAMES[dt.dtype]}")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    build.check(fn(x.data_ptr(), dt.data_ptr(), Af.data_ptr(), Bf.data_ptr(),
                   Cf.data_ptr(), 0 if Df is None else Df.data_ptr(),
                   0 if h0f is None else h0f.data_ptr(), y.data_ptr(),
                   h_last.data_ptr(), b, s, di, ds, stream), "ssm_scan")
    build.LAUNCHES["ssm_scan"] += 1
    return y, h_last
