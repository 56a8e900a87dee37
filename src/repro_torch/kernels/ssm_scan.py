"""Mamba-1 selective scan over ``(b, s, di)`` sequences, and its gradient.

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

``ssm_scan_bwd(x, dt, A, B, C, D, h0, dy, dh_last)`` is its gradient
through ``csrc/ssm_scan_bwd.cu``: ``(dx, ddt, dA, dB, dC, dD, dh0)``, dx in
x's dtype, ddt in dt's, the rest float32 (dD None without D, dh0 None
without h0).  ``SSMScanFn`` is the ``torch.autograd.Function`` whose
forward is ``ssm_scan_bsd`` and whose backward is ``ssm_scan_bwd``;
``ops.ssm_scan`` routes through it when an input requires grad.

``ssm_scan_plain`` and ``ssm_scan_bwd_plain`` are the same functions in
plain PyTorch (the first the twin of the reference's ``ref.ssm_scan_ref``,
the second its gradient as an explicit reverse-time loop).  The wrappers
take them for CPU tensors only; for CUDA tensors they launch the kernels
or raise; for meta tensors they allocate the card path's outputs and
launch nothing; and the bare wrappers refuse CUDA and meta inputs that
require grad (a kernel's output would cut the graph).  ``scan_work`` and
``scan_bwd_work`` count the bytes, exps and other float32 operations of
one call.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import build

_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16"}
MAX_STATE = 128                   # 32 lanes of 4 states in the kernel
# the backward kernel's shape (csrc/ssm_scan_bwd.cu's kThreads, kSteps):
# threads a CTA, steps a block
BWD_THREADS, BWD_STEPS = 128, 8
# its layouts (kEightLanes, kFourLanes, kWideLanes): threads a channel ->
# states a thread; the first two take ds <= 16, the last ds <= 128
BWD_LAYOUTS = {2: 8, 4: 4, 16: 8}
BWD_SMALL_STATE = 16
# eight states a thread (2 lanes) when their grid gives every SM at least
# this many CTAs (kEightCtas: the registers of two fit an SM), else four
_BWD_EIGHT_MIN_CTAS = 2


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


def scan_bwd_work(b: int, s: int, di: int, ds: int, x_bytes: int,
                  dt_bytes: int, skip: bool, h0: bool,
                  dh_last: bool) -> dict:
    """Least bytes, exps and other float32 operations of one backward call.
    Bytes: x, dt and dy (x's dtype) read once and dx, ddt written once, at
    ``x_bytes`` and ``dt_bytes`` an element; B and C read and dB, dC
    written, A read and dA written (and D and dD, h0 and dh0, dh_last), all
    float32.  The states are recomputed, not stored: storing them would
    move 4 b s di ds bytes.  Per (step, channel, state) one exp (a_t) and
    19 float32 operations: the state recomputed (dt*A, a*h, dtx*B, add),
    g = dy*C + carry (2), the dB term g*dtx and its sum over channels (2),
    the dC term dy*h and its sum (2), s1 += g*B (2), q = g*h*a (2), s2 +=
    q*A (2), dA += q*dt (2), carry = a*g (1); per (step, channel) dt*x,
    dt*s1 and ddt = x*s1 + s2 (4) (and D*dy's add and dD's multiply-add,
    4 more)."""
    nbytes = (b * s * di * (3 * x_bytes + 2 * dt_bytes) + 4 * b * s * ds * 4
              + 2 * di * ds * 4 + (2 * di * 4 if skip else 0)
              + b * di * ds * 4 * ((2 if h0 else 0) + (1 if dh_last else 0)))
    exps = b * s * di * ds
    flops = 19 * exps + b * s * di * (8 if skip else 4)
    return dict(bytes=nbytes, exps=exps, flops=flops)


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
    where = build.device_of("ssm_scan", given)
    b, s, di = x.shape
    ds = A.shape[1]
    if where != "cpu" and (b > 65535 or max(s, di) > 2**31 - 1):
        raise ValueError(f"ssm_scan: shape {tuple(x.shape)} exceeds the "
                         f"kernel's grid")
    Af, Bf, Cf = (t.to(torch.float32).contiguous() for t in (A, B, C))
    Df = None if D is None else D.to(torch.float32).contiguous()
    h0f = None if h0 is None else h0.to(torch.float32).contiguous()
    y = torch.empty_like(x)
    h_last = h_out if h_out is not None else torch.empty(
        (b, di, ds), dtype=torch.float32, device=x.device)
    with build.counted("ssm_scan", lambda: build.work(scan_work(
            b, s, di, ds, x.element_size(), dt.element_size(),
            skip=D is not None, h0=h0 is not None))):
        if where == "cpu":
            got = ssm_scan_plain(x, dt, Af, Bf, Cf, Df, h0f)
            y.copy_(got[0])
            h_last.copy_(got[1])
        elif where == "cuda":
            fn = getattr(build.library("ssm_scan"),
                         f"ssm_scan_{_NAMES[x.dtype]}_{_NAMES[dt.dtype]}")
            stream = torch.cuda.current_stream(x.device).cuda_stream
            build.check(fn(x.data_ptr(), dt.data_ptr(), Af.data_ptr(),
                           Bf.data_ptr(), Cf.data_ptr(),
                           0 if Df is None else Df.data_ptr(),
                           0 if h0f is None else h0f.data_ptr(),
                           y.data_ptr(), h_last.data_ptr(), b, s, di, ds,
                           stream), "ssm_scan")
            build.LAUNCHES["ssm_scan"] += 1
    return y, h_last


def ssm_scan_bwd_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                       B: torch.Tensor, C: torch.Tensor,
                       D: torch.Tensor | None, h0: torch.Tensor | None,
                       dy: torch.Tensor,
                       dh_last: torch.Tensor | None = None):
    """The backward's formulas in plain PyTorch, a float32 loop over time
    (the kernel's twin): the states recomputed forward, then from t = s - 1
    down g_t = dy_t C_t + carry (the carry seeded by dh_last, then a_t g_t),
    with q_t = g_t h_{t-1} a_t: dx_t = dt_t (g_t . B_t) (+ D dy_t), ddt_t =
    x_t (g_t . B_t) + q_t . A, dB_t = sum_c g_t dt_t x_t, dC_t = sum_c dy_t
    h_t, dA = sum q_t dt_t, dD = sum dy_t x_t, dh0 = a_0 g_0.  Returns
    ``(dx, ddt, dA, dB, dC, dD, dh0)``: dx in x's dtype, ddt in dt's, the
    rest float32; dD None without D, dh0 None without h0."""
    _check(x, dt, A, B, C, D, h0, None)
    b, s, di = x.shape
    ds = A.shape[1]
    _check_bwd(x, dy, dh_last, b, di, ds)
    f32 = torch.float32
    xf, dtf, dyf = x.to(f32), dt.to(f32), dy.to(f32)
    Af, Bf, Cf = (t.to(f32) for t in (A, B, C))
    h = torch.zeros((b, di, ds), dtype=f32, device=x.device) \
        if h0 is None else h0.to(f32)
    hs = [h]
    for t in range(s):
        a = torch.exp(dtf[:, t, :, None] * Af[None])
        u = (dtf[:, t] * xf[:, t])[:, :, None] * Bf[:, t, None, :]
        hs.append(a * hs[-1] + u)
    carry = torch.zeros((b, di, ds), dtype=f32, device=x.device) \
        if dh_last is None else dh_last.to(f32)
    dx, ddt = torch.empty_like(xf), torch.empty_like(xf)
    dB, dC = torch.empty_like(Bf), torch.empty_like(Bf)
    dA = torch.zeros_like(Af)
    for t in range(s - 1, -1, -1):
        dtv, xv, dyv = dtf[:, t], xf[:, t], dyf[:, t]
        a = torch.exp(dtv[:, :, None] * Af[None])
        g = dyv[:, :, None] * Cf[:, t, None, :] + carry
        dB[:, t] = torch.einsum("bin,bi->bn", g, dtv * xv)
        dC[:, t] = torch.einsum("bin,bi->bn", hs[t + 1], dyv)
        s1 = torch.einsum("bin,bn->bi", g, Bf[:, t])
        q = g * hs[t] * a
        dA += (q * dtv[:, :, None]).sum(0)
        dx[:, t] = dtv * s1
        ddt[:, t] = xv * s1 + (q * Af[None]).sum(-1)
        carry = a * g
    dD = None
    if D is not None:
        dx += D.to(f32)[None, None] * dyf
        dD = (dyf * xf).sum((0, 1))
    return (dx.to(x.dtype), ddt.to(dt.dtype), dA, dB, dC, dD,
            None if h0 is None else carry)


def _check_bwd(x, dy, dh_last, b, di, ds) -> None:
    if not isinstance(dy, torch.Tensor) or dy.shape != x.shape:
        raise ValueError(f"ssm_scan_bwd: dy must be {tuple(x.shape)}, got "
                         f"{getattr(dy, 'shape', type(dy).__name__)}")
    if dh_last is not None and tuple(dh_last.shape) != (b, di, ds):
        raise ValueError(f"ssm_scan_bwd: dh_last must be {(b, di, ds)}, got "
                         f"{tuple(dh_last.shape)}")


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """The backward kernel's layout for one shape: ``lanes`` threads a
    channel (a key of ``BWD_LAYOUTS``), ``states`` states each."""
    b: int
    s: int
    di: int
    ds: int
    lanes: int

    @property
    def states(self) -> int:
        return BWD_LAYOUTS[self.lanes]

    @property
    def channels(self) -> int:            # channels a CTA
        return BWD_THREADS // self.lanes

    @property
    def ctas(self) -> int:                # CTAs a sequence
        return -(-self.di // self.channels)

    @property
    def blocks(self) -> int:              # blocks of BWD_STEPS steps
        return -(-self.s // BWD_STEPS)

    def workspace_floats(self, skip: bool) -> int:
        """Floats of the kernel's workspace, as ``csrc/ssm_scan_bwd.cu``
        lays it out: the state before each block of each CTA, each CTA's
        dB and dC partials, each sequence's dA (and dD) partials (338 MB
        at falcon-mamba-7b's (4, 1024, 8192, 16): 268 MB of saved states,
        67 MB of dB and dC partials)."""
        return (self.b * self.ctas * self.blocks * BWD_THREADS * self.states
                + self.ctas * 2 * self.b * self.s * self.ds
                + self.b * self.di * self.ds
                + (self.b * self.di if skip else 0))


def bwd_plan(b: int, s: int, di: int, ds: int, sms: int = 132) -> BwdPlan:
    """The layout for ``(b, s, di, ds)`` on a card of ``sms`` SMs: 16
    threads a channel past ds = 16; else eight states a thread (2 lanes, 64
    channels a CTA) when that grid gives every SM ``_BWD_EIGHT_MIN_CTAS``
    CTAs, and four (4 lanes, 32 channels) when it would leave SMs short:
    batch 1 or 2 at falcon-mamba-7b's width, as when a 7B model is
    fine-tuned on one card with a micro-batch of one sequence and gradient
    accumulation.  Measured on an H100 (``tools/kernel_variants.py``):
    0.74-0.75 ms with four against 0.90-0.92 with eight at (1, 2048, 8192,
    16); 1.02-1.07 with eight against 1.25-1.33 with four at (4, 1024,
    8192, 16)."""
    if ds > BWD_SMALL_STATE:
        lanes = 16
    elif b * -(-di // (BWD_THREADS // 2)) >= _BWD_EIGHT_MIN_CTAS * sms:
        lanes = 2
    else:
        lanes = 4
    return BwdPlan(b, s, di, ds, lanes)


def ssm_scan_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor, D: torch.Tensor | None,
                 h0: torch.Tensor | None, dy: torch.Tensor,
                 dh_last: torch.Tensor | None = None):
    """The gradient of ``ssm_scan_bsd(x, dt, A, B, C, D, h0)`` given dy
    (b, s, di) and dh_last (b, di, ds) or None: ``(dx, ddt, dA, dB, dC, dD,
    dh0)`` as ``ssm_scan_bwd_plain`` returns them."""
    _check(x, dt, A, B, C, D, h0, None)
    b, s, di = x.shape
    ds = A.shape[1]
    _check_bwd(x, dy, dh_last, b, di, ds)
    given = [t for t in (x, dt, A, B, C, D, h0, dy, dh_last) if t is not None]
    where = build.device_of("ssm_scan_bwd", given)
    if where != "cpu" and (b > 65535 or max(s, di) > 2**31 - 1):
        raise ValueError(f"ssm_scan_bwd: shape {tuple(x.shape)} exceeds the "
                         f"kernel's grid")
    dev, f32 = x.device, torch.float32
    Af, Bf, Cf = (t.to(f32).contiguous() for t in (A, B, C))
    Df = None if D is None else D.to(f32).contiguous()
    h0f = None if h0 is None else h0.to(f32).contiguous()
    dhf = None if dh_last is None else dh_last.to(f32).contiguous()
    dyx = dy.to(x.dtype).contiguous()
    dx, ddt = torch.empty_like(x), torch.empty_like(dt)
    dA = torch.empty((di, ds), dtype=f32, device=dev)
    dBC = torch.empty((2, b, s, ds), dtype=f32, device=dev)
    dD = None if D is None else torch.empty(di, dtype=f32, device=dev)
    dh0 = None if h0 is None else torch.empty((b, di, ds), dtype=f32,
                                               device=dev)
    if b * s * di == 0:
        for t in (dA, dBC, dD, dh0):
            if t is not None:
                t.zero_()
        if dh0 is not None and dhf is not None and s == 0:
            dh0.copy_(dhf)
        return dx, ddt, dA, dBC[0], dBC[1], dD, dh0

    def make_plan():
        return bwd_plan(b, s, di, ds, build.sms(dev))
    with build.counted("ssm_scan_bwd", lambda: build.work(scan_bwd_work(
            b, s, di, ds, x.element_size(), dt.element_size(),
            skip=D is not None, h0=h0 is not None,
            dh_last=dh_last is not None),
            4 * make_plan().workspace_floats(D is not None))):
        if where == "cpu":
            got = ssm_scan_bwd_plain(x, dt, Af, Bf, Cf, Df, h0f, dy, dhf)
            for out, g in zip((dx, ddt, dA, dBC[0], dBC[1], dD, dh0), got):
                if out is not None:
                    out.copy_(g)
        elif where == "cuda":
            plan = make_plan()
            work = torch.empty(plan.workspace_floats(D is not None),
                               dtype=f32, device=dev)

            def ptr(t):
                return 0 if t is None else t.data_ptr()
            fn = getattr(build.library("ssm_scan_bwd"),
                         f"ssm_scan_bwd_{_NAMES[x.dtype]}_{_NAMES[dt.dtype]}")
            stream = torch.cuda.current_stream(dev).cuda_stream
            build.check(fn(x.data_ptr(), dt.data_ptr(), Af.data_ptr(),
                           Bf.data_ptr(), Cf.data_ptr(), ptr(Df), ptr(h0f),
                           dyx.data_ptr(), ptr(dhf), dx.data_ptr(),
                           ddt.data_ptr(), dA.data_ptr(), dBC.data_ptr(),
                           ptr(dD), ptr(dh0), work.data_ptr(), b, s, di, ds,
                           plan.lanes, stream), "ssm_scan_bwd")
            build.LAUNCHES["ssm_scan_bwd"] += 1
    return dx, ddt, dA, dBC[0], dBC[1], dD, dh0


class SSMScanFn(torch.autograd.Function):
    """The scan whose forward is ``ssm_scan_bsd`` (saving its inputs, no
    state a step) and whose backward is ``ssm_scan_bwd`` (the kernel on the
    card, the plain twin on the CPU, shapes alone on meta); returns ``(y,
    h_last)``."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, D, h0):
        y, h_last = ssm_scan_bsd(x, dt, A, B, C, D, h0)
        ctx.save_for_backward(x, dt, A, B, C, D, h0)
        ctx.set_materialize_grads(False)
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        ins = ctx.saved_tensors
        x = ins[0]
        if dy is None:
            dy = torch.zeros_like(x)
        grads = ssm_scan_bwd(*ins, dy, dh_last)
        return tuple(None if g is None or not need else g.to(t.dtype)
                     for g, t, need in zip(grads, ins,
                                           ctx.needs_input_grad))
