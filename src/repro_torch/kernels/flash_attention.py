"""Softmax attention forward in the model's ``(b, s, heads, dh)`` layout.

``flash_attention_bshd(q, k, v, causal)`` takes q ``(b, sq, H, dh)`` and
k, v ``(b, skv, KV, dh)`` (``H`` a multiple of ``KV``: query head ``h``
reads KV head ``h // (H // KV)``) and returns ``(b, sq, H, dh)`` in q's
dtype, through the CUDA kernel ``csrc/flash_attention.cu``: online softmax
in float32, scale ``dh**-0.5``, causal blocks above the diagonal skipped.
The kernel reads the inputs through their strides (dh contiguous), so a
head-interleaved tensor is not copied.  Causal masking is aligned to the
bottom right, as the reference's ``ref.flash_attention_ref``: query ``i``
sees key ``j`` iff ``j <= i + (skv - sq)``; at ``sq == skv`` this is the
Pallas kernel's mask.  ``sq > skv`` with ``causal`` leaves the first rows
without a key and is refused.

``flash_attention_plain`` is the exact-softmax twin of
``ref.flash_attention_ref`` in plain PyTorch.  The wrapper takes it for a
CPU tensor only; for a CUDA tensor it launches the kernel or raises.
``attn_work`` counts the work of one call (the visible (query, key) pairs
the mask keeps), from which a bound on the card's time follows, and
``attn_bwd_work`` that of one backward call.  On ``meta`` tensors both
wrappers allocate what the card path allocates and launch nothing
(``build.device_of``).

The gradient: ``with_lse=True`` also returns each row's log-sum-exp of its
scaled scores (float32 ``(b, H, sq)``, natural log), and
``flash_attention_bwd(q, k, v, o, lse, do, causal)`` returns ``(dq, dk,
dv)`` in q's dtype through ``csrc/flash_attention_bwd.cu``, or for CPU
tensors through ``flash_attention_bwd_plain``, the same formulas in plain
PyTorch.  No atomics: two launches give the same bits.  Both dtypes take
one launch plan (``bwd_plan``): a dK/dV kernel whose CTAs own 128 keys and
are split over a KV head's (query head, query tile) pairs, float32
partials summed in a fixed order.  bfloat16 runs FlashAttention-3's
backward on ``wgmma`` and TMA at every head dim, with a dQ kernel of
128-row CTAs; float32 (the vlm's cross-attention and whisper's encoder and
cross-attention, whose float32 memory promotes them) runs FlashAttention-2's
backward register-tiled on the SIMT FMA pipes, which keep the digits the
float32 card-vs-host checks hold: its dK/dV kernel also writes each key
tile's share of dQ, which a reduction sums in key-tile order, so S and dP
are computed once.
``FlashAttentionFn`` is the ``torch.autograd.Function`` over the two, which
``ops.flash_attention`` takes when a gradient is wanted.  Under grad mode
the bare wrappers refuse a CUDA input that requires grad: a kernel's output
carries no ``grad_fn``, and would cut the graph without an error.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import build

HEAD_DIMS = (32, 64, 128)          # the kernel's instantiations
BLOCK_Q = 128                      # query rows of one bf16 work item
_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16"}
# the backward's tiles: csrc/flash_attention_bwd.cu's kDkdvKeys, kDkdvRows,
# kDqRows, kDqKeys and kRowPad (bf16), kF32Keys, kF32Rows and kF32RowPad
# (float32, whose dK/dV kernel also writes each key tile's dQ partial)
BWD_KEYS = 128                     # keys of a dK/dV CTA
BWD_ROWS = 64                      # query rows of a dK/dV step
BWD_DQ_ROWS = 128                  # query rows of a dQ CTA
BWD_DQ_KEYS = 64                   # keys of a dQ step
BWD_ROW_PAD = 128                  # lse2 and D rows padded to
# a dK/dV grid of fewer CTAs than SMs is split until it holds this many
# CTAs an SM, in at most _MAX_SPLIT parts
_SPLIT_WAVES = 2
_MAX_SPLIT = 8
# float32 (one CTA an SM, each a long run): a grid of fewer CTAs than SMs
# is split for this many CTAs an SM (the causal mask's uneven CTAs balance
# better in smaller parts), and the split is raised until the grid's last
# wave leaves at most _F32_WAVE_SLACK of its waves' CTA slots idle
_F32_SPLIT_WAVES = 4
_F32_WAVE_SLACK = 0.05


def _check(q, k, v, causal: bool) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"flash_attention: {name} must be a "
                            f"torch.Tensor, got {type(t).__name__}")
        if t.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be (b, s, heads,"
                             f" dh), got {tuple(t.shape)}")
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention: q is {q.dtype} but {name} is "
                            f"{t.dtype}")
    b, sq, H, dh = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != dh:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not "
                         f"agree")
    KV = k.shape[2]
    if KV == 0 or H % KV:
        raise ValueError(f"flash_attention: {H} query heads are not a "
                         f"multiple of {KV} KV heads")
    if causal and sq > k.shape[1]:
        raise ValueError(f"causal attention needs sq <= skv (bottom-right "
                         f"alignment), got sq={sq}, skv={k.shape[1]}")


def attn_work(b: int, sq: int, skv: int, H: int, KV: int, dh: int,
              elem: int, causal: bool = True) -> tuple[float, float]:
    """(flops, bytes) of one call: 4*dh flops (two products) per visible
    (query, key) pair and head, with the bottom-right causal mask of
    ``flash_attention_plain``; q, k, v read once and o written once, at
    ``elem`` bytes an element."""
    if causal and sq > skv:
        raise ValueError(f"causal attention needs sq <= skv, got sq={sq}, "
                         f"skv={skv}")
    # row i sees keys j <= i + (skv - sq): skv - sq + i + 1 of them
    pairs = sq * (skv - sq) + sq * (sq + 1) // 2 if causal else sq * skv
    return 4.0 * dh * pairs * b * H, \
        float(elem * (2 * b * sq * H * dh + 2 * b * skv * KV * dh))


def _scores(q, k, causal: bool) -> torch.Tensor:
    """Scaled float32 scores (b, KV, qper, sq, skv), -inf where hidden."""
    b, sq, H, dh = q.shape
    skv, KV = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, KV, H // KV, dh).to(torch.float32)
    s = torch.einsum("bqkpd,bjkd->bkpqj", qg, k.to(torch.float32)) \
        * (dh ** -0.5)
    if causal:
        s = s.masked_fill(~_visible(sq, skv, q.device), float("-inf"))
    return s


def _visible(sq: int, skv: int, device) -> torch.Tensor:
    """(sq, skv) bool: query i sees key j iff j <= i + (skv - sq)."""
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(skv, device=device)[None, :]
    return qpos + (skv - sq) >= kpos


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, with_lse: bool = False):
    """Exact softmax attention with GQA in float32 (``ref.py:8``); with
    ``with_lse`` also the rows' log-sum-exp (b, H, sq)."""
    _check(q, k, v, causal)
    b, sq, H, dh = q.shape
    s = _scores(q, k, causal)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkpqj,bjkd->bqkpd", p, v.to(torch.float32))
    o = o.reshape(b, sq, H, dh).to(q.dtype)
    if not with_lse:
        return o
    return o, torch.logsumexp(s, dim=-1).reshape(b, H, sq)


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              lse: torch.Tensor, do: torch.Tensor,
                              causal: bool = True):
    """The kernel's formulas in plain float32 PyTorch: P = exp(S - lse)
    (0 where hidden), dV = P^T do and dK = dS^T q * scale summed over each
    KV head's group, dS = P (do V^T - rowsum(do o)), dQ = dS K * scale.
    Returns (dq, dk, dv) in q's dtype."""
    _check(q, k, v, causal)
    b, sq, H, dh = q.shape
    KV = k.shape[2]
    scale = dh ** -0.5
    shape5 = (b, sq, KV, H // KV, dh)
    p = torch.exp(_scores(q, k, causal)
                  - lse.reshape(b, KV, H // KV, sq, 1).to(torch.float32))
    gf = do.reshape(shape5).to(torch.float32)
    dsum = (gf * o.reshape(shape5).to(torch.float32)).sum(-1)   # b q k p
    dp = torch.einsum("bqkpd,bjkd->bkpqj", gf, v.to(torch.float32))
    ds = p * (dp - dsum.permute(0, 2, 3, 1)[..., None])
    dv = torch.einsum("bkpqj,bqkpd->bjkd", p, gf)
    dq = torch.einsum("bkpqj,bjkd->bqkpd", ds, k.to(torch.float32)) * scale
    dk = torch.einsum("bkpqj,bqkpd->bjkd", ds,
                      q.reshape(shape5).to(torch.float32)) * scale
    return (dq.reshape(b, sq, H, dh).to(q.dtype), dk.to(q.dtype),
            dv.to(q.dtype))


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """The backward's launch at one shape (``bwd_plan``): the dK/dV
    grid is (key tile, KV head, batch, part) with the key tile slowest, each
    part a run of its key tile's (group head, visible query tile) pairs;
    the dQ grid is (query tile, head, batch) with the head fastest.  Under
    the causal mask both put the heaviest CTAs first."""
    b: int
    sq: int
    skv: int
    H: int
    KV: int
    dh: int
    split: int
    simt: bool = False

    @property
    def sq_pad(self) -> int:
        return _cdiv(self.sq, BWD_ROW_PAD) * BWD_ROW_PAD

    @property
    def key_tiles(self) -> int:
        return _cdiv(self.skv, BWD_KEYS)

    @property
    def dkdv_ctas(self) -> int:
        return self.key_tiles * self.KV * self.b * self.split

    @property
    def dq_ctas(self) -> int:
        return _cdiv(self.sq, BWD_DQ_ROWS) * self.H * self.b

    @property
    def work_floats(self) -> int:
        """float32 scratch: lse2 and D (b, H, sq_pad), then the dK/dV
        parts (split, 2, b, skv, KV, dh) when split > 1, then for the
        float32 kernel each key tile's dQ partial (key tiles, b, H, dh,
        sq_pad)."""
        rows = self.b * self.H * self.sq_pad
        parts = 2 * self.split * self.b * self.skv * self.KV * self.dh
        dq = self.key_tiles * rows * self.dh if self.simt else 0
        return 2 * rows + (parts if self.split > 1 else 0) + dq

    @property
    def scratch_bytes(self) -> int:
        return 4 * self.work_floats

    def visible_query_tiles(self, key_tile: int, causal: bool) -> range:
        """The dK/dV steps (query tiles of BWD_ROWS) with a row that sees a
        key of ``key_tile``."""
        first = max(0, key_tile * BWD_KEYS - (self.skv - self.sq)) \
            // BWD_ROWS if causal else 0
        return range(first, _cdiv(self.sq, BWD_ROWS))

    def dkdv_order(self, causal: bool):
        """The dK/dV CTAs in launch order: (key tile, KV head, batch, part,
        [(head, query tile), ...])."""
        qper = self.H // self.KV
        for i in range(self.dkdv_ctas):
            kt, rest = divmod(i, self.KV * self.b * self.split)
            part, kvh, b = (rest % self.split, rest // self.split % self.KV,
                            rest // (self.split * self.KV))
            tiles = self.visible_query_tiles(kt, causal)
            n = qper * len(tiles)
            lo, hi = n * part // self.split, n * (part + 1) // self.split
            yield kt, kvh, b, part, [
                (kvh * qper + j // len(tiles), tiles[j % len(tiles)])
                for j in range(lo, hi)]

    def dq_order(self, causal: bool):
        """The dQ CTAs in launch order: (query tile, head, batch, key tiles
        of BWD_DQ_KEYS its rows see)."""
        n_qt = _cdiv(self.sq, BWD_DQ_ROWS)
        for i in range(self.dq_ctas):
            qt = (n_qt - 1 - i // (self.H * self.b) if causal
                  else i // (self.H * self.b))
            end = min(self.skv, (qt + 1) * BWD_DQ_ROWS + self.skv - self.sq) \
                if causal else self.skv
            yield qt, i % self.H, i // self.H % self.b, \
                _cdiv(max(end, 0), BWD_DQ_KEYS)


def bwd_plan(b: int, sq: int, skv: int, H: int, KV: int, dh: int,
             sms: int, causal: bool = True, simt: bool = False) -> BwdPlan:
    """The backward's plan on a card of ``sms`` SMs: a dK/dV grid that
    would leave SMs idle is split over each KV head's (query head, query
    tile) pairs into ``split`` parts, enough for ``_SPLIT_WAVES`` CTAs an
    SM, at most ``_MAX_SPLIT`` and no more than the lightest key tile has
    pairs (so that no part is empty).  ``simt`` (the float32 kernels, one
    CTA an SM): ``_F32_SPLIT_WAVES`` CTAs an SM instead, and the split is
    then raised, within the same limits, until the last wave of CTAs
    leaves at most ``_F32_WAVE_SLACK`` of the waves' slots idle (at the
    vlm's cross shape 416 CTAs fill 3.15 waves of 132 and leave the fourth
    85 % idle; 4 parts fill 12.6 of 13)."""
    plan = BwdPlan(b, sq, skv, H, KV, dh, 1, simt)
    base = plan.dkdv_ctas
    if base == 0:
        return plan
    lightest = H // KV * len(plan.visible_query_tiles(plan.key_tiles - 1,
                                                      causal))
    cap = max(min(_MAX_SPLIT, lightest), 1)
    waves = _F32_SPLIT_WAVES if simt else _SPLIT_WAVES
    split = 1 if base >= sms else min(_cdiv(waves * sms, base), cap)
    if simt:
        while split < cap and base * split / sms / _cdiv(
                base * split, sms) < 1.0 - _F32_WAVE_SLACK:
            split += 1
    return dataclasses.replace(plan, split=max(split, 1), simt=simt)


def attn_bwd_work(b: int, sq: int, skv: int, H: int, KV: int, dh: int,
                  elem: int, causal: bool = True) -> tuple[float, float]:
    """(flops, bytes) of one backward call: 10*dh flops (five products: q
    k^T, do v^T, dV, dK, dQ) a visible pair and head, 2.5 times
    ``attn_work``'s; q, k, v, o and do read and dq, dk, dv written (twice
    ``attn_work``'s bytes), and the float32 lse read."""
    flops, nbytes = attn_work(b, sq, skv, H, KV, dh, elem, causal)
    return flops * 2.5, nbytes * 2 + b * H * sq * 4


def _work(fn, q, k, causal: bool, scratch: int = 0) -> build.Work:
    """``build.Work`` of ``fn`` (``attn_work`` or ``attn_bwd_work``) at q
    and k's shapes: on the tensor cores in bfloat16, else on the float32
    pipes."""
    b, sq, H, dh = q.shape
    flops, nbytes = fn(b, sq, k.shape[1], H, k.shape[2], dh,
                       q.element_size(), causal)
    return build.Work(flops, nbytes, tensor_flops=flops
                      if q.dtype == torch.bfloat16 else 0.0,
                      scratch=scratch)


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, with_lse: bool = False):
    """q (b, sq, H, dh); k, v (b, skv, KV, dh) -> (b, sq, H, dh), and with
    ``with_lse`` the rows' log-sum-exp (b, H, sq) float32."""
    _check(q, k, v, causal)
    where = build.device_of("flash_attention", (q, k, v))
    b, sq, H, dh = q.shape
    skv, KV = k.shape[1], k.shape[2]
    if where != "cpu":
        if q.dtype not in _NAMES:
            raise TypeError(f"flash_attention takes float32 or bfloat16, "
                            f"got {q.dtype}")
        if dh not in HEAD_DIMS:
            raise ValueError(f"flash_attention kernel takes head_dim in "
                             f"{HEAD_DIMS}, got {dh}")
        vec = 16 // q.element_size()
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.stride(3) != 1 or any(st % vec for st in t.stride()[:3]) \
                    or t.data_ptr() % 16:
                raise ValueError(f"flash_attention: {name} needs dh "
                                 f"contiguous, 16-byte aligned rows "
                                 f"(strides {t.stride()})")
        if max(b, H) > 65535 or b * H * -(-sq // BLOCK_Q) > 2**31 - 1 \
                or skv > 2**31 - 1:
            raise ValueError(f"flash_attention: shape {tuple(q.shape)} / "
                             f"{tuple(k.shape)} exceeds the kernel's grid")
    out = torch.empty((b, sq, H, dh), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, H, sq), dtype=torch.float32, device=q.device) \
        if with_lse else None
    with build.counted("flash_attention",
                       lambda: _work(attn_work, q, k, causal)):
        if where == "cpu":
            got = flash_attention_plain(q, k, v, causal, with_lse)
            if with_lse:
                out.copy_(got[0])
                lse.copy_(got[1])
            else:
                out.copy_(got)
        elif where == "cuda":
            fn = getattr(build.library("flash_attention"),
                         f"flash_attention_{_NAMES[q.dtype]}")
            stream = torch.cuda.current_stream(q.device).cuda_stream
            build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           out.data_ptr(),
                           0 if lse is None else lse.data_ptr(), b, sq, skv,
                           H, KV, dh, *q.stride()[:3], *k.stride()[:3],
                           *v.stride()[:3], *out.stride()[:3],
                           int(bool(causal)), stream), "flash_attention")
            build.LAUNCHES["flash_attention"] += 1
    return (out, lse) if with_lse else out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        causal: bool = True):
    """(dq, dk, dv) of ``flash_attention_bshd`` at (q, k, v) given its
    output o, its lse and the output's gradient do; q's dtype.  On the card
    bfloat16 takes the wgmma kernels, float32 the SIMT ones, both with
    ``bwd_plan``'s split and its float32 scratch (lse2, D and the dK/dV
    parts)."""
    _check(q, k, v, causal)
    b, sq, H, dh = q.shape
    skv, KV = k.shape[1], k.shape[2]
    if o.shape != q.shape or do.shape != q.shape or \
            lse.shape != (b, H, sq):
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)}, do "
                         f"{tuple(do.shape)}, lse {tuple(lse.shape)} do not "
                         f"match q {tuple(q.shape)}")
    where = build.device_of("flash_attention_bwd", (q, k, v, o, lse, do))
    if where != "cpu":
        if q.dtype not in _NAMES or o.dtype != q.dtype \
                or do.dtype != q.dtype or lse.dtype != torch.float32:
            raise TypeError(f"flash_attention_bwd takes float32 or bfloat16"
                            f" q, o, do and a float32 lse, got {q.dtype}, "
                            f"{o.dtype}, {do.dtype}, {lse.dtype}")
        if dh not in HEAD_DIMS:
            raise ValueError(f"flash_attention_bwd takes head_dim in "
                             f"{HEAD_DIMS}, got {dh}")
        if max(b, H, KV) > 65535:
            raise ValueError(f"flash_attention_bwd: shape {tuple(q.shape)} "
                             f"/ {tuple(k.shape)} exceeds the kernel's grid")
    q, k, v, o, lse, do = (t.contiguous() for t in (q, k, v, o, lse, do))
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)):
        if where == "cuda" and t.data_ptr() % 16:
            raise ValueError(f"flash_attention_bwd: {name} is not 16-byte "
                             f"aligned")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))

    def make_plan():
        return bwd_plan(b, sq, skv, H, KV, dh, build.sms(q.device), causal,
                        simt=q.dtype != torch.bfloat16)
    with build.counted("flash_attention_bwd", lambda: _work(
            attn_bwd_work, q, k, causal, make_plan().scratch_bytes)):
        if where == "cpu":
            for out, got in zip((dq, dk, dv), flash_attention_bwd_plain(
                    q, k, v, o, lse, do, causal)):
                out.copy_(got)
        elif where == "cuda":
            plan = make_plan()
            work = torch.empty(plan.work_floats, dtype=torch.float32,
                               device=q.device)
            fn = getattr(build.library("flash_attention_bwd"),
                         f"flash_attention_bwd_{_NAMES[q.dtype]}")
            stream = torch.cuda.current_stream(q.device).cuda_stream
            build.check(fn(*(t.data_ptr() for t in (q, k, v, o, lse, do, dq,
                                                    dk, dv, work)),
                           b, sq, skv, H, KV, dh, int(bool(causal)),
                           plan.split, stream), "flash_attention_bwd")
            build.LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """Attention whose forward saves (q, k, v, o, lse) and whose backward
    is ``flash_attention_bwd`` (the kernel on the card, the plain twin on
    the CPU, shapes alone on meta)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        o, lse = flash_attention_bshd(q, k, v, causal, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, ctx.causal)
        return dq, dk, dv, None
