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
the mask keeps), from which a bound on the card's time follows.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

HEAD_DIMS = (32, 64, 128)          # the kernel's instantiations
BLOCK_Q = 128                      # query rows of one bf16 work item
_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16"}


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


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True) -> torch.Tensor:
    """Exact softmax attention with GQA in float32 (``ref.py:8``)."""
    _check(q, k, v, causal)
    b, sq, H, dh = q.shape
    skv, KV = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, KV, H // KV, dh).to(torch.float32)
    s = torch.einsum("bqkpd,bjkd->bkpqj", qg, k.to(torch.float32)) \
        * (dh ** -0.5)
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None]
        kpos = torch.arange(skv, device=q.device)[None, :]
        s = s.masked_fill(~(qpos + (skv - sq) >= kpos), float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkpqj,bjkd->bqkpd", p, v.to(torch.float32))
    return o.reshape(b, sq, H, dh).to(q.dtype)


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True) -> torch.Tensor:
    """q (b, sq, H, dh); k, v (b, skv, KV, dh) -> (b, sq, H, dh)."""
    _check(q, k, v, causal)
    devices = {t.device for t in (q, k, v)}
    if devices == {torch.device("cpu")}:
        return flash_attention_plain(q, k, v, causal)
    if len(devices) != 1 or q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu with q, k, v "
                         f"on one device, not {sorted(map(str, devices))}")
    if q.dtype not in _NAMES:
        raise TypeError(f"flash_attention takes float32 or bfloat16, got "
                        f"{q.dtype}")
    b, sq, H, dh = q.shape
    skv, KV = k.shape[1], k.shape[2]
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {dh}")
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or any(st % vec for st in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} needs dh contiguous, "
                             f"16-byte aligned rows (strides "
                             f"{t.stride()})")
    if max(b, H) > 65535 or b * H * -(-sq // BLOCK_Q) > 2**31 - 1 \
            or skv > 2**31 - 1:
        raise ValueError(f"flash_attention: shape {tuple(q.shape)} / "
                         f"{tuple(k.shape)} exceeds the kernel's grid")
    out = torch.empty((b, sq, H, dh), dtype=q.dtype, device=q.device)
    fn = getattr(build.library("flash_attention"),
                 f"flash_attention_{_NAMES[q.dtype]}")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   b, sq, skv, H, KV, dh, *q.stride()[:3], *k.stride()[:3],
                   *v.stride()[:3], *out.stride()[:3], int(bool(causal)),
                   stream), "flash_attention")
    build.LAUNCHES["flash_attention"] += 1
    return out
