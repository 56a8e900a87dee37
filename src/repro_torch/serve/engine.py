"""Batched serving engine: prefill once, decode tokens step by step.

As the reference's, the engine holds a ``prefill`` model and a ``decode``
model that share parameter values and differ in how they lay them out.  On
one card (``ONE_DEVICE``) the two layouts name the same tensors, so they
are one model (``model`` and ``decode_model`` are the same object).  On a
rank of a (1, tp) mesh (``topo`` and that rank's ``group``) each holds its
rank's blocks: Megatron with a sequence-sharded residual for prefill,
row-parallel for decode; where the two pspecs give the same block (every
MLP, Mamba and embedding weight, every norm, a MoE block's router and
shared experts, and its experts where both placements cut d_ff), the
decode model shares the prefill model's tensor; where they differ (``ep``
experts against ``ep_decode``'s d_ff columns), it holds its own.  Every
rank runs ``generate`` with the same batch; the logits are whole on every
rank, so greedy ids agree, and a sampled id is drawn on rank 0 and
broadcast.

The decode caches take the reference's dtypes (k and v, an MLA layer's
latent and rope key: bfloat16, padded along the sequence to ``max_len``; a
Mamba layer's state float32 and conv window bfloat16) and are updated in
place; on a rank, a cache that tp divides holds the rank's run of the
``max_len`` positions (``_pad_caches`` lays the prefill's whole caches out
so), and a Mamba layer's state and conv window hold the rank's channels,
whole along their own sequence.  A cross-attention cache (the vlm's over
its ``num_image_tokens``, the enc-dec's over ``memory_len =
frames.shape[1]``) is cast, never padded: a zero key past the memory
would be attended to at decode.  On a rank it holds its run of the memory
positions where tp divides the memory's length, else all of them (the
reference's fallback to replication), whatever ``max_len`` does.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.common import ONE_DEVICE, Topo
from repro_torch.models.convert import rank_state_dict
from repro_torch.models.model_zoo import build_model


@dataclass
class ServeStats:
    prefill_tokens: int = 0
    decode_steps: int = 0
    requests: int = 0
    # host clock, each interval ending when a token reaches the host (which
    # waits for the device): prompt to first token, and first to last token
    first_token_s: float = 0.0
    next_tokens_s: float = 0.0
    # the last request's intervals between consecutive tokens, one a step
    step_s: list = field(default_factory=list)


class ServeEngine:
    def __init__(self, cfg: ModelConfig, max_len: int, device="cuda",
                 dtype: torch.dtype | None = None, topo: Topo = ONE_DEVICE,
                 group=None):
        self.cfg, self.max_len = cfg, max_len
        self.device = resolve_device(device)
        self.model = build_model(cfg, topo, kind="prefill",
                                 device=self.device, dtype=dtype,
                                 group=group)
        self.group = getattr(self.model, "group", None)
        if self.group is None:
            self.decode_model = self.model
        else:
            self.decode_model = build_model(cfg, topo, kind="decode",
                                            device="meta", dtype=dtype,
                                            group=group)
            _share_blocks(self.decode_model, self.model, self.device)
        self.stats = ServeStats()

    def init_params(self, seed: int) -> None:
        """The port's seeded init of every parameter, on the device; on a
        rank, its blocks of the tensors one device draws."""
        self.model.init_params(
            torch.Generator(device=self.device).manual_seed(seed),
            None if self.decode_model is self.model else self.decode_model)

    def load_params(self, full: dict) -> None:
        """Whole parameters (the reference's tree or a port state dict)
        into both models, on a rank as its blocks."""
        for m in {id(m): m for m in (self.model, self.decode_model)}.values():
            m.load_state_dict(rank_state_dict(full, m))

    def _pad_caches(self, caches: dict, batch: int,
                    memory_len: int | None = None) -> dict:
        if self.cfg.is_encoder_decoder:
            structs = self.decode_model.cache_shape_structs(
                batch, self.max_len, memory_len=memory_len)
        else:
            structs = self.decode_model.cache_shape_structs(batch,
                                                            self.max_len)
        out = {}
        for name, entry in structs.items():
            out[name] = {}
            for key, (shape, dtype) in entry.items():
                c = caches[name][key]
                if key in ("k", "v", "ckv", "krope"):   # (n, b, seq, ...)
                    # the rank's run of the positions, of the memory's for
                    # a cross cache
                    lo = self.decode_model.cache_start(shape[2]) \
                        if self.group is not None else None
                    if lo is not None:
                        shape = (*shape[:2], shape[2] // self.group.size,
                                 *shape[3:])
                        c = c[:, :, lo:lo + shape[2]]
                    buf = torch.zeros(shape, dtype=dtype, device=c.device)
                    buf[:, :, :c.shape[2]] = c  # a cross cache: all of it
                else:     # Mamba state and conv window (a rank's channels)
                    buf = c.to(dtype, copy=True)
                out[name][key] = buf
        return out

    def generate(self, batch: dict, num_tokens: int, greedy: bool = True,
                 generator: torch.Generator | None = None) -> np.ndarray:
        """batch {"tokens": (b, s)[, "image_embeds" (vlm) or "frames"
        (enc-dec)]} -> (b, num_tokens) int32 token ids."""
        tokens = batch["tokens"]
        b, s = tokens.shape
        if s + num_tokens > self.max_len:
            raise ValueError("prompt + generation exceeds engine max_len")
        draws = self.group is None or self.group.rank == 0
        if not greedy and draws and generator is None:
            raise ValueError("sampling (greedy=False) requires a generator; "
                             "pass generator=torch.Generator(...) or use "
                             "greedy=True")
        mem_len = batch["frames"].shape[1] if "frames" in batch else None
        step_kw = {} if self.group is None else {"cache_len": self.max_len}
        if self.group is not None and mem_len is not None:
            step_kw["memory_len"] = mem_len
        t0 = time.perf_counter()
        logits, caches = self.model.prefill(batch)
        caches = self._pad_caches(caches, b, memory_len=mem_len)
        self.stats.prefill_tokens += b * s
        self.stats.requests += 1
        out = []
        for i in range(num_tokens):
            logits = logits.to(torch.float32)[:, :self.cfg.vocab_size]
            finite = torch.isfinite(logits).all()
            if greedy:
                nxt = torch.argmax(logits, dim=-1)
            elif draws:
                nxt = torch.multinomial(torch.softmax(logits, dim=-1), 1,
                                        generator=generator)[:, 0]
            else:
                nxt = torch.empty(b, dtype=torch.int64, device=logits.device)
            if not greedy and self.group is not None:
                nxt = self.group.broadcast(nxt, 0)
            out.append(nxt.to(torch.int32).cpu().numpy())
            if not bool(finite):
                raise FloatingPointError(f"non-finite logits before token {i}")
            now = time.perf_counter()
            if i == 0:
                self.stats.first_token_s += now - t0
                self.stats.step_s = []
            else:
                self.stats.next_tokens_s += now - t_prev
                self.stats.step_s.append(now - t_prev)
            t_prev = now
            logits, caches = self.decode_model.decode_step(caches, nxt, s + i,
                                                           **step_kw)
            self.stats.decode_steps += 1
        return np.stack(out, axis=1)


def _share_blocks(decode, prefill, device: torch.device) -> None:
    """Give ``decode`` (built on meta) its parameters: ``prefill``'s tensor
    where the two layouts give the rank the same block, else a new one of
    its block's shape on ``device``."""
    shared = dict(prefill.named_parameters())
    blocks = prefill.blocks()
    for name, index in decode.blocks().items():
        mod_name, _, leaf = name.rpartition(".")
        owner = decode.get_submodule(mod_name)
        meta = getattr(owner, leaf)
        owner.register_parameter(leaf, shared[name] if index == blocks[name]
                                 else torch.nn.Parameter(torch.empty(
                                     meta.shape, dtype=meta.dtype,
                                     device=device), requires_grad=False))
