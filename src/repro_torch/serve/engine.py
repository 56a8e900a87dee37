"""Batched serving engine: prefill once, decode tokens step by step.

The reference's engine holds a ``prefill`` model and a ``decode`` model
that share parameter values and differ only in how they shard them.  On one
card the two layouts name the same tensors, so the port's engine holds one
``LM`` (its parameters live on ``device``) and runs both steps on it.  The
decode caches take the reference's dtypes (k and v bfloat16, padded along
the sequence to ``max_len``; a Mamba layer's state float32 and conv window
bfloat16) and are updated in place.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.common import ONE_DEVICE
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


class ServeEngine:
    def __init__(self, cfg: ModelConfig, max_len: int, device="cuda",
                 dtype: torch.dtype | None = None):
        self.cfg, self.max_len = cfg, max_len
        self.device = resolve_device(device)
        self.model = build_model(cfg, ONE_DEVICE, kind="prefill",
                                 device=self.device, dtype=dtype)
        self.stats = ServeStats()

    def init_params(self, seed: int) -> None:
        """The port's seeded init of every parameter, on the device."""
        self.model.init_params(
            torch.Generator(device=self.device).manual_seed(seed))

    def _pad_caches(self, caches: dict, batch: int) -> dict:
        out = {}
        for name, entry in self.model.cache_shape_structs(
                batch, self.max_len).items():
            out[name] = {}
            for key, (shape, dtype) in entry.items():
                c = caches[name][key]
                buf = torch.zeros(shape, dtype=dtype, device=c.device)
                if key in ("k", "v"):       # (n, b, seq, KV, dh)
                    buf[:, :, :c.shape[2]] = c
                else:                       # Mamba state and conv window
                    buf.copy_(c)
                out[name][key] = buf
        return out

    def generate(self, batch: dict, num_tokens: int, greedy: bool = True,
                 generator: torch.Generator | None = None) -> np.ndarray:
        """batch {"tokens": (b, s)} -> (b, num_tokens) int32 token ids."""
        tokens = batch["tokens"]
        b, s = tokens.shape
        if s + num_tokens > self.max_len:
            raise ValueError("prompt + generation exceeds engine max_len")
        if not greedy and generator is None:
            raise ValueError("sampling (greedy=False) requires a generator; "
                             "pass generator=torch.Generator(...) or use "
                             "greedy=True")
        t0 = time.perf_counter()
        logits, caches = self.model.prefill(batch)
        caches = self._pad_caches(caches, b)
        self.stats.prefill_tokens += b * s
        self.stats.requests += 1
        out = []
        for i in range(num_tokens):
            logits = logits.to(torch.float32)[:, :self.cfg.vocab_size]
            finite = torch.isfinite(logits).all()
            if greedy:
                nxt = torch.argmax(logits, dim=-1)
            else:
                nxt = torch.multinomial(torch.softmax(logits, dim=-1), 1,
                                        generator=generator)[:, 0]
            out.append(nxt.to(torch.int32).cpu().numpy())
            if not bool(finite):
                raise FloatingPointError(f"non-finite logits before token {i}")
            now = time.perf_counter()
            if i == 0:
                self.stats.first_token_s += now - t0
            else:
                self.stats.next_tokens_s += now - t_prev
            t_prev = now
            logits, caches = self.model.decode_step(caches, nxt, s + i)
            self.stats.decode_steps += 1
        return np.stack(out, axis=1)
