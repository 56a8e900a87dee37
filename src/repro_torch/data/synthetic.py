"""Deterministic synthetic data pipeline.

Two sources:
  * ``SyntheticTokens`` — iid zipf-ish token streams, deterministic per
    (seed, step, host_shard) so multi-host runs produce disjoint shards and
    restarts resume exactly (step-indexed, no hidden iterator state).
  * ``ByteCorpus`` — next-byte prediction over a repeating text corpus, used
    by examples so training loss visibly decreases.

Both yield {"tokens": (b, s) int32, "labels": (b, s) int32} plus optional
modality stubs (image_embeds / frames) for vlm/audio archs, as numpy
arrays: the same bits as the reference's pipeline for the same seed and
step (the trainer moves them to its device).
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig


class SyntheticTokens:
    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, seed: int = 0,
                 host_index: int = 0, host_count: int = 1):
        if shape.global_batch % host_count:
            raise ValueError("global batch must divide host count")
        self.cfg, self.shape = cfg, shape
        self.seed, self.host_index, self.host_count = seed, host_index, host_count
        self.local_batch = shape.global_batch // host_count

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 4099 + self.host_index)
        b, s, v = self.local_batch, self.shape.seq_len, self.cfg.vocab_size
        # zipf-flavored marginal: realistic token frequency skew
        u = rng.random((b, s + 1))
        toks = np.minimum((v * u ** 3).astype(np.int64), v - 1).astype(np.int32)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        self._add_modalities(out, rng, b, s)
        return out

    def _add_modalities(self, out: dict, rng, b: int, s: int) -> None:
        cfg = self.cfg
        if cfg.family == "vlm":
            out["image_embeds"] = (rng.standard_normal(
                (b, cfg.num_image_tokens, cfg.d_model)) * 0.02).astype(np.float32)
        if cfg.family == "audio":
            out["frames"] = (rng.standard_normal(
                (b, s, cfg.d_model)) * 0.02).astype(np.float32)

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


_DEFAULT_TEXT = (
    "minos judges every workload that enters the cluster. the power spikes "
    "are binned by magnitude and the spikes vector is clustered with cosine "
    "distance. compute bound workloads shift left under frequency caps while "
    "memory bound workloads barely move. "
) * 64


class ByteCorpus:
    """Next-byte LM over a repeating corpus; vocab is bytes (<=256)."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, seed: int = 0,
                 text: str = _DEFAULT_TEXT):
        self.cfg, self.shape, self.seed = cfg, shape, seed
        data = np.frombuffer(text.encode(), np.uint8).astype(np.int32)
        self.data = data % cfg.vocab_size
        self.shape_cfg = shape

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng(self.seed * 7919 + step)
        b, s = self.shape.global_batch, self.shape.seq_len
        starts = rng.integers(0, len(self.data) - s - 1, size=b)
        toks = np.stack([self.data[st:st + s + 1] for st in starts])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
