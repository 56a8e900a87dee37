"""Config dataclasses for models, shapes, meshes and runs.

Every assigned architecture is expressed as a ``ModelConfig``; the four
assigned input shapes are ``ShapeConfig``s.  Configs are plain frozen
dataclasses so they can be hashed, diffed and serialized into experiment
records.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters (exact per the assignment block)."""

    name: str
    family: str  # dense | ssm | hybrid | moe | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128

    # --- attention flavor ---
    qkv_bias: bool = False
    attn_out_bias: bool = False
    rope_theta: float = 10_000.0
    use_mla: bool = False
    kv_lora_rank: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0      # MLA value head dim (defaults to head_dim)
    qk_nope_dim: int = 0     # MLA non-rope q/k head dim (defaults to head_dim)

    # --- MoE ---
    moe_num_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    moe_num_shared: int = 0
    moe_layer_period: int = 1     # MoE on layers where (layer % period == period-1)
    moe_group_size: int = 256     # dispatch group size (tokens)
    capacity_factor: float = 1.25

    # --- SSM (mamba1) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0          # 0 -> ceil(d_model/16)
    # "sequential" (O(state) HBM traffic; §Perf F1) | "associative" (baseline)
    ssm_scan_impl: str = "sequential"

    # --- hybrid (jamba): one attention layer per `attn_period` layers ---
    attn_period: int = 0

    # --- VLM: one cross-attention layer per `cross_attn_period` layers ---
    cross_attn_period: int = 0
    num_image_tokens: int = 0

    # --- encoder-decoder (whisper backbone) ---
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0

    # --- misc ---
    layers_per_period: int = 0       # 0 -> family default; >1 stacks several
                                     # layers per scan period (halves the
                                     # seq-resharding boundaries; §Perf C4)
    mlp_activation: str = "swiglu"   # swiglu | gelu
    norm_type: str = "rmsnorm"       # rmsnorm | layernorm
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    remat: bool = True
    # Notes from the assignment (provenance, applicability).
    source: str = ""

    # ------------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up so embedding/logits shard evenly (multiple of 256)."""
        return _round_up(self.vocab_size, 256)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        if self.ssm_dt_rank:
            return self.ssm_dt_rank
        return -(-self.d_model // 16)

    @property
    def mla_qk_nope(self) -> int:
        return self.qk_nope_dim or self.head_dim

    @property
    def mla_v_dim(self) -> int:
        return self.v_head_dim or self.head_dim

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    def is_moe_layer(self, layer_idx: int) -> bool:
        if self.moe_num_experts == 0:
            return False
        p = self.moe_layer_period
        return (layer_idx % p) == (p - 1)

    def is_attn_layer(self, layer_idx: int) -> bool:
        """For hybrid stacks: which layers are attention (vs mamba)."""
        if self.family != "hybrid":
            return self.family != "ssm"
        return (layer_idx % self.attn_period) == (self.attn_period - 1)

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Total parameter count (dense accounting, experts included)."""
        return _param_count(self)

    def active_param_count(self) -> int:
        """Per-token active parameters (MoE: shared + top_k routed)."""
        return _param_count(self, active_only=True)

    def reduced(self, **overrides: Any) -> "ModelConfig":
        """A small config of the same family for CPU smoke tests."""
        small: dict[str, Any] = dict(
            num_layers=max(2, min(4, self.num_layers)),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads else 0,
            head_dim=32,
            d_ff=256 if self.d_ff else 0,
            vocab_size=512,
        )
        if self.use_mla:
            small.update(kv_lora_rank=32, qk_rope_dim=16, qk_nope_dim=32,
                         v_head_dim=32, num_kv_heads=4)
        if self.moe_num_experts:
            small.update(moe_num_experts=4, moe_top_k=min(2, self.moe_top_k),
                         moe_d_ff=64, moe_group_size=16,
                         moe_num_shared=min(1, self.moe_num_shared))
        if self.family in ("ssm", "hybrid"):
            small.update(ssm_state=8, ssm_dt_rank=8)
        if self.family == "hybrid":
            small.update(attn_period=2, num_layers=4, moe_layer_period=2)
        if self.family == "vlm":
            small.update(cross_attn_period=2, num_image_tokens=8, num_layers=4)
        if self.is_encoder_decoder:
            small.update(num_encoder_layers=2)
        small.update(overrides)
        return dataclasses.replace(self, **small)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)


def _param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    d = cfg.d_model
    n = 0
    # embeddings (+ untied logits head)
    n += cfg.padded_vocab * d
    if not cfg.tie_embeddings:
        n += cfg.padded_vocab * d

    def attn_params() -> int:
        if cfg.use_mla:
            q = d * cfg.num_heads * (cfg.mla_qk_nope + cfg.qk_rope_dim)
            kv_a = d * (cfg.kv_lora_rank + cfg.qk_rope_dim)
            kv_b = cfg.kv_lora_rank * cfg.num_heads * (cfg.mla_qk_nope + cfg.mla_v_dim)
            o = cfg.num_heads * cfg.mla_v_dim * d
            return q + kv_a + kv_b + o
        q = d * cfg.num_heads * cfg.head_dim
        kv = 2 * d * cfg.num_kv_heads * cfg.head_dim
        o = cfg.num_heads * cfg.head_dim * d
        b = (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim if cfg.qkv_bias else 0
        return q + kv + o + b

    def mlp_params(ff: int) -> int:
        mult = 3 if cfg.mlp_activation == "swiglu" else 2
        return mult * d * ff

    def mamba_params() -> int:
        di, ds, dr = cfg.d_inner, cfg.ssm_state, cfg.dt_rank
        return (d * 2 * di          # in_proj
                + di * cfg.ssm_conv  # conv
                + di * (dr + 2 * ds)  # x_proj
                + dr * di + di       # dt_proj
                + di * ds + di       # A_log, D
                + di * d)            # out_proj

    def moe_params() -> int:
        routed = cfg.moe_num_experts * mlp_params(cfg.moe_d_ff)
        if active_only:
            routed = cfg.moe_top_k * mlp_params(cfg.moe_d_ff)
        shared = cfg.moe_num_shared * mlp_params(cfg.moe_d_ff)
        router = d * cfg.moe_num_experts
        return routed + shared + router

    layers = range(cfg.num_layers)
    for i in layers:
        n += 2 * d  # norms
        if cfg.family == "ssm":
            n += mamba_params()
            continue
        if cfg.family == "hybrid" and not cfg.is_attn_layer(i):
            n += mamba_params()
        else:
            n += attn_params()
        if cfg.family == "vlm" and cfg.cross_attn_period and \
                (i % cfg.cross_attn_period) == (cfg.cross_attn_period - 1):
            n += attn_params()  # cross-attention block
        if cfg.is_moe_layer(i):
            n += moe_params()
        elif cfg.d_ff:
            n += mlp_params(cfg.d_ff)
    if cfg.is_encoder_decoder:
        for _ in range(cfg.num_encoder_layers):
            n += 2 * d + attn_params() + mlp_params(cfg.d_ff)
        # decoder cross-attention blocks
        n += cfg.num_layers * (attn_params() + d)
    return n


@dataclass(frozen=True)
class ShapeConfig:
    """An assigned input shape: (seq_len, global_batch, step kind)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


@dataclass(frozen=True)
class MeshConfig:
    shape: tuple[int, ...]
    axis_names: tuple[str, ...]

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def batch_axes(self) -> tuple[str, ...]:
        return tuple(a for a in self.axis_names if a in ("pod", "data"))

    @property
    def model_axis_size(self) -> int:
        return self.shape[self.axis_names.index("model")]

    @property
    def data_axis_size(self) -> int:
        n = 1
        for a, s in zip(self.axis_names, self.shape):
            if a in ("pod", "data"):
                n *= s
        return n


SINGLE_POD = MeshConfig(shape=(16, 16), axis_names=("data", "model"))
MULTI_POD = MeshConfig(shape=(2, 16, 16), axis_names=("pod", "data", "model"))
SMOKE_MESH = MeshConfig(shape=(1, 1), axis_names=("data", "model"))


@dataclass(frozen=True)
class RunConfig:
    """Training-run hyperparameters."""

    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 1000
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    microbatches: int = 1          # gradient accumulation
    moment_dtype: str = "float32"  # "bfloat16" halves optimizer memory
    seed: int = 0
    checkpoint_every: int = 100
    checkpoint_dir: str = "/tmp/repro_ckpt"
    telemetry_sample_ms: float = 1.0
