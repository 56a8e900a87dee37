"""whisper-medium [audio]: 24L d_model=1024 16H (kv=16) d_ff=4096 vocab=51865.

Encoder-decoder backbone; the conv/mel frontend is a STUB — ``input_specs()``
provides precomputed frame embeddings (batch, frames, d_model).
[arXiv:2212.04356; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    num_layers=24,              # decoder layers
    num_encoder_layers=24,
    is_encoder_decoder=True,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51865,
    mlp_activation="gelu",
    norm_type="layernorm",
    qkv_bias=True,
    attn_out_bias=True,
    source="arXiv:2212.04356; unverified",
)
