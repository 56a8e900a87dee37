"""phi3-medium-14b [dense]: 40L d_model=5120 40H (GQA kv=10) d_ff=17920 vocab=100352.

RoPE SwiGLU GQA. 40 heads are not divisible by the 16-way model axis, so
this arch uses sequence-sharded attention (see DESIGN.md sharding table).
[arXiv:2404.14219; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=10,
    head_dim=128,
    d_ff=17920,
    vocab_size=100352,
    qkv_bias=False,
    rope_theta=10_000.0,
    source="arXiv:2404.14219; unverified",
)
