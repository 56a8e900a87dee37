"""glm4-9b [dense]: 40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552.

RoPE, GQA with 2 KV heads, QKV bias (GLM convention), SwiGLU MLP.
[hf:THUDM/glm-4-9b; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b",
    family="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=151552,
    qkv_bias=True,
    rope_theta=10_000.0,
    source="hf:THUDM/glm-4-9b; hf",
)
