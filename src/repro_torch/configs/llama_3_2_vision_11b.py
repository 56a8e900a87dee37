"""llama-3.2-vision-11b [vlm]: 40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256.

Cross-attention image layers every 5th layer; the vision frontend is a STUB
(``input_specs()`` provides precomputed patch embeddings already projected to
d_model). [hf:meta-llama/Llama-3.2-11B-Vision; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    qkv_bias=False,
    rope_theta=500_000.0,
    cross_attn_period=5,
    num_image_tokens=1600,
    source="hf:meta-llama/Llama-3.2-11B-Vision; unverified",
)
