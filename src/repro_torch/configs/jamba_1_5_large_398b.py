"""jamba-1.5-large-398b [hybrid]: 72L d_model=8192 64H (GQA kv=8) d_ff=24576
vocab=65536, MoE 16e top-2. Mamba+attention 1:7 interleave (one attention layer
per 8), MoE on alternating layers. [arXiv:2403.19887; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    attn_period=8,          # layers 7, 15, ... are attention; rest mamba
    moe_num_experts=16,
    moe_top_k=2,
    moe_d_ff=24576,
    moe_layer_period=2,     # MoE on every other layer
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    rope_theta=10_000.0,
    source="arXiv:2403.19887; hf",
)
