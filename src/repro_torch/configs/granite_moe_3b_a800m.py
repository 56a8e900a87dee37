"""granite-moe-3b-a800m [moe]: 32L d_model=1536 24H (GQA kv=8) d_ff=512,
vocab=49155, MoE 40e top-8. 40 experts are not divisible by the 16-way model
axis -> expert weights use tensor parallelism over d_ff instead of expert
parallelism; 24 heads -> sequence-sharded attention (DESIGN.md).
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    moe_num_experts=40,
    moe_top_k=8,
    moe_d_ff=512,
    moe_layer_period=1,
    moe_group_size=128,
    rope_theta=10_000.0,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf",
)
