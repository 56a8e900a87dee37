"""deepseek-v2-236b [moe]: 60L d_model=5120 128H d_ff=1536 vocab=102400,
MLA kv_lora=512 (+64 rope dims), MoE: 2 shared + 160 routed experts, top-6.
[arXiv:2405.04434; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,       # MLA decompresses to full heads
    head_dim=128,
    d_ff=1536,
    vocab_size=102400,
    use_mla=True,
    kv_lora_rank=512,
    qk_rope_dim=64,
    qk_nope_dim=128,
    v_head_dim=128,
    moe_num_experts=160,
    moe_top_k=6,
    moe_d_ff=1536,
    moe_num_shared=2,
    moe_layer_period=1,     # every layer MoE
    rope_theta=10_000.0,
    source="arXiv:2405.04434; hf",
)
