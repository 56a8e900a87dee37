"""falcon-mamba-7b [ssm]: 64L d_model=4096 (attn-free) vocab=65024, ssm_state=16.

Mamba-1 architecture (selective SSM), no attention, no MLP (d_ff=0):
each layer is a Mamba block with d_inner = 2*d_model.
[arXiv:2410.05355; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    num_layers=64,
    d_model=4096,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=65024,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    norm_type="rmsnorm",
    source="arXiv:2410.05355 (mamba1 arch); unverified",
)
