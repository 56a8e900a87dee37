"""The four assigned input shapes (seq_len x global_batch).

``decode_*`` / ``long_*`` lower ``serve_step`` (one new token against a KV
cache of ``seq_len``), not ``train_step``.  ``long_500k`` requires
sub-quadratic attention and is only lowered for SSM/hybrid families (see
DESIGN.md and the dry-run skip table).
"""
from repro_torch.configs.base import ShapeConfig

TRAIN_4K = ShapeConfig(name="train_4k", seq_len=4_096, global_batch=256, kind="train")
PREFILL_32K = ShapeConfig(name="prefill_32k", seq_len=32_768, global_batch=32, kind="prefill")
DECODE_32K = ShapeConfig(name="decode_32k", seq_len=32_768, global_batch=128, kind="decode")
LONG_500K = ShapeConfig(name="long_500k", seq_len=524_288, global_batch=1, kind="decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES = {s.name: s for s in ALL_SHAPES}

# Families for which long_500k decode is runnable (sub-quadratic / O(1)-state).
LONG_CONTEXT_FAMILIES = ("ssm", "hybrid")


def shape_applicable(family: str, shape: ShapeConfig) -> tuple[bool, str]:
    """(applicable, reason-if-not) for an (arch family x shape) cell."""
    if shape.name == "long_500k" and family not in LONG_CONTEXT_FAMILIES:
        return False, ("long_500k needs sub-quadratic attention; this arch is "
                       "pure full-attention (skip per assignment spec)")
    return True, ""
