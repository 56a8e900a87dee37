# minoslint: path=chip_smoke.py
"""Known-bad W401 fixture for the port's script on the card: it may import
the legacy seed loops, but never the JAX stack or the reference package —
not even lazily, inside a function."""
from repro_torch.legacy import ema_filter_loop    # fine: chip_smoke.py


def golden(x):
    import jax.numpy as jnp                       # W401
    from repro import legacy                      # W401
    return ema_filter_loop(x), jnp, legacy
