# minoslint: path=chip_smoke.py
"""Known-good twin of ``bad_foreign.py``: the port's own copy of the seed
loops, and torch."""
from repro_torch.legacy import ema_filter_loop


def golden(x):
    import torch
    return ema_filter_loop(x), torch
