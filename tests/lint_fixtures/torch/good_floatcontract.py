# minoslint: path=src/repro_torch/sched/fixture_float.py
"""Known-good twin of ``bad_floatcontract.py``: tolerance-based
comparison, reference math stays in float64 (integral-valued literals
compare exactly and are allowed)."""
import math

import torch


def decide(margin, trace):
    if math.isclose(margin, 0.3, rel_tol=1e-9) or margin == 0.0:
        return None
    return torch.as_tensor(trace, dtype=torch.float64)
