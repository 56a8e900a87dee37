# minoslint: path=src/repro_torch/sched/fixture_float.py
"""Known-bad W501/W502 fixture for the port: exact equality against a
non-integral float literal, and a float32 downcast in a float64 reference
module."""
import torch


def decide(margin, trace):
    if margin == 0.3:                                   # W501
        return None
    return torch.as_tensor(trace, dtype=torch.float32)  # W502
