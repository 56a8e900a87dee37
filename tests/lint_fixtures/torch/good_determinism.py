# minoslint: path=src/repro_torch/kernels/fixture_determinism.py
"""Known-good twin of ``bad_determinism.py``: timestamps flow in as
parameters, RNG is explicitly seeded, set output is sorted, and keys are
stable identities."""
import numpy as np
import torch


def stamp(profiles, started: float, seed: int):
    rng = np.random.default_rng(seed)
    jitter = rng.random(len(profiles))
    names = sorted({p.name for p in profiles})
    order = {}
    for i, p in enumerate(profiles):
        order[p.name] = i
    return started, torch.as_tensor(jitter), names, order
