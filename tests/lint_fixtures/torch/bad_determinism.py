# minoslint: path=src/repro_torch/kernels/fixture_determinism.py
"""Known-bad W301-W304 fixture for the port: every classic determinism leak
in one pinned-module snippet (the kernels' wrappers are pinned too)."""
import random
import time

import numpy as np
import torch


def stamp(profiles):
    started = time.perf_counter()               # W301
    jitter = np.random.rand(len(profiles))      # W302
    shuffled = random.random()                  # W302
    names = list({p.name for p in profiles})    # W303
    order = {}
    for i, p in enumerate(profiles):
        order[id(p)] = i                        # W304
    return started, torch.as_tensor(jitter), shuffled, names, order
