# minoslint: path=src/repro_torch/core/fixture_layering.py
"""Known-good twin of ``bad_layering.py``: ``core`` stays on its declared
DAG edges (device, kernels, pipeline) and imports torch, not JAX."""
import torch

from repro_torch.device import resolve_device     # allowed: core -> device
from repro_torch.kernels import spike_hist        # allowed: core -> kernels


def helper():
    from repro_torch.pipeline import library      # allowed: core -> pipeline
    return torch, resolve_device, spike_hist, library
