"""Device policy of the port: the card unless the caller asks for the CPU.

Every entry point takes an explicit ``device`` argument that defaults to
``"cuda"``.  ``resolve_device`` turns it into a ``torch.device`` and raises
when CUDA is asked for on a host without a usable card — there is no silent
fallback to the CPU.
"""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``torch.device`` for ``device``; raises if it names CUDA and no card
    is available (pass ``device="cpu"`` to run on the host)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available; "
            f"pass device='cpu' to run on the host")
    return dev


def as_f64(x, device: torch.device) -> torch.Tensor:
    """``x`` (array, tensor or sequence) as a float64 tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float64)
    return torch.as_tensor(x, dtype=torch.float64, device=device)
