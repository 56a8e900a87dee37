"""Minos on PyTorch and CUDA: the port of the ``repro`` package to an NVIDIA
Hopper card.

The layout mirrors ``repro`` module for module (``repro.X.Y`` <->
``repro_torch.X.Y``).  This package imports torch, numpy and the standard
library only.  Its entry points run on the card (``device="cuda"``) unless
the caller asks for the CPU; with no card and no such request they raise.

Ported so far: the fleet profiling path — telemetry simulation,
``BatchProfileEngine`` / ``ProfileBuilder``, the reference library, the
Minos classifier and Algorithm 1, the online cap controllers, the
incremental packer and ``FleetCapController`` with its failure paths — the
``MinosSession`` facade (``api``) with its durable store (``store``) and
fault-tolerance helpers (``ft``), and LM serving (``models``, ``serve``).
The kernels (``kernels/csrc``) are CUDA C++ for ``sm_90a``.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
