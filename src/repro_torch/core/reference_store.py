"""DEPRECATED persistence shim — use ``repro_torch.pipeline.ReferenceLibrary``.

The store's flat ``save_profiles``/``load_profiles`` functions have been
folded into the versioned ``ReferenceLibrary`` (which additionally persists
the fingerprinted spike-matrix cache for classifier warm starts and keeps
traces float64 so reloads are bit-exact).  These wrappers delegate there and
emit ``DeprecationWarning``; directories written by either API load with
either API — the library's reader tolerates stores without the
``library.json``/``spike_cache.npz`` sidecars (including float32 trace
archives), and reads the reference package's stores as its own.  The
library, and so the loaded profiles' traces, live on ``device`` (default:
the card).
"""
from __future__ import annotations

import warnings

from repro_torch.core.classify import WorkloadProfile
from repro_torch.device import DEFAULT_DEVICE


def save_profiles(profiles: list[WorkloadProfile], directory: str,
                  device=DEFAULT_DEVICE) -> None:
    warnings.warn(
        "repro_torch.core.reference_store.save_profiles is deprecated; use "
        "repro_torch.pipeline.ReferenceLibrary(profiles).save(directory)",
        DeprecationWarning, stacklevel=2)
    from repro_torch.pipeline.library import ReferenceLibrary
    ReferenceLibrary(profiles, device=device).save(directory)


def load_profiles(directory: str,
                  device=DEFAULT_DEVICE) -> list[WorkloadProfile]:
    warnings.warn(
        "repro_torch.core.reference_store.load_profiles is deprecated; use "
        "repro_torch.pipeline.ReferenceLibrary.load(directory)",
        DeprecationWarning, stacklevel=2)
    from repro_torch.pipeline.library import ReferenceLibrary
    return ReferenceLibrary.load(directory, device=device).profiles
