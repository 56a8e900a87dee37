"""Baselines Minos is compared against (paper §7.3).

Guerreiro et al. [29] — the state of the art the paper beats — classifies
workloads by *mean power*; this is its nearest-neighbor analogue (closest
mean relative power) with the same prediction protocol as Minos, so the
comparison isolates the feature (mean power vs spike distribution).  Both
baselines read host scalars of the profiles (a profile's mean power is one
reduction of its trace on the trace's device).
"""
from __future__ import annotations

import math

import numpy as np

from repro_torch.core.classify import WorkloadProfile


def _check_eligible(best: WorkloadProfile | None, target: WorkloadProfile,
                    exclude: str | None) -> None:
    # same contract as MinosClassifier._check_eligible: an all-excluded
    # reference set is a ValueError, never a (None, inf) return
    if best is None:
        raise ValueError(
            f"no eligible reference for target {target.name!r}: every "
            f"reference is excluded (self-match or exclude={exclude!r})")


def mean_power_neighbor(target: WorkloadProfile,
                        references: list[WorkloadProfile],
                        exclude: str | None = None
                        ) -> tuple[WorkloadProfile, float]:
    """Nearest reference by mean relative power (Guerreiro et al.)."""
    mt = target.mean_power
    best, best_d = None, math.inf
    for r in references:
        if r.name == target.name or r.name == exclude:
            continue
        d = abs(mt - r.mean_power)
        if d < best_d:
            best, best_d = r, d
    _check_eligible(best, target, exclude)
    return best, float(best_d)


def util_only_neighbor(target: WorkloadProfile,
                       references: list[WorkloadProfile],
                       exclude: str | None = None
                       ) -> tuple[WorkloadProfile, float]:
    """Performance-counter-only classification (no power signal)."""
    v = target.util_point
    best, best_d = None, math.inf
    for r in references:
        if r.name == target.name or r.name == exclude:
            continue
        d = float(np.linalg.norm(v - r.util_point))
        if d < best_d:
            best, best_d = r, d
    _check_eligible(best, target, exclude)
    return best, best_d
