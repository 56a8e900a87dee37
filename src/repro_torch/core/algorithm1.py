"""Algorithm 1 — SELECT_OPTIMAL_FREQ (paper §4.3).

Faithful implementation:
  ChooseBinSize     - offline argmin of p90 prediction error over candidates
  GetPwrNeighbor    - nearest reference by cosine distance on spike vectors
  GetUtilNeighbor   - nearest reference by Euclidean distance in util space
  CapPowerCentric   - highest frequency whose *neighbor* p90 spikes < 1.3*TDP
  CapPerfCentric    - lowest frequency whose *neighbor* perf loss <= 5%

The target workload contributes exactly ONE profile (at the uncapped clock);
all frequency-scaling information comes from the neighbor — that is the
paper's 89-90% profiling-time saving.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from repro_torch.core.classify import MinosClassifier, WorkloadProfile

DEFAULT_BIN_CANDIDATES = (0.05, 0.1, 0.15, 0.2, 0.25, 0.5)
POWER_BOUND = 1.3       # x TDP on p90 spikes (paper)
PERF_BOUND = 0.05       # 5% max degradation (paper, same as POLCA)


@dataclass
class FreqSelection:
    target: str
    bin_size: float
    power_neighbor: str
    power_distance: float
    util_neighbor: str
    util_distance: float
    f_pwr: float
    f_perf: float

    def cap(self, objective: str) -> float:
        return self.f_pwr if objective == "powercentric" else self.f_perf


@dataclass(frozen=True)
class ObjectivePolicy:
    """A pluggable capping objective: maps an Algorithm 1 ``FreqSelection``
    to the frequency cap it actuates.  The two paper objectives are builtin;
    custom policies register by name through ``repro_torch.api.register_objective``
    and flow through the same controllers as the builtins."""
    name: str
    cap_fn: Callable[[FreqSelection], float] = field(compare=False)

    def cap(self, sel: FreqSelection) -> float:
        return self.cap_fn(sel)


POWERCENTRIC = ObjectivePolicy("powercentric", lambda sel: sel.f_pwr)
PERFCENTRIC = ObjectivePolicy("perfcentric", lambda sel: sel.f_perf)
_BUILTIN_OBJECTIVES = {p.name: p for p in (POWERCENTRIC, PERFCENTRIC)}


def resolve_objective(objective) -> ObjectivePolicy:
    """Resolve a builtin objective name or an ``ObjectivePolicy``-like object
    (``.name`` + ``.cap(selection)``) to an ``ObjectivePolicy``.

    Strings only resolve the two builtins here — custom objectives are
    registered by name in ``repro_torch.api.OBJECTIVES`` and must be resolved
    through that registry (the session facade does this) so the core layer
    stays independent of the plugin namespace."""
    if isinstance(objective, ObjectivePolicy):
        return objective
    if isinstance(objective, str):
        try:
            return _BUILTIN_OBJECTIVES[objective]
        except KeyError:
            raise ValueError(
                f"unknown objective {objective!r} (builtins: "
                f"{', '.join(sorted(_BUILTIN_OBJECTIVES))}; custom objectives "
                f"resolve by name through repro_torch.api.OBJECTIVES)") from None
    name = getattr(objective, "name", None)
    if name and callable(getattr(objective, "cap", None)):
        return ObjectivePolicy(str(name), objective.cap)
    raise ValueError(f"objective must be a builtin name or an "
                     f"ObjectivePolicy-like object, got {objective!r}")


def choose_bin_size(target: WorkloadProfile, clf: MinosClassifier,
                    candidates=DEFAULT_BIN_CANDIDATES,
                    quantile: float = 90.0) -> float:
    """Err_c(T) = |p90(T) - p90(NN_c(T))| at the profiled frequency (§7.4).

    Each candidate bin size hits the classifier's cached spike matrix, so a
    sweep re-histograms the target once per c but the references only once
    per c *per classifier lifetime* (not per call).
    """
    best_c, best_err = candidates[0], np.inf
    p_t = target.p_quantile(quantile)
    for c in candidates:
        (nn, _), = clf.power_neighbors([target], bin_size=c)
        err = abs(p_t - nn.p_quantile(quantile))
        if err < best_err:
            best_c, best_err = c, err
    return best_c


def cap_power_centric(neighbor: WorkloadProfile, bound: float = POWER_BOUND,
                      quantile: str = "p90") -> float:
    """Highest frequency cap keeping the neighbor's p90 spikes under bound."""
    freqs = sorted(neighbor.scaling, reverse=True)
    for f in freqs:
        if getattr(neighbor.scaling[f], quantile) < bound:
            return f
    return freqs[-1] if freqs else 1.0


def cap_perf_centric(neighbor: WorkloadProfile, bound: float = PERF_BOUND) -> float:
    """Lowest frequency cap keeping the neighbor's degradation within bound."""
    freqs = sorted(neighbor.scaling)
    if not freqs:
        return 1.0
    base = neighbor.scaling[max(freqs)].exec_time
    for f in freqs:
        degr = neighbor.scaling[f].exec_time / base - 1.0
        if degr <= bound:
            return f
    return max(freqs)


def select_optimal_freq(target: WorkloadProfile, clf: MinosClassifier,
                        bin_candidates=DEFAULT_BIN_CANDIDATES) -> FreqSelection:
    c_star = choose_bin_size(target, clf, bin_candidates)
    (r_pwr, d_pwr), = clf.power_neighbors([target], bin_size=c_star)
    (r_util, d_util), = clf.util_neighbors([target])
    return FreqSelection(
        target=target.name,
        bin_size=c_star,
        power_neighbor=r_pwr.name,
        power_distance=d_pwr,
        util_neighbor=r_util.name,
        util_distance=d_util,
        f_pwr=cap_power_centric(r_pwr),
        f_perf=cap_perf_centric(r_util),
    )


def profiling_savings(target: WorkloadProfile, freqs: list[float]) -> float:
    """1 - T_f0 / sum_f T_f  (paper §7.1.3): one profiled frequency vs a
    sweep; exec times taken from the target's true scaling data."""
    if not target.scaling:
        return 1.0 - 1.0 / max(len(freqs), 1)
    total = sum(target.scaling[f].exec_time for f in freqs if f in target.scaling)
    f0 = max(target.scaling)
    return 1.0 - target.scaling[f0].exec_time / total
