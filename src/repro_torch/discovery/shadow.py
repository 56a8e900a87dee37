"""Shadow evaluation: score a candidate class before it touches production.

A candidate minted by re-clustering is only as good as the decisions it
would change.  The evaluator builds a *shadow* library (current library plus
the candidate), classifies every quarantined cluster member against it, and
compares each member's shadow cap with the candidate's full-profile ground
truth (``cap_power_centric``/``cap_perf_centric`` over its measured scaling
table — the same truth the benchmarks use).  Shadow classifiers are private
objects; no live classifier is queried, so evaluation can never perturb a
running session's decisions or its zero-call accounting.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.algorithm1 import (DEFAULT_BIN_CANDIDATES,
                                         FreqSelection, cap_perf_centric,
                                         cap_power_centric,
                                         resolve_objective)
from repro_torch.core.classify import WorkloadProfile
from repro_torch.pipeline.library import ReferenceLibrary
from repro_torch.pipeline.online import classify_with_margin


@dataclass
class ShadowReport:
    """Outcome of evaluating one candidate class against its members."""

    candidate: str
    n_members: int
    agreement: float             # fraction of members whose shadow cap hits truth
    mean_confidence_before: float
    mean_confidence_after: float
    truth_cap: float
    promote: bool

    def record(self) -> dict:
        return {
            "candidate": self.candidate,
            "n_members": self.n_members,
            "agreement": float(self.agreement),
            "mean_confidence_before": float(self.mean_confidence_before),
            "mean_confidence_after": float(self.mean_confidence_after),
            "truth_cap": float(self.truth_cap),
            "promote": self.promote,
        }


def truth_selection(profile: WorkloadProfile,
                    bin_size: float = 0.1) -> FreqSelection:
    """Ground-truth selection for a fully profiled workload: it is its own
    neighbor, so both caps come straight from its measured scaling table."""
    return FreqSelection(
        target=profile.name, bin_size=float(bin_size),
        power_neighbor=profile.name, power_distance=0.0,
        util_neighbor=profile.name, util_distance=0.0,
        f_pwr=cap_power_centric(profile),
        f_perf=cap_perf_centric(profile))


class ShadowEvaluator:
    """Gatekeeper between re-clustering and promotion."""

    def __init__(self, library: ReferenceLibrary, objective="powercentric",
                 bin_candidates=DEFAULT_BIN_CANDIDATES,
                 promote_agreement: float = 0.9,
                 min_confidence_gain: float | None = 0.0,
                 bin_size: float = 0.1):
        self.library = library
        self.objective_policy = resolve_objective(objective)
        self.bin_candidates = tuple(bin_candidates)
        self.promote_agreement = float(promote_agreement)
        self.min_confidence_gain = (None if min_confidence_gain is None
                                    else float(min_confidence_gain))
        self.bin_size = float(bin_size)

    def evaluate(self, candidate: WorkloadProfile, members,
                 member_confidences) -> ShadowReport:
        """Score ``candidate`` (a fully profiled class representative)
        against its quarantined ``members`` (partial profiles) and the
        margin confidences they were quarantined with."""
        shadow = self.library.subset(lambda p: True)
        shadow.add(candidate)
        shadow_clf = shadow.classifier(bin_size=self.bin_size)
        truth_cap = self.objective_policy.cap(
            truth_selection(candidate, self.bin_size))
        hits = 0
        conf_after = []
        for member in members:
            sel, conf = classify_with_margin(member, shadow_clf,
                                             self.bin_candidates)
            conf_after.append(conf)
            if self.objective_policy.cap(sel) == truth_cap:
                hits += 1
        n = len(conf_after)
        agreement = hits / n if n else 0.0
        before = (sum(float(c) for c in member_confidences)
                  / len(member_confidences)) if member_confidences else 0.0
        after = sum(conf_after) / n if n else 0.0
        promote = n > 0 and agreement >= self.promote_agreement and (
            self.min_confidence_gain is None
            or after - before >= self.min_confidence_gain)
        return ShadowReport(
            candidate=candidate.name, n_members=n, agreement=agreement,
            mean_confidence_before=before, mean_confidence_after=after,
            truth_cap=truth_cap, promote=promote)
