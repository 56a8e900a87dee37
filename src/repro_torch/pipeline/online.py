"""Online frequency capping from partial profiles (the pipeline's service
mode).

The paper's batch workflow profiles a new workload to completion before
Algorithm 1 runs once.  ``OnlineCapController`` instead watches a
``ProfileBuilder`` mid-run: after each ingested chunk it classifies the
partial profile, turns the nearest/runner-up cosine distances into a
margin-based confidence score, and — once confident — issues the frequency
cap **early** through the DVFS actuator and (optionally) re-packs the pod
through ``PowerAwareScheduler``.  ``benchmarks/bench_online_cap.py`` measures
how early the online decision converges to the full-profile cap.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import spikes
from repro_torch.core.algorithm1 import (DEFAULT_BIN_CANDIDATES, FreqSelection,
                                   cap_perf_centric, cap_power_centric,
                                   resolve_objective, select_optimal_freq)
from repro_torch.core.classify import MinosClassifier, WorkloadProfile
from repro_torch.pipeline.builder import ProfileBuilder
from repro_torch.pipeline.library import ReferenceLibrary


@dataclass
class CapDecision:
    target: str
    cap: float
    objective: str
    selection: FreqSelection
    confidence: float            # 1 - d_best/d_second at the chosen bin size
    fraction: float              # trace fraction ingested when decided
    n_samples: int
    early: bool                  # decided before the stream finished
    device_id: str = ""          # fleet device the job runs on ("" = n/a)


def classify_with_margin(profile: WorkloadProfile, clf: MinosClassifier,
                         bin_candidates=DEFAULT_BIN_CANDIDATES
                         ) -> tuple[FreqSelection, float]:
    """Algorithm 1 plus a distance-margin confidence: how decisively the
    nearest power neighbor beats the runner-up at the selected bin size.
    Confidence is ``1 - d1/d2`` in [0, 1]: ~0 when the two closest references
    are equidistant (an unstable decision), ->1 when the winner is clear."""
    sel = select_optimal_freq(profile, clf, bin_candidates)
    (_, d1, d2), = clf.power_top2([profile], bin_size=sel.bin_size)
    if d2 == 0.0:
        confidence = 0.0         # two exact ties: nothing separates them
    elif d2 == float("inf"):
        confidence = 1.0         # single eligible reference
    else:
        confidence = max(0.0, 1.0 - d1 / d2)
    return sel, confidence


def _batch_quantiles(profiles, q: float) -> None:
    """Prefill each profile's ``p_quantile`` memo with row-wise percentiles
    over equal-length trace stacks (one device sort per stack).
    ``spikes.p_quantiles`` computes each row independently of the others,
    so every prefetched value is bit-identical to the per-trace call the
    memo would otherwise make."""
    q = float(q)
    by_len: dict[int, list] = {}
    for p in profiles:
        cache = p.__dict__.setdefault("_pq_memo", {})
        if q in cache or len(p.power_trace) == 0:
            continue
        by_len.setdefault(len(p.power_trace), []).append(p)
    for group in by_len.values():
        if len(group) == 1:
            group[0].p_quantile(q)           # plain single-trace path
            continue
        vals = spikes.p_quantiles(
            torch.stack([p.power_trace for p in group]), q)
        for p, v in zip(group, vals):
            p.__dict__["_pq_memo"][q] = float(v / p.tdp)


def classify_with_margin_batch(profiles, clf: MinosClassifier,
                               bin_candidates=DEFAULT_BIN_CANDIDATES
                               ) -> list[tuple[FreqSelection, float]]:
    """``classify_with_margin`` over a whole batch of profiles in a handful
    of classifier queries: one ``power_neighbors_idx`` sweep per candidate
    bin size for every profile at once, one batched utilization query, and
    one margin query per *distinct chosen* bin size — instead of ~9 queries
    per profile.  Per-profile results are bit-identical to the one-at-a-time
    path: every reduction in the distance pipeline (fixed-order dot products
    and norms, row-wise argmin/second-smallest/percentile) computes row i
    independently of the batch around it.  The distance matrices live on
    the classifier's device; the chosen indices and distances come back to
    the host once per candidate bin size."""
    if not profiles:
        return []
    q = 90.0                                 # choose_bin_size default
    _batch_quantiles(profiles, q)
    p_t = np.array([p.p_quantile(q) for p in profiles])
    ref_pq = np.array([r.p_quantile(q) for r in clf.references])
    n = len(profiles)
    # one fused sweep: nearest + runner-up distances for every candidate bin
    # size, from one distance matrix per candidate
    sweep = clf.power_sweep(profiles, bin_candidates, second=False)
    nn_idx = np.stack([s[0] for s in sweep], axis=1)
    nn_dist = np.stack([s[1] for s in sweep], axis=1)
    # ChooseBinSize: argmin of |p90(T) - p90(NN_c(T))|, first minimum wins
    # (exactly the strict-less update order of the sequential sweep)
    errs = np.abs(p_t[:, None] - ref_pq[nn_idx])
    best_j = np.argmin(errs, axis=1)
    rows = np.arange(n)
    pwr_idx = nn_idx[rows, best_j]
    util_idx, util_dist = clf.util_neighbors_idx(profiles)
    # the margin distances at the chosen bin size come straight out of the
    # sweep — the one-at-a-time path recomputes the same matrix in power_top2.
    # The runner-up partition runs only on the rows that chose each bin size
    # (a row of the distance matrix partitions the same alone as in bulk).
    d1 = nn_dist[rows, best_j]
    d2 = np.empty(n, np.float64)
    for j, s in enumerate(sweep):
        sel_rows = np.nonzero(best_j == j)[0]
        if not len(sel_rows):
            continue
        D = s[2]
        if D.shape[1] > 1:
            rows_t = torch.as_tensor(sel_rows, device=D.device)
            d2[sel_rows] = torch.topk(D.index_select(0, rows_t), 2, dim=1,
                                      largest=False).values[:, 1].cpu().numpy()
        else:
            d2[sel_rows] = np.inf
    # frequency caps are pure functions of the neighbor: compute once per
    # distinct neighbor, not once per profile
    f_pwr_memo: dict[int, float] = {}
    f_perf_memo: dict[int, float] = {}
    pwr_i = pwr_idx.tolist()
    util_i = util_idx.tolist()
    pwr_d = d1.tolist()                      # .tolist() preserves the bits
    util_d = util_dist.tolist()
    d1_l, d2_l = d1.tolist(), d2.tolist()
    best_c = [bin_candidates[j] for j in best_j.tolist()]
    out = []
    for i, p in enumerate(profiles):
        pi, ui = pwr_i[i], util_i[i]
        f_pwr = f_pwr_memo.get(pi)
        if f_pwr is None:
            f_pwr = f_pwr_memo[pi] = cap_power_centric(clf.references[pi])
        f_perf = f_perf_memo.get(ui)
        if f_perf is None:
            f_perf = f_perf_memo[ui] = cap_perf_centric(clf.references[ui])
        sel = FreqSelection(
            target=p.name, bin_size=best_c[i],
            power_neighbor=clf.references[pi].name,
            power_distance=pwr_d[i],
            util_neighbor=clf.references[ui].name,
            util_distance=util_d[i],
            f_pwr=f_pwr, f_perf=f_perf)
        if d2_l[i] == 0.0:
            confidence = 0.0
        elif d2_l[i] == float("inf"):
            confidence = 1.0
        else:
            confidence = max(0.0, 1.0 - d1_l[i] / d2_l[i])
        out.append((sel, confidence))
    return out


class OnlineCapController:
    """Watch a builder's stream and issue the cap as soon as it is safe.

    ``references`` may be a ``ReferenceLibrary`` (warm-started classifier) or
    a prebuilt ``MinosClassifier``.  A decision fires when the partial
    profile has at least ``min_spike_samples`` committed spike samples, at
    least ``min_fraction`` of the expected trace, and margin confidence at or
    above ``min_confidence`` — or unconditionally at ``finalize``.

    Cost note: every ``observe`` runs full Algorithm 1 on the snapshot —
    O(trace-so-far), since ``choose_bin_size`` needs trace quantiles, not
    just the builder's incremental histograms (the snapshot memoizes its
    spike vectors so the bin-size sweep, neighbor, and margin queries share
    one histogram pass per bin size).  At the shipped 1 kHz sampling that is
    microseconds per chunk; raise ``min_spike_samples``/``min_fraction`` or
    observe every k-th chunk if sampling orders of magnitude faster.
    """

    def __init__(self, references, objective="powercentric",
                 actuator=None, min_confidence: float = 0.3,
                 min_fraction: float = 0.1, min_spike_samples: int = 50,
                 bin_candidates=DEFAULT_BIN_CANDIDATES,
                 device_id: str = ""):
        if isinstance(references, ReferenceLibrary):
            self.clf = references.classifier()
        elif isinstance(references, MinosClassifier):
            self.clf = references
        else:
            self.clf = MinosClassifier(list(references))
        # a builtin name ("powercentric"/"perfcentric") or any
        # ObjectivePolicy-like plugin (see repro.api.register_objective)
        self.objective_policy = resolve_objective(objective)
        self.objective = self.objective_policy.name
        self.actuator = actuator
        self.min_confidence = float(min_confidence)
        self.min_fraction = float(min_fraction)
        self.min_spike_samples = int(min_spike_samples)
        self.bin_candidates = tuple(bin_candidates)
        self.device_id = device_id
        self.decisions: list[CapDecision] = []

    # discovery gate tap (class default, so a tap-less controller is
    # byte-identical to the pre-discovery one): when set — by
    # FleetCapController.set_discovery — every recorded decision is offered,
    # with its decided profile, to the quarantine intake.  Replay never
    # calls _record (decisions are re-adopted verbatim from the journal), so
    # a resumed session cannot double-quarantine.
    quarantine_tap = None

    def _record(self, profile, builder: ProfileBuilder, sel: FreqSelection,
                confidence: float, early: bool) -> CapDecision:
        decision = CapDecision(
            target=profile.name, cap=self.objective_policy.cap(sel),
            objective=self.objective, selection=sel, confidence=confidence,
            fraction=builder.fraction, n_samples=builder.n_ingested,
            early=early, device_id=self.device_id)
        self.decisions.append(decision)
        if self.actuator is not None:
            self.actuator.set_cap(decision.cap)
        if self.quarantine_tap is not None:
            self.quarantine_tap(profile, decision)
        return decision

    def observe(self, builder: ProfileBuilder) -> CapDecision | None:
        """Called after a chunk lands: returns an early ``CapDecision`` once
        the gates pass, ``None`` while the evidence is still too thin."""
        if builder.spike_count() < self.min_spike_samples:
            return None
        if builder.fraction < self.min_fraction:
            return None
        profile = builder.snapshot()
        if len(profile.power_trace) == 0:
            return None
        sel, conf = classify_with_margin(profile, self.clf,
                                         self.bin_candidates)
        if conf < self.min_confidence:
            return None
        return self._record(profile, builder, sel, conf, early=True)

    def finalize(self, builder: ProfileBuilder) -> CapDecision:
        """End of stream without a confident early call: decide from the
        completed profile (the batch-equivalent decision)."""
        profile = builder.finalize()
        sel, conf = classify_with_margin(profile, self.clf,
                                         self.bin_candidates)
        return self._record(profile, builder, sel, conf, early=False)

    def run(self, meta, chunks, tdp: float, **builder_kw) -> CapDecision:
        """Pump a ``stream_telemetry`` stream to the first confident decision
        (early-stopping the profile run — the paper's cost saving, extended
        online); falls back to the finalize decision at stream end."""
        builder = ProfileBuilder(meta, tdp, **builder_kw)
        for chunk in chunks:
            builder.ingest(chunk)
            decision = self.observe(builder)
            if decision is not None:
                return decision
        return self.finalize(builder)

    # -- pod integration -------------------------------------------------
    def repack(self, scheduler, jobs, budget_w: float):
        """Re-pack the pod after cap decisions change the power picture:
        delegates to ``PowerAwareScheduler.schedule`` over the live job
        queue (deterministic first-fit-decreasing)."""
        return scheduler.schedule(jobs, budget_w=budget_w)


# ---------------------------------------------------------------------------
# fleet-scale batched observation (one classification sweep per mux tick)
# ---------------------------------------------------------------------------
def _grouped(entries):
    """Group ``(i, controller, builder, profile)`` entries by the (shared)
    classifier + bin-candidate tuple, preserving order within each group."""
    groups: dict[tuple, list] = {}
    for entry in entries:
        ctl = entry[1]
        # id() keys group by *object identity* within one call only —
        # never ordered, compared, or serialized (dict insertion order is
        # first-appearance, which is deterministic given the input order)
        groups.setdefault((id(ctl.clf), ctl.bin_candidates),  # minoslint: disable=W304
                          []).append(entry)
    return groups.values()


def _replica_key(ctl, builder, tdp: float, n_ingested: int):
    """Replica-group key for engine-backed fleet jobs.  Slot rows that
    ingested the same telemetry stream (identified by the *shared*
    ``TraceMeta`` object — the fleet pattern where one pre-generated stream
    feeds many jobs) at the same TDP to the same depth hold bit-identical
    state: the engine is deterministic in (chunk values, tdp), so one
    representative's snapshot and classification serve the whole group.
    ``tdp``/``n_ingested`` are the builder's, read in bulk by the caller.
    Jobs with per-job metas never share a key and see no behavior change."""
    return (id(builder.meta), tdp, n_ingested,
            id(ctl.clf), ctl.bin_candidates)


def observe_fleet(pairs) -> list:
    """Batched ``OnlineCapController.observe`` across many ``(controller,
    builder)`` pairs (one per fleet job, sharing a classifier): the cheap
    per-job gates run in pair order, then every gate-passing snapshot goes
    through ONE ``classify_with_margin_batch`` sweep — with one
    representative per replica group (see ``_replica_key``) standing in for
    all its identical siblings.  Returns the per-pair ``CapDecision |
    None`` list; each decision is bit-identical to what that pair's
    ``observe`` call would have produced."""
    out = [None] * len(pairs)
    # engine-backed slot builders gate and snapshot columnar: one bulk read
    # of (spike count, samples ingested, tdp) and one snapshot_batch per
    # engine, instead of per-job device reads
    snap: dict[int, object] = {}
    gated: set[int] = set()
    replicas: dict[int, list[int]] = {}
    by_engine: dict[int, list[int]] = {}
    engines: dict[int, object] = {}
    for i, (ctl, builder) in enumerate(pairs):
        eng = getattr(builder, "engine", None)
        if eng is not None and not getattr(builder, "_released", True):
            # identity grouping within this call only: iteration is in
            # first-appearance order and keys are never serialized
            by_engine.setdefault(id(eng), []).append(i)  # minoslint: disable=W304
            engines[id(eng)] = eng  # minoslint: disable=W304
    for key, ids in by_engine.items():
        eng = engines[key]
        counts, n_ing, tdps = eng.gate_columns([pairs[i][1].slot for i in ids])
        reps: list[int] = []
        first: dict[tuple, int] = {}
        for i, cnt, n, tdp in zip(ids, counts.tolist(), n_ing.tolist(),
                                  tdps.tolist()):
            ctl, builder = pairs[i]
            if cnt < ctl.min_spike_samples \
                    or n / max(builder.meta.n_samples, 1) < ctl.min_fraction:
                continue
            r = first.setdefault(_replica_key(ctl, builder, tdp, n), i)
            if r == i:
                reps.append(i)
            else:
                replicas.setdefault(r, []).append(i)
        gated.update(ids)
        snap.update(zip(reps, eng.snapshot_batch(
            [pairs[i][1].slot for i in reps])))
    passing = []                 # (i, controller, builder, profile)
    for i, (ctl, builder) in enumerate(pairs):
        if i in snap:
            profile = snap[i]
        elif i in gated:
            continue             # batched gates said the evidence is thin
            # (replica siblings ride on their representative instead)
        else:
            if builder.spike_count() < ctl.min_spike_samples:
                continue
            if builder.fraction < ctl.min_fraction:
                continue
            profile = builder.snapshot()
        if len(profile.power_trace) == 0:
            continue
        passing.append((i, ctl, builder, profile))
    for group in _grouped(passing):
        results = classify_with_margin_batch(
            [p for _, _, _, p in group], group[0][1].clf,
            group[0][1].bin_candidates)
        for (i, ctl, builder, profile), (sel, conf) in zip(group, results):
            if conf >= ctl.min_confidence:
                out[i] = ctl._record(profile, builder, sel, conf, early=True)
            for j in replicas.get(i, ()):
                ctl_j, b_j = pairs[j]
                if conf >= ctl_j.min_confidence:
                    out[j] = ctl_j._record(profile, b_j, sel, conf,
                                           early=True)
    return out


def finalize_fleet(pairs) -> list:
    """Batched ``OnlineCapController.finalize``: flush every builder, then
    classify all completed profiles in one sweep per shared classifier.
    Returns the per-pair ``CapDecision`` list, in pair order."""
    # engine-backed slot builders flush through finalize_batch (stacked memo
    # prefill); plain builders finalize one at a time
    profs: dict[int, object] = {}
    by_engine: dict[int, list[int]] = {}
    engines: dict[int, object] = {}
    for i, (ctl, builder) in enumerate(pairs):
        eng = getattr(builder, "engine", None)
        if eng is not None and not getattr(builder, "_released", True):
            # identity grouping within this call only: iteration is in
            # first-appearance order and keys are never serialized
            by_engine.setdefault(id(eng), []).append(i)  # minoslint: disable=W304
            engines[id(eng)] = eng  # minoslint: disable=W304
    for key, ids in by_engine.items():
        profs.update(zip(ids, engines[key].finalize_batch(
            [pairs[i][1].slot for i in ids])))
    entries = [(i, ctl, builder,
                profs[i] if i in profs else builder.finalize())
               for i, (ctl, builder) in enumerate(pairs)]
    out = [None] * len(pairs)
    # replica dedup (see _replica_key): every engine slot still flushed
    # above — only the classification is shared.  Each sibling's decision
    # is built from its OWN (bit-identical) profile and builder.
    replicas: dict[int, list] = {}
    first: dict[tuple, int] = {}
    lead = []
    for e in entries:
        i, ctl, builder, _ = e
        if i in profs:
            prof = profs[i]
            r = first.setdefault(
                _replica_key(ctl, builder, prof.tdp, prof.n_samples), i)
            if r != i:
                replicas.setdefault(r, []).append(e)
                continue
        lead.append(e)
    for group in _grouped(lead):
        results = classify_with_margin_batch(
            [p for _, _, _, p in group], group[0][1].clf,
            group[0][1].bin_candidates)
        for (i, ctl, builder, profile), (sel, conf) in zip(group, results):
            out[i] = ctl._record(profile, builder, sel, conf, early=False)
            for j, ctl_j, b_j, prof_j in replicas.get(i, ()):
                out[j] = ctl_j._record(prof_j, b_j, sel, conf, early=False)
    return out
