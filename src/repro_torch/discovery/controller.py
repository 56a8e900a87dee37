"""Discovery controller: quarantine -> re-cluster -> shadow-evaluate ->
promote.

``DiscoveryController`` owns the full online-discovery loop around a
versioned ``ReferenceLibrary``:

  * low-margin ``CapDecision``s feed the :class:`QuarantinePool` through the
    fleet's gate tap (``wants``/``entry_record``/``admit_record`` — split so
    the session can journal each entry write-ahead);
  * ``propose`` re-clusters the pool through ``core/clustering`` (average
    linkage over cosine spike distances, on the library's device), picks
    each viable cluster's medoid, profiles it to a full scaling sweep via
    the injected ``profiler``, and shadow-evaluates the candidate before it
    may promote;
  * ``apply``/``adopt_promoted`` publish the next library version — a fresh
    ``ReferenceLibrary`` built by row-append on the cached spike matrices
    (no re-histogramming of existing members), with the previous version
    retained for N-1 ``rollback``;
  * ``state_record``/``restore`` round-trip the whole thing through session
    snapshots, and replay re-adopts promotions from their journal records
    with zero classifier calls (``adopt_promoted`` never classifies).

The controller itself never touches a live classifier: proposing uses
private shadow objects, and adopting a promoted library is the session /
fleet controller's job, done atomically between ticks.  Pool profiles,
candidates and promoted rows live on the library's device.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from repro_torch.core.algorithm1 import DEFAULT_BIN_CANDIDATES
from repro_torch.core.classify import WorkloadProfile
from repro_torch.core.clustering import cosine_distance_matrix, cut, linkage
from repro_torch.device import DEFAULT_DEVICE, as_f64
from repro_torch.discovery.pool import PoolEntry, QuarantinePool
from repro_torch.discovery.records import profile_from_record, profile_record
from repro_torch.discovery.shadow import ShadowEvaluator
from repro_torch.pipeline.library import ReferenceLibrary

# the serializable knobs accepted by the session's {"discovery": {...}}
# config key (the profiler is injected programmatically — it is code)
DISCOVERY_KEYS = ("quarantine_below", "min_cluster", "cluster_distance",
                  "promote_agreement", "recluster_every", "capacity",
                  "min_confidence_gain", "bin_size")


@dataclass
class Promotion:
    """One accepted library-version bump, ready to journal and apply."""

    version: int                         # the version being promoted to
    profiles: list                       # new WorkloadProfile references
    profile_records: list                # their JSON records (journal payload)
    consumed: list                       # pool entry ids folded into classes
    reports: list = field(default_factory=list)   # ShadowReport per candidate


class DiscoveryController:
    """Online class discovery around a versioned reference library."""

    def __init__(self, library: ReferenceLibrary, objective="powercentric",
                 profiler=None, quarantine_below: float = 0.3,
                 min_cluster: int = 3, cluster_distance: float = 0.25,
                 promote_agreement: float = 0.9, recluster_every: int = 8,
                 capacity: int = 256, min_confidence_gain: float | None = 0.0,
                 bin_size: float = 0.1,
                 bin_candidates=DEFAULT_BIN_CANDIDATES):
        if not isinstance(library, ReferenceLibrary):
            raise ValueError(
                "discovery requires a ReferenceLibrary (it versions the "
                f"membership), got {type(library).__name__}")
        self.base_library = library
        self.library = library           # current (promoted) version
        self.device = library.device
        self._previous: ReferenceLibrary | None = None   # N-1 rollback
        self.version = 1
        self.batches: list[list] = []    # profile-record lists per promotion
        self.objective = objective
        self.profiler = profiler         # full-profile oracle; injected code
        self.quarantine_below = float(quarantine_below)
        self.min_cluster = int(min_cluster)
        self.cluster_distance = float(cluster_distance)
        self.promote_agreement = float(promote_agreement)
        self.recluster_every = int(recluster_every)
        self.min_confidence_gain = (None if min_confidence_gain is None
                                    else float(min_confidence_gain))
        self.bin_size = float(bin_size)
        self.bin_candidates = tuple(bin_candidates)
        self.pool = QuarantinePool(capacity=capacity, device=self.device)
        self.quarantined = 0             # admissions over the session's life
        self._since_recluster = 0

    # -- quarantine intake ----------------------------------------------
    def wants(self, decision) -> bool:
        """Does this finalized decision belong in quarantine?"""
        return decision.confidence < self.quarantine_below

    def entry_record(self, profile: WorkloadProfile, decision) -> dict:
        """Build the entry record for a wanted decision *without* admitting
        it — the caller journals the record first (write-ahead), then feeds
        the same record to ``admit_record``."""
        return PoolEntry(
            id=self.pool.next_id, name=profile.name,
            confidence=float(decision.confidence),
            device_id=decision.device_id, fraction=float(decision.fraction),
            profile=profile).record()

    def admit_record(self, rec: dict) -> PoolEntry:
        """Admit a journaled entry record (live path and replay path)."""
        entry = self.pool.add_record(rec)
        self.quarantined += 1
        self._since_recluster += 1
        return entry

    # -- re-clustering + shadow evaluation -------------------------------
    def due(self) -> bool:
        return (self._since_recluster >= self.recluster_every
                and len(self.pool) >= self.min_cluster
                and self.profiler is not None)

    def propose(self, force: bool = False) -> Promotion | None:
        """Re-cluster the pool and shadow-evaluate the candidates; returns a
        ``Promotion`` when at least one candidate passed the gate, else
        ``None``.  Pure proposal — nothing is applied or journaled here."""
        if not force and not self.due():
            return None
        if len(self.pool) < self.min_cluster:
            return None
        if self.profiler is None:
            if force:
                raise ValueError(
                    "discovery has no profiler: set session.discovery"
                    ".profiler to a full-profile callable before forcing "
                    "a proposal")
            return None
        self._since_recluster = 0
        entries = list(self.pool)
        clusters = self._clusters(entries)
        if not clusters:
            return None
        evaluator = ShadowEvaluator(
            self.library, objective=self.objective,
            bin_candidates=self.bin_candidates,
            promote_agreement=self.promote_agreement,
            min_confidence_gain=self.min_confidence_gain,
            bin_size=self.bin_size)
        new_version = self.version + 1
        profiles, records, consumed, reports = [], [], [], []
        taken: set[str] = set()
        for members in clusters:
            rep = self._medoid(members)
            full = self.profiler(rep.profile)
            candidate = self._as_candidate(full, new_version, taken)
            report = evaluator.evaluate(
                candidate, [e.profile for e in members],
                [e.confidence for e in members])
            reports.append(report)
            if not report.promote:
                continue
            taken.add(candidate.name)
            profiles.append(candidate)
            records.append(profile_record(candidate))
            consumed.extend(e.id for e in members)
        if not profiles:
            return None
        return Promotion(version=new_version, profiles=profiles,
                         profile_records=records, consumed=consumed,
                         reports=reports)

    def _spike_rows(self, entries) -> torch.Tensor:
        """(n, bins) spike vectors of the entries, stacked on the device."""
        return torch.stack([as_f64(e.profile.spike_vec(self.bin_size),
                                   self.device) for e in entries])

    def _clusters(self, entries) -> list[list[PoolEntry]]:
        """Group pool entries by average-linkage cosine clustering of their
        spike vectors; clusters below ``min_cluster`` members are left in
        the pool for later rounds.  Cluster order follows leaf first
        appearance (deterministic in entry order)."""
        if len(entries) < 2:
            return []
        labels = cut(linkage(cosine_distance_matrix(self._spike_rows(
            entries)), method="average"), self.cluster_distance)
        by_label: dict[int, list[PoolEntry]] = {}
        for entry, lab in zip(entries, labels):
            by_label.setdefault(int(lab), []).append(entry)
        return [members for members in by_label.values()
                if len(members) >= self.min_cluster]

    def _medoid(self, members) -> PoolEntry:
        """Cluster representative: the member minimizing the summed cosine
        distance to the rest (first wins on ties).  The sums run over the
        columns in order, so the card and the host pick the same member."""
        D = cosine_distance_matrix(self._spike_rows(members))
        sums = D[:, 0]
        for j in range(1, D.shape[1]):
            sums = sums + D[:, j]
        return members[int(torch.argmin(sums).item())]

    def _as_candidate(self, full: WorkloadProfile, version: int,
                      taken: set[str]) -> WorkloadProfile:
        """Rebrand the profiled representative with a unique, versioned
        reference name (library names are unique keys)."""
        base = f"discovered-v{version}:{full.name}"
        name, k = base, 2
        while name in self.library or name in taken:
            name, k = f"{base}#{k}", k + 1
        return WorkloadProfile(
            name=name, tdp=full.tdp, power_trace=full.power_trace,
            sm_util=full.sm_util, dram_util=full.dram_util,
            exec_time=full.exec_time, scaling=dict(full.scaling),
            domain=full.domain or "discovered")

    # -- promotion / rollback --------------------------------------------
    def apply(self, promo: Promotion) -> ReferenceLibrary:
        """Publish ``promo`` as the next library version (live path; the
        caller journals the promotion record first)."""
        return self._apply(promo.version, promo.profiles,
                           promo.profile_records, promo.consumed)

    def adopt_promoted(self, version: int, profile_records,
                       consumed) -> ReferenceLibrary:
        """Re-adopt a journaled promotion verbatim (replay path) — rebuilds
        the promoted profiles from their records on the library's device;
        zero classifier calls."""
        profiles = [profile_from_record(rec, device=self.device)
                    for rec in profile_records]
        return self._apply(int(version), profiles, list(profile_records),
                           list(consumed))

    def _apply(self, version, profiles, records, consumed):
        if version != self.version + 1:
            raise ValueError(
                f"promotion targets version {version}, current is "
                f"{self.version} (promotions apply in order)")
        new_lib = self.library.subset(lambda p: True)
        for p in profiles:
            new_lib.add(p)               # row-append on cached spike matrices
        self.pool.remove(consumed)
        # a promotion closes the current re-cluster window on BOTH paths
        # (live apply and journal replay) — propose() already zeroed it on
        # the live path, so this keeps replayed state identical
        self._since_recluster = 0
        self._previous = self.library
        self.library = new_lib
        self.version = version
        self.batches.append(list(records))
        return new_lib

    def rollback(self) -> ReferenceLibrary:
        """Revert to the N-1 library version (one step only — older versions
        are gone once a newer promotion lands)."""
        if self._previous is None:
            raise ValueError("no previous library version to roll back to")
        self.library = self._previous
        self._previous = None
        self.batches.pop()
        self.version -= 1
        return self.library

    # -- persistence ------------------------------------------------------
    def state_record(self) -> dict:
        """Snapshot state: pool + promoted batches (JSON-safe)."""
        return {
            "version": self.version,
            "next_id": self.pool.next_id,
            "quarantined": self.quarantined,
            "since_recluster": self._since_recluster,
            "pool": [e.record() for e in self.pool],
            "batches": [list(batch) for batch in self.batches],
        }

    def restore(self, state: dict) -> None:
        """Rebuild from ``state_record`` output: replays every promoted
        batch on top of the base library (row-append only — no classifier,
        no re-histogramming of existing members)."""
        self.library = self.base_library
        self._previous = None
        self.version = 1
        self.batches = []
        for batch in state.get("batches", ()):
            self.adopt_promoted(self.version + 1, batch, ())
        self.pool.restore(state.get("pool", ()),
                          int(state.get("next_id", 1)))
        self.quarantined = int(state.get("quarantined", 0))
        self._since_recluster = int(state.get("since_recluster", 0))

    def config_record(self) -> dict:
        """The serializable knobs, for the store's open record."""
        return {
            "quarantine_below": self.quarantine_below,
            "min_cluster": self.min_cluster,
            "cluster_distance": self.cluster_distance,
            "promote_agreement": self.promote_agreement,
            "recluster_every": self.recluster_every,
            "capacity": self.pool.capacity,
            "min_confidence_gain": self.min_confidence_gain,
            "bin_size": self.bin_size,
        }

    def report_record(self) -> dict:
        """Session-report summary of the discovery state."""
        discovered = [name for batch in self.batches
                      for name in (rec["name"] for rec in batch)]
        return {
            "version": self.version,
            "pool": len(self.pool),
            "quarantined": self.quarantined,
            "promotions": len(self.batches),
            "classes": discovered,
        }


def stream_profiler(streams, model=None, freqs=None, tdp=None, seed: int = 0,
                    target_duration: float = 3.0, chunk_samples: int = 256,
                    device=DEFAULT_DEVICE):
    """Full-profile oracle over a set of known ``KernelStream``s: returns a
    callable mapping a quarantined partial profile to the full frequency
    sweep of the stream it came from (matched by name — exact, else the
    longest stream name the profile name starts with), profiled on
    ``device``.

    This stands in for the production act of scheduling a one-off full
    profiling run for a newly discovered family; benchmarks and tests hand
    it the novel zoo streams."""
    from repro_torch.analysis.hardware import FREQ_SWEEP
    from repro_torch.pipeline.builder import stream_profile_workload
    from repro_torch.telemetry.power_model import TPUPowerModel

    model = model or TPUPowerModel()
    freqs = FREQ_SWEEP if freqs is None else freqs
    tdp = model.spec.tdp_w if tdp is None else float(tdp)
    by_name = {s.name: (i, s) for i, s in enumerate(streams)}
    memo: dict[str, WorkloadProfile] = {}

    def profiler(profile: WorkloadProfile) -> WorkloadProfile:
        key = profile.name
        if key not in by_name:
            prefixes = [n for n in by_name
                        if key.startswith(n) or key.split("@")[0] == n]
            if not prefixes:
                raise KeyError(
                    f"no stream matches quarantined profile {key!r}")
            key = max(prefixes, key=len)
        if key not in memo:
            i, stream = by_name[key]
            memo[key] = stream_profile_workload(
                stream, model, freqs, tdp, seed=seed + i,
                target_duration=target_duration,
                chunk_samples=chunk_samples, device=device)
        return memo[key]

    return profiler
