"""Cluster-wide online capping under a shared power budget.

``FleetCapController`` scales the single-job pipeline to a
heterogeneous fleet: every admitted job gets its own ``ProfileBuilder`` and
``OnlineCapController`` (sharing one warm classifier), fed from the
``FleetTelemetryMux``'s interleaved chunk feed.  The moment any job's
confidence gate clears, its cap is actuated on its device and the whole pod
is re-packed through the heterogeneity-aware ``PowerAwareScheduler`` against
the shared cluster budget — the POLCA-style early-re-provisioning loop, now
cluster-wide.

Device portability: each job's builder normalizes by its *device's*
effective TDP (nameplate x per-chip power variability), so the partial
profiles it hands the classifier are in the same relative frame as the
single shipped (nominal-v5e) ``ReferenceLibrary``.  On a homogeneous
zero-variability fleet that base equals the nameplate TDP bit-for-bit, and
every per-job decision is byte-identical to running the single-job
``OnlineCapController.run`` path — the invariance ``tests/test_fleet.py``
pins.

Once a job has a decision its remaining telemetry is dropped (profiling
stops early on the device — the paper's cost saving).  Packing provisions
the neighbor's p99 (not p90) per-chip power by default so coincident
cross-job spikes stay inside the budget; ``benchmarks/bench_fleet.py``
validates the aggregate simulated fleet trace against it.

This port carries the controller's inert configuration: no journal, no
straggler adapter, no device failures and no discovery tap.  Every method
or argument that reaches those features raises ``NotImplementedError``
naming the ROADMAP item that adds it.  The profiling state of every job is
one slot of a ``BatchProfileEngine`` on ``device`` (default: the card).
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from time import perf_counter

from repro_torch.configs.base import MeshConfig
from repro_torch.core.classify import MinosClassifier
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.fleet.inventory import DeviceInstance, DeviceInventory
from repro_torch.fleet.mux import FleetChunk, FleetTelemetryMux
from repro_torch.pipeline.batch import BatchProfileEngine, SlotBuilder
from repro_torch.pipeline.builder import ProfileBuilder
from repro_torch.pipeline.library import ReferenceLibrary
from repro_torch.pipeline.online import CapDecision, OnlineCapController, \
    finalize_fleet, observe_fleet
from repro_torch.sched.dvfs import SimActuator
from repro_torch.sched.power_sched import IncrementalPacker, JobPlan, \
    PowerAwareScheduler, RepackStats, ScheduleResult

# ROADMAP items that add what this port of the controller leaves out
_SESSION_ITEM = "ROADMAP queue 1, item 1: MinosSession with store/, ft/, " \
    "discovery/ and the controller's failure paths"


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported yet ({_SESSION_ITEM})")


class _PendingRepack:
    """A re-pack recorded but not yet materialized: holds the live packer
    plus the exact power totals at record time.  If the packer has not
    moved on, resolving yields the full ``ScheduleResult`` (byte-identical
    to ``pack()``); once superseded, only the totals survive as
    ``RepackStats`` — per-job placements of historical packs are not kept
    at fleet scale."""

    __slots__ = ("packer", "version", "planned_w", "nameplate_w", "budget_w")

    def __init__(self, packer: IncrementalPacker):
        self.packer = packer
        self.version = packer.version
        self.planned_w = packer.planned_power_w
        self.nameplate_w = packer.nameplate_power_w
        self.budget_w = packer.budget_w

    def resolve(self):
        if self.version == self.packer.version:
            return self.packer.result()
        return RepackStats(self.planned_w, self.nameplate_w, self.budget_w)


class RepackTrail(list):
    """``FleetCapController.repacks`` with lazy materialization.

    The incremental path appends an O(1) ``_PendingRepack`` marker per
    re-pack instead of an O(n) ``ScheduleResult``; reading an entry (by
    index, slice, or iteration) resolves it in place — the most recent
    entry to the full byte-identical ``ScheduleResult``, superseded ones
    to their ``RepackStats`` power totals.  Every aggregate consumer
    (budget sweeps over history, reports, ``repacks[-1]``) works
    unchanged; only per-job placements of *historical* packs are gone."""

    __slots__ = ()

    def append_lazy(self, packer: IncrementalPacker) -> None:
        list.append(self, _PendingRepack(packer))

    def _resolve(self, i: int):
        entry = list.__getitem__(self, i)
        if type(entry) is _PendingRepack:
            entry = entry.resolve()
            list.__setitem__(self, i, entry)
        return entry

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self._resolve(j) for j in range(*i.indices(len(self)))]
        if i < 0:
            i += len(self)
        return self._resolve(i)

    def __iter__(self):
        # list iteration bypasses __getitem__; resolve explicitly
        for i in range(len(self)):
            yield self._resolve(i)


@dataclass(frozen=True)
class FleetEvent:
    """One fleet-membership/lifecycle event: a failure, a proactive
    degrade, a restore, or a per-job consequence (migrate / shrink /
    strand).  The inert controller emits none; the type is the result's."""
    kind: str                    # fail|degrade|restore|migrate|shrink|strand
    device_id: str               # the device the event is about (source)
    job_id: str = ""             # affected job ("" = device-level event)
    to_device_id: str = ""       # migration target ("" = none)
    detail: str = ""             # human-readable specifics


@dataclass
class FleetJob:
    """One admitted job: its device binding plus the per-job pipeline."""
    job_id: str
    device: DeviceInstance         # primary device (profiling frame)
    chips: int
    builder: object                # ProfileBuilder | pipeline.batch.SlotBuilder
    controller: OnlineCapController
    actuator: object               # FrequencyActuator | None (plugin-chosen)
    decision: CapDecision | None = None
    plan: JobPlan | None = None    # built once, when the decision lands
    profile_to_completion: bool = False   # keep building after the decision
    devices: tuple = ()            # full multi-chip span (defaults (device,))
    mesh: MeshConfig | None = None        # multi-chip topology (optional)
    global_batch: int | None = None       # rescaled on elastic shrink


@dataclass
class FleetResult:
    """Outcome of one fleet run: per-job decisions + the final packing."""
    decisions: dict[str, CapDecision] = field(default_factory=dict)
    schedule: ScheduleResult | None = None
    repacks: int = 0             # how many early caps triggered a re-pack
    budget_w: float = 0.0
    chunks_dropped: int = 0      # telemetry skipped after early decisions
    events: list = field(default_factory=list)   # FleetEvents, in order

    @property
    def early_decisions(self) -> int:
        return sum(d.early for d in self.decisions.values())

    @property
    def migrations(self) -> int:
        return sum(e.kind in ("migrate", "shrink") for e in self.events)


class FleetCapController:
    """Run one ``OnlineCapController`` per job under a shared power budget.

    ``references`` is a ``ReferenceLibrary`` (preferred: warm classifier) or
    a prebuilt ``MinosClassifier`` — shared by every job, on ``device``.
    Gate thresholds (``min_confidence`` etc.) are forwarded verbatim to each
    per-job controller, so a one-job fleet reproduces the single-job path
    exactly.  ``inventory`` is kept for ``device_health``; ``journal`` and
    ``straggler_adapter`` must stay ``None`` in this port.
    """

    def __init__(self, references, budget_w: float,
                 objective="powercentric",
                 provision_quantile="p99",
                 min_confidence: float = 0.3, min_fraction: float = 0.1,
                 min_spike_samples: int = 50,
                 actuator_factory=SimActuator.for_device,
                 inventory: DeviceInventory | None = None,
                 straggler_adapter=None,
                 journal=None, engine: str = "batched",
                 repack: str = "decision", packer: str = "incremental",
                 device=DEFAULT_DEVICE):
        """``engine`` selects the builder state layout: ``"batched"``
        (default) backs every job by one slot of a shared columnar
        ``BatchProfileEngine`` — bit-identical to ``"perjob"`` (one
        ``ProfileBuilder`` per job), but advanced in one stacked pass per
        ``ingest_tick``.  ``repack`` sets the re-packing cadence:
        ``"decision"`` (default) re-packs on every landed decision;
        ``"tick"`` coalesces to one re-pack per mux tick — same final
        packing, the fleet-scale mode.  ``packer`` selects how each re-pack
        is computed: ``"incremental"`` (default, an ``IncrementalPacker``)
        or ``"full"`` (one ``PowerAwareScheduler.pack`` per re-pack) —
        byte-identical results."""
        if journal is not None:
            raise _not_ported("a session journal (journal=...)")
        if straggler_adapter is not None:
            raise _not_ported("straggler monitoring (straggler_adapter=...)")
        self.device = resolve_device(device)
        if isinstance(references, ReferenceLibrary):
            self.clf = references.classifier()
        elif isinstance(references, MinosClassifier):
            self.clf = references
        else:
            self.clf = MinosClassifier(list(references), device=self.device)
        if self.clf.device != self.device:
            raise ValueError(f"the reference classifier lives on "
                             f"{self.clf.device}, the fleet on {self.device}")
        self.budget_w = float(budget_w)
        self.objective = objective
        # per-device actuator plugin: called once per admitted job with the
        # job's DeviceInstance; None disables actuation entirely
        self.actuator_factory = actuator_factory
        self._gates = dict(min_confidence=min_confidence,
                           min_fraction=min_fraction,
                           min_spike_samples=min_spike_samples)
        # tdp_w is only the fallback for device-less queue entries; every
        # fleet job carries its own device
        self.scheduler = PowerAwareScheduler(
            self.clf, tdp_w=0.0, objective=objective,
            quantile=provision_quantile)
        if engine not in ("batched", "perjob"):
            raise ValueError(f"engine must be 'batched' or 'perjob', "
                             f"got {engine!r}")
        if repack not in ("decision", "tick"):
            raise ValueError(f"repack must be 'decision' or 'tick', "
                             f"got {repack!r}")
        if packer not in ("incremental", "full"):
            raise ValueError(f"packer must be 'incremental' or 'full', "
                             f"got {packer!r}")
        self.engine = BatchProfileEngine(device=self.device) \
            if engine == "batched" else None
        self.repack_mode = repack
        self.packer_mode = packer
        self._packer = self.scheduler.packer(self.budget_w) \
            if packer == "incremental" else None
        self.repack_s = 0.0          # wall-clock spent maintaining packings
        self.inventory = inventory
        self.jobs: dict[str, FleetJob] = {}
        self.repacks = RepackTrail()
        self.events: list[FleetEvent] = []
        self._dropped = 0

    # -- not ported: discovery, classifier swaps --------------------------
    def set_discovery(self, discovery) -> None:
        raise _not_ported("online class discovery (set_discovery)")

    def adopt_classifier(self, references) -> MinosClassifier:
        raise _not_ported("adopt_classifier (discovery promotion)")

    # -- builder lifecycle -----------------------------------------------
    def _make_builder(self, meta, tdp: float):
        """One profiling-state handle in the configured engine: a slot view
        of the shared columnar engine, or a standalone ``ProfileBuilder``."""
        if self.engine is not None:
            return self.engine.builder(meta, tdp)
        return ProfileBuilder(meta, tdp=tdp, device=self.device)

    @staticmethod
    def _drop_builder(builder) -> None:
        """Release a builder's engine slot for reuse (no-op for the
        standalone ``ProfileBuilder``)."""
        release = getattr(builder, "release", None)
        if release is not None:
            release()

    # -- admission -------------------------------------------------------
    def admit(self, device: DeviceInstance, meta, chips: int = 1,
              job_id: str | None = None,
              profile_to_completion: bool = False,
              devices=None, mesh: MeshConfig | None = None,
              global_batch: int | None = None) -> str:
        """Register a job on ``device``; returns its ``job_id`` (default
        ``"<workload>@<device>"``).  The job's builder normalizes by the
        device's effective TDP — the device-portable frame.

        ``profile_to_completion`` keeps ingesting telemetry into the job's
        builder after its cap decision lands (instead of dropping it), so a
        full-trace profile stays available — the convergence-study mode.

        Multi-chip jobs may span several devices: pass the full span as
        ``devices`` (must include ``device``, which stays the profiling
        frame) with ``chips`` divided evenly across it, plus an optional
        ``mesh``/``global_batch`` (kept on the job for the elastic re-mesh
        that the failure paths will use)."""
        spec = self._admit_validate(
            device, meta, chips=chips, job_id=job_id,
            profile_to_completion=profile_to_completion, devices=devices,
            mesh=mesh, global_batch=global_batch)
        self._admit_apply(spec)
        return spec["job_id"]

    def admit_many(self, admissions) -> list[str]:
        """Bulk admission: validate a whole batch up front (atomically — a
        bad entry rejects the batch before anything is applied), then apply
        them in order, claiming every engine slot with one bulk allocation.
        ``admissions`` is an iterable of dicts with :meth:`admit`'s keyword
        arguments (``device`` and ``meta`` required).  Returns the
        ``job_id``s in batch order; job state and placement are identical
        to calling ``admit`` once per entry."""
        taken: set[str] = set()
        specs = [self._admit_validate(taken=taken, **kw)
                 for kw in admissions]
        builders = [None] * len(specs)
        if self.engine is not None:
            slots = self.engine.alloc_many(
                (spec["meta"] for spec in specs),
                (spec["device"].effective_tdp_w for spec in specs))
            builders = [SlotBuilder(self.engine, slot, spec["meta"])
                        for slot, spec in zip(slots, specs)]
        for spec, builder in zip(specs, builders):
            self._admit_apply(spec, builder)
        return [spec["job_id"] for spec in specs]

    def _admit_validate(self, device: DeviceInstance, meta, chips: int = 1,
                        job_id: str | None = None,
                        profile_to_completion: bool = False,
                        devices=None, mesh: MeshConfig | None = None,
                        global_batch: int | None = None,
                        taken: set | None = None) -> dict:
        """Shared admission checks; ``taken`` carries job_ids earlier in the
        same batch so bulk admission sees in-flight duplicates."""
        job_id = job_id or f"{meta.name}@{device.device_id}"
        if job_id in self.jobs or (taken is not None and job_id in taken):
            raise ValueError(f"duplicate job_id {job_id!r}")
        span = tuple(devices) if devices else (device,)
        if device not in span:
            raise ValueError("the primary device must be part of the span")
        if len({d.device_id for d in span}) != len(span):
            raise ValueError("duplicate device in job span")
        if chips % len(span):
            raise ValueError(f"chips={chips} does not divide evenly across "
                             f"{len(span)} devices")
        if taken is not None:
            taken.add(job_id)
        return dict(job_id=job_id, device=device, meta=meta,
                    chips=int(chips), span=span,
                    profile_to_completion=bool(profile_to_completion),
                    mesh=mesh, global_batch=global_batch)

    def _admit_apply(self, spec: dict, builder=None) -> None:
        device = spec["device"]
        actuator = self.actuator_factory(device) \
            if self.actuator_factory is not None else None
        controller = OnlineCapController(
            self.clf, objective=self.objective, actuator=actuator,
            device_id=device.device_id, **self._gates)
        if builder is None:
            builder = self._make_builder(spec["meta"],
                                         device.effective_tdp_w)
        self.jobs[spec["job_id"]] = FleetJob(
            job_id=spec["job_id"], device=device, chips=spec["chips"],
            builder=builder,
            controller=controller, actuator=actuator,
            profile_to_completion=spec["profile_to_completion"],
            devices=spec["span"], mesh=spec["mesh"],
            global_batch=spec["global_batch"])

    # -- streaming -------------------------------------------------------
    def ingest(self, fchunk: FleetChunk) -> CapDecision | None:
        """Route one multiplexed chunk to its job.  Returns that job's
        ``CapDecision`` when this chunk tips its confidence gate (which also
        re-packs the fleet); ``None`` otherwise.

        Telemetry for a job that has left the fleet is discarded."""
        job = self.jobs.get(fchunk.job_id)
        if job is None:                    # retired/stranded mid-stream
            self._dropped += 1
            return None
        return self.ingest_chunk(fchunk.job_id, fchunk.chunk)

    def ingest_chunk(self, job_id: str, chunk,
                     _defer_repack: bool = False) -> CapDecision | None:
        """Un-muxed entry point: ingest one raw ``TelemetryChunk`` for
        ``job_id`` (the ``MinosSession``/``JobHandle`` feed path)."""
        job = self.jobs[job_id]
        if job.decision is not None:
            if not job.profile_to_completion:
                self._dropped += 1
                return None        # profiling already stopped for this job
            job.builder.ingest(chunk)
            return None            # decision already made; just keep building
        job.builder.ingest(chunk)
        decision = job.controller.observe(job.builder)
        if decision is None:
            return None
        self._decide(job, decision)
        if not _defer_repack:
            self._repack()
        return decision

    def ingest_tick(self, batch) -> list[CapDecision]:
        """Advance the fleet by one mux tick — a batch of simultaneous
        ``FleetChunk``s from ``FleetTelemetryMux.ticks()`` — in one columnar
        engine pass instead of a per-job Python loop.  Returns the decisions
        that landed this tick, in chunk order.

        Outcome-equivalent to calling ``ingest`` per chunk in batch order:
        undecided jobs' chunks advance through ``BatchProfileEngine.
        ingest_batch`` (bit-identical builder state), then confidence gates
        are observed in the same chunk order, so decisions and (with
        ``repack="decision"``) re-packs land in the identical sequence.
        With ``repack="tick"`` all of a tick's decisions share one closing
        re-pack.  Falls back to the sequential path per chunk when the chunk
        can't batch (per-job engine, duplicate job in one batch)."""
        defer = self.repack_mode == "tick"
        decisions: list[CapDecision] = []
        # route: engine-eligible chunks batch; the rest go sequential
        rows = []               # (fchunk, job | None, batched, observe)
        seen: set[str] = set()
        slots, chunks = [], []
        jobs_get = self.jobs.get          # hoisted: this loop runs once
        eng = self.engine                 # per chunk at fleet scale
        for fc in batch:
            job = jobs_get(fc.job_id)
            if job is None:            # retired/stranded mid-stream
                self._dropped += 1
                continue
            eligible = (eng is not None
                        and fc.job_id not in seen
                        and getattr(job.builder, "engine", None) is eng
                        and (job.decision is None
                             or job.profile_to_completion))
            seen.add(fc.job_id)
            if eligible:
                slots.append(job.builder.slot)
                chunks.append(fc.chunk)
                rows.append((fc, job, True, job.decision is None))
            else:
                rows.append((fc, job, False, False))
        if slots:
            self.engine.ingest_batch(slots, chunks)
        # one classification sweep for every gate-passing undecided job
        # this tick (engine rows only mutate through ingest_batch above,
        # so the batched observations see exactly the state the per-row
        # observe calls would)
        obs = [pos for pos, (_, job, batched, observe) in enumerate(rows)
               if batched and observe]
        tick_ds = dict(zip(obs, observe_fleet(
            [(rows[pos][1].controller, rows[pos][1].builder)
             for pos in obs]))) if obs else {}
        for pos, (fc, job, batched, observe) in enumerate(rows):
            if not batched:
                d = self.ingest_chunk(fc.job_id, fc.chunk,
                                      _defer_repack=defer)
            elif observe:
                d = tick_ds.get(pos)
                if d is not None:
                    self._decide(job, d)
                    if not defer:
                        self._repack()
            else:
                d = None       # decided profile-to-completion job
            if d is not None:
                decisions.append(d)
        if defer and decisions:
            self._repack()
        return decisions

    def finalize(self) -> FleetResult:
        """Decide any still-undecided jobs from their completed profiles,
        re-pack once more, and return the fleet outcome.  Jobs with nothing
        ingested stay undecided and are left out of the decision map rather
        than classified from an empty trace."""
        pending = [j for j in self.jobs.values()
                   if j.decision is None and j.builder.n_ingested > 0]
        batched = [j for j in pending
                   if self.engine is not None
                   and getattr(j.builder, "engine", None) is self.engine]
        # engine-backed stragglers classify in one batched sweep; decisions
        # still adopt in admission order
        pre = dict(zip(
            (j.job_id for j in batched),
            finalize_fleet([(j.controller, j.builder) for j in batched]))) \
            if batched else {}
        for job in pending:
            decision = pre.get(job.job_id)
            if decision is None:
                decision = job.controller.finalize(job.builder)
            self._decide(job, decision)
        if pending or not self.repacks:
            self._repack()
        return FleetResult(
            decisions={j.job_id: j.decision for j in self.jobs.values()
                       if j.decision is not None},
            schedule=self.repacks[-1], repacks=len(self.repacks),
            budget_w=self.budget_w, chunks_dropped=self._dropped,
            events=list(self.events))

    def finalize_job(self, job_id: str) -> CapDecision:
        """Decide one still-undecided job from whatever it has ingested so
        far (the batch-equivalent decision) and re-pack; a no-op for jobs
        that already decided."""
        job = self.jobs[job_id]
        if job.decision is None:
            self._decide(job, job.controller.finalize(job.builder))
            self._repack()
        return job.decision

    def run(self, mux: FleetTelemetryMux) -> FleetResult:
        """Pump the multiplexed feed to completion: every mux tick advances
        all simultaneous jobs in one columnar pass, each early cap re-packs
        the fleet (per the ``repack`` cadence), stragglers decide at stream
        end.  Outcomes are byte-identical to the per-chunk drain."""
        for batch in mux.ticks():
            self.ingest_tick(batch)
        return self.finalize()

    # -- dynamic lifecycle -----------------------------------------------
    def retire(self, job_id: str) -> FleetJob:
        """Remove a job from the fleet (it finished or was cancelled): its
        telemetry routing stops and its plan leaves the packing, releasing
        its budget share.  If the job was planned, the survivors re-pack
        into the freed budget — from their cached ``JobPlan``s, so a
        retirement never re-classifies anything."""
        if job_id not in self.jobs:    # KeyError on unknown/already-retired
            raise KeyError(job_id)
        job = self.jobs.pop(job_id)
        self._drop_builder(job.builder)
        if job.plan is not None:
            self._unpack(job.plan)
            self._repack()
        return job

    def set_budget(self, budget_w: float) -> None:
        """Change the shared power budget; re-packs the decided jobs against
        the new ceiling (cached plans only — no re-classification)."""
        self.budget_w = float(budget_w)
        if self._has_plans():
            self._repack()

    # -- fault tolerance: not ported ----------------------------------------
    def fail_device(self, device_id: str) -> list[FleetEvent]:
        raise _not_ported("fail_device (migration on device failure)")

    def degrade_device(self, device_id: str) -> list[FleetEvent]:
        raise _not_ported("degrade_device (straggler drain)")

    def restore_device(self, device_id: str) -> list[FleetEvent]:
        raise _not_ported("restore_device (re-placement after restore)")

    def device_health(self) -> dict[str, str]:
        """device_id -> health for the attached inventory ({} if none)."""
        return {} if self.inventory is None \
            else dict(self.inventory.device_health)

    # -- packing ---------------------------------------------------------
    def _plan_for(self, job: FleetJob, selection=None) -> JobPlan:
        """(Re)build a job's plan from its cached decision selection —
        never a classification.  ``selection`` overrides for the moment a
        decision lands (the job field is not assigned yet)."""
        return self.scheduler.plan_from_selection(
            job.decision.selection if selection is None else selection,
            job.chips, job.device, job_id=job.job_id)

    def _decide(self, job: FleetJob, decision: CapDecision,
                plan: JobPlan | None = None) -> None:
        """Pin a job's decision and build its ``JobPlan`` once, straight
        from the decision's Algorithm 1 selection — re-packs never
        re-classify."""
        if plan is None:
            plan = self._plan_for(job, selection=decision.selection)
        job.decision = decision
        self._set_plan(job, plan)

    def _set_plan(self, job: FleetJob, plan: JobPlan | None) -> None:
        """The one way a job's plan changes: assign it and keep the
        incremental packer's population in lockstep.  Any plan the packer
        cannot hold exactly (non-finite power, colliding identity) degrades
        the controller to full packs — correctness over speed."""
        old, job.plan = job.plan, plan
        pk = self._packer
        if pk is None or old is plan:
            return
        t0 = perf_counter()
        try:
            if old is not None:
                pk.remove(old)
            if plan is not None:
                pk.insert(plan)
        except (KeyError, ValueError) as exc:
            self._packer = None
            warnings.warn(f"incremental packing disabled, falling back to "
                          f"full re-packs: {exc}", RuntimeWarning,
                          stacklevel=2)
        self.repack_s += perf_counter() - t0

    def _unpack(self, plan: JobPlan) -> None:
        """A plan leaves the fleet with its job (retire): evict it from the
        packer without touching the departed job."""
        pk = self._packer
        if pk is None:
            return
        t0 = perf_counter()
        try:
            pk.remove(plan)
        except KeyError as exc:
            self._packer = None
            warnings.warn(f"incremental packing disabled, falling back to "
                          f"full re-packs: {exc}", RuntimeWarning,
                          stacklevel=2)
        self.repack_s += perf_counter() - t0

    def _has_plans(self) -> bool:
        if self._packer is not None:
            return len(self._packer) > 0
        return any(j.plan is not None for j in self.jobs.values())

    def _repack(self) -> None:
        """Record the packing of every decided job into the budget.

        Incremental mode appends an O(1) lazy marker — the packer already
        tracks every plan mutation, so the ``ScheduleResult`` (byte-
        identical to a full ``pack()``) materializes only when the entry is
        actually read.  Full mode runs the reference O(n log n) sweep."""
        t0 = perf_counter()
        pk = self._packer
        if pk is not None:
            pk.set_budget(self.budget_w)     # O(1) when unchanged
            self.repacks.append_lazy(pk)
        else:
            self.repacks.append(self.scheduler.pack(
                (j.plan for j in self.jobs.values() if j.plan is not None),
                budget_w=self.budget_w))
        self.repack_s += perf_counter() - t0
