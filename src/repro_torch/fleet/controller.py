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

Fault tolerance (connects ``repro_torch.ft`` to the fleet): construct with
an ``inventory`` and the controller survives membership churn —
``fail_device`` migrates every affected job to surviving healthy silicon by
re-costing its cached ``CapDecision`` selection against the new device's
effective TDP (``PowerAwareScheduler.migrate_plan``: **zero classifier
calls**, the same invariant as retire/set_budget), ``degrade_device``
drains a straggling device proactively, ``restore_device`` returns it to
the placement pool.  Multi-chip jobs that lose part of their device span
shrink through ``ft.plan_new_mesh``/``rescale_batch`` instead of migrating
wholesale.  A ``FleetStragglerAdapter`` wired via ``straggler_adapter``
turns the mux's per-device chunk cadence into automatic degrade-and-drain.
A ``journal`` (a ``repro_torch.store.SessionStore``) records every
mutation write-ahead.

The profiling state of every job is one slot of a ``BatchProfileEngine`` on
``device`` (default: the card).  Online class discovery (``set_discovery``,
``adopt_classifier``) is not ported yet and raises ``NotImplementedError``.
"""
from __future__ import annotations

import warnings
from contextlib import nullcontext
from dataclasses import dataclass, field
from time import perf_counter

from repro_torch.configs.base import MeshConfig
from repro_torch.core.classify import MinosClassifier
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.fleet.inventory import FAILED, HEALTHY, DeviceInstance, \
    DeviceInventory
from repro_torch.fleet.mux import FleetChunk, FleetTelemetryMux
from repro_torch.fleet.records import device_record, meta_record, \
    mesh_record
from repro_torch.ft.elastic import plan_new_mesh, rescale_batch
from repro_torch.ft.fleetwatch import FleetStragglerAdapter
from repro_torch.pipeline.batch import BatchProfileEngine, SlotBuilder
from repro_torch.pipeline.builder import ProfileBuilder
from repro_torch.pipeline.library import ReferenceLibrary
from repro_torch.pipeline.online import CapDecision, OnlineCapController, \
    finalize_fleet, observe_fleet
from repro_torch.sched.dvfs import SimActuator
from repro_torch.sched.power_sched import IncrementalPacker, JobPlan, \
    PowerAwareScheduler, RepackStats, ScheduleResult
from repro_torch.store import kinds

# the ROADMAP item that adds what the port's controller and session leave
# out (online class discovery)
_SESSION_ITEM = "ROADMAP queue 1, item 1c: online class discovery"


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
    """One fleet-membership/lifecycle event (JSON-round-trippable via
    ``repro_torch.api.results``): a failure, a proactive degrade, a
    restore, or a per-job consequence (migrate / shrink / strand)."""
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
    needs_reprofile: bool = False  # mid-profile migrant awaiting its re-run


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
    exactly.

    ``inventory`` (optional) enables the fault-tolerance surface: failed /
    degraded devices are tracked there and migrations target its healthy
    view.  ``straggler_adapter`` (optional ``FleetStragglerAdapter``) makes
    degrade-and-drain automatic from the mux feed's chunk cadence.  Both
    default off, in which case every code path is byte-identical to the
    controller without fault tolerance.
    """

    def __init__(self, references, budget_w: float,
                 objective="powercentric",
                 provision_quantile="p99",
                 min_confidence: float = 0.3, min_fraction: float = 0.1,
                 min_spike_samples: int = 50,
                 actuator_factory=SimActuator.for_device,
                 inventory: DeviceInventory | None = None,
                 straggler_adapter: FleetStragglerAdapter | None = None,
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
        self.straggler_adapter = straggler_adapter
        # write-ahead session store (repro_torch.store.SessionStore),
        # attached by MinosSession when configured with a store path; None =
        # no durability, every code path byte-identical to the store-less
        # controller
        self.journal = journal
        self.jobs: dict[str, FleetJob] = {}
        self.repacks = RepackTrail()
        self.events: list[FleetEvent] = []
        self._dropped = 0
        self._failed_devices: set[str] = set()

    # -- durability ------------------------------------------------------
    def _journal(self, kind: str, **data) -> None:
        """Write-ahead: durably record a mutation *before* applying it.
        No-op without an attached session store."""
        if self.journal is not None:
            self.journal.record(kind, **data)

    def _emit(self, events) -> None:
        """Append lifecycle events, journaling each as an informational
        record.  Consequence events (migrate/shrink/strand) are reproduced
        by re-running the deterministic controller logic during recovery,
        so replay skips these records — they exist for reports."""
        for ev in events:
            self._journal(kinds.EVENT, event=ev)
        self.events.extend(events)

    def _sync_store(self) -> None:
        """Let the store write its cadence snapshot now that the mutation
        the latest records describe has fully applied (a snapshot taken
        mid-mutation would lose the in-flight record on replay)."""
        if self.journal is not None:
            self.journal.flush_snapshot()

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

    def _replace_builder(self, job: FleetJob, meta=None,
                         tdp: float | None = None):
        """Swap a job's profiling state for a fresh run (migration /
        reprofile), freeing the old engine slot."""
        meta = meta if meta is not None else job.builder.meta
        tdp = job.device.effective_tdp_w if tdp is None else tdp
        self._drop_builder(job.builder)
        job.builder = self._make_builder(meta, tdp)
        return job.builder

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
        ``mesh``/``global_batch`` so a partial device loss can re-mesh
        through ``ft.plan_new_mesh``/``rescale_batch``."""
        spec = self._admit_validate(
            device, meta, chips=chips, job_id=job_id,
            profile_to_completion=profile_to_completion, devices=devices,
            mesh=mesh, global_batch=global_batch)
        self._journal_admit(spec)
        self._admit_apply(spec)
        self._sync_store()
        return spec["job_id"]

    def admit_many(self, admissions) -> list[str]:
        """Bulk admission: validate a whole batch up front (atomically — a
        bad entry rejects the batch before anything is journaled or
        applied), then journal every admit record in one coalesced store
        flush and apply them in order, claiming every engine slot with one
        bulk allocation.  ``admissions`` is an iterable of dicts with
        :meth:`admit`'s keyword arguments (``device`` and ``meta``
        required).  Returns the ``job_id``s in batch order.

        Journal bytes, job state, and placement are identical to calling
        ``admit`` once per entry; only the store-flush count changes."""
        taken: set[str] = set()
        specs = [self._admit_validate(taken=taken, **kw)
                 for kw in admissions]
        ctx = self.journal.batch() if self.journal is not None \
            else nullcontext()
        with ctx:
            for spec in specs:
                self._journal_admit(spec)
            builders = [None] * len(specs)
            if self.engine is not None:
                slots = self.engine.alloc_many(
                    (spec["meta"] for spec in specs),
                    (spec["device"].effective_tdp_w for spec in specs))
                builders = [SlotBuilder(self.engine, slot, spec["meta"])
                            for slot, spec in zip(slots, specs)]
            for spec, builder in zip(specs, builders):
                self._admit_apply(spec, builder)
        self._sync_store()
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
        if self.inventory is not None:
            for d in span:
                did = d.device_id
                if did in self.inventory \
                        and not self.inventory.is_healthy(did):
                    raise ValueError(f"cannot admit on {did!r}: device is "
                                     f"{self.inventory.health(did)}")
        if taken is not None:
            taken.add(job_id)
        return dict(job_id=job_id, device=device, meta=meta,
                    chips=int(chips), span=span,
                    profile_to_completion=bool(profile_to_completion),
                    mesh=mesh, global_batch=global_batch)

    def _journal_admit(self, spec: dict) -> None:
        if self.journal is not None:
            # the record payload (dataclasses.asdict over meta/devices) is
            # the expensive part — only build it when a store is attached
            self._journal(
                kinds.ADMIT, job_id=spec["job_id"],
                device=device_record(spec["device"]), chips=spec["chips"],
                meta=meta_record(spec["meta"]),
                profile_to_completion=spec["profile_to_completion"],
                devices=[device_record(d) for d in spec["span"]],
                mesh=mesh_record(spec["mesh"]),
                global_batch=spec["global_batch"])

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

        Telemetry from a failed device (in flight when the failure landed)
        is discarded, as is telemetry for a job that has left the fleet —
        the wire keeps no promises under churn.  With a straggler adapter
        attached, every chunk also feeds the per-device cadence monitor and
        flagged devices are degraded-and-drained automatically."""
        if self.straggler_adapter is not None:
            self.straggler_adapter.observe(fchunk)
            if self.straggler_adapter.should_check():
                self._auto_degrade()
        if fchunk.device_id in self._failed_devices:
            self._dropped += 1
            return None
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
        if job.needs_reprofile:
            # the partial trace died with the job's old device; without a
            # device tag on this path we cannot tell the stale stream from
            # the re-run, so demand an explicit restart
            raise ValueError(
                f"job {job_id!r} migrated mid-profile; restart its run via "
                f"restart_profile()/JobHandle.reprofile() before feeding")
        job.builder.ingest(chunk)
        decision = job.controller.observe(job.builder)
        if decision is None:
            return None
        self._decide(job, decision)
        if not _defer_repack:
            self._repack()
            self._sync_store()
        return decision

    def ingest_tick(self, batch) -> list[CapDecision]:
        """Advance the fleet by one mux tick — a batch of simultaneous
        ``FleetChunk``s from ``FleetTelemetryMux.ticks()`` — in one columnar
        engine pass instead of a per-job Python loop.  Returns the decisions
        that landed this tick, in chunk order.

        Outcome-equivalent to calling ``ingest`` per chunk in batch order:
        undecided jobs' chunks advance through ``BatchProfileEngine.
        ingest_batch`` (bit-identical builder state), then confidence gates
        are observed in the same chunk order, so decisions, journal records,
        and (with ``repack="decision"``) re-packs land in the identical
        sequence.  With ``repack="tick"`` all of a tick's decisions share
        one closing re-pack.  Falls back to the sequential path per chunk
        when the chunk can't batch (per-job engine, duplicate job in one
        batch, straggler cadence monitoring — which is order-sensitive)."""
        if self.straggler_adapter is not None:
            # cadence monitoring consumes chunks one at a time in wire
            # order; keep that path byte-identical
            return [d for d in (self.ingest(fc) for fc in batch)
                    if d is not None]
        defer = self.repack_mode == "tick"
        store_ctx = self.journal.batch() if self.journal is not None \
            else nullcontext()
        decisions: list[CapDecision] = []
        with store_ctx:
            # route: engine-eligible chunks batch; the rest go sequential
            rows = []               # (fchunk, job | None, batched, observe)
            seen: set[str] = set()
            slots, chunks = [], []
            jobs_get = self.jobs.get          # hoisted: this loop runs once
            failed = self._failed_devices     # per chunk at fleet scale
            eng = self.engine
            for fc in batch:
                if fc.device_id in failed:
                    self._dropped += 1
                    continue
                job = jobs_get(fc.job_id)
                if job is None:            # retired/stranded mid-stream
                    self._dropped += 1
                    continue
                eligible = (eng is not None
                            and fc.job_id not in seen
                            and getattr(job.builder, "engine", None) is eng
                            and not job.needs_reprofile
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
                            self._sync_store()
                else:
                    d = None       # decided profile-to-completion job
                if d is not None:
                    decisions.append(d)
            if defer and decisions:
                self._repack()
                self._sync_store()
        return decisions

    def finalize(self) -> FleetResult:
        """Decide any still-undecided jobs from their completed profiles,
        re-pack once more, and return the fleet outcome.  Jobs with nothing
        ingested stay undecided and are left out of the decision map rather
        than classified from an empty trace (e.g. mid-profile migrants whose
        re-run never arrived — see ``restart_profile``)."""
        pending = [j for j in self.jobs.values()
                   if j.decision is None and j.builder.n_ingested > 0]
        batched = [j for j in pending
                   if self.engine is not None
                   and getattr(j.builder, "engine", None) is self.engine]
        # engine-backed stragglers classify in one batched sweep; decisions
        # still adopt in admission order so journal replay stays verbatim
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
        self._sync_store()
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
            self._sync_store()
        return job.decision

    def restart_profile(self, job_id: str, meta=None) -> None:
        """Reset an undecided job's profiling run — the recovery step after
        a mid-profile migration, whose partial trace died with its device.
        The fresh builder normalizes by the job's *current* device frame;
        pass the re-run's ``TraceMeta`` (its sample count differs on the
        new silicon) or inherit the old one."""
        job = self.jobs[job_id]
        if job.decision is not None:
            raise ValueError(f"job {job_id!r} already decided; nothing to "
                             f"re-profile")
        meta = meta if meta is not None else job.builder.meta
        self._journal(kinds.REPROFILE, job_id=job_id, meta=meta_record(meta))
        self._replace_builder(job, meta)
        job.needs_reprofile = False
        self._sync_store()

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
        self._journal(kinds.RETIRE, job_id=job_id)
        job = self.jobs.pop(job_id)
        self._drop_builder(job.builder)
        if job.plan is not None:
            self._unpack(job.plan)
            self._repack()
        self._sync_store()
        return job

    def set_budget(self, budget_w: float) -> None:
        """Change the shared power budget; re-packs the decided jobs against
        the new ceiling (cached plans only — no re-classification)."""
        self._journal(kinds.BUDGET, budget_w=float(budget_w))
        self.budget_w = float(budget_w)
        if self._has_plans():
            self._repack()
        self._sync_store()

    # -- fault tolerance -------------------------------------------------
    def fail_device(self, device_id: str) -> list[FleetEvent]:
        """A device died: mark it failed, stop trusting its telemetry, and
        migrate every affected job to surviving healthy devices.

        Decided jobs carry their cached ``CapDecision`` selection, so the
        migration is ``PowerAwareScheduler.migrate_plan`` — a re-costing
        against the new device's effective TDP with **zero classifier
        calls** (device-portable classification makes cross-model migration
        free).  Undecided jobs restart profiling on the target device (the
        failed device's partial trace is unfinishable).  Multi-chip jobs
        that only lost part of their span shrink via ``ft.plan_new_mesh``/
        ``rescale_batch`` instead.  Jobs with nowhere to go are stranded:
        they leave the packing (drawing no budget) until capacity returns.
        Ends with a single re-pack of the survivors.

        Returns this failure's events (also appended to ``self.events``)."""
        inv = self._require_inventory("fail_device")
        inv.get(device_id)                   # KeyError on unknown device
        self._journal(kinds.FAIL, device=device_id)
        inv.mark_failed(device_id)
        self._failed_devices.add(device_id)
        events = self._drain_device(device_id, FleetEvent("fail", device_id))
        self._sync_store()
        return events

    def degrade_device(self, device_id: str) -> list[FleetEvent]:
        """A device is straggling: mark it degraded and proactively migrate
        its *decided* jobs to healthy devices (zero classifier calls, as in
        ``fail_device``).  Undecided jobs keep profiling — the power frame
        of a slow-but-alive chip is still valid — and migrate the moment
        they decide.  No-op if the device is already non-healthy."""
        inv = self._require_inventory("degrade_device")
        if inv.health(device_id) != HEALTHY:
            return []
        self._journal(kinds.DEGRADE, device=device_id)
        inv.mark_degraded(device_id)
        events = self._drain_device(device_id,
                                    FleetEvent("degrade", device_id),
                                    decided_only=True)
        self._sync_store()
        return events

    def restore_device(self, device_id: str) -> list[FleetEvent]:
        """The device is back: return it to the healthy placement pool and
        re-place any stranded jobs — capacity returned, so jobs that had
        nowhere to go re-plan from their cached decisions (zero classifier
        calls) and mid-profile strandees re-bind for their re-run.  Healthy
        placements stay where they are (migration is one-way)."""
        inv = self._require_inventory("restore_device")
        prior = inv.health(device_id)
        self._journal(kinds.RESTORE, device=device_id)
        inv.restore(device_id)
        self._failed_devices.discard(device_id)
        events = [FleetEvent("restore", device_id, detail=f"was {prior}")]
        replaced = False
        for job in self.jobs.values():
            health = inv.health(job.device.device_id)
            if job.decision is not None and job.plan is None:
                # stranded (by a fail, or a degrade drain that found no
                # target): capacity is back, put it somewhere
                if health == HEALTHY:
                    # its own device is back
                    self._set_plan(job, self._plan_for(job))
                    if job.actuator is not None:
                        job.actuator.set_cap(job.decision.cap)
                    events.append(FleetEvent(
                        "migrate", job.device.device_id, job_id=job.job_id,
                        to_device_id=job.device.device_id,
                        detail="re-placed after restore"))
                else:
                    events.append(self._migrate_job(job,
                                                    job.device.device_id))
                replaced = True
            elif job.decision is None and health == FAILED:
                # mid-profile resident of a dead device: re-bind it so its
                # re-run lands on live silicon
                events.append(self._migrate_job(job, job.device.device_id))
        self._emit(events)
        if replaced:
            self._repack()
        self._sync_store()
        return events

    def device_health(self) -> dict[str, str]:
        """device_id -> health for the attached inventory ({} if none)."""
        return {} if self.inventory is None \
            else dict(self.inventory.device_health)

    def _require_inventory(self, op: str) -> DeviceInventory:
        if self.inventory is None:
            raise ValueError(f"{op} needs an inventory of candidate devices;"
                             f" construct FleetCapController(..., "
                             f"inventory=...)")
        return self.inventory

    def _auto_degrade(self) -> None:
        """Degrade-and-drain devices the straggler adapter flags (only
        meaningful with an inventory; flagged devices without one are left
        to the caller via ``straggler_adapter.degraded()``)."""
        if self.inventory is None:
            return
        for device_id in self.straggler_adapter.degraded():
            if device_id in self.inventory \
                    and self.inventory.health(device_id) == HEALTHY:
                self.degrade_device(device_id)

    def _drain_device(self, device_id: str, cause: FleetEvent,
                      decided_only: bool = False) -> list[FleetEvent]:
        events = [cause]
        affected = [j for j in self.jobs.values()
                    if device_id in {d.device_id for d in j.devices}
                    and (j.decision is not None or not decided_only)]
        for job in affected:
            if len(job.devices) > 1:
                events.append(self._shrink_job(job, device_id))
            else:
                events.append(self._migrate_job(job, device_id))
        self._emit(events)
        if self._has_plans() or self.repacks:
            self._repack()
        return events

    def _placement_load_w(self) -> dict[str, float]:
        """Planned watts currently bound to each device (for the
        deterministic least-loaded migration target choice)."""
        load: dict[str, float] = {}
        for j in self.jobs.values():
            if j.plan is not None:
                load[j.device.device_id] = load.get(j.device.device_id, 0.0) \
                    + j.plan.predicted_p90_w * j.plan.chips
        return load

    def _pick_target(self, exclude: set[str]) -> DeviceInstance | None:
        """Least-loaded healthy device (ties broken by device_id) outside
        ``exclude`` — deterministic, so a replayed failure schedule yields
        a byte-identical recovery."""
        candidates = [d for d in (self.inventory.healthy
                                  if self.inventory is not None else [])
                      if d.device_id not in exclude]
        if not candidates:
            return None
        load = self._placement_load_w()
        return min(candidates,
                   key=lambda d: (load.get(d.device_id, 0.0), d.device_id))

    def _rebind(self, job: FleetJob, device: DeviceInstance) -> None:
        """Point a job's actuation + decision tagging at a new device and
        re-assert its cap there (decided jobs only)."""
        job.device = device
        job.controller.device_id = device.device_id
        job.actuator = self.actuator_factory(device) \
            if self.actuator_factory is not None else None
        job.controller.actuator = job.actuator
        if job.decision is not None and job.actuator is not None:
            job.actuator.set_cap(job.decision.cap)

    def _migrate_job(self, job: FleetJob, from_device_id: str) -> FleetEvent:
        target = self._pick_target(exclude={from_device_id})
        if target is None:
            # nowhere to go: the job leaves the packing (draws no budget)
            # but keeps its cached decision for when capacity returns
            # (restore_device re-places strandees)
            stranded_plan = job.plan
            self._set_plan(job, None)
            if job.decision is None:
                # the partial trace died with the device: drop it so a
                # later finalize cannot classify from the dead frame
                self._replace_builder(job)
                job.needs_reprofile = True
            return FleetEvent(
                "strand", from_device_id, job_id=job.job_id,
                detail="no healthy device available" if stranded_plan
                else "no healthy device available; profiling aborted")
        detail = ""
        if job.decision is not None:
            # the free path: re-cost the cached selection on the new device
            self._set_plan(job, self.scheduler.migrate_plan(
                job.plan or self._plan_for(job), target))
        else:
            # mid-profile: the partial trace died with the device — restart
            # the profiling run in the new device's normalization frame
            self._replace_builder(job, tdp=target.effective_tdp_w)
            job.needs_reprofile = True
            detail = "reprofile"
        self._rebind(job, target)
        job.devices = (target,)
        return FleetEvent("migrate", from_device_id, job_id=job.job_id,
                          to_device_id=target.device_id, detail=detail)

    def _shrink_job(self, job: FleetJob, lost_device_id: str) -> FleetEvent:
        """Partial span loss for a multi-chip job: keep the survivors and
        re-mesh down through ``ft.plan_new_mesh`` (model extent preserved,
        data extent the largest power of two that fits), rescaling the
        global batch to hold the per-device batch constant."""
        surviving = tuple(d for d in job.devices
                          if d.device_id != lost_device_id)
        chips_per_dev = job.chips // len(job.devices)
        surviving_chips = chips_per_dev * len(surviving)
        mesh = job.mesh or MeshConfig(shape=(job.chips, 1),
                                      axis_names=("data", "model"))
        try:
            eplan = plan_new_mesh(mesh, surviving_chips)
        except RuntimeError:
            # survivors can't hold the model extent: whole-job migration
            return self._migrate_job(job, lost_device_id)
        old_chips = job.chips
        job.mesh = eplan.new
        job.chips = eplan.new.num_devices
        job.devices = surviving
        if job.global_batch is not None:
            job.global_batch = rescale_batch(job.global_batch, eplan)
        if job.device.device_id == lost_device_id:
            self._rebind(job, surviving[0])
            if job.decision is None:
                # the profiling frame was the lost primary: its partial
                # trace is unfinishable — restart on the new primary
                self._replace_builder(job)
                job.needs_reprofile = True
        if job.decision is not None:
            self._set_plan(job, self.scheduler.migrate_plan(
                job.plan or self._plan_for(job), job.device,
                chips=job.chips))
        return FleetEvent(
            "shrink", lost_device_id, job_id=job.job_id,
            to_device_id=job.device.device_id,
            detail=f"chips {old_chips}->{job.chips} "
                   f"(lost={eplan.lost_devices} idle={eplan.idle_devices})")

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
        re-classify.  A job that decides while part of its span sits on a
        non-healthy device (degraded mid-profile) drains immediately:
        single-device jobs migrate, multi-chip jobs shrink the bad member
        away — the deferred half of ``degrade_device``'s contract.

        The decision record is journaled *with* its plan before either is
        adopted, so crash recovery re-adopts both verbatim (``plan`` is the
        replay path's verbatim hand-back)."""
        if plan is None:
            plan = self._plan_for(job, selection=decision.selection)
        self._journal(kinds.DECISION, job_id=job.job_id, decision=decision,
                      plan=plan)
        job.decision = decision
        self._set_plan(job, plan)
        if self.inventory is None:
            return
        for dev in list(job.devices):
            did = dev.device_id
            if dev not in job.devices:         # shrunk away by a prior turn
                continue
            if did in self.inventory \
                    and self.inventory.health(did) != HEALTHY:
                if len(job.devices) > 1:
                    self._emit([self._shrink_job(job, did)])
                else:
                    self._emit([self._migrate_job(job, did)])

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
