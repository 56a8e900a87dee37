"""``MinosSession``: the unified ingestion-to-decision facade.

One object owns the whole Minos mechanism — the ``ReferenceLibrary`` (warm
classifier), the device inventory, the shared power budget, and the three
policy axes (objective / actuator / provisioning quantile, all resolvable
by registry name) — and exposes the full job lifecycle:

    session = MinosSession(lib, inventory=inv, budget_w=50_000.0)
    job = session.submit(stream, device=inv[0], chips=256)   # -> JobHandle
    job.feed(chunks)            # incremental telemetry; early CapDecision
    job.decision()              # the (possibly finalized) cap decision
    job.plan()                  # its cached power reservation
    job.retire()                # release budget; repack WITHOUT reclassify
    report = session.run()      # drain attached streams -> SessionReport

Decisions are byte-identical to the direct ``OnlineCapController`` /
``FleetCapController`` paths (pinned in ``tests/test_api.py``): the facade
routes every chunk through exactly the same per-job builder + controller
machinery, device-frame normalization included.  Jobs may arrive *and
retire* at any point; retirement and budget changes re-pack from cached
``JobPlan``s and never re-classify.

``MinosSession.from_config(dict | json)`` constructs a session declaratively
— library path, device counts + variability, budget, and the three policy
names — so a deployment is one JSON document away from a running session.

The port's session runs every job's profiling state, and the classifier, on
``device`` (default: the card); ``MinosSession.resume`` reads stores that
either package wrote, discovery records included.
"""
from __future__ import annotations

import difflib
import json
import math
import os
import warnings
from contextlib import nullcontext

from repro_torch.api.registry import ACTUATORS, OBJECTIVES, QUANTILES
from repro_torch.core.algorithm1 import resolve_objective
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.fleet.controller import FleetCapController, FleetEvent, \
    FleetJob, RepackTrail
from repro_torch.fleet.inventory import DEGRADED, FAILED, DeviceInstance, \
    DeviceInventory, VariabilityModel
from repro_torch.fleet.mux import FleetTelemetryMux
from repro_torch.fleet.records import device_from_record, device_record, \
    mesh_from_record, mesh_record, meta_from_record, meta_record
from repro_torch.ft.fleetwatch import FleetStragglerAdapter
from repro_torch.ft.heartbeat import StragglerMonitor
from repro_torch.pipeline.builder import PartialProfile
from repro_torch.pipeline.library import ReferenceLibrary
from repro_torch.pipeline.online import CapDecision
from repro_torch.sched.dvfs import FrequencyActuator
from repro_torch.sched.power_sched import JobPlan
from repro_torch.store import SessionStore, StoreError, kinds
from repro_torch.telemetry.kernel_stream import KernelStream
from repro_torch.telemetry.simulator import TelemetryChunk, TraceMeta, \
    stream_telemetry

from repro_torch.api.results import SessionReport, from_dict, to_dict

_GATE_KEYS = ("min_confidence", "min_fraction", "min_spike_samples")
_STRAGGLER_KEYS = ("window", "k", "min_samples")
_CONFIG_KEYS = frozenset({"library", "devices", "variability", "seed",
                          "objective", "actuator", "quantile", "budget_w",
                          "budget_fraction_of_nameplate", "gates",
                          "stragglers", "store", "discovery"})


class JobHandle:
    """Live handle on one submitted job (create via ``MinosSession.submit``).

    The handle stays valid after retirement: ``decision()``/``plan()`` keep
    returning the cached artifacts; only feeding is rejected."""

    def __init__(self, session: "MinosSession", job: FleetJob,
                 meta: TraceMeta, chunks=None):
        self._session = session
        self._job = job
        self.meta = meta
        self._chunks = chunks        # attached telemetry iterator (optional)
        self.retired = False

    # -- introspection ---------------------------------------------------
    @property
    def job_id(self) -> str:
        return self._job.job_id

    @property
    def device(self) -> DeviceInstance:
        return self._job.device

    @property
    def decided(self) -> bool:
        return self._job.decision is not None

    @property
    def actuator(self):
        """The job's DVFS actuator (plugin-chosen; ``None`` = no actuation)."""
        return self._job.actuator

    @property
    def fraction(self) -> float:
        """Fraction of the expected trace ingested so far."""
        return self._job.builder.fraction

    def snapshot(self) -> PartialProfile:
        """A valid partial profile over everything fed so far (pure)."""
        return self._job.builder.snapshot()

    def profile(self) -> PartialProfile:
        """Finalize the job's builder and return the completed profile.
        After this the job accepts no more telemetry."""
        return self._job.builder.finalize()

    # -- lifecycle -------------------------------------------------------
    def feed(self, chunks) -> CapDecision | None:
        """Ingest telemetry: one ``TelemetryChunk`` or an iterable of them
        (in stream order).  Returns the job's ``CapDecision`` the moment a
        chunk tips its confidence gate — which also re-packs the session —
        else ``None``.  Chunks after a decision are dropped (or kept, with
        ``profile_to_completion=True`` at submit)."""
        self._check_live()
        if isinstance(chunks, TelemetryChunk):
            chunks = (chunks,)
        decision = None
        for chunk in chunks:
            d = self._session._fleet.ingest_chunk(self.job_id, chunk)
            decision = decision or d
        return decision

    def run(self, stop_early: bool = True) -> CapDecision:
        """Pump the attached telemetry stream: with ``stop_early`` (default)
        the pull stops at the first confident decision — the paper's
        profiling-cost saving — else the whole stream is consumed.  Falls
        back to the finalize decision at stream end."""
        self._check_live()
        if self._chunks is None:
            raise ValueError(f"job {self.job_id!r} has no attached stream; "
                             f"feed() it chunks instead")
        chunks, self._chunks = self._chunks, None
        for chunk in chunks:
            decision = self.feed(chunk)
            if decision is not None and stop_early:
                return decision
        return self.decision()

    def decision(self, finalize: bool = True) -> CapDecision | None:
        """The job's cap decision.  If none has fired yet and ``finalize``
        is set (default), decide now from everything ingested so far — the
        batch-equivalent decision; with ``finalize=False`` returns ``None``
        until a decision lands.  A handle retired before any decision has
        nothing cached and returns ``None``."""
        if self._job.decision is not None or not finalize or self.retired:
            return self._job.decision
        return self._session._fleet.finalize_job(self.job_id)

    def plan(self) -> JobPlan | None:
        """The job's cached power reservation (built once, from the
        decision's Algorithm 1 selection); ``None`` before a decision."""
        return self._job.plan

    def reprofile(self, source, freq: float = 1.0, **telemetry_kw) -> None:
        """Restart this job's profiling run — the recovery step after a
        mid-profile device failure migrated it (its partial trace died with
        the old device).  ``source`` is a ``KernelStream`` (profiled on the
        job's *current* device), a ``(meta, chunks)`` pair, or a bare
        ``TraceMeta``; fresh chunks attach to the handle for ``run()`` /
        the session drain.  Only undecided jobs can re-profile."""
        self._check_live()
        if isinstance(source, KernelStream):
            meta, chunks = stream_telemetry(
                source, freq, self.device.power_model(),
                device_id=self.device.device_id, **telemetry_kw)
        elif isinstance(source, TraceMeta):
            meta, chunks = source, None
        elif isinstance(source, tuple) and len(source) == 2 \
                and isinstance(source[0], TraceMeta):
            meta, chunks = source
        else:
            raise TypeError(f"reprofile() takes a KernelStream, a TraceMeta,"
                            f" or a (meta, chunks) pair, got "
                            f"{type(source).__name__}")
        self._session._fleet.restart_profile(self.job_id, meta)
        self.meta = meta
        self._chunks = chunks

    def retire(self) -> JobPlan | None:
        """Retire this job (see ``MinosSession.retire``)."""
        return self._session.retire(self.job_id)

    def _take_chunks(self):
        """Detach and return the pending stream (None if already consumed)."""
        chunks, self._chunks = self._chunks, None
        return chunks

    def _check_live(self) -> None:
        if self.retired:
            raise ValueError(f"job {self.job_id!r} is retired")


class MinosSession:
    """The session facade over the streaming pipeline + fleet layers."""

    def __init__(self, references, *, inventory: DeviceInventory | None = None,
                 budget_w: float = math.inf, objective="powercentric",
                 actuator="sim", quantile="p99",
                 min_confidence: float = 0.3, min_fraction: float = 0.1,
                 min_spike_samples: int = 50, stragglers=None, store=None,
                 discovery=None, device=DEFAULT_DEVICE):
        """``references`` is a ``ReferenceLibrary`` (preferred: warm
        classifier), a ``MinosClassifier``, or a profile list.  ``objective``
        / ``actuator`` / ``quantile`` accept registry names (see
        ``repro_torch.api.registry``) or policy objects; gate thresholds
        match the direct ``OnlineCapController`` defaults.

        ``stragglers`` opts into proactive degrade-and-drain: pass a
        ``ft.StragglerMonitor`` (or a prebuilt ``FleetStragglerAdapter``, or
        ``True`` for monitor defaults) and the fleet flags devices whose
        telemetry cadence falls behind, migrating their decided jobs to
        healthy silicon without a single re-classification.

        ``store`` opts into durability: pass a directory path (or a
        prebuilt ``repro_torch.store.SessionStore``) and every admit, decision,
        plan, retirement, budget change, and device-health transition is
        journaled write-ahead — ``MinosSession.resume(path)`` reconstructs
        the session after a crash with zero classifier calls.  Without a
        store every code path is byte-identical to the store-less session.

        ``discovery`` opts into online class discovery: pass ``True``
        (defaults), a knobs dict (see ``repro_torch.discovery.
        DISCOVERY_KEYS``), or a prebuilt ``DiscoveryController`` — finalized
        low-margin decisions then quarantine their profiles, periodic
        re-clustering mints candidate classes, and shadow-vetted promotions
        publish a new library version the fleet adopts atomically between
        ticks (``references`` must be a ``ReferenceLibrary``).  Set
        ``session.discovery.profiler`` to a full-profile callable to enable
        promotion.  Without a discovery key every code path is
        byte-identical to the discovery-less session.

        ``device`` is where the classifier and every job's profiling state
        live (default: the card; pass ``"cpu"`` to run on the host).  A
        ``ReferenceLibrary`` or ``MinosClassifier`` passed as
        ``references`` must already live there."""
        self.device = resolve_device(device)
        self.library = references        # whatever was handed in (may be lib)
        self.inventory = inventory
        self._objective = self._resolve_objective(objective)
        self._quantile = QUANTILES.get(quantile) \
            if isinstance(quantile, str) else quantile
        self._fleet = FleetCapController(
            references, budget_w=budget_w, objective=self._objective,
            provision_quantile=self._quantile,
            min_confidence=min_confidence, min_fraction=min_fraction,
            min_spike_samples=min_spike_samples,
            actuator_factory=self._resolve_actuator(actuator),
            inventory=inventory,
            straggler_adapter=self._resolve_stragglers(stragglers),
            device=self.device)
        self._handles: dict[str, JobHandle] = {}
        self._retired: dict[str, CapDecision | None] = {}
        self._rr = 0                     # round-robin cursor over inventory
        self._default_device: DeviceInstance | None = None
        self._actuator_name = actuator if isinstance(actuator, str) else None
        self._library_path = None        # set when built via from_config
        self._store: SessionStore | None = None
        self._discovery = self._init_discovery(discovery, references)
        if self._discovery is not None:
            self._fleet.set_discovery(self._discovery)
        if store is not None:
            self._init_store(store)

    # -- plugin resolution ----------------------------------------------
    @staticmethod
    def _resolve_objective(objective):
        if isinstance(objective, str):
            objective = OBJECTIVES.get(objective)
        return resolve_objective(objective)

    @staticmethod
    def _resolve_actuator(actuator):
        if actuator is None:
            return None
        if isinstance(actuator, str):
            return ACTUATORS.get(actuator)
        if isinstance(actuator, FrequencyActuator):
            return lambda device=None: actuator   # one shared instance
        if callable(actuator):
            return actuator
        raise ValueError(f"actuator must be a registry name, factory, or "
                         f"FrequencyActuator, got {actuator!r}")

    @staticmethod
    def _resolve_stragglers(stragglers):
        if stragglers is None or stragglers is False:
            return None
        if stragglers is True:
            return FleetStragglerAdapter()
        if isinstance(stragglers, FleetStragglerAdapter):
            return stragglers
        if isinstance(stragglers, StragglerMonitor):
            return FleetStragglerAdapter(stragglers)
        raise ValueError(f"stragglers must be True, a StragglerMonitor, or "
                         f"a FleetStragglerAdapter, got {stragglers!r}")

    def _init_discovery(self, discovery, references):
        """Resolve the ``discovery`` option into a ``DiscoveryController``
        (or ``None`` — the inert default: no discovery attribute is touched
        anywhere on the hot paths)."""
        if discovery is None or discovery is False:
            return None
        from repro_torch.discovery import DISCOVERY_KEYS, DiscoveryController
        if isinstance(discovery, DiscoveryController):
            return discovery
        if discovery is True:
            knobs = {}
        elif isinstance(discovery, dict):
            bad = set(discovery) - set(DISCOVERY_KEYS)
            if bad:
                raise ValueError(f"unknown discovery keys {sorted(bad)}; "
                                 f"recognized: {list(DISCOVERY_KEYS)}")
            knobs = dict(discovery)
        else:
            raise ValueError(f"discovery must be True, a knobs dict, or a "
                             f"DiscoveryController, got {discovery!r}")
        if not isinstance(references, ReferenceLibrary):
            raise ValueError(
                "discovery needs the session references to be a "
                "ReferenceLibrary (promotions version its membership); got "
                f"{type(references).__name__}")
        return DiscoveryController(references, objective=self._objective,
                                   **knobs)

    # -- declarative construction ----------------------------------------
    @classmethod
    def from_config(cls, config, references=None,
                    device=DEFAULT_DEVICE) -> "MinosSession":
        """Build a session from a config dict, a JSON string, or a path to a
        JSON file.  Recognized keys (all optional unless noted):

          * ``library``       — reference-store directory (required unless a
            ``references`` object is passed in);
          * ``devices``       — chip-model -> count (or a bare int of
            nominal v5e chips); ``variability`` — sigma dict (``{}`` =
            published defaults), ``"none"``/omitted = nominal chips;
            ``seed`` — inventory RNG seed;
          * ``objective`` / ``actuator`` / ``quantile`` — registry names;
          * ``budget_w`` — shared power budget in watts, or
            ``budget_fraction_of_nameplate`` — fraction of the inventory's
            total per-device nameplate TDP (requires ``devices``);
          * ``gates`` — ``min_confidence`` / ``min_fraction`` /
            ``min_spike_samples`` overrides;
          * ``stragglers`` — ``true`` (monitor defaults) or a
            ``window``/``k``/``min_samples`` dict: proactive
            degrade-and-drain of devices whose telemetry cadence lags;
          * ``store`` — durable-session directory (must be fresh): every
            mutation is journaled write-ahead so a crashed session can be
            reconstructed with ``MinosSession.resume(path)``;
          * ``discovery`` — ``true`` (defaults) or a knobs dict
            (``quarantine_below`` / ``min_cluster`` / ``cluster_distance``
            / ``promote_agreement`` / ``recluster_every`` / ``capacity`` /
            ``min_confidence_gain`` / ``bin_size``): online class discovery
            — low-margin decisions quarantine, re-clustering mints
            candidates, shadow-vetted promotions publish new library
            versions (requires a ``ReferenceLibrary``; attach a profiler
            via ``session.discovery.profiler`` to enable promotion).

        ``device`` (a keyword, not a config key) is where the session runs;
        the library is loaded onto it."""
        if isinstance(config, (str, os.PathLike)):
            text = str(config)
            if not text.lstrip().startswith("{"):
                with open(text) as f:
                    text = f.read()
            config = json.loads(text)
        if not isinstance(config, dict):
            raise ValueError(f"config must be a dict, JSON text, or a path, "
                             f"got {type(config).__name__}")
        unknown = set(config) - _CONFIG_KEYS
        if unknown:
            labels = []
            for key in sorted(unknown):
                close = difflib.get_close_matches(key, _CONFIG_KEYS, n=1)
                labels.append(f"{key!r} (did you mean {close[0]!r}?)"
                              if close else repr(key))
            raise ValueError(f"unknown config keys {', '.join(labels)}; "
                             f"recognized: {sorted(_CONFIG_KEYS)}")

        if references is None:
            if "library" not in config:
                raise ValueError("config needs a 'library' store path "
                                 "(or pass a references object)")
            references = ReferenceLibrary.load(config["library"],
                                               device=device)

        inventory = None
        if "devices" in config:
            var = config.get("variability")
            if var is None or var == "none":
                var = VariabilityModel.none()
            elif isinstance(var, dict):
                var = VariabilityModel(**var)
            elif not isinstance(var, VariabilityModel):
                raise ValueError(f"variability must be a sigma dict or "
                                 f"'none', got {var!r}")
            inventory = DeviceInventory.generate(
                config["devices"], var, seed=int(config.get("seed", 0)))

        if "budget_w" in config and "budget_fraction_of_nameplate" in config:
            raise ValueError("give budget_w or budget_fraction_of_nameplate,"
                             " not both")
        budget_w = math.inf
        if "budget_w" in config:
            budget_w = float(config["budget_w"])
        elif "budget_fraction_of_nameplate" in config:
            if inventory is None:
                raise ValueError("budget_fraction_of_nameplate needs "
                                 "'devices'")
            budget_w = float(config["budget_fraction_of_nameplate"]) \
                * inventory.nameplate_w

        gates = dict(config.get("gates", {}))
        bad = set(gates) - set(_GATE_KEYS)
        if bad:
            raise ValueError(f"unknown gate keys {sorted(bad)}; "
                             f"recognized: {list(_GATE_KEYS)}")

        stragglers = config.get("stragglers")
        if isinstance(stragglers, dict):
            bad = set(stragglers) - set(_STRAGGLER_KEYS)
            if bad:
                raise ValueError(f"unknown straggler keys {sorted(bad)}; "
                                 f"recognized: {list(_STRAGGLER_KEYS)}")
            stragglers = StragglerMonitor(**stragglers)
        elif stragglers not in (None, True, False):
            raise ValueError(f"stragglers must be true or a monitor-params "
                             f"dict, got {stragglers!r}")
        session = cls(references, inventory=inventory, budget_w=budget_w,
                      objective=config.get("objective", "powercentric"),
                      actuator=config.get("actuator", "sim"),
                      quantile=config.get("quantile", "p99"),
                      stragglers=stragglers,
                      discovery=config.get("discovery"), device=device,
                      **gates)
        if "library" in config:
            session._library_path = str(config["library"])
        if "store" in config:
            session._init_store(config["store"])
        return session

    # -- durability ------------------------------------------------------
    @classmethod
    def resume(cls, path, references=None, fsync: bool = False,
               device=DEFAULT_DEVICE) -> "MinosSession":
        """Reconstruct a crashed session from its store directory.

        Loads the latest intact snapshot and replays the journal tail: every
        cached ``CapDecision``/``JobPlan`` and device-health transition is
        re-adopted verbatim — **zero classifier calls**.  Torn journal tails
        are truncated with a warning; a corrupt latest snapshot falls back
        to its predecessor (longer replay).  Jobs that were still profiling
        when the process died lost their in-flight telemetry (chunks are
        not journaled) and come back flagged ``needs_reprofile`` — restart
        them via ``JobHandle.reprofile``.

        ``references`` is only needed when the original session was built
        around an in-memory reference library; sessions created through
        ``from_config({"library": ...})`` reload it from the recorded path.

        Stores written by the reference package resume here too: the
        journal, snapshot and record formats are the same, discovery's
        quarantine, promotion and rollback records included.  A promoted
        library version is re-adopted from its records (zero classifier
        calls), so new jobs classify against it as they did before.

        Raises ``repro_torch.store.NoStoreError`` when ``path`` holds no
        store at all, ``repro_torch.store.StoreError`` when a store exists
        but cannot be reconstructed."""
        store = SessionStore.open_existing(str(path), encode=to_dict,
                                           fsync=fsync)
        opened = store.open_record()
        if opened is None or opened.kind != kinds.OPEN:
            store.close()
            kind = "no" if opened is None else repr(opened.kind)
            raise StoreError(
                f"session store at {str(path)!r} is corrupt: the journal "
                f"begins with {kind} record instead of the "
                f"session 'open' record, so the session's construction "
                f"facts are lost and it cannot be reconstructed.")
        cfg = opened.data
        if references is None:
            if cfg.get("library") is None:
                store.close()
                raise ValueError(
                    "this store's session was built from an in-memory "
                    "reference library (no 'library' path was recorded); "
                    "pass the references object to resume()")
            references = ReferenceLibrary.load(cfg["library"], device=device)
        inventory = None
        if cfg.get("devices"):
            inventory = DeviceInventory(
                [device_from_record(d) for d in cfg["devices"]])
        session = cls(
            references, inventory=inventory,
            budget_w=from_dict(cfg.get("budget_w", math.inf)),
            objective=cfg.get("objective", "powercentric"),
            actuator=cfg.get("actuator") or "sim",
            quantile=cfg.get("quantile", "p99"),
            stragglers=cls._stragglers_from_record(cfg.get("stragglers")),
            discovery=cfg.get("discovery"), device=device,
            **(cfg.get("gates") or {}))
        session._library_path = cfg.get("library")
        state, snap_seq = store.load_snapshot()
        if state is not None:
            session._restore_state(state)
        for rec in store.records(after_seq=snap_seq):
            session._apply_record(rec)
        for job in session._fleet.jobs.values():
            if job.decision is None:
                # the in-flight partial trace died with the process:
                # demand a fresh profiling run (migration semantics)
                session._fleet._replace_builder(job)
                job.needs_reprofile = True
            elif job.actuator is not None and job.plan is not None:
                job.actuator.set_cap(job.decision.cap)
        fleet = session._fleet
        if not fleet.repacks \
                and any(j.plan is not None for j in fleet.jobs.values()):
            fleet._repack()
        d = session._discovery
        if d is not None and d.version > 1:
            # re-adopt the promoted library version verbatim: a fresh warm
            # classifier from the replayed membership — pure spike-matrix
            # adoption, zero classifier queries (replayed decisions were
            # re-adopted from the journal, never re-derived)
            fleet.adopt_classifier(d.library)
        session._attach_store(store)
        store.record(kinds.RESUME, last_seq=store.journal.last_seq,
                     snapshot_seq=snap_seq)
        store.flush_snapshot(force=True)
        return session

    @property
    def store(self) -> SessionStore | None:
        """The attached durable session store (``None`` = not durable)."""
        return self._store

    def close(self) -> None:
        """Flush a final snapshot and release the store's file handles (a
        no-op for store-less sessions).  The session object stays usable,
        but further mutations are no longer journaled."""
        if self._store is not None:
            self._store.flush_snapshot(force=True)
            self._store.close()
            self._store = None
            self._fleet.journal = None

    def _init_store(self, store) -> None:
        """Attach a FRESH store and durably pin the session's construction
        facts as its ``open`` record."""
        if not isinstance(store, SessionStore):
            store = SessionStore.create(str(store), encode=to_dict)
        if store.journal.last_seq > 0 or store.recovered_records:
            path = store.path
            store.close()
            raise ValueError(
                f"store at {path!r} already holds a session journal; "
                f"continue it with MinosSession.resume({path!r}) or point "
                f"'store' at a fresh directory")
        self._attach_store(store)
        store.record(kinds.OPEN, **self._open_record())

    def _attach_store(self, store: SessionStore) -> None:
        self._store = store
        store.encode = to_dict           # session payloads are typed results
        store.capture = self._capture_state
        self._fleet.journal = store

    def _open_record(self) -> dict:
        """The construction facts ``resume`` rebuilds the session from.
        Policies are recorded by registry name — custom objective/actuator/
        quantile *objects* are not serializable, so resume falls back to
        the defaults for any axis that was not name-resolved."""
        rec = {
            "objective": self.objective,
            "actuator": self._actuator_name,
            "quantile": self._quantile_name(),
            "budget_w": self._fleet.budget_w,
            "gates": dict(self._fleet._gates),
            "devices": [device_record(d) for d in self.inventory]
                       if self.inventory is not None else None,
            "stragglers": self._straggler_record(
                self._fleet.straggler_adapter),
            "library": self._library_path,
        }
        if self._discovery is not None:
            # key present only when enabled: discovery-less stores keep
            # their open-record bytes (inert-by-default)
            rec["discovery"] = self._discovery.config_record()
        return rec

    def _quantile_name(self):
        q = self._quantile
        return q if isinstance(q, str) or q is None \
            else getattr(q, "name", None)

    @staticmethod
    def _straggler_record(adapter) -> dict | None:
        if adapter is None:
            return None
        monitor = adapter.monitor
        return {"window": monitor.window, "k": monitor.k,
                "min_samples": monitor.min_samples,
                "check_every": adapter.check_every}

    @staticmethod
    def _stragglers_from_record(rec):
        if not rec:
            return None
        return FleetStragglerAdapter(
            StragglerMonitor(window=rec["window"], k=rec["k"],
                             min_samples=rec["min_samples"]),
            check_every=rec.get("check_every", 8))

    def _capture_state(self) -> dict:
        """The full JSON-ready session state for one snapshot: restoring it
        and replaying the journal records past its sequence number is
        equivalent to replaying the whole journal."""
        fleet = self._fleet
        jobs = []
        for job in fleet.jobs.values():
            jobs.append({
                "job_id": job.job_id,
                "device": device_record(job.device),
                "chips": job.chips,
                "meta": meta_record(job.builder.meta),
                "profile_to_completion": job.profile_to_completion,
                "devices": [device_record(d) for d in job.devices],
                "mesh": mesh_record(job.mesh),
                "global_batch": job.global_batch,
                "decision": to_dict(job.decision)
                            if job.decision is not None else None,
                "plan": to_dict(job.plan) if job.plan is not None else None,
                "needs_reprofile": job.needs_reprofile,
            })
        state = {
            "budget_w": to_dict(fleet.budget_w),
            "jobs": jobs,
            "retired": {job_id: to_dict(d) if d is not None else None
                        for job_id, d in self._retired.items()},
            "events": [to_dict(e) for e in fleet.events],
            "device_health": fleet.device_health(),
            "failed_devices": sorted(fleet._failed_devices),
            "repacks": len(fleet.repacks),
            "schedule": to_dict(fleet.repacks[-1]) if fleet.repacks else None,
            "dropped": fleet._dropped,
            "rr": self._rr,
        }
        if self._discovery is not None:
            # key present only when enabled: discovery-less snapshots keep
            # their bytes (inert-by-default)
            state["discovery"] = self._discovery.state_record()
        return state

    def _restore_state(self, state: dict) -> None:
        """Materialize a snapshot: jobs are re-admitted with their recorded
        decisions/plans adopted verbatim (never re-derived), then health is
        applied directly — the consequences a live ``fail_device`` would
        trigger are already part of the snapshot, so no drain logic runs."""
        fleet = self._fleet
        for rec in state["jobs"]:
            self._replay_admit(rec)
            job = fleet.jobs[rec["job_id"]]
            if rec["decision"] is not None:
                job.decision = from_dict(rec["decision"])
            if rec["plan"] is not None:
                # through _set_plan so the incremental packer adopts the
                # restored plan population too
                fleet._set_plan(job, from_dict(rec["plan"]))
            job.needs_reprofile = bool(rec["needs_reprofile"])
        if self.inventory is not None:
            for device_id, health in state["device_health"].items():
                if health == FAILED:
                    self.inventory.mark_failed(device_id)
                elif health == DEGRADED:
                    self.inventory.mark_degraded(device_id)
        fleet._failed_devices = set(state["failed_devices"])
        fleet.budget_w = from_dict(state["budget_w"])
        fleet.events = [from_dict(e) for e in state["events"]]
        fleet._dropped = int(state["dropped"])
        self._rr = int(state["rr"])
        self._retired = {job_id: from_dict(d) if d is not None else None
                         for job_id, d in state["retired"].items()}
        if state["schedule"] is not None:
            # only len() and [-1] are ever observed, so padding with the
            # final schedule preserves both without storing the whole trail
            fleet.repacks = RepackTrail([from_dict(state["schedule"])]
                                        * max(int(state["repacks"]), 1))
        if self._discovery is not None and state.get("discovery") is not None:
            self._discovery.restore(state["discovery"])

    def _replay_admit(self, rec: dict) -> None:
        device = device_from_record(rec["device"])
        meta = meta_from_record(rec["meta"])
        self._fleet.admit(
            device, meta, chips=int(rec["chips"]), job_id=rec["job_id"],
            profile_to_completion=bool(rec["profile_to_completion"]),
            devices=[device_from_record(d) for d in rec["devices"]],
            mesh=mesh_from_record(rec["mesh"]),
            global_batch=rec["global_batch"])
        self._handles[rec["job_id"]] = JobHandle(
            self, self._fleet.jobs[rec["job_id"]], meta, None)

    def _apply_record(self, rec) -> None:
        """Replay one journal record against the live (store-detached)
        session.  Only *causes* replay; consequence ``event`` records are
        informational (the deterministic controller logic regenerates the
        identical events), and ``open``/``resume`` are markers."""
        kind, data = rec.kind, rec.data
        match kind:
            case kinds.OPEN | kinds.EVENT | kinds.RESUME:
                return
            case kinds.ADMIT:
                self._replay_admit(data)
            case kinds.DECISION:
                job = self._fleet.jobs[data["job_id"]]
                self._fleet._decide(job, from_dict(data["decision"]),
                                    plan=from_dict(data["plan"]))
                self._fleet._repack()
            case kinds.RETIRE:
                self.retire(data["job_id"])
            case kinds.BUDGET:
                self._fleet.set_budget(from_dict(data["budget_w"]))
            case kinds.FAIL:
                self._fleet.fail_device(data["device"])
            case kinds.DEGRADE:
                self._fleet.degrade_device(data["device"])
            case kinds.RESTORE:
                self._fleet.restore_device(data["device"])
            case kinds.REPROFILE:
                self._fleet.restart_profile(data["job_id"],
                                            meta_from_record(data["meta"]))
            case kinds.CURSOR:
                self._rr = int(data["rr"])
            case kinds.QUARANTINE | kinds.PROMOTE | kinds.ROLLBACK:
                d = self._discovery
                if d is None:
                    warnings.warn(
                        f"journal record {rec.seq} is a discovery {kind!r} "
                        f"record but the resumed session has no discovery "
                        f"configured; skipping it", RuntimeWarning)
                elif kind == kinds.QUARANTINE:
                    d.admit_record(data["entry"])
                elif kind == kinds.PROMOTE:
                    # verbatim re-adoption of the promoted membership:
                    # rebuilds the profiles from their journaled records and
                    # row-appends them — zero classifier calls (the fleet's
                    # classifier is re-pointed once, after the full replay)
                    d.adopt_promoted(int(data["version"]), data["profiles"],
                                     data["consumed"])
                else:
                    d.rollback()
            case _:
                warnings.warn(f"journal record {rec.seq} has unknown kind "
                              f"{kind!r}; skipping it", RuntimeWarning)

    # -- introspection ---------------------------------------------------
    @property
    def classifier(self):
        """The shared warm ``MinosClassifier`` every job classifies against."""
        return self._fleet.clf

    @property
    def scheduler(self):
        return self._fleet.scheduler

    @property
    def objective(self) -> str:
        return self._objective.name

    @property
    def budget_w(self) -> float:
        return self._fleet.budget_w

    @property
    def jobs(self) -> dict[str, JobHandle]:
        """Live (non-retired) job handles, in submit order."""
        return dict(self._handles)

    def __len__(self) -> int:
        return len(self._handles)

    # -- lifecycle -------------------------------------------------------
    def submit(self, source, device=None, chips: int = 1,
               job_id: str | None = None, profile_to_completion: bool = False,
               freq: float = 1.0, devices=None, mesh=None,
               global_batch: int | None = None, **telemetry_kw) -> JobHandle:
        """Admit a job and return its ``JobHandle``.  ``source`` is one of

          * a ``KernelStream`` — the session profiles it on ``device``'s
            power model via ``stream_telemetry`` (``seed``,
            ``target_duration``, ``chunk_samples``, ... pass through) and
            attaches the chunk stream to the handle (``handle.run()``);
          * a ``(meta, chunks)`` pair from ``stream_telemetry`` — attached
            as-is;
          * a bare ``TraceMeta`` — telemetry arrives via ``handle.feed``.

        ``device`` is a ``DeviceInstance``, a device_id string resolved in
        the session inventory, or ``None`` — the next *healthy* inventory
        device (round-robin), or a nominal reference chip when the session
        has no inventory.  Default ``job_id``s (``"<workload>@<device>"``)
        are de-duplicated with a ``#k`` suffix.

        Multi-chip jobs may span several devices: pass the full span as
        ``devices`` (instances or device_ids; must include ``device``) with
        ``chips`` divided evenly across it, plus an optional ``mesh`` /
        ``global_batch`` — a partial device loss then shrinks the job
        through the elastic re-mesh instead of migrating it wholesale."""
        rr_before = self._rr
        device = self._resolve_device(device)
        if devices is not None:
            devices = tuple(self._resolve_device(d) for d in devices)
        if self._store is not None and self._rr != rr_before:
            # auto-placement advanced the round-robin cursor: journal it
            # (before the admit record) so replayed sessions keep placing
            # later submits on the same devices
            self._store.record(kinds.CURSOR, rr=self._rr)
        meta, chunks = self._parse_source(source, device, freq, telemetry_kw)
        if job_id is None:
            job_id = self._unique_job_id(f"{meta.name}@{device.device_id}")
        job_id = self._fleet.admit(device, meta, chips=chips, job_id=job_id,
                                   profile_to_completion=profile_to_completion,
                                   devices=devices, mesh=mesh,
                                   global_batch=global_batch)
        handle = JobHandle(self, self._fleet.jobs[job_id], meta, chunks)
        self._handles[job_id] = handle
        return handle

    def submit_many(self, sources, device=None, chips=1, job_ids=None,
                    profile_to_completion: bool = False, freq: float = 1.0,
                    **telemetry_kw) -> list[JobHandle]:
        """Bulk admission: admit a whole batch of jobs through one fleet
        call and one coalesced journal flush — the fleet-scale submit path.

        ``sources`` is an iterable of :meth:`submit` sources (a
        ``KernelStream``, a ``(meta, chunks)`` pair, or a bare
        ``TraceMeta``).  ``device`` applies to every job (``None`` =
        round-robin placement over healthy inventory, resolved per job
        exactly as sequential submits would).  ``chips`` is one count for
        all jobs or a per-job sequence; ``job_ids`` an optional per-job
        sequence (auto ids are de-duplicated with the same ``#k`` suffixes
        sequential submits produce).  Returns the handles in batch order.

        Session state, placement, and resume behavior are identical to
        calling ``submit`` once per source; the batch writes one cursor
        record (the final round-robin position) plus all admit records in
        a single buffered store flush.  Multi-device spans (``devices``/
        ``mesh``/``global_batch``) stay on ``submit``."""
        sources = list(sources)
        n = len(sources)
        chips_list = [int(chips)] * n if isinstance(chips, int) \
            else [int(c) for c in chips]
        if len(chips_list) != n:
            raise ValueError(f"chips sequence has {len(chips_list)} entries "
                             f"for {n} sources")
        if job_ids is not None:
            job_ids = list(job_ids)
            if len(job_ids) != n:
                raise ValueError(f"job_ids has {len(job_ids)} entries for "
                                 f"{n} sources")
        rr_before = self._rr
        parsed = []
        for source in sources:
            dev = self._resolve_device(device)
            meta, chunks = self._parse_source(source, dev, freq,
                                              telemetry_kw)
            parsed.append((dev, meta, chunks))
        taken: set[str] = set()
        admissions = []
        for i, (dev, meta, _) in enumerate(parsed):
            jid = job_ids[i] if job_ids is not None else None
            if jid is None:
                jid = self._unique_job_id(f"{meta.name}@{dev.device_id}",
                                          taken)
            taken.add(jid)
            admissions.append(dict(
                device=dev, meta=meta, chips=chips_list[i], job_id=jid,
                profile_to_completion=profile_to_completion))
        ctx = self._store.batch() if self._store is not None \
            else nullcontext()
        with ctx:
            if self._store is not None and self._rr != rr_before:
                # one cursor record for the whole batch: replay lands the
                # round-robin exactly where the sequential loop would
                self._store.record(kinds.CURSOR, rr=self._rr)
            ids = self._fleet.admit_many(admissions)
        handles = []
        for jid, (dev, meta, chunks) in zip(ids, parsed):
            handle = JobHandle(self, self._fleet.jobs[jid], meta, chunks)
            self._handles[jid] = handle
            handles.append(handle)
        return handles

    def _parse_source(self, source, device, freq, telemetry_kw):
        """Normalize a submit source into ``(meta, chunks)``."""
        if isinstance(source, KernelStream):
            return stream_telemetry(
                source, freq, device.power_model(),
                device_id=device.device_id, **telemetry_kw)
        if isinstance(source, TraceMeta):
            if telemetry_kw:
                raise ValueError(f"telemetry options {sorted(telemetry_kw)} "
                                 f"only apply when submitting a KernelStream")
            return source, None
        if isinstance(source, tuple) and len(source) == 2 \
                and isinstance(source[0], TraceMeta):
            if telemetry_kw:
                raise ValueError(f"telemetry options {sorted(telemetry_kw)} "
                                 f"only apply when submitting a KernelStream")
            return source
        raise TypeError(f"submit() takes a KernelStream, a TraceMeta, or "
                        f"a (meta, chunks) pair, got "
                        f"{type(source).__name__}")

    def retire(self, job_id: str) -> JobPlan | None:
        """Retire a job: its telemetry stops counting and its plan leaves
        the packing, releasing its budget share — the survivors re-pack
        from cached plans (never re-classifying).  Returns the retired
        job's plan (``None`` if it never decided).  The handle's cached
        ``decision()``/``plan()`` remain readable."""
        handle = self._handles.pop(job_id, None)
        if handle is None:
            raise KeyError(f"unknown or already-retired job {job_id!r}")
        job = self._fleet.retire(job_id)
        handle.retired = True
        self._retired[job_id] = job.decision
        return job.plan

    def set_budget(self, budget_w: float) -> None:
        """Change the shared power budget mid-session; decided jobs re-pack
        against the new ceiling from their cached plans."""
        self._fleet.set_budget(budget_w)

    # -- fault tolerance -------------------------------------------------
    def fail_device(self, device_id: str) -> list[FleetEvent]:
        """A device died: every affected job migrates to surviving healthy
        devices from its cached decision (**zero classifier calls** — the
        same invariant as retire/set_budget), multi-chip jobs shrink via
        the elastic re-mesh, and the fleet re-packs once.  Needs a session
        inventory.  Returns the failure's events (also in ``report()``)."""
        return self._fleet.fail_device(device_id)

    def degrade_device(self, device_id: str) -> list[FleetEvent]:
        """Mark a device as straggling and proactively drain its decided
        jobs onto healthy silicon (no re-classification).  Jobs still
        profiling on it finish and migrate the moment they decide."""
        return self._fleet.degrade_device(device_id)

    def restore_device(self, device_id: str) -> list[FleetEvent]:
        """Return a failed/degraded device to the healthy placement pool
        (existing placements stay put; the device takes new work again)."""
        return self._fleet.restore_device(device_id)

    @property
    def device_health(self) -> dict[str, str]:
        """device_id -> ``"healthy"``/``"degraded"``/``"failed"`` for the
        session inventory (empty without one)."""
        return self._fleet.device_health()

    @property
    def stragglers(self) -> FleetStragglerAdapter | None:
        """The session's straggler adapter (``None`` unless enabled): read
        ``.degraded()`` for cadence outliers and ``.dead()`` for devices
        that went silent — the latter is advisory; escalate a genuinely
        lost device with ``fail_device`` yourself (silence can also mean
        its jobs finished early)."""
        return self._fleet.straggler_adapter

    # -- online class discovery -------------------------------------------
    @property
    def discovery(self):
        """The session's ``DiscoveryController`` (``None`` unless the
        session was built with a ``discovery`` option).  Set its
        ``.profiler`` to a full-profile callable — e.g.
        ``repro_torch.discovery.stream_profiler`` over the streams a production
        profiling run would target — to enable promotion."""
        return self._discovery

    def _require_discovery(self):
        if self._discovery is None:
            raise ValueError(
                "this session has no discovery configured; construct it "
                "with discovery=True (or a knobs dict)")
        return self._discovery

    def discover(self, force: bool = True) -> dict | None:
        """Run one re-cluster + shadow-evaluate pass over the quarantine
        pool now (``force=False`` honours the ``recluster_every`` cadence),
        and — when at least one candidate passes the shadow gate — promote:
        journal the promotion write-ahead, publish the next library
        version, and atomically re-point the whole fleet at it (zero
        classifier calls on the swap).  Returns a promotion summary dict,
        or ``None`` when nothing promoted."""
        d = self._require_discovery()
        promo = d.propose(force=force)
        if promo is None:
            return None
        return self._adopt_promotion(promo)

    def rollback_discovery(self) -> dict:
        """Revert the last promotion (N-1): journal the rollback, restore
        the previous library version, and re-point the fleet at it.  Note
        that plans built *after* the promotion may reference discovered
        classes the restored library no longer has; re-costing such a plan
        (migration, elastic shrink) will fail — roll back before acting on
        a promotion's decisions, or retire the affected jobs first."""
        d = self._require_discovery()
        if d._previous is None:
            raise ValueError("no previous library version to roll back to")
        if self._store is not None:
            self._store.record(kinds.ROLLBACK, version=d.version - 1)
        d.rollback()
        self._fleet.adopt_classifier(d.library)
        if self._store is not None:
            self._store.flush_snapshot(force=True)
        return {"version": d.version, "classes": d.library.names}

    def _maybe_discover(self) -> None:
        """Between-ticks discovery hook (inert without discovery): runs the
        re-cluster pass only when the quarantine cadence says it is due."""
        d = self._discovery
        if d is None or not d.due():
            return
        promo = d.propose()
        if promo is not None:
            self._adopt_promotion(promo)

    def _adopt_promotion(self, promo) -> dict:
        """Journal (write-ahead) + apply a promotion, then swap the fleet's
        classifier atomically — between ticks, never mid-tick."""
        d = self._discovery
        if self._store is not None:
            self._store.record(kinds.PROMOTE, version=promo.version,
                               profiles=promo.profile_records,
                               consumed=list(promo.consumed))
        d.apply(promo)
        self._fleet.adopt_classifier(d.library)
        if self._store is not None:
            # a promotion is a version boundary: snapshot it immediately so
            # a crash right after resumes from the promoted state directly
            self._store.flush_snapshot(force=True)
        return {"version": d.version,
                "classes": [p.name for p in promo.profiles],
                "consumed": len(promo.consumed),
                "reports": [r.record() for r in promo.reports]}

    def run(self, finalize: bool = True) -> SessionReport:
        """Drain every attached-but-unconsumed telemetry stream through the
        deterministic fleet mux (submit-order interleave), then — with
        ``finalize`` (default) — decide any still-undecided jobs from their
        completed profiles and re-pack once more.  Returns the report."""
        pending = [h for h in self._handles.values()
                   if h._chunks is not None]
        if pending:
            mux = FleetTelemetryMux()
            for h in pending:
                mux.add_job(h.job_id, h.meta, h._take_chunks())
            for batch in mux.ticks():
                self._fleet.ingest_tick(batch)
                self._maybe_discover()       # library swaps between ticks
        if finalize and self._fleet.jobs:
            self._fleet.finalize()
            self._maybe_discover()
        return self.report()

    def report(self) -> SessionReport:
        """The session outcome so far (pure; JSON-round-trippable)."""
        fleet = self._fleet
        return SessionReport(
            objective=self.objective,
            quantile=fleet.scheduler.quantile,
            budget_w=fleet.budget_w,
            decisions={job_id: job.decision
                       for job_id, job in fleet.jobs.items()
                       if job.decision is not None},
            schedule=fleet.repacks[-1] if fleet.repacks else None,
            repacks=len(fleet.repacks),
            chunks_dropped=fleet._dropped,
            retired=dict(self._retired),
            events=list(fleet.events),
            device_health=fleet.device_health(),
            discovery=self._discovery.report_record()
                      if self._discovery is not None else None)

    # -- helpers ---------------------------------------------------------
    def _resolve_device(self, device) -> DeviceInstance:
        if isinstance(device, DeviceInstance):
            return device
        if isinstance(device, str):
            if self.inventory is None:
                raise ValueError(f"device_id {device!r} given but the "
                                 f"session has no inventory")
            return self.inventory.get(device)
        if device is not None:
            raise TypeError(f"device must be a DeviceInstance, a device_id, "
                            f"or None, got {type(device).__name__}")
        if self.inventory is not None and len(self.inventory):
            # round-robin over HEALTHY devices only: failed/degraded chips
            # take no new placements (an all-healthy inventory walks the
            # exact pre-FT order)
            for _ in range(len(self.inventory)):
                dev = self.inventory[self._rr % len(self.inventory)]
                self._rr += 1
                if self.inventory.is_healthy(dev.device_id):
                    return dev
            raise ValueError("no healthy device left in the inventory; "
                             "restore_device one or pass a device explicitly")
        if self._default_device is None:
            # the nominal reference chip: scales exactly 1.0, so decisions
            # are byte-identical to the device-less single-job path
            self._default_device = DeviceInventory.generate(1)[0]
        return self._default_device

    def _unique_job_id(self, base: str, taken=()) -> str:
        """De-duplicate a default job_id; ``taken`` carries ids claimed
        earlier in the same ``submit_many`` batch."""
        job_id, k = base, 1
        while job_id in self._fleet.jobs or job_id in self._retired \
                or job_id in taken:
            k += 1
            job_id = f"{base}#{k}"
        return job_id
