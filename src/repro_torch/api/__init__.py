"""``repro_torch.api`` — the one front door to the port of Minos.

A ``MinosSession`` owns the reference library, the device inventory, the
budget, and the policy plugins, and every scenario — one job on one chip, a
heterogeneous fleet under an oversubscribed budget, a custom objective, a
device failure, a crash and its resume — is a few calls on it.  The
profiling engine and the classifier run on ``device`` (default: the card):

    from repro_torch.api import MinosSession

    session = MinosSession.from_config({
        "library": "results/reference_store",
        "devices": {"tpu-v5e": 6, "tpu-v5p": 2},
        "variability": {},
        "budget_fraction_of_nameplate": 0.75,
        "store": "session_store",
    })
    job = session.submit(stream, chips=256)     # -> JobHandle
    decision = job.run()                        # early, confidence-gated cap
    report = session.run()                      # SessionReport (JSON-able)
    session = MinosSession.resume("session_store")   # after a crash

    # online class discovery: low-margin jobs quarantine, promote new classes
    session = MinosSession(library, discovery=True)
    session.discovery.profiler = stream_profiler(novel_streams())

Everything the facade builds on is re-exported here.
"""
from repro_torch.api.registry import (ACTUATORS, OBJECTIVES, QUANTILES,
                                      QuantilePolicy, Registry,
                                      register_actuator, register_objective,
                                      register_quantile)
from repro_torch.api.results import (SessionReport, from_dict, from_json,
                                     to_dict, to_json)
from repro_torch.api.session import JobHandle, MinosSession

# the engine underneath, re-exported so facade users need one import root
from repro_torch.core.algorithm1 import (FreqSelection, ObjectivePolicy,
                                         profiling_savings, resolve_objective,
                                         select_optimal_freq)
from repro_torch.core.classify import (FreqPoint, MinosClassifier,
                                       WorkloadProfile,
                                       count_classifier_calls)
from repro_torch.discovery import (DiscoveryController, QuarantinePool,
                                   ShadowEvaluator, stream_profiler,
                                   truth_selection)
from repro_torch.fleet.controller import (FleetCapController, FleetEvent,
                                          FleetResult)
from repro_torch.fleet.inventory import (DeviceInstance, DeviceInventory,
                                         VariabilityModel)
from repro_torch.fleet.mux import FleetChunk, FleetTelemetryMux
from repro_torch.ft.fleetwatch import FleetStragglerAdapter
from repro_torch.ft.heartbeat import StragglerMonitor
from repro_torch.pipeline.batch import BatchProfileEngine, SlotBuilder
from repro_torch.pipeline.builder import (PartialProfile, ProfileBuilder,
                                          stream_profile_once,
                                          stream_profile_workload)
from repro_torch.pipeline.library import (ReferenceLibrary,
                                          build_reference_library)
from repro_torch.pipeline.online import CapDecision, OnlineCapController
from repro_torch.sched.dvfs import FrequencyActuator, SimActuator
from repro_torch.sched.power_sched import (IncrementalPacker, JobPlan,
                                           PowerAwareScheduler, RepackStats,
                                           ScheduleResult)
from repro_torch.store import (EventJournal, JournalRecord, NoStoreError,
                               SessionStore, SnapshotStore, StoreError,
                               store_report, windowed_report)
from repro_torch.telemetry.kernel_stream import (Kernel, KernelStream,
                                                 build_stream, micro_gemm,
                                                 micro_idle_burst,
                                                 micro_spmv_compute,
                                                 micro_spmv_memory,
                                                 micro_stencil,
                                                 micro_vector_search)
from repro_torch.telemetry.power_model import TPUPowerModel
from repro_torch.telemetry.simulator import (SimTrace, TelemetryChunk,
                                             TraceMeta, simulate,
                                             stream_telemetry)
from repro_torch.telemetry.workloads import (fleet_job_mix, holdout_streams,
                                             novel_streams,
                                             reference_streams)

__all__ = [
    # facade
    "MinosSession", "JobHandle", "SessionReport",
    # registries / plugin policies
    "Registry", "OBJECTIVES", "ACTUATORS", "QUANTILES",
    "register_objective", "register_actuator", "register_quantile",
    "ObjectivePolicy", "QuantilePolicy", "resolve_objective",
    # result objects + codec
    "CapDecision", "JobPlan", "ScheduleResult", "FreqSelection",
    "IncrementalPacker", "RepackStats",
    "to_dict", "from_dict", "to_json", "from_json",
    # streaming pipeline
    "ProfileBuilder", "PartialProfile", "ReferenceLibrary",
    "build_reference_library", "OnlineCapController",
    "stream_profile_once", "stream_profile_workload",
    "BatchProfileEngine", "SlotBuilder",
    # classification core
    "MinosClassifier", "WorkloadProfile", "FreqPoint",
    "select_optimal_freq", "profiling_savings", "count_classifier_calls",
    # fleet
    "DeviceInstance", "DeviceInventory", "VariabilityModel",
    "FleetCapController", "FleetResult", "FleetChunk", "FleetTelemetryMux",
    # fault tolerance
    "FleetEvent", "FleetStragglerAdapter", "StragglerMonitor",
    # durable sessions (repro_torch.store)
    "SessionStore", "EventJournal", "JournalRecord", "SnapshotStore",
    "NoStoreError", "StoreError", "store_report", "windowed_report",
    # online class discovery (repro_torch.discovery)
    "DiscoveryController", "QuarantinePool", "ShadowEvaluator",
    "stream_profiler", "truth_selection",
    # actuation / scheduling
    "FrequencyActuator", "SimActuator", "PowerAwareScheduler",
    # telemetry + workload zoo
    "TPUPowerModel", "simulate", "stream_telemetry", "SimTrace",
    "TelemetryChunk", "TraceMeta", "Kernel", "KernelStream", "build_stream",
    "micro_gemm", "micro_idle_burst", "micro_spmv_compute",
    "micro_spmv_memory", "micro_stencil", "micro_vector_search",
    "reference_streams", "holdout_streams", "novel_streams", "fleet_job_mix",
]
