"""Streaming profiling pipeline of the port (mirrors ``repro.pipeline``).

  * ``ProfileBuilder`` (``builder``) — incremental ingestion of
    ``TelemetryChunk``s on the device; partial ``WorkloadProfile`` at any
    point, batch equivalence at the end.
  * ``ReferenceLibrary`` (``library``) — versioned reference set with the
    reference's on-disk format and fingerprinted spike-matrix cache.
  * ``OnlineCapController`` (``online``) — classify partial profiles
    mid-run with a distance-margin confidence and actuate caps early.
  * ``BatchProfileEngine`` (``batch``) — slot-indexed columnar twin of
    ``ProfileBuilder``: one stacked pass on the device advances every live
    fleet job per mux tick, bit-identical to the per-job path.
"""
from repro_torch.pipeline.batch import BatchProfileEngine, SlotBuilder
from repro_torch.pipeline.builder import (DEFAULT_BIN_SIZES, PartialProfile,
                                          ProfileBuilder, stream_profile_once,
                                          stream_profile_workload)
from repro_torch.pipeline.library import (ReferenceLibrary,
                                          build_reference_library,
                                          import_reference_library)
from repro_torch.pipeline.online import (CapDecision, OnlineCapController,
                                         classify_with_margin,
                                         classify_with_margin_batch,
                                         finalize_fleet, observe_fleet)
