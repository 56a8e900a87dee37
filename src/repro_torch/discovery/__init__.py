"""Online class discovery: the reference library learns from production
traffic.

Minos' premise is that a finite class library absorbs new workloads cheaply
— but workload populations drift, and unseen application families are
exactly where the low-margin decisions pile up.  This package closes the
loop:

  * :class:`QuarantinePool` accumulates the finalized low-margin profiles
    the ``OnlineCapController`` confidence gate surfaces;
  * :class:`DiscoveryController` periodically re-clusters the pool
    (``core/clustering`` linkage over cosine spike distances) to mint
    candidate classes;
  * :class:`ShadowEvaluator` scores every candidate against full-profile
    ground truth *before* it can affect a live decision;
  * the promotion path publishes a new versioned ``ReferenceLibrary``
    (spike cache grown incrementally, N-1 rollback retained) which the
    session and fleet controller adopt atomically between ticks — zero
    classifier queries on the swap.

Discovery is inert-by-default: a session without a ``discovery`` config key
takes byte-identical code paths to a session without this package.  The
records it journals are the reference package's, byte for byte.
"""
from repro_torch.discovery.controller import (DISCOVERY_KEYS,
                                              DiscoveryController, Promotion,
                                              stream_profiler)
from repro_torch.discovery.pool import PoolEntry, QuarantinePool
from repro_torch.discovery.records import profile_from_record, profile_record
from repro_torch.discovery.shadow import (ShadowEvaluator, ShadowReport,
                                          truth_selection)

__all__ = [
    "DISCOVERY_KEYS", "DiscoveryController", "Promotion", "PoolEntry",
    "QuarantinePool", "ShadowEvaluator", "ShadowReport",
    "profile_from_record", "profile_record", "stream_profiler",
    "truth_selection",
]
