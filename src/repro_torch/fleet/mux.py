"""Fleet telemetry multiplexer: many concurrent job streams, one chunk feed.

On a real cluster the telemetry daemon polls every device on one wire and
hands the collector an interleaved sequence of per-device counter readings
("Characterizing Production GPU Workloads using System-wide Telemetry
Data", arXiv:2502.18680).  ``FleetTelemetryMux`` reproduces that view from
per-job ``stream_telemetry`` iterators: chunks are merged in arrival-time
order (the wall-clock time of a chunk's last sample edge), with job
admission order as the tie-break, so the interleave is fully deterministic.

Each yielded ``FleetChunk`` tags the raw ``TelemetryChunk`` with its job and
device, which is all ``FleetCapController`` needs to route it to the right
``ProfileBuilder``.  Per-job chunk order is preserved by construction, so
any single job's sub-stream is exactly what the un-muxed path would see —
the property the homogeneous-fleet byte-identity test pins.
"""
from __future__ import annotations

import heapq
from typing import NamedTuple

from repro_torch.telemetry.simulator import TelemetryChunk, TraceMeta


class FleetChunk(NamedTuple):
    """One multiplexed poll: a raw counter chunk tagged with its origin.

    A ``NamedTuple`` rather than a frozen dataclass: the mux mints one per
    chunk per tick, and tuple construction is several times cheaper than
    ``object.__setattr__``-based frozen-dataclass init at fleet scale."""
    job_id: str
    device_id: str
    t_end: float                 # wall-clock time of the last sample edge (s)
    chunk: TelemetryChunk


class FleetTelemetryMux:
    """Merge per-job telemetry streams into one time-ordered chunk feed."""

    def __init__(self):
        self._jobs: list[tuple[str, str, float, object]] = []
        self._ids: set[str] = set()
        self._dead_jobs: set[str] = set()
        self._dead_devices: set[str] = set()

    def add_job(self, job_id: str, meta: TraceMeta, chunks,
                device_id: str | None = None, t_start: float = 0.0) -> None:
        """Register one job's chunk iterator.  ``device_id`` defaults to the
        stream's ``meta.device_id`` tag; ``t_start`` offsets the job's
        arrival on the fleet clock (0 = starts with the fleet)."""
        if job_id in self._ids:
            raise ValueError(f"duplicate job_id {job_id!r}")
        self._ids.add(job_id)
        did = meta.device_id if device_id is None else device_id
        self._jobs.append((job_id, did, float(t_start), iter(chunks)))

    def __len__(self) -> int:
        return len(self._jobs)

    # -- failure injection -----------------------------------------------
    def drop_job(self, job_id: str) -> None:
        """Stop delivering ``job_id``'s chunks (the job migrated or was
        cancelled mid-stream).  Takes effect immediately, even inside a
        live iteration: the next chunk due from that stream is discarded
        and the stream is not pulled again."""
        self._dead_jobs.add(job_id)

    def drop_device(self, device_id: str) -> None:
        """A device died: every stream tagged with its ``device_id`` goes
        silent from this poll on — the wire-level view of a failure.  Safe
        to call mid-iteration (the failure-injection path)."""
        self._dead_devices.add(device_id)

    def _is_dead(self, fchunk: FleetChunk) -> bool:
        return (fchunk.job_id in self._dead_jobs
                or fchunk.device_id in self._dead_devices)

    def _chunk_t_end(self, chunk: TelemetryChunk, t_start: float) -> float:
        n_end = chunk.start_index + len(chunk.energy_j)
        return t_start + n_end * chunk.sample_dt

    def __iter__(self):
        """Yield ``FleetChunk``s across all jobs in (t_end, admission-order)
        order — a lazy k-way heap merge, pulling each stream only as its
        chunks come due."""
        heap: list[tuple[float, int, FleetChunk]] = []
        iters: dict[int, tuple[str, str, float, object]] = {}
        for order, (job_id, did, t_start, it) in enumerate(self._jobs):
            iters[order] = (job_id, did, t_start, it)
            chunk = next(it, None)
            if chunk is not None:
                t_end = self._chunk_t_end(chunk, t_start)
                heapq.heappush(heap, (t_end, order, FleetChunk._make(
                    (job_id, did, t_end, chunk))))
        while heap:
            _, order, fchunk = heapq.heappop(heap)
            if self._is_dead(fchunk):
                continue           # stream went silent: discard, never pull
            yield fchunk
            job_id, did, t_start, it = iters[order]
            if job_id in self._dead_jobs or did in self._dead_devices:
                continue           # dropped while the chunk was being handled
            nxt = next(it, None)
            if nxt is not None:
                t_end = self._chunk_t_end(nxt, t_start)
                heapq.heappush(heap, (t_end, order, FleetChunk._make(
                    (job_id, did, t_end, nxt))))

    def ticks(self):
        """Yield *batches* of ``FleetChunk``s — all chunks sharing one
        ``t_end`` (one poll of the fleet wire) popped together, ordered by
        the same ``(t_end, admission-order)`` key as ``__iter__``.

        Concatenating the yielded batches reproduces ``__iter__``'s chunk
        sequence exactly; the batching only exposes which chunks are
        simultaneous so ``FleetCapController.ingest_tick`` can advance every
        live job in one columnar pass.  Streams are pulled lazily per tick
        (no per-chunk heap churn between equal timestamps), and
        ``drop_job``/``drop_device`` take effect at the same poll boundary
        as the per-chunk path.
        """
        heap: list[tuple[float, int, FleetChunk]] = []
        iters: dict[int, tuple[str, str, float, object]] = {}
        for order, (job_id, did, t_start, it) in enumerate(self._jobs):
            iters[order] = (job_id, did, t_start, it)
            chunk = next(it, None)
            if chunk is not None:
                t_end = self._chunk_t_end(chunk, t_start)
                heapq.heappush(heap, (t_end, order, FleetChunk._make(
                    (job_id, did, t_end, chunk))))
        while heap:
            t_now = heap[0][0]
            popped: list[tuple[int, FleetChunk]] = []
            while heap and heap[0][0] == t_now:
                _, order, fchunk = heapq.heappop(heap)
                popped.append((order, fchunk))
            batch = [fc for _, fc in popped if not self._is_dead(fc)]
            if batch:
                yield batch
            for order, fchunk in popped:
                job_id, did, t_start, it = iters[order]
                if job_id in self._dead_jobs or did in self._dead_devices:
                    continue       # dropped at (or before) this poll
                nxt = next(it, None)
                if nxt is not None:
                    t_end = self._chunk_t_end(nxt, t_start)
                    heapq.heappush(heap, (t_end, order, FleetChunk._make(
                        (job_id, did, t_end, nxt))))
