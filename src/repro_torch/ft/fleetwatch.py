"""Fleet-level straggler detection: ``ft.StragglerMonitor`` over telemetry.

The training-loop ``StragglerMonitor`` watches per-host step durations; on
the fleet there are no steps, but the multiplexed telemetry feed carries the
same signal for free — each ``FleetChunk``'s ``t_end`` is the wall-clock
edge of its last sample, so the gap between consecutive chunks from one
device is that device's effective polling cadence.  A degrading chip (
thermal throttling, a flaky interconnect, a dying HBM stack) stretches its
cadence long before it stops answering entirely.

``FleetStragglerAdapter`` converts the chunk feed into monitor samples:
``observe`` one ``FleetChunk`` at a time (device keyed by ``device_id``,
each device's own chunk count as its step clock — a fleet-wide counter
would out-run the monitor window on large fleets and age out perfectly
healthy devices between their own polls), then read ``degraded()`` /
``dead()``.  A device whose chunk count falls a full monitor window behind
the busiest device ages out as dead — the heartbeat contract.  ``dead()``
is advisory, never auto-acted on: a device also goes silent when its jobs
simply finish early, so only the operator (or a harness that knows the
job mix, like ``bench_chaos``) should escalate it to ``fail_device``.
``FleetCapController`` wires ``degraded()`` to proactive migration: a
flagged device gets its decided jobs re-planned onto healthy silicon
*before* it fails, with zero re-classification.
"""
from __future__ import annotations

from repro_torch.ft.heartbeat import StragglerMonitor


class FleetStragglerAdapter:
    """Feed per-device inter-chunk timings into a ``StragglerMonitor``.

    ``check_every`` throttles ``should_check()`` (the controller's cue to
    recompute the fleet-wide straggler statistics): the median+MAD sweep is
    O(devices x window), far heavier than a chunk ingest, and its verdict
    only drifts as samples accumulate — every 8th chunk is plenty."""

    def __init__(self, monitor: StragglerMonitor | None = None,
                 check_every: int = 8):
        self.monitor = monitor or StragglerMonitor()
        self.check_every = max(int(check_every), 1)
        self._last_t_end: dict[str, float] = {}
        self._counts: dict[str, int] = {}
        self._step = 0

    def observe(self, fchunk) -> None:
        """Record one multiplexed chunk's arrival for its device.  The first
        chunk from a device only seeds its clock (a gap needs two edges)."""
        device_id, t_end = fchunk.device_id, float(fchunk.t_end)
        self._step += 1
        count = self._counts.get(device_id, 0) + 1
        self._counts[device_id] = count
        last = self._last_t_end.get(device_id)
        self._last_t_end[device_id] = t_end
        if last is None:
            return
        # same-t_end chunks (dense multiplexing) contribute a zero gap —
        # still a heartbeat, so the device's liveness clock advances
        self.monitor.record(device_id, count, max(t_end - last, 0.0))

    def should_check(self) -> bool:
        """True every ``check_every``-th observed chunk — the throttled cue
        to run the O(devices x window) straggler sweep."""
        return self._step % self.check_every == 0

    def degraded(self) -> list[str]:
        """Devices whose chunk cadence is a straggler outlier (median +
        k*MAD across the fleet) — candidates for proactive migration."""
        return sorted(self.monitor.stragglers(), key=str)

    def dead(self) -> list[str]:
        """Devices aged out of the monitor entirely (a full window of polls
        behind the busiest device) — surfaced for the operator to escalate
        (``fail_device``), never auto-acted on: silence can also mean the
        device's jobs finished early."""
        return self.monitor.dead_hosts()

    def devices(self) -> list[str]:
        """Every device that has ever reported, sorted."""
        return sorted(self._last_t_end)
