"""Fault-tolerance: straggler detection + preemption handling.

On a real multi-host deployment these bind to ``torch.distributed``
heartbeats; the detection logic is host-agnostic and fully unit-testable
with injected clocks (per the dry-run-first philosophy of this repo).
"""
from __future__ import annotations

import signal
import statistics
from collections import defaultdict, deque
from dataclasses import dataclass, field


@dataclass
class StragglerMonitor:
    """Flags hosts whose per-step durations exceed median + k * MAD.

    Hosts are any hashable id (ints for training hosts, device_id strings
    for fleet devices).  A host that stops reporting is aged out: once no
    sample has arrived from it in the last ``window`` steps (tracked via the
    ``step`` argument to ``record``), its stale duration window is evicted
    and ``healthy_hosts`` stops vouching for it — ``dead_hosts()`` reports
    it instead, until it records again.
    """

    window: int = 20
    k: float = 6.0
    min_samples: int = 5
    _durations: dict = field(default_factory=lambda: defaultdict(deque))
    _last_step: dict = field(default_factory=dict)
    _dead: set = field(default_factory=set)
    _latest_step: int = field(default=-1)

    def record(self, host, step: int, duration_s: float) -> None:
        step = int(step)
        self._dead.discard(host)           # a reporting host is back alive
        prev = self._last_step.get(host, step)
        self._last_step[host] = max(prev, step)
        if step > self._latest_step:
            self._latest_step = step
        d = self._durations[host]
        d.append(duration_s)
        if len(d) > self.window:
            d.popleft()
        self._evict_stale()

    def _evict_stale(self) -> None:
        cutoff = self._latest_step - self.window
        for host in [h for h, s in self._last_step.items() if s < cutoff]:
            del self._last_step[host]
            self._durations.pop(host, None)
            self._dead.add(host)

    def dead_hosts(self) -> list:
        """Hosts aged out for silence (no sample in the last ``window``
        steps), in eviction order-independent sorted form."""
        return sorted(self._dead, key=str)

    def stragglers(self) -> list:
        per_host = {h: statistics.median(d) for h, d in self._durations.items()
                    if len(d) >= self.min_samples}
        if len(per_host) < 3:
            return []
        meds = sorted(per_host.values())
        med = statistics.median(meds)
        mad = statistics.median([abs(x - med) for x in meds]) or 1e-9
        return [h for h, v in per_host.items() if v > med + self.k * mad]

    def healthy_hosts(self, all_hosts: list) -> list:
        bad = set(self.stragglers()) | self._dead
        return [h for h in all_hosts if h not in bad]


class PreemptionHandler:
    """SIGTERM -> set flag; the training loop checkpoints and exits cleanly."""

    def __init__(self, install: bool = True):
        self.preempted = False
        if install:
            try:
                signal.signal(signal.SIGTERM, self._on_signal)
            except ValueError:
                pass  # non-main thread (tests)

    def _on_signal(self, signum, frame) -> None:
        self.preempted = True

    def trigger(self) -> None:  # test hook
        self.preempted = True
