"""Quarantine pool: finalized low-margin profiles awaiting re-clustering.

Entries enter through the ``OnlineCapController`` confidence-gate tap and
leave either by promotion (their cluster minted a new reference class) or by
FIFO eviction once the pool exceeds capacity.  Both paths are deterministic
functions of the entry records, so journal replay reproduces the pool
byte-for-byte without touching a classifier.  Entry profiles live on the
pool's ``device``.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.classify import WorkloadProfile
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.discovery.records import profile_from_record, profile_record


@dataclass
class PoolEntry:
    """One quarantined job profile plus the decision context that gated it."""

    id: int
    name: str
    confidence: float
    device_id: str
    fraction: float
    profile: WorkloadProfile

    def record(self) -> dict:
        """JSON-safe dict embedding the full profile codec."""
        return {
            "id": self.id,
            "name": self.name,
            "confidence": float(self.confidence),
            "device_id": self.device_id,
            "fraction": float(self.fraction),
            "profile": profile_record(self.profile),
        }

    @classmethod
    def from_record(cls, rec: dict, device=DEFAULT_DEVICE) -> "PoolEntry":
        return cls(
            id=int(rec["id"]),
            name=rec["name"],
            confidence=float(rec["confidence"]),
            device_id=rec.get("device_id", ""),
            fraction=float(rec.get("fraction", 0.0)),
            profile=profile_from_record(rec["profile"], device=device),
        )


class QuarantinePool:
    """Bounded FIFO pool of low-margin profiles.

    ``next_id`` is monotone across evictions and removals so entry ids in
    journal records stay unique for the life of a session; ``add_record``
    honours the id already stamped into the record, which lets write-ahead
    journaling record an entry before the live pool admits it and replay
    admit the identical entry later.
    """

    def __init__(self, capacity: int = 256, device=DEFAULT_DEVICE):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.device = resolve_device(device)
        self.entries: list[PoolEntry] = []
        self._next_id = 1

    @property
    def next_id(self) -> int:
        """Id the next admitted record should carry."""
        return self._next_id

    def add_record(self, rec: dict) -> PoolEntry:
        """Admit an entry record (live tap and journal replay both land here)."""
        entry = PoolEntry.from_record(rec, device=self.device)
        self._next_id = max(self._next_id, entry.id + 1)
        self.entries.append(entry)
        while len(self.entries) > self.capacity:
            self.entries.pop(0)
        return entry

    def remove(self, ids) -> int:
        """Drop the entries with the given ids; returns how many were dropped."""
        drop = set(int(i) for i in ids)
        before = len(self.entries)
        self.entries = [e for e in self.entries if e.id not in drop]
        return before - len(self.entries)

    def restore(self, records, next_id: int) -> None:
        """Rebuild the pool from snapshot state."""
        self.entries = [PoolEntry.from_record(rec, device=self.device)
                        for rec in records]
        self._next_id = max(
            int(next_id), *(e.id + 1 for e in self.entries), 1
        )

    def clear(self) -> None:
        self.entries = []

    def __len__(self) -> int:
        return len(self.entries)

    def __iter__(self):
        return iter(self.entries)
