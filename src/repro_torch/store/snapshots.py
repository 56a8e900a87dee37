"""Checksummed snapshot store with N-1 rollback.

A snapshot is the fully materialized session state (jobs with their adopted
decisions/plans, retired jobs, device health, the event trail, counters) as
of one journal sequence number: restoring snapshot ``k`` and replaying the
journal records with ``seq > k`` reconstructs the exact pre-crash state
without touching the records before ``k``.

Snapshots are written atomically (tmp file + ``os.replace``) with a sha256
checksum over the canonical payload, and the store retains the latest TWO:
if the newest snapshot is corrupt (torn write, bit rot), ``load_latest``
warns and falls back to its predecessor — recovery then just replays a
longer journal tail.  Older snapshots are pruned on every write, so disk
use is bounded no matter how long the session runs.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import time
import warnings

SNAPSHOT_RETAIN = 2              # latest + one fallback (N-1 rollback)

_CANONICAL = dict(sort_keys=True, separators=(",", ":"), allow_nan=False)
_SNAP_RE = re.compile(r"^snapshot-(\d{10})\.json$")


def _checksum(seq: int, ts: float, state) -> str:
    body = json.dumps({"seq": seq, "ts": ts, "state": state}, **_CANONICAL)
    return hashlib.sha256(body.encode()).hexdigest()


class SnapshotStore:
    """Write/load checksummed state snapshots under a store directory."""

    def __init__(self, directory: str, retain: int = SNAPSHOT_RETAIN,
                 fsync: bool = False):
        self.directory = directory
        self.retain = max(int(retain), 1)
        self.fsync = bool(fsync)

    def _path(self, seq: int) -> str:
        return os.path.join(self.directory, f"snapshot-{seq:010d}.json")

    def _listing(self) -> list[tuple[int, str]]:
        """(seq, path) pairs for every snapshot file, newest first."""
        out = []
        if os.path.isdir(self.directory):
            for name in os.listdir(self.directory):
                m = _SNAP_RE.match(name)
                if m:
                    out.append((int(m.group(1)),
                                os.path.join(self.directory, name)))
        return sorted(out, reverse=True)

    # -- writing ---------------------------------------------------------
    def write(self, state, seq: int, ts: float | None = None) -> str:
        """Atomically persist ``state`` as the snapshot at journal ``seq``
        and prune beyond the retention window.  Returns the file path."""
        os.makedirs(self.directory, exist_ok=True)
        # ts is informational metadata (recovery keys on seq, not ts);
        # deterministic callers pin it via the parameter
        ts = time.time() if ts is None else float(ts)  # minoslint: disable=W301
        payload = {"seq": int(seq), "ts": ts, "state": state,
                   "sha": _checksum(int(seq), ts, state)}
        path = self._path(int(seq))
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            # dumps, not dump: the same bytes, from the C encoder (dump
            # streams through the pure-Python one, ~10x slower on a fleet)
            f.write(json.dumps(payload, **_CANONICAL))
            f.flush()
            if self.fsync:
                os.fsync(f.fileno())
        os.replace(tmp, path)
        for _, old in self._listing()[self.retain:]:
            os.remove(old)
        return path

    # -- recovery --------------------------------------------------------
    def _verify(self, seq: int, path: str) -> dict:
        """Parse + checksum one snapshot file; raises on any damage."""
        with open(path, encoding="utf-8") as f:
            payload = json.load(f)
        state = payload["state"]
        if payload["sha"] != _checksum(int(payload["seq"]),
                                       float(payload["ts"]), state):
            raise ValueError("checksum mismatch")
        if int(payload["seq"]) != seq:
            raise ValueError(f"claims seq {payload['seq']}, "
                             f"file says {seq}")
        return state

    def intact_seqs(self, max_seq: float | None = None) -> list[int]:
        """Sequence numbers of every snapshot that verifies, newest first.
        Corrupt files are silently skipped (no warning — this is a
        compaction-planning probe, not a recovery path); ``max_seq``
        filters like ``load_latest``."""
        out = []
        for seq, path in self._listing():
            if max_seq is not None and seq > max_seq:
                continue
            try:
                self._verify(seq, path)
            except (OSError, ValueError, KeyError, TypeError):
                continue
            out.append(seq)
        return out

    def load_latest(self, max_seq: float | None = None) \
            -> tuple[dict | None, int]:
        """The newest *intact* snapshot as ``(state, seq)``.

        A snapshot that fails to parse or checksum is warned about and
        skipped in favor of its predecessor (the N-1 rollback); with no
        intact snapshot at all, returns ``(None, 0)`` — the session then
        recovers by replaying the journal from the beginning.

        ``max_seq`` (the journal's recovered tip) silently skips snapshots
        from *beyond* the surviving journal: after a tail truncation they
        describe state the journal can no longer reach."""
        for seq, path in self._listing():
            if max_seq is not None and seq > max_seq:
                continue
            try:
                state = self._verify(seq, path)
            except (OSError, ValueError, KeyError, TypeError) as e:
                warnings.warn(
                    f"snapshot {path} is corrupt ({e}); falling back to the "
                    f"previous snapshot (longer journal replay)",
                    RuntimeWarning)
                continue
            return state, seq
        return None, 0
