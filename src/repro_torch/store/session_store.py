"""SessionStore: one directory = one durable session.

Layout::

    <store>/
        journal.jsonl            append-only write-ahead event journal
        journal-<k>.jsonl        sealed journal segments (rotation)
        journal.base.json        compaction base (folded-segment floor)
        snapshot-<seq>.json      checksummed state snapshots (latest 2 kept)

The store is codec-agnostic: callers hand it an ``encode`` callable (the
session passes ``repro_torch.api.results.to_dict``) so
``repro_torch.store`` never imports ``repro_torch.api`` — payloads are
encoded to JSON-ready dicts at record time and handed back verbatim on
recovery.

Snapshot cadence is record-count based (``snapshot_every``).  Writing a
snapshot synchronously inside :meth:`record` would capture state *before*
the just-journaled mutation applies, so reaching the cadence only marks a
snapshot as *due*; the session calls :meth:`flush_snapshot` after each
completed mutation, at which point the captured state includes everything
up to ``journal.last_seq``.
"""
from __future__ import annotations

import os
from contextlib import contextmanager

from .journal import JOURNAL_FILE, EventJournal, JournalRecord
from .snapshots import SnapshotStore

SNAPSHOT_EVERY = 25              # journal records between snapshots
ROTATE_EVERY = 10_000            # journal records per sealed segment


class StoreError(RuntimeError):
    """A session store could not be opened (distinct from 'no store')."""


class NoStoreError(StoreError):
    """The path holds no session store at all (nothing to resume)."""


def _identity(obj):
    return obj


class SessionStore:
    """Write-ahead journal + snapshot cadence for one session directory."""

    def __init__(self, path: str, *, encode=None, fsync: bool = False,
                 snapshot_every: int = SNAPSHOT_EVERY,
                 rotate_every: int | None = ROTATE_EVERY,
                 compact_every: int | None = None):
        self.path = path
        self.encode = encode or _identity
        self.capture = None          # zero-arg state capture (session-set)
        self.snapshot_every = max(int(snapshot_every), 1)
        self.rotate_every = int(rotate_every) if rotate_every else None
        self.compact_every = int(compact_every) if compact_every else None
        self.snapshots = SnapshotStore(path, fsync=fsync)
        self.journal: EventJournal | None = None
        self._recovered: list[JournalRecord] = []
        self._since_snapshot = 0
        self._snapshot_due = False
        self._since_compact = 0
        self._fsync = bool(fsync)

    # -- opening ---------------------------------------------------------
    @classmethod
    def create(cls, path: str, *, encode=None, fsync: bool = False,
               snapshot_every: int = SNAPSHOT_EVERY,
               rotate_every: int | None = ROTATE_EVERY,
               compact_every: int | None = None) -> "SessionStore":
        """Open ``path`` for a NEW session, extending any existing journal."""
        store = cls(path, encode=encode, fsync=fsync,
                    snapshot_every=snapshot_every, rotate_every=rotate_every,
                    compact_every=compact_every)
        journal_path = os.path.join(path, JOURNAL_FILE)
        if os.path.exists(journal_path) \
                or EventJournal.segments(journal_path) \
                or os.path.exists(EventJournal.base_path(journal_path)):
            store.journal, store._recovered = EventJournal.open_existing(
                journal_path, fsync=fsync, rotate_every=store.rotate_every)
        else:
            store.journal = EventJournal(journal_path, fsync=fsync,
                                         rotate_every=store.rotate_every)
        return store

    @classmethod
    def open_existing(cls, path: str, *, encode=None, fsync: bool = False,
                      snapshot_every: int = SNAPSHOT_EVERY,
                      rotate_every: int | None = ROTATE_EVERY,
                      compact_every: int | None = None) \
            -> "SessionStore":
        """Open ``path`` for resume.  Raises :class:`NoStoreError` when the
        path holds no store at all, :class:`StoreError` when a store exists
        but every record in it is damaged beyond recovery."""
        journal_path = os.path.join(path, JOURNAL_FILE)
        if not os.path.isdir(path) or not (
                os.path.exists(journal_path)
                or EventJournal.segments(journal_path)
                or os.path.exists(EventJournal.base_path(journal_path))):
            raise NoStoreError(
                f"no session store at {path!r}: the directory "
                f"{'exists but ' if os.path.isdir(path) else 'does not exist and '}"
                f"holds no {JOURNAL_FILE}. Pass the directory given as the "
                f"'store' config key of the session you want to resume.")
        store = cls(path, encode=encode, fsync=fsync,
                    snapshot_every=snapshot_every, rotate_every=rotate_every,
                    compact_every=compact_every)
        store.journal, store._recovered = EventJournal.open_existing(
            journal_path, fsync=fsync, rotate_every=store.rotate_every)
        # a fully-compacted store legitimately has zero loose records — its
        # state lives in the snapshot the base floor points at
        if not store._recovered and store.journal.base is None:
            raise StoreError(
                f"session store at {path!r} is corrupt: {JOURNAL_FILE} "
                f"exists but contains no intact records. The session cannot "
                f"be reconstructed; start fresh with "
                f"from_config({{'store': ...}}) on a new directory.")
        return store

    # -- recovered state -------------------------------------------------
    @property
    def recovered_records(self) -> list[JournalRecord]:
        """Every intact journal record found when the store was opened."""
        return self._recovered

    def records(self, after_seq: int = 0) -> list[JournalRecord]:
        """Recovered records with ``seq > after_seq`` (the replay tail)."""
        return [r for r in self._recovered if r.seq > after_seq]

    def load_snapshot(self) -> tuple[dict | None, int]:
        """Latest usable snapshot ``(state, seq)``; ``(None, 0)`` if none.
        Snapshots past the recovered journal tip (describing state a
        truncated journal can no longer reach) are skipped."""
        state, seq = self.snapshots.load_latest(
            max_seq=self.journal.last_seq if self.journal else None)
        base = self.journal.base if self.journal else None
        if state is None and base is not None and base["base_seq"] > 0:
            # compaction removed the records before the base floor; without
            # an intact snapshot at/under the tip there is nothing to
            # replay them from
            raise StoreError(
                f"session store at {self.path!r} was compacted through seq "
                f"{base['base_seq']} but no intact snapshot survives; the "
                f"folded records cannot be reconstructed.")
        return state, seq

    def open_record(self) -> JournalRecord | None:
        """The session's ``open`` record — the first journal record on an
        uncompacted store, or the copy preserved in the compaction base
        once the segment that held it has been folded away."""
        base = self.journal.base if self.journal else None
        if base is not None and base.get("open") is not None:
            o = base["open"]
            return JournalRecord(seq=int(o["seq"]), ts=float(o["ts"]),
                                 kind=o["kind"], data=o["data"])
        if self._recovered:
            return self._recovered[0]
        return None

    # -- writing ---------------------------------------------------------
    def record(self, kind: str, **data) -> int:
        """Journal one event (write-ahead: call BEFORE applying the
        mutation).  Payload values pass through ``encode``."""
        seq = self.journal.append(kind, {k: self.encode(v)
                                         for k, v in data.items()})
        self._since_snapshot += 1
        self._since_compact += 1
        if self._since_snapshot >= self.snapshot_every:
            self._snapshot_due = True
        return seq

    @contextmanager
    def batch(self):
        """Coalesce journal flushes across one fleet tick (see
        ``EventJournal.batch``): records inside the block land in append
        order but share one flush at exit.  ``fsync=True`` stores keep
        per-record durability.  Snapshots written mid-batch are safe — a
        crash that tears the unflushed journal tail truncates it on
        recovery, and :meth:`load_snapshot` already skips snapshots past
        the recovered tip."""
        if self.journal is None:
            yield self
            return
        with self.journal.batch():
            yield self

    def flush_snapshot(self, capture=None, force: bool = False) -> bool:
        """Write a snapshot if one is due (or ``force``).  ``capture`` is a
        zero-arg callable returning the JSON-ready session state (defaults
        to the attached ``self.capture``); it runs only when a snapshot is
        actually written.  With no capture available the due flag persists,
        so the next flush with one still writes."""
        capture = capture if capture is not None else self.capture
        if not (self._snapshot_due or force) or capture is None:
            return False
        self.snapshots.write(capture(), self.journal.last_seq)
        self._since_snapshot = 0
        self._snapshot_due = False
        if self.compact_every and self._since_compact >= self.compact_every:
            self._since_compact = 0
            self.compact(capture=capture)
        return True

    # -- compaction ------------------------------------------------------
    def compact(self, capture=None) -> int:
        """Fold sealed journal segments fully covered by the retained
        snapshots into the compaction base and remove them; returns the
        number of segments folded (0 when nothing is safely foldable).

        Safety rule: a segment folds only when *every* retained intact
        snapshot sits at or past its last record — restoring ANY surviving
        snapshot (including the N-1 fallback) then never needs the folded
        records.  The base file is written before the segments are
        removed, so a crash between the two leaves skippable leftovers.
        The session's ``open`` record is preserved inside the base."""
        journal = self.journal
        if journal is None:
            return 0
        journal_path = journal.path
        base = journal.base
        base_seq = base["base_seq"] if base else 0
        folded_k = base["through_segment"] if base else 0
        # sweep compaction leftovers from a prior crash (base written,
        # removal interrupted)
        for k, seg in EventJournal.segments(journal_path):
            if k <= folded_k:
                os.remove(seg)
        cap = capture if capture is not None else self.capture
        if cap is not None and journal.last_seq > base_seq:
            # a fresh snapshot at the tip maximizes how much can fold
            self.snapshots.write(cap(), journal.last_seq)
            self._since_snapshot = 0
            self._snapshot_due = False
        intact = self.snapshots.intact_seqs(max_seq=journal.last_seq)
        if len(intact) < 2:
            return 0                 # keep the N-1 fallback replayable
        floor = min(intact)          # oldest retained snapshot's seq
        open_rec = base["open"] if base else None
        folded: list[tuple[int, str]] = []
        after = base_seq
        for k, seg in EventJournal.segments(journal_path):
            recs, good = EventJournal._scan(seg, after)
            if not recs or good < os.path.getsize(seg):
                break                # damaged segment: leave for recovery
            if recs[-1].seq > floor:
                break                # still needed by the oldest snapshot
            if open_rec is None:
                for r in recs:
                    if r.kind == "open":
                        open_rec = {"seq": r.seq, "ts": r.ts,
                                    "kind": r.kind, "data": r.data}
                        break
            after = recs[-1].seq
            folded.append((k, seg))
        if not folded:
            return 0
        journal.base = EventJournal.write_base(
            journal_path, base_seq=after, through_segment=folded[-1][0],
            open_record=open_rec, fsync=self._fsync)
        for _, seg in folded:
            os.remove(seg)
        return len(folded)

    def close(self) -> None:
        if self.journal is not None:
            self.journal.close()
