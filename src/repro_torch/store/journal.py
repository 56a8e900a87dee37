"""Append-only write-ahead event journal (the durability primitive).

One ``journal.jsonl`` file per session store: every record is a single
JSON line carrying a monotonically increasing sequence number, a wall-clock
timestamp, a record kind, an arbitrary JSON payload, and a sha256 checksum
over the canonical encoding of the other four fields.  Records are written
*before* the mutation they describe takes effect (write-ahead semantics),
flushed per record, and optionally fsynced.

Crash tolerance is asymmetric by design: appends are cheap and optimistic,
recovery is paranoid.  ``EventJournal.recover`` replays the file line by
line and stops at the FIRST sign of damage — a line without a trailing
newline (torn write), unparseable JSON, a checksum mismatch, or a sequence
break — warning and discarding everything from that point on (a corrupt
record invalidates its successors: they may describe state that was never
reached).  Re-opening a journal for append truncates the file back to the
last intact record, so the recovered session and the on-disk tail agree.

Segment rotation bounds the live file for month-long sessions: with
``rotate_every=k`` the live ``journal.jsonl`` is sealed as
``journal-<n>.jsonl`` every ``k`` records and a fresh live file starts.
Sequence numbers run unbroken across segments; ``recover`` reads sealed
segments in order before the live file, so readers see one continuous
journal.  Sealed segments are immutable — torn-tail *truncation* only ever
applies to the live segment.  A damaged sealed segment invalidates its
successors exactly like a damaged record: recovery stops there, and
re-opening for append quarantines the unreachable suffix (``.corrupt``
renames, nothing deleted) and resumes appending from the last intact
record.

Compaction (``SessionStore.compact``) folds sealed segments whose records
are fully covered by the retained snapshots into a checksummed *base file*
(``journal.base.json``): it records the sequence number the surviving
journal now starts after (``base_seq``), the highest folded segment number
(``through_segment``), and the session's preserved ``open`` record.
Recovery chains from ``base_seq`` instead of 0 and skips any segment at or
below ``through_segment`` (a crash between the base write and the segment
removal leaves harmless leftovers).  Sequence numbers never restart — the
journal stays one unbroken sequence, just with a floor.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import time
import warnings
from contextlib import contextmanager
from dataclasses import dataclass

JOURNAL_FILE = "journal.jsonl"

_CANONICAL = dict(sort_keys=True, separators=(",", ":"), allow_nan=False)


def _checksum(seq: int, ts: float, kind: str, data) -> str:
    body = json.dumps({"seq": seq, "ts": ts, "kind": kind, "data": data},
                      **_CANONICAL)
    return hashlib.sha256(body.encode()).hexdigest()


def _base_checksum(base_seq: int, through_segment: int, open_record) -> str:
    body = json.dumps({"base_seq": base_seq,
                       "through_segment": through_segment,
                       "open": open_record}, **_CANONICAL)
    return hashlib.sha256(body.encode()).hexdigest()


@dataclass(frozen=True)
class JournalRecord:
    """One durably recorded session event."""
    seq: int                     # 1-based, strictly consecutive
    ts: float                    # wall-clock append time (time.time())
    kind: str                    # admit|decision|retire|budget|fail|...
    data: dict                   # JSON-ready payload (pre-encoded by caller)


class EventJournal:
    """Append-only JSONL journal with per-record checksums and optional
    record-count segment rotation."""

    def __init__(self, path: str, fsync: bool = False,
                 start_seq: int = 0, rotate_every: int | None = None,
                 segment_records: int = 0, next_segment: int = 1):
        self.path = path
        self.fsync = bool(fsync)
        self.rotate_every = int(rotate_every) if rotate_every else None
        self._seq = int(start_seq)
        self._fh = None
        self._batch_depth = 0
        self._dirty = False
        self._segment_records = int(segment_records)
        self._next_segment = int(next_segment)
        # compaction base ({"base_seq", "through_segment", "open"} or None):
        # set by open_existing from the on-disk base file and updated by
        # SessionStore.compact when segments fold
        self.base: dict | None = None

    @property
    def last_seq(self) -> int:
        return self._seq

    def _handle(self):
        if self._fh is None:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            self._fh = open(self.path, "a", encoding="utf-8")
        return self._fh

    # -- segment naming --------------------------------------------------
    def _segment_path(self, k: int) -> str:
        return self.segment_path(self.path, k)

    @staticmethod
    def segment_path(path: str, k: int) -> str:
        """Sealed-segment name for a live journal ``path``:
        ``journal.jsonl`` -> ``journal-<k>.jsonl``."""
        root, ext = os.path.splitext(path)
        return f"{root}-{k}{ext}"

    @staticmethod
    def segments(path: str) -> list[tuple[int, str]]:
        """Sealed segments beside the live journal ``path``, as ``(k,
        segment_path)`` sorted by seal order (oldest first)."""
        dirname = os.path.dirname(path) or "."
        root, ext = os.path.splitext(os.path.basename(path))
        pat = re.compile(rf"^{re.escape(root)}-(\d+){re.escape(ext)}$")
        found = []
        if os.path.isdir(dirname):
            for name in os.listdir(dirname):
                m = pat.match(name)
                if m:
                    found.append((int(m.group(1)),
                                  os.path.join(dirname, name)))
        return sorted(found)

    # -- compaction base -------------------------------------------------
    @staticmethod
    def base_path(path: str) -> str:
        """Compaction-base name for a live journal ``path``:
        ``journal.jsonl`` -> ``journal.base.json``."""
        root, _ = os.path.splitext(path)
        return f"{root}.base.json"

    @classmethod
    def read_base(cls, path: str) -> dict | None:
        """The journal's compaction base (``None`` when never compacted).
        A corrupt base file is warned about and treated as absent — the
        records folded into it are unrecoverable, so downstream recovery
        will (correctly) fail rather than rebuild partial state."""
        bp = cls.base_path(path)
        if not os.path.exists(bp):
            return None
        try:
            with open(bp, encoding="utf-8") as f:
                payload = json.load(f)
            base_seq = int(payload["base_seq"])
            through = int(payload["through_segment"])
            open_rec = payload["open"]
            if payload["sha"] != _base_checksum(base_seq, through, open_rec):
                raise ValueError("checksum mismatch")
        except (OSError, ValueError, KeyError, TypeError) as e:
            warnings.warn(
                f"journal base {bp} is corrupt ({e}); ignoring it — the "
                f"records compacted into it are lost", RuntimeWarning)
            return None
        return {"base_seq": base_seq, "through_segment": through,
                "open": open_rec}

    @classmethod
    def write_base(cls, path: str, base_seq: int, through_segment: int,
                   open_record: dict | None, fsync: bool = False) -> dict:
        """Atomically persist the compaction base (tmp + ``os.replace``);
        written BEFORE the folded segments are removed, so a crash between
        the two leaves skippable leftovers, never a gap."""
        bp = cls.base_path(path)
        payload = {"base_seq": int(base_seq),
                   "through_segment": int(through_segment),
                   "open": open_record,
                   "sha": _base_checksum(int(base_seq), int(through_segment),
                                         open_record)}
        tmp = bp + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(payload, f, **_CANONICAL)
            f.flush()
            if fsync:
                os.fsync(f.fileno())
        os.replace(tmp, bp)
        return {"base_seq": int(base_seq),
                "through_segment": int(through_segment), "open": open_record}

    # -- writing ---------------------------------------------------------
    def append(self, kind: str, data: dict, ts: float | None = None) -> int:
        """Durably record one event; returns its sequence number.  The line
        hits the OS (flush) before this returns — and the disk, with
        ``fsync`` — so a crash immediately after sees the record.

        Inside a ``batch()`` block (and without ``fsync``) the flush is
        deferred to batch exit, coalescing one syscall per record into one
        per tick; recovery already tolerates a torn batched tail exactly
        like any torn record."""
        seq = self._seq + 1
        # ts is informational wall-clock metadata, never replayed into
        # session state; deterministic callers pin it via the parameter
        ts = time.time() if ts is None else float(ts)
        rec = {"seq": seq, "ts": ts, "kind": str(kind), "data": data}
        rec["sha"] = _checksum(seq, ts, rec["kind"], data)
        fh = self._handle()
        fh.write(json.dumps(rec, **_CANONICAL) + "\n")
        if self._batch_depth and not self.fsync:
            self._dirty = True
        else:
            fh.flush()
            if self.fsync:
                os.fsync(fh.fileno())
        self._seq = seq
        self._segment_records += 1
        if self.rotate_every and self._segment_records >= self.rotate_every:
            self._rotate()
        return seq

    def _rotate(self) -> None:
        """Seal the live file as the next numbered segment and start a
        fresh live journal.  The sealed bytes are flushed (and fsynced,
        when configured) before the rename, so rotation never weakens
        durability — even mid-``batch()``."""
        fh = self._fh
        if fh is not None:
            fh.flush()
            if self.fsync:
                os.fsync(fh.fileno())
            fh.close()
            self._fh = None
        self._dirty = False
        os.replace(self.path, self._segment_path(self._next_segment))
        self._next_segment += 1
        self._segment_records = 0

    @contextmanager
    def batch(self):
        """Coalesce appends: records written inside the block share one
        flush at exit instead of flushing per record.  Write-ahead ordering
        within the file is unchanged (records still land in append order),
        and ``fsync=True`` journals keep their per-record flush+fsync —
        explicit durability is never weakened by batching.  Re-entrant."""
        self._batch_depth += 1
        try:
            yield self
        finally:
            self._batch_depth -= 1
            if self._batch_depth == 0 and self._dirty:
                self._dirty = False
                if self._fh is not None:
                    self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    # -- recovery --------------------------------------------------------
    @staticmethod
    def _scan(path: str, after_seq: int) -> tuple[list[JournalRecord], int]:
        """One file's intact records (expecting ``after_seq + 1`` first)
        and the byte offset just past the last intact record."""
        records: list[JournalRecord] = []
        good = 0
        with open(path, "rb") as f:
            raw = f.read()
        for line in raw.split(b"\n"):
            end = good + len(line) + 1          # +1 for the newline
            if end > len(raw):
                if line.strip():
                    warnings.warn(
                        f"journal {path}: torn record after seq "
                        f"{records[-1].seq if records else after_seq} (no "
                        f"trailing newline); truncating the damaged tail",
                        RuntimeWarning)
                break
            if not line.strip():
                good = end
                continue
            reason = None
            try:
                rec = json.loads(line)
                seq, ts = int(rec["seq"]), float(rec["ts"])
                kind, data, sha = rec["kind"], rec["data"], rec["sha"]
                if sha != _checksum(seq, ts, kind, data):
                    reason = "checksum mismatch"
                elif seq != (records[-1].seq if records
                             else after_seq) + 1:
                    reason = f"sequence break (got {seq})"
            except (ValueError, KeyError, TypeError) as e:
                reason = f"unparseable record ({type(e).__name__})"
            if reason is not None:
                warnings.warn(
                    f"journal {path}: {reason} after seq "
                    f"{records[-1].seq if records else after_seq}; "
                    f"truncating the damaged tail", RuntimeWarning)
                break
            records.append(JournalRecord(seq=seq, ts=ts, kind=kind,
                                         data=data))
            good = end
        return records, good

    @classmethod
    def _recover_all(cls, path: str):
        """Recover sealed segments (in order) then the live file.

        Returns ``(records, live_good, live_count, damage, base)``: all
        intact records across segments, the live file's truncation offset,
        how many of the records came from the live file, — when a SEALED
        segment is damaged — ``(k, segment_path, good_bytes, count)`` for
        it (everything after a sealed-segment wound is unreachable and is
        dropped, live file included), and the compaction base (or None).
        With a base, recovery chains from ``base_seq`` and segments at or
        below ``through_segment`` are skipped (compaction leftovers)."""
        base = cls.read_base(path)
        base_seq = base["base_seq"] if base else 0
        folded_k = base["through_segment"] if base else 0
        records: list[JournalRecord] = []
        for k, seg in cls.segments(path):
            if k <= folded_k:
                continue            # already folded into the base
            segrecs, good = cls._scan(
                seg, records[-1].seq if records else base_seq)
            records.extend(segrecs)
            if good < os.path.getsize(seg):
                warnings.warn(
                    f"journal segment {seg} is damaged mid-archive; "
                    f"records after seq "
                    f"{records[-1].seq if records else base_seq} (later "
                    f"segments and the live tail) are unreachable and "
                    f"dropped", RuntimeWarning)
                return records, 0, 0, (k, seg, good, len(segrecs)), base
        if not os.path.exists(path):
            return records, 0, 0, None, base
        liverecs, good = cls._scan(path,
                                   records[-1].seq if records else base_seq)
        records.extend(liverecs)
        return records, good, len(liverecs), None, base

    @classmethod
    def recover(cls, path: str) -> tuple[list[JournalRecord], int]:
        """Read every intact record — sealed segments in seal order, then
        the live file — tolerating a damaged tail.

        Returns ``(records, good_bytes)`` where ``good_bytes`` is the byte
        offset just past the live file's last intact record — the
        truncation point for re-opening the journal in append mode (0 when
        a damaged *sealed* segment made the live file unreachable).  Never
        raises on damage: torn/corrupt tails produce a ``RuntimeWarning``
        and are dropped.  Read-only: no file is modified.  On a compacted
        journal only the records after the base floor are returned."""
        records, live_good, _, _, _ = cls._recover_all(path)
        return records, live_good

    @classmethod
    def open_existing(cls, path: str, fsync: bool = False,
                      rotate_every: int | None = None) \
            -> tuple["EventJournal", list[JournalRecord]]:
        """Recover ``path`` (segments included) and open it for appending.

        The live file is truncated back to its last intact record so new
        appends extend clean state.  If a *sealed* segment is damaged, its
        unreachable successors (later segments and the old live file) are
        quarantined under ``.corrupt`` names — bytes renamed, never
        deleted — and the damaged segment, truncated to its intact prefix,
        becomes the live journal again."""
        records, live_good, live_count, damage, base = cls._recover_all(path)
        folded_k = base["through_segment"] if base else 0
        if damage is not None:
            k, seg, seg_good, seg_count = damage
            for k2, seg2 in cls.segments(path):
                if k2 > k:
                    os.replace(seg2, seg2 + ".corrupt")
            if os.path.exists(path):
                os.replace(path, path + ".corrupt")
            os.replace(seg, path)
            with open(path, "r+b") as f:
                f.truncate(seg_good)
            live_count, next_segment = seg_count, k
        else:
            if os.path.exists(path) \
                    and live_good < os.path.getsize(path):
                with open(path, "r+b") as f:
                    f.truncate(live_good)
            ks = [k for k, _ in cls.segments(path) if k > folded_k]
            next_segment = (max(ks + [folded_k]) + 1
                            if (ks or folded_k) else 1)
        journal = cls(path, fsync=fsync, rotate_every=rotate_every,
                      start_seq=records[-1].seq if records
                      else (base["base_seq"] if base else 0),
                      segment_records=live_count,
                      next_segment=next_segment)
        journal.base = base
        return journal, records
