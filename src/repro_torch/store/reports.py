"""Windowed reports derived from the event journal.

The journal is the source of truth for everything a ``SessionReport``
summarizes — so operational reports (utilization, headroom, migration
counts over time windows) are computed here straight from the recovered
records, without a live session and without importing ``repro_torch.api``.
Payloads are consumed as the raw JSON-ready dicts the codec produced
(``__type__`` tags are ignored, ``__float__`` tags are decoded locally).

Repeated reporting over the same on-disk journal is cheap:
``store_report`` parses each journal once into a columnar
:class:`JournalView` — parallel ``(seq, ts, kind, value)`` columns holding
only the fields the aggregation consumes — and caches it keyed by a
fingerprint of every segment's ``(name, size, mtime_ns)``.  Re-windowing a
10k-record journal at a different ``window_s`` then re-aggregates the
digest instead of re-reading and re-checksumming the file; any append or
rotation changes the fingerprint and invalidates the cache.
"""
from __future__ import annotations

import math
import os

from . import kinds
from .journal import JOURNAL_FILE, EventJournal, JournalRecord


def _num(value, default: float = 0.0) -> float:
    """Decode a journal number: plain float/int or a ``__float__`` tag."""
    if isinstance(value, dict) and set(value) == {"__float__"}:
        return float(value["__float__"])
    if isinstance(value, (int, float)):
        return float(value)
    return default


def _fields(record) -> tuple[int, float, str, dict]:
    if isinstance(record, JournalRecord):
        return record.seq, record.ts, record.kind, record.data
    return (int(record["seq"]), float(record["ts"]),
            str(record["kind"]), record.get("data", {}))


def _digest(kind: str, data: dict):
    """The one value aggregation needs from a record's payload."""
    if kind in (kinds.OPEN, kinds.BUDGET):
        return _num(data.get("budget_w"), math.inf)
    if kind == kinds.DECISION:
        plan = data.get("plan") or {}
        return (plan.get("job_id") or data.get("job_id", ""),
                _num(plan.get("predicted_p90_w")))
    if kind in (kinds.RETIRE, kinds.REPROFILE):
        return data.get("job_id", "")
    if kind == kinds.EVENT:
        return (data.get("event") or {}).get("kind", "")
    return None


class JournalView:
    """Columnar digest of a journal: parallel ``seqs``/``tss``/``kinds``/
    ``vals`` tuples in sequence order, holding only what windowed
    aggregation consumes.  Building one costs a single pass over the
    records; re-aggregating it (any ``window_s``) never touches disk."""

    __slots__ = ("seqs", "tss", "kinds", "vals")

    def __init__(self, records):
        rows = sorted((_fields(r) for r in records), key=lambda f: f[0])
        self.seqs = tuple(r[0] for r in rows)
        self.tss = tuple(r[1] for r in rows)
        self.kinds = tuple(r[2] for r in rows)
        self.vals = tuple(_digest(r[2], r[3]) for r in rows)

    def __len__(self) -> int:
        return len(self.seqs)


def _blank_window(start: float, end: float) -> dict:
    return {"start": start, "end": end, "records": 0,
            "admits": 0, "decisions": 0, "retires": 0,
            "migrations": 0, "shrinks": 0, "strands": 0,
            "failures": 0, "degrades": 0, "restores": 0}


def _aggregate(view: JournalView, window_s: float) -> list[dict]:
    window_s = float(window_s)
    if window_s <= 0:
        raise ValueError(f"window_s must be positive, got {window_s}")
    if not view.seqs:
        return []

    budget_w = math.inf
    planned: dict[str, float] = {}       # job_id -> predicted p90 watts
    windows: list[dict] = []
    origin = view.tss[0]

    def _close(win):
        total = sum(planned.values())
        win["planned_w"] = total
        win["budget_w"] = budget_w
        win["headroom_w"] = budget_w - total
        win["utilization"] = (total / budget_w
                              if math.isfinite(budget_w) and budget_w > 0
                              else None)
        windows.append(win)

    win = _blank_window(origin, origin + window_s)
    for ts, kind, val in zip(view.tss, view.kinds, view.vals):
        while ts >= win["end"]:
            _close(win)
            win = _blank_window(win["end"], win["end"] + window_s)
        win["records"] += 1
        if kind in (kinds.OPEN, kinds.BUDGET):
            budget_w = val
        elif kind == kinds.ADMIT:
            win["admits"] += 1
        elif kind == kinds.DECISION:
            win["decisions"] += 1
            job_id, p90 = val
            planned[job_id] = p90
        elif kind == kinds.RETIRE:
            win["retires"] += 1
            planned.pop(val, None)
        elif kind == kinds.FAIL:
            win["failures"] += 1
        elif kind == kinds.DEGRADE:
            win["degrades"] += 1
        elif kind == kinds.RESTORE:
            win["restores"] += 1
        elif kind == kinds.EVENT:
            if val == "migrate":
                win["migrations"] += 1
            elif val == "shrink":
                win["shrinks"] += 1
            elif val == "strand":
                win["strands"] += 1
        elif kind == kinds.REPROFILE:
            planned.pop(val, None)
    _close(win)
    return windows


def windowed_report(records, window_s: float = 60.0) -> list[dict]:
    """Aggregate journal ``records`` into consecutive time windows.

    Each window reports event counts (admits, decisions, retires,
    migrations, shrinks, strands, device failures/degrades/restores) plus
    the power picture at the window's close: ``planned_w`` (sum of the
    predicted p90 draw of every decided, still-active plan), ``budget_w``,
    ``headroom_w`` and ``utilization`` (``planned_w / budget_w``, ``None``
    under an unbounded budget).  Windows with no records are still emitted
    so the timeline has no gaps.
    """
    return _aggregate(JournalView(records), window_s)


# -- on-disk view cache --------------------------------------------------
_VIEW_CACHE: dict[str, tuple[tuple, JournalView]] = {}


def _fingerprint(journal_path: str) -> tuple:
    """Identity of the on-disk journal: every segment's (name, size,
    mtime_ns), sealed segments first, live file last."""
    parts = []
    for _k, seg in EventJournal.segments(journal_path):
        st = os.stat(seg)
        parts.append((os.path.basename(seg), st.st_size, st.st_mtime_ns))
    if os.path.exists(journal_path):
        st = os.stat(journal_path)
        parts.append((os.path.basename(journal_path), st.st_size,
                      st.st_mtime_ns))
    return tuple(parts)


def journal_view(journal_path: str) -> JournalView:
    """Cached columnar view of the journal at ``journal_path`` (segments
    included).  The fingerprint is taken BEFORE reading, so a concurrent
    append mid-read changes the next call's fingerprint and re-parses."""
    key = os.path.abspath(journal_path)
    fp = _fingerprint(journal_path)
    cached = _VIEW_CACHE.get(key)
    if cached is not None and cached[0] == fp:
        return cached[1]
    records, _ = EventJournal.recover(journal_path)
    view = JournalView(records)
    _VIEW_CACHE[key] = (fp, view)
    return view


def store_report(path: str, window_s: float = 60.0) -> list[dict]:
    """``windowed_report`` over the journal found in store ``path``,
    served from the fingerprint-keyed columnar view cache."""
    journal_path = os.path.join(path, JOURNAL_FILE)
    if not os.path.exists(journal_path) \
            and not EventJournal.segments(journal_path):
        raise FileNotFoundError(f"no {JOURNAL_FILE} under {path!r}")
    return _aggregate(journal_view(journal_path), window_s)
