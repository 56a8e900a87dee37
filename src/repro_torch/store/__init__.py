"""Durable session storage: write-ahead event journal + snapshot store.

``repro_torch.store`` is the persistence layer under ``MinosSession``'s
``store`` config key: every decision, plan, retirement, budget change and
device-health transition is journaled before it takes effect, snapshots of
the materialized state are written on a record-count cadence, and
``MinosSession.resume`` reconstructs a crashed session from the latest
intact snapshot plus the journal tail — with zero classifier calls.

This package is deliberately codec-agnostic (no ``repro_torch.api`` imports):
the session injects its own encoder, and :mod:`repro_torch.store.reports`
consumes the raw journal dicts directly.
"""
from .journal import JOURNAL_FILE, EventJournal, JournalRecord
from .reports import JournalView, journal_view, store_report, windowed_report
from .session_store import (
    ROTATE_EVERY,
    SNAPSHOT_EVERY,
    NoStoreError,
    SessionStore,
    StoreError,
)
from .snapshots import SNAPSHOT_RETAIN, SnapshotStore

__all__ = [
    "JOURNAL_FILE",
    "ROTATE_EVERY",
    "SNAPSHOT_EVERY",
    "SNAPSHOT_RETAIN",
    "EventJournal",
    "JournalRecord",
    "JournalView",
    "journal_view",
    "NoStoreError",
    "SessionStore",
    "SnapshotStore",
    "StoreError",
    "store_report",
    "windowed_report",
]
