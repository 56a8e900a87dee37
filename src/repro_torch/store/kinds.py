"""Canonical registry of journal record kinds.

Every record the write-ahead journal carries has a ``kind`` string; this
module is the ONE place those strings are defined.  Emitters
(``FleetCapController._journal``, ``MinosSession``'s store records) and the
resume dispatch (``MinosSession._apply_record``) both key on these
constants, so adding a record kind is a three-step contract:

  1. add the constant here (and to the matching group below);
  2. emit it write-ahead at the mutation site;
  3. handle it in ``MinosSession._apply_record`` (or add it to
     ``MARKER_KINDS`` if replay intentionally skips it).

The values are wire format — they appear verbatim in ``journal.jsonl``
records and inside their sha256 checksums — so renaming one breaks every
existing store.  Add, never rename.
"""
from __future__ import annotations

# -- session lifecycle -----------------------------------------------------
OPEN = "open"            # session construction facts (always record #1)
RESUME = "resume"        # a resume happened (marker; never replayed)

# -- job lifecycle ---------------------------------------------------------
ADMIT = "admit"          # job admitted (device binding + trace context)
DECISION = "decision"    # cap decision landed, with its JobPlan
RETIRE = "retire"        # job retired; its plan left the packing
REPROFILE = "reprofile"  # profiling run restarted (post-migration)
CURSOR = "cursor"        # round-robin placement cursor advanced

# -- fleet control ---------------------------------------------------------
BUDGET = "budget"        # shared power budget changed
FAIL = "fail"            # device failed (jobs migrate/shrink/strand)
DEGRADE = "degrade"      # device degraded (decided jobs drain)
RESTORE = "restore"      # device restored to the placement pool
EVENT = "event"          # informational FleetEvent (regenerated on replay)

# -- online class discovery ------------------------------------------------
QUARANTINE = "quarantine"  # low-margin profile entered the quarantine pool
PROMOTE = "promote"        # library version promoted (profiles journaled)
ROLLBACK = "rollback"      # promotion rolled back to the N-1 version

#: kinds replay acknowledges but intentionally skips: ``OPEN`` is the
#: construction record ``resume`` consumes up front, ``EVENT`` records are
#: informational (the deterministic controller logic regenerates identical
#: events), and ``RESUME`` is a marker of a past recovery.
MARKER_KINDS = frozenset({OPEN, EVENT, RESUME})

#: every registered record kind (the exhaustiveness pass's universe).
ALL_KINDS = frozenset({
    OPEN, RESUME, ADMIT, DECISION, RETIRE, REPROFILE, CURSOR,
    BUDGET, FAIL, DEGRADE, RESTORE, EVENT,
    QUARANTINE, PROMOTE, ROLLBACK,
})
