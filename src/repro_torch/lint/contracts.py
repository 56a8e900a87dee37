"""The port's contract configuration consumed by the lint passes.

Everything policy lives here — the passes themselves are mechanism.  The
entries are the reference's (``repro.lint.contracts``) pointed at the
port's files; where the port's design differs from the reference's
(the top-level ``device`` module, models dispatching to hand-written
kernels, the JAX package as a package the port never imports) the entry
says so, and why.
"""
from __future__ import annotations

#: the package whose tree these contracts describe: imports of
#: ``<ROOT_PACKAGE>.X`` are edges of the DAG below.
ROOT_PACKAGE = "repro_torch"

# -- W1xx · write-ahead discipline ---------------------------------------

#: files whose journaled classes the write-ahead pass audits.  A class is
#: "journaled" when any of its methods makes a journal call (see
#: ``writeahead.is_journal_call``); plain value classes in the same file
#: are skipped automatically.
JOURNALED_FILES = (
    "src/repro_torch/fleet/controller.py",
    "src/repro_torch/api/session.py",
    "src/repro_torch/discovery/controller.py",
    "src/repro_torch/store/",
)

#: ``self._fleet.<name>(...)`` calls that count as journal dominators: the
#: callee journals write-ahead itself, so the caller's follow-up mutations
#: (handle tables, mirrors) are covered by the delegate's record.
JOURNAL_DELEGATES = frozenset({
    "admit", "admit_jobs", "retire", "set_budget", "fail_device",
    "degrade_device", "restore_device", "restart_profile", "_decide",
    "apply_event", "quarantine",
})

#: attributes exempt from W101: derived caches, counters, and mirrors that
#: replay rebuilds from the journaled causes — mutating them is not state
#: the journal must capture first.
DERIVED_ATTRS = frozenset({
    # fleet controller: telemetry/bookkeeping regenerated by replay
    "events", "repacks", "repack_s", "_dropped", "_packer", "clf",
    "builder", "scheduler",
    # api session: handle mirrors + the round-robin cursor (the cursor is
    # journaled *after* advancing, by design: the record carries the
    # post-advance value replay assigns verbatim).  _default_device is a
    # memoized deterministic constant (DeviceInventory.generate(1)[0]).
    "_handles", "_retired", "_rr", "_store", "_discovery",
    "_default_device",
    # fleet controller: discovery attachment is construction-time wiring
    # that resume re-establishes explicitly, not journaled state
    "discovery",
    # store bookkeeping: snapshot/compaction cadence counters
    "_since_snapshot", "_snapshot_due", "_since_compact",
    # discovery controller: profiler/cadence internals
    "profiler", "_since_recluster",
})

#: methods exempt from W101 wholesale: the *apply* halves of the
#: journal-then-apply split (replay calls them directly, so by definition
#: they mutate without journaling), plus restore/adoption paths that
#: reconstruct state from already-durable records.
APPLY_METHODS = frozenset({
    "_admit_apply", "_set_plan", "_apply_record", "_replay_admit",
    "_restore_state", "_attach_store", "adopt_promoted", "admit_record",
    "restore", "rollback", "_load_snapshot", "resume",
})

# -- W2xx · journal-record exhaustiveness --------------------------------

#: the canonical record-kind registry (constants + ALL_KINDS).
KINDS_REGISTRY = "src/repro_torch/store/kinds.py"

#: the resume/replay dispatch function: every registered kind must be
#: handled by (exactly) one ``case`` here, or be a registry marker.
DISPATCH_FUNC = "_apply_record"

# -- W3xx · determinism discipline ---------------------------------------

#: byte-identity-pinned packages: classification must be bit-reproducible
#: (the port's tests hold its pipeline output and journal bytes to the
#: reference's), so no wall-clock, no unseeded RNG, no iteration-order
#: leaks in these trees.
PINNED_DIRS = (
    "src/repro_torch/pipeline/",
    "src/repro_torch/sched/",
    "src/repro_torch/kernels/",
    "src/repro_torch/store/",
)

# -- W4xx · layering / import boundary -----------------------------------

#: the allowed package DAG under ``repro_torch``: package -> packages it
#: may import.  The reference's DAG plus two kinds of edge its design
#: needs and the reference's cannot name:
#:
#: * ``device`` — the port's top-level device policy (``resolve_device``:
#:   the card unless the caller asks for the CPU, never a silent
#:   fallback).  It imports nothing; every package whose entry points take
#:   a ``device=`` argument has an edge to it.
#: * ``models -> kernels`` — the port's models dispatch attention, norms
#:   and the selective scan to the hand-written CUDA kernels, where the
#:   reference's models compute ``jnp``.
#:
#: The process groups of a (1, tp) mesh (``models.parallel``: the
#: collectives the sharded layers run, the ranks as threads or as
#: ``torch.distributed`` processes) live in ``models``, whose layers call
#: them; ``serve`` and ``launch`` reach them through their edges to
#: ``models``, and they build the kernels before ranks start through
#: ``models -> kernels``.  So they need no node or edge of their own.
#:
#: ``core`` never importing ``api`` (or ``fleet``) is the north-star edge;
#: ``store`` importing nothing keeps durability stdlib-only and
#: cycle-free.  ``kernels`` importing nothing keeps the build stdlib +
#: torch: the H100's SM count it plans launches for off the card is a
#: constant of its own (``kernels.build.H100_SMS``), not ``analysis``'s.
ALLOWED_EDGES = {
    "analysis": {"configs"},
    "api": {"core", "device", "discovery", "fleet", "ft", "pipeline",
            "sched", "store", "telemetry"},
    "checkpoint": set(),
    "configs": set(),
    "core": {"device", "kernels", "pipeline"},
    "data": {"configs"},
    "device": set(),
    "discovery": {"analysis", "core", "device", "pipeline", "telemetry"},
    "fleet": {"analysis", "configs", "core", "device", "ft", "pipeline",
              "sched", "store", "telemetry"},
    "ft": {"configs"},
    "kernels": set(),
    "launch": {"analysis", "api", "configs", "device", "models", "sched",
               "serve", "telemetry", "train"},
    "legacy": {"core", "telemetry"},
    "lint": set(),
    "models": {"configs", "device", "kernels"},
    "optim": {"configs"},
    "pipeline": {"analysis", "core", "device", "kernels", "telemetry"},
    "sched": {"analysis", "core"},
    "serve": {"configs", "device", "models"},
    "store": set(),
    "telemetry": {"analysis", "configs", "core", "device", "pipeline"},
    "train": {"checkpoint", "configs", "data", "device", "ft", "models",
              "optim"},
}

#: packages nothing outside ``tests/`` may import, lazily or not: the JAX
#: stack and the reference package.  The port keeps its own copy of what
#: it needs; only its tests import both to hold one against the other.
FOREIGN_PACKAGES = ("jax", "jaxlib", "repro")

#: where ``FOREIGN_PACKAGES`` may be imported: the port's tests.
FOREIGN_ALLOWED = ("tests/",)

#: facade files: user-facing entry points that must consume the library
#: only through its public surface.
FACADE_FILES = (
    "examples/quickstart_torch.py",
    "examples/fleet_power_planner_torch.py",
)

#: the only repro_torch modules a facade file may import.
FACADE_ALLOWED = ("repro_torch.api", "repro_torch.fleet")

#: ``repro_torch.legacy`` is the frozen seed surface: only its
#: characterization tests and ``chip_smoke.py``'s golden check of the
#: kernels against the seed loops may import it.
LEGACY_ALLOWED = ("tests/", "chip_smoke.py")

# -- W5xx · float contract -----------------------------------------------

#: modules whose tests pin 1e-9 agreement or byte identity: bare float
#: equality against a non-integral literal is a latent flake there.
FLOAT_EQ_DIRS = PINNED_DIRS + ("src/repro_torch/core/",)

#: modules where an implicit float32 downcast silently breaks the float64
#: reference contract.  ``kernels/`` is deliberately absent: the CUDA
#: kernels' float32 paths compute in float32 by design, and the float64
#: *reference* implementations they are pinned against live in
#: ``core``/``pipeline``.
DOWNCAST_DIRS = ("src/repro_torch/pipeline/", "src/repro_torch/sched/",
                 "src/repro_torch/store/")
