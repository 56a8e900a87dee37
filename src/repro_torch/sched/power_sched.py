"""Power-aware cluster scheduling on top of Minos predictions (paper §4.3:
POLCA/TAPAS/PAL-style use cases).

Given a power budget and a queue of jobs (each a WorkloadProfile from a
single low-cost profiling run), the scheduler:
  1. runs Algorithm 1 per job to pick a frequency cap for the objective,
  2. estimates each job's per-chip power at that cap from its *neighbor's*
     scaling data (no extra profiling),
  3. packs jobs into the budget (first-fit decreasing), oversubscribing
     against nameplate TDP — the paper's motivating scenario.

Heterogeneity-aware extension: queue entries may carry a fleet
``DeviceInstance`` as a third element, in which case the neighbor's
*relative* power quantile is converted to watts with that device's
effective TDP (nameplate x per-chip power variability) instead of the
scheduler-wide ``tdp_w`` — slow-silicon chips cost more budget, efficient
ones less.  Two-element entries behave exactly as before.
"""
from __future__ import annotations

import math
import operator
from bisect import bisect_left
from dataclasses import dataclass, field

from repro_torch.core.algorithm1 import (FreqSelection, resolve_objective,
                                   select_optimal_freq)
from repro_torch.core.classify import MinosClassifier, WorkloadProfile

_BUILTIN_QUANTILES = ("p90", "p95", "p99")

# Exact fixed-point scale for power accounting.  Every finite float is
# p/q with q a power of two <= 2**1074, so scaling by 2**1100 embeds all
# per-job needs and budgets losslessly into integers: greedy first-fit
# accumulation becomes associative, which is what lets the incremental
# packer's checkpointed partial sums reproduce ``pack()`` byte-for-byte
# (float partial sums would drift by an ulp at block boundaries).
_SCALE = 1 << 1100

# budget sentinels for non-finite budgets (match float comparison
# semantics: +inf admits every finite need, -inf/NaN admit nothing)
_FIT_ALL = object()
_FIT_NONE = object()


def _exact(x: float) -> int:
    """Losslessly embed a finite float into the ``_SCALE`` integer grid."""
    n, d = x.as_integer_ratio()
    return n * (_SCALE // d)


def _exact_budget(budget_w) -> "int | object":
    b = float(budget_w)
    if math.isfinite(b):
        return _exact(b)
    return _FIT_ALL if b > 0 else _FIT_NONE


def _fits(total: int, budget) -> bool:
    if type(budget) is int:
        return total <= budget
    return budget is _FIT_ALL


def resolve_quantile(quantile):
    """Resolve a provisioning quantile to ``(name, rel_fn)`` where
    ``rel_fn(FreqPoint) -> float`` is the relative per-chip power to reserve.

    Builtin names read the matching ``FreqPoint`` attribute; anything else
    must be a ``QuantilePolicy``-like callable carrying a ``.name`` (custom
    quantiles register by name in ``repro_torch.api.QUANTILES``)."""
    if isinstance(quantile, str):
        if quantile not in _BUILTIN_QUANTILES:
            raise ValueError(f"unknown provisioning quantile {quantile!r} "
                             f"(builtins: {', '.join(_BUILTIN_QUANTILES)}; "
                             f"custom quantiles resolve by name through "
                             f"repro_torch.api.QUANTILES)")
        return quantile, operator.attrgetter(quantile)
    name = getattr(quantile, "name", None)
    if name and callable(quantile):
        return str(name), quantile
    raise ValueError(f"quantile must be a builtin name or a QuantilePolicy-"
                     f"like callable with a .name, got {quantile!r}")


@dataclass
class JobPlan:
    name: str
    chips: int
    cap: float
    predicted_p90_w: float       # per chip, at the scheduler's quantile
    selection: FreqSelection
    device_id: str = ""          # fleet device ("" = homogeneous pod)
    nameplate_w: float = 0.0     # per-chip TDP a non-Minos scheduler reserves
    job_id: str = ""             # queue-entry tag ("" = keyed by name)

    def __post_init__(self):
        # pack()'s first-fit-decreasing sort key, precomputed because a
        # fleet re-pack sorts the same (immutable) plans again and again;
        # a plain attribute so ``attrgetter`` stays a C-level lookup
        self._order_key = (-self.predicted_p90_w * self.chips, self.name,
                           self.device_id, self.job_id)
        # exact fixed-point power terms (None when non-finite): packing
        # arithmetic runs on these so incremental and full packs agree
        # bit-for-bit no matter how the additions associate
        need = self.predicted_p90_w * self.chips
        self._need = need
        self._need_exact = _exact(need) if math.isfinite(need) else None
        nameplate = self.nameplate_w * self.chips
        self._nameplate_exact = (_exact(nameplate)
                                 if math.isfinite(nameplate) else None)


@dataclass
class ScheduleResult:
    placed: list[JobPlan] = field(default_factory=list)
    deferred: list[str] = field(default_factory=list)
    budget_w: float = 0.0

    @property
    def planned_power_w(self) -> float:
        return sum(j.predicted_p90_w * j.chips for j in self.placed)

    @property
    def nameplate_power_w(self) -> float:
        # what a TDP-provisioned (non-Minos) scheduler would have to reserve
        return sum(j.nameplate_w * j.chips for j in self.placed)

    @property
    def headroom_reclaimed_w(self) -> float:
        """Watts of provisioning headroom Minos recovers vs nameplate TDP."""
        return self.nameplate_power_w - self.planned_power_w


class RepackStats:
    """Power accounting for a superseded fleet re-pack.

    The fleet's ``repacks`` history materializes full ``ScheduleResult``s
    lazily; once the live packer has moved past an entry, only its exact
    power totals are retained — enough for every aggregate consumer
    (budget-compliance sweeps, reports).  Reading ``placed``/``deferred``
    on a superseded entry raises: per-job placements of historical packs
    are not kept at fleet scale."""

    __slots__ = ("planned_power_w", "nameplate_power_w", "budget_w")

    def __init__(self, planned_power_w: float, nameplate_power_w: float,
                 budget_w: float):
        self.planned_power_w = planned_power_w
        self.nameplate_power_w = nameplate_power_w
        self.budget_w = budget_w

    @property
    def headroom_reclaimed_w(self) -> float:
        return self.nameplate_power_w - self.planned_power_w

    @property
    def placed(self):
        raise AttributeError(
            "this re-pack has been superseded; per-job placements are only "
            "materialized for the most recent pack (read fleet.repacks[-1] "
            "before mutating the fleet, or use PowerAwareScheduler.pack)")

    deferred = placed

    def __repr__(self):
        return (f"RepackStats(planned_power_w={self.planned_power_w!r}, "
                f"nameplate_power_w={self.nameplate_power_w!r}, "
                f"budget_w={self.budget_w!r})")


class PowerAwareScheduler:
    """First-fit-decreasing packer over Minos per-job power predictions.

    ``quantile`` selects which spike quantile of the neighbor's scaling data
    is provisioned per chip ("p90" reproduces the original behavior; the
    fleet controller packs at "p99" so coincident cross-job spikes stay
    inside a shared budget).
    """

    def __init__(self, clf: MinosClassifier, tdp_w: float,
                 objective="powercentric", quantile="p90"):
        self.clf = clf
        self.tdp_w = tdp_w
        self.objective_policy = resolve_objective(objective)
        self.objective = self.objective_policy.name
        self.quantile, self._rel = resolve_quantile(quantile)
        # per-(neighbor, cap) relative-power memo: the lookup chain below is
        # a pure function of the reference set, which is immutable for the
        # lifetime of the attached classifier (adopt_classifier resets it)
        self._rel_memo: dict[tuple[str, float], float] = {}
        self._ref_by_name: dict[str, WorkloadProfile] | None = None

    def adopt_classifier(self, clf: MinosClassifier) -> None:
        """Swap the reference classifier (a discovery promotion/rollback
        published a new library version) and drop the per-reference memos —
        they key on neighbor *names*, whose resolution must follow the new
        membership.  Plans already built keep their cached selections;
        re-costing them resolves names against the new reference set."""
        self.clf = clf
        self._rel_memo.clear()
        self._ref_by_name = None

    def plan_job(self, profile: WorkloadProfile, chips: int,
                 device=None) -> JobPlan:
        sel = select_optimal_freq(profile, self.clf)
        return self.plan_from_selection(sel, chips, device)

    def plan_from_selection(self, sel: FreqSelection, chips: int,
                            device=None, job_id: str = "") -> JobPlan:
        """Build a ``JobPlan`` from an already-made Algorithm 1 selection —
        the fleet controller's path: a job's online ``CapDecision`` carries
        the selection, so re-packing never re-classifies."""
        cap = self.objective_policy.cap(sel)
        rel = self._rel_memo.get((sel.power_neighbor, cap))
        if rel is None:
            if self._ref_by_name is None:
                self._ref_by_name = {r.name: r for r in self.clf.references}
            neighbor = self._ref_by_name[sel.power_neighbor]
            # nearest available frequency in the neighbor's scaling data
            f = min(neighbor.scaling, key=lambda x: abs(x - cap))
            rel = self._rel(neighbor.scaling[f])
            self._rel_memo[(sel.power_neighbor, cap)] = rel
        if device is None:
            watts_base, nameplate, did = self.tdp_w, self.tdp_w, ""
        else:
            watts_base = device.effective_tdp_w
            nameplate = device.nameplate_w
            did = device.device_id
        return JobPlan(sel.target, chips, cap, rel * watts_base, sel,
                       device_id=did, nameplate_w=nameplate, job_id=job_id)

    def migrate_plan(self, plan: JobPlan, device,
                     chips: int | None = None) -> JobPlan:
        """Re-host an existing plan on ``device`` (optionally at a new chip
        count — the elastic-shrink path): the cached Algorithm 1 selection
        is re-costed against the new device's effective TDP, so a migration
        is a dictionary lookup plus arithmetic — **never** a
        re-classification.  Device-portable classification makes this free:
        the neighbor's relative power curve is intrinsic to the workload,
        only the watts conversion is per-device."""
        return self.plan_from_selection(
            plan.selection, plan.chips if chips is None else int(chips),
            device, job_id=plan.job_id)

    def pack(self, plans, budget_w: float) -> ScheduleResult:
        """First-fit-decreasing over prebuilt ``JobPlan``s with a
        deterministic tie-break: equal-power jobs pack in (name, device,
        job) order regardless of queue order (repacking the same queue must
        always produce the same placement).

        Accounting runs on exact fixed-point integers (``plan._need_exact``)
        rather than floats, so the sum of placed needs never exceeds the
        budget by rounding and — critically — ``IncrementalPacker`` can
        reproduce this result byte-for-byte from checkpointed partial sums.
        Plans with non-finite need always defer under a finite budget, and
        a non-finite budget admits everything (+inf) or nothing (-inf/NaN),
        matching the float comparison semantics this loop always had."""
        plans = sorted(plans, key=operator.attrgetter("_order_key"))
        res = ScheduleResult(budget_w=budget_w)
        budget = _exact_budget(budget_w)
        used = 0
        for plan in plans:
            need = plan._need_exact
            if need is not None and _fits(used + need, budget):
                res.placed.append(plan)
                used += need
            else:
                res.deferred.append(plan.name)
        return res

    def schedule(self, jobs, budget_w: float) -> ScheduleResult:
        """Plan and pack ``jobs`` — ``(profile, chips)`` or ``(profile,
        chips, device)`` tuples — into ``budget_w``."""
        return self.pack((self.plan_job(*job) for job in jobs), budget_w)

    def packer(self, budget_w: float = 0.0,
               block_size: int = 128) -> "IncrementalPacker":
        """A fresh :class:`IncrementalPacker` seeded with ``budget_w`` —
        the control-plane companion to one-shot :meth:`pack`."""
        return IncrementalPacker(budget_w=budget_w, block_size=block_size)


class _Block:
    """One chunk of the packer's FFD-ordered plan sequence.

    ``placed_need``/``placed_nameplate`` are exact sums over the block's
    placed plans; ``min_fit`` is the minimum over the block's *deferred*
    plans of (in-block placed need before it + its own need) — the
    tightest admission that could flip if upstream usage shrinks.  Both
    let a re-flow decide in O(1) that a block's placements cannot change."""

    __slots__ = ("plans", "keys", "placed", "placed_need",
                 "placed_nameplate", "min_fit", "dirty")

    def __init__(self, plans, keys, placed):
        self.plans = plans
        self.keys = keys
        self.placed = placed
        self.placed_need = 0
        self.placed_nameplate = 0
        self.min_fit = None
        self.dirty = True


class IncrementalPacker:
    """First-fit-decreasing packing as a maintained structure, not a pass.

    Holds the live ``JobPlan`` population in ``_order_key`` order, chunked
    into ~``block_size`` blocks with checkpointed exact power sums, so one
    insert/remove or a budget change re-runs the greedy scan only over the
    blocks whose placements can actually change: the mutated block, plus
    any downstream block where the shifted entry usage could flip a
    placement (checked in O(1) per block via ``placed_need``/``min_fit``).
    Everything upstream — and every downstream block that provably packs
    the same — is skipped.  Per-event cost is O(block + n/block) instead
    of the full pack's O(n log n).

    Re-flows are **read-coalesced**: a mutation only splices the plan into
    its block and marks the dirty range (cheap list surgery, no exact
    arithmetic), and the greedy re-flow runs once at the next read
    (``result()`` / ``stats()`` / the power properties).  A burst of
    mutations between reads — a fleet tick deciding hundreds of jobs, one
    coalesced repack at the end — pays for ONE re-flow, not one per event,
    while a read-per-event caller sees exactly the per-event incremental
    cost.

    ``result()`` materializes a ``ScheduleResult`` **byte-identical** to
    ``PowerAwareScheduler.pack(plans, budget_w)`` over the same population
    (hypothesis-pinned in ``tests/test_incremental_pack.py``); both sides
    run on the same exact fixed-point arithmetic, so the equivalence is
    exact, not approximate.  ``version`` increments on every mutation —
    consumers holding a lazy reference can tell whether their snapshot is
    still the live state.

    Restrictions that keep the equivalence honest: plans must have finite
    need/nameplate and pairwise-distinct ``_order_key``s (the fleet always
    satisfies both — ``job_id`` is unique per controller); violations
    raise ``ValueError`` and the caller falls back to full packs."""

    def __init__(self, budget_w: float = 0.0, block_size: int = 128):
        self.budget_w = budget_w
        self._budget = _exact_budget(budget_w)
        self._block_size = max(8, int(block_size))
        self._blocks: list[_Block] = []
        self._last_keys: list[tuple] = []
        self._n = 0
        self.version = 0
        self._placed_need = 0          # exact, over all blocks
        self._placed_nameplate = 0     # exact, over all blocks
        self._dirty_lo: int | None = None   # pending re-flow block range
        self._dirty_hi: int | None = None
        self._prune_pending = False

    def __len__(self) -> int:
        return self._n

    @property
    def planned_power_w(self) -> float:
        self._flush()
        return self._placed_need / _SCALE

    @property
    def nameplate_power_w(self) -> float:
        self._flush()
        return self._placed_nameplate / _SCALE

    @property
    def headroom_reclaimed_w(self) -> float:
        self._flush()
        return (self._placed_nameplate - self._placed_need) / _SCALE

    # -- mutation ----------------------------------------------------------

    def insert(self, plan: JobPlan) -> None:
        """Admit ``plan`` into the packed population.

        O(block) list surgery now; the exact-arithmetic re-flow is
        deferred to the next read and shared by every mutation since."""
        if plan._need_exact is None or plan._nameplate_exact is None:
            raise ValueError(
                f"incremental packing requires finite power terms: "
                f"{plan.job_id or plan.name} has need={plan._need!r}, "
                f"nameplate={plan.nameplate_w * plan.chips!r}")
        key = plan._order_key
        if not self._blocks:
            self._blocks.append(_Block([plan], [key], [False]))
            self._last_keys.append(key)
            bi = 0
        else:
            bi = min(bisect_left(self._last_keys, key),
                     len(self._blocks) - 1)
            b = self._blocks[bi]
            pos = bisect_left(b.keys, key)
            if pos < len(b.keys) and b.keys[pos] == key:
                raise ValueError(
                    f"duplicate packing key for {plan.job_id or plan.name}: "
                    f"incremental packing requires distinct (need, name, "
                    f"device, job) identities")
            b.plans.insert(pos, plan)
            b.keys.insert(pos, key)
            b.placed.insert(pos, False)
            b.dirty = True
            if pos == len(b.keys) - 1:
                self._last_keys[bi] = key
        self._n += 1
        self.version += 1
        self._mark(bi)
        if len(self._blocks[bi].keys) > 2 * self._block_size:
            self._split(bi)

    def remove(self, plan: JobPlan) -> None:
        """Evict ``plan`` from the packed population.

        O(block) list surgery now; re-flow (and empty-block pruning) is
        deferred to the next read.  An emptied block keeps its stale last
        key until then — sound, because the vacated key range holds no
        plans, so lookups routed there correctly miss."""
        key = plan._order_key
        bi = bisect_left(self._last_keys, key)
        if bi == len(self._blocks):
            raise KeyError(f"plan not packed: {plan.job_id or plan.name}")
        b = self._blocks[bi]
        pos = bisect_left(b.keys, key)
        if (pos >= len(b.keys) or b.keys[pos] != key
                or (b.plans[pos] is not plan and b.plans[pos] != plan)):
            raise KeyError(f"plan not packed: {plan.job_id or plan.name}")
        del b.plans[pos], b.keys[pos], b.placed[pos]
        b.dirty = True
        if b.keys:
            self._last_keys[bi] = b.keys[-1]
        else:
            self._prune_pending = True
        self._n -= 1
        self.version += 1
        self._mark(bi)

    def replace(self, old: JobPlan, new: JobPlan) -> None:
        """Migration/shrink: swap one plan for its re-costed successor."""
        self.remove(old)
        self.insert(new)

    def set_budget(self, budget_w: float) -> None:
        """Re-flow every block against a new budget — still O(1) per block
        whose placements provably cannot change."""
        b, cur = float(budget_w), float(self.budget_w)
        if b == cur and math.copysign(1.0, b) == math.copysign(1.0, cur):
            self.budget_w = budget_w    # bit-identical budget: no re-flow
            return
        old = self._budget
        self.budget_w = budget_w
        self._budget = _exact_budget(budget_w)
        self.version += 1
        if self._budget is old or (type(old) is int and
                                   type(self._budget) is int and
                                   old == self._budget):
            return                      # same admissions (e.g. int vs float)
        self._flush(budget_changed=True)

    # -- reads -------------------------------------------------------------

    def result(self) -> ScheduleResult:
        """Materialize the current placement as a ``ScheduleResult``
        byte-identical to ``pack()`` over the same plans and budget."""
        self._flush()
        res = ScheduleResult(budget_w=self.budget_w)
        placed, deferred = res.placed, res.deferred
        for b in self._blocks:
            flags = b.placed
            for i, plan in enumerate(b.plans):
                if flags[i]:
                    placed.append(plan)
                else:
                    deferred.append(plan.name)
        return res

    def stats(self) -> RepackStats:
        """O(1) power totals of the current placement."""
        return RepackStats(self.planned_power_w, self.nameplate_power_w,
                           self.budget_w)

    # -- internals ---------------------------------------------------------

    def _mark(self, bi: int) -> None:
        # widen the pending re-flow range to cover block ``bi``
        if self._dirty_lo is None:
            self._dirty_lo = self._dirty_hi = bi
        else:
            if bi < self._dirty_lo:
                self._dirty_lo = bi
            if bi > self._dirty_hi:
                self._dirty_hi = bi

    def _flush(self, budget_changed: bool = False) -> None:
        # run the deferred re-flow over the marked range (everything, on a
        # budget change), then prune blocks emptied by pending removes
        if budget_changed:
            lo, hi = 0, len(self._blocks) - 1
        elif self._dirty_lo is None:
            return
        else:
            lo, hi = self._dirty_lo, self._dirty_hi
        self._dirty_lo = self._dirty_hi = None
        self._reflow(lo, budget_changed=budget_changed, until=hi)
        if self._prune_pending:
            self._prune_pending = False
            if any(not b.keys for b in self._blocks):
                self._blocks[:] = [b for b in self._blocks if b.keys]
                self._last_keys[:] = [b.keys[-1] for b in self._blocks]

    def _split(self, bi: int) -> None:
        b = self._blocks[bi]
        half = len(b.keys) // 2
        left = _Block(b.plans[:half], b.keys[:half], b.placed[:half])
        right = _Block(b.plans[half:], b.keys[half:], b.placed[half:])
        self._blocks[bi:bi + 1] = [left, right]
        self._last_keys[bi:bi + 1] = [left.keys[-1], right.keys[-1]]
        # the split shifts every block index > bi by one; keep the pending
        # dirty range spanning the same (now wider) set of blocks
        if self._dirty_lo is not None and self._dirty_lo > bi:
            self._dirty_lo += 1
        if self._dirty_hi is not None and self._dirty_hi >= bi:
            self._dirty_hi += 1

    def _can_skip(self, b: _Block, enter: int) -> bool:
        # sound O(1) stability test for a clean block under the (possibly
        # shifted) entry usage ``enter`` and the current budget: every
        # placed plan would still place (worst case is the block's full
        # placed need on top of ``enter``) and every deferred plan would
        # still defer (best case is the block's tightest deferred fit)
        if not _fits(enter + b.placed_need, self._budget):
            return False
        return b.min_fit is None or not _fits(enter + b.min_fit,
                                              self._budget)

    def _reflow(self, bi: int, budget_changed: bool = False,
                until: int | None = None) -> None:
        if until is None:
            until = bi
        blocks = self._blocks
        prefix = 0
        for j in range(bi):
            prefix += blocks[j].placed_need
        enter_old = enter_new = prefix
        for j in range(bi, len(blocks)):
            b = blocks[j]
            ps_old = b.placed_need
            if not b.dirty:
                if not budget_changed and j > until and enter_new == enter_old:
                    break               # nothing downstream can differ
                if self._can_skip(b, enter_new):
                    enter_old += ps_old
                    enter_new += ps_old
                    continue
            self._recompute(b, enter_new)
            b.dirty = False
            enter_old += ps_old
            enter_new += b.placed_need
        self._placed_need = sum(b.placed_need for b in blocks)
        self._placed_nameplate = sum(b.placed_nameplate for b in blocks)

    def _recompute(self, b: _Block, enter: int) -> None:
        budget = self._budget
        used = enter
        placed_need = placed_nameplate = within = 0
        min_fit = None
        flags = b.placed
        for i, plan in enumerate(b.plans):
            need = plan._need_exact
            if _fits(used + need, budget):
                flags[i] = True
                used += need
                within += need
                placed_need += need
                placed_nameplate += plan._nameplate_exact
            else:
                flags[i] = False
                fit = within + need
                if min_fit is None or fit < min_fit:
                    min_fit = fit
        b.placed_need = placed_need
        b.placed_nameplate = placed_nameplate
        b.min_fit = min_fit
