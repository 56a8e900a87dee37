"""Typed, JSON-round-trippable result objects for the session facade.

The facade's outputs are the three decision artifacts a deployment needs to
persist or ship over the wire:

  * ``CapDecision``  — one job's online frequency-cap decision (from
    ``repro_torch.pipeline``), with its full Algorithm 1 ``FreqSelection``;
  * ``JobPlan`` / ``ScheduleResult`` — the per-job power reservation and
    the packed placement (from ``repro_torch.sched``), device_id-tagged on a
    fleet;
  * ``SessionReport`` — the whole session outcome: every live decision,
    the final packing, repack/drop counters, the retired jobs, and the
    fleet's fault-tolerance trail (``FleetEvent``s + device health).

``to_dict``/``from_dict`` (and the ``to_json``/``from_json`` wrappers)
round-trip all of them losslessly: dataclasses are tagged with their type
name, field order follows the dataclass definition (stable across runs),
dict insertion order is preserved by JSON, and numpy scalars are coerced to
the matching Python ``float``/``int`` on the way out — so a decoded object
compares equal to the original.
"""
from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.algorithm1 import FreqSelection
from repro_torch.fleet.controller import FleetEvent
from repro_torch.pipeline.online import CapDecision
from repro_torch.sched.power_sched import JobPlan, ScheduleResult

_TYPE_KEY = "__type__"


@dataclass
class SessionReport:
    """Snapshot of a ``MinosSession``'s outcome (JSON-round-trippable)."""
    objective: str
    quantile: str                # provisioning quantile name
    budget_w: float
    decisions: dict[str, CapDecision] = field(default_factory=dict)
    schedule: ScheduleResult | None = None
    repacks: int = 0
    chunks_dropped: int = 0      # telemetry skipped after early decisions
    retired: dict[str, CapDecision | None] = field(default_factory=dict)
    events: list = field(default_factory=list)     # FleetEvents, in order
    device_health: dict[str, str] = field(default_factory=dict)
    # online class-discovery summary (library version, pool depth,
    # promotions, discovered class names); None on discovery-less sessions
    # — old serialized reports (without the key) decode unchanged
    discovery: dict | None = None

    @property
    def early_decisions(self) -> int:
        return sum(d.early for d in self.decisions.values())

    @property
    def migrations(self) -> int:
        """Jobs moved (or elastically shrunk) by failure/degrade handling."""
        return sum(e.kind in ("migrate", "shrink") for e in self.events)

    @property
    def failures(self) -> int:
        return sum(e.kind == "fail" for e in self.events)

    @property
    def n_jobs(self) -> int:
        """Jobs with a recorded outcome: decided live jobs + retired ones
        (live jobs that have not decided yet are not in the report)."""
        return len(self.decisions) + len(self.retired)

    def to_json(self, indent: int | None = None) -> str:
        return to_json(self, indent=indent)

    @classmethod
    def from_json(cls, text: str) -> "SessionReport":
        obj = from_json(text)
        if not isinstance(obj, cls):
            raise TypeError(f"expected a serialized SessionReport, "
                            f"got {type(obj).__name__}")
        return obj


# the closed set of types the codec round-trips; a closed set keeps
# from_dict safe to call on untrusted text (no arbitrary class lookup)
_CODEC_TYPES: dict[str, type] = {
    cls.__name__: cls
    for cls in (FreqSelection, CapDecision, JobPlan, ScheduleResult,
                SessionReport, FleetEvent)
}


_PLAIN = frozenset({bool, int, str, type(None)})


def to_dict(obj):
    """Recursively encode a result object into JSON-ready primitives."""
    # exact-type fast paths for the bulk of a fleet's records (the rows of
    # every admitted job's trace meta); the general checks below give the
    # same results for these types
    t = type(obj)
    if t is float:
        return obj if math.isfinite(obj) else {"__float__": repr(obj)}
    if t in _PLAIN:
        return obj
    if t is list or t is tuple:
        return [to_dict(v) for v in obj]
    if type(obj).__name__ in _CODEC_TYPES and dataclasses.is_dataclass(obj):
        out = {_TYPE_KEY: type(obj).__name__}
        for f in dataclasses.fields(obj):
            out[f.name] = to_dict(getattr(obj, f.name))
        return out
    if isinstance(obj, dict):
        if any(not isinstance(k, str) for k in obj):
            raise TypeError(f"only string dict keys serialize, got {obj!r}")
        return {k: to_dict(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_dict(v) for v in obj]
    if isinstance(obj, np.floating):
        obj = float(obj)
    elif isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, float) and not math.isfinite(obj):
        # inf (e.g. an unbounded session budget) is not valid RFC JSON;
        # tag it so strict consumers can parse the text and we can decode
        return {"__float__": repr(obj)}
    if isinstance(obj, (bool, int, float, str)) or obj is None:
        return obj
    raise TypeError(f"{type(obj).__name__} is not serializable by "
                    f"repro_torch.api.results (supported result types: "
                    f"{', '.join(sorted(_CODEC_TYPES))})")


def from_dict(data):
    """Inverse of ``to_dict``: rebuild tagged dataclasses recursively."""
    if isinstance(data, dict):
        if set(data) == {"__float__"}:
            return float(data["__float__"])
        tag = data.get(_TYPE_KEY)
        if tag is None:
            return {k: from_dict(v) for k, v in data.items()}
        try:
            cls = _CODEC_TYPES[tag]
        except KeyError:
            raise ValueError(f"unknown serialized type {tag!r}; expected one "
                             f"of {', '.join(sorted(_CODEC_TYPES))}") from None
        kw = {k: from_dict(v) for k, v in data.items() if k != _TYPE_KEY}
        return cls(**kw)
    if isinstance(data, list):
        return [from_dict(v) for v in data]
    return data


def to_json(obj, indent: int | None = None) -> str:
    # allow_nan=False: non-finite floats must have been tagged by to_dict,
    # so the emitted text is strict RFC JSON any consumer can parse
    return json.dumps(to_dict(obj), indent=indent, allow_nan=False)


def from_json(text: str):
    return from_dict(json.loads(text))
