"""Named plugin registries for the session facade's policy axes.

Every policy knob a ``MinosSession`` exposes resolves through a registry, so
``MinosSession.from_config`` can construct a full session from plain names
and downstream code can add policies without touching the core:

  * ``OBJECTIVES`` — what cap a decision actuates.  Builtins are the paper's
    ``powercentric``/``perfcentric``; a custom objective is any function
    ``FreqSelection -> float`` registered via ``register_objective``.
  * ``ACTUATORS`` — how a cap reaches a device.  Builtins: ``sim`` (the
    recording ``SimActuator``, bound per device) and ``none`` (decide but
    do not actuate).  A custom actuator is a factory
    ``DeviceInstance | None -> FrequencyActuator | None``.
  * ``QUANTILES`` — which spike quantile of the neighbor's scaling data the
    scheduler provisions per chip.  Builtins: ``p90``/``p95``/``p99``; a
    custom quantile is any function ``FreqPoint -> float`` registered via
    ``register_quantile``.

Registered plugins flow through exactly the same controllers as the
builtins (``OnlineCapController``, ``PowerAwareScheduler``), so the
byte-identity guarantees of the direct paths carry over.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

from repro_torch.core.algorithm1 import (PERFCENTRIC, POWERCENTRIC,
                                         FreqSelection, ObjectivePolicy)
from repro_torch.core.classify import FreqPoint
from repro_torch.sched.dvfs import SimActuator


@dataclass(frozen=True)
class QuantilePolicy:
    """A pluggable provisioning quantile: maps a neighbor ``FreqPoint`` to
    the relative per-chip power the scheduler reserves for a job."""
    name: str
    rel_fn: Callable[[FreqPoint], float] = field(compare=False)

    def __call__(self, fp: FreqPoint) -> float:
        return self.rel_fn(fp)


class Registry:
    """A string-keyed plugin table with decorator-style registration."""

    def __init__(self, kind: str):
        self.kind = kind
        self._items: dict[str, object] = {}

    def register(self, name: str, obj=None, *, replace: bool = False):
        """``register(name, obj)`` or ``@register(name)`` on a factory.
        Duplicate names raise unless ``replace=True``."""
        if obj is None:
            return lambda f: self.register(name, f, replace=replace)
        if not isinstance(name, str) or not name:
            raise ValueError(f"{self.kind} name must be a non-empty string, "
                             f"got {name!r}")
        if name in self._items and not replace:
            raise ValueError(f"{self.kind} {name!r} is already registered "
                             f"(pass replace=True to override)")
        self._items[name] = obj
        return obj

    def get(self, name: str):
        try:
            return self._items[name]
        except KeyError:
            raise KeyError(f"unknown {self.kind} {name!r}; registered: "
                           f"{', '.join(self.names())}") from None

    def names(self) -> list[str]:
        return sorted(self._items)

    def __contains__(self, name: str) -> bool:
        return name in self._items

    def __len__(self) -> int:
        return len(self._items)


OBJECTIVES = Registry("objective")
OBJECTIVES.register("powercentric", POWERCENTRIC)
OBJECTIVES.register("perfcentric", PERFCENTRIC)

ACTUATORS = Registry("actuator")
ACTUATORS.register(
    "sim", lambda device=None: SimActuator.for_device(device)
    if device is not None else SimActuator())
ACTUATORS.register("none", lambda device=None: None)

QUANTILES = Registry("quantile")
for _q in ("p90", "p95", "p99"):
    # builtins stay plain strings: PowerAwareScheduler resolves them to the
    # matching FreqPoint attribute, the exact pre-facade code path
    QUANTILES.register(_q, _q)


def register_objective(name: str, cap_fn: Callable[[FreqSelection], float],
                       *, replace: bool = False) -> ObjectivePolicy:
    """Register a custom capping objective by name; returns its policy."""
    policy = ObjectivePolicy(name, cap_fn)
    OBJECTIVES.register(name, policy, replace=replace)
    return policy


def register_quantile(name: str, rel_fn: Callable[[FreqPoint], float],
                      *, replace: bool = False) -> QuantilePolicy:
    """Register a custom provisioning quantile by name; returns its policy."""
    policy = QuantilePolicy(name, rel_fn)
    QUANTILES.register(name, policy, replace=replace)
    return policy


def register_actuator(name: str, factory, *, replace: bool = False):
    """Register a custom actuator factory (``device -> actuator``) by name."""
    if not callable(factory):
        raise ValueError(f"actuator factory must be callable, got {factory!r}")
    ACTUATORS.register(name, factory, replace=replace)
    return factory
