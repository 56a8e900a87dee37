"""Device inventory: the heterogeneous, variability-aware fleet model.

A fleet is a set of ``DeviceInstance``s drawn from the ``CHIP_MODELS``
registry.  Each instance carries its own ``ChipSpec`` whose
``perf_scale``/``power_scale`` fields are seeded per-device perturbations of
the nominal frequency->power/perf curves — the chip-to-chip silicon lottery
of "Not All GPUs Are Created Equal" (arXiv:2208.11035).  With variability
disabled every draw is exactly 1.0 and the instance spec is bit-identical to
the nominal model, which is what the homogeneous-fleet invariance tests pin.

Device-portable classification hangs off ``effective_tdp_w``: a power trace
captured on a device, divided by that device's *effective* TDP (nameplate x
power_scale), recovers the workload's intrinsic relative power curve.  Since
the power model is calibrated relative to TDP for every chip model, relative
curves are comparable across the whole fleet — so the single shipped
``ReferenceLibrary`` (built on the nominal v5e) serves every device.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

from repro_torch.analysis.hardware import CHIP_MODELS, ChipSpec
from repro_torch.core.classify import WorkloadProfile
from repro_torch.telemetry.power_model import TPUPowerModel


@dataclass(frozen=True)
class VariabilityModel:
    """Seeded per-device multiplicative draws around the nominal curves.

    Draws are ``1 + sigma * z`` with ``z ~ N(0, 1)`` clipped to ``max_z``
    standard deviations (a chip can't be arbitrarily bad).  Defaults follow
    the ~5% frequency / ~8% power spreads reported for production fleets.
    With a sigma of 0 the draw is *exactly* 1.0 (the RNG is still consumed,
    so an inventory's device list doesn't depend on which sigmas are zero).
    """
    sigma_perf: float = 0.05
    sigma_power: float = 0.08
    max_z: float = 3.0

    @classmethod
    def none(cls) -> "VariabilityModel":
        """Variability disabled: every device is the nominal chip."""
        return cls(sigma_perf=0.0, sigma_power=0.0)

    def draw(self, rng: np.random.Generator) -> tuple[float, float]:
        z = np.clip(rng.standard_normal(2), -self.max_z, self.max_z)
        return 1.0 + self.sigma_perf * float(z[0]), \
            1.0 + self.sigma_power * float(z[1])


@dataclass(frozen=True)
class DeviceInstance:
    """One physical accelerator: a chip model plus its silicon-lottery spec."""
    device_id: str
    model: str                   # CHIP_MODELS key
    spec: ChipSpec               # per-instance (possibly perturbed) spec

    @property
    def effective_tdp_w(self) -> float:
        """The device's profile-normalization base (see module docstring)."""
        return self.spec.effective_tdp_w

    @property
    def nameplate_w(self) -> float:
        """What a TDP-provisioned scheduler must reserve for this device."""
        return self.spec.tdp_w

    def power_model(self, **kw) -> TPUPowerModel:
        """A ``TPUPowerModel`` bound to this instance's perturbed spec."""
        return TPUPowerModel(self.spec, **kw)

    def normalize_profile(self, profile: WorkloadProfile) -> WorkloadProfile:
        """Re-express a profile captured on this device in the fleet's
        device-portable frame: the trace stays in device watts but the
        normalization base becomes the device's effective TDP, so spike
        vectors and power quantiles are relative to the *intrinsic* curve.
        Identity (same object values) on an unperturbed device."""
        return dataclasses.replace(profile, tdp=self.effective_tdp_w)


# device health states (the fleet membership-churn model: production
# telemetry studies show devices fail, degrade, and come back constantly)
HEALTHY = "healthy"
DEGRADED = "degraded"       # straggling: still running, proactively drained
FAILED = "failed"           # gone: jobs must migrate, no new placements

_HEALTH_STATES = (HEALTHY, DEGRADED, FAILED)


class DeviceInventory:
    """Ordered collection of ``DeviceInstance``s with deterministic
    generation, simple lookup/grouping, and per-device health state.

    Health is inventory-level (the instances stay frozen value objects):
    ``mark_failed``/``mark_degraded``/``restore`` move a device between
    states, ``healthy``/``failed_ids``/``device_health`` are the views the
    fleet controller schedules against.  A fresh inventory is all-healthy,
    so the health layer is inert until a failure is injected — the
    byte-identity pins of the no-failure paths are untouched."""

    def __init__(self, devices=()):
        self._devices: list[DeviceInstance] = list(devices)
        ids = [d.device_id for d in self._devices]
        if len(set(ids)) != len(ids):
            raise ValueError("duplicate device_id in inventory")
        self._health: dict[str, str] = {i: HEALTHY for i in ids}

    @classmethod
    def generate(cls, counts: dict[str, int] | int,
                 variability: VariabilityModel | None = None,
                 seed: int = 0) -> "DeviceInventory":
        """Build a fleet: ``counts`` maps chip-model name -> device count (a
        bare int means that many nominal-model ``tpu-v5e`` chips).  Draws are
        taken from one seeded RNG in sorted-model order, so the same
        ``(counts, seed)`` always yields the same fleet."""
        if isinstance(counts, int):
            counts = {"tpu-v5e": counts}
        var = variability or VariabilityModel.none()
        rng = np.random.default_rng(seed)
        devices = []
        for model_name in sorted(counts):
            base = CHIP_MODELS[model_name]       # KeyError on unknown model
            for i in range(counts[model_name]):
                perf, power = var.draw(rng)
                spec = dataclasses.replace(base, perf_scale=perf,
                                           power_scale=power)
                devices.append(DeviceInstance(
                    device_id=f"{model_name}/{i:03d}", model=model_name,
                    spec=spec))
        return cls(devices)

    def __len__(self) -> int:
        return len(self._devices)

    def __iter__(self):
        return iter(self._devices)

    def __getitem__(self, i: int) -> DeviceInstance:
        return self._devices[i]

    def __contains__(self, key) -> bool:
        """O(1) membership by device_id (or a DeviceInstance's id)."""
        if isinstance(key, DeviceInstance):
            key = key.device_id
        return key in self._health

    def get(self, device_id: str) -> DeviceInstance:
        for d in self._devices:
            if d.device_id == device_id:
                return d
        raise KeyError(device_id)

    def by_model(self, model: str) -> list[DeviceInstance]:
        return [d for d in self._devices if d.model == model]

    @property
    def models(self) -> list[str]:
        """Distinct chip models present, in first-seen order."""
        seen: dict[str, None] = {}
        for d in self._devices:
            seen.setdefault(d.model, None)
        return list(seen)

    @property
    def nameplate_w(self) -> float:
        """Total nameplate TDP across the fleet (per-device, 1 chip each)."""
        return sum(d.nameplate_w for d in self._devices)

    # -- health ----------------------------------------------------------
    def _set_health(self, device_id: str, state: str) -> None:
        self.get(device_id)                  # KeyError on unknown device
        self._health[device_id] = state

    def mark_failed(self, device_id: str) -> None:
        """The device is gone: it leaves every healthy view until
        ``restore``; jobs bound to it must migrate."""
        self._set_health(device_id, FAILED)

    def mark_degraded(self, device_id: str) -> None:
        """The device is straggling: keep it out of new placements while it
        drains, but don't treat its telemetry as dead."""
        self._set_health(device_id, DEGRADED)

    def restore(self, device_id: str) -> None:
        """The device is back (replaced or recovered): it re-joins the
        healthy pool and may take new/migrated jobs again."""
        self._set_health(device_id, HEALTHY)

    def health(self, device_id: str) -> str:
        self.get(device_id)
        return self._health[device_id]

    def is_healthy(self, device_id: str) -> bool:
        return self.health(device_id) == HEALTHY

    @property
    def device_health(self) -> dict[str, str]:
        """device_id -> health state for every device, inventory order."""
        return {d.device_id: self._health[d.device_id]
                for d in self._devices}

    @property
    def healthy(self) -> list[DeviceInstance]:
        """Devices eligible for (new or migrated) placements."""
        return [d for d in self._devices
                if self._health[d.device_id] == HEALTHY]

    @property
    def failed_ids(self) -> list[str]:
        return [d.device_id for d in self._devices
                if self._health[d.device_id] == FAILED]

    @property
    def healthy_nameplate_w(self) -> float:
        """Nameplate TDP of the surviving (non-failed) devices only."""
        return sum(d.nameplate_w for d in self._devices
                   if self._health[d.device_id] != FAILED)

    @property
    def homogeneous(self) -> bool:
        """True when every device is the *identical* nominal chip: one model
        and no variability perturbations (all scales exactly 1.0)."""
        return len(self.models) <= 1 and all(
            d.spec.perf_scale == 1.0 and d.spec.power_scale == 1.0
            for d in self._devices)
