"""DVFS actuation interface.

On a real deployment ``FrequencyActuator`` binds to the platform power API
(the TPU analogue of ``rocm-smi --setsclk``); here the simulated actuator
just records the cap and exposes it to the telemetry simulator.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.analysis.hardware import ChipSpec, V5E


class FrequencyActuator:
    """Abstract actuator: set/get a normalized SM/MXU frequency cap."""

    def set_cap(self, freq: float) -> None:
        raise NotImplementedError

    def get_cap(self) -> float:
        raise NotImplementedError


@dataclass
class SimActuator(FrequencyActuator):
    spec: ChipSpec = V5E
    _cap: float = 1.0
    history: list = field(default_factory=list)
    device_id: str = ""          # fleet device this actuator drives

    @classmethod
    def for_device(cls, device) -> "SimActuator":
        """Actuator bound to a fleet ``DeviceInstance``: clamps to that
        instance's DVFS range and records which device it drives."""
        return cls(spec=device.spec, device_id=device.device_id)

    def set_cap(self, freq: float) -> None:
        freq = min(max(freq, self.spec.f_min), self.spec.f_max)
        self._cap = freq
        self.history.append(freq)

    def get_cap(self) -> float:
        return self._cap
