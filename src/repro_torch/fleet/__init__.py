"""Heterogeneous fleet layer of the port: variability-aware device models,
multiplexed telemetry, and cluster-wide online capping — with an
``inventory`` attached, ``fail_device``/``degrade_device``/``restore_device``
migrate jobs to healthy silicon from their cached decisions (zero
re-classification; see ``repro_torch.ft``).

    from repro_torch.fleet import (DeviceInventory, VariabilityModel,
                                   FleetTelemetryMux, FleetCapController)
"""
from repro_torch.fleet.controller import (FleetCapController, FleetEvent,
                                          FleetJob, FleetResult, RepackTrail)
from repro_torch.fleet.inventory import (DEGRADED, FAILED, HEALTHY,
                                         DeviceInstance, DeviceInventory,
                                         VariabilityModel)
from repro_torch.fleet.mux import FleetChunk, FleetTelemetryMux

__all__ = [
    "DeviceInstance", "DeviceInventory", "VariabilityModel",
    "FleetChunk", "FleetTelemetryMux",
    "FleetCapController", "FleetEvent", "FleetJob", "FleetResult",
    "RepackTrail",
    "HEALTHY", "DEGRADED", "FAILED",
]
