"""JSON record codecs for the fleet types the event journal references.

``CapDecision``/``JobPlan``/``FleetEvent`` round-trip through the tagged
``repro_torch.api.results`` codec, but a journaled *admit* also has to
carry the job's device bindings and trace context — ``DeviceInstance``
(with its possibly-perturbed per-instance ``ChipSpec``), ``TraceMeta``, and
``MeshConfig`` are not session results, so they get explicit record forms
here.  Every field is a JSON scalar/list, and floats survive the text
round-trip exactly (``json`` emits shortest-repr floats), so a device
rebuilt from its record has a bit-identical ``effective_tdp_w`` — the
normalization base crash recovery must reproduce.
"""
from __future__ import annotations

import dataclasses

from repro_torch.analysis.hardware import ChipSpec
from repro_torch.configs.base import MeshConfig
from repro_torch.fleet.inventory import DeviceInstance
from repro_torch.telemetry.simulator import TraceMeta


def _fields(obj) -> dict:
    """A flat dataclass's fields as a dict: what ``dataclasses.asdict``
    gives for scalar fields, without its recursive deep copy (a snapshot
    encodes one device and one meta record per job)."""
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def device_record(device: DeviceInstance) -> dict:
    return {"device_id": device.device_id, "model": device.model,
            "spec": _fields(device.spec)}


def device_from_record(rec: dict) -> DeviceInstance:
    return DeviceInstance(device_id=rec["device_id"], model=rec["model"],
                          spec=ChipSpec(**rec["spec"]))


def meta_record(meta: TraceMeta) -> dict:
    rec = _fields(meta)
    # the row tuples encode as the lists asdict's copy would give
    rec["kernel_rows"] = list(meta.kernel_rows)
    return rec


def meta_from_record(rec: dict) -> TraceMeta:
    rec = dict(rec)
    # JSON turned the (duration, util_c, util_m) row tuples into lists;
    # restore the tuple shape so rebuilt metas compare equal to originals
    rec["kernel_rows"] = [tuple(row) for row in rec.get("kernel_rows", [])]
    return TraceMeta(**rec)


def mesh_record(mesh: MeshConfig | None) -> dict | None:
    if mesh is None:
        return None
    return {"shape": list(mesh.shape), "axis_names": list(mesh.axis_names)}


def mesh_from_record(rec: dict | None) -> MeshConfig | None:
    if rec is None:
        return None
    return MeshConfig(shape=tuple(rec["shape"]),
                      axis_names=tuple(rec["axis_names"]))
