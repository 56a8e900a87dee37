"""Elastic re-meshing: plan a new mesh after losing hosts/pods.

The production mesh is (pod, data, model); losing a pod or a data-slice
shrinks the data-parallel extent while keeping the model extent (weights must
still fit).  ``plan_new_mesh`` picks the largest valid mesh from the surviving
device count; restore then re-shards the last checkpoint onto it
(checkpoint/ckpt.py restore(shardings=...)).
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import MeshConfig


@dataclass(frozen=True)
class ElasticPlan:
    old: MeshConfig
    new: MeshConfig
    surviving_devices: int

    @property
    def lost_devices(self) -> int:
        """Devices actually lost to the failure (NOT devices idled by the
        power-of-two rounding of the new data extent — see ``idle_devices``)."""
        return self.old.num_devices - self.surviving_devices

    @property
    def idle_devices(self) -> int:
        """Surviving devices the new mesh cannot use: the remainder of the
        model-axis division plus the power-of-two rounding of the data
        extent.  They stay healthy and re-join on the next re-mesh."""
        return self.surviving_devices - self.new.num_devices

    @property
    def data_scale(self) -> float:
        return self.new.data_axis_size / self.old.data_axis_size


def plan_new_mesh(mesh: MeshConfig, surviving_devices: int) -> ElasticPlan:
    """Shrink the data/pod extent to the largest power-of-two that fits."""
    model = mesh.model_axis_size
    if surviving_devices < model:
        raise RuntimeError(
            f"only {surviving_devices} devices left; model axis needs {model}")
    data = surviving_devices // model
    # largest power of two <= data (keeps batch divisibility simple)
    p = 1
    while p * 2 <= data:
        p *= 2
    new = MeshConfig(shape=(p, model), axis_names=("data", "model"))
    return ElasticPlan(old=mesh, new=new, surviving_devices=surviving_devices)


def rescale_batch(global_batch: int, plan: ElasticPlan) -> int:
    """Keep the *integer* per-device batch constant: each surviving data
    slice keeps exactly the per-device batch it had on the old mesh, so the
    new global batch is ``per_device * new_data_extent`` (never a truncated
    float ratio, which could silently change the per-device batch when the
    old global batch did not divide evenly)."""
    per_device = max(global_batch // plan.old.data_axis_size, 1)
    return per_device * plan.new.data_axis_size
