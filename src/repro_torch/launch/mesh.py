"""Mesh layouts (the reference's ``repro.launch.mesh``).

The port runs on one card and shards nothing (``models.common.Topo`` is
one device), so it has no counterpart of the reference's
``make_production_mesh``: ``CARD`` (one H100, every axis of size 1) is the
only layout its dry run takes.  ``mesh_config`` returns the reference's
pod layouts, as there, for records that name them.  Importing this module
touches no device.
"""
from __future__ import annotations

from repro_torch.configs.base import MULTI_POD, SINGLE_POD, MeshConfig

# one H100: n_chips = 1, the weights split tp = 1 way
CARD = MeshConfig(shape=(1, 1), axis_names=("data", "model"))
MESHES = {"card": CARD}


def mesh_config(*, multi_pod: bool = False) -> MeshConfig:
    return MULTI_POD if multi_pod else SINGLE_POD
