"""Mesh layouts (the reference's ``repro.launch.mesh``).

The port runs one card (``CARD``, every axis of size 1) or a (1, tp) mesh
of tp ranks (``tp_mesh``: data 1, model tp), over which every family
serves and the dense and ssm families train with the reference's
tensor-parallel layouts (``models.common.Topo``, ``models.parallel``;
``launch.serve`` and ``launch.train`` take ``--tp``).  Meshes with
data > 1, and so the reference's ``make_production_mesh``, are not
ported (ROADMAP.md queue 1); the dry run takes one layout, ``card``.
``mesh_config`` returns the reference's pod layouts, as there, for
records that name them.  Importing this module touches no device.
"""
from __future__ import annotations

from repro_torch.configs.base import MULTI_POD, SINGLE_POD, MeshConfig

# one H100: n_chips = 1, the weights split tp = 1 way
CARD = MeshConfig(shape=(1, 1), axis_names=("data", "model"))
MESHES = {"card": CARD}


def tp_mesh(tp: int) -> MeshConfig:
    """The (1, tp) mesh: tp ranks on the "model" axis."""
    return MeshConfig(shape=(1, tp), axis_names=("data", "model"))


def mesh_config(*, multi_pod: bool = False) -> MeshConfig:
    return MULTI_POD if multi_pod else SINGLE_POD
