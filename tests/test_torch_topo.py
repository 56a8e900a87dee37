"""The port's ``Topo`` against the reference's: the same pspec for every
parameter and cache, on every mesh, with no device and no allocation.

The reference's models are built as layouts only (``ParamStore`` defs);
the port's on ``meta``, and their per-layer defs stacked over the layers
as the reference stacks them.  ``shard_slices`` must then cut each tensor
of the (1, tp) meshes into blocks that tile it exactly.
"""
import functools
import itertools

import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs.base import MeshConfig as RefMeshConfig
from repro.models.common import Topo as RefTopo
from repro.models.model_zoo import build_model as ref_build_model
from repro_torch.configs import ARCHS
from repro_torch.configs.base import MeshConfig
from repro_torch.models.common import ONE_DEVICE, ParamDef, Topo
from repro_torch.models.convert import STACKED
from repro_torch.models.model_zoo import build_model

MESHES = [((1, 1), ("data", "model")), ((1, 2), ("data", "model")),
          ((1, 4), ("data", "model")), ((4, 4), ("data", "model")),
          ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
KINDS = ("train", "prefill", "decode")


def _topos(mesh):
    shape, names = mesh
    return Topo(MeshConfig(shape, names)), RefTopo(RefMeshConfig(shape,
                                                                 names))


@functools.lru_cache(maxsize=None)
def _models(arch: str, kind: str, mesh):
    """The reference's model (defs only) and the port's on meta."""
    topo, ref_topo = _topos(mesh)
    return (ref_build_model(REF_ARCHS[arch], ref_topo, kind=kind),
            build_model(ARCHS[arch], topo, kind=kind, device="meta"))


def stacked_defs(model) -> dict[str, ParamDef]:
    """The port model's defs keyed and stacked as the reference's store:
    ``layers.<i>.<rest>`` -> ``layers/<rest>`` with a leading (n,) dim of
    logical axis None, after checking that every layer's defs are layer
    0's."""
    out, per_layer = {}, {}
    for name, d in model.param_defs().defs.items():
        stack, _, rest = name.partition(".")
        if stack in STACKED:
            i, _, leaf = rest.partition(".")
            per_layer.setdefault(f"{stack}/{leaf}", {})[int(i)] = d
        else:
            out[name.replace(".", "/")] = d
    for path, layers in per_layer.items():
        assert sorted(layers) == list(range(len(layers))), path
        assert all(d == layers[0] for d in layers.values()), path
        d = layers[0]
        out[path.replace(".", "/")] = ParamDef(
            (len(layers), *d.shape), (None, *d.axes), d.init, d.scale,
            d.dtype)
    return out


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_pspecs_match_the_reference_on_every_mesh(arch):
    """All 10 archs at full size x train / prefill / decode x six meshes:
    the same defs (shape, logical axes, init) and the same pspec."""
    n = 0
    for kind, mesh in itertools.product(KINDS, MESHES):
        topo, ref_topo = _topos(mesh)
        ref, port = _models(arch, kind, mesh)
        defs = stacked_defs(port)
        assert sorted(defs) == sorted(ref.store.defs), (kind, mesh)
        for path, rd in ref.store.defs.items():
            d = defs[path]
            assert (d.shape, d.axes, d.init, d.scale) == \
                (rd.shape, rd.axes, rd.init, rd.scale), (kind, mesh, path)
            want = tuple(ref_topo.pspec(rd.axes, rd.shape))
            assert topo.pspec(d.axes, d.shape) == want, (kind, mesh, path)
            n += 1
    assert n > 0


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_pspecs_match_the_reference(arch):
    for kind, mesh, (b, s) in itertools.product(
            ("prefill", "decode"), MESHES, ((4, 1024), (2, 1001))):
        ref, port = _models(arch, kind, mesh)
        want = {name: {key: tuple(p) for key, p in entry.items()}
                for name, entry in ref.cache_pspecs(b, s).items()}
        assert port.cache_pspecs(b, s) == want, (kind, mesh, b, s)


def test_topo_rules_equal_the_reference():
    """axis_size, resolve (with its fallback to a suffix of the axes and
    to replication) and the trimmed pspec, logical by logical."""
    for mesh in MESHES:
        topo, ref_topo = _topos(mesh)
        for logical in ("batch", "fsdp", "tp", "seq_tp", "all", "none"):
            assert topo.axis_size(logical) == ref_topo.axis_size(logical)
            for dim in (1, 2, 3, 4, 8, 16, 24, 32, 48, 1000, 1001, 1024):
                assert topo.resolve(logical, dim) == \
                    ref_topo.resolve(logical, dim), (mesh, logical, dim)
        for axes in [(None, "tp"), ("fsdp", None), ("tp", "fsdp"),
                     ("all", None, None), (None, None)]:
            for shape in [(32, 64), (17, 64), (64, 17), (512, 3, 5)]:
                shape = shape[:len(axes)] + (1,) * (len(axes) - len(shape))
                assert topo.pspec(axes, shape) == \
                    tuple(ref_topo.pspec(axes, shape)), (mesh, axes, shape)
    with pytest.raises(KeyError):
        ONE_DEVICE.axis_size("pipeline")
    assert ONE_DEVICE.pspec(("fsdp", "tp"), (8, 8)) == ("data", "model")


def test_command_r_on_a_one_by_four_mesh_takes_the_references_layout():
    """The pspecs of the served model, written out: heads for prefill's
    wq / wo, head_dim for its wk / wv, d_model for decode's projections
    and the output d for decode's wo; caches over the sequence."""
    topo = Topo(MeshConfig((1, 4), ("data", "model")))
    cfg = ARCHS["command-r-35b"]
    want = {
        "prefill": {"wq": (None, "data", "model"),
                    "wk": (None, "data", None, "model"),
                    "wv": (None, "data", None, "model"),
                    "wo": (None, "model", None, "data")},
        "decode": {"wq": (None, "model"), "wk": (None, "model"),
                   "wv": (None, "model"), "wo": (None, None, None, "model")},
    }
    for kind, attn in want.items():
        defs = stacked_defs(build_model(cfg, topo, kind=kind, device="meta"))
        spec = {p: topo.pspec(d.axes, d.shape) for p, d in defs.items()}
        assert spec["embed/table"] == ("model", "data")
        assert spec["embed/head"] == ("data", "model")
        for w, p in attn.items():
            assert spec[f"layers/l0_attn/core/{w}"] == p, (kind, w)
        mlp = "layers/l0_mlp/core/"
        ff = ("data", "model") if kind == "prefill" else (None, "model")
        assert spec[mlp + "w_gate"] == (None, *ff)
        assert spec[mlp + "w_up"] == (None, *ff)
        assert spec[mlp + "w_down"] == ((None, "model", "data")
                                        if kind == "prefill"
                                        else (None, "model"))
        assert spec["layers/l0_attn/norm/scale"] == ()
        model = build_model(cfg, topo, kind=kind, device="meta")
        assert model.cache_pspecs(4, 1024)["l0_attn"] == {
            "k": (None, "data", "model"), "v": (None, "data", "model")}


@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_shard_slices_tile_every_tensor_exactly(tp, kind):
    """Each rank's block, by the defs of a reduced dense model (vocab,
    heads, head_dim, d_model and d_ff all cut at tp = 4) and of tensors
    that tp does not divide, covers its part once: the blocks put back
    together give the whole tensor."""
    topo = Topo(MeshConfig((1, tp), ("data", "model")))
    model = build_model(ARCHS["command-r-35b"].reduced(num_layers=1),
                        topo, kind=kind, device="meta")
    cases = [(d.axes, d.shape) for d in model.param_defs().defs.values()]
    cases += [(("tp", None), (6, 3)), (("tp", "fsdp"), (5, 4)),
              ((None, "batch", "seq_tp", None, None), (2, 3, 1001, 2, 4))]
    for axes, shape in cases:
        whole = np.arange(int(np.prod(shape))).reshape(shape)
        pspec = topo.pspec(axes, shape)
        cut = [i for i, e in enumerate(pspec)
               if "model" in (e if isinstance(e, tuple) else (e,))]
        blocks = []
        for r in range(tp):
            blocks.append(whole[topo.shard_slices(pspec, shape, r)])
        if cut:
            np.testing.assert_array_equal(
                np.concatenate(blocks, axis=cut[0]), whole)
            assert len({b.shape for b in blocks}) == 1
        else:
            for b in blocks:
                np.testing.assert_array_equal(b, whole)


def test_shard_slices_refuse_a_mesh_with_data_and_a_bad_rank():
    topo = Topo(MeshConfig((4, 4), ("data", "model")))
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1"):
        topo.shard_slices(("data", "model"), (8, 8), 0)
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1"):
        _ = topo.tp
    with pytest.raises(ValueError):
        Topo(MeshConfig((1, 2), ("data", "model"))).shard_slices(
            ("model",), (8,), 2)
    assert ONE_DEVICE.shard_slices((), (3, 5), 0) == (slice(0, 3),
                                                      slice(0, 5))
    pspec = ONE_DEVICE.pspec((None, "tp"), (3, 5))
    assert torch.empty(3, 5)[ONE_DEVICE.shard_slices(pspec, (3, 5),
                                                     0)].shape == (3, 5)
