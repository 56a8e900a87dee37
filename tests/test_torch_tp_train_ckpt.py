"""Checkpoints and the launcher of tensor-parallel training, on the CPU.

A reduced float32 glm4-9b (2 layers) trains over a (1, 2) mesh of
``LocalGroup`` threads: 4 steps uninterrupted, and 2 steps that save at
step 2 (rank 0 writes the blocks gathered whole, in the reference's
tree).  That checkpoint resumes at tp 2 bit for bit, at tp 1 within 1e-5
of the uninterrupted run, and in the reference's ``Trainer`` within 1e-4
(its ``ckpt.restore`` reads the whole leaves).  The launcher trains at
``--smoke --tp 2 --group local --device cpu``; without ``--smoke`` its
``check_fits`` refuses glm4-9b's and falcon-mamba-7b's whole train state
on an 80 GB card and counts a rank's blocks at ``--tp 4``, on meta.
"""
import os
import shutil
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as ref_ckpt
from repro.configs import ARCHS as REF_ARCHS
from repro.configs.base import RunConfig as RefRunConfig
from repro.configs.base import ShapeConfig as RefShapeConfig
from repro.models.common import SMOKE_TOPO
from repro.models.model_zoo import build_model as ref_build_model
from repro.train import Trainer as RefTrainer
from repro_torch.configs import ARCHS
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.launch import train as train_launcher
from repro_torch.launch.mesh import tp_mesh
from repro_torch.models.common import Topo
from repro_torch.models.parallel import run_local
from repro_torch.train import Trainer

CFG = ARCHS["glm4-9b"].reduced(num_layers=2)
SHAPE = ShapeConfig("smoke", 16, 4, "train")
H100_BYTES = 80 * 10**9


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _run_cfg(cls, directory):
    return cls(total_steps=4, warmup_steps=1, checkpoint_every=2,
               checkpoint_dir=directory, learning_rate=3e-3)


def _train(tp: int, directory, steps: int) -> list:
    """``steps`` steps of the float32 model over tp ranks (one device at
    tp 1) from ``directory``'s latest checkpoint or the seeded init:
    rank 0's result."""
    if tp == 1:
        return [Trainer(CFG, SHAPE, _run_cfg(RunConfig, directory),
                        device="cpu", dtype=torch.float32).run(steps)]
    return run_local(lambda g: Trainer(
        CFG, SHAPE, _run_cfg(RunConfig, directory), Topo(tp_mesh(tp)),
        device="cpu", dtype=torch.float32, group=g).run(steps), tp)


def test_a_checkpoint_over_ranks_resumes_anywhere():
    # a step first, unchecked: the process's first ranks' step once
    # reported a loss a few float32 ulps from every later run's
    _train(2, None, 1)
    with tempfile.TemporaryDirectory() as tmp:
        whole = _train(2, None, 4)
        assert whole[0].losses == whole[1].losses
        ck = os.path.join(tmp, "tp2")
        first = _train(2, ck, 2)[0]
        assert first.losses == whole[0].losses[:2]
        assert sorted(os.listdir(ck)) == ["step_00000002"]
        for other in ("tp1", "ref"):
            shutil.copytree(ck, os.path.join(tmp, other))
        # the reference's restore reads the whole leaves in its tree
        tree, step = ref_ckpt.restore(ck, 2)
        assert step == 2 and int(tree["opt"]["step"]) == 2
        ref_cfg = REF_ARCHS["glm4-9b"].reduced(num_layers=2)
        shapes = ref_build_model(ref_cfg, SMOKE_TOPO,
                                 kind="train").param_shapes()
        for path, st in jax.tree_util.tree_leaves_with_path(shapes):
            node = tree["params"]
            for key in path:
                node = node[key.key]
            assert node.shape == st.shape, path
        resumed = _train(2, ck, 4)
        assert resumed[0].restored_from == 2
        assert resumed[0].losses == resumed[1].losses == \
            whole[0].losses[2:]                       # bit for bit
        one = _train(1, os.path.join(tmp, "tp1"), 4)[0]
        assert one.restored_from == 2
        np.testing.assert_allclose(one.losses, whole[0].losses[2:],
                                   rtol=1e-5)
        ref = RefTrainer(ref_cfg, RefShapeConfig("smoke", 16, 4, "train"),
                         _run_cfg(RefRunConfig, os.path.join(tmp, "ref")),
                         SMOKE_TOPO).run()
        assert ref.restored_from == 2
        np.testing.assert_allclose(ref.losses, whole[0].losses[2:],
                                   rtol=1e-4)
        # the resumed tp-2 run's step-4 checkpoint equals tp 1's whole
        got, _ = ref_ckpt.restore(ck, 4)
        want, _ = ref_ckpt.restore(os.path.join(tmp, "tp1"), 4)
        for path, w in jax.tree_util.tree_leaves_with_path(want):
            g = got
            for key in path:
                g = g[key.key]
            w = np.asarray(jnp.asarray(w, jnp.float32))
            err = np.abs(np.asarray(jnp.asarray(g, jnp.float32)) - w).max()
            assert err <= 1e-4 * max(1.0, np.abs(w).max()), (path, err)


def test_the_launcher_trains_over_ranks_and_counts_a_rank(capsys,
                                                           monkeypatch):
    with tempfile.TemporaryDirectory() as tmp:
        monkeypatch.setattr("sys.argv", [
            "train", "--arch", "glm4-9b", "--smoke", "--tp", "2", "--group",
            "local", "--device", "cpu", "--steps", "2", "--seq-len", "16",
            "--ckpt-dir", os.path.join(tmp, "ck")])
        train_launcher.main()
        assert "ran 2 steps" in capsys.readouterr().out
        assert max(os.listdir(os.path.join(tmp, "ck"))) == "step_00000002"
    monkeypatch.setattr("sys.argv", ["train", "--arch", "glm4-9b", "--tp",
                                     "2", "--device", "cpu"])
    with pytest.raises(SystemExit, match="--group"):
        train_launcher.main()
    monkeypatch.setattr(train_launcher, "device_memory_bytes",
                        lambda device: H100_BYTES)
    run_cfg = RunConfig()
    full = train_launcher.train_state_bytes(ARCHS["glm4-9b"], run_cfg)
    assert full == 12 * ARCHS["glm4-9b"].param_count() > H100_BYTES
    for arch in ("glm4-9b", "falcon-mamba-7b"):    # 112.8 GB, 87.3 GB
        with pytest.raises(ValueError, match="do not fit"):
            train_launcher.check_fits(ARCHS[arch], run_cfg, "cuda")
    rank = train_launcher.train_state_bytes(ARCHS["glm4-9b"], run_cfg, 4)
    assert full / 4 <= rank < full / 4 * 1.01       # norms whole on each
    train_launcher.check_fits(ARCHS["glm4-9b"], run_cfg, "cuda", 4)
    with pytest.raises(ValueError, match="a rank of 4"):
        train_launcher.check_fits(ARCHS["glm4-9b"], run_cfg, "cuda", 4,
                                  ranks_per_device=4)
