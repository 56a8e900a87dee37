"""Training the port's vlm (llama-3.2-vision-11b: gated cross-attention over
float32 image embeddings) and encoder-decoder (whisper-medium: float32
frames) against the reference, on the CPU.

Reduced configs on 2 layers (whisper: 2 encoder and 2 decoder layers),
d_model 128, the vlm's 8 image tokens, float32 parameters drawn with numpy
by ``test_torch_encdec.cross_tree`` (each vlm gate in [0.5, 1.5]: at the
reference's zero init ``tanh(0)`` would leave every cross weight without a
gradient, and the test would not see the cross sublayer).

- ``loss`` and every gradient leaf against ``jax.value_and_grad`` of the
  reference's ``loss``: the loss within 1e-5 relative, each leaf within
  1e-4 x max(1, max |g_ref|), as ``test_torch_backward`` holds glm4-9b;
- the parameter trees (the vlm's gates, the encoder's and the decoder's
  stacks) carried both ways bit for bit;
- three ``Trainer`` steps in both packages from one reference-written
  float32 checkpoint (losses within 1e-4 relative), and each package
  resuming the other's step-3 checkpoint to step 6, as
  ``test_torch_train`` does for glm4-9b;
- ``launch/train.py --smoke`` for both archs on the CPU.
"""
import os
import shutil
import subprocess
import sys
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
from repro.optim import init_opt_state as ref_init_opt_state
from repro.train import Trainer as RefTrainer
from repro_torch.checkpoint import ckpt
from repro_torch.configs import ARCHS
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.launch import train as train_launcher
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.models.model_zoo import build_model
from repro_torch.train import Trainer
from test_torch_encdec import batch_for, cross_tree
from test_torch_models import _f32

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = torch.float32
VLM, WHISPER = "llama-3.2-vision-11b", "whisper-medium"
ARCH_NAMES = (VLM, WHISPER)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small tensor ops: one thread runs them as fast as eight, and
    the suite's parallel workers would oversubscribe the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfgs(arch: str):
    return (REF_ARCHS[arch].reduced(num_layers=2),
            ARCHS[arch].reduced(num_layers=2))


def _leaves(tree) -> dict:
    return {jax.tree_util.keystr(p): g
            for p, g in jax.tree_util.tree_leaves_with_path(tree)}


def _is_key_bias(name: str) -> bool:
    return name.endswith("['bk']")


def _close_leaves(got_tree, want_tree, what: str,
                  key_bias_tol: float | None = None) -> None:
    """Every leaf within 1e-4 x max(1, max |want|).  With ``key_bias_tol``
    a key bias (whisper's ``bk``) is held to that absolute bound instead:
    softmax is invariant to a shift of a row's scores, so the loss's
    gradient in ``bk`` is zero up to rounding, and AdamW turns each
    package's rounding noise into steps of up to about the learning rate."""
    want, got = _leaves(want_tree), _leaves(got_tree)
    assert set(got) == set(want), what
    bad = []
    for name, w in want.items():
        w = np.asarray(jnp.asarray(w, jnp.float32))
        err = np.abs(_f32(got[name]) - w).max()
        tol = key_bias_tol if key_bias_tol is not None and \
            _is_key_bias(name) else 1e-4 * max(1.0, np.abs(w).max())
        if not err <= tol:
            bad.append((name, float(err)))
    assert not bad, (what, bad)


# ---------------------------------------------------------------------------
# loss and every gradient leaf
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,seed", [(VLM, 0), (WHISPER, 1)])
def test_cross_loss_and_every_gradient_equal_the_reference(arch, seed):
    ref_cfg, cfg = _cfgs(arch)
    ref_model = ref_build_model(ref_cfg, SMOKE_TOPO, kind="train")
    tree = cross_tree(ref_model, seed, jnp.float32)
    # whisper's frames shorter than the tokens: its cross-attention has
    # sq != skv, as the vlm's has
    batch = batch_for(cfg, b=2, s=64, seed=seed + 5, memory=24)
    rng = np.random.default_rng(seed)
    labels = np.concatenate([batch["tokens"][:, 1:], rng.integers(
        0, cfg.vocab_size, (2, 1)).astype(np.int32)], axis=1)
    labels[0, 5] = cfg.vocab_size + 3        # masked: outside the vocab
    labels[1, 7] = -1                        # masked
    batch["labels"] = labels
    (r_total, r_metrics), r_grads = jax.value_and_grad(
        ref_model.loss, has_aux=True)(jax.tree.map(jnp.asarray, tree),
                                      {k: jnp.asarray(v)
                                       for k, v in batch.items()})
    model = build_model(cfg, kind="train", device="cpu", dtype=F32)
    model.load_state_dict(params_from_jax(tree))
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    total, metrics = model.loss(batch)
    grads = torch.autograd.grad(total, list(params.values()))
    for key, want in (("total", r_total), ("loss", r_metrics["loss"]),
                      ("aux_loss", r_metrics["aux_loss"])):
        got = (total if key == "total" else metrics[key]).detach()
        assert got.dtype == F32
        want = float(want)
        assert abs(float(got) - want) <= 1e-5 * max(abs(want), 1e-6), \
            (key, float(got), want)
    assert float(metrics["aux_loss"]) == 0.0
    got_tree = params_to_jax(dict(zip(params, grads)))
    _close_leaves(got_tree, r_grads, arch)
    # a key bias shifts every score of a row alike: no gradient in either
    for name, g in _leaves(got_tree).items():
        if _is_key_bias(name):
            assert float(g.abs().max()) < 1e-6, name
    # the cross sublayers carry gradient: their weights and gates moved
    cross = {k: g for k, g in _leaves(got_tree).items()
             if "cross" in k and ("'wk'" in k or "'gate'" in k)}
    assert cross and all(float(g.abs().max()) > 0 for g in cross.values())


# ---------------------------------------------------------------------------
# parameter trees and checkpoints
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_cross_params_to_jax_inverts_params_from_jax(arch):
    ref_cfg, cfg = _cfgs(arch)
    tree = cross_tree(ref_build_model(ref_cfg, SMOKE_TOPO, kind="train"), 2,
                      jnp.bfloat16)
    state = params_from_jax(tree)
    model = build_model(cfg, kind="train", device="cpu")
    assert set(state) == set(dict(model.named_parameters()))
    model.load_state_dict(state)
    back = params_to_jax(dict(model.named_parameters()))
    want = _leaves(tree)
    got = _leaves(back)
    assert set(got) == set(want)
    for name, w in want.items():
        assert got[name].dtype == torch.bfloat16, name
        np.testing.assert_array_equal(got[name].view(torch.int16).numpy(),
                                      np.asarray(w).view(np.int16))
    stacks = ("['layers']",) if arch == VLM else ("['enc_layers']",
                                                  "['dec_layers']")
    for stack in stacks:
        assert any(k.startswith(stack) for k in got), stack
    if arch == VLM:
        gates = [k for k in got if k.endswith("['gate']")]
        assert gates and all(got[k].shape == (1, 1) for k in gates)


def _run_cfg(cls, tmp, steps=6):
    return cls(total_steps=steps, warmup_steps=2, checkpoint_every=3,
               checkpoint_dir=tmp, learning_rate=3e-3)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_cross_trainers_and_checkpoints_move_between_the_packages(arch):
    ref_cfg, cfg = _cfgs(arch)
    rshape = RefShapeConfig("smoke", 32, 4, "train")
    shape = ShapeConfig("smoke", 32, 4, "train")
    with tempfile.TemporaryDirectory() as tmp:
        seed = os.path.join(tmp, "seed")
        model = ref_build_model(ref_cfg, SMOKE_TOPO, kind="train")
        params = jax.tree.map(jnp.asarray,
                              cross_tree(model, 6, jnp.float32))
        ref_ckpt.save({"params": params,
                       "opt": ref_init_opt_state(params, "float32")},
                      seed, 0)
        dirs = {}
        for who in ("ref", "port"):
            dirs[who] = os.path.join(tmp, who)
            shutil.copytree(seed, dirs[who])
        r1 = RefTrainer(ref_cfg, rshape, _run_cfg(RefRunConfig, dirs["ref"]),
                        SMOKE_TOPO).run(num_steps=3)
        p1 = Trainer(cfg, shape, _run_cfg(RunConfig, dirs["port"]),
                     device="cpu", dtype=F32).run(num_steps=3)
        assert r1.restored_from == p1.restored_from == 0
        np.testing.assert_allclose(p1.losses, r1.losses, rtol=1e-4)
        assert ckpt.latest_step(dirs["port"]) == 3
        rtree, step = ref_ckpt.restore(dirs["port"])
        assert step == 3 and int(rtree["opt"]["step"]) == 3
        # each resumes the other's step-3 checkpoint to step 6
        r2 = RefTrainer(ref_cfg, rshape,
                        _run_cfg(RefRunConfig, dirs["port"]),
                        SMOKE_TOPO).run()
        p2 = Trainer(cfg, shape, _run_cfg(RunConfig, dirs["ref"]),
                     device="cpu", dtype=F32).run()
        assert r2.restored_from == p2.restored_from == 3
        assert r2.final_step == p2.final_step == 6
        np.testing.assert_allclose(p2.losses, r2.losses, rtol=1e-4)
        want, _ = ref_ckpt.restore(dirs["port"], 6)
        got, _ = ckpt.restore(dirs["ref"], 6)
        # Adam's update is at most about lr a step: 6 steps bound bk's drift
        _close_leaves(got, want, f"{arch} state at step 6",
                      key_bias_tol=6 * 3e-3)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_launcher_trains_cross_models_on_the_host(arch):
    if arch == VLM:       # 10.11 B parameters: 121 GB of train state
        with pytest.raises(ValueError, match="do not fit"):
            train_launcher.check_fits(ARCHS[arch], RunConfig(),
                                      torch.device("cpu"))
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                   OMP_NUM_THREADS="1")
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch",
             arch, "--smoke", "--steps", "2", "--seq-len", "16",
             "--device", "cpu", "--ckpt-dir", os.path.join(tmp, "ck")],
            capture_output=True, text=True, env=env, timeout=300)
        assert out.returncode == 0, out.stderr
        assert "ran 2 steps" in out.stdout
        assert ckpt.latest_step(os.path.join(tmp, "ck")) == 2
