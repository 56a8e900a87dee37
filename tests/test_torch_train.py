"""The port's training path (``optim``, ``data``, ``checkpoint``, ``train``,
``launch.train``) against the reference's, on the CPU.

The optimizer against the reference's bit for bit or within one float32
ulp; the data pipelines exactly; three ``Trainer`` steps of the reduced
float32 glm4-9b from one state in both packages within 1e-4 relative;
checkpoints written by either package resumed by the other (steps 4-6
within 1e-4 relative); and the port's mirrors of
``tests/test_train_and_ckpt.py``.
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
from repro.data import ByteCorpus as RefByteCorpus
from repro.data import SyntheticTokens as RefSyntheticTokens
from repro.models.common import SMOKE_TOPO
from repro.models.model_zoo import build_model as ref_build_model
from repro.optim import adamw_update as ref_adamw_update
from repro.optim import clip_by_global_norm as ref_clip
from repro.optim import init_opt_state as ref_init_opt_state
from repro.optim import warmup_cosine as ref_warmup_cosine
from repro.train import Trainer as RefTrainer
from repro_torch.checkpoint import ckpt
from repro_torch.configs import ARCHS
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.data import ByteCorpus, SyntheticTokens
from repro_torch.ft import PreemptionHandler
from repro_torch.launch import train as train_launcher
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.models.model_zoo import build_model, input_specs, make_batch
from repro_torch.optim import (adamw_update, clip_by_global_norm,
                               global_norm, init_opt_state, warmup_cosine)
from repro_torch.train import Trainer
from repro_torch.train.step import init_state, make_train_step
from test_torch_models import _f32, reference_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = torch.float32


def _run_cfg(cls, tmp, steps=6, **kw):
    return cls(total_steps=steps, warmup_steps=2, checkpoint_every=3,
               checkpoint_dir=tmp, learning_rate=3e-3, **kw)


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    """Largest distance in float32 ulps between two float32 arrays."""
    ia = a.astype(np.float32).view(np.int32).astype(np.int64)
    ib = b.astype(np.float32).view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int(np.abs(ia - ib).max())


# ---------------------------------------------------------------------------
# optimizer and schedule
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_and_clip_equal_the_reference(dtype, moments):
    rng = np.random.default_rng(5)
    shapes = {"a": (7, 33), "b": {"c": (64,), "d": (3, 4, 5)}}
    jdt = jnp.dtype(dtype)
    flat = {"a": shapes["a"], "b.c": shapes["b"]["c"],
            "b.d": shapes["b"]["d"]}
    p_np = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in flat.items()}
    g_np = {k: (rng.standard_normal(s) * 3).astype(np.float32)
            for k, s in flat.items()}

    def tree(d):
        return {"a": jnp.asarray(d["a"]).astype(jdt),
                "b": {"c": jnp.asarray(d["b.c"]).astype(jdt),
                      "d": jnp.asarray(d["b.d"]).astype(jdt)}}

    cfg = RunConfig(weight_decay=0.1)
    rcfg = RefRunConfig(weight_decay=0.1)
    r_params, r_grads = tree(p_np), tree(g_np)
    r_opt = ref_init_opt_state(r_params, moments)
    tdt = {"float32": F32, "bfloat16": torch.bfloat16}[dtype]
    params = {k: torch.from_numpy(v).to(tdt) for k, v in p_np.items()}
    grads = {k: torch.from_numpy(v).to(tdt) for k, v in g_np.items()}
    opt = init_opt_state(params, moments)
    for step in range(3):
        r_clipped, r_norm = ref_clip(r_grads, 1.0)
        clipped, norm = clip_by_global_norm(grads, 1.0)
        assert _ulps(np.asarray(r_norm, np.float32)[None],
                     norm.numpy()[None]) <= 1
        lr_ref = ref_warmup_cosine(rcfg, r_opt["step"])
        lr = warmup_cosine(cfg, opt["step"])
        assert float(lr) == float(lr_ref)
        r_params, r_opt = ref_adamw_update(r_params, r_clipped, r_opt, rcfg,
                                           lr_ref)
        params, opt = adamw_update(params, clipped, opt, cfg, lr)
        assert int(opt["step"]) == int(r_opt["step"]) == step + 1
        got = params_to_jax({"params." + k: v for k, v in params.items()}
                            )["params"]
        for path, want in jax.tree_util.tree_leaves_with_path(r_params):
            node = got
            for key in path:
                node = node[key.key]
            assert node.dtype == tdt
            assert _ulps(np.asarray(jnp.asarray(want, jnp.float32)),
                         _f32(node)) <= 1, (path, step)
        for name in ("m", "v"):
            for k, t in opt[name].items():
                parts = k.split(".")
                want = r_opt[name]
                for key in parts:
                    want = want[key]
                assert _ulps(np.asarray(jnp.asarray(want, jnp.float32)),
                             _f32(t)) <= 1, (name, k, step)
        grads = {k: g * 0.5 for k, g in grads.items()}
        r_grads = jax.tree.map(lambda g: g * 0.5, r_grads)


def test_warmup_cosine_equals_the_reference_at_every_step():
    for kw in (dict(learning_rate=3e-4, warmup_steps=100, total_steps=1000),
               dict(learning_rate=3e-3, warmup_steps=2, total_steps=6),
               dict(learning_rate=1e-2, warmup_steps=0, total_steps=1)):
        for step in list(range(0, 12)) + [99, 100, 101, 555, 999, 1000,
                                          1500]:
            want = ref_warmup_cosine(RefRunConfig(**kw), step)
            got = warmup_cosine(RunConfig(**kw), step)
            assert got.dtype == F32
            assert np.float32(got) == np.asarray(want, np.float32), (kw,
                                                                     step)


def test_optimizer_units():
    params = {"w": torch.ones((4, 4), dtype=torch.bfloat16)}
    grads = {"w": torch.full((4, 4), 2.0, dtype=torch.bfloat16)}
    opt = init_opt_state(params, "bfloat16")
    assert opt["m"]["w"].dtype == torch.bfloat16
    assert opt["step"].dtype == torch.int32
    clipped, norm = clip_by_global_norm(grads, 1.0)
    assert float(norm) == pytest.approx(8.0)
    assert float(global_norm(clipped)) == pytest.approx(1.0, rel=1e-2)
    new_p, new_opt = adamw_update(params, grads, opt, RunConfig(),
                                  torch.tensor(1e-2))
    assert int(new_opt["step"]) == 1
    assert float(new_p["w"][0, 0]) < 1.0   # moved against the gradient


# ---------------------------------------------------------------------------
# data and batches
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["glm4-9b", "llama-3.2-vision-11b",
                                  "whisper-medium"])
def test_data_pipelines_equal_the_reference(arch):
    ref_cfg = REF_ARCHS[arch].reduced()
    cfg = ARCHS[arch].reduced()
    rshape = RefShapeConfig("smoke", 24, 4, "train")
    shape = ShapeConfig("smoke", 24, 4, "train")
    ref_src = RefSyntheticTokens(ref_cfg, rshape, seed=3, host_index=1,
                                 host_count=2)
    src = SyntheticTokens(cfg, shape, seed=3, host_index=1, host_count=2)
    for step in (0, 1, 17):
        want, got = ref_src.batch_at(step), src.batch_at(step)
        assert sorted(want) == sorted(got)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    rb = RefByteCorpus(ref_cfg, rshape, seed=2).batch_at(5)
    b = ByteCorpus(cfg, shape, seed=2).batch_at(5)
    for k in rb:
        np.testing.assert_array_equal(b[k], rb[k])


def test_input_specs_and_make_batch_follow_the_reference_specs():
    from repro.models.model_zoo import input_specs as ref_input_specs
    for arch in ("glm4-9b", "llama-3.2-vision-11b", "whisper-medium"):
        for kind in ("train", "prefill", "decode"):
            ref_cfg, cfg = REF_ARCHS[arch].reduced(), ARCHS[arch].reduced()
            want = ref_input_specs(ref_cfg, RefShapeConfig("x", 16, 2, kind))
            got = input_specs(cfg, ShapeConfig("x", 16, 2, kind))
            assert {k: (tuple(st.shape), str(st.dtype))
                    for k, st in want.items()} == \
                {k: (s, str(d).removeprefix("torch.")) for k, (s, d)
                 in got.items()}
            gen = torch.Generator().manual_seed(0)
            batch = make_batch(cfg, ShapeConfig("x", 16, 2, kind), gen)
            for k, (s, d) in got.items():
                assert tuple(batch[k].shape) == s and batch[k].dtype == d
            assert int(batch["tokens"].max()) < cfg.vocab_size


# ---------------------------------------------------------------------------
# trainers and checkpoints, both packages
# ---------------------------------------------------------------------------
def _glm():
    return (REF_ARCHS["glm4-9b"].reduced(num_layers=2),
            ARCHS["glm4-9b"].reduced(num_layers=2))


def _seed_checkpoint(directory: str) -> None:
    """A float32 reduced glm4-9b state at step 0, written by the
    reference: its tree drawn with numpy, zero moments."""
    ref_cfg, _ = _glm()
    model = ref_build_model(ref_cfg, SMOKE_TOPO, kind="train")
    params = jax.tree.map(jnp.asarray,
                          reference_tree(model, 0, jnp.float32))
    ref_ckpt.save({"params": params,
                   "opt": ref_init_opt_state(params, "float32")},
                  directory, 0)


def test_trainers_and_checkpoints_move_between_the_packages():
    ref_cfg, cfg = _glm()
    rshape = RefShapeConfig("smoke", 32, 4, "train")
    shape = ShapeConfig("smoke", 32, 4, "train")
    with tempfile.TemporaryDirectory() as tmp:
        seed = os.path.join(tmp, "seed")
        _seed_checkpoint(seed)
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
        # the port's step-3 checkpoint in the reference's layout
        rtree, step = ref_ckpt.restore(dirs["port"])
        assert step == 3 and int(rtree["opt"]["step"]) == 3
        assert rtree["params"]["layers"]["l0_attn"]["core"]["wq"].shape[0] \
            == ref_cfg.num_layers
        # cross over: each resumes the other's checkpoint to step 6
        r2 = RefTrainer(ref_cfg, rshape, _run_cfg(RefRunConfig,
                                                  dirs["port"]),
                        SMOKE_TOPO).run()
        p2 = Trainer(cfg, shape, _run_cfg(RunConfig, dirs["ref"]),
                     device="cpu", dtype=F32).run()
        assert r2.restored_from == p2.restored_from == 3
        assert r2.final_step == p2.final_step == 6
        np.testing.assert_allclose(p2.losses, r2.losses, rtol=1e-4)
        # and the two final states agree leaf by leaf
        want, _ = ref_ckpt.restore(dirs["port"], 6)
        got, _ = ckpt.restore(dirs["ref"], 6)
        for path, w in jax.tree_util.tree_leaves_with_path(want):
            g = got
            for key in path:
                g = g[key.key]
            w = np.asarray(jnp.asarray(w, jnp.float32))
            assert np.abs(_f32(g) - w).max() <= 1e-4 * max(
                1.0, np.abs(w).max()), path


def test_loss_decreases_on_byte_corpus():
    _, cfg = _glm()
    cfg = ARCHS["glm4-9b"].reduced(num_layers=2, vocab_size=256)
    shape = ShapeConfig("smoke", seq_len=48, global_batch=8, kind="train")
    with tempfile.TemporaryDirectory() as tmp:
        tr = Trainer(cfg, shape, _run_cfg(RunConfig, tmp, steps=14),
                     data=ByteCorpus(cfg, shape), device="cpu")
        res = tr.run()
    assert all(np.isfinite(res.losses))
    assert np.mean(res.losses[-3:]) < np.mean(res.losses[:3]) - 0.2


def test_checkpoint_resume_continues_exactly():
    _, cfg = _glm()
    shape = ShapeConfig("smoke", seq_len=32, global_batch=4, kind="train")
    with tempfile.TemporaryDirectory() as tmp:
        run = _run_cfg(RunConfig, tmp)
        Trainer(cfg, shape, run, device="cpu").run(num_steps=3)
        r2 = Trainer(cfg, shape, run, device="cpu").run()
        assert r2.restored_from == 3 and r2.final_step == 6
        with tempfile.TemporaryDirectory() as tmp2:
            r3 = Trainer(cfg, shape, _run_cfg(RunConfig, tmp2),
                         device="cpu").run()
    np.testing.assert_allclose(r2.losses, r3.losses[3:], rtol=1e-5)
    assert r2.losses == r3.losses[3:]          # bit for bit on one device


def test_preemption_checkpoints_and_stops():
    _, cfg = _glm()
    shape = ShapeConfig("smoke", seq_len=32, global_batch=4, kind="train")
    with tempfile.TemporaryDirectory() as tmp:
        pre = PreemptionHandler(install=False)
        tr = Trainer(cfg, shape, _run_cfg(RunConfig, tmp, steps=50),
                     preemption=pre, device="cpu")
        pre.trigger()
        res = tr.run()
        assert res.preempted and res.steps_run == 1
        assert ckpt.latest_step(tmp) == 1


def test_ckpt_roundtrip_and_gc_in_both_packages():
    state = {"a": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3),
             "b": {"c": torch.tensor(3.5),
                   "d": torch.arange(4, dtype=torch.int32)},
             "e": [torch.ones(2), torch.zeros(2)]}       # stacked on save
    with tempfile.TemporaryDirectory() as tmp:
        for step in (1, 2, 3, 4):
            ckpt.save(state, tmp, step)
        ckpt.garbage_collect(tmp, keep=2)
        os.makedirs(os.path.join(tmp, "step_00000009.tmp-x"))  # orphan
        assert ckpt.latest_step(tmp) == 4
        restored, step = ckpt.restore(tmp)
        assert step == 4
        assert restored["a"].dtype == torch.bfloat16
        assert torch.equal(restored["a"], state["a"])
        assert float(restored["b"]["c"]) == 3.5
        assert restored["b"]["d"].dtype == torch.int32
        assert torch.equal(restored["e"], torch.stack(state["e"]))
        ckpt.garbage_collect(tmp, keep=2)
        assert sorted(os.listdir(tmp)) == ["step_00000003", "step_00000004"]
        # the reference reads the port's files, bfloat16 bits and all
        ref_state, _ = ref_ckpt.restore(tmp, 4)
        assert ref_state["a"].dtype == jnp.bfloat16
        np.testing.assert_array_equal(np.asarray(ref_state["a"], np.float32),
                                      _f32(state["a"]))
        # and the port the reference's
        ref_ckpt.save({"x": jnp.arange(3, dtype=jnp.bfloat16) / 3}, tmp, 7)
        got, _ = ckpt.restore(tmp, 7)
        np.testing.assert_array_equal(
            _f32(got["x"]), np.asarray(jnp.arange(3, dtype=jnp.bfloat16) / 3,
                                       np.float32))


def test_params_to_jax_inverts_params_from_jax():
    ref_cfg, cfg = _glm()
    model = ref_build_model(ref_cfg, SMOKE_TOPO, kind="train")
    tree = reference_tree(model, 4, jnp.bfloat16)
    back = params_to_jax(params_from_jax(tree))
    for path, want in jax.tree_util.tree_leaves_with_path(tree):
        got = back
        for key in path:
            got = got[key.key]
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      np.asarray(want).view(np.int16))


def test_microbatched_step_matches_unbatched():
    _, cfg = _glm()
    shape = ShapeConfig("smoke", seq_len=32, global_batch=8, kind="train")
    gen = torch.Generator().manual_seed(1)
    batch = make_batch(cfg, shape, gen)
    metrics = {}
    for n_mb in (1, 4):
        model = build_model(cfg, kind="train", device="cpu")
        state = init_state(model, RunConfig(),
                           torch.Generator().manual_seed(0))
        step = make_train_step(model, RunConfig(microbatches=n_mb))
        _, metrics[n_mb] = step(state, batch)
    # bf16 grad accumulation: losses equal, grad norms close
    assert abs(float(metrics[1]["loss"]) - float(metrics[4]["loss"])) < 1e-2
    assert abs(float(metrics[1]["grad_norm"]) -
               float(metrics[4]["grad_norm"])) / \
        max(float(metrics[1]["grad_norm"]), 1e-9) < 0.1
    assert set(metrics[4]) == {"loss", "aux_loss", "grad_norm", "lr"}


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
def test_launcher_trains_on_the_host_and_refuses_what_does_not_fit():
    assert train_launcher.train_state_bytes(
        ARCHS["glm4-9b"], RunConfig()) == 12 * ARCHS["glm4-9b"].param_count()
    with pytest.raises(ValueError, match="do not fit"):
        train_launcher.check_fits(ARCHS["jamba-1.5-large-398b"], RunConfig(),
                                  torch.device("cpu"))
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch",
             "glm4-9b", "--smoke", "--steps", "2", "--seq-len", "16",
             "--device", "cpu", "--ckpt-dir", os.path.join(tmp, "ck")],
            capture_output=True, text=True, env=env, timeout=300)
        assert out.returncode == 0, out.stderr
        assert "ran 2 steps" in out.stdout
        assert ckpt.latest_step(os.path.join(tmp, "ck")) == 2
