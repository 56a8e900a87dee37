"""Training the port's ssm and hybrid families (falcon-mamba-7b, jamba)
against the reference, on the CPU.

- ``ssm_scan_bwd_plain`` (the formulas of the ``ssm_scan_bwd`` CUDA kernel)
  against ``jax.grad`` of ``ref.ssm_scan_ref`` with cotangents on y and
  h_last: float32 and bfloat16 x (and dt), with and without D, h0 and
  dh_last, at lengths that are not a multiple of the kernel's 16-step
  block, within ``test_torch_backward.GRAD_TOL`` of the gradient's scale;
- ``ops.ssm_scan`` under grad goes through ``SSMScanFn``: its gradients
  are the twin's bit for bit, and ``torch.autograd.grad`` of
  ``ssm_scan_plain`` within 2e-6 (float32 sums in another order);
- one ``MambaBlock`` at s = 256 (two of the reference's 128-token chunks,
  each recomputed in its backward): output and every gradient leaf against
  ``jax.grad`` of the reference block;
- three ``Trainer`` steps of the reduced float32 models in both packages
  from one reference-written checkpoint (losses within 1e-4 relative), each
  package resuming the other's step-3 checkpoint to step 6, the states
  within 1e-4 x max(1, max |leaf|);
- ``launch/train.py --smoke`` for both archs on the CPU, and the whole
  falcon-mamba-7b refused (87.3 GB of train state).

``test_torch_backward`` holds both reduced models' loss and every gradient
leaf to the reference's ``jax.value_and_grad``.
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
from repro.kernels import ref
from repro.models.common import SMOKE_TOPO
from repro.models.model_zoo import build_model as ref_build_model
from repro.optim import init_opt_state as ref_init_opt_state
from repro.train import Trainer as RefTrainer
from repro_torch.checkpoint import ckpt
from repro_torch.configs import ARCHS
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.kernels import (SSMScanFn, build, ops, scan_bwd_work,
                                 ssm_scan_bwd, ssm_scan_bwd_plain,
                                 ssm_scan_plain)
from repro_torch.launch import train as train_launcher
from repro_torch.models.convert import to_tensor
from repro_torch.train import Trainer
from test_torch_backward import GRAD_TOL
from test_torch_models import _f32, reference_tree
from test_torch_ssm import _blocks, scan_inputs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = torch.float32
FALCON, JAMBA = "falcon-mamba-7b", "jamba-1.5-large-398b"
ARCH_NAMES = (FALCON, JAMBA)
GRADS = ("dx", "ddt", "dA", "dB", "dC", "dD", "dh0")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small tensor ops: one thread runs them as fast as eight, and
    the suite's parallel workers would oversubscribe the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _close(got, want, tol: float, what: str) -> None:
    want = np.asarray(jnp.asarray(want, jnp.float32))
    err = np.abs(_f32(got) - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), (what, err)


# ---------------------------------------------------------------------------
# the backward twin
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,di,ds", [(2, 37, 24, 8), (1, 50, 40, 16)])
@pytest.mark.parametrize("skip,with_h0,with_dh", [
    (False, False, False), (True, False, False), (True, True, False),
    (True, True, True), (False, True, True)],
    ids=["bare", "D", "D-h0", "D-h0-dh", "h0-dh"])
def test_scan_backward_twin_equals_jax_grad(dtype, b, s, di, ds, skip,
                                            with_h0, with_dh):
    t, j = scan_inputs(b, s, di, ds, b * 100 + s + ds, dtype)
    rng = np.random.default_rng(s + ds)
    dy = rng.standard_normal((b, s, di)).astype(np.float32)
    dh = rng.standard_normal((b, di, ds)).astype(np.float32)
    tdy = torch.from_numpy(dy).to(t["x"].dtype)       # y's dtype
    jdy = jnp.asarray(tdy.to(F32).numpy())
    D = j["D"] if skip else jnp.zeros_like(j["D"])      # the reference's D

    def f(x, dt, A, B, C, D, h0):
        y, h_last = ref.ssm_scan_ref(x, dt, A, B, C, D,
                                     h0 if with_h0 else None)
        loss = jnp.sum(y.astype(jnp.float32) * jdy)
        return loss + (jnp.sum(h_last * dh) if with_dh else 0.0)

    want = jax.grad(f, argnums=tuple(range(7)))(
        j["x"], j["dt"], j["A"], j["B"], j["C"], D, j["h0"])
    got = ssm_scan_bwd_plain(t["x"], t["dt"], t["A"], t["B"], t["C"],
                             t["D"] if skip else None,
                             t["h0"] if with_h0 else None, tdy,
                             torch.from_numpy(dh) if with_dh else None)
    assert got[0].dtype == t["x"].dtype and got[1].dtype == t["dt"].dtype
    for name, g, w, given in zip(GRADS, got, want, (
            True, True, True, True, True, skip, with_h0)):
        if not given:
            assert g is None, name
            continue
        assert tuple(g.shape) == w.shape, name
        _close(g, w, GRAD_TOL[dtype], name)
    # the wrapper takes the twin for CPU tensors
    again = ssm_scan_bwd(t["x"], t["dt"], t["A"], t["B"], t["C"],
                         t["D"] if skip else None,
                         t["h0"] if with_h0 else None, tdy,
                         torch.from_numpy(dh) if with_dh else None)
    for a, c in zip(got, again):
        assert (a is None and c is None) or torch.equal(a, c)


def test_scan_backward_rejects_what_it_does_not_take():
    t, _ = scan_inputs(1, 8, 16, 4, 0)
    args = [t[k] for k in ("x", "dt", "A", "B", "C", "D", "h0")]
    with pytest.raises(ValueError, match="dy must be"):
        ssm_scan_bwd(*args, torch.zeros(1, 7, 16))
    with pytest.raises(ValueError, match="dh_last must be"):
        ssm_scan_bwd(*args, torch.zeros(1, 8, 16), torch.zeros(1, 16, 5))


def test_scan_bwd_work_counts_the_least_work():
    # falcon-mamba-7b's training shape: x and dy bf16, dt float32
    w = scan_bwd_work(4, 1024, 8192, 16, 2, 4, skip=False, h0=False,
                      dh_last=False)
    bsd = 4 * 1024 * 8192
    assert w["exps"] == bsd * 16
    assert w["flops"] == 19 * bsd * 16 + 4 * bsd
    assert w["bytes"] == bsd * (3 * 2 + 2 * 4) + 4 * 4 * 1024 * 16 * 4 \
        + 2 * 8192 * 16 * 4
    more = scan_bwd_work(4, 1024, 8192, 16, 2, 4, skip=True, h0=True,
                         dh_last=True)
    assert more["bytes"] - w["bytes"] == 2 * 8192 * 4 + 3 * 4 * 8192 * 16 * 4
    assert more["flops"] - w["flops"] == 4 * bsd


# ---------------------------------------------------------------------------
# the autograd Function
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
def test_ops_ssm_scan_under_grad_goes_through_the_function(with_h0):
    t, _ = scan_inputs(2, 21, 32, 8, 5)
    before = build.LAUNCHES["ssm_scan_bwd"]
    names = ("x", "dt", "A", "B", "C", "D", "h0")
    leaves = [t[k].clone().requires_grad_() for k in names]
    h0 = leaves[6] if with_h0 else None
    y, h_last = ops.ssm_scan(*leaves[:6], h0=h0)
    assert type(y.grad_fn).__name__ == "SSMScanFnBackward"
    rng = np.random.default_rng(9)
    gy = torch.from_numpy(rng.standard_normal(y.shape).astype(np.float32))
    gh = torch.from_numpy(rng.standard_normal(h_last.shape).astype(
        np.float32))
    wanted = leaves if with_h0 else leaves[:6]
    got = torch.autograd.grad((y * gy).sum() + (h_last * gh).sum(), wanted)
    plain = [t[k].clone().requires_grad_() for k in names]
    y2, h2 = ssm_scan_plain(*plain[:6], h0=plain[6] if with_h0 else None)
    assert torch.equal(y.detach(), y2.detach())
    assert torch.equal(h_last.detach(), h2.detach())
    want = torch.autograd.grad((y2 * gy).sum() + (h2 * gh).sum(),
                               plain if with_h0 else plain[:6])
    for name, a, w in zip(names, got, want):
        torch.testing.assert_close(a, w, rtol=2e-6, atol=2e-6,
                                   msg=name)
    # the Function's backward is the twin, bit for bit
    twin = ssm_scan_bwd_plain(*[t[k] for k in names[:6]],
                              t["h0"] if with_h0 else None, gy, gh)
    for name, a, w in zip(names, got, twin):
        assert torch.equal(a, w), name
    # only y used: h_last's gradient is absent, not materialised
    y3, _ = SSMScanFn.apply(*leaves[:6], h0)
    (g3,) = torch.autograd.grad((y3 * gy).sum(), leaves[:1])
    assert torch.equal(g3, ssm_scan_bwd_plain(
        *[t[k] for k in names[:6]], t["h0"] if with_h0 else None, gy)[0])
    # no gradient wanted: no graph; an in-place state under grad: refused
    with torch.no_grad():
        assert ops.ssm_scan(*leaves[:6]).__getitem__(0).grad_fn is None
    with pytest.raises(ValueError, match="h_out"):
        ops.ssm_scan(*leaves[:6], h0=leaves[6], h_out=t["h0"].clone())
    assert build.LAUNCHES["ssm_scan_bwd"] == before   # no kernel on the CPU


# ---------------------------------------------------------------------------
# one Mamba block
# ---------------------------------------------------------------------------
def test_mamba_block_gradients_equal_the_reference():
    s = 256            # two of the reference's chunks, each rematerialised
    rblock, rp, port = _blocks(s + 1)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, s, 64)).astype(np.float32) * 0.5
    g = rng.standard_normal((2, s, 64)).astype(np.float32)

    def f(p, x):
        out = rblock(p, x, None, SMOKE_TOPO)
        return jnp.sum(out * g), out

    (_, want_out), (want_p, want_x) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(rp, jnp.asarray(x))
    params = dict(port.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    xt = to_tensor(x).requires_grad_()
    out = port(xt)
    np.testing.assert_allclose(_f32(out), _f32(want_out), rtol=3e-5,
                               atol=3e-5)
    got = torch.autograd.grad((out * torch.from_numpy(g)).sum(),
                              [xt, *params.values()])
    assert set(params) == set(want_p)
    _close(got[0], want_x, GRAD_TOL["float32"], "x")
    for (name, _), gp in zip(params.items(), got[1:]):
        _close(gp, want_p[name], GRAD_TOL["float32"], name)
        assert float(gp.abs().max()) > 0, name


# ---------------------------------------------------------------------------
# trainers, checkpoints and the launcher
# ---------------------------------------------------------------------------
def _cfgs(arch: str):
    return (REF_ARCHS[arch].reduced(num_layers=2),
            ARCHS[arch].reduced(num_layers=2))


def _leaves(tree) -> dict:
    return {jax.tree_util.keystr(p): g
            for p, g in jax.tree_util.tree_leaves_with_path(tree)}


def _run_cfg(cls, tmp, steps=6):
    return cls(total_steps=steps, warmup_steps=2, checkpoint_every=3,
               checkpoint_dir=tmp, learning_rate=3e-3)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_ssm_trainers_and_checkpoints_move_between_the_packages(arch):
    ref_cfg, cfg = _cfgs(arch)
    rshape = RefShapeConfig("smoke", 32, 4, "train")
    shape = ShapeConfig("smoke", 32, 4, "train")
    with tempfile.TemporaryDirectory() as tmp:
        seed = os.path.join(tmp, "seed")
        model = ref_build_model(ref_cfg, SMOKE_TOPO, kind="train")
        params = jax.tree.map(jnp.asarray,
                              reference_tree(model, 6, jnp.float32))
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
        assert any("mamba" in k for k in _leaves(rtree["params"]))
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
        want, got = _leaves(want), _leaves(got)
        assert set(got) == set(want)
        bad = []
        for name, w in want.items():
            w = np.asarray(jnp.asarray(w, jnp.float32))
            err = np.abs(_f32(got[name]) - w).max()
            if not err <= 1e-4 * max(1.0, np.abs(w).max()):
                bad.append((name, float(err)))
        assert not bad, bad


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_launcher_trains_ssm_models_on_the_host(arch):
    # 7.27 B parameters at 12 B each: 87.3 GB; jamba's 398 B far more
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
