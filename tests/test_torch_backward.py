"""The port's gradients against the reference's ``jax.grad``.

The backward twins of the two kernels on the training path
(``flash_attention_bwd_plain``, ``rmsnorm_bwd_plain``: the formulas the CUDA
kernels compute) against ``jax.grad`` of ``ref.flash_attention_ref`` and
``ref.rmsnorm_ref``; the ``autograd.Function``s that ``ops`` routes through
when a gradient is wanted; and whole reduced models (glm4-9b, and
granite-moe-3b-a800m for the MoE load-balancing loss; the vlm and
whisper in ``test_torch_train_cross``) in float32 with the same
parameters: ``LM.loss`` against the reference's ``model.loss`` within
1e-5 relative, every gradient leaf within 1e-4 x max(1, max |g_ref|).

Tolerances: float32 within 2e-5 of the reference's gradient scale (float32
sums in another order); bfloat16 inputs within 2e-2 (the reference rounds
its gradients to bfloat16 and the twin rounds its own).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.kernels import ref
from repro.models.common import SMOKE_TOPO
from repro.models.model_zoo import build_model as ref_build_model
from repro_torch.configs import ARCHS
from repro_torch.kernels import (flash_attention_bwd_plain,
                                 flash_attention_plain, ops,
                                 rmsnorm_bwd_plain, rmsnorm_plain)
from repro_torch.models import layers
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.models.model_zoo import build_model
from test_torch_models import _f32, reference_tree

GRAD_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
DT = {"float32": (np.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _close(got: torch.Tensor, want, tol: float, what: str) -> None:
    want = np.asarray(jnp.asarray(want, jnp.float32))
    err = np.abs(_f32(got) - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), (what, err)


# ---------------------------------------------------------------------------
# kernel twins
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,skv,H,KV,dh,causal", [
    (2, 16, 16, 4, 2, 32, True),      # GQA, square
    (1, 7, 19, 6, 2, 16, True),       # cached prefill: bottom-right mask
    (2, 9, 13, 4, 4, 32, False),      # cross-attention: sq != skv
    (2, 12, 20, 4, 2, 32, False),     # GQA cross-attention (vlm, whisper)
    (1, 24, 24, 8, 1, 64, True),      # one KV head for eight
])
def test_flash_backward_twin_equals_jax_grad(dtype, b, sq, skv, H, KV, dh,
                                            causal):
    rng = np.random.default_rng(b * 100 + sq + skv)
    jdt, tdt = DT[dtype]
    q = rng.standard_normal((b, sq, H, dh)).astype(np.float32)
    k = rng.standard_normal((b, skv, KV, dh)).astype(np.float32)
    v = rng.standard_normal((b, skv, KV, dh)).astype(np.float32)
    g = rng.standard_normal((b, sq, H, dh)).astype(np.float32)
    jq, jk, jv, jg = (jnp.asarray(a).astype(jdt) for a in (q, k, v, g))

    def f(q, k, v):
        o = ref.flash_attention_ref(q, k, v, causal)
        return jnp.sum(o.astype(jnp.float32) * jg.astype(jnp.float32))

    want = jax.grad(f, argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv, tg = (torch.from_numpy(a).to(tdt) for a in (q, k, v, g))
    o, lse = flash_attention_plain(tq, tk, tv, causal, with_lse=True)
    assert lse.shape == (b, H, sq) and lse.dtype == torch.float32
    got = flash_attention_bwd_plain(tq, tk, tv, o, lse, tg, causal)
    for name, gt, w in zip("qkv", got, want):
        assert gt.dtype == tdt and gt.shape == w.shape
        _close(gt, w, GRAD_TOL[dtype], f"d{name}")


def test_flash_lse_is_the_rows_logsumexp():
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 5, 4, 16), (2, 9, 2, 16), (2, 9, 2, 16)))
    o, lse = flash_attention_plain(q, k, v, True, with_lse=True)
    assert torch.equal(o, flash_attention_plain(q, k, v, True))
    s = torch.einsum("bqhd,bjhd->bhqj", q, k.repeat_interleave(2, 2)) / 4.0
    vis = torch.arange(5)[:, None] + 4 >= torch.arange(9)[None, :]
    want = torch.logsumexp(s.masked_fill(~vis, float("-inf")), -1)
    torch.testing.assert_close(lse, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("xdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("sdt", ["float32", "bfloat16"])
def test_rmsnorm_backward_twin_equals_jax_grad(xdt, sdt):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((24, 64)).astype(np.float32)
    s = (1.0 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    g = rng.standard_normal((24, 64)).astype(np.float32)
    jx, jg = (jnp.asarray(a).astype(DT[xdt][0]) for a in (x, g))
    js = jnp.asarray(s).astype(DT[sdt][0])

    def f(x, s):
        return jnp.sum(ref.rmsnorm_ref(x, s).astype(jnp.float32)
                       * jg.astype(jnp.float32))

    wx, ws = jax.grad(f, argnums=(0, 1))(jx, js)
    tx, tg = (torch.from_numpy(a).to(DT[xdt][1]) for a in (x, g))
    ts = torch.from_numpy(s).to(DT[sdt][1])
    dx, ds = rmsnorm_bwd_plain(tx, ts, tg, 1e-5)
    assert dx.dtype == tx.dtype and ds.dtype == ts.dtype
    tol = max(GRAD_TOL[xdt], GRAD_TOL[sdt])
    _close(dx, wx, tol, "dx")
    _close(ds, ws, tol, "dscale")


# ---------------------------------------------------------------------------
# the autograd Functions and the guards
# ---------------------------------------------------------------------------
def test_ops_route_through_the_functions_when_a_gradient_is_wanted():
    rng = np.random.default_rng(11)
    q, k, v, g = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                  for s in ((2, 8, 4, 16), (2, 8, 2, 16), (2, 8, 2, 16),
                            (2, 8, 4, 16)))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = ops.flash_attention(*leaves, causal=True)
    assert type(o.grad_fn).__name__ == "FlashAttentionFnBackward"
    (o * g).sum().backward()
    o2, lse = flash_attention_plain(q, k, v, True, with_lse=True)
    assert torch.equal(o.detach(), o2)
    for leaf, want in zip(leaves, flash_attention_bwd_plain(
            q, k, v, o2, lse, g, True)):
        assert torch.equal(leaf.grad, want)
    # no gradient wanted: the plain path, no graph
    with torch.no_grad():
        assert ops.flash_attention(*leaves).grad_fn is None

    x = torch.from_numpy(rng.standard_normal((3, 5, 32)).astype(np.float32))
    sc = torch.ones(32, requires_grad=True)
    xl = x.clone().requires_grad_()
    y = ops.rmsnorm(xl, sc)
    assert y.grad_fn is not None
    gy = torch.from_numpy(rng.standard_normal((3, 5, 32)).astype(np.float32))
    (y * gy).sum().backward()
    dx, ds = rmsnorm_bwd_plain(x.reshape(-1, 32), sc.detach(),
                               gy.reshape(-1, 32))
    assert torch.equal(xl.grad, dx.reshape(x.shape))
    assert torch.equal(sc.grad, ds)
    torch.testing.assert_close(y.detach(), rmsnorm_plain(x, sc.detach()))


def test_norm_launches_without_pdl_under_grad(monkeypatch):
    seen = []

    def spy(x, scale, eps=1e-5, *, pdl=False):
        seen.append(pdl)
        return rmsnorm_plain(x, scale, eps)

    monkeypatch.setattr(layers.ops, "rmsnorm", spy)
    norm = layers.Norm("n", 16, device="cpu")
    x = torch.randn(2, 16)
    with torch.no_grad():
        norm(x)                       # serving: a weight, PDL allowed
    norm(x)                           # grad mode, a frozen scale: allowed
    norm.scale.requires_grad_(True)
    norm(x)                           # training: the optimizer writes it
    with torch.no_grad():
        norm(x)
    assert seen == [True, True, False, True]


# ---------------------------------------------------------------------------
# whole models: loss and every gradient leaf
# ---------------------------------------------------------------------------
def _loss_and_grads(arch: str, seed: int):
    ref_cfg = REF_ARCHS[arch].reduced(num_layers=2)
    cfg = ARCHS[arch].reduced(num_layers=2)
    ref_model = ref_build_model(ref_cfg, SMOKE_TOPO, kind="train")
    tree = reference_tree(ref_model, seed, jnp.float32)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (2, 65)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, 5] = cfg.vocab_size + 3        # masked: outside the vocab
    labels[1, 7] = -1                        # masked
    batch = {"tokens": toks[:, :-1], "labels": labels}
    (r_total, r_metrics), r_grads = jax.value_and_grad(
        ref_model.loss, has_aux=True)(tree, batch)
    model = build_model(cfg, kind="train", device="cpu", dtype=torch.float32)
    model.load_state_dict(params_from_jax(tree))
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    total, metrics = model.loss(batch)
    grads = torch.autograd.grad(total, list(params.values()))
    return (r_total, r_metrics, r_grads), (total, metrics,
                                           dict(zip(params, grads)))


@pytest.mark.parametrize("arch,seed", [("glm4-9b", 0),
                                       ("granite-moe-3b-a800m", 1),
                                       ("falcon-mamba-7b", 2),
                                       ("jamba-1.5-large-398b", 3)])
def test_lm_loss_and_every_gradient_equal_the_reference(arch, seed):
    (r_total, r_metrics, r_grads), (total, metrics, grads) = \
        _loss_and_grads(arch, seed)
    for key, want in (("total", r_total), ("loss", r_metrics["loss"]),
                      ("aux_loss", r_metrics["aux_loss"])):
        got = (total if key == "total" else metrics[key]).detach()
        assert got.dtype == torch.float32
        want = float(want)
        assert abs(float(got) - want) <= 1e-5 * max(abs(want), 1e-6), \
            (key, float(got), want)
    if arch.startswith("granite"):
        assert float(metrics["aux_loss"].detach()) > 0
    want_leaves = {jax.tree_util.keystr(p): g for p, g in
                   jax.tree_util.tree_leaves_with_path(r_grads)}
    got_tree = params_to_jax(grads)
    got_leaves = {jax.tree_util.keystr(p): g for p, g in
                  jax.tree_util.tree_leaves_with_path(got_tree)}
    assert set(got_leaves) == set(want_leaves)
    for name, want in want_leaves.items():
        want = np.asarray(want, np.float32)
        err = np.abs(_f32(got_leaves[name]) - want).max()
        assert err <= 1e-4 * max(1.0, np.abs(want).max()), (name, err)
