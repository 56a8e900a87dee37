"""Tensor-parallel training (the dense and ssm families over a (1, tp)
mesh) against the reference's unsharded model, on the CPU.

Reduced glm4-9b (qkv biases, 2 KV heads), command-r-35b and
falcon-mamba-7b, 2 layers, get the reference's numpy parameters
(``test_torch_models.reference_tree``), cut into each rank's blocks by
``convert.rank_state_dict``; the ranks are ``LocalGroup`` threads.  At a
length that tp divides the residual is cut over the sequence
(Megatron-SP), at one it does not divide it is replicated.  Held to the
reference's ``model.loss`` under ``jax.value_and_grad`` and two steps of
its ``make_train_step`` (``SMOKE_TOPO``, clip and AdamW; one case with 2
microbatches):

- the loss on every rank within 1e-5 (float32);
- each rank's block of every gradient leaf, after the step's sum of the
  replicated leaves' shares (``model.grad_shares``), within 1e-4 x
  max(1, |leaf|) of the reference's leaf at ``shard_slices``; bfloat16
  within ``BF16_TOL``;
- the global norm over the ranks within rtol 1e-5;
- each step's loss and grad norm, and every rank's parameter blocks after
  the two steps, within 1e-4 (float32);
- the leaves every rank holds whole bitwise equal on all ranks, the
  parameters and both moments.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs.base import RunConfig as RefRunConfig
from repro.models.common import SMOKE_TOPO
from repro.models.model_zoo import build_model as ref_build_model
from repro.optim import clip_by_global_norm as ref_clip
from repro.optim import init_opt_state as ref_init_opt_state
from repro.train.step import make_train_step as ref_make_train_step
from repro_torch.configs import ARCHS
from repro_torch.configs.base import RunConfig
from repro_torch.launch.mesh import tp_mesh
from repro_torch.models.common import Topo
from repro_torch.models.convert import params_from_jax, rank_state_dict
from repro_torch.models.model_zoo import build_model
from repro_torch.models.parallel import run_local
from repro_torch.optim import global_norm
from repro_torch.train.step import make_state, make_train_step, sum_shares
from test_torch_models import BF16_TOL, DTYPES, reference_tree

BATCH = 4
STEPS = 2

# id -> (arch, tp, tokens, dtype, microbatches)
CASES = {
    "glm-tp2-seq": ("glm4-9b", 2, 16, "float32", 1),
    "glm-tp4-replicated": ("glm4-9b", 4, 15, "float32", 1),
    "glm-tp4-seq-bf16": ("glm4-9b", 4, 16, "bfloat16", 1),
    "command-r-tp4-seq": ("command-r-35b", 4, 16, "float32", 1),
    "command-r-tp2-replicated-2mb": ("command-r-35b", 2, 15, "float32", 2),
    "mamba-tp2-replicated": ("falcon-mamba-7b", 2, 15, "float32", 1),
    "mamba-tp4-seq": ("falcon-mamba-7b", 4, 16, "float32", 1),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small ops on tp threads: one intra-op thread each keeps the suite's
    parallel workers from oversubscribing the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _run_cfg(cls, n_mb: int):
    return cls(learning_rate=3e-3, warmup_steps=1, total_steps=10,
               microbatches=n_mb)


def _batches(vocab: int, s: int, seed: int) -> list[dict]:
    """``STEPS`` batches of (BATCH, s) tokens and their next tokens, one
    label outside the vocabulary and one negative (both masked)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        toks = rng.integers(0, vocab, (BATCH, s + 1)).astype(np.int32)
        labels = toks[:, 1:].copy()
        labels[0, 3] = vocab + 7
        labels[1, 2] = -1
        out.append({"tokens": toks[:, :-1], "labels": labels})
    return out


def _leaves(tree) -> dict[str, np.ndarray]:
    """A reference tree as float32 numpy leaves by the port's names."""
    return {k: v.float().numpy() for k, v in params_from_jax(
        jax.tree.map(lambda x: np.asarray(x, np.float32), tree)).items()}


@functools.lru_cache(maxsize=None)
def _reference(arch: str, s: int, dtype: str, n_mb: int):
    """The reference's numpy tree and batches, its loss, gradients and
    their global norm at the first batch, and two train steps' losses,
    grad norms and parameters."""
    cfg = REF_ARCHS[arch].reduced(num_layers=2)
    model = ref_build_model(cfg, SMOKE_TOPO, kind="train")
    tree = reference_tree(model, 11, DTYPES[dtype][0])
    batches = _batches(cfg.vocab_size, s, 12)
    params = jax.tree.map(jnp.asarray, tree)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        model.loss, has_aux=True))(params, batches[0])
    norm = ref_clip(grads, 1.0)[1]
    step = jax.jit(ref_make_train_step(model, _run_cfg(RefRunConfig, n_mb),
                                       SMOKE_TOPO))
    state = {"params": params, "opt": ref_init_opt_state(params, "float32")}
    losses, norms = [], []
    for b in batches:
        state, metrics = step(state, b)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    return (tree, batches, float(loss), _leaves(grads), float(norm), losses,
            norms, _leaves(state["params"]))


def train_rank(group, arch: str, dtype, tree: dict, batches: list,
               n_mb: int) -> dict:
    """One rank: its blocks of ``tree``, the loss and the gradients at the
    first batch (the shares summed), their norm over the ranks, then
    ``STEPS`` train steps; CPU tensors and numbers."""
    cfg = ARCHS[arch].reduced(num_layers=2)
    model = build_model(cfg, Topo(tp_mesh(group.size)), "train",
                        device="cpu", dtype=dtype, group=group)
    model.load_state_dict(rank_state_dict(tree, model))
    run_cfg = _run_cfg(RunConfig, n_mb)
    state = make_state(dict(model.named_parameters()), run_cfg)
    params = state["params"]
    total, _ = model.loss(batches[0])
    grads = dict(zip(params, torch.autograd.grad(total,
                                                 list(params.values()))))
    sum_shares(grads, model.grad_shares(batches[0]["tokens"].shape[1]),
               group)
    cut = model.cut_params()
    norm = global_norm(grads, group, cut)
    step = make_train_step(model, run_cfg)
    losses, norms = [], []
    for b in batches:
        state, metrics = step(state, b)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    whole = [n for n in params if n not in cut]
    return {"loss": float(total.detach()), "grads": grads,
            "norm": float(norm),
            "losses": losses, "norms": norms, "blocks": model.blocks(),
            "params": {n: p.detach().clone() for n, p in params.items()},
            "whole": {n: (params[n].detach().clone(),
                          state["opt"]["m"][n].clone(),
                          state["opt"]["v"][n].clone()) for n in whole}}


def _close(got: torch.Tensor, want: np.ndarray, dtype: str,
           what: str) -> None:
    got = got.detach().float().numpy()
    if dtype == "bfloat16":
        np.testing.assert_allclose(got, want, **BF16_TOL, err_msg=what)
        return
    err = np.abs(got - want).max()
    assert err <= 1e-4 * max(1.0, np.abs(want).max()), (what, err)


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_train_step_matches_the_reference(case):
    arch, tp, s, dtype, n_mb = CASES[case]
    (tree, batches, loss, grads, norm, losses, norms,
     params) = _reference(arch, s, dtype, n_mb)
    ranks = run_local(lambda g: train_rank(
        g, arch, DTYPES[dtype][1], tree, batches, n_mb), tp)
    rtol = 1e-5 if dtype == "float32" else BF16_TOL["rtol"]
    for r, got in enumerate(ranks):
        assert abs(got["loss"] - loss) <= rtol * abs(loss), (r, got["loss"],
                                                              loss)
        assert abs(got["norm"] - norm) <= rtol * norm, (r, got["norm"], norm)
        assert sorted(got["grads"]) == sorted(grads)
        for name, g in got["grads"].items():
            want = grads[name][got["blocks"][name]]
            assert tuple(g.shape) == want.shape, name
            _close(g, want, dtype, f"rank {r} grad {name}")
        if dtype == "float32":
            np.testing.assert_allclose(got["losses"], losses, rtol=1e-4)
            np.testing.assert_allclose(got["norms"], norms, rtol=1e-4)
        for name, p in got["params"].items():
            _close(p, params[name][got["blocks"][name]], dtype,
                   f"rank {r} step {STEPS} {name}")
        for name, leaves in got["whole"].items():
            for a, b in zip(leaves, ranks[0]["whole"][name]):
                assert torch.equal(a, b), (r, name)
    assert ranks[0]["whole"], "no leaf held whole"
