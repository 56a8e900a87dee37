"""Tensor-parallel serving on the card (``cuda`` marker; skipped without a
card).  Imports neither JAX nor the reference package:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_tp_cuda.py

The ranks are ``LocalGroup`` threads on the cards there are (every rank on
card 0 of a one-card machine), each launching its own kernels; training's
ranks are processes (``parallel.spawn``: NCCL with a card each, else gloo
processes sharing the cards), since threads cannot run backward passes on
one card together.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS
from repro_torch.configs.base import MeshConfig, RunConfig, ShapeConfig
from repro_torch.kernels import build
from repro_torch.models.common import Topo
from repro_torch.models.layers import matmul_f32
from repro_torch.models.parallel import LocalGroup, run_local, spawn
from repro_torch.serve import ServeEngine
from repro_torch.train import Trainer
from repro_torch.train.step import make_train_step

TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
       torch.bfloat16: dict(rtol=2e-2, atol=5e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
def test_float32_partials_of_a_bf16_product(cuda):
    """``matmul_f32`` on the card: bf16 operands, float32 out, equal to the
    float32 product of the widened operands within float32 rounding."""
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(3, 5, 256, device=cuda, generator=g).bfloat16()
    w = torch.randn(256, 64, device=cuda, generator=g).bfloat16()
    got = matmul_f32(x, w)
    assert got.dtype == torch.float32 and got.shape == (3, 5, 64)
    want = (x.double() @ w.double()).float()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    # under autograd: the backward of the bf16 product (bf16 gradients)
    dy = torch.randn(3, 5, 64, device=cuda, generator=g).bfloat16()
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    got = torch.autograd.grad(matmul_f32(xg, wg), (xg, wg), dy.float())
    want = torch.autograd.grad(xg @ wg, (xg, wg), dy)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tp", [2, 4])
def test_tp_ranks_on_the_card_match_one_card(cuda, tp, dtype):
    """A reduced command-r-35b (2 KV heads: at tp = 4 two ranks read one)
    over tp threads: prefill logits and 4 greedy steps equal the unsharded
    engine's within the models' tolerances, the ids equal, every rank
    launching 2 flash kernels (one a layer) and 5 rmsnorms a forward."""
    cfg = ARCHS["command-r-35b"].reduced(num_layers=2)
    tokens = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 64)).astype(np.int32)
    one = ServeEngine(cfg, max_len=72, device=cuda, dtype=dtype)
    one.init_params(0)
    want_logits = one.model.prefill({"tokens": tokens})[0]
    want = one.generate({"tokens": tokens}, 4)
    topo = Topo(MeshConfig((1, tp), ("data", "model")))
    devices = [torch.device("cuda", i)
               for i in range(torch.cuda.device_count())]

    def rank(g):
        eng = ServeEngine(cfg, max_len=72, device=g.device, dtype=dtype,
                          topo=topo, group=g)
        eng.init_params(0)
        logits = eng.model.prefill({"tokens": tokens})[0]
        with build.rank_counts() as launches:
            ids = eng.generate({"tokens": tokens}, 4)
        return logits.cpu(), ids, dict(launches)

    for logits, ids, launches in run_local(rank, tp, devices):
        torch.testing.assert_close(logits, want_logits.cpu(), **TOL[dtype])
        np.testing.assert_array_equal(ids, want)
        assert launches["flash_attention"] == 2
        assert launches["rmsnorm"] == 5 * 5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tp", [2, 4])
def test_tp_jamba_ranks_on_the_card_match_one_card(cuda, tp, dtype):
    """A reduced jamba-1.5-large-398b (layer 0 Mamba + MLP, layer 1
    attention + MoE: ``ep`` experts in prefill, ``ep_decode``'s d_ff in
    decode, the Mamba channels cut) over tp threads: prefill logits and 4
    greedy steps equal the unsharded engine's within the models'
    tolerances, the ids equal, every rank launching 1 flash kernel a
    prefill, 1 ``ssm_scan`` and 5 rmsnorms a forward."""
    cfg = ARCHS["jamba-1.5-large-398b"].reduced(num_layers=2)
    tokens = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 64)).astype(np.int32)
    one = ServeEngine(cfg, max_len=72, device=cuda, dtype=dtype)
    one.init_params(0)
    want_logits = one.model.prefill({"tokens": tokens})[0]
    want = one.generate({"tokens": tokens}, 4)
    topo = Topo(MeshConfig((1, tp), ("data", "model")))
    devices = [torch.device("cuda", i)
               for i in range(torch.cuda.device_count())]

    def rank(g):
        eng = ServeEngine(cfg, max_len=72, device=g.device, dtype=dtype,
                          topo=topo, group=g)
        eng.init_params(0)
        logits = eng.model.prefill({"tokens": tokens})[0]
        with build.rank_counts() as launches:
            ids = eng.generate({"tokens": tokens}, 4)
        return logits.cpu(), ids, dict(launches)

    for logits, ids, launches in run_local(rank, tp, devices):
        torch.testing.assert_close(logits, want_logits.cpu(), **TOL[dtype])
        np.testing.assert_array_equal(ids, want)
        assert launches["flash_attention"] == 1
        assert launches["ssm_scan"] == 5
        assert launches["rmsnorm"] == 5 * 5


def away_from_zero(model, seed: int = 5) -> None:
    """Every vlm gate and attention bias (zero at init, where they would
    leave the cross layers out or hide a bias added once a rank) drawn in
    [0.5, 1.5] on the host from ``seed``, whole, and the model's block of
    it kept: the same values on one card and on every rank."""
    gen = torch.Generator().manual_seed(seed)
    defs, blocks = model.param_defs().defs, model.blocks()
    with torch.no_grad():
        for name, p in sorted(model.named_parameters()):
            if name.rsplit(".", 1)[-1] in ("gate", "bq", "bk", "bv", "bo"):
                whole = torch.rand(defs[name].shape, generator=gen) + 0.5
                p.copy_(whole[blocks[name]].to(p.device))


# per arch: its stub input, flash launches a prefill and rmsnorm launches a
# forward of the reduced model (4 layers; the vlm's 2 cross layers,
# whisper's 2 encoder layers and LayerNorms)
CROSS_ARCHS = {"deepseek-v2-236b": (None, 0, 3 * 4 + 1),
               "llama-3.2-vision-11b": ("image_embeds", 4 + 2, 2 * 4 + 2 + 1),
               "whisper-medium": ("frames", 2 + 2 * 4, 0)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", sorted(CROSS_ARCHS))
def test_tp_mla_and_cross_ranks_on_the_card_match_one_card(cuda, arch, tp,
                                                           dtype):
    """A reduced deepseek-v2 (MLA + MoE), vlm or whisper over tp threads,
    its gates and biases away from zero: prefill logits and 4 greedy steps
    equal the unsharded engine's within the models' tolerances, the ids
    equal, every rank launching the model's flash kernels a prefill (on
    its heads; the vlm's cross layers and whisper's encoder and cross
    layers in float32 over the float32 memory) and rmsnorms a forward (3
    a deepseek layer: the two norms and the latent norm)."""
    cfg = ARCHS[arch].reduced()
    key, flash, norms = CROSS_ARCHS[arch]
    rng = np.random.default_rng(4)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 64)).astype(
        np.int32)}
    if key is not None:
        memory = cfg.num_image_tokens if key == "image_embeds" else 96
        batch[key] = rng.standard_normal((2, memory, cfg.d_model)).astype(
            np.float32) * 0.02
    one = ServeEngine(cfg, max_len=72, device=cuda, dtype=dtype)
    one.init_params(0)
    away_from_zero(one.model)
    want_logits = one.model.prefill(batch)[0]
    want = one.generate(batch, 4)
    topo = Topo(MeshConfig((1, tp), ("data", "model")))
    devices = [torch.device("cuda", i)
               for i in range(torch.cuda.device_count())]

    def rank(g):
        eng = ServeEngine(cfg, max_len=72, device=g.device, dtype=dtype,
                          topo=topo, group=g)
        eng.init_params(0)
        away_from_zero(eng.model)
        logits = eng.model.prefill(batch)[0]
        with build.rank_counts() as launches:
            ids = eng.generate(batch, 4)
        return logits.cpu(), ids, dict(launches)

    for logits, ids, launches in run_local(rank, tp, devices):
        torch.testing.assert_close(logits, want_logits.cpu(), **TOL[dtype])
        np.testing.assert_array_equal(ids, want)
        assert launches["flash_attention"] == flash
        assert launches["rmsnorm"] == norms * 5


TRAIN_CFG = ARCHS["glm4-9b"].reduced(num_layers=2)


def _train(group, device, dtype) -> dict:
    """3 float32 or bf16 ``Trainer`` steps of the reduced glm4-9b on
    ``device``, over the group's (1, tp) mesh (one card without one), 4 x
    64 tokens, no checkpoints: the losses and the rank's launches."""
    tp = 1 if group is None else group.size
    trainer = Trainer(
        TRAIN_CFG, ShapeConfig("t", 64, 4, "train"),
        RunConfig(total_steps=3, warmup_steps=1, checkpoint_dir=None),
        Topo(MeshConfig((1, tp), ("data", "model"))), device=device,
        dtype=dtype, group=group)
    build.reset_launches()
    res = trainer.run()
    return {"losses": res.losses, "launches": dict(build.LAUNCHES)}


def train_rank(group, dtype) -> dict:
    return _train(group, group.device, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tp_training_on_the_card_matches_one_card(cuda, dtype):
    """A reduced glm4-9b trained over 2 ranks (NCCL processes with 2 cards,
    else gloo processes sharing the card): each step's loss within the
    models' tolerance of one card's, every rank launching what one card
    launches (2L flash, L backward, 4L + 1 rmsnorm and 2L + 1 backward a
    step, its heads through the kernels); threads on a card are refused."""
    one = _train(None, cuda, dtype)
    n = torch.cuda.device_count()
    ranks = spawn(train_rank, 2, "nccl" if n >= 2 else "gloo",
                  timeout=600.0, args=(dtype,),
                  devices=None if n >= 2 else [str(cuda)])
    for r in ranks:
        np.testing.assert_allclose(r["losses"], one["losses"],
                                   rtol=TOL[dtype]["rtol"])
        assert r["launches"] == one["launches"]
        assert r["losses"] == ranks[0]["losses"]
    from repro_torch.models.model_zoo import build_model
    model = build_model(TRAIN_CFG, Topo(MeshConfig((1, 2), ("data",
                                                           "model"))),
                        "train", device="meta",
                        group=LocalGroup.make(2, [cuda])[0])
    with pytest.raises(ValueError, match="cannot train"):
        make_train_step(model, RunConfig())
