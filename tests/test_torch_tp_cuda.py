"""Tensor-parallel serving on the card (``cuda`` marker; skipped without a
card).  Imports neither JAX nor the reference package:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_tp_cuda.py

The ranks are ``LocalGroup`` threads on the cards there are (every rank on
card 0 of a one-card machine), each launching its own kernels.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS
from repro_torch.configs.base import MeshConfig
from repro_torch.kernels import build
from repro_torch.models.common import Topo
from repro_torch.models.layers import matmul_f32
from repro_torch.models.parallel import run_local
from repro_torch.serve import ServeEngine

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
