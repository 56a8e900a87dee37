"""What a rank of a (1, 4) mesh holds and exchanges at full width, counted
on meta.

Rank 0 of four ``LocalGroup`` threads builds ``ServeEngine`` on ``meta``
(no data is made) for the configurations ``chip_smoke.py``'s phases 25 and
26 serve, runs one prefill of their requests and one decode step, and
the calls and bytes its group was handed in each (``Group.counts``) and
the bytes of its parameters (both layouts' blocks, a shared block once)
are pinned.  Those phases count the same on the card; the numbers here
are the prediction they are held to in ``PERF.md``.  whisper-medium's
case is in ``test_torch_tp_counts_encdec.py``, so that ``--dist loadfile``
puts the two files' minute of meta work on two workers.

Training: rank 0's collectives in one train step of phase 27's check
models (glm4-9b and falcon-mamba-7b at full width on 2 layers, 4 x 1024
over a (1, 4) mesh), counted on meta by ``chip_smoke.tp_train_counts``,
which phase 27 holds each rank's steps on the card to.  Per layer and
step (remat: the forward, its recomputation and the backward): a dense
layer gathers its two sublayers' inputs and attention's k and v over
head_dim, reduce-scatters their outputs, and the backward runs each
conjugate; a Mamba layer gathers and scatters once and sums ``x_proj``'s
partials (and their gradient).  The loss gathers the residual and reduces
each 512-token chunk's max, sum and gold logit, again in the chunk's
recomputation; the step adds one all-reduce of the gradient shares and
one of the norm.
"""
import dataclasses
import os
import sys

import pytest
import torch

from repro_torch.configs import ARCHS
from repro_torch.launch.mesh import tp_mesh
from repro_torch.models.common import Topo
from repro_torch.models.parallel import run_local
from repro_torch.serve import ServeEngine

META = torch.device("meta")
TP = 4

# (arch, replaced fields, (batch, prompt tokens), frames of an enc-dec
# request) -> prefill {collective: (calls, bytes)}, decode step {...},
# parameter bytes
CASES = {
    "deepseek-check": (
        ("deepseek-v2-236b", dict(num_layers=2, moe_layer_period=2,
                                  layers_per_period=2), (4, 1000), None),
        {"all_gather": (5, 41369600), "reduce_scatter": (6, 450560000),
         "broadcast": (1, 40960)},
        {"all_reduce": (14, 5703680), "all_gather": (5, 561152)},
        4803973120),
    "deepseek-8-layers": (
        ("deepseek-v2-236b", dict(num_layers=8), (4, 1000), None),
        {"all_gather": (17, 164249600), "reduce_scatter": (25, 2007040000),
         "broadcast": (1, 40960)},
        {"all_reduce": (57, 24657920), "all_gather": (17, 1015808)},
        32796231680),
    "vlm-period": (
        ("llama-3.2-vision-11b", dict(num_layers=5), (4, 1000), None),
        {"all_gather": (24, 124212224), "reduce_scatter": (12, 753664000),
         "broadcast": (1, 32768)},
        {"all_reduce": (30, 1316864), "all_gather": (7, 562176)},
        1217495042),
    "vlm-40-layers": (
        ("llama-3.2-vision-11b", {}, (4, 1000), None),
        {"all_gather": (185, 990106624), "reduce_scatter": (89, 5799936000),
         "broadcast": (1, 32768)},
        {"all_reduce": (233, 10305536), "all_gather": (49, 906240)},
        6062546960),
}


def rank_counts(cfg, request: tuple, memory: int | None) -> dict:
    """Rank 0's collectives in one prefill and one decode step, and its
    parameter bytes, ``max_len`` being the prompt and 36 more."""
    batch, tokens = request
    req = {"tokens": torch.zeros(request, dtype=torch.int64, device=META)}
    if cfg.family == "vlm":
        req["image_embeds"] = torch.zeros(
            (batch, cfg.num_image_tokens, cfg.d_model), device=META)
    if memory is not None:
        req["frames"] = torch.zeros((batch, memory, cfg.d_model),
                                    device=META)
    max_len = tokens + 36

    def rank(g) -> dict:
        eng = ServeEngine(cfg, max_len=max_len, device=META,
                          topo=Topo(tp_mesh(TP)), group=g)
        g.reset_counts()
        _, caches = eng.model.prefill(req)
        prefill = {k: dict(v) for k, v in g.counts.items()}
        caches = eng._pad_caches(caches, batch, memory_len=memory)
        kw = {"cache_len": max_len}
        if memory is not None:
            kw["memory_len"] = memory
        g.reset_counts()
        eng.decode_model.decode_step(caches, torch.zeros(
            batch, dtype=torch.int64, device=META), tokens, **kw)
        params = {id(p): p for m in (eng.model, eng.decode_model)
                  for p in m.parameters()}
        return {"prefill": prefill,
                "step": {k: dict(v) for k, v in g.counts.items()},
                "param_bytes": sum(p.numel() * p.element_size()
                                   for p in params.values())}

    return run_local(rank, TP, [META])[0]


def check_case(case: tuple) -> None:
    """Rank 0's counts for ``case`` (a value of ``CASES``) are pinned."""
    (arch, fields, request, memory), prefill, step, param_bytes = case
    cfg = dataclasses.replace(ARCHS[arch], **fields)
    got = rank_counts(cfg, request, memory)

    def calls_bytes(counts: dict) -> dict:
        return {k: (v["calls"], v["bytes"]) for k, v in counts.items()
                if v["calls"]}

    assert calls_bytes(got["prefill"]) == prefill
    assert calls_bytes(got["step"]) == step
    assert got["param_bytes"] == param_bytes


@pytest.mark.parametrize("case", sorted(CASES))
def test_a_rank_exchanges_and_holds_what_the_chip_phases_predict(case):
    check_case(CASES[case])


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# arch -> a train step's {collective: [calls, bytes]} on rank 0
TRAIN_CASES = {
    "glm4-9b": {"all_reduce": [14, 217092],
                "all_gather": [22, 155189248],
                "reduce_scatter": [16, 612368384]},
    "falcon-mamba-7b": {"all_reduce": [20, 28459012],
                        "all_gather": [8, 83886080],
                        "reduce_scatter": [6, 268435456]},
}


@pytest.mark.parametrize("arch", sorted(TRAIN_CASES))
def test_a_rank_exchanges_in_a_train_step_what_phase_27_predicts(arch):
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    cfg = dataclasses.replace(ARCHS[arch],
                              num_layers=chip_smoke.TP_TRAIN_CHECK_LAYERS)
    assert chip_smoke.TP_TRAIN_SHAPE == (4, 1024)
    assert chip_smoke.tp_train_counts(cfg, TP) == TRAIN_CASES[arch]
