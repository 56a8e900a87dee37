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
"""
import dataclasses

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
