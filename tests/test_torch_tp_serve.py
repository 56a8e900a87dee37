"""Tensor-parallel dense serving (``Topo`` over a (1, tp) mesh) against the
reference's unsharded model.

Reduced command-r-35b and glm4-9b (glm4 with its qkv biases) get the
reference's numpy parameters (``test_torch_models.reference_tree``), cut
into each rank's blocks by ``convert.rank_state_dict``.  The ranks are
``LocalGroup`` threads; tp = 4 puts fewer KV heads (2) than ranks, so two
ranks' q heads read one KV head.  Prefill logits, the whole caches and 8
teacher-forced decode steps (the decode caches put back together from the
ranks' runs) are held to the reference at 1e-4 in float32 and
``BF16_TOL`` in bfloat16, and greedy ids are equal in float32.

The float32 comparison lays the decode caches out in float32, in both
packages.  The ranks sum row-parallel partials in another order than one
GEMM, a few float32 ulps apart, and the served bfloat16 cache rounds a
written k or v to 2^-8: where the two land on either side of a rounding
edge, the cache differs by a bfloat16 ulp and a later step's logits by
~3e-4 (seen on glm4-9b at tp = 2).  float32 caches keep the comparison one
of the arithmetic; the bfloat16 caches are held in the bfloat16 tests and
by ``generate``'s greedy ids.  A prompt
and a cache length that tp does not divide fall back to a replicated
residual and whole caches, as the reference's ``resolve`` does.
``test_torch_tp_dist`` holds gloo processes (``DistGroup``) to the
threads.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.models.common import SMOKE_TOPO
from repro.serve import ServeEngine as RefServeEngine
from repro_torch.configs import ARCHS
from repro_torch.configs.base import MeshConfig
from repro_torch.models.attention import rank_kv_heads
from repro_torch.models.common import Topo
from repro_torch.models.parallel import LocalGroup, run_local
from repro_torch.serve import ServeEngine
from test_torch_models import BF16_TOL, DTYPES, F32_TOL, reference_tree

STEPS = 8


def _cfgs(arch: str, widths: tuple = ()):
    """The reduced config of both packages, ``widths`` ((field, value)
    pairs) overriding the reduction's."""
    kw = dict(num_layers=2, **dict(widths))
    return REF_ARCHS[arch].reduced(**kw), ARCHS[arch].reduced(**kw)


@functools.lru_cache(maxsize=None)
def _reference(arch: str, dtype: str, s: int, max_len: int,
               widths: tuple = ()):
    """The reference's tree, prompt, greedy ids, prefill logits and caches,
    the teacher-forced logits of every step and the decode caches after
    them."""
    jdtype = DTYPES[dtype][0]
    ref_cfg, cfg = _cfgs(arch, widths)
    ref = RefServeEngine(ref_cfg, SMOKE_TOPO, max_len=max_len)
    tree = reference_tree(ref.prefill_model, 3, jdtype)
    params = jax.tree.map(jnp.asarray, tree)
    tokens = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, s)).astype(np.int32)
    ids = ref.generate(params, {"tokens": tokens}, STEPS)
    logits, caches = ref._prefill(params, {"tokens": jnp.asarray(tokens)})
    prefill = (np.asarray(logits, np.float32), _np(caches))
    if dtype == "float32":       # the reference's padding, kept float32
        caches = jax.tree.map(lambda c: jnp.pad(c, [(0, 0), (0, 0), (
            0, max_len - s), (0, 0), (0, 0)]), caches)
    else:
        caches = ref._pad_caches(caches, 2, s)
    steps = []
    for i in range(STEPS):
        logits, caches = ref._decode(params, caches, jnp.asarray(ids[:, i]),
                                     jnp.asarray(s + i, jnp.int32))
        steps.append(np.asarray(logits, np.float32))
    return tree, tokens, ids, prefill, steps, _np(caches)


def _np(caches) -> dict:
    return {name: {k: np.asarray(jnp.asarray(v, jnp.float32))
                   for k, v in entry.items()}
            for name, entry in caches.items()}


def _f32(caches) -> dict:
    return {name: {k: v.float().numpy() for k, v in entry.items()}
            for name, entry in caches.items()}


def teacher_forced_rank(group, cfg, dtype, full, tokens, ids, max_len):
    """One rank: its engine loaded with ``full``, the prefill (logits,
    whole caches), ``ids`` fed back step by step (the logits of each step,
    the rank's decode caches after them), then ``generate``'s greedy ids;
    numpy and CPU tensors, so that a process can return them."""
    topo = Topo(MeshConfig((1, group.size), ("data", "model")))
    eng = ServeEngine(cfg, max_len=max_len, device="cpu", dtype=dtype,
                      topo=topo, group=group)
    eng.load_params(full)
    s = tokens.shape[1]
    logits, caches = eng.model.prefill({"tokens": tokens})
    out = {"prefill": logits.numpy(), "caches": _f32(caches), "steps": []}
    if dtype == torch.float32:   # the rank's run, padded, kept float32
        start = eng.decode_model.cache_start(max_len)
        n = max_len if start is None else max_len // group.size
        start = start or 0
        caches = {name: {k: torch.nn.functional.pad(
            c[:, :, start:start + n],
            (0, 0, 0, 0, 0, n - c[:, :, start:start + n].shape[2]))
            for k, c in entry.items()} for name, entry in caches.items()}
    else:
        caches = eng._pad_caches(caches, tokens.shape[0])
    for i in range(ids.shape[1]):
        logits, caches = eng.decode_model.decode_step(
            caches, torch.from_numpy(ids[:, i]), s + i, cache_len=max_len)
        out["steps"].append(logits.numpy())
    out["decode_caches"] = _f32(caches)
    out["start"] = eng.decode_model.cache_start(max_len)
    out["ids"] = eng.generate({"tokens": tokens}, ids.shape[1])
    out["collectives"] = {k: dict(v) for k, v in group.counts.items()}
    return out


def _run_ranks(arch, dtype, tp, s, max_len, widths=()):
    tree, tokens, ids, *_ = _reference(arch, dtype, s, max_len, widths)
    _, cfg = _cfgs(arch, widths)
    return run_local(functools.partial(
        teacher_forced_rank, cfg=cfg, dtype=DTYPES[dtype][1], full=tree,
        tokens=tokens, ids=ids, max_len=max_len), tp)


def _check(arch, dtype, tp, s, max_len, widths=()):
    _, tokens, ids, (logits, caches), steps, dec_caches = _reference(
        arch, dtype, s, max_len, widths)
    ranks = _run_ranks(arch, dtype, tp, s, max_len, widths)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    vocab = ARCHS[arch].vocab_size
    for r in ranks[1:]:          # the ranks hold the same bits
        np.testing.assert_array_equal(r["prefill"], ranks[0]["prefill"])
        for a, b in zip(r["steps"], ranks[0]["steps"]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(r["ids"], ranks[0]["ids"])
    got = ranks[0]
    np.testing.assert_allclose(got["prefill"][:, :vocab],
                               logits[:, :vocab], **tol)
    for name, entry in caches.items():
        for key, want in entry.items():
            for r in ranks:                         # whole on every rank
                np.testing.assert_allclose(r["caches"][name][key], want,
                                           **tol)
    for i, want in enumerate(steps):
        np.testing.assert_allclose(got["steps"][i][:, :vocab],
                                   want[:, :vocab], err_msg=f"step {i}",
                                   **tol)
    sharded = got["start"] is not None
    assert sharded == (max_len % tp == 0)
    assert [r["start"] for r in ranks] == (
        [r * max_len // tp for r in range(tp)] if sharded else [None] * tp)
    for name, entry in dec_caches.items():
        for key, want in entry.items():
            whole = np.concatenate([r["decode_caches"][name][key]
                                    for r in ranks], axis=2) \
                if sharded else got["decode_caches"][name][key]
            assert whole.shape == want.shape
            np.testing.assert_allclose(whole, want, **tol)
    if dtype == "float32":
        np.testing.assert_array_equal(got["ids"], ids)
    return ranks


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["command-r-35b", "glm4-9b"])
def test_tp_serving_matches_the_unsharded_reference(arch, dtype, tp):
    """A 16-token prompt and 40 cache positions, both cut over the ranks:
    the residual stream is sequence-sharded in prefill, the caches in
    decode.  The collectives: per layer in prefill, two gathers of the
    residual, two of k and v over head_dim and two reduce-scatters (plus
    the embedding's); in decode one all-reduce of q, k, v, the softmax's
    max and sum and its values, the MLP's."""
    ranks = _check(arch, dtype, tp, 16, 40)
    calls = {k: v["calls"] for k, v in ranks[0]["collectives"].items()}
    layers = ARCHS[arch].reduced(num_layers=2).num_layers
    # two prefills and 2 x STEPS decode steps: teacher-forced, then
    # generate's
    assert calls["reduce_scatter"] == 2 * (1 + 2 * layers)
    assert calls["broadcast"] == 2             # the last row, each prefill
    assert calls["all_gather"] == 2 * (4 * layers + 1) + \
        2 * STEPS * (layers + 1)
    assert calls["all_reduce"] == 2 * STEPS * (1 + 5 * layers)


@pytest.mark.parametrize("s,max_len,tp", [(15, 40, 4), (16, 41, 2)])
def test_lengths_tp_does_not_divide_fall_back_to_replication(s, max_len,
                                                             tp):
    """A 15-token prompt at tp = 4 (the residual whole on every rank,
    all-reduced instead of reduce-scattered; the decode caches still cut)
    and 41 cache positions at tp = 2 (whole caches on every rank, each
    writing every token; the prompt still cut) match the reference."""
    ranks = _check("command-r-35b", "float32", tp, s, max_len)
    calls = ranks[0]["collectives"]
    assert (calls["reduce_scatter"]["calls"] == 0) == (s == 15)


def test_rank_kv_heads_pair_each_q_head_with_its_kv_head():
    """command-r's 64 / 8 at tp = 4: 16 q heads over KV heads 2r, 2r + 1;
    a rank whose heads share one KV head; phi3's 40 / 10 at tp = 4, whose
    10 q heads read KV heads 2, 2, 2... unevenly: one index a q head."""
    assert rank_kv_heads(64, 8, 4, 1) == slice(2, 4)
    assert rank_kv_heads(4, 2, 4, 3) == slice(1, 2)
    assert rank_kv_heads(40, 8, 4, 2) == slice(4, 6)
    idx = rank_kv_heads(40, 10, 4, 1)
    assert idx.tolist() == [h // 4 for h in range(10, 20)]


@pytest.mark.parametrize("widths", [
    (("num_heads", 6), ("num_kv_heads", 3)),
    (("d_model", 130), ("head_dim", 30), ("d_ff", 250))],
    ids=["uneven_kv_heads", "widths_tp_does_not_divide"])
def test_widths_match_the_reference(widths):
    """At tp = 2, 6 q heads over 3 KV heads: rank 0's heads 0, 1, 2 read KV
    heads 0, 0, 1, which no slice pairs by the kernel's own map, so the
    rank passes one KV head a q head.  At tp = 4, a d_model, head_dim and
    d_ff that 4 does not divide: decode's wq / wk / wv, prefill's wk / wv
    and the MLP's weights fall back to whole tensors on every rank (the
    reference's replication), whose products need no sum."""
    tp = 2 if dict(widths).get("num_heads") == 6 else 4
    ranks = _check("command-r-35b", "float32", tp, 16, 40, widths)
    if tp == 4:     # two prefills: the embedding's and wo's sums, no MLP's
        assert ranks[0]["collectives"]["reduce_scatter"]["calls"] == \
            2 * (1 + 2)


def test_groups_check_their_ranks_and_models_refuse_what_is_not_ported():
    """A group must match the mesh; every family builds over several ranks
    (MoE, MLA, SSM, hybrid, vlm and enc-dec models), and the dense and
    ssm families train over them, while data > 1, ``fsdp_sp`` attention
    (heads that tp does not divide) and the training of MoE, MLA, cross
    and enc-dec models raise ``NotImplementedError`` naming ROADMAP.md's
    queue 1; a model laid out over ranks but built without its group only
    describes the layout."""
    from repro_torch.models.model_zoo import build_model
    topo = Topo(MeshConfig((1, 2), ("data", "model")))
    g = LocalGroup.make(2)[0]
    cfg = ARCHS["command-r-35b"].reduced(num_layers=1)
    with pytest.raises(ValueError, match="a group of 2 ranks"):
        build_model(cfg, Topo(MeshConfig((1, 4), ("data", "model"))),
                    "prefill", device="cpu", group=g)
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1"):
        build_model(cfg, Topo(MeshConfig((2, 2), ("data", "model"))),
                    "prefill", device="cpu", group=g)
    with pytest.raises(NotImplementedError, match="fsdp_sp over ranks"):
        build_model(ARCHS["command-r-35b"].reduced(num_heads=3), topo,
                    "prefill", device="meta", group=g)
    batch = {"tokens": np.zeros((1, 4), np.int32),
             "labels": np.zeros((1, 4), np.int32),
             "frames": np.zeros((1, 4, 128), np.float32)}
    for arch in ("granite-moe-3b-a800m", "falcon-mamba-7b",
                 "jamba-1.5-large-398b", "deepseek-v2-236b",
                 "llama-3.2-vision-11b", "whisper-medium"):
        for kind in ("prefill", "decode"):
            model = build_model(ARCHS[arch].reduced(), topo, kind,
                                device="meta", group=g)
            assert model.group is g
        if arch == "falcon-mamba-7b":
            continue
        with pytest.raises(NotImplementedError,
                           match="sharded training.*ROADMAP.md queue 1"):
            model.loss(batch)
    # the dense and ssm families train over the ranks: one loss on all
    def trains(grp, arch):
        model = build_model(ARCHS[arch].reduced(num_layers=1), topo,
                            "train", device="cpu", group=grp)
        model.init_params(torch.Generator().manual_seed(0))
        return float(model.loss(batch)[0].detach())

    for arch in ("command-r-35b", "falcon-mamba-7b"):
        losses = run_local(lambda grp: trains(grp, arch), 2)
        assert np.isfinite(losses[0]) and losses[0] == losses[1], arch
    whole = build_model(cfg, topo, "prefill", device="cpu")
    with pytest.raises(ValueError, match="group of one rank"):
        whole.prefill({"tokens": np.zeros((1, 4), np.int32)})
    one = build_model(cfg, Topo(MeshConfig((1, 1), ("data", "model"))),
                      "prefill", device="cpu", group=LocalGroup.make(1)[0])
    assert one.group is None


def test_sampling_draws_on_rank_zero_and_broadcasts():
    """greedy=False: rank 0 draws from its generator, the others take its
    ids; a rank other than 0 needs no generator."""
    _, cfg = _cfgs("command-r-35b")
    topo = Topo(MeshConfig((1, 2), ("data", "model")))
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 8)).astype(np.int32)

    def rank(g):
        eng = ServeEngine(cfg, max_len=16, device="cpu", topo=topo, group=g)
        eng.init_params(0)
        gen = torch.Generator().manual_seed(5) if g.rank == 0 else None
        return eng.generate({"tokens": tokens}, 4, greedy=False,
                            generator=gen)

    a, b = run_local(rank, 2)
    np.testing.assert_array_equal(a, b)
    one = ServeEngine(cfg, max_len=16, device="cpu")
    one.init_params(0)
    with pytest.raises(ValueError, match="requires a generator"):
        one.generate({"tokens": tokens}, 1, greedy=False)
