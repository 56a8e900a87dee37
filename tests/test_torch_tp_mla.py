"""Tensor-parallel MLA serving (``Topo`` over a (1, tp) mesh) against the
reference's unsharded engine.

A reduced deepseek-v2-236b (MLA, MoE with a shared expert: 4 heads, a
latent of 32 + 16 rope dims, ``w_kvb``'s last dim 32 k_nope + 32 value
columns) gets the reference's numpy parameters
(``test_torch_moe_models.moe_tree``), cut into each rank's blocks by
``convert.rank_state_dict``; the ranks are ``LocalGroup`` threads.  In
prefill (``megatron``) a rank holds its heads of ``wq``, ``w_kvb`` and
``wo`` and the whole ``w_kva``, so every rank computes the whole latent
(the caches); in decode (``decode_rp``) ``wq`` and ``w_kva`` are cut over
d_model and ``w_kvb`` over its last dim: at tp = 2 rank 0 holds every
k_nope column and rank 1 every value column, at tp = 4 ranks 0-1 hold
k_nope columns only and ranks 2-3 value columns only.

Prefill logits, the whole caches on every rank, 8 teacher-forced decode
steps and the decode caches (put back together from the ranks' runs) are
held to the reference at 1e-4 in float32 (over float32 decode caches, as
``test_torch_tp_serve`` explains) and ``BF16_TOL`` in bfloat16; greedy ids
are equal in float32.  ``check`` and ``reference`` serve
``test_torch_tp_cross`` too.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.models.attention import MLAttention as RefMLA
from repro.models.common import SMOKE_TOPO
from repro.serve import ServeEngine as RefServeEngine
from repro_torch.configs import ARCHS
from repro_torch.launch.mesh import tp_mesh
from repro_torch.models.attention import MLAttention
from repro_torch.models.common import Topo
from repro_torch.models.convert import to_tensor
from repro_torch.models.model_zoo import build_model
from repro_torch.models.parallel import LocalGroup, run_local
from repro_torch.serve import ServeEngine
from test_torch_models import BF16_TOL, DTYPES, F32_TOL
from test_torch_moe_models import moe_tree
from test_torch_tp_serve import STEPS, _f32, _np

DEEPSEEK = "deepseek-v2-236b"
PROMPT, MAX_LEN = 16, 40


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small tensor ops on several rank threads: one intra-op thread
    each keeps the suite's parallel workers from oversubscribing the
    cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def cfgs(arch: str, widths: tuple = ()):
    """The reduced config of both packages, ``widths`` ((field, value)
    pairs) overriding the reduction's."""
    kw = dict(widths)
    return REF_ARCHS[arch].reduced(**kw), ARCHS[arch].reduced(**kw)


def _jax(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _memory_len(batch: dict) -> int | None:
    return batch["frames"].shape[1] if "frames" in batch else None


def _pad_f32(caches, structs) -> dict:
    """The reference's prefill caches padded to the decode caches'
    lengths (a cross cache's is its own), kept float32."""
    return {name: {k: jnp.pad(c, [(0, a - b) for a, b in zip(
        structs[name][k].shape, c.shape)]) for k, c in entry.items()}
        for name, entry in caches.items()}


@functools.lru_cache(maxsize=None)
def reference(arch: str, dtype: str, tree_fn, batch_fn, widths: tuple = ()):
    """The reference on one device: its tree, the batch, greedy ids,
    prefill logits and caches, the teacher-forced logits of every step and
    the decode caches after them."""
    ref_cfg, cfg = cfgs(arch, widths)
    ref = RefServeEngine(ref_cfg, SMOKE_TOPO, max_len=MAX_LEN)
    tree = tree_fn(ref.prefill_model, 3, DTYPES[dtype][0])
    params = jax.tree.map(jnp.asarray, tree)
    batch = batch_fn(cfg)
    b, s = batch["tokens"].shape
    ids = ref.generate(params, _jax(batch), STEPS)
    logits, caches = ref._prefill(params, _jax(batch))
    prefill = (np.asarray(logits, np.float32), _np(caches))
    mem = _memory_len(batch)
    if dtype == "float32":
        kw = {"memory_len": mem} if mem is not None else {}
        caches = _pad_f32(caches, ref.decode_model.cache_shape_structs(
            b, MAX_LEN, **kw))
    else:
        caches = ref._pad_caches(caches, b, s, memory_len=mem)
    steps = []
    for i in range(STEPS):
        logits, caches = ref._decode(params, caches, jnp.asarray(ids[:, i]),
                                     jnp.asarray(s + i, jnp.int32))
        steps.append(np.asarray(logits, np.float32))
    return tree, batch, ids, prefill, steps, _np(caches)


def float32_caches(model) -> None:
    """``model``'s decode caches laid out in float32 (the engine's runs and
    padding, another dtype)."""
    structs = model.cache_shape_structs

    def f32(*args, **kw):
        return {name: {key: (shape, torch.float32)
                       for key, (shape, _) in entry.items()}
                for name, entry in structs(*args, **kw).items()}
    model.cache_shape_structs = f32


def serve_rank(group, cfg, dtype, full, batch, ids) -> dict:
    """One rank: its engine loaded with ``full``, the prefill (logits,
    whole caches), ``ids`` fed back step by step (the logits of each step,
    the rank's decode caches after them, the calls of each collective a
    step), then ``generate``'s greedy ids."""
    eng = ServeEngine(cfg, max_len=MAX_LEN, device="cpu", dtype=dtype,
                      topo=Topo(tp_mesh(group.size)), group=group)
    eng.load_params(full)
    b, s = batch["tokens"].shape
    mem = _memory_len(batch)
    logits, caches = eng.model.prefill(batch)
    out = {"prefill": logits.numpy(), "caches": _f32(caches), "steps": []}
    if dtype == torch.float32:
        float32_caches(eng.decode_model)
    caches = eng._pad_caches(caches, b, memory_len=mem)
    if dtype == torch.float32:
        del eng.decode_model.cache_shape_structs
    kw = {"cache_len": MAX_LEN}
    if mem is not None:
        kw["memory_len"] = mem
    group.reset_counts()
    for i in range(ids.shape[1]):
        logits, caches = eng.decode_model.decode_step(
            caches, torch.from_numpy(ids[:, i]), s + i, **kw)
        out["steps"].append(logits.numpy())
    out["decode_calls"] = {k: v["calls"] // ids.shape[1]
                           for k, v in group.counts.items()}
    out["decode_caches"] = _f32(caches)
    out["ids"] = eng.generate(batch, ids.shape[1])
    return out


def check(arch, dtype, tp, tree_fn, batch_fn, widths=()) -> list:
    """Every rank against the reference: the same bits on every rank,
    prefill logits, the whole caches, the teacher-forced steps, the decode
    caches (a rank's run along the sequence where tp divides the cache's
    length, else whole), and in float32 the greedy ids."""
    tree, batch, ids, (logits, caches), steps, dec = reference(
        arch, dtype, tree_fn, batch_fn, widths)
    _, cfg = cfgs(arch, widths)
    ranks = run_local(functools.partial(
        serve_rank, cfg=cfg, dtype=DTYPES[dtype][1], full=tree,
        batch=batch, ids=ids), tp)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    vocab = cfg.vocab_size
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["prefill"], ranks[0]["prefill"])
        for a, b in zip(r["steps"], ranks[0]["steps"]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(r["ids"], ranks[0]["ids"])
    got = ranks[0]
    np.testing.assert_allclose(got["prefill"][:, :vocab], logits[:, :vocab],
                               **tol)
    for name, entry in caches.items():
        for key, want in entry.items():
            for r in ranks:
                np.testing.assert_allclose(r["caches"][name][key], want,
                                           err_msg=f"{name} {key}", **tol)
    for i, want in enumerate(steps):
        np.testing.assert_allclose(got["steps"][i][:, :vocab],
                                   want[:, :vocab], err_msg=f"step {i}",
                                   **tol)
    for name, entry in dec.items():
        for key, want in entry.items():
            parts = [r["decode_caches"][name][key] for r in ranks]
            whole = np.concatenate(parts, axis=2) \
                if want.shape[2] % tp == 0 else parts[0]
            assert whole.shape == want.shape, (name, key)
            np.testing.assert_allclose(whole, want, err_msg=f"{name} {key}",
                                       **tol)
    if dtype == "float32":
        np.testing.assert_array_equal(got["ids"], ids)
    return ranks


def deepseek_batch(cfg) -> dict:
    return {"tokens": np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, PROMPT)).astype(np.int32)}


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tp_mla_serving_matches_the_unsharded_reference(dtype, tp):
    """A 16-token prompt and 40 cache positions, both cut over the ranks;
    the MoE blocks take ``ep`` experts in prefill and ``ep_decode``'s d_ff
    in decode.  A decode step's MLA layer makes five all-reduces (q and
    the latent's partials, q_eff's, the softmax's max and sum, the latent
    output) and two gathers (the value columns, the output's d)."""
    ranks = check(DEEPSEEK, dtype, tp, moe_tree, deepseek_batch)
    layers = cfgs(DEEPSEEK)[1].num_layers
    # a step: the embedding's sum, per layer the MLA's five and the
    # ``ep_decode`` MoE's two (its routed and shared experts' partials);
    # the logits' gather and the MLA's two
    assert ranks[0]["decode_calls"] == {
        "all_reduce": 1 + 7 * layers, "all_gather": 1 + 2 * layers,
        "reduce_scatter": 0, "broadcast": 0}


@pytest.mark.parametrize("tp", [2, 4])
def test_decode_w_kvb_blocks_hold_k_only_or_value_only_columns(tp):
    """``decode_rp`` cuts ``w_kvb`` (lora, H, 32 k_nope + 32 value
    columns) on its last dim: at tp = 2 rank 0 holds the k_nope columns
    and rank 1 the value columns, at tp = 4 ranks 0-1 a half of the k_nope
    columns each and ranks 2-3 a half of the value columns; ``megatron``
    cuts it over the heads.  ``wq`` and ``w_kva`` are cut over d_model in
    decode, ``w_kva`` whole in prefill."""
    _, cfg = cfgs(DEEPSEEK)
    nope, dv, n = cfg.mla_qk_nope, cfg.mla_v_dim, (32 + 32) // tp
    assert (nope, dv) == (32, 32)
    topo = Topo(tp_mesh(tp))
    for r, g in enumerate(LocalGroup.make(tp)):
        dec = build_model(cfg, topo, "decode", device="meta", group=g)
        pre = build_model(cfg, topo, "prefill", device="meta", group=g)
        mla = dec.layers[0]["l0_mla"].core
        cols = mla.block("w_kvb")[2]
        assert cols == slice(r * n, (r + 1) * n)
        assert tuple(mla.w_kvb.shape) == (cfg.kv_lora_rank, cfg.num_heads, n)
        k_only, v_only = cols.stop <= nope, cols.start >= nope
        assert (k_only, v_only) == (r < tp // 2, r >= tp // 2)
        rows = slice(r * cfg.d_model // tp, (r + 1) * cfg.d_model // tp)
        assert mla.block("wq")[0] == rows and mla.block("w_kva")[0] == rows
        assert mla.block("wo")[2] == rows and not mla.split("kv_norm")
        p = pre.layers[0]["l0_mla"].core
        heads = slice(r * cfg.num_heads // tp, (r + 1) * cfg.num_heads // tp)
        assert p.block("w_kvb")[1] == heads and p.block("wq")[1] == heads
        assert p.block("wo")[0] == heads and not p.split("w_kva")


@pytest.mark.parametrize("sharded", [True, False], ids=["seq_cut", "whole"])
def test_mla_decode_on_ranks_matches_the_reference_block(sharded):
    """One ``decode_rp`` MLA block at tp = 4 on a 12-position latent cache
    (the ranks' runs of 3, or the whole cache on every rank) against the
    reference's ``MLAttention.decode`` in float32: the output and the
    written row.  On the sequence-sharded cache the rank that holds
    position t writes it, the others leave their runs."""
    rng = np.random.default_rng(7)
    b, d, H, lora, nope, rope, dv, S, t = 2, 64, 4, 16, 8, 8, 8, 12, 7
    args = ("a", d, H, lora, nope, rope, dv, "decode_rp")
    ref = RefMLA(*args)
    shapes = {"wq": (d, H, nope + rope), "w_kva": (d, lora + rope),
              "kv_norm": (lora,), "w_kvb": (lora, H, nope + dv),
              "wo": (H, dv, d)}
    params = {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
              for k, s in shapes.items()}
    params["kv_norm"] = 1.0 + params["kv_norm"]
    x = rng.standard_normal((b, d)).astype(np.float32)
    c = rng.standard_normal((b, S, lora)).astype(np.float32)
    kr = rng.standard_normal((b, S, rope)).astype(np.float32)
    want, (c_r, kr_r) = ref.decode({k: jnp.asarray(v) for k, v in
                                    params.items()}, jnp.asarray(x),
                                   jnp.int32(t), jnp.asarray(c),
                                   jnp.asarray(kr), SMOKE_TOPO)
    topo = Topo(tp_mesh(4))

    def rank(g):
        m = MLAttention(*args, device="cpu", dtype=torch.float32, topo=topo,
                        group=g)
        m.load_state_dict({k: to_tensor(v)[m.block(k)]
                           for k, v in params.items()})
        run = slice(g.rank * 3, g.rank * 3 + 3) if sharded else slice(0, S)
        cc, kk = to_tensor(c)[:, run].clone(), to_tensor(kr)[:, run].clone()
        out, _ = m.decode(torch.from_numpy(x), t, cc, kk,
                          g.rank * 3 if sharded else None)
        return out, cc, kk, dict(g.counts)

    ranks = run_local(rank, 4)
    for out, *_ in ranks:
        np.testing.assert_allclose(out.numpy(), np.asarray(want), **F32_TOL)
    parts = [(cc, kk) for _, cc, kk, _ in ranks]
    got_c = torch.cat([p[0] for p in parts], 1) if sharded else parts[0][0]
    got_k = torch.cat([p[1] for p in parts], 1) if sharded else parts[0][1]
    np.testing.assert_allclose(got_c.numpy(), np.asarray(c_r), **F32_TOL)
    np.testing.assert_allclose(got_k.numpy(), np.asarray(kr_r), **F32_TOL)
    calls = {k: v["calls"] for k, v in ranks[0][3].items()}
    assert calls == {"all_reduce": 5 if sharded else 2, "all_gather": 2,
                     "reduce_scatter": 0, "broadcast": 0}


def test_the_launcher_serves_deepseek_over_threads_as_on_one_device(
        capsys, monkeypatch):
    """``launch.serve --arch deepseek-v2-236b --smoke --tp 2 --group local
    --device cpu`` prints the ids of ``--tp 1``; ``check_fits`` refuses the
    whole model over 4 ranks on an 80 GB card, naming a rank's bytes."""
    from repro_torch.launch import serve

    def run(*extra):
        monkeypatch.setattr("sys.argv", [
            "serve", "--arch", DEEPSEEK, "--smoke", "--device", "cpu",
            "--tokens", "4", *extra])
        serve.main()
        out = capsys.readouterr().out
        return out[:out.index("prefill_tokens")]

    assert run("--tp", "2", "--group", "local") == run()
    rank = serve.rank_weight_bytes(ARCHS[DEEPSEEK], 4)
    monkeypatch.setattr(serve, "device_memory_bytes", lambda dev: 80 * 10**9)
    with pytest.raises(ValueError, match=f"{rank / 1e9:.1f} GB a rank of 4"):
        serve.check_fits(ARCHS[DEEPSEEK], torch.device("cuda", 0), 4)
