"""Tensor-parallel MoE, SSM and hybrid serving (``Topo`` over a (1, tp)
mesh) against the reference.

Reduced granite-moe-3b-a800m (4 experts, top 2), falcon-mamba-7b and
jamba-1.5-large-398b (layer 0 Mamba + MLP, layer 1 attention + MoE) get
the reference's numpy parameters (``test_torch_moe_models.moe_tree``: each
weight drawn at the scale of its own fan-in, an expert's too),
cut into each rank's blocks by ``convert.rank_state_dict``; the ranks are
``LocalGroup`` threads.  Prefill logits, every cache (a Mamba layer's
state and conv window put back together from the ranks' channels) and 8
teacher-forced decode steps are held to the reference's unsharded
``ServeEngine`` at 1e-4 in float32 (over float32 decode caches, as
``test_torch_tp_serve`` explains) and ``BF16_TOL`` in bfloat16; greedy ids
are equal in float32.  tp divides the reduced models' 4 experts, so their
MoE blocks take ``ep`` in prefill and ``ep_decode`` in decode.

``gathered`` / ``tp_decode`` (granite with 6 experts at tp = 4, with and
without a shared expert) are held to the reference built on an inactive
(1, 4) ``Topo``: ``gathered`` groups a quarter of the tokens where one
device groups all of them, so its routing, and what it drops, follow the
mesh.  Every rank's ``Route`` is the same, bit for bit.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs.base import MeshConfig as RefMeshConfig
from repro.models.common import SMOKE_TOPO
from repro.models.common import Topo as RefTopo
from repro.serve import ServeEngine as RefServeEngine
from repro_torch.configs import ARCHS
from repro_torch.configs.base import MeshConfig
from repro_torch.models.common import ONE_DEVICE, Topo
from repro_torch.models.model_zoo import build_model
from repro_torch.models.moe import MoE
from repro_torch.models.parallel import LocalGroup, run_local
from repro_torch.models.ssm import MambaBlock
from repro_torch.serve import ServeEngine
from test_torch_models import BF16_TOL, DTYPES, F32_TOL
from test_torch_moe_models import moe_tree
from test_torch_tp_serve import STEPS, _f32, _np

GRANITE, MAMBA, JAMBA = ("granite-moe-3b-a800m", "falcon-mamba-7b",
                         "jamba-1.5-large-398b")
PROMPT, MAX_LEN = 16, 40
SEQ_AXIS = {"k": 2, "v": 2}                  # sequence-sharded caches
CHANNEL_AXIS = {"state": 2, "conv": 3}       # channel-sharded caches
GATHERED = (("moe_num_experts", 6),)


def _cfgs(arch: str, widths: tuple = ()):
    kw = dict(num_layers=2, **dict(widths))
    return REF_ARCHS[arch].reduced(**kw), ARCHS[arch].reduced(**kw)


def _pad_kv(caches: dict, s: int) -> dict:
    """float32 decode caches: k and v padded along the sequence to
    ``MAX_LEN``, the Mamba caches as they are."""
    return {name: {key: jnp.pad(c, [(0, 0), (0, 0), (0, MAX_LEN - s)]
                                + [(0, 0)] * (c.ndim - 3))
                   if key in SEQ_AXIS else c for key, c in entry.items()}
            for name, entry in caches.items()}


@functools.lru_cache(maxsize=None)
def _reference(arch: str, dtype: str, mesh_tp: int = 1, widths: tuple = ()):
    """The reference on one device (``mesh_tp`` 1) or on an inactive
    (1, mesh_tp) mesh: its tree, prompt, greedy ids, prefill logits and
    caches, the teacher-forced logits of every step and the decode caches
    after them."""
    ref_cfg, cfg = _cfgs(arch, widths)
    topo = SMOKE_TOPO if mesh_tp == 1 else RefTopo(
        RefMeshConfig((1, mesh_tp), ("data", "model")), active=False)
    ref = RefServeEngine(ref_cfg, topo, max_len=MAX_LEN)
    tree = moe_tree(ref.prefill_model, 3, DTYPES[dtype][0])
    params = jax.tree.map(jnp.asarray, tree)
    tokens = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, PROMPT)).astype(np.int32)
    ids = ref.generate(params, {"tokens": tokens}, STEPS)
    logits, caches = ref._prefill(params, {"tokens": jnp.asarray(tokens)})
    # copies: the decode steps below may reuse the Mamba caches' buffers
    prefill = (np.asarray(logits, np.float32),
               {name: {k: v.copy() for k, v in entry.items()}
                for name, entry in _np(caches).items()})
    caches = _pad_kv(caches, PROMPT) if dtype == "float32" \
        else ref._pad_caches(caches, 2, PROMPT)
    steps = []
    for i in range(STEPS):
        logits, caches = ref._decode(params, caches, jnp.asarray(ids[:, i]),
                                     jnp.asarray(PROMPT + i, jnp.int32))
        steps.append(np.asarray(logits, np.float32))
    return tree, tokens, ids, prefill, steps, _np(caches)


def record_routes(model, routes: list) -> None:
    """Wrap each MoE block's ``_route`` to keep what it returns in
    ``routes``."""
    for m in model.modules():
        if isinstance(m, MoE):
            def route(xg, _orig=m._route):
                r = _orig(xg)
                routes.append(tuple(t.numpy().copy() for t in r))
                return r
            m._route = route


def moe_rank(group, cfg, dtype, full, tokens, ids) -> dict:
    """One rank: its engine loaded with ``full``, the prefill, ``ids`` fed
    back step by step, then ``generate``; every MoE routing it made, and
    its MoE blocks' placements and token groups."""
    topo = Topo(MeshConfig((1, group.size), ("data", "model")))
    eng = ServeEngine(cfg, max_len=MAX_LEN, device="cpu", dtype=dtype,
                      topo=topo, group=group)
    eng.load_params(full)
    routes = []
    record_routes(eng.model, routes)
    record_routes(eng.decode_model, routes)
    s = tokens.shape[1]
    logits, caches = eng.model.prefill({"tokens": tokens})
    out = {"prefill": logits.numpy(), "caches": _f32(caches), "steps": []}
    start = eng.decode_model.cache_start(MAX_LEN)
    # the rank's run of k and v, kept float32; copies of the Mamba caches,
    # which decode updates in place (``out["caches"]`` views them)
    if dtype == torch.float32:
        n = MAX_LEN // group.size
        caches = {name: {k: torch.nn.functional.pad(
            c[:, :, start:start + n],
            (0, 0, 0, 0, 0, n - c[:, :, start:start + n].shape[2]))
            if k in SEQ_AXIS else c.clone() for k, c in entry.items()}
            for name, entry in caches.items()}
    else:
        caches = eng._pad_caches(caches, tokens.shape[0])
    for i in range(ids.shape[1]):
        logits, caches = eng.decode_model.decode_step(
            caches, torch.from_numpy(ids[:, i]), s + i, cache_len=MAX_LEN)
        out["steps"].append(logits.numpy())
    out["decode_caches"] = _f32(caches)
    out["start"] = start
    out["ids"] = eng.generate({"tokens": tokens}, ids.shape[1])
    out["routes"] = routes
    # each block's placement and its token groups: the prompt's tokens in
    # prefill, the batch's in decode
    out["moe"] = [(m.placement, m.group(n))
                  for model, n in ((eng.model, tokens.size),
                                   (eng.decode_model, tokens.shape[0]))
                  for m in model.modules() if isinstance(m, MoE)]
    return out


def _check(arch, dtype, tp, mesh_tp=1, widths=()):
    tree, tokens, ids, (logits, caches), steps, dec_caches = _reference(
        arch, dtype, mesh_tp, widths)
    _, cfg = _cfgs(arch, widths)
    ranks = run_local(functools.partial(
        moe_rank, cfg=cfg, dtype=DTYPES[dtype][1], full=tree, tokens=tokens,
        ids=ids), tp)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    vocab = cfg.vocab_size
    for r in ranks[1:]:          # the ranks hold the same bits
        np.testing.assert_array_equal(r["prefill"], ranks[0]["prefill"])
        for a, b in zip(r["steps"], ranks[0]["steps"]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(r["ids"], ranks[0]["ids"])
        assert len(r["routes"]) == len(ranks[0]["routes"])
        for a, b in zip(r["routes"], ranks[0]["routes"]):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
    got = ranks[0]
    np.testing.assert_allclose(got["prefill"][:, :vocab],
                               logits[:, :vocab], **tol)

    def whole(per_rank: list, key: str, sharded: bool) -> np.ndarray:
        if key in CHANNEL_AXIS:
            return np.concatenate(per_rank, axis=CHANNEL_AXIS[key])
        return np.concatenate(per_rank, axis=SEQ_AXIS[key]) if sharded \
            else per_rank[0]

    for name, entry in caches.items():
        for key, want in entry.items():
            if key in SEQ_AXIS:                      # whole on every rank
                for r in ranks:
                    np.testing.assert_allclose(r["caches"][name][key], want,
                                               **tol)
            else:
                np.testing.assert_allclose(whole(
                    [r["caches"][name][key] for r in ranks], key, False),
                    want, err_msg=f"{name} {key}", **tol)
    for i, want in enumerate(steps):
        np.testing.assert_allclose(got["steps"][i][:, :vocab],
                                   want[:, :vocab], err_msg=f"step {i}",
                                   **tol)
    sharded = got["start"] is not None
    assert sharded
    for name, entry in dec_caches.items():
        for key, want in entry.items():
            w = whole([r["decode_caches"][name][key] for r in ranks], key,
                      sharded)
            assert w.shape == want.shape, (name, key)
            np.testing.assert_allclose(w, want, err_msg=f"{name} {key}",
                                       **tol)
    if dtype == "float32":
        np.testing.assert_array_equal(got["ids"], ids)
    return ranks


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", [GRANITE, MAMBA, JAMBA])
def test_tp_serving_matches_the_unsharded_reference(arch, dtype, tp):
    """A 16-token prompt and 40 cache positions, both cut over the ranks;
    the MoE blocks take ``ep`` experts in prefill and ``ep_decode``'s d_ff
    columns in decode, both routing every token on every rank."""
    ranks = _check(arch, dtype, tp)
    moe = ranks[0]["moe"]
    assert bool(moe) == (arch != MAMBA)
    assert moe == [("ep", 16)] * (len(moe) // 2) + \
        [("ep_decode", 2)] * (len(moe) // 2)
    if arch != MAMBA:        # prefill and 8 + 8 decode steps, then generate
        assert len(ranks[0]["routes"]) == \
            2 * (1 + STEPS) * sum(ARCHS[arch].reduced(num_layers=2)
                                  .is_moe_layer(j) for j in range(2))


@pytest.mark.parametrize("widths", [GATHERED,
                                    GATHERED + (("moe_num_shared", 1),)],
                         ids=["gathered", "gathered_shared"])
def test_gathered_and_tp_decode_match_the_reference_on_the_same_mesh(widths):
    """6 experts over 4 ranks: ``gathered`` in prefill, ``tp_decode`` in
    decode, every expert's d_ff columns on every rank.  ``gathered``'s token
    groups are a quarter of the prompt's 32 tokens (one device's are 16),
    as the reference's on the inactive (1, 4) mesh, whose ids these equal;
    decode's groups are the whole batch either way."""
    ranks = _check(GRANITE, "float32", 4, mesh_tp=4, widths=widths)
    _, cfg = _cfgs(GRANITE, widths)
    one = build_model(cfg, ONE_DEVICE, "prefill", device="meta")
    one_moe = next(m for m in one.modules() if isinstance(m, MoE))
    assert one_moe.placement == "ep" and one_moe.group(32) == 16
    assert ranks[0]["moe"] == [("gathered", 8)] * 2 + [("tp_decode", 2)] * 2


def _blocks_by_rank(arch: str, tp: int, kind: str):
    cfg = ARCHS[arch].reduced(num_layers=2)
    topo = Topo(MeshConfig((1, tp), ("data", "model")))
    groups = LocalGroup.make(tp)
    models = [build_model(cfg, topo, kind, device="meta", group=g)
              for g in groups]
    return models, [m.blocks() for m in models]


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_blocks_tile_every_tensor_and_w_in_holds_a_ranks_channels(kind, tp):
    """Every parameter of the reduced granite, falcon-mamba and jamba: the
    ranks' blocks cover each element once (cut) or each rank holds it
    whole.  A Mamba block's ``w_in`` holds the x and the z columns of the
    rank's own channels, those of its ``conv_b``, ``D`` and ``A_log``."""
    for arch in (GRANITE, MAMBA, JAMBA):
        models, blocks = _blocks_by_rank(arch, tp, kind)
        defs = models[0].param_defs().defs
        for name, d in defs.items():
            count = np.zeros(d.shape, np.int64)
            for b in blocks:
                count[b[name]] += 1
            assert (count == 1).all() or (count == tp).all(), (arch, name)
            for m, b in zip(models, blocks):
                got = dict(m.named_parameters())[name].shape
                assert tuple(got) == count[b[name]].shape, (arch, name)
        for r, m in enumerate(models):
            for mod in m.modules():
                if not isinstance(mod, MambaBlock):
                    continue
                di, n = mod.d_inner, mod.d_inner // tp
                ch = list(range(r * n, (r + 1) * n))
                assert mod.block("conv_b") == (slice(r * n, (r + 1) * n),)
                assert mod.block("A_log")[0] == slice(r * n, (r + 1) * n)
                assert mod.block("w_in")[1] == ch + [di + c for c in ch]
                assert tuple(mod.w_in.shape) == (mod.d_model, 2 * n)
                assert mod.split("w_x") and mod.split("w_out")


def test_ssm_and_moe_blocks_share_what_both_layouts_cut_alike():
    """The engine's decode model shares the prefill model's Mamba, MLP and
    router blocks, and holds its own expert blocks: ``ep`` cuts the
    experts, ``ep_decode`` their d_ff."""
    cfg = ARCHS[JAMBA].reduced(num_layers=2)
    topo = Topo(MeshConfig((1, 2), ("data", "model")))
    eng = ServeEngine(cfg, max_len=8, device="meta", topo=topo,
                      group=LocalGroup.make(2)[1])
    pre = dict(eng.model.named_parameters())
    for name, p in eng.decode_model.named_parameters():
        if "_attn." in name:        # megatron against decode_rp blocks
            continue
        expert = name.rsplit(".", 1)[-1] in ("w_gate", "w_up", "w_down") \
            and "_moe." in name
        assert (p is pre[name]) != expert, name
    moe = eng.model.layers[0]["l1_moe"].core
    assert moe.block("w_gate")[0] == slice(2, 4)
    assert tuple(moe.w_gate.shape) == (2, cfg.d_model, cfg.moe_d_ff)
    dec = eng.decode_model.layers[0]["l1_moe"].core
    assert tuple(dec.w_gate.shape) == (4, cfg.d_model, cfg.moe_d_ff // 2)


def test_the_launcher_serves_jamba_over_threads_as_on_one_device(
        capsys, monkeypatch):
    """``launch.serve --arch jamba-1.5-large-398b --smoke --tp 2 --group
    local --device cpu`` prints the ids of ``--tp 1``; ``check_fits``
    refuses the whole model over 4 ranks (374 GB of weights a rank)."""
    from repro_torch.launch import serve

    def run(*extra):
        monkeypatch.setattr("sys.argv", [
            "serve", "--arch", JAMBA, "--smoke", "--device", "cpu",
            "--tokens", "4", *extra])
        serve.main()
        out = capsys.readouterr().out
        return out[:out.index("prefill_tokens")]

    assert run("--tp", "2", "--group", "local") == run()
    with pytest.raises(ValueError, match="do not fit"):
        serve.check_fits(ARCHS[JAMBA], torch.device("cpu"), 4,
                         ranks_per_device=10**3)


@pytest.mark.parametrize("placement,tokens,tp", [
    ("ep_decode", 4, 2), ("ep_decode", 4, 4), ("gathered", 32, 4)])
def test_d_ff_cut_experts_round_each_row_as_one_device_does(placement,
                                                           tokens, tp):
    """bfloat16 experts large enough that an expert's output row (up to
    ~77) has a bfloat16 ulp of 0.25-0.5: the unsharded block rounds each
    expert's row before the combine, so the d_ff-cut ranks sum each row's
    float32 partials over the ranks and round it before theirs.  The
    ranks' output equals one device's bit for bit (one device on the same
    mesh, whose token groups ``gathered`` follows; ``gathered``'s input
    and output are the rank's run of the sequence).  Rounding only the
    combined sum left 45 of 256 decode elements 0.25 apart."""
    d, E, k, f = 64, 8, 2, 128
    topo = Topo(MeshConfig((1, tp), ("data", "model")))
    kw = dict(num_shared=1, group_size=16, placement=placement,
              device="cpu")
    one = MoE("m", d, E, k, f, topo=topo, **kw)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in one.named_parameters():
            p.copy_(torch.randn(p.shape, generator=g)
                    * (0.3 if name.startswith("w") else 0.2))
    x = torch.randn(2, tokens // 2, d, generator=g).bfloat16()
    want = one(x)[0]
    full = dict(one.named_parameters())
    seq = placement == "gathered"
    n = tokens // 2 // tp

    def rank(group):
        m = MoE("m", d, E, k, f, topo=topo, group=group, **kw)
        m.load_state_dict({name: full[name][m.block(name)]
                           for name in full})
        xr = x.narrow(1, group.rank * n, n) if seq else x
        return m(xr, seq_sharded=seq)[0]

    outs = run_local(rank, tp)
    got = torch.cat(outs, 1) if seq else outs[0]
    assert torch.equal(got, want)
    for o in outs[1:]:
        assert seq or torch.equal(o, outs[0])
