"""The port's MoE, MLA and hybrid models against the reference.

granite-moe-3b-a800m (GQA attention + MoE), deepseek-v2-236b (MLA + MoE
with shared experts) and jamba-1.5-large-398b (Mamba and attention layers,
MoE on every other layer) at their reduced configurations get the same
numpy parameters in both packages (``moe_tree``, carried with
``models.convert.params_from_jax``) and the same prompts.

Tolerances: float32 parameters, prefill logits, caches and 8 teacher-forced
decode logits within 1e-4 (float32 in another order; the decode runs on
float32 caches in both packages, since a bfloat16 cache value on a rounding
edge may round either way), and greedy tokens equal; at every step the
reference's top-2 logit gap exceeds the two packages' largest logit
difference, so the equality does not hang on a near tie.

bfloat16 parameters: rtol 2e-2 + atol 5e-2 (``test_torch_models``'s: the
reference's jnp attention rounds ``q * scale`` and the softmax weights to
bfloat16, the port's flash kernel keeps them in float32).  The router
inputs then differ by bfloat16 ulps, and a token whose k-th and (k+1)-th
router probabilities are nearly tied takes another expert: with these
weights and prompt the reduced granite-moe-3b-a800m flips one token at its
third MoE layer (reference margin 3.3e-3) and deepseek-v2-236b one at its
fourth (3.9e-3).  So the bfloat16 models are held at every MoE input up to
the first flip, the flips to near ties, and whole (logits and caches) only
without a flip; the MoE block itself, given one bfloat16 input in both
packages, routes identically (``test_torch_moe``).
"""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.models.common import SMOKE_TOPO
from repro.models.model_zoo import build_model as ref_build_model
from repro.serve import ServeEngine as RefServeEngine
from repro_torch.configs import ARCHS
from repro_torch.launch import serve as serve_launcher
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model_zoo import build_model
from repro_torch.serve import ServeEngine
from test_torch_models import BF16_TOL, DTYPES, F32_TOL, _f32

GRANITE, DEEPSEEK, JAMBA = ("granite-moe-3b-a800m", "deepseek-v2-236b",
                            "jamba-1.5-large-398b")
MOE_ARCHS = (GRANITE, DEEPSEEK, JAMBA)
CACHE_KEYS = {GRANITE: {"l0_attn": ("k", "v")},
              DEEPSEEK: {"l0_mla": ("ckv", "krope")},
              JAMBA: {"l0_mamba": ("state", "conv"), "l1_attn": ("k", "v")}}
EXPERT_WEIGHTS = ("'w_gate'", "'w_up'", "'w_down'")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def moe_tree(ref_model, seed: int, dtype) -> dict:
    """numpy parameters in the layout of ``ref_model.init_params``.  Each
    weight is drawn normal / sqrt(its input width): d_model for a stacked
    expert's ``w_gate`` / ``w_up``, d_ff for its ``w_down``, heads x head
    dim for ``wo``, the first dim otherwise.  Norm scales (``kv_norm``
    too) are 1 + normal * 0.1, biases normal * 0.1, the embedding table
    normal; a Mamba layer's A_log, dt_bias and D around their inits, as in
    ``test_torch_models.reference_tree``."""
    rng = np.random.default_rng(seed)

    def leaf(path, st):
        name = jax.tree_util.keystr(path)
        shape = st.shape
        own = shape[1:] if name.startswith("['layers']") else shape
        if "'A_log'" in name:
            a = np.log(np.arange(1, shape[-1] + 1)) \
                + rng.normal(0.0, 0.1, shape)
        elif "'dt_bias'" in name:
            dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), shape))
            a = dt + np.log(-np.expm1(-dt))
        elif "'D'" in name:
            a = 1.0 + rng.normal(0.0, 0.1, shape)
        elif "'conv_b'" in name:
            a = rng.normal(0.0, 0.1, shape)
        elif "'scale'" in name or "'kv_norm'" in name:
            a = 1.0 + rng.normal(0.0, 0.1, shape)
        elif "'table'" in name:
            a = rng.normal(0.0, 1.0, shape)
        else:
            if any(w in name for w in EXPERT_WEIGHTS) and len(own) == 3:
                fan_in = own[1]
            elif "'wo'" in name:
                fan_in = int(np.prod(own[:-1]))
            else:
                fan_in = own[0]
            a = rng.normal(0.0, 1.0, shape) / np.sqrt(fan_in)
        return np.asarray(a, np.float32).astype(jnp.dtype(dtype))

    return jax.tree_util.tree_map_with_path(leaf, ref_model.param_shapes())


def _engines(arch: str, dtype: str, max_len: int = 40):
    jdtype, tdtype = DTYPES[dtype]
    ref = RefServeEngine(REF_ARCHS[arch].reduced(), SMOKE_TOPO,
                         max_len=max_len)
    tree = moe_tree(ref.prefill_model, 3, jdtype)
    port = ServeEngine(ARCHS[arch].reduced(), max_len=max_len, device="cpu",
                       dtype=tdtype)
    port.model.load_state_dict(params_from_jax(tree))
    return ref, jax.tree.map(jnp.asarray, tree), port


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_parameter_names_shapes_and_count_match_the_reference(arch):
    ref = ref_build_model(REF_ARCHS[arch].reduced(), SMOKE_TOPO,
                          kind="prefill")
    port = build_model(ARCHS[arch].reduced(), kind="prefill", device="cpu")
    state = params_from_jax(moe_tree(ref, 0, jnp.bfloat16))
    assert sorted(state) == sorted(port.state_dict())
    for name, t in port.state_dict().items():
        assert state[name].shape == t.shape and t.dtype == torch.bfloat16
    assert port.param_defs().num_params() == ref.store.num_params()
    kinds = {k for layer in port.layers for k in
             (s.kind for s in layer.values())}
    assert kinds == {GRANITE: {"attn", "moe"}, DEEPSEEK: {"mla", "moe"},
                     JAMBA: {"mamba", "mlp", "attn", "moe"}}[arch]


@pytest.mark.parametrize("arch,billions", [(GRANITE, 3.375),
                                           (DEEPSEEK, 244.2),
                                           (JAMBA, 398.6)])
def test_full_configs_count_the_reference_parameters(arch, billions):
    full = build_model(ARCHS[arch], kind="prefill", device="meta")
    ref = ref_build_model(REF_ARCHS[arch], SMOKE_TOPO, kind="prefill")
    n = sum(p.numel() for p in full.parameters())
    assert n == ref.store.num_params()
    assert round(n / 1e9, 3 if billions < 10 else 1) == billions
    assert len(full.layers) * len(full.period_kinds) // 2 == \
        ARCHS[arch].num_layers


# ---------------------------------------------------------------------------
# prefill, teacher-forced decode and greedy tokens
# ---------------------------------------------------------------------------
SEQ_KEYS = ("k", "v", "ckv", "krope")


def _pad_port(caches: dict, max_len: int) -> dict:
    out = {}
    for name, entry in caches.items():
        out[name] = {}
        for key, c in entry.items():
            if key in SEQ_KEYS:
                buf = c.new_zeros((*c.shape[:2], max_len, *c.shape[3:]))
                buf[:, :, :c.shape[2]] = c
                c = buf
            out[name][key] = c
    return out


def _pad_ref(caches: dict, max_len: int) -> dict:
    return {name: {key: jnp.pad(c, [(0, 0), (0, 0), (0, max_len - c.shape[2])]
                                + [(0, 0)] * (c.ndim - 3))
                   if key in SEQ_KEYS else c for key, c in entry.items()}
            for name, entry in caches.items()}


def _prompt(cfg) -> np.ndarray:
    return np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_decode_and_greedy_tokens_match_the_reference(arch):
    """float32 parameters.  The engines' greedy tokens (bfloat16 caches, as
    the reference keeps them) are equal; then prefill and 8 teacher-forced
    decode steps with float32 caches in both packages, so that a cache
    value on a bfloat16 rounding edge, which either package may round
    either way, does not hide a difference of the port's."""
    ref, params, port = _engines(arch, "float32")
    cfg = port.cfg
    tokens = _prompt(cfg)
    n = 8
    want = ref.generate(params, {"tokens": tokens}, n)
    got = port.generate({"tokens": tokens}, n)
    assert got.dtype == np.int32 and got.shape == (2, n)
    np.testing.assert_array_equal(got, want)

    logits_r, caches_r = ref._prefill(params, {"tokens": jnp.asarray(tokens)})
    logits_p, caches_p = port.model.prefill({"tokens": tokens})
    assert sorted(caches_p) == sorted(caches_r)
    for name, entry in caches_r.items():
        assert sorted(caches_p[name]) == sorted(entry)
        for key, c in entry.items():
            assert caches_p[name][key].shape == c.shape
            np.testing.assert_allclose(_f32(caches_p[name][key]), _f32(c),
                                       **F32_TOL)
    caches_r, caches_p = _pad_ref(caches_r, 40), _pad_port(caches_p, 40)
    for i in range(n):
        lr = np.asarray(logits_r, np.float32)[:, :cfg.vocab_size]
        lp = logits_p.numpy()[:, :cfg.vocab_size]
        np.testing.assert_allclose(lp, lr, **F32_TOL)
        top2 = np.sort(lr, axis=1)[:, -2:]
        assert np.all(top2[:, 1] - top2[:, 0] > np.abs(lp - lr).max(1)), i
        nxt = want[:, i]
        logits_r, caches_r = ref._decode(params, caches_r, jnp.asarray(nxt),
                                         jnp.asarray(16 + i, jnp.int32))
        logits_p, caches_p = port.model.decode_step(
            caches_p, torch.from_numpy(nxt), 16 + i)
    for name, keys in CACHE_KEYS[arch].items():
        for key in keys:
            assert caches_p[name][key].dtype == torch.float32
            np.testing.assert_allclose(_f32(caches_p[name][key]),
                                       _f32(caches_r[name][key]), **F32_TOL)


def ref_moe_inputs(ref_model, params, tokens) -> dict:
    """(period, sublayer) -> the reference's input to each MoE sublayer of
    a prefill, its period loop unrolled (``LM._apply_period``'s order)."""
    topo = SMOKE_TOPO
    h = ref_model.embedding.embed(params["embed"], jnp.asarray(tokens), topo)
    positions = jnp.arange(tokens.shape[1], dtype=jnp.int32)
    out = {}
    for i in range(ref_model.n_periods):
        lp = jax.tree.map(lambda a: a[i], params["layers"])
        for sub in ref_model.period:
            sp = lp[sub.name]
            x = sub.norm(sp["norm"], h)
            if sub.kind in ("attn", "mla", "mamba"):
                h = h + sub.block(sp["core"], x, positions, topo)
            elif sub.kind == "moe":
                out[(i, sub.name)] = x
                h = h + sub.block(sp["core"], x, topo)[0]
            else:
                h = h + sub.block(sp["core"], x, topo)
    return out


def port_moe_inputs(model, tokens) -> dict:
    """(period, sublayer) -> the port's input to each MoE sublayer."""
    got, hooks = {}, []
    for i, layer in enumerate(model.layers):
        for name, sub in layer.items():
            if sub.kind == "moe":
                hooks.append(sub.core.register_forward_pre_hook(
                    lambda m, a, key=(i, name): got.__setitem__(key, a[0])))
    try:
        model.prefill({"tokens": tokens})
    finally:
        for hook in hooks:
            hook.remove()
    return got


def top_order(probs: np.ndarray, k: int):
    """Each token's top-k experts in order (the order decides which pass
    claims a capacity slot) and the least gap between neighbouring
    probabilities among its first k + 1."""
    order = np.argsort(-probs, axis=-1, kind="stable")
    v = np.take_along_axis(probs, order, axis=-1)
    return order[..., :k], (v[..., :k] - v[..., 1:k + 1]).min(-1)


NEAR_TIE = 1e-2


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_bf16_models_agree_up_to_routing_near_ties(arch):
    """bfloat16 parameters.  The packages' activations differ by bfloat16
    ulps (see the module docstring), so a token whose k-th and (k+1)-th
    router probabilities are nearly tied may take another expert, and
    from there its hidden state differs by O(1); two nearly tied choices
    within the top k may swap, and with them the pass that claims a
    capacity slot.  So: at every MoE layer up to the first such flip the
    two MoE inputs agree within the bfloat16 tolerance; every token that
    flips there has a reference margin (the least gap between neighbouring
    probabilities among its first k + 1) below 1e-2; and a model without a
    flip has its prefill logits and caches within that tolerance."""
    ref, params, port = _engines(arch, "bfloat16")
    tokens = _prompt(port.cfg)
    want = ref_moe_inputs(ref.prefill_model, params, tokens)
    got = port_moe_inputs(port.model, tokens)
    assert sorted(got) == sorted(want)
    flips = []
    for key in sorted(want):
        x_r, x_p = want[key], got[key]
        np.testing.assert_allclose(_f32(x_p), _f32(x_r), **BF16_TOL)
        moe = port.model.layers[key[0]][key[1]].core
        p_r = np.asarray(jax.nn.softmax(jnp.einsum(
            "bsd,de->bse", x_r, params["layers"][key[1]]["core"]["router"]
            [key[0]].astype(x_r.dtype), preferred_element_type=jnp.float32),
            axis=-1))
        p_p = moe._probs(x_p).numpy()
        order_r, margin = top_order(p_r, moe.top_k)
        order_p, _ = top_order(p_p, moe.top_k)
        flipped = np.argwhere(np.any(order_r != order_p, axis=-1))
        for b, s in flipped:
            flips.append((key, int(b), int(s), float(margin[b, s])))
            assert margin[b, s] < NEAR_TIE, flips[-1]
        if len(flipped):
            break
    if flips:
        return
    logits_r, caches_r = ref._prefill(params, {"tokens": jnp.asarray(tokens)})
    logits_p, caches_p = port.model.prefill({"tokens": tokens})
    np.testing.assert_allclose(_f32(logits_p), _f32(logits_r), **BF16_TOL)
    for name, entry in caches_r.items():
        for key, c in entry.items():
            np.testing.assert_allclose(_f32(caches_p[name][key]), _f32(c),
                                       **BF16_TOL)


def test_mla_caches_pad_along_the_sequence():
    eng = ServeEngine(ARCHS[DEEPSEEK].reduced(), max_len=30, device="cpu",
                      dtype=torch.float32)
    eng.init_params(2)
    _, caches = eng.model.prefill({"tokens": np.ones((3, 7), np.int32)})
    padded = eng._pad_caches(caches, 3)
    cfg = eng.cfg
    for key, width in (("ckv", cfg.kv_lora_rank), ("krope", cfg.qk_rope_dim)):
        c = padded["l0_mla"][key]
        assert c.shape == (cfg.num_layers, 3, 30, width)
        assert c.dtype == torch.bfloat16 and not c[:, :, 7:].any()
        assert torch.equal(c[:, :, :7],
                           caches["l0_mla"][key].to(torch.bfloat16))


# ---------------------------------------------------------------------------
# the launcher and the device policy
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serve_launcher_smoke_on_the_cpu(monkeypatch, capsys, arch):
    monkeypatch.setattr("sys.argv", [
        "serve", "--arch", arch, "--smoke", "--device", "cpu",
        "--batch", "1", "--prompt-len", "5", "--tokens", "3"])
    serve_launcher.main()
    out = capsys.readouterr().out
    assert "prefill_tokens=5 decode_steps=3" in out and "device=cpu" in out


def test_serve_launcher_refuses_weights_larger_than_the_device(monkeypatch):
    card = 80 * 10**9
    monkeypatch.setattr(serve_launcher, "device_memory_bytes",
                        lambda device: card)
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match=r"488\.4 GB .* 80\.0 GB"):
        serve_launcher.check_fits(ARCHS[DEEPSEEK], cpu)
    serve_launcher.check_fits(ARCHS[GRANITE], cpu)        # 6.75 GB fits
    four = dataclasses.replace(ARCHS[DEEPSEEK], num_layers=4)
    assert four.param_count() == 17_257_897_984
    serve_launcher.check_fits(four, cpu)
    monkeypatch.setattr("sys.argv", ["serve", "--arch", JAMBA, "--device",
                                     "cpu"])
    with pytest.raises(ValueError, match="jamba-1.5-large-398b"):
        serve_launcher.main()


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_engine_defaults_to_the_card(arch):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(ARCHS[arch].reduced(), max_len=8)


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "whisper-medium"])
def test_vlm_and_enc_dec_name_their_roadmap_item(arch):
    """The vlm and enc-dec families, once refused with their ROADMAP item,
    now serve: the engine answers a request of the reduced model on the
    CPU with its stub input (image embeddings or frames)."""
    cfg = ARCHS[arch].reduced()
    eng = ServeEngine(cfg, max_len=12, device="cpu")
    eng.init_params(1)
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (1, 5))}
    memory = "image_embeds" if cfg.family == "vlm" else "frames"
    batch[memory] = rng.standard_normal(
        (1, cfg.num_image_tokens or 7, cfg.d_model)).astype(np.float32)
    out = eng.generate(batch, 4)
    assert out.shape == (1, 4) and out.max() < cfg.vocab_size
    assert (eng.stats.prefill_tokens, eng.stats.decode_steps) == (5, 4)


# ---------------------------------------------------------------------------
# chip_smoke.py's sublayer-by-sublayer card-vs-host check, on two CPU models
# ---------------------------------------------------------------------------
def sublayer_check(arch, dtype, mutate=None):
    """``chip_smoke.moe_sublayers_vs_host`` with a CPU copy of the host
    model in the card's place (``mutate`` applied to the copy), on phase
    14's prompt and its 8 teacher-forced tokens."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    cfg = ARCHS[arch].reduced()
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 100))
    host = ServeEngine(cfg, max_len=120, device="cpu", dtype=dtype)
    host.init_params(0)
    copy = ServeEngine(cfg, max_len=120, device="cpu", dtype=dtype)
    copy.model.load_state_dict(host.model.state_dict())
    if mutate is not None:
        with torch.no_grad():
            mutate(copy.model)
    logits, caches = host.model.prefill({"tokens": tokens})
    caches = host._pad_caches(caches, 2)
    fed = []
    for i in range(8):
        fed.append(torch.argmax(logits, dim=-1))
        logits, caches = host.model.decode_step(caches, fed[-1], 100 + i)
    return chip_smoke.moe_sublayers_vs_host(host, copy.model, "cpu", tokens,
                                            fed, dtype, arch)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_chip_smoke_sublayer_check_on_the_cpu(arch, dtype):
    """Two equal CPU models: every norm, block, cache and logit of the
    prefill and the 8 decode steps equal, no routing difference, a margin
    for each MoE layer."""
    got = sublayer_check(arch, dtype)
    assert got["err"] == {"norm": 0.0, "block": 0.0, "moe": 0.0,
                          "cache": 0.0, "logits": 0.0}
    assert got["flips"] == []
    moe = "l1_moe" if arch == JAMBA else "l0_moe"
    periods = 2 if arch == JAMBA else 4
    assert sorted(got["margins"]) == [f"{i}/{moe}" for i in range(periods)]
    assert all(0 < m < 1 for m in got["margins"].values())


def _scale_expert(model):
    model.layers[1]["l0_moe"].core.w_down[2] *= 1.1


def _move_router(model):
    r = model.layers[1]["l0_moe"].core.router
    r.add_(0.02 * torch.randn(r.shape, generator=torch.Generator()
                              .manual_seed(0)).to(r.dtype))


def _scale_norm(model):
    model.layers[0]["l0_moe"].norm.scale.mul_(1.1)


def _scale_latent_norm(model):
    model.layers[1]["l0_mla"].core.kv_norm.mul_(1.1)


def _scale_decode(model):
    core = model.layers[2]["l0_attn"].core
    decode = core.decode
    core.decode = lambda *a: (decode(*a)[0] * 1.1, None)


@pytest.mark.parametrize("arch, mutate, where", [
    (GRANITE, _scale_expert, "prefill layer 1 l0_moe output"),
    (GRANITE, _move_router, "routes differently on the same input"),
    (GRANITE, _scale_norm, "prefill layer 0 l0_moe norm"),
    (DEEPSEEK, _scale_latent_norm, "prefill layer 1 l0_mla cache ckv"),
    (GRANITE, _scale_decode, "decode 0 layer 2 l0_attn output")],
    ids=["expert", "router", "norm", "latent_norm", "decode_only"])
def test_chip_smoke_sublayer_check_catches_a_fault(arch, mutate, where):
    """A copy that differs in one expert, the router, one norm, MLA's
    latent norm or one layer's decode alone fails the check there, in
    float32 and bfloat16."""
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(AssertionError, match=where):
            sublayer_check(arch, dtype, mutate)
