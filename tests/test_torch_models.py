"""The port's dense LM (``repro_torch.models``) against the reference.

The same parameters, drawn with numpy from a seed in the reference's tree
layout, go into the reference's modules (JAX on the CPU, ``SMOKE_TOPO``) and,
through ``models.convert.params_from_jax``, into the port's; the same
inputs go through both.  Biases and norm scales, zero and one at init, are
drawn around those values so that their paths count.

Tolerances: float32 parameters, 3e-5 for one attention block and 1e-4 for
the logits and caches of a whole model (float32 rounding in another order).
bfloat16 parameters: logits and caches within rtol 2e-2 + atol 5e-2.  The
reference's jnp attention rounds ``q * scale``
and the softmax weights to bfloat16 (``models/attention.py:71, 106``); the
port's flash kernel keeps both in float32, as the reference's Pallas kernel
does, so the two differ by a few bfloat16 ulps after a layer.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.models import attention as ref_attention
from repro.models import layers as ref_layers
from repro.models.common import SMOKE_TOPO
from repro.models.model_zoo import build_model as ref_build_model
from repro_torch.configs import ARCHS
from repro_torch.models import attention, layers
from repro_torch.models.common import (ONE_DEVICE, ParamDef, ParamStore,
                                       init_param_)
from repro_torch.models.convert import params_from_jax, to_tensor
from repro_torch.models.model_zoo import build_model
from repro_torch.models.transformer import _attn_layout

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, None)}     # None: the defs' own bf16
F32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=2e-2, atol=5e-2)


def reference_tree(ref_model, seed: int, dtype) -> dict:
    """numpy parameters in the layout of ``ref_model.init_params``: weights
    normal / sqrt(fan_in) (the per-layer fan-in), the embedding table
    normal, biases normal * 0.1, norm scales 1 + normal * 0.1.  A Mamba
    layer's A_log, dt_bias and D are drawn around their inits, so the scan
    keeps its memory: A_log = log(1..ds) + normal * 0.1, dt_bias the inverse
    softplus of a log-uniform dt in [1e-3, 1e-1], D = 1 + normal * 0.1."""
    rng = np.random.default_rng(seed)

    def leaf(path, st):
        name = jax.tree_util.keystr(path)
        shape = st.shape
        if "'A_log'" in name:
            a = np.log(np.arange(1, shape[-1] + 1)) \
                + rng.normal(0.0, 0.1, shape)
        elif "'dt_bias'" in name:
            dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), shape))
            a = dt + np.log(-np.expm1(-dt))
        elif "'D'" in name:
            a = 1.0 + rng.normal(0.0, 0.1, shape)
        elif any(f"'{b}'" in name
                 for b in ("bq", "bk", "bv", "bo", "bias", "conv_b")):
            a = rng.normal(0.0, 0.1, shape)
        elif "'scale'" in name:
            a = 1.0 + rng.normal(0.0, 0.1, shape)
        elif "'table'" in name:
            a = rng.normal(0.0, 1.0, shape)
        else:
            fan_in = shape[1] if name.startswith("['layers']") else shape[0]
            a = rng.normal(0.0, 1.0, shape) / np.sqrt(fan_in)
        return np.asarray(a, np.float32).astype(jnp.dtype(dtype))

    return jax.tree_util.tree_map_with_path(leaf, ref_model.param_shapes())


def glm_reduced():
    return (REF_ARCHS["glm4-9b"].reduced(num_layers=2),
            ARCHS["glm4-9b"].reduced(num_layers=2))


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------------------------
# import boundary, topology, parameters
# ---------------------------------------------------------------------------
def test_port_imports_neither_jax_nor_the_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "assert len(mods) > 40, mods\n"
        "print(len(mods))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) > 40


def test_one_device_topology_picks_the_reference_layouts():
    ref_cfg, cfg = glm_reduced()
    assert ONE_DEVICE.axis_size("tp") == 1
    assert ONE_DEVICE.axis_size("batch") == 1
    with pytest.raises(KeyError):
        ONE_DEVICE.axis_size("pipeline")
    for kind in ("prefill", "decode", "train"):
        from repro.models.transformer import _attn_layout as ref_layout
        assert _attn_layout(cfg, ONE_DEVICE, kind) == \
            ref_layout(ref_cfg, SMOKE_TOPO, kind)
    assert _attn_layout(cfg, ONE_DEVICE, "prefill") == "megatron"
    assert _attn_layout(cfg, ONE_DEVICE, "decode") == "decode_rp"


def test_parameter_names_shapes_and_count_match_the_reference():
    ref_cfg, cfg = glm_reduced()
    ref = ref_build_model(ref_cfg, SMOKE_TOPO, kind="prefill")
    port = build_model(cfg, kind="prefill", device="cpu")
    tree = reference_tree(ref, 0, jnp.bfloat16)
    state = params_from_jax(tree)
    assert sorted(state) == sorted(port.state_dict())
    for name, t in port.state_dict().items():
        assert state[name].shape == t.shape and t.dtype == torch.bfloat16
    assert port.param_defs().num_params() == ref.store.num_params()
    # the config's count leaves out the final norm's scale
    assert sum(t.numel() for t in port.parameters()) == \
        cfg.param_count() + cfg.d_model


def test_params_from_jax_keeps_bf16_bits():
    a = np.asarray(jnp.asarray([1.0, -2.5, 3.1415926, 1e-8, 65504.0],
                               jnp.bfloat16))
    t = to_tensor(a)
    assert t.dtype == torch.bfloat16
    assert np.array_equal(t.view(torch.int16).numpy().view(np.uint16),
                          a.view(np.uint16))
    f = to_tensor(np.arange(6, dtype=np.float32).reshape(2, 3))
    assert f.dtype == torch.float32 and f.shape == (2, 3)


def test_seeded_init_follows_the_defs():
    store = ParamStore()
    store.add("w", ParamDef((256, 64), (None, None)))
    store.add("b", ParamDef((64,), (None,), init="zeros"))
    store.add("s", ParamDef((64,), (None,), init="ones", dtype="float32"))
    p1 = store.init(torch.Generator().manual_seed(3))
    p2 = store.init(torch.Generator().manual_seed(3))
    assert torch.equal(p1["w"], p2["w"]) and p1["w"].dtype == torch.bfloat16
    assert abs(float(p1["w"].float().std()) - 1 / 16) < 5e-3
    assert not p1["b"].any() and bool((p1["s"] == 1).all())
    nested = ParamStore()
    nested.stacked(3, "layers", store)
    assert nested.defs["layers/w"].shape == (3, 256, 64)
    assert nested.num_params() == 3 * (256 * 64 + 128)
    # the bf16 draw is the f32 draw rounded
    f = torch.empty(256, 64)
    init_param_(f, ParamDef((256, 64), (None, None)),
                torch.Generator().manual_seed(3))
    assert torch.equal(f.to(torch.bfloat16), p1["w"])


def test_lm_init_is_seeded_and_zero_biases_one_scales():
    _, cfg = glm_reduced()
    m1 = build_model(cfg, kind="prefill", device="cpu")
    m2 = build_model(cfg, kind="prefill", device="cpu")
    m1.init_params(torch.Generator().manual_seed(0))
    m2.init_params(torch.Generator().manual_seed(0))
    for (name, a), b in zip(m1.state_dict().items(),
                            m2.state_dict().values()):
        assert torch.equal(a, b), name
        if name.endswith(("bq", "bk", "bv")):
            assert not a.any()
        if name.endswith("scale"):
            assert bool((a == 1).all())
    wq = m1.layers[0]["l0_attn"].core.wq.float()
    assert abs(float(wq.std()) * np.sqrt(cfg.d_model) - 1.0) < 0.05


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b",
                                  "granite-moe-3b-a800m", "deepseek-v2-236b",
                                  "llama-3.2-vision-11b", "whisper-medium"])
def test_not_ported_families_raise(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(ARCHS[arch].reduced(), kind="prefill", device="cpu")


def test_lm_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    _, cfg = glm_reduced()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(cfg, kind="prefill")


# ---------------------------------------------------------------------------
# layers and the attention block, float32
# ---------------------------------------------------------------------------
def _load(module, params: dict) -> None:
    module.load_state_dict({k: to_tensor(v) for k, v in params.items()})


def test_norm_rope_mlp_and_head_match_the_reference():
    rng = np.random.default_rng(7)
    d, f = 64, 96
    x = rng.standard_normal((2, 5, d)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(d)).astype(np.float32)
    for kind, p in (("rmsnorm", {"scale": scale}),
                    ("layernorm", {"scale": scale, "bias": bias})):
        norm = layers.Norm("n", d, kind, device="cpu", dtype=torch.float32)
        _load(norm, p)
        want = ref_layers.Norm("n", d, kind)(
            {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
        np.testing.assert_allclose(_f32(norm(torch.from_numpy(x))),
                                   _f32(want), rtol=3e-5, atol=3e-5)

    q = rng.standard_normal((2, 5, 4, 32)).astype(np.float32)
    pos = np.arange(3, 8)
    np.testing.assert_allclose(
        _f32(layers.apply_rope(torch.from_numpy(q), torch.from_numpy(pos),
                               10_000.0)),
        _f32(ref_layers.apply_rope(jnp.asarray(q), jnp.asarray(pos),
                                   10_000.0)), rtol=3e-5, atol=3e-5)

    w = {"w_gate": rng.standard_normal((d, f)) / 8,
         "w_up": rng.standard_normal((d, f)) / 8,
         "w_down": rng.standard_normal((f, d)) / 10}
    w = {k: v.astype(np.float32) for k, v in w.items()}
    for act in ("swiglu", "gelu"):
        mlp = layers.Mlp("m", d, f, act, device="cpu", dtype=torch.float32)
        p = w if act == "swiglu" else {k: w[k] for k in ("w_up", "w_down")}
        _load(mlp, p)
        want = ref_layers.Mlp("m", d, f, act)(
            {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
            SMOKE_TOPO)
        np.testing.assert_allclose(_f32(mlp(torch.from_numpy(x))),
                                   _f32(want), rtol=3e-5, atol=3e-5)

    table = rng.standard_normal((50, d)).astype(np.float32)
    head = (rng.standard_normal((d, 50)) / 8).astype(np.float32)
    emb = layers.Embedding("e", 50, d, device="cpu", dtype=torch.float32)
    _load(emb, {"table": table, "head": head})
    ref_emb = ref_layers.Embedding("e", 50, d)
    rp = {"table": jnp.asarray(table), "head": jnp.asarray(head)}
    toks = np.array([[1, 4, 49], [0, 7, 7]])
    np.testing.assert_array_equal(
        _f32(emb.embed(torch.from_numpy(toks))),
        _f32(ref_emb.embed(rp, jnp.asarray(toks), SMOKE_TOPO)))
    np.testing.assert_allclose(
        _f32(emb.logits(torch.from_numpy(x[:, -1]))),
        _f32(ref_emb.logits(rp, jnp.asarray(x[:, -1]), SMOKE_TOPO)),
        rtol=3e-5, atol=3e-5)


def test_attention_prefill_and_decode_match_the_reference():
    rng = np.random.default_rng(11)
    b, s, d, H, KV, dh, S = 2, 12, 64, 4, 2, 32, 20
    ref = ref_attention.Attention("a", d, H, KV, dh, layout="megatron",
                                  qkv_bias=True)
    port = attention.Attention("a", d, H, KV, dh, layout="megatron",
                               qkv_bias=True, device="cpu",
                               dtype=torch.float32)
    params = {k: (rng.standard_normal(s_) / np.sqrt(s_[0] if k[0] == "w"
                                                     else 10))
              .astype(np.float32) for k, s_ in
              (("wq", (d, H, dh)), ("wk", (d, KV, dh)), ("wv", (d, KV, dh)),
               ("wo", (H, dh, d)), ("bq", (H, dh)), ("bk", (KV, dh)),
               ("bv", (KV, dh)))}
    _load(port, params)
    rp = {k: jnp.asarray(v) for k, v in params.items()}
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    pos = np.arange(s, dtype=np.int32)
    want, (k_r, v_r) = ref(rp, jnp.asarray(x), jnp.asarray(pos), SMOKE_TOPO,
                           return_kv=True)
    got, (k_p, v_p) = port(torch.from_numpy(x), torch.from_numpy(pos),
                           return_kv=True)
    for a, r in ((got, want), (k_p, k_r), (v_p, v_r)):
        np.testing.assert_allclose(_f32(a), _f32(r), rtol=3e-5, atol=3e-5)

    # decode at t = s against caches padded to S (float32 caches here)
    kc = np.zeros((b, S, KV, dh), np.float32)
    vc = np.zeros((b, S, KV, dh), np.float32)
    kc[:, :s], vc[:, :s] = _f32(k_r), _f32(v_r)
    xt = rng.standard_normal((b, d)).astype(np.float32)
    want, (kc_r, vc_r) = ref.decode(rp, jnp.asarray(xt), jnp.int32(s),
                                    jnp.asarray(kc), jnp.asarray(vc),
                                    SMOKE_TOPO)
    kc_t, vc_t = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    got, (kc_p, vc_p) = port.decode(torch.from_numpy(xt), s, kc_t, vc_t)
    assert kc_p is kc_t and vc_p is vc_t      # updated in place
    for a, r in ((got, want), (kc_p, kc_r), (vc_p, vc_r)):
        np.testing.assert_allclose(_f32(a), _f32(r), rtol=3e-5, atol=3e-5)


def test_decode_attention_ignores_the_cache_past_t():
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((1, 4, 16), np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 32, 4, 16), np.float32))
    v = torch.from_numpy(rng.standard_normal((1, 32, 4, 16), np.float32))
    out1 = attention.decode_attention(q, k, v, 10)
    k2, v2 = k.clone(), v.clone()
    k2[:, 11:], v2[:, 11:] = 99.0, -99.0
    assert torch.equal(out1, attention.decode_attention(q, k2, v2, 10))


# ---------------------------------------------------------------------------
# the whole reduced glm4-9b
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_prefill_matches_the_reference(dtype):
    jdtype, tdtype = DTYPES[dtype]
    ref_cfg, cfg = glm_reduced()
    ref = ref_build_model(ref_cfg, SMOKE_TOPO, kind="prefill")
    tree = reference_tree(ref, 1, jdtype)
    port = build_model(cfg, kind="prefill", device="cpu", dtype=tdtype)
    port.load_state_dict(params_from_jax(tree))
    tokens = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 24)).astype(np.int32)
    want, caches_r = jax.jit(ref.prefill)(
        jax.tree.map(jnp.asarray, tree), {"tokens": jnp.asarray(tokens)})
    got, caches_p = port.prefill({"tokens": tokens})
    assert got.dtype == torch.float32 and got.shape == want.shape
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)
    assert sorted(caches_p) == sorted(caches_r) == ["l0_attn"]
    for key in ("k", "v"):
        assert caches_p["l0_attn"][key].shape == caches_r["l0_attn"][key].shape
        np.testing.assert_allclose(_f32(caches_p["l0_attn"][key]),
                                   _f32(caches_r["l0_attn"][key]), **tol)
