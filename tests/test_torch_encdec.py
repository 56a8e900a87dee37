"""The port's vlm (gated cross-attention every ``cross_attn_period``
layers) and whisper-style encoder-decoder against the reference.

The reduced llama-3.2-vision-11b and whisper-medium get the same numpy
parameters in both packages (``cross_tree``, carried with
``models.convert.params_from_jax``) and the same prompts, image embeddings
and frames.  The reference initialises the vlm's gates to 0, where
``tanh(0)`` would leave the cross sublayers out of the logits, so every
gate here is drawn in [0.5, 1.5].

Tolerances, as ``test_torch_moe_models``': float32 parameters, the prefill
logits, every cache (self and cross) and 8 teacher-forced decode logits
within 1e-4 (float32 caches in both packages), the greedy tokens of the two
engines equal with each step's top-2 gap above the packages' largest
logit difference; bfloat16 parameters with float32 image embeddings or
frames (the served inputs, promoted through the bfloat16 weights as jnp
promotes them) within rtol 2e-2 + atol 5e-2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.models import attention as ref_attention
from repro.models import encdec as ref_encdec
from repro.models.common import SMOKE_TOPO
from repro.models.model_zoo import build_model as ref_build_model
from repro.serve import ServeEngine as RefServeEngine
from repro_torch.configs import ARCHS
from repro_torch.launch import serve as serve_launcher
from repro_torch.models import attention, encdec
from repro_torch.models.convert import params_from_jax, to_tensor
from repro_torch.models.model_zoo import build_model
from repro_torch.serve import ServeEngine
from test_torch_models import BF16_TOL, DTYPES, F32_TOL, _f32

VLM, WHISPER = "llama-3.2-vision-11b", "whisper-medium"
ARCH_NAMES = (VLM, WHISPER)
STACKS = ("['layers']", "['enc_layers']", "['dec_layers']")
MAX_LEN = 40
PROMPT = 16
STEPS = 8


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Reduced models are many small tensor ops, which one thread runs as
    fast as eight; under the suite's parallel workers a thread pool per
    worker oversubscribes the cores and slows them manyfold."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def cross_tree(ref_model, seed: int, dtype) -> dict:
    """numpy parameters in the layout of ``ref_model.init_params``: each
    weight normal / sqrt(its input width) (heads x head dim for ``wo``),
    the embedding table normal, biases (LayerNorm's too) normal * 0.1, norm
    scales 1 + normal * 0.1, and each vlm gate uniform in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)

    def leaf(path, st):
        name = jax.tree_util.keystr(path)
        shape = st.shape
        own = shape[1:] if name.startswith(STACKS) else shape
        if "'gate'" in name:
            a = rng.uniform(0.5, 1.5, shape)
        elif "'scale'" in name:
            a = 1.0 + rng.normal(0.0, 0.1, shape)
        elif any(f"'{b}'" in name for b in ("bq", "bk", "bv", "bo", "bias")):
            a = rng.normal(0.0, 0.1, shape)
        elif "'table'" in name:
            a = rng.normal(0.0, 1.0, shape)
        else:
            fan_in = int(np.prod(own[:-1])) if "'wo'" in name else own[0]
            a = rng.normal(0.0, 1.0, shape) / np.sqrt(fan_in)
        return np.asarray(a, np.float32).astype(jnp.dtype(dtype))

    return jax.tree_util.tree_map_with_path(leaf, ref_model.param_shapes())


def batch_for(cfg, b: int = 2, s: int = PROMPT, seed: int = 4,
              memory: int = 12) -> dict:
    """Tokens and the family's stub input, each ``standard_normal * 0.02``
    float32 as the launchers draw them (whisper's frames ``memory`` long,
    so that the encoder's length is not the prompt's)."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32)}
    if cfg.family == "vlm":
        batch["image_embeds"] = rng.standard_normal(
            (b, cfg.num_image_tokens, cfg.d_model)).astype(np.float32) * 0.02
    else:
        batch["frames"] = rng.standard_normal(
            (b, memory, cfg.d_model)).astype(np.float32) * 0.02
    return batch


def _engines(arch: str, dtype: str, seed: int = 3):
    jdtype, tdtype = DTYPES[dtype]
    ref = RefServeEngine(REF_ARCHS[arch].reduced(), SMOKE_TOPO,
                         max_len=MAX_LEN)
    tree = cross_tree(ref.prefill_model, seed, jdtype)
    port = ServeEngine(ARCHS[arch].reduced(), max_len=MAX_LEN, device="cpu",
                       dtype=tdtype)
    port.model.load_state_dict(params_from_jax(tree))
    return ref, jax.tree.map(jnp.asarray, tree), port


def _jax_batch(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _is_cross(name: str) -> bool:
    return name == "cross" or name.endswith("_cross")


def _pad(caches: dict, pad) -> dict:
    """Self-attention caches padded along the sequence to MAX_LEN; cross
    caches as they are."""
    return {name: {key: c if _is_cross(name) else pad(c)
                   for key, c in entry.items()}
            for name, entry in caches.items()}


def _pad_port(c):
    buf = c.new_zeros((*c.shape[:2], MAX_LEN, *c.shape[3:]))
    buf[:, :, :c.shape[2]] = c
    return buf


def _pad_ref(c):
    return jnp.pad(c, [(0, 0), (0, 0), (0, MAX_LEN - c.shape[2])]
                   + [(0, 0)] * (c.ndim - 3))


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_parameter_names_shapes_and_count_match_the_reference(arch):
    ref = ref_build_model(REF_ARCHS[arch].reduced(), SMOKE_TOPO,
                          kind="prefill")
    port = build_model(ARCHS[arch].reduced(), kind="prefill", device="cpu")
    state = params_from_jax(cross_tree(ref, 0, jnp.bfloat16))
    assert sorted(state) == sorted(port.state_dict())
    for name, t in port.state_dict().items():
        assert state[name].shape == t.shape and t.dtype == torch.bfloat16
    assert port.param_defs().num_params() == ref.store.num_params()
    if arch == VLM:
        gates = [n for n in state if n.endswith(".gate")]
        assert gates == [f"layers.{i}.l1_cross.gate" for i in range(2)]
        assert all(state[n].shape == (1,) for n in gates)
    else:
        assert {n.split(".")[0] for n in state} == {
            "embed", "enc_final_norm", "final_norm", "enc_layers",
            "dec_layers"}


@pytest.mark.parametrize("arch,count", [(VLM, 10_110_697_472),
                                        (WHISPER, 811_417_600)])
def test_full_configs_count_the_reference_parameters(arch, count):
    full = build_model(ARCHS[arch], kind="prefill", device="meta")
    ref = ref_build_model(REF_ARCHS[arch], SMOKE_TOPO, kind="prefill")
    assert sum(p.numel() for p in full.parameters()) == \
        ref.store.num_params()
    assert ARCHS[arch].param_count() == REF_ARCHS[arch].param_count() \
        == count


def test_seeded_init_leaves_the_gates_at_zero():
    eng = ServeEngine(ARCHS[VLM].reduced(), max_len=MAX_LEN, device="cpu",
                      dtype=torch.float32)
    eng.init_params(0)
    kinds = [k for _, k in eng.model.period_kinds]
    assert kinds == ["attn", "mlp", "attn", "cross", "mlp"]
    for layer in eng.model.layers:
        assert not layer["l1_cross"].gate.any()
    # tanh(0) = 0: the image embeddings then move nothing
    batch = batch_for(eng.cfg)
    a, _ = eng.model.prefill(batch)
    b, _ = eng.model.prefill(dict(batch,
                                  image_embeds=batch["image_embeds"] * 9))
    assert torch.equal(a, b)
    with torch.no_grad():
        for layer in eng.model.layers:
            layer["l1_cross"].gate.fill_(1.0)
    c, _ = eng.model.prefill(batch)
    d, _ = eng.model.prefill(dict(batch,
                                  image_embeds=batch["image_embeds"] * 9))
    assert not torch.allclose(c, d)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sq,sm,bias", [(12, 5, True), (3, 20, False)])
def test_cross_attention_prefill_and_decode_match_the_reference(sq, sm,
                                                                bias):
    """sq > skv and sq < skv over a memory, non-causal, no RoPE; decode
    projects q alone, attends to all of the memory and leaves the cache."""
    rng = np.random.default_rng(sq)
    b, d, H, KV, dh = 2, 64, 4, 2, 32
    kw = dict(layout="megatron", qkv_bias=bias, out_bias=bias,
              use_rope=False, is_cross=True, causal=False)
    ref = ref_attention.Attention("a", d, H, KV, dh, **kw)
    port = attention.Attention("a", d, H, KV, dh, device="cpu",
                               dtype=torch.float32, **kw)
    shapes = {"wq": (d, H, dh), "wk": (d, KV, dh), "wv": (d, KV, dh),
              "wo": (H, dh, d)}
    if bias:
        shapes.update(bq=(H, dh), bk=(KV, dh), bv=(KV, dh), bo=(d,))
    params = {k: (rng.standard_normal(s) / np.sqrt(8 if k[0] == "b"
                                                   else s[0]))
              .astype(np.float32) for k, s in shapes.items()}
    port.load_state_dict({k: to_tensor(v) for k, v in params.items()})
    rp = {k: jnp.asarray(v) for k, v in params.items()}
    x = rng.standard_normal((b, sq, d)).astype(np.float32)
    mem = rng.standard_normal((b, sm, d)).astype(np.float32)
    pos = np.arange(sq, dtype=np.int32)
    want, (k_r, v_r) = ref(rp, jnp.asarray(x), jnp.asarray(pos), SMOKE_TOPO,
                           memory=jnp.asarray(mem),
                           memory_positions=jnp.arange(sm, dtype=jnp.int32),
                           return_kv=True)
    got, (k_p, v_p) = port(torch.from_numpy(x), torch.from_numpy(pos),
                           return_kv=True, memory=torch.from_numpy(mem))
    assert k_p.shape == (b, sm, KV, dh)
    for a, r in ((got, want), (k_p, k_r), (v_p, v_r)):
        np.testing.assert_allclose(_f32(a), _f32(r), rtol=3e-5, atol=3e-5)
    with pytest.raises(ValueError, match="needs memory"):
        port(torch.from_numpy(x), torch.from_numpy(pos))

    xt = rng.standard_normal((b, d)).astype(np.float32)
    want, (kc_r, _) = ref.decode(rp, jnp.asarray(xt), jnp.int32(sq), k_r,
                                 v_r, SMOKE_TOPO, update_cache=False)
    kc, vc = k_p.clone(), v_p.clone()
    got, (kc_p, vc_p) = port.decode(torch.from_numpy(xt), sq, kc, vc)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=3e-5, atol=3e-5)
    assert kc_p is kc and torch.equal(kc, k_p) and torch.equal(vc, v_p)


def test_bf16_weights_promote_a_float32_memory_as_the_reference():
    """bfloat16 weights, bfloat16 x and a float32 memory: k and v come out
    float32, the output bfloat16, as jnp promotes them."""
    rng = np.random.default_rng(5)
    b, sq, sm, d, H, KV, dh = 2, 6, 10, 64, 4, 4, 32
    kw = dict(layout="megatron", qkv_bias=True, out_bias=True,
              use_rope=False, is_cross=True, causal=False)
    ref = ref_attention.Attention("a", d, H, KV, dh, **kw)
    port = attention.Attention("a", d, H, KV, dh, device="cpu", **kw)
    shapes = {"wq": (d, H, dh), "wk": (d, KV, dh), "wv": (d, KV, dh),
              "wo": (H, dh, d), "bq": (H, dh), "bk": (KV, dh),
              "bv": (KV, dh), "bo": (d,)}
    params = {k: np.asarray(rng.standard_normal(s) / np.sqrt(s[0]),
                            np.float32).astype(jnp.bfloat16)
              for k, s in shapes.items()}
    port.load_state_dict({k: to_tensor(v) for k, v in params.items()})
    x = np.asarray(rng.standard_normal((b, sq, d)), np.float32).astype(
        jnp.bfloat16)
    mem = rng.standard_normal((b, sm, d)).astype(np.float32)
    want, (k_r, _) = ref({k: jnp.asarray(v) for k, v in params.items()},
                         jnp.asarray(x), jnp.arange(sq), SMOKE_TOPO,
                         memory=jnp.asarray(mem),
                         memory_positions=jnp.arange(sm), return_kv=True)
    got, (k_p, _) = port(to_tensor(x), torch.arange(sq), return_kv=True,
                         memory=torch.from_numpy(mem))
    assert (got.dtype, k_p.dtype) == (torch.bfloat16, torch.float32)
    assert (want.dtype, k_r.dtype) == (jnp.bfloat16, jnp.float32)
    np.testing.assert_allclose(_f32(k_p), _f32(k_r), rtol=3e-5, atol=3e-5)
    np.testing.assert_allclose(_f32(got), _f32(want), **BF16_TOL)


def test_sinusoidal_positions_match_the_reference():
    """The two libraries' float32 ``exp`` differ by one ulp on some
    frequencies (56 of whisper's 512), so an angle differs by up to
    position x 2**-23 x its frequency (at most 1): 1e-5 up to the tested
    models' positions, position x 2**-22 beyond."""
    pos = np.array([0, 1, 7, 63, 1499, 2047])
    for dim in (128, 1024):
        got = encdec.sinusoidal(torch.from_numpy(pos), dim).numpy()
        want = np.asarray(ref_encdec.sinusoidal(jnp.asarray(pos), dim))
        np.testing.assert_allclose(got[:4], want[:4], rtol=0, atol=1e-5)
        bound = pos[4:, None] * 2.0 ** -22
        assert np.all(np.abs(got[4:] - want[4:]) <= bound)


def test_encoder_output_matches_the_reference():
    ref, params, port = _engines(WHISPER, "float32")
    frames = batch_for(port.cfg, memory=20)["frames"]
    want = jax.jit(ref.prefill_model.encode)(params, jnp.asarray(frames))
    got = port.model.encode(frames)
    assert got.shape == (2, 20, port.cfg.d_model)
    np.testing.assert_allclose(_f32(got), _f32(want), **F32_TOL)


# ---------------------------------------------------------------------------
# whole models: prefill, every cache, teacher-forced decode, greedy tokens
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_prefill_decode_and_greedy_tokens_match_the_reference(arch):
    """float32 parameters.  The engines' greedy tokens (bfloat16 caches, as
    the reference keeps them) are equal; then prefill and 8 teacher-forced
    decode steps with float32 caches in both packages."""
    ref, params, port = _engines(arch, "float32")
    cfg = port.cfg
    batch = batch_for(cfg)
    want = ref.generate(params, _jax_batch(batch), STEPS)
    got = port.generate(batch, STEPS)
    assert got.dtype == np.int32 and got.shape == (2, STEPS)
    np.testing.assert_array_equal(got, want)

    logits_r, caches_r = ref._prefill(params, _jax_batch(batch))
    logits_p, caches_p = port.model.prefill(batch)
    assert sorted(caches_p) == sorted(caches_r)
    crosses = [n for n in caches_r if _is_cross(n)]
    assert crosses == (["cross"] if arch == WHISPER else ["l1_cross"])
    memory = 12 if arch == WHISPER else cfg.num_image_tokens
    for name, entry in caches_r.items():
        assert sorted(caches_p[name]) == sorted(entry) == ["k", "v"]
        for key, c in entry.items():
            assert caches_p[name][key].shape == c.shape
            assert c.shape[2] == (memory if _is_cross(name) else PROMPT)
            np.testing.assert_allclose(_f32(caches_p[name][key]), _f32(c),
                                       **F32_TOL)
    caches_r, caches_p = _pad(caches_r, _pad_ref), _pad(caches_p, _pad_port)
    cross_before = {n: caches_p[n]["k"].clone() for n in crosses}
    for i in range(STEPS):
        lr = np.asarray(logits_r, np.float32)[:, :cfg.vocab_size]
        lp = logits_p.numpy()[:, :cfg.vocab_size]
        np.testing.assert_allclose(lp, lr, **F32_TOL)
        top2 = np.sort(lr, axis=1)[:, -2:]
        assert np.all(top2[:, 1] - top2[:, 0] > np.abs(lp - lr).max(1)), i
        nxt = want[:, i]
        logits_r, caches_r = ref._decode(params, caches_r, jnp.asarray(nxt),
                                         jnp.asarray(PROMPT + i, jnp.int32))
        logits_p, caches_p = port.model.decode_step(
            caches_p, torch.from_numpy(nxt), PROMPT + i)
    np.testing.assert_allclose(
        logits_p.numpy()[:, :cfg.vocab_size],
        np.asarray(logits_r, np.float32)[:, :cfg.vocab_size], **F32_TOL)
    for name, entry in caches_r.items():
        for key, c in entry.items():
            assert caches_p[name][key].dtype == torch.float32
            np.testing.assert_allclose(_f32(caches_p[name][key]), _f32(c),
                                       **F32_TOL)
    for n in crosses:                 # decode only reads the cross caches
        assert torch.equal(caches_p[n]["k"], cross_before[n])


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_bf16_models_with_float32_inputs_match_the_reference(arch):
    """bfloat16 parameters, the float32 image embeddings or frames the
    launchers draw: prefill logits and every cache within the bfloat16
    tolerance, the promoted caches in the reference's dtypes."""
    ref, params, port = _engines(arch, "bfloat16")
    batch = batch_for(port.cfg)
    logits_r, caches_r = ref._prefill(params, _jax_batch(batch))
    logits_p, caches_p = port.model.prefill(batch)
    np.testing.assert_allclose(_f32(logits_p), _f32(logits_r), **BF16_TOL)
    for name, entry in caches_r.items():
        for key, c in entry.items():
            assert str(caches_p[name][key].dtype).split(".")[1] == \
                str(c.dtype), (name, key)
            np.testing.assert_allclose(_f32(caches_p[name][key]), _f32(c),
                                       **BF16_TOL)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_cross_caches_are_cast_never_padded(arch):
    eng = ServeEngine(ARCHS[arch].reduced(), max_len=30, device="cpu",
                      dtype=torch.float32)
    eng.init_params(2)
    batch = batch_for(eng.cfg, b=3, s=7, memory=9)
    _, caches = eng.model.prefill(batch)
    mem = batch["frames"].shape[1] if "frames" in batch else None
    padded = eng._pad_caches(caches, 3, memory_len=mem)
    cfg = eng.cfg
    n = cfg.num_layers if arch == WHISPER else cfg.num_layers // \
        cfg.cross_attn_period
    for name, entry in padded.items():
        for key, c in entry.items():
            assert c.dtype == torch.bfloat16
            if _is_cross(name):
                assert c.shape == (n, 3, mem or cfg.num_image_tokens,
                                   cfg.num_kv_heads, cfg.head_dim)
                assert torch.equal(c, caches[name][key].to(torch.bfloat16))
            else:
                assert c.shape[2] == 30 and not c[:, :, 7:].any()


# ---------------------------------------------------------------------------
# the launcher and the device policy
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_serve_launcher_smoke_on_the_cpu(monkeypatch, capsys, arch):
    monkeypatch.setattr("sys.argv", [
        "serve", "--arch", arch, "--smoke", "--device", "cpu",
        "--batch", "2", "--prompt-len", "5", "--tokens", "3"])
    serve_launcher.main()
    out = capsys.readouterr().out
    assert "prefill_tokens=10 decode_steps=3" in out and "device=cpu" in out


def test_serve_launcher_fits_both_models_on_one_card(monkeypatch):
    monkeypatch.setattr(serve_launcher, "device_memory_bytes",
                        lambda device: 80 * 10**9)
    for arch in ARCH_NAMES:
        serve_launcher.check_fits(ARCHS[arch], torch.device("cpu"))
    huge = dataclasses.replace(ARCHS[VLM], num_layers=200)
    with pytest.raises(ValueError, match="llama-3.2-vision-11b"):
        serve_launcher.check_fits(huge, torch.device("cpu"))


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_engine_defaults_to_the_card(arch):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(ARCHS[arch].reduced(), max_len=8)
