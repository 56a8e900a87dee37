"""The port's serving engine (``repro_torch.serve``) against the reference's.

The reduced glm4-9b gets the same numpy parameters in both packages (see
``test_torch_models.reference_tree``).  Greedy tokens must be equal, and at
every step the gap between the reference's two largest logits must exceed
the largest difference between the two packages' logits, so the equality
does not hang on a near tie.  Logit and cache tolerances are those of
``test_torch_models``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.common import SMOKE_TOPO
from repro.serve import ServeEngine as RefServeEngine
from repro_torch.configs import ARCHS
from repro_torch.launch import serve as serve_launcher
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import ServeEngine
from test_torch_models import (BF16_TOL, DTYPES, F32_TOL,
                               glm_reduced, reference_tree)


def _engines(dtype: str, max_len: int = 40):
    jdtype, tdtype = DTYPES[dtype]
    ref_cfg, cfg = glm_reduced()
    ref = RefServeEngine(ref_cfg, SMOKE_TOPO, max_len=max_len)
    tree = reference_tree(ref.prefill_model, 3, jdtype)
    port = ServeEngine(cfg, max_len=max_len, device="cpu", dtype=tdtype)
    port.model.load_state_dict(params_from_jax(tree))
    return ref, jax.tree.map(jnp.asarray, tree), port


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_greedy_tokens_and_decode_logits_match_the_reference(dtype):
    ref, params, port = _engines(dtype)
    cfg = port.cfg
    tokens = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32)
    n = 8
    want = ref.generate(params, {"tokens": tokens}, n)
    got = port.generate({"tokens": tokens}, n)
    assert got.dtype == np.int32 and got.shape == (2, n)
    np.testing.assert_array_equal(got, want)
    assert port.stats.prefill_tokens == 32 and port.stats.decode_steps == n
    assert port.stats.requests == 1 and port.stats.first_token_s > 0

    # teacher-forced on the reference's tokens: logits of every step
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    logits_r, caches_r = ref._prefill(params, {"tokens": jnp.asarray(tokens)})
    caches_r = ref._pad_caches(caches_r, 2, 16)
    logits_p, caches_p = port.model.prefill({"tokens": tokens})
    caches_p = port._pad_caches(caches_p, 2)
    for i in range(n):
        lr = np.asarray(logits_r, np.float32)[:, :cfg.vocab_size]
        lp = logits_p.numpy()[:, :cfg.vocab_size]
        np.testing.assert_allclose(lp, lr, **tol)
        diff = np.abs(lp - lr).max(axis=1)
        top2 = np.sort(lr, axis=1)[:, -2:]
        assert np.all(top2[:, 1] - top2[:, 0] > diff), (i, top2, diff)
        nxt = want[:, i]
        logits_r, caches_r = ref._decode(params, caches_r, jnp.asarray(nxt),
                                         jnp.asarray(16 + i, jnp.int32))
        logits_p, caches_p = port.model.decode_step(
            caches_p, torch.from_numpy(nxt), 16 + i)
    for key in ("k", "v"):
        np.testing.assert_allclose(
            caches_p["l0_attn"][key].float().numpy(),
            np.asarray(caches_r["l0_attn"][key], np.float32),
            **tol)


def test_generate_shapes_and_determinism():
    _, cfg = glm_reduced()
    eng = ServeEngine(cfg, max_len=40, device="cpu")
    eng.init_params(0)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 16)).astype(
        np.int32)}
    out1 = eng.generate(batch, 6)
    out2 = eng.generate(batch, 6)
    assert out1.shape == (2, 6)
    np.testing.assert_array_equal(out1, out2)
    assert np.all(out1 >= 0) and np.all(out1 < cfg.vocab_size)
    other = ServeEngine(cfg, max_len=40, device="cpu")
    other.init_params(0)
    np.testing.assert_array_equal(other.generate(batch, 6), out1)


def test_generate_rejects_overflow_and_keyless_sampling():
    _, cfg = glm_reduced()
    eng = ServeEngine(cfg, max_len=20, device="cpu")
    eng.init_params(0)
    batch = {"tokens": np.zeros((1, 16), np.int32)}
    with pytest.raises(ValueError):
        eng.generate(batch, 10)
    # sampling without a generator must raise, not silently fall back to
    # greedy decoding
    with pytest.raises(ValueError, match="requires a generator"):
        eng.generate(batch, 2, greedy=False)
    out = eng.generate(batch, 2, greedy=False,
                       generator=torch.Generator().manual_seed(1))
    assert out.shape == (1, 2)
    again = eng.generate(batch, 2, greedy=False,
                         generator=torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(out, again)


def test_non_finite_logits_raise():
    _, cfg = glm_reduced()
    eng = ServeEngine(cfg, max_len=20, device="cpu")
    eng.init_params(0)
    with torch.no_grad():
        eng.model.embed.head[:, 3] = float("nan")
    with pytest.raises(FloatingPointError, match="non-finite"):
        eng.generate({"tokens": np.zeros((1, 4), np.int32)}, 2)


def test_caches_are_bf16_padded_to_max_len():
    _, cfg = glm_reduced()
    eng = ServeEngine(cfg, max_len=30, device="cpu", dtype=torch.float32)
    eng.init_params(2)
    _, caches = eng.model.prefill({"tokens": np.ones((3, 7), np.int32)})
    assert caches["l0_attn"]["k"].dtype == torch.float32
    padded = eng._pad_caches(caches, 3)
    k = padded["l0_attn"]["k"]
    assert k.shape == (2, 3, 30, cfg.num_kv_heads, cfg.head_dim)
    assert k.dtype == torch.bfloat16 and not k[:, :, 7:].any()
    assert torch.equal(k[:, :, :7], caches["l0_attn"]["k"].to(torch.bfloat16))


def test_serve_launcher_smoke_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", [
        "serve", "--arch", "glm4-9b", "--smoke", "--device", "cpu",
        "--batch", "1", "--prompt-len", "5", "--tokens", "3"])
    serve_launcher.main()
    out = capsys.readouterr().out
    assert "prefill_tokens=5 decode_steps=3" in out and "device=cpu" in out


def test_engine_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    cfg = dataclasses.replace(ARCHS["glm4-9b"].reduced(), num_layers=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(cfg, max_len=8)
