"""The port's serving engine (``repro_torch.serve``) against the reference's.

The reduced glm4-9b and falcon-mamba-7b get the same numpy parameters in
both packages (see ``test_torch_models.reference_tree``).  Greedy tokens
must be equal, and at every step the gap between the reference's two largest logits must exceed
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
from test_torch_ssm import mamba_reduced

REDUCED = {"glm4-9b": glm_reduced, "falcon-mamba-7b": mamba_reduced}


def _engines(dtype: str, max_len: int = 40, arch: str = "glm4-9b"):
    jdtype, tdtype = DTYPES[dtype]
    ref_cfg, cfg = REDUCED[arch]()
    ref = RefServeEngine(ref_cfg, SMOKE_TOPO, max_len=max_len)
    tree = reference_tree(ref.prefill_model, 3, jdtype)
    port = ServeEngine(cfg, max_len=max_len, device="cpu", dtype=tdtype)
    port.model.load_state_dict(params_from_jax(tree))
    return ref, jax.tree.map(jnp.asarray, tree), port


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_greedy_tokens_and_decode_logits_match_the_reference(dtype):
    _greedy_and_teacher_forced(dtype, "glm4-9b", {"l0_attn": ("k", "v")})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_falcon_mamba_greedy_tokens_and_decode_logits_match_the_reference(
        dtype):
    """float32 decode within 1e-4 too: the port's conv cache takes the dtype
    the reference's decode gives it (float32 after the first step).  In
    bfloat16 the reference's first teacher-forced step has a near tie (top
    two logits 0.0103 apart, the packages' logits up to 0.011 apart, well
    inside the bf16 tolerance), so there the port's choice must only be one
    of the reference's top two; the generated tokens are equal all the
    same."""
    _greedy_and_teacher_forced(dtype, "falcon-mamba-7b",
                               {"l0_mamba": ("state", "conv")},
                               near_ties=dtype == "bfloat16")


def _greedy_and_teacher_forced(dtype: str, arch: str, cache_keys: dict,
                               near_ties: bool = False):
    """Greedy tokens equal; teacher-forced logits within tolerance at every
    step, and the reference's top-2 gap larger than the logits' difference
    (with ``near_ties``: where it is not, the port's top token is one of the
    reference's top two, and elsewhere it is the reference's)."""
    ref, params, port = _engines(dtype, arch=arch)
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
        tied = top2[:, 1] - top2[:, 0] <= diff
        assert near_ties or not tied.any(), (i, top2, diff)
        ranks = (lr > lr[np.arange(len(lr)), lp.argmax(1)][:, None]).sum(1)
        assert np.all(np.where(tied, ranks <= 1, ranks == 0)), (i, ranks)
        nxt = want[:, i]
        logits_r, caches_r = ref._decode(params, caches_r, jnp.asarray(nxt),
                                         jnp.asarray(16 + i, jnp.int32))
        logits_p, caches_p = port.model.decode_step(
            caches_p, torch.from_numpy(nxt), 16 + i)
    for name, keys in cache_keys.items():
        for key in keys:
            # the same cache dtypes as the reference's after n steps
            assert str(caches_p[name][key].dtype) == \
                f"torch.{caches_r[name][key].dtype}"
            np.testing.assert_allclose(
                caches_p[name][key].float().numpy(),
                np.asarray(caches_r[name][key], np.float32), **tol)


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


def test_mamba_caches_keep_their_shapes_and_dtypes():
    _, cfg = mamba_reduced()
    eng = ServeEngine(cfg, max_len=30, device="cpu", dtype=torch.float32)
    eng.init_params(2)
    _, caches = eng.model.prefill({"tokens": np.ones((3, 7), np.int32)})
    padded = eng._pad_caches(caches, 3)
    st, cv = padded["l0_mamba"]["state"], padded["l0_mamba"]["conv"]
    assert st.shape == (2, 3, cfg.d_inner, cfg.ssm_state)
    assert st.dtype == torch.float32
    assert torch.equal(st, caches["l0_mamba"]["state"])
    assert cv.shape == (2, 3, cfg.ssm_conv - 1, cfg.d_inner)
    assert cv.dtype == torch.bfloat16
    assert torch.equal(cv, caches["l0_mamba"]["conv"].to(torch.bfloat16))
    # the first decode step promotes the conv window to float32, as the
    # reference's concatenation does, and advances both caches in place
    state_before = st.clone()
    _, out = eng.model.decode_step(padded, torch.tensor([1, 2, 3]), 7)
    assert out["l0_mamba"]["conv"].dtype == torch.float32
    assert out["l0_mamba"]["state"] is st
    assert not torch.equal(st, state_before)


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


@pytest.mark.parametrize("arch", ["glm4-9b", "falcon-mamba-7b"])
def test_serve_launcher_smoke_on_the_cpu(monkeypatch, capsys, arch):
    monkeypatch.setattr("sys.argv", [
        "serve", "--arch", arch, "--smoke", "--device", "cpu",
        "--batch", "1", "--prompt-len", "5", "--tokens", "3"])
    serve_launcher.main()
    out = capsys.readouterr().out
    assert "prefill_tokens=5 decode_steps=3" in out and "device=cpu" in out


@pytest.mark.parametrize("arch", ["glm4-9b", "falcon-mamba-7b"])
def test_engine_defaults_to_the_card(arch):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    cfg = dataclasses.replace(ARCHS[arch].reduced(), num_layers=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(cfg, max_len=8)
