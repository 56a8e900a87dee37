"""The port's MoE block and MLA attention against the reference.

The same parameters and inputs, drawn with numpy from a seed, go into the
reference's modules (JAX on the CPU, ``SMOKE_TOPO``) and the port's
(``repro_torch.models.moe.MoE``, ``repro_torch.models.attention
.MLAttention``, on the CPU).

Tolerances, float32: the MoE block's ``out`` and ``aux`` within 3e-5, its
dispatch mask exactly equal and its combine weights within 1e-6 (the same
slots; the weights' float32 softmax in another order); MLA prefill, decode
and its caches within 3e-5; MLA decode at t = s - 1 against a prefill of s
tokens within 1e-4 (two computations of one function in float32).  Every
routing comparison first asserts that the reference's routing margin (the
least gap between neighbouring router probabilities among a token's first
k + 1) exceeds 1e-4, so that an equal routing tests the port and not the
rounding.  bfloat16: both
packages get the same bfloat16 input, so routing and dispatch are equal and
``out`` agrees within rtol 2e-2 + atol 2e-2 (bfloat16 rounding of the
expert products in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import MLAttention as RefMLA
from repro.models.common import SMOKE_TOPO
from repro.models.moe import MoE as RefMoE
from repro_torch.models.attention import MLAttention
from repro_torch.models.common import init_param_
from repro_torch.models.convert import to_tensor
from repro_torch.models.moe import PLACEMENTS, MoE
from test_torch_models import _f32

BLOCK_TOL = dict(rtol=3e-5, atol=3e-5)
MARGIN = 1e-4


def moe_params(rng, d, E, f, num_shared=0) -> dict:
    """Router normal * 0.5 (sharp routing), expert weights normal /
    sqrt(input width)."""
    p = {"router": rng.standard_normal((d, E)) * 0.5,
         "w_gate": rng.standard_normal((E, d, f)) / np.sqrt(d),
         "w_up": rng.standard_normal((E, d, f)) / np.sqrt(d),
         "w_down": rng.standard_normal((E, f, d)) / np.sqrt(f)}
    if num_shared:
        fs = num_shared * f
        p.update(ws_gate=rng.standard_normal((d, fs)) / np.sqrt(d),
                 ws_up=rng.standard_normal((d, fs)) / np.sqrt(d),
                 ws_down=rng.standard_normal((fs, d)) / np.sqrt(fs))
    return {k: v.astype(np.float32) for k, v in p.items()}


def ref_margin(router, xg, k: int) -> float:
    """The reference's routing margin: the least gap between neighbouring
    router probabilities among a token's first k + 1 (the order of the
    top k decides which pass claims a capacity slot)."""
    logits = jnp.einsum("gsd,de->gse", xg, router.astype(xg.dtype),
                        preferred_element_type=jnp.float32)
    probs = -np.sort(-np.asarray(jax.nn.softmax(logits, axis=-1)), axis=-1)
    return float((probs[..., :k] - probs[..., 1:k + 1]).min())


def dense_combine(route, E: int, C: int) -> np.ndarray:
    """The port's route as the reference's (G, S, E, C) combine."""
    G, S, k = route.topi.shape
    out = np.zeros((G, S, E, C), np.float32)
    g, s, j = np.nonzero(route.pos.numpy() < C)
    out[g, s, route.topi.numpy()[g, s, j], route.pos.numpy()[g, s, j]] = \
        route.weight.numpy()[g, s, j]
    return out


def _pair(d, E, k, f, S, cf, shared, dtype=torch.float32, seed=0):
    ref = RefMoE("m", d, E, k, f, num_shared=shared, group_size=S,
                 capacity_factor=cf)
    port = MoE("m", d, E, k, f, num_shared=shared, group_size=S,
               capacity_factor=cf, device="cpu", dtype=dtype)
    params = moe_params(np.random.default_rng(seed), d, E, f, shared)
    port.load_state_dict({n: to_tensor(v).to(dtype)
                          for n, v in params.items()})
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    rp = {n: jnp.asarray(v).astype(jdtype) for n, v in params.items()}
    return ref, rp, port


# b, s (None: a (b, d) input), d, E, k, f, group, capacity factor, shared
CASES = {
    "bsd": (2, 16, 32, 4, 2, 64, 16, 1.25, 0),
    "bd": (8, None, 32, 4, 2, 64, 16, 1.25, 0),
    "shared": (2, 16, 32, 4, 2, 64, 16, 1.25, 1),
    "drops": (2, 16, 32, 4, 2, 64, 16, 0.1, 0),
    "snap": (3, 7, 32, 4, 2, 64, 16, 1.25, 1),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_block_matches_the_reference(case):
    b, s, d, E, k, f, S, cf, shared = CASES[case]
    ref, rp, port = _pair(d, E, k, f, S, cf, shared)
    shape = (b, d) if s is None else (b, s, d)
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    T = b * (s or 1)
    G = T // port.group(T)
    xg = x.reshape(G, T // G, d)
    assert ref_margin(rp["router"], jnp.asarray(xg), k) > MARGIN

    combine_r, dispatch_r, aux_r = ref._route(rp, jnp.asarray(xg))
    route = port._route(torch.from_numpy(xg))
    C = port.capacity(T // G)
    assert combine_r.shape == (G, T // G, E, C)
    combine_p = dense_combine(route, E, C)
    np.testing.assert_array_equal(combine_p > 0, _f32(dispatch_r) > 0)
    np.testing.assert_allclose(combine_p, _f32(combine_r), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(float(route.aux), float(aux_r), **BLOCK_TOL)
    if case == "snap":
        assert (G, T // G) == (3, 7)
    if case == "drops":
        assert C == 1 and not route.dispatched.all()

    want, aux_w = ref(rp, jnp.asarray(x), SMOKE_TOPO)
    got, aux_g = port(torch.from_numpy(x))
    assert got.shape == x.shape
    np.testing.assert_allclose(_f32(got), _f32(want), **BLOCK_TOL)
    np.testing.assert_allclose(float(aux_g), float(aux_w), **BLOCK_TOL)


def test_moe_block_bf16_routes_as_the_reference():
    ref, rp, port = _pair(64, 8, 2, 96, 32, 1.25, 1, dtype=torch.bfloat16,
                          seed=3)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 32, 64)).astype(np.float32)).to(torch.bfloat16)
    xj = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    xg = xj.reshape(2, 32, 64)
    assert ref_margin(rp["router"], xg, 2) > MARGIN
    _, dispatch_r, _ = ref._route(rp, xg)
    route = port._route(x.reshape(2, 32, 64))
    C = port.capacity(32)
    np.testing.assert_array_equal(dense_combine(route, 8, C) > 0,
                                  _f32(dispatch_r) > 0)
    want, _ = ref(rp, xj, SMOKE_TOPO)
    got, _ = port(x)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-2, atol=2e-2)


# ---------------------------------------------------------------------------
# tests/test_moe.py's contracts on the port
# ---------------------------------------------------------------------------
def _moe(E=4, k=2, d=32, f=64, S=16, cf=1.25, placement="ep"):
    m = MoE("moe", d, E, k, f, group_size=S, capacity_factor=cf,
            placement=placement, device="cpu", dtype=torch.float32)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for name, p in sorted(m.named_parameters()):
            init_param_(p, m.defs[name], g)
    return m


def _randn(seed, *shape):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("placement", PLACEMENTS)
def test_moe_forward_finite(placement):
    m = _moe(placement=placement)
    x = _randn(1, 2, 16, 32) * 0.5
    out, aux = m(x)
    assert out.shape == x.shape
    assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(aux))


def test_moe_2d_decode_input():
    out, _ = _moe()(_randn(2, 8, 32))
    assert out.shape == (8, 32)


def test_aux_loss_balanced_is_one():
    """A near-uniform router: aux = E * sum(f_t * f_p) ~= 1."""
    m = _moe(E=8, k=1, S=64)
    with torch.no_grad():
        m.router.copy_(_randn(4, 32, 8) * 1e-3)
    _, aux = m(_randn(3, 4, 64, 32))
    assert 0.8 < float(aux) < 1.5


def test_capacity_drops_tokens():
    """cf -> 0 forces drops: the output collapses toward zero."""
    m_full, m_tight = _moe(cf=8.0), _moe(cf=0.10)
    x = _randn(5, 2, 16, 32)
    n_full = float(m_full(x)[0].abs().sum())
    n_tight = float(m_tight(x)[0].abs().sum())
    assert n_tight < n_full


def test_dispatch_combine_identity_for_identity_experts():
    """Every expert the same map: each token's output is that map (the
    top-k weights sum to one, no drops at cf = 4)."""
    m = _moe(E=4, k=2, d=16, f=16, S=8, cf=4.0)
    with torch.no_grad():
        for w in (m.w_gate, m.w_up, m.w_down):
            w.copy_(w[0:1].expand_as(w))
    x = _randn(6, 1, 8, 16) * 0.3
    out, _ = m(x)
    want = (torch.nn.functional.silu(x @ m.w_gate[0]) * (x @ m.w_up[0])) \
        @ m.w_down[0]
    torch.testing.assert_close(out, want, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------
MLA_DIMS = dict(d=64, H=4, lora=32, nope=32, rope=16, v=24)


def _mla_pair(seed: int):
    d, H, lora, nope, rope, v = (MLA_DIMS[k] for k in
                                 ("d", "H", "lora", "nope", "rope", "v"))
    ref = RefMLA("a", d, H, lora, nope, rope, v, layout="megatron")
    ref_dec = RefMLA("a", d, H, lora, nope, rope, v, layout="decode_rp")
    port = MLAttention("a", d, H, lora, nope, rope, v, layout="megatron",
                       device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(seed)
    params = {"wq": rng.standard_normal((d, H, nope + rope)) / np.sqrt(d),
              "w_kva": rng.standard_normal((d, lora + rope)) / np.sqrt(d),
              "kv_norm": 1 + 0.1 * rng.standard_normal(lora),
              "w_kvb": rng.standard_normal((lora, H, nope + v))
              / np.sqrt(lora),
              "wo": rng.standard_normal((H, v, d)) / np.sqrt(H * v)}
    params = {k: a.astype(np.float32) for k, a in params.items()}
    port.load_state_dict({k: to_tensor(a) for k, a in params.items()})
    return ref, ref_dec, {k: jnp.asarray(a) for k, a in params.items()}, port


def test_mla_prefill_and_absorbed_decode_match_the_reference():
    ref, ref_dec, rp, port = _mla_pair(5)
    rng = np.random.default_rng(6)
    b, s, S = 2, 12, 20
    x = rng.standard_normal((b, s, MLA_DIMS["d"])).astype(np.float32)
    pos = np.arange(s, dtype=np.int32)
    want, (c_r, kr_r) = ref(rp, jnp.asarray(x), jnp.asarray(pos),
                            SMOKE_TOPO, return_kv=True)
    got, (c_p, kr_p) = port(torch.from_numpy(x), torch.from_numpy(pos),
                            return_kv=True)
    assert c_p.shape == (b, s, MLA_DIMS["lora"])
    assert kr_p.shape == (b, s, MLA_DIMS["rope"])
    for a, r in ((got, want), (c_p, c_r), (kr_p, kr_r)):
        np.testing.assert_allclose(_f32(a), _f32(r), **BLOCK_TOL)

    # decode at t = s against caches padded to S (float32 caches here)
    cc = np.zeros((b, S, MLA_DIMS["lora"]), np.float32)
    rc = np.zeros((b, S, MLA_DIMS["rope"]), np.float32)
    cc[:, :s], rc[:, :s] = _f32(c_r), _f32(kr_r)
    xt = rng.standard_normal((b, MLA_DIMS["d"])).astype(np.float32)
    want, (cc_r, rc_r) = ref_dec.decode(rp, jnp.asarray(xt), jnp.int32(s),
                                        jnp.asarray(cc), jnp.asarray(rc),
                                        SMOKE_TOPO)
    cc_t, rc_t = torch.from_numpy(cc.copy()), torch.from_numpy(rc.copy())
    got, (cc_p, rc_p) = port.decode(torch.from_numpy(xt), s, cc_t, rc_t)
    assert cc_p is cc_t and rc_p is rc_t            # updated in place
    for a, r in ((got, want), (cc_p, cc_r), (rc_p, rc_r)):
        np.testing.assert_allclose(_f32(a), _f32(r), **BLOCK_TOL)


def test_mla_decode_equals_prefill_of_one_more_token():
    _, _, _, port = _mla_pair(7)
    b, s = 2, 10
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (b, s, MLA_DIMS["d"])).astype(np.float32))
    full = port(x, torch.arange(s))
    _, (c, kr) = port(x[:, :-1], torch.arange(s - 1), return_kv=True)
    cc = torch.zeros((b, s + 3, MLA_DIMS["lora"]))
    rc = torch.zeros((b, s + 3, MLA_DIMS["rope"]))
    cc[:, :s - 1], rc[:, :s - 1] = c, kr
    out, _ = port.decode(x[:, -1], s - 1, cc, rc)
    torch.testing.assert_close(out, full[:, -1], rtol=1e-4, atol=1e-4)
