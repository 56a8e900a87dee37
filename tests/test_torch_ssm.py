"""The port's selective scan and Mamba model against the reference.

``ssm_scan`` (on the CPU: its plain float32 loop) is held against
``ref.ssm_scan_ref`` and against the reference's ``ops.ssm_scan`` (the
Pallas kernel in interpret mode) at ``tests/test_kernels.py``'s sweep, with
its tolerances: 2e-4 in float32 and bf16 rounding of the output (rtol and
atol 2e-2) in bfloat16.  Against ``ssm_scan_ref`` itself, which computes in
float32 in the same order of operations, float32 agrees to 3e-6.

``MambaBlock`` and the reduced falcon-mamba-7b get the same numpy
parameters in both packages (``test_torch_models.reference_tree``, which
draws A_log, dt_bias and D around their inits).  float32 parameters: 3e-5
for one block, 1e-4 for a whole model's logits and caches.  bfloat16
parameters: rtol 2e-2 + atol 5e-2.  In bfloat16 both packages round the
prefill scan's output (without the skip term) to bfloat16 before adding
D * x in float32: the port calls the kernel without D to mirror the
reference's per-chunk cast, so the remaining difference is the order of
float32 sums and bfloat16 rounding of the projections.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_kernels
from repro.models.common import ParamDef as RefParamDef
from repro.models.common import SMOKE_TOPO, _init_param
from repro.models.model_zoo import build_model as ref_build_model
from repro.models.ssm import MambaBlock as RefMambaBlock
from repro_torch.configs import ARCHS
from repro_torch.kernels import build, ssm_scan, ssm_scan_bsd, ssm_scan_plain
from repro_torch.models.common import ParamDef, init_param_
from repro_torch.models.convert import params_from_jax, to_tensor
from repro_torch.models.model_zoo import build_model
from repro_torch.models.ssm import MambaBlock
from test_torch_models import (BF16_TOL, DTYPES, F32_TOL, _f32,
                               reference_tree)

SWEEP = [(1, 64, 128, 8, 16, 128), (2, 128, 256, 16, 64, 128),
         (1, 96, 384, 16, 32, 384)]
SCAN_TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
            "bfloat16": dict(rtol=2e-2, atol=2e-2)}
MAMBA = "falcon-mamba-7b"


def scan_inputs(b, s, di, ds, seed, dtype="float32"):
    """tests/test_kernels.py's distributions, drawn with numpy: x, dt, B, C
    in ``dtype`` (bf16 rounded once in torch, carried to jnp bit for bit),
    A and D float32, h0 float32."""
    rng = np.random.default_rng(seed)
    arrays = {
        "x": rng.standard_normal((b, s, di)) * 0.5,
        "dt": np.log1p(np.exp(rng.standard_normal((b, s, di)) * 0.2 - 1)),
        "A": -np.exp(rng.standard_normal((di, ds)) * 0.3),
        "B": rng.standard_normal((b, s, ds)) * 0.5,
        "C": rng.standard_normal((b, s, ds)) * 0.5,
        "D": 1.0 + 0.1 * rng.standard_normal(di),
        "h0": rng.standard_normal((b, di, ds)),
    }
    tdtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jdtype = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    t, j = {}, {}
    for k, a in arrays.items():
        low = k in ("x", "dt", "B", "C")
        t[k] = torch.from_numpy(a.astype(np.float32)).to(
            tdtype if low else torch.float32)
        j[k] = jnp.asarray(t[k].to(torch.float32).numpy()).astype(
            jdtype if low else jnp.float32)
    return t, j


# ---------------------------------------------------------------------------
# the scan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,s,di,ds,bs,bd", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
def test_plain_ssm_scan_matches_ref(b, s, di, ds, bs, bd, dtype, with_h0):
    t, j = scan_inputs(b, s, di, ds, s + di, dtype)
    args = [t[k] for k in ("x", "dt", "A", "B", "C", "D")]
    y, h = ssm_scan(*args, h0=t["h0"] if with_h0 else None)
    assert y.dtype == t["x"].dtype and y.shape == (b, s, di)
    assert h.dtype == torch.float32 and h.shape == (b, di, ds)
    y_r, h_r = ref_kernels.ssm_scan_ref(
        *[j[k] for k in ("x", "dt", "A", "B", "C", "D")],
        h0=j["h0"] if with_h0 else None)
    tol = dict(rtol=3e-6, atol=3e-6) if dtype == "float32" \
        else SCAN_TOL["bfloat16"]
    np.testing.assert_allclose(_f32(y), _f32(y_r), **tol)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_r), rtol=3e-6,
                               atol=3e-6)


@pytest.mark.parametrize("b,s,di,ds,bs,bd", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ops_ssm_scan_matches_pallas_interpret(b, s, di, ds, bs, bd, dtype):
    t, j = scan_inputs(b, s, di, ds, s * di, dtype)
    keys = ("x", "dt", "A", "B", "C", "D")
    y, _ = ssm_scan(*[t[k] for k in keys])
    want = ref_ops.ssm_scan(*[j[k] for k in keys], block_s=bs, block_d=bd)
    np.testing.assert_allclose(_f32(y), _f32(want), **SCAN_TOL[dtype])


def test_ssm_scan_without_skip_and_state_in_place():
    t, _ = scan_inputs(2, 37, 100, 16, 1)
    args = [t[k] for k in ("x", "dt", "A", "B", "C")]
    y_d, h_d = ssm_scan(*args, t["D"], h0=t["h0"])
    y_0, h_0 = ssm_scan(*args, None, h0=t["h0"])
    torch.testing.assert_close(y_0 + t["D"] * t["x"], y_d, rtol=1e-6,
                               atol=1e-6)
    assert torch.equal(h_0, h_d)
    # h_out may be h0 itself: the state is advanced in place
    state = t["h0"].clone()
    y_i, h_i = ssm_scan(*args, t["D"], h0=state, h_out=state)
    assert h_i is state and torch.equal(state, h_d) and torch.equal(y_i, y_d)
    # two halves carried through the state equal one pass
    first, second = ([t[k][:, part].contiguous() for k in ("x", "dt", "B",
                                                           "C")]
                     for part in (slice(0, 20), slice(20, None)))
    y_a, h_a = ssm_scan(*first[:2], t["A"], *first[2:], t["D"], h0=t["h0"])
    y_b, h_b = ssm_scan(*second[:2], t["A"], *second[2:], t["D"], h0=h_a)
    torch.testing.assert_close(torch.cat([y_a, y_b], 1), y_d, rtol=1e-6,
                               atol=1e-6)
    torch.testing.assert_close(h_b, h_d, rtol=1e-6, atol=1e-6)


def test_ssm_scan_wrapper_on_cpu_is_the_plain_version():
    t, _ = scan_inputs(1, 9, 40, 5, 2)
    args = [t[k] for k in ("x", "dt", "A", "B", "C", "D")]
    before = dict(build.LAUNCHES)
    y, h = ssm_scan_bsd(*args)
    y_p, h_p = ssm_scan_plain(*args)
    assert torch.equal(y, y_p) and torch.equal(h, h_p)
    assert build.LAUNCHES == before      # no kernel launch on the CPU
    assert "ssm_scan" in build.SOURCES and "ssm_scan" in build.LAUNCHES


@pytest.mark.parametrize("change,err", [
    ({"x": torch.zeros((2, 5))}, ValueError),                   # rank
    ({"dt": torch.zeros((2, 6, 8))}, ValueError),               # dt shape
    ({"A": torch.zeros((7, 4))}, ValueError),                   # A rows
    ({"A": torch.zeros((8, 129))}, ValueError),                 # ds > 128
    ({"B": torch.zeros((2, 5, 3))}, ValueError),                # B shape
    ({"D": torch.zeros(9)}, ValueError),                        # D shape
    ({"h0": torch.zeros((2, 8, 3))}, ValueError),               # h0 shape
    ({"x": torch.zeros((2, 5, 8), dtype=torch.float64)}, TypeError),
    ({"h_out": torch.zeros((2, 8, 4), dtype=torch.bfloat16)}, TypeError),
    ({"C": np.zeros((2, 5, 4), np.float32)}, TypeError),
    ({"dt": torch.zeros((2, 10, 8))[:, ::2]}, ValueError),      # strided
    ({"h_out": torch.zeros((2, 4, 8)).transpose(1, 2)}, ValueError),
])
def test_ssm_scan_rejects_what_it_does_not_take(change, err):
    args = dict(x=torch.zeros((2, 5, 8)), dt=torch.zeros((2, 5, 8)),
                A=torch.zeros((8, 4)), B=torch.zeros((2, 5, 4)),
                C=torch.zeros((2, 5, 4)), D=torch.zeros(8), h0=None,
                h_out=None)
    args.update(change)
    with pytest.raises(err):
        ssm_scan_bsd(**args)


# ---------------------------------------------------------------------------
# inits and parameters
# ---------------------------------------------------------------------------
def test_mamba_inits():
    d_a = ParamDef((6, 16), ("tp", None), init="mamba_a", dtype="float32")
    a = init_param_(torch.empty(6, 16), d_a, torch.Generator().manual_seed(0))
    want = _init_param(jax.random.key(0),
                       RefParamDef((6, 16), ("tp", None), init="mamba_a",
                                   dtype="float32"))
    np.testing.assert_allclose(a.numpy(), np.asarray(want), rtol=1e-7)
    d_dt = ParamDef((4096,), ("tp",), init="mamba_dt", dtype="float32")
    g = torch.Generator().manual_seed(3)
    bias = init_param_(torch.empty(4096), d_dt, g)
    again = init_param_(torch.empty(4096), d_dt,
                        torch.Generator().manual_seed(3))
    assert torch.equal(bias, again)                     # seeded
    dt = torch.nn.functional.softplus(bias.double())
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5)
    assert float(dt.max()) <= 1e-1 * (1 + 1e-5)
    # log-uniform: log10(dt) spreads evenly over [-3, -1]
    hist = torch.histc(torch.log10(dt), bins=4, min=-3, max=-1)
    assert bool((hist > 4096 / 4 * 0.85).all()), hist
    # the reference's draw covers the same range
    ref_dt = np.log1p(np.exp(np.asarray(_init_param(
        jax.random.key(1), RefParamDef((4096,), ("tp",), init="mamba_dt",
                                       dtype="float32")), np.float64)))
    assert ref_dt.min() >= 1e-3 * (1 - 1e-5) and ref_dt.max() <= 0.1001


def test_falcon_mamba_parameters_match_the_reference():
    ref_cfg = REF_ARCHS[MAMBA].reduced(num_layers=2)
    ref = ref_build_model(ref_cfg, SMOKE_TOPO, kind="prefill")
    port = build_model(ARCHS[MAMBA].reduced(num_layers=2), kind="prefill",
                       device="cpu")
    state = params_from_jax(reference_tree(ref, 0, jnp.bfloat16))
    assert sorted(state) == sorted(port.state_dict())
    core = "layers.0.l0_mamba.core."
    assert sorted(k[len(core):] for k in state if k.startswith(core)) == \
        sorted(["w_in", "conv_w", "conv_b", "w_x", "w_dt", "dt_bias",
                "A_log", "D", "w_out"])
    for name, t in port.state_dict().items():
        assert state[name].shape == t.shape and t.dtype == torch.bfloat16
    assert port.param_defs().num_params() == ref.store.num_params()
    # full width: 64 layers, ~7.3 B parameters, counted without memory
    full = build_model(ARCHS[MAMBA], kind="prefill", device="meta")
    ref_full = ref_build_model(REF_ARCHS[MAMBA], SMOKE_TOPO, kind="prefill")
    n = sum(p.numel() for p in full.parameters())
    assert n == ref_full.store.num_params()
    assert abs(n - 7.3e9) / 7.3e9 < 0.02 and len(full.layers) == 64
    assert {d.init for d in full.param_defs().defs.values()} >= \
        {"mamba_a", "mamba_dt", "zeros", "ones", "normal"}


def test_falcon_mamba_init_is_seeded_and_follows_the_defs():
    cfg = ARCHS[MAMBA].reduced(num_layers=2)
    m1 = build_model(cfg, kind="prefill", device="cpu", dtype=torch.float32)
    m2 = build_model(cfg, kind="prefill", device="cpu", dtype=torch.float32)
    m1.init_params(torch.Generator().manual_seed(0))
    m2.init_params(torch.Generator().manual_seed(0))
    for (name, a), b in zip(m1.state_dict().items(),
                            m2.state_dict().values()):
        assert torch.equal(a, b), name
    core = m1.layers[1]["l0_mamba"].core
    assert torch.equal(core.A_log, torch.log(torch.arange(
        1, cfg.ssm_state + 1, dtype=torch.float32)).expand_as(core.A_log))
    assert bool((core.D == 1).all()) and not core.conv_b.any()
    dt = torch.nn.functional.softplus(core.dt_bias)
    assert float(dt.min()) >= 0.99e-3 and float(dt.max()) <= 0.101
    assert abs(float(core.conv_w.std()) - 0.5) < 0.05


# ---------------------------------------------------------------------------
# the Mamba block, float32
# ---------------------------------------------------------------------------
def _blocks(seed: int):
    d, di, ds, dr = 64, 128, 8, 8
    ref = RefMambaBlock("m", d, di, ds, 4, dr)
    port = MambaBlock("m", d, di, ds, 4, dr, device="cpu",
                      dtype=torch.float32)
    rng = np.random.default_rng(seed)
    params = {
        "w_in": rng.standard_normal((d, 2 * di)) / np.sqrt(d),
        "conv_w": rng.standard_normal((4, di)) * 0.5,
        "conv_b": rng.standard_normal(di) * 0.1,
        "w_x": rng.standard_normal((di, dr + 2 * ds)) / np.sqrt(di),
        "w_dt": rng.standard_normal((dr, di)) / np.sqrt(dr),
        "dt_bias": np.log(np.expm1(np.exp(rng.uniform(np.log(1e-3),
                                                      np.log(1e-1), di)))),
        "A_log": np.log(np.arange(1, ds + 1)) + 0.1 * rng.standard_normal(
            (di, ds)),
        "D": 1 + 0.1 * rng.standard_normal(di),
        "w_out": rng.standard_normal((di, d)) / np.sqrt(di),
    }
    params = {k: v.astype(np.float32) for k, v in params.items()}
    port.load_state_dict({k: to_tensor(v) for k, v in params.items()})
    return ref, {k: jnp.asarray(v) for k, v in params.items()}, port


@pytest.mark.parametrize("s", [48, 256])
def test_mamba_block_forward_matches_the_reference(s):
    ref, rp, port = _blocks(s)
    x = np.random.default_rng(1).standard_normal((2, s, 64)).astype(
        np.float32) * 0.5
    want, (st_r, tail_r) = ref(rp, jnp.asarray(x), None, SMOKE_TOPO,
                               return_state=True)
    got, (st_p, tail_p) = port(torch.from_numpy(x), return_state=True)
    assert st_p.dtype == torch.float32 and st_p.shape == (2, 128, 8)
    for a, r in ((got, want), (st_p, st_r), (tail_p, tail_r)):
        np.testing.assert_allclose(_f32(a), _f32(r), rtol=3e-5, atol=3e-5)


def test_mamba_block_decode_matches_the_reference():
    ref, rp, port = _blocks(5)
    rng = np.random.default_rng(2)
    state = rng.standard_normal((2, 128, 8)).astype(np.float32)
    conv = rng.standard_normal((2, 3, 128)).astype(np.float32)
    st_t, cv_t = torch.from_numpy(state.copy()), torch.from_numpy(conv.copy())
    st_r, cv_r = jnp.asarray(state), jnp.asarray(conv)
    for t in range(4):
        x = rng.standard_normal((2, 64)).astype(np.float32)
        want, (st_r, cv_r) = ref.decode(rp, jnp.asarray(x), t, st_r, cv_r,
                                        SMOKE_TOPO)
        got, (st_p, cv_p) = port.decode(torch.from_numpy(x), t, st_t, cv_t)
        assert st_p is st_t and cv_p is cv_t        # updated in place
        for a, r in ((got, want), (st_p, st_r), (cv_p, cv_r)):
            np.testing.assert_allclose(_f32(a), _f32(r), rtol=3e-5,
                                       atol=3e-5)


@pytest.mark.parametrize("s", [200, 2])
def test_mamba_prefill_of_any_length_equals_its_own_decode(s):
    """The reference's prefill takes s <= 128 or a multiple of 128 only; the
    port's takes any s (here s = 200, two chunks and a ragged tail, and a
    prompt shorter than the conv window), and must agree with its own
    token-by-token decode from a zero state."""
    _, _, port = _blocks(7)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, s, 64)).astype(np.float32) * 0.5)
    full, (state, tail) = port(x, return_state=True)
    st, cv = torch.zeros((2, 128, 8)), torch.zeros((2, 3, 128))
    outs = [port.decode(x[:, t], t, st, cv)[0] for t in range(s)]
    torch.testing.assert_close(torch.stack(outs, 1), full, rtol=3e-5,
                               atol=3e-5)
    torch.testing.assert_close(st, state, rtol=3e-5, atol=3e-5)
    torch.testing.assert_close(cv, tail, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the whole reduced falcon-mamba-7b
# ---------------------------------------------------------------------------
def mamba_reduced():
    return (REF_ARCHS[MAMBA].reduced(num_layers=2),
            ARCHS[MAMBA].reduced(num_layers=2))


@pytest.mark.parametrize("s", [24, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_falcon_mamba_prefill_matches_the_reference(dtype, s):
    jdtype, tdtype = DTYPES[dtype]
    ref_cfg, cfg = mamba_reduced()
    ref = ref_build_model(ref_cfg, SMOKE_TOPO, kind="prefill")
    tree = reference_tree(ref, 1, jdtype)
    port = build_model(cfg, kind="prefill", device="cpu", dtype=tdtype)
    port.load_state_dict(params_from_jax(tree))
    tokens = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, s)).astype(np.int32)
    want, caches_r = jax.jit(ref.prefill)(
        jax.tree.map(jnp.asarray, tree), {"tokens": jnp.asarray(tokens)})
    got, caches_p = port.prefill({"tokens": tokens})
    assert got.dtype == torch.float32 and got.shape == want.shape
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)
    assert sorted(caches_p) == sorted(caches_r) == ["l0_mamba"]
    for key in ("state", "conv"):
        assert caches_p["l0_mamba"][key].shape == \
            caches_r["l0_mamba"][key].shape
        np.testing.assert_allclose(_f32(caches_p["l0_mamba"][key]),
                                   _f32(caches_r["l0_mamba"][key]), **tol)
    assert caches_p["l0_mamba"]["state"].dtype == torch.float32
