"""Port kernels (``repro_torch.kernels``) against the reference.

On the CPU the wrappers run their plain PyTorch versions; the same inputs,
made with numpy from a seed, go through the reference's NumPy float64
scatter, its Pallas kernels in interpret mode and its ``ops`` wrappers.
The CUDA kernels themselves are held against the plain versions by the
``cuda``-marked tests of ``tests/test_torch_cuda.py`` and by
``chip_smoke.py`` on the card.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import spikes as ref_spikes
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_kernels
from repro.kernels.ema_scan import ema_scan_pallas
from repro.kernels.spike_hist import spike_hist_batch_pallas
from repro_torch.core import spikes
from repro_torch.kernels import (attn_work, build, ema_scan, ema_scan_plain,
                                 ema_scan_rows, flash_attention,
                                 flash_attention_plain, rmsnorm,
                                 rmsnorm_plain, scan_work, spike_hist,
                                 spike_hist_batch, spike_hist_batch_plain,
                                 ssm_scan_plain)

BINS = (0.05, 0.1, 0.15, 0.2, 0.25, 0.5)
NBINS = tuple(ref_spikes.num_bins(c) for c in BINS)


def _numpy_scatter(r: np.ndarray, c: float, n: int) -> np.ndarray:
    """The reference engine's float64 scatter (pipeline/batch.py)."""
    out = np.zeros((r.shape[0], n), np.int64)
    for i, row in enumerate(r):
        v = row[row >= ref_spikes.SPIKE_LO]
        idx = np.minimum(((v - ref_spikes.SPIKE_LO) / c).astype(np.int64),
                         n - 1)
        out[i] = np.bincount(idx, minlength=n)
    return out


def _edge_values() -> np.ndarray:
    """Values on, one ulp around, and 1e-12 around every bin edge."""
    edges = np.array([ref_spikes.SPIKE_LO + k * c for c, n in zip(BINS, NBINS)
                      for k in range(n + 1)])
    return np.concatenate([edges, np.nextafter(edges, np.inf),
                           np.nextafter(edges, -np.inf), edges + 1e-12,
                           edges - 1e-12, [ref_spikes.SPIKE_LO, 2.0, 7.5]])


@pytest.mark.parametrize("seed,rows,cols", [(0, 7, 256), (1, 1, 1000),
                                            (2, 33, 13)])
def test_plain_spike_hist_equals_numpy_f64_scatter(seed, rows, cols):
    rng = np.random.default_rng(seed)
    r = rng.uniform(0.0, 2.5, (rows, cols))
    edges = _edge_values()
    flat = r.reshape(-1)
    flat[:min(len(edges), flat.size)] = edges[:flat.size]
    r[rng.random(r.shape) < 0.1] = -np.inf          # the engine's padding
    got = spike_hist_batch_plain(torch.from_numpy(r), BINS, NBINS).numpy()
    want = np.concatenate([_numpy_scatter(r, c, n)
                           for c, n in zip(BINS, NBINS)], axis=1)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def _edge_block(rng, rows, cols, scale=1.0):
    """Uniform values with every bin edge (and its neighbours) times
    ``scale`` at the start, a tenth -inf and a few NaN."""
    r = rng.uniform(0.0, 2.5, (rows, cols))
    edges = _edge_values()
    flat = r.reshape(-1)
    flat[:min(len(edges), flat.size)] = edges[:flat.size]
    r = r * scale
    r[rng.random(r.shape) < 0.1] = -np.inf
    r[rng.random(r.shape) < 0.02] = np.nan
    return r


@pytest.mark.parametrize("seed,rows,cols,R", [(10, 7, 256, 3), (11, 1, 1000, 1),
                                              (12, 33, 13, 40)])
def test_plain_spike_hist_out_rows_equals_index_add_and_numpy(seed, rows,
                                                              cols, R):
    """out= / rows= (repeated indices included) adds up as index_add_ of
    the counts does, and as the reference's float64 scatter into the same
    rows."""
    rng = np.random.default_rng(seed)
    r = _edge_block(rng, rows, cols)
    idx = rng.integers(0, R, rows)
    idx[-1] = idx[0]
    base = rng.integers(0, 9, (R, sum(NBINS))).astype(np.float64)
    out = torch.from_numpy(base.copy())
    got = spike_hist_batch_plain(torch.from_numpy(r), BINS, NBINS, out=out,
                                 rows=torch.from_numpy(idx))
    assert got is out
    counts = spike_hist_batch_plain(torch.from_numpy(r), BINS, NBINS)
    two_step = torch.from_numpy(base.copy()).index_add_(
        0, torch.from_numpy(idx), counts.to(torch.float64))
    assert torch.equal(got, two_step)
    want = base.copy()
    per_row = np.concatenate([_numpy_scatter(r, c, n)
                              for c, n in zip(BINS, NBINS)], axis=1)
    np.add.at(want, idx, per_row.astype(np.float64))
    np.testing.assert_array_equal(got.numpy(), want)
    # without rows=, row i adds into out[i]
    out2 = torch.zeros((rows, sum(NBINS)), dtype=torch.float64)
    spike_hist_batch(torch.from_numpy(r), BINS, NBINS, out=out2)
    assert torch.equal(out2, counts.to(torch.float64))


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_plain_spike_hist_divisor_equals_divide_then_bin(per_row, dtype):
    """divisor= bins r / divisor, one IEEE divide as torch.div, with bin
    edges (times the divisor) among the samples."""
    rng = np.random.default_rng(13)
    tdp = rng.uniform(100.0, 300.0, 9 if per_row else ())
    r = _edge_block(rng, 9, 300, tdp[:, None] if per_row else tdp)
    t = torch.from_numpy(r).to(dtype)
    div = torch.tensor(tdp, dtype=dtype)
    got = spike_hist_batch(t, BINS, NBINS, divisor=div)
    rel = t / (div[:, None] if per_row else div)
    assert torch.equal(got, spike_hist_batch_plain(rel, BINS, NBINS))
    if dtype == torch.float64:        # the reference's scatter of r / tdp
        want = np.concatenate([
            _numpy_scatter(r / (tdp[:, None] if per_row else tdp), c, n)
            for c, n in zip(BINS, NBINS)], axis=1)
        np.testing.assert_array_equal(got.numpy(), want)
    out = torch.zeros((9, sum(NBINS)), dtype=torch.float64)
    spike_hist_batch(t, BINS, NBINS, divisor=div, out=out,
                     rows=torch.arange(9))
    assert torch.equal(out, got.to(torch.float64))


@pytest.mark.parametrize("kw,match", [
    (dict(out=torch.zeros((5, 72), dtype=torch.float32)), "float64"),
    (dict(out=torch.zeros((5, 71), dtype=torch.float64)), "float64"),
    (dict(out=torch.zeros((4, 72), dtype=torch.float64)), "rows="),
    (dict(out=torch.zeros((72, 5), dtype=torch.float64).t()), "contiguous"),
    (dict(out=torch.zeros((5, 72), dtype=torch.float64),
          rows=torch.zeros(4, dtype=torch.int64)), "rows"),
    (dict(out=torch.zeros((5, 72), dtype=torch.float64),
          rows=torch.zeros(5, dtype=torch.int32)), "rows"),
    (dict(rows=torch.zeros(5, dtype=torch.int64)), "needs out"),
    (dict(divisor=torch.ones(4, dtype=torch.float64)), "divisor"),
    (dict(divisor=torch.ones((5, 1), dtype=torch.float64)), "divisor"),
    (dict(divisor=torch.ones((), dtype=torch.float32)), "divisor"),
])
def test_spike_hist_rejects_bad_out_rows_divisor(kw, match):
    r = torch.zeros((5, 10), dtype=torch.float64)
    with pytest.raises(ValueError, match=match):
        spike_hist_batch(r, BINS, NBINS, **kw)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_quotient_plan_scalings_equal_the_divides(dtype):
    """The kernel's quotient plan, followed as the kernel does: a size
    whose quotient is an exact power-of-two scaling of its family's divided
    quotient or of r - lo gives the IEEE divide's bits, at every bin edge,
    its neighbours and random values."""
    from repro_torch.kernels.spike_hist import (DIVIDE, FROM_BASE,
                                                _plan_code, _quotient_plan)
    sizes = BINS + (0.4, 0.3, 1.0, 0.125)
    plan = _quotient_plan(sizes, dtype)
    assert sorted(b for b, _, _ in plan) == list(range(len(sizes)))
    assert [b for b, _, _ in _quotient_plan(BINS, dtype)] == [0, 1, 3, 2,
                                                              4, 5]
    assert _plan_code(_quotient_plan(BINS, dtype)) == 2580   # kPlanSix
    assert sum(kind == DIVIDE for _, kind, _ in plan) == 2   # 0.05, 0.15
    rng = np.random.default_rng(14)
    v = np.concatenate([_edge_values(), rng.uniform(0.5, 3.0, 20_000),
                        [0.5, 1e300, np.inf]])
    shifted = torch.from_numpy(v).to(dtype) - torch.tensor(0.5, dtype=dtype)
    base = shifted
    for b, kind, scale in plan:
        want = shifted / torch.tensor(sizes[b], dtype=dtype)
        if kind == DIVIDE:
            got = want
            base = got
        else:
            got = (base if kind == FROM_BASE else shifted) \
                * torch.tensor(scale, dtype=dtype)
        assert torch.equal(got, want), (sizes[b], kind, scale)


@pytest.mark.parametrize("rows,F,total,want", [
    (10_000, 256, 72, (1, 1)),        # the engine's blocks: a warp a row
    (300, 256, 72, (8, 1)),           # too few rows to fill the card
    (1, 256, 72, (8, 1)),             # a builder commit: a CTA a row
    (1, 4000, 15, (8, 1)),            # ops.spike_hist: a CTA, no split
    (1, 100_000, 72, (8, 25)),        # one long trace over 25 CTAs
    (5000, 300, 2000, (8, 1)),        # counters too many for eight sets
])
def test_spike_hist_layout(rows, F, total, want):
    from repro_torch.kernels.spike_hist import _hist_layout
    assert _hist_layout(rows, F, total) == want


def test_wrapper_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(3)
    r = torch.from_numpy(rng.uniform(0.0, 2.2, (5, 300)))
    before = dict(build.LAUNCHES)
    assert torch.equal(spike_hist_batch(r, BINS, NBINS),
                       spike_hist_batch_plain(r, BINS, NBINS))
    assert build.LAUNCHES == before        # no kernel launch on the CPU


def test_plain_spike_hist_f32_equals_pallas_interpret_away_from_edges():
    # away from bin edges the reference's f32 Pallas binning and the port's
    # binning must agree exactly; at edges they may not (the port bins in the
    # block's own dtype with an IEEE divide, Pallas in f32 through XLA)
    rng = np.random.default_rng(4)
    c = 0.1
    n = ref_spikes.num_bins(c)
    centres = ref_spikes.SPIKE_LO + (rng.integers(0, n, (9, 200)) + 0.5) * c
    r = (centres + rng.uniform(-0.3 * c, 0.3 * c, centres.shape)) \
        .astype(np.float32)
    r[:, :20] = rng.uniform(0.0, 0.45, (9, 20))          # below threshold
    want = np.asarray(spike_hist_batch_pallas(
        jnp.asarray(r), n, bin_width=c, interpret=True))
    got = spike_hist_batch_plain(torch.from_numpy(r), (c,), (n,)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int32))


@pytest.mark.parametrize("n_bins", [15, 30, 6])
def test_ops_spike_hist_matches_reference_ops(n_bins):
    rng = np.random.default_rng(n_bins)
    tdp = 197.0
    width = 1.5 / n_bins
    centres = 0.5 + (rng.integers(0, n_bins, 3000) + 0.5) * width
    rel = centres + rng.uniform(-0.3 * width, 0.3 * width, 3000)
    power = (rel * tdp).astype(np.float32)
    want = np.asarray(ref_ops.spike_hist(jnp.asarray(power), tdp,
                                         n_bins=n_bins, interpret=True))
    got = spike_hist(torch.from_numpy(power), tdp, n_bins=n_bins).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_ops_spike_hist_all_below_threshold_is_zero():
    got = spike_hist(torch.full((100,), 10.0), 197.0)
    assert torch.equal(got, torch.zeros(15))


@pytest.mark.parametrize("n", [1, 2, 127, 128, 129, 1000])
def test_plain_ema_matches_pallas_interpret(n):
    # f32 tolerance: the Pallas kernel scans 128-sample rows with a decay-
    # matrix matmul, the plain version doubles prefixes; both round in f32,
    # and the alpha = 0.5 filter keeps the rounding error from growing, so
    # a few f32 ulps of the trace magnitude bound the difference
    rng = np.random.default_rng(n)
    x = rng.uniform(50.0, 300.0, n).astype(np.float32)
    want = np.asarray(ema_scan_pallas(jnp.asarray(x), interpret=True))
    got = ema_scan_plain(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * x.max())
    got_ops = ema_scan(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(
        got_ops, np.asarray(ref_ops.ema_scan(jnp.asarray(x), interpret=True)),
        rtol=0, atol=1e-5 * x.max())


def test_ema_rows_filter_each_row_independently():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.uniform(0, 300, (4, 77)).astype(np.float32))
    got = ema_scan_rows(x)
    for i in range(4):
        assert torch.equal(got[i], ema_scan_plain(x[i]))


def test_ema_filter_backends():
    rng = np.random.default_rng(6)
    p = rng.uniform(50.0, 300.0, 2000)
    want = ref_spikes.ema_filter(p, backend="numpy")
    # float64 prefix doubling in torch: bit-identical to the reference
    got = spikes.ema_filter(torch.from_numpy(p))
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        spikes.ema_filter(p, backend="numpy"), want)
    np.testing.assert_array_equal(
        spikes.ema_filter(p, backend="torch", device="cpu").numpy(), want)
    # the f32 kernel path (plain version on the CPU): f32 tolerance
    f32 = spikes.ema_filter(torch.from_numpy(p), backend="cuda")
    assert f32.dtype == torch.float64
    np.testing.assert_allclose(f32.numpy(), want, rtol=0,
                               atol=1e-5 * p.max())
    with pytest.raises(ValueError, match="unknown ema backend"):
        spikes.ema_filter(p, backend="pallas")


def test_power_from_energy_and_trim_idle_match_reference():
    rng = np.random.default_rng(9)
    e = np.cumsum(rng.uniform(0.0, 0.3, 500))
    np.testing.assert_array_equal(
        spikes.power_from_energy(torch.from_numpy(e), 1e-3).numpy(),
        ref_spikes.power_from_energy(e, 1e-3))
    p = rng.uniform(0, 300, 500)
    busy = (rng.random(500) < 0.5).astype(float)
    busy[:17] = 0.0
    busy[-9:] = 0.0
    np.testing.assert_array_equal(
        spikes.trim_idle(torch.from_numpy(p), torch.from_numpy(busy)).numpy(),
        ref_spikes.trim_idle(p, busy))
    assert len(spikes.trim_idle(torch.from_numpy(p),
                                torch.zeros(500, dtype=torch.float64))) == 0


def test_num_bins_keeps_python_round():
    assert [spikes.num_bins(c) for c in BINS] == list(NBINS)
    assert spikes.num_bins(0.2) == 8                 # 7.5 rounds to 8


@pytest.mark.parametrize("bad,err", [
    (torch.zeros(5), ValueError),                    # not (rows, F)
    (torch.zeros((2, 5), dtype=torch.int32), TypeError),
    (np.zeros((2, 5)), TypeError),
])
def test_spike_hist_rejects_what_the_kernel_does_not_take(bad, err):
    with pytest.raises(err):
        spike_hist_batch(bad, BINS, NBINS)


def test_spike_hist_rejects_bad_layouts():
    r = torch.zeros((2, 5), dtype=torch.float64)
    with pytest.raises(ValueError):
        spike_hist_batch(r, (0.1, 0.2), (15,))
    with pytest.raises(ValueError):
        spike_hist_batch(r, (0.0,), (15,))
    with pytest.raises(ValueError):
        spike_hist_batch(r, tuple([0.1] * 17), tuple([15] * 17))


def test_ema_scan_rejects_bad_inputs():
    with pytest.raises(TypeError):
        ema_scan_rows(torch.zeros(5, dtype=torch.float64))
    with pytest.raises(ValueError):
        ema_scan_rows(torch.zeros((2, 2, 2)))
    with pytest.raises(ValueError):
        ema_scan_rows(torch.zeros(5), alpha=0.0)


def test_cuda_request_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        spikes.ema_filter(np.ones(10))


# ---------------------------------------------------------------------------
# flash attention and RMSNorm (the serving path's kernels)
# ---------------------------------------------------------------------------
DTYPES = [(np.float32, torch.float32, jnp.float32),
          ("bfloat16", torch.bfloat16, jnp.bfloat16)]


def _tol(tdtype):
    """tests/test_kernels.py's tolerances: bf16 rounding of the output, or
    float32 rounding of a softmax / mean of squares."""
    return dict(rtol=2e-2, atol=2e-2) if tdtype == torch.bfloat16 \
        else dict(rtol=3e-5, atol=3e-5)


def _pair(a: np.ndarray, tdtype, jdtype):
    """The same values as a torch tensor and a jnp array of one dtype (the
    bf16 rounding done once, in torch, and carried over bit for bit)."""
    t = torch.from_numpy(a).to(tdtype)
    j = jnp.asarray(t.to(torch.float32).numpy()).astype(jdtype)
    return t, j


def _np(x) -> np.ndarray:
    return np.asarray(x.to(torch.float32) if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("b,sq,skv,H,KV,dh,causal", [
    (1, 128, 128, 4, 4, 64, True),      # MHA causal
    (2, 128, 128, 8, 2, 64, True),      # GQA 4:1
    (2, 64, 256, 8, 8, 128, False),     # cross-ish, bidirectional
    (1, 256, 256, 16, 2, 128, True),    # MQA-ish wide
])
@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
def test_plain_flash_attention_matches_pallas_interpret(b, sq, skv, H, KV,
                                                        dh, causal, dtypes):
    _, tdtype, jdtype = dtypes
    rng = np.random.default_rng(b * sq + H)
    q, qj = _pair(rng.standard_normal((b, sq, H, dh), np.float32), tdtype,
                  jdtype)
    k, kj = _pair(rng.standard_normal((b, skv, KV, dh), np.float32), tdtype,
                  jdtype)
    v, vj = _pair(rng.standard_normal((b, skv, KV, dh), np.float32), tdtype,
                  jdtype)
    got = flash_attention(q, k, v, causal=causal)
    assert got.dtype == tdtype and got.shape == (b, sq, H, dh)
    want = ref_ops.flash_attention(qj, kj, vj, causal=causal, block_q=64,
                                   block_k=64)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(tdtype))


@pytest.mark.parametrize("sq,skv,H,KV", [(64, 128, 8, 2), (1, 77, 4, 1),
                                         (30, 100, 6, 3)])
def test_plain_flash_attention_matches_ref_bottom_right_causal(sq, skv, H,
                                                               KV):
    """sq < skv: the mask is ref.py's bottom-right alignment (the cached
    prefill and decode mask), not the Pallas kernel's top-left one."""
    rng = np.random.default_rng(sq + skv)
    arrays = [rng.standard_normal(s, np.float32) for s in
              ((2, sq, H, 32), (2, skv, KV, 32), (2, skv, KV, 32))]
    got = flash_attention_plain(*map(torch.from_numpy, arrays), causal=True)
    want = ref_kernels.flash_attention_ref(*map(jnp.asarray, arrays),
                                           causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-5,
                               atol=3e-5)


def test_flash_attention_wrapper_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((1, 40, 4, 32), np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 40, 2, 32), np.float32))
    before = dict(build.LAUNCHES)
    assert torch.equal(flash_attention(q, k, k), flash_attention_plain(q, k, k))
    assert build.LAUNCHES == before      # no kernel launch on the CPU


@pytest.mark.parametrize("sq,skv,causal", [
    (100, 100, True),       # sq == skv
    (37, 300, True),        # sq < skv: bottom-right alignment
    (129, 131, True),       # ragged against 128-row blocks and tiles
    (1, 77, True),          # one query row
    (50, 70, False),        # bidirectional
])
def test_attn_work_counts_the_pairs_the_plain_mask_keeps(sq, skv, causal):
    """Equal scores and v = the identity: row i of the output is
    1 / n_i on each key the plain version's mask keeps, 0 elsewhere, so its
    nonzero count is the number of visible (query, key) pairs."""
    H, KV = 4, 2
    q = torch.zeros((2, sq, H, skv))
    k = torch.zeros((2, skv, KV, skv))
    v = torch.eye(skv).reshape(1, skv, 1, skv).expand(2, skv, KV, skv)
    kept = int((flash_attention_plain(q, k, v, causal=causal) > 0).sum())
    flops, nbytes = attn_work(2, sq, skv, H, KV, 128, 2, causal=causal)
    assert flops == 4.0 * 128 * kept            # kept counts b and H too
    assert nbytes == 2.0 * (2 * 2 * sq * H * 128 + 2 * 2 * skv * KV * 128)


def test_attn_work_refuses_causal_sq_above_skv():
    with pytest.raises(ValueError, match="sq <= skv"):
        attn_work(1, 10, 5, 4, 2, 64, 2)


@pytest.mark.parametrize("b,s,di,ds,xdtype,dtdtype,skip,with_h0", [
    (2, 33, 48, 16, torch.bfloat16, torch.float32, False, False),
    (1, 1, 64, 8, torch.float32, torch.bfloat16, True, True),
])
def test_scan_work_counts_the_plain_versions_tensors(b, s, di, ds, xdtype,
                                                     dtdtype, skip, with_h0):
    """bytes = the inputs' and outputs' nbytes as the plain version takes
    and returns them; exps = one per (step, channel, state)."""
    rng = np.random.default_rng(s)

    def f(*shape, dtype=torch.float32):
        return torch.from_numpy(rng.standard_normal(shape)).to(dtype)
    ins = [f(b, s, di, dtype=xdtype), f(b, s, di, dtype=dtdtype),
           -torch.exp(f(di, ds)), f(b, s, ds), f(b, s, ds),
           f(di) if skip else None, f(b, di, ds) if with_h0 else None]
    y, h = ssm_scan_plain(*ins)
    work = scan_work(b, s, di, ds, xdtype.itemsize, dtdtype.itemsize,
                     skip=skip, h0=with_h0)
    assert work["bytes"] == sum(t.nbytes for t in (*ins, y, h)
                                if t is not None)
    assert work["exps"] == b * s * di * ds
    assert work["flops"] == 6 * b * s * di * ds + b * s * di * (3 if skip
                                                                 else 1)


@pytest.mark.parametrize("args,err", [
    (((1, 8, 4, 32), (1, 8, 3, 32), (1, 8, 3, 32)), ValueError),  # 4 % 3
    (((1, 8, 4, 32), (1, 4, 2, 32), (1, 4, 2, 32)), ValueError),  # sq > skv
    (((1, 8, 4, 32), (1, 8, 2, 16), (1, 8, 2, 16)), ValueError),  # dh
    (((8, 4, 32), (1, 8, 2, 32), (1, 8, 2, 32)), ValueError),     # rank
])
def test_flash_attention_rejects_what_it_does_not_take(args, err):
    with pytest.raises(err):
        flash_attention(*(torch.zeros(s) for s in args), causal=True)
    with pytest.raises(TypeError):
        flash_attention(torch.zeros((1, 8, 4, 32)),
                        torch.zeros((1, 8, 2, 32), dtype=torch.bfloat16),
                        torch.zeros((1, 8, 2, 32)))


@pytest.mark.parametrize("n,d", [(8, 128), (64, 512), (100, 384)])
@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
def test_plain_rmsnorm_matches_pallas_interpret(n, d, dtypes):
    _, tdtype, jdtype = dtypes
    rng = np.random.default_rng(n + d)
    x, xj = _pair(rng.standard_normal((n, d), np.float32), tdtype, jdtype)
    sc = rng.standard_normal(d).astype(np.float32)
    got = rmsnorm(x, torch.from_numpy(sc))
    assert got.dtype == tdtype
    want = ref_ops.rmsnorm(xj, jnp.asarray(sc))
    np.testing.assert_allclose(_np(got), _np(want), **_tol(tdtype))
    # leading dims are flattened, as ops.rmsnorm does
    x3 = x.reshape(2, n // 2, d)
    assert torch.equal(rmsnorm(x3, torch.from_numpy(sc)).reshape(n, d), got)


@pytest.mark.parametrize("n,d", [(4, 4096), (1, 4096), (7, 100), (3, 1),
                                 (5, 257)])
@pytest.mark.parametrize("pdl", [False, True])
def test_rmsnorm_pdl_on_cpu_is_the_plain_version(n, d, pdl):
    """ops.rmsnorm with or without pdl= (a launch option of the kernel) is
    the plain version on CPU tensors, and agrees with the reference's
    rmsnorm_ref; the decode rows (4, 4096) and (1, 4096) are served."""
    from repro_torch.kernels import ops
    rng = np.random.default_rng(n * d)
    x = rng.standard_normal((n, d), np.float32) * 3
    sc = rng.standard_normal(d).astype(np.float32)
    got = ops.rmsnorm(torch.from_numpy(x), torch.from_numpy(sc), pdl=pdl)
    assert torch.equal(got, rmsnorm_plain(torch.from_numpy(x),
                                          torch.from_numpy(sc)))
    want = ref_kernels.rmsnorm_ref(jnp.asarray(x), jnp.asarray(sc))
    np.testing.assert_allclose(_np(got), _np(want), **_tol(torch.float32))


def test_norm_layer_launches_rmsnorm_with_pdl(monkeypatch):
    """Norm's scale is a weight that no kernel of the step writes, so Norm
    (and only the rmsnorm kind) asks for programmatic dependent launch."""
    from repro_torch.kernels import ops
    from repro_torch.models.layers import Norm
    seen = []
    real = ops.rmsnorm

    def spy(x, scale, eps=1e-5, **kw):
        seen.append(kw)
        return real(x, scale, eps, **kw)
    monkeypatch.setattr(ops, "rmsnorm", spy)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 3, 16), np.float32))
    norm = Norm("n", 16, device="cpu")
    norm.scale.copy_(torch.linspace(0.5, 1.5, 16))
    y = norm(x)
    assert seen == [{"pdl": True}]
    assert torch.equal(y, rmsnorm_plain(x.reshape(-1, 16),
                                        norm.scale).reshape(x.shape))
    Norm("ln", 16, kind="layernorm", device="cpu")(x)
    assert len(seen) == 1


def test_rmsnorm_wrapper_rejects_bad_inputs():
    with pytest.raises(ValueError):
        rmsnorm(torch.zeros((4, 8)), torch.ones(7))
    with pytest.raises(TypeError):
        rmsnorm(torch.zeros((4, 8), dtype=torch.float64), torch.ones(8))
    x = torch.ones((3, 8), dtype=torch.bfloat16)
    assert torch.equal(rmsnorm(x, torch.ones(8, dtype=torch.bfloat16)),
                       rmsnorm_plain(x, torch.ones(8)))
