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
from repro.kernels.ema_scan import ema_scan_pallas
from repro.kernels.spike_hist import spike_hist_batch_pallas
from repro_torch.core import spikes
from repro_torch.kernels import (build, ema_scan, ema_scan_plain,
                                 ema_scan_rows, spike_hist, spike_hist_batch,
                                 spike_hist_batch_plain)

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
