"""The port's seed loops (``repro_torch.legacy``) and its engine held to them.

Two layers:

* **copy** — each function of ``repro_torch.legacy`` equals its
  ``repro.legacy`` counterpart on the same seeded inputs: the busy counter
  and the kmeans++ draws bit for bit, everything else within 1e-12 (the
  silhouette loop on the reference's distance matrix; on the port's own
  within that matrix's ~3e-9 error);
* **golden** — ``tests/test_profiling_engine.py``'s cases, case for case,
  on the port: its vectorized engine (``integrate_events`` / ``simulate``,
  ``ema_filter``, the batched neighbours, ``choose_bin_size``,
  ``linkage``, ``silhouette_score``, ``kmeanspp_init``) equals its own
  seed loops within 1e-9 (the busy counter exactly), and the EMA and
  histogram kernels' wrappers, which run their plain twins on the CPU,
  agree with the loops at that file's tolerances.
"""
import numpy as np
import pytest
import torch

from repro import legacy as ref_legacy
from repro.core.classify import FreqPoint as RefFreqPoint
from repro.core.classify import WorkloadProfile as RefWorkloadProfile
from repro.telemetry import TPUPowerModel as RefPowerModel
from repro.telemetry.kernel_stream import micro_gemm as ref_micro_gemm
from repro.telemetry.kernel_stream import \
    micro_idle_burst as ref_micro_idle_burst
from repro_torch import legacy
from repro_torch.core import spikes
from repro_torch.core.algorithm1 import choose_bin_size, select_optimal_freq
from repro_torch.core.classify import (FreqPoint, MinosClassifier,
                                       WorkloadProfile)
from repro_torch.core.clustering import (cosine_distance_matrix,
                                         kmeanspp_init, linkage,
                                         silhouette_score)
from repro_torch.kernels.ema_scan import ema_scan_blocks
from repro_torch.kernels.ops import ema_scan
from repro_torch.kernels.spike_hist import spike_hist_batch
from repro_torch.telemetry import TPUPowerModel, simulate
from repro_torch.telemetry.kernel_stream import micro_gemm, micro_idle_burst
from repro_torch.telemetry.simulator import integrate_events

CPU = "cpu"
TDP = 200.0
FREQS = [0.6, 0.8, 1.0]
EXACT = dict(rtol=1e-12, atol=1e-12)
GOLDEN = dict(rtol=1e-9, atol=1e-9)


def _profiles(name, level, sm, dram):
    """One seeded profile in both packages (the port's trace a CPU tensor)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    trace = rng.normal(level * TDP, 9.0, 700)
    out = []
    for fp_cls, wp_cls, tr in ((RefFreqPoint, RefWorkloadProfile, trace),
                               (FreqPoint, WorkloadProfile,
                                torch.from_numpy(trace))):
        scaling = {f: fp_cls(freq=f, p90=level * f, p95=level * f + 0.03,
                             p99=level * f + 0.07,
                             mean_power=level * f - 0.1, exec_time=1.0 / f)
                   for f in FREQS}
        out.append(wp_cls(name=name, tdp=TDP, power_trace=tr, sm_util=sm,
                          dram_util=dram, exec_time=1.0, scaling=scaling))
    return out


REFS = (("gemm", 1.3, 0.95, 0.15), ("spmv", 0.7, 0.10, 0.90),
        ("hybrid", 1.05, 0.55, 0.50), ("stencil", 0.9, 0.40, 0.70),
        ("idle-burst", 1.5, 0.30, 0.20))
TARGETS = (("t-compute", 1.28, 0.9, 0.2), ("t-mem", 0.72, 0.15, 0.85),
           ("t1", 1.0, 0.93, 0.18), ("t2", 1.0, 0.2, 0.8))


@pytest.fixture(scope="module")
def zoo():
    """(reference refs, port refs, reference targets, port targets)."""
    refs = [_profiles(*r) for r in REFS]
    targets = [_profiles(*t) for t in TARGETS]
    return ([r[0] for r in refs], [r[1] for r in refs],
            [t[0] for t in targets] + [r[0] for r in refs],
            [t[1] for t in targets] + [r[1] for r in refs])


# ---------------------------------------------------------------------------
# copy: repro_torch.legacy == repro.legacy
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_events", [1, 7, 300])
def test_integrate_events_dense_equals_reference(n_events):
    rng = np.random.default_rng(n_events)
    t0 = rng.uniform(0.0, 3.0, n_events)
    t1 = t0 + rng.uniform(1e-6, 0.5, n_events)
    pw = rng.uniform(-50.0, 400.0, n_events)
    edges = np.arange(0, 3500) * 1e-3
    np.testing.assert_array_equal(
        legacy.integrate_events_dense(t0, t1, pw, edges),
        ref_legacy.integrate_events_dense(t0, t1, pw, edges))


@pytest.mark.parametrize("which,freq", [("gemm", 1.0), ("gemm", 0.6),
                                        ("idle", 1.0)])
def test_simulate_dense_equals_reference(which, freq):
    port_fn, ref_fn = {"gemm": (micro_gemm, ref_micro_gemm),
                       "idle": (micro_idle_burst, ref_micro_idle_burst)}[which]
    a = legacy.simulate_dense(port_fn(), freq, TPUPowerModel(), seed=11,
                              target_duration=1.0)
    b = ref_legacy.simulate_dense(ref_fn(), freq, RefPowerModel(), seed=11,
                                  target_duration=1.0)
    np.testing.assert_array_equal(a.busy, b.busy)            # bit for bit
    np.testing.assert_allclose(a.power_raw, b.power_raw, **EXACT)
    np.testing.assert_allclose(a.power_filtered, b.power_filtered, **EXACT)
    assert (a.exec_time, a.app_sm_util, a.app_dram_util, a.sample_dt) == \
        (b.exec_time, b.app_sm_util, b.app_dram_util, b.sample_dt)
    assert a.kernel_rows == b.kernel_rows


@pytest.mark.parametrize("n", [0, 1, 2, 100, 4099])
@pytest.mark.parametrize("alpha", [0.5, 0.1, 0.9])
def test_ema_filter_loop_equals_reference(n, alpha):
    x = np.random.default_rng(n).uniform(40.0, 600.0, n)
    np.testing.assert_array_equal(legacy.ema_filter_loop(x, alpha),
                                  ref_legacy.ema_filter_loop(x, alpha))


@pytest.mark.parametrize("bin_size", [0.05, 0.1, 0.25])
def test_neighbor_loops_equal_reference(zoo, bin_size):
    rrefs, prefs, rtargets, ptargets = zoo
    for rt, pt in zip(rtargets, ptargets):
        for exclude in (None, "gemm"):
            nn_r, d_r = ref_legacy.power_neighbor_loop(rrefs, rt, bin_size,
                                                       exclude=exclude)
            nn_p, d_p = legacy.power_neighbor_loop(prefs, pt, bin_size,
                                                   exclude=exclude)
            assert nn_p.name == nn_r.name
            assert d_p == pytest.approx(d_r, rel=1e-12, abs=1e-12)
            nn_r, d_r = ref_legacy.util_neighbor_loop(rrefs, rt, exclude)
            nn_p, d_p = legacy.util_neighbor_loop(prefs, pt, exclude)
            assert nn_p.name == nn_r.name
            assert d_p == pytest.approx(d_r, rel=1e-12, abs=1e-12)


def test_choose_bin_size_loop_equals_reference(zoo):
    rrefs, prefs, rtargets, ptargets = zoo
    for cands in ((0.05, 0.1, 0.15, 0.25), (0.05, 0.1, 0.15, 0.2, 0.25, 0.5)):
        for rt, pt in zip(rtargets, ptargets):
            assert legacy.choose_bin_size_loop(pt, prefs, cands) == \
                ref_legacy.choose_bin_size_loop(rt, rrefs, cands)


@pytest.mark.parametrize("method", ["ward", "average", "complete", "single"])
@pytest.mark.parametrize("n", [2, 5, 18])
def test_linkage_loop_equals_reference(method, n):
    X = np.abs(np.random.default_rng(n).normal(size=(n, 6))) + 0.05
    D = cosine_distance_matrix(X).numpy()
    np.testing.assert_allclose(legacy.linkage_loop(D, method),
                               ref_legacy.linkage_loop(D, method), **EXACT)


def _silhouette_cases():
    rng = np.random.default_rng(5)
    for _ in range(20):
        n = int(rng.integers(3, 40))
        X = rng.normal(size=(n, 3))
        yield X, rng.integers(0, 4, size=n) * 7 - 3   # non-contiguous labels


def test_silhouette_loop_equals_reference(monkeypatch):
    """The loop is the reference's: on the reference's distance matrix it
    gives the reference's value.  On its own (the port's distances, exact
    where the reference's NumPy expansion carries up to ~3e-9 of error, as
    ``test_torch_clustering.py`` finds) it stays within that error."""
    import repro.core.clustering as ref_clustering
    import repro_torch.core.clustering as clustering
    own = [legacy.silhouette_loop(X, labels)
           for X, labels in _silhouette_cases()]
    monkeypatch.setattr(clustering, "euclidean_distance_matrix",
                        ref_clustering.euclidean_distance_matrix)
    for (X, labels), got in zip(_silhouette_cases(), own):
        want = ref_legacy.silhouette_loop(X, labels)
        assert legacy.silhouette_loop(X, labels) == pytest.approx(
            want, rel=1e-12, abs=1e-12)
        assert got == pytest.approx(want, abs=1e-8)
    assert legacy.silhouette_loop(X[:2], np.array([0, 1])) == 0.0
    assert legacy.silhouette_loop(X, np.zeros(len(X), np.int64)) == 0.0


def test_kmeanspp_init_loop_equals_reference():
    rng = np.random.default_rng(9)
    for seed in range(10):
        n = int(rng.integers(4, 30))
        X = rng.normal(size=(n, 2))
        k = int(rng.integers(2, min(6, n + 1)))
        np.testing.assert_array_equal(
            legacy.kmeanspp_init_loop(X, k, np.random.default_rng(seed)),
            ref_legacy.kmeanspp_init_loop(X, k, np.random.default_rng(seed)))
    Z = np.ones((6, 2))
    np.testing.assert_array_equal(
        legacy.kmeanspp_init_loop(Z, 3, np.random.default_rng(1)),
        ref_legacy.kmeanspp_init_loop(Z, 3, np.random.default_rng(1)))


# ---------------------------------------------------------------------------
# golden: the port's engine == the port's seed loops
# ---------------------------------------------------------------------------
def test_integrate_events_matches_dense():
    rng = np.random.default_rng(0)
    for n_events in (1, 7, 300):
        t0 = rng.uniform(0.0, 3.0, n_events)
        t1 = t0 + rng.uniform(1e-6, 0.5, n_events)
        pw = rng.uniform(-50.0, 400.0, n_events)
        edges = np.arange(0, 3500) * 1e-3
        np.testing.assert_allclose(
            integrate_events(t0, t1, pw, edges),
            legacy.integrate_events_dense(t0, t1, pw, edges), **GOLDEN)


def test_integrate_events_empty_and_coincident():
    edges = np.linspace(0, 1, 11)
    assert np.all(integrate_events(np.array([]), np.array([]),
                                   np.array([]), edges) == 0)
    t0 = np.array([0.2, 0.2])
    t1 = np.array([0.6, 0.6])
    pw = np.array([10.0, 5.0])
    np.testing.assert_allclose(integrate_events(t0, t1, pw, edges),
                               legacy.integrate_events_dense(t0, t1, pw,
                                                             edges), **EXACT)


@pytest.mark.parametrize("stream_fn,freq", [(micro_gemm, 1.0),
                                            (micro_gemm, 0.6),
                                            (micro_idle_burst, 1.0)])
def test_simulate_matches_seed(stream_fn, freq):
    model = TPUPowerModel()
    a = simulate(stream_fn(), freq, model, seed=11, target_duration=1.0)
    b = legacy.simulate_dense(stream_fn(), freq, model, seed=11,
                              target_duration=1.0)
    np.testing.assert_allclose(a.power_raw, b.power_raw, **GOLDEN)
    np.testing.assert_allclose(a.power_filtered, b.power_filtered, **GOLDEN)
    np.testing.assert_array_equal(a.busy, b.busy)
    assert a.exec_time == b.exec_time
    assert a.app_sm_util == b.app_sm_util


@pytest.mark.parametrize("n", [1, 2, 100, 4099, 20000])
@pytest.mark.parametrize("alpha", [0.5, 0.1, 0.9])
@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_ema_vectorized_matches_loop(n, alpha, backend):
    x = np.random.default_rng(n).uniform(40.0, 600.0, n)
    got = spikes.ema_filter(x, alpha, backend=backend, device=CPU)
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, legacy.ema_filter_loop(x, alpha),
                               **GOLDEN)


def test_ema_kernels_match_loop_on_their_plain_twins():
    """The float32 EMA wrapper within ``test_profiling_engine``'s kernel
    tolerance, the engine's float64 blocked EMA within 1e-9 (the CPU runs
    each wrapper's plain twin; ``chip_smoke.py`` holds the kernels)."""
    x = np.random.default_rng(3).uniform(40.0, 600.0, 3000)
    want = legacy.ema_filter_loop(x, 0.5)
    np.testing.assert_allclose(ema_scan(torch.from_numpy(x), 0.5).numpy(),
                               want, rtol=2e-4, atol=2e-3)
    np.testing.assert_allclose(
        ema_scan_blocks(torch.from_numpy(x), alpha=0.5).numpy(), want,
        **GOLDEN)


@pytest.mark.parametrize("n", [96 * 128, 1280, 130, 125 * 128, 250 * 128])
def test_spike_hist_counts_every_sample_once(n):
    """Row lengths that fill no block evenly: every sample >= 0.5 lands in
    exactly one bin (the top bin takes what lies past the range)."""
    p = np.random.default_rng(n).uniform(0.4, 2.2, n).astype(np.float32)
    got = spike_hist_batch(torch.from_numpy(p)[None, :], (0.1,), (15,))
    assert int(got.sum()) == int(np.sum(p >= np.float32(0.5)))


def test_batched_power_neighbors_match_loop(zoo):
    _, prefs, _, ptargets = zoo
    clf = MinosClassifier(prefs, device=CPU)
    for c in (0.05, 0.1, 0.25):
        got = clf.power_neighbors(ptargets, bin_size=c)
        for t, (nn, d) in zip(ptargets, got):
            nn_ref, d_ref = legacy.power_neighbor_loop(prefs, t, bin_size=c)
            assert nn.name == nn_ref.name
            assert d == pytest.approx(d_ref, abs=1e-9)


def test_batched_util_neighbors_match_loop(zoo):
    _, prefs, _, ptargets = zoo
    clf = MinosClassifier(prefs, device=CPU)
    for t, (nn, d) in zip(ptargets, clf.util_neighbors(ptargets)):
        nn_ref, d_ref = legacy.util_neighbor_loop(prefs, t)
        assert nn.name == nn_ref.name
        assert d == pytest.approx(d_ref, abs=1e-9)


def test_neighbor_exclude_param(zoo):
    _, prefs, _, ptargets = zoo
    clf = MinosClassifier(prefs, device=CPU)
    target = ptargets[0]
    nn_all, _ = clf.power_neighbor(target)
    nn_excl, _ = clf.power_neighbor(target, exclude=nn_all.name)
    assert nn_excl.name != nn_all.name
    want, _ = legacy.power_neighbor_loop(prefs, target, 0.1,
                                         exclude=nn_all.name)
    assert nn_excl.name == want.name


def test_choose_bin_size_matches_seed_loop(zoo):
    _, prefs, _, ptargets = zoo
    clf = MinosClassifier(prefs, device=CPU)
    cands = (0.05, 0.1, 0.15, 0.25)
    for t in ptargets[:2]:
        assert choose_bin_size(t, clf, cands) == \
            legacy.choose_bin_size_loop(t, prefs, cands)
        sel = select_optimal_freq(t, clf, cands)
        nn, _ = legacy.power_neighbor_loop(prefs, t, bin_size=sel.bin_size)
        assert sel.power_neighbor == nn.name


@pytest.mark.parametrize("method", ["ward", "average", "complete", "single"])
@pytest.mark.parametrize("n", [2, 5, 18])
def test_linkage_matches_loop(method, n):
    X = np.abs(np.random.default_rng(n).normal(size=(n, 6))) + 0.05
    D = cosine_distance_matrix(X)
    np.testing.assert_allclose(linkage(D, method),
                               legacy.linkage_loop(D.numpy(), method),
                               **GOLDEN)


def test_silhouette_matches_loop():
    for X, labels in _silhouette_cases():
        assert silhouette_score(X, labels, device=CPU) == \
            pytest.approx(legacy.silhouette_loop(X, labels), abs=1e-9)
    # degenerate inputs take the same early exit
    assert silhouette_score(X[:2], np.array([0, 1]), device=CPU) == 0.0
    assert silhouette_score(X, np.zeros(len(X), np.int64), device=CPU) == 0.0


def test_kmeanspp_init_matches_loop_rng_stream():
    rng = np.random.default_rng(9)
    for seed in range(10):
        n = int(rng.integers(4, 30))
        X = rng.normal(size=(n, 2))
        k = int(rng.integers(2, min(6, n + 1)))
        np.testing.assert_array_equal(
            kmeanspp_init(X, k, np.random.default_rng(seed)),
            legacy.kmeanspp_init_loop(X, k, np.random.default_rng(seed)))
    Z = np.ones((6, 2))
    np.testing.assert_array_equal(
        kmeanspp_init(Z, 3, np.random.default_rng(1)),
        legacy.kmeanspp_init_loop(Z, 3, np.random.default_rng(1)))
