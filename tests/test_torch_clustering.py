"""The port's K-Means, silhouette, Mahalanobis distances, dendrogram order
and baselines (``repro_torch.core``) against the reference (``repro.core``)
on the CPU.

K-Means is held bitwise: kmeans++ draws, and every restart's centres,
labels and inertia equal the reference's float32 Lloyd (an XLA compile on
the CPU, which fuses each distance's sum of squares into multiply-adds and
sums more than 32 rows by windows; the port follows both).  The
silhouette is held to the exact value (long double) within 1e-12: the
reference's distance matrix carries up to ~1e-8 on its diagonal (NumPy's
row norms against a BLAS product), which moves its scores by up to ~3e-9,
so the port is held to the reference within 1e-8.
"""
import numpy as np
import pytest
import torch

from repro.core import baselines as ref_baselines
from repro.core import clustering as ref_clustering
from repro.core.classify import MinosClassifier as RefClassifier
from repro.pipeline import stream_profile_once as ref_once
from repro.telemetry import TPUPowerModel as RefModel
from repro.telemetry import workloads as ref_workloads
from repro_torch.core import baselines, clustering
from repro_torch.core.classify import MinosClassifier
from repro_torch.pipeline import stream_profile_once
from repro_torch.telemetry import TPUPowerModel
from repro_torch.telemetry import workloads

CPU = "cpu"
EXACT_TOL = 1e-12
REF_SILHOUETTE_TOL = 1e-8
# (seed, rows, features): up to 32 rows the reference sums in one run,
# beyond that by windows of 32
CASES = [(0, 28, 2), (1, 12, 3), (2, 33, 2), (3, 51, 4), (4, 64, 5),
         (5, 90, 2), (6, 7, 2)]


def _data(seed, n, d):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, d)) * rng.uniform(0.1, 3.0)


def _exact_silhouette(X, labels) -> float:
    """Silhouette in long double, point by point (the definition)."""
    X = np.asarray(X, np.longdouble)
    _, inv = np.unique(labels, return_inverse=True)
    D = np.sqrt(((X[:, None, :] - X[None, :, :]) ** 2).sum(-1))
    s = []
    for i in range(len(X)):
        own = inv == inv[i]
        if own.sum() <= 1:
            s.append(np.longdouble(0))
            continue
        a = D[i, own].sum() / (own.sum() - 1)
        b = min(D[i, inv == c].mean() for c in set(inv.tolist()) - {inv[i]})
        mx = max(a, b)
        s.append((b - a) / mx if mx > 0 else np.longdouble(0))
    return float(np.mean(np.array(s, np.longdouble)))


@pytest.fixture(scope="module")
def zoo_profiles():
    """Short profiles of the 28 reference workloads in both packages (the
    utilization points K-Means classifies in the paper's Fig. 4)."""
    rm, tm = RefModel(), TPUPowerModel()
    ref = [ref_once(s, rm, rm.spec.tdp_w, seed=i, target_duration=0.2)
           for i, s in enumerate(ref_workloads.reference_streams())]
    port = [stream_profile_once(s, tm, tm.spec.tdp_w, seed=i,
                                target_duration=0.2, device=CPU)
            for i, s in enumerate(workloads.reference_streams())]
    return ref, port


@pytest.mark.parametrize("seed,n,d", CASES)
def test_kmeanspp_init_draws_equal(seed, n, d):
    X = _data(seed, n, d)
    for k in (2, 3, min(6, n - 1)):
        ra, rb = np.random.default_rng(seed), np.random.default_rng(seed)
        for _ in range(3):               # consecutive draws share the stream
            np.testing.assert_array_equal(
                ref_clustering.kmeanspp_init(X, k, ra),
                clustering.kmeanspp_init(torch.from_numpy(X), k, rb))
        assert ra.integers(1 << 30) == rb.integers(1 << 30)


@pytest.mark.parametrize("seed,n,d", CASES)
def test_kmeans_matches_reference_lloyd(seed, n, d):
    """Every restart's centres, labels and inertia, and the kept restart,
    bitwise equal to the reference's float32 Lloyd."""
    import jax.numpy as jnp
    X = _data(seed, n, d)
    for k in (2, 3, min(5, n - 1)):
        rng = np.random.default_rng(seed)
        inits = np.stack([ref_clustering.kmeanspp_init(X, k, rng)
                          for _ in range(4)])
        cb, lb, ib = clustering._lloyd(
            torch.tensor(X, dtype=torch.float32),
            torch.tensor(inits, dtype=torch.float32), k, 50)
        for r, init in enumerate(inits):
            ca, la, ia = ref_clustering._lloyd(jnp.asarray(X),
                                               jnp.asarray(init), k, 50)
            np.testing.assert_array_equal(np.asarray(ca), cb[r].numpy())
            np.testing.assert_array_equal(np.asarray(la), lb[r].numpy())
            assert float(ia) == float(ib[r]), (k, r)
        ca, la, ia = ref_clustering.kmeans(X, k, seed=seed)
        cp, lp, ip = clustering.kmeans(X, k, seed=seed, device=CPU)
        assert cp.dtype == np.float32
        np.testing.assert_array_equal(np.asarray(ca), cp)
        np.testing.assert_array_equal(np.asarray(la), lp)
        assert ia == ip


@pytest.mark.parametrize("seed,n,d", CASES)
def test_silhouette_score_exact_and_near_reference(seed, n, d):
    X = _data(seed, n, d)
    for k in (2, 3, 4):
        labels = np.random.default_rng(seed + k).integers(0, k, n)
        got = clustering.silhouette_score(X, labels, device=CPU)
        assert abs(got - _exact_silhouette(X, labels)) <= EXACT_TOL
        ref = ref_clustering.silhouette_score(X, labels)
        assert abs(got - ref) <= REF_SILHOUETTE_TOL
    # the degenerate cases return 0.0 in both packages
    one = np.zeros(n, np.int64)
    assert clustering.silhouette_score(X, one, device=CPU) == 0.0 \
        == ref_clustering.silhouette_score(X, one)
    assert clustering.silhouette_score(X[:2], [0, 1], device=CPU) == 0.0 \
        == ref_clustering.silhouette_score(X[:2], [0, 1])


@pytest.mark.parametrize("seed,n,d", CASES[:4])
def test_best_k_by_silhouette_matches_reference(seed, n, d):
    X = _data(seed, n, d)
    ka, sa = ref_clustering.best_k_by_silhouette(X, k_range=range(2, 9),
                                                 seed=seed)
    kb, sb = clustering.best_k_by_silhouette(X, k_range=range(2, 9),
                                             seed=seed, device=CPU)
    assert ka == kb and list(sa) == list(sb)
    for k in sa:
        assert abs(sa[k] - sb[k]) <= REF_SILHOUETTE_TOL


def test_util_classes_match_reference(zoo_profiles):
    """The paper's Fig. 4 sweep on the 28 workloads' utilization points:
    the same k, labels and float32 centres; then at a fixed k."""
    ref, port = zoo_profiles
    a = RefClassifier(ref)
    b = MinosClassifier(port, device=CPU)
    np.testing.assert_array_equal(a.util_matrix(), b.util_matrix().numpy())
    la, ca, ka, sa = a.util_classes()
    lb, cb, kb, sb = b.util_classes()
    assert ka == kb and list(sa) == list(sb)
    np.testing.assert_array_equal(np.asarray(la), lb)
    np.testing.assert_array_equal(np.asarray(ca), cb)
    for k in sa:
        assert abs(sa[k] - sb[k]) <= REF_SILHOUETTE_TOL
    la, ca, _, none = a.util_classes(k=3, seed=5)
    lb, cb, kb, _ = b.util_classes(k=3, seed=5)
    assert none is None and kb == 3
    np.testing.assert_array_equal(np.asarray(la), lb)
    np.testing.assert_array_equal(np.asarray(ca), cb)


@pytest.mark.parametrize("seed,n,d", CASES)
def test_mahalanobis_distance_matrix_matches_reference(seed, n, d):
    X = _data(seed, n, d)
    want = ref_clustering.mahalanobis_distance_matrix(X)
    got = clustering.mahalanobis_distance_matrix(X)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=EXACT_TOL)


@pytest.mark.parametrize("method", ["ward", "average", "single"])
def test_dendrogram_order_matches_reference(method):
    V = np.abs(_data(7, 40, 6)) + 0.01
    Z = ref_clustering.linkage(ref_clustering.cosine_distance_matrix(V),
                               method)
    order = clustering.dendrogram_order(Z)
    assert order == ref_clustering.dendrogram_order(Z)
    assert sorted(order) == list(range(40))


def test_baselines_match_reference(zoo_profiles):
    """Hold-one-out neighbours of every workload under both baselines, with
    and without an extra exclusion; the all-excluded ValueError."""
    ref, port = zoo_profiles
    for pick_a, pick_b in ((ref_baselines.mean_power_neighbor,
                            baselines.mean_power_neighbor),
                           (ref_baselines.util_only_neighbor,
                            baselines.util_only_neighbor)):
        for ta, tb in zip(ref, port):
            for exclude in (None, ref[0].name):
                if ta.name == exclude:
                    continue
                (na, da), (nb, db) = (pick_a(ta, ref, exclude),
                                      pick_b(tb, port, exclude))
                assert na.name == nb.name
                assert abs(da - db) <= EXACT_TOL
        for refs, target, pick in ((ref[:1], ref[0], pick_a),
                                   (port[:1], port[0], pick_b),
                                   (port[:2], port[0], pick_b)):
            exclude = refs[-1].name
            with pytest.raises(ValueError, match="no eligible reference"):
                pick(target, refs, exclude=exclude)


def test_kmeans_requires_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    X = _data(0, 10, 2)
    for call in (lambda: clustering.kmeans(X, 3),
                 lambda: clustering.silhouette_score(X, [0, 1] * 5),
                 lambda: clustering.best_k_by_silhouette(X)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


@pytest.fixture(scope="module")
def micro_libraries():
    """The micro zoo's five-workload library in both packages."""
    from repro.pipeline import ReferenceLibrary as RefLibrary
    from repro.pipeline import stream_profile_workload as ref_workload
    from repro.telemetry import kernel_stream as rks
    from repro_torch.pipeline import ReferenceLibrary, stream_profile_workload
    from repro_torch.telemetry import kernel_stream as tks
    names = ("micro_gemm", "micro_spmv_memory", "micro_spmv_compute",
             "micro_idle_burst", "micro_stencil")
    rm, tm = RefModel(), TPUPowerModel()
    ref = RefLibrary((ref_workload(getattr(rks, n)(), rm, (0.6, 0.8, 1.0),
                                   rm.spec.tdp_w, seed=i,
                                   target_duration=0.5)
                      for i, n in enumerate(names)), built_on=rm.spec.name)
    port = ReferenceLibrary((stream_profile_workload(
        getattr(tks, n)(), tm, (0.6, 0.8, 1.0), tm.spec.tdp_w, seed=i,
        target_duration=0.5, device=CPU) for i, n in enumerate(names)),
        built_on=tm.spec.name, device=CPU)
    return ref, port


@pytest.mark.parametrize("bench,table", [
    ("bench_classification", "classification_tables"),
    ("bench_holdout", "holdout_table"),
    ("bench_baseline_cmp", "baseline_table")])
def test_chip_smoke_tables_match_reference_benches(micro_libraries, bench,
                                                   table, tmp_path,
                                                   monkeypatch):
    """``chip_smoke.py``'s ports of the classification, holdout and
    baseline benches give the reference benches' json on one library."""
    import importlib
    import os
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    try:
        mod = importlib.import_module(f"benchmarks.{bench}")
        import chip_smoke
    finally:
        sys.path.remove(root)
    ref, port = micro_libraries
    monkeypatch.setattr(mod, "reference_library", lambda: ref)
    monkeypatch.setattr(mod, "RESULTS", str(tmp_path))
    want = mod.run()
    got = getattr(chip_smoke, table)(port)
    assert got == want
