"""Port classifier, clustering and Algorithm 1 (``repro_torch.core``)
against the reference (``repro.core``) on the CPU.

Neighbours, bin sizes and caps must be identical.  Distances agree to
1e-12: the port accumulates norms and dot products over the bins in a fixed
column order (batch-invariant on any device), NumPy's einsum and pairwise
sums in another, so the last bits may differ.
"""
import numpy as np
import pytest
import torch

from repro.core import clustering as ref_clustering
from repro.core.algorithm1 import select_optimal_freq as ref_select
from repro.core.classify import MinosClassifier as RefClassifier
from repro.pipeline import ReferenceLibrary as RefLibrary
from repro.pipeline import stream_profile_once as ref_once
from repro.pipeline import stream_profile_workload as ref_profile_workload
from repro.pipeline.online import classify_with_margin as ref_margin
from repro.pipeline.online import classify_with_margin_batch as ref_margin_b
from repro.telemetry import TPUPowerModel as RefModel
from repro.telemetry import kernel_stream as rks
from repro_torch.core import clustering
from repro_torch.core.algorithm1 import select_optimal_freq
from repro_torch.core.classify import (MinosClassifier, WorkloadProfile,
                                       _cosine_distances,
                                       count_classifier_calls)
from repro_torch.pipeline import (ReferenceLibrary, stream_profile_once,
                                  stream_profile_workload)
from repro_torch.pipeline.online import (classify_with_margin,
                                         classify_with_margin_batch)
from repro_torch.telemetry import TPUPowerModel
from repro_torch.telemetry import kernel_stream as tks

FREQS = (0.6, 0.8, 1.0)
CPU = "cpu"
NAMES = ("micro_gemm", "micro_idle_burst", "micro_spmv_memory",
         "micro_spmv_compute", "micro_stencil")


@pytest.fixture(scope="module")
def pair():
    """The same five-workload library built by both packages, plus targets
    (short profiles of the held-out vector-search stream and of the zoo)."""
    rm, tm = RefModel(), TPUPowerModel()
    ref = RefLibrary((ref_profile_workload(getattr(rks, n)(), rm, FREQS,
                                           rm.spec.tdp_w, seed=i,
                                           target_duration=0.6)
                      for i, n in enumerate(NAMES)), built_on=rm.spec.name)
    port = ReferenceLibrary((stream_profile_workload(
        getattr(tks, n)(), tm, FREQS, tm.spec.tdp_w, seed=i,
        target_duration=0.6, device=CPU) for i, n in enumerate(NAMES)),
        built_on=tm.spec.name, device=CPU)
    targets = [(ref_once(getattr(rks, n)(), rm, rm.spec.tdp_w, seed=50 + i,
                         target_duration=0.3),
                stream_profile_once(getattr(tks, n)(), tm, tm.spec.tdp_w,
                                    seed=50 + i, target_duration=0.3,
                                    device=CPU))
               for i, n in enumerate(NAMES + ("micro_vector_search",))]
    return ref, port, targets


@pytest.mark.parametrize("bin_size", [0.05, 0.1, 0.15, 0.2, 0.25, 0.5])
def test_hold_one_out_neighbours_identical(pair, bin_size):
    ref, port, _ = pair
    a, b = ref.classifier(), port.classifier()
    ra = a.power_neighbors(a.references, bin_size=bin_size)
    rb = b.power_neighbors(b.references, bin_size=bin_size)
    assert [r.name for r, _ in ra] == [r.name for r, _ in rb]
    np.testing.assert_allclose([d for _, d in ra], [d for _, d in rb],
                               rtol=0, atol=1e-12)
    ua, ub = a.util_neighbors(a.references), b.util_neighbors(b.references)
    assert [(r.name, d) for r, d in ua] == [(r.name, d) for r, d in ub]


def test_target_neighbours_caps_and_margins_identical(pair):
    ref, port, targets = pair
    a, b = ref.classifier(), port.classifier()
    for ta, tb in targets:
        sa, sb = ref_select(ta, a), select_optimal_freq(tb, b)
        assert (sa.bin_size, sa.power_neighbor, sa.util_neighbor, sa.f_pwr,
                sa.f_perf, sa.util_distance) == \
            (sb.bin_size, sb.power_neighbor, sb.util_neighbor, sb.f_pwr,
             sb.f_perf, sb.util_distance)
        assert abs(sa.power_distance - sb.power_distance) <= 1e-12
        (_, ca), (_, cb) = ref_margin(ta, a), classify_with_margin(tb, b)
        assert abs(ca - cb) <= 1e-12
    ba = ref_margin_b([t for t, _ in targets], a)
    bb = classify_with_margin_batch([t for _, t in targets], b)
    for (sa, ca), (sb, cb) in zip(ba, bb):
        assert (sa.bin_size, sa.power_neighbor, sa.f_pwr, sa.f_perf) == \
            (sb.bin_size, sb.power_neighbor, sb.f_pwr, sb.f_perf)
        assert abs(ca - cb) <= 1e-12


def test_batch_and_single_distance_rows_bitwise(pair):
    _, port, targets = pair
    clf = port.classifier()
    for c in (0.05, 0.2):
        T = torch.stack([t.spike_vec(c) for _, t in targets])
        full = _cosine_distances(T, clf.spike_matrix(c))
        for i in range(len(targets)):
            one = _cosine_distances(T[i:i + 1], clf.spike_matrix(c))
            assert torch.equal(full[i:i + 1], one)
        # and inside a bigger batch, at another row position
        big = _cosine_distances(torch.cat([T.flip(0), T]),
                                clf.spike_matrix(c))
        assert torch.equal(big[len(targets):], full)


def test_cosine_distances_zero_rows_and_reference_values():
    rng = np.random.default_rng(0)
    A = rng.random((6, 15))
    A[2] = 0.0
    B = rng.random((4, 15))
    B[1] = 0.0
    got = _cosine_distances(torch.from_numpy(A), torch.from_numpy(B)).numpy()
    from repro.core.classify import _cosine_distances as ref_cos
    np.testing.assert_allclose(got, ref_cos(A, B), rtol=0, atol=1e-12)
    assert (got[2] == 1.0).all() and (got[:, 1] == 1.0).all()


@pytest.mark.parametrize("method", ["ward", "single", "average", "complete"])
def test_linkage_and_cut_match_reference(method):
    rng = np.random.default_rng(1)
    V = rng.random((9, 12))
    D = ref_clustering.cosine_distance_matrix(V)
    Dt = clustering.cosine_distance_matrix(torch.from_numpy(V))
    np.testing.assert_allclose(Dt.numpy(), D, rtol=0, atol=1e-12)
    Zr = ref_clustering.linkage(D, method=method)
    Zt = clustering.linkage(Dt, method=method)
    np.testing.assert_array_equal(Zt[:, [0, 1, 3]], Zr[:, [0, 1, 3]])
    np.testing.assert_allclose(Zt[:, 2], Zr[:, 2], rtol=0, atol=1e-10)
    for k in (1, 2, 4):
        np.testing.assert_array_equal(clustering.cut_k(Zt, k),
                                      ref_clustering.cut_k(Zr, k))


def test_euclidean_distance_matrix_matches_reference():
    X = np.random.default_rng(2).random((7, 3))
    np.testing.assert_allclose(
        clustering.euclidean_distance_matrix(torch.from_numpy(X)).numpy(),
        ref_clustering.euclidean_distance_matrix(X), rtol=0, atol=1e-12)


def test_power_classes_match_reference(pair):
    ref, port, _ = pair
    np.testing.assert_array_equal(port.classifier().power_classes(3),
                                  ref.classifier().power_classes(3))


def test_exclusion_and_errors_match_reference(pair):
    ref, port, _ = pair
    a, b = ref.classifier(), port.classifier()
    one_a = RefClassifier([a.references[0]])
    one_b = MinosClassifier([b.references[0]])
    for clf in (one_a, one_b):
        with pytest.raises(ValueError, match="no eligible reference"):
            clf.power_neighbors(clf.references)
    for bad in (0, -0.1, True, "x"):
        with pytest.raises(ValueError, match="bin_size must be a positive"):
            MinosClassifier(b.references, bin_size=bad)
    with pytest.raises(ValueError, match="empty reference set"):
        MinosClassifier([])
    name = a.references[1].name
    ea = a.power_neighbors([a.references[0]], exclude=name)
    eb = b.power_neighbors([b.references[0]], exclude=name)
    assert ea[0][0].name == eb[0][0].name != name
    with pytest.raises(NotImplementedError, match="K-Means"):
        b.util_classes(3)


def test_top2_and_sweep_match_reference(pair):
    ref, port, targets = pair
    a, b = ref.classifier(), port.classifier()
    ta = [t for t, _ in targets]
    tb = [t for _, t in targets]
    for (ra, d1a, d2a), (rb, d1b, d2b) in zip(a.power_top2(ta, 0.1),
                                              b.power_top2(tb, 0.1)):
        assert ra.name == rb.name
        assert abs(d1a - d1b) <= 1e-12 and abs(d2a - d2b) <= 1e-12
    for (ia, ba, sa), (ib, bb, sb) in zip(
            a.power_sweep(ta, (0.05, 0.5)), b.power_sweep(tb, (0.05, 0.5))):
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_allclose(ba, bb, rtol=0, atol=1e-12)
        np.testing.assert_allclose(sa, sb, rtol=0, atol=1e-12)


def test_count_classifier_calls_spy(pair):
    _, port, targets = pair
    clf = port.classifier()
    calls = count_classifier_calls(clf)
    classify_with_margin_batch([t for _, t in targets], clf)
    assert calls["n"] > 0
    before = calls["n"]
    clf.util_matrix()
    clf.spike_matrix(0.1)
    assert calls["n"] == before


def test_profile_quantiles_bit_identical(pair):
    _, _, targets = pair
    for ta, tb in targets:
        for q in (50.0, 90.0, 95.0, 99.0, 100.0, 0.0):
            assert ta.p_quantile(q) == tb.p_quantile(q)
    empty = WorkloadProfile("e", 197.0, torch.empty(0, dtype=torch.float64),
                            0.5, 0.5, 1.0)
    assert empty.p_quantile(90.0) == 0.0 and empty.mean_power == 0.0
