"""The paper's remaining tables on the port against the reference, on the
CPU: ``spike_cdf`` and ``app_utilization`` (``repro_torch.core``),
``build_reference_set`` and ``build_holdout_profiles``
(``repro_torch.telemetry``), and ``chip_smoke.py``'s ports of the savings,
frequency-scaling, bin-size, case-study and CDF benches.

Everything is held exactly: CDF counts, utilization sums, traces and
quantiles bit for bit, and every table equal to the reference bench's
output on the full 28-workload library of each package (the reference's
``reference_library`` and ``RESULTS`` monkeypatched, as
``test_torch_clustering`` does for phase 13's tables) and to the committed
``results/*.json``.
"""
import importlib
import json
import os
import sys

import numpy as np
import pytest
import torch

from repro.core import app_utilization as ref_app_utilization
from repro.core import spikes as ref_spikes
from repro.pipeline import build_reference_library as ref_build_library
from repro.telemetry import TPUPowerModel as RefModel
from repro.telemetry import build_holdout_profiles as ref_holdout
from repro.telemetry import build_reference_set as ref_reference_set
from repro_torch.core import app_utilization, spikes
from repro_torch.pipeline import build_reference_library
from repro_torch.telemetry import (TPUPowerModel, build_holdout_profiles,
                                   build_reference_set)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
TDP = RefModel().spec.tdp_w


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The profiles are thousands of small tensor ops, which one thread
    runs as fast as eight; under the suite's parallel workers a thread
    pool per worker oversubscribes the cores and slows them manyfold."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _chip_smoke():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    return chip_smoke


def _bench(name):
    sys.path.insert(0, ROOT)
    try:
        return importlib.import_module(f"benchmarks.{name}")
    finally:
        sys.path.remove(ROOT)


def _assert_profiles_equal(ref, port):
    """Two lists of profiles, bit for bit (the mean within 1e-12: NumPy's
    pairwise sum against the port's host mean of the same samples)."""
    assert [r.name for r in ref] == [p.name for p in port]
    for a, b in zip(ref, port):
        np.testing.assert_array_equal(a.power_trace, b.power_trace.numpy())
        assert (a.sm_util, a.dram_util, a.exec_time, a.tdp) == \
            (b.sm_util, b.dram_util, b.exec_time, b.tdp)
        assert sorted(a.scaling) == sorted(b.scaling)
        for f in a.scaling:
            x, y = a.scaling[f], b.scaling[f]
            assert (x.p90, x.p95, x.p99, x.exec_time) == \
                (y.p90, y.p95, y.p99, y.exec_time)
            assert abs(x.mean_power - y.mean_power) <= 1e-12
            np.testing.assert_array_equal(x.spike_vec, y.spike_vec.numpy())


# ---------------------------------------------------------------------------
# spike_cdf and app_utilization
# ---------------------------------------------------------------------------
def _trace(seed: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    p = rng.gamma(4.0, TDP / 4.0, n)
    p[rng.random(n) < 0.1] = 0.0
    # samples exactly on grid points (relative power k / 100), where the
    # right-sided search must count the sample
    p[:n // 4] = np.round(p[:n // 4] / TDP, 2) * TDP
    return p


@pytest.mark.parametrize("seed,n,grid", [
    (0, 4000, None), (1, 257, np.linspace(0.0, 2.0, 101)),
    (2, 1, None), (3, 0, None), (4, 2000, np.linspace(0.3, 1.7, 29)),
    (5, 999, np.array([0.0, 0.5, 0.5, 1.0, 3.0]))])
def test_spike_cdf_matches_the_reference_exactly(seed, n, grid):
    p = _trace(seed, n)
    want_grid, want = ref_spikes.spike_cdf(p, TDP, grid)
    for power in (torch.from_numpy(p), p):          # a tensor or an array
        got_grid, got = spikes.spike_cdf(power, TDP, grid, device=CPU)
        assert got.dtype == torch.float64 and got_grid.dtype == torch.float64
        np.testing.assert_array_equal(got_grid.numpy(), want_grid)
        np.testing.assert_array_equal(got.numpy(), want)


def test_spike_cdf_default_grid_and_device():
    grid, cdf = spikes.spike_cdf(torch.zeros(3, dtype=torch.float64), TDP)
    assert grid.shape == (201,) and float(grid[-1]) == spikes.SPIKE_HI
    assert bool((cdf == 1.0).all())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            spikes.spike_cdf(np.zeros(3), TDP)


@pytest.mark.parametrize("rows", [
    [(1.0, 0.5, 0.25)],
    [(0.3, 0.91, 0.12), (1.7, 0.05, 0.66), (0.01, 1.0, 0.0)],
    [(0.0, 0.5, 0.5), (0.0, 0.1, 0.2)],
    [],
    "random"])
def test_app_utilization_matches_the_reference_exactly(rows):
    if rows == "random":
        rng = np.random.default_rng(9)
        rows = [tuple(float(v) for v in r) for r in rng.random((500, 3))]
    got = app_utilization(rows)
    assert got == ref_app_utilization(rows)
    assert all(type(v) is float for v in got)


# ---------------------------------------------------------------------------
# build_reference_set and build_holdout_profiles
# ---------------------------------------------------------------------------
def test_build_reference_set_matches_the_reference():
    freqs, dur = (0.6, 1.0), 0.3
    want = ref_reference_set(RefModel(), freqs=freqs, seed=5,
                             target_duration=dur)
    got = build_reference_set(TPUPowerModel(), freqs=freqs, seed=5,
                              target_duration=dur, device=CPU)
    assert len(got) == 28
    _assert_profiles_equal(want, got)


@pytest.mark.parametrize("with_truth", [False, True])
def test_build_holdout_profiles_match_the_reference(with_truth):
    freqs = (0.6, 0.8, 1.0)
    want = ref_holdout(RefModel(), with_truth=with_truth, freqs=freqs)
    got = build_holdout_profiles(TPUPowerModel(), with_truth=with_truth,
                                 freqs=freqs, device=CPU)
    if not with_truth:
        want, got = (want, []), (got, [])
    _assert_profiles_equal(want[0], got[0])
    assert all(p.complete and not p.scaling for p in got[0])
    _assert_profiles_equal(want[1], got[1])
    assert [len(t.scaling) for t in got[1]] == [3] * len(got[1])


def test_builders_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    for make in (lambda: build_holdout_profiles(),
                 lambda: build_reference_set(target_duration=0.1)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()


# ---------------------------------------------------------------------------
# chip_smoke.py's tables against the reference benches
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def libraries():
    """The full 28-workload library of each package, as the benches'
    ``reference_library`` builds it (``target_duration=3.0``)."""
    return (ref_build_library(RefModel(), target_duration=3.0),
            build_reference_library(TPUPowerModel(), target_duration=3.0,
                                    device=CPU))


@pytest.mark.parametrize("bench,table", [
    ("bench_savings", "savings_table"),
    ("bench_freq_scaling", "freq_scaling_table"),
    ("bench_binsize", "binsize_table"),
    ("bench_case_study", "case_study_table"),
    ("bench_cdf", "cdf_table")])
def test_chip_smoke_tables_match_reference_benches(libraries, bench, table,
                                                   tmp_path, monkeypatch):
    chip_smoke = _chip_smoke()
    mod = _bench(bench)
    ref, port = libraries
    if hasattr(mod, "reference_library"):
        monkeypatch.setattr(mod, "reference_library", lambda: ref)
    monkeypatch.setattr(mod, "RESULTS", str(tmp_path))
    want = mod.run()
    if table == "case_study_table":
        assert chip_smoke.case_study_table(port, CPU) == want["rows"]
    elif table == "cdf_table":
        got = chip_smoke.cdf_table(CPU)
        assert got == want
    else:
        assert getattr(chip_smoke, table)(port) == want


def test_tables_phase_holds_the_committed_jsons_on_the_cpu(libraries,
                                                           monkeypatch):
    """Phase 16 as ``chip_smoke.py`` runs it, with the CPU in the card's
    place: every json exactly (no kernel launches on the CPU, so the
    launch check is replaced by one that records what it was given)."""
    chip_smoke = _chip_smoke()
    seen = []
    monkeypatch.setattr(chip_smoke, "check_launches",
                        lambda what, launches: seen.append(what))
    out = chip_smoke.tables_phase(torch.device(CPU), CPU, libraries[1])
    assert out["savings_mean"] == 0.8976
    assert seen == ["case study (held-out profiles)"]
    assert [r["target"] for r in out["case_study"]] == [
        "granite-moe-3b-a800m:decode_32k", "granite-moe-3b-a800m:train_4k",
        "vector-search"]


def test_check_json_compares_a_list_whole():
    chip_smoke = _chip_smoke()
    with open(os.path.join(ROOT, "results", "case_study.json")) as f:
        rows = json.load(f)
    chip_smoke.check_json("case_study.json", rows)
    changed = [dict(r) for r in rows]
    changed[-1]["f_pwr"] = 0.6
    with pytest.raises(AssertionError, match="case_study.json"):
        chip_smoke.check_json("case_study.json", changed)
