"""The port's slice end to end: ``repro_torch.fleet.FleetCapController``
against ``repro.fleet.FleetCapController`` on the CPU, at a cut of
``benchmarks/bench_fleet_scale.py``'s smoke configuration (the five micro
streams on a zero-variability six-device inventory).

Every ``CapDecision`` must carry the same cap, neighbours, bin size, early
flag, fraction and sample count, with distances and confidence within
1e-12 (the port's fixed-order distance sums may differ from NumPy's in the
last bit); the final placed and deferred sets and the planned watts must be
identical.
"""
import numpy as np
import pytest
import torch

import repro.fleet as RF
import repro.pipeline as RP
import repro.telemetry as RT
import repro_torch.fleet as TF
import repro_torch.pipeline as TP
import repro_torch.telemetry as TT
from repro.core.classify import count_classifier_calls as ref_count
from repro.telemetry import kernel_stream as rks
from repro_torch.core.classify import count_classifier_calls
from repro_torch.telemetry import kernel_stream as tks

GATES = dict(min_confidence=0.2, min_fraction=0.1, min_spike_samples=50)
NAMES = ("micro_gemm", "micro_spmv_memory", "micro_spmv_compute",
         "micro_idle_burst", "micro_stencil")
CPU = "cpu"


def _drive(P, T, F, ks, count, n_jobs, port: bool, **fleet_kw):
    """bench_fleet_scale's drive at a small size, through one package."""
    kw = {"device": CPU} if port else {}
    streams = [getattr(ks, n)() for n in NAMES]
    model = T.TPUPowerModel()
    lib = P.ReferenceLibrary(
        (P.stream_profile_workload(s, model, (0.6, 0.8, 1.0),
                                   model.spec.tdp_w, seed=i,
                                   target_duration=1.0, **kw)
         for i, s in enumerate(streams)), built_on=model.spec.name, **kw)
    inv = F.DeviceInventory.generate({"tpu-v5e": 4, "tpu-v5p": 2},
                                     F.VariabilityModel.none(), seed=7)
    assigned = [(streams[i % len(streams)], 32, inv[i % len(inv)])
                for i in range(n_jobs)]
    budget = 0.75 * sum(c * d.nameplate_w for _, c, d in assigned)
    seeds = {n: 500 + i for i, n in
             enumerate(sorted({s.name for s, _, _ in assigned}))}
    telemetry = {}
    for s, _, d in assigned:
        key = (s.name, d.model)
        if key not in telemetry:
            meta, chunks = T.stream_telemetry(
                s, 1.0, d.power_model(), seed=seeds[s.name],
                target_duration=0.4, chunk_samples=256)
            telemetry[key] = (meta, list(chunks))
    fleet = F.FleetCapController(lib, budget_w=budget,
                                 provision_quantile="p99", **GATES,
                                 **fleet_kw, **kw)
    mux = F.FleetTelemetryMux()
    ids = fleet.admit_many(
        dict(device=d, meta=telemetry[(s.name, d.model)][0], chips=c,
             job_id=f"j{i:05d}:{s.name}")
        for i, (s, c, d) in enumerate(assigned))
    for (s, _, d), jid in zip(assigned, ids):
        meta, chunks = telemetry[(s.name, d.model)]
        mux.add_job(jid, meta, chunks, device_id=d.device_id)
    result = fleet.run(mux)
    calls = count(fleet.clf)
    fleet.set_budget(budget * 0.9)
    fleet.set_budget(budget)
    return fleet, result, fleet.repacks[-1], calls["n"]


def _ref(n_jobs, **kw):
    return _drive(RP, RT, RF, rks, ref_count, n_jobs, port=False, **kw)


def _port(n_jobs, **kw):
    return _drive(TP, TT, TF, tks, count_classifier_calls, n_jobs, port=True,
                  **kw)


def _key(d):
    s = d.selection
    return (d.target, d.cap, d.objective, d.early, d.fraction, d.n_samples,
            d.device_id, s.bin_size, s.power_neighbor, s.util_neighbor,
            s.util_distance, s.f_pwr, s.f_perf)


def _assert_same_outcome(a, b):
    _, ra, fa, ca = a
    _, rb, fb, cb = b
    assert ra.decisions.keys() == rb.decisions.keys()
    for k, x in ra.decisions.items():
        y = rb.decisions[k]
        assert _key(x) == _key(y), k
        assert abs(x.confidence - y.confidence) <= 1e-12
        assert abs(x.selection.power_distance
                   - y.selection.power_distance) <= 1e-12
    assert (ra.early_decisions, ra.repacks, ra.chunks_dropped) == \
        (rb.early_decisions, rb.repacks, rb.chunks_dropped)
    assert [p.job_id for p in fa.placed] == [p.job_id for p in fb.placed]
    assert fa.deferred == fb.deferred
    assert fa.planned_power_w == fb.planned_power_w
    assert ca == cb == 0                    # repacks never re-classify


@pytest.mark.parametrize("n_jobs", [60, 400])
def test_fleet_slice_matches_reference_tick_repack(n_jobs):
    ref, port = _ref(n_jobs, repack="tick"), _port(n_jobs, repack="tick")
    _assert_same_outcome(ref, port)
    assert len(port[1].decisions) == n_jobs
    assert 0 < port[1].early_decisions < n_jobs


def test_fleet_slice_matches_reference_per_decision_repack():
    _assert_same_outcome(_ref(90, repack="decision"),
                         _port(90, repack="decision"))


def test_port_perjob_engine_matches_batched():
    a = _port(50, repack="tick", engine="batched")
    b = _port(50, repack="tick", engine="perjob")
    _assert_same_outcome(a, b)
    assert b[0].engine is None


def test_full_packer_matches_incremental():
    _assert_same_outcome(_port(70, repack="tick", packer="full"),
                         _port(70, repack="tick"))


def test_retire_repacks_without_reclassification():
    fleet, result, _, _ = _port(40, repack="tick")
    calls = count_classifier_calls(fleet.clf)
    job_id = next(iter(result.decisions))
    job = fleet.retire(job_id)
    assert job.builder._released and job_id not in fleet.jobs
    assert calls["n"] == 0
    with pytest.raises(KeyError):
        fleet.retire(job_id)


def test_not_ported_paths_raise():
    """Online class discovery is the one controller path still to port
    (ROADMAP item 1c); the failure paths are ported and, as in the
    reference, need an inventory."""
    fleet, _, _, _ = _port(10, repack="tick")
    for call in (lambda: fleet.adopt_classifier(fleet.clf),
                 lambda: fleet.set_discovery(object())):
        with pytest.raises(NotImplementedError, match="ROADMAP.*item 1c"):
            call()
    for call in (lambda: fleet.fail_device("tpu-v5e/000"),
                 lambda: fleet.degrade_device("tpu-v5e/000"),
                 lambda: fleet.restore_device("tpu-v5e/000")):
        with pytest.raises(ValueError, match="needs an inventory"):
            call()
    lib = [j.controller.clf for j in fleet.jobs.values()][0]
    adapter = TF.controller.FleetStragglerAdapter()
    built = TF.FleetCapController(lib, budget_w=1.0, device=CPU,
                                  journal=None, straggler_adapter=adapter)
    assert built.straggler_adapter is adapter and built.journal is None


def test_inventory_and_mux_copies_match_reference():
    a = RF.DeviceInventory.generate({"tpu-v5e": 3, "tpu-v6e": 2},
                                    RF.VariabilityModel(), seed=9)
    b = TF.DeviceInventory.generate({"tpu-v5e": 3, "tpu-v6e": 2},
                                    TF.VariabilityModel(), seed=9)
    assert [(d.device_id, d.effective_tdp_w, d.nameplate_w) for d in a] == \
        [(d.device_id, d.effective_tdp_w, d.nameplate_w) for d in b]
    ra, rb = RF.FleetTelemetryMux(), TF.FleetTelemetryMux()
    for k, s in enumerate((rks.micro_gemm(), rks.micro_idle_burst())):
        meta, chunks = RT.stream_telemetry(s, 1.0, RT.TPUPowerModel(),
                                           seed=k, target_duration=0.5)
        chunks = list(chunks)
        ra.add_job(f"j{k}", meta, chunks, device_id=f"d{k}")
        rb.add_job(f"j{k}", meta, chunks, device_id=f"d{k}")
    ta = [[(c.job_id, c.t_end) for c in tick] for tick in ra.ticks()]
    tb = [[(c.job_id, c.t_end) for c in tick] for tick in rb.ticks()]
    assert ta == tb


def test_job_mix_and_telemetry_copies_match_reference():
    a = RT.workloads.fleet_job_mix(300, seed=11)
    b = TT.workloads.fleet_job_mix(300, seed=11)
    assert [(s.name, c) for s, c in a] == [(s.name, c) for s, c in b]
    ma, ca = RT.stream_telemetry(a[0][0], 0.8, RT.TPUPowerModel(), seed=3,
                                 target_duration=0.5)
    mb, cb = TT.stream_telemetry(b[0][0], 0.8, TT.TPUPowerModel(), seed=3,
                                 target_duration=0.5)
    assert ma.n_samples == mb.n_samples and ma.exec_time == mb.exec_time
    for x, y in zip(ca, cb):
        np.testing.assert_array_equal(x.energy_j, y.energy_j)
        np.testing.assert_array_equal(x.busy_s, y.busy_s)
    sa = RT.simulate(a[1][0], 1.0, RT.TPUPowerModel(), seed=4,
                     target_duration=0.5)
    sb = TT.simulate(b[1][0], 1.0, TT.TPUPowerModel(), seed=4,
                     target_duration=0.5)
    np.testing.assert_array_equal(sa.power_filtered, sb.power_filtered)


def test_fleet_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TF.FleetCapController([], budget_w=1.0)
