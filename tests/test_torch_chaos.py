"""The port's failure paths (``fail_device`` / ``degrade_device`` /
``restore_device``, migration, elastic shrink, stranding, re-placement,
straggler drain) against the reference's, on the CPU.

Every scenario of ``tests/test_chaos.py`` that drives a fleet runs through
both packages on the same seeded inputs; the port must give the same
events, decisions, plans, placements, device spans and health (distances
and confidence within 1e-12, everything else exact), and chaos handling
must make 0 classifier calls in both.  The budget property runs over
hypothesis failure schedules; the harness re-profiles a migrated job
before it feeds its telemetry again, as ``bench_chaos`` does — feeding the
stale stream instead raises the reference's ``ValueError``, which the port
keeps.  ``results/fleet.json``'s and ``results/chaos.json``'s smoke counts
come out of the port's session through ``chip_smoke.py``'s drives.
"""
import json
import os
import sys
import types

import pytest
from hypothesis import given, settings, strategies as st

import repro.api as R
import repro.ft as RFT
import repro_torch.api as T
import repro_torch.ft as TFT
from repro.configs.base import MeshConfig as RMesh
from repro.fleet import DEGRADED, FAILED
from repro_torch.configs.base import MeshConfig as TMesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
FREQS = (0.6, 0.8, 1.0)
GATES = dict(min_confidence=0.2, min_fraction=0.1, min_spike_samples=50)
FLOAT_TOL = 1e-12


def _ns(A, ft, mesh):
    """One package's surface, with its device keyword bound."""
    kw = {"device": CPU} if A is T else {}
    return types.SimpleNamespace(
        A=A, ft=ft, Mesh=mesh, kw=kw,
        fleet=lambda lib, **k: A.FleetCapController(lib, **GATES, **kw, **k),
        session=lambda lib, **k: A.MinosSession(lib, **GATES, **kw, **k))


PKGS = {"repro": _ns(R, RFT, RMesh), "repro_torch": _ns(T, TFT, TMesh)}


def _library(P):
    A = P.A
    model = A.TPUPowerModel()
    return A.ReferenceLibrary(
        (A.stream_profile_workload(s, model, FREQS, model.spec.tdp_w, seed=i,
                                   target_duration=0.5, **P.kw)
         for i, s in enumerate([A.micro_gemm(), A.micro_idle_burst(),
                                A.micro_spmv_memory(), A.micro_stencil()])),
        built_on="tpu-v5e", **P.kw)


@pytest.fixture(scope="module")
def libs():
    return {name: _library(P) for name, P in PKGS.items()}


def _job_stream(P, fn_name, device, seed, chunk_samples=100):
    A = P.A
    return A.stream_telemetry(getattr(A, fn_name)(), 1.0,
                              device.power_model(), seed=seed,
                              target_duration=0.5,
                              chunk_samples=chunk_samples,
                              device_id=device.device_id)


def _summary(P, fleet, chaos_calls=0, **extra) -> dict:
    """Everything a failure path decides, JSON-comparable across packages."""
    A = P.A
    jobs = fleet.jobs.values()
    last = fleet.repacks[-1] if fleet.repacks else None
    return dict(
        events=[A.to_dict(e) for e in fleet.events],
        decisions={j.job_id: A.to_dict(j.decision) if j.decision else None
                   for j in jobs},
        plans={j.job_id: A.to_dict(j.plan) if j.plan else None for j in jobs},
        spans={j.job_id: [d.device_id for d in j.devices] for j in jobs},
        primary={j.job_id: j.device.device_id for j in jobs},
        chips={j.job_id: [j.chips, j.global_batch] for j in jobs},
        profiling={j.job_id: [j.needs_reprofile, j.builder.n_ingested,
                              j.builder.tdp] for j in jobs},
        caps={j.job_id: None if j.actuator is None else
              [j.actuator.device_id, j.actuator.get_cap()] for j in jobs},
        health=fleet.device_health(), failed=sorted(fleet._failed_devices),
        repacks=len(fleet.repacks),
        planned=[r.planned_power_w for r in fleet.repacks],
        placed=None if last is None else
        [[p.job_id, p.device_id] for p in last.placed],
        deferred=None if last is None else list(last.deferred),
        chaos_calls=chaos_calls, **extra)


def _assert_close(a, b, where="summary"):
    if isinstance(a, float) and isinstance(b, float):
        assert a == b or abs(a - b) <= FLOAT_TOL * max(1.0, abs(a)), \
            (where, a, b)
    elif isinstance(a, dict) and isinstance(b, dict):
        assert list(a) == list(b), (where, list(a), list(b))
        for k in a:
            _assert_close(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        assert len(a) == len(b), (where, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_close(x, y, f"{where}[{i}]")
    else:
        assert a == b, (where, a, b)


class _Spy:
    """Classifier calls made inside ``with spy:`` blocks."""

    def __init__(self, P, clf):
        self.calls = P.A.count_classifier_calls(clf)
        self.chaos = 0

    def __enter__(self):
        self.before = self.calls["n"]

    def __exit__(self, *exc):
        self.chaos += self.calls["n"] - self.before


# ---------------------------------------------------------------------------
# scenarios of tests/test_chaos.py, each driven through one package
# ---------------------------------------------------------------------------
def _decided_fleet(P, lib, n_devices=3, seed=0):
    inv = P.A.DeviceInventory.generate(n_devices, P.A.VariabilityModel(),
                                       seed=seed)
    fleet = P.fleet(lib, budget_w=1e9, inventory=inv)
    mux = P.A.FleetTelemetryMux()
    for i, fn in enumerate(["micro_gemm", "micro_spmv_memory"]):
        meta, chunks = _job_stream(P, fn, inv[i], seed=i)
        mux.add_job(fleet.admit(inv[i], meta, chips=4), meta, chunks)
    fleet.run(mux)
    return inv, fleet


def _fail_decided(P, lib):
    inv, fleet = _decided_fleet(P, lib)
    spy = _Spy(P, fleet.clf)
    with spy:
        events = fleet.fail_device(
            next(iter(fleet.jobs.values())).device.device_id)
    assert [e.kind for e in events] == ["fail", "migrate"]
    return _summary(P, fleet, spy.chaos)


def _fail_mid_profile(P, lib):
    inv = P.A.DeviceInventory.generate(2, P.A.VariabilityModel(), seed=3)
    fleet = P.fleet(lib, budget_w=1e9, inventory=inv)
    meta, chunks = _job_stream(P, "micro_gemm", inv[0], seed=5)
    job_id = fleet.admit(inv[0], meta, chips=2)
    chunks = list(chunks)
    fleet.ingest_chunk(job_id, chunks[0])
    spy = _Spy(P, fleet.clf)
    with spy:
        fleet.fail_device(inv[0].device_id)
    job = fleet.jobs[job_id]
    assert job.needs_reprofile and job.builder.n_ingested == 0
    assert job.builder.tdp == inv[1].effective_tdp_w
    stale = P.A.FleetChunk(job_id, inv[0].device_id, 1.0, chunks[1])
    dropped = fleet.ingest(stale) is None
    with pytest.raises(ValueError, match="restart"):
        fleet.ingest_chunk(job_id, chunks[1])
    before = _summary(P, fleet, spy.chaos)
    meta2, chunks2 = _job_stream(P, "micro_gemm", inv[1], seed=6)
    fleet.restart_profile(job_id, meta2)
    for chunk in chunks2:
        if fleet.ingest_chunk(job_id, chunk) is not None:
            break
    fleet.finalize_job(job_id)
    return dict(before=before, after=_summary(P, fleet, spy.chaos),
                dropped=dropped)


def _strand_and_restore(P, lib):
    inv, fleet = _decided_fleet(P, lib, n_devices=2)
    spy = _Spy(P, fleet.clf)
    with spy:
        fleet.fail_device(inv[1].device_id)
        fleet.fail_device(inv[0].device_id)
    stranded = _summary(P, fleet, spy.chaos)
    assert {e["kind"] for e in stranded["events"]} >= {"strand"}
    assert all(p is None for p in stranded["plans"].values())
    with spy:
        events = fleet.restore_device(inv[1].device_id)
    assert [e.kind for e in events] == ["restore", "migrate", "migrate"]
    return dict(stranded=stranded, restored=_summary(P, fleet, spy.chaos))


def _degrade_strand_restore(P, lib):
    inv, fleet = _decided_fleet(P, lib, n_devices=2)
    spy = _Spy(P, fleet.clf)
    with spy:
        fleet.fail_device(inv[1].device_id)
        fleet.degrade_device(inv[0].device_id)
    stranded = _summary(P, fleet, spy.chaos)
    with spy:
        fleet.restore_device(inv[1].device_id)
    return dict(stranded=stranded, restored=_summary(P, fleet, spy.chaos))


def _span_decides_on_degraded(P, lib):
    inv = P.A.DeviceInventory.generate(3, P.A.VariabilityModel(), seed=9)
    fleet = P.fleet(lib, budget_w=1e9, inventory=inv)
    meta, chunks = _job_stream(P, "micro_gemm", inv[1], seed=4)
    job_id = fleet.admit(inv[1], meta, chips=4, devices=(inv[0], inv[1]))
    chunks = list(chunks)
    fleet.ingest_chunk(job_id, chunks[0])
    fleet.degrade_device(inv[0].device_id)
    for chunk in chunks[1:]:
        if fleet.ingest_chunk(job_id, chunk) is not None:
            break
    fleet.finalize_job(job_id)
    return _summary(P, fleet)


def _restore_rejoins_pool(P, lib):
    inv, fleet = _decided_fleet(P, lib)
    fleet.fail_device(inv[0].device_id)
    meta, _ = _job_stream(P, "micro_gemm", inv[0], seed=9)
    with pytest.raises(ValueError, match="device is failed"):
        fleet.admit(inv[0], meta, job_id="late-arrival")
    fleet.restore_device(inv[0].device_id)
    fleet.admit(inv[0], meta, job_id="late-arrival")
    return _summary(P, fleet)


def _partial_span_shrink(P, lib):
    inv = P.A.DeviceInventory.generate(4, P.A.VariabilityModel(), seed=1)
    fleet = P.fleet(lib, budget_w=1e9, inventory=inv)
    meta, chunks = _job_stream(P, "micro_gemm", inv[0], seed=2)
    job_id = fleet.admit(inv[0], meta, chips=12,
                         devices=(inv[0], inv[1], inv[2]), global_batch=96)
    for chunk in chunks:
        if fleet.ingest_chunk(job_id, chunk) is not None:
            break
    fleet.finalize_job(job_id)
    spy = _Spy(P, fleet.clf)
    with spy:
        fleet.fail_device(inv[1].device_id)
    once = _summary(P, fleet, spy.chaos)
    assert once["chips"][job_id] == [8, 64]     # 12 -> 8 chips, batch 96->64
    with spy:
        fleet.fail_device(inv[2].device_id)
    twice = _summary(P, fleet, spy.chaos)
    assert twice["chips"][job_id] == [4, 32]
    return dict(once=once, twice=twice)


def _partial_span_primary(P, lib):
    inv = P.A.DeviceInventory.generate(3, P.A.VariabilityModel(), seed=6)
    fleet = P.fleet(lib, budget_w=1e9, inventory=inv)
    meta, chunks = _job_stream(P, "micro_gemm", inv[0], seed=7)
    job_id = fleet.admit(inv[0], meta, chips=4, devices=(inv[0], inv[1]),
                         mesh=P.Mesh((4, 1), ("data", "model")))
    fleet.ingest_chunk(job_id, next(iter(chunks)))
    fleet.fail_device(inv[0].device_id)
    with pytest.raises(ValueError, match="restart"):
        fleet.ingest_chunk(job_id, next(iter(chunks)))
    meta2, chunks2 = _job_stream(P, "micro_gemm", inv[1], seed=8)
    fleet.restart_profile(job_id, meta2)
    fleet.ingest_chunk(job_id, next(iter(chunks2)))
    return _summary(P, fleet, mesh=list(fleet.jobs[job_id].mesh.shape))


def _degrade_then_decide(P, lib):
    inv = P.A.DeviceInventory.generate(3, P.A.VariabilityModel(), seed=4)
    fleet = P.fleet(lib, budget_w=1e9, inventory=inv)
    meta_a, chunks_a = _job_stream(P, "micro_gemm", inv[0], seed=1)
    fleet.admit(inv[0], meta_a, chips=2, job_id="a")
    for chunk in chunks_a:
        if fleet.ingest_chunk("a", chunk) is not None:
            break
    fleet.finalize_job("a")
    meta_b, chunks_b = _job_stream(P, "micro_spmv_memory", inv[0], seed=2)
    chunks_b = list(chunks_b)
    fleet.admit(inv[0], meta_b, chips=2, job_id="b")
    fleet.ingest_chunk("b", chunks_b[0])
    spy = _Spy(P, fleet.clf)
    with spy:
        fleet.degrade_device(inv[0].device_id)
        again = fleet.degrade_device(inv[0].device_id)
    drained = _summary(P, fleet, spy.chaos, again=len(again))
    for chunk in chunks_b[1:]:
        if fleet.ingest_chunk("b", chunk) is not None:
            break
    fleet.finalize_job("b")
    return dict(drained=drained, decided=_summary(P, fleet, spy.chaos))


def _auto_degrade(P, lib):
    A = P.A
    inv = A.DeviceInventory.generate(3, A.VariabilityModel.none(), seed=0)
    adapter = P.ft.FleetStragglerAdapter(
        P.ft.StragglerMonitor(min_samples=5, k=4.0))
    fleet = P.fleet(lib, budget_w=1e9, inventory=inv,
                    straggler_adapter=adapter)
    streams = {}
    for i, fn in enumerate(["micro_gemm", "micro_spmv_memory",
                            "micro_stencil"]):
        meta, chunks = _job_stream(P, fn, inv[i], seed=i, chunk_samples=50)
        streams[fleet.admit(inv[i], meta, chips=2)] = list(chunks)
    rounds = min(len(c) for c in streams.values())
    for r in range(rounds):
        for i, (job_id, chunks) in enumerate(streams.items()):
            cadence = 0.5 if i == 2 else 0.05
            fleet.ingest(A.FleetChunk(job_id, inv[i].device_id,
                                      r * cadence, chunks[r]))
    assert fleet.device_health()[inv[2].device_id] == DEGRADED
    return _summary(P, fleet, degraded=adapter.degraded())


def _no_failure_identity(P, lib):
    inv = P.A.DeviceInventory.generate(3, P.A.VariabilityModel(), seed=7)
    jobs = [("micro_gemm", 0), ("micro_spmv_memory", 1),
            ("micro_spmv_compute", 2)]
    out = {}
    for wired in (False, True):
        ft = dict(inventory=inv,
                  straggler_adapter=P.ft.FleetStragglerAdapter()) \
            if wired else {}
        fleet = P.fleet(lib, budget_w=2e4, **ft)
        mux = P.A.FleetTelemetryMux()
        for (fn, seed), dev in zip(jobs, inv):
            meta, chunks = _job_stream(P, fn, dev, seed=seed)
            mux.add_job(fleet.admit(dev, meta, chips=4), meta, chunks)
        res = fleet.run(mux)
        out[wired] = _summary(P, fleet, dropped=res.chunks_dropped)
    assert out[True]["decisions"] == out[False]["decisions"]
    assert out[True]["placed"] == out[False]["placed"]
    assert out[True]["events"] == []
    return out[True]


def _session_surface(P, lib):
    A = P.A
    inv = A.DeviceInventory.generate({"tpu-v5e": 2, "tpu-v5p": 1},
                                     A.VariabilityModel(), seed=5)
    session = P.session(lib, inventory=inv, budget_w=1e9)
    for i, fn in enumerate(["micro_gemm", "micro_spmv_memory"]):
        session.submit(_job_stream(P, fn, inv[i], seed=i), device=inv[i],
                       chips=4).run()
    spy = _Spy(P, session.classifier)
    with spy:
        session.fail_device(inv[0].device_id)
    report = session.run()
    submitted_on = [session.submit(_job_stream(P, "micro_stencil", inv[1],
                                               seed=9)).device.device_id
                    for _ in range(4)]
    with spy:
        session.restore_device(inv[0].device_id)
    back = A.SessionReport.from_json(session.report().to_json())
    assert back == session.report()
    assert inv[0].device_id not in submitted_on    # healthy devices only
    return _summary(P, session._fleet, spy.chaos, submitted_on=submitted_on,
                    failures=report.failures, migrations=report.migrations,
                    report=A.to_dict(session.report()))


def _session_reprofile(P, lib):
    A = P.A
    inv = A.DeviceInventory.generate(2, A.VariabilityModel(), seed=8)
    session = P.session(lib, inventory=inv, budget_w=1e9)
    meta, chunks = _job_stream(P, "micro_gemm", inv[0], seed=3)
    handle = session.submit(meta, device=inv[0], chips=2)
    handle.feed(next(iter(chunks)))
    session.fail_device(inv[0].device_id)
    assert not handle.decided and handle.fraction == 0.0
    handle.reprofile(A.micro_gemm(), seed=4, target_duration=0.5,
                     chunk_samples=100)
    decision = handle.run()
    with pytest.raises(ValueError, match="already decided"):
        handle.reprofile(A.micro_gemm(), seed=4, target_duration=0.5)
    with pytest.raises(TypeError, match="KernelStream"):
        handle.reprofile(42)
    return _summary(P, session._fleet, decision=A.to_dict(decision))


SCENARIOS = {
    "fail_decided": _fail_decided,
    "fail_mid_profile": _fail_mid_profile,
    "strand_and_restore": _strand_and_restore,
    "degrade_strand_restore": _degrade_strand_restore,
    "span_decides_on_degraded": _span_decides_on_degraded,
    "restore_rejoins_pool": _restore_rejoins_pool,
    "partial_span_shrink": _partial_span_shrink,
    "partial_span_primary": _partial_span_primary,
    "degrade_then_decide": _degrade_then_decide,
    "auto_degrade": _auto_degrade,
    "no_failure_identity": _no_failure_identity,
    "session_surface": _session_surface,
    "session_reprofile": _session_reprofile,
}


def _chaos_calls(summary):
    if isinstance(summary, dict) and "chaos_calls" in summary:
        yield summary["chaos_calls"]
    elif isinstance(summary, dict):
        for v in summary.values():
            yield from _chaos_calls(v)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_failure_paths_match_reference(libs, name):
    scenario = SCENARIOS[name]
    ref = scenario(PKGS["repro"], libs["repro"])
    port = scenario(PKGS["repro_torch"], libs["repro_torch"])
    _assert_close(port, ref, name)
    assert set(_chaos_calls(port)) <= {0}


def test_fail_device_requires_inventory(libs):
    P, lib = PKGS["repro_torch"], libs["repro_torch"]
    with pytest.raises(ValueError, match="inventory"):
        P.fleet(lib, budget_w=1e9).fail_device("tpu-v5e/000")
    with pytest.raises(ValueError, match="inventory"):
        P.session(lib).fail_device("tpu-v5e/000")


# ---------------------------------------------------------------------------
# property: the packed budget survives any failure schedule
# ---------------------------------------------------------------------------
def _schedule_run(P, lib, encoded, reprofile: bool):
    """``test_chaos``'s property harness.  With ``reprofile`` a migrated
    job's stale chunks are not fed: it restarts its run on its new device
    after the stream (``bench_chaos``'s recovery step)."""
    A = P.A
    inv = A.DeviceInventory.generate(3, A.VariabilityModel(), seed=2)
    jobs = [("micro_gemm", 0), ("micro_spmv_memory", 1),
            ("micro_stencil", 2)]
    budget = 0.75 * sum(4 * d.nameplate_w for d in inv)
    fleet = P.fleet(lib, budget_w=budget, inventory=inv)
    mux = A.FleetTelemetryMux()
    for (fn, seed), dev in zip(jobs, inv):
        meta, chunks = _job_stream(P, fn, dev, seed=seed)
        mux.add_job(fleet.admit(dev, meta, chips=4), meta, chunks)
    schedule = sorted(((e // 9) % 12, (e // 3) % 3, e % 3) for e in encoded)
    spy = _Spy(P, fleet.clf)

    def apply_due(n):
        while schedule and n >= schedule[0][0]:
            _, action, dev_idx = schedule.pop(0)
            device_id = inv[dev_idx].device_id
            with spy:
                if action == 0:
                    fleet.fail_device(device_id)
                    mux.drop_device(device_id)
                elif action == 1:
                    fleet.degrade_device(device_id)
                else:
                    fleet.restore_device(device_id)

    n = 0
    for fchunk in mux:
        apply_due(n)
        job = fleet.jobs.get(fchunk.job_id)
        if not (reprofile and job is not None and job.needs_reprofile):
            fleet.ingest(fchunk)
        n += 1
    apply_due(12)
    if reprofile:
        for i, job in enumerate(list(fleet.jobs.values())):
            if job.needs_reprofile and job.plan is None \
                    and fleet.device_health()[job.device.device_id] \
                    != FAILED:
                meta, chunks = _job_stream(P, jobs[i][0], job.device,
                                           seed=50 + i)
                fleet.restart_profile(job.job_id, meta)
                for chunk in chunks:
                    if fleet.ingest_chunk(job.job_id, chunk) is not None:
                        break
    for res in fleet.repacks:
        assert res.planned_power_w <= res.budget_w + 1e-9
    return _summary(P, fleet, spy.chaos)


@settings(max_examples=8, deadline=None)
@given(st.lists(st.integers(min_value=0, max_value=3 * 3 * 12 - 1),
                min_size=0, max_size=6))
def test_budget_never_exceeded_across_any_failure_schedule(encoded):
    """Each int unpacks to (chunk 0..11, action 0..2, device 0..2); under
    any churn every re-pack stays inside the budget, chaos handling never
    classifies, and the port decides as the reference does."""
    port = _schedule_run(PKGS["repro_torch"], _PROPERTY_LIBS["repro_torch"],
                         encoded, reprofile=True)
    ref = _schedule_run(PKGS["repro"], _PROPERTY_LIBS["repro"], encoded,
                        reprofile=True)
    _assert_close(port, ref, f"schedule {encoded}")
    assert port["chaos_calls"] == 0


_PROPERTY_LIBS = {}


@pytest.fixture(autouse=True)
def _seed_property_libs(libs):
    _PROPERTY_LIBS.update(libs)


@pytest.mark.parametrize("pkg", ["repro", "repro_torch"])
def test_stale_chunk_after_migration_raises(libs, pkg):
    """The schedule [0, 56, 62] fails device 0, then fails and restores
    device 2 at chunk 6: a migrated job's stale chunk reaches the feed
    before its ``restart_profile``.  Both packages refuse it."""
    with pytest.raises(ValueError, match="migrated mid-profile"):
        _schedule_run(PKGS[pkg], libs[pkg], [0, 56, 62], reprofile=False)


# ---------------------------------------------------------------------------
# ft helpers: the port's copies behave as the reference's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("survivors,batch", [(208, 256), (144, 256),
                                             (144, 250), (144, 3),
                                             (256, 96)])
def test_elastic_plan_and_rescale_match_reference(survivors, batch):
    rp = RFT.plan_new_mesh(RMesh((16, 16), ("data", "model")), survivors)
    tp = TFT.plan_new_mesh(TMesh((16, 16), ("data", "model")), survivors)
    assert (tp.new.shape, tp.lost_devices, tp.idle_devices,
            tp.surviving_devices) == (rp.new.shape, rp.lost_devices,
                                      rp.idle_devices, rp.surviving_devices)
    assert TFT.rescale_batch(batch, tp) == RFT.rescale_batch(batch, rp)


def test_straggler_monitor_and_adapter_match_reference():
    class _FC:
        def __init__(self, device_id, t_end):
            self.device_id, self.t_end = device_id, t_end

    out = []
    for ft in (RFT, TFT):
        adapter = ft.FleetStragglerAdapter(ft.StragglerMonitor(min_samples=5,
                                                               k=4.0))
        for i in range(8):
            for d, cadence in (("dev/0", 0.05), ("dev/1", 0.05),
                               ("dev/2", 0.5)):
                adapter.observe(_FC(d, i * cadence))
        mon = ft.StragglerMonitor(window=10, min_samples=3, k=4.0)
        for step in range(5):
            mon.record(9, step, 5.0)
        for host in range(3):
            for step in range(30):
                mon.record(host, step, 1.0)
        out.append((adapter.degraded(), adapter.devices(), adapter.dead(),
                    mon.dead_hosts(), mon.stragglers(),
                    mon.healthy_hosts([0, 1, 2, 9])))
    assert out[0] == out[1]
    assert out[1][0] == ["dev/2"] and out[1][3] == [9]


# ---------------------------------------------------------------------------
# the outcome targets' smoke counts through the port's session
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bench", ["fleet", "chaos"])
def test_smoke_outcome_targets_through_port_session(bench):
    """``bench_fleet.py --smoke`` and ``bench_chaos.py --smoke`` as
    ``chip_smoke.py`` drives them on the card, here on the CPU: the counts
    of ``results/fleet.json`` and ``results/chaos.json``."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    with open(os.path.join(ROOT, "results", f"{bench}.json")) as f:
        want = json.load(f)
    if bench == "fleet":
        got = chip_smoke.session_fleet_smoke(CPU)
        keys = ("early_decisions", "repacks", "chunks_dropped", "placed",
                "deferred", "planned_power_w", "budget_violations")
    else:
        got = chip_smoke.session_chaos_smoke(CPU)
        keys = ("failures", "migrations", "reprofiled_jobs", "repacks",
                "placed", "deferred", "planned_power_w",
                "classifier_calls_chaos", "budget_violations",
                "device_health")
        assert got["session"].report().migrations == want["migrations"]
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
