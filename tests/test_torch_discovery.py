"""The port's online class discovery (``repro_torch.discovery`` and the
session's ``discovery=``) against the reference's on the CPU.

Each of ``tests/test_discovery.py``'s contracts is mirrored here, with both
packages run on the same seeded inputs (the micro zoo, 0.5 s profiles):

  * the pool (FIFO capacity, monotonic ids, restore) and the profile codec
    (float64-exact, and byte-equal to the reference's record);
  * the shadow gate, the knob errors and the guards on order and rollback;
  * the inert property (a high-confidence decision never changes), the
    promoted class absorbing new arrivals, the report field;
  * resume at every journal boundary with 0 classifier queries, resume
    mid-promotion then continue, warnings without the key.

Decisions, reports and discovery state equal the reference's with floats
within 1e-12 (the port's fixed-order distance sums may differ from NumPy's
in the last bit).  Also pinned: a discovery store written by either package
resumes in the other with 0 classifier calls; the records themselves are
byte-identical with a pinned ``ts``; and ``results/discovery.json``'s smoke
counts through ``chip_smoke.py``'s own drive.
"""
import glob
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.api as R
import repro.discovery as RD
import repro.pipeline.library as RL
import repro.store as RS
import repro_torch.api as T
import repro_torch.discovery as TD
import repro_torch.pipeline.library as TL
import repro_torch.store as TS
from repro_torch.store.journal import JOURNAL_FILE

CPU = "cpu"
FREQS = (0.6, 0.8, 1.0)
GATES = dict(min_confidence=0.2, min_fraction=0.1, min_spike_samples=50)
DISC = {"quarantine_below": 0.9, "min_cluster": 3, "recluster_every": 100,
        "promote_agreement": 0.5, "cluster_distance": 0.5}
FLOAT_TOL = 1e-12
REFERENCE = ("micro_gemm", "micro_idle_burst", "micro_spmv_memory",
             "micro_stencil")
D = {R: RD, T: TD}                 # package -> its discovery package
LIB = {R: RL, T: TL}               # package -> its library module
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SHARED: dict = {}       # lazy singletons: the hypothesis shim's @given
                         # wrapper is zero-arg, so the property test cannot
                         # take pytest fixtures


def _kw(A):
    return {"device": CPU} if A is T else {}


def _model(A):
    return A.TPUPowerModel()


def _library(A):
    if ("library", A) not in _SHARED:
        m = _model(A)
        _SHARED["library", A] = A.ReferenceLibrary(
            (A.stream_profile_workload(getattr(A, s)(), m, FREQS,
                                       m.spec.tdp_w, seed=i,
                                       target_duration=0.5, **_kw(A))
             for i, s in enumerate(REFERENCE)),
            built_on="tpu-v5e", **_kw(A))
    return _SHARED["library", A]


@pytest.fixture(scope="module")
def libs():
    return {R: _library(R), T: _library(T)}


def _telemetry(A, stream, seed):
    return A.stream_telemetry(stream, 1.0, _model(A), seed=seed,
                              target_duration=0.5)


def _novel_profiler(A):
    m = _model(A)
    return A.stream_profiler([A.micro_vector_search()], m, FREQS,
                             m.spec.tdp_w, target_duration=0.5, **_kw(A))


def _full_novel(A, seed):
    m = _model(A)
    return A.stream_profile_workload(A.micro_vector_search(), m, FREQS,
                                     m.spec.tdp_w, seed=seed,
                                     target_duration=0.5, **_kw(A))


def _assert_close(a, b, where="state"):
    """Equal structure and values (dicts equal as dicts: a snapshot stores
    its records with sorted keys); floats within 1e-12."""
    if isinstance(a, float) and isinstance(b, float):
        assert a == b or abs(a - b) <= FLOAT_TOL, (where, a, b)
    elif isinstance(a, dict) and isinstance(b, dict):
        assert sorted(a) == sorted(b), (where, sorted(a), sorted(b))
        for k in a:
            _assert_close(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        assert len(a) == len(b), (where, len(a), len(b))
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_close(x, y, f"{where}[{i}]")
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


def _spy_library_classifiers(A):
    """Patch package ``A``'s ``ReferenceLibrary.classifier`` so every
    classifier any library mints is query-counted; returns (restore,
    counters)."""
    counters = []
    cls = LIB[A].ReferenceLibrary
    orig = cls.classifier

    def patched(self, *a, **k):
        clf = orig(self, *a, **k)
        counters.append(A.count_classifier_calls(clf))
        return clf

    cls.classifier = patched
    return (lambda: setattr(cls, "classifier", orig)), counters


# ---------------------------------------------------------------------------
# unit: quarantine pool and the profile codec
# ---------------------------------------------------------------------------
def _entry_record(A, profile, entry_id, confidence=0.5):
    return D[A].PoolEntry(id=entry_id, name=profile.name,
                          confidence=confidence, device_id="tpu-v5e/000",
                          fraction=0.4, profile=profile).record()


def test_pool_fifo_capacity_and_ids(libs):
    records = {}
    for A in (R, T):
        profiles = list(libs[A])
        pool = D[A].QuarantinePool(capacity=3, **_kw(A))
        for i, p in enumerate(profiles):          # 4 adds into capacity 3
            assert pool.next_id == i + 1
            pool.add_record(_entry_record(A, p, pool.next_id))
        assert len(pool) == 3
        assert [e.name for e in pool] == [p.name for p in profiles[1:]]
        assert pool.next_id == 5                  # ids never reused
        records[A] = [e.record() for e in pool]
        assert pool.remove([e.id for e in list(pool)[:2]]) == 2
        assert len(pool) == 1
        pool.clear()
        assert len(pool) == 0
        with pytest.raises(ValueError, match="capacity must be >= 1"):
            D[A].QuarantinePool(capacity=0, **_kw(A))
    _assert_close(records[T], records[R], "pool")


def test_pool_restore_roundtrip(libs):
    profiles = list(libs[T])
    pool = TD.QuarantinePool(capacity=8, device=CPU)
    for p in profiles[:3]:
        pool.add_record(_entry_record(T, p, pool.next_id))
    records = [e.record() for e in pool]
    for A in (R, T):                   # the reference restores them too
        again = D[A].QuarantinePool(capacity=8, **_kw(A))
        again.restore(json.loads(json.dumps(records)), next_id=pool.next_id)
        assert [e.record() for e in again] == records
        assert again.next_id == pool.next_id
    assert all(e.profile.power_trace.device.type == "cpu" for e in again)


def test_profile_record_roundtrip_is_exact(libs):
    """float64-exact round trip in the port, and byte-equal records: a
    reference record decoded and re-encoded by the port (and the reverse)
    dumps to the same bytes."""
    for p in libs[T]:
        rec = json.loads(json.dumps(TD.profile_record(p)))
        q = TD.profile_from_record(rec, device=CPU)
        assert q.name == p.name and q.tdp == p.tdp and q.domain == p.domain
        assert q.power_trace.dtype == torch.float64
        assert torch.equal(q.power_trace, p.power_trace)
        assert q.sm_util == p.sm_util and q.dram_util == p.dram_util
        assert q.exec_time == p.exec_time
        assert set(q.scaling) == set(p.scaling)
        for f, fp in p.scaling.items():
            for field in ("freq", "p90", "p95", "p99", "mean_power",
                          "exec_time"):
                assert getattr(q.scaling[f], field) == getattr(fp, field)
        assert torch.equal(q.spike_vec(0.1), p.spike_vec(0.1))
    for rp, tp in zip(libs[R], libs[T]):
        ref_rec = RD.profile_record(rp)
        port_rec = TD.profile_record(tp)
        assert json.dumps(TD.profile_record(TD.profile_from_record(
            ref_rec, device=CPU))) == json.dumps(ref_rec)
        assert json.dumps(RD.profile_record(RD.profile_from_record(
            port_rec))) == json.dumps(port_rec)
        # the two packages' profiles of one workload: the same record
        assert json.dumps(port_rec) == json.dumps(ref_rec)


# ---------------------------------------------------------------------------
# unit: shadow evaluation
# ---------------------------------------------------------------------------
def test_truth_selection_is_self_neighbor(libs):
    sels = {}
    for A in (R, T):
        p = next(iter(libs[A]))
        sel = D[A].truth_selection(p)
        assert sel.power_neighbor == p.name and sel.power_distance == 0.0
        assert sel.util_neighbor == p.name and sel.util_distance == 0.0
        assert A.resolve_objective("powercentric").cap(sel) in p.scaling
        sels[A] = A.to_dict(sel)
    assert sels[T] == sels[R]


def test_shadow_gate_promotes_and_rejects(libs):
    reports = {}
    for A in (R, T):
        full = _full_novel(A, 9)
        members = [full] * 3
        confs = [0.3, 0.4, 0.5]
        report = D[A].ShadowEvaluator(libs[A], promote_agreement=0.5) \
            .evaluate(full, members, confs)
        assert report.promote and report.agreement == 1.0
        assert report.mean_confidence_after > report.mean_confidence_before
        strict = D[A].ShadowEvaluator(libs[A], promote_agreement=1.01)
        assert not strict.evaluate(full, members, confs).promote
        assert not D[A].ShadowEvaluator(libs[A]).evaluate(full, [],
                                                          []).promote
        gain = D[A].ShadowEvaluator(libs[A], promote_agreement=0.5,
                                    min_confidence_gain=0.99)
        assert not gain.evaluate(full, members, confs).promote
        reports[A] = report.record()
    _assert_close(reports[T], reports[R], "shadow")


# ---------------------------------------------------------------------------
# unit: controller versioning + validation
# ---------------------------------------------------------------------------
def test_controller_requires_reference_library(libs):
    with pytest.raises(ValueError, match="ReferenceLibrary"):
        TD.DiscoveryController(list(libs[T]))
    with pytest.raises(ValueError, match="ReferenceLibrary"):
        T.MinosSession(libs[T].classifier(), discovery={}, device=CPU,
                       **GATES)


def test_session_rejects_unknown_discovery_knob(libs):
    msgs = []
    for A in (R, T):
        with pytest.raises(ValueError, match="quarantine_below") as err:
            A.MinosSession(libs[A], discovery={"zzz": 1}, **GATES, **_kw(A))
        msgs.append(str(err.value))
        with pytest.raises(ValueError, match="knobs dict"):
            A.MinosSession(libs[A], discovery="yes", **GATES, **_kw(A))
    assert msgs[0] == msgs[1]


def test_force_propose_without_profiler_raises(libs):
    pools = {}
    for A in (R, T):
        session = A.MinosSession(libs[A], discovery=DISC, **GATES, **_kw(A))
        for i in range(3):
            session.submit(_telemetry(A, A.micro_vector_search(), 500 + i),
                           chips=1).run()
        assert len(session.discovery.pool) == 3
        assert session.discover(force=False) is None    # not due yet
        with pytest.raises(ValueError, match="profiler"):
            session.discover(force=True)
        pools[A] = session.discovery.state_record()
    _assert_close(pools[T], pools[R], "pool")


def test_promotions_apply_in_order_and_rollback_guards(libs):
    d = TD.DiscoveryController(libs[T])
    with pytest.raises(ValueError, match="no previous library"):
        d.rollback()
    full = _full_novel(T, 3)
    promo = TD.Promotion(version=3, profiles=[full],
                         profile_records=[TD.profile_record(full)],
                         consumed=[])
    with pytest.raises(ValueError, match="in order"):
        d.apply(promo)                      # current is 1; 3 skips 2
    promo.version = 2
    lib = d.apply(promo)
    assert d.version == 2 and lib.names == libs[T].names + [full.name]
    # rows are appended to the carried spike matrices, not re-histogrammed
    for c in libs[T].bin_sizes:
        M = lib.spike_matrix(c)
        assert torch.equal(M[:-1], libs[T].spike_matrix(c))
        assert torch.equal(M[-1], full.spike_vec(c))
    assert d.rollback() is libs[T] and d.version == 1


def test_rollback_restores_previous_membership(libs):
    outs = {}
    for A in (R, T):
        session = A.MinosSession(libs[A], discovery=DISC, **GATES, **_kw(A))
        for i in range(4):
            session.submit(_telemetry(A, A.micro_vector_search(), 600 + i),
                           chips=1).run()
        session.discovery.profiler = _novel_profiler(A)
        out = session.discover(force=True)
        assert out is not None and out["version"] == 2
        assert any("discovered-v2" in n
                   for n in session.discovery.library.names)
        rb = session.rollback_discovery()
        assert rb["version"] == 1
        assert list(session.discovery.library.names) == \
            list(libs[A].names)
        assert session._fleet.clf.references == libs[A].profiles
        with pytest.raises(ValueError, match="no previous"):
            session.rollback_discovery()
        outs[A] = (out, rb)
    _assert_close(outs[T], outs[R], "discover")


# ---------------------------------------------------------------------------
# the discovery-inert pin (hypothesis property)
# ---------------------------------------------------------------------------
def _promoted_session(A):
    """A discovery session that has quarantined novel traffic and promoted
    a discovered class — the maximally-perturbed counterpart the inert
    property compares against."""
    if ("promoted", A) not in _SHARED:
        session = A.MinosSession(_library(A), discovery=DISC, **GATES,
                                 **_kw(A))
        for i in range(4):
            session.submit(_telemetry(A, A.micro_vector_search(), 700 + i),
                           chips=2).run()
        session.discovery.profiler = _novel_profiler(A)
        assert session.discover(force=True) is not None
        _SHARED["promoted", A] = session
    return _SHARED["promoted", A]


def _plain_session(A):
    if ("plain", A) not in _SHARED:
        _SHARED["plain", A] = A.MinosSession(_library(A), **GATES, **_kw(A))
    return _SHARED["plain", A]


@settings(max_examples=6, deadline=None)
@given(st.sampled_from(range(len(REFERENCE))),
       st.integers(min_value=0, max_value=9999),
       st.sampled_from([1, 2, 4]))
def test_discovery_never_changes_high_confidence_decisions(
        stream_idx, seed, chips):
    """The same in-library job, submitted to a discovery-less session and
    to one that quarantined traffic AND promoted a class, reaches the same
    decision whenever the plain decision is high-confidence; each port
    decision equals the reference's."""
    got = {}
    for A in (R, T):
        stream = getattr(A, REFERENCE[stream_idx])()
        plain = _plain_session(A).submit(
            _telemetry(A, stream, 3000 + seed), chips=chips).run()
        disc = _promoted_session(A).submit(
            _telemetry(A, stream, 3000 + seed), chips=chips).run()
        if plain.confidence >= 0.5:
            assert disc.cap == plain.cap
            assert disc.early == plain.early
            assert disc.fraction == plain.fraction
            assert A.to_dict(disc.selection) == A.to_dict(plain.selection)
        got[A] = (A.to_dict(plain), A.to_dict(disc))
    _assert_close(got[T], got[R], "decisions")


def test_report_discovery_field_inert_by_default():
    reports = {}
    for A in (R, T):
        plain, promoted = _plain_session(A), _promoted_session(A)
        assert plain.report().discovery is None
        assert plain.discovery is None
        rep = promoted.report().discovery
        assert rep["version"] == 2 and rep["promotions"] == 1
        assert rep["classes"] and all("discovered-v2" in n
                                      for n in rep["classes"])
        reports[A] = rep
    assert reports[T]["classes"] == reports[R]["classes"]


def test_promoted_class_absorbs_new_arrivals():
    decisions = {}
    for A in (R, T):
        dec = _promoted_session(A).submit(
            _telemetry(A, A.micro_vector_search(), 4242), chips=2).run()
        assert "discovered-v2" in dec.selection.power_neighbor
        decisions[A] = A.to_dict(dec)
    _assert_close(decisions[T], decisions[R], "absorbed")


# ---------------------------------------------------------------------------
# durable discovery: crash-at-every-boundary across a version bump
# ---------------------------------------------------------------------------
def _disc_state(A, session) -> dict:
    d = session.discovery
    return {
        "version": d.version,
        "names": list(d.library.names),
        "state": json.loads(json.dumps(d.state_record())),
        "decisions": {jid: A.to_dict(j.decision)
                      for jid, j in session._fleet.jobs.items()
                      if j.decision is not None},
    }


@pytest.fixture(scope="module")
def discovery_stores(libs, tmp_path_factory):
    """One scripted durable discovery run per package — quarantines, a
    promotion, a post-promotion decision on the discovered class, and a
    rollback — with the discovery state recorded at every step boundary:
    package -> (store path, {journal seq: (tag, state)})."""
    out = {}
    for A in (R, T):
        path = str(tmp_path_factory.mktemp("disc") / "session")
        session = A.MinosSession(libs[A], store=path, discovery=DISC,
                                 **GATES, **_kw(A))
        session.discovery.profiler = _novel_profiler(A)
        boundaries = {}

        def mark(tag, session=session, boundaries=boundaries, A=A):
            boundaries[session.store.journal.last_seq] = (
                tag, _disc_state(A, session))

        mark("open")
        for i in range(4):
            session.submit(_telemetry(A, A.micro_vector_search(), 800 + i),
                           chips=2).run()
            mark(f"quarantine-{i}")
        promoted = session.discover(force=True)
        assert promoted is not None and promoted["version"] == 2
        mark("promote")
        session.submit(_telemetry(A, A.micro_vector_search(), 900),
                       chips=2).run()
        mark("post-promotion-decision")
        session.rollback_discovery()
        mark("rollback")
        session.close()
        out[A] = (path, boundaries)
    return out


def _truncate_journal(src, dst, keep_records):
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)
    jp = os.path.join(dst, JOURNAL_FILE)
    with open(jp, "rb") as f:
        lines = f.read().splitlines(keepends=True)
    with open(jp, "wb") as f:
        f.writelines(lines[:keep_records])


def _resume_spied(A, path, lib):
    restore, counters = _spy_library_classifiers(A)
    try:
        session = A.MinosSession.resume(path, references=lib, **_kw(A))
    finally:
        restore()
    return session, sum(c["n"] for c in counters)


def test_scripted_discovery_journals_match_reference(discovery_stores):
    """Both packages journal the same records at the same boundaries, with
    the same discovery state at each."""
    (rpath, rmarks), (tpath, tmarks) = (discovery_stores[R],
                                        discovery_stores[T])
    assert [(s, tag) for s, (tag, _) in rmarks.items()] == \
        [(s, tag) for s, (tag, _) in tmarks.items()]
    rrecs = RS.SessionStore.open_existing(rpath).recovered_records
    trecs = TS.SessionStore.open_existing(tpath).recovered_records
    assert [r.kind for r in rrecs] == [r.kind for r in trecs]
    assert {"quarantine", "promote", "rollback"} <= {r.kind for r in trecs}
    _assert_close([r.data for r in trecs], [r.data for r in rrecs],
                  "journal")
    for seq in tmarks:
        _assert_close(tmarks[seq][1], rmarks[seq][1], tmarks[seq][0])


def test_resume_every_boundary_readopts_promotion_verbatim(
        discovery_stores, libs, tmp_path):
    path, boundaries = discovery_stores[T]
    for seq, (tag, expected) in boundaries.items():
        crash = str(tmp_path / f"crash-{seq}")
        _truncate_journal(path, crash, seq)
        session, queries = _resume_spied(T, crash, libs[T])
        assert queries == 0, \
            f"resume at {tag!r} (seq {seq}) made {queries} classifier queries"
        assert _disc_state(T, session) == expected, \
            f"discovery state diverged at boundary {tag!r}"
        assert session._fleet.clf.references == \
            session.discovery.library.profiles
        session.close()


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_discovery_store_resumes_in_the_other_package(
        discovery_stores, libs, tmp_path, writer):
    """A store with quarantines, a promotion and a rollback, written by one
    package, resumes in the other at every boundary: the writer's
    discovery state and decisions, 0 classifier calls."""
    W, Rd = (R, T) if writer == "repro" else (T, R)
    path, boundaries = discovery_stores[W]
    for seq, (tag, expected) in boundaries.items():
        crash = str(tmp_path / f"crash-{seq}")
        _truncate_journal(path, crash, seq)
        session, queries = _resume_spied(Rd, crash, libs[Rd])
        assert queries == 0, (tag, queries)
        _assert_close(_disc_state(Rd, session), expected, tag)
        session.close()


def test_resume_mid_promotion_then_continue(discovery_stores, libs,
                                            tmp_path):
    """Crash right at the promotion boundary: the resumed session carries
    version 2 and a NEW arrival classifies to the discovered class, as in
    the reference; rollback still works after the resume."""
    decisions = {}
    for A in (R, T):
        path, boundaries = discovery_stores[A]
        promote_seq = next(seq for seq, (tag, _) in boundaries.items()
                           if tag == "promote")
        crash = str(tmp_path / f"resume-continue-{A.__name__}")
        _truncate_journal(path, crash, promote_seq)
        session = A.MinosSession.resume(crash, references=libs[A], **_kw(A))
        assert session.discovery.version == 2
        dec = session.submit(_telemetry(A, A.micro_vector_search(), 950),
                             chips=2).run()
        assert "discovered-v2" in dec.selection.power_neighbor
        assert session.rollback_discovery()["version"] == 1
        session.close()
        decisions[A] = A.to_dict(dec)
    _assert_close(decisions[T], decisions[R], "continued")


def test_resume_without_discovery_key_warns_on_discovery_records(
        discovery_stores, libs, tmp_path, monkeypatch):
    """A journal holding quarantine/promote records resumed by a session
    whose discovery config is gone warns and skips, never crashes."""
    path, boundaries = discovery_stores[T]
    crash = str(tmp_path / "strip")
    _truncate_journal(path, crash, max(boundaries))
    for snap in glob.glob(os.path.join(crash, "snapshot-*.json")):
        os.remove(snap)                  # force a full journal replay
    monkeypatch.setattr(T.MinosSession, "_init_discovery",
                        lambda self, discovery, references: None)
    with pytest.warns(RuntimeWarning, match="discovery"):
        session = T.MinosSession.resume(crash, references=libs[T],
                                        device=CPU)
    assert session.discovery is None
    session.close()


def test_discovery_records_byte_identical_with_pinned_ts(discovery_stores,
                                                         tmp_path):
    """The reference's quarantine, promote and rollback records, decoded
    and re-encoded by the port's codec and journaled by the port's store
    with a pinned ``ts``, are byte for byte the reference's lines."""
    rpath, _ = discovery_stores[R]
    recs = [r for r in RS.SessionStore.open_existing(rpath)
            .recovered_records
            if r.kind in ("quarantine", "promote", "rollback")]
    port_data = []
    for r in recs:
        data = dict(r.data)
        if r.kind == "quarantine":
            data["entry"] = TD.PoolEntry.from_record(data["entry"],
                                                     device=CPU).record()
        elif r.kind == "promote":
            data["profiles"] = [TD.profile_record(TD.profile_from_record(
                p, device=CPU)) for p in data["profiles"]]
        port_data.append(data)
    lines = {}
    for pkg, S, datas in ((R, RS, [r.data for r in recs]),
                          (T, TS, port_data)):
        path = str(tmp_path / f"{pkg.__name__}.jsonl")
        journal = S.EventJournal(path)
        for r, data in zip(recs, datas):
            journal.append(r.kind, data, ts=1234.5)
        journal.close()
        with open(path, "rb") as f:
            lines[pkg] = f.read()
    assert len(recs) >= 6 and lines[T] == lines[R]


# ---------------------------------------------------------------------------
# results/discovery.json through chip_smoke.py's own drive, on the CPU
# ---------------------------------------------------------------------------
def test_discovery_json_smoke_through_chip_smoke(tmp_path):
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    got = chip_smoke.discovery_bench(torch.device(CPU), True, str(tmp_path))
    with open(os.path.join(ROOT, "results", "discovery.json")) as f:
        want = json.load(f)
    chip_smoke.check_discovery_json(got["result"], want)
    assert set(got["launches"]) == set(chip_smoke.DISCOVERY_PARTS)
    assert got["continued"] == 2


def test_discovery_full_configuration_matches_reference(tmp_path,
                                                        monkeypatch):
    """``bench_discovery.py``'s full configuration (four novel families,
    1.0 s profiles) through ``chip_smoke.py``'s drive equals the
    reference bench's result but for the two latencies."""
    sys.path.insert(0, ROOT)
    try:
        import benchmarks.bench_discovery as bench
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    monkeypatch.setattr(bench, "RESULTS", str(tmp_path / "results"))
    want = bench.run(smoke=False)
    got = chip_smoke.discovery_bench(torch.device(CPU), False, str(tmp_path))
    chip_smoke.check_discovery_json(got["result"], want)
    assert len(want["promoted"]) == 3 and got["continued"] == 4
