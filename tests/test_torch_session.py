"""The port's ``MinosSession`` (``repro_torch.api``) against the
reference's (``repro.api``) on the CPU.

Pinned here, on the micro zoo and ``tests/test_store.py``'s scripted chaos
session (submit, decide, fail, budget, submit, run, degrade, retire,
restore):

  * the facade is byte-identical to the port's direct controllers, and its
    decisions equal the reference's (distances and confidence within
    1e-12, every other field exact);
  * crash at every journal boundary: the port resumes each truncated
    store with 0 classifier calls to exactly the live port state, and to
    the reference's state at the same boundary (floats within 1e-12);
  * a store written by either package resumes in the other with 0
    classifier calls and the same decisions and plans;
  * torn tails, corrupt middle records and corrupt snapshots recover;
    ``from_config`` takes the reference's keys, ``discovery`` included
    (its own pins are in ``tests/test_torch_discovery.py``).
"""
import glob
import json
import math
import os
import shutil
import warnings

import pytest
import torch

import repro.api as R
import repro_torch.api as T
from repro_torch.store.journal import JOURNAL_FILE

CPU = "cpu"
FREQS = (0.6, 0.8, 1.0)
GATES = dict(min_confidence=0.2, min_fraction=0.1, min_spike_samples=50)
FLOAT_TOL = 1e-12
TAGS = ("open", "submit-a", "decide-a", "submit-b", "fail", "budget",
        "submit-c", "run", "degrade", "retire", "restore")


def _kw(A):
    return {"device": CPU} if A is T else {}


def _library(A):
    model = A.TPUPowerModel()
    return A.ReferenceLibrary(
        (A.stream_profile_workload(s, model, FREQS, model.spec.tdp_w, seed=i,
                                   target_duration=0.5, **_kw(A))
         for i, s in enumerate([A.micro_gemm(), A.micro_idle_burst(),
                                A.micro_spmv_memory(), A.micro_stencil()])),
        built_on="tpu-v5e", **_kw(A))


@pytest.fixture(scope="module")
def libs():
    return {R: _library(R), T: _library(T)}


def _inventory(A):
    return A.DeviceInventory.generate({"tpu-v5e": 3, "tpu-v5p": 2},
                                      A.VariabilityModel(), seed=7)


def _telemetry(A, stream, seed):
    return A.stream_telemetry(stream, 1.0, A.TPUPowerModel(), seed=seed,
                              target_duration=0.5)


def _state(A, session) -> dict:
    """JSON-comparable view of everything resume must reproduce (the
    reference's ``tests/test_store.py::_state``)."""
    fleet = session._fleet
    return {
        "job_ids": sorted(fleet.jobs),
        "decisions": {jid: A.to_dict(j.decision) for jid, j in
                      fleet.jobs.items() if j.decision is not None},
        "plans": {jid: A.to_dict(j.plan) for jid, j in fleet.jobs.items()
                  if j.plan is not None},
        "health": fleet.device_health(),
        "events": [A.to_dict(e) for e in fleet.events],
        "retired": {jid: A.to_dict(d) if d is not None else None
                    for jid, d in session._retired.items()},
        "budget": A.to_dict(fleet.budget_w),
        "failed": sorted(fleet._failed_devices),
        "rr": session._rr,
    }


def _assert_close(a, b, where="state"):
    """Equal structure and values; floats within 1e-12 (the port's
    fixed-order distance sums may differ from NumPy's in the last bit)."""
    if isinstance(a, float) and isinstance(b, float):
        assert a == b or abs(a - b) <= FLOAT_TOL, (where, a, b)
    elif isinstance(a, dict) and isinstance(b, dict):
        assert list(a) == list(b), (where, list(a), list(b))
        for k in a:
            _assert_close(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list) and isinstance(b, list):
        assert len(a) == len(b), (where, len(a), len(b))
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_close(x, y, f"{where}[{i}]")
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


def _drive_scripted(A, session, mark=lambda tag: None):
    """``tests/test_store.py::_drive_scripted`` through package ``A``."""
    mark("open")
    a = session.submit(_telemetry(A, A.micro_gemm(), 100), chips=4)
    mark("submit-a")
    a.run()
    mark("decide-a")
    session.submit(_telemetry(A, A.micro_spmv_memory(), 101), chips=2)
    mark("submit-b")
    session.fail_device(a.device.device_id)
    mark("fail")
    session.set_budget(5000.0)
    mark("budget")
    c = session.submit(_telemetry(A, A.micro_stencil(), 102), chips=1)
    mark("submit-c")
    session.run()
    mark("run")
    session.degrade_device(c.device.device_id)
    mark("degrade")
    session.retire(a.job_id)
    mark("retire")
    session.restore_device(sorted(session._fleet._failed_devices)[0])
    mark("restore")
    return session


def _session(A, lib, **kw):
    return A.MinosSession(lib, inventory=_inventory(A), budget_w=20000.0,
                          **GATES, **_kw(A), **kw)


@pytest.fixture(scope="module")
def scripted(libs, tmp_path_factory):
    """One scripted durable run per package: package -> (store path,
    {tag: (journal seq, live state)})."""
    out = {}
    for A in (R, T):
        path = str(tmp_path_factory.mktemp("store") / "session")
        session = _session(A, libs[A], store=path)
        marks = {}

        def mark(tag, session=session, marks=marks, A=A):
            marks[tag] = (session.store.journal.last_seq, _state(A, session))

        _drive_scripted(A, session, mark)
        session.close()
        out[A] = (path, marks)
    return out


def _truncate(src: str, dst: str, keep: int) -> None:
    """Copy a store keeping the first ``keep`` journal records: the disk
    after a crash right after that append."""
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)
    jp = os.path.join(dst, JOURNAL_FILE)
    with open(jp, "rb") as f:
        lines = f.read().splitlines(keepends=True)
    with open(jp, "wb") as f:
        f.writelines(lines[:keep])


def _resume(A, path, lib):
    """Resume through package ``A`` with its classifier spied from before
    construction; returns (session, calls)."""
    clf = lib.classifier()
    calls = A.count_classifier_calls(clf)
    return A.MinosSession.resume(path, references=clf, **_kw(A)), calls


# ---------------------------------------------------------------------------
# facade == direct controller (test_api's pins on the port)
# ---------------------------------------------------------------------------
def _fleet_case(A, lib):
    inv = A.DeviceInventory.generate({"tpu-v5e": 2, "tpu-v5p": 1},
                                     A.VariabilityModel(), seed=5)
    jobs = [(A.micro_gemm, 8), (A.micro_spmv_memory, 4),
            (A.micro_spmv_compute, 2)]
    budget = 0.6 * sum(chips * inv[i % len(inv)].nameplate_w
                       for i, (_, chips) in enumerate(jobs))

    def streams_for(i, dev):
        return A.stream_telemetry(jobs[i][0](), 1.0, dev.power_model(),
                                  seed=40 + i, target_duration=0.5,
                                  chunk_samples=100, device_id=dev.device_id)

    fleet = A.FleetCapController(lib, budget_w=budget, **GATES, **_kw(A))
    mux = A.FleetTelemetryMux()
    for i, (_, chips) in enumerate(jobs):
        dev = inv[i % len(inv)]
        meta, chunks = streams_for(i, dev)
        mux.add_job(fleet.admit(dev, meta, chips), meta, chunks)
    direct = fleet.run(mux)
    session = A.MinosSession(lib, inventory=inv, budget_w=budget, **GATES,
                             **_kw(A))
    for i, (_, chips) in enumerate(jobs):
        dev = inv[i % len(inv)]
        session.submit(streams_for(i, dev), device=dev, chips=chips)
    return direct, session.run()


def test_session_byte_identical_to_fleet_controller(libs):
    direct, report = _fleet_case(T, libs[T])
    assert report.decisions == direct.decisions
    assert list(report.decisions) == list(direct.decisions)
    assert report.schedule.placed == direct.schedule.placed
    assert report.schedule.deferred == direct.schedule.deferred
    assert (report.repacks, report.chunks_dropped, report.budget_w) == \
        (direct.repacks, direct.chunks_dropped, direct.budget_w)
    # byte identity of the encoded results, and the reference's report
    assert T.to_json(report.decisions) == T.to_json(direct.decisions)
    assert T.to_json(report.schedule) == T.to_json(direct.schedule)
    _, ref = _fleet_case(R, libs[R])
    _assert_close(T.to_dict(report), R.to_dict(ref), "report")


def test_session_matches_online_controller_on_zoo(libs):
    """Every seventh stream of the 28-stream zoo (four in all, to keep the
    CPU run short) through ``submit``/``run`` equals the direct
    ``OnlineCapController.run`` of the port, and the reference's
    session."""
    lib = libs[T]
    assert len(T.reference_streams()) == 28
    streams = T.reference_streams()[::7]
    rstreams = R.reference_streams()[::7]
    session = T.MinosSession(lib, **GATES, device=CPU)
    rsession = R.MinosSession(libs[R], **GATES)
    model = T.TPUPowerModel()
    for i, (stream, rstream) in enumerate(zip(streams, rstreams)):
        got = session.submit(_telemetry(T, stream, 100 + i)).run()
        meta, chunks = _telemetry(T, stream, 100 + i)
        single = T.OnlineCapController(lib, **GATES)
        expect = single.run(meta, chunks, model.spec.tdp_w, device=CPU)
        for field in ("selection", "cap", "objective", "confidence",
                      "fraction", "n_samples", "early"):
            assert getattr(got, field) == getattr(expect, field), field
        ref = rsession.submit(_telemetry(R, rstream, 100 + i)).run()
        _assert_close(T.to_dict(got), R.to_dict(ref), stream.name)


def test_submit_feed_retire_submit_repacks_without_reclassify(libs):
    session = T.MinosSession(libs[T], **GATES, device=CPU)
    calls = T.count_classifier_calls(session.classifier)
    job_a = session.submit(_telemetry(T, T.micro_gemm(), 1), chips=4)
    job_b = session.submit(_telemetry(T, T.micro_spmv_memory(), 2), chips=4)
    job_a.run()
    job_b.run()
    n_decided = calls["n"]
    assert n_decided > 0
    w_a = job_a.plan().predicted_p90_w * job_a.plan().chips
    w_b = job_b.plan().predicted_p90_w * job_b.plan().chips
    big, small = (job_a, job_b) if w_a >= w_b else (job_b, job_a)
    session.set_budget(max(w_a, w_b) + 0.5 * min(w_a, w_b))
    rep = session.report()
    assert [p.job_id for p in rep.schedule.placed] == [big.job_id]
    assert big.retire().job_id == big.job_id
    rep = session.report()
    assert [p.job_id for p in rep.schedule.placed] == [small.job_id]
    assert big.job_id in rep.retired
    with pytest.raises(ValueError, match="retired"):
        big.feed([])
    with pytest.raises(KeyError, match="unknown or already-retired"):
        session.retire(big.job_id)
    meta, _ = _telemetry(T, T.micro_stencil(), 3)
    job_c = session.submit(meta)
    assert session.retire(job_c.job_id) is None
    assert job_c.decision() is None and job_c.plan() is None
    assert calls["n"] == n_decided


# ---------------------------------------------------------------------------
# the codec: what the port journals is host scalars, and round-trips
# ---------------------------------------------------------------------------
def test_report_json_roundtrip_and_codec(libs):
    session = _drive_scripted(T, _session(T, libs[T]))
    report = session.report()
    text = report.to_json()
    back = T.SessionReport.from_json(text)
    assert back == report
    assert back.to_json() == text == report.to_json()   # stable bytes
    # every journaled decision field is a host scalar: the strict codec
    # encodes it without knowing about tensors, and refuses a tensor
    d = next(iter(report.decisions.values()))
    raw = json.loads(T.to_json(d))
    assert raw["__type__"] == "CapDecision"
    assert isinstance(raw["confidence"], float)
    assert isinstance(raw["n_samples"], int)
    with pytest.raises(TypeError, match="not serializable"):
        T.to_dict(torch.tensor(1.0))
    with pytest.raises(ValueError, match="unknown serialized type"):
        T.from_dict({"__type__": "Nope"})
    # unbounded budgets serialize as strict JSON
    free = T.MinosSession(libs[T], **GATES, device=CPU)
    free.submit(_telemetry(T, T.micro_gemm(), 1)).run()
    text = free.run().to_json()
    assert "Infinity" not in text
    assert math.isinf(T.SessionReport.from_json(text).budget_w)
    # the reference decodes the port's report into an equal report
    _assert_close(R.to_dict(R.from_json(report.to_json())),
                  T.to_dict(report), "decoded")


# ---------------------------------------------------------------------------
# tentpole: crash at every journal boundary, 0 classifier calls
# ---------------------------------------------------------------------------
def test_scripted_journals_match_reference(scripted):
    """Both packages journal the same records at the same boundaries."""
    (rpath, rmarks), (tpath, tmarks) = scripted[R], scripted[T]
    assert list(rmarks) == list(tmarks) == list(TAGS)
    assert [s for s, _ in rmarks.values()] == [s for s, _ in tmarks.values()]
    rrecs = R.SessionStore.open_existing(rpath).recovered_records
    trecs = T.SessionStore.open_existing(tpath).recovered_records
    assert [r.kind for r in rrecs] == [r.kind for r in trecs]
    _assert_close([r.data for r in rrecs], [r.data for r in trecs],
                  "journal")
    for tag in TAGS:
        _assert_close(tmarks[tag][1], rmarks[tag][1], tag)


@pytest.mark.parametrize("tag", TAGS)
def test_resume_at_every_boundary(scripted, libs, tmp_path, tag):
    """Crash right after the boundary's last record, resume through the
    port: 0 classifier calls, exactly the live port state, and the
    reference's state at the same boundary."""
    path, marks = scripted[T]
    seq, expected = marks[tag]
    crash = str(tmp_path / "crash")
    _truncate(path, crash, seq)
    session, calls = _resume(T, crash, libs[T])
    assert calls["n"] == 0, f"resume at {tag!r} classified {calls['n']}x"
    got = _state(T, session)
    assert got == expected
    _assert_close(got, scripted[R][1][tag][1], tag)
    for job in session._fleet.jobs.values():
        if job.decision is None:
            assert job.needs_reprofile
    session.close()


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_store_resumes_in_the_other_package(scripted, libs, tmp_path,
                                            writer):
    """A store written by one package resumes in the other at every
    boundary with 0 classifier calls and the writer's decisions, plans,
    events and health."""
    W, Rd = (R, T) if writer == "repro" else (T, R)
    path, marks = scripted[W]
    for tag in TAGS:
        seq, expected = marks[tag]
        crash = str(tmp_path / f"crash-{tag}")
        _truncate(path, crash, seq)
        session, calls = _resume(Rd, crash, libs[Rd])
        assert calls["n"] == 0, (tag, calls["n"])
        _assert_close(_state(Rd, session), expected, tag)
        session.close()


def test_resume_after_any_single_record_never_crashes(scripted, libs,
                                                      tmp_path):
    path, _ = scripted[T]
    with open(os.path.join(path, JOURNAL_FILE), "rb") as f:
        total = len(f.read().splitlines())
    clf = libs[T].classifier()
    calls = T.count_classifier_calls(clf)
    for keep in range(1, total + 1):
        crash = str(tmp_path / "crash")
        _truncate(path, crash, keep)
        session = T.MinosSession.resume(crash, references=clf, device=CPU)
        assert session.report() is not None
        session.close()
    assert calls["n"] == 0


@pytest.mark.parametrize("damage", ["torn_tail", "corrupt_middle",
                                    "corrupt_snapshot"])
def test_resume_survives_damage(scripted, libs, tmp_path, damage):
    path, marks = scripted[T]
    last_seq, last_state = marks["restore"]
    crash = str(tmp_path / damage)
    _truncate(path, crash, last_seq)
    jp = os.path.join(crash, JOURNAL_FILE)
    if damage == "torn_tail":
        with open(jp, "ab") as f:
            f.write(b'{"seq": 999, "ts": 0.0, "kind": "bud')
        match = "torn record"
    elif damage == "corrupt_middle":
        for snap in glob.glob(os.path.join(crash, "snapshot-*.json")):
            os.remove(snap)                    # force pure journal replay
        with open(jp, "rb") as f:
            lines = f.read().splitlines(keepends=True)
        victim = len(lines) // 2
        lines[victim] = lines[victim].replace(b'"kind"', b'"kinX"', 1)
        with open(jp, "wb") as f:
            f.writelines(lines)
        match = None
    else:
        snaps = sorted(glob.glob(os.path.join(crash, "snapshot-*.json")))
        assert snaps
        with open(snaps[-1], "r+b") as f:
            f.seek(20)
            f.write(b"XXXXXX")
        match = "corrupt"
    with pytest.warns(RuntimeWarning, match=match):
        session, calls = _resume(T, crash, libs[T])
    assert calls["n"] == 0
    if damage == "corrupt_middle":
        assert session.store.journal.last_seq >= len(lines) // 2
    else:
        assert _state(T, session) == last_state
    session.close()


def test_reprofile_after_resume_reproduces_decision(scripted, libs,
                                                    tmp_path):
    path, marks = scripted[T]
    crash = str(tmp_path / "reprofile")
    _truncate(path, crash, marks["submit-b"][0])
    session, calls = _resume(T, crash, libs[T])
    b_id = next(jid for jid, j in session._fleet.jobs.items()
                if j.decision is None)
    handle = session.jobs[b_id]
    _, probe = _telemetry(T, T.micro_spmv_memory(), 101)
    with pytest.raises(ValueError, match="restart"):
        handle.feed(next(iter(probe)))
    assert calls["n"] == 0
    handle.reprofile(_telemetry(T, T.micro_spmv_memory(), 101))
    handle.run()
    assert T.to_dict(handle.decision()) == \
        marks["restore"][1]["decisions"][b_id]
    session.close()


def test_compacted_session_resumes_identically(libs, tmp_path):
    states, segments = {}, {}
    for mode, compact_every in (("plain", None), ("compact", 6)):
        path = str(tmp_path / mode)
        store = T.SessionStore.create(path, encode=T.to_dict,
                                      snapshot_every=4, rotate_every=3,
                                      compact_every=compact_every)
        session = _session(T, libs[T], store=store)
        _drive_scripted(T, session)
        session.close()
        resumed, calls = _resume(T, path, libs[T])
        assert calls["n"] == 0
        states[mode] = _state(T, resumed)
        resumed.close()
        segments[mode] = len(T.EventJournal.segments(
            os.path.join(path, JOURNAL_FILE)))
    assert states["compact"] == states["plain"]
    assert segments["compact"] < segments["plain"]


# ---------------------------------------------------------------------------
# store on/off, construction, errors
# ---------------------------------------------------------------------------
def test_store_is_inert_and_observes_only(libs, tmp_path):
    plain = _session(T, libs[T])
    assert plain.store is None and plain._fleet.journal is None
    stored = _session(T, libs[T], store=str(tmp_path / "s"))
    assert _state(T, _drive_scripted(T, plain)) == \
        _state(T, _drive_scripted(T, stored))
    assert plain.report().to_json() == stored.report().to_json()
    plain.close()                               # no-op without a store
    stored.close()
    with pytest.raises(ValueError, match="already holds a session journal"):
        T.MinosSession(libs[T], store=str(tmp_path / "s"), device=CPU)


def test_from_config_keys_and_store(libs, tmp_path):
    from repro.api.session import _CONFIG_KEYS as ref_keys
    from repro_torch.api.session import _CONFIG_KEYS
    assert _CONFIG_KEYS == ref_keys
    path = str(tmp_path / "cfg-store")
    session = T.MinosSession.from_config(
        {"devices": {"tpu-v5e": 2}, "budget_w": 1500.0, "store": path,
         "gates": {"min_confidence": 0.2}, "stragglers": {"window": 10}},
        references=libs[T], device=CPU)
    assert session.store is not None and session.device.type == "cpu"
    assert session._fleet.straggler_adapter.monitor.window == 10
    session.submit(_telemetry(T, T.micro_gemm(), 5)).run()
    session.close()
    resumed = T.MinosSession.resume(path, references=libs[T], device=CPU)
    assert len(resumed._fleet.jobs) == 1
    resumed.close()
    with pytest.raises(ValueError, match="did you mean 'budget_w'"):
        T.MinosSession.from_config({"budgett_w": 1.0}, references=libs[T],
                                   device=CPU)
    with pytest.raises(ValueError, match="recognized"):
        T.MinosSession.from_config({"zzz": 1}, references=libs[T],
                                   device=CPU)
    with pytest.raises(ValueError, match="unknown gate keys"):
        T.MinosSession.from_config({"gates": {"min_conf": 1}},
                                   references=libs[T], device=CPU)


def test_from_config_library_path_loads_on_device(libs, tmp_path):
    """A ``library`` path is loaded onto the session's device, recorded in
    the open record, and reloaded by ``resume``."""
    directory = str(tmp_path / "lib")
    libs[T].save(directory)
    store = str(tmp_path / "s")
    session = T.MinosSession.from_config(
        {"library": directory, "store": store}, device=CPU)
    assert session.classifier.device.type == "cpu"
    session.submit(_telemetry(T, T.micro_gemm(), 5)).run()
    decisions = session.report().to_json()
    session.close()
    resumed = T.MinosSession.resume(store, device=CPU)
    assert resumed.report().decisions == \
        T.SessionReport.from_json(decisions).decisions
    resumed.close()


def test_discovery_not_ported_and_discovery_records_skip(libs, tmp_path):
    """Discovery is ported: ``discovery=`` and the ``from_config`` key build
    the reference's controller (the same open-record knobs); a session
    without it has none, ``discover`` / ``rollback_discovery`` raise the
    reference's ``ValueError``, and discovery records in its journal are
    skipped with a warning, as the reference skips them."""
    for value in (True, {"capacity": 3}):
        built = [T.MinosSession(libs[T], discovery=value, device=CPU),
                 T.MinosSession.from_config({"discovery": value},
                                            references=libs[T], device=CPU)]
        want = R.MinosSession(libs[R], discovery=value).discovery
        for session in built:
            assert session.discovery.config_record() == \
                want.config_record()
            assert session.discovery.pool.device.type == "cpu"
            assert session.report().discovery == want.report_record()
    session = T.MinosSession(libs[T], discovery=False, device=CPU,
                             store=str(tmp_path / "s"))
    assert session.discovery is None and session.report().discovery is None
    for call in (session.discover, session.rollback_discovery):
        with pytest.raises(ValueError, match="no discovery configured"):
            call()
    for kind in ("quarantine", "promote", "rollback"):
        session.store.record(kind, version=2)
    session.store.close()                 # a crash: no closing snapshot
    with pytest.warns(RuntimeWarning, match="discovery 'quarantine'"):
        resumed = T.MinosSession.resume(str(tmp_path / "s"),
                                        references=libs[T], device=CPU)
    resumed.close()


def test_resume_errors_distinguish_missing_from_corrupt(libs, tmp_path):
    with pytest.raises(T.NoStoreError, match="no session store"):
        T.MinosSession.resume(str(tmp_path / "nowhere"), references=libs[T],
                              device=CPU)
    corrupt = tmp_path / "corrupt"
    corrupt.mkdir()
    (corrupt / JOURNAL_FILE).write_text("this is not a journal\n")
    with pytest.raises(T.StoreError, match="corrupt"), \
            warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        T.MinosSession.resume(str(corrupt), references=libs[T], device=CPU)


def test_session_requires_the_card_by_default(libs):
    """Entry points default to the card: without one they raise, and a
    library on the CPU cannot serve a session on another device."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.MinosSession(libs[T])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.MinosSession.from_config({}, references=libs[T])
