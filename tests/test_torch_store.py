"""The port's durable store (``repro_torch.store``) against the reference's
(``repro.store``) on the CPU.

The store is plain Python in both packages, so the port must speak the
reference's wire format exactly: the same record kinds, the same sha256
line checksum, segment rotation, compaction base and snapshot files.  The
unit tests mirror ``tests/test_store.py``'s (journal round trip and torn
tail, checksum and sequence breaks, ``batch()`` coalescing, rotation and
compaction, snapshot retention and the N-1 fallback, windowed reports);
the cross-package tests hold a journal written by either package to the
other's reader record for record, and the lines both packages write for
the same records equal apart from ``ts`` and the checksum (which covers
``ts``).
"""
import glob
import json
import math
import os

import pytest

import repro.store as RS
import repro_torch.store as TS
from repro.fleet import records as rrec
from repro.telemetry import TPUPowerModel as RModel
from repro.telemetry import stream_telemetry as r_stream_telemetry
from repro.telemetry.kernel_stream import micro_gemm as r_micro_gemm
from repro_torch.fleet import records as trec
from repro_torch.store import (EventJournal, SessionStore, SnapshotStore,
                               StoreError, kinds, store_report,
                               windowed_report)
from repro_torch.store.journal import JOURNAL_FILE
from repro_torch.telemetry import TPUPowerModel as TModel
from repro_torch.telemetry import stream_telemetry as t_stream_telemetry
from repro_torch.telemetry.kernel_stream import micro_gemm as t_micro_gemm

PACKAGES = {"repro": RS, "repro_torch": TS}
# payloads of every shape a session journals: nested dicts, lists, the
# tagged non-finite float, ints, bools, None and exact float reprs
RECORDS = [
    ("open", {"objective": "powercentric", "budget_w": {"__float__": "inf"},
              "gates": {"min_confidence": 0.2}, "devices": None}),
    ("admit", {"job_id": "a", "chips": 4, "mesh": None,
               "meta": {"n_samples": 523, "kernel_rows": [[0.1, 0.5, 0.2]]}}),
    ("decision", {"job_id": "a", "decision": {"__type__": "CapDecision",
                                              "confidence": 0.1 + 0.2,
                                              "early": True}}),
    ("budget", {"budget_w": 5000.0}),
    ("fail", {"device": "tpu-v5e/000"}),
    ("event", {"event": {"__type__": "FleetEvent", "kind": "migrate"}}),
    ("retire", {"job_id": "a"}),
]


def _write(pkg, path, records=RECORDS, ts=None):
    journal = pkg.EventJournal(path)
    for kind, data in records:
        journal.append(kind, data, ts=ts)
    journal.close()


def _lines(path):
    with open(path, "rb") as f:
        return [json.loads(line) for line in f]


# ---------------------------------------------------------------------------
# wire format: the two packages write and read each other's journals
# ---------------------------------------------------------------------------
def test_record_kinds_match_reference():
    from repro.store import kinds as rkinds
    names = [n for n in dir(rkinds) if n.isupper()]
    assert names == [n for n in dir(kinds) if n.isupper()]
    for name in names:
        assert getattr(kinds, name) == getattr(rkinds, name), name
    assert kinds.ALL_KINDS == rkinds.ALL_KINDS
    assert kinds.MARKER_KINDS == rkinds.MARKER_KINDS
    assert (TS.SNAPSHOT_EVERY, TS.ROTATE_EVERY, TS.SNAPSHOT_RETAIN,
            TS.JOURNAL_FILE) == (RS.SNAPSHOT_EVERY, RS.ROTATE_EVERY,
                                 RS.SNAPSHOT_RETAIN, RS.JOURNAL_FILE)


@pytest.mark.parametrize("writer,reader", [("repro", "repro_torch"),
                                           ("repro_torch", "repro")])
def test_journal_parses_in_the_other_package(tmp_path, writer, reader):
    jp = str(tmp_path / JOURNAL_FILE)
    _write(PACKAGES[writer], jp)
    got, good = PACKAGES[reader].EventJournal.recover(jp)
    own, own_good = PACKAGES[writer].EventJournal.recover(jp)
    assert good == own_good == os.path.getsize(jp)
    assert [(r.seq, r.ts, r.kind, r.data) for r in got] == \
        [(r.seq, r.ts, r.kind, r.data) for r in own]
    assert [(r.kind, r.data) for r in got] == RECORDS
    # the reader extends the writer's sequence in the same file
    journal, records = PACKAGES[reader].EventJournal.open_existing(jp)
    assert len(records) == len(RECORDS)
    assert journal.append("cursor", {"rr": 3}) == len(RECORDS) + 1
    journal.close()
    assert len(PACKAGES[writer].EventJournal.recover(jp)[0]) == \
        len(RECORDS) + 1


def test_same_records_give_the_same_lines(tmp_path):
    """Lines written by both packages for the same records: equal apart
    from ts (and the checksum, which covers ts); with a pinned ts the
    bytes are identical."""
    a, b = str(tmp_path / "a.jsonl"), str(tmp_path / "b.jsonl")
    _write(RS, a)
    _write(TS, b)
    la, lb = _lines(a), _lines(b)
    assert [sorted(x) for x in la] == [sorted(x) for x in lb]
    drop = ("ts", "sha")
    assert [{k: v for k, v in x.items() if k not in drop} for x in la] == \
        [{k: v for k, v in x.items() if k not in drop} for x in lb]
    _write(RS, a + ".pinned", ts=1234.5)
    _write(TS, b + ".pinned", ts=1234.5)
    with open(a + ".pinned", "rb") as fa, open(b + ".pinned", "rb") as fb:
        assert fa.read() == fb.read()


@pytest.mark.parametrize("writer,reader", [("repro", "repro_torch"),
                                           ("repro_torch", "repro")])
def test_snapshots_and_segments_read_across_packages(tmp_path, writer,
                                                     reader):
    path = str(tmp_path / "s")
    store = PACKAGES[writer].SessionStore.create(path, snapshot_every=5,
                                                 rotate_every=4)
    store.capture = lambda: {"n": store.journal.last_seq, "x": [0.1, None]}
    store.record("open", a=1)
    for i in range(13):
        store.record("tick", i=i)
        store.flush_snapshot()
    store.close()
    mine = PACKAGES[writer].SessionStore.open_existing(path)
    other = PACKAGES[reader].SessionStore.open_existing(path)
    assert other.load_snapshot() == mine.load_snapshot() == \
        ({"n": 10, "x": [0.1, None]}, 10)
    assert [(r.seq, r.kind, r.data) for r in other.records(after_seq=10)] \
        == [(r.seq, r.kind, r.data) for r in mine.records(after_seq=10)]
    assert other.open_record().data == {"a": 1}
    mine.close()
    other.close()


@pytest.mark.parametrize("direction", ["repro->repro_torch",
                                       "repro_torch->repro"])
def test_fleet_record_codecs_match_reference(direction):
    """Admit-record codecs: device, meta and mesh records are the same
    dicts in both packages and rebuild into equal objects across them."""
    from repro.configs.base import MeshConfig as RMesh
    from repro.fleet import DeviceInventory as RInv, VariabilityModel as RVar
    from repro_torch.configs.base import MeshConfig as TMesh
    from repro_torch.fleet import DeviceInventory as TInv
    from repro_torch.fleet import VariabilityModel as TVar
    rdev = RInv.generate({"tpu-v5e": 2, "tpu-v6e": 1}, RVar(), seed=3)[2]
    tdev = TInv.generate({"tpu-v5e": 2, "tpu-v6e": 1}, TVar(), seed=3)[2]
    rmeta, _ = r_stream_telemetry(r_micro_gemm(), 1.0, RModel(), seed=3,
                                  target_duration=0.3)
    tmeta, _ = t_stream_telemetry(t_micro_gemm(), 1.0, TModel(), seed=3,
                                  target_duration=0.3)
    rmesh, tmesh = RMesh((4, 2), ("data", "model")), \
        TMesh((4, 2), ("data", "model"))
    recs = [(rrec.device_record(rdev), trec.device_record(tdev)),
            (rrec.meta_record(rmeta), trec.meta_record(tmeta)),
            (rrec.mesh_record(rmesh), trec.mesh_record(tmesh))]
    for r, t in recs:
        assert json.dumps(r) == json.dumps(t)
    src, dst = (rrec, trec) if direction.startswith("repro->") \
        else (trec, rrec)
    dev = tdev if dst is trec else rdev
    meta = tmeta if dst is trec else rmeta
    mesh = tmesh if dst is trec else rmesh
    text = json.loads(json.dumps(recs[0][src is trec]))
    assert dst.device_from_record(text) == dev
    assert dst.device_from_record(text).effective_tdp_w == \
        dev.effective_tdp_w
    assert dst.meta_from_record(json.loads(json.dumps(
        recs[1][src is trec]))) == meta
    assert dst.mesh_from_record(recs[2][src is trec]) == mesh
    assert dst.mesh_from_record(None) is None


# ---------------------------------------------------------------------------
# journal unit behaviour (mirrors tests/test_store.py on the port)
# ---------------------------------------------------------------------------
def test_journal_roundtrip_and_torn_tail(tmp_path):
    jp = str(tmp_path / "j" / JOURNAL_FILE)
    journal = EventJournal(jp)
    for i in range(5):
        assert journal.append("tick", {"i": i}) == i + 1
    journal.close()
    records, good = EventJournal.recover(jp)
    assert [r.data["i"] for r in records] == list(range(5))
    assert good == os.path.getsize(jp)
    with open(jp, "ab") as f:
        f.write(b'{"seq": 6, "ts": 1.0, "ki')
    with pytest.warns(RuntimeWarning, match="torn"):
        journal2, records2 = EventJournal.open_existing(jp)
    assert len(records2) == 5
    assert os.path.getsize(jp) == good
    assert journal2.append("tick", {"i": 5}) == 6
    journal2.close()
    assert len(EventJournal.recover(jp)[0]) == 6


@pytest.mark.parametrize("damage,match,survivors", [
    ("checksum", "checksum", 2),
    ("sequence", "sequence", 1),
])
def test_journal_checksum_and_sequence_breaks(tmp_path, damage, match,
                                              survivors):
    jp = str(tmp_path / JOURNAL_FILE)
    journal = EventJournal(jp)
    for i in range(4):
        journal.append("tick", {"i": i})
    journal.close()
    with open(jp, "rb") as f:
        lines = f.read().splitlines(keepends=True)
    if damage == "checksum":     # a flipped payload in record 3
        bad = lines[:2] + [lines[2].replace(b'"i":2', b'"i":9', 1)] \
            + lines[3:]
    else:                        # record 2 missing: a sequence gap
        bad = [lines[0], lines[2]]
    with open(jp, "wb") as f:
        f.writelines(bad)
    with pytest.warns(RuntimeWarning, match=match):
        records, _ = EventJournal.recover(jp)
    assert len(records) == survivors


@pytest.mark.parametrize("fsync", [False, True])
def test_journal_batch_coalescing(tmp_path, fsync):
    """Inside ``batch()`` appends defer their flush to the outermost exit
    (re-entrant); an ``fsync=True`` journal keeps its per-record flush.
    Either way every record recovers intact."""
    jp = str(tmp_path / JOURNAL_FILE)
    journal = EventJournal(jp, fsync=fsync)
    journal.append("open", {})
    base = os.path.getsize(jp)
    with journal.batch():
        for i in range(3):
            journal.append("tick", {"i": i})
        with journal.batch():
            journal.append("tick", {"i": 3})
        mid = os.path.getsize(jp)
        assert (mid > base) if fsync else (mid == base)
    assert os.path.getsize(jp) > base
    journal.close()
    records, good = EventJournal.recover(jp)
    assert [r.kind for r in records] == ["open"] + ["tick"] * 4
    assert good == os.path.getsize(jp)


def test_session_store_batch_delegates(tmp_path):
    store = SessionStore.create(str(tmp_path / "s"))
    with store.batch():
        for i in range(4):
            store.record("tick", i=i)
    assert store.journal.last_seq == 4
    store.close()
    reopened = SessionStore.open_existing(str(tmp_path / "s"))
    assert [r.data["i"] for r in reopened.recovered_records] == [0, 1, 2, 3]
    reopened.close()


# ---------------------------------------------------------------------------
# snapshots
# ---------------------------------------------------------------------------
def test_snapshot_retention_and_fallback(tmp_path):
    store = SnapshotStore(str(tmp_path), retain=2)
    for seq in (3, 7, 11):
        store.write({"v": seq}, seq)
    files = sorted(glob.glob(str(tmp_path / "snapshot-*.json")))
    assert len(files) == 2
    assert store.load_latest() == ({"v": 11}, 11)
    with open(files[-1], "r+b") as f:
        f.seek(10)
        f.write(b"~~~~")
    with pytest.warns(RuntimeWarning, match="corrupt"):
        assert store.load_latest() == ({"v": 7}, 7)
    assert store.load_latest(max_seq=5) == (None, 0)


def test_session_store_snapshot_cadence(tmp_path):
    store = SessionStore.create(str(tmp_path / "s"), snapshot_every=3)
    store.capture = lambda: {"n": store.journal.last_seq}
    for i in range(7):
        store.record("tick", i=i)
        store.flush_snapshot()
    assert store.load_snapshot() == ({"n": 6}, 6)
    store.close()


def test_create_and_open_existing_errors(tmp_path):
    with pytest.raises(TS.NoStoreError, match="no session store"):
        SessionStore.open_existing(str(tmp_path / "nowhere"))
    assert issubclass(TS.NoStoreError, StoreError)
    store = SessionStore.create(str(tmp_path / "s"))
    store.record("open", a=1)
    store.close()
    reopened = SessionStore.open_existing(str(tmp_path / "s"))
    assert reopened.journal.last_seq == 1
    assert reopened.open_record().data == {"a": 1}
    reopened.close()


# ---------------------------------------------------------------------------
# rotation and compaction
# ---------------------------------------------------------------------------
def _ticked_store(path, n=40, snapshot_every=5, rotate_every=4,
                  compact_every=None):
    store = SessionStore.create(path, snapshot_every=snapshot_every,
                                rotate_every=rotate_every,
                                compact_every=compact_every)
    store.capture = lambda: {"n": store.journal.last_seq}
    store.record("open", a=1)
    for i in range(n):
        store.record("tick", i=i)
        store.flush_snapshot()
    return store


def test_compact_folds_segments_and_keeps_sequences(tmp_path):
    path = str(tmp_path / "s")
    store = _ticked_store(path, compact_every=10)
    last = store.journal.last_seq
    base = store.journal.base
    assert base is not None and base["base_seq"] > 0
    assert base["open"]["kind"] == "open"
    live = [k for k, _ in EventJournal.segments(store.journal.path)]
    assert live and min(live) > base["through_segment"]
    store.close()
    reopened = SessionStore.open_existing(path)
    assert reopened.journal.last_seq == last
    assert [r.seq for r in reopened.recovered_records] == \
        list(range(base["base_seq"] + 1, last + 1))
    opened = reopened.open_record()
    assert opened.kind == "open" and opened.seq == 1
    assert reopened.load_snapshot()[0] is not None
    assert reopened.record("tick", i=99) == last + 1
    reopened.close()


@pytest.mark.parametrize("case", ["n1_fallback", "fully_covered",
                                  "cadence"])
def test_compaction_rules(tmp_path, case):
    if case == "n1_fallback":
        # nothing folds while fewer than two intact snapshots exist
        store = SessionStore.create(str(tmp_path / "s"), rotate_every=3)
        for i in range(10):
            store.record("tick", i=i)
        assert store.compact() == 0
        store.capture = lambda: {"n": store.journal.last_seq}
        store.flush_snapshot(force=True)
        assert store.compact() == 0
        store.record("tick", i=10)
        assert store.compact() >= 1
        store.close()
    elif case == "fully_covered":
        # a segment folds only when the oldest retained snapshot covers it
        store = _ticked_store(str(tmp_path / "s"), n=20, snapshot_every=50,
                              rotate_every=3)
        store.snapshots.write({"n": 6}, 6)
        store.snapshots.write({"n": 18}, 18)
        store.capture = None
        assert store.compact() >= 1
        assert store.journal.base["base_seq"] == 6
        store.close()
    else:
        auto = _ticked_store(str(tmp_path / "auto"), compact_every=10)
        plain = _ticked_store(str(tmp_path / "plain"))
        assert auto.journal.base is not None
        assert plain.journal.base is None
        auto.close()
        plain.close()


def test_compacted_store_reads_identically_in_both_packages(tmp_path):
    """A store compacted by the port opens in the reference (and the other
    way round) with the same records, open record and snapshot."""
    for pkg_w, pkg_r in ((TS, RS), (RS, TS)):
        path = str(tmp_path / f"{pkg_w.__name__}")
        store = pkg_w.SessionStore.create(path, snapshot_every=5,
                                          rotate_every=4, compact_every=10)
        store.capture = lambda: {"n": store.journal.last_seq}
        store.record("open", a=1)
        for i in range(40):
            store.record("tick", i=i)
            store.flush_snapshot()
        store.close()
        a = pkg_w.SessionStore.open_existing(path)
        b = pkg_r.SessionStore.open_existing(path)
        assert [(r.seq, r.kind, r.data) for r in a.recovered_records] == \
            [(r.seq, r.kind, r.data) for r in b.recovered_records]
        assert a.open_record().data == b.open_record().data
        assert a.load_snapshot() == b.load_snapshot()
        a.close()
        b.close()


def test_corrupt_base_file_warns_and_fails_closed(tmp_path):
    path = str(tmp_path / "s")
    _ticked_store(path, compact_every=10).close()
    bp = EventJournal.base_path(os.path.join(path, JOURNAL_FILE))
    with open(bp, "r+b") as f:
        f.seek(5)
        f.write(b"XXXX")
    with pytest.warns(RuntimeWarning, match="journal base"):
        with pytest.raises(StoreError, match="no intact records"):
            SessionStore.open_existing(path)


# ---------------------------------------------------------------------------
# journal-derived reports
# ---------------------------------------------------------------------------
def test_windowed_report_handles_unbounded_budget():
    recs = [
        {"seq": 1, "ts": 0.0, "kind": "open",
         "data": {"budget_w": {"__float__": "inf"}}},
        {"seq": 2, "ts": 1.0, "kind": "admit", "data": {"job_id": "a"}},
        {"seq": 3, "ts": 2.0, "kind": "decision",
         "data": {"job_id": "a", "plan": {"job_id": "a",
                                          "predicted_p90_w": 123.0}}},
        {"seq": 4, "ts": 7200.0, "kind": "retire", "data": {"job_id": "a"}},
    ]
    windows = windowed_report(recs, window_s=3600.0)
    assert windows == RS.windowed_report(recs, window_s=3600.0)
    assert len(windows) == 3
    assert windows[0]["planned_w"] == 123.0
    assert windows[0]["utilization"] is None
    assert windows[0]["headroom_w"] == math.inf
    assert windows[1]["records"] == 0
    assert windows[2]["retires"] == 1 and windows[2]["planned_w"] == 0.0
    with pytest.raises(ValueError, match="positive"):
        windowed_report(recs, window_s=0.0)
    assert windowed_report([], window_s=60.0) == []


def test_store_report_matches_reference(tmp_path):
    """``store_report`` over one on-disk journal: the same windows from
    both packages' readers."""
    path = str(tmp_path / "s")
    store = SessionStore.create(path)
    store.record("open", budget_w=1000.0)
    store.record("admit", job_id="a")
    store.record("decision", job_id="a",
                 plan={"job_id": "a", "predicted_p90_w": 250.0})
    store.record("fail", device="tpu-v5e/000")
    store.record("event", event={"kind": "migrate"})
    store.record("retire", job_id="a")
    store.close()
    got = store_report(path, window_s=3600.0)
    assert got == RS.store_report(path, window_s=3600.0)
    assert sum(w["admits"] for w in got) == 1
    assert sum(w["failures"] for w in got) == 1
