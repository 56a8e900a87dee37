"""Port pipeline (``repro_torch.pipeline``) against the reference
(``repro.pipeline``) on the CPU: the same telemetry, made with numpy from a
seed, goes through both packages.  Traces, EMA state and spike histograms
must agree bit for bit; the validation messages word for word."""
import numpy as np
import pytest
import torch

from repro.pipeline import BatchProfileEngine as RefEngine
from repro.pipeline import ProfileBuilder as RefBuilder
from repro.pipeline import ReferenceLibrary as RefLibrary
from repro.pipeline import stream_profile_workload as ref_profile_workload
from repro.telemetry import TPUPowerModel as RefModel
from repro.telemetry.kernel_stream import (micro_gemm, micro_idle_burst,
                                           micro_spmv_memory, micro_stencil)
from repro.telemetry.simulator import TelemetryChunk, TraceMeta
from repro_torch.pipeline import (BatchProfileEngine, ProfileBuilder,
                                  ReferenceLibrary, build_reference_library,
                                  import_reference_library,
                                  stream_profile_workload)
from repro_torch.telemetry import TPUPowerModel, kernel_stream as tks

TDP = RefModel().spec.tdp_w
FREQS = (0.6, 0.8, 1.0)
CPU = "cpu"


def _counters(seed, n, name="synthetic"):
    rng = np.random.default_rng(seed)
    power = rng.uniform(0.0, 1.3 * TDP, size=n)
    busy = (rng.random(n) < 0.8).astype(float)
    busy[:int(rng.integers(0, 40))] = 0.0            # leading idle
    energy = np.concatenate([[0.0], np.cumsum(power * 1e-3)])
    busy_ctr = np.concatenate([[0.0], np.cumsum(busy * 1e-3)])
    meta = TraceMeta(name=name, domain="test", sample_dt=1e-3, n_samples=n,
                     exec_time=1.0, app_sm_util=0.5, app_dram_util=0.5,
                     kernel_rows=[])
    return meta, energy, busy_ctr


def _chunks(rng, meta, e, b):
    n = meta.n_samples
    cuts = sorted({int(c) for c in rng.integers(1, max(n, 2),
                                                size=int(rng.integers(0, 7)))
                   if 0 < c < n})
    bounds = [0] + cuts + [n]
    return [TelemetryChunk(energy_j=e[i + 1:j + 1], busy_s=b[i + 1:j + 1],
                           sample_dt=meta.sample_dt, start_index=i)
            for i, j in zip(bounds[:-1], bounds[1:])]


def _assert_same(ref, port):
    """Port builder (or slot view) equals a reference builder bit for bit."""
    assert ref.n_ingested == port.n_ingested
    assert ref.n_committed == port.n_committed
    assert ref.fraction == port.fraction
    assert ref.spike_count() == port.spike_count()
    for c in ref.bin_sizes:
        np.testing.assert_array_equal(ref.spike_vector(c),
                                      port.spike_vector(c).numpy())
    a, b = ref.snapshot(), port.snapshot()
    np.testing.assert_array_equal(a.power_trace, b.power_trace.numpy())
    assert (a.fraction, a.n_samples) == (b.fraction, b.n_samples)
    for c in ref.bin_sizes:
        np.testing.assert_array_equal(a.spike_vec(c), b.spike_vec(c).numpy())


@pytest.mark.parametrize("seed", range(6))
def test_profile_builder_bit_identical_under_random_chunking(seed):
    rng = np.random.default_rng(seed)
    meta, e, b = _counters(seed, int(rng.integers(1, 1500)))
    ref, port = RefBuilder(meta, TDP), ProfileBuilder(meta, TDP, device=CPU)
    for ck in _chunks(rng, meta, e, b):
        ref.ingest(ck)
        port.ingest(ck)
        _assert_same(ref, port)
    a, p = ref.finalize(), port.finalize()
    np.testing.assert_array_equal(a.power_trace, p.power_trace.numpy())
    assert p.complete and p.power_trace.dtype == torch.float64
    _assert_same(ref, port)


@pytest.mark.parametrize("scenario", range(10))
def test_batch_engine_bit_identical_with_admit_and_retire(scenario):
    """Random interleavings, chunk splits, mid-stream admit and retire with
    slot reuse: the port engine's slot views equal one reference
    ``ProfileBuilder`` per job, and its columns (histograms, EMA state,
    counters) equal the reference engine's, bit for bit."""
    rng = np.random.default_rng(1000 + scenario)
    port = BatchProfileEngine(capacity=2, device=CPU)   # forces growth
    ref_eng = RefEngine(capacity=2, backend="numpy")

    def new_job(name):
        meta, e, b = _counters(int(rng.integers(0, 10 ** 6)),
                               int(rng.integers(1, 1200)), name)
        return dict(ref=RefBuilder(meta, TDP), ref_sb=ref_eng.builder(meta, TDP),
                    sb=port.builder(meta, TDP),
                    chunks=_chunks(rng, meta, e, b), pos=0)

    live = {f"j{k}": new_job(f"j{k}") for k in range(int(rng.integers(2, 6)))}
    admits_left, next_id = 3, 100
    while live:
        remaining = [j for j in sorted(live)
                     if live[j]["pos"] < len(live[j]["chunks"])]
        if remaining:
            tick = [j for j in remaining if rng.random() < 0.7] \
                or [remaining[0]]
            slots, ref_slots, chunks = [], [], []
            for jid in tick:
                job = live[jid]
                ck = job["chunks"][job["pos"]]
                job["pos"] += 1
                job["ref"].ingest(ck)
                slots.append(job["sb"].slot)
                ref_slots.append(job["ref_sb"].slot)
                chunks.append(ck)
            port.ingest_batch(slots, chunks)
            ref_eng.ingest_batch(ref_slots, chunks)
            assert slots == ref_slots                 # same slot policy
            _assert_same(live[tick[0]]["ref"], live[tick[0]]["sb"])
            for c in port.bin_sizes:
                np.testing.assert_array_equal(port._hist[c].numpy(),
                                              ref_eng._hist[c])
            for col in ("_ema_state", "_energy", "_busy", "_next_index",
                        "_n_pending", "_n_committed", "_ema_has",
                        "_seen_busy"):
                np.testing.assert_array_equal(getattr(port, col).numpy(),
                                              getattr(ref_eng, col), col)
        if rng.random() < 0.15:
            jid = sorted(live)[int(rng.integers(len(live)))]
            job = live.pop(jid)
            _assert_same(job["ref"], job["sb"])
            job["sb"].release()
            job["ref_sb"].release()
            if admits_left and rng.random() < 0.5:   # slot reuse
                admits_left -= 1
                live[f"n{next_id}"] = new_job(f"n{next_id}")
                next_id += 1
        done = [j for j in sorted(live)
                if live[j]["pos"] >= len(live[j]["chunks"])]
        if done:
            jobs = [live.pop(j) for j in done]
            profs = port.finalize_batch([job["sb"].slot for job in jobs])
            ref_eng.finalize_batch([job["ref_sb"].slot for job in jobs])
            for job, p in zip(jobs, profs):
                a = job["ref"].finalize()
                np.testing.assert_array_equal(a.power_trace,
                                              p.power_trace.numpy())
                assert (a.fraction, a.n_samples) == (p.fraction, p.n_samples)
                for c in port.bin_sizes:
                    np.testing.assert_array_equal(a.spike_vec(c),
                                                  p.spike_vec(c).numpy())
                job["sb"].release()
                job["ref_sb"].release()


def test_snapshot_batch_equals_single_snapshots():
    rng = np.random.default_rng(5)
    eng = BatchProfileEngine(device=CPU)
    views = []
    for k in range(4):
        meta, e, b = _counters(k, 700, f"s{k}")
        sb = eng.builder(meta, TDP)
        for ck in _chunks(rng, meta, e, b)[:2]:
            sb.ingest(ck)
        views.append(sb)
    batch = eng.snapshot_batch([v.slot for v in views])
    for v, prof in zip(views, batch):
        one = v.snapshot()
        assert torch.equal(one.power_trace, prof.power_trace)
        for c in eng.bin_sizes:
            assert torch.equal(one.spike_vec(c), prof.spike_vec(c))


def _poisoned(kind):
    meta, e, b = _counters(3, 300, "poisoned")
    meta.device_id = "tpu-v5e/000"
    er, br = e[1:301].copy(), b[1:301].copy()
    dt = 1e-3
    if kind == "nan":
        er[50] = np.nan
    elif kind == "backwards":
        br[100] = br[99] - 1.0
    else:
        dt = 0.0
    return meta, e, b, TelemetryChunk(energy_j=er, busy_s=br, sample_dt=dt,
                                      start_index=0)


@pytest.mark.parametrize("kind", ["nan", "backwards", "dt"])
def test_validation_messages_verbatim_and_tick_all_or_nothing(kind):
    meta, e, b, bad = _poisoned(kind)
    with pytest.raises(ValueError) as want:
        RefBuilder(meta, TDP).ingest(bad)
    with pytest.raises(ValueError) as got:
        ProfileBuilder(meta, TDP, device=CPU).ingest(bad)
    assert str(got.value) == str(want.value)
    # engine: a good chunk and a poisoned one in one tick — the message is
    # the per-job builder's and no slot mutates
    eng = BatchProfileEngine(device=CPU)
    ok_meta, oe, ob = _counters(4, 300, "fine")
    sa, sb = eng.builder(ok_meta, TDP), eng.builder(meta, TDP)
    good = TelemetryChunk(energy_j=oe[1:301], busy_s=ob[1:301],
                          sample_dt=1e-3, start_index=0)
    with pytest.raises(ValueError) as got_eng:
        eng.ingest_batch((sa.slot, sb.slot), (good, bad))
    assert str(got_eng.value) == str(want.value)
    assert sa.n_ingested == 0 and sb.n_ingested == 0
    assert float(eng._hist_all.abs().sum()) == 0.0


def test_scalar_check_messages_match_reference():
    meta, e, b = _counters(8, 400)
    ck = TelemetryChunk(energy_j=e[1:101], busy_s=b[1:101], sample_dt=1e-3,
                        start_index=0)
    late = TelemetryChunk(energy_j=e[201:301], busy_s=b[201:301],
                          sample_dt=1e-3, start_index=200)
    for make in (lambda: (RefBuilder(meta, TDP), ProfileBuilder(
            meta, TDP, device=CPU)),
                 lambda: (RefEngine(backend="numpy").builder(meta, TDP),
                          BatchProfileEngine(device=CPU).builder(meta, TDP))):
        ref, port = make()
        ref.ingest(ck)
        port.ingest(ck)
        msgs = []
        for x in (ref, port):
            with pytest.raises(ValueError) as err:
                x.ingest(late)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]
        ref.finalize()
        port.finalize()
        msgs = []
        for x in (ref, port):
            with pytest.raises(ValueError) as err:
                x.ingest(late)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1] == "ProfileBuilder already finalized"


def _ref_library():
    model = RefModel()
    return RefLibrary(
        (ref_profile_workload(s, model, FREQS, model.spec.tdp_w, seed=i,
                              target_duration=0.6)
         for i, s in enumerate([micro_gemm(), micro_idle_burst(),
                                micro_spmv_memory(), micro_stencil()])),
        built_on=model.spec.name)


def _port_library():
    model = TPUPowerModel()
    return ReferenceLibrary(
        (stream_profile_workload(s, model, FREQS, model.spec.tdp_w, seed=i,
                                 target_duration=0.6, device=CPU)
         for i, s in enumerate([tks.micro_gemm(), tks.micro_idle_burst(),
                                tks.micro_spmv_memory(),
                                tks.micro_stencil()])),
        built_on=model.spec.name, device=CPU)


@pytest.fixture(scope="module")
def libraries():
    return _ref_library(), _port_library()


def test_stream_profile_workload_matches_reference(libraries):
    ref, port = libraries
    assert ref.names == port.names
    assert ref.fingerprint() == port.fingerprint()   # traces bit-identical
    for a, b in zip(ref, port):
        np.testing.assert_array_equal(a.power_trace, b.power_trace.numpy())
        assert (a.sm_util, a.dram_util, a.exec_time) == \
            (b.sm_util, b.dram_util, b.exec_time)
        for f in a.scaling:
            x, y = a.scaling[f], b.scaling[f]
            assert (x.p90, x.p95, x.p99, x.exec_time) == \
                (y.p90, y.p95, y.p99, y.exec_time)
            # the mean sums in another order than NumPy's pairwise sum
            assert abs(x.mean_power - y.mean_power) <= 1e-12
            np.testing.assert_array_equal(x.spike_vec, y.spike_vec.numpy())
    for c in port.bin_sizes:
        np.testing.assert_array_equal(ref.spike_matrix(c),
                                      port.spike_matrix(c).numpy())


def _neighbours(clf, profiles):
    return [(r.name, round(d, 12)) for r, d in clf.power_neighbors(profiles)]


@pytest.mark.parametrize("direction", ["port_to_ref", "ref_to_port"])
def test_library_saved_by_one_package_loads_in_the_other(libraries, tmp_path,
                                                         direction):
    ref, port = libraries
    if direction == "port_to_ref":
        port.save(str(tmp_path))
        loaded = RefLibrary.load(str(tmp_path))
        assert loaded.fingerprint() == port.fingerprint()
        assert loaded._spike          # warm start: the cache was adopted
        a, b = loaded.classifier(), port.classifier()
    else:
        ref.save(str(tmp_path))
        loaded = ReferenceLibrary.load(str(tmp_path), device=CPU)
        assert loaded.fingerprint() == ref.fingerprint()
        assert loaded._spike
        a, b = ref.classifier(), loaded.classifier()
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "library.json", "profiles.json", "spike_cache.npz", "traces.npz"]
    for c in (0.05, 0.1, 0.25):
        ra = a.power_neighbors(a.references, bin_size=c)
        rb = b.power_neighbors(b.references, bin_size=c)
        assert [r.name for r, _ in ra] == [r.name for r, _ in rb]
        np.testing.assert_allclose([d for _, d in ra], [d for _, d in rb],
                                   rtol=0, atol=1e-12)


def test_import_reference_library_from_records(libraries, tmp_path):
    ref, _ = libraries
    ref.save(str(tmp_path))
    import json
    with open(tmp_path / "profiles.json") as f:
        records = json.load(f)
    with open(tmp_path / "library.json") as f:
        lib_meta = json.load(f)
    arrays = dict(np.load(tmp_path / "traces.npz"))
    cache = dict(np.load(tmp_path / "spike_cache.npz"))
    lib = import_reference_library(records, arrays, lib_meta=lib_meta,
                                   spike_cache=cache, device=CPU)
    assert lib.names == ref.names and lib.built_on == ref.built_on
    assert lib.fingerprint() == ref.fingerprint()
    for c in ref.bin_sizes:
        np.testing.assert_array_equal(lib.spike_matrix(c).numpy(),
                                      ref.spike_matrix(c))


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    meta, _, _ = _counters(0, 10)
    for make in (lambda: ProfileBuilder(meta, TDP),
                 lambda: BatchProfileEngine(),
                 lambda: ReferenceLibrary(),
                 lambda: build_reference_library(target_duration=0.1)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
