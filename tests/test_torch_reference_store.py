"""The port's deprecated persistence shims, held to the reference's.

``tests/test_reference_store.py``'s cases on ``repro_torch.core.
reference_store`` (profile order, exact float scaling keys, float64 traces,
the warnings, float32 archives without sidecars, the library format read by
the shim), stores moved both ways between the packages' ``save_profiles``
/ ``load_profiles``, and the deprecated simulator entry points
``profile_workload`` / ``profile_once``, which warn and return what the
streaming builders return.  Everything runs with ``device="cpu"``.
"""
import json
import os

import numpy as np
import pytest
import torch

from repro.core.classify import FreqPoint as RefFreqPoint
from repro.core.classify import WorkloadProfile as RefWorkloadProfile
from repro.core.reference_store import load_profiles as ref_load_profiles
from repro.core.reference_store import save_profiles as ref_save_profiles
from repro_torch.core.classify import FreqPoint, WorkloadProfile
from repro_torch.core.reference_store import load_profiles, save_profiles
from repro_torch.pipeline import (ReferenceLibrary, stream_profile_once,
                                  stream_profile_workload)
from repro_torch.telemetry import TPUPowerModel
from repro_torch.telemetry.kernel_stream import micro_gemm, micro_stencil
from repro_torch.telemetry.simulator import profile_once, profile_workload

CPU = "cpu"
TDP = 180.0
# deliberately awkward frequency keys: only exact float-key preservation
# (via repr/float roundtrip) keeps scaling lookups working after a reload
FREQS = (0.6, 2.0 / 3.0, 0.8125, 1.0)
FIELDS = ("freq", "p90", "p95", "p99", "mean_power", "exec_time")


def _profile(name: str, level: float, seed: int, port: bool = True):
    rng = np.random.default_rng(seed)
    fp_cls, wp_cls = (FreqPoint, WorkloadProfile) if port else \
        (RefFreqPoint, RefWorkloadProfile)
    scaling = {
        f: fp_cls(freq=f, p90=level * f, p95=level * f + 0.03,
                  p99=level * f + 0.07, mean_power=level * f - 0.1,
                  exec_time=1.0 / f)
        for f in FREQS
    }
    trace = rng.normal(level * TDP, 7.0, 321)
    return wp_cls(
        name=name, tdp=TDP,
        power_trace=torch.from_numpy(trace) if port else trace,
        sm_util=rng.random(), dram_util=rng.random(), exec_time=1.25,
        scaling=scaling, domain="test")


SPECS = (("z-gemm", 1.3, 0), ("a-spmv", 0.7, 1), ("m-stencil", 0.95, 2))


@pytest.fixture()
def profiles():
    # z-/a- names: ordering must come from the save order, not name sort
    return [_profile(*s) for s in SPECS]


def _trace(p) -> np.ndarray:
    t = p.power_trace
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _assert_same(got, orig, trace_tol=None):
    assert [p.name for p in got] == [p.name for p in orig]
    for o, g in zip(orig, got):
        assert list(g.scaling) == list(o.scaling)
        for f in FREQS:
            assert f in g.scaling          # exact float key, not a repr-ish
            for attr in FIELDS:
                assert getattr(g.scaling[f], attr) == \
                    getattr(o.scaling[f], attr), (f, attr)
        if trace_tol is None:
            np.testing.assert_array_equal(_trace(g), _trace(o))
        else:
            np.testing.assert_allclose(_trace(g), _trace(o), **trace_tol)
        for attr in ("tdp", "sm_util", "dram_util", "exec_time", "domain"):
            assert getattr(g, attr) == getattr(o, attr), attr


def test_roundtrip_preserves_keys_dtypes_and_order(profiles, tmp_path):
    d = str(tmp_path)
    with pytest.deprecated_call():
        save_profiles(profiles, d, device=CPU)
    with pytest.deprecated_call():
        loaded = load_profiles(d, device=CPU)
    _assert_same(loaded, profiles)
    for got in loaded:
        # float64 in, float64 out, on the library's device
        assert got.power_trace.dtype == torch.float64
        assert got.power_trace.device.type == "cpu"


@pytest.mark.parametrize("name", ["save_profiles", "load_profiles"])
def test_shims_warn_and_name_the_port(name, profiles, tmp_path):
    d = str(tmp_path)
    if name == "load_profiles":
        ReferenceLibrary(profiles, device=CPU).save(d)
    with pytest.warns(DeprecationWarning,
                      match=rf"repro_torch\.core\.reference_store\.{name} "
                            r"is deprecated; use repro_torch\.pipeline\."
                            r"ReferenceLibrary"):
        if name == "save_profiles":
            save_profiles(profiles, d, device=CPU)
        else:
            load_profiles(d, device=CPU)


def test_loads_float32_archives_without_sidecars(profiles, tmp_path):
    """Directories without the library.json / spike_cache.npz sidecars and
    with float32 traces (the store's first format) still load."""
    d = str(tmp_path)
    meta, arrays = {}, {}
    for i, p in enumerate(profiles):
        key = f"trace_{i}"
        arrays[key] = _trace(p).astype(np.float32)
        meta[p.name] = {
            "trace_key": key, "tdp": p.tdp, "sm_util": p.sm_util,
            "dram_util": p.dram_util, "exec_time": p.exec_time,
            "domain": p.domain,
            "scaling": {str(f): {a: getattr(fp, a) for a in FIELDS}
                        for f, fp in p.scaling.items()},
        }
    np.savez_compressed(os.path.join(d, "traces.npz"), **arrays)
    with open(os.path.join(d, "profiles.json"), "w") as f:
        json.dump(meta, f)

    lib = ReferenceLibrary.load(d, device=CPU)
    assert lib.names == [p.name for p in profiles]
    assert lib._spike == {}               # no sidecars -> cold start
    for orig, got in zip(profiles, lib.profiles):
        assert got.power_trace.dtype == torch.float64
        np.testing.assert_allclose(_trace(got), _trace(orig),
                                   rtol=1e-6, atol=1e-4)
        assert list(got.scaling) == list(orig.scaling)
    lib.classifier()                      # still classifies
    with pytest.deprecated_call():
        assert [p.name for p in load_profiles(d, device=CPU)] == lib.names


def test_shim_and_library_formats_interoperate(profiles, tmp_path):
    d = str(tmp_path / "lib")
    ReferenceLibrary(profiles, device=CPU).save(d)
    with pytest.deprecated_call():
        loaded = load_profiles(d, device=CPU)   # shim reads library format
    _assert_same(loaded, profiles)


def test_reference_store_loads_in_the_port(tmp_path):
    """A directory the reference's ``save_profiles`` wrote loads with the
    port's ``load_profiles``, equal within 1e-12 (bit for bit here)."""
    d = str(tmp_path)
    ref = [_profile(*s, port=False) for s in SPECS]
    with pytest.deprecated_call():
        ref_save_profiles(ref, d)
    with pytest.deprecated_call():
        got = load_profiles(d, device=CPU)
    _assert_same(got, ref, trace_tol=dict(rtol=1e-12, atol=1e-12))


def test_port_store_loads_in_the_reference(profiles, tmp_path):
    """And the other way round."""
    d = str(tmp_path)
    with pytest.deprecated_call():
        save_profiles(profiles, d, device=CPU)
    with pytest.deprecated_call():
        got = ref_load_profiles(d)
    _assert_same(got, profiles, trace_tol=dict(rtol=1e-12, atol=1e-12))
    assert all(g.power_trace.dtype == np.float64 for g in got)


# ---------------------------------------------------------------------------
# the deprecated simulator entry points
# ---------------------------------------------------------------------------
def _equal_profiles(a, b):
    assert (a.name, a.tdp, a.sm_util, a.dram_util, a.exec_time, a.domain) \
        == (b.name, b.tdp, b.sm_util, b.dram_util, b.exec_time, b.domain)
    assert torch.equal(a.power_trace, b.power_trace)


def test_profile_workload_shim_warns_and_equals_the_builder():
    model = TPUPowerModel()
    tdp = model.spec.tdp_w
    with pytest.warns(DeprecationWarning,
                      match=r"repro_torch\.telemetry\.profile_workload is "
                            r"deprecated; use repro_torch\.pipeline\."
                            r"stream_profile_workload"):
        got = profile_workload(micro_gemm(), model, (0.7, 1.0), tdp, seed=4,
                               target_duration=0.3, device=CPU)
    want = stream_profile_workload(micro_gemm(), model, (0.7, 1.0), tdp,
                                   seed=4, target_duration=0.3, device=CPU)
    _equal_profiles(got, want)
    assert list(got.scaling) == list(want.scaling)
    for f, w in want.scaling.items():
        g = got.scaling[f]
        assert [getattr(g, a) for a in FIELDS] == \
            [getattr(w, a) for a in FIELDS]


def test_profile_once_shim_warns_and_equals_the_builder():
    model = TPUPowerModel()
    tdp = model.spec.tdp_w
    with pytest.warns(DeprecationWarning,
                      match=r"repro_torch\.telemetry\.profile_once is "
                            r"deprecated; use repro_torch\.pipeline\."
                            r"stream_profile_once"):
        got = profile_once(micro_stencil(), model, tdp, freq=0.8, seed=2,
                           device=CPU)
    want = stream_profile_once(micro_stencil(), model, tdp, freq=0.8, seed=2,
                               device=CPU)
    _equal_profiles(got, want)


def test_shims_are_exported_as_the_references_are():
    import repro.telemetry
    import repro_torch.telemetry
    for name in ("profile_workload", "profile_once"):
        assert hasattr(repro.telemetry, name)
        assert getattr(repro_torch.telemetry, name) is \
            globals()[name]
