"""Versioned reference library: the mutable, persistent home of the
reference-profile set.

Replaces the ad-hoc ``list[WorkloadProfile]`` + ``reference_store.save/load``
pair with one object that owns:

  * **incremental membership** — ``add``/``remove`` bump a version counter
    and update the per-bin-size spike matrices row-wise instead of
    re-histogramming the whole set;
  * **warm-start persistence** — ``save`` writes the profiles (float64
    traces) *plus* the spike matrices keyed by a content fingerprint;
    ``load`` verifies the fingerprint and seeds ``MinosClassifier`` with the
    cached matrices, so a process cold-start skips the 28-trace
    re-histogramming entirely while producing byte-identical neighbor
    decisions (pinned by ``tests/test_pipeline.py``);
  * **cluster-based dedup** — near-identical spike behavior collapses via
    single-linkage clustering on the cosine distance matrix
    (``core/clustering.py``), keeping the first profile of each cluster.

The on-disk layout is the reference's (``library.json``, ``profiles.json``,
``traces.npz``, ``spike_cache.npz``): a library saved by ``repro`` loads here
and the reverse, with identical neighbours.  ``import_reference_library``
takes the same records and arrays in memory.  Traces and spike matrices live
on the library's device.
"""
from __future__ import annotations

import hashlib
import json
import os
import warnings
import zipfile

import numpy as np
import torch

from repro_torch.core.classify import FreqPoint, MinosClassifier, WorkloadProfile
from repro_torch.core.clustering import cosine_distance_matrix, cut, linkage
from repro_torch.device import DEFAULT_DEVICE, as_f64, resolve_device
from repro_torch.pipeline.builder import DEFAULT_BIN_SIZES

_LIBRARY_META = "library.json"
_SPIKE_CACHE = "spike_cache.npz"
_PROFILES = "profiles.json"
_TRACES = "traces.npz"


def _host(x) -> np.ndarray:
    """float64 NumPy copy of a tensor or array."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float64).cpu().numpy()
    return np.asarray(x, np.float64)


def _profile_digest(p: WorkloadProfile) -> str:
    h = hashlib.sha256()
    h.update(p.name.encode())
    h.update(np.float64(p.tdp).tobytes())
    h.update(np.ascontiguousarray(_host(p.power_trace)).tobytes())
    return h.hexdigest()


class ReferenceLibrary:
    """Ordered, versioned collection of reference ``WorkloadProfile``s."""

    def __init__(self, profiles=(), bin_sizes=DEFAULT_BIN_SIZES,
                 built_on: str = "", device=DEFAULT_DEVICE):
        self.device = resolve_device(device)
        self.bin_sizes = tuple(float(c) for c in bin_sizes)
        # provenance: the chip model the reference traces were captured on.
        # Profiles are stored relative to that device's TDP, so one library
        # serves a heterogeneous fleet through device-frame normalization
        # (see repro.fleet.inventory).
        self.built_on = built_on
        self._profiles: list[WorkloadProfile] = []
        self._spike: dict[float, torch.Tensor] = {}
        self.version = 0
        for p in profiles:
            self.add(p)

    # -- membership -----------------------------------------------------
    def __len__(self) -> int:
        return len(self._profiles)

    def __iter__(self):
        return iter(self._profiles)

    def __contains__(self, name: str) -> bool:
        return any(p.name == name for p in self._profiles)

    @property
    def profiles(self) -> list[WorkloadProfile]:
        return list(self._profiles)

    @property
    def names(self) -> list[str]:
        return [p.name for p in self._profiles]

    def get(self, name: str) -> WorkloadProfile:
        for p in self._profiles:
            if p.name == name:
                return p
        raise KeyError(name)

    def add(self, profile: WorkloadProfile) -> None:
        """Append a reference; spike matrices grow by one row (no rebuild)."""
        if profile.name in self:
            raise ValueError(f"duplicate reference name {profile.name!r} "
                             f"(remove it first to replace)")
        self._profiles.append(profile)
        for c in list(self._spike):
            row = as_f64(profile.spike_vec(c), self.device)[None, :]
            self._spike[c] = torch.cat([self._spike[c], row])
        self.version += 1

    def remove(self, name: str) -> WorkloadProfile:
        """Drop a reference by name; spike matrices lose its row."""
        for i, p in enumerate(self._profiles):
            if p.name == name:
                del self._profiles[i]
                for c in list(self._spike):
                    M = self._spike[c]
                    self._spike[c] = torch.cat([M[:i], M[i + 1:]])
                self.version += 1
                return p
        raise KeyError(name)

    def subset(self, keep) -> "ReferenceLibrary":
        """New library with the profiles for which ``keep(profile)`` holds;
        cached spike-matrix rows are carried over (no re-histogramming)."""
        mask = [bool(keep(p)) for p in self._profiles]
        out = ReferenceLibrary(bin_sizes=self.bin_sizes,
                               built_on=self.built_on, device=self.device)
        out._profiles = [p for p, m in zip(self._profiles, mask) if m]
        rows = torch.tensor(mask, dtype=torch.bool, device=self.device)
        out._spike = {c: M[rows] for c, M in self._spike.items()}
        out.version = 1
        return out

    # -- features & classification --------------------------------------
    def spike_matrix(self, bin_size: float) -> torch.Tensor:
        """(n_refs, n_bins) spike matrix, maintained incrementally."""
        c = float(bin_size)
        M = self._spike.get(c)
        if M is None:
            M = torch.stack([as_f64(p.spike_vec(c), self.device)
                             for p in self._profiles])
            self._spike[c] = M
        return M

    def warm_spike_cache(self) -> dict[float, torch.Tensor]:
        """All tracked matrices (computing any missing) — the classifier's
        warm-start seed."""
        return {c: self.spike_matrix(c) for c in self.bin_sizes}

    def classifier(self, bin_size: float = 0.1) -> MinosClassifier:
        """A ``MinosClassifier`` over the current membership, warm-started
        from the library's spike matrices."""
        if not self._profiles:
            raise ValueError("empty reference library")
        return MinosClassifier(self._profiles, bin_size=bin_size,
                               spike_cache=self.warm_spike_cache(),
                               device=self.device)

    def fingerprint(self) -> str:
        """Order-sensitive content hash of the membership (names + tdp +
        float64 trace bytes) — the spike-cache validity key."""
        h = hashlib.sha256()
        for p in self._profiles:
            h.update(_profile_digest(p).encode())
        return h.hexdigest()

    # -- dedup ----------------------------------------------------------
    def dedup(self, max_distance: float = 1e-9,
              bin_size: float = 0.1) -> list[str]:
        """Collapse references whose spike vectors cluster within
        ``max_distance`` cosine distance (single linkage), keeping the first
        profile of each cluster.  Returns the removed names."""
        if len(self._profiles) < 2:
            return []
        D = cosine_distance_matrix(self.spike_matrix(bin_size))
        labels = cut(linkage(D, method="single"), max_distance)
        keep_idx = {}
        removed = []
        for i, lab in enumerate(labels):
            if lab in keep_idx:
                removed.append(self._profiles[i].name)
            else:
                keep_idx[lab] = i
        for name in removed:
            self.remove(name)
        return removed

    # -- persistence ----------------------------------------------------
    def save(self, directory: str) -> None:
        """Write profiles + scaling data + the fingerprinted spike-matrix
        cache.  Traces are stored float64 so a reload is bit-exact (the
        warm-start byte-identity guarantee depends on it)."""
        os.makedirs(directory, exist_ok=True)
        meta, arrays = self.export_records()
        np.savez_compressed(os.path.join(directory, _TRACES), **arrays)
        with open(os.path.join(directory, _PROFILES), "w") as f:
            json.dump(meta, f, indent=1)
        cache = {f"c_{c!r}": _host(M)
                 for c, M in self.warm_spike_cache().items()}
        np.savez_compressed(os.path.join(directory, _SPIKE_CACHE), **cache)
        with open(os.path.join(directory, _LIBRARY_META), "w") as f:
            json.dump({"version": self.version,
                       "fingerprint": self.fingerprint(),
                       "bin_sizes": list(self.bin_sizes),
                       "built_on": self.built_on}, f, indent=1)

    def export_records(self) -> tuple[dict, dict]:
        """``(records, arrays)``: the profile records (``profiles.json``)
        and float64 trace arrays (``traces.npz``) exactly as ``save`` writes
        them — the form ``import_reference_library`` takes."""
        meta, arrays = {}, {}
        for i, p in enumerate(self._profiles):
            key = f"trace_{i}"
            arrays[key] = _host(p.power_trace)
            meta[p.name] = {
                "trace_key": key,
                "tdp": p.tdp,
                "sm_util": p.sm_util,
                "dram_util": p.dram_util,
                "exec_time": p.exec_time,
                "domain": p.domain,
                "scaling": {
                    repr(float(f)): {
                        "freq": fp.freq, "p90": fp.p90, "p95": fp.p95,
                        "p99": fp.p99, "mean_power": fp.mean_power,
                        "exec_time": fp.exec_time,
                    }
                    for f, fp in p.scaling.items()
                },
            }
        return meta, arrays

    @classmethod
    def load(cls, directory: str, device=DEFAULT_DEVICE) -> "ReferenceLibrary":
        """Load a saved library onto ``device``; when the on-disk spike
        cache's fingerprint matches the loaded membership, the matrices are
        adopted verbatim (warm start) instead of recomputed."""
        with open(os.path.join(directory, _PROFILES)) as f:
            meta = json.load(f)
        with np.load(os.path.join(directory, _TRACES)) as data:
            lib = import_reference_library(meta, data, device=device)
        lib_meta_path = os.path.join(directory, _LIBRARY_META)
        cache_path = os.path.join(directory, _SPIKE_CACHE)
        if os.path.exists(lib_meta_path) and os.path.exists(cache_path):
            # the warm-start cache is an optimization, never a dependency: a
            # corrupt/truncated library.json or spike_cache.npz degrades to
            # the cold matrix rebuild (bit-identical results, just slower)
            # instead of failing the load
            try:
                with open(lib_meta_path) as f:
                    lm = json.load(f)
                if lib._adopt_meta(lm):
                    with np.load(cache_path) as cache:
                        lib._adopt_spike_cache(cache)
            except (OSError, EOFError, ValueError, KeyError,
                    zipfile.BadZipFile) as e:
                warnings.warn(
                    f"spike cache under {directory!r} is corrupt or "
                    f"truncated ({type(e).__name__}: {e}); falling back to "
                    f"a cold spike-matrix rebuild", RuntimeWarning)
        return lib

    def _adopt_meta(self, lm: dict) -> bool:
        """Take version, bin sizes and provenance from a ``library.json``
        record; True when its fingerprint matches this membership (the spike
        cache written beside it is then valid)."""
        self.version = int(lm.get("version", 1))
        self.bin_sizes = tuple(float(c) for c in lm.get(
            "bin_sizes", DEFAULT_BIN_SIZES))
        self.built_on = lm.get("built_on", "")
        return lm.get("fingerprint") == self.fingerprint()

    def _adopt_spike_cache(self, cache) -> None:
        """Adopt ``spike_cache.npz``-keyed matrices (``"c_<bin>"``)."""
        self._spike = {float(k[2:]): as_f64(np.asarray(cache[k], np.float64),
                                            self.device)
                       for k in cache.keys()}

    @classmethod
    def load_or_build(cls, directory: str, build,
                      device=DEFAULT_DEVICE) -> "ReferenceLibrary":
        """Load from ``directory`` if present, else call ``build()`` for the
        profile list, save, and return the library."""
        if os.path.exists(os.path.join(directory, _PROFILES)):
            return cls.load(directory, device=device)
        lib = cls(build(), device=device)
        lib.save(directory)
        return lib


def import_reference_library(records: dict, arrays, lib_meta=None,
                             spike_cache=None,
                             device=DEFAULT_DEVICE) -> ReferenceLibrary:
    """A ``ReferenceLibrary`` on ``device`` from the reference package's
    saved form: ``records`` is the ``profiles.json`` dict (name -> profile
    record), ``arrays`` maps each record's ``trace_key`` to its float64
    trace (``traces.npz``).  ``lib_meta`` (``library.json``) and
    ``spike_cache`` (``spike_cache.npz``: ``"c_<bin>"`` -> matrix) are
    optional: the cached matrices are adopted only when ``lib_meta``'s
    fingerprint matches the imported membership."""
    lib = ReferenceLibrary(bin_sizes=(), device=device)
    for name, m in records.items():
        scaling = {float(f): FreqPoint(**fp)
                   for f, fp in m["scaling"].items()}
        lib._profiles.append(WorkloadProfile(
            name=name,
            tdp=m["tdp"],
            power_trace=as_f64(np.asarray(arrays[m["trace_key"]], np.float64),
                               lib.device),
            sm_util=m["sm_util"],
            dram_util=m["dram_util"],
            exec_time=m["exec_time"],
            scaling=scaling,
            domain=m.get("domain", ""),
        ))
    lib.version = 1
    lib.bin_sizes = tuple(DEFAULT_BIN_SIZES)
    if lib_meta is not None and lib._adopt_meta(lib_meta) \
            and spike_cache is not None:
        lib._adopt_spike_cache(spike_cache)
    return lib


def build_reference_library(model=None, freqs=None, seed: int = 0,
                            target_duration: float = 4.0,
                            chunk_samples: int = 256,
                            device=DEFAULT_DEVICE) -> ReferenceLibrary:
    """Build the shipped reference zoo through the streaming pipeline (one
    ``ProfileBuilder`` per workload x frequency, on ``device``) into a
    ``ReferenceLibrary``."""
    from repro_torch.analysis.hardware import FREQ_SWEEP
    from repro_torch.pipeline.builder import stream_profile_workload
    from repro_torch.telemetry.power_model import TPUPowerModel
    from repro_torch.telemetry.workloads import reference_streams

    device = resolve_device(device)
    model = model or TPUPowerModel()
    freqs = FREQ_SWEEP if freqs is None else freqs
    tdp = model.spec.tdp_w
    return ReferenceLibrary(
        (stream_profile_workload(s, model, freqs, tdp, seed=seed + i,
                                 target_duration=target_duration,
                                 chunk_samples=chunk_samples, device=device)
         for i, s in enumerate(reference_streams())),
        built_on=model.spec.name, device=device)
