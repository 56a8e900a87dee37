"""Seed (pre-vectorization) implementations of the profiling hot path.

A verbatim copy of ``repro.legacy`` on the port's own types
(``WorkloadProfile``, ``KernelStream``, ``TPUPowerModel``): the frozen
scalar/Python-loop code the vectorized event-stream engine replaced.  It
stays NumPy on the host; where a port type hands it a tensor (a profile's
spike vector, the clustering distance matrix) it takes a host copy first.

  * ``simulate_dense``       — O(events x samples) dense-broadcast energy and
                               busy integration (``telemetry/simulator.py``)
  * ``ema_filter_loop``      — per-sample Python EMA (``core/spikes.py``)
  * ``power_neighbor_loop``/``util_neighbor_loop``/``choose_bin_size_loop``
                             — per-call spike-vector recomputation
                               (``core/classify.py`` / ``core/algorithm1.py``)
  * ``linkage_loop``         — per-point Lance-Williams update
  * ``silhouette_loop``      — per-point silhouette
  * ``kmeanspp_init_loop``   — O(k^2 n) kmeans++ seeding

They exist for exactly two consumers and nothing else:

  1. golden-equivalence tests (``tests/test_torch_legacy.py``) pinning the
     port's vectorized engine to the seed semantics at 1e-9, and
  2. ``chip_smoke.py``'s check of the card's EMA kernels against
     ``ema_filter_loop``.

Do not "fix" or optimize this module — it is the baseline.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.classify import WorkloadProfile
from repro_torch.telemetry.kernel_stream import KernelStream
from repro_torch.telemetry.power_model import OVERSHOOT_TAU, TPUPowerModel


def _host(x) -> np.ndarray:
    """A host NumPy copy of a port tensor (or array)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# ---------------------------------------------------------------------------
# telemetry: dense O(E x S) integration (seed simulate)
# ---------------------------------------------------------------------------
def _chunks(t0, t1, pw, size: int = 512):
    for i in range(0, len(t0), size):
        yield t0[i:i + size], t1[i:i + size], pw[i:i + size]


def integrate_events_dense(t0: np.ndarray, t1: np.ndarray, pw: np.ndarray,
                           edges: np.ndarray) -> np.ndarray:
    """Seed cumulative integral: per-edge dense clip-broadcast over events."""
    out = np.zeros(len(edges))
    for a, b, watts in _chunks(t0, t1, pw):
        contrib = np.clip(edges[None, :] - a[:, None], 0.0,
                          (b - a)[:, None]) * watts[:, None]
        out += contrib.sum(axis=0)
    return out


def simulate_dense(stream: KernelStream, freq: float, model: TPUPowerModel,
                   sample_dt: float = 1e-3, target_duration: float = 4.0,
                   max_iterations: int = 2000, noise: float = 0.03,
                   seed: int = 0):
    """The seed ``simulate`` (dense integration + loop EMA), verbatim.

    Returns the same ``SimTrace`` as ``repro_torch.telemetry.simulate``.
    """
    from repro_torch.telemetry.simulator import SimTrace

    execs = [model.exec_kernel(k, freq) for k in stream.kernels]
    gaps = np.array([k.gap_s for k in stream.kernels])
    durs = np.array([e.duration for e in execs])
    pows = np.array([e.power for e in execs])
    step_time = float(np.sum(gaps) + np.sum(durs))
    iters = int(np.clip(np.ceil(target_duration / max(step_time, 1e-9)),
                        1, max_iterations))

    nk = len(execs)
    idle = model.idle_w
    seg_d = np.empty(2 * nk)
    seg_p = np.empty(2 * nk)
    seg_busy = np.empty(2 * nk)
    seg_d[0::2] = gaps
    seg_d[1::2] = durs
    seg_p[0::2] = idle
    seg_p[1::2] = pows
    seg_busy[0::2] = 0.0
    seg_busy[1::2] = 1.0
    pad = max(10 * sample_dt, 0.01)
    d = np.concatenate([[pad], np.tile(seg_d, iters), [pad]])
    p = np.concatenate([[idle], np.tile(seg_p, iters), [idle]])
    busy_flag = np.concatenate([[0.0], np.tile(seg_busy, iters), [0.0]])
    keep = d > 0
    d, p, busy_flag = d[keep], p[keep], busy_flag[keep]

    t_edges = np.concatenate([[0.0], np.cumsum(d)])
    starts, ends = t_edges[:-1], t_edges[1:]
    ev_t0, ev_t1, ev_p = [starts], [ends], [p]
    prev_p = np.concatenate([[idle], p[:-1]])
    for i in np.nonzero(p - prev_p >= 30.0)[0]:
        amp = model.overshoot(prev_p[i], p[i])
        if amp is None:
            continue
        tau = min(OVERSHOOT_TAU, d[i])
        ev_t0.append(np.array([starts[i]]))
        ev_t1.append(np.array([starts[i] + tau]))
        ev_p.append(np.array([amp - p[i]]))
    t0 = np.concatenate(ev_t0)
    t1 = np.concatenate(ev_t1)
    pw = np.concatenate(ev_p)

    total_t = t_edges[-1]
    n_samples = int(total_t / sample_dt)
    edges = np.arange(n_samples + 1) * sample_dt

    energy = np.zeros(n_samples + 1)
    for a, b, watts in _chunks(t0, t1, pw):
        contrib = np.clip(edges[None, :] - a[:, None], 0.0,
                          (b - a)[:, None]) * watts[:, None]
        energy += contrib.sum(axis=0)

    rng = np.random.default_rng(seed)
    de = np.diff(energy)
    de = de * (1.0 + noise * rng.standard_normal(n_samples))
    out_mask = rng.random(n_samples) < 0.01
    de = np.where(out_mask, de * (1.0 + 0.5 * rng.random(n_samples)), de)
    p_raw = de / sample_dt

    busy_t0, busy_t1 = starts[busy_flag > 0], ends[busy_flag > 0]
    busy = np.zeros(n_samples)
    for a, b, _ in _chunks(busy_t0, busy_t1, np.ones_like(busy_t0)):
        contrib = np.clip(edges[None, :] - a[:, None], 0.0, (b - a)[:, None])
        busy += np.diff(contrib.sum(axis=0))
    busy = (busy > 0).astype(np.float64)

    filt = ema_filter_loop(p_raw, alpha=0.5)
    nz = np.nonzero(busy > 0)[0]
    filt = filt[nz[0]:nz[-1] + 1] if len(nz) else filt[:0]

    tot_d = durs.sum()
    app_sm = float((durs * [e.util_c for e in execs]).sum() / max(tot_d, 1e-12))
    app_dr = float((durs * [e.util_m for e in execs]).sum() / max(tot_d, 1e-12))
    rows = [(e.duration, e.util_c, e.util_m) for e in execs]
    return SimTrace(power_filtered=filt, power_raw=p_raw, busy=busy,
                    sample_dt=sample_dt, exec_time=step_time,
                    app_sm_util=app_sm, app_dram_util=app_dr,
                    kernel_rows=rows)


# ---------------------------------------------------------------------------
# spikes: per-sample Python EMA
# ---------------------------------------------------------------------------
def ema_filter_loop(power: np.ndarray, alpha: float = 0.5) -> np.ndarray:
    out = np.empty_like(power, dtype=np.float64)
    if len(power) == 0:
        return out
    acc = power[0]
    for i, p in enumerate(power):
        acc = alpha * p + (1 - alpha) * acc
        out[i] = acc
    return out


# ---------------------------------------------------------------------------
# classify: per-call spike-vector recomputation
# ---------------------------------------------------------------------------
def _cosine_distance(a: np.ndarray, b: np.ndarray) -> float:
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    if na == 0 or nb == 0:
        return 1.0
    return float(1.0 - np.clip(np.dot(a, b) / (na * nb), -1.0, 1.0))


def power_neighbor_loop(references: list[WorkloadProfile],
                        target: WorkloadProfile, bin_size: float = 0.1,
                        exclude: str | None = None):
    v = _host(target.spike_vec(bin_size))
    best, best_d = None, np.inf
    for r in references:
        if r.name == target.name or r.name == exclude:
            continue
        d = _cosine_distance(v, _host(r.spike_vec(bin_size)))
        if d < best_d:
            best, best_d = r, d
    return best, float(best_d)


def util_neighbor_loop(references: list[WorkloadProfile],
                       target: WorkloadProfile, exclude: str | None = None):
    v = target.util_point
    best, best_d = None, np.inf
    for r in references:
        if r.name == target.name or r.name == exclude:
            continue
        d = float(np.linalg.norm(v - r.util_point))
        if d < best_d:
            best, best_d = r, d
    return best, best_d


def choose_bin_size_loop(target: WorkloadProfile,
                         references: list[WorkloadProfile],
                         candidates=(0.05, 0.1, 0.15, 0.2, 0.25, 0.5),
                         quantile: float = 90.0) -> float:
    best_c, best_err = candidates[0], np.inf
    p_t = target.p_quantile(quantile)
    for c in candidates:
        nn, _ = power_neighbor_loop(references, target, bin_size=c)
        err = abs(p_t - nn.p_quantile(quantile))
        if err < best_err:
            best_c, best_err = c, err
    return best_c


# ---------------------------------------------------------------------------
# clustering: per-point loops
# ---------------------------------------------------------------------------
_LW = {
    "average": lambda ni, nj, nk: (ni / (ni + nj), nj / (ni + nj), 0.0, 0.0),
    "complete": lambda ni, nj, nk: (0.5, 0.5, 0.0, 0.5),
    "single": lambda ni, nj, nk: (0.5, 0.5, 0.0, -0.5),
}


def linkage_loop(dist: np.ndarray, method: str = "ward") -> np.ndarray:
    n = dist.shape[0]
    D = dist.astype(np.float64).copy()
    if method == "ward":
        D = D * D
    np.fill_diagonal(D, np.inf)
    sizes = {i: 1 for i in range(n)}
    ids = {i: i for i in range(n)}
    active = list(range(n))
    Z = np.zeros((n - 1, 4))
    big = np.full(D.shape, np.inf)
    big[:D.shape[0], :D.shape[1]] = D
    D = big
    next_id = n
    for step in range(n - 1):
        sub = D[np.ix_(active, active)]
        flat = np.argmin(sub)
        a, b = divmod(flat, len(active))
        if a == b:
            raise RuntimeError("degenerate linkage state")
        i, j = active[a], active[b]
        if i > j:
            i, j = j, i
        dij = D[i, j]
        d_rep = np.sqrt(dij) if method == "ward" else dij
        Z[step] = [ids[i], ids[j], d_rep, sizes[i] + sizes[j]]
        ni, nj = sizes[i], sizes[j]
        for k in active:
            if k in (i, j):
                continue
            nk = sizes[k]
            dik, djk = D[i, k], D[j, k]
            if method == "ward":
                tot = ni + nj + nk
                new = ((ni + nk) * dik + (nj + nk) * djk - nk * dij) / tot
            else:
                ai, aj, bb, g = _LW[method](ni, nj, nk)
                new = ai * dik + aj * djk + bb * dij + g * abs(dik - djk)
            D[i, k] = D[k, i] = new
        sizes[i] = ni + nj
        ids[i] = next_id
        next_id += 1
        active.remove(j)
        D[j, :] = np.inf
        D[:, j] = np.inf
    return Z


def silhouette_loop(X: np.ndarray, labels: np.ndarray) -> float:
    from repro_torch.core.clustering import euclidean_distance_matrix

    X = np.asarray(X, np.float64)
    labels = np.asarray(labels)
    n = len(X)
    uniq = np.unique(labels)
    if len(uniq) < 2 or n < 3:
        return 0.0
    D = _host(euclidean_distance_matrix(X))
    s = np.zeros(n)
    for i in range(n):
        same = labels == labels[i]
        n_same = same.sum()
        if n_same <= 1:
            s[i] = 0.0
            continue
        a = D[i, same].sum() / (n_same - 1)
        b = np.inf
        for c in uniq:
            if c == labels[i]:
                continue
            mask = labels == c
            b = min(b, D[i, mask].mean())
        s[i] = (b - a) / max(a, b) if max(a, b) > 0 else 0.0
    return float(np.mean(s))


def kmeanspp_init_loop(X: np.ndarray, k: int,
                       rng: np.random.Generator) -> np.ndarray:
    """Seed kmeans++ seeding: recomputes distances to ALL centers each step."""
    X = np.asarray(X, np.float64)
    centers = [X[rng.integers(len(X))]]
    while len(centers) < k:
        d2 = np.min(
            [np.sum((X - c) ** 2, axis=1) for c in centers], axis=0)
        tot = d2.sum()
        if tot <= 0:
            centers.append(X[rng.integers(len(X))])
            continue
        centers.append(X[rng.choice(len(X), p=d2 / tot)])
    return np.stack(centers)
