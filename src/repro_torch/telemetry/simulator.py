"""Event-based telemetry simulator: kernel stream -> sampled power trace.

Produces exactly what the paper's profiling harness sees on hardware:
  * an energy-accumulator counter sampled every 1-2 ms (noisy, per [87])
  * a busy-cycles counter (for idle trimming)
  * per-kernel (duration, compute-util, memory-util) rows (the nsight
    analogue) — aggregated into the app-level utilization point.

Integration is vectorized: power is piecewise-constant over events, so the
cumulative energy E(t) is piecewise-linear and sampling it at bin edges is a
single ``np.interp``.  Concretely (``integrate_events``): power deltas are
accumulated at the sorted event endpoints with ``np.add.at``, one prefix sum
gives the piecewise-constant rate, a second gives the cumulative integral at
the breakpoints, and ``np.interp`` evaluates it at all sample edges — O((E+S)
log E) instead of an O(E x S) dense clip-broadcast.  The busy counter uses
the same engine with unit weights.  This module is a host copy of
``repro.telemetry.simulator``: the same seeds give the same chunks.

Two consumption modes share the event engine:

  * ``simulate`` — the batch path: the whole trace at once (``SimTrace``).
  * ``stream_telemetry`` — the streaming path: yields ``TelemetryChunk``s of
    raw *counter readings* (cumulative energy joules + cumulative busy
    seconds at each sample edge), exactly what a telemetry daemon polls on
    hardware.  ``repro_torch.pipeline.ProfileBuilder`` ingests these chunks
    incrementally and can emit a partial profile at any point.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core import spikes as spk
from repro_torch.core.classify import WorkloadProfile
from repro_torch.device import DEFAULT_DEVICE
from repro_torch.telemetry.kernel_stream import KernelStream
from repro_torch.telemetry.power_model import (
    OVERSHOOT_TAU, TPUPowerModel,
)


@dataclass
class SimTrace:
    power_filtered: np.ndarray       # after Δe/Δt + EMA + trim (what Minos sees)
    power_raw: np.ndarray
    busy: np.ndarray
    sample_dt: float
    exec_time: float                 # one iteration of the stream (s)
    app_sm_util: float
    app_dram_util: float
    kernel_rows: list = field(default_factory=list)


@dataclass
class TelemetryChunk:
    """One poll of the chip's accumulating counters: readings at the sample
    edges ``start_index+1 .. start_index+len(energy_j)`` (edge 0 reads 0/0,
    so the first chunk starts at index 0).  Readings are cumulative since
    trace start; the consumer differentiates against its own prefix state."""
    energy_j: np.ndarray         # cumulative energy counter (J), one per edge
    busy_s: np.ndarray           # cumulative busy-time counter (s), aligned
    sample_dt: float
    start_index: int             # absolute sample index of the first reading


@dataclass
class TraceMeta:
    """Trace-level context a streaming consumer needs up front."""
    name: str
    domain: str
    sample_dt: float
    n_samples: int               # total samples the stream will deliver
    exec_time: float             # one iteration of the kernel stream (s)
    app_sm_util: float
    app_dram_util: float
    kernel_rows: list = field(default_factory=list)
    device_id: str = ""          # originating fleet device ("" = unspecified)


@dataclass
class _EventTrace:
    """Shared precursor of both consumption modes: the event list plus the
    per-stream aggregates, before any sampling/noise is applied."""
    t0: np.ndarray               # power-event starts
    t1: np.ndarray               # power-event ends
    pw: np.ndarray               # power-event rates (W)
    busy_t0: np.ndarray          # busy-segment starts
    busy_t1: np.ndarray          # busy-segment ends
    edges: np.ndarray            # sample edges (n_samples + 1)
    n_samples: int
    sample_dt: float
    exec_time: float
    app_sm_util: float
    app_dram_util: float
    kernel_rows: list


def _event_trace(stream: KernelStream, freq: float, model: TPUPowerModel,
                 sample_dt: float, target_duration: float,
                 max_iterations: int) -> _EventTrace:
    execs = [model.exec_kernel(k, freq) for k in stream.kernels]
    gaps = np.array([k.gap_s for k in stream.kernels])
    durs = np.array([e.duration for e in execs])
    pows = np.array([e.power for e in execs])
    step_time = float(np.sum(gaps) + np.sum(durs))
    iters = int(np.clip(np.ceil(target_duration / max(step_time, 1e-9)),
                        1, max_iterations))

    # --- build the event list (times, power levels) for all iterations ---
    nk = len(execs)
    idle = model.idle_w
    # per-iteration event pattern: [gap_0, k_0, gap_1, k_1, ...]
    seg_d = np.empty(2 * nk)
    seg_p = np.empty(2 * nk)
    seg_busy = np.empty(2 * nk)
    seg_d[0::2] = gaps
    seg_d[1::2] = durs
    seg_p[0::2] = idle
    seg_p[1::2] = pows
    seg_busy[0::2] = 0.0
    seg_busy[1::2] = 1.0
    # head/tail idle padding so trimming has something to trim
    pad = max(10 * sample_dt, 0.01)
    d = np.concatenate([[pad], np.tile(seg_d, iters), [pad]])
    p = np.concatenate([[idle], np.tile(seg_p, iters), [idle]])
    busy_flag = np.concatenate([[0.0], np.tile(seg_busy, iters), [0.0]])
    # drop zero-length segments
    keep = d > 0
    d, p, busy_flag = d[keep], p[keep], busy_flag[keep]

    # --- overshoot events at low->high transitions ---
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
        # overshoot is *additional* power on top of the segment
        ev_p.append(np.array([amp - p[i]]))
    t0 = np.concatenate(ev_t0)
    t1 = np.concatenate(ev_t1)
    pw = np.concatenate(ev_p)

    total_t = t_edges[-1]
    n_samples = int(total_t / sample_dt)
    edges = np.arange(n_samples + 1) * sample_dt

    busy_t0, busy_t1 = starts[busy_flag > 0], ends[busy_flag > 0]
    tot_d = durs.sum()
    app_sm = float((durs * [e.util_c for e in execs]).sum() / max(tot_d, 1e-12))
    app_dr = float((durs * [e.util_m for e in execs]).sum() / max(tot_d, 1e-12))
    rows = [(e.duration, e.util_c, e.util_m) for e in execs]
    return _EventTrace(t0=t0, t1=t1, pw=pw, busy_t0=busy_t0, busy_t1=busy_t1,
                       edges=edges, n_samples=n_samples, sample_dt=sample_dt,
                       exec_time=step_time, app_sm_util=app_sm,
                       app_dram_util=app_dr, kernel_rows=rows)


def _noisy_energy_increments(ev: _EventTrace, noise: float,
                             seed: int) -> np.ndarray:
    """Per-sample energy-counter increments with sensor noise (paper [87]:
    energy-derived power is spiky).  RNG call order is frozen — the golden
    tests pin it against ``legacy.simulate_dense``."""
    energy = integrate_events(ev.t0, ev.t1, ev.pw, ev.edges)
    rng = np.random.default_rng(seed)
    de = np.diff(energy)
    de = de * (1.0 + noise * rng.standard_normal(ev.n_samples))
    # occasional sensor outliers
    out_mask = rng.random(ev.n_samples) < 0.01
    return np.where(out_mask, de * (1.0 + 0.5 * rng.random(ev.n_samples)), de)


def _busy_counter(ev: _EventTrace) -> np.ndarray:
    """Cumulative busy-seconds counter at every sample edge."""
    return integrate_events(ev.busy_t0, ev.busy_t1,
                            np.ones_like(ev.busy_t0), ev.edges)


def simulate(stream: KernelStream, freq: float, model: TPUPowerModel,
             sample_dt: float = 1e-3, target_duration: float = 4.0,
             max_iterations: int = 2000, noise: float = 0.03,
             seed: int = 0) -> SimTrace:
    ev = _event_trace(stream, freq, model, sample_dt, target_duration,
                      max_iterations)
    de = _noisy_energy_increments(ev, noise, seed)
    p_raw = de / sample_dt

    # busy counter per sample: busy-time overlap via the same event engine
    busy_time = np.diff(_busy_counter(ev))
    busy = (busy_time > 0).astype(np.float64)

    # backend pinned: host-side simulation stays float64-reproducible on
    # every host (the f32 EMA kernel is for on-device use)
    filt = spk.ema_filter(p_raw, alpha=0.5, backend="numpy")
    filt = spk.trim_idle(filt, busy)

    return SimTrace(power_filtered=filt, power_raw=p_raw, busy=busy,
                    sample_dt=sample_dt, exec_time=ev.exec_time,
                    app_sm_util=ev.app_sm_util, app_dram_util=ev.app_dram_util,
                    kernel_rows=ev.kernel_rows)


def stream_telemetry(stream: KernelStream, freq: float, model: TPUPowerModel,
                     sample_dt: float = 1e-3, target_duration: float = 4.0,
                     max_iterations: int = 2000, noise: float = 0.03,
                     seed: int = 0, chunk_samples: int = 256,
                     device_id: str = ""):
    """Streaming twin of ``simulate``: ``(meta, chunk_iterator)``.

    The iterator yields ``TelemetryChunk``s of cumulative counter readings —
    the same noisy energy increments the batch path turns into ``power_raw``,
    re-accumulated into the counter a real daemon would poll.  Feeding every
    chunk to ``repro_torch.pipeline.ProfileBuilder`` reproduces the batch
    ``simulate`` trace (golden-tested at 1e-9), and any prefix of the chunks
    yields a valid partial profile.
    """
    if chunk_samples <= 0:
        raise ValueError(f"chunk_samples must be positive, got {chunk_samples}")
    ev = _event_trace(stream, freq, model, sample_dt, target_duration,
                      max_iterations)
    de = _noisy_energy_increments(ev, noise, seed)
    energy_ctr = np.concatenate([[0.0], np.cumsum(de)])
    busy_ctr = _busy_counter(ev)
    meta = TraceMeta(name=stream.name, domain=stream.domain,
                     sample_dt=sample_dt, n_samples=ev.n_samples,
                     exec_time=ev.exec_time, app_sm_util=ev.app_sm_util,
                     app_dram_util=ev.app_dram_util,
                     kernel_rows=ev.kernel_rows, device_id=device_id)

    def chunks():
        for i in range(0, ev.n_samples, chunk_samples):
            j = min(i + chunk_samples, ev.n_samples)
            yield TelemetryChunk(energy_j=energy_ctr[i + 1:j + 1],
                                 busy_s=busy_ctr[i + 1:j + 1],
                                 sample_dt=sample_dt, start_index=i)

    return meta, chunks()


def integrate_events(t0: np.ndarray, t1: np.ndarray, pw: np.ndarray,
                     edges: np.ndarray) -> np.ndarray:
    """Cumulative integral of overlapping box signals, sampled at ``edges``.

    Each event contributes rate ``pw[i]`` on ``[t0[i], t1[i])``.  The summed
    rate is piecewise-constant, so its integral is piecewise-linear with
    breakpoints only at event endpoints: accumulate the +pw/-pw rate deltas
    at the unique endpoint times (``np.add.at`` handles coincident events),
    prefix-sum twice (rate, then integral), and evaluate with one
    ``np.interp``.  Queries outside the event span clamp to 0 / the total.
    """
    if len(t0) == 0:
        return np.zeros(len(edges))
    times = np.concatenate([t0, t1])
    deltas = np.concatenate([pw, -np.asarray(pw)])
    uniq, inv = np.unique(times, return_inverse=True)
    rate_delta = np.zeros(len(uniq))
    np.add.at(rate_delta, inv, deltas)
    rate = np.cumsum(rate_delta)                       # rate on [uniq_k, uniq_k+1)
    cum = np.empty(len(uniq))
    cum[0] = 0.0
    np.cumsum(np.diff(uniq) * rate[:-1], out=cum[1:])
    return np.interp(edges, uniq, cum)


def profile_workload(stream: KernelStream, model: TPUPowerModel,
                     freqs, tdp: float, seed: int = 0,
                     sample_dt: float = 1e-3,
                     target_duration: float = 4.0,
                     device=DEFAULT_DEVICE) -> WorkloadProfile:
    """DEPRECATED batch sweep — routes through the streaming
    ``ProfileBuilder`` (``repro_torch.pipeline.stream_profile_workload``) on
    ``device``, the one profiling implementation."""
    import warnings
    warnings.warn(
        "repro_torch.telemetry.profile_workload is deprecated; use "
        "repro_torch.pipeline.stream_profile_workload (or "
        "repro_torch.api.MinosSession)",
        DeprecationWarning, stacklevel=2)
    from repro_torch.pipeline.builder import stream_profile_workload
    return stream_profile_workload(stream, model, freqs, tdp, seed=seed,
                                   sample_dt=sample_dt,
                                   target_duration=target_duration,
                                   device=device)


def profile_once(stream: KernelStream, model: TPUPowerModel, tdp: float,
                 freq: float = 1.0, seed: int = 0,
                 device=DEFAULT_DEVICE) -> WorkloadProfile:
    """DEPRECATED single low-cost profile — routes through the streaming
    ``ProfileBuilder`` (``repro_torch.pipeline.stream_profile_once``) on
    ``device``."""
    import warnings
    warnings.warn(
        "repro_torch.telemetry.profile_once is deprecated; use "
        "repro_torch.pipeline.stream_profile_once (or "
        "repro_torch.api.MinosSession.submit)",
        DeprecationWarning, stacklevel=2)
    from repro_torch.pipeline.builder import stream_profile_once
    return stream_profile_once(stream, model, tdp, freq=freq, seed=seed,
                               device=device)

