"""Incremental profile construction from streamed telemetry chunks.

``ProfileBuilder`` is the streaming half of the Minos profiling pipeline: it
ingests ``TelemetryChunk``s (cumulative energy/busy counter readings, the
exact thing a telemetry daemon polls) and maintains, incrementally and on its
device,

  * the running energy/busy **prefix state** — the last counter readings,
    differentiated against each new chunk to recover per-sample power and
    busy flags;
  * the **EMA filter tail** — filtered samples are produced through
    fixed-position blocks (prefix-doubling within a block, carried filter
    state between blocks), so the output is *bit-for-bit independent of how
    the stream was chunked*;
  * the **idle-trim frontier** — samples before the first busy reading are
    dropped, samples after the last busy reading so far are held in a
    pending tail and only committed when a later busy sample arrives;
  * **per-bin-size spike histograms** over the committed samples — every
    commit bins into all tracked bin sizes with one spike-histogram kernel
    launch.

``snapshot()`` emits a valid partial ``WorkloadProfile`` at any point;
``finalize()`` flushes everything and emits the completed profile.  Every
float expression is the reference's (``repro.pipeline.builder``), evaluated
elementwise in float64 with a separate multiply and add, so a build on the
CPU equals the reference bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import spikes
from repro_torch.core.classify import FreqPoint, WorkloadProfile
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.kernels.ema_scan import EMA_BLOCK, ema_scan_blocks
from repro_torch.kernels.spike_hist import spike_hist_batch
from repro_torch.telemetry.simulator import TelemetryChunk, TraceMeta

DEFAULT_BIN_SIZES = (0.05, 0.1, 0.15, 0.2, 0.25, 0.5)


@dataclass
class PartialProfile(WorkloadProfile):
    """A ``WorkloadProfile`` emitted mid-stream, annotated with progress."""
    fraction: float = 1.0        # fraction of the expected trace ingested
    n_samples: int = 0           # raw samples ingested so far
    complete: bool = False       # True only for finalize() output

    def spike_vec(self, bin_size: float) -> torch.Tensor:
        # the trace is immutable once emitted: memoize per bin size
        cache = self.__dict__.setdefault("_spike_memo", {})
        c = float(bin_size)
        if c not in cache:
            cache[c] = super().spike_vec(c)
        return cache[c]


def _validate_readings(meta: TraceMeta, prev_e: float, prev_b: float,
                       start_index: int, sample_dt: float,
                       er: np.ndarray, br: np.ndarray) -> None:
    """Reject poisoned telemetry (NaN/non-finite/regressing counters,
    non-positive sample_dt) with the job/device context.  Shared by the
    per-job ``ProfileBuilder`` and the batched engine so both raise the
    byte-identical message for the same chunk."""
    where = f"job {meta.name!r}"
    if meta.device_id:
        where += f" on device {meta.device_id!r}"
    if not np.isfinite(sample_dt) or sample_dt <= 0:
        raise ValueError(
            f"{where}: chunk at sample {start_index} has "
            f"non-positive/non-finite sample_dt {sample_dt!r} (sample "
            f"timestamps must advance monotonically)")
    for label, readings, prev in (("energy_j", er, prev_e),
                                  ("busy_s", br, prev_b)):
        if not np.all(np.isfinite(readings)):
            raise ValueError(
                f"{where}: chunk at sample {start_index} has "
                f"NaN/non-finite {label} counter readings")
        if readings[0] < prev or np.any(np.diff(readings) < 0):
            raise ValueError(
                f"{where}: {label} counter goes backwards in the chunk "
                f"at sample {start_index} (cumulative counters "
                f"must be non-negative and non-decreasing)")


class _BlockedEMA:
    """EMA filter whose output does not depend on ingest chunk boundaries:
    prefix doubling over blocks at fixed absolute positions (multiples of
    ``block`` from trace start), each seeded with the carried filter state
    (``kernels.ema_scan_blocks``: one launch for every block of a call)."""

    def __init__(self, alpha: float = 0.5, block: int = EMA_BLOCK):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = alpha
        self.block = int(block)
        self._pending: list[torch.Tensor] = []
        self._n_pending = 0
        self._state: torch.Tensor | None = None   # None until the 1st block

    def _buffer(self) -> torch.Tensor:
        return self._pending[0] if len(self._pending) == 1 \
            else torch.cat(self._pending)

    def _filter(self, buf: torch.Tensor, n: int | None = None):
        """The first ``n`` (default: all) samples of ``buf`` filtered from
        the carried state."""
        return ema_scan_blocks(buf, self._state, self._state is not None,
                               self.alpha, n=n, block=self.block)

    def ingest(self, p: torch.Tensor) -> torch.Tensor:
        """Absorb raw samples; return the newly *committed* filtered samples
        (complete blocks only — the partial tail stays pending)."""
        if len(p):
            self._pending.append(p)
            self._n_pending += len(p)
        if self._n_pending < self.block:
            return p[:0]
        take = self._n_pending // self.block * self.block
        buf = self._buffer()
        filt = self._filter(buf, take)
        self._state = filt[-1]
        rest = buf[take:]
        self._pending = [rest] if len(rest) else []
        self._n_pending = len(rest)
        return filt

    def pending_view(self, like: torch.Tensor) -> torch.Tensor:
        """Filtered values for the pending partial block, without committing
        filter state (safe to call repeatedly)."""
        if not self._n_pending:
            return like[:0]
        return self._filter(self._buffer())

    def flush(self, like: torch.Tensor) -> torch.Tensor:
        """Commit the pending partial block (end of stream)."""
        out = self.pending_view(like)
        if len(out):
            self._state = out[-1]
        self._pending, self._n_pending = [], 0
        return out


def _busy_span(busy: torch.Tensor) -> tuple[int, int] | None:
    """(first, last) index of the busy samples, or None."""
    nz = torch.nonzero(busy > 0).flatten()
    if not len(nz):
        return None
    first, last = nz[[0, -1]].tolist()
    return first, last


def _fold_trim(filt: torch.Tensor, busy: torch.Tensor, seen_busy: bool,
               tail: list[torch.Tensor]):
    """Advance the idle-trim frontier over one span of filtered samples.

    Returns ``(commits, seen_busy, tail)``: pieces whose membership in the
    trimmed trace is now decided, the updated head flag, and the new pending
    tail (samples after the last busy reading so far) — the batch
    ``trim_idle`` (keep [first-busy, last-busy]) on every stream prefix.
    """
    commits: list[torch.Tensor] = []
    span = _busy_span(busy)
    if not seen_busy:
        if span is None:
            return commits, False, tail            # still leading idle: drop
        filt = filt[span[0]:]
        span = (0, span[1] - span[0])
        seen_busy = True
    if span is None:
        if len(filt):
            tail = tail + [filt]
        return commits, seen_busy, tail
    last = span[1]
    commits = tail + [filt[:last + 1]]
    tail = [filt[last + 1:]] if last + 1 < len(filt) else []
    return commits, seen_busy, tail


class ProfileBuilder:
    """Incrementally build a ``WorkloadProfile`` from telemetry chunks, with
    its state on ``device`` (default: the card)."""

    def __init__(self, meta: TraceMeta, tdp: float,
                 bin_sizes=DEFAULT_BIN_SIZES, alpha: float = 0.5,
                 ema_block: int = EMA_BLOCK, device=DEFAULT_DEVICE):
        self.meta = meta
        self.tdp = float(tdp)
        self.bin_sizes = tuple(float(c) for c in bin_sizes)
        if any(c <= 0 for c in self.bin_sizes):
            raise ValueError(f"bin sizes must be positive: {self.bin_sizes}")
        self.device = resolve_device(device)
        self._ema = _BlockedEMA(alpha=alpha, block=ema_block)
        self._empty = torch.empty(0, dtype=torch.float64, device=self.device)
        self._tdp_t = spikes.scalar(self.tdp, self._empty)
        # running prefix state: last counter readings + expected next index
        self._energy_j = 0.0
        self._busy_s = 0.0
        self._next_index = 0
        # busy flags for samples still pending inside the EMA
        self._busy_queue: list[torch.Tensor] = []
        # idle-trim state + committed stats
        self._seen_busy = False
        self._tail: list[torch.Tensor] = []
        self._committed: list[torch.Tensor] = []
        self._n_committed = 0
        # all tracked histograms side by side; _hist[c] are column views
        self._n_bins = tuple(spikes.num_bins(c) for c in self.bin_sizes)
        self._hist_all = torch.zeros(sum(self._n_bins), dtype=torch.float64,
                                     device=self.device)
        self._hist: dict[float, torch.Tensor] = {}
        off = 0
        for c, n in zip(self.bin_sizes, self._n_bins):
            self._hist[c] = self._hist_all[off:off + n]
            off += n
        self._finalized = False

    # -- ingestion ------------------------------------------------------
    def ingest(self, chunk: TelemetryChunk) -> None:
        """Absorb one chunk of counter readings (must arrive in order)."""
        if self._finalized:
            raise ValueError("ProfileBuilder already finalized")
        if chunk.start_index != self._next_index:
            raise ValueError(
                f"chunk starts at sample {chunk.start_index}, expected "
                f"{self._next_index} (chunks must be contiguous and ordered)")
        er = np.asarray(chunk.energy_j, np.float64)
        br = np.asarray(chunk.busy_s, np.float64)
        if er.shape != br.shape:
            raise ValueError("energy_j and busy_s readings differ in length")
        if len(er) == 0:
            return
        self._validate_chunk(chunk, er, br)
        # differentiate the counters against the running prefix state, on
        # the device: one transfer of [prev, readings] per counter
        both = torch.from_numpy(np.stack([
            np.concatenate([[self._energy_j], er]),
            np.concatenate([[self._busy_s], br])])).to(self.device)
        d = torch.diff(both, dim=1)
        self._energy_j = float(er[-1])
        self._busy_s = float(br[-1])
        self._next_index += len(er)
        p_raw = d[0] / spikes.scalar(chunk.sample_dt, d)
        busy = (d[1] > 0).to(torch.float64)

        self._busy_queue.append(busy)
        filt = self._ema.ingest(p_raw)
        if len(filt):
            self._absorb(filt, self._take_busy(len(filt)))

    def _validate_chunk(self, chunk: TelemetryChunk, er: np.ndarray,
                        br: np.ndarray) -> None:
        """Reject poisoned telemetry before any state mutates."""
        _validate_readings(self.meta, self._energy_j, self._busy_s,
                           chunk.start_index, chunk.sample_dt, er, br)

    def _take_busy(self, n: int) -> torch.Tensor:
        buf = torch.cat(self._busy_queue)
        taken, rest = buf[:n], buf[n:]
        self._busy_queue = [rest] if len(rest) else []
        return taken

    def _absorb(self, filt: torch.Tensor, busy: torch.Tensor) -> None:
        commits, self._seen_busy, self._tail = _fold_trim(
            filt, busy, self._seen_busy, self._tail)
        for arr in commits:
            self._commit(arr)

    def _commit(self, arr: torch.Tensor) -> None:
        if not len(arr):
            return
        self._committed.append(arr)
        self._n_committed += len(arr)
        # every tracked histogram in one spike-histogram launch (jobs = 1),
        # which also divides by the TDP and adds into _hist_all
        spike_hist_batch(arr.contiguous()[None, :], self.bin_sizes,
                         self._n_bins, lo=spikes.SPIKE_LO,
                         divisor=self._tdp_t, out=self._hist_all[None, :])

    # -- incremental queries --------------------------------------------
    @property
    def n_ingested(self) -> int:
        """Raw samples absorbed so far."""
        return self._next_index

    @property
    def n_committed(self) -> int:
        """Samples already inside the trimmed trace."""
        return self._n_committed

    @property
    def fraction(self) -> float:
        """Fraction of the expected trace ingested (from ``meta``)."""
        return self.n_ingested / max(self.meta.n_samples, 1)

    def _check_bin(self, bin_size) -> float:
        c = float(bin_size)
        if c not in self._hist:
            raise ValueError(f"bin size {bin_size} not tracked; "
                             f"tracked: {self.bin_sizes}")
        return c

    def spike_vector(self, bin_size: float) -> torch.Tensor:
        """Normalized spike vector over the *committed* samples — an O(bins)
        read of the incremental histogram."""
        h = self._hist[self._check_bin(bin_size)]
        tot = h.sum()
        if tot.item() == 0:
            return torch.zeros_like(h)
        return h / tot

    def spike_count(self, bin_size: float | None = None) -> int:
        """Committed samples at or above the spike threshold (the same for
        every tracked histogram; ``None`` reads the first)."""
        c = self.bin_sizes[0] if bin_size is None else bin_size
        return int(self._hist[self._check_bin(c)].sum().item())

    # -- profile emission -----------------------------------------------
    def _profile(self, trace: torch.Tensor, complete: bool) -> PartialProfile:
        m = self.meta
        return PartialProfile(
            name=m.name, tdp=self.tdp, power_trace=trace,
            sm_util=m.app_sm_util, dram_util=m.app_dram_util,
            exec_time=m.exec_time, scaling={}, domain=m.domain,
            fraction=self.fraction, n_samples=self.n_ingested,
            complete=complete)

    def snapshot(self) -> PartialProfile:
        """A valid partial profile over everything ingested so far.  Does not
        mutate builder state — ingestion can continue afterwards."""
        filt = self._ema.pending_view(self._empty)
        pieces = list(self._committed)
        if len(filt):
            busy = torch.cat(self._busy_queue)[:len(filt)] \
                if self._busy_queue else torch.zeros_like(filt)
            commits, _, _ = _fold_trim(filt, busy, self._seen_busy,
                                       list(self._tail))
            pieces += commits
        trace = torch.cat(pieces) if pieces else self._empty
        return self._profile(trace, complete=False)

    def finalize(self) -> PartialProfile:
        """Flush the EMA tail and emit the completed profile."""
        if not self._finalized:
            filt = self._ema.flush(self._empty)
            if len(filt):
                self._absorb(filt, self._take_busy(len(filt)))
            self._busy_queue = []
            self._finalized = True
        trace = torch.cat(self._committed) if self._committed \
            else self._empty
        return self._profile(trace, complete=True)


# ---------------------------------------------------------------------------
# streaming profiling entry points
# ---------------------------------------------------------------------------
def stream_profile_once(stream, model, tdp: float, freq: float = 1.0,
                        seed: int = 0, sample_dt: float = 1e-3,
                        target_duration: float = 4.0,
                        chunk_samples: int = 256,
                        device=DEFAULT_DEVICE) -> PartialProfile:
    """One low-cost profile, built by pumping the chunk stream through a
    ``ProfileBuilder`` on ``device``."""
    from repro_torch.telemetry.simulator import stream_telemetry
    meta, chunks = stream_telemetry(stream, freq, model, seed=seed,
                                    sample_dt=sample_dt,
                                    target_duration=target_duration,
                                    chunk_samples=chunk_samples)
    builder = ProfileBuilder(meta, tdp, device=device)
    for chunk in chunks:
        builder.ingest(chunk)
    return builder.finalize()


def stream_profile_workload(stream, model, freqs, tdp: float, seed: int = 0,
                            sample_dt: float = 1e-3,
                            target_duration: float = 4.0,
                            chunk_samples: int = 256,
                            device=DEFAULT_DEVICE) -> WorkloadProfile:
    """The full reference sweep: one builder per frequency (same
    per-frequency seeds as the reference), assembled into a
    ``WorkloadProfile``."""
    scaling = {}
    top = max(freqs)
    top_profile = None
    for i, f in enumerate(sorted(freqs)):
        prof = stream_profile_once(stream, model, tdp, freq=f,
                                   seed=seed * 1009 + i, sample_dt=sample_dt,
                                   target_duration=target_duration,
                                   chunk_samples=chunk_samples, device=device)
        tr = prof.power_trace
        p90, p95, p99 = (0.0, 0.0, 0.0) if len(tr) == 0 else (
            v / tdp for v in (spikes.p_quantiles(tr[None, :], q)[0]
                              for q in (90, 95, 99)))
        scaling[f] = FreqPoint(
            freq=f, p90=p90, p95=p95, p99=p99,
            mean_power=spikes.mean_power_rel(tr, tdp),
            exec_time=prof.exec_time,
            spike_vec=spikes.spike_vector(tr, tdp),
        )
        if f == top:
            top_profile = prof
    return WorkloadProfile(
        name=top_profile.name, tdp=tdp, power_trace=top_profile.power_trace,
        sm_util=top_profile.sm_util, dram_util=top_profile.dram_util,
        exec_time=top_profile.exec_time, scaling=scaling,
        domain=top_profile.domain,
    )
