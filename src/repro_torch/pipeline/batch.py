"""Batched multi-job profiling: one columnar pass over the fleet's telemetry.

``BatchProfileEngine`` holds the state of *many* concurrent ``ProfileBuilder``
runs as slot-indexed columnar tensors on its device — energy/busy prefix
counters, blocked-EMA carry state, per-bin-size spike histograms stacked
``(capacity, n_bins)``, and idle-trim flags — so one stacked pass (counter
diff -> EMA prefix doubling -> trim fold -> histogram commit) advances every
live job per mux tick.  Slots are allocated on admit and freed on retire;
freed slots are recycled.

Bit-for-bit identity with the per-job ``ProfileBuilder`` (and with the
reference ``repro.pipeline.batch``) is the contract:

  * every elementwise stage evaluates the *same float expression per
    element* as the 1D path, in float64 with a separate multiply and add;
  * rows are grouped per tick by ``(chunk_len, n_pending, has_ema_state)`` so
    stacked EMA blocks line up at identical absolute positions;
  * histogram counts are integers binned in float64 exactly as the
    reference's scatter bins them, so they agree whatever the order.

Every histogram commit — the newly committed spans of a tick, the old-tail
pieces a fresh busy sample promotes, the flush at finalize and the memo
prefill of a snapshot — bins into all six histograms with ONE launch of the
spike-histogram kernel (``kernels.spike_hist``) over a ``(rows, F)`` block
padded with ``-inf``.

``SlotBuilder`` is the per-job view over one slot: it quacks exactly like a
``ProfileBuilder``, so ``OnlineCapController`` and the fleet controller
drive it unchanged.

Error semantics: the engine validates every chunk of a tick *before* mutating
any slot, so a poisoned chunk leaves the whole tick's builders untouched;
the raised message is byte-identical to the per-job ``ProfileBuilder``
message for the first offending chunk in batch order.

Host syncs: the per-row trace bookkeeping of a tick (``_fold_commit``'s loop)
reads four small columns back to the host once per group (its host time is
``row_loop_s``), and each ``SlotBuilder`` scalar query reads one value.
"""
from __future__ import annotations

from time import perf_counter

import numpy as np
import torch

from repro_torch.core import spikes
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.kernels.ema_scan import EMA_BLOCK, ema_scan_blocks
from repro_torch.kernels.spike_hist import spike_hist_batch
from repro_torch.pipeline.builder import (DEFAULT_BIN_SIZES, PartialProfile,
                                          _fold_trim, _validate_readings)
from repro_torch.telemetry.simulator import TelemetryChunk, TraceMeta

__all__ = ["BatchProfileEngine", "SlotBuilder"]

_F64, _I64 = torch.float64, torch.int64


class SlotBuilder:
    """Per-job view over one ``BatchProfileEngine`` slot.

    Duck-types the ``ProfileBuilder`` surface (``meta``/``tdp``/``ingest``/
    ``snapshot``/``finalize``/``spike_vector``/``spike_count``/``fraction``/
    ``n_ingested``/``n_committed``/``bin_sizes``).  ``release()`` frees the
    slot for reuse (after which the view rejects every call).
    """

    __slots__ = ("engine", "slot", "meta", "_released")

    def __init__(self, engine: "BatchProfileEngine", slot: int,
                 meta: TraceMeta):
        self.engine = engine
        self.slot = slot
        self.meta = meta
        self._released = False

    def _check(self) -> int:
        if self._released:
            raise ValueError(
                f"slot builder for job {self.meta.name!r} was released")
        return self.slot

    @property
    def tdp(self) -> float:
        return float(self.engine._tdp[self._check()].item())

    @property
    def bin_sizes(self):
        return self.engine.bin_sizes

    @property
    def n_ingested(self) -> int:
        return int(self.engine._next_index[self._check()].item())

    @property
    def n_committed(self) -> int:
        return int(self.engine._n_committed[self._check()].item())

    @property
    def fraction(self) -> float:
        return self.n_ingested / max(self.meta.n_samples, 1)

    def ingest(self, chunk: TelemetryChunk) -> None:
        self.engine.ingest_batch((self._check(),), (chunk,))

    def spike_vector(self, bin_size: float) -> torch.Tensor:
        return self.engine.spike_vector(self._check(), bin_size)

    def spike_count(self, bin_size: float | None = None) -> int:
        return self.engine.spike_count(self._check(), bin_size)

    def snapshot(self) -> PartialProfile:
        return self.engine.snapshot(self._check())

    def finalize(self) -> PartialProfile:
        return self.engine.finalize(self._check())

    def release(self) -> None:
        """Free the underlying slot for reuse (idempotent)."""
        if not self._released:
            self.engine.free(self.slot)
            self._released = True


class BatchProfileEngine:
    """Slot-indexed columnar state for many concurrent profiling runs, on
    ``device`` (default: the card)."""

    _F64_COLS = ("_tdp", "_energy", "_busy", "_ema_state")
    _I64_COLS = ("_next_index", "_n_pending", "_n_committed")
    _BOOL_COLS = ("_ema_has", "_seen_busy", "_final", "_live")

    def __init__(self, bin_sizes=DEFAULT_BIN_SIZES, alpha: float = 0.5,
                 ema_block: int = EMA_BLOCK, capacity: int = 64,
                 device=DEFAULT_DEVICE):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.bin_sizes = tuple(float(c) for c in bin_sizes)
        if any(c <= 0 for c in self.bin_sizes):
            raise ValueError(f"bin sizes must be positive: {self.bin_sizes}")
        self.device = resolve_device(device)
        self.alpha = float(alpha)
        self.block = int(ema_block)
        self._n_bins = tuple(spikes.num_bins(c) for c in self.bin_sizes)
        self._offsets = tuple(int(o) for o in np.cumsum((0,) + self._n_bins))
        cap = max(int(capacity), 1)
        # columnar scalar state (one row per slot)
        for name in self._F64_COLS:
            setattr(self, name, self._zeros(cap, _F64))
        for name in self._I64_COLS:
            setattr(self, name, self._zeros(cap, _I64))
        for name in self._BOOL_COLS:
            setattr(self, name, self._zeros(cap, torch.bool))
        # every tracked histogram side by side, (capacity, sum n_bins);
        # _hist[c] is the (capacity, n_bins) column view of bin size c
        self._hist_all = self._zeros((cap, self._offsets[-1]), _F64)
        self._hist: dict[float, torch.Tensor] = {}
        self._bind_hist_views()
        # ragged per-slot state (sample runs of varying length, on device)
        self._meta: list[TraceMeta | None] = [None] * cap
        self._pending: list[list[torch.Tensor]] = [[] for _ in range(cap)]
        self._busyq: list[list[torch.Tensor]] = [[] for _ in range(cap)]
        self._tail: list[list[torch.Tensor]] = [[] for _ in range(cap)]
        self._committed: list[list[torch.Tensor]] = [[] for _ in range(cap)]
        self._free: list[int] = list(range(cap - 1, -1, -1))
        self._empty = self._zeros(0, _F64)
        # host seconds spent in _fold_commit's per-row bookkeeping loop,
        # including the one device read that feeds it (its host sync)
        self.row_loop_s = 0.0

    def _zeros(self, shape, dtype) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def _bind_hist_views(self) -> None:
        for c, lo, hi in zip(self.bin_sizes, self._offsets,
                             self._offsets[1:]):
            self._hist[c] = self._hist_all[:, lo:hi]

    def _idx(self, slots) -> torch.Tensor:
        return torch.as_tensor(np.asarray(slots, np.int64), device=self.device)

    # -- capacity --------------------------------------------------------
    @property
    def capacity(self) -> int:
        return len(self._meta)

    @property
    def n_live(self) -> int:
        return int(self._live.sum().item())

    def _grow(self) -> None:
        # quadruple: growth is a stop-the-world copy of every column, and a
        # slot row is tiny (~576 B of histogram), so fewer bigger steps win
        old = self.capacity
        new = old * 4
        add = new - old
        for names, dtype in ((self._F64_COLS, _F64), (self._I64_COLS, _I64),
                             (self._BOOL_COLS, torch.bool)):
            for name in names:
                setattr(self, name, torch.cat(
                    [getattr(self, name), self._zeros(add, dtype)]))
        self._hist_all = torch.cat(
            [self._hist_all, self._zeros((add, self._offsets[-1]), _F64)])
        self._bind_hist_views()
        self._meta.extend([None] * add)
        for lst in (self._pending, self._busyq, self._tail, self._committed):
            lst.extend([] for _ in range(add))
        self._free.extend(range(new - 1, old - 1, -1))

    # -- slot lifecycle --------------------------------------------------
    def alloc(self, meta: TraceMeta, tdp: float) -> int:
        """Claim a slot for one profiling run; returns its index."""
        return self.alloc_many((meta,), (tdp,))[0]

    def alloc_many(self, metas, tdps) -> list[int]:
        """Claim one slot per run (the column resets are one indexed write
        per column for the whole batch); returns the slot indices.
        Histogram rows are already zero: ``_grow`` allocates zeros and
        ``free`` scrubs a slot's rows on release."""
        metas, tdps = list(metas), [float(t) for t in tdps]
        while len(self._free) < len(metas):
            self._grow()
        slots = [self._free.pop() for _ in metas]
        if not slots:
            return slots
        idx = self._idx(slots)
        self._tdp[idx] = torch.tensor(tdps, dtype=_F64, device=self.device)
        for name in ("_energy", "_busy", "_ema_state"):
            getattr(self, name)[idx] = 0.0
        for name in self._I64_COLS:
            getattr(self, name)[idx] = 0
        for name in ("_ema_has", "_seen_busy", "_final"):
            getattr(self, name)[idx] = False
        self._live[idx] = True
        for s, meta in zip(slots, metas):
            self._meta[s] = meta
            self._pending[s] = []
            self._busyq[s] = []
            self._tail[s] = []
            self._committed[s] = []
        return slots

    def builder(self, meta: TraceMeta, tdp: float) -> SlotBuilder:
        """Allocate a slot and return its ``ProfileBuilder``-shaped view."""
        return SlotBuilder(self, self.alloc(meta, tdp), meta)

    def free(self, slot: int) -> None:
        """Release a slot (idempotent); its state is recycled on next alloc."""
        if self._meta[slot] is not None:
            self._live[slot] = False
            self._meta[slot] = None
            # scrub the histogram rows now so alloc() can skip the clears
            self._hist_all[slot] = 0.0
            self._pending[slot] = []
            self._busyq[slot] = []
            self._tail[slot] = []
            self._committed[slot] = []
            self._free.append(slot)

    def _check_live(self, slot: int) -> None:
        # a live slot always carries its meta (alloc sets it, free clears
        # it), so liveness is a host check
        if self._meta[slot] is None:
            raise ValueError(f"slot {slot} is not allocated")

    def _columns(self, idx: torch.Tensor, *names) -> np.ndarray:
        """Host copy of some integer/bool columns at ``idx``: one transfer,
        shape (len(names), len(idx))."""
        return torch.stack([getattr(self, n)[idx].to(_I64)
                            for n in names]).cpu().numpy()

    # -- ingestion -------------------------------------------------------
    def ingest_batch(self, slots, chunks) -> None:
        """Advance many slots by one chunk each — the per-tick columnar pass.

        ``slots``/``chunks`` are parallel sequences; each slot may appear at
        most once.  The whole batch is validated before any slot mutates,
        and the raised error for bad telemetry matches the per-job
        ``ProfileBuilder`` message for the first offending chunk in batch
        order.
        """
        slots = list(slots)
        chunks = list(chunks)
        if len(slots) != len(chunks):
            raise ValueError("slots and chunks differ in length")
        if len(set(slots)) != len(slots):
            raise ValueError("duplicate slot in one ingest_batch tick")
        if not slots:
            return
        final, next_index, n_pending, ema_has = self._columns(
            self._idx(slots), "_final", "_next_index", "_n_pending",
            "_ema_has")
        # phase 1: per-row scalar checks (live / finalized / contiguity /
        # shape), mirroring ProfileBuilder.ingest's check order and messages
        rows = []            # (batch_pos, slot, chunk, er, br)
        for pos, (s, chunk) in enumerate(zip(slots, chunks)):
            self._check_live(s)
            if final[pos]:
                raise ValueError("ProfileBuilder already finalized")
            if chunk.start_index != next_index[pos]:
                raise ValueError(
                    f"chunk starts at sample {chunk.start_index}, expected "
                    f"{next_index[pos]} (chunks must be contiguous and "
                    f"ordered)")
            er = np.asarray(chunk.energy_j, np.float64)
            br = np.asarray(chunk.busy_s, np.float64)
            if er.shape != br.shape:
                raise ValueError("energy_j and busy_s readings differ in "
                                 "length")
            if len(er) == 0:
                continue                    # empty chunk: a no-op
            rows.append((pos, s, chunk, er, br))
        if not rows:
            return
        # phase 2: group rows so stacked 2D passes line up — equal chunk
        # length for the counter diff, equal pending count + state presence
        # for fixed-position EMA blocks
        groups: dict[tuple, list] = {}
        for row in rows:
            pos, _, _, er, _ = row
            key = (len(er), int(n_pending[pos]), bool(ema_has[pos]))
            groups.setdefault(key, []).append(row)
        # phase 3: move each group's stacked readings to the device once and
        # validate every group before any state mutates (all-or-nothing)
        bad_pos = None
        for grp in groups.values():
            idx = self._idx([r[1] for r in grp])
            both = torch.from_numpy(np.stack(
                [np.stack([r[3] for r in grp]),
                 np.stack([r[4] for r in grp])])).to(self.device)
            er2, br2 = both[0], both[1]
            dt = torch.tensor([r[2].sample_dt for r in grp], dtype=_F64,
                              device=self.device)
            d_e = torch.diff(er2, dim=1)
            d_b = torch.diff(br2, dim=1)
            ok = (torch.isfinite(dt) & (dt > 0)
                  & torch.isfinite(er2).all(dim=1)
                  & torch.isfinite(br2).all(dim=1)
                  & (er2[:, 0] >= self._energy[idx])
                  & (d_e >= 0).all(dim=1)
                  & (br2[:, 0] >= self._busy[idx])
                  & (d_b >= 0).all(dim=1))
            for j in np.nonzero(~ok.cpu().numpy())[0]:
                pos = grp[j][0]
                if bad_pos is None or pos < bad_pos[0]:
                    bad_pos = (pos, grp[j])
            grp.append((idx, er2, br2, dt, d_e, d_b))  # stash stacked tensors
        if bad_pos is not None:
            _, (_, s, chunk, er, br) = bad_pos
            _validate_readings(self._meta[s], float(self._energy[s].item()),
                               float(self._busy[s].item()), chunk.start_index,
                               chunk.sample_dt, er, br)
            raise AssertionError("vectorized validation flagged a chunk the "
                                 "reference validator accepts")  # unreachable
        # phase 4: mutate, one stacked pass per group
        for (length, pend, has_state), grp in groups.items():
            idx, er2, br2, dt, d_e, d_b = grp.pop()
            self._advance_group([r[1] for r in grp], idx, er2, br2, dt, d_e,
                                d_b, length, pend, has_state)

    def _advance_group(self, slots: list[int], idx: torch.Tensor,
                       er2: torch.Tensor, br2: torch.Tensor,
                       dt: torch.Tensor, d_e: torch.Tensor,
                       d_b: torch.Tensor, length: int, pend: int,
                       has_state: bool) -> None:
        """One stacked columnar advance for rows sharing (chunk length,
        pending count, EMA-state presence).  ``d_e``/``d_b`` are the
        validator's intra-chunk counter diffs, reused here: prepending the
        prefix-state column gives the identical elementwise subtractions as
        a diff over ``[prev, readings]``."""
        de = torch.cat([er2[:, :1] - self._energy[idx, None], d_e], dim=1)
        db = torch.cat([br2[:, :1] - self._busy[idx, None], d_b], dim=1)
        self._energy[idx] = er2[:, -1]
        self._busy[idx] = br2[:, -1]
        self._next_index[idx] += length
        p_raw = de / dt[:, None]
        busy = (db > 0).to(_F64)

        total = pend + length
        nblocks = total // self.block
        if nblocks == 0:
            # nothing commits this tick: everything stays pending
            for j, s in enumerate(slots):
                self._pending[s].append(p_raw[j])
                self._busyq[s].append(busy[j])
            self._n_pending[idx] = total
            return
        # stack the pending buffers (equal length across the group) and the
        # new samples into (k, total); commit whole fixed-position blocks
        if pend:
            prev_p = torch.stack([torch.cat(self._pending[s])
                                  if len(self._pending[s]) != 1
                                  else self._pending[s][0] for s in slots])
            prev_b = torch.stack([torch.cat(self._busyq[s])
                                  if len(self._busyq[s]) != 1
                                  else self._busyq[s][0] for s in slots])
            buf = torch.cat([prev_p, p_raw], dim=1)
            busy_buf = torch.cat([prev_b, busy], dim=1)
        else:
            buf, busy_buf = p_raw, busy
        # every block of every row in one launch, which also writes each
        # row's last filtered value and has-state flag into its slot
        take = nblocks * self.block
        filt = ema_scan_blocks(buf, self._ema_state, has_state, self.alpha,
                               n=take, index=idx, state_out=self._ema_state,
                               has_out=self._ema_has, block=self.block)
        rest_p = buf[:, take:]
        rest_b = busy_buf[:, take:]
        keep = rest_p.shape[1] > 0
        for j, s in enumerate(slots):
            self._pending[s] = [rest_p[j]] if keep else []
            self._busyq[s] = [rest_b[j]] if keep else []
        self._n_pending[idx] = total - take
        self._fold_commit(slots, idx, filt, busy_buf[:, :take])

    def _fold_commit(self, slots: list[int], idx: torch.Tensor,
                     filt: torch.Tensor, busy: torch.Tensor) -> None:
        """Columnar idle-trim fold + histogram commit over (k, F) filtered
        samples — the batched twin of ``_fold_trim`` + ``_commit``."""
        k, F = filt.shape
        busy_pos = (busy > 0).to(torch.int32)
        has_busy = busy_pos.any(dim=1)
        # argmax returns the first maximum: the first / last busy sample
        first = torch.where(has_busy, torch.argmax(busy_pos, dim=1), F)
        last = torch.where(has_busy,
                           F - 1 - torch.argmax(busy_pos.flip(1), dim=1), -1)
        seen = self._seen_busy[idx]
        start = torch.where(seen, 0, first)
        commit_end = torch.where(has_busy, last + 1, start)
        # pass 1: histogram contribution of the newly committed spans
        cols = torch.arange(F, device=self.device)
        commit_mask = (cols >= start[:, None]) & (cols < commit_end[:, None])
        self._scatter_hist(idx, torch.where(commit_mask, filt, -torch.inf),
                           divisor=self._tdp[idx])
        # pass 2: old-tail pieces promoted by a fresh busy sample, plus the
        # ragged per-row trace bookkeeping (one host read of the row flags)
        t0 = perf_counter()
        hb_l, seen_l, start_l, end_l = torch.stack(
            [has_busy.to(_I64), seen.to(_I64), start, commit_end]
        ).cpu().tolist()
        tail_rows: list[int] = []
        tail_pieces: list[torch.Tensor] = []
        n_add = [0] * k
        for j, s in enumerate(slots):
            if hb_l[j]:
                if self._tail[s]:
                    for piece in self._tail[s]:
                        n_add[j] += len(piece)
                        tail_rows.append(s)
                        tail_pieces.append(piece)
                    self._committed[s].extend(self._tail[s])
                    self._tail[s] = []
                span = filt[j, start_l[j]:end_l[j]]
                self._committed[s].append(span)
                n_add[j] += len(span)
                if end_l[j] < F:
                    self._tail[s] = [filt[j, end_l[j]:]]
            elif seen_l[j]:
                self._tail[s].append(filt[j])
            # rows with no busy yet: leading idle, dropped entirely
        self.row_loop_s += perf_counter() - t0
        if tail_pieces:
            keys, block = self._rel_block(tail_rows, tail_pieces, tail_rows)
            self._scatter_hist(self._idx(keys), block)
        self._n_committed[idx] += torch.tensor(n_add, dtype=_I64,
                                               device=self.device)
        self._seen_busy[idx] = seen | has_busy

    def _rel_block(self, row_keys: list, pieces: list[torch.Tensor],
                   piece_slots: list[int]) -> tuple[list, torch.Tensor]:
        """Pad ragged pieces of filtered power into a ``(m, L)`` block of
        relative power (``-inf`` padding): one row per distinct key of
        ``row_keys`` (first-appearance order; a row's pieces concatenate in
        order).  Each value is divided by the TDP of its piece's slot — the
        same elementwise divide as the per-piece path.  Returns the keys in
        row order and the block."""
        order: dict = {}
        for key in row_keys:
            order.setdefault(key, len(order))
        lens = np.array([len(p) for p in pieces], np.int64)
        starts = np.zeros(len(pieces), np.int64)
        fill = [0] * len(order)
        for i, (key, n) in enumerate(zip(row_keys, lens.tolist())):
            r = order[key]
            starts[i] = fill[r]       # offset inside the row
            fill[r] += n
        L = max(max(fill), 1)
        rows = np.array([order[key] for key in row_keys], np.int64)
        cum = np.concatenate([[0], np.cumsum(lens)[:-1]])
        pos = np.repeat(rows * L + starts - cum, lens) \
            + np.arange(int(lens.sum()))
        slot_of = np.repeat(np.asarray(piece_slots, np.int64), lens)
        vals = torch.cat(pieces) / self._tdp[self._idx(slot_of)]
        block = torch.full((len(order), L), -torch.inf, dtype=_F64,
                           device=self.device)
        block.view(-1)[self._idx(pos)] = vals
        return list(order), block

    def _scatter_hist(self, idx: torch.Tensor, block: torch.Tensor,
                      hist: torch.Tensor | None = None,
                      divisor: torch.Tensor | None = None) -> None:
        """Add the counts of a ``-inf``-padded relative-power block (one row
        per slot of ``idx``; of power when ``divisor`` holds each row's TDP)
        to the rows ``idx`` of every tracked histogram of ``hist`` (default
        ``_hist_all``) — one spike-histogram launch for all bin sizes, which
        also adds the counts in."""
        spike_hist_batch(block.contiguous(), self.bin_sizes, self._n_bins,
                         lo=spikes.SPIKE_LO, divisor=divisor,
                         out=self._hist_all if hist is None else hist,
                         rows=idx)

    # -- incremental queries ---------------------------------------------
    def _check_bin(self, bin_size) -> float:
        c = float(bin_size)
        if c not in self._hist:
            raise ValueError(f"bin size {bin_size} not tracked; "
                             f"tracked: {self.bin_sizes}")
        return c

    def spike_vector(self, slot: int, bin_size: float) -> torch.Tensor:
        self._check_live(slot)
        h = self._hist[self._check_bin(bin_size)][slot]
        tot = h.sum()
        if tot.item() == 0:
            return torch.zeros_like(h)
        return h / tot

    def spike_count(self, slot: int, bin_size: float | None = None) -> int:
        self._check_live(slot)
        c = self.bin_sizes[0] if bin_size is None else bin_size
        return int(self._hist[self._check_bin(c)][slot].sum().item())

    def _live_idx(self, slots) -> torch.Tensor:
        slots = list(slots)
        for s in slots:
            self._check_live(s)
        return self._idx(slots)

    def spike_count_batch(self, slots) -> np.ndarray:
        """Vector ``spike_count`` over many slots: one stacked row-sum of
        exact integer counts."""
        return self.gate_columns(slots)[0]

    def gate_columns(self, slots) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``(spike_count, n_ingested, tdp)`` for many slots in one read —
        what the fleet's confidence gates and replica keys look at."""
        idx = self._live_idx(slots)
        both = torch.stack([
            self._hist[self.bin_sizes[0]][idx].sum(dim=1),
            self._next_index[idx].to(_F64), self._tdp[idx]]).cpu().numpy()
        return both[0].astype(np.int64), both[1].astype(np.int64), both[2]

    # -- profile emission ------------------------------------------------
    def _profile(self, slot: int, trace: torch.Tensor, complete: bool,
                 n_ing: int, tdp: float) -> PartialProfile:
        m = self._meta[slot]
        return PartialProfile(
            name=m.name, tdp=tdp, power_trace=trace,
            sm_util=m.app_sm_util, dram_util=m.app_dram_util,
            exec_time=m.exec_time, scaling={}, domain=m.domain,
            fraction=n_ing / max(m.n_samples, 1), n_samples=n_ing,
            complete=complete)

    def _row_state(self, slots) -> dict[str, list]:
        """Host copy of the per-slot fields that profile emission needs."""
        idx = self._idx(slots)
        cols = torch.stack([self._n_pending[idx].to(_F64),
                            self._seen_busy[idx].to(_F64),
                            self._next_index[idx].to(_F64),
                            self._final[idx].to(_F64),
                            self._tdp[idx]]).cpu().numpy()
        return {"n_pending": cols[0].astype(np.int64).tolist(),
                "seen_busy": cols[1].astype(bool).tolist(),
                "next_index": cols[2].astype(np.int64).tolist(),
                "final": cols[3].astype(bool).tolist(),
                "tdp": cols[4].tolist()}

    def _pending_views(self, slots: list[int], idx: torch.Tensor,
                       lengths: list[int],
                       commit: bool = False) -> list[torch.Tensor]:
        """Each slot's pending partial block filtered from its carried
        state (``lengths[j]`` samples of ``slots[j]``, 0 for none), every
        slot in one launch over the concatenated pending samples.  With
        ``commit`` each slot with samples also takes its last filtered value
        as its state."""
        offs = np.concatenate([[0], np.cumsum(lengths)]).tolist()
        if not offs[-1]:
            return [self._empty] * len(slots)
        pieces = [p for s, n in zip(slots, lengths) if n
                  for p in self._pending[s]]
        buf = pieces[0] if len(pieces) == 1 else torch.cat(pieces)
        out = (self._ema_state, self._ema_has) if commit else (None, None)
        filt = ema_scan_blocks(buf, self._ema_state, self._ema_has,
                               self.alpha, offsets=offs, index=idx,
                               state_out=out[0], has_out=out[1],
                               block=self.block)
        return [filt[a:b] for a, b in zip(offs, offs[1:])]

    def _extras(self, slot: int, filt: torch.Tensor,
                seen_busy: bool) -> list[torch.Tensor]:
        """Pieces the pending EMA tail (``filt``, its pending view) would
        commit now (snapshot view)."""
        if not len(filt):
            return []
        busy = torch.cat(self._busyq[slot])[:len(filt)] \
            if self._busyq[slot] else torch.zeros_like(filt)
        extras, _, _ = _fold_trim(filt, busy, seen_busy,
                                  list(self._tail[slot]))
        return [e for e in extras if len(e)]

    def _memo_mats(self, idx: torch.Tensor, extra_rows: list[int],
                   extra_pieces: list[torch.Tensor], extra_slots: list[int]
                   ) -> dict[float, torch.Tensor]:
        """Stacked spike-memo prefill for the slots in ``idx``: the (k,
        sum n_bins) histogram rows, plus the counts of each row's
        uncommitted extras (``extra_rows``: the local row, ``extra_pieces``:
        filtered power, ``extra_slots``: their slots), normalized row-wise per bin size.  Counts are exact
        integers and the divide is elementwise, so every row matches the
        scalar ``spike_vector`` bit for bit."""
        H = self._hist_all[idx]                  # advanced index: a copy
        if extra_pieces:
            keys, block = self._rel_block(extra_rows, extra_pieces,
                                          extra_slots)
            self._scatter_hist(self._idx(keys), block, hist=H)
        mats: dict[float, torch.Tensor] = {}
        for c, lo, hi in zip(self.bin_sizes, self._offsets,
                             self._offsets[1:]):
            h = H[:, lo:hi]
            tot = h.sum(dim=1)
            M = h / torch.where(tot > 0.0, tot, 1.0)[:, None]
            M[tot == 0.0] = 0.0              # empty rows pin to exact zeros
            mats[c] = M
        return mats

    def _assemble(self, slot: int, pieces: list[torch.Tensor]) -> torch.Tensor:
        if not pieces:
            return self._empty
        if len(pieces) == 1:
            return pieces[0]                 # committed pieces are immutable
        return torch.cat(pieces)

    def snapshot(self, slot: int) -> PartialProfile:
        """A valid partial profile over everything this slot ingested so
        far; pure — mirrors ``ProfileBuilder.snapshot`` bit for bit."""
        return self.snapshot_batch([slot])[0]

    def snapshot_batch(self, slots) -> list[PartialProfile]:
        """``snapshot`` over many slots in one columnar pass: the ragged
        per-row work (the EMA view of mid-block pending samples, the
        idle-trim fold, the trace concat) stays per slot, the memo prefill
        runs stacked through ``_memo_mats`` with one kernel launch for every
        row's extras.  Each profile also carries the shared memo matrix so
        the classifier's sweep can gather target rows with one index."""
        slots = list(slots)
        if not slots:
            return []
        idx = self._live_idx(slots)
        st = self._row_state(slots)
        views = self._pending_views(slots, idx, st["n_pending"])
        traces: list[torch.Tensor] = []
        extra_rows: list[int] = []
        extra_pieces: list[torch.Tensor] = []
        for j, s in enumerate(slots):
            pieces = self._committed[s]
            extras = self._extras(s, views[j], st["seen_busy"][j])
            if extras:
                pieces = pieces + extras
                extra_rows.extend([j] * len(extras))
                extra_pieces.extend(extras)
            traces.append(self._assemble(s, pieces))
        mats = self._memo_mats(idx, extra_rows, extra_pieces,
                               [slots[j] for j in extra_rows])
        return self._emit(slots, traces, mats, st, complete=False)

    def _emit(self, slots, traces, mats, st, complete: bool):
        out = []
        for j, s in enumerate(slots):
            prof = self._profile(s, traces[j], complete, st["next_index"][j],
                                 st["tdp"][j])
            prof.__dict__["_spike_memo"] = {c: M[j] for c, M in mats.items()}
            prof.__dict__["_spike_mat"] = (mats, j)
            out.append(prof)
        return out

    def _commit_pieces(self, slot: int, pieces: list[torch.Tensor]) -> None:
        """Append committed pieces to a slot's trace bookkeeping (the
        histogram commit is the caller's)."""
        pieces = [a for a in pieces if len(a)]
        self._committed[slot].extend(pieces)
        n = sum(len(a) for a in pieces)
        if n:
            self._n_committed[slot] += n

    def finalize(self, slot: int) -> PartialProfile:
        """Flush the slot's EMA tail and emit its completed profile."""
        return self.finalize_batch([slot])[0]

    def finalize_batch(self, slots) -> list[PartialProfile]:
        """Flush every slot's pending EMA tail (per slot: ragged), commit
        all the flushed pieces with one kernel launch, and emit the
        completed profiles with a stacked memo prefill.  Bit-identical to
        per-slot ``ProfileBuilder.finalize``; idempotent per slot."""
        slots = list(slots)
        if not slots:
            return []
        if len(set(slots)) != len(slots):
            # a repeated slot would collide in the indexed scatter below;
            # finalize is idempotent, so take the slots one at a time
            return [self.finalize_batch([s])[0] for s in slots]
        idx = self._live_idx(slots)
        st = self._row_state(slots)
        # every slot's flush in one launch, which also sets the flushed
        # slots' filter state
        views = self._pending_views(
            slots, idx, [0 if f else n for f, n in zip(st["final"],
                                                       st["n_pending"])],
            commit=True)
        flush_rows: list[int] = []
        flush_pieces: list[torch.Tensor] = []
        for j, s in enumerate(slots):
            if st["final"][j]:
                continue
            filt = views[j]
            if len(filt):
                busy = torch.cat(self._busyq[s])[:len(filt)]
                commits, seen, tail = _fold_trim(
                    filt, busy, st["seen_busy"][j], list(self._tail[s]))
                self._seen_busy[s] = seen
                self._tail[s] = tail
                commits = [a for a in commits if len(a)]
                self._commit_pieces(s, commits)
                flush_rows.extend([s] * len(commits))
                flush_pieces.extend(commits)
            self._pending[s] = []
            self._busyq[s] = []
        self._n_pending[idx] = 0
        self._final[idx] = True
        if flush_pieces:
            keys, block = self._rel_block(flush_rows, flush_pieces,
                                          flush_rows)
            self._scatter_hist(self._idx(keys), block)
        # post-flush the histograms cover each whole committed trace
        mats = self._memo_mats(idx, [], [], [])
        traces = [self._assemble(s, self._committed[s]) for s in slots]
        return self._emit(slots, traces, mats, st, complete=True)
