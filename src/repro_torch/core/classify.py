"""Workload profiles + the Minos dual classifier (paper §4).

A ``WorkloadProfile`` is what one low-cost profiling run produces:
  * the filtered power trace at the profiled frequency (a float64 tensor)
  * per-kernel (duration, sm_util, dram_util) -> duration-weighted app point
  * optionally, per-frequency scaling data {freq: FreqPoint} — available only
    for *reference* workloads.

``MinosClassifier`` owns the reference set: it caches the reference spike
matrix per bin size and the utilization matrix on its device, and answers
nearest-neighbor queries in batch as single (n_targets, n_refs)
distance-matrix ops.  Distances accumulate over the bins in a fixed order
with elementwise ops, so row i of a batched query is bit-identical to a
one-row query — the property the fleet's replica groups rely on.
"""
from __future__ import annotations

import numbers
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core import spikes
from repro_torch.core.clustering import (best_k_by_silhouette,
                                         cosine_distance_matrix, cut_k,
                                         kmeans, linkage, row_dots,
                                         row_sq_norms)
from repro_torch.device import as_f64


@dataclass
class FreqPoint:
    freq: float                  # normalized cap (f / f_max)
    p90: float                   # 90th pct of power, relative to TDP
    p95: float
    p99: float
    mean_power: float            # relative to TDP
    exec_time: float             # seconds per iteration
    spike_vec: torch.Tensor | None = None


@dataclass
class WorkloadProfile:
    name: str
    tdp: float
    power_trace: torch.Tensor            # filtered, trimmed, at profile freq
    sm_util: float                       # duration-weighted app SM/MXU util
    dram_util: float                     # duration-weighted app HBM util
    exec_time: float                     # at profile freq
    scaling: dict[float, FreqPoint] = field(default_factory=dict)
    domain: str = ""

    def spike_vec(self, bin_size: float) -> torch.Tensor:
        return spikes.spike_vector(self.power_trace, self.tdp, bin_size)

    def p_quantile(self, q: float) -> float:
        # the trace is immutable after construction: memoize per q
        cache = self.__dict__.setdefault("_pq_memo", {})
        q = float(q)
        if q not in cache:
            cache[q] = spikes.p_quantile(self.power_trace, self.tdp, q)
        return cache[q]

    @property
    def mean_power(self) -> float:
        return spikes.mean_power_rel(self.power_trace, self.tdp)

    @property
    def util_point(self) -> np.ndarray:
        return np.array([self.dram_util, self.sm_util], np.float64)


def app_utilization(kernels: list[tuple[float, float, float]]
                    ) -> tuple[float, float]:
    """Duration-weighted (sm, dram) utilization from per-kernel rows
    (duration, sm_util, dram_util), paper Eqs. (1)/(2).  Host rows, summed
    with NumPy as the reference sums them."""
    t = np.array([k[0] for k in kernels], np.float64)
    sm = np.array([k[1] for k in kernels], np.float64)
    dr = np.array([k[2] for k in kernels], np.float64)
    tot = t.sum()
    if tot <= 0:
        return 0.0, 0.0
    return float((t * sm).sum() / tot), float((t * dr).sum() / tot)


class MinosClassifier:
    """Power-spike (hierarchical/cosine) + utilization classifier.

    The reference set is immutable after construction; ``spike_matrix(c)``
    (the (n_refs, n_bins) stack of spike vectors) is cached per bin size and
    ``util_matrix()`` outright, both on ``device`` (default: the device of
    the first reference trace).  Self-matches (same workload name) and an
    optional ``exclude`` name are masked out of every query.
    """

    def __init__(self, references: list[WorkloadProfile],
                 bin_size: float = 0.1,
                 spike_cache: dict | None = None, device=None):
        """``spike_cache`` warm-starts the per-bin-size spike matrices (each
        (n_refs, num_bins(c)), row-aligned with ``references``)."""
        if not references:
            raise ValueError("empty reference set")
        self.references = list(references)
        self.bin_size = self._validate_bin(bin_size)
        if device is None:
            trace = self.references[0].power_trace
            device = trace.device if isinstance(trace, torch.Tensor) \
                else "cpu"
        self.device = torch.device(device)
        self._ref_names = np.array([r.name for r in self.references])
        self._spike_cache: dict[float, torch.Tensor] = {}
        self._util_cache: torch.Tensor | None = None
        for c, M in (spike_cache or {}).items():
            c = self._validate_bin(c)
            M = as_f64(M, self.device)
            want = (len(self.references), spikes.num_bins(c))
            if tuple(M.shape) != want:
                raise ValueError(
                    f"spike_cache[{c}] has shape {tuple(M.shape)}, expected "
                    f"{want}")
            self._spike_cache[c] = M

    @staticmethod
    def _validate_bin(c) -> float:
        if isinstance(c, bool) or not isinstance(c, numbers.Real) or not c > 0:
            raise ValueError(f"bin_size must be a positive number, got {c!r}")
        return float(c)

    def _resolve_bin(self, bin_size: float | None) -> float:
        return self.bin_size if bin_size is None else self._validate_bin(bin_size)

    # -- power side -----------------------------------------------------
    def spike_matrix(self, bin_size: float | None = None) -> torch.Tensor:
        """(n_refs, n_bins) reference spike vectors, cached per bin size."""
        c = self._resolve_bin(bin_size)
        M = self._spike_cache.get(c)
        if M is None:
            M = torch.stack([as_f64(r.spike_vec(c), self.device)
                             for r in self.references])
            self._spike_cache[c] = M
        return M

    def power_linkage(self, bin_size: float | None = None) -> np.ndarray:
        D = cosine_distance_matrix(self.spike_matrix(bin_size))
        return linkage(D, method="ward")

    def power_classes(self, k: int = 3,
                      bin_size: float | None = None) -> np.ndarray:
        """Dendrogram slice for interpretation only (predictions use NN)."""
        return cut_k(self.power_linkage(bin_size), k)

    def power_neighbors(self, targets: list[WorkloadProfile],
                        bin_size: float | None = None,
                        exclude: str | None = None
                        ) -> list[tuple[WorkloadProfile, float]]:
        """Nearest reference by cosine distance, for a batch of targets.
        Raises ``ValueError`` if some target has every reference excluded."""
        D = self._power_distances(targets, bin_size)
        return self._pick(D, targets, exclude)

    def power_neighbor(self, target: WorkloadProfile,
                       bin_size: float | None = None,
                       exclude: str | None = None) -> tuple[WorkloadProfile, float]:
        return self.power_neighbors([target], bin_size, exclude)[0]

    def power_top2(self, targets: list[WorkloadProfile],
                   bin_size: float | None = None,
                   exclude: str | None = None
                   ) -> list[tuple[WorkloadProfile, float, float]]:
        """``(best_ref, d_best, d_second)`` per target; ``d_second`` is
        ``inf`` when only one reference is eligible."""
        idx, best, second = self._top2(targets, bin_size, exclude)
        return [(self.references[i], float(d1), float(d2))
                for i, d1, d2 in zip(idx, best, second)]

    def power_neighbors_idx(self, targets: list[WorkloadProfile],
                            bin_size: float | None = None,
                            exclude: str | None = None
                            ) -> tuple[np.ndarray, np.ndarray]:
        """Nearest reference per target as host ``(index, distance)``
        arrays (row values bit-identical to ``power_neighbors``)."""
        D = self._mask(self._power_distances(targets, bin_size), targets,
                       exclude)
        return self._argbest(D, targets, exclude)

    def power_top2_idx(self, targets: list[WorkloadProfile],
                       bin_size: float | None = None,
                       exclude: str | None = None
                       ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Array-form ``power_top2``: ``(index, d_best, d_second)``."""
        return self._top2(targets, bin_size, exclude)

    def power_sweep(self, targets: list[WorkloadProfile], bin_sizes,
                    exclude: str | None = None, second: bool = True
                    ) -> list[tuple]:
        """Fused bin-size sweep: for every candidate bin size the nearest
        reference ``(index, d_best)`` plus the runner-up ``d_second``, from
        one masked distance matrix per candidate.  With ``second=False`` the
        third element is the masked (device) distance matrix itself."""
        masked = self._mask_matrix(targets, exclude)
        # targets minted by one BatchProfileEngine snapshot/finalize batch
        # share a memo matrix per bin size: gather their rows with one index
        shared = None
        mats = targets[0].__dict__.get("_spike_mat") if targets else None
        if mats is not None:
            refs = [t.__dict__.get("_spike_mat") for t in targets]
            if all(r is not None and r[0] is mats[0] for r in refs):
                rows = torch.tensor([r[1] for r in refs], dtype=torch.int64,
                                    device=self.device)
                shared = (mats[0], rows)
        out = []
        for c in bin_sizes:
            c = float(c)
            if shared is not None and c in shared[0]:
                D = _cosine_distances(shared[0][c].index_select(0, shared[1]),
                                      self.spike_matrix(c))
            else:
                D = self._power_distances(targets, c)
            D = torch.where(masked, torch.inf, D)
            idx, best = self._argbest(D, targets, exclude)
            if not second:
                out.append((idx, best, D))
            elif D.shape[1] > 1:
                out.append((idx, best, _second_smallest(D)))
            else:
                out.append((idx, best, np.full(len(targets), np.inf)))
        return out

    def _top2(self, targets, bin_size, exclude):
        D = self._mask(self._power_distances(targets, bin_size), targets,
                       exclude)
        idx, best = self._argbest(D, targets, exclude)
        if D.shape[1] > 1:
            second = _second_smallest(D)
        else:
            second = np.full(len(targets), np.inf)
        return idx, best, second

    def _target_matrix(self, targets, c: float) -> torch.Tensor:
        if self._is_reference_batch(targets):
            return self.spike_matrix(c)        # hold-one-out: reuse the cache
        return torch.stack([as_f64(t.spike_vec(c), self.device)
                            for t in targets])

    def _power_distances(self, targets: list[WorkloadProfile],
                         bin_size: float | None) -> torch.Tensor:
        """(n_targets, n_refs) cosine distances on spike vectors."""
        c = self._resolve_bin(bin_size)
        return _cosine_distances(self._target_matrix(targets, c),
                                 self.spike_matrix(c))

    # -- utilization side -------------------------------------------------
    def util_matrix(self) -> torch.Tensor:
        """(n_refs, 2) [dram_util, sm_util] reference points, cached."""
        if self._util_cache is None:
            self._util_cache = torch.tensor(
                np.stack([r.util_point for r in self.references]),
                dtype=torch.float64, device=self.device)
        return self._util_cache

    def util_classes(self, k: int | None = None, seed: int = 0):
        """K-Means classes of the utilization points (paper Fig. 4): k from
        the silhouette sweep unless given.  Returns (labels, centers, k,
        scores) with host arrays, as the reference does."""
        X = self.util_matrix()
        if k is None:
            k, scores = best_k_by_silhouette(X, seed=seed,
                                             device=self.device)
        else:
            scores = None
        centers, labels, _ = kmeans(X, k, seed=seed, device=self.device)
        return labels, centers, k, scores

    def util_neighbors(self, targets: list[WorkloadProfile],
                       exclude: str | None = None
                       ) -> list[tuple[WorkloadProfile, float]]:
        """Nearest reference by Euclidean distance in utilization space."""
        return self._pick(self._util_distances(targets), targets, exclude)

    def util_neighbors_idx(self, targets: list[WorkloadProfile],
                           exclude: str | None = None
                           ) -> tuple[np.ndarray, np.ndarray]:
        """Array-form ``util_neighbors``: ``(index, distance)`` arrays."""
        D = self._mask(self._util_distances(targets), targets, exclude)
        return self._argbest(D, targets, exclude)

    def _util_distances(self, targets: list[WorkloadProfile]) -> torch.Tensor:
        if self._is_reference_batch(targets):
            T = self.util_matrix()
        else:
            T = torch.tensor([(t.dram_util, t.sm_util) for t in targets],
                             dtype=torch.float64,
                             device=self.device).reshape(-1, 2)
        U = self.util_matrix()
        d0 = T[:, None, 0] - U[None, :, 0]
        d1 = T[:, None, 1] - U[None, :, 1]
        return torch.sqrt(d0 * d0 + d1 * d1)

    def util_neighbor(self, target: WorkloadProfile,
                      exclude: str | None = None) -> tuple[WorkloadProfile, float]:
        return self.util_neighbors([target], exclude)[0]

    # -- shared ----------------------------------------------------------
    def _is_reference_batch(self, targets: list[WorkloadProfile]) -> bool:
        return len(targets) == len(self.references) and \
            all(t is r for t, r in zip(targets, self.references))

    def _mask_matrix(self, targets, exclude) -> torch.Tensor:
        masked = self._ref_names[None, :] == \
            np.array([t.name for t in targets])[:, None]
        if exclude is not None:
            masked |= self._ref_names[None, :] == exclude
        return torch.from_numpy(np.ascontiguousarray(masked)).to(self.device)

    def _mask(self, D: torch.Tensor, targets: list[WorkloadProfile],
              exclude: str | None) -> torch.Tensor:
        return torch.where(self._mask_matrix(targets, exclude), torch.inf, D)

    @staticmethod
    def _check_eligible(best: np.ndarray, targets: list[WorkloadProfile],
                        exclude: str | None) -> None:
        if np.any(np.isinf(best)):
            bad = targets[int(np.nonzero(np.isinf(best))[0][0])].name
            raise ValueError(
                f"no eligible reference for target {bad!r}: every reference "
                f"is excluded (self-match or exclude={exclude!r})")

    def _argbest(self, D: torch.Tensor, targets: list[WorkloadProfile],
                 exclude: str | None) -> tuple[np.ndarray, np.ndarray]:
        # argmin returns the first minimum, as np.argmin does
        idx = torch.argmin(D, dim=1)
        best = D.gather(1, idx[:, None])[:, 0]
        idx, best = idx.cpu().numpy(), best.cpu().numpy()
        self._check_eligible(best, targets, exclude)
        return idx, best

    def _pick(self, D: torch.Tensor, targets: list[WorkloadProfile],
              exclude: str | None) -> list[tuple[WorkloadProfile, float]]:
        idx, best = self._argbest(self._mask(D, targets, exclude), targets,
                                  exclude)
        return [(self.references[i], float(d)) for i, d in zip(idx, best)]


def _second_smallest(D: torch.Tensor) -> np.ndarray:
    """Row-wise second smallest value (``np.partition(D, 1)[:, 1]``)."""
    return torch.topk(D, 2, dim=1, largest=False).values[:, 1].cpu().numpy()


def _cosine_distances(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Pairwise cosine distances between the rows of A and of B; rows with
    zero norm are at distance 1 from everything.  Norms and dot products
    accumulate over the bins in a fixed order (``row_sq_norms`` /
    ``row_dots``), so row i of a batched call is bit-identical to a one-row
    call."""
    na = torch.sqrt(row_sq_norms(A))
    nb = torch.sqrt(row_sq_norms(B))
    Ua = A / torch.where(na > 0, na, torch.ones_like(na))[:, None]
    Ub = B / torch.where(nb > 0, nb, torch.ones_like(nb))[:, None]
    D = 1.0 - torch.clamp(row_dots(Ua, Ub), -1.0, 1.0)
    D[na == 0, :] = 1.0
    D[:, nb == 0] = 1.0
    return D


def count_classifier_calls(clf: "MinosClassifier") -> dict:
    """Instrument ``clf`` in place to count its neighbor/margin queries;
    returns a live ``{"n": count}`` dict — the spy behind the
    zero-reclassification pins (repacks and budget changes must leave the
    count unchanged)."""
    calls = {"n": 0}
    for name in ("power_neighbors", "util_neighbors", "power_top2",
                 "power_neighbors_idx", "util_neighbors_idx",
                 "power_top2_idx", "power_sweep"):
        orig = getattr(clf, name)

        def wrapped(*a, _orig=orig, **k):
            calls["n"] += 1
            return _orig(*a, **k)

        setattr(clf, name, wrapped)
    return calls
