"""Clustering primitives from scratch: pairwise distances and agglomerative
hierarchical clustering (Lance-Williams updates, ward/average/complete/
single linkage), on float64 torch tensors.

K-Means (``kmeans``, ``silhouette_score``, ``best_k_by_silhouette``) is a
float32 JAX jit in the reference and is not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch


def _f64(V) -> torch.Tensor:
    if isinstance(V, torch.Tensor):
        return V.to(torch.float64)
    return torch.as_tensor(np.asarray(V, np.float64))


def row_sq_norms(V: torch.Tensor) -> torch.Tensor:
    """sum_k V[:, k]^2, accumulated column by column in a fixed order, so
    row i does not depend on the other rows (no shape-dependent split)."""
    acc = torch.zeros(V.shape[0], dtype=V.dtype, device=V.device)
    for k in range(V.shape[1]):
        acc += V[:, k] * V[:, k]
    return acc


def row_dots(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """(n, m) matrix of A[i] . B[j], accumulated over k in a fixed order:
    row i of a batched call is bit-identical to a one-row call (a matmul
    kernel does not promise that across shapes)."""
    acc = torch.zeros((A.shape[0], B.shape[0]), dtype=A.dtype,
                      device=A.device)
    for k in range(A.shape[1]):
        acc += A[:, k, None] * B[None, :, k]
    return acc


def cosine_distance_matrix(V) -> torch.Tensor:
    """Pairwise cosine distances between row vectors (zero rows -> dist 1)."""
    V = _f64(V)
    norms = torch.sqrt(row_sq_norms(V))
    safe = torch.where(norms > 0, norms, torch.ones_like(norms))
    U = V / safe[:, None]
    d = 1.0 - torch.clamp(row_dots(U, U), -1.0, 1.0)
    zero = norms == 0
    d[zero, :] = 1.0
    d[:, zero] = 1.0
    d.fill_diagonal_(0.0)
    return d


def euclidean_distance_matrix(X) -> torch.Tensor:
    X = _f64(X)
    sq = row_sq_norms(X)
    d2 = sq[:, None] + sq[None, :] - 2 * row_dots(X, X)
    return torch.sqrt(torch.clamp(d2, min=0.0))


# ---------------------------------------------------------------------------
# agglomerative hierarchical clustering (Lance-Williams)
# ---------------------------------------------------------------------------
_LW = {
    # (ai, aj, b, g) over cluster sizes (ni, nj, nk)
    "average": lambda ni, nj, nk: (ni / (ni + nj), nj / (ni + nj), 0.0, 0.0),
    "complete": lambda ni, nj, nk: (0.5, 0.5, 0.0, 0.5),
    "single": lambda ni, nj, nk: (0.5, 0.5, 0.0, -0.5),
}


def linkage(dist, method: str = "ward") -> np.ndarray:
    """scipy-compatible linkage matrix Z (n-1, 4): [i, j, dist, size].

    ward uses the Lance-Williams recurrence on squared distances; other
    methods operate on raw distances.  The distance matrix is updated on its
    device; Z is a small host array.
    """
    D = _f64(dist).clone()
    n = D.shape[0]
    if method == "ward":
        D = D * D
    D.fill_diagonal_(float("inf"))
    sizes = torch.ones(n, dtype=torch.float64, device=D.device)
    ids = list(range(n))                     # row -> cluster id
    alive = torch.ones(n, dtype=torch.bool, device=D.device)
    Z = np.zeros((n - 1, 4))
    next_id = n
    for step in range(n - 1):
        # closest pair: dead rows/cols are held at inf, so a flat argmin
        # finds the first minimum in row-major order
        i, j = divmod(int(torch.argmin(D).item()), n)
        if i == j:
            raise RuntimeError("degenerate linkage state")
        if i > j:
            i, j = j, i
        dij = D[i, j]
        d_rep = torch.sqrt(dij) if method == "ward" else dij
        ni, nj = sizes[i].clone(), sizes[j].clone()
        Z[step] = [ids[i], ids[j], float(d_rep.item()),
                   float((ni + nj).item())]
        upd = alive.clone()
        upd[i] = False
        upd[j] = False
        nk = sizes[upd]
        dik, djk = D[i, upd], D[j, upd]
        if method == "ward":
            new = ((ni + nk) * dik + (nj + nk) * djk - nk * dij) \
                / (ni + nj + nk)
        else:
            ai, aj, bb, g = _LW[method](ni, nj, nk)
            new = ai * dik + aj * djk + bb * dij + g * torch.abs(dik - djk)
        D[i, upd] = new
        D[upd, i] = new
        sizes[i] = ni + nj
        ids[i] = next_id
        next_id += 1
        alive[j] = False
        D[j, :] = float("inf")
        D[:, j] = float("inf")
    return Z


def cut(Z: np.ndarray, threshold: float) -> np.ndarray:
    """Cluster labels from slicing the dendrogram at ``threshold``."""
    n = Z.shape[0] + 1
    parent = list(range(2 * n - 1))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for step in range(n - 1):
        i, j, d, _ = Z[step]
        if d <= threshold:
            node = n + step
            parent[find(int(i))] = node
            parent[find(int(j))] = node
    roots = {}
    labels = np.zeros(n, np.int64)
    for leaf in range(n):
        r = find(leaf)
        labels[leaf] = roots.setdefault(r, len(roots))
    return labels


def cut_k(Z: np.ndarray, k: int) -> np.ndarray:
    """Labels for exactly k clusters (cut just below the (k-1)-th last merge)."""
    n = Z.shape[0] + 1
    k = max(1, min(k, n))
    if k == 1:
        return np.zeros(n, np.int64)
    threshold = Z[n - k, 2] - 1e-12
    return cut(Z, threshold)
