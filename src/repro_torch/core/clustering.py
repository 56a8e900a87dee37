"""Clustering primitives from scratch: pairwise distances, agglomerative
hierarchical clustering (Lance-Williams updates, ward/average/complete/
single linkage) on float64 torch tensors, K-Means and silhouette scores.

K-Means runs its Lloyd iterations in float32 on the device, as the
reference's jit does with x64 off; every sum in it (the per-cluster sums,
the distances over features, the inertia) runs in a fixed order, so the
card and the host give the same bits and keep the same restart.  kmeans++
seeding stays float64 on the host, on ``np.random.default_rng``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device


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


def mahalanobis_distance_matrix(X, reg: float = 1e-6) -> torch.Tensor:
    """Mahalanobis pairwise distances (paper §4.1.2 names this as an
    alternative metric that accounts for feature correlations)."""
    X = _f64(X)
    eye = torch.eye(X.shape[1], dtype=torch.float64, device=X.device)
    prec = torch.linalg.inv(torch.cov(X.T) + reg * eye)
    diff = X[:, None, :] - X[None, :, :]
    d2 = torch.einsum("ijk,kl,ijl->ij", diff, prec, diff)
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


def dendrogram_order(Z: np.ndarray) -> list[int]:
    """Leaf ordering for display (left subtree first, from the root)."""
    n = Z.shape[0] + 1
    order, stack = [], [2 * n - 2]
    while stack:
        node = stack.pop()
        if node < n:
            order.append(node)
        else:
            a, b = Z[node - n, :2]
            stack += [int(b), int(a)]
    return order


# ---------------------------------------------------------------------------
# K-Means (float32 Lloyd iterations on the device) + silhouette
# ---------------------------------------------------------------------------
def _host_f64(X) -> np.ndarray:
    if isinstance(X, torch.Tensor):
        return X.detach().to(torch.float64).cpu().numpy()
    return np.asarray(X, np.float64)


# the reference's Lloyd is a float32 XLA compile on the CPU: it contracts
# each distance's sum of squares into fused multiply-adds, and reduces more
# than _XLA_WINDOW rows in windows of that many (the first one short by half
# the padding); the port follows both, so it keeps the reference's bits
_XLA_WINDOW = 32


def _sq_distances(X: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """(R, n, k) float32 squared distances of the rows of X (n, d) to the
    centres C (R, k, d): a fused multiply-add per feature, in order.  Each
    square is exact in float64 and each sum is rounded to float32 once
    more; the double rounding (about one term in 2^28) is the only
    departure from a true FMA."""
    diff = (X[None, :, None, :] - C[:, None, :, :]).to(torch.float64)
    sq = diff * diff
    d = sq[..., 0].to(torch.float32)
    for j in range(1, sq.shape[-1]):
        d = (d.to(torch.float64) + sq[..., j]).to(torch.float32)
    return d


def _row_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in the reference's order: one after another,
    by windows of ``_XLA_WINDOW`` beyond that many."""
    n = v.shape[-1]
    bounds = [0, n]
    if n > _XLA_WINDOW:
        pad = -n % _XLA_WINDOW
        bounds = [0, *range(_XLA_WINDOW - pad // 2, n, _XLA_WINDOW), n]
    total = None
    for a, b in zip(bounds[:-1], bounds[1:]):
        part = v[..., a]
        for i in range(a + 1, b):
            part = part + v[..., i]
        total = part if total is None else total + part
    return total


def _lloyd(X: torch.Tensor, init: torch.Tensor, k: int, iters: int):
    """``iters`` Lloyd steps from each of the R starts in ``init`` (R, k, d),
    all in float32; returns (centers, labels, inertia) per start.  A
    cluster's sum adds its members in row order, as the reference's one-hot
    product does, never through atomics."""
    n = X.shape[0]
    centers = init
    for _ in range(iters):
        lab = torch.argmin(_sq_distances(X, centers), dim=2)
        onehot = torch.nn.functional.one_hot(lab, k).to(X.dtype)
        counts = onehot.sum(dim=1)[..., None]               # exact: 0/1s
        terms = onehot[..., None] * X[None, :, None, :]     # (R, n, k, d)
        sums = terms[:, 0]
        for i in range(1, n):
            sums = sums + terms[:, i]
        centers = torch.where(counts > 0,
                              sums / torch.clamp(counts, min=1.0), centers)
    d = _sq_distances(X, centers)
    best, labels = d.min(dim=2)
    return centers, labels, _row_sum(best)


def kmeanspp_init(X, k: int, rng: np.random.Generator) -> np.ndarray:
    """kmeans++ seeding (float64, on the host) with an incrementally
    maintained nearest-centre distance; draws the reference's RNG stream,
    and so its centres."""
    X = _host_f64(X)
    centers = np.empty((k, X.shape[1]))
    centers[0] = X[rng.integers(len(X))]
    d2 = np.sum((X - centers[0]) ** 2, axis=1)
    for m in range(1, k):
        tot = d2.sum()
        if tot <= 0:
            idx = rng.integers(len(X))
        else:
            idx = rng.choice(len(X), p=d2 / tot)
        centers[m] = X[idx]
        d2 = np.minimum(d2, np.sum((X - centers[m]) ** 2, axis=1))
    return centers


def kmeans(X, k: int, seed: int = 0, iters: int = 50, restarts: int = 4,
           device=DEFAULT_DEVICE):
    """K-Means with kmeans++ seeding; returns (centers, labels, inertia):
    float32 centres and labels as host arrays, the inertia a float.  The
    restarts run side by side on ``device``; the first one with the
    strictly lowest inertia wins."""
    dev = resolve_device(device)
    X64 = _host_f64(X)
    rng = np.random.default_rng(seed)
    inits = np.stack([kmeanspp_init(X64, k, rng) for _ in range(restarts)])
    c, lab, inertia = _lloyd(
        torch.from_numpy(X64).to(dev, torch.float32),
        torch.from_numpy(inits).to(dev, torch.float32), k, iters)
    inertia = inertia.cpu().tolist()
    best = 0
    for r in range(1, restarts):
        if inertia[r] < inertia[best]:
            best = r
    return c[best].cpu().numpy(), lab[best].cpu().numpy(), inertia[best]


def silhouette_score(X, labels, device=DEFAULT_DEVICE) -> float:
    """Mean silhouette (float64 on ``device``): each point's distance sums
    to every cluster come from one fixed-order product of the distance
    matrix with the cluster one-hot."""
    dev = resolve_device(device)
    X = _f64(X).to(dev)
    labels = labels.cpu().numpy() if isinstance(labels, torch.Tensor) \
        else np.asarray(labels)
    n = len(X)
    uniq, inv = np.unique(labels, return_inverse=True)
    k = len(uniq)
    if k < 2 or n < 3:
        return 0.0
    D = euclidean_distance_matrix(X)
    inv = torch.from_numpy(inv).to(dev)
    onehot = torch.nn.functional.one_hot(inv, k).to(torch.float64)
    counts = onehot.sum(dim=0)                        # (k,)
    sums = row_dots(D, onehot.T)                      # (n, k)
    own = counts[inv]                                 # own-cluster sizes
    rows = torch.arange(n, device=dev)
    a = sums[rows, inv] / torch.clamp(own - 1, min=1.0)
    means = sums / counts[None, :]
    means[rows, inv] = float("inf")                   # b: nearest OTHER
    b = means.min(dim=1).values
    mx = torch.maximum(a, b)
    s = torch.where((own > 1) & (mx > 0),
                    (b - a) / torch.where(mx > 0, mx, torch.ones_like(mx)),
                    torch.zeros_like(mx))
    return float(s.mean().item())


def best_k_by_silhouette(X, k_range=range(3, 18), seed: int = 0,
                         device=DEFAULT_DEVICE):
    """Silhouette sweep (paper: K_util in [3, 17], optimum 3)."""
    scores = {}
    for k in k_range:
        if k >= len(X):
            break
        _, labels, _ = kmeans(X, k, seed=seed, device=device)
        scores[k] = silhouette_score(X, labels, device=device)
    best = max(scores, key=scores.get)
    return best, scores
