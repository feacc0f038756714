"""Hierarchical agglomerative clustering (Fig. 4) — single/complete/average linkage.

``hac_numpy`` is the host-side implementation the adaptive controller runs
(scipy-compatible merge list). The reference's jit-able ``hac_jax`` is off
the serving path and not ported yet.

Merges use Lance–Williams updates. Output is a scipy-style ``Z`` matrix
(n-1, 4): [cluster_a, cluster_b, distance, new_size] with original leaves
0..n-1 and merged cluster k getting id n+k. ``cut(Z, d)`` yields flat labels
(the paper's "feature set g based on HAC at similarity distance d", Fig. 5
line 5).
"""
from __future__ import annotations

import numpy as np

LINKAGES = ("single", "complete", "average")


def _lw_update(d_ki: np.ndarray, d_kj: np.ndarray, n_i: float, n_j: float,
               linkage: str):
    if linkage == "single":
        return np.minimum(d_ki, d_kj)
    if linkage == "complete":
        return np.maximum(d_ki, d_kj)
    if linkage == "average":
        return (n_i * d_ki + n_j * d_kj) / (n_i + n_j)
    raise ValueError(f"unknown linkage {linkage!r}")


def hac_numpy(dist: np.ndarray, linkage: str = "single") -> np.ndarray:
    """(n, n) symmetric distance matrix -> (n-1, 4) merge matrix Z."""
    assert linkage in LINKAGES
    d = np.array(dist, dtype=np.float64)
    n = d.shape[0]
    np.fill_diagonal(d, np.inf)
    active = np.ones(n, dtype=bool)
    sizes = np.ones(n)
    ids = np.arange(n)          # scipy-style cluster id held by each slot
    z = np.zeros((max(n - 1, 0), 4))
    for step in range(n - 1):
        masked = np.where(active[:, None] & active[None, :], d, np.inf)
        i, j = np.unravel_index(np.argmin(masked), masked.shape)
        if i > j:
            i, j = j, i
        dij = masked[i, j]
        z[step] = (min(ids[i], ids[j]), max(ids[i], ids[j]), dij,
                   sizes[i] + sizes[j])
        # merge j into slot i
        new_row = _lw_update(d[i], d[j], sizes[i], sizes[j], linkage)
        d[i, :] = new_row
        d[:, i] = new_row
        d[i, i] = np.inf
        active[j] = False
        sizes[i] += sizes[j]
        ids[i] = n + step
    return z


def cut(z: np.ndarray, distance: float) -> np.ndarray:
    """Flat cluster labels from Z, merging every row with dist <= distance."""
    z = np.asarray(z)
    m = z.shape[0]
    n = m + 1
    parent = np.arange(n + m)

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for step in range(m):
        a, b, dist, _ = z[step]
        new_id = n + step
        if dist <= distance:
            parent[find(int(a))] = new_id
            parent[find(int(b))] = new_id
    roots = np.array([find(i) for i in range(n)])
    _, labels = np.unique(roots, return_inverse=True)
    return labels.astype(np.int32)
