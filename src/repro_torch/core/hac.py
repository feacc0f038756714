"""Hierarchical agglomerative clustering (Fig. 4) — single/complete/average linkage.

Two implementations with identical semantics:
  * ``hac_numpy`` — host-side reference (scipy-compatible merge list), the
    one the adaptive controller runs;
  * ``hac_torch`` — the same merges in float32 on a torch device (the card
    unless the caller asks for the CPU), step for step the reference's
    jit-able ``hac_jax``: plain PyTorch, off the serving path.

Merges use Lance–Williams updates. Output is a scipy-style ``Z`` matrix
(n-1, 4): [cluster_a, cluster_b, distance, new_size] with original leaves
0..n-1 and merged cluster k getting id n+k. ``cut(Z, d)`` yields flat labels
(the paper's "feature set g based on HAC at similarity distance d", Fig. 5
line 5).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import dispatch

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


def _fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` for float32 tensors, rounded once, as a fused
    multiply-add rounds it: the product is exact in float64 (24 × 24 bits),
    the sum is rounded to odd there (TwoSum's error term picks the odd
    neighbour) and then to float32, which rounds as one rounding would
    (Boldo and Melquiond, 2008). Infinite sums pass through."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, float("inf"), float("-inf")).double()
    nudge = torch.isfinite(s) & (err != 0) & even
    return torch.where(nudge, torch.nextafter(s, toward), s).float()


def hac_torch(dist, linkage: str = "single", *,
              device="cuda") -> torch.Tensor:
    """HAC in float32 on ``device``; the same Z as the reference's
    ``hac_jax``: the diagonal set to +inf, n - 1 masked argmins over the
    flattened matrix (ties to the first index), and the Lance–Williams row
    updates in the same order of float32 operations: XLA contracts the
    average linkage's ``n_i d_i + n_j d_j`` into one fused multiply-add on
    the CPU, and so does :func:`_fma32`. Every index stays a one-element
    tensor, so the loop never waits on the device."""
    if linkage not in LINKAGES:
        raise ValueError(f"unknown linkage {linkage!r}; expected one of "
                         f"{list(LINKAGES)}")
    dev = dispatch.resolve_device(device)
    d = torch.as_tensor(dist, dtype=torch.float32, device=dev).clone(
        memory_format=torch.contiguous_format)
    n = d.shape[0]
    big = float("inf")
    diag = torch.arange(n, device=dev)
    d[diag, diag] = big
    flat_d = d.view(-1)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    sizes = torch.ones(n, dtype=torch.float32, device=dev)
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    z = torch.zeros((max(n - 1, 0), 4), dtype=torch.float32, device=dev)
    for step in range(n - 1):
        masked = torch.where(active[:, None] & active[None, :], d, big)
        flat = torch.argmin(masked.view(-1), dim=0, keepdim=True)
        i0, j0 = flat // n, flat % n
        i, j = torch.minimum(i0, j0), torch.maximum(i0, j0)
        dij = masked.view(-1).index_select(0, i * n + j)
        id_i, id_j = ids.index_select(0, i), ids.index_select(0, j)
        s_i, s_j = sizes.index_select(0, i), sizes.index_select(0, j)
        z[step] = torch.cat([torch.minimum(id_i, id_j).float(),
                             torch.maximum(id_i, id_j).float(),
                             dij, s_i + s_j])
        di, dj = d.index_select(0, i), d.index_select(0, j)
        if linkage == "single":
            new_row = torch.minimum(di, dj)
        elif linkage == "complete":
            new_row = torch.maximum(di, dj)
        else:
            new_row = _fma32(s_i, di, s_j * dj) / (s_i + s_j)
        d.index_copy_(0, i, new_row)
        d.index_copy_(1, i, new_row.t())
        flat_d.index_fill_(0, i * n + i, big)
        active.index_fill_(0, j, False)
        sizes.index_copy_(0, i, s_i + s_j)
        ids.index_fill_(0, i, n + step)
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
