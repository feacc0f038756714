"""Jaccard distance matrix over packed feature bitmaps.

Counterpart of ``repro/kernels/jaccard/ops.py``. Bitmaps are 32-bit words
carried as int32 tensors (the same bits as the reference's uint32: torch's
uint32 support is thin, and on the CPU ``>>`` on ``UInt32`` is not
implemented). On a CUDA tensor :func:`distance` launches the Hopper kernel
of ``repro_torch/csrc/jaccard.cu``; on a CPU tensor it runs
:func:`distance_plain`, which widens the words to int64 before its SWAR
popcount. Both give float32 results bitwise equal to the reference's: the
adaptive controller's single-linkage HAC reads them as float64, so one bit
of drift changes merges and with them the layouts.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build, dispatch


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of 32-bit words held in int64 (values in [0, 2^32))."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def distance_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(Q, W) x (K, W) int32 bitmaps -> (Q, K) float32 ``1 - |A&B|/|A|B|``,
    0 for two empty sets."""
    a64 = a.to(torch.int64) & 0xFFFFFFFF
    b64 = b.to(torch.int64) & 0xFFFFFFFF
    inter = _popcount32(a64[:, None, :] & b64[None, :, :]).sum(-1)
    union = _popcount32(a64[:, None, :] | b64[None, :, :]).sum(-1)
    sim = torch.where(union > 0,
                      inter.to(torch.float32)
                      / union.clamp(min=1).to(torch.float32),
                      torch.ones((), dtype=torch.float32, device=a.device))
    return 1.0 - sim


def distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(Q, W) x (K, W) int32 bitmaps -> (Q, K) float32 Jaccard distances.
    Replaces ``jaccard_distance_pallas``."""
    for name, t in (("a", a), ("b", b)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: expected torch.int32 bitmap words, "
                            f"got {t.dtype}")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous (rows, words) "
                             f"tensor, got shape {tuple(t.shape)}")
    if a.device != b.device:
        raise ValueError(f"a on {a.device}, b on {b.device}")
    if a.shape[1] != b.shape[1]:
        raise ValueError(f"word counts differ: {a.shape[1]} vs {b.shape[1]}")
    t = dispatch.tier(a)
    dispatch.note_tier("jaccard.distance", t)
    if t == "torch":
        return distance_plain(a, b)
    q, w = a.shape
    k = b.shape[0]
    out = torch.empty((q, k), dtype=torch.float32, device=a.device)
    if q and k:
        _build.launch("jaccard", "rt_jaccard_distance", a.device,
                      a.data_ptr(), q, b.data_ptr(), k, w, out.data_ptr())
    return out


def jaccard_distance(bitmaps, *, device) -> torch.Tensor:
    """Symmetric (Q, Q) float32 Jaccard distance matrix, on ``device``, of
    packed bitmaps: a (Q, W) uint32 numpy array (as
    ``FeatureSpace.workload_bitmaps`` returns) or an int32 tensor."""
    if isinstance(bitmaps, np.ndarray):
        words = np.ascontiguousarray(bitmaps, dtype=np.uint32).view(np.int32)
        bitmaps = torch.from_numpy(words)
    a = bitmaps.to(torch.device(device)).contiguous()
    return distance(a, a)
