"""Jaccard distance matrix over packed feature bitmaps.

Counterpart of ``repro/kernels/jaccard/ops.py``. Bitmaps are 32-bit words
carried as int32 tensors (the same bits as the reference's uint32: torch's
uint32 support is thin, and on the CPU ``>>`` on ``UInt32`` is not
implemented). On a CUDA tensor :func:`distance` launches one of the two
Hopper kernels of ``repro_torch/csrc/jaccard.cu``, chosen by
:func:`variant` from the shape alone; on a CPU tensor it runs
:func:`distance_plain`, which widens the words to int64 before its SWAR
popcount. All give float32 results bitwise equal to the reference's: the
adaptive controller's single-linkage HAC reads them as float64, so one bit
of drift changes merges and with them the layouts.

The variants:

* ``"row"`` (``jaccard_kernel``): one thread an output, looping over the W
  words of its two rows in device memory, ``popc(a & b)`` and
  ``popc(a | b)`` per word;
* ``"tile"`` (``jaccard_tile_kernel``): a block a ``TILE_Q`` x ``TILE_K``
  output tile, the word axis in chunks of ``CHUNK`` words copied into
  shared memory (16 bytes a copy where the rows are 16-byte aligned),
  each chunk zero-padded to a multiple of 4 words, each lane a 2 x 2
  micro-tile over every ``SPLIT``-th 16-byte group; only ``popc(a & b)``
  per pair, the union as ``|A| + (|B| - |A&B|)`` from each row's count.
  :func:`distance_tiled` repeats that order of work in torch ops.

Both count in int32, so a CUDA call takes W < ``MAX_WORDS`` = 2^26 words
(a union holds at most 32 W bits) and refuses more before any launch.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build, dispatch

TILE_Q, TILE_K = 8, 8    # a-rows and b-rows of a tile kernel block's tile
CHUNK = 64               # words of a tile kernel panel chunk
SPLIT = 8                # lanes of the tile kernel sharing a micro-tile
MAX_WORDS = 1 << 26      # the int32 counts hold 32 W bits for W below this
TILE_MIN_WORDS = 16      # "tile" from here up (chip_smoke.py's sweep) ...
FEW_ROWS = 8             # ... and from twice that for a b side this short


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


def distance_tiled(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The tile kernel's order of work in torch ops: blocks of ``TILE_Q``
    a-rows by ``TILE_K`` b-rows (past the edge the last row again, its
    outputs dropped), the words in chunks of ``CHUNK`` padded with zero
    words to a multiple of 4; each panel row counted in ``CHUNK // 4``
    partial sums, one a 16-byte group of every chunk, added at the end;
    each micro-tile's ``SPLIT`` lanes counting ``popc(a & b)`` over every
    ``SPLIT``-th 16-byte group of a chunk, added at the end; the union as
    ``|A| + (|B| - |A&B|)``."""
    q, w = a.shape
    k = b.shape[0]
    tq, tk = -(-q // TILE_Q), -(-k // TILE_K)
    w4 = -(-w // 4) * 4
    groups = CHUNK // 4

    def panels(t, n, tiles, rows):
        words = torch.nn.functional.pad(t.to(torch.int64) & 0xFFFFFFFF,
                                        (0, w4 - w))
        idx = torch.arange(tiles * rows, device=t.device).clamp(max=n - 1)
        return words[idx].view(tiles, rows, w4)

    def row_counts(p):
        # the thread of group g of a row adds group g of every chunk
        part = torch.zeros(p.shape[:-1] + (groups,), dtype=torch.int64,
                           device=p.device)
        for x0 in range(0, w4, CHUNK):
            chunk = _popcount32(p[..., x0:x0 + CHUNK])
            n4 = chunk.shape[-1] // 4
            part[..., :n4] += chunk.view(*p.shape[:-1], n4, 4).sum(-1)
        return part.sum(-1)

    # a-row gq + 4 i of a tile is [i, gq]; b-row gk + 4 j is [j, gk]
    pa = panels(a, q, tq, TILE_Q).view(tq, 2, TILE_Q // 2, w4)
    pb = panels(b, k, tk, TILE_K).view(tk, 2, TILE_K // 2, w4)
    count_a, count_b = row_counts(pa), row_counts(pb)
    lanes = [torch.zeros((tq, 2, TILE_Q // 2, tk, 2, TILE_K // 2),
                         dtype=torch.int64, device=a.device)
             for _ in range(SPLIT)]
    for x0 in range(0, w4, CHUNK):
        n4 = (min(x0 + CHUNK, w4) - x0) // 4
        for s in range(SPLIT):
            cols = [x0 + 4 * g + e for g in range(s, n4, SPLIT)
                    for e in range(4)]
            ua = pa[..., cols][:, :, :, None, None, None, :]
            ub = pb[..., cols][None, None, None]
            lanes[s] += _popcount32(ua & ub).sum(-1)
    inter = sum(lanes)                    # the three xor shuffles
    union = (count_a[:, :, :, None, None, None]
             + (count_b[None, None, None] - inter))
    dist = torch.where(union > 0,
                       1.0 - inter.to(torch.float32)
                       / union.clamp(min=1).to(torch.float32),
                       torch.zeros((), dtype=torch.float32, device=a.device))
    return dist.reshape(tq * TILE_Q, tk * TILE_K)[:q, :k].contiguous()


def variant(q: int, k: int, w: int) -> str:
    """Which kernel a CUDA call of a (``q``, ``w``) by (``k``, ``w``)
    distance matrix runs. ``"tile"`` costs about two launch floors at any
    shape up to a few thousand outputs; ``"row"`` costs one and a half plus
    a step a word, which grows with the rows of b a warp reads per word,
    min(k, 32). So ``"tile"`` from ``TILE_MIN_WORDS`` = 16 words up, and
    from twice that where b has at most ``FEW_ROWS`` rows; ``"row"`` below
    (the KG rounds' 2-word bitmaps). The thresholds are where the two
    crossed in ``chip_smoke.py``'s sweep (``PERF.md`` §6)."""
    if w >= 2 * TILE_MIN_WORDS or (w >= TILE_MIN_WORDS and k > FEW_ROWS):
        return "tile"
    return "row"


def _run(var: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch kernel ``var`` on checked CUDA inputs, counted under
    ``jaccard`` and ``jaccard.<var>``."""
    q, w = a.shape
    k = b.shape[0]
    entry = {"row": "rt_jaccard_distance", "tile": "rt_jaccard_tile"}[var]
    out = torch.empty((q, k), dtype=torch.float32, device=a.device)
    if q and k:
        _build.launch("jaccard", entry, a.device, a.data_ptr(), q,
                      b.data_ptr(), k, w, out.data_ptr(), variant=var)
    return out


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
    if w >= MAX_WORDS:
        raise ValueError(f"{w} words: the CUDA kernels count in int32 and "
                         f"take W < 2^26 = {MAX_WORDS} words")
    return _run(variant(q, b.shape[0], w), a, b)


def jaccard_distance(bitmaps, *, device) -> torch.Tensor:
    """Symmetric (Q, Q) float32 Jaccard distance matrix, on ``device``, of
    packed bitmaps: a (Q, W) uint32 numpy array (as
    ``FeatureSpace.workload_bitmaps`` returns) or an int32 tensor."""
    if isinstance(bitmaps, np.ndarray):
        words = np.ascontiguousarray(bitmaps, dtype=np.uint32).view(np.int32)
        bitmaps = torch.from_numpy(words)
    a = bitmaps.to(torch.device(device)).contiguous()
    return distance(a, a)
