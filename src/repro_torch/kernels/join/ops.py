"""Hash-join ops: pack, probe, expand, gather, and the fused pipeline.

Counterpart of ``repro/kernels/join/ops.py``. Each granular op takes torch
tensors and picks its path from their device (``repro_torch.kernels
.dispatch``): on a CUDA tensor it launches its hand-written Hopper kernel
from ``repro_torch/csrc/join.cu``, on a CPU tensor it runs the plain
PyTorch version beside it (``*_plain``), which repeats the kernel's
arithmetic. There is no size floor and no fallback on the card.

Keys are native int64 throughout; the reference's hi/lo word pairs existed
only because the TPU has no int64.

:func:`hash_join_pipeline` chains pack -> stable build sort -> probe ->
expand -> gather with every intermediate on the device. The host sees the
two key-column uploads, the expansion-total scalar (the output size must be
known to allocate, and the row cap is checked on it before any pair array
exists) and the final ``(li, ri)`` pair: 5 crossings on a CUDA device, 0 on
the CPU (:func:`track_transfers` counts the crossings that happen). The
build sort is ``torch.sort(stable=True)`` on the device; its permutation
equals ``np.argsort(kind="stable")``, which fixes the order of ``ri``.

``hash_probe_numpy``, ``expand_pairs_numpy`` and ``_pipeline_numpy`` are
the host reference, copied from the reference package.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build, dispatch

_I64 = torch.int64


class ExpansionCapExceeded(RuntimeError):
    """A ragged pair expansion would materialize more rows than the
    caller's ``max_total`` cap (the executor maps this onto its
    ``JoinCapExceeded``, mirroring the cartesian-product cap)."""


# --------------------------------------------------------------------------- #
# host-transfer accounting
# --------------------------------------------------------------------------- #

@dataclasses.dataclass
class TransferStats:
    """Host<->device array crossings made by the ops in this module while a
    :func:`track_transfers` scope is active (one per array or scalar that
    crosses; none when the tensors live on the CPU)."""
    h2d: int = 0
    d2h: int = 0

    @property
    def total(self) -> int:
        return self.h2d + self.d2h


_transfer_scopes: List[TransferStats] = []


@contextlib.contextmanager
def track_transfers():
    """Count host<->device crossings performed by ops in this scope."""
    ts = TransferStats()
    _transfer_scopes.append(ts)
    try:
        yield ts
    finally:
        _transfer_scopes.remove(ts)


def _note(device: torch.device, h2d: int = 0, d2h: int = 0) -> None:
    if device.type == "cpu":
        return
    for ts in _transfer_scopes:
        ts.h2d += h2d
        ts.d2h += d2h


# --------------------------------------------------------------------------- #
# wrappers: checks shared by every kernel
# --------------------------------------------------------------------------- #

def _check(name: str, t: torch.Tensor, ndim: int, device: torch.device,
           dtype: torch.dtype = _I64) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim}-d, got shape "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _bisect(a: torch.Tensor, keys: torch.Tensor, *,
            right: bool) -> torch.Tensor:
    """Plain vectorized binary search: per key, the first index of the
    ascending ``a`` holding a value ``>= key`` (``right=False``) or
    ``> key`` (``right=True``) — searchsorted left / right, by the same
    bisection each kernel thread runs."""
    m = a.shape[0]
    lo = torch.zeros_like(keys)
    hi = torch.full_like(keys, m)
    for _ in range(m.bit_length()):           # ceil(log2(m + 1)) halvings
        mid = (lo + hi) >> 1
        v = a[mid.clamp(max=max(m - 1, 0))]
        go = (v <= keys) if right else (v < keys)
        go &= lo < hi
        lo = torch.where(go, mid + 1, lo)
        hi = torch.where(go, hi, mid)
    return lo


# --------------------------------------------------------------------------- #
# pack
# --------------------------------------------------------------------------- #

def pack_keys_plain(cols: torch.Tensor) -> torch.Tensor:
    """(K<=2, N) int64 key columns -> (N,) packed keys ``c0 * 2^31 + c1``."""
    key = cols[0]
    for c in cols[1:]:
        key = key * (1 << 31) + c
    return key.contiguous()


def pack_keys(cols: torch.Tensor) -> torch.Tensor:
    """(K<=2, N) int64 key columns (one row per column, values < 2^31) ->
    (N,) int64 keys, the base-2^31 positional packing of ``_pack_np``.
    Replaces ``pack_keys_pallas``. One column is its own key: it comes back
    as a view, with no kernel launched. Two columns at any storage offset
    and any N."""
    _check("cols", cols, 2, cols.device)
    k, n = cols.shape
    if not 1 <= k <= 2:
        raise ValueError(f"key columns must be reduced to <= 2, got {k}")
    if k == 1:
        return cols[0]
    t = dispatch.tier(cols)
    dispatch.note_tier("join.pack_keys", t)
    if t == "torch":
        return pack_keys_plain(cols)
    out = torch.empty(n, dtype=_I64, device=cols.device)
    if n:
        _build.launch("pack", "rt_pack_keys", cols.device, cols.data_ptr(),
                      n, k, out.data_ptr())
    return out


# --------------------------------------------------------------------------- #
# probe
# --------------------------------------------------------------------------- #

def probe_sorted_plain(build_sorted: torch.Tensor, probe: torch.Tensor,
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    lo = _bisect(build_sorted, probe, right=False)
    hi = _bisect(build_sorted, probe, right=True)
    return lo, hi - lo


PROBE_MAX_GROUP = 32          # lanes a probe key takes, at most: a warp
PROBE_MIN_GROUP = 4           # the fewest lanes worth a ballot
PROBE_SM_THREADS = 512        # threads on an SM while a search stays bound
                              # by latency (16 warps)


def probe_group(n: int, m: int, n_sms: int) -> int:
    """Lanes of the probe kernel that serve one probe key. The G lanes
    load G splitters of the ``m`` build keys in one round trip, so a search
    takes ``floor(log_{G+1} m) + 1`` rounds, but G times the loads of one
    lane: wide groups pay while the card is nearly empty and cost once it
    is busy. So G is the widest power of two ``<= 32`` with which ``n * G``
    threads stay within ``PROBE_SM_THREADS`` on each of the card's
    ``n_sms`` SMs; below ``PROBE_MIN_GROUP`` lanes, 1 (one lane runs a
    plain pair of bisections, with no ballot, which beat 2 lanes at every
    size timed on the H100). No more than the smallest power of two
    ``>= m``, with which one round settles a key."""
    g = PROBE_MAX_GROUP
    while g >= PROBE_MIN_GROUP and n * g > n_sms * PROBE_SM_THREADS:
        g //= 2
    if g < PROBE_MIN_GROUP:
        return 1
    return min(g, 1 << max(m - 1, 0).bit_length())


def _probe(build_sorted: torch.Tensor, probe: torch.Tensor, group: int,
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the probe kernel with ``group`` lanes a key on checked CUDA
    inputs (:func:`probe_sorted` passes :func:`probe_group`'s; another
    group is for timing the shapes of the search against each other)."""
    n, m = probe.shape[0], build_sorted.shape[0]
    lo = torch.empty(n, dtype=_I64, device=probe.device)
    counts = torch.empty(n, dtype=_I64, device=probe.device)
    if n:
        _build.launch("probe", "rt_probe_sorted", probe.device,
                      build_sorted.data_ptr(), m, probe.data_ptr(), n, group,
                      lo.data_ptr(), counts.data_ptr())
    return lo, counts


def probe_sorted(build_sorted: torch.Tensor, probe: torch.Tensor,
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per probe key, ``(lo, counts)``: the searchsorted-left index of the
    key in the ascending int64 ``build_sorted`` and the length of its run of
    equal keys. Replaces ``probe_sorted_pallas`` (which returned lo/hi
    counts from O(n*m) compares); here :func:`probe_group` lanes search
    k-ary for each key, both bounds in the same rounds."""
    dev = probe.device
    _check("build_sorted", build_sorted, 1, dev)
    _check("probe", probe, 1, dev)
    t = dispatch.tier(probe)
    dispatch.note_tier("join.probe_sorted", t)
    if t == "torch":
        return probe_sorted_plain(build_sorted, probe)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return _probe(build_sorted, probe,
                  probe_group(probe.shape[0], build_sorted.shape[0], n_sms))


# --------------------------------------------------------------------------- #
# expand
# --------------------------------------------------------------------------- #

def expand_pairs_plain(starts: torch.Tensor, lo: torch.Tensor, total: int,
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    j = torch.arange(total, dtype=_I64, device=starts.device)
    li = _bisect(starts, j, right=True) - 1
    return li, lo[li] + (j - starts[li])


EXPAND_THREADS = 256          # threads of an expand block
EXPAND_ITEMS = 3              # merge-path items one thread walks
EXPAND_TILE = EXPAND_THREADS * EXPAND_ITEMS     # items of one block


def expand_tiles(total: int, m: int) -> int:
    """Blocks of the expand kernel: the merge of ``total`` output slots
    with ``m`` segment starts, cut into tiles of ``EXPAND_TILE`` items.
    Empty segments take up items too, so no block's work grows with the
    lengths of runs of them."""
    return -(-(total + m) // EXPAND_TILE)


def expand_pairs(lo: torch.Tensor, counts: torch.Tensor, *,
                 starts: "torch.Tensor | None" = None,
                 total: "int | None" = None,
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Segmented ragged expansion of per-segment ``(lo, counts)`` runs into
    flat ``(li, pos)`` of length ``total = counts.sum()``: output ``j``
    belongs to segment ``li[j]`` (zero-count segments own nothing) and
    ``pos[j] = lo[li[j]] + j - starts[li[j]]``. ``starts`` (the exclusive
    cumsum of ``counts``) and ``total`` are computed when not given.
    Replaces ``expand_pairs_pallas``; the kernel walks the merge of output
    slots and segment starts in :func:`expand_tiles` tiles."""
    dev = counts.device
    _check("lo", lo, 1, dev)
    _check("counts", counts, 1, dev)
    if starts is None:
        starts = torch.cumsum(counts, 0) - counts
    _check("starts", starts, 1, dev)
    if not lo.shape[0] == counts.shape[0] == starts.shape[0]:
        raise ValueError("lo, counts and starts must have one length")
    if total is None:
        total = int(counts.sum())
    t = dispatch.tier(counts)
    dispatch.note_tier("join.expand_pairs", t)
    if t == "torch":
        return expand_pairs_plain(starts, lo, total)
    li = torch.empty(total, dtype=_I64, device=dev)
    pos = torch.empty(total, dtype=_I64, device=dev)
    if total:
        _build.launch("expand", "rt_expand_pairs", dev, starts.data_ptr(),
                      lo.data_ptr(), starts.shape[0], total, EXPAND_TILE,
                      li.data_ptr(), pos.data_ptr())
    return li, pos


def expand_segment_ids(counts: torch.Tensor) -> torch.Tensor:
    """``repeat_interleave(arange(len(counts)), counts)`` through the expand
    kernel — the segment-id half of the expansion, used by the executor's
    federation bincount build."""
    li, _ = expand_pairs(torch.zeros_like(counts), counts)
    return li


# --------------------------------------------------------------------------- #
# gather
# --------------------------------------------------------------------------- #

def gather_rows_plain(values: torch.Tensor, idx: torch.Tensor,
                      fill: int = 0) -> torch.Tensor:
    m = values.shape[0]
    out = torch.full_like(idx, fill)
    if m:
        valid = (idx >= 0) & (idx < m)
        out = torch.where(valid, values[idx.clamp(0, m - 1)], out)
    return out


def gather_rows(values: torch.Tensor, idx: torch.Tensor, *,
                fill: int = 0) -> torch.Tensor:
    """Masked gather ``values[idx]`` (int64), ``fill`` where ``idx`` lies
    outside ``[0, len(values))``. Replaces ``gather_rows_pallas``."""
    dev = idx.device
    _check("values", values, 1, dev)
    _check("idx", idx, 1, dev)
    t = dispatch.tier(idx)
    dispatch.note_tier("join.gather_rows", t)
    if t == "torch":
        return gather_rows_plain(values, idx, fill)
    n = idx.shape[0]
    out = torch.empty(n, dtype=_I64, device=dev)
    if n:
        _build.launch("gather", "rt_gather_rows", dev, values.data_ptr(),
                      values.shape[0], idx.data_ptr(), n, int(fill),
                      out.data_ptr())
    return out


# --------------------------------------------------------------------------- #
# the host reference
# --------------------------------------------------------------------------- #

def hash_probe_numpy(lcs: Sequence[np.ndarray], rcs: Sequence[np.ndarray],
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The host probe: base-2^31 pack + stable sort + searchsorted."""
    lk = _pack_np(lcs)
    rk = _pack_np(rcs)
    order = np.argsort(rk, kind="stable")
    rk_sorted = rk[order]
    lo = np.searchsorted(rk_sorted, lk, side="left")
    hi = np.searchsorted(rk_sorted, lk, side="right")
    return order, lo, hi - lo


def _pack_np(cols: Sequence[np.ndarray]) -> np.ndarray:
    key = cols[0]
    for c in cols[1:]:
        key = key * np.int64(1 << 31) + c
    return key


def expand_pairs_numpy(lo: np.ndarray, counts: np.ndarray,
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """The host expansion: ``li`` repeats each segment id ``counts[i]``
    times; ``pos`` walks ``lo[i], lo[i]+1, ...`` within each run."""
    lo = np.asarray(lo, np.int64)
    counts = np.asarray(counts, np.int64)
    n = counts.shape[0]
    total = int(counts.sum())
    li = np.repeat(np.arange(n, dtype=np.int64), counts)
    starts = np.cumsum(counts) - counts
    offs = np.arange(total, dtype=np.int64) - np.repeat(starts, counts)
    pos = np.repeat(lo, counts) + offs
    return li, pos


# --------------------------------------------------------------------------- #
# the fused probe -> expand -> gather pipeline
# --------------------------------------------------------------------------- #

def _check_total(total: int, max_total: "int | None") -> None:
    if max_total is not None and total > max_total:
        raise ExpansionCapExceeded(
            f"hash-join ragged expansion would materialize {total} rows, "
            f"above the {max_total}-row cap")


_EMPTY_PAIR = (np.empty(0, np.int64), np.empty(0, np.int64), 0)


def _pipeline_numpy(lcs, rcs, max_total):
    """Pure-host pipeline; the cap check sits between probe and expansion,
    where the device pipeline checks it."""
    order, lo, counts = hash_probe_numpy(lcs, rcs)
    total = int(counts.sum())
    _check_total(total, max_total)
    if total == 0:
        return _EMPTY_PAIR
    li, pos = expand_pairs_numpy(lo, counts)
    return li, order[pos], total


def _upload(cols: Sequence[np.ndarray], device: torch.device) -> torch.Tensor:
    _note(device, h2d=1)
    host = torch.from_numpy(np.ascontiguousarray(
        np.stack([np.asarray(c, np.int64) for c in cols])))
    return host.to(device)


def hash_join_pipeline(lcs: Sequence[np.ndarray], rcs: Sequence[np.ndarray],
                       *, device, max_total: "int | None" = None,
                       ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Fused pack -> sort -> probe -> expand -> gather on ``device``: host
    key columns in (``lcs`` probe side, ``rcs`` build side, each <= 2 int
    columns of values < 2^31), host ``(li, ri, total)`` out — ``li``
    probe-side rows, ``ri`` build-side rows, both int64, in the order of
    :func:`_pipeline_numpy`. ``max_total`` caps the expansion before any
    pair array exists (:class:`ExpansionCapExceeded`)."""
    assert len(lcs) <= 2 and len(rcs) <= 2, "reduce key columns first"
    device = torch.device(device)
    nl, nr = len(lcs[0]), len(rcs[0])
    if nl == 0 or nr == 0:
        return _EMPTY_PAIR
    dispatch.note_tier("join.pipeline",
                       "cuda" if device.type == "cuda" else "torch")
    lk = pack_keys(_upload(lcs, device))
    rk = pack_keys(_upload(rcs, device))
    rk_sorted, order = torch.sort(rk, stable=True)
    lo, counts = probe_sorted(rk_sorted, lk)
    starts = torch.cumsum(counts, 0) - counts
    _note(device, d2h=1)
    total = int(counts.sum())                 # the one mid-pipeline sync
    _check_total(total, max_total)
    if total == 0:
        return _EMPTY_PAIR
    li, pos = expand_pairs(lo, counts, starts=starts, total=total)
    ri = gather_rows(order, pos)
    _note(device, d2h=2)
    return li.cpu().numpy(), ri.cpu().numpy(), total
