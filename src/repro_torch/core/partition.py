"""Partition metadata (the paper's PMeta): feature -> shard ownership."""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass
class PartitionState:
    """Assignment of every owner feature to a shard (single copy, no replication)."""

    feature_to_shard: np.ndarray      # (F,) int32
    feature_sizes: np.ndarray         # (F,) int64 triples per feature
    n_shards: int

    def copy(self) -> "PartitionState":
        return PartitionState(self.feature_to_shard.copy(),
                              self.feature_sizes.copy(), self.n_shards)

    def shard_sizes(self) -> np.ndarray:
        return np.bincount(self.feature_to_shard, weights=self.feature_sizes,
                           minlength=self.n_shards).astype(np.int64)

    def imbalance(self) -> float:
        """max/mean shard size — 1.0 is perfectly balanced."""
        sizes = self.shard_sizes()
        mean = sizes.mean()
        return float(sizes.max() / mean) if mean > 0 else 1.0

    def triple_shards(self, owners: np.ndarray) -> np.ndarray:
        """Shard id per triple given owner-feature ids."""
        return self.feature_to_shard[owners]

    def features_on(self, shard: int) -> np.ndarray:
        return np.where(self.feature_to_shard == shard)[0]


def hash_partition(feature_sizes: np.ndarray, n_shards: int,
                   seed: int = 0) -> PartitionState:
    """Baseline: feature-hash partitioning (what non-workload-aware systems do)."""
    rng = np.random.default_rng(seed)
    f2s = rng.integers(0, n_shards, size=len(feature_sizes), dtype=np.int32)
    return PartitionState(f2s, np.asarray(feature_sizes, np.int64), n_shards)


def balanced_partition(feature_sizes: np.ndarray,
                       n_shards: int) -> PartitionState:
    """Workload-agnostic LPT round-robin: biggest feature to the least-loaded
    shard. The starting point both WawPart and AWAPart refine."""
    sizes = np.asarray(feature_sizes, np.int64)
    f2s = np.zeros(len(sizes), dtype=np.int32)
    shard_load = np.zeros(n_shards, dtype=np.int64)
    for f in np.argsort(-sizes).tolist():
        dst = int(np.argmin(shard_load))
        f2s[f] = dst
        shard_load[dst] += sizes[f]
    return PartitionState(f2s, sizes, n_shards)


def greedy_balance(state: PartitionState, movable: np.ndarray,
                   tolerance: float = 1.10) -> List[tuple]:
    """Fig.-5 lines 20–23: repeatedly move the largest movable feature from the
    largest shard into the smallest shard until within tolerance.

    Returns the list of (feature, src, dst) moves applied in place.
    """
    moves: List[tuple] = []
    movable_set = set(movable.tolist())
    for _ in range(10_000):
        sizes = state.shard_sizes()
        if sizes.max() <= tolerance * max(sizes.mean(), 1.0):
            break
        src = int(np.argmax(sizes))
        dst = int(np.argmin(sizes))
        feats = [f for f in state.features_on(src).tolist() if f in movable_set]
        if not feats:
            break
        gap = (sizes[src] - sizes[dst]) / 2
        fsz = state.feature_sizes[feats]
        # biggest feature that does not overshoot the midpoint (else smallest)
        ok = np.where(fsz <= gap)[0]
        pick = feats[int(ok[np.argmax(fsz[ok])])] if len(ok) else \
            feats[int(np.argmin(fsz))]
        if state.feature_sizes[pick] == 0:
            movable_set.discard(pick)
            continue
        state.feature_to_shard[pick] = dst
        moves.append((pick, src, dst))
        movable_set.discard(pick)
        if not movable_set:
            break
    return moves
