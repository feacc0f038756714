"""repro_torch.replicate — workload-aware read replication of hot features.

AWAPart adapts the *placement* of triples to the workload, but a single-copy
layout cannot eliminate the residual distributed joins: a hot feature touched
by queries homed on many different shards forces cut-edge shipping wherever
it lands. AdPart and TAPER both resolve this by incrementally *replicating*
frequently-accessed data alongside workload-adaptive placement — a query
reads the copy nearest to its PPN, and only features with no local copy are
shipped.

This package is the layout side of that idea:

* :class:`ReplicaMap` — feature -> set-of-shards, carried by
  ``PartitionedKG`` beside the primary ``PartitionState``. The primary
  assignment stays authoritative (exactly one designated primary copy per
  feature; writes/deltas fan out to every copy); replicas are pure read
  copies the planner may serve locally.
* :func:`propose_replicas` — the per-adaptation-round policy: promote the
  hottest workload features (``migration.feature_heat``) onto the PPNs that
  read them remotely, greedy under a byte budget; features not re-proposed
  are demoted. The ``AWAPartController`` calls this each round and the
  accept guard prices the resulting copy traffic like any other migration
  bytes.

Replica *materialization* is not a new mechanism: promotions/demotions ride
the existing ``MigrationPlan``/``MigrationChunk``/``MigrationSession``
machinery (``repro_torch.core.migration``, ``repro_torch.migrate``) as ``replica_adds``
/ ``replica_drops`` ops, so copy traffic drains under the same
``migration_budget`` as moves and every partially-replicated layout is a
first-class served epoch.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.core.migration import TRIPLE_BYTES, feature_heat
from repro_torch.core.partition import PartitionState

__all__ = ["ReplicaMap", "propose_replicas"]


def _popcount(masks: np.ndarray) -> np.ndarray:
    """Set bits per uint64 mask, (F,) int64 (portable: no np.bitwise_count)."""
    if len(masks) == 0:
        return np.zeros(0, dtype=np.int64)
    bits = np.unpackbits(np.ascontiguousarray(masks).view(np.uint8))
    return bits.reshape(len(masks), 64).sum(axis=1).astype(np.int64)


@dataclasses.dataclass
class ReplicaMap:
    """Which shards hold a copy of each feature, as per-feature bitmasks.

    ``masks[f]`` has bit ``s`` set iff shard ``s`` holds a copy of feature
    ``f``'s triples. The designated primary copy is NOT stored here — it is
    the ``PartitionState.feature_to_shard`` assignment carried beside this
    map — but its bit is always set (invariant maintained by every mutation
    path), so ``masks`` alone answers "who can serve f locally".
    """

    masks: np.ndarray                  # (F,) uint64 holder bitmask
    n_shards: int

    def __post_init__(self) -> None:
        assert self.n_shards <= 64, "bitmask layout supports <= 64 shards"
        self.masks = np.ascontiguousarray(self.masks, dtype=np.uint64)

    @classmethod
    def primary_only(cls, state: PartitionState) -> "ReplicaMap":
        """The no-replication layout: each feature held by its primary."""
        masks = (np.uint64(1) << state.feature_to_shard.astype(np.uint64))
        return cls(masks, state.n_shards)

    def copy(self) -> "ReplicaMap":
        return ReplicaMap(self.masks.copy(), self.n_shards)

    # ------------------------------------------------------------------ #
    @property
    def n_features(self) -> int:
        return len(self.masks)

    @property
    def has_replicas(self) -> bool:
        """True when any feature has more than one copy."""
        m = self.masks
        return bool((m & (m - np.uint64(1))).any())

    def has(self, f: int, s: int) -> bool:
        return bool((self.masks[f] >> np.uint64(s)) & np.uint64(1))

    def holders(self, f: int) -> List[int]:
        m = int(self.masks[f])
        return [s for s in range(self.n_shards) if (m >> s) & 1]

    def on_shard(self, s: int) -> np.ndarray:
        """(F,) bool: does shard ``s`` hold a copy of each feature?"""
        return ((self.masks >> np.uint64(s)) & np.uint64(1)).astype(bool)

    def n_copies(self) -> np.ndarray:
        """(F,) copies per feature (always >= 1 once primaries are set)."""
        return _popcount(self.masks)

    def replicated(self) -> np.ndarray:
        """Feature ids holding more than one copy."""
        m = self.masks
        return np.flatnonzero(m & (m - np.uint64(1)))

    def replica_bytes(self, feature_sizes: np.ndarray) -> int:
        """Total bytes of non-primary copies (the ``replica_budget`` unit)."""
        extra = np.maximum(self.n_copies() - 1, 0)
        return int((extra * np.asarray(feature_sizes, np.int64)).sum()
                   * TRIPLE_BYTES)

    # ------------------------------------------------------------------ #
    def add(self, f: int, s: int) -> None:
        self.masks[f] |= np.uint64(1) << np.uint64(s)

    def remove(self, f: int, s: int) -> None:
        self.masks[f] &= ~(np.uint64(1) << np.uint64(s))

    def move_primary(self, f: int, src: int, dst: int) -> None:
        """A primary move ships the data away from ``src``: the copy leaves
        ``src`` and lands on ``dst`` (merging with any replica already
        there); other replicas are untouched."""
        self.masks[f] = (self.masks[f] & ~(np.uint64(1) << np.uint64(src))) \
            | (np.uint64(1) << np.uint64(dst))

    def extend(self, feature_to_shard: np.ndarray) -> None:
        """Grow to a larger feature universe: new features (split PO
        children) start primary-only on their inherited shard."""
        n_new = len(feature_to_shard) - len(self.masks)
        assert n_new >= 0
        if n_new == 0:
            return
        new = (np.uint64(1)
               << feature_to_shard[len(self.masks):].astype(np.uint64))
        self.masks = np.concatenate([self.masks, new])

    def __eq__(self, other) -> bool:
        return (isinstance(other, ReplicaMap)
                and self.n_shards == other.n_shards
                and np.array_equal(self.masks, other.masks))


# --------------------------------------------------------------------------- #
# promotion/demotion policy (one call per adaptation round)
# --------------------------------------------------------------------------- #

def propose_replicas(space, state: PartitionState, queries: Sequence,
                     budget_bytes: int, *,
                     heat: np.ndarray | None = None,
                     write_heat: np.ndarray | None = None) -> ReplicaMap:
    """Workload-aware replica set for ``state``, greedy under a byte budget.

    Candidates are ``(feature, shard)`` pairs where some query's PPN reads
    the feature remotely (the feature's primary is not the PPN). Promotion
    order is hottest feature first (``migration.feature_heat``), then the
    pair's frequency-weighted remote demand, with deterministic id
    tie-breaks. A copy costs its feature's triples in bytes; pairs that no
    longer fit the remaining budget are skipped so smaller hot features can
    still fill it. Features not selected hold only their primary copy —
    demotion of cold replicas is implicit in rebuilding the map fresh each
    round.

    ``write_heat`` (rows written per feature this TM window, already scaled
    by the caller's write-rate weight — see ``AdaptConfig.write_cost_weight``)
    turns the order write-aware: a copy of a written feature must receive
    every write too, so promotion ranks by *net* heat (read minus write) and
    a candidate whose recurring fanout outweighs its read demand is never
    proposed — the accept guard then prices dropping the existing copy as a
    per-window saving. None keeps the read-only behaviour bit-identical."""
    rmap = ReplicaMap.primary_only(state)
    budget = int(budget_bytes or 0)
    queries = list(queries)
    if budget <= 0 or not queries:
        return rmap
    from repro_torch.query import plan as qplan     # deferred: keeps imports acyclic

    if heat is None:
        heat = feature_heat(space, queries)
    net_heat = np.asarray(heat, np.float64)
    if write_heat is not None:
        wh = np.zeros(len(net_heat))
        wh[:min(len(net_heat), len(write_heat))] = \
            write_heat[:min(len(net_heat), len(write_heat))]
        net_heat = net_heat - wh
    sizes = np.asarray(state.feature_sizes, np.int64)
    demand: Dict[Tuple[int, int], float] = {}
    for q in queries:
        ppn = qplan.primary_shard(q, space, state)
        for f in space.query_features(q).tolist():
            if int(state.feature_to_shard[f]) != ppn:
                key = (int(f), int(ppn))
                demand[key] = demand.get(key, 0.0) + q.frequency
    order = sorted(demand, key=lambda fs: (-float(net_heat[fs[0]]),
                                           -demand[fs], fs))
    spent = 0
    for f, s in order:
        if write_heat is not None and net_heat[f] <= 0:
            continue           # fanout eats the read savings: don't promote
        cost = int(sizes[f]) * TRIPLE_BYTES
        if cost <= 0 or rmap.has(f, s) or spent + cost > budget:
            continue
        rmap.add(f, s)
        spent += cost
    return rmap
