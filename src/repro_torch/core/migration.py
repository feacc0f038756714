"""Triple-migration planning between shard layouts (Sec. III.B / IV).

Only triples of *re-assigned* features move — the incremental adjustment that
distinguishes AWAPart from full re-partitioning. A plan lists
(feature, src, dst) moves plus the migration traffic they imply.

A plan can additionally be *chunked* (``chunk_plan``) into prioritized
``MigrationChunk``s — hottest workload features first, each chunk bounded by
a per-step bytes budget — so an online ``repro_torch.migrate.MigrationSession`` can
apply it incrementally while queries keep being served, instead of one
stop-the-world commit. ``migration_seconds`` prices the traffic of a plan or
chunk under the same network model the executors use, which is what the
controller's migration-cost-aware accept guard amortizes.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.partition import PartitionState

TRIPLE_BYTES = 12  # dictionary-encoded (s, p, o) int32


@dataclasses.dataclass
class MigrationPlan:
    moves: List[Tuple[int, int, int]]        # (feature, src_shard, dst_shard)
    n_triples: int
    bytes: int
    # replica ops (repro_torch.replicate): an add ships a read copy of a feature
    # to a new holder shard (src == dst marks a zero-traffic promotion — the
    # data is already local, e.g. the feature's old primary keeps a copy);
    # a drop retires a copy in place (no traffic). local_moves lists the
    # features of `moves` whose destination already held a replica copy:
    # the primary re-designation ships nothing.
    replica_adds: List[Tuple[int, int, int]] = \
        dataclasses.field(default_factory=list)   # (feature, src, dst)
    replica_drops: List[Tuple[int, int]] = \
        dataclasses.field(default_factory=list)   # (feature, shard)
    local_moves: List[int] = dataclasses.field(default_factory=list)

    @property
    def n_moves(self) -> int:
        return len(self.moves)

    @property
    def n_replica_ops(self) -> int:
        return len(self.replica_adds) + len(self.replica_drops)

    def summary(self) -> str:
        rep = (f", {len(self.replica_adds)}+/{len(self.replica_drops)}- "
               "replicas" if self.n_replica_ops else "")
        return (f"{self.n_moves} feature moves{rep}, {self.n_triples} "
                f"triples, {self.bytes / 1e6:.2f} MB migration traffic")


@dataclasses.dataclass
class MigrationChunk:
    """One bounded step of a chunked migration: a slice of a plan's ops
    (grouped per feature — a feature's move and its replica ops never split
    across chunks) whose total traffic fits the per-step bytes budget."""
    moves: List[Tuple[int, int, int]]        # (feature, src_shard, dst_shard)
    n_triples: int
    bytes: int
    replica_adds: List[Tuple[int, int, int]] = \
        dataclasses.field(default_factory=list)
    replica_drops: List[Tuple[int, int]] = \
        dataclasses.field(default_factory=list)
    local_moves: List[int] = dataclasses.field(default_factory=list)

    @property
    def n_moves(self) -> int:
        return len(self.moves)

    def summary(self) -> str:
        rep = (f", {len(self.replica_adds)}+/{len(self.replica_drops)}- "
               "replicas" if self.replica_adds or self.replica_drops else "")
        return (f"chunk: {self.n_moves} moves{rep}, {self.n_triples} "
                f"triples, {self.bytes / 1e3:.1f} KB")


def migration_seconds(plan_or_chunk, net) -> float:
    """Modeled wall time to ship a plan/chunk's triples between shards: one
    transfer-setup latency per distinct (src, dst) shard pair plus wire time
    for the payload. Replica adds ship like moves; drops, src == dst local
    promotions, and moves onto a shard already holding a copy
    (``local_moves``) are free. ``net`` is any object with ``latency_s`` /
    ``bandwidth_Bps`` (e.g. ``repro_torch.query.exec.NetworkModel``)."""
    local = set(getattr(plan_or_chunk, "local_moves", ()))
    pairs = {(src, dst) for f, src, dst in plan_or_chunk.moves
             if f not in local}
    pairs |= {(src, dst)
              for _, src, dst in getattr(plan_or_chunk, "replica_adds", [])
              if src != dst}
    return len(pairs) * net.latency_s + plan_or_chunk.bytes / net.bandwidth_Bps


def feature_heat(space, queries: Sequence) -> np.ndarray:
    """Frequency-weighted workload touch count per feature — the priority
    used to order migration chunks (hottest features migrate first, so the
    layout the workload actually hits converges earliest)."""
    heat = np.zeros(space.n_features, dtype=np.float64)
    for q in queries:
        heat[space.query_features(q)] += q.frequency
    return heat


def chunk_plan(plan: MigrationPlan, feature_sizes: np.ndarray,
               bytes_budget: int,
               priority: Optional[np.ndarray] = None) -> List[MigrationChunk]:
    """Split ``plan`` into ``MigrationChunk``s of at most ``bytes_budget``
    migration traffic each (a single feature's ops larger than the budget
    get their own chunk — ops are atomic at feature granularity, and a
    feature's move plus its replica adds/drops always land in ONE chunk:
    an add may retain a copy at the feature's old primary, which is only
    zero-traffic if it applies together with the move).

    Features are ordered hottest-first by ``priority`` (per-feature workload
    heat; ties broken by traffic, then by feature id for determinism), so
    early chunks carry the features the workload is actually touching.
    """
    if not plan.moves and not plan.replica_adds and not plan.replica_drops:
        return []
    sizes = np.asarray(feature_sizes, dtype=np.int64)

    groups: dict = {}

    def group(f: int) -> dict:
        return groups.setdefault(
            int(f), dict(moves=[], adds=[], drops=[], n_triples=0))

    local = set(plan.local_moves)
    for m in plan.moves:
        g = group(m[0])
        g["moves"].append(m)
        if m[0] not in local:             # dst already held a copy: free
            g["n_triples"] += int(sizes[m[0]])
    for a in plan.replica_adds:
        g = group(a[0])
        g["adds"].append(a)
        if a[1] != a[2]:                  # src == dst: local, zero traffic
            g["n_triples"] += int(sizes[a[0]])
    for d in plan.replica_drops:
        group(d[0])["drops"].append(d)    # retire in place: zero traffic

    feats = np.array(sorted(groups), dtype=np.int64)
    gbytes = np.array([groups[int(f)]["n_triples"] * TRIPLE_BYTES
                       for f in feats], dtype=np.int64)
    prio = (np.zeros(len(feats)) if priority is None
            else np.asarray(priority, dtype=np.float64)[feats])
    # lexsort: last key is primary — hottest, then biggest, then feature id
    order = np.lexsort((feats, -gbytes, -prio))
    budget = max(int(bytes_budget), 1)

    chunks: List[MigrationChunk] = []
    cur: List[int] = []
    cur_bytes = 0
    for i in order.tolist():
        b = int(gbytes[i])
        if cur and cur_bytes + b > budget:
            chunks.append(_make_chunk(groups, feats, cur, local))
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += b
    chunks.append(_make_chunk(groups, feats, cur, local))
    return chunks


def _make_chunk(groups: dict, feats: np.ndarray, idxs: List[int],
                local: set) -> MigrationChunk:
    gs = [groups[int(feats[i])] for i in idxs]
    n = sum(g["n_triples"] for g in gs)
    moves = [m for g in gs for m in g["moves"]]
    return MigrationChunk(
        moves=moves, n_triples=n, bytes=n * TRIPLE_BYTES,
        replica_adds=[a for g in gs for a in g["adds"]],
        replica_drops=[d for g in gs for d in g["drops"]],
        local_moves=[m[0] for m in moves if m[0] in local])


def plan(old: PartitionState, new: PartitionState,
         old_replicas=None, new_replicas=None) -> MigrationPlan:
    """Delta between two layouts: primary moves plus — when both replica
    maps are given (``repro_torch.replicate.ReplicaMap``) — the replica adds and
    drops taking the old map (with primaries rebased onto the new layout,
    since the moves themselves carry the primary copies) to the new one.

    An op whose target shard already held a copy under the *old* map ships
    nothing: a replica add is marked ``src == dst`` (local promotion), and
    a primary move onto an existing replica is listed in ``local_moves``
    (primary re-designation only)."""
    assert len(old.feature_to_shard) == len(new.feature_to_shard), \
        "extend the old state before planning (new tracked PO features)"
    changed = np.where(old.feature_to_shard != new.feature_to_shard)[0]
    moves = [(int(f), int(old.feature_to_shard[f]), int(new.feature_to_shard[f]))
             for f in changed.tolist()]
    local_moves = ([] if old_replicas is None else
                   [f for f, _src, dst in moves if old_replicas.has(f, dst)])
    shipped = changed if old_replicas is None else \
        np.array([f for f, _s, d in moves if not old_replicas.has(f, d)],
                 dtype=np.int64)
    n_triples = int(new.feature_sizes[shipped].sum())
    out = MigrationPlan(moves=moves, n_triples=n_triples,
                        bytes=n_triples * TRIPLE_BYTES,
                        local_moves=local_moves)
    if old_replicas is None or new_replicas is None:
        return out

    one = np.uint64(1)
    rebased = old_replicas.masks.copy()
    for f, src, dst in moves:
        rebased[f] = (rebased[f] & ~(one << np.uint64(src))) \
            | (one << np.uint64(dst))
    diff = np.flatnonzero(rebased ^ new_replicas.masks)
    for f in diff.tolist():
        add_bits = int(new_replicas.masks[f] & ~rebased[f])
        drop_bits = int(rebased[f] & ~new_replicas.masks[f])
        primary = int(new.feature_to_shard[f])
        size = int(new.feature_sizes[f])
        for s in range(new.n_shards):
            if (add_bits >> s) & 1:
                local = bool((int(old_replicas.masks[f]) >> s) & 1)
                out.replica_adds.append((f, s if local else primary, s))
                if not local:
                    out.n_triples += size
                    out.bytes += size * TRIPLE_BYTES
            if (drop_bits >> s) & 1:
                out.replica_drops.append((f, s))
    return out


def extend_for_space(state: PartitionState, space,
                     ) -> Tuple[PartitionState, np.ndarray]:
    """Extend ``state`` to ``space``'s grown feature universe.

    The single place encoding the PO-split parent rule (a new PO feature
    inherits its parent P feature's shard) — both the controller's adapt
    round and the PartitionedKG facade go through it, so their extended
    states are identical by construction. New *P* features (a predicate the
    universe has never seen, born on the live write path before the owner
    of this state absorbed it) have no parent to inherit from: parent -1
    sends them to the least-loaded shard, matching the write path's own
    placement rule. Returns (state, triple owners)."""
    old_nf = len(state.feature_to_shard)
    owners = space.triple_owners()
    sizes = space.feature_sizes(owners)
    parents = []
    for i in range(old_nf, space.n_features):
        key = space.key(i)
        parents.append(space.p_index(key[1]) if key[0] == "PO" else -1)
    return extend_state(state, sizes, parents), owners


def extend_state(state: PartitionState, new_sizes: np.ndarray,
                 parent_of_new: List[int]) -> PartitionState:
    """Grow a state with newly-tracked features.

    A new PO feature's triples already live on its parent P feature's shard
    (tracking splits ownership without moving data), so it inherits that
    shard; the parent's size shrinks accordingly — handled by passing the
    re-computed ``new_sizes`` for the full (grown) feature universe. A
    parent may itself be new (a PO child of a predicate born in the same
    growth step): parents are resolved in creation order, so the child
    reads the shard its parent was just assigned. Parent ``-1`` (a new P
    feature, write path) places on the least-loaded shard."""
    f_old = len(state.feature_to_shard)
    f_new = len(new_sizes)
    assert f_new >= f_old and len(parent_of_new) == f_new - f_old
    sizes = np.asarray(new_sizes, np.int64)
    f2s = np.empty(f_new, dtype=np.int32)
    f2s[:f_old] = state.feature_to_shard
    loads = None
    for i, parent in enumerate(parent_of_new):
        if parent >= 0:
            f2s[f_old + i] = f2s[parent]
        else:
            if loads is None:
                loads = np.bincount(f2s[:f_old], weights=sizes[:f_old],
                                    minlength=state.n_shards)
            dst = int(np.argmin(loads))
            f2s[f_old + i] = dst
            loads[dst] += max(int(sizes[f_old + i]), 1)
    return PartitionState(f2s, sizes, state.n_shards)
