"""Query planner — the ``QueryPlan`` IR shared by every executor.

AWAPart's adaptation loop reasons about *plans*, not executions: the same
ordered sequence of scan/join operators is (a) executed for real by a
pluggable backend (``repro_torch.query.exec``), (b) profiled once against the
global store into a layout-invariant ``QueryProfile``, and (c) re-priced
under candidate layouts with pure bincount arithmetic — without re-deriving
join order, selectivities or the PPN each time (the duplication the old
``engine.execute`` / ``engine.profile_query`` pair carried).

``plan(q, stats_source)`` is the single entry point. ``stats_source`` is
anything holding the triples the query will run over:

* a bare :class:`~repro_torch.graph.triples.TripleStore` (no partition metadata —
  single-node plan, ``ppn = 0``),
* an ``engine.ShardedStore`` or :class:`~repro_torch.api.facade.PartitionedKG`
  (federated plan: PPN choice + per-pattern home-shard annotations).

``PartitionedKG`` caches one plan per ``(query, store)`` and invalidates the
cache when the layout changes (``commit`` / ``sync_universe``) — and when
the *graph* changes: a live write (``repro_torch.write.apply_batch``) bumps the
facade epoch too, since plan selectivities, the PPN vote, and home-shard
annotations were all derived from pre-write matches. Every cached plan
carries the epoch it was built at and asserts on a stale hit. So a whole
adaptation round builds each query's plan exactly once, and no plan ever
outlives the graph it described.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.core.migration import TRIPLE_BYTES
from repro_torch.query.pattern import Pattern, Query, is_var


def primary_shard(q: Query, space, state, replicas=None) -> int:
    """PPN selection: shard holding the highest number of the query's
    features, weighted by feature size (Sec. IV). With a
    ``repro_torch.replicate.ReplicaMap``, every shard holding a *copy* of a
    feature collects that feature's vote — the PPN prefers the shard with
    the most local copies of the plan's features (a primary-only map votes
    identically to the replica-free rule)."""
    feats = space.query_features(q)
    votes = np.zeros(state.n_shards)
    for f in feats.tolist():
        w = 1 + np.log1p(state.feature_sizes[f])
        if replicas is None:
            votes[state.feature_to_shard[f]] += w
        else:
            votes[replicas.holders(f)] += w
    return int(np.argmax(votes))


def pattern_home(pat: Pattern, space, state, replicas=None,
                 ppn: int | None = None) -> int:
    """Shard homing a pattern's feature (PO if tracked, else P); -1 means an
    unbound predicate (broadcast to every shard). When the feature is
    replicated onto the query's PPN, the PPN serves it locally — the home
    IS the PPN (no SERVICE call)."""
    s, p, o = pat
    if is_var(p):
        return -1
    f = None
    if not is_var(o):
        f = space.po_index(p, o)
    if f is None:
        f = space.p_index(p)
    if replicas is not None and ppn is not None and replicas.has(f, ppn):
        return int(ppn)
    return int(state.feature_to_shard[f])


# --------------------------------------------------------------------------- #
# the IR
# --------------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class PlanOp:
    """One scan+join step: match ``pattern`` on every shard, hash-join the
    result into the binding table on ``join_vars``."""
    pattern: Pattern
    est_rows: int                  # global match count (selectivity estimate)
    selectivity: float             # est_rows / total triples
    join_vars: Tuple[int, ...]     # vars shared with the table built so far
    new_vars: Tuple[int, ...]      # vars first bound by this op
    cartesian: bool                # no shared vars: cross product (capped)
    home: int                      # federation annotation: feature-home shard
    service: bool                  # True when home is off-PPN (SERVICE call)


@dataclasses.dataclass(frozen=True)
class QueryPlan:
    """Ordered scan/join ops + PPN choice + federation annotations for one
    BGP over one store. Executors consume this IR; they never re-derive it."""
    query: Query
    ops: Tuple[PlanOp, ...]
    ppn: int
    n_shards: int
    total_triples: int

    @property
    def n_patterns(self) -> int:
        return len(self.query.patterns)

    def explain(self) -> str:
        """Human-readable plan, EXPLAIN-style."""
        lines = [f"QueryPlan {self.query.name}: {len(self.ops)} ops, "
                 f"ppn=shard{self.ppn}/{self.n_shards}"]
        for i, op in enumerate(self.ops):
            kind = ("scan" if i == 0
                    else "cartesian" if op.cartesian
                    else f"hash-join on {list(op.join_vars)}")
            where = ("broadcast" if op.home < 0
                     else "local" if not op.service
                     else f"SERVICE shard{op.home}")
            lines.append(f"  [{i}] {op.pattern} {kind} "
                         f"~{op.est_rows} rows "
                         f"(sel={op.selectivity:.2e}) {where}")
        return "\n".join(lines)


def _resolve_source(stats_source) -> Tuple[object, object, object, object]:
    """(store, space, state, replicas) from any supported stats source."""
    store = getattr(stats_source, "store", stats_source)
    space = getattr(stats_source, "space", None)
    state = getattr(stats_source, "state", None)
    replicas = getattr(stats_source, "replicas", None)
    return store, space, state, replicas


def _join_order(patterns: Sequence[Pattern],
                counts: Dict[Pattern, int]) -> List[Pattern]:
    """Greedy join order: most selective first, staying connected."""
    remaining = list(patterns)
    bound_vars: set = set()
    order: List[Pattern] = []
    while remaining:
        connected = [p for p in remaining
                     if any(is_var(s) and s in bound_vars for s in p)]
        pool = connected if connected and bound_vars else remaining
        pick = min(pool, key=lambda p: counts[p])
        order.append(pick)
        remaining.remove(pick)
        bound_vars.update(s for s in pick if is_var(s))
    return order


def plan(q: Query, stats_source) -> QueryPlan:
    """Build the execution plan for ``q`` against ``stats_source``."""
    store, space, state, replicas = _resolve_source(stats_source)
    counts = {pat: store.count(None if is_var(pat[0]) else pat[0],
                               None if is_var(pat[1]) else pat[1],
                               None if is_var(pat[2]) else pat[2])
              for pat in q.patterns}
    order = _join_order(q.patterns, counts)
    federated = space is not None and state is not None
    ppn = primary_shard(q, space, state, replicas) if federated else 0
    n_shards = state.n_shards if federated else 1
    total = max(store.n_triples, 1)

    ops: List[PlanOp] = []
    bound: set = set()
    for i, pat in enumerate(order):
        pat_vars = [s for s in pat if is_var(s)]
        join_vars = tuple(dict.fromkeys(v for v in pat_vars if v in bound))
        new_vars = tuple(dict.fromkeys(v for v in pat_vars if v not in bound))
        home = (pattern_home(pat, space, state, replicas, ppn)
                if federated else 0)
        ops.append(PlanOp(pattern=pat, est_rows=counts[pat],
                          selectivity=counts[pat] / total,
                          join_vars=join_vars, new_vars=new_vars,
                          cartesian=i > 0 and not join_vars,
                          home=home,
                          service=federated and home not in (ppn, -1)))
        bound.update(pat_vars)
    return QueryPlan(query=q, ops=tuple(ops), ppn=ppn, n_shards=n_shards,
                     total_triples=store.n_triples)


# --------------------------------------------------------------------------- #
# layout-invariant profiles — a derived artifact of the plan
# --------------------------------------------------------------------------- #

@dataclasses.dataclass
class QueryProfile:
    """Everything about a plan's execution that does NOT depend on the
    partition layout: each executed op's matched global row ids, the
    join-pipeline row counts, and the result cardinality.

    Join results are a property of the *global* triple set — shards only
    change where matches live, i.e. the federation accounting. A profile is
    derived once per plan (one real execution worth of work against the
    global store, see ``exec.profile_from_plan``) and then prices any
    candidate ``PartitionState`` with pure bincount arithmetic via
    :func:`stats_from_profile`.

    Layout-invariant is not *write*-invariant: ``pattern_rows`` holds
    global row ids, which a ``repro_torch.write`` mutation remaps (deletes
    compact the store, inserts append). The facade therefore tags cached
    profiles with its ``data_version`` and drops them on every effective
    write — a profile never prices a graph other than the one it was
    profiled on."""
    pattern_rows: List[np.ndarray]     # global row ids per executed op
    join_rows: int
    rows: int
    n_patterns: int                    # len(q.patterns), for dj accounting
    cartesian_rows: int = 0            # cross-product rows materialized
    expanded_rows: int = 0             # ragged hash-join pairs materialized


def stats_from_profile(q: Query, prof: QueryProfile, space, state,
                       triple_shard: np.ndarray, replicas=None,
                       owners: np.ndarray | None = None):
    """Re-account a profiled query under a candidate layout.

    Reproduces the executors' federation statistics exactly — same PPN rule,
    same per-shard scan/shipping arithmetic — without re-running any joins.
    ``triple_shard`` maps every global triple row to its candidate
    (primary) shard. With a ``repro_torch.replicate.ReplicaMap`` (and the
    per-triple ``owners`` features), shipping is charged against the
    *nearest replica*: matches whose owner feature holds a copy on the PPN
    are scanned there — local, nothing shipped — and only copy-less
    matches ship from their primary."""
    from repro_torch.query.exec import ExecStats
    stats = ExecStats(join_rows=prof.join_rows, rows=prof.rows,
                      cartesian_rows=prof.cartesian_rows,
                      expanded_rows=prof.expanded_rows)
    ppn = primary_shard(q, space, state, replicas)
    on_ppn = (replicas.on_shard(ppn)
              if replicas is not None and owners is not None
              and replicas.has_replicas else None)
    multi = prof.n_patterns > 1
    for idx in prof.pattern_rows:
        shard_ids = triple_shard[idx]
        if on_ppn is not None and len(idx):
            shard_ids = np.where(on_ppn[owners[idx]], np.int32(ppn),
                                 shard_ids)
        per_shard = np.bincount(shard_ids, minlength=state.n_shards)
        stats.scan_rows_critical += int(per_shard.max()) if len(idx) else 0
        off = per_shard.copy()
        off[ppn] = 0
        nz = int((off > 0).sum())
        shipped = int(off.sum())
        stats.messages += nz
        stats.rows_shipped += shipped
        stats.bytes_shipped += shipped * TRIPLE_BYTES
        if multi:
            stats.distributed_joins += nz
    return stats
