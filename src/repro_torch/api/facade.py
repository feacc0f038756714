"""PartitionedKG — the partitioned-knowledge-graph facade.

Owns the global ``TripleStore``, the ``FeatureSpace`` and the current
``PartitionState``, and materializes per-shard ``TripleStore`` views **once**.
Thereafter every layout change arrives as a ``MigrationPlan``-shaped delta
(a candidate ``PartitionState`` over the same feature universe) and only the
shards actually touched by moved features are re-indexed; untouched shard
views are reused as-is.

The facade is also the plan cache: ``kg.plan(q)`` builds the
``repro_torch.query.plan.QueryPlan`` IR once per ``(query, store)`` and serves it
to every executor until the layout changes (``commit`` / ``sync_universe``
invalidate, because the PPN choice and federation annotations are
layout-dependent). Layout-invariant ``QueryProfile``s are derived from the
plan and cached separately — they survive commits, which is what makes
candidate evaluation (``measure_candidate``) pure bincount re-accounting
with no joins re-executed and no views touched.

Beside the primary assignment the facade carries a
``repro_torch.replicate.ReplicaMap``: shard views additionally materialize any
read copies pinned onto them, ``read_shard(ppn)`` resolves every triple's
serving shard for a query (nearest replica: the PPN when a local copy
exists, else the primary), and replica promotions/demotions arrive through
the same ``MigrationChunk`` deltas as moves. An epoch-keyed result cache
(``cached_result``/``store_result``) sits beside the plan cache so repeated
``(query, epoch)`` pairs in hot TM windows skip re-execution entirely.

Live mutation arrives through ``apply_write`` (``repro_torch.write``): writes are
routed by the primary assignment, fanned out to replica holders, re-index
only the touched shard views, and bump both the epoch and a separate
``data_version`` — the invalidation key for the profiles, which survive
layout changes but not graph changes. Every cache entry carries the
epoch/version it was built at and serving asserts the tag, so a mutating
path that forgets to invalidate fails loudly instead of serving stale
results.

The object is duck-compatible with ``repro_torch.query.engine.ShardedStore``
(``.space`` / ``.state`` / ``.shards`` / ``.store`` / ``.triple_shard``), so
any ``Executor`` runs against it unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import migration
from repro_torch.core.features import FeatureSpace
from repro_torch.core.partition import PartitionState
from repro_torch.graph.triples import TripleStore
from repro_torch.obs.metrics import NULL_METRICS
from repro_torch.query import exec as qexec
from repro_torch.query import plan as qplan
from repro_torch.query.pattern import Query
from repro_torch.replicate import ReplicaMap


class PartitionedKG:
    """Per-shard views of a feature-partitioned KG with incremental updates."""

    def __init__(self, store: TripleStore, space: FeatureSpace,
                 state: PartitionState, owners: np.ndarray | None = None,
                 max_join_rows: int = qexec.DEFAULT_MAX_JOIN_ROWS,
                 replicas: ReplicaMap | None = None,
                 metrics=None):
        self.store = store
        self.space = space
        self.state = state
        # repro_torch.obs registry (the owning KGService's); inert by default so
        # facades built directly — tests, rebuild twins — need no checks
        self.metrics = metrics if metrics is not None else NULL_METRICS
        # profiling honors the serving executor's cartesian-join cap
        self.max_join_rows = max_join_rows
        self.owners = space.triple_owners() if owners is None else owners
        self._triple_shard = state.triple_shards(self.owners).astype(np.int32)
        self._rows: List[np.ndarray] = [
            np.flatnonzero(self._triple_shard == s)
            for s in range(state.n_shards)]
        self._views: List[Optional[TripleStore]] = [None] * state.n_shards
        self.view_rebuilds = 0         # telemetry: shard views (re)built
        # layout epoch: bumped whenever the served layout actually changes
        # (a delta that moves features or replicas, or universe growth).
        # Cached plans/results are valid for exactly one epoch; a
        # mid-migration hybrid layout is a first-class epoch like any other.
        self.epoch = 0
        # data version: bumped by every effective write (repro_torch.write) — the
        # invalidation key for caches that survive layout epochs but NOT
        # graph mutations (the layout-invariant profiles below)
        self.data_version = 0
        # query plans, cached per (query, store) until the layout changes;
        # keyed by query name (+ patterns, so a re-defined query under the
        # same name is re-planned). Entries are tagged with the epoch they
        # were built at; serving asserts the tag — any mutating path that
        # forgot to bump the epoch before a cached entry is served trips an
        # assertion instead of returning stale federation annotations.
        self._plans: Dict[str, Tuple[tuple, qplan.QueryPlan, int]] = {}
        self.plan_builds = 0           # telemetry: plans built / cache hits
        self.plan_hits = 0
        # epoch-keyed result cache beside the plan cache: bindings+stats of
        # repeated (query, epoch) pairs in hot TM windows are served without
        # re-execution; invalidated together with the plans on epoch bumps
        # (entries carry their epoch under the same stale-serving assert)
        self._results: Dict[str, Tuple[tuple, dict, qexec.ExecStats,
                                       int]] = {}
        self.result_hits = 0
        # layout-invariant query profiles (derived from plans; survive
        # commits — join results don't depend on the layout, but they DO
        # depend on the triples: entries are tagged with the data version)
        self._profiles: Dict[str, Tuple[tuple, qplan.QueryProfile, int]] = {}
        # read replication (repro_torch.replicate): which shards hold a copy of
        # each feature; the primary assignment above stays authoritative
        self.replicas = replicas or ReplicaMap.primary_only(state)
        assert self.replicas.n_features == len(state.feature_to_shard)
        self._replica_rows: List[np.ndarray] = [
            np.empty(0, np.int64)] * state.n_shards
        self._shard_rows: List[Optional[np.ndarray]] = [None] * state.n_shards
        self._read_cache: Dict[int, np.ndarray] = {}   # ppn -> read shards
        self._rebuild_feature_index()
        if self.replicas.has_replicas:
            for s in range(state.n_shards):
                self._refresh_replica_rows(s, state.feature_to_shard)

    # ------------------------------------------------------------------ #
    # executor compatibility
    # ------------------------------------------------------------------ #
    @property
    def n_shards(self) -> int:
        return self.state.n_shards

    @property
    def triple_shard(self) -> np.ndarray:
        """Current shard of every global triple row, (N,) int32."""
        return self._triple_shard

    @property
    def shards(self) -> List[TripleStore]:
        """Materialized per-shard views (lazily built, cached until a delta
        touches the shard). A shard's view holds its primary slice plus any
        replica copies pinned onto it (``self.replicas``)."""
        for s in range(self.state.n_shards):
            if self._views[s] is None:
                self._views[s] = TripleStore(
                    self.store.triples[self.shard_rows(s)],
                    self.store.dictionary)
                self.view_rebuilds += 1
                self.metrics.counter("cache.view_rebuilds").inc()
        return list(self._views)

    def shard_rows(self, s: int) -> np.ndarray:
        """Global triple rows materialized on shard ``s`` — primary rows
        first, then replica-copy rows. ``shards[s]`` view row ``i`` is
        global row ``shard_rows(s)[i]``."""
        if self._shard_rows[s] is None:
            rep = self._replica_rows[s]
            self._shard_rows[s] = (self._rows[s] if len(rep) == 0 else
                                   np.concatenate([self._rows[s], rep]))
        return self._shard_rows[s]

    def shard_sizes(self) -> List[int]:
        """Primary (owned) triples per shard — replica copies not counted;
        this is the balance quantity the partitioner optimizes."""
        return [len(r) for r in self._rows]

    # ------------------------------------------------------------------ #
    # replica-aware read layout
    # ------------------------------------------------------------------ #
    def read_shard(self, ppn: int) -> np.ndarray:
        """Per-triple serving shard for a query homed at ``ppn``: the PPN
        itself when the triple's owner feature holds a copy there (local
        read — nothing shipped), else the primary. Cached per PPN for the
        current epoch."""
        cached = self._read_cache.get(ppn)
        if cached is None:
            on = self.replicas.on_shard(ppn)
            cached = np.where(on[self.owners], np.int32(ppn),
                              self._triple_shard)
            self._read_cache[ppn] = cached
            # replica-served volume: triples a query homed at this PPN
            # reads from local copies instead of shipping (vs. the
            # federation.bytes_shipped counter's actual wire traffic)
            local = int(np.count_nonzero((cached == ppn)
                                         & (self._triple_shard != ppn)))
            self.metrics.gauge(
                f"replicate.local_read_rows.ppn{ppn}").set(local)
        return cached

    def _refresh_replica_rows(self, s: int,
                              feature_to_shard: np.ndarray) -> bool:
        """Recompute shard ``s``'s replica-copy rows (owner features holding
        a copy on ``s`` whose primary is elsewhere). Returns True when the
        set changed (the shard's view must be re-materialized)."""
        on = self.replicas.on_shard(s)
        on[feature_to_shard == s] = False
        rows = self._rows_of(np.flatnonzero(on))
        changed = not np.array_equal(rows, self._replica_rows[s])
        self._replica_rows[s] = rows
        if changed:
            self._views[s] = None
            self._shard_rows[s] = None
        return changed

    def _invalidate_caches(self) -> None:
        """Epoch-scoped caches: plans, results and read layouts are valid
        for exactly one served layout."""
        self._plans.clear()
        self._results.clear()
        self._read_cache.clear()

    # ------------------------------------------------------------------ #
    # owner-feature row index (CSR over triples grouped by owner feature)
    # ------------------------------------------------------------------ #
    def _rebuild_feature_index(self) -> None:
        order = np.argsort(self.owners, kind="stable").astype(np.int64)
        nf = len(self.state.feature_to_shard)
        self._feat_order = order
        self._feat_starts = np.searchsorted(
            self.owners[order], np.arange(nf + 1))

    def _rows_of(self, feats: np.ndarray) -> np.ndarray:
        parts = [self._feat_order[self._feat_starts[f]:self._feat_starts[f + 1]]
                 for f in feats.tolist()]
        return (np.concatenate(parts) if parts
                else np.empty(0, dtype=np.int64))

    # ------------------------------------------------------------------ #
    # feature-universe growth (adaptive PO-split tracking)
    # ------------------------------------------------------------------ #
    def sync_universe(self) -> None:
        """Absorb newly-tracked PO features from the FeatureSpace.

        A split PO feature's triples stay on the parent's shard (ownership
        split, no data movement), so the triple->shard mapping — and every
        shard view — is unchanged; only owners/sizes/state are re-derived.
        Cached plans are invalidated: feature sizes feed the PPN vote."""
        if self.space.n_features == len(self.state.feature_to_shard):
            return
        self.state, self.owners = migration.extend_for_space(self.state,
                                                             self.space)
        self.epoch += 1
        self._invalidate_caches()
        self._rebuild_feature_index()
        # new (split) PO features start primary-only; a split parent's
        # replica copies keep only the rows the parent still owns
        self.replicas.extend(self.state.feature_to_shard)
        if self.replicas.has_replicas:
            for s in range(self.state.n_shards):
                self._refresh_replica_rows(s, self.state.feature_to_shard)

    # ------------------------------------------------------------------ #
    # incremental deltas
    # ------------------------------------------------------------------ #
    def _apply(self, new_state: PartitionState,
               replica_adds: Sequence[Tuple[int, int, int]] = (),
               replica_drops: Sequence[Tuple[int, int]] = ()) -> None:
        assert len(new_state.feature_to_shard) == \
            len(self.state.feature_to_shard), \
            "sync_universe() before applying a delta over a grown universe"
        changed = np.flatnonzero(
            self.state.feature_to_shard != new_state.feature_to_shard)
        # replica ops first (drops, then — after the moves below — adds),
        # tracking which shards' copy sets actually change
        rep_touched: set = set()
        dropped = 0
        for f, s in replica_drops:
            if int(new_state.feature_to_shard[f]) != s \
                    and self.replicas.has(f, s):
                self.replicas.remove(f, s)
                rep_touched.add(s)
                dropped += 1
        # an add is effective unless the target IS the feature's new primary
        # or will still hold a copy after the moves below run: a retained
        # copy at a moving feature's OLD primary is effective (the move
        # clears that bit), an add onto any other existing copy is not.
        # One predicate drives both no-op detection and application.
        moving = set(changed.tolist())

        def _add_effective(f: int, dst: int) -> bool:
            if int(new_state.feature_to_shard[f]) == dst:
                return False
            if f in moving and dst == int(self.state.feature_to_shard[f]):
                return True
            return not self.replicas.has(f, dst)

        effective_adds = [(f, dst) for f, _src, dst in replica_adds
                          if _add_effective(f, dst)]
        if len(changed) == 0 and not rep_touched and not effective_adds:
            self.state = new_state         # no-op delta: the served layout is
            return                         # unchanged — keep plans/views/epoch
        rows = self._rows_of(changed)
        old_shards = self._triple_shard[rows]
        new_shards = new_state.feature_to_shard[self.owners[rows]] \
            .astype(np.int32)
        touched = (np.unique(np.concatenate([old_shards, new_shards])).tolist()
                   if len(rows) else [])
        for f in changed.tolist():         # the move carries the primary copy
            self.replicas.move_primary(
                f, int(self.state.feature_to_shard[f]),
                int(new_state.feature_to_shard[f]))
        for f, dst in effective_adds:      # after the moves, so a retained
            self.replicas.add(f, dst)      # old-primary copy sticks
            rep_touched.add(dst)
        self._triple_shard[rows] = new_shards
        for s in set(touched) | rep_touched:
            if s in touched:
                self._rows[s] = np.flatnonzero(self._triple_shard == s)
                self._views[s] = None      # re-indexed lazily on next access
                self._shard_rows[s] = None
            self._refresh_replica_rows(s, new_state.feature_to_shard)
        self.state = new_state
        self.epoch += 1
        self._invalidate_caches()          # PPN/federation annotations changed
        m = self.metrics
        m.counter("migrate.features_moved").inc(len(changed))
        m.counter("replicate.promotions").inc(len(effective_adds))
        m.counter("replicate.demotions").inc(dropped)
        m.gauge("layout.epoch").set(self.epoch)

    def apply_chunk(self, chunk: migration.MigrationChunk) -> None:
        """Apply one ``MigrationChunk`` of an in-flight migration as an
        incremental delta. The resulting partially-migrated layout is served
        as-is (a new epoch): only shards touched by the chunk's moves and
        replica ops are re-indexed, and cached plans/results are invalidated
        because the PPN vote and federation annotations may have shifted.

        The delta is derived from the **live** state, so a chunk moving a
        feature whose triples changed since the session was planned (live
        writes, ``apply_write``) carries the post-write rows — the row set
        shipped is whatever the owner feature holds *now*."""
        state = self.state.copy()
        for f, _src, dst in chunk.moves:
            state.feature_to_shard[f] = dst
        self._apply(state, getattr(chunk, "replica_adds", ()),
                    getattr(chunk, "replica_drops", ()))

    # ------------------------------------------------------------------ #
    # live writes (repro_torch.write)
    # ------------------------------------------------------------------ #
    def apply_write(self, batch) -> "object":
        """Apply a ``repro_torch.write.WriteBatch`` to the served graph: effective
        rows are routed by the current primary assignment of their owner
        feature, fanned out to every ``ReplicaMap`` holder, and only the
        touched shard views are re-indexed. An effective write is a new
        epoch AND a new data version (plans, results and layout-invariant
        profiles all invalidate); a fully-redundant batch changes nothing.
        Returns the ``repro_torch.write.WriteReport``."""
        from repro_torch import write as kgwrite
        return kgwrite.apply_batch(self, batch)

    # ------------------------------------------------------------------ #
    # plans, profiles, candidate pricing
    # ------------------------------------------------------------------ #
    def plan(self, q: Query) -> qplan.QueryPlan:
        """The query's execution plan under the current layout (cached per
        ``(query, store)``; invalidated by ``commit``/``sync_universe``/
        ``apply_write``)."""
        pats = tuple(q.patterns)
        entry = self._plans.get(q.name)
        if entry is None or entry[0] != pats:
            entry = (pats, qplan.plan(q, self), self.epoch)
            self._plans[q.name] = entry
            self.plan_builds += 1
            self.metrics.counter("cache.plan_builds").inc()
        else:
            assert entry[2] == self.epoch, \
                f"stale plan served for {q.name}: cached at epoch " \
                f"{entry[2]}, layout is at {self.epoch} — a mutating path " \
                "bumped the epoch without invalidating"
            self.plan_hits += 1
            self.metrics.counter("cache.plan_hits").inc()
        return entry[1]

    def profile(self, q: Query) -> qplan.QueryProfile:
        """Layout-invariant execution profile of ``q``, derived from its plan
        (cached; one real execution against the global store on first use).
        Survives layout epochs but not writes — profiles hold global row
        ids of the triples the query matched."""
        pats = tuple(q.patterns)
        entry = self._profiles.get(q.name)
        if entry is None or entry[0] != pats:
            entry = (pats, qexec.profile_from_plan(self.plan(q), self.store,
                                                   self.max_join_rows),
                     self.data_version)
            self._profiles[q.name] = entry
        else:
            assert entry[2] == self.data_version, \
                f"stale profile served for {q.name}: cached at data " \
                f"version {entry[2]}, store is at {self.data_version} — a " \
                "write path skipped profile invalidation"
        return entry[1]

    def cached_result(self, q: Query,
                      ) -> Optional[Tuple[dict, qexec.ExecStats]]:
        """Bindings+stats of ``q`` if already executed at the current epoch
        (bindings are layout-invariant under moves/replication — NOT under
        writes, which bump the epoch too; stats are valid per epoch). None
        on a miss — the caller executes and ``store_result``s. Binding
        columns and the stats are copied both into and out of the cache, so
        callers mutating their result (or the original executor objects)
        can never corrupt a later hit — a memcpy per column, still far
        below a re-execution."""
        entry = self._results.get(q.name)
        if entry is not None and entry[0] == tuple(q.patterns):
            assert entry[3] == self.epoch, \
                f"stale result served for {q.name}: cached at epoch " \
                f"{entry[3]}, layout is at {self.epoch} — a mutating path " \
                "bumped the epoch without invalidating"
            self.result_hits += 1
            self.metrics.counter("cache.result_hits").inc()
            return ({v: c.copy() for v, c in entry[1].items()},
                    dataclasses.replace(entry[2]))
        return None

    def store_result(self, q: Query, bindings: dict,
                     stats: qexec.ExecStats) -> None:
        self._results[q.name] = (tuple(q.patterns),
                                 {v: c.copy() for v, c in bindings.items()},
                                 dataclasses.replace(stats), self.epoch)

    def measure_candidate(self, cand: PartitionState,
                          queries: Sequence[Query], net=None,
                          replicas=None) -> float:
        """Average modeled workload time under ``cand`` — pure federation
        re-accounting over cached query profiles. No joins are re-executed,
        no shard view is touched: only the candidate's triple->shard map is
        derived (one gather) and each profiled pattern re-priced. With a
        candidate ``ReplicaMap``, shipping is charged against the nearest
        replica (``stats_from_profile``) — how replica-served savings enter
        the adaptation guard's benefit side."""
        self.sync_universe()
        triple_shard = cand.feature_to_shard[self.owners].astype(np.int32)
        net = net or qexec.NetworkModel()
        num = den = 0.0
        for q in queries:
            st = qplan.stats_from_profile(q, self.profile(q), self.space,
                                          cand, triple_shard,
                                          replicas=replicas,
                                          owners=self.owners)
            num += st.modeled_time(net) * q.frequency
            den += q.frequency
        return num / max(den, 1e-12)

    def commit(self, new_state: PartitionState) -> migration.MigrationPlan:
        """Adopt ``new_state``; returns the migration delta that was applied.
        Only shards touched by moved features are re-indexed."""
        self.sync_universe()
        plan = migration.plan(self.state, new_state)
        self._apply(new_state)
        return plan

    # ------------------------------------------------------------------ #
    def imbalance(self) -> float:
        return self.state.imbalance()

    def telemetry(self) -> dict:
        """Serving-counter snapshot — layout identity plus the cache/view
        telemetry the facade accumulates. Folded into ``KGService.stats()``
        next to the streaming layer's latency aggregates."""
        return dict(epoch=self.epoch, data_version=self.data_version,
                    n_triples=self.store.n_triples, n_shards=self.n_shards,
                    n_features=len(self.state.feature_to_shard),
                    n_replicated=len(self.replicas.replicated()),
                    imbalance=self.imbalance(),
                    plan_builds=self.plan_builds, plan_hits=self.plan_hits,
                    result_hits=self.result_hits,
                    view_rebuilds=self.view_rebuilds)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"PartitionedKG(n_triples={self.store.n_triples}, "
                f"n_shards={self.n_shards}, "
                f"n_features={len(self.state.feature_to_shard)}, "
                f"n_replicated={len(self.replicas.replicated())}, "
                f"epoch={self.epoch})")
