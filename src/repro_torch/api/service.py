"""KGService — the master-node session API (paper Fig. 6).

One object owns the whole serving loop: bootstrap a partition with any
``Partitioner`` strategy, execute federated queries through a pluggable
``Executor`` backend, monitor per-query runtimes (TM), and — for adaptive
strategies — trigger/apply the Fig.-5 adaptation. Drivers, examples,
benchmarks, and tests orchestrate through this facade only; controller
internals are never reached into.

    svc = KGService.from_dataset(ds, n_shards=8,       # on the card
                                 migration_budget=1 << 20)   # 1 MB per step
    kg = svc.bootstrap(ds.base_workload())
    bindings, stats = svc.query(ds.queries["Q9"])
    results = svc.query_batch(window)        # one dispatched batch per window
    svc.insert(new_triples)                  # live writes, served next epoch
    svc.delete(old_triples)                  # (safe mid-drain, fanned out
    report = svc.maybe_adapt(new_queries)    #  to replica holders)
    svc.step()                               # apply one migration chunk
    svc.drain()                              # or finish the whole drain

Every query is planned once per ``(query, store)`` (the ``PartitionedKG``
plan cache) and executed by the configured backend: ``executor="torch"``
(default; batched, a whole TM window executes as one batch on ``device``)
or ``"numpy"`` (reference semantics on the host). An ``Executor`` instance
plugs in too.

``device`` (default ``"cuda"``) is where the torch executor's joins and
the adaptive controller's Jaccard matrix run: the hand-written Hopper
kernels on the card, their plain PyTorch versions with ``device="cpu"``.
Asking for ``"cuda"`` with no CUDA device present raises.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import write as kgwrite
from repro_torch.core.adaptive import AdaptConfig, AdaptReport, AWAPartController
from repro_torch.core.features import FeatureSpace
from repro_torch.core.migration import TRIPLE_BYTES, MigrationChunk
from repro_torch.graph.triples import TripleStore
from repro_torch.kernels import dispatch
from repro_torch.migrate import MigrationSession
from repro_torch.obs import NULL_TRACER, MetricsRegistry, Tracer, set_ambient
from repro_torch.query import exec as qexec
from repro_torch.query.pattern import Query

from repro_torch.api.facade import PartitionedKG
from repro_torch.api.partitioners import AWAPartitioner, Partitioner


class KGService:
    """Session facade over store + feature space + partitioner + shard views.

    ``migration_budget`` (bytes) throttles how an accepted adaptation is
    applied: ``None`` (default) drains the whole ``MigrationPlan`` inside
    ``adapt()`` — the old atomic commit — while a byte budget turns the
    round into a pending :class:`MigrationSession` whose chunks are applied
    one per ``query_batch`` window (or explicitly via ``step()``/``drain()``),
    so adaptation becomes a background process with bounded per-window cost
    instead of a latency cliff.

    ``replica_budget`` (bytes) enables workload-aware read replication
    (``repro_torch.replicate``): each adaptation round promotes the hottest
    features onto the shards that read them remotely — up to this many
    bytes of extra copies — and demotes replicas that fell cold. Copy
    traffic drains through the same migration sessions as moves."""

    def __init__(self, store: TripleStore, n_shards: int,
                 partitioner: Partitioner | None = None, *,
                 type_predicate: int | None = None,
                 config: AdaptConfig | None = None,
                 executor: "str | qexec.Executor | None" = None,
                 net: qexec.NetworkModel | None = None,
                 migration_budget: int | None = None,
                 replica_budget: int | None = None,
                 trace: "bool | Tracer" = False,
                 device="cuda"):
        self.device = dispatch.resolve_device(device)
        self.store = store
        self.n_shards = n_shards
        self.partitioner = partitioner or AWAPartitioner(config)
        self.space = FeatureSpace(store, type_predicate=type_predicate)
        self.executor = qexec.get_executor(executor, device=self.device)
        self.net = net
        self.migration_budget = migration_budget
        self.replica_budget = replica_budget
        if replica_budget is not None:
            # thread the knob into the adaptive strategy's config — on a
            # copy, never mutating a caller-owned AdaptConfig in place
            if not hasattr(self.partitioner, "adapt"):
                warnings.warn(
                    f"replica_budget has no effect: partitioner "
                    f"'{self.partitioner.name}' never runs an adaptation "
                    "round (replicas are promoted per round)", stacklevel=2)
            else:
                cfg = self.partitioner.config or AdaptConfig()
                self.partitioner.config = dataclasses.replace(
                    cfg, replica_budget=int(replica_budget))
        self.kg: Optional[PartitionedKG] = None
        self.session: Optional[MigrationSession] = None   # in-flight drain
        self._times: Dict[str, List[float]] = {}   # TM for non-adaptive runs
        self.write_log = kgwrite.WriteLog()        # applied-mutation history
        self._stream_recorder = None   # LatencyRecorder of the live stream
        # observability (repro_torch.obs): one registry per service, always on
        # (counters are cheap); span tracing only when asked for. The
        # registry doubles as the ambient sink for kernel-dispatch tier
        # counters, which have no service handle.
        self.metrics = MetricsRegistry()
        set_ambient(self.metrics)
        if trace is True:
            self._tracer = Tracer()
        elif trace:
            self._tracer = trace            # caller-owned Tracer instance
        else:
            self._tracer = NULL_TRACER

    @classmethod
    def from_dataset(cls, ds, n_shards: int,
                     partitioner: Partitioner | None = None,
                     **kwargs) -> "KGService":
        """Build from a dataset exposing ``.store`` and ``.dictionary``
        (e.g. ``repro_torch.graph.lubm.load``)."""
        return cls(ds.store, n_shards, partitioner,
                   type_predicate=ds.dictionary.lookup("rdf:type"), **kwargs)

    # ------------------------------------------------------------------ #
    @property
    def controller(self) -> Optional[AWAPartController]:
        """The adaptive control plane, if the strategy has one."""
        return getattr(self.partitioner, "controller", None)

    def bootstrap(self, workload: Sequence[Query] = ()) -> PartitionedKG:
        """Partition with the configured strategy and materialize the shard
        views (once — all later layout changes are incremental deltas)."""
        state = self.partitioner.partition(self.space, self.n_shards,
                                           list(workload), device=self.device)
        self.kg = PartitionedKG(
            self.store, self.space, state,
            max_join_rows=getattr(self.executor, "max_join_rows",
                                  qexec.DEFAULT_MAX_JOIN_ROWS),
            metrics=self.metrics)
        self.metrics.gauge("join.expand_cap").set(self.kg.max_join_rows)
        return self.kg

    # ------------------------------------------------------------------ #
    # serving + monitoring (TM)
    # ------------------------------------------------------------------ #
    def query(self, q: Query) -> Tuple[Dict[int, np.ndarray],
                                       qexec.ExecStats]:
        """Execute one federated query and record its runtime. A repeat of
        the same query at the same layout epoch is served from the facade's
        result cache without re-execution."""
        assert self.kg is not None, "bootstrap() first"
        hit = self.kg.cached_result(q)
        cached = hit is not None
        built0 = self.kg.plan_builds
        if hit is None:
            hit = self.executor.run(self.kg.plan(q), self.kg)
            self.kg.store_result(q, *hit)
        bindings, stats = hit
        self.observe(q, stats.modeled_time(self.net))
        self._note_query(q, stats, cached,
                         plan_built=self.kg.plan_builds > built0)
        return bindings, stats

    def query_batch(self, queries: Sequence[Query],
                    ) -> List[Tuple[Dict[int, np.ndarray], qexec.ExecStats]]:
        """Execute a whole window of queries as one backend batch (a single
        batch on the torch executor) and record every runtime.
        Queries already executed at the current layout epoch are served from
        the result cache; only the misses reach the backend.

        When a throttled migration is in flight, one chunk is applied ahead
        of the window — the window pays a bounded migration stall (at most
        ``migration_budget`` bytes of traffic) and then serves the updated
        hybrid layout, so the hottest features arrive earliest."""
        self.step()
        return self.serve_window(queries)[0]

    def serve_window(self, queries: Sequence[Query],
                     ) -> Tuple[List[Tuple[Dict[int, np.ndarray],
                                           qexec.ExecStats]], List[int]]:
        """The execution half of :meth:`query_batch`: serve one window at
        the *current* layout — cache check, one ``run_batch`` over the
        misses, TM observation — with no migration step. This is the seam
        the streaming loop (``repro_torch.stream``) pumps windows through after
        interleaving its own writes/chunks; returns ``(results, miss)``
        where ``miss`` indexes the queries that actually reached the
        backend (the rest were epoch-valid result-cache hits)."""
        assert self.kg is not None, "bootstrap() first"
        results = [self.kg.cached_result(q) for q in queries]
        miss = [i for i, r in enumerate(results) if r is None]
        built = set()
        if miss:
            plans = []
            for i in miss:
                builds0 = self.kg.plan_builds
                plans.append(self.kg.plan(queries[i]))
                if self.kg.plan_builds > builds0:
                    built.add(i)
            for i, res in zip(miss, self.executor.run_batch(plans, self.kg)):
                results[i] = res
                self.kg.store_result(queries[i], *res)
        for q, (_, stats) in zip(queries, results):
            self.observe(q, stats.modeled_time(self.net))
        missed = set(miss)
        tr = self._tracer
        if tr.enabled:
            with tr.span("window", cat="serve", n=len(queries),
                         misses=len(miss), epoch=self.kg.epoch):
                for i, (q, (_, stats)) in enumerate(zip(queries, results)):
                    self._note_query(q, stats, cached=i not in missed,
                                     plan_built=i in built)
        else:
            for i, (q, (_, stats)) in enumerate(zip(queries, results)):
                self._note_query(q, stats, cached=i not in missed,
                                 plan_built=i in built)
        return results, miss

    def _note_query(self, q: Query, stats: qexec.ExecStats, cached: bool,
                    plan_built: bool) -> None:
        """Per-query observability: registry counters always; when tracing,
        one ``query`` span decomposed into plan→scan→join→federate→ship
        children whose durations are exactly the ``NetworkModel`` terms of
        ``stats.modeled_time`` — so the spans are emitted from plan+stats
        at the service layer and their *structure* is identical across
        executor backends (ExecStats.COMPARABLE is pinned by tests)."""
        net = self.net or qexec.NetworkModel()
        m = self.metrics
        m.counter("queries.served").inc()
        if cached:
            m.counter("queries.result_cache_hits").inc()
        else:
            m.counter("federation.messages").inc(stats.messages)
            m.counter("federation.rows_shipped").inc(stats.rows_shipped)
            m.counter("federation.bytes_shipped").inc(stats.bytes_shipped)
            m.counter("join.cross_shard").inc(stats.distributed_joins)
            m.counter("join.rows").inc(stats.join_rows)
            m.counter("join.expanded_rows").inc(stats.expanded_rows)
            peak = m.gauge("join.expanded_rows_peak").track_max(
                stats.expanded_rows)
            m.gauge("join.expand_cap_headroom").set(
                self.kg.max_join_rows - peak)
            m.histogram("query.modeled_s").observe(stats.modeled_time(net))
        tr = self._tracer
        if not tr.enabled:
            return
        with tr.span("query", cat="serve", query=q.name, cached=cached,
                     epoch=self.kg.epoch, rows=stats.rows):
            with tr.span("plan", cat="serve",
                         dur=net.plan_s if plan_built else 0.0,
                         built=plan_built):
                pass
            with tr.span("scan", cat="serve",
                         dur=stats.scan_rows_critical / net.scan_rows_per_s,
                         rows=stats.scan_rows_critical):
                pass
            with tr.span("join", cat="serve",
                         dur=stats.join_rows / net.join_rows_per_s,
                         rows=stats.join_rows,
                         cross_shard=stats.distributed_joins,
                         expanded_rows=stats.expanded_rows):
                pass
            with tr.span("federate", cat="serve",
                         dur=stats.messages * net.latency_s,
                         messages=stats.messages):
                pass
            with tr.span("ship", cat="serve",
                         dur=stats.rows_shipped * net.row_bytes
                             / net.bandwidth_Bps,
                         rows=stats.rows_shipped,
                         bytes=stats.bytes_shipped):
                pass

    # ------------------------------------------------------------------ #
    # live writes (repro_torch.write)
    # ------------------------------------------------------------------ #
    def insert(self, triples) -> kgwrite.WriteReport:
        """Insert dictionary-encoded ``(s, p, o)`` triples into the live
        graph. Safe while serving, while replicated, and while a migration
        drain is in flight: rows are routed by the current primary
        assignment, fanned out to every replica holder, and served from the
        next epoch on (any cached plan/result of the old graph
        invalidates). Already-present triples are no-ops."""
        return self.write(kgwrite.WriteBatch(inserts=triples))

    def delete(self, triples) -> kgwrite.WriteReport:
        """Delete dictionary-encoded ``(s, p, o)`` triples from the live
        graph — the write path's mirror image of :meth:`insert` (absent
        triples are no-ops)."""
        return self.write(kgwrite.WriteBatch(deletes=triples))

    def fresh_ids(self, n: int = 1) -> np.ndarray:
        """Mint ``n`` entity ids unused by any triple in the live graph —
        subjects for new rows (``repro_torch.write.fresh_entity_ids``; bulk
        entity ids live past the dictionary, so ``Dictionary.encode`` on a
        new term may collide with an existing entity)."""
        assert self.kg is not None, "bootstrap() first"
        return kgwrite.fresh_entity_ids(self.kg.store, n)

    def write(self, batch: kgwrite.WriteBatch) -> kgwrite.WriteReport:
        """Apply one :class:`repro_torch.write.WriteBatch` (deletes first,
        inserts win) and log it. The report is folded into the adaptive
        controller's TM window (``note_writes``): write-born features join
        the tracked universe and per-feature write heat accumulates — the
        data-drift signal the next adaptation round's fanout pricing and
        replica proposal consume."""
        assert self.kg is not None, "bootstrap() first"
        report = self.kg.apply_write(batch)
        self.write_log.append(batch, report)
        ctrl = self.controller
        if ctrl is not None and report.effective:
            ctrl.note_writes(report)
        tr = self._tracer
        if tr.enabled:
            net = self.net or qexec.NetworkModel()
            traffic = (report.n_inserted + report.n_deleted) * TRIPLE_BYTES \
                + report.fanout_bytes
            with tr.span("write.batch", cat="write",
                         dur=traffic / net.bandwidth_Bps,
                         inserted=report.n_inserted,
                         deleted=report.n_deleted,
                         redundant=report.n_redundant,
                         touched_shards=len(report.touched_shards),
                         fanout_bytes=report.fanout_bytes,
                         epoch=report.epoch):
                pass
        return report

    # ------------------------------------------------------------------ #
    # streaming admission (repro_torch.stream)
    # ------------------------------------------------------------------ #
    def stream(self, **kwargs) -> "object":
        """Open a continuous-admission serving loop over this service — a
        :class:`repro_torch.stream.StreamService`. Queries and write batches are
        ``submit``-ted as they arrive, served in pipelined windows through
        the same :meth:`serve_window` seam (results stay byte-identical to
        a synchronous ``query_batch`` over the same admission order), and
        per-query admission→completion latency lands in the stream's
        :class:`repro_torch.stream.LatencyRecorder` (surfaced via
        :meth:`stats`). Keyword arguments forward to ``StreamService``
        (``pipeline=``, ``max_window=``, ``hit_cost_s=``)."""
        from repro_torch.stream import StreamService
        return StreamService(self, **kwargs)

    def tracer(self) -> Tracer:
        """The service's span tracer (``repro_torch.obs.Tracer``) — inspect
        ``tracer().events`` or ``tracer().export(path)`` after a run."""
        if not self._tracer.enabled:
            raise RuntimeError(
                "tracing is disabled for this service: construct it with "
                "KGService(..., trace=True) (or pass a repro_torch.obs.Tracer "
                "instance) to record spans")
        return self._tracer

    def stats(self) -> Dict[str, object]:
        """One dict of everything observable about the serving session:
        the facade's layout/cache telemetry, write-log and migration-drain
        progress, the metrics-registry snapshot, and the latency aggregates
        (overall / per-window / per-shard p50/p95/p99 — a well-formed
        all-zero block when no stream has recorded anything yet)."""
        if self.kg is None:
            raise RuntimeError(
                "KGService.stats() before bootstrap(): call "
                "svc.bootstrap(workload) to partition the graph and "
                "materialize the shard views first")
        out = self.kg.telemetry()
        out.update(
            executor=self.executor.name,
            partitioner=self.partitioner.name,
            writes_applied=len(self.write_log.entries),
            rows_inserted=self.write_log.n_inserted,
            rows_deleted=self.write_log.n_deleted,
            migration_in_flight=self.session is not None,
            migration_progress=(self.session.progress()
                                if self.session is not None else 1.0),
        )
        from repro_torch.stream.telemetry import LatencyRecorder
        rec = self._stream_recorder
        if rec is not None and len(rec):
            out["latency"] = rec.summary()
            out["latency_per_shard"] = rec.per_shard()
        else:
            out["latency"] = LatencyRecorder.empty_summary()
            out["latency_per_shard"] = {}
        out["metrics"] = self.metrics.snapshot()
        return out

    def run_workload(self, queries: Sequence[Query],
                     ) -> Tuple[Dict[str, float], Dict[str, qexec.ExecStats]]:
        """Batched measurement sweep (no TM recording): per-query modeled
        times and stats, keyed by query name."""
        assert self.kg is not None, "bootstrap() first"
        return qexec.run_workload(queries, self.kg, self.executor, self.net)

    def workload_average_time(self, queries: Sequence[Query]) -> float:
        assert self.kg is not None, "bootstrap() first"
        return qexec.workload_average_time(queries, self.kg, self.executor,
                                           self.net)

    def observe(self, query: Query, runtime: float) -> None:
        ctrl = self.controller
        if ctrl is not None:
            ctrl.observe(query, runtime)
        else:
            self._times.setdefault(query.name, []).append(runtime)

    def avg_execution_time(self) -> float:
        ctrl = self.controller
        if ctrl is not None:
            return ctrl.avg_execution_time()
        per_q = [float(np.mean(v)) for v in self._times.values() if v]
        return float(np.mean(per_q)) if per_q else 0.0

    # ------------------------------------------------------------------ #
    # adaptation
    # ------------------------------------------------------------------ #
    def should_adapt(self) -> bool:
        """Adaptation trigger — False while a migration drain is in flight:
        the TM is observing transient hybrid-layout times, and a fresh round
        would finish the drain atomically, re-introducing the stop-the-world
        stall the ``migration_budget`` knob exists to prevent."""
        if self.session is not None:
            return False
        ctrl = self.controller
        return ctrl is not None and ctrl.should_adapt()

    def adapt(self, new_queries: Sequence[Query] = (), *,
              _trigger: str = "explicit") -> AdaptReport:
        """Run one adaptation round now (strategy must be adaptive). On
        acceptance the TM window restarts with the measured new baseline.

        Any still-draining previous migration is finished first. With
        ``migration_budget=None`` the accepted plan is drained atomically
        before returning (the classic stop-the-world commit); with a budget
        it is left pending as ``self.session`` and applied chunk-by-chunk by
        subsequent ``query_batch`` windows / ``step()`` calls."""
        assert self.kg is not None, "bootstrap() first"
        if not hasattr(self.partitioner, "adapt"):
            raise TypeError(f"partitioner '{self.partitioner.name}' is not "
                            "adaptive; use AWAPartitioner")
        m = self.metrics
        m.counter("adapt.rounds").inc()
        # adapt is a cold path: span bookkeeping runs unconditionally (the
        # null tracer's span is a shared no-op), so the atomic drain's chunk
        # spans nest inside the round span without duplicated control flow
        with self._tracer.span("adapt.round", cat="adapt",
                               trigger=_trigger) as sp:
            self.drain()                       # finish any in-flight drain
            session, report = self.partitioner.adapt(
                self.kg, list(new_queries), net=self.net,
                bytes_budget=self.migration_budget)
            ctrl = self.controller
            if report.accepted and ctrl is not None:
                ctrl.clear_window()            # fresh TM window post-migration
                ctrl.reset_baseline(report.t_new)
            sp.annotate(accepted=report.accepted, reason=report.reason,
                        t_base=report.t_base, t_new=report.t_new,
                        migration_s=report.migration_s,
                        amortize_window=report.amortize_window,
                        fanout_bytes=report.fanout_bytes,
                        moves=report.plan.n_moves,
                        chosen_cut=report.chosen_cut,
                        n_clusters=report.n_clusters)
            m.counter("adapt.accepted" if report.accepted
                      else "adapt.rejected").inc()
            if report.accepted:
                m.gauge("replicate.copy_bytes_held").set(report.replica_bytes)
            if report.accepted and report.plan.n_replica_ops:
                m.counter("replicate.planned_adds").inc(
                    len(report.plan.replica_adds))
                m.counter("replicate.planned_drops").inc(
                    len(report.plan.replica_drops))
                with self._tracer.span(
                        "replica.promotion", cat="replicate",
                        adds=len(report.plan.replica_adds),
                        drops=len(report.plan.replica_drops),
                        replica_bytes=report.replica_bytes):
                    pass
            if self.migration_budget is None:
                session.drain()                # atomic: commit-now behaviour
        self.session = None if session.done else session
        return report

    def step(self) -> Optional[MigrationChunk]:
        """Apply one chunk of the pending migration session (if any).
        Returns the applied ``MigrationChunk`` or ``None`` when idle."""
        if self.session is None:
            return None
        sess = self.session
        chunk = sess.step()
        if chunk is not None and self._tracer.enabled:
            net = self.net or qexec.NetworkModel()
            with self._tracer.span(
                    "migration.chunk", cat="migrate",
                    dur=chunk.bytes / net.bandwidth_Bps,
                    moves=len(chunk.moves), bytes=chunk.bytes,
                    replica_adds=len(chunk.replica_adds),
                    replica_drops=len(chunk.replica_drops),
                    progress=sess.progress(), epoch=self.kg.epoch):
                pass
        if self.session.done:
            self.session = None
            # the TM observed hybrid-layout times while draining; restart the
            # window so the pinned t_new baseline is compared against the
            # fully-migrated layout only (no spurious post-drain round)
            ctrl = self.controller
            if ctrl is not None:
                ctrl.clear_window()
            self._times.clear()
        return chunk

    def drain(self) -> int:
        """Finish the pending migration session; returns chunks applied."""
        n = 0
        while self.step() is not None:
            n += 1
        return n

    def maybe_adapt(self, new_queries: Sequence[Query] = (),
                    ) -> Optional[AdaptReport]:
        """Adapt only if the monitored average degraded past the threshold
        (or no baseline exists yet and at least one query was observed).
        Returns None when no round was run."""
        if not self.should_adapt():
            return None
        ctrl = self.controller
        if ctrl is not None and ctrl.write_drift():
            trigger = "write_drift"
        elif ctrl is not None and ctrl._baseline_avg is None:
            trigger = "no_baseline"
        else:
            trigger = "degradation"
        return self.adapt(new_queries, _trigger=trigger)

    def reset_baseline(self, value: Optional[float] = None) -> None:
        """Public baseline control: clear (None) to force the next
        ``maybe_adapt`` to run a round, or pin to a measured average. Resets
        the whole TM window — the non-adaptive ``_times`` log included, so
        ``avg_execution_time()`` restarts consistently across strategies."""
        ctrl = self.controller
        if ctrl is not None:
            ctrl.reset_baseline(value)
        self._times.clear()
