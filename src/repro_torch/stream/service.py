"""StreamService — continuous admission over a ``KGService`` session.

The paper's Fig.-5 loop consumes closed TM windows; a serving system sees
queries (and writes) *arrive*. This module turns the synchronous
``query_batch`` loop into a streaming one without changing a single
result byte:

* **Admission queue** — ``submit()`` / ``submit_write()`` append events in
  arrival order (timestamps are clamped monotone; admission order IS
  submission order). ``poll()`` drains completed results.
* **Window pipeline** — ``pump()`` forms the next serving window from the
  queries that have arrived, executes it through the existing
  ``KGService.serve_window`` seam (cache check → one ``run_batch`` over
  the misses → TM observation), and — in ``pipeline=True`` mode —
  pre-stages the *next* window's plans while the current one executes
  (double buffering). A window never spans a write event: the write is
  applied first, exactly where synchronous admission would have applied
  it, so bindings stay byte-identical to ``query_batch`` over the same
  admission order at every epoch.
* **Background drainer** — pending write batches and migration/replica
  chunks are interleaved into the gaps between windows under the same
  ``bytes_budget`` discipline as the synchronous loop: one mandatory
  chunk per window (``query_batch`` parity), plus — pipelined only — as
  many extra chunks as fit inside the hidden-time budget, so an idle
  stream finishes its drain without ever stalling a query.

Time is the same *modeled* currency as everywhere else in this repo
(``NetworkModel`` — the container has no cluster fabric): queries execute
for real, the clock is deterministic. A window's service time is

    overhead  = write stalls + chunk stalls + plans built * net.plan_s
    exec_s    = sum of modeled query times over the cache misses
    finish    = t0 + max(0, overhead - hidden) + exec_s

where ``hidden`` is the pipelining credit — the previous window's
execution time plus any idle gap, during which the master planned ahead
and the drainer moved bytes. ``pipeline=False`` sets the credit to zero:
the same code path, the same results, the synchronous loop's head-of-line
stalls — which is what ``benchmarks/bench_streaming.py`` compares tails
against.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch import write as kgwrite
from repro_torch.core.migration import TRIPLE_BYTES
from repro_torch.query import exec as qexec
from repro_torch.query.pattern import Query

from repro_torch.stream.telemetry import LatencyRecorder, QueryLatency

__all__ = ["StreamEvent", "StreamResult", "StreamService"]


@dataclasses.dataclass
class StreamEvent:
    """One admitted event: a query or a write batch."""

    seq: int
    arrival_s: float
    query: Optional[Query] = None
    batch: Optional[kgwrite.WriteBatch] = None

    @property
    def is_write(self) -> bool:
        return self.batch is not None


@dataclasses.dataclass
class StreamResult:
    """One completed query, with its latency record."""

    seq: int
    query: Query
    bindings: Dict[int, np.ndarray]
    stats: qexec.ExecStats
    latency: QueryLatency


class StreamService:
    """Continuous-admission serving loop over one :class:`KGService`.

    Parameters
    ----------
    svc : KGService
        The bootstrapped session to serve through (its executor, caches,
        migration session and write path are all reused as-is).
    pipeline : bool
        ``True`` (default): double-buffered windows — plan pre-staging and
        drainer stalls hide behind the previous window's execution time.
        ``False``: the synchronous loop's accounting (every stall is
        head-of-line). Results are byte-identical either way.
    max_window : int
        Cap on queries per serving window.
    hit_cost_s : float
        Modeled service time of an epoch-valid result-cache hit (a column
        memcpy — effectively free next to federated execution).
    net : NetworkModel, optional
        Clock cost model; defaults to the service's (or a default) model.
    """

    def __init__(self, svc, *, pipeline: bool = True, max_window: int = 64,
                 hit_cost_s: float = 0.0,
                 net: Optional[qexec.NetworkModel] = None):
        assert svc.kg is not None, "bootstrap() the service first"
        self.svc = svc
        self.net = net or svc.net or qexec.NetworkModel()
        self.pipeline = bool(pipeline)
        self.max_window = int(max_window)
        self.hit_cost_s = float(hit_cost_s)
        self.recorder = LatencyRecorder()
        svc._stream_recorder = self.recorder     # KGService.stats() surface

        self.now = 0.0                  # virtual clock (seconds)
        self.n_windows = 0
        self.window_log: List[Dict[str, float]] = []
        self._queue: Deque[StreamEvent] = deque()
        self._done: List[StreamResult] = []
        self._seq = 0
        self._last_arrival = 0.0
        self._credit = 0.0              # hidden-time budget for the drainer
        self._prestaged: set = set()    # query names planned ahead (telemetry)
        self.prestage_hits = 0          # prestaged plans that survived to use

    # ------------------------------------------------------------------ #
    # admission
    # ------------------------------------------------------------------ #
    def _admit(self, ev_kwargs: dict, at: Optional[float]) -> int:
        arrival = self.now if at is None else float(at)
        arrival = max(arrival, self._last_arrival)   # clamp monotone
        self._last_arrival = arrival
        ev = StreamEvent(seq=self._seq, arrival_s=arrival, **ev_kwargs)
        self._seq += 1
        self._queue.append(ev)
        return ev.seq

    def submit(self, query: Query, at: Optional[float] = None) -> int:
        """Admit one query (at ``at`` seconds on the virtual clock, default
        now). Returns its admission sequence number."""
        return self._admit(dict(query=query), at)

    def submit_write(self, batch: kgwrite.WriteBatch,
                     at: Optional[float] = None) -> int:
        """Admit one write batch. It applies before any query admitted
        after it — exactly the synchronous admission-order semantics."""
        return self._admit(dict(batch=batch), at)

    def poll(self) -> List[StreamResult]:
        """Completed results since the last poll, in completion order."""
        out, self._done = self._done, []
        return out

    @property
    def pending(self) -> int:
        return len(self._queue)

    # ------------------------------------------------------------------ #
    # the serving loop
    # ------------------------------------------------------------------ #
    def pump(self) -> int:
        """Serve one window (or apply pending mutations): interleave the
        writes and migration chunks due before the next window, execute
        the window through ``serve_window``, pre-stage the next one.
        Returns the number of queries served (0 is still progress — a
        mutation-only pump or a clock advance)."""
        svc, kg, net = self.svc, self.svc.kg, self.net
        if not self._queue:
            return 0
        t0 = max(self.now, self._queue[0].arrival_s)
        # sync the span tracer's virtual-clock cursor to the admission
        # clock: spans emitted by the writes/chunks/window below lay out
        # from this window's start (monotone — never rewinds over spans)
        svc._tracer.advance_to(t0)
        idle = t0 - self.now
        avail = (self._credit + idle) if self.pipeline else 0.0
        overhead = 0.0
        wrote = 0

        # 1. writes admitted ahead of the window's queries land first — the
        #    same point in the admission order the synchronous loop applies
        #    them, so every later query sees the identical graph
        while self._queue and self._queue[0].is_write \
                and self._queue[0].arrival_s <= t0:
            ev = self._queue.popleft()
            report = svc.write(ev.batch)
            overhead += ((report.n_inserted + report.n_deleted)
                         * TRIPLE_BYTES + report.fanout_bytes) \
                / net.bandwidth_Bps
            wrote += 1

        # 2. the drainer: one mandatory bounded chunk (query_batch parity),
        #    then — pipelined only — as many extra chunks as fit entirely
        #    inside the hidden-time budget, so idle gaps finish the drain
        chunk_bytes = 0
        chunk = svc.step()
        if chunk is not None:
            overhead += chunk.bytes / net.bandwidth_Bps
            chunk_bytes += chunk.bytes
        if self.pipeline:
            while svc.session is not None:
                stall = svc.session.peek().bytes / net.bandwidth_Bps
                if overhead + stall > avail:
                    break
                chunk_bytes += svc.step().bytes
                overhead += stall

        # 3. window formation: ready queries in admission order; a window
        #    never spans a write event or an unarrived query
        window: List[StreamEvent] = []
        while self._queue and len(window) < self.max_window:
            ev = self._queue[0]
            if ev.is_write or ev.arrival_s > t0:
                break
            window.append(self._queue.popleft())

        if not window:       # mutation-only pump: charge the unhidden stall
            self.now = t0 + max(0.0, overhead - avail)
            svc._tracer.advance_to(self.now)
            if self.pipeline:
                self._credit = max(0.0, avail - overhead)
            return 0

        # 4. execute through the existing seam; plans built during the
        #    window (pre-stage misses, epoch-invalidated pre-stages) are
        #    master-side overhead at plan_s each
        builds0 = kg.plan_builds
        queries = [ev.query for ev in window]
        results, miss = svc.serve_window(queries)
        built = kg.plan_builds - builds0
        overhead += built * net.plan_s
        staged = sum(1 for ev in window if ev.query.name in self._prestaged)
        self.prestage_hits += max(0, staged - built)
        miss_set = set(miss)
        exec_s = sum(
            (results[i][1].modeled_time(net) if i in miss_set
             else self.hit_cost_s) for i in range(len(results)))

        hidden = min(overhead, avail)
        start = t0 + (overhead - hidden)
        finish = start + exec_s

        # 5. record + complete
        miss_seqs = {window[i].seq for i in miss}
        m = svc.metrics
        for ev, (bindings, stats) in zip(window, results):
            rec = QueryLatency(
                seq=ev.seq, name=ev.query.name, window=self.n_windows,
                shard=int(kg.plan(ev.query).ppn), arrival_s=ev.arrival_s,
                start_s=start, finish_s=finish, epoch=kg.epoch,
                cached=ev.seq not in miss_seqs)
            self.recorder.record(rec)
            m.histogram("query.queue_s").observe(rec.queue_s)
            m.histogram("query.latency_s").observe(rec.latency_s)
            self._done.append(StreamResult(ev.seq, ev.query, bindings,
                                           stats, rec))
        self.window_log.append(dict(
            window=self.n_windows, t0=t0, start=start, finish=finish,
            n=len(window), n_miss=len(miss), exec_s=exec_s,
            overhead_s=overhead, hidden_s=hidden, writes=wrote,
            chunk_bytes=chunk_bytes, epoch=kg.epoch))
        # the queue-vs-execute split: how much window time was spent
        # waiting (stalls that failed to hide) vs. executing
        m.counter("stream.windows").inc()
        m.counter("stream.queries").inc(len(window))
        m.counter("stream.exec_s_total").inc(exec_s)
        m.counter("stream.queue_s_total").inc(
            sum(start - ev.arrival_s for ev in window))
        m.counter("stream.overhead_s_total").inc(overhead)
        m.counter("stream.hidden_s_total").inc(hidden)
        self.n_windows += 1
        self.now = finish
        svc._tracer.advance_to(finish)
        # double buffering: the next window's stalls can hide behind this
        # window's execution — and behind nothing else
        self._credit = exec_s if self.pipeline else 0.0

        # 6. pre-stage window N+1: build plans for the queries already
        #    admitted behind this window, stopping at the first write event
        #    (it would invalidate them anyway). Runs on the master while
        #    the shards execute — its cost is the credit being consumed.
        self._prestaged = set()
        if self.pipeline:
            for ev in list(self._queue)[:self.max_window]:
                if ev.is_write:
                    break
                if ev.query is not None:
                    kg.plan(ev.query)
                    self._prestaged.add(ev.query.name)
        return len(window)

    def run_until_idle(self) -> LatencyRecorder:
        """Pump until the admission queue is empty. Returns the recorder."""
        while self._queue:
            self.pump()
        return self.recorder

    # ------------------------------------------------------------------ #
    def stats(self) -> Dict[str, object]:
        """The stream's own aggregates, merged over ``KGService.stats()``."""
        out = self.svc.stats()
        out.update(n_windows=self.n_windows, clock_s=self.now,
                   pending=self.pending, pipeline=self.pipeline,
                   latency=self.recorder.summary(),
                   latency_per_shard=self.recorder.per_shard())
        return out

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"StreamService(pipeline={self.pipeline}, "
                f"windows={self.n_windows}, pending={self.pending}, "
                f"clock={self.now:.3f}s)")
