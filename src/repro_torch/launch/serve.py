"""KG serving driver — the paper's own system end-to-end (Fig. 6).

Master-node loop via the ``repro_torch.api`` service facade: LUBM dataset
-> workload-aware initial partition (WawPart [21]) -> serve federated
queries over the shards -> monitor per-query runtimes (TM) -> on workload
change, run the Fig.-5 adaptation as an incremental shard-view delta ->
keep serving. ``--experiment 1|2`` reproduces the paper's two
evaluations, ``--partitioner hash|wawpart|awapart`` swaps the strategy,
``--executor torch|numpy`` swaps the query backend under the same harness
(``torch``, the default, executes each window as one batch whose joins run
through the ``repro_torch.kernels.join`` Hopper kernels on the card;
``numpy`` is the host reference), ``--device cuda|cpu`` says where the
torch executor and the adaptation's Jaccard matrix run (the card unless
the caller asks for the CPU; ``cuda`` with no card raises), and
``--migration-budget BYTES`` throttles accepted migrations into a chunked
``MigrationSession`` drained one chunk per serving window (default: atomic),
and ``--writes-per-window N`` interleaves N synthetic live inserts
(``repro_torch.write``: fresh subjects carrying sampled (p, o) pairs,
routed by primary and fanned out to replicas) ahead of every drain window
— mixed read/write serving. ``--stream`` swaps the experiment for the
continuous-admission loop (``repro_torch.stream``): an open-loop replay at
``--arrival-rate`` qps with writes and the migration drain in flight,
reporting p50/p95/p99 admission→completion tails per window.
``--trace out.json`` records the run's ``repro_torch.obs`` spans
(per-query plan→scan→join→federate→ship, windows, migration chunks,
adaptation rounds) as a Perfetto-loadable Chrome trace, and
``--metrics-csv`` dumps the metrics-registry snapshot.

  PYTHONPATH=src python -m repro_torch.launch.serve --universities 5 \
      --shards 8 --experiment 1 --migration-budget 1048576 \
      --writes-per-window 256
  PYTHONPATH=src python -m repro_torch.launch.serve --universities 1 \
      --shards 4 --experiment 2 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --universities 3 \
      --shards 8 --stream --arrival-rate 400 --migration-budget 1048576 \
      --writes-per-window 128
"""
from __future__ import annotations

import argparse
import time
from typing import Dict

import numpy as np

from repro_torch.api import (AWAPartitioner, HashPartitioner, KGService,
                       WawPartitioner)
from repro_torch.core.adaptive import AdaptConfig
from repro_torch.graph import lubm
from repro_torch.query import rewrite

PARTITIONERS = {"hash": HashPartitioner, "wawpart": WawPartitioner,
                "awapart": AWAPartitioner}


def build_system(universities: int, shards: int, seed: int = 0,
                 config: AdaptConfig | None = None,
                 partitioner: str = "awapart", executor: str = "torch",
                 migration_budget: int | None = None,
                 replica_budget: int | None = None,
                 trace: bool = False, device="cuda"):
    """Load LUBM and assemble the service facade (no partition yet) on
    ``device``."""
    ds = lubm.load(universities, seed)
    part = (HashPartitioner() if partitioner == "hash"
            else PARTITIONERS[partitioner](config))
    svc = KGService.from_dataset(ds, shards, part, executor=executor,
                                 migration_budget=migration_budget,
                                 replica_budget=replica_budget,
                                 trace=trace, device=device)
    return ds, svc


def synthetic_writes(svc: KGService, n: int, rng):
    """Insert ``n`` synthetic rows into the live graph: fresh subjects
    (``svc.fresh_ids`` — entity ids live past the dictionary) carrying
    (p, o) pairs sampled from existing triples, so the writes land across
    the same features the workload reads. Returns the ``WriteReport``."""
    t = svc.kg.store.triples
    rows = t[rng.integers(0, len(t), n)].copy()
    rows[:, 0] = svc.fresh_ids(n).astype(np.int32)
    return svc.insert(rows)


def drive_migration(svc: KGService, window, verbose=True,
                    writes_per_window: int = 0, rng=None):
    """Drain a pending MigrationSession while continuing to serve: each
    ``query_batch`` window applies exactly one bounded chunk ahead of
    serving, then executes against the updated hybrid layout; with
    ``writes_per_window`` > 0, that many synthetic live inserts land ahead
    of every window (mixed read/write serving — later chunks carry the
    post-write rows). Returns per-window average modeled query times
    observed during the drain."""
    averages = []
    session = svc.session
    if writes_per_window and rng is None:
        rng = np.random.default_rng(0)
    while svc.session is not None:
        wrote = ""
        if writes_per_window:
            rep = synthetic_writes(svc, writes_per_window, rng)
            wrote = (f" | +{rep.n_inserted} rows on shards "
                     f"{rep.touched_shards}")
        results = svc.query_batch(window)       # serve + one chunk
        avg = float(np.mean([st.modeled_time(svc.net)
                             for _, st in results]))
        averages.append(avg)
        if verbose:
            print(f"[migrate] window {len(averages) - 1}: "
                  f"avg {avg * 1e3:6.1f} ms | epoch {svc.kg.epoch} | "
                  f"{session.applied}/{session.n_chunks} chunks, "
                  f"{session.bytes_applied / 1e6:.2f} MB migrated{wrote}")
    return averages


def experiment1(ds, svc: KGService, verbose=True,
                writes_per_window: int = 0):
    """Workload-composition change: 14 base queries -> +10 new queries."""
    kg = svc.bootstrap(ds.base_workload())
    extended = ds.extended_workload()
    t_initial, s_initial = svc.run_workload(extended)

    if not hasattr(svc.partitioner, "adapt"):   # static strategy: no round
        avg0 = float(np.mean(list(t_initial.values())))
        if verbose:
            print(f"[exp1] strategy={svc.partitioner.name} (static): "
                  f"all-24 avg {avg0*1e3:.1f} ms, no adaptation")
        return dict(initial=t_initial, adaptive=t_initial, report=None,
                    stats_initial=s_initial, stats_adaptive=s_initial,
                    state=kg.state, kg=kg)

    report = svc.adapt(ds.workload([f"EQ{i}" for i in range(1, 11)]))
    if svc.session is not None:        # throttled: drain while serving
        if verbose:
            print(f"[exp1] migration session: {svc.session.n_chunks} chunks "
                  f"of <= {svc.migration_budget} B "
                  f"({report.plan.summary()})")
        drive_migration(svc, extended, verbose=verbose,
                        writes_per_window=writes_per_window)
    t_adapt, s_adapt = svc.run_workload(extended)
    if verbose:
        _print_exp(t_initial, t_adapt, s_initial, s_adapt, report)
    return dict(initial=t_initial, adaptive=t_adapt, report=report,
                stats_initial=s_initial, stats_adaptive=s_adapt,
                state=kg.state, kg=kg)


def experiment2(ds, svc: KGService, hot_query: str = "Q1",
                hot_share: float = 0.5, verbose=True,
                writes_per_window: int = 0):
    """Frequency change: hot_query becomes hot_share of the workload."""
    base = ds.base_workload()
    svc.bootstrap(base)
    n = len(base)
    hot_freq = hot_share * (n - 1) / (1 - hot_share)
    biased = ds.workload([q.name for q in base],
                         frequencies={hot_query: hot_freq})
    t0 = svc.workload_average_time(biased)

    if not hasattr(svc.partitioner, "adapt"):   # static strategy: no round
        if verbose:
            print(f"[exp2] strategy={svc.partitioner.name} (static): "
                  f"biased avg {t0*1e3:.1f} ms, no adaptation")
        return dict(t_initial=t0, t_adaptive=t0, report=None,
                    state=svc.kg.state, kg=svc.kg)

    report = svc.adapt(biased)
    if svc.session is not None:        # throttled: drain while serving
        drive_migration(svc, biased, verbose=verbose,
                        writes_per_window=writes_per_window)
    t1 = svc.workload_average_time(biased)
    if verbose:
        print(f"[exp2] biased-workload avg: initial {t0*1e3:.1f} ms -> "
              f"adaptive {t1*1e3:.1f} ms "
              f"({(1 - t1 / max(t0, 1e-12)) * 100:.1f}% improvement) | "
              f"{report.plan.summary()}")
    return dict(t_initial=t0, t_adaptive=t1, report=report,
                state=svc.kg.state, kg=svc.kg)


def _print_exp(t0: Dict, t1: Dict, s0, s1, report) -> None:
    new_q = [n for n in t0 if n.startswith("EQ")]
    old_q = [n for n in t0 if not n.startswith("EQ")]
    avg = lambda t, qs: float(np.mean([t[q] for q in qs]))
    print(f"[exp1] adaptation accepted={report.accepted} "
          f"dj {report.dj_before:.0f}->{report.dj_after:.0f} "
          f"clusters={report.n_clusters} | {report.plan.summary()}")
    print(f"[exp1] new queries avg: {avg(t0,new_q)*1e3:.1f} -> "
          f"{avg(t1,new_q)*1e3:.1f} ms "
          f"({(1 - avg(t1,new_q)/avg(t0,new_q))*100:.1f}% improvement)")
    print(f"[exp1] old queries avg: {avg(t0,old_q)*1e3:.1f} -> "
          f"{avg(t1,old_q)*1e3:.1f} ms")
    print(f"[exp1] all 24 avg:      {avg(t0,list(t0))*1e3:.1f} -> "
          f"{avg(t1,list(t1))*1e3:.1f} ms")


def stream_demo(ds, svc: KGService, rate_qps: float, passes: int = 4,
                writes_per_window: int = 0, verbose=True):
    """Continuous-admission serving (``repro_torch.stream``): bootstrap, accept
    an adaptation round, then replay an open-loop arrival process of the
    extended workload — writes admitted mid-stream, the migration drain
    retiring into idle gaps — and report per-window p50/p95/p99 tails."""
    from repro_torch.api import WriteBatch
    from repro_torch.stream import interleave, open_loop_arrivals, replay

    svc.bootstrap(ds.base_workload())
    window = ds.extended_workload()
    svc.query_batch(window)
    report = svc.adapt(ds.workload([f"EQ{i}" for i in range(1, 11)]))
    in_flight = svc.session.n_chunks if svc.session is not None else 0

    queries = window * passes
    writes = []
    if writes_per_window:
        rng = np.random.default_rng(0)
        t = svc.kg.store.triples
        fresh = svc.fresh_ids(passes * writes_per_window)
        for k in range(passes):
            rows = t[rng.integers(0, len(t), writes_per_window)].copy()
            rows[:, 0] = fresh[k * writes_per_window:
                               (k + 1) * writes_per_window].astype(np.int32)
            writes.append((k * len(window), WriteBatch(inserts=rows)))
    stream = svc.stream(pipeline=True)
    replay(stream, interleave(
        queries, open_loop_arrivals(len(queries), rate_qps), writes))
    results = stream.poll()

    stats = stream.stats()
    lat = stats["latency"]
    if verbose:
        for w, s in stream.recorder.per_window().items():
            print(f"[stream] window {w}: n={s['n']:3d} "
                  f"p50 {s['p50'] * 1e3:8.1f} ms | "
                  f"p95 {s['p95'] * 1e3:8.1f} ms | "
                  f"p99 {s['p99'] * 1e3:8.1f} ms")
        hidden = sum(w["hidden_s"] for w in stream.window_log)
        print(f"[stream] {len(results)} queries @ {rate_qps:g} qps over "
              f"{stream.n_windows} windows, makespan {stream.now:.2f}s, "
              f"{hidden * 1e3:.1f} ms of stalls hidden | accepted="
              f"{report.accepted}, {in_flight} chunks drained mid-stream, "
              f"{stats['rows_inserted']} rows written")
        print(f"[stream] overall p50 {lat['p50'] * 1e3:.1f} ms | "
              f"p95 {lat['p95'] * 1e3:.1f} ms | "
              f"p99 {lat['p99'] * 1e3:.1f} ms")
    return dict(stream=stream, results=results, stats=stats, report=report,
                state=svc.kg.state, kg=svc.kg)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--universities", type=int, default=10)
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--experiment", type=int, default=1, choices=[1, 2])
    ap.add_argument("--partitioner", default="awapart",
                    choices=sorted(PARTITIONERS))
    ap.add_argument("--executor", default="torch",
                    choices=["torch", "numpy"],
                    help="query backend (torch = batched execution, its "
                         "joins through the Hopper join kernels on the "
                         "card; numpy = the host reference)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the torch executor and the adaptation's "
                         "Jaccard matrix run (cuda raises without a card)")
    ap.add_argument("--migration-budget", type=int, default=None,
                    help="bytes of migration traffic per serving window "
                         "(default: atomic commit)")
    ap.add_argument("--replica-budget", type=int, default=None,
                    help="bytes of read-replica copies the adaptation may "
                         "pin onto remote readers' shards (default: no "
                         "replication)")
    ap.add_argument("--writes-per-window", type=int, default=0,
                    help="synthetic live inserts ahead of every drain "
                         "window (repro_torch.write; needs --migration-budget "
                         "to produce multiple windows)")
    ap.add_argument("--stream", action="store_true",
                    help="continuous-admission serving demo (repro_torch.stream) "
                         "instead of an experiment: open-loop replay with "
                         "writes and the migration drain in flight, "
                         "p50/p95/p99 tails per window")
    ap.add_argument("--arrival-rate", type=float, default=200.0,
                    help="open-loop arrival rate for --stream (queries/s)")
    ap.add_argument("--show-federated", action="store_true",
                    help="print a federated SPARQL rewrite example")
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="record repro_torch.obs spans (per-query plan/scan/join/"
                         "federate/ship, windows, migration chunks, "
                         "adaptation rounds) and export a Chrome-trace JSON "
                         "(.jsonl for JSON-lines) to PATH")
    ap.add_argument("--metrics-csv", metavar="PATH", default=None,
                    help="dump the service's metrics-registry snapshot "
                         "(counters/gauges/histograms) as CSV to PATH")
    args = ap.parse_args()

    t0 = time.time()
    ds, svc = build_system(args.universities, args.shards,
                           partitioner=args.partitioner,
                           executor=args.executor,
                           migration_budget=args.migration_budget,
                           replica_budget=args.replica_budget,
                           trace=args.trace is not None,
                           device=args.device)
    print(f"loaded LUBM({args.universities}): {ds.store.n_triples} triples "
          f"({time.time()-t0:.1f}s), {svc.space.n_features} features, "
          f"{args.shards} shards, strategy={svc.partitioner.name}, "
          f"executor={svc.executor.name}, device={svc.device}")
    if args.stream:
        out = stream_demo(ds, svc, args.arrival_rate,
                          writes_per_window=args.writes_per_window)
    elif args.experiment == 1:
        out = experiment1(ds, svc,
                          writes_per_window=args.writes_per_window)
    else:
        out = experiment2(ds, svc,
                          writes_per_window=args.writes_per_window)
    if args.show_federated:
        state = out["state"]
        q = ds.queries["Q9"]
        print("\nFederated rewrite of Q9 under the adapted partition:")
        print(rewrite.federated_sparql(q, svc.space, state, ds.dictionary,
                                       replicas=svc.kg.replicas))
    if args.trace:
        n = svc.tracer().export(args.trace)
        print(f"[obs] wrote {n} trace events to {args.trace}")
    if args.metrics_csv:
        svc.metrics.to_csv(args.metrics_csv)
        print(f"[obs] wrote metrics snapshot to {args.metrics_csv}")


if __name__ == "__main__":
    main()
