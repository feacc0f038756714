"""End-to-end driver on the PyTorch port (the paper's kind): serve a
partitioned knowledge graph with batched queries while the workload
drifts, adapting online.

Simulates the Fig.-6 deployment through ``repro_torch.api``: queries
arrive in batches with a drifting mix and each batch executes as ONE
backend batch (``svc.query_batch`` — one batch on the torch executor,
its joins through the Hopper kernels on the card); the ``KGService``
monitors per-query runtimes (TM) and triggers the Fig.-5 adaptation when
the average degrades past the threshold, applying the migration to the
live shard views as an incremental delta.

    PYTHONPATH=src python examples/serve_kg_torch.py [--batches 12] \
        [--executor torch|numpy] [--device cuda|cpu]
"""
import argparse
import time

import numpy as np

from repro_torch.api import AWAPartitioner, KGService
from repro_torch.core.adaptive import AdaptConfig
from repro_torch.graph import lubm


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--universities", type=int, default=3)
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--batches", type=int, default=12)
    ap.add_argument("--queries-per-batch", type=int, default=24)
    ap.add_argument("--executor", default="torch",
                    choices=["torch", "numpy"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the torch executor and the adaptation's "
                         "Jaccard matrix run (cuda raises without a card)")
    ap.add_argument("--migration-budget", type=int, default=None,
                    help="bytes of migration traffic applied per batch "
                         "(default: atomic commit inside the adapt round)")
    ap.add_argument("--replica-budget", type=int, default=None,
                    help="bytes of hot-feature read replicas the adaptation "
                         "may pin onto remote readers' shards")
    args = ap.parse_args()

    rng = np.random.default_rng(0)
    t0 = time.time()
    ds = lubm.load(args.universities, 0)
    svc = KGService.from_dataset(
        ds, args.shards,
        AWAPartitioner(AdaptConfig(adapt_threshold=1.10)),
        executor=args.executor,
        migration_budget=args.migration_budget,
        replica_budget=args.replica_budget,
        device=args.device)
    base = ds.base_workload()
    svc.bootstrap(base)
    print(f"[{time.time()-t0:5.1f}s] serving {ds.store.n_triples} triples on "
          f"{args.shards} shards (executor={svc.executor.name}, "
          f"device={svc.device})")
    svc.reset_baseline()      # no reference yet: first trigger adapts
    adaptations = 0

    for batch_i in range(args.batches):
        # workload drift: batches 0-3 base-only; 4+ shift to the EQ mix
        drift = min(max((batch_i - 3) / 4, 0.0), 0.9)
        pool_base = [q.name for q in base]
        pool_new = [f"EQ{i}" for i in range(1, 11)]
        names = [pool_new[rng.integers(len(pool_new))] if rng.random() < drift
                 else pool_base[rng.integers(len(pool_base))]
                 for _ in range(args.queries_per_batch)]
        batch_queries = [ds.queries[n] for n in names]

        t_batch = time.perf_counter()
        svc.query_batch(batch_queries)      # one backend batch
        wall = time.perf_counter() - t_batch
        avg_ms = svc.avg_execution_time() * 1e3

        marker = ""
        if svc.session is not None:     # chunked drain in flight: one chunk
            sess = svc.session          # was applied ahead of this batch
            marker = (f"  .. migrating {sess.applied}/{sess.n_chunks} chunks"
                      f" ({sess.bytes_applied / 1e6:.2f} MB)")
        if batch_i >= 1:
            # should_adapt() is False while a drain is in flight, so no
            # caller-side special case is needed to avoid a mid-drain round
            report = svc.maybe_adapt()
            if report is not None and report.accepted:
                adaptations += 1
                marker = (f"  << ADAPTED: dj {report.dj_before:.0f}->"
                          f"{report.dj_after:.0f}, {report.plan.summary()}")
        print(f"[batch {batch_i:2d}] drift={drift:.1f} "
              f"avg={avg_ms:6.1f} ms wall={wall:5.2f}s{marker}")

    print(f"\nserved {args.batches * args.queries_per_batch} queries, "
          f"{adaptations} adaptation(s), final shards: "
          f"{svc.kg.shard_sizes()} "
          f"({svc.kg.view_rebuilds} shard-view rebuilds, "
          f"{len(svc.kg.replicas.replicated())} replicated features, "
          f"{svc.kg.result_hits} result-cache hits)")


if __name__ == "__main__":
    main()
