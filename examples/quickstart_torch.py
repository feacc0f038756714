"""Quickstart on the PyTorch port: partition a knowledge graph, query it,
adapt to the workload.

Everything goes through the public ``repro_torch.api`` surface: a
``Partitioner`` strategy (hash / wawpart / awapart, interchangeable), the
``KGService`` session loop with a pluggable ``Executor`` backend (the
batched torch executor, its joins on the card's Hopper kernels, or the
numpy reference), and the ``PartitionedKG`` facade whose shard views and
cached query plans update incrementally when the partition adapts.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.api import HashPartitioner, KGService, NumpyExecutor
from repro_torch.graph import lubm
from repro_torch.query import rewrite

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                help="where the torch executor and the Jaccard matrix run")
ap.add_argument("--universities", type=int, default=2)
args = ap.parse_args()

# 1. a small LUBM knowledge graph (2 universities, ~300k triples)
ds = lubm.load(args.universities, seed=0)
print(f"knowledge graph: {ds.store.n_triples} triples, "
      f"{len(ds.queries)} benchmark queries")

# 2. workload-aware adaptive partition over 4 shards (default strategy),
#    served by the torch executor on the chosen device
svc = KGService.from_dataset(ds, n_shards=4, device=args.device)
base = ds.base_workload()               # LUBM Q1..Q14
kg = svc.bootstrap(base)
print(f"shards: {kg.shard_sizes()} (imbalance {kg.imbalance():.2f}, "
      f"strategy={svc.partitioner.name}, executor={svc.executor.name} on "
      f"{svc.device})")

# 3. run a query — planned once per (query, store), federated across shards,
#    runtime recorded by the service
q9 = ds.queries["Q9"]
bindings, stats = svc.query(q9)
print(f"\nQ9 -> {stats.rows} rows, {stats.distributed_joins} distributed "
      f"joins, {stats.bytes_shipped / 1e3:.1f} KB shipped")
print("\nits QueryPlan IR:")
print(kg.plan(q9).explain())
print("\nfederated rewrite of Q9:")
print(rewrite.federated_sparql(q9, svc.space, kg.state, ds.dictionary,
                               replicas=kg.replicas))

# 4. the workload changes: 10 new queries arrive -> adapt incrementally
new_queries = ds.workload([f"EQ{i}" for i in range(1, 11)])
times0, _ = svc.run_workload(new_queries)

report = svc.adapt(new_queries)
print(f"\nadaptation: accepted={report.accepted}, "
      f"{report.n_clusters} query clusters, distributed joins "
      f"{report.dj_before:.0f} -> {report.dj_after:.0f}, "
      f"{report.plan.summary()}")

times1, _ = svc.run_workload(new_queries)   # same facade, views updated
avg0 = np.mean(list(times0.values())) * 1e3
avg1 = np.mean(list(times1.values())) * 1e3
print(f"new-query avg runtime: {avg0:.1f} ms -> {avg1:.1f} ms "
      f"({(1 - avg1 / avg0) * 100:+.1f}%)")

# 5. strategies are pluggable: same service loop, hash baseline
hash_svc = KGService.from_dataset(ds, n_shards=4,
                                  partitioner=HashPartitioner(),
                                  device=args.device)
hash_svc.bootstrap()
t_hash = hash_svc.workload_average_time(new_queries) * 1e3
print(f"hash-partition baseline on the new queries: {t_hash:.1f} ms")

# 6. executors are pluggable too: the torch backend runs a whole workload
#    window as one batch (same bindings and stats as the numpy reference,
#    which runs the plans one at a time)
window = ds.extended_workload()
plans = [kg.plan(q) for q in window]
t0 = time.perf_counter()
per_query = [NumpyExecutor().run(p, kg) for p in plans]
wall_np = time.perf_counter() - t0
svc.executor.run_batch(plans, kg)                 # warm-up (kernel build)
t0 = time.perf_counter()
batched = svc.executor.run_batch(plans, kg)       # torch, one batch
if svc.device.type == "cuda":
    torch.cuda.synchronize()
wall_t = time.perf_counter() - t0
assert all(a[1].rows == b[1].rows for a, b in zip(per_query, batched))
print(f"\nworkload window x{len(window)}: numpy per-query {wall_np*1e3:.0f} "
      f"ms -> torch batch on {svc.device} {wall_t*1e3:.0f} ms "
      f"({wall_np / max(wall_t, 1e-9):.1f}x)")
