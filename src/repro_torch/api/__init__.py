"""repro_torch.api — the public partitioning-service surface.

Everything callers need to serve a partitioned knowledge graph:

* strategies: :class:`Partitioner` protocol with :class:`HashPartitioner`,
  :class:`WawPartitioner`, :class:`AWAPartitioner`;
* :class:`PartitionedKG` — shard-view facade with incremental delta updates
  and the per-``(query, store)`` plan cache;
* :class:`KGService` — the Fig.-6 session loop (``bootstrap / query /
  query_batch / observe / maybe_adapt / step / drain / reset_baseline``);
* :class:`MigrationSession` — chunked online application of an accepted
  migration (``repro_torch.migrate``), throttled by the service's
  ``migration_budget`` knob;
* :class:`ReplicaMap` — workload-aware read replication of hot features
  (``repro_torch.replicate``), budgeted by the service's ``replica_budget`` knob;
* :class:`WriteBatch` / :class:`WriteReport` — the live write path
  (``repro_torch.write``): ``svc.insert(...)`` / ``svc.delete(...)`` served
  concurrently with queries, replication, and an in-flight drain;
* :class:`StreamService` / :class:`LatencyRecorder` — continuous
  admission (``repro_torch.stream``): ``svc.stream()`` serves submitted
  queries/writes in pipelined windows, byte-identical to ``query_batch``
  over the same admission order, with p50/p95/p99 tail telemetry on
  ``svc.stats()``;
* executors: :class:`Executor` protocol with :class:`NumpyExecutor`
  (reference) and :class:`TorchExecutor` (batched on a torch device; its
  joins run through the ``repro_torch.kernels.join`` Hopper kernels on the
  card), re-exported from ``repro_torch.query.exec``;
* observability: :class:`Tracer` / :class:`MetricsRegistry`
  (``repro_torch.obs``) — ``KGService(trace=True)`` records per-query
  plan→scan→join→federate→ship spans plus window / migration-chunk /
  write-batch / adaptation-round spans on the modeled clock
  (``svc.tracer().export("out.json")`` is Perfetto-loadable), and every
  service folds its metrics snapshot into ``stats()["metrics"]``.

See ``docs/api.md`` for the quickstart.
"""
from repro_torch.api.facade import PartitionedKG
from repro_torch.api.partitioners import (AWAPartitioner, HashPartitioner,
                                    Partitioner, WawPartitioner)
from repro_torch.api.service import KGService
from repro_torch.migrate import MigrationSession
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.query.exec import Executor, NumpyExecutor, TorchExecutor
from repro_torch.replicate import ReplicaMap
from repro_torch.stream import LatencyRecorder, StreamService
from repro_torch.write import WriteBatch, WriteLog, WriteReport

__all__ = [
    "AWAPartitioner",
    "Executor",
    "HashPartitioner",
    "KGService",
    "LatencyRecorder",
    "MetricsRegistry",
    "MigrationSession",
    "NumpyExecutor",
    "PartitionedKG",
    "Partitioner",
    "ReplicaMap",
    "StreamService",
    "TorchExecutor",
    "Tracer",
    "WawPartitioner",
    "WriteBatch",
    "WriteLog",
    "WriteReport",
]
