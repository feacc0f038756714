"""Compatibility layer over the planner/executor split.

The query engine now lives in two modules:

* ``repro_torch.query.plan`` — the ``QueryPlan`` IR (``plan(q, stats_source)``),
  PPN selection, and layout-invariant ``QueryProfile`` pricing;
* ``repro_torch.query.exec`` — the ``Executor`` protocol with the
  ``NumpyExecutor`` reference backend and the batched ``TorchExecutor``.

This module keeps :class:`ShardedStore` (per-shard views materialized from a
``PartitionState``) plus **deprecated** thin shims for the retired
free-function entry points (``execute`` / ``run_workload`` /
``workload_average_time`` / ``profile_query`` / ``stats_from_profile``).
The shims delegate to the new surface and warn; they will be removed after
one release. In-repo code must not call them (enforced by ``scripts/ci.sh``).
Like the free functions they replace, every shim runs the numpy reference
executor (``exec.run_workload`` itself defaults to the torch executor on
the card, so the shims name ``"numpy"``).
"""
from __future__ import annotations

import warnings
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.core.features import FeatureSpace
from repro_torch.core.partition import PartitionState
from repro_torch.graph.triples import TripleStore
from repro_torch.query import exec as qexec
from repro_torch.query import plan as qplan
from repro_torch.query.pattern import Query

# canonical homes are repro_torch.query.exec / repro_torch.query.plan; re-exported here
# for backward compatibility
ExecStats = qexec.ExecStats
NetworkModel = qexec.NetworkModel
QueryProfile = qplan.QueryProfile
_primary_shard = qplan.primary_shard


class ShardedStore:
    """Per-shard TripleStores materialized from a PartitionState."""

    def __init__(self, store: TripleStore, space: FeatureSpace,
                 state: PartitionState, owners: np.ndarray | None = None):
        self.store = store
        self.space = space
        self.state = state
        owners = space.triple_owners() if owners is None else owners
        self.triple_shard = state.triple_shards(owners).astype(np.int32)
        self.shards: List[TripleStore] = []
        for s in range(state.n_shards):
            sel = self.triple_shard == s
            self.shards.append(TripleStore(store.triples[sel],
                                           store.dictionary))

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    def shard_sizes(self) -> List[int]:
        return [sh.n_triples for sh in self.shards]


def _deprecated(old: str, new: str) -> None:
    warnings.warn(f"repro_torch.query.engine.{old} is deprecated; use {new} "
                  "(see docs/api.md, 'Plans and executors')",
                  DeprecationWarning, stacklevel=3)


def execute(q: Query, sharded, net: NetworkModel | None = None,
            ) -> Tuple[Dict[int, np.ndarray], ExecStats]:
    """Deprecated: plan once, then run an executor.

    ``net`` was accepted but never read; ``NetworkModel`` lives solely in
    ``ExecStats.modeled_time`` now."""
    _deprecated("execute", "plan.plan(q, kg) + exec.NumpyExecutor().run")
    return qexec.NumpyExecutor().run(qplan.plan(q, sharded), sharded)


def run_workload(queries: Sequence[Query], sharded,
                 net: NetworkModel | None = None,
                 ) -> Tuple[Dict[str, float], Dict[str, ExecStats]]:
    """Deprecated: use ``exec.run_workload`` (or ``KGService.query_batch``)."""
    _deprecated("run_workload", "exec.run_workload / KGService.query_batch")
    return qexec.run_workload(queries, sharded, "numpy", net=net)


def workload_average_time(queries: Sequence[Query], sharded,
                          net: NetworkModel | None = None) -> float:
    """Deprecated: use ``exec.workload_average_time``."""
    _deprecated("workload_average_time", "exec.workload_average_time")
    return qexec.workload_average_time(queries, sharded, "numpy", net=net)


def profile_query(q: Query, store: TripleStore) -> QueryProfile:
    """Deprecated: profiles are derived from plans now."""
    _deprecated("profile_query", "exec.profile_from_plan(plan.plan(q, store))")
    return qexec.profile_from_plan(qplan.plan(q, store), store)


def stats_from_profile(q: Query, prof: QueryProfile, space: FeatureSpace,
                       state: PartitionState,
                       triple_shard: np.ndarray) -> ExecStats:
    """Deprecated: use ``plan.stats_from_profile``."""
    _deprecated("stats_from_profile", "plan.stats_from_profile")
    return qplan.stats_from_profile(q, prof, space, state, triple_shard)
