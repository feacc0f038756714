"""Pluggable partitioning strategies behind one ``Partitioner`` protocol.

Three interchangeable strategies cover the paper's comparison axes:

* ``HashPartitioner``  — workload-oblivious feature hashing (the baseline
  non-workload-aware systems use),
* ``WawPartitioner``   — WawPart-style workload-aware *initial* partition
  ([21] in the paper), no adaptivity,
* ``AWAPartitioner``   — the full adaptive Fig.-5 loop; ``adapt`` prices
  candidate cuts against a live ``PartitionedKG``'s cached query profiles
  instead of re-materializing a ShardedStore and re-executing the workload
  per candidate.
"""
from __future__ import annotations

from typing import Optional, Protocol, Sequence, Tuple, runtime_checkable

from repro_torch.core import migration
from repro_torch.core.adaptive import AdaptConfig, AdaptReport, AWAPartController
from repro_torch.core.features import FeatureSpace
from repro_torch.core.partition import (PartitionState, balanced_partition,
                                  hash_partition)
from repro_torch.migrate import MigrationSession
from repro_torch.query import exec as qexec
from repro_torch.query.pattern import Query

from repro_torch.api.facade import PartitionedKG


@runtime_checkable
class Partitioner(Protocol):
    """Strategy protocol: map (feature space, shard count, workload) to a
    ``PartitionState``; ``device`` is where the strategy's tensor work runs
    (the owning ``KGService`` passes its own). Adaptive strategies
    additionally expose ``adapt(kg, new_queries)`` and a ``controller``."""

    name: str

    def partition(self, space: FeatureSpace, n_shards: int,
                  workload: Sequence[Query] = (), *,
                  device="cuda") -> PartitionState:
        ...


class HashPartitioner:
    """Feature-hash baseline; ignores the workload entirely."""

    name = "hash"

    def __init__(self, seed: int = 0):
        self.seed = seed

    def partition(self, space: FeatureSpace, n_shards: int,
                  workload: Sequence[Query] = (), *,
                  device="cuda") -> PartitionState:
        return hash_partition(space.feature_sizes(), n_shards, self.seed)


class WawPartitioner:
    """Workload-aware initial partition (WawPart [21]): cluster the workload
    once and co-locate each cluster's features; never re-adapts. The
    controller's Jaccard matrix runs on the ``device`` given to
    ``partition``."""

    name = "wawpart"

    def __init__(self, config: AdaptConfig | None = None):
        self.config = config

    def _initial(self, space: FeatureSpace, n_shards: int,
                 workload: Sequence[Query], device,
                 ) -> Tuple[PartitionState, AWAPartController]:
        ctrl = AWAPartController(space, n_shards, self.config, device=device)
        workload = list(workload)
        if not workload:     # nothing to be aware of: balanced round-robin
            ctrl.state = balanced_partition(space.feature_sizes(), n_shards)
            return ctrl.state, ctrl
        space.track_workload(workload)
        return ctrl.initial_partition(workload), ctrl

    def partition(self, space: FeatureSpace, n_shards: int,
                  workload: Sequence[Query] = (), *,
                  device="cuda") -> PartitionState:
        state, _ = self._initial(space, n_shards, workload, device)
        return state


class AWAPartitioner(WawPartitioner):
    """WawPart initial partition + the adaptive Fig.-5 control loop."""

    name = "awapart"

    def __init__(self, config: AdaptConfig | None = None):
        super().__init__(config)
        self.controller: Optional[AWAPartController] = None

    def partition(self, space: FeatureSpace, n_shards: int,
                  workload: Sequence[Query] = (), *,
                  device="cuda") -> PartitionState:
        state, self.controller = self._initial(space, n_shards, workload,
                                               device)
        return state

    def adapt(self, kg: PartitionedKG, new_queries: Sequence[Query] = (),
              net=None, measure=None, bytes_budget: Optional[int] = None,
              ) -> Tuple[MigrationSession, AdaptReport]:
        """One adaptation round against the live facade — returns a
        :class:`MigrationSession` instead of mutating the served layout.

        Each candidate cut is priced via the facade's cached query profiles
        (no joins re-executed, no views touched); the controller's
        migration-cost-aware guard then accepts the winner only if the
        modeled savings amortize the plan's traffic over the expected TM
        window. The round is replica-aware end to end: the live facade's
        ``ReplicaMap`` feeds the controller, which promotes hot features /
        demotes cold replicas under ``config.replica_budget`` and prices
        both the copy traffic (cost) and the nearest-replica shipping
        savings (benefit). Nothing is committed here: the accepted plan
        comes back as a session whose chunks (hottest workload features
        first, each at most ``bytes_budget`` of traffic; ``None`` = one
        chunk) the caller drains while serving. A rejected round returns an
        already-drained noop session. ``measure`` overrides the objective
        (``None`` = modeled workload-average time from the profiles)."""
        assert self.controller is not None, "partition() first"
        ctrl = self.controller
        net_model = net or qexec.NetworkModel()
        if measure is None:
            def measure(cand: PartitionState, replicas=None) -> float:
                return kg.measure_candidate(
                    cand, list(ctrl.workload.values()), net,
                    replicas=replicas)
        state, report = ctrl.adapt(list(new_queries), measure=measure,
                                   net=net_model, replicas=kg.replicas)
        kg.sync_universe()     # align the served universe with the round's
        if not (report.accepted
                and (report.plan.n_moves or report.plan.n_replica_ops)):
            return MigrationSession.noop(kg), report
        heat = report.heat if report.heat is not None else \
            migration.feature_heat(ctrl.space, list(ctrl.workload.values()))
        # the session's delta is derived from the *live* facade state (which
        # may be a mid-drain hybrid), so draining always lands exactly on the
        # accepted target — report.plan stays the guard's priced plan
        session = MigrationSession(kg, state, bytes_budget=bytes_budget,
                                   priority=heat, net=net_model,
                                   target_replicas=report.replicas)
        return session, report
