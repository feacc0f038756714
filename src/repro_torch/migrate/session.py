"""MigrationSession — chunked, serving-friendly application of an accepted
migration (AdPart/xDGP-style incremental redistribution).

An accepted adaptation round no longer commits its ``MigrationPlan``
atomically. Instead it becomes a session: the plan is split into prioritized
``MigrationChunk``s (hottest workload features first, each bounded by a
per-step ``bytes_budget``) and each ``step()`` applies exactly one chunk to
the live ``PartitionedKG`` as an incremental delta. Between steps the facade
serves a consistent *hybrid* layout — some features already at their target
shard, the rest still at the source — which is a first-class epoch: queries
return exactly the same bindings as under any other layout (only federation
stats differ), cached plans are invalidated per epoch, and only the shards a
chunk actually touches are re-indexed.

    session, report = partitioner.adapt(kg, new_queries)   # nothing moved yet
    while not session.done:
        serve_a_window_of_queries()
        session.step()                  # one bounded chunk of migration I/O
    # kg.state is now byte-identical to the accepted target layout

``KGService`` owns the session lifecycle (``svc.step()`` / ``svc.drain()``,
interleaved with ``query_batch`` windows under the ``migration_budget``
knob); this module is the mechanism.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from repro_torch.core import migration
from repro_torch.core.partition import PartitionState


class MigrationSession:
    """Drains one accepted ``MigrationPlan`` into a live ``PartitionedKG``
    in bounded chunks.

    Parameters
    ----------
    kg : PartitionedKG
        The live facade (its universe must already match ``target`` — the
        partitioner calls ``kg.sync_universe()`` before building a session).
    target : PartitionState
        The accepted destination layout; after ``drain()`` the facade's
        state is exactly this.
    plan : MigrationPlan, optional
        The delta to apply (derived from ``kg.state`` vs ``target`` when
        omitted).
    bytes_budget : int, optional
        Per-step migration-traffic bound; ``None`` = unbounded (one chunk —
        the old atomic commit).
    priority : np.ndarray, optional
        Per-feature heat (see ``migration.feature_heat``); hottest features
        migrate in the earliest chunks.
    net : NetworkModel-like, optional
        Used by ``step_seconds``/``total_seconds`` to price chunk traffic.
    target_replicas : ReplicaMap, optional
        The accepted destination replica layout (``repro_torch.replicate``).
        Promotions/demotions ride the same chunks as moves — copy traffic
        drains under the same budget — and after ``drain()`` the facade's
        ``ReplicaMap`` equals this exactly.
    """

    def __init__(self, kg, target: PartitionState,
                 plan: Optional[migration.MigrationPlan] = None, *,
                 bytes_budget: Optional[int] = None,
                 priority: Optional[np.ndarray] = None,
                 net=None, target_replicas=None):
        self.kg = kg
        self.target = target
        self.target_replicas = target_replicas
        self.plan = plan if plan is not None \
            else migration.plan(kg.state, target,
                                getattr(kg, "replicas", None)
                                if target_replicas is not None else None,
                                target_replicas)
        self.net = net
        budget = self.plan.bytes if bytes_budget is None else bytes_budget
        self.chunks: List[migration.MigrationChunk] = migration.chunk_plan(
            self.plan, target.feature_sizes, budget, priority)
        self.applied = 0
        self.bytes_applied = 0
        # epoch trail: facade epoch at session start and after every step —
        # every entry is a layout the session actually served
        self.epochs: List[int] = [kg.epoch]

    @classmethod
    def noop(cls, kg) -> "MigrationSession":
        """An already-drained session (rejected round / nothing to move)."""
        return cls(kg, kg.state, migration.MigrationPlan([], 0, 0))

    # ------------------------------------------------------------------ #
    @property
    def n_chunks(self) -> int:
        return len(self.chunks)

    @property
    def done(self) -> bool:
        return self.applied >= len(self.chunks)

    @property
    def remaining_bytes(self) -> int:
        return self.plan.bytes - self.bytes_applied

    def progress(self) -> float:
        """Fraction of migration traffic already applied, in [0, 1]."""
        return 1.0 if self.plan.bytes == 0 \
            else self.bytes_applied / self.plan.bytes

    def peek(self) -> Optional[migration.MigrationChunk]:
        """The chunk the next ``step()`` would apply (``None`` when drained)
        — without applying it. The streaming drainer (``repro_torch.stream``) uses
        this to size the stall it is about to interleave into an idle gap
        before committing to it."""
        return None if self.done else self.chunks[self.applied]

    # ------------------------------------------------------------------ #
    def step(self) -> Optional[migration.MigrationChunk]:
        """Apply the next chunk as an incremental delta on the facade.
        Returns the applied chunk, or ``None`` when already drained. After
        the final step the facade's layout equals ``target`` exactly."""
        if self.done:
            return None
        chunk = self.chunks[self.applied]
        self.kg.apply_chunk(chunk)
        self.applied += 1
        self.bytes_applied += chunk.bytes
        self.epochs.append(self.kg.epoch)
        m = getattr(self.kg, "metrics", None)
        if m is not None:           # repro_torch.obs: drain progress counters
            m.counter("migrate.chunks").inc()
            m.counter("migrate.bytes").inc(chunk.bytes)
            m.counter("migrate.moved_triples").inc(chunk.n_triples)
            m.gauge("migrate.progress").set(self.progress())
        if self.done:
            # compare the target's universe only: live writes during the
            # drain may have grown the feature universe (repro_torch.write), and
            # write-born features stay wherever the write path placed them
            # — the session owns exactly the features its target knows
            nf = len(self.target.feature_to_shard)
            assert np.array_equal(self.kg.state.feature_to_shard[:nf],
                                  self.target.feature_to_shard), \
                "drained session must land exactly on the target layout"
            assert self.target_replicas is None or np.array_equal(
                self.kg.replicas.masks[:len(self.target_replicas.masks)],
                self.target_replicas.masks), \
                "drained session must land exactly on the target replicas"
        return chunk

    def drain(self) -> int:
        """Apply every remaining chunk; returns how many were applied."""
        n = 0
        while self.step() is not None:
            n += 1
        return n

    # ------------------------------------------------------------------ #
    def step_seconds(self, chunk: migration.MigrationChunk) -> float:
        """Modeled traffic time of one chunk under the session's net model."""
        return migration.migration_seconds(chunk, self._net())

    def total_seconds(self) -> float:
        """Modeled traffic time of the whole plan (the atomic-commit spike
        a chunked drain spreads across windows)."""
        return migration.migration_seconds(self.plan, self._net())

    def _net(self):
        if self.net is None:
            from repro_torch.query.exec import NetworkModel
            self.net = NetworkModel()
        return self.net

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"MigrationSession({self.applied}/{self.n_chunks} chunks, "
                f"{self.bytes_applied}/{self.plan.bytes} bytes, "
                f"epoch={self.kg.epoch})")
