"""AWAPartController — the complete Fig.-5 adaptive partitioning loop.

Pipeline per adaptation round (Sec. III.B, Fig. 5):
  1. merge new queries + frequencies into the workload (line 1),
  2. record the baseline average execution time T_base (line 2),
  3. extract features of the new queries (line 3) — newly-seen constant-object
     patterns become tracked PO features (ownership split, no data movement),
  4. Jaccard distance matrix over query bitmaps -> HAC -> query clusters at
     similarity distance d -> feature groups g (lines 4-5),
  5. score every key feature against every shard (lines 7-12) and assign the
     single copy to the argmax-score shard (line 14),
  6. proximity-assign unclustered features; bin-pack the rest for balance
     (lines 13, 16-23),
  7. measure T_new; accept the new partition only if it improves, else revert
     (lines 24-27).

The Jaccard matrix of step 4 runs on the controller's ``device``: the
Hopper kernel on a CUDA device, its plain PyTorch version on the CPU, both
bitwise equal to the reference. HAC stays on the host (``hac_numpy``).
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import hac, migration
from repro_torch.core.features import FeatureSpace
from repro_torch.core.partition import (PartitionState, balanced_partition,
                                  greedy_balance)
from repro_torch.core.scoring import (ScoreWeights, WorkloadStats,
                                distributed_joins, score_matrix,
                                workload_stats)
from repro_torch.kernels import dispatch
from repro_torch.kernels.jaccard import ops as jaccard_ops
from repro_torch.query.pattern import Query


@dataclasses.dataclass
class AdaptConfig:
    linkage: str = "single"          # the paper runs single linkage on LUBM
    cut_distance: float = 0.75       # initial partition: the paper-style manual dendrogram pick
    # beyond-paper: the right cut is workload-dependent (the paper reads it
    # off the dendrogram by hand); we extend the paper's own accept/revert
    # guard to SELECT it — each candidate cut yields a candidate partition,
    # the measured objective picks the winner, and the guard still protects
    # against regression. Empty tuple = single fixed cut_distance.
    cut_candidates: tuple = (0.45, 0.6, 0.75, 0.9)
    balance_tolerance: float = 1.15
    weights: ScoreWeights = dataclasses.field(default_factory=ScoreWeights)
    adapt_threshold: float = 1.25    # adapt when avg time degrades by 25%
    # migration-cost-aware accept guard: expected number of query executions
    # in the next TM window, over which the per-query savings must amortize
    # the migration traffic. None = estimate from the TM (observed execution
    # count, floored at the workload's total frequency).
    amortize_window: Optional[int] = None
    # read-replication budget (bytes of non-primary copies, repro_torch.replicate):
    # each round promotes the hottest workload features onto the PPNs that
    # read them remotely and demotes replicas that fell cold, greedy under
    # this cap. Copy traffic counts toward the guard's migration cost;
    # replica-served shipping savings count toward its benefit. 0 = off.
    replica_budget: int = 0
    # write-rate term (repro_torch.write): every extra replica copy of a feature
    # written w times per TM window costs w triple-payloads of recurring
    # fanout traffic per window. The accept guard adds that per-window
    # fanout delta (current map vs proposed map, priced at the network
    # bandwidth and scaled by this weight) to the benefit side, and the
    # replica proposal penalizes hot-written candidates by the same weight
    # — so a hot-written feature becomes cheaper to demote than to keep
    # replicated. 0 disables write-fanout pricing.
    write_cost_weight: float = 1.0
    # write-heat drift trigger (repro_torch.stream): should_adapt
    # fires on data drift alone — no query-time degradation needed — when
    # some feature accumulated at least ``write_drift_min_rows`` fresh rows
    # this TM window AND that fresh heat is at least ``write_drift_ratio``
    # of the feature's current size (churn comparable to the feature
    # itself). A round (accepted or not) consumes the signal, so a rejected
    # round cannot re-trigger on the same writes. min_rows <= 0 disables.
    write_drift_ratio: float = 0.5
    write_drift_min_rows: int = 64


@dataclasses.dataclass
class AdaptReport:
    accepted: bool
    plan: migration.MigrationPlan
    dj_before: float
    dj_after: float
    t_base: Optional[float] = None
    t_new: Optional[float] = None
    n_clusters: int = 0
    chosen_cut: float = 0.0
    migration_s: float = 0.0         # modeled traffic time of the plan
    amortize_window: int = 0         # TM window the guard amortized over
    replicas: Optional[object] = None  # accepted target ReplicaMap (or None)
    replica_bytes: int = 0           # non-primary copy bytes under the target
    # expected replica write-fanout traffic per TM window (bytes) under the
    # layout the round returned — observed write heat x extra copies
    fanout_bytes: int = 0
    # why the guard accepted/rejected: "amortized" (savings paid for the
    # migration), "improved" (t_new < t_base, no traffic to price),
    # "unamortized" (gain too small for the journey), "no_gain",
    # "dj_improved"/"dj_no_gain" (measureless distributed-join guard)
    reason: str = ""
    # per-feature workload heat of this round (repr-suppressed array) — the
    # chunk priority, computed once here and reused when the session is built
    heat: Optional[np.ndarray] = dataclasses.field(default=None, repr=False)


def _accepts_replicas(measure: Callable) -> bool:
    """Can ``measure`` price a replicated candidate — i.e. accept a
    keyword ``replicas`` argument? Custom objectives without one predate
    replication and must keep working (the round then prices primary-only
    and leaves the served replicas untouched). Detection is by parameter
    *name* and the argument is always passed by keyword, so an unrelated
    second positional parameter never receives a ReplicaMap."""
    try:
        params = inspect.signature(measure).parameters
    except (TypeError, ValueError):       # builtins/C callables: assume yes
        return True
    if any(p.kind is p.VAR_KEYWORD for p in params.values()):
        return True
    p = params.get("replicas")
    return p is not None and p.kind in (p.POSITIONAL_OR_KEYWORD,
                                        p.KEYWORD_ONLY)


class AWAPartController:
    """Master-node control plane: QAFE + PM + HAC + PMeta (Fig. 6)."""

    def __init__(self, space: FeatureSpace, n_shards: int,
                 config: AdaptConfig | None = None, *, device="cuda"):
        self.space = space
        self.n_shards = n_shards
        self.config = config or AdaptConfig()
        self.device = dispatch.resolve_device(device)   # Jaccard runs here
        self.workload: Dict[str, Query] = {}
        self.exec_times: Dict[str, List[float]] = {}     # TM metadata
        self.state: Optional[PartitionState] = None
        self._baseline_avg: Optional[float] = None
        # per-feature write touches this TM window (repro_torch.write): the
        # data-drift signal — feeds the guard's fanout pricing and the
        # replica proposal's demotion penalty; cleared with the window
        self.write_heat = np.zeros(space.n_features, dtype=np.float64)
        # write heat already consumed by an adaptation round this window —
        # a rejected round marks its heat seen instead of clearing it (the
        # fanout pricing still wants the full window's heat), so the drift
        # trigger only ever fires on writes no round has judged yet
        self._drift_seen = np.zeros(space.n_features, dtype=np.float64)

    # ------------------------------------------------------------------ #
    # workload bookkeeping (QAFE + TM)
    # ------------------------------------------------------------------ #
    def observe(self, query: Query, runtime: float) -> None:
        self.workload[query.name] = query
        self.exec_times.setdefault(query.name, []).append(runtime)

    def avg_execution_time(self) -> float:
        """Fig.-5 line 2: mean over queries of their mean runtime."""
        per_q = [np.mean(v) for v in self.exec_times.values() if v]
        return float(np.mean(per_q)) if per_q else 0.0

    def should_adapt(self) -> bool:
        # data drift alone is a trigger: a churn-hot feature no longer waits
        # for the next query-driven degradation to relocate (repro_torch.write
        # feeds the heat, the round's fanout pricing + chunk priority
        # consume it)
        if self.write_drift():
            return True
        # no baseline yet: adapt on the first *observed* degradation signal —
        # an empty TM (fresh session, zero queries served) must not trigger a
        # pointless round
        if self._baseline_avg is None:
            return any(self.exec_times.values())
        cur = self.avg_execution_time()
        return cur > self.config.adapt_threshold * self._baseline_avg

    def write_drift(self) -> bool:
        """True when some feature's *fresh* write heat (rows written this
        TM window and not yet judged by a round) clears both drift
        thresholds: at least ``write_drift_min_rows`` rows, and at least
        ``write_drift_ratio`` of the feature's current size."""
        cfg = self.config
        min_rows = int(getattr(cfg, "write_drift_min_rows", 0) or 0)
        if min_rows <= 0 or self.state is None or not len(self.write_heat):
            return False
        wh = self.write_heat
        seen = self._drift_seen
        if len(seen) < len(wh):
            seen = np.pad(seen, (0, len(wh) - len(seen)))
        fresh = wh - seen
        hot = fresh >= min_rows
        if not hot.any():
            return False
        sizes = self.state.feature_sizes.astype(np.float64)
        if len(sizes) < len(wh):
            sizes = np.pad(sizes, (0, len(wh) - len(sizes)))
        ratio = float(getattr(cfg, "write_drift_ratio", 0.0))
        return bool((hot & (fresh >= ratio * np.maximum(sizes[:len(wh)],
                                                        1.0))).any())

    def reset_baseline(self, value: Optional[float] = None) -> None:
        """Set (or clear, with None) the T_base reference of Fig.-5 line 2.

        Clearing forces the next ``should_adapt`` to fire; setting it to the
        post-migration average starts a fresh monitoring window."""
        self._baseline_avg = value

    def clear_window(self) -> None:
        """Restart the TM window: runtime observations and write heat both
        describe exactly one serving window, so whoever restarts the window
        (accepted round, finished drain) clears them together."""
        self.exec_times.clear()
        if len(self.write_heat):
            self.write_heat[:] = 0.0
        if len(self._drift_seen):
            self._drift_seen[:] = 0.0

    def note_writes(self, report) -> None:
        """Fold an applied ``repro_torch.write.WriteReport`` into this window's
        data-drift signal.

        Features born on the write path (new predicates / new ``rdf:type``
        classes) join the tracked state at the placement the facade chose —
        keeping ``self.state`` aligned with the grown universe so the next
        round's ``extend_for_space`` and migration planning stay
        length-consistent. Each written feature's heat accumulates the rows
        written; sizes are re-derived from the space at round time."""
        if self.state is not None:
            for fid, _key, shard in report.new_features:
                if fid == len(self.state.feature_to_shard):
                    self.state = PartitionState(
                        np.append(self.state.feature_to_shard,
                                  np.int32(shard)),
                        np.append(self.state.feature_sizes, np.int64(0)),
                        self.state.n_shards)
        if len(self.write_heat) < self.space.n_features:
            self.write_heat = np.pad(
                self.write_heat,
                (0, self.space.n_features - len(self.write_heat)))
        for f, c in report.feature_writes.items():
            if f < len(self.write_heat):
                self.write_heat[f] += c

    # ------------------------------------------------------------------ #
    # clustering (lines 4-5)
    # ------------------------------------------------------------------ #
    def cluster_queries(self, queries: Sequence[Query],
                        cut: Optional[float] = None) -> np.ndarray:
        bitmaps = self.space.workload_bitmaps(queries)
        dist = jaccard_ops.jaccard_distance(
            bitmaps, device=self.device).cpu().numpy()
        z = hac.hac_numpy(dist, self.config.linkage)
        return hac.cut(z, cut if cut is not None
                       else self.config.cut_distance)

    def feature_groups(self, queries: Sequence[Query],
                       labels: np.ndarray) -> List[np.ndarray]:
        groups = []
        for lbl in np.unique(labels):
            feats: set = set()
            for q, l in zip(queries, labels):
                if l == lbl:
                    feats.update(self.space.query_features(q).tolist())
            groups.append(np.array(sorted(feats), dtype=np.int32))
        return groups

    # ------------------------------------------------------------------ #
    # assignment (lines 7-23)
    # ------------------------------------------------------------------ #
    def _assign(self, queries: Sequence[Query], base: PartitionState,
                cut: Optional[float] = None,
                ) -> Tuple[PartitionState, WorkloadStats, int]:
        """Lines 6–23: place feature groups (query clusters) as units, under a
        hard balance cap; oversized groups degrade to per-feature placement."""
        stats = workload_stats(queries, self.space)
        new = base.copy()
        labels = self.cluster_queries(queries, cut)
        groups = self.feature_groups(queries, labels)
        sizes = new.feature_sizes.astype(np.int64)
        total = max(int(sizes.sum()), 1)
        cap = self.config.balance_tolerance * total / self.n_shards

        # resolve feature->group overlaps by frequency weight of the cluster
        feat_group: Dict[int, int] = {}
        gweight = np.zeros(len(groups))
        for gi, lbl in enumerate(np.unique(labels)):
            gweight[gi] = sum(q.frequency for q, l in zip(queries, labels)
                              if l == lbl)
        for gi in np.argsort(-gweight).tolist():
            for f in groups[gi].tolist():
                feat_group.setdefault(f, gi)
        members = [np.array([f for f, g in feat_group.items() if g == gi],
                            dtype=np.int64) for gi in range(len(groups))]

        # loads excluding the features we are about to (re)place
        key_set = np.zeros(len(sizes), bool)
        key_set[list(feat_group.keys())] = True
        loads = np.bincount(new.feature_to_shard[~key_set],
                            weights=sizes[~key_set],
                            minlength=self.n_shards).astype(np.float64)

        ki_of = {int(k): i for i, k in enumerate(stats.key_features)}
        # place heaviest (size × frequency) groups first
        order = np.argsort(-(np.array([sizes[m].sum() for m in members])
                             * np.maximum(gweight, 1e-9)))
        for gi in order.tolist():
            mem = members[gi]
            if len(mem) == 0:
                continue
            scores = score_matrix(stats, new, self.config.weights)
            gsize = float(sizes[mem].sum())
            rows = [ki_of[int(f)] for f in mem if int(f) in ki_of]
            gscore = (scores[rows].sum(0) if rows
                      else np.zeros(self.n_shards))
            fits = loads + gsize <= cap
            if fits.any():          # group placed as a unit
                cand = np.where(fits, gscore, -np.inf)
                dst = int(np.argmax(cand))
                new.feature_to_shard[mem] = dst
                loads[dst] += gsize
            else:                    # oversized: per-feature, big first
                for f in mem[np.argsort(-sizes[mem])].tolist():
                    fs = float(sizes[f])
                    row = (scores[ki_of[int(f)]] if int(f) in ki_of
                           else np.zeros(self.n_shards))
                    ok = loads + fs <= cap
                    dst = (int(np.argmax(np.where(ok, row, -np.inf)))
                           if ok.any() else int(np.argmin(loads)))
                    new.feature_to_shard[f] = dst
                    loads[dst] += fs
        # proximity + balance for non-workload features (lines 16-23)
        movable = np.arange(len(sizes))[~key_set]
        greedy_balance(new, movable, self.config.balance_tolerance)
        return new, stats, len(groups)

    # ------------------------------------------------------------------ #
    # public API
    # ------------------------------------------------------------------ #
    def initial_partition(self, queries: Sequence[Query]) -> PartitionState:
        """WawPart-style initial workload-aware partition ([21])."""
        for q in queries:
            self.workload[q.name] = q
        # start from round-robin by size (balanced, workload-agnostic) ...
        base = balanced_partition(self.space.feature_sizes(), self.n_shards)
        # ... then pull workload features together
        state, _, _ = self._assign(list(self.workload.values()), base)
        self.state = state
        return state

    def _expected_window(self, queries: Sequence[Query]) -> int:
        """Expected query executions in the next TM window — what the
        migration-cost guard amortizes the plan's traffic over. Configured
        (``amortize_window``) or estimated: the observed TM execution count,
        floored at the workload's total frequency (every workload query runs
        at least once per window)."""
        if self.config.amortize_window is not None:
            return int(self.config.amortize_window)
        observed = sum(len(v) for v in self.exec_times.values())
        expected = sum(q.frequency for q in queries)
        return int(max(observed, expected))

    def adapt(self, new_queries: Sequence[Query],
              measure: Optional[Callable[[PartitionState], float]] = None,
              net=None, replicas=None) -> Tuple[PartitionState, AdaptReport]:
        """One Fig.-5 adaptation round. ``measure`` returns the average
        workload execution time under a candidate partition (used for the
        accept/revert guard); if None, the frequency-weighted distributed
        join count is the guard objective.

        The line-24 guard is migration-cost-aware when ``net`` (a
        ``NetworkModel``-like object) is given alongside ``measure``: the
        destination layout is accepted only if the modeled per-query savings,
        amortized over the expected TM window (``_expected_window``), pay for
        shipping ``plan.bytes`` of migration traffic — pricing the *journey*,
        not just the destination.

        ``replicas`` (the live ``repro_torch.replicate.ReplicaMap``) switches the
        round replica-aware: the winning layout gets a fresh replica proposal
        (hottest features promoted under ``config.replica_budget``, cold
        replicas demoted), ``measure`` is called as ``measure(cand, rmap)``
        to price the replicated destination, and the plan's bytes include
        the copy traffic — so the guard weighs replica cost against
        replica-served savings. The accepted target map is returned as
        ``report.replicas``."""
        assert self.state is not None, "call initial_partition first"
        cfg = self.config
        if replicas is not None and measure is not None \
                and not _accepts_replicas(measure):
            replicas = None       # replica-unaware custom objective: price
            #                       primary-only, leave served copies alone
        for q in new_queries:                        # line 1
            self.workload[q.name] = q
        queries = list(self.workload.values())

        # line 2 — T_base under the layout actually being served (including
        # its current read replicas, if any)
        t_base = None
        if measure:
            t_base = (measure(self.state, replicas=replicas)
                      if replicas is not None and replicas.has_replicas
                      else measure(self.state))
        self._baseline_avg = t_base if t_base is not None else self._baseline_avg

        # line 3: track new PO features; ownership split grows the universe
        self.space.track_workload(queries)
        cur, _ = migration.extend_for_space(self.state, self.space)
        if replicas is not None:
            # plan over the grown universe: new (split) PO features start
            # primary-only on their inherited shard, like the facade's view
            replicas = replicas.copy()
            replicas.extend(cur.feature_to_shard)

        # lines 4-23, once per candidate cut; the measured objective picks
        # the winning candidate (beyond-paper extension of the line-24 guard)
        cuts = self.config.cut_candidates or (self.config.cut_distance,)
        best = None
        for cut in cuts:
            cand, stats, ncl = self._assign(queries, cur, cut=cut)
            obj = measure(cand) if measure else distributed_joins(stats, cand)
            if best is None or obj < best[0]:
                best = (obj, cand, stats, cut, ncl)
        obj_new, new, stats, chosen_cut, n_clusters = best

        # per-feature workload heat over the grown universe: the replica
        # promotion order here AND the session's chunk priority (via the
        # report) — computed exactly once per round
        heat = migration.feature_heat(self.space, queries)

        # write heat over the grown universe (repro_torch.write): rows written to
        # each feature this TM window, scaled by the config's write-rate
        # weight — priced wherever a replica copy would have to receive them
        wh = self.write_heat
        if len(wh) < self.space.n_features:
            wh = np.pad(wh, (0, self.space.n_features - len(wh)))
        wh = wh * float(getattr(cfg, "write_cost_weight", 1.0))

        def _fanout_bytes(rmap) -> int:
            """Expected per-window write-fanout traffic under a replica map:
            every extra copy of a feature receives its writes too."""
            if rmap is None or not rmap.has_replicas or not wh.any():
                return 0
            extra = np.maximum(rmap.n_copies() - 1, 0)
            return int((extra * wh[:len(extra)]).sum()
                       * migration.TRIPLE_BYTES)

        # replica promotion/demotion for the winning layout: hottest
        # workload features onto their remote readers' PPNs, greedy under
        # the byte budget; features not re-proposed are demoted. Hot-written
        # features are penalized by their write heat — a copy whose
        # recurring fanout outweighs its read savings is not proposed, which
        # is exactly how a hot-written replica becomes a demotion candidate.
        rmap_new = None
        if replicas is not None:
            from repro_torch import replicate
            rmap_new = replicate.propose_replicas(
                self.space, new, queries,
                int(getattr(cfg, "replica_budget", 0) or 0), heat=heat,
                write_heat=wh if wh.any() else None)

        dj_before = distributed_joins(stats, cur)
        dj_after = distributed_joins(stats, new)
        mplan = migration.plan(cur, new, replicas, rmap_new)

        t_new = obj_new if measure else None                 # line 24
        if measure and rmap_new is not None and rmap_new.has_replicas:
            # replica-served savings enter the benefit side of the guard
            t_new = measure(new, replicas=rmap_new)
        migration_s = 0.0
        window = 0
        fan_base = _fanout_bytes(replicas)
        fan_new = _fanout_bytes(rmap_new) if rmap_new is not None \
            else fan_base
        if measure:
            gain = t_base - t_new
            if net is not None and (mplan.n_moves or mplan.n_replica_ops):
                # migration-cost-aware guard: the destination must amortize
                # the cost of getting there (moves AND replica copies) over
                # the expected TM window. The write-fanout delta is a
                # RECURRING per-window cost/saving entering the benefit side
                # directly: dropping a hot-written copy saves its fanout
                # every window from now on, keeping one keeps paying it.
                migration_s = migration.migration_seconds(mplan, net)
                window = self._expected_window(queries)
                fan_gain_s = (fan_base - fan_new) / net.bandwidth_Bps
                benefit = gain * window + fan_gain_s
                # window == 0 means nothing to amortize over: savings can
                # never pay for a positive migration cost, so reject
                accepted = benefit > 0 and benefit >= migration_s
                reason = ("amortized" if accepted
                          else "no_gain" if benefit <= 0 else "unamortized")
            else:
                accepted = t_new < t_base                    # lines 25-27
                reason = "improved" if accepted else "no_gain"
        else:
            accepted = dj_after < dj_before
            reason = "dj_improved" if accepted else "dj_no_gain"
        if accepted:
            self.state = new
        else:
            self.state = cur
            mplan = migration.MigrationPlan([], 0, 0)
            rmap_new = None                # served replicas stay as they are
        # the round judged this window's write heat either way — mark it
        # consumed so a rejected round can't re-trigger the drift signal on
        # the same writes (an accepted round's clear_window resets both)
        if len(self.write_heat) < self.space.n_features:
            self.write_heat = np.pad(
                self.write_heat,
                (0, self.space.n_features - len(self.write_heat)))
        self._drift_seen = self.write_heat.copy()
        return self.state, AdaptReport(
            accepted=accepted, plan=mplan, dj_before=dj_before,
            dj_after=dj_after, t_base=t_base, t_new=t_new,
            n_clusters=n_clusters, chosen_cut=chosen_cut,
            migration_s=migration_s, amortize_window=window,
            replicas=rmap_new,
            # chunk priority = read heat + write heat: a churn-hot feature
            # should reach its destination as early as a read-hot one
            heat=heat + wh,
            replica_bytes=(rmap_new.replica_bytes(new.feature_sizes)
                           if rmap_new is not None else 0),
            fanout_bytes=fan_new if accepted else fan_base,
            reason=reason)
