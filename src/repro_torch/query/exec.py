"""Pluggable query executors over the ``QueryPlan`` IR.

Two backends behind one ``Executor`` protocol:

* :class:`NumpyExecutor` — the reference semantics: per-shard pattern
  matching, numpy hash joins, python-level federation accounting.
* :class:`TorchExecutor` — the batched backend on a torch device: patterns
  are matched once against the global store (results deduplicated across
  the whole batch), every hash join runs as the fused device pipeline of
  ``repro_torch.kernels.join`` (the Hopper kernels on a CUDA device, their
  plain PyTorch versions on the CPU), and the federation accounting for
  every distinct pattern in the window is ONE scatter-add on the device
  instead of a python loop per shard per query. Bindings and stats match
  the numpy backend exactly (modulo row order and the informational
  ``wall_s``).

Execution model mirrors the paper's federated SPARQL (Sec. IV): a query runs
at its Primary Processing Node (PPN) and every triple pattern whose matches
live on other shards is a SERVICE call whose bindings are shipped to the PPN.
Joins execute for real; *time* is modeled by :class:`NetworkModel` (this
container has no cluster fabric), which lives solely in
``ExecStats.modeled_time`` — executors never take a network argument.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Protocol, Sequence, Tuple, \
    runtime_checkable

import numpy as np
import torch

from repro_torch.core.migration import TRIPLE_BYTES
from repro_torch.query import plan as qplan
from repro_torch.query.pattern import Query, is_var

# Cross products ("cartesian" plan ops) materialize |left| x |right| rows;
# exceeding this cap raises JoinCapExceeded instead of exhausting memory.
DEFAULT_MAX_JOIN_ROWS = 50_000_000


class JoinCapExceeded(RuntimeError):
    """A join step — cartesian product or ragged hash-join expansion —
    would materialize more rows than the executor's ``max_join_rows``
    cap."""


@dataclasses.dataclass
class NetworkModel:
    """Deterministic cluster cost model.

    Queries execute for real (joins — results are exact), but their *time*
    is modeled, because this container has no cluster fabric and wall-clock
    noise would swamp the federation costs the paper's technique optimizes.
    The model matches the paper's deployment shape: per-shard scans run in
    parallel (max, not sum), SERVICE calls pay a round-trip latency, and
    shipped bindings pay serialization+wire time (federated SPARQL over HTTP
    is slow — effective ~20 MB/s)."""
    latency_s: float = 0.050          # SERVICE round trip incl. query setup
    bandwidth_Bps: float = 20e6       # effective federated-result throughput
    scan_rows_per_s: float = 5e6      # Virtuoso-ish index scan rate
    join_rows_per_s: float = 5e6      # hash-join probe rate at the PPN
    row_bytes: float = 60.0           # serialized SPARQL result row (HTTP/XML)
    plan_s: float = 0.002             # master-side cost per query plan built
    #   (the currency of repro_torch.stream's pre-staging: a pipelined window hides
    #    plan builds behind the previous window's execution)

    def time(self, messages: int, rows_shipped: int) -> float:
        return (messages * self.latency_s
                + rows_shipped * self.row_bytes / self.bandwidth_Bps)


@dataclasses.dataclass
class ExecStats:
    scan_rows_critical: int = 0        # sum over patterns of max-shard rows
    join_rows: int = 0                 # rows flowing through PPN joins
    distributed_joins: int = 0
    rows_shipped: int = 0              # binding rows crossing shards
    bytes_shipped: int = 0             # rows_shipped * TRIPLE_BYTES
    messages: int = 0
    rows: int = 0
    cartesian_rows: int = 0            # cross-product rows materialized
    expanded_rows: int = 0             # ragged hash-join pairs materialized
    wall_s: float = 0.0                # actual local execution time (info)

    # every field that must agree between backends / profile re-accounting
    COMPARABLE = ("scan_rows_critical", "join_rows", "distributed_joins",
                  "rows_shipped", "bytes_shipped", "messages", "rows",
                  "cartesian_rows", "expanded_rows")

    def modeled_time(self, net: NetworkModel | None = None) -> float:
        net = net or NetworkModel()
        return (self.scan_rows_critical / net.scan_rows_per_s
                + self.join_rows / net.join_rows_per_s
                + net.time(self.messages, self.rows_shipped))


Bindings = Dict[int, np.ndarray]


@runtime_checkable
class Executor(Protocol):
    """Backend protocol: run one plan (or a whole workload window) against a
    sharded KG (``engine.ShardedStore`` or ``api.PartitionedKG``)."""

    name: str

    def run(self, plan: qplan.QueryPlan, kg) -> Tuple[Bindings, ExecStats]:
        ...

    def run_batch(self, plans: Sequence[qplan.QueryPlan], kg,
                  ) -> List[Tuple[Bindings, ExecStats]]:
        ...


# --------------------------------------------------------------------------- #
# shared join machinery (numpy reference semantics)
# --------------------------------------------------------------------------- #

def _pattern_cols(pat, rows: np.ndarray) -> Bindings:
    """Variable columns from matched triples, with intra-pattern repeated
    variables (e.g. ``(?x, p, ?x)``) filtered."""
    cols: Bindings = {}
    for slot_idx, slot in enumerate(pat):
        if is_var(slot):
            cols[slot] = rows[:, slot_idx].astype(np.int64)
    seen: Dict[int, int] = {}
    keep = np.ones(rows.shape[0], bool)
    for slot_idx, slot in enumerate(pat):
        if is_var(slot):
            if slot in seen:
                keep &= rows[:, seen[slot]] == rows[:, slot_idx]
            else:
                seen[slot] = slot_idx
    if not keep.all():
        cols = {v: c[keep] for v, c in cols.items()}
    return cols


def _cartesian_indices(nl: int, nr: int, stats: ExecStats,
                       max_rows: int) -> Tuple[np.ndarray, np.ndarray]:
    """Cross-product (left, right) index pairs, capped."""
    produced = nl * nr
    if produced > max_rows:
        raise JoinCapExceeded(
            f"cartesian join would materialize {produced} rows "
            f"({nl} x {nr}), above the {max_rows}-row cap; "
            "raise Executor(max_join_rows=...) or add a shared variable")
    stats.cartesian_rows += produced
    li = np.repeat(np.arange(nl), nr)
    ri = np.tile(np.arange(nr), nl)
    return li, ri


def _check_expansion(total: int, stats: ExecStats, max_rows: int) -> int:
    """Cap + account the data-dependent ragged hash-join expansion, exactly
    like the cartesian path: the check fires before any pair array is
    materialized."""
    if total > max_rows:
        raise JoinCapExceeded(
            f"hash-join expansion would materialize {total} rows, above "
            f"the {max_rows}-row cap; raise Executor(max_join_rows=...) "
            "or add a more selective pattern")
    stats.expanded_rows += total
    return total


def _key_columns(table: Bindings, cols: Bindings, shared: Sequence[int],
                 ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Shared-var key columns, reduced to at most two int64 columns.

    Two dictionary ids (< 2^31) pack exactly into one int64; with three or
    more shared variables the leading columns are first combined and
    dense-ranked over the union of both sides, so the packed key never
    overflows (a straight base-2^31 pack of three columns wraps int64 and
    hash-equates rows whose leading variable differs by a multiple of 4)."""
    lcs = [table[v] for v in shared]
    rcs = [cols[v] for v in shared]
    while len(lcs) > 2:
        lkey = lcs[0] * np.int64(1 << 31) + lcs[1]
        rkey = rcs[0] * np.int64(1 << 31) + rcs[1]
        _, inv = np.unique(np.concatenate([lkey, rkey]), return_inverse=True)
        lcs = [inv[:len(lkey)].astype(np.int64)] + lcs[2:]
        rcs = [inv[len(lkey):].astype(np.int64)] + rcs[2:]
    return lcs, rcs


def _join_numpy(table: Optional[Bindings], pat, rows: np.ndarray,
                stats: ExecStats, max_rows: int) -> Optional[Bindings]:
    """Hash-join current binding table with matched triples on shared vars.
    The key packing + searchsorted probe is ``join.ops.hash_probe_numpy``
    (one copy of the base-2^31 packing math repo-wide); the per-left-row
    run concatenation below is the readable reference expansion every
    backend's vectorized equivalent must reproduce."""
    from repro_torch.kernels.join import ops as join_ops

    cols = _pattern_cols(pat, rows)
    if table is None:
        return cols
    shared = [v for v in cols if v in table]
    if not shared:
        nl = len(next(iter(table.values())))
        nr = len(next(iter(cols.values())))
        li, ri = _cartesian_indices(nl, nr, stats, max_rows)
    else:
        lcs, rcs = _key_columns(table, cols, shared)
        order, lo, counts = join_ops.hash_probe_numpy(lcs, rcs)
        total = _check_expansion(int(counts.sum()), stats, max_rows)
        li = np.repeat(np.arange(len(lo)), counts)
        ri_parts = [order[l:h] for l, h in zip(lo, lo + counts) if h > l]
        ri = (np.concatenate(ri_parts) if ri_parts
              else np.empty(0, dtype=np.int64))
        assert len(ri) == total
    out: Bindings = {v: c[li] for v, c in table.items()}
    for v, c in cols.items():
        if v not in out:
            out[v] = c[ri]
    return out


def _table_len(table: Optional[Bindings]) -> int:
    return len(next(iter(table.values()))) if table else 0


# --------------------------------------------------------------------------- #
# numpy backend — reference semantics
# --------------------------------------------------------------------------- #

def _has_replicated_layout(kg) -> bool:
    """Does ``kg`` carry a ReplicaMap with actual read copies? (ShardedStore
    and primary-only facades answer False — the replica-free fast paths
    stay byte-identical to the pre-replication executors.)"""
    replicas = getattr(kg, "replicas", None)
    return replicas is not None and replicas.has_replicas


class NumpyExecutor:
    """Per-shard matching + numpy joins; the reference backend."""

    name = "numpy"

    def __init__(self, max_join_rows: int = DEFAULT_MAX_JOIN_ROWS):
        self.max_join_rows = max_join_rows

    def run(self, plan: qplan.QueryPlan, kg) -> Tuple[Bindings, ExecStats]:
        stats = ExecStats()
        t0 = time.perf_counter()
        shards = kg.shards
        # replicated layout: shard views hold read copies, so every triple
        # is scanned exactly once at its *read* shard for this query — the
        # PPN when the owner feature has a local copy there, else the
        # primary. The match set (hence every binding) is unchanged; only
        # which shard serves each row — the federation accounting — moves.
        read = (kg.read_shard(plan.ppn) if _has_replicated_layout(kg)
                else None)
        multi = plan.n_patterns > 1
        table: Optional[Bindings] = None
        for op in plan.ops:
            s, p, o = op.pattern
            if read is None:
                per_shard = [sh.match(None if is_var(s) else s,
                                      None if is_var(p) else p,
                                      None if is_var(o) else o)
                             for sh in shards]
            else:
                per_shard = []
                for s_idx, sh in enumerate(shards):
                    vidx = sh.match_indices(None if is_var(s) else s,
                                            None if is_var(p) else p,
                                            None if is_var(o) else o)
                    keep = read[kg.shard_rows(s_idx)[vidx]] == s_idx
                    per_shard.append(sh.triples[vidx[keep]])
            rows = (np.concatenate(per_shard, axis=0)
                    if any(len(m) for m in per_shard)
                    else np.empty((0, 3), np.int32))
            # shards scan their slices in parallel: pay the slowest
            stats.scan_rows_critical += max(
                (len(m) for m in per_shard), default=0)
            # federation accounting: matches living off-PPN are shipped
            for s_idx, m in enumerate(per_shard):
                if s_idx != plan.ppn and len(m) > 0:
                    stats.messages += 1
                    stats.rows_shipped += len(m)
                    stats.bytes_shipped += len(m) * TRIPLE_BYTES
                    if multi:
                        stats.distributed_joins += 1
            before = _table_len(table)
            table = _join_numpy(table, op.pattern, rows, stats,
                                self.max_join_rows)
            stats.join_rows += before + len(rows) + _table_len(table)
            if table is not None and _table_len(table) == 0:
                break
        stats.wall_s = time.perf_counter() - t0
        stats.rows = _table_len(table)
        m = getattr(kg, "metrics", None)
        if m is not None:          # repro_torch.obs: backend execution counters
            m.counter("executor.queries").inc()
            m.histogram("executor.wall_s").observe(stats.wall_s)
        return table or {}, stats

    def run_batch(self, plans: Sequence[qplan.QueryPlan], kg,
                  ) -> List[Tuple[Bindings, ExecStats]]:
        m = getattr(kg, "metrics", None)
        if m is not None:
            m.counter("executor.batches").inc()
        return [self.run(p, kg) for p in plans]


# --------------------------------------------------------------------------- #
# torch backend — batched execution on a device
# --------------------------------------------------------------------------- #

def _join_torch(table: Optional[Bindings], pat, rows: np.ndarray,
                stats: ExecStats, max_rows: int, device: torch.device,
                cols: Optional[Bindings] = None) -> Optional[Bindings]:
    """Same join semantics as :func:`_join_numpy`, with the whole
    pack→sort→probe→expand→gather chain fused into
    ``join.ops.hash_join_pipeline`` on ``device``: intermediates stay on the
    device and the host sees one final ``(li, ri)`` materialization. The
    pipeline enforces ``max_rows`` on the data-dependent expansion total
    before any pair array exists, mirroring the cartesian cap."""
    from repro_torch.kernels.join import ops as join_ops

    cols = _pattern_cols(pat, rows) if cols is None else cols
    if table is None:
        return cols
    shared = [v for v in cols if v in table]
    if not shared:
        nl, nr = _table_len(table), len(next(iter(cols.values())))
        li, ri = _cartesian_indices(nl, nr, stats, max_rows)
    else:
        lcs, rcs = _key_columns(table, cols, shared)
        try:
            li, ri, total = join_ops.hash_join_pipeline(
                lcs, rcs, device=device, max_total=max_rows)
        except join_ops.ExpansionCapExceeded as e:
            raise JoinCapExceeded(
                f"{e}; raise Executor(max_join_rows=...) or add a more "
                "selective pattern") from None
        stats.expanded_rows += total
    out: Bindings = {v: c[li] for v, c in table.items()}
    for v, c in cols.items():
        if v not in out:
            out[v] = c[ri]
    return out


def _federation_bincounts(shard_ids_list: Sequence[np.ndarray],
                          n_shards: int, device: torch.device) -> np.ndarray:
    """(n_entries, n_shards) serving-shard counts for every distinct
    executed (pattern[, read layout]) of the batch — one scatter-add on
    ``device`` for the whole workload window. Each entry is the per-match
    shard ids (primary ``triple_shard`` gather, or the replica-aware
    ``read_shard`` gather when the layout holds read copies)."""
    from repro_torch.kernels.join import ops as join_ops

    if not shard_ids_list:
        return np.zeros((0, n_shards), np.int64)
    lens = np.array([len(i) for i in shard_ids_list], np.int64)
    if lens.sum() == 0:
        return np.zeros((len(shard_ids_list), n_shards), np.int64)
    # the segment build is the same segmented ragged expansion as the join's
    # pair expansion (segment id per flat output slot): the expand kernel
    seg = join_ops.expand_segment_ids(torch.from_numpy(lens).to(device))
    shard_ids = torch.from_numpy(np.concatenate(
        [np.asarray(i, np.int64) for i in shard_ids_list])).to(device)
    out = torch.zeros((len(shard_ids_list), n_shards), dtype=torch.int64,
                      device=device)
    out.index_put_((seg, shard_ids), torch.ones_like(shard_ids),
                   accumulate=True)
    return out.cpu().numpy()


class TorchExecutor:
    """Batched backend on a torch ``device``: global-store matching with
    pattern results (indices, rows, variable columns) deduplicated across
    the whole window, every hash join through the fused device pipeline
    (``repro_torch.kernels.join``: the Hopper kernels on a CUDA device,
    their plain PyTorch versions on the CPU), and one scatter-add for the
    batch's federation accounting over distinct patterns."""

    name = "torch"

    def __init__(self, max_join_rows: int = DEFAULT_MAX_JOIN_ROWS, *,
                 device="cuda"):
        from repro_torch.kernels import dispatch

        self.max_join_rows = max_join_rows
        self.device = dispatch.resolve_device(device)

    def run(self, plan: qplan.QueryPlan, kg) -> Tuple[Bindings, ExecStats]:
        return self.run_batch([plan], kg)[0]

    def run_batch(self, plans: Sequence[qplan.QueryPlan], kg,
                  ) -> List[Tuple[Bindings, ExecStats]]:
        store = kg.store
        triple_shard = kg.triple_shard
        device = self.device
        # global-store matches deduplicated across the whole window:
        # pattern -> (row ids, matched triples, variable columns)
        match_cache: Dict[tuple, tuple] = {}

        results: List[Tuple[Bindings, ExecStats]] = []
        executed: List[Tuple[int, tuple]] = []         # (query, pattern)
        for qi, plan in enumerate(plans):
            stats = ExecStats()
            t0 = time.perf_counter()
            table: Optional[Bindings] = None
            ops_run = 0
            for op in plan.ops:
                hit = match_cache.get(op.pattern)
                if hit is None:
                    s, p, o = op.pattern
                    idx = store.match_indices(None if is_var(s) else s,
                                              None if is_var(p) else p,
                                              None if is_var(o) else o)
                    rows = store.triples[idx]
                    hit = (idx, rows, _pattern_cols(op.pattern, rows))
                    match_cache[op.pattern] = hit
                idx, rows, cols = hit
                executed.append((qi, op.pattern))
                ops_run += 1
                before = _table_len(table)
                table = _join_torch(table, op.pattern, rows, stats,
                                    self.max_join_rows, device, cols=cols)
                stats.join_rows += before + len(rows) + _table_len(table)
                if table is not None and _table_len(table) == 0:
                    break
            if table is not None and ops_run == 1:
                # single-op result IS the cached column dict: copy so two
                # queries in the window never alias the same binding arrays
                table = {v: c.copy() for v, c in table.items()}
            stats.rows = _table_len(table)
            stats.wall_s = time.perf_counter() - t0
            results.append((table or {}, stats))

        # one device batch prices the federation of every distinct
        # pattern executed in the window. On a replicated layout the
        # serving shard of a match depends on the query's PPN (its local
        # copies serve for free), so entries are keyed per (pattern, ppn)
        # and gathered through the facade's cached read_shard(ppn).
        t0 = time.perf_counter()
        replicated = _has_replicated_layout(kg)
        if replicated:
            keys = [(pat, plans[qi].ppn) for qi, pat in executed]
            distinct = list(dict.fromkeys(keys))
            idx_lists = [kg.read_shard(ppn)[match_cache[pat][0]]
                         for pat, ppn in distinct]
        else:
            keys = [pat for _, pat in executed]
            distinct = list(match_cache)
            idx_lists = [triple_shard[match_cache[pat][0]]
                         for pat in distinct]
        counts = _federation_bincounts(idx_lists, kg.n_shards, device)
        count_of = dict(zip(distinct, counts))
        for key, (qi, pat) in zip(keys, executed):
            stats = results[qi][1]
            plan = plans[qi]
            per_shard = count_of[key]
            stats.scan_rows_critical += int(per_shard.max())
            off = per_shard.copy()
            off[plan.ppn] = 0
            nz = int((off > 0).sum())
            stats.messages += nz
            stats.rows_shipped += int(off.sum())
            stats.bytes_shipped += int(off.sum()) * TRIPLE_BYTES
            if plan.n_patterns > 1:
                stats.distributed_joins += nz
        if plans:
            acct = (time.perf_counter() - t0) / len(plans)
            for _, stats in results:
                stats.wall_s += acct
        m = getattr(kg, "metrics", None)
        if m is not None:          # repro_torch.obs: backend execution counters
            m.counter("executor.batches").inc()
            m.counter("executor.queries").inc(len(plans))
            m.counter("executor.match_dedup_hits").inc(
                len(executed) - len(match_cache))
            for _, stats in results:
                m.histogram("executor.wall_s").observe(stats.wall_s)
        return results


def get_executor(spec: "str | Executor | None", *,
                 device="cuda") -> Executor:
    """Resolve an executor: an instance passes through, a name (``"numpy"``
    / ``"torch"``) constructs the backend, ``None`` means ``"torch"``. The
    torch backend runs on ``device`` (the card unless the caller asks for
    the CPU)."""
    if spec is None or spec == "torch":
        return TorchExecutor(device=device)
    if spec == "numpy":
        return NumpyExecutor()
    if isinstance(spec, str):
        raise ValueError(f"unknown executor {spec!r}; "
                         "expected one of ['numpy', 'torch']")
    return spec


# --------------------------------------------------------------------------- #
# profiles (derived from plans) + workload helpers
# --------------------------------------------------------------------------- #

def profile_from_plan(plan: qplan.QueryPlan, store,
                      max_join_rows: int = DEFAULT_MAX_JOIN_ROWS,
                      ) -> qplan.QueryProfile:
    """One real execution of ``plan`` against the global store, recording the
    layout-invariant artifacts (matched row ids, join-pipeline counts).
    ``max_join_rows`` should match the serving executor's cap so profiling
    never rejects a workload the executor was configured to allow.

    The recorded row ids index the store *as it is now*: a live write
    (``repro_torch.write``) compacts/appends rows, so profiles are valid per
    facade ``data_version`` — ``PartitionedKG.profile`` re-derives after
    any effective mutation rather than serving remapped-out ids."""
    prof = qplan.QueryProfile(pattern_rows=[], join_rows=0, rows=0,
                              n_patterns=plan.n_patterns)
    stats = ExecStats()
    table: Optional[Bindings] = None
    for op in plan.ops:
        s, p, o = op.pattern
        idx = store.match_indices(None if is_var(s) else s,
                                  None if is_var(p) else p,
                                  None if is_var(o) else o)
        prof.pattern_rows.append(np.asarray(idx, dtype=np.int64))
        rows = store.triples[idx]
        before = _table_len(table)
        table = _join_numpy(table, op.pattern, rows, stats, max_join_rows)
        prof.join_rows += before + len(rows) + _table_len(table)
        if table is not None and _table_len(table) == 0:
            break
    prof.rows = _table_len(table)
    prof.cartesian_rows = stats.cartesian_rows
    prof.expanded_rows = stats.expanded_rows
    return prof


def _plans_for(queries: Sequence[Query], kg) -> List[qplan.QueryPlan]:
    if hasattr(kg, "plan"):           # PartitionedKG: cached per (query, store)
        return [kg.plan(q) for q in queries]
    return [qplan.plan(q, kg) for q in queries]


def run_workload(queries: Sequence[Query], kg,
                 executor: "str | Executor | None" = None,
                 net: NetworkModel | None = None,
                 ) -> Tuple[Dict[str, float], Dict[str, ExecStats]]:
    """Execute a workload window in one batch; returns per-query modeled
    times (seconds) and stats, keyed by query name."""
    ex = get_executor(executor)
    net = net or NetworkModel()
    plans = _plans_for(queries, kg)
    results = ex.run_batch(plans, kg)
    times = {q.name: st.modeled_time(net)
             for q, (_, st) in zip(queries, results)}
    all_stats = {q.name: st for q, (_, st) in zip(queries, results)}
    return times, all_stats


def workload_average_time(queries: Sequence[Query], kg,
                          executor: "str | Executor | None" = None,
                          net: NetworkModel | None = None) -> float:
    """Fig.-5 average: frequency-weighted mean runtime over the workload."""
    times, _ = run_workload(queries, kg, executor, net)
    freqs = np.array([q.frequency for q in queries])
    vals = np.array([times[q.name] for q in queries])
    return float((vals * freqs).sum() / freqs.sum())
