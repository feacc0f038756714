"""repro_torch.write — the live write path: inserts/deletes served concurrently
with queries, migration, and replication.

AWAPart's premise is *continual* re-partitioning, but adapting to query
drift over an immutable graph is only half the story: xDGP and AdPart's
dynamic redistribution both treat graph **mutation** as the first-class
event partitioning must react to. This package makes the serving stack
writable:

* :class:`WriteBatch` — one normalized mutation (set semantics: deletes
  apply first, inserts win; redundant ops are no-ops).
* :func:`apply_batch` — the engine. Routes every effective row by the
  current primary assignment (``PartitionState.feature_to_shard`` of its
  owner feature), fans it out to every replica holder in the facade's
  ``ReplicaMap``, mutates the global ``TripleStore`` in place, re-indexes
  **only the touched shard views** (untouched shards keep their
  materialized ``TripleStore`` views — the same incremental-delta economy
  migration chunks get), and bumps the facade epoch + data version so the
  plan/result/profile caches invalidate correctly — including mid-
  ``MigrationSession``, where a later chunk moving a written feature
  naturally carries the post-write rows (chunk deltas are derived from the
  *live* state).
* :class:`WriteReport` / :class:`WriteLog` — what happened, per batch and
  per session: effective counts, per-feature write touches (the data-drift
  signal ``AWAPartController.note_writes`` folds into the TM window), the
  write-fanout traffic each replica copy cost, and any features born on
  the write path (new predicates are placed least-loaded; new
  ``rdf:type`` classes split out of the type predicate like any other
  tracked PO pair).
* :func:`rebuild_from_scratch` — the correctness oracle: an independently
  constructed ``PartitionedKG`` over the mutated triple set serving the
  same layout (feature universe translated by *key*). The write-path tests
  hold the live facade byte-identical to it at every epoch.

Writes are not migration: nothing moves between shards here. A write lands
where the layout says its rows live *today*; whether that layout should
change because of the write is the adaptation loop's call — write heat and
fanout bytes feed the accept guard (``repro_torch.core.adaptive``), which prices
keeping a hot-written feature replicated against demoting it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.core.migration import TRIPLE_BYTES

__all__ = ["WriteBatch", "WriteReport", "WriteLog", "apply_batch",
           "fresh_entity_ids", "rebuild_from_scratch"]


def fresh_entity_ids(store, n: int = 1) -> np.ndarray:
    """Mint ``n`` entity ids no triple in ``store`` uses.

    The dictionary interns only *named* terms; bulk entity ids are
    allocated past it (see ``graph.lubm``), so ``Dictionary.encode`` on a
    fresh term can return an id some existing entity already carries —
    a subject collision that silently merges the new rows into a stranger's
    neighborhood. Writers minting subjects for new rows should take them
    from here instead: ids start one past the store's current maximum, so
    they stay fresh as long as each minted range is inserted before the
    next is minted."""
    base = int(store.triples.max(initial=-1)) + 1
    return np.arange(base, base + int(n), dtype=np.int64)


def _normalize(triples) -> np.ndarray:
    """(M, 3) int32, unique rows, from any triple-like input."""
    arr = np.asarray(triples if triples is not None else (), dtype=np.int32)
    arr = arr.reshape(-1, 3)
    return np.unique(arr, axis=0) if len(arr) else arr


def _row_keys(*arrays: np.ndarray) -> List[np.ndarray]:
    """One int64 key per (s, p, o) row, consistent *across* all given
    arrays (equal rows map to equal keys). Three int32 ids don't pack into
    one int64 directly, so the (s, p) pair is dense-ranked over the union
    first and the rank packed with o — the same base-2**31 trick the
    executors' ``_key_columns`` uses."""
    lens = [len(a) for a in arrays]
    if sum(lens) == 0:
        return [np.empty(0, np.int64) for _ in arrays]
    cat = np.concatenate([np.asarray(a, np.int64).reshape(-1, 3)
                          for a in arrays])
    sp = cat[:, 0] * np.int64(1 << 31) + cat[:, 1]
    _, inv = np.unique(sp, return_inverse=True)
    keys = inv.astype(np.int64) * np.int64(1 << 31) + cat[:, 2]
    out, at = [], 0
    for n in lens:
        out.append(keys[at:at + n])
        at += n
    return out


@dataclasses.dataclass
class WriteBatch:
    """One mutation against the live graph: triples to delete + triples to
    insert, dictionary-encoded (s, p, o) int32 rows.

    Semantics are set-based and deterministic regardless of row order:
    the post-batch triple set is ``(store - deletes) | inserts`` — deletes
    apply first, an insert of a triple also being deleted wins (the triple
    ends present). Inserting a triple already present and deleting one
    absent are redundant no-ops (counted in ``WriteReport.n_redundant``).
    """

    inserts: np.ndarray = dataclasses.field(
        default_factory=lambda: np.empty((0, 3), np.int32))
    deletes: np.ndarray = dataclasses.field(
        default_factory=lambda: np.empty((0, 3), np.int32))

    def __post_init__(self) -> None:
        self.inserts = _normalize(self.inserts)
        self.deletes = _normalize(self.deletes)

    @property
    def n_ops(self) -> int:
        return len(self.inserts) + len(self.deletes)

    def summary(self) -> str:
        return (f"WriteBatch(+{len(self.inserts)}/-{len(self.deletes)} "
                f"triples)")


@dataclasses.dataclass
class WriteReport:
    """What one applied :class:`WriteBatch` actually did."""

    n_inserted: int                    # effective rows added
    n_deleted: int                     # effective rows removed
    n_redundant: int                   # requested ops that were no-ops
    touched_shards: List[int]          # shards whose materialized rows changed
    feature_writes: Dict[int, int]     # owner feature -> rows written (+/-)
    # features born on this write (new predicate / new rdf:type class):
    # (feature idx, key, assigned primary shard)
    new_features: List[Tuple[int, Tuple, int]]
    fanout_copies: int                 # extra replica copies written
    fanout_bytes: int                  # replica write-fanout traffic (bytes)
    epoch: int                         # facade epoch after the write
    data_version: int                  # facade data version after the write
    seq: int = -1                      # position in the WriteLog (set there)

    @property
    def effective(self) -> bool:
        return bool(self.n_inserted or self.n_deleted)

    def summary(self) -> str:
        rep = (f", fanout {self.fanout_copies} copies/"
               f"{self.fanout_bytes} B" if self.fanout_copies else "")
        return (f"write +{self.n_inserted}/-{self.n_deleted} "
                f"({self.n_redundant} redundant) on shards "
                f"{self.touched_shards}{rep} -> epoch {self.epoch}")


class WriteLog:
    """Ordered log of applied batches — the session-level mutation history
    ``KGService`` keeps (telemetry + replay source for tests/benchmarks)."""

    def __init__(self) -> None:
        self.entries: List[Tuple[WriteBatch, WriteReport]] = []
        self.n_inserted = 0
        self.n_deleted = 0
        self.fanout_bytes = 0

    def append(self, batch: WriteBatch, report: WriteReport) -> int:
        report.seq = len(self.entries)
        self.entries.append((batch, report))
        self.n_inserted += report.n_inserted
        self.n_deleted += report.n_deleted
        self.fanout_bytes += report.fanout_bytes
        return report.seq

    def __len__(self) -> int:
        return len(self.entries)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"WriteLog({len(self.entries)} batches, "
                f"+{self.n_inserted}/-{self.n_deleted} triples, "
                f"{self.fanout_bytes} B fanout)")


# --------------------------------------------------------------------------- #
# the engine
# --------------------------------------------------------------------------- #

def _resolve(kg, batch: WriteBatch):
    """Effective delete row ids + effective insert rows under set semantics.

    ``del_rows``: store rows whose triple is in ``deletes`` and not
    re-inserted by the same batch (insert wins). ``ins_rows``: insert
    triples not already present. Everything else is redundant."""
    store = kg.store
    skey, dkey, ikey = _row_keys(store.triples, batch.deletes, batch.inserts)
    order = np.argsort(skey, kind="stable")
    skey_sorted = skey[order]
    eff_del = dkey[~np.isin(dkey, ikey)] if len(dkey) else dkey
    del_rows: List[np.ndarray] = []
    if len(eff_del):
        lo = np.searchsorted(skey_sorted, eff_del, side="left")
        hi = np.searchsorted(skey_sorted, eff_del, side="right")
        # a store built via build_store is duplicate-free, but set-delete
        # removes every copy of the triple regardless
        del_rows = [order[l:h] for l, h in zip(lo.tolist(), hi.tolist())
                    if h > l]
    del_rows = (np.sort(np.concatenate(del_rows)) if del_rows
                else np.empty(0, np.int64))
    new_mask = (~np.isin(ikey, skey) if len(ikey)
                else np.zeros(0, dtype=bool))
    ins_rows = batch.inserts[new_mask]
    n_redundant = (len(batch.inserts) - len(ins_rows)) \
        + (len(batch.deletes) - len(del_rows))
    return del_rows, ins_rows, n_redundant


def _owner_features(kg, ins_rows: np.ndarray,
                    ) -> Tuple[np.ndarray, List[Tuple[int, Tuple, int]]]:
    """Owner feature per effective insert row, creating (and placing) any
    features the universe has never seen.

    Routing is vectorized: one batched tracked-PO
    lookup plus one batched P lookup resolve every row whose owner feature
    already exists (``FeatureSpace.po_index_batch``/``p_index_batch`` —
    a ``searchsorted`` each instead of a python loop over the batch). Only
    the leftover rows — brand-new predicates and never-seen ``rdf:type``
    classes — take the scalar creation path, in first-occurrence order, so
    feature birth order and placement are byte-identical to the scalar
    routing (``_owner_features_scalar``, kept as the parity oracle).

    A new predicate's P feature goes to the least-loaded shard (by primary
    triple count — there is no parent to inherit from); a new
    ``rdf:type`` class gets a tracked PO feature on its parent P shard,
    mirroring the ownership split the FeatureSpace applies at
    construction, so a rebuild-from-scratch facade derives the identical
    owner for every row."""
    space, state = kg.space, kg.state
    owners = np.empty(len(ins_rows), dtype=np.int32)
    new_features: List[Tuple[int, Tuple, int]] = []
    if not len(ins_rows):
        return owners, new_features

    p = ins_rows[:, 1].astype(np.int64)
    o = ins_rows[:, 2].astype(np.int64)
    po = space.po_index_batch(p, o)
    owners[:] = po
    need = po < 0                          # PO pair untracked at batch start
    if not need.any():
        return owners, new_features

    tp = -1 if space.type_predicate is None else int(space.type_predicate)
    idx = np.flatnonzero(need)
    pi = space.p_index_batch(p[idx])
    fast = (pi >= 0) & (p[idx] != tp)      # known plain predicate: owner = P
    owners[idx[fast]] = pi[fast]

    loads = None
    placed: Dict[int, int] = {}        # new feature idx -> assigned shard

    def place_least_loaded(fid: int) -> int:
        nonlocal loads
        if loads is None:
            loads = np.asarray(kg.shard_sizes(), dtype=np.int64).copy()
        dst = int(np.argmin(loads))
        loads[dst] += 1
        return dst

    nf_before = space.n_features
    for i in idx[~fast].tolist():          # feature-creating rows only
        p_i, o_i = int(p[i]), int(o[i])
        f = space.po_index(p_i, o_i)       # may exist since batch start now
        if f is None:
            known = space.index_of(("P", p_i))
            if known is None:
                known = space.track_p(p_i)
                dst = place_least_loaded(known)
                placed[known] = dst
                new_features.append((known, space.key(known), dst))
            if p_i == space.type_predicate:
                # a never-seen class: split it out of rdf:type exactly like
                # the constructor / track_workload would have
                f = space.track_po(p_i, o_i)
                dst = (placed[known] if known in placed
                       else int(state.feature_to_shard[known]))
                placed[f] = dst
                new_features.append((f, space.key(f), dst))
            else:
                f = known
        owners[i] = f
    if space.n_features > nf_before:
        add = np.array([shard for _f, _k, shard in new_features],
                       dtype=np.int32)
        assert len(add) == space.n_features - nf_before
        state.feature_to_shard = np.concatenate(
            [state.feature_to_shard, add])
        state.feature_sizes = np.concatenate(
            [state.feature_sizes, np.zeros(len(add), np.int64)])
        kg.replicas.extend(state.feature_to_shard)
    return owners, new_features


def _owner_features_scalar(kg, ins_rows: np.ndarray,
                           ) -> Tuple[np.ndarray,
                                      List[Tuple[int, Tuple, int]]]:
    """The original per-row routing loop — the parity oracle the vectorized
    :func:`_owner_features` is tested against (identical owners, identical
    feature birth order/placement, identical state growth)."""
    space, state = kg.space, kg.state
    owners = np.empty(len(ins_rows), dtype=np.int32)
    new_features: List[Tuple[int, Tuple, int]] = []
    loads = None
    placed: Dict[int, int] = {}        # new feature idx -> assigned shard

    def place_least_loaded(fid: int) -> int:
        nonlocal loads
        if loads is None:
            loads = np.asarray(kg.shard_sizes(), dtype=np.int64).copy()
        dst = int(np.argmin(loads))
        loads[dst] += 1
        return dst

    nf_before = space.n_features
    for i, (s, p, o) in enumerate(ins_rows.tolist()):
        f = space.po_index(p, o)
        if f is None:
            known = space.index_of(("P", p))
            if known is None:
                known = space.track_p(p)
                dst = place_least_loaded(known)
                placed[known] = dst
                new_features.append((known, space.key(known), dst))
            if p == space.type_predicate:
                f = space.track_po(p, o)
                dst = (placed[known] if known in placed
                       else int(state.feature_to_shard[known]))
                placed[f] = dst
                new_features.append((f, space.key(f), dst))
            else:
                f = known
        owners[i] = f
    if space.n_features > nf_before:
        add = np.array([shard for _f, _k, shard in new_features],
                       dtype=np.int32)
        assert len(add) == space.n_features - nf_before
        state.feature_to_shard = np.concatenate(
            [state.feature_to_shard, add])
        state.feature_sizes = np.concatenate(
            [state.feature_sizes, np.zeros(len(add), np.int64)])
        kg.replicas.extend(state.feature_to_shard)
    return owners, new_features


def apply_batch(kg, batch: WriteBatch) -> WriteReport:
    """Apply one :class:`WriteBatch` to a live ``PartitionedKG``.

    Effective rows are routed by the **current** primary assignment of
    their owner feature and fanned out to every holder in the facade's
    ``ReplicaMap`` (a replicated feature's copies stay byte-identical —
    that fanout is exactly the per-write cost the adaptation guard prices).
    Only the shards whose materialized rows changed are re-indexed; an
    effective write bumps the facade epoch (plans/results invalidate) and
    its data version (layout-invariant profiles invalidate too — join
    results are no longer the same graph's). A fully-redundant batch is a
    no-op: same epoch, caches intact.
    """
    state = kg.state
    del_rows, ins_rows, n_redundant = _resolve(kg, batch)
    if not len(del_rows) and not len(ins_rows):
        return WriteReport(
            n_inserted=0, n_deleted=0, n_redundant=n_redundant,
            touched_shards=[], feature_writes={}, new_features=[],
            fanout_copies=0, fanout_bytes=0, epoch=kg.epoch,
            data_version=kg.data_version)

    owners_ins, new_features = _owner_features(kg, ins_rows)
    owners_del = kg.owners[del_rows]
    touched_feats = np.unique(np.concatenate([owners_del, owners_ins])
                              .astype(np.int64))

    # fanout: every extra holder of a written feature receives the row too
    n_copies = kg.replicas.n_copies()
    extra = np.maximum(n_copies[touched_feats] - 1, 0)
    writes_per_feat = np.bincount(
        np.concatenate([owners_del, owners_ins]).astype(np.int64),
        minlength=len(state.feature_to_shard))[touched_feats]
    fanout_copies = int((extra * writes_per_feat).sum())
    fanout_bytes = fanout_copies * TRIPLE_BYTES

    # shards whose materialized rows change: every holder of a touched
    # feature (the primary's bit is always set in the mask)
    hold = np.bitwise_or.reduce(kg.replicas.masks[touched_feats])
    touched_shards = [s for s in range(state.n_shards)
                      if (int(hold) >> s) & 1]

    # mutate the global store in place; remap the facade's row indexes
    remap = kg.store.apply_mutation(ins_rows, del_rows)
    keep = remap >= 0
    kg.owners = np.concatenate([kg.owners[keep], owners_ins])
    kg._triple_shard = np.concatenate(
        [kg._triple_shard[keep],
         state.feature_to_shard[owners_ins]]).astype(np.int32)
    np.subtract.at(state.feature_sizes, owners_del, 1)
    np.add.at(state.feature_sizes, owners_ins, 1)

    touched = set(touched_shards)
    for s in range(state.n_shards):
        if s in touched:
            kg._rows[s] = np.flatnonzero(kg._triple_shard == s)
            kg._views[s] = None
        elif len(del_rows):
            # untouched shards hold no deleted row; the remap is monotonic
            # over survivors, so sorted row lists stay sorted
            kg._rows[s] = remap[kg._rows[s]]
            kg._replica_rows[s] = remap[kg._replica_rows[s]]
        kg._shard_rows[s] = None
    kg._rebuild_feature_index()
    for s in touched_shards:
        kg._refresh_replica_rows(s, state.feature_to_shard)

    kg.epoch += 1
    kg.data_version += 1
    kg._invalidate_caches()
    kg._profiles.clear()       # profiles are data-dependent: global row ids

    m = getattr(kg, "metrics", None)
    if m is not None:          # repro_torch.obs: write-path traffic counters
        m.counter("write.batches").inc()
        m.counter("write.rows_inserted").inc(len(ins_rows))
        m.counter("write.rows_deleted").inc(len(del_rows))
        m.counter("write.rows_redundant").inc(n_redundant)
        m.counter("write.fanout_copies").inc(fanout_copies)
        m.counter("write.fanout_bytes").inc(fanout_bytes)

    return WriteReport(
        n_inserted=len(ins_rows), n_deleted=len(del_rows),
        n_redundant=n_redundant, touched_shards=touched_shards,
        feature_writes={int(f): int(c) for f, c in
                        zip(touched_feats.tolist(), writes_per_feat.tolist())},
        new_features=new_features, fanout_copies=fanout_copies,
        fanout_bytes=fanout_bytes, epoch=kg.epoch,
        data_version=kg.data_version)


# --------------------------------------------------------------------------- #
# the correctness oracle
# --------------------------------------------------------------------------- #

def rebuild_from_scratch(kg):
    """An independently-built ``PartitionedKG`` over the live facade's
    current triples, serving the same layout.

    Fresh ``TripleStore``, fresh ``FeatureSpace`` mirroring the live
    feature universe by *key* (including features whose triples were all
    deleted — queries may still reference them), and the primary/replica
    assignment translated key-by-key. The write-path property tests hold
    the live facade byte-identical (bindings + comparable ``ExecStats``)
    to this rebuild at every epoch.
    """
    from repro_torch.api.facade import PartitionedKG
    from repro_torch.core.features import FeatureSpace
    from repro_torch.core.partition import PartitionState
    from repro_torch.graph.triples import TripleStore
    from repro_torch.replicate import ReplicaMap

    store2 = TripleStore(kg.store.triples.copy(), kg.store.dictionary)
    space2 = FeatureSpace(store2, type_predicate=kg.space.type_predicate)
    for key in kg.space.feature_keys():
        if key[0] == "PO":
            space2.track_po(key[1], key[2])
        else:
            space2.track_p(key[1])
    f2s = np.empty(space2.n_features, dtype=np.int32)
    masks = np.empty(space2.n_features, dtype=np.uint64)
    for i in range(space2.n_features):
        j = kg.space.index_of(space2.key(i))
        assert j is not None, \
            f"rebuilt space tracks {space2.key(i)} but the live one doesn't"
        f2s[i] = kg.state.feature_to_shard[j]
        masks[i] = kg.replicas.masks[j]
    state2 = PartitionState(f2s, space2.feature_sizes(), kg.n_shards)
    return PartitionedKG(store2, space2, state2,
                         max_join_rows=kg.max_join_rows,
                         replicas=ReplicaMap(masks, kg.n_shards))
