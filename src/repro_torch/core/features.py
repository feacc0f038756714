"""Query & triple feature extraction — the paper's QueryAnalyzer (Sec. III.A).

Features identifying triples (and clustering queries):
  * ``P``  — all triples sharing predicate P,
  * ``PO`` — all triples sharing predicate P *and* object O.

Join-structure features (``SSJ``/``OOJ``/``OSJ``) are extracted per query and
feed the Fig.-5 scoring statistics, not the Jaccard bitmaps (per Fig. 1, the
Jaccard sets contain only P and PO features).

Every triple has exactly one *owner* feature — its PO feature if that (p, o)
pair is tracked, else its P feature. The partition maps owner features to
shards, so a feature's triples live in exactly one shard (no replication —
Sec. III.B). Tracked PO pairs are all ``rdf:type`` pairs plus any (p, o) pair
appearing as a constant-object pattern in the observed workload; tracking a
new PO feature *splits* it out of its parent P feature (adaptive granularity).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

from repro_torch.graph.triples import TripleStore
from repro_torch.query.pattern import Query, is_var

FeatureKey = Tuple  # ("P", p) | ("PO", p, o)


class FeatureSpace:
    """Dense indexing of the feature universe over a dataset + workload."""

    def __init__(self, store: TripleStore, type_predicate: int | None = None):
        self.store = store
        self.type_predicate = type_predicate
        self._keys: List[FeatureKey] = []
        self._index: Dict[FeatureKey, int] = {}
        self._tracked_po: Dict[int, int] = {}   # packed (p, o) -> feature idx
        preds = np.unique(store.triples[:, 1])
        for p in preds.tolist():
            self._add(("P", int(p)))
        if type_predicate is not None:
            t = store.triples
            mask = t[:, 1] == type_predicate
            for o in np.unique(t[mask, 2]).tolist():
                self.track_po(type_predicate, int(o))

    # ------------------------------------------------------------------ #
    def _add(self, key: FeatureKey) -> int:
        idx = self._index.get(key)
        if idx is None:
            idx = len(self._keys)
            self._keys.append(key)
            self._index[key] = idx
        return idx

    @staticmethod
    def _pack(p: int, o: int) -> int:
        return (int(p) << 32) | int(o)

    def track_po(self, p: int, o: int) -> int:
        idx = self._add(("PO", int(p), int(o)))
        self._tracked_po[self._pack(p, o)] = idx
        return idx

    def track_p(self, p: int) -> int:
        """Ensure predicate ``p`` has a P feature, returning its index.
        The write path (``repro_torch.write``) calls this when an insert carries a
        predicate the store has never seen — features are otherwise derived
        from the store's predicates at construction."""
        return self._add(("P", int(p)))

    def track_workload(self, queries: Iterable[Query]) -> List[int]:
        """Track every constant-object (p, o) pattern in the workload."""
        added = []
        for q in queries:
            for s, p, o in q.patterns:
                if not is_var(p) and not is_var(o):
                    added.append(self.track_po(p, o))
        return added

    # ------------------------------------------------------------------ #
    @property
    def n_features(self) -> int:
        return len(self._keys)

    def key(self, idx: int) -> FeatureKey:
        return self._keys[idx]

    def index_of(self, key: FeatureKey) -> int | None:
        """Feature index of a key, or None if untracked (the key-based
        translation ``repro_torch.write.rebuild_from_scratch`` uses to map one
        space's universe onto another's)."""
        return self._index.get(tuple(key))

    def feature_keys(self) -> List[FeatureKey]:
        """All tracked keys, in feature-index order."""
        return list(self._keys)

    def p_index(self, p: int) -> int:
        return self._index[("P", int(p))]

    def po_index(self, p: int, o: int) -> int | None:
        return self._tracked_po.get(self._pack(p, o))

    def p_index_batch(self, p: np.ndarray) -> np.ndarray:
        """Vectorized :meth:`p_index` over a predicate column: P-feature
        index per row, ``-1`` where the predicate is untracked (instead of
        the scalar method's KeyError). One sorted-key ``searchsorted``
        instead of a dict probe per row."""
        p = np.asarray(p, dtype=np.int64)
        out = np.full(p.shape, -1, dtype=np.int32)
        tracked = [(key[1], i) for i, key in enumerate(self._keys)
                   if key[0] == "P"]
        if tracked and len(p):
            tracked.sort()
            keys = np.array([k for k, _ in tracked], dtype=np.int64)
            vals = np.array([i for _, i in tracked], dtype=np.int32)
            pos = np.clip(np.searchsorted(keys, p), 0, len(keys) - 1)
            hit = keys[pos] == p
            out[hit] = vals[pos[hit]]
        return out

    def po_index_batch(self, p: np.ndarray, o: np.ndarray) -> np.ndarray:
        """Vectorized :meth:`po_index` over (p, o) columns: tracked-PO
        feature index per row, ``-1`` where the pair is untracked. The
        batched half of the write path's routing (``repro_torch.write``) — one
        packed-key ``searchsorted`` over the tracked-PO table for the whole
        batch."""
        p = np.asarray(p, dtype=np.int64)
        o = np.asarray(o, dtype=np.int64)
        out = np.full(p.shape, -1, dtype=np.int32)
        if self._tracked_po and len(p):
            packed = (p << 32) | o
            keys = np.array(sorted(self._tracked_po), dtype=np.int64)
            vals = np.array([self._tracked_po[k] for k in keys.tolist()],
                            dtype=np.int32)
            pos = np.clip(np.searchsorted(keys, packed), 0, len(keys) - 1)
            hit = keys[pos] == packed
            out[hit] = vals[pos[hit]]
        return out

    # ------------------------------------------------------------------ #
    def query_features(self, q: Query, *, fine: bool = True) -> np.ndarray:
        """The query's P/PO feature set as sorted unique indices.

        ``fine=False`` is the Fig.-1 clustering granularity: PO features only
        for ``rdf:type`` patterns, plain P otherwise (Q2 there counts its
        constant-object ``subOrganizationOf`` as a P feature). ``fine=True``
        is the ownership/scoring granularity: any tracked (p, o) pair."""
        feats = set()
        for s, p, o in q.patterns:
            if is_var(p):
                continue
            if not is_var(o) and (fine or p == self.type_predicate):
                po = self.po_index(p, o)
                feats.add(po if po is not None else self.p_index(p))
            else:
                feats.add(self.p_index(p))
        return np.array(sorted(feats), dtype=np.int32)

    def workload_bitmaps(self, queries: Sequence[Query],
                         n_features: int | None = None) -> np.ndarray:
        """Packed uint32 bitmaps, one row per query (input to Jaccard)."""
        nf = n_features or self.n_features
        n_words = (nf + 31) // 32
        out = np.zeros((len(queries), n_words), dtype=np.uint32)
        # |= with duplicate word indices needs np.bitwise_or.at
        for i, q in enumerate(queries):
            f = self.query_features(q, fine=False)   # Fig.-1 granularity
            np.bitwise_or.at(out[i], f // 32,
                             (np.uint32(1) << (f % 32).astype(np.uint32)))
        return out

    # ------------------------------------------------------------------ #
    def triple_owners(self) -> np.ndarray:
        """Owner feature index per triple, (N,) int32. Vectorized re-keying."""
        t = self.store.triples
        p = t[:, 1].astype(np.int64)
        o = t[:, 2].astype(np.int64)
        owner = self.p_index_batch(p)
        assert len(owner) == 0 or owner.min() >= 0, \
            "store carries a predicate with no P feature"
        po = self.po_index_batch(p, o)
        hit = po >= 0
        owner[hit] = po[hit]
        return owner

    def feature_sizes(self, owners: np.ndarray | None = None) -> np.ndarray:
        owners = self.triple_owners() if owners is None else owners
        return np.bincount(owners, minlength=self.n_features).astype(np.int64)


@dataclasses.dataclass
class QueryStats:
    """Per-query join structure used by the Fig.-5 scoring statistics."""
    features: np.ndarray          # P/PO feature idx per pattern (len = #patterns)
    join_edges: List[Tuple[int, int, str]]   # (pat_i, pat_j, SSJ|OOJ|OSJ)


def query_stats(q: Query, space: FeatureSpace) -> QueryStats:
    from repro_torch.query.pattern import join_structure
    feats = []
    for s, p, o in q.patterns:
        if is_var(p):
            feats.append(-1)
            continue
        if not is_var(o):
            po = space.po_index(p, o)
            feats.append(po if po is not None else space.p_index(p))
        else:
            feats.append(space.p_index(p))
    return QueryStats(features=np.array(feats, dtype=np.int32),
                      join_edges=join_structure(q))
