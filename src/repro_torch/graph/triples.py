"""Dictionary-encoded RDF triple store.

The paper stores triples in Virtuoso instances; the TPU-native analogue is a
dictionary-encoded ``int32 (N, 3)`` array with sorted permutation indexes
(SPO / POS / OSP), so any triple pattern resolves to a contiguous index range
via binary search — the same role Lucene plays for AWAPart's initial
partitioning.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

S, P, O = 0, 1, 2


class Dictionary:
    """Bidirectional term <-> id mapping (RDF dictionary encoding)."""

    def __init__(self) -> None:
        self._term_to_id: Dict[str, int] = {}
        self._id_to_term: List[str] = []

    def encode(self, term: str) -> int:
        tid = self._term_to_id.get(term)
        if tid is None:
            tid = len(self._id_to_term)
            self._term_to_id[term] = tid
            self._id_to_term.append(term)
        return tid

    def lookup(self, term: str) -> Optional[int]:
        return self._term_to_id.get(term)

    def decode(self, tid: int) -> str:
        return self._id_to_term[tid]

    def __len__(self) -> int:
        return len(self._id_to_term)


def _sort_index(triples: np.ndarray, order: Tuple[int, int, int]) -> np.ndarray:
    """Permutation sorting ``triples`` lexicographically by the given column order."""
    # np.lexsort keys: last key is primary.
    keys = tuple(triples[:, c] for c in reversed(order))
    return np.lexsort(keys).astype(np.int64)


@dataclasses.dataclass
class TripleStore:
    """Immutable dictionary-encoded triple set with SPO/POS/OSP indexes."""

    triples: np.ndarray                 # (N, 3) int32
    dictionary: Dictionary
    spo: np.ndarray = dataclasses.field(default=None)  # type: ignore[assignment]
    pos: np.ndarray = dataclasses.field(default=None)  # type: ignore[assignment]
    osp: np.ndarray = dataclasses.field(default=None)  # type: ignore[assignment]

    def __post_init__(self) -> None:
        assert self.triples.ndim == 2 and self.triples.shape[1] == 3
        self.triples = np.ascontiguousarray(self.triples, dtype=np.int32)
        if self.spo is None:
            self.spo = _sort_index(self.triples, (S, P, O))
        if self.pos is None:
            self.pos = _sort_index(self.triples, (P, O, S))
        if self.osp is None:
            self.osp = _sort_index(self.triples, (O, S, P))
        self._sorted_views: Dict[str, np.ndarray] = {}

    def _sorted_view(self, which: str) -> np.ndarray:
        """A permutation's sorted triple matrix, materialized lazily on the
        first pattern lookup that probes it, so a match is pure binary
        search (no O(N) gather per call) without paying memory for
        permutations a store never queries."""
        view = self._sorted_views.get(which)
        if view is None:
            view = np.ascontiguousarray(self.triples[getattr(self, which)])
            self._sorted_views[which] = view
        return view

    # ------------------------------------------------------------------ #
    @property
    def n_triples(self) -> int:
        return int(self.triples.shape[0])

    def _range(self, view: np.ndarray, cols: Sequence[int],
               vals: Sequence[int]) -> Tuple[int, int]:
        """[lo, hi) range in the sorted ``view`` matching vals on prefix cols."""
        # successive binary searches on each prefix column
        lo, hi = 0, view.shape[0]
        for c, v in zip(cols, vals):
            col = view[lo:hi, c]
            lo2 = lo + int(np.searchsorted(col, v, side="left"))
            hi2 = lo + int(np.searchsorted(col, v, side="right"))
            lo, hi = lo2, hi2
            if lo >= hi:
                return lo, lo
        return lo, hi

    def match(self, s: Optional[int], p: Optional[int],
              o: Optional[int]) -> np.ndarray:
        """Return (M, 3) triples matching the pattern; None = wildcard."""
        return self.triples[self.match_indices(s, p, o)]

    def match_indices(self, s: Optional[int], p: Optional[int],
                      o: Optional[int]) -> np.ndarray:
        """Row indices (into ``triples``) matching the pattern; None = wildcard.

        The permutation values in the sorted indexes *are* row ids, so
        ``match`` is just this plus a gather."""
        if s is not None and p is None and o is None:
            lo, hi = self._range(self._sorted_view("spo"), (S,), (s,))
            return self.spo[lo:hi]
        if s is not None and p is not None and o is None:
            lo, hi = self._range(self._sorted_view("spo"), (S, P), (s, p))
            return self.spo[lo:hi]
        if s is not None and p is not None and o is not None:
            lo, hi = self._range(self._sorted_view("spo"), (S, P, O),
                                 (s, p, o))
            return self.spo[lo:hi]
        if p is not None and o is None and s is None:
            lo, hi = self._range(self._sorted_view("pos"), (P,), (p,))
            return self.pos[lo:hi]
        if p is not None and o is not None and s is None:
            lo, hi = self._range(self._sorted_view("pos"), (P, O), (p, o))
            return self.pos[lo:hi]
        if o is not None and s is None and p is None:
            lo, hi = self._range(self._sorted_view("osp"), (O,), (o,))
            return self.osp[lo:hi]
        if o is not None and s is not None and p is None:
            lo, hi = self._range(self._sorted_view("osp"), (O, S), (o, s))
            return self.osp[lo:hi]
        return np.arange(self.n_triples, dtype=np.int64)  # fully unbound

    def count(self, s: Optional[int], p: Optional[int], o: Optional[int]) -> int:
        return int(self.match_indices(s, p, o).shape[0])

    # ------------------------------------------------------------------ #
    # live mutation (repro_torch.write)
    # ------------------------------------------------------------------ #
    def apply_mutation(self, inserts: np.ndarray,
                       delete_rows: np.ndarray) -> np.ndarray:
        """Mutate the store in place: drop the rows in ``delete_rows``
        (global row ids), append ``inserts`` ((M, 3) int32 triples assumed
        not already present), and rebuild the SPO/POS/OSP permutations.

        Mutating *in place* is what keeps every holder of this store object
        (``FeatureSpace.store``, ``KGService.store``, the facade and its
        untouched shard views) consistent without re-wiring references.

        Returns the old-row -> new-row remap, (N_old,) int64 with ``-1`` for
        deleted rows. Surviving rows keep their relative order and inserts
        append after them, so with no deletes the remap is the identity and
        callers may skip re-indexing entirely.
        """
        delete_rows = np.asarray(delete_rows, dtype=np.int64)
        inserts = np.asarray(inserts, dtype=np.int32).reshape(-1, 3)
        n_old = self.n_triples
        remap = np.arange(n_old, dtype=np.int64)
        if len(delete_rows):
            keep = np.ones(n_old, dtype=bool)
            keep[delete_rows] = False
            remap[~keep] = -1
            remap[keep] = np.arange(int(keep.sum()), dtype=np.int64)
            triples = self.triples[keep]
        else:
            triples = self.triples
        if len(inserts):
            triples = np.concatenate([triples, inserts])
        if triples is not self.triples:
            self.triples = np.ascontiguousarray(triples, dtype=np.int32)
            self.spo = _sort_index(self.triples, (S, P, O))
            self.pos = _sort_index(self.triples, (P, O, S))
            self.osp = _sort_index(self.triples, (O, S, P))
            self._sorted_views.clear()
        return remap


def build_store(triples: np.ndarray, dictionary: Dictionary) -> TripleStore:
    # drop duplicate triples (materialization can produce them)
    uniq = np.unique(triples, axis=0)
    return TripleStore(triples=uniq, dictionary=dictionary)
