"""Build the port's objects from plain state.

The system's state is data, not weights: a dictionary-encoded triple set,
a query workload, the feature universe, a feature->shard assignment and
replica holder masks. Each function here takes that state as plain numpy
arrays and Python values — as any other implementation of the system can
export it — and returns the ``repro_torch`` object that holds it, so one
dataset and one layout can be served by this package and compared with
another's.
"""
from __future__ import annotations

from typing import Dict, Iterable, Mapping, Sequence, Tuple

import numpy as np

from repro_torch.core.features import FeatureSpace
from repro_torch.core.partition import PartitionState
from repro_torch.graph import lubm
from repro_torch.graph.triples import Dictionary, TripleStore
from repro_torch.query.pattern import Query
from repro_torch.replicate import ReplicaMap


def dictionary(terms: Iterable[str]) -> Dictionary:
    """A ``Dictionary`` in which ``terms[i]`` has id ``i``."""
    d = Dictionary()
    for i, term in enumerate(terms):
        if d.encode(term) != i:
            raise ValueError(f"duplicate term {term!r}")
    return d


def triple_store(triples: np.ndarray, terms: Iterable[str]) -> TripleStore:
    """(N, 3) dictionary-encoded triples, in their row order, plus the
    dictionary's terms in id order -> ``TripleStore``."""
    return TripleStore(np.array(triples, dtype=np.int32), dictionary(terms))


def query(spec: Tuple) -> Query:
    """``(name, patterns, frequency, shape)`` -> ``Query``."""
    name, patterns, frequency, shape = spec
    return Query(name=str(name),
                 patterns=tuple(tuple(int(x) for x in p) for p in patterns),
                 frequency=float(frequency), shape=str(shape))


def feature_space(store: TripleStore, keys: Iterable[Tuple],
                  type_predicate: "int | None" = None) -> FeatureSpace:
    """A ``FeatureSpace`` over ``store`` whose feature ``i`` is
    ``keys[i]`` (``("P", p)`` or ``("PO", p, o)``), so that assignments
    indexed by feature carry over unchanged."""
    space = FeatureSpace(store, type_predicate=type_predicate)
    for key in keys:
        if key[0] == "PO":
            space.track_po(key[1], key[2])
        else:
            space.track_p(key[1])
    keys = [tuple(k) for k in keys]
    if space.feature_keys() != keys:
        raise ValueError("feature keys are not in the order this store "
                         "and type predicate produce")
    return space


def partition_state(feature_to_shard: np.ndarray, feature_sizes: np.ndarray,
                    n_shards: int) -> PartitionState:
    """A feature->shard assignment -> ``PartitionState``."""
    return PartitionState(np.array(feature_to_shard, dtype=np.int32),
                          np.array(feature_sizes, dtype=np.int64),
                          int(n_shards))


def replica_map(masks: np.ndarray, n_shards: int) -> ReplicaMap:
    """Per-feature holder bitmasks (bit ``s`` set: shard ``s`` holds a copy)
    -> ``ReplicaMap``."""
    return ReplicaMap(np.array(masks, dtype=np.uint64), int(n_shards))


def lubm_dataset(triples: np.ndarray, terms: Sequence[str],
                 named: Mapping[str, int], queries: Iterable[Tuple],
                 n_universities: int) -> lubm.LubmDataset:
    """A LUBM dataset (store, dictionary, named entities, benchmark
    queries) from its plain state."""
    store = triple_store(triples, terms)
    qs: Dict[str, Query] = {}
    for spec in queries:
        q = query(spec)
        qs[q.name] = q
    return lubm.LubmDataset(store=store, dictionary=store.dictionary,
                            named=lubm.Named(**{k: int(v)
                                                for k, v in named.items()}),
                            queries=qs, n_universities=int(n_universities))
