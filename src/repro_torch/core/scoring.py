"""Fig.-5 scoring: key-feature statistics S_K and shard scores.

The paper's pseudo-code (lines 7–12) scores every key feature F_K against
every shard:

    S_K(c)     = p_c*w1 + q_c*w2 + s_c*w3 + p_t*w4 + q_t*w5 + s_t*w6
    Score(F_K, c) = [colocated-join gain](c) * w_dj * f   +   S_K(c)

with the statistics (Sec. III.B, "The statistics use other feature patterns,
such as SSJ, OOJ and OSJ and distributed joins in queries"):

  p — peer features: features adjacent to F_K through a join edge
      (SSJ/OOJ/OSJ) in some workload query. ``p_c`` counts peers already
      resident on shard c; ``p_t`` is the total number of distinct peers.
  q — out-degree (hops): join edges leaving F_K's patterns. ``q_c`` weights
      each query's out-degree by the fraction of its features on shard c;
      ``q_t`` is the frequency-weighted total.
  s — triple-size ratio of F_K within shard c (``s_c``) and within the whole
      dataset (``s_t``).

The distributed-join term: D(F_K, c) = frequency-weighted number of join
edges incident to F_K whose peer feature is *not* on shard c. The paper keeps
``min(D_QR)``; equivalently we add the *gain* ``max_c' D - D(c)`` so the
argmax-score shard is the min-distributed-join shard, with S_K refining ties.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np

from repro_torch.core.features import FeatureSpace, query_stats
from repro_torch.core.partition import PartitionState
from repro_torch.query.pattern import Query


@dataclasses.dataclass
class ScoreWeights:
    w1: float = 1.0      # peers in shard
    w2: float = 0.5      # out-degree share in shard
    w3: float = 2.0      # size ratio in shard
    w4: float = 0.1      # total peers
    w5: float = 0.1      # total out-degree
    w6: float = 0.1      # total size ratio
    w_dj: float = 10.0   # distributed-join gain weight


@dataclasses.dataclass
class WorkloadStats:
    """Join-structure statistics for a workload, keyed by feature index."""
    key_features: np.ndarray                  # (K,) feature idx in workload
    peers: Dict[int, set]                     # feature -> peer feature set
    out_degree: Dict[int, float]              # feature -> freq-weighted degree
    feature_freq: Dict[int, float]            # feature -> summed query frequency
    join_edges: List[tuple]                   # (feat_a, feat_b, freq, kind)


def workload_stats(queries: Sequence[Query], space: FeatureSpace) -> WorkloadStats:
    peers: Dict[int, set] = {}
    out_degree: Dict[int, float] = {}
    feature_freq: Dict[int, float] = {}
    join_edges: List[tuple] = []
    keys: set = set()
    for q in queries:
        st = query_stats(q, space)
        for f in st.features:
            if f >= 0:
                keys.add(int(f))
                feature_freq[int(f)] = feature_freq.get(int(f), 0.0) + q.frequency
        for i, j, kind in st.join_edges:
            fa, fb = int(st.features[i]), int(st.features[j])
            if fa < 0 or fb < 0:
                continue
            join_edges.append((fa, fb, q.frequency, kind))
            for a, b in ((fa, fb), (fb, fa)):
                peers.setdefault(a, set()).add(b)
                out_degree[a] = out_degree.get(a, 0.0) + q.frequency
    return WorkloadStats(
        key_features=np.array(sorted(keys), dtype=np.int32),
        peers=peers, out_degree=out_degree, feature_freq=feature_freq,
        join_edges=join_edges)


def distributed_joins(stats: WorkloadStats, state: PartitionState) -> float:
    """Frequency-weighted count of join edges crossing shard boundaries."""
    total = 0.0
    f2s = state.feature_to_shard
    for fa, fb, freq, _ in stats.join_edges:
        if f2s[fa] != f2s[fb]:
            total += freq
    return total


def score_matrix(stats: WorkloadStats, state: PartitionState,
                 weights: ScoreWeights | None = None) -> np.ndarray:
    """(K, n_shards) score for each key feature on each candidate shard."""
    w = weights or ScoreWeights()
    keys = stats.key_features
    n_sh = state.n_shards
    f2s = state.feature_to_shard
    sizes = state.feature_sizes.astype(np.float64)
    shard_sz = np.maximum(state.shard_sizes().astype(np.float64), 1.0)
    total_sz = max(sizes.sum(), 1.0)

    scores = np.zeros((len(keys), n_sh))
    for ki, k in enumerate(keys.tolist()):
        peer_list = list(stats.peers.get(k, ()))
        peer_shards = f2s[peer_list] if peer_list else np.empty(0, np.int64)
        p_t = float(len(peer_list))
        q_t = stats.out_degree.get(k, 0.0)
        s_t = float(sizes[k]) / total_sz
        freq = stats.feature_freq.get(k, 1.0)

        # distributed joins of k per candidate shard
        dj = np.zeros(n_sh)
        for fa, fb, f_q, _ in stats.join_edges:
            if fa == k and fb != k:
                dj += f_q * (np.arange(n_sh) != f2s[fb])
            elif fb == k and fa != k:
                dj += f_q * (np.arange(n_sh) != f2s[fa])
        dj_gain = dj.max() - dj   # max at the min-distributed-join shard

        for c in range(n_sh):
            p_c = float((peer_shards == c).sum())
            q_c = q_t * (p_c / max(p_t, 1.0))
            s_c = float(sizes[k]) / shard_sz[c]
            s_k = (p_c * w.w1 + q_c * w.w2 + s_c * w.w3
                   + p_t * w.w4 + q_t * w.w5 + s_t * w.w6)
            scores[ki, c] = dj_gain[c] * w.w_dj * freq + s_k
    return scores
