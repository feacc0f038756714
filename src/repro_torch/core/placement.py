"""AWAPart applied inside the LM framework: workload-aware expert & vocab placement.

Counterpart of ``repro/core/placement.py``. The mapping from the paper's
domain:

    SPARQL query            ->  request (sequence) routed through a MoE layer
    P/PO feature            ->  expert
    feature co-occurrence   ->  expert co-activation (same request, same layer)
    triples of a feature    ->  the expert's weight tensors
    shard                   ->  expert-parallel rank
    distributed join        ->  extra all-to-all destination rank per token
    triple migration        ->  expert weight permutation between ranks
    accept/revert guard     ->  measured avg distinct-ranks-per-token objective

Rank-granularity dispatch ships each token once per distinct destination
rank, so clustering co-activated experts onto the same rank cuts
all-to-all bytes exactly the way co-locating a query's features cuts
distributed joins.

Vocab placement: token co-occurrence drives a vocabulary permutation that
balances hot embedding rows across the shards (the paper's balance
constraint, applied to the embedding gather load).

The planning is the reference's host numpy, with two changes: the expert
distance matrix comes from the Jaccard kernel on ``device`` (the card
unless the caller asks for the CPU), and :func:`apply_expert_placement`
permutes torch tensors on their own device; :func:`migrate_experts` does
the same across the ranks of a ``models.moe.ShardCtx`` that hold them: the
paper's triple exchange between shards.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import hac
from repro_torch.kernels.jaccard import ops as jaccard_ops


# --------------------------------------------------------------------------- #
# expert placement
# --------------------------------------------------------------------------- #

def coactivation_bitmaps(routing: np.ndarray, n_experts: int,
                         n_requests: int) -> np.ndarray:
    """routing: (n_requests, k) expert ids per request (one MoE layer).

    Returns packed uint32 bitmaps (n_experts, ceil(n_requests/32)): expert e's
    bitmap marks the requests that activated it — the transpose of the KG
    case (features described by the queries that touch them)."""
    words = (n_requests + 31) // 32
    bm = np.zeros((n_experts, words), dtype=np.uint32)
    for r in range(routing.shape[0]):
        for e in np.unique(routing[r]):
            bm[e, r // 32] |= np.uint32(1) << np.uint32(r % 32)
    return bm


def cluster_experts(bitmaps: np.ndarray, *, linkage: str = "average",
                    cut_distance: float = 0.6, device="cuda") -> np.ndarray:
    """Flat cluster labels of the experts: Jaccard distances of their
    co-activation bitmaps on ``device`` (the kernel on a CUDA device), then
    ``hac_numpy`` and the cut on the host."""
    dist = jaccard_ops.jaccard_distance(bitmaps, device=device).cpu().numpy()
    z = hac.hac_numpy(dist, linkage)
    return hac.cut(z, cut_distance)


def place_clusters(labels: np.ndarray, loads: np.ndarray,
                   n_ranks: int) -> np.ndarray:
    """Bin-pack expert clusters onto ranks with exactly E/n_ranks slots each.

    Returns ``expert_to_rank`` (E,). Clusters are split only when they exceed
    the per-rank slot budget (the paper's oversized-group fallback); packing
    order is by cluster token load, heaviest first, into the least-loaded
    rank with room (balance constraint)."""
    e = len(labels)
    slots = e // n_ranks
    rank_free = np.full(n_ranks, slots)
    rank_load = np.zeros(n_ranks)
    expert_to_rank = np.full(e, -1, dtype=np.int32)

    clusters = []
    for lbl in np.unique(labels):
        members = np.where(labels == lbl)[0]
        clusters.append((members, float(loads[members].sum())))
    clusters.sort(key=lambda c: -c[1])

    for members, load in clusters:
        # order members by load so splits keep heavy experts together
        members = members[np.argsort(-loads[members])]
        idx = 0
        while idx < len(members):
            candidates = np.where(rank_free > 0)[0]
            take_rank = candidates[np.argmin(rank_load[candidates])]
            take = members[idx: idx + rank_free[take_rank]]
            expert_to_rank[take] = take_rank
            rank_free[take_rank] -= len(take)
            rank_load[take_rank] += float(loads[take].sum())
            idx += len(take)
    assert (expert_to_rank >= 0).all()
    return expert_to_rank


def rank_map_to_perm(expert_to_rank: np.ndarray) -> np.ndarray:
    """expert_to_rank -> physical slot permutation.

    ``perm[slot] = logical expert`` with rank r owning slots
    [r*E_loc, (r+1)*E_loc). ``inv_perm = argsort(perm)`` maps logical->slot."""
    order = np.lexsort((np.arange(len(expert_to_rank)), expert_to_rank))
    return order.astype(np.int32)


def avg_distinct_ranks(routing: np.ndarray, expert_to_rank: np.ndarray,
                       n_ranks: int) -> float:
    """The dispatch-bytes objective: mean distinct destination ranks per
    token (= SERVICE calls per federated query)."""
    ranks = expert_to_rank[routing]                     # (T, k)
    distinct = np.array([len(np.unique(r)) for r in ranks])
    return float(distinct.mean())


@dataclasses.dataclass
class PlacementReport:
    accepted: bool
    ranks_before: float
    ranks_after: float
    moved_experts: int
    migration_bytes: int

    @property
    def bytes_saved_frac(self) -> float:
        if self.ranks_before <= 0:
            return 0.0
        return 1.0 - self.ranks_after / self.ranks_before


def plan_expert_placement(routing: np.ndarray, n_experts: int, n_ranks: int,
                          old_expert_to_rank: Optional[np.ndarray] = None,
                          expert_bytes: int = 0, *,
                          cut_distance: float = 0.6, device="cuda",
                          ) -> Tuple[np.ndarray, PlacementReport]:
    """One adaptation round for a single MoE layer.

    routing: (T, k) token->expert assignments observed since the last round.
    Returns (new expert_to_rank, report); reverts (returns the old map) if
    the distinct-ranks objective does not improve — the Fig.-5 guard.
    ``device`` computes the Jaccard matrix (the kernel on a CUDA device)."""
    e_loc = n_experts // n_ranks
    if old_expert_to_rank is None:
        old_expert_to_rank = np.repeat(np.arange(n_ranks), e_loc).astype(
            np.int32)
    loads = np.bincount(routing.reshape(-1), minlength=n_experts).astype(
        np.float64)
    n_req = routing.shape[0]
    bm = coactivation_bitmaps(routing, n_experts, n_req)
    labels = cluster_experts(bm, cut_distance=cut_distance, device=device)
    new_map = place_clusters(labels, loads, n_ranks)

    before = avg_distinct_ranks(routing, old_expert_to_rank, n_ranks)
    after = avg_distinct_ranks(routing, new_map, n_ranks)
    moved = int((new_map != old_expert_to_rank).sum())
    # the Fig.-5 guard, with a minimum-gain margin so marginal re-plans do
    # not churn expert weights for nothing
    if after < 0.99 * before:
        return new_map, PlacementReport(True, before, after, moved,
                                        moved * expert_bytes)
    return old_expert_to_rank, PlacementReport(False, before, after, 0, 0)


def _new_layout(moe_params: Mapping[str, torch.Tensor],
                expert_to_rank: np.ndarray):
    """(gather, state): each new slot's current slot, and ``moe_params``
    with the logical->slot map ``inv_perm`` (int32, on its device) of the
    new layout and every other entry passed through."""
    cur_inv = moe_params["inv_perm"].cpu().numpy()       # logical -> old slot
    perm_new = rank_map_to_perm(expert_to_rank)         # new slot -> logical
    # new slot s' holds logical expert perm_new[s'], currently stored at
    # old slot cur_inv[perm_new[s']]
    out = dict(moe_params)
    out["inv_perm"] = torch.from_numpy(
        np.argsort(perm_new).astype(np.int32)).to(
            moe_params["inv_perm"].device)
    return cur_inv[perm_new].astype(np.int64), out


def apply_expert_placement(moe_params: Mapping[str, torch.Tensor],
                           expert_to_rank: np.ndarray
                           ) -> Dict[str, torch.Tensor]:
    """Migrate expert weights to their new physical slots (the triple-swap).

    moe_params: one layer's {"wg","wi","wo","inv_perm",...} tensors (an MoE
    module's ``state_dict()``); returns a new dict with the stacked weights
    permuted on their own device (one ``index_select`` each) and the
    logical->slot map ``inv_perm`` (int32, on its device) updated; the
    other entries pass through. Composes with the CURRENT physical layout
    (repeated migrations are the normal case — like successive triple
    exchanges). Load it back with ``MoE.load_state_dict``."""
    gather, out = _new_layout(moe_params, expert_to_rank)
    for w in ("wg", "wi", "wo"):
        t = moe_params[w]
        out[w] = t.index_select(0, torch.from_numpy(gather).to(t.device))
    return out


def migrate_experts(moe_params: Mapping[str, torch.Tensor],
                    expert_to_rank: np.ndarray, ctx
                    ) -> Tuple[Dict[str, torch.Tensor], int]:
    """:func:`apply_expert_placement` across the ranks that hold the
    experts: the paper's triple exchange between shards. ``ctx`` is a
    ``models.moe.ShardCtx``; every rank of its tp group calls with the
    same map, and ``moe_params`` holds this rank's slots. Returns
    ``(state, bytes)``: the state holds slots ``[r*E_loc, (r+1)*E_loc)``
    of the one-device result, bit for bit, and ``bytes`` is what this rank
    sent. Each stacked leaf takes one all-to-all over the tp group
    carrying only the experts that change rank; the others move within
    the rank."""
    gather, out = _new_layout(moe_params, expert_to_rank)
    tp, r = ctx.tp, ctx.tp_rank
    e_loc = len(gather) // tp
    if moe_params["wg"].shape[0] != e_loc:
        raise ValueError(f"the rank holds {moe_params['wg'].shape[0]} "
                         f"experts, not {len(gather)}/{tp}")
    src = gather // e_loc                    # each new slot's current rank
    # to rank q: q's new slots whose expert is here, in slot order
    sends = [np.flatnonzero(src[q * e_loc:(q + 1) * e_loc] == r) + q * e_loc
             if q != r else np.empty(0, np.int64) for q in range(tp)]
    send_rows = np.concatenate(sends)
    mine = np.arange(r * e_loc, (r + 1) * e_loc)
    recv_counts = [int((src[mine] == q).sum()) if q != r else 0
                   for q in range(tp)]
    # each new local slot's row in cat(held, received): received rows come
    # source by source, each source's in slot order
    index = np.empty(e_loc, np.int64)
    start = np.cumsum([0] + recv_counts)[:-1]
    for j, s_new in enumerate(mine):
        q = src[s_new]
        if q == r:
            index[j] = gather[s_new] - r * e_loc
        else:
            index[j] = e_loc + start[q]
            start[q] += 1
    group = ctx.mesh.get_group(ctx.tp_axis)
    sent = 0
    for w in ("wg", "wi", "wo"):
        t = moe_params[w]
        send = t.index_select(0, torch.from_numpy(
            gather[send_rows] - r * e_loc).to(t.device))
        recv = t.new_empty((sum(recv_counts),) + tuple(t.shape[1:]))
        dist.all_to_all_single(recv, send, output_split_sizes=recv_counts,
                               input_split_sizes=[len(x) for x in sends],
                               group=group)
        out[w] = torch.cat([t, recv]).index_select(
            0, torch.from_numpy(index).to(t.device))
        sent += send.numel() * send.element_size()
    return out, sent


# --------------------------------------------------------------------------- #
# vocabulary placement
# --------------------------------------------------------------------------- #

def vocab_permutation(token_counts: np.ndarray, n_shards: int) -> np.ndarray:
    """Balance hot tokens across vocab shards: sort by frequency, deal
    round-robin in serpentine order. Returns perm: new_id -> old_id with
    contiguous blocks per shard."""
    v = len(token_counts)
    per = v // n_shards
    order = np.argsort(-token_counts)
    shard_rows: List[List[int]] = [[] for _ in range(n_shards)]
    direction = 1
    s = 0
    for tok in order.tolist():
        shard_rows[s].append(tok)
        s += direction
        if s == n_shards or s < 0:
            direction *= -1
            s += direction
    perm = np.concatenate([np.array(rows[:per] + rows[per:], dtype=np.int64)
                           for rows in shard_rows])
    return perm.astype(np.int32)


def shard_gather_imbalance(token_counts: np.ndarray, perm: np.ndarray,
                           n_shards: int) -> float:
    """max/mean embedding-gather load across shards (1.0 = balanced)."""
    v = len(perm)
    per = v // n_shards
    loads = np.array([token_counts[perm[i * per:(i + 1) * per]].sum()
                      for i in range(n_shards)], dtype=np.float64)
    return float(loads.max() / max(loads.mean(), 1e-9))
