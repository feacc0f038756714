"""Mixture-of-Experts, on one device or expert-parallel across ranks.

Counterpart of ``repro/models/moe.py``. With no :class:`ShardCtx` (or a
mesh of one rank) :func:`moe_apply` computes the reference's
``moe_apply_dense`` function; with one it runs the reference's
expert-parallel dispatch over the ``tp`` axis of a ``DeviceMesh``, in one
of two modes (``cfg.moe_dispatch``):

* ``"expert"`` — GShard-style baseline: every (token, routed-expert) pair
  is shipped to the expert's rank in per-expert capacity buffers.
* ``"rank"`` — **AWAPart-placed dispatch**: a token is shipped **once per
  distinct rank** owning any of its top-k experts (the federated-query
  SERVICE-call dedup), so co-locating co-activated experts
  (``core/placement.py``) cuts the (token, rank) rows a dispatch occupies.
  The bytes on the wire do not shrink with them: the buffers' capacities
  are static, set by the capacity factor alone.

The logical->physical expert map lives in ``inv_perm`` (int32, a buffer,
not trained): expert ``e``'s weights sit in slot ``inv_perm[e]`` of the
stacked ``wg``/``wi``/``wo``. Migration permutes the stacked weights and
rewrites the map (``core.placement.apply_expert_placement``), the
analogue of exchanging triples between shards and updating PMeta. Across
``tp`` ranks a rank's module holds the slots ``[r*E_loc, (r+1)*E_loc)``
(:func:`expert_slice`, the reference's ``P(tp, None, None)``); the router
and ``inv_perm`` are whole on every rank.

One device: where the reference runs every token through every expert and
adds ``w_e`` times the product (zero for a token not routed to ``e``),
this layer computes each routed expert on its own tokens only (``E/k``
times fewer expert FLOPs) and adds the products into ``y`` in the compute
dtype, logical expert by logical expert in increasing id: the reference's
summation order, since the zero terms it adds are exact. The result
therefore does not depend on the placement, bit for bit.

Across ranks: the reference's function, with its static capacities
(:func:`_capacity`), the stable sort that decides which pairs are dropped,
the ``-1``/``0`` fill of empty rows, ``valid = ... & (w > 0)`` and the
two-level capacity of rank mode. Each dispatch block is written once, as
a generator that yields the buffers it ships and receives what the
all-to-all returns: :func:`moe_apply` drives it with
``torch.distributed.all_to_all_single`` over the ``tp`` group (the
buffers of one exchange packed into one byte buffer); the plain twin
:func:`moe_apply_ranks_plain` drives every rank's block in one process,
each all-to-all a transpose of the stacked buffers, so the two agree bit
for bit on the CPU. The dispatch reckons the bytes each all-to-all puts
on the wire from its static buffers, ``(g - 1)/g`` of the buffer (the
reference's ``launch/hlo_analysis.py`` rule), and returns them beside the
output (:class:`DispatchStats`). Nothing here names a backend: the
process group behind the mesh is the caller's.

Autograd runs through the distributed layer. Each collective is an
autograd Function whose backward is its adjoint: an all-to-all (row r to
rank r) is its own, and only its floating buffers carry a cotangent; the
sequence slice's is the all-gather of the slices' cotangents over tp; the
all-gather of ``y`` takes this rank's slice of the incoming cotangent.
Everything downstream of the layer runs the same on every tp rank, so a
value the tp ranks share is one value: its cotangent is taken once. Where
every tp rank uses a whole tensor for its part of the work (the router;
the tokens themselves when they are replicated over tp) the parts'
cotangents are summed over tp in rank order, the same bits on every rank;
with replicated tokens only tp rank 0's output carries a cotangent (every
rank keeps its result); and a mean over ranks (aux over tp and dp, the
loss over dp) passes each rank's own term alone its share. A rank's
gradients are then those of its dp slice's share of the loss: whole
leaves the same on every tp rank, expert leaves its slots'; summing them
over the dp axes (``models.lm.reduce_grads``) gives the reference's. The
plain twin reaches the same gradients through plain autograd, bit for
bit.
"""
from __future__ import annotations

import dataclasses
import math
from typing import (Any, Dict, Generator, List, Mapping, NamedTuple,
                    Optional, Tuple)

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import _param, dtype
from repro_torch.optim.adamw import sum_in_order


class MoE(nn.Module):
    """Router ``wr`` (d, E), float32 whatever the parameter dtype; stacked
    experts ``wg``/``wi`` (E, d, f) and ``wo`` (E, f, d) in the compute
    dtype; ``inv_perm`` (E,) int32, logical expert -> physical slot."""

    def __init__(self, cfg: ArchConfig, w: Mapping[str, torch.Tensor]):
        super().__init__()
        cd = dtype(cfg.compute_dtype)
        self.wr = _param(w["wr"], torch.float32)
        self.wg = _param(w["wg"], cd)
        self.wi = _param(w["wi"], cd)
        self.wo = _param(w["wo"], cd)
        self.register_buffer("inv_perm",
                             w["inv_perm"].to(torch.int32).contiguous())


def _router(p: MoE, x2d: torch.Tensor, cfg: ArchConfig):
    """Top-k routing in float32. x2d: (T, d) -> weights/ids (T, k), aux
    loss (Switch-style load balance: E * sum_e f_e * P_e)."""
    logits = x2d.to(torch.float32) @ p.wr.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)                        # (T, E)
    topw, topi = torch.topk(probs, cfg.top_k, dim=-1)            # (T, k)
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    e = cfg.n_experts
    frac = torch.zeros(e, dtype=torch.float32, device=x2d.device)
    frac.index_add_(0, topi.reshape(-1), torch.full(
        (topi.numel(),), 1.0 / topi.numel(), device=x2d.device))
    aux = e * (frac * probs.mean(0)).sum()
    return topw, topi, aux


def _expert_ffn(wg, wi, wo, x, cfg: ArchConfig):
    """x: (C, d) tokens of one expert, with its (d, f), (d, f) and (f, d)
    weights in the compute dtype -> (C, d), in the reference's order of
    operations; or (E_loc, C, d) grouped tokens with the stacked (E_loc,
    ...) weights -> (E_loc, C, d), the reference's batched ``einsum``s."""
    h = x @ wi
    if cfg.activation == "silu":
        h = F.silu(x @ wg) * h
    else:
        h = F.gelu(h, approximate="tanh")
    return h @ wo


def meta_routes(n_pairs: int, n_experts: int) -> list:
    """The group sizes :func:`moe_apply` takes on the meta device (the dry
    run), where no route can be read: the ``n_pairs`` (token, expert)
    pairs spread as evenly as they go, ``n_pairs // n_experts`` or one
    more an expert (the first ones), summing to ``n_pairs``. The experts'
    FLOPs do not depend on the routes, so they count exactly."""
    q, r = divmod(n_pairs, n_experts)
    return [q + (i < r) for i in range(n_experts)]


def moe_apply(p: MoE, x: torch.Tensor, cfg: ArchConfig,
              ctx: "ShardCtx | None" = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y, aux). With a :class:`ShardCtx` over more than
    one rank, the expert-parallel dispatch (:func:`moe_dispatch`; ``x`` is
    then this rank's batch slice). Without, ``moe_apply_dense``'s function:
    the
    (token, expert) pairs are grouped by logical expert with a stable sort;
    one device->host read a call fetches the group sizes and the slot map,
    and only the experts that received tokens run. On the meta device the
    routes are :func:`meta_routes`' balanced ones, the slot map the
    identity."""
    if ctx is not None and ctx.tp * ctx.dp > 1:
        y, aux, stats = moe_dispatch(p, x, cfg, ctx)
        # a checkpointed block's recompute dispatches again inside
        # autograd's backward: the first run's stats stand for it
        if (ctx.dispatch_log is not None
                and torch._C._current_graph_task_id() == -1):
            ctx.dispatch_log.append(stats)
        return y, aux
    cd = dtype(cfg.compute_dtype)
    b, s, d = x.shape
    x2 = x.reshape(-1, d).to(cd)
    topw, topi, aux = _router(p, x2, cfg)
    k, e = cfg.top_k, cfg.n_experts
    flat = topi.reshape(-1)
    order = torch.argsort(flat, stable=True)
    tok = order // k                           # each group's tokens, rising
    w = topw.reshape(-1)[order].to(cd)
    if x.device.type == "meta":     # the dry run: no route can be read
        meta = meta_routes(flat.numel(), e) + list(range(e))
    else:
        counts = torch.bincount(flat, minlength=e)
        meta = torch.cat([counts, p.inv_perm.to(counts.dtype)]).tolist()
    y = torch.zeros_like(x2)
    start = 0
    for ex in range(e):                        # logical id, increasing
        c = meta[ex]
        if not c:
            continue
        slot = meta[e + ex]
        rows = tok[start:start + c]
        out = _expert_ffn(p.wg[slot], p.wi[slot], p.wo[slot],
                          x2.index_select(0, rows), cfg)
        y.index_add_(0, rows, out * w[start:start + c, None])
        start += c
    return y.reshape(b, s, d).to(x.dtype), aux


# --------------------------------------------------------------------------- #
# expert-parallel dispatch
# --------------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Mesh context threaded through the model's apply functions: a
    ``torch.distributed`` ``DeviceMesh`` (``launch.mesh``) over an
    initialised process group, its batch axes (e.g. ``("pod", "data")``),
    the expert-parallel axis, and whether the dispatch splits a rank's
    tokens over ``tp`` by sequence where the length divides (a prefill);
    otherwise they are split by batch only and replicated over ``tp`` (the
    decode steps). Where ``dispatch_log`` is a list, :func:`moe_apply`
    appends each dispatch's :class:`DispatchStats` to it (not a remat
    recompute's)."""
    mesh: Any
    dp_axes: Tuple[str, ...]
    tp_axis: str = "model"
    seq_shard_moe: bool = True
    dispatch_log: Optional[list] = dataclasses.field(default=None,
                                                     compare=False)

    def size(self, axis: str) -> int:
        return self.mesh.shape[self.mesh.mesh_dim_names.index(axis)]

    @property
    def tp(self) -> int:
        return self.size(self.tp_axis)

    @property
    def dp(self) -> int:
        return math.prod(self.size(a) for a in self.dp_axes)

    @property
    def tp_rank(self) -> int:
        return self.mesh.get_local_rank(self.tp_axis)

    @property
    def dp_rank(self) -> int:
        """This rank's batch slice: its coordinates on the dp axes, row
        major (the reference's ``P(dp_axes)``)."""
        r = 0
        for a in self.dp_axes:
            r = r * self.size(a) + self.mesh.get_local_rank(a)
        return r


class ExpertShard(NamedTuple):
    """The leaves a dispatch block reads (an ``MoE`` module has them too):
    the whole router and slot map, and the stacked experts of one rank's
    slots."""
    wr: torch.Tensor
    wg: torch.Tensor
    wi: torch.Tensor
    wo: torch.Tensor
    inv_perm: torch.Tensor


@dataclasses.dataclass
class DispatchStats:
    """One rank's dispatch of one call. ``exchanges``: for each all-to-all,
    its name, its buffers' shapes and bytes, and the bytes it puts on the
    wire, ``(g - 1)/g`` of the whole (the reference's
    ``launch/hlo_analysis.py`` rule). ``rows``: the rows shipped, (token,
    expert) pairs in expert mode, (token, rank) rows in rank mode;
    ``dropped``: this rank's pairs dropped at its source capacity, plus in
    rank mode the received jobs dropped at its expert capacity;
    ``distinct``: the distinct destination ranks summed over its tokens.
    The counts are tensors on the device (read them when needed)."""
    tokens: int
    pairs: int
    rows: torch.Tensor
    dropped: torch.Tensor
    distinct: torch.Tensor
    exchanges: List[Tuple[str, Dict[str, Tuple[tuple, int]], int]] = \
        dataclasses.field(default_factory=list)

    @property
    def wire_bytes(self) -> int:
        return sum(e[2] for e in self.exchanges)


def _positions_in_group(group_ids: torch.Tensor, n_groups: int):
    """Stable sort pair ids by group; return order, sorted ids and
    intra-group positions (all static shapes)."""
    order = torch.argsort(group_ids, stable=True)
    sorted_ids = group_ids[order]
    counts = torch.bincount(group_ids, minlength=n_groups)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(group_ids.numel(), device=group_ids.device) \
        - starts[sorted_ids]
    return order, sorted_ids, pos


def _capacity(tokens: int, k: int, n_groups: int, cf: float) -> int:
    c = int(math.ceil(tokens * k * cf / n_groups))
    return max(8, (c + 7) // 8 * 8)


# A dispatch block runs one rank's part of the layer. It yields each
# all-to-all as (name, {buffer name: (tp, ...) tensor}) -- row r of every
# buffer goes to rank r -- and receives {buffer name: (tp, ...) tensor},
# row s from rank s; it returns (y (T_loc, d) in the compute dtype, aux
# averaged over tp, DispatchStats).
Block = Generator[Tuple[str, Dict[str, torch.Tensor]],
                  Dict[str, torch.Tensor], Tuple]


def _ranks_hit(ranks: torch.Tensor, tp: int) -> torch.Tensor:
    """(T, k) destination ranks -> (T, tp) bool, the ranks each token
    hits."""
    t, k = ranks.shape
    hit = torch.zeros((t, tp), dtype=torch.bool, device=ranks.device)
    hit[torch.arange(t, device=ranks.device).repeat_interleave(k),
        ranks.reshape(-1)] = True
    return hit


def _expert_block(p: ExpertShard, x_loc: torch.Tensor, cfg: ArchConfig,
                  tp: int, rank: int, replicated: bool) -> Block:
    """Expert granularity (GShard baseline): every (token, expert) pair
    in the expert's capacity buffer on its rank."""
    cd = dtype(cfg.compute_dtype)
    t_loc, d = x_loc.shape
    e, k = cfg.n_experts, cfg.top_k
    e_loc, dev = e // tp, x_loc.device
    topw, topi, aux = _router(p, x_loc, cfg)
    slots = p.inv_perm[topi].long()                              # physical
    cap = _capacity(t_loc, k, e, cfg.capacity_factor)
    pair_tok = torch.arange(t_loc, device=dev).repeat_interleave(k)
    order, sorted_slot, pos = _positions_in_group(slots.reshape(-1), e)
    keep = pos < cap
    kept = keep.nonzero().squeeze(1)            # one read of the routes
    ks, kp, kt = sorted_slot[kept], pos[kept], pair_tok[order][kept]
    buf = torch.zeros((e, cap, d), dtype=cd, device=dev)
    buf[ks, kp] = x_loc[kt].to(cd)
    stats = DispatchStats(t_loc, t_loc * k, keep.sum(), (~keep).sum(),
                          _ranks_hit(slots // e_loc, tp).sum())

    # ship: (E, C, d) as (tp, E_loc, C, d); receive (tp sources, E_loc, C,
    # d) -> each local expert's rows, source-major
    recv = (yield "dispatch", {"x": buf.reshape(tp, e_loc, cap, d)})["x"]
    del buf
    out = _expert_ffn(p.wg, p.wi, p.wo,
                      recv.transpose(0, 1).reshape(e_loc, tp * cap, d), cfg)
    del recv
    out = out.reshape(e_loc, tp, cap, d).transpose(0, 1)
    if replicated:      # every source holds the same tokens: send source
        out = out[:1].expand_as(out)    # 0's results to all of them
    back = yield "return", {"y": out, "aux": aux.reshape(1, 1).expand(tp, 1)}
    vals = back["y"].reshape(e, cap, d)[ks, kp]
    w = topw.reshape(-1)[order][kept].to(cd)
    y = torch.zeros((t_loc, d), dtype=cd, device=dev).index_add_(
        0, kt, vals * w[:, None])
    return y, back["aux"].reshape(-1).mean(), stats


def _rank_block(p: ExpertShard, x_loc: torch.Tensor, cfg: ArchConfig,
                tp: int, rank: int, replicated: bool) -> Block:
    """AWAPart mode: one shipment per distinct destination rank a token,
    then a second-level dispatch to the rank's local experts."""
    cd = dtype(cfg.compute_dtype)
    t_loc, d = x_loc.shape
    e, k = cfg.n_experts, cfg.top_k
    e_loc, dev = e // tp, x_loc.device
    topw, topi, aux = _router(p, x_loc, cfg)
    slots = p.inv_perm[topi].long()                              # (T, k)
    ranks = slots // e_loc
    rank_hit = _ranks_hit(ranks, tp)
    cap_r = _capacity(t_loc, min(k, tp), tp, cfg.capacity_factor)
    pos2d = torch.cumsum(rank_hit.to(torch.int64), 0) - 1        # (T, tp)
    keep = rank_hit & (pos2d < cap_r)
    kt, kr = keep.nonzero(as_tuple=True)
    kp = pos2d[kt, kr]
    xbuf = torch.zeros((tp, cap_r, d), dtype=cd, device=dev)
    xbuf[kr, kp] = x_loc[kt].to(cd)
    slotbuf = torch.full((tp, cap_r, k), -1, dtype=torch.int32, device=dev)
    slotbuf[kr, kp] = slots[kt].to(torch.int32)
    wbuf = torch.zeros((tp, cap_r, k), dtype=torch.float32, device=dev)
    wbuf[kr, kp] = topw[kt]
    tokbuf = torch.full((tp, cap_r), -1, dtype=torch.int64, device=dev)
    tokbuf[kr, kp] = kt
    pair_rows = keep[torch.arange(t_loc, device=dev).repeat_interleave(k),
                     ranks.reshape(-1)]
    stats = DispatchStats(t_loc, t_loc * k, keep.sum(), (~pair_rows).sum(),
                          rank_hit.sum())

    got = yield "dispatch", {"x": xbuf, "slot": slotbuf, "w": wbuf}
    del xbuf, slotbuf, wbuf
    r_tot = tp * cap_r
    xr = got["x"].reshape(r_tot, d)
    local_slot = got["slot"].reshape(r_tot, k).long() - rank * e_loc
    wr2 = got["w"].reshape(r_tot, k)
    valid = (local_slot >= 0) & (local_slot < e_loc) & (wr2 > 0)

    # second-level (local) dispatch: jobs = (received row, local expert)
    job_e = torch.where(valid, local_slot, e_loc).reshape(-1)
    job_tok = torch.arange(r_tot, device=dev).repeat_interleave(k)
    cap_e = _capacity(t_loc * tp, k, e, cfg.capacity_factor)
    order, sorted_e, pos = _positions_in_group(job_e, e_loc + 1)
    keep_j = (sorted_e < e_loc) & (pos < cap_e)
    kept = keep_j.nonzero().squeeze(1)
    je, jp, jt = sorted_e[kept], pos[kept], job_tok[order][kept]
    stats.dropped = stats.dropped + valid.sum() - keep_j.sum()
    xe = torch.zeros((e_loc, cap_e, d), dtype=cd, device=dev)
    xe[je, jp] = xr[jt]
    del got, xr
    he = _expert_ffn(p.wg, p.wi, p.wo, xe, cfg)
    del xe
    # local combine back to the received rows, weighted
    w = wr2.reshape(-1)[order][kept].to(cd)
    yr = torch.zeros((r_tot, d), dtype=cd, device=dev).index_add_(
        0, jt, he[je, jp] * w[:, None]).reshape(tp, cap_r, d)
    if replicated:
        yr = yr[:1].expand_as(yr)
    back = yield "return", {"y": yr, "aux": aux.reshape(1, 1).expand(tp, 1)}
    rows = (tokbuf.reshape(-1) >= 0).nonzero().squeeze(1)
    y = torch.zeros((t_loc, d), dtype=cd, device=dev).index_add_(
        0, tokbuf.reshape(-1)[rows], back["y"].reshape(-1, d)[rows])
    return y, back["aux"].reshape(-1).mean(), stats


BLOCKS = {"expert": _expert_block, "rank": _rank_block}


def _exchange_bytes(name: str, parts: Dict[str, torch.Tensor], tp: int
                    ) -> Tuple[str, Dict[str, Tuple[tuple, int]], int]:
    """An exchange's entry of ``DispatchStats.exchanges``."""
    nbytes = {k: (tuple(t.shape), t.numel() * t.element_size())
              for k, t in parts.items()}
    total = sum(n for _, n in nbytes.values())
    return name, nbytes, total * (tp - 1) // tp


def _swap(parts: List[torch.Tensor], group, tp: int) -> List[torch.Tensor]:
    """One ``all_to_all_single`` over ``group`` for the buffers of one
    exchange, packed as bytes, row r of each to rank r; the received
    buffers, row s from rank s, in the same shapes and dtypes."""
    flat = [t.contiguous().view(torch.uint8).reshape(tp, -1) for t in parts]
    send = torch.cat(flat, 1) if len(flat) > 1 else flat[0]
    del flat
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    del send
    # views of the received bytes (every buffer's bytes a multiple of 4:
    # capacities are multiples of 8)
    out, at = [], 0
    for t in parts:
        n = t.numel() * t.element_size() // tp
        out.append(recv[:, at:at + n].view(t.dtype).reshape(t.shape))
        at += n
    return out


class _Exchange(torch.autograd.Function):
    """An exchange's all-to-all; its backward is the same all-to-all of
    the cotangents of the buffers that carry one (an all-to-all with row
    r going to rank r is its own adjoint)."""

    @staticmethod
    def forward(ctx, group, tp, *parts):
        ctx.group, ctx.tp = group, tp
        ctx.live = [i for i in range(len(parts))
                    if ctx.needs_input_grad[2 + i]]
        out = _swap(list(parts), group, tp)
        ctx.mark_non_differentiable(*[t for i, t in enumerate(out)
                                      if i not in ctx.live])
        return tuple(out)

    @staticmethod
    def backward(ctx, *cts):
        grads = [None] * len(cts)
        back = _swap([cts[i] for i in ctx.live], ctx.group, ctx.tp)
        for i, g in zip(ctx.live, back):
            grads[i] = g
        return (None, None, *grads)


def _all_to_all(parts: Dict[str, torch.Tensor], group, tp: int, rank: int
                ) -> Dict[str, torch.Tensor]:
    """An exchange's buffers through :class:`_Exchange`. aux rides the
    return, but not its cotangent: each rank's own aux, which it sends
    itself, is the row that carries it (the mean's share of this rank's
    term, as the plain twin's rank 0 gives every rank's)."""
    live = parts.get("aux")
    if live is not None:
        parts = dict(parts, aux=live.detach())
    out = dict(zip(parts, _Exchange.apply(group, tp, *parts.values())))
    if live is not None:
        got = out["aux"]
        out["aux"] = torch.cat([got[:rank], live[rank:rank + 1],
                                got[rank + 1:]])
    return out


def _gather(t: torch.Tensor, group, n: int) -> List[torch.Tensor]:
    got = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(got, t.contiguous(), group=group)
    return got


class _SumOverTp(torch.autograd.Function):
    """A whole tensor every tp rank uses for its part of the work: the
    identity; its cotangent is the parts' summed over tp in rank order,
    the same bits on every rank."""

    @staticmethod
    def forward(ctx, t, group, tp):
        ctx.group, ctx.tp = group, tp
        return t.view_as(t)

    @staticmethod
    def backward(ctx, ct):
        return sum_in_order(_gather(ct, ctx.group, ctx.tp)), None, None


class _Copies(torch.autograd.Function):
    """The plain twin's :class:`_SumOverTp`: ``n`` copies of a tensor, one
    for each rank's block; its cotangent is theirs summed in rank
    order."""

    @staticmethod
    def forward(ctx, t, n):
        return tuple(t.view_as(t) for _ in range(n))

    @staticmethod
    def backward(ctx, *cts):
        return sum_in_order(cts), None


class _SeqSlice(torch.autograd.Function):
    """This rank's sequence slice of the (B, S, d) tokens; its cotangent,
    the slices' all-gathered over tp, reaches every tp rank whole."""

    @staticmethod
    def forward(ctx, x, group, tp, rank):
        ctx.group, ctx.tp = group, tp
        n = x.shape[1] // tp
        return x[:, rank * n:(rank + 1) * n].contiguous()

    @staticmethod
    def backward(ctx, ct):
        return (torch.cat(_gather(ct, ctx.group, ctx.tp), 1), None, None,
                None)


class _GatherSeq(torch.autograd.Function):
    """The sequence slices' outputs all-gathered over tp; the cotangent
    every tp rank holds whole is one: each takes its slice."""

    @staticmethod
    def forward(ctx, y, group, tp, rank):
        ctx.rank, ctx.n = rank, y.shape[1]
        return torch.cat(_gather(y, group, tp), 1)

    @staticmethod
    def backward(ctx, ct):
        r, n = ctx.rank, ctx.n
        return ct[:, r * n:(r + 1) * n], None, None, None


class _FirstRankGrad(torch.autograd.Function):
    """The output of tokens replicated over tp (every rank holds tp rank
    0's result): the identity; only tp rank 0's copy passes a cotangent,
    the others zeros (so that every rank's backward runs the same
    collectives)."""

    @staticmethod
    def forward(ctx, y, rank):
        ctx.rank = rank
        return y.view_as(y)

    @staticmethod
    def backward(ctx, ct):
        return (ct if ctx.rank == 0 else torch.zeros_like(ct)), None


def dp_mean(t: torch.Tensor, ctx: ShardCtx) -> torch.Tensor:
    """The mean of a scalar over each dp axis in turn (the reference's
    ``pmean``s), the same value on every rank; only this rank's own term
    carries a cotangent, so its gradient is this rank's share (module
    docstring)."""
    for axis in ctx.dp_axes:
        n = ctx.size(axis)
        if n > 1:
            got = _gather(t.detach(), ctx.mesh.get_group(axis), n)
            got[ctx.mesh.get_local_rank(axis)] = t
            t = _mean(got)
    return t


def tp_sum(t: torch.Tensor, ctx: ShardCtx) -> torch.Tensor:
    """A tensor summed over the tp ranks in rank order (no gradient), the
    same bits on every rank."""
    return sum_in_order(_gather(t.detach(),
                                ctx.mesh.get_group(ctx.tp_axis), ctx.tp))


def gather_slots(t: torch.Tensor, ctx: ShardCtx) -> torch.Tensor:
    """A leaf of this rank's expert slots (slots first) -> every slot, the
    tp ranks' parts all-gathered in rank order (no gradient)."""
    return torch.cat(_gather(t.detach(), ctx.mesh.get_group(ctx.tp_axis),
                             ctx.tp))


def _mean(values: List[torch.Tensor]) -> torch.Tensor:
    return torch.stack(values).mean(0)


def _dispatch_layout(tp: int, s: int, seq_shard_moe: bool) -> bool:
    """Whether the dispatch splits the sequence over tp (the reference's
    ``x_spec``): where it divides and is at least tp long."""
    return seq_shard_moe and s % tp == 0 and s >= tp


def _rank_slots(cfg: ArchConfig, tp: int, rank: int) -> slice:
    if cfg.n_experts % tp:
        raise ValueError(f"{cfg.n_experts} experts do not divide over "
                         f"{tp} expert-parallel ranks")
    e_loc = cfg.n_experts // tp
    return slice(rank * e_loc, (rank + 1) * e_loc)


def expert_slice(cfg: ArchConfig, ctx: Optional[ShardCtx] = None) -> slice:
    """The stacked expert slots this rank holds under ``ctx``: ``[r*E_loc,
    (r+1)*E_loc)`` for tp rank r (the reference's ``P(tp, None, None)``);
    all of them without a ``ctx``. Raises where the experts do not divide
    over tp."""
    if ctx is None:
        return slice(None)
    return _rank_slots(cfg, ctx.tp, ctx.tp_rank)


def moe_dispatch(p: MoE, x: torch.Tensor, cfg: ArchConfig, ctx: ShardCtx
                 ) -> Tuple[torch.Tensor, torch.Tensor, DispatchStats]:
    """The expert-parallel layer on this rank: ``x`` (B_loc, S, d), this
    rank's batch slice (the same on every rank of its tp group), with
    ``p`` holding this rank's expert slots. The tokens dispatched are the
    rank's sequence slice where :func:`_dispatch_layout` says so, else all
    of ``x``; after the return all-to-all every rank of the tp group holds
    the same (B_loc, S, d) (sequence slices all-gathered over tp; with
    replicated tokens every rank takes tp rank 0's results, the
    reference's visible output). aux is averaged over tp and then over
    each dp axis, as the reference's ``pmean``s are. Autograd runs
    through it (module docstring). Returns (y, aux, this rank's
    :class:`DispatchStats`)."""
    tp, b, s, d = ctx.tp, *x.shape
    expert_slice(cfg, ctx)          # raises where the experts do not divide
    if p.wg.shape[0] * tp != cfg.n_experts:
        raise ValueError(f"the module holds {p.wg.shape[0]} experts, not "
                         f"{cfg.n_experts}/{tp}")
    seq_tp = _dispatch_layout(tp, s, ctx.seq_shard_moe)
    rank = ctx.tp_rank
    group = ctx.mesh.get_group(ctx.tp_axis)
    x_loc = (_SeqSlice.apply(x, group, tp, rank) if seq_tp
             else _SumOverTp.apply(x, group, tp))
    shard = ExpertShard(_SumOverTp.apply(p.wr, group, tp), p.wg, p.wi, p.wo,
                        p.inv_perm)
    block = BLOCKS[cfg.moe_dispatch](shard, x_loc.reshape(-1, d), cfg, tp,
                                     rank, not seq_tp)
    name, parts = next(block)
    sent = []
    try:
        while True:
            sent.append(_exchange_bytes(name, parts, tp))
            got = _all_to_all(parts, group, tp, rank)
            del parts               # the block frees what it shipped
            name, parts = block.send(got)
            del got
    except StopIteration as done:
        y, aux, stats = done.value
    stats.exchanges = sent
    y = y.reshape(b, -1, d).to(x.dtype)
    y = (_GatherSeq.apply(y, group, tp, rank) if seq_tp
         else _FirstRankGrad.apply(y, rank))
    return y, dp_mean(aux, ctx), stats


def moe_apply_ranks_plain(p: MoE, x: torch.Tensor, cfg: ArchConfig,
                          mesh_shape: Tuple[int, ...]
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     List[DispatchStats]]:
    """The plain twin of :func:`moe_dispatch` under a ``ShardCtx`` with
    its default ``seq_shard_moe``, in one process: ``p`` holds every
    expert, ``x`` is the global (B, S, d), ``mesh_shape`` the mesh's axis
    sizes with the dp axes first and tp last (``(data, model)`` or
    ``(pod, data, model)``). Every rank's block runs in turn, each
    all-to-all a transpose of the stacked per-rank buffers. Returns the
    global y, the aux and every rank's stats (dp-major). Plain autograd
    through it gives :func:`moe_dispatch`'s gradients, the whole router's
    and, with replicated tokens, the tokens' summed over tp in rank
    order."""
    *dp_shape, tp = mesh_shape
    b, s, d = x.shape
    _rank_slots(cfg, tp, 0)
    seq_tp = _dispatch_layout(tp, s, True)
    ys, auxes, all_stats = [], [], []
    for xg in x.chunk(math.prod(dp_shape)):
        blocks, sent = [], []
        routers = _Copies.apply(p.wr, tp)
        xs = None if seq_tp else _Copies.apply(xg, tp)
        for r in range(tp):
            x_loc = (xg[:, r * (s // tp):(r + 1) * (s // tp)] if seq_tp
                     else xs[r])
            mine = _rank_slots(cfg, tp, r)
            shard = ExpertShard(routers[r], p.wg[mine], p.wi[mine],
                                p.wo[mine], p.inv_perm)
            blocks.append(BLOCKS[cfg.moe_dispatch](
                shard, x_loc.reshape(-1, d), cfg, tp, r, not seq_tp))
        sent = [next(blk) for blk in blocks]
        names = [[] for _ in range(tp)]
        done = [None] * tp
        while done[0] is None:
            for r in range(tp):
                names[r].append(sent[r])
            recv = [{k: torch.stack([sent[src][1][k][r] for src in range(tp)])
                     for k in sent[r][1]} for r in range(tp)]
            for r, blk in enumerate(blocks):
                try:
                    sent[r] = blk.send(recv[r])
                except StopIteration as stop:
                    done[r] = stop.value
        for r, (_, _, stats) in enumerate(done):
            stats.exchanges = [_exchange_bytes(name, parts, tp)
                               for name, parts in names[r]]
            all_stats.append(stats)
        y = [o[0].reshape(xg.shape[0], -1, d).to(x.dtype) for o in done]
        ys.append(torch.cat(y, 1) if seq_tp else y[0])
        auxes.append(done[0][1])
    # the reference's pmean over each dp axis in turn
    for n in dp_shape:
        auxes = [_mean(auxes[i::len(auxes) // n])
                 for i in range(len(auxes) // n)]
    return torch.cat(ys, 0), auxes[0], all_stats
