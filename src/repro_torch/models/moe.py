"""Mixture-of-experts layer on one device.

Counterpart of ``repro/models/moe.py``. The reference runs the layer on
one device as ``moe_apply_dense`` (its ``moe_apply`` falls through to it
without a multi-device mesh); :func:`moe_apply` computes that function.
Its expert-parallel ``shard_map`` blocks (expert- and rank-granularity
dispatch over all-to-alls) exist only across ranks and are not ported:
one card is one rank.

The logical->physical expert map lives in ``inv_perm`` (int32, a buffer,
not trained): expert ``e``'s weights sit in slot ``inv_perm[e]`` of the
stacked ``wg``/``wi``/``wo``. Migration permutes the stacked weights and
rewrites the map (``core.placement.apply_expert_placement``), the
analogue of exchanging triples between shards and updating PMeta.

Where the reference runs every token through every expert and adds
``w_e`` times the product (zero for a token not routed to ``e``), this
layer computes each routed expert on its own tokens only (``E/k`` times
fewer expert FLOPs) and adds the products into ``y`` in the compute
dtype, logical expert by logical expert in increasing id: the reference's
summation order, since the zero terms it adds are exact. The result
therefore does not depend on the placement, bit for bit.
"""
from __future__ import annotations

from typing import Mapping, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import _param, dtype


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
    operations."""
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


def moe_apply(p: MoE, x: torch.Tensor, cfg: ArchConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y, aux): ``moe_apply_dense``'s function. The
    (token, expert) pairs are grouped by logical expert with a stable sort;
    one device->host read a call fetches the group sizes and the slot map,
    and only the experts that received tokens run. On the meta device the
    routes are :func:`meta_routes`' balanced ones, the slot map the
    identity."""
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
