"""Layer stacks: the attention family (dense / MoE / VLM / audio-encoder
transformers), RWKV6, and Mamba2 with zamba2's shared attention block.

Counterpart of ``repro/models/transformer.py``. The reference stacks each
block's parameters on a leading ``layers`` axis and runs ``lax.scan``; here
the blocks are an ``nn.ModuleList`` walked by a Python loop, built from the
same stacked tensors (``Transformer(cfg, flat)``). Caches keep the
reference's layouts and are written in place: ``{"k": (L, B, T, K, D),
"v": ...}`` in the compute dtype for the attention family;
``{"tm_shift": (L, B, d), "cm_shift": (L, B, d), "wkv": (L, B, H, hd,
hd)}``, all float32, for RWKV6; for Mamba2 stacks ``conv`` (L, B, K-1,
conv_dim) in the compute dtype and ``ssm`` (L, B, H, N, hd) float32, plus
for the hybrid ``k``/``v`` (A, B, T, K, D), one slot per application of
the shared block.

The hybrid (zamba2) applies one shared attention + MLP block, with its own
residual, before every ``attn_every``-th Mamba2 layer (layers 0,
``attn_every``, ...); ``attn_every = 0`` is the pure Mamba2 stack.

A mixture-of-experts config (``cfg.is_moe``) puts a one-device
``models.moe.MoE`` layer where the dense block has its MLP; the forward
sums the layers' router aux losses, as the reference's does.

Rematerialization (``cfg.remat``), while autograd records: ``"full"`` runs
each block (and each application of the hybrid's shared block) under
``torch.utils.checkpoint`` (non-reentrant), so only the blocks' inputs are
kept and each block's forward runs again in the backward, as the
reference's ``jax.checkpoint`` does; ``"none"`` keeps every activation.
``"dots"`` (keep the matrix products' outputs) is not ported (ROADMAP
item 3) and raises. Without autograd (serving) every setting runs the
blocks plainly.
"""
from __future__ import annotations

import functools
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as torch_checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import moe, rwkv, ssm
from repro_torch.models.layers import (MLP, Attention, Norm, _param, _sub,
                                       attention_apply, dtype, mlp_apply,
                                       norm_apply)

Caches = Dict[str, torch.Tensor]


# --------------------------------------------------------------------------- #
# attention-family block
# --------------------------------------------------------------------------- #

class Block(nn.Module):
    def __init__(self, cfg: ArchConfig, w: Mapping[str, torch.Tensor]):
        super().__init__()
        self.ln1 = Norm(_sub(w, "ln1"))
        self.attn = Attention(cfg, _sub(w, "attn"))
        self.ln2 = Norm(_sub(w, "ln2"))
        self.mlp = self.moe = None
        if cfg.is_moe:
            self.moe = moe.MoE(cfg, _sub(w, "moe"))
        else:
            self.mlp = MLP(cfg, _sub(w, "mlp"))


def attn_block_apply(p: Block, x: torch.Tensor, cfg: ArchConfig, *,
                     positions: torch.Tensor, cache=None, cache_pos=None):
    """Pre-norm attention + MLP (or MoE) block -> (x, new_cache, aux); aux
    is the MoE router's load-balancing term, 0 for a dense block."""
    h = norm_apply(p.ln1, x, cfg)
    y, new_cache = attention_apply(p.attn, h, cfg, positions=positions,
                                   cache=cache, cache_pos=cache_pos)
    x = x + y
    h = norm_apply(p.ln2, x, cfg)
    if p.moe is not None:
        y, aux = moe.moe_apply(p.moe, h, cfg)
        return x + y, new_cache, aux
    return x + mlp_apply(p.mlp, h, cfg), new_cache, 0.0


class MambaBlock(nn.Module):
    """Pre-norm Mamba2 layer: ``ln`` and ``mamba`` leaves."""

    def __init__(self, cfg: ArchConfig, w: Mapping[str, torch.Tensor]):
        super().__init__()
        self.ln = Norm(_sub(w, "ln"))
        self.mamba = ssm.Mamba2(cfg, _sub(w, "mamba"))


def n_shared_apps(cfg: ArchConfig) -> int:
    """How many times the hybrid applies its shared block (one K/V cache
    slot each)."""
    if not cfg.attn_every:
        return 0
    return (cfg.n_layers + cfg.attn_every - 1) // cfg.attn_every


def is_mamba_stack(cfg: ArchConfig) -> bool:
    """Mamba2 layers, with (hybrid) or without the shared block."""
    return cfg.family in ("ssm", "hybrid") and not cfg.rwkv


# --------------------------------------------------------------------------- #
# the model
# --------------------------------------------------------------------------- #

class Transformer(nn.Module):
    """Embedding (absent for ``embedding_inputs``), blocks, final norm and
    head (absent for ``tied_embeddings``: the embedding serves); for the
    zamba2 hybrid, the ``shared`` attention block (None otherwise)."""

    def __init__(self, cfg: ArchConfig, flat: Mapping[str, torch.Tensor]):
        """``flat``: the reference's parameter tree keyed by its paths
        (``"embed"``, ``"ln_f/scale"``, ``"blocks/attn/wq"``, ...), blocks
        stacked on a leading ``layers`` axis, in the parameter dtype."""
        super().__init__()
        cd = dtype(cfg.compute_dtype)
        self.embed = (None if cfg.embedding_inputs
                      else _param(flat["embed"], cd))
        self.ln_f = Norm({k[5:]: v for k, v in flat.items()
                          if k.startswith("ln_f/")})
        self.head = (None if cfg.tied_embeddings
                     else _param(flat["head"], cd))
        stacked = {k[7:]: v for k, v in flat.items()
                   if k.startswith("blocks/")}
        for k, v in stacked.items():
            if v.shape[0] != cfg.n_layers:
                raise ValueError(f"blocks/{k}: {v.shape[0]} layers, config "
                                 f"has {cfg.n_layers}")
        block = (rwkv.RWKVBlock if cfg.rwkv else
                 MambaBlock if is_mamba_stack(cfg) else Block)
        self.blocks = nn.ModuleList(
            block(cfg, {k: v[i] for k, v in stacked.items()})
            for i in range(cfg.n_layers))
        self.shared = (Block(cfg, _sub(flat, "shared"))
                       if is_mamba_stack(cfg) and cfg.attn_every else None)

    @property
    def device(self) -> torch.device:
        return self.ln_f.scale.device


def embed_tokens(p: Transformer, tokens: torch.Tensor,
                 cfg: ArchConfig) -> torch.Tensor:
    return F.embedding(tokens, p.embed)


def lm_head(p: Transformer, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Final norm and vocabulary projection -> float32 logits."""
    h = norm_apply(p.ln_f, x, cfg).to(dtype(cfg.compute_dtype))
    logits = F.linear(h, p.embed) if cfg.tied_embeddings else h @ p.head
    return logits.to(torch.float32)


# --------------------------------------------------------------------------- #
# training/prefill forward
# --------------------------------------------------------------------------- #

def hidden(p: Transformer, inputs: torch.Tensor, cfg: ArchConfig, *,
           collect_cache: bool = False
           ) -> Tuple[torch.Tensor, Optional[Caches]]:
    """The forward through the blocks, before the final norm: (B, S, d)
    activations and, with ``collect_cache``, the decode caches: (L, B, S,
    K, D) key/value caches sized S, RWKV6's states after position S-1
    (shift states cast to float32, as the reference's forward casts them
    when it collects them), or the Mamba2 states after position S-1 with
    the shared block's (A, B, S, K, D) key/value caches."""
    x, _, caches = _blocks(p, inputs, cfg, collect_cache=collect_cache)
    return x, caches


def _remat(cfg: ArchConfig):
    """How a block runs under ``cfg.remat``: a wrapper ``run(fn, *args)``,
    or None to call it plainly (``"none"``, or autograd not recording)."""
    if not torch.is_grad_enabled() or cfg.remat == "none":
        return None
    if cfg.remat == "full":
        return functools.partial(torch_checkpoint.checkpoint,
                                 use_reentrant=False)
    if cfg.remat == "dots":
        raise ValueError("remat='dots' (keep the matrix products' outputs) "
                         "is not ported: ROADMAP item 3; use 'full' or "
                         "'none'")
    raise ValueError(f"unknown remat {cfg.remat!r}: expected full, dots or "
                     "none")


def _run(remat, fn, *args, **kw):
    if remat is None:
        return fn(*args, **kw)
    return remat(functools.partial(fn, **kw), *args)


def _blocks(p: Transformer, inputs: torch.Tensor, cfg: ArchConfig, *,
            collect_cache: bool):
    """:func:`hidden`'s activations and caches, with the sum of the
    blocks' aux losses between them (0 but for MoE); each block run as
    ``cfg.remat`` says."""
    remat = None if collect_cache else _remat(cfg)
    if cfg.embedding_inputs:
        x = inputs.to(dtype(cfg.compute_dtype))
        b, s = x.shape[:2]
    else:
        x = embed_tokens(p, inputs, cfg)
        b, s = inputs.shape
    if cfg.rwkv:
        caches = (init_decode_caches(cfg, b, s, device=x.device)
                  if collect_cache else None)
        for i, blk in enumerate(p.blocks):
            x, st = _run(remat, rwkv.rwkv_block_apply, blk, x, cfg)
            if caches is not None:
                for key, val in st.items():
                    caches[key][i].copy_(val)
        return x, 0.0, caches
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    if is_mamba_stack(cfg):
        caches = (init_decode_caches(cfg, b, s, device=x.device)
                  if collect_cache else None)
        for i, blk in enumerate(p.blocks):
            if p.shared is not None and i % cfg.attn_every == 0:
                app = i // cfg.attn_every
                kv = ((caches["k"][app], caches["v"][app]) if collect_cache
                      else None)
                x, _, _ = _run(remat, attn_block_apply, p.shared, x, cfg,
                               positions=positions, cache=kv,
                               cache_pos=0 if collect_cache else None)
            x, st = _run(remat, _mamba_layer, blk, x, cfg,
                         return_state=collect_cache)
            if collect_cache:
                caches["conv"][i].copy_(st["conv"])
                caches["ssm"][i].copy_(st["ssm"])
        return x, 0.0, caches
    caches = (init_decode_caches(cfg, b, s, device=x.device)
              if collect_cache else None)
    aux = 0.0
    for i, blk in enumerate(p.blocks):
        kv = (caches["k"][i], caches["v"][i]) if collect_cache else None
        x, _, a = _run(remat, attn_block_apply, blk, x, cfg,
                       positions=positions, cache=kv,
                       cache_pos=0 if collect_cache else None)
        aux = aux + a
    return x, aux, caches


def _mamba_layer(blk: MambaBlock, x: torch.Tensor, cfg: ArchConfig, *,
                 return_state: bool):
    """One pre-norm Mamba2 layer with its residual -> (x, state or None)."""
    y, st = ssm.mamba2_apply(blk.mamba, norm_apply(blk.ln, x, cfg), cfg,
                             return_state=return_state)
    return x + y, st


def forward(p: Transformer, inputs: torch.Tensor, cfg: ArchConfig, *,
            collect_cache: bool = False):
    """inputs: tokens (B, S) or embeddings (B, S, d) -> (logits (B, S, V)
    float32, aux, caches)."""
    x, aux, caches = _blocks(p, inputs, cfg, collect_cache=collect_cache)
    return lm_head(p, x, cfg), aux, caches


# --------------------------------------------------------------------------- #
# decode (one token, cached)
# --------------------------------------------------------------------------- #

def init_decode_caches(cfg: ArchConfig, batch: int, max_len: int, *,
                       device="cuda") -> Caches:
    """Zero caches for ``batch`` sequences of up to ``max_len`` positions
    (RWKV6's and Mamba2's states do not grow: ``max_len`` sizes only the
    shared block's key/value caches)."""
    if cfg.rwkv or is_mamba_stack(cfg):
        init = rwkv.rwkv_init_state if cfg.rwkv else ssm.mamba2_init_state
        st = init(cfg, cfg.n_layers * batch, device=device)
        caches = {key: val.reshape(cfg.n_layers, batch, *val.shape[1:])
                  for key, val in st.items()}
        if cfg.rwkv or not cfg.attn_every:
            return caches
        kshape = (n_shared_apps(cfg), batch, max_len, cfg.n_kv_heads,
                  cfg.resolved_head_dim)
        cd = dtype(cfg.compute_dtype)
        caches["k"] = torch.zeros(kshape, dtype=cd, device=device)
        caches["v"] = torch.zeros(kshape, dtype=cd, device=device)
        return caches
    kshape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads,
              cfg.resolved_head_dim)
    cd = dtype(cfg.compute_dtype)
    return {"k": torch.zeros(kshape, dtype=cd, device=device),
            "v": torch.zeros(kshape, dtype=cd, device=device)}


def decode_step(p: Transformer, caches: Caches, token: torch.Tensor,
                pos: int, cfg: ArchConfig):
    """token: (B,) ids, pos: int -> (logits (B, V) float32, caches). The
    caches are updated in place (at ``pos`` for the attention family and
    the shared block; RWKV6's and Mamba2's states do not read ``pos``) and
    returned."""
    if is_mamba_stack(cfg):
        pos = int(pos)
        x = embed_tokens(p, token, cfg)                  # (B, d)
        positions = torch.full((x.shape[0], 1), pos, dtype=torch.int64,
                               device=x.device)
        for i, blk in enumerate(p.blocks):
            if p.shared is not None and i % cfg.attn_every == 0:
                app = i // cfg.attn_every
                y, _, _ = attn_block_apply(
                    p.shared, x[:, None], cfg, positions=positions,
                    cache=(caches["k"][app], caches["v"][app]),
                    cache_pos=pos)
                x = y[:, 0]
            h = norm_apply(blk.ln, x, cfg)
            y, _ = ssm.mamba2_decode(
                blk.mamba, h, {"conv": caches["conv"][i],
                               "ssm": caches["ssm"][i]}, cfg)
            x = x + y
        return lm_head(p, x[:, None], cfg)[:, 0], caches
    if cfg.rwkv:
        x = embed_tokens(p, token, cfg)                  # (B, d)
        for i, blk in enumerate(p.blocks):
            x, st = rwkv.rwkv_block_decode(
                blk, x, {key: val[i] for key, val in caches.items()}, cfg)
            for key, val in st.items():
                caches[key][i].copy_(val)
        return lm_head(p, x[:, None], cfg)[:, 0], caches
    pos = int(pos)
    x = embed_tokens(p, token[:, None], cfg)            # (B, 1, d)
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.int64,
                           device=x.device)
    for i, blk in enumerate(p.blocks):
        x, _, _ = attn_block_apply(
            blk, x, cfg, positions=positions,
            cache=(caches["k"][i], caches["v"][i]), cache_pos=pos)
    return lm_head(p, x, cfg)[:, 0], caches
