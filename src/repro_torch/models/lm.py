"""LM-level serving steps: prefill and cached decode, plus random weights
and input batches.

Counterpart of ``repro/models/lm.py`` for serving; ``loss_fn`` and
``train_step`` come with the training slice (ROADMAP Queue 1, item 3).
Entry points run on the card unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import SHAPES, ArchConfig
from repro_torch.kernels import dispatch
from repro_torch.models import transformer
from repro_torch.models.layers import dtype

Batch = Dict[str, torch.Tensor]


def param_shapes(cfg: ArchConfig) -> Dict[str, tuple]:
    """The reference's parameter tree for an attention-family config,
    keyed by path, blocks stacked on a leading ``layers`` axis."""
    transformer.require_attention_family(cfg)
    d, h, k = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd, f, v, n = cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size, \
        cfg.n_layers
    norm = ("scale", "bias") if cfg.norm == "layernorm" else ("scale",)
    shapes: Dict[str, tuple] = {}
    if not cfg.embedding_inputs:
        shapes["embed"] = (v, d)
    for name in norm:
        shapes[f"ln_f/{name}"] = (d,)
    if not cfg.tied_embeddings:
        shapes["head"] = (d, v)
    blk = {"attn/wq": (d, h, hd), "attn/wk": (d, k, hd),
           "attn/wv": (d, k, hd), "attn/wo": (h, hd, d)}
    if cfg.qkv_bias:
        blk.update({"attn/bq": (h, hd), "attn/bk": (k, hd),
                    "attn/bv": (k, hd), "attn/bo": (d,),
                    "mlp/bi": (f,), "mlp/bo": (d,)})
    if cfg.qk_norm:
        blk.update({"attn/q_norm": (hd,), "attn/k_norm": (hd,)})
    for ln in ("ln1", "ln2"):
        for name in norm:
            blk[f"{ln}/{name}"] = (d,)
    if cfg.activation == "silu":
        blk["mlp/wg"] = (d, f)
    blk.update({"mlp/wi": (d, f), "mlp/wo": (f, d)})
    shapes.update({f"blocks/{key}": (n,) + s for key, s in blk.items()})
    return shapes


def _fan_in(path: str, shape: tuple, cfg: ArchConfig) -> int:
    if path == "embed":
        return cfg.d_model
    if path == "blocks/attn/wo":
        return cfg.n_heads * cfg.resolved_head_dim
    return shape[1] if path.startswith("blocks/") else shape[0]


def init_params(cfg: ArchConfig, *, device="cuda",
                generator: Optional[torch.Generator] = None
                ) -> transformer.Transformer:
    """Random weights in the reference's distribution (normal scaled by
    1/sqrt(fan_in) for matrices, ones for norm scales, zeros for biases),
    drawn on ``device`` from ``generator`` (a generator on that device;
    seed 0 when omitted)."""
    dev = dispatch.resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    pdt = dtype(cfg.param_dtype)
    flat = {}
    for path, shape in param_shapes(cfg).items():
        leaf = path.rsplit("/", 1)[-1]
        if leaf in ("scale", "q_norm", "k_norm"):
            t = torch.ones(shape, device=dev)
        elif leaf.startswith("b"):
            t = torch.zeros(shape, device=dev)
        else:
            t = torch.randn(shape, generator=generator, device=dev)
            t *= 1.0 / np.sqrt(max(_fan_in(path, shape, cfg), 1))
        flat[path] = t.to(pdt)
    return transformer.Transformer(cfg, flat)


def prefill_step(model: transformer.Transformer, batch: Batch,
                 cfg: ArchConfig):
    """Full-sequence forward -> (float32 logits of the last position (B, V),
    decode-ready caches). The head runs on the last position only: the
    reference computes (B, S, V) logits and keeps ``[:, -1]``, the same
    numbers."""
    inputs = batch["embeddings"] if cfg.embedding_inputs else batch["tokens"]
    x, caches = transformer.hidden(model, inputs, cfg,
                                   collect_cache=cfg.has_decode)
    return transformer.lm_head(model, x[:, -1:], cfg)[:, 0], caches


def decode_step(model: transformer.Transformer, caches, batch: Batch,
                cfg: ArchConfig):
    """One new token per sequence against caches of ``seq_len`` slots;
    ``batch = {"token": (B,), "pos": int}``. Caches update in place."""
    return transformer.decode_step(model, caches, batch["token"],
                                   batch["pos"], cfg)


def make_batch(cfg: ArchConfig, shape_name: str, rng: np.random.Generator,
               batch_override: Optional[int] = None, *,
               device="cuda") -> Batch:
    """A random batch for a shape cell, drawn from ``rng`` in the
    reference's order (so one seed gives both packages the same batch)."""
    dev = dispatch.resolve_device(device)
    info = SHAPES[shape_name]
    s, b = info["seq_len"], batch_override or info["global_batch"]
    kind = info["kind"]

    def ids(shape):
        return torch.from_numpy(rng.integers(0, cfg.vocab_size, size=shape)
                                .astype(np.int32)).to(dev)

    def emb(shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                ).to(dev).to(torch.bfloat16)

    if kind == "train":
        if cfg.embedding_inputs:
            out = {"embeddings": emb((b, s, cfg.d_model)),
                   "labels": ids((b, s))}
            out["mask"] = torch.from_numpy(rng.random((b, s)) < 0.3).to(dev)
            return out
        return {"tokens": ids((b, s))}
    if kind == "prefill":
        if cfg.embedding_inputs:
            return {"embeddings": emb((b, s, cfg.d_model))}
        return {"tokens": ids((b, s))}
    return {"token": ids((b,)), "pos": 0}
