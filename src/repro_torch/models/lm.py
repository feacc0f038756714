"""LM-level steps: train, prefill and cached decode, plus random weights
and input batches.

Counterpart of ``repro/models/lm.py``. Entry points run on the card unless
the caller passes ``device="cpu"``.

Serving (``prefill_step``, ``decode_step``) runs under ``torch.no_grad()``
and builds no graph. Training (``loss_fn``, ``train_step``) needs a model
made trainable (``init_all`` or :func:`make_trainable`): every floating
parameter requires grad; the MoE slot map ``inv_perm`` is an int32 buffer
that nothing updates (the reference's ``allow_int=True``). The modules
hold their matrices in the compute dtype; where that differs from a
leaf's parameter dtype (bf16 compute over float32 parameters, the full
configs), the model carries float32 master copies in ``model.master``
(keyed by parameter name): the optimizer updates the masters from the
gradients cast to their dtype and copies them into the modules, as the
reference updates its float32 parameters and casts them at every use.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import SHAPES, ArchConfig
from repro_torch.kernels import dispatch
from repro_torch.models import rwkv, ssm, transformer
from repro_torch.models.layers import dtype
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update

Batch = Dict[str, torch.Tensor]

AUX_WEIGHT = 0.01


def _rwkv_block_shapes(cfg: ArchConfig) -> Dict[str, tuple]:
    """One RWKV6 block's ``tm`` leaves (``rwkv6_init``'s tree)."""
    d, f, lora = cfg.d_model, cfg.d_ff, cfg.rwkv_lora_dim
    nh, hd, mix = rwkv.n_heads(cfg), cfg.rwkv_head_dim, rwkv.MIX_LORA
    blk = {"mu_x": (d,), "mu": (5, d), "mix_w1": (d, 5 * mix),
           "mix_w2": (5, mix, d), "w0": (d,), "decay_w1": (d, lora),
           "decay_w2": (lora, d), "u": (nh, hd)}
    blk.update({name: (d, d) for name in ("wr", "wk", "wv", "wg", "wo")})
    blk.update({"ln_x_scale": (d,), "ln_x_bias": (d,), "cm_mu_k": (d,),
                "cm_mu_r": (d,), "cm_k": (d, f), "cm_v": (f, d),
                "cm_r": (d, d)})
    return {f"tm/{name}": s for name, s in blk.items()}


def _mamba_block_shapes(cfg: ArchConfig) -> Dict[str, tuple]:
    """One Mamba2 layer's ``mamba`` leaves (``mamba2_init``'s tree)."""
    dm = ssm.dims(cfg)
    d_in, nh, conv_dim = dm["d_in"], dm["n_heads"], dm["conv_dim"]
    proj = 2 * d_in + 2 * ssm.N_GROUPS * cfg.ssm_state + nh
    blk = {"in_proj": (cfg.d_model, proj),
           "conv_w": (cfg.ssm_conv, conv_dim), "conv_b": (conv_dim,),
           "dt_bias": (nh,), "A_log": (nh,), "D": (nh,), "norm": (d_in,),
           "out_proj": (d_in, cfg.d_model)}
    return {f"mamba/{name}": s for name, s in blk.items()}


def _attn_block_shapes(cfg: ArchConfig, norms: Dict[str, tuple]
                       ) -> Dict[str, tuple]:
    """One attention + MLP (or MoE) block's leaves (``attn_block_init``'s
    tree)."""
    d, h, k = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd, f, e = cfg.resolved_head_dim, cfg.d_ff, cfg.n_experts
    blk = {"attn/wq": (d, h, hd), "attn/wk": (d, k, hd),
           "attn/wv": (d, k, hd), "attn/wo": (h, hd, d)}
    if cfg.qkv_bias:
        blk.update({"attn/bq": (h, hd), "attn/bk": (k, hd),
                    "attn/bv": (k, hd), "attn/bo": (d,)})
    if cfg.qk_norm:
        blk.update({"attn/q_norm": (hd,), "attn/k_norm": (hd,)})
    for ln in ("ln1", "ln2"):
        blk.update({f"{ln}/{name}": s for name, s in norms.items()})
    if cfg.is_moe:                          # ``moe_init``'s tree
        blk.update({"moe/wr": (d, e), "moe/wg": (e, d, f),
                    "moe/wi": (e, d, f), "moe/wo": (e, f, d),
                    "moe/inv_perm": (e,)})
        return blk
    if cfg.qkv_bias:
        blk.update({"mlp/bi": (f,), "mlp/bo": (d,)})
    if cfg.activation == "silu":
        blk["mlp/wg"] = (d, f)
    blk.update({"mlp/wi": (d, f), "mlp/wo": (f, d)})
    return blk


def param_shapes(cfg: ArchConfig) -> Dict[str, tuple]:
    """The reference's parameter tree for an attention-family (dense or
    MoE), RWKV6 or Mamba2 (hybrid or not) config, keyed by path, blocks
    stacked on a leading ``layers`` axis; the hybrid's ``shared`` block is
    not stacked."""
    d, v, n = cfg.d_model, cfg.vocab_size, cfg.n_layers
    names = ("scale", "bias") if cfg.norm == "layernorm" else ("scale",)
    norms = {name: (d,) for name in names}
    shapes: Dict[str, tuple] = {}
    if not cfg.embedding_inputs:
        shapes["embed"] = (v, d)
    shapes.update({f"ln_f/{name}": s for name, s in norms.items()})
    if not cfg.tied_embeddings:
        shapes["head"] = (d, v)
    if cfg.rwkv:
        blk = _rwkv_block_shapes(cfg)
        for ln in ("ln1", "ln2"):
            blk.update({f"{ln}/{name}": s for name, s in norms.items()})
    elif cfg.family in ("ssm", "hybrid"):
        blk = _mamba_block_shapes(cfg)
        blk.update({f"ln/{name}": s for name, s in norms.items()})
        if cfg.attn_every:
            shapes.update({f"shared/{key}": s for key, s in
                           _attn_block_shapes(cfg, norms).items()})
    else:
        blk = _attn_block_shapes(cfg, norms)
    shapes.update({f"blocks/{key}": (n,) + s for key, s in blk.items()})
    return shapes


def _fan_in(path: str, shape: tuple, cfg: ArchConfig) -> int:
    if path == "embed":
        return cfg.d_model
    if path.endswith("attn/wo"):
        return cfg.n_heads * cfg.resolved_head_dim
    if path in MOE_EXPERT_LEAVES:        # (L, E, fan_in, fan_out)
        return shape[2]
    return shape[1] if path.startswith("blocks/") else shape[0]


# the stacked expert leaves: drawn one layer at a time (one float32 leaf of
# qwen3-moe-30b-a3b, (48, 128, 2048, 768), is 38.6 GB)
MOE_EXPERT_LEAVES = ("blocks/moe/wg", "blocks/moe/wi", "blocks/moe/wo")


# RWKV6 leaves the reference initialises otherwise (``rwkv6_init``):
# constants, and normals at a fixed scale instead of 1/sqrt(fan_in)
RWKV_CONSTANTS = {"mu_x": 0.5, "mu": 0.5, "cm_mu_k": 0.5, "cm_mu_r": 0.5,
                  "w0": -2.0, "ln_x_scale": 1.0, "ln_x_bias": 0.0}
RWKV_NORMAL_SCALES = {"mix_w2": 0.01, "decay_w2": 0.01, "u": 0.1}


def mamba_constants(cfg: ArchConfig) -> Dict[str, np.ndarray]:
    """The (H,) and (d_in,) leaves ``mamba2_init`` sets without the key,
    float32, the same in every layer: ``dt_bias``, the softplus-inverse of
    dt drawn log-uniform in [1e-3, 1e-1] from ``np.random.default_rng(0)``
    (re-seeded at every call), ``A_log = log(linspace(1, 16, H))``, ``D``
    and ``norm`` ones, ``conv_b`` zeros. ``linspace`` is ``jnp.linspace``'s
    float32 formula; its log is rounded from float64, within one float32
    step of XLA's (whose log is not correctly rounded)."""
    dm = ssm.dims(cfg)
    nh, f32 = dm["n_heads"], np.float32
    dt0 = np.exp(np.random.default_rng(0).uniform(
        np.log(1e-3), np.log(1e-1), nh)).astype(f32)
    if nh > 1:
        step = np.arange(nh - 1, dtype=f32) / f32(nh - 1)
        lin = np.append(f32(1) * (f32(1) - step) + f32(16) * step, f32(16))
    else:
        lin = np.ones(nh, f32)
    return {"dt_bias": (dt0 + np.log(-np.expm1(-dt0))).astype(f32),
            "A_log": np.log(lin.astype(np.float64)).astype(f32),
            "D": np.ones(nh, f32), "norm": np.ones(dm["d_in"], f32),
            "conv_b": np.zeros(dm["conv_dim"], f32)}


MAMBA_CONV_SCALE = 0.1      # conv_w ~ N(0, 1) * 0.1, not 1/sqrt(fan_in)


def init_params(cfg: ArchConfig, *, device="cuda",
                generator: Optional[torch.Generator] = None
                ) -> transformer.Transformer:
    """The model of :func:`init_flat`'s weights."""
    return transformer.Transformer(
        cfg, init_flat(cfg, device=device, generator=generator))


def init_flat(cfg: ArchConfig, *, device="cuda",
              generator: Optional[torch.Generator] = None
              ) -> Dict[str, torch.Tensor]:
    """Random weights in the reference's distribution (normal scaled by
    1/sqrt(fan_in) for matrices, ones for norm scales, zeros for biases;
    RWKV6's ``tm`` leaves as ``rwkv6_init`` draws them, Mamba2's as
    ``mamba2_init`` does; MoE's as ``moe_init`` does: the router float32
    whatever ``param_dtype`` is, the slot map ``inv_perm`` the identity,
    int32), drawn on ``device`` from ``generator`` (a generator on that
    device; seed 0 when omitted). The stacked expert leaves are drawn one
    layer at a time in float32 and cast into the parameter dtype, so no
    float32 copy of a whole leaf exists. Returns the parameter tree keyed
    by path (``param_shapes``), in the parameter dtype."""
    dev = dispatch.resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    pdt = dtype(cfg.param_dtype)
    mamba = mamba_constants(cfg) if transformer.is_mamba_stack(cfg) else {}
    flat = {}
    for path, shape in param_shapes(cfg).items():
        leaf = path.rsplit("/", 1)[-1]
        rwkv_leaf = cfg.rwkv and path.startswith("blocks/tm/")
        mamba_leaf = path.startswith("blocks/mamba/")
        if path in MOE_EXPERT_LEAVES:
            t = torch.empty(shape, dtype=pdt, device=dev)
            scale = 1.0 / np.sqrt(max(_fan_in(path, shape, cfg), 1))
            for i in range(shape[0]):
                t[i] = torch.randn(shape[1:], generator=generator,
                                   device=dev) * scale
            flat[path] = t
            continue
        if leaf == "inv_perm":
            flat[path] = torch.arange(shape[-1], dtype=torch.int32,
                                      device=dev).expand(shape).contiguous()
            continue
        if mamba_leaf and leaf in mamba:     # one copy a layer
            t = torch.from_numpy(mamba[leaf]).to(dev).expand(
                shape).contiguous()
        elif mamba_leaf and leaf == "conv_w":
            t = torch.randn(shape, generator=generator, device=dev)
            t *= MAMBA_CONV_SCALE
        elif rwkv_leaf and leaf in RWKV_CONSTANTS:
            t = torch.full(shape, RWKV_CONSTANTS[leaf], device=dev)
        elif rwkv_leaf and leaf in RWKV_NORMAL_SCALES:
            t = torch.randn(shape, generator=generator, device=dev)
            t *= RWKV_NORMAL_SCALES[leaf]
        elif leaf in ("scale", "q_norm", "k_norm"):
            t = torch.ones(shape, device=dev)
        elif leaf.startswith("b"):
            t = torch.zeros(shape, device=dev)
        else:
            t = torch.randn(shape, generator=generator, device=dev)
            t *= 1.0 / np.sqrt(max(_fan_in(path, shape, cfg), 1))
        flat[path] = t if path == "blocks/moe/wr" else t.to(pdt)
    return flat


# --------------------------------------------------------------------------- #
# training
# --------------------------------------------------------------------------- #

def leaf_path(name: str) -> Tuple[str, Optional[int]]:
    """A parameter's (or buffer's) name in the model -> (the reference's
    leaf path, its layer on the stacked axis or None): ``blocks.3.attn.wq``
    -> (``blocks/attn/wq``, 3); RWKV6's channel-mix leaves, kept in the
    ``cm`` module, sit under ``tm`` there."""
    parts = name.split(".")
    if parts[0] != "blocks":
        return "/".join(parts), None
    rest = parts[2:]
    if rest[0] == "cm":
        rest = ["tm"] + rest[1:]
    return "/".join(["blocks"] + rest), int(parts[1])


def _master_dtype(path: str, cfg: ArchConfig) -> torch.dtype:
    """The dtype the reference keeps a leaf in: the parameter dtype, but
    float32 for the MoE router."""
    return (torch.float32 if path == "blocks/moe/wr"
            else dtype(cfg.param_dtype))


def make_trainable(model: transformer.Transformer, cfg: ArchConfig,
                   flat: Optional[Mapping[str, torch.Tensor]] = None
                   ) -> transformer.Transformer:
    """Turn on ``requires_grad`` for every floating parameter and, for each
    whose module dtype differs from the dtype the reference keeps it in,
    set a master copy in ``model.master``, taken from ``flat``, the
    parameter tree the model was built from. ``flat`` may be omitted only
    where no parameter needs a master: one upcast from the module's
    rounded weights would lose the master's precision. Returns the
    model."""
    master = {}
    for name, p in model.named_parameters():
        if not p.dtype.is_floating_point:
            continue
        p.requires_grad_(True)
        path, layer = leaf_path(name)
        mdt = _master_dtype(path, cfg)
        if p.dtype == mdt:
            continue
        if flat is None:
            raise ValueError(f"{name} is kept in {mdt} beside a {p.dtype} "
                             f"module: pass the tree the model was built "
                             f"from as flat")
        src = flat[path] if layer is None else flat[path][layer]
        master[name] = src.reshape(p.shape).to(mdt)
    model.master = master
    return model


def trainable(model: transformer.Transformer) -> Dict[str, torch.Tensor]:
    """The tensors the optimizer updates, by parameter name: the master
    copy where the model has one, else the parameter itself."""
    master = getattr(model, "master", None) or {}
    return {name: master.get(name, p)
            for name, p in model.named_parameters() if p.requires_grad}


def init_all(cfg: ArchConfig, *, seed: int = 0, device="cuda"):
    """Random weights (:func:`init_flat`, drawn from ``seed`` on
    ``device``) as a trainable model, and zero AdamW state."""
    dev = dispatch.resolve_device(device)
    flat = init_flat(cfg, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(seed))
    model = make_trainable(transformer.Transformer(cfg, flat), cfg, flat)
    return model, adamw_init(trainable(model))


def _cross_entropy(logits: torch.Tensor, targets: torch.Tensor
                   ) -> torch.Tensor:
    """Per-position CE, float32: ``logsumexp`` minus the target's logit.
    The logit is picked with ``gather``; the reference contracts with a
    (B, S, V) one-hot, whose other terms are exact zeros, so the values are
    identical, and at full width the one-hot would cost as much as the
    logits (about 10 GB at 4 x 4095 x 151,936)."""
    lf = logits.to(torch.float32)
    picked = lf.gather(-1, targets[..., None].to(torch.int64))[..., 0]
    return torch.logsumexp(lf, dim=-1) - picked


def loss_fn(model: transformer.Transformer, batch: Batch, cfg: ArchConfig
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """-> (total, {"loss", "aux"}): next-token CE, the mean over B x
    (S - 1) positions (the head runs on positions :-1 only: the reference
    computes all S and drops the last, the same numbers), or for
    ``embedding_inputs`` HuBERT's masked CE, ``sum(nll * mask) /
    max(mask.sum(), 1)``; ``total = loss + AUX_WEIGHT * aux`` with aux the
    MoE router's load-balancing term (0 otherwise)."""
    if cfg.embedding_inputs:
        x, aux, _ = transformer._blocks(model, batch["embeddings"], cfg,
                                        collect_cache=False)
        nll = _cross_entropy(transformer.lm_head(model, x, cfg),
                             batch["labels"])
        mask = batch["mask"].to(torch.float32)
        loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1)
    else:
        tokens = batch["tokens"]
        x, aux, _ = transformer._blocks(model, tokens, cfg,
                                        collect_cache=False)
        nll = _cross_entropy(transformer.lm_head(model, x[:, :-1], cfg),
                             tokens[:, 1:])
        loss = nll.mean()
    aux = torch.as_tensor(aux, dtype=torch.float32, device=loss.device)
    return loss + AUX_WEIGHT * aux, {"loss": loss, "aux": aux}


def loss_and_grads(model: transformer.Transformer, batch: Batch,
                   cfg: ArchConfig):
    """-> (total, {"loss", "aux"}, grads): :func:`loss_fn` and its
    gradients (flash attention's hand-written backward where
    ``cfg.use_flash``), keyed by parameter name, each in the dtype of the
    tensor the optimizer updates (:func:`trainable`); None for a parameter
    the loss does not reach. The parameters' ``.grad`` are left None."""
    params = {name: p for name, p in model.named_parameters()
              if p.requires_grad}
    if not params:
        raise ValueError("the model has no trainable parameter: build it "
                         "with init_all or make_trainable")
    for p in params.values():
        p.grad = None
    with torch.enable_grad():
        total, metrics = loss_fn(model, batch, cfg)
        total.backward()
    opt = trainable(model)
    grads = {name: None if p.grad is None else p.grad.to(opt[name].dtype)
             for name, p in params.items()}
    for p in params.values():
        p.grad = None
    return (total.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def train_step(model: transformer.Transformer, opt_state: Dict,
               batch: Batch, cfg: ArchConfig, opt_cfg: AdamWConfig):
    """One step: :func:`loss_and_grads`, then AdamW. Updates the model's
    parameters (and masters) and ``opt_state`` IN PLACE and returns
    ``(model, opt_state, metrics)``, metrics ``loss``, ``aux``, ``total``,
    ``lr`` and ``grad_norm`` as float32 tensors on the model's device."""
    total, metrics, grads = loss_and_grads(model, batch, cfg)
    params = dict(model.named_parameters())
    _, opt_state, opt_metrics = adamw_update(trainable(model), grads,
                                             opt_state, opt_cfg)
    with torch.no_grad():
        for name, master in (getattr(model, "master", None) or {}).items():
            params[name].copy_(master)
        for m in model.modules():
            if isinstance(m, ssm.Mamba2):
                m.refresh()
    return model, opt_state, dict(metrics, total=total, **opt_metrics)


@torch.no_grad()
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


@torch.no_grad()
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
