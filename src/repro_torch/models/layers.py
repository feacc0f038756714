"""Shared neural layers: norms, RoPE, GQA attention, dense MLP.

Counterpart of ``repro/models/layers.py``. Weights live in ``nn.Module``s
(``Norm``, ``Attention``, ``MLP``) built from tensors in the reference's
layouts; the ``*_apply`` functions take such a module where the reference
takes a parameter dict, with the same (B, S, H, D) activations. Matrix
weights and biases are cast to the compute dtype once, when the module is
built (the reference casts them at every use: the same numbers); norm and
qk-norm scales stay float32, as the reference reads them.

Numerics kept from the reference: RMSNorm eps 1e-6, LayerNorm eps 1e-5,
qk-norm eps 1e-6; rotate-half RoPE with float32 angles; ``gelu`` in its
tanh form; the plain attention divides the logits by ``sqrt(d)`` cast to
the compute dtype and casts the probabilities to it before P·V. The flash
path (``cfg.use_flash``) goes through
``repro_torch.kernels.flash_attention``, whose scores are scaled by
``1/sqrt(d)`` in float32 and whose probabilities stay float32.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention import ops as flash

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}

Cache = Tuple[torch.Tensor, torch.Tensor]


def dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def _param(t: torch.Tensor, dt: torch.dtype) -> nn.Parameter:
    return nn.Parameter(t.to(dt).contiguous(), requires_grad=False)


def _sub(w: Mapping[str, torch.Tensor], prefix: str
         ) -> Dict[str, torch.Tensor]:
    """The leaves of ``w`` under ``prefix/``, keyed by the rest."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in w.items() if k.startswith(prefix + "/")}


# --------------------------------------------------------------------------- #
# norms
# --------------------------------------------------------------------------- #

class Norm(nn.Module):
    """RMSNorm (``scale``) or LayerNorm (``scale`` and ``bias``)."""

    def __init__(self, w: Mapping[str, torch.Tensor]):
        super().__init__()
        self.scale = _param(w["scale"], torch.float32)
        self.bias = (_param(w["bias"], torch.float32) if "bias" in w
                     else None)


def norm_apply(p: Norm, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    xf = x.to(torch.float32)
    if cfg.norm == "layernorm" and p.bias is not None:
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + 1e-5) * p.scale + p.bias
    else:
        var = (xf ** 2).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + 1e-6) * p.scale
    return y.to(x.dtype)


def rms_head_norm(scale: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """qk-norm: RMS norm over the head_dim axis (qwen3 / chameleon style)."""
    xf = x.to(torch.float32)
    var = (xf ** 2).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + 1e-6)
            * scale.to(torch.float32)).to(x.dtype)


# --------------------------------------------------------------------------- #
# RoPE
# --------------------------------------------------------------------------- #

def rope_freqs(d: int, theta: float) -> torch.Tensor:
    """The (d/2,) float32 RoPE frequencies, computed as the reference does
    (numpy, float32)."""
    half = d // 2
    return torch.from_numpy(
        1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half)))


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
         freqs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (..., S, H, D) with positions (..., S); rotate-half, first half
    against second half, angles in float32. ``freqs``: ``rope_freqs(D,
    theta)`` on x's device, kept by the caller (made here when omitted, an
    upload from the host that waits for the device)."""
    half = x.shape[-1] // 2
    if freqs is None:
        freqs = rope_freqs(x.shape[-1], theta).to(x.device)
    ang = positions[..., :, None].to(torch.float32) * freqs   # (..., S, half)
    cos = torch.cos(ang)[..., :, None, :]                     # (..., S, 1, half)
    sin = torch.sin(ang)[..., :, None, :]
    xf1 = x[..., :half].to(torch.float32)
    xf2 = x[..., half:].to(torch.float32)
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


# --------------------------------------------------------------------------- #
# attention
# --------------------------------------------------------------------------- #

class Attention(nn.Module):
    """wq (d, H, D), wk/wv (d, K, D), wo (H, D, d) in the reference's layout,
    kept as (d, H·D) / (H·D, d) matrices in the compute dtype; optional
    biases (``qkv_bias``) and qk-norm scales (``qk_norm``)."""

    def __init__(self, cfg: ArchConfig, w: Mapping[str, torch.Tensor]):
        super().__init__()
        cd = dtype(cfg.compute_dtype)
        d = cfg.d_model
        self.wq = _param(w["wq"].reshape(d, -1), cd)
        self.wk = _param(w["wk"].reshape(d, -1), cd)
        self.wv = _param(w["wv"].reshape(d, -1), cd)
        self.wo = _param(w["wo"].reshape(-1, d), cd)
        self.bq = self.bk = self.bv = self.bo = None
        if cfg.qkv_bias:
            self.bq = _param(w["bq"].reshape(-1), cd)
            self.bk = _param(w["bk"].reshape(-1), cd)
            self.bv = _param(w["bv"].reshape(-1), cd)
            self.bo = _param(w["bo"], cd)
        self.q_norm = self.k_norm = None
        if cfg.qk_norm:
            self.q_norm = _param(w["q_norm"], torch.float32)
            self.k_norm = _param(w["k_norm"], torch.float32)
        self.register_buffer(
            "freqs", rope_freqs(cfg.resolved_head_dim, cfg.rope_theta).to(
                w["wq"].device) if cfg.rope else None, persistent=False)


def _masked_softmax(logits: torch.Tensor, ok_mask: torch.Tensor,
                    v_dtype: torch.dtype, *, f32: bool) -> torch.Tensor:
    """Numerically-stable softmax over the last axis.

    ``f32=False`` keeps the probabilities in the compute dtype with only the
    row statistics in float32."""
    if f32:
        logits = torch.where(ok_mask, logits.to(torch.float32),
                             torch.full((), -1e30, device=logits.device))
        return torch.softmax(logits, dim=-1).to(v_dtype)
    neg = torch.full((), -3e38, dtype=logits.dtype, device=logits.device)
    logits = torch.where(ok_mask, logits, neg)
    m = logits.to(torch.float32).amax(-1, keepdim=True)
    p = torch.exp(logits - m.to(logits.dtype))
    p = torch.where(ok_mask, p, torch.zeros((), dtype=p.dtype,
                                            device=p.device))
    denom = p.sum(-1, keepdim=True, dtype=torch.float32)
    return (p / torch.clamp(denom, min=1e-30).to(p.dtype)).to(v_dtype)


def _sqrt_d(d: int, dt: torch.dtype) -> float:
    """``sqrt(d)`` rounded to the compute dtype (the reference divides the
    plain path's logits by ``np.sqrt(d).astype(dtype)``), as a Python
    number, so the division uploads nothing."""
    return float(torch.tensor(math.sqrt(d), dtype=dt))


def _sdpa_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, q_offset: int = 0,
                    softmax_f32: bool = True) -> torch.Tensor:
    """Grouped-query attention. q: (B,S,H,D), k/v: (B,T,K,D)."""
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    g = h // kh
    qg = q.reshape(b, s, kh, g, d)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k) / _sqrt_d(d, q.dtype)
    if causal:
        qpos = torch.arange(s, device=q.device)[:, None] + q_offset
        kpos = torch.arange(t, device=q.device)[None, :]
        ok = (qpos >= kpos)[None, None, None]
    else:
        ok = torch.ones((1, 1, 1, s, t), dtype=torch.bool, device=q.device)
    w = _masked_softmax(logits, ok, v.dtype, f32=softmax_f32)
    out = torch.einsum("bkgst,btkd->bskgd", w, v)
    return out.reshape(b, s, h, d)


def attention_apply(p: Attention, x: torch.Tensor, cfg: ArchConfig, *,
                    positions: torch.Tensor,
                    cache: Optional[Cache] = None,
                    cache_pos: Optional[int] = None,
                    ) -> Tuple[torch.Tensor, Optional[Cache]]:
    """x: (B, S, d). With ``cache`` (k_cache, v_cache of (B, T_max, K, D)):
    prefill/decode mode — the new k/v are written at ``cache_pos`` IN PLACE
    (the reference returns updated copies), and the same tensors are
    returned as the new cache."""
    cd = dtype(cfg.compute_dtype)
    b, s = x.shape[:2]
    h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    xq = x.to(cd)
    q = xq @ p.wq
    k = xq @ p.wk
    v = xq @ p.wv
    if cfg.qkv_bias:
        q = q + p.bq
        k = k + p.bk
        v = v + p.bv
    q = q.view(b, s, h, hd)
    k = k.view(b, s, kh, hd)
    v = v.view(b, s, kh, hd)
    if cfg.qk_norm:
        q = rms_head_norm(p.q_norm, q)
        k = rms_head_norm(p.k_norm, k)
    if cfg.rope:
        q = rope(q, positions, cfg.rope_theta, p.freqs)
        k = rope(k, positions, cfg.rope_theta, p.freqs)

    new_cache = None
    if cache is not None:
        kc, vc = cache
        off = 0 if cache_pos is None else int(cache_pos)
        t = kc.shape[1]
        if not 0 <= off <= t - s:
            raise ValueError(f"cache of {t} slots cannot take {s} new "
                             f"positions at {off}")
        kc[:, off:off + s] = k.to(kc.dtype)
        vc[:, off:off + s] = v.to(vc.dtype)
        new_cache = (kc, vc)
        k_att, v_att = kc.to(cd), vc.to(cd)
        if cfg.use_flash:
            out = flash.flash_attention(
                q.contiguous(), k_att, v_att, causal=cfg.causal,
                q_offset=off, kv_valid_len=off + s)
        else:
            g = h // kh
            kpos = torch.arange(t, device=x.device)
            valid = kpos < off + s
            qg = q.reshape(b, s, kh, g, hd)
            logits = torch.einsum("bskgd,btkd->bkgst", qg, k_att) / \
                _sqrt_d(hd, cd)
            ok = valid[None, :]
            if cfg.causal:
                qpos = torch.arange(s, device=x.device)[:, None] + off
                ok = ok & (qpos >= kpos[None, :])
            w = _masked_softmax(logits, ok[None, None, None], cd,
                                f32=cfg.softmax_f32)
            out = torch.einsum("bkgst,btkd->bskgd", w, v_att)
            out = out.reshape(b, s, h, hd)
    elif cfg.use_flash:
        out = flash.flash_attention(q.contiguous(), k.contiguous(),
                                    v.contiguous(), causal=cfg.causal)
    else:
        out = _sdpa_reference(q, k, v, causal=cfg.causal,
                              softmax_f32=cfg.softmax_f32)

    y = out.reshape(b, s, h * hd) @ p.wo
    if cfg.qkv_bias:
        y = y + p.bo
    return y.to(x.dtype), new_cache


# --------------------------------------------------------------------------- #
# dense MLP (SwiGLU / GELU)
# --------------------------------------------------------------------------- #

class MLP(nn.Module):
    """wi (d, f), wo (f, d), wg (d, f) for SwiGLU; biases bi, bo where the
    reference has them (``qkv_bias`` configs)."""

    def __init__(self, cfg: ArchConfig, w: Mapping[str, torch.Tensor]):
        super().__init__()
        cd = dtype(cfg.compute_dtype)
        self.wi = _param(w["wi"], cd)
        self.wo = _param(w["wo"], cd)
        self.wg = _param(w["wg"], cd) if "wg" in w else None
        self.bi = _param(w["bi"], cd) if "bi" in w else None
        self.bo = _param(w["bo"], cd) if "bo" in w else None


def mlp_apply(p: MLP, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    xc = x.to(dtype(cfg.compute_dtype))
    h = xc @ p.wi
    if p.bi is not None:
        h = h + p.bi
    if cfg.activation == "silu":
        h = F.silu(xc @ p.wg) * h
    else:
        h = F.gelu(h, approximate="tanh")
    y = h @ p.wo
    if p.bo is not None:
        y = y + p.bo
    return y.to(x.dtype)
