"""RWKV-6 "Finch" layer: data-dependent decay WKV + channel mix.

Counterpart of ``repro/models/rwkv.py`` (arXiv:2404.05892): ddlerp
token-shift (LoRA-modulated mixing), per-channel data-dependent decay
``w = exp(-exp(w0 + lora(x_w)))``, per-head bonus ``u``, grouped head-norm
(eps 64e-5), gated output; squared-ReLU channel mix.

Weights live in ``nn.Module``s built from the reference's ``tm`` leaves:
``TimeMix`` keeps its matrices in float32, because the time mix runs in
float32 whatever the compute dtype (the reference upcasts them at every
call), and ``ChannelMix`` casts its matrices to the compute dtype once.
``time_mix`` returns in x's dtype. Its float32 matrix products are full
float32 only with TF32 off, torch's default, which nothing here changes.

The WKV recurrence always goes through ``repro_torch.kernels.rwkv6_wkv``,
in prefill and in the one-token decode alike, whatever ``cfg.use_flash``
says: on a CUDA tensor that is the hand-written kernel, on a CPU tensor its
plain version. The reference's prefill takes its Pallas kernel under
``use_flash`` and its scan otherwise, and its decode always scans
(``rwkv_block_decode`` calls ``time_mix`` without the kernel); the kernel
and the scans compute the same function.

Decode state: the reference returns the shift states of a decode step in
the compute dtype (``h[:, 0]``) and those of a prefill in float32. The
values are the same (they come from compute-dtype activations), so the port
keeps the float32 caches of the prefill throughout and the caller writes
each step's states into them in place.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
from repro_torch.models.layers import Norm, _param, _sub, dtype, norm_apply

MIX_LORA = 32
HEAD_NORM_EPS = 64e-5

State = Dict[str, torch.Tensor]


def n_heads(cfg: ArchConfig) -> int:
    return cfg.d_model // cfg.rwkv_head_dim


# leaves of the reference's ``tm`` tree, by module
TIME_MIX_LEAVES = ("mu_x", "mu", "mix_w1", "mix_w2", "w0", "decay_w1",
                   "decay_w2", "u", "wr", "wk", "wv", "wg", "wo",
                   "ln_x_scale", "ln_x_bias")
CHANNEL_MIX_LEAVES = ("cm_mu_k", "cm_mu_r", "cm_k", "cm_v", "cm_r")


class TimeMix(nn.Module):
    """The time-mix leaves of ``tm``, float32."""

    def __init__(self, w: Mapping[str, torch.Tensor]):
        super().__init__()
        for name in TIME_MIX_LEAVES:
            setattr(self, name, _param(w[name], torch.float32))


class ChannelMix(nn.Module):
    """The channel-mix leaves of ``tm``, in the compute dtype."""

    def __init__(self, cfg: ArchConfig, w: Mapping[str, torch.Tensor]):
        super().__init__()
        cd = dtype(cfg.compute_dtype)
        for name in CHANNEL_MIX_LEAVES:
            setattr(self, name, _param(w[name], cd))


class RWKVBlock(nn.Module):
    """``ln1``, time mix, ``ln2``, channel mix; built from one layer's
    leaves keyed ``ln1/scale``, ``tm/mu_x``, ..."""

    def __init__(self, cfg: ArchConfig, w: Mapping[str, torch.Tensor]):
        super().__init__()
        tm = _sub(w, "tm")
        self.ln1 = Norm(_sub(w, "ln1"))
        self.tm = TimeMix(tm)
        self.ln2 = Norm(_sub(w, "ln2"))
        self.cm = ChannelMix(cfg, tm)


def _ddlerp(p: TimeMix, x: torch.Tensor, xs: torch.Tensor
            ) -> Tuple[torch.Tensor, ...]:
    """Data-dependent lerp between x and its shift xs -> (x_w, x_k, x_v,
    x_r, x_g); float32."""
    xx = xs - x
    xxx = x + xx * p.mu_x
    lora = torch.tanh(xxx @ p.mix_w1)
    lora = lora.reshape(*lora.shape[:-1], 5, MIX_LORA)
    delta = torch.einsum("...nl,nld->...nd", lora, p.mix_w2)
    mix = p.mu + delta                                       # (..., 5, d)
    return tuple(x + xx * mix[..., i, :] for i in range(5))


def _decay(p: TimeMix, x_w: torch.Tensor) -> torch.Tensor:
    ww = p.w0 + torch.tanh(x_w @ p.decay_w1) @ p.decay_w2
    return torch.exp(-torch.exp(ww))                         # in (0, 1)


def _head_norm(p: TimeMix, y: torch.Tensor, nh: int, hd: int) -> torch.Tensor:
    """GroupNorm over each head's hd channels, float32."""
    shape = y.shape
    yf = y.reshape(*shape[:-1], nh, hd)
    mu = yf.mean(-1, keepdim=True)
    var = ((yf - mu) ** 2).mean(-1, keepdim=True)
    yn = ((yf - mu) * torch.rsqrt(var + HEAD_NORM_EPS)).reshape(shape)
    return yn * p.ln_x_scale + p.ln_x_bias


def time_mix(p: TimeMix, x: torch.Tensor, xs: torch.Tensor,
             state: Optional[torch.Tensor], cfg: ArchConfig
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d), xs: x shifted by one step, state: (B, H, hd, hd)
    float32 or None (zeros) -> (y in x's dtype, the new WKV state)."""
    b, s, d = x.shape
    nh, hd = n_heads(cfg), cfg.rwkv_head_dim
    x_w, x_k, x_v, x_r, x_g = _ddlerp(p, x.to(torch.float32),
                                      xs.to(torch.float32))
    w = _decay(p, x_w).reshape(b, s, nh, hd)
    r = (x_r @ p.wr).reshape(b, s, nh, hd)
    k = (x_k @ p.wk).reshape(b, s, nh, hd)
    v = (x_v @ p.wv).reshape(b, s, nh, hd)
    g = F.silu(x_g @ p.wg)
    if state is None:
        state = torch.zeros((b, nh, hd, hd), dtype=torch.float32,
                            device=x.device)
    y, new_state = wkv_ops.wkv(r, k, v, w, p.u, state)
    y = _head_norm(p, y.reshape(b, s, d), nh, hd)
    y = (y * g) @ p.wo
    return y.to(x.dtype), new_state


def channel_mix(p: ChannelMix, x: torch.Tensor, xs: torch.Tensor,
                cfg: ArchConfig) -> torch.Tensor:
    cd = dtype(cfg.compute_dtype)
    xc, xsc = x.to(cd), xs.to(cd)
    x_k = xc + (xsc - xc) * p.cm_mu_k
    x_r = xc + (xsc - xc) * p.cm_mu_r
    k = torch.square(F.relu(x_k @ p.cm_k))
    return (torch.sigmoid(x_r @ p.cm_r) * (k @ p.cm_v)).to(x.dtype)


# --------------------------------------------------------------------------- #
# block-level apply (shift handling for prefill vs decode)
# --------------------------------------------------------------------------- #

def shift_train(x: torch.Tensor) -> torch.Tensor:
    """xs[t] = x[t-1], zeros at t=0."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def rwkv_block_apply(p: RWKVBlock, x: torch.Tensor, cfg: ArchConfig
                     ) -> Tuple[torch.Tensor, State]:
    """Forward of one block over (B, S, d) -> (x, the block's decode state
    after the last position: float32 shift states and WKV state)."""
    h = norm_apply(p.ln1, x, cfg)
    y, wkv = time_mix(p.tm, h, shift_train(h), None, cfg)
    x = x + y
    h2 = norm_apply(p.ln2, x, cfg)
    x = x + channel_mix(p.cm, h2, shift_train(h2), cfg)
    return x, dict(tm_shift=h[:, -1].to(torch.float32),
                   cm_shift=h2[:, -1].to(torch.float32), wkv=wkv)


def rwkv_block_decode(p: RWKVBlock, x: torch.Tensor, state: State,
                      cfg: ArchConfig) -> Tuple[torch.Tensor, State]:
    """Single-token step. x: (B, d). state: {tm_shift, cm_shift, wkv}.
    Returns (x, the new state); the shift states in x's dtype, as the
    reference returns them."""
    h = norm_apply(p.ln1, x[:, None, :], cfg)
    y, new_wkv = time_mix(p.tm, h, state["tm_shift"][:, None, :],
                          state["wkv"], cfg)
    x = x + y[:, 0]
    h2 = norm_apply(p.ln2, x[:, None, :], cfg)
    y2 = channel_mix(p.cm, h2, state["cm_shift"][:, None, :], cfg)
    x = x + y2[:, 0]
    return x, dict(tm_shift=h[:, 0], cm_shift=h2[:, 0], wkv=new_wkv)


def rwkv_init_state(cfg: ArchConfig, batch: int, *, device="cuda") -> State:
    nh, hd = n_heads(cfg), cfg.rwkv_head_dim
    return dict(
        tm_shift=torch.zeros((batch, cfg.d_model), device=device),
        cm_shift=torch.zeros((batch, cfg.d_model), device=device),
        wkv=torch.zeros((batch, nh, hd, hd), device=device),
    )
