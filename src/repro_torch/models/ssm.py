"""Mamba2 layer (SSD, state-space duality): prefill and one-token decode.

Counterpart of ``repro/models/ssm.py``, zamba2-7b's backbone. Weights live
in a ``Mamba2`` module built from one layer's ``mamba`` leaves: the
projections and the causal conv in the compute dtype, ``dt_bias``,
``A_log``, ``D`` and the gated norm's scale in float32, as the reference
reads them.

The scan always goes through ``repro_torch.kernels.mamba2_ssd``, in prefill
and in the one-token decode alike: on a CUDA tensor that is the
hand-written kernel, on a CPU tensor its plain version. The reference runs
neither its Pallas kernel nor its scan oracle here: its prefill computes
the chunked form in jnp (intra-chunk matrix products, a ``lax.scan`` over
chunk states) and its decode one step of einsums. All compute the same
function. In float32 they agree to float32 rounding; in bf16 compute they
differ by design, because the reference rounds the intra-chunk scores
(``ssm.py:119-120``) and the inter-chunk term (``:142-144``) to bf16 before
it sums them, where the kernel keeps float32 until ``y`` is cast for the
gated norm.

The causal conv is K shifted multiply-adds in the compute dtype, as the
reference writes it, in prefill and decode alike (``F.conv1d`` would go
through cuDNN, in TF32 for float32 by default). The decode state is the
reference's: ``conv``, the last K-1 rows of the pre-conv ``xbc`` in the
compute dtype (zeros before position 0), and ``ssm``, the (H, N, hd)
float32 scan state. ``mamba2_decode`` updates both in place.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.mamba2_ssd import ops as ssd_ops
from repro_torch.models.layers import _param, dtype

N_GROUPS = 1
NORM_EPS = 1e-6

State = Dict[str, torch.Tensor]


def dims(cfg: ArchConfig) -> Dict[str, int]:
    d_in = cfg.ssm_expand * cfg.d_model
    return dict(
        d_in=d_in,
        n_heads=d_in // cfg.ssm_head_dim,
        conv_dim=d_in + 2 * N_GROUPS * cfg.ssm_state,
    )


class Mamba2(nn.Module):
    """One layer's ``mamba`` leaves: ``in_proj`` (d, 2 d_in + 2 N + H),
    ``conv_w`` (K, conv_dim), ``conv_b``, ``out_proj`` (d_in, d) in the
    compute dtype; ``dt_bias``, ``A_log``, ``D`` (H,) and ``norm`` (d_in,)
    in float32. ``a = -exp(A_log)`` is kept beside them (``refresh``
    recomputes it after a training step changes ``A_log``)."""

    def __init__(self, cfg: ArchConfig, w: Mapping[str, torch.Tensor]):
        super().__init__()
        cd = dtype(cfg.compute_dtype)
        for name in ("in_proj", "conv_w", "conv_b", "out_proj"):
            setattr(self, name, _param(w[name], cd))
        for name in ("dt_bias", "A_log", "D", "norm"):
            setattr(self, name, _param(w[name], torch.float32))
        self.register_buffer("a", -torch.exp(self.A_log.detach()),
                             persistent=False)

    def refresh(self) -> None:
        """Recompute ``a`` from ``A_log`` (after a training step)."""
        with torch.no_grad():
            self.a.copy_(-torch.exp(self.A_log))


def _a(p: Mamba2) -> torch.Tensor:
    """``a = -exp(A_log)``: the kept buffer, or, while autograd records a
    trainable ``A_log``, computed from it so that its gradient flows."""
    if torch.is_grad_enabled() and p.A_log.requires_grad:
        return -torch.exp(p.A_log)
    return p.a


def _split_proj(zxbcdt: torch.Tensor, cfg: ArchConfig
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> z (..., d_in), xbc (..., d_in + 2 N), dt (..., H): views."""
    dm = dims(cfg)
    d_in, nh = dm["d_in"], dm["n_heads"]
    return torch.split(zxbcdt, [d_in, dm["conv_dim"], nh], dim=-1)


def _conv_train(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                ) -> torch.Tensor:
    """Causal depthwise conv over the sequence. xbc: (B, S, C), w: (K, C)."""
    k, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = pad[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + pad[:, i:i + s] * w[i]
    return F.silu(out + b)


def _gated_norm(y: torch.Tensor, z: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """RMS norm of y * silu(z) in float32, back in y's dtype."""
    yf = (y * F.silu(z)).to(torch.float32)
    var = (yf ** 2).mean(-1, keepdim=True)
    return (yf * torch.rsqrt(var + NORM_EPS) * scale).to(y.dtype)


def _scan_inputs(p: Mamba2, xbc: torch.Tensor, dtr: torch.Tensor,
                 cfg: ArchConfig):
    """The conv output and the raw dt, (B, S, ...) -> float32 x (B, S, H,
    hd), b, c (B, S, N) and dt (B, S, H) post-softplus, for the SSD op."""
    dm = dims(cfg)
    b, s = xbc.shape[:2]
    xbc = xbc.to(torch.float32)
    xs, bmat, cmat = torch.split(
        xbc, [dm["d_in"], cfg.ssm_state, cfg.ssm_state], dim=-1)
    xh = xs.reshape(b, s, dm["n_heads"], cfg.ssm_head_dim)
    dt = F.softplus(dtr.to(torch.float32) + p.dt_bias)
    return xh, bmat, cmat, dt


def mamba2_apply(p: Mamba2, x: torch.Tensor, cfg: ArchConfig,
                 return_state: bool = False):
    """Prefill forward. x: (B, S, d) with S a multiple of ``min(ssm_chunk,
    S)`` (the reference's requirement, kept so the two raise alike; the
    SSD op takes any S). -> (out in x's dtype, the decode state after the
    last position with ``return_state``, else None)."""
    cd = dtype(cfg.compute_dtype)
    b, s, _ = x.shape
    q = min(cfg.ssm_chunk, s)
    if q and s % q:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"SSM chunk {q}")
    dm = dims(cfg)
    zxbcdt = x.to(cd) @ p.in_proj
    z, xbc_raw, dtr = _split_proj(zxbcdt, cfg)
    xbc = _conv_train(xbc_raw, p.conv_w, p.conv_b)
    xh, bmat, cmat, dt = _scan_inputs(p, xbc, dtr, cfg)
    s0 = torch.zeros((b, dm["n_heads"], cfg.ssm_state, cfg.ssm_head_dim),
                     dtype=torch.float32, device=x.device)
    y, s_final = ssd_ops.ssd(xh, bmat, cmat, dt, _a(p), p.D, s0)
    y = _gated_norm(y.reshape(b, s, dm["d_in"]).to(cd), z, p.norm)
    out = (y @ p.out_proj).to(x.dtype)
    if not return_state:
        return out, None
    k = cfg.ssm_conv - 1
    tail = F.pad(xbc_raw, (0, 0, max(k - s, 0), 0))[:, -k:]
    return out, dict(conv=tail, ssm=s_final)


def mamba2_init_state(cfg: ArchConfig, batch: int, *,
                      device="cuda") -> State:
    dm = dims(cfg)
    return dict(
        conv=torch.zeros((batch, cfg.ssm_conv - 1, dm["conv_dim"]),
                         dtype=dtype(cfg.compute_dtype), device=device),
        ssm=torch.zeros((batch, dm["n_heads"], cfg.ssm_state,
                         cfg.ssm_head_dim), dtype=torch.float32,
                        device=device),
    )


def mamba2_decode(p: Mamba2, x: torch.Tensor, state: State,
                  cfg: ArchConfig) -> Tuple[torch.Tensor, State]:
    """Single-token step. x: (B, d); state: {conv, ssm} as
    ``mamba2_init_state`` makes them, updated IN PLACE (the reference
    returns new arrays) and returned. The scan is the SSD op with S = 1,
    writing the new state over the old."""
    cd = dtype(cfg.compute_dtype)
    b = x.shape[0]
    dm = dims(cfg)
    zxbcdt = x.to(cd) @ p.in_proj
    z, xbc_new, dtr = _split_proj(zxbcdt, cfg)
    conv_in = torch.cat([state["conv"], xbc_new[:, None, :]], dim=1)
    xbc = conv_in[:, 0] * p.conv_w[0]
    for i in range(1, conv_in.shape[1]):
        xbc = xbc + conv_in[:, i] * p.conv_w[i]
    xbc = F.silu(xbc + p.conv_b)
    state["conv"].copy_(conv_in[:, 1:])
    xh, bmat, cmat, dt = _scan_inputs(p, xbc[:, None], dtr[:, None], cfg)
    y, _ = ssd_ops.ssd(xh, bmat, cmat, dt, _a(p), p.D, state["ssm"],
                       state_out=state["ssm"])
    y = _gated_norm(y.reshape(b, dm["d_in"]).to(cd), z, p.norm)
    return (y @ p.out_proj).to(x.dtype), state
