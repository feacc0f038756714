"""Mamba2 SSD (state-space dual) scan, forward.

Counterpart of ``repro/kernels/mamba2_ssd/ops.py`` and its oracle
``ref.py``. On a CUDA tensor :func:`ssd` launches the Hopper kernel of
``repro_torch/csrc/mamba2_ssd.cu``; on a CPU tensor it runs
:func:`ssd_plain`, which repeats the kernel's arithmetic step by step with
torch ops. Both compute the reference's recurrence, per (b, h), with S the
(N, hd) float32 state starting at ``s0``:

* ``S_t = e^{dt_t a} S_{t-1} + b_t (dt_t x_t)ᵀ``;
* ``y_t = c_t · S_t + d x_t``.

``b`` and ``c`` hold one group shared by every head, ``dt`` is
post-softplus, ``a = -exp(A_log) < 0`` and ``d`` are per head.

The reference's gates are gone: ``use_kernel`` (its per-head scan on short
sequences), ``interpret`` and ``S % chunk == 0``. They guarded the TPU's
chunked closed form; the CUDA kernel runs the recurrence itself, so it
takes any S ≥ 0 (S = 0 returns ``s0``), ragged S and single decode steps
included, and dt = 0.

Layouts: ``x`` is (B, S, H, hd) and ``b``/``c`` (B, S, N), ``dt`` (B, S, H);
each (b, t) row of them must be contiguous, but the batch and time strides
are free, so the model passes its views of the conv output without a copy.
``a``, ``d``, ``s0`` and ``state_out`` are contiguous. With ``state_out``
the final state is written there (it may be ``s0`` itself: a decode step
updates its cache in place) and returned.

No backward: the training slice adds it as a ``torch.autograd.Function``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, dispatch

SIZES = (16, 32, 64, 128)    # the kernel's compiled state sizes and head dims


def _check(x, b, c, dt, a, d, s0, state_out) -> None:
    named = (("x", x), ("b", b), ("c", c), ("dt", dt), ("a", a), ("d", d),
             ("s0", s0), ("state_out", state_out))
    for name, t in named:
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    if x.dim() != 4:
        raise ValueError(f"x: expected (B, S, H, hd), got shape "
                         f"{tuple(x.shape)}")
    if b.dim() != 3:
        raise ValueError(f"b: expected (B, S, N), got shape "
                         f"{tuple(b.shape)}")
    bb, s, h, hd = x.shape
    n = b.shape[-1]
    want = {"b": (bb, s, n), "c": (bb, s, n), "dt": (bb, s, h), "a": (h,),
            "d": (h,), "s0": (bb, h, n, hd), "state_out": (bb, h, n, hd)}
    for name, t in named[1:]:
        if t is not None and tuple(t.shape) != want[name]:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{want[name]}")
    if hd not in SIZES or n not in SIZES:
        raise ValueError(f"head_dim {hd}, state {n}: the kernel takes "
                         f"{SIZES}")
    # strides only where there are elements: an empty tensor's strides are
    # whatever torch made them
    if x.numel() and (x.stride(3) != 1 or x.stride(2) != hd):
        raise ValueError("x: each (b, t) row of H * hd values must be "
                         "contiguous")
    for name, t in (("b", b), ("c", c), ("dt", dt)):
        if t.numel() and t.stride(2) != 1:
            raise ValueError(f"{name}: each (b, t) row must be contiguous")
    for name, t in (("a", a), ("d", d), ("s0", s0),
                    ("state_out", state_out)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")


def ssd_plain(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
              dt: torch.Tensor, a: torch.Tensor, d: torch.Tensor,
              s0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in torch ops, one step at a time over all
    heads at once, float32."""
    state = s0.clone()
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    for t in range(x.shape[1]):
        decay = torch.exp(dt[:, t] * a)                     # (B, H)
        dx = dt[:, t, :, None] * x[:, t]                    # (B, H, hd)
        state = (decay[:, :, None, None] * state
                 + b[:, t, None, :, None] * dx[:, :, None, :])
        y[:, t] = (torch.einsum("bn,bhnp->bhp", c[:, t], state)
                   + d[:, None] * x[:, t])
    return y, state


def ssd(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor, dt: torch.Tensor,
        a: torch.Tensor, d: torch.Tensor, s0: torch.Tensor, *,
        state_out: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, H, hd), b/c (B, S, N), dt (B, S, H), a/d (H,), s0 (B, H, N,
    hd), float32 -> (y (B, S, H, hd), final state (B, H, N, hd)). Replaces
    ``ssd_pallas``."""
    _check(x, b, c, dt, a, d, s0, state_out)
    tier = dispatch.tier(x)
    dispatch.note_tier("mamba2_ssd", tier)
    if tier == "torch":
        y, state = ssd_plain(x, b, c, dt, a, d, s0)
        if state_out is not None:
            state = state_out.copy_(state)
        return y, state
    bb, s, h, hd = x.shape
    n = b.shape[-1]
    y = torch.empty((bb, s, h, hd), dtype=torch.float32, device=x.device)
    s_out = torch.empty_like(s0) if state_out is None else state_out
    if bb and h:
        _build.launch("mamba2_ssd", "rt_ssd_fwd", x.device, x.data_ptr(),
                      b.data_ptr(), c.data_ptr(), dt.data_ptr(), a.data_ptr(),
                      d.data_ptr(), s0.data_ptr(), y.data_ptr(),
                      s_out.data_ptr(), bb, s, h, hd, n, x.stride(0),
                      x.stride(1), b.stride(0), b.stride(1), c.stride(0),
                      c.stride(1), dt.stride(0), dt.stride(1))
    return y, s_out
