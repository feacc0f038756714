"""Mamba2 SSD (state-space dual) scan, forward.

Counterpart of ``repro/kernels/mamba2_ssd/ops.py`` and its oracle
``ref.py``. On a CUDA tensor :func:`ssd` launches one of the two Hopper
kernels of ``repro_torch/csrc/mamba2_ssd.cu``, chosen by :func:`variant`
from the call's length alone; on a CPU tensor it runs :func:`ssd_plain`,
which repeats the recurrence step by step with torch ops. All compute the
reference's recurrence, per (b, h), with S the (N, hd) float32 state
starting at ``s0``:

* ``S_t = e^{dt_t a} S_{t-1} + b_t (dt_t x_t)ᵀ``;
* ``y_t = c_t · S_t + d x_t``.

``b`` and ``c`` hold one group shared by every head, ``dt`` is
post-softplus, ``a = -exp(A_log) < 0`` and ``d`` are per head.

The variants:

* ``"tc"`` (S ≥ 64, the prefill): the reference's chunked form, chunks of
  64 steps closed into matrix products on the tensor cores, each product
  as three TF32 products (hi·hi + hi·lo + lo·hi), every sum in float32;
  within about 1e-6 of the float32 recurrence (one TF32 product would
  leave it by some 3e-4: ``tests/test_torch_ssd.py``);
* ``"rec"`` (S < 64: decode steps, short calls, S = 0): the recurrence in
  float32 multiply-adds.

The reference's gates are gone: ``use_kernel`` (its per-head scan on short
sequences), ``interpret`` and ``S % chunk == 0``. Both kernels take any S
in their range, a ragged last chunk and dt = 0 included; S = 0 returns
``s0``. The kernels are compiled for the head and state sizes in
:data:`SIZES`; a CUDA call at another size raises, a CPU call computes it.

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

SIZES = (16, 32, 64, 128)    # the kernels' compiled state sizes and head dims
TC_CHUNK = 64                # steps per chunk of the tc kernel
TC_GRAM = 36 * 64            # G's 8x8 blocks on and under its diagonal
_ENTRIES = {"tc": "rt_ssd_tc", "rec": "rt_ssd_fwd"}


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
    """The kernels' function in torch ops: the recurrence one step at a
    time over all heads at once, float32."""
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


def variant(s: int, hd: int, n: int) -> str:
    """Which kernel a CUDA call of length ``s``, head width ``hd`` and
    state size ``n`` runs: ``"tc"`` (the chunked form on the tensor cores)
    from one chunk of 64 steps up, at every ``hd`` and ``n`` of
    :data:`SIZES`, else ``"rec"`` (the recurrence: decode steps, short
    calls and S = 0)."""
    return "tc" if s >= TC_CHUNK else "rec"


def _run(var: str, x, b, c, dt, a, d, s0, s_out) -> torch.Tensor:
    """Launch kernel ``var`` on checked CUDA inputs, counted under
    ``mamba2_ssd`` and ``mamba2_ssd.<var>``; returns y. The tc kernel
    takes a scratch for G = C Bᵀ of every (b, chunk), computed once for
    all heads."""
    bb, s, h, hd = x.shape
    y = torch.empty((bb, s, h, hd), dtype=torch.float32, device=x.device)
    if not (bb and h):
        return y
    extra = ()
    if var == "tc":
        chunks = -(-s // TC_CHUNK)
        gram = torch.empty(bb * chunks * TC_GRAM, dtype=torch.float32,
                           device=x.device)
        extra = (gram.data_ptr(),)
    _build.launch("mamba2_ssd", _ENTRIES[var], x.device, x.data_ptr(),
                  b.data_ptr(), c.data_ptr(), dt.data_ptr(), a.data_ptr(),
                  d.data_ptr(), s0.data_ptr(), y.data_ptr(),
                  s_out.data_ptr(), bb, s, h, hd, b.shape[-1], x.stride(0),
                  x.stride(1), b.stride(0), b.stride(1), c.stride(0),
                  c.stride(1), dt.stride(0), dt.stride(1), *extra,
                  variant=var)
    return y


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
    hd, n = x.shape[3], b.shape[-1]
    if hd not in SIZES or n not in SIZES:
        raise ValueError(f"head_dim {hd}, state {n}: the CUDA kernels are "
                         f"compiled for head_dim and state in {SIZES}")
    s_out = torch.empty_like(s0) if state_out is None else state_out
    y = _run(variant(x.shape[1], hd, n), x, b, c, dt, a, d, s0, s_out)
    return y, s_out
