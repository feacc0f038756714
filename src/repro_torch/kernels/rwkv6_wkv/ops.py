"""RWKV6 WKV recurrence with data-dependent decay (forward).

Counterpart of ``repro/kernels/rwkv6_wkv/ops.py``. On a CUDA tensor
:func:`wkv` launches one of the three Hopper kernels of
``repro_torch/csrc/rwkv6_wkv.cu``, chosen by :func:`variant` from the
call's length alone; on a CPU tensor it runs :func:`wkv_plain`, which
repeats the recurrence step by step with torch ops, at any head size. All
compute the reference's recurrence, per (b, h), with S the (hd, hd)
float32 state starting at ``s0``:

* ``y_t = r_t·(diag(u) k_t v_tᵀ + S_{t-1})``, with ``u·k_t`` formed first;
* ``S_t = diag(w_t) S_{t-1} + k_t v_tᵀ``.

The variants:

* ``"tc"`` (S ≥ 64, the prefill): the chunked form, chunks of 64 steps in
  sub-chunks of 16, every decay a product of w's (no exp or log), the
  chunk's matrix products on the tensor cores as three TF32 products each
  (hi·hi + hi·lo + lo·hi); within 1e-6 of the float32 recurrence (one
  TF32 product would leave it by 3e-4 to 6e-4: ``tests/test_torch_wkv.py``);
* ``"dec"`` (S = 1: every decode step): the one step with one warp per 16
  state columns of a head, the state read and written in 16-byte groups,
  no shared memory and no barrier; the warps per block from
  :func:`dec_warps`. It reads s0 in 16-byte groups, so a misaligned s0
  is refused;
* ``"rec"`` (S = 0 and 2 to 63: short calls): the recurrence in float32
  multiply-adds.

The reference's gates are gone: ``use_kernel`` (the scan where the TPU
kernel did not pay), ``S % chunk == 0`` and ``interpret``. They guarded the
TPU's chunked closed form, whose ``exp(−L)`` needs chunks of at most 64
steps and ``w ≥ 1e-30``; no CUDA kernel takes a logarithm, so each takes
any S in its range, ragged S included, and ``w = 0`` exactly. The
kernels are compiled for the head sizes in :data:`HEAD_DIMS`; a CUDA call
at another size raises, a CPU call computes it.

No backward: the training slice adds it as a ``torch.autograd.Function``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build, dispatch

HEAD_DIMS = (16, 32, 64, 128)   # the kernels' compiled head sizes
MIN_TILE = 8                    # state columns of the rec kernel's blocks
TC_CHUNK = 64                   # steps per chunk of the tc kernel
DEC_COLS = 16                   # state columns of one warp of the dec kernel
DEC_MAX_WARPS = 8               # warps of a dec block, at most


def _check(r, k, v, w, u, s0) -> None:
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u),
                    ("s0", s0)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
        if t.device != r.device:
            raise ValueError(f"{name} on {t.device}, r on {r.device}")
    if r.dim() != 4:
        raise ValueError(f"r: expected (B, S, H, hd), got shape "
                         f"{tuple(r.shape)}")
    b, _, h, hd = r.shape
    for name, t in (("k", k), ("v", v), ("w", w)):
        if t.shape != r.shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, r has "
                             f"{tuple(r.shape)}")
    if u.shape != (h, hd):
        raise ValueError(f"u: shape {tuple(u.shape)}, expected {(h, hd)}")
    if s0.shape != (b, h, hd, hd):
        raise ValueError(f"s0: shape {tuple(s0.shape)}, expected "
                         f"{(b, h, hd, hd)}")


def wkv_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in torch ops, one step at a time."""
    state = s0.clone()
    uk = u * k
    y = torch.empty_like(r)
    for t in range(r.shape[1]):
        vt = v[:, t, :, None, :]
        y[:, t] = torch.einsum("bhi,bhij->bhj", r[:, t],
                               uk[:, t, :, :, None] * vt + state)
        state = w[:, t, :, :, None] * state + k[:, t, :, :, None] * vt
    return y, state


def col_tiles(b: int, h: int, hd: int, n_sms: int) -> int:
    """How many blocks of the rec kernel share one (b, h): 1 when B * H
    blocks fill a wave of the card's ``n_sms`` SMs, else the fewest powers
    of two that do, keeping at least ``MIN_TILE`` state columns per
    block."""
    tiles = 1
    while b * h * tiles < n_sms and hd // (2 * tiles) >= MIN_TILE:
        tiles *= 2
    return tiles


def dec_warps(b: int, h: int, hd: int, n_sms: int) -> int:
    """Warps per block of the dec kernel. It runs ``b * h * hd / 16``
    warps, warp ``i`` of block ``n`` taking warp index ``n * W + i``:
    (b, h) = index // (hd / 16), columns 16 (index % (hd / 16)) + 0..15.
    With ``waves`` = the fewest rounds of ``DEC_MAX_WARPS``-warp blocks on
    every one of the card's ``n_sms`` SMs that hold them all, W is the
    fewest warps that make at most ``n_sms * waves`` blocks: no SM holds
    more than ``waves`` blocks, and a grid under one wave runs one warp a
    block."""
    warps = b * h * (hd // DEC_COLS)
    waves = max(1, -(-warps // (n_sms * DEC_MAX_WARPS)))
    return max(1, -(-warps // (n_sms * waves)))


def variant(s: int, hd: int) -> str:
    """Which kernel a CUDA call of length ``s`` and head size ``hd`` runs,
    at every ``hd`` of :data:`HEAD_DIMS`: ``"dec"`` for one step (every
    decode step), ``"tc"`` (the chunked form on the tensor cores) from one
    chunk of 64 steps up, else ``"rec"`` (the recurrence: S = 0 and 2 to
    63)."""
    if s == 1:
        return "dec"
    return "tc" if s >= TC_CHUNK else "rec"


def _run(var: str, r, k, v, w, u, s0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch kernel ``var`` on checked CUDA inputs, counted under
    ``rwkv6_wkv`` and ``rwkv6_wkv.<var>``."""
    b, s, h, hd = r.shape
    y = torch.empty_like(r)
    s_out = torch.empty_like(s0)
    if not (b and h):
        return y, s_out
    ptrs = (r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), s0.data_ptr(), y.data_ptr(), s_out.data_ptr())
    if var == "tc":
        _build.launch("rwkv6_wkv", "rt_wkv_tc", r.device, *ptrs, b, s, h, hd,
                      variant=var)
        return y, s_out
    n_sms = torch.cuda.get_device_properties(r.device).multi_processor_count
    if var == "dec":
        if s != 1:
            raise ValueError(f"the dec kernel takes one step, got S = {s}")
        _build.launch("rwkv6_wkv", "rt_wkv_dec", r.device, *ptrs, b, h, hd,
                      dec_warps(b, h, hd, n_sms), variant=var)
    else:
        _build.launch("rwkv6_wkv", "rt_wkv_fwd", r.device, *ptrs, b, s, h, hd,
                      hd // col_tiles(b, h, hd, n_sms), variant=var)
    return y, s_out


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
        u: torch.Tensor, s0: torch.Tensor
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k/v/w (B, S, H, hd), u (H, hd), s0 (B, H, hd, hd), float32 ->
    (y (B, S, H, hd), final state (B, H, hd, hd)). Replaces
    ``wkv_pallas``."""
    _check(r, k, v, w, u, s0)
    t = dispatch.tier(r)
    dispatch.note_tier("wkv", t)
    if t == "torch":
        return wkv_plain(r, k, v, w, u, s0)
    b, s, h, hd = r.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd}: the CUDA kernels are compiled for "
                         f"head_dim in {HEAD_DIMS}")
    var = variant(s, hd)
    # rec and tc read s0 in 4-byte words; dec reads it in 16-byte groups
    aligned = (("r", r), ("k", k), ("v", v), ("w", w), ("u", u))
    for name, x in aligned + ((("s0", s0),) if var == "dec" else ()):
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel reads 16-byte groups; the "
                             "tensor's storage is not 16-byte aligned")
    return _run(var, r, k, v, w, u, s0)
