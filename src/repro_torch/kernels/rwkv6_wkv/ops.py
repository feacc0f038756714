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

The gradient: a call that needs one (grad enabled and an input that
requires it) goes through ``_WKV``, an autograd Function whose forward is
the forward above and whose backward is :func:`wkv_bwd`. On a CUDA tensor
that runs one of two routes, chosen by :func:`bwd_variant` from the
length alone (the forward's rule):

* ``"tc"`` (S ≥ 64): the four kernels of
  ``repro_torch/csrc/rwkv6_wkv_bwd_tc.cu``, the gradient of the chunked
  form on the tensor cores (each chunk's own state and gradient parts,
  the passes over the chunk boundaries, the gradients a block per (b,
  chunk, h) with dw taken per sub-chunk of 16 steps, the sum of du's
  parts), every product as three TF32 products and every decay a product
  of w's: no log, no exp, no division by w;
* ``"rec"`` (S < 64): the two kernels of
  ``repro_torch/csrc/rwkv6_wkv_bwd.cu`` (the reverse sweep, then the sum
  of ``du`` over the batch).

On a CPU tensor it runs :func:`wkv_bwd_plain`, the plain version of both.
The reference has no backward kernel: XLA differentiates its scan.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, dispatch

HEAD_DIMS = (16, 32, 64, 128)   # the kernels' compiled head sizes
MIN_TILE = 8                    # state columns of the rec kernel's blocks
TC_CHUNK = 64                   # steps per chunk of the tc kernel
DEC_COLS = 16                   # state columns of one warp of the dec kernel
DEC_MAX_WARPS = 8               # warps of a dec block, at most
BWD_CHUNK = 16                  # steps between the rec backward's checkpoints
# steps per chunk of the tc backward, by head size (at hd 128 the chunk's
# staged rows of 64 steps would not fit a block's shared memory), in
# sub-chunks of BWD_TC_SUB
BWD_TC_CHUNK = {16: 64, 32: 64, 64: 64, 128: 32}
BWD_TC_SUB = 16
# each backward route's kernels, in launch order; a launch is counted
# under its kernel and under "<kernel>.<route>" ("rwkv6_wkv_bwd.<route>":
# one a call)
BWD_KERNELS = {
    "rec": ("rwkv6_wkv_bwd", "rwkv6_wkv_bwd_sum"),
    "tc": ("rwkv6_wkv_bwd_states", "rwkv6_wkv_bwd_pass", "rwkv6_wkv_bwd",
           "rwkv6_wkv_bwd_sum"),
}


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
    n_sms = dispatch.n_sms(r.device)
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
    ``wkv_pallas``; differentiable (through ``_WKV``) when grad is enabled
    and an input requires it."""
    _check(r, k, v, w, u, s0)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (r, k, v, w, u, s0)):
        return _WKV.apply(r, k, v, w, u, s0)
    return _forward(r, k, v, w, u, s0)


class _WKV(torch.autograd.Function):
    """The forward saves its inputs; the backward is :func:`wkv_bwd`, with
    the gradients of y and of the final state."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        ctx.save_for_backward(r, k, v, w, u, s0)
        return _forward(r, k, v, w, u, s0)

    @staticmethod
    def backward(ctx, dy, ds):
        return wkv_bwd(*ctx.saved_tensors, dy.contiguous(), ds.contiguous())


@dispatch.kernel_op("wkv", lambda r, *a: variant(r.shape[1], r.shape[3]))
def _forward(r, k, v, w, u, s0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward of a checked call: a kernel on a CUDA tensor, the plain
    version on a CPU tensor, the CUDA path with nothing launched on a meta
    tensor."""
    t = dispatch.tier(r, meta=True)
    dispatch.note_tier("wkv", t)
    if t == "torch":
        return wkv_plain(r, k, v, w, u, s0)
    b, s, h, hd = r.shape
    _check_cuda(hd)
    var = variant(s, hd)
    # rec and tc read s0 in 4-byte words; dec reads it in 16-byte groups
    aligned = (("r", r), ("k", k), ("v", v), ("w", w), ("u", u))
    for name, x in aligned + ((("s0", s0),) if var == "dec" else ()):
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel reads 16-byte groups; the "
                             "tensor's storage is not 16-byte aligned")
    return _run(var, r, k, v, w, u, s0)


def _check_cuda(hd: int) -> None:
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd}: the CUDA kernels are compiled for "
                         f"head_dim in {HEAD_DIMS}")


# --------------------------------------------------------------------------- #
# backward
# --------------------------------------------------------------------------- #

def wkv_bwd_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
                  dy: torch.Tensor, ds: torch.Tensor):
    """The reverse recurrence in torch ops, one step at a time, at any head
    size and float dtype. A forward sweep keeps the state before every
    ``BWD_CHUNK`` steps; each chunk, last first, recomputes its states from
    there and runs backwards, with G the gradient of the state after step
    t (``ds`` after the last):

    * ``dr_t = u∘k_t (v_t·dy_t) + S_{t-1} dy_t``;
    * ``dk_t = u∘r_t (v_t·dy_t) + G v_t``;
    * ``dv_t = (Σ_i u_i r_t[i] k_t[i]) dy_t + Gᵀ k_t``;
    * ``dw_t[i] = Σ_j G[i, j] S_{t-1}[i, j]``;
    * ``du = Σ_{b, t} r_t∘k_t (v_t·dy_t)``;
    * then ``G <- diag(w_t) G + r_t dy_tᵀ``, and ``ds0`` is the last G.

    -> (dr, dk, dv, dw, du, ds0)."""
    s = r.shape[1]

    def step(st, t):
        return (w[:, t, :, :, None] * st
                + k[:, t, :, :, None] * v[:, t, :, None, :])
    marks, state = [], s0
    for t in range(s):
        if t % BWD_CHUNK == 0:
            marks.append(state)
        state = step(state, t)
    g = ds.clone()
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du = torch.zeros_like(u)
    for c in reversed(range(len(marks))):
        lo, hi = c * BWD_CHUNK, min((c + 1) * BWD_CHUNK, s)
        before = [marks[c]]
        for t in range(lo, hi - 1):
            before.append(step(before[-1], t))
        for t in reversed(range(lo, hi)):
            sp = before[t - lo]
            rt, kt, vt, wt, dyt = (x[:, t] for x in (r, k, v, w, dy))
            vdy = (vt * dyt).sum(-1, keepdim=True)          # (B, H, 1)
            dr[:, t] = u * kt * vdy + torch.einsum("bhij,bhj->bhi", sp, dyt)
            dk[:, t] = u * rt * vdy + torch.einsum("bhij,bhj->bhi", g, vt)
            dv[:, t] = ((u * rt * kt).sum(-1, keepdim=True) * dyt
                        + torch.einsum("bhij,bhi->bhj", g, kt))
            dw[:, t] = (g * sp).sum(-1)
            du += (rt * kt * vdy).sum(0)
            g = wt[..., None] * g + rt[..., None] * dyt[:, :, None, :]
    return dr, dk, dv, dw, du, g


def bwd_variant(s: int, hd: int) -> str:
    """Which backward a CUDA call of length ``s`` and head size ``hd``
    runs: ``"tc"`` (the chunked form's gradient on the tensor cores) from
    one chunk of 64 steps up, at every ``hd`` of :data:`HEAD_DIMS`, else
    ``"rec"`` (the reverse recurrence): the rule by which :func:`variant`
    picks the forward's tc kernel."""
    return "tc" if s >= TC_CHUNK else "rec"


def _bwd_route(r, *args, route: Optional[str] = None) -> str:
    return route or bwd_variant(r.shape[1], r.shape[3])


@dispatch.kernel_op("wkv.bwd", _bwd_route)
def wkv_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
            dy: torch.Tensor, ds: torch.Tensor, *,
            route: Optional[str] = None):
    """(dr, dk, dv, dw, du, ds0) of :func:`wkv` at (r, k, v, w, u, s0), from
    the gradients of y (``dy``, (B, S, H, hd)) and of the final state
    (``ds``, (B, H, hd, hd)), float32. On a CUDA tensor the kernels of
    ``route`` run in turn (:data:`BWD_KERNELS`; default: the route
    :func:`bwd_variant` picks; another only to compare the two, tc taking
    any S >= 1):

    * ``"tc"``: ``csrc/rwkv6_wkv_bwd_tc.cu``, the chunked form's gradient
      on the tensor cores: each chunk's own state and gradient parts, the
      passes over the chunk boundaries, the gradients a block per (b,
      chunk, h), the sum of du's parts;
    * ``"rec"``: ``csrc/rwkv6_wkv_bwd.cu``, the reverse sweep (every
      gradient but du, and du's part of each (b, h)), then the sum of
      those parts over b.

    On a CPU tensor, :func:`wkv_bwd_plain`; on a meta tensor, the CUDA
    path with nothing launched."""
    _check(r, k, v, w, u, s0)
    for name, x, want in (("dy", dy, r.shape), ("ds", ds, s0.shape)):
        if (x.shape != want or x.dtype != torch.float32
                or x.device != r.device or not x.is_contiguous()):
            raise ValueError(f"{name}: expected a contiguous float32 tensor "
                             f"of shape {tuple(want)} on {r.device}; got "
                             f"{tuple(x.shape)}, {x.dtype}, {x.device}")
    t = dispatch.tier(r, meta=True)
    dispatch.note_tier("wkv.bwd", t)
    if t == "torch":
        return wkv_bwd_plain(r, k, v, w, u, s0, dy, ds)
    b, s, h, hd = r.shape
    _check_cuda(hd)
    grads = tuple(torch.empty_like(r) for _ in range(4))
    du = torch.zeros_like(u)
    ds0 = torch.empty_like(s0)
    if not (b and h):
        return (*grads, du, ds0)
    route = route or bwd_variant(s, hd)
    kernels = BWD_KERNELS[route]
    inputs = tuple(x.data_ptr() for x in (r, k, v, w, u, s0, dy, ds))
    outputs = tuple(x.data_ptr() for x in grads) + (ds0.data_ptr(),)
    if route == "tc":
        chunks = -(-s // BWD_TC_CHUNK[hd])
        # each chunk's own parts of S and G, then S_in and G_out (B, H,
        # chunks, hd, hd); the chunks' decays (B, H, chunks, hd); du's
        # part of each block (B, chunks, H, hd)
        s_in, g_out = (torch.empty(b * h * chunks * hd * hd,
                                   dtype=torch.float32, device=r.device)
                       for _ in range(2))
        decay = torch.empty(b * h * chunks * hd, dtype=torch.float32,
                            device=r.device)
        du_part = torch.empty(b * chunks * h * hd, dtype=torch.float32,
                              device=r.device)
        ptrs = inputs + outputs + tuple(x.data_ptr() for x in (
            s_in, g_out, decay, du_part, du))
        for which, kernel in enumerate(kernels):
            _build.launch(kernel, "rt_wkv_bwd_tc", r.device, *ptrs, b, s, h,
                          hd, which, variant=route)
        return (*grads, du, ds0)
    du_part = torch.empty((b, h, hd), dtype=torch.float32, device=r.device)
    chunks = -(-s // BWD_CHUNK)
    marks = torch.empty(b * h * max(chunks, 1) * hd * hd, dtype=torch.float32,
                        device=r.device)
    hist = torch.empty(b * h * BWD_CHUNK * hd * hd, dtype=torch.float32,
                       device=r.device)
    scan, total = kernels
    _build.launch(scan, "rt_wkv_bwd", r.device, *inputs, *outputs,
                  du_part.data_ptr(), marks.data_ptr(), hist.data_ptr(),
                  b, s, h, hd, variant=route)
    _build.launch(total, "rt_wkv_bwd_sum", r.device, du_part.data_ptr(),
                  du.data_ptr(), b, h * hd, variant=route)
    return (*grads, du, ds0)
