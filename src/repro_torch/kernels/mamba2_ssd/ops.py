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

The gradient: a call that needs one (grad enabled and an input that
requires it) goes through ``_SSD``, an autograd Function whose forward is
the forward above and whose backward is :func:`ssd_bwd`. On a CUDA tensor
that runs one of two routes, chosen by :func:`bwd_variant` from the
length alone (the forward's rule):

* ``"tc"`` (S ≥ 64): the four kernels of
  ``repro_torch/csrc/mamba2_ssd_bwd_tc.cu``, the gradient of the chunked
  form on the tensor cores (each chunk's own state and dS part, the passes
  over the chunk boundaries, the gradients a block per (b, chunk, group
  of :data:`BWD_HEADS` heads), the sums over the groups and chunks);
* ``"rec"`` (S < 64): the two kernels of
  ``repro_torch/csrc/mamba2_ssd_bwd.cu`` (the reverse sweep, then the
  sums over heads and over the batch).

On a CPU tensor it runs :func:`ssd_bwd_plain`, the plain version of both.
The reference has no backward kernel: XLA differentiates its chunked form.
Such a call takes no ``state_out`` (the in-place decode step runs without
a graph).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, dispatch

SIZES = (16, 32, 64, 128)    # the kernels' compiled state sizes and head dims
TC_CHUNK = 64                # steps per chunk of the tc kernel
TC_GRAM = 36 * 64            # G's 8x8 blocks on and under its diagonal
_ENTRIES = {"tc": "rt_ssd_tc", "rec": "rt_ssd_fwd"}
BWD_CHUNK = 16               # steps between the rec backward's checkpoints
BWD_HEADS = 16               # heads a block of the tc backward
# each backward route's kernels, in launch order; a launch is counted
# under its kernel and under "<kernel>.<route>" ("mamba2_ssd_bwd.<route>":
# one a call)
BWD_KERNELS = {
    "rec": ("mamba2_ssd_bwd", "mamba2_ssd_bwd_sum"),
    "tc": ("mamba2_ssd_bwd_states", "mamba2_ssd_bwd_pass", "mamba2_ssd_bwd",
           "mamba2_ssd_bwd_sum"),
}


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
    ``ssd_pallas``; differentiable (through ``_SSD``) when grad is enabled
    and an input requires it."""
    _check(x, b, c, dt, a, d, s0, state_out)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, b, c, dt, a, d, s0)):
        if state_out is not None:
            raise ValueError("state_out is the in-place decode form; a call "
                             "that needs a gradient returns its state")
        return _SSD.apply(x, b, c, dt, a, d, s0)
    return _forward(x, b, c, dt, a, d, s0, state_out)


class _SSD(torch.autograd.Function):
    """The forward saves its inputs; the backward is :func:`ssd_bwd`, with
    the gradients of y and of the final state."""

    @staticmethod
    def forward(ctx, x, b, c, dt, a, d, s0):
        ctx.save_for_backward(x, b, c, dt, a, d, s0)
        return _forward(x, b, c, dt, a, d, s0, None)

    @staticmethod
    def backward(ctx, dy, ds):
        return ssd_bwd(*ctx.saved_tensors, dy.contiguous(), ds.contiguous())


@dispatch.kernel_op("mamba2_ssd", lambda x, b, *a: variant(
    x.shape[1], x.shape[3], b.shape[-1]))
def _forward(x, b, c, dt, a, d, s0, state_out
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward of a checked call: a kernel on a CUDA tensor, the plain
    version on a CPU tensor, the CUDA path with nothing launched on a meta
    tensor."""
    tier = dispatch.tier(x, meta=True)
    dispatch.note_tier("mamba2_ssd", tier)
    if tier == "torch":
        y, state = ssd_plain(x, b, c, dt, a, d, s0)
        if state_out is not None:
            state = state_out.copy_(state)
        return y, state
    _check_cuda(x.shape[3], b.shape[-1])
    s_out = torch.empty_like(s0) if state_out is None else state_out
    y = _run(variant(x.shape[1], x.shape[3], b.shape[-1]), x, b, c, dt, a,
             d, s0, s_out)
    return y, s_out


def _check_cuda(hd: int, n: int) -> None:
    if hd not in SIZES or n not in SIZES:
        raise ValueError(f"head_dim {hd}, state {n}: the CUDA kernels are "
                         f"compiled for head_dim and state in {SIZES}")


# --------------------------------------------------------------------------- #
# backward
# --------------------------------------------------------------------------- #

def ssd_bwd_plain(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                  dt: torch.Tensor, a: torch.Tensor, d: torch.Tensor,
                  s0: torch.Tensor, dy: torch.Tensor, ds: torch.Tensor):
    """The reverse recurrence in torch ops, one step at a time over all
    heads at once, at any size and float dtype. A forward sweep keeps the
    state before every ``BWD_CHUNK`` steps; each chunk, last first,
    recomputes its states from there and runs backwards, with G the
    gradient of the state after step t (``ds`` after the last) and
    ``α_t = e^{dt_t a}``:

    * ``G += c_t dy_tᵀ``; ``dc_t = S_t dy_t`` (summed over heads);
    * ``db_t = Σ_h dt_t G x_t``; ``dx_t = d dy_t + dt_t Gᵀ b_t``;
    * ``ddt_t = x_t·(Gᵀ b_t) + a α_t ⟨S_{t-1}, G⟩``;
    * ``da = Σ_{b,t} dt_t α_t ⟨S_{t-1}, G⟩``, ``dd = Σ_{b,t} x_t·dy_t``;
    * then ``G <- α_t G``, and ``ds0`` is the last G.

    -> (dx, db, dc, ddt, da, dd, ds0), each contiguous in its input's
    shape."""
    s = x.shape[1]

    def step(state, t):
        return (torch.exp(dt[:, t] * a)[:, :, None, None] * state
                + b[:, t, None, :, None]
                * (dt[:, t, :, None] * x[:, t])[:, :, None, :])
    marks, state = [], s0
    for t in range(s):
        if t % BWD_CHUNK == 0:
            marks.append(state)
        state = step(state, t)
    g = ds.clone()
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    db, dc = (torch.empty(b.shape, dtype=b.dtype, device=b.device)
              for _ in range(2))
    ddt = torch.empty(dt.shape, dtype=dt.dtype, device=dt.device)
    da, dd = torch.zeros_like(a), torch.zeros_like(d)
    for ci in reversed(range(len(marks))):
        lo, hi = ci * BWD_CHUNK, min((ci + 1) * BWD_CHUNK, s)
        before = [marks[ci]]
        for t in range(lo, hi - 1):
            before.append(step(before[-1], t))
        for t in reversed(range(lo, hi)):
            sp = before[t - lo]
            xt, dyt, dtt = x[:, t], dy[:, t], dt[:, t]
            alpha = torch.exp(dtt * a)                          # (B, H)
            g = g + c[:, t, None, :, None] * dyt[:, :, None, :]
            dc[:, t] = torch.einsum("bhnp,bhp->bn", step(sp, t), dyt)
            db[:, t] = torch.einsum("bh,bhnp,bhp->bn", dtt, g, xt)
            gb = torch.einsum("bhnp,bn->bhp", g, b[:, t])       # (B, H, hd)
            dx[:, t] = d[:, None] * dyt + dtt[..., None] * gb
            sg = (sp * g).sum((-2, -1))                         # (B, H)
            ddt[:, t] = (xt * gb).sum(-1) + a * alpha * sg
            da += (dtt * alpha * sg).sum(0)
            dd += (xt * dyt).sum((0, 2))
            g = alpha[:, :, None, None] * g
    return dx, db, dc, ddt, da, dd, g


def bwd_variant(s: int, hd: int, n: int) -> str:
    """Which backward a CUDA call of length ``s``, head width ``hd`` and
    state size ``n`` runs: ``"tc"`` (the chunked form's gradient on the
    tensor cores) from one chunk of 64 steps up, at every ``hd`` and ``n``
    of :data:`SIZES`, else ``"rec"`` (the reverse recurrence): the
    forward's :func:`variant`."""
    return "tc" if s >= TC_CHUNK else "rec"


def _bwd_route(x, b, *args, route: Optional[str] = None) -> str:
    return route or bwd_variant(x.shape[1], x.shape[3], b.shape[-1])


@dispatch.kernel_op("mamba2_ssd.bwd", _bwd_route)
def ssd_bwd(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
            dt: torch.Tensor, a: torch.Tensor, d: torch.Tensor,
            s0: torch.Tensor, dy: torch.Tensor, ds: torch.Tensor, *,
            route: Optional[str] = None):
    """(dx, db, dc, ddt, da, dd, ds0) of :func:`ssd` at (x, b, c, dt, a, d,
    s0), from the gradients of y (``dy``, (B, S, H, hd)) and of the final
    state (``ds``, (B, H, N, hd)), float32, each contiguous. x, b, c and dt
    may be the strided views :func:`ssd` takes. On a CUDA tensor the
    kernels of ``route`` (default: the one :func:`bwd_variant` picks;
    another only to compare the two, and both take any S ≥ 1) run in turn
    (:data:`BWD_KERNELS`); on a CPU tensor, :func:`ssd_bwd_plain`; on a
    meta tensor, the CUDA path with nothing launched."""
    _check(x, b, c, dt, a, d, s0, None)
    for name, t, want in (("dy", dy, x.shape), ("ds", ds, s0.shape)):
        if (t.shape != want or t.dtype != torch.float32
                or t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"{name}: expected a contiguous float32 tensor "
                             f"of shape {tuple(want)} on {x.device}; got "
                             f"{tuple(t.shape)}, {t.dtype}, {t.device}")
    tier = dispatch.tier(x, meta=True)
    dispatch.note_tier("mamba2_ssd.bwd", tier)
    if tier == "torch":
        return ssd_bwd_plain(x, b, c, dt, a, d, s0, dy, ds)
    bb, s, h, hd = x.shape
    n = b.shape[-1]
    _check_cuda(hd, n)
    dev = x.device
    dx = torch.empty((bb, s, h, hd), dtype=torch.float32, device=dev)
    db, dc = (torch.zeros((bb, s, n), dtype=torch.float32, device=dev)
              for _ in range(2))
    ddt = torch.empty((bb, s, h), dtype=torch.float32, device=dev)
    da, dd = torch.zeros_like(a), torch.zeros_like(d)
    ds0 = torch.empty_like(s0)
    if not (bb and h):
        return dx, db, dc, ddt, da, dd, ds0
    route = route or bwd_variant(s, hd, n)
    kernels = BWD_KERNELS[route]
    strides = (x.stride(0), x.stride(1), b.stride(0), b.stride(1),
               c.stride(0), c.stride(1), dt.stride(0), dt.stride(1))
    inputs = tuple(t.data_ptr() for t in (x, b, c, dt, a, d, s0, dy, ds))
    if route == "tc":
        chunks, groups = -(-s // TC_CHUNK), -(-h // BWD_HEADS)
        # each chunk's own state and dS part, then S_in and dS_out
        # (B, H, chunks, N, hd); e^{cum_last} (B, H, chunks); each head
        # group's parts of db and dc (groups, B, S, N); each (b, chunk,
        # h)'s of da and dd (2, B chunks, H)
        s_in, ds_out = (torch.empty(bb * h * chunks * n * hd,
                                    dtype=torch.float32, device=dev)
                        for _ in range(2))
        elast = torch.empty(bb * h * chunks, dtype=torch.float32, device=dev)
        db_part, dc_part = (torch.empty(groups * bb * s * n,
                                        dtype=torch.float32, device=dev)
                            for _ in range(2))
        scal_part = torch.empty(2 * bb * chunks * h, dtype=torch.float32,
                                device=dev)
        ptrs = inputs + tuple(t.data_ptr() for t in (
            dx, ddt, ds0, s_in, ds_out, elast, db_part, dc_part, scal_part,
            db, dc, da, dd))
        for which, kernel in enumerate(kernels):
            _build.launch(kernel, "rt_ssd_bwd_tc", dev, *ptrs, bb, s, h, hd,
                          n, *strides, which, variant=route)
        return dx, db, dc, ddt, da, dd, ds0
    # db's and dc's part of each head, (B, S, H, N); da's and dd's of each
    # (b, h)
    db_part, dc_part = (torch.empty((bb, s, h, n), dtype=torch.float32,
                                    device=dev) for _ in range(2))
    scal_part = torch.empty((2, bb, h), dtype=torch.float32, device=dev)
    chunks = -(-s // BWD_CHUNK)
    marks = torch.empty(bb * h * max(chunks, 1) * n * hd,
                        dtype=torch.float32, device=dev)
    hist = torch.empty(bb * h * BWD_CHUNK * n * hd, dtype=torch.float32,
                       device=dev)
    scan, total = kernels
    _build.launch(scan, "rt_ssd_bwd", dev, *inputs,
                  *(t.data_ptr() for t in (dx, ddt, ds0, db_part, dc_part,
                                           scal_part, marks, hist)),
                  bb, s, h, hd, n, *strides, variant=route)
    _build.launch(total, "rt_ssd_bwd_sum", dev, db_part.data_ptr(),
                  dc_part.data_ptr(), scal_part.data_ptr(), db.data_ptr(),
                  dc.data_ptr(), da.data_ptr(), dd.data_ptr(), bb, s, h, n,
                  variant=route)
    return dx, db, dc, ddt, da, dd, ds0
