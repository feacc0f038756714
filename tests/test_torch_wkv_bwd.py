"""The WKV gradient on the CPU: ``wkv_bwd_plain`` and the autograd path.

``rwkv6_wkv.ops.wkv_bwd_plain`` (what a CPU tensor runs, and what the CUDA
backward kernel is held against on the card) against ``jax.vjp`` of the
reference's sequential oracle ``ref.wkv`` and against torch autograd
through ``wkv_plain``, with cotangents on both y and the final state, in
float32 on the same numpy inputs: every gradient within 1e-5 of its own
largest magnitude (the same recurrence, its sums taken in other orders).

The card's kernel (``csrc/rwkv6_wkv_bwd.cu``) works in another order: a
forward sweep keeps the state before every ``BWD_CHUNK`` steps, each chunk
recomputes its states from there, eight lanes own a state row (row sums
by an xor tree), dv is summed down the warps' four rows and then over the
warps, and du is a part per (b, h) summed over b by a second kernel.
:func:`_emulated` repeats that order in torch, and is held within the
same 1e-5 the card test keeps; a variant with one planted fault each
falls outside it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6_wkv import ref as rref
from repro_torch.kernels import _build
from repro_torch.kernels.rwkv6_wkv import ops as W
from repro_torch.obs import metrics as obs_metrics

TOL = 1e-5
NAMES = ("dr", "dk", "dv", "dw", "du", "ds0")
LANES = 8          # lanes of a state row in the kernel
WARP_ROWS = 4      # state rows of a warp


@pytest.fixture(autouse=True, scope="module")
def _exp_initialised():
    """torch's CPU ``exp`` (2.13, AVX-512 build) now and then returns
    values about 1e-4 off on its first multi-threaded call in a process
    (7 of 64 fresh processes); one call on a single element first makes
    every later call accurate to float32 rounding."""
    torch.exp(torch.zeros(1))


def _inputs(b, s, h, hd, *, seed=0, decay="model", s0=True, ds=True):
    """r, k, v, w, u, s0, dy, ds as numpy float32: w = exp(-exp(N(0, 1) -
    2)) as the reference's kernel tests draw it (``model``), that with
    every third step 0 (``zero``), or within 1e-6 of 1 (``near1``)."""
    rng = np.random.default_rng(seed)
    shape = (b, s, h, hd)
    r, v, dy = (rng.normal(size=shape) for _ in range(3))
    k = rng.normal(size=shape) * 0.5
    if decay == "near1":
        w = 1.0 - rng.uniform(0.0, 1e-6, shape)
    else:
        w = np.exp(-np.exp(rng.normal(size=shape) - 2.0))
        if decay == "zero":
            w[:, ::3] = 0.0
    u = rng.normal(size=(h, hd)) * 0.1
    st = rng.normal(size=(b, h, hd, hd)) * (0.3 if s0 else 0.0)
    dst = rng.normal(size=(b, h, hd, hd)) * (1.0 if ds else 0.0)
    return tuple(a.astype(np.float32)
                 for a in (r, k, v, w, u, st, dy, dst))


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    if not want.size:
        return 0.0
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _errs(got, want) -> dict:
    return {n: _rel(g, w) for n, g, w in zip(NAMES, got, want)}


def _plain(args):
    return tuple(g.numpy() for g in W.wkv_bwd_plain(
        *map(torch.from_numpy, args)))


def _jax_vjp(args):
    """jax.vjp of the reference's ``ref.wkv`` with cotangents (dy, ds)."""
    ins = tuple(map(jnp.asarray, args[:6]))
    _, vjp = jax.vjp(rref.wkv, *ins)
    return tuple(np.asarray(g) for g in vjp((jnp.asarray(args[6]),
                                             jnp.asarray(args[7]))))


def _autograd(args):
    ins = [torch.from_numpy(a).requires_grad_() for a in args[:6]]
    y, st = W.wkv_plain(*ins)
    grads = torch.autograd.grad(
        (y * torch.from_numpy(args[6])).sum()
        + (st * torch.from_numpy(args[7])).sum(), ins, allow_unused=True)
    return tuple(np.zeros_like(a) if g is None else g.numpy()
                 for g, a in zip(grads, args))


# (B, S, H, hd, decay, s0, ds): S = 0, 1, a whole chunk, ragged (17, 40),
# hd 24 (the CPU tier's size, not compiled for the card), w = 0 every third
# step, w within 1e-6 of 1, s0 and ds zero and random
CASES = [
    (2, 0, 2, 16, "model", True, True),
    (2, 1, 3, 16, "model", True, True),
    (1, 16, 2, 16, "model", False, True),
    (2, 17, 2, 16, "zero", True, False),
    (1, 40, 2, 24, "model", True, True),
    (2, 33, 1, 32, "near1", True, True),
    (1, 50, 2, 8, "zero", False, False),
]


@pytest.mark.parametrize("case", CASES, ids=str)
def test_plain_bwd_matches_jax_vjp_of_the_reference(case):
    b, s, h, hd, decay, s0, ds = case
    args = _inputs(b, s, h, hd, seed=s + hd, decay=decay, s0=s0, ds=ds)
    errs = _errs(_plain(args), _jax_vjp(args))
    assert max(errs.values()) <= TOL, errs


@pytest.mark.parametrize("case", CASES, ids=str)
def test_plain_bwd_matches_autograd_of_wkv_plain(case):
    b, s, h, hd, decay, s0, ds = case
    args = _inputs(b, s, h, hd, seed=s + hd + 1, decay=decay, s0=s0, ds=ds)
    errs = _errs(_plain(args), _autograd(args))
    assert max(errs.values()) <= TOL, errs


def test_w_zero_cuts_the_gradient_of_the_past():
    """With w_t = 0 the state after step t forgets S_{t-1}, so the
    gradient of S_{t-1} is r_t dy_t^T alone: dr, dk, dv, dw before t and
    ds0 equal those of the sequence cut before t with that gradient of
    its final state, bit for bit."""
    r, k, v, w, u, s0, dy, ds = _inputs(1, 12, 2, 16, seed=4)
    w = w.copy()
    w[:, 6] = 0.0
    full = _plain((r, k, v, w, u, s0, dy, ds))
    cut = (r[:, 6, :, :, None] * dy[:, 6, :, None, :]).astype(np.float32)
    head = _plain((r[:, :6], k[:, :6], v[:, :6], w[:, :6], u, s0,
                   dy[:, :6], cut))
    for x, y in zip(full[:4], head[:4]):
        assert np.array_equal(x[:, :6], y)
    assert np.array_equal(full[5], head[5])


# --------------------------------------------------------------------------- #
# the kernel's order of work
# --------------------------------------------------------------------------- #

def _xor_tree(p):
    """The butterfly sum over the last axis (8 lanes: xor 1, 2, 4)."""
    idx = torch.arange(p.shape[-1])
    off = 1
    while off < p.shape[-1]:
        p = p + p[..., idx ^ off]
        off *= 2
    return p[..., 0]


def _lanes(x, hd):
    """(..., i, j) -> (..., i, lane g, m): lane g owns columns g + 8 m."""
    return x.reshape(*x.shape[:-1], hd // LANES, LANES).transpose(-1, -2)


def _emulated(r, k, v, w, u, s0, dy, ds, *, chunk=W.BWD_CHUNK, fault=None):
    """``rt_wkv_bwd`` and ``rt_wkv_bwd_sum``'s order of work in torch
    (float32, B and H at once): marks every ``chunk`` steps from a forward
    sweep, each chunk's states recomputed from its mark, the row sums of
    a row's eight lanes (each lane's columns g + 8 m in order, then the
    xor tree), dv as each warp's four rows by the tree then the warps in
    order after ``urk dy``, du a part per (b, h) over t from the last, then
    over b in order. ``fault``: ``"late mark"`` (each mark a step late),
    ``"warp part"`` (warp 0's dv part left out) or ``"batch part"`` (b 0's
    part of du left out)."""
    b, s, h, hd = r.shape
    warps = hd // WARP_ROWS
    lag = 1 if fault == "late mark" else 0

    def step(st, t):
        return (w[:, t, :, :, None] * st
                + k[:, t, :, :, None] * v[:, t, :, None, :])
    chunks = -(-s // chunk)
    marks, st = [], s0.clone()
    for c in range(chunks):
        t = c * chunk
        marks.append(step(st, t) if lag and t < s - 1 else st)
        if c < chunks - 1:
            for t in range(c * chunk, (c + 1) * chunk):
                st = step(st, t)
    g = ds.clone()
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du_part = torch.zeros((b, h, hd))
    for c in reversed(range(chunks)):
        lo, hi = c * chunk, min((c + 1) * chunk, s)
        hist = [marks[c]]
        for t in range(lo, hi - 1):
            hist.append(step(hist[-1], t))
        for t in reversed(range(lo, hi)):
            sp = hist[t - lo]
            rt, kt, vt, wt, dyt = (x[:, t] for x in (r, k, v, w, dy))
            vdy = (vt * dyt).sum(-1, keepdim=True)
            urk = (u * rt * kt).sum(-1, keepdim=True)
            dyj, vj = dyt[:, :, None, :], vt[:, :, None, :]
            pdr = _xor_tree(_lanes(sp * dyj, hd).sum(-1))
            pdk = _xor_tree(_lanes(g * vj, hd).sum(-1))
            pdw = _xor_tree(_lanes(g * sp, hd).sum(-1))
            dr[:, t] = u * kt * vdy + pdr
            dk[:, t] = u * rt * vdy + pdk
            dw[:, t] = pdw
            rows = (g * kt[..., None]).reshape(b, h, warps, WARP_ROWS, hd)
            part = (rows[:, :, :, 0] + rows[:, :, :, 1]) + (
                rows[:, :, :, 2] + rows[:, :, :, 3])
            acc = urk * dyt
            for p in range(warps):
                if not (fault == "warp part" and p == 0):
                    acc = acc + part[:, :, p]
            dv[:, t] = acc
            du_part += rt * kt * vdy
            g = wt[..., None] * g + rt[..., None] * dyj
    du = torch.zeros((h, hd))
    for bi in range(b):
        if not (fault == "batch part" and bi == 0):
            du = du + du_part[bi]
    return dr, dk, dv, dw, du, g


EMU_CASES = [
    (2, 40, 2, 16, "model"),
    (1, 33, 1, 32, "zero"),
    (2, 17, 3, 64, "model"),
    (3, 5, 2, 16, "near1"),
]


@pytest.mark.parametrize("case", EMU_CASES, ids=str)
def test_kernel_order_of_work_within_the_card_tolerance(case):
    b, s, h, hd, decay = case
    args = _inputs(b, s, h, hd, seed=s * hd, decay=decay)
    t = tuple(map(torch.from_numpy, args))
    errs = _errs([x.numpy() for x in _emulated(*t)], _plain(args))
    assert max(errs.values()) <= TOL, errs


@pytest.mark.parametrize("chunk", [1, 7, 16, 64])
def test_order_of_work_at_other_checkpoint_intervals(chunk):
    """The marks' interval changes nothing but the order of sums: one
    chunk (64), ragged chunks (7), a mark every step (1)."""
    args = _inputs(2, 40, 2, 16, seed=chunk, decay="zero")
    t = tuple(map(torch.from_numpy, args))
    errs = _errs([x.numpy() for x in _emulated(*t, chunk=chunk)],
                 _plain(args))
    assert max(errs.values()) <= TOL, errs


@pytest.mark.parametrize("fault", ["late mark", "warp part", "batch part"])
def test_a_planted_fault_in_the_order_of_work_leaves_the_tolerance(fault):
    args = _inputs(2, 40, 2, 16, seed=3, decay="model")
    t = tuple(map(torch.from_numpy, args))
    errs = _errs([x.numpy() for x in _emulated(*t, fault=fault)],
                 _plain(args))
    assert max(errs.values()) > 10 * TOL, errs


def test_the_emulation_marks_match_the_scratch_the_wrapper_allocates():
    """The marks the order of work takes (one per started chunk) and the
    chunk constant the kernel reads (``kChunk``) are the wrapper's."""
    src = (_build.CSRC / "rwkv6_wkv_bwd.cu").read_text()
    assert f"constexpr int kChunk = {W.BWD_CHUNK};" in src
    assert f"constexpr int kLanes = {LANES};" in src


# --------------------------------------------------------------------------- #
# the autograd Function on the CPU
# --------------------------------------------------------------------------- #

def test_wkv_needing_a_gradient_runs_the_function_and_the_plain_backward():
    args = _inputs(2, 20, 2, 16, seed=8)
    ins = [torch.from_numpy(a).requires_grad_() for a in args[:6]]
    reg = obs_metrics.MetricsRegistry()
    before = obs_metrics.ambient()
    obs_metrics.set_ambient(reg)
    _build.reset_launches()
    try:
        y, st = W.wkv(*ins)
        assert y.grad_fn is not None and st.grad_fn is not None
        assert type(y.grad_fn).__name__ == "_WKVBackward"
        grads = torch.autograd.grad(
            (y * torch.from_numpy(args[6])).sum()
            + (st * torch.from_numpy(args[7])).sum(), ins)
    finally:
        obs_metrics.set_ambient(before)
    assert not _build.launches
    snap = reg.snapshot()["counters"]
    assert snap.get("kernels.dispatch.wkv.torch") == 1
    assert snap.get("kernels.dispatch.wkv.bwd.torch") == 1
    errs = _errs([g.numpy() for g in grads], _plain(args))
    assert max(errs.values()) == 0.0, errs
    y0, _ = W.wkv_plain(*map(torch.from_numpy, args[:6]))
    assert torch.equal(y.detach(), y0)


def test_wkv_under_no_grad_builds_no_graph():
    ins = [torch.from_numpy(a).requires_grad_()
           for a in _inputs(1, 5, 2, 16)[:6]]
    with torch.no_grad():
        y, st = W.wkv(*ins)
    assert y.grad_fn is None and st.grad_fn is None
    y2, _ = W.wkv(*[x.detach() for x in ins])
    assert y2.grad_fn is None and torch.equal(y, y2)


def test_only_the_final_state_carries_a_gradient():
    """A loss on the final state alone: the Function receives a zero dy
    and still matches the reference's vjp with dy = 0."""
    args = _inputs(1, 9, 2, 16, seed=12, ds=True)
    ins = [torch.from_numpy(a).requires_grad_() for a in args[:6]]
    _, st = W.wkv(*ins)
    grads = torch.autograd.grad((st * torch.from_numpy(args[7])).sum(), ins)
    want = _jax_vjp(args[:6] + (np.zeros_like(args[6]), args[7]))
    errs = _errs([g.numpy() for g in grads], want)
    assert max(errs.values()) <= TOL, errs
