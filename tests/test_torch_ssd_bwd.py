"""The SSD gradient on the CPU: ``ssd_bwd_plain`` and the autograd path.

``mamba2_ssd.ops.ssd_bwd_plain`` (what a CPU tensor runs, and what the
CUDA backward kernel is held against on the card) against ``jax.vjp`` of
the reference's per-head sequential oracle ``ref.ssd`` (head by head, as
the reference's ``ops.ssd`` runs it) and against torch autograd through
``ssd_plain``, with cotangents on both y and the final state, in float32
on the same numpy inputs: every gradient within 1e-5 of its own largest
magnitude (the same recurrence, its sums taken in other orders).

The card's kernel (``csrc/mamba2_ssd_bwd.cu``) works in another order: a
forward sweep keeps the state before every ``BWD_CHUNK`` steps, each chunk
recomputes its states from there, eight lanes own a state row (row sums
by an xor tree), ``sum_n G b`` is summed down the warps' four rows and
then over the warps, ddt and da's part a step are sums over the rows
after the chunk, and a second kernel sums db and dc over the heads (each
block writes its head's part) and da and dd over b. :func:`_emulated`
repeats that order in torch, within the same 1e-5 the card test keeps;
a variant with one planted fault each falls outside it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba2_ssd import ref as rref
from repro_torch.kernels import _build
from repro_torch.kernels.mamba2_ssd import ops as SSD
from repro_torch.obs import metrics as obs_metrics

TOL = 1e-5
NAMES = ("dx", "db", "dc", "ddt", "da", "dd", "ds0")
LANES = 8          # lanes of a state row in the kernel
WARP_ROWS = 4      # state rows of a warp


@pytest.fixture(autouse=True, scope="module")
def _exp_initialised():
    """torch's CPU ``exp`` (2.13, AVX-512 build) now and then returns
    values about 1e-4 off on its first multi-threaded call in a process
    (7 of 64 fresh processes); one call on a single element first makes
    every later call accurate to float32 rounding."""
    torch.exp(torch.zeros(1))


def _inputs(b, s, h, hd, n, *, seed=0, dt="model", s0=True, ds=True):
    """x, b, c, dt, a, d, s0, dy, ds as numpy float32, drawn as
    ``tests/test_torch_ssd.py`` draws them: dt log-uniform in [1e-3, 1e-1]
    (``model``), about 1e-6 (``tiny``) or 5 to 20 (``huge``: e^{dt a}
    underflows to 0); a = -linspace(1, 16, H)."""
    rng = np.random.default_rng(seed)
    x, dy = (rng.normal(size=(b, s, h, hd)) for _ in range(2))
    bm, cm = (rng.normal(size=(b, s, n)) for _ in range(2))
    if dt == "model":
        dtv = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), (b, s, h)))
    elif dt == "tiny":
        dtv = 1e-6 * rng.uniform(0.5, 1.5, (b, s, h))
    else:
        dtv = rng.uniform(5.0, 20.0, (b, s, h))
    a = -np.linspace(1.0, 16.0, h)
    d = rng.normal(size=(h,))
    st = rng.normal(size=(b, h, n, hd)) * (1.0 if s0 else 0.0)
    dst = rng.normal(size=(b, h, n, hd)) * (1.0 if ds else 0.0)
    return tuple(v.astype(np.float32)
                 for v in (x, bm, cm, dtv, a, d, st, dy, dst))


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
    return tuple(g.numpy() for g in SSD.ssd_bwd_plain(
        *map(torch.from_numpy, args)))


def _ref_heads(x, b, c, dt, a, d, s0):
    """The reference's ``ref.ssd`` head by head, stacked."""
    outs = [rref.ssd(x[:, :, h], b, c, dt[:, :, h], a[h], d[h], s0[:, h])
            for h in range(x.shape[2])]
    return (jnp.stack([y for y, _ in outs], 2),
            jnp.stack([s for _, s in outs], 1))


def _jax_vjp(args):
    """jax.vjp of the heads of ``ref.ssd`` with cotangents (dy, ds)."""
    _, vjp = jax.vjp(_ref_heads, *map(jnp.asarray, args[:7]))
    return tuple(np.asarray(g) for g in vjp((jnp.asarray(args[7]),
                                             jnp.asarray(args[8]))))


def _autograd(args):
    ins = [torch.from_numpy(a).requires_grad_() for a in args[:7]]
    y, st = SSD.ssd_plain(*ins)
    grads = torch.autograd.grad(
        (y * torch.from_numpy(args[7])).sum()
        + (st * torch.from_numpy(args[8])).sum(), ins, allow_unused=True)
    return tuple(np.zeros_like(a) if g is None else g.numpy()
                 for g, a in zip(grads, args))


# (B, S, H, hd, N, dt, s0, ds): S = 0, 1, a whole chunk, ragged (17, 37),
# hd 24 and N 8 (the CPU tier's sizes), dt tiny and huge, s0 and ds zero
# and random
CASES = [
    (2, 0, 2, 16, 16, "model", True, True),
    (2, 1, 3, 16, 8, "model", True, True),
    (1, 16, 2, 16, 16, "tiny", False, True),
    (2, 17, 2, 24, 8, "huge", True, False),
    (1, 37, 3, 16, 16, "model", True, True),
    (2, 33, 2, 8, 32, "huge", False, False),
]


@pytest.mark.parametrize("case", CASES, ids=str)
def test_plain_bwd_matches_jax_vjp_of_the_reference(case):
    b, s, h, hd, n, dt, s0, ds = case
    args = _inputs(b, s, h, hd, n, seed=s + hd + n, dt=dt, s0=s0, ds=ds)
    errs = _errs(_plain(args), _jax_vjp(args))
    assert max(errs.values()) <= TOL, errs


@pytest.mark.parametrize("case", CASES, ids=str)
def test_plain_bwd_matches_autograd_of_ssd_plain(case):
    b, s, h, hd, n, dt, s0, ds = case
    args = _inputs(b, s, h, hd, n, seed=s + hd + n + 1, dt=dt, s0=s0, ds=ds)
    errs = _errs(_plain(args), _autograd(args))
    assert max(errs.values()) <= TOL, errs


def _strided(args, s, h, hd, n):
    """x, b, c and dt as the model passes them: views of one (B, S, W)
    conv output (x, b, c) and of a wider dt buffer, each (b, t) row
    contiguous, the batch and time strides those of the wider rows."""
    x, bm, cm, dtv = args[:4]
    bb = x.shape[0]
    conv = np.zeros((bb, s, h * hd + 2 * n + 5), np.float32)
    conv[..., :h * hd] = x.reshape(bb, s, h * hd)
    conv[..., h * hd:h * hd + n] = bm
    conv[..., h * hd + n:h * hd + 2 * n] = cm
    wide = np.zeros((bb, s, h + 3), np.float32)
    wide[..., 1:h + 1] = dtv
    ct, wt = torch.from_numpy(conv), torch.from_numpy(wide)
    views = (ct[..., :h * hd].reshape(bb, s, h, hd),
             ct[..., h * hd:h * hd + n], ct[..., h * hd + n:h * hd + 2 * n],
             wt[..., 1:h + 1])
    if s > 1:
        assert not views[0].is_contiguous() and not views[3].is_contiguous()
    return views + tuple(map(torch.from_numpy, args[4:]))


def test_strided_views_give_the_gradients_of_contiguous_inputs():
    """The model's strided views of x, b, c and dt: the plain backward and
    the Function give contiguous gradients in the inputs' shapes, equal
    to those of contiguous copies."""
    s, h, hd, n = 20, 2, 16, 8
    args = _inputs(2, s, h, hd, n, seed=21)
    views = _strided(args, s, h, hd, n)
    got = SSD.ssd_bwd(*views)
    want = _plain(args)
    for name, g, w in zip(NAMES, got, want):
        assert g.is_contiguous() and np.array_equal(g.numpy(), w), name
    ins = [v.clone().requires_grad_() if i >= 4 else
           v.detach().requires_grad_() for i, v in enumerate(views[:7])]
    y, st = SSD.ssd(*ins)
    grads = torch.autograd.grad((y * views[7]).sum() + (st * views[8]).sum(),
                                ins)
    for name, g, w in zip(NAMES, grads, want):
        assert g.shape == w.shape and np.array_equal(g.numpy(), w), name


# --------------------------------------------------------------------------- #
# the kernel's order of work
# --------------------------------------------------------------------------- #

def _xor_tree(p):
    """The butterfly sum over the last axis (xor 1, 2, 4, ...)."""
    idx = torch.arange(p.shape[-1])
    off = 1
    while off < p.shape[-1]:
        p = p + p[..., idx ^ off]
        off *= 2
    return p[..., 0]


def _lanes(x, hd):
    """(..., n, p) -> (..., n, lane g, m): lane g owns columns g + 8 m."""
    return x.reshape(*x.shape[:-1], hd // LANES, LANES).transpose(-1, -2)


def _warp_sum(x):
    """A sum over the last axis as one warp takes it: lane e the values
    e, e + 32, ... in order, then the xor tree over the 32 lanes."""
    n = x.shape[-1]
    pad = -(-n // 32) * 32 - n
    lanes = torch.nn.functional.pad(x, (0, pad)).reshape(
        *x.shape[:-1], -1, 32).sum(-2)
    return _xor_tree(lanes)


def _emulated(x, b, c, dt, a, d, s0, dy, ds, *, chunk=SSD.BWD_CHUNK,
              fault=None):
    """``rt_ssd_bwd`` and ``rt_ssd_bwd_sum``'s order of work in torch
    (float32, B and H at once): marks every ``chunk`` steps, each chunk's
    states recomputed from its mark, the row sums of a row's eight lanes
    by the xor tree, ``sum_n G b`` as each warp's four rows by the tree
    then the warps in order, ddt and da's part of a step as warp sums over
    the rows, da's and dd's parts per (b, h) over t from the last; then db
    and dc over the heads in order, da and dd over b in order. ``fault``:
    ``"no decay"`` (G not decayed), ``"head part"`` (head 0's part of db
    left out) or ``"dropped step"`` (the reverse step at S/2 skipped)."""
    bb, s, h, hd = x.shape
    n = b.shape[-1]
    warps = n // WARP_ROWS
    alpha_all = torch.exp(dt * a)                              # (B, S, H)

    def step(st, t):
        return (alpha_all[:, t, :, None, None] * st + b[:, t, None, :, None]
                * (dt[:, t, :, None] * x[:, t])[:, :, None, :])
    chunks = -(-s // chunk)
    marks, st = [], s0.clone()
    for ci in range(chunks):
        marks.append(st)
        if ci < chunks - 1:
            for t in range(ci * chunk, (ci + 1) * chunk):
                st = step(st, t)
    g = ds.clone()
    dx = torch.empty_like(x)
    ddt = torch.empty_like(dt)
    db_part, dc_part = (torch.empty((bb, s, h, n)) for _ in range(2))
    da_part, dd_part = torch.zeros((bb, h)), torch.zeros((bb, h))
    for ci in reversed(range(chunks)):
        lo, hi = ci * chunk, min((ci + 1) * chunk, s)
        hist = [marks[ci]]
        for t in range(lo, hi - 1):
            hist.append(step(hist[-1], t))
        for t in reversed(range(lo, hi)):
            if fault == "dropped step" and t == s // 2:
                dx[:, t] = 0.0
                ddt[:, t] = 0.0
                db_part[:, t] = 0.0
                dc_part[:, t] = 0.0
                continue
            sp = hist[t - lo]
            xt, dyt, dtt, alpha = x[:, t], dy[:, t], dt[:, t], alpha_all[:, t]
            xp, dyp = xt[:, :, None, :], dyt[:, :, None, :]
            g = g + c[:, t, None, :, None] * dyp
            sn = step(sp, t)
            dc_part[:, t] = _xor_tree(_lanes(sn * dyp, hd).sum(-1))
            q = _xor_tree(_lanes(g * xp, hd).sum(-1))           # (B, H, N)
            sg = _xor_tree(_lanes(sp * g, hd).sum(-1))
            rows = (g * b[:, t, None, :, None]).reshape(bb, h, warps,
                                                        WARP_ROWS, hd)
            part = (rows[:, :, :, 0] + rows[:, :, :, 1]) + (
                rows[:, :, :, 2] + rows[:, :, :, 3])
            gb = torch.zeros((bb, h, hd))
            for p in range(warps):
                gb = gb + part[:, :, p]
            dx[:, t] = d[:, None] * dyt + dtt[..., None] * gb
            asg = alpha * _warp_sum(sg)
            ddt[:, t] = _warp_sum(b[:, t, None, :] * q) + a * asg
            db_part[:, t] = dtt[..., None] * q
            da_part += dtt * asg
            dd_part += _warp_sum(xt * dyt)
            if fault != "no decay":
                g = alpha[:, :, None, None] * g
    db, dc = torch.zeros((bb, s, n)), torch.zeros((bb, s, n))
    for hh in range(h):
        if not (fault == "head part" and hh == 0):
            db = db + db_part[:, :, hh]
        dc = dc + dc_part[:, :, hh]
    da, dd = torch.zeros(h), torch.zeros(h)
    for bi in range(bb):
        da = da + da_part[bi]
        dd = dd + dd_part[bi]
    return dx, db, dc, ddt, da, dd, g


EMU_CASES = [
    (2, 40, 3, 16, 16, "model"),
    (1, 33, 2, 32, 16, "tiny"),
    (2, 17, 2, 16, 64, "huge"),
    (3, 5, 4, 64, 16, "model"),
]


@pytest.mark.parametrize("case", EMU_CASES, ids=str)
def test_kernel_order_of_work_within_the_card_tolerance(case):
    b, s, h, hd, n, dt = case
    args = _inputs(b, s, h, hd, n, seed=s * hd + n, dt=dt)
    t = tuple(map(torch.from_numpy, args))
    errs = _errs([v.numpy() for v in _emulated(*t)], _plain(args))
    assert max(errs.values()) <= TOL, errs


@pytest.mark.parametrize("chunk", [1, 7, 64])
def test_order_of_work_at_other_checkpoint_intervals(chunk):
    args = _inputs(2, 40, 2, 16, 16, seed=chunk, dt="huge")
    t = tuple(map(torch.from_numpy, args))
    errs = _errs([v.numpy() for v in _emulated(*t, chunk=chunk)],
                 _plain(args))
    assert max(errs.values()) <= TOL, errs


@pytest.mark.parametrize("fault", ["no decay", "head part", "dropped step"])
def test_a_planted_fault_in_the_order_of_work_leaves_the_tolerance(fault):
    args = _inputs(2, 40, 3, 16, 16, seed=3, dt="model")
    t = tuple(map(torch.from_numpy, args))
    errs = _errs([v.numpy() for v in _emulated(*t, fault=fault)],
                 _plain(args))
    assert max(errs.values()) > 10 * TOL, errs


def test_the_emulation_constants_are_the_kernel_s():
    src = (_build.CSRC / "mamba2_ssd_bwd.cu").read_text()
    assert f"constexpr int kChunk = {SSD.BWD_CHUNK};" in src
    assert f"constexpr int kLanes = {LANES};" in src


# --------------------------------------------------------------------------- #
# the autograd Function on the CPU
# --------------------------------------------------------------------------- #

def test_ssd_needing_a_gradient_runs_the_function_and_the_plain_backward():
    args = _inputs(2, 20, 2, 16, 8, seed=8)
    ins = [torch.from_numpy(v).requires_grad_() for v in args[:7]]
    reg = obs_metrics.MetricsRegistry()
    before = obs_metrics.ambient()
    obs_metrics.set_ambient(reg)
    _build.reset_launches()
    try:
        y, st = SSD.ssd(*ins)
        assert y.grad_fn is not None and st.grad_fn is not None
        assert type(y.grad_fn).__name__ == "_SSDBackward"
        grads = torch.autograd.grad(
            (y * torch.from_numpy(args[7])).sum()
            + (st * torch.from_numpy(args[8])).sum(), ins)
    finally:
        obs_metrics.set_ambient(before)
    assert not _build.launches
    snap = reg.snapshot()["counters"]
    assert snap.get("kernels.dispatch.mamba2_ssd.torch") == 1
    assert snap.get("kernels.dispatch.mamba2_ssd.bwd.torch") == 1
    errs = _errs([g.numpy() for g in grads], _plain(args))
    assert max(errs.values()) == 0.0, errs


def test_ssd_with_state_out_and_a_gradient_raises():
    args = [torch.from_numpy(v) for v in _inputs(1, 4, 2, 16, 8)[:7]]
    args[4] = args[4].clone().requires_grad_()
    with pytest.raises(ValueError, match="state_out"):
        SSD.ssd(*args, state_out=torch.empty_like(args[6]))
    with torch.no_grad():                  # the decode step's form
        out = torch.empty_like(args[6])
        _, st = SSD.ssd(*args, state_out=out)
    assert st is out


def test_ssd_under_no_grad_builds_no_graph():
    ins = [torch.from_numpy(v).requires_grad_()
           for v in _inputs(1, 5, 2, 16, 8)[:7]]
    with torch.no_grad():
        y, st = SSD.ssd(*ins)
    assert y.grad_fn is None and st.grad_fn is None
