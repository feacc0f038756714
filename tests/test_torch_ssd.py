"""repro_torch.kernels.mamba2_ssd against the reference on the CPU.

The port's plain version (what a CPU tensor runs, and what the CUDA kernel
is held against on the card) against the reference's per-head sequential
``ref.ssd`` and its chunked Pallas kernel in interpret mode
(``ops.ssd(..., use_kernel=True, interpret=True)``), in float32 on the same
numpy inputs. Tolerance 1e-5 of max |y| (and of max |state| for the final
state): the same float32 recurrence, its products rounded in other places
(the plain version forms dt·x before the outer product with b; the Pallas
kernel closes each chunk into matrix products over exponentials of
cumulative decays).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba2_ssd import ops as rops
from repro.kernels.mamba2_ssd import ref as rref
from repro_torch.kernels import _build
from repro_torch.kernels.mamba2_ssd import ops as SSD
from repro_torch.obs import metrics as obs_metrics

TOL = 1e-5
B, H, HD, N = 2, 3, 16, 16


@pytest.fixture(autouse=True, scope="module")
def _exp_initialised():
    """torch's CPU ``exp`` (2.13, AVX-512 build) now and then returns
    values about 1e-4 off on its first multi-threaded call in a process
    (7 of 64 fresh processes); one call on a single element first makes
    every later call accurate to float32 rounding."""
    torch.exp(torch.zeros(1))


def _inputs(s, *, b=B, h=H, hd=HD, n=N, seed=0, dt="model", s0="zero"):
    """x, b, c, dt, a, d, s0 as numpy float32: x, b, c ~ N(0, 1); dt
    log-uniform in [1e-3, 1e-1] as ``mamba2_init`` sets it (``model``),
    about 1e-6 (``tiny``: the state barely moves) or 5 to 20 (``huge``:
    the decay e^{dt a} underflows to 0 and each step forgets the past);
    a = -linspace(1, 16, H) as ``mamba2_init``'s A_log gives it; d ~
    N(0, 1); s0 zero or N(0, 1)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, h, hd))
    bm = rng.normal(size=(b, s, n))
    cm = rng.normal(size=(b, s, n))
    if dt == "model":
        dtv = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), (b, s, h)))
    elif dt == "tiny":
        dtv = 1e-6 * rng.uniform(0.5, 1.5, (b, s, h))
    else:
        dtv = rng.uniform(5.0, 20.0, (b, s, h))
    a = -np.linspace(1.0, 16.0, h)
    d = rng.normal(size=(h,))
    st = (np.zeros((b, h, n, hd)) if s0 == "zero"
          else rng.normal(size=(b, h, n, hd)))
    return tuple(v.astype(np.float32) for v in (x, bm, cm, dtv, a, d, st))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _plain(args):
    y, st = SSD.ssd_plain(*map(torch.from_numpy, args))
    return y.numpy(), st.numpy()


def _reference_scan(args):
    """``ref.ssd`` head by head, as the reference's ops.ssd runs it."""
    y, st = rops.ssd(*map(jnp.asarray, args), use_kernel=False)
    return np.asarray(y), np.asarray(st)


@pytest.mark.parametrize("s0", ["zero", "random"])
@pytest.mark.parametrize("dt", ["model", "tiny", "huge"])
@pytest.mark.parametrize("s", [64, 128])
def test_plain_matches_reference_scan_and_pallas_interpret(s, dt, s0):
    args = _inputs(s, seed=s, dt=dt, s0=s0)
    y, st = _plain(args)
    ry, rst = _reference_scan(args)
    py, pst = rops.ssd(*map(jnp.asarray, args), use_kernel=True,
                       interpret=True, chunk=32)
    errs = {"scan y": _rel(y, ry), "scan state": _rel(st, rst),
            "pallas y": _rel(y, py), "pallas state": _rel(st, pst)}
    print({k: f"{v:.2e}" for k, v in errs.items()})
    assert max(errs.values()) <= TOL, errs


@pytest.mark.parametrize("s", [1, 37])
def test_plain_matches_reference_scan_at_one_step_and_ragged(s):
    """S = 1 (a decode step) and S off any chunk (the Pallas kernel needs
    S % chunk == 0, so the per-head scan is the oracle here)."""
    args = _inputs(s, seed=s, s0="random")
    y, st = _plain(args)
    ry, rst = _reference_scan(args)
    assert _rel(y, ry) <= TOL and _rel(st, rst) <= TOL


def test_reference_scan_is_ref_ssd_head_by_head():
    """The oracle above is the reference's per-head ``ref.ssd``."""
    args = _inputs(9, seed=5, s0="random")
    ry, rst = _reference_scan(args)
    x, bm, cm, dtv, a, d, st = map(jnp.asarray, args)
    for hi in range(H):
        y1, s1 = rref.ssd(x[:, :, hi], bm, cm, dtv[:, :, hi], a[hi], d[hi],
                          st[:, hi])
        assert np.array_equal(np.asarray(y1), ry[:, :, hi])
        assert np.array_equal(np.asarray(s1), rst[:, hi])


def test_zero_dt_keeps_the_state():
    """dt = 0: e^0 = 1 and no input, so the state stays s0 exactly and
    y_t = c_t·s0 + d x_t."""
    x, bm, cm, dtv, a, d, st = map(torch.from_numpy,
                                   _inputs(5, seed=6, s0="random"))
    dtv.zero_()
    y, final = SSD.ssd_plain(x, bm, cm, dtv, a, d, st)
    assert torch.equal(final, st)
    want = torch.einsum("btn,bhnp->bthp", cm, st) + d[:, None] * x
    assert torch.allclose(y, want, rtol=1e-6, atol=1e-6)


def test_no_steps_return_s0():
    args = tuple(map(torch.from_numpy, _inputs(0, s0="random")))
    y, st = SSD.ssd(*args)
    assert y.shape == (B, 0, H, HD) and torch.equal(st, args[-1])


def test_state_out_takes_the_final_state_in_place():
    """A decode step passes its cache as s0 and as ``state_out``."""
    args = tuple(map(torch.from_numpy, _inputs(1, seed=7, s0="random")))
    want_y, want_st = SSD.ssd_plain(*args)
    cache = args[-1].clone()
    y, st = SSD.ssd(*args[:-1], cache, state_out=cache)
    assert st is cache and torch.equal(cache, want_st)
    assert torch.equal(y, want_y)


def test_strided_batch_and_time_are_taken_as_they_are():
    """x, b, c and dt as views with free batch and time strides (the model
    passes its conv output's views); rows stay contiguous."""
    x, bm, cm, dtv, a, d, st = map(torch.from_numpy, _inputs(6, seed=8))
    want = SSD.ssd(x, bm, cm, dtv, a, d, st)
    xbc = torch.cat([x.reshape(B, 6, H * HD), bm, cm], -1)
    xbc = torch.stack([xbc, torch.zeros_like(xbc)], 1)[:, 0]    # batch
    xv, bv, cv = torch.split(xbc, [H * HD, N, N], -1)
    dtw = torch.stack([dtv, dtv], 2)[:, :, 0]                   # time
    assert not xv.is_contiguous() and not dtw.is_contiguous()
    got = SSD.ssd(xv.reshape(B, 6, H, HD), bv, cv, dtw, a, d, st)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_cpu_tensor_runs_the_plain_version_and_counts_it():
    args = tuple(map(torch.from_numpy, _inputs(9, s0="random")))
    reg = obs_metrics.MetricsRegistry()
    before = obs_metrics.ambient()
    obs_metrics.set_ambient(reg)
    _build.reset_launches()
    try:
        got = SSD.ssd(*args)
        SSD.ssd(*args)
    finally:
        obs_metrics.set_ambient(before)
    want = SSD.ssd_plain(*args)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert not _build.launches
    snap = reg.snapshot()["counters"]
    assert snap.get("kernels.dispatch.mamba2_ssd.torch") == 2
    assert "kernels.dispatch.mamba2_ssd.cuda" not in snap


@pytest.mark.parametrize("bad, match", [
    (dict(hd=24), "head_dim 24"),
    (dict(n=8), "state 8"),
    (dict(dtype=torch.float64), "float32"),
    (dict(a_shape=(4,)), "a: shape"),
    (dict(s0_shape=(2, 3, 16, 8)), "s0: shape"),
    (dict(b_shape=(2, 4)), r"b: expected \(B, S, N\)"),
    (dict(strided_row=True), "row of H \\* hd values"),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad, match):
    hd, n = bad.get("hd", 16), bad.get("n", 16)
    dt = bad.get("dtype", torch.float32)
    x = torch.zeros((2, 4, 3, hd), dtype=dt)
    if bad.get("strided_row"):
        x = torch.zeros((2, 4, hd, 3)).transpose(2, 3)
    bm = torch.zeros(bad.get("b_shape", (2, 4, n)))
    a = torch.zeros(bad.get("a_shape", (3,)))
    s0 = torch.zeros(bad.get("s0_shape", (2, 3, n, hd)))
    with pytest.raises((ValueError, TypeError), match=match):
        SSD.ssd(x, bm, torch.zeros((2, 4, n)), torch.zeros((2, 4, 3)), a,
                torch.zeros(3), s0)
