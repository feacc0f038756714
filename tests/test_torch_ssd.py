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

The card's tc kernel computes the same chunked form with every product as
three TF32 tensor-core products; :func:`_chunked_tf32` emulates that
arithmetic (operands rounded to TF32, exact products, float32 sums) so the
tests below can show, without a card, that three terms hold the 1e-5
contract the card tests keep and one term does not, and that over a long
tiny-dt sequence the chunked form stays nearer a float64 recurrence than
the float32 recurrence itself.
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
from tf32_emulation import mm as _mm

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


@pytest.mark.parametrize("hd, n", [(24, 16), (16, 8)], ids=lambda c: str(c))
def test_cpu_tier_computes_sizes_the_kernels_are_not_built_for(hd, n):
    """A head or state size outside ``SIZES``: the reference's SSD computes
    it, so the port's CPU tier does too (a CUDA call raises:
    tests/test_torch_cuda.py), held against the reference's scan at TOL."""
    assert hd not in SSD.SIZES or n not in SSD.SIZES
    args = _inputs(20, hd=hd, n=n, seed=hd + n, s0="random")
    y, st = SSD.ssd(*map(torch.from_numpy, args))
    ry, rst = _reference_scan(args)
    assert _rel(y.numpy(), ry) <= TOL and _rel(st.numpy(), rst) <= TOL


@pytest.mark.parametrize("bad, match", [
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


def _chunked_tf32(args, terms=3, chunk=SSD.TC_CHUNK):
    """The tc kernel's arithmetic in torch: per chunk of 64 steps (the last
    one ragged), cum = cumsum(dt a) restarted at the chunk; G = C Bᵀ;
    M = G ∘ tril(e^{cum_t - cum_j}) ∘ dt_j; y = M X + e^{cum_t} (C S) +
    d X; S' = e^{cum_last} S + Bᵀ (w ∘ X), w_j = e^{cum_last - cum_j} dt_j;
    every matrix product through :func:`_mm`. Returns numpy y, state."""
    x, bm, cm, dtv, a, d, st = map(torch.from_numpy, args)
    y = torch.empty_like(x)
    for t0 in range(0, x.shape[1], chunk):
        sl = slice(t0, t0 + chunk)
        xc, bc, cc, dc = x[:, sl], bm[:, sl], cm[:, sl], dtv[:, sl]
        n = xc.shape[1]
        cum = torch.cumsum(dc * a, 1)                        # (B, n, H)
        g = _mm(cc, bc.transpose(1, 2), terms)               # (B, t, j)
        low = torch.tril(torch.ones(n, n, dtype=torch.bool))[None, :, :, None]
        diff = torch.where(low, cum[:, :, None] - cum[:, None], 0.0)
        m = torch.where(low, g[..., None] * torch.exp(diff)
                        * dc[:, None], 0.0)                  # (B, t, j, H)
        xh = xc.permute(0, 2, 1, 3)                          # (B, H, j, p)
        yc = (_mm(cc[:, None], st, terms)
              * torch.exp(cum).permute(0, 2, 1)[..., None]
              + _mm(m.permute(0, 3, 1, 2), xh, terms)
              + d[None, :, None, None] * xh)
        y[:, sl] = yc.permute(0, 2, 1, 3)
        last = cum[:, -1]                                    # (B, H)
        w = torch.exp(last[:, None] - cum) * dc              # (B, n, H)
        st = (torch.exp(last)[..., None, None] * st
              + _mm(bc.transpose(1, 2)[:, None],
                    (w[..., None] * xc).permute(0, 2, 1, 3), terms))
    return y.numpy(), st.numpy()


def _recurrence64(args):
    """The recurrence in float64, the witness of the long case."""
    x, bm, cm, dtv, a, d, st = (torch.from_numpy(v).double() for v in args)
    y = torch.empty_like(x)
    for t in range(x.shape[1]):
        st = (torch.exp(dtv[:, t] * a)[:, :, None, None] * st
              + bm[:, t, None, :, None]
              * (dtv[:, t, :, None] * x[:, t])[:, :, None, :])
        y[:, t] = (torch.einsum("bn,bhnp->bhp", cm[:, t], st)
                   + d[:, None] * x[:, t])
    return y.numpy(), st.numpy()


def _rel64(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("s0", ["zero", "random"])
@pytest.mark.parametrize("dt", ["model", "tiny", "huge"])
@pytest.mark.parametrize("s", [64, 300])
def test_three_tf32_terms_hold_the_contract(s, dt, s0):
    """The tc kernel's arithmetic within 1e-5 of the plain version, one
    chunk and a ragged 300 (no longer: past about 512 steps at tiny dt the
    plain version's own drift is what the comparison reads)."""
    args = _inputs(s, seed=s, dt=dt, s0=s0)
    y, st = _plain(args)
    ey, est = _chunked_tf32(args, terms=3)
    errs = (_rel(ey, y), _rel(est, st))
    print(f"three terms: y {errs[0]:.1e}, state {errs[1]:.1e}")
    assert max(errs) <= TOL, errs


@pytest.mark.parametrize("s0", ["zero", "random"])
@pytest.mark.parametrize("dt", ["model", "tiny", "huge"])
@pytest.mark.parametrize("s", [64, 300])
def test_one_tf32_term_leaves_the_contract(s, dt, s0):
    """Why the kernel has no one-term mode: operands rounded once to TF32
    leave y or the state past 1e-5 in every case."""
    args = _inputs(s, seed=s, dt=dt, s0=s0)
    y, st = _plain(args)
    ey, est = _chunked_tf32(args, terms=1)
    errs = (_rel(ey, y), _rel(est, st))
    print(f"one term: y {errs[0]:.1e}, state {errs[1]:.1e}")
    assert max(errs) > TOL, errs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_three_tf32_terms_stay_near_float64_where_the_recurrence_drifts(
        seed):
    """S = 2048, dt about 1e-6, s0 random: the float32 recurrence rounds
    e^{dt a}, a hair under 1, 2048 times and drifts past 1e-5 of a float64
    recurrence; the chunked form multiplies by e^{cum} once per chunk and
    stays within 2e-6 of it. So the card holds the tc kernel to float64
    in this case, not to the plain version."""
    args = _inputs(2048, b=1, h=2, seed=seed, dt="tiny", s0="random")
    fy, fst = _recurrence64(args)
    y, st = _plain(args)
    ey, est = _chunked_tf32(args, terms=3)
    chunked = (_rel64(ey, fy), _rel64(est, fst))
    plain = (_rel64(y, fy), _rel64(st, fst))
    print(f"vs float64: chunked {chunked}, plain {plain}")
    assert max(chunked) <= 2e-6, chunked
    assert max(plain) > 1e-5, plain


def test_variant_routes_by_length_alone():
    """tc from one chunk (64 steps) up, at every hd and N; rec below."""
    for hd in SSD.SIZES:
        for n in SSD.SIZES:
            assert [SSD.variant(s, hd, n) for s in (0, 1, 63)] == ["rec"] * 3
            assert [SSD.variant(s, hd, n)
                    for s in (64, 65, 2048)] == ["tc"] * 3
