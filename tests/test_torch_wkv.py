"""repro_torch.kernels.rwkv6_wkv against the reference on the CPU.

The port's plain version (what a CPU tensor runs, and what the CUDA kernel
is held against on the card) against the reference's sequential
``ref.wkv`` and its Pallas kernel in interpret mode, in float32 on the same
numpy inputs. Tolerance 1e-4 of max |y| (and of max |state| for the final
state): the plain version forms u·k before the outer product with v, and
the Pallas kernel closes each chunk into matrix products over exponentials
of cumulative log-decays, so the three round differently; the reference's
own kernel test allows 1e-3 absolute. The strong-decay case keeps that
test's 1e-2 against the Pallas kernel, whose segment exponentials lose
digits there.

The card's tc kernel computes the same function in chunks of 64 steps,
sub-chunks of 16, every decay a product of w's, every matrix product as
three TF32 tensor-core products; :func:`_chunked` emulates that arithmetic
(operands rounded to TF32, exact products, float32 sums) so the tests
below can show, without a card, that three terms hold the 1e-5 contract
the card tests keep and one term does not, and how the chunked form and
the float32 recurrence each drift from a float64 recurrence over 2048
steps of w near 1.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6_wkv import kernel as rkernel
from repro.kernels.rwkv6_wkv import ref as rref
from repro_torch.kernels import _build
from repro_torch.kernels.rwkv6_wkv import ops as W
from repro_torch.obs import metrics as obs_metrics

TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _exp_initialised():
    """torch's CPU ``exp`` (2.13, AVX-512 build) now and then returns
    values about 1e-4 off on its first multi-threaded call in a process
    (7 of 64 fresh processes); one call on a single element first makes
    every later call accurate to float32 rounding."""
    torch.exp(torch.zeros(1))


def _inputs(b, s, h, hd, *, seed=0, s0_scale=0.0, decay_shift=-2.0,
            k_scale=0.5, u_scale=0.1):
    """r, k, v, w, u, s0 as numpy float32, drawn as the reference's kernel
    tests draw them: w = exp(-exp(N(0, 1) + decay_shift))."""
    rng = np.random.default_rng(seed)
    shape = (b, s, h, hd)
    r = rng.normal(size=shape)
    k = rng.normal(size=shape) * k_scale
    v = rng.normal(size=shape)
    w = np.exp(-np.exp(rng.normal(size=shape) + decay_shift))
    u = rng.normal(size=(h, hd)) * u_scale
    s0 = rng.normal(size=(b, h, hd, hd)) * s0_scale
    return tuple(a.astype(np.float32) for a in (r, k, v, w, u, s0))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _plain(args):
    y, st = W.wkv_plain(*map(torch.from_numpy, args))
    return y.numpy(), st.numpy()


# (B, S, H, hd, Pallas chunk, s0 scale): the reference's kernel-test shapes
# and chunks, S = 1 (one chunk of one step, a decode step) and a nonzero s0
CASES = [
    (2, 32, 2, 16, 8, 0.0),
    (1, 64, 4, 32, 16, 0.0),
    (2, 128, 1, 64, 64, 0.0),
    (3, 1, 2, 32, 1, 0.0),
    (2, 48, 3, 16, 16, 0.1),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_plain_matches_reference_scan_and_pallas_interpret(case):
    b, s, h, hd, chunk, s0_scale = case
    args = _inputs(b, s, h, hd, s0_scale=s0_scale)
    y, st = _plain(args)
    ry, rst = rref.wkv(*map(jnp.asarray, args))
    py, pst = rkernel.wkv_pallas(*map(jnp.asarray, args), chunk=chunk,
                                 interpret=True)
    errs = {"scan y": _rel(y, ry), "scan state": _rel(st, rst),
            "pallas y": _rel(y, py), "pallas state": _rel(st, pst)}
    print({k: f"{v:.2e}" for k, v in errs.items()})
    assert max(errs.values()) <= TOL, errs


@pytest.mark.parametrize("s", [1, 63, 100])
def test_plain_matches_reference_scan_at_ragged_lengths(s):
    """S off any chunk (the Pallas kernel needs S % chunk == 0, so the
    sequential scan is the oracle here)."""
    args = _inputs(2, s, 2, 16, seed=s, s0_scale=0.2)
    y, st = _plain(args)
    ry, rst = rref.wkv(*map(jnp.asarray, args))
    assert _rel(y, ry) <= TOL and _rel(st, rst) <= TOL


def test_strong_decay_stays_finite():
    """w as small as 0.03, as in the reference's overflow test: the plain
    version has no exponentials to overflow and matches the scan within
    TOL; the Pallas kernel within that test's 1e-2."""
    args = _inputs(1, 64, 2, 16, seed=3, decay_shift=0.2, k_scale=1.0,
                   u_scale=1.0)
    assert float(args[3].min()) < 0.05
    y, _ = _plain(args)
    assert np.isfinite(y).all()
    ry, _ = rref.wkv(*map(jnp.asarray, args))
    py, _ = rkernel.wkv_pallas(*map(jnp.asarray, args), chunk=32,
                               interpret=True)
    assert _rel(y, ry) <= TOL
    np.testing.assert_allclose(y, np.asarray(py), atol=1e-2)


def test_zero_decay_forgets_the_past_exactly():
    """w = 0: each step's state is k_t v_t^T alone, whatever came before."""
    r, k, v, w, u, s0 = _inputs(1, 6, 2, 16, seed=4, s0_scale=1.0)
    w[:, 3] = 0.0
    y, st = W.wkv_plain(*map(torch.from_numpy, (r, k, v, w, u, s0)))
    tail = (r[:, 4:], k[:, 4:], v[:, 4:], w[:, 4:], u)
    kv3 = k[:, 3, :, :, None] * v[:, 3, :, None, :]
    y2, st2 = W.wkv_plain(*map(torch.from_numpy, tail + (kv3,)))
    assert torch.equal(st, st2)
    assert torch.allclose(y[:, 4:], y2, rtol=1e-6, atol=0)


def test_cpu_tensor_runs_the_plain_version_and_counts_it():
    args = tuple(map(torch.from_numpy, _inputs(2, 9, 2, 16, s0_scale=0.1)))
    reg = obs_metrics.MetricsRegistry()
    before = obs_metrics.ambient()
    obs_metrics.set_ambient(reg)
    _build.reset_launches()
    try:
        got = W.wkv(*args)
        W.wkv(*args)
    finally:
        obs_metrics.set_ambient(before)
    want = W.wkv_plain(*args)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert not _build.launches
    snap = reg.snapshot()["counters"]
    assert snap.get("kernels.dispatch.wkv.torch") == 2
    assert "kernels.dispatch.wkv.cuda" not in snap


def test_cpu_tier_computes_head_sizes_the_kernels_are_not_built_for():
    """hd 24, outside ``HEAD_DIMS``: the reference's WKV computes it, so the
    port's CPU tier does too (a CUDA call raises: tests/test_torch_cuda.py),
    held against ``ref.wkv`` at TOL."""
    assert 24 not in W.HEAD_DIMS
    args = _inputs(1, 20, 2, 24, seed=9, s0_scale=0.3)
    y, st = W.wkv(*map(torch.from_numpy, args))
    ry, rst = rref.wkv(*map(jnp.asarray, args))
    assert _rel(y.numpy(), ry) <= TOL and _rel(st.numpy(), rst) <= TOL


@pytest.mark.parametrize("bad, match", [
    (dict(dtype=torch.float64), "float32"),
    (dict(u_shape=(3, 16)), "u: shape"),
    (dict(s0_shape=(1, 2, 16, 8)), "s0: shape"),
    (dict(strided=True), "contiguous"),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad, match):
    hd = bad.get("hd", 16)
    dt = bad.get("dtype", torch.float32)
    r = torch.zeros((1, 4, 2, hd), dtype=dt)
    u = torch.zeros(bad.get("u_shape", (2, hd)), dtype=dt)
    s0 = torch.zeros(bad.get("s0_shape", (1, 2, hd, hd)), dtype=dt)
    if bad.get("strided"):
        r = torch.zeros((1, 2, 4, hd)).transpose(1, 2)
    with pytest.raises((ValueError, TypeError), match=match):
        W.wkv(r, torch.zeros_like(r), torch.zeros_like(r),
              torch.zeros_like(r), u, s0)


@pytest.mark.parametrize("shape, tiles", [
    ((4, 40, 64), 1),          # rwkv6-3b at batch 4: 160 blocks, a wave
    ((1, 40, 64), 4),          # one sequence: 40 blocks -> 160
    ((1, 2, 64), 8),           # at most 8 tiles of 8 columns at hd 64
    ((1, 2, 16), 2),           # at most 2 tiles at hd 16
    ((2, 4, 128), 16),         # 8 blocks -> 128, tiles of 8 columns
])
def test_col_tiles_fill_a_wave_of_the_card(shape, tiles):
    b, h, hd = shape
    assert W.col_tiles(b, h, hd, n_sms=132) == tiles


# --------------------------------------------------------------------------- #
# the tc kernel's arithmetic
# --------------------------------------------------------------------------- #

EMU_TOL = 1e-5          # the card tests' limit, of max |y| and max |state|
SUB = 16                # steps per sub-chunk of the tc kernel


def _decay_inputs(s, *, b=1, h=2, hd=16, seed=0, decay="model", s0="zero"):
    """r, k, v ~ N(0, 1); w = exp(-exp(0.5 N(0, 1) - 2)) as the random
    model's decays (``model``), about 0.03 (``strong``), the model's with
    every third step 0 (``zero``) or within 1e-6 of 1 (``near1``); u =
    0.1 N(0, 1); s0 zero or N(0, 1). numpy float32, as the card tests draw
    them."""
    rng = np.random.default_rng(seed)
    shape = (b, s, h, hd)
    r, k, v, z = (rng.normal(size=shape) for _ in range(4))
    if decay == "strong":
        w = np.exp(-np.exp(0.5 * z + 1.25))
    elif decay == "near1":
        w = 1.0 - 1e-6 * rng.uniform(size=shape)
    else:
        w = np.exp(-np.exp(0.5 * z - 2.0))
    if decay == "zero":
        w[:, ::3] = 0.0
    u = 0.1 * rng.normal(size=(h, hd))
    st = (np.zeros((b, h, hd, hd)) if s0 == "zero"
          else rng.normal(size=(b, h, hd, hd)))
    return tuple(a.astype(np.float32) for a in (r, k, v, w, u, st))


def _tf32(v: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits, ties away from
    zero), as the kernel rounds: add 0x1000 to the bits, clear the low 13."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm(a: torch.Tensor, b: torch.Tensor, terms: int) -> torch.Tensor:
    """a @ b on the tensor cores' TF32: one term hi·hi, or three, hi·hi +
    hi·lo + lo·hi with hi = tf32(v), lo = tf32(v - hi). A product of two
    TF32 values is exact in float32; the sums are float32."""
    ahi, bhi = _tf32(a), _tf32(b)
    if terms == 1:
        return ahi @ bhi
    alo, blo = _tf32(a - ahi), _tf32(b - bhi)
    return alo @ bhi + ahi @ blo + ahi @ bhi


def _chunked(args, terms=3, chunk=W.TC_CHUNK):
    """The tc kernel's arithmetic in torch, per (b, h) and chunk of 64
    steps in four sub-chunks of 16 (rows past S: r = k = v = 0, w = 1):
    P and Q the prefix and suffix products of w within a sub-chunk, F its
    whole product; A's diagonal 16 x 16 blocks by running products from j
    (the bonus r_t·(k_t u) on the diagonal), its blocks (T, J < T) as
    (r_T ∘ P_T ∘ W_JT)(k_J ∘ Q_J)ᵀ, W_JT = Π_{J<K<T} F_K; y = (r ∘ P_ex) S +
    A V, S' = P_last ∘ S + (k ∘ Q)ᵀ V, with P_ex = P Π_{K<T} F_K, Q = Q
    Π_{K>T} F_K; every matrix product through :func:`_mm`. Returns numpy
    y, state."""
    r, k, v, w, u, st = map(torch.from_numpy, args)
    b, s, h, hd = r.shape
    nsub = chunk // SUB
    r, k, v, w = (x.permute(0, 2, 1, 3) for x in (r, k, v, w))  # (B,H,S,hd)
    y = torch.empty_like(r)
    for t0 in range(0, s, chunk):
        n = min(chunk, s - t0)

        def staged(x, fill):
            out = torch.full((b, h, chunk, hd), fill)
            out[:, :, :n] = x[:, :, t0:t0 + n]
            return out.view(b, h, nsub, SUB, hd)

        rc, kc, vc, wc = (staged(x, f) for x, f in
                          ((r, 0.0), (k, 0.0), (v, 0.0), (w, 1.0)))
        pre, suf = torch.ones_like(wc), torch.ones_like(wc)
        for i in range(1, SUB):
            pre[:, :, :, i] = pre[:, :, :, i - 1] * wc[:, :, :, i - 1]
        for i in range(SUB - 2, -1, -1):
            suf[:, :, :, i] = suf[:, :, :, i + 1] * wc[:, :, :, i + 1]
        f = pre[:, :, :, -1] * wc[:, :, :, -1]               # (B,H,nsub,hd)
        lft, rgt = rc * pre, kc * suf
        a = torch.zeros((b, h, chunk, chunk))
        idx = torch.arange(SUB)
        for tb in range(nsub):
            o = SUB * tb
            rr, kk = rc[:, :, tb], kc[:, :, tb]
            a[:, :, o + idx, o + idx] = (rr * (kk * u[:, None])).sum(-1)
            c = kk.clone()
            for d in range(1, SUB):
                js = idx[:SUB - d]
                a[:, :, o + js + d, o + js] = (rr[:, :, d:]
                                               * c[:, :, :SUB - d]).sum(-1)
                c[:, :, :SUB - d] = c[:, :, :SUB - d] * wc[:, :, tb, d:]
            for jb in range(tb):
                wf = torch.ones((b, h, hd))
                for kb in range(jb + 1, tb):
                    wf = wf * f[:, :, kb]
                a[:, :, o:o + SUB, SUB * jb:SUB * (jb + 1)] = _mm(
                    lft[:, :, tb] * wf[:, :, None],
                    rgt[:, :, jb].transpose(-1, -2), terms)
        gk, hk = torch.ones_like(f), torch.ones_like(f)
        for kb in range(1, nsub):
            gk[:, :, kb] = gk[:, :, kb - 1] * f[:, :, kb - 1]
        for kb in range(nsub - 2, -1, -1):
            hk[:, :, kb] = hk[:, :, kb + 1] * f[:, :, kb + 1]
        last = gk[:, :, -1] * f[:, :, -1]                     # (B, H, hd)
        rp = (lft * gk[:, :, :, None]).reshape(b, h, chunk, hd)
        kp = (rgt * hk[:, :, :, None]).reshape(b, h, chunk, hd)
        vv = vc.reshape(b, h, chunk, hd)
        yc = _mm(rp, st, terms) + _mm(a, vv, terms)
        st = last[..., None] * st + _mm(kp.transpose(-1, -2), vv, terms)
        y[:, :, t0:t0 + n] = yc[:, :, :n]
    return y.permute(0, 2, 1, 3).numpy(), st.numpy()


EMU_CASES = [(s, decay, s0) for s in (64, 300, 2049)
             for decay in ("model", "strong", "zero")
             for s0 in ("zero", "random")]


@pytest.mark.parametrize("s, decay, s0", EMU_CASES,
                         ids=lambda c: str(c))
def test_three_tf32_terms_hold_the_contract(s, decay, s0):
    """The tc kernel's arithmetic within 1e-5 of the plain version at one
    chunk, a ragged 300 and 2049 (33 chunks, the last of one step)."""
    args = _decay_inputs(s, seed=s, decay=decay, s0=s0)
    y, st = _plain(args)
    ey, est = _chunked(args, terms=3)
    errs = (_rel(ey, y), _rel(est, st))
    print(f"three terms: y {errs[0]:.1e}, state {errs[1]:.1e}")
    assert max(errs) <= EMU_TOL, errs


@pytest.mark.parametrize("s, decay, s0", EMU_CASES,
                         ids=lambda c: str(c))
def test_one_tf32_term_leaves_the_contract(s, decay, s0):
    """Why the kernel has no one-term mode: operands rounded once to TF32
    leave y or the state past 1e-5 in every case."""
    args = _decay_inputs(s, seed=s, decay=decay, s0=s0)
    y, st = _plain(args)
    ey, est = _chunked(args, terms=1)
    errs = (_rel(ey, y), _rel(est, st))
    print(f"one term: y {errs[0]:.1e}, state {errs[1]:.1e}")
    assert max(errs) > EMU_TOL, errs


def test_zero_decay_forgets_the_past_exactly_in_the_chunked_form():
    """w = 0 at step 5: every decay product across it is exactly 0, so y
    from step 6 on and the final state do not depend on anything before
    step 5, bit for bit, as in the recurrence: other r, k, v before step 5
    and another s0 give the same y[6:] and state."""
    r, k, v, w, u, s0 = _decay_inputs(100, seed=5, s0="random")
    w[:, 5] = 0.0
    y, st = _chunked((r, k, v, w, u, s0))
    other = _decay_inputs(100, seed=6, s0="random")
    r2, k2, v2 = (np.concatenate([o[:, :5], x[:, 5:]], 1)
                  for o, x in zip(other[:3], (r, k, v)))
    y2, st2 = _chunked((r2, k2, v2, w, u, other[5]))
    assert not np.array_equal(y[:, 5], y2[:, 5])
    assert np.array_equal(y[:, 6:], y2[:, 6:])
    assert np.array_equal(st, st2)


def _recurrence64(args):
    """The recurrence in float64, the witness of the long case."""
    r, k, v, w, u, st = (torch.from_numpy(a).double() for a in args)
    y = torch.empty_like(r)
    for t in range(r.shape[1]):
        vt = v[:, t, :, None, :]
        y[:, t] = torch.einsum("bhi,bhij->bhj", r[:, t],
                               (u * k[:, t])[:, :, :, None] * vt + st)
        st = w[:, t, :, :, None] * st + k[:, t, :, :, None] * vt
    return y.numpy(), st.numpy()


def _rel64(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_near_one_decay_over_2048_steps_against_float64(seed):
    """S = 2048, w within 1e-6 of 1, s0 random: the state barely decays and
    every step adds k vᵀ to it. The float32 recurrence rounds w S + k vᵀ
    2048 times and drifts 3.7e-6 to 7.1e-6 from a float64 recurrence; the
    chunked form takes 32 chunk sums and stays within about 3e-7 of it.
    Pinned as read: the chunked form within 1e-6 of float64, and nearer it
    than the float32 recurrence (itself inside the 1e-5 contract)."""
    args = _decay_inputs(2048, seed=seed, decay="near1", s0="random")
    fy, fst = _recurrence64(args)
    y, st = _plain(args)
    ey, est = _chunked(args, terms=3)
    chunked = max(_rel64(ey, fy), _rel64(est, fst))
    plain = max(_rel64(y, fy), _rel64(st, fst))
    print(f"vs float64: chunked {chunked:.2e}, plain {plain:.2e}")
    assert chunked <= 1e-6, chunked
    assert chunked < plain <= EMU_TOL, (chunked, plain)


def test_variant_routes_by_length_alone():
    """tc from one chunk (64 steps) up, at every hd; dec for one step;
    rec for the rest below."""
    for hd in W.HEAD_DIMS:
        assert [W.variant(s, hd) for s in (0, 2, 63)] == ["rec"] * 3
        assert W.variant(1, hd) == "dec"
        assert [W.variant(s, hd) for s in (64, 65, 2048)] == ["tc"] * 3
