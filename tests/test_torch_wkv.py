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


@pytest.mark.parametrize("bad, match", [
    (dict(hd=24), "head_dim 24"),
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
