"""The dec WKV kernel's decisions, settled on the CPU.

The dec kernel (``wkv_dec_kernel`` of ``repro_torch/csrc/rwkv6_wkv.cu``)
runs every CUDA call of one step: the decode steps. What the CPU can check
of it:

* the routing rule ``ops.variant``: "dec" for S = 1 at every compiled head
  size, "rec" for S = 0 and 2 to 63, "tc" from 64 up; rwkv6-3b's decode
  steps, and those of its reduced config, call the op with S = 1;
* the grid rule ``ops.dec_warps``: the kernel's warps, in the blocks the
  rule gives, cover every (b, h, state row, state column) exactly once and
  write every y column exactly once, and no SM is handed more than its
  share of blocks;
* the kernel's order of work, emulated in torch in float32: each lane's
  partial of y over its rows g R, g R + 1, ..., g R + R - 1 (R = hd / 8)
  in multiply-adds, then the xor tree over the row groups g; the state as
  ``fma(w, S, k v)``. Held to the card's own tolerance (1e-5 of the
  largest magnitude of y and of the state: ``tests/test_torch_cuda.py``
  ``_wkv_close``) against ``wkv_plain`` and against the reference's
  ``ref.wkv`` through JAX on the CPU, at each head size, with s0 zero and
  random, and at w = 0.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6_wkv import ref as rref
from repro_torch import configs
from repro_torch.kernels.rwkv6_wkv import ops as W

N_SMS = 132                     # the H100's SMs
GROUPS = 8                      # row groups of a warp (lane // 4)
TOL = 1e-5                      # the card tests' limit


@pytest.fixture(autouse=True, scope="module")
def _exp_initialised():
    """torch's CPU ``exp`` (2.13, AVX-512 build) now and then returns
    values about 1e-4 off on its first multi-threaded call in a process;
    one call on a single element first makes every later call accurate to
    float32 rounding."""
    torch.exp(torch.zeros(1))


# --------------------------------------------------------------------------- #
# the routing rule
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("hd", W.HEAD_DIMS)
def test_one_step_runs_dec_at_every_head_size(hd):
    assert W.variant(1, hd) == "dec"
    assert [W.variant(s, hd) for s in (0, *range(2, 64))] == ["rec"] * 63
    assert [W.variant(s, hd) for s in (64, 65, 2048)] == ["tc"] * 3


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_rwkv6_3b_decodes_on_dec_and_prefills_on_tc(reduced):
    cfg = configs.get("rwkv6-3b")
    if reduced:
        cfg = cfg.reduced()
    hd = cfg.rwkv_head_dim
    assert hd in W.HEAD_DIMS
    assert W.variant(1, hd) == "dec" and W.variant(2048, hd) == "tc"


def test_reduced_rwkv_decode_steps_call_the_op_with_one_step(monkeypatch):
    """The model's decode path hands the op S = 1 in every layer, so a CUDA
    decode step would run "dec" in every layer."""
    from repro_torch.models import lm

    cfg = dataclasses.replace(configs.get("rwkv6-3b").reduced(),
                              use_flash=True)
    seen = []
    wkv = W.wkv

    def spy(r, *args):
        seen.append(tuple(r.shape))
        return wkv(r, *args)

    monkeypatch.setattr(W, "wkv", spy)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 10)).astype(np.int32))
    model = lm.init_params(cfg, device="cpu")
    _, caches = lm.prefill_step(model, {"tokens": toks[:, :8]}, cfg)
    assert [s[1] for s in seen] == [8] * cfg.n_layers
    seen.clear()
    for pos in (8, 9):
        _, caches = lm.decode_step(model, caches, {"token": toks[:, pos],
                                                   "pos": pos}, cfg)
    assert len(seen) == 2 * cfg.n_layers
    assert {W.variant(s[1], s[3]) for s in seen} == {"dec"}


# --------------------------------------------------------------------------- #
# the grid rule
# --------------------------------------------------------------------------- #

def _dec_grid(b, h, hd, n_sms):
    """(blocks, warps per block, warps) of a dec launch, as the C entry
    point computes them from ``dec_warps``."""
    per = W.dec_warps(b, h, hd, n_sms)
    warps = b * h * (hd // W.DEC_COLS)
    return -(-warps // per), per, warps


def _dec_cover(b, h, hd, n_sms):
    """How many times the kernel's lanes read and write each state element
    (bh, i, j) and write each y element (bh, j): the kernel's index math,
    warp by warp."""
    blocks, per, warps = _dec_grid(b, h, hd, n_sms)
    tiles = hd // W.DEC_COLS
    state = np.zeros((b * h, hd, hd), np.int64)
    y = np.zeros((b * h, hd), np.int64)
    lane = np.arange(32)
    g, q = lane // 4, lane % 4
    nr = hd // GROUPS                        # rows of a lane
    rows = nr * g[:, None] + np.arange(nr)[None, :]
    for wid in range(blocks * per):          # block wid // per, warp wid % per
        if wid >= warps:
            continue                         # the kernel's early return
        bh, tile = divmod(wid, tiles)
        cols = tile * W.DEC_COLS + 4 * q[:, None] + np.arange(4)[None, :]
        for ln in lane:
            np.add.at(state[bh], (rows[ln][:, None], cols[ln][None, :]), 1)
            if g[ln] == 0:
                np.add.at(y[bh], cols[ln], 1)
    return state, y


@pytest.mark.parametrize("b, h, hd, n_sms", [
    (4, 40, 64, N_SMS),        # rwkv6-3b's decode step: 640 warps
    (1, 1, 16, N_SMS),         # one head, one warp
    (1, 3, 128, N_SMS),        # 24 warps: under a wave
    (33, 4, 128, N_SMS),       # 1056 warps: one full wave of 8-warp blocks
    (32, 40, 64, N_SMS),       # 5120 warps: five waves
    (3, 5, 32, 7),             # a small card
])
def test_dec_warps_cover_every_state_element_once(b, h, hd, n_sms):
    state, y = _dec_cover(b, h, hd, n_sms)
    assert (state == 1).all() and (y == 1).all()
    blocks, per, warps = _dec_grid(b, h, hd, n_sms)
    assert 1 <= per <= W.DEC_MAX_WARPS
    waves = -(-warps // (n_sms * W.DEC_MAX_WARPS))
    assert blocks <= n_sms * waves           # no SM over its share
    assert blocks * per - warps < per        # at most one partial block


@pytest.mark.parametrize("b, h, hd, want", [
    (4, 40, 64, 5),            # 640 warps: 128 blocks of 5
    (1, 40, 64, 2),            # 160 warps: 80 blocks of 2
    (1, 3, 128, 1),            # 24 warps: 24 blocks of 1
    (4, 40, 128, 5),           # 1280 warps: two waves, 256 blocks of 5
])
def test_dec_warps_at_known_shapes(b, h, hd, want):
    assert W.dec_warps(b, h, hd, N_SMS) == want


# --------------------------------------------------------------------------- #
# the order of work
# --------------------------------------------------------------------------- #

def _fma(a, b, c):
    """``fmaf`` in float32: the product of two float32 values is exact in
    float64, the sum rounds there and then to float32 (a double rounding
    that leaves ``fmaf`` by one float32 step at most, in rare ties)."""
    return (a.double() * b.double() + c.double()).float()


def _dec_emulated(r, k, v, w, u, s0):
    """The dec kernel's arithmetic on (B, 1, H, hd) inputs: lane (g, q)
    sums ``fma(r_i, fma(u_i k_i, v_j, S_ij), acc)`` over its rows
    i = g R, ..., g R + R - 1 (R = hd / 8) in that order; the shuffles add
    the row groups' partials over g's bits 0, 1, 2; the state is
    ``fma(w_i, S_ij, k_i v_j)``."""
    b, _, h, hd = r.shape
    rr, kk, vv, ww = (x[:, 0] for x in (r, k, v, w))
    uk = u * kk
    inner = _fma(uk[..., :, None], vv[..., None, :], s0)
    parts = []
    nr = hd // GROUPS                        # rows of a lane
    for g in range(GROUPS):
        acc = torch.zeros((b, h, hd))
        for i in range(g * nr, (g + 1) * nr):
            acc = _fma(rr[..., i, None], inner[..., i, :], acc)
        parts.append(acc)
    for bit in (1, 2, 4):                    # __shfl_xor_sync 4, 8, 16
        parts = [parts[g] + parts[g ^ bit] for g in range(GROUPS)]
    state = _fma(ww[..., :, None], s0, kk[..., :, None] * vv[..., None, :])
    return parts[0][:, None], state


def _inputs(b, h, hd, *, decay, s0_scale, seed):
    """r, k, v ~ N(0, 1), u = 0.1 N(0, 1) as ``rwkv6_init`` draws it, w =
    exp(-exp(0.5 N(0, 1) - 2)) as the random model's decays, about 0.03
    (strong) or 0; s0 N(0, 1) times ``s0_scale``; numpy float32."""
    rng = np.random.default_rng(seed)
    shape = (b, 1, h, hd)
    r, k, v, z = (rng.normal(size=shape) for _ in range(4))
    w = np.exp(-np.exp(0.5 * z + (1.25 if decay == "strong" else -2.0)))
    if decay == "zero":
        w = np.zeros(shape)
    u = 0.1 * rng.normal(size=(h, hd))
    s0 = s0_scale * rng.normal(size=(b, h, hd, hd))
    return tuple(a.astype(np.float32) for a in (r, k, v, w, u, s0))


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# (B, H, hd, decay, s0 scale): every head size with the model's decays and
# s0 random, rwkv6-3b's decode shape, s0 zero, w = 0, strong decay
DEC_CASES = [
    (2, 3, 16, "model", 0.5),
    (2, 3, 32, "model", 0.5),
    (4, 40, 64, "model", 0.5),
    (1, 2, 128, "model", 0.5),
    (3, 2, 64, "model", 0.0),
    (2, 2, 64, "zero", 0.5),
    (2, 2, 128, "zero", 1.0),
    (1, 3, 32, "strong", 0.5),
]


@pytest.mark.parametrize("case", DEC_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_dec_order_of_work_holds_the_card_tolerance(case):
    b, h, hd, decay, s0_scale = case
    args = tuple(map(torch.from_numpy, _inputs(
        b, h, hd, decay=decay, s0_scale=s0_scale, seed=hd + b)))
    got = _dec_emulated(*args)
    want = W.wkv_plain(*args)
    errs = [_rel(g, w_) for g, w_ in zip(got, want)]
    print(f"vs wkv_plain: y {errs[0]:.2e}, state {errs[1]:.2e}")
    assert max(errs) <= TOL, errs


@pytest.mark.parametrize("hd", W.HEAD_DIMS)
@pytest.mark.parametrize("decay, s0_scale", [
    ("model", 0.0), ("model", 1.0), ("zero", 1.0)])
def test_dec_order_of_work_matches_the_reference(hd, decay, s0_scale):
    args = _inputs(2, 3, hd, decay=decay, s0_scale=s0_scale, seed=hd)
    got = _dec_emulated(*map(torch.from_numpy, args))
    want = rref.wkv(*map(jnp.asarray, args))
    errs = [_rel(g, np.asarray(w_)) for g, w_ in zip(got, want)]
    print(f"vs ref.wkv: y {errs[0]:.2e}, state {errs[1]:.2e}")
    assert max(errs) <= TOL, errs


def test_dec_at_zero_decay_keeps_only_the_new_outer_product():
    """w = 0: the new state is k vᵀ in every element, s0 forgotten."""
    r, k, v, w, u, s0 = map(torch.from_numpy, _inputs(
        2, 3, 64, decay="zero", s0_scale=1.0, seed=11))
    _, state = _dec_emulated(r, k, v, w, u, s0)
    assert torch.equal(state, k[:, 0, :, :, None] * v[:, 0, :, None, :])
