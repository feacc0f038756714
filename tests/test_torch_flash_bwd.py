"""repro_torch's flash-attention backward against the reference on the CPU.

``flash_attention_bwd_plain`` (what a CPU tensor runs in the backward, and
what the three CUDA backward kernels are held against on the card) against
``jax.vjp`` of the reference's ``flash_attention`` (its ``custom_vjp``:
the Pallas forward in interpret mode, the chunked ``_bwd``) in float32 on
the same numpy inputs, within 1e-5 of each gradient's largest magnitude:
both take the same float32 sums in other orders. Then against torch
autograd through ``flash_attention_plain``, within 1e-4, as
``tests/test_kernels.py`` holds the reference's own backward. Then the op
as autograd sees it: a call that needs a gradient goes through
``_FlashAttention`` (the CPU tier's plain backward, counted), one that
does not builds no graph.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as rops
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops as FA
from repro_torch.obs import metrics as obs_metrics

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _exp_initialised():
    """torch's CPU ``exp`` (2.13, AVX-512 build) now and then returns
    values about 1e-4 off on its first multi-threaded call in a process
    (7 of 64 fresh processes); one call on a single element first makes
    every later call accurate to float32 rounding."""
    torch.exp(torch.zeros(1))


# (B, S, T, H, K, D, causal, q_offset, kv_valid_len): causal and not, GQA
# g = 1, 2, 4, q_offset > 0, kv_valid_len < T, S not a multiple of 128 (the
# plain backward's chunk), S = 1
CASES = [
    (2, 64, 64, 4, 2, 16, True, 0, None),
    (1, 64, 64, 4, 2, 32, False, 0, None),
    (2, 48, 48, 2, 2, 16, True, 0, None),
    (1, 40, 72, 4, 1, 16, False, 0, None),
    (1, 33, 70, 4, 4, 24, True, 37, None),
    (1, 200, 200, 2, 1, 16, True, 0, None),
    (1, 130, 150, 4, 2, 8, False, 0, 140),
    (2, 100, 120, 4, 1, 16, True, 20, 110),
    (2, 1, 96, 4, 2, 16, True, 70, 71),
]


def _ids(c):
    return "-".join(map(str, c))


def _inputs(case, seed=0):
    b, s, t, h, kh, d = case[:6]
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(np.float32)
                 for shape in ((b, s, h, d), (b, t, kh, d), (b, t, kh, d),
                               (b, s, h, d)))


def _kw(case):
    causal, off, valid = case[6:]
    return dict(causal=causal, q_offset=off, kv_valid_len=valid)


def _close(got, want, tol):
    """Each gradient within ``tol`` of its own largest magnitude."""
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        assert g.shape == w.shape, name
        err = float(np.abs(g - w).max())
        assert err <= tol * float(np.abs(w).max()), (name, err)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_plain_bwd_matches_reference_custom_vjp(case):
    q, k, v, do = _inputs(case)
    kw = _kw(case)
    o, vjp = jax.vjp(lambda q_, k_, v_: rops.flash_attention(
        q_, k_, v_, interpret=True, **kw), *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    got = FA.flash_attention_bwd_plain(
        *map(torch.from_numpy, (q, k, v, np.array(o), do)), **kw)
    assert all(x.dtype == torch.float32 for x in got)
    _close([x.numpy() for x in got], want, TOL)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_plain_bwd_matches_autograd_through_the_plain_forward(case):
    q, k, v, do = map(torch.from_numpy, _inputs(case, seed=1))
    kw = _kw(case)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    o = FA.flash_attention_plain(*leaves, **kw)
    o.backward(do)
    got = FA.flash_attention_bwd_plain(q, k, v, o.detach(), do, **kw)
    _close([x.numpy() for x in got], [x.grad.numpy() for x in leaves], 1e-4)


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float16], ids=str)
def test_plain_bwd_returns_the_inputs_dtype(dt):
    q, k, v, do = (torch.from_numpy(x).to(dt) for x in _inputs(CASES[0]))
    o = FA.flash_attention_plain(q, k, v)
    got = FA.flash_attention_bwd_plain(q, k, v, o, do)
    assert [x.dtype for x in got] == [dt] * 3
    want = FA.flash_attention_bwd_plain(*(x.float() for x in (q, k, v, o,
                                                               do)))
    for g, w in zip(got, want):
        assert torch.equal(g, w.to(dt))


def test_op_with_grad_runs_the_plain_backward_and_counts_it():
    case = CASES[4]
    q, k, v, do = map(torch.from_numpy, _inputs(case, seed=2))
    kw = _kw(case)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    reg = obs_metrics.MetricsRegistry()
    before = obs_metrics.ambient()
    obs_metrics.set_ambient(reg)
    _build.reset_launches()
    try:
        o = FA.flash_attention(*leaves, **kw)
        assert o.grad_fn is not None
        o.backward(do)
    finally:
        obs_metrics.set_ambient(before)
    assert not _build.launches
    snap = reg.snapshot()["counters"]
    assert snap.get("kernels.dispatch.flash_attention.fwd.torch") == 1
    assert snap.get("kernels.dispatch.flash_attention.bwd.torch") == 1
    assert "kernels.dispatch.flash_attention.bwd.cuda" not in snap
    want = FA.flash_attention_bwd_plain(q, k, v, o.detach(), do, **kw)
    for x, w in zip(leaves, want):
        assert torch.equal(x.grad, w)


def test_op_without_grad_builds_no_graph():
    q, k, v, _ = map(torch.from_numpy, _inputs(CASES[0]))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    with torch.no_grad():
        assert FA.flash_attention(*leaves).grad_fn is None
    assert FA.flash_attention(q, k, v).grad_fn is None
    assert FA.flash_attention(*leaves).grad_fn is not None


def test_only_the_inputs_that_require_grad_get_one():
    q, k, v, do = map(torch.from_numpy, _inputs(CASES[1]))
    kq = k.clone().requires_grad_()
    FA.flash_attention(q, kq, v, causal=False).backward(do)
    want = FA.flash_attention_bwd_plain(
        q, k, v, FA.flash_attention_plain(q, k, v, causal=False), do,
        causal=False)
    assert torch.equal(kq.grad, want[1])


def test_bwd_checks_o_and_do_against_q():
    q, k, v, do = map(torch.from_numpy, _inputs(CASES[0]))
    o = FA.flash_attention_plain(q, k, v)
    with pytest.raises(ValueError, match="do: expected q's shape"):
        FA.flash_attention_bwd(q, k, v, o, do[:, :5])
    with pytest.raises(ValueError, match="o: expected q's shape"):
        FA.flash_attention_bwd(q, k, v, o.double(), do)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_stats_plain_is_what_the_plain_backward_normalises_by(case):
    """``flash_attention_bwd_stats_plain`` (what the pre kernel is held
    against on the card): its m and l give the plain backward's
    probabilities, and D = rowsum(dO∘O), in the kernel's (B, K, S, g)
    layout."""
    q, k, v, do = map(torch.from_numpy, _inputs(case, seed=3))
    kw = _kw(case)
    b, s, t, h, kh, d = case[:6]
    g = h // kh
    o = FA.flash_attention_plain(q, k, v, **kw)
    m, l, dsum = FA.flash_attention_bwd_stats_plain(q, k, o, do, **kw)
    assert m.shape == l.shape == dsum.shape == (b, kh, s, g)
    qg = q.reshape(b, s, kh, g, d)
    scores = torch.einsum("bskgd,btkd->bksgt", qg, k) / np.sqrt(d)
    kpos = torch.arange(t)
    ok = torch.ones((s, t), dtype=torch.bool)
    if kw["causal"]:
        ok = (torch.arange(s)[:, None] + kw["q_offset"]) >= kpos[None, :]
    if kw["kv_valid_len"] is not None:
        ok = ok & (kpos < kw["kv_valid_len"])[None, :]
    scores = torch.where(ok[:, None, :], scores, torch.tensor(-1e30))
    p = torch.exp(scores - m[..., None]) / l[..., None]
    want = torch.softmax(scores, -1)
    assert float((p - want).abs().max()) <= 1e-6
    assert torch.allclose(dsum, (do * o).sum(-1).reshape(
        b, s, kh, g).permute(0, 2, 1, 3), atol=1e-5, rtol=0)
