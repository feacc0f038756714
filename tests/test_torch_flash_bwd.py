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

Then the CUDA side's decisions the CPU can check: which backward design a
call runs (``ops.bwd_variant``, the forward's tc rule), and why the
tensor-core route carries P and dS as two bf16 terms: its arithmetic,
emulated in torch, stays within the card's elementwise limit against the
plain backward and the reference with two terms, and leaves it with one.
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


# --------------------------------------------------------------------------- #
# the CUDA routing rule and the tensor-core backward's arithmetic
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("dtype, s, g, d, want", [
    (torch.bfloat16, 4096, 2, 128, "tc"),        # qwen3-0.6b training
    (torch.bfloat16, 4096, 1, 80, "tc"),         # hubert-xlarge's encoder
    (torch.bfloat16, 32, 2, 64, "tc"),           # S * g = 64: one warpgroup
    (torch.bfloat16, 1, 64, 16, "tc"),           # one row, 64 heads a group
    (torch.bfloat16, 63, 1, 64, "scalar"),       # S * g = 63
    (torch.bfloat16, 1, 2, 128, "scalar"),       # a decode-sized call
    (torch.bfloat16, 512, 1, 144, "scalar"),     # wider than 128
    (torch.bfloat16, 512, 1, 256, "scalar"),
    (torch.bfloat16, 512, 1, 40, "scalar"),      # not a multiple of 16
    (torch.bfloat16, 512, 1, 8, "scalar"),
    (torch.float32, 4096, 2, 128, "scalar"),     # float32 training, check (f)
    (torch.float16, 4096, 2, 128, "scalar"),
    (torch.float32, 64, 1, 64, "scalar"),
])
def test_bwd_variant_is_a_rule_of_dtype_and_shape(dtype, s, g, d, want):
    assert FA.bwd_variant(dtype, s, g, d) == want


def test_bwd_variant_takes_the_forwards_tc_rule():
    """Where the forward runs its tc kernel, the backward runs the tc
    route, and nowhere else."""
    for dtype in (torch.bfloat16, torch.float32, torch.float16):
        for s, g in ((1, 1), (1, 64), (16, 4), (33, 2), (63, 1), (64, 1),
                     (4096, 2)):
            for d in range(8, 264, 8):
                fwd_tc = FA.variant(dtype, s, g, d) == "tc"
                assert (FA.bwd_variant(dtype, s, g, d) == "tc") == fwd_tc


def _terms(x, terms):
    """x as ``terms`` bfloat16 terms, each the rounding of what the earlier
    ones leave (bf16(x), bf16(x - bf16(x)), ...), as float32."""
    out, rest = [], x
    for _ in range(terms):
        term = rest.to(torch.bfloat16).float()
        out.append(term)
        rest = rest - term
    return out


def _tc_bwd_emulation(q, k, v, o, do, *, causal, q_offset, kv_valid_len,
                      terms):
    """The tc kernels' arithmetic in torch: S = Q·Kᵀ and dP = dO·Vᵀ from
    the bf16 operands summed in float32; m and l online over 64-key tiles
    (pre); D = rowsum(dO∘O); ``P = exp(s·scale - m) · (1 / max(l,
    1e-30))`` and ``dS = P∘(dP - D)`` in float32; then Pᵀ·dO, dSᵀ·Q and
    dS·K with P and dS carried as ``terms`` bf16 terms, each term's product
    summed in float32 into one accumulator; dK and dV summed over the
    group, dK and dQ scaled once, every output rounded to bf16."""
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    g = h // kh
    scale = 1.0 / d ** 0.5
    qf, of, dof = (x.float().permute(0, 2, 1, 3) for x in (q, o, do))
    kf, vf = (x.float().permute(0, 2, 1, 3).repeat_interleave(g, 1)
              for x in (k, v))                           # (B, H, T, D)
    kv_lim = t if kv_valid_len is None else min(kv_valid_len, t)
    kpos = torch.arange(t)[None, :]
    ok = kpos < kv_lim
    if causal:
        ok = ok & (kpos <= torch.arange(s)[:, None] + q_offset)
    x = torch.where(ok, (qf @ kf.transpose(-1, -2)) * scale,
                    torch.full((), FA.NEG_INF))
    m = torch.full((b, h, s, 1), FA.NEG_INF)
    l = torch.zeros((b, h, s, 1))
    for t0 in range(0, t, 64):
        tile = x[..., t0:t0 + 64]
        m_new = torch.maximum(m, tile.amax(-1, keepdim=True))
        l = l * torch.exp(m - m_new) + torch.exp(tile - m_new).sum(
            -1, keepdim=True)
        m = m_new
    drow = (dof * of).sum(-1, keepdim=True)
    p = torch.where(ok, torch.exp(x - m) * (1.0 / torch.clamp(l, min=1e-30)),
                    torch.zeros(()))
    ds = p * (dof @ vf.transpose(-1, -2) - drow)
    dv = sum(pt.transpose(-1, -2) @ dof for pt in _terms(p, terms))
    dk = sum(dt.transpose(-1, -2) @ qf for dt in _terms(ds, terms))
    dq = sum(dt @ kf for dt in _terms(ds, terms))

    def kv_out(x):                          # (B, H, T, D) -> (B, T, K, D)
        return x.reshape(b, kh, g, t, d).sum(2).permute(0, 2, 1, 3)
    return ((dq * scale).permute(0, 2, 1, 3).to(torch.bfloat16),
            (kv_out(dk) * scale).to(torch.bfloat16),
            kv_out(dv).to(torch.bfloat16))


# the card's elementwise limit (chip_smoke.py's check (k),
# tests/test_torch_cuda.py): |got - want| <= 2^-7·|want| + 2^-14·max|want|
# for bf16 outputs
BF16_REL, ABS_OF_MAX = 2.0 ** -7, 2.0 ** -14

# bf16 shapes the tc route takes: GQA 1, 2 and 8; D 16, 64, 80 and 128;
# q_offset > 0; kv_valid_len < T; non-causal; S and T off the 64-row tiles
# (B, S, T, H, K, D, causal, q_offset, kv_valid_len)
TC_BWD_CASES = [
    (2, 77, 77, 4, 2, 128, True, 0, None),
    (1, 130, 130, 4, 4, 64, True, 0, None),
    (1, 65, 100, 8, 1, 16, False, 0, 90),
    (2, 33, 70, 4, 2, 64, True, 37, None),
    (1, 100, 150, 6, 3, 80, True, 20, 110),
    (1, 200, 200, 2, 1, 128, False, 0, None),
    (1, 64, 64, 16, 2, 80, True, 0, None),
    (1, 150, 150, 2, 2, 16, True, 0, 140),
]


def _limit_share(got, want):
    """The largest share of its limit that an element's difference takes,
    over dq, dk and dv (above 1: outside the card's limit)."""
    worst = 0.0
    for x, y in zip(got, want):
        assert x.dtype == y.dtype == torch.bfloat16 and x.shape == y.shape
        y32 = y.float()
        diff = (x.float() - y32).abs()
        limit = BF16_REL * y32.abs() + ABS_OF_MAX * float(y32.abs().max())
        worst = max(worst, float((diff / limit).max()))
    return worst


def _tc_bwd_inputs(case):
    b, s, t, h, kh, d = case[:6]
    rng = np.random.default_rng(sum(case[:6]))
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape, np.float32))
                   .to(torch.bfloat16)
                   for shape in ((b, s, h, d), (b, t, kh, d), (b, t, kh, d),
                                 (b, s, h, d)))
    assert FA.bwd_variant(q.dtype, s, h // kh, d) == "tc"
    return q, k, v, do, _kw(case)


@pytest.mark.parametrize("case", TC_BWD_CASES, ids=_ids)
def test_two_bf16_terms_of_p_and_ds_hold_the_card_limit(case):
    """The tc route's arithmetic with P and dS as two bf16 terms, against
    ``flash_attention_bwd_plain`` on the same bf16 inputs: every element
    of dq, dk and dv within the card's limit."""
    q, k, v, do, kw = _tc_bwd_inputs(case)
    o = FA.flash_attention_plain(q, k, v, **kw)
    got = _tc_bwd_emulation(q, k, v, o, do, terms=2, **kw)
    want = FA.flash_attention_bwd_plain(q, k, v, o, do, **kw)
    assert _limit_share(got, want) <= 1.0


@pytest.mark.parametrize("case", TC_BWD_CASES[:4], ids=_ids)
def test_two_bf16_terms_hold_the_card_limit_against_the_reference(case):
    """The same arithmetic against the reference's ``custom_vjp`` (the
    Pallas forward in interpret mode, the chunked ``_bwd``) run through
    JAX on the CPU in bf16, from the same inputs and the reference's o."""
    q, k, v, do, kw = _tc_bwd_inputs(case)
    as_jnp = lambda x: jnp.asarray(x.float().numpy(), jnp.bfloat16)  # noqa
    o, vjp = jax.vjp(lambda q_, k_, v_: rops.flash_attention(
        q_, k_, v_, interpret=True, **kw), *map(as_jnp, (q, k, v)))
    want = [torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
            for x in vjp(as_jnp(do))]
    o = torch.from_numpy(np.asarray(o, np.float32)).to(torch.bfloat16)
    got = _tc_bwd_emulation(q, k, v, o, do, terms=2, **kw)
    assert _limit_share(got, want) <= 1.0


@pytest.mark.parametrize("case", TC_BWD_CASES, ids=_ids)
def test_one_bf16_term_of_p_and_ds_breaks_the_card_limit(case):
    """The witness for the second term: P and dS rounded once to bf16
    (2^-9 relative, as FlashAttention-2/3 do) move outputs past the card's
    limit on every shape, by several times (about 10 to 16 on these)."""
    q, k, v, do, kw = _tc_bwd_inputs(case)
    o = FA.flash_attention_plain(q, k, v, **kw)
    got = _tc_bwd_emulation(q, k, v, o, do, terms=1, **kw)
    want = FA.flash_attention_bwd_plain(q, k, v, o, do, **kw)
    assert _limit_share(got, want) > 4.0
