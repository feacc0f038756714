"""The WKV backward's tc route, its order of work emulated on the CPU.

On a CUDA tensor with S >= 64 ``rwkv6_wkv.ops.wkv_bwd`` runs the four
kernels of ``csrc/rwkv6_wkv_bwd_tc.cu``: the gradient of the chunked form
of the recurrence, each matrix product as three TF32 tensor-core products
and every decay a product of w's (no log, no exp, no division).
:func:`_tc_bwd` repeats that order of work in torch, per (b, h) and chunk
of ``BWD_TC_CHUNK[hd]`` steps, in sub-chunks of ``BWD_TC_SUB``:

(a) each chunk's own ΔS = (k ∘ P⁺)ᵀ V, ΔG = (r ∘ P⁻)ᵀ dY and total decay F
    (P⁻, P⁺ the products of w before and after a step inside the chunk);
(b) the passes over the chunk boundaries, S_in(c+1) = F S_in(c) + ΔS(c)
    from s0 and G_out(c-1) = F G_out(c) + ΔG(c) from ds, ds0 the last;
(c) per (b, chunk, h) the gradients: D = dY Vᵀ, dY S_inᵀ, V G_outᵀ and
    (k ∘ P⁺) G_out, the products across sub-chunks through D with the
    decays between them (W, a product of whole sub-chunks' F), the
    matrix A of the forward (its diagonal blocks in float32 scalars),
    dv = (k ∘ P⁺) G_out + Aᵀ dY, and per (sub-chunk, row i) the running
    products of dr, dk and dw's four parts (the pairs s < t < s' inside
    a sub-chunk among them), and du's part;
(d) du summed over (b, chunk) in order.

It is held to ``jax.vjp`` of the reference's oracle and to
``wkv_bwd_plain``, each gradient within 1e-5 of its largest, the
tolerance the card holds the kernels to (``chip_smoke.py`` check (k2));
with one TF32 term, or with a planted fault, it leaves it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6_wkv import ref as rref
from repro_torch.kernels import _build
from repro_torch.kernels.rwkv6_wkv import ops as W
from tf32_emulation import mm

TOL = 1e-5
NAMES = ("dr", "dk", "dv", "dw", "du", "ds0")


def _inputs(b, s, h, hd, *, seed=0, decay="model", s0=True, ds=True):
    """r, k, v, w, u, s0, dy, ds as numpy float32, drawn as
    ``tests/test_torch_wkv_bwd.py`` draws them: w = exp(-exp(N(0, 1) -
    2)) (``model``), that with every third step 0 (``zero``), or within
    1e-6 of 1 (``near1``)."""
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
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _errs(got, want) -> dict:
    return {n: _rel(g, w) for n, g, w in zip(NAMES, got, want)}


def _plain(args):
    return tuple(g.numpy() for g in W.wkv_bwd_plain(
        *map(torch.from_numpy, args)))


def _jax_vjp(args):
    """jax.vjp of the reference's ``ref.wkv`` with cotangents (dy, ds)."""
    _, vjp = jax.vjp(rref.wkv, *map(jnp.asarray, args[:6]))
    return tuple(np.asarray(g) for g in vjp((jnp.asarray(args[6]),
                                             jnp.asarray(args[7]))))


def _excl_prod(w, dim, reverse=False):
    """The product of w before each row along ``dim`` (after it, with
    ``reverse``), the row itself left out, in order from the near end."""
    n = w.shape[dim]
    out, run = [None] * n, torch.ones_like(w.select(dim, 0))
    for t in (reversed(range(n)) if reverse else range(n)):
        out[t] = run
        run = run * w.select(dim, t)
    return torch.stack(out, dim), run


def _tc_bwd(r, k, v, w, u, s0, dy, ds, *, terms=3, fault=None):
    """The tc route's order of work in torch, float32 (see the module's
    docstring). ``fault``: ``"boundary"`` (the reverse pass does not carry
    ds across the last chunk boundary: a short last chunk decays it
    little) or ``"pairs"`` (dw's part 4,
    the pairs s < t < s' inside a sub-chunk, left out). Returns (dr, dk,
    dv, dw, du, ds0)."""
    b, s, h, hd = r.shape
    C, L = W.BWD_TC_CHUNK[hd], W.BWD_TC_SUB
    NS = C // L
    nk = -(-s // C)
    pad = nk * C - s

    def chunked(x, fill):
        """(B, S, H, hd) -> (B, K, H, C, hd), rows past S ``fill``"""
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad), value=fill)
        return x.reshape(b, nk, C, h, hd).transpose(2, 3)

    def tr(x):
        return x.transpose(-1, -2)
    R, K, V, DY = (chunked(x, 0.0) for x in (r, k, v, dy))
    Wd = chunked(w, 1.0)
    # (a) each chunk's own ΔS, ΔG and F; (b) the passes
    pm, fc = _excl_prod(Wd, -2)
    pp, _ = _excl_prod(Wd, -2, reverse=True)
    dS = mm(tr(K * pp), V, terms)                         # (B, K, H, hd, hd)
    dG = mm(tr(R * pm), DY, terms)
    s_in, st = [], s0
    for c in range(nk):
        s_in.append(st)
        st = fc[:, c, :, :, None] * st + dS[:, c]
    g_out, g = [None] * nk, ds
    for c in reversed(range(nk)):
        g_out[c] = g
        carried = fc[:, c, :, :, None] * g
        if fault == "boundary" and c == nk - 1:
            carried = torch.zeros_like(g)
        g = carried + dG[:, c]
    ds0 = g
    S_in, G_out = torch.stack(s_in, 1), torch.stack(g_out, 1)

    # (c) the sub-chunks' decays: P (before a step), Q (after), F (all)
    def sub(x):
        return x.reshape(*x.shape[:-2], NS, L, x.shape[-1])

    def rows(x):
        return x.reshape(*x.shape[:-3], NS * L, x.shape[-1])
    P, F = _excl_prod(sub(Wd), -2)                    # F: (B, K, H, NS, hd)
    Q, _ = _excl_prod(sub(Wd), -2, reverse=True)
    P, Q = rows(P), rows(Q)

    def span(lo, hi):
        """the product of F over sub-chunks lo .. hi - 1"""
        out = torch.ones_like(F[..., 0, :])
        for m in range(lo, hi):
            out = out * F[..., m, :]
        return out
    D = mm(DY, tr(V), terms)                              # (B, K, H, C, C)
    YS = mm(DY, tr(S_in), terms)                          # (.., C, hd)
    VG = mm(V, tr(G_out), terms)
    RP, KQ = R * P, K * Q
    fa_rows = rows(torch.stack([span(t + 1, NS)[..., None, :].expand(
        *F.shape[:-2], L, hd) for t in range(NS)], -3))
    KG = mm(KQ * fa_rows, G_out, terms)
    c3 = sub(RP * YS).sum(-2)                             # (.., NS, hd)
    c2 = sub(KQ * VG).sum(-2)
    sig0 = (S_in * G_out).sum(-1)                         # (.., hd)

    def blk(x, t, j=None):
        """rows of sub-chunk t (and columns of sub-chunk j)"""
        x = x[..., L * t:L * (t + 1), :]
        return x if j is None else x[..., L * j:L * (j + 1)]
    Y, X = YS.clone(), VG.clone()
    c4 = {}
    for t in range(NS):
        acc = span(0, t)[..., None, :] * blk(YS, t)
        for j in range(t):
            dk_tj = mm(blk(D, t, j), blk(KQ, j), terms)
            if j <= t - 2:
                c4[t, j] = (blk(RP, t) * dk_tj).sum(-2)
            acc = acc + span(j + 1, t)[..., None, :] * dk_tj
        Y[..., L * t:L * (t + 1), :] = acc
        acc = span(t + 1, NS)[..., None, :] * blk(VG, t)
        for j in range(t + 1, NS):
            dr_tj = mm(tr(blk(D, j, t)), blk(RP, j), terms)
            acc = acc + span(t + 1, j)[..., None, :] * dr_tj
        X[..., L * t:L * (t + 1), :] = acc
    # A: the blocks across sub-chunks on the tensor cores, the diagonal
    # blocks (and the bonus) in float32 running products
    A = torch.zeros_like(D)
    for t in range(NS):
        for j in range(t + 1, NS):
            A[..., L * j:L * (j + 1), L * t:L * (t + 1)] = mm(
                blk(RP, j) * span(t + 1, j)[..., None, :], tr(blk(KQ, t)),
                terms)
    rr, kk, ww = sub(R), sub(K), sub(Wd)                  # (.., NS, L, hd)
    diag = torch.arange(NS) * L
    for t in range(L):
        A[..., diag + t, diag + t] = (rr[..., t, :] * u[:, None]
                                      * kk[..., t, :]).sum(-1)
        run = torch.ones_like(kk[..., 0, :])
        for s_ in range(t + 1, L):
            A[..., diag + s_, diag + t] = (rr[..., s_, :] * run
                                           * kk[..., t, :]).sum(-1)
            run = run * ww[..., s_, :]
    dv = KG + mm(tr(A), DY, terms)
    # σ = <S_T[i], G_T[i]>, the state at sub-chunk T's start and the
    # gradient at its end, from the chunk's terms
    sig = []
    for t in range(NS):
        fb, fa = span(0, t), span(t + 1, NS)
        acc = fb * fa * sig0
        for j in range(t + 1, NS):
            acc = acc + fb * span(t + 1, j) * c3[..., j, :]
        for j in range(t):
            acc = acc + fa * span(j + 1, t) * c2[..., j, :]
        for j in range(t):
            for j2 in range(t + 1, NS):
                acc = acc + (span(j + 1, t) * span(t + 1, j2)
                             * c4[j2, j])
        sig.append(acc)
    sig = torch.stack(sig, -2)                            # (.., NS, hd)
    # per (sub-chunk, row i): the pairs inside the sub-chunk. e runs E[s'][t]
    # = sum_{s<t} a(s,t) k_s D[s'][s] up t; H (dw's pairs s < t < s') and
    # dkI (dk's inner sum) add s' by Horner from the last step down; drI
    # (dr's inner sum) is E[s'][s']
    Ds = torch.stack([blk(D, t, t) for t in range(NS)], -3)  # (.., NS, L, L)
    vdy = Ds.diagonal(dim1=-2, dim2=-1)[..., None]        # (.., NS, L, 1)
    Ysub, Xsub, Psub, Qsub = sub(Y), sub(X), sub(P), sub(Q)
    H = [torch.zeros_like(kk[..., 0, :]) for _ in range(L)]
    dkI = [torch.zeros_like(kk[..., 0, :]) for _ in range(L)]
    drI = [torch.zeros_like(kk[..., 0, :]) for _ in range(L)]
    for sp in range(L - 1, 0, -1):
        e = torch.zeros_like(kk[..., 0, :])
        for t in range(sp):
            d = Ds[..., sp, t, None]
            H[t] = ww[..., sp, :] * H[t] + rr[..., sp, :] * e
            dkI[t] = ww[..., sp, :] * dkI[t] + rr[..., sp, :] * d
            e = ww[..., t, :] * e + kk[..., t, :] * d
        drI[sp] = e
    f, g, fs, gs = 0.0, 0.0, [None] * L, [None] * L
    for t in range(L):
        fs[t] = f
        f = ww[..., t, :] * f + kk[..., t, :] * Xsub[..., t, :]
    for t in reversed(range(L)):
        gs[t] = g
        g = ww[..., t, :] * g + rr[..., t, :] * Ysub[..., t, :]
    H, dkI, drI = (torch.stack(x, -2) for x in (H, dkI, drI))
    fs, gs = (torch.stack([x * torch.ones_like(kk[..., 0, :]) for x in y], -2)
              for y in (fs, gs))
    uu = u[None, None, :, None, None, :]
    dr = uu * kk * vdy + Psub * Ysub + drI
    dk = uu * rr * vdy + Qsub * Xsub + dkI
    dw = Psub * Qsub * sig[..., None, :] + Qsub * fs + Psub * gs
    if fault != "pairs":
        dw = dw + H
    # (d) du: each block's part over its sub-chunks in order, then over
    # (b, chunk) in order
    part = (rr * kk * vdy).sum(-2)                        # (.., NS, hd)
    du_part = part[..., 0, :]
    for t in range(1, NS):
        du_part = du_part + part[..., t, :]
    du = torch.zeros((h, hd))
    for bi in range(b):
        for c in range(nk):
            du = du + du_part[bi, c]

    def unchunked(x):
        """(B, K, H, NS, L, hd) -> (B, S, H, hd)"""
        x = x.reshape(b, nk, h, C, hd).transpose(2, 3)
        return x.reshape(b, nk * C, h, hd)[:, :s].contiguous()
    return (unchunked(dr), unchunked(dk), unchunked(sub(dv)), unchunked(dw),
            du, ds0)


def _emulated(args, **kw):
    return tuple(g.numpy() for g in _tc_bwd(*map(torch.from_numpy, args),
                                            **kw))


# (B, S, H, hd, decay, s0, ds): one chunk, a ragged second, two chunks and
# a ragged third, three chunks and a ragged fourth; every hd; w = 0 every
# third step, w within 1e-6 of 1; s0 and ds zero and random
CASES = [
    (2, 64, 2, 16, "model", True, True),
    (1, 65, 2, 32, "zero", True, False),
    (2, 130, 2, 64, "near1", False, True),
    (1, 200, 2, 16, "zero", False, False),
    (1, 130, 1, 128, "model", True, True),
    (1, 65, 2, 128, "near1", False, True),
]


@pytest.mark.parametrize("case", CASES, ids=str)
def test_tc_order_of_work_matches_jax_vjp_of_the_reference(case):
    b, s, h, hd, decay, s0, ds = case
    args = _inputs(b, s, h, hd, seed=s + hd, decay=decay, s0=s0, ds=ds)
    errs = _errs(_emulated(args), _jax_vjp(args))
    assert max(errs.values()) <= TOL, errs


@pytest.mark.parametrize("case", CASES, ids=str)
def test_tc_order_of_work_matches_the_plain_backward(case):
    b, s, h, hd, decay, s0, ds = case
    args = _inputs(b, s, h, hd, seed=s + hd + 1, decay=decay, s0=s0, ds=ds)
    errs = _errs(_emulated(args), _plain(args))
    assert max(errs.values()) <= TOL, errs


@pytest.mark.parametrize("hd", W.HEAD_DIMS)
@pytest.mark.parametrize("decay", ["model", "zero", "near1"])
def test_every_compiled_head_size_at_every_decay(hd, decay):
    """Every hd the kernels are built for at 130 steps (two chunks of 64
    and a ragged third; five of 32 at hd 128), each decay, against
    jax.vjp of the reference."""
    args = _inputs(1, 130, 2, hd, seed=hd, decay=decay)
    errs = _errs(_emulated(args), _jax_vjp(args))
    assert max(errs.values()) <= TOL, errs


@pytest.mark.parametrize("case", CASES[:3], ids=str)
def test_one_tf32_term_leaves_the_tolerance(case):
    """Why every product runs as three TF32 products: with one, some
    gradient leaves 1e-5 of its largest."""
    b, s, h, hd, decay, s0, ds = case
    args = _inputs(b, s, h, hd, seed=s + hd, decay=decay, s0=s0, ds=ds)
    errs = _errs(_emulated(args, terms=1), _plain(args))
    assert max(errs.values()) > TOL, errs


def _backward64(args):
    return tuple(g.numpy() for g in W.wkv_bwd_plain(
        *(torch.from_numpy(v).double() for v in args)))


def test_long_near_one_decay_within_twice_the_plain_distance_from_float64():
    """4096 steps of w within 1e-6 of 1 (chip_smoke.py's WKV_BWD_LONG at
    the CPU tier's width): each gradient of the tc order of work within
    twice the float32 plain backward's own distance from a float64 plain
    backward (or 1e-5), the limit the card holds the kernels to."""
    args = _inputs(1, 4096, 2, 16, seed=7, decay="near1")
    exact = _backward64(args)
    got, own = _errs(_emulated(args), exact), _errs(_plain(args), exact)
    for name in NAMES:
        assert got[name] <= max(2 * own[name], TOL), (name, got, own)


@pytest.mark.parametrize("fault", ["boundary", "pairs"])
def test_a_planted_fault_leaves_the_tolerance(fault):
    """The faults chip_smoke.py's check (k2) plants in the tc route: a
    chunk boundary's G_out not passed on, dw's pairs s < t < s' inside a
    sub-chunk left out."""
    args = _inputs(2, 130, 2, 32, seed=11)
    want = _plain(args)
    assert max(_errs(_emulated(args), want).values()) <= TOL
    errs = _errs(_emulated(args, fault=fault), want)
    assert max(errs.values()) > 10 * TOL, errs


def test_w_zero_is_exact_and_the_decays_take_no_logarithm():
    """w = 0 at every step: no state survives a step, so every gradient
    is the step's own (dr = u k (v.dy), dk = u r (v.dy) + G_t v, dw =
    <G_t, S_{t-1}> with S_{t-1} = k v of the step before); the
    emulation, which multiplies w's and never divides, gives the plain
    backward's values within the tolerance and no NaN."""
    args = list(_inputs(1, 70, 2, 16, seed=2))
    args[3] = np.zeros_like(args[3])
    got = _emulated(tuple(args))
    assert all(np.isfinite(g).all() for g in got)
    errs = _errs(got, _plain(tuple(args)))
    assert max(errs.values()) <= TOL, errs


def test_the_emulation_constants_are_the_kernel_s():
    src = (_build.CSRC / "rwkv6_wkv_bwd_tc.cu").read_text()
    assert f"constexpr int kSub = {W.BWD_TC_SUB};" in src
    assert ("static constexpr int kC = HD <= 64 ? "
            f"{W.BWD_TC_CHUNK[64]} : {W.BWD_TC_CHUNK[128]};") in src
    assert all(W.BWD_TC_CHUNK[hd] == W.BWD_TC_CHUNK[64] for hd in (16, 32))
    assert all(W.BWD_TC_CHUNK[hd] % W.BWD_TC_SUB == 0 for hd in W.HEAD_DIMS)
    assert "logf" not in src and "expf" not in src


def test_bwd_variant_routes_by_length_alone():
    """tc from one chunk (64 steps) up at every hd, rec below: the
    forward's rule, so a training call runs both directions on tc."""
    for hd in W.HEAD_DIMS:
        assert [W.bwd_variant(s, hd) for s in (0, 1, 2, 63)] == ["rec"] * 4
        assert [W.bwd_variant(s, hd) for s in (64, 65, 4096)] == ["tc"] * 3
        assert all((W.bwd_variant(s, hd) == "tc")
                   == (W.variant(s, hd) == "tc") for s in range(2, 200))
