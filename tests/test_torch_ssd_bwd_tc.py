"""The SSD backward's tc route, its order of work emulated on the CPU.

On a CUDA tensor with S >= 64 ``mamba2_ssd.ops.ssd_bwd`` runs the four
kernels of ``csrc/mamba2_ssd_bwd_tc.cu``: the gradient of the reference's
chunked form (``repro/models/ssm.py:82-156``), each matrix product as three
TF32 tensor-core products. :func:`_tc_bwd` repeats that order of work in
torch: chunks of ``TC_CHUNK`` steps with ``cum`` restarted at each, every
exponent a difference cum_t - cum_j with t >= j;

(a) each chunk's own state Bᵀ (w ∘ X) and the pass over the chunk
    boundaries from s0, S_in(k+1) = e^{cum_last} S_in(k) + local(k);
(b) Cᵀ diag(e^{cum}) dY per chunk and the reverse pass from ds,
    dS_out(k-1) = e^{cum_last} dS_out(k) + that;
(c) per (b, chunk, group of ``BWD_HEADS`` heads) the gradients: dM = dY Xᵀ,
    dG = dM ∘ L ∘ dt_j, dX = Mᵀ dY + d dY + diag(w) B dS_out, dC = dG B +
    diag(e^{cum}) dY S_inᵀ, dB = dGᵀ C + diag(w) X dS_outᵀ, db and dc
    summed over the group's heads, ddt from the gradient of the log decays
    (a reverse sum within the chunk) and the direct dt terms;
(d) db and dc summed over the head groups, da and dd over (b, chunk), in
    order;

every product through ``tf32_emulation.mm`` but the four that carry the
state across chunks (Bᵀ (w ∘ X), Cᵀ (e^{cum} ∘ dY), dY S_inᵀ, X dS_outᵀ),
which run on the float64 tensor cores (:func:`_mm64`): da is a sum of
terms many times its size, and with those four as TF32 products it lay
9.4e-6 of its largest from float64 at one of ``chip_smoke.py``'s (k2)
edges, where the float32 plain backward lies 6.9e-6 from it on the other
side. It is held to ``jax.vjp`` of
the reference's oracle head by head and to ``ssd_bwd_plain``, each
gradient within 1e-5 of its largest, the tolerance the card holds the
kernels to (``chip_smoke.py`` check (k2)); with one TF32 term, or with
a planted fault, it leaves it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba2_ssd import ref as rref
from repro_torch.kernels import _build
from repro_torch.kernels.mamba2_ssd import ops as SSD
from tf32_emulation import mm

TOL = 1e-5
NAMES = ("dx", "db", "dc", "ddt", "da", "dd", "ds0")


@pytest.fixture(autouse=True, scope="module")
def _exp_initialised():
    """torch's CPU ``exp`` (2.13, AVX-512 build) now and then returns
    values about 1e-4 off on its first multi-threaded call in a process
    (7 of 64 fresh processes); one call on a single element first makes
    every later call accurate to float32 rounding."""
    torch.exp(torch.zeros(1))


def _inputs(b, s, h, hd, n, *, seed=0, dt="model", s0=True):
    """x, b, c, dt, a, d, s0, dy, ds as numpy float32, drawn as
    ``tests/test_torch_ssd_bwd.py`` draws them: dt log-uniform in [1e-3,
    1e-1] (``model``), about 1e-6 (``tiny``) or 5 to 20 (``huge``: e^{dt a}
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
    dst = rng.normal(size=(b, h, n, hd))
    return tuple(v.astype(np.float32)
                 for v in (x, bm, cm, dtv, a, d, st, dy, dst))


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _errs(got, want) -> dict:
    return {n: _rel(g, w) for n, g, w in zip(NAMES, got, want)}


def _plain(args):
    return tuple(g.numpy() for g in SSD.ssd_bwd_plain(
        *map(torch.from_numpy, args)))


def _ref_heads(x, b, c, dt, a, d, s0):
    outs = [rref.ssd(x[:, :, h], b, c, dt[:, :, h], a[h], d[h], s0[:, h])
            for h in range(x.shape[2])]
    return (jnp.stack([y for y, _ in outs], 2),
            jnp.stack([s for _, s in outs], 1))


def _jax_vjp(args):
    """jax.vjp of the heads of ``ref.ssd`` with cotangents (dy, ds)."""
    _, vjp = jax.vjp(_ref_heads, *map(jnp.asarray, args[:7]))
    return tuple(np.asarray(g) for g in vjp((jnp.asarray(args[7]),
                                             jnp.asarray(args[8]))))


def _mm64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b on the float64 tensor cores: float32 operands, products and
    sums in float64."""
    return a.double() @ b.double()


def _tc_bwd(x, b, c, dt, a, d, s0, dy, ds, *, terms=3, heads=None,
            fault=None):
    """The tc route's order of work in torch, float32 (see the module's
    docstring); ``heads`` a block (default ``BWD_HEADS``). ``fault``:
    ``"boundary"`` (the reverse pass does not carry dS across the middle
    chunk boundary) or ``"group part"`` (head group 0's part of db left
    out). Returns (dx, db, dc, ddt, da, dd, ds0), float32."""
    heads = heads or SSD.BWD_HEADS
    C = SSD.TC_CHUNK
    bb, s, h, hd = x.shape
    k_chunks = -(-s // C)
    pad = k_chunks * C - s

    def chunked(v):
        """(B, S, ...) -> (B, K, C, ...), rows past S zero"""
        v = torch.nn.functional.pad(v, (0,) * (2 * (v.dim() - 2)) + (0, pad))
        return v.reshape(bb, k_chunks, C, *v.shape[2:])

    def per_head(v):
        """(B, K, C, H, ...) -> (B, K, H, C, ...)"""
        return v.transpose(2, 3)
    xh, dyh = per_head(chunked(x)), per_head(chunked(dy))    # (B, K, H, C, hd)
    bk, ck = chunked(b)[:, :, None], chunked(c)[:, :, None]  # (B, K, 1, C, N)
    dth = per_head(chunked(dt))                              # (B, K, H, C)
    # cum = cumsum(dt a) restarted at each chunk, summed in float64 and kept
    # as hi + lo floats; cum_last at the chunk's last real row (rows past S
    # have dt = 0); every decay a difference (hi_t - hi_j) + (lo_t - lo_j)
    cum = torch.cumsum((dth * a[:, None]).double(), -1)
    hi = cum.float()
    lo = (cum - hi.double()).float()
    rows = torch.full((k_chunks,), C)
    rows[-1] = C - pad
    last = (rows - 1).view(1, k_chunks, 1, 1).expand(bb, -1, h, 1)
    hi_l, lo_l = hi.gather(-1, last), lo.gather(-1, last)    # (B, K, H, 1)
    et = torch.exp(hi)
    ew = torch.exp((hi_l - hi) + (lo_l - lo))                # e^{last - cum}
    w = ew * dth
    elast = torch.exp(hi_l[..., 0])                          # (B, K, H)
    # (a) and (b): each chunk's own state and dS part (on the float64
    # tensor cores), then the passes
    local = _mm64(bk.transpose(-1, -2), w[..., None] * xh).float()
    dlocal = _mm64(ck.transpose(-1, -2), et[..., None] * dyh).float()
    s_in, st = [], s0
    for k in range(k_chunks):
        s_in.append(st)
        st = elast[:, k, :, None, None] * st + local[:, k]
    ds_out, g = [None] * k_chunks, ds
    for k in reversed(range(k_chunks)):
        ds_out[k] = g
        carried = elast[:, k, :, None, None] * g
        if fault == "boundary" and k == k_chunks // 2:
            carried = torch.zeros_like(g)
        g = carried + dlocal[:, k]
    ds0 = g
    s_in = torch.stack(s_in, 1)                              # (B, K, H, N, hd)
    ds_out = torch.stack(ds_out, 1)
    # (c) G = C Bᵀ once per (b, chunk); dM = dY Xᵀ; with L the decays,
    # M = G ∘ L ∘ dt_j, dG = dM ∘ L ∘ dt_j and P = dM ∘ L ∘ G on and under
    # the diagonal
    low = torch.tril(torch.ones(C, C, dtype=torch.bool))
    gram = torch.where(low, mm(ck, bk.transpose(-1, -2), terms), 0.0)
    ell = torch.exp((hi[..., :, None] - hi[..., None, :])
                    + (lo[..., :, None] - lo[..., None, :]))
    e = torch.where(low, mm(dyh, xh.transpose(-1, -2), terms) * ell, 0.0)
    m = torch.where(low, gram * ell * dth[..., None, :], 0.0)
    dg = e * dth[..., None, :]
    p = e * gram
    dx = (mm(m.transpose(-1, -2), dyh, terms)
          + mm(w[..., None] * bk, ds_out, terms) + d[:, None, None] * dyh)
    # dY S_inᵀ and X dS_outᵀ on the float64 tensor cores, r's and u's sums
    # in float64
    y1 = _mm64(dyh, s_in.transpose(-1, -2))                   # (B, K, H, C, N)
    y2 = _mm64(xh, ds_out.transpose(-1, -2))
    r = et * (ck.double() * y1).sum(-1).float()              # (B, K, H, C)
    u = ew * (bk.double() * y2).sum(-1).float()
    y1, y2 = y1.float(), y2.float()
    dc_h = et[..., None] * y1 + mm(dg, bk.expand_as(y1), terms)
    db_h = w[..., None] * y2 + mm(dg.transpose(-1, -2), ck.expand_as(y2),
                                  terms)
    # the gradient of the log decays, dlog_u = sum_{t >= u} d/dcum_t, in
    # terms that do not cancel: R_u, the sum of Q = dG ∘ G over the
    # rectangle t >= u > j (Z = Q V with V[j, u] = [j < u], one product on
    # the tensor cores, then sums down its columns), r over t >= u, v =
    # dt ∘ u over t < u, and e^{cum_last} <S_in, dS_out> at every u
    strict = torch.triu(torch.ones(C, C), 1)                 # [j < u]
    z = mm(dg * gram, strict, terms)
    rect = torch.where(low, z, 0.0).sum(-2)
    r_suf = torch.flip(torch.cumsum(torch.flip(r, (-1,)), -1), (-1,))
    v = dth * u
    v_pre = torch.nn.functional.pad(torch.cumsum(v, -1)[..., :-1], (1, 0))
    es = elast * (s_in.double() * ds_out.double()).sum((-2, -1)).float()
    dlog = ((rect + r_suf) + v_pre) + es[..., None]
    ddt = (p.sum(-2) + u) + a[:, None] * dlog
    # (c)'s parts: db and dc summed over each group's heads in order, da
    # and dd per (b, chunk, h); (d) db and dc over the groups, da and dd
    # over (b, chunk), in order
    parts = []
    for g0 in range(0, h, heads):
        pb, pc = torch.zeros_like(db_h[:, :, 0]), torch.zeros_like(
            dc_h[:, :, 0])
        for hh in range(g0, min(g0 + heads, h)):
            pb = pb + db_h[:, :, hh]
            pc = pc + dc_h[:, :, hh]
        parts.append((pb, pc))
    db_k, dc_k = torch.zeros_like(parts[0][0]), torch.zeros_like(parts[0][1])
    for gi, (pb, pc) in enumerate(parts):
        if not (fault == "group part" and gi == 0):
            db_k = db_k + pb
        dc_k = dc_k + pc
    da_part = (dth * dlog).sum(-1).reshape(bb * k_chunks, h)
    dd_part = (xh.double() * dyh.double()).sum((-2, -1)).float().reshape(
        bb * k_chunks, h)
    da, dd = torch.zeros(h), torch.zeros(h)
    for i in range(bb * k_chunks):
        da = da + da_part[i]
        dd = dd + dd_part[i]

    def unchunked(v):
        """(B, K, C, ...) -> (B, S, ...)"""
        return v.reshape(bb, k_chunks * C, *v.shape[3:])[:, :s].contiguous()
    return (unchunked(per_head(dx)), unchunked(db_k), unchunked(dc_k),
            unchunked(per_head(ddt[..., None]))[..., 0], da, dd, ds0)


def _emulated(args, **kw):
    return tuple(g.numpy() for g in _tc_bwd(*map(torch.from_numpy, args),
                                            **kw))


# (B, S, H, hd, N, dt, s0): one chunk, a ragged second, two chunks and a
# ragged third, four chunks; dt tiny and huge; s0 zero; 20 heads, two
# head groups of a block
CASES = [
    (2, 64, 3, 16, 16, "model", True),
    (1, 65, 3, 16, 32, "huge", True),
    (2, 130, 2, 32, 16, "tiny", False),
    (1, 256, 2, 16, 16, "model", False),
    (1, 130, 20, 16, 16, "model", True),
]


@pytest.mark.parametrize("case", CASES, ids=str)
def test_tc_order_of_work_matches_jax_vjp_of_the_reference(case):
    b, s, h, hd, n, dt, s0 = case
    args = _inputs(b, s, h, hd, n, seed=s + h, dt=dt, s0=s0)
    errs = _errs(_emulated(args), _jax_vjp(args))
    assert max(errs.values()) <= TOL, errs


@pytest.mark.parametrize("case", CASES, ids=str)
def test_tc_order_of_work_matches_the_plain_backward(case):
    b, s, h, hd, n, dt, s0 = case
    args = _inputs(b, s, h, hd, n, seed=s + h + 1, dt=dt, s0=s0)
    errs = _errs(_emulated(args), _plain(args))
    assert max(errs.values()) <= TOL, errs


@pytest.mark.parametrize("hd", SSD.SIZES)
@pytest.mark.parametrize("n", SSD.SIZES)
def test_every_compiled_size_at_a_tc_length(hd, n):
    """Every (hd, N) the kernels are built for, at 65 steps (a chunk and a
    ragged second), against jax.vjp of the reference."""
    args = _inputs(1, 65, 2, hd, n, seed=hd * n)
    errs = _errs(_emulated(args), _jax_vjp(args))
    assert max(errs.values()) <= TOL, errs


def test_the_model_s_strided_views():
    """x, b, c and dt as views of one wider buffer, each (b, t) row
    contiguous (the model's conv output): the same gradients as
    contiguous copies, within TOL of the reference."""
    bb, s, h, hd, n = 2, 130, 3, 16, 16
    args = _inputs(bb, s, h, hd, n, seed=5)
    conv = torch.zeros((bb, s, h * hd + 2 * n + 5))
    conv[..., :h * hd] = torch.from_numpy(args[0]).reshape(bb, s, h * hd)
    conv[..., h * hd:h * hd + n] = torch.from_numpy(args[1])
    conv[..., h * hd + n:h * hd + 2 * n] = torch.from_numpy(args[2])
    wide = torch.zeros((bb, s, h + 3))
    wide[..., 1:h + 1] = torch.from_numpy(args[3])
    views = (conv[..., :h * hd].reshape(bb, s, h, hd),
             conv[..., h * hd:h * hd + n],
             conv[..., h * hd + n:h * hd + 2 * n], wide[..., 1:h + 1])
    assert not views[0].is_contiguous() and not views[3].is_contiguous()
    got = _tc_bwd(*views, *map(torch.from_numpy, args[4:]))
    want = _emulated(args)
    for name, g, w in zip(NAMES, got, want):
        assert g.is_contiguous() and np.array_equal(g.numpy(), w), name
    errs = _errs([g.numpy() for g in got], _jax_vjp(args))
    assert max(errs.values()) <= TOL, errs


@pytest.mark.parametrize("case", CASES[:4], ids=str)
def test_one_tf32_term_leaves_the_tolerance(case):
    """Why every product runs as three TF32 products: with one, some
    gradient leaves 1e-5 of its largest in every case."""
    b, s, h, hd, n, dt, s0 = case
    args = _inputs(b, s, h, hd, n, seed=s + h, dt=dt, s0=s0)
    errs = _errs(_emulated(args, terms=1), _plain(args))
    assert max(errs.values()) > TOL, errs


def _backward64(args):
    return tuple(g.numpy() for g in SSD.ssd_bwd_plain(
        *(torch.from_numpy(v).double() for v in args)))


def test_long_tiny_dt_stays_within_twice_the_plain_distance_from_float64():
    """4096 steps of dt about 1e-6 (chip_smoke.py's SSD_BWD_LONG at the CPU
    tier's widths): each gradient of the tc order of work within twice the
    float32 plain backward's own distance from a float64 plain backward
    (or 1e-5), the limit the card holds the kernels to."""
    args = _inputs(1, 4096, 2, 16, 16, seed=7, dt="tiny")
    exact = _backward64(args)
    got, own = _errs(_emulated(args), exact), _errs(_plain(args), exact)
    for name in NAMES:
        assert got[name] <= max(2 * own[name], TOL), (name, got, own)


@pytest.mark.parametrize("fault", ["boundary", "group part"])
def test_a_planted_fault_leaves_the_tolerance(fault):
    """The faults chip_smoke.py's check (k2) plants in the tc route: a
    chunk boundary's dS not passed on, one head group's part of db left
    out (three heads in groups of two)."""
    args = _inputs(2, 130, 3, 16, 16, seed=11)
    t = tuple(map(torch.from_numpy, args))
    want = _plain(args)
    assert max(_errs([g.numpy() for g in _tc_bwd(*t, heads=2)],
                     want).values()) <= TOL
    errs = _errs([g.numpy() for g in _tc_bwd(*t, heads=2, fault=fault)],
                 want)
    assert max(errs.values()) > 10 * TOL, errs


def test_the_emulation_constants_are_the_kernel_s():
    src = (_build.CSRC / "mamba2_ssd_bwd_tc.cu").read_text()
    assert f"constexpr int kC = {SSD.TC_CHUNK};" in src
    assert f"constexpr int kHeads = {SSD.BWD_HEADS};" in src


def test_bwd_variant_routes_by_length_alone():
    """tc from one chunk (64 steps) up at every hd and N, rec below: the
    forward's rule, so a training call runs both directions on tc."""
    for hd in SSD.SIZES:
        for n in SSD.SIZES:
            assert [SSD.bwd_variant(s, hd, n)
                    for s in (0, 1, 63)] == ["rec"] * 3
            assert [SSD.bwd_variant(s, hd, n)
                    for s in (64, 65, 4096)] == ["tc"] * 3
            assert all(SSD.bwd_variant(s, hd, n) == SSD.variant(s, hd, n)
                       for s in (0, 1, 63, 64, 65, 4096))
