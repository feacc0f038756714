"""repro_torch.kernels.flash_attention against the reference on the CPU.

The port's plain version (what a CPU tensor runs, and what the CUDA kernel
is held against on the card) against the reference's Pallas kernel in
interpret mode and against its ``ref.attention``, in float32 on the same
numpy inputs. Tolerance 1e-5 absolute: all three sum the same float32
products in different orders (the Pallas kernel tile by tile with an
online softmax, the others over the whole row), on values of order 1.

Then the CUDA side's decisions that the CPU can check: which kernel a call
runs (``ops.variant``; the dec kernel's split formula and order of work
are in ``test_torch_flash_dec.py``), and why the tensor-core kernel
carries P as two bf16 terms: its arithmetic, emulated in torch, stays
within the card test's tolerance against the plain version with two terms
and leaves it with one.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import kernel as rkernel
from repro.kernels.flash_attention import ref as rref
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops as FA
from repro_torch.kernels.flash_attention import ref as tref

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _exp_initialised():
    """torch's CPU ``exp`` (2.13, AVX-512 build) now and then returns
    values about 1e-4 off on its first multi-threaded call in a process
    (7 of 64 fresh processes); one call on a single element first makes
    every later call accurate to float32 rounding."""
    torch.exp(torch.zeros(1))

# (B, S, T, H, K, D, causal, q_offset, kv_valid_len)
CASES = [
    (2, 64, 64, 4, 2, 16, True, 0, None),          # GQA g = 2, causal
    (1, 64, 64, 4, 2, 32, False, 0, None),         # g = 2, not causal
    (2, 48, 48, 2, 2, 16, True, 0, None),          # g = 1
    (1, 40, 72, 3, 3, 16, False, 0, None),         # g = 1, not causal, S != T
    (2, 1, 96, 4, 2, 16, True, 70, 71),            # decode against a cache
    (1, 3, 64, 4, 1, 24, True, 40, 43),            # short chunk, g = 4
    (1, 200, 200, 2, 1, 16, True, 0, None),        # S, T not multiples of 128
    (1, 130, 150, 2, 2, 8, False, 0, 140),         # ragged, kv_valid_len < T
]


def _inputs(case, seed=0):
    b, s, t, h, kh, d = case[:6]
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(np.float32)
                 for shape in ((b, s, h, d), (b, t, kh, d), (b, t, kh, d)))


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_plain_matches_pallas_interpret_and_ref(case):
    causal, off, valid = case[6:]
    q, k, v = _inputs(case)
    kw = dict(causal=causal, q_offset=off, kv_valid_len=valid)
    got = FA.flash_attention_plain(*map(torch.from_numpy, (q, k, v)), **kw)
    pallas = np.asarray(rkernel.flash_attention_fwd(
        *map(jnp.asarray, (q, k, v)), interpret=True, **kw))
    ref = np.asarray(rref.attention(*map(jnp.asarray, (q, k, v)), **kw))
    err_pallas = float(np.abs(got.numpy() - pallas).max())
    err_ref = float(np.abs(got.numpy() - ref).max())
    print(f"max abs err vs pallas {err_pallas:.2e}, vs ref {err_ref:.2e}")
    assert got.dtype == torch.float32 and got.shape == q.shape
    assert err_pallas <= TOL and err_ref <= TOL


@pytest.mark.parametrize("case", CASES[:5], ids=lambda c: "-".join(
    map(str, c)))
def test_port_ref_matches_reference_ref(case):
    causal, off, valid = case[6:]
    q, k, v = _inputs(case, seed=1)
    kw = dict(causal=causal, q_offset=off, kv_valid_len=valid)
    got = tref.attention(*map(torch.from_numpy, (q, k, v)), **kw).numpy()
    want = np.asarray(rref.attention(*map(jnp.asarray, (q, k, v)), **kw))
    assert float(np.abs(got - want).max()) <= TOL


def test_cpu_tensor_runs_the_plain_version_without_a_launch():
    q, k, v = map(torch.from_numpy, _inputs(CASES[4]))
    _build.reset_launches()
    got = FA.flash_attention(q, k, v, q_offset=70, kv_valid_len=71)
    want = FA.flash_attention_plain(q, k, v, q_offset=70, kv_valid_len=71)
    assert torch.equal(got, want)
    assert not _build.launches


def test_bf16_inputs_compute_in_float32_and_return_bf16():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _inputs(CASES[0]))
    got = FA.flash_attention(q, k, v)
    want = FA.flash_attention_plain(q.float(), k.float(), v.float())
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.to(torch.bfloat16))


# (D, dtype): head sizes the CUDA kernels are not built for (not a multiple
# of 8, above 256) and float16, which the scalar kernel takes on the card
CPU_ONLY = [(12, torch.float32), (264, torch.float32), (16, torch.float16)]
# float16: both round the output to float16 (their float32 results may
# fall on either side of a rounding boundary: one step, at most 2^-10 of
# max |want|), and the reference rounds the softmax weights to float16
# before P·V (2^-11 relative each): within 2^-9 of max |want|
F16_REL = 2.0 ** -9


@pytest.mark.parametrize("d, dtype", CPU_ONLY, ids=lambda c: str(c))
def test_cpu_tier_computes_what_the_plain_version_computes(d, dtype):
    """A CPU call at a size or dtype outside the CUDA kernels' runs the
    plain version, as the reference's stacks run these (a CUDA call at
    those sizes raises, and float16 runs the scalar kernel:
    tests/test_torch_cuda.py); held against ``ref.attention``."""
    case = (1, 20, 20, 4, 2, d, True, 0, None)
    q, k, v = _inputs(case, seed=3)
    got = FA.flash_attention(*(torch.from_numpy(a).to(dtype)
                               for a in (q, k, v)))
    jdt = jnp.float16 if dtype == torch.float16 else jnp.float32
    want = np.asarray(rref.attention(*(jnp.asarray(a, jdt)
                                       for a in (q, k, v))), np.float32)
    assert got.dtype == dtype and got.shape == q.shape
    err = float(np.abs(got.float().numpy() - want).max())
    limit = (F16_REL * float(np.abs(want).max())
             if dtype == torch.float16 else TOL)
    assert err <= limit, (err, limit)


@pytest.mark.parametrize("bad, match", [
    (dict(h=3, kh=2), "do not group"),
    (dict(kv_valid_len=0), "kv_valid_len"),
    (dict(q_offset=-1), "q_offset"),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad, match):
    d, h, kh = bad.get("d", 16), bad.get("h", 4), bad.get("kh", 2)
    dt = bad.get("dtype", torch.float32)
    q = torch.zeros((1, 4, h, d), dtype=dt)
    k = torch.zeros((1, 4, kh, d), dtype=dt)
    with pytest.raises((ValueError, TypeError), match=match):
        FA.flash_attention(q, k, k, q_offset=bad.get("q_offset", 0),
                           kv_valid_len=bad.get("kv_valid_len"))


def test_wrapper_refuses_mixed_dtypes_and_strided_inputs():
    q = torch.zeros((1, 4, 2, 16))
    with pytest.raises(TypeError, match="dtypes differ"):
        FA.flash_attention(q, q.to(torch.bfloat16), q.to(torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        FA.flash_attention(q.transpose(1, 2), q, q)


@pytest.mark.parametrize("shape, splits", [
    ((4, 2048, 16, 8, 2048), 1),      # prefill: 1024 blocks, no split
    ((4, 1, 16, 8, 2080), 9),         # decode: 32 blocks -> 288
    ((1, 1, 4, 4, 100), 1),           # too few keys to split
    ((1, 1, 4, 4, 300), 3),           # at least 4 tiles of 32 per split
    ((2, 100, 8, 2, 5000), 6),        # 52 blocks -> 312
])
def test_kv_splits_fill_a_wave_of_the_card(shape, splits):
    b, s, h, kh, kv_len = shape
    assert FA.kv_splits(b, s, h, kh, kv_len, n_sms=132) == splits


# --------------------------------------------------------------------------- #
# the CUDA routing rule and the tensor-core kernel's arithmetic
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("dtype, s, g, d, want", [
    (torch.bfloat16, 2048, 2, 128, "tc"),        # qwen3-0.6b prefill
    (torch.bfloat16, 2048, 1, 112, "tc"),        # zamba2-7b prefill
    (torch.bfloat16, 64, 1, 80, "tc"),           # hubert-xlarge's width
    (torch.bfloat16, 32, 2, 64, "tc"),           # S * g = 64: one warpgroup
    (torch.bfloat16, 63, 1, 64, "scalar"),       # S * g = 63
    (torch.bfloat16, 21, 3, 64, "scalar"),
    (torch.bfloat16, 1, 2, 128, "dec"),          # a decode step
    (torch.bfloat16, 1, 64, 128, "tc"),          # one row, 64 heads a group
    (torch.bfloat16, 512, 1, 136, "scalar"),     # wider than 128
    (torch.bfloat16, 512, 1, 256, "scalar"),
    (torch.bfloat16, 512, 1, 72, "scalar"),      # not a multiple of 16
    (torch.float32, 2048, 2, 128, "scalar"),     # a float32 prefill
    (torch.float32, 512, 1, 64, "scalar"),
    (torch.float32, 1, 2, 112, "dec"),           # float32 decode step
])
def test_variant_is_a_rule_of_dtype_and_shape(dtype, s, g, d, want):
    assert FA.variant(dtype, s, g, d) == want


def _tc_emulation(q, k, v, *, causal, q_offset, kv_valid_len, terms):
    """The tc kernel's arithmetic in torch: scores of bf16 q and k summed in
    float32, the online softmax over 64-key tiles in float32, and P·V as
    ``terms`` bf16 terms of P (bf16(P), then bf16(P - bf16(P))), each
    multiplied with V and summed in float32."""
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    qf = q.float().permute(0, 2, 1, 3)                       # (B, H, S, D)
    kf = k.float().permute(0, 2, 1, 3).repeat_interleave(h // kh, 1)
    vf = v.float().permute(0, 2, 1, 3).repeat_interleave(h // kh, 1)
    kv_lim = t if kv_valid_len is None else min(kv_valid_len, t)
    qpos = torch.arange(s)[:, None] + q_offset
    m = torch.full((b, h, s, 1), FA.NEG_INF)
    l = torch.zeros((b, h, s, 1))
    acc = torch.zeros((b, h, s, d))
    for t0 in range(0, kv_lim, 64):
        kpos = torch.arange(t0, min(t0 + 64, t))[None, :]
        sc = qf @ kf[:, :, t0:t0 + 64].transpose(-1, -2) * (1.0 / d ** 0.5)
        ok = kpos < kv_lim
        if causal:
            ok = ok & (kpos <= qpos)
        sc = torch.where(ok, sc, torch.full((), FA.NEG_INF))
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        p = torch.exp(sc - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha
        rest = p
        for _ in range(terms):
            term = rest.to(torch.bfloat16).float()
            acc = acc + term @ vf[:, :, t0:t0 + 64]
            rest = rest - term
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.permute(0, 2, 1, 3).to(torch.bfloat16)


# the bf16 shapes of the card tests that the tc kernel takes
# (B, S, T, H, K, D, causal, q_offset, kv_valid_len)
TC_CASES = [
    (2, 77, 77, 4, 2, 128, True, 0, None),
    (1, 130, 130, 4, 4, 64, True, 0, None),
    (2, 33, 45, 6, 2, 112, False, 0, None),
    (1, 33, 70, 4, 2, 64, True, 37, None),
    (2, 65, 130, 10, 2, 80, True, 65, None),
    (1, 200, 333, 6, 2, 128, True, 100, 290),
    (2, 100, 100, 8, 8, 112, True, 0, None),
    (1, 300, 300, 4, 2, 32, False, 0, 257),
]


def _over_card_tolerance(case, terms):
    """Elements of the emulation outside the card test's tolerance against
    ``flash_attention_plain``: one bf16 step, ``2^-7·|want| + 1e-5``."""
    b, s, t, h, kh, d, causal, off, valid = case
    rng = np.random.default_rng(sum(case[:6]))
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, np.float32))
               .to(torch.bfloat16)
               for shape in ((b, s, h, d), (b, t, kh, d), (b, t, kh, d)))
    assert FA.variant(q.dtype, s, h // kh, d) == "tc"
    kw = dict(causal=causal, q_offset=off, kv_valid_len=valid)
    got = _tc_emulation(q, k, v, terms=terms, **kw).float()
    want = FA.flash_attention_plain(q, k, v, **kw).float()
    return int(((got - want).abs() > want.abs() * 2.0 ** -7 + 1e-5).sum())


@pytest.mark.parametrize("case", TC_CASES, ids=lambda c: "-".join(
    map(str, c)))
def test_two_bf16_terms_of_p_hold_the_card_tolerance(case):
    assert _over_card_tolerance(case, terms=2) == 0


@pytest.mark.parametrize("case", TC_CASES, ids=lambda c: "-".join(
    map(str, c)))
def test_one_bf16_term_of_p_breaks_the_card_tolerance(case):
    """The witness for the second term: P rounded once to bf16 moves some
    outputs past one bf16 step of the function."""
    assert _over_card_tolerance(case, terms=1) > 0
