"""repro_torch on the card: each hand-written kernel against its plain
PyTorch version, and the serving loop on the card against the same loop
on the CPU.

These tests need a CUDA device (the kernels have no CPU mode) and skip
without one. They import only torch, numpy and repro_torch, so they also
run where jax is not installed:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops as FA
from repro_torch.kernels.jaccard import ops as jac
from repro_torch.kernels.join import ops as J
from repro_torch.kernels.mamba2_ssd import ops as SSD
from repro_torch.kernels.rwkv6_wkv import ops as W

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True, scope="module")
def _exp_initialised():
    """torch's CPU ``exp`` (2.13, AVX-512 build) now and then returns
    values about 1e-4 off on its first multi-threaded call in a process
    (7 of 64 fresh processes); one call on a single element first makes
    every later call accurate to float32 rounding."""
    torch.exp(torch.zeros(1))


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    _build.reset_launches()
    return torch.device("cuda")


def _t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(dev)


def test_join_kernels_match_plain(dev):
    rng = np.random.default_rng(5)
    cols = _t(rng.integers(0, 2**31, (2, 5000)), dev)
    assert torch.equal(J.pack_keys(cols), J.pack_keys_plain(cols))
    build = torch.sort(_t(rng.integers(0, 900, 4000), dev)).values
    probe = _t(rng.integers(-3, 905, 3000), dev)
    lo, counts = J.probe_sorted(build, probe)
    plo, pcounts = J.probe_sorted_plain(build, probe)
    assert torch.equal(lo, plo) and torch.equal(counts, pcounts)
    starts = torch.cumsum(counts, 0) - counts
    total = int(counts.sum())
    li, pos = J.expand_pairs(lo, counts)
    pli, ppos = J.expand_pairs_plain(starts, lo, total)
    assert torch.equal(li, pli) and torch.equal(pos, ppos)
    idx = _t(rng.integers(-5, 4005, 7000), dev)
    assert torch.equal(J.gather_rows(build, idx, fill=-1),
                       J.gather_rows_plain(build, idx, -1))
    torch.cuda.synchronize()
    one = cols[:1]
    assert J.pack_keys(one).data_ptr() == one.data_ptr()   # no launch
    assert dict(_build.launches) == dict(pack=1, probe=1, expand=1, gather=1)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 1000, 1001, 4097])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset-view"])
def test_pack_kernel_at_odd_lengths_and_offset_views(dev, n, offset):
    """Every (c0, c1) alignment: odd n puts c1 8 bytes off a 16-byte
    boundary, a view one word into its storage moves c0 there; values up
    to 2^31 - 1. Bit for bit against the plain version, one launch."""
    rng = np.random.default_rng(n + offset)
    vals = rng.integers(0, 2**31, 2 * n + offset)
    vals[offset::7] = 2**31 - 1
    cols = _t(vals, dev)[offset:].view(2, n)
    assert cols.data_ptr() % 16 == 8 * offset and cols.is_contiguous()
    got = J.pack_keys(cols)
    torch.cuda.synchronize()
    assert torch.equal(got, J.pack_keys_plain(cols))
    assert torch.equal(got.cpu(), torch.from_numpy(
        J._pack_np(list(vals[offset:].reshape(2, n)))))
    assert dict(_build.launches) == dict(pack=1)


def test_pipeline_on_card_matches_host_reference(dev):
    rng = np.random.default_rng(6)
    lcs = [rng.integers(0, 50, 3000), rng.integers(0, 3, 3000)]
    rcs = [rng.integers(0, 50, 2000), rng.integers(0, 3, 2000)]
    with J.track_transfers() as ts:
        li, ri, total = J.hash_join_pipeline(lcs, rcs, device=dev)
    rli, rri, rtotal = J._pipeline_numpy(lcs, rcs, None)
    assert total == rtotal > 0
    np.testing.assert_array_equal(li, rli)
    np.testing.assert_array_equal(ri, rri)
    assert (ts.h2d, ts.d2h) == (2, 3)
    with pytest.raises(J.ExpansionCapExceeded):
        J.hash_join_pipeline(lcs, rcs, device=dev, max_total=total - 1)


def test_jaccard_kernel_bitwise(dev):
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.integers(-2**31, 2**31, (37, 6))
                         .astype(np.int32)).to(dev)
    a[::5] = 0
    got = jac.distance(a, a)
    want = jac.distance_plain(a, a)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert _build.launches["jaccard"] == 1


def _jaccard_words(q, w, seed, offset=0):
    """(q, w) int32 bitmap words on the card, a view ``offset`` words into
    its storage: every fifth row empty, row 1 all ones."""
    rng = np.random.default_rng(seed)
    base = torch.from_numpy(rng.integers(-2**31, 2**31, q * w + offset)
                            .astype(np.int32)).cuda()
    a = base[offset:].view(q, w)
    a[::5] = 0
    if q > 1:
        a[1] = -1
    return a


# (Q, K, W, offset of a's view in words): W around the 64-word chunk and
# off a multiple of 4, Q off the 8 x 8 tile, K != Q, rows of a not
# 16-byte aligned though W is a multiple of 4, no words at all
JACCARD_EDGES = [(1, 1, 1, 0), (13, 13, 2, 0), (21, 37, 3, 0),
                 (17, 5, 63, 0), (33, 33, 64, 0), (24, 40, 65, 0),
                 (64, 64, 64, 1), (9, 130, 64, 3), (128, 128, 64, 0),
                 (130, 9, 129, 2), (5, 7, 0, 0)]


@pytest.mark.parametrize("var", ["row", "tile"])
@pytest.mark.parametrize("q,k,w,offset", JACCARD_EDGES)
def test_jaccard_variants_bitwise_at_the_edges(dev, var, q, k, w, offset):
    a = _jaccard_words(q, w, q * 100 + w, offset)
    b = a if k == q else _jaccard_words(k, w, k * 100 + w + 1)
    assert a.data_ptr() % 16 == 4 * offset % 16
    got = jac._run(var, a, b)
    want = jac.distance_plain(a, b)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert dict(_build.launches) == {"jaccard": 1, f"jaccard.{var}": 1}


@pytest.mark.parametrize("q,w", [(24, 2), (6, 2), (64, 64), (128, 64),
                                 (40, 65)])
def test_jaccard_routes_by_the_shape_rule(dev, q, w):
    a = _jaccard_words(q, w, q + w)
    got = jac.distance(a, a)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32),
                       jac.distance_plain(a, a).view(torch.int32))
    assert dict(_build.launches) == {
        "jaccard": 1, f"jaccard.{jac.variant(q, q, w)}": 1}


# the probe kernel's edges: (build, probe) as numpy arrays
def _probe_edges(rng):
    run = np.array([1] * 10 + [5] * 1000 + [9] * 10)
    big = np.sort(rng.integers(-2**62, 2**62, 36_191))
    return {
        "m0": (np.array([], np.int64), np.array([-1, 0, 5])),
        "m1": (np.array([7]), np.array([6, 7, 8])),
        "n0": (np.arange(100), np.array([], np.int64)),
        "m_below_g": (np.array([-4, 2, 2, 9, 11]),
                      np.array([-5, -4, 2, 3, 11, 12])),
        "all_equal": (np.full(300, 7), np.array([6, 7, 8])),
        "near_2_62": (np.array([-2**62 - 5, -2**62, -1, 0, 2**62, 2**62,
                                2**62 + 9]),
                      np.array([-2**63, -2**62 - 5, -2**62, -1, 0, 2**62,
                                2**62 + 9, 2**63 - 1])),
        "run_across_splitters": (run, np.array([0, 1, 4, 5, 6, 9, 10])),
        "random": (np.sort(rng.integers(0, 900, 4000)),
                   rng.integers(-3, 905, 3001)),
        "main_path_m": (big, np.concatenate([rng.choice(big, 150),
                                             rng.integers(-2**62, 2**62,
                                                          53)])),
    }


@pytest.mark.parametrize("g", [1, 2, 4, 8, 16, 32])
def test_probe_kernel_at_every_group_matches_plain(dev, g):
    """The probe kernel at each group the formula can give, through its
    private launcher, on every edge: exactly the plain version."""
    for name, (build, probe) in _probe_edges(np.random.default_rng(g)) \
            .items():
        b, p = _t(build, dev), _t(probe, dev)
        got = J._probe(b, p, g)
        want = J.probe_sorted_plain(b, p)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]), (name, g)
        assert torch.equal(got[1], want[1]), (name, g)
    assert _build.launches["probe"] == 8        # n = 0 launches nothing
    with pytest.raises(RuntimeError, match="failed to launch"):
        J._probe(b, p, 3)


def test_probe_group_thresholds_on_card(dev):
    """probe_sorted at and either side of each threshold of probe_group on
    this card's SM count: the group it gives, and exactly the plain
    version."""
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    room = n_sms * J.PROBE_SM_THREADS
    rng = np.random.default_rng(11)
    build = torch.sort(_t(rng.integers(0, 10**6, 36_191), dev)).values
    seen = set()
    for g in (4, 8, 16, 32):
        for n in (room // g - 1, room // g, room // g + 1):
            probe = _t(rng.integers(-5, 10**6 + 5, n), dev)
            seen.add(J.probe_group(n, build.shape[0], n_sms))
            lo, counts = J.probe_sorted(build, probe)
            plo, pcounts = J.probe_sorted_plain(build, probe)
            torch.cuda.synchronize()
            assert torch.equal(lo, plo) and torch.equal(counts, pcounts), n
    assert seen == {1, 4, 8, 16, 32}


def _expand_edges(rng):
    d = J.EXPAND_TILE
    zero_runs = rng.integers(0, 4, 3000)
    zero_runs[100:2900] = 0
    zero_runs[1500] = 5
    lead, trail = rng.integers(0, 4, 3000), rng.integers(0, 4, 3000)
    lead[:2500] = 0
    trail[-2500:] = 0
    many = np.zeros(7, np.int64)
    many[3] = 9 * d + 5
    million = np.zeros(1_000_000, np.int64)
    million[[0, 499_999, 999_999]] = [3, 2 * d, 1]
    return {"mixed": rng.integers(0, 4, 3000), "leading_zero": lead,
            "trailing_zero": trail, "zero_runs": zero_runs,
            "one_segment_many_tiles": many,
            "off_tile_total": np.r_[2, np.ones(d + 2, np.int64)],
            "ones": np.ones(5000, np.int64), "single": np.array([1]),
            "million_empty": million,
            # either side of the one-round search (at most 256 segments)
            "256_segments": rng.integers(0, 9, 256),
            "257_segments": rng.integers(0, 9, 257),
            "main_path": np.r_[rng.integers(0, 7241, 203)]}


def test_expand_kernel_matches_plain_at_edges(dev):
    rng = np.random.default_rng(12)
    edges = _expand_edges(rng)
    for name, counts in edges.items():
        c = _t(counts, dev)
        lo = _t(rng.integers(-2**40, 2**40, len(counts)), dev)
        starts = torch.cumsum(c, 0) - c
        total = int(c.sum())
        li, pos = J.expand_pairs(lo, c, starts=starts, total=total)
        pli, ppos = J.expand_pairs_plain(starts, lo, total)
        torch.cuda.synchronize()
        assert torch.equal(li, pli) and torch.equal(pos, ppos), name
    assert _build.launches["expand"] == len(edges)


def test_expand_segment_ids_as_federation_counts_call_it(dev):
    from repro_torch.query import exec as port_exec

    rng = np.random.default_rng(13)
    lens = rng.integers(0, 5000, 300)
    lens[::7] = 0
    seg = J.expand_segment_ids(_t(lens, dev))
    torch.cuda.synchronize()
    assert torch.equal(seg.cpu(), torch.repeat_interleave(
        torch.arange(len(lens)), torch.from_numpy(lens)))
    ids = [rng.integers(0, 8, n) for n in lens]
    got = port_exec._federation_bincounts(ids, 8, dev)
    want = port_exec._federation_bincounts(ids, 8, torch.device("cpu"))
    np.testing.assert_array_equal(got, want)
    assert _build.launches["expand"] == 2


def test_wrappers_refuse_mixed_devices(dev):
    with pytest.raises(ValueError, match="expected cuda"):
        J.probe_sorted(torch.arange(4), torch.arange(3, device=dev))


def test_service_on_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from repro_torch.api import KGService
    from repro_torch.graph import lubm

    ds = lubm.load(1, seed=0)
    traces = []
    for device in ("cuda", "cpu"):
        svc = KGService.from_dataset(ds, n_shards=4, migration_budget=120_000,
                                     trace=True, device=device)
        svc.bootstrap(ds.base_workload())
        window = ds.extended_workload()
        svc.query_batch(window)
        assert svc.adapt(ds.workload([f"EQ{i}" for i in range(1, 11)])) \
            .accepted
        while svc.session is not None:
            svc.query_batch(window)
        traces.append(svc.tracer().to_json())
    assert traces[0] == traces[1]


# (B, S, T, H, K, D, causal, q_offset, kv_valid_len, dtype): ragged S and T,
# g = 1, 2, 3, non-causal, a decode row against a longer cache, float32
FLASH_CASES = [
    (2, 77, 77, 4, 2, 128, True, 0, None, torch.bfloat16),
    (1, 130, 130, 4, 4, 64, True, 0, None, torch.bfloat16),
    (2, 33, 45, 6, 2, 112, False, 0, None, torch.bfloat16),
    (2, 1, 200, 4, 2, 128, True, 150, 151, torch.bfloat16),
    (1, 5, 97, 5, 5, 80, True, 60, 65, torch.float32),
    (1, 40, 40, 2, 1, 256, True, 0, 23, torch.float32),
    (3, 16, 16, 4, 2, 16, True, 0, None, torch.float32),
    # few blocks: the keys split across blocks and merge (scalar: 17 rows
    # in one block, 5 splits; the rest of these run "dec")
    (1, 17, 600, 1, 1, 64, True, 583, None, torch.bfloat16),
    (4, 1, 2080, 16, 8, 128, True, 2079, 2080, torch.bfloat16),
    (2, 3, 1000, 4, 2, 64, True, 990, 993, torch.bfloat16),
    (1, 2, 700, 2, 2, 80, False, 0, 650, torch.float32),
    # the tensor-core kernel: each D it takes (16 to 128; 80 and 112 end
    # inside a 64-column box), g = 1, 2, 3, 5, S * g at and just over 64,
    # S and T off the 64-key tile, q_offset > 0 with S < T, kv_valid_len
    # < T, non-causal, a grid of fewer blocks than SMs, several row tiles
    (1, 64, 64, 1, 1, 64, True, 0, None, torch.bfloat16),
    (1, 33, 70, 4, 2, 64, True, 37, None, torch.bfloat16),
    (2, 65, 130, 10, 2, 80, True, 65, None, torch.bfloat16),
    (1, 200, 333, 6, 2, 128, True, 100, 290, torch.bfloat16),
    (2, 100, 100, 8, 8, 112, True, 0, None, torch.bfloat16),
    (1, 300, 300, 4, 2, 32, False, 0, 257, torch.bfloat16),
    (1, 40, 40, 4, 2, 16, True, 0, None, torch.bfloat16),
    (2, 129, 129, 2, 1, 96, True, 0, None, torch.bfloat16),
    (1, 520, 520, 3, 3, 48, True, 0, None, torch.bfloat16),
    (1, 256, 256, 2, 1, 128, True, 0, None, torch.bfloat16),
    (2, 190, 190, 5, 1, 112, False, 0, 150, torch.bfloat16),
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernel_matches_plain(dev, case):
    b, s, t, h, kh, d, causal, off, valid, dt = case
    g = torch.Generator(device=dev).manual_seed(sum(case[:6]))
    q, k, v = (torch.randn(shape, generator=g, device=dev).to(dt)
               for shape in ((b, s, h, d), (b, t, kh, d), (b, t, kh, d)))
    kw = dict(causal=causal, q_offset=off, kv_valid_len=valid)
    got = FA.flash_attention(q, k, v, **kw)
    want = FA.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert got.dtype == dt and got.shape == q.shape
    assert _build.launches["flash_attention_fwd"] == 1
    var = FA.variant(dt, s, h // kh, d)
    assert _build.launches[f"flash_attention_fwd.{var}"] == 1
    got, want = got.float(), want.float()
    # both sum in float32 in different orders; a bf16 output may then round
    # to the neighbouring value: at most one bf16 step, 2^-7 relative
    tol = (want.abs() * 2.0 ** -7 + 1e-5 if dt == torch.bfloat16
           else torch.full_like(want, 1e-5))
    assert bool(((got - want).abs() <= tol).all()), \
        float((got - want).abs().max())


def test_flash_float32_prefill_takes_the_scalar_kernel_and_decode_dec(dev):
    g = torch.Generator(device=dev).manual_seed(9)
    q32 = torch.randn((2, 128, 8, 128), generator=g, device=dev)
    k32 = torch.randn((2, 128, 4, 128), generator=g, device=dev)
    FA.flash_attention(q32, k32, k32)                       # float32 prefill
    q1 = q32[:, :1].contiguous().to(torch.bfloat16)
    k16 = k32.to(torch.bfloat16)
    FA.flash_attention(q1, k16, k16, q_offset=127)          # decode step
    torch.cuda.synchronize()
    assert _build.launches["flash_attention_fwd.scalar"] == 1
    assert _build.launches["flash_attention_fwd.dec"] == 1
    assert _build.launches["flash_attention_fwd.tc"] == 0


# (B, S, T, H, K, D, causal, q_offset, kv_valid_len) through the dec kernel,
# each in all three dtypes: kv_valid_len = 1 (every other key, warp and
# split of the row sees no valid key), a split all masked for row 0 (query
# 63 against keys 64 to 78), kv_len one key past two tiles and a split,
# qwen3-0.6b's decode shape, g = 1, 2, 3, 5, 8, 12, S * g from 1 to 16 with
# S up to 16 under causal masks with q_offset > 0, D = 8, 32, 64, 80, 96,
# 112, 128 and 256 (each lanes-per-key and output-group case of each
# element size), non-causal with kv_valid_len < T
FLASH_DEC_CASES = [
    (2, 1, 300, 4, 2, 64, True, 299, 1),
    (1, 16, 200, 1, 1, 64, True, 63, None),
    (1, 1, 129, 2, 2, 128, True, 128, 129),
    (4, 1, 2080, 16, 8, 128, True, 2079, 2080),
    (2, 1, 2080, 8, 8, 112, True, 2079, 2080),
    (1, 1, 400, 12, 1, 128, True, 399, 400),
    (1, 2, 300, 16, 2, 64, True, 250, 252),
    (2, 16, 90, 2, 2, 32, True, 70, 86),
    (1, 8, 333, 4, 2, 256, True, 300, 308),
    (3, 1, 2080, 4, 4, 8, True, 2079, 2080),
    (2, 5, 150, 3, 1, 80, False, 0, 140),
    (1, 1, 1000, 5, 1, 128, True, 999, 1000),
    (1, 3, 65, 6, 2, 96, True, 62, None),
    (1, 4, 2000, 4, 4, 256, True, 1500, 1504),
]


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16,
                                torch.float16], ids=str)
@pytest.mark.parametrize("case", FLASH_DEC_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_flash_dec_kernel_matches_plain(dev, case, dt):
    """The dec kernel against the plain version: 1e-5 absolute, plus one
    step of a 16-bit output (2^-7 bf16, 2^-10 float16) where the two
    float32 results round to neighbours; one launch, on "dec" alone."""
    b, s, t, h, kh, d, causal, off, valid = case
    assert FA.variant(dt, s, h // kh, d) == "dec"
    g = torch.Generator(device=dev).manual_seed(sum(case[:6]))
    q, k, v = (torch.randn(shape, generator=g, device=dev).to(dt)
               for shape in ((b, s, h, d), (b, t, kh, d), (b, t, kh, d)))
    kw = dict(causal=causal, q_offset=off, kv_valid_len=valid)
    got = FA.flash_attention(q, k, v, **kw)
    want = FA.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert got.dtype == dt and got.shape == q.shape
    assert {v_: _build.launches[f"flash_attention_fwd.{v_}"]
            for v_ in ("tc", "scalar", "dec")} == dict(tc=0, scalar=0, dec=1)
    step = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}.get(dt, 0.)
    got, want = got.float(), want.float()
    assert bool(((got - want).abs() <= want.abs() * step + 1e-5).all()), \
        float((got - want).abs().max())


def test_flash_kernel_refuses_bad_head_dim(dev):
    q = torch.zeros((1, 4, 2, 12), device=dev)
    with pytest.raises(ValueError, match="multiple of 8"):
        FA.flash_attention(q, q, q)


def test_flash_kernel_refuses_head_dim_above_its_limit(dev):
    q = torch.zeros((1, 4, 2, 264), device=dev)
    with pytest.raises(ValueError, match="up to 256"):
        FA.flash_attention(q, q, q)


# (B, S, T, H, K, D, q_offset, kv_valid_len, variant): a prefill (scalar),
# a decode step against a longer cache and a short call (dec)
FLASH_F16_CASES = [
    (2, 77, 77, 4, 2, 128, 0, None, "scalar"),
    (2, 1, 300, 8, 2, 64, 299, 300, "dec"),
    (1, 3, 700, 2, 2, 80, 697, 700, "dec"),
]


@pytest.mark.parametrize("case", FLASH_F16_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_flash_float16_runs_the_scalar_and_dec_kernels(dev, case):
    """float16 runs the scalar or the dec kernel (the tc kernel is bf16
    only), held like bf16 to the plain version: 1e-5, plus one float16
    step (2^-10 relative) where the two float32 results round to
    neighbours."""
    b, s, t, h, kh, d, off, valid, var = case
    g = torch.Generator(device=dev).manual_seed(sum(case[:6]))
    q, k, v = (torch.randn(shape, generator=g, device=dev).half()
               for shape in ((b, s, h, d), (b, t, kh, d), (b, t, kh, d)))
    assert FA.variant(torch.float16, s, h // kh, d) == var
    kw = dict(q_offset=off, kv_valid_len=valid)
    got = FA.flash_attention(q, k, v, **kw)
    want = FA.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert got.dtype == torch.float16 and got.shape == q.shape
    assert _build.launches[f"flash_attention_fwd.{var}"] == 1
    assert _build.launches["flash_attention_fwd.tc"] == 0
    got, want = got.float(), want.float()
    tol = want.abs() * 2.0 ** -10 + 1e-5
    assert bool(((got - want).abs() <= tol).all()), \
        float((got - want).abs().max())


def test_lm_on_card_matches_cpu_and_launches_once_per_layer(dev):
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import lm, transformer

    cfg = dataclasses.replace(configs.get("qwen3-0.6b").reduced(),
                              use_flash=True)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16))
                            .astype(np.int32))
    out = {}
    for device in ("cpu", "cuda"):
        model = lm.init_params(cfg, device="cpu").to(device)
        _build.reset_launches()
        logits, caches = lm.prefill_step(
            model, {"tokens": toks[:, :12].to(device)}, cfg)
        n_prefill = _build.launches["flash_attention_fwd"]
        big = transformer.init_decode_caches(cfg, 2, 16, device=device)
        for key in "kv":
            big[key][:, :, :12] = caches[key]
        steps = [logits]
        for pos in range(12, 16):
            tok = toks[:, pos].to(device)
            logits, big = lm.decode_step(model, big,
                                         {"token": tok, "pos": pos}, cfg)
            steps.append(logits)
        out[device] = torch.stack(steps).cpu()
        if device == "cuda":
            assert n_prefill == cfg.n_layers
            assert _build.launches["flash_attention_fwd"] == \
                cfg.n_layers * 5
    assert torch.allclose(out["cuda"], out["cpu"], atol=1e-4, rtol=0)


# (B, S, H, hd, w, s0 scale): ragged S around the rec kernel's 24-step
# chunk at hd 64 (S = 1, 63, 65, 100), hd 16 and 128, strong decay (w
# about 0.03) and w = 0 exactly, nonzero s0, grids under one wave (column
# tiles) and a full wave of whole heads at hd 128 (blocks of 1024 threads);
# each runs the variant its length picks (dec for one step, tc from 64
# steps up)
WKV_CASES = [
    (4, 1, 40, 64, "model", 0.5),
    (2, 63, 8, 64, "model", 0.0),
    (2, 65, 8, 64, "model", 0.5),
    (1, 100, 3, 64, "model", 0.5),
    (3, 50, 4, 16, "model", 0.5),
    (2, 40, 4, 128, "model", 0.5),
    (2, 64, 4, 64, "strong", 0.0),
    (2, 64, 4, 64, "zero", 0.5),
    (1, 300, 2, 64, "model", 0.5),
    (160, 5, 1, 32, "model", 0.5),
    (33, 30, 4, 128, "model", 0.5),
]
# (B, S, H, hd, w, s0 scale) through the tc kernel (S >= 64): one chunk, a
# chunk and a step, 2049 (32 chunks and one of a step), every hd, w = 0
# every third step, strong decay, B * H = 6 blocks (under one wave) and the
# prefill's 160 blocks of hd 64
WKV_TC_CASES = [
    (2, 64, 3, 64, "model", 0.5),
    (2, 65, 3, 64, "model", 0.5),
    (1, 2049, 4, 64, "model", 0.5),
    (2, 100, 3, 16, "model", 0.5),
    (2, 130, 3, 32, "model", 0.5),
    (2, 100, 3, 128, "model", 0.5),
    (1, 2049, 2, 128, "zero", 0.5),
    (2, 300, 3, 64, "zero", 0.5),
    (2, 300, 3, 64, "strong", 0.0),
    (1, 65, 2, 16, "strong", 0.5),
    (4, 256, 40, 64, "model", 0.5),
]


def _wkv_inputs(case, dev):
    b, s, h, hd, decay, s0_scale = case
    g = torch.Generator(device=dev).manual_seed(sum(case[:4]))
    r, k, v, logit = (torch.randn((b, s, h, hd), generator=g, device=dev)
                      for _ in range(4))
    if decay == "near1":
        w = 1.0 - 1e-6 * torch.rand((b, s, h, hd), generator=g, device=dev)
    else:
        w = torch.exp(-torch.exp(logit * 0.5 + (1.25 if decay == "strong"
                                                 else -2.0)))
    if decay == "zero":
        w[:, ::3] = 0.0
    u = 0.1 * torch.randn((h, hd), generator=g, device=dev)
    s0 = s0_scale * torch.randn((b, h, hd, hd), generator=g, device=dev)
    return r, k, v, w, u, s0


def _wkv_close(got, want):
    """Within 1e-5 of the largest magnitude of y (of the state, for the
    state): the same float32 recurrence, the sum over i in another order
    (rec) or as the chunk's products (tc)."""
    for g, w in zip(got, want):
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        err = float((g - w).abs().max())
        assert err <= 1e-5 * float(w.abs().max()), err


def _wkv_ran(var):
    torch.cuda.synchronize()
    assert _build.launches["rwkv6_wkv"] == 1
    assert _build.launches[f"rwkv6_wkv.{var}"] == 1


@pytest.mark.parametrize("case", WKV_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_wkv_kernel_matches_plain(dev, case):
    args = _wkv_inputs(case, dev)
    got = W.wkv(*args)
    _wkv_ran(W.variant(case[1], case[3]))
    _wkv_close(got, W.wkv_plain(*args))


# (B, S = 1, H, hd, w, s0 scale) through the dec kernel: rwkv6-3b's decode
# shape, every hd, one warp in all (B * H * hd / 16 = 1), grids under a
# wave and over one (1056 and 5120 warps), w = 0, strong decay, s0 zero
WKV_DEC_CASES = [
    (4, 1, 40, 64, "model", 0.5),
    (2, 1, 3, 16, "model", 0.5),
    (2, 1, 3, 32, "model", 0.5),
    (1, 1, 2, 128, "model", 0.5),
    (1, 1, 1, 16, "model", 1.0),
    (33, 1, 4, 128, "model", 0.5),
    (32, 1, 40, 64, "model", 0.5),
    (2, 1, 4, 64, "zero", 0.5),
    (2, 1, 4, 64, "strong", 0.5),
    (3, 1, 5, 64, "model", 0.0),
]


@pytest.mark.parametrize("case", WKV_DEC_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_wkv_dec_kernel_matches_plain(dev, case):
    args = _wkv_inputs(case, dev)
    s0 = args[-1].clone()
    assert W.variant(case[1], case[3]) == "dec"
    y, st = W.wkv(*args)
    _wkv_ran("dec")
    _wkv_close((y, st), W.wkv_plain(*args))
    assert torch.equal(args[-1], s0) and st.data_ptr() != s0.data_ptr()
    if case[4] == "zero":                  # w = 0: s0 forgotten
        k, v = args[1][:, 0], args[2][:, 0]
        assert torch.equal(st, k[..., :, None] * v[..., None, :])


def test_wkv_dec_kernel_refuses_a_misaligned_state(dev):
    """dec reads s0 in 16-byte groups: a state one float into its storage
    is refused, and nothing launches (rec, S = 2, still takes it)."""
    r, k, v, w, u, s0 = _wkv_inputs((2, 1, 3, 64, "model", 0.5), dev)
    buf = torch.empty(s0.numel() + 1, device=dev)
    bad = buf[1:].view(s0.shape)
    bad.copy_(s0)
    assert bad.is_contiguous() and bad.data_ptr() % 16 == 4
    with pytest.raises(ValueError, match="s0: .*16-byte"):
        W.wkv(r, k, v, w, u, bad)
    assert not _build.launches
    args2 = _wkv_inputs((2, 2, 3, 64, "model", 0.5), dev)
    _wkv_close(W.wkv(*args2[:-1], bad), W.wkv_plain(*args2[:-1], s0))
    _wkv_ran("rec")


@pytest.mark.parametrize("case", WKV_TC_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_wkv_tc_kernel_matches_plain(dev, case):
    args = _wkv_inputs(case, dev)
    assert W.variant(case[1], case[3]) == "tc"
    got = W.wkv(*args)
    _wkv_ran("tc")
    _wkv_close(got, W.wkv_plain(*args))


def test_wkv_tc_kernel_forgets_the_past_exactly_at_zero_decay(dev):
    """w = 0 at step 70: y from step 71 on and the final state do not
    depend on r, k, v before step 70 or on s0, bit for bit."""
    r, k, v, w, u, s0 = _wkv_inputs((2, 200, 3, 64, "model", 0.5), dev)
    w[:, 70] = 0.0
    y, st = W.wkv(r, k, v, w, u, s0)
    r2, k2, v2 = (x.clone() for x in (r, k, v))
    for x in (r2, k2, v2):
        x[:, :70] = torch.randn_like(x[:, :70])
    y2, st2 = W.wkv(r2, k2, v2, w, u, torch.randn_like(s0))
    torch.cuda.synchronize()
    assert torch.equal(y[:, 71:], y2[:, 71:]) and torch.equal(st, st2)


def test_wkv_tc_kernel_near_one_decay_against_float64(dev):
    """S = 2048, w within 1e-6 of 1, s0 random: the float32 recurrence
    drifts some 4e-6 to 7e-6 from a float64 one (tests/test_torch_wkv.py),
    so the tc kernel is held to float64 here."""
    args = _wkv_inputs((1, 2048, 4, 64, "near1", 1.0), dev)
    got = W.wkv(*args)
    _wkv_ran("tc")
    r, k, v, w, u, st = (t.double() for t in args)
    y = torch.empty_like(r)
    for t in range(r.shape[1]):
        vt = v[:, t, :, None, :]
        y[:, t] = torch.einsum("bhi,bhij->bhj", r[:, t],
                               (u * k[:, t])[:, :, :, None] * vt + st)
        st = w[:, t, :, :, None] * st + k[:, t, :, :, None] * vt
    _wkv_close(got, (y, st))


def test_wkv_kernel_with_no_steps_returns_the_state(dev):
    r, k, v, w, u, s0 = _wkv_inputs((2, 0, 3, 64, "model", 1.0), dev)
    y, st = W.wkv(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert y.shape == (2, 0, 3, 64) and torch.equal(st, s0)


@pytest.mark.parametrize("s", [1, 100])
def test_wkv_kernels_refuse_head_sizes_they_are_not_built_for(dev, s):
    """hd 24 computes on the CPU (tests/test_torch_wkv.py); on the card
    neither kernel is built for it, and nothing falls back."""
    r, k, v, w, u, s0 = _wkv_inputs((1, s, 2, 24, "model", 0.5), dev)
    with pytest.raises(ValueError, match=r"head_dim 24.*\(16, 32, 64, 128\)"):
        W.wkv(r, k, v, w, u, s0)
    assert not _build.launches


@pytest.mark.parametrize("hd, n", [(24, 16), (16, 8)])
def test_ssd_kernels_refuse_sizes_they_are_not_built_for(dev, hd, n):
    """hd 24 or N 8 computes on the CPU (tests/test_torch_ssd.py); on the
    card neither kernel is built for it, and nothing falls back."""
    args = _ssd_inputs((1, 70, 2, hd, n, "model", "random", False), dev)
    with pytest.raises(ValueError, match=r"\(16, 32, 64, 128\)"):
        SSD.ssd(*args)
    assert not _build.launches


def test_rwkv_on_card_matches_cpu_and_launches_once_per_layer(dev):
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import lm

    cfg = dataclasses.replace(configs.get("rwkv6-3b").reduced(),
                              use_flash=True)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16))
                            .astype(np.int32))
    out = {}
    for device in ("cpu", "cuda"):
        model = lm.init_params(cfg, device="cpu").to(device)
        _build.reset_launches()
        logits, caches = lm.prefill_step(
            model, {"tokens": toks[:, :12].to(device)}, cfg)
        n_prefill = _build.launches["rwkv6_wkv"]
        steps = [logits]
        for pos in range(12, 16):
            logits, caches = lm.decode_step(
                model, caches, {"token": toks[:, pos].to(device),
                                "pos": pos}, cfg)
            steps.append(logits)
        out[device] = (torch.stack(steps).cpu(),
                       [caches[k].cpu() for k in sorted(caches)])
        if device == "cuda":
            assert n_prefill == cfg.n_layers
            assert _build.launches["rwkv6_wkv"] == cfg.n_layers * 5
    assert torch.allclose(out["cuda"][0], out["cpu"][0], atol=1e-4, rtol=0)
    for got, want in zip(out["cuda"][1], out["cpu"][1]):
        assert torch.allclose(got, want, atol=1e-4, rtol=1e-5)


# (B, S, H, hd, N, dt, s0): the zamba2-7b decode shape (S = 1), S = 0 and
# S = 2049 (ragged against every chunk of the kernel's staging), odd H with
# hd = N = 16, mixed hd and N, dt tiny (the state barely moves) and huge
# (the decay underflows to 0), s0 zero, and a batch stride that is not
# contiguous
SSD_CASES = [
    (4, 1, 112, 64, 64, "model", "random", False),
    (2, 0, 3, 64, 64, "model", "random", False),
    (1, 2049, 8, 64, 64, "model", "random", False),
    (2, 65, 5, 16, 16, "model", "random", False),
    (2, 40, 3, 32, 128, "model", "random", False),
    (1, 30, 2, 128, 16, "model", "random", False),
    (2, 100, 4, 64, 64, "tiny", "random", False),
    (2, 100, 4, 64, 64, "huge", "random", False),
    (1, 300, 2, 64, 64, "model", "zero", False),
    (3, 40, 7, 64, 64, "model", "random", True),
]


def _ssd_inputs(case, dev):
    """x, b, c ~ N(0, 1); dt log-uniform in [1e-3, 1e-1] (``mamba2_init``),
    about 1e-6 (tiny), 5 to 20 (huge) or 0; a = -linspace(1, 16, H); d ~
    N(0, 1); s0 N(0, 1) or zero; with ``strided`` x, b, c and dt are every
    other sequence of a batch twice as large."""
    b, s, h, hd, n, dt, s0, strided = case
    g = torch.Generator(device=dev).manual_seed(sum(case[:5]))
    bb = 2 * b if strided else b

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    x, bm, cm = randn(bb, s, h, hd), randn(bb, s, n), randn(bb, s, n)
    u = torch.rand((bb, s, h), generator=g, device=dev)
    if dt == "model":
        dtv = torch.exp(math.log(1e-3) + u * math.log(100.0))
    elif dt == "tiny":
        dtv = 1e-6 * (0.5 + u)
    elif dt == "zero":
        dtv = torch.zeros_like(u)
    else:
        dtv = 5.0 + 15.0 * u
    if strided:
        x, bm, cm, dtv = x[::2], bm[::2], cm[::2], dtv[::2]
    a = -torch.linspace(1.0, 16.0, h, device=dev)
    d = randn(h)
    st = randn(b, h, n, hd) if s0 == "random" else torch.zeros(
        (b, h, n, hd), device=dev)
    return x, bm, cm, dtv, a, d, st


@pytest.mark.parametrize("case", SSD_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_ssd_kernel_matches_plain(dev, case):
    args = _ssd_inputs(case, dev)
    y, st = SSD.ssd(*args)
    py, pst = SSD.ssd_plain(*args)
    torch.cuda.synchronize()
    assert _build.launches["mamba2_ssd"] == 1
    assert y.shape == py.shape and st.shape == pst.shape
    # the same float32 recurrence, the sum over N in another order
    for got, want in ((y, py), (st, pst)):
        assert bool(torch.isfinite(got).all())
        err = float((got - want).abs().max()) if got.numel() else 0.0
        scale = float(want.abs().max()) if want.numel() else 0.0
        assert err <= 1e-5 * scale, err


def test_ssd_kernel_with_no_steps_returns_the_state(dev):
    args = _ssd_inputs((2, 0, 3, 64, 64, "model", "random", False), dev)
    y, st = SSD.ssd(*args)
    torch.cuda.synchronize()
    assert y.shape == (2, 0, 3, 64) and torch.equal(st, args[-1])
    assert _build.launches["mamba2_ssd"] == 1


def test_ssd_kernel_writes_the_state_in_place(dev):
    """A decode step: s0 and ``state_out`` are the same cache tensor."""
    args = _ssd_inputs((4, 1, 112, 64, 64, "model", "random", False), dev)
    py, pst = SSD.ssd_plain(*args)
    cache = args[-1].clone()
    y, st = SSD.ssd(*args[:-1], cache, state_out=cache)
    torch.cuda.synchronize()
    assert st is cache
    assert float((cache - pst).abs().max()) <= 1e-5 * float(pst.abs().max())
    assert float((y - py).abs().max()) <= 1e-5 * float(py.abs().max())


# (B, S, H, hd, N, dt, s0, strided) through the tc kernel (S >= 64): one
# chunk, one chunk and a step, one step short of two, ragged S = 300 and
# 2049, the model's strided layout, dt tiny, huge and 0, and every (hd, N)
SSD_TC_CASES = [
    (2, 64, 3, 64, 64, "model", "random", False),
    (2, 65, 3, 64, 64, "model", "random", False),
    (1, 127, 4, 64, 64, "model", "random", False),
    (1, 300, 2, 64, 64, "model", "zero", False),
    (1, 2049, 4, 64, 64, "model", "random", False),
    (3, 96, 7, 64, 64, "model", "random", True),
    (2, 100, 4, 64, 64, "tiny", "random", False),
    (2, 100, 4, 64, 64, "huge", "random", False),
    (2, 100, 4, 64, 64, "zero", "random", False),
] + [(1, 100, 3, hd, n, "model", "random", False)
     for hd in SSD.SIZES for n in SSD.SIZES]


def _ssd_close(got, want):
    """Within 1e-5 of the largest magnitude of y (of the state, for the
    state): the float32 recurrence, here as the chunked form with three
    TF32 products per product."""
    for g, w in zip(got, want):
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        err = float((g - w).abs().max())
        assert err <= 1e-5 * float(w.abs().max()), err


def _ran(var):
    torch.cuda.synchronize()
    assert _build.launches["mamba2_ssd"] == 1
    assert _build.launches[f"mamba2_ssd.{var}"] == 1


@pytest.mark.parametrize("case", SSD_TC_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_ssd_tc_kernel_matches_plain(dev, case):
    args = _ssd_inputs(case, dev)
    assert SSD.variant(case[1], case[3], case[4]) == "tc"
    got = SSD.ssd(*args)
    _ran("tc")
    _ssd_close(got, SSD.ssd_plain(*args))
    if case[5] == "zero":          # e^0 = 1 and no input: s0 exactly
        assert torch.equal(got[1], args[-1])


@pytest.mark.parametrize("s", [1, 63])
def test_ssd_short_calls_run_the_recurrence(dev, s):
    args = _ssd_inputs((2, s, 5, 64, 64, "model", "random", False), dev)
    got = SSD.ssd(*args)
    _ran("rec")
    _ssd_close(got, SSD.ssd_plain(*args))


def test_ssd_tc_kernel_writes_the_state_in_place(dev):
    args = _ssd_inputs((2, 130, 5, 64, 64, "model", "random", False), dev)
    want = SSD.ssd_plain(*args)
    cache = args[-1].clone()
    y, st = SSD.ssd(*args[:-1], cache, state_out=cache)
    _ran("tc")
    assert st is cache
    _ssd_close((y, cache), want)


def test_ssd_tc_kernel_takes_rows_off_16_byte_alignment(dev):
    """x, b and c as views one float into wider rows: their rows are not
    16-byte aligned, so the tc kernel stages them 4 bytes at a time."""
    x, bm, cm, dtv, a, d, st = _ssd_inputs(
        (2, 130, 3, 64, 64, "model", "random", False), dev)
    pad = torch.zeros((2, 130, 1), device=dev)
    xv = torch.cat([pad, x.flatten(2)], -1)[..., 1:].unflatten(-1, (3, 64))
    bv = torch.cat([pad, bm], -1)[..., 1:]
    cv = torch.cat([pad, cm], -1)[..., 1:]
    assert xv.data_ptr() % 16 and bv.data_ptr() % 16 and cv.data_ptr() % 16
    got = SSD.ssd(xv, bv, cv, dtv, a, d, st)
    _ran("tc")
    _ssd_close(got, SSD.ssd_plain(x, bm, cm, dtv, a, d, st))


def test_ssd_tc_kernel_long_tiny_dt_against_float64(dev):
    """S = 2048, dt about 1e-6, s0 random: the float32 recurrence drifts
    some 3e-5 from a float64 one (2048 roundings of e^{dt a} near 1;
    tests/test_torch_ssd.py), so the tc kernel is held to float64 here."""
    args = _ssd_inputs((1, 2048, 4, 64, 64, "tiny", "random", False), dev)
    got = SSD.ssd(*args)
    _ran("tc")
    x, bm, cm, dtv, a, d, st = (t.double() for t in args)
    y = torch.empty_like(x)
    for t in range(x.shape[1]):
        st = (torch.exp(dtv[:, t] * a)[:, :, None, None] * st
              + bm[:, t, None, :, None]
              * (dtv[:, t, :, None] * x[:, t])[:, :, None, :])
        y[:, t] = (torch.einsum("bn,bhnp->bhp", cm[:, t], st)
                   + d[:, None] * x[:, t])
    _ssd_close(got, (y, st))


@pytest.mark.parametrize("attn_every", [2, 0])
def test_zamba_on_card_matches_cpu_and_launches_once_per_layer(
        dev, attn_every):
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import lm, transformer

    cfg = dataclasses.replace(configs.get("zamba2-7b").reduced(),
                              use_flash=True, attn_every=attn_every)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 20))
                            .astype(np.int32))
    napps = transformer.n_shared_apps(cfg)
    out = {}
    for device in ("cpu", "cuda"):
        model = lm.init_params(cfg, device="cpu").to(device)
        _build.reset_launches()
        logits, pre = lm.prefill_step(
            model, {"tokens": toks[:, :16].to(device)}, cfg)
        launched = dict(_build.launches)
        caches = transformer.init_decode_caches(cfg, 2, 20, device=device)
        for key in caches:
            if key in "kv":
                caches[key][:, :, :16] = pre[key]
            else:
                caches[key].copy_(pre[key])
        steps = [logits]
        for pos in range(16, 20):
            logits, caches = lm.decode_step(
                model, caches, {"token": toks[:, pos].to(device),
                                "pos": pos}, cfg)
            steps.append(logits)
        out[device] = (torch.stack(steps).cpu(),
                       [caches[k].cpu() for k in sorted(caches)])
        if device == "cuda":
            assert launched.get("mamba2_ssd") == cfg.n_layers
            assert launched.get("flash_attention_fwd", 0) == napps
            assert _build.launches["mamba2_ssd"] == cfg.n_layers * 5
            assert _build.launches.get("flash_attention_fwd", 0) == \
                napps * 5
    assert torch.allclose(out["cuda"][0], out["cpu"][0], atol=1e-4, rtol=0)
    for got, want in zip(out["cuda"][1], out["cpu"][1]):
        assert torch.allclose(got, want, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("linkage", ["single", "complete", "average"])
def test_hac_torch_on_card_equals_cpu(dev, linkage):
    """hac_torch on the card gives the CPU's Z bit for bit (the same float32
    operations, the average update's fused multiply-add emulated exactly),
    and hac_numpy's merges (distances within 1e-5)."""
    from repro_torch.core import hac

    rng = np.random.default_rng(11)
    bitmaps = rng.integers(0, 2 ** 32, (96, 3), dtype=np.uint32)
    bitmaps[::5] = 0
    bitmaps[::7] = bitmaps[1::7][:len(bitmaps[::7])]
    jd = jac.jaccard_distance(bitmaps, device="cpu").numpy()
    rd = rng.random((128, 128)).astype(np.float32)
    rd = (rd + rd.T) / 2
    np.fill_diagonal(rd, 0)
    for d in (jd, rd):
        z = hac.hac_torch(d, linkage, device=dev)
        assert z.device.type == "cuda"
        z = z.cpu().numpy()
        np.testing.assert_array_equal(
            z, hac.hac_torch(d, linkage, device="cpu").numpy())
        want = hac.hac_numpy(d.astype(np.float64), linkage)
        np.testing.assert_array_equal(z[:, [0, 1, 3]], want[:, [0, 1, 3]])
        np.testing.assert_allclose(z[:, 2], want[:, 2], rtol=0, atol=1e-5)


def test_serve_cli_on_card_equals_cpu(dev):
    """``python -m repro_torch.launch.serve`` on the card (the default) and
    with ``--device cpu`` print the same experiment lines and rewrite."""
    import os
    import subprocess
    import sys

    src = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
    env = dict(os.environ, PYTHONPATH=src)
    out = {}
    for extra in ((), ("--device", "cpu")):
        run = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve",
             "--universities", "1", "--shards", "4", "--experiment", "1",
             "--migration-budget", "120000", "--show-federated", *extra],
            env=env, capture_output=True, text=True, timeout=600)
        assert run.returncode == 0, run.stderr
        out[extra] = run.stdout
    assert "device=cuda" in out[()]
    assert "device=cpu" in out["--device", "cpu"]
    # past the first line (load time, device): every line the same
    card, cpu = (o.split("\n", 1)[1] for o in out.values())
    assert card == cpu and "[exp1]" in card and "SERVICE" in card


# --------------------------------------------------------------------------- #
# mixture-of-experts serving
# --------------------------------------------------------------------------- #

def _moe_routes(moe_mod, calls):
    """Wrap ``moe_mod._router`` to append each call's sorted top-k ids (on
    the host) to ``calls``; returns the original."""
    router = moe_mod._router

    def recording(p, x2d, cfg):
        out = router(p, x2d, cfg)
        calls.append(torch.sort(out[1], -1).values.cpu())
        return out
    moe_mod._router = recording
    return router


@pytest.mark.parametrize("experts", [(8, 2), (16, 8)], ids=str)
def test_moe_layer_on_card_matches_cpu(dev, experts):
    """The MoE layer in float32: the same routes, values within 1e-5 of the
    CPU's; migrated twice on the card, bit for bit its unplaced output."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.core import placement
    from repro_torch.models import lm, moe

    e, k = experts
    cfg = dataclasses.replace(configs.get("olmoe-1b-7b").reduced(),
                              n_experts=e, top_k=k)
    layer = lm.init_params(cfg, device="cpu").blocks[0].moe
    x = torch.randn((3, 40, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    out, routes = {}, {}
    for device in ("cpu", "cuda"):
        calls = []
        router = _moe_routes(moe, calls)
        try:
            out[device] = moe.moe_apply(layer.to(device), x.to(device), cfg)
        finally:
            moe._router = router
        routes[device] = calls
    assert torch.equal(routes["cuda"][0], routes["cpu"][0])
    assert torch.allclose(out["cuda"][0].cpu(), out["cpu"][0], atol=1e-5,
                          rtol=0)
    assert abs(float(out["cuda"][1]) - float(out["cpu"][1])) <= 1e-6
    rng = np.random.default_rng(2)
    for _ in range(2):
        perm = rng.permutation(np.repeat(np.arange(2), e // 2))
        layer.load_state_dict(placement.apply_expert_placement(
            layer.state_dict(), perm.astype(np.int32)))
        y, aux = moe.moe_apply(layer, x.to(dev), cfg)
        assert torch.equal(y, out["cuda"][0])
        assert torch.equal(aux, out["cuda"][1])


@pytest.mark.parametrize("experts", [64, 128])
def test_placement_with_the_jaccard_kernel_equals_the_cpu_plan(dev, experts):
    """``plan_expert_placement`` with its Jaccard matrix on the card: one
    launch, and the CPU's map and report exactly."""
    from repro_torch.core import placement

    rng = np.random.default_rng(experts)
    topics = rng.permutation(experts).reshape(-1, 8)
    routing = np.stack([rng.permutation(topics[rng.integers(len(topics))])
                        for _ in range(2048)])
    noise = rng.random(routing.shape) < 0.1
    routing[noise] = rng.integers(0, experts, int(noise.sum()))
    got = placement.plan_expert_placement(routing, experts, 16, None, 4096,
                                          device=dev)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {"jaccard": 1, "jaccard.tile": 1}
    want = placement.plan_expert_placement(routing, experts, 16, None, 4096,
                                           device="cpu")
    assert np.array_equal(got[0], want[0]) and got[1] == want[1]
    assert got[1].accepted


def test_moe_lm_on_card_matches_cpu_and_launches_once_per_layer(dev):
    """Reduced qwen3-moe-30b-a3b in float32, prefill and 4 decode steps:
    flash once a layer in each, the same routes and logits within 1e-4 of
    the CPU's."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import lm, moe, transformer

    cfg = dataclasses.replace(configs.get("qwen3-moe-30b-a3b").reduced(),
                              use_flash=True)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32))
    out, routes = {}, {}
    for device in ("cpu", "cuda"):
        model = lm.init_params(cfg, device="cpu").to(device)
        calls = []
        router = _moe_routes(moe, calls)
        try:
            _build.reset_launches()
            logits, caches = lm.prefill_step(
                model, {"tokens": toks[:, :12].to(device)}, cfg)
            n_prefill = _build.launches["flash_attention_fwd"]
            big = transformer.init_decode_caches(cfg, 2, 16, device=device)
            for key in "kv":
                big[key][:, :, :12] = caches[key]
            steps = [logits]
            for pos in range(12, 16):
                logits, big = lm.decode_step(
                    model, big, {"token": toks[:, pos].to(device),
                                 "pos": pos}, cfg)
                steps.append(logits)
        finally:
            moe._router = router
        out[device] = torch.stack(steps).cpu()
        routes[device] = calls
        if device == "cuda":
            assert n_prefill == cfg.n_layers
            assert _build.launches["flash_attention_fwd"] == \
                cfg.n_layers * 5
    assert len(routes["cuda"]) == cfg.n_layers * 5
    for got, want in zip(routes["cuda"], routes["cpu"]):
        assert torch.equal(got, want)
    assert torch.allclose(out["cuda"], out["cpu"], atol=1e-4, rtol=0)


# qwen3-moe-30b-a3b's attention: 32 query heads on 4 kv heads, a GQA group
# of 8: its prefill through "tc" (S and T off the 64-key tile too), its
# decode step through "dec" (8 rows a kv head) in each dtype
GQA8_CASES = [
    (2, 256, 256, 32, 4, 128, True, 0, None, torch.bfloat16, "tc"),
    (1, 100, 130, 32, 4, 128, True, 30, None, torch.bfloat16, "tc"),
    (4, 1, 2080, 32, 4, 128, True, 2079, 2080, torch.bfloat16, "dec"),
    (2, 1, 700, 32, 4, 128, True, 650, 651, torch.float32, "dec"),
    (2, 2, 300, 32, 4, 128, True, 290, 292, torch.float16, "dec"),
]


@pytest.mark.parametrize("case", GQA8_CASES, ids=str)
def test_flash_at_gqa_8_matches_plain(dev, case):
    b, s, t, h, kh, d, causal, off, valid, dt, var = case
    g = torch.Generator(device=dev).manual_seed(sum(case[:6]))
    q, k, v = (torch.randn(shape, generator=g, device=dev).to(dt)
               for shape in ((b, s, h, d), (b, t, kh, d), (b, t, kh, d)))
    kw = dict(causal=causal, q_offset=off, kv_valid_len=valid)
    got = FA.flash_attention(q, k, v, **kw)
    want = FA.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert FA.variant(dt, s, h // kh, d) == var
    assert _build.launches[f"flash_attention_fwd.{var}"] == 1
    got, want = got.float(), want.float()
    step = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}.get(dt, 0)
    assert bool(((got - want).abs() <= want.abs() * step + 1e-5).all()), \
        float((got - want).abs().max())


# the flash backward's edges: GQA groups g = 1 to 8, D 8 and 256, S = 1,
# q_offset > 0, kv_valid_len < T, non-causal, S and T off the 32-row tiles;
# each in float32, bfloat16 and float16
FLASH_BWD_EDGES = [
    (2, 77, 77, 16, 8, 128, True, 0, None),
    (1, 33, 70, 4, 4, 64, True, 37, None),
    (2, 45, 45, 8, 1, 8, False, 0, 40),
    (1, 1, 50, 6, 2, 256, True, 49, 50),
    (1, 130, 200, 5, 1, 80, False, 0, 150),
    (2, 64, 100, 4, 2, 32, True, 36, 90),
    (1, 100, 100, 7, 1, 40, True, 0, None),
    (1, 40, 40, 2, 1, 256, True, 0, 23),
]
# bf16 edges the tc route takes (each also through the scalar route's
# float32 and float16): GQA g = 1, 2, 8 and 64, D 16 to 128 (80 and 112 off
# the 64-column boxes), S * g = 64, S = 1, T = 3, q_offset > 0,
# kv_valid_len < T (inside a 64-key warpgroup, and leaving the second
# warpgroup of a 128-key dkv block without keys), non-causal, S and T off
# the 64- and 128-row tiles
FLASH_BWD_TC_EDGES = [
    (2, 77, 77, 16, 8, 128, True, 0, None),
    (1, 32, 32, 4, 2, 64, True, 0, None),
    (1, 1, 40, 64, 1, 16, True, 39, None),
    (2, 65, 3, 4, 4, 32, False, 0, None),
    (1, 130, 200, 5, 1, 80, False, 0, 150),
    (2, 100, 170, 16, 2, 112, True, 70, 160),
    (1, 300, 300, 8, 1, 48, True, 0, 60),
    (1, 129, 257, 4, 2, 96, True, 128, None),
    (2, 64, 100, 4, 2, 32, True, 36, 90),
]
# each element within FLASH_BWD_REL of itself plus 2^-14 of its output's
# largest magnitude: float32 sums in another order from the same inputs,
# then one step of the output's dtype
FLASH_BWD_REL = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -7,
                 torch.float16: 2.0 ** -10}


def _bwd_close(got, want):
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        assert x.dtype == y.dtype and x.shape == y.shape, name
        y32 = y.float()
        diff = (x.float() - y32).abs()
        limit = (FLASH_BWD_REL[y.dtype] * y32.abs()
                 + 2.0 ** -14 * float(y32.abs().max()))
        assert bool((diff <= limit).all()), \
            (name, float(diff.max()), float((diff - limit).max()))


def _flash_bwd_inputs(case, dt, dev):
    b, s, t, h, kh, d, causal, off, valid = case
    g = torch.Generator(device=dev).manual_seed(sum(case[:6]))
    q, k, v, do = (torch.randn(shape, generator=g, device=dev).to(dt)
                   for shape in ((b, s, h, d), (b, t, kh, d), (b, t, kh, d),
                                 (b, s, h, d)))
    kw = dict(causal=causal, q_offset=off, kv_valid_len=valid)
    return q, k, v, FA.flash_attention(q, k, v, **kw), do, kw


def _bwd_route(q, k):
    b, s, h, d = q.shape
    return FA.bwd_variant(q.dtype, s, h // k.shape[2], d)


def _bwd_ran(route):
    """Each backward kernel launched once, on ``route`` alone."""
    want = {n: 1 for n in FA.BWD_KERNELS}
    for var in FA.BWD_VARIANTS:
        want.update({f"{n}.{var}": int(var == route)
                     for n in FA.BWD_KERNELS})
    assert {n: _build.launches[n] for n in want} == want, \
        dict(_build.launches)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16,
                                torch.float16], ids=str)
@pytest.mark.parametrize("case", FLASH_BWD_EDGES + FLASH_BWD_TC_EDGES,
                         ids=str)
def test_flash_bwd_kernels_match_plain(dev, case, dt):
    """dq, dk and dv of the three backward kernels against
    ``flash_attention_bwd_plain`` on the same inputs, each element within
    2^-14 of its output's largest magnitude plus, for bf16 and f16 (the
    outputs round to the dtype), 2^-7 or 2^-10 of itself; one launch of
    each kernel, all on the route ``bwd_variant`` gives."""
    q, k, v, o, do, kw = _flash_bwd_inputs(case, dt, dev)
    _build.reset_launches()
    got = FA.flash_attention_bwd(q, k, v, o, do, **kw)
    want = FA.flash_attention_bwd_plain(q, k, v, o, do, **kw)
    torch.cuda.synchronize()
    _bwd_ran(_bwd_route(q, k))
    assert all(x.dtype == dt for x in got)
    _bwd_close(got, want)


@pytest.mark.parametrize("case", FLASH_BWD_TC_EDGES, ids=str)
def test_flash_bwd_tc_route_gives_the_same_bits_twice(dev, case):
    """The tc kernels write every output element once, without atomics:
    two calls on the same inputs give equal bits."""
    q, k, v, o, do, kw = _flash_bwd_inputs(case, torch.bfloat16, dev)
    assert _bwd_route(q, k) == "tc"
    first = FA.flash_attention_bwd(q, k, v, o, do, **kw)
    second = FA.flash_attention_bwd(q, k, v, o, do, **kw)
    for x, y in zip(first, second):
        assert torch.equal(x, y)


@pytest.mark.parametrize("case, dt", [
    ((2, 77, 77, 16, 8, 128, True, 0, None), torch.float32),
    ((2, 77, 77, 16, 8, 128, True, 0, None), torch.float16),
    ((1, 200, 200, 4, 2, 144, True, 0, None), torch.bfloat16),   # D > 128
    ((1, 200, 200, 4, 2, 40, True, 0, None), torch.bfloat16),    # D % 16
    ((1, 63, 63, 2, 2, 64, True, 0, None), torch.bfloat16),      # S*g = 63
], ids=str)
def test_flash_bwd_outside_the_tc_rule_runs_the_scalar_kernels(dev, case,
                                                               dt):
    q, k, v, o, do, kw = _flash_bwd_inputs(case, dt, dev)
    assert _bwd_route(q, k) == "scalar"
    _build.reset_launches()
    got = FA.flash_attention_bwd(q, k, v, o, do, **kw)
    torch.cuda.synchronize()
    _bwd_ran("scalar")
    _bwd_close(got, FA.flash_attention_bwd_plain(q, k, v, o, do, **kw))


def test_flash_bwd_tc_kernels_refuse_what_they_do_not_take(dev):
    """The tc entry points raise on a dtype or head size outside their
    rule rather than run."""
    q, k, v, o, do, kw = _flash_bwd_inputs(FLASH_BWD_EDGES[0],
                                           torch.float32, dev)
    b, s, h, d = q.shape
    out = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v),
           torch.empty(3 * b * s * h, dtype=torch.float32, device=dev))
    with pytest.raises(RuntimeError, match="cudaError"):
        _build.launch("flash_attention_bwd_pre",
                      "rt_flash_attention_bwd_tc_pre", dev, q.data_ptr(),
                      k.data_ptr(), o.data_ptr(), do.data_ptr(),
                      out[3].data_ptr(), b, s, k.shape[1], h, k.shape[2], d,
                      1, 0, -1, 0)


def test_flash_autograd_on_card_runs_the_backward_kernels(dev):
    """A flash call that needs a gradient returns a tensor in the graph,
    and its backward launches the three kernels, once each."""
    q, k, v, _, do, kw = _flash_bwd_inputs(FLASH_BWD_EDGES[0],
                                           torch.bfloat16, dev)
    q, k, v = (x.clone().requires_grad_() for x in (q, k, v))
    o = FA.flash_attention(q, k, v, **kw)
    assert o.grad_fn is not None
    _build.reset_launches()
    o.backward(do)
    torch.cuda.synchronize()
    _bwd_ran("tc")
    want = FA.flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(),
                                        o.detach(), do, **kw)
    _bwd_close((q.grad, k.grad, v.grad), want)


def test_wkv_and_ssd_refuse_a_call_that_needs_a_gradient(dev):
    """No backward kernel yet: a CUDA call with grad enabled and an input
    that requires it raises, rather than return a tensor cut from the
    graph; under no_grad it runs."""
    g = torch.Generator(device=dev).manual_seed(3)
    b, s, h, hd = 1, 8, 2, 16
    r, k, vv = (torch.randn((b, s, h, hd), generator=g, device=dev)
                for _ in range(3))
    w = torch.rand((b, s, h, hd), generator=g, device=dev)
    u = torch.randn((h, hd), generator=g, device=dev)
    s0 = torch.zeros((b, h, hd, hd), device=dev)
    with pytest.raises(NotImplementedError, match="ROADMAP item 8"):
        W.wkv(r.clone().requires_grad_(), k, vv, w, u, s0)
    with torch.no_grad():
        W.wkv(r.clone().requires_grad_(), k, vv, w, u, s0)
    n = 16
    x = torch.randn((b, s, h, hd), generator=g, device=dev)
    bm, cm = (torch.randn((b, s, n), generator=g, device=dev)
              for _ in range(2))
    dt = torch.rand((b, s, h), generator=g, device=dev)
    a, d = -torch.rand(h, device=dev), torch.ones(h, device=dev)
    st = torch.zeros((b, h, n, hd), device=dev)
    with pytest.raises(NotImplementedError, match="ROADMAP item 8"):
        SSD.ssd(x, bm, cm, dt, a.clone().requires_grad_(), d, st)
    with torch.no_grad():
        SSD.ssd(x, bm, cm, dt, a.clone().requires_grad_(), d, st)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", FLASH_BWD_EDGES + FLASH_BWD_TC_EDGES,
                         ids=str)
def test_flash_bwd_pre_kernel_matches_stats_plain(dev, case, dt):
    """The row statistics the pre kernel of the call's route writes (m, l,
    D) against ``flash_attention_bwd_stats_plain``, each within 2^-14 of
    its largest magnitude (float32 sums in another order, from the same
    values)."""
    q, k, v, o, do, kw = _flash_bwd_inputs(case, dt, dev)
    b, s, t, h, kh, d = case[:6]
    out = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v),
           torch.empty(3 * b * s * h, dtype=torch.float32, device=dev))
    _build.reset_launches()
    FA._bwd_kernels(FA.BWD_KERNELS[:1], (q, k, v, o, do), out,
                    kw["causal"], kw["q_offset"], kw["kv_valid_len"])
    assert _build.launches[f"{FA.BWD_KERNELS[0]}.{_bwd_route(q, k)}"] == 1
    got = out[3].view(3, b, kh, s, h // kh)
    want = FA.flash_attention_bwd_stats_plain(q, k, o, do, **kw)
    for name, x, y in zip("mlD", got, want):
        err = float((x - y).abs().max())
        assert err <= 2.0 ** -14 * float(y.abs().max()), (name, err)
