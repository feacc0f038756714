"""The dec flash-attention kernel's decisions, settled on the CPU.

The dec kernel (``flash_decode_kernel`` of
``repro_torch/csrc/flash_attention.cu``) runs every CUDA call with at most
``DEC_MAX_ROWS`` (query, head) rows per kv head: the decode steps. What
the CPU can check of it:

* the routing rule ``ops.variant``: "dec" in all three dtypes up to 16
  rows, the tc and scalar rules unchanged, and for every attention config
  a decode step on "dec" and its 2048-token prefill where it was;
* the split formula ``ops.dec_splits``: every key covered once, splits of
  whole tiles, none empty, at least two waves of blocks where the keys
  allow;
* the kernel's order of work, emulated in torch in float32: the splits,
  the four warps of a block taking key slices of each tile, each warp's
  online softmax, the merge of the warps' states in the block and then
  the merge of the splits, each state weighted by ``e^(m - M)``. Held
  against ``flash_attention_plain`` at the card's own tolerance
  (``chip_smoke.py`` ``_flash_err``: 1e-5 plus one step of the output
  dtype) on the edges where the merges could go wrong, and a few cases
  against the reference's ``ref.attention`` too.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ref as rref
from repro_torch import configs
from repro_torch.kernels.flash_attention import ops as FA

BF16, F32, F16 = torch.bfloat16, torch.float32, torch.float16
N_SMS = 132                     # the H100's SMs
DEC_WARPS = 4                   # the kernel's kDecWarps


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

@pytest.mark.parametrize("dtype", [F32, BF16, F16], ids=str)
@pytest.mark.parametrize("s, g, d, want", [
    (1, 1, 112, "dec"),          # zamba2-7b, olmoe-1b-7b, hubert-xlarge
    (1, 2, 128, "dec"),          # qwen3-0.6b
    (1, 3, 64, "dec"),           # smollm-360m
    (1, 5, 128, "dec"),          # qwen2.5-32b
    (1, 8, 128, "dec"),          # chameleon-34b, qwen3-moe-30b-a3b
    (1, 12, 128, "dec"),         # starcoder2-15b
    (16, 1, 64, "dec"),          # S * g = 16: the last row count it takes
    (8, 2, 128, "dec"),
    (17, 1, 64, "scalar"),       # S * g = 17: one row too many
    (1, 17, 128, "scalar"),
    (1, 2, 8, "dec"),            # the narrowest and widest heads
    (1, 2, 256, "dec"),
    (2, 8, 256, "dec"),
    (1, 2, 12, "scalar"),        # not a multiple of 8: the CUDA call raises
    (1, 2, 264, "scalar"),       # wider than 256: the CUDA call raises
])
def test_dec_takes_up_to_16_rows_in_every_dtype(dtype, s, g, d, want):
    assert FA.variant(dtype, s, g, d) == want


@pytest.mark.parametrize("arch", [a for a in configs.ARCH_IDS
                                  if configs.get(a).n_heads])
def test_every_attention_config_decodes_on_dec(arch):
    """A decode step (S = 1) of every attention config runs "dec"; its
    2048-token prefill runs "tc" as before (bfloat16, D % 16 == 0 and D <=
    128 in every config)."""
    cfg = configs.get(arch)
    dtype = getattr(torch, cfg.compute_dtype)
    g, d = cfg.n_heads // cfg.n_kv_heads, cfg.resolved_head_dim
    assert FA.variant(dtype, 1, g, d) == "dec"
    assert FA.variant(dtype, 2048, g, d) == "tc"


# --------------------------------------------------------------------------- #
# the split formula
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("b, kh, kv_len, want", [
    (4, 8, 2080, (17, 128)),     # qwen3-0.6b's decode step: 544 blocks
    (4, 32, 2080, (5, 448)),     # zamba2-7b's: 640 blocks
    (1, 1, 1, (1, 64)),          # one valid key
    (1, 1, 65, (2, 64)),         # one key past a tile
    (64, 8, 2080, (2, 1088)),    # 512 pairs: two splits
    (528, 1, 5000, (1, 5056)),   # two waves without a split
])
def test_dec_splits_at_known_shapes(b, kh, kv_len, want):
    assert FA.dec_splits(b, kh, kv_len, N_SMS) == want


@pytest.mark.parametrize("b, kh", [(1, 1), (2, 2), (4, 8), (4, 32), (3, 5),
                                   (16, 8), (64, 8), (1, 264), (600, 1)])
@pytest.mark.parametrize("kv_len", [1, 63, 64, 65, 127, 128, 129, 1000,
                                    2080, 2081, 32768])
def test_dec_splits_cover_every_key_once_in_whole_tiles(b, kh, kv_len):
    splits, chunk = FA.dec_splits(b, kh, kv_len, N_SMS)
    assert chunk > 0 and chunk % FA.DEC_KEY_GRANULE == 0
    for tile in (16, 32, 64):                      # every tile size divides
        assert FA.DEC_KEY_GRANULE % tile == 0
    covered = np.zeros(kv_len, np.int64)
    for i in range(splits):
        lo, hi = i * chunk, min((i + 1) * chunk, kv_len)
        assert lo < hi, "an empty split"
        covered[lo:hi] += 1
    assert (covered == 1).all()
    granules = -(-kv_len // FA.DEC_KEY_GRANULE)
    # at least two waves of blocks on the card where the keys allow (the
    # main path's decode shapes, (4, 8) and (4, 32) at 2080 keys, among)
    assert b * kh * splits >= min(2 * N_SMS, b * kh * granules)


# --------------------------------------------------------------------------- #
# the kernel's order of work, emulated
# --------------------------------------------------------------------------- #

def _dec_tile(itemsize: int, d: int) -> int:
    """Keys per tile of the dec kernel: ``DEC_WARPS`` warps of 32 lanes, a
    K row of ``d * itemsize`` bytes read by 4, 8 or 16 lanes (at most four
    16-byte chunks each); mirrors ``dec_lanes_per_key`` of the kernel."""
    row_bytes = d * itemsize
    lanes = 4 if row_bytes <= 256 else 8 if row_bytes <= 512 else 16
    return DEC_WARPS * 32 // lanes


def _dec_emulation(q, k, v, *, causal, q_offset, kv_valid_len):
    """The dec kernel's order of work in torch, float32 throughout: the
    split formula, then per split each tile of keys cut into ``DEC_WARPS``
    slices, each warp's online softmax over its slices (masked keys weigh
    exactly 0), the block's merge of its warps' states and the merge of the
    splits, each state by ``e^(m - M)``; out = acc / max(l, 1e-30) in q's
    dtype. The scores are the plain version's own (the same product, then
    the scale), so that what differs is the order of the softmax, of P·V
    and of the merges: with scores of order 100 (q x 30) the float32
    rounding of q·k alone moves the output by about 1e-5 whatever the order
    of its sum (the plain version is 1.03e-5 from a float64 attention on
    "x30_g1", and a per-tile product of the same inputs 3.3e-6)."""
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    g, rows = h // kh, s * (h // kh)
    qf = q.to(torch.float32).reshape(b, s, kh, g, d).permute(0, 2, 3, 1, 4)
    kf = k.to(torch.float32).permute(0, 2, 1, 3)[:, :, None]  # (B,K,1,T,D)
    scores = torch.matmul(qf, kf.transpose(-1, -2)) * (1.0 / math.sqrt(d))
    scores = scores.permute(0, 1, 3, 2, 4).reshape(b, kh, rows, t)
    vf = v.float().permute(0, 2, 1, 3)                 # (B, K, T, D)
    qpos = q_offset + torch.arange(rows) // g          # row = i * g + head
    kv_len = t if kv_valid_len is None else min(kv_valid_len, t)
    if causal:
        kv_len = min(kv_len, q_offset + s)
    splits, chunk = FA.dec_splits(b, kh, kv_len, N_SMS)
    tile = _dec_tile(q.element_size(), d)
    per_warp = tile // DEC_WARPS
    neg = torch.full((), FA.NEG_INF)

    def merge(states):
        mx = torch.stack([m for m, _, _ in states]).amax(0)
        ws = [torch.exp(m - mx) for m, _, _ in states]
        l = sum(l_ * w for (_, l_, _), w in zip(states, ws))
        acc = sum(a * w for (_, _, a), w in zip(states, ws))
        return mx, l, acc

    parts = []
    for sp in range(splits):
        k0, k1 = sp * chunk, min((sp + 1) * chunk, kv_len)
        warps = [(torch.full((b, kh, rows, 1), FA.NEG_INF),
                  torch.zeros((b, kh, rows, 1)),
                  torch.zeros((b, kh, rows, d))) for _ in range(DEC_WARPS)]
        for t0 in range(k0, k1, tile):
            for w in range(DEC_WARPS):
                keys = torch.arange(t0 + w * per_warp, t0 + (w + 1) * per_warp)
                ok = keys[None, :] < k1
                if causal:
                    ok = ok & (keys[None, :] <= qpos[:, None])
                idx = keys.clamp(max=t - 1)
                sc = torch.where(ok, scores[:, :, :, idx], neg)
                m, l, acc = warps[w]
                m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
                p = torch.where(ok, torch.exp(sc - m_new), torch.zeros(()))
                alpha = torch.exp(m - m_new)
                warps[w] = (m_new, l * alpha + p.sum(-1, keepdim=True),
                            acc * alpha + p @ vf[:, :, idx])
        parts.append(merge(warps))
    _, l, acc = parts[0] if splits == 1 else merge(parts)
    out = acc / torch.clamp(l, min=1e-30)
    return out.reshape(b, kh, s, g, d).permute(0, 2, 1, 3, 4) \
        .reshape(b, s, h, d).to(q.dtype)


def _card_tolerance(got, want):
    """``chip_smoke.py`` ``_flash_err``: 1e-5 absolute plus one step of the
    output dtype relative (2^-7 bf16, 2^-10 float16) where two float32
    results round to neighbours. Returns the elements outside it."""
    step = {BF16: 2.0 ** -7, F16: 2.0 ** -10}.get(got.dtype, 0.0)
    got, want = got.float(), want.float()
    return int(((got - want).abs() > 1e-5 + step * want.abs()).sum())


def _inputs(case, dtype, seed=0, q_scale=1.0):
    b, s, t, h, kh, d = case[:6]
    rng = np.random.default_rng(seed + sum(case[:6]))
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((b, s, h, d), (b, t, kh, d), (b, t, kh, d)))
    return tuple(torch.from_numpy(a).to(dtype) for a in (q * q_scale, k, v))


# (B, S, T, H, K, D, causal, q_offset, kv_valid_len, q scale)
DEC_CASES = [
    (2, 1, 300, 4, 2, 64, True, 299, 1, 1.0),        # kv_valid_len = 1
    (1, 16, 200, 1, 1, 64, True, 63, None, 1.0),     # split 1 masked for row 0
    (1, 1, 129, 2, 2, 128, True, 128, 129, 1.0),     # one key past 2 tiles
    (2, 1, 700, 8, 8, 112, True, 699, 700, 30.0),    # scores x 30, g = 1
    (2, 1, 520, 4, 2, 128, True, 519, 520, 30.0),    # g = 2
    (1, 2, 300, 16, 2, 64, True, 250, 252, 1.0),     # g = 8, S = 2
    (1, 1, 400, 12, 1, 128, True, 399, 400, 1.0),    # g = 12
    (2, 16, 90, 2, 2, 32, True, 70, 86, 1.0),        # S = 16, q_offset > 0
    (1, 8, 333, 4, 2, 256, True, 300, 308, 30.0),    # S = 8, g = 2, D 256
    (3, 1, 2080, 4, 4, 8, True, 2079, 2080, 1.0),    # D = 8
    (2, 5, 150, 3, 1, 80, False, 0, 140, 1.0),       # non-causal, g = 3
]
DEC_IDS = ["valid1", "masked_split", "tile_edge", "x30_g1", "x30_g2", "g8",
           "g12", "s16", "d256", "d8", "noncausal_g3"]


@pytest.mark.parametrize("dtype", [F32, BF16, F16], ids=str)
@pytest.mark.parametrize("case", DEC_CASES, ids=DEC_IDS)
def test_dec_order_of_work_holds_the_card_tolerance(case, dtype):
    b, s, t, h, kh, d, causal, off, valid, q_scale = case
    assert FA.variant(dtype, s, h // kh, d) == "dec"
    q, k, v = _inputs(case, dtype, q_scale=q_scale)
    kw = dict(causal=causal, q_offset=off, kv_valid_len=valid)
    got = _dec_emulation(q, k, v, **kw)
    want = FA.flash_attention_plain(q, k, v, **kw)
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.isfinite(got.float()).all()
    assert _card_tolerance(got, want) == 0, \
        float((got.float() - want.float()).abs().max())


def test_the_masked_case_leaves_a_split_without_a_valid_key():
    """The "masked_split" case does what its name says: row 0 (query 63)
    finds no valid key in split 1 (keys 64 to 78), so that split's state
    for it has m = -1e30 and must weigh 0."""
    b, s, t, h, kh, d, causal, off, valid, _ = DEC_CASES[1]
    splits, chunk = FA.dec_splits(b, kh, min(t, off + s), N_SMS)
    assert splits == 2 and chunk == 64 and off < chunk


@pytest.mark.parametrize("case", [DEC_CASES[i] for i in (0, 1, 4, 7, 10)],
                         ids=[DEC_IDS[i] for i in (0, 1, 4, 7, 10)])
def test_dec_order_of_work_matches_the_reference(case):
    b, s, t, h, kh, d, causal, off, valid, q_scale = case
    q, k, v = _inputs(case, F32, seed=1, q_scale=q_scale)
    kw = dict(causal=causal, q_offset=off, kv_valid_len=valid)
    got = _dec_emulation(q, k, v, **kw).numpy()
    want = np.asarray(rref.attention(*(jnp.asarray(x.numpy())
                                       for x in (q, k, v)), **kw))
    assert float(np.abs(got - want).max()) <= 1e-5
