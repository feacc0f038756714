"""The Jaccard tile kernel's order of work, on the CPU.

``jaccard_tile_kernel`` (``repro_torch/csrc/jaccard.cu``, the "tile"
variant) counts only ``popc(a & b)`` per pair, takes each panel row's count
once a block, pads each word chunk with zero words to a multiple of 4, and
forms the union as ``|A| + (|B| - |A&B|)``. ``ops.distance_tiled`` repeats
that order in torch ops; here it is held bitwise to the plain version, to
the reference's jnp oracle and to the reference Pallas kernel in interpret
mode, at the edges and over ``hypothesis`` bitmaps. Also: the tile
constants against the CUDA source, the routing rule ``ops.variant`` at its
threshold, and the refusal of W >= 2^26 words on a CUDA call before any
launch. No test here runs a kernel.
"""
import pathlib
import re

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels.jaccard import kernel as ref_kernel
from repro.kernels.jaccard import ref as ref_jaccard
from repro_torch.kernels import _build
from repro_torch.kernels.jaccard import ops

JACCARD_CU = (pathlib.Path(ops.__file__).resolve().parents[2] / "csrc"
              / "jaccard.cu")


def _words(q, w, seed, density=0.3):
    """(q, w) uint32 bitmaps: every fifth row empty, row 1 all ones."""
    rng = np.random.default_rng(seed)
    bits = rng.random((q, w, 32)) < density
    out = (bits * (1 << np.arange(32, dtype=np.uint64))).sum(-1)
    out = out.astype(np.uint32)
    out[::5] = 0
    if q > 1:
        out[1] = 0xFFFFFFFF
    return out


def _t(words):
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32))


def _assert_bitwise(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_tile_constants_match_the_kernel():
    src = JACCARD_CU.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert const("kTileQ") == ops.TILE_Q
    assert const("kTileK") == ops.TILE_K
    assert const("kChunk") == ops.CHUNK
    assert const("kSplit") == ops.SPLIT
    assert ops.CHUNK % (4 * ops.SPLIT) == 0     # whole 16-byte groups a lane
    assert ops.CHUNK // 4 * ops.TILE_Q == 128   # a copy pass: 8 rows
    # warp g holds a-rows g and g + TILE_Q / 2; a warp's lanes are
    # TILE_K / 2 b-row pairs by SPLIT word slices
    assert const("kTileThreads") == 32 * (ops.TILE_Q // 2)
    assert (ops.TILE_K // 2) * ops.SPLIT == 32
    assert "panel[2][kRows][kChunk]" in src      # rows unpadded
    # both entry points, one per variant
    assert 'extern "C" int rt_jaccard_distance(' in src
    assert 'extern "C" int rt_jaccard_tile(' in src
    assert set(_build.SIGNATURES) >= {"rt_jaccard_distance",
                                      "rt_jaccard_tile"}


def test_every_output_of_a_tile_is_written_by_one_lane():
    """Lane l of warp g, s = l % SPLIT, writes output (g + 4 i, l / SPLIT
    + 4 j) of its tile, (i, j) = (s / 2, s % 2), where s < 4."""
    hit = np.zeros((ops.TILE_Q, ops.TILE_K), int)
    for warp in range(ops.TILE_Q // 2):
        for lane in range(32):
            s, gk = lane % ops.SPLIT, lane // ops.SPLIT
            if s < 4:
                hit[warp + ops.TILE_Q // 2 * (s >> 1),
                    gk + ops.TILE_K // 2 * (s & 1)] += 1
    assert (hit == 1).all()


@pytest.mark.parametrize("w", [1, 2, 3, 63, 64, 65])
@pytest.mark.parametrize("q,k", [(13, 13), (21, 37), (9, 4)])
def test_tiled_order_bitwise_equals_plain_reference_and_pallas(q, k, w):
    a = _words(q, w, seed=q * 1000 + w)
    b = a if k == q else _words(k, w, seed=k * 1000 + w + 1)
    got = ops.distance_tiled(_t(a), _t(b)).numpy()
    _assert_bitwise(got, ops.distance_plain(_t(a), _t(b)).numpy())
    _assert_bitwise(got, ref_jaccard.jaccard_distance(a, b))
    _assert_bitwise(got, ref_kernel.jaccard_distance_pallas(
        a, b, interpret=True))


@pytest.mark.parametrize("w", [64, 65, 130])
def test_tiled_order_at_empty_and_full_rows(w):
    """Empty sets (distance 0 to each other), all-ones words, a single bit
    in the chunk's zero padding's place (the last word of an odd W)."""
    a = np.zeros((11, w), np.uint32)
    a[3] = 0xFFFFFFFF
    a[4, :w // 2] = 0xFFFFFFFF
    a[5, -1] = 1
    a[6, -1] = 0x80000000
    a[7] = 0xFFFFFFFF
    a[7, 0] = 0xFFFFFFFE
    b = np.concatenate([a, _words(20, w, seed=w)])
    got = ops.distance_tiled(_t(a), _t(b)).numpy()
    _assert_bitwise(got, ops.distance_plain(_t(a), _t(b)).numpy())
    _assert_bitwise(got, ref_jaccard.jaccard_distance(a, b))
    assert (got[:3, :3] == 0).all() and got[3, 3] == 0 and got[3, 0] == 1


def test_tiled_order_at_the_placement_shapes():
    """(64, 64) and (128, 64): the MoE placement round's bitmaps."""
    for q in (64, 128):
        a = _t(_words(q, 64, seed=q, density=0.05))
        _assert_bitwise(ops.distance_tiled(a, a).numpy(),
                        ops.distance_plain(a, a).numpy())


@settings(max_examples=80, deadline=None, derandomize=True, database=None)
@given(st.data())
def test_random_bitmaps_tiled_equals_plain(data):
    q = data.draw(st.integers(0, 40))
    k = data.draw(st.integers(1, 40))
    w = data.draw(st.integers(0, 140))
    density = data.draw(st.sampled_from([0.0, 0.02, 0.3, 0.9, 1.0]))
    seed = data.draw(st.integers(0, 2**32 - 1))
    a = _words(q, w, seed, density)
    b = a if data.draw(st.booleans()) and k == q else _words(k, w, seed + 1,
                                                             density)
    _assert_bitwise(ops.distance_tiled(_t(a), _t(b)).numpy(),
                    ops.distance_plain(_t(a), _t(b)).numpy())


@pytest.mark.parametrize("q,k,w,want", [
    (24, 24, 2, "row"), (6, 6, 2, "row"), (1024, 1024, 1, "row"),
    (1024, 1024, 8, "row"), (64, 64, ops.TILE_MIN_WORDS - 1, "row"),
    (64, 64, ops.TILE_MIN_WORDS, "tile"),
    (6, ops.FEW_ROWS, 2 * ops.TILE_MIN_WORDS - 1, "row"),
    (6, ops.FEW_ROWS + 1, ops.TILE_MIN_WORDS, "tile"),
    (300, ops.FEW_ROWS, 2 * ops.TILE_MIN_WORDS, "tile"),
    (64, 64, 64, "tile"), (128, 128, 64, "tile"), (40, 300, 65, "tile"),
    (1024, 1024, 256, "tile"),
])
def test_variant_rule(q, k, w, want):
    assert ops.variant(q, k, w) == want


def test_cuda_call_refuses_words_past_the_int32_counts(monkeypatch):
    """W >= 2^26 is refused on a CUDA call before any launch; W = 2^26 - 1
    reaches the launch (meta tensors stand in for the card's)."""
    launched = []
    monkeypatch.setattr(ops.dispatch, "tier", lambda t: "cuda")
    monkeypatch.setattr(ops._build, "launch",
                        lambda *args, **kw: launched.append(kw["variant"]))
    big = torch.empty((2, ops.MAX_WORDS), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match=r"W < 2\^26"):
        ops.distance(big, big)
    assert not launched
    ok = big[:, 1:].contiguous()
    assert ops.distance(ok, ok).shape == (2, 2)
    assert launched == [ops.variant(2, 2, ops.MAX_WORDS - 1)]
