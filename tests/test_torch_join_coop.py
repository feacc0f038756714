"""The join probe's and expand's order of work on the card, settled on the
CPU.

The probe kernel (``probe_kernel<G>`` of ``repro_torch/csrc/join.cu``)
serves each probe key with a group of G lanes that search the sorted build
side k-ary, both bounds in the same rounds; the expand kernel cuts the
merge of output slots and segment starts into tiles, finds a tile's two
ends with the same k-ary search, and has every thread walk its few items
in order. What the CPU can check of them:

* the two rules of shape: ``ops.probe_group`` (the fewest lanes, a power
  of two up to 32, with which the probe side fills the card; no more than
  one round needs) at its thresholds, and ``ops.expand_tiles`` with the
  tile constants the kernel is compiled with;
* both kernels' order of work, emulated here in numpy lane by lane, round
  by round and thread by thread (every splitter in range, the ballot true
  on a prefix of the lanes, every output written exactly once, the rounds
  within ``floor(log_{G+1} m) + 1``), bit for bit against the port's plain
  versions, the reference's host tier (``_pack_np``, ``np.searchsorted``,
  ``expand_pairs_numpy``, the numpy pipeline) and the reference's Pallas
  kernels at ``interpret=True``, at the edges: empty and tiny sides,
  equal keys, keys beyond every build key and near +-2^62, runs of equal
  keys across the splitters, runs of empty segments anywhere, a segment
  over many tiles, a total off the tile size; and over random inputs
  (``hypothesis``).
"""
import pathlib
import re

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels.join import kernel as ref_kernel
from repro.kernels.join import ops as ref_ops
from repro_torch.kernels.join import ops

N_SMS = 132                     # the H100's SMs
GROUPS = (1, 2, 4, 8, 16, 32)
JOIN_CU = (pathlib.Path(ops.__file__).resolve().parents[2] / "csrc"
           / "join.cu")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64))


# --------------------------------------------------------------------------- #
# the kernels' order of work, in numpy
# --------------------------------------------------------------------------- #

def _cut(w, c, g):
    """``kary_cut<G>``: floor(c * w / (G + 1)), no intermediate above w."""
    return c * (w // (g + 1)) + (c * (w % (g + 1))) // (g + 1)


def kary_counts(seq, keys, les, g):
    """``kary_counts<G>`` for many groups at once: over the ascending
    ``seq``, the counts ``#{s: seq[s] < key}`` (``<=`` where ``les[b]``)
    of the two key rows ``keys`` (2, K). Returns the counts (2, K), each
    group's rounds and whether any lane of it ever issued two loads in one
    round (its two intervals parted)."""
    n = len(seq)
    keys = np.asarray(keys, np.int64)
    k = keys.shape[1]
    le = np.asarray(les, bool)[:, None, None]
    lanes = np.arange(1, g + 1)
    l = np.zeros((2, k), np.int64)
    w = np.full((2, k), n, np.int64)
    rounds = np.zeros(k, np.int64)
    two_loads = np.zeros(k, bool)
    while (w > 0).any():
        open_ = w > 0
        rounds += open_.any(0)
        p = l[..., None] + _cut(w[..., None], lanes, g)      # lane splitters
        assert ((p >= l[..., None]) & (p < n) | ~open_[..., None]).all()
        both = open_[0] & open_[1]
        two_loads |= (both[:, None] & (p[0] != p[1])).any(-1)
        v = seq[np.where(open_[..., None], p, 0)]
        t = np.where(le, v <= keys[..., None], v < keys[..., None])
        t &= open_[..., None]
        c = t.sum(-1)
        assert (t == (lanes - 1 < c[..., None])).all()       # a prefix
        new_l = np.where(c == 0, l, l + _cut(w, c, g) + 1)
        new_w = l + _cut(w, c + 1, g) - new_l
        assert (new_w[open_] <= w[open_] // (g + 1)).all()
        l = np.where(open_, new_l, l)
        w = np.where(open_, new_w, w)
    return l, rounds, two_loads


def max_rounds(m, g):
    """The rounds a search of ``m`` values takes at most."""
    if m == 0:
        return 0
    r, w = 0, m
    while w:
        w //= g + 1
        r += 1
    return r


def probe_emulated(build, probe, g):
    """The probe kernel with ``g`` lanes a key: ``(lo, counts)``, rounds
    and two-load flags per key."""
    probe = np.asarray(probe, np.int64)
    (lo, hi), rounds, two = kary_counts(np.asarray(build, np.int64),
                                        np.stack([probe, probe]),
                                        (False, True), g)
    assert (rounds <= max_rounds(len(build), g)).all()
    return lo, hi - lo, rounds, two


def expand_emulated(starts, lo, total, threads=ops.EXPAND_THREADS,
                    items=ops.EXPAND_ITEMS):
    """The expand kernel with blocks of ``threads`` threads and tiles of
    ``threads * items`` merge items: the search of the tile's ends (with at
    most ``threads`` segments, one round of two block-wide counts in which
    every segment is a splitter; else warp 0's k-ary search), the
    shared-memory staging, the direct write of a tile holding no segment
    start, else each thread's bisection and walk and the block's
    write-out; every output slot written exactly once."""
    starts = np.asarray(starts, np.int64)
    lo = np.asarray(lo, np.int64)
    m, tile = len(starts), threads * items
    n_items = total + m
    tiles = -(-n_items // tile)
    if tile == ops.EXPAND_TILE:
        assert tiles == ops.expand_tiles(total, m)
    li = np.full(total, -1, np.int64)
    pos = np.zeros(total, np.int64)
    written = np.zeros(total, np.int64)
    d0 = np.arange(tiles, dtype=np.int64) * tile
    d1 = np.minimum(d0 + tile, n_items)
    diag = starts + np.arange(m)                  # strictly ascending
    if m <= threads:                              # thread x: segment x
        k0s = (diag[None, :] < d0[:, None]).sum(1)
        k1s = (diag[None, :] < d1[:, None]).sum(1)
    else:
        (k0s, k1s), rounds, _ = kary_counts(diag, np.stack([d0, d1]),
                                            (False, False), 32)
        assert (rounds <= max_rounds(m, 32)).all()
    for b in range(tiles):
        k0, ns = int(k0s[b]), int(k1s[b] - k0s[b])
        length = int(d1[b] - d0[b])
        i0, no = int(d0[b]) - k0, length - ns
        assert 0 <= ns <= tile and 0 <= no <= tile
        st_ = starts[k0:k0 + ns]                          # st[x]
        segs = np.arange(k0 - 1, k0 + ns)                 # off[x]'s segment
        off = np.where(segs >= 0, lo[np.maximum(segs, 0)]
                       - starts[np.maximum(segs, 0)], 0)
        seg = np.full(no, -1, np.int64)
        if ns == 0:                               # no walk: one segment
            seg[:] = 0
            dt = np.zeros(0, np.int64)            # no thread walks
        else:
            dt = np.minimum(np.arange(threads) * items, length)
        k = np.searchsorted(st_ + k0 + np.arange(ns), d0[b] + dt)
        j = i0 + dt - k
        for u in range(items):
            live = dt + u < length
            nxt = st_[np.minimum(k, ns - 1)] if ns else np.zeros_like(k)
            start = live & (k < ns) & (nxt <= j)
            emit = live & ~start
            assert (seg[j[emit] - i0] == -1).all()
            seg[j[emit] - i0] = k[emit]
            k, j = k + start, j + emit
        assert (seg >= 0).all()
        out = np.arange(i0, i0 + no)
        li[out] = k0 - 1 + seg
        pos[out] = off[seg] + out
        written[out] += 1
    assert (written == 1).all()
    return li, pos


def _starts(counts):
    counts = np.asarray(counts, np.int64)
    return np.cumsum(counts) - counts


# --------------------------------------------------------------------------- #
# the rules of shape
# --------------------------------------------------------------------------- #

def test_probe_group_thresholds():
    room = N_SMS * ops.PROBE_SM_THREADS       # 67,584 threads on the H100
    m = 36_191
    for g in (4, 8, 16, 32):
        # n * g threads within the room: g lanes; one key more: fewer
        t = room // g
        assert ops.probe_group(t, m, N_SMS) == g
        assert ops.probe_group(t + 1, m, N_SMS) == (g // 2 if g > 4 else 1)
    assert [ops.probe_group(n, m, N_SMS) for n in
            (1, 2112, 2113, 4225, 8449, 16896, 16897, 10**9)] == \
        [32, 32, 16, 8, 4, 4, 1, 1]
    # the main path's largest join and largest probe side
    assert ops.probe_group(203, 36_191, N_SMS) == 32
    assert ops.probe_group(734_990, 28_925, N_SMS) == 1


@pytest.mark.parametrize("m,g", [(0, 1), (1, 1), (2, 2), (3, 4), (5, 8),
                                 (16, 16), (17, 32), (33, 32)])
def test_probe_group_needs_no_more_lanes_than_one_round(m, g):
    assert ops.probe_group(5, m, N_SMS) == g
    assert max_rounds(m, g) <= 1 or g == 32


def test_tile_rule_matches_the_compiled_kernel():
    src = JOIN_CU.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert const("kExpandThreads") == ops.EXPAND_THREADS
    assert const("kExpandItems") == ops.EXPAND_ITEMS
    assert ops.EXPAND_TILE == ops.EXPAND_THREADS * ops.EXPAND_ITEMS
    assert ops.EXPAND_ITEMS % 2 == 1            # the walk's stores spread
    cases = re.findall(r"case (\d+):\s*probe_kernel<(\d+)>", src)
    assert [(int(a), int(b)) for a, b in cases] == [(g, g) for g in GROUPS]
    assert ops.PROBE_MAX_GROUP == GROUPS[-1]
    d = ops.EXPAND_TILE
    for total, m, want in [(0, 0, 0), (1, 0, 1), (0, 1, 1), (d - 1, 1, 1),
                           (d, 1, 2), (734_990, 203, 958), (0, 10**6, 1303)]:
        assert ops.expand_tiles(total, m) == want


@pytest.mark.parametrize("g", GROUPS)
def test_group_lanes_partition_each_warp(g):
    lanes = np.arange(32)
    masks = ((1 << g) - 1) << (lanes & ~(g - 1))
    assert ((masks >> lanes) & 1).all()         # each lane in its own group
    assert len(set(masks)) == 32 // g
    assert sum(set(masks)) == 2**32 - 1         # the groups cover the warp


# --------------------------------------------------------------------------- #
# probe
# --------------------------------------------------------------------------- #

def _probe_want(build, probe):
    lo = np.searchsorted(build, probe, "left")
    return lo, np.searchsorted(build, probe, "right") - lo


def _check_probe(build, probe, g):
    build = np.asarray(build, np.int64)
    probe = np.asarray(probe, np.int64)
    lo, counts, rounds, two = probe_emulated(build, probe, g)
    wlo, wcounts = _probe_want(build, probe)
    np.testing.assert_array_equal(lo, wlo)
    np.testing.assert_array_equal(counts, wcounts)
    plo, pcounts = ops.probe_sorted(_t(build), _t(probe))
    np.testing.assert_array_equal(lo, plo.numpy())
    np.testing.assert_array_equal(counts, pcounts.numpy())
    return rounds, two


PROBE_EDGES = {
    "m0": ([], [-1, 0, 5]),
    "m1": ([7], [6, 7, 8]),
    "m_below_g": ([-4, 2, 2, 9, 11], [-5, -4, 2, 3, 11, 12]),
    "n0": (list(range(100)), []),
    "all_equal": ([7] * 300, [6, 7, 8]),
    "beyond_every_key": (list(range(10, 500, 3)), [-10**12, 9, 500, 10**12]),
    "near_2_62": ([-2**62 - 5, -2**62, -1, 0, 2**62, 2**62, 2**62 + 9],
                  [-2**63, -2**62 - 5, -2**62, -1, 0, 2**62, 2**62 + 9,
                   2**63 - 1]),
    "run_across_splitters": ([1] * 10 + [5] * 1000 + [9] * 10,
                             [0, 1, 4, 5, 6, 9, 10]),
}


@pytest.mark.parametrize("case", sorted(PROBE_EDGES))
@pytest.mark.parametrize("g", GROUPS)
def test_probe_rounds_match_plain_and_searchsorted(case, g):
    build, probe = PROBE_EDGES[case]
    _check_probe(build, probe, g)


def test_probe_bounds_part_where_a_run_straddles_the_splitters():
    build, probe = PROBE_EDGES["run_across_splitters"]
    rounds, two = _check_probe(build, probe, 32)
    assert two[probe.index(5)]          # key 5: both loads in one round
    # keys outside the run keep one interval, one load a lane a round
    assert not two[probe.index(0)] and not two[probe.index(10)]


def test_probe_at_the_main_path_shape_takes_four_rounds():
    rng = np.random.default_rng(0)
    build = np.sort(rng.integers(0, 400_000, 36_191))
    probe = np.concatenate([rng.choice(build, 150), rng.integers(0, 400_000,
                                                                 53)])
    g = ops.probe_group(len(probe), len(build), N_SMS)
    rounds, _ = _check_probe(build, probe, g)
    assert g == 32 and rounds.max() == max_rounds(36_191, 32) == 4
    rounds1, _ = _check_probe(build, probe, 1)
    assert rounds1.max() == max_rounds(36_191, 1) == 16


def test_probe_matches_pallas_and_the_host_pipeline():
    rng = np.random.default_rng(1)
    rcs = [rng.integers(0, 30, 900), rng.integers(0, 4, 900)]
    lcs = [rng.integers(0, 32, 300), rng.integers(0, 4, 300)]
    order, wlo, wcounts = ref_ops.hash_probe_numpy(lcs, rcs)
    lk, rk = ref_ops._pack_np(lcs), ref_ops._pack_np(rcs)
    build = rk[order]
    plo, phi = ref_kernel.probe_sorted_pallas(
        *(np.asarray(w) for w in ref_ops._split_words(build)),
        *(np.asarray(w) for w in ref_ops._split_words(lk)), interpret=True)
    for g in (1, 8, 32):
        lo, counts, _, _ = probe_emulated(build, lk, g)
        np.testing.assert_array_equal(lo, wlo)
        np.testing.assert_array_equal(counts, wcounts)
        np.testing.assert_array_equal(lo, np.asarray(plo))
        np.testing.assert_array_equal(counts,
                                      np.asarray(phi) - np.asarray(plo))
    assert wcounts.sum() > 0 and (wcounts == 0).any()


# --------------------------------------------------------------------------- #
# expand
# --------------------------------------------------------------------------- #

def _check_expand(counts, lo, **tile):
    counts = np.asarray(counts, np.int64)
    lo = np.asarray(lo, np.int64)
    total = int(counts.sum())
    li, pos = expand_emulated(_starts(counts), lo, total, **tile)
    rli, rpos = ref_ops.expand_pairs_numpy(lo, counts)
    np.testing.assert_array_equal(li, rli)
    np.testing.assert_array_equal(pos, rpos)
    pli, ppos = ops.expand_pairs_plain(_t(_starts(counts)), _t(lo), total)
    np.testing.assert_array_equal(li, pli.numpy())
    np.testing.assert_array_equal(pos, ppos.numpy())
    return li, pos


def _expand_case(case, rng):
    d = ops.EXPAND_TILE
    counts = rng.integers(0, 4, 3000)
    if case == "leading_zero":
        counts[:2500] = 0
    elif case == "trailing_zero":
        counts[-2500:] = 0
    elif case == "zero_runs":
        counts[100:2900] = 0
        counts[1500] = 5
    elif case == "all_zero_but_one":
        counts[:] = 0
        counts[1234] = 1
    elif case == "one_segment_many_tiles":
        counts = np.zeros(7, np.int64)
        counts[3] = 9 * d + 5
    elif case == "off_tile_total":
        counts = np.full(d + 3, 1, np.int64)
        counts[0] = 2                   # total = d + 4 with d + 3 segments
    elif case == "ones":
        counts = np.ones(5000, np.int64)
    elif case == "single":
        counts = np.array([1], np.int64)
    elif case in ("256_segments", "257_segments"):   # either side of the
        counts = rng.integers(0, 9, int(case[:3]))     # one-round search
        counts[::5] = 0
    lo = rng.integers(-2**40, 2**40, len(counts))
    return counts, lo


EXPAND_CASES = ["mixed", "leading_zero", "trailing_zero", "zero_runs",
                "all_zero_but_one", "one_segment_many_tiles",
                "off_tile_total", "ones", "single", "256_segments",
                "257_segments"]


@pytest.mark.parametrize("tile", [(ops.EXPAND_THREADS, ops.EXPAND_ITEMS),
                                  (4, 3), (1, 1), (32, 7)],
                         ids=["kernel", "4x3", "1x1", "32x7"])
@pytest.mark.parametrize("case", EXPAND_CASES)
def test_expand_tiles_match_plain_and_numpy(case, tile):
    rng = np.random.default_rng(len(case))
    counts, lo = _expand_case(case, rng)
    _check_expand(counts, lo, threads=tile[0], items=tile[1])


def test_expand_over_a_million_empty_segments_spreads_over_tiles():
    counts = np.zeros(1_000_000, np.int64)
    counts[[0, 499_999, 999_999]] = [3, 2 * ops.EXPAND_TILE, 1]
    lo = np.arange(1_000_000, dtype=np.int64) * 3
    _check_expand(counts, lo)
    # each tile of the merge holds at most EXPAND_TILE segment starts
    assert ops.expand_tiles(int(counts.sum()), len(counts)) == 1305


def test_expand_matches_pallas():
    rng = np.random.default_rng(3)
    counts = rng.integers(0, 4, 700)
    counts[:40] = 0
    counts[-60:] = 0
    counts[300] = 2000
    lo = rng.integers(0, 5000, 700)
    li, pos = _check_expand(counts, lo)
    total = int(counts.sum())
    kli, kpos = ref_kernel.expand_pairs_pallas(
        _starts(counts).astype(np.int32), counts.astype(np.int32),
        lo.astype(np.int32), total=total, interpret=True)
    np.testing.assert_array_equal(li, np.asarray(kli)[:total])
    np.testing.assert_array_equal(pos, np.asarray(kpos)[:total])


@pytest.mark.parametrize("lens", [[0, 5, 0, 0, 3], [4000], [0] * 9 + [1],
                                  [2] * 2000])
def test_expand_segment_ids_as_the_federation_counts_call_it(lens):
    lens = np.asarray(lens, np.int64)
    li, _ = expand_emulated(_starts(lens), np.zeros_like(lens),
                            int(lens.sum()))
    np.testing.assert_array_equal(
        li, ref_ops.expand_pairs_numpy(np.zeros_like(lens), lens)[0])
    np.testing.assert_array_equal(li, np.repeat(np.arange(len(lens)), lens))
    np.testing.assert_array_equal(li, ops.expand_segment_ids(_t(lens)))


# --------------------------------------------------------------------------- #
# the two together, and random inputs
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("seed,k", [(0, 1), (1, 2)])
def test_probe_then_expand_is_the_reference_join(seed, k):
    rng = np.random.default_rng(seed)
    lcs = [rng.integers(0, 40, 500) for _ in range(k)]
    rcs = [rng.integers(0, 40, 2000) for _ in range(k)]
    lk, rk = ref_ops._pack_np(lcs), ref_ops._pack_np(rcs)
    order = np.argsort(rk, kind="stable")
    g = ops.probe_group(len(lk), len(rk), N_SMS)
    lo, counts, _, _ = probe_emulated(rk[order], lk, g)
    li, pos = expand_emulated(_starts(counts), lo, int(counts.sum()))
    rli, rri, total = ref_ops.hash_join_pipeline(lcs, rcs, mode="numpy")
    assert total == len(li) > 0
    np.testing.assert_array_equal(li, rli)
    np.testing.assert_array_equal(order[pos], rri)


@settings(max_examples=60, deadline=None, derandomize=True, database=None)
@given(st.data())
def test_random_builds_probes_and_counts(data):
    span = data.draw(st.sampled_from([3, 50, 2**40, 2**62]))
    m = data.draw(st.integers(0, 400))
    n = data.draw(st.integers(0, 60))
    seed = data.draw(st.integers(0, 2**32 - 1))
    g = data.draw(st.sampled_from(GROUPS))
    rng = np.random.default_rng(seed)
    build = np.sort(rng.integers(-span, span, m))
    probe = rng.integers(-span - 2, span + 2, n)
    if m and n:
        probe[: n // 2] = rng.choice(build, n // 2)
    _check_probe(build, probe, g)
    segs = data.draw(st.integers(1, 300))
    counts = rng.integers(0, data.draw(st.sampled_from([1, 2, 9, 60])), segs)
    counts[rng.random(segs) < data.draw(st.floats(0, 1))] = 0
    lo = rng.integers(-2**62, 2**62, segs)
    threads, items = data.draw(st.sampled_from(
        [(ops.EXPAND_THREADS, ops.EXPAND_ITEMS), (2, 3), (8, 5), (1, 2)]))
    _check_expand(counts, lo, threads=threads, items=items)
