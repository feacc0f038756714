"""repro_torch.kernels.join against the reference join family.

The same numpy inputs, made from a seed, go through the port's ops on CPU
tensors (each kernel's plain PyTorch version) and through the reference:
its host numpy tier and its raw Pallas kernels at ``interpret=True`` (the
reference's jnp oracle tiers need ``jax.experimental.enable_x64``, which
the installed jax lacks). Integer outputs must match exactly.
"""
import numpy as np
import pytest
import torch

from repro.kernels.join import kernel as ref_kernel
from repro.kernels.join import ops as ref_ops
from repro.query import exec as ref_exec
from repro_torch.kernels.join import ops
from repro_torch.query import exec as port_exec

CPU = torch.device("cpu")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64))


def _words(hi, lo) -> np.ndarray:
    """The reference kernels' (hi int32, lo uint32) word pair -> int64."""
    return ((np.asarray(hi).astype(np.int64) << 32)
            | np.asarray(lo).astype(np.uint32).astype(np.int64))


# --------------------------------------------------------------------------- #
# granular ops
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("k", [1, 2])
def test_pack_matches_numpy_and_pallas(k):
    rng = np.random.default_rng(k)
    cols = rng.integers(0, 2**31, (300, k), dtype=np.int64)
    cols[:3] = [[2**31 - 1] * k, [0] * k, [1] * k]
    got = ops.pack_keys(_t(cols.T)).numpy()
    np.testing.assert_array_equal(got, ref_ops._pack_np(list(cols.T)))
    hi, lo = ref_kernel.pack_keys_pallas(cols.astype(np.int32),
                                         interpret=True)
    np.testing.assert_array_equal(got, _words(hi, lo))


def test_probe_duplicates_and_misses_match_pallas():
    rng = np.random.default_rng(1)
    build = np.sort(rng.integers(0, 40, 700)) * np.int64(2**31) + 5
    probe = np.concatenate([build[::7], rng.integers(0, 2**37, 90),
                            [0, build[0], build[-1], build[-1] + 1]])
    lo, counts = ops.probe_sorted(_t(build), _t(probe))
    np.testing.assert_array_equal(lo.numpy(),
                                  np.searchsorted(build, probe, "left"))
    np.testing.assert_array_equal(
        counts.numpy(), np.searchsorted(build, probe, "right")
        - np.searchsorted(build, probe, "left"))
    plo, phi = ref_kernel.probe_sorted_pallas(
        *(np.asarray(w) for w in ref_ops._split_words(build)),
        *(np.asarray(w) for w in ref_ops._split_words(probe)),
        interpret=True)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(plo))
    np.testing.assert_array_equal(counts.numpy(),
                                  np.asarray(phi) - np.asarray(plo))
    assert counts.sum() > 0 and (counts == 0).any()


@pytest.mark.parametrize("nb,np_", [(0, 5), (5, 0), (1, 1)])
def test_probe_empty_and_single_sides(nb, np_):
    build = np.arange(nb, dtype=np.int64) * 3
    probe = np.arange(np_, dtype=np.int64) * 3
    lo, counts = ops.probe_sorted(_t(build), _t(probe))
    np.testing.assert_array_equal(lo.numpy(),
                                  np.searchsorted(build, probe, "left"))
    np.testing.assert_array_equal(
        counts.numpy(), np.searchsorted(build, probe, "right")
        - np.searchsorted(build, probe, "left"))


@pytest.mark.parametrize("case", ["mixed", "leading_zero", "trailing_zero",
                                  "single_run"])
def test_expand_matches_numpy_and_pallas(case):
    rng = np.random.default_rng(3)
    counts = rng.integers(0, 4, 200)
    if case == "leading_zero":
        counts[:17] = 0
    elif case == "trailing_zero":
        counts[-23:] = 0
    elif case == "single_run":
        counts[:] = 0
        counts[57] = 31
    lo = rng.integers(0, 5000, 200)
    li, pos = ops.expand_pairs(_t(lo), _t(counts))
    rli, rpos = ref_ops.expand_pairs_numpy(lo, counts)
    np.testing.assert_array_equal(li.numpy(), rli)
    np.testing.assert_array_equal(pos.numpy(), rpos)
    total = int(counts.sum())
    starts = np.cumsum(counts) - counts
    kli, kpos = ref_kernel.expand_pairs_pallas(
        starts.astype(np.int32), counts.astype(np.int32),
        lo.astype(np.int32), total=total, interpret=True)
    np.testing.assert_array_equal(li.numpy(), np.asarray(kli)[:total])
    np.testing.assert_array_equal(pos.numpy(), np.asarray(kpos)[:total])


@pytest.mark.parametrize("counts", [[], [0, 0, 0], [0, 2, 0, 0, 3, 0],
                                    [4]])
def test_expand_segment_ids_zero_count_segments(counts):
    counts = np.asarray(counts, np.int64)
    got = ops.expand_segment_ids(_t(counts)).numpy()
    np.testing.assert_array_equal(
        got, np.repeat(np.arange(len(counts)), counts))


def test_gather_out_of_range_matches_pallas():
    rng = np.random.default_rng(4)
    values = rng.integers(0, 2**31, 300)
    idx = rng.integers(-20, 320, 1000)
    got = ops.gather_rows(_t(values), _t(idx), fill=-3).numpy()
    valid = (idx >= 0) & (idx < len(values))
    want = np.where(valid, values[np.clip(idx, 0, len(values) - 1)], -3)
    np.testing.assert_array_equal(got, want)
    ref = ref_kernel.gather_rows_pallas(values.astype(np.int32),
                                        idx.astype(np.int32), fill=-3,
                                        interpret=True)
    np.testing.assert_array_equal(got, np.asarray(ref))
    empty = ops.gather_rows(_t(np.empty(0)), _t(idx[:5]), fill=9).numpy()
    np.testing.assert_array_equal(empty, np.full(5, 9))


def test_wrappers_reject_bad_inputs():
    with pytest.raises(TypeError, match="int64"):
        ops.probe_sorted(torch.zeros(3, dtype=torch.int32),
                         torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        ops.gather_rows(torch.arange(10), torch.arange(10)[::2])
    with pytest.raises(ValueError, match="<= 2"):
        ops.pack_keys(torch.zeros((3, 4), dtype=torch.int64))


# --------------------------------------------------------------------------- #
# the fused pipeline
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("seed,k", [(0, 1), (1, 2), (2, 1), (3, 2)])
def test_pipeline_matches_reference_numpy(seed, k):
    rng = np.random.default_rng(seed)
    (nl, nr), hi = rng.integers(1, 400, 2), 60
    lcs = [rng.integers(0, hi, nl) for _ in range(k)]
    rcs = [rng.integers(0, hi, nr) for _ in range(k)]
    li, ri, total = ops.hash_join_pipeline(lcs, rcs, device="cpu")
    rli, rri, rtotal = ref_ops.hash_join_pipeline(lcs, rcs, mode="numpy")
    assert total == rtotal
    np.testing.assert_array_equal(li, rli)
    np.testing.assert_array_equal(ri, rri)
    assert li.dtype == ri.dtype == np.int64


@pytest.mark.parametrize("nl,nr", [(0, 4), (4, 0), (0, 0)])
def test_pipeline_empty_sides(nl, nr):
    li, ri, total = ops.hash_join_pipeline(
        [np.zeros(nl, np.int64)], [np.zeros(nr, np.int64)], device="cpu")
    assert total == 0 and len(li) == len(ri) == 0


def test_pipeline_zero_match():
    li, ri, total = ops.hash_join_pipeline(
        [np.array([1, 3, 5])], [np.array([2, 4])], device="cpu")
    assert total == 0 and len(li) == len(ri) == 0


def test_pipeline_cap_fires_before_materialization(monkeypatch):
    lcs = [np.zeros(20, np.int64)]
    rcs = [np.zeros(12, np.int64)]

    def no_expand(*a, **kw):
        raise AssertionError("expansion materialized past the cap")

    monkeypatch.setattr(ops, "expand_pairs", no_expand)
    with pytest.raises(ops.ExpansionCapExceeded, match="240 rows"):
        ops.hash_join_pipeline(lcs, rcs, device="cpu", max_total=239)
    monkeypatch.undo()
    with ops.track_transfers() as ts:
        _, _, total = ops.hash_join_pipeline(lcs, rcs, device="cpu",
                                             max_total=240)
    assert total == 240
    assert ts.total == 0        # CPU tensors: nothing crosses a boundary


# --------------------------------------------------------------------------- #
# 1, 2 and 3+ shared variables (the _key_columns dense-rank path)
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("n_shared", [1, 2, 3])
def test_join_shared_variables_match_numpy_join(n_shared):
    rng = np.random.default_rng(10 + n_shared)
    pat = (-1, -2, -3)                       # (?a, ?b, ?c)
    table = {v: rng.integers(0, 3, 80).astype(np.int64)
             for v in pat[:n_shared]}
    table[-9] = rng.integers(0, 10**6, 80).astype(np.int64)
    rows = rng.integers(0, 3, (70, 3)).astype(np.int32)
    st_ref, st_port = ref_exec.ExecStats(), port_exec.ExecStats()
    ref = ref_exec._join_numpy(dict(table), pat, rows, st_ref, 10**7)
    got = port_exec._join_torch(dict(table), pat, rows, st_port, 10**7,
                                CPU)
    keys = sorted(ref)
    assert sorted(got) == keys
    for k in keys:                           # same pairs, same order
        np.testing.assert_array_equal(got[k], ref[k])
    assert st_ref.expanded_rows == st_port.expanded_rows > 0
