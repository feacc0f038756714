"""repro_torch.kernels.jaccard against the reference Jaccard family.

The port's op on CPU tensors (the kernel's plain PyTorch version) must be
bitwise equal, as float32, to the reference jnp oracle
(``repro.kernels.jaccard.ref``) and to the reference Pallas kernel at
``interpret=True``: the adaptive controller's single-linkage HAC reads the
distances as float64, so one bit changes merges and layouts.
"""
import numpy as np
import pytest
import torch

from repro.core.features import FeatureSpace as RefSpace
from repro.kernels.jaccard import kernel as ref_kernel
from repro.kernels.jaccard import ref as ref_jaccard
from repro_torch.kernels.jaccard import ops


def _bitmaps(q, w, seed, density=0.3):
    rng = np.random.default_rng(seed)
    bits = rng.random((q, w * 32)) < density
    words = np.packbits(bits.reshape(q, w, 4, 8)[..., ::-1],
                        axis=-1).reshape(q, w, 4)
    out = words[..., ::-1].copy().view(np.uint32).reshape(q, w)
    out[::5] = 0                               # empty sets mixed in
    return out


def _assert_bitwise(got: np.ndarray, want: np.ndarray):
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("q,w", [(1, 1), (7, 1), (13, 3), (130, 2),
                                 (9, 40)])
def test_distance_bitwise_equals_reference(q, w):
    a = _bitmaps(q, w, seed=q * 100 + w)
    got = ops.jaccard_distance(a, device="cpu").numpy()
    assert got.shape == (q, q)
    _assert_bitwise(got, np.asarray(ref_jaccard.jaccard_distance(a, a)))
    _assert_bitwise(got, np.asarray(
        ref_kernel.jaccard_distance_pallas(a, a, interpret=True)))


def test_rectangular_and_full_range_words():
    rng = np.random.default_rng(7)
    a = rng.integers(0, 2**32, (11, 5), dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2**32, (6, 5), dtype=np.uint64).astype(np.uint32)
    a[0] = 0xFFFFFFFF
    b[0] = 0x80000000
    got = ops.distance(torch.from_numpy(a.view(np.int32)),
                       torch.from_numpy(b.view(np.int32))).numpy()
    _assert_bitwise(got, np.asarray(ref_jaccard.jaccard_distance(a, b)))


def test_empty_bitmaps_have_distance_zero_to_each_other():
    a = np.zeros((4, 3), np.uint32)
    a[3, 1] = 1
    got = ops.jaccard_distance(a, device="cpu").numpy()
    assert (got[:3, :3] == 0).all()
    assert (got[3, :3] == 1).all() and got[3, 3] == 0


def test_workload_bitmaps_of_lubm_match_reference(small_lubm):
    space = RefSpace(small_lubm.store,
                     type_predicate=small_lubm.dictionary.lookup("rdf:type"))
    queries = small_lubm.extended_workload()
    space.track_workload(queries)
    bm = space.workload_bitmaps(queries)
    got = ops.jaccard_distance(bm, device="cpu").numpy()
    _assert_bitwise(got, np.asarray(ref_jaccard.jaccard_distance(bm, bm)))


def test_distance_rejects_bad_inputs():
    with pytest.raises(TypeError, match="int32"):
        ops.distance(torch.zeros((2, 2), dtype=torch.int64),
                     torch.zeros((2, 2), dtype=torch.int64))
    with pytest.raises(ValueError, match="word counts"):
        ops.distance(torch.zeros((2, 2), dtype=torch.int32),
                     torch.zeros((2, 3), dtype=torch.int32))
