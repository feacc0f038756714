"""repro_torch.core.hac.hac_torch against the reference's HAC.

``hac_torch`` is the torch form of the reference's jit-able ``hac_jax``:
float32, the diagonal at +inf, n - 1 masked argmins over the flattened
matrix (ties to the first index), and the same Lance–Williams row updates
in the same order of float32 operations. On the CPU its Z must equal
``hac_jax``'s bit for bit, and against the float64 ``hac_numpy`` the merge
ids and sizes (Z columns 0, 1, 3) must be equal and the distances within
1e-5, the reference's own tolerance (``tests/test_core_clustering.py``).
"""
from fractions import Fraction

import numpy as np
import pytest
import torch

from repro.core import hac as ref_hac
from repro_torch.core import hac
from repro_torch.kernels.jaccard import ops as jac

LINKAGES = ("single", "complete", "average")
DIST_TOL = 1e-5          # hac_numpy's distances are float64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the CPU tier's ops are
    small, and test workers running side by side would otherwise each
    spin a thread per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random(n, seed):
    rng = np.random.default_rng(seed)
    d = rng.random((n, n)).astype(np.float32)
    d = (d + d.T) / 2
    np.fill_diagonal(d, 0)
    return d


def _jaccard(q, w, seed):
    """Jaccard distances of random bitmaps with duplicate and empty rows:
    many exactly tied distances, as the adaptation round's are."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2 ** 32, (q, w), dtype=np.uint32)
    a[rng.random((q, w)) < 0.5] &= rng.integers(0, 2 ** 32, dtype=np.uint32)
    a[::7] = a[1::7][:len(a[::7])]              # duplicate rows
    a[::5] = 0                                  # empty sets
    return jac.jaccard_distance(a, device="cpu").numpy()


def _check(d, linkage):
    z = hac.hac_torch(d, linkage, device="cpu")
    assert z.dtype == torch.float32 and z.device.type == "cpu"
    z = z.numpy()
    n = d.shape[0]
    assert z.shape == (max(n - 1, 0), 4)
    want = ref_hac.hac_numpy(d.astype(np.float64), linkage)
    np.testing.assert_array_equal(z[:, [0, 1, 3]], want[:, [0, 1, 3]])
    np.testing.assert_allclose(z[:, 2], want[:, 2], rtol=0, atol=DIST_TOL)
    if n > 1:       # hac_jax's traced loop body indexes an empty Z at n = 1
        np.testing.assert_array_equal(
            z, np.asarray(ref_hac.hac_jax(d, linkage)))
    return z


@pytest.mark.parametrize("linkage", LINKAGES)
@pytest.mark.parametrize("n", [1, 2, 64])
def test_random_matrix_matches_reference(n, linkage):
    _check(_random(n, seed=n), linkage)


@pytest.mark.parametrize("linkage", LINKAGES)
def test_tied_distances_merge_the_first_index(linkage):
    d = np.full((6, 6), 0.5, np.float32)
    np.fill_diagonal(d, 0)
    d[2, 4] = d[4, 2] = 0.25
    d[1, 3] = d[3, 1] = 0.25
    z = _check(d, linkage)
    # (1, 3) and (2, 4) tie at 0.25: the first flat index, (1, 3), wins;
    # then every pair ties at 0.5 and the lowest slots merge first
    np.testing.assert_array_equal(z[0], [1, 3, 0.25, 2])
    np.testing.assert_array_equal(z[1], [2, 4, 0.25, 2])
    assert z[2, 0] == 0 and z[2, 2] == 0.5


@pytest.mark.parametrize("linkage", LINKAGES)
@pytest.mark.parametrize("q,w", [(24, 2), (70, 3)])
def test_jaccard_distances_match_reference(q, w, linkage):
    d = _jaccard(q, w, seed=q)
    assert (d == 0).sum() > q                   # ties at 0 besides the diagonal
    z = _check(d, linkage)
    want = ref_hac.hac_numpy(d.astype(np.float64), linkage)
    # cut as the controller runs it, on float64 distances (a float32 Z
    # compares 0.8 with the threshold in float32 under NumPy's promotion)
    for thr in (0.0, 0.4, 0.8):
        np.testing.assert_array_equal(hac.cut(z.astype(np.float64), thr),
                                      ref_hac.cut(want, thr))


def _fma_exact(a, b, c) -> np.float32:
    """a * b + c rounded once to float32, nearest-even, from exact
    rationals."""
    x = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    f = np.float32(float(x))
    cands = [np.nextafter(f, np.float32(-np.inf)), f,
             np.nextafter(f, np.float32(np.inf))]
    errs = [abs(Fraction(float(v)) - x) for v in cands]
    best = min(errs)
    tied = [v for v, e in zip(cands, errs) if e == best]
    return min(tied, key=lambda v: int(np.array(v).view(np.int32)) & 1)


def test_fma32_rounds_once():
    """The average update rounds ``n_i d_i + n_j d_j`` once, as XLA's
    fused multiply-add does: exact against rationals, including sums a
    hair off a float32 midpoint, where rounding in float64 and then in
    float32 would go the wrong way."""
    rng = np.random.default_rng(3)
    a = (rng.integers(1, 600, 500)).astype(np.float32)
    b = (rng.random(500) * 10.0 ** rng.integers(-6, 6, 500)).astype(
        np.float32)
    c = (rng.random(500) * 10.0 ** rng.integers(-12, 6, 500)).astype(
        np.float32)
    x = np.float32(1 + 2 ** -12)          # x * x = 1 + 2^-11 + 2^-24: a tie
    a = np.concatenate([a, [x, x, x]]).astype(np.float32)
    b = np.concatenate([b, [x, x, x]]).astype(np.float32)
    c = np.concatenate([c, [2 ** -60, -2 ** -60, 0]]).astype(np.float32)
    got = hac._fma32(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    want = np.array([_fma_exact(*t) for t in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert got[-3] == np.float32(1 + 2 ** -11 + 2 ** -23)
    assert got[-2] == got[-1] == np.float32(1 + 2 ** -11)


def test_tensor_input_is_left_alone():
    """A tensor goes in as it is, a transposed view included, and comes
    back unchanged."""
    d = _random(40, seed=9)
    t = torch.from_numpy(d.T.copy()).t()          # a non-contiguous view
    z = hac.hac_torch(t, "average", device="cpu")
    np.testing.assert_array_equal(
        z.numpy(), np.asarray(ref_hac.hac_jax(d, "average")))
    assert torch.equal(t, torch.from_numpy(d))


def test_unknown_linkage_raises():
    with pytest.raises(ValueError, match="unknown linkage 'ward'"):
        hac.hac_torch(_random(4, 0), "ward", device="cpu")


def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        z = hac.hac_torch(_random(8, 1), "single")
        assert z.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            hac.hac_torch(_random(8, 1), "single")
