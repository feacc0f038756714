"""repro_torch on the card: each hand-written kernel against its plain
PyTorch version, and the serving loop on the card against the same loop
on the CPU.

These tests need a CUDA device (the kernels have no CPU mode) and skip
without one. They import only torch, numpy and repro_torch, so they also
run where jax is not installed:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.jaccard import ops as jac
from repro_torch.kernels.join import ops as J

pytestmark = pytest.mark.cuda


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
