"""repro_torch.core.placement against the reference on the CPU.

The planning is host numpy in both packages; the port computes the expert
Jaccard matrix through its Jaccard op (``device="cpu"``: the kernel's
plain version, bitwise equal to the reference's), so maps and reports
must be equal exactly, not within a tolerance. ``apply_expert_placement``
permutes torch tensors where the reference permutes arrays: the same
permutation, so the weights and slot maps must be equal exactly too.
"""
import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs.base import ArchConfig as RefConfig
from repro.core import placement as rplacement
from repro.models import moe as rmoe
from repro_torch.configs.base import ArchConfig
from repro_torch.core import placement
from repro_torch.kernels import _build
from repro_torch.models import moe


def _moe_cfg(cls=ArchConfig, **kw):
    base = dict(arch_id="t", family="moe", n_layers=1, d_model=16, n_heads=2,
                n_kv_heads=2, d_ff=32, vocab_size=64, n_experts=8, top_k=2,
                capacity_factor=8.0, param_dtype="float32",
                compute_dtype="float32")
    base.update(kw)
    return cls(**base)


def _layer(cfg, seed):
    """One MoE layer's weights drawn with numpy, as ``moe_init`` scales
    them: the reference's dict of arrays and the port's ``MoE``."""
    rng = np.random.default_rng(seed)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    w = {"wr": rng.normal(size=(d, e)) / np.sqrt(d),
         "wg": rng.normal(size=(e, d, f)) / np.sqrt(d),
         "wi": rng.normal(size=(e, d, f)) / np.sqrt(d),
         "wo": rng.normal(size=(e, f, d)) / np.sqrt(f)}
    w = {k: v.astype(np.float32) for k, v in w.items()}
    w["inv_perm"] = np.arange(e, dtype=np.int32)
    return w, moe.MoE(cfg, {k: torch.tensor(v) for k, v in w.items()})


def topical_routing(rng, n_requests, n_experts, k, noise=0.1, topic=None):
    """``examples/adaptive_moe.py``'s workload: the experts fall into topics
    of ``topic`` experts (``k`` when omitted, as there: 8 topics of 8 at 64
    experts); each request picks ``k`` of one topic's experts, each pick
    replaced by a random expert with probability ``noise``."""
    topics = rng.permutation(n_experts).reshape(-1, topic or k)
    out = np.empty((n_requests, k), np.int64)
    for i in range(n_requests):
        t = topics[rng.integers(len(topics))]
        picks = list(rng.permutation(t)[:k])
        for j in range(k):
            if rng.random() < noise:
                picks[j] = int(rng.integers(n_experts))
        out[i] = picks
    return out


# --------------------------------------------------------------------------- #
# counterparts of tests/test_placement_moe.py's CPU cases
# --------------------------------------------------------------------------- #

def test_placement_reduces_dispatch_bytes(rng):
    e, r, t, k = 32, 4, 512, 4
    topics = rng.permutation(e).reshape(8, 4)
    req_topic = rng.integers(0, 8, t)
    routing = np.stack([rng.permutation(topics[ti])[:k] for ti in req_topic])
    e2r, rep = placement.plan_expert_placement(routing, e, r, device="cpu")
    assert rep.accepted
    assert rep.ranks_after < rep.ranks_before
    assert rep.bytes_saved_frac > 0.3
    assert (np.bincount(e2r, minlength=r) == e // r).all()   # balance


def test_placement_reverts_when_no_gain(rng):
    """Uniform random routing: clustering can't help -> guard reverts."""
    e, r = 16, 4
    routing = rng.integers(0, e, (256, 4))
    old = np.repeat(np.arange(r), e // r).astype(np.int32)
    e2r, rep = placement.plan_expert_placement(
        routing, e, r, old_expert_to_rank=old, device="cpu")
    if not rep.accepted:
        assert (e2r == old).all()
        assert rep.moved_experts == 0


@given(st.integers(0, 2 ** 31 - 1))
@settings(max_examples=15, deadline=None)
def test_placement_is_valid_permutation(seed):
    rng = np.random.default_rng(seed)
    e, r = 16, 4
    routing = rng.integers(0, e, (64, 3))
    e2r, _ = placement.plan_expert_placement(routing, e, r, device="cpu")
    perm = placement.rank_map_to_perm(e2r)
    assert sorted(perm.tolist()) == list(range(e))
    assert (np.bincount(e2r, minlength=r) == e // r).all()


def test_apply_placement_preserves_function(rng):
    cfg = _moe_cfg()
    _, layer = _layer(cfg, 0)
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 4, 16))
                         .astype(np.float32))
    y0, _ = moe.moe_apply(layer, x, cfg)
    e2r = placement.plan_expert_placement(
        rng.integers(0, 8, (64, 2)), 8, 2, device="cpu")[0]
    layer.load_state_dict(placement.apply_expert_placement(
        layer.state_dict(), e2r))
    y1, _ = moe.moe_apply(layer, x, cfg)
    np.testing.assert_allclose(y0.numpy(), y1.numpy(), atol=1e-5)


def test_vocab_permutation_balances_bpe_order():
    v = 4096
    counts = 1.0 / (np.arange(v) + 100.0) ** 0.9   # BPE-like: hot ids first
    ident = placement.shard_gather_imbalance(
        counts, np.arange(v, dtype=np.int32), 16)
    perm = placement.vocab_permutation(counts, 16)
    placed = placement.shard_gather_imbalance(counts, perm, 16)
    assert sorted(perm.tolist()) == list(range(v))
    assert ident > 2.0
    assert placed < 1.05


# --------------------------------------------------------------------------- #
# the port against the reference
# --------------------------------------------------------------------------- #

# (experts, ranks, k, requests, workload): the example's olmoe geometry
# and qwen3-moe-30b-a3b's 128 experts under topical routing (topics of k
# experts; "wide": 8 topics of 16, whose experts share a request a third
# as often as either is used, a Jaccard distance of about 2/3, above the
# 0.6 cut, so clusters hardly form), small shapes under
# topical and uniform routing, requests off a 32-bit word
PLAN_CASES = [
    (64, 16, 8, 2048, "topical"),
    (128, 16, 8, 2048, "topical"),
    (128, 16, 8, 2048, "wide"),
    (32, 4, 4, 500, "topical"),
    (16, 4, 3, 256, "uniform"),
    (16, 2, 2, 33, "uniform"),
]


@pytest.mark.parametrize("case", PLAN_CASES, ids=str)
@pytest.mark.parametrize("seed", [0, 1])
def test_plan_equals_reference_exactly(case, seed):
    e, r, k, n, kind = case
    rng = np.random.default_rng(seed)
    routing = (rng.integers(0, e, (n, k)) if kind == "uniform" else
               topical_routing(rng, n, e, k,
                               topic=16 if kind == "wide" else None))
    old = rng.permutation(np.repeat(np.arange(r), e // r)).astype(np.int32)
    for prior in (None, old):
        _build.reset_launches()
        got = placement.plan_expert_placement(
            routing, e, r, prior, 3 * 4096, device="cpu")
        assert not _build.launches        # the CPU runs the plain version
        want = rplacement.plan_expert_placement(routing, e, r, prior,
                                                3 * 4096)
        assert got[0].dtype == want[0].dtype
        assert np.array_equal(got[0], want[0])
        assert got[1] == placement.PlacementReport(
            **vars(want[1])), (got[1], want[1])
        if kind == "topical":
            assert got[1].accepted


def test_coactivation_bitmaps_and_clusters_equal_reference():
    rng = np.random.default_rng(3)
    routing = topical_routing(rng, 1000, 64, 8)
    bm = placement.coactivation_bitmaps(routing, 64, 1000)
    assert np.array_equal(bm, rplacement.coactivation_bitmaps(routing, 64,
                                                              1000))
    for cut in (0.3, 0.6, 0.9):
        assert np.array_equal(
            placement.cluster_experts(bm, cut_distance=cut, device="cpu"),
            rplacement.cluster_experts(bm, cut_distance=cut))


def test_apply_placement_composes_as_reference_does():
    """Two rounds of migration on one layer: the port's permuted weights
    and slot map equal the reference's exactly after each, and the layer
    computes the reference's dense function on the placed weights."""
    cfg = _moe_cfg(n_experts=16, top_k=4)
    rcfg = _moe_cfg(RefConfig, n_experts=16, top_k=4)
    w, layer = _layer(cfg, 5)
    ref = {key: jax.numpy.asarray(v) for key, v in w.items()}
    port = layer.state_dict()
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 8, 16)).astype(np.float32)
    old = None
    for _ in range(2):
        e2r, rep = rplacement.plan_expert_placement(
            topical_routing(rng, 256, 16, 4), 16, 4, old)
        ref = rplacement.apply_expert_placement(ref, e2r)
        port = placement.apply_expert_placement(port, e2r)
        for key in ("wg", "wi", "wo", "inv_perm"):
            assert port[key].dtype == (torch.int32 if key == "inv_perm"
                                       else torch.float32)
            assert np.array_equal(port[key].numpy(), np.asarray(ref[key])), \
                key
        old = e2r
    assert not np.array_equal(port["inv_perm"].numpy(), np.arange(16))
    layer.load_state_dict(port)
    y, _ = moe.moe_apply(layer, torch.from_numpy(x), cfg)
    want, _ = rmoe.moe_apply_dense(ref, jax.numpy.asarray(x), rcfg)
    assert float(np.abs(y.numpy() - np.asarray(want)).max()) <= 1e-5


@pytest.mark.parametrize("n_shards", [2, 7, 16])
@pytest.mark.parametrize("dist", ["zipf", "uniform", "ties"])
def test_vocab_permutation_and_imbalance_equal_reference(n_shards, dist):
    v = 1000
    rng = np.random.default_rng(n_shards)
    counts = {"zipf": 1.0 / (np.arange(v) + 10.0) ** 1.1,
              "uniform": rng.random(v),
              "ties": rng.integers(0, 4, v).astype(np.float64)}[dist]
    perm = placement.vocab_permutation(counts, n_shards)
    want = rplacement.vocab_permutation(counts, n_shards)
    assert perm.dtype == want.dtype and np.array_equal(perm, want)
    for p in (perm, np.arange(v, dtype=np.int32)):
        assert placement.shard_gather_imbalance(counts, p, n_shards) == \
            rplacement.shard_gather_imbalance(counts, p, n_shards)
