"""repro_torch's TorchExecutor against the reference NumpyExecutor.

One dataset and one layout are put into both packages (the port's side
through ``repro_torch.interop``); the port's ``TorchExecutor(device="cpu")``
runs every join through the plain PyTorch versions of the join kernels.
Bindings (canonicalised) and every ``ExecStats.COMPARABLE`` field must be
equal, on LUBM(1) windows, a replicated layout, a mid-drain epoch and
random small stores.
"""
import numpy as np
import pytest

from conftest import canon_bindings
from repro.api import KGService as RefService
from repro.api.facade import PartitionedKG as RefKG
from repro.core.features import FeatureSpace as RefSpace
from repro.core.partition import hash_partition
from repro.graph.triples import Dictionary, build_store
from repro.query import exec as ref_exec
from repro.query.pattern import Query, is_var, var
from repro_torch import interop
from repro_torch.api.facade import PartitionedKG
from repro_torch.query import exec as qexec


def _terms(d):
    return [d.decode(i) for i in range(len(d))]


def _carry(ref_kg) -> PartitionedKG:
    """The reference facade's store, universe and layout, in the port."""
    store = interop.triple_store(ref_kg.store.triples,
                                 _terms(ref_kg.store.dictionary))
    space = interop.feature_space(store, ref_kg.space.feature_keys(),
                                  ref_kg.space.type_predicate)
    state = interop.partition_state(ref_kg.state.feature_to_shard,
                                    ref_kg.state.feature_sizes,
                                    ref_kg.n_shards)
    return PartitionedKG(store, space, state,
                         replicas=interop.replica_map(ref_kg.replicas.masks,
                                                      ref_kg.n_shards))


def _port_query(q):
    return interop.query((q.name, q.patterns, q.frequency, q.shape))


def _assert_window_equal(ref_kg, queries):
    kg = _carry(ref_kg)
    np.testing.assert_array_equal(kg.triple_shard, ref_kg.triple_shard)
    ref_plans = [ref_kg.plan(q) for q in queries]
    plans = [kg.plan(_port_query(q)) for q in queries]
    assert [p.ppn for p in plans] == [p.ppn for p in ref_plans]
    want = ref_exec.NumpyExecutor().run_batch(ref_plans, ref_kg)
    for ex in (qexec.TorchExecutor(device="cpu"), qexec.NumpyExecutor()):
        got = ex.run_batch(plans, kg)
        for q, (rb, rs), (b, s) in zip(queries, want, got):
            assert canon_bindings(b) == canon_bindings(rb), (ex.name, q.name)
            for f in ref_exec.ExecStats.COMPARABLE:
                assert getattr(s, f) == getattr(rs, f), (ex.name, q.name, f)


def test_lubm_window_bootstrap_layout(small_lubm):
    svc = RefService.from_dataset(small_lubm, n_shards=4)
    kg = svc.bootstrap(small_lubm.base_workload())
    _assert_window_equal(kg, small_lubm.extended_workload())


def test_lubm_window_replicated_layout(small_lubm):
    svc = RefService.from_dataset(small_lubm, n_shards=4,
                                  replica_budget=1 << 20)
    kg = svc.bootstrap(small_lubm.base_workload())
    window = small_lubm.extended_workload()
    svc.query_batch(window)
    svc.adapt(small_lubm.workload([f"EQ{i}" for i in range(1, 11)]))
    assert kg.replicas.has_replicas
    _assert_window_equal(kg, window)


def test_lubm_window_mid_drain_epoch(small_lubm):
    svc = RefService.from_dataset(small_lubm, n_shards=4,
                                  migration_budget=120_000)
    kg = svc.bootstrap(small_lubm.base_workload())
    window = small_lubm.extended_workload()
    svc.query_batch(window)
    report = svc.adapt(small_lubm.workload([f"EQ{i}" for i in range(1, 11)]))
    assert report.accepted and svc.session is not None
    svc.step()
    assert svc.session is not None          # a hybrid layout is served
    _assert_window_equal(kg, window)


def _random_kg(rng, n_shards):
    d = Dictionary()
    for i in range(40):
        d.encode(f"t{i}")
    t = np.stack([rng.integers(0, 40, 400), rng.integers(0, 6, 400),
                  rng.integers(0, 40, 400)], axis=1).astype(np.int32)
    store = build_store(t, d)
    space = RefSpace(store)
    state = hash_partition(space.feature_sizes(), n_shards, seed=3)
    return RefKG(store, space, state)


def _random_query(rng, store, name):
    """Random BGP: chains and stars over shared variables, constant
    objects, repeated intra-pattern variables, disconnected (cartesian)
    patterns and unbound predicates."""
    pats, pool, nv = [], [], 0
    for _ in range(int(rng.integers(1, 5))):
        row = store.triples[rng.integers(store.n_triples)]
        p = int(row[1]) if rng.random() > 0.1 else var(98)
        if pool and rng.random() < 0.7:
            s = pool[rng.integers(len(pool))]
        else:
            s, nv = var(nv), nv + 1
        u = rng.random()
        if u < 0.45:
            o = int(row[2])
        elif u < 0.6 and pool:
            o = pool[rng.integers(len(pool))]
        elif u < 0.7:
            o = s
        else:
            o, nv = var(nv), nv + 1
        pool += [x for x in (s, o) if is_var(x) and x not in pool]
        pats.append((s, p, o))
    return Query(name=name, patterns=tuple(pats))


@pytest.mark.parametrize("seed", range(6))
def test_random_bgps_on_random_layouts(seed):
    rng = np.random.default_rng(seed)
    ref_kg = _random_kg(rng, int(rng.integers(1, 7)))
    queries = [_random_query(rng, ref_kg.store, f"R{i}") for i in range(5)]
    _assert_window_equal(ref_kg, queries)


def _ragged_kg():
    """Every probe row matches every build row through one shared entity:
    a 20 x 12 hash-join expansion that is not a cartesian plan op."""
    d = Dictionary()
    for i in range(40):
        d.encode(f"t{i}")
    rows = [[3 + i, 1, 5] for i in range(20)] + \
        [[25 + j, 2, 5] for j in range(12)]
    store = interop.triple_store(np.array(rows, np.int32), _terms(d))
    space = interop.feature_space(store, [("P", 1), ("P", 2)])
    state = interop.partition_state([0, 2], space.feature_sizes(), 3)
    q = interop.query(("H", ((var(0), 1, var(1)), (var(2), 2, var(1))),
                       1.0, ""))
    return q, PartitionedKG(store, space, state)


def test_expansion_cap_enforced():
    q, kg = _ragged_kg()
    plan = kg.plan(q)
    _, stats = qexec.TorchExecutor(device="cpu").run(plan, kg)
    assert stats.expanded_rows == stats.rows == 240
    with pytest.raises(qexec.JoinCapExceeded, match="240 rows"):
        qexec.TorchExecutor(max_join_rows=239, device="cpu").run(plan, kg)


def test_executor_registry():
    assert qexec.get_executor("torch", device="cpu").name == "torch"
    assert qexec.get_executor("numpy").name == "numpy"
    ex = qexec.TorchExecutor(device="cpu")
    assert qexec.get_executor(ex) is ex
    with pytest.raises(ValueError, match="torch"):
        qexec.get_executor("jax-pallas")
