"""repro_torch.query.rewrite and repro_torch.query.engine against the
reference.

``rewrite`` renders a query's federated SPARQL form under the current
partition metadata: for every LUBM query at LUBM(1) on 4 shards, after
``bootstrap`` and after an accepted ``adapt`` (with and without read
replicas), the port's string must equal the reference's character for
character, and so must ``service_counts``. ``engine`` keeps
``ShardedStore`` and the deprecated free-function shims: on the same
layout they must return what the reference's return (bindings and every
COMPARABLE stat exactly, modeled times exactly) and warn the same way.
"""
import warnings

import numpy as np
import pytest
import torch

from conftest import canon_bindings
from repro.api import KGService as RefService
from repro.graph import lubm as ref_lubm
from repro.query import engine as ref_engine
from repro.query import rewrite as ref_rewrite
from repro_torch.api import KGService
from repro_torch.graph import lubm
from repro_torch.query import engine, rewrite
from repro_torch.query.exec import ExecStats

EQ = [f"EQ{i}" for i in range(1, 11)]
ENDPOINTS = [f"https://shard-{i}.example/sparql" for i in range(4)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the CPU tier's ops are
    small, and test workers running side by side would otherwise each
    spin a thread per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(replica_budget):
    """The reference (numpy) and the port (torch executor on the CPU) on the
    same LUBM(1) dataset and strategy, each bootstrapped. Both generated
    afresh: ``lubm.load`` memoizes a dataset that write tests mutate."""
    ref_ds = ref_lubm.generate(1, seed=0)
    ref = RefService.from_dataset(ref_ds, 4, executor="numpy",
                                  replica_budget=replica_budget)
    port_ds = lubm.generate(1, seed=0)
    port = KGService.from_dataset(port_ds, 4, device="cpu",
                                  replica_budget=replica_budget)
    for svc, ds in ((ref, ref_ds), (port, port_ds)):
        svc.bootstrap(ds.base_workload())
        svc.query_batch(ds.extended_workload())
    return (ref, ref_ds), (port, port_ds)


def _render(mod, svc, ds, endpoints=None):
    kg = svc.kg
    return {name: (mod.federated_sparql(q, svc.space, kg.state,
                                        ds.dictionary, endpoints=endpoints,
                                        replicas=kg.replicas),
                   mod.federated_sparql(q, svc.space, kg.state),
                   mod.service_counts(q, svc.space, kg.state, kg.replicas))
            for name, q in sorted(ds.queries.items())}


@pytest.fixture(scope="module", params=[None, 200_000],
                ids=["primaries", "replicas"])
def renderings(request):
    (ref, ref_ds), (port, port_ds) = _pair(request.param)
    out = {"bootstrap": (_render(ref_rewrite, ref, ref_ds, ENDPOINTS),
                         _render(rewrite, port, port_ds, ENDPOINTS))}
    reports = [svc.adapt(ds.workload(EQ))
               for svc, ds in ((ref, ref_ds), (port, port_ds))]
    assert all(r.accepted for r in reports)
    assert reports[0].plan.summary() == reports[1].plan.summary()
    if request.param is not None:
        assert len(port.kg.replicas.replicated()) > 0
    out["adapted"] = (_render(ref_rewrite, ref, ref_ds, ENDPOINTS),
                      _render(rewrite, port, port_ds, ENDPOINTS))
    return out


@pytest.mark.parametrize("stage", ["bootstrap", "adapted"])
def test_federated_sparql_equals_reference(renderings, stage):
    want, got = renderings[stage]
    assert len(got) == 24 and sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name
    # the layout really federates: some query carries a SERVICE clause
    assert any("SERVICE <https://shard-" in g[0] for g in got.values())


def test_adaptation_changes_the_rewrite(renderings):
    before, after = renderings["bootstrap"][1], renderings["adapted"][1]
    assert any(before[n] != after[n] for n in before)


# --------------------------------------------------------------------------- #
# engine: ShardedStore and the deprecated shims
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def sharded():
    (ref, ref_ds), (port, port_ds) = _pair(None)
    for svc, ds in ((ref, ref_ds), (port, port_ds)):
        assert svc.adapt(ds.workload(EQ)).accepted
    return ((ref_engine.ShardedStore(ref.store, ref.space, ref.kg.state),
             ref_ds),
            (engine.ShardedStore(port.store, port.space, port.kg.state),
             port_ds))


def test_sharded_store_equals_reference(sharded):
    (want, _), (got, _) = sharded
    assert got.n_shards == want.n_shards == 4
    assert got.shard_sizes() == want.shard_sizes()
    np.testing.assert_array_equal(got.triple_shard, want.triple_shard)
    for g, w in zip(got.shards, want.shards):
        np.testing.assert_array_equal(g.triples, w.triples)


def _call(mod, name, *args):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = getattr(mod, name)(*args)
    assert len(caught) == 1
    w = caught[0]
    return out, (w.category, str(w.message), w.filename)


def _same_warning(got, want):
    assert got[0] is want[0] is DeprecationWarning
    assert got[1] == want[1].replace("repro.query.engine",
                                     "repro_torch.query.engine")
    assert got[1].startswith("repro_torch.query.engine.")
    assert got[2] == want[2] == __file__     # stacklevel: the caller


def _same_stats(got, want):
    for f in ExecStats.COMPARABLE:
        assert getattr(got, f) == getattr(want, f), f
    assert got.modeled_time() == want.modeled_time()


@pytest.mark.parametrize("name", ["Q2", "Q9", "EQ3"])
def test_execute_shim_equals_reference(sharded, name):
    (ref_sh, ref_ds), (sh, ds) = sharded
    (rb, rs), rw = _call(ref_engine, "execute", ref_ds.queries[name], ref_sh)
    (b, s), w = _call(engine, "execute", ds.queries[name], sh)
    _same_warning(w, rw)
    assert canon_bindings(b) == canon_bindings(rb)
    _same_stats(s, rs)


def test_workload_shims_equal_reference(sharded):
    (ref_sh, ref_ds), (sh, ds) = sharded
    (rt, rst), rw = _call(ref_engine, "run_workload",
                          ref_ds.extended_workload(), ref_sh)
    (t, st), w = _call(engine, "run_workload", ds.extended_workload(), sh)
    _same_warning(w, rw)
    assert t == rt
    for n in rst:
        _same_stats(st[n], rst[n])
    biased = ds.workload([q.name for q in ds.base_workload()], {"Q1": 13.0})
    rbiased = ref_ds.workload([q.name for q in ref_ds.base_workload()],
                              {"Q1": 13.0})
    ravg, rw = _call(ref_engine, "workload_average_time", rbiased, ref_sh)
    avg, w = _call(engine, "workload_average_time", biased, sh)
    _same_warning(w, rw)
    assert avg == ravg


@pytest.mark.parametrize("name", ["Q4", "Q9", "EQ7"])
def test_profile_shims_equal_reference(sharded, name):
    (ref_sh, ref_ds), (sh, ds) = sharded
    rprof, rw = _call(ref_engine, "profile_query", ref_ds.queries[name],
                      ref_sh.store)
    prof, w = _call(engine, "profile_query", ds.queries[name], sh.store)
    _same_warning(w, rw)
    for f in ("join_rows", "rows", "n_patterns", "cartesian_rows",
              "expanded_rows"):
        assert getattr(prof, f) == getattr(rprof, f), f
    assert len(prof.pattern_rows) == len(rprof.pattern_rows)
    for g, r in zip(prof.pattern_rows, rprof.pattern_rows):
        np.testing.assert_array_equal(g, r)
    rst, rw = _call(ref_engine, "stats_from_profile", ref_ds.queries[name],
                    rprof, ref_sh.space, ref_sh.state, ref_sh.triple_shard)
    st, w = _call(engine, "stats_from_profile", ds.queries[name], prof,
                  sh.space, sh.state, sh.triple_shard)
    _same_warning(w, rw)
    _same_stats(st, rst)


def test_reexports_are_the_ports():
    from repro_torch.query import exec as qexec
    from repro_torch.query import plan as qplan
    assert engine.ExecStats is qexec.ExecStats
    assert engine.NetworkModel is qexec.NetworkModel
    assert engine.QueryProfile is qplan.QueryProfile
    assert engine._primary_shard is qplan.primary_shard
