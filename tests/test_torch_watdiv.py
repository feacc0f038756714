"""repro_torch.graph.watdiv: the port's copy of the seeded
star/path/snowflake/complex generator.

Each test of the reference's ``tests/test_watdiv.py`` has a counterpart
here on the port (answerability through the port's numpy executor and, on
the CPU, its torch executor), and ``generate(s, seed)`` must give the
reference's dataset exactly at s = 1 and 3: the same triples, terms,
named entities, 16 templates and topics.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from conftest import canon_bindings
from repro.graph import watdiv as ref_watdiv
from repro_torch.api import HashPartitioner, KGService
from repro_torch.graph import lubm, watdiv
from repro_torch.graph.triples import Dictionary, TripleStore
from repro_torch.query.pattern import Query, is_var

SHAPES = ("star", "linear", "snowflake", "complex")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the CPU tier's ops are
    small, and test workers running side by side would otherwise each
    spin a thread per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def watdiv1():
    return watdiv.load(1, seed=0)


@pytest.fixture(scope="module", params=["numpy", "torch"])
def watdiv_svc(watdiv1, request):
    """One port service per executor for answerability checks (hash
    layout — bindings are layout-invariant)."""
    svc = KGService(watdiv1.store, 4, HashPartitioner(),
                    executor=request.param, device="cpu",
                    type_predicate=watdiv1.dictionary.lookup("rdf:type"))
    svc.bootstrap(())
    return svc


# --------------------------------------------------------------------------- #
# the port's generator is the reference's
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("scale,seed", [(1, 0), (1, 5), (3, 0)])
def test_generate_equals_reference(scale, seed):
    got, want = watdiv.generate(scale, seed), ref_watdiv.generate(scale, seed)
    assert got.scale == want.scale == scale
    assert got.store.triples.dtype == want.store.triples.dtype
    np.testing.assert_array_equal(got.store.triples, want.store.triples)
    assert len(got.dictionary) == len(want.dictionary)
    assert [got.dictionary.decode(i) for i in range(len(got.dictionary))] \
        == [want.dictionary.decode(i) for i in range(len(want.dictionary))]
    assert vars(got.named) == vars(want.named)
    assert sorted(got.queries) == sorted(want.queries)
    assert len(got.queries) == 16
    for name, q in want.queries.items():
        p = got.queries[name]
        assert (p.name, p.patterns, p.frequency, p.shape) \
            == (q.name, q.patterns, q.frequency, q.shape)
    assert got.topics == want.topics
    rng_a, rng_b = np.random.default_rng(1), np.random.default_rng(1)
    for _ in range(8):
        a, b = got.sample_query(rng_a), want.sample_query(rng_b)
        assert (a.name, a.patterns, a.shape) == (b.name, b.patterns, b.shape)


# --------------------------------------------------------------------------- #
# graph shape
# --------------------------------------------------------------------------- #

def test_generated_graph_shape(watdiv1):
    st_ = watdiv1.store
    assert st_.n_triples > 10_000
    assert st_.triples.dtype == np.int32
    d = watdiv1.dictionary
    used = set(np.unique(st_.triples[:, 1]).tolist())
    for term in watdiv.PROPERTIES:
        pid = d.lookup(term)
        assert pid is not None and pid in used, term
    tp = d.lookup("rdf:type")
    prod = d.lookup("wsdbm:Product")
    products = set(st_.match(None, tp, prod)[:, 0].tolist())
    for cls, supers in watdiv.SUPERCLASSES.items():
        cid = d.lookup(cls)
        members = st_.match(None, tp, cid)
        assert len(members) > 0, cls
        assert "wsdbm:Product" in supers
        assert set(members[:, 0].tolist()) <= products


def test_scale_grows_the_graph():
    small = watdiv.generate(1, seed=0)
    big = watdiv.generate(2, seed=0)
    assert big.store.n_triples > 1.5 * small.store.n_triples


# --------------------------------------------------------------------------- #
# answerability (templates + witness-walk samples)
# --------------------------------------------------------------------------- #

def test_all_templates_answerable(watdiv1, watdiv_svc):
    assert len(watdiv1.queries) == 16
    by_shape = {s: watdiv1.family(s) for s in SHAPES}
    assert [len(by_shape[s]) for s in SHAPES] == [5, 5, 3, 3]
    for name, q in sorted(watdiv1.queries.items()):
        bindings, _ = watdiv_svc.query(q)
        rows = canon_bindings(bindings)
        assert rows, f"template {name} unanswerable"
        assert set(bindings) == {v for pat in q.patterns
                                 for v in pat if is_var(v)}


def test_topics_cover_and_partition_templates(watdiv1):
    names = [n for t in sorted(watdiv1.topics) for n in watdiv1.topics[t]]
    assert sorted(names) == sorted(watdiv1.queries)
    for t in watdiv1.topics:
        assert [q.name for q in watdiv1.topic_workload(t)] \
            == list(watdiv1.topics[t])


@given(st.integers(0, 2 ** 31 - 1), st.sampled_from(SHAPES))
@settings(max_examples=20, deadline=None)
def test_sampled_queries_answerable(watdiv1, watdiv_svc, seed, shape):
    q = watdiv1.sample_query(np.random.default_rng(seed), shape=shape)
    assert q.shape == shape and q.name.startswith(shape[0].upper())
    assert 2 <= len(q.patterns) <= 8
    bindings, _ = watdiv_svc.query(q)
    assert canon_bindings(bindings), (seed, shape, q.patterns)


@given(st.integers(0, 2 ** 31 - 1))
@settings(max_examples=10, deadline=None)
def test_sampler_is_deterministic(watdiv1, seed):
    a = watdiv1.sample_query(np.random.default_rng(seed))
    b = watdiv1.sample_query(np.random.default_rng(seed))
    assert a.name == b.name and a.shape == b.shape
    assert a.patterns == b.patterns


# --------------------------------------------------------------------------- #
# determinism of generation
# --------------------------------------------------------------------------- #

def test_generation_byte_identical_for_fixed_seed():
    a = watdiv.generate(1, seed=7)
    b = watdiv.generate(1, seed=7)
    assert a.store.triples.tobytes() == b.store.triples.tobytes()
    assert sorted(a.queries) == sorted(b.queries)
    for n in a.queries:
        assert a.queries[n].patterns == b.queries[n].patterns
    assert a.named == b.named
    assert a.topics == b.topics


def test_different_seeds_differ():
    a = watdiv.generate(1, seed=0)
    b = watdiv.generate(1, seed=1)
    assert a.store.triples.tobytes() != b.store.triples.tobytes()


def test_load_memoizes():
    assert watdiv.load(1, seed=0) is watdiv.load(1, seed=0)


# --------------------------------------------------------------------------- #
# Dataset duck-type conformance, shared across both graph families
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module", params=["lubm", "watdiv"])
def dataset(request):
    return (lubm.load(1, seed=0) if request.param == "lubm"
            else watdiv.load(1, seed=0))


def test_dataset_conformance(dataset):
    ds = dataset
    assert isinstance(ds.store, TripleStore)
    assert isinstance(ds.dictionary, Dictionary)
    assert isinstance(ds.dictionary.lookup("rdf:type"), (int, np.integer))
    assert ds.queries and all(isinstance(q, Query)
                              for q in ds.queries.values())
    assert all(q.name == n for n, q in ds.queries.items())
    base, ext = ds.base_workload(), ds.extended_workload()
    assert base and set(q.name for q in base) <= set(ds.queries)
    assert ext and set(q.name for q in ext) <= set(ds.queries)
    names = sorted(ds.queries)[:2]
    w = ds.workload(names, {names[0]: 4.0})
    assert [q.name for q in w] == names
    assert w[0].frequency == 4.0 and w[1].frequency == 1.0


@pytest.mark.parametrize("executor", ["numpy", "torch"])
def test_dataset_serves_through_from_dataset(dataset, executor):
    svc = KGService.from_dataset(dataset, n_shards=4,
                                 partitioner=HashPartitioner(),
                                 executor=executor, device="cpu")
    svc.bootstrap(dataset.base_workload())
    name = sorted(dataset.queries)[0]
    bindings, stats = svc.query(dataset.queries[name])
    assert stats.rows == len(canon_bindings(bindings))
