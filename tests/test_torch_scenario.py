"""repro_torch.scenario: drift schedules and the reactivity driver, held
against the reference.

Each test of the reference's ``tests/test_scenario.py`` has a counterpart
here on the port. Besides: every factory's schedule equals the
reference's window for window; ``run_scenario`` on the port, with its
torch executor (on the CPU) and its numpy executor, gives the reference's
numpy run record for record, adaptive and frozen, with writes and with a
budgeted drain; and the streamed schedule serves what the port's own
synchronous replay serves on both executors, with the numpy executor's
synchronous run as the oracle (the reference's own streamed test needs
jax's ``enable_x64``).
"""
import dataclasses

import numpy as np
import pytest
import torch

from conftest import canon_bindings
from repro import scenario as ref_drift
from repro.api import KGService as RefService
from repro.api import MigrationSession as RefSession
from repro.core import migration as ref_migration
from repro.core.partition import hash_partition as ref_hash_partition
from repro.graph import watdiv as ref_watdiv
from repro.graph.triples import TripleStore as RefStore
from repro.replicate import ReplicaMap as RefReplicaMap
from repro_torch import scenario as drift
from repro_torch.api import KGService, MigrationSession, WriteBatch
from repro_torch.core import migration
from repro_torch.core.partition import hash_partition
from repro_torch.graph import watdiv
from repro_torch.graph.triples import TripleStore
from repro_torch.replicate import ReplicaMap

EXECUTORS = ("numpy", "torch")
FACTORIES = ("diurnal", "flash_crowd", "hot_set_churn", "mixed_read_write")

PORT = dict(drift=drift, service=KGService, session=MigrationSession,
            migration=migration, hash_partition=hash_partition,
            replicas=ReplicaMap, store=TripleStore)
REF = dict(drift=ref_drift, service=RefService, session=RefSession,
           migration=ref_migration, hash_partition=ref_hash_partition,
           replicas=RefReplicaMap, store=RefStore)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the CPU tier's ops are
    small, and test workers running side by side would otherwise each
    spin a thread per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# generated afresh: ``watdiv.load`` memoizes a dataset other test modules
# share
@pytest.fixture(scope="module")
def ds():
    return watdiv.generate(1, seed=0)


@pytest.fixture(scope="module")
def ref_ds():
    return ref_watdiv.generate(1, seed=0)


def _fresh_service(ds, executor="numpy", n_shards=4, side=PORT, **kwargs):
    """Service over a COPY of the memoized store — scenario writes mutate
    stores in place and twins must not share one."""
    store = side["store"](ds.store.triples.copy(), ds.store.dictionary)
    if side is PORT:
        kwargs["device"] = "cpu"
    return side["service"](store, n_shards,
                           type_predicate=ds.dictionary.lookup("rdf:type"),
                           executor=executor, **kwargs)


def _force_session(svc, seed=0, side=PORT):
    """Put a deterministic budgeted migration (with replica promotions) in
    flight, so the replay serves hybrid layouts across several epochs."""
    sizes = svc.space.feature_sizes()
    target = side["hash_partition"](sizes, svc.n_shards, seed=seed)
    reps = side["replicas"].primary_only(target)
    rng = np.random.default_rng(seed)
    for f in range(len(target.feature_to_shard)):
        if rng.random() < 0.2:
            reps.add(f, int(rng.integers(svc.n_shards)))
    budget = max(int(sizes.sum()) * side["migration"].TRIPLE_BYTES // 6, 1)
    svc.session = side["session"](svc.kg, target, bytes_budget=budget,
                                  target_replicas=reps)
    assert svc.session.n_chunks >= 3


def _factory(side, name):
    return getattr(side["drift"], name)


# --------------------------------------------------------------------------- #
# the port's schedules are the reference's
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("factory", FACTORIES)
def test_schedule_equals_reference(ds, ref_ds, factory):
    got = _factory(PORT, factory)(ds, seed=3).schedule(ds)
    want = _factory(REF, factory)(ref_ds, seed=3).schedule(ref_ds)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g.index, g.phase, g.onset, g.mix_key) \
            == (w.index, w.phase, w.onset, w.mix_key)
        assert [(q.name, q.patterns, q.frequency) for q in g.queries] \
            == [(q.name, q.patterns, q.frequency) for q in w.queries]
        if w.write_rows is None:
            assert g.write_rows is None
        else:
            assert g.write_rows.dtype == w.write_rows.dtype
            assert g.write_rows.tobytes() == w.write_rows.tobytes()


# --------------------------------------------------------------------------- #
# schedule determinism
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("factory", FACTORIES)
def test_schedule_is_deterministic(ds, factory):
    make = _factory(PORT, factory)
    a = make(ds, seed=11).schedule(ds)
    b = make(ds, seed=11).schedule(ds)
    assert len(a) == len(b) > 0
    for wa, wb in zip(a, b):
        assert (wa.index, wa.phase, wa.onset, wa.mix_key) \
            == (wb.index, wb.phase, wb.onset, wb.mix_key)
        assert [q.name for q in wa.queries] == [q.name for q in wb.queries]
        if wa.write_rows is None:
            assert wb.write_rows is None
        else:
            assert wa.write_rows.tobytes() == wb.write_rows.tobytes()
    c = make(ds, seed=12).schedule(ds)
    assert [[q.name for q in w.queries] for w in a] \
        != [[q.name for q in w.queries] for w in c], "seed ignored"


@pytest.mark.parametrize("factory", FACTORIES)
def test_schedule_structure(ds, factory):
    scn = _factory(PORT, factory)(ds, seed=0)
    windows = scn.schedule(ds)
    assert windows[0].onset is False
    assert sum(w.onset for w in windows) == len(scn.phases) - 1
    assert [w.index for w in windows] == list(range(len(windows)))
    assert sum(1 for _ in windows) == sum(p.windows for p in scn.phases)
    for w in windows:
        assert len(w.queries) == scn.queries_per_window
        assert all(q.name in ds.queries for q in w.queries)
    boot = {q.name for q in scn.bootstrap_workload(ds)}
    assert boot == {n for n, x in scn.phases[0].mix if x > 0}


def test_write_rows_use_fresh_disjoint_subjects(ds):
    scn = drift.mixed_read_write(ds, read_windows=1, write_windows=3,
                                 cool_windows=1, writes_per_window=8,
                                 queries_per_window=4, seed=4)
    windows = scn.schedule(ds)
    burst = [w for w in windows if w.write_rows is not None]
    assert len(burst) == 3
    top = int(ds.store.triples.max())
    seen = set()
    for w in burst:
        subjects = set(w.write_rows[:, 0].tolist())
        assert all(s > top for s in subjects), "subject collides with graph"
        assert not (subjects & seen), "subjects reused across windows"
        seen |= subjects


# --------------------------------------------------------------------------- #
# reactivity metrics on synthetic series
# --------------------------------------------------------------------------- #

def _rec(i, phase, onset, ms, stall=0, key=None):
    return drift.WindowRecord(
        index=i, phase=phase, onset=onset, n_queries=1, write_rows=0,
        avg_ms=ms, stall_bytes=stall, window_ms=ms, bytes_shipped=0,
        epoch=0, adapted=False, mix_key=key if key is not None else phase)


def test_reactivity_recovery_and_bytes():
    ws = [_rec(0, "a", False, 10.0), _rec(1, "a", False, 10.0),
          _rec(2, "a", False, 10.0),
          _rec(3, "b", True, 50.0, stall=100),
          _rec(4, "b", False, 30.0, stall=50),
          _rec(5, "b", False, 11.0, stall=25),
          _rec(6, "b", False, 99.0, stall=7)]
    (r,) = drift.reactivity(ws, margin=0.2)
    assert r.onset == 3 and r.baseline_ms == pytest.approx(10.0)
    assert r.recovered and r.time_to_recover == 2
    assert r.depth == pytest.approx(5.0)
    assert r.bytes_spent == 175


def test_reactivity_never_recovers():
    ws = [_rec(0, "a", False, 10.0),
          _rec(1, "b", True, 40.0, stall=5), _rec(2, "b", False, 35.0,
                                                  stall=5)]
    (r,) = drift.reactivity(ws, margin=0.2)
    assert not r.recovered and r.time_to_recover is None
    assert r.depth == pytest.approx(4.0) and r.bytes_spent == 10


def test_reactivity_anchors_to_same_mix_phase():
    ws = [_rec(0, "day0", False, 10.0, key="day"),
          _rec(1, "day0", False, 10.0, key="day"),
          _rec(2, "night0", True, 100.0, key="night"),
          _rec(3, "night0", False, 100.0, key="night"),
          _rec(4, "day1", True, 11.0, key="day"),
          _rec(5, "day1", False, 11.0, key="day"),
          _rec(6, "night1", True, 101.0, key="night")]
    night0, day1, night1 = drift.reactivity(ws, margin=0.2)
    assert night0.baseline_ms == pytest.approx(10.0) and not night0.recovered
    assert day1.baseline_ms == pytest.approx(10.0)
    assert day1.recovered and day1.time_to_recover == 0
    assert night1.baseline_ms == pytest.approx(100.0)
    assert night1.recovered and night1.time_to_recover == 0


def test_reactivity_equals_reference():
    ws = [_rec(i, p, o, ms, stall=s, key=k) for i, (p, o, ms, s, k) in
          enumerate([("a", False, 10.0, 0, "x"), ("a", False, 12.0, 0, "x"),
                     ("b", True, 31.0, 90, "y"), ("b", False, 11.5, 9, "y"),
                     ("c", True, 10.5, 3, "x"), ("c", False, 40.0, 1, "x")])]
    ref_ws = [ref_drift.WindowRecord(**dataclasses.asdict(w)) for w in ws]
    for margin in (0.0, 0.2, 1.0):
        got = drift.reactivity(ws, margin=margin, baseline_windows=1)
        want = ref_drift.reactivity(ref_ws, margin=margin,
                                    baseline_windows=1)
        assert [dataclasses.astuple(r) for r in got] \
            == [dataclasses.astuple(r) for r in want]


# --------------------------------------------------------------------------- #
# driver mechanics
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("executor", EXECUTORS)
def test_run_scenario_telemetry_and_writes(ds, executor):
    scn = drift.mixed_read_write(ds, read_windows=1, write_windows=2,
                                 cool_windows=1, writes_per_window=8,
                                 queries_per_window=4, seed=2)
    svc = _fresh_service(ds, executor)
    svc.bootstrap(scn.bootstrap_workload(ds))
    before = svc.store.n_triples
    rep = drift.run_scenario(svc, scn, ds, adapt=False, mode="frozen")
    assert rep.scenario == "mixed_read_write" and rep.mode == "frozen"
    assert [w.write_rows for w in rep.windows] == [0, 24, 24, 0]
    assert svc.write_log.n_inserted == 48
    assert svc.store.n_triples == before + 48
    assert [w.onset for w in rep.windows] == [False, True, False, True]
    assert all(w.window_ms >= w.avg_ms > 0 for w in rep.windows)
    assert len(rep.recoveries) == 2
    s = rep.summary()
    assert s["windows"] == 4 and s["onsets"] == 2
    assert s["bytes_spent"] == 0


@pytest.mark.parametrize("executor", EXECUTORS)
def test_run_scenario_charges_migration_stalls(ds, executor):
    scn = drift.hot_set_churn(ds, steps=2, windows_per_step=2,
                              queries_per_window=4, seed=1)
    svc = _fresh_service(ds, executor, migration_budget=20_000)
    svc.bootstrap(scn.bootstrap_workload(ds))
    _force_session(svc, seed=3)
    rep = drift.run_scenario(svc, scn, ds, adapt=False, mode="frozen")
    drained = sum(w.stall_bytes for w in rep.windows)
    assert drained > 0, "in-flight chunks never charged to a window"
    for w in rep.windows:
        assert w.window_ms >= w.avg_ms
        if w.stall_bytes:
            assert w.window_ms > w.avg_ms


# --------------------------------------------------------------------------- #
# run_scenario record for record against the reference's numpy run
# --------------------------------------------------------------------------- #

CASES = {
    # (factory, its kwargs, service kwargs, adapt, warmup_phases, forced)
    "flash_crowd/adaptive": ("flash_crowd", {}, {}, True, 0, False),
    "flash_crowd/frozen": ("flash_crowd", {}, {}, False, 1, False),
    "flash_crowd/budget": ("flash_crowd", {},
                           dict(migration_budget=20_000), True, 0, False),
    "hot_set_churn/adaptive": ("hot_set_churn", {}, {}, True, 0, False),
    "mixed_read_write/adaptive": (
        "mixed_read_write", dict(read_windows=1, write_windows=2,
                                 cool_windows=2, writes_per_window=8),
        dict(replica_budget=200_000), True, 0, False),
    "hot_set_churn/drain": ("hot_set_churn", dict(steps=2, windows_per_step=2,
                                                  queries_per_window=4),
                            dict(migration_budget=20_000), False, 0, True),
}


def _replay(side, ds, case, executor="numpy"):
    factory, fkw, skw, adapt, warmup, forced = CASES[case]
    scn = _factory(side, factory)(ds, seed=5, **fkw)
    svc = _fresh_service(ds, executor, side=side, **skw)
    svc.bootstrap(scn.bootstrap_workload(ds))
    if forced:
        _force_session(svc, seed=3, side=side)
    rep = side["drift"].run_scenario(svc, scn, ds, adapt=adapt, mode=case,
                                     warmup_phases=warmup)
    return rep, svc


@pytest.fixture(scope="module")
def reference_runs(ref_ds):
    return {case: _replay(REF, ref_ds, case) for case in CASES}


@pytest.mark.parametrize("executor", EXECUTORS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_run_scenario_equals_reference(ds, reference_runs, case, executor):
    want, ref_svc = reference_runs[case]
    got, svc = _replay(PORT, ds, case, executor)
    assert (got.scenario, got.mode) == (want.scenario, want.mode)
    assert [dataclasses.astuple(w) for w in got.windows] \
        == [dataclasses.astuple(w) for w in want.windows]
    assert [dataclasses.astuple(r) for r in got.recoveries] \
        == [dataclasses.astuple(r) for r in want.recoveries]
    assert got.summary() == want.summary()
    np.testing.assert_array_equal(svc.kg.state.feature_to_shard,
                                  ref_svc.kg.state.feature_to_shard)
    assert svc.store.n_triples == ref_svc.store.n_triples


def test_reference_cases_exercise_the_driver(reference_runs):
    """The cases above adapt, drain, write and replicate."""
    adapted = sum(w.adapted for rep, _ in reference_runs.values()
                  for w in rep.windows)
    stalled = sum(w.stall_bytes for rep, _ in reference_runs.values()
                  for w in rep.windows)
    written = sum(w.write_rows for rep, _ in reference_runs.values()
                  for w in rep.windows)
    assert adapted >= 3 and stalled > 0 and written > 0


# --------------------------------------------------------------------------- #
# THE parity property: streamed schedule == synchronous schedule
# --------------------------------------------------------------------------- #

def _sync_replay(svc, windows):
    out, epochs = [], set()
    for w in windows:
        if w.write_rows is not None:
            svc.write(WriteBatch(inserts=w.write_rows.copy()))
        for b, _ in svc.query_batch(w.queries):
            out.append(canon_bindings(b))
        epochs.add(svc.kg.epoch)
    return out, epochs


@pytest.fixture(scope="module")
def streamed_case(ds):
    scn = drift.mixed_read_write(ds, read_windows=1, write_windows=2,
                                 cool_windows=1, writes_per_window=8,
                                 queries_per_window=5, seed=5)
    windows = scn.schedule(ds)

    def build(executor):
        svc = _fresh_service(ds, executor, migration_budget=30_000)
        svc.bootstrap(scn.bootstrap_workload(ds))
        _force_session(svc, seed=7)
        return svc

    oracle, epochs = _sync_replay(build("numpy"), windows)
    assert len(epochs) > 1, "replay never crossed an epoch"
    return scn, windows, build, oracle


@pytest.mark.parametrize("executor", EXECUTORS)
def test_streamed_schedule_matches_synchronous(streamed_case, executor):
    """Same drift schedule, same starting state (budgeted migration with
    replica promotions in flight): the continuous-admission replay serves
    bindings byte-identical to the synchronous window loop on each
    executor, and both equal the numpy executor's synchronous run."""
    scn, windows, build, oracle = streamed_case
    sync, epochs = _sync_replay(build(executor), windows)
    assert len(epochs) > 1
    assert sync == oracle, executor
    svc = build(executor)
    stream, results = drift.stream_schedule(
        svc, windows, max_window=scn.queries_per_window)
    got = [canon_bindings(r.bindings) for r in results]
    assert got == oracle, executor
    assert svc.write_log.n_inserted == 48
