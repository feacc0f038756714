"""Drift scenarios — seeded workload *dynamics* over a serving session.

A static benchmark asks "how fast is this layout for that workload"; a
drift scenario asks the production question: *when the workload changes
under you, how deep do you degrade and how fast do you come back*. This
module describes the change itself:

* a :class:`Phase` is a stretch of serving windows drawn from one weighted
  query mix (optionally with a write stream riding along);
* a :class:`DriftScenario` is a named phase sequence plus a seed;
* :meth:`DriftScenario.schedule` expands it into a fully *pre-computed*,
  deterministic list of :class:`Window` s — the admission stream. Same
  seed, same dataset ⇒ byte-identical schedule, so the synchronous loop,
  the streaming loop, and every (strategy × adaptive/frozen) arm replay
  exactly the same drift.

Factories cover the canonical dynamics from the TAPER/xDGP evaluations:
:func:`diurnal` (focus oscillates between query families),
:func:`flash_crowd` (sudden concentration on one hot feature),
:func:`hot_set_churn` (the hot query set slowly rotates), and
:func:`mixed_read_write` (a write burst mid-serving). They group queries
by the dataset's ``topics`` attribute (``graph.watdiv``) when present and
fall back to ``Query.shape`` families otherwise, so they run on any
``Dataset`` duck-typed source (``graph.lubm`` included).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.query.pattern import Query

__all__ = ["Phase", "Window", "DriftScenario", "diurnal", "flash_crowd",
           "hot_set_churn", "mixed_read_write", "hot_feature_writer"]

# a writer maps (rng, n_rows, alloc) -> (n, 3) int32 insert rows, where
# ``alloc(k)`` mints k fresh entity ids (disjoint from the live graph)
Writer = Callable[[np.random.Generator, int, Callable[[int], np.ndarray]],
                  np.ndarray]


@dataclasses.dataclass(frozen=True)
class Phase:
    """One homogeneous stretch of the scenario: ``windows`` serving windows
    sampled from the weighted query ``mix``, each optionally preceded by
    ``writes_per_window`` freshly generated insert rows."""

    name: str
    windows: int
    mix: Tuple[Tuple[str, float], ...]     # (query name, sampling weight)
    writes_per_window: int = 0


@dataclasses.dataclass
class Window:
    """One admission window of the expanded schedule. ``onset`` marks the
    first window of a new phase — the drift instants the reactivity
    metrics anchor on."""

    index: int
    phase: str
    onset: bool
    queries: List[Query]
    write_rows: Optional[np.ndarray] = None    # (n, 3) int32 inserts
    # canonical identity of the phase's mix: recurring phases (day0/day1)
    # share it, so recovery baselines can compare like with like
    mix_key: str = ""


@dataclasses.dataclass
class DriftScenario:
    name: str
    phases: Tuple[Phase, ...]
    queries_per_window: int = 12
    seed: int = 0
    writer: Optional[Writer] = None

    def bootstrap_workload(self, ds) -> List[Query]:
        """The pre-drift workload: the distinct queries of phase 0's mix —
        what a service would reasonably have been partitioned for before
        the scenario's dynamics hit it."""
        names = [n for n, w in self.phases[0].mix if w > 0]
        return ds.workload(sorted(set(names)))

    def schedule(self, ds) -> List[Window]:
        """Expand into the deterministic admission stream. Every sampling
        decision (query draws, write rows, fresh entity ids) comes from one
        generator seeded with ``self.seed``, computed up front against the
        *initial* store — so identical replays see identical events."""
        rng = np.random.default_rng(self.seed)
        next_free = int(ds.store.triples.max()) + 1

        def alloc(k: int) -> np.ndarray:
            nonlocal next_free
            ids = np.arange(next_free, next_free + k, dtype=np.int64)
            next_free += k
            assert next_free < np.iinfo(np.int32).max
            return ids

        windows: List[Window] = []
        for pi, phase in enumerate(self.phases):
            names = [n for n, _ in phase.mix]
            w = np.array([max(float(x), 0.0) for _, x in phase.mix])
            assert w.sum() > 0, f"phase {phase.name}: empty mix"
            p = w / w.sum()
            for wi in range(phase.windows):
                picked = rng.choice(len(names), size=self.queries_per_window,
                                    p=p)
                queries = [ds.queries[names[int(i)]] for i in picked]
                rows = None
                if phase.writes_per_window > 0:
                    assert self.writer is not None, \
                        f"phase {phase.name} writes but scenario has no writer"
                    rows = np.asarray(
                        self.writer(rng, phase.writes_per_window, alloc),
                        dtype=np.int32).reshape(-1, 3)
                windows.append(Window(
                    index=len(windows), phase=phase.name,
                    onset=(pi > 0 and wi == 0), queries=queries,
                    write_rows=rows,
                    mix_key=",".join(f"{n}:{x:g}" for n, x in phase.mix)))
        return windows


# --------------------------------------------------------------------------- #
# query-family grouping (dataset-agnostic)
# --------------------------------------------------------------------------- #

def _families(ds) -> Dict[str, List[str]]:
    """Focus families to drift between: the dataset's ``topics`` when it
    has them (``graph.watdiv``), else groups by ``Query.shape``."""
    topics = getattr(ds, "topics", None)
    if topics:
        return {k: list(v) for k, v in topics.items()}
    groups: Dict[str, List[str]] = {}
    for name, q in sorted(ds.queries.items()):
        groups.setdefault(q.shape or "other", []).append(name)
    return groups


def _mix(names: Sequence[str], weight: float = 1.0,
         ) -> Tuple[Tuple[str, float], ...]:
    return tuple((n, weight) for n in names)


def _two_families(ds) -> Tuple[List[str], List[str]]:
    fams = _families(ds)
    if "retail" in fams and "social" in fams:
        return fams["retail"], fams["social"]
    ordered = sorted(fams.items(), key=lambda kv: (-len(kv[1]), kv[0]))
    assert len(ordered) >= 2, "dataset has a single query family"
    return ordered[0][1], ordered[1][1]


# --------------------------------------------------------------------------- #
# scenario factories
# --------------------------------------------------------------------------- #

def diurnal(ds, *, cycles: int = 2, day_windows: int = 4,
            night_windows: int = 4, queries_per_window: int = 12,
            seed: int = 0,
            families: Optional[Tuple[str, str]] = None) -> DriftScenario:
    """Diurnal focus shift: traffic oscillates between two query families
    (WatDiv: the ``retail`` mix by day, the ``review`` mix by night). The
    service is bootstrapped for day; every nightfall is a drift onset."""
    fams = _families(ds)
    if families is not None:
        day, night = list(fams[families[0]]), list(fams[families[1]])
    elif "retail" in fams and "review" in fams:
        day, night = list(fams["retail"]), list(fams["review"])
    else:
        day, night = _two_families(ds)
    phases: List[Phase] = []
    for c in range(cycles):
        phases.append(Phase(f"day{c}", day_windows, _mix(day)))
        phases.append(Phase(f"night{c}", night_windows, _mix(night)))
    return DriftScenario(name="diurnal", phases=tuple(phases),
                         queries_per_window=queries_per_window, seed=seed)


def flash_crowd(ds, *, warm: int = 4, spike: int = 5, cool: int = 3,
                queries_per_window: int = 12, seed: int = 0,
                spike_on: Optional[Sequence[str]] = None) -> DriftScenario:
    """Flash crowd: a warm steady-state mix, then a sudden phase where ~90%
    of admitted queries concentrate on one previously-cold feature (WatDiv
    default: the ``social`` stars around ``likes product0``), then back."""
    day, night = _two_families(ds)
    crowd = list(spike_on) if spike_on else \
        [n for n in night if ds.queries[n].shape == "star"] or night[:1]
    warm_mix = _mix(day)
    spike_mix = tuple([(n, 9.0 * len(day) / len(crowd)) for n in crowd]
                      + list(_mix(day)))
    return DriftScenario(
        name="flash_crowd",
        phases=(Phase("warm", warm, warm_mix),
                Phase("spike", spike, spike_mix),
                Phase("cool", cool, warm_mix)),
        queries_per_window=queries_per_window, seed=seed)


def hot_set_churn(ds, *, steps: int = 4, windows_per_step: int = 3,
                  hot_size: int = 4, queries_per_window: int = 12,
                  seed: int = 0) -> DriftScenario:
    """Slow hot-set churn: the hot query subset rotates a little every few
    windows (weight 8:1 hot:cold) — drift as erosion, not as a cliff."""
    names = sorted(ds.queries)
    assert hot_size < len(names)
    phases = []
    for s in range(steps):
        start = (s * max(hot_size // 2, 1)) % len(names)
        hot = [names[(start + i) % len(names)] for i in range(hot_size)]
        mix = tuple((n, 8.0 if n in hot else 1.0) for n in names)
        phases.append(Phase(f"churn{s}", windows_per_step, mix))
    return DriftScenario(name="hot_set_churn", phases=tuple(phases),
                         queries_per_window=queries_per_window, seed=seed)


def mixed_read_write(ds, *, read_windows: int = 3, write_windows: int = 4,
                     cool_windows: int = 3, writes_per_window: int = 96,
                     queries_per_window: int = 12, seed: int = 0,
                     writer: Optional[Writer] = None) -> DriftScenario:
    """Mixed read/write phases: steady reads, then a write burst growing a
    hot feature under the same reads, then reads again. Writes ride the
    admission stream as ``repro_torch.write`` batches (routed, fanned out, heat
    noted) — the data-drift half of the reactivity story."""
    day, night = _two_families(ds)
    mix = _mix(day + night)
    return DriftScenario(
        name="mixed_read_write",
        phases=(Phase("read0", read_windows, mix),
                Phase("burst", write_windows, mix,
                      writes_per_window=writes_per_window),
                Phase("read1", cool_windows, mix)),
        queries_per_window=queries_per_window, seed=seed,
        writer=writer or hot_feature_writer(ds))


def hot_feature_writer(ds) -> Writer:
    """Insert-row generator growing one workload-tracked hot feature:
    fresh users liking ``product0`` (WatDiv), fresh students taking
    ``GraduateCourse0`` (LUBM), else fresh subjects over sampled existing
    rows (any store)."""
    d = ds.dictionary
    named = getattr(ds, "named", None)
    if named is not None and hasattr(named, "product0"):
        t, cls = d.lookup("rdf:type"), d.lookup("wsdbm:User")
        likes = d.lookup("wsdbm:likes")
        nat, c0 = d.lookup("sorg:nationality"), named.country0
        hot = named.product0

        def rows(rng, n, alloc):
            s = alloc(n)
            return np.concatenate([
                np.stack([s, np.full(n, t), np.full(n, cls)], axis=1),
                np.stack([s, np.full(n, likes), np.full(n, hot)], axis=1),
                np.stack([s, np.full(n, nat), np.full(n, c0)], axis=1),
            ]).astype(np.int32)
        return rows
    if named is not None and hasattr(named, "grad_course0"):
        t, cls = d.lookup("rdf:type"), d.lookup("ub:GraduateStudent")
        take = d.lookup("ub:takesCourse")
        hot = named.grad_course0

        def rows(rng, n, alloc):
            s = alloc(n)
            return np.concatenate([
                np.stack([s, np.full(n, t), np.full(n, cls)], axis=1),
                np.stack([s, np.full(n, take), np.full(n, hot)], axis=1),
            ]).astype(np.int32)
        return rows

    base = ds.store.triples

    def rows(rng, n, alloc):
        picked = base[rng.integers(0, len(base), n)].astype(np.int64)
        picked[:, 0] = alloc(n)
        return picked.astype(np.int32)
    return rows
