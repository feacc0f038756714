"""Scenario driver — replay a drift schedule and measure *reactivity*.

`repro_torch.scenario.schedule` describes how a workload changes;
:func:`run_scenario` replays that change over a live :class:`KGService`
session and answers the production questions AWAPart's static benchmarks
cannot: when the mix shifts, **how deep** does the modeled window latency
degrade (:attr:`Recovery.depth`), **how many windows** until it is back
within ``margin`` of the pre-drift level (:attr:`Recovery.time_to_recover`),
and **how many migration+replica bytes** that recovery cost
(:attr:`Recovery.bytes_spent`). The same schedule replays over adaptive
(``maybe_adapt`` per window) and frozen (never adapt) services, so the
telemetry isolates what the Fig.-5 loop buys.

Accounting mirrors ``benchmarks/bench_writes.py``: per-window serving cost
is the mean modeled query time, and migration traffic applied during the
window stalls it at the network model's bandwidth, amortized over the
window's queries — degradation *and* the price of reacting to it land in
the same ``window_ms`` series the recovery metrics read.

:func:`stream_schedule` routes the identical schedule through
``svc.stream()`` (the ``repro_torch.stream`` continuous-admission loop), which
the parity tests pin byte-identical to the synchronous replay.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.query import exec as qexec
from repro_torch import write as kgwrite
from repro_torch.scenario.schedule import DriftScenario, Window

__all__ = ["WindowRecord", "Recovery", "ReactivityReport", "reactivity",
           "run_scenario", "stream_schedule"]


@dataclasses.dataclass
class WindowRecord:
    """Telemetry for one served window of a scenario replay."""

    index: int
    phase: str
    onset: bool            # first window of a new phase (drift instant)
    n_queries: int
    write_rows: int        # insert rows applied ahead of the window
    avg_ms: float          # mean modeled query time, serving only
    stall_bytes: int       # migration+replica traffic applied this window
    window_ms: float       # avg_ms + amortized migration stall
    bytes_shipped: int     # intermediate-result shipping during serving
    epoch: int             # layout epoch after the window
    adapted: bool          # an adaptation round was accepted this window
    mix_key: str = ""      # mix identity (recurring phases share it)


@dataclasses.dataclass
class Recovery:
    """Reactivity metrics for one drift onset."""

    phase: str             # the phase whose arrival caused the drift
    onset: int             # window index of the onset
    baseline_ms: float     # mean window_ms of the pre-onset windows
    peak_ms: float         # worst window_ms from onset to recovery (or span end)
    depth: float           # peak_ms / baseline_ms — degradation depth
    recovered: bool        # came back within (1+margin)*baseline in-span
    time_to_recover: Optional[int]   # windows from onset until recovered
    bytes_spent: int       # migration+replica bytes from onset through recovery


@dataclasses.dataclass
class ReactivityReport:
    scenario: str
    mode: str                        # e.g. "awapart/adaptive", "hash/frozen"
    windows: List[WindowRecord]
    recoveries: List[Recovery]

    def summary(self) -> Dict[str, float]:
        rec = self.recoveries
        return {
            "windows": len(self.windows),
            "onsets": len(rec),
            "recovered": sum(r.recovered for r in rec),
            "worst_depth": max((r.depth for r in rec), default=1.0),
            "max_ttr": max((r.time_to_recover for r in rec
                            if r.time_to_recover is not None), default=0),
            "bytes_spent": sum(r.bytes_spent for r in rec),
        }


def reactivity(windows: Sequence[WindowRecord], *, margin: float = 0.2,
               baseline_windows: int = 3) -> List[Recovery]:
    """Reduce a window series to per-onset recovery metrics.

    For each onset, the baseline is the pre-drift level the arriving mix is
    expected to return to: the tail (last ``baseline_windows`` windows) of
    the most recent *earlier* phase serving the same mix when one exists —
    a recurring phase is judged against its own past, never against a mix
    with a different compute floor — else the tail of the windows
    immediately before the onset. The recovery point is the first window in
    the onset's span (up to the next onset) whose ``window_ms`` is back
    within ``(1 + margin) * baseline``. ``depth`` is the worst degradation
    seen before that point. ``bytes_spent`` sums the migration stalls from
    the onset through the recovery window — the traffic the layout paid to
    get back (the whole span when it never does)."""
    onsets = [w.index for w in windows if w.onset]
    spans = list(zip([0] + onsets, onsets + [len(windows)]))
    out: List[Recovery] = []
    for start, end in spans:
        if start not in onsets:
            continue
        key = windows[start].mix_key
        same = [(s, e) for s, e in spans if e <= start
                and key and windows[s].mix_key == key]
        if same:
            s, e = same[-1]
            pre = windows[max(s, e - baseline_windows):e]
        else:
            pre = windows[max(0, start - baseline_windows):start]
        assert pre, f"onset at window {start} has no pre-drift baseline"
        baseline = float(np.mean([w.window_ms for w in pre]))
        span = windows[start:end]
        limit = (1.0 + margin) * baseline
        at = next((i for i, w in enumerate(span) if w.window_ms <= limit),
                  None)
        upto = span if at is None else span[:at + 1]
        peak = max(w.window_ms for w in upto)
        out.append(Recovery(
            phase=span[0].phase, onset=start, baseline_ms=baseline,
            peak_ms=peak, depth=peak / baseline if baseline > 0 else 1.0,
            recovered=at is not None, time_to_recover=at,
            bytes_spent=sum(w.stall_bytes for w in upto)))
    return out


def _session_bytes(svc) -> Tuple[object, int]:
    sess = svc.session
    return sess, (sess.bytes_applied if sess is not None else 0)


def run_scenario(svc, scenario: DriftScenario, ds, *, adapt: bool,
                 mode: str = "", margin: float = 0.2,
                 baseline_windows: int = 3,
                 warmup_phases: int = 0) -> ReactivityReport:
    """Replay ``scenario`` over a bootstrapped service, synchronously:
    writes, then ``query_batch`` (which applies one migration chunk), then
    — in adaptive mode — ``maybe_adapt`` on the window's queries. Frozen
    mode serves the identical schedule without ever adapting; bindings are
    layout-invariant, so the two arms differ only in cost telemetry.

    ``warmup_phases`` lets a frozen arm adapt during the first N phases
    before freezing: both arms then face the first drift onset from the
    same well-tuned pre-drift layout, so the recovery metrics isolate
    *reactivity* rather than initial placement quality. (It is a no-op
    for non-adaptive strategies — ``maybe_adapt`` never fires without an
    adaptive controller.)"""
    assert svc.kg is not None, "bootstrap(scenario.bootstrap_workload(ds)) first"
    windows = scenario.schedule(ds)
    phase_index = {p.name: i for i, p in enumerate(scenario.phases)}
    net = svc.net or qexec.NetworkModel()
    records: List[WindowRecord] = []
    for w in windows:
        stall = 0
        if w.write_rows is not None:
            svc.write(kgwrite.WriteBatch(inserts=w.write_rows.copy()))
        # migration chunk applied by query_batch ahead of serving
        prev, b0 = _session_bytes(svc)
        results = svc.query_batch(w.queries)
        if prev is not None:
            stall += prev.bytes_applied - b0
        adapted = False
        if adapt or phase_index[w.phase] < warmup_phases:
            # an adaptation round first finishes any in-flight drain, then
            # (budget=None) commits the accepted plan atomically — both are
            # traffic this window pays for
            prev, b0 = _session_bytes(svc)
            report = svc.maybe_adapt(w.queries)
            if prev is not None:
                stall += prev.bytes_applied - b0
            if report is not None and report.accepted:
                adapted = True
                cur = svc.session
                stall += (report.plan.bytes if cur is None
                          else cur.bytes_applied)
        times = [stats.modeled_time(net) for _, stats in results]
        avg_ms = float(np.mean(times)) * 1e3
        stall_ms = stall / net.bandwidth_Bps / len(results) * 1e3
        records.append(WindowRecord(
            index=w.index, phase=w.phase, onset=w.onset,
            n_queries=len(w.queries),
            write_rows=0 if w.write_rows is None else len(w.write_rows),
            avg_ms=avg_ms, stall_bytes=int(stall),
            window_ms=avg_ms + stall_ms,
            bytes_shipped=int(sum(s.bytes_shipped for _, s in results)),
            epoch=svc.kg.epoch, adapted=adapted, mix_key=w.mix_key))
    return ReactivityReport(
        scenario=scenario.name, mode=mode, windows=records,
        recoveries=reactivity(records, margin=margin,
                              baseline_windows=baseline_windows))


def stream_schedule(svc, windows: Sequence[Window], *, gap_s: float = 1.0,
                    **stream_kwargs):
    """Admit a pre-computed schedule through the continuous-admission loop
    (``svc.stream()``): window *k*'s writes then queries arrive at
    ``k * gap_s``, preserving the synchronous replay's admission order.
    Returns ``(stream, results)`` with results in admission order — pinned
    byte-identical to the synchronous ``query_batch`` replay by
    ``tests/test_scenario.py``."""
    stream = svc.stream(**stream_kwargs)
    for k, w in enumerate(windows):
        at = k * gap_s
        if w.write_rows is not None:
            stream.submit_write(kgwrite.WriteBatch(inserts=w.write_rows.copy()),
                                at=at)
        for q in w.queries:
            stream.submit(q, at=at)
    stream.run_until_idle()
    return stream, stream.poll()
