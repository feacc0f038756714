"""Clocked replay drivers — feed a :class:`StreamService` a recorded or
synthetic arrival process.

Benchmarks don't have live clients, so they *replay*: an event list of
``(arrival_s, Query | WriteBatch)`` pairs is admitted in order onto the
stream's virtual clock and pumped to completion. Arrival processes:

* :func:`open_loop_arrivals` — the open-loop (uniform-spacing) process
  ``bench_streaming.py`` sweeps: clients fire at ``rate_qps`` regardless
  of completions, so queueing delay shows up in the tail the moment the
  system saturates (a closed loop would hide it).
* :func:`poisson_arrivals` — exponential gaps at the same mean rate, for
  burstier tails (seeded — everything stays deterministic).

``replay()`` is the loop: submit every event at its timestamp, run until
idle, return the stream's :class:`LatencyRecorder`.
"""
from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

import numpy as np

from repro_torch import write as kgwrite
from repro_torch.query.pattern import Query

from repro_torch.stream.service import StreamService
from repro_torch.stream.telemetry import LatencyRecorder

__all__ = ["open_loop_arrivals", "poisson_arrivals", "interleave",
           "replay"]


def open_loop_arrivals(n: int, rate_qps: float,
                       start: float = 0.0) -> np.ndarray:
    """``n`` uniform open-loop arrival timestamps at ``rate_qps``."""
    assert rate_qps > 0, rate_qps
    return start + np.arange(n, dtype=np.float64) / float(rate_qps)


def poisson_arrivals(n: int, rate_qps: float, rng,
                     start: float = 0.0) -> np.ndarray:
    """``n`` Poisson-process arrivals (exponential gaps, mean rate
    ``rate_qps``), from a seeded ``numpy`` Generator."""
    assert rate_qps > 0, rate_qps
    gaps = rng.exponential(1.0 / float(rate_qps), size=n)
    return start + np.cumsum(gaps)


def interleave(queries: Sequence[Query], arrivals: np.ndarray,
               writes: Sequence[Tuple[int, kgwrite.WriteBatch]] = (),
               ) -> List[Tuple[float, object]]:
    """Build a replay event list: ``queries[i]`` at ``arrivals[i]``, with
    each write batch admitted *before* the query at its position (a
    ``(position, batch)`` pair; position == len(queries) appends at the
    end). Returns ``(arrival_s, payload)`` pairs in admission order."""
    assert len(queries) == len(arrivals)
    by_pos: dict = {}
    for pos, batch in writes:
        by_pos.setdefault(int(pos), []).append(batch)
    events: List[Tuple[float, object]] = []
    for i, (q, t) in enumerate(zip(queries, arrivals.tolist())):
        for batch in by_pos.get(i, ()):
            events.append((t, batch))
        events.append((t, q))
    tail = float(arrivals[-1]) if len(arrivals) else 0.0
    for batch in by_pos.get(len(queries), ()):
        events.append((tail, batch))
    return events


def replay(stream: StreamService,
           events: Iterable[Tuple[float, object]]) -> LatencyRecorder:
    """Admit every ``(arrival_s, Query | WriteBatch)`` event in order and
    pump the stream until idle. Returns the stream's recorder."""
    for at, payload in events:
        if isinstance(payload, kgwrite.WriteBatch):
            stream.submit_write(payload, at=at)
        else:
            stream.submit(payload, at=at)
    return stream.run_until_idle()
