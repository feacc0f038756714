"""Tail-latency telemetry for the streaming admission loop.

The paper scores adaptation by *window averages*; a serving system is
judged by per-query tails. :class:`LatencyRecorder` keeps one
:class:`QueryLatency` row per served query — admission, start and
completion on the stream's deterministic virtual clock, plus the window,
PPN shard and epoch it was served at — and aggregates them into
p50/p95/p99 summaries overall, per window and per shard. ``KGService``
surfaces the live stream's recorder through ``stats()``; benchmarks
export the per-window rows to ``results/`` CSVs.

All timestamps are seconds on the stream's modeled clock (the container
has no cluster fabric — see ``NetworkModel``), so every percentile here
is deterministic and comparable across runs, executors and machines.
"""
from __future__ import annotations

import csv
import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

PERCENTILES = (50.0, 95.0, 99.0)


@dataclasses.dataclass
class QueryLatency:
    """One served query on the stream's virtual clock."""

    seq: int                 # admission sequence number
    name: str                # query name
    window: int              # serving window the query executed in
    shard: int               # PPN shard the plan ran at
    arrival_s: float         # admission timestamp
    start_s: float           # window start (after interleaved mutations)
    finish_s: float          # completion timestamp
    epoch: int               # facade epoch the query was served at
    cached: bool             # served from the epoch-valid result cache

    @property
    def latency_s(self) -> float:
        return self.finish_s - self.arrival_s

    @property
    def queue_s(self) -> float:
        """Time spent queued before its window started."""
        return self.start_s - self.arrival_s


def percentile_summary(values: Sequence[float]) -> Dict[str, float]:
    """``{n, mean, p50, p95, p99, max}`` over a latency sample (seconds)."""
    arr = np.asarray(list(values), dtype=np.float64)
    if arr.size == 0:
        return dict(n=0, mean=0.0, p50=0.0, p95=0.0, p99=0.0, max=0.0)
    p50, p95, p99 = np.percentile(arr, PERCENTILES).tolist()
    return dict(n=int(arr.size), mean=float(arr.mean()), p50=float(p50),
                p95=float(p95), p99=float(p99), max=float(arr.max()))


class LatencyRecorder:
    """Accumulates :class:`QueryLatency` rows and aggregates their tails.

    Every aggregate carries a nested ``"queue"`` percentile block over the
    rows' ``queue_s`` (time spent admitted-but-unstarted) beside the
    end-to-end latency percentiles — queueing pathologies would otherwise
    hide inside the admission→completion p99."""

    def __init__(self) -> None:
        self.records: List[QueryLatency] = []

    def record(self, rec: QueryLatency) -> None:
        self.records.append(rec)

    def __len__(self) -> int:
        return len(self.records)

    # ------------------------------------------------------------------ #
    @staticmethod
    def empty_summary() -> Dict[str, object]:
        """The well-formed all-zero :meth:`summary` block — what
        ``KGService.stats()`` reports before any stream has recorded."""
        return LatencyRecorder._summarize([])

    @staticmethod
    def _summarize(recs: Sequence[QueryLatency]) -> Dict[str, object]:
        out: Dict[str, object] = percentile_summary(
            [r.latency_s for r in recs])
        out["queue"] = percentile_summary([r.queue_s for r in recs])
        return out

    def latencies(self) -> np.ndarray:
        return np.array([r.latency_s for r in self.records],
                        dtype=np.float64)

    def summary(self) -> Dict[str, object]:
        """Overall admission→completion percentile summary (seconds),
        with the queue-time percentiles under ``"queue"``."""
        return self._summarize(self.records)

    def _grouped(self, key) -> Dict[int, Dict[str, object]]:
        groups: Dict[int, List[QueryLatency]] = {}
        for r in self.records:
            groups.setdefault(key(r), []).append(r)
        return {k: self._summarize(v) for k, v in sorted(groups.items())}

    def per_window(self) -> Dict[int, Dict[str, float]]:
        """Percentile summary per serving window."""
        return self._grouped(lambda r: r.window)

    def per_shard(self) -> Dict[int, Dict[str, float]]:
        """Percentile summary per PPN shard — which shard serves the worst
        tails is exactly the signal a placement change should move."""
        return self._grouped(lambda r: r.shard)

    # ------------------------------------------------------------------ #
    def window_rows(self, **constants) -> List[Dict[str, object]]:
        """Per-window CSV rows (latencies in milliseconds), with any
        ``constants`` (e.g. ``mode=..., rate_qps=...``) prepended to every
        row — the shape ``benchmarks/bench_streaming.py`` writes to
        ``results/exp_streaming.csv``."""
        rows = []
        for window, s in self.per_window().items():
            row: Dict[str, object] = dict(constants)
            row.update(window=window, n=s["n"],
                       p50_ms=round(s["p50"] * 1e3, 3),
                       p95_ms=round(s["p95"] * 1e3, 3),
                       p99_ms=round(s["p99"] * 1e3, 3),
                       mean_ms=round(s["mean"] * 1e3, 3),
                       max_ms=round(s["max"] * 1e3, 3),
                       # queue-time tails ride after the latency columns
                       # (existing consumers index by the header prefix)
                       queue_p50_ms=round(s["queue"]["p50"] * 1e3, 3),
                       queue_p95_ms=round(s["queue"]["p95"] * 1e3, 3),
                       queue_p99_ms=round(s["queue"]["p99"] * 1e3, 3))
            rows.append(row)
        return rows

    def to_csv(self, path, **constants) -> int:
        """Write :meth:`window_rows` to ``path``; returns rows written."""
        rows = self.window_rows(**constants)
        if not rows:
            return 0
        with open(path, "w", newline="") as fh:
            writer = csv.DictWriter(fh, fieldnames=list(rows[0]))
            writer.writeheader()
            writer.writerows(rows)
        return len(rows)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        s = self.summary()
        return (f"LatencyRecorder(n={s['n']}, p50={s['p50'] * 1e3:.1f}ms, "
                f"p95={s['p95'] * 1e3:.1f}ms, p99={s['p99'] * 1e3:.1f}ms)")
