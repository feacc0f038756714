"""Central metrics registry: counters, gauges, histograms.

One registry per :class:`~repro_torch.api.service.KGService`, threaded through
the facade, executors, ``repro_torch.stream``, ``repro_torch.migrate``,
``repro_torch.replicate``, ``repro_torch.write``, and ``kernels.dispatch`` — so the
signals the adaptation loop runs on (cross-shard joins, bytes shipped
vs. replica-served, cache hit rates, kernel tier picks, queue-vs-execute
split) are all visible in one ``svc.stats()["metrics"]`` snapshot.

Instruments are created on first use (``registry.counter(name).inc()``)
and named with dotted paths (``federation.bytes_shipped``,
``kernels.dispatch.join.pipeline.oracle``). Snapshots sort names so the
output is deterministic; ``to_csv`` emits a standalone file that
``results/make_table.py`` renders as a ``metrics_table``.

``kernels.dispatch`` has no service handle, so the module also keeps an
*ambient* registry hook: the most recently constructed service installs
its registry via :func:`set_ambient`, and dispatch-tier counters land
there. ``NULL_METRICS`` is the inert default for facades built outside
a service.
"""
from __future__ import annotations

import csv
from typing import Any, Dict, List, Optional

import numpy as np

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "NullRegistry", "NULL_METRICS", "set_ambient", "ambient"]


class Counter:
    """Monotone count (events, rows, bytes)."""

    __slots__ = ("value",)
    kind = "counter"

    def __init__(self):
        self.value = 0

    def inc(self, v: int = 1) -> None:
        self.value += v


class Gauge:
    """Last-written (or max-tracked) level: headroom, epoch, depth."""

    __slots__ = ("value",)
    kind = "gauge"

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def track_max(self, v: float) -> float:
        if v > self.value:
            self.value = float(v)
        return self.value


class Histogram:
    """Raw-sample histogram; summarized (p50/p95/p99) at snapshot time.
    Sample counts here are per-run and small (one per query/window), so
    keeping raw values stays cheap and exact."""

    __slots__ = ("values",)
    kind = "histogram"

    def __init__(self):
        self.values: List[float] = []

    def observe(self, v: float) -> None:
        self.values.append(float(v))

    def summary(self) -> Dict[str, float]:
        vals = self.values
        if not vals:
            return dict(n=0, mean=0.0, p50=0.0, p95=0.0, p99=0.0, max=0.0)
        arr = np.asarray(vals, dtype=np.float64)
        p50, p95, p99 = np.percentile(arr, (50.0, 95.0, 99.0))
        return dict(n=len(vals), mean=float(arr.mean()), p50=float(p50),
                    p95=float(p95), p99=float(p99), max=float(arr.max()))


class MetricsRegistry:
    """Name → instrument map with on-demand creation. A name is bound to
    one instrument kind for its lifetime (asking for a counter where a
    gauge lives is a bug, surfaced loudly)."""

    def __init__(self):
        self._instruments: Dict[str, Any] = {}

    def __len__(self) -> int:
        return len(self._instruments)

    def _get(self, name: str, cls):
        inst = self._instruments.get(name)
        if inst is None:
            inst = self._instruments[name] = cls()
        elif type(inst) is not cls:
            raise TypeError(f"metric {name!r} is a {inst.kind}, "
                            f"not a {cls.kind}")
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def snapshot(self) -> Dict[str, Any]:
        """Deterministic nested dict: ``counters`` / ``gauges`` map name
        to value, ``histograms`` map name to a percentile summary."""
        out: Dict[str, Any] = {"counters": {}, "gauges": {},
                               "histograms": {}}
        for name in sorted(self._instruments):
            inst = self._instruments[name]
            if isinstance(inst, Counter):
                out["counters"][name] = inst.value
            elif isinstance(inst, Gauge):
                out["gauges"][name] = inst.value
            else:
                out["histograms"][name] = inst.summary()
        return out

    def to_csv(self, path: str) -> int:
        """Standalone snapshot CSV (``metric,kind,value,mean,p50,p95,
        p99,max``) for ``results/make_table.py``. Returns rows written."""
        cols = ["metric", "kind", "value", "mean", "p50", "p95", "p99",
                "max"]
        rows = []
        for name in sorted(self._instruments):
            inst = self._instruments[name]
            row = dict(metric=name, kind=inst.kind)
            if isinstance(inst, Histogram):
                s = inst.summary()
                row.update(value=s["n"], mean=s["mean"], p50=s["p50"],
                           p95=s["p95"], p99=s["p99"], max=s["max"])
            else:
                row["value"] = inst.value
            rows.append(row)
        with open(path, "w", newline="") as fh:
            w = csv.DictWriter(fh, fieldnames=cols, restval="")
            w.writeheader()
            w.writerows(rows)
        return len(rows)


class _NullInstrument:
    """Shared inert counter/gauge/histogram."""

    __slots__ = ()
    value = 0
    kind = "null"

    def inc(self, v: int = 1) -> None:
        return None

    def set(self, v: float) -> None:
        return None

    def track_max(self, v: float) -> float:
        return 0.0

    def observe(self, v: float) -> None:
        return None

    def summary(self) -> Dict[str, float]:
        return dict(n=0, mean=0.0, p50=0.0, p95=0.0, p99=0.0, max=0.0)


class NullRegistry:
    """Inert registry: the default for facades constructed outside a
    service, so instrumentation sites never need a None-check."""

    _INST = _NullInstrument()

    def __len__(self) -> int:
        return 0

    def counter(self, name: str) -> _NullInstrument:
        return self._INST

    def gauge(self, name: str) -> _NullInstrument:
        return self._INST

    def histogram(self, name: str) -> _NullInstrument:
        return self._INST

    def snapshot(self) -> Dict[str, Any]:
        return {"counters": {}, "gauges": {}, "histograms": {}}

    def to_csv(self, path: str) -> int:
        with open(path, "w", newline="") as fh:
            fh.write("metric,kind,value,mean,p50,p95,p99,max\n")
        return 0


NULL_METRICS = NullRegistry()

# Ambient registry for call sites with no service handle (kernel
# dispatch). The latest-constructed KGService owns it; None before any
# service exists.
_AMBIENT: Optional[MetricsRegistry] = None


def set_ambient(registry: Optional[MetricsRegistry]) -> None:
    global _AMBIENT
    _AMBIENT = registry


def ambient() -> Optional[MetricsRegistry]:
    return _AMBIENT
