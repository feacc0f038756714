"""repro_torch.obs — unified tracing + metrics for the serving, adaptation,
and kernel stack.

* :class:`Tracer` / :class:`Span`: structured spans on the modeled
  virtual clock (per-query plan→scan→join→federate→ship, window,
  migration-chunk, replica-promotion, write-batch, adaptation-round),
  exported as Chrome trace-event JSON (Perfetto-loadable) or JSONL.
  Byte-identical across runs for a fixed seed/executor.
* :class:`MetricsRegistry`: central counters/gauges/histograms threaded
  through the facade, executors, stream, migrate, replicate, write, and
  kernel dispatch; snapshot folded into ``KGService.stats()``.
* ``NULL_TRACER`` / ``NULL_METRICS``: inert defaults — observability is
  off unless asked for, at the cost of one attribute check per site.
"""
from repro_torch.obs.metrics import (NULL_METRICS, Counter, Gauge, Histogram,
                               MetricsRegistry, NullRegistry, ambient,
                               set_ambient)
from repro_torch.obs.tracer import NULL_TRACER, NullTracer, Span, Tracer

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "NullRegistry",
    "NULL_METRICS", "ambient", "set_ambient",
    "Span", "Tracer", "NullTracer", "NULL_TRACER",
]
