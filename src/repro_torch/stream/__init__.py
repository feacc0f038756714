"""repro_torch.stream — the continuous-admission serving loop.

The synchronous ``query_batch`` window becomes a stream. Queries
and write batches are admitted as they arrive (``StreamService.submit`` /
``submit_write`` / ``poll``), served in double-buffered windows through
the existing ``KGService.serve_window`` seam, with migration/replica
chunks and writes drained into the gaps between windows under the same
budgets — and every query's admission→completion latency lands in a
:class:`LatencyRecorder` (p50/p95/p99 per window and per shard), the
tail-latency currency adaptation quality is actually judged in.

Results are byte-identical to a synchronous ``query_batch`` over the same
admission order, at every epoch — the streaming loop changes *when* work
happens, never *what* it computes.

    stream = svc.stream(pipeline=True)           # or StreamService(svc)
    stream.submit(q1); stream.submit_write(batch); stream.submit(q2)
    stream.run_until_idle()                      # or pump() per window
    for r in stream.poll(): ...                  # StreamResult per query
    svc.stats()["latency"]                       # p50/p95/p99 aggregates

``repro_torch.stream.replay`` drives recorded/synthetic arrival processes for
benchmarks (open-loop and Poisson); see ``benchmarks/bench_streaming.py``
and docs/api.md § "Streaming admission".
"""
from repro_torch.stream.replay import (interleave, open_loop_arrivals,
                                 poisson_arrivals, replay)
from repro_torch.stream.service import StreamEvent, StreamResult, StreamService
from repro_torch.stream.telemetry import (LatencyRecorder, QueryLatency,
                                    percentile_summary)

__all__ = ["StreamService", "StreamEvent", "StreamResult",
           "LatencyRecorder", "QueryLatency", "percentile_summary",
           "open_loop_arrivals", "poisson_arrivals", "interleave",
           "replay"]
