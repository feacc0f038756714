"""Structured span tracer on the modeled (virtual) clock.

Every timestamp comes from the deterministic cost model — the
``NetworkModel`` arithmetic that prices scans, joins, federation
round-trips, shipped bytes, migration chunks, and write fan-out — never
from the wall clock. Two runs with the same seed and executor therefore
produce *byte-identical* trace files, which makes traces first-class,
testable artifacts rather than best-effort diagnostics.

Layout: the tracer keeps a virtual-clock cursor ``now``. A span opens at
the cursor, and closing it moves the cursor to ``max(now, ts + dur)`` —
so sibling spans lay out sequentially and a parent's extent covers its
children (a parent opened with ``dur=0`` ends exactly where its last
child ended). ``advance_to`` lets the stream loop sync the cursor to its
own admission clock between windows.

Export targets:

* Chrome trace-event JSON (``{"traceEvents": [...]}``, "X" complete
  events) — loads directly in Perfetto / ``chrome://tracing``.
* JSONL — one event per line, for grep/jq pipelines.

The no-op path: ``NULL_TRACER`` shares one inert span, ``enabled`` is
False, and every method returns immediately — hot call sites guard span
construction with ``if tracer.enabled`` so tracing off-by-default costs
a single attribute check per site.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["Span", "Tracer", "NullTracer", "NULL_TRACER"]


def _clean(value):
    """JSON-safe span attribute: numpy scalars to native, containers
    element-wise, everything else passed through for json to reject."""
    if isinstance(value, (bool, int, float, str)) or value is None:
        return value
    if isinstance(value, (list, tuple)):
        return [_clean(v) for v in value]
    if isinstance(value, dict):
        return {str(k): _clean(v) for k, v in value.items()}
    if hasattr(value, "item"):  # numpy scalar
        return value.item()
    return str(value)


class Span:
    """One timed region on the modeled clock. Context manager; closing
    records the event and advances the tracer's cursor past it."""

    __slots__ = ("tracer", "name", "cat", "ts", "dur", "attrs", "seq",
                 "depth")

    def __init__(self, tracer, name, cat, ts, dur, attrs, seq, depth):
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.ts = ts
        self.dur = dur
        self.attrs = attrs
        self.seq = seq
        self.depth = depth

    def annotate(self, **attrs) -> "Span":
        """Attach attributes discovered after the span opened (accept
        decisions, realized counts)."""
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.tracer._close(self)


class Tracer:
    """Span recorder on a virtual clock, starting at ``clock0`` seconds."""

    enabled = True

    def __init__(self, clock0: float = 0.0):
        self.events: List[Dict[str, Any]] = []
        self.now = float(clock0)
        self._stack: List[Span] = []
        self._seq = 0

    def __len__(self) -> int:
        return len(self.events)

    # -- recording -----------------------------------------------------
    def span(self, name: str, cat: str = "serve", dur: float = 0.0,
             **attrs) -> Span:
        """Open a span at the cursor. ``dur`` is the modeled duration in
        seconds; children opened before the span closes extend it."""
        sp = Span(self, name, cat, self.now, float(dur),
                  {k: _clean(v) for k, v in attrs.items()},
                  self._seq, len(self._stack))
        self._seq += 1
        self._stack.append(sp)
        return sp

    def instant(self, name: str, cat: str = "mark", **attrs) -> None:
        """Zero-duration event at the cursor (drift triggers, rejects)."""
        with self.span(name, cat=cat, dur=0.0, **attrs):
            pass

    def _close(self, sp: Span) -> None:
        end = max(self.now, sp.ts + sp.dur)
        self.events.append(dict(seq=sp.seq, name=sp.name, cat=sp.cat,
                                ts=sp.ts, dur=end - sp.ts, depth=sp.depth,
                                args=sp.attrs))
        self.now = end
        if self._stack and self._stack[-1] is sp:
            self._stack.pop()

    # -- clock ---------------------------------------------------------
    def advance_to(self, t: float) -> None:
        """Monotone sync: move the cursor forward to the caller's clock
        (never backward — earlier spans already occupy that range)."""
        if t > self.now:
            self.now = float(t)

    # -- introspection (tests, smoke checks) ---------------------------
    def structure(self) -> List[Tuple[int, str]]:
        """(depth, name) pairs in span *open* order — the executor- and
        timing-independent shape of the trace."""
        return [(e["depth"], e["name"])
                for e in sorted(self.events, key=lambda e: e["seq"])]

    def span_counts(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        for e in self.events:
            counts[e["name"]] = counts.get(e["name"], 0) + 1
        return counts

    def find(self, name: str) -> List[Dict[str, Any]]:
        return [e for e in self.events if e["name"] == name]

    # -- export --------------------------------------------------------
    def chrome_trace(self) -> Dict[str, Any]:
        """Chrome trace-event dict: "X" complete events, microsecond
        timestamps, single pid/tid (the modeled system is one timeline)."""
        evs: List[Dict[str, Any]] = [
            dict(name="process_name", ph="M", pid=0, tid=0,
                 args=dict(name="repro.kg (modeled clock)")),
            dict(name="thread_name", ph="M", pid=0, tid=0,
                 args=dict(name="virtual")),
        ]
        for e in sorted(self.events, key=lambda e: e["seq"]):
            evs.append(dict(name=e["name"], cat=e["cat"], ph="X",
                            ts=round(e["ts"] * 1e6, 3),
                            dur=round(e["dur"] * 1e6, 3),
                            pid=0, tid=0, args=e["args"]))
        return {"traceEvents": evs, "displayTimeUnit": "ms"}

    def to_json(self) -> str:
        """Canonical serialization — sorted keys, no whitespace — so a
        fixed seed/executor yields a byte-identical file."""
        return json.dumps(self.chrome_trace(), sort_keys=True,
                          separators=(",", ":"))

    def to_jsonl(self) -> str:
        lines = [json.dumps(e, sort_keys=True, separators=(",", ":"))
                 for e in sorted(self.events, key=lambda e: e["seq"])]
        return "\n".join(lines) + ("\n" if lines else "")

    def export(self, path: str) -> int:
        """Write the trace to ``path`` (`.jsonl` → JSONL, else Chrome
        trace JSON). Returns the number of span events written."""
        text = self.to_jsonl() if path.endswith(".jsonl") else self.to_json()
        with open(path, "w") as fh:
            fh.write(text)
        return len(self.events)


class _NullSpan:
    """Shared inert span: context manager + annotate, records nothing."""

    __slots__ = ()

    def annotate(self, **attrs):
        return self

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return None


class NullTracer:
    """Off-by-default tracer: every method is a no-op returning the one
    shared inert span. ``enabled`` is False so hot sites can skip even
    building attribute dicts."""

    enabled = False
    _SPAN = _NullSpan()

    events: List[Dict[str, Any]] = []
    now = 0.0

    def __len__(self) -> int:
        return 0

    def span(self, name, cat="serve", dur=0.0, **attrs):
        return self._SPAN

    def instant(self, name, cat="mark", **attrs):
        return None

    def advance_to(self, t):
        return None

    def structure(self):
        return []

    def span_counts(self):
        return {}

    def find(self, name):
        return []


NULL_TRACER = NullTracer()
