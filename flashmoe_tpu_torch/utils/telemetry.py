"""Host-side telemetry the serving engine writes: a metrics registry, a
flight recorder and named spans.

Counterpart of the parts of ``flashmoe_tpu/utils/telemetry.py`` that the
engine calls: :class:`Metrics` (``:543``: counters, gauges, streaming
sketches and structured decision records), :class:`FlightRecorder`
(``:412``) and :func:`trace_span` (``:323``).  Here a span is a
``torch.profiler.record_function``, so the engine's ``serve.*`` spans
show in a ``torch.profiler`` trace.  The Prometheus exposition, the span
and decision-name registries and the live plane are not ported (ROADMAP
"Host-side planes"): a decision of any name is recorded.
"""

from __future__ import annotations

import contextlib
import json
import os
from collections import defaultdict, deque

import torch

from flashmoe_tpu_torch.telemetry_plane.sketch import QuantileSketch


@contextlib.contextmanager
def trace_span(name: str):
    """A named range in ``torch.profiler`` traces (host and, through the
    profiler's correlation, the kernels launched inside it)."""
    with torch.profiler.record_function(name):
        yield


class FlightRecorder:
    """Bounded ring buffer of per-step structured records.  Old records
    fall off the back; export dumps what the window still holds.

    Capacity: explicit argument, else ``FLASHMOE_FLIGHT_CAPACITY``, else
    1024 records."""

    def __init__(self, capacity: int | None = None):
        if capacity is None:
            try:
                capacity = int(os.environ.get(
                    "FLASHMOE_FLIGHT_CAPACITY", "1024"))
            except ValueError:
                capacity = 1024
        self._buf: deque = deque(maxlen=max(1, int(capacity)))

    @property
    def records(self) -> list[dict]:
        return list(self._buf)

    def record(self, **fields) -> dict:
        rec = dict(fields)
        self._buf.append(rec)
        return rec

    def export_jsonl(self, path: str) -> int:
        """Write every record the ring still holds to ``path`` as JSONL
        (truncating it); returns the count written."""
        with open(path, "w") as f:
            for rec in self._buf:
                f.write(json.dumps(rec) + "\n")
        return len(self._buf)


class Metrics:
    """Host-side metrics registry: counters, gauges, streaming quantile
    sketches and structured decision records."""

    def __init__(self):
        self.counters: dict[str, float] = defaultdict(float)
        self.gauges: dict[str, float] = {}
        self.sketches: dict[str, QuantileSketch] = {}
        self.decisions: list[dict] = []

    def count(self, name: str):
        self.counters[name] += 1

    def gauge(self, name: str, value: float):
        self.gauges[name] = float(value)

    def sketch(self, name: str, value: float):
        """Observe ``value`` on the named streaming quantile sketch
        (O(1) memory rolling p50/p90/p99)."""
        s = self.sketches.get(name)
        if s is None:
            s = self.sketches[name] = QuantileSketch()
        s.observe(value)
        return s

    def decision(self, name: str, **fields) -> dict:
        """Record a structured decision; every one is kept, in order."""
        rec = {"decision": name, **fields}
        self.decisions.append(rec)
        self.counters[f"decision.{name}"] += 1
        return rec

    def last_decision(self, name: str) -> dict | None:
        for rec in reversed(self.decisions):
            if rec["decision"] == name:
                return rec
        return None

    def dump_decisions_jsonl(self, path: str) -> int:
        """Append every decision to ``path`` as JSONL; returns the count."""
        with open(path, "a") as f:
            for rec in self.decisions:
                f.write(json.dumps(rec) + "\n")
        return len(self.decisions)


#: the process-wide registry the engine writes to when it is given none
metrics = Metrics()
