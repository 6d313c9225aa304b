"""Host-side telemetry the serving engine and the training runtime
write: a metrics registry, histograms, a flight recorder and named spans.

Counterpart of the parts of ``flashmoe_tpu/utils/telemetry.py`` that the
engine and the runtime call: :class:`Metrics` (``:543``: counters,
gauges, wall timers, histograms, streaming sketches, structured decision
records, ``summary`` and ``dump_jsonl``), :class:`Histogram` (``:356``),
:class:`FlightRecorder` (``:412``, with the offset-aware export) and
:func:`trace_span` (``:323``).  Here a span is a
``torch.profiler.record_function``, so the engine's ``serve.*`` spans
show in a ``torch.profiler`` trace.  The Prometheus exposition, the span
and decision-name registries and the live plane are not ported (ROADMAP
"Host-side planes"): a decision of any name is recorded.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import math
import os
import time
from collections import defaultdict, deque

import torch

from flashmoe_tpu_torch.telemetry_plane.sketch import QuantileSketch


@contextlib.contextmanager
def trace_span(name: str):
    """A named range in ``torch.profiler`` traces (host and, through the
    profiler's correlation, the kernels launched inside it)."""
    with torch.profiler.record_function(name):
        yield


class Histogram:
    """Fixed-bucket histogram with percentile estimates (JAX's buckets:
    1-2.5-5 decades from 1e-3 to 5e3 unless ``buckets`` are given)."""

    DEFAULT_BUCKETS = tuple(
        m * 10.0 ** e for e in range(-3, 4) for m in (1.0, 2.5, 5.0))

    def __init__(self, buckets=None):
        self.buckets = tuple(sorted(buckets)) if buckets \
            else self.DEFAULT_BUCKETS
        # counts[i]: observations in (buckets[i-1], buckets[i]];
        # counts[-1]: those above buckets[-1]
        self.counts = [0] * (len(self.buckets) + 1)
        self.n = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, value: float):
        v = float(value)
        self.counts[bisect.bisect_left(self.buckets, v)] += 1
        self.n += 1
        self.total += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    def percentile(self, q: float) -> float:
        """Approximate q-quantile (0..1): the upper bound of the bucket
        that holds it, capped at the largest observation."""
        if not self.n:
            return 0.0
        target = q * self.n
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= target and c:
                hi = self.buckets[i] if i < len(self.buckets) else self.max
                return min(hi, self.max)
        return self.max

    def summary(self) -> dict:
        if not self.n:
            return {"count": 0}
        return {"count": self.n, "sum": self.total, "min": self.min,
                "max": self.max, "mean": self.total / self.n,
                "p50": self.percentile(0.5), "p99": self.percentile(0.99)}


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
        self._total = 0  # records ever recorded, the ring's wraps included

    @property
    def capacity(self) -> int:
        return self._buf.maxlen

    @property
    def records(self) -> list[dict]:
        return list(self._buf)

    @property
    def total_recorded(self) -> int:
        """Records ever recorded: the index space of ``start``."""
        return self._total

    def __len__(self) -> int:
        return len(self._buf)

    def record(self, **fields) -> dict:
        rec = dict(fields)
        self._buf.append(rec)
        self._total += 1
        return rec

    def export_jsonl(self, path: str, start: int | None = None,
                     metrics_obj: "Metrics | None" = None) -> int:
        """Write the ring's records to ``path`` as JSONL.

        ``start=None``: truncate ``path``, write every record the ring
        holds and return the count written.  ``start=<int>``: write the
        held records whose absolute index is at least ``start`` (a fresh
        file when ``start`` is 0, appended otherwise) and return the total
        count recorded, the next call's ``start``; records that left the
        ring before they were written are counted as
        ``flight.export_lost`` in ``metrics_obj`` (the global registry by
        default)."""
        if start is None:
            with open(path, "w") as f:
                for rec in self._buf:
                    f.write(json.dumps(rec) + "\n")
            return len(self._buf)
        oldest = self._total - len(self._buf)
        lost = max(0, oldest - max(start, 0))
        if lost:
            sink = metrics_obj if metrics_obj is not None else metrics
            sink.count("flight.export_lost", lost)
        first = max(start - oldest, 0)
        with open(path, "w" if start <= 0 else "a") as f:
            for i, rec in enumerate(self._buf):
                if i >= first:
                    f.write(json.dumps(rec) + "\n")
        return self._total


class Metrics:
    """Host-side metrics registry: counters, gauges, wall timers,
    histograms, streaming quantile sketches and structured decision
    records."""

    def __init__(self):
        self.counters: dict[str, float] = defaultdict(float)
        self.gauges: dict[str, float] = {}
        self.times: dict[str, list[float]] = defaultdict(list)
        self.histograms: dict[str, Histogram] = {}
        self.sketches: dict[str, QuantileSketch] = {}
        self.decisions: list[dict] = []

    def count(self, name: str, inc: float = 1.0):
        self.counters[name] += inc

    def gauge(self, name: str, value: float):
        self.gauges[name] = float(value)

    def histogram(self, name: str, value: float, buckets=None) -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram(buckets)
        h.observe(value)
        return h

    @contextlib.contextmanager
    def timer(self, name: str):
        """Append the block's wall seconds to ``times[name]``."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times[name].append(time.perf_counter() - t0)

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

    def summary(self) -> dict:
        """One flat dict: counters, gauges, each timer's ``_ms_p50``,
        ``_ms_sum`` and ``_calls``, each histogram's and sketch's
        statistics (JAX's keys)."""
        out: dict[str, float] = dict(self.counters)
        out.update(self.gauges)
        for k, v in self.times.items():
            if v:
                s = sorted(v)
                out[f"{k}_ms_p50"] = s[len(s) // 2] * 1e3
                out[f"{k}_ms_sum"] = sum(v) * 1e3
                out[f"{k}_calls"] = len(v)
        for k, h in self.histograms.items():
            for stat, val in h.summary().items():
                out[f"{k}_{stat}"] = val
        for k, sk in self.sketches.items():
            for stat, val in sk.summary().items():
                if val is not None:
                    out[f"{k}_{stat}"] = val
        return out

    def dump_jsonl(self, path: str, **extra) -> dict:
        """Append ``summary()`` with ``extra`` to ``path`` as one JSON
        line; returns the record."""
        rec = dict(self.summary(), **extra)
        with open(path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        return rec

    def dump_decisions_jsonl(self, path: str) -> int:
        """Append every decision to ``path`` as JSONL; returns the count."""
        with open(path, "a") as f:
            for rec in self.decisions:
                f.write(json.dumps(rec) + "\n")
        return len(self.decisions)


#: the process-wide registry the engine and the runtime write to when
#: they are given none
metrics = Metrics()
