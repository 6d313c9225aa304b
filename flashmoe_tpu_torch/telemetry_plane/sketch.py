"""Bounded-memory streaming aggregation: quantile sketch and windowed
rates.

Counterpart of ``flashmoe_tpu/telemetry_plane/sketch.py`` (the port keeps
its own copy of the pure-Python logic):

* :class:`P2Quantile`: the P² algorithm (Jain & Chlamtac 1985), one
  target quantile tracked with five markers, each ``observe`` adjusting
  the marker heights by a piecewise-parabolic fit.  Exact for n <= 5,
  approximate beyond; no buffers, no sorting.
* :class:`QuantileSketch`: a bundle of P² cells (default p50/p90/p99)
  plus exact count/sum/min/max, with a small exact buffer for n <=
  ``EXACT_N`` so small samples report nearest-rank-exact percentiles.
* :class:`WindowedRate`: per-second rate over a sliding window in
  one-second buckets (memory = window seconds, not event count).

The serving engine keeps its TTFT / TPOT / step-time sketches and its
token, admission and eviction rates here.
"""

from __future__ import annotations

import math
import time

#: below this count the sketch answers from an exact nearest-rank
#: buffer; at and beyond it the P² markers take over.  Keeps CI drills
#: (tens of requests) bit-comparable with the old exact percentiles.
EXACT_N = 64


class P2Quantile:
    """One target quantile via the P² algorithm: five markers whose
    heights converge on the q-quantile of the stream.  O(1) memory and
    O(1) per observation."""

    def __init__(self, q: float):
        if not 0.0 < q < 1.0:
            raise ValueError(f"quantile must be in (0, 1), got {q}")
        self.q = float(q)
        self._heights: list[float] = []        # marker heights (sorted)
        self._pos = [1.0, 2.0, 3.0, 4.0, 5.0]  # actual positions
        self._want = [1.0, 1.0 + 2 * q, 1.0 + 4 * q, 3.0 + 2 * q, 5.0]
        self._dwant = [0.0, q / 2.0, q, (1.0 + q) / 2.0, 1.0]
        self.n = 0

    def observe(self, value: float) -> None:
        v = float(value)
        self.n += 1
        h = self._heights
        if len(h) < 5:
            h.append(v)
            h.sort()
            return
        # locate the cell and bump marker positions
        if v < h[0]:
            h[0] = v
            k = 0
        elif v >= h[4]:
            h[4] = v
            k = 3
        else:
            k = 0
            while k < 3 and v >= h[k + 1]:
                k += 1
        for i in range(k + 1, 5):
            self._pos[i] += 1.0
        for i in range(5):
            self._want[i] += self._dwant[i]
        # adjust the three interior markers
        for i in (1, 2, 3):
            d = self._want[i] - self._pos[i]
            if (d >= 1.0 and self._pos[i + 1] - self._pos[i] > 1.0) or \
                    (d <= -1.0 and self._pos[i - 1] - self._pos[i] < -1.0):
                d = 1.0 if d >= 0 else -1.0
                hi = self._parabolic(i, d)
                if not h[i - 1] < hi < h[i + 1]:
                    hi = self._linear(i, d)
                h[i] = hi
                self._pos[i] += d

    def _parabolic(self, i: int, d: float) -> float:
        h, p = self._heights, self._pos
        return h[i] + d / (p[i + 1] - p[i - 1]) * (
            (p[i] - p[i - 1] + d) * (h[i + 1] - h[i])
            / (p[i + 1] - p[i])
            + (p[i + 1] - p[i] - d) * (h[i] - h[i - 1])
            / (p[i] - p[i - 1]))

    def _linear(self, i: int, d: float) -> float:
        h, p = self._heights, self._pos
        j = i + int(d)
        return h[i] + d * (h[j] - h[i]) / (p[j] - p[i])

    def value(self) -> float | None:
        if not self._heights:
            return None
        if len(self._heights) < 5:
            # tiny stream: nearest-rank over what we have
            s = sorted(self._heights)
            return s[min(len(s) - 1, int(self.q * len(s)))]
        return self._heights[2]


class QuantileSketch:
    """Streaming summary of one metric: exact count/sum/min/max plus a
    P² cell per target quantile, exact (nearest-rank) below
    :data:`EXACT_N` observations.

    Error bound: below ``EXACT_N`` observations the reported quantiles
    ARE the nearest-rank percentiles (the ``loadgen.pctl`` definition).
    Beyond, P² marker heights are always genuine observed-range values
    (clamped between the running min and max) and for well-behaved
    (unimodal, non-adversarial) streams the relative rank error is
    small — the classic P² result; tests/test_telemetry_plane.py gates
    a ~10% relative-value band on lognormal-ish latency data."""

    DEFAULT_QS = (0.5, 0.9, 0.99)

    def __init__(self, quantiles=DEFAULT_QS):
        self.quantiles = tuple(float(q) for q in quantiles)
        self._cells = {q: P2Quantile(q) for q in self.quantiles}
        self._exact: list[float] | None = []   # None once graduated
        self.n = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, value: float) -> None:
        v = float(value)
        self.total += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        for cell in self._cells.values():
            cell.observe(v)
        if self._exact is not None:
            self._exact.append(v)
            if len(self._exact) >= EXACT_N:
                self._exact = None            # bounded memory from here
        # count LAST: a scrape thread that sees n >= 1 must also see
        # the observation it counts (the first-scrape race class)
        self.n += 1

    def quantile(self, q: float) -> float | None:
        """The q-quantile estimate: nearest-rank exact below
        :data:`EXACT_N` observations, P² beyond (clamped to the
        observed [min, max])."""
        if not self.n:
            return None
        # bind once: the job thread may graduate the buffer to None
        # (64th observe) between a scrape thread's check and its read
        buf = self._exact
        if buf is not None:
            s = sorted(buf)
            if not s:                 # racing first observe: no data yet
                return None
            return s[min(len(s) - 1, int(q * len(s)))]
        cell = self._cells.get(float(q))
        if cell is None:
            # nearest tracked quantile stands in for an untracked ask
            qq = min(self.quantiles, key=lambda t: abs(t - q))
            cell = self._cells[qq]
        v = cell.value()
        return None if v is None else min(max(v, self.min), self.max)

    @property
    def mean(self) -> float | None:
        return self.total / self.n if self.n else None

    def summary(self) -> dict:
        if not self.n:
            return {"count": 0}
        out = {"count": self.n, "sum": self.total, "min": self.min,
               "max": self.max, "mean": self.total / self.n}
        for q in self.quantiles:
            out[f"p{int(q * 100)}"] = self.quantile(q)
        return out


class WindowedRate:
    """Events per second over a sliding window, bucketed at one-second
    granularity so memory is O(window seconds) regardless of event
    count.  ``add(n)`` records ``n`` events now; ``rate()`` is the
    window's per-second average."""

    def __init__(self, window_s: float = 30.0, clock=time.monotonic):
        if window_s <= 0:
            raise ValueError("window_s must be > 0")
        self.window_s = float(window_s)
        self._clock = clock
        self._buckets: dict[int, float] = {}
        self.total = 0.0

    def _prune(self, now: float) -> None:
        horizon = int(now - self.window_s)
        for k in [k for k in self._buckets if k < horizon]:
            del self._buckets[k]

    def add(self, n: float = 1.0) -> float:
        now = self._clock()
        b = int(now)
        self._buckets[b] = self._buckets.get(b, 0.0) + float(n)
        self.total += float(n)
        self._prune(now)
        return self.rate(now)

    def rate(self, now: float | None = None) -> float:
        now = self._clock() if now is None else now
        self._prune(now)
        if not self._buckets:
            return 0.0
        span = max(now - min(self._buckets), 1.0)
        return sum(self._buckets.values()) / min(span, self.window_s)
