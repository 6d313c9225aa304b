"""Host-side telemetry: the metrics registry, histograms, the flight
recorder, named spans and the span and decision registries.

Counterpart of ``flashmoe_tpu/utils/telemetry.py``:

* :func:`trace_span`: a ``torch.profiler.record_function`` range (so the
  engine's and the layers' spans show in a ``torch.profiler`` trace)
  that also reports its host enter and exit to the armed span listener
  (:func:`set_span_listener`): the phase profiler's timeline
  (:mod:`flashmoe_tpu_torch.profiler.spans`) or the request tracer
  (:mod:`flashmoe_tpu_torch.telemetry_plane.tracing`);
* :data:`SPAN_NAMES` and :data:`DECISION_NAMES`, the registries of span
  and decision names (a decision of an unregistered name is recorded,
  warns and counts ``decision.unregistered``);
* :class:`Metrics`: counters, gauges (labeled too), wall timers,
  histograms, streaming quantile sketches and structured decisions, with
  JSONL export and the Prometheus text exposition
  (:meth:`Metrics.prometheus_text`, served as :data:`PROM_CONTENT_TYPE`
  by :mod:`flashmoe_tpu_torch.telemetry_plane.server`);
* :class:`FlightRecorder`: a bounded ring of per-step records with the
  offset-aware JSONL export.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import math
import os
import re
import time
import warnings
from collections import defaultdict, deque

import torch

from flashmoe_tpu_torch.telemetry_plane.sketch import QuantileSketch

#: The decision-name registry (``flashmoe_tpu/utils/telemetry.py:37``):
#: JAX's names with their meanings, and the port's own.  Every
#: ``Metrics.decision("x.y", ...)`` name the port records is declared
#: here; :meth:`Metrics.decision` warns on any other and counts
#: ``decision.unregistered``, so a typo'd name is seen, not silently
#: forked off the JSONL stream.  :func:`decision_table_markdown` renders
#: it.
DECISION_NAMES: dict[str, str] = {
    "bootstrap.groups":
        "the Decider formed DP x EP groups from the measured/mocked "
        "slice topology at bootstrap",
    "checkpoint.async_error":
        "a background async save failed (surfaced, not raised)",
    "checkpoint.emergency_save":
        "last good state persisted on an abort path",
    "checkpoint.fallback":
        "restore demoted a corrupt step to an older intact one",
    "controller.cooldown":
        "a trigger fired during cooldown (or planned a noop) and was "
        "suppressed",
    "controller.demotion_reset":
        "a restart cleared path demotions earned on the dead topology",
    "controller.morph":
        "the self-healing controller re-selected the MoE path mid-job",
    "controller.probe_error":
        "the slow-trigger throughput re-probe failed; re-placement "
        "degraded to uniform rates",
    "controller.replace":
        "the self-healing controller re-placed/replicated experts "
        "mid-job",
    "controller.replica_morph":
        "the controller drained (sustained-idle fabric) or returned "
        "(sustained queue pressure) a decode replica in the fabric "
        "router's rotation",
    "controller.spec_morph":
        "the controller switched speculative decoding off after the "
        "fleet acceptance EMA ran below the planner's break-even "
        "acceptance for the debounce window (token streams unchanged "
        "by construction — the morph costs zero tokens)",
    "controller.wire_morph":
        "the controller flipped the DCN-hop wire dtype after sustained "
        "a2a-leg dominance on a multi-slice job",
    "fabric.handoff":
        "a prefill KV run crossed to a decode replica as wire-coded "
        "pages: payload size, modeled DCN cost, and whether it hides "
        "under the decode pool's per-step objective",
    "fabric.handoff_drift":
        "measured-vs-priced reconciliation for one KV handoff on the "
        "virtual clock: measured DCN (modeled + chaos), hidden/exposed "
        "split against the decode tick, and whether the measured "
        "overlap verdict agrees with the priced one",
    "fabric.handoff_corrupt":
        "a KV-handoff transfer failed its per-page CRC32 verify at the "
        "receiver: which pages were corrupted, on which attempt — the "
        "bytes never reach the paged cache",
    "fabric.handoff_retry":
        "the handoff transport retransmitted a failed transfer "
        "(corrupt or timed out): attempt number, wasted wire ms, "
        "capped-exponential backoff, remaining retry budget",
    "fabric.heartbeat_miss":
        "a decode replica with pending work advanced no heartbeat seq "
        "across one fabric-step observation: consecutive miss count "
        "and remaining deadline budget before a stall is declared",
    "fabric.heartbeat_stall":
        "the heartbeat watchdog declared a replica stalled MID-STEP "
        "(its probe still answers — only the sub-step heartbeat "
        "deadline catches a hang): last published phase/seq and the "
        "detection latency in virtual decode ms",
    "fabric.migrate":
        "a crashed replica's request moved to a survivor: the resumed "
        "prompt carries every delivered token, so the deterministic "
        "re-prefill replays the token stream bit-equal",
    "fabric.replica_crash":
        "the fabric's health probes detected a dead decode replica: "
        "in-flight and queued victim counts, surviving rotation",
    "fabric.partition":
        "the KV wire dropped a transfer mid-stream (injected "
        "net_partition, or a real kernel-socket reset on the tcp "
        "wire): bytes that never crossed, attempt number — the "
        "receiver discarded the partial transfer at the short read",
    "fabric.route":
        "the replica router placed a request (session affinity or "
        "join-shortest-queue over live /healthz depths)",
    "frontdoor.brownout":
        "the front door's hysteretic overload detector changed state "
        "(enter/exit): queue pressure vs thresholds, debounce/cooldown "
        "/budget bookkeeping",
    "frontdoor.failover":
        "a dead front-door peer's namespace lease moved to a survivor: "
        "shard, old/new owner, bumped epoch",
    "frontdoor.fence":
        "the external lease store REFUSED a stale-epoch lease write: "
        "the claimant's fencing token is not newer than the stored "
        "epoch — the split-brain guard (a zombie door cannot take a "
        "shard back)",
    "frontdoor.lease_repair":
        "the lease store found a torn tail (a writer died mid-append) "
        "and rolled the log back to the last intact CRC-framed "
        "record: torn bytes dropped, restored epoch",
    "frontdoor.shed":
        "a brownout admission verdict: the arriving request was shed "
        "(rejected) or degraded (token budget capped) instead of "
        "joining an overloaded fleet",
    "frontdoor.submit":
        "the fabric front door accepted a request into the fleet-wide "
        "trace namespace and recorded the router's placement",
    "planner.backend_constraint":
        "auto pick demoted to a backend the config can actually run",
    "planner.drift":
        "measured latency compared against the analytical prediction",
    "planner.fallback":
        "a failed execution path was demoted for the process",
    "planner.overlap_drift":
        "measured overlap fraction compared against the chunked bound",
    "planner.path_select":
        "moe_backend='auto' resolved a path (full latency breakdown)",
    "planner.scaleout":
        "the planner traded EP-across-DCN against DP-across-DCN for a "
        "multi-slice job",
    "preempt.drain":
        "graceful drain completed: final step, remaining grace",
    "preempt.notice":
        "a preemption notice arrived (signal source, grace budget)",
    "regress.detected":
        "the perf sentry found a metric past its tolerance vs the "
        "rolling baseline in obs/history.jsonl",
    "planner.phase_drift":
        "one MoE phase's measured time compared against its prediction",
    "postmortem.saved":
        "a crash postmortem bundle was written (dir, error, step)",
    "serve.admit":
        "the serving engine admitted a request into the decode batch",
    "serve.attribution":
        "one retired request's measured latency decomposed into "
        "critical-path components (queue wait, router spill, prefill, "
        "handoff DCN, decode, eviction gaps) with the dominant "
        "contributor named; components sum to the span within 1%",
    "serve.evict":
        "page pressure preempted the youngest request back to the "
        "queue (its pages freed, delivered tokens stand)",
    "serve.plan":
        "the engine resolved its prefill- and decode-priced execution "
        "plans (decode priced at per-step token counts)",
    "serve.pools":
        "prefill/decode pool split over the inference-mode Decider "
        "(heterogeneous groups, no allreduce term)",
    "serve.quant":
        "the serving engine loaded a quantized expert state: store "
        "dtype, freed HBM, and the extra KV-cache pages that headroom "
        "buys (flashmoe_tpu/quant/)",
    "serve.retire":
        "a request completed (stop token or max length) with its "
        "TTFT/TPOT (plus per-request draft-acceptance stats when "
        "speculation is configured)",
    "serve.spec":
        "speculative decoding lifecycle: armed at engine build, "
        "morph_on/morph_off at a controller (or operator) toggle — "
        "with the SpecConfig knobs or the morph reason",
    "serve.trace":
        "a request's trace closed at retirement: trace_id, span count, "
        "evictions, end-to-end duration (telemetry_plane/tracing.py)",
    "slo.breach":
        "a step/phase time exceeded its SLO budget",
    "slo.recovered":
        "a breached SLO target returned under budget",
    "supervisor.resume":
        "a restart resumed: incarnation, step, world size, ep x dp",
    "telemetry.server_start":
        "the live telemetry scrape server came up (bound port)",
    "telemetry.server_stop":
        "the live telemetry scrape server shut down",
    "trainer.grad_skip":
        "tier 1 skipped an anomalous update in-graph",
}

#: The span-name registry, :data:`DECISION_NAMES`' counterpart for
#: :func:`trace_span` and the profiler's ``section(...)`` names (a
#: chunked pipeline span appends a numeric suffix to a registered base:
#: ``moe.expert.3``).  A misspelled span forks the phase timeline the
#: cost ledger joins on.  :func:`span_table_markdown` renders it.
SPAN_NAMES: dict[str, str] = {
    "moe.gate": "router: logits, top-k selection, aux losses",
    "moe.dispatch": "scatter tokens into the exchange layout",
    "moe.a2a_dispatch":
        "dispatch all-to-all (``.k`` suffix = pipeline chunk k)",
    "moe.expert": "expert FFN on received rows (``.k`` = chunk k)",
    "moe.a2a_combine":
        "return all-to-all (``.k`` suffix = pipeline chunk k)",
    "moe.combine": "weighted gather back to token order",
    "moe.fused_kernel": "fused RDMA kernel (dispatch+FFN in one launch)",
    "serve.prefill":
        "serving engine: single-pass prompt prefill into cache pages",
    "serve.prefill_chunk":
        "serving engine: one fixed-budget chunk of an admitted "
        "prompt's incremental prefill (chunked admission)",
    "serve.handoff":
        "fabric: a prefill KV run's page codec round-trip on its way "
        "to the decode replica",
    "serve.decode":
        "serving engine: one continuous-batching decode step",
    "serve.draft":
        "serving engine: host-side n-gram drafting over the per-slot "
        "suffix-match tables (speculative decode's propose phase)",
    "serve.verify":
        "serving engine: one speculative verify forward scoring "
        "draft_tokens+1 positions per slot (replaces serve.decode on "
        "steps where anything was drafted)",
    "serve.queued":
        "request trace: queue wait from arrival (or eviction — "
        "``resumed``) to admission; the visible eviction gap",
    "serve.request":
        "request trace: the parent span of one request's whole "
        "lifecycle (trace_id minted at serve.admit)",
    "serve.step":
        "request trace: the full engine-step window a request rode "
        "(covers host sampling/compile between the jitted spans)",
    "train.data_pull": "host wait on the data iterator",
    "train.step": "one train step: dispatch + device execution",
    "train.checkpoint": "checkpoint save on the step loop",
    "train.drain": "graceful preemption drain (final save + cursor)",
}


def register_span(name: str, meaning: str) -> None:
    """Declare a span name at runtime (plugins, experiments); the
    port's own names live in :data:`SPAN_NAMES`."""
    SPAN_NAMES[name] = meaning


def span_table_markdown() -> str:
    """The span registry as a markdown table, sorted by name."""
    lines = ["| span | meaning |", "|------|---------|"]
    for name in sorted(SPAN_NAMES):
        lines.append(f"| `{name}` | {SPAN_NAMES[name]} |")
    return "\n".join(lines)


def register_decision(name: str, meaning: str) -> None:
    """Declare a decision name at runtime (plugins, experiments); the
    port's own names live in :data:`DECISION_NAMES`."""
    DECISION_NAMES[name] = meaning


def decision_table_markdown() -> str:
    """The decision registry as a markdown table, sorted by name."""
    lines = ["| decision | meaning |", "|----------|---------|"]
    for name in sorted(DECISION_NAMES):
        lines.append(f"| `{name}` | {DECISION_NAMES[name]} |")
    return "\n".join(lines)


#: Active span listener (one slot): an object with ``span_enter(name)
#: -> token`` / ``span_exit(name, token)``, installed by the phase
#: profiler (:mod:`flashmoe_tpu_torch.profiler.spans`) while a timeline is
#: armed.  ``None`` (default) keeps :func:`trace_span` exactly the
#: metadata-only context manager it always was.
_SPAN_LISTENER: list = [None]


def set_span_listener(listener) -> None:
    """Install (or, with ``None``, remove) the span listener the phase
    profiler uses to turn trace_span sites into a host-side timeline."""
    _SPAN_LISTENER[0] = listener


def get_span_listener():
    """The currently armed listener (None when nothing is armed) — the
    request tracer (telemetry_plane/tracing.py) chains to it so phase
    profiling and request tracing compose."""
    return _SPAN_LISTENER[0]


@contextlib.contextmanager
def trace_span(name: str):
    """A named range in ``torch.profiler`` traces (host and, through the
    profiler's correlation, the kernels launched inside it).  With a
    span listener armed (:func:`set_span_listener`) its host enter and
    exit instants are reported to it as well."""
    lst = _SPAN_LISTENER[0]
    tok = lst.span_enter(name) if lst is not None else None
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if lst is not None:
            lst.span_exit(name, tok)


#: the running whole-program trace: (profiler, log_dir), or None
_TRACE: list = [None]


def start_trace(log_dir: str) -> None:
    """Start a whole-program trace (``jax.profiler.start_trace``'s
    counterpart) on ``torch.profiler.profile``: CPU activity, and CUDA's
    where a card is present.  :func:`stop_trace` writes it under
    ``log_dir`` as a Chrome trace, which holds the :func:`trace_span`
    ranges.  Raises if a trace is already running."""
    if _TRACE[0] is not None:
        raise RuntimeError("a trace is already running: stop_trace() first")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    _TRACE[0] = (prof, log_dir)


def stop_trace() -> str:
    """Stop the trace of :func:`start_trace` and write it as
    ``<log_dir>/trace.<pid>.<ns>.json`` (Chrome trace format); returns
    the file's path.  Raises if no trace is running."""
    if _TRACE[0] is None:
        raise RuntimeError("no trace is running: start_trace() first")
    prof, log_dir = _TRACE[0]
    _TRACE[0] = None
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir,
                        f"trace.{os.getpid()}.{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def capture_trace(log_dir: str):
    """:func:`start_trace` on entry, :func:`stop_trace` on exit."""
    start_trace(log_dir)
    try:
        yield
    finally:
        stop_trace()


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


#: the content type every Prometheus text-exposition response must
#: carry (the 0.0.4 text format) — the scrape server
#: (:mod:`flashmoe_tpu_torch.telemetry_plane.server`) sends exactly this on ``/metrics``
PROM_CONTENT_TYPE = "text/plain; version=0.0.4"


def _prom_name(name: str) -> str:
    """Sanitize to the Prometheus metric-name grammar
    ``[a-zA-Z_:][a-zA-Z0-9_:]*``."""
    n = re.sub(r"[^a-zA-Z0-9_:]", "_", name)
    if not n or n[0].isdigit():
        n = "_" + n
    return n


def escape_label_value(value) -> str:
    """Exposition-spec escaping for a label VALUE: backslash, newline,
    and double-quote must be escaped (in that order — escaping the
    backslash first keeps ``\\n`` from double-encoding), or a hostile
    value (a path with quotes, a reason string with newlines) breaks
    every parser downstream of ``/metrics``."""
    return (str(value).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _snapshot(obj, copy=dict):
    """Copy a registry container that another thread may be growing.

    Even a plain ``dict(d)`` / ``list(d.items())`` can raise
    "dictionary changed size during iteration" when the job thread
    inserts a new key mid-copy (observed under a scrape-hammer on
    CPython 3.10) — retry until a consistent copy lands; under the GIL
    a handful of attempts always suffices."""
    for _ in range(64):
        try:
            return copy(obj)
        except RuntimeError:
            continue
    return copy(obj)    # last try: surface the error if truly stuck


def _prom_labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{_prom_name(str(k))}="{escape_label_value(v)}"'
        for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class Metrics:
    """Host-side metrics registry: counters, gauges, wall timers,
    histograms, and structured decision records (planner path
    selections, schedule choices — anything a postmortem needs the full
    breakdown of, not just a scalar)."""

    def __init__(self):
        self.counters: dict[str, float] = defaultdict(float)
        self.gauges: dict[str, float] = {}
        self.times: dict[str, list[float]] = defaultdict(list)
        self.histograms: dict[str, Histogram] = {}
        self.sketches: dict = {}          # name -> QuantileSketch
        # name -> {sorted (label, value) tuple -> gauge value}
        self.labeled_gauges: dict[str, dict[tuple, float]] = {}
        self.decisions: list[dict] = []

    def count(self, name: str, inc: float = 1.0):
        self.counters[name] += inc

    def gauge(self, name: str, value: float):
        self.gauges[name] = float(value)

    def labeled_gauge(self, name: str, value: float, **labels):
        """A gauge with label dimensions (one value per label set) —
        e.g. ``labeled_gauge("serve.rate", 120.0, kind="tokens")``.
        Label VALUES are exposition-escaped at render time, so hostile
        strings (quotes, newlines, backslashes) cannot corrupt
        ``/metrics``."""
        key = tuple(sorted((str(k), str(v)) for k, v in labels.items()))
        self.labeled_gauges.setdefault(name, {})[key] = float(value)

    def histogram(self, name: str, value: float, buckets=None):
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram(buckets)
        h.observe(value)
        return h

    def sketch(self, name: str, value: float, quantiles=None):
        """Observe ``value`` on the named streaming quantile sketch
        (:mod:`flashmoe_tpu_torch.telemetry_plane.sketch`): O(1)-memory rolling p50/p90/p99
        instead of a full-history percentile list — the live plane's
        replacement for unbounded TTFT/TPOT retention.  Rendered as a
        Prometheus summary by :meth:`prometheus_text`."""
        s = self.sketches.get(name)
        if s is None:
            s = self.sketches[name] = QuantileSketch(
                quantiles or QuantileSketch.DEFAULT_QS)
        s.observe(value)
        return s

    def decision(self, name: str, **fields) -> dict:
        """Record a structured decision (e.g. the planner's path choice
        with its full latency breakdown).  Kept as a list so repeated
        decisions (one per layer/config) are all visible; ``summary()``
        reports the count per decision name.

        Unregistered names (not in :data:`DECISION_NAMES`) are recorded
        anyway — losing the record would be worse — but warn and count
        ``decision.unregistered``, so a typo is visible instead of
        silently forking the JSONL stream."""
        if name not in DECISION_NAMES:
            self.counters["decision.unregistered"] += 1
            warnings.warn(
                f"unregistered decision name {name!r}: declare it in "
                f"flashmoe_tpu_torch/utils/telemetry.py:DECISION_NAMES",
                RuntimeWarning, stacklevel=2)
        rec = {"decision": name, **fields}
        self.decisions.append(rec)
        self.counters[f"decision.{name}"] += 1
        return rec

    def last_decision(self, name: str) -> dict | None:
        for rec in reversed(self.decisions):
            if rec["decision"] == name:
                return rec
        return None

    @contextlib.contextmanager
    def timer(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times[name].append(time.perf_counter() - t0)

    def summary(self) -> dict:
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
        for k, s in self.sketches.items():
            for stat, val in s.summary().items():
                if val is not None:
                    out[f"{k}_{stat}"] = val
        return out

    def prometheus_text(self, prefix: str = "flashmoe") -> str:
        """Prometheus text-exposition (format 0.0.4) rendering of the
        registry: counters as ``*_total``, gauges (labeled included),
        timers and quantile sketches as summaries, histograms with
        cumulative ``le`` buckets.  Every family carries its ``# HELP``
        and ``# TYPE`` lines and every label value is spec-escaped
        (:func:`escape_label_value`); serve it with
        :data:`PROM_CONTENT_TYPE` (the scrape server does).

        Renders from SHALLOW SNAPSHOTS of the registry dicts: the
        scrape server calls this from its own thread while the job
        thread registers new metrics, and iterating the live dicts
        would intermittently raise "dictionary changed size during
        iteration" (an HTTP 500 on the first scrape that races a
        first-time counter/sketch)."""
        lines: list[str] = []
        counters = _snapshot(self.counters)
        gauges = _snapshot(self.gauges)
        labeled = {k: _snapshot(v)
                   for k, v in _snapshot(self.labeled_gauges).items()}
        times = {k: _snapshot(v, list)
                 for k, v in _snapshot(self.times).items()}
        sketches = _snapshot(self.sketches)
        histograms = _snapshot(self.histograms)

        def fmt(v: float) -> str:
            return repr(float(v))

        def family(n: str, kind: str, desc: str):
            lines.append(f"# HELP {n} {escape_label_value(desc)}")
            lines.append(f"# TYPE {n} {kind}")

        for name in sorted(counters):
            n = f"{prefix}_{_prom_name(name)}_total"
            family(n, "counter", f"flashmoe counter {name}")
            lines.append(f"{n} {fmt(counters[name])}")
        for name in sorted(gauges):
            n = f"{prefix}_{_prom_name(name)}"
            family(n, "gauge", f"flashmoe gauge {name}")
            lines.append(f"{n} {fmt(gauges[name])}")
        for name in sorted(labeled):
            series = labeled[name]
            n = f"{prefix}_{_prom_name(name)}"
            family(n, "gauge", f"flashmoe gauge {name}")
            for key in sorted(series):
                lines.append(f"{n}{_prom_labels(dict(key))} "
                             f"{fmt(series[key])}")
        for name in sorted(times):
            v = times[name]
            if not v:
                continue
            n = f"{prefix}_{_prom_name(name)}_seconds"
            s = sorted(v)
            family(n, "summary", f"flashmoe timer {name} (seconds)")
            lines += [
                f'{n}{{quantile="0.5"}} {fmt(s[len(s) // 2])}',
                f"{n}_sum {fmt(sum(v))}",
                f"{n}_count {len(v)}",
            ]
        for name in sorted(sketches):
            sk = sketches[name]
            if not sk.n:
                continue
            n = f"{prefix}_{_prom_name(name)}"
            family(n, "summary",
                   f"flashmoe streaming quantile sketch {name}")
            for q in sk.quantiles:
                val = sk.quantile(q)
                if val is not None:
                    lines.append(f'{n}{{quantile="{q:g}"}} {fmt(val)}')
            lines.append(f"{n}_sum {fmt(sk.total)}")
            lines.append(f"{n}_count {sk.n}")
        for name in sorted(histograms):
            h = histograms[name]
            n = f"{prefix}_{_prom_name(name)}"
            family(n, "histogram", f"flashmoe histogram {name}")
            cum = 0
            for bound, c in zip(h.buckets, h.counts):
                cum += c
                lines.append(f'{n}_bucket{{le="{bound:g}"}} {cum}')
            lines.append(f'{n}_bucket{{le="+Inf"}} {h.n}')
            lines.append(f"{n}_sum {fmt(h.total)}")
            lines.append(f"{n}_count {h.n}")
        return "\n".join(lines) + "\n"

    def dump_jsonl(self, path: str, **extra):
        rec = dict(self.summary(), **extra)
        with open(path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        return rec

    def dump_decisions_jsonl(self, path: str, start: int = 0) -> int:
        """Append recorded decisions (full breakdowns) as JSONL from
        index ``start`` on — callers that flush repeatedly (a periodic flusher)
        pass the previous return value so no decision is written twice.
        Returns the total decision count (the next call's ``start``)."""
        with open(path, "a") as f:
            for rec in self.decisions[start:]:
                f.write(json.dumps(rec) + "\n")
        return len(self.decisions)



#: the process-wide registry the engine and the runtime write to when
#: they are given none
metrics = Metrics()
