"""Request-scoped tracing for the serving engine.

Counterpart of ``flashmoe_tpu/telemetry_plane/tracing.py``.
:class:`RequestTracer` mints a trace context (``trace_id``, parent span
``serve.request``) at ``serve.admit`` and threads it through a request's
lifecycle

    queued -> admit -> prefill -> per-step decode
           -> (evict -> re-queue -> re-prefill)* -> retire

as one contiguous list of child spans:

* ``serve.queued``: arrival (or eviction) to admission: the queue wait
  and every eviction gap (``resumed=True``);
* ``serve.prefill`` / ``serve.prefill_chunk``: each prefill, taken from
  the telemetry span-listener hook; the tracer chains to whatever
  listener was armed (a :class:`~flashmoe_tpu_torch.profiler.spans.
  PhaseTimeline` keeps working);
* ``serve.decode``: one span per decode step the request rode;
* ``serve.step``: the whole engine-step window each active request rode
  (begin_step to end_step), which covers the host work between the
  device spans and keeps a retired request's track contiguous.

:func:`flashmoe_tpu_torch.profiler.export.request_trace_document`
renders one Perfetto track per request; :meth:`RequestTracer.validate`
is the no-orphan / contiguity gate.  The tracer is host bookkeeping
around the engine's calls: the token streams are the same with it armed
or not.
"""

from __future__ import annotations

import json
import time

#: tolerated clock slack (ms) when checking track contiguity — spans
#: are stamped around host dispatch, so neighbours may be a hair apart
CONTIGUITY_SLACK_MS = 5.0


class _RequestState:
    """Mutable per-request trace under construction."""

    __slots__ = ("rid", "trace_id", "spans", "open_queued", "evictions",
                 "retired", "t_first", "t_last", "steps")

    def __init__(self, rid: int, trace_id: str, t0: float):
        self.rid = rid
        self.trace_id = trace_id
        self.spans: list[dict] = []
        self.open_queued: float | None = t0   # queue wait in progress
        self.evictions = 0
        self.retired = False
        self.t_first = t0
        self.t_last = t0
        self.steps = 0


class RequestTracer:
    """Span listener + lifecycle recorder.  Install with
    :meth:`install` (chains to the currently armed listener) or hand it
    to :class:`~flashmoe_tpu_torch.serving.engine.ServingEngine`, which
    does both ends of the lifecycle wiring."""

    def __init__(self, metrics_obj=None, clock=time.monotonic):
        self._clock = clock
        self._birth = clock()
        self._metrics = metrics_obj
        self._inner = None          # chained listener (PhaseTimeline)
        self._installed = False
        self.requests: dict[int, _RequestState] = {}
        # engine-set attribution context for listener spans
        self._prefill_rid: int | None = None
        self._active_rids: tuple[int, ...] = ()
        self._step: int | None = None
        self._step_t0: float | None = None
        self._joined_at: dict[int, float] = {}
        self._pending_retires: list = []

    # ---- clock --------------------------------------------------------

    def _now_ms(self) -> float:
        return (self._clock() - self._birth) * 1e3

    # ---- listener chaining -------------------------------------------

    def install(self) -> "RequestTracer":
        """Become the active telemetry span listener, forwarding to any
        previously armed one (a PhaseTimeline keeps working)."""
        from flashmoe_tpu_torch.utils.telemetry import (
            get_span_listener, set_span_listener,
        )

        if not self._installed:
            self._inner = get_span_listener()
            set_span_listener(self)
            self._installed = True
        return self

    def uninstall(self) -> None:
        from flashmoe_tpu_torch.utils.telemetry import (
            get_span_listener, set_span_listener,
        )

        if self._installed and get_span_listener() is self:
            set_span_listener(self._inner)
        self._installed = False
        self._inner = None

    # ---- the span-listener protocol ----------------------------------

    def span_enter(self, name: str):
        inner_tok = (self._inner.span_enter(name)
                     if self._inner is not None else None)
        return (self._now_ms(), inner_tok)

    def span_exit(self, name: str, tok) -> None:
        if tok is None:
            return
        t0, inner_tok = tok
        if self._inner is not None:
            self._inner.span_exit(name, inner_tok)
        now = self._now_ms()
        if name in ("serve.prefill", "serve.prefill_chunk",
                    "serve.handoff") and self._prefill_rid is not None:
            # serve.handoff nests inside serve.prefill (the fabric's
            # KV-page crossing), serve.prefill_chunk is armed per-slot
            # via on_prefill_chunk — all three attribute to the request
            # whose prompt is being prefilled
            self._span(self._prefill_rid, name, t0, now)
        elif name == "serve.decode":
            for rid in self._active_rids:
                self._span(rid, "serve.decode", t0, now)

    # ---- lifecycle events (called by the engine) ---------------------

    def on_arrival(self, rid: int) -> None:
        """The request's trace arrival step was reached: the queue-wait
        clock starts (TTFT base)."""
        if rid not in self.requests:
            self.requests[rid] = _RequestState(rid, "", self._now_ms())

    def on_admit(self, rid: int, step: int, resumed: bool) -> None:
        """Admission closes the open queued span; the first admission
        mints the trace id.  The engine runs its prefill immediately
        after, attributed to this rid via the listener hook."""
        now = self._now_ms()
        st = self.requests.get(rid)
        if st is None:
            st = self.requests[rid] = _RequestState(rid, "", now)
        if not st.trace_id:
            st.trace_id = f"req{rid:x}-{int(step):x}"
        if st.open_queued is not None:
            self._span(rid, "serve.queued", st.open_queued, now,
                       resumed=resumed)
            st.open_queued = None
        self._prefill_rid = rid
        self._step = int(step)
        # join the open step window from the admission instant on
        if self._step_t0 is not None and rid not in self._active_rids:
            self._active_rids = self._active_rids + (rid,)
            self._joined_at[rid] = now
            st.steps += 1

    def on_prefill_chunk(self, rid: int) -> None:
        """Arm prefill attribution for one mid-prefill slot before its
        ``serve.prefill_chunk`` span — chunked prefills interleave
        across slots, so the admission-time ``_prefill_rid`` context is
        stale by the time a later chunk runs."""
        self._prefill_rid = int(rid)

    def on_evict(self, rid: int, step: int) -> None:
        """Eviction re-opens the queued clock: the gap until the
        re-admission renders as a ``serve.queued`` span with
        ``resumed=True`` — the visible hole in the decode train.  The
        evictee LEAVES the open step window here: its ``serve.step``
        span closes at the eviction instant and the rest of the step
        (including the decode it no longer rides) is not attributed to
        it — decode slices must never overlap the eviction gap."""
        st = self.requests.get(rid)
        if st is None:
            return
        st.evictions += 1
        now = self._now_ms()
        if self._step_t0 is not None and rid in self._active_rids:
            t0 = self._joined_at.get(rid, self._step_t0)
            self._span(rid, "serve.step", t0, now)
            self._active_rids = tuple(r for r in self._active_rids
                                      if r != rid)
            self._joined_at.pop(rid, None)
        st.open_queued = now

    def begin_step(self, step: int, active_rids) -> None:
        """Engine step boundary (called at the TOP of the engine step,
        before arrivals/admissions): decode spans emitted by the
        listener hook until :meth:`end_step` belong to ``active_rids``
        plus any request admitted during the step, and each of them
        gets a ``serve.step`` window span when the step closes.  The
        window opening before ``_admit`` is what keeps a neighbour's
        prefill (or its first-call compile) from punching a hole in
        every other active request's track."""
        self._step = int(step)
        self._active_rids = tuple(int(r) for r in active_rids)
        self._prefill_rid = None
        self._step_t0 = self._now_ms()
        self._joined_at: dict[int, float] = {}
        for rid in self._active_rids:
            st = self.requests.get(rid)
            if st is not None:
                st.steps += 1

    def end_step(self) -> None:
        """Close the engine-step window: every request that rode this
        step gets a ``serve.step`` span covering it end to end — the
        contiguity filler over host sampling/compile time.  A request
        admitted mid-step starts its window at its admission instant,
        so the span never predates its queued span.  Retirements that
        happened during the step emit their ``serve.trace`` decision
        HERE, after the closing window span, so the decision's span
        count matches the finished track."""
        if self._step_t0 is None:
            return
        now = self._now_ms()
        for rid in self._active_rids:
            t0 = self._joined_at.get(rid, self._step_t0)
            self._span(rid, "serve.step", t0, now)
        self._step_t0 = None
        self._active_rids = ()
        self._joined_at = {}
        pending, self._pending_retires = self._pending_retires, []
        for rid, step, fields in pending:
            self._emit_trace_decision(rid, step, **fields)

    def on_retire(self, rid: int, step: int, *, tokens=None,
                  ttft_ms=None, tpot_ms=None) -> None:
        st = self.requests.get(rid)
        if st is None:
            return
        st.retired = True
        st.t_last = self._now_ms()
        fields = {"tokens": tokens, "ttft_ms": ttft_ms,
                  "tpot_ms": tpot_ms}
        if self._step_t0 is not None:
            # mid-step retire: the closing serve.step span is still
            # coming — decide at end_step so the count is final
            self._pending_retires.append((rid, int(step), fields))
        else:
            self._emit_trace_decision(rid, int(step), **fields)

    def _emit_trace_decision(self, rid: int, step: int, *, tokens=None,
                             ttft_ms=None, tpot_ms=None) -> None:
        st = self.requests.get(rid)
        if st is None or self._metrics is None:
            return
        self._metrics.decision(
            "serve.trace", rid=rid, trace_id=st.trace_id,
            step=step, spans=len(st.spans), steps=st.steps,
            evictions=st.evictions, tokens=tokens,
            ttft_ms=ttft_ms, tpot_ms=tpot_ms,
            dur_ms=round(st.t_last - st.t_first, 3))

    # ---- recording ---------------------------------------------------

    def _span(self, rid: int, name: str, t0: float, t1: float,
              **extra) -> None:
        st = self.requests.get(rid)
        if st is None:
            return
        st.t_last = max(st.t_last, t1)
        st.spans.append({
            "name": name, "rid": rid, "trace_id": st.trace_id,
            "ts_ms": round(t0, 6),
            "dur_ms": round(max(t1 - t0, 1e-6), 6),
            "step": self._step, **extra,
        })

    # ---- views -------------------------------------------------------

    def request_track(self, rid: int) -> list[dict]:
        """One request's spans in timeline order (the per-request
        Perfetto track, and what ``observe --trace`` renders)."""
        st = self.requests.get(rid)
        if st is None:
            return []
        return sorted(st.spans, key=lambda s: s["ts_ms"])

    def validate(self) -> list[str]:
        """The no-orphan / contiguity gate.  Empty list = every retired
        request reconstructs to a contiguous track: it starts with a
        queued span, every gap between consecutive spans is covered
        (within :data:`CONTIGUITY_SLACK_MS`), every eviction shows up
        as a ``resumed`` queued span, and no span belongs to an unknown
        request."""
        problems: list[str] = []
        for rid, st in sorted(self.requests.items()):
            track = self.request_track(rid)
            if not st.retired:
                continue
            if not track:
                problems.append(f"request {rid}: retired with no spans")
                continue
            if not st.trace_id:
                problems.append(f"request {rid}: no trace_id minted")
            if track[0]["name"] != "serve.queued":
                problems.append(
                    f"request {rid}: track starts with "
                    f"{track[0]['name']!r}, not serve.queued")
            gaps = [s for s in track if s["name"] == "serve.queued"
                    and s.get("resumed")]
            if len(gaps) != st.evictions:
                problems.append(
                    f"request {rid}: {st.evictions} evictions but "
                    f"{len(gaps)} resumed queued spans")
            end = None
            for s in track:
                if s.get("rid") != rid:
                    problems.append(f"request {rid}: orphan span "
                                    f"{s['name']} tagged rid={s.get('rid')}")
                if end is not None \
                        and s["ts_ms"] - end > CONTIGUITY_SLACK_MS:
                    problems.append(
                        f"request {rid}: {s['ts_ms'] - end:.3f} ms "
                        f"uncovered gap before {s['name']} at "
                        f"{s['ts_ms']:.3f}")
                end = max(end or 0.0, s["ts_ms"] + s["dur_ms"])
        return problems

    # ---- export ------------------------------------------------------

    def records(self) -> list[dict]:
        """Flight-recorder-shaped records (``kind="serve_trace_span"``),
        the JSONL form ``observe --trace`` consumes."""
        out = []
        for rid in sorted(self.requests):
            st = self.requests[rid]
            for s in self.request_track(rid):
                out.append({"kind": "serve_trace_span",
                            "evictions": st.evictions,
                            "retired": st.retired, **s})
        return out

    def export_jsonl(self, path: str) -> int:
        recs = self.records()
        with open(path, "w") as f:
            for rec in recs:
                f.write(json.dumps(rec) + "\n")
        return len(recs)
