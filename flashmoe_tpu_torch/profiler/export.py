"""Chrome-trace / Perfetto export of a :class:`PhaseTimeline` and of the
request tracer.

Counterpart of ``flashmoe_tpu/profiler/export.py:1-160, 260-312``.
Writes the JSON-object flavour of the Trace Event Format, which
``ui.perfetto.dev`` and ``chrome://tracing`` open directly:

* one process (pid) per timeline, named by ``process_name`` metadata;
* ``tid 0``: the MoE phase spans (``moe.gate`` .. ``moe.combine``; a
  chunked pipeline's ``moe.expert.k`` as slices of their own);
* ``tid 1``: the trainer's host sections (``train.*``);
* counter tracks (``ph: "C"``) for the samples a caller takes per step
  (expert-load imbalance, flight-recorder depth);
* per request, a track of its lifecycle spans
  (:func:`request_trace_events`).

Times are microseconds relative to each timeline's birth.
:func:`validate_trace` checks the invariants the documents rely on; both
writers run it before they write.  JAX's ``fleet_trace_*`` functions read
the serving fabric's pools and wait for it (ROADMAP "Serving fabric").
"""

from __future__ import annotations

import json

from flashmoe_tpu_torch.profiler.spans import PhaseTimeline

#: event types this exporter emits (a subset of the Trace Event spec);
#: "s"/"f" are flow start/finish, which the fleet document draws (JAX's
#: ``fleet_trace_events``; the validator accepts them)
_KNOWN_PH = ("X", "C", "M", "s", "f")


def chrome_trace_events(tl: PhaseTimeline, *, pid: int = 0,
                        process_name: str | None = None) -> list[dict]:
    """One timeline -> a list of Trace Event dicts."""
    name = process_name or tl.label or f"flashmoe timeline {pid}"
    events: list[dict] = [
        {"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
         "args": {"name": name}},
        {"ph": "M", "name": "thread_name", "pid": pid, "tid": 0,
         "args": {"name": "moe phases"}},
        {"ph": "M", "name": "thread_name", "pid": pid, "tid": 1,
         "args": {"name": "host sections"}},
    ]

    def complete(rec: dict, tid: int) -> dict:
        args = {"step": rec.get("step")}
        if rec.get("phase") and rec["phase"] != rec["name"]:
            args["phase"] = rec["phase"]  # chunked sub-slice -> base
        return {
            "ph": "X", "name": rec["name"], "cat": rec.get(
                "kind", "phase"),
            "ts": round(rec["ts_ms"] * 1e3, 3),
            "dur": max(round(rec["dur_ms"] * 1e3, 3), 0.001),
            "pid": pid, "tid": tid, "args": args,
        }

    for rec in tl.spans:
        events.append(complete(rec, 0))
    for rec in tl.sections:
        events.append(complete(rec, 1))
    for c in tl.counters:
        events.append({
            "ph": "C", "name": c["name"], "pid": pid,
            "ts": round(c["ts_ms"] * 1e3, 3),
            "args": {"value": c["value"]},
        })
    return events


def trace_document(timelines, *, labels=None) -> dict:
    """Merge one or more timelines into a single trace document (one
    pid each)."""
    if isinstance(timelines, PhaseTimeline):
        timelines = [timelines]
    events: list[dict] = []
    for pid, tl in enumerate(timelines):
        label = labels[pid] if labels else None
        events.extend(chrome_trace_events(tl, pid=pid,
                                          process_name=label))
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"producer": "flashmoe_tpu_torch.profiler"}}


def write_trace(timelines, path: str, *, labels=None) -> dict:
    """Write ``trace.json``; returns the document (already validated —
    a malformed export should fail at write time, not in Perfetto)."""
    doc = trace_document(timelines, labels=labels)
    errors = validate_trace(doc)
    if errors:
        raise ValueError(f"malformed trace export: {errors[:3]}")
    with open(path, "w") as f:
        json.dump(doc, f)
    return doc


def request_trace_events(tracer, *, base_pid: int = 1000) -> list[dict]:
    """One Perfetto track PER REQUEST from a
    :class:`flashmoe_tpu_torch.telemetry_plane.tracing.RequestTracer`: each
    request gets its own pid (named ``request <rid> [<trace_id>]``),
    with its lifecycle spans — ``serve.queued`` (eviction gaps render
    as ``serve.queued [resumed]`` slices), ``serve.prefill``,
    ``serve.step`` windows and the nested ``serve.decode`` device
    slices — as ``ph:"X"`` complete events.  Composable with
    :func:`chrome_trace_events` output (phase timelines keep pids <
    ``base_pid``), so one trace.json can carry both views."""
    events: list[dict] = []
    for idx, rid in enumerate(sorted(tracer.requests)):
        st = tracer.requests[rid]
        pid = base_pid + idx
        name = f"request {rid}"
        if st.trace_id:
            name += f" [{st.trace_id}]"
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "tid": 0, "args": {"name": name}})
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": 0, "args": {"name": "request lifecycle"}})
        for s in tracer.request_track(rid):
            label = s["name"]
            if s.get("resumed"):
                label += " [resumed]"
            events.append({
                "ph": "X", "name": label, "cat": "request",
                "ts": round(s["ts_ms"] * 1e3, 3),
                "dur": max(round(s["dur_ms"] * 1e3, 3), 0.001),
                "pid": pid, "tid": 0,
                "args": {"rid": rid, "trace_id": st.trace_id,
                         "step": s.get("step")},
            })
    return events


def request_trace_document(tracer, *, timelines=None,
                           labels=None) -> dict:
    """A full trace document of per-request tracks, optionally merged
    with phase timelines (one pid each, below the request pids)."""
    events: list[dict] = []
    if timelines is not None:
        events = trace_document(timelines, labels=labels)["traceEvents"]
    events.extend(request_trace_events(tracer))
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"producer": "flashmoe_tpu_torch.profiler"}}


def write_request_trace(tracer, path: str, *, timelines=None,
                        labels=None) -> dict:
    """Write the per-request trace (``validate_trace``-gated, like
    :func:`write_trace` — a malformed export fails at write time)."""
    doc = request_trace_document(tracer, timelines=timelines,
                                 labels=labels)
    errors = validate_trace(doc)
    if errors:
        raise ValueError(f"malformed request-trace export: {errors[:3]}")
    with open(path, "w") as f:
        json.dump(doc, f)
    return doc


def validate_trace(doc: dict) -> list[str]:
    """Schema check against the Trace Event Format invariants this
    exporter relies on.  Returns human-readable problems (empty =
    valid)."""
    errors: list[str] = []
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        return ["document is not a dict with a traceEvents list"]
    events = doc["traceEvents"]
    if not isinstance(events, list):
        return ["traceEvents is not a list"]
    for i, ev in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            errors.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in _KNOWN_PH:
            errors.append(f"{where}: unknown ph {ph!r}")
            continue
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            errors.append(f"{where}: missing name")
        if not isinstance(ev.get("pid"), int):
            errors.append(f"{where}: missing integer pid")
        if ph == "M":
            if not isinstance(ev.get("args"), dict):
                errors.append(f"{where}: metadata event without args")
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            errors.append(f"{where}: ts must be a non-negative number")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur <= 0:
                errors.append(f"{where}: complete event needs dur > 0")
            if not isinstance(ev.get("tid"), int):
                errors.append(f"{where}: complete event needs tid")
        if ph in ("s", "f"):
            if not isinstance(ev.get("tid"), int):
                errors.append(f"{where}: flow event needs tid")
            if not isinstance(ev.get("id"), (int, str)):
                errors.append(f"{where}: flow event needs an id")
        if ph == "C":
            args = ev.get("args")
            if not isinstance(args, dict) or not all(
                    isinstance(v, (int, float))
                    for v in args.values()):
                errors.append(
                    f"{where}: counter args must be numeric")
    try:
        json.dumps(doc)
    except (TypeError, ValueError) as e:
        errors.append(f"document not JSON-serializable: {e}")
    return errors
