"""Chrome-trace / Perfetto export of a :class:`PhaseTimeline` and of the
request tracer.

Counterpart of ``flashmoe_tpu/profiler/export.py``.
Writes the JSON-object flavour of the Trace Event Format, which
``ui.perfetto.dev`` and ``chrome://tracing`` open directly:

* one process (pid) per timeline, named by ``process_name`` metadata;
* ``tid 0``: the MoE phase spans (``moe.gate`` .. ``moe.combine``; a
  chunked pipeline's ``moe.expert.k`` as slices of their own);
* ``tid 1``: the trainer's host sections (``train.*``);
* counter tracks (``ph: "C"``) for the samples a caller takes per step
  (expert-load imbalance, flight-recorder depth);
* per request, a track of its lifecycle spans
  (:func:`request_trace_events`);
* the serving fabric's fleet view: a process per pool, each request a
  thread on the pools it visited, a flow arrow from its prefill-pool
  span to its decode resume (:func:`fleet_trace_events`).

Times are microseconds relative to each timeline's birth.
:func:`validate_trace` checks the invariants the documents rely on; both
writers run it before they write.
"""

from __future__ import annotations

import json

from flashmoe_tpu_torch.profiler.spans import PhaseTimeline

#: event types this exporter emits (a subset of the Trace Event spec);
#: "s"/"f" are flow start/finish, which the fleet document draws
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


#: lifecycle spans that ran in the prefill pool (the fabric's handoff
#: prefills there; everything else is decode-replica work)
_PREFILL_POOL_SPANS = ("serve.prefill", "serve.handoff")


def fleet_trace_events(tracer, placement, *, prefill_pid: int = 1999,
                       base_pid: int = 2000,
                       replicas: int | None = None) -> list[dict]:
    """ONE fleet view of a fabric drill: a process track per decode
    replica (pid ``base_pid + r``) plus one for the prefill pool, each
    request a thread (``tid = rid``) on the pool(s) it visited, and a
    flow arrow (``ph "s"``/``"f"``, id = rid) linking the request's
    prefill-pool span to its decode-pool resume — the cross-pool
    journey the per-request view can't show.

    ``placement``: ``{rid: decode replica}`` (``ServingFabric.
    _placement`` / ``summary()["placement"]``)."""
    events: list[dict] = []
    if replicas is None:
        replicas = (max((int(r) for r in placement.values()),
                        default=0) + 1) if placement else 1
    events.append({"ph": "M", "name": "process_name",
                   "pid": prefill_pid, "tid": 0,
                   "args": {"name": "prefill pool"}})
    for r in range(replicas):
        events.append({"ph": "M", "name": "process_name",
                       "pid": base_pid + r, "tid": 0,
                       "args": {"name": f"decode pool r{r}"}})
    for rid in sorted(tracer.requests):
        st = tracer.requests[rid]
        replica = int(placement.get(rid, 0))
        dec_pid = base_pid + replica
        tid = int(rid)
        label = f"request {rid}"
        if st.trace_id:
            label += f" [{st.trace_id}]"
        track = tracer.request_track(rid)
        crossed = any(s["name"] in _PREFILL_POOL_SPANS for s in track)
        events.append({"ph": "M", "name": "thread_name", "pid": dec_pid,
                       "tid": tid, "args": {"name": label}})
        if crossed:
            events.append({"ph": "M", "name": "thread_name",
                           "pid": prefill_pid, "tid": tid,
                           "args": {"name": label}})
        prefill_start = None
        first_decode = None
        for s in track:
            name = s["name"]
            on_prefill = name in _PREFILL_POOL_SPANS
            lbl = name + (" [resumed]" if s.get("resumed") else "")
            events.append({
                "ph": "X", "name": lbl, "cat": "fabric",
                "ts": round(s["ts_ms"] * 1e3, 3),
                "dur": max(round(s["dur_ms"] * 1e3, 3), 0.001),
                "pid": prefill_pid if on_prefill else dec_pid,
                "tid": tid,
                "args": {"rid": rid, "trace_id": st.trace_id,
                         "step": s.get("step"), "replica": replica},
            })
            if on_prefill and prefill_start is None:
                prefill_start = s
            if name == "serve.decode" and first_decode is None:
                first_decode = s
        if prefill_start is not None and first_decode is not None:
            # the cross-pool flow: prefill-pool span -> decode resume
            for ph, pid, ts_ms, extra in (
                    ("s", prefill_pid, prefill_start["ts_ms"], {}),
                    ("f", dec_pid, first_decode["ts_ms"],
                     {"bp": "e"})):
                events.append({
                    "ph": ph, "id": tid, "name": "prefill->decode",
                    "cat": "fabric", "pid": pid, "tid": tid,
                    "ts": round(ts_ms * 1e3, 3), **extra,
                })
    return events


def fleet_trace_document(tracer, placement, *,
                         replicas: int | None = None) -> dict:
    """The fabric-wide Perfetto document (see
    :func:`fleet_trace_events`)."""
    return {"traceEvents": fleet_trace_events(tracer, placement,
                                              replicas=replicas),
            "displayTimeUnit": "ms",
            "otherData": {"producer": "flashmoe_tpu_torch.fabric"}}


def write_fleet_trace(tracer, placement, path: str, *,
                      replicas: int | None = None) -> dict:
    """Write the fleet trace (``validate_trace``-gated like every
    other exporter here)."""
    doc = fleet_trace_document(tracer, placement, replicas=replicas)
    errors = validate_trace(doc)
    if errors:
        raise ValueError(f"malformed fleet-trace export: {errors[:3]}")
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
