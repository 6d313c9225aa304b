"""Per-request critical-path attribution.

Counterpart of ``flashmoe_tpu/telemetry_plane/attribution.py``: a
retired request's track from the
:class:`~flashmoe_tpu_torch.telemetry_plane.tracing.RequestTracer`
decomposes into named components that sum to the track's extent:

* ``queue_wait``: arrival to first admission (``serve.queued``,
  ``resumed=False``), or ``router_spill`` when the request's
  ``fabric.route`` decision spilled off its preferred replica;
* ``eviction_gap``: every preemption hole (``serve.queued``,
  ``resumed=True``);
* ``prefill``: ``serve.prefill`` and ``serve.prefill_chunk``, less the
  handoff nested inside;
* ``handoff_dcn``: ``serve.handoff``;
* ``decode_steps``: the engine-step windows less the prefills nested in
  them.

:func:`attribute_track` decomposes one track (optionally clipped at the
first token, for a TTFT decomposition), :func:`attribute_tracer` every
retired request of a live tracer (``serve.attr.*_ms`` sketches and a
``serve.attribution`` decision each), :func:`attribution_report` a fleet
of exported records.
"""

from __future__ import annotations

#: attribution components, in render order
COMPONENTS = ("queue_wait", "router_spill", "eviction_gap", "prefill",
              "handoff_dcn", "decode_steps")

#: absolute slack (ms) forgiven by ``sum_ok`` on degenerate tiny tracks
_ABS_SLACK_MS = 0.05


def attribute_track(track, *, spilled: bool = False,
                    until_ms: float | None = None) -> dict:
    """Decompose one request's span track (timeline-ordered dicts with
    ``name``/``ts_ms``/``dur_ms``, e.g. ``RequestTracer.
    request_track``) into :data:`COMPONENTS`.

    ``until_ms`` clips every span at an absolute track time — pass
    ``track[0].ts_ms + ttft_ms`` to decompose TTFT instead of E2E.
    Returns components, their sum, the track's span extent, the
    relative error between the two, the 1%-gate verdict ``sum_ok``,
    and the ``dominant`` contributor."""
    queue_wait = evict_gap = steps = prefill_all = handoff = 0.0
    t_first: float | None = None
    t_last = 0.0
    for s in track:
        t0 = float(s["ts_ms"])
        t1 = t0 + float(s["dur_ms"])
        if until_ms is not None:
            t1 = min(t1, float(until_ms))
        d = max(0.0, t1 - t0)
        if d <= 0 and until_ms is not None and t0 >= until_ms:
            continue
        if t_first is None or t0 < t_first:
            t_first = t0
        t_last = max(t_last, t1)
        name = s["name"]
        if name == "serve.queued":
            if s.get("resumed"):
                evict_gap += d
            else:
                queue_wait += d
        elif name == "serve.step":
            steps += d
        elif name in ("serve.prefill", "serve.prefill_chunk"):
            prefill_all += d
        elif name == "serve.handoff":
            handoff += d
    components = {
        "queue_wait": 0.0 if spilled else queue_wait,
        "router_spill": queue_wait if spilled else 0.0,
        "eviction_gap": evict_gap,
        "prefill": max(prefill_all - handoff, 0.0),
        "handoff_dcn": handoff,
        "decode_steps": max(steps - prefill_all, 0.0),
    }
    total = sum(components.values())
    span_ms = (t_last - t_first) if t_first is not None else 0.0
    diff = abs(total - span_ms)
    rel_err = diff / span_ms if span_ms > 0 else 0.0
    dominant = (max(COMPONENTS, key=lambda k: components[k])
                if span_ms > 0 else None)
    return {
        "components": {k: round(v, 6) for k, v in components.items()},
        "total_ms": round(total, 6),
        "span_ms": round(span_ms, 6),
        "rel_err": round(rel_err, 6),
        "sum_ok": bool(diff <= max(0.01 * span_ms, _ABS_SLACK_MS)),
        "dominant": dominant,
    }


def spilled_rids(route_decisions) -> set:
    """Rids whose router placement spilled off the affinity-preferred
    replica — ``fabric.route`` decision dicts (live or JSONL form)."""
    out = set()
    for rec in route_decisions:
        if rec.get("policy") == "jsq_spill" and rec.get("rid") is not None:
            out.add(rec["rid"])
    return out


def attribute_tracer(tracer, *, spilled=(), metrics_obj=None,
                     ttft_ms=None) -> dict:
    """Attribute every RETIRED request of a live tracer.

    ``spilled``: rid set from :func:`spilled_rids`.  ``ttft_ms``:
    optional ``{rid: ttft_ms}`` — when given, each request also gets a
    TTFT decomposition (track clipped at first-token time).  With
    ``metrics_obj`` set, per-component totals feed ``serve.attr.
    <component>_ms`` sketches (the ``/metrics`` scrape view) and each
    request emits one ``serve.attribution`` decision naming its
    dominant contributor."""
    spilled = set(spilled)
    out: dict = {}
    for rid, st in sorted(tracer.requests.items()):
        if not st.retired:
            continue
        track = tracer.request_track(rid)
        att = attribute_track(track, spilled=rid in spilled)
        if ttft_ms and ttft_ms.get(rid) is not None and track:
            att["ttft"] = attribute_track(
                track, spilled=rid in spilled,
                until_ms=float(track[0]["ts_ms"]) + float(ttft_ms[rid]))
        out[rid] = att
        if metrics_obj is not None:
            for comp, v in att["components"].items():
                if v > 0:
                    metrics_obj.sketch(f"serve.attr.{comp}_ms", v)
            metrics_obj.decision(
                "serve.attribution", rid=rid, dominant=att["dominant"],
                span_ms=att["span_ms"], total_ms=att["total_ms"],
                rel_err=att["rel_err"], sum_ok=att["sum_ok"],
                **{k: v for k, v in att["components"].items() if v > 0})
    return out


def attribution_report(records) -> dict:
    """Fleet-wide attribution over exported JSONL records (``observe
    --attribution``): groups ``serve_trace_span`` records by rid
    (deduping shard overlap), pulls spill verdicts from ``fabric.
    route`` decisions, attributes each retired request, and rolls the
    components up fleet-wide."""
    tracks: dict = {}
    retired: dict = {}
    seen = set()
    routes = []
    for rec in records:
        kind = rec.get("kind")
        if kind == "serve_trace_span":
            key = (rec.get("rid"), rec.get("name"), rec.get("ts_ms"),
                   rec.get("dur_ms"), rec.get("step"))
            if key in seen:
                continue
            seen.add(key)
            tracks.setdefault(rec.get("rid"), []).append(rec)
            retired[rec.get("rid")] = (retired.get(rec.get("rid"), False)
                                       or bool(rec.get("retired")))
        elif rec.get("decision") == "fabric.route":
            routes.append(rec)
    spilled = spilled_rids(routes)
    per_request: dict = {}
    totals = {k: 0.0 for k in COMPONENTS}
    dominant_counts: dict = {}
    bad = []
    for rid in sorted(tracks, key=lambda r: (str(type(r)), str(r))):
        if not retired.get(rid):
            continue
        track = sorted(tracks[rid], key=lambda s: s["ts_ms"])
        att = attribute_track(track, spilled=rid in spilled)
        per_request[rid] = att
        for k, v in att["components"].items():
            totals[k] += v
        if att["dominant"] is not None:
            dominant_counts[att["dominant"]] = \
                dominant_counts.get(att["dominant"], 0) + 1
        if not att["sum_ok"]:
            bad.append(rid)
    grand = sum(totals.values())
    return {
        "requests": len(per_request),
        "spilled": sorted(spilled & set(per_request)),
        "totals_ms": {k: round(v, 3) for k, v in totals.items()},
        "shares": {k: round(v / grand, 4) if grand > 0 else 0.0
                   for k, v in totals.items()},
        "dominant_counts": dict(sorted(dominant_counts.items())),
        "sum_violations": bad,
        "per_request": per_request,
    }
