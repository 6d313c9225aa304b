"""Flight-recorder analysis CLI: turn JSONL telemetry dumps into the
reports a perf postmortem starts from.

Counterpart of ``flashmoe_tpu/observe.py``: the same reports, renderers
and modes, on the port's own planner drift report, quantile sketch,
attribution and postmortem bundles.  Input: any mix of JSONL files
produced by the port:

  * flight-recorder exports (``runtime.trainer.train(flight_path=...)``,
    records with ``step`` and optional per-layer ``moe`` stats),
  * telemetry decision logs (``Metrics.dump_decisions_jsonl``: planner
    path selections, ``planner.drift`` comparisons, the runtime
    controller's actions, the chaos drills' ``decisions.jsonl``),
  * metrics summaries (``Metrics.dump_jsonl``: phase timers).

Output: an expert-load imbalance report, the drop-rate timeline, the
tier-0 degradation timeline, the resilience report (every recovery rung
that fired), the adaptation report (the controller's actions with the
flight steps before and after each), a phase-time breakdown and the
planner drift report.  ``--json`` emits one machine-readable document.

Usage::

    python -m flashmoe_tpu_torch.observe flight.jsonl [decisions.jsonl ...]
    python -m flashmoe_tpu_torch.observe --json flight.jsonl
    python -m flashmoe_tpu_torch.observe --ledger ledger.jsonl
    python -m flashmoe_tpu_torch.observe --serving flight.jsonl decisions.jsonl
    python -m flashmoe_tpu_torch.observe --postmortem /path/to/bundles
    python -m flashmoe_tpu_torch.observe --trace 3 trace.jsonl
    python -m flashmoe_tpu_torch.observe --merge telemetry.*.jsonl
    python -m flashmoe_tpu_torch.observe --attribution trace.jsonl
    python -m flashmoe_tpu_torch.observe --regression --ci [obs/history_torch.jsonl]

``--regression`` runs the perf sentry
(:mod:`flashmoe_tpu_torch.telemetry_plane.regression`) over the port's
run history (default ``obs/history_torch.jsonl``; ``--ci`` exits rc 2 on
a tolerance breach).
"""

from __future__ import annotations

import argparse
import json
import sys


def load_jsonl(paths: list[str]) -> list[dict]:
    """All parseable JSON objects from the given files, in order.
    Unparseable lines (partial writes, comments) are skipped."""
    records: list[dict] = []
    for path in paths:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if isinstance(rec, dict):
                    records.append(rec)
    return records


def _layer_stats(rec: dict) -> list[dict]:
    """Per-layer MoE stat dicts of one flight record (either the
    trainer's ``moe`` list or a bare top-level stats record)."""
    if isinstance(rec.get("moe"), list):
        return [m for m in rec["moe"] if isinstance(m, dict)]
    if isinstance(rec.get("expert_load"), list):
        return [rec]
    return []


def imbalance_report(flight: list[dict]) -> dict:
    """Aggregate expert-load histogram across steps and layers."""
    load: list[float] = []
    imb = []
    ent = []
    for rec in flight:
        for m in _layer_stats(rec):
            el = m.get("expert_load") or []
            if len(load) < len(el):
                load.extend([0.0] * (len(el) - len(load)))
            for i, v in enumerate(el):
                load[i] += float(v)
            if "imbalance" in m:
                imb.append(float(m["imbalance"]))
            if "router_entropy" in m:
                ent.append(float(m["router_entropy"]))
    total = sum(load)
    mean = total / len(load) if load else 0.0
    return {
        "experts": len(load),
        "expert_load": [round(v, 1) for v in load],
        "total_assignments": round(total, 1),
        "imbalance": round(max(load) / mean, 4) if mean > 0 else None,
        "mean_step_imbalance": round(sum(imb) / len(imb), 4) if imb
        else None,
        "mean_router_entropy": round(sum(ent) / len(ent), 4) if ent
        else None,
    }


def drop_report(flight: list[dict]) -> dict:
    """Drop-rate / capacity-utilization timeline and aggregates."""
    timeline = []
    for rec in flight:
        stats = _layer_stats(rec)
        drops = [float(m["dropped_fraction"]) for m in stats
                 if "dropped_fraction" in m]
        utils = [float(m["capacity_utilization"]) for m in stats
                 if "capacity_utilization" in m]
        if drops:
            timeline.append({
                "step": rec.get("step"),
                "dropped_fraction": round(sum(drops) / len(drops), 6),
                "capacity_utilization": round(sum(utils) / len(utils), 6)
                if utils else None,
            })
    dr = [t["dropped_fraction"] for t in timeline]
    return {
        "steps": len(timeline),
        "mean_dropped_fraction": round(sum(dr) / len(dr), 6) if dr
        else None,
        "max_dropped_fraction": round(max(dr), 6) if dr else None,
        "timeline": timeline,
    }


def degradation_report(flight: list[dict]) -> dict:
    """Tier-0 fault-tolerance timeline: steps where
    the expert-health mask fired (``degrade_unhealthy_experts``), with
    masked-expert counts and masked assignment fractions."""
    timeline = []
    for rec in flight:
        stats = _layer_stats(rec)
        masked = [float(m["masked_experts"]) for m in stats
                  if m.get("masked_experts")]
        frac = [float(m["masked_fraction"]) for m in stats
                if "masked_fraction" in m]
        if masked:
            timeline.append({
                "step": rec.get("step"),
                "masked_experts": round(sum(masked), 2),
                "masked_fraction": round(sum(frac) / len(frac), 6)
                if frac else None,
            })
    return {
        "steps_with_masking": len(timeline),
        "max_masked_experts": max((t["masked_experts"] for t in timeline),
                                  default=0.0),
        "timeline": timeline,
    }


def wire_report(flight: list[dict]) -> dict:
    """Wire-compression health (ops/wire.py): the round-trip
    quantization-error proxy the EP layers attach to MoEStats when a
    ``wire_dtype`` is on.  Steps where the wire was active (error > 0),
    mean/max error — a rising error flags payload distributions the fp8
    wire no longer represents well."""
    errs = []
    dcn_errs = []
    for rec in flight:
        for m in _layer_stats(rec):
            e = m.get("wire_rtq_error")
            if isinstance(e, (int, float)) and e > 0:
                errs.append(float(e))
            e = m.get("wire_rtq_error_dcn")
            if isinstance(e, (int, float)) and e > 0:
                dcn_errs.append(float(e))
    return {
        "steps_with_wire": len(errs),
        "mean_rtq_error": round(sum(errs) / len(errs), 6) if errs
        else None,
        "max_rtq_error": round(max(errs), 6) if errs else None,
        # the cross-slice hop's own wire (wire_dtype_dcn), tracked
        # separately so an fp8 DCN hop's loss never hides in (or
        # inflates) the in-slice number
        "steps_with_dcn_wire": len(dcn_errs),
        "mean_dcn_rtq_error": (round(sum(dcn_errs) / len(dcn_errs), 6)
                               if dcn_errs else None),
        "max_dcn_rtq_error": round(max(dcn_errs), 6) if dcn_errs
        else None,
    }


def quant_report(flight: list[dict]) -> dict:
    """Quantized-expert-store health (flashmoe_tpu/quant/): the
    weight-space round-trip error proxy the layers attach to MoEStats
    when ``MoEConfig.expert_quant`` is on.  Non-zero on fake-quant runs
    (the real quantization loss); pre-quantized states report ~0 here —
    their baked loss lives in the checkpoint's quant metadata block."""
    errs = []
    for rec in flight:
        for m in _layer_stats(rec):
            e = m.get("quant_error")
            if isinstance(e, (int, float)) and e > 0:
                errs.append(float(e))
    return {
        "steps_with_quant": len(errs),
        "mean_quant_error": round(sum(errs) / len(errs), 6) if errs
        else None,
        "max_quant_error": round(max(errs), 6) if errs else None,
    }


def resilience_report(records: list[dict]) -> dict:
    """Fault-tolerance narrative from the decision stream
    how often each recovery rung fired, every
    drain with its remaining grace, and every supervised resume with
    the world it landed on — the loss-of-work story of the run."""
    by_name: dict[str, int] = {}
    drains = []
    resumes = []
    for rec in records:
        name = rec.get("decision")
        if not isinstance(name, str):
            continue
        by_name[name] = by_name.get(name, 0) + 1
        if name == "preempt.drain":
            drains.append({
                "step": rec.get("step"),
                "source": rec.get("source"),
                "remaining_grace_s": rec.get("remaining_grace_s"),
            })
        elif name == "supervisor.resume":
            resumes.append({
                "incarnation": rec.get("incarnation"),
                "step": rec.get("step"),
                "world": rec.get("world"),
                "ep": rec.get("ep"), "dp": rec.get("dp"),
            })
    interesting = ("trainer.grad_skip", "checkpoint.fallback",
                   "checkpoint.emergency_save", "checkpoint.async_error",
                   "planner.fallback", "preempt.notice", "preempt.drain",
                   "supervisor.resume", "slo.breach", "slo.recovered",
                   "postmortem.saved")
    return {
        "events": {k: by_name[k] for k in interesting if k in by_name},
        "drains": drains,
        "resumes": resumes,
        "worlds": sorted({r["world"] for r in resumes
                          if r.get("world") is not None}),
    }


def adaptation_report(records: list[dict]) -> dict:
    """The self-healing controller's story: every ``controller.*`` decision in
    timeline order, and — for each morph/re-placement — the mean MoE
    imbalance and dropped fraction over the flight-recorder steps
    BEFORE vs AFTER the action, so the report answers "did the repair
    actually repair" without replaying the run."""
    acts = [r for r in records
            if str(r.get("decision", "")).startswith("controller.")]
    flight = []
    for rec in records:
        ms = _layer_stats(rec)
        if ms and isinstance(rec.get("step"), (int, float)):
            flight.append((int(rec["step"]),
                           max(m.get("imbalance", 0.0) for m in ms),
                           max(m.get("dropped_fraction", 0.0)
                               for m in ms)))
    flight.sort()

    def window(step, after: bool, n: int = 5):
        rows = [(i, d) for s, i, d in flight
                if (s >= step if after else s < step)]
        rows = rows[:n] if after else rows[-n:]
        if not rows:
            return None
        return {"imbalance": round(sum(r[0] for r in rows)
                                   / len(rows), 3),
                "dropped_fraction": round(sum(r[1] for r in rows)
                                          / len(rows), 4)}

    timeline = []
    for a in acts:
        entry = {"decision": a.get("decision"), "step": a.get("step"),
                 "trigger": a.get("trigger")}
        if a["decision"] == "controller.morph":
            entry.update(backend=a.get("backend"),
                         dropless=a.get("dropless"),
                         overrides=a.get("overrides"),
                         reason=a.get("reason"))
        elif a["decision"] == "controller.replace":
            entry.update(replicas=a.get("replicas"),
                         rates=a.get("rates"),
                         device_share_before=a.get(
                             "device_share_before"))
        elif a["decision"] == "controller.demotion_reset":
            entry.update(dropped=a.get("dropped"),
                         world=a.get("world"))
        if a["decision"] in ("controller.morph", "controller.replace") \
                and isinstance(a.get("step"), (int, float)):
            entry["before"] = window(int(a["step"]), after=False)
            entry["after"] = window(int(a["step"]), after=True)
        timeline.append(entry)
    counts: dict[str, int] = {}
    for a in acts:
        counts[a["decision"]] = counts.get(a["decision"], 0) + 1
    return {"actions": counts, "timeline": timeline}


def phase_report(records: list[dict]) -> dict:
    """Mean of every ``*_ms`` field across records (flight ``step_ms``,
    bench leg timings) plus ``*_ms_p50`` phase timers from metrics
    summaries — the comm/compute phase breakdown."""
    sums: dict[str, float] = {}
    counts: dict[str, int] = {}
    # prediction fields are drift inputs, not phases — keep them out
    skip = {"predicted_ms", "xla_predicted_ms", "measured_ms"}
    for rec in records:
        for k, v in rec.items():
            if not isinstance(v, (int, float)) or isinstance(v, bool):
                continue
            if k in skip:
                continue
            if k.endswith("_ms") or k.endswith("_ms_p50"):
                sums[k] = sums.get(k, 0.0) + float(v)
                counts[k] = counts.get(k, 0) + 1
    return {k: round(sums[k] / counts[k], 4) for k in sorted(sums)}


def summarize(records: list[dict]) -> dict:
    """The full analysis document over a mixed record pile."""
    from flashmoe_tpu_torch.planner.drift import drift_report

    flight = [r for r in records if _layer_stats(r) or "step" in r]
    return {
        "records": len(records),
        "flight_steps": len(flight),
        "imbalance": imbalance_report(flight),
        "drops": drop_report(flight),
        "degradation": degradation_report(flight),
        "wire": wire_report(flight),
        "quant": quant_report(flight),
        "resilience": resilience_report(records),
        "adaptation": adaptation_report(records),
        "phases": phase_report(records),
        "drift": drift_report(records),
        "decisions": sorted({r["decision"] for r in records
                             if isinstance(r.get("decision"), str)}),
    }


def ledger_report(records: list[dict]) -> dict:
    """The cost-ledger view: per-(path, chunks, wire) per-phase
    measured-vs-predicted drift, from ``ledger.jsonl`` rows
    (:mod:`flashmoe_tpu_torch.profiler.ledger` rows) and/or
    ``planner.phase_drift`` decision records — the per-phase answer to
    "which term of the cost model is lying".  Overlap cross-check rows
    (``record == "overlap"``) are summarized separately."""
    points: dict[tuple, dict] = {}
    overlaps = []
    for rec in records:
        if rec.get("record") == "overlap" or (
                "measured_fraction" in rec and "chunks" in rec):
            overlaps.append({
                "path": rec.get("point") or rec.get("path"),
                "d": rec.get("d"),
                "chunks": rec.get("chunks"), "wire": rec.get("wire"),
                "measured_fraction": rec.get("measured_fraction"),
                "predicted_fraction": rec.get("predicted_fraction"),
                "exceeded": rec.get("exceeded"),
            })
            continue
        phase = rec.get("phase")
        if not isinstance(phase, str) or "measured_ms" not in rec:
            continue
        # ledger.jsonl rows carry both the matrix point name ("flat")
        # and the planner path ("collective"); group/display by the
        # point name when present (decision records only have the path)
        key = (rec.get("point") or rec.get("path"),
               rec.get("chunks", 1), rec.get("wire", "off"))
        pt = points.setdefault(key, {
            "point": key[0], "path": rec.get("path"),
            "chunks": key[1], "wire": key[2], "phases": {}})
        pt["phases"][phase] = {
            "measured_ms": rec.get("measured_ms"),
            "predicted_ms": rec.get("predicted_ms"),
            "rel_error": rec.get("rel_error"),
            "exceeded": bool(rec.get("exceeded")),
        }
    phase_names = sorted({ph for pt in points.values()
                          for ph in pt["phases"]})
    n = sum(len(pt["phases"]) for pt in points.values())
    return {
        "n": n,
        "points": [points[k] for k in sorted(
            points, key=lambda k: (str(k[0]), k[1], str(k[2])))],
        "phases": phase_names,
        "exceeded": sum(1 for pt in points.values()
                        for p in pt["phases"].values() if p["exceeded"]),
        "overlap": overlaps,
    }


def render_ledger_text(led: dict) -> str:
    if not led["n"] and not led["overlap"]:
        return "no phase-ledger rows found (run " \
               "profiler.ledger.run_ledger_matrix first)"
    lines = []
    if led["n"]:
        lines += [f"cost ledger: {led['n']} phase comparisons over "
                  f"{len(led['points'])} config points, "
                  f"{led['exceeded']} over the drift threshold", ""]
        head = f"{'point':<34s}" + "".join(
            f"{ph.removeprefix('moe.'):>16s}" for ph in led["phases"])
        lines.append(head + "   (rel err, measured/predicted - 1)")
        for pt in led["points"]:
            label = (f"{pt.get('point') or pt['path']} "
                     f"c={pt['chunks']} wire={pt['wire']}")
            cells = []
            for ph in led["phases"]:
                p = pt["phases"].get(ph)
                if p is None:
                    cells.append(f"{'-':>16s}")
                else:
                    mark = "**" if p["exceeded"] else "  "
                    cells.append(f"{p['rel_error']:>+13.1%}{mark} ")
            lines.append(f"{label:<34s}" + "".join(cells))
    if led["overlap"]:
        lines.append("")
        lines.append("overlap cross-check (fenced serial phase sum / "
                     "jitted step):")
        for o in led["overlap"]:
            lines.append(
                f"  {o['path']} d={o['d']} chunks={o['chunks']} "
                f"wire={o['wire']}: measured {o['measured_fraction']} "
                f"vs bound {o['predicted_fraction']}"
                f"{'  ** DRIFTING' if o['exceeded'] else ''}")
    return "\n".join(lines)


def serving_report(records: list[dict]) -> dict:
    """The serving engine's story (``--serving``): per-step
    ``serve_step`` flight records (queue depth, active requests, cache
    occupancy, tokens emitted), per-request TTFT/TPOT from
    ``serve_request`` records / ``serve.retire`` decisions, the
    admission/eviction narrative, the decode-vs-prefill planner split
    (``serve.plan``), and serving SLO breaches (``slo.breach`` with
    target ttft/tpot).

    Percentiles run through the shared bounded-memory quantile sketch
    (telemetry_plane/sketch.py) — the same definition the engine's live
    ``/metrics`` summaries use, nearest-rank exact below 64
    observations (= ``loadgen.pctl`` on every CI-sized drill) and
    O(1)-memory P² beyond, so a million-request dump aggregates in
    constant space instead of retaining full history."""
    from flashmoe_tpu_torch.telemetry_plane.sketch import QuantileSketch

    steps = n_steps = 0
    tokens = 0
    wall_ms = 0.0
    tt, tp = QuantileSketch(), QuantileSketch()
    qd, occ, act = QuantileSketch(), QuantileSketch(), QuantileSketch()
    rids: set = set()
    seen_req_recs = False
    plan = None
    quant = None
    pools = None
    route_counts: dict = {}
    route_policies: dict = {}
    route_draining: list = []
    ho_n = 0
    ho_kb = 0.0
    ho_ms = 0.0
    ho_overlapped = ho_verdicts = 0
    ho_wire = None
    admissions = evictions = slo_ttft = slo_tpot = 0
    migrations: list = []
    crashes: list = []
    retries: list = []
    corrupts = 0
    sheds: dict = {}
    brownouts: dict = {}
    failovers: list = []
    partitions: list = []
    fences: list = []
    repairs: list = []
    stalls: list = []
    hb_misses = 0
    for r in records:
        kind, dec = r.get("kind"), r.get("decision")
        if kind == "serve_step":
            n_steps += 1
            tokens += int(r.get("tokens", 0))
            wall_ms += float(r.get("step_ms", 0.0))
            if isinstance(r.get("queue_depth"), (int, float)):
                qd.observe(r["queue_depth"])
            if isinstance(r.get("cache_occupancy"), (int, float)):
                occ.observe(r["cache_occupancy"])
            if isinstance(r.get("active"), (int, float)):
                act.observe(r["active"])
        elif kind == "serve_request" or (dec == "serve.retire"
                                         and not seen_req_recs):
            # serve_request flight records win; retire decisions are
            # the fallback when no flight dump is present (same values)
            if kind == "serve_request" and not seen_req_recs:
                seen_req_recs = True
                tt, tp = QuantileSketch(), QuantileSketch()
                rids = set()
            rids.add(r.get("rid"))
            if isinstance(r.get("ttft_ms"), (int, float)):
                tt.observe(r["ttft_ms"])
            if isinstance(r.get("tpot_ms"), (int, float)):
                tp.observe(r["tpot_ms"])
        if dec == "serve.plan":
            plan = r
        elif dec == "serve.quant":
            quant = r
        elif dec == "serve.pools":
            pools = r
        elif dec == "fabric.route":
            rep_id = r.get("replica")
            route_counts[rep_id] = route_counts.get(rep_id, 0) + 1
            pol = r.get("policy")
            route_policies[pol] = route_policies.get(pol, 0) + 1
            route_draining = r.get("draining") or []
        elif dec == "fabric.handoff":
            ho_n += 1
            ho_kb += float(r.get("payload_kb", 0.0))
            ho_ms += float(r.get("modeled_dcn_ms", 0.0))
            if r.get("overlapped") is not None:
                ho_verdicts += 1
                ho_overlapped += int(bool(r.get("overlapped")))
            ho_wire = r.get("wire", ho_wire)
        elif dec == "serve.admit":
            admissions += 1
        elif dec == "serve.evict":
            evictions += 1
        elif dec == "fabric.migrate":
            migrations.append(r)
        elif dec == "fabric.replica_crash":
            crashes.append(r)
        elif dec == "fabric.handoff_retry":
            retries.append(r)
        elif dec == "fabric.handoff_corrupt":
            corrupts += 1
        elif dec == "frontdoor.shed":
            mode = str(r.get("mode") or "reject")
            sheds[mode] = sheds.get(mode, 0) + 1
        elif dec == "frontdoor.brownout":
            st = str(r.get("state") or "?")
            brownouts[st] = brownouts.get(st, 0) + 1
        elif dec == "frontdoor.failover":
            failovers.append(r)
        elif dec == "fabric.partition":
            partitions.append(r)
        elif dec == "frontdoor.fence":
            fences.append(r)
        elif dec == "frontdoor.lease_repair":
            repairs.append(r)
        elif dec == "fabric.heartbeat_stall":
            stalls.append(r)
        elif dec == "fabric.heartbeat_miss":
            hb_misses += 1
        elif dec == "slo.breach":
            if r.get("target") == "ttft":
                slo_ttft += 1
            elif r.get("target") == "tpot":
                slo_tpot += 1
    steps = n_steps

    def rnd(v, nd=3):
        return round(v, nd) if v is not None else None

    slo = slo_ttft or slo_tpot
    return {
        "steps": steps,
        "requests_completed": len(rids),
        "tokens": tokens,
        "tokens_per_sec": round(tokens / (wall_ms / 1e3), 1)
        if wall_ms > 0 else None,
        "ttft_ms": {"mean": rnd(tt.mean), "p50": rnd(tt.quantile(0.5)),
                    "p99": rnd(tt.quantile(0.99)),
                    "max": rnd(tt.max)} if tt.n else None,
        "tpot_ms": {"mean": rnd(tp.mean),
                    "p50": rnd(tp.quantile(0.5))} if tp.n else None,
        "queue_depth": {"mean": rnd(qd.mean, 2),
                        "max": int(qd.max)} if qd.n else None,
        "active": {"mean": rnd(act.mean, 2),
                   "max": int(act.max)} if act.n else None,
        "cache_occupancy": {"mean": rnd(occ.mean, 4),
                            "peak": rnd(occ.max, 4)} if occ.n else None,
        "admissions": admissions,
        "evictions": evictions,
        "plan": ({"prefill": [plan.get("prefill_backend"),
                              plan.get("prefill_chunks")],
                  "decode": [plan.get("decode_backend"),
                             plan.get("decode_chunks")],
                  "heterogeneous": plan.get("heterogeneous")}
                 if plan else None),
        "slo_breaches": {"ttft": slo_ttft, "tpot": slo_tpot}
        if slo else None,
        # quantized expert storage: the HBM the narrow store freed,
        # expressed as the extra KV-cache pages that headroom buys on
        # this engine's page size (serve.quant decision)
        "quant": ({"expert_quant": quant.get("expert_quant"),
                   "freed_mb": quant.get("freed_mb"),
                   "extra_kv_pages": quant.get("extra_kv_pages"),
                   "num_pages": quant.get("num_pages")}
                  if quant else None),
        # disaggregated fabric: the Decider's prefill/decode pool split
        # (serve.pools), where the router placed requests
        # (fabric.route) and what the KV handoff link moved
        # (fabric.handoff)
        "pools": ({"prefill_devices": pools.get("prefill_devices"),
                   "decode_devices": pools.get("decode_devices"),
                   "prefill_ms": pools.get("prefill_ms"),
                   "decode_ms": pools.get("decode_ms"),
                   "prefill_mapping": pools.get("prefill_mapping"),
                   "decode_mapping": pools.get("decode_mapping"),
                   "decode_quant": pools.get("decode_quant"),
                   "kv_wire": pools.get("kv_wire")}
                  if pools else None),
        "fabric_route": ({
            "placements": {str(k): v for k, v
                           in sorted(route_counts.items())},
            "policies": dict(sorted(route_policies.items())),
            "draining": route_draining,
        } if route_counts else None),
        "fabric_handoff": ({
            "count": ho_n,
            "payload_kb": round(ho_kb, 3),
            "modeled_dcn_ms": round(ho_ms, 6),
            "overlapped_frac": (round(ho_overlapped / ho_verdicts, 3)
                                if ho_verdicts else None),
            "wire": ho_wire,
        } if ho_n else None),
        # the serving failure story: crash timeline,
        # migrations, retried handoffs, brownout shedding, front-door
        # failovers, wire partitions, lease fencing/repair and
        # heartbeat stalls — the section an incident review reads first
        "fabric_failures": _fabric_failures(
            crashes, migrations, retries, corrupts, sheds, brownouts,
            failovers, partitions, fences, repairs, stalls, hb_misses),
        # speculative decoding: acceptance economics and
        # controller spec-morphs, aggregated from the same records by
        # the flight-recorder consumer twin of the engine's counters
        "speculation": _speculation_section(records),
    }


def _speculation_section(records):
    """The ``--serving`` speculation section (None when the run never
    drafted and never morphed — a non-speculative dump stays
    byte-identical)."""
    from flashmoe_tpu_torch.ops.stats import speculation_summary

    s = speculation_summary(records)
    if not (s["spec_drafted"] or s["steps_spec_on"]
            or s["spec_morphs"]):
        return None
    return s


def _fabric_failures(crashes, migrations, retries, corrupts, sheds,
                     brownouts, failovers, partitions=(), fences=(),
                     repairs=(), stalls=(), hb_misses=0):
    """Aggregate the serving fault-tolerance decisions into the
    ``--serving`` report's failure section (None when the run saw no
    failure activity — the common case stays quiet)."""
    if not (crashes or migrations or retries or corrupts
            or sheds or brownouts or failovers or partitions
            or fences or repairs or stalls or hb_misses):
        return None

    def hist(values):
        out: dict = {}
        for v in values:
            out[str(v)] = out.get(str(v), 0) + 1
        return dict(sorted(out.items()))

    mig_paths = hist(f"r{m.get('from_replica')}->r{m.get('to_replica')}"
                     for m in migrations)
    return {
        "crashes": [{"replica": c.get("replica"),
                     "step": c.get("step"),
                     "in_flight": c.get("in_flight"),
                     "queued": c.get("queued")} for c in crashes],
        "migrations": {
            "total": len(migrations),
            "resumed_mid_decode": sum(bool(m.get("resumed"))
                                      for m in migrations),
            "paths": mig_paths,
        },
        "handoff_retries": {
            "total": len(retries),
            "reasons": hist(r.get("reason") for r in retries),
            "wasted_ms": round(sum(float(r.get("wasted_ms", 0.0))
                                   for r in retries), 3),
            "backoff_ms_hist": hist(r.get("backoff_ms")
                                    for r in retries),
        },
        "corrupt_transfers": corrupts,
        "shed": dict(sorted(sheds.items())),
        "brownout_transitions": dict(sorted(brownouts.items())),
        "failovers": {
            "total": len(failovers),
            "max_epoch": max((int(f.get("epoch", 0))
                              for f in failovers), default=0),
            "paths": hist(f"p{f.get('from_peer')}->p{f.get('to_peer')}"
                          for f in failovers),
        },
        # the cross-process arms: socket-wire partition
        # windows, the lease store's refused stale-epoch writes (the
        # split-brain verdict) and torn-tail repairs, and the
        # sub-step heartbeat detections
        "partitions": ({
            "total": len(partitions),
            "injected": sum(bool(p.get("injected")) for p in partitions),
            "real_resets": sum(not p.get("injected")
                               for p in partitions),
            "dropped_kb": round(sum(float(p.get("dropped_bytes") or 0)
                                    for p in partitions) / 1024, 3),
            "windows": hist(f"t{p.get('transfer')}"
                            for p in partitions),
        } if partitions else None),
        "lease_fences": ({
            "total": len(fences),
            "refused": sum(bool(f.get("refused")) for f in fences),
            "split_brain_averted": all(f.get("refused")
                                       for f in fences),
            "stale_epochs": hist(f.get("stale_epoch") for f in fences),
            "claimants": hist(f"p{f.get('claimant')}" for f in fences),
        } if fences else None),
        "lease_repairs": ({
            "total": len(repairs),
            "torn_bytes": sum(int(r.get("torn_bytes") or 0)
                              for r in repairs),
            "restored_epochs": hist(r.get("restored_epoch")
                                    for r in repairs),
        } if repairs else None),
        "heartbeat": ({
            "stalls": [{"replica": s.get("replica"),
                        "step": s.get("step"),
                        "detect_ms": s.get("detect_ms")}
                       for s in stalls],
            "misses": hb_misses,
        } if (stalls or hb_misses) else None),
    }


def render_serving_text(rep: dict) -> str:
    if not rep["steps"] and not rep["requests_completed"]:
        return ("no serving records found (run `python -m "
                "flashmoe_tpu_torch.serving --obs-dir ...` or the engine "
                "with a recorder first)")
    lines = [f"serving: {rep['requests_completed']} requests over "
             f"{rep['steps']} engine steps, {rep['tokens']} tokens"
             + (f" ({rep['tokens_per_sec']} tok/s)"
                if rep.get("tokens_per_sec") else "")]
    if rep.get("ttft_ms"):
        t = rep["ttft_ms"]
        lines.append(f"  TTFT ms: mean {t['mean']}  p50 {t['p50']}  "
                     f"p99 {t['p99']}  max {t['max']}")
    if rep.get("tpot_ms"):
        t = rep["tpot_ms"]
        lines.append(f"  TPOT ms: mean {t['mean']}  p50 {t['p50']}")
    if rep.get("queue_depth"):
        lines.append(f"  queue depth: mean {rep['queue_depth']['mean']}"
                     f"  max {rep['queue_depth']['max']}"
                     + (f"   active: mean {rep['active']['mean']} max "
                        f"{rep['active']['max']}" if rep.get("active")
                        else ""))
    if rep.get("cache_occupancy"):
        o = rep["cache_occupancy"]
        lines.append(f"  cache occupancy: mean {o['mean']}  peak "
                     f"{o['peak']}")
    lines.append(f"  admissions {rep['admissions']}  evictions "
                 f"{rep['evictions']}")
    plan = rep.get("plan")
    if plan:
        lines.append(
            f"  planner split: prefill {plan['prefill'][0]}"
            f"(c{plan['prefill'][1]}) vs decode {plan['decode'][0]}"
            f"(c{plan['decode'][1]})"
            + ("  [heterogeneous]" if plan.get("heterogeneous")
               else "  [same plan]"))
    if rep.get("quant"):
        q = rep["quant"]
        lines.append(
            f"  quantized experts: {q['expert_quant']} freed "
            f"{q['freed_mb']} MB of weight HBM = +{q['extra_kv_pages']} "
            f"KV pages of headroom (pool {q['num_pages']})")
    if rep.get("pools"):
        p = rep["pools"]
        det = ""
        if p.get("prefill_mapping"):
            det = (f"  [{p['prefill_mapping']} vs {p['decode_mapping']}"
                   + (f", decode quant {p['decode_quant']}"
                      if p.get("decode_quant") else "")
                   + (f", kv wire {p['kv_wire']}"
                      if p.get("kv_wire") else "") + "]")
        lines.append(
            f"  pools: prefill {len(p['prefill_devices'] or [])} dev "
            f"({p['prefill_ms']} ms) / decode "
            f"{len(p['decode_devices'] or [])} dev ({p['decode_ms']} ms)"
            + det)
    if rep.get("fabric_route"):
        fr = rep["fabric_route"]
        plc = " ".join(f"r{k}:{v}" for k, v in fr["placements"].items())
        pol = " ".join(f"{k}={v}" for k, v in fr["policies"].items())
        lines.append(f"  fabric router: {plc}  ({pol})"
                     + (f"  draining={fr['draining']}"
                        if fr.get("draining") else ""))
    if rep.get("fabric_handoff"):
        h = rep["fabric_handoff"]
        lines.append(
            f"  kv handoff: {h['count']} transfers, "
            f"{h['payload_kb']} KB, modeled DCN {h['modeled_dcn_ms']} ms"
            + (f", {h['overlapped_frac'] * 100:.0f}% hidden under "
               f"decode" if h.get("overlapped_frac") is not None
               else "")
            + (f"  [wire {h['wire']}]"
               if h.get("wire") not in (None, "off") else ""))
    if rep.get("slo_breaches"):
        b = rep["slo_breaches"]
        lines.append(f"  SLO breaches: ttft={b['ttft']} "
                     f"tpot={b['tpot']}")
    sp = rep.get("speculation")
    if sp:
        lines.append(
            f"  speculation: {sp['spec_accepted']}/{sp['spec_drafted']}"
            f" drafts accepted ({sp['accept_rate']:.1%}), "
            f"{sp['spec_tokens_per_step']:.2f} tokens/verify-step over "
            f"{sp['spec_steps']} verify steps"
            + (f"  [{sp['spec_morphs']} spec morph(s) — controller "
               f"switched speculation off]" if sp["spec_morphs"]
               else ""))
    ff = rep.get("fabric_failures")
    if ff:
        lines.append("  -- failures --")
        for c in ff["crashes"]:
            lines.append(
                f"  replica crash: r{c['replica']} at step {c['step']} "
                f"({c['in_flight']} in flight, {c['queued']} queued)")
        mg = ff["migrations"]
        if mg["total"]:
            paths = " ".join(f"{k}:{v}" for k, v
                             in mg["paths"].items())
            lines.append(
                f"  migrations: {mg['total']} "
                f"({mg['resumed_mid_decode']} resumed mid-decode)  "
                f"{paths}")
        hr = ff["handoff_retries"]
        if hr["total"]:
            reasons = " ".join(f"{k}={v}" for k, v
                               in hr["reasons"].items())
            backoff = " ".join(f"{k}ms:{v}" for k, v
                               in hr["backoff_ms_hist"].items())
            lines.append(
                f"  handoff retries: {hr['total']} ({reasons}), wasted "
                f"{hr['wasted_ms']} ms on the wire, backoff {backoff}")
        if ff.get("corrupt_transfers"):
            lines.append(f"  corrupt transfers: "
                         f"{ff['corrupt_transfers']} (CRC named the "
                         f"pages; all re-sent)")
        if ff.get("shed"):
            shed = " ".join(f"{k}={v}" for k, v in ff["shed"].items())
            lines.append(f"  brownout shed admissions: {shed}")
        if ff.get("brownout_transitions"):
            tr = " ".join(f"{k}={v}" for k, v
                          in ff["brownout_transitions"].items())
            lines.append(f"  brownout transitions: {tr}")
        fo = ff["failovers"]
        if fo["total"]:
            paths = " ".join(f"{k}:{v}" for k, v
                             in fo["paths"].items())
            lines.append(
                f"  front-door failovers: {fo['total']} leases moved "
                f"(max epoch {fo['max_epoch']})  {paths}")
        if ff.get("partitions"):
            pt = ff["partitions"]
            wins = " ".join(f"{k}:{v}" for k, v
                            in pt["windows"].items())
            lines.append(
                f"  wire partitions: {pt['total']} "
                f"({pt['injected']} injected, {pt['real_resets']} real "
                f"resets), {pt['dropped_kb']} KB torn mid-stream  "
                f"{wins}")
        if ff.get("lease_fences"):
            lf = ff["lease_fences"]
            who = " ".join(f"{k}:{v}" for k, v
                           in lf["claimants"].items())
            verdict = ("split brain AVERTED"
                       if lf["split_brain_averted"]
                       else "SPLIT BRAIN: a stale write was accepted")
            lines.append(
                f"  lease fences: {lf['refused']}/{lf['total']} "
                f"stale-epoch writes refused ({verdict})  {who}")
        if ff.get("lease_repairs"):
            lr = ff["lease_repairs"]
            eps = " ".join(f"e{k}:{v}" for k, v
                           in lr["restored_epochs"].items())
            lines.append(
                f"  lease repairs: {lr['total']} torn tails rolled "
                f"back ({lr['torn_bytes']} bytes refused)  "
                f"restored {eps}")
        if ff.get("heartbeat"):
            hb = ff["heartbeat"]
            for s in hb["stalls"]:
                lines.append(
                    f"  heartbeat stall: r{s['replica']} declared at "
                    f"step {s['step']} (detected in "
                    f"{s['detect_ms']} virtual ms)")
            if hb["misses"]:
                lines.append(f"  heartbeat misses observed: "
                             f"{hb['misses']}")
    return "\n".join(lines)


def trace_report(records: list[dict], rid: int) -> dict:
    """One request's end-to-end timeline (``--trace <rid>``) from the
    tracer's ``serve_trace_span`` JSONL records: every lifecycle span
    in timeline order, eviction gaps flagged, and the totals a latency
    investigation starts from (queue wait vs prefill vs decode-window
    time)."""
    raw = [r for r in records if r.get("kind") == "serve_trace_span"
           and r.get("rid") == rid]
    # merged fleet shards record the SAME span in more than one file
    # (the prefill pool and the decode pool both witness a handoff):
    # identical (name, ts, dur, step) rows collapse to one so the
    # timeline reads contiguous, not twice as long
    spans, seen = [], set()
    for s in raw:
        key = (s.get("name"), s.get("ts_ms"), s.get("dur_ms"),
               s.get("step"), s.get("resumed"))
        if key in seen:
            continue
        seen.add(key)
        spans.append(s)
    spans.sort(key=lambda s: s.get("ts_ms", 0.0))
    known = sorted({r.get("rid") for r in records
                    if r.get("kind") == "serve_trace_span"})
    by_phase: dict[str, float] = {}
    for s in spans:
        if s.get("name") != "serve.step":   # windows overlap the rest
            by_phase[s["name"]] = by_phase.get(s["name"], 0.0) \
                + float(s.get("dur_ms", 0.0))
    gaps = [s for s in spans if s.get("name") == "serve.queued"
            and s.get("resumed")]
    return {
        "rid": rid,
        "found": bool(spans),
        "spans_deduped": len(raw) - len(spans),
        "known_rids": known,
        "trace_id": spans[0].get("trace_id") if spans else None,
        "spans": spans,
        "evictions": int(spans[0].get("evictions", 0)) if spans else 0,
        "eviction_gap_ms": round(sum(float(s.get("dur_ms", 0.0))
                                     for s in gaps), 3),
        "phase_ms": {k: round(v, 3) for k, v in sorted(by_phase.items())},
        # max END over all spans: the last-STARTING span may end before
        # an earlier step window does
        "total_ms": round(max(s["ts_ms"] + s["dur_ms"] for s in spans)
                          - spans[0]["ts_ms"], 3) if spans else None,
    }


def render_trace_text(rep: dict) -> str:
    if not rep["found"]:
        known = ", ".join(str(r) for r in rep["known_rids"]) or "none"
        return (f"no trace spans for request {rep['rid']} (traced "
                f"requests: {known}) — run the drill with tracing on "
                f"(`python -m flashmoe_tpu_torch.serving --trace ...`)")
    lines = [f"request {rep['rid']} trace {rep['trace_id']}: "
             f"{len(rep['spans'])} spans, {rep['total_ms']} ms end to "
             f"end, {rep['evictions']} eviction(s)"
             + (f" ({rep['eviction_gap_ms']} ms re-queued)"
                if rep["evictions"] else "")
             + (f" [{rep['spans_deduped']} shard-duplicate span(s) "
                f"collapsed]" if rep.get("spans_deduped") else "")]
    for k, v in rep["phase_ms"].items():
        lines.append(f"  {k:<24s} {v:>10.3f} ms total")
    lines.append("  timeline:")
    t0 = rep["spans"][0]["ts_ms"]
    for s in rep["spans"]:
        mark = " <- eviction gap" if (s["name"] == "serve.queued"
                                      and s.get("resumed")) else ""
        lines.append(
            f"    +{s['ts_ms'] - t0:>10.3f} ms  {s['name']:<16s} "
            f"{s['dur_ms']:>10.3f} ms  step={s.get('step')}{mark}")
    return "\n".join(lines)


def merge_report(paths: list[str]) -> dict:
    """Fleet view over per-host telemetry shards (``--merge``): each
    input file is one host's JSONL dump (``telemetry.<host>.jsonl`` —
    telemetry_plane/server.py:host_shard_path, or any flight/decision
    file); records are tagged with their host, counted per host, and
    the union is summarized once — the mocked multi-slice drills
    read as one job instead of n disjoint dumps."""
    import os as _os

    hosts: dict[str, dict] = {}
    merged: list[dict] = []
    for path in paths:
        base = _os.path.basename(path)
        host = base
        if base.startswith("telemetry.") and base.endswith(".jsonl"):
            host = base[len("telemetry."):-len(".jsonl")]
        recs = load_jsonl([path])
        info = hosts.setdefault(host, {"records": 0, "files": []})
        info["records"] += len(recs)
        info["files"].append(base)
        steps = [r.get("step") for r in recs
                 if isinstance(r.get("step"), (int, float))]
        if steps:
            info["steps"] = [int(min(steps)), int(max(steps))]
        for r in recs:
            merged.append(dict(r, host=host))
    # a KV handoff is witnessed by BOTH pools (the prefill side prices
    # it, the decode side admits its pages): when the shards come from
    # the two pools the same transfer shows up twice — collapse on the
    # transfer's identity so fleet counts read per-transfer, not
    # per-witness
    deduped, seen, dropped = [], set(), 0
    for r in merged:
        if r.get("decision") == "fabric.handoff":
            key = (r.get("rid"), r.get("replica"), r.get("pages"),
                   r.get("modeled_dcn_ms"))
            if key in seen:
                dropped += 1
                continue
            seen.add(key)
        deduped.append(r)
    return {
        "hosts": hosts,
        "records": len(deduped),
        "handoffs_deduped": dropped,
        "fleet": summarize(deduped),
    }


def render_merge_text(rep: dict) -> str:
    lines = [f"fleet view: {len(rep['hosts'])} host shard(s), "
             f"{rep['records']} records"
             + (f" ({rep['handoffs_deduped']} double-witnessed "
                f"handoff(s) collapsed)"
                if rep.get("handoffs_deduped") else "")]
    for host in sorted(rep["hosts"]):
        info = rep["hosts"][host]
        steps = info.get("steps")
        lines.append(f"  {host}: {info['records']} records"
                     + (f", steps {steps[0]}..{steps[1]}" if steps
                        else ""))
    lines.append("")
    lines.append(render_text(rep["fleet"]))
    return "\n".join(lines)


def render_attribution_text(rep: dict) -> str:
    """``--attribution``: the fleet's latency budget with names on it
    (:func:`flashmoe_tpu_torch.telemetry_plane.attribution.
    attribution_report`)."""
    lines = [f"latency attribution: {rep['requests']} retired "
             f"request(s)"
             + (f", {len(rep['spilled'])} spilled off their preferred "
                f"replica" if rep["spilled"] else "")]
    if rep["sum_violations"]:
        lines.append(f"  ** {len(rep['sum_violations'])} request(s) "
                     f"FAILED the 1% sum gate: "
                     f"{rep['sum_violations'][:8]}")
    lines.append("  fleet totals (where the milliseconds went):")
    for comp, ms in rep["totals_ms"].items():
        share = rep["shares"].get(comp, 0.0)
        dom = rep["dominant_counts"].get(comp, 0)
        lines.append(
            f"    {comp:<14s} {ms:>10.3f} ms  {share:>6.1%}"
            + (f"  dominant in {dom}" if dom else ""))
    lines.append("  per request:")
    for rid, att in rep["per_request"].items():
        lines.append(
            f"    rid={rid:<6} span {att['span_ms']:>10.3f} ms  "
            f"dominant={att['dominant']}"
            + ("" if att["sum_ok"]
               else f"  ** sum off by {att['rel_err']:.1%}"))
    return "\n".join(lines)


def postmortem_report(bundle: dict) -> dict:
    """Triage view of one loaded postmortem bundle
    (:func:`flashmoe_tpu_torch.profiler.postmortem.load_bundle`)."""
    man = bundle.get("manifest") or {}
    decisions = bundle.get("decisions") or []
    by_name: dict[str, int] = {}
    for d in decisions:
        name = d.get("decision")
        if isinstance(name, str):
            by_name[name] = by_name.get(name, 0) + 1
    tb = bundle.get("traceback") or ""
    cfg = bundle.get("config") or {}
    env = bundle.get("env") or {}
    planner = bundle.get("planner") or {}
    flight = bundle.get("flight") or []
    losses = [r.get("loss") for r in flight
              if isinstance(r.get("loss"), (int, float))]
    return {
        "path": bundle.get("path"),
        "error": man.get("error"),
        "step": man.get("step"),
        "files": man.get("files", []),
        "traceback_tail": tb.strip().splitlines()[-12:],
        "decision_counts": by_name,
        "last_decisions": decisions[-8:],
        "flight_records": len(flight),
        "last_losses": [round(v, 4) for v in losses[-5:]],
        "config": {k: cfg[k] for k in (
            "num_experts", "expert_top_k", "hidden_size",
            "intermediate_size", "moe_backend", "wire_dtype",
            "a2a_chunks", "ep", "dp") if k in cfg},
        "backend": env.get("backend"),
        "torch": env.get("torch"),
        "last_path_select": planner.get("last_path_select"),
        "extra": man.get("extra"),
    }


def render_postmortem_text(rep: dict) -> str:
    lines = [f"postmortem bundle: {rep['path']}",
             f"  error: {rep['error']}",
             f"  step:  {rep['step']}    files: "
             f"{', '.join(rep['files'])}"]
    if rep.get("extra"):
        lines.append(f"  extra: {rep['extra']}")
    if rep.get("config"):
        lines.append("  config: " + ", ".join(
            f"{k}={v}" for k, v in rep["config"].items()))
    if rep.get("backend") or rep.get("torch"):
        lines.append(f"  env: torch {rep['torch']} on {rep['backend']}")
    if rep["decision_counts"]:
        lines.append("  decisions: " + ", ".join(
            f"{k}={v}" for k, v in sorted(rep["decision_counts"].items())))
    if rep["flight_records"]:
        lines.append(f"  flight: {rep['flight_records']} records, last "
                     f"losses {rep['last_losses']}")
    sel = rep.get("last_path_select")
    if sel:
        lines.append(f"  last path select: {sel.get('backend') or sel}")
    if rep["traceback_tail"]:
        lines.append("  traceback (tail):")
        for tline in rep["traceback_tail"]:
            lines.append(f"    {tline}")
    return "\n".join(lines)


def _bar(value: float, peak: float, width: int = 40) -> str:
    n = int(round(width * value / peak)) if peak > 0 else 0
    return "#" * max(n, 1 if value > 0 else 0)


def render_text(s: dict) -> str:
    lines = [f"records: {s['records']}  flight steps: {s['flight_steps']}"]
    imb = s["imbalance"]
    if imb["experts"]:
        lines.append("")
        lines.append(f"expert load histogram ({imb['experts']} experts, "
                     f"{imb['total_assignments']:g} assignments, "
                     f"imbalance max/mean = {imb['imbalance']}):")
        peak = max(imb["expert_load"])
        for i, v in enumerate(imb["expert_load"]):
            lines.append(f"  e{i:<3d} {v:>10.1f} {_bar(v, peak)}")
        if imb["mean_router_entropy"] is not None:
            lines.append(f"  mean router entropy: "
                         f"{imb['mean_router_entropy']} nats")
    drops = s["drops"]
    if drops["steps"]:
        lines.append("")
        lines.append(f"drop rate: mean {drops['mean_dropped_fraction']} "
                     f"max {drops['max_dropped_fraction']} over "
                     f"{drops['steps']} steps")
        for t in drops["timeline"][-10:]:
            lines.append(f"  step {t['step']}: dropped "
                         f"{t['dropped_fraction']}  capacity util "
                         f"{t['capacity_utilization']}")
    deg = s.get("degradation", {})
    if deg.get("steps_with_masking"):
        lines.append("")
        lines.append(f"tier-0 degradation: expert-health mask fired on "
                     f"{deg['steps_with_masking']} steps (max "
                     f"{deg['max_masked_experts']:g} masked experts)")
        for t in deg["timeline"][-10:]:
            lines.append(f"  step {t['step']}: masked "
                         f"{t['masked_experts']:g} experts, fraction "
                         f"{t['masked_fraction']}")
    wire = s.get("wire", {})
    if wire.get("steps_with_wire"):
        lines.append("")
        lines.append(f"wire compression: active on "
                     f"{wire['steps_with_wire']} layer-steps, round-trip "
                     f"quantization error mean {wire['mean_rtq_error']} "
                     f"max {wire['max_rtq_error']}")
    quant = s.get("quant", {})
    if quant.get("steps_with_quant"):
        lines.append("")
        lines.append(f"quantized experts: active on "
                     f"{quant['steps_with_quant']} layer-steps, "
                     f"weight round-trip error mean "
                     f"{quant['mean_quant_error']} max "
                     f"{quant['max_quant_error']}")
    res = s.get("resilience", {})
    if res.get("events"):
        lines.append("")
        lines.append("resilience events: " + ", ".join(
            f"{k}={v}" for k, v in res["events"].items()))
        for dr in res["drains"][-5:]:
            lines.append(
                f"  drain at step {dr['step']} ({dr['source']}), "
                f"{dr['remaining_grace_s']:.1f}s grace left"
                if isinstance(dr.get("remaining_grace_s"), float)
                else f"  drain at step {dr['step']} ({dr['source']})")
        for r in res["resumes"][-5:]:
            lines.append(f"  resume #{r['incarnation']} at step "
                         f"{r['step']}: world={r['world']} "
                         f"(ep={r['ep']} x dp={r['dp']})")
    adapt = s.get("adaptation", {})
    if adapt.get("actions"):
        lines.append("")
        lines.append("self-healing controller: " + ", ".join(
            f"{k.split('.', 1)[1]}={v}"
            for k, v in sorted(adapt["actions"].items())))
        for t in adapt["timeline"]:
            kind = str(t["decision"]).split(".", 1)[1]
            head = f"  step {t.get('step')}: {kind}"
            if kind == "morph":
                head += (f" -> {t.get('backend')}"
                         f"{' (dropless)' if t.get('dropless') else ''}")
            elif kind == "replace":
                reps = t.get("replicas") or []
                head += (f" (replicas {reps})" if reps
                         else " (permutation only)")
            elif kind == "demotion_reset":
                head += f" dropped={t.get('dropped')}"
            lines.append(head)
            b, a = t.get("before"), t.get("after")
            if b and a:
                lines.append(
                    f"    imbalance {b['imbalance']} -> "
                    f"{a['imbalance']}, dropped "
                    f"{b['dropped_fraction']} -> "
                    f"{a['dropped_fraction']}")
    if s["phases"]:
        lines.append("")
        lines.append("phase times (mean):")
        for k, v in s["phases"].items():
            lines.append(f"  {k:<32s} {v:>10.3f}")
    drift = s["drift"]
    if drift["n"]:
        lines.append("")
        lines.append(f"planner drift: {drift['n']} comparisons, "
                     f"{drift['exceeded']} over threshold")
        for key, b in drift["by_path"].items():
            lines.append(
                f"  {key:<24s} n={b['n']} mean|rel|="
                f"{b['mean_abs_rel_error']} worst={b['worst_rel_error']}"
                f"{'  ** DRIFTING' if b['exceeded'] else ''}")
    if s["decisions"]:
        lines.append("")
        lines.append("decision records: " + ", ".join(s["decisions"]))
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m flashmoe_tpu_torch.observe",
        description="Summarize flight-recorder / telemetry JSONL dumps")
    ap.add_argument("files", nargs="*", help="JSONL files to analyze")
    ap.add_argument("--json", action="store_true",
                    help="emit one machine-readable JSON document")
    ap.add_argument("--ledger", action="store_true",
                    help="render the per-phase cost-ledger report "
                         "(ledger.jsonl / phase_drift decision files)")
    ap.add_argument("--serving", action="store_true",
                    help="render the serving report (engine "
                         "flight/decision dumps: TTFT/TPOT, queue "
                         "depth, cache occupancy, planner split)")
    ap.add_argument("--postmortem", metavar="DIR",
                    help="render a triage report of the crash postmortem "
                         "bundle(s) under DIR")
    ap.add_argument("--trace", type=int, metavar="RID", default=None,
                    help="render one request's end-to-end timeline "
                         "(queue wait, prefill, decode, eviction gaps) "
                         "from serve_trace_span JSONL records")
    ap.add_argument("--merge", action="store_true",
                    help="fleet view: treat each input file as one "
                         "host's telemetry shard and summarize the "
                         "union (telemetry.<host>.jsonl); handoffs "
                         "witnessed by both pools collapse to one")
    ap.add_argument("--attribution", action="store_true",
                    help="per-request critical-path attribution from "
                         "serve_trace_span records: where each retired "
                         "request's latency went (queue wait, router "
                         "spill, prefill, handoff DCN, decode, "
                         "eviction gaps) and the fleet rollup")
    ap.add_argument("--regression", action="store_true",
                    help="perf sentry: compare the newest run in the "
                         "history file (default obs/history_torch.jsonl) "
                         "against the rolling baseline")
    ap.add_argument("--ci", action="store_true",
                    help="with --regression: exit rc 2 when any metric "
                         "regressed (regress.detected decisions)")
    args = ap.parse_args(argv)

    modes = [m for m, on in (("--ledger", args.ledger),
                             ("--serving", args.serving),
                             ("--postmortem", bool(args.postmortem)),
                             ("--trace", args.trace is not None),
                             ("--merge", args.merge),
                             ("--attribution", args.attribution),
                             ("--regression", args.regression)) if on]
    if len(modes) > 1:
        ap.error(f"pick one mode: {' '.join(modes)}")
    if args.ci and not args.regression:
        ap.error("--ci only applies with --regression")

    if args.regression:
        from flashmoe_tpu_torch.telemetry_plane import regression as reg

        path = args.files[0] if args.files else reg.DEFAULT_HISTORY
        runs = reg.load_history(path)
        if not runs:
            print(f"no run history at {path!r} (append one with "
                  f"`bench.py --regression` or "
                  f"regression.append_run)", file=sys.stderr)
            return 2
        report = reg.check_regression(runs)
        report["history"] = path
        if args.json:
            json.dump(report, sys.stdout)
            print()
        else:
            print(reg.render_text(report))
        if args.ci and report["regressions"]:
            return 2
        return 0

    if args.postmortem:
        from flashmoe_tpu_torch.profiler import postmortem as pm

        bundles = pm.find_bundles(args.postmortem)
        if not bundles:
            print(f"no postmortem bundles under {args.postmortem!r}",
                  file=sys.stderr)
            return 2
        reports = [postmortem_report(pm.load_bundle(b)) for b in bundles]
        if args.json:
            json.dump({"bundles": reports}, sys.stdout)
            print()
        else:
            print("\n\n".join(render_postmortem_text(r) for r in reports))
        return 0

    if not args.files:
        ap.error("JSONL files required (or use --postmortem DIR)")
    if args.merge:
        rep = merge_report(args.files)
        if args.json:
            json.dump(rep, sys.stdout)
            print()
        else:
            print(render_merge_text(rep))
        return 0 if rep["records"] else 2
    records = load_jsonl(args.files)
    if not records:
        print("no parseable records found", file=sys.stderr)
        return 2
    if args.trace is not None:
        rep = trace_report(records, args.trace)
        if args.json:
            json.dump(rep, sys.stdout)
            print()
        else:
            print(render_trace_text(rep))
        return 0 if rep["found"] else 2
    if args.attribution:
        from flashmoe_tpu_torch.telemetry_plane.attribution import (
            attribution_report,
        )

        rep = attribution_report(records)
        if args.json:
            json.dump(rep, sys.stdout)
            print()
        else:
            print(render_attribution_text(rep))
        return 0 if rep["requests"] else 2
    if args.ledger:
        led = ledger_report(records)
        if args.json:
            json.dump(led, sys.stdout)
            print()
        else:
            print(render_ledger_text(led))
        return 0 if led["n"] or led["overlap"] else 2
    if args.serving:
        rep = serving_report(records)
        if args.json:
            json.dump(rep, sys.stdout)
            print()
        else:
            print(render_serving_text(rep))
        return 0 if rep["steps"] or rep["requests_completed"] else 2
    s = summarize(records)
    if args.json:
        json.dump(s, sys.stdout)
        print()
    else:
        print(render_text(s))
    return 0


if __name__ == "__main__":
    sys.exit(main())
