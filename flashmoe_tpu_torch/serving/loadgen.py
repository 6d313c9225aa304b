"""Seeded load generation and the offered-load sweeps.

Counterpart of ``flashmoe_tpu/serving/loadgen.py``: :func:`tiny_config`,
:func:`build_requests`, :func:`pctl`, the per-replica trace split
(:func:`split_requests`, :func:`merge_traces`) and the sweeps, with
JAX's defaults and record keys: :func:`serve_load_sweep` (the engine
under rising offered load, optionally speculative or with a live
scrape), :func:`fabric_load_sweep` (the serving fabric per replica
count, in process or over TCP, on the wall clock or the virtual one)
and :func:`fabric_fault_sweep` (the fabric's fault drills and the
brownout shed record).  Offered load is the arrival gap of the seeded
trace (requests arrive in pairs every ``arrival_every`` engine steps;
smaller gap, higher load).  Each sweep point drives a fresh engine on
``tiny_config``'s model, on ``device`` (the card unless the caller asks
for the CPU), and emits one record whose ``metric`` identity string is
JAX's letter for letter: the regression sentry
(:mod:`flashmoe_tpu_torch.telemetry_plane.regression`) keys on it.  The
fabric's points run in the caller's world of ranks
(:func:`flashmoe_tpu_torch.fabric.topo.world_ranks`: a runtime brought
up with ``bootstrap.initialize(devices=...)``, else one rank), blocked
into replicas by ``FLASHMOE_MOCK_FABRIC`` per point as in JAX.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from flashmoe_tpu_torch.config import MoEConfig


def tiny_config(*, hidden: int = 64, experts: int = 4, layers: int = 2,
                vocab: int = 256) -> MoEConfig:
    """The CPU-sized serving drill model (dropless, the engine's
    requirement): ``flashmoe_tpu/serving/loadgen.py:17``'s fields."""
    return MoEConfig(
        num_experts=experts, expert_top_k=min(2, experts),
        hidden_size=hidden, intermediate_size=2 * hidden,
        sequence_len=128, num_layers=layers, moe_frequency=2,
        vocab_size=vocab, num_heads=2, drop_tokens=False,
        dtype=torch.float32, param_dtype=torch.float32)


def build_requests(n: int, *, vocab: int, prompt_len: int,
                   max_new: int, seed: int, arrival_every: int,
                   temperature: float = 0.0,
                   repetitive: bool = False):
    """The seeded trace: ``n`` requests with deterministic prompts and
    staggered arrivals (one pair every ``arrival_every`` engine steps).
    Prompts come from ``numpy.random.default_rng(seed)`` (the JAX
    package draws them from JAX keys, so the token values differ).
    ``repetitive`` tiles each prompt from a per-request random bigram
    motif, where the n-gram drafter finds suffix matches to propose
    from.  Request i is seeded ``seed + i``."""
    from flashmoe_tpu_torch.serving.engine import Request

    rng = np.random.default_rng(seed)
    if repetitive:
        motif = rng.integers(0, vocab, (n, 2))
        reps = -(-prompt_len // 2)
        toks = [(list(motif[i]) * reps)[:prompt_len] for i in range(n)]
    else:
        toks = rng.integers(0, vocab, (n, prompt_len))
    reqs = [Request(rid=i, prompt=tuple(int(t) for t in toks[i]),
                    max_new_tokens=max_new, temperature=temperature,
                    seed=seed + i)
            for i in range(n)]
    arrivals = [(i // 2) * arrival_every for i in range(n)]
    return reqs, arrivals


def pctl(values, q: float):
    """Nearest-rank percentile (None on empty), rounded to 3 decimals:
    the serving percentile of the JAX package's reports."""
    if not values:
        return None
    v = sorted(values)
    return round(v[min(len(v) - 1, int(q * len(v)))], 3)


def _serve_config(max_batch: int, page_size: int, num_pages: int,
                  prompt_len: int, max_new: int):
    """The sweeps' engine shape (JAX's)."""
    from flashmoe_tpu_torch.serving.engine import ServeConfig

    return ServeConfig(
        max_batch=max_batch, page_size=page_size, num_pages=num_pages,
        max_pages_per_slot=max(
            2, -(-(prompt_len + max_new) // page_size) + 1),
        ctx_bucket_pages=1, prompt_bucket=page_size)


def _sweep_model(seed: int, device):
    """``tiny_config()`` and its weights, seeded on ``device``."""
    from flashmoe_tpu_torch.models.transformer import init_params

    cfg = tiny_config()
    params = init_params(torch.Generator(device=device).manual_seed(seed),
                         cfg)
    return cfg, params


def _latency_pctls(mx) -> dict:
    """TTFT / TPOT percentiles of a run's ``serve.retire`` decisions."""
    retires = [d for d in mx.decisions if d.get("decision") == "serve.retire"]
    ttfts = [d["ttft_ms"] for d in retires if d.get("ttft_ms") is not None]
    tpots = [d["tpot_ms"] for d in retires if d.get("tpot_ms") is not None]
    return {"ttft_ms_p50": pctl(ttfts, 0.5), "ttft_ms_p99": pctl(ttfts, 0.99),
            "tpot_ms_p50": pctl(tpots, 0.5), "tpot_ms_p99": pctl(tpots, 0.99)}


def _drive(driver, mx, server, reqs, arrivals) -> tuple[float, dict | None]:
    """Run ``driver`` (an engine, fabric or front door) over the trace:
    ``(seconds, the mid-run scrape or None)``.  With a live ``server`` the
    run pauses once the first retirement has seeded the TTFT sketch,
    scrapes ``/metrics`` while work is in flight, then finishes; the
    scrape's pause is left out of the seconds, so throughput stays
    comparable with an unscraped run (whose identity differs anyway)."""
    t0 = time.monotonic()
    scrape_rec = None
    pause_s = 0.0
    if server is not None:
        driver.run(reqs, arrivals,
                   until=lambda: "serve.ttft_ms" in mx.sketches)
        t_pause = time.monotonic()
        scrape_rec = _scrape_metrics(server)
        pause_s = time.monotonic() - t_pause
        driver.run()
    else:
        driver.run(reqs, arrivals)
    return max(time.monotonic() - t0 - pause_s, 1e-9), scrape_rec


def serve_load_sweep(loads, *, n_requests: int = 8, max_batch: int = 4,
                     prompt_len: int = 8, max_new: int = 6,
                     seed: int = 0, page_size: int = 8,
                     num_pages: int = 64,
                     telemetry_port: int | None = None,
                     speculate: int | None = None,
                     device="cuda") -> list[dict]:
    """One record per offered-load point (``loads``: arrival gaps in
    engine steps, descending = rising load), JAX's
    ``serve_load_sweep``.  ``vs_baseline`` is each point's throughput
    relative to the first point's.  Token streams are deterministic per
    seed; latencies are wall-clock.

    ``telemetry_port``: one scrape server spans the sweep, serving the
    current point's metrics; each record then carries a mid-run
    ``/metrics`` self-scrape (``telemetry_scrape``) and the identity
    gains ``telemetry``.  ``speculate``: speculative decoding at
    ``draft_tokens=speculate`` over a repetitive trace, with a baseline
    run per point (the same requests and load, speculation off): each
    record carries ``baseline_tpot_ms_p50/p99``, the acceptance figures
    and ``bit_equal_to_baseline``, asserted (a diverged stream raises);
    the identity gains ``spec=kN``, so a speculative run never baselines
    a plain one."""
    from flashmoe_tpu_torch.utils.telemetry import Metrics

    cfg, params = _sweep_model(seed, device)
    serve = _serve_config(max_batch, page_size, num_pages, prompt_len,
                          max_new)
    if speculate:
        from flashmoe_tpu_torch.serving.speculate import SpecConfig

        serve = dataclasses.replace(
            serve, speculate=SpecConfig(draft_tokens=int(speculate)))
    holder = [Metrics()]
    server = None
    if telemetry_port is not None:
        from flashmoe_tpu_torch.telemetry_plane.server import maybe_server

        server = maybe_server(telemetry_port,
                              metrics_fn=lambda: holder[0])
    try:
        return _sweep_points(loads, params, cfg, serve, holder, server,
                             n_requests=n_requests, max_batch=max_batch,
                             prompt_len=prompt_len, max_new=max_new,
                             seed=seed, device=device)
    finally:
        if server is not None:
            server.stop()


def _scrape_metrics(server) -> dict:
    """The mid-run self-scrape: fetch ``/metrics`` off the live server
    and report whether it parsed and carried the serving summary
    quantiles."""
    from flashmoe_tpu_torch.telemetry_plane.server import scrape

    try:
        body, ctype = scrape(f"{server.url}/metrics")
    except Exception as e:  # noqa: BLE001 -- the record survives
        return {"ok": False, "error": f"{type(e).__name__}: "
                                      f"{str(e)[:120]}"}
    return {
        "ok": True,
        "bytes": len(body),
        "content_type": ctype,
        "has_ttft_quantiles":
            'flashmoe_serve_ttft_ms{quantile="' in body,
        "has_tpot_quantiles":
            'flashmoe_serve_tpot_ms{quantile="' in body,
    }


def _sweep_points(loads, params, cfg, serve, holder, server, *,
                  n_requests, max_batch, prompt_len, max_new, seed,
                  device="cuda"):
    """:func:`serve_load_sweep`'s points, one fresh engine each."""
    from flashmoe_tpu_torch.serving.engine import ServingEngine
    from flashmoe_tpu_torch.utils.telemetry import Metrics

    records = []
    base_tps = None
    spec = serve.speculate
    for every in loads:
        if every < 1:
            raise ValueError(f"offered-load gap {every} must be >= 1 "
                             f"engine step")
        reqs, arrivals = build_requests(
            n_requests, vocab=cfg.vocab_size, prompt_len=prompt_len,
            max_new=max_new, seed=seed, arrival_every=int(every),
            repetitive=spec is not None)
        spec_rec = None
        if spec is not None:
            # the baseline: the same trace at the same load, speculation
            # off; the comparison each record carries and the oracle of
            # the exactness check
            bmx = Metrics()
            b_eng = ServingEngine(
                params, cfg, dataclasses.replace(serve, speculate=None),
                metrics_obj=bmx)
            b_eng.run(list(reqs), list(arrivals))
            b_tp = _latency_pctls(bmx)
            spec_rec = {
                "baseline_outputs": dict(b_eng.outputs),
                "baseline_tpot_ms_p50": b_tp["tpot_ms_p50"],
                "baseline_tpot_ms_p99": b_tp["tpot_ms_p99"],
            }
        mx = Metrics()   # a private stream a point: clean retire stats
        holder[0] = mx   # the live server scrapes this point now
        engine = ServingEngine(params, cfg, serve, metrics_obj=mx)
        wall_s, scrape_rec = _drive(engine, mx, server, reqs, arrivals)
        s = engine.summary()
        tps = s["tokens"] / wall_s
        base_tps = base_tps if base_tps is not None else tps
        # arming rides the measurement identity: an armed run's numbers
        # never baseline an unarmed run's in the sentry
        tag = ",telemetry" if server is not None else ""
        if spec is not None:
            tag += f",spec=k{spec.draft_tokens}"
        records.append({
            "metric": f"serve_load[every={every},B={max_batch},"
                      f"req={n_requests}{tag}]",
            "value": round(tps, 1),
            "unit": "tokens_per_sec",
            "vs_baseline": round(tps / base_tps, 3) if base_tps
            else None,
            "offered_every_steps": int(every),
            "completed": s["completed"],
            "tokens": s["tokens"],
            "steps": s["steps"],
            **_latency_pctls(mx),
            "queue_depth_max": s["max_queue_depth"],
            "cache_occupancy_peak": round(s["peak_occupancy"], 4),
            "evictions": s["evictions"],
            "decode_plan": s["decode_plan"],
            "backend": torch.device(device).type,
        })
        if scrape_rec is not None:
            records[-1]["telemetry_scrape"] = scrape_rec
            records[-1]["telemetry_port"] = server.port
        if spec_rec is not None:
            snap = engine.spec_snapshot()
            bit_equal = dict(engine.outputs) \
                == spec_rec.pop("baseline_outputs")
            records[-1].update(spec_rec)
            records[-1].update({
                "accept_rate": snap["accept_rate"],
                "spec_tokens_per_step": snap["spec_tokens_per_step"],
                "spec_drafted": snap["spec_drafted"],
                "spec_accepted": snap["spec_accepted"],
                "bit_equal_to_baseline": bit_equal,
            })
            if not bit_equal:
                # exactness is the contract: a diverged stream is a
                # broken run, not a data point
                raise AssertionError(
                    f"speculative decode diverged from baseline at "
                    f"load point every={every}")
    return records


def split_requests(n: int, *, replicas: int, vocab: int,
                   prompt_len: int, max_new: int, seed: int,
                   arrival_every: int, temperature: float = 0.0):
    """Deterministic per-replica trace split
    (``flashmoe_tpu/serving/loadgen.py:297``): replica ``r``'s trace is
    seeded from ``numpy.random.SeedSequence((seed, r))`` (JAX folds ``r``
    into ``PRNGKey(seed)``), so N independent drill processes, one a
    replica, generate disjoint, reproducible loads with no coordination;
    rids are globally unique, ``rid * replicas + r``, as JAX's.  Returns
    ``[(requests, arrivals), ...]``, one pair a replica; requests total
    ``n`` (the remainder spreads over the lowest replica ids)."""
    import dataclasses

    if replicas < 1:
        raise ValueError(f"replicas={replicas} must be >= 1")
    out = []
    for r in range(replicas):
        count = n // replicas + (1 if r < n % replicas else 0)
        sub = int(np.random.SeedSequence((seed, r)).generate_state(1)[0]) \
            % (2**31 - 1)
        reqs, arrivals = build_requests(
            count, vocab=vocab, prompt_len=prompt_len, max_new=max_new,
            seed=sub, arrival_every=arrival_every,
            temperature=temperature)
        reqs = [dataclasses.replace(q, rid=q.rid * replicas + r)
                for q in reqs]
        out.append((reqs, arrivals))
    return out


def merge_traces(splits):
    """Merge per-replica traces back into one arrival-ordered stream
    (ties break on rid): what a single fabric front door submits when
    the split generated the load."""
    merged = []
    for reqs, arrivals in splits:
        merged.extend(zip(arrivals, reqs))
    merged.sort(key=lambda p: (p[0], p[1].rid))
    return [q for _, q in merged], [a for a, _ in merged]


def fabric_load_sweep(loads, *, replica_counts=(1, 2, 4),
                      n_requests: int = 8, max_batch: int = 4,
                      prompt_len: int = 8, max_new: int = 6,
                      seed: int = 0, page_size: int = 8,
                      num_pages: int = 64,
                      telemetry_port: int | None = None,
                      vclock: bool = False,
                      wire: str = "inproc", device="cuda") -> list[dict]:
    """One record per (replica count, offered-load point), JAX's
    ``fabric_load_sweep``: each drives a fresh
    :class:`~flashmoe_tpu_torch.fabric.engine.ServingFabric`, its world
    blocked into that many replicas by ``FLASHMOE_MOCK_FABRIC`` (set per
    point, restored after), on the :func:`split_requests` trace of that
    width.  Each record carries throughput, TTFT/TPOT percentiles, the
    handoff count and modeled DCN cost, and the router's placement
    histogram; ``vs_baseline`` is relative to the same replica count's
    first point, ``vs_single`` to the 1-replica fabric at the same load.

    ``telemetry_port``: one scrape server for the sweep and a mid-run
    ``/metrics`` self-scrape in each record.  ``vclock``: each point
    steps on a :class:`~flashmoe_tpu_torch.fabric.vclock.VirtualClock`
    behind a :class:`~flashmoe_tpu_torch.fabric.frontdoor.FrontDoor` on
    one :func:`build_requests` trace (the door owns the namespace), its
    TTFT/TPOT measured under the modeled DCN delay, and adds the
    measured-vs-priced handoff fields and the attribution rollup; the
    identity gains ``vclock``.  ``wire="tcp"``: every KV handoff crosses
    a localhost socket through a CRC-checking
    :class:`~flashmoe_tpu_torch.fabric.transport.HandoffTransport`; the
    identity gains ``wire=tcp``."""
    from flashmoe_tpu_torch.fabric.topo import mock_fabric
    from flashmoe_tpu_torch.fabric.transport import WIRE_MODES
    from flashmoe_tpu_torch.utils.telemetry import Metrics

    if wire not in WIRE_MODES:
        raise ValueError(f"wire {wire!r} not in {WIRE_MODES}")
    cfg, params = _sweep_model(seed, device)
    serve = _serve_config(max_batch, page_size, num_pages, prompt_len,
                          max_new)
    holder = [Metrics()]
    server = None
    if telemetry_port is not None:
        from flashmoe_tpu_torch.telemetry_plane.server import maybe_server

        server = maybe_server(telemetry_port,
                              metrics_fn=lambda: holder[0])
    records = []
    single_tps: dict = {}       # every -> 1-replica tokens/sec
    try:
        for k in replica_counts:
            if k < 1:
                raise ValueError(f"replica count {k} must be >= 1")
            base_tps = None
            for every in loads:
                if every < 1:
                    raise ValueError(f"offered-load gap {every} must "
                                     f"be >= 1 engine step")
                with mock_fabric(k):
                    rec, tps = _fabric_point(
                        params, cfg, serve, holder, server, k=int(k),
                        every=int(every), n_requests=n_requests,
                        prompt_len=prompt_len, max_new=max_new, seed=seed,
                        vclock=vclock, wire=wire, device=device)
                base_tps = base_tps if base_tps is not None else tps
                if int(k) == 1:
                    single_tps[int(every)] = tps
                rec["vs_baseline"] = (round(tps / base_tps, 3)
                                      if base_tps else None)
                rec["vs_single"] = (round(tps / single_tps[int(every)], 3)
                                    if single_tps.get(int(every)) else None)
                records.append(rec)
    finally:
        if server is not None:
            server.stop()
    return records


def _fabric_point(params, cfg, serve, holder, server, *, k, every,
                  n_requests, prompt_len, max_new, seed, vclock, wire,
                  device) -> tuple[dict, float]:
    """One point of :func:`fabric_load_sweep` in the world blocked into
    ``k`` replicas: ``(record, tokens/s)``, the record's keys in JAX's
    order."""
    from flashmoe_tpu_torch.fabric.engine import ServingFabric
    from flashmoe_tpu_torch.utils.telemetry import Metrics

    if vclock:
        # the front door owns the namespace: one global trace, no
        # per-replica split of rids and seeds
        reqs, arrivals = build_requests(
            n_requests, vocab=cfg.vocab_size, prompt_len=prompt_len,
            max_new=max_new, seed=seed, arrival_every=every)
    else:
        reqs, arrivals = merge_traces(split_requests(
            n_requests, replicas=k, vocab=cfg.vocab_size,
            prompt_len=prompt_len, max_new=max_new, seed=seed,
            arrival_every=every))
    mx = Metrics()
    holder[0] = mx
    vc = door = transport = None
    if vclock:
        from flashmoe_tpu_torch.fabric.vclock import VirtualClock

        vc = VirtualClock()
    if wire == "tcp":
        from flashmoe_tpu_torch.fabric.transport import HandoffTransport

        transport = HandoffTransport(metrics_obj=mx, wire="tcp")
    fab = ServingFabric(params, cfg, serve, metrics_obj=mx, vclock=vc,
                        transport=transport)
    try:
        driver = fab
        if vclock:
            from flashmoe_tpu_torch.fabric.frontdoor import FrontDoor

            door = driver = FrontDoor(fab)
        wall_s, scrape_rec = _drive(driver, mx, server, reqs, arrivals)
        s = fab.summary()
        tokens = sum(e["tokens"] for e in s["engines"])
        tps = tokens / wall_s
        tag = ",telemetry" if server is not None else ""
        if vclock:
            tag += ",vclock"
        if wire != "inproc":
            tag += f",wire={wire}"
        rec = {
            "metric": f"fabric_load[replicas={k},every={every},"
                      f"req={n_requests}{tag}]",
            "value": round(tps, 1),
            "unit": "tokens_per_sec",
            "vs_baseline": None,
            "vs_single": None,
            "replicas": k,
            "offered_every_steps": every,
            "completed": sum(e["completed"] for e in s["engines"]),
            "tokens": tokens,
            "steps": s["steps"],
            "handoffs": s["handoffs"],
            "handoff_kb": round(s["handoff_bytes"] / 1024, 3),
            "handoff_ms_modeled": round(fab.handoff.modeled_ms_total, 6),
            "routed": s["routed"],
            "evictions": sum(e["evictions"] for e in s["engines"]),
            **_latency_pctls(mx),
            "pools_formed": fab.pool_plan is not None,
            "backend": torch.device(device).type,
        }
        if scrape_rec is not None:
            rec["telemetry_scrape"] = scrape_rec
            rec["telemetry_port"] = server.port
        if door is not None:
            # the measured-latency leg: TTFT/TPOT above are virtual-time
            # numbers (under the priced DCN delay); these fields
            # reconcile them with the planner's verdicts and the
            # attribution gate
            att = door.attribution()
            errs = door.validate()
            h = fab.handoff
            rec["vclock"] = True
            rec["tick_ms"] = (round(vc.tick_ms, 6)
                              if vc.tick_ms is not None else None)
            rec["handoff_ms_measured"] = round(h.measured_ms_total, 6)
            rec["handoff_hidden_frac"] = (
                round(h.hidden_ms_total / h.measured_ms_total, 6)
                if h.measured_ms_total > 0 else None)
            rec["handoff_verdicts_agree"] = h.drift_agree
            rec["handoff_verdicts_total"] = h.drift_total
            rec["attribution_sum_ok"] = bool(
                att and all(a["sum_ok"] for a in att.values()))
            rec["attribution_max_rel_err"] = (
                max(a["rel_err"] for a in att.values()) if att else None)
            doms = [a["dominant"] for a in att.values()]
            rec["attribution_dominant"] = {
                d: doms.count(d) for d in sorted(set(doms))}
            rec["trace_errors"] = len(errs)
        if transport is not None:
            # the socket wire's provenance: real roundtrips and the
            # connection resets its ladder absorbed
            rec["wire"] = wire
            rec["wire_transfers"] = transport.transfers
            rec["wire_resets"] = transport.reset_total
    finally:
        if door is not None:
            door.close()
        fab.close()
        if transport is not None:
            transport.close()
    return rec, tps


#: the serving fault-tolerance ladder of :func:`fabric_fault_sweep`
#: (``chaos.EXPECTED_TIER`` maps each fault to its recovery tier)
SERVING_FAULTS = ("replica_crash", "handoff_corrupt",
                  "handoff_timeout", "frontdoor_loss",
                  "net_partition", "lease_split_brain",
                  "replica_stall", "lease_torn_write")


def fabric_fault_sweep(faults=None, *, seed: int = 0,
                       include_brownout: bool = True,
                       device="cuda") -> list[dict]:
    """One record per serving fault, JAX's ``fabric_fault_sweep``: each
    runs that fault's chaos drill
    (:func:`flashmoe_tpu_torch.chaos.drill.run_drill`) against a mocked
    2-replica fabric and reports the recovery ledger: the wall-clock
    recovery time as the headline value, the migrated requests, handoff
    retries and corruptions, front-door failovers and the trace
    verdict.  A drill that does not recover carries ``error``, so the
    sentry never baselines a broken run.  ``include_brownout`` appends
    :func:`_brownout_shed_record`'s record."""
    from flashmoe_tpu_torch.chaos.drill import run_drill

    faults = tuple(faults) if faults is not None else SERVING_FAULTS
    bad = [f for f in faults if f not in SERVING_FAULTS]
    if bad:
        raise ValueError(f"not serving faults: {bad} "
                         f"(choose from {SERVING_FAULTS})")
    records = []
    for fault in faults:
        r = run_drill(fault, seed=seed, device=device)
        ev = r.evidence
        rec = {
            "metric": f"fabric_fault[{fault}]",
            "value": round(r.wall_s * 1e3, 1),
            "unit": "ms",
            "fault": fault,
            "tier": r.expected_tier,
            "recovered": r.recovered,
            "completed": ev.get("completed", 0),
            "bit_equal": ev.get("bit_equal_to_baseline", False),
            "migrated": ev.get("migrations", 0),
            "retries": ev.get("retries", 0),
            "corrupt": ev.get("corrupt", 0),
            "failovers": ev.get("failovers", 0),
            "partitions": ev.get("partitions", 0),
            "fences": ev.get("fences", 0),
            "lease_repairs": ev.get("lease_repairs", 0),
            "shed_frac": 0.0,   # fault drills never shed
            "trace_errors": len(ev.get("trace_errors") or []),
            "backend": torch.device(device).type,
        }
        # the sub-step detection latency (virtual ms from the hang to
        # the watchdog's verdict): only the heartbeat drill prices one
        stalls = [d for d in r.decisions
                  if d.get("decision") == "fabric.heartbeat_stall"]
        if stalls:
            rec["heartbeat_detect_ms"] = round(
                max(d.get("detect_ms", 0.0) for d in stalls), 6)
        if not r.recovered:
            rec["error"] = r.reason[:200]
        records.append(rec)
    if include_brownout:
        records.append(_brownout_shed_record(seed=seed, device=device))
    return records


def _brownout_shed_record(*, seed: int = 0, device="cuda") -> dict:
    """One deterministic brownout drill: a seeded flood against the
    hysteretic admission controller on the virtual clock, through a
    2-replica fabric (shed decisions depend only on queue depth and step
    index, so they are the same on any machine)."""
    from flashmoe_tpu_torch.fabric.engine import ServingFabric
    from flashmoe_tpu_torch.fabric.frontdoor import FrontDoor
    from flashmoe_tpu_torch.fabric.topo import mock_fabric
    from flashmoe_tpu_torch.fabric.vclock import VirtualClock
    from flashmoe_tpu_torch.runtime.controller import BrownoutConfig
    from flashmoe_tpu_torch.serving.engine import ServeConfig
    from flashmoe_tpu_torch.utils.telemetry import Metrics

    cfg, params = _sweep_model(seed, device)
    serve = ServeConfig(
        max_batch=2, page_size=8, num_pages=64, max_pages_per_slot=4,
        ctx_bucket_pages=1, prompt_bucket=8)
    flood, _ = build_requests(10, vocab=cfg.vocab_size, prompt_len=8,
                              max_new=6, seed=seed + 1, arrival_every=1)
    # front-loaded arrivals: the burst trips the threshold, the tail
    # arrives while the brownout holds
    arrivals = [0, 0, 0, 0, 2, 2, 3, 3, 4, 5]
    bo = BrownoutConfig(queue_high=2.0, queue_low=0.5,
                        debounce_steps=1, cooldown_steps=2,
                        episode_budget=2)
    mx = Metrics()
    fab = door = None
    t0 = time.perf_counter()
    with mock_fabric(2):
        try:
            fab = ServingFabric(params, cfg, serve, metrics_obj=mx,
                                vclock=VirtualClock())
            door = FrontDoor(fab, brownout=bo)
            out = door.run(flood, arrivals)
            errs = door.validate()
            snap = door.brownout_snapshot()
        finally:
            if door is not None:
                door.close()
            if fab is not None:
                fab.close()
    wall_ms = (time.perf_counter() - t0) * 1e3
    return {
        "metric": "fabric_shed[brownout]",
        "value": round(snap["shed"] / len(flood), 4),
        "unit": "frac",
        "offered": len(flood),
        "completed": len(out),
        "shed": snap["shed"],
        "degraded": snap["degraded"],
        "episodes": snap["episodes"],
        "trace_errors": len(errs),
        "wall_ms": round(wall_ms, 1),
        "backend": torch.device(device).type,
    }
