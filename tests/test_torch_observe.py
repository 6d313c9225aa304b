"""PyTorch port: the flight-recorder analysis CLI
(``flashmoe_tpu_torch/observe.py``) against the JAX package's
``observe.py`` on the same synthetic records.

Every report function gives a dict equal to JAX's and every renderer the
same text, byte for byte, and the CLI's modes print what JAX's CLI
prints on the same files.  Two differences are by design: a postmortem
report names the bundle's ``torch`` version where JAX's names ``jax``
(its ``env.json`` records the port's framework), and ``--regression``
reads the port's own history (``obs/history_torch.jsonl`` by default),
with JAX's report, text, message and exit codes.  The adaptation
report over the port's own controller run shows the morph's before and
after windows."""

import io
import json
import contextlib

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # one intra-op thread a test worker

from flashmoe_tpu import observe as jobs
from flashmoe_tpu.ops import stats as jstats
from flashmoe_tpu_torch import observe as tobs
from flashmoe_tpu_torch.chaos import inject as tinject
from flashmoe_tpu_torch.chaos.drill import data_stream, drill_config
from flashmoe_tpu_torch.ops import stats as tstats
from flashmoe_tpu_torch.profiler import postmortem as tpm
from flashmoe_tpu_torch.runtime import controller as tctl
from flashmoe_tpu_torch.runtime import trainer as ttrainer
from flashmoe_tpu_torch.utils.telemetry import FlightRecorder, Metrics


def _flight(rng, n=12, layers=2, e=8):
    out = []
    for s in range(n):
        moe = []
        for li in range(layers):
            load = rng.integers(0, 40, e).astype(float)
            if s >= 6:
                load[0] += 80   # a skew that starts at step 6
            m = {"layer": li, "expert_load": load.tolist(),
                 "imbalance": float(load.max() / max(load.mean(), 1e-9)),
                 "router_entropy": float(rng.random() * 2),
                 "dropped_fraction": float(rng.random() * 0.1),
                 "capacity_utilization": float(rng.random()),
                 "masked_experts": float(s % 4 == 1),
                 "masked_fraction": float(rng.random() * 0.01),
                 "wire_rtq_error": float(rng.random() * 1e-3)
                 if s % 2 else 0.0,
                 "wire_rtq_error_dcn": float(rng.random() * 1e-3)
                 if s % 3 == 0 else 0.0,
                 "quant_error": float(rng.random() * 1e-2)
                 if s > 8 else 0.0}
            moe.append(m)
        out.append({"step": s, "loss": float(5 - 0.1 * s),
                    "step_ms": float(10 + rng.random()),
                    "grad_norm": float(rng.random()), "moe": moe})
    return out


def _decisions():
    return [
        {"decision": "trainer.grad_skip", "step": 2, "grad_norm": 1e9},
        {"decision": "preempt.notice", "source": "chaos"},
        {"decision": "preempt.drain", "step": 4, "source": "chaos",
         "remaining_grace_s": 29.5},
        {"decision": "preempt.drain", "step": 9, "source": "signal",
         "remaining_grace_s": None},
        {"decision": "supervisor.resume", "incarnation": 1, "step": 4,
         "world": 2, "ep": 2, "dp": 1},
        {"decision": "checkpoint.fallback", "step": 5},
        {"decision": "planner.fallback", "failed": "fused"},
        {"decision": "slo.breach", "target": "step", "step": 7},
        {"decision": "slo.recovered", "step": 9},
        {"decision": "postmortem.saved", "path": "/x"},
        {"decision": "controller.morph", "step": 7, "trigger": "skew",
         "backend": "ragged", "dropless": True,
         "overrides": {"drop_tokens": False, "moe_backend": "ragged"},
         "reason": "drops"},
        {"decision": "controller.cooldown", "step": 8, "trigger": "skew",
         "until": 10},
        {"decision": "controller.replace", "step": 10, "trigger": "slow",
         "perm": [1, 0, 2, 3, 4, 5, 6, 7], "replicas": [[1, 4]],
         "rates": [0.25, 1.0, 1.0, 1.0],
         "device_share_before": [0.7, 0.1, 0.1, 0.1]},
        {"decision": "controller.replace", "step": 11, "trigger": "slow",
         "perm": list(range(8)), "replicas": [], "rates": None},
        {"decision": "controller.demotion_reset", "incarnation": 1,
         "world": 2, "dropped": ["ragged"]},
        {"decision": "planner.drift", "path": "collective", "gen": "h100",
         "d": 8, "predicted_ms": 1.0, "measured_ms": 1.5,
         "rel_error": 0.5, "exceeded": True},
        {"metric": "moe_fwd", "value": 2.0, "predicted_ms": 1.8,
         "path": "fused", "d": 8},
        {"name": "phase", "moe.gate_ms_p50": 0.2, "moe.expert_ms_p50": 1.2,
         "predicted_ms": 3.0},
    ]


def _serving(rng):
    recs = []
    for s in range(20):
        recs.append({"kind": "serve_step", "step": s, "tokens": 8,
                     "step_ms": float(5 + rng.random()),
                     "queue_depth": int(rng.integers(0, 6)),
                     "cache_occupancy": float(rng.random()),
                     "active": int(rng.integers(1, 8)),
                     "spec_tokens": int(rng.integers(0, 3)),
                     "spec_on": bool(s < 15)})
    for rid in range(10):
        recs.append({"kind": "serve_request", "rid": rid,
                     "ttft_ms": float(20 + 10 * rng.random()),
                     "tpot_ms": float(3 + rng.random()),
                     "spec_drafted": 8, "spec_accepted": int(rid % 5)})
    recs += [
        {"decision": "serve.retire", "rid": 3, "ttft_ms": 1.0},
        {"decision": "serve.plan", "prefill_backend": "fused",
         "prefill_chunks": 2, "decode_backend": "collective",
         "decode_chunks": 1, "heterogeneous": True},
        {"decision": "serve.quant", "expert_quant": "int8",
         "freed_mb": 12.5, "extra_kv_pages": 40, "num_pages": 128},
        {"decision": "serve.pools", "prefill_devices": [0, 1],
         "decode_devices": [2, 3], "prefill_ms": 1.5, "decode_ms": 0.5,
         "prefill_mapping": "fused", "decode_mapping": "collective",
         "decode_quant": "int8", "kv_wire": "e4m3"},
        {"decision": "fabric.route", "replica": 0, "policy": "jsq",
         "draining": [1], "rid": 1, "spilled": True, "preferred": 1},
        {"decision": "fabric.route", "replica": 1, "policy": "affinity",
         "rid": 2},
        {"decision": "fabric.handoff", "rid": 1, "replica": 0, "pages": 4,
         "payload_kb": 64.0, "modeled_dcn_ms": 0.25, "overlapped": True,
         "wire": "e4m3"},
        {"decision": "fabric.handoff", "rid": 2, "replica": 1, "pages": 2,
         "payload_kb": 32.0, "modeled_dcn_ms": 0.125, "overlapped": False,
         "wire": "e4m3"},
        {"decision": "serve.admit", "rid": 1},
        {"decision": "serve.evict", "rid": 1},
        {"decision": "fabric.replica_crash", "replica": 1, "step": 5,
         "in_flight": 2, "queued": 1},
        {"decision": "fabric.migrate", "from_replica": 1, "to_replica": 0,
         "resumed": True},
        {"decision": "fabric.handoff_retry", "reason": "crc",
         "wasted_ms": 0.5, "backoff_ms": 2},
        {"decision": "fabric.handoff_corrupt"},
        {"decision": "frontdoor.shed", "mode": "degrade"},
        {"decision": "frontdoor.brownout", "state": "enter"},
        {"decision": "frontdoor.failover", "epoch": 3, "from_peer": 0,
         "to_peer": 1},
        {"decision": "fabric.partition", "injected": True,
         "dropped_bytes": 2048, "transfer": 4},
        {"decision": "frontdoor.fence", "refused": True, "stale_epoch": 2,
         "claimant": 1},
        {"decision": "frontdoor.lease_repair", "torn_bytes": 12,
         "restored_epoch": 3},
        {"decision": "fabric.heartbeat_stall", "replica": 0, "step": 9,
         "detect_ms": 40.0},
        {"decision": "fabric.heartbeat_miss"},
        {"decision": "slo.breach", "target": "ttft"},
        {"decision": "slo.breach", "target": "tpot"},
        {"decision": "controller.spec_morph", "kind": "off"},
    ]
    return recs


def _trace(rng):
    recs = []
    for rid in range(4):
        t = 10.0 * rid
        spans = [("serve.queued", 2.0, False), ("serve.prefill", 3.0, None),
                 ("serve.handoff", 0.5, None), ("serve.step", 4.0, None),
                 ("serve.queued", 1.0, True), ("serve.step", 4.0, None)]
        for step, (name, dur, resumed) in enumerate(spans):
            rec = {"kind": "serve_trace_span", "rid": rid, "name": name,
                   "ts_ms": t, "dur_ms": dur, "step": step,
                   "trace_id": f"t{rid}", "evictions": 1,
                   "retired": rid != 3}
            if resumed is not None:
                rec["resumed"] = resumed
            recs.append(rec)
            t += dur + float(rng.random())
    # a shard duplicate
    recs.append(dict(recs[1]))
    return recs


def _ledger():
    return [
        {"point": "flat", "path": "collective", "chunks": 1, "wire": "off",
         "phase": "moe.a2a_dispatch", "measured_ms": 1.2,
         "predicted_ms": 1.0, "rel_error": 0.2, "exceeded": False},
        {"point": "flat", "path": "collective", "chunks": 1, "wire": "off",
         "phase": "moe.expert", "measured_ms": 3.0, "predicted_ms": 1.0,
         "rel_error": 2.0, "exceeded": True},
        {"decision": "planner.phase_drift", "path": "fused", "chunks": 2,
         "wire": "e4m3", "phase": "moe.expert", "measured_ms": 1.0,
         "predicted_ms": 1.1, "rel_error": -0.0909, "exceeded": False},
        {"record": "overlap", "point": "chunked", "d": 8, "chunks": 2,
         "wire": "off", "measured_fraction": 0.8,
         "predicted_fraction": 0.6, "exceeded": True},
    ]


@pytest.fixture
def records():
    rng = np.random.default_rng(0)
    return {"flight": _flight(rng), "decisions": _decisions(),
            "serving": _serving(rng), "trace": _trace(rng),
            "ledger": _ledger()}


def _all(records):
    return [r for v in records.values() for r in v]


REPORTS = ("imbalance_report", "drop_report", "degradation_report",
           "wire_report", "quant_report")


@pytest.mark.parametrize("name", REPORTS)
def test_flight_reports_equal_jax(records, name):
    fl = records["flight"]
    assert getattr(tobs, name)(fl) == getattr(jobs, name)(fl)


@pytest.mark.parametrize("name", ["resilience_report", "adaptation_report",
                                  "phase_report", "summarize"])
def test_record_reports_equal_jax(records, name):
    recs = _all(records)
    got, want = getattr(tobs, name)(recs), getattr(jobs, name)(recs)
    assert got == want
    if name == "summarize":
        assert tobs.render_text(got) == jobs.render_text(want)
        empty = tobs.summarize([])
        assert empty == jobs.summarize([])
        assert tobs.render_text(empty) == jobs.render_text(empty)


def test_serving_and_speculation_equal_jax(records):
    recs = records["serving"]
    assert tstats.speculation_summary(recs) == \
        jstats.speculation_summary(recs)
    assert tstats.speculation_summary([]) == jstats.speculation_summary([])
    got, want = tobs.serving_report(recs), jobs.serving_report(recs)
    assert got == want
    assert tobs.render_serving_text(got) == jobs.render_serving_text(want)
    # retire decisions alone (no serve_request records)
    alone = [r for r in recs if r.get("kind") != "serve_request"]
    assert tobs.serving_report(alone) == jobs.serving_report(alone)


def test_trace_ledger_merge_attribution_equal_jax(records, tmp_path):
    tr = records["trace"]
    for rid in (0, 1, 99):
        got, want = tobs.trace_report(tr, rid), jobs.trace_report(tr, rid)
        assert got == want
        if got["found"]:
            assert tobs.render_trace_text(got) == jobs.render_trace_text(want)
    led = records["ledger"]
    got, want = tobs.ledger_report(led), jobs.ledger_report(led)
    assert got == want
    assert tobs.render_ledger_text(got) == jobs.render_ledger_text(want)
    from flashmoe_tpu.telemetry_plane.attribution import (
        attribution_report as jattr)
    from flashmoe_tpu_torch.telemetry_plane.attribution import (
        attribution_report as tattr)

    recs = tr + records["serving"]
    got, want = tattr(recs), jattr(recs)
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    assert tobs.render_attribution_text(got) == \
        jobs.render_attribution_text(want)
    paths = _files(tmp_path, records)
    got, want = tobs.merge_report(paths), jobs.merge_report(paths)
    assert got == want
    assert tobs.render_merge_text(got) == jobs.render_merge_text(want)


def _files(tmp_path, records):
    paths = []
    for k, v in records.items():
        p = tmp_path / f"telemetry.{k}.jsonl"
        p.write_text("".join(json.dumps(r) + "\n" for r in v)
                     + "# a comment\nnot json\n")
        paths.append(str(p))
    return paths


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


@pytest.mark.parametrize("mode", [
    [], ["--json"], ["--serving"], ["--serving", "--json"], ["--ledger"],
    ["--ledger", "--json"], ["--trace", "1"], ["--trace", "2", "--json"],
    ["--trace", "77"], ["--merge"], ["--merge", "--json"],
    ["--attribution"], ["--attribution", "--json"],
])
def test_cli_modes_print_what_jax_prints(records, tmp_path, mode):
    paths = _files(tmp_path, records)
    got = _run(tobs.main, mode + paths)
    want = _run(jobs.main, mode + paths)
    if mode[:2] == ["--trace", "77"]:
        # the miss names the port's serving CLI where JAX's names its own
        got = (got[0], got[1].replace("flashmoe_tpu_torch.", "flashmoe_tpu."))
    assert got == want


def test_cli_postmortem_and_refusals(tmp_path, capsys):
    pm_dir = tmp_path / "pm"
    try:
        raise RuntimeError("boom at step 3")
    except RuntimeError as e:
        err = e
    m = Metrics()
    m.decision("checkpoint.fallback", step=2)
    tpm.write_bundle(str(pm_dir), error=err, cfg=drill_config(),
                     metrics_obj=m, history=[{"loss": 1.5}, {"loss": 1.25}],
                     step=3, extra={"retries": 2})
    got = _run(tobs.main, ["--postmortem", str(pm_dir)])
    want = _run(jobs.main, ["--postmortem", str(pm_dir)])
    env = [line for line in got[1].splitlines() if "env:" in line]
    assert env and env[0].strip().startswith(f"env: torch {torch.__version__}")
    strip = [line for line in got[1].splitlines() if "env:" not in line]
    assert got[0] == want[0] == 0
    assert strip == [line for line in want[1].splitlines()
                     if "env:" not in line]
    rep_t = json.loads(_run(tobs.main, ["--postmortem", str(pm_dir),
                                        "--json"])[1])
    rep_j = json.loads(_run(jobs.main, ["--postmortem", str(pm_dir),
                                        "--json"])[1])
    assert rep_t["bundles"][0].pop("torch") == torch.__version__
    rep_j["bundles"][0].pop("jax")
    assert rep_t == rep_j
    assert _run(tobs.main, ["--postmortem", str(tmp_path / "none")])[0] == 2
    # the perf sentry: a clean history rc 0, a regressed one rc 2 under
    # --ci, a missing one rc 2 with JAX's message; output and rc JAX's
    from flashmoe_tpu.telemetry_plane import regression as jreg
    from flashmoe_tpu_torch.telemetry_plane import regression as treg

    hist = str(tmp_path / "history_torch.jsonl")
    pts = {"serve_load[every=1,B=4,req=8]":
           {"value": 100.0, "unit": "tokens_per_sec"},
           "fabric_fault[replica_crash]": {"value": 12.0, "unit": "ms"}}
    for run in ("r1", "r2"):
        treg.append_run(hist, pts, run=run)
    bad = {k: dict(v) for k, v in pts.items()}
    bad["fabric_fault[replica_crash]"]["value"] = 20.0
    capsys.readouterr()
    for argv, rc in ((["--regression", hist], 0),
                     (["--regression", "--ci", hist], 0),
                     (["--regression", "--json", hist], 0)):
        got, want = _run(tobs.main, argv), _run(jobs.main, argv)
        assert got == want and got[0] == rc
    jreg.append_run(hist, bad, run="r3")
    for argv, rc in ((["--regression", hist], 0),
                     (["--regression", "--ci", hist], 2)):
        got, want = _run(tobs.main, argv), _run(jobs.main, argv)
        assert got == want and got[0] == rc
    assert "REGRESSED fabric_fault[replica_crash]" in got[1]
    missing = str(tmp_path / "none.jsonl")
    capsys.readouterr()
    assert _run(tobs.main, ["--regression", missing])[0] == 2
    t_err = capsys.readouterr().err
    assert _run(jobs.main, ["--regression", missing])[0] == 2
    assert t_err == capsys.readouterr().err != ""
    for argv in (["--ledger", "--serving", "x"], ["--ci", "x"], []):
        with pytest.raises(SystemExit):
            tobs.main(argv)
    empty = tmp_path / "empty.jsonl"
    empty.write_text("\n")
    assert _run(tobs.main, [str(empty)])[0] == \
        _run(jobs.main, [str(empty)])[0] == 2
    capsys.readouterr()


def test_adaptation_report_over_the_ports_controller_run(tmp_path):
    """``train`` under sustained skew with a controller and a recorder:
    the report lists the morph with the flight steps before and after
    it, the drop fraction falling to 0."""
    cfg = drill_config()
    tinject.arm("skewed_routing", expert=0, bias=100.0)
    try:
        ctl = tctl.RuntimeController(
            cfg, tctl.ControllerConfig(debounce_steps=2, cooldown_steps=3,
                                       baseline_steps=2, ema_decay=0.5,
                                       morph_budget=1,
                                       enable_replace=False),
            metrics=Metrics(), device="cpu")
        rec = FlightRecorder()
        ttrainer.train(cfg, data_stream(cfg, 2, 0, "cpu"), 8,
                       generator=torch.Generator().manual_seed(0),
                       recorder=rec, flight_path=str(tmp_path / "f.jsonl"),
                       controller=ctl)
    finally:
        tinject.disarm()
    (tmp_path / "d.jsonl").write_text(
        "".join(json.dumps(d) + "\n" for d in ctl.timeline))
    recs = tobs.load_jsonl([str(tmp_path / "f.jsonl"),
                            str(tmp_path / "d.jsonl")])
    rep = tobs.adaptation_report(recs)
    assert rep == jobs.adaptation_report(recs)
    morph = rep["timeline"][0]
    assert morph["decision"] == "controller.morph" and morph["dropless"]
    assert morph["before"]["dropped_fraction"] > 0
    assert morph["after"]["dropped_fraction"] == 0.0
    text = _run(tobs.main, [str(tmp_path / "f.jsonl"),
                            str(tmp_path / "d.jsonl")])[1]
    assert "self-healing controller: morph=1" in text
    assert "step " + str(morph["step"]) + ": morph -> local (dropless)" \
        in text
