"""PyTorch port: the live telemetry plane (``flashmoe_tpu_torch/
telemetry_plane/``, ``utils/telemetry.py``, ``runtime/telemetry_hooks.py``)
against the JAX package's on the CPU.

The Prometheus exposition is byte-equal to JAX's after the same
operations (hostile label values included); the span and decision
registries hold JAX's entries; the scrape server answers on an ephemeral
port; the request tracer gives JAX's spans under the same injected clock
and event sequence (an eviction gap included) and chains to an armed
phase timeline; attribution equals JAX's; and the port's engine gives
the same tokens with the tracer, a timeline and the scrape server armed
as without them."""

import json
import urllib.error
import urllib.request
import warnings

import pytest
import torch
torch.set_num_threads(1)  # one intra-op thread a test worker

from flashmoe_tpu.telemetry_plane import attribution as jattr
from flashmoe_tpu.telemetry_plane import tracing as jtracing
from flashmoe_tpu.utils import telemetry as jtel
from flashmoe_tpu_torch.models.transformer import init_params
from flashmoe_tpu_torch.profiler import spans as tspans
from flashmoe_tpu_torch.runtime import telemetry_hooks
from flashmoe_tpu_torch.serving import engine as teng
from flashmoe_tpu_torch.serving import loadgen as tload
from flashmoe_tpu_torch.telemetry_plane import attribution as tattr
from flashmoe_tpu_torch.telemetry_plane import server as tserver
from flashmoe_tpu_torch.telemetry_plane import tracing as ttracing
from flashmoe_tpu_torch.utils import telemetry as ttel
from test_torch_profiler import Clock, _traced


def _fill(tel):
    m = tel.Metrics()
    m.count("steps")
    m.count("steps", 2.5)
    m.count("weird name/with:chars")
    m.gauge("lr", 0.1)
    m.gauge("9lives", -3.0)
    m.labeled_gauge("build_info", 1.0,
                    host='evil"host\nwith\\stuff', slice="s/0")
    m.labeled_gauge("build_info", 2.0, host="ok")
    m.labeled_gauge("serve.rate", 120.0, kind="tokens")
    for v in range(100):
        m.sketch("serve.ttft_ms", float(v) * 1.5)
    m.sketch("empty_later", 1.0)
    m.times["fwd"].extend([0.002, 0.001, 0.004])
    m.times["never"]
    for v in (0.5, 2.0, 7.0, 1e4):
        m.histogram("step_ms", v, buckets=(1.0, 5.0))
    m.histogram("default_buckets", 3.3)
    m.decision("serve.admit", rid=1)
    return m


def test_prometheus_text_byte_equal_to_jax():
    j, t = _fill(jtel), _fill(ttel)
    assert t.prometheus_text() == j.prometheus_text()
    assert t.prometheus_text(prefix="job") == j.prometheus_text(
        prefix="job")
    assert t.summary() == j.summary()
    assert ttel.PROM_CONTENT_TYPE == jtel.PROM_CONTENT_TYPE
    for v in ('a"b', "a\nb", "a\\b", "\\n", 7):
        assert ttel.escape_label_value(v) == jtel.escape_label_value(v)


def test_registries_hold_jax_entries_and_warn_on_unknown(tmp_path):
    assert set(jtel.DECISION_NAMES) <= set(ttel.DECISION_NAMES)
    assert ttel.SPAN_NAMES == jtel.SPAN_NAMES
    assert ttel.span_table_markdown() == jtel.span_table_markdown()
    m = ttel.Metrics()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        for name in ttel.DECISION_NAMES:
            m.decision(name)  # staticcheck: ok every registered name
    assert m.counters["decision.unregistered"] == 0
    with pytest.warns(RuntimeWarning, match="unregistered decision"):
        m.decision("no.such_name", x=1)  # staticcheck: ok the warning
    assert m.counters["decision.unregistered"] == 1
    ttel.register_decision("no.such_name", "a test's own decision")
    try:
        m.decision("no.such_name")  # staticcheck: ok registered above
        assert "`no.such_name`" in ttel.decision_table_markdown()
    finally:
        ttel.DECISION_NAMES.pop("no.such_name")
    ttel.register_span("test.span", "a test's span")
    try:
        assert "`test.span`" in ttel.span_table_markdown()
    finally:
        ttel.SPAN_NAMES.pop("test.span")
    # the offset-aware decision dump
    path = str(tmp_path / "d.jsonl")
    n = m.dump_decisions_jsonl(path)
    assert m.dump_decisions_jsonl(path, start=n) == n
    assert len(open(path).read().splitlines()) == n


def _get(url):
    with urllib.request.urlopen(url, timeout=5) as r:
        return r.status, r.read().decode(), r.headers.get("Content-Type")


def test_server_endpoints_on_an_ephemeral_port(tmp_path, monkeypatch):
    m = ttel.Metrics()
    m.gauge("lr", 0.1)
    with tserver.TelemetryServer(
            0, metrics_obj=m, health_fn=lambda: {"queue_depth": 3},
            vars_fn=lambda: {"plan": ["collective", 1]}) as srv:
        assert srv.port > 0
        code, body, ctype = _get(f"{srv.url}/metrics")
        assert code == 200 and ctype == ttel.PROM_CONTENT_TYPE
        assert body == m.prometheus_text()
        code, body, _ = _get(f"{srv.url}/healthz?x=1")
        assert json.loads(body) == {"ok": True, "queue_depth": 3}
        _, body, _ = _get(f"{srv.url}/vars")
        assert json.loads(body)["plan"] == ["collective", 1]
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(f"{srv.url}/nope")
        assert e.value.code == 404
        assert tserver.scrape(f"{srv.url}/vars")[1] == "application/json"
    names = [d["decision"] for d in m.decisions]
    assert names.count("telemetry.server_start") == 1
    assert names.count("telemetry.server_stop") == 1
    assert tserver.maybe_server(None) is None
    monkeypatch.setenv("FLASHMOE_HOST_ID", "host a/b")
    assert tserver.host_shard_path(str(tmp_path)).endswith(
        "telemetry.host_a_b.jsonl")
    # the training loops' documents
    progress = {"step": 4}
    m.decision("bootstrap.groups", mapping="single", dp=1, ep=8)
    srv = telemetry_hooks.train_server(
        0, None, num_steps=9, progress=progress, metrics_obj=m,
        checkpoint_dir=str(tmp_path / "none"))
    try:
        hz = json.loads(_get(f"{srv.url}/healthz")[1])
        assert hz["step"] == 4 and hz["num_steps"] == 9
        assert hz["last_checkpoint_step"] is None
        v = json.loads(_get(f"{srv.url}/vars")[1])
        assert v["group_plan"]["mapping"] == "single"
    finally:
        srv.stop()
    assert telemetry_hooks.train_server(None) is None


def test_request_tracer_spans_equal_jax():
    jm, tm = jtel.Metrics(), ttel.Metrics()
    jt, tt = _traced(jtracing), _traced(ttracing)
    jt._metrics, tt._metrics = jm, tm
    for rid in (0, 1):
        assert tt.request_track(rid) == jt.request_track(rid)
    assert tt.records() == jt.records()
    assert tt.validate() == jt.validate() == []
    assert any(s.get("resumed") for s in tt.request_track(1))
    assert tt.requests[1].evictions == 1
    # trace decisions at retirement, the same
    for tr, m in ((jt, jm), (tt, tm)):
        tr.on_retire(0, 9, tokens=3)
    assert tm.decisions == jm.decisions
    # the no-orphan gate catches what JAX's catches
    for tr in (jt, tt):
        tr.requests[0].spans.append({"name": "serve.decode", "rid": 5,
                                     "trace_id": "x", "ts_ms": 999.0,
                                     "dur_ms": 1.0, "step": 9})
    assert tt.validate() == jt.validate() != []


def test_tracer_chains_to_phase_timeline():
    tl = tspans.PhaseTimeline()
    tspans.install(tl)
    try:
        tr = ttracing.RequestTracer(clock=Clock(1e-3)).install()
        assert ttel.get_span_listener() is tr
        tl.begin_step(0)
        tr.begin_step(0, [])
        tr.on_admit(1, 0, resumed=False)
        with ttel.trace_span("serve.prefill"):
            pass
        tr.end_step()
        tl.end_step()
        tr.uninstall()
        assert ttel.get_span_listener() is tl
        assert any(s["name"] == "serve.prefill" for s in tl.spans)
        assert any(s["name"] == "serve.prefill"
                   for s in tr.request_track(1))
    finally:
        tspans.uninstall()
    assert ttel.get_span_listener() is None


def test_attribution_equals_jax():
    jt, tt = _traced(jtracing), _traced(ttracing)
    jm, tm = jtel.Metrics(), ttel.Metrics()
    assert tattr.attribute_tracer(tt, metrics_obj=tm,
                                  ttft_ms={0: 1.0, 1: 2.0}) == \
        jattr.attribute_tracer(jt, metrics_obj=jm,
                               ttft_ms={0: 1.0, 1: 2.0})
    assert tm.decisions == jm.decisions
    routes = [{"decision": "fabric.route", "rid": 1,
               "policy": "jsq_spill"}]
    recs = tt.records() + tt.records()[:2] + routes
    assert tattr.attribution_report(recs) == jattr.attribution_report(
        jt.records() + jt.records()[:2] + routes)
    assert tattr.spilled_rids(routes) == {1}
    track = tt.request_track(1)
    assert tattr.attribute_track(track, spilled=True, until_ms=3.0) == \
        jattr.attribute_track(jt.request_track(1), spilled=True,
                              until_ms=3.0)


def test_engine_tokens_unchanged_with_the_plane_armed():
    cfg = tload.tiny_config()
    params = init_params(torch.Generator().manual_seed(0), cfg)
    reqs, arrivals = tload.build_requests(6, vocab=cfg.vocab_size,
                                          prompt_len=6, max_new=5, seed=2,
                                          arrival_every=1)
    serve = teng.ServeConfig(max_batch=4, page_size=4, num_pages=10,
                             max_pages_per_slot=4, prompt_bucket=4)

    def run(**kw):
        eng = teng.ServingEngine(params, cfg, serve,
                                 metrics_obj=ttel.Metrics(), **kw)
        try:
            return eng.run(reqs, arrivals), eng
        finally:
            eng.close()

    want, _ = run()
    tl = tspans.PhaseTimeline()
    with tspans.profiling(tl):
        tl.begin_step(0)
        got, eng = run(tracer=True, telemetry_port=0)
        tl.end_step()
    assert got == want
    assert eng.tracer.validate() == []
    # the tracer forwarded the engine's spans to the armed timeline
    assert {"serve.prefill", "serve.decode"} <= {s["name"]
                                                 for s in tl.spans}
    assert {d["decision"] for d in eng.metrics.decisions} >= {
        "serve.trace", "telemetry.server_start", "telemetry.server_stop"}
    assert ttel.get_span_listener() is None


def test_capture_trace_writes_a_chrome_trace_with_its_spans(tmp_path):
    """``capture_trace`` (``jax.profiler``'s whole-program capture, on
    ``torch.profiler``): a Chrome trace under ``log_dir`` holding the
    ``trace_span`` ranges and the ops inside them; start and stop refuse
    to nest or to stop nothing, as JAX's profiler does."""
    log_dir = tmp_path / "trace"
    with ttel.capture_trace(str(log_dir)):
        with ttel.trace_span("moe.expert"):
            torch.ones(16, 16) @ torch.ones(16, 16)
    files = list(log_dir.glob("*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    span = [e for e in events if e.get("name") == "moe.expert"]
    assert span and span[0]["ph"] == "X" and span[0]["dur"] >= 0
    assert any(e.get("name") == "aten::mm" for e in events)
    with pytest.raises(RuntimeError, match="no trace"):
        ttel.stop_trace()
    ttel.start_trace(str(log_dir))
    try:
        with pytest.raises(RuntimeError, match="already running"):
            ttel.start_trace(str(log_dir))
    finally:
        path = ttel.stop_trace()
    assert path.startswith(str(log_dir)) and len(
        list(log_dir.glob("*.json"))) == 2
