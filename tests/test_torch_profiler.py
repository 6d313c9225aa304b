"""PyTorch port: the phase profiler (``flashmoe_tpu_torch/profiler/``)
against the JAX package's (``flashmoe_tpu/profiler/``) on the CPU.

* the timeline's semantics (``tests/test_profiler.py:34-95``);
* ``predicted_phase_ms`` equal to JAX's at rtol 1e-9, JAX's tables
  holding the port's rows (``"local<d>"``: a local-mesh rank's 1/d share
  of the card; JAX halves its bf16 peak for f32, so an f32 row holds
  twice the port's f32 rate) and JAX's links set to the row's count;
* ``phase_ledger``'s rows and decisions, the Chrome-trace and
  request-trace documents (the same spans on the same injected clock),
  ``validate_trace``'s verdicts, the SLO watchdog's decision stream
  (its YAML fallback parser included) and the postmortem bundle's
  manifest, all equal to JAX's;
* the collective, ragged and fused layers (their plain versions) give
  the same bits with ``profile_phases`` on and off, with and without a
  timeline armed, and record their phases under JAX's names.
"""

import dataclasses
import json
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashmoe_tpu.config import MoEConfig as JaxConfig
from flashmoe_tpu.parallel import topology as jtop
from flashmoe_tpu.planner import select as jselect
from flashmoe_tpu.profiler import export as jexport
from flashmoe_tpu.profiler import ledger as jledger
from flashmoe_tpu.profiler import postmortem as jpm
from flashmoe_tpu.profiler import slo as jslo
from flashmoe_tpu.profiler import spans as jspans
from flashmoe_tpu.telemetry_plane import tracing as jtracing
from flashmoe_tpu.utils import telemetry as jtel
from flashmoe_tpu_torch.config import MoEConfig
from flashmoe_tpu_torch.convert import params_from_numpy
from flashmoe_tpu_torch.parallel import ep as tep
from flashmoe_tpu_torch.parallel import topology as ttop
from flashmoe_tpu_torch.parallel.fused import fused_ep_moe_layer
from flashmoe_tpu_torch.parallel.mesh import local_mesh
from flashmoe_tpu_torch.parallel.ragged_ep import ragged_ep_moe_layer
from flashmoe_tpu_torch.planner import select as tselect
from flashmoe_tpu_torch.profiler import export as texport
from flashmoe_tpu_torch.profiler import ledger as tledger
from flashmoe_tpu_torch.profiler import postmortem as tpm
from flashmoe_tpu_torch.profiler import slo as tslo
from flashmoe_tpu_torch.profiler import spans as tspans
from flashmoe_tpu_torch.telemetry_plane import tracing as ttracing
from flashmoe_tpu_torch.utils import telemetry as ttel
from test_torch_ep import moe_params, tokens
from test_torch_planner import _to_port


class Clock:
    """A deterministic clock: each read advances by ``tick``."""

    def __init__(self, tick=0.25):
        self.t = 0.0
        self.tick = tick

    def __call__(self):
        self.t += self.tick
        return self.t


def _clocked(mod, label="toy"):
    tl = mod.PhaseTimeline(label=label)
    tl._now_ms = Clock()
    return tl


# ----------------------------------------------------------------------
# timeline semantics
# ----------------------------------------------------------------------

def test_merged_phase_equals_jax():
    for name in ("moe.expert.3", "moe.expert", "moe.a2a_dispatch.12",
                 "train.step", "serve.decode", "x.1.y"):
        assert tspans.merged_phase(name) == jspans.merged_phase(name)


def test_timeline_records_spans_only_inside_steps():
    tl = tspans.PhaseTimeline(label="t")
    with tspans.profiling(tl):
        with ttel.trace_span("moe.gate"):
            pass
        assert tl.spans == []
        tl.begin_step(0)
        with ttel.trace_span("moe.gate"):
            torch.ones(4).sum()
        with ttel.trace_span("moe.expert.0"):
            pass
        with ttel.trace_span("moe.expert.1"):
            pass
        rec = tl.end_step()
    with ttel.trace_span("moe.gate"):
        pass
    assert [s["name"] for s in tl.spans] == \
        ["moe.gate", "moe.expert.0", "moe.expert.1"]
    assert set(rec["phases"]) == {"moe.gate", "moe.expert"}
    assert rec["wall_ms"] >= rec["phases"]["moe.gate"]
    assert tl.phase_means()["moe.gate"] == rec["phases"]["moe.gate"]
    assert ttel.get_span_listener() is None and tspans.active() is None
    with pytest.raises(RuntimeError, match="end_step without"):
        tl.end_step()


def test_timeline_sections_counters_and_fence():
    tl = tspans.PhaseTimeline()
    with tspans.profiling(tl):
        with tspans.section("train.data_pull", step=7):
            pass
        tl.counter("moe.load_imbalance", 2.5, step=7)
        x = torch.ones(4)
        assert tspans.fence((x, {"a": x}, None)) is not None
    assert tl.sections[0]["name"] == "train.data_pull"
    assert tl.sections[0]["step"] == 7
    assert tl.counters[0]["value"] == 2.5
    with tspans.section("train.data_pull"):
        pass
    assert len(tl.sections) == 1
    x = torch.ones(4)
    assert tspans.fence(x) is x


def test_timeline_records_equal_jax():
    """The same span sequence on the same clock: the same spans, steps,
    means and flight-shaped records."""
    tls = []
    for mod in (jspans, tspans):
        tl = _clocked(mod)
        for step in range(2):
            tl.begin_step(step)
            for ph in ("moe.gate", "moe.a2a_dispatch.0", "moe.expert.0",
                       "moe.a2a_dispatch.1", "moe.expert.1"):
                tl.span_exit(ph, tl.span_enter(ph))
            tl.end_step()
        with tl.section("train.checkpoint", step=1):
            pass
        tl.counter("moe.load_imbalance", 1.5, step=1)
        tls.append(tl)
    j, t = tls
    for attr in ("spans", "steps", "sections", "counters"):
        assert getattr(t, attr) == getattr(j, attr), attr
    assert t.phase_means() == j.phase_means()
    assert t.step_wall_means() == j.step_wall_means()
    assert t.step_records() == j.step_records()


# ----------------------------------------------------------------------
# predicted phases and the ledger
# ----------------------------------------------------------------------

JROW = {("local", 2): "local2", ("local", 4): "local4",
        ("local", 8): "local8", ("h100", 1): "h100", ("h100", 8): "h100"}


@pytest.fixture
def jax_rows(monkeypatch):
    """JAX's spec tables holding the port's rows for bf16; ``f32`` sets
    each peak to twice the port's f32 rate (JAX halves it)."""
    def patch(f32: bool):
        for (row, d), name in JROW.items():
            share = ttop.rank_share(row, d)
            lat, gbps = ttop._ICI_SPECS[row]
            peak = (2 * ttop._F32_TFLOPS[row] if f32
                    else ttop._PEAK_TFLOPS[row])
            monkeypatch.setitem(jtop._PEAK_TFLOPS, name, peak * share)
            monkeypatch.setitem(jtop._HBM_GBPS, name,
                                ttop._HBM_GBPS[row] * share)
            monkeypatch.setitem(jtop._ICI_SPECS, name, (lat, gbps * share))
        monkeypatch.setattr(jtop, "_DCN_SPEC", ttop._DCN_SPEC)
    return patch


PRED = [
    # (row, d, path, slices, config fields)
    ("local", 8, "collective", 1, {}),
    ("local", 8, "ragged", 1, dict(num_experts=16, a2a_chunks=2,
                                   wire_dtype="e4m3")),
    ("local", 4, "hierarchical", 2, dict(wire_dtype_dcn="e4m3")),
    ("local", 2, "collective", 1, dict(wire_dtype_combine="bf16")),
    ("h100", 8, "collective", 2, dict(num_experts=32, a2a_chunks=4)),
    ("h100", 1, "collective", 1, {}),
]


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("row,d,path,slices,fields", PRED,
                         ids=[f"{r}{d}-{p}" for r, d, p, *_ in PRED])
def test_predicted_phase_ms_equals_jax(jax_rows, dtype, row, d, path,
                                       slices, fields):
    jax_rows(dtype == "f32")
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    kw = {**dict(num_experts=8, expert_top_k=2, hidden_size=4096,
                 intermediate_size=14336, sequence_len=8192, ep=d,
                 gated_ffn=True), **fields}
    if dtype == "f32" and "wire_dtype_combine" in kw:
        kw.pop("wire_dtype_combine")
    jc = JaxConfig(dtype=jd, param_dtype=jd, **kw)
    tc = _to_port(jc)
    want = jledger.predicted_phase_ms(jc, d, JROW[(row, d)], path=path,
                                      slices=slices,
                                      links=ttop.link_count(row),
                                      mxu_fraction=0.7)
    got = tledger.predicted_phase_ms(tc, d, row, path=path, slices=slices,
                                     mxu_fraction=0.7)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-9, err_msg=k)


def test_fused_prediction_prices_the_kernel_span():
    tc = MoEConfig(num_experts=8, expert_top_k=2, hidden_size=4096,
                   intermediate_size=14336, sequence_len=8192, ep=8,
                   dtype=torch.bfloat16, gated_ffn=True)
    pred = tledger.predicted_phase_ms(tc, 8, "local", path="fused")
    assert pred["moe.fused_kernel"] == pytest.approx(
        pred["moe.expert"] + pred["moe.a2a_dispatch"]
        + pred["moe.a2a_combine"], rel=1e-12)


def test_phase_ledger_rows_and_decisions_equal_jax(jax_rows, monkeypatch):
    jax_rows(False)
    kw = dict(num_experts=16, expert_top_k=2, hidden_size=64,
              intermediate_size=128, sequence_len=512, ep=8,
              a2a_chunks=2)
    jc = JaxConfig(dtype=jnp.bfloat16, param_dtype=jnp.bfloat16, **kw)
    out = []
    for mod, sp, tel, cfg, gen, links in (
            (jledger, jspans, jtel, jc, "local8", 1),
            (tledger, tspans, ttel, _to_port(jc), "local", None)):
        m = tel.Metrics()
        monkeypatch.setattr(tel, "metrics", m)
        if mod is jledger:
            from flashmoe_tpu.planner import drift
        else:
            from flashmoe_tpu_torch.planner import drift
        monkeypatch.setattr(drift, "metrics", m)
        tl = _clocked(sp)
        tl.begin_step(0)
        for ph in ("moe.gate", "moe.dispatch", "moe.a2a_dispatch.0",
                   "moe.expert.0", "moe.a2a_combine.0",
                   "moe.a2a_dispatch.1", "moe.expert.1",
                   "moe.a2a_combine.1", "moe.combine"):
            tl.span_exit(ph, tl.span_enter(ph))
        tl.end_step()
        tl.overlapped_ms = 1.0
        kwl = {} if links is None else dict(links=links)
        rows, overlap = mod.phase_ledger(tl, cfg, d=8, gen=gen,
                                         path="collective", **kwl)
        out.append((rows, overlap, m.decisions))
    (jr, jo, jd), (tr, to, td) = out
    strip = lambda r: {k: v for k, v in r.items() if k != "gen"}  # noqa
    assert [strip(r) for r in tr] == [strip(r) for r in jr]
    assert strip(to) == strip(jo)
    assert [strip(d) for d in td] == [strip(d) for d in jd]
    assert [r["phase"] for r in tr] == ["moe.gate", "moe.a2a_dispatch",
                                        "moe.expert", "moe.a2a_combine"]


def test_ledger_matrix_quick_point_on_the_cpu(tmp_path):
    recs = tledger.run_ledger_matrix(str(tmp_path), quick=True,
                                     overlapped=True)
    assert len(recs) == 1
    rec = recs[0]
    assert set(rec["phases"]) == {"moe.gate", "moe.a2a_dispatch",
                                  "moe.expert", "moe.a2a_combine"}
    assert rec["step_ms"] >= rec["value"] > 0
    assert rec["overlapped_ms"] > 0 and rec["overlap"] is not None
    doc = json.loads((tmp_path / "trace.json").read_text())
    assert texport.validate_trace(doc) == []
    assert (tmp_path / "ledger.jsonl").read_text().count("\n") == 5


# ----------------------------------------------------------------------
# trace documents
# ----------------------------------------------------------------------

def _toy(mod, label):
    tl = _clocked(mod, label)
    tl.begin_step(0)
    for ph in ("moe.gate", "moe.expert.0", "moe.expert.1"):
        tl.span_exit(ph, tl.span_enter(ph))
    tl.end_step()
    with tl.section("train.checkpoint", step=0):
        pass
    tl.counter("moe.load_imbalance", 1.5, step=0)
    return tl


def test_trace_documents_equal_jax(tmp_path):
    jdoc = jexport.trace_document([_toy(jspans, "a"), _toy(jspans, "b")],
                                  labels=["one", "two"])
    tdoc = texport.trace_document([_toy(tspans, "a"), _toy(tspans, "b")],
                                  labels=["one", "two"])
    assert tdoc["traceEvents"] == jdoc["traceEvents"]
    assert tdoc["displayTimeUnit"] == jdoc["displayTimeUnit"]
    assert texport.chrome_trace_events(_toy(tspans, "a"), pid=3) == \
        jexport.chrome_trace_events(_toy(jspans, "a"), pid=3)
    doc = texport.write_trace(_toy(tspans, "a"), str(tmp_path / "t.json"))
    assert json.loads((tmp_path / "t.json").read_text()) == doc


def _traced(mod):
    """One request drill on an injected clock: queue, admit, prefill,
    two decode steps, an eviction, a resumed prefill, retire (a
    millisecond a clock read)."""
    clock = Clock(1e-3)
    tr = mod.RequestTracer(clock=clock)
    tr.on_arrival(0)
    tr.on_arrival(1)
    tr.begin_step(0, [])
    tr.on_admit(0, 0, resumed=False)
    tr.span_exit("serve.prefill", tr.span_enter("serve.prefill"))
    tr.end_step()
    for step in (1, 2):
        tr.begin_step(step, [0])
        if step == 2:
            tr.on_admit(1, step, resumed=False)
            tr.span_exit("serve.prefill", tr.span_enter("serve.prefill"))
        tr.span_exit("serve.decode", tr.span_enter("serve.decode"))
        tr.end_step()
    tr.begin_step(3, [0, 1])
    tr.on_evict(1, 3)
    tr.span_exit("serve.decode", tr.span_enter("serve.decode"))
    tr.on_retire(0, 3, tokens=3, ttft_ms=1.0, tpot_ms=0.5)
    tr.end_step()
    tr.begin_step(4, [])
    tr.on_admit(1, 4, resumed=True)
    tr.span_exit("serve.prefill", tr.span_enter("serve.prefill"))
    tr.on_retire(1, 4, tokens=2)
    tr.end_step()
    return tr


def test_request_trace_documents_equal_jax(tmp_path):
    jt, tt = _traced(jtracing), _traced(ttracing)
    jdoc = jexport.request_trace_document(
        jt, timelines=[_toy(jspans, "p")], labels=["phases"])
    tdoc = texport.request_trace_document(
        tt, timelines=[_toy(tspans, "p")], labels=["phases"])
    assert tdoc["traceEvents"] == jdoc["traceEvents"]
    assert texport.request_trace_events(tt, base_pid=7) == \
        jexport.request_trace_events(jt, base_pid=7)
    texport.write_request_trace(tt, str(tmp_path / "r.json"))
    assert texport.validate_trace(
        json.loads((tmp_path / "r.json").read_text())) == []


BAD = [
    {"nope": 1},
    {"traceEvents": "x"},
    {"traceEvents": [7]},
    {"traceEvents": [{"ph": "Q", "name": "x", "pid": 0}]},
    {"traceEvents": [{"ph": "X", "name": "", "pid": "0", "tid": 0,
                      "ts": 1.0, "dur": 1}]},
    {"traceEvents": [{"ph": "X", "name": "x", "pid": 0, "tid": 0,
                      "ts": 1.0, "dur": 0}]},
    {"traceEvents": [{"ph": "X", "name": "x", "pid": 0, "ts": -5,
                      "dur": 1}]},
    {"traceEvents": [{"ph": "C", "name": "c", "pid": 0, "ts": 1.0,
                      "args": {"value": "high"}}]},
    {"traceEvents": [{"ph": "M", "name": "m", "pid": 0}]},
    {"traceEvents": [{"ph": "s", "name": "f", "pid": 0, "ts": 1.0}]},
    {"traceEvents": [{"ph": "X", "name": "x", "pid": 0, "tid": 0,
                      "ts": 1.0, "dur": 1, "args": {"v": {1, 2}}}]},
]


@pytest.mark.parametrize("doc", BAD, ids=[str(i) for i in range(len(BAD))])
def test_validate_trace_rejects_what_jax_rejects(doc):
    got = texport.validate_trace(doc)
    assert got and got == jexport.validate_trace(doc)


# ----------------------------------------------------------------------
# the SLO watchdog
# ----------------------------------------------------------------------

STEPS = [(3.0, None), (50.0, {"moe.expert": 7.0}), (50.0, None),
         (60.0, {"moe.expert": 9.0}), (2.0, {"moe.expert": 1.0}),
         (11.0, None), (12.0, None), (4.0, None), (20.0, None)]


def test_slo_decision_stream_equals_jax():
    streams, failed = [], []
    for slo, tel, sel in ((jslo, jtel, jselect), (tslo, ttel, tselect)):
        sel.reset_path_failures()
        m = tel.Metrics()
        wd = slo.SLOWatchdog(slo.SLOConfig(
            step_ms=10.0, consecutive=2, demote_backend="fused",
            phase_ms=(("moe.expert", 5.0),), ttft_ms=20.0, tpot_ms=2.0),
            m)
        try:
            for i, (ms, phases) in enumerate(STEPS):
                wd.observe_step(i, ms, phases=phases)
            wd.observe_request(9, 3, ttft_ms=25.0, tpot_ms=1.0,
                               dominant="prefill")
            wd.observe_request(9, 4, ttft_ms=5.0, tpot_ms=2.5)
            streams.append((m.decisions, dict(m.counters), wd.snapshot()))
            failed.append(sorted(sel.failed_backends()))
        finally:
            sel.reset_path_failures()
    assert streams[1] == streams[0]
    assert failed[1] == failed[0] == ["fused"]


YAML = """
# budgets for the nightly job
step_ms: 250
consecutive: 2
demote_backend: ragged
ttft_ms:
phase_ms:
  moe.expert: 120
  moe.a2a_dispatch: 40.5   # the exchange
"""


def test_slo_yaml_and_fallback_parser_equal_jax(tmp_path, monkeypatch):
    assert tslo._parse_flat_yaml(YAML) == jslo._parse_flat_yaml(YAML)
    for bad in ("key only", "  indented: 1"):
        with pytest.raises(ValueError) as te:
            tslo._parse_flat_yaml(bad)
        with pytest.raises(ValueError) as je:
            jslo._parse_flat_yaml(bad)
        assert str(te.value) == str(je.value)
    p = tmp_path / "slo.yaml"
    p.write_text(YAML)
    with_yaml = tslo.SLOConfig.from_yaml(str(p))
    monkeypatch.setitem(sys.modules, "yaml", None)  # the fallback arm
    fallback = tslo.SLOConfig.from_yaml(str(p))
    want = jslo.SLOConfig.from_yaml(str(p))
    assert dataclasses.asdict(fallback) == dataclasses.asdict(want)
    assert dataclasses.asdict(with_yaml) == dataclasses.asdict(want)
    for raw in ({"step_milliseconds": 5}, {"phase_ms": [1]},
                {"phase_ms": {"a": "x"}}, {"step_ms": [1]}):
        with pytest.raises(ValueError) as te:
            tslo.SLOConfig.from_dict(raw)
        with pytest.raises(ValueError) as je:
            jslo.SLOConfig.from_dict(raw)
        assert str(te.value) == str(je.value)


# ----------------------------------------------------------------------
# postmortem bundles
# ----------------------------------------------------------------------

def test_postmortem_bundle_roundtrip_with_jax_layout(tmp_path):
    kw = dict(num_experts=4, expert_top_k=2, hidden_size=64,
              intermediate_size=128, sequence_len=16)
    bundles = []
    for pm, tel, sp, cfg in ((jpm, jtel, jspans, JaxConfig(**kw)),
                             (tpm, ttel, tspans, MoEConfig(**kw))):
        m = tel.Metrics()
        m.decision("planner.path_select", backend="ragged")
        try:
            raise RuntimeError("synthetic crash for the bundle test")
        except RuntimeError as e:
            b = pm.write_bundle(
                str(tmp_path / pm.__name__), error=e, cfg=cfg,
                metrics_obj=m, history=[{"loss": 1.5}, {"loss": 1.25}],
                timeline=_toy(sp, "pm"), step=7, extra={"retries": 3})
        assert pm.find_bundles(str(tmp_path / pm.__name__)) == [b]
        bundles.append(pm.load_bundle(b))
    j, t = bundles
    assert set(t) == set(j)
    assert set(t["manifest"]) == set(j["manifest"])
    assert t["manifest"]["files"] == j["manifest"]["files"]
    for k in ("step", "error", "extra", "bundle_version"):
        assert t["manifest"][k] == j["manifest"][k]
    assert t["flight"] == j["flight"]
    assert t["config"]["num_experts"] == 4
    assert "RuntimeError" in t["traceback"]
    assert texport.validate_trace(t["trace"]) == []
    assert t["trace"]["traceEvents"] == j["trace"]["traceEvents"]
    run = [[{k: v for k, v in d.items() if k != "dir"}
            for d in b["decisions"] if d["stream"] == "run"]
           for b in (j, t)]
    assert run[1] == run[0]
    assert any(d["decision"] == "postmortem.saved" for d in run[1])
    assert {"python", "torch", "cuda", "backend", "device_count"} <= \
        set(t["env"])
    assert t["planner"]["last_path_select"]["backend"] == "ragged"
    with pytest.raises(FileNotFoundError):
        tpm.load_bundle(str(tmp_path))


# ----------------------------------------------------------------------
# the layers' phase spans
# ----------------------------------------------------------------------

LAYERS = {
    "collective": (tep.ep_moe_layer, dict(collect_stats=True),
                   {"moe.gate", "moe.dispatch", "moe.a2a_dispatch",
                    "moe.expert", "moe.a2a_combine", "moe.combine"}),
    "collective_chunked": (tep.ep_moe_layer, dict(a2a_chunks=2),
                           {"moe.gate", "moe.dispatch", "moe.a2a_dispatch",
                            "moe.expert", "moe.a2a_combine",
                            "moe.combine"}),
    "ragged": (ragged_ep_moe_layer, dict(drop_tokens=False),
               {"moe.gate", "moe.dispatch", "moe.a2a_dispatch",
                "moe.expert", "moe.a2a_combine", "moe.combine"}),
    # at this size the combine runs outside the kernel
    "fused": (fused_ep_moe_layer, {},
              {"moe.gate", "moe.dispatch", "moe.fused_kernel",
               "moe.combine"}),
    "fused_degrade": (fused_ep_moe_layer,
                      dict(degrade_unhealthy_experts=True),
                      {"moe.gate", "moe.dispatch", "moe.fused_kernel",
                       "moe.combine"}),
}


@pytest.mark.parametrize("name", list(LAYERS))
def test_layers_bit_equal_under_profiling(name):
    layer, fields, phases = LAYERS[name]
    cfg = MoEConfig(num_experts=8, expert_top_k=2, hidden_size=64,
                    intermediate_size=64, sequence_len=128, ep=4,
                    dtype=torch.float32, param_dtype=torch.float32,
                    **fields)
    p = params_from_numpy(moe_params(cfg, seed=5), device="cpu")
    x = torch.from_numpy(tokens(cfg, seed=5))
    mesh = local_mesh(4)
    base = layer(p, x, cfg, mesh)
    on = cfg.replace(profile_phases=True)
    unarmed = layer(p, x, on, mesh)
    tl = tspans.PhaseTimeline()
    with tspans.profiling(tl):
        tl.begin_step(0)
        armed = layer(p, x, on, mesh)
        rec = tl.end_step()
    for o in (unarmed, armed):
        assert torch.equal(o.out, base.out)
        assert torch.equal(o.aux_loss, base.aux_loss)
        assert torch.equal(o.expert_counts, base.expert_counts)
    assert set(rec["phases"]) == phases
    names = [s["name"] for s in tl.spans]
    if cfg.a2a_chunks:
        assert {"moe.expert.0", "moe.expert.1"} <= set(names)
    assert all(v >= 0 for v in rec["phases"].values())
    assert sum(rec["phases"].values()) <= rec["wall_ms"] + 1e-6


def test_profile_moe_phases_on_the_cpu():
    cfg = MoEConfig(num_experts=8, expert_top_k=2, hidden_size=64,
                    intermediate_size=64, sequence_len=128, ep=4,
                    dtype=torch.float32, param_dtype=torch.float32,
                    drop_tokens=False)
    rec = ttel.FlightRecorder()
    for path in ("collective", "ragged", "fused"):
        tl = tledger.profile_moe_phases(cfg, local_mesh(4), path=path,
                                        steps=2, recorder=rec)
        assert len(tl.steps) == 2 and tl.overlapped_ms > 0
        assert "moe.gate" in tl.phase_means()
        assert tl.meta["path"] == path
    assert len(rec) == 6
