"""PyTorch port: the serving fabric (``flashmoe_tpu_torch/fabric/``,
``serving/pools.py``, the engine's fabric seams) against the JAX
package's (``flashmoe_tpu/fabric/``) on the CPU.

The same numpy weights (``convert.params_from_numpy``) and requests go
through both.  The mock parse and its errors, the router's decision
streams, the KV codec (wire off: the same tensors; e4m3: bit-equal to
JAX's eager encode) and the pool plans equal JAX's exactly; the handoff's
decisions equal JAX's with ``kv_handoff_ms`` at rtol 1e-9 (JAX's tables
patched to the port's rows).  The acceptance drill runs a 2-replica
fabric with pools (JAX: 8 CPU devices; the port: a runtime of 8 virtual
ranks) over one trace: the greedy streams equal JAX's fabric's, every
stream equals the port's single engine's, and ``/healthz`` and ``/vars``
have JAX's shapes.  JAX's fabric runs once, in a module fixture.  The
sampler differs from JAX's (``serving/engine.py``), so sampled streams
are held to the port's own engine only."""

import copy
import json
import os
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashmoe_tpu.fabric import engine as jfeng
from flashmoe_tpu.fabric import frontdoor as jfd
from flashmoe_tpu.fabric import handoff as jho
from flashmoe_tpu.fabric import router as jrouter
from flashmoe_tpu.fabric import topo as jtopo
from flashmoe_tpu.fabric import vclock as jvclock
from flashmoe_tpu.parallel import topology as jtop
from flashmoe_tpu.runtime import controller as jctl
from flashmoe_tpu.serving import engine as jeng
from flashmoe_tpu.serving import pools as jpools
from flashmoe_tpu.utils.telemetry import Metrics as JaxMetrics
from flashmoe_tpu_torch.fabric import engine as tfeng
from flashmoe_tpu_torch.fabric import frontdoor as tfd
from flashmoe_tpu_torch.fabric import handoff as tho
from flashmoe_tpu_torch.fabric import router as trouter
from flashmoe_tpu_torch.fabric import topo as ttopo
from flashmoe_tpu_torch.fabric import vclock as tvclock
from flashmoe_tpu_torch.parallel import topology as ttop
from flashmoe_tpu_torch.runtime import bootstrap as tboot
from flashmoe_tpu_torch.runtime import controller as tctl
from flashmoe_tpu_torch.serving import engine as teng
from flashmoe_tpu_torch.serving import pools as tpools
from flashmoe_tpu_torch.utils.telemetry import Metrics

from test_torch_planner import (_fresh_planner, jax_rows,  # noqa: F401
                                port_model)
from test_torch_serving import (JCFG, TCFG, both_requests, numpy_params,
                                prompt_rows)

RTOL = 1e-9
ENV = ttopo.ENV_MOCK_FABRIC
SERVE = dict(max_batch=4, page_size=8, num_pages=8, max_pages_per_slot=4,
             ctx_bucket_pages=1, prompt_bucket=8)
ARRIVALS = [0, 0, 0, 0, 1, 1, 2, 3]


@pytest.fixture(scope="module")
def weights():
    tree = numpy_params()
    from flashmoe_tpu_torch.convert import params_from_numpy

    return (jax.tree_util.tree_map(jnp.asarray, tree),
            params_from_numpy(tree, device="cpu"))


class _Env:
    """Set (or unset) an environment variable for a block."""

    def __init__(self, name, value):
        self.name, self.value = name, value

    def __enter__(self):
        self.saved = os.environ.get(self.name)
        if self.value is None:
            os.environ.pop(self.name, None)
        else:
            os.environ[self.name] = self.value

    def __exit__(self, *exc):
        if self.saved is None:
            os.environ.pop(self.name, None)
        else:
            os.environ[self.name] = self.saved


class _Runtime:
    """The port's runtime of ``n`` virtual CPU ranks for a block."""

    def __init__(self, n=8):
        self.n = n

    def __enter__(self):
        tboot.finalize()
        tboot.initialize(TCFG, devices=self.n, device="cpu")

    def __exit__(self, *exc):
        tboot.finalize()


def _mixed_requests(prompts, max_new=10):
    """Both packages' requests: even rids greedy, odd rids sampled."""
    out = []
    for mod in (jeng, teng):
        out.append([mod.Request(
            rid=i, prompt=tuple(int(t) for t in p), max_new_tokens=max_new,
            seed=100 + i,
            **({} if i % 2 == 0 else dict(temperature=0.8, top_k=20,
                                          top_p=0.9)))
            for i, p in enumerate(prompts)])
    return out


def _shape(doc):
    """A JSON document's shape: keys and value types, recursively (lists
    by their first element)."""
    if isinstance(doc, dict):
        return {k: _shape(v) for k, v in doc.items()}
    if isinstance(doc, (list, tuple)):
        return [_shape(doc[0])] if doc else []
    if isinstance(doc, bool) or doc is None:
        return type(doc).__name__
    if isinstance(doc, (int, float)):
        return "number"
    return type(doc).__name__


def _drive(fab, door, reqs, arrivals, scrape=False):
    """Submit through ``door`` and drive ``fab`` to the end; with
    ``scrape``, read ``/metrics`` once mid-run, after the first replica
    sketch exists and while work is in flight.  Returns (outputs, the
    scraped body or None)."""
    for req, arr in zip(reqs, arrivals):
        door.submit(req, arr)
    body = None
    if scrape:
        while fab.pending() and not any(
                k.endswith(".ttft_ms") and ".r" in k
                for k in fab.metrics.sketches):
            fab.step()
        assert fab.pending()
        url = f"http://127.0.0.1:{fab.telemetry.port}/metrics"
        with urllib.request.urlopen(url, timeout=5) as r:
            body = r.read().decode()
    while fab.pending():
        fab.step()
    out = {}
    for e in fab.engines:
        out.update(e.outputs)
    return out, body


@pytest.fixture(scope="module")
def jax_fabric(weights):
    """JAX's 2-replica fabric over the mixed trace, once: pools formed on
    the 8 CPU devices, a front door on a virtual clock of tick 1 ms."""
    reqs = _mixed_requests(prompt_rows(8, 8, seed=5))[0]
    with _Env(ENV, "2"):
        mx = JaxMetrics()
        vc = jvclock.VirtualClock(tick_ms=1.0)
        fab = jfeng.ServingFabric(weights[0], JCFG,
                                  jeng.ServeConfig(**SERVE),
                                  metrics_obj=mx, vclock=vc)
        door = jfd.FrontDoor(fab)
        try:
            out, _ = _drive(fab, door, reqs, ARRIVALS)
            doc = door.fleet_trace_document()
            return dict(out=out, summary=fab.summary(),
                        health=fab._health_snapshot(),
                        vars=json.loads(json.dumps(fab._vars_snapshot(),
                                                   default=str)),
                        doc=doc, decisions=list(mx.decisions),
                        pools=fab.pool_plan is not None)
        finally:
            door.close()
            fab.close()


# ----------------------------------------------------------------------
# The mocked topology
# ----------------------------------------------------------------------

def _parse(mod, n):
    try:
        return ("ok", mod._mock_fabric(n), mod.fabric_world(n))
    except ValueError as e:
        return ("err", str(e))


@pytest.mark.parametrize("value", [None, "", "1", "2", "4", "3", "x",
                                   "2.5", "0", "-2"])
def test_mock_fabric_parse_and_errors_equal_jax(value):
    with _Env(ENV, value):
        for n in (1, 2, 6, 8):
            assert _parse(ttopo, n) == _parse(jtopo, n)
        for mod in (jtopo, ttopo):
            with pytest.raises(ValueError, match=">= 1 device"):
                mod.fabric_world(0)


def test_fabric_world_counts_the_runtime_ranks():
    """Without a runtime the world is this process (one rank); with a
    runtime of 8 virtual ranks, 8 on the ``"local"`` row."""
    tboot.finalize()
    with _Env(ENV, "2"):
        assert ttopo.world_ranks() == ([ttop.world_nodes()[0]], None)
        assert ttopo.fabric_world() == (2, 1)
        with _Runtime(8):
            assert ttopo.world_ranks() == ([0] * 8, "local")
            assert ttopo.fabric_world() == jtopo.fabric_world(8) == (2, 4)


def test_fabric_package_exports_jax_names():
    import flashmoe_tpu.fabric as jfabric
    import flashmoe_tpu_torch.fabric as tfabric

    assert tfabric.__all__ == jfabric.__all__
    assert all(hasattr(tfabric, name) for name in tfabric.__all__)
    assert tfabric.WIRE_MODES == jfabric.WIRE_MODES


# ----------------------------------------------------------------------
# The router
# ----------------------------------------------------------------------

def _router_script(mod, metrics):
    """One placement script over scripted health (a raising probe, a
    drain, a failed replica, everyone draining); each step's result or
    error."""
    depth = [3, 1, 1, 0]
    down = set()

    def health(i):
        def fn():
            if i in down:
                raise RuntimeError("replica down")
            return {"queue_depth": depth[i], "active_requests": i % 2,
                    "ok": i != 2}
        return fn

    log = []
    for affinity in (False, True):
        r = mod.ReplicaRouter([health(i) for i in range(4)],
                              metrics_obj=metrics, affinity=affinity)
        for rid in range(6):
            log.append(r.route(rid=rid, session=("s%d" % (rid % 3)
                                                  if rid % 2 else None)))
            depth[rid % 4] += 1
        r.drain(1)
        down.add(3)
        log += [r.route(rid=10), r.route(rid=11, session="alice")]
        r.mark_failed(0)
        down.discard(3)
        for i in range(4):
            r.drain(i)
        log += [r.route(rid=12), r.draining(), r.failed()]
        r.undrain(1)
        log += [r.route(rid=13, session="bob"), r.snapshot()]
        for bad in (lambda: r.drain(9), lambda: mod.ReplicaRouter([])):
            try:
                bad()
            except ValueError as e:
                log.append(str(e))
    return log


def test_router_decision_streams_equal_jax():
    jm, tm = JaxMetrics(), Metrics()
    assert _router_script(trouter, tm) == _router_script(jrouter, jm)
    assert tm.decisions == jm.decisions
    assert tm.counters["fabric.routed"] == jm.counters["fabric.routed"]


# ----------------------------------------------------------------------
# The KV codec and the handoff
# ----------------------------------------------------------------------

def _kv_run(seed, l=2, nkv=2, t=16, d=8):
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((l, nkv, t, d)).astype(np.float32)
    v = rng.standard_normal((l, nkv, t, d)).astype(np.float32)
    k[:, :, 12:] = 0.0                       # a padded tail
    return k, v


def test_kv_codec_off_is_the_same_tensors():
    k, v = (torch.from_numpy(a) for a in _kv_run(0))
    p = tho.encode_kv_run(k, v, 8, None)
    assert (p.wire, p.pages, p.k_qscale, p.v_qscale) == ("off", 2, None,
                                                         None)
    ko, vo = tho.decode_kv_run(p, torch.float32)
    assert ko is k and vo is v
    assert p.payload_bytes == 2 * k.numel() * 4


@pytest.mark.parametrize("wire", ["e4m3", "e5m2", "bf16"])
def test_kv_codec_bit_equal_to_jax_eager_encode(wire):
    k, v = _kv_run(2)
    jp = jho.encode_kv_run(jnp.asarray(k), jnp.asarray(v), 8,
                           jho.wr.resolve(wire))
    tp = tho.encode_kv_run(torch.from_numpy(k), torch.from_numpy(v), 8,
                           tho.wr.resolve(wire))
    assert (tp.wire, tp.pages, tp.shape, tp.payload_bytes) == \
        (jp.wire, jp.pages, jp.shape, jp.payload_bytes)
    for a, b in ((tp.k, jp.k), (tp.v, jp.v)):
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b.astype(jnp.float32)))
    for a, b in ((tp.k_qscale, jp.k_qscale), (tp.v_qscale, jp.v_qscale)):
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    decoded = tho.decode_kv_run(tp, torch.float32)
    for a, b in zip(decoded, jho.decode_kv_run(jp, jnp.float32)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert not decoded[0][:, :, 12:].any()    # zeros stay exact


def test_kv_codec_refuses_partial_pages():
    k, v = _kv_run(4, t=12)
    msgs = []
    for mod, arr in ((jho, jnp.asarray), (tho, torch.from_numpy)):
        with pytest.raises(ValueError, match="whole pages") as e:
            mod.encode_kv_run(arr(k), arr(v), 8, mod.wr.resolve("e4m3"))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def _handoff_decisions(mod, params, cfg, prompt_fn, wire, vclock_mod):
    mx = (JaxMetrics if mod is jho else Metrics)()
    vc = vclock_mod.VirtualClock(tick_ms=0.02)
    ho = mod.KVHandoff(params, cfg, 8, wire=wire, metrics_obj=mx,
                       decode_step_ms=0.02, vclock=vc)
    outs = []
    for rid, (t_pad, t0) in enumerate(((8, 8), (16, 11), (24, 20))):
        prompt = np.random.default_rng(rid).integers(
            0, cfg.vocab_size, (1, t_pad))
        outs.append(ho.prefill(prompt_fn(prompt), t0, replica=rid % 2,
                               rid=rid))
        vc.complete_step()
    return mx.decisions, ho.snapshot(), outs, vc.snapshot()


_PRICED = ("modeled_dcn_ms", "measured_dcn_ms", "modeled_ms_total",
           "measured_ms_total", "hidden_ms_total", "hidden_ms",
           "exposed_ms", "hidden_frac_measured", "hidden_frac_priced",
           "lane_s")


def _split_ms(recs):
    """(records without the priced times, the priced times flat)."""
    recs = copy.deepcopy(recs)
    times = []
    for r in recs:
        for k in _PRICED:
            if k in r:
                v = r.pop(k)
                times.extend(v if isinstance(v, list) else [v])
    return recs, times


@pytest.mark.parametrize("wire", [None, "e4m3"])
def test_kv_handoff_decisions_equal_jax(weights, jax_rows, wire):
    """Decisions, snapshots and the decoded KV equal JAX's; the priced
    times at rtol 1e-9 (JAX's DCN row patched to the port's)."""
    jd, js, jo, jv = _handoff_decisions(jho, weights[0], JCFG,
                                        jnp.asarray, wire, jvclock)
    td, ts, to, tv = _handoff_decisions(tho, weights[1], TCFG,
                                        torch.from_numpy, wire, tvclock)
    for got, want in ((td, jd), ([ts, tv], [js, jv])):
        g, gt = _split_ms(got)
        w, wt = _split_ms(want)
        assert g == w
        np.testing.assert_allclose(np.asarray(gt, dtype=float),
                                   np.asarray(wt, dtype=float), rtol=RTOL)
    assert sum(d["decision"] == "fabric.handoff_drift" for d in td) == 3
    for (tl, tk, tvv), (jl, jk, jvv) in zip(to, jo):
        assert tk.shape == tuple(jk.shape)   # [L, N_kv, T_pad, D]
        for a, b in ((tl, jl), (tk, jk), (tvv, jvv)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=2e-4, atol=2e-4)


# ----------------------------------------------------------------------
# The pool plan
# ----------------------------------------------------------------------

def _pool_world(n=8, slow=()):
    """One adjacency and worker list, for both packages."""
    adj = ttop.ici_adjacency([0] * n, platform="local")
    rates = [0.5 if i in slow else 1.0 + 0.01 * i for i in range(n)]
    return ((jtop.Adjacency(alpha=np.array(adj.alpha),
                            beta=np.array(adj.beta)),
             [jtop.WorkerAttr(throughput=r, memory_gb=80.0)
              for r in rates]),
            (adj, [ttop.WorkerAttr(throughput=r, memory_gb=80.0)
                   for r in rates]))


@pytest.mark.parametrize("share,slow,over", [
    (0.5, (), None), (0.3, (1, 2), None), (0.7, (0,),
                                           {"expert_quant": "int8"})])
def test_plan_serving_pools_snapshots_equal_jax(port_model, monkeypatch,
                                                share, slow, over):
    from flashmoe_tpu import tuning as jtuning
    from flashmoe_tpu_torch import tuning as ttuning

    monkeypatch.setattr(jtuning, "generation", lambda *a, **k: "h100")
    monkeypatch.setattr(ttuning, "generation", lambda *a, **k: "h100")
    (jadj, jw), (tadj, tw) = _pool_world(slow=slow)
    jm, tm = JaxMetrics(), Metrics()
    monkeypatch.setattr(jpools, "_metrics", jm)
    monkeypatch.setattr(tpools, "_metrics", tm)
    kw = dict(decode_share=share, decode_tokens=4, decode_overrides=over,
              prefill_overrides={"kv_wire_dtype": "bf16"})
    jp = jpools.plan_serving_pools(jadj, jw, JCFG, devices=jax.devices(),
                                   **kw)
    tp = tpools.plan_serving_pools(tadj, tw, TCFG, devices=[0] * 8, **kw)
    assert tp.snapshot() == jp.snapshot()
    assert tm.decisions == jm.decisions
    # without devices: the split and its prices alone
    jp = jpools.plan_serving_pools(jadj, jw, JCFG, record=False,
                                   decode_share=share)
    tp = tpools.plan_serving_pools(tadj, tw, TCFG, record=False,
                                   decode_share=share)
    assert tp.snapshot() == jp.snapshot()
    for mod, adj, w, cfg in ((jpools, jadj, jw, JCFG),
                             (tpools, tadj, tw, TCFG)):
        with pytest.raises(ValueError, match="decode_share"):
            mod.plan_serving_pools(adj, w, cfg, decode_share=1.0)


def test_plan_serving_pools_refuses_one_device():
    msgs = []
    for mod, top, cfg in ((jpools, jtop, JCFG), (tpools, ttop, TCFG)):
        adj = top.Adjacency(alpha=np.zeros((1, 1)), beta=np.zeros((1, 1)))
        with pytest.raises(ValueError, match=">= 2 devices") as e:
            mod.plan_serving_pools(adj, [top.WorkerAttr(1.0, 80.0)], cfg)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# ----------------------------------------------------------------------
# The engine's seams
# ----------------------------------------------------------------------

def test_engine_seams_run(weights):
    """A handed-off prefill gives the local prefill's tokens (and skips
    chunking); replica sketches, pools in /vars, the five heartbeat
    phases a step, and evacuate / adopt moving requests between two
    engines with the tokens of an uninterrupted run."""
    params = weights[1]
    reqs = both_requests(prompt_rows(4, 12, seed=7), 6)[1]
    serve = teng.ServeConfig(**dict(SERVE, num_pages=32,
                                    prefill_chunk=8))
    want = teng.ServingEngine(params, TCFG, serve,
                              metrics_obj=Metrics()).run(reqs)
    calls, beats = [], []

    def prefill_fn(prompt, t0, *, rid=None):
        calls.append((tuple(prompt.shape), t0, rid))
        return teng._prefill_padded(params, TCFG, prompt, t0)

    mx = Metrics()
    eng = teng.ServingEngine(params, TCFG, serve, metrics_obj=mx,
                             prefill_fn=prefill_fn, replica_tag="r3",
                             pools_info={"decode_ms": 1.5},
                             heartbeat_fn=beats.append)
    assert eng.run(reqs) == want
    assert calls == [((1, 16), 12, r.rid) for r in reqs]
    assert eng.stats["prefill_buckets"] == {16}    # whole, not chunked
    assert beats[:5] == ["admit", "prefill", "sample", "decode", "end"]
    assert len(beats) == 5 * eng.stats["steps"]
    assert mx.sketches["serve.r3.ttft_ms"].n == 4
    assert eng._health_snapshot()["replica"] == "r3"
    v = eng._vars_snapshot()
    assert v["replica"] == "r3" and v["pools"] == {"decode_ms": 1.5}
    # crash migration: evacuate one engine mid-run, adopt elsewhere
    a = teng.ServingEngine(params, TCFG, serve, metrics_obj=Metrics())
    b = teng.ServingEngine(params, TCFG, serve, metrics_obj=Metrics())
    for r in reqs:
        a.submit(r)
    for _ in range(3):
        a.step()
    inflight, queued = a.evacuate()
    assert not a.pending() and inflight
    assert all(len(e.req.prompt) > len(e.orig.prompt) for e in inflight)
    for e in reversed(inflight):
        b.adopt(e, front=True)
    for e in queued:
        b.adopt(e)
    assert b.stats["adopted"] == len(inflight) + len(queued)
    out = {**a.outputs, **b.run()}
    assert out == want


# ----------------------------------------------------------------------
# The acceptance drill
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_fabric(weights):
    """The port's twin of :func:`jax_fabric` (a runtime of 8 virtual
    ranks), with the scrape server on, plus its single engine."""
    reqs = _mixed_requests(prompt_rows(8, 8, seed=5))[1]
    single = teng.ServingEngine(weights[1], TCFG,
                                teng.ServeConfig(**SERVE),
                                metrics_obj=Metrics()).run(reqs, ARRIVALS)
    with _Env(ENV, "2"), _Runtime(8):
        mx = Metrics()
        vc = tvclock.VirtualClock(tick_ms=1.0)
        fab = tfeng.ServingFabric(weights[1], TCFG,
                                  teng.ServeConfig(**SERVE),
                                  metrics_obj=mx, vclock=vc,
                                  telemetry_port=0)
        door = tfd.FrontDoor(fab)
        try:
            out, body = _drive(fab, door, reqs, ARRIVALS, scrape=True)
            return dict(out=out, single=single, body=body, reqs=reqs,
                        summary=fab.summary(),
                        health=fab._health_snapshot(),
                        vars=json.loads(json.dumps(fab._vars_snapshot(),
                                                   default=str)),
                        doc=door.fleet_trace_document(),
                        trace_errors=door.validate(),
                        decisions=list(mx.decisions),
                        pools=fab.pool_plan is not None)
        finally:
            door.close()
            fab.close()


def test_fabric_drill_streams_equal_jax_and_the_single_engine(
        jax_fabric, port_fabric):
    t, j = port_fabric, jax_fabric
    assert t["pools"] and j["pools"]
    assert t["out"] == t["single"]
    greedy = [r.rid for r in t["reqs"] if r.temperature <= 0]
    assert {r: t["out"][r] for r in greedy} == \
        {r: j["out"][r] for r in greedy}
    s = t["summary"]
    assert s["handoffs"] >= 8 and sum(s["routed"]) == 8
    assert sum(e["evictions"] for e in s["engines"]) >= 1
    assert sum(e["completed"] for e in s["engines"]) == 8
    assert 'flashmoe_serve_r0_ttft_ms{quantile="' in t["body"] \
        or 'flashmoe_serve_r1_ttft_ms{quantile="' in t["body"]
    assert t["trace_errors"] == []
    handoffs = [d for d in t["decisions"]
                if d["decision"] == "fabric.handoff"]
    assert len(handoffs) == s["handoffs"]
    assert all(d["modeled_dcn_ms"] > 0 for d in handoffs)


def test_fabric_health_and_vars_shapes_equal_jax(jax_fabric, port_fabric):
    assert _shape(port_fabric["health"]) == _shape(jax_fabric["health"])
    tv, jv = port_fabric["vars"], jax_fabric["vars"]
    assert _shape(tv) == _shape(jv)
    assert tv["replicas"] == jv["replicas"] == 2
    assert tv["pools"] is not None


def test_fabric_placements_and_fleet_trace_equal_jax(jax_fabric,
                                                     port_fabric):
    """The router's placements and the fleet document's structure
    (every event but the times, which the pool plan's pricing moves)
    equal JAX's."""
    def route(decs):
        return [(d["rid"], d["replica"], d["policy"]) for d in decs
                if d["decision"] == "fabric.route"]

    assert route(port_fabric["decisions"]) == route(jax_fabric["decisions"])
    assert port_fabric["summary"]["placement"] == \
        jax_fabric["summary"]["placement"]

    def untimed(doc):
        return [{k: v for k, v in e.items() if k not in ("ts", "dur")}
                for e in doc["traceEvents"]]

    assert untimed(port_fabric["doc"]) == untimed(jax_fabric["doc"])
    assert port_fabric["doc"]["otherData"] == {
        "producer": "flashmoe_tpu_torch.fabric"}


def test_fabric_refuses_what_jax_refuses(weights):
    from flashmoe_tpu_torch.chaos import FaultPlan

    msgs = []
    for mod, params, cfg, eng, plan in (
            (tfeng, weights[1], TCFG, teng, FaultPlan),
            (jfeng, weights[0], JCFG, jeng,
             __import__("flashmoe_tpu.chaos",
                        fromlist=["FaultPlan"]).FaultPlan)):
        got = []
        for kw in (dict(fault_plan=plan("nan_grad")),
                   dict(fault_plan=plan("replica_stall")),
                   dict(replicas=0)):
            with pytest.raises(ValueError) as e:
                mod.ServingFabric(params, cfg, eng.ServeConfig(**SERVE),
                                  metrics_obj=Metrics(), **kw)
            got.append(str(e.value))
        msgs.append(got)
    assert msgs[0] == msgs[1]


def test_fabric_controller_drains_the_idle_replica(weights):
    """An armed controller watching an idle fabric drains the highest-id
    replica through the router, as JAX's does."""
    got = []
    for ctl_mod, fab_mod, eng, params, cfg, metrics in (
            (tctl, tfeng, teng, weights[1], TCFG, Metrics),
            (jctl, jfeng, jeng, weights[0], JCFG, JaxMetrics)):
        mx = metrics()
        kw = dict(device="cpu") if ctl_mod is tctl else {}
        ctl = ctl_mod.RuntimeController(
            cfg, ctl_mod.ControllerConfig(
                enable_replica_morph=True, debounce_steps=2,
                cooldown_steps=4, replica_morph_budget=1,
                replica_queue_low=3.0, replica_queue_high=9.0),
            metrics=mx, **kw)
        with _Env(ENV, "2"):
            fab = fab_mod.ServingFabric(
                params, cfg, eng.ServeConfig(**dict(SERVE, num_pages=32)),
                metrics_obj=mx, controller=ctl, replicas=2)
            reqs = both_requests(prompt_rows(2, 8, seed=5), 8)[
                0 if eng is jeng else 1]
            out = fab.run(reqs, [0, 0])
            fab.close()
        morphs = [d for d in mx.decisions
                  if d["decision"] == "controller.replica_morph"]
        assert len(out) == 2 and morphs and morphs[0]["kind"] == "drain"
        assert fab.router.draining() == (morphs[0]["replica"],)
        got.append((out, morphs, fab.router.snapshot()))
    assert got[0] == got[1]
