"""PyTorch port: the serving engine and its paged KV cache against the JAX
package's (``flashmoe_tpu/serving/``) on the CPU.

The same numpy weights (``convert.params_from_numpy``) and requests go
through JAX's engine (its XLA arm, f32 ``tiny_config``) and the port's
(its plain versions on CPU tensors): the page allocators, bucketing and
page ops agree exactly, the device steps within 2e-4, and the engines
give equal greedy token streams, the same admit / evict / retire
schedules and the same gather buckets.  Speculation, sampling and EP
decode are in ``tests/test_torch_serving_spec.py``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashmoe_tpu.models import transformer as jtf
from flashmoe_tpu.serving import engine as jeng
from flashmoe_tpu.serving import kvcache as jkv
from flashmoe_tpu.serving import loadgen as jload
from flashmoe_tpu.telemetry_plane import sketch as jsketch
from flashmoe_tpu.utils.telemetry import Metrics as JaxMetrics
from flashmoe_tpu_torch.convert import params_from_numpy
from flashmoe_tpu_torch.models import generate as tgen
from flashmoe_tpu_torch.serving import __main__ as tcli
from flashmoe_tpu_torch.serving import engine as teng
from flashmoe_tpu_torch.serving import kvcache as tkv
from flashmoe_tpu_torch.serving import loadgen as tload
from flashmoe_tpu_torch.telemetry_plane import sketch as tsketch
from flashmoe_tpu_torch.utils.telemetry import FlightRecorder, Metrics

JCFG = jload.tiny_config()
TCFG = tload.tiny_config()
TOL = 2e-4


def numpy_params(seed=0):
    """JAX's parameter tree of ``tiny_config`` filled from numpy."""
    rng = np.random.default_rng(seed)

    def fill(leaf):
        if len(leaf.shape) == 1:  # norm weights
            return (1.0 + 0.1 * rng.standard_normal(leaf.shape)).astype(
                np.float32)
        return (rng.standard_normal(leaf.shape)
                / np.sqrt(leaf.shape[-2])).astype(np.float32)

    shapes = jax.eval_shape(lambda k: jtf.init_params(k, JCFG),
                            jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(fill, shapes)


@pytest.fixture(scope="module")
def weights():
    tree = numpy_params()
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            params_from_numpy(tree, device="cpu"))


def prompt_rows(n, length, seed=1):
    return np.random.default_rng(seed).integers(
        0, TCFG.vocab_size, (n, length))


def both_requests(prompts, max_new, stops=None, **kw):
    """The same requests for both engines."""
    out = []
    for mod in (jeng, teng):
        out.append([mod.Request(
            rid=i, prompt=tuple(int(t) for t in p), max_new_tokens=max_new,
            stop_tokens=() if stops is None else (int(stops[i]),), **kw)
            for i, p in enumerate(prompts)])
    return out


def schedule(decisions, name):
    return [(d["step"], d["rid"]) for d in decisions
            if d["decision"] == name]


# ----------------------------------------------------------------------
# The paged KV cache
# ----------------------------------------------------------------------

def _pool_script(pool, shard=None):
    """One alloc/free script; each step's result or error (type, text)."""
    kw = {} if shard is None else {"shard": shard}
    log = []

    def do(fn, *a):
        try:
            log.append(("ok", fn(*a, **kw)))
        except ValueError as e:
            log.append(("err", str(e)))

    a = pool.alloc(3, **kw)
    b = pool.alloc(2, **kw)
    log += [("a", a), ("b", b), ("free", pool.free_pages),
            ("used", pool.used_pages), ("occ", pool.occupancy)]
    do(pool.alloc, 99)
    do(pool.free, a)
    do(pool.alloc, 3)
    do(pool.free, b + b)
    do(pool.free, [0])
    do(pool.alloc, -1)
    do(pool.free, [pool.num_pages + 5])
    log += [("free", pool.free_pages), ("used", pool.used_pages)]
    return log


def test_page_pools_match_jax():
    assert _pool_script(tkv.PagePool(8)) == _pool_script(jkv.PagePool(8))
    for shard in (0, 3):
        t = tkv.ShardedPagePool(24, 4)
        j = jkv.ShardedPagePool(24, 4)
        assert _pool_script(t, shard) == _pool_script(j, shard)
        assert t.to_global([1, 2], shard) == j.to_global([1, 2], shard)
        assert (t.occupancy, t.free_pages, t.shard_free_pages(1)) \
            == (j.occupancy, j.free_pages, j.shard_free_pages(1))
    for args in ((1,), (9, 2), (8, 8), (6, 0)):
        errs = []
        for mod in (tkv, jkv):
            with pytest.raises(ValueError) as e:
                (mod.PagePool(*args) if len(args) == 1
                 else mod.ShardedPagePool(*args))
            errs.append(str(e.value))
        assert errs[0] == errs[1]


def test_ctx_bucket_and_prompt_pad_match_jax():
    for t in range(0, 70, 3):
        for page in (1, 4, 8):
            for bucket in (1, 2, 3):
                for cap in (bucket, 8, 16):
                    assert tkv.ctx_pages_bucket(t, page, bucket, cap) \
                        == jkv.ctx_pages_bucket(t, page, bucket, cap)
        for bucket in (1, 8, 16, 128):
            assert tkv.prompt_pad(t, bucket) == jkv.prompt_pad(t, bucket)


def test_store_and_gather_match_jax():
    rng = np.random.default_rng(3)
    nkv, dh = TCFG.resolved_num_kv_heads, TCFG.resolved_head_dim
    pages = rng.standard_normal((10, nkv, 4, dh)).astype(np.float32)
    tok = rng.standard_normal((3, nkv, dh)).astype(np.float32)
    span = rng.standard_normal((2, 3, nkv, dh)).astype(np.float32)
    ids, rows = np.array([3, 5, 7]), np.array([0, 3, 1])
    sids, srows = np.array([[2, 2, 4], [6, 6, 6]]), np.array(
        [[2, 3, 0], [0, 1, 2]])
    tables = np.array([[3, 5, 0], [7, 2, 9]])

    def t(a):
        return torch.from_numpy(np.array(a))

    want = jkv.store_token(jnp.asarray(pages), jnp.asarray(tok),
                           jnp.asarray(ids), jnp.asarray(rows))
    got = tkv.store_token(t(pages), t(tok), t(ids), t(rows))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jkv.store_tokens(want, jnp.asarray(span), jnp.asarray(sids),
                            jnp.asarray(srows))
    got = tkv.store_tokens(got, t(span), t(sids), t(srows))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        tkv.gather_ctx(got, t(tables)).numpy(),
        np.asarray(jkv.gather_ctx(want, jnp.asarray(tables))))
    cache = rng.standard_normal((2, 10, nkv, 4, dh)).astype(np.float32)
    seq = rng.standard_normal((2, nkv, 8, dh)).astype(np.float32)
    pids = np.array([6, 2])
    np.testing.assert_array_equal(
        tkv.store_prefill(t(cache), t(seq), t(pids)).numpy(),
        np.asarray(jkv.store_prefill(jnp.asarray(cache), jnp.asarray(seq),
                                     jnp.asarray(pids))))
    with pytest.raises(ValueError, match="does not fill"):
        tkv.store_prefill(t(cache), t(seq), t(pids[:1]))
    pc = tkv.init_paged_cache(TCFG, 6, 4, device="cpu")
    jc = jkv.init_paged_cache(JCFG, 6, 4)
    assert tuple(pc.k_pages.shape) == jc.k_pages.shape
    assert (pc.num_pages, pc.page_size) == (jc.num_pages, jc.page_size)


# ----------------------------------------------------------------------
# The device steps
# ----------------------------------------------------------------------

def _pages(seed, num_pages=12, page=4):
    rng = np.random.default_rng(seed)
    shape = (TCFG.num_layers, num_pages, TCFG.resolved_num_kv_heads, page,
             TCFG.resolved_head_dim)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _assert_pages(got, want, before, written):
    """Written pages within TOL of JAX's; every other page but the scratch
    page (duplicate inactive-slot writes race there) exactly as before."""
    written = sorted(set(int(p) for p in np.ravel(written)) - {0})
    others = [p for p in range(1, before.shape[1]) if p not in written]
    np.testing.assert_allclose(got[:, written], np.asarray(want)[:, written],
                               rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got[:, others], before[:, others])
    np.testing.assert_array_equal(np.asarray(want)[:, others],
                                  before[:, others])


def _run_step(weights, name, kp, vp, *arrays, ints=()):
    jp, tp = weights
    want = getattr(jeng, name)(jp, JCFG, jnp.asarray(kp), jnp.asarray(vp),
                               *(jnp.asarray(a, jnp.int32) for a in arrays),
                               *(jnp.int32(i) for i in ints))
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    got = getattr(teng, name)(tp, TCFG, tk, tv,
                              *(torch.from_numpy(np.array(a)) for a in arrays),
                              *ints)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=TOL, atol=TOL)
    assert got[1] is tk and got[2] is tv  # written in place
    return got, want


def test_paged_decode_step_matches_jax(weights):
    kp, vp = _pages(4)
    toks = np.array([5, 17, 200, 0])
    tables = np.array([[1, 2, 3], [4, 5, 0], [6, 0, 0], [0, 0, 0]])
    positions = np.array([9, 6, 2, 0])  # slot 3 inactive
    got, want = _run_step(weights, "_paged_decode_step", kp, vp, toks,
                          tables, positions)
    _assert_pages(got[1].numpy(), want[1], kp, tables)
    _assert_pages(got[2].numpy(), want[2], vp, tables)


def test_paged_verify_step_matches_jax(weights):
    kp, vp = _pages(5)
    toks = np.array([[5, 6, 7, 8], [17, 1, 0, 0], [3, 3, 3, 3]])
    tables = np.array([[1, 2, 3], [4, 5, 0], [6, 7, 8]])
    # slot 2's span runs past its 12 gathered positions (scratch writes)
    positions = np.array([3, 5, 10])
    got, want = _run_step(weights, "_paged_verify_step", kp, vp, toks,
                          tables, positions)
    _assert_pages(got[1].numpy(), want[1], kp, tables)
    _assert_pages(got[2].numpy(), want[2], vp, tables)
    # each column of the span equals what lm_logits gives that row
    _, tp = weights
    h = torch.randn(3, 4, TCFG.hidden_size,
                    generator=torch.Generator().manual_seed(0))
    span = tgen.lm_logits_span(tp, TCFG, h)
    for t in range(4):
        assert torch.equal(span[:, t], tgen.lm_logits(tp, TCFG, h[:, t:t + 1]))


@pytest.mark.parametrize("start,rel_last", [(0, 7), (8, 5)])
def test_prefill_chunk_matches_jax(weights, start, rel_last):
    kp, vp = _pages(6)
    toks = np.random.default_rng(7).integers(0, TCFG.vocab_size, (1, 8))
    table = np.array([1, 2, 3, 4])
    chunk_ids = table[start // 4:start // 4 + 2]
    got, want = _run_step(weights, "_prefill_chunk", kp, vp, toks, table,
                          chunk_ids, ints=(start, rel_last))
    _assert_pages(got[1].numpy(), want[1], kp, chunk_ids)
    _assert_pages(got[2].numpy(), want[2], vp, chunk_ids)


# ----------------------------------------------------------------------
# The engines, request for request
# ----------------------------------------------------------------------

SERVE = dict(max_batch=8, page_size=8, num_pages=32, max_pages_per_slot=4,
             ctx_bucket_pages=1, prompt_bucket=8)


def _scenario(name, drill_out=None):
    """(ServeConfig kwargs, prompts, max_new, arrivals, stop tokens)."""
    if name == "drill8":
        return SERVE, prompt_rows(8, 8), 6, [0, 0, 0, 0, 1, 1, 2, 3], None
    if name == "evict":
        return (dict(SERVE, max_batch=4, num_pages=8), prompt_rows(4, 8),
                10, None, None)
    if name == "chunked":
        prompts = [prompt_rows(1, n, seed=10 + n)[0] for n in (20, 9, 16, 3)]
        return (dict(SERVE, max_batch=4, max_pages_per_slot=5,
                     ctx_bucket_pages=2, prefill_chunk=8), prompts, 6,
                [0, 0, 1, 1], None)
    # stop: each request stops at its third greedy token of the drill
    stops = [drill_out[i][8 + 2] for i in range(4)]
    return dict(SERVE, max_batch=4), prompt_rows(4, 8), 8, None, stops


def serve_both(weights, serve_kw, prompts, max_new, arrivals=None,
               stops=None, speculate=None, **req_kw):
    """Run JAX's engine and the port's on the same requests (with
    ``speculate`` drafts a step, each engine's own ``SpecConfig``);
    returns ((outputs, decisions, summary) of JAX, the same of the
    port)."""
    jreqs, treqs = both_requests(prompts, max_new, stops, **req_kw)
    res = []
    for mod, params, reqs, mx in ((jeng, weights[0], jreqs, JaxMetrics()),
                                  (teng, weights[1], treqs, Metrics())):
        cfg = JCFG if mod is jeng else TCFG
        kw = dict(serve_kw)
        if speculate is not None:
            kw["speculate"] = mod.SpecConfig(draft_tokens=speculate)
        eng = mod.ServingEngine(params, cfg, mod.ServeConfig(**kw),
                                metrics_obj=mx)
        out = eng.run(reqs, arrivals)
        res.append(({k: [int(t) for t in v] for k, v in out.items()},
                    mx.decisions, eng.summary()))
    return res


@pytest.fixture(scope="module")
def drill(weights):
    serve_kw, prompts, max_new, arrivals, _ = _scenario("drill8")
    return serve_both(weights, serve_kw, prompts, max_new, arrivals)


@pytest.mark.parametrize("name", ["drill8", "evict", "chunked", "stop"])
def test_engine_matches_jax(weights, drill, name):
    if name == "drill8":
        (jout, jdec, jsum), (tout, tdec, tsum) = drill
    else:
        serve_kw, prompts, max_new, arrivals, stops = _scenario(
            name, drill[1][0])
        (jout, jdec, jsum), (tout, tdec, tsum) = serve_both(
            weights, serve_kw, prompts, max_new, arrivals, stops)
    assert tout == jout
    for d in ("serve.admit", "serve.evict", "serve.retire"):
        assert schedule(tdec, d) == schedule(jdec, d), d
    for k in ("decode_buckets", "prefill_buckets", "completed", "tokens",
              "steps", "evictions", "max_active", "max_queue_depth",
              "peak_occupancy", "decode_plan", "prefill_plan"):
        assert tsum[k] == jsum[k], k
    assert tsum["completed"] == len(tout)
    if name == "drill8":
        assert tsum["max_active"] == 8
        assert max(s for s, _ in schedule(tdec, "serve.admit")) > 0
    if name == "evict":
        assert tsum["evictions"] > 0
        assert [d["resumed"] for d in tdec if d["decision"] == "serve.admit"]\
            == [d["resumed"] for d in jdec if d["decision"] == "serve.admit"]
    if name == "chunked":
        assert any(d["chunked"] for d in tdec
                   if d["decision"] == "serve.admit")
    if name == "stop":
        assert all(len(v) < 8 + 8 for v in tout.values())


def test_engine_equals_port_generate(weights, drill):
    """Each drill request's stream equals ``generate`` on that prompt
    alone; the retire decisions and flight records carry TTFT / TPOT."""
    _, tp = weights
    tout = drill[1][0]
    for i, p in enumerate(prompt_rows(8, 8)):
        want = tgen.generate(tp, torch.from_numpy(p)[None], TCFG,
                             max_new_tokens=6)[0].tolist()
        assert tout[i] == want
    recorder, mx = FlightRecorder(), Metrics()
    eng = teng.ServingEngine(tp, TCFG, teng.ServeConfig(**SERVE),
                             recorder=recorder, metrics_obj=mx)
    eng.run(both_requests(prompt_rows(3, 8), 4)[1])
    steps = [r for r in recorder.records if r["kind"] == "serve_step"]
    reqs = [r for r in recorder.records if r["kind"] == "serve_request"]
    assert steps and len(reqs) == 3
    assert set(steps[0]) == {"kind", "step", "active", "queue_depth",
                             "pages_used", "cache_occupancy", "tokens",
                             "completed", "step_ms"}
    assert all(r["ttft_ms"] is not None and r["tpot_ms"] is not None
               for r in reqs)
    plan = mx.last_decision("serve.plan")
    assert plan["decode_backend"] == TCFG.moe_backend


# ----------------------------------------------------------------------
# Validation, refusals, metrics, the CLI
# ----------------------------------------------------------------------

@pytest.mark.parametrize("bad", [
    dict(page_size=8, prompt_bucket=4), dict(ctx_bucket_pages=99),
    dict(num_pages=1), dict(max_batch=0), dict(page_size=0),
    dict(prefill_chunk=12), dict(ep_shards=0),
    dict(ep_shards=3, max_batch=8), dict(ep_shards=4, num_pages=30),
    dict(ep_shards=8, num_pages=8), dict(speculate=3)])
def test_serve_config_errors_match_jax(bad):
    msgs = []
    for mod in (jeng, teng):
        with pytest.raises(ValueError) as e:
            mod.ServeConfig(**bad)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_request_submit_and_engine_errors_match_jax(weights):
    for bad in (dict(prompt=()), dict(prompt=(1,), max_new_tokens=0),
                dict(prompt=(1,), top_p=0.0)):
        msgs = []
        for mod in (jeng, teng):
            with pytest.raises(ValueError) as e:
                mod.Request(rid=0, **bad)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    for serve_kw, req_kw in (
            (dict(max_batch=2, num_pages=4, max_pages_per_slot=8),
             dict(prompt=tuple(range(1, 25)), max_new_tokens=8)),
            (dict(max_batch=2, max_pages_per_slot=2),
             dict(prompt=tuple(range(1, 20)), max_new_tokens=8))):
        msgs = []
        for mod, params, cfg in ((jeng, weights[0], JCFG),
                                 (teng, weights[1], TCFG)):
            eng = mod.ServingEngine(params, cfg, mod.ServeConfig(
                **dict(SERVE, **serve_kw)), metrics_obj=Metrics())
            with pytest.raises(ValueError) as e:
                eng.submit(mod.Request(rid=0, **req_kw))
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    msgs = []
    for mod, params, cfg in ((jeng, weights[0], JCFG),
                             (teng, weights[1], TCFG)):
        with pytest.raises(ValueError) as e:
            mod.ServingEngine(params, cfg.replace(drop_tokens=True))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# the JAX engine's keywords: the live plane's run (item None), the
# fabric's seams are refused naming their ROADMAP item
REFUSED = [("tracer", True, None),
           ("telemetry_port", 0, None),
           ("slo", "slo", None),
           ("prefill_fn", lambda *a, **k: None, "Serving fabric"),
           ("replica_tag", "r0", "Serving fabric"),
           ("pools_info", {}, "Serving fabric"),
           ("heartbeat_fn", lambda phase: None, "Serving fabric")]


def _plane_run(weights, **kw):
    """Greedy tokens of a short drill (an eviction included) through the
    port's engine, with ``kw`` armed; the engine is closed after."""
    prompts = prompt_rows(4, 6, seed=3)
    reqs = both_requests(prompts, 5)[1]
    eng = teng.ServingEngine(
        weights[1], TCFG, teng.ServeConfig(max_batch=4, page_size=4,
                                           num_pages=9,
                                           max_pages_per_slot=4,
                                           prompt_bucket=4),
        metrics_obj=Metrics(), **kw)
    try:
        out = eng.run(reqs, [0, 0, 1, 1])
        return out, eng
    finally:
        eng.close()


@pytest.mark.parametrize("kw,value,item", REFUSED,
                         ids=[r[0] for r in REFUSED])
def test_refused_keywords_name_their_roadmap_item(weights, kw, value, item):
    if item is None:
        # ported with the live plane: the keyword runs, and the tokens
        # are those of the engine without it
        from flashmoe_tpu_torch.profiler.slo import SLOConfig

        if kw == "slo":
            value = SLOConfig(step_ms=1e-6, ttft_ms=1e-6, tpot_ms=1e-6)
        want, _ = _plane_run(weights)
        got, eng = _plane_run(weights, **{kw: value})
        assert got == want
        if kw == "tracer":
            assert eng.tracer.validate() == []
            assert eng.stats["evictions"] > 0
        if kw == "slo":
            assert eng.watchdog.metrics.counters["slo.breaches"] > 0
        if kw == "telemetry_port":
            assert eng.telemetry is None  # closed
        return
    with pytest.raises(NotImplementedError, match=f"'{item}'"):
        teng.ServingEngine(weights[1], TCFG, **{kw: value})


def test_refused_fabric_methods_and_cli_flags(weights, capsys, tmp_path):
    eng = teng.ServingEngine(weights[1], TCFG, metrics_obj=Metrics())
    with pytest.raises(NotImplementedError, match="'Serving fabric'"):
        eng.evacuate()
    with pytest.raises(NotImplementedError, match="'Serving fabric'"):
        eng.adopt(None)
    # the live plane's flags run (ported with it)
    obs = tmp_path / "obs"
    assert tcli.main(["--device", "cpu", "--requests", "2", "--max-new",
                      "2", "--layers", "1", "--trace", "--telemetry-port",
                      "0", "--ttft-slo-ms", "5", "--tpot-slo-ms", "5",
                      "--obs-dir", str(obs)]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["trace_problems"] == [] and got["telemetry_port"] > 0
    for name in ("trace.jsonl", "request_trace.json", "flight.jsonl",
                 "decisions.jsonl"):
        assert (obs / name).is_file()


def test_cli_prints_jax_summary_keys(tmp_path, capsys):
    from flashmoe_tpu.serving import __main__ as jcli

    args = ["--requests", "3", "--max-new", "2", "--layers", "1"]
    assert jcli.main(args) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    obs = tmp_path / "obs"
    assert tcli.main(args + ["--device", "cpu", "--obs-dir",
                             str(obs)]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(want) <= set(got)
    assert got["device"] == "cpu" and got["completed"] == 3
    for k in ("submitted", "completed", "tokens", "steps",
              "decode_buckets", "prefill_buckets", "max_active"):
        assert got[k] == want[k], k
    flight = [json.loads(x) for x in (obs / "flight.jsonl").open()]
    decisions = [json.loads(x) for x in (obs / "decisions.jsonl").open()]
    assert {r["kind"] for r in flight} == {"serve_step", "serve_request"}
    assert {"serve.admit", "serve.retire"} <= {d["decision"]
                                               for d in decisions}
    if not torch.cuda.is_available():
        assert tcli.main(["--requests", "1"]) == 2
        assert "no CUDA device" in capsys.readouterr().err


def test_sketches_match_jax():
    rng = np.random.default_rng(8)
    stream = np.exp(rng.standard_normal(300)).tolist()
    for n in (3, 40, 300):
        t, j = tsketch.QuantileSketch(), jsketch.QuantileSketch()
        for v in stream[:n]:
            t.observe(v)
            j.observe(v)
        assert t.summary() == j.summary()
        assert t.quantile(0.75) == j.quantile(0.75)
    tq, jq = tsketch.P2Quantile(0.9), jsketch.P2Quantile(0.9)
    for v in stream:
        tq.observe(v)
        jq.observe(v)
    assert tq.value() == jq.value()
    now = [100.0]
    tr = tsketch.WindowedRate(window_s=5.0, clock=lambda: now[0])
    jr = jsketch.WindowedRate(window_s=5.0, clock=lambda: now[0])
    for i, v in enumerate(stream[:40]):
        now[0] += 0.37 * (i % 4)
        assert tr.add(v) == jr.add(v)
        assert tr.rate() == jr.rate()
    for mod in (tsketch, jsketch):
        with pytest.raises(ValueError):
            mod.P2Quantile(1.0)
    tm, jm = Metrics(), JaxMetrics()
    for v in stream[:70]:
        tm.sketch("serve.ttft_ms", v)
        jm.sketch("serve.ttft_ms", v)
    assert tm.sketches["serve.ttft_ms"].summary() \
        == jm.sketches["serve.ttft_ms"].summary()


def test_build_requests_and_pctl():
    a = tload.build_requests(5, vocab=50, prompt_len=7, max_new=3, seed=4,
                             arrival_every=2)
    b = tload.build_requests(5, vocab=50, prompt_len=7, max_new=3, seed=4,
                             arrival_every=2)
    ja = jload.build_requests(5, vocab=50, prompt_len=7, max_new=3, seed=4,
                              arrival_every=2)
    assert a == b and a[1] == ja[1] == [0, 0, 2, 2, 4]
    assert [(r.rid, r.seed, len(r.prompt)) for r in a[0]] \
        == [(r.rid, r.seed, len(r.prompt)) for r in ja[0]]
    rep = tload.build_requests(3, vocab=50, prompt_len=9, max_new=3,
                               seed=4, arrival_every=1, repetitive=True)
    assert all(r.prompt[:2] * 4 + r.prompt[:1] == r.prompt for r in rep[0])
    vals = [5.0, 1.0, 3.0, 2.0, 4.0]
    for q in (0.0, 0.5, 0.99):
        assert tload.pctl(vals, q) == jload.pctl(vals, q)
    assert tload.pctl([], 0.5) is None
