"""PyTorch port: the serving engine's speculative decoding, sampler and
EP-sharded decode on the CPU.

Speculative greedy decoding against JAX's engine (equal streams, the same
schedules, buckets and acceptance counts), the n-gram drafter against
JAX's, and the port's own properties where JAX's key streams cannot be
reproduced: sampled streams identical across runs, with speculation on
and off, and for a request served alone or in a batch; ``ep_shards`` 2 and
4 over a local mesh equal to the one-shard engine.
"""

import numpy as np
import pytest
import torch

from flashmoe_tpu.serving import speculate as jspec
from flashmoe_tpu_torch.config import MoEConfig
from flashmoe_tpu_torch.models import transformer as ttf
from flashmoe_tpu_torch.parallel.mesh import local_mesh
from flashmoe_tpu_torch.serving import engine as teng
from flashmoe_tpu_torch.serving import speculate as tspec
from flashmoe_tpu_torch.utils.telemetry import Metrics
from test_torch_serving import (SERVE, TCFG, schedule,  # noqa: F401
                                serve_both, weights)

SPEC_SERVE = dict(SERVE, max_batch=4)


def spec_prompts(n=8, length=8, seed=7):
    """Tiled bigram motifs: the drafter finds suffix matches."""
    motifs = np.random.default_rng(seed).integers(0, TCFG.vocab_size, (n, 2))
    return [[int(motifs[i][j % 2]) for j in range(length)] for i in range(n)]


def sampled_run(params, prompts, rids=None, arrivals=None, speculate=None,
                max_new=6, seed=21, temperature=0.8):
    rids = range(len(prompts)) if rids is None else rids
    serve = dict(SPEC_SERVE)
    if speculate is not None:
        serve["speculate"] = teng.SpecConfig(draft_tokens=speculate)
    eng = teng.ServingEngine(params, TCFG, teng.ServeConfig(**serve),
                             metrics_obj=Metrics())
    reqs = [teng.Request(rid=i, prompt=tuple(prompts[i]),
                         max_new_tokens=max_new, seed=seed + i,
                         temperature=temperature, top_k=20, top_p=0.9)
            for i in rids]
    return eng.run(reqs, arrivals), eng


@pytest.mark.parametrize("evict", [False, True], ids=["fits", "evicts"])
def test_speculative_greedy_matches_jax(weights, evict):
    serve = dict(SPEC_SERVE, num_pages=8 if evict else 32)
    run = dict(prompts=spec_prompts(4), max_new=10 if evict else 8,
               arrivals=None if evict else [0, 0, 1, 2])
    (jout, jdec, jsum), (tout, tdec, tsum) = serve_both(
        weights, serve, speculate=3, **run)
    assert tout == jout
    for d in ("serve.admit", "serve.evict", "serve.retire"):
        assert schedule(tdec, d) == schedule(jdec, d), d
    for k in ("decode_buckets", "prefill_buckets", "steps", "evictions",
              "spec_drafted", "spec_accepted", "spec_tokens_per_step"):
        assert tsum[k] == jsum[k], k
    assert tsum["spec_accepted"] > 0
    assert (tsum["evictions"] > 0) == evict
    assert all("accept_rate" in d for d in tdec
               if d["decision"] == "serve.retire")
    # speculation off: the same streams
    eng = teng.ServingEngine(weights[1], TCFG, teng.ServeConfig(**serve),
                             metrics_obj=Metrics())
    plain = eng.run([teng.Request(rid=i, prompt=tuple(p),
                                  max_new_tokens=run["max_new"])
                     for i, p in enumerate(run["prompts"])], run["arrivals"])
    assert plain == tout and "spec_drafted" not in eng.summary()


def test_sampled_streams_repeat_across_runs(weights):
    _, tp = weights
    a, _ = sampled_run(tp, spec_prompts(4))
    b, _ = sampled_run(tp, spec_prompts(4))
    assert a == b
    greedy = run_greedy(tp, spec_prompts(4), 6)
    assert a != greedy  # the sampled arm ran
    assert all(0 <= t < TCFG.vocab_size for v in a.values() for t in v)


def run_greedy(params, prompts, max_new):
    eng = teng.ServingEngine(params, TCFG, teng.ServeConfig(**SPEC_SERVE),
                             metrics_obj=Metrics())
    return eng.run([teng.Request(rid=i, prompt=tuple(p),
                                 max_new_tokens=max_new)
                    for i, p in enumerate(prompts)])


@pytest.mark.parametrize("temperature", [0.8, 0.1])
def test_sampled_streams_equal_with_speculation(weights, temperature):
    """At 0.1 the draws mostly follow the motif, so drafts are proposed
    and checked against canonical samples; at 0.8 they mostly are not."""
    _, tp = weights
    base, _ = sampled_run(tp, spec_prompts(4), temperature=temperature)
    spec, eng = sampled_run(tp, spec_prompts(4), speculate=3,
                            temperature=temperature)
    stagger, _ = sampled_run(tp, spec_prompts(4), arrivals=[0, 1, 2, 3],
                             speculate=3, temperature=temperature)
    assert spec == base and stagger == base
    if temperature < 0.5:
        assert eng.spec_snapshot()["spec_accepted"] > 0


def test_sampled_stream_alone_equals_in_batch(weights):
    _, tp = weights
    batch, _ = sampled_run(tp, spec_prompts(4), arrivals=[0, 0, 1, 1])
    for i in range(4):
        alone, _ = sampled_run(tp, spec_prompts(4), rids=[i])
        assert alone[i] == batch[i]


def test_sampler_arms():
    """Greedy rows are the argmax; top-k 1 is the argmax at any
    temperature; draws are keyed by (seed, index) alone."""
    logits = torch.randn(5, 64, generator=torch.Generator().manual_seed(3))
    n = logits.shape[0]
    greedy = teng._sample_dynamic(logits, [1] * n, [0] * n, [0.0] * n,
                                  [0] * n, [1.0] * n)
    assert torch.equal(greedy, torch.argmax(logits, -1))
    top1 = teng._sample_dynamic(logits, list(range(n)), [4] * n, [1.5] * n,
                                [1] * n, [1.0] * n)
    assert torch.equal(top1, greedy)
    draws = teng._sample_dynamic(logits, [9] * n, list(range(n)), [1.0] * n,
                                 [0] * n, [1.0] * n)
    # row r alone, at its own (seed, index), draws the same token
    for r in range(n):
        one = teng._sample_dynamic(logits[r:r + 1], [9], [r], [1.0], [0],
                                   [1.0])
        assert int(one) == int(draws[r])
    # nucleus at a tiny top-p keeps only the top token
    nuc = teng._sample_dynamic(logits, [2] * n, [0] * n, [1.0] * n,
                               [0] * n, [1e-6] * n)
    assert torch.equal(nuc, greedy)
    assert teng.draw_seed(1, 2) != teng.draw_seed(2, 1)


@pytest.mark.parametrize("shards,speculate", [(2, None), (4, None), (2, 3)])
def test_ep_shards_equal_one_shard(weights, shards, speculate):
    _, tp = weights
    prompts = spec_prompts(8)
    serve = dict(SERVE, num_pages=32)
    if speculate is not None:
        serve["speculate"] = teng.SpecConfig(draft_tokens=speculate)
    outs = []
    for d in (1, shards):
        eng = teng.ServingEngine(tp, TCFG, teng.ServeConfig(
            **dict(serve, ep_shards=d)), metrics_obj=Metrics())
        outs.append(eng.run([teng.Request(rid=i, prompt=tuple(p),
                                          max_new_tokens=6)
                             for i, p in enumerate(prompts)],
                            [0, 0, 0, 0, 1, 1, 2, 2]))
        assert eng.summary()["completed"] == 8
    assert outs[1] == outs[0]
    if speculate is not None:
        assert eng.spec_snapshot()["spec_accepted"] > 0


def test_ep_engine_errors(weights):
    _, tp = weights
    with pytest.raises(ValueError, match="must divide num_experts"):
        teng.ServingEngine(tp, TCFG, teng.ServeConfig(ep_shards=8,
                                                      num_pages=64))
    shared = MoEConfig(**{**TCFG.__dict__, "num_shared_experts": 1})
    sp = ttf.init_params(torch.Generator().manual_seed(0), shared)
    with pytest.raises(ValueError, match="num_shared_experts=0"):
        teng.ServingEngine(sp, shared, teng.ServeConfig(ep_shards=2))
    with pytest.raises(ValueError, match="needs a mesh of 2 ep ranks"):
        teng.ServingEngine(tp, TCFG, teng.ServeConfig(ep_shards=2),
                           mesh=local_mesh(4))
    with pytest.raises(ValueError, match="must divide max_batch"):
        teng.ServeConfig(ep_shards=3, max_batch=8, num_pages=63)


def test_draft_state_matches_jax():
    rng = np.random.default_rng(11)
    for ngram in (1, 2, 3):
        for _ in range(20):
            hist = rng.integers(0, 6, rng.integers(1, 30)).tolist()
            t = tspec.DraftState(tspec.SpecConfig(draft_tokens=4,
                                                  ngram=ngram), hist[:5])
            j = jspec.DraftState(jspec.SpecConfig(draft_tokens=4,
                                                  ngram=ngram), hist[:5])
            for k in (1, 3, 5):
                assert t.draft(k) == j.draft(k)
            t.sync(hist)
            j.sync(hist)
            t.extend([7, 7])
            j.extend([7, 7])
            for k in (0, 2, 4):
                assert t.draft(k) == j.draft(k)
            with pytest.raises(ValueError, match="shrank"):
                t.sync(hist[:1])
    for bad in (dict(draft_tokens=0), dict(ngram=0), dict(source="m")):
        msgs = []
        for mod in (tspec, jspec):
            with pytest.raises(ValueError) as e:
                mod.SpecConfig(**bad)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    assert tspec.spec_stats_fields(4, 3, 2) \
        == jspec.spec_stats_fields(4, 3, 2)
    assert tspec.spec_stats_fields(0, 0, 0) \
        == jspec.spec_stats_fields(0, 0, 0)


def test_set_speculate(weights):
    _, tp = weights
    mx = Metrics()
    eng = teng.ServingEngine(tp, TCFG, teng.ServeConfig(
        **dict(SPEC_SERVE, speculate=teng.SpecConfig(draft_tokens=3))),
        metrics_obj=mx)
    eng.set_speculate(False, reason="drill")
    out = eng.run([teng.Request(rid=i, prompt=tuple(p), max_new_tokens=6)
                   for i, p in enumerate(spec_prompts(2))])
    assert eng.spec_snapshot()["spec_drafted"] == 0
    assert out == run_greedy(tp, spec_prompts(2), 6)
    assert [d["event"] for d in mx.decisions
            if d["decision"] == "serve.spec"] == ["armed", "morph_off"]
    plain = teng.ServingEngine(tp, TCFG, teng.ServeConfig(**SPEC_SERVE),
                               metrics_obj=Metrics())
    with pytest.raises(ValueError, match="speculate"):
        plain.set_speculate(True)


@pytest.mark.parametrize("speculate", [None, 3], ids=["decode", "verify"])
def test_ep_engine_matches_jax(weights, speculate):
    """``ep_shards=2``: the port's engine over a local mesh against JAX's
    over two host devices (its ``_ep_decode_fn`` / ``_ep_verify_fn``):
    equal greedy streams, schedules and buckets."""
    serve = dict(SERVE, num_pages=32, ep_shards=2)
    (jout, jdec, jsum), (tout, tdec, tsum) = serve_both(
        weights, serve, spec_prompts(8), 6, [0, 0, 0, 0, 1, 1, 2, 2],
        speculate=speculate)
    assert tout == jout
    for d in ("serve.admit", "serve.evict", "serve.retire"):
        assert schedule(tdec, d) == schedule(jdec, d), d
    for k in ("decode_buckets", "prefill_buckets", "completed", "steps",
              "max_active"):
        assert tsum[k] == jsum[k], k
    assert tsum["completed"] == 8
    if speculate is not None:
        assert tsum["spec_accepted"] == jsum["spec_accepted"] > 0
