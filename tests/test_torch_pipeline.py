"""PyTorch port: pipeline parallelism over the pp axis of a local mesh
against the JAX package on the same numpy weights and tokens: the tick
table against JAX's formula; the cross-entropy of GPipe and the
interleaved schedule against JAX's mesh-free ``loss_fn`` (JAX's own
tests hold its ``pipeline_loss`` equal to it at rtol 1e-5); the
gradients (aux and z coefficients 0, where the pipeline loss is the
plain loss) against ``jax.grad`` of it; EP inside the stages; the lm
head's call count; the validation errors; and the aux term against
JAX's ``pipeline_loss`` itself."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashmoe_tpu.config import MoEConfig as JaxConfig
from flashmoe_tpu.models import transformer as jtf
from flashmoe_tpu.parallel import pipeline as jpipe
from flashmoe_tpu.parallel.mesh import make_mesh as jmake_mesh
from flashmoe_tpu_torch.config import MoEConfig as TorchConfig
from flashmoe_tpu_torch.convert import params_from_numpy
from flashmoe_tpu_torch.parallel import pipeline as tpipe
from flashmoe_tpu_torch.parallel.mesh import make_mesh
from flashmoe_tpu_torch.tree import tree_leaves, tree_map

# JAX's tests/test_pipeline.py configuration
CFG = dict(num_experts=4, expert_top_k=2, hidden_size=64,
           intermediate_size=128, sequence_len=32, num_layers=4,
           moe_frequency=1, vocab_size=256, num_heads=2, drop_tokens=False)
TOL = 2e-4


def _cfgs(**kw):
    kw = {**CFG, **kw}
    return (JaxConfig(dtype=jnp.float32, param_dtype=jnp.float32, **kw),
            TorchConfig(dtype=torch.float32, param_dtype=torch.float32,
                        **kw))


def _params(jc, seed=0):
    """JAX's ``init_params`` tree as numpy, biases made nonzero."""
    tree = jax.tree_util.tree_map(
        np.asarray, jtf.init_params(jax.random.PRNGKey(seed), jc))
    rng = np.random.default_rng(seed)
    for layer in tree["layers"]:
        for k in ("b_up", "b_down"):
            layer["moe"][k] = (0.1 * rng.standard_normal(
                layer["moe"][k].shape)).astype(np.float32)
    return tree


def _tokens(b, seed=1):
    return np.random.default_rng(seed).integers(
        0, CFG["vocab_size"], (b, CFG["sequence_len"] + 1)).astype(np.int32)


def _jax_loss(jc, params, tok):
    """JAX's mesh-free ``loss_fn`` and its gradient, jitted."""
    fn = jax.jit(jax.value_and_grad(
        lambda p, t: jtf.loss_fn(p, {"tokens": t}, jc, None, False),
        has_aux=True))
    return fn(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(tok))


def _port(tc, params, tok, mesh, grad=False, **kw):
    tparams = params_from_numpy(params, device="cpu")
    if grad:
        tparams = tree_map(lambda t: t.requires_grad_(True), tparams)
    total, m = tpipe.pipeline_loss(tparams, {"tokens": torch.from_numpy(tok)},
                                   tc, mesh, **kw)
    if not grad:
        return total, m, None
    leaves = tree_leaves(tparams)
    g = torch.autograd.grad(total, leaves, allow_unused=True,
                            materialize_grads=True)
    return total, m, g


@pytest.mark.parametrize("pp,m,v", [(2, 2, 1), (4, 2, 1), (2, 4, 2),
                                    (4, 8, 2), (3, 6, 3)])
def test_tick_table_matches_jax_formula(pp, m, v):
    """Every (tick, stage): JAX's window, group / lap / offset and
    clipped microbatch (``pipeline.py:181-191``), evaluated with jnp."""
    table = tpipe.tick_table(pp, m, v)
    assert len(table) == v * m + pp - 1
    for t, row in enumerate(table):
        for s, job in enumerate(row):
            u = jnp.int32(t) - s
            active = bool((u >= 0) & (u < v * m))
            uc = jnp.clip(u, 0, v * m - 1)
            g, lap, r = uc // (v * pp), (uc % (v * pp)) // pp, uc % pp
            mb = int(jnp.clip(g * pp + r, 0, m - 1))
            assert job == ((int(lap), mb) if active else None), (t, s)
    # every microbatch passes every chunk of every stage exactly once
    done = [(s, job) for row in table for s, job in enumerate(row) if job]
    assert sorted(done) == sorted((s, (lap, mb)) for s in range(pp)
                                  for lap in range(v) for mb in range(m))


@pytest.mark.parametrize("pp,dp,mb,v", [(4, 2, 2, 1), (2, 4, 4, 1),
                                        (2, 2, 1, 1), (2, 2, 2, 2),
                                        (2, 2, 4, 2)])
def test_pipeline_ce_matches_plain_loss(pp, dp, mb, v):
    jc, tc = _cfgs(pp=pp, dp=dp)
    params, tok = _params(jc), _tokens(dp * mb)
    (_, want), _ = _jax_loss(jc.replace(pp=1, dp=1), params, tok)
    calls = tpipe.lm_head_ce.calls
    with torch.no_grad():
        total, m, _ = _port(tc, params, tok, make_mesh(tc, device="cpu"),
                            num_microbatches=mb, interleave=v)
    assert tpipe.lm_head_ce.calls - calls == mb  # once a microbatch
    np.testing.assert_allclose(float(m["ce"]), float(want["ce"]), rtol=1e-5)
    np.testing.assert_allclose(float(total), float(m["ce"] + m["aux"]),
                               rtol=1e-6)


@pytest.mark.parametrize("case", ["gpipe_dp2", "interleaved_dp2",
                                  "ep2_in_stage"])
def test_pipeline_grads_match_jax(case):
    """With the aux and z coefficients at 0 the pipeline loss is the
    plain loss: every gradient leaf against ``jax.grad`` of JAX's
    ``loss_fn`` (EP inside the stages in the last case, pp 2 x ep 2 x
    dp 2)."""
    ep, v, mb = {"gpipe_dp2": (1, 1, 2), "interleaved_dp2": (1, 2, 2),
                 "ep2_in_stage": (2, 1, 2)}[case]
    jc, tc = _cfgs(pp=2, dp=2, ep=ep, aux_loss_coef=0.0,
                   router_z_loss_coef=0.0, is_training=True)
    params, tok = _params(jc, seed=3), _tokens(2 * ep * mb, seed=4)
    (wl, _), wg = _jax_loss(jc.replace(pp=1, dp=1, ep=1), params, tok)
    calls = tpipe.lm_head_ce.calls
    total, _, got = _port(tc, params, tok, make_mesh(tc, device="cpu"),
                          grad=True, num_microbatches=mb, interleave=v)
    assert tpipe.lm_head_ce.calls - calls == mb
    np.testing.assert_allclose(float(total.detach()), float(wl), rtol=1e-5)
    want = jax.tree_util.tree_leaves(wg)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL, err_msg=f"leaf {i}")


def test_pipeline_aux_matches_jax_pipeline():
    """The aux term (the MoE losses summed over stages, averaged over
    microbatches and the (dp, ep) shards, each shard's own) against JAX's
    ``pipeline_loss`` on pp 2 x dp 2 x ep 2, z-loss on."""
    jc, tc = _cfgs(pp=2, dp=2, ep=2, router_z_loss_coef=1e-3)
    params, tok = _params(jc, seed=5), _tokens(8, seed=6)
    mesh = jmake_mesh(jc, devices=jax.devices()[:8])
    fn = jax.jit(lambda p, t: jpipe.pipeline_loss(
        p, {"tokens": t}, jc, mesh, num_microbatches=2, use_pallas=False))
    args = (jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(tok))
    wt, wm = fn.lower(*args).compile(compiler_options={
        "xla_backend_optimization_level": 0})(*args)
    with torch.no_grad():
        total, m, _ = _port(tc, params, tok, make_mesh(tc, device="cpu"),
                            num_microbatches=2)
    np.testing.assert_allclose(float(m["aux"]), float(wm["aux"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["ce"]), float(wm["ce"]), rtol=1e-5)
    np.testing.assert_allclose(float(total), float(wt), rtol=1e-5)


def test_stage_params_are_the_model_params():
    """The stage lists hold the model's own layer dicts, in JAX's
    interleaved chunk order: nothing is copied."""
    _, tc = _cfgs(num_layers=8)
    params = {"layers": [{"i": torch.tensor(i)} for i in range(8)],
              "embed": 0, "final_norm": 1, "lm_head": 2}
    stages, io = tpipe.stack_stage_params(params, tc, 2, interleave=2)
    assert [[[int(l["i"]) for l in chunk] for chunk in st]
            for st in stages] == [[[0, 1], [4, 5]], [[2, 3], [6, 7]]]
    assert stages[1][1][0] is params["layers"][6]
    assert io == {"embed": 0, "final_norm": 1, "lm_head": 2}


def test_validation_errors_match_jax():
    jc, tc = _cfgs(pp=2, dp=2)
    params = _params(jc)
    tparams = params_from_numpy(params, device="cpu")
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    tok = _tokens(6)
    jm = jmake_mesh(jc, devices=jax.devices()[:4])
    tm = make_mesh(tc, device="cpu")

    def same(jfn, tfn):
        with pytest.raises(ValueError) as jerr:
            jfn()
        with pytest.raises(ValueError) as terr:
            tfn()
        assert str(terr.value) == str(jerr.value)

    for kw in (dict(num_microbatches=3, interleave=2), dict(interleave=0)):
        same(lambda: jpipe.pipeline_loss(jparams, {"tokens": tok}, jc, jm,
                                         **kw),
             lambda: tpipe.pipeline_loss(tparams, {"tokens": torch.from_numpy(
                 tok)}, tc, tm, **kw))
    j1, t1 = _cfgs(dp=4)
    jm1 = jmake_mesh(j1, devices=jax.devices()[:4])
    same(lambda: jpipe.pipeline_loss(jparams, {"tokens": tok}, j1, jm1),
         lambda: tpipe.pipeline_loss(tparams, {"tokens": torch.from_numpy(
             tok)}, t1, make_mesh(t1, device="cpu")))
    j3, t3 = _cfgs(num_layers=3)
    same(lambda: jpipe.stack_stage_params(_params(j3), j3, 2),
         lambda: tpipe.stack_stage_params({"layers": [{}] * 3}, t3, 2))
    j4, t4 = _cfgs(moe_frequency=2)
    same(lambda: jpipe.stack_stage_params(_params(j4), j4, 4),
         lambda: tpipe.stack_stage_params({"layers": [{}] * 4}, t4, 4))
    with pytest.raises(ValueError, match="does not split"):
        tpipe.pipeline_loss(tparams, {"tokens": torch.from_numpy(tok)}, tc,
                            tm, num_microbatches=4)
