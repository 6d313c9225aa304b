"""PyTorch port: the training step against the JAX package on the same
numpy weights and tokens (CPU): ``loss_fn`` and every parameter's
gradient, remat on and off, the optimizer against optax, three train
steps continuing a JAX train state, and the gradient guard."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from flashmoe_tpu.config import MoEConfig as JaxConfig
from flashmoe_tpu.models import transformer as jtf
from flashmoe_tpu.parallel.mesh import make_mesh
from flashmoe_tpu.runtime import trainer as jtrainer
from flashmoe_tpu_torch.config import MoEConfig as TorchConfig
from flashmoe_tpu_torch.convert import params_from_numpy, train_state_from_numpy
from flashmoe_tpu_torch.models import transformer as ttf
from flashmoe_tpu_torch.runtime import trainer as ttrainer
from flashmoe_tpu_torch.tree import tree_leaves, tree_map

# two layers, the first dense and the second a gated-SiLU dropless MoE
MODEL = dict(num_experts=4, expert_top_k=2, hidden_size=64,
             intermediate_size=64, num_layers=2, moe_frequency=2,
             vocab_size=64, num_heads=2, num_kv_heads=1, sequence_len=8,
             gated_ffn=True, hidden_act="silu", drop_tokens=False,
             router_z_loss_coef=1e-3, is_training=True)


def _cfgs(**over):
    kw = dict(MODEL, **over)
    return (JaxConfig(dtype=jnp.float32, param_dtype=jnp.float32, **kw),
            TorchConfig(dtype=torch.float32, param_dtype=torch.float32,
                        **kw))


def _compile(jitted, *args):
    """The JAX reference compiled at XLA's CPU optimisation level 0, which
    halves the compile of these small programs."""
    return jitted.lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})


def _numpy_params(jc, seed=0):
    rng = np.random.default_rng(seed)

    def fill(leaf):
        if len(leaf.shape) == 1:  # norm weights
            return (1 + 0.1 * rng.standard_normal(leaf.shape)).astype(
                np.float32)
        return (rng.standard_normal(leaf.shape)
                / np.sqrt(leaf.shape[-2])).astype(np.float32)

    shapes = jax.eval_shape(lambda k: jtf.init_params(k, jc),
                            jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(fill, shapes)


def _batches(n, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, MODEL["vocab_size"], (2, 9)).astype(np.int32)
            for _ in range(n)]


def _assert_tree_close(got, want, rtol, atol):
    """Port tree (tensors) against a JAX/numpy tree of the same nesting."""
    flat_w = []
    tree_map(lambda _, w: flat_w.append(np.asarray(w, np.float32)), got,
             jax.tree_util.tree_map(np.asarray, want))
    flat_g = [g.detach().float().numpy() for g in tree_leaves(got)]
    assert len(flat_g) == len(flat_w) > 0
    for i, (g, w) in enumerate(zip(flat_g, flat_w)):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                   err_msg=f"leaf {i}")


def test_loss_and_grads_match_jax_with_and_without_remat():
    """``loss_fn``'s value and every parameter's gradient against JAX
    ``loss_fn(use_pallas=False)`` on the same weights and tokens (f32,
    1e-3 / 1e-4 as the layer's); remat on and off give the same
    gradients; one SGD step lowers the loss on the same batch."""
    jc, tc = _cfgs()
    p = _numpy_params(jc)
    tokens = _batches(1)[0]
    mask = (np.arange(8) < 7).astype(np.float32)[None].repeat(2, 0)
    jbatch = {"tokens": jnp.asarray(tokens), "mask": jnp.asarray(mask)}
    (jloss, jmet), jgrads = _compile(jax.jit(jax.value_and_grad(
        lambda pp: jtf.loss_fn(pp, jbatch, jc, use_pallas=False),
        has_aux=True)), p)(p)

    tp = params_from_numpy(p, device="cpu")
    tbatch = {"tokens": torch.from_numpy(tokens).long(),
              "mask": torch.from_numpy(mask)}
    loss, met, grads = ttf.value_and_grad(tp, tbatch, tc)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(met["ce"]), float(jmet["ce"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(met["aux"]), float(jmet["aux"]),
                               rtol=1e-4)
    _assert_tree_close(grads, jgrads, rtol=1e-3, atol=1e-4)

    _, _, no_remat = ttf.value_and_grad(tp, tbatch,
                                        tc.replace(is_training=False))
    for a, b in zip(tree_leaves(grads), tree_leaves(no_remat)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)

    new, loss0, _ = ttf.sgd_train_step(tp, tbatch, tc, lr=0.05)
    loss1, _ = ttf.loss_fn(new, tbatch, tc)
    assert float(loss1) < float(loss0)


def test_value_and_grad_zeroes_an_unreached_leaf():
    """A parameter the loss never reaches gets a zero gradient, as
    ``jax.grad`` gives it (the dense layer's ``gate_w``)."""
    jc, tc = _cfgs()
    tp = params_from_numpy(_numpy_params(jc), device="cpu")
    tp["layers"][0]["unused"] = torch.ones(3)
    batch = {"tokens": torch.from_numpy(_batches(1)[0]).long()}
    _, _, grads = ttf.value_and_grad(tp, batch, tc)
    assert torch.equal(grads["layers"][0]["unused"], torch.zeros(3))
    assert not grads["layers"][0]["moe"]["gate_w"].any()
    assert grads["layers"][1]["moe"]["gate_w"].abs().max() > 0


def _tree_np(rng, scale):
    return {"a": (rng.standard_normal((4, 8)) * scale).astype(np.float32),
            "layers": [{"w": (rng.standard_normal((8, 3)) * scale).astype(
                np.float32)} for _ in range(2)]}


def test_optimizer_matches_optax_step_for_step():
    """Three updates of the port's optimizer against JAX
    ``make_optimizer`` (optax) on the same gradients: the updates, the
    moments and the count, with the clip both idle and active."""
    jc, tc = _cfgs()
    rng = np.random.default_rng(7)
    params = _tree_np(rng, 1.0)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=6)
    jopt = jtrainer.make_optimizer(jc, **kw)
    topt = ttrainer.make_optimizer(tc, **kw)
    jstate = jopt.init(params)
    tparams = params_from_numpy(params, device="cpu")
    tstate = topt.init(tparams)
    jupdate = _compile(jax.jit(jopt.update), params, jstate, params)
    for scale in (0.01, 3.0, 0.2):  # global norm below, above, below 1
        grads = _tree_np(rng, scale)
        jupd, jstate = jupdate(grads, jstate, params)
        tupd, tstate = topt.update(params_from_numpy(grads, device="cpu"),
                                   tstate, tparams)
        _assert_tree_close(tupd, jupd, rtol=1e-5, atol=1e-8)
        adam = jstate[1][0]
        assert int(tstate.count) == int(adam.count)
        _assert_tree_close(tstate.mu, adam.mu, rtol=1e-6, atol=1e-9)
        _assert_tree_close(tstate.nu, adam.nu, rtol=1e-6, atol=1e-12)
        params = optax.apply_updates(params, jupd)
        tparams = ttrainer.apply_updates(tparams, tupd)
        _assert_tree_close(tparams, params, rtol=1e-6, atol=1e-7)


def test_schedule_matches_optax():
    want = optax.warmup_cosine_decay_schedule(0.0, 3e-4, 3, 10)
    got = ttrainer.warmup_cosine_decay_schedule(0.0, 3e-4, 3, 10)
    for c in range(14):
        np.testing.assert_allclose(
            float(got(torch.tensor(c, dtype=torch.int32))),
            float(want(jnp.int32(c))), rtol=1e-6, atol=1e-12)


def test_train_steps_continue_a_jax_state():
    """A JAX train state after one JAX step crosses through
    ``train_state_from_numpy``; two more steps in each framework, with
    the gradient guard armed, stay together: params, moments, counts,
    guard and metrics (f32; the updates' tolerance is a hundredth of the
    learning rate).  One MoE layer: the smallest model with a router, an
    expert FFN and a carried AdamW state for both."""
    jc, tc = _cfgs(num_layers=1, moe_frequency=1)
    guard = jtrainer.GradGuardConfig()
    lr = 1e-3
    jopt = jtrainer.make_optimizer(jc, lr=lr, warmup_steps=1, total_steps=4)
    mesh = make_mesh(jc, dp=1, devices=jax.devices()[:1])
    jstep = jtrainer.make_train_step(jc, mesh, jopt, use_pallas=False,
                                     guard=guard)
    state = jtrainer.TrainState(
        jax.tree_util.tree_map(jnp.asarray, _numpy_params(jc)),
        None, jnp.zeros((), jnp.int32), jtrainer.init_guard_state())
    state = state._replace(opt_state=jopt.init(state.params))
    # the step's own output placement, so that it compiles once
    state = jax.device_put(state, jtrainer.state_shardings(state, jc, mesh))
    batches = _batches(3, seed=2)
    jstep = _compile(jstep, state, {"tokens": jnp.asarray(batches[0])})
    state, _ = jstep(state, {"tokens": jnp.asarray(batches[0])})

    tstate = train_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, state), device="cpu")
    topt = ttrainer.make_optimizer(tc, lr=lr, warmup_steps=1, total_steps=4)
    tstep = ttrainer.make_train_step(
        tc, topt, guard=ttrainer.GradGuardConfig())
    for tokens in batches[1:]:
        state, jm = jstep(state, {"tokens": jnp.asarray(tokens)})
        tstate, tm = tstep(tstate, {"tokens": torch.from_numpy(tokens)})
        for k in ("loss", "ce", "aux", "grad_norm", "grad_ok",
                  "grad_norm_ema"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-4, err_msg=k)
        adam = state.opt_state[1][0]
        assert int(tstate.step) == int(state.step)
        assert int(tstate.opt_state.count) == int(adam.count)
        assert int(tstate.guard.seen) == int(state.guard.seen)
        _assert_tree_close(tstate.params, state.params, rtol=0,
                           atol=lr / 100)
        _assert_tree_close(tstate.opt_state.mu, adam.mu, rtol=2e-3,
                           atol=1e-5)
        _assert_tree_close(tstate.opt_state.nu, adam.nu, rtol=2e-3,
                           atol=1e-8)
    assert int(tstate.step) == 3


def test_guard_skips_a_nonfinite_step():
    """A NaN in the loss (through the mask) gives a NaN gradient: the
    armed guard skips the update, keeping params, moments and its EMA,
    and counts the step."""
    _, tc = _cfgs()
    guard = ttrainer.GradGuardConfig()
    opt = ttrainer.make_optimizer(tc, lr=1e-2, warmup_steps=1)
    state = ttrainer.init_state(torch.Generator().manual_seed(0), tc, opt,
                                guard=guard)
    step = ttrainer.make_train_step(tc, opt, guard=guard)
    tokens = torch.from_numpy(_batches(1)[0])
    state, m = step(state, {"tokens": tokens})
    assert float(m["grad_ok"]) == 1.0 and int(state.guard.seen) == 1
    mask = torch.ones(2, 8)
    mask[0, 3] = math.nan
    after, m = step(state, {"tokens": tokens, "mask": mask})
    assert math.isnan(float(m["grad_norm"]))
    assert float(m["grad_ok"]) == 0.0
    assert int(after.step) == 2 and int(after.guard.seen) == 1
    assert float(after.guard.norm_ema) == float(state.guard.norm_ema)
    for a, b in zip(tree_leaves((after.params, tuple(after.opt_state))),
                    tree_leaves((state.params, tuple(state.opt_state)))):
        assert torch.equal(a, b)


def test_train_loop_logs_and_counts_steps():
    """``train`` on the CPU: three steps from a generator, history at the
    logged steps (every second one and the last), the guard's metrics in
    it, and a loss that falls on a repeated batch."""
    _, tc = _cfgs()
    tokens = torch.from_numpy(_batches(1)[0])
    state, history = ttrainer.train(
        tc, iter([{"tokens": tokens}] * 3), 3,
        generator=torch.Generator().manual_seed(0), log_every=2,
        guard=ttrainer.GradGuardConfig())
    assert int(state.step) == 3 and int(state.guard.seen) == 3
    assert len(history) == 2
    assert all(math.isfinite(h["loss"]) and h["grad_ok"] == 1.0
               and h["step_ms"] > 0 for h in history)
    assert history[-1]["loss"] < history[0]["loss"]
