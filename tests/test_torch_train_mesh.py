"""PyTorch port: training over an expert-parallel mesh.  Two
``make_train_step`` steps over a local mesh (AdamW, the gradient guard
armed) against the JAX package's ``make_train_step(cfg, mesh, opt)`` on
its 8-device CPU mesh, from the same numpy weights and tokens: the
collective layer, the collective layer with tensor-parallel experts and
the dropless ragged layer, each against JAX's losses, metrics and
parameters.  The fused layer (whose JAX counterpart runs only in Pallas
interpret mode) is held against the port's own collective run."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashmoe_tpu.parallel.mesh import make_mesh
from flashmoe_tpu.runtime import trainer as jtrainer
from flashmoe_tpu_torch.convert import train_state_from_numpy
from flashmoe_tpu_torch.models import transformer as ttf
from flashmoe_tpu_torch.parallel.mesh import local_mesh
from flashmoe_tpu_torch.runtime import trainer as ttrainer

from test_torch_train import (_assert_tree_close, _batches, _cfgs,
                              _compile, _numpy_params)

LR = 1e-3
CASES = {
    # name: (ep, tp, moe_backend)
    "collective_ep4": (4, 1, "collective"),
    "collective_ep2_tp2": (2, 2, "collective"),
    "ragged_ep4": (4, 1, "ragged"),
}


def _state(tc, jstate):
    return train_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstate), device="cpu")


def _jax_start(jc, ep, tp):
    """JAX's step on its ep x tp mesh and its initial state there."""
    jopt = jtrainer.make_optimizer(jc, lr=LR, warmup_steps=1, total_steps=4)
    mesh = make_mesh(jc, dp=1, ep=ep, tp=tp, devices=jax.devices()[:ep * tp])
    jstep = jtrainer.make_train_step(jc, mesh, jopt, use_pallas=False,
                                     guard=jtrainer.GradGuardConfig())
    state = jtrainer.TrainState(
        jax.tree_util.tree_map(jnp.asarray, _numpy_params(jc)),
        None, jnp.zeros((), jnp.int32), jtrainer.init_guard_state())
    state = state._replace(opt_state=jopt.init(state.params))
    state = jax.device_put(state, jtrainer.state_shardings(state, jc, mesh))
    return jstep, state


def _port_steps(tc, start, mesh, batches):
    topt = ttrainer.make_optimizer(tc, lr=LR, warmup_steps=1, total_steps=4)
    step = ttrainer.make_train_step(tc, topt, guard=ttrainer.GradGuardConfig(),
                                    mesh=mesh)
    state, metrics = start, []
    for tokens in batches:
        state, m = step(state, {"tokens": torch.from_numpy(tokens)})
        metrics.append(m)
    return state, metrics


@pytest.mark.parametrize("case", list(CASES))
def test_train_steps_over_a_mesh_match_jax(case):
    ep, tp, backend = CASES[case]
    jc, tc = _cfgs(ep=ep, tp=tp, moe_backend=backend, moe_frequency=1)
    jstep, jstate = _jax_start(jc, ep, tp)
    start = _state(tc, jstate)
    batches = _batches(2, seed=5)
    jstep = _compile(jstep, jstate, {"tokens": jnp.asarray(batches[0])})
    tstate, tms = _port_steps(tc, start, local_mesh(ep, tp=tp), batches)
    for tokens, tm in zip(batches, tms):
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(tokens)})
        for k in ("loss", "ce", "aux", "grad_norm", "grad_ok",
                  "grad_norm_ema"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-4, err_msg=k)
    adam = jstate.opt_state[1][0]
    assert int(tstate.step) == int(jstate.step) == 2
    _assert_tree_close(tstate.params, jstate.params, rtol=0, atol=LR / 100)
    _assert_tree_close(tstate.opt_state.mu, adam.mu, rtol=2e-3, atol=1e-5)


def test_fused_train_steps_match_the_collective_ones():
    """The fused layer's steps (its blocks not rematerialised, its
    backward through ``_FusedCore``) against the collective layer's on
    the same mesh and state."""
    ep = 4
    jc, tc = _cfgs(ep=ep, moe_frequency=1)
    _, jstate = _jax_start(jc.replace(ep=1), 1, 1)
    batches = _batches(2, seed=6)
    m = local_mesh(ep)
    want, wms = _port_steps(tc, _state(tc, jstate), m, batches)
    got, gms = _port_steps(tc.replace(moe_backend="fused"),
                           _state(tc, jstate), m, batches)
    for g, w in zip(gms, wms):
        for k in ("loss", "ce", "aux", "grad_norm"):
            np.testing.assert_allclose(float(g[k]), float(w[k]), rtol=1e-5,
                                       err_msg=k)
    _assert_tree_close(got.params, jax.tree_util.tree_map(
        lambda t: t.detach().numpy(), want.params,
        is_leaf=lambda t: isinstance(t, torch.Tensor)), rtol=0,
        atol=LR / 100)


def test_entry_points_take_the_mesh():
    """``loss_fn``, ``value_and_grad`` and ``sgd_train_step`` over a mesh
    agree with one device (the dropless layers route alike; the
    load-balancing loss, a product of per-shard means, is off, since its
    mean over ranks is not the whole batch's), and a mesh of the wrong
    size is refused."""
    jc, tc = _cfgs(ep=2, tp=2, moe_frequency=1, aux_loss_coef=0.0)
    _, jstate = _jax_start(jc.replace(ep=1, tp=1), 1, 1)
    params = _state(tc, jstate).params
    batch = {"tokens": torch.from_numpy(_batches(1, seed=7)[0])}
    one = tc.replace(ep=1, tp=1)
    want, _ = ttf.loss_fn(params, batch, one)
    m = local_mesh(2, tp=2)
    got, _ = ttf.loss_fn(params, batch, tc, mesh=m)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    loss, _, grads = ttf.value_and_grad(params, batch, tc, mesh=m)
    _, _, grads1 = ttf.value_and_grad(params, batch, one)
    assert float(loss) == float(got)
    for g, w in zip(jax.tree_util.tree_leaves(grads),
                    jax.tree_util.tree_leaves(grads1)):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-6)
    new, loss2, _ = ttf.sgd_train_step(params, batch, tc, lr=0.1, mesh=m)
    assert float(loss2) == float(loss)
    assert float(ttf.loss_fn(new, batch, tc, mesh=m)[0]) < float(loss)
    with pytest.raises(ValueError, match="mesh of 4 ranks"):
        ttf.loss_fn(params, batch, tc.replace(tp=1), mesh=m)
