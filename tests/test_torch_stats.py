"""PyTorch port: the MoE flight recorder's statistics and tier-0 expert
degradation against the JAX package, on the same numpy inputs (CPU; the
port runs the kernels' plain versions there)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashmoe_tpu.config import MoEConfig as JaxConfig
from flashmoe_tpu.models import transformer as jtf
from flashmoe_tpu.ops import health as jhlt
from flashmoe_tpu.ops import stats as jst
from flashmoe_tpu.runtime.trainer import host_metrics as jax_host_metrics
from flashmoe_tpu_torch.config import MoEConfig as TorchConfig
from flashmoe_tpu_torch.convert import params_from_numpy
from flashmoe_tpu_torch.models import transformer as ttf
from flashmoe_tpu_torch.ops import health as thlt
from flashmoe_tpu_torch.ops import stats as tst
from flashmoe_tpu_torch.ops.moe import moe_layer
from flashmoe_tpu_torch.runtime.trainer import host_metrics

LAYER = dict(num_experts=4, expert_top_k=2, hidden_size=64,
             intermediate_size=64, sequence_len=32, collect_stats=True)


def _jax0(fn, *args, **static):
    """``fn(*args, **static)``, the JAX reference jitted and compiled at
    XLA's CPU optimisation level 0, which halves the compile of these
    small programs."""
    return jax.jit(functools.partial(fn, **static)).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)


def _cfgs(**kw):
    return (JaxConfig(dtype=jnp.float32, param_dtype=jnp.float32, **kw),
            TorchConfig(dtype=torch.float32, param_dtype=torch.float32, **kw))


def _params(cfg, seed):
    """MoE-layer parameters from numpy."""
    rng = np.random.default_rng(seed)
    e, h, i = cfg.num_experts, cfg.hidden_size, cfg.intermediate_size

    def normal(shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    p = {"gate_w": normal((h, e), h ** -0.5),
         "w_up": normal((e, h, i), h ** -0.5), "b_up": normal((e, i), 0.1),
         "w_down": normal((e, i, h), i ** -0.5),
         "b_down": normal((e, h), 0.1)}
    if cfg.gated_ffn:
        p["w_gate"] = normal((e, h, i), h ** -0.5)
    return p


def _assert_stats(got, want):
    assert got._fields == want._fields
    for name, g, w in zip(got._fields, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_stats_off_and_degradation_healthy_change_nothing():
    """collect_stats off: no stats; degradation on with every expert
    healthy: the same output bit for bit (the renormalization ratio is
    exactly 1)."""
    _, tc = _cfgs(**dict(LAYER, collect_stats=False, drop_tokens=False))
    tp = params_from_numpy(_params(tc, seed=5), device="cpu")
    x = torch.randn(32, 64, generator=torch.Generator().manual_seed(5))
    plain = moe_layer(tp, x, tc)
    assert plain.stats is None
    degraded = moe_layer(tp, x, tc.replace(degrade_unhealthy_experts=True))
    assert torch.equal(plain.out, degraded.out)


@pytest.mark.parametrize("probs_zero", [False, True],
                         ids=["probs", "no_probs"])
def test_stats_functions_match_jax(probs_zero):
    """The stats helpers on one [E] load, with the gate's probabilities
    or without them (the two-pass gate without pass 2: entropy of the
    load instead), and against a capacity."""
    rng = np.random.default_rng(6)
    load = rng.integers(0, 20, 16).astype(np.float32)
    probs = np.zeros(16, np.float32) if probs_zero else \
        rng.dirichlet(np.ones(16)).astype(np.float32)
    jc, tc = _cfgs(num_experts=16)
    tl, tp = torch.from_numpy(load), torch.from_numpy(probs)
    for got, want in [
            (tst.load_imbalance(tl), jst.load_imbalance(load)),
            (tst.dist_entropy(tl), jst.dist_entropy(load)),
            (tst.router_entropy(tp, tl), jst.router_entropy(probs, load)),
            *zip(tst.drop_stats(tl, tc, 9), jst.drop_stats(load, jc, 9)),
            *zip(tst.drop_stats(tl, tc, None),
                 jst.drop_stats(load, jc, None))]:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_health_helpers_match_jax():
    """Health of the three layouts and the masked combine weights."""
    rng = np.random.default_rng(7)
    y = rng.standard_normal((6, 8, 4)).astype(np.float32)
    y[2, 5, 1] = np.inf
    rows = y.reshape(48, 4)
    gid = np.array([0, 1, 2, 2, 3, 3], np.int32)  # tiles of 8 rows
    counts = np.array([8, 8, 16, 10, 0, 0], np.int32)
    for got, want in [
            (thlt.expert_health_capacity(torch.from_numpy(y)),
             jhlt.expert_health_capacity(y)),
            (thlt.expert_health_tiles(torch.from_numpy(rows),
                                      torch.from_numpy(gid), 6, 8),
             jhlt.expert_health_tiles(rows, gid, 6, 8)),
            (thlt.expert_health_segments(torch.from_numpy(rows),
                                         torch.from_numpy(counts)),
             jhlt.expert_health_segments(rows, counts))]:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    healthy = np.array([True, False, True, True, False, True])
    idx = rng.integers(0, 6, (10, 2))
    cw = rng.uniform(0.1, 1, (10, 2)).astype(np.float32)
    for renorm in (False, True):
        got = thlt.mask_combine_weights(
            torch.from_numpy(cw), torch.from_numpy(idx),
            torch.from_numpy(healthy), renormalize=renorm)
        want = jhlt.mask_combine_weights(cw, idx, healthy,
                                         renormalize=renorm)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    for got, want in zip(
            thlt.degradation_stats(torch.from_numpy(healthy),
                                   torch.from_numpy(idx)),
            jhlt.degradation_stats(healthy, idx)):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_forward_and_loss_stats_match_jax():
    """forward's third output, one MoEStats per MoE layer (a dense layer
    has none), against JAX loss_fn's ``moe_stats`` metric (its forward on
    the same inputs), and the port's metric through the trainer's
    host_metrics against JAX's."""
    kw = dict(num_experts=4, expert_top_k=2, hidden_size=64,
              intermediate_size=64, num_layers=2, moe_frequency=2,
              vocab_size=256, num_heads=4, num_kv_heads=2, gated_ffn=True,
              hidden_act="silu", drop_tokens=True, capacity_factor=1.0,
              sequence_len=16, collect_stats=True)
    jc, tc = _cfgs(**kw)
    shapes = jax.eval_shape(lambda k: jtf.init_params(k, jc),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(8)
    jp = jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) / np.sqrt(s.shape[-1])
                   ).astype(np.float32), shapes)
    tp = params_from_numpy(jp, device="cpu")
    tok = rng.integers(0, 256, (2, 13)).astype(np.int32)
    _, jm = _jax0(jtf.loss_fn, jp, {"tokens": jnp.asarray(tok)}, cfg=jc)
    tt = torch.from_numpy(tok).long()
    _, _, got = ttf.forward(tp, tt[:, :-1], tc)
    assert len(got) == len(jm["moe_stats"]) == len(tc.moe_layer_indices) \
        == 1
    for g, w in zip(got, jm["moe_stats"]):
        _assert_stats(g, w)
    _, tm, _ = ttf.value_and_grad(tp, {"tokens": tt}, tc)
    want_host = jax_host_metrics(jm, jc.moe_layer_indices)
    got_host = host_metrics(tm, tc.moe_layer_indices)
    assert got_host.keys() == want_host.keys()
    for g, w in zip(got_host["moe"], want_host["moe"]):
        assert g.keys() == w.keys()
        for name in g:
            np.testing.assert_allclose(g[name], w[name], rtol=1e-5,
                                       atol=1e-6, err_msg=name)
