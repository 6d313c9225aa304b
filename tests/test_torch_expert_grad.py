"""PyTorch port: the training kernels' plain versions (residual-saving FFN,
grouped matmul, transposed grouped matmul), the grouped FFN's backward,
the router's recompute backward and the MoE layer's gradients against the
JAX package, on the same numpy inputs (CPU).  Also: no kernel wrapper
runs under autograd, so no gradient can be cut without a word."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashmoe_tpu.config import MoEConfig as JaxConfig
from flashmoe_tpu.ops import expert as jexp
from flashmoe_tpu.ops.moe import moe_layer as jax_moe_layer
from flashmoe_tpu_torch.config import MoEConfig as TorchConfig
from flashmoe_tpu_torch.convert import params_from_numpy
from flashmoe_tpu_torch.models.reference import init_moe_params
from flashmoe_tpu_torch.ops import attention, expert as texp, gate
from flashmoe_tpu_torch.ops.moe import moe_layer

# tests/test_expert.py's shapes: 6 row tiles of 16 rows, expert 1 owns one
GID = np.array([0, 0, 1, 2, 2, 2], np.int32)
BM = 16


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _ffn_weights(rng, e, h, i, gated):
    p = {"w_up": _rand(rng, (e, h, i), h ** -0.5),
         "b_up": _rand(rng, (e, i), 0.1),
         "w_down": _rand(rng, (e, i, h), i ** -0.5),
         "b_down": _rand(rng, (e, h), 0.1)}
    if gated:
        p["w_gate"] = _rand(rng, (e, h, i), h ** -0.5)
    return p


@pytest.mark.parametrize("gated,act", [(True, "silu"), (False, "gelu")],
                         ids=["gated_silu", "gelu"])
def test_ffn_res_plain_matches_pallas_interpret(gated, act):
    """The plain residual-saving FFN against ``_grouped_ffn_res`` (the TPU
    kernel in interpret mode): y, u and g, f32 at 2e-4."""
    rng = np.random.default_rng(0)
    e, h, i = 3, 128, 256
    p = _ffn_weights(rng, e, h, i, gated)
    x = _rand(rng, (GID.size * BM, h))
    want = jexp._grouped_ffn_res(
        jnp.asarray(x), jnp.asarray(GID), p["w_up"], p["b_up"], p["w_down"],
        p["b_down"], p.get("w_gate"), act_name=act, gated=gated,
        block_m=BM, block_i=128, interpret=True)
    t = params_from_numpy(p, device="cpu")
    got = texp.grouped_ffn_res_plain(
        _t(x), _t(GID), t["w_up"], t["b_up"], t["w_down"], t["b_down"],
        t.get("w_gate"), act_name=act, gated=gated, block_m=BM)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4,
                                       atol=2e-4)


def test_ffn_res_plain_zeroes_the_ragged_tail():
    """Rows at or past num_rows come back zero in y, u and g."""
    rng = np.random.default_rng(1)
    t = params_from_numpy(_ffn_weights(rng, 3, 64, 64, True), device="cpu")
    x = _t(_rand(rng, (GID.size * BM, 64)))
    args = (x, _t(GID), t["w_up"], t["b_up"], t["w_down"], t["b_down"],
            t["w_gate"])
    kw = dict(act_name="silu", gated=True, block_m=BM)
    full = texp.grouped_ffn_res_plain(*args, **kw)
    cut = texp.grouped_ffn_res_plain(*args, num_rows=torch.tensor(3 * BM),
                                     **kw)
    for a, b in zip(full, cut):
        torch.testing.assert_close(b[:3 * BM], a[:3 * BM], rtol=0, atol=0)
        assert not b[3 * BM:].any()


@pytest.mark.parametrize("transpose_w", [False, True], ids=["w", "w_T"])
def test_grouped_matmul_plain_matches_pallas_interpret(transpose_w):
    rng = np.random.default_rng(2)
    e, k, n = 3, 128, 256
    x = _rand(rng, (GID.size * BM, k))
    w = _rand(rng, (e, n, k) if transpose_w else (e, k, n))
    want = jexp.grouped_matmul(jnp.asarray(x), jnp.asarray(GID),
                               jnp.asarray(w), transpose_w=transpose_w,
                               block_m=BM, out_dtype=jnp.float32,
                               interpret=True)
    got = texp.grouped_matmul_plain(_t(x), _t(GID), _t(w),
                                    transpose_w=transpose_w,
                                    out_dtype=torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("gid", [GID, np.array([0, 0, 2], np.int32)],
                         ids=["sorted", "zero_tile_expert"])
def test_tgmm_plain_matches_pallas_interpret(gid):
    """dW against ``tgmm``; an expert that owns no tile gets exactly 0."""
    rng = np.random.default_rng(3)
    x = _rand(rng, (gid.size * BM, 64))
    dy = _rand(rng, (gid.size * BM, 128))
    want = np.asarray(jexp.tgmm(jnp.asarray(x), jnp.asarray(dy),
                                jnp.asarray(gid), 3, block_m=BM,
                                interpret=True))
    got = texp.tgmm_plain(_t(x), _t(dy), _t(gid), 3)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    for e in set(range(3)) - set(gid.tolist()):
        assert not got[e].any() and (want[e] == 0).all()


def test_segment_bias_grad_matches_jax():
    rng = np.random.default_rng(4)
    d = _rand(rng, (GID.size * BM, 32))
    want = jexp._segment_bias_grad(jnp.asarray(d), jnp.asarray(GID), 4, BM)
    got = texp.segment_bias_grad(_t(d), _t(GID), 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def _jit(fn, *args):
    """``jax.jit(fn)(*args)`` compiled at XLA's CPU optimisation level 0,
    which halves the compile of these small reference programs."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)


def _ffn_grads_jax(xs, p, jc):
    def loss(xs, p):
        y = jexp.capacity_buffer_ffn_ad(xs, p, jc, interpret=True)
        return (y.astype(jnp.float32) ** 2).sum()

    return _jit(jax.grad(loss, argnums=(0, 1)), jnp.asarray(xs), p)


def _ffn_grads_torch(xs, p, tc, ffn):
    txs = _t(xs, grad=True)
    tp = {k: v.requires_grad_(True)
          for k, v in params_from_numpy(p, device="cpu").items()}
    y = ffn(txs, tp, tc)
    grads = torch.autograd.grad((y.float() ** 2).sum(), [txs, *tp.values()])
    return grads[0], dict(zip(tp, grads[1:]))


@pytest.mark.parametrize("e,h,i,gated,act", [
    (4, 128, 256, False, "gelu"), (2, 128, 512, True, "silu"),
    (2, 192, 320, False, "gelu")], ids=["gelu", "gated_silu", "h192_i320"])
def test_capacity_ffn_grads_match_jax_and_dense(e, h, i, gated, act):
    """``capacity_buffer_ffn_ad``'s gradients (x, every weight and bias)
    against ``jax.grad`` of the JAX function (Pallas, interpret) and
    against torch autograd of the dense FFN, at tests/test_expert.py's
    5e-3."""
    rng = np.random.default_rng(e + h + i)
    kw = dict(num_experts=e, hidden_size=h, intermediate_size=i,
              gated_ffn=gated, hidden_act=act)
    jc = JaxConfig(dtype=jnp.float32, param_dtype=jnp.float32, **kw)
    tc = TorchConfig(dtype=torch.float32, param_dtype=torch.float32, **kw)
    p = _ffn_weights(rng, e, h, i, gated)
    xs = _rand(rng, (e, 64, h))
    jgx, jgp = _ffn_grads_jax(xs, p, jc)
    gx, gp = _ffn_grads_torch(xs, p, tc, texp.capacity_buffer_ffn_ad)
    dx, dp = _ffn_grads_torch(xs, p, tc, texp.expert_ffn_dense)
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), rtol=5e-3,
                               atol=5e-3)
    np.testing.assert_allclose(gx.numpy(), dx.numpy(), rtol=5e-3, atol=5e-3)
    assert set(gp) == set(jgp)
    for k in gp:
        np.testing.assert_allclose(gp[k].numpy(), np.asarray(jgp[k]),
                                   rtol=5e-3, atol=5e-3, err_msg=k)
        np.testing.assert_allclose(gp[k].numpy(), dp[k].numpy(), rtol=5e-3,
                                   atol=5e-3, err_msg=k)


def test_router_recompute_backward_matches_plain_autograd(monkeypatch):
    """The router's Function (kernel forward, recompute backward) with the
    kernel replaced by its plain version: gradients of x and gate_w
    through the combine weights, probs_mean and both losses equal torch
    autograd of ``router_plain``; ids and counts carry none."""
    cfg = TorchConfig(num_experts=8, expert_top_k=2, hidden_size=64,
                      router_z_loss_coef=1e-2, dtype=torch.float32)
    monkeypatch.setattr(gate, "router_cuda", gate.router_plain)
    rng = np.random.default_rng(5)
    xn, wn = _rand(rng, (40, 64)), _rand(rng, (64, 8), 0.2)
    cot = _rand(rng, (40, 2))

    def grads(fn):
        x, w = _t(xn, grad=True), _t(wn, grad=True)
        out = gate.RouterOutput(*fn(x, w))
        loss = (out.combine_weights * _t(cot)).sum() + out.aux_loss \
            + out.z_loss + out.probs_mean[3]
        assert not out.expert_idx.requires_grad
        assert not out.expert_counts.requires_grad
        return torch.autograd.grad(loss, (x, w))

    got = grads(lambda x, w: gate._RouterAD.apply(x, w, cfg,
                                                  gate.router_cuda))
    want = grads(lambda x, w: gate.router_plain(x, w, cfg))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


LAYER = dict(num_experts=4, expert_top_k=2, hidden_size=64,
             intermediate_size=128, sequence_len=64)


@pytest.mark.parametrize("kw", [
    dict(LAYER, drop_tokens=False),
    dict(LAYER, drop_tokens=False, gated_ffn=True, hidden_act="silu"),
    dict(LAYER, drop_tokens=True, capacity_factor=1.0)],
    ids=["dropless", "dropless_gated", "capacity"])
def test_moe_layer_grads_match_jax(kw):
    """Every parameter's gradient of ``sum(out**2) + aux`` (gate_w
    included) and x's against ``jax.grad`` of JAX ``moe_layer``, at
    tests/test_moe_layer.py's 1e-3 / 1e-4."""
    jc = JaxConfig(dtype=jnp.float32, param_dtype=jnp.float32, **kw)
    tc = TorchConfig(dtype=torch.float32, param_dtype=torch.float32, **kw)
    shapes = init_moe_params(torch.Generator().manual_seed(0), tc)
    rng = np.random.default_rng(6)
    p = {k: _rand(rng, tuple(v.shape), 0.3 if k.startswith("b") else
                  v.shape[-2] ** -0.5) for k, v in shapes.items()}
    x = _rand(rng, (tc.tokens, tc.hidden_size))

    def jloss(p, x):
        o = jax_moe_layer(p, x, jc, use_pallas=False)
        return jnp.sum(o.out ** 2) + o.aux_loss

    jgp, jgx = _jit(jax.grad(jloss, argnums=(0, 1)), p, jnp.asarray(x))
    tp = {k: v.requires_grad_(True)
          for k, v in params_from_numpy(p, device="cpu").items()}
    tx = _t(x, grad=True)
    o = moe_layer(tp, tx, tc)
    grads = torch.autograd.grad(torch.sum(o.out ** 2) + o.aux_loss,
                                [tx, *tp.values()])
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jgx), rtol=1e-3,
                               atol=1e-4)
    for k, g in zip(tp, grads[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgp[k]), rtol=1e-3,
                                   atol=1e-4, err_msg=k)
    assert float(grads[1 + list(tp).index("gate_w")].abs().max()) > 0


def _cuda_calls():
    """Each kernel wrapper with CPU arguments that require grad."""
    x = torch.randn(64, 64, requires_grad=True)
    w3 = torch.randn(1, 64, 64, requires_grad=True)
    b = torch.zeros(1, 64, requires_grad=True)
    gid = torch.zeros(1, dtype=torch.long)
    q = torch.randn(1, 1, 8, 64, requires_grad=True)
    cfg = TorchConfig(num_experts=2, expert_top_k=1, hidden_size=64)
    ffn = dict(act_name="relu", block_m=64)
    return {
        "router_cuda": lambda: gate.router_cuda(
            x, torch.randn(64, 2, requires_grad=True), cfg),
        "grouped_ffn_cuda": lambda: texp.grouped_ffn_cuda(
            x, gid, w3, b, w3, b, **ffn),
        "grouped_ffn_res_cuda": lambda: texp.grouped_ffn_res_cuda(
            x, gid, w3, b, w3, b, **ffn),
        "grouped_matmul_cuda": lambda: texp.grouped_matmul_cuda(x, gid, w3),
        "tgmm_cuda": lambda: texp.tgmm_cuda(x, x, gid, 1),
        "flash_attention_cuda": lambda: attention.flash_attention_cuda(
            q, q, q),
    }


@pytest.mark.parametrize("name", sorted(_cuda_calls()))
def test_kernel_wrappers_refuse_autograd(name):
    """Under autograd a kernel's output would carry no gradient, so every
    wrapper raises; without grad the same call gets as far as the device
    check."""
    call = _cuda_calls()[name]
    with pytest.raises(RuntimeError, match="autograd"):
        call()
    with torch.no_grad(), pytest.raises(ValueError, match="cuda"):
        call()
