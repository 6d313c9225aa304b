"""PyTorch port: the gather-fused grouped FFN and the gather arms of the
MoE layer against the JAX package, on the same numpy inputs (CPU; the
port runs the kernel's plain version there)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashmoe_tpu.config import MoEConfig as JaxConfig
from flashmoe_tpu.models.reference import init_moe_params as jinit
from flashmoe_tpu.ops import dispatch as jdsp
from flashmoe_tpu.ops import expert as jexp
from flashmoe_tpu.ops.moe import moe_layer as jax_moe_layer
from flashmoe_tpu_torch.config import MoEConfig as TorchConfig
from flashmoe_tpu_torch.convert import params_from_numpy
from flashmoe_tpu_torch.models.reference import init_moe_params as tinit
from flashmoe_tpu_torch.ops import dispatch as tdsp
from flashmoe_tpu_torch.ops import expert as texp
from flashmoe_tpu_torch.ops import ragged as trag
from flashmoe_tpu_torch.ops.moe import moe_layer

TOL = 2e-4  # f32, tests/test_expert.py's tolerance
LAYER = dict(num_experts=4, expert_top_k=2, hidden_size=64,
             intermediate_size=128, sequence_len=32, gather_fused=True)


def _jax0(fn, *args, **static):
    """``fn(*args, **static)``, the JAX reference jitted and compiled at
    XLA's CPU optimisation level 0, which halves the compile of these
    small programs."""
    return jax.jit(functools.partial(fn, **static)).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)


def _cfgs(**kw):
    return (JaxConfig(dtype=jnp.float32, param_dtype=jnp.float32, **kw),
            TorchConfig(dtype=torch.float32, param_dtype=torch.float32, **kw))


def _params(e, h, i, gated, seed, shared=0):
    rng = np.random.default_rng(seed)

    def normal(shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    p = {"gate_w": normal((h, e), h ** -0.5),
         "w_up": normal((e, h, i), h ** -0.5), "b_up": normal((e, i), 0.3),
         "w_down": normal((e, i, h), i ** -0.5),
         "b_down": normal((e, h), 0.3)}
    if gated:
        p["w_gate"] = normal((e, h, i), h ** -0.5)
    if shared:
        si = i * shared
        p["shared_w_up"] = normal((h, si), h ** -0.5)
        p["shared_w_down"] = normal((si, h), si ** -0.5)
        if gated:
            p["shared_w_gate"] = normal((h, si), h ** -0.5)
    return p


def test_grouped_ffn_tokens_plain_matches_pallas_interpret():
    """The plain gather-fused FFN (gated SiLU) against the TPU kernel
    itself (interpret) on a ragged plan's map, at the populated rows (an
    empty slot computes token 0 on both sides, and the combine never reads
    it)."""
    gated, act = True, "silu"
    e, h, i, s, bm = 4, 64, 128, 40, 64
    tc = TorchConfig(num_experts=e, expert_top_k=2, hidden_size=h,
                     drop_tokens=False)
    rng = np.random.default_rng(7)
    ids = rng.integers(0, e, (s, 2))
    ids[:, 1] = (ids[:, 0] + 1 + rng.integers(0, e - 1, s)) % e
    plan = trag.make_ragged_plan(torch.from_numpy(ids), tc, bm)
    x = rng.standard_normal((s, h)).astype(np.float32)
    p = _params(e, h, i, gated, seed=8)
    src, gid = plan.src_tok.numpy().astype(np.int32), \
        plan.tile_gid.numpy().astype(np.int32)
    want = _jax0(jexp.grouped_ffn_tokens, jnp.asarray(x), jnp.asarray(src),
                 jnp.asarray(gid), p["w_up"], p["b_up"], p["w_down"],
                 p["b_down"], p.get("w_gate"), act_name=act, gated=gated,
                 block_m=bm, block_i=64, interpret=True)
    t = params_from_numpy(p, device="cpu")
    got = texp.grouped_ffn_tokens(
        torch.from_numpy(x), plan.src_tok, plan.tile_gid, t["w_up"],
        t["b_up"], t["w_down"], t["b_down"], t.get("w_gate"), act_name=act,
        gated=gated, block_m=bm, num_rows=plan.num_rows)
    live = plan.present.numpy()
    assert live.sum() == 2 * s
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                               rtol=TOL, atol=TOL)
    # the same rows as the grouped FFN on the dispatched buffer, exactly
    xbuf = trag.ragged_dispatch(torch.from_numpy(x), plan, tc, bm)
    ref = texp.grouped_ffn(xbuf, plan.tile_gid, t["w_up"], t["b_up"],
                           t["w_down"], t["b_down"], t.get("w_gate"),
                           act_name=act, gated=gated, block_m=bm,
                           num_rows=plan.num_rows)
    assert torch.equal(got[torch.from_numpy(live)],
                       ref[torch.from_numpy(live)])


def test_capacity_ffn_gather_matches_jax():
    """The capacity arm's gather-fused FFN against JAX's, at the slots a
    combine reads (each side pads the capacity 70 to its own row tile)."""
    cap = 70
    jc, tc = _cfgs(**dict(LAYER, capacity_factor=1.0))
    e, h = jc.num_experts, jc.hidden_size
    p = _params(e, h, 128, False, seed=cap)
    rng = np.random.default_rng(cap)
    x = rng.standard_normal((32, h)).astype(np.float32)
    idx = rng.integers(0, e, (32, 2)).astype(np.int32)
    idx[:, 1] = (idx[:, 0] + 1) % e

    def jax_side(x, idx):
        plan = jdsp.make_plan(idx, jc, cap)
        return plan, jexp.capacity_ffn_gather(x, plan, jc, cap, p,
                                              interpret=True)[0]

    jplan, jy = _jax0(jax_side, jnp.asarray(x), jnp.asarray(idx))
    tplan = tdsp.make_plan(torch.from_numpy(idx), tc, cap)
    ty, cp = texp.capacity_ffn_gather(torch.from_numpy(x), tplan, tc, cap,
                                      params_from_numpy(p, device="cpu"))
    assert cp % texp.ROW_TILE == 0 and ty.shape == (e, cp, h)
    filled = np.arange(cap)[None, :] < np.minimum(
        np.asarray(jplan.counts), cap)[:, None]  # [E, cap] occupied slots
    np.testing.assert_allclose(ty.numpy()[:, :cap][filled],
                               np.asarray(jy)[:, :cap][filled], rtol=TOL,
                               atol=TOL)


ARMS = {
    "dropless": dict(LAYER, drop_tokens=False, gated_ffn=True,
                     hidden_act="silu"),
    "capacity": dict(LAYER, drop_tokens=True, capacity_factor=0.75,
                     hidden_act="gelu"),
}
# the layer options ride both arms: routing statistics, and tier-0
# degradation masking expert 1, whose w_down holds a NaN
OPTIONS = dict(collect_stats=True, degrade_unhealthy_experts=True,
               router_z_loss_coef=0.01)


@functools.lru_cache(maxsize=None)
def _jax_gather_arm(arm):
    """JAX moe_layer(use_pallas=True, interpret=True) with gather_fused on
    the arm's config, once per arm (one interpret compile each)."""
    jc, _ = _cfgs(**ARMS[arm], **OPTIONS)
    p, x = _sick_layer(jc)
    return p, x, _jax0(jax_moe_layer, p, jnp.asarray(x), cfg=jc,
                       use_pallas=True, interpret=True)


def _sick_layer(cfg):
    p = _params(4, 64, 128, cfg.gated_ffn, seed=3)
    p["w_down"][1, 3, :] = np.nan
    x = np.random.default_rng(4).standard_normal((32, 64)).astype(
        np.float32)
    return p, x


@pytest.mark.parametrize("gather", [True, False], ids=["gather", "explicit"])
@pytest.mark.parametrize("arm", sorted(ARMS))
def test_gather_arms_match_jax_moe_layer(arm, gather):
    """Both arms of the layer, gather-fused (inference) and through the
    dispatch buffer, against JAX's gather arm (moe_layer(use_pallas=True,
    interpret=True) with gather_fused=True), with the layer options on:
    the same output, routing and losses, and the same MoEStats, tier-0
    degradation having masked expert 1 on both sides."""
    p, x, want = _jax_gather_arm(arm)
    _, tc = _cfgs(**dict(ARMS[arm], gather_fused=gather), **OPTIONS)
    got = moe_layer(params_from_numpy(p, device="cpu"), torch.from_numpy(x),
                    tc)
    assert torch.isfinite(got.out).all()
    np.testing.assert_allclose(got.out.numpy(), np.asarray(want.out),
                               rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got.expert_counts.numpy(),
                                  np.asarray(want.expert_counts))
    for name in ("aux_loss", "z_loss"):
        np.testing.assert_allclose(float(getattr(got, name)),
                                   float(getattr(want, name)), rtol=1e-4)
    assert got.stats._fields == want.stats._fields
    for name, g, w in zip(got.stats._fields, got.stats, want.stats):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    assert float(got.stats.masked_experts) == 1


def test_gather_fused_follows_env(monkeypatch):
    """gather_fused=None follows FLASHMOE_GATHER_FUSED=1; training never
    takes the gather arm."""
    _, tc = _cfgs(**dict(LAYER, gather_fused=None, drop_tokens=False))
    tp = params_from_numpy(_params(4, 64, 128, False, seed=2), device="cpu")
    x = torch.randn(32, 64, generator=torch.Generator().manual_seed(0))
    calls = []
    real = texp.grouped_ffn_tokens_ad
    monkeypatch.setattr(texp, "grouped_ffn_tokens_ad",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    moe_layer(tp, x, tc)
    assert not calls
    monkeypatch.setenv("FLASHMOE_GATHER_FUSED", "1")
    moe_layer(tp, x, tc)
    assert calls == [1]
    moe_layer(tp, x, tc.replace(is_training=True))
    assert calls == [1]


def _grads(p, x, cfg):
    """d(sum(out**2) + aux) for x and every parameter, and the loss."""
    tp = {k: v.requires_grad_(True)
          for k, v in params_from_numpy(p, device="cpu").items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    o = moe_layer(tp, tx, cfg)
    loss = torch.sum(o.out ** 2) + o.aux_loss
    return float(loss.detach()), dict(zip(["x", *tp], torch.autograd.grad(
        loss, [tx, *tp.values()])))


def test_gather_arm_grads_match_jax():
    """Gradients through the dropless gather arm's re-gathering backward
    against jax.grad of the JAX layer (its XLA arm, as
    tests/test_moe_layer.py holds JAX's own gather arm), at that test's
    5e-3: x's and every parameter's."""
    kw = dict(LAYER, drop_tokens=False, intermediate_size=64,
              gated_ffn=True, hidden_act="silu")
    jc, tc = _cfgs(**kw)
    p = _params(4, 64, 64, True, seed=11)
    x = np.random.default_rng(11).standard_normal((32, 64)).astype(
        np.float32)

    def jloss(p, x):
        o = jax_moe_layer(p, x, jc, use_pallas=False)
        return jnp.sum(o.out ** 2) + o.aux_loss

    jl, (jgp, jgx) = _jax0(jax.value_and_grad(jloss, argnums=(0, 1)), p,
                           jnp.asarray(x))
    loss, got = _grads(p, x, tc)
    np.testing.assert_allclose(loss, float(jl), rtol=1e-5)
    np.testing.assert_allclose(got.pop("x").numpy(), np.asarray(jgx),
                               rtol=5e-3, atol=5e-3)
    for k, g in got.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(jgp[k]), rtol=5e-3,
                                   atol=5e-3, err_msg=k)


def test_capacity_gather_arm_grads_match_explicit_arm():
    """The capacity arm's gradients are the same function gather-fused and
    through the dispatch buffer (whose gradients tests/test_torch_expert_grad
    holds against jax.grad)."""
    kw = dict(LAYER, drop_tokens=True, capacity_factor=1.0,
              intermediate_size=64, hidden_act="gelu")
    _, tc = _cfgs(**kw)
    p = _params(4, 64, 64, False, seed=13)
    x = np.random.default_rng(13).standard_normal((32, 64)).astype(
        np.float32)
    loss, got = _grads(p, x, tc)
    want_loss, want = _grads(p, x, tc.replace(gather_fused=False))
    np.testing.assert_allclose(loss, want_loss, rtol=1e-6)
    for k, g in got.items():
        torch.testing.assert_close(g, want[k], rtol=1e-5, atol=1e-6,
                                   msg=k)


def test_gather_kernel_refuses_cpu_tensors():
    t = params_from_numpy(_params(2, 64, 64, False, seed=0), device="cpu")
    args = (torch.zeros(8, 64), torch.zeros(64, dtype=torch.long),
            torch.tensor([0]), t["w_up"], t["b_up"], t["w_down"],
            t["b_down"])
    with pytest.raises(ValueError, match="CUDA"):
        texp.grouped_ffn_tokens(*args, act_name="relu", use_kernels=True)
    with pytest.raises(ValueError, match="cuda"):
        texp.grouped_ffn_tokens_cuda(*args, act_name="relu", block_m=64)


def test_many_expert_layer_matches_jax():
    """Qwen3-Next-80B-A3B's MoE layer shape (E 512, top-10, SwiGLU, one
    shared expert, dropless) at H = I = 64: a JAX parameter tree with its
    shared-expert leaves crosses through params_from_numpy, and the port's
    layer (the two-pass gate, the gather-fused FFN) matches JAX's XLA
    arm."""
    kw = dict(num_experts=512, expert_top_k=10, hidden_size=64,
              intermediate_size=64, sequence_len=32, num_shared_experts=1,
              gated_ffn=True, hidden_act="silu", drop_tokens=False,
              gather_fused=True, router_z_loss_coef=0.01)
    jc, tc = _cfgs(**kw)
    p = _params(512, 64, 64, True, seed=12, shared=1)
    tp = params_from_numpy(p, device="cpu")
    shapes = jax.eval_shape(lambda k: jinit(k, jc), jax.random.PRNGKey(0))
    port = tinit(torch.Generator().manual_seed(0), tc)
    assert set(shapes) == set(p) == set(tp) == set(port)
    for k, s in shapes.items():
        assert tuple(tp[k].shape) == tuple(port[k].shape) == s.shape, k
    x = np.random.default_rng(12).standard_normal((32, 64)).astype(
        np.float32)
    want = _jax0(jax_moe_layer, p, jnp.asarray(x), cfg=jc, use_pallas=False)
    got = moe_layer(tp, torch.from_numpy(x), tc)
    np.testing.assert_allclose(got.out.numpy(), np.asarray(want.out),
                               rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got.expert_counts.numpy(),
                                  np.asarray(want.expert_counts))
    for name in ("aux_loss", "z_loss"):
        np.testing.assert_allclose(float(getattr(got, name)),
                                   float(getattr(want, name)), rtol=1e-4)
