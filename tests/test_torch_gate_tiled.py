"""PyTorch port: the two-pass expert-tiled gate and the router's choice of
gate against the JAX package, on the same numpy inputs (CPU; the port
runs the kernels' plain versions there)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashmoe_tpu.config import MoEConfig as JaxConfig
from flashmoe_tpu.ops.gate import apply_replicas as jax_apply_replicas
from flashmoe_tpu.ops.gate import gate_vmem_bytes as jax_gate_vmem_bytes
from flashmoe_tpu.ops.gate import router as jax_router
from flashmoe_tpu.ops.gate import router_pallas_tiled, router_xla
from flashmoe_tpu_torch.config import MoEConfig as TorchConfig
from flashmoe_tpu_torch.ops import gate as tg


def _jax0(fn, *args, **static):
    """``fn(*args, **static)``, the JAX reference jitted and compiled at
    XLA's CPU optimisation level 0, which halves the compile of these
    small programs."""
    return jax.jit(functools.partial(fn, **static)).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)


def _router_xla(x, w, jc):
    return _jax0(router_xla, x, w, cfg=jc)


def _cfgs(**kw):
    return (JaxConfig(dtype=jnp.float32, **kw),
            TorchConfig(dtype=torch.float32, **kw))


def _inputs(s, h, e, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((s, h), dtype=np.float32)
    w = (rng.standard_normal((h, e)) / np.sqrt(h)).astype(np.float32)
    return x, w


def _assert_router_equal(got, want):
    """Ids and counts exact; f32 values at 1e-4 (sums in another
    order: the TPU kernel rescales its running sum tile by tile)."""
    np.testing.assert_array_equal(got.expert_idx.numpy(),
                                  np.asarray(want.expert_idx))
    np.testing.assert_array_equal(got.expert_counts.numpy(),
                                  np.asarray(want.expert_counts))
    np.testing.assert_allclose(got.combine_weights.numpy(),
                               np.asarray(want.combine_weights),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.probs_mean.numpy(),
                               np.asarray(want.probs_mean),
                               rtol=1e-4, atol=1e-7)
    for name in ("aux_loss", "z_loss"):
        np.testing.assert_allclose(float(getattr(got, name)),
                                   float(getattr(want, name)), rtol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("e,k,need_stats", [(600, 2, True),
                                            (1280, 6, False)],
                         ids=["e600k2_stats", "e1280k6_no_stats"])
def test_router_tiled_plain_matches_pallas_interpret(e, k, need_stats):
    """Both passes against the TPU kernels themselves (interpret mode),
    with the statistics pass and without (counts from the ids, aux and z
    losses 0)."""
    jc, tc = _cfgs(num_experts=e, expert_top_k=k, hidden_size=64,
                   router_z_loss_coef=0.01)
    x, w = _inputs(32, 64, e, seed=e + k)
    want = _jax0(router_pallas_tiled, jnp.asarray(x), jnp.asarray(w),
                 cfg=jc, interpret=True, need_stats=need_stats)
    got = tg.router_tiled_plain(torch.from_numpy(x), torch.from_numpy(w),
                                tc, need_stats)
    _assert_router_equal(got, want)
    assert (float(got.aux_loss) > 0) == need_stats


@pytest.mark.parametrize("e,k", [(300, 2), (600, 33), (1280, 64)],
                         ids=["e300k2", "e600k33", "e1280k64"])
def test_router_tiled_plain_matches_router_xla(e, k):
    """With the statistics pass the tiled gate is router_xla's function,
    K = 64 (the merge's limit) included."""
    jc, tc = _cfgs(num_experts=e, expert_top_k=k, hidden_size=128,
                   router_z_loss_coef=0.01)
    x, w = _inputs(40, 128, e, seed=k)
    want = _router_xla(jnp.asarray(x), jnp.asarray(w), jc)
    got = tg.router_tiled_plain(torch.from_numpy(x), torch.from_numpy(w),
                                tc, True)
    _assert_router_equal(got, want)


@pytest.mark.parametrize("e,k,h", [(64, 33, 64), (300, 2, 64),
                                   (18944, 2, 128)],
                         ids=["e64k33_single", "e300_single", "e18944_tiled"])
def test_router_matches_jax_router_choice(e, k, h):
    """The port's router against JAX router(use_pallas, interpret) where
    the two choose different gates.  E <= 256 with K > 32 and E = 300
    both take the port's two-pass gate while JAX, within its VMEM budget,
    takes its single-tile gate, which always computes the statistics; so
    the port runs pass 2 there, and aux_loss agrees.  At E = 18944 both
    take the two-pass gate without pass 2: aux_loss 0 on both sides.
    JAX takes router_xla at S % 8 != 0, so the port runs pass 2 there
    too."""
    s = 8
    jc, tc = _cfgs(num_experts=e, expert_top_k=k, hidden_size=h)
    x, w = _inputs(s, h, e, seed=k)
    fits = jax_gate_vmem_bytes(s, h, e, jnp.float32) <= 12 * 2**20
    assert fits == (e < 18944)
    for ss in (s, 12):
        assert tg.gate_vmem_bytes(ss, h, e, torch.float32) \
            == jax_gate_vmem_bytes(ss, h, e, jnp.float32)
    assert tg.tiled_need_stats(tc, s, h, torch.float32) == fits
    assert tg.tiled_need_stats(tc, 12, h, torch.float32)
    want = _jax0(jax_router, jnp.asarray(x), jnp.asarray(w), cfg=jc,
                 use_pallas=True, interpret=True)
    got = tg.router(torch.from_numpy(x), torch.from_numpy(w), tc)
    _assert_router_equal(got, want)
    assert (float(got.aux_loss) == 0) == (not fits)


def test_router_takes_plain_router_past_the_merge():
    """2K > 128: the plain router by configuration, as JAX router takes
    router_xla."""
    jc, tc = _cfgs(num_experts=300, expert_top_k=65, hidden_size=64)
    x, w = _inputs(16, 64, 300, seed=3)
    want = _router_xla(jnp.asarray(x), jnp.asarray(w), jc)
    got = tg.router(torch.from_numpy(x), torch.from_numpy(w), tc)
    _assert_router_equal(got, want)


def test_tiled_gate_breaks_ties_by_lowest_expert_id():
    """Equal logits across and within expert tiles: the lowest ids win,
    in the order router_xla gives."""
    e, h = 300, 64
    jc, tc = _cfgs(num_experts=e, expert_top_k=4, hidden_size=h)
    w = np.zeros((h, e), np.float32)
    w[0, [5, 70, 130, 200, 299]] = 1.0  # five experts tied at the top
    w[0, [1, 2]] = 0.5
    x = np.zeros((8, h), np.float32)
    x[:, 0] = 1.0
    want = _router_xla(jnp.asarray(x), jnp.asarray(w), jc)
    got = tg.router_tiled_plain(torch.from_numpy(x), torch.from_numpy(w),
                                tc, True)
    assert got.expert_idx[0].tolist() == [5, 70, 130, 200]
    _assert_router_equal(got, want)


def test_apply_replicas_matches_jax():
    e = 300
    jc, tc = _cfgs(num_experts=e, expert_top_k=2, hidden_size=64,
                   expert_replicas=((7, 11), (3, 250)))
    x, w = _inputs(24, 64, e, seed=9)
    w[:, 7] += 0.5  # make expert 7 hot
    want = _jax0(lambda x, w: jax_apply_replicas(router_xla(x, w, jc), jc),
                 jnp.asarray(x), jnp.asarray(w))
    got = tg.router(torch.from_numpy(x), torch.from_numpy(w), tc)
    _assert_router_equal(got, want)
    assert 0 < int(got.expert_counts[11]) and 0 < int(got.expert_counts[7])


@pytest.mark.parametrize("kw", [
    dict(expert_replicas=[(1, 2)]), dict(expert_replicas=((1, 1),)),
    dict(expert_replicas=((1, 9),)), dict(expert_replicas=((1, 2), (3, 2))),
    dict(expert_replicas=((1, 2), (1, 3))),
    dict(expert_replicas=((1, 2), (2, 3))),
], ids=["list", "self", "range", "slot_twice", "hot_twice", "chain"])
def test_replica_map_validation_matches_jax(kw):
    with pytest.raises(ValueError) as jerr:
        JaxConfig(num_experts=8, **kw)
    with pytest.raises(ValueError) as terr:
        TorchConfig(num_experts=8, **kw)
    assert str(terr.value) == str(jerr.value)


def test_tiled_router_backward_recomputes_plain_router():
    """Through the two-pass gate, the gradients of the combine weights and
    the aux loss are router_plain's (the JAX custom VJP's backward)."""
    _, tc = _cfgs(num_experts=300, expert_top_k=3, hidden_size=64,
                  router_z_loss_coef=0.01)
    x, w = (torch.from_numpy(a) for a in _inputs(16, 64, 300, seed=4))
    ct = torch.randn(16, 3, generator=torch.Generator().manual_seed(0))

    def grads(fn):
        xs, ws = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        o = fn(xs, ws, tc)
        loss = (o.combine_weights * ct).sum() + o.aux_loss + o.z_loss
        return torch.autograd.grad(loss, (xs, ws))

    for g, p in zip(grads(tg.router), grads(tg.router_plain)):
        torch.testing.assert_close(g, p, rtol=1e-5, atol=1e-6)


def test_tiled_gate_kernels_refuse_cpu_tensors():
    x, w = (torch.from_numpy(a) for a in _inputs(16, 64, 300))
    with pytest.raises(ValueError, match="cuda"):
        tg.gate_pass1_cuda(x, w, 2, True)
    with pytest.raises(ValueError, match="K <="):
        tg.gate_pass1_cuda(x, w, 65, True)
    logits, m, se, _, top_i = tg.gate_pass1_plain(x, w, 2, True)
    with pytest.raises(ValueError, match="cuda"):
        tg.gate_pass2_cuda(logits, m, se, top_i, 300)
