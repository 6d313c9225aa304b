"""PyTorch port: the gate and the dispatch/ragged plans against the JAX
package, on the same numpy inputs (CPU; the port runs its plain
versions there)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashmoe_tpu.config import MoEConfig as JaxConfig
from flashmoe_tpu.ops import dispatch as jdsp
from flashmoe_tpu.ops import ragged as jrag
from flashmoe_tpu.ops.gate import router_pallas, router_xla
from flashmoe_tpu_torch.config import MoEConfig as TorchConfig
from flashmoe_tpu_torch.models.reference import top_k_lowest_index
from flashmoe_tpu_torch.ops import dispatch as tdsp
from flashmoe_tpu_torch.ops import ragged as trag
from flashmoe_tpu_torch.ops.gate import router, router_cuda


# jitted once per shape: one compile is cheaper than eager op-by-op
_router_xla = jax.jit(router_xla, static_argnums=(2,))


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _plans(idx, jc, cap, bm):
    plan = jdsp.make_plan(idx, jc, cap)
    return (plan, jdsp.dispatch_indices(plan, jc, cap),
            jrag.make_ragged_plan(idx, jc, bm))


def _cfgs(**kw):
    return (JaxConfig(dtype=jnp.float32, **kw),
            TorchConfig(dtype=torch.float32, **kw))


def _inputs(s, h, e, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((s, h), dtype=np.float32)
    w = (rng.standard_normal((h, e)) / np.sqrt(h)).astype(np.float32)
    return x, w


def _assert_router_equal(got, want):
    """Ids and counts exact; f32 values at tests/test_gate.py's
    tolerances."""
    np.testing.assert_array_equal(got.expert_idx.numpy(),
                                  np.asarray(want.expert_idx))
    np.testing.assert_array_equal(got.expert_counts.numpy(),
                                  np.asarray(want.expert_counts))
    np.testing.assert_allclose(got.combine_weights.numpy(),
                               np.asarray(want.combine_weights),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.probs_mean.numpy(),
                               np.asarray(want.probs_mean),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(got.aux_loss), float(want.aux_loss),
                               rtol=1e-5)
    np.testing.assert_allclose(float(got.z_loss), float(want.z_loss),
                               rtol=1e-4)


def test_router_matches_pallas_gate_interpret():
    """The port's gate against the TPU gate kernel itself (interpret)."""
    jc, tc = _cfgs(num_experts=8, expert_top_k=2, hidden_size=128,
                   sequence_len=64, router_z_loss_coef=0.1)
    x, w = _inputs(64, 128, 8)
    want = router_pallas(jnp.asarray(x), jnp.asarray(w), jc, interpret=True)
    got = router(torch.from_numpy(x), torch.from_numpy(w), tc)
    _assert_router_equal(got, want)
    assert float(got.z_loss) > 0


@pytest.mark.parametrize("e,k,h,s", [
    (8, 2, 128, 128), (64, 4, 256, 256), (200, 6, 128, 128), (8, 1, 128, 128),
    (8, 2, 128, 4),  # a decode batch: S % 8 != 0
], ids=["e8k2", "e64k4", "e200k6", "e8k1", "s4"])
def test_router_matches_router_xla(e, k, h, s):
    jc, tc = _cfgs(num_experts=e, expert_top_k=k, hidden_size=h,
                   sequence_len=s, router_z_loss_coef=0.01)
    x, w = _inputs(s, h, e, seed=e + k)
    want = _router_xla(jnp.asarray(x), jnp.asarray(w), jc)
    got = router(torch.from_numpy(x), torch.from_numpy(w), tc)
    _assert_router_equal(got, want)
    assert int(got.expert_counts.sum()) == s * k


def test_top_k_lowest_index_wins_ties():
    p = torch.tensor([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25]])
    v, i = top_k_lowest_index(p, 3)
    assert i.tolist() == [[1, 2, 3], [0, 1, 2]]
    assert v[0].tolist() == pytest.approx([0.3, 0.3, 0.3])


def _expert_ids(s, k, e, seed):
    rng = np.random.default_rng(seed)
    # skewed routing so some experts overflow capacity and some are empty
    return rng.choice(e, size=(s, k), p=np.linspace(1, 3, e) / np.linspace(
        1, 3, e).sum()).astype(np.int32)


@pytest.mark.parametrize("s,k,e,cap,bm", [(64, 2, 8, 12, 64),
                                          (37, 3, 5, 64, 8),
                                          (4, 2, 8, 8, 64)],
                         ids=["drops", "odd", "decode"])
def test_plans_match_jax(s, k, e, cap, bm):
    """Capacity and ragged plans: every field exactly as JAX's."""
    jc, tc = _cfgs(num_experts=e, expert_top_k=k, hidden_size=64)
    idx = _expert_ids(s, k, e, seed=s)
    want, w_idx, w_rag = _plans(jnp.asarray(idx), jc, cap, bm)
    got = tdsp.make_plan(torch.from_numpy(idx), tc, cap)
    for name in ("position", "valid", "counts", "tok_sorted"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    for g, w in zip(tdsp.dispatch_indices(got, tc, cap), w_idx):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    got = trag.make_ragged_plan(torch.from_numpy(idx), tc, bm)
    for name in ("position", "tile_gid", "counts", "num_rows", "src_tok",
                 "present"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(w_rag, name)),
                                      err_msg=name)


def test_dispatch_and_combine_match_jax():
    s, k, e, h, cap = 32, 2, 4, 64, 12
    jc, tc = _cfgs(num_experts=e, expert_top_k=k, hidden_size=h)
    idx = _expert_ids(s, k, e, seed=3)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((s, h), dtype=np.float32)
    cw = rng.uniform(0.1, 1.0, (s, k)).astype(np.float32)

    @jax.jit
    def jax_side(idx, x, cw):
        plan = jdsp.make_plan(idx, jc, cap)
        buf = jdsp.dispatch(x, plan, jc, cap)
        return buf, jdsp.combine(buf, plan, cw, jc, cap)

    jbuf, jout = jax_side(jnp.asarray(idx), jnp.asarray(x), jnp.asarray(cw))
    tplan = tdsp.make_plan(torch.from_numpy(idx), tc, cap)
    tbuf = tdsp.dispatch(torch.from_numpy(x), tplan, tc, cap)
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))
    tout = tdsp.combine(tbuf, tplan, torch.from_numpy(cw), tc, cap)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-6,
                               atol=1e-6)


def test_gate_kernel_refuses_cpu_tensors():
    _, tc = _cfgs(num_experts=8, expert_top_k=2, hidden_size=64)
    x, w = (torch.from_numpy(a) for a in _inputs(16, 64, 8))
    with pytest.raises(ValueError, match="CUDA"):
        router(x, w, tc, use_kernels=True)
    with pytest.raises(ValueError, match="cuda"):
        router_cuda(x, w, tc)
    _, big = _cfgs(num_experts=300, expert_top_k=2, hidden_size=64)
    x, w = (torch.from_numpy(a) for a in _inputs(16, 64, 300))
    with pytest.raises(ValueError, match="two-pass"):
        router_cuda(x, w, big)
