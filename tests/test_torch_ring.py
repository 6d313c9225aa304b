"""PyTorch port: ring attention over the sp axis of a local mesh against
the JAX package's ``ring_attention`` on its 8-device CPU mesh, on the same
numpy inputs: f32 at sp 2, 4 and 8, causal and not; bf16 long context at
JAX's own tolerance; the gradient through autograd against ``jax.grad``;
and the uneven-length refusal."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from flashmoe_tpu.ops.attention import attention_xla
from flashmoe_tpu.parallel.ringattn import ring_attention as jring
from flashmoe_tpu_torch.ops.attention import attention_plain
from flashmoe_tpu_torch.parallel.mesh import make_mesh
from flashmoe_tpu_torch.parallel.ringattn import ring_attention

TOL = 2e-4


def _qkv(b=1, n=2, t=256, d=64, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, n, t, d)).astype(np.float32)
            for _ in range(3)]


def _jax_ring(q, k, v, sp, causal, dtype=jnp.float32):
    mesh = JaxMesh(np.asarray(jax.devices()[:sp]), ("sp",))
    args = [jnp.asarray(a, dtype) for a in (q, k, v)]
    fn = jax.jit(functools.partial(jring, mesh=mesh, causal=causal))
    return fn(*args)


@pytest.mark.parametrize("sp,causal", [(2, True), (2, False), (4, True),
                                       (4, False), (8, True), (8, False)])
def test_ring_attention_matches_jax(sp, causal):
    q, k, v = _qkv(t=128, seed=sp)
    want = _jax_ring(q, k, v, sp, causal)
    m = make_mesh(sp=sp, device="cpu")
    got = ring_attention(*(torch.from_numpy(a) for a in (q, k, v)), m,
                         causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    # and the whole-sequence attention, as JAX's own test holds it
    full = attention_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                           causal=causal)
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=TOL,
                               atol=TOL)


def test_ring_attention_bf16_long_context():
    """8-way sharded 2048-token causal attention on bf16 inputs, at JAX's
    long-context tolerance against the f32 attention; against JAX's own
    bf16 ring within a bf16 rounding."""
    q, k, v = _qkv(b=1, n=1, t=2048, d=64, seed=3)
    want = np.asarray(attention_xla(*(jnp.asarray(a) for a in (q, k, v)),
                                    causal=True))
    m = make_mesh(sp=8, device="cpu")
    got = ring_attention(*(torch.from_numpy(a).to(torch.bfloat16)
                           for a in (q, k, v)), m, causal=True)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.abs(got - want).max() / np.abs(want).max() < 0.05
    jgot = np.asarray(_jax_ring(q, k, v, 8, True, jnp.bfloat16)
                      .astype(jnp.float32))
    np.testing.assert_allclose(got, jgot, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_grad_matches_jax(causal):
    q, k, v = _qkv(t=64, d=32, seed=5)
    ct = np.random.default_rng(9).standard_normal(q.shape).astype(
        np.float32)
    mesh = JaxMesh(np.asarray(jax.devices()[:4]), ("sp",))

    def jloss(q, k, v):
        return jnp.sum(jring(q, k, v, mesh, causal=causal) * ct)

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        *(jnp.asarray(a) for a in (q, k, v)))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = ring_attention(*ts, make_mesh(sp=4, device="cpu"), causal=causal)
    got = torch.autograd.grad((out * torch.from_numpy(ct)).sum(), ts)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL)


def test_ring_attention_refuses_an_uneven_split():
    q = torch.zeros(1, 1, 30, 8)
    with pytest.raises(ValueError, match="does not split over sp=4"):
        ring_attention(q, q, q, make_mesh(sp=4, device="cpu"))
