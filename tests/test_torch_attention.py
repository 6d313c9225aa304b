"""PyTorch port: flash attention against the JAX package, on the same
numpy inputs (CPU; the port runs the kernel's plain version)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashmoe_tpu.ops.attention import attention_xla, flash_attention
from flashmoe_tpu_torch.ops import attention as tatt

_attention_xla = jax.jit(attention_xla, static_argnames=("causal",))


def _qkv(b, n, nkv, t, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, n, t, d)).astype(np.float32)
    k = rng.standard_normal((b, nkv, t, d)).astype(np.float32)
    v = rng.standard_normal((b, nkv, t, d)).astype(np.float32)
    return q, k, v


def test_flash_matches_pallas_interpret():
    """The plain flash attention against the TPU kernel itself
    (interpret), f32 at tests/test_attention.py's 2e-4."""
    q, k, v = _qkv(1, 2, 2, 128, 64)
    want = flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=True, block_q=64, block_k=64,
                           interpret=True)
    got = tatt.flash_attention(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("causal,n,nkv,t", [(True, 4, 4, 40),
                                            (False, 4, 4, 40),
                                            (True, 8, 2, 72)],
                         ids=["causal", "full", "gqa"])
def test_flash_matches_attention_xla(causal, n, nkv, t):
    """Against the XLA oracle with GQA heads repeated as jnp.repeat does;
    T is not a multiple of any block."""
    q, k, v = _qkv(2, n, nkv, t, 64, seed=t)
    kr, vr = (np.repeat(a, n // nkv, axis=1) for a in (k, v))
    want = _attention_xla(jnp.asarray(q), jnp.asarray(kr), jnp.asarray(vr),
                          causal=causal)
    got = tatt.flash_attention(*map(torch.from_numpy, (q, k, v)),
                               causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


def test_flash_kernel_refuses_what_it_does_not_take():
    q, k, v = map(torch.from_numpy, _qkv(1, 2, 2, 16, 64))
    with pytest.raises(ValueError, match="CUDA"):
        tatt.flash_attention(q, k, v, use_kernels=True)
    with pytest.raises(ValueError, match="cuda"):
        tatt.flash_attention_cuda(q, k, v)
    q96, k96, v96 = map(torch.from_numpy, _qkv(1, 2, 2, 16, 96))
    with pytest.raises(ValueError, match="D in"):
        tatt.flash_attention_cuda(q96, k96, v96)
    with pytest.raises(ValueError, match="shapes"):
        tatt.flash_attention(q, k[:, :, :8], v[:, :, :8])
