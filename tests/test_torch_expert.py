"""PyTorch port: the grouped expert FFN against the JAX package, on the
same numpy inputs (CPU; the port runs the kernel's plain version)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashmoe_tpu.config import MoEConfig as JaxConfig
from flashmoe_tpu.ops import expert as jexp
from flashmoe_tpu_torch.config import MoEConfig as TorchConfig
from flashmoe_tpu_torch.convert import params_from_numpy
from flashmoe_tpu_torch.ops import expert as texp

_expert_ffn_dense = jax.jit(jexp.expert_ffn_dense, static_argnums=(2,))


def _weights(e, h, i, gated, seed=0):
    rng = np.random.default_rng(seed)

    def normal(shape, fan_in):
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
            np.float32)

    p = {"w_up": normal((e, h, i), h), "w_down": normal((e, i, h), i),
         "b_up": normal((e, i), 8), "b_down": normal((e, h), 8)}
    if gated:
        p["w_gate"] = normal((e, h, i), h)
    return p


@pytest.mark.parametrize("gated,act", [(True, "silu"), (False, "gelu")],
                         ids=["gated_silu", "gelu"])
def test_grouped_ffn_matches_pallas_interpret(gated, act):
    """The plain grouped FFN against the TPU kernel itself (interpret),
    f32 at tests/test_expert.py's 2e-4."""
    e, h, i, bm = 4, 64, 128, 64
    p = _weights(e, h, i, gated)
    gid = np.array([2, 0, 0, 3, 1], np.int32)  # unsorted on purpose
    x = np.random.default_rng(1).standard_normal(
        (gid.size * bm, h)).astype(np.float32)
    want = jexp.grouped_ffn(
        jnp.asarray(x), jnp.asarray(gid), p["w_up"], p["b_up"], p["w_down"],
        p["b_down"], p.get("w_gate"), act_name=act, gated=gated, block_m=bm,
        block_i=64, interpret=True)
    t = params_from_numpy(p, device="cpu")
    got = texp.grouped_ffn(
        torch.from_numpy(x), torch.from_numpy(gid), t["w_up"], t["b_up"],
        t["w_down"], t["b_down"], t.get("w_gate"), act_name=act,
        gated=gated, block_m=bm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("gated,act,c", [(True, "silu", 24),
                                         (False, "relu", 64),
                                         (False, "gelu", 80)],
                         ids=["gated_c24", "relu_c64", "gelu_c80"])
def test_capacity_buffer_ffn_matches_dense(gated, act, c):
    """The capacity-buffer FFN (grouped, padded to the row tile) against
    the JAX package's batched XLA FFN."""
    e, h, i = 4, 64, 128
    kw = dict(num_experts=e, hidden_size=h, intermediate_size=i,
              gated_ffn=gated, hidden_act=act)
    jc = JaxConfig(dtype=jnp.float32, **kw)
    tc = TorchConfig(dtype=torch.float32, **kw)
    p = _weights(e, h, i, gated, seed=c)
    xs = np.random.default_rng(c).standard_normal((e, c, h)).astype(
        np.float32)
    want = _expert_ffn_dense(jnp.asarray(xs), p, jc)
    tp = params_from_numpy(p, device="cpu")
    got = texp.capacity_buffer_ffn(torch.from_numpy(xs), tp, tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(
        texp.expert_ffn_dense(torch.from_numpy(xs), tp, tc).numpy(),
        np.asarray(want), rtol=2e-4, atol=2e-4)


def test_num_rows_zeroes_the_padded_tail():
    e, h, i, bm = 2, 64, 64, 64
    t = params_from_numpy(_weights(e, h, i, False), device="cpu")
    x = torch.randn(3 * bm, h, generator=torch.Generator().manual_seed(0))
    gid = torch.tensor([0, 1, 1])
    args = (x, gid, t["w_up"], t["b_up"], t["w_down"], t["b_down"])
    full = texp.grouped_ffn(*args, act_name="relu", block_m=bm)
    cut = texp.grouped_ffn(*args, act_name="relu", block_m=bm,
                           num_rows=torch.tensor(2 * bm))
    torch.testing.assert_close(cut[:2 * bm], full[:2 * bm], rtol=0, atol=0)
    assert not cut[2 * bm:].any()


def test_auto_block_and_capacity_tiling():
    assert texp._auto_block(14336, 512) == 512
    assert texp._auto_block(768, 512) == 384
    assert texp._capacity_tiling(256) == (64, 256)
    assert texp._capacity_tiling(8) == (64, 64)


def test_grouped_ffn_kernel_refuses_cpu_tensors():
    t = params_from_numpy(_weights(2, 64, 64, False), device="cpu")
    x = torch.zeros(64, 64)
    args = (x, torch.tensor([0]), t["w_up"], t["b_up"], t["w_down"],
            t["b_down"])
    with pytest.raises(ValueError, match="CUDA"):
        texp.grouped_ffn(*args, act_name="relu", use_kernels=True)
    with pytest.raises(ValueError, match="cuda"):
        texp.grouped_ffn_cuda(*args, act_name="relu", block_m=64)
    with pytest.raises(ValueError, match="block_m"):
        texp.grouped_ffn(*args, act_name="relu", block_m=48)
