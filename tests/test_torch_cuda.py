"""PyTorch port: each CUDA kernel against its plain torch version on the
card, at small shapes.  Marked ``cuda``; without a CUDA device every test
skips.  On a machine with an NVIDIA Hopper GPU and nvcc (no JAX needed):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import pytest
import torch

from flashmoe_tpu_torch.config import MoEConfig
from flashmoe_tpu_torch.models.reference import init_moe_params
from flashmoe_tpu_torch.ops import attention, expert, gate, ragged
from flashmoe_tpu_torch.ops.moe import moe_layer

pytestmark = pytest.mark.cuda

# bf16 outputs: normwise relative error of bf16 rounding (2^-8 per
# element) with f32 sums in another order
BF16_TOL = 1e-2


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU version")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _normwise(a, b):
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("dtype,s,e,k", [(torch.bfloat16, 100, 8, 2),
                                         (torch.float32, 37, 256, 6),
                                         (torch.bfloat16, 4, 64, 2)],
                         ids=["bf16_e8", "f32_e256", "bf16_decode"])
def test_gate_kernel_matches_plain(gen, dtype, s, e, k):
    cfg = MoEConfig(num_experts=e, expert_top_k=k, hidden_size=256,
                    router_z_loss_coef=0.1, dtype=dtype)
    x = torch.randn(s, 256, device="cuda", generator=gen, dtype=dtype)
    w = (torch.randn(256, e, device="cuda", generator=gen) / 16).to(dtype)
    got = gate.router_cuda(x, w, cfg)
    want = gate.router_plain(x, w, cfg)
    assert torch.equal(got.expert_idx, want.expert_idx)
    assert torch.equal(got.expert_counts, want.expert_counts)
    torch.testing.assert_close(got.combine_weights, want.combine_weights,
                               rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got.probs_mean, want.probs_mean, rtol=1e-5,
                               atol=1e-7)
    torch.testing.assert_close(got.z_loss, want.z_loss, rtol=1e-4, atol=0)


@pytest.mark.parametrize("dtype,gated,act", [(torch.bfloat16, True, "silu"),
                                             (torch.float32, False, "gelu")],
                         ids=["bf16_swiglu", "f32_gelu"])
def test_grouped_ffn_kernel_matches_plain(gen, dtype, gated, act):
    cfg = MoEConfig(num_experts=4, expert_top_k=2, hidden_size=128,
                    intermediate_size=192, gated_ffn=gated, hidden_act=act,
                    drop_tokens=False, dtype=dtype, param_dtype=dtype)
    p = init_moe_params(gen, cfg, device="cuda")
    p["b_up"] = torch.randn(4, 192, device="cuda", generator=gen).to(dtype)
    x = torch.randn(50, 128, device="cuda", generator=gen, dtype=dtype)
    r = gate.router_plain(x, p["gate_w"], cfg)
    plan = ragged.make_ragged_plan(r.expert_idx, cfg, expert.ROW_TILE)
    xbuf = ragged.ragged_dispatch(x, plan, cfg, expert.ROW_TILE)
    args = (xbuf, plan.tile_gid, p["w_up"], p["b_up"], p["w_down"],
            p["b_down"], p.get("w_gate"))
    kw = dict(act_name=act, gated=gated, block_m=expert.ROW_TILE,
              num_rows=plan.num_rows)
    got = expert.grouped_ffn_cuda(*args, **kw)
    want = expert.grouped_ffn_plain(*args, **kw)
    tol = BF16_TOL if dtype == torch.bfloat16 else 1e-5
    assert _normwise(got, want) <= tol
    assert not got[int(plan.num_rows):].any()


@pytest.mark.parametrize("dtype,n,nkv,t,d", [
    (torch.bfloat16, 8, 2, 200, 128), (torch.bfloat16, 4, 4, 64, 64),
    (torch.float32, 4, 2, 77, 64)], ids=["bf16_gqa", "bf16_d64", "f32"])
def test_flash_kernel_matches_plain(gen, dtype, n, nkv, t, d):
    q = torch.randn(2, n, t, d, device="cuda", generator=gen, dtype=dtype)
    k = torch.randn(2, nkv, t, d, device="cuda", generator=gen, dtype=dtype)
    v = torch.randn(2, nkv, t, d, device="cuda", generator=gen, dtype=dtype)
    got = attention.flash_attention_cuda(q, k, v)
    want = attention.flash_attention_plain(q, k, v)
    tol = BF16_TOL if dtype == torch.bfloat16 else 1e-5
    assert _normwise(got, want) <= tol


@pytest.mark.parametrize("drop", [False, True], ids=["dropless", "capacity"])
def test_moe_layer_kernels_match_plain(gen, drop):
    cfg = MoEConfig(num_experts=8, expert_top_k=2, hidden_size=128,
                    intermediate_size=128, gated_ffn=not drop,
                    hidden_act="silu" if not drop else "gelu",
                    drop_tokens=drop, capacity_factor=1.0,
                    dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    p = init_moe_params(gen, cfg, device="cuda")
    x = torch.randn(96, 128, device="cuda", generator=gen,
                    dtype=torch.bfloat16)
    before = gate.router_cuda.launches, expert.grouped_ffn_cuda.launches
    got = moe_layer(p, x, cfg)
    assert (gate.router_cuda.launches, expert.grouped_ffn_cuda.launches) \
        == (before[0] + 1, before[1] + 1)
    want = moe_layer(p, x, cfg, use_kernels=False)
    assert _normwise(got.out, want.out) <= BF16_TOL
    assert torch.equal(got.expert_counts, want.expert_counts)
