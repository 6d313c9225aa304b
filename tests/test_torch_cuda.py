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


def _ragged_rows(gen, dtype, e, rows, h):
    """Expert-sorted rows of a ragged plan (expert 1 routed nothing),
    with its tile ids and live-row count."""
    cfg = MoEConfig(num_experts=e, expert_top_k=2, hidden_size=h,
                    drop_tokens=False, dtype=dtype)
    ids = torch.randint(0, e, (rows, 2), device="cuda", generator=gen)
    ids[ids == 1] = 0
    plan = ragged.make_ragged_plan(ids, cfg, expert.ROW_TILE)
    x = torch.randn(rows, h, device="cuda", generator=gen, dtype=dtype)
    return ragged.ragged_dispatch(x, plan, cfg, expert.ROW_TILE), plan


@pytest.mark.parametrize("dtype,gated,act", [(torch.bfloat16, True, "silu"),
                                             (torch.float32, False, "gelu")],
                         ids=["bf16_swiglu", "f32_gelu"])
def test_grouped_ffn_res_kernel_matches_plain(gen, dtype, gated, act):
    """y, u and g against the plain version; the ragged tail is zero."""
    e, h, i = 4, 128, 192
    xbuf, plan = _ragged_rows(gen, dtype, e, 70, h)
    w = lambda *s: (torch.randn(*s, device="cuda", generator=gen)
                    / s[-2] ** 0.5).to(dtype)
    args = (xbuf, plan.tile_gid, w(e, h, i),
            torch.randn(e, i, device="cuda", generator=gen), w(e, i, h),
            torch.randn(e, h, device="cuda", generator=gen),
            w(e, h, i) if gated else None)
    kw = dict(act_name=act, gated=gated, block_m=expert.ROW_TILE,
              num_rows=plan.num_rows)
    got = expert.grouped_ffn_res_cuda(*args, **kw)
    want = expert.grouped_ffn_res_plain(*args, **kw)
    tol = BF16_TOL if dtype == torch.bfloat16 else 1e-5
    live = int(plan.num_rows)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert _normwise(a, b) <= tol
            assert not a[live:].any()


@pytest.mark.parametrize("dtype,transpose_w", [
    (torch.bfloat16, True), (torch.bfloat16, False), (torch.float32, True),
    (torch.float32, False)], ids=["bf16_wT", "bf16_w", "f32_wT", "f32_w"])
def test_grouped_matmul_kernel_matches_plain(gen, dtype, transpose_w):
    e, k, n = 4, 192, 128
    xbuf, plan = _ragged_rows(gen, dtype, e, 70, k)
    w = torch.randn(*((e, n, k) if transpose_w else (e, k, n)),
                    device="cuda", generator=gen).to(dtype)
    for out_dtype in (torch.float32, dtype):
        kw = dict(transpose_w=transpose_w, out_dtype=out_dtype,
                  num_rows=plan.num_rows)
        got = expert.grouped_matmul_cuda(xbuf, plan.tile_gid, w, **kw)
        want = expert.grouped_matmul_plain(xbuf, plan.tile_gid, w, **kw)
        assert got.dtype == out_dtype
        tol = 1e-5 if out_dtype == torch.float32 else BF16_TOL
        assert _normwise(got, want) <= tol


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_tgmm_kernel_matches_plain(gen, dtype):
    """f32 dW against the plain version; the expert with no rows gets
    exactly 0 (the kernel writes it), the padded tail adds nothing."""
    e = 4
    xbuf, plan = _ragged_rows(gen, dtype, e, 70, 128)
    dy = torch.randn(xbuf.shape[0], 192, device="cuda", generator=gen,
                     dtype=dtype)
    got = expert.tgmm_cuda(xbuf, dy, plan.tile_gid, e,
                           num_rows=plan.num_rows)
    want = expert.tgmm_plain(xbuf, dy, plan.tile_gid, e,
                             num_rows=plan.num_rows)
    assert got.dtype == torch.float32
    assert _normwise(got, want) <= 1e-5
    assert torch.isfinite(got).all() and not got[1].any()


@pytest.mark.parametrize("drop", [False, True], ids=["dropless", "capacity"])
def test_moe_layer_grads_kernels_match_plain(gen, drop):
    """Every gradient of sum(out**2) + aux through the kernels (gate, B6,
    B7, B8) against the same layer on the plain versions."""
    cfg = MoEConfig(num_experts=8, expert_top_k=2, hidden_size=128,
                    intermediate_size=128, gated_ffn=not drop,
                    hidden_act="silu" if not drop else "gelu",
                    drop_tokens=drop, capacity_factor=1.0,
                    dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    p = init_moe_params(gen, cfg, device="cuda")
    x = torch.randn(96, 128, device="cuda", generator=gen,
                    dtype=torch.bfloat16)

    def grads(use_kernels):
        leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        xx = x.detach().requires_grad_(True)
        o = moe_layer(leaves, xx, cfg, use_kernels=use_kernels)
        loss = (o.out.float() ** 2).sum() + o.aux_loss
        return torch.autograd.grad(loss, [xx, *leaves.values()])

    before = (expert.grouped_ffn_res_cuda.launches,
              expert.grouped_matmul_cuda.launches, expert.tgmm_cuda.launches)
    got = grads(None)
    after = (expert.grouped_ffn_res_cuda.launches,
             expert.grouped_matmul_cuda.launches, expert.tgmm_cuda.launches)
    assert all(b > a for a, b in zip(before, after))
    want = grads(False)
    for name, a, b in zip(["x", *p], got, want):
        assert torch.isfinite(a).all(), name
        assert _normwise(a, b) <= 2 * BF16_TOL, name


def test_kernel_wrappers_refuse_autograd_on_cuda(gen):
    x = torch.randn(64, 64, device="cuda", generator=gen,
                    requires_grad=True)
    w = torch.randn(1, 64, 64, device="cuda", generator=gen)
    gid = torch.zeros(1, dtype=torch.long, device="cuda")
    with pytest.raises(RuntimeError, match="autograd"):
        expert.grouped_matmul_cuda(x, gid, w)
    with torch.no_grad():
        assert expert.grouped_matmul_cuda(x, gid, w).shape == (64, 64)


# the two-pass gate: a routing difference is accepted only where the plain
# version's K-th and (K+1)-th logits are this close (f32 sums of the same
# products in another order)
NEAR_TIE = 1e-4


@pytest.mark.parametrize("dtype,s,e,k", [
    (torch.bfloat16, 100, 300, 2), (torch.bfloat16, 64, 512, 10),
    (torch.float32, 37, 1280, 2), (torch.bfloat16, 4, 512, 64),
    (torch.float32, 70, 300, 33)],
    ids=["bf16_e300", "bf16_e512k10", "f32_e1280", "bf16_decode_k64",
         "f32_k33"])
def test_gate_pass1_kernel_matches_plain(gen, dtype, s, e, k):
    """Logits, m and se against the plain version; the top-k ids distinct
    and, read in the plain logits, the plain top-k values but at near
    ties; top_p = exp(logit - m) / se at those ids."""
    x = torch.randn(s, 256, device="cuda", generator=gen, dtype=dtype)
    w = (torch.randn(256, e, device="cuda", generator=gen) / 16).to(dtype)
    logits, m, se, top_p, top_i = gate.gate_pass1_cuda(x, w, k, True)
    want = gate.gate_pass1_plain(x, w, k, True)
    torch.testing.assert_close(logits, want[0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(m, want[1], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(se, want[2], rtol=1e-4, atol=0)
    ids = top_i.long()
    assert (ids.sort(-1).values.diff(dim=-1) > 0).all()
    picked = want[0].gather(-1, ids)
    top = want[0].sort(-1, descending=True).values[:, :k]
    assert float((picked - top).abs().max()) <= NEAR_TIE
    assert int((ids != want[4]).any(-1).sum()) <= max(1, s // 50)
    torch.testing.assert_close(
        top_p, torch.exp(picked - want[1][:, None]) / want[2][:, None],
        rtol=1e-4, atol=1e-6)
    assert gate.gate_pass1_cuda(x, w, k, False)[0] is None


@pytest.mark.parametrize("s,e,k", [(100, 300, 2), (257, 1280, 64)],
                         ids=["e300", "e1280k64"])
def test_gate_pass2_kernel_matches_plain(gen, s, e, k):
    """On the same pass-1 outputs: probability sums and the z sum at f32
    summation-order tolerance, counts exact."""
    x = torch.randn(s, 128, device="cuda", generator=gen)
    w = torch.randn(128, e, device="cuda", generator=gen) / 11
    logits, m, se, _, top_i = gate.gate_pass1_cuda(x, w, k, True)
    got = gate.gate_pass2_cuda(logits, m, se, top_i, e)
    want = gate.gate_pass2_plain(logits, m, se, top_i, e)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
    assert torch.equal(got[1].long(), want[1])
    torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=0)


def test_router_takes_tiled_gate_and_its_gradient(gen):
    """E > 256 on the card: the router launches pass 1 and pass 2, and its
    gradients are router_plain's (its backward recomputes it)."""
    cfg = MoEConfig(num_experts=300, expert_top_k=3, hidden_size=128,
                    router_z_loss_coef=0.1, dtype=torch.float32)
    x = torch.randn(64, 128, device="cuda", generator=gen)
    w = torch.randn(128, 300, device="cuda", generator=gen) / 11
    ct = torch.randn(64, 3, device="cuda", generator=gen)

    def grads(fn):
        xs, ws = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        o = fn(xs, ws, cfg)
        loss = (o.combine_weights * ct).sum() + o.aux_loss + o.z_loss
        return torch.autograd.grad(loss, (xs, ws))

    before = gate.gate_pass1_cuda.launches, gate.gate_pass2_cuda.launches
    got = grads(gate.router)
    assert (gate.gate_pass1_cuda.launches, gate.gate_pass2_cuda.launches) \
        == (before[0] + 1, before[1] + 1)
    for a, b in zip(got, grads(gate.router_plain)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype,gated,act", [(torch.bfloat16, True, "silu"),
                                             (torch.float32, False, "gelu")],
                         ids=["bf16_swiglu", "f32_gelu"])
def test_grouped_ffn_tokens_kernel_matches_plain_and_b2(gen, dtype, gated,
                                                        act):
    """The gather-fused FFN against its plain version at the populated
    rows, and bit for bit against B2 on the dispatched buffer there."""
    e, h, i, s = 4, 128, 192, 70
    cfg = MoEConfig(num_experts=e, expert_top_k=2, hidden_size=h,
                    drop_tokens=False, dtype=dtype)
    ids = torch.randint(0, e, (s, 2), device="cuda", generator=gen)
    ids[:, 1] = (ids[:, 0] + 1) % e
    plan = ragged.make_ragged_plan(ids, cfg, expert.ROW_TILE)
    x = torch.randn(s, h, device="cuda", generator=gen, dtype=dtype)
    w = lambda *sh: (torch.randn(*sh, device="cuda", generator=gen)
                     / sh[-2] ** 0.5).to(dtype)
    weights = (w(e, h, i), torch.randn(e, i, device="cuda", generator=gen),
               w(e, i, h), torch.randn(e, h, device="cuda", generator=gen),
               w(e, h, i) if gated else None)
    kw = dict(act_name=act, gated=gated, block_m=expert.ROW_TILE,
              num_rows=plan.num_rows)
    before = expert.grouped_ffn_tokens_cuda.launches
    got = expert.grouped_ffn_tokens_cuda(x, plan.src_tok, plan.tile_gid,
                                         *weights, **kw)
    assert expert.grouped_ffn_tokens_cuda.launches == before + 1
    want = expert.grouped_ffn_tokens_plain(x, plan.src_tok, plan.tile_gid,
                                           *weights, **kw)
    live = plan.present
    tol = BF16_TOL if dtype == torch.bfloat16 else 1e-5
    assert _normwise(got[live], want[live]) <= tol
    xbuf = ragged.ragged_dispatch(x, plan, cfg, expert.ROW_TILE)
    b2 = expert.grouped_ffn_cuda(xbuf, plan.tile_gid, *weights, **kw)
    assert torch.equal(got[live], b2[live])
    assert not got[int(plan.num_rows):].any()


@pytest.mark.parametrize("drop", [False, True], ids=["dropless", "capacity"])
def test_gather_arms_kernels_match_plain(gen, drop):
    """Both gather arms of the layer (E 300: the two-pass gate too) with
    the kernels against the plain versions."""
    cfg = MoEConfig(num_experts=300, expert_top_k=2, hidden_size=128,
                    intermediate_size=128, gated_ffn=not drop,
                    hidden_act="silu" if not drop else "gelu",
                    drop_tokens=drop, capacity_factor=2.0,
                    dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                    gather_fused=True, collect_stats=True)
    p = init_moe_params(gen, cfg, device="cuda")
    x = torch.randn(256, 128, device="cuda", generator=gen,
                    dtype=torch.bfloat16)
    before = (expert.grouped_ffn_tokens_cuda.launches,
              gate.gate_pass1_cuda.launches, gate.gate_pass2_cuda.launches)
    got = moe_layer(p, x, cfg)
    after = (expert.grouped_ffn_tokens_cuda.launches,
             gate.gate_pass1_cuda.launches, gate.gate_pass2_cuda.launches)
    assert all(b == a + 1 for a, b in zip(before, after))
    want = moe_layer(p, x, cfg, use_kernels=False)
    assert _normwise(got.out, want.out) <= BF16_TOL
    torch.testing.assert_close(got.stats.router_entropy,
                               want.stats.router_entropy, rtol=1e-4, atol=0)


def test_new_kernel_wrappers_refuse_autograd_on_cuda(gen):
    x = torch.randn(64, 64, device="cuda", generator=gen,
                    requires_grad=True)
    w = torch.randn(64, 300, device="cuda", generator=gen)
    with pytest.raises(RuntimeError, match="autograd"):
        gate.gate_pass1_cuda(x, w, 2, True)
    wu = torch.randn(1, 64, 64, device="cuda", generator=gen)
    b = torch.zeros(1, 64, device="cuda")
    src = torch.zeros(64, dtype=torch.long, device="cuda")
    gid = torch.zeros(1, dtype=torch.long, device="cuda")
    with pytest.raises(RuntimeError, match="autograd"):
        expert.grouped_ffn_tokens_cuda(x, src, gid, wu, b, wu, b,
                                       act_name="relu", block_m=64)
    with torch.no_grad():
        assert gate.gate_pass1_cuda(x, w, 2, False)[4].shape == (64, 2)
