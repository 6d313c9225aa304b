"""PyTorch port: each CUDA kernel against its plain torch version on the
card, at small shapes.  Marked ``cuda``; without a CUDA device every test
skips.  On a machine with an NVIDIA Hopper GPU and nvcc (no JAX needed):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from flashmoe_tpu_torch.config import MoEConfig
from flashmoe_tpu_torch.kernels import _build
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
    (torch.float32, 70, 300, 33), (torch.bfloat16, 1000, 300, 10),
    (torch.bfloat16, 1000, 300, 64), (torch.float32, 1000, 300, 64),
    (torch.bfloat16, 130, 301, 3), (torch.bfloat16, 70, 1280, 1)],
    ids=["bf16_e300", "bf16_e512k10", "f32_e1280", "bf16_decode_k64",
         "f32_k33", "bf16_e300_s1000", "bf16_e300_s1000_k64",
         "f32_e300_s1000_k64", "bf16_e301", "bf16_e1280_k1"])
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


@pytest.mark.parametrize("s,e,k", [(100, 300, 2), (257, 1280, 64),
                                   (8192, 512, 10), (130, 301, 3)],
                         ids=["e300", "e1280k64", "s8192_e512", "e301"])
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


def test_gate_pass1_batch_invariant_and_repeatable(gen):
    """bf16 pass 1 at the many-expert layer's widths (H 2048, E 512, top-10):
    a token's logits, m, se, weights and ids are the same bits alone (S 1
    to 4, decode) as inside S 8192, and two calls give the same bits."""
    x = torch.randn(8192, 2048, device="cuda", generator=gen,
                    dtype=torch.bfloat16)
    w = (torch.randn(2048, 512, device="cuda", generator=gen)
         / 45).to(torch.bfloat16)
    full = gate.gate_pass1_cuda(x, w, 10, True)
    again = gate.gate_pass1_cuda(x, w, 10, True)
    for a, b in zip(full, again):
        assert torch.equal(a, b)
    for s0, n in ((0, 4), (61, 4), (4093, 3), (8191, 1)):
        part = gate.gate_pass1_cuda(x[s0:s0 + n].contiguous(), w, 10, True)
        for a, b in zip(part, full):
            assert torch.equal(a, b[s0:s0 + n])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_gate_pass1_top_k_spread_over_the_quad(gen, dtype):
    """Logits whose top-10 is spread over the four threads of a quad in
    the first expert tile (each thread two large logits, tied across
    threads, and one medium; all else small): the kernel's ids equal the
    plain top-k exactly, in every row of a 64-row tile and past it."""
    s, e, k = 70, 300, 10
    lg = -1.0 - (np.arange(e) % 7)[None, :] * 0.125 + np.zeros((s, 1))
    for q in range(4):
        lg[:, 2 * q] = 16 + 2 * q
        lg[:, 8 + 2 * q] = 12 + 2 * q
        lg[:, 16 + 2 * q] = 4 + 0.5 * q
    lg[:, 24:128:3] += 0.25 * (np.arange(s) % 4)[:, None]
    x = torch.zeros(s, 128, device="cuda", dtype=dtype)
    x[:, :64] = torch.eye(64, device="cuda", dtype=dtype).repeat(2, 1)[:s]
    w = torch.zeros(128, e, device="cuda", dtype=dtype)
    w[:64] = torch.from_numpy(lg[:64]).to("cuda", dtype)
    got = gate.gate_pass1_cuda(x, w, k, True)
    want = gate.gate_pass1_plain(x, w, k, True)
    assert torch.equal(got[4].long(), want[4])
    assert sorted(got[4][0].tolist()) == [0, 2, 4, 6, 8, 10, 12, 14, 20, 22]


def test_gate_pass2_repeatable_and_counts_exact(gen):
    """Pass 2 at S 8192, E 512, K 10 twice: the same bits, and the counts
    the ids' bincount exactly."""
    x = torch.randn(8192, 2048, device="cuda", generator=gen,
                    dtype=torch.bfloat16)
    w = (torch.randn(2048, 512, device="cuda", generator=gen)
         / 45).to(torch.bfloat16)
    logits, m, se, _, top_i = gate.gate_pass1_cuda(x, w, 10, True)
    a = gate.gate_pass2_cuda(logits, m, se, top_i, 512)
    b = gate.gate_pass2_cuda(logits, m, se, top_i, 512)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    assert torch.equal(a[1].long(),
                       torch.bincount(top_i.reshape(-1).long(),
                                      minlength=512))


@pytest.mark.parametrize("s,e", [(1000, 512), (100, 300)],
                         ids=["s1000", "e300"])
def test_gate_pass1_reads_x_in_place(gen, monkeypatch, s, e):
    """bf16 pass 1 hands the kernel x's own data at an S that is not a
    multiple of the 64-token tile (no padded copy), and gate_w's own data
    where E % 8 == 0."""
    x = torch.randn(s, 256, device="cuda", generator=gen,
                    dtype=torch.bfloat16)
    w = (torch.randn(256, e, device="cuda", generator=gen) / 16).to(
        torch.bfloat16)
    lib = _build.library()
    real, seen = lib.fm_gate_pass1, []

    def record(*args):
        seen.append(args)
        return real(*args)

    monkeypatch.setattr(lib, "fm_gate_pass1", record)
    got = gate.gate_pass1_cuda(x, w, 4, True)
    assert len(seen) == 1 and seen[0][1] == x.data_ptr()
    assert (seen[0][2] == w.data_ptr()) == (e % 8 == 0)
    want = gate.gate_pass1_plain(x, w, 4, True)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-5)


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


# ----------------------------------------------------------------------
# B5: the fused expert-parallel kernel over virtual ranks
# ----------------------------------------------------------------------

def _fused_inputs(gen, d, gated, combine, skew, dtype=torch.bfloat16,
                  cap=96, nlx=2, h=128, i=192, k=2):
    """Random shard inputs of the fused kernel: slabs, counts (with skew,
    rank 0 sends nothing and expert 0 of every owner gets nothing),
    weights and, with the combine, one token-sorted row per populated
    slot and its weight (0 on the other rows)."""
    dev = dict(device="cuda")
    x_send = torch.randn(d, d, nlx, cap, h, generator=gen, **dev).to(dtype)
    send_cnt = torch.randint(0, cap + 1, (d, d, nlx), generator=gen, **dev)
    if skew:
        send_cnt[:, :, 0] = 0
        if d > 1:
            send_cnt[0] = 0
    w = {name: (torch.randn(*shape, generator=gen, **dev) / shape[-2] ** 0.5
                ).to(dtype)
         for name, shape in (("w_up", (d * nlx, h, i)),
                             ("w_gate", (d * nlx, h, i)),
                             ("w_down", (d * nlx, i, h)))}
    b_up = torch.randn(d * nlx, i, generator=gen, **dev) * 0.1
    b_down = torch.randn(d * nlx, h, generator=gen, **dev) * 0.1
    args = (send_cnt, None, x_send, w["w_up"], b_up, w["w_down"], b_down,
            w["w_gate"] if gated else None)
    kw = dict(act_name="silu" if gated else "gelu", gated=gated)
    if combine:
        slots = int(send_cnt.sum(dim=(1, 2)).max())
        rows_pad = max(k, -(-slots // k) * k)
        ret_pos = torch.zeros(d, d, nlx, cap, dtype=torch.int32, **dev)
        w_sorted = torch.zeros(d, rows_pad, **dev)
        live = torch.arange(cap, **dev) < send_cnt[..., None]
        for s in range(d):
            n = int(live[s].sum())
            pos = torch.randperm(rows_pad, generator=gen, **dev)[:n]
            ret_pos[s][live[s]] = pos.to(torch.int32)
            w_sorted[s, pos] = torch.rand(n, generator=gen, **dev)
        kw.update(recv_pos=ret_pos.transpose(0, 1).contiguous(),
                  w_sorted=w_sorted, k=k)
    return args, kw


def _fused_check(args, kw, d, src_order, schedule, tol):
    from flashmoe_tpu_torch.parallel import fused

    args = args[:1] + (src_order,) + args[2:]
    got = fused.fused_shard_cuda(*args, schedule=schedule, **kw)
    want = fused.fused_shard_plain(*args, schedule=schedule, **kw)
    torch.cuda.synchronize()
    if "recv_pos" not in kw:
        # populated rows only: the kernel leaves the others unspecified
        live = torch.arange(got.shape[3], device="cuda") < args[0][..., None]
        got, want = got[live], want[live]
    assert bool(torch.isfinite(got).all())
    assert _normwise(got, want) <= tol


@pytest.mark.parametrize("d,gated,combine,skew,schedule", [
    (1, True, False, False, "stream"), (2, False, False, False, "resident"),
    (2, True, True, False, "batched"), (4, True, True, False, "stream"),
    (4, False, False, True, "rowwin"), (4, True, True, True, "batched")],
    ids=["ep1_gated", "ep2_plain", "ep2_gated_combine", "ep4_gated_combine",
         "ep4_skewed", "ep4_skewed_combine"])
def test_fused_ep_kernel_matches_plain(gen, d, gated, combine, skew,
                                       schedule):
    from flashmoe_tpu_torch.parallel import fused

    args, kw = _fused_inputs(gen, d, gated, combine, skew)
    ring = fused.default_ring(d)
    before = fused.fused_shard_cuda.launches
    _fused_check(args, kw, d, ring, schedule, BF16_TOL)
    # a second call on the same heap, other counts and another source
    # order: the flags hold the first call's sequence number, which must
    # satisfy no wait of this one
    args2, kw2 = _fused_inputs(gen, d, gated, combine, not skew)
    rev = np.array([[r] + [s for s in reversed(range(d)) if s != r]
                    for r in range(d)])
    _fused_check(args2, kw2, d, rev, schedule, BF16_TOL)
    assert fused.fused_shard_cuda.launches == before + 2


def test_fused_ep_kernel_f32_and_small_capacity(gen):
    from flashmoe_tpu_torch.parallel import fused

    args, kw = _fused_inputs(gen, 2, True, False, False, torch.float32,
                             cap=32)
    _fused_check(args, kw, 2, fused.default_ring(2), "stream", 1e-5)


def test_fused_ep_kernel_refuses_oversized_grid(gen):
    from flashmoe_tpu_torch.parallel import fused

    args, kw = _fused_inputs(gen, 2, False, False, False)
    most = fused.max_blocks(args[2], False)
    before = fused.fused_shard_cuda.launches
    with pytest.raises(ValueError, match="deadlock"):
        fused.fused_shard_cuda(*args, blocks_per_rank=most, **kw)
    assert fused.fused_shard_cuda.launches == before


def test_fused_ep_kernel_recovers_from_a_refused_launch(gen, monkeypatch):
    """A launch the driver refuses (a cooperative grid past what the card
    keeps resident, past the wrapper's guard) raises, runs nothing and
    leaves the flags' sequence number where it was: the next call, on the
    same flag words, completes and agrees with the plain version."""
    from flashmoe_tpu_torch.parallel import fused

    args, kw = _fused_inputs(gen, 2, False, False, False)
    ring = fused.default_ring(2)
    _fused_check(args, kw, 2, ring, "stream", BF16_TOL)
    most = fused.max_blocks(args[2], False)
    flags = fused._FLAGS[args[2].device]
    seq, before = flags.seq, fused.fused_shard_cuda.launches
    with monkeypatch.context() as mp:
        mp.setattr(fused, "max_blocks", lambda x, gated, wq=0: 4 * most)
        with pytest.raises(RuntimeError, match="fm_fused_ep"):
            fused.fused_shard_cuda(*args, blocks_per_rank=most, **kw)
    assert fused._FLAGS[args[2].device] is flags and flags.seq == seq
    assert fused.fused_shard_cuda.launches == before
    _fused_check(args, kw, 2, ring, "stream", BF16_TOL)
    assert flags.seq == seq + 1


@pytest.mark.parametrize("combine", ["0", "1"], ids=["slabs", "combine"])
def test_fused_layer_kernel_matches_plain_and_collective(gen, monkeypatch,
                                                         combine):
    from flashmoe_tpu_torch.parallel import ep, fused, mesh

    monkeypatch.setenv("FLASHMOE_FUSED_COMBINE", combine)
    cfg = MoEConfig(num_experts=8, expert_top_k=2, hidden_size=128,
                    intermediate_size=128, gated_ffn=True, hidden_act="silu",
                    capacity_factor=1.25, ep=4, num_shared_experts=1,
                    moe_backend="fused", dtype=torch.bfloat16,
                    param_dtype=torch.bfloat16)
    p = init_moe_params(gen, cfg, device="cuda")
    x = torch.randn(256, 128, device="cuda", generator=gen,
                    dtype=torch.bfloat16)
    m = mesh.local_mesh(4)
    before = fused.fused_shard_cuda.launches
    got = fused.fused_ep_moe_layer(p, x, cfg, m)
    assert fused.fused_shard_cuda.launches == before + 1
    plain = fused.fused_ep_moe_layer(p, x, cfg, m, use_kernels=False)
    coll = ep.ep_moe_layer(p, x, cfg, m)
    assert _normwise(got.out, plain.out) <= BF16_TOL
    assert _normwise(got.out, coll.out) <= BF16_TOL
    assert torch.equal(got.expert_counts, coll.expert_counts)
    # under autograd the layer runs the kernel inside its VJP
    # (``_FusedCore`` / ``_FusedCombineCore``); the wrapper alone refuses
    x.requires_grad_(True)
    before = fused.fused_shard_cuda.launches
    out = fused.fused_ep_moe_layer(p, x, cfg, m).out
    assert out.grad_fn is not None
    assert fused.fused_shard_cuda.launches == before + 1


# ----------------------------------------------------------------------
# B5q: the fused kernel's quantized arm (int8 / e4m3 weights + scales)
# ----------------------------------------------------------------------

def _quantize_shard(args, kw, qname):
    """The shard arguments with their weights in the ``qname`` store:
    payloads in place of the weights, their scales in the keywords."""
    from flashmoe_tpu_torch import quant as qt

    args = list(args)
    sc = {}
    for i, key in ((3, "wup_sc"), (5, "wdn_sc"), (7, "wg_sc")):
        if args[i] is not None:
            args[i], sc[key] = qt.quantize_channelwise(args[i], qname)
    return tuple(args), dict(kw, **sc)


_QUANT_GRID = [(q, dt, gated, cap) for q in ("int8", "e4m3")
               for dt in (torch.bfloat16, torch.float32)
               for gated in (True, False) for cap in (32, 96)]


@pytest.mark.parametrize(
    "qname,dtype,gated,cap", _QUANT_GRID,
    ids=[f"{q}_{str(dt)[6:]}_{'gated' if g else 'plain'}_cap{c}"
         for q, dt, g, c in _QUANT_GRID])
def test_fused_ep_quant_kernel_matches_plain(gen, qname, dtype, gated, cap):
    """B5q against its plain version at the populated rows (bf16 within the
    bf16 tolerance, f32 within 1e-5 normwise), at capacities below and
    above the 64-row tile, in both processing orders; and equal bit for
    bit to the kernel on the same weights dequantized beforehand (the
    tiles it builds in shared memory hold the same values)."""
    from flashmoe_tpu_torch import quant as qt
    from flashmoe_tpu_torch.parallel import fused

    args, kw = _fused_inputs(gen, 4, gated, False, cap > 64, dtype, cap=cap)
    qargs, qkw = _quantize_shard(args, kw, qname)
    tol = BF16_TOL if dtype == torch.bfloat16 else 1e-5
    ring = fused.default_ring(4)
    before = fused.fused_shard_cuda.launches
    for schedule in ("rowwin", "stream"):
        _fused_check(qargs, qkw, 4, ring, schedule, tol)
    deq = list(qargs)
    for i, key in ((3, "wup_sc"), (5, "wdn_sc"), (7, "wg_sc")):
        if deq[i] is not None:
            deq[i] = qt.dequantize_channelwise(deq[i], qkw[key], dtype)
    got = fused.fused_shard_cuda(*qargs, schedule="rowwin", **qkw)
    want = fused.fused_shard_cuda(*deq, schedule="rowwin", **kw)
    torch.cuda.synchronize()
    live = torch.arange(cap, device="cuda") < args[0][..., None]
    assert torch.equal(got[live], want[live])
    assert fused.fused_shard_cuda.launches == before + 4


def test_fused_ep_quant_kernel_refusals(gen):
    """Payloads without scales, grouped scales and mixed stores are
    refused before any launch."""
    from flashmoe_tpu_torch import quant as qt
    from flashmoe_tpu_torch.parallel import fused

    args, kw = _fused_inputs(gen, 2, True, False, False)
    qargs, qkw = _quantize_shard(args, kw, "int8")
    before = fused.fused_shard_cuda.launches
    with pytest.raises(ValueError, match="without its scales"):
        fused.fused_shard_cuda(*qargs, **dict(qkw, wg_sc=None))
    _, grouped = qt.quantize_channelwise(args[3], "int8", group_size=64)
    with pytest.raises(ValueError, match="scales are"):
        fused.fused_shard_cuda(*qargs, **dict(qkw, wup_sc=grouped))
    mixed = qargs[:5] + (qargs[5].float().to(torch.float8_e4m3fn),) \
        + qargs[6:]
    with pytest.raises(ValueError, match="one quantized store"):
        fused.fused_shard_cuda(*mixed, **qkw)
    assert fused.fused_shard_cuda.launches == before


@pytest.mark.parametrize("qname", ["int8", "e4m3"])
def test_quantized_layers_kernels_match_plain(gen, monkeypatch, qname):
    """On a quantized store: ``moe_layer`` (boundary dequant, then the
    gate and grouped FFN kernels) and the fused layer (B5q, at the
    default schedule) against their plain runs, and the fused layer
    against the collective one."""
    from flashmoe_tpu_torch import quant as qt
    from flashmoe_tpu_torch.parallel import ep, fused, mesh

    monkeypatch.setenv("FLASHMOE_FUSED_COMBINE", "0")
    cfg = MoEConfig(num_experts=8, expert_top_k=2, hidden_size=128,
                    intermediate_size=192, gated_ffn=True, hidden_act="silu",
                    drop_tokens=False, ep=4, expert_quant=qname,
                    dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    p = qt.quantize_state(init_moe_params(gen, cfg, device="cuda"),
                          qname).params
    x = torch.randn(256, 128, device="cuda", generator=gen,
                    dtype=torch.bfloat16)
    before = expert.grouped_ffn_cuda.launches
    one = moe_layer(p, x, cfg.replace(ep=1))
    assert expert.grouped_ffn_cuda.launches == before + 1
    plain = moe_layer(p, x, cfg.replace(ep=1), use_kernels=False)
    assert _normwise(one.out, plain.out) <= BF16_TOL
    m = mesh.local_mesh(4)
    fcfg = cfg.replace(moe_backend="fused")
    before = fused.fused_shard_cuda.store_launches[qname]
    got = fused.fused_ep_moe_layer(p, x, fcfg, m)
    assert fused.fused_shard_cuda.store_launches[qname] == before + 1
    want = fused.fused_ep_moe_layer(p, x, fcfg, m, use_kernels=False)
    assert _normwise(got.out, want.out) <= BF16_TOL
    coll = ep.ep_moe_layer(p, x, cfg, m)
    assert _normwise(got.out, coll.out) <= BF16_TOL
    assert _normwise(got.out, one.out) <= BF16_TOL


# ----------------------------------------------------------------------
# the gate's split-H grid and the Hopper grouped matmul
# ----------------------------------------------------------------------

_GATE_GRID = [(s, e, k) for s in (1, 4, 17, 1024, 8192)
              for e in (8, 60, 256) for k in (1, 2, 8, 32) if k <= e]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("s,e,k", _GATE_GRID,
                         ids=[f"s{s}_e{e}_k{k}" for s, e, k in _GATE_GRID])
def test_gate_kernel_grid_matches_plain(gen, dtype, s, e, k):
    """The gate over its split-H grid at decode, odd and prefill token
    counts: ids equal to the plain router's except at near-ties of the
    probabilities (the f32 sums run in another order), the other outputs
    close, and a second launch equal bit for bit (the tickets and the
    merge order)."""
    h = 512
    cfg = MoEConfig(num_experts=e, expert_top_k=k, hidden_size=h,
                    router_z_loss_coef=1e-3, dtype=dtype)
    x = torch.randn(s, h, device="cuda", generator=gen, dtype=dtype)
    w = (torch.randn(h, e, device="cuda", generator=gen) / 16).to(dtype)
    got = gate.router_cuda(x, w, cfg)
    again = gate.router_cuda(x, w, cfg)
    want = gate.router_plain(x, w, cfg)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    # another id set only at a near-tie of the k-th and (k + 1)-th
    # probabilities, another order only among near-equal ones
    probs = torch.softmax(x.float() @ w.float(), -1)
    sets = (got.expert_idx.sort(-1).values
            == want.expert_idx.sort(-1).values).all(-1)
    if not sets.all():
        top = probs[~sets].sort(-1, descending=True).values
        assert bool((top[:, k - 1] - top[:, k] <= 1e-4).all())
        assert int((~sets).sum()) <= 1 + s // 500
    best = probs.sort(-1, descending=True).values[:, :k]
    assert float((probs.gather(1, got.expert_idx) - best).abs().max()) \
        <= 1e-4
    same = (got.expert_idx == want.expert_idx).all(-1)
    torch.testing.assert_close(got.combine_weights[same],
                               want.combine_weights[same], rtol=1e-5,
                               atol=1e-6)
    assert torch.equal(got.expert_counts,
                       torch.bincount(got.expert_idx.reshape(-1),
                                      minlength=e))
    torch.testing.assert_close(got.probs_mean, want.probs_mean, rtol=1e-5,
                               atol=1e-7)
    torch.testing.assert_close(got.z_loss, want.z_loss, rtol=1e-4, atol=0)


def test_gate_kernel_is_batch_invariant(gen):
    """A token's routing does not depend on the batch it is routed in: the
    kernel's H slices are fixed by H and E, so tokens routed inside a
    prefill of 1024 get, bit for bit, the ids and weights they get when
    routed 4, 17 or 24 at a time."""
    cfg = MoEConfig(num_experts=8, expert_top_k=2, hidden_size=4096,
                    dtype=torch.bfloat16)
    x = torch.randn(1024, 4096, device="cuda", generator=gen,
                    dtype=torch.bfloat16)
    w = (torch.randn(4096, 8, device="cuda", generator=gen) / 64).to(
        torch.bfloat16)
    full = gate.router_cuda(x, w, cfg)
    for s0, n in ((0, 4), (100, 17), (1000, 24)):
        part = gate.router_cuda(x[s0:s0 + n].contiguous(), w, cfg)
        assert torch.equal(part.expert_idx, full.expert_idx[s0:s0 + n])
        assert torch.equal(part.combine_weights,
                           full.combine_weights[s0:s0 + n])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_gate_kernel_ties_take_the_lowest_index(gen, dtype):
    """Duplicated gate_w columns give exactly equal logits in the kernel;
    the lower expert index must win each tie, as in the plain router."""
    cfg = MoEConfig(num_experts=16, expert_top_k=4, hidden_size=256,
                    dtype=dtype)
    x = torch.randn(200, 256, device="cuda", generator=gen, dtype=dtype)
    w = (torch.randn(256, 16, device="cuda", generator=gen) / 16).to(dtype)
    w[:, 9] = w[:, 3]
    w[:, 14] = w[:, 3]
    w[:, 12] = w[:, 5]
    got = gate.router_cuda(x, w, cfg)
    want = gate.router_plain(x, w, cfg)
    assert torch.equal(got.expert_idx, want.expert_idx)
    picked = got.expert_idx
    assert not ((picked == 9) & ~(picked == 3).any(-1, keepdim=True)).any()
    assert not ((picked == 12) & ~(picked == 5).any(-1, keepdim=True)).any()


def _gmm_rows(gen, t, tiles_per_expert):
    gid = torch.tensor([e for e, c in enumerate(tiles_per_expert)
                        for _ in range(c)], dtype=torch.int32, device="cuda")
    assert gid.numel() * expert.ROW_TILE == t
    return gid


@pytest.mark.parametrize("k,n,tiles", [
    (64, 64, (2,)), (192, 128, (2, 0, 3, 1)), (4096, 14336, (3, 0, 2)),
    (14336, 4096, (1, 2, 0, 2))], ids=["k64", "k192", "d_hidden", "d_x"])
@pytest.mark.parametrize("live", [None, "tail"], ids=["all", "num_rows"])
def test_grouped_matmul_hopper_matches_plain(gen, k, n, tiles, live):
    """The bf16 transpose_w path (the Hopper kernel) at the card test's
    shapes and the training step's widths, with experts that own no rows,
    without and with a ragged tail (zeros past num_rows), in f32 and bf16
    out; a second call equal bit for bit."""
    t = sum(tiles) * expert.ROW_TILE
    gid = _gmm_rows(gen, t, tiles)
    x = torch.randn(t, k, device="cuda", generator=gen, dtype=torch.bfloat16)
    w = (torch.randn(len(tiles), n, k, device="cuda", generator=gen)
         / 32).to(torch.bfloat16)
    nrow = None if live is None else torch.tensor(
        t - expert.ROW_TILE, device="cuda")
    before = expert.grouped_matmul_cuda.hopper_launches
    for out_dtype in (torch.float32, torch.bfloat16):
        kw = dict(transpose_w=True, out_dtype=out_dtype, num_rows=nrow)
        got = expert.grouped_matmul_cuda(x, gid, w, **kw)
        again = expert.grouped_matmul_cuda(x, gid, w, **kw)
        want = expert.grouped_matmul_plain(x, gid, w, **kw)
        assert torch.equal(got, again)
        if out_dtype == torch.float32:
            torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
        else:
            assert _normwise(got, want) <= BF16_TOL
        if nrow is not None:
            assert not got[int(nrow):].any()
    assert expert.grouped_matmul_cuda.hopper_launches == before + 4


def test_grouped_matmul_hopper_work_list_matches_python(gen):
    """The work list the Hopper grouped matmul builds on the device (its
    one-block plan launch, over several 1024-tile chunks) equals
    ``gmm_work_list``'s on random sorted and unsorted plans with a ragged
    tail and dead tiles (-1), and the GEMM over it (w [E, N, K] and [E, K,
    N] in turn) matches the plain version."""
    from flashmoe_tpu_torch.kernels import _build

    rng = np.random.default_rng(7)
    lib = _build.library()
    for case in range(8):
        bm = expert.ROW_TILE * int(rng.choice([1, 2]))
        nt = int(rng.integers(1, 1400))
        gid = rng.integers(0, int(rng.integers(1, 9)), nt)
        if case % 2:
            gid = np.sort(gid)
        if case % 4 > 1:
            gid[rng.random(nt) < 0.4] = -1
        t = nt * bm
        nrow = int(rng.integers(0, t // expert.ROW_TILE + 1)) * expert.ROW_TILE
        gid_t = torch.tensor(gid, dtype=torch.int32, device="cuda")
        nrow_t = torch.tensor([nrow], dtype=torch.int32, device="cuda")
        x = torch.randn(t, 64, device="cuda", generator=gen,
                        dtype=torch.bfloat16)
        w = torch.randn(8, 64, 64, device="cuda", generator=gen,
                        dtype=torch.bfloat16)
        tw = case % 2 == 0
        args, out, plan = expert.gmm_hopper_args(x, gid_t, w, torch.float32,
                                                 nrow_t, transpose_w=tw)
        assert lib.fm_grouped_matmul_hopper(*args) == 0
        want = expert.gmm_work_list(gid_t.cpu(), bm, t, nrow)
        got = plan.cpu()
        count = int(got[-1])
        assert count == len(want)
        assert [tuple(r[:3]) for r in got[:4 * count].reshape(-1, 4).tolist()
                ] == want
        torch.testing.assert_close(
            out, expert.grouped_matmul_plain(x, gid_t, w, transpose_w=tw,
                                             out_dtype=torch.float32,
                                             num_rows=nrow_t),
            rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("k,n,tiles", [
    (64, 64, (2,)), (192, 320, (2, 0, 3, 1)), (4096, 14336, (3, 0, 2)),
    (14336, 4096, (1, 2, 0, 2))],
    ids=["k64", "k192_n320", "recompute", "k14336"])
@pytest.mark.parametrize("cut", ["all", "dead", "dead_num_rows"])
def test_grouped_matmul_hopper_mn_matches_plain(gen, k, n, tiles, cut):
    """bf16 w [E, K, N] (the fused backward's recompute: MN-major B read
    in place) on the Hopper kernel, at the card test's shapes and the
    recompute's widths, experts that own no rows, with dead tiles (-1:
    every other tile) and a ragged tail: f32 out within 2e-4 and bf16 out
    normwise of the plain version, dead rows and rows past num_rows
    exactly zero, a second call equal bit for bit; every call a Hopper
    launch."""
    t = sum(tiles) * expert.ROW_TILE
    gid = _gmm_rows(gen, t, tiles)
    if cut != "all":
        gid[1::2] = -1
    x = torch.randn(t, k, device="cuda", generator=gen, dtype=torch.bfloat16)
    w = (torch.randn(len(tiles), k, n, device="cuda", generator=gen)
         / 32).to(torch.bfloat16)
    nrow = torch.tensor(t - expert.ROW_TILE, device="cuda") \
        if cut == "dead_num_rows" else None
    dead = (gid < 0).repeat_interleave(expert.ROW_TILE)
    if nrow is not None:
        dead[int(nrow):] = True
    before = expert.grouped_matmul_cuda.hopper_launches
    for out_dtype in (torch.float32, torch.bfloat16):
        kw = dict(out_dtype=out_dtype, num_rows=nrow)
        got = expert.grouped_matmul_cuda(x, gid, w, **kw)
        again = expert.grouped_matmul_cuda(x, gid, w, **kw)
        want = expert.grouped_matmul_plain(x, gid, w, **kw)
        assert torch.equal(got, again)
        assert not got[dead].any()
        if out_dtype == torch.float32:
            torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
        else:
            assert _normwise(got, want) <= BF16_TOL
    assert expert.grouped_matmul_cuda.hopper_launches == before + 4


@pytest.mark.parametrize("transpose_w", [False, True], ids=["w", "wT"])
def test_grouped_matmul_f32_dead_tiles(gen, transpose_w):
    """The f32 tile kernel honours dead tiles (-1): their rows exactly
    zero, the others as the plain version's, in both layouts of w."""
    e, k, n = 3, 192, 128
    gid = torch.tensor([0, -1, 2, 2, -1, 1], dtype=torch.int32,
                       device="cuda")
    x = torch.randn(gid.numel() * expert.ROW_TILE, k, device="cuda",
                    generator=gen)
    w = torch.randn(*((e, n, k) if transpose_w else (e, k, n)),
                    device="cuda", generator=gen)
    got = expert.grouped_matmul_cuda(x, gid, w, transpose_w=transpose_w)
    want = expert.grouped_matmul_plain(x, gid, w, transpose_w=transpose_w)
    assert not got[(gid < 0).repeat_interleave(expert.ROW_TILE)].any()
    assert _normwise(got, want) <= 1e-5


# ----------------------------------------------------------------------
# the Hopper grouped FFN: bf16 B2 and B3 on TMA + wgmma
# ----------------------------------------------------------------------

@pytest.mark.parametrize("k,n", [(64, 128), (192, 256), (4096, 128),
                                 (4096, 256)],
                         ids=["k64_n128", "k192_n256", "k4096_n128",
                              "k4096_n256"])
def test_hopper_tile_mn_matches_matmul(gen, k, n):
    """One block of the MN-major mainloop (B [K, N] row-major read in
    place, wgmma with the transposed-B flag) against torch.matmul in f32
    on the same bf16 inputs: f32 sums of the same products in another
    order, within 1e-5 of the largest output."""
    a = torch.randn(64, k, device="cuda", generator=gen).to(torch.bfloat16)
    b = torch.randn(k, n, device="cuda", generator=gen).to(torch.bfloat16)
    got = expert.hopper_tile_mn_cuda(a, b)
    want = torch.matmul(a.float(), b.float())
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


# gated, act, dtype, E, H, I, 64-row tiles of each expert, ragged tail
_FFN_CASES = [
    (True, "silu", torch.bfloat16, 4, 256, 512, (3, 0, 2, 1), False),
    (True, "gelu", torch.bfloat16, 3, 128, 320, (1, 1, 4), True),
    (False, "gelu", torch.bfloat16, 3, 192, 512, (2, 3, 0), True),
    (False, "relu", torch.bfloat16, 2, 320, 192, (5, 2), False),
    (True, "silu", torch.bfloat16, 2, 4096, 14336, (2, 1), True),
    (True, "gelu", torch.float32, 3, 128, 192, (1, 2, 1), True),
]


@pytest.mark.parametrize(
    "gated,act,dtype,e,h,i,tiles,tail", _FFN_CASES,
    ids=["swiglu_i512", "geglu_i320_tail", "gelu_i512_tail", "relu_h320",
         "mixtral_i14336_tail", "f32_geglu_tail"])
def test_grouped_ffn_hopper_matches_plain_and_b3(gen, gated, act, dtype, e,
                                                 h, i, tiles, tail):
    """B2 against its plain version (bf16 within 1e-2 normwise, f32
    1e-5) at odd and even runs of tiles, an expert without rows, widths
    that are not multiples of the column tile, and with num_rows below T
    (zeros past it); a second call equal bit for bit; and B3 on tokens
    x [S, H] with src_tok such that x[src_tok] is B2's buffer: equal to
    B2 bit for bit at every row."""
    t = sum(tiles) * expert.ROW_TILE
    gid = _gmm_rows(gen, t, tiles)
    s = t // 2 + 1
    x = torch.randn(s, h, device="cuda", generator=gen, dtype=dtype)
    src = torch.randint(0, s, (t,), device="cuda", generator=gen)
    xbuf = x[src]
    w = lambda *sh: (torch.randn(*sh, device="cuda", generator=gen)
                     / sh[-2] ** 0.5).to(dtype)
    weights = (w(e, h, i), torch.randn(e, i, device="cuda", generator=gen),
               w(e, i, h), torch.randn(e, h, device="cuda", generator=gen),
               w(e, h, i) if gated else None)
    nrow = torch.tensor(t - expert.ROW_TILE, device="cuda") if tail \
        else None
    kw = dict(act_name=act, gated=gated, block_m=expert.ROW_TILE,
              num_rows=nrow)
    got = expert.grouped_ffn_cuda(xbuf, gid, *weights, **kw)
    again = expert.grouped_ffn_cuda(xbuf, gid, *weights, **kw)
    want = expert.grouped_ffn_plain(xbuf, gid, *weights, **kw)
    tok = expert.grouped_ffn_tokens_cuda(x, src, gid, *weights, **kw)
    assert torch.equal(got, again)
    assert _normwise(got, want) <= (BF16_TOL if dtype == torch.bfloat16
                                    else 1e-5)
    if nrow is not None:
        assert not got[int(nrow):].any()
    assert torch.equal(tok, got)


@pytest.mark.parametrize("tokens", [False, True], ids=["b2", "b3"])
def test_grouped_ffn_hopper_decode_rows_equal_prefill_rows(gen, tokens):
    """A token's output does not depend on its batch: the rows of 4 tokens
    routed alone (a decode step) equal, bit for bit, the same tokens'
    rows at the same experts inside a prefill of 512 tokens (no split-K,
    one K order and one column tile at every T)."""
    e, h, i = 8, 512, 1024
    cfg = MoEConfig(num_experts=e, expert_top_k=2, hidden_size=h,
                    drop_tokens=False, dtype=torch.bfloat16)
    x = torch.randn(512, h, device="cuda", generator=gen,
                    dtype=torch.bfloat16)
    ids = torch.randn(512, e, device="cuda", generator=gen).topk(2, -1)[1]
    w = lambda *sh: (torch.randn(*sh, device="cuda", generator=gen)
                     / sh[-2] ** 0.5).to(torch.bfloat16)
    weights = (w(e, h, i), torch.randn(e, i, device="cuda", generator=gen),
               w(e, i, h), torch.randn(e, h, device="cuda", generator=gen),
               w(e, h, i))
    outs = []
    for s in (512, 4):
        xs = x[:s].contiguous()
        plan = ragged.make_ragged_plan(ids[:s], cfg, expert.ROW_TILE)
        kw = dict(act_name="silu", gated=True, block_m=expert.ROW_TILE,
                  num_rows=plan.num_rows)
        y = expert.grouped_ffn_tokens_cuda(
            xs, plan.src_tok, plan.tile_gid, *weights, **kw) if tokens \
            else expert.grouped_ffn_cuda(
                ragged.ragged_dispatch(xs, plan, cfg, expert.ROW_TILE),
                plan.tile_gid, *weights, **kw)
        outs.append(y[plan.position.reshape(-1)])
    assert torch.equal(outs[1], outs[0][:8])


# ----------------------------------------------------------------------
# B6, B5 and B5q on the Hopper FFN's mainloop: equal to B2 bit for bit
# ----------------------------------------------------------------------

_RES_CASES = [(gated, act, i) for gated, act in
              ((True, "silu"), (True, "gelu"), (False, "gelu"),
               (False, "relu")) for i in (320, 14336)]


@pytest.mark.parametrize(
    "gated,act,i", _RES_CASES,
    ids=[f"{'gated' if g else 'plain'}_{a}_i{i}" for g, a, i in _RES_CASES])
def test_grouped_ffn_res_hopper_y_equals_b2(gen, gated, act, i):
    """bf16 B6 runs B2's Hopper FFN, whose up pass also writes u and g: its
    y equals B2's out bit for bit (num_rows below T, an odd run of tiles,
    an expert without rows, I a multiple of 64 but not of the column
    tile); u and g within the bf16 tolerance of the plain version and
    zero past num_rows; a second call equal bit for bit."""
    e, h = 4, 192
    tiles = (3, 0, 2, 1)
    t = sum(tiles) * expert.ROW_TILE
    gid = _gmm_rows(gen, t, tiles)
    xbuf = torch.randn(t, h, device="cuda", generator=gen,
                       dtype=torch.bfloat16)
    w = lambda *sh: (torch.randn(*sh, device="cuda", generator=gen)
                     / sh[-2] ** 0.5).to(torch.bfloat16)
    weights = (w(e, h, i), torch.randn(e, i, device="cuda", generator=gen),
               w(e, i, h), torch.randn(e, h, device="cuda", generator=gen),
               w(e, h, i) if gated else None)
    nrow = torch.tensor(t - expert.ROW_TILE - 64 * (i > 1000),
                        device="cuda")
    kw = dict(act_name=act, gated=gated, block_m=expert.ROW_TILE,
              num_rows=nrow)
    got = expert.grouped_ffn_res_cuda(xbuf, gid, *weights, **kw)
    again = expert.grouped_ffn_res_cuda(xbuf, gid, *weights, **kw)
    b2 = expert.grouped_ffn_cuda(xbuf, gid, *weights, **kw)
    want = expert.grouped_ffn_res_plain(xbuf, gid, *weights, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[0], b2)
    live = int(nrow)
    for name, a, b, c in zip("yug", got, want, again):
        assert (a is None) == (b is None) == (c is None), name
        if a is None:
            continue
        assert torch.equal(a, c), name
        assert _normwise(a, b) <= BF16_TOL, name
        assert not a[live:].any(), name


def _b2_rows(args, kw):
    """B2 (``grouped_ffn_cuda``) on every row the fused kernel's shard
    arguments send: for each owner, its experts' received rows (source
    by source) in one ragged buffer; returned as y[src, owner, e, slot]
    at the populated slots, zeros elsewhere."""
    send_cnt, _, x_send, w_up, b_up, w_down, b_down, w_gate = args
    d, _, nlx, _, h = x_send.shape
    cnt = send_cnt.tolist()
    y = torch.zeros_like(x_send)
    bm = expert.ROW_TILE
    for r in range(d):
        rows, gids, places = [], [], []
        for e in range(nlx):
            n = sum(cnt[s][r][e] for s in range(d))
            for s in range(d):
                rows.append(x_send[s, r, e, :cnt[s][r][e]])
            pad = -(-n // bm) * bm - n
            rows.append(x_send.new_zeros(pad, h))
            gids += [e] * ((n + pad) // bm)
            places.append(pad)
        if not gids:
            continue
        own = slice(r * nlx, (r + 1) * nlx)
        out = expert.grouped_ffn_cuda(
            torch.cat(rows), torch.tensor(gids, device="cuda"), w_up[own],
            b_up[own], w_down[own], b_down[own],
            None if w_gate is None else w_gate[own], act_name=kw["act_name"],
            gated=kw["gated"], block_m=bm)
        at = 0
        for e in range(nlx):
            for s in range(d):
                c = cnt[s][r][e]
                y[s, r, e, :c] = out[at:at + c]
                at += c
            at += places[e]
    return y


def _combine_like_kernel(y, send_cnt, recv_pos, w_sorted, k):
    """The in-kernel combine of the rows y[src, owner, e, slot]: each
    returned row at its sorted row of its source, then per token the f32
    sum, in order, of each nonzero weight times its row."""
    d, _, nlx, cap, h = y.shape
    rows_pad = w_sorted.shape[1]
    live = torch.arange(cap, device="cuda") < send_cnt[..., None]
    out = []
    for s in range(d):
        ys = torch.zeros(rows_pad, h, dtype=y.dtype, device="cuda")
        pos = recv_pos[:, s].long()  # [owner, e, slot]
        ys[pos[live[s]]] = y[s][live[s]]
        acc = torch.zeros(rows_pad // k, h, device="cuda")
        for j in range(k):
            w = w_sorted[s, j::k][:, None]
            acc = torch.where(w != 0, acc + ys[j::k].float() * w, acc)
        out.append(acc)
    return torch.stack(out)


# ep 16 at 8 blocks a rank fills 128 of an H100's 132 SMs: the TMA maps of
# every rank travel in a device buffer, not in the kernel's parameters
_B5_CASES = [(d, combine, cap) for d in (1, 3, 8) for combine in (False, True)
             for cap in (32, 96)] + [(16, False, 96), (16, True, 32)]


@pytest.mark.parametrize(
    "d,combine,cap", _B5_CASES,
    ids=[f"ep{d}_{'combine' if c else 'slabs'}_cap{cap}"
         for d, c, cap in _B5_CASES])
def test_fused_ep_hopper_rows_equal_b2(gen, d, combine, cap):
    """bf16 B5 (the Hopper kernel: items of two tiles paired across
    sources, column tiles of 128 gated and 256 down, epilogues straight
    from the fragments) returns each populated row equal, bit for bit, to
    B2 on the same rows (the same K order, column tiles, epilogue and
    act_f); with the in-kernel combine, the combined rows equal the same
    f32 combine of B2's rows.  Both processing orders, capacities below
    and above the 64-row tile, H and I that are not multiples of the
    column tile; two calls in a row give identical results."""
    from flashmoe_tpu_torch.parallel import fused

    args, kw = _fused_inputs(gen, d, True, combine, d > 2, cap=cap, h=320,
                             i=320)
    ref = _b2_rows(args, kw)
    live = torch.arange(cap, device="cuda") < args[0][..., None]
    if combine:
        ref = _combine_like_kernel(ref, args[0], kw["recv_pos"],
                                   kw["w_sorted"], kw["k"])
    for schedule in ("stream", "rowwin"):
        got = fused.fused_shard_cuda(*args, schedule=schedule, **kw)
        again = fused.fused_shard_cuda(*args, schedule=schedule, **kw)
        torch.cuda.synchronize()
        if not combine:
            got, again = got[live], again[live]
        assert torch.equal(got, again), schedule
        assert torch.equal(got, ref if combine else ref[live]), schedule


def test_fused_ep_bf16_arms_take_one_hopper_block_per_sm(gen):
    """The bf16 arms of B5 and B5q (full precision, int8, e4m3; gated or
    not) launch the Hopper kernel, one block of 384 threads per SM (its
    ring fills the SM's shared memory); the f32 arms keep the 64 x 64
    tile, several blocks an SM.  A call past 128 ranks is refused before
    any launch, bf16 as f32."""
    from flashmoe_tpu_torch.parallel import fused

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    xb = torch.zeros(1, device="cuda", dtype=torch.bfloat16)
    xf = torch.zeros(1, device="cuda")
    for gated in (True, False):
        for wq in (0, 1, 2):
            assert fused.max_blocks(xb, gated, wq) == sms
            assert fused.max_blocks(xf, gated, wq) > sms
    args, kw = _fused_inputs(gen, 129, False, False, False, cap=32, nlx=1,
                             h=64, i=64)
    before = fused.fused_shard_cuda.launches
    with pytest.raises(ValueError, match="D <= 128"):
        fused.fused_shard_cuda(*args, **kw)
    assert fused.fused_shard_cuda.launches == before


# ----------------------------------------------------------------------
# the Hopper transposed grouped matmul (bf16 B8) and flash attention
# (bf16 B9) on TMA + wgmma, and the operand forms they add
# ----------------------------------------------------------------------

@pytest.mark.parametrize("form,k,n", [
    ("tn", 64, 256), ("tn", 320, 256), ("nt", 64, 64), ("nt", 128, 64),
    ("rs", 64, 64), ("rs", 256, 64), ("rs", 64, 128), ("rs", 256, 128)],
    ids=["tn_k64", "tn_k320", "nt_k64", "nt_k128", "rs_n64_k64",
         "rs_n64_k256", "rs_n128_k64", "rs_n128_k256"])
def test_hopper_forms_match_matmul(gen, form, k, n):
    """Each new wgmma operand form alone on one block against torch.matmul
    in f32 on the same bf16 inputs: A MN-major (tn: a^T b, a [K, 64]),
    both K-major at n64 (nt: a b^T), A in registers against an MN-major B
    (rs: a b); f32 sums of the same products in another order, within
    1e-5 of the largest output."""
    code, ash, bsh, _ = expert.HOPPER_FORMS[form]
    a = torch.randn(*ash(k, n), device="cuda", generator=gen).to(
        torch.bfloat16)
    b = torch.randn(*bsh(k, n), device="cuda", generator=gen).to(
        torch.bfloat16)
    got = expert.hopper_form_cuda(form, a, b)
    want = {"tn": lambda: a.float().T @ b.float(),
            "nt": lambda: a.float() @ b.float().T,
            "rs": lambda: a.float() @ b.float()}[form]()
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


# E, K, N, 64-row tiles of each expert, live rows cut (64-row tiles)
_TGMM_CASES = [
    (1, 192, 320, (3,), None),
    (3, 64, 448, (2, 0, 1), 2),
    (8, 4096, 14336, (5, 5, 6, 4, 5, 5, 5, 5), 39),
    (8, 14336, 4096, (5, 5, 0, 4, 5, 5, 5, 5), 33),
    (64, 128, 192, tuple([0, 1, 2, 0] * 16), 50),
]


@pytest.mark.parametrize("e,k,n,tiles,live", _TGMM_CASES,
                         ids=["e1_odd", "e3_empty_cut", "e8_d_w_up",
                              "e8_d_w_down_empty", "e64_cut"])
def test_tgmm_hopper_matches_plain(gen, e, k, n, tiles, live):
    """bf16 B8 against its plain version, elementwise at f32 2e-4 (the
    JAX package's f32 tolerance; f32 sums of the same bf16 products in
    another order); every expert that owns no live row exactly 0 (written
    by the kernel: the output is filled with NaN first); two calls
    bit-equal (no atomics, one summation order).  Rows past the live cut
    hold garbage the kernel must not read."""
    gid = torch.tensor([g for g, c in enumerate(tiles) for _ in range(c)],
                       device="cuda")
    t = gid.numel() * 64
    x = torch.randn(t, k, device="cuda", generator=gen).to(torch.bfloat16)
    dy = torch.randn(t, n, device="cuda", generator=gen).to(torch.bfloat16)
    nrow = None
    if live is not None:
        nrow = torch.tensor(live * 64, device="cuda")
        x[live * 64:] = float("nan")
    args, dw, _ranges = expert.tgmm_args(x, dy, gid, e, num_rows=nrow)
    dw.fill_(float("nan"))
    assert _build.library().fm_tgmm(*args) == 0
    want = expert.tgmm_plain(x, dy, gid, e, num_rows=nrow)
    assert torch.isfinite(dw).all()
    assert bool(((dw - want).abs() <= 2e-4 + 2e-4 * want.abs()).all())
    owners = set(gid[:(live or len(gid))].tolist())
    for ex in range(e):
        if ex not in owners:
            assert not dw[ex].any(), f"expert {ex} owns no row"
    again = expert.tgmm_cuda(x, dy, gid, e, num_rows=nrow)
    assert torch.equal(again, dw)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("ratio", [1, 4, 8])
@pytest.mark.parametrize("t", [1, 63, 64, 200, 256, 272, 1024])
def test_flash_hopper_matches_plain(gen, t, ratio, d, causal):
    """bf16 B9 against its plain version at normwise 1e-2 (bf16 output
    rounding, p rounded to bf16 at other points of an online softmax):
    GQA ratios 1, 4 and 8 (tiles packing 1, 4 and 8 heads), T from one
    token to 16 key blocks, T not a multiple of the tile; two calls
    bit-equal."""
    nkv = 2
    q = torch.randn(2, nkv * ratio, t, d, device="cuda", generator=gen,
                    dtype=torch.bfloat16)
    k = torch.randn(2, nkv, t, d, device="cuda", generator=gen,
                    dtype=torch.bfloat16)
    v = torch.randn(2, nkv, t, d, device="cuda", generator=gen,
                    dtype=torch.bfloat16)
    got = attention.flash_attention_cuda(q, k, v, causal=causal)
    want = attention.flash_attention_plain(q, k, v, causal=causal)
    assert torch.isfinite(got).all()
    assert _normwise(got, want) <= BF16_TOL
    assert torch.equal(attention.flash_attention_cuda(q, k, v,
                                                      causal=causal), got)
