#!/usr/bin/env python3
"""Drive the PyTorch port (flashmoe_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run on any error:

1. build: compile the CUDA kernels from ``flashmoe_tpu_torch/csrc/``;
2. kernels: first the grouped FFN's MN-major mainloop alone (one block,
   [64, 4096] @ [4096, N] against torch.matmul); then hold each kernel
   against its plain torch version on the card at the shapes its path
   gives it (plus a small f32 case), and time the kernel, the plain
   version and one PyTorch library call computing the same function: the
   gate, grouped FFN and flash attention of serving, the residual-saving
   FFN (its output also against the grouped FFN's, bit for bit), grouped
   matmul and transposed grouped matmul of the training step, the two-pass gate's passes at the many-expert layer's widths
   (with pass 2 and without; f32 and K = 64 cases too), and the
   gather-fused FFN (also against the grouped FFN on the dispatched
   buffer, bit for bit).  The gate and both FFNs are timed at prefill and
   decode (the grouped FFN's decode rows also held, bit for bit, against
   the same tokens' rows inside the prefill), the grouped matmul at both
   of the train step's shapes; the gate and grouped matmul as the bare C
   call, with the wrapper's time beside it;
3. capacity arm: one MoE layer of the FlashMoE reference config (E=64,
   top-2, H=I=2048, 8192 tokens, capacity 256), kernels against plain,
   forward (explicit dispatch and gather-fused) and the gradients of
   ``sum(out**2) + aux``;
4. serve: Mixtral-8x7B at its published widths with 4 of its 32 layers
   and random bf16 weights: 4 prompts of 256 tokens, 16 greedy tokens
   through ``generate`` (the serving path: counts reset before, read
   after), with the explicit dispatch and again gather-fused (the same
   tokens but at a near-tie routing flip); every step's logits against
   ``forward`` over the whole sequence, and every prefill MoE layer
   against the dense oracle ``reference_moe``;
5. ep: expert parallelism over 8 virtual ranks of a local mesh: the ep
   path, ``forward`` at Mixtral widths (4 layers, 4 x 256 tokens) with
   the fused backend (counts reset before, read after) and the
   collective one, each against the one-device forward; the fused
   kernel (B5) at that path's shapes against its plain version and its
   rows against the grouped FFN's on the same rows (bit for bit), timed
   with the library yardstick; then one Mixtral-width MoE layer at 8192
   tokens (dropless) and the FlashMoE reference layer (capacity 32 a
   rank and expert): B5 as at the path's shapes, the fused layer
   against its plain version, the collective layer and (dropless) the
   single-device layer, the in-kernel combine against the layer's, each
   timed, one fused layer profiled;
6. quantized expert storage: Mixtral-8x7B at its published widths and
   all 32 layers with its experts stored as int8 (random bf16 weights
   quantized layer by layer, ``quant.quantize_ffn_params``): the store's
   bytes beside a bf16 store's, serving as in phase 4 (generate's step
   logits against ``forward``, a prefill and a decode step timed and
   profiled, the boundary dequantization's share, every prefill MoE layer
   and every MoE layer of the decode steps against ``reference_moe`` on
   its dequantized weights); on 4 of its
   layers the ep path over 8 virtual ranks (the fused backend streams the
   payloads through B5q, the fused kernel's quantized arm: counts reset
   before, read after; the collective backend), B5q at that path's shapes
   against its plain version (rowwin and stream, both handed the
   payloads, bit for bit against the
   kernel on the weights dequantized beforehand, timed with the library
   yardstick; a small f32 case), and one int8 layer at 8192 tokens timed
   beside the bf16 fused layer on the same weights dequantized; then the
   same with an e4m3 store of 4 layers (no 8192-token layer);
7. many-expert layer: one MoE layer at Qwen3-Next-80B-A3B's MoE widths
   (E 512, top-10, H 2048, I 512, one shared expert, 8192 tokens, bf16):
   inference with the gather-fused FFN off, on, and on with
   ``collect_stats`` (the many-expert path: counts reset before each,
   read after), each against the plain versions and ``reference_moe``,
   the stats against the plain run's; then forward and backward in
   training against a plain run replaying its routing;
8. train: Mixtral-8x7B's widths with 2 layers, bf16 weights and AdamW:
   three ``make_train_step`` steps on 4 x 257 tokens (the training path:
   counts reset before the first step, read after it); every gradient
   against the plain versions', the loss lower after one SGD step, and the
   step's device time split into the optimizer and ``value_and_grad``.

The second-to-last line of stdout is the kernels' JSON line, the last
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
package beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from flashmoe_tpu_torch import config, quant  # noqa: E402
from flashmoe_tpu_torch.kernels import _build  # noqa: E402
from flashmoe_tpu_torch.models import (generate, presets,  # noqa: E402
                                       reference, transformer)
from flashmoe_tpu_torch.ops import (attention, expert, gate,  # noqa: E402
                                    moe, ragged)
from flashmoe_tpu_torch.parallel import ep, fused, mesh  # noqa: E402
from flashmoe_tpu_torch.runtime import trainer  # noqa: E402
from flashmoe_tpu_torch.tree import tree_leaves  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s, bf16
# tensor-core FLOP/s, f32 FLOP/s outside the tensor cores
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
# bf16 kernels against f32 plain versions: normwise relative error
# (||kernel - plain|| / ||plain||).  Outputs are rounded to bf16 (2^-8 =
# 3.9e-3 relative per element) and the f32 sums run in another order, so
# hidden values may round to a neighbouring bf16 value.
BF16_NORMWISE_TOL = 1e-2
# the gate's f32 outputs: both sides sum f32 products of the same inputs
GATE_ABS_TOL = 1e-4
# a routing difference is accepted only as a near-tie of the plain
# version's probabilities, and on at most this share of tokens
NEAR_TIE = 1e-4
MAX_FLIP_SHARE = 1e-3
# the gate's losses: f32 sums of the same f32 terms in another order
GATE_LOSS_RTOL = 1e-4
# generate's step logits against forward over the whole sequence: the two
# paths round bf16 activations at different points (GEMMs of other shapes,
# decode attention in plain matmuls), which compounds over 4 layers to
# about 1e-2 normwise at the median row; every row is held to 5x that.
# Where that perturbation flips a routing decision, the logits of that
# position and of later ones in its sequence may move far.  Such a row is
# excused only when both paths' routing was recorded and every flip lies
# at a near-tie of forward's probabilities: gate logits move by about the
# bf16 tolerance, so two probabilities within twice that may cross.
SERVE_MEDIAN_TOL = 2 * BF16_NORMWISE_TOL
SERVE_ROW_TOL = 5 * BF16_NORMWISE_TOL
SERVE_NEAR_TIE = 2 * BF16_NORMWISE_TOL
# f32 outputs of the training kernels against their plain versions: the
# JAX package's own f32 tolerance (tests/test_expert.py), elementwise
F32_TOL = 2e-4
# gradients through the kernels against the plain versions' (which replay
# the kernel run's routing), per leaf, normwise: bf16 rounding at the same
# points, f32 sums in another order, compounded through the backward's
# chain of bf16 GEMMs
GRAD_NORMWISE_TOL = 2 * BF16_NORMWISE_TOL
# learning rate of the SGD check: large enough that the update of a
# 1/64-scale bf16 weight survives rounding (its ulp is 1.2e-4)
TRAIN_SGD_LR = 0.1


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def normwise(a, b) -> float:
    a, b = a.float(), b.float()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b).clamp_min(1e-30))


def max_abs(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def check_f32(tag, got, want) -> float:
    """An f32 output against its plain version, elementwise at F32_TOL."""
    err = (got - want).abs()
    check(bool(torch.isfinite(got).all()), f"{tag}: finite")
    check(bool((err <= F32_TOL + F32_TOL * want.abs()).all()),
          f"{tag}: max abs err {float(err.max())} (rtol = atol = {F32_TOL})")
    return float(err.max())


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds of ``fn`` over ``iters`` back-to-back calls on
    CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


# ----------------------------------------------------------------------
# kernel phase
# ----------------------------------------------------------------------

def routing_flips(ids_k, ids_p, probs_p) -> int:
    """Tokens whose top-k sets differ between kernel and plain; each must
    be a near-tie of the plain probabilities (the k-th and (k+1)-th)."""
    k = ids_k.shape[1]
    diff = (ids_k.sort(-1).values != ids_p.sort(-1).values).any(-1)
    n = int(diff.sum())
    if n:
        top = probs_p[diff].sort(-1, descending=True).values
        gaps = top[:, k - 1] - top[:, k]
        check(bool((gaps <= NEAR_TIE).all()),
              f"routing differs on {n} tokens, not all near-ties "
              f"(largest gap {float(gaps.max()):.3g})")
        check(n <= MAX_FLIP_SHARE * ids_k.shape[0] + 1,
              f"routing differs on {n} of {ids_k.shape[0]} tokens")
    return n


def check_gate(tag, x, w, cfg):
    cfg = cfg.replace(router_z_loss_coef=1e-3)  # so z_loss is compared
    got = gate.router_cuda(x, w, cfg)
    want = gate.router_plain(x, w, cfg)
    probs = torch.softmax(reference.dot_f32(x, w), -1)
    torch.cuda.synchronize()
    flips = routing_flips(got.expert_idx, want.expert_idx, probs)
    same = (got.expert_idx == want.expert_idx).all(-1)
    err = max_abs(got.combine_weights[same], want.combine_weights[same])
    check(err <= GATE_ABS_TOL, f"gate {tag}: combine weights err {err}")
    own = torch.bincount(got.expert_idx.reshape(-1),
                         minlength=cfg.num_experts)
    check(torch.equal(own, got.expert_counts), f"gate {tag}: counts")
    # each flipped token moves one selection from one expert to another
    dc = int((got.expert_counts - want.expert_counts).abs().sum())
    check(dc <= 2 * flips, f"gate {tag}: counts differ from plain by {dc} "
          f"with {flips} routing flips")
    pm = max_abs(got.probs_mean, want.probs_mean)
    check(pm <= 1e-6, f"gate {tag}: probs_mean err {pm}")
    losses = {}
    for name in ("aux_loss", "z_loss"):
        a, b = float(getattr(got, name)), float(getattr(want, name))
        losses[name] = abs(a - b) / abs(b)
        check(b != 0 and losses[name] <= GATE_LOSS_RTOL,
              f"gate {tag}: {name} {a} vs plain {b}")
    print(f"gate {tag}: S={x.shape[0]} H={x.shape[1]} E={cfg.num_experts} "
          f"K={cfg.expert_top_k} {x.dtype}: max_abs_err={err:.3g} "
          f"(tol {GATE_ABS_TOL}, f32 sums in another order) "
          f"routing_flips={flips} counts_diff={dc} probs_mean_err={pm:.3g} "
          f"aux_rel_err={losses['aux_loss']:.3g} "
          f"z_rel_err={losses['z_loss']:.3g} (tol {GATE_LOSS_RTOL})")
    return err


def gate_times(cfg, x, w, iters):
    """The gate kernel's own time, the bare C call (``fm_gate``) on
    buffers made once, beside ``router_cuda`` (the wrapper: checks,
    buffers, the call), the plain router and the library yardstick, all
    on CUDA events; and the bound of its bytes (x and gate_w read; the
    f32 weights and i64 ids [S, K], the f32 means and i64 counts [E]
    written) and operations."""
    s, h = x.shape
    e, k = cfg.num_experts, cfg.expert_top_k
    args, _, scratch = gate.gate_args(x, w, cfg)
    lib = _build.library()
    check(lib.fm_gate(*args) == 0, "fm_gate launch")

    def library():
        torch.topk(torch.softmax(torch.matmul(x, w).float(), -1), k)

    return dict(ms=cuda_ms(lambda: lib.fm_gate(*args), iters),
                wrapper_ms=cuda_ms(lambda: gate.router_cuda(x, w, cfg),
                                   iters),
                plain_ms=cuda_ms(lambda: gate.router_plain(x, w, cfg),
                                 iters),
                library_ms=cuda_ms(library, iters),
                **bound(bytes_=2 * s * h + 2 * h * e + 12 * s * k + 12 * e,
                        flops=2 * s * h * e))


def gate_phase(cfg, x, w):
    """The gate at Mixtral's prefill (1024 tokens) and decode (4 tokens)
    shapes and in f32, each against the plain router; then the kernel's
    own time at prefill (the row's ms) and at decode (decode_*)."""
    err = check_gate("prefill", x, w, cfg)
    check_gate("decode", x[:4].contiguous(), w, cfg)
    tc = config.MoEConfig(num_experts=16, expert_top_k=4, hidden_size=256,
                          dtype=torch.float32)
    g = torch.Generator(device="cuda").manual_seed(5)
    check_gate("f32", torch.randn(100, 256, device="cuda", generator=g),
               torch.randn(256, 16, device="cuda", generator=g) / 16, tc)
    pre = gate_times(cfg, x, w, 200)
    dec = gate_times(cfg, x[:4].contiguous(), w, 200)
    for tag, r, s in (("prefill", pre, x.shape[0]), ("decode", dec, 4)):
        print(f"gate {tag} S={s}: kernel_ms={r['ms']:.5f} (bare fm_gate) "
              f"wrapper_ms={r['wrapper_ms']:.5f} (router_cuda) "
              f"plain_ms={r['plain_ms']:.5f} "
              f"library_ms={r['library_ms']:.5f} "
              f"bound_ms={r['bound_ms']:.5f} ({r['bound_by']}) "
              f"grid={gate.gate_split(s, *w.shape, x.dtype)} "
              f"({gpu_line()})")
    return dict(
        name="gate", route="cuda", source="flashmoe_tpu_torch/csrc/gate.cu",
        replaces="flashmoe_tpu/ops/gate.py:102", max_abs_err=err, **pre,
        **{f"decode_{key}": v for key, v in dec.items()})


def bound(bytes_: float, flops: float, peak: float = BF16_FLOPS) -> dict:
    tb, tf = bytes_ / HBM_BPS * 1e3, flops / peak * 1e3
    return {"bound_ms": max(tb, tf),
            "bound_by": "bytes" if tb >= tf else "operations"}


def check_ffn(tag, args, kw):
    got = expert.grouped_ffn_cuda(*args, **kw)
    want = expert.grouped_ffn_plain(*args, **kw)
    torch.cuda.synchronize()
    tol = BF16_NORMWISE_TOL if got.dtype == torch.bfloat16 else 1e-5
    err, nerr = max_abs(got, want), normwise(got, want)
    check(bool(torch.isfinite(got).all()), f"grouped_ffn {tag}: finite")
    check(nerr <= tol, f"grouped_ffn {tag}: normwise err {nerr}")
    print(f"grouped_ffn {tag}: rows={args[0].shape[0]} "
          f"H={args[0].shape[1]} I={args[2].shape[2]} E={args[2].shape[0]} "
          f"{got.dtype} gated={kw['gated']}: normwise_err={nerr:.3g} "
          f"(tol {tol}) max_abs_err={err:.3g}")
    return err


def ffn_inputs(cfg, params, x):
    """What the dropless arm hands the grouped FFN for tokens x."""
    r = gate.router_cuda(x, params["gate_w"], cfg)
    plan = ragged.make_ragged_plan(r.expert_idx, cfg, expert.ROW_TILE)
    xbuf = ragged.ragged_dispatch(x, plan, cfg, expert.ROW_TILE)
    args = (xbuf, plan.tile_gid, params["w_up"], params["b_up"],
            params["w_down"], params["b_down"], params.get("w_gate"))
    kw = dict(act_name=cfg.hidden_act, gated=cfg.gated_ffn,
              block_m=expert.ROW_TILE, num_rows=plan.num_rows)
    return args, kw, plan


def ffn_library(cfg, segs, xbuf, w_up, b_up, w_down, b_down, w_gate):
    """The grouped FFN's function through cuBLAS, one expert segment at a
    time (the library yardstick)."""
    act = reference.activation_fn(cfg.hidden_act)
    out = torch.empty_like(xbuf)
    for e, a, b in segs:
        xe = xbuf[a:b]
        u = torch.addmm(b_up[e], xe, w_up[e])
        out[a:b] = torch.addmm(b_down[e], act(xe @ w_gate[e]) * u, w_down[e])
    return out


def ffn_bound(cfg, segs, gathered=False) -> dict:
    """B2's (or B3's) least time: the live rows read (as token rows and
    their src_tok with ``gathered``) and written once, the touched
    experts' weights and biases read once; 2 x rows x H x I operations a
    matrix."""
    rows = sum(b - a for _, a, b in segs)
    h, i = cfg.hidden_size, cfg.intermediate_size
    n_mats = 3 if cfg.gated_ffn else 2
    touched = sum(1 for _, a, b in segs if b > a)
    return bound(bytes_=2 * rows * h * 2 + (4 * rows if gathered else 0)
                 + touched * (n_mats * h * i * 2 + 4 * (i + h)),
                 flops=2 * rows * h * i * n_mats)


def ffn_times(cfg, args, kw, plan, iters=10) -> dict:
    """B2's wrapper time beside its plain version's, the library
    yardstick's and the bound, at one plan's rows."""
    segs = expert_segments(plan, expert.ROW_TILE)
    return dict(
        ms=cuda_ms(lambda: expert.grouped_ffn_cuda(*args, **kw), iters),
        plain_ms=cuda_ms(lambda: expert.grouped_ffn_plain(*args, **kw), 3),
        library_ms=cuda_ms(lambda: ffn_library(cfg, segs, args[0],
                                               *args[2:]), iters),
        **ffn_bound(cfg, segs))


def tile_phase():
    """The MN-major mainloop alone, before the FFN that runs on it: one
    block of [64, 4096] @ [4096, N] (the up pass's K), N 128 and 256,
    against torch.matmul in f32 on the same bf16 inputs (f32 sums of the
    same products in another order: 1e-5 of the largest output)."""
    g = torch.Generator(device="cuda").manual_seed(15)
    for n in (128, 256):
        a = torch.randn(64, 4096, device="cuda", generator=g).to(
            torch.bfloat16)
        b = torch.randn(4096, n, device="cuda", generator=g).to(
            torch.bfloat16)
        got = expert.hopper_tile_mn_cuda(a, b)
        want = torch.matmul(a.float(), b.float())
        torch.cuda.synchronize()
        err = float((got - want).abs().max() / want.abs().max())
        check(err <= 1e-5, f"hopper tile N={n}: relative err {err}")
        print(f"hopper_tile_mn K=4096 N={n}: max_abs_err/max={err:.3g} "
              f"(tol 1e-5)")


def ffn_phase(cfg, params, x):
    """B2 at Mixtral prefill (the tokens x) and decode (their first 4),
    each against its plain version and timed beside the plain version,
    the library yardstick and the bound (at decode: the touched experts'
    weights); the decode rows against the same tokens' rows inside the
    prefill, bit for bit; a small f32 case."""
    args, kw, plan = ffn_inputs(cfg, params, x)
    err = check_ffn("prefill", args, kw)
    dargs, dkw, dplan = ffn_inputs(cfg, params, x[:4].contiguous())
    check_ffn("decode", dargs, dkw)
    # a token's output does not depend on its batch: its decode rows are
    # its prefill rows (the gate routes it alike in both, card test)
    y = expert.grouped_ffn_cuda(*args, **kw)
    yd = expert.grouped_ffn_cuda(*dargs, **dkw)
    rows_p, rows_d = plan.position[:4].reshape(-1), dplan.position.reshape(-1)
    bm = expert.ROW_TILE
    check(torch.equal(plan.tile_gid[rows_p // bm],
                      dplan.tile_gid[rows_d // bm]),
          "decode tokens routed as in prefill")
    check(torch.equal(y[rows_p], yd[rows_d]),
          "grouped_ffn: decode rows differ from the same rows in prefill")
    print("grouped_ffn decode rows equal their prefill rows bit for bit")
    del y, yd
    small = config.MoEConfig(
        num_experts=3, expert_top_k=2, hidden_size=128, intermediate_size=256,
        gated_ffn=True, hidden_act="gelu", dtype=torch.float32)
    g = torch.Generator(device="cuda").manual_seed(6)
    sp = reference.init_moe_params(g, small, device="cuda")
    sp["b_up"] = torch.randn(3, 256, device="cuda", generator=g)
    sx = torch.randn(64, 128, device="cuda", generator=g)
    sargs, skw, _ = ffn_inputs(small, sp, sx)
    check_ffn("f32", sargs, skw)

    pre = ffn_times(cfg, args, kw, plan)
    dec = ffn_times(cfg, dargs, dkw, dplan, iters=50)
    for tag, r in (("prefill", pre), ("decode", dec)):
        print(f"grouped_ffn {tag}: ms={r['ms']:.4f} "
              f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
              f"plain_ms={r['plain_ms']:.4f} "
              f"library_ms={r['library_ms']:.4f} ({gpu_line()})")
    return dict(
        name="grouped_ffn", route="cuda",
        source="flashmoe_tpu_torch/csrc/grouped_ffn.cu",
        replaces="flashmoe_tpu/ops/expert.py:77", max_abs_err=err, **pre,
        **{f"decode_{key}": v for key, v in dec.items()})


def flash_phase():
    g = torch.Generator(device="cuda").manual_seed(7)

    def qkv(b, n, nkv, t, d, dt):
        return (torch.randn(b, n, t, d, device="cuda", generator=g,
                            dtype=dt),
                torch.randn(b, nkv, t, d, device="cuda", generator=g,
                            dtype=dt),
                torch.randn(b, nkv, t, d, device="cuda", generator=g,
                            dtype=dt))

    def one(tag, q, k, v):
        got = attention.flash_attention_cuda(q, k, v, causal=True)
        want = attention.flash_attention_plain(q, k, v, causal=True)
        torch.cuda.synchronize()
        tol = BF16_NORMWISE_TOL if q.dtype == torch.bfloat16 else 1e-5
        err, nerr = max_abs(got, want), normwise(got, want)
        check(nerr <= tol, f"flash {tag}: normwise err {nerr}")
        print(f"flash_attention {tag}: q={tuple(q.shape)} "
              f"kv={tuple(k.shape)} {q.dtype}: normwise_err={nerr:.3g} "
              f"(tol {tol}) max_abs_err={err:.3g}")
        return err

    q, k, v = qkv(4, 32, 8, 256, 128, torch.bfloat16)
    err = one("prefill", q, k, v)
    one("ragged_T272", *qkv(4, 32, 8, 272, 128, torch.bfloat16))
    one("d64", *qkv(2, 8, 8, 200, 64, torch.bfloat16))
    one("f32", *qkv(1, 4, 2, 100, 64, torch.float32))
    b, n, t, d = q.shape
    nkv = k.shape[1]
    return dict(
        name="flash_attention", route="cuda",
        source="flashmoe_tpu_torch/csrc/flash_attention.cu",
        replaces="flashmoe_tpu/ops/attention.py:54", max_abs_err=err,
        ms=cuda_ms(lambda: attention.flash_attention_cuda(q, k, v), 50),
        plain_ms=cuda_ms(lambda: attention.flash_attention_plain(q, k, v), 20),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), 50),
        **bound(bytes_=2 * (2 * b * n * t * d + 2 * b * nkv * t * d),
                    flops=4 * b * n * d * t * (t + 1) / 2))


def expert_segments(plan, bm):
    """(expert, first row, end row) of each expert's live rows in a
    ragged plan's buffer."""
    segs, start = [], 0
    for e, c in enumerate(plan.counts.tolist()):
        segs.append((e, start, start + c))
        start += -(-c // bm) * bm
    return segs


def res_phase(cfg, params, x):
    """The residual-saving FFN (training forward) at the train step's
    rows: y, u and g against the plain version; y against B2's output
    on the same rows, bit for bit (bf16 B6 runs B2's Hopper FFN, its up
    pass writing u and g beside hidden)."""
    args, kw, plan = ffn_inputs(cfg, params, x)
    live = int(plan.num_rows)
    got = expert.grouped_ffn_res_cuda(*args, **kw)
    want = expert.grouped_ffn_res_plain(*args, **kw)
    b2 = expert.grouped_ffn_cuda(*args, **kw)
    torch.cuda.synchronize()
    check(torch.equal(got[0], b2), "ffn_res: y differs from B2's output")
    del b2
    errs = []
    for name, a, b in zip("yug", got, want):
        nerr = normwise(a, b)
        check(bool(torch.isfinite(a).all()), f"ffn_res {name}: finite")
        check(nerr <= BF16_NORMWISE_TOL, f"ffn_res {name}: normwise {nerr}")
        check(not bool(a[live:].any()), f"ffn_res {name}: ragged tail zero")
        errs.append((name, nerr, max_abs(a, b)))
    print(f"grouped_ffn_res train: rows={args[0].shape[0]} live={live} "
          f"H={cfg.hidden_size} I={cfg.intermediate_size} bf16: " + " ".join(
              f"{n}_normwise_err={e:.3g} {n}_max_abs_err={m:.3g}"
              for n, e, m in errs) + f" (tol {BF16_NORMWISE_TOL}); "
          f"y equal to B2's output bit for bit")
    small = config.MoEConfig(
        num_experts=3, expert_top_k=2, hidden_size=128, intermediate_size=256,
        gated_ffn=False, hidden_act="gelu", dtype=torch.float32)
    g = torch.Generator(device="cuda").manual_seed(8)
    sp = reference.init_moe_params(g, small, device="cuda")
    sp["b_up"] = torch.randn(3, 256, device="cuda", generator=g)
    sargs, skw, _ = ffn_inputs(small, sp,
                               torch.randn(64, 128, device="cuda",
                                           generator=g))
    sgot = expert.grouped_ffn_res_cuda(*sargs, **skw)
    swant = expert.grouped_ffn_res_plain(*sargs, **skw)
    f32 = [check_f32(f"ffn_res f32 {n}", a, b)
           for n, a, b in zip("yu", sgot, swant)]
    print(f"grouped_ffn_res f32 gelu: max_abs_err={max(f32):.3g} "
          f"(rtol = atol = {F32_TOL})")

    xbuf, w_up, b_up, w_down, b_down, w_gate = (args[0], *args[2:])
    segs = expert_segments(plan, expert.ROW_TILE)
    act = reference.activation_fn(cfg.hidden_act)
    shapes = [tuple(t.shape) for t in got]
    del got, want

    def library():
        y, u, gg = (torch.empty(sh, device="cuda", dtype=torch.bfloat16)
                    for sh in shapes)
        for e, a, b in segs:
            xe = xbuf[a:b]
            u[a:b] = torch.addmm(b_up[e], xe, w_up[e])
            gg[a:b] = xe @ w_gate[e]
            y[a:b] = torch.addmm(b_down[e], act(gg[a:b]) * u[a:b],
                                 w_down[e])
        return y

    rows = sum(b - a for _, a, b in segs)
    t, h, i = xbuf.shape[0], cfg.hidden_size, cfg.intermediate_size
    touched = sum(1 for _, a, b in segs if b > a)
    rec = dict(
        name="grouped_ffn_res", route="cuda",
        source="flashmoe_tpu_torch/csrc/grouped_ffn.cu",
        replaces="flashmoe_tpu/ops/expert.py:665",
        max_abs_err=max(m for _, _, m in errs),
        ms=cuda_ms(lambda: expert.grouped_ffn_res_cuda(*args, **kw), 10),
        plain_ms=cuda_ms(lambda: expert.grouped_ffn_res_plain(*args, **kw),
                         3),
        library_ms=cuda_ms(library, 10),
        **bound(bytes_=rows * h * 2 + touched * (3 * h * i * 2
                                                 + 4 * (i + h))
                + t * (h + 2 * i) * 2,
                flops=2 * rows * h * i * 3))
    print(f"grouped_ffn_res train: ms={rec['ms']:.4f} "
          f"bound_ms={rec['bound_ms']:.4f} ({rec['bound_by']}) "
          f"plain_ms={rec['plain_ms']:.4f} library_ms={rec['library_ms']:.4f}")
    return rec


def gmm_phase(cfg, params, x):
    """The grouped matmul at the train step's two shapes: dHidden = dy @
    w_down^T (the row's numbers) and dX = d_up @ w_up^T (d_x_*), f32 out,
    on the Hopper kernel: against the plain version, then its own time
    (the bare C call, ``fm_grouped_matmul_hopper``) beside the wrapper's,
    the per-expert library matmul and the bound; then the 64 x 64 tile
    kernel's layouts (f32, both) against the plain version."""
    args, _, plan = ffn_inputs(cfg, params, x)
    gid, nrow = plan.tile_gid, plan.num_rows
    t, h, i = args[0].shape[0], cfg.hidden_size, cfg.intermediate_size
    g = torch.Generator(device="cuda").manual_seed(9)
    dy = torch.randn(t, h, device="cuda", generator=g, dtype=torch.bfloat16)
    d_up = torch.randn(t, i, device="cuda", generator=g,
                       dtype=torch.bfloat16)
    kw = dict(transpose_w=True, out_dtype=torch.float32, num_rows=nrow)
    calls = {"d_hidden": (dy, params["w_down"]),
             "d_x": (d_up, params["w_up"])}
    segs = expert_segments(plan, expert.ROW_TILE)
    rows = sum(b - a for _, a, b in segs)
    touched = sum(1 for _, a, b in segs if b > a)
    lib = _build.library()
    rec = {}
    for tag, (a_in, w) in calls.items():
        hop = expert.grouped_matmul_cuda.hopper_launches
        got = expert.grouped_matmul_cuda(a_in, gid, w, **kw)
        want = expert.grouped_matmul_plain(a_in, gid, w, **kw)
        torch.cuda.synchronize()
        check(expert.grouped_matmul_cuda.hopper_launches == hop + 1,
              f"grouped_matmul {tag} did not take the Hopper kernel")
        err = check_f32(f"grouped_matmul {tag}", got, want)
        k, n = a_in.shape[1], w.shape[1]
        bare, _, plan = expert.gmm_hopper_args(
            a_in, gid.to(torch.int32), w, torch.float32,
            nrow.reshape(1).to(torch.int32))
        check(lib.fm_grouped_matmul_hopper(*bare) == 0,
              "fm_grouped_matmul_hopper launch")

        def library(a_in=a_in, w=w):
            out = torch.empty((t, n), device="cuda", dtype=torch.bfloat16)
            for e, lo, hi in segs:
                out[lo:hi] = a_in[lo:hi] @ w[e].T
            return out

        r = dict(
            max_abs_err=err,
            ms=cuda_ms(lambda: lib.fm_grouped_matmul_hopper(*bare), 20),
            wrapper_ms=cuda_ms(
                lambda: expert.grouped_matmul_cuda(a_in, gid, w, **kw), 20),
            library_ms=cuda_ms(library, 20),
            plain_ms=cuda_ms(
                lambda: expert.grouped_matmul_plain(a_in, gid, w, **kw), 3),
            **bound(bytes_=rows * k * 2 + touched * k * n * 2 + t * n * 4,
                    flops=2 * rows * k * n))
        print(f"grouped_matmul {tag}: x [{t}, {k}] bf16 @ w^T [{n}, {k}] "
              f"per expert -> f32, live rows {rows}: max_abs_err={err:.3g} "
              f"(rtol = atol = {F32_TOL}) kernel_ms={r['ms']:.4f} (bare "
              f"fm_grouped_matmul_hopper, "
              f"{2 * rows * k * n / r['ms'] / 1e9:.1f} TFLOP/s) "
              f"wrapper_ms={r['wrapper_ms']:.4f} "
              f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
              f"library_ms={r['library_ms']:.4f} "
              f"plain_ms={r['plain_ms']:.4f} ({gpu_line()})")
        rec.update(r if tag == "d_hidden"
                   else {f"{tag}_{key}": v for key, v in r.items()})
    sg = torch.Generator(device="cuda").manual_seed(10)
    sx = torch.randn(192, 128, device="cuda", generator=sg)
    sgid = torch.tensor([0, 2, 2], device="cuda")
    for tw in (False, True):
        sw = torch.randn(3, 128, 64, device="cuda", generator=sg)
        sw = sw.transpose(1, 2).contiguous() if tw else sw
        check_f32(f"grouped_matmul f32 transpose_w={tw}",
                  expert.grouped_matmul_cuda(sx, sgid, sw, transpose_w=tw),
                  expert.grouped_matmul_plain(sx, sgid, sw, transpose_w=tw))
    print("grouped_matmul f32 (both layouts): within "
          f"rtol = atol = {F32_TOL}")
    return dict(name="grouped_matmul", route="cuda",
                source="flashmoe_tpu_torch/csrc/grouped_matmul.cu",
                replaces="flashmoe_tpu/ops/expert.py:490", **rec)


def tgmm_phase(cfg, params, x):
    """The transposed grouped matmul at the train step's two shapes:
    d_wu/d_wg = x^T d_up (reported) and d_wd = hidden^T dy."""
    args, _, plan = ffn_inputs(cfg, params, x)
    gid, nrow = plan.tile_gid, plan.num_rows
    xbuf = args[0]
    t, h, i = xbuf.shape[0], cfg.hidden_size, cfg.intermediate_size
    e = cfg.num_experts
    g = torch.Generator(device="cuda").manual_seed(11)
    d_up = torch.randn(t, i, device="cuda", generator=g,
                       dtype=torch.bfloat16)
    hidden = torch.randn(t, i, device="cuda", generator=g,
                         dtype=torch.bfloat16)
    dy = torch.randn(t, h, device="cuda", generator=g, dtype=torch.bfloat16)
    segs = expert_segments(plan, expert.ROW_TILE)
    rows = sum(b - a for _, a, b in segs)
    rec = None
    for tag, (a_in, b_in) in {"d_w_up": (xbuf, d_up),
                              "d_w_down": (hidden, dy)}.items():
        got = expert.tgmm_cuda(a_in, b_in, gid, e, num_rows=nrow)
        want = expert.tgmm_plain(a_in, b_in, gid, e, num_rows=nrow)
        torch.cuda.synchronize()
        err = check_f32(f"tgmm {tag}", got, want)
        del got, want
        k, n = a_in.shape[1], b_in.shape[1]

        def library(a_in=a_in, b_in=b_in):
            out = torch.empty((e, k, n), device="cuda", dtype=torch.bfloat16)
            for ex, lo, hi in segs:
                out[ex] = a_in[lo:hi].T @ b_in[lo:hi]
            return out

        ms = cuda_ms(lambda: expert.tgmm_cuda(a_in, b_in, gid, e,
                                              num_rows=nrow), 10)
        b = bound(bytes_=rows * (k + n) * 2 + e * k * n * 4,
                  flops=2 * rows * k * n)
        lib_ms = cuda_ms(library, 10)
        print(f"tgmm {tag}: [{t}, {k}]^T @ [{t}, {n}] bf16 per expert -> "
              f"f32 [{e}, {k}, {n}], live rows {rows}: max_abs_err={err:.3g} "
              f"(rtol = atol = {F32_TOL}) ms={ms:.4f} "
              f"bound_ms={b['bound_ms']:.4f} ({b['bound_by']}) "
              f"library_ms={lib_ms:.4f}")
        if rec is None:
            rec = dict(
                name="tgmm", route="cuda",
                source="flashmoe_tpu_torch/csrc/tgmm.cu",
                replaces="flashmoe_tpu/ops/expert.py:574", max_abs_err=err,
                ms=ms, library_ms=lib_ms, plain_ms=cuda_ms(
                    lambda: expert.tgmm_plain(a_in, b_in, gid, e,
                                              num_rows=nrow), 3), **b)
    # an expert that owns no row comes back exactly zero
    sg = torch.Generator(device="cuda").manual_seed(12)
    sx = torch.randn(192, 64, device="cuda", generator=sg)
    sdy = torch.randn(192, 128, device="cuda", generator=sg)
    sgid = torch.tensor([0, 0, 2], device="cuda")
    sw = expert.tgmm_cuda(sx, sdy, sgid, 3)
    check_f32("tgmm f32", sw, expert.tgmm_plain(sx, sdy, sgid, 3))
    check(not bool(sw[1].any()), "tgmm: an expert with no rows gets 0")
    print(f"tgmm f32 with an expert of no rows: within rtol = atol = "
          f"{F32_TOL}, that expert exactly 0")
    return rec


def check_tiled_gate(tag, x, w, cfg, need_stats):
    """The two-pass gate's kernels (``router_tiled_cuda``) against their
    plain version, as ``check_gate``; without pass 2, the counts from the
    ids and aux and z exactly 0.  Returns the combine weights' error."""
    cfg = cfg.replace(router_z_loss_coef=1e-3)
    got = gate.router_tiled_cuda(x, w, cfg, need_stats)
    want = gate.router_tiled_plain(x, w, cfg, need_stats)
    probs = torch.softmax(reference.dot_f32(x, w), -1)
    torch.cuda.synchronize()
    flips = routing_flips(got.expert_idx, want.expert_idx, probs)
    same = (got.expert_idx == want.expert_idx).all(-1)
    err = max_abs(got.combine_weights[same], want.combine_weights[same])
    check(err <= GATE_ABS_TOL, f"gate_tiled {tag}: combine weights err {err}")
    own = torch.bincount(got.expert_idx.reshape(-1),
                         minlength=cfg.num_experts)
    check(torch.equal(own, got.expert_counts), f"gate_tiled {tag}: counts")
    dc = int((got.expert_counts - want.expert_counts).abs().sum())
    check(dc <= 2 * flips, f"gate_tiled {tag}: counts differ from plain by "
          f"{dc} with {flips} routing flips")
    losses = {}
    if need_stats:
        pm = max_abs(got.probs_mean, want.probs_mean) \
            / float(want.probs_mean.abs().max())
        check(pm <= GATE_LOSS_RTOL, f"gate_tiled {tag}: probs_mean rel err "
              f"{pm}")
        for name in ("aux_loss", "z_loss"):
            a, b = float(getattr(got, name)), float(getattr(want, name))
            losses[name] = abs(a - b) / abs(b)
            check(b != 0 and losses[name] <= GATE_LOSS_RTOL,
                  f"gate_tiled {tag}: {name} {a} vs plain {b}")
    else:
        check(not got.probs_mean.any() and float(got.aux_loss) == 0
              and float(got.z_loss) == 0,
              f"gate_tiled {tag}: without pass 2 probs_mean, aux and z are 0")
        pm = 0.0
    print(f"gate_tiled {tag}: S={x.shape[0]} H={x.shape[1]} "
          f"E={cfg.num_experts} K={cfg.expert_top_k} {x.dtype} "
          f"pass2={need_stats}: max_abs_err={err:.3g} (tol {GATE_ABS_TOL}) "
          f"routing_flips={flips} counts_diff={dc} probs_mean_rel_err="
          f"{pm:.3g} " + " ".join(f"{k}_rel_err={v:.3g}"
                                  for k, v in losses.items())
          + f" (tol {GATE_LOSS_RTOL})")
    return err


def gate_tiled_phase():
    """The two-pass gate (B4a, B4b) at the many-expert layer's widths (S
    8192, H 2048, E 512, K 10, bf16), with pass 2 and without; the JAX
    tests' f32 case (E 1280, K 2, H 128) and K = 64.  B4b is also held
    alone against its plain version on the kernel's pass-1 outputs."""
    cfg = many_expert_cfg()
    s, h, e, k = cfg.tokens, cfg.hidden_size, cfg.num_experts, \
        cfg.expert_top_k
    g = torch.Generator(device="cuda").manual_seed(13)
    x = torch.randn(s, h, device="cuda", generator=g, dtype=torch.bfloat16)
    w = (torch.randn(h, e, device="cuda", generator=g)
         / math.sqrt(h)).to(torch.bfloat16)
    err = check_tiled_gate("many_expert", x, w, cfg, True)
    check_tiled_gate("many_expert", x, w, cfg, False)
    f32 = config.MoEConfig(num_experts=1280, expert_top_k=2, hidden_size=128,
                           dtype=torch.float32)
    check_tiled_gate("f32", torch.randn(1000, 128, device="cuda",
                                        generator=g),
                     torch.randn(128, 1280, device="cuda", generator=g)
                     / math.sqrt(128), f32, True)
    check_tiled_gate("k64", x[:1024].contiguous(), w,
                     cfg.replace(expert_top_k=64), True)

    logits, m, se, _, top_i = gate.gate_pass1_cuda(x, w, k, True)
    got = gate.gate_pass2_cuda(logits, m, se, top_i, e)
    want = gate.gate_pass2_plain(logits, m, se, top_i, e)
    torch.cuda.synchronize()
    p2_err = max_abs(got[0], want[0])
    check(p2_err <= 1e-5 * float(want[0].abs().max())
          and torch.equal(got[1].long(), want[1])
          and abs(float(got[2]) - float(want[2])) <= 1e-5 * float(want[2]),
          f"gate_pass2 alone: probs_sum err {p2_err}, zsum {float(got[2])} "
          f"vs {float(want[2])}, counts equal "
          f"{torch.equal(got[1].long(), want[1])}")
    print(f"gate_pass2 alone on the kernel's pass-1 outputs: probs_sum "
          f"max_abs_err={p2_err:.3g} (rtol 1e-5) counts exact zsum_rel_err="
          f"{abs(float(got[2]) - float(want[2])) / float(want[2]):.3g}")

    def library1():
        torch.topk(torch.softmax(torch.matmul(x, w).float(), -1), k)

    def library2():
        torch.softmax(logits, -1).sum(0)
        torch.bincount(top_i.reshape(-1), minlength=e)
        torch.logsumexp(logits, -1).square().sum()

    pass1 = dict(
        name="gate_pass1", route="cuda",
        source="flashmoe_tpu_torch/csrc/gate_tiled.cu",
        replaces="flashmoe_tpu/ops/gate.py:223", max_abs_err=err,
        ms=cuda_ms(lambda: gate.gate_pass1_cuda(x, w, k, True), 20),
        plain_ms=cuda_ms(lambda: gate.gate_pass1_plain(x, w, k, True), 5),
        library_ms=cuda_ms(library1, 20),
        **bound(bytes_=2 * s * h + 2 * h * e + 4 * s * e + 8 * s + 8 * s * k,
                flops=2 * s * h * e))
    pass2 = dict(
        name="gate_pass2", route="cuda",
        source="flashmoe_tpu_torch/csrc/gate_tiled.cu",
        replaces="flashmoe_tpu/ops/gate.py:308", max_abs_err=p2_err,
        ms=cuda_ms(lambda: gate.gate_pass2_cuda(logits, m, se, top_i, e), 20),
        plain_ms=cuda_ms(
            lambda: gate.gate_pass2_plain(logits, m, se, top_i, e), 5),
        library_ms=cuda_ms(library2, 20),
        **bound(bytes_=4 * s * e + 8 * s + 4 * s * k + 8 * e + 4,
                flops=4 * s * e, peak=F32_FLOPS))
    for rec in (pass1, pass2):
        print(f"{rec['name']}: S={s} H={h} E={e} K={k} bf16: "
              f"ms={rec['ms']:.4f} bound_ms={rec['bound_ms']:.4f} "
              f"({rec['bound_by']}) plain_ms={rec['plain_ms']:.4f} "
              f"library_ms={rec['library_ms']:.4f}")
    return [pass1, pass2]


def gather_times(cfg, x, args, kw, plan, iters=10) -> dict:
    """B3's wrapper time beside its plain version's, the library
    yardstick's (``index_select``, then the per-expert loop) and the
    bound, at one plan's rows."""
    targs = (x, plan.src_tok, *args[1:])
    segs = expert_segments(plan, expert.ROW_TILE)
    src = plan.src_tok
    return dict(
        ms=cuda_ms(lambda: expert.grouped_ffn_tokens_cuda(*targs, **kw),
                   iters),
        plain_ms=cuda_ms(
            lambda: expert.grouped_ffn_tokens_plain(*targs, **kw), 3),
        library_ms=cuda_ms(lambda: ffn_library(
            cfg, segs, x.index_select(0, src), *args[2:]), iters),
        **ffn_bound(cfg, segs, gathered=True))


def gather_phase(cfg, params, x):
    """The gather-fused FFN (B3) at the rows and ragged plans of B2's
    prefill and decode checks: against its plain version at the populated
    rows, and against B2 on the dispatched buffer there, bit for bit (the
    same bytes reach the same products and epilogue); a small f32 case;
    then timed at prefill and decode."""
    runs = {}
    for tag, xs in (("prefill", x), ("decode", x[:4].contiguous())):
        args, kw, plan = ffn_inputs(cfg, params, xs)
        targs = (xs, plan.src_tok, *args[1:])
        live = plan.present
        got = expert.grouped_ffn_tokens_cuda(*targs, **kw)
        want = expert.grouped_ffn_tokens_plain(*targs, **kw)
        b2 = expert.grouped_ffn_cuda(*args, **kw)
        torch.cuda.synchronize()
        nerr = normwise(got[live], want[live])
        err = max_abs(got[live], want[live])
        check(bool(torch.isfinite(got).all()), "grouped_ffn_tokens: finite")
        check(nerr <= BF16_NORMWISE_TOL,
              f"grouped_ffn_tokens {tag}: normwise {nerr}")
        check(torch.equal(got[live], b2[live]),
              f"grouped_ffn_tokens {tag}: differs from B2 on the dispatched "
              f"buffer by {max_abs(got[live], b2[live])}")
        print(f"grouped_ffn_tokens {tag}: tokens={xs.shape[0]} "
              f"rows={args[0].shape[0]} live={int(live.sum())} "
              f"H={cfg.hidden_size} I={cfg.intermediate_size} bf16: "
              f"normwise_err={nerr:.3g} (tol {BF16_NORMWISE_TOL}) "
              f"max_abs_err={err:.3g}; equal to B2 at every live row")
        del got, want, b2
        runs[tag] = (err, xs, args, kw, plan)
    small = config.MoEConfig(
        num_experts=3, expert_top_k=2, hidden_size=128, intermediate_size=256,
        gated_ffn=True, hidden_act="gelu", dtype=torch.float32)
    g = torch.Generator(device="cuda").manual_seed(14)
    sp = reference.init_moe_params(g, small, device="cuda")
    sp["b_up"] = torch.randn(3, 256, device="cuda", generator=g)
    sx = torch.randn(64, 128, device="cuda", generator=g)
    sargs, skw, splan = ffn_inputs(small, sp, sx)
    sl = splan.present
    sgot = expert.grouped_ffn_tokens_cuda(sx, splan.src_tok, *sargs[1:],
                                          **skw)
    check_f32("grouped_ffn_tokens f32", sgot[sl],
              expert.grouped_ffn_tokens_plain(sx, splan.src_tok, *sargs[1:],
                                              **skw)[sl])

    err, *pre_in = runs["prefill"]
    pre = gather_times(cfg, *pre_in)
    dec = gather_times(cfg, *runs["decode"][1:], iters=50)
    for tag, r in (("prefill", pre), ("decode", dec)):
        print(f"grouped_ffn_tokens {tag}: ms={r['ms']:.4f} "
              f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
              f"plain_ms={r['plain_ms']:.4f} "
              f"library_ms={r['library_ms']:.4f} ({gpu_line()})")
    return dict(
        name="grouped_ffn_tokens", route="cuda",
        source="flashmoe_tpu_torch/csrc/grouped_ffn.cu",
        replaces="flashmoe_tpu/ops/expert.py:196", max_abs_err=err, **pre,
        **{f"decode_{key}": v for key, v in dec.items()})


def b2_rows(args, kw):
    """B2 (``grouped_ffn_cuda``) on every row the fused kernel's shard
    arguments send: for each owner, its experts' received rows (source by
    source) in one ragged buffer; returned as y[src, owner, e, slot] at
    the populated slots, zeros elsewhere."""
    send_cnt, _, x_send, w_up, b_up, w_down, b_down, w_gate = args
    d, _, nlx, _, h = x_send.shape
    cnt = send_cnt.tolist()
    y = torch.zeros_like(x_send)
    bm = expert.ROW_TILE
    for r in range(d):
        rows, gids, pads = [], [], []
        for e in range(nlx):
            n = sum(cnt[s][r][e] for s in range(d))
            rows += [x_send[s, r, e, :cnt[s][r][e]] for s in range(d)]
            pads.append(-(-n // bm) * bm - n)
            rows.append(x_send.new_zeros(pads[-1], h))
            gids += [e] * ((n + pads[-1]) // bm)
        if not gids:
            continue
        own = slice(r * nlx, (r + 1) * nlx)
        out = expert.grouped_ffn_cuda(
            torch.cat(rows), torch.tensor(gids, device=x_send.device),
            w_up[own], b_up[own], w_down[own], b_down[own],
            None if w_gate is None else w_gate[own],
            act_name=kw["act_name"], gated=kw["gated"], block_m=bm)
        at = 0
        for e in range(nlx):
            for s in range(d):
                c = cnt[s][r][e]
                y[s, r, e, :c] = out[at:at + c]
                at += c
            at += pads[e]
    return y


def fused_kernel_row(tag, cfg, params, x, m, iters):
    """B5 on the shard inputs the fused layer builds for tokens x: against
    its plain version at populated rows (or on the combined output),
    timed beside the plain version and the library yardstick (the
    exchange as a transpose, then the per-expert ``addmm`` loop over each
    owner's slabs).  The kernel's other processing order (``stream``
    against ``batched`` or ``rowwin``) is checked and timed beside the one
    the layer chose.  Under ``cfg.expert_quant`` (B5q, the quantized
    arm, in both orders) the yardstick first dequantizes the payloads
    (``payload * scale`` into dt), the bound counts each weight at 1 byte
    and its scales at 4 bytes a channel, and the kernel's output must
    equal, bit for bit, the kernel's on the weights dequantized
    beforehand; with full-precision weights, the populated rows (in both
    orders) equal, bit for bit, B2's on the same rows (``b2_rows``).
    Returns the kernels-line entry."""
    fi = fused.fused_inputs(params, x, cfg, m)
    kw = {k: v for k, v in fi.kw.items() if k != "use_kernels"}
    send_cnt, _, x_send, w_up, b_up, w_down, b_down, w_gate = fi.args
    scales = {k: kw[k] for k in ("wup_sc", "wdn_sc", "wg_sc") if k in kw}
    if cfg.expert_quant is not None:
        check(bool(scales) and w_up.element_size() == 1,
              f"fused_ep {tag}: the layer hands B5q its payloads")
    other = "stream" if kw["schedule"] in ("batched", "rowwin") else "batched"
    okw = dict(kw, schedule=other)
    got = fused.fused_shard_cuda(*fi.args, **kw)
    alt = fused.fused_shard_cuda(*fi.args, **okw)
    want = fused.fused_shard_plain(*fi.args, **kw)
    torch.cuda.synchronize()
    d, _, nlx, c, h = x_send.shape
    i = w_down.shape[1]
    if "recv_pos" not in kw:
        live = torch.arange(c, device=x.device) < send_cnt[..., None]
        got, alt, want = got[live], alt[live], want[live]
    check(bool(torch.isfinite(got).all()), f"fused_ep {tag}: finite")
    err, nerr = max_abs(got, want), normwise(got, want)
    check(nerr <= BF16_NORMWISE_TOL, f"fused_ep {tag}: normwise err {nerr}")
    alt_err = normwise(alt, want)
    check(alt_err <= BF16_NORMWISE_TOL,
          f"fused_ep {tag} {other}: normwise err {alt_err}")
    dt = x_send.dtype
    act = reference.activation_fn(cfg.hidden_act)
    wsc = {"w_up": scales.get("wup_sc"), "w_down": scales.get("wdn_sc"),
           "w_gate": scales.get("wg_sc")}
    weights = {"w_up": w_up, "w_down": w_down, "w_gate": w_gate}

    def compute_weights():
        """The weights in dt: as they are, or the payloads dequantized
        (torch.mul into dt)."""
        return {k: w if wsc[k] is None else
                quant.dequantize_channelwise(w, wsc[k], dt)
                for k, w in weights.items() if w is not None}

    same = ""
    if not scales and "recv_pos" not in kw:
        ref = b2_rows(fi.args, kw)[live]
        check(torch.equal(got, ref) and torch.equal(alt, ref),
              f"fused_ep {tag}: rows differ from B2's on the same rows")
        same = " equal_to_b2_rows=True"
        del ref
    if scales:
        deq = {k: quant.dequantize_channelwise(w, wsc[k], dt)
               for k, w in weights.items() if w is not None}
        dkw = {k: v for k, v in kw.items() if k not in scales}
        ref = fused.fused_shard_cuda(send_cnt, None, x_send, deq["w_up"],
                                     b_up, deq["w_down"], b_down,
                                     deq.get("w_gate"), **dkw)
        got_q = fused.fused_shard_cuda(*fi.args, **kw)
        torch.cuda.synchronize()
        if "recv_pos" not in kw:
            ref, got_q = ref[live], got_q[live]
        check(torch.equal(got_q, ref), f"fused_ep {tag}: B5q differs from "
              f"the kernel on the weights dequantized beforehand")
        same = " equal_to_kernel_on_dequantized_weights=True"
        del deq, ref, got_q

    def library():
        w = compute_weights()
        x_recv = x_send.transpose(0, 1).contiguous()  # [owner, src, ...]
        y = torch.empty_like(x_recv)
        for r in range(d):
            for e in range(nlx):
                g = r * nlx + e
                xe = x_recv[r, :, e].reshape(d * c, h)
                u = torch.addmm(b_up[g].to(dt), xe, w["w_up"][g])
                hid = (act(xe @ w["w_gate"][g]) * u if cfg.gated_ffn
                       else act(u))
                y[r, :, e] = torch.addmm(b_down[g].to(dt), hid,
                                         w["w_down"][g]).reshape(d, c, h)
        return y.transpose(0, 1).contiguous()

    rows = int(send_cnt.sum())
    touched = int((send_cnt.sum(0) > 0).sum())  # (owner, expert) pairs
    n_mats = 3 if cfg.gated_ffn else 2
    w_bytes = w_up.element_size()
    # f32 scales, one per output channel of each weight
    sc_bytes = 4 * ((n_mats - 1) * i + h) if scales else 0
    name = ("fused_ep" if cfg.expert_quant is None else
            f"fused_ep_{quant.canonical_name(cfg.expert_quant)}")
    entry = dict(
        name=name, route="cuda",
        source="flashmoe_tpu_torch/csrc/fused_ep.cu",
        replaces=("flashmoe_tpu/parallel/fused.py:115" if not scales else
                  "flashmoe_tpu/parallel/fused.py:638"), max_abs_err=err,
        ms=cuda_ms(lambda: fused.fused_shard_cuda(*fi.args, **kw), iters),
        plain_ms=cuda_ms(lambda: fused.fused_shard_plain(*fi.args, **kw),
                         1),
        library_ms=cuda_ms(library, iters),
        **bound(bytes_=2 * rows * h * dt.itemsize + 4 * d * d * nlx
                + touched * (n_mats * h * i * w_bytes + 4 * (i + h)
                             + sc_bytes),
                flops=2 * rows * h * i * n_mats))
    other_ms = cuda_ms(lambda: fused.fused_shard_cuda(*fi.args, **okw),
                       iters)
    store = (f" store={quant.canonical_name(cfg.expert_quant)} "
             f"(1-byte payloads, f32 scales)" if scales else "")
    print(f"fused_ep {tag}: D={d} nLx={nlx} C={c} H={h} I={i} {dt}{store} "
          f"gated={cfg.gated_ffn} schedule={kw['schedule']} "
          f"combine={'recv_pos' in kw} live_rows={rows}: normwise_err="
          f"{nerr:.3g} (tol {BF16_NORMWISE_TOL}) max_abs_err={err:.3g} "
          f"{other}_normwise_err={alt_err:.3g}{same} "
          f"ms={entry['ms']:.4f} {other}_ms={other_ms:.4f} "
          f"plain_ms={entry['plain_ms']:.4f} "
          f"library_ms={entry['library_ms']:.4f} bound_ms="
          f"{entry['bound_ms']:.4f} ({entry['bound_by']}) ({gpu_line()})")
    return entry


def ep_layer_phase(tag, cfg, params, x, iters):
    """One MoE layer over 8 virtual ranks of a local mesh: the fused
    layer (B5; counts reset before, read after) against its plain
    version, the collective layer (B2 on each rank), the in-kernel
    combine against the layer's, and, dropless, the single-device layer:
    the same routing, so the same tokens meet the same experts.  Timed on
    CUDA events; one fused and one collective layer profiled."""
    m = mesh.local_mesh(cfg.ep, "cuda")
    fcfg = cfg.replace(moe_backend="fused")
    rk = gate.router_cuda(x, params["gate_w"], cfg)
    rp = gate.router_plain(x, params["gate_w"], cfg)
    flips = routing_flips(rk.expert_idx, rp.expert_idx, torch.softmax(
        reference.dot_f32(x, params["gate_w"]), -1))
    fused_row = fused_kernel_row(tag, fcfg, params, x, m, iters)
    reset_counts()
    got = fused.fused_ep_moe_layer(params, x, fcfg, m)
    torch.cuda.synchronize()
    counts = launch_counts()
    check(counts["fused_ep"] == 1 and counts["grouped_ffn"] == 0
          and counts["gate"] == cfg.ep, f"{tag} fused launches {counts}")
    plain = fused.fused_ep_moe_layer(params, x, fcfg, m, use_kernels=False)
    layer_agreement(f"{tag} fused vs plain", got.out, plain.out, flips)
    reset_counts()
    coll = ep.ep_moe_layer(params, x, cfg, m)
    torch.cuda.synchronize()
    counts = launch_counts()
    check(counts["grouped_ffn"] == cfg.ep and counts["fused_ep"] == 0,
          f"{tag} collective launches {counts}")
    layer_agreement(f"{tag} fused vs collective", got.out, coll.out, 0)
    check(torch.equal(got.expert_counts, coll.expert_counts),
          f"{tag}: expert counts")
    os.environ["FLASHMOE_FUSED_COMBINE"] = "1"
    try:
        comb = fused.fused_ep_moe_layer(params, x, fcfg, m)
        layer_agreement(f"{tag} in-kernel combine vs layer combine",
                        comb.out, got.out, 0)
        comb_ms = cuda_ms(lambda: fused.fused_ep_moe_layer(params, x, fcfg,
                                                            m), iters)
    finally:
        del os.environ["FLASHMOE_FUSED_COMBINE"]
    times = dict(fused=cuda_ms(lambda: fused.fused_ep_moe_layer(
        params, x, fcfg, m), iters), fused_combine=comb_ms,
        collective=cuda_ms(lambda: ep.ep_moe_layer(params, x, cfg, m),
                           iters))
    if not cfg.drop_tokens:
        single = moe.moe_layer(params, x, cfg.replace(ep=1))
        layer_agreement(f"{tag} fused vs single-device moe_layer", got.out,
                        single.out, 0)
        times["single_device"] = cuda_ms(lambda: moe.moe_layer(
            params, x, cfg.replace(ep=1)), iters)
    print(f"{tag}: E={cfg.num_experts} K={cfg.expert_top_k} "
          f"H={cfg.hidden_size} I={cfg.intermediate_size} S={x.shape[0]} "
          f"ep={cfg.ep} capacity={ep.local_capacity(cfg, x.shape[0] // cfg.ep)}"
          f" layer_ms " + " ".join(f"{k}={v:.4f}" for k, v in times.items())
          + f" routing_flips={flips} ({gpu_line()})")
    device_breakdown(f"{tag} fused layer",
                     lambda: fused.fused_ep_moe_layer(params, x, fcfg, m))
    device_breakdown(f"{tag} collective layer",
                     lambda: ep.ep_moe_layer(params, x, cfg, m))
    return fused_row, times, got


def ep_forward_phase(cfg, params):
    """The ep path: ``forward`` at Mixtral widths over 8 virtual ranks,
    4 x 256 tokens, with the fused backend (counts reset before, read
    after) and the collective one, each against the one-device forward
    within the serve phase's tolerances."""
    g = torch.Generator(device="cuda").manual_seed(3)
    b = 4
    tokens = torch.randint(0, cfg.vocab_size, (b, 256), device="cuda",
                           generator=g)
    with RoutingLog() as one:
        want, _ = transformer.forward(params, tokens, cfg)
    m = mesh.local_mesh(8, "cuda")
    out = {}
    for backend in ("fused", "collective"):
        ecfg = cfg.replace(ep=8, moe_backend=backend)
        reset_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        got, _ = transformer.forward(params, tokens, ecfg, mesh=m)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        counts = launch_counts()
        with RoutingLog() as rl:
            again, _ = transformer.forward(params, tokens, ecfg, mesh=m)
        check(torch.equal(again, got), f"ep forward {backend}: repeatable")
        n = cfg.num_layers
        fused_on = backend == "fused"
        check(counts["fused_ep"] == (n if fused_on else 0)
              and counts["grouped_ffn"] == (0 if fused_on else 8 * n)
              and counts["gate"] == 8 * n and counts["flash_attention"] == n,
              f"ep forward {backend} launches {counts}")
        if cfg.expert_quant is not None:
            # every fused layer streams the payloads through B5q
            arm = f"fused_ep_{quant.canonical_name(cfg.expert_quant)}"
            check(counts[arm] == (n if fused_on else 0),
                  f"ep forward {backend}: {counts[arm]} launches of {arm}")
        rows = (torch.linalg.vector_norm(got - want, dim=-1)
                / torch.linalg.vector_norm(want, dim=-1))
        # a near-tie routing flip between the two forwards moves the
        # logits of its position and of the later ones of its sequence
        excused, n_flips, gap, gap_first = serve_flips(cfg, rl, one, b,
                                                       ranks=8)
        held = rows[~excused]
        med = float(rows.median())
        worst = float(held.max()) if held.numel() else 0.0
        check(bool(torch.isfinite(got).all()) and got.shape == want.shape,
              f"ep forward {backend}: finite logits of {tuple(want.shape)}")
        check(med <= SERVE_MEDIAN_TOL and worst <= SERVE_ROW_TOL
              and gap <= SERVE_NEAR_TIE,
              f"ep forward {backend} vs ep 1: median {med}, max without "
              f"a flip {worst}, largest flip gap {gap}")
        print(f"ep forward {backend}: mixtral_8x7b layers={n} B={b} T=256 "
              f"ep=8 (local mesh) store={cfg.expert_quant or 'bf16'} "
              f"forward_ms={ms:.3f} logits vs ep 1: "
              f"median_normwise={med:.3g} (tol {SERVE_MEDIAN_TOL}) "
              f"max_normwise={float(rows.max()):.3g} "
              f"max_normwise_without_flip={worst:.3g} (tol {SERVE_ROW_TOL}) "
              f"rows_after_a_flip={int(excused.sum())}/{rows.numel()} "
              f"routing_flips={n_flips} largest_flip_gap={gap:.3g} (tol "
              f"{SERVE_NEAR_TIE}, first-order flips {gap_first:.3g}) "
              f"launches={counts}")
        out[backend] = counts
    return out["fused"]


def ep_phase(cfg, params):
    """Expert parallelism over 8 virtual ranks on the card: the ep path
    (``forward`` with a mesh), B5 at the shapes it gives the kernel, one
    Mixtral-width MoE layer at 8192 tokens and the FlashMoE reference
    layer.  Returns (B5's kernels-line entry, the ep path's launches)."""
    launches = ep_forward_phase(cfg, params)
    g = torch.Generator(device="cuda").manual_seed(4)
    moe0 = params["layers"][0]["moe"]
    x = torch.randn(1024, cfg.hidden_size, device="cuda", generator=g,
                    dtype=torch.bfloat16)
    entry = fused_kernel_row("ep forward shapes",
                             cfg.replace(ep=8, moe_backend="fused"), moe0, x,
                             mesh.local_mesh(8, "cuda"), 10)
    x = torch.randn(8192, cfg.hidden_size, device="cuda", generator=g,
                    dtype=torch.bfloat16)
    ep_layer_phase("ep mixtral layer", cfg.replace(ep=8), moe0, x, 3)
    del x
    rcfg = presets.flashmoe_reference(param_dtype=torch.bfloat16, ep=8)
    rparams = reference.init_moe_params(g, rcfg, device="cuda")
    rx = torch.randn(rcfg.tokens, rcfg.hidden_size, device="cuda",
                     generator=g, dtype=torch.bfloat16)
    ep_layer_phase("ep reference layer", rcfg, rparams, rx, 5)
    del rparams, rx
    torch.cuda.empty_cache()
    return entry, launches


# ----------------------------------------------------------------------
# quantized expert storage
# ----------------------------------------------------------------------

def quantized_model(cfg, seed):
    """Random weights of ``cfg``'s transformer with its experts in the
    ``cfg.expert_quant`` store, made layer by layer: one layer's random
    bf16 weights (init_params' distributions), its experts quantized, the
    bf16 experts freed, so that the bf16 model never exists at once."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    one = cfg.replace(num_layers=1)
    params = None
    for _ in range(cfg.num_layers):
        p = transformer.init_params(g, one, device="cuda")
        layer = p["layers"][0]
        layer["moe"] = quant.quantize_ffn_params(layer["moe"],
                                                 cfg.expert_quant)
        if params is None:
            params = p
        else:
            params["layers"].append(layer)
        del p, layer
    torch.cuda.empty_cache()
    return params


def store_bytes(params) -> tuple[int, int, int]:
    """(payload bytes, scale bytes, bytes of every other leaf) of a tree."""
    pay = sc = rest = 0
    for layer in params["layers"]:
        for k, t in layer["moe"].items():
            n = t.numel() * t.element_size()
            if k.endswith(quant.SCALE_SUFFIX):
                sc += n
            elif k in quant.QUANT_WEIGHT_KEYS:
                pay += n
            else:
                rest += n
        rest += sum(t.numel() * t.element_size() for k, t in layer.items()
                    if k != "moe")
    rest += sum(params[k].numel() * params[k].element_size()
                for k in ("embed", "final_norm", "lm_head"))
    return pay, sc, rest


def quant_f32_case(qname):
    """B5q on a small f32 shard (4 ranks, 2 experts each, capacity 96,
    SwiGLU) against its plain version at populated rows, elementwise at
    F32_TOL: the kernel's dequantized tiles are f32 as the plain
    version's weights."""
    g = torch.Generator(device="cuda").manual_seed(21)
    d, nlx, cap, h, i = 4, 2, 96, 128, 192
    dev = dict(device="cuda", generator=g)
    x_send = torch.randn(d, d, nlx, cap, h, **dev)
    cnt = torch.randint(0, cap + 1, (d, d, nlx), **dev)
    w = {k: torch.randn(*shape, **dev) / shape[-2] ** 0.5
         for k, shape in (("w_up", (d * nlx, h, i)),
                          ("w_gate", (d * nlx, h, i)),
                          ("w_down", (d * nlx, i, h)))}
    q = {k: quant.quantize_channelwise(v, qname) for k, v in w.items()}
    args = (cnt, None, x_send, q["w_up"][0], torch.randn(d * nlx, i, **dev),
            q["w_down"][0], torch.randn(d * nlx, h, **dev), q["w_gate"][0])
    kw = dict(act_name="silu", gated=True, schedule="rowwin",
              wup_sc=q["w_up"][1], wdn_sc=q["w_down"][1],
              wg_sc=q["w_gate"][1])
    got = fused.fused_shard_cuda(*args, **kw)
    want = fused.fused_shard_plain(*args, **kw)
    torch.cuda.synchronize()
    live = torch.arange(cap, device="cuda") < cnt[..., None]
    err = check_f32(f"fused_ep_{qname} f32", got[live], want[live])
    print(f"fused_ep_{qname} f32: D={d} nLx={nlx} C={cap} H={h} I={i} "
          f"gated rowwin: max_abs_err={err:.3g} (rtol = atol = {F32_TOL})")


def quant_serve_phase(cfg, params, tag):
    """Serving on a quantized expert store: ``generate`` (4 prompts of 256
    tokens, 16 greedy tokens) with serve_run's checks (first-order flips
    held to the near-tie gap: 32 layers deep, flips cascade), a device-time
    breakdown of a prefill and a decode step, the boundary
    dequantization's share of both, and every MoE layer of the prefill
    and of the decode steps against ``reference_moe`` on its dequantized
    weights."""
    g = torch.Generator(device="cuda").manual_seed(22)
    b, t0, new = 4, 256, 16
    prompt = torch.randint(0, cfg.vocab_size, (b, t0), device="cuda",
                           generator=g)
    torch.cuda.reset_peak_memory_stats()
    tokens, launches, _ = serve_run(tag, cfg, params, prompt, new,
                                    first_order=True)
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(not any(launches[k] for k in (*EP_KERNELS, *QUANT_KERNELS)),
          f"{tag}: the fused kernel ran on one device: {launches}")
    print(f"{tag}: peak_memory_GB={peak:.2f} (generate, its replay and "
          f"forward over the sequence) ({gpu_line()})")
    dev = profile_breakdown(cfg, params, prompt, tokens, tag)
    # the boundary dequantization of one layer's experts, as moe_layer
    # runs it at every step
    moe0 = params["layers"][0]["moe"]
    deq_ms = cuda_ms(lambda: quant.ffn_compute_params(moe0, cfg,
                                                      out_dtype=cfg.dtype), 5)
    n = len(cfg.moe_layer_indices)
    share = " ".join(
        f"{k}_share={deq_ms * n / v:.3f}" if v else f"{k}_share=not measured"
        for k, v in zip(("prefill", "decode_step"), dev))
    print(f"{tag}: boundary dequant of one layer's experts "
          f"dequant_layer_ms={deq_ms:.4f} (CUDA events), x{n} layers = "
          f"{deq_ms * n:.3f} ms a step; of the profiled device time: "
          f"{share} ({gpu_line()})")
    embed = params["embed"].to(cfg.dtype)
    x = embed[prompt]
    off = cfg.replace(expert_quant=None)
    for li, layer in enumerate(params["layers"]):
        x = x + transformer.attention(
            layer, transformer.rms_norm(x, layer["attn_norm"]), cfg)
        f_in = transformer.rms_norm(x, layer["ffn_norm"]).reshape(b * t0, -1)
        got = moe.moe_layer(layer["moe"], f_in, cfg)
        deq = quant.dequantize_state(layer["moe"], cfg.dtype)
        want, _ = reference.reference_moe(deq, f_in, off)
        rk = gate.router_cuda(f_in, deq["gate_w"], off)
        _, top_idx, probs, _ = reference.reference_gate(f_in, deq["gate_w"],
                                                        off)
        flips = routing_flips(rk.expert_idx, top_idx, probs)
        layer_agreement(f"{tag}: prefill layer {li} vs reference_moe on "
                        f"the dequantized weights", got.out, want, flips)
        x = x + got.out.reshape(x.shape)
        del deq, want, got
    decode_layer_check(tag, cfg, params, prompt, tokens)
    return launches


def decode_layer_check(tag, cfg, params, prompt, tokens):
    """Every MoE layer of the decode steps of ``tokens``' greedy run, on
    the inputs it had there, against ``reference_moe`` on its dequantized
    weights, as ``layer_agreement`` holds a prefill layer: the decode
    steps' check that does not go through the step logits (at depth most
    rows follow a routing flip and are excused there).  The steps are
    replayed with ``transformer.moe_layer`` recorded; a layer's inputs of
    all steps are held at once (the layer is dropless)."""
    b, t0 = prompt.shape
    new = tokens.shape[1] - t0
    real, calls = transformer.moe_layer, []

    def recorded(p, x, c, use_kernels=None):
        out = real(p, x, c, use_kernels=use_kernels)
        calls.append((x, out.out))
        return out

    cache = generate.init_cache(cfg, b, t0 + new, "cuda")
    embed = params["embed"].to(cfg.dtype)
    _, cache = generate.prefill_batched(params, cfg, prompt, cache)
    transformer.moe_layer = recorded
    try:
        for i in range(new - 1):
            _, cache = generate._decode_step(
                params, cfg, embed[tokens[:, t0 + i]][:, None, :], cache,
                t0 + i)
    finally:
        transformer.moe_layer = real
    n = cfg.num_layers
    check(len(calls) == n * (new - 1),
          f"{tag}: {len(calls)} FFN calls in {new - 1} decode steps")
    off = cfg.replace(expert_quant=None)
    worst, n_flips, n_off = 0.0, 0, 0
    for li in cfg.moe_layer_indices:
        x = torch.cat([c[0] for c in calls[li::n]])
        got = torch.cat([c[1] for c in calls[li::n]])
        deq = quant.dequantize_state(params["layers"][li]["moe"], cfg.dtype)
        want, _ = reference.reference_moe(deq, x, off)
        rk = gate.router_cuda(x, deq["gate_w"], off)
        _, top_idx, probs, _ = reference.reference_gate(x, deq["gate_w"],
                                                        off)
        flips = routing_flips(rk.expert_idx, top_idx, probs)
        nerr, bad = layer_agreement(
            f"{tag}: decode layer {li} vs reference_moe on the dequantized "
            f"weights", got, want, flips, verbose=False)
        worst = max(worst, nerr) if flips == 0 else worst
        n_flips += flips
        n_off += bad
        del deq, want
    print(f"{tag}: {len(cfg.moe_layer_indices)} MoE layers x {new - 1} "
          f"decode steps x {b} tokens vs reference_moe on the dequantized "
          f"weights: max_normwise_err={worst:.3g} over the layers without "
          f"a flip (tol {BF16_NORMWISE_TOL}) routing_flips={n_flips} "
          f"tokens_off={n_off}")


def quant_layer_phase(cfg, moe_q, g):
    """One Mixtral-width int8 MoE layer at 8192 tokens over 8 virtual
    ranks (ep_layer_phase: the fused layer on B5q against its plain
    version, the collective and single-device layers, the in-kernel
    combine), then the bf16 fused layer on the same weights dequantized,
    timed beside it."""
    x = torch.randn(8192, cfg.hidden_size, device="cuda", generator=g,
                    dtype=torch.bfloat16)
    qname = quant.canonical_name(cfg.expert_quant)
    _, times, got = ep_layer_phase(f"ep mixtral {qname} layer",
                                   cfg.replace(ep=8), moe_q, x, 3)
    deq = quant.dequantize_state(moe_q, cfg.dtype)
    bcfg = cfg.replace(ep=8, moe_backend="fused", expert_quant=None)
    m = mesh.local_mesh(8, "cuda")
    bf = fused.fused_ep_moe_layer(deq, x, bcfg, m)
    layer_agreement(f"ep mixtral {qname} fused layer vs bf16 fused layer on "
                    f"its dequantized weights", got.out, bf.out, 0)
    bf_ms = cuda_ms(lambda: fused.fused_ep_moe_layer(deq, x, bcfg, m), 3)
    print(f"ep mixtral {qname} layer: S=8192 ep=8 fused_{qname}_ms="
          f"{times['fused']:.4f} (B5q, rowwin) fused_bf16_ms={bf_ms:.4f} "
          f"(the same weights dequantized, schedule "
          f"{fused.schedule_table(bcfg, 8)['schedule']}) ({gpu_line()})")
    del deq, bf, got, x
    torch.cuda.empty_cache()


def quant_phase():
    """Quantized expert storage on the card.  int8: Mixtral-8x7B at its
    published widths and all 32 layers, the experts stored as int8 (made
    layer by layer), served as the serve phase does; then, on 4 of its
    layers, the ep path over 8 virtual ranks (fused: B5q, counts reset
    before and read after; collective), B5q at that path's shapes and a
    layer at 8192 tokens.  e4m3: 4 layers, served, then the same ep path
    and B5q row.  Returns (B5q's kernels-line entries, the ep paths'
    launches)."""
    entries, launches = [], {}
    for qname, layers in (("int8", 32), ("e4m3", 4)):
        cfg = presets.mixtral_8x7b(num_layers=layers,
                                   param_dtype=torch.bfloat16,
                                   expert_quant=qname,
                                   fused_schedule="rowwin")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        params = quantized_model(cfg, 30 + layers)
        build_s = time.perf_counter() - t
        pay, sc, rest = store_bytes(params)
        meta = quant.quant_metadata(params)
        check(quant.verify_quant_metadata(meta) and meta["dtype"] == qname,
              f"quant {qname}: metadata {meta}")
        print(f"quant {qname}: mixtral_8x7b layers={layers} expert store "
              f"payload_GB={pay / 1e9:.3f} scales_GB={sc / 1e9:.4f} (a bf16 "
              f"store: {2 * pay / 1e9:.3f} GB) other_bf16_weights_GB="
              f"{rest / 1e9:.3f} total_GB={(pay + sc + rest) / 1e9:.3f} "
              f"build_s={build_s:.2f} peak_memory_GB_building="
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} "
              f"quant_bytes_saved_vs_bf16_GB="
              f"{quant.quant_bytes_saved(params, torch.bfloat16) / 1e9:.3f} "
              f"meta={json.dumps(meta, sort_keys=True)} ({gpu_line()})")
        quant_serve_phase(cfg, params, f"serve {qname}")
        if layers > 4:
            params["layers"] = params["layers"][:4]
            cfg = cfg.replace(num_layers=4)
            torch.cuda.empty_cache()
        counts = ep_forward_phase(cfg, params)
        launches[f"fused_ep_{qname}"] = counts[f"fused_ep_{qname}"]
        g = torch.Generator(device="cuda").manual_seed(23)
        moe0 = params["layers"][0]["moe"]
        x = torch.randn(1024, cfg.hidden_size, device="cuda", generator=g,
                        dtype=torch.bfloat16)
        entries.append(fused_kernel_row(
            f"{qname} ep forward shapes",
            cfg.replace(ep=8, moe_backend="fused"), moe0, x,
            mesh.local_mesh(8, "cuda"), 10))
        quant_f32_case(qname)
        if qname == "int8":
            quant_layer_phase(cfg, moe0, g)
        del params, moe0, x
        torch.cuda.empty_cache()
    return entries, launches


# ----------------------------------------------------------------------
# layer and model phases
# ----------------------------------------------------------------------

def layer_agreement(tag, got, want, flips, verbose=True):
    """Outputs of two routings of one layer: normwise within the bf16
    tolerance when the routing agreed everywhere; with near-tie flips,
    at most the flipped share of tokens (plus the capacity positions
    they shift) may disagree.  Returns (the normwise error, the tokens
    that disagree)."""
    per_tok = (torch.linalg.vector_norm((got - want).float(), dim=-1)
               / torch.linalg.vector_norm(want.float(), dim=-1)
               .clamp_min(1e-30))
    bad = int((per_tok > 4 * BF16_NORMWISE_TOL).sum())
    nerr = normwise(got, want)
    check(bool(torch.isfinite(got).all()), f"{tag}: finite")
    if flips == 0:
        check(nerr <= BF16_NORMWISE_TOL, f"{tag}: normwise err {nerr}")
    else:
        check(bad <= 0.02 * got.shape[0],
              f"{tag}: {bad} tokens disagree after {flips} routing flips")
    if verbose:
        print(f"{tag}: normwise_err={nerr:.3g} (tol {BF16_NORMWISE_TOL}) "
              f"tokens_off={bad} routing_flips={flips}")
    return nerr, bad


def reset_counts():
    for fn in kernel_fns().values():
        fn.launches = 0
    expert.grouped_matmul_cuda.hopper_launches = 0
    for k in fused.fused_shard_cuda.store_launches:
        fused.fused_shard_cuda.store_launches[k] = 0


SERVE_KERNELS = ("gate", "grouped_ffn", "flash_attention")
TRAIN_KERNELS = ("grouped_ffn_res", "grouped_matmul", "tgmm")
MANY_EXPERT_KERNELS = ("gate_pass1", "gate_pass2", "grouped_ffn_tokens")
EP_KERNELS = ("fused_ep",)
# B5q: the fused kernel's quantized arm, counted by store
QUANT_KERNELS = ("fused_ep_int8", "fused_ep_e4m3")


def kernel_fns():
    return {"gate": gate.router_cuda,
            "grouped_ffn": expert.grouped_ffn_cuda,
            "flash_attention": attention.flash_attention_cuda,
            "grouped_ffn_res": expert.grouped_ffn_res_cuda,
            "grouped_matmul": expert.grouped_matmul_cuda,
            "tgmm": expert.tgmm_cuda,
            "gate_pass1": gate.gate_pass1_cuda,
            "gate_pass2": gate.gate_pass2_cuda,
            "grouped_ffn_tokens": expert.grouped_ffn_tokens_cuda,
            "fused_ep": fused.fused_shard_cuda}


def launch_counts():
    """Launches of each kernel wrapper since the last reset; the fused
    kernel's (all arms) also by quantized store."""
    out = {k: f.launches for k, f in kernel_fns().items()}
    by_store = fused.fused_shard_cuda.store_launches
    out.update({f"fused_ep_{q}": by_store[q] for q in ("int8", "e4m3")})
    return out


def capacity_phase():
    cfg = presets.flashmoe_reference(param_dtype=torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(1)
    params = reference.init_moe_params(g, cfg, device="cuda")
    x = torch.randn(cfg.tokens, cfg.hidden_size, device="cuda",
                    generator=g, dtype=torch.bfloat16)
    reset_counts()
    out = moe.moe_layer(params, x, cfg)
    torch.cuda.synchronize()
    counts = launch_counts()
    check(counts["gate"] > 0 and counts["grouped_ffn"] > 0,
          f"capacity arm launches {counts}")
    plain = moe.moe_layer(params, x, cfg, use_kernels=False)
    rk = gate.router_cuda(x, params["gate_w"], cfg)
    rp = gate.router_plain(x, params["gate_w"], cfg)
    flips = routing_flips(rk.expert_idx, rp.expert_idx,
                          torch.softmax(reference.dot_f32(x, params["gate_w"]), -1))
    print(f"capacity arm: flashmoe_reference E={cfg.num_experts} "
          f"K={cfg.expert_top_k} H={cfg.hidden_size} "
          f"I={cfg.intermediate_size} S={cfg.tokens} "
          f"capacity={cfg.capacity_for(cfg.tokens)} launches={counts}")
    layer_agreement("capacity arm vs plain", out.out, plain.out, flips)
    ms = cuda_ms(lambda: moe.moe_layer(params, x, cfg), 5)
    print(f"capacity arm layer_ms={ms:.4f}")

    # the same layer at inference through the gather-fused FFN (B3)
    gcfg = cfg.replace(gather_fused=True)
    reset_counts()
    gout = moe.moe_layer(params, x, gcfg)
    torch.cuda.synchronize()
    counts = launch_counts()
    check(counts["grouped_ffn_tokens"] > 0 and counts["grouped_ffn"] == 0,
          f"capacity gather arm launches {counts}")
    gplain = moe.moe_layer(params, x, gcfg, use_kernels=False)
    layer_agreement("capacity gather arm vs plain", gout.out, gplain.out,
                    flips)
    layer_agreement("capacity gather arm vs explicit dispatch", gout.out,
                    out.out, 0)
    print(f"capacity gather arm: max_abs_diff_from_explicit="
          f"{max_abs(gout.out, out.out):.3g} layer_ms="
          f"{cuda_ms(lambda: moe.moe_layer(params, x, gcfg), 5):.4f} "
          f"launches={counts}")

    # the backward: residual-saving forward, grouped matmul, tgmm (E=64)
    layer_backward("capacity arm backward", cfg, params, x, ("gate",))
    del params


def layer_backward(tag, cfg, params, x, gate_kernels):
    """Gradients of ``sum(out**2) + aux`` of one MoE layer through the
    kernels (the gate's and B6, B7, B8) against a plain run that replays
    the kernel run's routing (a near-tie flip moves a token's whole
    contribution, so the plain run's own choices are only counted), every
    leaf within GRAD_NORMWISE_TOL."""
    def layer_grads(use_kernels):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        xx = x.detach().requires_grad_(True)
        o = moe.moe_layer(leaves, xx, cfg, use_kernels=use_kernels)
        loss = (o.out.float() ** 2).sum() + o.aux_loss
        return dict(zip(["x", *leaves],
                        torch.autograd.grad(loss, [xx, *leaves.values()])))

    reset_counts()
    with RoutingLog() as rk:
        got = layer_grads(None)
    torch.cuda.synchronize()
    counts = launch_counts()
    check(all(counts[k] > 0 for k in (*gate_kernels, *TRAIN_KERNELS)),
          f"{tag} launches {counts}")
    with ReplayRouting(rk.calls, cfg.expert_top_k, forward_calls=1) as rp:
        want = layer_grads(False)
    check(rp.n == len(rk.calls) == 1,
          f"{tag}: {len(rk.calls)} router calls with the kernels, {rp.n} "
          f"replayed")
    check(rp.gap <= NEAR_TIE and rp.flips <= MAX_FLIP_SHARE * x.shape[0] + 1,
          f"{tag}: {rp.flips} routing flips, largest gap {rp.gap} (near tie "
          f"{NEAR_TIE})")
    errs = grad_agreement(tag, got, want)
    print(f"{tag}: d(sum(out**2) + aux) per leaf vs plain with the kernel "
          f"run's routing replayed: "
          + " ".join(f"{k}={v:.3g}" for k, v in errs.items())
          + f" (normwise tol {GRAD_NORMWISE_TOL}); plain routing would have "
          f"flipped {rp.flips} tokens, largest gap {rp.gap:.3g} (tol "
          f"{NEAR_TIE}) launches={counts}")


def many_expert_cfg(**kw):
    """One MoE layer at Qwen3-Next-80B-A3B's MoE widths
    (Qwen/Qwen3-Next-80B-A3B-Instruct config.json: num_experts 512,
    num_experts_per_tok 10, hidden_size 2048, moe_intermediate_size 512,
    shared_expert_intermediate_size 512, SiLU gated, norm_topk_prob), as
    the FlashMoE reference layer is run: 8192 tokens, dropless, bf16."""
    base = dict(num_experts=512, expert_top_k=10, hidden_size=2048,
                intermediate_size=512, num_shared_experts=1, gated_ffn=True,
                hidden_act="silu", drop_tokens=False, sequence_len=8192,
                dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    base.update(kw)
    return config.MoEConfig(**base)


# the many-expert layer against the dense oracle on its first tokens: the
# oracle evaluates all 512 experts on every token it is given (in f32)
ORACLE_TOKENS = 128


def many_expert_phase():
    """The many-expert layer at inference with the gather-fused FFN off,
    on, and on with collect_stats (the two-pass gate with pass 2 each
    time: JAX's single-tile gate would compute the statistics here), each
    against the plain versions and the dense oracle, the three against
    each other, the stats against the plain run's; then training, forward
    and backward.  Returns the launches of the gather-fused inference."""
    cfg = many_expert_cfg()
    g = torch.Generator(device="cuda").manual_seed(15)
    params = reference.init_moe_params(g, cfg, device="cuda")
    x = torch.randn(cfg.tokens, cfg.hidden_size, device="cuda", generator=g,
                    dtype=torch.bfloat16)
    n_bytes = sum(t.numel() * t.element_size() for t in params.values())
    print(f"many_expert layer: E={cfg.num_experts} K={cfg.expert_top_k} "
          f"H={cfg.hidden_size} I={cfg.intermediate_size} shared=1 "
          f"S={cfg.tokens} bf16: weights_GB={n_bytes / 1e9:.3f}")
    rk = gate.router_tiled_cuda(x, params["gate_w"], cfg, True)
    rp = gate.router_tiled_plain(x, params["gate_w"], cfg, True)
    flips = routing_flips(rk.expert_idx, rp.expert_idx, torch.softmax(
        reference.dot_f32(x, params["gate_w"]), -1))
    xo = x[:ORACLE_TOKENS]
    oracle, _ = reference.reference_moe(params, xo, cfg)
    _, oracle_idx, oracle_probs, _ = reference.reference_gate(
        xo, params["gate_w"], cfg)
    oracle_flips = routing_flips(rk.expert_idx[:ORACLE_TOKENS], oracle_idx,
                                 oracle_probs)
    outs, launches = {}, None
    for tag, kw in (("gather_off", dict(gather_fused=False)),
                    ("gather_on", dict(gather_fused=True)),
                    ("gather_on_stats", dict(gather_fused=True,
                                             collect_stats=True))):
        lcfg = many_expert_cfg(**kw)
        reset_counts()
        out = moe.moe_layer(params, x, lcfg)
        torch.cuda.synchronize()
        counts = launch_counts()
        b3 = kw["gather_fused"]
        check(counts["gate_pass1"] == counts["gate_pass2"] == 1
              and counts["gate"] == 0
              and (counts["grouped_ffn_tokens"] > 0) == b3
              and (counts["grouped_ffn"] > 0) != b3,
              f"many_expert {tag} launches {counts}")
        if tag == "gather_on":
            launches = counts
        plain = moe.moe_layer(params, x, lcfg, use_kernels=False)
        layer_agreement(f"many_expert {tag} vs plain", out.out, plain.out,
                        flips)
        layer_agreement(f"many_expert {tag} vs reference_moe "
                        f"(first {ORACLE_TOKENS} tokens)",
                        out.out[:ORACLE_TOKENS], oracle, oracle_flips)
        ms = cuda_ms(lambda: moe.moe_layer(params, x, lcfg), 3)
        print(f"many_expert {tag}: layer_ms={ms:.4f} launches={counts} "
              f"({gpu_line()})")
        outs[tag] = (out, plain)
    for a, b in (("gather_off", "gather_on"), ("gather_on", "gather_on_stats")):
        d = max_abs(outs[a][0].out, outs[b][0].out)
        check(d <= BF16_NORMWISE_TOL * float(outs[a][0].out.abs().max()),
              f"many_expert {a} vs {b}: max abs diff {d}")
        print(f"many_expert {a} vs {b}: max_abs_diff={d:.3g}")
    stats, pstats = outs["gather_on_stats"][0].stats, \
        outs["gather_on_stats"][1].stats
    check(outs["gather_on"][0].stats is None and stats is not None,
          "many_expert: stats only with collect_stats")
    load_diff = float((stats.expert_load - pstats.expert_load).abs().sum())
    check(load_diff <= 2 * flips, f"many_expert stats: load differs from "
          f"plain by {load_diff} with {flips} flips")
    rel = {}
    for name in ("imbalance", "router_entropy", "topk_confidence"):
        a, b = float(getattr(stats, name)), float(getattr(pstats, name))
        rel[name] = abs(a - b) / abs(b)
        check(rel[name] <= 1e-3, f"many_expert stats {name}: {a} vs {b}")
    check(float(stats.dropped_fraction) == 0
          and float(stats.capacity_utilization) == 1,
          "many_expert stats: dropless")
    print(f"many_expert stats vs plain: load_abs_diff={load_diff:.0f} "
          + " ".join(f"{k}_rel_err={v:.3g}" for k, v in rel.items())
          + f" (tol 1e-3) router_entropy={float(stats.router_entropy):.5f} "
          f"imbalance={float(stats.imbalance):.4f} routing_flips={flips}")
    del outs, oracle
    device_breakdown(
        "many_expert gather_on",
        lambda: moe.moe_layer(params, x, many_expert_cfg(gather_fused=True)),
        top_n=8)
    layer_backward("many_expert training backward",
                   cfg.replace(is_training=True), params, x,
                   ("gate_pass1", "gate_pass2"))
    del params
    torch.cuda.empty_cache()
    return launches


def grad_agreement(tag, got, want) -> dict:
    """Gradients through the kernels against the plain versions' with the
    same routing, leaf by leaf: finite, and normwise within
    GRAD_NORMWISE_TOL."""
    errs = {}
    for k, a in got.items():
        check(a is not None and bool(torch.isfinite(a).all()),
              f"{tag}: gradient {k} finite")
        errs[k] = normwise(a, want[k])
        check(errs[k] <= GRAD_NORMWISE_TOL,
              f"{tag}: gradient {k} normwise {errs[k]}")
    return errs


def serve_run(tag, cfg, params, prompt, new, first_order=False):
    """One ``generate`` (the serving path: counts reset before, read
    after), then its greedy steps replayed with every layer's routing
    recorded, every step's logits held against ``forward`` over the whole
    sequence.  Every routing flip must be a near tie, or with
    ``first_order`` every flip that no earlier flip of its sequence (in
    an earlier layer or position) caused: at depth a flip changes the
    residual stream of its position and of the later ones in every later
    layer, so the flips that follow it are no near ties and prove
    nothing about the kernels (rows after a flip are excused either
    way).  Returns (tokens, launches, the replay's RoutingLog)."""
    b, t0 = prompt.shape
    reset_counts()
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    tokens = generate.generate(params, prompt, cfg, max_new_tokens=new)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t_start
    launches = launch_counts()
    ffn = "grouped_ffn_tokens" if cfg.gather_fused else "grouped_ffn"
    other = "grouped_ffn" if cfg.gather_fused else "grouped_ffn_tokens"
    check(all(launches[k] > 0 for k in ("gate", ffn, "flash_attention"))
          and not any(launches[k] for k in (*TRAIN_KERNELS, other,
                                            "gate_pass1", "gate_pass2")),
          f"{tag} path launches {launches}")
    check(tokens.shape == (b, t0 + new), f"tokens shape {tokens.shape}")
    check(launches["gate"] == len(cfg.moe_layer_indices) * new,
          f"{tag}: {launches['gate']} gate launches, want one a MoE layer "
          f"for the prefill and each of the {new - 1} decode steps")
    print(f"{tag}: mixtral_8x7b layers={cfg.num_layers} B={b} T0={t0} "
          f"new={new} gather_fused={bool(cfg.gather_fused)}: "
          f"generate_s={gen_s:.3f} launches={launches}")

    # replay the greedy steps, keeping each step's logits and every
    # layer's routing
    cache = generate.init_cache(cfg, b, t0 + new, "cuda")
    embed = params["embed"].to(cfg.dtype)
    with RoutingLog() as replay:
        logits, cache = generate.prefill_batched(params, cfg, prompt, cache)
        steps = [logits]
        for i in range(new - 1):
            tok = tokens[:, t0 + i]
            logits, cache = generate._decode_step(
                params, cfg, embed[tok][:, None, :], cache, t0 + i)
            steps.append(logits)
    step_logits = torch.stack(steps, 1)  # [B, new, V]
    check(bool(torch.isfinite(step_logits).all()), "step logits finite")
    check(torch.equal(step_logits.argmax(-1), tokens[:, t0:]),
          "generate's tokens are the argmax of the replayed logits")
    with RoutingLog() as fwd:
        full, _ = transformer.forward(params, tokens[:, :-1], cfg)
    want = full[:, t0 - 1:]
    rows = (torch.linalg.vector_norm(step_logits - want, dim=-1)
            / torch.linalg.vector_norm(want, dim=-1))
    excused, n_flips, gap, gap_first = serve_flips(cfg, replay, fwd, b)
    excused = excused[:, t0 - 1:]  # step j is computed at position t0-1+j
    held = rows[~excused]
    med, worst = float(rows.median()), float(rows.max())
    worst_held = float(held.max()) if held.numel() else 0.0
    far = float((rows > SERVE_ROW_TOL).float().mean())
    agree = float((step_logits.argmax(-1) == want.argmax(-1)).float().mean())
    print(f"{tag}: step logits vs forward over the full sequence: "
          f"median_normwise={med:.3g} (tol {SERVE_MEDIAN_TOL}) "
          f"max_normwise={worst:.3g} max_normwise_without_flip="
          f"{worst_held:.3g} (tol {SERVE_ROW_TOL}) rows_over_tol={far:.4f} "
          f"rows_after_a_flip={int(excused.sum())}/{rows.numel()} "
          f"routing_flips={n_flips} largest_flip_gap={gap:.3g} "
          f"(tol {SERVE_NEAR_TIE}, first-order flips {gap_first:.3g}) "
          f"argmax_agreement={agree:.3f}")
    check(med <= SERVE_MEDIAN_TOL,
          f"{tag} step logits vs forward: median normwise {med}")
    check(worst_held <= SERVE_ROW_TOL,
          f"{tag} step logits vs forward: a row with no routing flip before "
          f"it is {worst_held} normwise off")
    held_gap = gap_first if first_order else gap
    check(held_gap <= SERVE_NEAR_TIE,
          f"{tag}: a {'first-order ' if first_order else ''}routing flip "
          f"between generate and forward is no near-tie (probability gap "
          f"{held_gap})")
    return tokens, launches, replay


def serve_phase(cfg, params):
    g = torch.Generator(device="cuda").manual_seed(2)
    b, t0, new = 4, 256, 16
    prompt = torch.randint(0, cfg.vocab_size, (b, t0), device="cuda",
                           generator=g)
    tokens, launches, replay = serve_run("serve", cfg, params, prompt, new)
    gtokens, _, greplay = serve_run("serve gather_fused",
                                    cfg.replace(gather_fused=True), params,
                                    prompt, new)
    serve_gather_tokens(cfg, tokens, gtokens, replay, greplay, t0)

    profile_breakdown(cfg, params, prompt, tokens)
    embed = params["embed"].to(cfg.dtype)

    # every prefill MoE layer against the dense oracle, on its own input
    x = embed[prompt]
    for li, layer in enumerate(params["layers"]):
        x = x + transformer.attention(layer, transformer.rms_norm(x, layer["attn_norm"]), cfg)
        f_in = transformer.rms_norm(x, layer["ffn_norm"]).reshape(b * t0, -1)
        got = moe.moe_layer(layer["moe"], f_in, cfg)
        want, _ = reference.reference_moe(layer["moe"], f_in, cfg)
        rk = gate.router_cuda(f_in, layer["moe"]["gate_w"], cfg)
        _, top_idx, probs, _ = reference.reference_gate(
            f_in, layer["moe"]["gate_w"], cfg)
        flips = routing_flips(rk.expert_idx, top_idx, probs)
        layer_agreement(f"serve: prefill layer {li} vs reference_moe",
                        got.out, want, flips)
        x = x + got.out.reshape(x.shape)
    return launches


def train_phase():
    """Mixtral-8x7B widths, 2 layers, bf16 weights, AdamW.  At the initial
    weights: every gradient through the kernels against the plain
    versions', and one SGD step lowering the loss; then three train steps
    (the training path) and a device-time breakdown of one step."""
    cfg = presets.mixtral_8x7b(num_layers=2, param_dtype=torch.bfloat16,
                               is_training=True)
    g = torch.Generator(device="cuda").manual_seed(3)
    opt = trainer.make_optimizer(cfg, warmup_steps=1, total_steps=3)
    state = trainer.init_state(g, cfg, opt)
    tokens = torch.randint(0, cfg.vocab_size, (4, 257), device="cuda",
                           generator=g)
    batch = {"tokens": tokens}
    n_bytes = sum(t.numel() * t.element_size()
                  for t in tree_leaves((state.params, state.opt_state)))
    print(f"train: mixtral_8x7b layers={cfg.num_layers} B=4 T=257 bf16 "
          f"AdamW: weights+moments_GB={n_bytes / 1e9:.2f}")
    train_gradients(cfg, state.params, batch)

    # one SGD step on the same batch lowers the loss
    with torch.no_grad():
        before, _ = transformer.loss_fn(state.params, batch, cfg)
    new, _, _ = transformer.sgd_train_step(state.params, batch, cfg,
                                           lr=TRAIN_SGD_LR)
    with torch.no_grad():
        after, _ = transformer.loss_fn(new, batch, cfg)
    del new
    print(f"train: loss_fn {float(before):.5f} -> {float(after):.5f} after "
          f"one sgd_train_step (lr {TRAIN_SGD_LR}) on the same batch")
    check(float(after) < float(before), "train: SGD step did not lower "
          "the loss")

    step = trainer.make_train_step(cfg, opt)
    losses, step_ms = [], []
    for i in range(3):
        if i == 0:
            reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            launches = launch_counts()
            hopper = expert.grouped_matmul_cuda.hopper_launches
        losses.append(float(m["loss"]))
        check(math.isfinite(losses[-1]), f"train step {i}: loss {m['loss']}")
    check(all(launches[k] > 0 for k in ("gate", *TRAIN_KERNELS))
          and launches["grouped_ffn"] == 0
          and launches["flash_attention"] == 0,
          f"training path launches {launches}")
    check(hopper == launches["grouped_matmul"]
          == 3 * len(cfg.moe_layer_indices),
          f"train: {hopper} of {launches['grouped_matmul']} grouped matmul "
          f"launches on the Hopper kernel, want 3 a layer")
    print(f"train: grouped_matmul launches on the Hopper kernel: {hopper} "
          f"of {launches['grouped_matmul']}")
    print(f"train: losses={[round(x, 5) for x in losses]} "
          f"train_step_ms={[round(x, 3) for x in step_ms]} ({gpu_line()}) "
          f"launches_per_step={launches} attention=plain "
          f"(flash_attention_cuda launches 0 under autograd: the kernel has "
          f"no backward)")
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"train: peak_memory_GB={peak:.2f} (since the start of the run)")
    step_dev = device_breakdown("train_step", lambda: step(state, batch),
                                top_n=12)[0]
    optimizer_share(cfg, opt, state, batch, step_dev)
    return launches


def optimizer_share(cfg, opt, state, batch, step_device_ms):
    """The step's two parts by themselves, each against the whole step's
    device time: the optimizer (``opt.update`` + ``apply_updates`` on the
    train state and one step's gradients: CUDA-event time, device time and
    kernel launches) and ``value_and_grad`` (forward, remat and backward)."""
    _, _, grads = transformer.value_and_grad(state.params, batch, cfg)

    def update():
        updates, _ = opt.update(grads, state.opt_state, state.params)
        return trainer.apply_updates(state.params, updates)

    ms = cuda_ms(update, 3)
    opt_dev, n_opt = device_breakdown("optimizer_update", update, top_n=4)
    del grads
    grad_dev, n_grad = device_breakdown(
        "value_and_grad",
        lambda: transformer.value_and_grad(state.params, batch, cfg),
        top_n=8)
    if not (step_device_ms and opt_dev and grad_dev):
        print("train: optimizer share not measured (the profiler recorded "
              "no device time)")
        return
    print(f"train: optimizer update+apply_updates ms={ms:.3f} (CUDA events) "
          f"device_ms={opt_dev:.3f} kernels={n_opt} "
          f"({opt_dev / step_device_ms:.1%} of the step's device_ms="
          f"{step_device_ms:.3f}); value_and_grad device_ms={grad_dev:.3f} "
          f"kernels={n_grad} ({grad_dev / step_device_ms:.1%}) "
          f"({gpu_line()})")


def train_gradients(cfg, params, batch):
    """Every gradient leaf through the kernels: present, finite, non-zero
    where the loss reaches, and within GRAD_NORMWISE_TOL of the plain
    versions' with the same routing.  Layer 1's input differs between the
    two runs by bf16 rounding, so its routing may flip at near ties, and a
    flipped token's whole gradient changes; the plain run therefore
    replays the kernel run's expert choices (its own are only counted)."""
    with RoutingLog() as rk:
        _, _, gk = transformer.value_and_grad(params, batch, cfg)
    with ReplayRouting(rk.calls, cfg.expert_top_k,
                       len(cfg.moe_layer_indices)) as rp:
        _, _, gp = transformer.value_and_grad(params, batch, cfg,
                                              use_kernels=False)
    torch.cuda.synchronize()
    check(rp.n == len(rk.calls), f"train: {len(rk.calls)} router calls "
          f"with the kernels, {rp.n} replayed")
    check(rp.gap <= SERVE_NEAR_TIE,
          f"train: a routing flip between kernels and plain is no near tie "
          f"(probability gap {rp.gap})")
    flips, gap = rp.flips, rp.gap
    names = []

    def walk(tree, path):
        if isinstance(tree, dict):
            for key, v in tree.items():
                walk(v, f"{path}.{key}" if path else key)
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                walk(v, f"{path}[{i}]")
        else:
            names.append(path)

    walk(params, "")
    got = dict(zip(names, tree_leaves(gk)))
    want = dict(zip(names, tree_leaves(gp)))
    reached = ["embed", "lm_head", "final_norm"] + [
        f"layers[{li}].{leaf}" for li in range(cfg.num_layers)
        for leaf in ("wq", "wk", "wv", "wo", "attn_norm", "ffn_norm",
                     "moe.gate_w", "moe.w_gate", "moe.w_up", "moe.w_down")]
    for name in reached:
        check(float(got[name].float().abs().max()) > 0,
              f"train: gradient {name} is zero")
    errs = grad_agreement("train gradients", got, want)
    worst = sorted(errs.items(), key=lambda kv: -kv[1])[:6]
    print(f"train: {len(errs)} gradient leaves present and finite, "
          f"{len(reached)} checked non-zero; vs plain versions with the "
          f"kernels' routing replayed, normwise max "
          + " ".join(f"{name}={v:.3g}" for name, v in worst)
          + f" (tol {GRAD_NORMWISE_TOL}); plain routing would have flipped "
          f"{flips} (layer, token) choices, largest gap {gap:.3g} "
          f"(tol {SERVE_NEAR_TIE})")


class ReplayRouting:
    """While active, ``moe_layer``'s router is the plain one made to route
    as recorded calls did (``RoutingLog.calls``), call by call, so that a
    plain run differentiates the same function as the kernel run:

    - forward: the plain router's probabilities, combine weights and losses
      at the recorded expert ids;
    - backward: through the plain router's own ids on the recorded call's
      input (the top-k of its recorded probabilities), which is what the
      kernel's ``_RouterAD`` back-propagates through (it recomputes
      ``router_plain``, whose top-k may differ from the kernel's at a near
      tie).

    Over the first ``forward_calls`` calls (one per MoE layer; the remat's
    recompute repeats them) it counts the (layer, token) choices where this
    run's own top-k differs from the replayed ids (``flips``) and the
    largest gap of its k-th and (k+1)-th probabilities there (``gap``)."""

    def __init__(self, calls, k, forward_calls):
        self.calls = calls
        self.k = k
        self.forward_calls = forward_calls

    def __enter__(self):
        self.n, self.flips, self.gap, self._router = 0, 0, 0.0, moe.router

        def replayed(x, gate_w, cfg, use_kernels=None):
            ids, rec_probs = self.calls[self.n]
            back_ids = reference.top_k_lowest_index(rec_probs, self.k)[1]
            self.n += 1
            logits = reference.dot_f32(x, gate_w)
            probs = torch.softmax(logits, -1)
            own = reference.top_k_lowest_index(probs, self.k)[1]
            diff = (own.sort(-1).values != ids.sort(-1).values).any(-1)
            if self.n <= self.forward_calls and bool(diff.any()):
                top = probs.detach()[diff].sort(-1, descending=True).values
                self.gap = max(self.gap, float(
                    (top[:, self.k - 1] - top[:, self.k]).max()))
                self.flips += int(diff.sum())
            zsum = torch.sum(torch.square(torch.logsumexp(logits, -1)))

            def at(i):
                counts = torch.bincount(i.reshape(-1),
                                        minlength=cfg.num_experts)
                return gate._finish(cfg, probs.gather(-1, i), i,
                                    probs.sum(0), counts, zsum, x.shape[0])

            fwd, back = at(ids), at(back_ids)

            def value_of_fwd_grad_of_back(f, b):
                return b + (f - b).detach()

            return fwd._replace(
                combine_weights=value_of_fwd_grad_of_back(
                    fwd.combine_weights, back.combine_weights),
                aux_loss=value_of_fwd_grad_of_back(fwd.aux_loss,
                                                   back.aux_loss))

        moe.router = replayed
        return self

    def __exit__(self, *exc):
        moe.router = self._router


class RoutingLog:
    """While active, records every gate call that ``moe_layer`` and the
    expert-parallel layers make (one a rank): the top-k ids and the
    softmax probabilities of its tokens."""

    MODULES = (moe, ep, fused)

    def __enter__(self):
        self.calls, self._router = [], moe.router

        def recorded(x, gate_w, cfg, use_kernels=None):
            out = self._router(x, gate_w, cfg, use_kernels=use_kernels)
            probs = torch.softmax(reference.dot_f32(x, gate_w), -1)
            self.calls.append((out.expert_idx, probs.detach()))
            return out

        for mod in self.MODULES:
            mod.router = recorded
        return self

    def __exit__(self, *exc):
        for mod in self.MODULES:
            mod.router = self._router

    def per_position(self, n_layers, b, ranks=1):
        """Layer by layer, ids [B, T, K] and probs [B, T, E] over all the
        positions the recorded calls covered, in call order: a prefill or
        forward call covers [B, T] tokens, a decode step [B, 1]; an
        expert-parallel layer's ``ranks`` calls (one per rank, in token
        order) count as one."""
        calls = [tuple(torch.cat([c[j] for c in self.calls[i:i + ranks]])
                       for j in (0, 1))
                 for i in range(0, len(self.calls), ranks)]
        out = []
        for li in range(n_layers):
            calls_li = calls[li::n_layers]
            out.append(tuple(
                torch.cat([c[j].reshape(b, -1, c[j].shape[-1])
                           for c in calls_li], 1) for j in (0, 1)))
        return out


def serve_gather_tokens(cfg, tokens, gtokens, replay, greplay, t0):
    """The greedy tokens of generate with and without gather_fused: equal,
    or a sequence differs only after the two runs' routing flipped at a
    near tie (the serve check's rule: the replays' probabilities at a
    flip within SERVE_NEAR_TIE), before its first differing token."""
    b = tokens.shape[0]
    n = len(cfg.moe_layer_indices)
    k = cfg.expert_top_k
    diff_tok = (tokens != gtokens).any(-1)
    flips, gap, first = 0, 0.0, None
    for (ids, probs), (gids, _) in zip(replay.per_position(n, b),
                                       greplay.per_position(n, b)):
        d = (ids.sort(-1).values != gids.sort(-1).values).any(-1)  # [B, T]
        flips += int(d.sum())
        if bool(d.any()):
            top = probs[d].sort(-1, descending=True).values
            gap = max(gap, float((top[:, k - 1] - top[:, k]).max()))
        first = d if first is None else first | d
    for bi in torch.nonzero(diff_tok).reshape(-1).tolist():
        at = int(torch.nonzero(tokens[bi] != gtokens[bi])[0])
        check(bool(first[bi, :at].any()) and gap <= SERVE_NEAR_TIE,
              f"serve gather_fused: sequence {bi} differs at position {at} "
              f"without a near-tie routing flip before it (gap {gap})")
    print(f"serve gather_fused vs explicit dispatch: sequences_differing="
          f"{int(diff_tok.sum())}/{b} tokens_differing="
          f"{int((tokens[:, t0:] != gtokens[:, t0:]).sum())} "
          f"routing_flips={flips} largest_flip_gap={gap:.3g} "
          f"(tol {SERVE_NEAR_TIE})")


def serve_flips(cfg, replay, fwd, b, ranks=1):
    """Compare generate's (or an expert-parallel forward's, ``ranks``
    router calls a layer) routing with forward's, position by position.
    Returns ([B, T] true at every position at or after a routing flip in
    its sequence, the number of (layer, token) flips, the largest gap of
    forward's k-th and (k+1)-th probabilities at a flip, and that largest
    gap at a first-order flip only: one where no earlier layer flipped at
    its position or an earlier one of its sequence, so that the two runs'
    inputs to the layer differ by rounding alone)."""
    k = cfg.expert_top_k
    n = len(cfg.moe_layer_indices)
    check(len(fwd.calls) == n and len(replay.calls) % (n * ranks) == 0,
          f"routing calls: replay {len(replay.calls)}, forward "
          f"{len(fwd.calls)}, MoE layers {n}")
    after, gap, gap_first, n_flips = None, 0.0, 0.0, 0
    for (ids_r, _), (ids_f, probs_f) in zip(
            replay.per_position(n, b, ranks), fwd.per_position(n, b)):
        check(ids_r.shape == ids_f.shape,
              f"routing shapes {tuple(ids_r.shape)} {tuple(ids_f.shape)}")
        diff = (ids_r.sort(-1).values != ids_f.sort(-1).values).any(-1)
        if after is None:
            after = torch.zeros_like(diff)
        if bool(diff.any()):
            top = probs_f.sort(-1, descending=True).values
            gaps = top[..., k - 1] - top[..., k]
            gap = max(gap, float(gaps[diff].max()))
            first = diff & ~after
            if bool(first.any()):
                gap_first = max(gap_first, float(gaps[first].max()))
        n_flips += int(diff.sum())
        after = after | diff.int().cummax(1).values.bool()
    return after, n_flips, gap, gap_first


def profile_breakdown(cfg, params, prompt, tokens, tag="serve"):
    """Where the serving time goes: host-clock time of a prefill and of a
    decode step (each ended by a synchronize), and the device time by
    kernel from torch.profiler over both.  Returns the two device times
    (None where the profiler recorded none)."""
    b, t0 = prompt.shape
    embed = params["embed"].to(cfg.dtype)
    tok = embed[tokens[:, t0]][:, None, :]

    def prefill():
        cache = generate.init_cache(cfg, b, t0 + 2, "cuda")
        generate.prefill_batched(params, cfg, prompt, cache)
        return cache

    cache = prefill()
    torch.cuda.synchronize()
    t = time.perf_counter()
    cache = prefill()
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    generate._decode_step(params, cfg, tok, cache, t0)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t) * 1e3
    print(f"{tag}: prefill_ms={prefill_ms:.3f} "
          f"decode_step_ms={decode_ms:.3f}")
    pre = "" if tag == "serve" else f"{tag} "
    def decode():
        generate._decode_step(params, cfg, tok, cache, t0)

    return (device_breakdown(f"{pre}prefill", prefill)[0],
            device_breakdown(f"{pre}decode_step", decode)[0])


def device_breakdown(tag, fn, top_n=8):
    """Device time by kernel of one call of ``fn``, from torch.profiler.
    Only the kernels' own rows count: an operator's row repeats the time
    of the kernels it launched.  Returns (device ms, kernel launches), or
    (None, 0) when the profiler recorded no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    total = sum(r[1] for r in rows)
    if not rows:
        print(f"profile {tag}: device time not measured (the profiler "
              f"recorded none)")
        return None, 0
    rows.sort(key=lambda r: -r[1])
    launches = sum(r[2] for r in rows)
    top = "; ".join(f"{k[:48]} x{c} {ms:.3f}ms ({ms / total:.0%})"
                    for k, ms, c in rows[:top_n])
    print(f"profile {tag}: device_ms={total:.3f} kernels={launches}: {top}")
    classes = {}
    for k, ms, _ in rows:
        name = ("port kernels" if "fm::" in k else
                "library GEMMs" if any(w in k.lower() for w in (
                    "gemm", "cutlass", "xmma", "nvjet", "cublas")) else
                "elementwise" if any(w in k for w in (
                    "elementwise", "vectorized", "unrolled")) else
                "reductions" if "reduce" in k.lower() else "other")
        classes[name] = classes.get(name, 0.0) + ms
    print(f"profile {tag} by class: " + "; ".join(
        f"{n} {ms:.3f}ms ({ms / total:.0%})"
        for n, ms in sorted(classes.items(), key=lambda kv: -kv[1])))
    return total, launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(gpu_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.library()
    print(f"kernel build_s={time.perf_counter() - t0:.2f}")

    cfg = presets.mixtral_8x7b(num_layers=4, param_dtype=torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(0)
    params = transformer.init_params(g, cfg, device="cuda")
    n_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    print(f"mixtral_8x7b layers={cfg.num_layers}: "
          f"weights_GB={n_bytes / 1e9:.2f}")

    moe0 = params["layers"][0]["moe"]
    x = torch.randn(1024, cfg.hidden_size, device="cuda", generator=g,
                    dtype=torch.bfloat16)
    tile_phase()
    entries = [gate_phase(cfg, x, moe0["gate_w"]),
               ffn_phase(cfg, moe0, x), flash_phase(),
               res_phase(cfg, moe0, x), gmm_phase(cfg, moe0, x),
               tgmm_phase(cfg, moe0, x), *gate_tiled_phase(),
               gather_phase(cfg, moe0, x)]
    capacity_phase()
    launches = serve_phase(cfg, params)
    ep_entry, ep_launches = ep_phase(cfg, params)
    entries.append(ep_entry)
    launches.update({k: ep_launches[k] for k in EP_KERNELS})
    del params, moe0, x
    torch.cuda.empty_cache()
    quant_entries, quant_launches = quant_phase()
    entries += quant_entries
    launches.update(quant_launches)
    many = many_expert_phase()
    launches.update({k: many[k] for k in MANY_EXPERT_KERNELS})
    train_launches = train_phase()
    launches.update({k: train_launches[k] for k in TRAIN_KERNELS})

    kernels = [dict(e, launches=launches[e["name"]]) for e in entries]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
