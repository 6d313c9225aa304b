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
   (with pass 2 and without; S 4, E 300, f32 and K = 64 cases too; a
   token's pass-1 outputs alone bit for bit against the same token's in
   S 8192; both passes twice bit for bit), and the
   gather-fused FFN (also against the grouped FFN on the dispatched
   buffer, bit for bit).  The gate and both FFNs are timed at prefill and
   decode (the grouped FFN's decode rows also held, bit for bit, against
   the same tokens' rows inside the prefill), the grouped matmul and the
   transposed grouped matmul at both of the train step's shapes; the
   gate, grouped matmul, transposed grouped matmul, flash attention and
   the two-pass gate's passes (at S 8192 and 4) as the bare C call, with
   the wrapper's time beside it; the last three also as their kernels'
   device time from torch.profiler beside the library call's (the
   transposed grouped matmul's with a bf16 output and with an f32 one,
   each with its own byte bound);
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
4b. engine: the serving engine (``serving.ServingEngine``) on the same
   weights, each run a path (counts reset before, read after): a trace
   of 16 requests (prompts of 64-512 tokens, 16-32 new, every second one
   sampled at temperature 0.8, top-k 50, top-p 0.9, a pair arriving
   every 2 steps) through 8 slots, its greedy requests against
   ``generate`` on each prompt alone, then again for the same streams
   (timed, unlogged) and a third time for a profiled window of decode
   steps (device time by class, idle share); the same trace gather-fused,
   in a starved page pool (evictions) and with ep_shards 8 over a local
   mesh, each against the first run; 4 prompts of 1024-1536 tokens in
   chunks of 256 against the whole prefill; speculative greedy decoding
   (4 drafts, repetitive prompts) against the plain engine.  Tokens equal
   or first differing at a near tie, the logits of each token decided
   from the same history within the serve checks' tolerances, routing
   flips only at near ties (``near_tie_match``); then each comparison
   again with both runs replaying one run's routing, so that they route
   alike by construction and every token up to the first difference is
   held; and ``python -m flashmoe_tpu_torch.serving`` with its defaults;
5. ep: expert parallelism over 8 virtual ranks of a local mesh: the ep
   path, ``forward`` at Mixtral widths (4 layers, 4 x 256 tokens) with
   the fused backend (counts reset before, read after), the collective
   one and the dropless ragged one, each against the one-device forward;
   the fused kernel (B5) at that path's shapes against its plain version
   and its rows against the grouped FFN's on the same rows (bit for
   bit), timed with the library yardstick; then one Mixtral-width MoE
   layer at 8192 tokens (dropless) and the FlashMoE reference layer
   (capacity 32 a rank and expert): B5 as at the path's shapes, the
   fused layer against its plain version, the collective layer and
   (dropless) the single-device layer, the in-kernel combine against the
   layer's, each timed, one fused layer profiled.  On that Mixtral layer
   the expert-parallel training paths, each with its counts reset
   before and read after: the ragged layer (``moe_backend='ragged'``: B1
   and B2 on each rank, B2 handed the live row count) against its plain
   version, the dense exchange, the collective and single-device layers,
   counts exact, timed and profiled, its backward against a plain run
   replaying its routing, ``decode_moe_rows`` on one row a rank; the
   collective layer over 4 ep x 2 tp ranks, forward and backward against
   ep 8 and the single-device layer, timed with its weight-slice copy;
   the fused layer's backward (B5 forward, B7's w [E, K, N] recompute
   over the occupied slab tiles, B7 and B8, every grouped matmul a
   Hopper launch) against a plain run, the collective layer's
   gradients, the in-kernel combine's and its own with the full map (bit
   for bit); each layer's forward+backward timed and profiled; and B7's
   w [E, K, N] f32-output arm alone at the recompute's shape, over the
   full slab and over the backward's live tiles, timed with its bound
   and ``torch.mm``;
6. quantized expert storage: Mixtral-8x7B at its published widths and
   all 32 layers with its experts stored as int8 (random bf16 weights
   quantized layer by layer, ``quant.quantize_ffn_params``): the store's
   bytes beside a bf16 store's, serving as in phase 4 (generate's step
   logits against ``forward``, a prefill and a decode step timed and
   profiled, the boundary dequantization's share, every prefill MoE layer
   and every MoE layer of the decode steps against ``reference_moe`` on
   its dequantized weights, and the serving engine on the 4 prompts
   against ``generate``'s tokens, the freed bytes as extra KV pages); on
   4 of its
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
   training against a plain run replaying its routing, and the share of
   tokens whose top-k the router's backward (router_plain, recomputed)
   would choose otherwise than B4a did;
8. train: Mixtral-8x7B's widths with 2 layers, bf16 weights and AdamW:
   three ``make_train_step`` steps on 4 x 257 tokens (the training path:
   counts reset before the first step, read after it); every gradient
   against the plain versions', the loss lower after one SGD step, and the
   step's device time split into the optimizer and ``value_and_grad``;
9. ep train: ``make_train_step`` over a local mesh at the same widths,
   state and batch, each with the ragged layer (ep 8), the fused layer
   (ep 8) and the collective layer at ep 4 x tp 2: at the initial
   weights every gradient of ``value_and_grad`` over the mesh against the
   plain versions' on the same mesh with the routing replayed; then three
   AdamW steps (counts reset before the first step, read after it):
   losses finite, step 0's against the one-device step's, step time on
   the host clock and on the device, and the idle share; then three
   steps without the load-balancing loss (a mean of the ranks' own over
   a mesh) against the one-device steps without it;
10. axes: the mesh's other axes over virtual ranks, each path with its
   counts reset before and read after: after phase 5, on its 4-layer
   weights, ``forward`` over dp 2 x ep 2 x sp 2 (ring attention over
   sp, the MoE tokens over (dp, ep, sp)) at B 2 x T 4096, collective
   and fused, against the one-device forward (B9 at T 4096) by phase
   5's rule, timed, profiled, with its peak memory; ring attention alone
   at [2, 32, 4096, 128] bf16 over sp 4 against the plain attention in
   f32, timed beside B9 and SDPA.  After phase 9, at its widths, state
   and batch: every gradient of ``value_and_grad`` over dp 2 x ep 2 x
   sp 2 against a plain replay, timed and profiled; ``make_train_step``
   over dp 2 x ep 4, collective and fused, as phase 9 (without its
   gradient check); ``pipeline_loss`` over pp 2 x ep 2 x dp 2 at 4
   layers, 8 x 257 tokens, 2 microbatches, GPipe and interleaved: ce
   against one device's ``loss_fn``, the lm head once a microbatch, and
   with the aux and z coefficients at 0 the loss against one device's ce
   and every gradient against the same pipeline on the plain versions
   replaying the routing, timed, profiled, with its peak memory.

11. runtime: the front door, on a temporary directory whose free space
   is checked first: ``bootstrap.initialize()`` on the card; a config
   file of BENCH_CONFIGS "reference" (E 64, top-2, H = I = 2048, 8192
   tokens, bf16) written by ``MoEConfig.to_json``, run by
   ``api.run_moe(1, config_path=...)`` as a worker process (rc 0, a
   finite output), then the worker's ``main([config, "--bench"])`` in
   this process (the worker path: counts reset before, read after,
   ``moe_fwd_ms``); ``throughput.measure_expert_throughput`` at the same
   widths (the probe path); one train state at Mixtral-8x7B's widths (1
   layer, bf16, with the guard): a sync save (payload and CRC timed
   apart), an async save (the loop's stall), a restore with verification
   bit for bit; the training CLI (``python -m
   flashmoe_tpu_torch.runtime.train_cli`` through ``chip_smoke.py
   --train-cli``, which counts its kernels) at those widths on 4 x 257
   tokens a step from a token file through the native loader: 6 unbroken
   steps (the CLI path), then with ``--checkpoint-dir``,
   ``--checkpoint-every 3``, ``--async-save`` and ``--grad-guard`` sent
   SIGTERM after its step-3 line (rc 0, drained, its checkpoint verified
   with the loader's cursor), then again to resume and finish; the
   drained and resumed losses against the unbroken run's, bit for bit or
   within ``CLI_LOSS_RTOL``.

The second-to-last line of stdout is the kernels' JSON line (each
kernel's launches on the main path of the slice that ported it, and, in
``launches_by_path``, on the paths of phases 4b, 5, 6, 9, 10 and 11 that
ran it), the last
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
package beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import tempfile
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
from flashmoe_tpu_torch.parallel import (ep, fused, mesh,  # noqa: E402
                                         pipeline, ragged_ep, ringattn)
from flashmoe_tpu_torch import api  # noqa: E402
from flashmoe_tpu_torch.runtime import (bootstrap, checkpoint,  # noqa: E402
                                        data, elastic, throughput,
                                        train_cli, trainer, worker)
from flashmoe_tpu_torch.serving import __main__ as serve_cli  # noqa: E402
from flashmoe_tpu_torch.serving import engine as serving  # noqa: E402
from flashmoe_tpu_torch.serving import loadgen  # noqa: E402
from flashmoe_tpu_torch.serving.kvcache import (  # noqa: E402
    gather_ctx, init_paged_cache, prompt_pad)
from flashmoe_tpu_torch.tree import tree_leaves, tree_map  # noqa: E402
from flashmoe_tpu_torch.utils.telemetry import (FlightRecorder,  # noqa: E402
                                                Metrics)

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
# two runs' greedy (or sampled) tokens may first differ where this run's
# top two scores lie closer than the two runs' rounding moves them apart:
# with the rows' rms difference d over the vocabulary, two entries' errors
# differ by about sqrt(2) d (random lm_head columns), so a margin of 6 d
# is a 4.2-sigma move
SERVE_TIE_SIGMAS = 6.0
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


def device_ms(fn, iters: int, words=None) -> tuple[float | None, str]:
    """Mean device milliseconds a call of ``fn`` spends in the kernels
    whose names hold one of ``words`` (every kernel with None), from
    torch.profiler over ``iters`` calls after one warm-up call; and those
    kernels' names.  (None, "") when the profiler recorded no device
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0
            and (words is None or any(w in e.key for w in words))]
    if not rows:
        return None, ""
    names = "; ".join(k[:60] for k, _ in rows)
    return sum(us for _, us in rows) / 1e3 / iters, names


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.5f}"


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
    # the bare C call on arguments made once, the wrapper (checks, output,
    # the call), the kernel's and SDPA's device time
    args, _o = attention.flash_args(q, k, v)
    lib = _build.library()
    check(lib.fm_flash_attention(*args) == 0, "fm_flash_attention launch")

    def library():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              enable_gqa=True)

    rec = dict(
        name="flash_attention", route="cuda",
        source="flashmoe_tpu_torch/csrc/flash_attention.cu",
        replaces="flashmoe_tpu/ops/attention.py:54", max_abs_err=err,
        ms=cuda_ms(lambda: lib.fm_flash_attention(*args), 200),
        wrapper_ms=cuda_ms(lambda: attention.flash_attention_cuda(q, k, v),
                           200),
        device_ms=device_ms(lambda: lib.fm_flash_attention(*args), 50,
                            ("flash",))[0],
        plain_ms=cuda_ms(lambda: attention.flash_attention_plain(q, k, v), 20),
        library_ms=cuda_ms(library, 200),
        **bound(bytes_=2 * (2 * b * n * t * d + 2 * b * nkv * t * d),
                flops=4 * b * n * d * t * (t + 1) / 2))
    rec["library_device_ms"], lib_names = device_ms(library, 50)
    print(f"flash_attention prefill [{b}, {n}, {t}, {d}] kv heads {nkv} "
          f"bf16 causal: kernel_ms={rec['ms']:.5f} (bare "
          f"fm_flash_attention) wrapper_ms={rec['wrapper_ms']:.5f} "
          f"device_ms={fmt_ms(rec['device_ms'])} (profiler) "
          f"library_ms={rec['library_ms']:.5f} library_device_ms="
          f"{fmt_ms(rec['library_device_ms'])} ({lib_names}) "
          f"plain_ms={rec['plain_ms']:.5f} bound_ms={rec['bound_ms']:.5f} "
          f"({rec['bound_by']}) ({gpu_line()})")
    return rec


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
            nrow.reshape(1).to(torch.int32), transpose_w=True)
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

        # the bare C call on arguments made once beside the wrapper; the
        # kernel's device time; two library yardsticks, per-expert x_e^T
        # @ dy_e with a bf16 output (half of B8's output bytes) and with
        # an f32 one (torch.mm's out_dtype, where the installed torch has
        # it), each with its own byte bound
        bare, _dw, _ranges = expert.tgmm_args(a_in, b_in, gid, e,
                                              num_rows=nrow)
        lib = _build.library()
        check(lib.fm_tgmm(*bare) == 0, "fm_tgmm launch")

        def library(a_in=a_in, b_in=b_in):
            out = torch.empty((e, k, n), device="cuda", dtype=torch.bfloat16)
            for ex, lo, hi in segs:
                out[ex] = a_in[lo:hi].T @ b_in[lo:hi]
            return out

        def library_f32(a_in=a_in, b_in=b_in):
            out = torch.empty((e, k, n), device="cuda", dtype=torch.float32)
            for ex, lo, hi in segs:
                torch.mm(a_in[lo:hi].T, b_in[lo:hi], out_dtype=torch.float32,
                         out=out[ex])
            return out

        try:
            ref = library_f32()
            torch.cuda.synchronize()
            f32_ok = True
        except (TypeError, RuntimeError) as exc:
            f32_ok = False
            print(f"tgmm {tag}: torch.mm takes no out_dtype here ({exc!r:.120})")
        r = dict(
            ms=cuda_ms(lambda: lib.fm_tgmm(*bare), 10),
            wrapper_ms=cuda_ms(lambda: expert.tgmm_cuda(
                a_in, b_in, gid, e, num_rows=nrow), 10),
            device_ms=device_ms(lambda: lib.fm_tgmm(*bare), 5,
                                ("tgmm",))[0],
            library_ms=cuda_ms(library, 10),
            library_device_ms=device_ms(library, 5)[0],
            library_bound_ms=(rows * (k + n) * 2 + e * k * n * 2)
            / HBM_BPS * 1e3,
            library_f32_ms=cuda_ms(library_f32, 10) if f32_ok else None,
            library_f32_device_ms=device_ms(library_f32, 5)[0]
            if f32_ok else None,
            **bound(bytes_=rows * (k + n) * 2 + e * k * n * 4,
                    flops=2 * rows * k * n))
        if f32_ok:
            del ref
        print(f"tgmm {tag}: [{t}, {k}]^T @ [{t}, {n}] bf16 per expert -> "
              f"f32 [{e}, {k}, {n}], live rows {rows}: max_abs_err={err:.3g} "
              f"(rtol = atol = {F32_TOL}) kernel_ms={r['ms']:.4f} (bare "
              f"fm_tgmm) wrapper_ms={r['wrapper_ms']:.4f} "
              f"device_ms={fmt_ms(r['device_ms'])} (profiler) "
              f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
              f"library_ms={r['library_ms']:.4f} library_device_ms="
              f"{fmt_ms(r['library_device_ms'])} (bf16 out, byte bound "
              f"{r['library_bound_ms']:.4f}) library_f32_ms="
              f"{fmt_ms(r['library_f32_ms'])} library_f32_device_ms="
              f"{fmt_ms(r['library_f32_device_ms'])} (f32 out, byte bound "
              f"{r['bound_ms']:.4f}) ({gpu_line()})")
        del _dw
        if rec is None:
            rec = dict(
                name="tgmm", route="cuda",
                source="flashmoe_tpu_torch/csrc/tgmm.cu",
                replaces="flashmoe_tpu/ops/expert.py:574", max_abs_err=err,
                plain_ms=cuda_ms(
                    lambda: expert.tgmm_plain(a_in, b_in, gid, e,
                                              num_rows=nrow), 3), **r)
        else:
            rec.update({f"{tag}_{key}": v for key, v in r.items()})
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
    8192, H 2048, E 512, K 10, bf16), with pass 2 and without; at S 4
    (decode), E 300 with S 1000, the JAX tests' f32 case (E 1280, K 2, H
    128) and K = 64.  B4a's outputs for tokens alone (S 1 to 4) bit for
    bit against the same tokens' inside S 8192, both passes called twice
    bit for bit, B4b alone against its plain version on the kernel's
    pass-1 outputs.  Times: the bare C calls, the wrappers and the
    kernels' device time, at S 8192 and at S 4."""
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
    check_tiled_gate("decode_s4", x[:4].contiguous(), w, cfg, True)
    w300 = (torch.randn(h, 300, device="cuda", generator=g)
            / math.sqrt(h)).to(torch.bfloat16)
    check_tiled_gate("e300_s1000", x[:1000].contiguous(), w300,
                     cfg.replace(num_experts=300), True)

    # a token's pass-1 outputs are the same bits alone as in S 8192, and
    # both passes give the same bits twice
    full = gate.gate_pass1_cuda(x, w, k, True)
    again = gate.gate_pass1_cuda(x, w, k, True)
    check(all(torch.equal(a, b) for a, b in zip(full, again)),
          "gate_pass1: two calls differ")
    for s0, n in ((0, 4), (61, 4), (4093, 3), (8191, 1)):
        part = gate.gate_pass1_cuda(x[s0:s0 + n].contiguous(), w, k, True)
        check(all(torch.equal(a, b[s0:s0 + n]) for a, b in zip(part, full)),
              f"gate_pass1: tokens {s0}..{s0 + n} alone differ from S {s}")
    logits, m, se, _, top_i = full
    got = gate.gate_pass2_cuda(logits, m, se, top_i, e)
    check(all(torch.equal(a, b) for a, b in zip(
        got, gate.gate_pass2_cuda(logits, m, se, top_i, e))),
        "gate_pass2: two calls differ")
    print("gate_tiled: pass 1 of tokens alone (S 1-4) equal bit for bit to "
          "the same tokens in S 8192; both passes called twice equal bit "
          "for bit")
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

    lib = _build.library()

    def times(xs):
        """Both passes' bare C calls (arguments made once), wrappers,
        device time, plain versions and library calls on tokens xs."""
        n = xs.shape[0]
        a1, o1, _keep = gate.gate_pass1_args(xs, w, k, True)
        check(lib.fm_gate_pass1(*a1) == 0, "fm_gate_pass1 launch")
        lg, mm, ss, _, ti = o1
        a2, _o2, _scr = gate.gate_pass2_args(lg, mm, ss, ti)
        check(lib.fm_gate_pass2(*a2) == 0, "fm_gate_pass2 launch")
        iters = 200 if n < 64 else 50

        def library1():
            torch.topk(torch.softmax(torch.matmul(xs, w).float(), -1), k)

        def library2():
            torch.softmax(lg, -1).sum(0)
            torch.bincount(ti.reshape(-1), minlength=e)
            torch.logsumexp(lg, -1).square().sum()

        p1 = dict(
            ms=cuda_ms(lambda: lib.fm_gate_pass1(*a1), iters),
            wrapper_ms=cuda_ms(lambda: gate.gate_pass1_cuda(xs, w, k, True),
                               iters),
            device_ms=device_ms(lambda: lib.fm_gate_pass1(*a1), 20,
                                ("gate_pass1",))[0],
            plain_ms=cuda_ms(lambda: gate.gate_pass1_plain(xs, w, k, True),
                             5),
            library_ms=cuda_ms(library1, iters),
            library_device_ms=device_ms(library1, 20)[0],
            **bound(bytes_=2 * n * h + 2 * h * e + 4 * n * e + 8 * n
                    + 8 * n * k, flops=2 * n * h * e))
        p2 = dict(
            ms=cuda_ms(lambda: lib.fm_gate_pass2(*a2), iters),
            wrapper_ms=cuda_ms(
                lambda: gate.gate_pass2_cuda(lg, mm, ss, ti, e), iters),
            device_ms=device_ms(lambda: lib.fm_gate_pass2(*a2), 20,
                                ("gate_pass2",))[0],
            plain_ms=cuda_ms(
                lambda: gate.gate_pass2_plain(lg, mm, ss, ti, e), 5),
            library_ms=cuda_ms(library2, iters),
            library_device_ms=device_ms(library2, 20)[0],
            **bound(bytes_=4 * n * e + 8 * n + 4 * n * k + 8 * e + 4,
                    flops=4 * n * e, peak=F32_FLOPS))
        return p1, p2

    pass1, pass2 = times(x)
    d1, d2 = times(x[:4].contiguous())
    pass1.update(name="gate_pass1", route="cuda",
                 source="flashmoe_tpu_torch/csrc/gate_tiled.cu",
                 replaces="flashmoe_tpu/ops/gate.py:223", max_abs_err=err)
    pass2.update(name="gate_pass2", route="cuda",
                 source="flashmoe_tpu_torch/csrc/gate_tiled.cu",
                 replaces="flashmoe_tpu/ops/gate.py:308", max_abs_err=p2_err)
    for rec, dec in ((pass1, d1), (pass2, d2)):
        for tag, r in (("S=8192", rec), ("S=4", dec)):
            print(f"{rec['name']}: {tag} H={h} E={e} K={k} bf16: "
                  f"kernel_ms={r['ms']:.5f} (bare C call) wrapper_ms="
                  f"{r['wrapper_ms']:.5f} device_ms={fmt_ms(r['device_ms'])} "
                  f"(profiler) bound_ms={r['bound_ms']:.5f} ({r['bound_by']}) "
                  f"plain_ms={r['plain_ms']:.4f} library_ms="
                  f"{r['library_ms']:.5f} library_device_ms="
                  f"{fmt_ms(r['library_device_ms'])} ({gpu_line()})")
        rec.update({f"s4_{key}": v for key, v in dec.items()})
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
    m = mesh.local_mesh(cfg.ep, device="cuda")
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


def ep_forward_phase(cfg, params, backends=("fused", "collective")):
    """The ep path: ``forward`` at Mixtral widths over 8 virtual ranks,
    4 x 256 tokens, with each of ``backends`` (the fused one, the
    collective one, the dropless ragged one; counts reset before, read
    after), each against the one-device forward within the serve phase's
    tolerances.  Returns each backend's launches."""
    g = torch.Generator(device="cuda").manual_seed(3)
    b = 4
    tokens = torch.randint(0, cfg.vocab_size, (b, 256), device="cuda",
                           generator=g)
    with RoutingLog() as one:
        want, _ = transformer.forward(params, tokens, cfg)
    m = mesh.local_mesh(8, device="cuda")
    out = {}
    for backend in backends:
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
    return out


def ep_phase(cfg, params):
    """Expert parallelism over 8 virtual ranks on the card: the ep path
    (``forward`` with a mesh), B5 at the shapes it gives the kernel, one
    Mixtral-width MoE layer at 8192 tokens and the FlashMoE reference
    layer, then that Mixtral layer's dropless ragged, tensor-parallel and
    fused-backward paths (:func:`ep_train_layers`).  Returns (B5's and
    B7's recompute kernels-line entries, the ep path's launches, the
    launches of each path of this phase)."""
    fwd = ep_forward_phase(cfg, params, ("fused", "collective", "ragged"))
    launches = fwd["fused"]
    paths = {"ep forward ragged": fwd["ragged"]}
    g = torch.Generator(device="cuda").manual_seed(4)
    moe0 = params["layers"][0]["moe"]
    x = torch.randn(1024, cfg.hidden_size, device="cuda", generator=g,
                    dtype=torch.bfloat16)
    entry = fused_kernel_row("ep forward shapes",
                             cfg.replace(ep=8, moe_backend="fused"), moe0, x,
                             mesh.local_mesh(8, device="cuda"), 10)
    x = torch.randn(8192, cfg.hidden_size, device="cuda", generator=g,
                    dtype=torch.bfloat16)
    _, ep_times, _ = ep_layer_phase("ep mixtral layer", cfg.replace(ep=8),
                                    moe0, x, 3)
    gmm_entry = ep_train_layers(cfg, moe0, x, ep_times, paths)
    del x
    rcfg = presets.flashmoe_reference(param_dtype=torch.bfloat16, ep=8)
    rparams = reference.init_moe_params(g, rcfg, device="cuda")
    rx = torch.randn(rcfg.tokens, rcfg.hidden_size, device="cuda",
                     generator=g, dtype=torch.bfloat16)
    ep_layer_phase("ep reference layer", rcfg, rparams, rx, 5)
    del rparams, rx
    torch.cuda.empty_cache()
    return entry, gmm_entry, launches, paths


# ----------------------------------------------------------------------
# expert-parallel training paths: ragged, tp, the fused backward
# ----------------------------------------------------------------------

# the kernels each path of this section must launch at least once
PATH_KERNELS = {
    "ep forward ragged": ("gate", "grouped_ffn"),
    "ep ragged layer": ("gate", "grouped_ffn"),
    "ep ragged backward": ("gate", "grouped_ffn_res", "grouped_matmul",
                           "tgmm"),
    "ep ragged decode": ("gate", "grouped_ffn"),
    "ep tp layer": ("gate", "grouped_ffn"),
    "ep tp backward": ("gate", "grouped_ffn_res", "grouped_matmul", "tgmm"),
    "ep fused backward": ("gate", "fused_ep", "grouped_matmul", "tgmm"),
    "ep train ragged": ("gate", "grouped_ffn_res", "grouped_matmul",
                        "tgmm"),
    "ep train fused": ("gate", "fused_ep", "grouped_matmul", "tgmm"),
    "ep train collective tp": ("gate", "grouped_ffn_res", "grouped_matmul",
                               "tgmm"),
    "axes sp forward collective": ("gate", "grouped_ffn"),
    "axes sp forward fused": ("gate", "fused_ep"),
    "axes sp backward": ("gate", "grouped_ffn_res", "grouped_matmul",
                         "tgmm"),
    "axes dp train collective": ("gate", "grouped_ffn_res",
                                 "grouped_matmul", "tgmm"),
    "axes dp train fused": ("gate", "fused_ep", "grouped_matmul", "tgmm"),
    "axes pp gpipe": ("gate", "grouped_ffn_res", "grouped_matmul", "tgmm"),
    "axes pp interleaved": ("gate", "grouped_ffn_res", "grouped_matmul",
                            "tgmm"),
    "runtime worker": ("gate", "grouped_ffn"),
    "runtime probe": ("grouped_ffn",),
    "runtime cli": ("gate", "grouped_ffn_res", "grouped_matmul", "tgmm"),
}


def path_counts(name, paths, counts=None):
    """The launch counts since the last reset (or ``counts``, read in a
    child process), recorded as path ``name``; fails unless each of its
    kernels launched."""
    if counts is None:
        counts = all_counts()
    missing = [k for k in PATH_KERNELS[name] if not counts[k]]
    check(not missing, f"{name}: no launch of {missing} ({counts})")
    paths[name] = counts
    return counts


class GroupedRowsLog:
    """While active, records the live padded rows (``num_rows``) and the
    buffer rows of every grouped FFN call the ragged layer makes."""

    def __enter__(self):
        self.calls, self._ffn = [], ragged_ep._grouped_ffn

        def spy(x_grp, *a, num_rows=None, **kw):
            self.calls.append((None if num_rows is None else int(num_rows),
                               x_grp.shape[0]))
            return self._ffn(x_grp, *a, num_rows=num_rows, **kw)

        ragged_ep._grouped_ffn = spy
        return self

    def __exit__(self, *exc):
        ragged_ep._grouped_ffn = self._ffn

    def check(self, tag, n):
        check(len(self.calls) == n and all(
            live is not None and live < rows for live, rows in self.calls),
            f"{tag}: grouped FFN calls {self.calls}, want {n} with num_rows "
            f"below the buffer")
        live = [c[0] for c in self.calls]
        return (f"num_rows {min(live)}-{max(live)} of "
                f"{self.calls[0][1]} buffer rows")


def ep_layer_grads(layer_fn, params, x, cfg, m, use_kernels=None,
                   aux=True):
    """Gradients of ``sum(out**2)`` (+ aux) of one expert-parallel layer
    with respect to x and every parameter leaf."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    xx = x.detach().requires_grad_(True)
    o = layer_fn(leaves, xx, cfg, m, use_kernels=use_kernels)
    loss = (o.out.float() ** 2).sum() + (o.aux_loss if aux else 0.0)
    return dict(zip(["x", *leaves],
                    torch.autograd.grad(loss, [xx, *leaves.values()])))


def ep_backward(tag, layer_fn, cfg, params, x, m, paths):
    """The layer's gradients of ``sum(out**2) + aux`` through the kernels
    (counts reset before, read after, as path ``tag``) against a plain run
    that replays the kernel run's routing, every leaf within
    GRAD_NORMWISE_TOL.  Returns the kernel run's gradients."""
    reset_counts()
    with RoutingLog() as rk:
        got = ep_layer_grads(layer_fn, params, x, cfg, m)
    torch.cuda.synchronize()
    counts = path_counts(tag, paths)
    with ReplayRouting(rk.calls, cfg.expert_top_k, len(rk.calls)) as rp:
        want = ep_layer_grads(layer_fn, params, x, cfg, m, use_kernels=False)
    torch.cuda.synchronize()
    check(rp.n == len(rk.calls) == cfg.ep * cfg.tp,
          f"{tag}: {len(rk.calls)} router calls with the kernels, {rp.n} "
          f"replayed")
    check(rp.gap <= NEAR_TIE and rp.flips <= MAX_FLIP_SHARE * x.shape[0] + 1,
          f"{tag}: {rp.flips} routing flips, largest gap {rp.gap}")
    errs = grad_agreement(tag, got, want)
    del want
    print(f"{tag}: d(sum(out**2) + aux) per leaf vs plain with the kernel "
          f"run's routing replayed: "
          + " ".join(f"{k}={v:.3g}" for k, v in errs.items())
          + f" (normwise tol {GRAD_NORMWISE_TOL}); plain routing would have "
          f"flipped {rp.flips} tokens, largest gap {rp.gap:.3g} "
          f"launches={counts}")
    return got


def ragged_layer_phase(cfg, params, x, m, ep_times, paths):
    """The dropless ragged layer at Mixtral widths over 8 virtual ranks:
    B1 and B2 on each rank (B2 handed the live row count), against its
    plain version, the dense exchange (bit for bit), the dropless
    collective layer and the single-device layer (the same routing, so
    the same tokens meet the same experts), counts exact; timed beside
    the collective and fused layers and profiled; its backward against a
    plain run replaying the routing; ``decode_moe_rows`` on one row a
    rank against the single-device layer."""
    rcfg = cfg.replace(moe_backend="ragged")
    tag = "ep ragged layer"
    rk = gate.router_cuda(x, params["gate_w"], cfg)
    rp = gate.router_plain(x, params["gate_w"], cfg)
    flips = routing_flips(rk.expert_idx, rp.expert_idx, torch.softmax(
        reference.dot_f32(x, params["gate_w"]), -1))
    reset_counts()
    with GroupedRowsLog() as rows:
        got = ragged_ep.ragged_ep_moe_layer(params, x, rcfg, m)
        torch.cuda.synchronize()
    counts = path_counts(tag, paths)
    check(counts["gate"] == cfg.ep and counts["grouped_ffn"] == cfg.ep
          and counts["fused_ep"] == counts["grouped_ffn_res"] == 0,
          f"{tag} launches {counts}")
    live = rows.check(tag, cfg.ep)
    plain = ragged_ep.ragged_ep_moe_layer(params, x, rcfg, m,
                                          use_kernels=False)
    layer_agreement(f"{tag} vs plain", got.out, plain.out, flips)
    del plain
    dense = ragged_ep.ragged_ep_moe_layer(params, x, rcfg, m,
                                          exchange="dense")
    check(torch.equal(dense.out, got.out),
          f"{tag}: the dense exchange differs from the ragged one")
    del dense
    coll = ep.ep_moe_layer(params, x, cfg, m)
    layer_agreement(f"{tag} vs dropless collective", got.out, coll.out, 0)
    single = moe.moe_layer(params, x, cfg.replace(ep=1))
    layer_agreement(f"{tag} vs single-device moe_layer", got.out,
                    single.out, 0)
    check(torch.equal(got.expert_counts, coll.expert_counts)
          and torch.equal(got.expert_counts, single.expert_counts)
          and int(got.expert_counts.sum()) == x.shape[0] * cfg.expert_top_k,
          f"{tag}: expert counts {got.expert_counts.tolist()}")
    del coll, single
    times = dict(ragged=cuda_ms(lambda: ragged_ep.ragged_ep_moe_layer(
        params, x, rcfg, m), 3), ragged_dense=cuda_ms(
        lambda: ragged_ep.ragged_ep_moe_layer(params, x, rcfg, m,
                                              exchange="dense"), 3),
        **{k: ep_times[k] for k in ("collective", "fused", "single_device")})
    print(f"{tag}: E={cfg.num_experts} K={cfg.expert_top_k} "
          f"H={cfg.hidden_size} I={cfg.intermediate_size} S={x.shape[0]} "
          f"ep={cfg.ep} {live} launches={counts} expert_counts="
          f"{got.expert_counts.tolist()} layer_ms "
          + " ".join(f"{k}={v:.4f}" for k, v in times.items())
          + f" ({gpu_line()})")
    device_breakdown(tag, lambda: ragged_ep.ragged_ep_moe_layer(
        params, x, rcfg, m))
    del got
    ep_backward("ep ragged backward", ragged_ep.ragged_ep_moe_layer, rcfg,
                params, x, m, paths)
    # decode: one row a rank, each rank's own
    xd = x[:cfg.ep]
    reset_counts()
    dec = ragged_ep.decode_moe_rows(m.shard_params(params), m.split(xd),
                                    rcfg, m)
    torch.cuda.synchronize()
    counts = path_counts("ep ragged decode", paths)
    want = moe.moe_layer(params, xd, cfg.replace(ep=1))
    layer_agreement("ep ragged decode_moe_rows vs single-device moe_layer",
                    torch.cat(dec.out), want.out, 0)
    print(f"ep ragged decode_moe_rows: {cfg.ep} rows, one a rank: "
          f"launches={counts}")


def tp_layer_phase(cfg, params, x, paths):
    """The same layer over 4 ep x 2 tp virtual ranks, collective: forward
    (B1 on every rank, B2 on each rank's half of every expert) against ep
    8 x tp 1 and the single-device layer; the gradients of ``sum(out**2)``
    (the load-balancing loss is a mean over ep shards, so it differs
    between ep 4 and ep 8 by definition) against both; timed, with the
    weight-slice copy the mesh makes for each call.  Returns the ep 8
    collective layer's gradients of ``sum(out**2) + aux``."""
    tag = "ep tp layer"
    tm = mesh.local_mesh(4, tp=2, device="cuda")
    tcfg = cfg.replace(ep=4, tp=2)
    m8 = mesh.local_mesh(8, device="cuda")
    reset_counts()
    got = ep.ep_moe_layer(params, x, tcfg, tm)
    torch.cuda.synchronize()
    counts = path_counts(tag, paths)
    check(counts["gate"] == 8 and counts["grouped_ffn"] == 8,
          f"{tag} launches {counts}")
    e8 = ep.ep_moe_layer(params, x, cfg, m8)
    single = moe.moe_layer(params, x, cfg.replace(ep=1))
    layer_agreement(f"{tag} vs ep 8 x tp 1", got.out, e8.out, 0)
    layer_agreement(f"{tag} vs single-device moe_layer", got.out, single.out,
                    0)
    check(torch.equal(got.expert_counts, e8.expert_counts),
          f"{tag}: expert counts")
    del e8, single
    times = dict(
        tp=cuda_ms(lambda: ep.ep_moe_layer(params, x, tcfg, tm), 3),
        weight_slices=cuda_ms(lambda: tm.shard_params(params), 3),
        ep8=cuda_ms(lambda: ep.ep_moe_layer(params, x, cfg, m8), 3))
    print(f"{tag}: ep=4 tp=2 (I/tp={cfg.intermediate_size // 2}) S="
          f"{x.shape[0]} launches={counts} layer_ms "
          + " ".join(f"{k}={v:.4f}" for k, v in times.items())
          + f" (weight_slices: the contiguous tp copies of every rank, one "
          f"per call) ({gpu_line()})")
    device_breakdown(tag, lambda: ep.ep_moe_layer(params, x, tcfg, tm))
    reset_counts()
    tg = ep_layer_grads(ep.ep_moe_layer, params, x, tcfg, tm, aux=False)
    torch.cuda.synchronize()
    counts = path_counts("ep tp backward", paths)
    want = ep_layer_grads(ep.ep_moe_layer, params, x, cfg, m8, aux=False)
    e8_errs = grad_agreement("ep tp backward vs ep 8", tg, want)
    del want
    want = ep_layer_grads(lambda p, xx, c, _m, use_kernels=None:
                          moe.moe_layer(p, xx, c, use_kernels=use_kernels),
                          params, x, cfg.replace(ep=1), None, aux=False)
    one_errs = grad_agreement("ep tp backward vs single device", tg, want)
    del want, tg
    print("ep tp backward: d(sum(out**2)) per leaf vs ep 8 x tp 1: "
          + " ".join(f"{k}={v:.3g}" for k, v in e8_errs.items())
          + "; vs the single-device layer: "
          + " ".join(f"{k}={v:.3g}" for k, v in one_errs.items())
          + f" (normwise tol {GRAD_NORMWISE_TOL}) launches={counts}")
    return ep_layer_grads(ep.ep_moe_layer, params, x, cfg, m8)


def _full_map(gid, counts, ch):
    """The fused backward's recompute over every slab row (JAX's), in
    place of ``fused.dead_tile_gid``."""
    return gid


def fused_backward_phase(cfg, params, x, m, coll_grads, paths):
    """The fused layer's backward (``_FusedCore``: B5 forward; the slabs
    and cotangents re-exchanged, u and g recomputed by B7's w [E, K, N]
    arm in f32 over each slab's occupied tiles, then B7 and B8, every
    grouped matmul on the Hopper kernel) against a plain run replaying
    its routing and against the collective layer's gradients; the
    in-kernel combine's (``_FusedCombineCore``) against the layer
    combine's; the gradients with the dead-tile map against those with
    the full map (every slab row recomputed), bit for bit.  Then fwd+bwd
    times of the ragged, collective, tp and fused layers, and the device
    time of each by class.  Returns the recompute's tile maps of the
    dead-tile run, one an owner rank."""
    fcfg = cfg.replace(moe_backend="fused")
    tag = "ep fused backward"
    got = ep_backward(tag, fused.fused_ep_moe_layer, fcfg, params, x, m,
                      paths)
    counts = paths[tag]
    d = cfg.ep
    n_rec = 2 if cfg.gated_ffn else 1  # u and g recomputed
    n_dx = 2 if cfg.gated_ffn else 1
    check(counts["fused_ep"] == 1 and counts["gate"] == d
          and counts["grouped_matmul"] == d * (n_rec + 1 + n_dx)
          and counts["grouped_matmul_hopper"] == counts["grouped_matmul"]
          and counts["tgmm"] == d * (2 + int(cfg.gated_ffn))
          and counts["grouped_ffn"] == counts["grouped_ffn_res"] == 0,
          f"{tag} launches {counts}")
    errs = grad_agreement(f"{tag} vs collective", got, coll_grads)
    print(f"{tag} vs the collective layer's (dropless, the same routing): "
          + " ".join(f"{k}={v:.3g}" for k, v in errs.items())
          + f" (normwise tol {GRAD_NORMWISE_TOL})")
    os.environ["FLASHMOE_FUSED_COMBINE"] = "1"
    try:
        comb = ep_layer_grads(fused.fused_ep_moe_layer, params, x, fcfg, m)
        cerrs = grad_agreement(f"{tag} in-kernel combine", comb, got)
        del comb
        comb_ms = cuda_ms(lambda: ep_layer_grads(
            fused.fused_ep_moe_layer, params, x, fcfg, m), 2)
    finally:
        del os.environ["FLASHMOE_FUSED_COMBINE"]
    print(f"{tag}: in-kernel combine vs layer combine: "
          + " ".join(f"{k}={v:.3g}" for k, v in cerrs.items())
          + f" (normwise tol {GRAD_NORMWISE_TOL})")
    del got
    maps, dead_map = [], fused.dead_tile_gid

    def spy(gid, counts, ch):
        maps.append(dead_map(gid, counts, ch))
        return maps[-1]

    try:
        fused.dead_tile_gid = spy
        live = ep_layer_grads(fused.fused_ep_moe_layer, params, x, fcfg, m)
        fused.dead_tile_gid = _full_map
        full = ep_layer_grads(fused.fused_ep_moe_layer, params, x, fcfg, m)
    finally:
        fused.dead_tile_gid = dead_map
    torch.cuda.synchronize()
    check(len(maps) == d, f"{tag}: {len(maps)} recompute maps, want {d}")
    shares = [float((mp >= 0).float().mean()) for mp in maps]
    check(min(shares) < 1.0, f"{tag}: no dead tile in the recompute")
    differ = [k for k in live if not torch.equal(live[k], full[k])]
    check(not differ, f"{tag}: gradients with the dead-tile map differ from "
          f"the full map's in {differ}")
    del live, full
    print(f"{tag}: gradients with the dead-tile map equal the full map's "
          f"bit for bit (every leaf); live tiles an owner "
          + " ".join(f"{v:.3f}" for v in shares))
    tm = mesh.local_mesh(4, tp=2, device="cuda")
    runs = {
        "ragged": (ragged_ep.ragged_ep_moe_layer,
                   cfg.replace(moe_backend="ragged"), m),
        "collective": (ep.ep_moe_layer, cfg, m),
        "tp": (ep.ep_moe_layer, cfg.replace(ep=4, tp=2), tm),
        "fused": (fused.fused_ep_moe_layer, fcfg, m)}
    times = {k: cuda_ms(lambda f=f, c=c, mm=mm: ep_layer_grads(
        f, params, x, c, mm), 2) for k, (f, c, mm) in runs.items()}
    times["fused_combine"] = comb_ms
    print("ep layers forward+backward (Mixtral widths, 8192 tokens) ms "
          + " ".join(f"{k}={v:.3f}" for k, v in times.items())
          + f" ({gpu_line()})")
    for k, (f, c, mm) in runs.items():
        device_breakdown(f"ep {k} layer forward+backward",
                         lambda f=f, c=c, mm=mm: ep_layer_grads(
                             f, params, x, c, mm), top_n=10)
    return maps


# device ms of B7's w [E, K, N] arm at the recompute's full slab on the
# parent tree (the 64 x 64 WMMA tile; PERF.md, H100 80GB HBM3, 700 W),
# printed beside this run's as "was"
RECOMPUTE_WAS_DEVICE_MS = 5.013


def gmm_recompute_row(cfg, params, d, maps):
    """B7's w [E, K, N] arm (the Hopper kernel, MN-major B) with an f32
    output at the fused backward's recompute shape (one owner's slabs:
    [d * 1024, H] @ w_up [1, H, I]), over the full slab and over the
    occupied tiles of owner 0 in the fused backward's own run (``maps``,
    its recompute's tile maps): each against the plain version (dead rows
    exactly zero), the bare C call (``fm_grouped_matmul_hopper``), its
    device time (the plan and the GEMM), the bound and ``torch.mm(...,
    out_dtype=float32)`` over the rows it needs.  Returns the keys it
    adds to B7's entry."""
    g = torch.Generator(device="cuda").manual_seed(12)
    t, h, i = d * 1024, cfg.hidden_size, cfg.intermediate_size
    xr = torch.randn(t, h, device="cuda", generator=g, dtype=torch.bfloat16)
    w = params["w_up"][:1].contiguous()
    check(all(mp.numel() == t // expert.ROW_TILE for mp in maps),
          f"recompute maps of {[mp.numel() for mp in maps]} tiles, want "
          f"{t // expert.ROW_TILE}")
    lib = _build.library()
    rec = {}
    for tag, gid in (("full", torch.zeros(t // expert.ROW_TILE,
                                          dtype=torch.int32, device="cuda")),
                     ("live", maps[0].to(torch.int32))):
        rows = (gid >= 0).repeat_interleave(expert.ROW_TILE)
        n_live = int(rows.sum())
        hop = expert.grouped_matmul_cuda.hopper_launches
        got = expert.grouped_matmul_cuda(xr, gid, w, out_dtype=torch.float32)
        want = expert.grouped_matmul_plain(xr, gid, w,
                                           out_dtype=torch.float32)
        torch.cuda.synchronize()
        check(expert.grouped_matmul_cuda.hopper_launches == hop + 1,
              f"grouped_matmul recompute {tag} did not take the Hopper "
              f"kernel")
        err = check_f32(f"grouped_matmul recompute {tag}", got, want)
        check(not got[~rows].any(), f"grouped_matmul recompute {tag}: dead "
              f"rows not zero")
        del got, want
        args, _out, _plan = expert.gmm_hopper_args(
            xr, gid, w, torch.float32, transpose_w=False)
        check(lib.fm_grouped_matmul_hopper(*args) == 0,
              "fm_grouped_matmul_hopper launch")
        x_live = xr[rows].contiguous()

        def library(x_live=x_live):
            return torch.mm(x_live, w[0], out_dtype=torch.float32)

        try:
            library()
            lib_ok = True
        except (TypeError, RuntimeError, NotImplementedError) as exc:
            lib_ok = False
            print(f"grouped_matmul recompute: torch.mm takes no out_dtype "
                  f"here ({exc!r:.120})")
        r = dict(
            max_abs_err=err, tile_share=n_live / t,
            ms=cuda_ms(lambda: lib.fm_grouped_matmul_hopper(*args), 20),
            device_ms=device_ms(lambda: lib.fm_grouped_matmul_hopper(*args),
                                5, ("gmm_hopper", "gmm_plan"))[0],
            library_ms=cuda_ms(library, 20) if lib_ok else None,
            library_device_ms=device_ms(library, 5)[0] if lib_ok else None,
            plain_ms=cuda_ms(lambda: expert.grouped_matmul_plain(
                xr, gid, w, out_dtype=torch.float32), 1),
            **bound(bytes_=n_live * h * 2 + h * i * 2 + t * i * 4,
                    flops=2 * n_live * h * i))
        del x_live
        print(f"grouped_matmul recompute {tag} (the fused backward's u, g): "
              f"x [{t}, {h}] bf16 @ w [1, {h}, {i}] -> f32 on the Hopper "
              f"arm, live rows {n_live} ({r['tile_share']:.3f} of the "
              f"tiles): max_abs_err={err:.3g} (rtol = atol = {F32_TOL}) "
              f"kernel_ms={r['ms']:.4f} (bare fm_grouped_matmul_hopper, "
              f"{2 * n_live * h * i / r['ms'] / 1e9:.1f} TFLOP/s) "
              f"device_ms={fmt_ms(r['device_ms'])} (was "
              f"{RECOMPUTE_WAS_DEVICE_MS} at the full slab on the 64 x 64 "
              f"tile) bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
              f"library_ms={fmt_ms(r['library_ms'])} library_device_ms="
              f"{fmt_ms(r['library_device_ms'])} (torch.mm over the live "
              f"rows, out_dtype=float32) plain_ms={r['plain_ms']:.4f} "
              f"({gpu_line()})")
        pre = "recompute" if tag == "full" else "recompute_live"
        rec.update({f"{pre}_{k}": v for k, v in r.items()})
    return rec


def ep_train_layers(cfg, params, x, ep_times, paths):
    """This slice's layer paths at Mixtral widths over 8 virtual ranks,
    8192 tokens: the ragged layer, the tp layer, the fused backward and
    B7's recompute arm.  Returns B7's recompute keys."""
    m = mesh.local_mesh(8, device="cuda")
    base = cfg.replace(ep=8)
    ragged_layer_phase(base, params, x, m, ep_times, paths)
    torch.cuda.empty_cache()
    coll = tp_layer_phase(base, params, x, paths)
    torch.cuda.empty_cache()
    maps = fused_backward_phase(base, params, x, m, coll, paths)
    del coll
    torch.cuda.empty_cache()
    return gmm_recompute_row(cfg, params, base.ep, maps)


def mesh_gradients(tag, cfg, m, params, batch):
    """Every gradient leaf of ``value_and_grad`` over mesh ``m`` through
    the kernels, against the same mesh run on the plain versions that
    replays the kernel run's routing (one router call a rank and MoE
    layer, the remat's recompute repeating them), each within
    GRAD_NORMWISE_TOL, and non-zero where the loss reaches.  The
    backward of every path of the mesh runs here on the card: the
    ragged layer's row exchange and regroup under the blocks' remat, the
    fused layer's VJP (not rematerialised), the tp sum, and B5, B6, B7
    and B8 at this path's shapes."""
    with RoutingLog() as rk:
        _, _, gk = transformer.value_and_grad(params, batch, cfg, mesh=m)
    torch.cuda.synchronize()
    ranks = len(m.ranks)
    with ReplayRouting(rk.calls, cfg.expert_top_k,
                       len(cfg.moe_layer_indices) * ranks) as rp:
        _, _, gp = transformer.value_and_grad(params, batch, cfg,
                                              use_kernels=False, mesh=m)
    torch.cuda.synchronize()
    check(rp.n == len(rk.calls) >= len(cfg.moe_layer_indices) * ranks,
          f"{tag}: {len(rk.calls)} router calls with the kernels, {rp.n} "
          f"replayed")
    check(rp.gap <= SERVE_NEAR_TIE,
          f"{tag}: a routing flip between kernels and plain is no near tie "
          f"(probability gap {rp.gap})")
    names = leaf_names(params)
    got = dict(zip(names, tree_leaves(gk)))
    want = dict(zip(names, tree_leaves(gp)))
    del gk, gp
    for li in range(cfg.num_layers):
        for leaf in ("wq", "wo", "moe.gate_w", "moe.w_gate", "moe.w_up",
                     "moe.w_down"):
            check(float(got[f"layers[{li}].{leaf}"].float().abs().max()) > 0,
                  f"{tag}: gradient layers[{li}].{leaf} is zero")
    errs = grad_agreement(f"{tag} gradients", got, want)
    worst = sorted(errs.items(), key=lambda kv: -kv[1])[:6]
    print(f"{tag}: {len(errs)} gradient leaves of value_and_grad over the "
          f"mesh vs the plain versions on the same mesh with the kernels' "
          f"routing replayed, normwise max "
          + " ".join(f"{name}={v:.3g}" for name, v in worst)
          + f" (tol {GRAD_NORMWISE_TOL}); plain routing would have flipped "
          f"{rp.flips} (layer, rank, token) choices, largest gap "
          f"{rp.gap:.3g} (tol {SERVE_NEAR_TIE})")


def train_state(cfg, opt):
    """The train phases' initial state and batch (4 x 257 tokens), made
    from seed 3 on the card: the same values at every call."""
    g = torch.Generator(device="cuda").manual_seed(3)
    state = trainer.init_state(g, cfg, opt)
    tokens = torch.randint(0, cfg.vocab_size, (4, 257), device="cuda",
                           generator=g)
    return state, {"tokens": tokens}


def step_losses(step, state, batch, n=3) -> list[float]:
    """The losses of ``n`` train steps from ``state``."""
    losses = []
    for _ in range(n):
        state, mt = step(state, batch)
        losses.append(float(mt["loss"]))
    return losses


def ep_train_phase(one_device_loss, paths):
    """``make_train_step`` over a local mesh at Mixtral-8x7B's widths, 2
    layers, bf16, AdamW, the train phase's state and batch, each with
    the ragged layer (ep 8), the fused layer (ep 8) and the collective
    layer at ep 4 x tp 2 (:func:`mesh_train`, gradients included).
    Returns :func:`train_reference`'s config, optimizer and losses."""
    cfg, opt, ref = train_reference()
    for name, ep_, tp_, backend in (("ragged", 8, 1, "ragged"),
                                    ("fused", 8, 1, "fused"),
                                    ("collective tp", 4, 2, "collective")):
        mesh_train(f"ep train {name}", cfg, opt,
                   cfg.replace(ep=ep_, tp=tp_, moe_backend=backend),
                   mesh.local_mesh(ep_, tp=tp_, device="cuda"),
                   one_device_loss, ref, paths)
    return cfg, opt, ref


def train_reference():
    """The mesh train runs' config (Mixtral-8x7B's widths, 2 layers,
    bf16), optimizer, and the one-device losses of three steps without
    the load-balancing loss."""
    cfg = presets.mixtral_8x7b(num_layers=2, param_dtype=torch.bfloat16,
                               is_training=True)
    opt = trainer.make_optimizer(cfg, warmup_steps=1, total_steps=3)
    no_aux = cfg.replace(aux_loss_coef=0.0)
    state, batch = train_state(no_aux, opt)
    ref = step_losses(trainer.make_train_step(no_aux, opt), state, batch)
    del state
    torch.cuda.empty_cache()
    return cfg, opt, ref


def mesh_desc(m) -> str:
    return " ".join(f"{a}={n}" for a, n in m.shape.items()
                    if n > 1 or a == "ep")


def mesh_train(tag, cfg, opt, ecfg, m, one_device_loss, ref, paths, *,
               gradients=True):
    """``make_train_step(ecfg, opt, mesh=m)`` from the train phase's state
    and batch:

    - with ``gradients``, at the initial weights every gradient over the
      mesh against a plain run replaying the routing
      (:func:`mesh_gradients`);
    - three steps (counts reset before the first, read after it as path
      ``tag``): losses finite, step 0's within 1e-2 of the one-device
      step's, the step time on the host clock and on the device, the
      idle share and the peak memory;
    - three steps without the load-balancing loss against the one-device
      steps without it (``ref``), each loss within 1e-2.  Over a mesh
      that loss is the mean of the ranks' own (as in the JAX package),
      not the one-device function; without it the mesh computes the
      one-device loss, so step 2 (the first after a real update: warm-up
      makes the first update zero) holds the mesh's gradients and
      optimizer update against one device's."""
    state, batch = train_state(cfg, opt)
    step = trainer.make_train_step(ecfg, opt, mesh=m)
    if gradients:
        mesh_gradients(tag, ecfg, m, state.params, batch)
        torch.cuda.empty_cache()
    losses, step_ms = [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(3):
        if i == 0:
            reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, mt = step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            counts = path_counts(tag, paths)
            ce0, aux0 = float(mt["ce"]), float(mt["aux"])
        losses.append(float(mt["loss"]))
        check(math.isfinite(losses[-1]), f"{tag} step {i}: loss "
              f"{losses[-1]}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    rel0 = abs(losses[0] - one_device_loss) / abs(one_device_loss)
    check(rel0 <= BF16_NORMWISE_TOL,
          f"{tag}: step 0 loss {losses[0]} vs one device "
          f"{one_device_loss} (relative {rel0})")
    dev, n_k = device_breakdown(f"{tag} step",
                                lambda: step(state, batch), top_n=10)
    host = min(step_ms[1:])
    idle = "not measured" if dev is None else f"{1 - dev / host:.1%}"
    del state, step
    torch.cuda.empty_cache()
    no_aux = cfg.replace(aux_loss_coef=0.0)
    state, batch = train_state(no_aux, opt)
    got = step_losses(trainer.make_train_step(
        ecfg.replace(aux_loss_coef=0.0), opt, mesh=m), state, batch)
    del state
    torch.cuda.empty_cache()
    rel = [abs(a - b) / abs(b) for a, b in zip(got, ref)]
    check(all(r <= BF16_NORMWISE_TOL for r in rel),
          f"{tag}: losses without the load-balancing loss {got} vs one "
          f"device {ref} (relative {rel})")
    print(f"{tag}: mixtral_8x7b layers=2 B=4 T=257 {mesh_desc(m)} "
          f"moe_backend={ecfg.moe_backend}: "
          f"losses={[round(v, 5) for v in losses]}"
          f" step0 ce={ce0:.5f} aux={aux0:.5f} vs one device loss "
          f"{one_device_loss:.5f} (relative {rel0:.3g}, tol "
          f"{BF16_NORMWISE_TOL}); without the load-balancing loss "
          f"losses={[round(v, 5) for v in got]} vs one device "
          f"{[round(v, 5) for v in ref]} (relative "
          f"{[float(f'{v:.3g}') for v in rel]}, tol {BF16_NORMWISE_TOL})"
          f" train_step_ms={[round(v, 3) for v in step_ms]} "
          f"device_ms={fmt_ms(dev)} idle_share={idle} "
          f"peak_memory_GB={peak:.2f} launches={counts} ({gpu_line()})")


# ----------------------------------------------------------------------
# the mesh's other axes: sp (ring attention), dp, pp (the pipeline)
# ----------------------------------------------------------------------

def axes_forward_phase(cfg, params, paths):
    """sp forward: ``forward`` over dp 2 x ep 2 x sp 2 (8 virtual ranks;
    ring attention over sp, the MoE tokens over (dp, ep, sp)) at Mixtral
    widths, 4 layers, B 2 x T 4096, with the collective backend and the
    fused one (one B5 world per (dp, sp) fibre), each against the
    one-device forward (B9 at T 4096) by the ep forward's rule, its flips
    held first-order; then ring attention alone (:func:`ring_row`)."""
    g = torch.Generator(device="cuda").manual_seed(6)
    b, t = 2, 4096
    tokens = torch.randint(0, cfg.vocab_size, (b, t), device="cuda",
                           generator=g)
    with torch.no_grad(), RoutingLog() as one:
        want, _ = transformer.forward(params, tokens, cfg)
    m = mesh.make_mesh(dp=2, ep=2, sp=2, device="cuda")
    # the fused layer routes fibre by fibre: the rank of each call
    order = [i for fib in m.fibres("ep") for i in fib]
    n, r = cfg.num_layers, m.size
    for backend in ("collective", "fused"):
        ecfg = cfg.replace(dp=2, ep=2, sp=2, moe_backend=backend)
        tag = f"axes sp forward {backend}"

        def fwd():
            with torch.no_grad():
                return transformer.forward(params, tokens, ecfg, mesh=m)[0]

        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with RoutingLog() as rl:
            got = fwd()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() / 1e9
        counts = path_counts(tag, paths)
        fused_on = backend == "fused"
        check(counts["gate"] == r * n and counts["flash_attention"] == 0
              and counts["fused_ep"] == (4 * n if fused_on else 0)
              and counts["grouped_ffn"] == (0 if fused_on else r * n),
              f"{tag} launches {counts}")
        if fused_on:
            rl.calls = [rl.calls[j + order.index(k)]
                        for j in range(0, len(rl.calls), r)
                        for k in range(r)]
        rows = (torch.linalg.vector_norm(got - want, dim=-1)
                / torch.linalg.vector_norm(want, dim=-1))
        excused, n_flips, gap, gap_first = serve_flips(cfg, rl, one, b,
                                                       ranks=r)
        held = rows[~excused]
        med = float(rows.median())
        worst = float(held.max()) if held.numel() else 0.0
        check(bool(torch.isfinite(got).all()) and got.shape == want.shape,
              f"{tag}: finite logits of {tuple(want.shape)}")
        # 8192 tokens a layer: a near-tie flip is likely somewhere, and
        # the flipped token's own later layers then route apart at any
        # gap, so only first-order flips are held to the near-tie bound
        # (the serve phase's rule for the 32-layer int8 store)
        check(med <= SERVE_MEDIAN_TOL and worst <= SERVE_ROW_TOL
              and gap_first <= SERVE_NEAR_TIE,
              f"{tag} vs one device: median {med}, max without a flip "
              f"{worst}, largest first-order flip gap {gap_first}")
        dev, _ = device_breakdown(tag, fwd)
        idle = "not measured" if dev is None else f"{1 - dev / ms:.1%}"
        print(f"{tag}: mixtral_8x7b layers={n} B={b} T={t} {mesh_desc(m)} "
              f"(local mesh) forward_ms={ms:.3f} device_ms={fmt_ms(dev)} "
              f"idle_share={idle} peak_memory_GB={peak:.2f} logits vs one "
              f"device: median_normwise={med:.3g} (tol {SERVE_MEDIAN_TOL}) "
              f"max_normwise={float(rows.max()):.3g} "
              f"max_normwise_without_flip={worst:.3g} (tol {SERVE_ROW_TOL}) "
              f"rows_after_a_flip={int(excused.sum())}/{rows.numel()} "
              f"routing_flips={n_flips} largest_flip_gap={gap:.3g} "
              f"first-order flips {gap_first:.3g} (tol {SERVE_NEAR_TIE}) "
              f"launches={counts} ({gpu_line()})")
        del got
    del want
    torch.cuda.empty_cache()
    ring_row()


def ring_row():
    """``ring_attention`` alone at [2, 32, 4096, 128] bf16 over sp 4
    against the plain attention in f32 (normwise, BF16_NORMWISE_TOL),
    timed beside B9 and SDPA on the same inputs (plain torch: the JAX
    package's ring blocks are einsums, no kernel)."""
    g = torch.Generator(device="cuda").manual_seed(9)
    q, k, v = (torch.randn(2, 32, 4096, 128, device="cuda", generator=g,
                           dtype=torch.bfloat16) for _ in range(3))
    m = mesh.make_mesh(sp=4, device="cuda")
    with torch.no_grad():
        got = ringattn.ring_attention(q, k, v, m)
        want = attention.attention_plain(q.float(), k.float(), v.float())
        b9 = attention.flash_attention_cuda(q, k, v)
        torch.cuda.synchronize()
        err, b9_err = normwise(got, want), normwise(b9, want)
        del want
        torch.cuda.empty_cache()
        check(err <= BF16_NORMWISE_TOL,
              f"ring attention vs plain f32: normwise {err}")
        ring_ms = cuda_ms(lambda: ringattn.ring_attention(q, k, v, m), 5)
        b9_ms = cuda_ms(lambda: attention.flash_attention_cuda(q, k, v), 20)
        sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True), 20)
        b, n, t, d = q.shape
        bnd = bound(bytes_=2 * 4 * b * n * t * d,
                    flops=4 * b * n * d * t * (t + 1) / 2)
    print(f"ring_attention [{b}, {n}, {t}, {d}] bf16 causal sp=4 (local "
          f"mesh): normwise_err={err:.3g} vs plain f32 (tol "
          f"{BF16_NORMWISE_TOL}; B9 {b9_err:.3g}) ring_ms={ring_ms:.3f} "
          f"b9_ms={b9_ms:.3f} sdpa_ms={sdpa_ms:.3f} bound_ms="
          f"{bnd['bound_ms']:.4f} ({bnd['bound_by']}) ({gpu_line()})")


def axes_train_phase(cfg, opt, ref, one_device_loss, paths):
    """The mesh's train paths at Mixtral widths, 2 layers, bf16, the
    train phase's state and batch (4 x 257 tokens):

    - sp and dp backward: ``value_and_grad`` over dp 2 x ep 2 x sp 2
      (ring attention's backward through autograd), every gradient leaf
      against a plain run replaying the routing (:func:`mesh_gradients`),
      timed and profiled;
    - dp train: ``make_train_step`` over dp 2 x ep 4, collective and
      fused (:func:`mesh_train`);
    - pp: :func:`pp_phase`."""
    ecfg = cfg.replace(dp=2, ep=2, sp=2)
    m = mesh.make_mesh(ecfg, device="cuda")
    tag = "axes sp backward"
    state, batch = train_state(cfg, opt)
    reset_counts()
    mesh_gradients(tag, ecfg, m, state.params, batch)
    counts = path_counts(tag, paths)

    def vg():
        return transformer.value_and_grad(state.params, batch, ecfg, mesh=m)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    vg()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vg()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 1e9
    dev, _ = device_breakdown(tag, vg, top_n=10)
    idle = "not measured" if dev is None else f"{1 - dev / ms:.1%}"
    print(f"{tag}: mixtral_8x7b layers=2 B=4 T=257 {mesh_desc(m)}: "
          f"value_and_grad_ms={ms:.3f} device_ms={fmt_ms(dev)} "
          f"idle_share={idle} peak_memory_GB={peak:.2f} launches={counts} "
          f"({gpu_line()})")
    del state
    torch.cuda.empty_cache()
    for backend in ("collective", "fused"):
        dcfg = cfg.replace(dp=2, ep=4, moe_backend=backend)
        mesh_train(f"axes dp train {backend}", cfg, opt, dcfg,
                   mesh.make_mesh(dcfg, device="cuda"), one_device_loss,
                   ref, paths, gradients=False)
    pp_phase(paths)


def pp_phase(paths):
    """``pipeline_loss`` over pp 2 x ep 2 x dp 2 at Mixtral widths, 4
    layers, bf16, dropless, 2 microbatches, batch 8 x 257, GPipe and
    interleaved (2 chunks a stage):

    - ce within 1e-2 of ``loss_fn`` on one device, the lm head run once a
      microbatch;
    - with the aux and z coefficients at 0 (then the pipeline loss is the
      plain loss) the loss and its gradient through the kernels (counts
      reset before, read after): the loss within 1e-2 of one device's
      ce, every gradient leaf within GRAD_NORMWISE_TOL of the same
      pipeline on the plain versions replaying the kernel run's routing;
      the forward+backward timed on the host clock and profiled, with
      its peak memory."""
    cfg = presets.mixtral_8x7b(num_layers=4, param_dtype=torch.bfloat16,
                               is_training=True, drop_tokens=False)
    g = torch.Generator(device="cuda").manual_seed(5)
    params = transformer.init_params(g, cfg, device="cuda")
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (8, 257),
                                     device="cuda", generator=g)}
    with torch.no_grad():
        _, one = transformer.loss_fn(params, batch, cfg)
    ce1 = float(one["ce"])
    pcfg = cfg.replace(pp=2, ep=2, dp=2)
    zero = pcfg.replace(aux_loss_coef=0.0, router_z_loss_coef=0.0)
    m = mesh.make_mesh(pcfg, device="cuda")
    mb = 2
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    wrt = tree_leaves(leaves)
    names = leaf_names(params)
    del params
    for v in (1, 2):
        tag = f"axes pp {'gpipe' if v == 1 else 'interleaved'}"
        calls = pipeline.lm_head_ce.calls
        with torch.no_grad():
            _, met = pipeline.pipeline_loss(leaves, batch, pcfg, m,
                                            num_microbatches=mb,
                                            interleave=v)
        check(pipeline.lm_head_ce.calls - calls == mb,
              f"{tag}: lm head ran {pipeline.lm_head_ce.calls - calls} "
              f"times for {mb} microbatches")
        ce = float(met["ce"])
        rel = abs(ce - ce1) / abs(ce1)
        check(rel <= BF16_NORMWISE_TOL,
              f"{tag}: ce {ce} vs one device {ce1} (relative {rel})")

        def loss_grad(use_kernels=None):
            loss, _ = pipeline.pipeline_loss(
                leaves, batch, zero, m, num_microbatches=mb, interleave=v,
                use_kernels=use_kernels)
            return loss.detach(), torch.autograd.grad(loss, wrt)

        reset_counts()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        calls = pipeline.lm_head_ce.calls
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with RoutingLog() as rk:
            loss_k, gk = loss_grad()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() / 1e9
        counts = path_counts(tag, paths)
        check(pipeline.lm_head_ce.calls - calls == mb,
              f"{tag}: lm head ran {pipeline.lm_head_ce.calls - calls} "
              f"times in the training call")
        rel_l = abs(float(loss_k) - ce1) / abs(ce1)
        check(rel_l <= BF16_NORMWISE_TOL,
              f"{tag}: loss without aux and z {float(loss_k)} vs one "
              f"device ce {ce1} (relative {rel_l})")
        # one router call a (dp, ep) rank, layer and microbatch in the
        # forward; the remat's recompute repeats them
        with ReplayRouting(rk.calls, cfg.expert_top_k,
                           cfg.num_layers * mb * 4) as rp:
            _, gp = loss_grad(use_kernels=False)
        check(rp.n == len(rk.calls), f"{tag}: {len(rk.calls)} router calls "
              f"with the kernels, {rp.n} replayed")
        check(rp.gap <= SERVE_NEAR_TIE,
              f"{tag}: a routing flip between kernels and plain is no near "
              f"tie (probability gap {rp.gap})")
        errs = grad_agreement(f"{tag} gradients", dict(zip(names, gk)),
                              dict(zip(names, gp)))
        del gk, gp
        torch.cuda.empty_cache()
        worst = sorted(errs.items(), key=lambda kv: -kv[1])[:4]
        dev, _ = device_breakdown(f"{tag} loss+grad", loss_grad, top_n=10)
        idle = "not measured" if dev is None else f"{1 - dev / ms:.1%}"
        print(f"{tag}: mixtral_8x7b layers=4 B=8 T=257 {mesh_desc(m)} "
              f"interleave={v} microbatches={mb} dropless: ce={ce:.5f} vs "
              f"one device {ce1:.5f} (relative {rel:.3g}, tol "
              f"{BF16_NORMWISE_TOL}); aux=z=0 loss={float(loss_k):.5f} "
              f"(relative {rel_l:.3g}); {len(errs)} gradient leaves vs the "
              f"plain pipeline replaying the routing, normwise max "
              + " ".join(f"{k}={e:.3g}" for k, e in worst)
              + f" (tol {GRAD_NORMWISE_TOL}), plain routing would have "
              f"flipped {rp.flips} choices (gap {rp.gap:.3g}); "
              f"lm_head_calls={mb} loss_grad_ms={ms:.3f} "
              f"device_ms={fmt_ms(dev)} idle_share={idle} "
              f"peak_memory_GB={peak:.2f} launches={counts} ({gpu_line()})")
    del leaves, wrt
    torch.cuda.empty_cache()


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


def engine_quant_run(tag, cfg, params, prompt, tokens, paths):
    """The engine on a quantized store: ``prompt``'s rows as greedy
    requests arriving at once, against ``generate``'s ``tokens`` on them
    (one batch, run again with its routing logged: the same tokens); the
    store's freed bytes as extra KV pages.  Then ``generate`` replaying
    the engine run's routing, and the engine replaying it too and forced
    to that run's tokens (``forced_match``)."""
    b, t0 = prompt.shape
    glog = EngineLog(cfg, rids=range(b))
    with glog:
        again = generate.generate(params, prompt, cfg,
                                  max_new_tokens=tokens.shape[1] - t0)
    check(torch.equal(again, tokens), f"{tag}: generate ran twice gave "
          f"other tokens")
    reqs = [serving.Request(rid=i, prompt=tuple(prompt[i].tolist()),
                            max_new_tokens=tokens.shape[1] - t0,
                            seed=100 + i) for i in range(b)]
    kw = dict(ENGINE_SERVE, max_batch=b,
              max_pages_per_slot=slot_pages(reqs, ENGINE_SERVE))
    kw["num_pages"] = b * kw["max_pages_per_slot"] + 1
    out, eng, log, _ = engine_run(tag, cfg, params, reqs, [0] * b, paths,
                                  **kw)
    info = eng.quant_info
    check(info is not None and info["extra_kv_pages"] > 0,
          f"{tag}: quant_info {info}")
    print(f"{tag}: expert_quant={info['expert_quant']} freed_GB="
          f"{info['freed_bytes'] / 1e9:.3f} page_bytes={info['page_bytes']} "
          f"extra_kv_pages={info['extra_kv_pages']} (pool of "
          f"{kw['num_pages']}) ({gpu_line()})")
    near_tie_match(tag, out, {i: tokens[i].tolist() for i in range(b)},
                   reqs, log, glog,
                   "generate() on the prompts as one batch")
    # both again, routing as this run did
    del eng
    rgen = EngineLog(cfg, rids=range(b), replay=log.routes())
    with rgen:
        again = generate.generate(params, prompt, cfg,
                                  max_new_tokens=tokens.shape[1] - t0)
    engine_replayed(tag, cfg, params, reqs, [0] * b,
                    ({i: again[i].tolist() for i in range(b)}, rgen),
                    "generate() replayed on the prompts as one batch",
                    **kw)


def quant_serve_phase(cfg, params, tag, paths):
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
    if cfg.num_layers == 32:
        engine_quant_run(f"engine {cfg.expert_quant} 32 layers", cfg,
                         params, prompt, tokens, paths)
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
    m = mesh.local_mesh(8, device="cuda")
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


def quant_phase(paths):
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
        quant_serve_phase(cfg, params, f"serve {qname}", paths)
        if layers > 4:
            params["layers"] = params["layers"][:4]
            cfg = cfg.replace(num_layers=4)
            torch.cuda.empty_cache()
        counts = ep_forward_phase(cfg, params)["fused"]
        launches[f"fused_ep_{qname}"] = counts[f"fused_ep_{qname}"]
        g = torch.Generator(device="cuda").manual_seed(23)
        moe0 = params["layers"][0]["moe"]
        x = torch.randn(1024, cfg.hidden_size, device="cuda", generator=g,
                        dtype=torch.bfloat16)
        entries.append(fused_kernel_row(
            f"{qname} ep forward shapes",
            cfg.replace(ep=8, moe_backend="fused"), moe0, x,
            mesh.local_mesh(8, device="cuda"), 10))
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


def all_counts():
    """:func:`launch_counts` and the grouped matmul's Hopper launches."""
    counts = launch_counts()
    counts["grouped_matmul_hopper"] = \
        expert.grouped_matmul_cuda.hopper_launches
    return counts


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
    # the router's backward recomputes router_plain on the forward's
    # inputs: the tokens whose recomputed top-k differs from B4a's ids
    pid = gate.router_plain(x, params["gate_w"],
                            cfg.replace(is_training=True)).expert_idx
    kid = rk.expert_idx
    in_order = int((kid != pid).any(-1).sum())
    as_sets = int((kid.sort(-1).values != pid.sort(-1).values).any(-1).sum())
    print(f"many_expert training backward: router_plain's recomputed top-k "
          f"differs from B4a's ids on {in_order} of {x.shape[0]} tokens "
          f"({in_order / x.shape[0]:.3g}) in order, {as_sets} "
          f"({as_sets / x.shape[0]:.3g}) as sets")
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


# ----------------------------------------------------------------------
# the serving engine (flashmoe_tpu_torch/serving/)
# ----------------------------------------------------------------------

# the engine's shape at Mixtral widths: 8 slots, 16-token pages, prompts
# padded to 128 (the flash kernel's tile), gathers bucketed by 8 pages
ENGINE_SERVE = dict(max_batch=8, page_size=16, prompt_bucket=128,
                    ctx_bucket_pages=8)
ENGINE_SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.9)
ENGINE_KERNELS = ("gate", "grouped_ffn", "flash_attention")
PATH_KERNELS.update({
    "engine mixed": ENGINE_KERNELS,
    "engine gather_fused": ("gate", "grouped_ffn_tokens", "flash_attention"),
    "engine starved": ENGINE_KERNELS,
    # every prompt of the chunked run is longer than one chunk: its
    # prefill is paged chunks, no whole-prompt flash attention
    "engine chunked": ("gate", "grouped_ffn"),
    "engine whole prefill": ENGINE_KERNELS,
    "engine speculative": ENGINE_KERNELS,
    "engine non-speculative": ENGINE_KERNELS,
    "engine ep 8": ENGINE_KERNELS,
    "engine int8 32 layers": ENGINE_KERNELS,
    "engine cli": ENGINE_KERNELS,
})


class EngineLog:
    """While active, records what decides an engine's (or ``generate``'s)
    tokens, per request:

    * ``logits[(rid, j)]``: the logits new token j was decided from (the
      last decision of that token wins: an evicted request's resumption,
      a rejected draft's position sampled again);
    * :meth:`routes`: {(rid, position, MoE layer): (top-k ids, the gap of
      the k-th and (k+1)-th gate probabilities)} of every prompt and
      decode position, from a RoutingLog and the rows of each device
      step in flight (the engine's slots; ``rids``, ``generate``'s
      batch).

    ``engine`` is the engine driven (its requests' seeds are their rids'
    keys: a trace seeds each request on its own).

    With ``replay`` (another log's :meth:`routes`) every MoE layer's router
    is the plain one made to route each row keyed (rid, position, layer)
    as ``replay`` records, and a row it does not key (a pad row, a
    speculative column past the recorded positions) by its own top-k:
    two runs replaying one record route alike by construction, so their
    logits differ by rounding alone.  ``replayed`` / ``unkeyed`` count
    the rows of each kind.  With ``force`` ({rid: new tokens}) the
    sampler returns those tokens, and ``own[(rid, j)]`` keeps its own
    pick: a run forced to another's tokens decides every token from the
    same history as that run."""

    STEPS = ("_prefill_padded", "_prefill_chunk", "_paged_decode_step",
             "_paged_verify_step", "_ep_decode_step", "_ep_verify_step")

    def __init__(self, cfg, engine=None, reqs=(), rids=(), replay=None,
                 force=None):
        self.k, self.n_layers = cfg.expert_top_k, len(cfg.moe_layer_indices)
        self.engine, self.rids, self.replay = engine, list(rids), replay
        self.force, self.own = force, {}
        reqs = list(reqs)
        self.seed_rid = {r.seed: r.rid for r in reqs}
        check(len(self.seed_rid) == len(reqs),
              "EngineLog: two requests share a seed")
        self.prompts = [(list(r.prompt), r.rid) for r in reqs]
        self.logits, self.marks = {}, []
        self.replayed = self.unkeyed = 0

    def _decided(self, keys, logits, picks):
        """Record the logits of each key's decision; returns the tokens:
        ``picks`` (this run's), or the forced ones."""
        for i, key in enumerate(keys):
            self.logits[key] = logits[i].float()
        if self.force is None:
            return picks
        own = picks.tolist()
        out = []
        for key, o in zip(keys, own):
            self.own[key] = o
            new = self.force[key[0]]
            out.append(new[key[1]] if key[1] < len(new) else o)
        return torch.tensor(out, dtype=picks.dtype,
                            device=picks.device).reshape(picks.shape)

    def _mark(self, rows):
        """A device step starts over ``rows``: its router calls walk them
        layer by layer (a list: [rows, cursor, layer])."""
        self.marks.append((len(self.routing.calls), rows))
        self._live = [rows, 0, 0]

    def _replayed_router(self, x, gate_w, cfg, use_kernels=None):
        rows, cursor, layer = self._live
        keys = rows[cursor:cursor + x.shape[0]]
        self._live[1] += x.shape[0]
        if self._live[1] == len(rows):
            self._live[1:] = [0, layer + 1]
        logits = reference.dot_f32(x, gate_w)
        probs = torch.softmax(logits, -1)
        ids = reference.top_k_lowest_index(probs, self.k)[1].tolist()
        for i, key in enumerate(keys):
            got = None if key is None else self.replay.get((*key, layer))
            if got is None:
                self.unkeyed += 1
            else:
                ids[i] = list(got[0])
                self.replayed += 1
        ids = torch.tensor(ids, device=x.device)
        counts = torch.bincount(ids.reshape(-1), minlength=cfg.num_experts)
        zsum = torch.sum(torch.square(torch.logsumexp(logits, -1)))
        return gate._finish(cfg, probs.gather(-1, ids), ids, probs.sum(0),
                            counts, zsum, x.shape[0])

    def __enter__(self):
        if self.replay is not None:
            self._router = moe.router
            for mod in RoutingLog.MODULES:
                mod.router = self._replayed_router
        self.routing = RoutingLog().__enter__()
        self._saved = {n: getattr(serving, n) for n in self.STEPS}
        self._saved_gen = (generate.prefill_batched, generate._decode_step,
                           generate.sample_tokens)
        self._sample = serving._sample_dynamic

        def sample(logits, seeds, indices, temps, top_ks, top_ps):
            scores = serving._sample_scores(logits, seeds, indices, temps,
                                            top_ks, top_ps)
            return self._decided([(self.seed_rid[s], j)
                                  for s, j in zip(seeds, indices)], logits,
                                 torch.argmax(scores, dim=-1))

        def step(name):
            def spy(*a, **kw):
                self._mark(self._rows(name, a))
                return self._saved[name](*a, **kw)
            return spy

        def gen_prefill(params, cfg, x, cache, *a, **kw):
            self._gen_step = 0
            self._mark([(r, t) for r in self.rids for t in range(x.shape[1])])
            return self._saved_gen[0](params, cfg, x, cache, *a, **kw)

        def gen_decode(params, cfg, x, cache, pos, *a, **kw):
            self._mark([(r, pos) for r in self.rids])
            return self._saved_gen[1](params, cfg, x, cache, pos, *a, **kw)

        def gen_sample(logits, *a, **kw):
            check(kw.get("temperature", 0.0) == 0.0,
                  "EngineLog: generate is logged greedy only")
            keys = [(r, self._gen_step) for r in self.rids]
            self._gen_step += 1
            return self._decided(keys, logits,
                                 self._saved_gen[2](logits, *a, **kw))

        serving._sample_dynamic = sample
        for n in self.STEPS:
            setattr(serving, n, step(n))
        (generate.prefill_batched, generate._decode_step,
         generate.sample_tokens) = gen_prefill, gen_decode, gen_sample
        return self

    def __exit__(self, *exc):
        serving._sample_dynamic = self._sample
        for n, f in self._saved.items():
            setattr(serving, n, f)
        (generate.prefill_batched, generate._decode_step,
         generate.sample_tokens) = self._saved_gen
        self.routing.__exit__(*exc)
        if self.replay is not None:
            for mod in RoutingLog.MODULES:
                mod.router = self._router

    def _rows(self, name, a):
        """(rid, position) of each row of the step ``name`` is about to
        run, None for pad and idle rows; a whole prefill's request is the
        one whose prompt its tokens start with (a resumed request's prompt
        carries its delivered tokens after the original's)."""
        eng = self.engine
        if name == "_prefill_padded":
            t_pad, true_len = a[2].shape[1], a[3]
            toks = a[2][0, :true_len].tolist()
            rid = [r for p, r in self.prompts if toks[:len(p)] == p]
            check(len(rid) == 1, f"EngineLog: a prefill of {true_len} "
                  f"tokens matches the prompts of requests {rid}")
            return [(rid[0], t) if t < true_len else None
                    for t in range(t_pad)]
        if name == "_prefill_chunk":
            start, c = a[7], a[4].shape[1]
            s = next(s for s in eng.slots
                     if s is not None and s.prefill_pos == start)
            return [(s.orig.rid, start + t)
                    if start + t < len(s.req.prompt) else None
                    for t in range(c)]
        toks = a[-3]
        t_span = toks.shape[1] if toks.dim() == 2 else 1
        return [(s.orig.rid, s.length + t)
                if s is not None and s.prefill_pos is None else None
                for s in eng.slots for t in range(t_span)]

    def routes(self):
        calls = self.routing.calls
        out = {}
        for i, (start, rows) in enumerate(self.marks):
            end = (self.marks[i + 1][0] if i + 1 < len(self.marks)
                   else len(calls))
            cursor, layer = 0, 0
            for ids, probs in calls[start:end]:
                ids = ids.sort(-1).values.tolist()
                top = probs.sort(-1, descending=True).values
                gaps = (top[:, self.k - 1] - top[:, self.k]).tolist()
                for j, key in enumerate(rows[cursor:cursor + len(ids)]):
                    if key is not None:
                        out[(*key, layer)] = (tuple(ids[j]), gaps[j])
                cursor += len(ids)
                if cursor == len(rows):
                    cursor, layer = 0, layer + 1
            check(cursor == 0 and layer == self.n_layers,
                  f"routing of a step: {layer} layers and {cursor} rows left")
        return out


def engine_trace(cfg, n=16, seed=40, prompt_lens=(64, 512),
                 new=(16, 32), sampled=True):
    """The engine's request trace: ``n`` requests with prompt lengths and
    new-token counts drawn from ``seed``, one pair arriving every 2
    steps, every second request sampled (ENGINE_SAMPLED) when
    ``sampled``, request i seeded 100 + i."""
    g = torch.Generator().manual_seed(seed)
    lens = torch.randint(prompt_lens[0], prompt_lens[1] + 1, (n,),
                         generator=g).tolist()
    news = torch.randint(new[0], new[1] + 1, (n,), generator=g).tolist()
    reqs = [serving.Request(
        rid=i, prompt=tuple(torch.randint(0, cfg.vocab_size, (lens[i],),
                                          generator=g).tolist()),
        max_new_tokens=news[i], seed=100 + i,
        **(ENGINE_SAMPLED if sampled and i % 2 else {}))
        for i in range(n)]
    return reqs, [(i // 2) * 2 for i in range(n)]


def slot_pages(reqs, serve_kw) -> int:
    """The slot context (in pages) the trace's longest lifetime needs."""
    longest = max(len(r.prompt) + r.max_new_tokens for r in reqs)
    return (prompt_pad(longest, serve_kw["prompt_bucket"])
            // serve_kw["page_size"])


def engine_counts(name, paths, gather=False):
    """path_counts for an engine run, plus serve_run's check that no
    training, many-expert or fused kernel and not the other FFN ran."""
    counts = path_counts(name, paths)
    other = "grouped_ffn" if gather else "grouped_ffn_tokens"
    check(not any(counts[k] for k in (*TRAIN_KERNELS, other, "gate_pass1",
                                      "gate_pass2", *EP_KERNELS,
                                      *QUANT_KERNELS)),
          f"{name}: unexpected launches {counts}")
    return counts


def engine_run(tag, cfg, params, reqs, arrivals, paths=None, *,
               log=True, ep_mesh=None, replay=None, force=None,
               **serve_kw):
    """Drive one engine over ``reqs`` (counts reset before, read after as
    path ``tag`` when ``paths`` is given), every request completed; print
    its serving metrics.  ``replay`` / ``force``: the EngineLog's routing
    record to replay and tokens to force.  Returns (outputs, engine, its
    EngineLog or None, flight records)."""
    mx, rec = Metrics(), FlightRecorder(capacity=100_000)
    eng = serving.ServingEngine(params, cfg, serving.ServeConfig(**serve_kw),
                                metrics_obj=mx, recorder=rec, mesh=ep_mesh)
    reset_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    elog = (EngineLog(cfg, eng, reqs, replay=replay, force=force) if log
            else None)
    if elog is not None:
        with elog:
            out = eng.run(reqs, arrivals)
    else:
        out = eng.run(reqs, arrivals)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = (engine_counts(tag, paths, bool(cfg.gather_fused))
              if paths is not None else None)
    s = eng.summary()
    check(s["completed"] == len(reqs) and len(out) == len(reqs)
          and all(len(out[r.rid]) == len(r.prompt) + r.max_new_tokens
                  for r in reqs),
          f"{tag}: {s['completed']} of {len(reqs)} requests completed")
    ttft, step = mx.sketches["serve.ttft_ms"], mx.sketches["serve.step_ms"]
    print(f"{tag}: requests={len(reqs)} max_active={s['max_active']} "
          f"steps={s['steps']} tokens={s['tokens']} wall_s={wall:.3f} "
          f"tokens_per_s={s['tokens'] / wall:.1f} ttft_ms_p50="
          f"{ttft.quantile(0.5):.2f} ttft_ms_p99={ttft.quantile(0.99):.2f} "
          f"tpot_ms_mean={s['tpot_ms_mean']:.2f} step_ms_mean="
          f"{step.mean:.2f} step_ms_max={step.max:.2f} evictions="
          f"{s['evictions']} peak_occupancy={s['peak_occupancy']:.3f} "
          f"decode_buckets={s['decode_buckets']} prefill_buckets="
          f"{s['prefill_buckets']} logged={log} launches={counts} "
          f"({gpu_line()})")
    return out, eng, elog, rec.records


def generate_alone(cfg, params, reqs, replay=None, force=None):
    """``generate`` on each request's prompt alone (greedy), logged
    (replaying the routing record ``replay``, forced to the tokens
    ``force``).  Returns ({rid: prompt + new tokens}, the EngineLog)."""
    elog, out = EngineLog(cfg, replay=replay, force=force), {}
    with elog:
        for r in reqs:
            elog.rids = [r.rid]
            out[r.rid] = generate.generate(
                params, torch.tensor([r.prompt], device="cuda"), cfg,
                max_new_tokens=r.max_new_tokens)[0].tolist()
    return out, elog


def near_tie_match(tag, got, want, reqs, elog, ref, what):
    """Each request's tokens in ``got`` (logged by ``elog``) against
    ``want`` (rid -> prompt + new tokens; logged by the EngineLog
    ``ref``), both runs routing on their own: equal, or they first differ
    at new token j, after which the request's tokens are excused.  The
    logits of each new token decided from the same history agree within
    SERVE_ROW_TOL normwise (the median row within SERVE_MEDIAN_TOL).
    serve_run's rules: a MoE layer may route the request otherwise at an
    earlier position, first at a near tie of this run's gate
    probabilities (k-th and (k+1)-th gap <= SERVE_NEAR_TIE); at depth a
    flip moves its position's hidden state, and the positions after it,
    beyond rounding, so the tokens after a flip are not held.  A first
    difference with no flip before it is a near tie of this run's scores
    (``tie_of``).  ``forced_match`` holds every token.  Returns the count
    of bit-equal requests."""
    routes, ref_routes = elog.routes(), ref.routes()
    n_layers = elog.n_layers
    equal, flipped, errs, ties, held_min = 0, 0, [], [], None
    for r in reqs:
        g, w = list(got[r.rid]), list(want[r.rid])
        n0 = len(r.prompt)
        check(len(g) == len(w) and g[:n0] == w[:n0],
              f"{tag}: request {r.rid}: {len(g)} tokens against {len(w)}")
        diff = next((j for j in range(len(g) - n0)
                     if g[n0 + j] != w[n0 + j]), None)
        last = len(g) - n0 - 1 if diff is None else diff
        flip = next(((p, li) for p in range(n0 + last) for li in
                     range(n_layers)
                     if routes[(r.rid, p, li)][0]
                     != ref_routes[(r.rid, p, li)][0]), None)
        if flip is not None:
            gap = routes[(r.rid, *flip)][1]
            check(gap <= SERVE_NEAR_TIE,
                  f"{tag}: request {r.rid} routes otherwise than {what} at "
                  f"(position, layer) {flip}, where this run's gate gap is "
                  f"{gap} (near tie: <= {SERVE_NEAR_TIE})")
            flipped += 1
        # the new tokens decided from the same history, before a flip
        held = range(last + 1 if flip is None else
                     min(last + 1, max(0, flip[0] - n0 + 1)))
        held_min = len(held) if held_min is None else min(held_min,
                                                          len(held))
        for j in held:
            a, b = elog.logits[(r.rid, j)], ref.logits[(r.rid, j)]
            errs.append(normwise(a, b))
            check(errs[-1] <= SERVE_ROW_TOL,
                  f"{tag}: request {r.rid} new token {j}: logits "
                  f"{errs[-1]} normwise from {what}'s (tol {SERVE_ROW_TOL})")
        if diff is None:
            equal += 1
        elif flip is None:
            ties.append(tie_of(tag, r, diff, elog, ref, what))
    med = float(torch.tensor(errs).median()) if errs else 0.0
    check(med <= SERVE_MEDIAN_TOL, f"{tag}: median logits row {med} "
          f"normwise from {what}'s (tol {SERVE_MEDIAN_TOL})")
    print(f"{tag}: {equal}/{len(reqs)} requests bit-equal to {what}; "
          f"{len(ties)} first differ at a near tie of the scores "
          f"(distance over the rows' rms difference max "
          f"{max((t[0] for t in ties), default=0):.3g}, tol "
          f"{SERVE_TIE_SIGMAS}; relative gap (p1 - p2) / p1 max "
          f"{max((t[1] for t in ties if t[1] is not None), default=0):.3g}"
          f", {sum(t[1] is None for t in ties)} at a truncation cut); "
          f"{flipped} first "
          f"routed otherwise at a near tie of the gate; logits of "
          f"{len(errs)} new tokens from the same history (fewest for a "
          f"request {held_min}): median {med:.3g} (tol {SERVE_MEDIAN_TOL}), "
          f"max {max(errs, default=0):.3g} normwise (tol {SERVE_ROW_TOL})")
    return equal


def forced_match(tag, got, want, reqs, elog, ref, what):
    """The twin of near_tie_match for a run (logged by ``elog``) that
    replayed the routing record ``ref`` replayed and was forced to its
    tokens ``want``: both route alike and decide every token from the
    same history, by construction.  So every new token's logits are held
    within SERVE_ROW_TOL normwise (the median row within
    SERVE_MEDIAN_TOL), and where this run's own pick differs from the
    forced token, it is a near tie of its scores (``tie_of``)."""
    check(elog.replay is not None and elog.replay is ref.replay
          and elog.force is not None, f"{tag}: not a replayed, forced twin")
    errs, ties, own_equal = [], [], 0
    for r in reqs:
        n0 = len(r.prompt)
        check(list(got[r.rid]) == list(want[r.rid]),
              f"{tag}: request {r.rid} did not take the forced tokens")
        same = True
        for j in range(len(want[r.rid]) - n0):
            a, b = elog.logits[(r.rid, j)], ref.logits[(r.rid, j)]
            errs.append(normwise(a, b))
            check(errs[-1] <= SERVE_ROW_TOL,
                  f"{tag}: request {r.rid} new token {j}: logits "
                  f"{errs[-1]} normwise from {what}'s (tol {SERVE_ROW_TOL})")
            if elog.own[(r.rid, j)] != want[r.rid][n0 + j]:
                same = False
                ties.append(tie_of(tag, r, j, elog, ref, what))
        own_equal += same
    med = float(torch.tensor(errs).median())
    check(med <= SERVE_MEDIAN_TOL, f"{tag}: median logits row {med} "
          f"normwise from {what}'s (tol {SERVE_MEDIAN_TOL})")
    print(f"{tag}: routing and tokens forced to {what}'s; the logits of "
          f"all {len(errs)} new tokens: median {med:.3g} (tol "
          f"{SERVE_MEDIAN_TOL}), max {max(errs):.3g} normwise (tol "
          f"{SERVE_ROW_TOL}); {own_equal}/{len(reqs)} requests would pick "
          f"every token alike; {len(ties)} tokens picked otherwise, each at "
          f"a near tie of the scores (distance over the rows' rms "
          f"difference max {max((t[0] for t in ties), default=0):.3g}, tol "
          f"{SERVE_TIE_SIGMAS}; relative gap (p1 - p2) / p1 max "
          f"{max((t[1] for t in ties if t[1] is not None), default=0):.3g}"
          f", {sum(t[1] is None for t in ties)} at a truncation cut); rows "
          f"routed as recorded {elog.replayed} and {ref.replayed}, by their "
          f"own top-k {elog.unkeyed} and {ref.unkeyed}")


def tie_of(tag, r, j, elog, ref, what):
    """New token j of request ``r``, which this run picks otherwise than
    the reference from the same history and routing: a near tie of this
    run's decision.
    Both runs' scores are recomputed from their logits (the sampler's, with
    the same noise).  Where each run's pick survives the other's
    truncation, the two picks' scores in this run lie within
    SERVE_TIE_SIGMAS times d, the rms difference of the two runs' scores
    over the vocabulary (their logits' over the temperature); where a
    pick is cut in the other run, it lies within that of the other run's
    cut (its lowest kept score before the noise).  Returns (the distance
    over d, the relative gap (p1 - p2) / p1 of this run's pick against the
    other's, None at a cut)."""
    t = r.temperature if r.temperature > 0 else 1.0
    a, b = elog.logits[(r.rid, j)], ref.logits[(r.rid, j)]
    d = float((a - b).square().mean().sqrt()) / t

    def scores(x):
        if r.temperature <= 0:
            return x
        return serving._sample_scores(x[None], [r.seed], [j],
                                      [r.temperature], [r.top_k],
                                      [r.top_p])[0]

    sa, sb = scores(a), scores(b)
    ta, tb = int(sa.argmax()), int(sb.argmax())
    check(ta != tb, f"{tag}: request {r.rid} new token {j}: the logged "
          f"logits pick the same token {ta} in both runs")
    ka, kb = sa > attention.NEG_INF / 2, sb > attention.NEG_INF / 2
    if bool(ka[tb]) and bool(kb[ta]):
        dist = float(sa[ta] - sa[tb])
        rel = -math.expm1(-dist)
    else:
        # a pick cut in the other run: its distance below that run's cut
        dist, rel = 0.0, None
        for x, keep, scaled in ((tb, ka, a / t), (ta, kb, b / t)):
            if not bool(keep[x]):
                dist = max(dist, float(scaled[keep].min() - scaled[x]))
    ratio = dist / d if d > 0 else math.inf
    check(ratio <= SERVE_TIE_SIGMAS,
          f"{tag}: request {r.rid} first differs from {what} at new token "
          f"{j} (token {ta} against {tb}), {dist} nats apart "
          f"{'from a truncation cut' if rel is None else 'in scores'}, "
          f"{ratio} "
          f"times the rows' rms difference {d} (near tie: <= "
          f"{SERVE_TIE_SIGMAS})")
    return ratio, rel


def decode_window(records, decisions, max_batch, width=6):
    """The first run of up to ``width`` steps with every slot decoding and
    no admission (pure decode steps), as (first step, count)."""
    admits = {d["step"] for d in decisions if d["decision"] == "serve.admit"}
    best = (0, 0)
    run = None
    for r in records:
        if r["kind"] != "serve_step":
            continue
        ok = r["step"] not in admits and r["active"] == max_batch
        run = (run or (r["step"], 0)) if ok else None
        if run is not None:
            run = (run[0], run[1] + 1)
            best = max(best, run, key=lambda x: x[1])
            if best[1] >= width:
                break
    check(best[1] > 0, "engine: no step decoded a full batch without "
          "an admission")
    return best


def engine_profile(cfg, params, reqs, arrivals, serve_kw, records,
                   decisions):
    """Device time of a window of pure decode steps of the mixed run (a
    third drive of the same trace, the same schedule), by class, and the
    idle share against the host time of the same steps in the timed run
    (no profiler)."""
    start, n = decode_window(records, decisions, serve_kw["max_batch"])
    eng = serving.ServingEngine(params, cfg, serving.ServeConfig(**serve_kw),
                                metrics_obj=Metrics())
    for i, r in enumerate(reqs):
        eng.submit(r, arrivals[i])
    while eng.step_idx < start:
        eng.step()
    dev, kernels = device_breakdown(
        f"engine decode window (steps {start}-{start + n - 1}, "
        f"{serve_kw['max_batch']} slots)",
        lambda: [eng.step() for _ in range(n)])
    host = sum(r["step_ms"] for r in records
               if r["kind"] == "serve_step" and start <= r["step"] < start + n)
    idle = "not measured" if dev is None else f"{1 - dev / host:.3f}"
    print(f"engine decode window: steps={n} host_ms_per_step={host / n:.3f} "
          f"(timed run, no profiler) device_ms_per_step="
          f"{fmt_ms(None if dev is None else dev / n)} kernels_per_step="
          f"{kernels / n:.1f} idle_share={idle} ({gpu_line()})")


def chunk_kv_check(cfg, params, req, chunk=256):
    """The K/V rows the chunked prefill writes into pages, against the
    whole prefill's run, layer by layer at every prompt position, with
    both runs' routing recorded.  Layer 0 (before any MoE layer) within
    the bf16 tolerance normwise; each routing difference a near tie of
    the whole prefill's gate (k-th and (k+1)-th gap <= SERVE_NEAR_TIE)
    where it is first-order (serve_flips' sense: no earlier layer flipped
    at its position or an earlier one); in each layer at most 2 % of the
    positions whose routing agreed in every earlier layer more than 4x
    the bf16 tolerance off (a flip elsewhere reaches them only through
    attention)."""
    page = ENGINE_SERVE["page_size"]
    t0 = len(req.prompt)
    t_pad = prompt_pad(t0, ENGINE_SERVE["prompt_bucket"])
    n = prompt_pad(t_pad, chunk) // page
    toks = torch.zeros(n * page, dtype=torch.long, device="cuda")
    toks[:t0] = torch.tensor(req.prompt, device="cuda")
    with RoutingLog() as whole:
        _, k_seq, v_seq = serving._prefill_padded(params, cfg,
                                                  toks[None, :t_pad], t0)
    cache = init_paged_cache(cfg, n + 1, page, "cuda")
    table = torch.arange(1, n + 1, device="cuda")
    with RoutingLog() as chunked:
        for pos in range(0, t0, chunk):
            end = (pos + chunk) // page
            serving._prefill_chunk(params, cfg, cache.k_pages,
                                   cache.v_pages, toks[None, pos:pos + chunk],
                                   table[:end], table[pos // page:end], pos,
                                   min(t0 - 1 - pos, chunk - 1))
    n_l, k = cfg.num_layers, cfg.expert_top_k
    check(len(cfg.moe_layer_indices) == n_l, "chunk_kv_check: every layer "
          "an MoE layer")
    # per layer: [t0] routing differs; earlier: some earlier layer did at
    # the position; before: ... at the position or an earlier one
    flips, gaps = [], 0.0
    earlier = torch.zeros(t0, dtype=torch.bool, device="cuda")
    before = earlier.clone()
    own = []
    for li in range(n_l):
        ids_w, probs_w = whole.calls[li]
        ids_c = torch.cat([c[0] for c in chunked.calls[li::n_l]])
        diff = (ids_w[:t0].sort(-1).values
                != ids_c[:t0].sort(-1).values).any(-1)
        first = diff & ~before
        if bool(first.any()):
            top = probs_w[:t0][first].sort(-1, descending=True).values
            gaps = max(gaps, float((top[:, k - 1] - top[:, k]).max()))
        own.append(earlier.clone())
        flips.append(int(diff.sum()))
        earlier |= diff
        before |= diff.int().cummax(0).values.bool()
    check(gaps <= SERVE_NEAR_TIE, f"engine chunked: a first-order routing "
          f"difference at a gate gap of {gaps} (near tie: <= "
          f"{SERVE_NEAR_TIE})")
    worst, off = [], []
    for pages, seq in ((cache.k_pages, k_seq), (cache.v_pages, v_seq)):
        for li in range(n_l):
            got = gather_ctx(pages[li], table[None])[0, :, :t0]
            want = seq[li][:, :t0]
            per_pos = (torch.linalg.vector_norm((got - want).float(),
                                                dim=(0, 2))
                       / torch.linalg.vector_norm(want.float(), dim=(0, 2)))
            worst.append(normwise(got, want))
            held = ~own[li]
            off.append(float((per_pos[held] > 4 * BF16_NORMWISE_TOL)
                             .float().mean()))
    print(f"engine chunked: K/V rows of {t0} prompt positions against the "
          f"whole prefill's, by layer (K then V): normwise "
          f"{[round(w, 5) for w in worst]} (layer 0 tol "
          f"{BF16_NORMWISE_TOL}); routing differences by layer {flips} "
          f"(largest first-order gap {gaps:.3g}, tol {SERVE_NEAR_TIE}); of "
          f"the positions routed alike in the earlier layers, the share "
          f"over {4 * BF16_NORMWISE_TOL}: {[round(o, 4) for o in off]} "
          f"(tol 0.02)")
    check(worst[0] <= BF16_NORMWISE_TOL and worst[n_l] <= BF16_NORMWISE_TOL
          and max(off) <= 0.02, "engine chunked: chunked K/V rows against "
          "the whole prefill's")


def engine_phase(cfg, params):
    """The serving engine at Mixtral widths (the serve phase's weights):
    (1) a mixed trace of 16 requests (prompts 64-512 tokens, 16-32 new,
    half sampled) sustaining 8 concurrent, its greedy requests against
    ``generate`` on each prompt alone, the same trace again for the same
    sampled streams (the timed run) and a third time for a profiled
    window of decode steps; (2) gather-fused; (3) a starved page pool
    (evictions); (4) chunked prefill of 1024-1536-token prompts against
    the whole prefill; (5) speculative greedy decoding against the plain
    engine; (6) ep_shards 8 over a local mesh.  Each comparison is made
    twice: between the runs as they route, and between twins that replay
    one run's routing (``EngineLog``'s ``replay``; the mixed run's for
    (1), (2), (3) and (6)).  Then the CLI (``cli_run``).  Each run's
    launches, the replayed twins' aside, are a path of the kernels line.
    Returns the paths."""
    paths = {}
    reqs, arrivals = engine_trace(cfg)
    base = dict(ENGINE_SERVE, max_pages_per_slot=slot_pages(reqs,
                                                           ENGINE_SERVE))
    roomy = dict(base, num_pages=8 * base["max_pages_per_slot"] + 1)
    out1, eng1, log1, _ = engine_run("engine mixed", cfg, params, reqs,
                                     arrivals, paths, **roomy)
    check(eng1.stats["max_active"] == 8 and eng1.stats["evictions"] == 0,
          f"engine mixed: {eng1.summary()}")
    greedy = [r for r in reqs if r.temperature <= 0]
    alone, alone_log = generate_alone(cfg, params, greedy)
    near_tie_match("engine mixed", out1, alone, greedy, log1, alone_log,
                   "generate() on each prompt alone")
    # the reference of the replayed, forced twins of (1), (2), (3), (6)
    routes1 = log1.routes()
    out, _, rlog1, _ = engine_run("engine mixed (replayed)", cfg, params,
                                  reqs, arrivals, replay=routes1, **roomy)
    ref1 = (out, rlog1)
    alone, alone_log = generate_alone(
        cfg, params, greedy, replay=routes1,
        force={r.rid: out[r.rid][len(r.prompt):] for r in greedy})
    forced_match("engine mixed: generate() alone (replayed, forced)", alone,
                 out, greedy, alone_log, rlog1, "the replayed mixed run")
    out1b, eng1b, _, rec1b = engine_run("engine mixed (timed)", cfg, params,
                                        reqs, arrivals, log=False, **roomy)
    check(out1b == out1, "engine mixed: a second run of the trace gave "
          "other streams")
    print("engine mixed: a second run gave the same streams, sampled "
          f"({len(reqs) - len(greedy)}) and greedy ({len(greedy)})")
    engine_profile(cfg, params, reqs, arrivals, roomy, rec1b,
                   eng1b.metrics.decisions)

    out, _, log, _ = engine_run("engine gather_fused",
                                cfg.replace(gather_fused=True), params,
                                reqs, arrivals, paths, **roomy)
    near_tie_match("engine gather_fused", out, out1, reqs, log, log1,
                   "the mixed run")
    engine_replayed("engine gather_fused", cfg.replace(gather_fused=True),
                    params, reqs, arrivals, ref1, "the replayed mixed run",
                    **roomy)
    # prompts padded to whole pages only, so that decode grows every
    # request by a page or two, into a pool of 160 pages: 2 evictions
    starved = dict(base, prompt_bucket=16, num_pages=161)
    out, eng, log, _ = engine_run("engine starved", cfg, params, reqs,
                                  arrivals, paths, **starved)
    check(eng.stats["evictions"] > 0, "engine starved: no eviction")
    near_tie_match("engine starved", out, out1, reqs, log, log1,
                   "the mixed run")
    engine_replayed("engine starved", cfg, params, reqs, arrivals, ref1,
                    "the replayed mixed run", **starved)

    long_reqs, long_arr = engine_trace(cfg, n=4, seed=41,
                                       prompt_lens=(1024, 1536),
                                       new=(16, 16), sampled=False)
    lkw = dict(ENGINE_SERVE, max_pages_per_slot=slot_pages(long_reqs,
                                                          ENGINE_SERVE))
    lkw["num_pages"] = 4 * lkw["max_pages_per_slot"] + 1
    whole, _, wlog, _ = engine_run("engine whole prefill", cfg, params,
                                   long_reqs, long_arr, paths, **lkw)
    out, eng, log, _ = engine_run("engine chunked", cfg, params, long_reqs,
                                  long_arr, paths, prefill_chunk=256, **lkw)
    check(eng.stats["prefill_buckets"] == {256}, "engine chunked: "
          f"prefill buckets {eng.stats['prefill_buckets']}")
    near_tie_match("engine chunked", out, whole, long_reqs, log,
                   wlog, "the whole-prefill engine")
    out, _, log, _ = engine_run("engine whole prefill (replayed)", cfg,
                                params, long_reqs, long_arr,
                                replay=wlog.routes(), **lkw)
    engine_replayed("engine chunked", cfg, params, long_reqs, long_arr,
                    (out, log), "the replayed whole-prefill engine",
                    prefill_chunk=256, **lkw)
    chunk_kv_check(cfg, params, max(long_reqs, key=lambda r: len(r.prompt)))

    spec_reqs, spec_arr = loadgen.build_requests(
        8, vocab=cfg.vocab_size, prompt_len=128, max_new=24, seed=50,
        arrival_every=2, repetitive=True)
    skw = dict(ENGINE_SERVE, max_pages_per_slot=slot_pages(spec_reqs,
                                                          ENGINE_SERVE))
    skw["num_pages"] = 8 * skw["max_pages_per_slot"] + 1
    plain, _, plog, _ = engine_run("engine non-speculative", cfg, params,
                                   spec_reqs, spec_arr, paths, **skw)
    out, eng, log, _ = engine_run(
        "engine speculative", cfg, params, spec_reqs, spec_arr, paths,
        speculate=serving.SpecConfig(draft_tokens=4), **skw)
    snap = eng.spec_snapshot()
    print(f"engine speculative: draft_tokens=4 drafted="
          f"{snap['spec_drafted']} accepted={snap['spec_accepted']} "
          f"accept_rate={snap['accept_rate']} tokens_per_step="
          f"{snap['spec_tokens_per_step']} verify_steps="
          f"{snap['spec_steps']}")
    near_tie_match("engine speculative", out, plain, spec_reqs, log,
                   plog, "the non-speculative engine")
    out, _, log, _ = engine_run("engine non-speculative (replayed)", cfg,
                                params, spec_reqs, spec_arr,
                                replay=plog.routes(), **skw)
    engine_replayed("engine speculative", cfg, params, spec_reqs, spec_arr,
                    (out, log), "the replayed non-speculative engine",
                    speculate=serving.SpecConfig(draft_tokens=4), **skw)

    ekw = dict(roomy, ep_shards=8,
               num_pages=8 * (base["max_pages_per_slot"] + 1))
    out, _, log, _ = engine_run(
        "engine ep 8", cfg, params, reqs, arrivals, paths,
        ep_mesh=mesh.local_mesh(8, device="cuda"), **ekw)
    near_tie_match("engine ep 8", out, out1, reqs, log, log1,
                   "the mixed run")
    engine_replayed("engine ep 8", cfg, params, reqs, arrivals, ref1,
                    "the replayed mixed run",
                    ep_mesh=mesh.local_mesh(8, device="cuda"), **ekw)
    cli_run(paths)
    return paths


def cli_run(paths):
    """``python -m flashmoe_tpu_torch.serving`` with its defaults on the
    card (its ``main``, in this process): the f32 drill model through the
    kernels at its own small shapes, every request completed on this
    card, the observability files written."""
    out = io.StringIO()
    with tempfile.TemporaryDirectory() as obs:
        reset_counts()
        with contextlib.redirect_stdout(out):
            rc = serve_cli.main(["--obs-dir", obs])
        torch.cuda.synchronize()
        counts = engine_counts("engine cli", paths)
        files = sorted(os.listdir(obs))
    summary = json.loads(out.getvalue().strip().splitlines()[-1])
    check(rc == 0 and summary["device"] == torch.cuda.get_device_name(0)
          and summary["completed"] == 8 and files == ["decisions.jsonl",
                                                     "flight.jsonl"],
          f"engine cli: rc {rc}, files {files}, summary {summary}")
    print(f"engine cli: python -m flashmoe_tpu_torch.serving (defaults; "
          f"hidden 128, f32): {json.dumps(summary)} launches={counts} "
          f"({gpu_line()})")


def engine_replayed(tag, cfg, params, reqs, arrivals, ref, what, **kw):
    """The run ``tag`` again, routing as the record that ``ref`` (the
    outputs and EngineLog of a run replaying it) replayed and forced to
    its tokens, held to it by forced_match."""
    force = {r.rid: list(ref[0][r.rid][len(r.prompt):]) for r in reqs}
    out, _, log, _ = engine_run(f"{tag} (replayed, forced)", cfg, params,
                                reqs, arrivals, replay=ref[1].replay,
                                force=force, **kw)
    forced_match(f"{tag} (replayed, forced)", out, ref[0], reqs, log,
                 ref[1], what)


def train_phase():
    """Mixtral-8x7B widths, 2 layers, bf16 weights, AdamW.  At the initial
    weights: every gradient through the kernels against the plain
    versions', and one SGD step lowering the loss; then three train steps
    (the training path) and a device-time breakdown of one step."""
    cfg = presets.mixtral_8x7b(num_layers=2, param_dtype=torch.bfloat16,
                               is_training=True)
    opt = trainer.make_optimizer(cfg, warmup_steps=1, total_steps=3)
    state, batch = train_state(cfg, opt)
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
    return launches, losses[0]


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
    names = leaf_names(params)
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


def leaf_names(tree) -> list[str]:
    """The dotted paths of a parameter tree's leaves, in ``tree_leaves``
    order."""
    names = []

    def walk(t, path):
        if isinstance(t, dict):
            for key, v in t.items():
                walk(v, f"{path}.{key}" if path else key)
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, f"{path}[{i}]")
        else:
            names.append(path)

    walk(tree, "")
    return names


class ReplayRouting:
    """While active, the MoE layers' router (``moe_layer``'s and the
    expert-parallel layers') is the plain one made to route as recorded
    calls did (``RoutingLog.calls``), call by call, so that a
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

        for mod in RoutingLog.MODULES:
            mod.router = replayed
        return self

    def __exit__(self, *exc):
        for mod in RoutingLog.MODULES:
            mod.router = self._router


class RoutingLog:
    """While active, records every gate call that ``moe_layer`` and the
    expert-parallel layers make (one a rank): the top-k ids and the
    softmax probabilities of its tokens."""

    MODULES = (moe, ep, fused, ragged_ep)

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
    # a record_function range (the serving engine's spans) also shows as
    # a device row spanning its kernels: not a kernel of its own
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)]
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


# ----------------------------------------------------------------------
# runtime phase: the front door (config file, bootstrap, worker, probe,
# the training CLI with checkpoints, preemption and resume)
# ----------------------------------------------------------------------

# BENCH_CONFIGS["reference"] (flashmoe_tpu/config.py:576-578): E 64,
# top-2, H = I = 2048, S 8192, capacity factor 1.0, bf16
REFERENCE_CFG = dict(num_experts=64, expert_top_k=2, hidden_size=2048,
                     intermediate_size=2048, sequence_len=8192,
                     capacity_factor=1.0)
# the training CLI's run: Mixtral-8x7B's preset, 1 layer, bf16 weights
# (and so bf16 moments), 4 x 257 tokens a step, 6 steps
CLI_STEPS = 6
CLI_BATCH = 4
CLI_SEQ = 256
CLI_ARGS = ["--preset", "mixtral-8x7b", "--num-layers", "1", "--batch",
            str(CLI_BATCH), "--steps", str(CLI_STEPS), "--log-every", "1",
            "--set", f"sequence_len={CLI_SEQ}", "--set",
            "param_dtype=bfloat16"]
# the CLI's resumed losses against the unbroken run's where they are not
# bit-equal: relative, the f32 loss of the same step on the same weights
# and tokens, moved only by the order of atomic sums in the backward
CLI_LOSS_RTOL = 1e-4
# a drain writes at most one checkpoint past the periodic ones; with the
# retention of MAX_TO_KEEP steps the CLI's directory peaks at
# MAX_TO_KEEP + 1 step directories, beside the phase's own measurement
# directory (one step), plus 10 % for the token file and the manifests
RUNTIME_DISK_STEPS = checkpoint.MAX_TO_KEEP + 2


def cli_cfg():
    return presets.mixtral_8x7b(num_layers=1, sequence_len=CLI_SEQ,
                                param_dtype=torch.bfloat16,
                                is_training=True)


def checkpoint_bytes(cfg, guard=True) -> int:
    """Bytes of one checkpoint of the config's train state (shapes on
    'meta': nothing allocated)."""
    opt = trainer.make_optimizer(cfg)
    st = elastic.meta_state(cfg, opt, trainer.GradGuardConfig()
                            if guard else None)
    return sum(t.numel() * t.element_size() for t in tree_leaves(st))


def check_disk(path) -> int:
    """Fail unless ``path``'s file system has room for the runtime
    phase's checkpoints; returns the bytes it needs."""
    need = int(RUNTIME_DISK_STEPS * checkpoint_bytes(cli_cfg()) * 1.1)
    free = shutil.disk_usage(path).free
    check(free >= need,
          f"runtime phase: {path} has {free / 1e9:.1f} GB free, the "
          f"checkpoints need {need / 1e9:.1f} GB ({(need - free) / 1e9:.1f}"
          f" GB short)")
    return need


@contextlib.contextmanager
def stdout_to(path):
    """The process's file descriptor 1 (children's too) into ``path``."""
    sys.stdout.flush()
    saved = os.dup(1)
    with open(path, "w") as f:
        os.dup2(f.fileno(), 1)
    try:
        yield
    finally:
        sys.stdout.flush()
        os.dup2(saved, 1)
        os.close(saved)


def cli_child(argv) -> int:
    """``python3 chip_smoke.py --train-cli ARGS``: the training CLI's
    ``main(ARGS)`` with the kernels' counts set to 0 before it and
    printed after it, as the last stdout line."""
    reset_counts()
    rc = train_cli.main(argv)
    torch.cuda.synchronize()
    print(json.dumps({"launches": all_counts()}))
    return rc


def cli_command(extra):
    return [sys.executable, os.path.join(HERE, "chip_smoke.py"),
            "--train-cli", *CLI_ARGS, *extra]


def step_losses_of(stderr: str) -> dict:
    """step -> loss from the CLI's stderr step lines (a step run again
    after a rewind: its last line)."""
    out = {}
    for line in stderr.splitlines():
        if line.startswith('{"step"'):
            rec = json.loads(line)
            out[rec["step"]] = rec["loss"]
    return out


def run_cli(tag, extra, paths, timeout=600):
    """The CLI to its end in a child; returns (summary, step losses)."""
    proc = subprocess.run(cli_command(extra), capture_output=True,
                          text=True, timeout=timeout)
    check(proc.returncode == 0,
          f"{tag}: rc {proc.returncode}\n{proc.stderr[-3000:]}")
    lines = proc.stdout.strip().splitlines()
    return json.loads(lines[-2]), json.loads(lines[-1])["launches"], \
        step_losses_of(proc.stderr), proc.stderr


def preempted_cli(tag, extra, timeout=600):
    """The CLI in a child, sent SIGTERM after its step-3 line; returns
    (rc, stderr, the step at which it drained)."""
    proc = subprocess.Popen(cli_command(extra), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    err = []
    sent = False
    t0 = time.perf_counter()
    try:
        for line in proc.stderr:
            err.append(line)
            if not sent and line.startswith('{"step": 3'):
                proc.send_signal(signal.SIGTERM)
                sent = True
            check(time.perf_counter() - t0 < timeout, f"{tag}: timed out")
        proc.stdout.read()
        proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    text = "".join(err)
    drained = [ln for ln in err if ln.startswith("preempted: drained at")]
    check(sent and proc.returncode == 0 and len(drained) == 1,
          f"{tag}: rc {proc.returncode}, SIGTERM sent {sent}\n"
          f"{text[-3000:]}")
    return text, int(drained[0].split()[4])


def checkpoint_io(cfg, root):
    """One train state of ``cfg`` on the card (with the guard): a sync
    save timed by its two stages (``checkpoint.save`` is ``_write_payload``
    then ``write_manifest``, whose CRC reads the files back), a restore
    with verification into a template on 'meta', held bit for bit, and
    an async save (the loop's stall).  Returns the times and bytes, and a
    function that waits for the async write (left to overlap the next
    work), verifies it and removes the directory."""
    opt = trainer.make_optimizer(cfg, total_steps=CLI_STEPS)
    g = torch.Generator(device="cuda").manual_seed(0)
    state = trainer.init_state(g, cfg, opt, guard=trainer.GradGuardConfig())
    d = os.path.join(root, "io")
    t0 = time.perf_counter()
    checkpoint._write_payload(d, checkpoint._flatten(state), 1)
    t1 = time.perf_counter()
    checkpoint.write_manifest(d, 1)
    t2 = time.perf_counter()
    check(checkpoint.verify(d, 1), "sync save: manifest does not verify")
    with open(os.path.join(d, "manifest-1.json")) as f:
        nbytes = sum(v["size"] for v in json.load(f)["files"].values())
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    back = checkpoint.restore(d, checkpoint.abstract_state(state),
                              device="cuda")
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t3) * 1e3
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(back),
                                                 tree_leaves(state)))
    check(same and int(back.step) == 0, "restore: not bit-equal")
    t4 = time.perf_counter()
    checkpoint.save(d, state, step=2, blocking=False)
    stall_ms = (time.perf_counter() - t4) * 1e3
    del state, back
    torch.cuda.empty_cache()

    def finish():
        check(checkpoint.wait_for_saves() == [], "async save: writer errors")
        check(checkpoint.verify(d, 2), "async save: manifest does not verify")
        shutil.rmtree(d)

    return dict(bytes=nbytes, payload_ms=(t1 - t0) * 1e3,
                crc_ms=(t2 - t1) * 1e3, save_ms=(t2 - t0) * 1e3,
                stall_ms=stall_ms, restore_ms=restore_ms), finish


def runtime_phase(paths):
    """The front door on the card: ``initialize``; ``run_moe(1)`` on a
    config file (BENCH_CONFIGS "reference", written by ``to_json``) as a
    subprocess, then the worker's ``main --bench`` in this process (the
    worker path); the throughput probe at the same widths (the probe
    path); checkpoint I/O at the CLI's state; the training CLI at
    Mixtral-8x7B's widths (1 layer) on a token file through the native
    loader: 6 unbroken steps (the CLI path, counted in its child), the
    same with checkpoints every 3 steps, async saves and the guard, sent
    SIGTERM after step 3 (it drains), and a rerun that resumes; the
    resumed losses against the unbroken ones."""
    rt = bootstrap.initialize()
    print(f"runtime initialize: mesh={dict(rt.mesh.shape)} device="
          f"{rt.device} placement={rt.placement.local_experts} "
          f"compiled dtype={api.get_compiled_config()['dtype']} "
          f"num_local_experts={api.get_num_local_experts()}")
    check(rt.device.type == "cuda" and rt.mesh.size == 1,
          f"initialize: {rt}")
    bootstrap.finalize()
    with tempfile.TemporaryDirectory() as tmp:
        check_disk(tmp)
        ref = config.MoEConfig(**REFERENCE_CFG)
        cfg_path = os.path.join(tmp, "reference.json")
        with open(cfg_path, "w") as f:
            f.write(ref.to_json())
        check(config.MoEConfig.from_json(cfg_path) == ref,
              "config file: from_json(to_json) differs")
        out_path = os.path.join(tmp, "worker.out")
        t0 = time.perf_counter()
        with stdout_to(out_path):
            rc = api.run_moe(1, config_path=cfg_path, timeout=300)
        with open(out_path) as f:
            rec = json.loads(f.read().strip().splitlines()[-1])
        check(rc == 0 and rec["finite"] and rec["output_shape"] == [
            ref.tokens, ref.hidden_size], f"run_moe(1): rc {rc}, {rec}")
        print(f"runtime run_moe(1) reference config: {json.dumps(rec)} "
              f"({(time.perf_counter() - t0):.1f} s)")

        reset_counts()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = worker.main([cfg_path, "--bench"])
        torch.cuda.synchronize()
        counts = path_counts("runtime worker", paths)
        rec = json.loads(buf.getvalue().strip().splitlines()[-1])
        check(rc == 0, f"worker --bench: rc {rc}")
        print(f"runtime worker --bench: moe_fwd_ms={rec['moe_fwd_ms']} "
              f"(32 calls after 8, CUDA events) launches={counts} "
              f"({gpu_line()})")

        reset_counts()
        rate = throughput.measure_expert_throughput(ref)
        torch.cuda.synchronize()
        counts = path_counts("runtime probe", paths)
        print(f"runtime throughput probe (8 experts x 256 rows, H = I = "
              f"2048, bf16): {rate:.3f} experts/ms = "
              f"{rate * 256 * 1e3:.4g} rows/s launches={counts} "
              f"({gpu_line()})")

        io_, io_finish = checkpoint_io(cli_cfg(), tmp)
        print(f"runtime checkpoint (Mixtral-8x7B widths, 1 layer, bf16, "
              f"guard): {io_['bytes']} bytes; sync save "
              f"{io_['save_ms']:.1f} ms (payload {io_['payload_ms']:.1f} "
              f"ms, {io_['bytes'] / io_['payload_ms'] / 1e6:.3f} GB/s; "
              f"CRC {io_['crc_ms']:.1f} ms, "
              f"{io_['bytes'] / io_['crc_ms'] / 1e6:.3f} GB/s); restore "
              f"with verify {io_['restore_ms']:.1f} ms; async stall "
              f"{io_['stall_ms']:.1f} ms ({gpu_line()})")

        tok_path = os.path.join(tmp, "tokens.bin")
        rng = __import__("numpy").random.default_rng(7)
        n_windows = 4 * CLI_STEPS * CLI_BATCH
        data.write_token_file(tok_path, rng.integers(
            0, cli_cfg().vocab_size, size=n_windows * (CLI_SEQ + 1)))
        loader = data.TokenLoader(tok_path, CLI_BATCH, CLI_SEQ)
        check(loader.is_native, "token loader: the native arm did not load")
        first = next(loader)["tokens"]
        check(first.is_cuda and first.dtype == torch.int32
              and tuple(first.shape) == (CLI_BATCH, CLI_SEQ + 1),
              f"token loader: batch {first.shape} {first.dtype}")
        loader.close()

        data_args = ["--data", tok_path]
        t0 = time.perf_counter()
        summary, launches, unbroken, err = run_cli(
            "cli unbroken", data_args, paths)
        cli_s = time.perf_counter() - t0
        io_finish()  # the async write overlapped the unbroken run
        check("native=True" in err, "cli: the native loader was not used")
        counts = path_counts("runtime cli", paths, launches)
        ck_dir = os.path.join(tmp, "ck")
        ck_args = data_args + ["--checkpoint-dir", ck_dir,
                               "--checkpoint-every", "3", "--async-save",
                               "--grad-guard"]
        t0 = time.perf_counter()
        err_b, drained = preempted_cli("cli preempted", ck_args)
        pre_s = time.perf_counter() - t0
        check(checkpoint.verify(ck_dir, drained)
              and checkpoint.load_loader_state(ck_dir, drained) is not None
              and checkpoint.has_guard(ck_dir, drained),
              f"cli preempted: checkpoint {drained} does not verify")
        t0 = time.perf_counter()
        summary_c, _, resumed, _ = run_cli("cli resumed", ck_args, paths)
        res_s = time.perf_counter() - t0
        check(summary_c.get("resumes") == 1.0
              and summary_c.get("loader_restores") == 1.0,
              f"cli resumed: {summary_c}")
        broken = {**step_losses_of(err_b), **resumed}
        check(sorted(broken) == sorted(unbroken) == list(range(CLI_STEPS)),
              f"cli: steps {sorted(broken)} vs {sorted(unbroken)}")
        bits = all(broken[i] == unbroken[i] for i in unbroken)
        rel = max(abs(broken[i] - unbroken[i]) / abs(unbroken[i])
                  for i in unbroken)
        check(bits or rel <= CLI_LOSS_RTOL,
              f"cli: resumed losses {broken} vs unbroken {unbroken}")
        print(f"runtime train cli (Mixtral-8x7B, 1 layer, 4 x 257 tokens, "
              f"bf16, native loader): unbroken losses "
              f"{[unbroken[i] for i in range(CLI_STEPS)]} median step "
              f"{summary['step_ms_p50']:.2f} ms ({cli_s:.1f} s); SIGTERM "
              f"after step 3: drained at step {drained} ({pre_s:.1f} s), "
              f"resumed to {CLI_STEPS} ({res_s:.1f} s): losses "
              f"{'bit-equal' if bits else f'max rel {rel:.3g}'} to the "
              f"unbroken run's; launches={counts} ({gpu_line()})")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if argv[:1] == ["--train-cli"]:
        return cli_child(argv[1:])
    print(gpu_line())
    print(f"runtime phase disk: {check_disk(tempfile.gettempdir()) / 1e9:.1f}"
          f" GB needed in {tempfile.gettempdir()}")
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
    paths = engine_phase(cfg, params)
    ep_entry, gmm_recompute, ep_launches, ep_paths = ep_phase(cfg, params)
    paths.update(ep_paths)
    axes_forward_phase(cfg, params, paths)
    entries.append(ep_entry)
    launches.update({k: ep_launches[k] for k in EP_KERNELS})
    del params, moe0, x
    torch.cuda.empty_cache()
    quant_entries, quant_launches = quant_phase(paths)
    entries += quant_entries
    launches.update(quant_launches)
    many = many_expert_phase()
    launches.update({k: many[k] for k in MANY_EXPERT_KERNELS})
    train_launches, one_device_loss = train_phase()
    launches.update({k: train_launches[k] for k in TRAIN_KERNELS})
    tcfg, opt, ref = ep_train_phase(one_device_loss, paths)
    axes_train_phase(tcfg, opt, ref, one_device_loss, paths)
    del tcfg, opt, ref
    torch.cuda.empty_cache()
    runtime_phase(paths)

    for e in entries:
        if e["name"] == "grouped_matmul":
            e.update(gmm_recompute)
    # launches: each kernel's count on the main path of the slice that
    # ported it; launches_by_path: its counts on this slice's paths
    kernels = [dict(e, launches=launches[e["name"]], launches_by_path={
        p: c[e["name"]] for p, c in paths.items() if c.get(e["name"])})
        for e in entries]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
