#!/usr/bin/env python3
"""Time this tree's gate and grouped matmul, and the serving and training
paths that run them, against another tree of the port on one card:

    python3 chip_ab.py --other DIR [--rounds 2]

DIR holds another version of the repository, for instance the parent
commit unpacked with ``git archive``.  Each measurement runs in a process
of its own that imports ``flashmoe_tpu_torch`` from one tree (and builds
that tree's kernels); the trees take turns, other, this, this, other, ...,
so both are measured on the same card in the same call.  Per run:

* the gate (Mixtral: H 4096, E 8, top-2, bf16) at prefill (1024 tokens)
  and decode (4 tokens): ``router_cuda`` on CUDA events, and its
  kernels' device time from torch.profiler;
* the grouped matmul at the training step's backward shapes (2560 rows of
  8 experts, 64 rows of padding past num_rows; K 4096 -> N 14336 and
  K 14336 -> N 4096, bf16 in, f32 out): ``grouped_matmul_cuda`` on CUDA
  events, and its kernels' device time;
* the fused EP kernel's full-precision arms, bf16 and f32 (SwiGLU, the
  ``batched`` order), at the ep path's shapes (8 ranks of one Mixtral
  expert each, slabs of 128 rows, 64-128 of them sent): ``fused_shard_cuda``
  on CUDA events, and its kernel's device time;
* serving: Mixtral-8x7B widths with 4 layers, 4 prompts of 256 tokens: a
  prefill and a decode step, host clock around work ended by a
  synchronize (median of 5);
* training: Mixtral-8x7B widths with 2 layers, AdamW, 4 x 257 tokens: one
  ``make_train_step`` step (median of 3 after one warm-up).

Prints one line a run, then one JSON object with every run as the last
line.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def worker(tree: str) -> dict:
    sys.path.insert(0, tree)
    import torch

    from flashmoe_tpu_torch import config
    from flashmoe_tpu_torch.kernels import _build
    from flashmoe_tpu_torch.models import generate, presets, transformer
    from flashmoe_tpu_torch.ops import expert, gate
    from flashmoe_tpu_torch.runtime import trainer

    import flashmoe_tpu_torch
    assert flashmoe_tpu_torch.__file__.startswith(os.path.abspath(tree))
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _build.library()
    res = {"tree": tree, "build_s": time.perf_counter() - t0}

    def events_ms(fn, iters):
        fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / iters

    def device_ms(fn, iters, word):
        """Device time a call of the port's kernels whose names hold
        ``word``, from torch.profiler."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and "fm::" in e.key
                 and word in e.key)
        return us / 1e3 / iters

    g = torch.Generator(device="cuda").manual_seed(0)
    gcfg = config.MoEConfig(num_experts=8, expert_top_k=2, hidden_size=4096,
                            dtype=torch.bfloat16)
    w = (torch.randn(4096, 8, device="cuda", generator=g) / 64).to(
        torch.bfloat16)
    for tag, s in (("prefill", 1024), ("decode", 4)):
        x = torch.randn(s, 4096, device="cuda", generator=g,
                        dtype=torch.bfloat16)
        res[f"gate_{tag}_wrapper_ms"] = events_ms(
            lambda: gate.router_cuda(x, w, gcfg), 200)
        res[f"gate_{tag}_kernel_ms"] = device_ms(
            lambda: gate.router_cuda(x, w, gcfg), 50, "gate")

    tiles = [5, 5, 6, 4, 5, 5, 5, 5]
    gid = torch.tensor([e for e, c in enumerate(tiles) for _ in range(c)],
                       dtype=torch.int32, device="cuda")
    t = gid.numel() * 64
    nrow = torch.tensor(t - 64, device="cuda")
    for tag, k, n in (("d_hidden", 4096, 14336), ("d_x", 14336, 4096)):
        a = torch.randn(t, k, device="cuda", generator=g,
                        dtype=torch.bfloat16)
        wt = (torch.randn(8, n, k, device="cuda", generator=g) / 32).to(
            torch.bfloat16)

        def call(a=a, wt=wt):
            return expert.grouped_matmul_cuda(
                a, gid, wt, transpose_w=True, out_dtype=torch.float32,
                num_rows=nrow)

        res[f"gmm_{tag}_wrapper_ms"] = events_ms(call, 20)
        res[f"gmm_{tag}_kernel_ms"] = device_ms(call, 10, "gmm")
        del a, wt
    torch.cuda.empty_cache()

    from flashmoe_tpu_torch.parallel import fused
    d, h, i = 8, 4096, 14336
    cnt = torch.randint(64, 129, (d, d, 1), device="cuda", generator=g)
    b_up = torch.zeros(d, i, device="cuda")
    b_down = torch.zeros(d, h, device="cuda")
    for tag, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        x_send = torch.randn(d, d, 1, 128, h, device="cuda",
                             generator=g).to(dt)
        ws = [(torch.randn(d, k, n, device="cuda", generator=g)
               / k ** 0.5).to(dt) for k, n in ((h, i), (i, h), (h, i))]

        def call(x_send=x_send, ws=ws):
            return fused.fused_shard_cuda(
                cnt, None, x_send, ws[0], b_up, ws[1], b_down, ws[2],
                act_name="silu", gated=True, schedule="batched")

        res[f"fused_{tag}_gated_wrapper_ms"] = events_ms(call, 10)
        res[f"fused_{tag}_gated_kernel_ms"] = device_ms(call, 5, "fused_ep")
        del x_send, ws
    torch.cuda.empty_cache()

    def host_ms(fn, reps):
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t1) * 1e3)
        return statistics.median(out)

    cfg = presets.mixtral_8x7b(num_layers=4, param_dtype=torch.bfloat16)
    params = transformer.init_params(g, cfg, device="cuda")
    prompt = torch.randint(0, cfg.vocab_size, (4, 256), device="cuda",
                           generator=g)

    def prefill():
        cache = generate.init_cache(cfg, 4, 258, "cuda")
        logits, cache = generate.prefill_batched(params, cfg, prompt, cache)
        return logits, cache

    prefill()
    res["serve_prefill_ms"] = host_ms(prefill, 5)
    logits, cache = prefill()
    tok = params["embed"].to(cfg.dtype)[logits.argmax(-1)][:, None, :]
    generate._decode_step(params, cfg, tok, cache, 256)
    res["serve_decode_step_ms"] = host_ms(
        lambda: generate._decode_step(params, cfg, tok, cache, 256), 5)
    del params, cache, logits, tok
    torch.cuda.empty_cache()

    cfg = presets.mixtral_8x7b(num_layers=2, param_dtype=torch.bfloat16,
                               is_training=True)
    opt = trainer.make_optimizer(cfg, warmup_steps=1, total_steps=10)
    state = trainer.init_state(g, cfg, opt)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 257),
                                     device="cuda", generator=g)}
    step = trainer.make_train_step(cfg, opt)
    box = [state]

    def one_step():
        box[0], _ = step(box[0], batch)

    one_step()
    res["train_step_ms"] = host_ms(one_step, 3)
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="root of the other tree")
    ap.add_argument("--rounds", type=int, default=2,
                    help="pairs of turns for each tree (default 2)")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker)))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device", file=sys.stderr)
        return 2
    if not args.other or not os.path.isdir(
            os.path.join(args.other, "flashmoe_tpu_torch")):
        print("chip_ab: --other must name a tree holding flashmoe_tpu_torch",
              file=sys.stderr)
        return 2
    other = os.path.abspath(args.other)
    print(gpu_line())
    order = []
    for r in range(args.rounds):
        order += [other, HERE] if r % 2 == 0 else [HERE, other]
    runs = []
    for tree in order:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", tree],
            capture_output=True, text=True, timeout=900, cwd=tree)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        res["tree"] = "this" if tree == HERE else "other"
        runs.append(res)
        print(" ".join(f"{k}={v:.5f}" if isinstance(v, float) else f"{k}={v}"
                       for k, v in res.items()), flush=True)
    print(json.dumps({"gpu": gpu_line(), "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
