#!/usr/bin/env python3
"""Time this tree's gate, grouped FFN, grouped matmul, transposed grouped
matmul, flash attention, fused EP kernel and two-pass gate, and the
serving, expert-parallel and training paths that run them, against
another tree of the port on one card:

    python3 chip_ab.py --other DIR [--rounds 2] [--groups b4,...]

DIR holds another version of the repository, for instance the parent
commit unpacked with ``git archive``.  Each measurement runs in a process
of its own that imports ``flashmoe_tpu_torch`` from one tree (and builds
that tree's kernels); the trees take turns, other, this, this, other, ...,
so both are measured on the same card in the same call.  Per run:

* the gate (Mixtral: H 4096, E 8, top-2, bf16) at prefill (1024 tokens)
  and decode (4 tokens): ``router_cuda`` on CUDA events, and its
  kernels' device time from torch.profiler;
* the grouped FFN (B2) and its gather-fused twin (B3), routing by the
  top-k of random logits: SwiGLU at Mixtral widths (E 8, H 4096, I 14336,
  top-2) at prefill (1024 tokens) and decode (4) and at Qwen3-Next's MoE
  widths (E 512, H 2048, I 512, top-10) at 8192 tokens and at 4, and
  GELU, not gated, at the FlashMoE reference config's (E 64, H = I =
  2048, top-2) at 8192 tokens and at 4: ``grouped_ffn_cuda`` and
  ``grouped_ffn_tokens_cuda`` on CUDA events, and their kernels' device
  time (the work list's launch included);
* the grouped matmul at the training step's backward shapes (2560 rows of
  8 experts, 64 rows of padding past num_rows; K 4096 -> N 14336 and
  K 14336 -> N 4096, bf16 in, f32 out): ``grouped_matmul_cuda`` on CUDA
  events, and its kernels' device time;
* the transposed grouped matmul (B8) at the same rows, d_w_up (K 4096,
  N 14336) and d_w_down (K 14336, N 4096), f32 out: ``tgmm_cuda`` on
  CUDA events, and its kernel's device time;
* flash attention (B9) at the prefill's shape ([4, 32, 256, 128], 8 kv
  heads, causal, bf16): ``flash_attention_cuda`` on CUDA events, and its
  kernel's device time;
* the residual-saving FFN (B6) at the Mixtral prefill's rows (2048 live
  of about 2560, the train step's shape): ``grouped_ffn_res_cuda`` on
  CUDA events, and its kernels' device time;
* the fused EP kernel's full-precision arms, bf16 and f32, and its int8
  arm (B5q; SwiGLU, the ``batched`` order), with 8 ranks of one Mixtral
  expert each, slabs of 128 rows, 64-128 of them sent:
  ``fused_shard_cuda`` on CUDA events, and its kernel's device time;
* the ep layers: one Mixtral-width MoE layer at 8192 tokens over 8
  virtual ranks, fused (B5) and collective, on CUDA events;
* serving: Mixtral-8x7B widths with 4 layers, 4 prompts of 256 tokens: a
  prefill and a decode step, host clock around work ended by a
  synchronize (median of 5);
* training: Mixtral-8x7B widths with 2 layers, AdamW, 4 x 257 tokens: one
  ``make_train_step`` step (median of 3 after one warm-up);
* the two-pass gate (B4a, B4b) at Qwen3-Next's MoE widths (H 2048, E
  512, top-10, bf16) at 8192 tokens and at 4: ``gate_pass1_cuda`` (with
  the logits) and ``gate_pass2_cuda`` on CUDA events, their kernels'
  device time (pass 2's final reduction, ``gate_reduce``, in a row of
  its own where it is a launch of its own), and the device time of the
  library calls that compute the same functions (``matmul`` +
  ``softmax`` + ``topk``; ``softmax().sum(0)`` + ``bincount`` +
  ``logsumexp``); then the many-expert layer that runs them (those
  widths, I 512, one shared expert, 8192 tokens, gather-fused) on CUDA
  events and as the device time of all its kernels.

``--groups`` keeps some of the parts: ``gate``, ``ffn``, ``gmm``,
``tgmm``, ``flash``, ``fused``, ``paths`` (serving, the ep layers,
training), ``b4``.

Prints one line a run, then one JSON object with every run as the last
line.  Needs a CUDA device.

    python3 chip_ab.py --ptxas grouped_ffn.cu [SOURCE ...]

compiles those sources of this tree as the build does and prints each
kernel's registers, stack, spills and static shared memory (``nvcc
-Xptxas -v``), whether ptxas serialized its wgmma (info C7510 / C7514),
and its count of HGMMA (wgmma) instructions (``cuobjdump -sass``).
Needs nvcc, not a device.
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
#: the parts of a run, in order (``--groups``): the gate (B1), the grouped
#: FFN (B2, B3, B6), grouped matmul (B7), transposed grouped matmul (B8),
#: flash attention (B9), the fused EP kernel (B5, B5q), serving, the ep
#: layers and training, and the two-pass gate (B4a, B4b)
GROUPS = ("gate", "ffn", "gmm", "tgmm", "flash", "fused", "paths", "b4")


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def worker(tree: str, groups: list[str]) -> dict:
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
        ``word`` (or one of the words of a tuple), from torch.profiler;
        with ``word`` None, of every kernel (a library call's)."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        words = (word,) if isinstance(word, str) else word
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA
                 and (words is None or ("fm::" in e.key
                                        and any(w in e.key for w in words))))
        return us / 1e3 / iters

    g = torch.Generator(device="cuda").manual_seed(0)
    if "gate" in groups:
        gcfg = config.MoEConfig(num_experts=8, expert_top_k=2,
                                hidden_size=4096, dtype=torch.bfloat16)
        w = (torch.randn(4096, 8, device="cuda", generator=g) / 64).to(
            torch.bfloat16)
        for tag, s in (("prefill", 1024), ("decode", 4)):
            x = torch.randn(s, 4096, device="cuda", generator=g,
                            dtype=torch.bfloat16)
            res[f"gate_{tag}_wrapper_ms"] = events_ms(
                lambda: gate.router_cuda(x, w, gcfg), 200)
            res[f"gate_{tag}_kernel_ms"] = device_ms(
                lambda: gate.router_cuda(x, w, gcfg), 50, "gate")

    if "ffn" in groups:
        from flashmoe_tpu_torch.ops import ragged
        for wname, e, h, i, k, s_pre, act in (
                ("mixtral", 8, 4096, 14336, 2, 1024, "silu"),
                ("qwen3next", 512, 2048, 512, 10, 8192, "silu"),
                ("flashmoe_ref", 64, 2048, 2048, 2, 8192, "gelu")):
            gated = act == "silu"
            fcfg = config.MoEConfig(num_experts=e, expert_top_k=k,
                                    hidden_size=h, intermediate_size=i,
                                    gated_ffn=gated, hidden_act=act,
                                    drop_tokens=False, dtype=torch.bfloat16)
            ws = [(torch.randn(*sh, device="cuda", generator=g)
                   / sh[-2] ** 0.5).to(torch.bfloat16)
                  for sh in ((e, h, i), (e, i, h), (e, h, i))]
            b_up = torch.randn(e, i, device="cuda", generator=g) / 8
            b_down = torch.randn(e, h, device="cuda", generator=g) / 8
            x = torch.randn(s_pre, h, device="cuda", generator=g,
                            dtype=torch.bfloat16)
            ids = torch.randn(s_pre, e, device="cuda", generator=g).topk(k)[1]
            for tag, s in (("prefill", s_pre), ("decode", 4)):
                plan = ragged.make_ragged_plan(ids[:s], fcfg, expert.ROW_TILE)
                xs = x[:s].contiguous()
                xbuf = ragged.ragged_dispatch(xs, plan, fcfg, expert.ROW_TILE)
                kw = dict(act_name=act, gated=gated, block_m=expert.ROW_TILE,
                          num_rows=plan.num_rows)
                rest = (plan.tile_gid, ws[0], b_up, ws[1], b_down,
                        ws[2] if gated else None)

                def b2(xbuf=xbuf, rest=rest, kw=kw):
                    return expert.grouped_ffn_cuda(xbuf, *rest, **kw)

                def b3(xs=xs, src=plan.src_tok, rest=rest, kw=kw):
                    return expert.grouped_ffn_tokens_cuda(xs, src, *rest, **kw)

                def b6(xbuf=xbuf, rest=rest, kw=kw):
                    return expert.grouped_ffn_res_cuda(xbuf, *rest, **kw)

                iters = 50 if tag == "decode" else 10
                fns = (("b2", b2), ("b3", b3))
                if wname == "mixtral" and tag == "prefill":
                    fns += (("b6", b6),)
                for name, fn in fns:
                    key = f"ffn_{wname}_{tag}_{name}"
                    res[f"{key}_wrapper_ms"] = events_ms(fn, iters)
                    res[f"{key}_kernel_ms"] = device_ms(fn, 5,
                                                        ("ffn", "gmm_plan"))
            del ws, x, xbuf
        torch.cuda.empty_cache()

    tiles = [5, 5, 6, 4, 5, 5, 5, 5]
    gid = torch.tensor([e for e, c in enumerate(tiles) for _ in range(c)],
                       dtype=torch.int32, device="cuda")
    t = gid.numel() * 64
    nrow = torch.tensor(t - 64, device="cuda")
    if "gmm" in groups:
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

    if "tgmm" in groups:
        # the transposed grouped matmul (B8) at the same rows: d_w_up = x^T
        # d_up and d_w_down = hidden^T dy, f32 [8, K, N] out
        for tag, k, n in (("d_w_up", 4096, 14336), ("d_w_down", 14336, 4096)):
            a = torch.randn(t, k, device="cuda", generator=g,
                            dtype=torch.bfloat16)
            b = torch.randn(t, n, device="cuda", generator=g,
                            dtype=torch.bfloat16)

            def call(a=a, b=b):
                return expert.tgmm_cuda(a, b, gid, 8, num_rows=nrow)

            res[f"tgmm_{tag}_wrapper_ms"] = events_ms(call, 10)
            res[f"tgmm_{tag}_kernel_ms"] = device_ms(call, 5, "tgmm")
            del a, b
        torch.cuda.empty_cache()

    if "flash" in groups:
        # flash attention (B9) at the prefill's shape: Mixtral's 32 query and
        # 8 kv heads, 4 prompts of 256 tokens, causal
        from flashmoe_tpu_torch.ops import attention
        q = torch.randn(4, 32, 256, 128, device="cuda", generator=g,
                        dtype=torch.bfloat16)
        kv = [torch.randn(4, 8, 256, 128, device="cuda", generator=g,
                          dtype=torch.bfloat16) for _ in range(2)]

        def flash():
            return attention.flash_attention_cuda(q, *kv)

        res["flash_prefill_wrapper_ms"] = events_ms(flash, 200)
        res["flash_prefill_kernel_ms"] = device_ms(flash, 50, "flash")
        del q, kv

    if "fused" in groups:
        from flashmoe_tpu_torch.parallel import fused
        d, h, i = 8, 4096, 14336
        cnt = torch.randint(64, 129, (d, d, 1), device="cuda", generator=g)
        b_up = torch.zeros(d, i, device="cuda")
        b_down = torch.zeros(d, h, device="cuda")
        from flashmoe_tpu_torch import quant
        for tag, dt in (("bf16", torch.bfloat16), ("f32", torch.float32),
                        ("int8", torch.bfloat16)):
            x_send = torch.randn(d, d, 1, 128, h, device="cuda",
                                 generator=g).to(dt)
            ws = [(torch.randn(d, k, n, device="cuda", generator=g)
                   / k ** 0.5).to(dt) for k, n in ((h, i), (i, h), (h, i))]
            sc = {}
            if tag == "int8":  # B5q: the payloads and their scales
                pairs = [quant.quantize_channelwise(wt, "int8") for wt in ws]
                ws = [pl for pl, _ in pairs]
                sc = dict(zip(("wup_sc", "wdn_sc", "wg_sc"),
                              (sc_ for _, sc_ in pairs)))

            def call(x_send=x_send, ws=ws, sc=sc):
                return fused.fused_shard_cuda(
                    cnt, None, x_send, ws[0], b_up, ws[1], b_down, ws[2],
                    act_name="silu", gated=True, schedule="batched", **sc)

            res[f"fused_{tag}_gated_wrapper_ms"] = events_ms(call, 10)
            res[f"fused_{tag}_gated_kernel_ms"] = device_ms(call, 5,
                                                            "fused_ep")
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

    if "paths" in groups:
        cfg = presets.mixtral_8x7b(num_layers=4, param_dtype=torch.bfloat16)
        params = transformer.init_params(g, cfg, device="cuda")
        prompt = torch.randint(0, cfg.vocab_size, (4, 256), device="cuda",
                               generator=g)

        def prefill():
            cache = generate.init_cache(cfg, 4, 258, "cuda")
            logits, cache = generate.prefill_batched(params, cfg, prompt,
                                                     cache)
            return logits, cache

        prefill()
        res["serve_prefill_ms"] = host_ms(prefill, 5)
        logits, cache = prefill()
        tok = params["embed"].to(cfg.dtype)[logits.argmax(-1)][:, None, :]
        generate._decode_step(params, cfg, tok, cache, 256)
        res["serve_decode_step_ms"] = host_ms(
            lambda: generate._decode_step(params, cfg, tok, cache, 256), 5)
        del cache, logits, tok
        torch.cuda.empty_cache()

        # the ep layers: one Mixtral-width MoE layer at 8192 tokens over 8
        # virtual ranks, fused (B5) and collective (B2 on each rank)
        from flashmoe_tpu_torch.parallel import ep, fused, mesh
        moe0 = params["layers"][0]["moe"]
        m = mesh.local_mesh(8, device="cuda")
        ecfg = cfg.replace(ep=8)
        x = torch.randn(8192, cfg.hidden_size, device="cuda", generator=g,
                        dtype=torch.bfloat16)
        res["ep_layer_fused_ms"] = events_ms(lambda: fused.fused_ep_moe_layer(
            moe0, x, ecfg.replace(moe_backend="fused"), m), 3)
        res["ep_layer_collective_ms"] = events_ms(
            lambda: ep.ep_moe_layer(moe0, x, ecfg, m), 3)
        del params, moe0, x
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
        del state, box
        torch.cuda.empty_cache()

    if "b4" in groups:
        # the two-pass gate (B4a, B4b) at Qwen3-Next's MoE widths (H 2048,
        # E 512, top-10, bf16) at 8192 tokens and at 4
        h, e, k = 2048, 512, 10
        wg = (torch.randn(h, e, device="cuda", generator=g)
              / h ** 0.5).to(torch.bfloat16)
        xg = torch.randn(8192, h, device="cuda", generator=g,
                         dtype=torch.bfloat16)
        for tag, s in (("s8192", 8192), ("s4", 4)):
            x = xg[:s].contiguous()

            def p1(x=x):
                return gate.gate_pass1_cuda(x, wg, k, True)

            logits, m, se, _, top_i = p1()

            def p2(logits=logits, m=m, se=se, top_i=top_i):
                return gate.gate_pass2_cuda(logits, m, se, top_i, e)

            def lib1(x=x):
                return torch.topk(torch.softmax(
                    torch.matmul(x, wg).float(), -1), k)

            def lib2(logits=logits, top_i=top_i):
                return (torch.softmax(logits, -1).sum(0),
                        torch.bincount(top_i.reshape(-1), minlength=e),
                        torch.logsumexp(logits, -1).square().sum())

            key = f"b4_{tag}"
            iters = 200 if s == 4 else 50
            res[f"{key}_pass1_wrapper_ms"] = events_ms(p1, iters)
            res[f"{key}_pass1_kernel_ms"] = device_ms(p1, 20, "gate_pass1")
            res[f"{key}_pass1_library_ms"] = device_ms(lib1, 20, None)
            res[f"{key}_pass2_wrapper_ms"] = events_ms(p2, iters)
            res[f"{key}_pass2_kernel_ms"] = device_ms(p2, 20, "gate_pass2")
            res[f"{key}_reduce_kernel_ms"] = device_ms(p2, 20, "gate_reduce")
            res[f"{key}_pass2_library_ms"] = device_ms(lib2, 20, None)
        # the many-expert layer that runs them (Qwen3-Next's MoE widths, one
        # shared expert, 8192 tokens, gather-fused): CUDA events, and the
        # device time of all its kernels
        from flashmoe_tpu_torch.models import reference
        from flashmoe_tpu_torch.ops import moe
        lcfg = config.MoEConfig(
            num_experts=e, expert_top_k=k, hidden_size=h,
            intermediate_size=512, num_shared_experts=1, gated_ffn=True,
            hidden_act="silu", drop_tokens=False, sequence_len=8192,
            dtype=torch.bfloat16, param_dtype=torch.bfloat16,
            gather_fused=True)
        lp = reference.init_moe_params(g, lcfg, device="cuda")

        def layer():
            return moe.moe_layer(lp, xg, lcfg)

        res["b4_layer_ms"] = events_ms(layer, 10)
        res["b4_layer_device_ms"] = device_ms(layer, 3, None)
    return res


def ptxas_report(source: str) -> list[dict]:
    """Each kernel of this tree's ``csrc/<source>``, compiled as the build
    compiles it: registers, stack, spills and static shared memory from
    ``nvcc -Xptxas -v``, and the HGMMA (wgmma) instructions of its SASS
    from ``cuobjdump -sass``."""
    import re
    import tempfile

    sys.path.insert(0, HERE)
    from flashmoe_tpu_torch.kernels import _build

    nvcc = _build._nvcc()
    tools = os.path.dirname(nvcc)
    with tempfile.TemporaryDirectory() as work:
        obj = os.path.join(work, "k.o")
        log = subprocess.run(
            [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", obj,
             os.path.join(_build.CSRC, source)],
            capture_output=True, text=True, check=True)
        sass = subprocess.run([os.path.join(tools, "cuobjdump"), "-sass", obj],
                              capture_output=True, text=True,
                              check=True).stdout
    kernels, name, serialized = {}, None, set()
    for line in (log.stdout + log.stderr).splitlines():
        m = re.search(r"\((C751\d)\).*in the function '(\S+)'", line)
        if m:  # ptxas serialized the function's wgmma
            serialized.add(m.group(2))
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            kernels[name] = {"kernel": name}
        elif name and "spill stores" in line:
            nums = [int(v) for v in re.findall(r"(\d+) bytes", line)]
            kernels[name].update(stack=nums[0], spill_stores=nums[1],
                                 spill_loads=nums[2])
        elif name and "Used" in line and "registers" in line:
            kernels[name]["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
            m = re.search(r"(\d+) bytes smem", line)
            kernels[name]["static_smem"] = int(m.group(1)) if m else 0
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = 0
        elif name and "HGMMA" in line:
            counts[name] += 1
    names = list(kernels)
    plain = subprocess.run([os.path.join(tools, "cu++filt")], input="\n".join(
        names), capture_output=True, text=True).stdout.splitlines()
    for mangled, readable in zip(names, plain):
        kernels[mangled].update(kernel=readable,
                                hgmma=counts.get(mangled, 0),
                                wgmma_serialized=mangled in serialized)
    return list(kernels.values())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="root of the other tree")
    ap.add_argument("--ptxas", nargs="+", metavar="SOURCE",
                    help="instead: report registers, spills, shared memory "
                    "and HGMMA counts of each kernel of these csrc/ sources")
    ap.add_argument("--rounds", type=int, default=2,
                    help="pairs of turns for each tree (default 2)")
    ap.add_argument("--groups", default=",".join(GROUPS),
                    help="comma-separated parts to time: " + ", ".join(
                        GROUPS) + " (default: all)")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    groups = args.groups.split(",")
    if any(k not in GROUPS for k in groups):
        print(f"chip_ab: unknown groups in {groups}", file=sys.stderr)
        return 2
    if args.worker:
        print(json.dumps(worker(args.worker, groups)))
        return 0
    if args.ptxas:
        rows = [dict(r, source=src) for src in args.ptxas
                for r in ptxas_report(src)]
        for r in rows:
            print(" ".join(f"{k}={v}" for k, v in r.items()))
        print(json.dumps({"gpu": gpu_line(), "kernels": rows}))
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
            [sys.executable, os.path.abspath(__file__), "--worker", tree,
             "--groups", args.groups],
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
