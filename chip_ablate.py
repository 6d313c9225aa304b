#!/usr/bin/env python3
"""Where the Hopper FFN's time goes: time bf16 B2, B3, B6 and B5 in builds
of this tree with one piece of the Hopper FFN (``csrc/grouped_ffn.cu``,
``csrc/ffn_hopper.cuh``, the fused kernel's task list) knocked out, on
one card:

    python3 chip_ablate.py [--cuts base,noact,...]

Each cut is a copy of ``flashmoe_tpu_torch`` (under a temporary
directory) with the cut's text patches applied; each copy
builds its kernels and is timed in a process of its own, one after the
other on the same card.  The cuts (``base`` is the tree as it is):

* ``noact``: the epilogue skips the activation (the gated up pass
  multiplies by the raw gate);
* ``fast_act``: the epilogue's activation with the special function
  unit's ``__expf`` and ``__fdividef`` in place of ``act_f``'s accurate
  ``expf`` and IEEE division;
* ``nostore``: the epilogue computes but writes no staging box and issues
  no TMA store;
* ``noloadA`` / ``noloadB``: the producer loads the A (rows) / B (weight)
  boxes only for a tile's first K-step, so later stages reuse stale data;
* ``mma2x``: every stage's products are issued twice;
* ``itemfast`` / ``colfast``: every pass walks its (item, column tile)
  pairs item-fastest / column-fastest;
* ``res_direct``: B6's up pass stores u and g straight from the
  accumulator fragments, not through the staging boxes and TMA stores
  it shares with hidden (three a chunk);
* ``b5_unpaired``: B5's items hold one row tile each (one consumer
  warpgroup of the block idles), not two paired across sources;
* ``b5q_noconvert`` / ``b5q_nofence``: B5q's consumer warpgroups
  convert nothing into the B tile (their loads and barriers stay) / skip
  each thread's proxy fence before the warpgroup's barrier.

The epilogue pieces (``noact``, ``fast_act``, ``mma2x``) live in
``ffn_hopper.cuh`` and cut B5 as well; ``nostore`` cuts only the staging
boxes' TMA stores, which B5 does not use.

Knocked-out builds compute wrong values: only their times mean anything.
Per cut and shape (Mixtral widths: E 8, H 4096, I 14336, top-2 of 1024
tokens and of 4; Qwen3-Next's MoE widths: E 512, H 2048, I 512, top-10 of
8192 tokens and of 4; SwiGLU, routing by the top-k of random logits): B2's
and B3's wrapper time on CUDA events, and each kernel's device time from
torch.profiler; B6's at the Mixtral prefill's rows; B5's and B5q's
(int8) at the ep path's shapes (8 ranks of one Mixtral expert each, slabs
of 128 rows, 16-48 sent).  Prints one line a cut and shape, then one JSON object
with every result as the last line.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
GFFN = "flashmoe_tpu_torch/csrc/grouped_ffn.cu"
FH = "flashmoe_tpu_torch/csrc/ffn_hopper.cuh"
FUSED = "flashmoe_tpu_torch/parallel/fused.py"
EP = "flashmoe_tpu_torch/csrc/fused_ep.cu"

_STORES = ("""    *reinterpret_cast<__nv_bfloat162*>(box + hg::sw128_offset(r, 2 * c)) =
        lo;
    *reinterpret_cast<__nv_bfloat162*>(
        box + hg::sw128_offset(r + 8, 2 * c)) = hi;""")
_STAGE = """#pragma unroll
    for (int m = 0; m < NB; ++m)
      hg::wgmma_stage_mn<BN>(d[m], sm.a[pos.stage][wg],
                             sm.b[pos.stage] + m * BN * hg::BK);"""
_EXPECT = "        hg::mbar_expect_tx(full, bytes);"
_B_BYTES = "(uint32_t)(NB * boxes * 64 * 64 * 2)"
_A_BYTES = "(uint32_t)((GATHER ? 0 : it.y * hg::A_TILE) * 2)"
_B_LOADS = """        for (int m = 0; m < NB; ++m)
          for (int j = 0; j < boxes; ++j)"""
_A_LOADS = """        if (!GATHER)
          for (int c = 0; c < it.y; ++c)"""
_DEQUANT = "      ep_dequant8<Q>(raw[i], box, s0, s1, k0 + 16 * i, c8);"
_ORDER = ("cols_inner(items_ > (int)gridDim.x && "
          "4 * ncols <= (int)gridDim.x)")
_RES_BOXES = """      if constexpr (RES) {
        ffn_box<MODE, ACT, 1, NB, BN>(d, bv, nullptr, ch, boxes, o.tu, stored,
                                      n0, row0, wg, tid);
        if (MODE == MODE_UP_GATED)
          ffn_box<MODE, ACT, 2, NB, BN>(d, bv, nullptr, ch, boxes, o.tg,
                                        stored, n0, row0, wg, tid);
      }"""
# u and g stored straight from the fragments: each thread's rows r and
# r + 8, the chunk's columns 8 jj + 2 (lane % 4) + {0, 1}
_RES_DIRECT = """      if constexpr (RES) {
        const int lane = tid % 32, r = tid / 32 * 16 + lane / 4;
        const size_t at = (size_t)(row0 + r) * N + n0 + EPI_COLS * ch;
        ffn_direct<MODE, ACT, 1, NB, BN>(d, bv, ch, o.U + at,
                                         o.U + at + (size_t)8 * N, lane);
        if (MODE == MODE_UP_GATED)
          ffn_direct<MODE, ACT, 2, NB, BN>(d, bv, ch, o.G + at,
                                           o.G + at + (size_t)8 * N, lane);
      }"""
_PAIRED = """    return [(tiles[i], tiles[i + 1] if i + 1 < len(tiles) else -1)
            for i in range(0, len(tiles), 2)]"""

# act_f with the special function unit's exponential and division (a few
# f32 ulp away; gelu's tanh(u) as 1 - 2 / (exp(2u) + 1))
_FAST_ACT = """#define _FAST_ACT(x) (ACT == ACT_RELU ? fmaxf((x), 0.f) \\
  : ACT == ACT_GELU ? 0.5f * (x) * (2.f - __fdividef(2.f, __expf(2.f * \\
      0.7978845608028654f * ((x) + 0.044715f * (x) * (x) * (x))) + 1.f)) \\
  : __fdividef((x), 1.f + __expf(-(x))))
"""

# name -> [(file of the tree, its text, the replacement)]; the pieces in
# ffn_hopper.cuh are B5's too
CUTS = {
    "base": [],
    "noact": [(FH, "  if (MODE == MODE_UP_GATED) return act_f(d1, ACT) * v;\n"
               "  if (MODE == MODE_UP) return act_f(v, ACT);",
               "  if (MODE == MODE_UP_GATED) return d1 * v;")],
    "fast_act": [(FH, "return act_f(d1, ACT) * v;",
                  "return _FAST_ACT(d1) * v;"),
                 (FH, "return act_f(v, ACT);", "return _FAST_ACT(v);"),
                 (FH, "template <int MODE, int ACT>\n__device__ "
                  "__forceinline__ float ffn_epi(",
                  _FAST_ACT + "template <int MODE, int ACT>\n"
                  "__device__ __forceinline__ float ffn_epi(")],
    "nostore": [(FH, _STORES, "    if (N < 0) {\n" + _STORES + "\n    }"),
                (FH, "  if (tid == 0) {\n    hg::tma_store_2d(",
                 "  if (tid == 0 && N < 0) {\n    hg::tma_store_2d(")],
    "noloadA": [(GFFN, _EXPECT, "        hg::mbar_expect_tx(full, kb == 0 ? "
                 "bytes : bytes - " + _A_BYTES + ");"),
                (GFFN, _A_LOADS, _A_LOADS.replace("if (!GATHER)",
                                                  "if (!GATHER && kb == 0)"))],
    "noloadB": [(GFFN, _EXPECT, "        hg::mbar_expect_tx(full, kb == 0 ? "
                 "bytes : bytes - " + _B_BYTES + ");"),
                (GFFN, _B_LOADS, "        if (kb == 0)\n" + _B_LOADS)],
    "mma2x": [(FH, _STAGE, _STAGE + "\n" + _STAGE)],
    "itemfast": [(GFFN, _ORDER, "cols_inner(false)")],
    "colfast": [(GFFN, _ORDER, "cols_inner(true)")],
    # B6's up pass stores u and g straight from the fragments, in place
    # of the staging boxes it shares with hidden (three TMA stores a chunk)
    "res_direct": [(FH, _RES_BOXES, _RES_DIRECT)],
    # B5's items hold one tile each: one consumer warpgroup idles
    "b5_unpaired": [(FUSED, _PAIRED, "    return [(c, -1) for c in tiles]")],
    # B5q's consumer warpgroups load the payloads and meet their
    # barriers but convert nothing into the B tile
    "b5q_noconvert": [(EP, _DEQUANT, "      if (tid < 0)\n" + _DEQUANT)],
    # B5q's consumer threads skip their proxy fence before the barrier
    "b5q_nofence": [(EP, "  hg::fence_async_smem();\n  wg_sync(wg);\n"
                     "  if (tid == 0) {\n    hg::mbar_arrive(&sm.ring.full[s]);",
                     "  wg_sync(wg);\n"
                     "  if (tid == 0) {\n    hg::mbar_arrive(&sm.ring.full[s]);")],
}

SHAPES = (("mixtral", 8, 4096, 14336, 2, 1024),
          ("qwen3next", 512, 2048, 512, 10, 8192))


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def make_tree(root: str, cut: str) -> str:
    """A copy of this tree's package with the cut's patches applied."""
    tree = os.path.join(root, cut)
    shutil.copytree(os.path.join(HERE, "flashmoe_tpu_torch"),
                    os.path.join(tree, "flashmoe_tpu_torch"),
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    for source, old, new in CUTS[cut]:
        path = os.path.join(tree, source)
        with open(path) as f:
            text = f.read()
        if old not in text:
            raise RuntimeError(f"cut {cut}: {source} no longer holds "
                               f"{old[:60]!r}")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    return tree


def worker(tree: str) -> dict:
    sys.path.insert(0, tree)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from flashmoe_tpu_torch import quant
    from flashmoe_tpu_torch.config import MoEConfig
    from flashmoe_tpu_torch.kernels import _build
    from flashmoe_tpu_torch.ops import expert, ragged

    assert expert.__file__.startswith(os.path.abspath(tree))
    _build.library()

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

    def kernels_ms(fn, iters):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        return {e.key.split("(")[0].replace("void fm::", ""):
                e.self_device_time_total / 1e3 / iters
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and "fm::" in e.key}

    res = {}
    g = torch.Generator(device="cuda").manual_seed(0)
    for name, e, h, i, k, s_pre in SHAPES:
        cfg = MoEConfig(num_experts=e, expert_top_k=k, hidden_size=h,
                        intermediate_size=i, gated_ffn=True,
                        hidden_act="silu", drop_tokens=False,
                        dtype=torch.bfloat16)
        ws = [(torch.randn(*sh, device="cuda", generator=g)
               / sh[-2] ** 0.5).to(torch.bfloat16)
              for sh in ((e, h, i), (e, i, h), (e, h, i))]
        b_up = torch.randn(e, i, device="cuda", generator=g) / 8
        b_down = torch.randn(e, h, device="cuda", generator=g) / 8
        x = torch.randn(s_pre, h, device="cuda", generator=g,
                        dtype=torch.bfloat16)
        ids = torch.randn(s_pre, e, device="cuda", generator=g).topk(k)[1]
        for tag, s in (("prefill", s_pre), ("decode", 4)):
            plan = ragged.make_ragged_plan(ids[:s], cfg, expert.ROW_TILE)
            xs = x[:s].contiguous()
            xbuf = ragged.ragged_dispatch(xs, plan, cfg, expert.ROW_TILE)
            kw = dict(act_name="silu", gated=True, block_m=expert.ROW_TILE,
                      num_rows=plan.num_rows)
            rest = (plan.tile_gid, ws[0], b_up, ws[1], b_down, ws[2])

            def b2(xbuf=xbuf, rest=rest, kw=kw):
                return expert.grouped_ffn_cuda(xbuf, *rest, **kw)

            def b3(xs=xs, src=plan.src_tok, rest=rest, kw=kw):
                return expert.grouped_ffn_tokens_cuda(xs, src, *rest, **kw)

            iters = 50 if tag == "decode" else 10
            res[f"{name}_{tag}"] = {
                "b2_ms": events_ms(b2, iters), "b3_ms": events_ms(b3, iters),
                "b2_kernels_ms": kernels_ms(b2, 5),
                "b3_kernels_ms": kernels_ms(b3, 5)}
            if name == "mixtral" and tag == "prefill":
                def b6(xbuf=xbuf, rest=rest, kw=kw):
                    return expert.grouped_ffn_res_cuda(xbuf, *rest, **kw)

                res[f"{name}_{tag}"].update(b6_ms=events_ms(b6, iters),
                                            b6_kernels_ms=kernels_ms(b6, 5))
        del ws, x
        torch.cuda.empty_cache()

    # B5 at the ep path's shapes: 8 ranks of one Mixtral expert each,
    # slabs of 128 rows of which 16-48 are sent, SwiGLU, batched
    from flashmoe_tpu_torch.parallel import fused
    d, h, i = 8, 4096, 14336
    cnt = torch.randint(16, 49, (d, d, 1), device="cuda", generator=g)
    x_send = torch.randn(d, d, 1, 128, h, device="cuda", generator=g,
                         dtype=torch.bfloat16)
    ws = [(torch.randn(d, k, n, device="cuda", generator=g) / k ** 0.5).to(
        torch.bfloat16) for k, n in ((h, i), (i, h), (h, i))]
    zeros = (torch.zeros(d, i, device="cuda"),
             torch.zeros(d, h, device="cuda"))

    pairs = [quant.quantize_channelwise(w, "int8") for w in ws]
    sc = dict(zip(("wup_sc", "wdn_sc", "wg_sc"), (s for _, s in pairs)))

    def b5(q=False):
        w = [p for p, _ in pairs] if q else ws
        return fused.fused_shard_cuda(
            cnt, None, x_send, w[0], zeros[0], w[1], zeros[1], w[2],
            act_name="silu", gated=True, schedule="batched",
            **(sc if q else {}))

    def b5q():
        return b5(True)

    res["ep_shapes"] = {"b5_ms": events_ms(b5, 10),
                        "b5q_int8_ms": events_ms(b5q, 10),
                        "b5_kernels_ms": kernels_ms(b5, 5),
                        "b5q_int8_kernels_ms": kernels_ms(b5q, 5)}
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cuts", default=",".join(CUTS),
                    help="comma-separated cuts (default: all)")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker)))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("chip_ablate: no CUDA device", file=sys.stderr)
        return 2
    cuts = args.cuts.split(",")
    unknown = [c for c in cuts if c not in CUTS]
    if unknown:
        print(f"chip_ablate: unknown cuts {unknown}", file=sys.stderr)
        return 2
    print(gpu_line())
    out = {}
    with tempfile.TemporaryDirectory() as root:
        trees = {cut: make_tree(root, cut) for cut in cuts}
        # build every copy at once, then time them one after the other
        build = ("import sys; sys.path.insert(0, sys.argv[1]); from "
                 "flashmoe_tpu_torch.kernels import _build; _build.library()")
        builds = [subprocess.Popen([sys.executable, "-c", build, tree],
                                   stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True)
                  for tree in trees.values()]
        for cut, proc in zip(trees, builds):
            log = proc.communicate()[0]
            if proc.returncode != 0:
                print(f"chip_ablate: cut {cut} does not build:\n{log[-4000:]}",
                      file=sys.stderr)
                return 1
        for cut, tree in trees.items():
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--worker", tree],
                capture_output=True, text=True, timeout=900, cwd=tree)
            if proc.returncode != 0:
                print(proc.stdout[-4000:], proc.stderr[-4000:],
                      file=sys.stderr)
                return 1
            out[cut] = json.loads(proc.stdout.strip().splitlines()[-1])
            for shape, r in out[cut].items():
                walls = " ".join(f"{k}={v:.4f}" for k, v in r.items()
                                 if not isinstance(v, dict))
                kernels = " ".join(
                    f"{k[:-len('_kernels_ms')]}:{n}={ms:.4f}"
                    for k, d in r.items() if k.endswith("_kernels_ms")
                    for n, ms in d.items())
                print(f"{cut} {shape}: {walls} {kernels}", flush=True)
    print(json.dumps({"gpu": gpu_line(), "cuts": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
