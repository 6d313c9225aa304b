#!/usr/bin/env python3
"""Where the Hopper kernels' time goes: time bf16 B2, B3, B6, B5, B7, B8,
B9, B4a and B4b in builds of this tree with one piece of a kernel
(``csrc/grouped_ffn.cu``, ``csrc/ffn_hopper.cuh``, the fused kernel's
task list, ``csrc/grouped_matmul.cu``, ``csrc/tgmm.cu``,
``csrc/flash_attention.cu``, ``csrc/gate_tiled.cu``) knocked out, on one
card:

    python3 chip_ablate.py [--cuts base,noact,...] [--groups ffn,b5,b7,b8]

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
  each thread's proxy fence before the warpgroup's barrier;
* ``b8_store_wait``: B8's consumer warpgroups wait until a tile's TMA
  stores have completed, and only then release the ring's last stage, so
  the stores no longer drain under the next tile's loads and products;
* ``b9_one_stage``: B9's K/V ring holds one stage, so each key block
  loads only after the last one's products;
* ``b9_report``: B9's barrier waits print a message before they trap,
  as the other Hopper kernels' do; the printf is a call inside the wgmma
  pipeline, so ptxas serializes every wgmma of the kernel (C7510);
* ``b8_quiet``: B8's barrier waits trap without the message, so that
  ptxas no longer serializes its wgmma;
* ``b7_report`` / ``b7_quiet``: B7's barrier waits print before they
  trap in both layouts of w / in neither (the tree: the w [E, K, N] arm
  quiet, the transpose_w arm with the message);
* ``b7_bands``: B7 walks its items in bands of 24 MB of rows, each band
  over every column block before the next (so that a band's rows stay in
  L2 while the weight streams past), not all items item-fastest;
* ``b9_accurate_exp``: B9's softmax takes the accurate ``expf`` in place
  of ``__expf`` (the special function unit's ex2.approx of x log2 e);
* ``b9_per_block``: B9 launches one block a work item instead of its
  persistent grid (each block then takes one item);
* ``b9_nos``: B9 issues no S = Q K^T products (their loads, waits and
  barriers stay);
* ``b9_three_tiles``: B9 with three consumer warpgroups, three tiles a
  work item, at 160 registers (the producer at 24);
* ``b4_nospill``: B4a writes no logits;
* ``b4_notopk``: B4a runs no selection rounds (its top-k stays empty);
* ``b4_wide``: B4a's other warpgroup split, each consumer 256 columns
  of a 512-expert tile (m64n256k16) with a ring of 2 stages of 72 KB, in
  place of 128 columns of a 256-expert tile with 4 stages of 40 KB;
* ``b4_report``: B4a's barrier waits print a message before they trap
  (ptxas then serializes its wgmma, C7510);
* ``b4_spill_direct``: B4a spills the logits straight from the
  fragments, as where E % 4 != 0, not by TMA from the staging boxes;
* ``b4_one_chain``: B4a's selection rounds scan each row's logits in
  one dependent chain, not in four;
* ``b4_fast_exp``: B4a's sums of exp on ``__expf``;
* ``b4b_scalar``: B4b reads the logits 4 bytes a thread, not 16.

The epilogue pieces (``noact``, ``fast_act``, ``mma2x``) live in
``ffn_hopper.cuh`` and cut B5 as well; ``nostore`` cuts only the staging
boxes' TMA stores, which B5 does not use.

Knocked-out builds compute wrong values: only their times mean anything.
Per cut and shape (Mixtral widths: E 8, H 4096, I 14336, top-2 of 1024
tokens and of 4; Qwen3-Next's MoE widths: E 512, H 2048, I 512, top-10
of 8192 tokens and of 4; SwiGLU, routing by the top-k of random logits):
B2's and B3's wrapper time on CUDA events, and each kernel's device time
from torch.profiler; B6's at the Mixtral prefill's rows; B5's and B5q's
(int8) at the ep path's shapes (8 ranks of one Mixtral expert each,
slabs of 128 rows, 16-48 sent); B7's w [E, K, N] arm at the fused
backward's recompute ([8192, 4096] @ [1, 4096, 14336], f32 out: the full
slab, and the first 4 of each 16-tile slab live, the fused backward's
occupancy) and its transpose_w arm at the train step's dHidden and dX
(2560 rows, 2496 live, K 4096 and 14336, N 14336 and 4096, 8 experts);
B8's at the train step's two shapes (2560 rows, 2496 live, d_w_up K 4096
N 14336, d_w_down K 14336 N 4096); B9's at the prefill's ([4, 32, 256,
128], 8 kv heads, causal), and its device time at T 64 and 1024; B4a's
(with the logits) and B4b's at Qwen3-Next's widths (H 2048, E 512,
top-10, bf16) at S 8192 and 4.  ``--groups`` keeps some of them: ``ffn``
(B2, B3, B6), ``b5`` (B5, B5q), ``b7``, ``b8``, ``b9``, ``b4``.
Prints one line a cut and shape, then one JSON object with every result
as the last line.  Needs a CUDA device.
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
TGMM = "flashmoe_tpu_torch/csrc/tgmm.cu"
GMM = "flashmoe_tpu_torch/csrc/grouped_matmul.cu"
FLASH = "flashmoe_tpu_torch/csrc/flash_attention.cu"
GT = "flashmoe_tpu_torch/csrc/gate_tiled.cu"

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
_B8_RELEASE = "    if (prev >= 0 && tid == 0) hg::mbar_arrive(&sm.empty[prev]);\n"
_B8_STORE = """    const int row0 = tl.k0 + wg * hg::WG_ROWS;
    if (row0 < K)  // the same for the whole warpgroup
      hg::store_f32(d, smem.out[wg][0], smem.out[wg][1], &tout, row0, tl.n0,
                    N, wg, tid, tl.e);
"""
_PAIRED = """    return [(tiles[i], tiles[i + 1] if i + 1 < len(tiles) else -1)
            for i in range(0, len(tiles), 2)]"""

# B7's walk in bands of items whose rows fit in L2: tile t of band t /
# (band * ncols) is item t % nb of column block t / nb from the band's
# start (nb the band's items)
_B7_WALK = """
constexpr size_t HG_BAND_BYTES = 24u << 20;
struct GmmWalk {
  int items, band, ncols;
  __device__ __forceinline__ int total() const { return items * ncols; }
  __device__ __forceinline__ void at(int t, int& item, int& col) const {
    const int b0 = t / (band * ncols) * band;
    const int nb = min(band, items - b0);
    const int local = t - b0 * ncols;
    item = b0 + local % nb;
    col = local / nb;
  }
};
"""
_B7_BANDS = [
    (GMM, "template <bool MN> constexpr bool HG_REPORT = !MN;\n",
     "template <bool MN> constexpr bool HG_REPORT = !MN;\n" + _B7_WALK),
    (GMM, "           OutT* __restrict__ out, int N, int K) {",
     "           OutT* __restrict__ out, int N, int K, int band) {"),
    (GMM, "  const int total = items * ((N + HG_BN - 1) / HG_BN);",
     "  const GmmWalk walk{items, min(band, items), (N + HG_BN - 1) / HG_BN};"
     "\n  const int total = walk.total();"),
    (GMM, """      const int4 it = work[t % items];
      if (it.z < 0) continue;
      const int n0 = (t / items) * HG_BN;""",
     """      int item, col;
      walk.at(t, item, col);
      const int4 it = work[item];
      if (it.z < 0) continue;
      const int n0 = col * HG_BN;"""),
    (GMM, """    const int4 it = work[t % items];
    const int n0 = (t / items) * HG_BN;""",
     """    int item, col;
    walk.at(t, item, col);
    const int4 it = work[item];
    const int n0 = col * HG_BN;"""),
    (GMM, "      tx, tw, tout, work, n_work, (OutT*)out, N, K);",
     "      tx, tw, tout, work, n_work, (OutT*)out, N, K,\n"
     "      (int)(HG_BAND_BYTES / (HG_CONSUMERS * hg::WG_ROWS * 2) / K > 0\n"
     "                ? HG_BAND_BYTES / (HG_CONSUMERS * hg::WG_ROWS * 2) / K\n"
     "                : 1));"),
]

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
    # B8's consumers wait until a tile's stores have completed, and only
    # then release the ring's last stage, before the next tile
    "b8_store_wait": [(TGMM, _B8_RELEASE + _B8_STORE,
                       _B8_STORE + "    if (tid == 0) hg::bulk_wait<0>();\n"
                       "    asm volatile(\"bar.sync %0, 128;\\n\" ::\"r\"(1 + wg));\n"
                       + _B8_RELEASE)],
    # B9's K/V ring of one stage: each key block loads after the last
    # one's products
    "b9_one_stage": [(FLASH, "constexpr int FA_STAGES = 3;",
                      "constexpr int FA_STAGES = 1;")],
    # B9's barrier waits print before they trap, as the other Hopper
    # kernels' do: a printf call inside the wgmma pipeline, so ptxas
    # serializes every wgmma of the kernel (its info C7510); B8's trap
    # without the message, so that its wgmma are not serialized
    "b9_report": [(FLASH, "hg::mbar_wait<false>(", "hg::mbar_wait(")],
    "b8_quiet": [(TGMM, "hg::mbar_wait(", "hg::mbar_wait<false>(")],
    # B7's barrier waits print before they trap in both arms / in neither
    "b7_report": [(GMM, "template <bool MN> constexpr bool HG_REPORT = !MN;",
                   "template <bool MN> constexpr bool HG_REPORT = true;")],
    "b7_quiet": [(GMM, "template <bool MN> constexpr bool HG_REPORT = !MN;",
                  "template <bool MN> constexpr bool HG_REPORT = false;")],
    # B7 walks its items band by band (the code carried whole)
    "b7_bands": _B7_BANDS,
    # B9's softmax on the accurate expf in place of the special function
    # unit's exponential (__expf: ex2.approx of x log2 e)
    "b9_accurate_exp": [(FLASH, "const float p = __expf(",
                         "const float p = expf(")],
    # B9 on a grid of one work item a block, in place of the persistent
    # snake (the first design of PR 9: each wave paid its loads' and
    # stores' latency)
    "b9_per_block": [(FLASH, "const int grid = min(items, flash_sms());",
                      "const int grid = items;")],
    # B9 issues no S = Q K^T products
    "b9_nos": [(FLASH, "    hg::wgmma_m64n64k16(s, ",
                "    if (false) hg::wgmma_m64n64k16(s, ")],
    # B9 with three consumer warpgroups (three tiles a work item) at 160
    # registers, the producer at 24
    "b9_three_tiles": [
        (FLASH, "constexpr int FA_CONSUMERS = 2;", "constexpr int FA_CONSUMERS = 3;"),
        (FLASH, "setmaxnreg.dec.sync.aligned.u32 40;", "setmaxnreg.dec.sync.aligned.u32 24;"),
        (FLASH, "setmaxnreg.inc.sync.aligned.u32 232;", "setmaxnreg.inc.sync.aligned.u32 160;")],
    # B4a writes no logits (its staging boxes and TMA stores idle)
    "b4_nospill": [(GT, "      if (logits != nullptr) {\n        if (spill_tma)",
                    "      if (logits != nullptr && E < 0) {\n"
                    "        if (spill_tma)")],
    # B4a runs no selection rounds (no top-k; its (m, se) stay)
    "b4_notopk": [(GT, "  for (;;) {\n    float bv[2];",
                   "  for (; K < 0;) {\n    float bv[2];")],
    # B4a's other warpgroup split: each consumer takes 256 columns of a
    # 512-expert tile (m64n256k16), x read once per 512 experts; a stage
    # is then 72 KB, so the ring holds 2
    "b4_wide": [(GT, "constexpr int G1_ET = 256;", "constexpr int G1_ET = 512;"),
                (GT, "return fm::pass1_hopper_launch<4>(",
                 "return fm::pass1_hopper_launch<2>(")],
    # B4a's barrier waits print before they trap (a call in the kernel:
    # ptxas serializes its wgmma, C7510)
    "b4_report": [(GT, "hg::mbar_wait<false>(", "hg::mbar_wait(")],
    # B4a spills the logits from the fragments (8-byte stores), as it
    # does where E % 4 != 0, not through the staging boxes and TMA
    "b4_spill_direct": [(GT, "const int spill_tma = logits != nullptr && "
                         "E % 4 == 0;",
                         "const int spill_tma = logits != nullptr && E < 0;")],
    # B4a's selection rounds scan a row's logits in one chain, not four
    "b4_one_chain": [(GT, "constexpr int G1_SCAN = 4;",
                      "constexpr int G1_SCAN = 1;")],
    # B4a's sum of exp(logit - m) on the special function unit's __expf
    "b4_fast_exp": [(GT, "part += expf(", "part += __expf(")],
    # B4b reads the logits 4 bytes a thread, not 16
    "b4b_scalar": [(GT, "  if (E % 4 == 0)\n    fm::gate_pass2<true>",
                    "  if (E < 0)\n    fm::gate_pass2<true>")],
}

GROUPS = ("ffn", "b5", "b7", "b8", "b9", "b4")
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


def worker(tree: str, groups: list[str]) -> dict:
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
    for name, e, h, i, k, s_pre in SHAPES if "ffn" in groups else ():
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

    if "b7" in groups:
        # B7's w [E, K, N] arm at the fused backward's recompute: one
        # owner's 8 slabs of 1024 rows, the full slab, then the first 4
        # tiles of each 16-tile slab live (dead tiles -1)
        xr = torch.randn(8192, 4096, device="cuda", generator=g,
                         dtype=torch.bfloat16)
        wk = (torch.randn(1, 4096, 14336, device="cuda", generator=g)
              / 64).to(torch.bfloat16)
        full = torch.zeros(128, dtype=torch.int32, device="cuda")
        live = torch.where(torch.arange(128, device="cuda") % 16 < 4,
                           full, -1).to(torch.int32)
        for tag, gid in (("full", full), ("live", live)):
            def b7(gid=gid):
                return expert.grouped_matmul_cuda(
                    xr, gid, wk, out_dtype=torch.float32)

            res[f"b7_recompute_{tag}"] = {"b7_ms": events_ms(b7, 10),
                                          "b7_kernels_ms": kernels_ms(b7, 5)}
        del xr, wk
        # and its transpose_w arm at the train step's dHidden and dX
        gid = torch.tensor([e for e, c in enumerate((5, 5, 6, 4, 5, 5, 5, 5))
                            for _ in range(c)], device="cuda")
        nrow = torch.tensor(gid.numel() * 64 - 64, device="cuda")
        for tag, k, n in (("d_hidden", 4096, 14336), ("d_x", 14336, 4096)):
            a = torch.randn(gid.numel() * 64, k, device="cuda", generator=g,
                            dtype=torch.bfloat16)
            wt = (torch.randn(8, n, k, device="cuda", generator=g)
                  / 64).to(torch.bfloat16)

            def b7t(a=a, wt=wt):
                return expert.grouped_matmul_cuda(
                    a, gid, wt, transpose_w=True, out_dtype=torch.float32,
                    num_rows=nrow)

            res[f"b7_{tag}"] = {"b7_ms": events_ms(b7t, 10),
                                "b7_kernels_ms": kernels_ms(b7t, 5)}
            del a, wt
        torch.cuda.empty_cache()
    if "b8" in groups:  # B8 at the train step's rows (2048 live of 2560)
        gid = torch.tensor([e for e, c in enumerate((5, 5, 6, 4, 5, 5, 5, 5))
                            for _ in range(c)], device="cuda")
        rows = gid.numel() * 64
        nrow = torch.tensor(rows - 64, device="cuda")
        for tag, k, n in (("d_w_up", 4096, 14336),
                          ("d_w_down", 14336, 4096)):
            a = torch.randn(rows, k, device="cuda", generator=g,
                            dtype=torch.bfloat16)
            b = torch.randn(rows, n, device="cuda", generator=g,
                            dtype=torch.bfloat16)

            def b8(a=a, b=b):
                return expert.tgmm_cuda(a, b, gid, 8, num_rows=nrow)

            res[f"b8_{tag}"] = {"b8_ms": events_ms(b8, 10),
                                "b8_kernels_ms": kernels_ms(b8, 5)}
            del a, b
        torch.cuda.empty_cache()
    if "b9" in groups:  # B9 at the prefill's shape
        from flashmoe_tpu_torch.ops import attention
        q, k, v = (torch.randn(4, nh, 256, 128, device="cuda", generator=g,
                               dtype=torch.bfloat16) for nh in (32, 8, 8))

        def b9():
            return attention.flash_attention_cuda(q, k, v)

        res["b9_prefill"] = {"b9_ms": events_ms(b9, 200),
                             "b9_kernels_ms": kernels_ms(b9, 50)}
        # the same heads at one key block a tile (T 64) up to 16 (T
        # 1024): a fixed cost a call against the cost a key block
        for t in (64, 1024):
            qt, kt, vt = (torch.randn(4, nh, t, 128, device="cuda",
                                      generator=g, dtype=torch.bfloat16)
                          for nh in (32, 8, 8))
            res[f"b9_t{t}"] = {"b9_kernels_ms": kernels_ms(
                lambda: attention.flash_attention_cuda(qt, kt, vt), 50)}
    if "b4" in groups:  # B4a, B4b at Qwen3-Next's widths, S 8192 and 4
        from flashmoe_tpu_torch.ops import gate
        w = (torch.randn(2048, 512, device="cuda", generator=g)
             / 45).to(torch.bfloat16)
        xg = torch.randn(8192, 2048, device="cuda", generator=g,
                         dtype=torch.bfloat16)
        for tag, s in (("s8192", 8192), ("s4", 4)):
            x = xg[:s].contiguous()

            def b4a(x=x):
                return gate.gate_pass1_cuda(x, w, 10, True)

            logits, m, se, _, top_i = b4a()

            def b4b(logits=logits, m=m, se=se, top_i=top_i):
                return gate.gate_pass2_cuda(logits, m, se, top_i, 512)

            iters = 200 if s == 4 else 50
            res[f"b4_{tag}"] = {"b4a_ms": events_ms(b4a, iters),
                                "b4b_ms": events_ms(b4b, iters),
                                "b4a_kernels_ms": kernels_ms(b4a, 20),
                                "b4b_kernels_ms": kernels_ms(b4b, 20)}
        del xg, logits
        torch.cuda.empty_cache()
    if "b5" not in groups:
        return res

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
    ap.add_argument("--groups", default=",".join(GROUPS),
                    help="comma-separated kernels to time in every cut: "
                    "ffn (B2, B3, B6), b5 (B5, B5q), b7, b8, b9, b4 (B4a, "
                    "B4b; default: all)")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    groups = args.groups.split(",")
    if args.worker:
        print(json.dumps(worker(args.worker, groups)))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("chip_ablate: no CUDA device", file=sys.stderr)
        return 2
    cuts = args.cuts.split(",")
    unknown = [c for c in cuts if c not in CUTS] + [
        k for k in groups if k not in GROUPS]
    if unknown:
        print(f"chip_ablate: unknown cuts or groups {unknown}",
              file=sys.stderr)
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
                [sys.executable, os.path.abspath(__file__), "--worker", tree,
                 "--groups", args.groups],
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
