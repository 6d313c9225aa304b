"""MoE gate (router): GEMM + softmax + top-k + routing statistics.

Counterpart of ``flashmoe_tpu/ops/gate.py``.  Two gates, each a
hand-written Hopper kernel with its plain torch version beside it:

* the single-tile gate: :func:`router_cuda` (``csrc/gate.cu``, the port of
  ``_gate_kernel``) and :func:`router_plain` (the counterpart of
  ``router_xla``, the oracle), for E <= 256 and K <= 32;
* the two-pass expert-tiled gate: :func:`router_tiled_cuda` runs
  :func:`gate_pass1_cuda` (``fm_gate_pass1`` in ``csrc/gate_tiled.cu``, the
  port of ``_gate_pass1_kernel``) and, when the statistics are needed,
  :func:`gate_pass2_cuda` (``fm_gate_pass2``, the port of
  ``_gate_pass2_kernel``); :func:`router_tiled_plain` is their plain
  version.

:func:`router` chooses among them from the configuration alone, as the JAX
``router`` does (gate.py:532-558), and reaches a kernel through a
``torch.autograd.Function`` whose backward recomputes :func:`router_plain`
under autograd, as ``_router_pallas_ad`` and ``_router_tiled_ad`` do.
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple

import torch
import torch.nn.functional as F

from flashmoe_tpu_torch.chaos import inject as chaos_inject
from flashmoe_tpu_torch.config import MoEConfig
from flashmoe_tpu_torch.kernels import _build
from flashmoe_tpu_torch.models.reference import dot_f32, top_k_lowest_index

#: limits of the single-pass gate kernel (csrc/gate.cu GEMAX, GKMAX)
GATE_MAX_EXPERTS = 256
GATE_MAX_TOP_K = 32
#: the two-pass gate merges the carried top-k with a tile's K candidates,
#: 2K entries: at most 128 (one lane row on the TPU, gate.py:397-400;
#: csrc/gate_tiled.cu TILED_KMAX = 64).  Beyond that the plain router
#: runs, as JAX runs router_xla.
TILED_MAX_MERGE = 128
#: token rows of a pass-1 work item, and expert columns of the f32 arm's
#: tile (csrc/gate_tiled.cu); H is a multiple of it
GATE_TILE = 64
#: the JAX package's single-tile gate budget and lane width: JAX router
#: takes its single-tile gate while gate_vmem_bytes stays within it
_GATE_VMEM_BUDGET = 12 * 2**20
_LANE = 128


class RouterOutput(NamedTuple):
    """Routing decisions for one token shard.

    combine_weights: [S, K] f32 normalized weights of the selected experts.
    expert_idx:      [S, K] int64 selected expert ids.
    expert_counts:   [E] int64 (token, k) selections per expert.
    probs_mean:      [E] mean softmax probability per expert.
    aux_loss:        [] load-balancing loss (Switch-style).
    z_loss:          [] router z-loss (0 unless enabled).
    """

    combine_weights: torch.Tensor
    expert_idx: torch.Tensor
    expert_counts: torch.Tensor
    probs_mean: torch.Tensor
    aux_loss: torch.Tensor
    z_loss: torch.Tensor


def _finish(cfg: MoEConfig, top_p, top_idx, probs_sum, counts, zsum,
            s_tokens: int) -> RouterOutput:
    """Shared epilogue: normalize top-k weights, form aux/z losses."""
    denom = top_p.sum(-1, keepdim=True)
    combine_weights = (top_p / torch.clamp(denom, min=1e-20)).to(
        cfg.accum_dtype)
    probs_mean = probs_sum / s_tokens
    density = counts.to(cfg.accum_dtype) / (s_tokens * cfg.expert_top_k)
    aux = cfg.num_experts * torch.sum(density * probs_mean) \
        * cfg.expert_top_k
    z = (zsum / s_tokens) * cfg.router_z_loss_coef
    return RouterOutput(
        combine_weights=combine_weights,
        expert_idx=top_idx.long(),
        expert_counts=counts.long(),
        probs_mean=probs_mean,
        aux_loss=aux.to(cfg.accum_dtype),
        z_loss=z.to(cfg.accum_dtype),
    )


def router_plain(x, gate_w, cfg: MoEConfig) -> RouterOutput:
    """Router in plain torch (``router_xla``). x: [S, H], gate_w: [H, E].
    An armed ``skewed_routing`` point biases its logits (the chaos seam,
    ``gate.py:85-88``), as the gate kernel adds its bias operand."""
    logits = dot_f32(x, gate_w)
    if chaos_inject.is_armed("skewed_routing"):
        logits = chaos_inject.poison_logits(logits)
    probs = torch.softmax(logits, dim=-1)
    # the gate's rule for subnormals, the gate kernel's too (csrc/gate.cu):
    # XLA and the TPU flush them, so a probability under the smallest
    # normal f32 (a logit gap past ~87, as a skewed router's) is 0, and
    # its top-k ties break to the lowest index
    probs = torch.where(probs < torch.finfo(probs.dtype).tiny,
                        torch.zeros_like(probs), probs)
    top_p, top_idx = top_k_lowest_index(probs, cfg.expert_top_k)
    counts = torch.bincount(top_idx.reshape(-1),
                            minlength=cfg.num_experts)
    zsum = torch.sum(torch.square(torch.logsumexp(logits, dim=-1)))
    return _finish(cfg, top_p, top_idx, probs.sum(0), counts, zsum,
                   x.shape[0])


#: the gate kernel's token tile (csrc/gate.cu GT) and its most H slices
GATE_TOKENS = 16
GATE_MAX_SPLIT = 32


def gate_split(s: int, h: int, e: int, dtype: torch.dtype
               ) -> tuple[int, int]:
    """The gate kernel's grid for S tokens of width H and E experts:
    ``(token tiles, H slices)``.  A slice is a whole number of 64-byte
    chunks of a row (32 bf16 or 16 f32 of H); slice ``i`` of ``n`` holds
    chunks ``[C * i // n, C * (i + 1) // n)`` of the C chunks.  The slice
    count does not depend on S, so a token's logits are summed in the same
    order in any batch (the gate is batch-invariant): up to
    GATE_MAX_SPLIT slices (a decode step of 4 Mixtral tokens runs 32
    blocks), fewer where the partial logits written and read again
    (8 E bytes a slice and token) would pass half of x's bytes."""
    chunks = h // (64 // dtype.itemsize)
    by_bytes = h * dtype.itemsize // (16 * e)
    return -(-s // GATE_TOKENS), max(1, min(chunks, GATE_MAX_SPLIT,
                                            by_bytes))


def gate_slices(h: int, split: int, dtype: torch.dtype) -> list[range]:
    """The H range of each slice of :func:`gate_split`, in order."""
    ch = 64 // dtype.itemsize
    n = h // ch
    return [range(n * i // split * ch, n * (i + 1) // split * ch)
            for i in range(split)]


#: per device, the ticket counters of the gate kernel and of the two-pass
#: gate's pass 2: zeros that every launch leaves zero (its last blocks
#: reset them), grown when a launch needs more
_TICKETS: dict[torch.device, torch.Tensor] = {}


def _tickets(dev: torch.device, n: int) -> torch.Tensor:
    t = _TICKETS.get(dev)
    if t is None or t.numel() < n:
        t = torch.zeros((max(n, 4096),), dtype=torch.int32, device=dev)
        _TICKETS[dev] = t
    return t


def gate_args(x, gate_w, cfg: MoEConfig):
    """The arguments of one launch of the gate kernel (``fm_gate``) on
    checked CUDA tensors of one dtype, with its outputs and scratch made
    here: ``(args, RouterOutput, scratch)``.  The kernel writes every field
    of the RouterOutput as :func:`_finish` forms them, in f32.  An armed
    ``skewed_routing`` point becomes the launch's logit bias
    (:func:`flashmoe_tpu_torch.chaos.inject.logit_bias`).  The launch
    takes the kernel's ticket counters, so launches on one device run in
    one stream's order."""
    s, h = x.shape
    e, k = cfg.num_experts, cfg.expert_top_k
    dev = x.device
    tiles, split = gate_split(s, h, e, x.dtype)
    bias_e, bias = chaos_inject.logit_bias(e) or (-1, 0.0)
    f32 = dict(dtype=torch.float32, device=dev)
    i64 = dict(dtype=torch.int64, device=dev)
    out = RouterOutput(
        combine_weights=torch.empty((s, k), **f32),
        expert_idx=torch.empty((s, k), **i64),
        expert_counts=torch.empty((e,), **i64),
        probs_mean=torch.empty((e,), **f32),
        aux_loss=torch.empty((), **f32), z_loss=torch.empty((), **f32))
    # the partial logits, the tiles' probability sums, counts and z sums
    scratch = torch.empty((split * s * e + tiles * (2 * e + 1),), **f32)
    args = (int(x.dtype == torch.bfloat16), x.data_ptr(), gate_w.data_ptr(),
            s, h, e, k, split, float(cfg.router_z_loss_coef), bias_e, bias,
            scratch.data_ptr(), _tickets(dev, tiles + 1).data_ptr(),
            *(t.data_ptr() for t in out), _build.stream_of(x))
    return args, out, scratch


def router_cuda(x, gate_w, cfg: MoEConfig) -> RouterOutput:
    """The gate kernel (``csrc/gate.cu``) on CUDA tensors: one launch,
    which also forms the losses and normalised weights of :func:`_finish`.
    An armed ``skewed_routing`` point biases its logits in the kernel, as
    :func:`router_plain` biases its own.

    x: [S, H] and gate_w: [H, E], bf16 or f32.  When the two dtypes differ
    both are upcast to f32, which is exact, as the JAX router computes in
    f32 whatever it is given.  Raises on CPU tensors, other dtypes, or E
    and K beyond the single-pass kernel."""
    s, h = x.shape
    e, k = cfg.num_experts, cfg.expert_top_k
    if gate_w.shape != (h, e):
        raise ValueError(f"gate_w {tuple(gate_w.shape)} != ({h}, {e})")
    for t in (x, gate_w):
        if t.dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"router_cuda takes bf16 or f32, got {t.dtype}")
    if e > GATE_MAX_EXPERTS or k > GATE_MAX_TOP_K:
        raise ValueError(
            f"E={e}, K={k}: the single-pass gate kernel takes E <= "
            f"{GATE_MAX_EXPERTS}, K <= {GATE_MAX_TOP_K}; larger ones take "
            f"the two-pass gate (router_tiled_cuda)")
    if h % 32 or s < 1:
        raise ValueError(f"router_cuda needs S >= 1 and H % 32 == 0, got "
                         f"S={s}, H={h}")
    _build.refuse_autograd("router_cuda", x, gate_w)
    dt = x.dtype if x.dtype == gate_w.dtype else torch.float32
    x = x.to(dt).contiguous()
    gate_w = gate_w.to(dt).contiguous()
    _build.require_cuda("router_cuda", x, gate_w)
    args, out, _scratch = gate_args(x, gate_w, cfg)
    with torch.cuda.device(x.device):
        err = _build.library().fm_gate(*args)
    _build.check(err, "fm_gate")
    router_cuda.launches += 1
    if cfg.accum_dtype != torch.float32:
        out = out._replace(**{f: getattr(out, f).to(cfg.accum_dtype) for f in
                              ("combine_weights", "aux_loss", "z_loss")})
    return out


router_cuda.launches = 0


# ----------------------------------------------------------------------
# the two-pass expert-tiled gate
# ----------------------------------------------------------------------

def gate_pass1_plain(x, gate_w, k: int, need_logits: bool):
    """Plain torch version of pass 1: ``(logits [S, E] f32 or None, m [S],
    se [S], top_p [S, K], top_i [S, K])``, m the max logit, se the sum of
    exp(logit - m), top_i the K largest logits (lowest id first on
    ties) and top_p = exp(top_logit - m) / max(se, 1e-30)."""
    logits = dot_f32(x, gate_w)
    m = logits.max(-1).values
    se = torch.exp(logits - m[:, None]).sum(-1)
    top_l, top_i = top_k_lowest_index(logits, k)
    top_p = torch.exp(top_l - m[:, None]) \
        / torch.clamp(se, min=1e-30)[:, None]
    return logits if need_logits else None, m, se, top_p, top_i


def gate_pass2_plain(logits, m, se, top_i, num_experts: int):
    """Plain torch version of pass 2: ``(probs_sum [E], counts [E],
    zsum [])`` from the logits and pass 1's (m, se) and ids."""
    den = torch.clamp(se, min=1e-30)
    probs = torch.exp(logits - m[:, None]) / den[:, None]
    counts = torch.bincount(top_i.reshape(-1).long(), minlength=num_experts)
    lse = m + torch.log(den)
    return probs.sum(0), counts, torch.sum(lse * lse)


def _router_tiled(pass1, pass2, x, gate_w, cfg: MoEConfig,
                  need_stats: bool) -> RouterOutput:
    """Both passes; without ``need_stats`` the counts come from the ids,
    and the probability sums and the z-loss sum are zero, so aux_loss is
    0 (JAX's choice, gate.py:437-444)."""
    e = cfg.num_experts
    logits, m, se, top_p, top_i = pass1(x, gate_w, cfg.expert_top_k,
                                        need_stats)
    if need_stats:
        probs_sum, counts, zsum = pass2(logits, m, se, top_i, e)
    else:
        counts = torch.bincount(top_i.reshape(-1).long(), minlength=e)
        probs_sum = torch.zeros((e,), dtype=torch.float32, device=x.device)
        zsum = torch.zeros((), dtype=torch.float32, device=x.device)
    return _finish(cfg, top_p, top_i, probs_sum, counts, zsum, x.shape[0])


def router_tiled_plain(x, gate_w, cfg: MoEConfig,
                       need_stats: bool) -> RouterOutput:
    """The two-pass gate in plain torch (``router_pallas_tiled``'s
    function).  x: [S, H], gate_w: [H, E]."""
    return _router_tiled(gate_pass1_plain, gate_pass2_plain, x, gate_w, cfg,
                         need_stats)


#: bf16 pass 1 (csrc/gate_tiled.cu gate_pass1_hopper): the expert tile,
#: whose columns its consumer warpgroups split, and the warpgroups
PASS1_EXPERT_TILE = 256
PASS1_CONSUMERS = 2
#: pass 2's panels of tokens and chunks of experts (csrc/gate_tiled.cu
#: P2_ROWS, P2_COLS)
PASS2_ROWS = 64
PASS2_COLS = 128


def gate_pass1_items(s: int, e: int) -> list[tuple[int, range, list]]:
    """bf16 pass 1's work items for S tokens and E experts, in order:
    ``(token tile, its rows, expert tiles)``, the rows clipped at S, each
    expert tile ``(first expert, [columns of warpgroup 0, of 1])`` with
    the columns clipped at E (an empty range: that warpgroup skips the
    tile).  An item holds one 64-token tile against all E experts: E is
    never split across blocks, and the expert tiles and the column split
    follow E alone."""
    cols = PASS1_EXPERT_TILE // PASS1_CONSUMERS
    tiles = [(e0, [range(min(e0 + wg * cols, e), min(e0 + (wg + 1) * cols,
                                                     e))
                   for wg in range(PASS1_CONSUMERS)])
             for e0 in range(0, e, PASS1_EXPERT_TILE)]
    return [(t, range(t * GATE_TILE, min((t + 1) * GATE_TILE, s)), tiles)
            for t in range(-(-s // GATE_TILE))]


def gate_pass1_block_walk(s: int, sms: int) -> list[tuple[int, int]]:
    """``(block, token tile)`` as bf16 pass 1's persistent grid takes its
    items on a card of ``sms`` SMs: min(tiles, sms) blocks, block b the
    tiles b, b + grid, b + 2 grid, ..., in that order."""
    tiles = -(-s // GATE_TILE)
    grid = min(tiles, sms)
    return [(b, t) for b in range(grid) for t in range(b, tiles, grid)]


def _gate_rank(v, i, k: int):
    """The first k of rows of (value, id) candidates by larger value, then
    lower id (a stable sort by id, then by value)."""
    i, o = torch.sort(i, dim=-1, stable=True)
    v = v.gather(-1, o)
    v, o = torch.sort(v, dim=-1, descending=True, stable=True)
    return v[:, :k], i.gather(-1, o)[:, :k]


def _gate_select(blk, cols: range, lv, li, k: int):
    """One expert tile's selection rounds for a warpgroup's rows, as the
    kernel runs them (``g1_tile``): each round takes, per row, the largest
    logit of the tile ranked below the last one taken (larger value, then
    lower id) and above the row's K-th entry, and inserts it into the
    row's list; a round in which no row finds one ends the tile.  The
    lists [rows, k] hold -inf and a large id where not yet filled."""
    rows = blk.shape[0]
    ids = torch.arange(cols.start, cols.stop)[None, :]
    pv = torch.full((rows, 1), float("inf"))
    pi = torch.full((rows, 1), -1, dtype=torch.int64)
    big = torch.iinfo(torch.int64).max
    while True:
        thr = lv[:, k - 1:k]
        cand = (blk > thr) & ((blk < pv) | ((blk == pv) & (ids > pi)))
        if not cand.any():
            return lv, li
        bv = torch.where(cand, blk, -torch.inf).max(-1, keepdim=True).values
        bi = torch.where(cand & (blk == bv), ids, big).min(
            -1, keepdim=True).values
        found = cand.any(-1, keepdim=True)
        nv, ni = _gate_rank(torch.cat([lv, bv], -1), torch.cat([li, bi], -1),
                            k)
        lv = torch.where(found, nv, lv)
        li = torch.where(found, ni, li)
        pv = torch.where(found, bv, pv)
        pi = torch.where(found, bi, pi)


def gate_pass1_walk(x, gate_w, k: int):
    """The function of bf16 pass 1's schedule in plain torch, f32, on CPU
    tensors: ``(m, se, top_p, top_i)`` as :func:`gate_pass1_plain` gives
    them (top_i int64).  Per item (:func:`gate_pass1_items`) and consumer
    warpgroup, the expert tiles in order: the running (m, se) from -1e30
    and 0, the tile's max and sum of exp(logit - m_new), the running sum
    rescaled by exp(m - m_new) as ``_gate_pass1_kernel`` does; the
    warpgroup's top-k carried through the selection rounds
    (:func:`_gate_select`).  Then the two warpgroups merged as the kernel
    merges them: m the larger, se = se0 exp(m0 - m) + se1 exp(m1 - m),
    the lists by larger value, then lower id."""
    logits = dot_f32(x, gate_w)
    s, e = logits.shape
    big = torch.iinfo(torch.int64).max
    m, se = torch.empty(s), torch.empty(s)
    top_p = torch.empty(s, k)
    top_i = torch.empty(s, k, dtype=torch.int64)
    for _, rows, tiles in gate_pass1_items(s, e):
        lg = logits[rows.start:rows.stop]
        n = lg.shape[0]
        parts = []
        for wg in range(PASS1_CONSUMERS):
            m_run = torch.full((n,), -1e30)
            se_run = torch.zeros(n)
            lv = torch.full((n, k), -torch.inf)
            li = torch.full((n, k), big, dtype=torch.int64)
            for _, cols in tiles:
                c = cols[wg]
                if not len(c):
                    continue
                blk = lg[:, c.start:c.stop]
                m_new = torch.maximum(m_run, blk.max(-1).values)
                part = torch.exp(blk - m_new[:, None]).sum(-1)
                se_run = se_run * torch.exp(m_run - m_new) + part
                m_run = m_new
                lv, li = _gate_select(blk, c, lv, li, k)
            parts.append((m_run, se_run, lv, li))
        (m0, se0, lv0, li0), (m1, se1, lv1, li1) = parts
        mm = torch.maximum(m0, m1)
        sse = se0 * torch.exp(m0 - mm) + se1 * torch.exp(m1 - mm)
        v, i = _gate_rank(torch.cat([lv0, lv1], -1),
                          torch.cat([li0, li1], -1), k)
        sl = slice(rows.start, rows.stop)
        m[sl], se[sl], top_i[sl] = mm, sse, i
        top_p[sl] = torch.exp(v - mm[:, None]) \
            / torch.clamp(sse, min=1e-30)[:, None]
    return m, se, top_p, top_i


def gate_pass2_plan(s: int, e: int) -> list[tuple[range, range]]:
    """Pass 2's blocks for S tokens and E experts, in launch order (the
    expert chunk fastest): ``(panel rows, chunk columns)``, 64 tokens by
    128 experts, clipped at S and E.  The last block of a chunk to finish
    adds the chunk's partials in panel order."""
    return [(range(p, min(p + PASS2_ROWS, s)), range(c, min(c + PASS2_COLS,
                                                            e)))
            for p in range(0, s, PASS2_ROWS) for c in range(0, e, PASS2_COLS)]


#: pass 2's warps: warp w of a block adds its panel's rows w, w + 8, ...
_PASS2_WARPS = 8


def gate_pass2_walk(logits, m, se, top_i, num_experts: int):
    """The function of pass 2's plan in plain torch, on CPU tensors:
    :func:`gate_pass2_plain`'s outputs (counts int64).  Per block of
    :func:`gate_pass2_plan`, exp(l - m) / max(se, 1e-30) of its panel and
    chunk, each warp's rows added in order, then the warps in order; the
    counts of the ids in the chunk; the panel's sum of lse^2.  Each
    chunk's partials then added in panel order, the first half and the
    second half apart, then the two; the z terms in panel order."""
    s, e = logits.shape
    plan = gate_pass2_plan(s, e)
    panels = -(-s // PASS2_ROWS)
    den = torch.clamp(se, min=1e-30)
    part_p = torch.zeros(panels, e)
    part_c = torch.zeros(panels, e, dtype=torch.int64)
    part_z = torch.zeros(panels)
    for rows, cols in plan:
        b = rows.start // PASS2_ROWS
        p = torch.exp(logits[rows.start:rows.stop, cols.start:cols.stop]
                      - m[rows.start:rows.stop, None]) \
            / den[rows.start:rows.stop, None]
        acc = torch.zeros(cols.stop - cols.start)
        for w in range(_PASS2_WARPS):
            wsum = torch.zeros_like(acc)
            for r in range(w, p.shape[0], _PASS2_WARPS):
                wsum = wsum + p[r]
            acc = acc + wsum
        part_p[b, cols.start:cols.stop] = acc
        ids = top_i[rows.start:rows.stop].reshape(-1).long()
        ids = ids[(ids >= cols.start) & (ids < cols.stop)]
        part_c[b] += torch.bincount(ids, minlength=e)
        if cols.start == 0:
            lse = m[rows.start:rows.stop] \
                + torch.log(den[rows.start:rows.stop])
            part_z[b] = torch.sum(lse * lse)
    half = panels // 2
    probs_sum = part_p[:half].sum(0) + part_p[half:].sum(0)
    return probs_sum, part_c.sum(0), part_z.sum()


def gate_pass1_args(x, gate_w, k: int, need_logits: bool):
    """The arguments of one launch of pass 1 (``fm_gate_pass1``) on checked
    CUDA tensors of one dtype, with its outputs made here: ``(args,
    (logits, m, se, top_p, top_i))``.  bf16 reads x in place (TMA fills
    rows past S with zeros) and gate_w too unless E % 8 != 0, which pads
    gate_w's columns to a multiple of 8 (the map's 16-byte row stride);
    f32 pads x's rows to the 64-token tile and gate_w's columns to the
    64-expert tile."""
    s, h = x.shape
    e = gate_w.shape[1]
    if x.dtype == torch.bfloat16:
        px = -(-e // 8) * 8
    else:
        px = -(-e // GATE_TILE) * GATE_TILE
        sp = -(-s // GATE_TILE) * GATE_TILE
        if sp != s:
            x = F.pad(x, (0, 0, 0, sp - s))
    if px != e:
        gate_w = F.pad(gate_w, (0, px - e))
    f32 = dict(dtype=torch.float32, device=x.device)
    out = (torch.empty((s, e), **f32) if need_logits else None,
           torch.empty((s,), **f32), torch.empty((s,), **f32),
           torch.empty((s, k), **f32),
           torch.empty((s, k), dtype=torch.int32, device=x.device))
    args = (int(x.dtype == torch.bfloat16), x.data_ptr(), gate_w.data_ptr(),
            s, h, e, px, k, None if out[0] is None else out[0].data_ptr(),
            *(t.data_ptr() for t in out[1:]), _build.stream_of(x))
    return args, out, (x, gate_w)


def gate_pass1_cuda(x, gate_w, k: int, need_logits: bool):
    """Pass 1 of the two-pass gate (``fm_gate_pass1``) on CUDA tensors:
    :func:`gate_pass1_plain`'s outputs, top_i int32.  x: [S, H] and
    gate_w: [H, E], bf16 or f32 (mixed dtypes are upcast to f32, which is
    exact); H % 64 == 0 and 1 <= K <= min(E, 64).  bf16 x is read in
    place; see :func:`gate_pass1_args` for the padding f32 takes."""
    s, h = x.shape
    e = gate_w.shape[1]
    if gate_w.shape[0] != h:
        raise ValueError(f"gate_w {tuple(gate_w.shape)} does not match x "
                         f"{tuple(x.shape)}")
    for t in (x, gate_w):
        if t.dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"gate_pass1_cuda takes bf16 or f32, got "
                             f"{t.dtype}")
    if s < 1 or h % GATE_TILE or not 1 <= k <= min(e, TILED_MAX_MERGE // 2):
        raise ValueError(f"gate_pass1_cuda needs S >= 1, H % {GATE_TILE} "
                         f"== 0 and 1 <= K <= min(E, "
                         f"{TILED_MAX_MERGE // 2}), got S={s}, H={h}, E={e}, "
                         f"K={k}")
    _build.refuse_autograd("gate_pass1_cuda", x, gate_w)
    dt = x.dtype if x.dtype == gate_w.dtype else torch.float32
    x, gate_w = x.to(dt).contiguous(), gate_w.to(dt).contiguous()
    _build.require_cuda("gate_pass1_cuda", x, gate_w)
    args, out, _keep = gate_pass1_args(x, gate_w, k, need_logits)
    with torch.cuda.device(x.device):
        err = _build.library().fm_gate_pass1(*args)
    _build.check(err, "fm_gate_pass1")
    gate_pass1_cuda.launches += 1
    return out


gate_pass1_cuda.launches = 0

def gate_pass2_args(logits, m, se, top_i):
    """The arguments of one launch of pass 2 (``fm_gate_pass2``) on checked
    CUDA tensors (top_i int32), with its outputs and scratch made here:
    ``(args, (probs_sum, counts, zsum), scratch)``.  The launch takes the
    gate kernels' ticket counters, so launches on one device run in one
    stream's order."""
    s, e = logits.shape
    nb = -(-s // PASS2_ROWS)
    dev = logits.device
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    scratch = (torch.empty((nb, e), **f32), torch.empty((nb, e), **i32),
               torch.empty((nb,), **f32))
    out = (torch.empty((e,), **f32), torch.empty((e,), **i32),
           torch.empty((), **f32))
    args = (logits.data_ptr(), m.data_ptr(), se.data_ptr(), top_i.data_ptr(),
            s, e, top_i.shape[1], *(t.data_ptr() for t in scratch),
            _tickets(dev, -(-e // PASS2_COLS)).data_ptr(),
            *(t.data_ptr() for t in out), _build.stream_of(logits))
    return args, out, scratch


def gate_pass2_cuda(logits, m, se, top_i, num_experts: int):
    """Pass 2 of the two-pass gate (``fm_gate_pass2``) on CUDA tensors:
    :func:`gate_pass2_plain`'s outputs, counts int32.  logits f32 [S, E],
    m and se f32 [S], top_i [S, K] with K <= 64.  One launch
    (:func:`gate_pass2_args`)."""
    s, e = logits.shape
    k = top_i.shape[1]
    if e != num_experts or m.shape != (s,) or se.shape != (s,) \
            or top_i.shape[0] != s or not 1 <= k <= TILED_MAX_MERGE // 2:
        raise ValueError(
            f"gate_pass2_cuda shapes: logits {tuple(logits.shape)}, m "
            f"{tuple(m.shape)}, se {tuple(se.shape)}, top_i "
            f"{tuple(top_i.shape)}, E={num_experts}")
    if any(t.dtype != torch.float32 for t in (logits, m, se)):
        raise ValueError("gate_pass2_cuda takes f32 logits, m and se")
    _build.refuse_autograd("gate_pass2_cuda", logits, m, se)
    top_i = top_i.to(torch.int32).contiguous()
    _build.require_cuda("gate_pass2_cuda", logits, m, se, top_i)
    args, out, _scratch = gate_pass2_args(logits, m, se, top_i)
    with torch.cuda.device(logits.device):
        err = _build.library().fm_gate_pass2(*args)
    _build.check(err, "fm_gate_pass2")
    gate_pass2_cuda.launches += 1
    return out


gate_pass2_cuda.launches = 0


def router_tiled_cuda(x, gate_w, cfg: MoEConfig,
                      need_stats: bool) -> RouterOutput:
    """The two-pass gate's kernels on CUDA tensors: pass 1, then pass 2
    when ``need_stats``."""
    return _router_tiled(gate_pass1_cuda, gate_pass2_cuda, x, gate_w, cfg,
                         need_stats)


def gate_vmem_bytes(s: int, h: int, e: int, dtype: torch.dtype) -> int:
    """The JAX package's static VMEM estimate of its single-tile gate
    (gate.py:484-495), the arithmetic copied: :func:`tiled_need_stats`
    needs to know where JAX router takes that gate."""
    px = max(_LANE, ((e + _LANE - 1) // _LANE) * _LANE)
    bm = next(b for b in (128, 64, 32, 16, 8) if s % b == 0) if s % 8 == 0 \
        else 128
    item = dtype.itemsize
    return h * px * item + bm * h * item + 4 * bm * px * 4 + 8 * px * 4


def tiled_need_stats(cfg: MoEConfig, s: int, h: int,
                     dtype: torch.dtype) -> bool:
    """Whether the two-pass gate runs pass 2 for S tokens of width H.

    Wherever JAX router would compute the statistics itself, the port
    does too, since its cut-over (E > 256) is not JAX's (a VMEM budget):
    JAX takes ``router_xla`` when S % 8 != 0, and its single-tile gate
    while :func:`gate_vmem_bytes` stays within the budget, and both always
    compute them.  Elsewhere, as ``router_pallas_tiled`` (gate.py:351-356):
    training, a z-loss, ``collect_stats`` or ``FLASHMOE_GATE_STATS=1``."""
    if s % 8 or gate_vmem_bytes(s, h, cfg.num_experts, dtype) \
            <= _GATE_VMEM_BUDGET:
        return True
    return bool(cfg.is_training or cfg.router_z_loss_coef > 0
                or cfg.collect_stats
                or os.environ.get("FLASHMOE_GATE_STATS") == "1")


def apply_replicas(out: RouterOutput, cfg: MoEConfig) -> RouterOutput:
    """Hot-expert replica routing (``cfg.expert_replicas``): for each
    (hot, slot) pair, the odd-numbered tokens that selected ``hot`` go to
    its value-identical replica ``slot`` instead, and ``expert_counts`` is
    recounted over the remapped ids; ``aux_loss`` and ``probs_mean`` keep
    the router's view.  An empty map is the identity."""
    if not cfg.expert_replicas:
        return out
    idx = out.expert_idx
    odd = (torch.arange(idx.shape[0], device=idx.device) % 2 == 1)[:, None]
    for hot, slot in cfg.expert_replicas:
        idx = torch.where((idx == hot) & odd,
                          torch.full_like(idx, slot), idx)
    counts = torch.bincount(idx.reshape(-1), minlength=cfg.num_experts)
    return out._replace(expert_idx=idx, expert_counts=counts)


class _RouterAD(torch.autograd.Function):
    """Forward: ``fn`` (a gate kernel, or the two-pass gate's plain
    version).  Backward: :func:`router_plain` recomputed under autograd on
    the saved inputs, the cotangents pulled back through it.  The ids and
    counts are integers and carry no gradient."""

    @staticmethod
    def forward(ctx, x, gate_w, cfg, fn):
        out = fn(x, gate_w, cfg)
        ctx.save_for_backward(x, gate_w)
        ctx.cfg = cfg
        ctx.set_materialize_grads(False)
        ctx.mark_non_differentiable(out.expert_idx, out.expert_counts)
        return tuple(out)

    @staticmethod
    def backward(ctx, *cts):
        x, gate_w = ctx.saved_tensors
        with torch.enable_grad():
            xs = x.detach().requires_grad_(True)
            ws = gate_w.detach().requires_grad_(True)
            outs, grads = [], []
            for o, ct in zip(router_plain(xs, ws, ctx.cfg), cts):
                if ct is not None and o.requires_grad:
                    outs.append(o)
                    grads.append(ct)
            dx, dw = torch.autograd.grad(outs, (xs, ws), grads,
                                         allow_unused=True)
        return dx, dw, None, None


def router(x, gate_w, cfg: MoEConfig, use_kernels: bool | None = None
           ) -> RouterOutput:
    """Route x: [S, H] through gate_w: [H, E], differentiably.

    E <= 256 and K <= 32: the single-tile gate kernel (through
    ``_RouterAD``) on CUDA tensors, :func:`router_plain` on CPU ones (or
    with ``use_kernels=False``).  Otherwise, while 2K <= 128: the two-pass
    gate, kernels on CUDA tensors and their plain version on CPU ones, with
    pass 2 as :func:`tiled_need_stats` decides.  Beyond that,
    :func:`router_plain`, as JAX takes ``router_xla`` (gate.py:554-557): a
    choice made from the configuration alone.

    An armed ``skewed_routing`` chaos point biases the single-tile gate's
    logits, in the kernel and in :func:`router_plain` alike.  The two-pass
    gate takes no bias: while the point is armed, its configurations
    route through :func:`router_plain` on CPU tensors, as JAX routes
    through ``router_xla`` then (gate.py:538-545), and raise on CUDA
    tensors."""
    uk = _build.use_kernels_for(x, use_kernels)
    e, k = cfg.num_experts, cfg.expert_top_k
    if e <= GATE_MAX_EXPERTS and k <= GATE_MAX_TOP_K:
        out = RouterOutput(*_RouterAD.apply(x, gate_w, cfg, router_cuda)) \
            if uk else router_plain(x, gate_w, cfg)
    elif 2 * k <= TILED_MAX_MERGE and chaos_inject.is_armed(
            "skewed_routing"):
        if uk:
            raise NotImplementedError(
                f"skewed_routing at E={e}: the two-pass gate kernels take "
                f"no logit bias (the single-tile gate takes E <= "
                f"{GATE_MAX_EXPERTS})")
        out = router_plain(x, gate_w, cfg)
    elif 2 * k <= TILED_MAX_MERGE:
        fn = functools.partial(
            router_tiled_cuda if uk else router_tiled_plain,
            need_stats=tiled_need_stats(cfg, *x.shape, x.dtype))
        out = RouterOutput(*_RouterAD.apply(x, gate_w, cfg, fn))
    else:
        out = router_plain(x, gate_w, cfg)
    return apply_replicas(out, cfg)
