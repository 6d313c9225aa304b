"""Fused expert-parallel MoE layer: dispatch, expert FFN and return in one
kernel, FlashDMoE's headline object.

Counterpart of ``flashmoe_tpu/parallel/fused.py:933-2244``.  Gate, plan
and the capacity-format send slabs stay plain torch on every rank, as
they stay XLA in the JAX package; the kernel (``csrc/fused_ep.cu``, the
port of ``_fused_kernel``) owns the exchange, the FFN and the return for
all ranks of the ep world at once: every rank pushes its occupied row
tiles into its peers' receive buffers with flag signals, runs its local
experts' FFN on each tile as it lands, and stores the results back into
the source's return buffer, optionally at token-sorted rows that the
kernel then combines (``FLASHMOE_FUSED_COMBINE=1``, ep > 1).

The ranks are the virtual ranks of a local mesh
(:func:`flashmoe_tpu_torch.parallel.mesh.local_mesh`): every rank's
regions of the kernel's symmetric heap are slices of allocations on one
card, the data regions made for each call, the flag words kept per
device.  A process mesh, with peer heaps mapped from other GPUs, waits for
the multi-GPU transport (ROADMAP A.5).  This is the inference path: under
autograd the kernel's wrapper refuses, and the fused layer's backward
(``fused.py:1696-1897``) waits for ROADMAP A.6.

The four schedule names of the JAX kernel stay, and map to two
processing orders of the one kernel: ``stream`` and ``resident`` take the
tasks (source, local expert, row tile) source-major in ``src_order``;
``batched`` and ``rowwin`` take the own slab first, then the remote slabs
expert-major.  The TPU schedules' VMEM budgets have no counterpart: every
order holds one 64-row tile's operands in a block's static shared memory
(about 34 KB of the 227 KB an H100 block may use, a static assert in the
kernel), whatever the capacity, source count or expert width.
"""

from __future__ import annotations

import ctypes
import os
from typing import NamedTuple

import numpy as np
import torch

from flashmoe_tpu_torch.config import MoEConfig
from flashmoe_tpu_torch.kernels import _build
from flashmoe_tpu_torch.models.reference import shared_expert_ffn
from flashmoe_tpu_torch.ops import dispatch as dsp
from flashmoe_tpu_torch.ops import expert as exp
from flashmoe_tpu_torch.ops import health as hlt
from flashmoe_tpu_torch.ops.gate import router
from flashmoe_tpu_torch.parallel.ep import (layer_output, local_capacity,
                                            refuse_quantized)

#: the kernel's row tile and output-column chunk (csrc/gemm_tile.cuh)
ROW_TILE = 64
COL_TILE = 64
#: column chunks in one task of the kernel (a 64 x 256 strip)
COL_GROUP = 4
SCHEDULES = ("batched", "resident", "stream", "rowwin")
#: how long a wait inside the kernel may spin before it traps
TIMEOUT_S = 5.0


def default_ring(n: int) -> np.ndarray:
    """The default source order: row r is (r, r+1, ..., r-1), as
    ``flashmoe_tpu/parallel/topology.py:125``."""
    r = np.arange(n, dtype=np.int32)
    return (r[:, None] + r[None, :]) % n


def _fused_schedule(d_world: int, forced: str | None = None) -> str:
    """The schedule the kernel runs: ``forced`` (``cfg.fused_schedule``)
    when given, with JAX's semantic error; else ``batched`` at d >= 3 (a
    rank's blocks then take one expert across every remote slab together,
    sharing its weight columns in L2), and ``stream`` otherwise."""
    if forced is not None:
        if forced not in SCHEDULES:
            raise ValueError(f"unknown fused schedule {forced!r}")
        if forced == "batched" and d_world < 2:
            raise ValueError(
                "fused_schedule='batched' needs an ep world of >= 2 ranks "
                "(there is no remote batch at d_world=1)")
        return forced
    return "batched" if d_world >= 3 else "stream"


def _padded_capacity(cap: int) -> int:
    """The send slabs' capacity: a multiple of 32 rows, as JAX pads."""
    return -(-cap // 32) * 32


def schedule_table(cfg: MoEConfig, d_world: int) -> dict:
    """The kernel's execution geometry at ``(cfg, d_world)``: the
    schedule it runs (``cfg.fused_schedule`` honoured; a forced schedule
    that cannot run falls back to the automatic one with the reason in
    ``forced_infeasible``), per-schedule feasibility, the 32-padded and
    raw capacities, and the row tile ``cm`` and column chunk ``bi`` with
    their loop extents."""
    cap_raw = local_capacity(cfg, cfg.tokens // d_world)
    cap = _padded_capacity(cap_raw)
    forced_infeasible = None
    try:
        resolved = _fused_schedule(d_world, cfg.fused_schedule)
    except ValueError as e:
        forced_infeasible = str(e)
        resolved = _fused_schedule(d_world)
    return {
        "schedule": resolved,
        "feasible": {s: s != "batched" or d_world >= 2 for s in SCHEDULES},
        "cap": cap, "cap_raw": cap_raw, "cm": ROW_TILE, "bi": COL_TILE,
        "n_row_tiles": -(-cap // ROW_TILE),
        "n_i_chunks": cfg.intermediate_size // COL_TILE,
        "forced_infeasible": forced_infeasible,
    }


def schedule_metadata(cfg: MoEConfig, d_world: int) -> dict:
    """JAX's short view of :func:`schedule_table`."""
    t = schedule_table(cfg, d_world)
    return {k: t[k] for k in ("schedule", "feasible", "cap", "cm", "bi",
                              "n_row_tiles", "n_i_chunks")}


def _combine_chunk_rows(k: int) -> int:
    """Output rows per combine chunk: the token-sorted return buffer is
    padded to a multiple of this many tokens' k rows."""
    return 128 if k <= 3 else 64


def _fuse_combine_enabled(cfg: MoEConfig, d_world: int) -> bool:
    """Whether the weighted combine runs in the kernel: only with
    ``FLASHMOE_FUSED_COMBINE=1`` and an ep world of more than one rank
    (at one rank there is no return to overlap).  The Hopper kernel's
    combine reads the sorted rows from device memory, so no shared-memory
    budget limits it."""
    return (os.environ.get("FLASHMOE_FUSED_COMBINE") == "1"
            and d_world > 1)


def _groups(dim: int) -> int:
    """Tasks across a dimension: 256-column groups of 64-column chunks."""
    return -(-(dim // COL_TILE) // COL_GROUP)


def task_order(src_order: np.ndarray, nlx: int, n_tiles: int, n_up: int,
               n_down: int, schedule: str) -> np.ndarray:
    """[D, D * nlx * n_tiles * (n_up + n_down), 2] int32: each rank's
    tasks, as the kernel reads them: ``(src * nlx + e) * n_tiles + t``
    and ``kind << 16 | group`` (kind 0 up, 1 down), in the schedule's
    order.  A unit is one source's slab of one expert (``stream``,
    ``resident``), or the own slab first and then all remote slabs of one
    expert together (``batched``, ``rowwin``); each unit lists its up
    tasks group by group across its tiles, then its down tasks, so that
    every down task comes after the up tasks it waits for."""
    d = src_order.shape[0]
    tiles = np.arange(n_tiles)
    out = []
    for r in range(d):
        srcs = [int(s) for s in src_order[r]]
        if schedule in ("batched", "rowwin"):
            units = [([srcs[0]], e) for e in range(nlx)]
            units += [(srcs[1:], e) for e in range(nlx)] if d > 1 else []
        else:
            units = [([s], e) for s in srcs for e in range(nlx)]
        rows = []
        for ss, e in units:
            codes = ((np.asarray(ss)[:, None] * nlx + e) * n_tiles
                     + tiles[None, :]).reshape(-1)
            for kind, n in ((0, n_up), (1, n_down)):
                for j in range(n):
                    rows.append(np.stack([codes, np.full_like(
                        codes, kind << 16 | j)], -1))
        out.append(np.concatenate(rows))
    return np.stack(out).astype(np.int32)


def check_src_order(src_order, d_world: int) -> np.ndarray:
    """``src_order`` as a [D, D] int32 array (the ring when None), each
    row an own-first permutation, with JAX's errors."""
    if src_order is None:
        return default_ring(d_world)
    so = np.asarray(src_order.cpu() if torch.is_tensor(src_order)
                    else src_order)
    if so.shape != (d_world, d_world):
        raise ValueError(
            f"src_order must be [{d_world}, {d_world}] (one processing "
            f"order per ep rank), got {so.shape}")
    for r in range(d_world):
        if so[r, 0] != r or sorted(so[r]) != list(range(d_world)):
            raise ValueError(
                f"src_order row {r} must be a permutation of "
                f"0..{d_world - 1} starting with {r}, got {so[r].tolist()}")
    return so.astype(np.int32)


def _check_shard_args(name, send_cnt, x_send, w_up, b_up, w_down, b_down,
                      w_gate, gated, recv_pos, w_sorted, k):
    """(D, nLx, C, H, I) of the shard arguments; ValueError unless every
    tensor has the shape the kernel reads."""
    if x_send.dim() != 5 or x_send.shape[0] != x_send.shape[1]:
        raise ValueError(f"{name}: x_send must be [D, D, nLx, C, H], got "
                         f"{tuple(x_send.shape)}")
    d, _, nlx, c, h = x_send.shape
    i_dim = w_up.shape[-1]
    want = {"send_cnt": (send_cnt, (d, d, nlx)),
            "w_up": (w_up, (d * nlx, h, i_dim)),
            "b_up": (b_up, (d * nlx, i_dim)),
            "w_down": (w_down, (d * nlx, i_dim, h)),
            "b_down": (b_down, (d * nlx, h))}
    if gated:
        if w_gate is None:
            raise ValueError(f"{name}: gated=True needs w_gate")
        want["w_gate"] = (w_gate, (d * nlx, h, i_dim))
    if recv_pos is not None:
        want["recv_pos"] = (recv_pos, (d, d, nlx, c))
        if (w_sorted is None or w_sorted.dim() != 2
                or w_sorted.shape[0] != d or w_sorted.shape[1] % k):
            raise ValueError(
                f"{name}: w_sorted must be [{d}, rows_pad] with rows_pad a "
                f"multiple of k={k}, got "
                f"{None if w_sorted is None else tuple(w_sorted.shape)}")
    for key, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(
                f"{name}: {key} is {tuple(t.shape)}, want {shape} (D={d}, "
                f"nLx={nlx}, C={c}, H={h}, I={i_dim})")
    return d, nlx, c, h, i_dim


def fused_shard_plain(send_cnt, src_order, x_send, w_up, b_up, w_down,
                      b_down, w_gate=None, *, act_name: str,
                      gated: bool = False, schedule: str = "stream",
                      recv_pos=None, w_sorted=None, k: int = 1):
    """Plain torch version of the fused kernel over the stacked ranks.

    x_send [D, D, nLx, C, H] (rank, destination, local expert, slot);
    send_cnt [D, D, nLx] (rows each rank sends each destination's
    experts; the rows rank r receives from source s are send_cnt[s, r]);
    weights [D * nLx, ...] in x_send's dtype, rank r owning experts
    r*nLx .. r*nLx + nLx - 1.  The exchange is a transpose of the rank
    axes, then B2's plain FFN runs per (owner, source, expert) slab, rows
    past a count zero, and the return is the transpose back: y_back
    [D, D, nLx, C, H] (rank, owner, ...).  With ``recv_pos``
    ([D, D, nLx, C], owner-major) and ``w_sorted`` [D, rows_pad] the
    returned rows land at their token-sorted rows and the result is the
    k-row weighted combine, [D, rows_pad / k, H] f32.  ``src_order``
    (checked as the kernel checks it) and ``schedule`` order the kernel's
    work and do not change the values."""
    d, nlx, c, h, _ = _check_shard_args(
        "fused_shard_plain", send_cnt, x_send, w_up, b_up, w_down, b_down,
        w_gate, gated, recv_pos, w_sorted, k)
    check_src_order(src_order, d)
    x_recv = x_send.transpose(0, 1)  # [owner, source, e, C, H]
    y_stage = []
    for r in range(d):
        buf = x_recv[r].permute(1, 0, 2, 3).reshape(nlx * d * c, h)
        gid = torch.arange(nlx * d, device=buf.device) // d
        own = slice(r * nlx, (r + 1) * nlx)
        y = exp.grouped_ffn_plain(
            buf, gid, w_up[own], b_up[own], w_down[own], b_down[own],
            None if w_gate is None else w_gate[own], act_name=act_name,
            gated=gated, block_m=c)
        y_stage.append(y.reshape(nlx, d, c, h).permute(1, 0, 2, 3))
    slot = torch.arange(c, device=x_send.device)
    live = slot < send_cnt.transpose(0, 1)[..., None]  # [owner, source, ..]
    y_stage = torch.where(live[..., None], torch.stack(y_stage),
                          torch.zeros((), dtype=x_send.dtype,
                                      device=x_send.device))
    y_back = y_stage.transpose(0, 1)  # [source, owner, e, C, H]
    if recv_pos is None:
        return y_back
    rows_pad = w_sorted.shape[1]
    sent = slot < send_cnt[..., None]  # [source, dst, e, C]
    ret_pos = recv_pos.transpose(0, 1).long()
    y_sorted = torch.zeros((d, rows_pad, h), dtype=x_send.dtype,
                           device=x_send.device)
    for s in range(d):
        y_sorted[s, ret_pos[s][sent[s]]] = y_back[s][sent[s]]
    w = w_sorted.float()[..., None]
    yw = torch.where(w != 0, y_sorted.float(), torch.zeros(
        (), device=w.device)) * w
    return yw.reshape(d, rows_pad // k, k, h).sum(2)


class _Flags:
    """The kernel's flag words on one device, kept across calls: each
    rank's barrier counter, work counter and dispatch, up and return
    flags (a few KB).  The flags carry each call's sequence number and
    are never reset, the work counter a running base, so no call resets
    them; the data regions are allocated for each call."""

    def __init__(self, key, d, n_flags, device):
        stride = -(-(16 + 4 * n_flags) // 256) * 256
        self.key = key
        self.mem = torch.zeros(d * stride, dtype=torch.uint8, device=device)
        self.peers = self.mem.data_ptr() + stride * torch.arange(
            d, dtype=torch.int64, device=device)
        self.seq = 0
        self.work_base = 0
        self.orders = {}


# the flag words of the layout last used on each device
_FLAGS: dict = {}
_MAX_BLOCKS: dict = {}


def max_blocks(x, gated: bool) -> int:
    """The most kernel blocks that can be resident at once on x's device
    (occupancy times the SM count)."""
    key = (x.device, x.dtype, gated)
    if key not in _MAX_BLOCKS:
        n = ctypes.c_int(0)
        with torch.cuda.device(x.device):
            err = _build.library().fm_fused_ep_max_blocks(
                int(x.dtype == torch.bfloat16), int(gated), ctypes.byref(n))
        _build.check(err, "fm_fused_ep_max_blocks")
        _MAX_BLOCKS[key] = n.value
    return _MAX_BLOCKS[key]


def _flags_for(device, d, nlx, n_tiles, n_up, n_down) -> _Flags:
    key = (d, nlx, n_tiles, n_up, n_down)
    flags = _FLAGS.get(device)
    if flags is None or flags.key != key:
        flags = _Flags(key, d, d * nlx * n_tiles * (1 + n_up + n_down),
                       device)
        _FLAGS[device] = flags
    return flags


def _rank_table(t) -> torch.Tensor:
    """[D] int64 on t's device: the address of each rank's region t[r]."""
    step = t.stride(0) * t.element_size()
    return t.data_ptr() + step * torch.arange(t.shape[0], dtype=torch.int64,
                                              device=t.device)


def fused_shard_cuda(send_cnt, src_order, x_send, w_up, b_up, w_down,
                     b_down, w_gate=None, *, act_name: str,
                     gated: bool = False, schedule: str = "stream",
                     recv_pos=None, w_sorted=None, k: int = 1,
                     blocks_per_rank: int | None = None,
                     timeout_s: float = TIMEOUT_S):
    """The fused kernel (``csrc/fused_ep.cu``) on CUDA tensors, with
    :func:`fused_shard_plain`'s arguments and results; rows past a count
    are unspecified here.  ``src_order`` is a [D, D] array (None: the
    ring).  ``blocks_per_rank`` defaults to the most the card keeps
    resident; a grid larger than that raises ValueError, never launches.
    Bad shapes or source orders raise ValueError; autograd and weights
    not in x_send's dtype (quantized stores) are refused.  Launches on
    the current stream without synchronising."""
    name = "fused_shard_cuda"
    combine = recv_pos is not None
    _build.refuse_autograd(name, x_send, w_up, b_up, w_down, b_down, w_gate)
    if x_send.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name} takes bf16 or f32, got {x_send.dtype}")
    d, nlx, c, h, i_dim = _check_shard_args(
        name, send_cnt, x_send, w_up, b_up, w_down, b_down, w_gate, gated,
        recv_pos, w_sorted, k)
    weights = [w_up, w_down] + ([w_gate] if gated else [])
    if any(w.dtype != x_send.dtype for w in weights):
        raise ValueError(f"{name}: weights must have x_send's dtype "
                         f"(quantized expert stores are not ported)")
    if h % 64 or i_dim % 64 or d > 128:
        raise ValueError(f"{name} needs H, I % 64 == 0 and D <= 128, got "
                         f"H={h}, I={i_dim}, D={d}")
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown fused schedule {schedule!r}")
    so = check_src_order(src_order, d)
    cnt32 = send_cnt.to(torch.int32).contiguous()
    b_up32, b_down32 = b_up.float().contiguous(), b_down.float().contiguous()
    tensors = [x_send, cnt32, b_up32, b_down32, *weights]
    rows_pad = 0
    if combine:
        recv_pos = recv_pos.to(torch.int32).contiguous()
        w_sorted = w_sorted.float().contiguous()
        rows_pad = w_sorted.shape[1]
        tensors += [recv_pos, w_sorted]
    _build.require_cuda(name, *tensors)
    ch = -(-c // ROW_TILE) * ROW_TILE
    n_tiles = ch // ROW_TILE
    most = max_blocks(x_send, gated)
    g = blocks_per_rank if blocks_per_rank is not None else most // d
    if g < 1 or d * g > most:
        raise ValueError(
            f"{name}: {d} ranks x {g} blocks exceed the {most} blocks this "
            f"card keeps resident at once; every block may wait on "
            f"another, so such a grid could deadlock")
    n_up, n_down = _groups(i_dim), _groups(h)
    dev, dt = x_send.device, x_send.dtype
    flags = _flags_for(dev, d, nlx, n_tiles, n_up, n_down)
    okey = (so.tobytes(), schedule)
    if okey not in flags.orders:
        flags.orders[okey] = torch.from_numpy(task_order(
            so, nlx, n_tiles, n_up, n_down, schedule)).to(dev)
    order = flags.orders[okey]
    x_recv = torch.empty((d, d, nlx, ch, h), dtype=dt, device=dev)
    ret = torch.empty((d, rows_pad if combine else d * nlx * ch, h),
                      dtype=dt, device=dev)
    hidden = torch.empty((d, d, nlx, ch, i_dim), dtype=dt, device=dev)
    peers = torch.stack([_rank_table(x_recv), _rank_table(ret),
                         _rank_table(hidden), flags.peers])
    out = (torch.empty((d, rows_pad // k, h), dtype=torch.float32,
                       device=dev) if combine else None)
    # the flags keep this call's sequence number only if it launched
    seq = flags.seq + 1
    with torch.cuda.device(dev):
        err = _build.library().fm_fused_ep(
            int(dt == torch.bfloat16), int(gated), exp._ACT_CODE[act_name],
            d, nlx, c, ch, h, i_dim, k, int(combine), rows_pad, g,
            COL_GROUP, seq, flags.work_base, int(timeout_s * 1e9),
            x_send.data_ptr(), cnt32.data_ptr(), order.data_ptr(),
            recv_pos.data_ptr() if combine else None,
            w_sorted.data_ptr() if combine else None, w_up.data_ptr(),
            w_gate.data_ptr() if gated else None, b_up32.data_ptr(),
            w_down.data_ptr(), b_down32.data_ptr(), peers.data_ptr(),
            out.data_ptr() if combine else None, _build.stream_of(x_send))
    _build.check(err, "fm_fused_ep")
    flags.seq = seq
    flags.work_base += order.shape[1] + g
    fused_shard_cuda.launches += 1
    if combine:
        return out
    return ret.view(d, d, nlx, ch, h)[:, :, :, :c].contiguous()


fused_shard_cuda.launches = 0


def fused_shard(send_cnt, src_order, x_send, w_up, b_up, w_down, b_down,
                w_gate=None, *, use_kernels: bool | None = None, **kw):
    """The fused kernel on CUDA tensors, its plain version on CPU ones
    (or with ``use_kernels=False``)."""
    fn = fused_shard_cuda if _build.use_kernels_for(x_send, use_kernels) \
        else fused_shard_plain
    return fn(send_cnt, src_order, x_send, w_up, b_up, w_down, b_down,
              w_gate, **kw)


class FusedInputs(NamedTuple):
    """What the layer hands the fused kernel, and what it keeps for the
    combine: per held rank the router outputs and plans; the stacked
    shard arguments of :func:`fused_shard` (``args``, ``kw``); the real
    and padded capacities and the local token count."""

    rs: list
    plans: list
    args: tuple
    kw: dict
    cap: int
    cap_pad: int
    s_loc: int


def fused_inputs(params, x, cfg: MoEConfig, mesh, *, src_order=None,
                 use_kernels: bool | None = None) -> FusedInputs:
    """Route, plan and dispatch every rank's tokens into its send slabs
    (capacity padded to 32 rows), exchange the sorted return rows (with
    the in-kernel combine), and cast the weights: everything of
    :func:`fused_ep_moe_layer` before the kernel.  The counts' exchange is
    the shard's own transpose of the stacked send counts."""
    if cfg.wire_dtype or cfg.wire_dtype_combine:
        raise ValueError(
            "fused_ep_moe_layer moves raw slabs in-kernel and cannot "
            "honor wire_dtype compression; use ep_moe_layer")
    if not mesh.is_local:
        raise NotImplementedError(
            "fused_ep_moe_layer runs the ranks of a local mesh; one rank "
            "per process waits for the multi-GPU transport (ROADMAP A.5)")
    refuse_quantized(params)
    d = mesh.size
    so = check_src_order(src_order, d)
    uk = _build.use_kernels_for(x, use_kernels)
    xs, ps = mesh.split(x), mesh.shard_params(params)
    s_loc, h = xs[0].shape
    nlx = cfg.num_experts // d
    cap = local_capacity(cfg, s_loc)
    cap_pad = _padded_capacity(cap)

    rs, plans, sends, counts = [], [], [], []
    for xr, p in zip(xs, ps):
        r = router(xr, p["gate_w"], cfg, use_kernels=uk)
        plan = dsp.make_plan(r.expert_idx, cfg, cap)
        xbuf = dsp.dispatch(xr.to(cfg.dtype), plan, cfg, cap)
        xbuf = torch.nn.functional.pad(xbuf, (0, 0, 0, cap_pad - cap))
        rs.append(r)
        plans.append(plan)
        sends.append(xbuf.reshape(d, nlx, cap_pad, h))
        # counts clamp to the real capacity: padded rows are never sent
        counts.append(torch.clamp(plan.counts, max=cap).reshape(d, nlx))
    dt = cfg.dtype
    args = (torch.stack(counts), so, torch.stack(sends), params["w_up"].to(dt), params["b_up"],
            params["w_down"].to(dt), params["b_down"],
            params["w_gate"].to(dt) if cfg.gated_ffn else None)
    kw = dict(act_name=cfg.hidden_act, gated=cfg.gated_ffn,
              schedule=_fused_schedule(d, cfg.fused_schedule),
              use_kernels=uk)
    # tier-0 degradation needs the per-expert outputs before the combine
    if _fuse_combine_enabled(cfg, d) and not cfg.degrade_unhealthy_experts:
        k = cfg.expert_top_k
        cu = _combine_chunk_rows(k)
        rows_pad = -(-(s_loc * k) // (cu * k)) * (cu * k)
        maps = [dsp.sorted_return_maps(plan, r.combine_weights, cfg, cap,
                                       rows_pad) for r, plan in zip(rs, plans)]
        ret_pos = [torch.nn.functional.pad(m[0], (0, cap_pad - cap))
                   .reshape(d, nlx, cap_pad) for m in maps]
        kw.update(recv_pos=torch.stack(mesh.all_to_all(ret_pos)),
                  w_sorted=torch.stack([m[1] for m in maps]), k=k)
    return FusedInputs(rs, plans, args, kw, cap, cap_pad, s_loc)


def fused_ep_moe_layer(params, x, cfg: MoEConfig, mesh, *, src_order=None,
                       use_kernels: bool | None = None):
    """Expert-parallel MoE layer through the fused kernel; the contract of
    :func:`flashmoe_tpu_torch.parallel.ep.ep_moe_layer` on a local mesh.

    ``src_order`` ([D, D]; row r the order in which rank r takes source
    slabs, starting with r) overrides the ring.  Shared experts run
    outside the kernel on each rank's tokens.  On CUDA tensors the kernel
    runs or the call raises."""
    fi = fused_inputs(params, x, cfg, mesh, src_order=src_order,
                      use_kernels=use_kernels)
    res = fused_shard(*fi.args, **fi.kw)
    e, h = cfg.num_experts, x.shape[1]
    outs, healthy = [], []
    if "recv_pos" in fi.kw:
        outs = list(res[:, :fi.s_loc])
    else:
        slot = torch.arange(fi.cap_pad, device=x.device)
        for i, (r, plan) in enumerate(zip(fi.rs, fi.plans)):
            ybuf = res[i].reshape(e, fi.cap_pad, h)
            combine_w = r.combine_weights
            if cfg.degrade_unhealthy_experts:
                # rows past a count are unspecified in the kernel's
                # output: only populated rows may flag an expert
                live = (slot < fi.args[0][i].reshape(e, 1))[..., None]
                ybuf = torch.where(live, ybuf, torch.zeros_like(ybuf))
                ok = hlt.expert_health_capacity(ybuf)
                healthy.append(ok)
                ybuf, combine_w = hlt.degrade_outputs(ybuf, combine_w,
                                                      r.expert_idx, ok)
            outs.append(dsp.combine(ybuf, plan, combine_w, cfg, fi.cap_pad))
    for i, (xr, p) in enumerate(zip(mesh.split(x), mesh.shard_params(params))):
        if cfg.num_shared_experts:
            outs[i] = outs[i] + shared_expert_ffn(xr.to(cfg.dtype), p, cfg)
        outs[i] = outs[i].to(cfg.dtype)
    return layer_output(mesh, cfg, fi.rs, outs, fi.cap, healthy)

