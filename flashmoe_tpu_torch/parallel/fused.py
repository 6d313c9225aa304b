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
(:func:`flashmoe_tpu_torch.parallel.mesh.local_mesh`; on a mesh with
dp or sp each ep fibre is a kernel world of its own, launched in turn):
every rank's regions of the kernel's symmetric heap are slices of
allocations on one card, the data regions made for each call, the flag
words kept per device.  A process mesh, with peer heaps mapped from other GPUs, waits for
the multi-GPU transport (the ROADMAP item 'Blocked on hardware: the
multi-GPU transport').

Under autograd the layer runs the kernel inside two
``torch.autograd.Function``s, the counterparts of JAX's custom VJPs
(``fused.py:1696-1897``): :class:`_FusedCore` (the slabs out, the
layer's combine outside) and :class:`_FusedCombineCore` (the in-kernel
combine, ``w_sorted`` differentiable so that router gradients flow
through it).  Their backward, :func:`_ffn_bwd_from_dy`, re-exchanges the
slabs and the cotangents through ``Mesh.all_to_all``, recomputes the
pre-activations u (+ ``b_up``) and g with the grouped matmul (B7, w
[E, K, N], f32 out) over each slab's occupied 64-row tiles (the others
dead, :func:`dead_tile_gid`: zeros, where JAX recomputes every slab
row), and runs ``ffn_backward_core`` (B7, B8).  The kernel's wrapper
itself keeps refusing autograd.

The four schedule names of the JAX kernel stay, and map to two
processing orders of the one kernel: ``stream`` and ``resident`` take the
tasks (source, local expert, row tile) source-major in ``src_order``;
``batched`` and ``rowwin`` take the own slab first, then the remote slabs
expert-major.  A task is an item of up to two 64-row tiles of one expert
(paired across a unit's sources, :func:`unit_items`) against one column
tile of ``TASK_COLS`` (half that in a gated up pass).  The TPU schedules'
VMEM budgets have no counterpart: bf16 runs one block of 384 threads per
SM with a ring of TMA stages in dynamic shared memory, f32 one 64 x 64
tile's operands in a block's static shared memory, whatever the
capacity, source count or expert width.

Under ``cfg.expert_quant`` (``flashmoe_tpu/parallel/fused.py:1451-1530,
2078-2120``) full-precision weights are quantized first and
per-K-group scales are refused; every order hands the kernel the 1-byte
payloads and their ``[E, N]`` f32 scales, and the kernel dequantizes
each weight tile on chip (B5q), where JAX's non-``rowwin`` schedules
dequantize whole experts at the boundary.  The values are the same:
each element is its own f32 product, rounded once to the input dtype.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import NamedTuple

import numpy as np
import torch

from flashmoe_tpu_torch import quant as qt
from flashmoe_tpu_torch.config import MoEConfig
from flashmoe_tpu_torch.kernels import _build
from flashmoe_tpu_torch.models.reference import shared_expert_ffn
from flashmoe_tpu_torch.ops import dispatch as dsp
from flashmoe_tpu_torch.ops import expert as exp
from flashmoe_tpu_torch.ops import health as hlt
from flashmoe_tpu_torch.ops.gate import router
from flashmoe_tpu_torch.parallel.ep import layer_output, local_capacity
from flashmoe_tpu_torch.parallel.mesh import Mesh
from flashmoe_tpu_torch.quant.core import is_quant_dtype

#: the kernel's row tile and the JAX schedule's column chunk
ROW_TILE = 64
COL_TILE = 64
#: output columns of a task (csrc/ffn_hopper.cuh FH_COLS): a down task's,
#: an up task's unless gated (then half: up and gate side by side)
TASK_COLS = 256
#: bytes of one TMA map (CUtensorMap) in the bf16 kernel's map buffer
MAP_BYTES = 128
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


def col_tiles(dim: int, gated: bool = False) -> int:
    """Column tiles of a task across ``dim`` output columns:
    ``TASK_COLS`` wide, half that in a gated up pass."""
    cols = TASK_COLS // (2 if gated else 1)
    return -(-dim // cols)


def unit_items(srcs, e: int, nlx: int, n_tiles: int) -> list:
    """The items of one unit (the sources ``srcs`` of local expert e):
    its tiles ``(src * nlx + e) * n_tiles + t`` taken tile-major (tile t
    of every source in turn), then consecutive ones paired, ``(first,
    second)``, second -1 for an item of one: one tile per consumer
    warpgroup of the Hopper kernel (the f32 kernel takes them in turn).
    At the ep path's shapes a slab holds about 32 rows, one partly filled
    tile: pairing across the unit's sources keeps both of a block's
    consumer warpgroups busy, where pairing within a slab would pair a
    tile with an empty one (on an H100 3.50 ms against 4.52 unpaired,
    ``chip_ablate.py``, cut ``b5_unpaired``)."""
    tiles = [(s * nlx + e) * n_tiles + t for t in range(n_tiles)
             for s in srcs]
    return [(tiles[i], tiles[i + 1] if i + 1 < len(tiles) else -1)
            for i in range(0, len(tiles), 2)]


def task_order(src_order: np.ndarray, nlx: int, n_tiles: int, n_up: int,
               n_down: int, schedule: str) -> np.ndarray:
    """[D, n_total, 4] int32: each rank's tasks, as the kernel reads them:
    an item's two tile codes (:func:`unit_items`), ``kind << 16 |
    column tile`` (kind 0 up, 1 down) and 0, in the schedule's order.  A
    unit is one source's slab of one expert (``stream``, ``resident``), or
    the own slab first and then all remote slabs of one expert together
    (``batched``, ``rowwin``); each unit lists its up tasks column tile by
    column tile across its items, then its down tasks, so that every down
    task comes after the up tasks it waits for and the blocks running
    together share each weight strip in L2."""
    d = src_order.shape[0]
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
            items = np.asarray(unit_items(ss, e, nlx, n_tiles), np.int64)
            zero = np.zeros((len(items), 1), np.int64)
            for kind, n in ((0, n_up), (1, n_down)):
                for j in range(n):
                    rows.append(np.concatenate(
                        [items, zero + (kind << 16 | j), zero], 1))
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
                      w_gate, gated, recv_pos, w_sorted, k, scales):
    """(D, nLx, C, H, I) of the shard arguments; ValueError unless every
    tensor has the shape the kernel reads.  ``scales`` ({weight name:
    its ``*_sc`` argument}): a weight in a 1-byte store needs its
    per-output-channel scales, [D * nLx, 1, N]; a weight in x_send's
    dtype takes none."""
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
    for key, sc in scales.items():
        w = want[key][0]
        if sc is None:
            if is_quant_dtype(w.dtype):
                raise ValueError(
                    f"{name}: {key} is a {w.dtype} payload without its "
                    f"scales")
            continue
        if not is_quant_dtype(w.dtype):
            raise ValueError(f"{name}: scales given for {key} in "
                             f"{w.dtype}, which is no quantized store")
        shape = (d * nlx, 1, w.shape[-1])
        if tuple(sc.shape) != shape:
            raise ValueError(
                f"{name}: {key}'s scales are {tuple(sc.shape)}, want "
                f"{shape} (one f32 per output channel; per-K-group "
                f"stores run on the collective layer)")
    return d, nlx, c, h, i_dim


def _scales(gated, wup_sc, wdn_sc, wg_sc) -> dict:
    return {"w_up": wup_sc, "w_down": wdn_sc,
            **({"w_gate": wg_sc} if gated else {})}


def fused_shard_plain(send_cnt, src_order, x_send, w_up, b_up, w_down,
                      b_down, w_gate=None, *, act_name: str,
                      gated: bool = False, schedule: str = "stream",
                      recv_pos=None, w_sorted=None, k: int = 1,
                      wup_sc=None, wdn_sc=None, wg_sc=None,
                      return_sorted: bool = False):
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
    k-row weighted combine, [D, rows_pad / k, H] f32 (with
    ``return_sorted`` also the token-sorted rows y_sorted [D, rows_pad,
    H], zero where nothing returned).  ``src_order``
    (checked as the kernel checks it) and ``schedule`` order the kernel's
    work and do not change the values.

    Quantized weights (B5q): int8 / e4m3 payloads with their
    ``wup_sc`` / ``wdn_sc`` / ``wg_sc`` scales [D * nLx, 1, N] dequantize
    to x_send's dtype, then the body above runs."""
    d, nlx, c, h, _ = _check_shard_args(
        "fused_shard_plain", send_cnt, x_send, w_up, b_up, w_down, b_down,
        w_gate, gated, recv_pos, w_sorted, k,
        _scales(gated, wup_sc, wdn_sc, wg_sc))
    check_src_order(src_order, d)
    deq = functools.partial(qt.dequantize_channelwise,
                            out_dtype=x_send.dtype)
    if wup_sc is not None:
        w_up, w_down = deq(w_up, wup_sc), deq(w_down, wdn_sc)
        if gated:
            w_gate = deq(w_gate, wg_sc)
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
    out = yw.reshape(d, rows_pad // k, k, h).sum(2)
    return (out, y_sorted) if return_sorted else out


class _Flags:
    """The kernel's flag words on one device, kept across calls: each
    rank's barrier counter, work counter and dispatch, up and return
    flags (a few KB).  The flags carry each call's sequence number and
    are never reset, the work counter a running base, so no call resets
    them; the data regions are allocated for each call."""

    def __init__(self, key, d, n_flags, device):
        self.stride = -(-(16 + 4 * n_flags) // 256) * 256
        self.key = key
        self.mem = torch.zeros(d * self.stride, dtype=torch.uint8,
                               device=device)
        self.peers = self.mem.data_ptr() + self.stride * torch.arange(
            d, dtype=torch.int64, device=device)
        self.seq = 0
        self.work_base = 0
        self.orders = {}


# the flag words of the layout last used on each device
_FLAGS: dict = {}
_MAX_BLOCKS: dict = {}


#: the kernel's weight codes (csrc/fused_ep.cu): in x's dtype, int8, e4m3
_WEIGHT_CODE = {"full": 0, "int8": 1, "e4m3": 2}
_STORES = {v: k for k, v in _WEIGHT_CODE.items()}


def _weight_code(w, x) -> int:
    if w.dtype == x.dtype:
        return _WEIGHT_CODE["full"]
    return _WEIGHT_CODE["int8" if w.dtype == torch.int8 else "e4m3"]


def max_blocks(x, gated: bool, wq: int = 0) -> int:
    """The most kernel blocks of the arm (x's dtype, ``gated``, weight code
    ``wq``) that can be resident at once on x's device (occupancy times
    the SM count)."""
    key = (x.device, x.dtype, gated, wq)
    if key not in _MAX_BLOCKS:
        n = ctypes.c_int(0)
        with torch.cuda.device(x.device):
            err = _build.library().fm_fused_ep_max_blocks(
                int(x.dtype == torch.bfloat16), int(gated), wq,
                ctypes.byref(n))
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


def _rank_addresses(t) -> list:
    """The addresses of :func:`_rank_table`, on the host."""
    step = t.stride(0) * t.element_size()
    return [t.data_ptr() + step * r for r in range(t.shape[0])]


def fused_shard_cuda(send_cnt, src_order, x_send, w_up, b_up, w_down,
                     b_down, w_gate=None, *, act_name: str,
                     gated: bool = False, schedule: str = "stream",
                     recv_pos=None, w_sorted=None, k: int = 1,
                     wup_sc=None, wdn_sc=None, wg_sc=None,
                     return_sorted: bool = False,
                     blocks_per_rank: int | None = None,
                     timeout_s: float = TIMEOUT_S):
    """The fused kernel (``csrc/fused_ep.cu``) on CUDA tensors, with
    :func:`fused_shard_plain`'s arguments and results; rows past a count
    (and, with ``return_sorted``, y_sorted's rows nothing returned into)
    are unspecified here.  ``src_order`` is a [D, D] array (None: the
    ring).  ``blocks_per_rank`` defaults to the most the card keeps
    resident; a grid larger than that raises ValueError, never launches.
    Weights are in x_send's dtype, or all int8 or all e4m3 payloads with
    their per-output-channel scales (B5q, the kernel's quantized arm,
    at any schedule).  Bad shapes, payloads without scales, grouped
    scales or bad source orders raise ValueError; autograd is refused.
    Launches on the current stream without synchronising."""
    name = "fused_shard_cuda"
    combine = recv_pos is not None
    _build.refuse_autograd(name, x_send, w_up, b_up, w_down, b_down, w_gate)
    if x_send.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name} takes bf16 or f32, got {x_send.dtype}")
    d, nlx, c, h, i_dim = _check_shard_args(
        name, send_cnt, x_send, w_up, b_up, w_down, b_down, w_gate, gated,
        recv_pos, w_sorted, k, _scales(gated, wup_sc, wdn_sc, wg_sc))
    weights = [w_up, w_down] + ([w_gate] if gated else [])
    if len({w.dtype for w in weights}) != 1 or not (
            weights[0].dtype == x_send.dtype
            or is_quant_dtype(weights[0].dtype)):
        raise ValueError(
            f"{name}: weights must all be in x_send's dtype or all in one "
            f"quantized store, got {[w.dtype for w in weights]}")
    wq = _weight_code(w_up, x_send)
    scales = {}  # the kernel's [E, N] f32 scales, by weight
    if wq:
        scales = {k: sc.float().reshape(d * nlx, -1).contiguous()
                  for k, sc in _scales(gated, wup_sc, wdn_sc, wg_sc).items()}
    if h % 64 or i_dim % 64 or d > 128:
        raise ValueError(f"{name} needs H, I % 64 == 0 and D <= 128, got "
                         f"H={h}, I={i_dim}, D={d}")
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown fused schedule {schedule!r}")
    so = check_src_order(src_order, d)
    cnt32 = send_cnt.to(torch.int32).contiguous()
    b_up32, b_down32 = b_up.float().contiguous(), b_down.float().contiguous()
    tensors = [x_send, cnt32, b_up32, b_down32, *weights, *scales.values()]
    rows_pad = 0
    if combine:
        recv_pos = recv_pos.to(torch.int32).contiguous()
        w_sorted = w_sorted.float().contiguous()
        rows_pad = w_sorted.shape[1]
        tensors += [recv_pos, w_sorted]
    _build.require_cuda(name, *tensors)
    ch = -(-c // ROW_TILE) * ROW_TILE
    n_tiles = ch // ROW_TILE
    most = max_blocks(x_send, gated, wq)
    g = blocks_per_rank if blocks_per_rank is not None else most // d
    if g < 1 or d * g > most:
        raise ValueError(
            f"{name}: {d} ranks x {g} blocks exceed the {most} blocks this "
            f"card keeps resident at once; every block may wait on "
            f"another, so such a grid could deadlock")
    n_up, n_down = col_tiles(i_dim, gated), col_tiles(h)
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
    # the same table on the host: the bf16 kernel's TMA maps are encoded
    # from it into a device buffer, [3 + 2 D] maps
    host_peers = torch.tensor(
        [a for t in (x_recv, ret, hidden) for a in _rank_addresses(t)]
        + [flags.mem.data_ptr() + flags.stride * r for r in range(d)],
        dtype=torch.int64)
    maps = (torch.empty((3 + 2 * d) * MAP_BYTES, dtype=torch.uint8,
                        device=dev) if dt == torch.bfloat16 else None)
    out = (torch.empty((d, rows_pad // k, h), dtype=torch.float32,
                       device=dev) if combine else None)
    # the flags keep this call's sequence number only if it launched
    seq = flags.seq + 1
    with torch.cuda.device(dev):
        err = _build.library().fm_fused_ep(
            int(dt == torch.bfloat16), int(gated), wq,
            exp._ACT_CODE[act_name],
            d, nlx, c, ch, h, i_dim, k, int(combine), rows_pad, g,
            order.shape[1], seq, flags.work_base, int(timeout_s * 1e9),
            x_send.data_ptr(), cnt32.data_ptr(), order.data_ptr(),
            recv_pos.data_ptr() if combine else None,
            w_sorted.data_ptr() if combine else None, w_up.data_ptr(),
            w_gate.data_ptr() if gated else None, b_up32.data_ptr(),
            w_down.data_ptr(), b_down32.data_ptr(),
            *(scales[k].data_ptr() if k in scales else None
              for k in ("w_up", "w_gate", "w_down")),
            peers.data_ptr(), host_peers.data_ptr(),
            maps.data_ptr() if maps is not None else None,
            out.data_ptr() if combine else None, _build.stream_of(x_send))
    _build.check(err, "fm_fused_ep")
    flags.seq = seq
    flags.work_base += order.shape[1] + g
    fused_shard_cuda.launches += 1
    fused_shard_cuda.store_launches[_STORES[wq]] += 1
    if combine:
        return (out, ret) if return_sorted else out
    return ret.view(d, d, nlx, ch, h)[:, :, :, :c].contiguous()


fused_shard_cuda.launches = 0
#: the launches above by weight store: "full" (x_send's dtype), and B5q's
#: "int8" and "e4m3"
fused_shard_cuda.store_launches = dict.fromkeys(_WEIGHT_CODE, 0)


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
    and padded capacities, the local token count, and each rank's weight
    round-trip error (fake quantization with ``collect_stats``, else
    None)."""

    rs: list
    plans: list
    args: tuple
    kw: dict
    cap: int
    cap_pad: int
    s_loc: int
    quant_err: list | None = None
    #: with the in-kernel combine, each source's [D, nLx, C] sorted row of
    #: each slab slot (the backward's map), stacked
    ret_pos: torch.Tensor | None = None


def _quant_weights(params, cfg: MoEConfig, mesh):
    """(the expert weights and biases of the shard arguments, the scale
    keywords, each rank's round-trip error or None) under
    ``cfg.expert_quant``, as ``flashmoe_tpu/parallel/fused.py:2078-2120``
    and ``:1451-1530``: full-precision weights quantize first, per-K-group
    scales are refused, and the payloads go to the kernel with their
    scales."""
    gated = cfg.gated_ffn
    dt = cfg.dtype
    if cfg.expert_quant is None:
        qt.ensure_unquantized(params)
        return ((params["w_up"].to(dt), params["b_up"],
                 params["w_down"].to(dt), params["b_down"],
                 params["w_gate"].to(dt) if gated else None), {}, None)
    quant_err = ([qt.weight_quant_error(p, cfg)
                  for p in mesh.shard_params(params)]
                 if cfg.collect_stats else None)
    if not qt.is_quantized(params):
        params = qt.quantize_ffn_params(params, cfg.expert_quant)
    sfx = qt.SCALE_SUFFIX
    sc = {"wup_sc": params["w_up" + sfx], "wdn_sc": params["w_down" + sfx],
          "wg_sc": params["w_gate" + sfx] if gated else None}
    if any(v is not None and v.shape[-2] != 1 for v in sc.values()):
        raise ValueError(
            "the fused path supports per-OUTPUT-CHANNEL quant "
            "scales only (quantize_state without group_size); "
            "per-K-group states run on the collective/ragged "
            "paths, or dequantize_state() + requantize "
            "per-channel")
    return ((params["w_up"], params["b_up"], params["w_down"],
             params["b_down"], params["w_gate"] if gated else None),
            sc, quant_err)


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
            "per process waits for the ROADMAP item 'Blocked on hardware: "
            "the multi-GPU transport'")
    if mesh.tp > 1:
        raise ValueError("the fused layer runs at tp 1; use "
                         "moe_backend='collective' on a tp mesh")
    if len(mesh.ranks) != mesh.ep:
        raise ValueError(f"fused_inputs takes one ep fibre; {mesh!r} "
                         f"holds {len(mesh.ranks) // mesh.ep}")
    d = mesh.ep
    schedule = _fused_schedule(d, cfg.fused_schedule)
    weights, scale_kw, quant_err = _quant_weights(params, cfg, mesh)
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
    args = (torch.stack(counts), so, torch.stack(sends), *weights)
    kw = dict(act_name=cfg.hidden_act, gated=cfg.gated_ffn,
              schedule=schedule, use_kernels=uk, **scale_kw)
    ret_pos = None
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
        ret_pos = torch.stack(ret_pos)
    return FusedInputs(rs, plans, args, kw, cap, cap_pad, s_loc, quant_err,
                       ret_pos)


# ----------------------------------------------------------------------
# the differentiable core: the kernel forward, a grouped-matmul backward
# ----------------------------------------------------------------------
#
# The kernel's dataflow is  x_send --a2a--> x_recv --FFN--> y_stage
# --a2a--> y_back.  The exchange is its own transpose, so the backward
# re-exchanges the primals and the cotangents and runs every large GEMM
# (the pre-activation recompute, dHidden and dX, the weight gradients)
# through the grouped kernels.  Expert shards are disjoint across ranks:
# the weight gradients need no reduction.

def dead_tile_gid(gid, counts, ch: int):
    """The recompute's tile map: ``gid`` (one owner's expert-major buffer
    of [nLx, D, ch] slab rows, one expert per ROW_TILE-row tile) with -1
    on each tile at or past its slab's row count (``counts`` [D (source),
    nLx], the rows the owner received).  The grouped matmul loads and
    multiplies nothing on such a dead tile and writes zeros.  Tensor ops
    on the device: no host sync."""
    start = torch.arange(0, ch, ROW_TILE, device=gid.device)
    live = start < counts.t().to(gid.device)[..., None]  # [nLx, D, tiles]
    return torch.where(live.reshape(-1), gid, -1)


def _ffn_bwd_from_dy(mesh, x_send, w_up, b_up, w_down, b_down, w_gate, dy,
                     send_cnt, *, act_name: str, use_kernels: bool):
    """The shared backward tail (``fused.py:1729``): the cotangent ``dy``
    of the returned slabs y_back [D, D, nLx, C, H] -> the gradients of
    (x_send, w_up, b_up, w_down, b_down, w_gate).  Per owner rank its
    received slabs (and cotangents) are one expert-major buffer of every
    slab row, C padded to the kernels' 64-row tile; u = x @ w_up + b_up
    and g = x @ w_gate are recomputed in f32 by the grouped matmul with
    w [E, K, N], then ``ffn_backward_core`` runs.  The recompute runs
    over the occupied tiles only (:func:`dead_tile_gid` of ``send_cnt``
    [D, D, nLx]): on a slab's tiles past its count x @ W is zero, where
    JAX computes it.  ``dy`` is zero on every row past a count, so no
    gradient changes; ``ffn_backward_core`` keeps the full map."""
    d, _, nlx, c, h = x_send.shape
    gated = w_gate is not None
    ch = -(-c // ROW_TILE) * ROW_TILE
    pad = (0, 0, 0, ch - c)
    x_recv = mesh.all_to_all(list(torch.nn.functional.pad(x_send, pad)))
    dy_stage = mesh.all_to_all(list(torch.nn.functional.pad(
        dy.to(x_send.dtype), pad)))
    tiles = d * ch // ROW_TILE
    gid = torch.arange(nlx * tiles, device=x_send.device) // tiles
    kw = dict(use_kernels=use_kernels)
    d_x, d_wu, d_bu, d_wd, d_bd, d_wg = ([] for _ in range(6))
    for r in range(d):
        own = slice(r * nlx, (r + 1) * nlx)
        xr = x_recv[r].transpose(0, 1).reshape(nlx * d * ch, h)
        dyr = dy_stage[r].transpose(0, 1).reshape(nlx * d * ch, h)
        live = dead_tile_gid(gid, send_cnt[:, r], ch)
        u = exp.grouped_matmul(xr, live, w_up[own], out_dtype=torch.float32,
                               **kw)
        u = (u.reshape(nlx, d * ch, -1) + b_up[own, None, :].float()
             ).reshape(u.shape)
        g = (exp.grouped_matmul(xr, live, w_gate[own],
                                out_dtype=torch.float32, **kw)
             if gated else None)
        grads = exp.ffn_backward_core(
            xr, gid, w_up[own], w_down[own],
            w_gate[own] if gated else None, u, g, dyr, act_name=act_name,
            gated=gated, **kw)
        del u, g
        for acc, t in zip((d_x, d_wu, d_bu, d_wd, d_bd, d_wg), grads):
            acc.append(t)
        d_x[-1] = d_x[-1].to(x_send.dtype).reshape(nlx, d, ch, h) \
            .transpose(0, 1)
    d_x_send = torch.stack(mesh.all_to_all(d_x))[..., :c, :]
    return (d_x_send, torch.cat(d_wu).to(w_up.dtype),
            torch.cat(d_bu).to(b_up.dtype), torch.cat(d_wd).to(w_down.dtype),
            torch.cat(d_bd).to(b_down.dtype),
            torch.cat(d_wg).to(w_gate.dtype) if gated else None)


class _FusedCore(torch.autograd.Function):
    """The fused kernel returning its slabs (``_fused_core``,
    ``fused.py:1708``): forward B5 (or its plain version), backward
    :func:`_ffn_bwd_from_dy` (``_fused_core_bwd``, ``:1783``).  Rows past
    a count are unspecified in the kernel's output; the layer's combine
    never reads them, so their cotangent is zero."""

    @staticmethod
    def forward(ctx, x_send, w_up, b_up, w_down, b_down, w_gate, send_cnt,
                src_order, mesh, kw):
        ctx.save_for_backward(x_send, w_up, b_up, w_down, b_down, w_gate,
                              send_cnt)
        ctx.mesh, ctx.kw = mesh, kw
        return fused_shard(send_cnt, src_order, x_send, w_up, b_up, w_down,
                           b_down, w_gate, **kw)

    @staticmethod
    def backward(ctx, dy):
        *saved, send_cnt = ctx.saved_tensors
        grads = _ffn_bwd_from_dy(
            ctx.mesh, *saved, dy, send_cnt, act_name=ctx.kw["act_name"],
            use_kernels=ctx.kw["use_kernels"])
        return (*grads, None, None, None, None)


class _FusedCombineCore(torch.autograd.Function):
    """The fused kernel with the in-kernel combine
    (``_fused_combine_core``, ``fused.py:1816``): forward B5 writing the
    returned rows at their token-sorted rows and combining them; backward
    (``_fused_combine_core_bwd``, ``:1844``) peels the combine, each
    occupied slab slot's cotangent ``w_sorted[row] * dout[row // k]``
    through its sorted row ``ret_pos``, unoccupied slots a hard zero, then
    :func:`_ffn_bwd_from_dy`.  ``w_sorted``'s gradient is ``<dout[r //
    k], y_sorted[r]>`` on the rows some occupied slot returned into;
    y_sorted's other rows are unwritten by the kernel, so they are masked
    before any arithmetic (a NaN there must not leak)."""

    @staticmethod
    def forward(ctx, x_send, w_up, b_up, w_down, b_down, w_gate, w_sorted,
                send_cnt, src_order, ret_pos, mesh, kw):
        out, y_sorted = fused_shard(send_cnt, src_order, x_send, w_up, b_up,
                                    w_down, b_down, w_gate,
                                    w_sorted=w_sorted, return_sorted=True,
                                    **kw)
        ctx.save_for_backward(x_send, w_up, b_up, w_down, b_down, w_gate,
                              w_sorted, send_cnt, ret_pos, y_sorted)
        ctx.mesh, ctx.kw = mesh, kw
        return out

    @staticmethod
    def backward(ctx, dout):
        (x_send, w_up, b_up, w_down, b_down, w_gate, w_sorted, send_cnt,
         ret_pos, y_sorted) = ctx.saved_tensors
        d, rows_pad = w_sorted.shape
        k = ctx.kw["k"]
        c = x_send.shape[3]
        dout = dout.float()  # [D, rows_pad // k, H]
        occupied = (torch.arange(c, device=x_send.device)
                    < send_cnt[..., None])  # [src, dst, nLx, C]
        pos = ret_pos.long()
        src = torch.arange(d, device=pos.device)[:, None, None, None]
        w_slab = w_sorted[src, pos]  # [src, dst, nLx, C]
        dy = torch.where(occupied[..., None],
                         w_slab[..., None] * dout[src, pos // k],
                         torch.zeros((), device=dout.device))
        grads = _ffn_bwd_from_dy(
            ctx.mesh, x_send, w_up, b_up, w_down, b_down, w_gate, dy,
            send_cnt, act_name=ctx.kw["act_name"],
            use_kernels=ctx.kw["use_kernels"])
        occ_rows = torch.zeros((d, rows_pad + 1), dtype=torch.bool,
                               device=pos.device)
        occ_rows.scatter_(1, torch.where(occupied, pos, rows_pad)
                          .reshape(d, -1), True)
        occ_rows = occ_rows[:, :rows_pad, None]
        zero = torch.zeros((), device=dout.device)
        y = torch.where(occ_rows, y_sorted.float(), zero)
        tok = torch.arange(rows_pad, device=pos.device) // k
        d_ws = torch.where(occ_rows[..., 0],
                           (dout[:, tok] * y).sum(-1), zero)
        return (*grads, d_ws.to(w_sorted.dtype), None, None, None, None,
                None)


def fused_core(fi: FusedInputs, mesh):
    """The fused kernel on the layer's inputs (:func:`fused_inputs`): a
    plain :func:`fused_shard` call, or, with grad enabled and an input
    requiring grad (x_send, a weight or ``w_sorted``), through
    :class:`_FusedCore` / :class:`_FusedCombineCore`.  A quantized store
    always takes the plain call: ``expert_quant`` is inference-only."""
    send_cnt, so, x_send, *weights = fi.args
    kw = dict(fi.kw)
    quant = "wup_sc" in kw
    if quant or not torch.is_grad_enabled() or not any(
            t is not None and t.requires_grad
            for t in (x_send, *weights, kw.get("w_sorted"))):
        return fused_shard(*fi.args, **kw)
    if "recv_pos" not in kw:
        return _FusedCore.apply(x_send, *weights, send_cnt, so, mesh, kw)
    w_sorted = kw.pop("w_sorted")
    return _FusedCombineCore.apply(x_send, *weights, w_sorted, send_cnt, so,
                                   fi.ret_pos, mesh, kw)


def fused_ep_moe_layer(params, x, cfg: MoEConfig, mesh, *,
                       token_axes: tuple[str, ...] = ("ep",),
                       src_order=None, use_kernels: bool | None = None):
    """Expert-parallel MoE layer through the fused kernel; the contract of
    :func:`flashmoe_tpu_torch.parallel.ep.ep_moe_layer` on a local mesh,
    differentiable (:func:`fused_core`).

    ``token_axes`` as in :func:`~flashmoe_tpu_torch.parallel.ep.
    ep_moe_layer`: each ep fibre of the mesh (its ep ranks at one dp,
    pp and sp coordinate) is one kernel world, launched on its own, and
    the losses, counts and stats reduce over every token axis.
    ``src_order`` ([D, D]; row r the order in which rank r takes source
    slabs, starting with r) overrides the ring.  Shared experts run
    outside the kernel on each rank's tokens.  On CUDA tensors the kernel
    runs or the call raises."""
    if not mesh.is_local:
        raise NotImplementedError(
            "fused_ep_moe_layer runs the ranks of a local mesh; one rank "
            "per process waits for the ROADMAP item 'Blocked on hardware: "
            "the multi-GPU transport'")
    if mesh.tp > 1:
        raise ValueError("the fused layer runs at tp 1; use "
                         "moe_backend='collective' on a tp mesh")
    mesh = mesh.over(token_axes)
    xs = mesh.split(x)
    sub = Mesh(mesh.ep, tuple(range(mesh.ep)), device=mesh.device)
    per, cap = [None] * len(xs), None
    for fib in mesh.fibres("ep"):
        rows, cap = _fused_fibre(params, torch.cat([xs[i] for i in fib]),
                                 cfg, sub, src_order, use_kernels)
        for i, row in zip(fib, rows):
            per[i] = row
    outs, rs, healthy, quant_err = (list(c) for c in zip(*per))
    return layer_output(mesh, cfg, rs, outs, cap,
                        healthy if cfg.degrade_unhealthy_experts else [],
                        quant_err=None if quant_err[0] is None
                        else quant_err)


def _fused_fibre(params, x, cfg: MoEConfig, mesh, src_order, use_kernels):
    """The fused layer over one ep fibre (``mesh`` an ep-only local mesh,
    ``x`` the fibre's tokens): per rank (output before the reductions,
    router output, health mask or None, quantized weights' error or
    None), and the capacity."""
    fi = fused_inputs(params, x, cfg, mesh, src_order=src_order,
                      use_kernels=use_kernels)
    res = fused_core(fi, mesh)
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
    none = [None] * len(outs)
    return (list(zip(outs, fi.rs, healthy or none, fi.quant_err or none)),
            fi.cap)

