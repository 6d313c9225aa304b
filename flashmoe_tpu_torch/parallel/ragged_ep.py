"""Distributed dropless MoE: expert parallelism over ragged row exchanges.

Counterpart of ``flashmoe_tpu/parallel/ragged_ep.py``.  The collective
layer (:mod:`flashmoe_tpu_torch.parallel.ep`) pads every (rank, expert)
slab to a fixed capacity; this layer moves exactly the routed rows.  Per
rank: the (token, k) assignments sort by global expert id (destination
major, :mod:`flashmoe_tpu_torch.ops.ragged` at block 1), one all-gathered
count matrix ``[D_src, D_dst, nLx]`` gives every transfer's size and
offsets, the rows move to their experts' owners, integer arithmetic (no
sort, :func:`_regroup_maps`) regroups the received source-major rows
into tile-padded expert-major segments for the grouped FFN
(:func:`flashmoe_tpu_torch.ops.expert.grouped_ffn_ad`: B2 at inference,
B6 forward and B7/B8 backward in training, on CUDA tensors), and the
whole dance runs in reverse before the combine.

The grouped buffer is sized for the worst case (``recv_bound = D *
S_loc * K`` rows plus a tile per local expert, as in JAX), but the FFN is
handed the live padded row count ``num_rows`` (the sum of the padded
segments) as a device tensor, so the kernels load nothing past it.  The
tail rows come back zero and are never gathered back, so outputs and
gradients are those of the whole buffer.

Exchanges (``exchange``), each filling the same ``[out_bound, W]``
source-major buffer:

* ``"ragged"`` (the default) moves exactly the routed rows.  On a local
  mesh it is one device-side gather whose row map is built from the
  count matrix (no host read); on a process mesh it is
  ``all_to_all_single`` with ``input_split_sizes`` /
  ``output_split_sizes``, one host read of the sizes per exchange.
* ``"dense"`` is JAX's padded fallback (``ragged_ep.py:85-113``): each
  block padded to ``block_rows`` rows, one ``Mesh.all_to_all``, then
  compacted.

With ``cfg.a2a_chunks = n`` the local-expert axis splits into n chunks,
each its own row-exchange -> regroup -> FFN -> return chain over its rows
(offsets from the one count matrix); ``None`` keeps the serial schedule.
The per-rank arithmetic is written once, over the ranks this process
holds; with ``token_axes`` beyond ep (dp, sp) each ep fibre of the mesh
exchanges its own rows and the reductions run over every token axis.
Wire dtypes, stats, tier-0 degradation and quantized storage
behave as in JAX.  The layer runs at tp 1 only (the config refuses
``moe_backend='ragged'`` with tp > 1) and without shared experts.
"""

from __future__ import annotations

import torch

from flashmoe_tpu_torch import quant as qt
from flashmoe_tpu_torch.config import MoEConfig
from flashmoe_tpu_torch.kernels import _build
from flashmoe_tpu_torch.ops import expert as exp
from flashmoe_tpu_torch.ops import health as hlt
from flashmoe_tpu_torch.ops import ragged as rag
from flashmoe_tpu_torch.ops import wire as wr
from flashmoe_tpu_torch.ops.gate import router
from flashmoe_tpu_torch.ops.moe import MoEOutput
from flashmoe_tpu_torch.parallel.ep import layer_output

EXCHANGES = ("ragged", "dense")


def _excl(t, dim: int = -1):
    """Exclusive prefix sum along ``dim``."""
    return torch.cumsum(t, dim) - t


# ----------------------------------------------------------------------
# row exchanges
# ----------------------------------------------------------------------

def _gather_rows(arrs, send_offsets, recv_sizes, recv_offsets, *,
                 out_bound, block_rows):
    """The ragged exchange within one ep fibre of a local mesh: every
    destination's
    ``[out_bound, W]`` buffer as one gather from all sources' rows (and a
    zero row), its row map scattered from the count-derived offsets.
    Source s's rows ``[send_offsets[s][p], + recv_sizes[p][s])`` land at
    ``recv_offsets[p][s]`` of destination p."""
    d = len(arrs)
    n, w = arrs[0].shape
    dev = arrs[0].device
    src = torch.cat([*arrs, arrs[0].new_zeros(1, w)])  # [d * n + 1, W]
    so = torch.stack(send_offsets).long()  # [src, dst]
    rs = torch.stack(recv_sizes).long()  # [dst, src]
    ro = torch.stack(recv_offsets).long()  # [dst, src]
    ar = torch.arange(block_rows, device=dev)
    live = ar < rs[..., None]  # [dst, src, block_rows]
    target = torch.where(live, ro[..., None] + ar, out_bound)
    value = (torch.arange(d, device=dev)[None, :, None] * n
             + so.T[..., None] + ar)
    rowmap = torch.full((d, out_bound + 1), d * n, dtype=torch.long,
                        device=dev)
    rowmap.scatter_(1, target.reshape(d, -1),
                    torch.where(live, value, d * n).reshape(d, -1))
    # index_select, whose backward is an index_add: the live rows are
    # each read once, so their gradients are exact; the many reads of the
    # zero row land on a row that is dropped (advanced indexing's
    # backward serialises over those repeats)
    return list(src.index_select(0, rowmap[:, :out_bound].reshape(-1))
                .reshape(d, out_bound, w))


def _dense_rows(mesh, arrs, out_bound, block_rows, send_offsets,
                send_sizes, recv_sizes, recv_offsets):
    """JAX's padded fallback: each source pads every block to
    ``block_rows`` rows, one all-to-all, each destination compacts."""
    d = mesh.ep
    w = arrs[0].shape[1]
    dev = arrs[0].device
    ar = torch.arange(block_rows, device=dev)
    blocks = []
    for arr, off, size in zip(arrs, send_offsets, send_sizes):
        padded = torch.cat([arr, arr.new_zeros(block_rows, w)])
        rows = padded.index_select(0, (off.long()[:, None] + ar).reshape(
            -1)).reshape(d, block_rows, w)
        blocks.append(torch.where((ar < size[:, None])[..., None], rows,
                                  torch.zeros((), dtype=arr.dtype,
                                              device=dev)))
    got = mesh.all_to_all(blocks)
    out = []
    for g, off, size in zip(got, recv_offsets, recv_sizes):
        idx = torch.where(ar < size[:, None], off.long()[:, None] + ar,
                          out_bound)  # [d, block_rows]
        buf = g.new_zeros(out_bound + 1, w).index_put(
            (idx.reshape(-1),), g.reshape(d * block_rows, w))
        out.append(buf[:out_bound])
    return out


def _process_rows(mesh, arr, out_bound, send_offsets, send_sizes,
                  recv_sizes, recv_offsets):
    """The ragged exchange on a process mesh: ``all_to_all_single`` with
    split sizes, the rows as raw bytes (gloo has no fp8 types), after one
    host read of the four size/offset vectors."""
    import torch.distributed as dist

    so, ss, rsz, ro = torch.stack([send_offsets, send_sizes, recv_sizes,
                                   recv_offsets]).long().tolist()
    raw = arr.contiguous().view(torch.uint8)  # [N, W * itemsize]
    send = torch.cat([raw[o:o + n] for o, n in zip(so, ss)])
    recv = raw.new_empty(sum(rsz), raw.shape[1])
    dist.all_to_all_single(recv, send, output_split_sizes=rsz,
                           input_split_sizes=ss, group=mesh.group)
    out = raw.new_zeros(out_bound, raw.shape[1])
    at = 0
    for o, n in zip(ro, rsz):
        out[o:o + n] = recv[at:at + n]
        at += n
    return out.view(arr.dtype)


def _row_exchange(mesh, arrs, *, exchange: str, block_rows: int,
                  out_bound: int, send_offsets, send_sizes, recv_sizes,
                  recv_offsets):
    """Move ragged row blocks of each held rank's ``arrs`` ([N, W], any W
    and dtype) between ranks (``flashmoe_tpu/parallel/ragged_ep.py:64``):
    the rank's block for peer p starts at ``send_offsets[p]`` with
    ``send_sizes[p]`` rows and lands in p's ``[out_bound, W]`` output at
    p's ``recv_offsets`` entry for this source, which holds its
    ``recv_sizes`` entry of rows (JAX's ``remote_offsets`` describe the
    same placement from the sending side).  Every argument but ``arrs``
    is a list of [D] integer tensors, one per held rank.  One function for
    both directions and for the payload and the fp8 scale column, so the
    two never take different routes."""
    if exchange == "dense":
        return _dense_rows(mesh, arrs, out_bound, block_rows, send_offsets,
                           send_sizes, recv_sizes, recv_offsets)
    if mesh.is_local:
        out = [None] * len(arrs)
        for fib in mesh.fibres("ep"):  # each ep fibre exchanges alone
            got = _gather_rows(*([v[i] for i in fib] for v in (
                arrs, send_offsets, recv_sizes, recv_offsets)),
                out_bound=out_bound, block_rows=block_rows)
            for i, g in zip(fib, got):
                out[i] = g
        return out
    return [_process_rows(mesh, arrs[0], out_bound, send_offsets[0],
                          send_sizes[0], recv_sizes[0], recv_offsets[0])]


def _wired_row_exchange(mesh, arrs, wire_dtype, **kw):
    """:func:`_row_exchange` with the wire codec at the boundary
    (``ragged_ep.py:117``): rows encode to ``wire_dtype`` before the
    transfer and decode after, fp8 per-row scales riding an identical
    second exchange as a [N, 1] column; None is the raw exchange."""
    if wire_dtype is None:
        return _row_exchange(mesh, arrs, **kw)
    enc = [wr.encode(a, wire_dtype) for a in arrs]
    payload = _row_exchange(mesh, [p for p, _ in enc], **kw)
    if enc[0][1] is None:
        return [wr.decode(p, None, a.dtype) for p, a in zip(payload, arrs)]
    scales = _row_exchange(mesh, [s[:, None] for _, s in enc], **kw)
    return [wr.decode(p, s[:, 0], a.dtype)
            for p, s, a in zip(payload, scales, arrs)]


# ----------------------------------------------------------------------
# regroup and FFN
# ----------------------------------------------------------------------

def _regroup_maps(recv_cmat, recv_offsets, recv_sizes, recv_bound: int,
                  block_m: int):
    """Source-major -> tile-padded expert-major scatter targets for one
    (chunk of the) local-expert axis (``ragged_ep.py:145``), integer for
    integer as JAX's.

    ``recv_cmat`` [D, nE]: rows per (source, local expert of the chunk);
    ``recv_offsets`` / ``recv_sizes`` [D]: where each source's block sits
    in the chunk's source-major receive buffer.  Returns ``(target
    [recv_bound], grouped_rows, tile_gid, total_recv, num_rows)``:
    dropped rows target ``grouped_rows`` itself (one past the buffer),
    and ``num_rows`` (a device scalar, beyond JAX's) is the live padded
    row count, the sum of the tile-padded segments."""
    d, ne = recv_cmat.shape
    dev = recv_cmat.device
    cm = recv_cmat.long()
    recv_offsets, recv_sizes = recv_offsets.long(), recv_sizes.long()
    etot = cm.sum(0)
    epad = (etot + block_m - 1) // block_m * block_m
    eseg = _excl(epad)
    pre = _excl(cm, 0)  # rows of this expert before source s
    intra = _excl(cm, 1)  # within-source expert starts
    rows = torch.arange(recv_bound, device=dev)
    src_of = torch.clamp(torch.searchsorted(
        (recv_offsets + recv_sizes).contiguous(), rows, right=True),
        0, d - 1)
    w = rows - recv_offsets[src_of]
    e_of = torch.clamp((w[:, None] >= torch.cumsum(cm, 1)[src_of]).sum(1),
                       0, ne - 1)
    i_of = w - intra[src_of, e_of]
    total_recv = recv_sizes.sum()
    grouped_rows = (-(-recv_bound // block_m) * block_m + ne * block_m)
    target = torch.where(rows < total_recv,
                         eseg[e_of] + pre[src_of, e_of] + i_of,
                         grouped_rows)
    tile_starts = torch.arange(grouped_rows // block_m, device=dev) * block_m
    tile_gid = torch.clamp(
        (tile_starts[:, None] >= (eseg + epad)[None, :]).sum(1), 0, ne - 1)
    return target, grouped_rows, tile_gid, total_recv, epad.sum()


def _grouped_ffn(x_grp, tile_gid, weights, cfg: MoEConfig, *,
                 use_kernels: bool, block_m: int, num_rows=None):
    """The grouped FFN on a tile-padded expert-major buffer
    (``ragged_ep.py:204``), ``weights`` = (w_up, b_up, w_down, b_down,
    w_gate or None) covering exactly the experts ``tile_gid`` indexes:
    :func:`flashmoe_tpu_torch.ops.expert.grouped_ffn_ad`, the kernels on
    CUDA tensors and ``grouped_ffn_plain``'s family on CPU ones, over
    the ``num_rows`` live rows.  Every weight is cast to x's dtype, as
    JAX's XLA arm casts them."""
    w_up, b_up, w_down, b_down, w_gate = weights
    dt = x_grp.dtype
    return exp.grouped_ffn_ad(
        x_grp, tile_gid, w_up.to(dt), b_up, w_down.to(dt), b_down,
        None if w_gate is None else w_gate.to(dt),
        act_name=cfg.hidden_act, gated=cfg.gated_ffn, block_m=block_m,
        num_rows=num_rows, use_kernels=use_kernels)


def _chunk_geometry(all_cmat, me: int, lo: int, hi: int) -> dict:
    """Rank ``me``'s transfer sizes and offsets for local experts
    ``[lo, hi)``, all arithmetic on the all-gathered count matrix
    ``all_cmat[s, p, le]`` (rows rank s sends rank p for p's local expert
    le): a chunk's rows are contiguous within each destination block of
    the expert-sorted staging buffer (``ragged_ep.py:244-300``).  At
    ``[0, nLx)`` it is the serial schedule's geometry."""
    cmat = all_cmat[me]  # [D_dst, nLx]
    send_sizes = cmat[:, lo:hi].sum(1)
    input_offsets = _excl(cmat.sum(1))
    all_send = all_cmat[:, :, lo:hi].sum(2)  # [D_src, D_dst]
    recv_sizes = all_send[:, me]
    return dict(
        send_sizes=send_sizes,
        send_offsets=input_offsets + _excl(cmat, 1)[:, lo],
        recv_sizes=recv_sizes, recv_offsets=_excl(recv_sizes),
        recv_cmat=all_cmat[:, me, lo:hi])


def _ragged_ep_shard(mesh, params: list, xs: list, cfg: MoEConfig, *,
                     exchange: str, block_m: int,
                     use_kernels: bool) -> MoEOutput:
    """The layer over the held ranks (``ragged_ep.py:366``): ``params``
    and ``xs`` are one expert-sharded parameter dict and one [S_loc, H]
    token shard per held rank.  Returns the held ranks' outputs joined,
    and the losses, counts and stats reduced over the mesh's token
    axes."""
    if exchange not in EXCHANGES:
        raise ValueError(f"exchange {exchange!r} not in {EXCHANGES}")
    if mesh.tp > 1:
        raise ValueError("the ragged layer runs at tp 1; use "
                         "moe_backend='collective' on a tp mesh")
    if block_m % exp.ROW_TILE:
        raise ValueError(f"block_m={block_m} must be a multiple of the "
                         f"kernels' row tile {exp.ROW_TILE}")
    d = mesh.ep
    s_loc, h = xs[0].shape
    e = cfg.num_experts
    nlx = e // d
    n_assign = s_loc * cfg.expert_top_k
    recv_bound = d * n_assign  # worst case: every row routed to one rank
    quant_err = ([qt.weight_quant_error(p, cfg) for p in params]
                 if cfg.expert_quant is not None and cfg.collect_stats
                 else None)
    params = [qt.ffn_compute_params(p, cfg, out_dtype=cfg.dtype)
              for p in params]
    wire_disp = wr.resolve(cfg.wire_dtype)
    wire_comb = wr.resolve(cfg.wire_dtype_combine)
    n_chunks = cfg.a2a_chunks or 1
    if n_chunks > 1 and nlx % n_chunks:
        raise ValueError(
            f"a2a_chunks={n_chunks} does not divide the local-expert "
            f"axis (num_experts={e} // ep={d} = {nlx}); pick a divisor "
            f"or leave a2a_chunks=None for the serial schedule")

    rs = [router(x, p["gate_w"], cfg, use_kernels=use_kernels)
          for x, p in zip(xs, params)]
    # the local expert-sorted layout (contiguous, unpadded: block 1)
    plans = [rag.make_ragged_plan(r.expert_idx, cfg, 1) for r in rs]
    staged = [rag.ragged_dispatch(x.to(cfg.dtype), plan, cfg, 1)[:n_assign]
              for x, plan in zip(xs, plans)]
    all_cmat = mesh.all_gather([plan.counts.reshape(d, nlx)
                                for plan in plans])
    me = [mesh.coord(r, "ep") for r in mesh.ranks]

    def stat_err(ts, wd):
        return ([wr.roundtrip_error(t, wd) for t in ts]
                if cfg.collect_stats and wd is not None else None)

    disp_err = stat_err(staged, wire_disp)
    comb_errs = []

    def move(arrs, wd, out_bound, geo, reverse):
        fwd = ("send_offsets", "send_sizes", "recv_sizes", "recv_offsets")
        keys = fwd[::-1] if reverse else fwd
        meta = {name: [g[k] for g in geo] for name, k in zip(fwd, keys)}
        return _wired_row_exchange(mesh, arrs, wd, exchange=exchange,
                                   block_rows=n_assign, out_bound=out_bound,
                                   **meta)

    nc = nlx // n_chunks
    ys = None
    for ck in range(n_chunks):
        lo = ck * nc
        geo = [_chunk_geometry(a, m, lo, lo + nc)
               for a, m in zip(all_cmat, me)]
        x_recv = move(staged, wire_disp, recv_bound, geo, False)
        y_src = []
        for xr, g, p in zip(x_recv, geo, params):
            target, grouped_rows, tile_gid, total_recv, num_rows = \
                _regroup_maps(g["recv_cmat"], g["recv_offsets"],
                              g["recv_sizes"], recv_bound, block_m)
            x_grp = xr.new_zeros(grouped_rows + 1, h).index_put(
                (target,), xr)[:grouped_rows]
            w_gate = p.get("w_gate") if cfg.gated_ffn else None
            y_grp = _grouped_ffn(
                x_grp, tile_gid,
                (p["w_up"][lo:lo + nc], p["b_up"][lo:lo + nc],
                 p["w_down"][lo:lo + nc], p["b_down"][lo:lo + nc],
                 None if w_gate is None else w_gate[lo:lo + nc]),
                cfg, use_kernels=use_kernels, block_m=block_m,
                num_rows=num_rows)
            live = (torch.arange(recv_bound, device=xr.device)
                    < total_recv)[:, None]
            # dead rows read the buffer's last row, which no live row
            # targets (see _gather_rows on index_select)
            y = y_grp.index_select(0, target.clamp(0, grouped_rows - 1))
            y_src.append(torch.where(live, y, torch.zeros(
                (), dtype=y.dtype, device=y.device)).to(xr.dtype))
        err = stat_err(y_src, wire_comb)
        if err is not None:
            comb_errs.append(err)
        # back to each source's staging slots; chunks return disjoint
        # rows (zeros elsewhere), so their sum is the whole layout
        ys_c = move(y_src, wire_comb, n_assign, geo, True)
        ys = ys_c if ys is None else [a + b for a, b in zip(ys, ys_c)]

    outs, healthy = [], []
    for r, plan, y in zip(rs, plans, ys):
        combine_w = r.combine_weights
        if cfg.degrade_unhealthy_experts:
            # the block-1 layout: expert e owns counts[e] rows; the ragged
            # combine does not renormalize, so the mask does
            ok = hlt.expert_health_segments(y, plan.counts)
            healthy.append(ok)
            y, combine_w = hlt.degrade_outputs(y, combine_w, r.expert_idx,
                                               ok, renormalize=True)
        outs.append(rag.ragged_combine(y, plan, combine_w, cfg)
                    .to(cfg.dtype))
    # dropless: no capacity, zero drops
    return layer_output(mesh, cfg, rs, outs, None, healthy, disp_err,
                        comb_errs, quant_err=quant_err)


def decode_moe_rows(params: list, xs: list, cfg: MoEConfig, mesh, *,
                    exchange: str | None = None,
                    block_m: int = exp.ROW_TILE,
                    use_kernels: bool | None = None) -> MoEOutput:
    """The ragged EP layer on each held rank's own batch rows
    (``ragged_ep.py:558``), for a caller that already holds the ranks:
    the serving engine's EP decode step.  ``params``: each held rank's
    local expert shard (``Mesh.shard_params``), ``xs``: each held rank's
    [b_local, H] decode rows.  Returns the layer's output with ``out``
    the list of the held ranks' rows.  JAX always takes its XLA arm here;
    the port runs its kernels on CUDA tensors (B1, B2), as everywhere
    on the card."""
    if cfg.num_shared_experts:
        raise NotImplementedError("shared experts stay outside this layer")
    uk = _build.use_kernels_for(xs[0], use_kernels)
    o = _ragged_ep_shard(mesh, params, xs, cfg, exchange=exchange or
                         "ragged", block_m=block_m, use_kernels=uk)
    outs = (list(o.out.split([x.shape[0] for x in xs])) if mesh.is_local
            else [o.out])
    return o._replace(out=outs)


def ragged_ep_moe_layer(params, x, cfg: MoEConfig, mesh, *,
                        token_axes: tuple[str, ...] = ("ep",),
                        exchange: str | None = None,
                        block_m: int = exp.ROW_TILE,
                        use_kernels: bool | None = None) -> MoEOutput:
    """Dropless expert-parallel MoE layer over the mesh's ep axis
    (``ragged_ep.py:579``); the contract of
    :func:`flashmoe_tpu_torch.parallel.ep.ep_moe_layer`.

    ``token_axes`` as in :func:`~flashmoe_tpu_torch.parallel.ep.
    ep_moe_layer`: each ep fibre exchanges its own rows.
    ``exchange``: ``"ragged"`` (default; exactly the routed rows) or
    ``"dense"`` (JAX's padded fallback).  ``block_m``: the grouped
    buffer's segment tile, a multiple of the kernels' 64-row tile.
    ``use_kernels`` as in :func:`flashmoe_tpu_torch.ops.moe.moe_layer`."""
    if cfg.num_shared_experts:
        raise NotImplementedError("shared experts stay outside this layer")
    uk = _build.use_kernels_for(x, use_kernels)
    mesh = mesh.over(token_axes)
    return _ragged_ep_shard(mesh, mesh.shard_params(params), mesh.split(x),
                            cfg, exchange=exchange or "ragged",
                            block_m=block_m, use_kernels=uk)
