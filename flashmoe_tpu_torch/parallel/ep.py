"""Expert-parallel MoE layer over collectives.

Counterpart of ``flashmoe_tpu/parallel/ep.py:85-520``.  Every rank of the
mesh (:mod:`flashmoe_tpu_torch.parallel.mesh`) routes its token shard
over all E experts, scatters its tokens into a capacity buffer
``[E, C, H]``, exchanges expert-major slabs ``[D, nLx, C, H]`` with an
all-to-all, runs its local experts' grouped FFN on ``[nLx, D*C, H]``
(:func:`flashmoe_tpu_torch.ops.expert.capacity_buffer_ffn_ad`: the B2
kernel on CUDA tensors), returns the results by the reverse all-to-all
and combines its own tokens.

The exchange is flat, or the two-stage (inner, outer) decomposition of a
multi-slice world (``dcn_inner`` ranks per slice); either leg may
compress its payload to a wire dtype (:mod:`flashmoe_tpu_torch.ops.wire`),
and the cross-slice hop may take its own (``wire_dtype_dcn``).  With
``a2a_chunks = n`` the slabs split into n chunks of local experts, each
its own dispatch -> FFN -> return chain.  ``skip_exchange`` elides both
exchanges (the compute-only leg of an overlap measurement; tokens then
meet the wrong experts).

The per-rank arithmetic is written once, over the ranks this process
holds: every stage is a list over them, and the ranks meet only in the
mesh's all-to-all and reductions.  Quantized expert storage enters
through the boundary hook on each rank's shard
(``flashmoe_tpu/parallel/ep.py:220-235``): payloads dequantize to the
compute dtype, full-precision weights fake-quantize, and with the knob
off a quantized store is refused.  Left out: the tensor-parallel split
of the experts (``tp`` stays refused by the config).
"""

from __future__ import annotations

import torch

from flashmoe_tpu_torch import quant as qt
from flashmoe_tpu_torch.config import MoEConfig
from flashmoe_tpu_torch.kernels import _build
from flashmoe_tpu_torch.models.reference import shared_expert_ffn
from flashmoe_tpu_torch.ops import dispatch as dsp
from flashmoe_tpu_torch.ops import expert as exp
from flashmoe_tpu_torch.ops import health as hlt
from flashmoe_tpu_torch.ops import stats as st
from flashmoe_tpu_torch.ops import wire as wr
from flashmoe_tpu_torch.ops.gate import router
from flashmoe_tpu_torch.ops.moe import MoEOutput, dense_ffn

_FFN_KEYS = ("w_up", "w_gate", "b_up", "w_down", "b_down")


def local_capacity(cfg: MoEConfig, s_local: int) -> int:
    """Per-(rank, expert) capacity over a local token shard."""
    return cfg.capacity_for(s_local)


def _hier_stage(mesh, ts: list, d: int, inner: int, *, stage: str) -> list:
    """One hop of the two-stage exchange on ``[D, ...]`` dest-major
    tensors: 'inner' within each slice, 'outer' across slices."""
    outer = d // inner
    rest = ts[0].shape[1:]
    if stage == "inner":
        ax = 1
        groups = [[o * inner + i for i in range(inner)]
                  for o in range(outer)]
    else:
        ax = 0
        groups = [[o * inner + j for o in range(outer)]
                  for j in range(inner)]
    out = mesh.all_to_all([t.reshape((outer, inner) + rest) for t in ts],
                          axis=ax, groups=groups)
    return [t.reshape((d,) + rest) for t in out]


def _hierarchical_a2a(mesh, ts: list, d: int, inner: int, *,
                      reverse: bool) -> list:
    """The two-stage all-to-all: the same result as the flat one."""
    stages = ["inner", "outer"]
    if reverse:
        stages = stages[::-1]
    for stage in stages:
        ts = _hier_stage(mesh, ts, d, inner, stage=stage)
    return ts


def _exchange(mesh, ts: list, d: int, dcn_inner: int | None, *,
              reverse: bool) -> list:
    """One exchange of ``[D, ...]`` dest-major tensors: two-stage when a
    slice blocking is given, else flat."""
    if dcn_inner is not None and 1 < dcn_inner < d:
        return _hierarchical_a2a(mesh, ts, d, dcn_inner, reverse=reverse)
    return mesh.all_to_all(ts)


def _coded(fn, ts: list, wire_dtype) -> list:
    """``fn`` (an exchange of a list) with the payload encoded at
    ``wire_dtype`` and the fp8 scales riding the same route."""
    if wire_dtype is None:
        return fn(ts)
    enc = [wr.encode(t, wire_dtype) for t in ts]
    payload = fn([p for p, _ in enc])
    if enc[0][1] is None:
        return [wr.decode(p, None, t.dtype) for p, t in zip(payload, ts)]
    scales = fn([s for _, s in enc])
    return [wr.decode(p, s, t.dtype)
            for p, s, t in zip(payload, scales, ts)]


def _wired_exchange(mesh, ts: list, wire_dtype, d: int,
                    dcn_inner: int | None, *, reverse: bool,
                    wire_dcn=None) -> list:
    """Exchange ``ts`` ([D, ..., H], rows on the last axis), encoded at
    ``wire_dtype`` for the wire only.  With ``wire_dcn`` on a two-stage
    exchange each hop encodes on its own: the in-slice hop at the leg's
    wire, the cross-slice hop at ``wire_dcn``."""
    hier = dcn_inner is not None and 1 < dcn_inner < d
    if wire_dcn is not None and hier:
        stages = [("inner", wire_dtype), ("outer", wire_dcn)]
        if reverse:
            stages = stages[::-1]
        for stage, wd in stages:
            ts = _coded(lambda v, s=stage: _hier_stage(
                mesh, v, d, dcn_inner, stage=s), ts, wd)
        return ts
    return _coded(lambda v: _exchange(mesh, v, d, dcn_inner,
                                      reverse=reverse), ts, wire_dtype)


def _max_err(errs):
    """Elementwise max over per-chunk lists of per-rank errors."""
    return [torch.stack(list(e)).amax(0) for e in zip(*errs)]


def _ep_moe_shard(mesh, params: list, xs: list, cfg: MoEConfig, *,
                  dcn_inner: int | None, skip_exchange: bool,
                  use_kernels: bool) -> MoEOutput:
    """The layer over the held ranks: ``params`` and ``xs`` are one
    expert-sharded parameter dict and one [S_loc, H] token shard per held
    rank.  Returns the held ranks' outputs joined, and the losses, counts
    and stats reduced over the mesh."""
    d = mesh.size
    s_loc, h = xs[0].shape
    e = cfg.num_experts
    nlx = e // d
    cap = local_capacity(cfg, s_loc)
    # each rank's expert shard resolved to its compute weights (every
    # FFN below casts them to cfg.dtype)
    quant_err = ([qt.weight_quant_error(p, cfg) for p in params]
                 if cfg.expert_quant is not None and cfg.collect_stats
                 else None)
    params = [qt.ffn_compute_params(p, cfg, out_dtype=cfg.dtype)
              for p in params]
    wire_disp = wr.resolve(cfg.wire_dtype)
    wire_comb = wr.resolve(cfg.wire_dtype_combine)
    hier_on = dcn_inner is not None and 1 < dcn_inner < d
    wire_dcn = wr.resolve(cfg.wire_dtype_dcn) if hier_on else None
    n_chunks = cfg.a2a_chunks or 1
    if n_chunks > 1 and nlx % n_chunks:
        raise ValueError(
            f"a2a_chunks={n_chunks} does not divide the local-expert "
            f"axis (num_experts={e} // ep={d} = {nlx}); pick a divisor "
            f"or leave a2a_chunks=None for the serial schedule")

    rs = [router(x, p["gate_w"], cfg, use_kernels=use_kernels)
          for x, p in zip(xs, params)]
    plans = [dsp.make_plan(r.expert_idx, cfg, cap) for r in rs]
    sends = [dsp.dispatch(x.to(cfg.dtype), plan, cfg, cap)
             .reshape(d, nlx, cap, h) for x, plan in zip(xs, plans)]

    def stat_err(ts, wd):
        """Per-rank round-trip error of a wire, only with collect_stats."""
        return ([wr.roundtrip_error(t, wd) for t in ts]
                if cfg.collect_stats and wd is not None else None)

    disp_err = stat_err(sends, wire_disp)
    # per-chunk lists of per-rank errors, max-reduced over chunks
    dcn_err = stat_err(sends, wire_dcn)
    comb_errs, dcn_errs = [], [] if dcn_err is None else [dcn_err]

    def exchange(ts, wd, reverse):
        if skip_exchange:
            return ts
        return _wired_exchange(mesh, ts, wd, d, dcn_inner, reverse=reverse,
                               wire_dcn=wire_dcn)

    nc = nlx // n_chunks
    ybacks = []
    for ck in range(n_chunks):
        lo = ck * nc
        recv = exchange([s[:, lo:lo + nc] for s in sends], wire_disp, False)
        ysend = []
        for rv, p in zip(recv, params):
            p_k = {k: (v[lo:lo + nc] if k in _FFN_KEYS else v)
                   for k, v in p.items()}
            buf = rv.transpose(0, 1).reshape(nc, d * cap, h)
            y = exp.capacity_buffer_ffn_ad(buf, p_k, cfg,
                                           use_kernels=use_kernels)
            ysend.append(y.reshape(nc, d, cap, h).transpose(0, 1))
        for errs, wd in ((comb_errs, wire_comb), (dcn_errs, wire_dcn)):
            err = stat_err(ysend, wd)
            if err is not None:
                errs.append(err)
        ybacks.append(exchange(ysend, wire_comb, True))
    ybufs = [torch.cat([yb[i] for yb in ybacks], 1).reshape(e, cap, h)
             for i in range(len(xs))]

    outs, healthy = [], []
    for x, p, r, plan, ybuf in zip(xs, params, rs, plans, ybufs):
        combine_w = r.combine_weights
        if cfg.degrade_unhealthy_experts:
            ok = hlt.expert_health_capacity(ybuf)
            healthy.append(ok)
            ybuf, combine_w = hlt.degrade_outputs(ybuf, combine_w,
                                                  r.expert_idx, ok)
        out = dsp.combine(ybuf, plan, combine_w, cfg, cap)
        if cfg.num_shared_experts:
            out = out + shared_expert_ffn(x.to(cfg.dtype), p, cfg)
        outs.append(out.to(cfg.dtype))
    return layer_output(mesh, cfg, rs, outs, cap, healthy, disp_err,
                        comb_errs, dcn_errs, quant_err)


def layer_output(mesh, cfg: MoEConfig, rs: list, outs: list, cap: int,
                 healthy: list, disp_err=None, comb_errs=(), dcn_errs=(),
                 quant_err=None):
    """The layer's output over the held ranks: the token shards joined,
    aux and z averaged, counts summed and, with ``collect_stats``, the
    stats reduced over the mesh (the fused layer shares it)."""
    aux = mesh.pmean([r.aux_loss for r in rs]) * cfg.aux_loss_coef
    z = mesh.pmean([r.z_loss for r in rs])
    counts = mesh.psum([r.expert_counts for r in rs])
    stats = None
    if cfg.collect_stats:
        local = [st.moe_stats(r, cfg, cap) for r in rs]
        stats = st.reduce_stats(mesh, local, [r.probs_mean for r in rs])
        if healthy:
            stats = hlt.attach_degradation(
                stats, healthy, [r.expert_idx for r in rs], mesh)
        wire_err = disp_err
        if comb_errs:
            comb = _max_err(comb_errs)
            wire_err = comb if wire_err is None else _max_err(
                [wire_err, comb])
        dcn_err = _max_err(dcn_errs) if dcn_errs else None
        if wire_err is not None or dcn_err is not None:
            stats = st.with_wire_error(stats, wire_err, mesh,
                                       dcn_error=dcn_err)
        if quant_err is not None and quant_err[0] is not None:
            stats = st.with_quant_error(stats, quant_err, mesh)
    return MoEOutput(mesh.join(outs), aux, z, counts, stats)


def ep_moe_layer(params, x, cfg: MoEConfig, mesh, *,
                 dcn_inner: int | None = None, skip_exchange: bool = False,
                 use_kernels: bool | None = None) -> MoEOutput:
    """Expert-parallel MoE layer.

    params: the layer's full MoE parameters (expert leaves [E, ...],
    sliced per rank by the mesh); x: the global [S, H] tokens on a local
    mesh, this process's shard on a process mesh (the output follows).
    ``dcn_inner``: ranks per slice for the two-stage exchange; None or 0
    is the flat one.  ``use_kernels`` as in
    :func:`flashmoe_tpu_torch.ops.moe.moe_layer`."""
    if dcn_inner == 0:
        dcn_inner = None
    uk = _build.use_kernels_for(x, use_kernels)
    if cfg.num_experts == 1:
        if qt.is_quantized(params):
            params = qt.ffn_compute_params(params, cfg, out_dtype=x.dtype)
        zero = torch.zeros((), dtype=cfg.accum_dtype, device=x.device)
        return MoEOutput(dense_ffn(params, x, cfg), zero, zero,
                         torch.full((1,), x.shape[0] * (
                             mesh.size if not mesh.is_local else 1),
                             dtype=torch.long, device=x.device))
    return _ep_moe_shard(mesh, mesh.shard_params(params), mesh.split(x),
                         cfg, dcn_inner=dcn_inner,
                         skip_exchange=skip_exchange, use_kernels=uk)
