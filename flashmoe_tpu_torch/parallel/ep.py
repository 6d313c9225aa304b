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
multi-slice world (``dcn_inner`` ranks per slice, by default the
bootstrapped runtime's: ``flashmoe_tpu/parallel/ep.py:91-195, 458-480``):
on a local mesh both stages are permutations of the rank axes, on a
process mesh ``all_to_all_single`` calls within the inner and outer
groups.  Either leg may compress its payload to a wire dtype
(:mod:`flashmoe_tpu_torch.ops.wire`), and the cross-slice hop may take
its own (``wire_dtype_dcn``).  With
``a2a_chunks = n`` the slabs split into n chunks of local experts, each
its own dispatch -> FFN -> return chain.  ``skip_exchange`` elides both
exchanges (the compute-only leg of an overlap measurement; tokens then
meet the wrong experts).  The phases run under JAX's span names
(``moe.gate``, ``moe.dispatch``, ``moe.a2a_dispatch[.k]``,
``moe.expert[.k]``, ``moe.a2a_combine[.k]``, ``moe.combine``), each
fenced under ``cfg.profile_phases`` for the phase profiler.

The per-rank arithmetic is written once, over the ranks this process
holds: every stage is a list over them, and the ranks meet only in the
mesh's all-to-all and reductions.  The tokens shard over the layer's
``token_axes`` (``("ep",)`` by default; ``("dp", "ep", "sp")`` in a
data- and sequence-parallel model): each ep fibre of the mesh exchanges
among its own ranks, and the losses, counts and stats reduce over every
token axis.  Quantized expert storage enters
through the boundary hook on each rank's shard
(``flashmoe_tpu/parallel/ep.py:220-235``): payloads dequantize to the
compute dtype, full-precision weights fake-quantize, and with the knob
off a quantized store is refused.

With ``tp`` (on a local mesh of ep x tp ranks) each expert's
intermediate dimension is Megatron-split over the tp ranks
(``flashmoe_tpu/parallel/ep.py:198-290``): the mesh hands each rank its
column-parallel slice of ``w_up``/``w_gate``/``b_up`` and row-parallel
slice of ``w_down`` (one contiguous copy each for the call), each tp rank
adds ``b_down / tp``, and the FFN's output is summed over the tp group
after every FFN call (the serial slab, or each ``a2a_chunks`` chunk).
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
from flashmoe_tpu_torch.profiler import spans as prof
from flashmoe_tpu_torch.utils.telemetry import trace_span

_FFN_KEYS = ("w_up", "w_gate", "b_up", "w_down", "b_down")

#: the layer's reductions over its token axes (aux and z means, the
#: counts' sum: :func:`layer_output`), JAX's ``EXPECTED_PSUMS``
EXPECTED_PSUMS = 3


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
    rank.  On a tp mesh the params are each rank's tp slice and the FFN's
    partial outputs are summed over each tp group.  Returns the held
    ranks' outputs joined, and the losses, counts and stats reduced over
    the mesh's token axes."""
    d = mesh.ep
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
    # row-parallel down bias: each tp rank adds 1/tp of it, so that the
    # tp sum holds it exactly once
    ffn_params = ([dict(p, b_down=p["b_down"] / mesh.tp) for p in params]
                  if mesh.tp > 1 else params)
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

    # phase spans (gate, dispatch, each exchange leg, the expert FFN,
    # combine; a chunked pipeline's as name.k); with cfg.profile_phases
    # each phase also fences its result for the phase profiler
    with trace_span("moe.gate"):
        rs = [router(x, p["gate_w"], cfg, use_kernels=use_kernels)
              for x, p in zip(xs, params)]
        if cfg.profile_phases:
            prof.fence(rs)
    with trace_span("moe.dispatch"):
        plans = [dsp.make_plan(r.expert_idx, cfg, cap) for r in rs]
        sends = [dsp.dispatch(x.to(cfg.dtype), plan, cfg, cap)
                 .reshape(d, nlx, cap, h) for x, plan in zip(xs, plans)]
        if cfg.profile_phases:
            prof.fence(sends)

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

    def span(base, ck):
        return trace_span(base if n_chunks == 1 else f"{base}.{ck}")

    nc = nlx // n_chunks
    ybacks = []
    for ck in range(n_chunks):
        lo = ck * nc
        with span("moe.a2a_dispatch", ck):
            recv = exchange([s[:, lo:lo + nc] for s in sends], wire_disp,
                            False)
            if cfg.profile_phases:
                prof.fence(recv)
        with span("moe.expert", ck):
            ys = []
            for rv, p in zip(recv, ffn_params):
                p_k = {k: (v[lo:lo + nc] if k in _FFN_KEYS else v)
                       for k, v in p.items()}
                buf = rv.transpose(0, 1).reshape(nc, d * cap, h)
                ys.append(exp.capacity_buffer_ffn_ad(
                    buf, p_k, cfg, use_kernels=use_kernels))
            ys = mesh.tp_psum(ys)
            if cfg.profile_phases:
                prof.fence(ys)
        with span("moe.a2a_combine", ck):
            ysend = [y.reshape(nc, d, cap, h).transpose(0, 1) for y in ys]
            for errs, wd in ((comb_errs, wire_comb), (dcn_errs, wire_dcn)):
                err = stat_err(ysend, wd)
                if err is not None:
                    errs.append(err)
            yback = exchange(ysend, wire_comb, True)
            if cfg.profile_phases:
                prof.fence(yback)
        ybacks.append(yback)
    ybufs = [torch.cat([yb[i] for yb in ybacks], 1).reshape(e, cap, h)
             for i in range(len(xs))]

    outs, healthy = [], []
    with trace_span("moe.combine"):
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
        if cfg.profile_phases:
            prof.fence(outs)
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
                 token_axes: tuple[str, ...] = ("ep",),
                 dcn_inner: int | None = None, skip_exchange: bool = False,
                 use_kernels: bool | None = None) -> MoEOutput:
    """Expert-parallel MoE layer.

    params: the layer's full MoE parameters (expert leaves [E, ...],
    sliced per rank by the mesh); x: the global [S, H] tokens on a local
    mesh, this process's shard on a process mesh (the output follows).
    ``token_axes``: the mesh axes the tokens shard over jointly, in that
    order (``("dp", "ep", "sp")`` in a data- and sequence-parallel
    model, JAX's ``P(token_axes, None)``); the exchange runs within each
    ep fibre, and aux, z, counts and stats reduce over all of them.
    ``dcn_inner``: ranks per slice for the two-stage exchange; None reads
    the bootstrapped runtime's blocking of this mesh
    (:func:`~flashmoe_tpu_torch.runtime.bootstrap.current_dcn_inner`:
    None without one), 0 forces the flat exchange.  On a mesh with a tp
    axis each expert is
    Megatron-split over the tp ranks.  ``use_kernels`` as in
    :func:`flashmoe_tpu_torch.ops.moe.moe_layer`."""
    if dcn_inner is None:
        from flashmoe_tpu_torch.runtime.bootstrap import current_dcn_inner

        dcn_inner = current_dcn_inner(mesh, mesh.ep)
    elif dcn_inner == 0:
        dcn_inner = None
    uk = _build.use_kernels_for(x, use_kernels)
    mesh = mesh.over(token_axes)
    if cfg.num_experts == 1:
        if qt.is_quantized(params):
            params = qt.ffn_compute_params(params, cfg, out_dtype=x.dtype)
        zero = torch.zeros((), dtype=cfg.accum_dtype, device=x.device)
        return MoEOutput(dense_ffn(params, x, cfg), zero, zero,
                         torch.full((1,), x.shape[0] * (
                             mesh.ep if not mesh.is_local else 1),
                             dtype=torch.long, device=x.device))
    return _ep_moe_shard(mesh, mesh.shard_params(params), mesh.split(x),
                         cfg, dcn_inner=dcn_inner,
                         skip_exchange=skip_exchange, use_kernels=uk)


# ----------------------------------------------------------------------
# moe_backend='auto' (``flashmoe_tpu/parallel/ep.py:526-606``)
# ----------------------------------------------------------------------

def resolve_moe_backend(cfg: MoEConfig, mesh=None) -> str:
    """The concrete moe_backend this layer stack runs: explicit configs
    pass through, ``'auto'`` asks the planner
    (:func:`flashmoe_tpu_torch.planner.select.resolve_moe_backend`)."""
    from flashmoe_tpu_torch.planner.select import (
        resolve_moe_backend as _resolve)

    return _resolve(cfg, mesh)


def resolve_moe_plan(cfg: MoEConfig, mesh=None, *, mode: str | None = None,
                     decode_tokens: int | None = None
                     ) -> tuple[str, int | None]:
    """(moe_backend, a2a_chunks) an ``'auto'`` config runs: the planner's
    winner and its chunked-pipeline pick (None = serial); explicit
    configs pass through with their own ``a2a_chunks``."""
    from flashmoe_tpu_torch.planner.select import (
        resolve_moe_plan as _resolve)

    return _resolve(cfg, mesh, mode=mode, decode_tokens=decode_tokens)


def apply_chunk_pick(cfg: MoEConfig, backend: str,
                     chunks: int | None) -> MoEConfig:
    """The planner's chunk pick threaded into a layer config: only onto
    an unset ``a2a_chunks`` of an exchange layer whose local-expert axis
    it divides; anything else passes through."""
    if (chunks and chunks > 1 and cfg.a2a_chunks is None
            and backend in ("collective", "ragged")
            and cfg.num_experts // max(cfg.ep, 1) % chunks == 0):
        return cfg.replace(a2a_chunks=chunks)
    return cfg


def auto_ep_moe_layer(params, x, cfg: MoEConfig, mesh, *,
                      token_axes: tuple[str, ...] = ("ep",),
                      use_kernels: bool | None = None) -> MoEOutput:
    """The expert-parallel layer on the planner's transport (collective,
    ragged or fused) and chunk pick.  A specialized transport that raises
    is reported (:func:`flashmoe_tpu_torch.planner.select.
    report_path_failure`: a ``planner.fallback`` decision, and the
    backend demoted for the rest of the process) and the collective
    layer runs in its place, as JAX's layer demotes it; the record is
    what keeps a failed transport from passing unseen."""
    backend, chunks = resolve_moe_plan(cfg, mesh)
    cfg = apply_chunk_pick(cfg, backend, chunks)
    try:
        if backend == "fused":
            from flashmoe_tpu_torch.parallel.fused import fused_ep_moe_layer

            return fused_ep_moe_layer(params, x, cfg, mesh,
                                      token_axes=token_axes,
                                      use_kernels=use_kernels)
        if backend == "ragged":
            from flashmoe_tpu_torch.parallel.ragged_ep import (
                ragged_ep_moe_layer)

            return ragged_ep_moe_layer(params, x, cfg, mesh,
                                       token_axes=token_axes,
                                       use_kernels=use_kernels)
    except Exception as e:  # noqa: BLE001 - the transport's fallback
        from flashmoe_tpu_torch.planner.select import report_path_failure

        report_path_failure(backend, f"{type(e).__name__}: {e}")
    return ep_moe_layer(params, x, cfg, mesh, token_axes=token_axes,
                        use_kernels=use_kernels)
