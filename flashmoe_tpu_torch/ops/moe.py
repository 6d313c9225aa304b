"""Single-device MoE layer: gate -> dispatch -> grouped FFN -> combine.

Counterpart of ``flashmoe_tpu/ops/moe.py:35-209``.  Two arms, as the JAX
layer has with ``use_pallas=True``:

* dropless (``drop_tokens=False``): the ragged
  expert-sorted grouping, the grouped FFN over it, and a gather combine;
* capacity: the [E, C, H] dispatch buffer, the grouped FFN over it, and a
  renormalizing combine that zeroes dropped slots.

At inference with ``gather_fused`` (or ``FLASHMOE_GATHER_FUSED=1``) both
arms skip the dispatch buffer: the gather-fused FFN reads each row from
the tokens through the plan's map (``ops/expert.py``).  With
``collect_stats`` the output carries the layer's :class:`MoEStats`, and
with ``degrade_unhealthy_experts`` a non-finite expert's contribution is
masked before the combine (``ops/health.py``).  An armed ``nan_expert``
chaos point poisons the capacity arm's expert outputs before that mask
(``flashmoe_tpu/ops/moe.py:158-161``).

Quantized expert storage (``cfg.expert_quant``, :mod:`flashmoe_tpu_torch.
quant`) enters at the layer boundary, as ``flashmoe_tpu/ops/moe.py:77-90``:
stored payloads dequantize to the compute dtype, full-precision weights
are fake-quantized, and with the knob off a quantized dict is refused;
the kernels then see ordinary compute-dtype weights.  With
``collect_stats`` on fake-quantized weights the stats carry their
round-trip error.

E == 1 takes the dense FFN.  Its full-precision weights stay unquantized
there, as in JAX; a stored quantized dense layer dequantizes (refused
with the knob off), where JAX's ``dense_ffn`` would cast raw payloads.
The gate and the grouped FFN run their CUDA
kernels on CUDA tensors and their plain versions on CPU tensors.  Both
arms are differentiable: the gate through its recompute backward
(``ops/gate.py``), the grouped FFN through :func:`grouped_ffn_ad` /
:func:`capacity_buffer_ffn_ad` (residual-saving forward, grouped-matmul
backward) or, on the gather-fused path, through its re-gathering
backward, and the plans, gathers and combines through torch autograd.
"""

from __future__ import annotations

import os
from typing import Any, NamedTuple

import torch

from flashmoe_tpu_torch import quant as qt
from flashmoe_tpu_torch.chaos import inject as chaos_inject
from flashmoe_tpu_torch.config import MoEConfig
from flashmoe_tpu_torch.kernels import _build
from flashmoe_tpu_torch.models.reference import (activation_fn, dot_f32,
                                                 shared_expert_ffn)
from flashmoe_tpu_torch.ops import dispatch as dsp
from flashmoe_tpu_torch.ops import expert as exp
from flashmoe_tpu_torch.ops import health as hlt
from flashmoe_tpu_torch.ops import ragged as rag
from flashmoe_tpu_torch.ops.gate import router
from flashmoe_tpu_torch.ops.stats import moe_stats, with_quant_error


def _gather_fused(cfg: MoEConfig) -> bool:
    """Whether inference takes the gather-fused FFN: the config field, or
    when it is None, ``FLASHMOE_GATHER_FUSED=1`` (``ops/moe.py:35-43``)."""
    if cfg.gather_fused is not None:
        return cfg.gather_fused
    return os.environ.get("FLASHMOE_GATHER_FUSED") == "1"


class MoEOutput(NamedTuple):
    out: torch.Tensor  # [S, H]
    aux_loss: torch.Tensor
    z_loss: torch.Tensor
    expert_counts: torch.Tensor  # [E]
    stats: Any = None  # MoEStats with cfg.collect_stats, else None


def dense_ffn(params, x, cfg: MoEConfig):
    """E == 1 dense FFN (plain torch, as the JAX package's XLA dots)."""
    act = activation_fn(cfg.hidden_act)
    dt = x.dtype
    up = dot_f32(x, params["w_up"][0].to(dt)) + params["b_up"][0].float()
    if cfg.gated_ffn:
        hidden = act(dot_f32(x, params["w_gate"][0].to(dt))) * up
    else:
        hidden = act(up)
    down = dot_f32(hidden.to(dt), params["w_down"][0].to(dt)) \
        + params["b_down"][0].float()
    return down.to(dt)


def moe_layer(params, x, cfg: MoEConfig, *, use_kernels: bool | None = None
              ) -> MoEOutput:
    """One MoE layer over a token shard x: [S, H].

    ``use_kernels``: ``None`` runs the CUDA kernels when x is on CUDA and
    the plain versions when it is on the CPU; ``False`` runs the plain
    versions anywhere; ``True`` with a CPU tensor raises."""
    uk = _build.use_kernels_for(x, use_kernels)
    if cfg.num_experts == 1:
        zero = torch.zeros((), dtype=cfg.accum_dtype, device=x.device)
        counts = torch.full((1,), x.shape[0], dtype=torch.long,
                            device=x.device)
        if qt.is_quantized(params):
            params = qt.ffn_compute_params(params, cfg, out_dtype=x.dtype)
        return MoEOutput(dense_ffn(params, x, cfg), zero, zero, counts)

    qerr = (qt.weight_quant_error(params, cfg)
            if cfg.expert_quant is not None and cfg.collect_stats else None)
    # every consumer below casts the expert weights to cfg.dtype
    params = qt.ffn_compute_params(params, cfg, out_dtype=cfg.dtype)
    r = router(x, params["gate_w"], cfg, use_kernels=uk)
    dt = cfg.dtype
    xs = x.to(dt)
    gather = not cfg.is_training and _gather_fused(cfg)
    stats = None
    if cfg.collect_stats:
        stats = moe_stats(r, cfg, None if not cfg.drop_tokens
                          else cfg.capacity_for(x.shape[0]))
    combine_w = r.combine_weights
    ffn = dict(act_name=cfg.hidden_act, gated=cfg.gated_ffn, use_kernels=uk)
    if not cfg.drop_tokens:
        bm = exp.ROW_TILE
        plan = rag.make_ragged_plan(r.expert_idx, cfg, bm)
        tail = (params["w_up"].to(dt), params["b_up"],
                params["w_down"].to(dt), params["b_down"],
                params["w_gate"].to(dt) if cfg.gated_ffn else None)
        if gather:
            ybuf = exp.grouped_ffn_tokens_ad(
                xs, plan.src_tok, plan.tile_gid, *tail, block_m=bm,
                num_rows=plan.num_rows, **ffn)
        else:
            xbuf = rag.ragged_dispatch(xs, plan, cfg, bm)
            ybuf = exp.grouped_ffn_ad(xbuf, plan.tile_gid, *tail, block_m=bm,
                                      num_rows=plan.num_rows, **ffn)
        if cfg.degrade_unhealthy_experts:
            # ragged_combine does not renormalize: the mask does
            healthy = hlt.expert_health_tiles(ybuf, plan.tile_gid,
                                              cfg.num_experts, bm)
            ybuf, combine_w = hlt.degrade_outputs(
                ybuf, combine_w, r.expert_idx, healthy, renormalize=True)
        out = rag.ragged_combine(ybuf, plan, combine_w, cfg)
    else:
        # capacity from this call's token count, not the config's nominal
        # sequence length
        cap = cfg.capacity_for(x.shape[0])
        plan = dsp.make_plan(r.expert_idx, cfg, cap)
        if gather:
            ybuf, cap = exp.capacity_ffn_gather(xs, plan, cfg, cap, params,
                                                use_kernels=uk)
        else:
            xbuf = dsp.dispatch(xs, plan, cfg, cap)
            ybuf = exp.capacity_buffer_ffn_ad(xbuf, params, cfg,
                                              use_kernels=uk)
        if chaos_inject.is_armed("nan_expert"):
            ybuf = chaos_inject.poison_expert(ybuf)
        if cfg.degrade_unhealthy_experts:
            # dsp.combine renormalizes the surviving weights itself
            healthy = hlt.expert_health_capacity(ybuf)
            ybuf, combine_w = hlt.degrade_outputs(ybuf, combine_w,
                                                  r.expert_idx, healthy)
        out = dsp.combine(ybuf, plan, combine_w, cfg, cap)
    if cfg.degrade_unhealthy_experts and stats is not None:
        stats = hlt.attach_degradation(stats, healthy, r.expert_idx)
    if qerr is not None and stats is not None:
        stats = with_quant_error(stats, qerr)
    if cfg.num_shared_experts:
        out = out + shared_expert_ffn(xs, params, cfg)
    return MoEOutput(out.to(dt), r.aux_loss * cfg.aux_loss_coef, r.z_loss,
                     r.expert_counts, stats)
