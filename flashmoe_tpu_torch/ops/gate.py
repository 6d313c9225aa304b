"""MoE gate (router): GEMM + softmax + top-k + routing statistics.

Counterpart of ``flashmoe_tpu/ops/gate.py``.  Two implementations of one
function:

* :func:`router_plain`, plain torch, the counterpart of ``router_xla``
  (the oracle, and what a CPU tensor gets);
* :func:`router_cuda`, the hand-written Hopper kernel in
  ``csrc/gate.cu``, the port of ``_gate_kernel`` (the single-tile gate).

The JAX package's two-pass expert-tiled gate (``_gate_pass1_kernel`` /
``_gate_pass2_kernel``) is not ported yet: E above 256 raises on CUDA.

:func:`router` reaches the kernel through a ``torch.autograd.Function``
(the counterpart of ``_router_pallas_ad``): its backward recomputes
:func:`router_plain` under autograd and back-propagates the cotangents
through it, as the kernel has no backward of its own.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from flashmoe_tpu_torch.config import MoEConfig
from flashmoe_tpu_torch.kernels import _build
from flashmoe_tpu_torch.models.reference import dot_f32, top_k_lowest_index

#: limits of the single-pass gate kernel (csrc/gate.cu GEMAX, GKMAX)
GATE_MAX_EXPERTS = 256
GATE_MAX_TOP_K = 32


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
    """Router in plain torch (``router_xla``). x: [S, H], gate_w: [H, E]."""
    logits = dot_f32(x, gate_w)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_idx = top_k_lowest_index(probs, cfg.expert_top_k)
    counts = torch.bincount(top_idx.reshape(-1),
                            minlength=cfg.num_experts)
    zsum = torch.sum(torch.square(torch.logsumexp(logits, dim=-1)))
    return _finish(cfg, top_p, top_idx, probs.sum(0), counts, zsum,
                   x.shape[0])


def router_cuda(x, gate_w, cfg: MoEConfig) -> RouterOutput:
    """The gate kernel (``csrc/gate.cu``) on CUDA tensors.

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
        raise NotImplementedError(
            f"E={e}, K={k}: the single-pass gate kernel takes E <= "
            f"{GATE_MAX_EXPERTS}, K <= {GATE_MAX_TOP_K}; larger E waits for "
            f"the two-pass gate kernels (ROADMAP B.4)")
    if h % 32 or s < 1:
        raise ValueError(f"router_cuda needs S >= 1 and H % 32 == 0, got "
                         f"S={s}, H={h}")
    _build.refuse_autograd("router_cuda", x, gate_w)
    dt = x.dtype if x.dtype == gate_w.dtype else torch.float32
    x = x.to(dt).contiguous()
    gate_w = gate_w.to(dt).contiguous()
    _build.require_cuda("router_cuda", x, gate_w)
    dev = x.device
    nb = (s + 15) // 16
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    top_p = torch.empty((s, k), **f32)
    top_i = torch.empty((s, k), **i32)
    part_p = torch.empty((nb, e), **f32)
    part_c = torch.empty((nb, e), **i32)
    part_z = torch.empty((nb,), **f32)
    probs_sum = torch.empty((e,), **f32)
    counts = torch.empty((e,), **i32)
    zsum = torch.empty((), **f32)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.fm_gate(
            int(dt == torch.bfloat16), x.data_ptr(), gate_w.data_ptr(), s, h,
            e, k, top_p.data_ptr(), top_i.data_ptr(), part_p.data_ptr(),
            part_c.data_ptr(), part_z.data_ptr(), probs_sum.data_ptr(),
            counts.data_ptr(), zsum.data_ptr(), _build.stream_of(x))
    _build.check(err, "fm_gate")
    router_cuda.launches += 1
    return _finish(cfg, top_p, top_i, probs_sum, counts, zsum, s)


router_cuda.launches = 0


def apply_replicas(out: RouterOutput, cfg: MoEConfig) -> RouterOutput:
    """Hot-expert replica routing.  The port's config carries no replica
    map yet (ROADMAP A.3), so this is the identity, as the JAX function
    is with its map empty."""
    return out


class _RouterAD(torch.autograd.Function):
    """Forward: the gate kernel.  Backward: :func:`router_plain` recomputed
    under autograd on the saved inputs, the cotangents pulled back through
    it.  The ids and counts are integers and carry no gradient."""

    @staticmethod
    def forward(ctx, x, gate_w, cfg):
        out = router_cuda(x, gate_w, cfg)
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
        return dx, dw, None


def router(x, gate_w, cfg: MoEConfig, use_kernels: bool | None = None
           ) -> RouterOutput:
    """The gate kernel on CUDA tensors, differentiable through
    ``_RouterAD``; the plain version on CPU ones (or when
    ``use_kernels=False``)."""
    if _build.use_kernels_for(x, use_kernels):
        out = RouterOutput(*_RouterAD.apply(x, gate_w, cfg))
    else:
        out = router_plain(x, gate_w, cfg)
    return apply_replicas(out, cfg)
