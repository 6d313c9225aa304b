"""Token dispatch (permute-to-experts) and combine (weighted un-permute).

Counterpart of ``flashmoe_tpu/ops/dispatch.py:38-208``; plain torch, as
these are plain XLA ops in the JAX package.  Positions within an expert
come from one stable argsort over the k-major flattening of the expert
ids, so every k=0 assignment beats every k=1 assignment and ties go by
token index (GShard priority).  Index tensors are int64.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from flashmoe_tpu_torch.config import MoEConfig


class DispatchPlan(NamedTuple):
    """Routing geometry for one token shard.

    expert_idx: [S, K] selected expert per (token, slot).
    position:   [S, K] slot within the expert's capacity buffer.
    valid:      [S, K] bool; False when dropped (over capacity).
    counts:     [E] selections per expert (pre-drop).
    tok_sorted: [S*K] token id per expert-sorted assignment.
    """

    expert_idx: torch.Tensor
    position: torch.Tensor
    valid: torch.Tensor
    counts: torch.Tensor
    tok_sorted: torch.Tensor


def make_plan(expert_idx, cfg: MoEConfig, capacity: int) -> DispatchPlan:
    """Per-(token, k) capacity positions.  expert_idx: [S, K]."""
    s, k = expert_idx.shape
    e = cfg.num_experts
    ef = expert_idx.long().T.reshape(-1)  # k-major: index = kk*S + ss
    order = torch.argsort(ef, stable=True)
    inv = torch.argsort(order)  # rank of each assignment in the sorted run
    starts = torch.searchsorted(
        ef[order], torch.arange(e, dtype=ef.dtype, device=ef.device))
    ends = torch.cat([starts[1:], starts.new_full((1,), s * k)])
    counts = ends - starts
    pos = (inv - starts[ef]).reshape(k, s).T
    tok_sorted = order % s
    valid = pos < capacity
    return DispatchPlan(expert_idx.long(), pos, valid, counts, tok_sorted)


def dispatch_indices(plan: DispatchPlan, cfg: MoEConfig, capacity: int):
    """Source token per expert-capacity slot: ``(src_tok, present)``, both
    [E, capacity]; empty slots point at token 0."""
    s, k = plan.expert_idx.shape
    offsets = torch.cumsum(plan.counts, 0) - plan.counts
    ar = torch.arange(capacity, device=plan.counts.device)
    slot = offsets[:, None] + ar[None, :]
    present = ar[None, :] < plan.counts[:, None]
    src_tok = plan.tok_sorted[torch.clamp(slot, 0, s * k - 1)]
    src_tok = torch.where(present, src_tok, torch.zeros_like(src_tok))
    return src_tok, present


def dispatch(x, plan: DispatchPlan, cfg: MoEConfig, capacity: int):
    """Gather tokens into the capacity buffer: [S, H] -> [E, C, H];
    empty slots are zero."""
    src_tok, present = dispatch_indices(plan, cfg, capacity)
    return torch.where(present[..., None], x[src_tok],
                       torch.zeros((), dtype=x.dtype, device=x.device))


def combine(expert_out, plan: DispatchPlan, combine_weights, cfg: MoEConfig,
            capacity: int):
    """Weighted un-permute: [E, C, H] -> [S, H] f32.  Dropped slots are
    zeroed and the surviving weights renormalized."""
    e, c, h = expert_out.shape
    s, k = plan.expert_idx.shape
    flat = torch.where(plan.valid, plan.expert_idx * capacity + plan.position,
                       torch.zeros_like(plan.position)).reshape(-1)
    gathered = expert_out.reshape(e * c, h)[flat].reshape(s, k, h).float()
    gathered = torch.where(plan.valid[..., None], gathered,
                           torch.zeros((), device=gathered.device))
    w = torch.where(plan.valid, combine_weights.float(),
                    torch.zeros((), device=gathered.device))
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-20)
    return torch.einsum("skh,sk->sh", gathered, w)
