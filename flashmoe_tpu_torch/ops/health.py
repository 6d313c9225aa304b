"""Tier-0 fault tolerance: expert-health masking inside the MoE layer.

Counterpart of ``flashmoe_tpu/ops/health.py``: an expert whose FFN output
holds a non-finite value is masked: its contribution is zeroed and each
affected token's surviving gate weights are renormalized, so one sick
expert degrades its tokens instead of poisoning the step.  Plain
``torch.where`` arithmetic, differentiable, run only when
``MoEConfig.degrade_unhealthy_experts`` is set.  On an expert-parallel
mesh each rank masks its own tokens' exposure, and the counters reduce
over the mesh (:func:`attach_degradation`).
"""

from __future__ import annotations

import torch

from flashmoe_tpu_torch.ops.stats import with_degradation


def expert_health_capacity(ybuf) -> torch.Tensor:
    """[E] bool health of a capacity-layout output [E, C, H]: an expert is
    sick when any of its rows holds a non-finite value.  Empty slots hold
    finite values (zeros, or an FFN of a real token), so they never flag
    a healthy expert."""
    return torch.isfinite(ybuf.float()).flatten(1).all(-1)


def expert_health_tiles(y_rows, tile_gid, num_experts: int,
                        block_m: int) -> torch.Tensor:
    """[E] bool health of a row-grouped output [T, H] whose row tiles map
    to experts through ``tile_gid`` [T // block_m]: an expert is sick when
    any of its tiles holds a non-finite value.  Tail tiles past the
    populated rows hold zeros, which never flag their (clamped) expert."""
    t = y_rows.shape[0] // block_m
    tile_ok = torch.isfinite(y_rows.float()).reshape(t, -1).all(-1)
    healthy = torch.ones((num_experts,), dtype=torch.int32,
                         device=y_rows.device)
    healthy = healthy.scatter_reduce(0, tile_gid.long(), tile_ok.int(),
                                     reduce="amin")
    return healthy.bool()


def expert_health_segments(y_rows, counts) -> torch.Tensor:
    """[E] bool health of an expert-sorted buffer [N, H] whose expert e
    owns the ``counts[e]`` rows after those of experts < e; rows past the
    populated total are padding and clamp onto the last expert."""
    n = y_rows.shape[0]
    ends = torch.cumsum(counts.long(), 0)
    row_gid = torch.clamp(torch.searchsorted(
        ends, torch.arange(n, device=y_rows.device), right=True),
        0, counts.shape[0] - 1)
    row_ok = torch.isfinite(y_rows.float()).all(-1)
    healthy = torch.ones((counts.shape[0],), dtype=torch.int32,
                         device=y_rows.device)
    healthy = healthy.scatter_reduce(0, row_gid, row_ok.int(), reduce="amin")
    return healthy.bool()


def sanitize(y):
    """Non-finite values to 0: needed before any weighted combine of
    masked outputs, since 0 * nan is nan."""
    return torch.where(torch.isfinite(y.float()), y, torch.zeros_like(y))


def mask_combine_weights(combine_weights, expert_idx, healthy, *,
                         renormalize: bool = False):
    """Zero each (token, k) weight whose expert is sick.  With
    ``renormalize`` the survivors are rescaled to each token's original
    total (for combines that do not renormalize themselves, such as
    ``ragged_combine``); with every expert healthy the ratio is x / x =
    1.0 exactly, so the healthy path is unchanged bit for bit.  A token
    with no healthy expert keeps all-zero weights."""
    keep = healthy[expert_idx]
    w = torch.where(keep, combine_weights, torch.zeros_like(combine_weights))
    if renormalize:
        total = combine_weights.float().sum(-1, keepdim=True)
        kept = w.float().sum(-1, keepdim=True)
        ratio = total / torch.clamp(kept, min=1e-20)
        w = (w.float() * ratio).to(combine_weights.dtype)
    return w


def degradation_stats(healthy, expert_idx):
    """(masked_experts, masked_fraction) f32 scalars: the sick experts,
    and the share of (token, k) assignments whose contribution was
    zeroed."""
    masked_experts = (~healthy).float().sum()
    return masked_experts, (~healthy[expert_idx]).float().mean()


def degrade_outputs(ybuf, combine_weights, expert_idx, healthy, *,
                    renormalize: bool = False):
    """The tier-0 masking every layer applies: sanitized expert outputs
    and the sick experts' combine weights zeroed (``renormalize`` as in
    :func:`mask_combine_weights`).  Returns (ybuf', combine_weights')."""
    return (sanitize(ybuf),
            mask_combine_weights(combine_weights, expert_idx, healthy,
                                 renormalize=renormalize))


def attach_degradation(stats, healthy, expert_idx, mesh=None):
    """Fold this layer's degradation counters into its MoEStats.  With a
    ``mesh``, ``healthy`` and ``expert_idx`` are lists over the held ranks:
    the masked-expert count sums over the ranks and the assignment share
    averages, as the JAX package's psum / pmean over ``reduce_axes``."""
    if mesh is None:
        return with_degradation(stats,
                                *degradation_stats(healthy, expert_idx))
    per = [degradation_stats(h, i) for h, i in zip(healthy, expert_idx)]
    return with_degradation(stats, mesh.psum([me for me, _ in per]),
                            mesh.pmean([mf for _, mf in per]))
