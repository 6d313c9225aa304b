"""MoE routing statistics: the flight recorder's data, from the router.

Counterpart of ``flashmoe_tpu/ops/stats.py`` for one device: every field
is a pure function of the router's outputs and the capacity the dispatch
clamps against, computed only when ``MoEConfig.collect_stats`` is set, so
attaching them cannot move the layer's numbers.  The JAX package's
cross-rank ``reduce_stats`` and its wire and quantization error fields'
fillers (``with_wire_error``, ``with_quant_error``) wait for the
expert-parallel and quantization slices; those fields stay zero here, as
they are in JAX with their features off.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from flashmoe_tpu_torch.config import MoEConfig


class MoEStats(NamedTuple):
    """One MoE layer's routing health, every field f32 (the JAX fields).

    expert_load:          [E] pre-drop (token, k) selections per expert.
    dropped_fraction:     [] share of assignments dropped at the capacity
                          clamp (0 on the dropless arm).
    capacity_utilization: [] kept rows / (E * capacity) (1 on the dropless
                          arm).
    imbalance:            [] max over experts / mean of the load.
    router_entropy:       [] entropy (nats) of the mean softmax
                          probabilities, or of the load when the gate
                          reports none (the two-pass gate without pass 2).
    topk_confidence:      [] mean normalized weight of each token's top-1.
    masked_experts:       [] experts masked by tier-0 degradation.
    masked_fraction:      [] share of assignments whose contribution the
                          tier-0 mask zeroed.
    wire_rtq_error, wire_rtq_error_dcn, quant_error: [] 0 (no wire
                          compression or quantized weights in the port).
    """

    expert_load: torch.Tensor
    dropped_fraction: torch.Tensor
    capacity_utilization: torch.Tensor
    imbalance: torch.Tensor
    router_entropy: torch.Tensor
    topk_confidence: torch.Tensor
    masked_experts: torch.Tensor
    masked_fraction: torch.Tensor
    wire_rtq_error: torch.Tensor
    wire_rtq_error_dcn: torch.Tensor
    quant_error: torch.Tensor


def load_imbalance(expert_load) -> torch.Tensor:
    """max / mean of an [E] load vector (f32 scalar)."""
    load = expert_load.float()
    return load.max(-1).values / torch.clamp(load.mean(-1), min=1e-9)


def dist_entropy(weights) -> torch.Tensor:
    """Entropy (nats) of an unnormalized nonnegative [E] weight vector."""
    w = weights.float()
    p = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    return -torch.where(p > 0, p * torch.log(torch.clamp(p, min=1e-30)),
                        torch.zeros_like(p)).sum(-1)


def router_entropy(probs_mean, expert_load) -> torch.Tensor:
    """Entropy of the router's expert distribution: its mean softmax
    probabilities, or the selection distribution where those are all
    zero (the two-pass gate's inference mode skips them)."""
    have_probs = probs_mean.float().sum(-1) > 0
    return torch.where(have_probs, dist_entropy(probs_mean),
                       dist_entropy(expert_load))


def drop_stats(expert_load, cfg: MoEConfig, capacity: int | None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dropped_fraction, capacity_utilization) of an [E] load against a
    per-expert ``capacity``; ``None`` is the dropless arm."""
    load = expert_load.float()
    total = torch.clamp(load.sum(-1), min=1.0)
    if capacity is None:
        return torch.zeros_like(total), torch.ones_like(total)
    kept = torch.minimum(load, torch.tensor(float(capacity),
                                            device=load.device)).sum(-1)
    return 1.0 - kept / total, kept / float(cfg.num_experts * capacity)


def moe_stats(router_out, cfg: MoEConfig, capacity: int | None) -> MoEStats:
    """Stats of one token shard from its RouterOutput; ``capacity`` is the
    one the dispatch plan clamps against, ``None`` on the dropless arm."""
    load = router_out.expert_counts.float()
    dropped, util = drop_stats(load, cfg, capacity)
    # slot 0 of the sorted top-k is each token's strongest expert
    conf = router_out.combine_weights[..., 0].float().mean(-1)
    zero = torch.zeros_like(dropped)
    return MoEStats(
        expert_load=load, dropped_fraction=dropped,
        capacity_utilization=util, imbalance=load_imbalance(load),
        router_entropy=router_entropy(router_out.probs_mean, load),
        topk_confidence=conf, masked_experts=zero, masked_fraction=zero,
        wire_rtq_error=zero, wire_rtq_error_dcn=zero, quant_error=zero)


def with_degradation(stats: MoEStats, masked_experts,
                     masked_fraction) -> MoEStats:
    """Attach the tier-0 degradation counters (``ops/health.py``)."""
    return stats._replace(
        masked_experts=torch.as_tensor(masked_experts).float(),
        masked_fraction=torch.as_tensor(masked_fraction).float())


def stats_to_host(stats: MoEStats) -> dict:
    """One flight-recorder dict (python floats and lists) of a layer's
    stats, through one device-to-host copy of the whole tuple."""
    host = MoEStats(*torch.cat([t.detach().float().reshape(-1)
                                for t in stats]).cpu().split(
        [t.numel() for t in stats]))
    out = {name: float(v) for name, v in zip(MoEStats._fields, host)
           if name != "expert_load"}
    return {"expert_load": host.expert_load.double().tolist(), **out}
