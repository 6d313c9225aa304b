"""MoE routing statistics: the flight recorder's data, from the router.

Counterpart of ``flashmoe_tpu/ops/stats.py``: every field is a pure
function of the router's outputs and the capacity the dispatch clamps
against, computed only when ``MoEConfig.collect_stats`` is set, so
attaching them cannot move the layer's numbers.  Across the ranks of an
expert-parallel mesh (:mod:`flashmoe_tpu_torch.parallel.mesh`),
:func:`reduce_stats`, :func:`with_wire_error` and
:func:`with_quant_error` reduce per-rank values over the mesh, as the JAX
package's reduce over the shard_map axes.
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
    wire_rtq_error:       [] mean relative round-trip error of the
                          exchange's wire dtype (0 with the wire off).
    wire_rtq_error_dcn:   [] the same for the cross-slice hop's wire.
    quant_error:          [] round-trip error of the expert weights under
                          ``expert_quant`` (fake quantization; 0 with
                          quant off or a pre-quantized store).
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


def reduce_stats(mesh, local: list, probs_mean: list) -> MoEStats:
    """Reduction over the mesh's ranks of per-rank stats (one MoEStats and
    one probs_mean per held rank): the load histogram sums, the ratio
    scalars average (every rank holds the same token count), imbalance
    and entropy are recomputed from the global load.  The degradation and
    wire fields pass through from the first held rank: the layer reduces
    them itself when their feature is on."""
    g_load = mesh.psum([s.expert_load for s in local])
    g_probs = mesh.pmean([p.float() for p in probs_mean])
    first = local[0]
    return MoEStats(
        expert_load=g_load,
        dropped_fraction=mesh.pmean([s.dropped_fraction for s in local]),
        capacity_utilization=mesh.pmean(
            [s.capacity_utilization for s in local]),
        imbalance=load_imbalance(g_load),
        router_entropy=router_entropy(g_probs, g_load),
        topk_confidence=mesh.pmean([s.topk_confidence for s in local]),
        masked_experts=first.masked_experts,
        masked_fraction=first.masked_fraction,
        wire_rtq_error=first.wire_rtq_error,
        wire_rtq_error_dcn=first.wire_rtq_error_dcn,
        quant_error=first.quant_error)


def with_wire_error(stats: MoEStats, wire_rtq_error=None, mesh=None, *,
                    dcn_error=None) -> MoEStats:
    """Attach the wire's round-trip error (``ops/wire.py``).  With a
    ``mesh`` each value is a list of per-rank proxies, averaged over the
    ranks; ``None`` leaves its field untouched."""
    def red(v):
        return (mesh.pmean([t.float() for t in v]) if mesh is not None
                else torch.as_tensor(v).float())

    fields = {}
    if wire_rtq_error is not None:
        fields["wire_rtq_error"] = red(wire_rtq_error)
    if dcn_error is not None:
        fields["wire_rtq_error_dcn"] = red(dcn_error)
    return stats._replace(**fields) if fields else stats


def with_quant_error(stats: MoEStats, quant_error, mesh=None) -> MoEStats:
    """Attach the quantized weights' round-trip error
    (:func:`flashmoe_tpu_torch.quant.state.weight_quant_error`).  With a
    ``mesh`` it is a list of per-rank errors (each rank measures its own
    expert shard), averaged over the ranks; ``None`` leaves the stats
    untouched."""
    if quant_error is None:
        return stats
    v = (mesh.pmean([t.float() for t in quant_error]) if mesh is not None
         else torch.as_tensor(quant_error).float())
    return stats._replace(quant_error=v)


def stats_to_host(stats: MoEStats) -> dict:
    """One flight-recorder dict (python floats and lists) of a layer's
    stats, through one device-to-host copy of the whole tuple."""
    host = MoEStats(*torch.cat([t.detach().float().reshape(-1)
                                for t in stats]).cpu().split(
        [t.numel() for t in stats]))
    out = {name: float(v) for name, v in zip(MoEStats._fields, host)
           if name != "expert_load"}
    return {"expert_load": host.expert_load.double().tolist(), **out}


def speculation_summary(records) -> dict:
    """Aggregate speculative-decoding acceptance stats from flight records.

    Counterpart of ``flashmoe_tpu/ops/stats.py:281``, the host-side
    consumer twin of ``serving.speculate.spec_stats_fields``:
    the engine folds per-slot counters into ``serve_request`` records and
    per-step ``spec_tokens``/``spec_on`` into step records; this reduces a
    recorder dump (or any iterable of such dicts) back into one summary the
    report surfaces (``observe.py``'s serving report) can print without
    re-deriving engine internals.
    """
    drafted = 0
    accepted = 0
    requests = 0
    spec_steps = 0
    steps_on = 0
    extra = 0
    morphs = 0
    for rec in records:
        kind = rec.get("kind")
        if kind == "serve_request" and "spec_drafted" in rec:
            requests += 1
            drafted += int(rec.get("spec_drafted") or 0)
            accepted += int(rec.get("spec_accepted") or 0)
        elif kind == "serve_step" and "spec_tokens" in rec:
            if rec.get("spec_on"):
                steps_on += 1
            n = int(rec.get("spec_tokens") or 0)
            if n > 0:
                spec_steps += 1
                extra += n
        elif "controller.spec_morph" in (rec.get("decision"),
                                         rec.get("name")):
            morphs += 1
    rate = (accepted / drafted) if drafted else 0.0
    per_step = 1.0 + extra / spec_steps if spec_steps else 1.0
    return {
        "spec_requests": requests,
        "spec_drafted": drafted,
        "spec_accepted": accepted,
        "accept_rate": round(rate, 6),
        "spec_tokens_per_step": round(per_step, 6),
        "spec_steps": spec_steps,
        "steps_spec_on": steps_on,
        "spec_morphs": morphs,
    }
