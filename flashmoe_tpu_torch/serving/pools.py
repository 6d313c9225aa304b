"""Prefill/decode pool formation: heterogeneous inference-mode Decider
groups.

Counterpart of ``flashmoe_tpu/serving/pools.py``.  The world is the
port's ranks (:func:`flashmoe_tpu_torch.fabric.topo.world_ranks`):
``devices`` holds each rank's slice entry, as
:func:`flashmoe_tpu_torch.runtime.bootstrap.form_groups` reads it.

Prefill steps are compute-bound full-sequence forwards (B x S tokens);
decode steps move a tiny per-step batch and are latency-bound.  A
disaggregated serving deployment therefore runs them on SEPARATE device
pools — and sizing those pools is exactly the reference Decider's
inference-mode specialization (``decider.cuh:177-268``: the group
objective with NO gradient-allreduce term), applied twice with
different per-step workloads.

:func:`plan_serving_pools` is that split: devices are partitioned into
a decode pool (the fastest devices — decode is the latency-critical
phase) and a prefill pool, sized so the decode pool's throughput share
matches the offered decode compute share; each pool is then priced with
the inference objective (:func:`flashmoe_tpu_torch.parallel.decider.
group_objective`, ``allreduce_ms=0``) at ITS OWN token count — prefill
at the full sequence, decode at the per-step decode batch (the same
decode shape the planner's ``mode='decode'`` prices).

The disaggregated fabric grows each pool into a full
Decider group: pass ``devices`` and the split additionally runs
:func:`flashmoe_tpu_torch.runtime.bootstrap.form_groups` per pool over the
pool's sub-adjacency (its own DP x EP mapping) plus
:func:`flashmoe_tpu_torch.planner.select.select_path` in the pool's pricing
mode (its own execution plan), and ``prefill_overrides`` /
``decode_overrides`` give each pool its OWN config — the int8
expert store on the decode pool, a KV handoff wire, per-pool a2a wire
dtypes — carried on ``PoolPlan.prefill_cfg`` / ``decode_cfg`` so the
fabric loads per-pool quantized states from them.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from flashmoe_tpu_torch.config import MoEConfig
from flashmoe_tpu_torch.parallel.decider import CostArgs, group_objective
from flashmoe_tpu_torch.utils.telemetry import metrics as _metrics


@dataclasses.dataclass(frozen=True)
class PoolPlan:
    """The split: device id lists per pool plus each pool's priced
    per-step objective (ms, inference mode — no allreduce term).

    The fabric fields (``None`` unless ``plan_serving_pools`` ran with
    ``devices``): per-pool Decider group formations
    (:class:`~flashmoe_tpu_torch.runtime.bootstrap.GroupPlan`), per-pool
    planner selections, and per-pool configs carrying each pool's own
    quant/wire settings."""

    prefill_devices: tuple
    decode_devices: tuple
    prefill_ms: float
    decode_ms: float
    decode_share: float
    prefill_group: object | None = None
    decode_group: object | None = None
    prefill_path: object | None = None     # planner Selection
    decode_path: object | None = None
    prefill_cfg: MoEConfig | None = None
    decode_cfg: MoEConfig | None = None

    def snapshot(self) -> dict:
        """JSON-safe ``/vars`` view of the split."""
        doc = {
            "prefill_devices": list(self.prefill_devices),
            "decode_devices": list(self.decode_devices),
            "prefill_ms": round(self.prefill_ms, 4),
            "decode_ms": round(self.decode_ms, 4),
            "decode_share": self.decode_share,
        }
        for name, grp in (("prefill_group", self.prefill_group),
                          ("decode_group", self.decode_group)):
            if grp is not None:
                doc[name] = {"dp": grp.dp, "ep": grp.ep,
                             "mapping": grp.mapping}
        for name, sel in (("prefill_path", self.prefill_path),
                          ("decode_path", self.decode_path)):
            if sel is not None:
                doc[name] = {"backend": getattr(sel, "backend", None),
                             "chunks": getattr(sel, "chunks", None)}
        for name, c in (("prefill_cfg", self.prefill_cfg),
                        ("decode_cfg", self.decode_cfg)):
            if c is not None:
                doc[name] = {"expert_quant": c.expert_quant,
                             "wire_dtype": c.wire_dtype,
                             "wire_dtype_dcn": c.wire_dtype_dcn,
                             "kv_wire_dtype": c.kv_wire_dtype}
        return doc


def _pool_objective(members, rates, adj, cfg: MoEConfig,
                    tokens: int) -> float:
    """Inference-mode objective of one pool at its per-step token
    count: expert compute split over the pool's rate + the worst
    intra-pool activation transfer (``decider._intra_comm_ms``'s
    shrinking-slab rule), allreduce = 0 (``decider.cuh:177-268``)."""
    from flashmoe_tpu_torch.parallel.decider import _intra_comm_ms

    act_mb = tokens * cfg.hidden_size * cfg.param_dtype.itemsize / 1e6
    gamma = max(1, cfg.num_layers // max(1, cfg.moe_frequency))
    args = CostArgs(
        total_expert_cost_ms=cfg.num_experts / max(
            min(rates[m] for m in members), 1e-9),
        comm_mbytes=act_mb, grad_buffer_mb=0.0, gamma=gamma)
    intra = _intra_comm_ms(members, adj, act_mb) if len(members) > 1 \
        else 0.0
    return group_objective(members, rates, intra, args,
                           allreduce_ms=0.0)


def _sub_adjacency(adj, members):
    """Restrict the world adjacency to one pool's members (index order
    preserved — the sub-matrix keeps the DCN entries of any cross-slice
    pair inside the pool)."""
    from flashmoe_tpu_torch.parallel.topology import Adjacency

    ix = np.ix_(members, members)
    return Adjacency(alpha=np.asarray(adj.alpha)[ix],
                     beta=np.asarray(adj.beta)[ix])


def _pool_ep_width(cfg: MoEConfig, n: int) -> int:
    """The EP width a pool of ``n`` devices can actually run: the
    largest divisor of ``num_experts`` that fits (deterministic; 1 for
    a single-device pool)."""
    for d in range(min(n, cfg.num_experts), 0, -1):
        if cfg.num_experts % d == 0:
            return d
    return 1


def _form_pool(cfg: MoEConfig, members, devices, adj, workers,
               *, mode: str, decode_tokens: int):
    """One pool's Decider group + planner selection at its own pricing
    mode.  ``devices``: the world's ranks' slice entries (parallel to
    the adjacency indices)."""
    from flashmoe_tpu_torch.planner.select import select_path
    from flashmoe_tpu_torch.runtime.bootstrap import form_groups

    sub_adj = _sub_adjacency(adj, members)
    sub_workers = [workers[m] for m in members]
    group = form_groups(cfg, [devices[m] for m in members],
                        adj=sub_adj, workers=sub_workers)
    d = group.ep if group.ep >= 1 else _pool_ep_width(cfg, len(members))
    sel = select_path(cfg, d=d, record=False, mode=mode,
                      decode_tokens=(decode_tokens
                                     if mode == "decode" else None))
    return group, sel


def plan_serving_pools(adj, workers, cfg: MoEConfig, *,
                       decode_share: float = 0.5,
                       decode_tokens: int | None = None,
                       devices=None,
                       prefill_overrides: dict | None = None,
                       decode_overrides: dict | None = None,
                       record: bool = True) -> PoolPlan:
    """Partition the world into (prefill, decode) pools.

    ``decode_share``: fraction of total compute the decode phase is
    expected to consume (an offered-load property); the decode pool
    takes the FASTEST devices, throughput-greedy, until its rate share
    reaches it — decode is the latency-critical phase, so it gets the
    best silicon, and the assignment is deterministic (throughput
    descending, device id ascending).  Both pools must be non-empty
    (>= 2 devices total).  ``decode_tokens``: the decode pool's
    per-step token count (default
    ``planner.model.DECODE_TOKENS_DEFAULT``); prefill prices at the
    config's full ``cfg.tokens``.

    ``devices`` (the world's ranks' slice entries, parallel to the
    adjacency indices) upgrades each pool to a full Decider group:
    ``bootstrap.form_groups`` runs per pool over the pool's
    sub-adjacency and ``select.select_path`` prices each pool's
    execution in ITS mode (prefill / decode).  ``prefill_overrides`` /
    ``decode_overrides`` are per-pool ``MoEConfig.replace`` fields
    (quant / wire knobs — e.g. ``{"expert_quant": "int8"}`` on decode
    only) applied before the pool is formed and carried on the plan's
    ``prefill_cfg`` / ``decode_cfg``.
    """
    from flashmoe_tpu_torch.planner.model import DECODE_TOKENS_DEFAULT

    n = adj.n
    if n < 2:
        raise ValueError(
            f"pool split needs >= 2 devices, got {n} (run the engine "
            f"co-located instead)")
    if not 0.0 < decode_share < 1.0:
        raise ValueError(f"decode_share={decode_share} must be in "
                         f"(0, 1)")
    rates = [w.throughput for w in workers]
    total_rate = float(np.sum(rates))
    order = sorted(range(n), key=lambda d: (-rates[d], d))
    decode: list = []
    acc = 0.0
    for d in order:
        if len(decode) >= n - 1:
            break
        if acc / total_rate >= decode_share and decode:
            break
        decode.append(d)
        acc += rates[d]
    prefill = [d for d in range(n) if d not in decode]
    decode.sort()

    toks = int(decode_tokens or DECODE_TOKENS_DEFAULT)
    prefill_cfg = (cfg.replace(**prefill_overrides)
                   if prefill_overrides else cfg)
    decode_cfg = (cfg.replace(**decode_overrides)
                  if decode_overrides else cfg)
    prefill_ms = _pool_objective(prefill, rates, adj, prefill_cfg,
                                 cfg.tokens)
    decode_ms = _pool_objective(decode, rates, adj, decode_cfg, toks)

    pre_group = dec_group = pre_sel = dec_sel = None
    if devices is not None:
        pre_group, pre_sel = _form_pool(
            prefill_cfg, prefill, devices, adj, workers,
            mode="prefill", decode_tokens=toks)
        dec_group, dec_sel = _form_pool(
            decode_cfg, decode, devices, adj, workers,
            mode="decode", decode_tokens=toks)

    plan = PoolPlan(
        tuple(prefill), tuple(decode), prefill_ms, decode_ms,
        decode_share,
        prefill_group=pre_group, decode_group=dec_group,
        prefill_path=pre_sel, decode_path=dec_sel,
        prefill_cfg=(prefill_cfg if prefill_overrides or devices
                     is not None else None),
        decode_cfg=(decode_cfg if decode_overrides or devices
                    is not None else None))
    if record:
        fields = dict(
            prefill_devices=list(plan.prefill_devices),
            decode_devices=list(plan.decode_devices),
            prefill_ms=round(prefill_ms, 4),
            decode_ms=round(decode_ms, 4),
            decode_share=decode_share, decode_tokens=toks)
        if pre_group is not None:
            fields.update(
                prefill_mapping=pre_group.mapping,
                prefill_ep=pre_group.ep,
                decode_mapping=dec_group.mapping,
                decode_ep=dec_group.ep,
                prefill_quant=prefill_cfg.expert_quant,
                decode_quant=decode_cfg.expert_quant,
                kv_wire=decode_cfg.kv_wire_dtype)
        _metrics.decision("serve.pools", **fields)
    return plan
