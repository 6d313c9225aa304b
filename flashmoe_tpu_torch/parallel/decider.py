"""Decider: topology-aware DP x EP group formation and expert placement.

Counterpart of ``flashmoe_tpu/parallel/decider.py:1-723``, function for
function:

* **group formation**: the world's ranks merge greedily over the
  alpha-beta adjacency (union-find, candidate edges sorted by the p2p
  time of one activation buffer); a merge stands when the merged group's
  objective does not exceed the larger of its parts';
* **objective**: gamma x (compute / rate + eta x the worst intra-group
  transfer), plus, when training, the inter-group gradient all-reduce
  priced on the worst external edge, kept in a max-heap across merges;
* **memory feasibility**: a group that cannot hold every expert must
  keep merging;
* **expert assignment**: within a group, experts split over the ranks in
  proportion to their rates (contiguous), or by the cost-sorted greedy
  makespan over observed per-expert costs, slice-aware across nodes,
  with hot experts optionally replicated.

The byte sizes come from the torch dtype's ``itemsize``.  ``decide``
prefers the native implementation (:func:`flashmoe_tpu_torch.runtime.
_native.native_decide`, the port's copy of ``csrc/decider.cpp``) and
falls back to the Python one; both give the same placement.  Everything
here is host-side and runs once at bootstrap (and, for
:func:`rebalance_placement`, when a running job re-places its experts).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from flashmoe_tpu_torch.config import MoEConfig
from flashmoe_tpu_torch.parallel.topology import Adjacency, WorkerAttr


# ----------------------------------------------------------------------
# Cost model (functions.cuh equivalents)
# ----------------------------------------------------------------------

@dataclasses.dataclass
class CostArgs:
    """Inputs to the group objective (the reference's ``ObjArgs``/``ARArgs``,
    ``os/decider/comps/args.cuh:17-89``)."""

    total_expert_cost_ms: float     # all experts, one device-unit of rate
    comm_mbytes: float              # per-step intra-group activation traffic
    grad_buffer_mb: float           # gradient buffer for the allreduce
    gamma: float = 1.0              # pipeline stages (num_layers/moe_freq)
    eta: float = 1.0                # comm weight


def ring_allreduce_ms(grad_mb: float, group_sizes, bottleneck_beta: float,
                      bottleneck_alpha: float = 0.0) -> float:
    """2(G-1)/G * buffer over the bottleneck inter-group edge (Sanders et
    al. ring model, as priced in ``functions.cuh:28-32``)."""
    g = len(group_sizes) if hasattr(group_sizes, "__len__") else group_sizes
    if g <= 1:
        return 0.0
    return 2.0 * (g - 1) * (
        bottleneck_alpha + (grad_mb / g) * bottleneck_beta
    )


def group_objective(members, rates, intra_comm_ms: float, args: CostArgs,
                    allreduce_ms: float = 0.0) -> float:
    """Objective of one group (``functions.cuh:20-26``): time to process all
    experts split across the group, plus weighted intra-group comm, plus the
    inter-group allreduce when training."""
    rate = sum(rates[m] for m in members)
    compute = args.total_expert_cost_ms / max(rate, 1e-9)
    return args.gamma * (compute + args.eta * intra_comm_ms) + allreduce_ms


# ----------------------------------------------------------------------
# Union-find
# ----------------------------------------------------------------------

class _DSU:
    def __init__(self, n):
        self.parent = list(range(n))

    def find(self, x):
        while self.parent[x] != x:
            self.parent[x] = self.parent[self.parent[x]]  # path halving
            x = self.parent[x]
        return x

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra
        return ra


# ----------------------------------------------------------------------
# Decider
# ----------------------------------------------------------------------

@dataclasses.dataclass
class Placement:
    """Result: parallelism groups + expert->device assignment.

    groups:        list of device-id lists (each an EP group; groups
                   replicate, i.e. are the DP dimension)
    expert_owner:  [E] device id owning each expert (within each group the
                   same logical assignment maps to that group's devices)
    local_experts: device id -> list of expert ids
    replicas:      hot-expert replication map.  From :func:`decide`:
                   expert id -> extra device ids also hosting a copy.
                   From :func:`rebalance_placement` (the equal-slot
                   runtime projection): hot SLOT -> victim SLOTs whose
                   ~dead experts are evicted to carry the copy (the
                   ``MoEConfig.expert_replicas`` encoding).  Empty when
                   no expert is replicated.
    """

    groups: list
    expert_owner: dict
    local_experts: dict
    replicas: dict = dataclasses.field(default_factory=dict)


def _intra_comm_ms(members, adj: Adjacency, mbytes: float) -> float:
    """Worst pairwise transfer inside the group — the dispatch/combine
    bottleneck edge.  The payload each peer exchanges shrinks as the group
    grows (the all-to-all slab is 1/|G| of the activations), mirroring the
    reference's ``evalP2PTime`` with ``p2pBuffer / numNodes``
    (``os/decider/comps/group.cuh``)."""
    n = max(len(members), 1)
    worst = 0.0
    for i in members:
        for j in members:
            if i != j:
                worst = max(worst, adj.transfer_ms(i, j, mbytes / n))
    return worst


def _placement_from_native(group_ids, counts, n: int, e: int) -> Placement:
    """Build a Placement from the C++ decider's (group_id, counts) arrays:
    expert ids are assigned contiguously per group in device order, matching
    the Python implementation."""
    import collections

    by_group = collections.defaultdict(list)
    for d in range(n):
        by_group[int(group_ids[d])].append(d)
    groups = [sorted(by_group[g]) for g in sorted(by_group)]
    expert_owner: dict[int, int] = {}
    local_experts: dict[int, list[int]] = {d: [] for d in range(n)}
    for gi, group in enumerate(groups):
        eid = 0
        for d in group:
            for _ in range(int(counts[d])):
                if gi == 0:
                    expert_owner[eid] = d
                local_experts[d].append(eid)
                eid += 1
    return Placement(groups, expert_owner, local_experts)


def assign_experts(group: list, rates, e: int,
                   expert_costs=None) -> dict:
    """Partition ``e`` experts across one group's devices proportionally
    to processing rate (``decider.cuh:273-329``).

    ``expert_costs=None`` keeps the contiguous rate-proportional budget
    split (uniform experts).  With per-expert costs — the controller's
    observed load histogram, the reference's cost-sorted multiset — the
    assignment is the greedy makespan heuristic over that multiset:
    experts sorted by cost descending (ties: lower id first), each
    placed on the device with the smallest projected finish time
    ``(assigned_cost + cost) / rate`` (ties: lower device id).  Both
    arms are fully deterministic: identical inputs yield the identical
    assignment (the stability property the runtime controller leans on
    — a re-plan from unchanged telemetry must be a no-op).

    Returns device id -> list of expert ids (sorted ascending).
    """
    out: dict[int, list[int]] = {d: [] for d in group}
    if expert_costs is None:
        grates = np.array([rates[d] for d in group], dtype=np.float64)
        budgets = np.floor(e * grates / grates.sum()).astype(int)
        # distribute the remainder to the fastest devices
        rem = e - budgets.sum()
        order = np.argsort(-grates, kind="stable")
        for k in range(rem):
            budgets[order[k % len(group)]] += 1
        eid = 0
        for d_idx, d in enumerate(group):
            for _ in range(budgets[d_idx]):
                out[d].append(eid)
                eid += 1
        return out
    costs = np.asarray(expert_costs, dtype=np.float64)
    if costs.shape != (e,):
        raise ValueError(
            f"expert_costs must have shape ({e},), got {costs.shape}")
    assigned = {d: 0.0 for d in group}
    # cost-sorted multiset, heaviest first; ties broken by expert id so
    # the order (and therefore the placement) is reproducible
    for eid in sorted(range(e), key=lambda i: (-costs[i], i)):
        d = min(group,
                key=lambda dd: ((assigned[dd] + costs[eid])
                                / max(rates[dd], 1e-9), dd))
        out[d].append(eid)
        assigned[d] += costs[eid]
    for d in group:
        out[d].sort()
    return out


def assign_experts_sliced(group: list, rates, e: int, slice_of,
                          expert_costs, pair: int = 2) -> dict:
    """Slice-aware cost-sorted assignment for a group whose devices
    span DCN-connected slices (the Decider output maps experts to
    SLICES, not just devices).

    Two levels, both deterministic:

    1. **experts -> slices.**  Each slice gets a rate-proportional
       expert budget (floor + remainder to the fastest slices, the
       :func:`assign_experts` uniform arm at slice granularity).
       Experts are then placed cost-sorted in PAIRS of ``pair``
       (default 2 = ``expert_top_k`` routing companions: the experts a
       token's top-k selection sends traffic to together): each pair
       lands whole on the slice with the smallest projected finish
       time ``(load + pair cost) / slice rate`` among slices with
       budget left.  Hot companions therefore co-locate inside one
       slice — a token routed to both crosses DCN at most once on
       dispatch and its combine rides the aggregated per-slice-pair
       message — while the pair-at-a-time greedy keeps the slices
       load-balanced (packing all hot experts on one slice would just
       move the bottleneck).
    2. **experts -> devices within a slice.**  The greedy makespan
       heuristic of :func:`assign_experts` over that slice's expert
       subset and its own devices.

    Returns device id -> sorted expert ids, the :func:`assign_experts`
    contract."""
    costs = np.asarray(expert_costs, dtype=np.float64)
    if costs.shape != (e,):
        raise ValueError(
            f"expert_costs must have shape ({e},), got {costs.shape}")
    by_slice: dict = {}
    for d in group:
        by_slice.setdefault(slice_of[d], []).append(d)
    sids = sorted(by_slice)
    if len(sids) < 2:
        return assign_experts(group, rates, e, expert_costs=expert_costs)
    srate = np.array([sum(rates[d] for d in by_slice[s]) for s in sids],
                     dtype=np.float64)
    budgets = np.floor(e * srate / srate.sum()).astype(int)
    rem = e - budgets.sum()
    order = np.argsort(-srate, kind="stable")
    for k in range(int(rem)):
        budgets[order[k % len(sids)]] += 1

    slice_experts: dict = {s: [] for s in sids}
    load = {s: 0.0 for s in sids}
    left = {s: int(budgets[i]) for i, s in enumerate(sids)}
    ranked = sorted(range(e), key=lambda i: (-costs[i], i))
    for lo in range(0, e, max(pair, 1)):
        chunk = ranked[lo:lo + max(pair, 1)]
        # slices that can hold the whole pair keep companions together;
        # the tail (budget fragmentation) falls back to any free slot
        fits = [s for s in sids if left[s] >= len(chunk)]
        cands = fits or [s for s in sids if left[s] > 0]
        csum = sum(costs[i] for i in chunk)
        tgt = min(cands,
                  key=lambda s: ((load[s] + csum) / max(srate[sids.index(s)], 1e-9), s))
        for eid in chunk:
            if left[tgt] <= 0:
                tgt = min((s for s in sids if left[s] > 0),
                          key=lambda s: ((load[s] + costs[eid])
                                         / max(srate[sids.index(s)],
                                               1e-9), s))
            slice_experts[tgt].append(eid)
            load[tgt] += costs[eid]
            left[tgt] -= 1

    out: dict[int, list[int]] = {d: [] for d in group}
    for s in sids:
        devs = sorted(by_slice[s])
        assigned = {d: 0.0 for d in devs}
        for eid in sorted(slice_experts[s],
                          key=lambda i: (-costs[i], i)):
            d = min(devs,
                    key=lambda dd: ((assigned[dd] + costs[eid])
                                    / max(rates[dd], 1e-9), dd))
            out[d].append(eid)
            assigned[d] += costs[eid]
    for d in group:
        out[d].sort()
    return out


def _replicate_hot(group: list, rates, per_device: dict, costs,
                   spare_slots: int) -> dict:
    """Replicate the costliest experts onto extra devices while spare
    memory slots remain AND each copy improves the group's projected
    makespan ``max(assigned/rate)``.  Returns expert -> extra device
    ids; ``per_device`` is extended in place."""
    replicas: dict[int, list[int]] = {}
    if spare_slots <= 0 or len(group) < 2:
        return replicas
    costs = np.asarray(costs, dtype=np.float64)
    assigned = {d: sum(costs[e] for e in per_device[d]) for d in group}
    # every copy must improve the makespan, so the loop terminates on
    # its own; the cap just bounds pathological memory-rich groups
    for _ in range(min(spare_slots, len(costs) * (len(group) - 1))):
        # the bottleneck device's costliest expert is the candidate
        bot = max(group, key=lambda d: (assigned[d] / max(rates[d], 1e-9),
                                        d))
        cands = [e for e in per_device[bot]
                 if e not in replicas or bot not in replicas[e]]
        if not cands:
            return replicas
        hot = max(cands, key=lambda e: (costs[e], -e))
        hosts = {d for d in group if hot in per_device[d]}
        free = [d for d in group if d not in hosts]
        if not free:
            return replicas
        # splitting the hot expert's cost evenly across its copies:
        # place the new copy where the post-split makespan is smallest
        n_copies = len(hosts) + 1
        share = costs[hot] / n_copies
        best, best_makespan = None, None
        for d in free:
            proj = dict(assigned)
            for h in hosts:
                proj[h] -= costs[hot] / len(hosts) - share
            proj[d] += share
            mk = max(proj[x] / max(rates[x], 1e-9) for x in group)
            if best_makespan is None or (mk, d) < (best_makespan, best):
                best, best_makespan = d, mk
        cur = max(assigned[x] / max(rates[x], 1e-9) for x in group)
        if best is None or best_makespan >= cur:
            return replicas  # no copy helps: capacity stays unspent
        for h in hosts:
            assigned[h] -= costs[hot] / len(hosts) - share
        assigned[best] += share
        per_device[best].append(hot)
        per_device[best].sort()
        replicas.setdefault(hot, []).append(best)
    return replicas


def decide(adj: Adjacency, workers: list[WorkerAttr], cfg: MoEConfig,
           expert_mb: float | None = None,
           native: str | bool = "auto",
           price_mode: str = "bottleneck",
           expert_costs=None, replicate: bool = False,
           slice_of=None) -> Placement:
    """Form DP x EP groups and assign experts (the reference's
    ``Decider<JobType>::operator()`` + ``assign``).

    Training mode prices the inter-group gradient allreduce with the
    ACTUAL bottleneck external edge, maintained in a max-heap across
    merges exactly as the reference's ``externalEdges`` priority queue
    (``decider.cuh:60, 86-130``): edges that become intra-group leave the
    pool, so the priced bottleneck improves as slow links are absorbed
    into groups — and, crucially, the allreduce term DIFFERS between the
    merged and unmerged sides of each comparison (fewer groups and a
    possibly different bottleneck edge), so it can decide merges.
    ``price_mode="max_beta"`` keeps the global-max-β model for
    comparison (it groups worse).  Inference jobs
    (``cfg.is_training=False``) use the reference's specialization with
    no allreduce term at all (``decider.cuh:177-268``).

    ``native``: "auto" prefers the C++ implementation
    (:mod:`flashmoe_tpu_torch.runtime._native`) when it builds/loads, True
    requires it, False forces pure Python.

    ``expert_costs``: observed per-expert processing cost ([E], any
    positive unit — the runtime controller feeds its load-histogram
    EMA).  Switches the within-group assignment from the contiguous
    uniform split to the reference's cost-sorted multiset
    (:func:`assign_experts`), so a hot expert lands with cheap
    neighbors and a slow device receives the cold tail.  ``replicate``
    additionally copies bottleneck experts onto extra devices while
    group memory capacity allows AND each copy improves the projected
    makespan (``Placement.replicas``).  Both are host-side only and
    force the pure-Python path (the C++ decider predates them).

    ``slice_of``: per-device slice membership (``topology.
    device_slice_ids``).  With ``expert_costs`` given, groups spanning
    more than one slice assign their experts through
    :func:`assign_experts_sliced` — hot top-k companion pairs
    co-locate inside a slice so the DCN hop carries the aggregated
    minimum.  Without costs the uniform split is
    slice-agnostic and nothing changes.
    """
    import heapq

    n = adj.n
    e = cfg.num_experts
    h, i_sz = cfg.hidden_size, cfg.intermediate_size
    bytes_per = cfg.param_dtype.itemsize
    expert_mb = expert_mb if expert_mb is not None else (
        2 * h * i_sz * bytes_per / 1e6
    )
    act_mb = cfg.tokens * h * bytes_per / 1e6
    grad_mb = cfg.param_count * bytes_per / 1e6 if cfg.is_training else 0.0

    rates = [w.throughput for w in workers]
    gamma = max(1, cfg.num_layers // max(1, cfg.moe_frequency))
    args = CostArgs(
        total_expert_cost_ms=e / max(min(rates), 1e-9),
        comm_mbytes=act_mb,
        grad_buffer_mb=grad_mb,
        gamma=gamma,
    )

    if (native != False and price_mode == "bottleneck"  # noqa: E712
            and expert_costs is None and not replicate):
        from flashmoe_tpu_torch.runtime import _native

        res = _native.native_decide(
            adj.alpha, adj.beta,
            np.array(rates, np.float64),
            np.array([w.memory_gb for w in workers], np.float64),
            e, expert_mb, act_mb, grad_mb, gamma, cfg.is_training,
        )
        if res is not None:
            return _placement_from_native(res[0], res[1], n, e)
        if native is True:
            raise RuntimeError("native decider unavailable (g++/build failed)")

    def can_hold_all(members) -> bool:
        cap = sum(workers[m].memory_gb for m in members) * 1024.0  # MB
        return cap >= e * expert_mb

    dsu = _DSU(n)
    members = {d: [d] for d in range(n)}
    training = cfg.is_training and grad_mb > 0

    def obj(mem, ar_ms) -> float:
        # memory-infeasible groups price at infinity, which is exactly the
        # reference's must-merge encoding (functions.cuh obj(): inf when
        # groupMemCapacity < totalExpertMemoryDemand; optimizingPolicy
        # accepts any merge between two infinite sides)
        if not can_hold_all(mem):
            return float("inf")
        intra = _intra_comm_ms(mem, adj, act_mb)
        return group_objective(mem, rates, intra, args, ar_ms)

    # --- inter-group allreduce bottleneck: max-heap of external edges ---
    # keyed by the edge's per-chunk gradient transfer time (the reference's
    # ARArgs::bottleneck); heapq is a min-heap, so negate.
    def bot_time(i, j):
        return adj.transfer_ms(i, j, grad_mb / max(n, 1))

    ext: list = []
    if training and price_mode == "bottleneck":
        ext = [(-bot_time(i, j), i, j)
               for i in range(n) for j in range(n) if i != j]
        heapq.heapify(ext)
    max_beta = float(np.max(adj.beta)) if n > 1 else 0.0

    def groups_now():
        return len({dsu.find(x) for x in range(n)})

    def ar_terms(ra, rb):
        """(ar_parts, ar_merged): the allreduce price before/after the
        hypothetical merge of roots ra+rb.  Pops permanently-intra edges;
        edges that the merge would internalize go to ``limbo`` and are
        re-pushed only if the merge is rejected (decider.cuh:96-158)."""
        g = groups_now()
        if not training:
            return 0.0, 0.0, []
        if price_mode == "max_beta":
            # legacy: same bottleneck both sides, only G differs
            return (ring_allreduce_ms(grad_mb, g, max_beta),
                    ring_allreduce_ms(grad_mb, max(g - 1, 1), max_beta),
                    [])
        limbo = []
        while ext:
            key, i, j = ext[0]
            fi, fj = dsu.find(i), dsu.find(j)
            if fi == fj:
                heapq.heappop(ext)          # intra forever: discard
                continue
            if {fi, fj} == {ra, rb}:
                limbo.append(heapq.heappop(ext))  # internal iff merged
                continue
            break
        # bottleneck for the CURRENT partition includes limbo edges.
        # Heap ORDER is fixed at the initial chunk grad_mb/n, but the
        # VALUE is repriced with the chunk of the current partition —
        # grad_mb/g now, grad_mb/(g-1) post-merge — mirroring the
        # reference's ARArgs::refresh, which re-derives bottleneckTime
        # from the live group count before every objective evaluation
        # (args.cuh:37, decider.cuh:96-158).  Without the refresh the
        # term is underpriced as merges shrink the partition.
        cand = ext[:1] + limbo
        cur_bot = max(
            (adj.transfer_ms(i, j, grad_mb / g) for _, i, j in cand),
            default=0.0,
        )
        ar_parts = 2.0 * (g - 1) * cur_bot if g > 1 else 0.0
        post_bot = (adj.transfer_ms(ext[0][1], ext[0][2],
                                    grad_mb / (g - 1))
                    if ext and g - 1 > 1 else 0.0)
        ar_merged = 2.0 * (g - 2) * post_bot if g - 1 > 1 else 0.0
        return ar_parts, ar_merged, limbo

    # candidate edges sorted by p2p transfer time of one activation buffer
    edges = sorted(
        ((adj.transfer_ms(i, j, act_mb), i, j)
         for i in range(n) for j in range(i + 1, n)),
        key=lambda t: t[0],
    )

    for _, a, b in edges:
        ra, rb = dsu.find(a), dsu.find(b)
        if ra == rb:
            continue
        ga, gb = members[ra], members[rb]
        merged = ga + gb
        ar_parts, ar_merged, limbo = ar_terms(ra, rb)
        o1, o2 = obj(ga, ar_parts), obj(gb, ar_parts)
        om = obj(merged, ar_merged)
        both_inf = o1 == float("inf") and o2 == float("inf")
        if both_inf or om <= max(o1, o2):
            root = dsu.union(ra, rb)
            other = rb if root == ra else ra
            members[root] = merged
            del members[other]
            # limbo edges became intra-group: stay out of the pool
        else:
            for item in limbo:
                heapq.heappush(ext, item)

    # any still-infeasible group merges into its cheapest feasible neighbor
    changed = True
    while changed and len(members) > 1:
        changed = False
        for root, mem in list(members.items()):
            if not can_hold_all(mem):
                best, cost = None, float("inf")
                for r2, m2 in members.items():
                    if r2 == root:
                        continue
                    c = min(
                        adj.transfer_ms(x, y, act_mb)
                        for x in mem for y in m2
                    )
                    if c < cost:
                        best, cost = r2, c
                if best is not None:
                    merged = members[root] + members[best]
                    nr = dsu.union(root, best)
                    other = best if nr == root else root
                    members[nr] = merged
                    if other in members:
                        del members[other]
                    changed = True
                    break

    groups = sorted(members.values(), key=lambda g: sorted(g)[0])
    groups = [sorted(g) for g in groups]

    # --- expert assignment within each group (decider.cuh:273-329) ---
    expert_owner: dict[int, int] = {}
    local_experts: dict[int, list[int]] = {d: [] for d in range(n)}
    replicas: dict[int, list[int]] = {}
    for group in groups:
        spans_slices = (slice_of is not None
                        and len({slice_of[d] for d in group}) > 1)
        if expert_costs is not None and spans_slices:
            per_device = assign_experts_sliced(group, rates, e,
                                               slice_of, expert_costs,
                                               pair=cfg.expert_top_k)
        else:
            per_device = assign_experts(group, rates, e,
                                        expert_costs=expert_costs)
        if replicate and expert_costs is not None:
            cap_mb = sum(workers[d].memory_gb for d in group) * 1024.0
            spare = int(cap_mb // expert_mb) - e if expert_mb > 0 else 0
            reps = _replicate_hot(group, rates, per_device,
                                  expert_costs, spare)
            if group is groups[0]:
                replicas = reps
        for d in group:
            local_experts[d] = list(per_device[d])
            if group is groups[0]:
                for eid in per_device[d]:
                    if eid not in expert_owner:
                        expert_owner[eid] = d
    return Placement(groups, expert_owner, local_experts,
                     replicas=replicas)


def rebalance_placement(loads, n_devices: int, cfg: MoEConfig, *,
                        rates=None, replicate: bool = False,
                        cold_eps: float = 1e-3,
                        hot_min: float | None = None) -> Placement:
    """Equal-slot projection of :func:`decide`'s rate-proportional
    assignment for a RUNNING job: re-place the current physical expert
    slots across devices from their *observed* load histogram.

    The live EP layers shard experts uniformly (``num_experts // ep``
    contiguous slots per rank), so a mid-job re-placement cannot change
    per-device slot counts — only WHICH experts fill which slots.  This
    is the cost-sorted multiset of :func:`assign_experts` under that
    slot constraint: slots sorted by observed load descending (ties:
    lower slot id), each assigned to the device with the smallest
    projected finish time ``(load + l) / rate`` among devices with free
    slots.  Deterministic: identical (loads, rates) produce the
    identical placement.

    ``loads``: [E] observed per-slot load (the controller's MoEStats
    EMA).  ``rates``: per-device throughput (default uniform) — a slow
    device then receives the cold tail.  ``replicate``: while a ~dead
    slot exists (load share < ``cold_eps``), the hottest slot (share >
    ``hot_min``, default ``2/E``) is replicated onto it when splitting
    improves the projected makespan; the pair lands in
    ``Placement.replicas`` as {hot_slot: [victim_slot, ...]} — the
    :attr:`flashmoe_tpu_torch.config.MoEConfig.expert_replicas` encoding
    (victim evicted, its slot overwritten with the hot expert's
    weights).

    Returns a single-group :class:`Placement` whose ``local_experts[d]``
    lists the OLD slot ids device ``d``'s new block holds — i.e. the
    permutation ``perm[new_slot] = old_slot`` read off block by block.
    """
    e = cfg.num_experts
    loads = np.asarray(loads, dtype=np.float64)
    if loads.shape != (e,):
        raise ValueError(f"loads must have shape ({e},), "
                         f"got {loads.shape}")
    if n_devices < 1 or e % n_devices:
        raise ValueError(
            f"n_devices={n_devices} must divide num_experts={e} "
            f"(the uniform EP shard's slot constraint)")
    nlx = e // n_devices
    rates = (np.ones(n_devices) if rates is None
             else np.asarray(rates, dtype=np.float64))
    if rates.shape != (n_devices,):
        raise ValueError(f"rates must have shape ({n_devices},), "
                         f"got {rates.shape}")

    assigned = [0.0] * n_devices
    slots_left = [nlx] * n_devices
    per_device: dict[int, list[int]] = {d: [] for d in range(n_devices)}
    for s in sorted(range(e), key=lambda i: (-loads[i], i)):
        free = [d for d in range(n_devices) if slots_left[d]]
        d = min(free, key=lambda dd: ((assigned[dd] + loads[s])
                                      / max(rates[dd], 1e-9), dd))
        per_device[d].append(s)
        assigned[d] += loads[s]
        slots_left[d] -= 1
    for d in per_device:
        per_device[d].sort()

    expert_owner = {s: d for d in per_device for s in per_device[d]}
    placement = Placement([list(range(n_devices))], expert_owner,
                          per_device)

    if replicate:
        total = float(loads.sum())
        if total > 0:
            share = loads / total
            hot_min = (2.0 / e) if hot_min is None else hot_min
            # new-slot index of each old slot under the permutation
            perm = [s for d in range(n_devices) for s in per_device[d]]
            new_of = {old: i for i, old in enumerate(perm)}
            hot = int(np.argmax(loads))
            dead = [s for s in range(e)
                    if share[s] < cold_eps and s != hot]
            if dead and share[hot] > hot_min:
                # split helps iff moving half the hot load onto some
                # dead slot's device lowers the bottleneck finish time;
                # pick the victim whose device benefits most
                dh = expert_owner[hot]
                before = max(assigned[d] / max(rates[d], 1e-9)
                             for d in range(n_devices))
                best, best_after = None, before
                for cold in dead:
                    dc = expert_owner[cold]
                    if dc == dh:
                        continue
                    proj = list(assigned)
                    proj[dh] -= loads[hot] / 2
                    proj[dc] += loads[hot] / 2
                    after = max(proj[d] / max(rates[d], 1e-9)
                                for d in range(n_devices))
                    if after < best_after:
                        best, best_after = cold, after
                if best is not None:
                    placement.replicas = {new_of[hot]: [new_of[best]]}
    return placement


def placement_permutation(placement: Placement) -> tuple:
    """``perm[new_slot] = old_slot`` for an equal-slot single-group
    placement (:func:`rebalance_placement`): device blocks concatenated
    in device order."""
    group = placement.groups[0]
    return tuple(s for d in group for s in placement.local_experts[d])


def uniform_placement(n_devices: int, cfg: MoEConfig) -> Placement:
    """Round-robin contiguous placement (the reference's ``imposeStrategy``,
    ``bootstrap.cuh:35-52``) — optimal on a homogeneous torus."""
    e = cfg.num_experts
    per = e // n_devices if e >= n_devices else 1
    local = {d: [] for d in range(n_devices)}
    owner = {}
    for eid in range(e):
        d = min(eid // max(per, 1), n_devices - 1)
        owner[eid] = d
        local[d].append(eid)
    return Placement([list(range(n_devices))], owner, local)
