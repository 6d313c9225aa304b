"""Host bootstrap: process group, world, Decider, placement and mesh.

Counterpart of ``flashmoe_tpu/runtime/bootstrap.py:1-362``.  One process
sees ``torch.cuda.device_count()`` devices, or one on the CPU when asked,
or an int of virtual ranks (as :func:`~flashmoe_tpu_torch.parallel.mesh.
make_mesh` counts them).  With ``FLASHMOE_COORDINATOR``,
``FLASHMOE_NPROCS`` and ``FLASHMOE_RANK`` set (or the same arguments), it
first calls ``torch.distributed.init_process_group`` (gloo on the CPU,
NCCL on the card), and the world is the processes, one ep rank each: the
mesh is :func:`~flashmoe_tpu_torch.parallel.mesh.process_mesh`.  ep folds
as JAX folds it.

With ``use_decider`` over more than one rank the Decider
(:mod:`flashmoe_tpu_torch.parallel.decider`) forms DP x EP groups over the
analytic adjacency (:func:`~flashmoe_tpu_torch.parallel.topology.
ici_adjacency`: the local-mesh row for virtual ranks, the card's row and
the nodes of a ``torch.distributed`` world otherwise;
``FLASHMOE_MOCK_SLICES`` mocks slices), priced on measured rates with
``measure`` (the throughput probe, run once on this process's device and
given to each of its virtual ranks, and in a process world the probed
cross-process costs).  :func:`form_groups` classifies the groups into a
:class:`GroupPlan`, recorded as a ``bootstrap.groups`` decision; an
unpinned ep adopts its factorization on a local mesh.  The runtime then
publishes the fused kernel's arrival order on a heterogeneous fabric
(:func:`current_src_order`) and the two-stage exchange's ranks per slice
(:func:`current_dcn_inner`).  A process world keeps one ep rank a
process: the plan is recorded there but not adopted, and dp, pp, tp or sp
above 1 across processes raise, naming their ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from flashmoe_tpu_torch.config import MoEConfig
from flashmoe_tpu_torch.parallel.decider import (Placement, decide,
                                                 uniform_placement)
from flashmoe_tpu_torch.parallel.mesh import make_mesh, process_mesh
from flashmoe_tpu_torch.parallel.topology import (
    contiguous_blocking, device_slice_ids, ici_adjacency,
    measured_worker_attrs, merge_dcn_costs, probe_dcn_costs,
    slice_structure, world_nodes)

_runtime: Optional["Runtime"] = None
_owns_group = False


@dataclasses.dataclass
class GroupPlan:
    """How the Decider's groups map onto the job's (dp, ep) axes
    (``flashmoe_tpu/runtime/bootstrap.py:36``).

    ``mapping``:

    * ``'single'``: one slice (or one group on it): ep owns every rank;
    * ``'ep_across_dcn'``: each EP group spans slices: the collective
      layer runs the two-stage exchange (``dcn_inner`` set;
      ``MoEConfig.wire_dtype_dcn`` applies to its cross-slice hop);
    * ``'dp_across_dcn'``: one EP group a slice: the exchange stays in a
      slice and dp crosses slices;
    * ``'irregular'``: the groups are not equal contiguous blocks the
      (dp, ep) grid can express; recorded, the single-group fold
      stands."""

    dp: int
    ep: int
    mapping: str
    slices: tuple[int, int] | None   # (n_slices, ranks_per_slice)
    dcn_inner: int | None            # the two-stage exchange's blocking
    groups: list
    placement: Placement


def _world_ranks(devices) -> list:
    """The ranks' slice entries: an int counts ranks of one node."""
    return [0] * devices if isinstance(devices, int) else list(devices)


def form_groups(cfg: MoEConfig, devices, adj=None, workers=None, *,
                expert_costs=None) -> GroupPlan:
    """Run the Decider over the (slice-aware) adjacency and classify its
    groups into a DP x EP mapping the mesh can express
    (``flashmoe_tpu/runtime/bootstrap.py:66``).  ``devices``: the ranks
    (an int counts ranks of one node; a list holds each rank's node or
    slice entry, as :func:`~flashmoe_tpu_torch.parallel.topology.
    device_slice_ids` reads it).  ``adj`` defaults to
    :func:`~flashmoe_tpu_torch.parallel.topology.ici_adjacency` of the
    ranks, ``workers`` to unprobed attributes.  ``expert_costs`` routes
    the within-group assignment through the slice-aware cost-sorted
    multiset."""
    devices = _world_ranks(devices)
    n = len(devices)
    ss = slice_structure(devices)
    sids = device_slice_ids(devices)
    if adj is None:
        adj = ici_adjacency(devices)
    if workers is None:
        workers = measured_worker_attrs(n // _procs(), cfg, probe=False)
    placement = decide(adj, workers, cfg, slice_of=sids,
                       expert_costs=expert_costs)
    groups = placement.groups

    def blocked(size: int) -> bool:
        """The groups are exactly the contiguous rank blocks of
        ``size``."""
        want = [list(range(i, i + size)) for i in range(0, n, size)]
        return sorted(map(tuple, groups)) == sorted(map(tuple, want))

    gsz = len(groups[0]) if groups else n
    regular = (len(groups) >= 1 and all(len(g) == gsz for g in groups)
               and gsz * len(groups) == n and blocked(gsz)
               and cfg.num_experts % gsz == 0)
    if not regular:
        ep = n
        while cfg.num_experts % ep:
            ep -= 1
        inner = ss[1] if ss else None
        hier = (inner is not None and 1 < inner < ep
                and ep % inner == 0)
        return GroupPlan(dp=1, ep=ep, mapping="irregular", slices=ss,
                         dcn_inner=inner if hier else None,
                         groups=groups, placement=placement)
    dp, ep = len(groups), gsz
    inner = ss[1] if ss else None
    if ss is None or dp == 1 and (inner is None or ep <= inner):
        mapping, dcn_inner = "single", None
    elif inner is not None and ep > inner and ep % inner == 0:
        mapping, dcn_inner = "ep_across_dcn", inner
    elif inner is not None and ep <= inner and inner % ep == 0:
        mapping = "dp_across_dcn" if dp > 1 else "single"
        dcn_inner = None
    else:
        mapping, dcn_inner = "irregular", None
    return GroupPlan(dp=dp, ep=ep, mapping=mapping, slices=ss,
                     dcn_inner=dcn_inner, groups=groups,
                     placement=placement)


@dataclasses.dataclass
class Runtime:
    cfg: MoEConfig
    mesh: object
    placement: Placement
    num_processes: int
    process_id: int
    device: torch.device = torch.device("cpu")
    # the fused kernel's per-rank source order on a heterogeneous fabric
    # (topology.arrival_order); None: the ring
    src_order: object = None
    # ranks per slice when the ep axis spans slices: the collective
    # layer's two-stage exchange
    dcn_inner: int | None = None
    # the Decider's group plan (None without the Decider)
    group_plan: GroupPlan | None = None

    @property
    def num_local_experts(self) -> int:
        """nLx of this process's first device: its rank's entry of the
        placement (one device a process in a process world, device 0
        otherwise)."""
        got = self.placement.local_experts.get(
            self.process_id if self.num_processes > 1 else 0)
        if got:
            return len(got)
        return self.cfg.num_experts // max(1, self.cfg.ep)


def _procs() -> int:
    """The processes of the ``torch.distributed`` world (1 without
    one)."""
    import torch.distributed as dist

    return (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else 1)


def _env_rank() -> int:
    for name in ("FLASHMOE_RANK", "OMPI_COMM_WORLD_RANK", "PMI_RANK",
                 "SLURM_PROCID"):
        if name in os.environ:
            return int(os.environ[name])
    return 0


def _local_devices(devices, device: torch.device) -> int:
    if devices is not None:
        return devices if isinstance(devices, int) else len(devices)
    if device.type == "cuda":
        n = torch.cuda.device_count()
        if n < 1:
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        return n
    return 1


def initialize(cfg: MoEConfig | dict | str | None = None, *,
               coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               use_decider: bool = True, measure: bool | None = None,
               devices=None, device="cuda") -> Runtime:
    """Bring up the runtime (idempotent: a live runtime is returned as is).

    ``cfg``: a config, or a path or dict in ``MoEConfig.from_json``'s
    format.  ``devices``: virtual ranks of ``device`` (an int, or a
    sequence whose length counts); by default the visible CUDA devices,
    or one on the CPU.  ``use_decider`` over more than one rank runs the
    Decider (module docstring); ``measure`` probes the expert throughput
    (and, in a process world, the cross-process costs) for it, by
    default on the card and in a process world."""
    global _runtime, _owns_group
    if _runtime is not None:
        return _runtime
    if isinstance(cfg, (dict, str)):
        cfg = MoEConfig.from_json(cfg)
    cfg = cfg or MoEConfig()
    device = torch.device(device)

    coord = coordinator_address or os.environ.get("FLASHMOE_COORDINATOR")
    nproc = num_processes or int(os.environ.get("FLASHMOE_NPROCS", "0"))
    pid = process_id if process_id is not None else _env_rank()
    import torch.distributed as dist

    if coord and nproc > 1 and not dist.is_initialized():
        if device.type == "cuda":
            torch.cuda.set_device(pid % torch.cuda.device_count())
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            init_method=f"tcp://{coord}", world_size=nproc, rank=pid)
        _owns_group = True
    multi = dist.is_initialized() and dist.get_world_size() > 1
    n = dist.get_world_size() if multi else _local_devices(devices, device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())

    # fold the requested ep down to the available device count
    ep_pinned = cfg.ep > 1
    ep = min(cfg.ep if cfg.ep > 1 else n, n)
    while cfg.num_experts % ep:
        ep -= 1
    cfg = cfg.replace(ep=max(1, ep))
    if measure is None:
        measure = multi or device.type == "cuda"
    # each rank's slice entry: the world's nodes, or one node of virtual
    # ranks
    ranks = world_nodes() if multi else [0] * n
    src_order = plan = None
    if use_decider and n > 1:
        # virtual ranks of one device price on the local-mesh row
        adj = ici_adjacency(ranks, platform=None if multi else "local")
        if measure and multi:
            adj = merge_dcn_costs(adj, probe_dcn_costs())
        attrs = measured_worker_attrs(1 if multi else n, cfg,
                                      probe=measure, device=device)
        plan = form_groups(cfg, ranks, adj=adj, workers=attrs)
        placement = plan.placement
        if (not ep_pinned and not multi
                and plan.mapping in ("ep_across_dcn", "dp_across_dcn")
                and cfg.num_experts % plan.ep == 0):
            # adopt the Decider's DP x EP factorization (a pinned ep
            # stands; a process world keeps one ep rank a process)
            cfg = cfg.replace(ep=plan.ep)
        from flashmoe_tpu_torch.utils.telemetry import metrics

        metrics.decision(
            "bootstrap.groups", mapping=plan.mapping,
            dp=plan.dp, ep=plan.ep, adopted_ep=cfg.ep,
            slices=list(plan.slices) if plan.slices else None,
            dcn_inner=plan.dcn_inner,
            groups=[list(g) for g in plan.groups],
            ep_pinned=ep_pinned)
        src_order = _heterogeneous_src_order(adj, cfg, n)
    else:
        placement = uniform_placement(n, cfg)
    if multi:
        if cfg.ep != n or max(cfg.dp, cfg.pp, cfg.tp, cfg.sp) > 1:
            raise NotImplementedError(
                f"a process world of {n} with ep={cfg.ep}, dp={cfg.dp}, "
                f"pp={cfg.pp}, tp={cfg.tp}, sp={cfg.sp}: tp, dp, pp or sp "
                f"above 1 across processes waits for the ROADMAP item "
                f"'Blocked on hardware: the multi-GPU transport'")
        mesh = process_mesh()
    else:
        mesh = make_mesh(cfg, devices=n, device=device)
    if plan is not None and cfg.ep == plan.ep:
        dcn_inner = plan.dcn_inner
    else:
        # the blocking of the ep prefix, from the world's slice ids
        ss = (contiguous_blocking(device_slice_ids(ranks)[:cfg.ep])
              if cfg.ep > 1 else None)
        # one rank a slice is the flat exchange: publish None
        dcn_inner = ss[1] if ss and 1 < ss[1] < cfg.ep else None
    _runtime = Runtime(
        cfg=cfg, mesh=mesh, placement=placement,
        num_processes=dist.get_world_size() if multi else 1,
        process_id=dist.get_rank() if multi else 0, device=device,
        src_order=src_order, dcn_inner=dcn_inner, group_plan=plan)
    return _runtime


def _serves(mesh, d_world: int) -> bool:
    """Whether the live runtime's rank indexing applies to ``mesh``: the
    runtime's own world of ``d_world`` ranks, as a local mesh of virtual
    ranks on its device, or a process mesh of its world in rank order
    (JAX: the mesh's devices are ``jax.devices()`` in order)."""
    rt = _runtime
    size = getattr(mesh, "size", None)
    if rt is None or size != d_world or rt.mesh.size != d_world:
        return False
    if mesh.is_local != rt.mesh.is_local:
        return False
    if mesh.is_local:
        dev = mesh.device
        return (tuple(mesh.ranks) == tuple(range(d_world))
                and (dev is None or dev == rt.device))
    import torch.distributed as dist

    return tuple(mesh.ranks) == (dist.get_rank(),)


def current_src_order(mesh, d_world: int):
    """The bootstrapped arrival-order table, iff it applies to ``mesh``
    (``flashmoe_tpu/runtime/bootstrap.py:284``): a live runtime holds a
    ``[d_world, d_world]`` table and ``mesh`` is its world
    (:func:`_serves`).  None otherwise: the kernel's ring stands."""
    rt = _runtime
    if rt is None or rt.src_order is None:
        return None
    if getattr(rt.src_order, "shape", None) != (d_world, d_world):
        return None
    return rt.src_order if _serves(mesh, d_world) else None


def current_dcn_inner(mesh, d_world: int) -> int | None:
    """The bootstrapped ranks per slice of ``mesh``'s ep axis, iff the
    mesh is the runtime's world (``flashmoe_tpu/runtime/bootstrap.py:
    310``).  None: one slice or unknown; the flat exchange stands."""
    rt = _runtime
    if rt is None or rt.dcn_inner is None:
        return None
    if not (1 < rt.dcn_inner < d_world) or d_world % rt.dcn_inner:
        return None
    return rt.dcn_inner if _serves(mesh, d_world) else None


def _heterogeneous_src_order(adj, cfg: MoEConfig, n: int):
    """The fused kernel's arrival-order schedule, or None when it is the
    ring (a homogeneous fabric, or an ep axis that does not span the
    adjacency).  Payload: one source's slab to one destination, nLx x
    cap x H at the compute dtype (``bootstrap.py:331``)."""
    from flashmoe_tpu_torch.parallel.ep import local_capacity
    from flashmoe_tpu_torch.parallel.topology import (arrival_order,
                                                      default_ring)

    if cfg.ep <= 1 or cfg.ep != n:
        return None
    s_loc = max(cfg.tokens // cfg.ep, 1)
    nlx = cfg.num_experts // cfg.ep
    slab_mb = (nlx * local_capacity(cfg, s_loc) * cfg.hidden_size
               * cfg.dtype.itemsize) / 1e6
    order = arrival_order(adj, slab_mb)
    return None if np.array_equal(order, default_ring(n)) else order


def finalize():
    """Tear down: drop the runtime and the process group it created."""
    global _runtime, _owns_group
    _runtime = None
    if _owns_group:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
        _owns_group = False


def get_runtime() -> Runtime:
    if _runtime is None:
        raise RuntimeError("flashmoe_tpu_torch.runtime not initialized")
    return _runtime
