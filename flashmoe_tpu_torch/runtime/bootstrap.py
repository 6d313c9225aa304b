"""Host bootstrap: process group, world, placement and mesh.

Counterpart of ``flashmoe_tpu/runtime/bootstrap.py:132-362``.  One process
sees ``torch.cuda.device_count()`` devices, or one on the CPU when asked,
or an int of virtual ranks (as :func:`~flashmoe_tpu_torch.parallel.mesh.
make_mesh` counts them).  With ``FLASHMOE_COORDINATOR``,
``FLASHMOE_NPROCS`` and ``FLASHMOE_RANK`` set (or the same arguments), it
first calls ``torch.distributed.init_process_group`` (gloo on the CPU,
NCCL on the card), and the world is the processes, one ep rank each: the
mesh is :func:`~flashmoe_tpu_torch.parallel.mesh.process_mesh`.  ep folds
as JAX folds it, and the expert placement is the uniform one
(:func:`uniform_placement`).  The Decider (``use_decider`` with more than
one device) and a process world with dp, pp, tp or sp above 1 are not
ported and raise, naming their ROADMAP items.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch

from flashmoe_tpu_torch.config import MoEConfig
from flashmoe_tpu_torch.parallel.mesh import make_mesh, process_mesh

_runtime: Optional["Runtime"] = None
_owns_group = False


@dataclasses.dataclass
class Placement:
    """Parallelism groups and the expert -> device assignment (a copy of
    ``flashmoe_tpu/parallel/decider.py:106``).

    groups:        device-id lists (each an EP group; groups replicate)
    expert_owner:  expert id -> device id owning it
    local_experts: device id -> list of expert ids
    replicas:      hot-expert replication map (empty: none)"""

    groups: list
    expert_owner: dict
    local_experts: dict
    replicas: dict = dataclasses.field(default_factory=dict)


def uniform_placement(n_devices: int, cfg: MoEConfig) -> Placement:
    """Round-robin contiguous placement
    (``flashmoe_tpu/parallel/decider.py:712``)."""
    e = cfg.num_experts
    per = e // n_devices if e >= n_devices else 1
    local = {d: [] for d in range(n_devices)}
    owner = {}
    for eid in range(e):
        d = min(eid // max(per, 1), n_devices - 1)
        owner[eid] = d
        local[d].append(eid)
    return Placement([list(range(n_devices))], owner, local)


@dataclasses.dataclass
class Runtime:
    cfg: MoEConfig
    mesh: object
    placement: Placement
    num_processes: int
    process_id: int
    device: torch.device = torch.device("cpu")

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
               use_decider: bool = True,
               devices=None, device="cuda") -> Runtime:
    """Bring up the runtime (idempotent: a live runtime is returned as is).

    ``cfg``: a config, or a path or dict in ``MoEConfig.from_json``'s
    format.  ``devices``: virtual ranks of ``device`` (an int, or a
    sequence whose length counts); by default the visible CUDA devices,
    or one on the CPU.  ``use_decider`` with more than one device raises
    ``NotImplementedError`` ("Host-side planes"): the Decider, its
    probes (JAX's ``measure``) and the group plan are not ported."""
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
    ep = min(cfg.ep if cfg.ep > 1 else n, n)
    while cfg.num_experts % ep:
        ep -= 1
    cfg = cfg.replace(ep=max(1, ep))
    if use_decider and n > 1:
        raise NotImplementedError(
            "initialize(use_decider=True) over more than one device is "
            "not ported yet: the Decider waits for the ROADMAP item "
            "'Host-side planes'; pass use_decider=False for the uniform "
            "placement")
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
    _runtime = Runtime(
        cfg=cfg, mesh=mesh, placement=placement,
        num_processes=dist.get_world_size() if multi else 1,
        process_id=dist.get_rank() if multi else 0, device=device)
    return _runtime


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
