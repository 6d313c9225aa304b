"""Top-level API facade: the reference's ``flashmoe.ops`` surface.

Counterpart of ``flashmoe_tpu/api.py``: :func:`run_moe` launches worker
processes, :func:`get_compiled_config` returns the active config as a dict
(the same keys and values as JAX's, dtypes by name), and
:func:`get_num_local_experts` / :func:`get_bookkeeping` read the
bootstrapped runtime.
"""

from __future__ import annotations

import dataclasses

from flashmoe_tpu_torch.config import MoEConfig, dtype_name
from flashmoe_tpu_torch.runtime import bootstrap
from flashmoe_tpu_torch.runtime.launcher import run_workers


def run_moe(n_processes: int = 1, processes_per_node: int | None = None,
            hostfile: str | None = None,
            config_path: str | None = None, *, bench: bool = False,
            **launch) -> int:
    """Launch the MoE workers (the reference's ``flashmoe.run_moe``);
    returns the worst exit code.  ``processes_per_node`` and ``hostfile``
    are accepted for the reference's interface; ``launch`` goes to
    :func:`~flashmoe_tpu_torch.runtime.launcher.run_workers`
    (``device``, ``coordinator``, ``timeout``, ...)."""
    del processes_per_node, hostfile
    return run_workers(n_processes, config_path=config_path, bench=bench,
                       **launch)


def get_compiled_config() -> dict:
    """The active configuration as a dict (the default config before
    :func:`~flashmoe_tpu_torch.runtime.bootstrap.initialize`)."""
    try:
        cfg = bootstrap.get_runtime().cfg
    except RuntimeError:
        cfg = MoEConfig()
    d = dataclasses.asdict(cfg)
    for k in ("dtype", "param_dtype", "accum_dtype"):
        d[k] = dtype_name(d[k])
    return d


def get_num_local_experts() -> int:
    """The reference's ``get_num_local_experts``."""
    return bootstrap.get_runtime().num_local_experts


def get_bookkeeping() -> dict:
    """The runtime's state as copies: mesh geometry, placement, process
    info."""
    rt = bootstrap.get_runtime()
    return {
        "mesh": dict(rt.mesh.shape),
        "groups": [list(g) for g in rt.placement.groups],
        "local_experts": {
            int(k): list(v) for k, v in rt.placement.local_experts.items()},
        "num_processes": rt.num_processes,
        "process_id": rt.process_id,
        "num_local_experts": rt.num_local_experts,
    }
