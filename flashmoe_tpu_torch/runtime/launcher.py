"""Multi-process launcher.

Counterpart of ``flashmoe_tpu/runtime/launcher.py``: start N local worker
processes with the coordinator environment that
:mod:`flashmoe_tpu_torch.runtime.bootstrap` reads.  Two processes cannot
share one H100 under NCCL, so a multi-process run here is a CPU run on
gloo (``device="cpu"``); a run on the card takes one process.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time


def run_workers(n_processes: int = 1, *, config_path: str | None = None,
                bench: bool = False, coordinator: str = "127.0.0.1:8476",
                extra_env: dict | None = None,
                per_rank_env: dict | None = None,
                worker_module: str = "flashmoe_tpu_torch.runtime.worker",
                device: str = "cuda", timeout: float | None = None) -> int:
    """Launch N local workers (``python -m worker_module [config]
    [--bench] [--device cpu]``) and return the worst exit code.
    ``per_rank_env`` maps rank -> environment overrides for that rank.
    ``timeout``: seconds to wait for them all; past it every worker is
    killed and ``subprocess.TimeoutExpired`` raised."""
    procs = []
    for rank in range(n_processes):
        env = dict(os.environ)
        env.update(extra_env or {})
        env.update((per_rank_env or {}).get(rank, {}))
        if n_processes > 1:
            env.update({
                "FLASHMOE_COORDINATOR": coordinator,
                "FLASHMOE_NPROCS": str(n_processes),
                "FLASHMOE_RANK": str(rank),
            })
        cmd = [sys.executable, "-m", worker_module]
        if config_path:
            cmd.append(config_path)
        if bench:
            cmd.append("--bench")
        if device != "cuda":
            cmd += ["--device", device]
        procs.append(subprocess.Popen(cmd, env=env))
    rc = 0
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=None if deadline is None
                   else max(0.0, deadline - time.monotonic()))
            rc = max(rc, p.returncode)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return rc
