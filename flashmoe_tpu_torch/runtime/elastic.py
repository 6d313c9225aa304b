"""Elastic resume: continue training after the world size changes.

Counterpart of ``flashmoe_tpu/runtime/elastic.py``.  The world is a count
of virtual ranks of one device (as :func:`~flashmoe_tpu_torch.parallel.
mesh.make_mesh` counts them), and the state lives whole on that device, so
a resume is a restore plus a new mesh and a re-folded config.  The restore
template is built on ``meta`` from shapes and dtypes: no second model is
allocated (JAX's ``eval_shape``).
"""

from __future__ import annotations

import warnings

import torch

from flashmoe_tpu_torch.config import MoEConfig
from flashmoe_tpu_torch.models import transformer
from flashmoe_tpu_torch.parallel.mesh import make_mesh
from flashmoe_tpu_torch.runtime import checkpoint as ckpt
from flashmoe_tpu_torch.runtime.trainer import (TrainState, init_guard_state,
                                                make_optimizer)


def fold_parallelism(cfg: MoEConfig, n_devices: int) -> MoEConfig:
    """Fit the config's parallelism to ``n_devices``: ep folds down to the
    largest divisor of num_experts that fits, dp takes the rest; pp, tp and
    sp drop to 1 with a warning (the model is the same, the execution
    strategy is not)."""
    dropped = [ax for ax in ("pp", "tp", "sp") if getattr(cfg, ax) > 1]
    if dropped:
        warnings.warn(
            "elastic resume folds parallelism to dp x ep; dropping "
            + ", ".join(f"{ax}={getattr(cfg, ax)}" for ax in dropped)
            + " from the stored config (the restored model is identical; "
            "the execution strategy is not)", stacklevel=2)
    ep = min(cfg.ep if cfg.ep > 1 else n_devices, n_devices)
    while ep > 1 and (cfg.num_experts % ep or n_devices % ep):
        ep -= 1
    return cfg.replace(ep=max(1, ep), dp=max(1, n_devices // max(1, ep)),
                       pp=1, tp=1, sp=1)


def train_mesh(cfg: MoEConfig, n_devices: int, device="cuda"):
    """The train step's mesh for ``n_devices`` virtual ranks of
    ``device``; None (the single-device path) for one rank."""
    if n_devices == 1:
        return None
    return make_mesh(cfg, devices=n_devices, device=device)


def meta_state(cfg: MoEConfig, optimizer, guard=None) -> TrainState:
    """A :class:`TrainState` of the config's shapes and dtypes on
    ``meta``: a restore template without storage."""
    params = transformer.init_params(torch.Generator(), cfg, device="meta")
    return TrainState(params, optimizer.init(params),
                      torch.zeros((), dtype=torch.int32, device="meta"),
                      init_guard_state("meta") if guard is not None
                      else None)


def elastic_resume(cfg: MoEConfig, checkpoint_dir: str, *,
                   devices=None, optimizer=None, total_steps: int = 10000,
                   guard=None, loader=None, device="cuda"):
    """Fold the config to ``devices`` (an int of virtual ranks of
    ``device``, or a sequence whose length counts; one rank without it),
    build the mesh, and restore the newest checkpoint onto ``device``.

    ``guard``: the job's ``GradGuardConfig`` when the checkpoint was
    written by a guarded step; a guarded checkpoint restored without it
    raises a clear ValueError.  ``loader``: repositioned from the
    manifest's cursor.  Returns (state, mesh, cfg', optimizer); the mesh
    is None for one rank."""
    n = 1 if devices is None else (
        devices if isinstance(devices, int) else len(devices))
    cfg = fold_parallelism(cfg, n)
    mesh = train_mesh(cfg, n, device)
    optimizer = optimizer or make_optimizer(cfg, total_steps=total_steps)
    step = ckpt.latest_step(checkpoint_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {checkpoint_dir}")
    template = meta_state(cfg, optimizer, guard)
    try:
        state = ckpt.restore(checkpoint_dir, template, step=step,
                             device=device)
    except ValueError as e:
        if guard is None and ckpt.has_guard(checkpoint_dir, step):
            raise ValueError(
                f"checkpoint step {step} in {checkpoint_dir} carries a "
                f"tier-1 GuardState subtree but elastic_resume was "
                f"called without guard=; pass the job's GradGuardConfig "
                f"so the restore template matches the on-disk layout") \
                from e
        raise
    ckpt.restore_loader_state(checkpoint_dir, int(state.step), loader)
    return state, mesh, cfg, optimizer
