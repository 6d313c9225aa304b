"""Runtime-side wiring of the live telemetry plane.

Counterpart of ``flashmoe_tpu/runtime/telemetry_hooks.py``: one place
builds the ``/healthz`` and ``/vars`` documents for every training entry
point (``train``, ``resilient_train``, ``supervise``), so the three
loops expose the same schema: step progress, SLO episode state, the
controller's budgets (when one runs), the last durable checkpoint step,
and the job's resolved plan (the newest ``planner.path_select`` and
``bootstrap.groups`` decisions).  Everything is read on scrape: no
thread works unless a request arrives, and with no ``telemetry_port``
nothing here is imported.
"""

from __future__ import annotations


def _config_vars(cfg) -> dict:
    """The "active knobs" slice of MoEConfig for ``/vars`` — the fields
    an on-call engineer asks about first."""
    if cfg is None:
        return {}
    return {k: getattr(cfg, k, None) for k in (
        "num_experts", "expert_top_k", "hidden_size",
        "intermediate_size", "sequence_len", "num_layers",
        "moe_backend", "serving_mode", "fused_schedule",
        "wire_dtype", "wire_dtype_combine", "wire_dtype_dcn",
        "a2a_chunks", "expert_replicas", "collect_stats",
        "degrade_unhealthy_experts", "ep", "dp",
    )}


def _plan_vars(metrics_obj=None) -> dict:
    """The resolved plan + GroupPlan from the decision stream (the
    planner and bootstrap already narrate them; ``/vars`` just shows
    the newest record of each)."""
    from flashmoe_tpu_torch.utils.telemetry import metrics as _global

    mo = metrics_obj if metrics_obj is not None else _global
    out = {}
    sel = mo.last_decision("planner.path_select")
    if sel is not None:
        out["path_select"] = {k: v for k, v in sel.items()
                              if k != "decision"}
    groups = mo.last_decision("bootstrap.groups")
    if groups is not None:
        out["group_plan"] = {k: v for k, v in groups.items()
                             if k != "decision"}
    return out


def train_server(port, cfg=None, mesh=None, *, num_steps=None,
                 progress=None, watchdog=None, controller=None,
                 checkpoint_dir=None, metrics_obj=None,
                 extra_health=None, box=None):
    """Start (or return ``None`` for a ``None`` port) the scrape server
    for a training loop.

    ``progress``: a mutable ``{"step": int}`` the loop updates in
    place.  ``box``: an optional mutable dict whose ``watchdog`` /
    ``controller`` / ``cfg`` / ``checkpoint_dir`` entries OVERRIDE the
    arguments at scrape time — ``supervise`` re-points one long-lived
    server at each incarnation's objects through it."""
    from flashmoe_tpu_torch.telemetry_plane.server import maybe_server

    box = box if box is not None else {}

    def health():
        wd = box.get("watchdog", watchdog)
        ctl = box.get("controller", controller)
        ckdir = box.get("checkpoint_dir", checkpoint_dir)
        doc: dict = {"phase": box.get("phase", "train")}
        if num_steps is not None:
            doc["num_steps"] = num_steps
        if progress is not None:
            doc["step"] = progress.get("step")
        doc.update(box.get("health", {}))
        if ckdir:
            from flashmoe_tpu_torch.runtime import checkpoint as ckpt

            try:
                doc["last_checkpoint_step"] = ckpt.latest_step(ckdir)
            except Exception as e:  # noqa: BLE001 — health must answer
                doc["last_checkpoint_step_error"] = str(e)[:120]
        if wd is not None:
            doc["slo"] = wd.snapshot()
        if ctl is not None:
            doc["controller"] = ctl.snapshot()
        if extra_health is not None:
            doc.update(extra_health() or {})
        return doc

    def vars_fn():
        c = box.get("cfg", cfg)
        doc = {"config": _config_vars(c)}
        m = box.get("mesh", mesh)
        if m is not None:
            doc["mesh"] = {str(k): int(v) for k, v in m.shape.items()}
        doc.update(_plan_vars(metrics_obj))
        return doc

    return maybe_server(port, health_fn=health, vars_fn=vars_fn,
                        metrics_obj=metrics_obj)
