"""Resilient training: failure detection and checkpoint-based recovery.

Counterpart of ``flashmoe_tpu/runtime/resilient.py``:

* **detection**: each step may run under a wall-clock deadline, and its
  loss must be finite; a deadline, a non-finite loss or an exception from
  the step counts as a failure;
* **recovery**: the state is restored from the newest intact checkpoint
  (verified first) and the same batches are replayed from a buffer; a
  step that fails ``max_retries`` times in a row aborts after an
  emergency save of the last good state;
* **periodic checkpoints**, sync or async (the loop pays only the copy to
  pinned host memory);
* **graceful drain**: a :class:`~flashmoe_tpu_torch.runtime.preempt.
  PreemptionListener` notice finishes the step in flight, writes a final
  checkpoint with the data loader's cursor, records a ``preempt.drain``
  decision and returns;
* **deterministic data resume**: a stateful loader's cursor rides every
  manifest and is restored on resume, so a resumed run consumes the token
  stream of an unbroken one.

:func:`supervise` is the restart loop over drains, crashes and changes of
world size (virtual ranks of one device, :func:`~flashmoe_tpu_torch.
runtime.elastic.elastic_resume`).

A step that raises :class:`~flashmoe_tpu_torch.planner.select.
PathFailure` has its backend reported to the planner before the retry
(``report_path_failure``: a ``planner.fallback`` decision and the
backend demoted), so an ``'auto'`` step rebuilt for the retry resolves
onto a healthy path, as JAX's loop does.

The host-side planes: ``slo`` judges every successful step against its
budgets (sustained breaches demote a path), ``telemetry_port`` serves
``/metrics``, ``/healthz`` and ``/vars`` for the run, and
``postmortem_dir`` receives a crash bundle
(:mod:`flashmoe_tpu_torch.profiler.postmortem`) when recovery gives up.
With a profiler timeline armed each step is a timeline step and the
loop's host work its sections.  A runtime controller (``controller``,
or ``ResilienceConfig.adapt`` under :func:`supervise`) observes every
successful step and may act at a step boundary; each action is made
durable at once, its plan in the checkpoint's manifest.  The
port's step returns new tensors and never donates its input, so the
state before the first checkpoint is kept by reference, not as a host
copy.
"""

from __future__ import annotations

import concurrent.futures as _fut
import dataclasses
import math
import time
from typing import Callable, Iterator

import torch

from flashmoe_tpu_torch.planner.select import (PathFailure,
                                               report_path_failure)
from flashmoe_tpu_torch.profiler import spans as prof
from flashmoe_tpu_torch.runtime import checkpoint as ckpt
from flashmoe_tpu_torch.runtime.trainer import TrainState
from flashmoe_tpu_torch.tree import tree_leaves
from flashmoe_tpu_torch.utils.telemetry import Metrics, trace_span

class StepFailure(RuntimeError):
    """Unrecoverable training failure.  Instances raised by
    :func:`resilient_train` carry ``partial_history``: the records of the
    steps executed before the abort."""

    partial_history: list


def _make_deadline_executor() -> _fut.ThreadPoolExecutor:
    """The single-worker executor of the step deadline (one a run, and a
    new one after each abandoned timeout)."""
    return _fut.ThreadPoolExecutor(
        max_workers=1, thread_name_prefix="flashmoe-deadline")


@dataclasses.dataclass
class ResilienceConfig:
    checkpoint_dir: str = "/tmp/flashmoe_ckpt"
    checkpoint_every: int = 50
    step_timeout_s: float | None = None  # None = no deadline
    max_retries: int = 3
    verify_checkpoints: bool = True   # checksum-verify before restore
    emergency_save: bool = True       # persist the last good state on abort
    async_save: bool = False          # periodic saves off the step loop
    # the runtime controller: a ControllerConfig arms one that
    # supervise() builds and owns; None keeps the loop without one
    adapt: object | None = None


def _block_until_ready(out) -> None:
    """Wait for the step's work on the card: one event behind it on the
    current stream (no device-wide synchronize)."""
    if any(t.is_cuda for t in tree_leaves(out) if torch.is_tensor(t)):
        done = torch.cuda.Event()
        done.record()
        done.synchronize()


def _run_step(step_fn, state, batch, timeout_s, ex_box=None):
    """One step, optionally under a wall-clock deadline on the result.

    ``ex_box``: a one-slot list holding the run's reusable executor.  A
    timeout abandons it (its worker may be stuck in the very hang the
    deadline detected, and a step running on the card cannot be
    cancelled); the next step gets a new one."""
    if timeout_s is None:
        out = step_fn(state, batch)
        _block_until_ready(out)
        return out
    if ex_box is None:
        ex_box = [None]
    if ex_box[0] is None:
        ex_box[0] = _make_deadline_executor()

    def run():
        out = step_fn(state, batch)
        _block_until_ready(out)
        return out

    f = ex_box[0].submit(run)
    try:
        return f.result(timeout=timeout_s)
    except _fut.TimeoutError as e:
        ex, ex_box[0] = ex_box[0], None
        ex.shutdown(wait=False)
        raise StepFailure(f"step exceeded {timeout_s}s deadline") from e


def scalar_metrics(m: dict) -> dict:
    """A step's metrics as floats, one-element values only (per-layer
    ``moe_stats`` and other arrays are skipped)."""
    out = {}
    for k, v in m.items():
        try:
            if torch.is_tensor(v):
                if v.numel() == 1:
                    out[k] = float(v.reshape(()))
            elif isinstance(v, (int, float)):
                out[k] = float(v)
        except (TypeError, ValueError, RuntimeError):
            continue
    return out


def _step_loss(m: dict) -> float | None:
    """The step's scalar loss, or None when absent or not a scalar."""
    v = m.get("loss")
    if v is None:
        return None
    if torch.is_tensor(v):
        return float(v.reshape(())) if v.numel() == 1 else None
    try:
        return float(v)
    except (TypeError, ValueError):
        return None


class _ReplayBuffer:
    """Batches consumed since the last durable checkpoint, keyed by step.

    A rewound step re-runs on the batch its failed attempt consumed.
    Pruning lags one checkpoint, so a fallback to the previous intact
    checkpoint still replays exactly.  With a stateful loader its cursor
    is recorded before each fresh pull: ``loader_state_for(k)`` is where a
    new process resumes at step ``k``."""

    def __init__(self, data_iter: Iterator):
        self._it = data_iter
        self._stateful = (hasattr(data_iter, "state_dict")
                          and hasattr(data_iter, "load_state_dict"))
        self._buf: dict[int, object] = {}
        self._states: dict[int, dict] = {}

    def batch_for(self, step: int):
        b = self._buf.get(step)
        if b is None:
            if self._stateful and step not in self._states:
                self._states[step] = self._it.state_dict()
            b = next(self._it)
            self._buf[step] = b
        return b

    def loader_state_for(self, step: int) -> dict | None:
        """The cursor whose next pull is batch ``step``: the snapshot
        taken before that batch, else the live cursor (not pulled yet)."""
        if not self._stateful:
            return None
        st = self._states.get(step)
        return dict(st) if st is not None else self._it.state_dict()

    def prune_before(self, step: int):
        for s in [s for s in self._buf if s < step]:
            del self._buf[s]
            self._states.pop(s, None)


def _state_device(state: TrainState):
    return tree_leaves(state.params)[0].device


def resilient_train(state: TrainState, step_fn: Callable,
                    data_iter: Iterator, num_steps: int,
                    rcfg: ResilienceConfig | None = None,
                    metrics: Metrics | None = None,
                    fail_injector: Callable | None = None,
                    preempt=None, slo=None,
                    postmortem_dir: str | None = None, cfg=None,
                    controller=None, rebuild_step: Callable | None = None,
                    telemetry_port: int | None = None):
    """Run ``num_steps`` with detection and restore-and-retry recovery.

    ``step_fn(state, batch) -> (state, metrics)``, e.g. from
    :func:`flashmoe_tpu_torch.runtime.trainer.make_train_step`.
    ``fail_injector(step_idx)`` may raise (tests).  ``preempt``: a
    :class:`~flashmoe_tpu_torch.runtime.preempt.PreemptionListener`,
    polled once a step; a notice drains (final checkpoint with the
    loader's cursor) and returns with ``state.step < num_steps``.  A
    stateful ``data_iter`` (``state_dict`` / ``load_state_dict``) has its
    cursor in every manifest and restored on resume.

    ``slo``: an :class:`~flashmoe_tpu_torch.profiler.slo.SLOConfig` (or
    a watchdog) judging every successful step's wall time.
    ``telemetry_port``: the scrape server for the run (``/healthz``
    carries the step, the SLO episode and the last durable checkpoint).
    ``postmortem_dir``: when recovery gives up, a postmortem bundle is
    written there (flight history, decisions, ``cfg`` when given, env,
    traceback) and its path set on the raised error's
    ``postmortem_bundle``.

    ``controller``: a :class:`~flashmoe_tpu_torch.runtime.controller.
    RuntimeController` observes every successful step and may, at a step
    boundary, morph the path or re-place experts.
    ``rebuild_step(overrides) -> step_fn`` rebuilds the step with the
    controller's accumulated ``MoEConfig.replace`` overrides
    (:func:`supervise` provides one); without it, actions that need a
    rebuild are not offered.  Every action forces a checkpoint whose
    manifest carries the controller's plan, and every restore reloads
    the plan the restored state was saved under (rebuilding the step
    when it differs).

    Returns (state, history).  Raises :class:`StepFailure` after
    ``max_retries`` consecutive failures of one step, after a best-effort
    emergency checkpoint of the last good state."""
    from flashmoe_tpu_torch.profiler.slo import as_watchdog

    rcfg = rcfg or ResilienceConfig()
    metrics = metrics or Metrics()
    watchdog = as_watchdog(slo)
    history = []
    device = _state_device(state)
    progress = {"step": None}
    server = None
    if telemetry_port is not None:
        from flashmoe_tpu_torch.runtime.telemetry_hooks import train_server

        server = train_server(
            telemetry_port, cfg, num_steps=num_steps, progress=progress,
            watchdog=watchdog, controller=controller,
            checkpoint_dir=rcfg.checkpoint_dir, metrics_obj=metrics)

    def _ctrl_state():
        return controller.state_dict() if controller is not None else None

    def _ctrl_resync(step: int):
        # a restore landed on some step's params: the controller's plan
        # (morph overrides, replica map) must be the one those params
        # were saved under, and the step rebuilt onto it (budgets stay
        # monotonic: a rewind never refills them)
        nonlocal step_fn
        if controller is None:
            return
        cs = ckpt.load_controller_state(rcfg.checkpoint_dir, step)
        before = controller.cfg_overrides
        controller.load_state_dict(cs or {})
        if rebuild_step is not None \
                and controller.cfg_overrides != before:
            step_fn = rebuild_step(controller.cfg_overrides)

    # resume if a checkpoint exists
    start = ckpt.latest_step(rcfg.checkpoint_dir)
    if start is not None and start > int(state.step):
        state = ckpt.restore(rcfg.checkpoint_dir, state,
                             check_integrity=rcfg.verify_checkpoints)
        metrics.count("resumes")
        _ctrl_resync(int(state.step))
        # the restore may have fallen back to an older intact step
        if ckpt.restore_loader_state(rcfg.checkpoint_dir,
                                     int(state.step), data_iter):
            metrics.count("loader_restores")

    i = int(state.step)
    retries = 0
    # retries count against the step that failed, not reset by a success
    # of an earlier rewound step (a deterministic failure must not livelock)
    last_fail_step = -1
    # the recovery point before the first durable checkpoint: the state
    # itself (the port's step never mutates or donates its input); after
    # it, restores read into a template on 'meta'
    safe_state = state
    abstract = ckpt.abstract_state(state)
    replay = _ReplayBuffer(data_iter)
    ckpt_boundaries: list[int] = []
    ex_box: list = [None]
    try:
        while i < num_steps:
            progress["step"] = i
            if preempt is not None and preempt.requested:
                with trace_span("train.drain"), \
                        prof.section("train.drain", step=i):
                    ckpt.wait_for_saves()
                    if ckpt.latest_step(rcfg.checkpoint_dir) != i:
                        ckpt.save(rcfg.checkpoint_dir, state, step=i,
                                  loader_state=replay.loader_state_for(i),
                                  controller_state=_ctrl_state())
                        metrics.count("checkpoints")
                metrics.count("preempt_drains")
                metrics.decision(
                    "preempt.drain", step=i, source=preempt.source,
                    remaining_grace_s=preempt.remaining_grace_s())
                return state, history
            with trace_span("train.data_pull"), \
                    prof.section("train.data_pull", step=i):
                batch = replay.batch_for(i)
            try:
                if fail_injector is not None:
                    fail_injector(i)
                t0 = time.perf_counter()
                tl = prof.active()
                with trace_span("train.step"):
                    # the step opens inside the span, so the span is a
                    # section of the timeline, not a phase of its step
                    if tl is not None:
                        tl.begin_step(i)
                    with prof.section("train.step", step=i):
                        new_state, m = _run_step(step_fn, state, batch,
                                                 rcfg.step_timeout_s, ex_box)
                    step_phases = (tl.end_step()["phases"]
                                   if tl is not None else None)
                loss = _step_loss(m)
                if loss is not None and not math.isfinite(loss):
                    raise StepFailure(f"non-finite loss at step {i}: {loss}")
            except Exception as e:  # deadline, NaN, device error, injected
                metrics.count("failures")
                if isinstance(e, PathFailure):
                    # demote the failed path before the retry, so that the
                    # retry re-resolves onto a healthy one
                    report_path_failure(e.backend, str(e))
                    metrics.count("path_fallbacks")
                # an async save may be in flight: it must land before
                # latest_step decides where recovery restores from
                ckpt.wait_for_saves()
                if i == last_fail_step:
                    retries += 1
                else:
                    retries, last_fail_step = 1, i
                if retries > rcfg.max_retries:
                    if rcfg.emergency_save:
                        saved = ckpt.emergency_save(
                            rcfg.checkpoint_dir, state,
                            loader_state=replay.loader_state_for(i),
                            controller_state=_ctrl_state())
                        if saved is not None:
                            metrics.count("emergency_saves")
                    raise StepFailure(
                        f"step {i} failed {retries} times; "
                        f"last error: {e}") from e
                last = ckpt.latest_step(rcfg.checkpoint_dir)
                if last is not None:
                    template = safe_state if safe_state is not None \
                        else abstract
                    try:
                        state = ckpt.restore(
                            rcfg.checkpoint_dir, template,
                            check_integrity=rcfg.verify_checkpoints,
                            device=device)
                        _ctrl_resync(int(state.step))
                    except ckpt.CheckpointCorruptionError as ce:
                        if safe_state is None:
                            if rcfg.emergency_save:
                                ckpt.emergency_save(
                                    rcfg.checkpoint_dir, state,
                                    loader_state=replay.loader_state_for(i))
                            raise StepFailure(
                                f"step {i} failed and no intact "
                                f"checkpoint remains: {ce}") from ce
                        state = safe_state
                else:
                    state = safe_state
                i = int(state.step)
                metrics.count("restores")
                continue

            if i > last_fail_step:
                retries = 0
            state = new_state
            metrics.count("steps")
            step_s = time.perf_counter() - t0
            metrics.times["step"].append(step_s)
            if watchdog is not None:
                watchdog.observe_step(i, step_s * 1e3, phases=step_phases)
            if controller is not None:
                controller.observe_step(i, step_s * 1e3, m)
            rec = scalar_metrics(m)
            if rec.get("grad_ok", 1.0) == 0.0:
                # the guard skipped this step's update on the device
                metrics.count("grad_skips")
                metrics.decision("trainer.grad_skip", step=i,
                                 grad_norm=rec.get("grad_norm"),
                                 grad_norm_ema=rec.get("grad_norm_ema"))
            history.append(rec)
            i += 1
            force_ckpt = False
            if controller is not None:
                # the decision point: a morph rebuilds the step on the
                # accumulated overrides; a re-placement permutes the
                # live state (and rebuilds, with a replica).  The action
                # is made durable at once: the next restore must see
                # params and plan from the same side of it
                act = controller.maybe_act(
                    i, can_rebuild=rebuild_step is not None)
                if act is not None:
                    state = controller.apply_action(act, state)
                    if act.needs_rebuild and rebuild_step is not None:
                        step_fn = rebuild_step(controller.cfg_overrides)
                    force_ckpt = True
            if i % rcfg.checkpoint_every == 0 or i == num_steps \
                    or force_ckpt:
                with trace_span("train.checkpoint"), \
                        prof.section("train.checkpoint", step=i):
                    ckpt.save(rcfg.checkpoint_dir, state, step=i,
                              blocking=not rcfg.async_save or force_ckpt,
                              loader_state=replay.loader_state_for(i),
                              controller_state=_ctrl_state())
                ckpt_boundaries.append(i)
                durable = ckpt.latest_step(rcfg.checkpoint_dir)
                # drop the in-memory recovery point once a checkpoint is
                # durable (an enqueued async save is not yet)
                if safe_state is not None and durable is not None:
                    safe_state = None
                # prune the replay buffer one durable checkpoint behind,
                # so a fallback to the previous one still replays exactly
                confirmed = [b for b in ckpt_boundaries
                             if durable is not None and b <= durable]
                if len(confirmed) >= 2:
                    replay.prune_before(confirmed[-2])
                    ckpt_boundaries = [b for b in ckpt_boundaries
                                       if b >= confirmed[-2]]
                metrics.count("checkpoints")
        if rcfg.async_save:
            # the final enqueued save lands before the caller reads it
            ckpt.wait_for_saves()
        return state, history
    except StepFailure as e:
        e.partial_history = list(history)
        if postmortem_dir:
            # recovery gave up: freeze what a triage needs (best-effort:
            # the writer never masks the failure it documents)
            from flashmoe_tpu_torch.profiler import postmortem as pm

            bundle = pm.write_bundle(
                postmortem_dir, error=e, cfg=cfg, metrics_obj=metrics,
                history=history, step=i,
                extra={"retries": retries, "num_steps": num_steps})
            if bundle is not None:
                e.postmortem_bundle = bundle
        raise
    finally:
        if server is not None:
            server.stop()
        if ex_box[0] is not None:
            ex_box[0].shutdown(wait=False)


def _world(devices) -> int:
    """A world size: an int of virtual ranks, or a sequence's length."""
    return devices if isinstance(devices, int) else len(devices)


def supervise(cfg, data_factory: Callable, num_steps: int,
              rcfg: ResilienceConfig | None = None, *,
              guard=None, metrics: Metrics | None = None,
              preempt=None, devices_fn: Callable | None = None,
              max_restarts: int = 3, fail_injector: Callable | None = None,
              step_wrapper: Callable | None = None, seed: int = 0,
              use_kernels: bool | None = None, slo=None,
              postmortem_dir: str | None = None, controller=None,
              telemetry_port: int | None = None, device="cuda"):
    """Job-level restart loop: run to ``num_steps`` across preemptions,
    crashes and world-size changes.

    Each incarnation sizes itself to ``devices_fn()`` (an int of virtual
    ranks of ``device``, or a sequence whose length counts; one rank
    without it), restores the newest checkpoint onto a re-folded mesh
    (:func:`~flashmoe_tpu_torch.runtime.elastic.elastic_resume`, a
    ``supervisor.resume`` decision) or starts from ``seed``, repositions
    ``data_factory(cfg)``'s loader from the manifest, and runs
    :func:`resilient_train`.  A drain ends an incarnation (the notice is
    cleared); a :class:`StepFailure` consumes one of ``max_restarts``.
    ``step_wrapper`` wraps the built step (tests stall it).  ``slo`` (one
    watchdog for the whole job) and ``postmortem_dir`` ride through to
    :func:`resilient_train`; a supervisor-level death (incarnations
    exhausted, refusing to spin) writes its own bundle.
    ``telemetry_port``: one scrape server for the whole job, re-pointed
    at each incarnation's config and mesh.

    ``controller``: a prebuilt :class:`~flashmoe_tpu_torch.runtime.
    controller.RuntimeController`, or one armed by ``rcfg.adapt`` (a
    :class:`~flashmoe_tpu_torch.runtime.controller.ControllerConfig`),
    which the supervisor owns and re-targets to each incarnation's folded
    config (spent budgets and plan carried over).  Each resumed
    incarnation restores the plan from the checkpoint's manifest,
    builds its step on the plan's overrides and hands
    :func:`resilient_train` the rebuild.  A resume onto a new
    incarnation also clears the planner's demoted paths
    (``controller.demotion_reset``): a demotion earned by the dead
    incarnation must not outlive it.  Returns (state, history), history
    over all incarnations."""
    from flashmoe_tpu_torch.runtime.elastic import (elastic_resume,
                                                    fold_parallelism,
                                                    train_mesh)
    from flashmoe_tpu_torch.profiler.slo import as_watchdog
    from flashmoe_tpu_torch.planner.select import (failed_backends,
                                                   reset_path_failures)
    from flashmoe_tpu_torch.runtime.trainer import (init_state,
                                                    make_optimizer,
                                                    make_train_step)

    rcfg = rcfg or ResilienceConfig()
    metrics = metrics or Metrics()
    # a controller built from rcfg.adapt is owned by the supervisor and
    # re-targeted to every incarnation below (a prebuilt one is the
    # caller's)
    own_controller = controller is None and rcfg.adapt is not None
    history: list = []
    restarts = 0
    incarnation = 0
    # one watchdog (one episode state) and one scrape server for the job;
    # the box re-points the server at each incarnation
    watchdog = as_watchdog(slo)
    tbox: dict = {"phase": "supervise",
                  "checkpoint_dir": rcfg.checkpoint_dir,
                  "watchdog": watchdog}
    tserver = None
    if telemetry_port is not None:
        from flashmoe_tpu_torch.runtime.telemetry_hooks import train_server

        tserver = train_server(
            telemetry_port, cfg, num_steps=num_steps, metrics_obj=metrics,
            box=tbox, extra_health=lambda: {
                "steps_done": int(metrics.counters.get("steps", 0))})

    def bundle(err):
        if postmortem_dir:
            from flashmoe_tpu_torch.profiler import postmortem as pm

            pm.write_bundle(postmortem_dir, error=err, cfg=cfg,
                            metrics_obj=metrics, history=history,
                            extra={"incarnation": incarnation,
                                   "restarts": restarts})

    # drains do not consume restarts, but a notice stuck on "always
    # preempted" must not loop forever either
    max_incarnations = max(8, 4 * (max_restarts + 1))
    try:
        while True:
            if incarnation >= max_incarnations:
                e = StepFailure(
                    f"supervisor exceeded {max_incarnations} incarnations "
                    f"without reaching step {num_steps}")
                bundle(e)
                raise e
            world = _world(devices_fn()) if devices_fn is not None else 1
            resumed_step = None
            if ckpt.latest_step(rcfg.checkpoint_dir) is not None:
                state, mesh, fcfg, opt = elastic_resume(
                    cfg, rcfg.checkpoint_dir, devices=world, guard=guard,
                    total_steps=num_steps, device=device)
                metrics.decision(
                    "supervisor.resume", incarnation=incarnation,
                    step=int(state.step), world=world, ep=fcfg.ep,
                    dp=fcfg.dp)
                # the dead incarnation's path demotions describe a world
                # that may be gone: the planner re-evaluates every path
                stale = sorted(failed_backends())
                if stale:
                    reset_path_failures()
                    metrics.decision(
                        "controller.demotion_reset",
                        incarnation=incarnation, world=world, ep=fcfg.ep,
                        dp=fcfg.dp, dropped=stale)
                resumed_step = int(state.step)
            else:
                fcfg = fold_parallelism(cfg, world)
                mesh = train_mesh(fcfg, world, device)
                opt = make_optimizer(fcfg, total_steps=num_steps)
                gen = torch.Generator(device=device).manual_seed(seed)
                state = init_state(gen, fcfg, opt, guard=guard)
            if own_controller:
                # re-target the controller to this incarnation's folded
                # world (placement math and morph re-selection describe
                # what runs); the plan and spent budgets carry over, and
                # the manifest below pins the plan to the resumed params
                from flashmoe_tpu_torch.runtime.controller import (
                    RuntimeController)

                prev = controller
                controller = RuntimeController(fcfg, rcfg.adapt,
                                               metrics=metrics,
                                               device=device)
                if prev is not None:
                    controller.load_state_dict(prev.state_dict())
            if controller is not None and resumed_step is not None:
                cs = ckpt.load_controller_state(rcfg.checkpoint_dir,
                                                resumed_step)
                controller.load_state_dict(cs or {})
            data = data_factory(fcfg)
            if ckpt.restore_loader_state(rcfg.checkpoint_dir,
                                         int(state.step), data):
                metrics.count("loader_restores")

            def build_step(overrides: dict, _fcfg=fcfg, _mesh=mesh,
                           _opt=opt):
                scfg = _fcfg.replace(**overrides) if overrides else _fcfg
                sf = make_train_step(scfg, _opt, guard=guard,
                                     use_kernels=use_kernels, mesh=_mesh)
                return step_wrapper(sf) if step_wrapper is not None else sf

            step_fn = build_step(
                controller.cfg_overrides if controller is not None else {})
            tbox.update(cfg=fcfg, mesh=mesh, controller=controller,
                        health={"incarnation": incarnation,
                                "restarts": restarts, "world": world})
            incarnation += 1
            try:
                state, hist = resilient_train(
                    state, step_fn, data, num_steps, rcfg=rcfg,
                    metrics=metrics, fail_injector=fail_injector,
                    preempt=preempt, slo=watchdog,
                    postmortem_dir=postmortem_dir, cfg=fcfg,
                    controller=controller, rebuild_step=build_step)
                history.extend(hist)
            except StepFailure as e:
                # in-job recovery exhausted: the scheduler would restart
                # the process; here the next incarnation does
                history.extend(getattr(e, "partial_history", []))
                restarts += 1
                metrics.count("supervisor_restarts")
                if restarts > max_restarts:
                    e.partial_history = list(history)
                    raise
                continue
            if int(state.step) >= num_steps:
                return state, history
            if preempt is not None and preempt.requested:
                preempt.clear()
                metrics.count("preempt_restarts")
                continue
            e = StepFailure(
                f"incarnation ended at step {int(state.step)} of "
                f"{num_steps} with no drain and no failure: refusing to "
                f"spin")
            bundle(e)
            raise e
    finally:
        if tserver is not None:
            tserver.stop()
