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

Not ported: JAX's ``PathFailure`` branch (it demotes a planner path; the
port has no planner), and the host-side planes (``slo``,
``controller``, ``telemetry_port``, ``postmortem_dir``,
``ResilienceConfig.adapt``), refused naming their ROADMAP item.  The
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

from flashmoe_tpu_torch.runtime import checkpoint as ckpt
from flashmoe_tpu_torch.runtime.trainer import TrainState
from flashmoe_tpu_torch.tree import tree_leaves
from flashmoe_tpu_torch.utils.telemetry import Metrics, trace_span

_PLANES = "Host-side planes"


def refuse_planes(**kw) -> None:
    """Raise ``NotImplementedError`` naming the ROADMAP item for each
    host-side plane argument that is set."""
    for name, val in kw.items():
        if val is not None:
            raise NotImplementedError(
                f"{name} is not ported yet: it waits for the ROADMAP item "
                f"'{_PLANES}'")


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
    # the runtime controller's config (Host-side planes): refused
    adapt: object | None = None

    def __post_init__(self):
        refuse_planes(**{"ResilienceConfig.adapt": self.adapt})


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
                    postmortem_dir: str | None = None, controller=None,
                    telemetry_port: int | None = None):
    """Run ``num_steps`` with detection and restore-and-retry recovery.

    ``step_fn(state, batch) -> (state, metrics)``, e.g. from
    :func:`flashmoe_tpu_torch.runtime.trainer.make_train_step`.
    ``fail_injector(step_idx)`` may raise (tests).  ``preempt``: a
    :class:`~flashmoe_tpu_torch.runtime.preempt.PreemptionListener`,
    polled once a step; a notice drains (final checkpoint with the
    loader's cursor) and returns with ``state.step < num_steps``.  A
    stateful ``data_iter`` (``state_dict`` / ``load_state_dict``) has its
    cursor in every manifest and restored on resume.  ``slo``,
    ``postmortem_dir``, ``controller`` and ``telemetry_port`` raise
    ``NotImplementedError`` ("Host-side planes").

    Returns (state, history).  Raises :class:`StepFailure` after
    ``max_retries`` consecutive failures of one step, after a best-effort
    emergency checkpoint of the last good state."""
    refuse_planes(slo=slo, postmortem_dir=postmortem_dir,
                  controller=controller, telemetry_port=telemetry_port)
    rcfg = rcfg or ResilienceConfig()
    metrics = metrics or Metrics()
    history = []
    device = _state_device(state)

    # resume if a checkpoint exists
    start = ckpt.latest_step(rcfg.checkpoint_dir)
    if start is not None and start > int(state.step):
        state = ckpt.restore(rcfg.checkpoint_dir, state,
                             check_integrity=rcfg.verify_checkpoints)
        metrics.count("resumes")
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
            if preempt is not None and preempt.requested:
                with trace_span("train.drain"):
                    ckpt.wait_for_saves()
                    if ckpt.latest_step(rcfg.checkpoint_dir) != i:
                        ckpt.save(rcfg.checkpoint_dir, state, step=i,
                                  loader_state=replay.loader_state_for(i))
                        metrics.count("checkpoints")
                metrics.count("preempt_drains")
                metrics.decision(
                    "preempt.drain", step=i, source=preempt.source,
                    remaining_grace_s=preempt.remaining_grace_s())
                return state, history
            with trace_span("train.data_pull"):
                batch = replay.batch_for(i)
            try:
                if fail_injector is not None:
                    fail_injector(i)
                t0 = time.perf_counter()
                with trace_span("train.step"):
                    new_state, m = _run_step(step_fn, state, batch,
                                             rcfg.step_timeout_s, ex_box)
                loss = _step_loss(m)
                if loss is not None and not math.isfinite(loss):
                    raise StepFailure(f"non-finite loss at step {i}: {loss}")
            except Exception as e:  # deadline, NaN, device error, injected
                metrics.count("failures")
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
                            loader_state=replay.loader_state_for(i))
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
            metrics.times["step"].append(time.perf_counter() - t0)
            rec = scalar_metrics(m)
            if rec.get("grad_ok", 1.0) == 0.0:
                # the guard skipped this step's update on the device
                metrics.count("grad_skips")
                metrics.decision("trainer.grad_skip", step=i,
                                 grad_norm=rec.get("grad_norm"),
                                 grad_norm_ema=rec.get("grad_norm_ema"))
            history.append(rec)
            i += 1
            if i % rcfg.checkpoint_every == 0 or i == num_steps:
                with trace_span("train.checkpoint"):
                    ckpt.save(rcfg.checkpoint_dir, state, step=i,
                              blocking=not rcfg.async_save,
                              loader_state=replay.loader_state_for(i))
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
        raise
    finally:
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
    ``step_wrapper`` wraps the built step (tests stall it).  The planes
    (``slo``, ``postmortem_dir``, ``controller``, ``telemetry_port``,
    ``rcfg.adapt``) raise ``NotImplementedError``.  Returns (state,
    history), history over all incarnations."""
    from flashmoe_tpu_torch.runtime.elastic import (elastic_resume,
                                                    fold_parallelism,
                                                    train_mesh)
    from flashmoe_tpu_torch.runtime.trainer import (init_state,
                                                    make_optimizer,
                                                    make_train_step)

    refuse_planes(slo=slo, postmortem_dir=postmortem_dir,
                  controller=controller, telemetry_port=telemetry_port)
    rcfg = rcfg or ResilienceConfig()
    metrics = metrics or Metrics()
    history: list = []
    restarts = 0
    incarnation = 0
    # drains do not consume restarts, but a notice stuck on "always
    # preempted" must not loop forever either
    max_incarnations = max(8, 4 * (max_restarts + 1))
    while True:
        if incarnation >= max_incarnations:
            raise StepFailure(
                f"supervisor exceeded {max_incarnations} incarnations "
                f"without reaching step {num_steps}")
        world = _world(devices_fn()) if devices_fn is not None else 1
        if ckpt.latest_step(rcfg.checkpoint_dir) is not None:
            state, mesh, fcfg, opt = elastic_resume(
                cfg, rcfg.checkpoint_dir, devices=world, guard=guard,
                total_steps=num_steps, device=device)
            metrics.decision(
                "supervisor.resume", incarnation=incarnation,
                step=int(state.step), world=world, ep=fcfg.ep, dp=fcfg.dp)
        else:
            fcfg = fold_parallelism(cfg, world)
            mesh = train_mesh(fcfg, world, device)
            opt = make_optimizer(fcfg, total_steps=num_steps)
            gen = torch.Generator(device=device).manual_seed(seed)
            state = init_state(gen, fcfg, opt, guard=guard)
        data = data_factory(fcfg)
        if ckpt.restore_loader_state(rcfg.checkpoint_dir, int(state.step),
                                     data):
            metrics.count("loader_restores")
        step_fn = make_train_step(fcfg, opt, guard=guard,
                                  use_kernels=use_kernels, mesh=mesh)
        if step_wrapper is not None:
            step_fn = step_wrapper(step_fn)
        incarnation += 1
        try:
            state, hist = resilient_train(
                state, step_fn, data, num_steps, rcfg=rcfg, metrics=metrics,
                fail_injector=fail_injector, preempt=preempt)
            history.extend(hist)
        except StepFailure as e:
            # in-job recovery exhausted: the scheduler would restart the
            # process; here the next incarnation does
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
        raise StepFailure(
            f"incarnation ended at step {int(state.step)} of {num_steps} "
            f"with no drain and no failure: refusing to spin")
