"""Training loop: AdamW train step with the gradient guard, on one device
or over a mesh.

Counterpart of ``flashmoe_tpu/runtime/trainer.py:27-219``.  A mesh (dp x
pp x ep x tp x sp virtual ranks of one device,
:mod:`flashmoe_tpu_torch.parallel.mesh`) reaches the model through
``make_train_step(..., mesh=)``: the batch shards over dp, the MoE
layers' tokens over (dp, ep[, sp]), attention over sp.
:func:`state_shardings` gives the train state's placement specs, JAX's
for JAX's.  :func:`train` has JAX's flight recorder, its
``trainer.step_ms`` histogram and its ``trainer.grad_skip`` decision
(``trainer.py:248-395``), its SLO watchdog, scrape server, profiler
sections and runtime controller.  The
optimizer is optax's chain written out as plain functions on tensors,
so that it can be held against optax step for step:
``clip_by_global_norm(1.0)``, then ``adamw`` over
``warmup_cosine_decay_schedule`` with the moments kept in the parameter
dtype, as optax keeps them.  (``torch.optim.AdamW`` clips and decays in
its own order.)  Every decision of a step, the guard's included, stays on
the device: nothing waits for the host.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, NamedTuple

import torch

from flashmoe_tpu_torch.chaos import inject as chaos_inject
from flashmoe_tpu_torch.config import MoEConfig
from flashmoe_tpu_torch.models import transformer
from flashmoe_tpu_torch.ops.stats import stats_to_host
from flashmoe_tpu_torch.parallel.mesh import transformer_param_specs
from flashmoe_tpu_torch.tree import tree_leaves, tree_map, tree_map_with_path
from flashmoe_tpu_torch.utils.telemetry import FlightRecorder
from flashmoe_tpu_torch.utils.telemetry import metrics as _telemetry


class AdamWState(NamedTuple):
    """optax's ``ScaleByAdamState`` (count, mu, nu); its
    ``ScaleByScheduleState.count`` always equals ``count``."""

    count: torch.Tensor  # [] int32 updates applied
    mu: Any              # first moments, the parameter tree's nesting
    nu: Any              # second moments


class TrainState(NamedTuple):
    params: Any
    opt_state: AdamWState
    step: torch.Tensor  # [] int32
    # GuardState when the step was built with a GradGuardConfig
    guard: Any = None


class GuardState(NamedTuple):
    """Running statistics for the tier-1 gradient anomaly guard."""

    norm_ema: torch.Tensor  # EMA of the (finite, accepted) grad norms
    seen: torch.Tensor      # accepted steps feeding the EMA (warmup gate)


@dataclasses.dataclass(frozen=True)
class GradGuardConfig:
    """Tier-1 fault tolerance: per-step gradient anomaly guard.

    A non-finite gradient or a grad-norm spike costs one skipped
    optimizer update (params, optimizer state and EMA kept by a select)
    instead of a checkpoint rewind.  ``spike_factor``: skip when grad_norm
    > spike_factor * EMA, once ``warmup_steps`` accepted norms have seeded
    the EMA.  ``ema_decay``: EMA decay per accepted step; skipped steps do
    not move the EMA."""

    skip_nonfinite: bool = True
    spike_factor: float = 10.0
    ema_decay: float = 0.99
    warmup_steps: int = 10


def init_guard_state(device="cuda") -> GuardState:
    return GuardState(torch.zeros((), dtype=torch.float32, device=device),
                      torch.zeros((), dtype=torch.int32, device=device))


class Optimizer(NamedTuple):
    """optax's ``GradientTransformation``: ``init(params) -> state`` and
    ``update(grads, state, params) -> (updates, state)``."""

    init: Callable
    update: Callable


def global_norm(tree) -> torch.Tensor:
    """``optax.global_norm``: sqrt of the sum of each leaf's sum of
    squares, each leaf's sum in its own dtype."""
    return torch.sqrt(sum(torch.sum(g * g) for g in tree_leaves(tree)))


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int):
    """optax's schedule of the same name (end value 0): linear from
    ``init_value`` to ``peak_value`` over ``warmup_steps``, then cosine
    decay to 0 at ``decay_steps``.  Maps an int count tensor to an f32
    tensor on its device."""
    cos_steps = float(decay_steps - warmup_steps)

    def schedule(count):
        c = count.float()
        frac = 1 - torch.clamp(c, 0, warmup_steps) / warmup_steps
        warm = (init_value - peak_value) * frac + peak_value
        t = torch.clamp(c - warmup_steps, max=cos_steps)
        cosine = 0.5 * (1 + torch.cos(math.pi * t / cos_steps))
        decayed = peak_value * cosine
        return torch.where(c < warmup_steps, warm, decayed)

    return schedule


# the JAX trainer's fixed AdamW constants (optax.adamw's b1, b2, eps) and
# its clip_by_global_norm bound
B1, B2, EPS, MAX_NORM = 0.9, 0.95, 1e-8, 1.0


def make_optimizer(cfg: MoEConfig, lr: float = 3e-4,
                   weight_decay: float = 0.1, warmup_steps: int = 100,
                   total_steps: int = 10000) -> Optimizer:
    """``optax.chain(clip_by_global_norm(1.0), adamw(sched, b1=0.9,
    b2=0.95, eps=1e-8, weight_decay))`` with ``sched =
    warmup_cosine_decay_schedule(0, lr, warmup_steps, max(total_steps,
    warmup_steps + 1))``, as the JAX ``make_optimizer``."""
    sched = warmup_cosine_decay_schedule(
        0.0, lr, warmup_steps, max(total_steps, warmup_steps + 1))

    def init(params) -> AdamWState:
        leaf = tree_leaves(params)[0]
        return AdamWState(
            torch.zeros((), dtype=torch.int32, device=leaf.device),
            tree_map(torch.zeros_like, params),
            tree_map(torch.zeros_like, params))

    def update(grads, state: AdamWState, params):
        # clip_by_global_norm, applied leaf by leaf where it is used so
        # that no clipped copy of the whole gradient tree is held
        g_norm = global_norm(grads)
        keep = g_norm < MAX_NORM

        def clip(g):
            return torch.where(keep, g, (g / g_norm.to(g.dtype)) * MAX_NORM)

        # scale_by_adam
        mu = tree_map(lambda g, m: (1 - B1) * clip(g) + B1 * m, grads,
                      state.mu)
        nu = tree_map(lambda g, v: (1 - B2) * clip(g) ** 2 + B2 * v, grads,
                      state.nu)
        count = state.count + 1
        c1 = 1 - torch.pow(torch.tensor(B1, device=count.device),
                           count.float())
        c2 = 1 - torch.pow(torch.tensor(B2, device=count.device),
                           count.float())
        step = (-sched(state.count))  # scale_by_learning_rate
        updates = tree_map(
            lambda m, v, p: step.to(p.dtype) * (
                (m / c1.to(m.dtype)) / (torch.sqrt(v / c2.to(v.dtype)) + EPS)
                + weight_decay * p),
            mu, nu, params)
        return updates, AdamWState(count, mu, nu)

    return Optimizer(init, update)


def apply_updates(params, updates):
    """``optax.apply_updates``: p + u in p's dtype."""
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def init_state(generator: torch.Generator, cfg: MoEConfig,
               optimizer: Optimizer,
               guard: GradGuardConfig | None = None) -> TrainState:
    """Random parameters (on the generator's device) and a fresh optimizer
    state."""
    params = transformer.init_params(generator, cfg)
    dev = generator.device
    return TrainState(params, optimizer.init(params),
                      torch.zeros((), dtype=torch.int32, device=dev),
                      init_guard_state(dev) if guard is not None else None)


def _leaves_with_paths(tree, is_leaf=None) -> list:
    out = []
    tree_map_with_path(lambda p, leaf: out.append((p, leaf)), tree, is_leaf)
    return out


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        a is None or isinstance(a, (str, tuple)) for a in x)


def state_shardings(state: TrainState, cfg: MoEConfig, mesh=None):
    """The train state's placement specs (``trainer.py:92``): a
    :class:`TrainState` of specs, each a tuple of mesh axis names (or
    None) per dimension (:mod:`flashmoe_tpu_torch.parallel.mesh`;
    ``()`` replicated), equal to JAX's ``NamedSharding`` specs.  Params
    follow :func:`~flashmoe_tpu_torch.parallel.mesh.
    transformer_param_specs`; an optimizer leaf takes the spec of the
    parameter whose key path ends its own and whose shape it has (shape
    alone would alias an ep-sharded and a replicated leaf of one shape),
    and everything else (counts, the step, the guard) is replicated.
    ``mesh`` is not read: the specs depend on the config alone."""
    pspecs = transformer_param_specs(cfg)
    spec_of = dict(_leaves_with_paths(pspecs, _is_spec))
    by_path = {path: (tuple(leaf.shape), spec_of[path])
               for path, leaf in _leaves_with_paths(state.params)}

    def match(path, leaf):
        for start in range(len(path)):
            hit = by_path.get(path[start:])
            if hit is not None and tuple(getattr(leaf, "shape", ())) \
                    == hit[0]:
                return hit[1]
        return ()

    return TrainState(pspecs, tree_map_with_path(match, state.opt_state),
                      (), tree_map_with_path(lambda *_: (), state.guard))


def make_train_step(cfg: MoEConfig, optimizer: Optimizer,
                    guard: GradGuardConfig | None = None,
                    use_kernels: bool | None = None, *,
                    mesh=None) -> Callable:
    """Build ``step(state, batch) -> (state, metrics)``.

    ``mesh``: the model's mesh (:mod:`flashmoe_tpu_torch.parallel.mesh`,
    its axes the config's), None for one device.  The batch shards over
    dp (JAX's ``P("dp", None)``) and the MoE layers' tokens over (dp,
    ep[, sp]).  JAX's step takes the mean of the dp replicas' gradients
    by an all-reduce; on a local mesh every rank's graph is part of the
    one loss of the global batch, so autograd gives that mean as it is.
    The state lives whole on the device of the local mesh;
    :func:`state_shardings` says where each leaf's blocks would live.

    ``guard`` arms the gradient anomaly guard: the state must then carry a
    :class:`GuardState` (``init_state(..., guard=guard)``), and the metrics
    gain ``grad_ok`` (1.0 = update applied, 0.0 = skipped) and
    ``grad_norm_ema``.  Metrics are 0-d tensors on the device."""
    # the training entry point implies is_training (per-block remat)
    if not cfg.is_training:
        cfg = cfg.replace(is_training=True)

    def step_fn(state: TrainState, batch):
        loss, metrics, grads = transformer.value_and_grad(
            state.params, batch, cfg, use_kernels, mesh=mesh)
        if (chaos_inject.is_armed("nan_grad")
                or chaos_inject.is_armed("grad_spike")):
            grads = chaos_inject.poison_grads(grads, state.step)
        gnorm = global_norm(grads)
        metrics = dict(metrics, loss=loss, grad_norm=gnorm)
        if guard is None:
            updates, opt_state = optimizer.update(grads, state.opt_state,
                                                  state.params)
            params = apply_updates(state.params, updates)
            return TrainState(params, opt_state, state.step + 1,
                              state.guard), metrics

        # decide, then select: every branch stays on the device
        gs: GuardState = state.guard
        finite = torch.isfinite(gnorm)
        warm = gs.seen >= guard.warmup_steps
        spike = warm & (gnorm > guard.spike_factor
                        * torch.clamp(gs.norm_ema, min=1e-30))
        ok = (finite if guard.skip_nonfinite
              else torch.ones_like(finite)) & ~spike
        # a non-finite gradient never reaches the optimizer, even on a
        # skipped step: zeros take its place
        safe = tree_map(lambda g: torch.where(ok, g, torch.zeros_like(g)),
                        grads)
        updates, new_opt = optimizer.update(safe, state.opt_state,
                                            state.params)
        new_params = apply_updates(state.params, updates)

        def sel(new, old):
            return tree_map(lambda n, o: torch.where(ok, n, o), new, old)

        params = sel(new_params, state.params)
        opt_state = sel(new_opt, state.opt_state)
        decay = torch.tensor(guard.ema_decay, dtype=torch.float32,
                             device=gnorm.device)
        ema_next = torch.where(gs.seen > 0,
                               decay * gs.norm_ema + (1 - decay) * gnorm,
                               gnorm.float())
        new_guard = GuardState(torch.where(ok, ema_next, gs.norm_ema),
                               gs.seen + ok.to(gs.seen.dtype))
        metrics = dict(metrics, grad_ok=ok.float(),
                       grad_norm_ema=new_guard.norm_ema)
        return TrainState(params, opt_state, state.step + 1,
                          new_guard), metrics

    return step_fn


def host_metrics(step_metrics: dict, moe_layers=None) -> dict:
    """A step's metrics as one JSON-ready dict (``host_metrics``): scalars
    to floats, and the MoE layers' stats (``moe_stats``, present with
    ``cfg.collect_stats``) to a ``moe`` list of flight-recorder dicts,
    each with its transformer ``layer`` from ``moe_layers`` (by default
    its position)."""
    out: dict = {}
    for k, v in step_metrics.items():
        if k == "moe_stats":
            out["moe"] = [
                dict(layer=(moe_layers[i] if moe_layers is not None
                            and i < len(moe_layers) else i),
                     **stats_to_host(st))
                for i, st in enumerate(v)]
        else:
            out[k] = float(v)
    return out


def train(cfg: MoEConfig, data_iter, num_steps: int,
          generator: torch.Generator | None = None, log_every: int = 10,
          state: TrainState | None = None,
          guard: GradGuardConfig | None = None,
          use_kernels: bool | None = None, *, mesh=None,
          recorder: FlightRecorder | None = None,
          flight_path: str | None = None, flight_flush_every: int = 0,
          slo=None, controller=None, telemetry_port: int | None = None):
    """Simple host training loop (over ``mesh``, as
    :func:`make_train_step`).  Returns ``(state, history)``: history
    holds the metrics of every ``log_every``-th step and of the last one,
    as floats, with ``step_ms`` (host clock, the step ended by reading its
    metrics back).  Without ``state`` the parameters are drawn from
    ``generator``, by default one on the card seeded with 0.

    ``recorder``: a :class:`~flashmoe_tpu_torch.utils.telemetry.
    FlightRecorder` that records every step (each step is then timed);
    with ``flight_path`` one is made if needed and exported there at the
    end, and ``flight_flush_every`` > 0 appends the new records every
    that many steps (the offset-aware export).  Every timed step feeds
    the global ``trainer.step_ms`` histogram, and a step whose update the
    guard skipped records a ``trainer.grad_skip`` decision.

    ``slo``: an :class:`~flashmoe_tpu_torch.profiler.slo.SLOConfig` (or a
    watchdog): every step is timed and judged against its budgets
    (``slo.breach`` / ``slo.recovered``; sustained breaches demote the
    configured path).  ``telemetry_port``: serve ``/metrics``,
    ``/healthz`` (step progress, SLO episode) and ``/vars`` for the
    loop's duration.  With a profiler timeline armed
    (:func:`flashmoe_tpu_torch.profiler.spans.profiling`) the loop's host
    work is recorded as ``train.data_pull`` / ``train.step`` sections and
    each timed step as a timeline step.

    ``controller``: a :class:`~flashmoe_tpu_torch.runtime.controller.
    RuntimeController` observes every step (each is then timed) and, at
    each step boundary, may act: a re-placement permutes the live state,
    and an action that needs it rebuilds the step with
    ``cfg.replace(**controller.cfg_overrides)``.  This loop writes no
    checkpoint, so its plan is not durable: ``resilient_train`` and
    ``supervise`` keep it in their manifests."""
    from flashmoe_tpu_torch.profiler import spans as prof
    from flashmoe_tpu_torch.profiler.slo import as_watchdog

    optimizer = make_optimizer(cfg, total_steps=num_steps)
    if state is None:
        if generator is None:
            generator = torch.Generator(device="cuda").manual_seed(0)
        state = init_state(generator, cfg, optimizer, guard=guard)
    step = make_train_step(cfg, optimizer, guard=guard,
                           use_kernels=use_kernels, mesh=mesh)
    if flight_path is not None and recorder is None:
        recorder = FlightRecorder()
    watchdog = as_watchdog(slo)
    history = []
    flushed = 0  # the offset-aware export's cursor
    progress = {"step": 0}
    server = None
    if telemetry_port is not None:
        from flashmoe_tpu_torch.runtime.telemetry_hooks import train_server

        server = train_server(telemetry_port, cfg, mesh,
                              num_steps=num_steps, progress=progress,
                              watchdog=watchdog, controller=controller)
    try:
        for i in range(num_steps):
            progress["step"] = i
            with prof.section("train.data_pull", step=i):
                batch = next(data_iter)
            log_step = i % log_every == 0 or i == num_steps - 1
            tl = prof.active()
            if recorder is None and not log_step and watchdog is None \
                    and tl is None and controller is None:
                with prof.section("train.step", step=i):
                    state, metrics = step(state, batch)
                continue
            t0 = time.perf_counter()
            if tl is not None:
                tl.begin_step(i)
            with prof.section("train.step", step=i):
                state, metrics = step(state, batch)
                # reading the metrics back ends the step on the device
                rec = host_metrics(metrics, cfg.moe_layer_indices)
            phases = tl.end_step()["phases"] if tl is not None else None
            rec["step_ms"] = (time.perf_counter() - t0) * 1e3
            _telemetry.histogram("trainer.step_ms", rec["step_ms"])
            if watchdog is not None:
                watchdog.observe_step(i, rec["step_ms"], phases=phases)
            if controller is not None:
                controller.observe_step(i, rec["step_ms"], metrics)
                act = controller.maybe_act(i + 1)
                if act is not None:
                    # the action at the step boundary: permute the live
                    # state (re-placement) and rebuild the step on the
                    # controller's accumulated overrides where needed
                    state = controller.apply_action(act, state)
                    if act.needs_rebuild:
                        step = make_train_step(
                            cfg.replace(**controller.cfg_overrides),
                            optimizer, guard=guard,
                            use_kernels=use_kernels, mesh=mesh)
            if rec.get("grad_ok", 1.0) == 0.0:
                _telemetry.decision("trainer.grad_skip", step=i,
                                    grad_norm=rec.get("grad_norm"),
                                    grad_norm_ema=rec.get("grad_norm_ema"))
            if recorder is not None:
                recorder.record(step=i, **rec)
                if flight_path is not None and flight_flush_every > 0 \
                        and (i + 1) % flight_flush_every == 0:
                    flushed = recorder.export_jsonl(flight_path,
                                                    start=flushed)
            if log_step:
                history.append(rec)
        if flight_path is not None and recorder is not None:
            if flight_flush_every > 0:
                recorder.export_jsonl(flight_path, start=flushed)
            else:
                recorder.export_jsonl(flight_path)
        return state, history
    finally:
        if server is not None:
            server.stop()
