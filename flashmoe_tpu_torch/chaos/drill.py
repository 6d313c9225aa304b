"""Chaos drills: prove each fault class recovers at its intended tier.

Counterpart of ``flashmoe_tpu/chaos/drill.py:1-500, 970-1147``.  One
drill = one :class:`flashmoe_tpu_torch.chaos.FaultPlan` run against a
small real training job under :func:`flashmoe_tpu_torch.runtime.
resilient.resilient_train` with the full ladder armed (tier-0 expert
masking, tier-1 gradient guard, tier-2 verified checkpoints and path
fallback, tier-3 supervised restarts, the runtime controller).  The
drill then reads the run back: did training reach the last step, how
many steps of work were re-executed, and does the telemetry carry
evidence that the intended tier absorbed the fault
(:data:`flashmoe_tpu_torch.chaos.EXPECTED_TIER`)?

The serving-fabric faults (tiers ``monitor:*`` and ``fabric:*``) run
against the serving fabric, which the port does not have yet:
:func:`run_drill` refuses them, and :func:`run_matrix` runs the other
faults by default (:data:`TRAINING_FAULTS`).  The drills run on the
card unless the caller passes ``device="cpu"``; the supervised drills'
worlds are virtual ranks of that device.

``python -m flashmoe_tpu_torch.chaos`` runs the matrix.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time

import numpy as np
import torch

from flashmoe_tpu_torch.chaos import (
    EXPECTED_TIER, FAULTS, FaultPlan, arm_plan, clear, inject,
    make_injector, wrap_step,
)
from flashmoe_tpu_torch.config import MoEConfig
from flashmoe_tpu_torch.runtime.resilient import (
    ResilienceConfig, StepFailure, resilient_train,
)
from flashmoe_tpu_torch.runtime.trainer import (
    GradGuardConfig, init_state, make_optimizer, make_train_step,
)
from flashmoe_tpu_torch.utils.telemetry import Metrics, metrics as global_metrics

_FABRIC = "Serving fabric"

#: the faults the port drills: every fault whose tier is not the serving
#: fabric's (``monitor:*`` / ``fabric:*``)
TRAINING_FAULTS = tuple(
    f for f in FAULTS
    if not EXPECTED_TIER[f].startswith(("monitor:", "fabric:")))


def drill_config(**overrides) -> MoEConfig:
    """The drill model: small enough to train in seconds, MoE enough (4
    experts, top-2, capacity drops possible) that every tier-0 path is
    exercised.  The full ladder is armed."""
    base = dict(num_experts=4, expert_top_k=2, hidden_size=64,
                intermediate_size=128, sequence_len=32, num_layers=1,
                moe_frequency=1, vocab_size=256, num_heads=2,
                drop_tokens=True, capacity_factor=1.5, is_training=True,
                dtype=torch.float32, param_dtype=torch.float32,
                degrade_unhealthy_experts=True, collect_stats=True)
    base.update(overrides)
    return MoEConfig(**base)


def data_stream(cfg: MoEConfig, batch: int = 2, seed: int = 0,
                device="cuda"):
    """Deterministic seeded batch stream: batch ``i`` is drawn from its
    own numpy generator seeded by ``(seed, i)``, so two streams with one
    seed are identical (what the replay assertions lean on)."""
    i = 0
    while True:
        rng = np.random.default_rng(seed * 100003 + i)
        yield {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, size=(batch, cfg.sequence_len + 1),
            dtype=np.int64)).to(device)}
        i += 1


@dataclasses.dataclass
class DrillResult:
    fault: str
    expected_tier: str
    recovered: bool
    reason: str            # why recovered is False ("" when True)
    final_step: int
    steps_rerun: int       # loss of work: successful step executions
                           # beyond num_steps (replays after rewinds)
    wall_s: float
    evidence: dict         # telemetry proof the intended tier fired
    decisions: list        # structured decisions recorded during the run

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _stats_probe(cfg: MoEConfig, params, key=11, device="cuda"):
    """One armed forward through the MoE layer, returning host stats:
    the tier-0 evidence reader (masked experts, imbalance, drops)."""
    from flashmoe_tpu_torch.ops.moe import moe_layer
    from flashmoe_tpu_torch.ops.stats import stats_to_host

    moe_params = params["layers"][0]["moe"]
    g = torch.Generator(device=device).manual_seed(key)
    x = torch.randn((cfg.tokens, cfg.hidden_size), generator=g,
                    dtype=torch.float32, device=device)
    with torch.no_grad():
        out = moe_layer(moe_params, x.to(cfg.dtype), cfg)
    return stats_to_host(out.stats), out


def _token_file(tmp: str, cfg: MoEConfig, seed: int,
                windows: int = 24) -> str:
    """A deterministic token shard for the supervised drills: a real
    TokenLoader makes the data-exactness claim end to end (its cursor
    rides the checkpoint manifest and must replay the same stream after
    a restart)."""
    from flashmoe_tpu_torch.runtime.data import write_token_file

    path = os.path.join(tmp, "tokens.bin")
    rng = np.random.default_rng(seed)
    write_token_file(path, rng.integers(
        0, cfg.vocab_size, size=windows * (cfg.sequence_len + 1),
        dtype=np.int32))
    return path


def _run_supervised_drill(fault: str, *, num_steps: int,
                          checkpoint_every: int, workdir: str | None,
                          seed: int, batch: int, device) -> DrillResult:
    """Drill the job-level (tier-3) faults through the supervisor:
    ``preempt`` (graceful drain and resume) and ``device_loss`` (the
    restart re-folds parallelism onto the surviving ranks: a world of 2
    virtual ranks shrinks to 1)."""
    from flashmoe_tpu_torch.runtime import checkpoint as ckpt_mod
    from flashmoe_tpu_torch.runtime.data import TokenLoader
    from flashmoe_tpu_torch.runtime.preempt import PreemptionListener
    from flashmoe_tpu_torch.runtime.resilient import supervise

    plan = FaultPlan(fault, step=3, seed=seed)
    clear()
    tmp = workdir or tempfile.mkdtemp(prefix=f"chaos_{fault}_")
    ckpt_dir = os.path.join(tmp, "ckpt")
    pm_dir = os.path.join(tmp, "postmortem")
    cfg = drill_config()
    token_path = _token_file(tmp, cfg, seed)

    world0 = 2 if fault == "device_loss" else 1
    injector_box: dict = {}

    def devices_fn():
        # device_loss: the first incarnation's world shrinks once the
        # fault has killed the process: the restart sees the survivors
        if fault == "device_loss" and injector_box.get("exhausted"):
            return 1
        return world0

    rcfg = ResilienceConfig(checkpoint_dir=ckpt_dir,
                            checkpoint_every=checkpoint_every,
                            max_retries=3,
                            async_save=(fault == "preempt"))
    guard = GradGuardConfig(warmup_steps=2, spike_factor=10.0)
    preempt = PreemptionListener(grace_s=30.0)
    metrics = Metrics()
    base_injector = make_injector(plan, rcfg, preempt=preempt)

    def injector(i):
        try:
            base_injector(i)
        except Exception:
            # the retry budget is max_retries; the (max_retries+1)-th
            # raise is the one that escalates to a process death
            if i == plan.step:
                injector_box["raises"] = injector_box.get("raises", 0) + 1
                if injector_box["raises"] > rcfg.max_retries:
                    injector_box["exhausted"] = True
            raise

    def data_factory(fcfg):
        return TokenLoader(token_path, batch, fcfg.sequence_len,
                           seed=seed, shuffle=True, native=False,
                           device=device)

    g0 = len(global_metrics.decisions)
    t0 = time.perf_counter()
    error = None
    try:
        final, history = supervise(
            cfg, data_factory, num_steps, rcfg, guard=guard,
            metrics=metrics, preempt=preempt, devices_fn=devices_fn,
            fail_injector=injector, seed=seed, postmortem_dir=pm_dir,
            device=device)
        final_step = int(final.step)
    except Exception as e:  # noqa: BLE001 - a drill reports, never dies
        error, final_step, history = f"{type(e).__name__}: {e}", -1, []
    wall = time.perf_counter() - t0

    decisions = metrics.decisions + global_metrics.decisions[g0:]
    c = metrics.counters
    names = sorted({d["decision"] for d in decisions})
    evidence: dict = {
        "failures": c.get("failures", 0.0),
        "restores": c.get("restores", 0.0),
        "checkpoints": c.get("checkpoints", 0.0),
        "preempt_drains": c.get("preempt_drains", 0.0),
        "loader_restores": c.get("loader_restores", 0.0),
        "supervisor_restarts": c.get("supervisor_restarts", 0.0),
        "finite_history": bool(history) and all(
            np.isfinite(h["loss"]) for h in history if "loss" in h),
        "decision_names": names,
        "world0": world0,
        "worlds": [d.get("world") for d in decisions
                   if d["decision"] == "supervisor.resume"],
    }
    last = ckpt_mod.latest_step(ckpt_dir)
    evidence["final_ckpt_step"] = last
    evidence["loader_state_present"] = (
        last is not None
        and ckpt_mod.load_loader_state(ckpt_dir, last) is not None)
    from flashmoe_tpu_torch.profiler import postmortem as pm

    bundles = pm.find_bundles(pm_dir)
    evidence["postmortem_bundles"] = bundles

    ok, why = True, []

    def need(cond, msg):
        nonlocal ok
        if not cond:
            ok = False
            why.append(msg)

    need(error is None, f"aborted: {error}")
    need(final_step == num_steps, f"ended at step {final_step}")
    need(evidence["finite_history"], "non-finite loss leaked")
    need("supervisor.resume" in names, "no supervisor.resume decision")
    need(evidence["loader_state_present"],
         "no loader state in the final manifest")
    steps_rerun = max(0, int(c.get("steps", 0)) - num_steps)
    if fault == "preempt":
        need(c.get("preempt_drains", 0) >= 1, "no graceful drain")
        need("preempt.drain" in names, "no preempt.drain decision")
        # zero lost steps: the drain checkpoints the exact step reached
        need(steps_rerun == 0,
             f"drain lost work: {steps_rerun} steps re-run")
        need(c.get("failures", 0) == 0, "drain path counted failures")
        # a graceful drain is not a death: no forensics bundle
        need(not bundles,
             f"graceful drain left postmortem bundle(s): {bundles}")
    else:  # device_loss
        need(c.get("supervisor_restarts", 0) >= 1,
             "process death did not reach the supervisor")
        need(c.get("restores", 0) >= 1, "no checkpoint restore")
        # the restart-forcing death must leave its forensics behind
        need(len(bundles) >= 1,
             "process death left no postmortem bundle")
        need("postmortem.saved" in names, "no postmortem.saved decision")
        if world0 >= 2:
            worlds = [w for w in evidence["worlds"] if w]
            need(worlds and min(worlds) < world0,
                 f"world never shrank below {world0} ({worlds})")
        # loss-of-work bound: every in-job retry replays at most one
        # checkpoint window, the restart replays at most one more
        bound = checkpoint_every * (rcfg.max_retries + 1)
        need(steps_rerun <= bound,
             f"loss of work {steps_rerun} exceeds bound {bound}")

    clear()
    return DrillResult(
        fault=fault, expected_tier=EXPECTED_TIER[fault], recovered=ok,
        reason="; ".join(why), final_step=final_step,
        steps_rerun=steps_rerun, wall_s=round(wall, 3),
        evidence=evidence, decisions=decisions)


def _run_controller_drill(fault: str, *, num_steps: int,
                          checkpoint_every: int, workdir: str | None,
                          seed: int, batch: int, device) -> DrillResult:
    """Drill the runtime controller: faults that are sustained
    performance or quality regressions, not crashes, which the controller
    must repair mid-job.

    ``skew_sustained``: routing collapses onto one expert for the whole
    run (the ``skewed_routing`` injection held past the controller's
    debounce window).  The capacity path drowns in token drops; recovery
    is a ``controller.morph`` onto a dropless execution, after which the
    drop EMA decays under the trigger.

    ``slow_device``: one device degrades to a quarter of its rate while
    the hot expert sits on it (the ``wrap_step`` stall is priced from the
    controller's live placement: ``sleep_s * device_load_share(slow) /
    rate``).  The controller keeps its default ``rates_fn``, the
    throughput re-probe, with the degraded rates armed at the
    ``probe_rates`` seam.  Recovery is a ``controller.replace`` carrying
    the probed rates: the hot expert moves to a fast device (replicated
    onto a dead slot), the stall collapses, and the armed SLO watchdog
    records ``slo.recovered``."""
    from flashmoe_tpu_torch.profiler.slo import SLOConfig
    from flashmoe_tpu_torch.runtime.controller import (
        ControllerConfig, RuntimeController,
    )

    clear()
    tmp = workdir or tempfile.mkdtemp(prefix=f"chaos_{fault}_")
    ckpt_dir = os.path.join(tmp, "ckpt")
    pm_dir = os.path.join(tmp, "postmortem")
    slow = fault == "slow_device"
    sleep_s = 0.4
    plan = FaultPlan(fault, step=(2 if slow else 0),
                     duration=num_steps, expert=0, bias=100.0,
                     sleep_s=sleep_s, seed=seed)
    if slow:
        # top-1 routing: the biased workload parks all load on expert 0
        # and leaves dead slots for the replication policy
        cfg = drill_config(num_experts=8, expert_top_k=1)
    else:
        cfg = drill_config()
    arm_plan(FaultPlan("skew_sustained", step=0, duration=num_steps,
                       expert=plan.expert, bias=plan.bias, seed=seed))

    n_dev = 4 if slow else 1
    rates = np.array([0.25, 1.0, 1.0, 1.0]) if slow else None
    if slow:
        # the controller keeps its default rates_fn; the drill degrades
        # what the probe reads through the chaos seam
        inject.arm("probe_rates", rates=tuple(float(r) for r in rates))
    ccfg = ControllerConfig(
        enable_morph=not slow, enable_replace=slow,
        debounce_steps=2, cooldown_steps=3, baseline_steps=2,
        morph_budget=1, replace_budget=1, ema_decay=0.5,
        slow_factor=1.5)
    metrics = Metrics()
    controller = RuntimeController(
        cfg, ccfg, metrics=metrics, n_devices=n_dev, device=device)

    guard = GradGuardConfig(warmup_steps=2, spike_factor=10.0)
    opt = make_optimizer(cfg, total_steps=num_steps)
    state = init_state(torch.Generator(device=device).manual_seed(seed),
                       cfg, opt, guard=guard)

    def _rearm_hot_column():
        # the injected skew models content-based routing: tokens chase
        # the hot expert's function, which a re-placement moves to a new
        # router column (gate_w's columns permute with their FFN
        # weights), so the column-anchored bias is re-armed at the hot
        # expert's current column before every rebuild
        col = plan.expert
        for rec in controller.timeline:
            if rec.get("decision") == "controller.replace":
                col = list(rec["perm"]).index(col)
        inject.arm("skewed_routing", expert=col, bias=plan.bias)
        return col

    def rebuild(overrides):
        _rearm_hot_column()
        scfg = cfg.replace(**overrides) if overrides else cfg
        return make_train_step(scfg, opt, guard=guard)

    step_fn = rebuild({})
    slo = None
    if slow:
        # the slow device gates the step at sleep_s / rate; the budget
        # sits between the degraded and the re-placed step time, so the
        # watchdog narrates breach -> (replace) -> recovered
        slo = SLOConfig(step_ms=sleep_s * 1e3 * 0.6, consecutive=3)

        def load_share(i):
            # bottleneck model: the slow device's work share over its
            # degraded rate (1.0 when the hot expert sits on it)
            return controller.device_load_share(0) / (
                rates[0] / rates.max())

        wrapped = wrap_step(step_fn, plan, load_share=load_share)

        def rebuild_wrapped(overrides):
            return wrap_step(rebuild(overrides), plan,
                             load_share=load_share)
    else:
        wrapped, rebuild_wrapped = step_fn, rebuild

    rcfg = ResilienceConfig(checkpoint_dir=ckpt_dir,
                            checkpoint_every=checkpoint_every,
                            max_retries=3)
    g0 = len(global_metrics.decisions)
    t0 = time.perf_counter()
    error = None
    step_wall: list[float] = []

    def timed(fn):
        # host wall clock around the step, the step's work waited for:
        # the drill's recovery verdict reads these timings
        def run(st, b):
            s0 = time.perf_counter()
            out = fn(st, b)
            _sync(device)
            step_wall.append(time.perf_counter() - s0)
            return out
        return run

    try:
        final, history = resilient_train(
            state, timed(wrapped), data_stream(cfg, batch, seed, device),
            num_steps, rcfg=rcfg, metrics=metrics, slo=slo,
            postmortem_dir=pm_dir, cfg=cfg, controller=controller,
            rebuild_step=lambda ov: timed(rebuild_wrapped(ov)))
        final_step = int(final.step)
    except Exception as e:  # noqa: BLE001 - a drill reports, never dies
        error, final_step, history = f"{type(e).__name__}: {e}", -1, []
    wall = time.perf_counter() - t0

    from flashmoe_tpu_torch.profiler import postmortem as pm
    from flashmoe_tpu_torch.runtime import checkpoint as ckpt_mod

    bundles = pm.find_bundles(pm_dir)
    decisions = metrics.decisions + global_metrics.decisions[g0:]
    names = sorted({d["decision"] for d in decisions})
    c = metrics.counters
    act_name = "controller.replace" if slow else "controller.morph"
    act = next((d for d in decisions if d["decision"] == act_name), None)
    last = ckpt_mod.latest_step(ckpt_dir)
    manifest_plan = (ckpt_mod.load_controller_state(ckpt_dir, last)
                     if last is not None else None)
    evidence: dict = {
        "failures": c.get("failures", 0.0),
        "decision_names": names,
        "action": {k: v for k, v in (act or {}).items()
                   if k not in ("perm",)},
        "drop_ema_end": controller.drop_ema,
        "imbalance_ema_end": controller.imbalance_ema,
        "morphs_used": controller.morphs_used,
        "replaces_used": controller.replaces_used,
        "overrides": {k: str(v)
                      for k, v in controller.cfg_overrides.items()},
        "manifest_plan": bool(manifest_plan),
        "postmortem_bundles": bundles,
    }

    ok, why = True, []

    def need(cond, msg):
        nonlocal ok
        if not cond:
            ok = False
            why.append(msg)

    need(error is None, f"aborted: {error}")
    need(final_step == num_steps, f"ended at step {final_step}")
    need(act is not None, f"no {act_name} decision")
    need(c.get("failures", 0) == 0,
         "controller fault escalated into step failures")
    need(not bundles,
         f"self-healed fault left postmortem bundle(s): {bundles}")
    need(manifest_plan is not None and bool(manifest_plan),
         "newest checkpoint manifest carries no controller plan")
    steps_rerun = max(0, int(c.get("steps", 0)) - num_steps)
    need(steps_rerun == 0,
         f"self-healing re-ran {steps_rerun} steps (must be zero lost "
         f"steps)")
    if act is not None:
        act_step = int(act.get("step", 0))
        if slow:
            perm = act.get("perm") or list(range(cfg.num_experts))
            need(perm != list(range(cfg.num_experts))
                 or act.get("replicas"),
                 "re-placement changed nothing (identity perm, no "
                 "replicas)")
            need(bool(act.get("replicas")),
                 "hot expert was not replicated onto a dead slot")
            # the re-placement must have consumed the probed rates (the
            # default rates_fn through the probe_rates seam)
            need(act.get("rates") == [float(r) for r in rates],
                 f"controller.replace did not carry the probed rates "
                 f"(got {act.get('rates')})")
            pre = [s for i, s in enumerate(step_wall)
                   if plan.step <= i < act_step]
            post = step_wall[act_step + 1:]  # skip the rebuilt step
            evidence["pre_ms"] = round(1e3 * max(pre), 1) if pre else None
            evidence["post_ms"] = (round(1e3 * min(post), 1)
                                   if post else None)
            need(pre and post and min(post) < 0.5 * max(pre),
                 f"step time did not recover "
                 f"(pre {evidence['pre_ms']} ms -> "
                 f"post {evidence['post_ms']} ms)")
            need("slo.breach" in names, "SLO never saw the degradation")
            need("slo.recovered" in names,
                 "step time never returned under the SLO budget")
        else:
            need(act.get("dropless"),
                 "morph did not target a dropless execution")
            need(controller.drop_ema is not None
                 and controller.drop_ema < ccfg.drop_high,
                 f"drop EMA {controller.drop_ema} still above the "
                 f"trigger after the morph")

    clear()
    return DrillResult(
        fault=fault, expected_tier=EXPECTED_TIER[fault], recovered=ok,
        reason="; ".join(why), final_step=final_step,
        steps_rerun=steps_rerun, wall_s=round(wall, 3),
        evidence=evidence, decisions=decisions)


def run_drill(fault: str, *, num_steps: int = 6, checkpoint_every: int = 2,
              workdir: str | None = None, seed: int = 0,
              batch: int = 2, device="cuda") -> DrillResult:
    """Run one fault drill end to end; never raises for a failed drill:
    the result carries the diagnosis instead.  A serving-fabric fault
    raises ``NotImplementedError`` naming its ROADMAP item."""
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}; known: {FAULTS}")
    if fault not in TRAINING_FAULTS:
        raise NotImplementedError(
            f"the {fault!r} drill ({EXPECTED_TIER[fault]}) is not ported "
            f"yet: it waits for the ROADMAP item '{_FABRIC}'")
    if fault in ("preempt", "device_loss"):
        return _run_supervised_drill(
            fault, num_steps=num_steps, checkpoint_every=checkpoint_every,
            workdir=workdir, seed=seed, batch=batch, device=device)
    if fault in ("skew_sustained", "slow_device"):
        # the controller drills need room for debounce, cooldown and
        # post-action evidence: at least 12 steps
        return _run_controller_drill(
            fault, num_steps=max(num_steps, 12),
            checkpoint_every=checkpoint_every, workdir=workdir,
            seed=seed, batch=batch, device=device)
    plan = FaultPlan(fault, step=3, seed=seed)
    if fault == "corrupt_ckpt":
        # corrupt the newest checkpoint after two exist, so the fallback
        # restore has an intact older step to land on
        plan.step = 2 * checkpoint_every + 1
    clear()
    arm_plan(plan)

    tmp = workdir or tempfile.mkdtemp(prefix=f"chaos_{fault}_")
    ckpt_dir = os.path.join(tmp, "ckpt")
    pm_dir = os.path.join(tmp, "postmortem")
    cfg = drill_config()
    # the drill runs on one device: deterministic and CLI-runnable; the
    # multi-rank tiers are covered by the supervised drills and tests
    guard = GradGuardConfig(warmup_steps=2, spike_factor=10.0)
    opt = make_optimizer(cfg, total_steps=num_steps)
    state = init_state(torch.Generator(device=device).manual_seed(seed),
                       cfg, opt, guard=guard)
    step_fn = make_train_step(cfg, opt, guard=guard)

    timeout = None
    if fault == "slow_step":
        # calibrate the deadline against a real (warm) step so the drill
        # never mistakes a first call for a stall
        warm = init_state(
            torch.Generator(device=device).manual_seed(seed + 1), cfg, opt,
            guard=guard)
        warm_batch = next(data_stream(cfg, batch, seed + 7, device))
        step_fn(warm, warm_batch)
        _sync(device)
        t0 = time.perf_counter()
        step_fn(warm, warm_batch)
        _sync(device)
        warm_s = time.perf_counter() - t0
        timeout = max(2.0, 20 * warm_s)
        plan.sleep_s = 2.5 * timeout

    rcfg = ResilienceConfig(checkpoint_dir=ckpt_dir,
                            checkpoint_every=checkpoint_every,
                            step_timeout_s=timeout, max_retries=3)
    metrics = Metrics()
    injector = make_injector(plan, rcfg)
    wrapped = wrap_step(step_fn, plan)
    g0 = len(global_metrics.decisions)

    t0 = time.perf_counter()
    error = None
    try:
        final, history = resilient_train(
            state, wrapped, data_stream(cfg, batch, seed, device),
            num_steps, rcfg=rcfg, metrics=metrics, fail_injector=injector,
            postmortem_dir=pm_dir, cfg=cfg)
        final_step = int(final.step)
    except Exception as e:  # noqa: BLE001 - a drill reports, never dies
        error, final_step, history = f"{type(e).__name__}: {e}", -1, []
    wall = time.perf_counter() - t0

    from flashmoe_tpu_torch.profiler import postmortem as pm

    bundles = pm.find_bundles(pm_dir)
    decisions = metrics.decisions + global_metrics.decisions[g0:]
    c = metrics.counters
    evidence: dict = {
        "failures": c.get("failures", 0.0),
        "restores": c.get("restores", 0.0),
        "grad_skips": c.get("grad_skips", 0.0),
        "checkpoints": c.get("checkpoints", 0.0),
        "path_fallbacks": c.get("path_fallbacks", 0.0),
        "finite_history": bool(history) and all(
            np.isfinite(h["loss"]) for h in history if "loss" in h),
        "decision_names": sorted({d["decision"] for d in decisions}),
        "postmortem_bundles": bundles,
    }

    # ---- per-fault verdict: did the intended tier absorb it? ----
    ok, why = True, []

    def need(cond, msg):
        nonlocal ok
        if not cond:
            ok = False
            why.append(msg)

    need(error is None, f"aborted: {error}")
    need(final_step == num_steps, f"ended at step {final_step}")
    if fault in ("nan_expert", "skewed_routing"):
        probe_params = (final.params if error is None else init_state(
            torch.Generator(device=device).manual_seed(seed), cfg,
            opt).params)
        st, _ = _stats_probe(cfg, {"layers": [{"moe": probe_params[
            "layers"][0]["moe"]}]}, device=device)
        evidence["probe"] = st
        need(evidence["finite_history"], "non-finite loss leaked")
        need(c.get("failures", 0) == 0,
             "fault escalated past tier 0 (step failures)")
        if fault == "nan_expert":
            need(st["masked_experts"] >= 1, "no masked expert in stats")
        else:
            need(st["imbalance"] > cfg.num_experts / 2
                 or st["dropped_fraction"] > 0,
                 "no skew visible in stats")
    elif fault in ("nan_grad", "grad_spike"):
        need(c.get("grad_skips", 0) >= 1, "no skipped update recorded")
        need(c.get("failures", 0) == 0,
             "fault escalated past tier 1 (step failures)")
        need(c.get("restores", 0) == 0, "needless checkpoint rewind")
        need(any(d["decision"] == "trainer.grad_skip" for d in decisions),
             "no trainer.grad_skip decision")
    elif fault == "slow_step":
        need(c.get("failures", 0) >= 1, "stall was not detected")
        need(c.get("restores", 0) >= 1, "no restore after timeout")
    elif fault == "corrupt_ckpt":
        need(any(d["decision"] == "checkpoint.fallback"
                 for d in decisions), "no checkpoint.fallback decision")
        need(c.get("restores", 0) >= 1, "no restore happened")
    elif fault == "path_raise":
        need(c.get("path_fallbacks", 0) >= 1, "PathFailure not handled")
        need(any(d["decision"] == "planner.fallback" for d in decisions),
             "no planner.fallback decision")

    steps_rerun = max(0, int(c.get("steps", 0)) - num_steps)
    # loss-of-work bound: a rewind replays at most the window since the
    # newest usable checkpoint: one interval, two when the newest was
    # the corrupted one (the fallback lands one checkpoint further back)
    bound = checkpoint_every * (2 if fault == "corrupt_ckpt" else 1)
    retries = int(c.get("failures", 0))
    if fault not in ("nan_expert", "skewed_routing", "nan_grad",
                     "grad_spike"):
        need(steps_rerun <= bound * max(1, retries),
             f"loss of work {steps_rerun} exceeds bound "
             f"{bound * max(1, retries)}")
    else:
        need(steps_rerun == 0, "in-graph tier re-ran steps")
    # every in-job fault recovers below the process-death line: a
    # postmortem bundle here would mean recovery gave up
    need(not bundles,
         f"recovered fault left postmortem bundle(s): {bundles}")

    clear()
    return DrillResult(
        fault=fault, expected_tier=EXPECTED_TIER[fault], recovered=ok,
        reason="; ".join(why), final_step=final_step,
        steps_rerun=steps_rerun, wall_s=round(wall, 3),
        evidence=evidence, decisions=decisions)


def run_matrix(faults=TRAINING_FAULTS, **kw) -> list[DrillResult]:
    return [run_drill(f, **kw) for f in faults]


__all__ = ["DrillResult", "StepFailure", "TRAINING_FAULTS", "data_stream",
           "drill_config", "run_drill", "run_matrix"]
