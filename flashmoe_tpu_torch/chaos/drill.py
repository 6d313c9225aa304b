"""Chaos drills: prove each fault class recovers at its intended tier.

Counterpart of ``flashmoe_tpu/chaos/drill.py``.  One training
drill = one :class:`flashmoe_tpu_torch.chaos.FaultPlan` run against a
small real training job under :func:`flashmoe_tpu_torch.runtime.
resilient.resilient_train` with the full ladder armed (tier-0 expert
masking, tier-1 gradient guard, tier-2 verified checkpoints and path
fallback, tier-3 supervised restarts, the runtime controller).  The
drill then reads the run back: did training reach the last step, how
many steps of work were re-executed, and does the telemetry carry
evidence that the intended tier absorbed the fault
(:data:`flashmoe_tpu_torch.chaos.EXPECTED_TIER`)?

The serving faults (tiers ``monitor:*`` and ``fabric:*``) run against a
mocked 2-replica serving fabric (:mod:`flashmoe_tpu_torch.fabric`)
behind a front door: the DCN faults on its virtual clock
(``_run_vclock_drill``), the others with recovery judged by token
equality with an uninterrupted single-pool engine
(``_run_fabric_fault_drill``).  :func:`run_matrix` runs all 21 faults by
default.  The drills run on the card unless the caller passes
``device="cpu"``; the supervised drills' worlds are virtual ranks of
that device.

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

#: the training ladder's faults: every fault whose tier is not the
#: serving fabric's (``monitor:*`` / ``fabric:*``)
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
            s0 = time.perf_counter()  # staticcheck: ok host wrapper around the step, not a traced body
            out = fn(st, b)
            _sync(device)
            step_wall.append(time.perf_counter() - s0)  # staticcheck: ok host wrapper around the step, not a traced body
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


def fabric_drill_config():
    """The serving drills' model: ``loadgen.tiny_config()``, JAX's, two
    heads of 32 on every device."""
    from flashmoe_tpu_torch.serving.loadgen import tiny_config

    return tiny_config()


def _fabric_drill_inputs(seed: int, device):
    """(config, weights, engine shape, requests, arrivals) of the serving
    drills: JAX's drill trace, 6 requests of 8 tokens, 4 new each."""
    from flashmoe_tpu_torch.models.transformer import init_params
    from flashmoe_tpu_torch.serving.engine import ServeConfig
    from flashmoe_tpu_torch.serving.loadgen import build_requests

    cfg = fabric_drill_config()
    params = init_params(torch.Generator(device=device).manual_seed(seed),
                         cfg, device=device)
    serve = ServeConfig(max_batch=2, page_size=8, num_pages=64,
                        max_pages_per_slot=4, ctx_bucket_pages=1,
                        prompt_bucket=8)
    reqs, arrivals = build_requests(
        6, vocab=cfg.vocab_size, prompt_len=8, max_new=4, seed=seed,
        arrival_every=1)
    return cfg, params, serve, reqs, arrivals


def _run_vclock_drill(fault: str, *, seed: int,
                      device="cuda") -> DrillResult:
    """Drill the DCN faults (``dcn_latency`` / ``dcn_jitter``) against
    the serving fabric's measured-latency plane: a mocked 2-replica
    fabric steps on a :class:`~flashmoe_tpu_torch.fabric.vclock.VirtualClock`
    with the plan armed, behind a
    :class:`~flashmoe_tpu_torch.fabric.frontdoor.FrontDoor`.

    These faults never crash anything — no recovery tier fires.  The
    claim under drill is OBSERVABILITY (``monitor:handoff_drift``):
    every perturbed transfer must surface through the
    ``fabric.handoff_drift`` decisions with ``measured > modeled``,
    unperturbed transfers must keep reconciling with the priced
    verdict, the shared tracer must stay contiguous, and every
    request's critical-path attribution must still sum to its span
    within the 1% gate — delay injection may stretch latencies, never
    corrupt the accounting."""
    from flashmoe_tpu_torch.fabric import (FrontDoor, ServingFabric,
                                           VirtualClock)
    from flashmoe_tpu_torch.fabric.topo import set_mock_fabric

    # window over TRANSFER index: skip the first two handoffs so the
    # drill proves both arms (clean reconciliation AND visible drift)
    plan = FaultPlan(fault, step=2, duration=6, latency_ms=50.0,
                     jitter_ms=50.0, seed=seed)
    clear()
    cfg, params, serve, reqs, arrivals = _fabric_drill_inputs(seed, device)
    metrics = Metrics()
    restore_env = set_mock_fabric(2)
    t0 = time.perf_counter()
    error, door, fab = None, None, None
    outputs: dict = {}
    att: dict = {}
    trace_errors: list = []
    try:
        vc = VirtualClock(plan=plan)
        fab = ServingFabric(params, cfg, serve, metrics_obj=metrics,
                            vclock=vc)
        door = FrontDoor(fab)
        outputs = door.run(reqs, arrivals)
        att = door.attribution()
        trace_errors = door.validate()
    except Exception as e:  # noqa: BLE001 — a drill reports, never dies
        error = f"{type(e).__name__}: {e}"
    finally:
        if door is not None:
            door.close()
        if fab is not None:
            fab.close()
        restore_env()
    wall = time.perf_counter() - t0

    decisions = list(metrics.decisions)
    drift = [d for d in decisions
             if d["decision"] == "fabric.handoff_drift"]
    perturbed = [d for d in drift if d["chaos_ms"] > 0]
    clean = [d for d in drift if d["chaos_ms"] == 0]
    sums_ok = [a["sum_ok"] for a in att.values()]
    evidence: dict = {
        "completed": len(outputs),
        "handoffs": len([d for d in decisions
                         if d["decision"] == "fabric.handoff"]),
        "drift_decisions": len(drift),
        "perturbed_transfers": len(perturbed),
        "clean_transfers": len(clean),
        "max_chaos_ms": (max(d["chaos_ms"] for d in perturbed)
                         if perturbed else 0.0),
        "clean_agree": [d["agree"] for d in clean],
        "attribution_requests": len(att),
        "attribution_sum_ok": sums_ok,
        "max_rel_err": (max(a["rel_err"] for a in att.values())
                        if att else None),
        "trace_errors": trace_errors,
        "decision_names": sorted({d["decision"] for d in decisions}),
    }

    ok, why = True, []

    def need(cond, msg):
        nonlocal ok
        if not cond:
            ok = False
            why.append(msg)

    need(error is None, f"aborted: {error}")
    need(len(outputs) == len(reqs),
         f"only {len(outputs)}/{len(reqs)} requests completed")
    need(len(drift) == evidence["handoffs"],
         "not every handoff produced a drift verdict")
    need(len(perturbed) >= 1, "injected DCN fault never surfaced in "
                              "fabric.handoff_drift")
    need(all(d["measured_dcn_ms"] > d["modeled_dcn_ms"]
             for d in perturbed),
         "a perturbed transfer measured no slower than priced")
    need(all(a is not False for a in evidence["clean_agree"]),
         "an UNperturbed transfer disagreed with the priced verdict")
    need(not trace_errors, f"tracer lost contiguity: {trace_errors[:3]}")
    need(att and all(sums_ok),
         "attribution no longer sums to the request span (1% gate)")

    clear()
    return DrillResult(
        fault=fault, expected_tier=EXPECTED_TIER[fault], recovered=ok,
        reason="; ".join(why), final_step=(fab.step_idx if fab else -1),
        steps_rerun=0, wall_s=round(wall, 3),
        evidence=evidence, decisions=decisions)


def _run_fabric_fault_drill(fault: str, *, seed: int,
                            device="cuda") -> DrillResult:
    """Drill the serving fault-tolerance ladder: a mocked
    2-replica fabric behind a front door, with ONE of the serving
    faults armed —

    * ``replica_crash``    — a decode replica dies silently at a fabric
      step; the health probes detect it and every victim MIGRATES to a
      survivor via deterministic re-prefill (``fabric:migrate``);
    * ``handoff_corrupt``  — a KV transfer's bytes flip on the wire;
      the per-page CRC32 verify refuses them and the transport retries
      exactly once (``fabric:handoff_retry``);
    * ``handoff_timeout``  — a transfer stalls past the deadline; same
      retry tier, reason ``timeout``;
    * ``frontdoor_loss``   — a front-door PEER dies mid-run; its
      namespace leases fail over to the survivors with bumped epochs
      (``fabric:frontdoor_failover``);
    * ``net_partition``    — the tcp wire drops transfers MID-STREAM
      (partial bytes really cross a kernel socket and the receiver
      really discards them); the sender reconnects and retries
      (``fabric:partition_retry``);
    * ``lease_split_brain`` — the lease table lives in an EXTERNAL
      fcntl-locked store; after a failover the dead peer plays zombie
      and re-asserts a moved shard at its stale epoch — the store's
      fencing token REFUSES it, zero requests double-served
      (``fabric:lease_fence``);
    * ``replica_stall``    — a decode replica hangs MID-STEP (its
      health probe still answers); the sub-step heartbeat deadline
      catches it and the victims migrate (``fabric:heartbeat_migrate``);
    * ``lease_torn_write`` — a lease writer is killed mid-append; the
      store's CRC framing refuses the torn record and rolls back to
      the last intact epoch (``fabric:lease_repair``).

    Recovery must be INVISIBLE to the tokens: every request completes
    with a token stream bit-equal to an uninterrupted single-pool
    engine on the same trace, the shared tracer stays orphan-free
    through the transition, the post-failure fleet Perfetto document
    still validates, and retry/migration costs are reconciled through
    the virtual clock (the ``fabric.handoff_drift`` family)."""
    from flashmoe_tpu_torch.fabric import (
        FrontDoor, FrontDoorCluster, HandoffTransport, HeartbeatConfig,
        LeaseStore, ServingFabric, StaleLeaseError, VirtualClock,
    )
    from flashmoe_tpu_torch.fabric.topo import set_mock_fabric
    from flashmoe_tpu_torch.serving.engine import ServingEngine

    clear()
    cfg, params, serve, reqs, arrivals = _fabric_drill_inputs(seed, device)

    # the uninterrupted single-pool run the recovery must be bit-equal
    # to (same step functions, same seeded trace)
    eng = ServingEngine(params, cfg, serve, metrics_obj=Metrics())
    baseline = eng.run(reqs, arrivals)
    eng.close()

    metrics = Metrics()
    restore_env = set_mock_fabric(2)
    t0 = time.perf_counter()
    error, fab, door, cluster, transport = None, None, None, None, None
    store, store_path = None, None
    zombie_attempts, zombie_refused = 0, 0
    torn_bytes, restored_epoch = 0, -1
    outputs: dict = {}
    att: dict = {}
    trace_errors: list = []
    fleet_doc: dict = {}
    try:
        vc = VirtualClock()
        if fault in ("lease_split_brain", "lease_torn_write"):
            fd, store_path = tempfile.mkstemp(
                prefix="flashmoe-drill-leases-", suffix=".bin")
            os.close(fd)
        if fault in ("handoff_corrupt", "handoff_timeout"):
            # window over TRANSFER index, first attempt only (once):
            # two faulted transfers, each retried exactly once
            transport = HandoffTransport(
                metrics_obj=metrics,
                plan=FaultPlan(fault, step=2, duration=2, seed=seed))
            fab = ServingFabric(params, cfg, serve, metrics_obj=metrics,
                                vclock=vc, transport=transport)
            door = FrontDoor(fab)
            outputs = door.run(reqs, arrivals)
        elif fault == "replica_crash":
            fab = ServingFabric(
                params, cfg, serve, metrics_obj=metrics, vclock=vc,
                fault_plan=FaultPlan(fault, step=3, expert=0,
                                     seed=seed))
            door = FrontDoor(fab)
            outputs = door.run(reqs, arrivals)
        elif fault == "frontdoor_loss":
            fab = ServingFabric(params, cfg, serve, metrics_obj=metrics,
                                vclock=vc)
            cluster = FrontDoorCluster(fab, n_doors=2, n_shards=8,
                                       metrics_obj=metrics)
            outputs = cluster.run(reqs, arrivals, fail_at=2,
                                  fail_peer=0)
        elif fault == "net_partition":
            # the REAL tcp wire: two transfers are cut mid-stream at
            # the kernel socket layer (partial bytes actually cross),
            # the receiver discards the torn frames, the sender
            # reconnects and retries on the capped-backoff ladder
            transport = HandoffTransport(
                metrics_obj=metrics, wire="tcp",
                plan=FaultPlan(fault, step=2, duration=2, seed=seed))
            fab = ServingFabric(params, cfg, serve, metrics_obj=metrics,
                                vclock=vc, transport=transport)
            door = FrontDoor(fab)
            outputs = door.run(reqs, arrivals)
        elif fault == "lease_split_brain":
            store = LeaseStore(store_path, metrics_obj=metrics)
            fab = ServingFabric(params, cfg, serve, metrics_obj=metrics,
                                vclock=vc)
            cluster = FrontDoorCluster(fab, n_doors=2, n_shards=8,
                                       metrics_obj=metrics, store=store)
            # the epochs the doomed peer believes it holds, BEFORE the
            # failover moves them
            stale = {s: ls.epoch for s, ls in store.leases().items()
                     if ls.owner == 0}
            outputs = cluster.run(reqs, arrivals, fail_at=2,
                                  fail_peer=0)
            # the zombie arm: the failed peer wakes back up and
            # re-asserts every shard it lost, using the fencing token
            # it believes is next — every write must be REFUSED
            for shard, epoch in sorted(stale.items()):
                zombie_attempts += 1
                try:
                    store.write_lease(shard, 0, epoch + 1,
                                      reason="zombie_reassert")
                except StaleLeaseError:
                    zombie_refused += 1
        elif fault == "replica_stall":
            # the victim hangs MID-STEP (after its admit heartbeat,
            # inside prefill); its probe still answers, so only the
            # sub-step heartbeat deadline can catch it
            fab = ServingFabric(
                params, cfg, serve, metrics_obj=metrics, vclock=vc,
                heartbeat=HeartbeatConfig(misses_to_stall=2),
                fault_plan=FaultPlan(fault, step=3, expert=0,
                                     seed=seed))
            door = FrontDoor(fab)
            outputs = door.run(reqs, arrivals)
        elif fault == "lease_torn_write":
            # seed a store, advance shard 3 to epoch 1, then kill the
            # writer mid-append of epoch 2 — the torn record must be
            # refused and the table rolled back to epoch 1
            store = LeaseStore(store_path, metrics_obj=metrics)
            store.init_leases({s: s % 2 for s in range(8)})
            store.write_lease(3, 1, 1, reason="pre_crash")
            store.write_lease(3, 1, 2, reason="crash_victim")
            torn_bytes = store.tear_last_record()
            fab = ServingFabric(params, cfg, serve, metrics_obj=metrics,
                                vclock=vc)
            # the cluster's first mutating write repairs the tail
            cluster = FrontDoorCluster(fab, n_doors=2, n_shards=8,
                                       metrics_obj=metrics, store=store)
            restored_epoch = store.leases()[3].epoch
            outputs = cluster.run(reqs, arrivals, fail_at=2,
                                  fail_peer=0)
        else:
            raise ValueError(f"not a fabric fault: {fault!r}")
        authority = cluster if cluster is not None else door
        trace_errors = authority.validate()
        fleet_doc = authority.fleet_trace_document()
        if door is not None:
            att = door.attribution()
    except Exception as e:  # noqa: BLE001 — a drill reports, never dies
        error = f"{type(e).__name__}: {e}"
    finally:
        if door is not None:
            door.close()
        if cluster is not None:
            cluster.close()
        if fab is not None:
            fab.close()
        if transport is not None:
            transport.close()
        if store_path is not None:
            try:
                os.unlink(store_path)
            except OSError:
                pass
        restore_env()
    wall = time.perf_counter() - t0

    decisions = list(metrics.decisions)

    def named(name):
        return [d for d in decisions if d["decision"] == name]

    bit_equal = (sorted(outputs) == sorted(baseline)
                 and all(outputs[r] == baseline[r] for r in baseline))
    drift = named("fabric.handoff_drift")
    retried_drift = [d for d in drift if d.get("retry_ms", 0) > 0]
    sums_ok = [a["sum_ok"] for a in att.values()]
    evidence: dict = {
        "completed": len(outputs),
        "bit_equal_to_baseline": bit_equal,
        "handoffs": len(named("fabric.handoff")),
        "retries": len(named("fabric.handoff_retry")),
        "corrupt": len(named("fabric.handoff_corrupt")),
        "migrations": len(named("fabric.migrate")),
        "crashes": len(named("fabric.replica_crash")),
        "failovers": len(named("frontdoor.failover")),
        "partitions": len(named("fabric.partition")),
        "fences": len(named("frontdoor.fence")),
        "lease_repairs": len(named("frontdoor.lease_repair")),
        "stalls": len(named("fabric.heartbeat_stall")),
        "heartbeat_misses": len(named("fabric.heartbeat_miss")),
        "zombie_attempts": zombie_attempts,
        "zombie_refused": zombie_refused,
        "torn_bytes": torn_bytes,
        "restored_epoch": restored_epoch,
        "retried_drift": len(retried_drift),
        "trace_errors": trace_errors,
        "fleet_trace_events": len(fleet_doc.get("traceEvents", [])),
        "attribution_requests": len(att),
        "attribution_sum_ok": sums_ok,
        "decision_names": sorted({d["decision"] for d in decisions}),
    }

    ok, why = True, []

    def need(cond, msg):
        nonlocal ok
        if not cond:
            ok = False
            why.append(msg)

    need(error is None, f"aborted: {error}")
    need(len(outputs) == len(reqs),
         f"only {len(outputs)}/{len(reqs)} requests completed")
    need(bit_equal, "a recovered request's token stream diverged from "
                    "the uninterrupted single-pool run")
    need(not trace_errors,
         f"tracer lost contiguity across the failure: "
         f"{trace_errors[:3]}")
    need(evidence["fleet_trace_events"] > 0,
         "post-failure fleet Perfetto document is empty")
    if fault == "replica_crash":
        need(evidence["crashes"] == 1,
             "the crash was never detected")
        need(evidence["migrations"] >= 1,
             "no request migrated off the dead replica")
    elif fault in ("handoff_corrupt", "handoff_timeout"):
        retries = named("fabric.handoff_retry")
        need(len(retries) == 2,
             f"expected exactly one retry per faulted transfer "
             f"(2 total), saw {len(retries)}")
        want_reason = ("corrupt" if fault == "handoff_corrupt"
                       else "timeout")
        need(all(d["reason"] == want_reason for d in retries),
             f"retry reasons {[d['reason'] for d in retries]} != "
             f"{want_reason}")
        if fault == "handoff_corrupt":
            need(evidence["corrupt"] == 2,
                 "CRC verify never named the corrupted pages")
        need(len(retried_drift) == 2,
             "retry cost never reconciled through the vclock "
             "(fabric.handoff_drift retry_ms)")
        need(att and all(sums_ok),
             "attribution no longer sums to the request span")
    elif fault == "frontdoor_loss":
        fo = named("frontdoor.failover")
        need(len(fo) >= 1, "no lease failed over off the dead peer")
        need(all(d["epoch"] >= 1 for d in fo),
             "a failover did not bump its lease epoch")
        need(all(d["to_peer"] != 0 for d in fo),
             "a lease failed over TO the dead peer")
    elif fault == "net_partition":
        retries = named("fabric.handoff_retry")
        parts = named("fabric.partition")
        need(len(parts) == 2,
             f"expected 2 partitioned transfers, saw {len(parts)}")
        need(all(d["wire"] == "tcp" and d["injected"] for d in parts),
             "a partition verdict did not come off the tcp wire")
        need(all(d.get("dropped_bytes", 0) > 0 for d in parts),
             "no partial bytes actually crossed the socket before "
             "the cut")
        need(len(retries) == 2
             and all(d["reason"] == "reset" for d in retries),
             f"expected 2 retries with reason=reset, saw "
             f"{[d.get('reason') for d in retries]}")
        need(len(retried_drift) == 2,
             "retry cost never reconciled through the vclock "
             "(fabric.handoff_drift retry_ms)")
        need(att and all(sums_ok),
             "attribution no longer sums to the request span")
    elif fault == "lease_split_brain":
        fo = named("frontdoor.failover")
        fences = named("frontdoor.fence")
        need(len(fo) >= 1, "no lease failed over off the dead peer")
        need(zombie_attempts >= 1,
             "the zombie never re-asserted a moved shard")
        need(zombie_refused == zombie_attempts,
             f"split brain: {zombie_attempts - zombie_refused} zombie "
             f"stale-epoch writes were ACCEPTED")
        need(len(fences) == zombie_refused
             and all(d["refused"] for d in fences),
             "a refusal was not logged as a frontdoor.fence decision")
    elif fault == "replica_stall":
        stalls = named("fabric.heartbeat_stall")
        need(len(stalls) == 1,
             "the mid-step hang was never declared a stall")
        need(evidence["heartbeat_misses"] >= 2,
             "the watchdog skipped its hysteresis window")
        need(stalls and stalls[0]["detect_ms"] > 0,
             "stall detection latency was not priced")
        need(stalls and stalls[0]["step"] > 3,
             "stall declared at or before the hang step — the probe "
             "false-positived where only heartbeats can see")
        need(evidence["crashes"] == 1,
             "the stalled replica was never fenced off")
        need(evidence["migrations"] >= 1,
             "no request migrated off the stalled replica")
    elif fault == "lease_torn_write":
        reps = named("frontdoor.lease_repair")
        need(torn_bytes > 0, "the kill never tore any bytes")
        need(len(reps) >= 1,
             "the torn tail was never repaired "
             "(frontdoor.lease_repair)")
        need(restored_epoch == 1,
             f"rolled back to epoch {restored_epoch}, wanted the "
             f"last intact epoch 1")
        need(evidence["failovers"] >= 1,
             "failover on top of the repaired store never happened")

    clear()
    return DrillResult(
        fault=fault, expected_tier=EXPECTED_TIER[fault], recovered=ok,
        reason="; ".join(why), final_step=(fab.step_idx if fab else -1),
        steps_rerun=0, wall_s=round(wall, 3),
        evidence=evidence, decisions=decisions)


def run_drill(fault: str, *, num_steps: int = 6, checkpoint_every: int = 2,
              workdir: str | None = None, seed: int = 0,
              batch: int = 2, device="cuda") -> DrillResult:
    """Run one fault drill end to end; never raises for a failed drill:
    the result carries the diagnosis instead."""
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}; known: {FAULTS}")
    if fault in ("dcn_latency", "dcn_jitter"):
        # serving-plane faults: drilled against the fabric's virtual
        # clock, not the training loop (num_steps etc. do not apply)
        return _run_vclock_drill(fault, seed=seed, device=device)
    if fault in ("replica_crash", "handoff_corrupt", "handoff_timeout",
                 "frontdoor_loss", "net_partition", "lease_split_brain",
                 "replica_stall", "lease_torn_write"):
        # the serving fault-tolerance ladder: a mocked 2-replica fabric,
        # recovery judged by token equality
        return _run_fabric_fault_drill(fault, seed=seed, device=device)
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


def run_matrix(faults=FAULTS, **kw) -> list[DrillResult]:
    return [run_drill(f, **kw) for f in faults]


__all__ = ["DrillResult", "StepFailure", "TRAINING_FAULTS", "data_stream",
           "drill_config", "run_drill", "run_matrix"]
