"""Chaos engineering for the fault-tolerance ladder.

Counterpart of ``flashmoe_tpu/chaos/__init__.py``.  Deterministic, seeded
fault injectors behind one :class:`FaultPlan` API, plugged into two
places:

  * **injection points** (:mod:`flashmoe_tpu_torch.chaos.inject`): NaN
    expert outputs, router skew, gradient NaN/spikes, a degraded probe
    reading, exercising tier 0 (expert masking), tier 1 (update
    skipping) and the runtime controller;
  * **host-level hooks**: :func:`make_injector` returns a
    ``fail_injector(step)`` for :func:`flashmoe_tpu_torch.runtime.
    resilient.resilient_train` (checkpoint corruption, path failures,
    preemption, device loss) and :func:`wrap_step` wraps a train step
    (stalls), exercising tiers 2 and 3.

``python -m flashmoe_tpu_torch.chaos`` runs the drill matrix against a
small model and reports recovery outcome, loss of work and the
telemetry evidence per fault (:mod:`flashmoe_tpu_torch.chaos.drill`).
The port's checkpoints are one raw file a leaf
(:mod:`flashmoe_tpu_torch.runtime.checkpoint`): the corruption fault
flips bytes in the largest of them, which the manifest's CRC32 catches.
"""

from __future__ import annotations

import dataclasses
import os
import time

from flashmoe_tpu_torch.chaos import inject

#: the drill matrix: every fault class the ladder claims to survive
FAULTS = ("nan_expert", "nan_grad", "grad_spike", "slow_step",
          "corrupt_ckpt", "skewed_routing", "path_raise", "preempt",
          "device_loss", "skew_sustained", "slow_device",
          "dcn_latency", "dcn_jitter",
          "replica_crash", "handoff_corrupt", "handoff_timeout",
          "frontdoor_loss",
          "net_partition", "lease_split_brain", "replica_stall",
          "lease_torn_write")

#: which recovery tier is expected to absorb each fault.  The
#: ``controller:*`` tiers are the self-healing runtime controller
#: (:mod:`flashmoe_tpu_torch.runtime.controller`): the fault is not a
#: crash but a sustained PERFORMANCE/QUALITY regression, and recovery
#: means the controller repairs it mid-job — path morphing for
#: sustained routing skew, Decider re-placement for a degraded device.
EXPECTED_TIER = {
    "nan_expert": "tier0:expert_mask",
    "skewed_routing": "tier0:telemetry",
    "nan_grad": "tier1:skip_update",
    "grad_spike": "tier1:skip_update",
    "slow_step": "tier2:timeout_retry",
    "corrupt_ckpt": "tier2:fallback_restore",
    "path_raise": "tier2:planner_fallback",
    "preempt": "tier3:drain_resume",
    "device_loss": "tier3:elastic_refold",
    "skew_sustained": "controller:morph",
    "slow_device": "controller:replace",
    # DCN faults are SERVING faults: they never crash anything — they
    # stretch handoff transfers on the fabric's virtual clock, and the
    # recovery claim is observability: the measured-vs-priced monitor
    # (``fabric.handoff_drift``) must expose the degradation while the
    # per-request attribution stays exact
    "dcn_latency": "monitor:handoff_drift",
    "dcn_jitter": "monitor:handoff_drift",
    # the serving fault-tolerance ladder (:mod:`flashmoe_tpu_torch.
    # fabric`): a crashed decode replica's requests
    # MIGRATE via deterministic re-prefill; a corrupt or timed-out KV
    # handoff is caught by the transport's per-page CRC32 verify /
    # deadline and RETRIED with capped backoff; a dead front-door peer
    # fails its namespace leases over to the survivors
    "replica_crash": "fabric:migrate",
    "handoff_corrupt": "fabric:handoff_retry",
    "handoff_timeout": "fabric:handoff_retry",
    "frontdoor_loss": "fabric:frontdoor_failover",
    # cross-process faults: a wire that drops a transfer
    # mid-stream is retried on a fresh connection; a zombie door
    # re-asserting a revoked lease is REFUSED by the store's epoch
    # fencing; a replica that hangs mid-step (not dead — the probe
    # still answers) is caught by the sub-step heartbeat watchdog and
    # migrated; a lease writer killed mid-append is rolled back to the
    # last intact CRC-framed record
    "net_partition": "fabric:partition_retry",
    "lease_split_brain": "fabric:lease_fence",
    "replica_stall": "fabric:heartbeat_migrate",
    "lease_torn_write": "fabric:lease_repair",
}


@dataclasses.dataclass
class FaultPlan:
    """One deterministic fault to inject.

    ``fault``: one of :data:`FAULTS`.
    ``step``:  the step index the fault fires at (host faults fire when
               the training loop reaches it; the in-graph gradient
               faults compare against the state's ``step`` tensor).
    ``expert``: target expert for nan_expert / skewed_routing; doubles
               as the target REPLICA for replica_crash (``expert %
               n_replicas``) and the dying front-door PEER for
               frontdoor_loss.
    ``scale``: gradient multiplier for grad_spike.
    ``bias``:  router logit bias for skewed_routing.
    ``sleep_s``: stall duration for slow_step (must exceed the
               ResilienceConfig step deadline to be detected) and the
               full-degradation stall for slow_device.
    ``once``:  host faults fire once then disarm (the transient-fault
               model); False = fire at every visit of ``step``.
    ``duration``: how many consecutive steps a SUSTAINED fault holds —
               ``slow_step`` stalls every step in ``[step, step +
               duration)`` (each visited step at most once under
               ``once``), ``slow_device`` degrades from ``step`` for
               ``duration`` steps, and the drill harness keeps
               ``skew_sustained`` armed that long.  Default 1 keeps
               every pre-existing single-shot drill byte-compatible.
               The self-healing controller's debounce window requires
               sustained faults: a one-step blip must never trigger a
               morph or re-placement.  For the DCN faults AND the
               handoff transport faults (handoff_corrupt /
               handoff_timeout / net_partition) the window is over
               TRANSFER index, not
               engine step; with ``once`` a faulted transfer's retry
               is clean (exactly one retry), with ``once=False`` every
               attempt fails until the retry budget gives up.
    ``latency_ms``: extra DCN delay added to every handoff transfer in
               the window (dcn_latency — a degraded inter-slice link).
    ``jitter_ms``: upper bound of the deterministic per-transfer jitter
               (dcn_jitter — crc32 of ``(seed, transfer index)`` maps
               each transfer to a fraction of this bound).
    ``seed``:  reserved for randomized plans; recorded for provenance
               (the dcn_jitter hash consumes it).
    """

    fault: str
    step: int = 3
    expert: int = 0
    scale: float = 1e4
    bias: float = 100.0
    sleep_s: float = 2.0
    once: bool = True
    duration: int = 1
    latency_ms: float = 0.0
    jitter_ms: float = 0.0
    seed: int = 0

    def __post_init__(self):
        if self.fault not in FAULTS:
            raise ValueError(
                f"unknown fault {self.fault!r}; known: {FAULTS}")
        if self.duration < 1:
            raise ValueError(f"duration must be >= 1, "
                             f"got {self.duration}")


def clear() -> None:
    """Disarm every in-graph point and forget reported path failures —
    call between drills so faults never leak across scenarios."""
    inject.disarm()
    from flashmoe_tpu_torch.planner import select

    select.reset_path_failures()


def arm_plan(plan: FaultPlan) -> None:
    """Arm the plan's in-graph injection point (no-op for host faults).
    The next call through the hook site sees it."""
    if plan.fault == "nan_expert":
        inject.arm("nan_expert", expert=plan.expert)
    elif plan.fault in ("skewed_routing", "skew_sustained"):
        # skew poisons every step while armed: a
        # ``skew_sustained`` plan is the same injection, drilled long
        # enough (``duration``) to cross the controller's debounce
        # window and force a morph instead of mere telemetry
        inject.arm("skewed_routing", expert=plan.expert, bias=plan.bias)
    elif plan.fault == "nan_grad":
        inject.arm("nan_grad", step=plan.step)
    elif plan.fault == "grad_spike":
        inject.arm("grad_spike", step=plan.step, scale=plan.scale)


def _corrupt_latest_checkpoint(directory: str) -> str | None:
    """Flip bytes in the newest checkpoint's largest payload file.
    Returns the corrupted path (None when there is nothing to corrupt)."""
    from flashmoe_tpu_torch.runtime import checkpoint as ckpt

    step = ckpt.latest_step(directory)
    if step is None:
        return None
    victim, size = None, -1
    for root, _dirs, files in os.walk(ckpt.step_dir(directory, step)):
        for f in files:
            p = os.path.join(root, f)
            s = os.path.getsize(p)
            if s > size:
                victim, size = p, s
    if victim is None:
        return None
    with open(victim, "r+b") as f:
        f.seek(max(0, size // 2))
        f.write(b"\xde\xad\xbe\xef")
    return victim


def make_injector(plan: FaultPlan, rcfg=None, preempt=None):
    """A ``fail_injector(step)`` callable for ``resilient_train`` that
    fires the plan's HOST-level fault (corrupt_ckpt / path_raise /
    preempt / device_loss).  In-graph and wrapper faults return a no-op
    injector so one code path installs any plan.

    ``preempt``: the run's :class:`flashmoe_tpu_torch.runtime.preempt.
    PreemptionListener` — the ``preempt`` fault notifies it
    programmatically (a deterministic SIGTERM stand-in).
    ``device_loss`` keeps raising at ``plan.step`` until the in-job
    retry budget is spent, modelling a device that stays gone until the
    process is restarted on the survivors."""
    fired = {"n": 0}

    def injector(i: int):
        if plan.fault == "device_loss":
            # persistent until the retry budget forces a process-level
            # restart: ``once`` semantics would let restore-and-retry
            # absorb it in-job, which a lost device never allows
            budget = getattr(rcfg, "max_retries", 3) + 1
            if i == plan.step and fired["n"] < budget:
                fired["n"] += 1
                raise RuntimeError(
                    f"chaos: injected device loss at step {i} "
                    f"({fired['n']}/{budget})")
            return
        if i != plan.step or (plan.once and fired["n"]):
            return
        if plan.fault == "corrupt_ckpt":
            fired["n"] += 1
            directory = getattr(rcfg, "checkpoint_dir", None)
            if directory:
                _corrupt_latest_checkpoint(directory)
            raise RuntimeError(
                f"chaos: injected crash after corrupting newest "
                f"checkpoint in {directory!r} (step {i})")
        if plan.fault == "path_raise":
            fired["n"] += 1
            from flashmoe_tpu_torch.planner.select import PathFailure

            raise PathFailure(
                "fused", f"chaos: injected path failure at step {i}")
        if plan.fault == "preempt":
            fired["n"] += 1
            if preempt is not None:
                # the step loop finishes THIS step, then drains: the
                # notice lands mid-step exactly like a real SIGTERM
                preempt.notify(source="chaos")

    return injector


def wrap_step(step_fn, plan: FaultPlan, deadline_s: float | None = None,
              load_share=None):
    """Wrap a train step with the plan's stall fault.

    ``slow_step``: the wrapped step sleeps ``plan.sleep_s`` at every
    step in ``[plan.step, plan.step + plan.duration)`` (each visited
    step at most once under ``plan.once``), which the resilient
    runner's wall-clock deadline converts into a detected StepFailure.

    ``slow_device``: models one DEGRADED (not dead) device gating the
    collective — the step slows by the share of expert work parked on
    that device: sleep = ``plan.sleep_s * load_share(step)``, sustained
    from ``plan.step`` for ``plan.duration`` steps.  ``load_share`` is
    the drill's probe of the live placement (e.g. ``controller.
    device_load_share(slow_dev) / rate``): once the self-healing
    controller re-places the hot experts off the slow device, the share
    — and the stall — collapses.  Defaults to a constant 1.0.

    Other faults pass through untouched."""
    if plan.fault == "slow_step":
        fired: set = set()

        def wrapped(state, batch):
            i = int(state.step)
            in_window = plan.step <= i < plan.step + plan.duration
            if in_window and not (plan.once and i in fired):
                fired.add(i)
                time.sleep(plan.sleep_s)
            return step_fn(state, batch)

        return wrapped
    if plan.fault == "slow_device":
        def wrapped(state, batch):
            i = int(state.step)
            if plan.step <= i < plan.step + plan.duration:
                share = float(load_share(i)) if load_share is not None \
                    else 1.0
                if share > 0:
                    time.sleep(plan.sleep_s * share)
            return step_fn(state, batch)

        return wrapped
    return step_fn


__all__ = ["FAULTS", "EXPECTED_TIER", "FaultPlan", "arm_plan", "clear",
           "inject", "make_injector", "wrap_step"]
