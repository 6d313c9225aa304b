"""Self-healing runtime controller: the telemetry -> planner ->
placement loop.

Counterpart of ``flashmoe_tpu/runtime/controller.py``, host logic
copied.  It watches the MoE statistics' load histograms and drop
fractions, the step time and the phase ledger through debounced,
hysteretic triggers and, at step boundaries only, takes one of two
graduated actions:

* **path morphing** (:class:`MorphAction`): re-run the planner's
  selection with the measured cost of the running path overriding its
  prior (:func:`flashmoe_tpu_torch.planner.adapt.replan`); the runner
  rebuilds its step with ``cfg.replace(**overrides)``, params and
  optimizer state untouched.  Triggered by sustained token drops or load
  skew.
* **expert re-placement** (:class:`ReplaceAction`): the observed
  per-expert load (an EMA of ``expert_load``) goes through the Decider's
  rate-proportional assignment
  (:func:`flashmoe_tpu_torch.parallel.decider.rebalance_placement`), and
  the live train state is permuted along the expert axis
  (:func:`permute_expert_state`: weights, their AdamW moments and the
  router's columns move together, on the device).  Where a dead slot
  exists the hottest expert is replicated onto it
  (``MoEConfig.expert_replicas``).  Triggered by a sustained step-time
  regression (a slow device).

On a multi-slice job a third axis, the **wire morph**, narrows the
two-stage exchange's cross-slice hop (``wire_dtype_dcn``) when the phase
ledger's exchange legs dominate the step.  The fabric-facing triggers
(:meth:`RuntimeController.observe_fabric`, :meth:`RuntimeController.
observe_spec`) are fed by the serving fabric
(:class:`~flashmoe_tpu_torch.fabric.engine.ServingFabric`) once a step,
which executes their drain and speculation verdicts.

Every action starts a cooldown window, each action class has a per-job
budget, and the skew trigger resets the moment its condition clears.
Every action is a registered decision (``controller.morph`` /
``controller.replace`` / ``controller.cooldown`` ...), and the timeline
rides :meth:`RuntimeController.state_dict` into the checkpoint manifest,
so restarts resume with the morphed plan and the spent budgets.
``python -m flashmoe_tpu_torch.observe`` renders it as the adaptation
report.

Wiring: ``resilient_train(..., controller=, rebuild_step=)``,
``supervise(..., controller=)`` / ``ResilienceConfig.adapt`` and
``runtime.trainer.train(..., controller=)``.  Drilled by ``python -m
flashmoe_tpu_torch.chaos`` (``skew_sustained`` recovers by a morph,
``slow_device`` by a re-placement).
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch

from flashmoe_tpu_torch.config import MoEConfig
from flashmoe_tpu_torch.tree import tree_map_with_path
from flashmoe_tpu_torch.utils.telemetry import Metrics, metrics as _global


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    """Trigger thresholds, debounce/cooldown windows, and action
    budgets.  Defaults are deliberately conservative: a controller
    should be boringly inert on a healthy job."""

    enable_morph: bool = True
    enable_replace: bool = True
    # --- skew trigger (drives morphing) ---
    drop_high: float = 0.05        # dropped-fraction EMA above => skew
    imbalance_high: float = 2.5    # load-imbalance EMA above => skew
    # --- slow trigger (drives re-placement) ---
    slow_factor: float = 1.5       # step_ms EMA > factor * baseline
    baseline_steps: int = 3        # baseline = min of the first N steps
    # --- a2a-dominance trigger (drives the DCN wire morph;
    #     armed only on multi-slice jobs — RuntimeController(slices=)) ---
    enable_wire_morph: bool = True
    a2a_share_high: float = 0.5    # a2a legs' share of the phase-ledger
    #                                sum above which the exchange (and on
    #                                a multi-slice job its DCN leg, the
    #                                slowest hop) dominates the step
    wire_morph_dtype: str = "e4m3"  # the DCN-hop wire the morph enables
    wire_morph_budget: int = 1
    # --- replica-morph trigger (the serving fabric's rotation) ---
    # armed only when a ServingFabric feeds observe_fabric(); the
    # controller drains a replica when the fabric runs sustained-idle
    # (mean per-replica queue+active below replica_queue_low) and
    # returns a drained one when pressure is back
    # (above replica_queue_high) — same debounce / cooldown / budget
    # discipline as every other morph
    enable_replica_morph: bool = False
    replica_queue_high: float = 4.0   # mean per-replica depth above
    replica_queue_low: float = 0.5    # ... and below => drain one
    replica_morph_budget: int = 2
    # --- spec-morph trigger (speculative decoding) ---
    # armed only when a serving loop feeds observe_spec(); the
    # controller switches speculation OFF when the observed draft
    # acceptance runs below the planner's break-even acceptance for
    # the debounce window (below break-even the verify span prices
    # under 1x tokens/step — pure overhead).  Exact rejection sampling
    # makes the morph free: token streams are unchanged either way
    enable_spec_morph: bool = False
    # acceptance floor; None defers to the planner break-even passed
    # to observe_spec(break_even=) by the serving loop
    spec_accept_floor: float | None = None
    spec_morph_budget: int = 1
    # --- dynamics ---
    debounce_steps: int = 3        # consecutive triggering observations
    cooldown_steps: int = 8        # no action for N steps after one
    ema_decay: float = 0.5         # per-step EMA decay of every signal
    # --- budgets (oscillation bound: hard per-job caps) ---
    morph_budget: int = 2
    replace_budget: int = 2
    # --- replication policy ---
    replicate: bool = True         # allow hot-expert replication
    cold_eps: float = 1e-3         # "dead slot" load-share ceiling
    # a re-placement must improve the projected bottleneck finish time
    # by at least this fraction, else it is a noop (a balanced layout
    # must never be churned for marginal or zero gain)
    min_replace_gain: float = 0.1

    def __post_init__(self):
        if self.debounce_steps < 1:
            raise ValueError("debounce_steps must be >= 1")
        if self.cooldown_steps < 0:
            raise ValueError("cooldown_steps must be >= 0")
        if not 0 < self.ema_decay < 1:
            raise ValueError("ema_decay must be in (0, 1)")
        if self.slow_factor <= 1.0:
            raise ValueError("slow_factor must be > 1")
        if not 0 < self.a2a_share_high < 1:
            raise ValueError("a2a_share_high must be in (0, 1)")
        if self.replica_queue_low >= self.replica_queue_high:
            raise ValueError(
                "replica_queue_low must be < replica_queue_high (the "
                "hysteresis band keeps drain/undrain from oscillating)")
        if (self.spec_accept_floor is not None
                and not 0 < self.spec_accept_floor < 1):
            raise ValueError("spec_accept_floor must be in (0, 1)")


@dataclasses.dataclass(frozen=True)
class BrownoutConfig:
    """Front-door brownout load-shedding thresholds (the
    RaMP-style degrade-don't-die arm of the serving ladder).

    The :class:`~flashmoe_tpu_torch.fabric.frontdoor.FrontDoor` observes
    fleet queue pressure and handoff-transport retry pressure every
    fabric step; when the hysteretic thresholds breach for
    ``debounce_steps`` consecutive observations it enters a brownout
    EPISODE — new admissions are shed (rejected at the door) or
    degraded (token budget capped) until pressure falls below the low
    watermark for the same debounce window.  Episodes are bounded by
    ``episode_budget`` and separated by ``cooldown_steps`` — the
    controller discipline, applied to admission control: a one-step
    blip must never shed a request, and a flapping signal must never
    oscillate the door."""

    #: mean per-live-replica (queue + active) depth above which the
    #: fleet counts as overloaded ...
    queue_high: float = 6.0
    #: ... and below which a brownout episode may end (hysteresis band)
    queue_low: float = 2.0
    #: handoff-transport retries observed since the previous step at or
    #: above this also count as a breach (the wire is failing — new
    #: admissions would pay retry latency on top of queue wait)
    retry_high: int = 3
    #: admission verdict while browned out: "shed" rejects the request
    #: at the door; "degrade" admits it with max_new_tokens capped at
    #: ``degrade_max_new``
    mode: str = "shed"
    degrade_max_new: int = 4
    debounce_steps: int = 2
    cooldown_steps: int = 4
    episode_budget: int = 2

    def __post_init__(self):
        if self.queue_low >= self.queue_high:
            raise ValueError(
                "queue_low must be < queue_high (the hysteresis band "
                "keeps the brownout from oscillating)")
        if self.mode not in ("shed", "degrade"):
            raise ValueError(f"mode must be 'shed' or 'degrade', "
                             f"got {self.mode!r}")
        if self.degrade_max_new < 1:
            raise ValueError("degrade_max_new must be >= 1")
        if self.debounce_steps < 1:
            raise ValueError("debounce_steps must be >= 1")
        if self.cooldown_steps < 0:
            raise ValueError("cooldown_steps must be >= 0")
        if self.episode_budget < 1:
            raise ValueError("episode_budget must be >= 1")
        if self.retry_high < 1:
            raise ValueError("retry_high must be >= 1")


@dataclasses.dataclass(frozen=True)
class MorphAction:
    """Path morph: rebuild the step with ``overrides`` applied."""

    overrides: dict
    trigger: str
    reason: str

    @property
    def needs_rebuild(self) -> bool:
        return bool(self.overrides)


@dataclasses.dataclass(frozen=True)
class ReplaceAction:
    """Expert re-placement: permute the live state by ``perm`` and, for
    each (hot, slot) replica pair, copy the hot expert's FFN weights
    onto the victim slot.  ``overrides`` carries the matching
    ``expert_replicas`` config change (empty when no replication, in
    which case the permutation needs no rebuild at all — the graph is
    placement-agnostic, only the params move)."""

    perm: tuple
    replica_pairs: tuple
    overrides: dict
    trigger: str
    reason: str

    @property
    def needs_rebuild(self) -> bool:
        return bool(self.overrides)


@dataclasses.dataclass(frozen=True)
class SpecMorphAction:
    """Speculation morph: switch draft-then-verify decoding ``off``
    across the fleet.  The fabric executes the verdict through each
    engine's :meth:`~flashmoe_tpu_torch.serving.engine.ServingEngine.
    set_speculate`; exact rejection sampling makes the switch cost
    zero tokens — only the tokens-per-step multiplier changes."""

    kind: str                      # 'off'
    trigger: str
    reason: str


@dataclasses.dataclass(frozen=True)
class ReplicaMorphAction:
    """Fabric rotation morph: ``drain`` takes ``replica`` out of the
    router's rotation (in-flight work keeps decoding), ``undrain``
    returns it.  The fabric executes the verdict through
    :meth:`~flashmoe_tpu_torch.fabric.router.ReplicaRouter.drain` /
    ``undrain``; the controller only decides."""

    kind: str                      # 'drain' | 'undrain'
    replica: int
    trigger: str
    reason: str


def detected_slices() -> int:
    """Slices the running job's ep axis spans — the default for
    :class:`RuntimeController`'s ``slices`` so production loops
    (``resilient_train`` / ``supervise`` / ``trainer.train``) arm the
    DCN wire morph without every call site learning the axis: the
    bootstrapped GroupPlan when a runtime exists, else live slice
    detection; 1 on any failure (detection must never block a step
    boundary)."""
    try:
        from flashmoe_tpu_torch.runtime import bootstrap

        rt = bootstrap._runtime
        if rt is not None and rt.group_plan is not None \
                and rt.group_plan.slices:
            return int(rt.group_plan.slices[0])
        from flashmoe_tpu_torch.parallel.topology import slice_structure

        ss = slice_structure()
        return int(ss[0]) if ss else 1
    except Exception:  # noqa: BLE001 — degrade to single-slice
        return 1


#: MoE param leaves stacked on a leading expert axis (permuted by
#: ``perm`` along axis 0); ``gate_w`` is the router table, permuted
#: along its expert COLUMNS instead.  The ``_qscale`` siblings are the
#: f32 scale sidecars of a quantized expert store
#: (flashmoe_tpu/quant/) — they MUST move with their payloads, or a
#: re-placement would decode every moved expert with another expert's
#: scales.
_EXPERT_AXIS0 = frozenset({
    "w_up", "b_up", "w_down", "b_down", "w_gate",
    "w_up_qscale", "w_down_qscale", "w_gate_qscale",
})


def _key_str(k) -> str:
    return re.sub(r"[^A-Za-z0-9_]", "", str(k))


def permute_expert_state(state, cfg: MoEConfig, perm,
                         replica_pairs=()):
    """Re-place experts in a live train state: every MoE leaf with an
    expert axis, the parameters and their AdamW moments alike (the
    optimizer state mirrors the parameter tree, so the key paths end
    alike, as optax's do), is permuted by ``perm[new_slot] = old_slot``;
    ``gate_w``'s columns move with their experts, so the model computes
    the same function under the new layout.  ``replica_pairs``: (hot,
    victim) new-slot pairs: the victim slot's FFN weights (and moments)
    are overwritten with the hot slot's (its router column is left
    alone; the split happens after top-k, :func:`flashmoe_tpu_torch.ops.
    gate.apply_replicas`).  Each touched leaf is gathered on its own
    device, bit for bit; the rest are kept as they are."""
    e = cfg.num_experts
    perm = tuple(int(p) for p in perm)
    if sorted(perm) != list(range(e)):
        raise ValueError(f"perm must be a permutation of range({e}), "
                         f"got {perm}")

    def fix(path, leaf):
        keys = [_key_str(k) for k in path]
        if "moe" not in keys or not torch.is_tensor(leaf):
            return leaf
        name = keys[-1]
        if name == "gate_w" and leaf.ndim >= 2 and leaf.shape[-1] == e:
            idx = torch.tensor(perm, dtype=torch.long, device=leaf.device)
            return leaf.index_select(leaf.ndim - 1, idx)
        if name in _EXPERT_AXIS0 and leaf.ndim >= 1 \
                and leaf.shape[0] == e:
            idx = torch.tensor(perm, dtype=torch.long, device=leaf.device)
            arr = leaf.index_select(0, idx)
            for hot, slot in replica_pairs:
                arr[slot] = arr[hot]
            return arr
        return leaf

    return tree_map_with_path(fix, state)


class RuntimeController:
    """The closed loop.  Feed it every step
    (:meth:`observe_step`), ask it at every step boundary
    (:meth:`maybe_act`), apply what it returns
    (:meth:`apply_action` for re-placements; rebuild the step with
    :attr:`cfg_overrides` when ``action.needs_rebuild``).

    ``n_devices``: the device count the placement math targets (the EP
    width; defaults to ``cfg.ep`` or 1).  ``rates_fn``: callable
    returning per-device throughput; the default (None) is a live
    re-probe through :func:`flashmoe_tpu_torch.runtime.throughput.
    device_rates` on ``device`` (the card by default), cache dropped,
    taken only when a slow-device re-placement is planned (the chaos
    drill reaches it through the ``probe_rates`` seam).  Pass an
    explicit callable to override, or one returning None to price
    devices uniformly; a probe that raises degrades to uniform rates
    with a ``controller.probe_error`` decision rather than blocking the
    step boundary.  ``d`` / ``gen``: the planner width and generation
    morphs re-select at (default ``n_devices`` / the planner's own).
    """

    def __init__(self, cfg: MoEConfig,
                 ccfg: ControllerConfig | None = None, *,
                 metrics: Metrics | None = None,
                 rates_fn=None, n_devices: int | None = None,
                 d: int | None = None, gen: str | None = None,
                 slices: int | None = None, device="cuda"):
        self.cfg = cfg
        self.device = device
        self.ccfg = ccfg or ControllerConfig()
        self.metrics = metrics if metrics is not None else _global
        self.rates_fn = (rates_fn if rates_fn is not None
                         else self._probe_rates)
        self.n_devices = int(n_devices or max(cfg.ep, 1))
        if cfg.num_experts % self.n_devices:
            raise ValueError(
                f"n_devices={self.n_devices} must divide "
                f"num_experts={cfg.num_experts}")
        self.d = int(d) if d is not None else self.n_devices
        self.gen = gen
        # slices the ep axis spans (bootstrap's GroupPlan / mocked):
        # the DCN wire morph only makes sense when a DCN hop exists.
        # Default (None) auto-detects, so the production loops arm the
        # axis on real multi-slice jobs without passing it through
        self.slices = (int(slices) if slices is not None
                       else detected_slices())
        # --- live signal state ---
        self.load_ema: np.ndarray | None = None   # [E] slot loads
        self.imbalance_ema: float | None = None
        self.drop_ema: float | None = None
        self.step_ms_ema: float | None = None
        # last INSTANTANEOUS observations: the debounce counters run on
        # these, not the EMAs — a single spike must not keep a trigger
        # "active" while its EMA tail decays across the window
        self._last_drop: float | None = None
        self._last_imb: float | None = None
        self._last_step_ms: float | None = None
        self.baseline_ms: float | None = None
        self._baseline_seen: list[float] = []
        # a2a-leg share of the phase ledger (the wire morph's signal)
        self.a2a_share_ema: float | None = None
        self._last_a2a_share: float | None = None
        self._skew_run = 0
        self._slow_run = 0
        self._a2a_run = 0
        # fabric replica-morph signal: fed by
        # observe_fabric(), never by the training loops
        self.fab_queue_ema: float | None = None
        self._last_fab_depth: float | None = None
        self._fab_n = 0
        self._fab_hi_run = 0
        self._fab_lo_run = 0
        # speculative-decode acceptance signal: fed by
        # observe_spec(), never by the training loops
        self.spec_accept_ema: float | None = None
        self._last_spec_accept: float | None = None
        self._spec_floor: float | None = None
        self._spec_lo_run = 0
        # --- persistent (manifest-riding) state ---
        self.overrides: dict = {}
        self.morphs_used = 0
        self.replaces_used = 0
        self.wire_morphs_used = 0
        self.replica_morphs_used = 0
        self.spec_morphs_used = 0
        self.cooldown_until = -1
        self.timeline: list[dict] = []
        self._cooldown_logged: set = set()

    # ------------------------------------------------------------------
    # Observation
    # ------------------------------------------------------------------

    def _ema(self, prev, value):
        a = self.ccfg.ema_decay
        return value if prev is None else a * prev + (1 - a) * value

    def observe_step(self, step: int, step_ms: float,
                     metrics_dict=None) -> None:
        """Fold one completed step into the trigger state.
        ``metrics_dict``: the step's device metrics (``moe_stats``
        consumed when present — requires ``cfg.collect_stats``)."""
        step = int(step)
        if len(self._baseline_seen) < self.ccfg.baseline_steps:
            self._baseline_seen.append(float(step_ms))
            # min, not mean: the first step carries compile time
            self.baseline_ms = min(self._baseline_seen)
        self.step_ms_ema = self._ema(self.step_ms_ema, float(step_ms))
        self._last_step_ms = float(step_ms)

        # phase-ledger a2a-leg share (the profiler's PhaseTimeline /
        # cost-ledger phase_ms dict — moe.a2a_dispatch[.k] +
        # moe.a2a_combine[.k] over every measured moe.* phase): the
        # signal the DCN wire morph debounces on
        self._last_a2a_share = None
        if isinstance(metrics_dict, dict):
            phases = metrics_dict.get("phase_ms")
            if isinstance(phases, dict) and phases:
                tot = sum(float(v) for v in phases.values())
                a2a = sum(float(v) for k, v in phases.items()
                          if str(k).startswith("moe.a2a_"))
                if tot > 0:
                    share = a2a / tot
                    self.a2a_share_ema = self._ema(self.a2a_share_ema,
                                                   share)
                    self._last_a2a_share = share

        stats = None
        if isinstance(metrics_dict, dict):
            stats = metrics_dict.get("moe_stats")
        if stats:
            from flashmoe_tpu_torch.ops.stats import stats_to_host

            load = None
            imb, drop = 0.0, 0.0
            for st in stats:
                h = st if isinstance(st, dict) else stats_to_host(st)
                v = np.asarray(h["expert_load"], dtype=np.float64)
                load = v if load is None else load + v
                imb = max(imb, float(h["imbalance"]))
                drop = max(drop, float(h["dropped_fraction"]))
            if load is not None:
                if self.load_ema is None \
                        or self.load_ema.shape != load.shape:
                    self.load_ema = load
                else:
                    a = self.ccfg.ema_decay
                    self.load_ema = a * self.load_ema + (1 - a) * load
            self.imbalance_ema = self._ema(self.imbalance_ema, imb)
            self.drop_ema = self._ema(self.drop_ema, drop)
            self._last_imb, self._last_drop = imb, drop

        # --- debounce with hysteresis: any clear observation resets ---
        if self._skew_active():
            self._skew_run += 1
        else:
            self._skew_run = 0
        if self._slow_active():
            self._slow_run += 1
        else:
            self._slow_run = 0
        if self._a2a_active():
            self._a2a_run += 1
        else:
            self._a2a_run = 0

    def _skew_active(self) -> bool:
        # instantaneous values: the debounce counts CONSECUTIVE skewed
        # observations, so a one-step blip resets at the next clear
        # step instead of riding its EMA decay tail across the window
        c = self.ccfg
        return ((self._last_drop is not None
                 and self._last_drop > c.drop_high)
                or (self._last_imb is not None
                    and self._last_imb > c.imbalance_high))

    def _slow_active(self) -> bool:
        return (self.baseline_ms is not None
                and self._last_step_ms is not None
                and len(self._baseline_seen) >= self.ccfg.baseline_steps
                and self._last_step_ms
                > self.ccfg.slow_factor * self.baseline_ms)

    def _a2a_active(self) -> bool:
        # instantaneous like the other debounces; gated on the job
        # actually having a DCN hop to narrow and the knob being off
        return (self.slices > 1
                and self._last_a2a_share is not None
                and self._last_a2a_share > self.ccfg.a2a_share_high
                and self._current_cfg().wire_dtype_dcn is None)

    def observe_fabric(self, step: int, depths) -> None:
        """Fold one fabric step's per-replica load (``queue_depth +
        active_requests``, the router's own JSQ signal) into the
        replica-morph trigger state.  Called by
        :meth:`~flashmoe_tpu_torch.fabric.engine.ServingFabric.step`; the
        debounce counts CONSECUTIVE pressured (or idle) observations,
        like every other trigger."""
        depths = [float(d) for d in depths]
        self._fab_n = len(depths)
        mean = sum(depths) / len(depths) if depths else 0.0
        self.fab_queue_ema = self._ema(self.fab_queue_ema, mean)
        self._last_fab_depth = mean
        c = self.ccfg
        if mean > c.replica_queue_high:
            self._fab_hi_run += 1
        else:
            self._fab_hi_run = 0
        if mean < c.replica_queue_low:
            self._fab_lo_run += 1
        else:
            self._fab_lo_run = 0

    def maybe_morph_replicas(self, step: int, draining=()):
        """The fabric's step-boundary decision: returns a
        :class:`ReplicaMorphAction` or None.  Sustained pressure
        returns the lowest-id DRAINED replica to the rotation
        (capacity back first); sustained idleness drains the highest-id
        replica still rotating (consolidate, never below one).  Same
        cooldown window / budget / decision-record discipline as
        :meth:`maybe_act` — and the same bit: a healthy fabric sees a
        boringly inert controller."""
        step = int(step)
        c = self.ccfg
        if not c.enable_replica_morph:
            return None
        hi = self._fab_hi_run >= c.debounce_steps
        lo = self._fab_lo_run >= c.debounce_steps
        if not (hi or lo):
            return None
        if step < self.cooldown_until:
            key = ("replica", self.cooldown_until)
            if key not in self._cooldown_logged:
                self._cooldown_logged.add(key)
                self._decide("controller.cooldown", step=step,
                             trigger="replica",
                             until=self.cooldown_until)
            return None
        if self.replica_morphs_used >= c.replica_morph_budget:
            return None
        draining = {int(d) for d in draining}
        if hi:
            if not draining:
                return None        # full rotation already
            target, kind, trig = min(draining), "undrain", "queue_high"
            reason = (f"sustained queue pressure (mean depth "
                      f"{self._last_fab_depth:.2f} > "
                      f"{c.replica_queue_high}): return replica "
                      f"{target} to the rotation")
        else:
            rotating = [i for i in range(self._fab_n)
                        if i not in draining]
            if len(rotating) <= 1:
                return None        # never drain the last replica
            target, kind, trig = max(rotating), "drain", "queue_low"
            reason = (f"sustained idle fabric (mean depth "
                      f"{self._last_fab_depth:.2f} < "
                      f"{c.replica_queue_low}): drain replica "
                      f"{target}")
        self.replica_morphs_used += 1
        self._cooldown(step)
        self._decide(
            "controller.replica_morph", step=step, trigger=trig,
            kind=kind, replica=int(target),
            queue_ema=(round(self.fab_queue_ema, 4)
                       if self.fab_queue_ema is not None else None),
            draining=sorted(draining), replicas=self._fab_n,
            budget_left=(c.replica_morph_budget
                         - self.replica_morphs_used),
            reason=reason)
        return ReplicaMorphAction(kind, int(target), trig, reason)

    def observe_spec(self, step: int, accept_rate, *,
                     break_even=None) -> None:
        """Fold one serving observation of the fleet draft-acceptance
        rate into the spec-morph trigger state.  ``accept_rate`` None
        (nothing drafted yet) leaves the state untouched —
        no-draft steps must not debounce toward a morph.
        ``break_even`` is the planner's break-even acceptance
        (:func:`~flashmoe_tpu_torch.planner.model.speculate_break_even`); an
        explicit ``ControllerConfig.spec_accept_floor`` overrides it.
        Like every trigger, the debounce counter runs on the
        INSTANTANEOUS observation; the EMA rides the decision record."""
        if accept_rate is None:
            return
        ar = float(accept_rate)
        self.spec_accept_ema = self._ema(self.spec_accept_ema, ar)
        self._last_spec_accept = ar
        c = self.ccfg
        floor = c.spec_accept_floor
        if floor is None and break_even is not None:
            floor = float(break_even)
        self._spec_floor = floor
        if floor is not None and ar < floor:
            self._spec_lo_run += 1
        else:
            self._spec_lo_run = 0

    def maybe_morph_spec(self, step: int, *, spec_on: bool = True):
        """The serving loop's step-boundary decision: returns a
        :class:`SpecMorphAction` (switch speculation off) or None.
        Same debounce / cooldown window / budget / decision-record
        discipline as every other morph; ``spec_on`` False (already
        morphed, or never armed) is always a None."""
        step = int(step)
        c = self.ccfg
        if not c.enable_spec_morph or not spec_on:
            return None
        if self._spec_lo_run < c.debounce_steps:
            return None
        if step < self.cooldown_until:
            key = ("spec", self.cooldown_until)
            if key not in self._cooldown_logged:
                self._cooldown_logged.add(key)
                self._decide("controller.cooldown", step=step,
                             trigger="spec",
                             until=self.cooldown_until)
            return None
        if self.spec_morphs_used >= c.spec_morph_budget:
            return None
        reason = (f"sustained low draft acceptance "
                  f"({self._last_spec_accept:.3f} < break-even "
                  f"{self._spec_floor:.3f}): the verify span prices "
                  f"below 1x tokens/step — switch speculation off")
        self.spec_morphs_used += 1
        self._cooldown(step)
        self._decide(
            "controller.spec_morph", step=step, trigger="accept_low",
            kind="off",
            accept_ema=(round(self.spec_accept_ema, 4)
                        if self.spec_accept_ema is not None else None),
            break_even=(round(self._spec_floor, 4)
                        if self._spec_floor is not None else None),
            budget_left=c.spec_morph_budget - self.spec_morphs_used,
            reason=reason)
        return SpecMorphAction("off", "accept_low", reason)

    def device_load_share(self, device: int) -> float:
        """Observed load share of one device's slot block under the
        CURRENT physical layout (slot s lives on device s // nLx) —
        what a slow-device simulation (or dashboard) reads."""
        if self.load_ema is None:
            return 1.0 / self.n_devices
        total = float(self.load_ema.sum())
        if total <= 0:
            return 1.0 / self.n_devices
        nlx = self.cfg.num_experts // self.n_devices
        lo = device * nlx
        return float(self.load_ema[lo:lo + nlx].sum()) / total

    # ------------------------------------------------------------------
    # Decision
    # ------------------------------------------------------------------

    @property
    def cfg_overrides(self) -> dict:
        """Accumulated ``MoEConfig.replace`` kwargs a rebuilt step must
        apply (morph targets + the replica routing map)."""
        return dict(self.overrides)

    def apply_to(self, cfg: MoEConfig) -> MoEConfig:
        return cfg.replace(**self.overrides) if self.overrides else cfg

    def _current_cfg(self) -> MoEConfig:
        return self.apply_to(self.cfg)

    def maybe_act(self, step: int, can_rebuild: bool = True):
        """The step-boundary decision: returns a :class:`MorphAction`,
        a :class:`ReplaceAction`, or None.  At most one action per
        boundary; during a cooldown window suppressed triggers are
        recorded as ``controller.cooldown`` decisions (once per window
        per trigger)."""
        step = int(step)
        c = self.ccfg
        skew = self._skew_run >= c.debounce_steps and c.enable_morph
        slow = self._slow_run >= c.debounce_steps and c.enable_replace
        wire = (self._a2a_run >= c.debounce_steps
                and c.enable_wire_morph and self.slices > 1)
        if not (skew or slow or wire):
            return None
        if step < self.cooldown_until:
            for name, hit in (("skew", skew), ("slow", slow),
                              ("a2a", wire)):
                key = (name, self.cooldown_until)
                if hit and key not in self._cooldown_logged:
                    self._cooldown_logged.add(key)
                    self._decide("controller.cooldown", step=step,
                                 trigger=name,
                                 until=self.cooldown_until)
            return None
        # slow wins ties: a degraded device also skews load downstream,
        # and re-placement is the cheaper action (no rebuild unless a
        # replica lands)
        if slow and self.replaces_used < c.replace_budget:
            act = self._plan_replace(step)
            if act is not None:
                return act
            if step < self.cooldown_until:
                return None  # planned a noop: its cooldown stands
        if skew and self.morphs_used < c.morph_budget and can_rebuild:
            act = self._plan_morph(step)
            if act is not None:
                return act
            if step < self.cooldown_until:
                return None
        if wire and self.wire_morphs_used < c.wire_morph_budget \
                and can_rebuild:
            return self._plan_wire_morph(step)
        return None

    def _cooldown(self, step: int) -> None:
        self.cooldown_until = step + self.ccfg.cooldown_steps
        self._skew_run = 0
        self._slow_run = 0
        self._a2a_run = 0
        self._fab_hi_run = 0
        self._fab_lo_run = 0
        self._spec_lo_run = 0
        # a fresh baseline: the action changed what "normal" looks like
        self._baseline_seen = []
        self.baseline_ms = None
        self.step_ms_ema = None
        self._last_step_ms = None

    def _decide(self, name: str, **fields) -> dict:
        rec = self.metrics.decision(name, **fields)
        self.timeline.append(rec)
        return rec

    def _plan_morph(self, step: int):
        from flashmoe_tpu_torch.planner import adapt

        cfg = self._current_cfg()
        drop_driven = (self.drop_ema is not None
                       and self.drop_ema > self.ccfg.drop_high)
        fam = adapt.current_family(cfg, self.d)
        measured = (adapt.measured_ledger(fam, self.step_ms_ema)
                    if self.step_ms_ema else None)
        plan = adapt.replan(cfg, self.d, gen=self.gen,
                            measured_ms=measured,
                            prefer_dropless=drop_driven)
        if plan.is_noop:
            self._decide("controller.cooldown", step=step,
                         trigger="skew", until=step,
                         reason=f"replan noop: {plan.reason}")
            self._cooldown(step)
            return None
        self.overrides.update(plan.overrides)
        self.morphs_used += 1
        self._cooldown(step)
        self._decide(
            "controller.morph", step=step, trigger="skew",
            mode=plan.mode, backend=plan.backend,
            a2a_chunks=plan.a2a_chunks, dropless=plan.dropless,
            overrides={k: v for k, v in plan.overrides.items()},
            drop_ema=(round(self.drop_ema, 4)
                      if self.drop_ema is not None else None),
            imbalance_ema=(round(self.imbalance_ema, 4)
                           if self.imbalance_ema is not None else None),
            predicted_ms=plan.predicted_ms,
            budget_left=self.ccfg.morph_budget - self.morphs_used,
            reason=plan.reason)
        return MorphAction(dict(plan.overrides), "skew", plan.reason)

    def _plan_wire_morph(self, step: int):
        """Wire-dtype morph: the
        phase ledger shows the a2a legs dominating the step on a
        multi-slice job, so narrow the DCN hop — flip
        ``wire_dtype_dcn`` to the configured fp8 wire and let the
        runner rebuild its step, with the same cooldown / budget / manifest
        discipline as a path morph.  The two-stage exchange then ships
        ~4x fewer DCN bytes while the in-slice hop keeps the compute
        dtype (quality guarded by the ``wire_rtq_error_dcn`` proxy in
        MoEStats)."""
        overrides = {"wire_dtype_dcn": self.ccfg.wire_morph_dtype}
        self.overrides.update(overrides)
        self.wire_morphs_used += 1
        self._cooldown(step)
        self._decide(
            "controller.wire_morph", step=step, trigger="a2a",
            wire_dtype_dcn=self.ccfg.wire_morph_dtype,
            a2a_share_ema=(round(self.a2a_share_ema, 4)
                           if self.a2a_share_ema is not None else None),
            slices=self.slices,
            budget_left=(self.ccfg.wire_morph_budget
                         - self.wire_morphs_used),
            reason="a2a legs dominate the phase ledger on a "
                   "multi-slice job: narrow the DCN hop to "
                   f"{self.ccfg.wire_morph_dtype}")
        return MorphAction(overrides, "a2a",
                           "DCN-hop wire narrowed after sustained "
                           "a2a-leg dominance")

    def _probe_rates(self):
        """Default ``rates_fn``: live per-device throughput re-probe
        (:func:`flashmoe_tpu_torch.runtime.throughput.device_rates`,
        ``fresh=True`` so a re-trigger measures the device as it is).
        Consulted only when a slow-device re-placement is planned, never
        in the step loop."""
        from flashmoe_tpu_torch.runtime import throughput

        return throughput.device_rates(self._current_cfg(),
                                       self.n_devices, fresh=True,
                                       device=self.device)

    def _plan_replace(self, step: int):
        from flashmoe_tpu_torch.parallel.decider import (
            placement_permutation, rebalance_placement,
        )

        if self.load_ema is None or float(self.load_ema.sum()) <= 0:
            return None  # no load signal yet: nothing to re-place on
        rates = None
        if self.rates_fn is not None:
            try:
                r = self.rates_fn()
            except Exception as e:  # noqa: BLE001 — degrade, don't block
                self._decide("controller.probe_error", step=step,
                             reason=f"{type(e).__name__}: {str(e)[:200]}")
                r = None
            if r is not None:
                rates = np.asarray(r, dtype=np.float64)
        placement = rebalance_placement(
            self.load_ema, self.n_devices, self.cfg, rates=rates,
            replicate=self.ccfg.replicate, cold_eps=self.ccfg.cold_eps)
        perm = placement_permutation(placement)
        pairs = tuple(sorted(
            (int(hot), int(v))
            for hot, vs in placement.replicas.items() for v in vs))

        # projected bottleneck finish time, current layout vs proposal
        # (a replica halves its hot slot's load): churn only for a real
        # improvement — a balanced layout re-shuffled for zero gain
        # would look like oscillation
        r = (rates if rates is not None
             else np.ones(self.n_devices, dtype=np.float64))
        nlx = self.cfg.num_experts // self.n_devices

        def makespan(slot_loads):
            per_dev = slot_loads.reshape(self.n_devices, nlx).sum(axis=1)
            return float(np.max(per_dev / np.maximum(r, 1e-9)))

        cur = makespan(self.load_ema)
        proposed_loads = self.load_ema[np.asarray(perm)].copy()
        for hot, victim in pairs:
            proposed_loads[victim] = proposed_loads[hot] / 2
            proposed_loads[hot] /= 2
        proposed = makespan(proposed_loads)
        if (perm == tuple(range(self.cfg.num_experts)) and not pairs) \
                or proposed > cur * (1 - self.ccfg.min_replace_gain):
            self._decide("controller.cooldown", step=step,
                         trigger="slow", until=step,
                         reason="re-placement noop: layout already "
                                "rate-balanced "
                                f"(projected {proposed:.3g} vs "
                                f"current {cur:.3g})")
            self._cooldown(step)
            return None
        before = [self.device_load_share(d)
                  for d in range(self.n_devices)]
        overrides = {"expert_replicas": pairs} if pairs else {}
        if pairs:
            self.overrides["expert_replicas"] = pairs
        self.replaces_used += 1
        self._cooldown(step)
        rec_rates = (rates.tolist() if rates is not None else None)
        self._decide(
            "controller.replace", step=step, trigger="slow",
            perm=list(perm), replicas=[list(p) for p in pairs],
            device_share_before=[round(s, 4) for s in before],
            rates=rec_rates,
            step_ms_ema=(round(self.step_ms_ema, 3)
                         if self.step_ms_ema is not None else None),
            baseline_ms=(round(self.baseline_ms, 3)
                         if self.baseline_ms is not None else None),
            budget_left=self.ccfg.replace_budget - self.replaces_used,
            reason="sustained step-time regression: rate-proportional "
                   "re-placement of the observed load histogram")
        # the load histogram indexes physical slots: re-index it under
        # the new layout so post-action observations stay coherent
        self.load_ema = self.load_ema[np.asarray(perm)]
        return ReplaceAction(perm, pairs, overrides, "slow",
                             "rate-proportional expert re-placement")

    # ------------------------------------------------------------------
    # Application / persistence
    # ------------------------------------------------------------------

    def apply_action(self, action, state):
        """Apply an action to the live train state.  Morphs leave the
        state untouched (the runner rebuilds the step); re-placements
        permute expert params and moments and copy replica weights."""
        if isinstance(action, ReplaceAction):
            return permute_expert_state(state, self.cfg, action.perm,
                                        action.replica_pairs)
        return state

    def snapshot(self) -> dict:
        """Live ``/healthz`` view: remaining action budgets, the
        cooldown window, current trigger run lengths, and the
        accumulated overrides — "what can the self-healer still do"."""
        c = self.ccfg
        return {
            "budgets": {
                "morph": c.morph_budget - self.morphs_used,
                "replace": c.replace_budget - self.replaces_used,
                "wire_morph": c.wire_morph_budget - self.wire_morphs_used,
                "replica_morph": (c.replica_morph_budget
                                  - self.replica_morphs_used),
                "spec_morph": (c.spec_morph_budget
                               - self.spec_morphs_used),
            },
            "cooldown_until": self.cooldown_until,
            "trigger_runs": {"skew": self._skew_run,
                             "slow": self._slow_run,
                             "a2a": self._a2a_run,
                             "replica_hi": self._fab_hi_run,
                             "replica_lo": self._fab_lo_run,
                             "spec_lo": self._spec_lo_run},
            "overrides": {k: (list(map(list, v))
                              if k == "expert_replicas" else v)
                          for k, v in self.overrides.items()},
            "actions_taken": len(self.timeline),
        }

    def state_dict(self) -> dict:
        """JSON-able persistent state, written into every checkpoint
        manifest after an action (``runtime.checkpoint.save(...,
        controller_state=)``), so a restarted incarnation resumes with
        the morphed plan, the replica map, and the SPENT budgets — a
        restart must not refill the oscillation bound."""
        ov = dict(self.overrides)
        if "expert_replicas" in ov:
            ov["expert_replicas"] = [list(p)
                                     for p in ov["expert_replicas"]]
        return {"overrides": ov,
                "morphs_used": self.morphs_used,
                "replaces_used": self.replaces_used,
                "wire_morphs_used": self.wire_morphs_used,
                "replica_morphs_used": self.replica_morphs_used,
                "spec_morphs_used": self.spec_morphs_used,
                "timeline": list(self.timeline)}

    def load_state_dict(self, sd: dict) -> None:
        ov = dict(sd.get("overrides") or {})
        if ov.get("expert_replicas"):
            ov["expert_replicas"] = tuple(
                tuple(int(v) for v in p) for p in ov["expert_replicas"])
        elif "expert_replicas" in ov:
            ov.pop("expert_replicas")
        self.overrides = ov
        # budgets are MONOTONIC: a rewind restores the plan the params
        # were saved under but never refills the oscillation bound
        self.morphs_used = max(self.morphs_used,
                               int(sd.get("morphs_used", 0)))
        self.replaces_used = max(self.replaces_used,
                                 int(sd.get("replaces_used", 0)))
        self.wire_morphs_used = max(self.wire_morphs_used,
                                    int(sd.get("wire_morphs_used", 0)))
        self.replica_morphs_used = max(
            self.replica_morphs_used,
            int(sd.get("replica_morphs_used", 0)))
        self.spec_morphs_used = max(
            self.spec_morphs_used,
            int(sd.get("spec_morphs_used", 0)))
        stored = list(sd.get("timeline") or [])
        if len(stored) > len(self.timeline):
            self.timeline = stored
