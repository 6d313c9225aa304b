"""The disaggregated serving fabric: N decode replicas behind a router,
fed by a prefill pool across the KV handoff wire.

Counterpart of ``flashmoe_tpu/fabric/engine.py``.  The world is the
port's ranks (:func:`flashmoe_tpu_torch.fabric.topo.world_ranks`): the
bootstrapped runtime's virtual ranks of one card, or the
``torch.distributed`` world.  Every replica and the prefill pool run on
the device of ``params``, and every replica shares those parameter
tensors (no copy a replica); only a decode pool with its own
``expert_quant`` holds a quantized store of its own, made at load as the
engine makes one.

One :class:`ServingFabric` composes the pieces the rest of the package
provides:

* **pools** — :func:`flashmoe_tpu_torch.serving.pools.plan_serving_pools`
  splits the rank world into Decider-formed prefill and decode groups
  (each with its own planner path and its own quant/wire config) when
  the world has >= 2 ranks; a one-rank world runs co-located, pool plan
  ``None``;
* **replicas** — ``replicas`` full :class:`~flashmoe_tpu_torch.serving.
  engine.ServingEngine` instances (count from
  :func:`~flashmoe_tpu_torch.fabric.topo.fabric_world`, i.e. the
  ``FLASHMOE_MOCK_FABRIC`` blocking on a mocked drill), sharing ONE
  metrics object so ``/metrics`` aggregates the fabric and the
  per-replica ``serve.rK.ttft_ms`` / ``.tpot_ms`` sketches split it;
* **handoff** — every replica's prefill runs through one
  :class:`~flashmoe_tpu_torch.fabric.handoff.KVHandoff` (the engine's
  ``prefill_fn`` seam): the prompt is computed with the prefill pool's
  config and crosses to the replica as DCN-priced pages.  With
  ``kv_wire_dtype=None`` the crossing is exact, which is what makes the
  acceptance drill token-bit-equal to a single-pool engine;
* **router** — :class:`~flashmoe_tpu_torch.fabric.router.ReplicaRouter`
  places each submitted request (JSQ + session affinity over the live
  ``/healthz`` snapshots); the runtime controller's replica-morph
  verdicts (:meth:`~flashmoe_tpu_torch.runtime.controller.RuntimeController.
  maybe_morph_replicas`) drain/undrain the rotation with the
  debounce/cooldown/budget discipline.

Determinism: replicas share the engine's step functions, the router
breaks ties on the lowest id, page pools are LIFO, and sampling keys on
(request seed, token index), so a fabric drill replays bit-identically
and (wire off) matches the single-pool engine token for token regardless
of how requests land on replicas, wherever a step's rows do not change
the arithmetic of the others (the plain versions on the CPU).
"""

from __future__ import annotations

import os
import tempfile

from flashmoe_tpu_torch.config import MoEConfig
from flashmoe_tpu_torch.fabric.handoff import KVHandoff
from flashmoe_tpu_torch.fabric.router import ReplicaRouter
from flashmoe_tpu_torch.fabric.topo import fabric_world, world_ranks
from flashmoe_tpu_torch.serving.engine import ServeConfig, ServingEngine
from flashmoe_tpu_torch.utils.telemetry import metrics as _global_metrics

# "break-even not priced yet" — distinct from None (priced, infeasible)
_SPEC_BE_UNSET = object()


class _ReplicaStallInjected(RuntimeError):
    """A ``replica_stall`` chaos plan hung the victim mid-step: its
    engine never returns from this step.  The fabric models the hung
    thread by catching this and never stepping the replica again —
    NOTHING announces the stall; only the heartbeat deadline can."""


class ServingFabric:
    """N-replica disaggregated serving driver.

    ``replicas=None`` resolves the count from :func:`fabric_world`
    (``FLASHMOE_MOCK_FABRIC`` on mocked drills, else 1).  ``serve``
    applies to every replica.  ``prefill_overrides`` /
    ``decode_overrides`` are per-pool ``MoEConfig.replace`` fields
    forwarded to :func:`plan_serving_pools` — the decode replicas run
    the decode pool's config (e.g. ``{"expert_quant": "int8"}`` loads
    the int8 store per replica), the handoff prefills with the
    prefill pool's.  ``controller``: a
    :class:`~flashmoe_tpu_torch.runtime.controller.RuntimeController` whose
    replica-morph trigger is armed (``enable_replica_morph=True``)
    observes every fabric step and drains/undrains the rotation."""

    def __init__(self, params, cfg: MoEConfig,
                 serve: ServeConfig | None = None, *,
                 replicas: int | None = None, decode_share: float = 0.5,
                 prefill_overrides: dict | None = None,
                 decode_overrides: dict | None = None,
                 metrics_obj=None, controller=None, recorder=None,
                 telemetry_port=None, affinity: bool = True,
                 vclock=None, tracer=None, transport=None,
                 fault_plan=None, heartbeat=None):
        """``vclock``: a :class:`~flashmoe_tpu_torch.fabric.vclock.
        VirtualClock` the whole fabric steps on — one lane per replica,
        tick resolved from the pool plan's decode objective when unset;
        None (default) is the wall clock.  ``tracer``: a shared
        :class:`~flashmoe_tpu_torch.telemetry_plane.tracing.RequestTracer`
        every replica reports into (the FrontDoor's trace authority —
        replicas step sequentially, so one listener is race-free).
        ``transport``: a :class:`~flashmoe_tpu_torch.fabric.transport.
        HandoffTransport` the handoff sends every payload through —
        per-page CRC32 verify, timeout + bounded retry; None (default)
        keeps the in-process wire.  ``fault_plan``: an armed
        :class:`~flashmoe_tpu_torch.chaos.FaultPlan` with fault
        ``replica_crash`` — replica ``plan.expert % n_replicas`` dies
        silently at fabric step ``plan.step``; the crash DETECTOR
        (health probes at the top of every step) notices and migrates
        its requests, it is never told — or ``replica_stall``: the
        victim HANGS mid-step (its health probe still answers, so only
        the sub-step heartbeat deadline catches it).  ``heartbeat``: a
        :class:`~flashmoe_tpu_torch.fabric.leasestore.HeartbeatConfig` —
        every replica publishes sub-step heartbeats into the external
        lease store and a watchdog declares a replica with pending work
        stalled after ``misses_to_stall`` beat-less fabric steps,
        triggering the same fence+evacuate+adopt migration a detected
        crash takes; None (default) publishes nothing."""
        if fault_plan is not None \
                and fault_plan.fault not in ("replica_crash",
                                             "replica_stall"):
            raise ValueError(
                f"ServingFabric only injects 'replica_crash' / "
                f"'replica_stall', got plan fault {fault_plan.fault!r}")
        if fault_plan is not None \
                and fault_plan.fault == "replica_stall" \
                and heartbeat is None:
            raise ValueError(
                "a replica_stall plan needs heartbeat= armed: a "
                "mid-step hang is only detectable through the sub-step "
                "heartbeat deadline (probes still answer)")
        self.fault_plan = fault_plan
        self.cfg = cfg
        self.serve = serve if serve is not None else ServeConfig()
        self.metrics = (metrics_obj if metrics_obj is not None
                        else _global_metrics)
        self.controller = controller
        self.vclock = vclock
        # fleet speculation trigger state: cumulative (drafted,
        # accepted) at the last controller observation, and the lazily
        # priced planner break-even (sentinel = not priced yet)
        self._spec_prev = (0, 0)
        self._spec_be = _SPEC_BE_UNSET

        ranks, row = world_ranks()
        if replicas is None:
            replicas, _ = fabric_world(len(ranks))
        self.n_replicas = int(replicas)
        if self.n_replicas < 1:
            raise ValueError(f"fabric needs >= 1 replica, got "
                             f"{self.n_replicas}")

        # ---- pool formation (>= 2 ranks; else co-located) ------------
        self.pool_plan = None
        prefill_cfg = decode_cfg = cfg
        if len(ranks) >= 2:
            from flashmoe_tpu_torch.parallel.topology import (
                ici_adjacency, measured_worker_attrs,
            )
            from flashmoe_tpu_torch.serving.pools import plan_serving_pools

            # virtual ranks of one device share its rate (one probe of
            # the process); a process world gathers one rate a process
            self.pool_plan = plan_serving_pools(
                ici_adjacency(ranks, platform=row),
                measured_worker_attrs(len(ranks) if row else 1, cfg,
                                      probe=False), cfg,
                decode_share=decode_share,
                decode_tokens=self.serve.max_batch, devices=ranks,
                prefill_overrides=prefill_overrides,
                decode_overrides=decode_overrides)
            prefill_cfg = self.pool_plan.prefill_cfg or cfg
            decode_cfg = self.pool_plan.decode_cfg or cfg
        elif prefill_overrides or decode_overrides:
            prefill_cfg = (cfg.replace(**prefill_overrides)
                           if prefill_overrides else cfg)
            decode_cfg = (cfg.replace(**decode_overrides)
                          if decode_overrides else cfg)
        self.prefill_cfg = prefill_cfg
        self.decode_cfg = decode_cfg

        # ---- the handoff link (prefill pool side) --------------------
        # prefill always computes full-precision math on the handed
        # params (the engine-side quant store is a DECODE-pool
        # property), so the handoff sees the same prefill the
        # single-pool engine would run
        decode_step_ms = (self.pool_plan.decode_ms
                          if self.pool_plan is not None else None)
        if self.vclock is not None:
            # one lane per replica; the decode tick is the pool plan's
            # per-step objective (what the priced verdict judges
            # against), so an unperturbed drill reconciles exactly
            self.vclock.ensure_lanes(self.n_replicas)
            if self.vclock.tick_ms is None:
                self.vclock.tick_ms = (decode_step_ms
                                       if decode_step_ms else 1.0)
        self.handoff = KVHandoff(
            params, prefill_cfg, self.serve.page_size,
            metrics_obj=self.metrics,
            decode_step_ms=decode_step_ms, vclock=self.vclock,
            transport=transport)

        # ---- sub-step heartbeats (external lease store) --------------
        self.heartbeat_cfg = heartbeat
        self.lease_store = None
        self.hb_watchdog = None
        self._own_store_path = None
        self._stalled: set[int] = set()  # hung mid-step (undetected
        #                                  until the heartbeat deadline)
        hb_fns: list = [None] * self.n_replicas
        if heartbeat is not None:
            from flashmoe_tpu_torch.fabric.leasestore import (
                HeartbeatPublisher, HeartbeatWatchdog, LeaseStore,
            )

            store_path = heartbeat.store_path
            if store_path is None:
                fd, store_path = tempfile.mkstemp(
                    prefix="flashmoe-leases-", suffix=".bin")
                os.close(fd)
                self._own_store_path = store_path
            self.lease_store = LeaseStore(
                store_path, metrics_obj=self.metrics)
            tick = (self.vclock.tick_ms if self.vclock is not None
                    else (decode_step_ms or 0.0))
            self.hb_watchdog = HeartbeatWatchdog(
                self.lease_store,
                misses_to_stall=heartbeat.misses_to_stall,
                tick_ms=tick, metrics_obj=self.metrics)
            for i in range(self.n_replicas):
                pub = HeartbeatPublisher(
                    self.lease_store, i, clock=self.vclock,
                    step_fn=(lambda i=i: self.engines[i].step_idx))
                hb_fns[i] = self._wrap_heartbeat(i, pub)

        # ---- decode replicas -----------------------------------------
        pools_info = (self.pool_plan.snapshot()
                      if self.pool_plan is not None else None)
        self.engines = [
            ServingEngine(
                params, decode_cfg, self.serve,
                metrics_obj=self.metrics, recorder=recorder,
                replica_tag=f"r{i}", prefill_fn=self.handoff.prefill_fn(i),
                pools_info=pools_info, clock=self.vclock,
                tracer=tracer, heartbeat_fn=hb_fns[i])
            for i in range(self.n_replicas)
        ]
        # the router probes through the fabric's crash filter: a killed
        # replica's probe RAISES (the process is gone — there is no
        # polite snapshot), which is exactly what an external /healthz
        # probe of a dead host experiences
        self._killed: set[int] = set()   # dead (silently, undetected)
        self._crashed: set[int] = set()  # detected + evacuated
        self.migrated = 0
        self.router = ReplicaRouter(
            [self._probe_fn(i) for i in range(self.n_replicas)],
            metrics_obj=self.metrics, affinity=affinity)
        self._placement: dict = {}      # rid -> replica
        self.step_idx = 0

        self.telemetry = None
        if telemetry_port is not None:
            from flashmoe_tpu_torch.telemetry_plane.server import maybe_server

            self.telemetry = maybe_server(
                telemetry_port, metrics_fn=lambda: self.metrics,
                health_fn=self._health_snapshot,
                vars_fn=self._vars_snapshot)

    # ---- live-plane snapshots ----------------------------------------

    def _health_snapshot(self) -> dict:
        """Fabric ``/healthz``: the aggregate load story plus each
        replica's own document."""
        reps = [e._health_snapshot() for e in self.engines]
        return {
            "steps": self.step_idx,
            "queue_depth": sum(r["queue_depth"] for r in reps),
            "active_requests": sum(r["active_requests"] for r in reps),
            "completed": sum(r["completed"] for r in reps),
            "evictions": sum(r["evictions"] for r in reps),
            "crashed": sorted(self._crashed),
            "stalled": sorted(self._stalled),
            "migrated": self.migrated,
            "router": self.router.snapshot(),
            "replicas": reps,
        }

    def _vars_snapshot(self) -> dict:
        """Fabric ``/vars``: pool plan, handoff link, router rotation,
        and every replica's resolved plans."""
        return {
            "replicas": self.n_replicas,
            "pools": (self.pool_plan.snapshot()
                      if self.pool_plan is not None else None),
            "handoff": self.handoff.snapshot(),
            "vclock": (self.vclock.snapshot()
                       if self.vclock is not None else None),
            "lease_store": (self.lease_store.snapshot()
                            if self.lease_store is not None else None),
            "watchdog": (self.hb_watchdog.snapshot()
                         if self.hb_watchdog is not None else None),
            "router": self.router.snapshot(),
            "engines": [e._vars_snapshot() for e in self.engines],
        }

    def close(self) -> None:
        if self.telemetry is not None:
            self.telemetry.stop()
            self.telemetry = None
        for e in self.engines:
            e.close()
        if self._own_store_path is not None:
            try:
                os.unlink(self._own_store_path)
            except OSError:
                pass
            self._own_store_path = None

    # ---- crash detection + request migration -------------------------

    def _wrap_heartbeat(self, i: int, publisher):
        """Replica ``i``'s heartbeat callable, with the
        ``replica_stall`` injection spliced in: at fabric step
        ``plan.step`` the victim hangs at the ``prefill`` phase
        boundary — it beat at ``admit``, then went silent mid-step,
        before any token sampled.  Everything already admitted/prefilled
        is the partial-step work the migration must reconcile."""
        def beat(phase: str) -> None:
            p = self.fault_plan
            if (p is not None and p.fault == "replica_stall"
                    and i == p.expert % self.n_replicas
                    and self.step_idx == p.step
                    and phase == "prefill"
                    and i not in self._stalled):
                raise _ReplicaStallInjected(
                    f"chaos: replica r{i} hung mid-step "
                    f"{self.step_idx} at phase {phase!r}")
            publisher(phase)
        return beat

    def _probe_fn(self, i: int):
        """Health probe for replica ``i`` as the router sees it: a
        killed replica RAISES (dead process, no snapshot)."""
        def probe() -> dict:
            if i in self._killed:
                raise RuntimeError(f"replica r{i} is dead")
            return self.engines[i]._health_snapshot()
        return probe

    def kill_replica(self, replica: int) -> None:
        """Kill replica ``replica`` SILENTLY — nothing is announced;
        the fabric's own health probes must detect the death at the
        top of the next step and migrate the victims.  (The chaos
        ``replica_crash`` drill calls this through ``fault_plan``.)"""
        r = int(replica)
        if not 0 <= r < self.n_replicas:
            raise ValueError(f"replica {r} out of range "
                             f"[0, {self.n_replicas})")
        if len(self._killed) + 1 >= self.n_replicas:
            raise RuntimeError(
                "refusing to kill the last live replica — there would "
                "be nowhere to migrate its requests")
        self._killed.add(r)

    def _maybe_inject_crash(self) -> None:
        p = self.fault_plan
        if p is None or p.fault != "replica_crash":
            return
        target = p.expert % self.n_replicas
        if self.step_idx == p.step and target not in self._killed:
            self.kill_replica(target)

    def _detect_crashes(self) -> None:
        """Probe every not-yet-evacuated replica; a raising probe is a
        detected death -> evacuate + migrate."""
        for i in range(self.n_replicas):
            if i in self._crashed:
                continue
            try:
                self.router.health_fns[i]()
            except Exception:
                self._on_replica_death(i)

    def _on_replica_death(self, dead: int) -> None:
        """One replica's death, end to end: pull it from the rotation,
        evacuate its work through the eviction path (resumed
        prompts carry every delivered token; trace spans close), and
        re-route every victim onto the survivors — in-flight requests
        resume at the head of their new queue, still in admission
        order, so the deterministic re-prefill replays bit-equal."""
        self.router.mark_failed(dead)
        engine = self.engines[dead]
        inflight, queued = engine.evacuate()
        self._crashed.add(dead)
        self.metrics.count("fabric.replica_crashes")
        self.metrics.decision(
            "fabric.replica_crash", replica=dead, step=self.step_idx,
            in_flight=len(inflight), queued=len(queued),
            survivors=[i for i in range(self.n_replicas)
                       if i not in self._crashed and
                       i not in self._killed])
        front: dict[int, list] = {}
        for entry in inflight:            # admission order
            choice = self.router.route(entry.orig.rid)
            front.setdefault(choice, []).append(entry)
            self._emit_migrate(entry, dead, choice, resumed=True)
        for choice, entries in front.items():
            # adopt(front=True) prepends, so reversed() lands the
            # oldest-admitted request back at the very head
            for entry in reversed(entries):
                self.engines[choice].adopt(entry, front=True)
        for entry in queued:
            choice = self.router.route(entry.orig.rid)
            self.engines[choice].adopt(entry)
            self._emit_migrate(entry, dead, choice, resumed=False)

    def _emit_migrate(self, entry, dead: int, choice: int, *,
                      resumed: bool) -> None:
        self._placement[entry.orig.rid] = choice
        self.migrated += 1
        self.metrics.count("fabric.migrations")
        self.metrics.decision(
            "fabric.migrate", rid=entry.orig.rid, from_replica=dead,
            to_replica=choice, resumed=resumed,
            delivered=(len(entry.req.prompt)
                       - len(entry.orig.prompt)),
            remaining=entry.req.max_new_tokens)

    def _observe_heartbeats(self) -> None:
        """One watchdog sweep after the replicas stepped: a replica
        with pending work that advanced no heartbeat seq takes a miss;
        at the deadline it is declared stalled and takes the same
        fence+evacuate+adopt path a detected crash does — the sub-step
        arm of the recovery ladder."""
        if self.hb_watchdog is None:
            return
        live = [i for i in range(self.n_replicas)
                if i not in self._killed and i not in self._crashed]
        newly = self.hb_watchdog.observe(
            self.step_idx, live,
            pending=lambda r: self.engines[r].pending())
        for victim in newly:
            if self.vclock is not None:
                # evacuate on the victim's own (frozen) lane so the
                # eviction instants continue from where it hung and
                # the resumed-gap spans stay contiguous
                self.vclock.use_lane(victim)
            self._on_replica_death(victim)

    # ---- submission / drive ------------------------------------------

    def submit(self, req, arrival_step: int = 0, *,
               session=None) -> int:
        """Route ``req`` to a replica (JSQ + affinity) and enqueue it
        there.  Returns the chosen replica id."""
        choice = self.router.route(req.rid, session=session)
        self.engines[choice].submit(req, arrival_step)
        self._placement[req.rid] = choice
        return choice

    def pending(self) -> bool:
        return any(e.pending() for e in self.engines)

    def _spec_break_even(self):
        """Planner break-even acceptance for the fleet's verify depth,
        priced once and cached (the shape never changes mid-run).  None
        when the planner has no feasible decode path for this config —
        the controller then falls back to its configured floor."""
        if self._spec_be is _SPEC_BE_UNSET:
            try:
                from flashmoe_tpu_torch.planner.model import \
                    speculate_break_even
                self._spec_be = speculate_break_even(
                    self.cfg,
                    verify_tokens=self.serve.speculate.draft_tokens)
            except Exception:
                self._spec_be = None
        return self._spec_be

    def _observe_spec(self) -> None:
        """Feed the controller the fleet's INSTANTANEOUS draft
        acceptance (this step's delta across replicas, not the
        cumulative rate — a run that started well must still morph when
        traffic turns adversarial) and execute a morph-off verdict on
        EVERY replica at once: a per-replica split would fork the
        measurement identity the planner's spec pricing assumes."""
        drafted = accepted = 0
        spec_on = False
        for e in self.engines:
            snap = e.spec_snapshot()
            drafted += snap["spec_drafted"]
            accepted += snap["spec_accepted"]
            spec_on = spec_on or snap["spec_on"]
        d = drafted - self._spec_prev[0]
        a = accepted - self._spec_prev[1]
        self._spec_prev = (drafted, accepted)
        self.controller.observe_spec(
            self.step_idx, (a / d) if d > 0 else None,
            break_even=self._spec_break_even())
        act = self.controller.maybe_morph_spec(
            self.step_idx, spec_on=spec_on)
        if act is not None:
            for e in self.engines:
                if e._spec is not None:
                    e.set_speculate(False, reason=act.reason)

    def step(self) -> dict:
        """One fabric iteration: inject/detect crashes, then every live
        replica with pending work steps once (decode steps overlap the
        handoff prefills its admissions triggered), then the controller
        observes queue pressure and may morph the rotation."""
        self._maybe_inject_crash()
        self._detect_crashes()
        recs = []
        for i, e in enumerate(self.engines):
            if i in self._killed or i in self._stalled:
                continue
            if e.pending():
                if self.vclock is not None:
                    # replica-local virtual time: the real fleet steps
                    # replicas in parallel, so each gets its own lane
                    self.vclock.use_lane(i)
                try:
                    recs.append(e.step())
                except _ReplicaStallInjected:
                    # the replica hung mid-step: its thread never
                    # returns, so it never steps again — and nothing
                    # announces it (the probe still answers).  Close
                    # its open step window at the hang instant so the
                    # trace authority's tracks stay contiguous; the
                    # WORK stays parked on the hung replica until the
                    # heartbeat deadline notices.
                    self._stalled.add(i)
                    if e.tracer is not None:
                        e.tracer.end_step()
        self._observe_heartbeats()
        self.step_idx += 1
        if self.controller is not None:
            depths = [e._health_snapshot() for e in self.engines]
            self.controller.observe_fabric(
                self.step_idx,
                [d["queue_depth"] + d["active_requests"]
                 for d in depths])
            act = self.controller.maybe_morph_replicas(
                self.step_idx, draining=self.router.draining())
            if act is not None:
                if act.kind == "drain":
                    self.router.drain(act.replica)
                else:
                    self.router.undrain(act.replica)
            if self.serve.speculate is not None:
                self._observe_spec()
        return {"kind": "fabric_step", "step": self.step_idx,
                "replica_steps": len(recs),
                "queue_depth": sum(len(e.queue) for e in self.engines),
                "active": sum(len(e._active()) for e in self.engines)}

    def run(self, requests=None, arrivals=None, *, sessions=None,
            until=None) -> dict:
        """Drive to completion; the fabric twin of
        :meth:`ServingEngine.run`.  ``sessions``: optional per-request
        affinity keys (parallel to ``requests``).  Returns the merged
        ``{rid: tokens}`` across replicas."""
        for idx, req in enumerate(requests or ()):
            self.submit(req,
                        int(arrivals[idx]) if arrivals else 0,
                        session=sessions[idx] if sessions else None)
        while self.pending() and not (until is not None and until()):
            if self.step_idx >= self.serve.max_steps:
                raise RuntimeError(
                    f"fabric exceeded max_steps={self.serve.max_steps} "
                    f"with work pending")
            self.step()
        out: dict = {}
        for e in self.engines:
            out.update(e.outputs)
        return out

    def summary(self) -> dict:
        """Merged drill summary: per-replica engine summaries plus the
        fabric's own counters."""
        out = {
            "replicas": self.n_replicas,
            "steps": self.step_idx,
            "handoffs": self.handoff.count,
            "handoff_bytes": self.handoff.bytes_moved,
            "routed": list(self.router.routed),
            "placement": dict(self._placement),
            "crashed": sorted(self._crashed),
            "stalled": sorted(self._stalled),
            "migrated": self.migrated,
            "engines": [e.summary() for e in self.engines],
        }
        if self.serve.speculate is not None:
            drafted = sum(e.spec_snapshot()["spec_drafted"]
                          for e in self.engines)
            accepted = sum(e.spec_snapshot()["spec_accepted"]
                           for e in self.engines)
            out["spec"] = {
                "spec_drafted": drafted,
                "spec_accepted": accepted,
                "accept_rate": (round(accepted / drafted, 6)
                                if drafted else 0.0),
                "spec_on": [bool(e._spec is not None)
                            for e in self.engines],
            }
        if self.hb_watchdog is not None:
            out["heartbeat"] = self.hb_watchdog.snapshot()
        if self.vclock is not None:
            out["handoff_ms_measured"] = round(
                self.handoff.measured_ms_total, 6)
            out["handoff_hidden_frac"] = (
                round(self.handoff.hidden_ms_total
                      / self.handoff.measured_ms_total, 6)
                if self.handoff.measured_ms_total > 0 else None)
            out["handoff_verdicts_agree"] = self.handoff.drift_agree
            out["handoff_verdicts_total"] = self.handoff.drift_total
        return out
