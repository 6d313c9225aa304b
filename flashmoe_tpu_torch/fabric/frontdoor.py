"""The fabric's single front door: one trace/session authority.

Counterpart of ``flashmoe_tpu/fabric/frontdoor.py``.  Without a door,
every fabric client splits the request/trace namespace per replica up
front (``loadgen.split_requests``): each engine traces its own shard and
nobody owns the request's identity across the prefill pool, the router,
an eviction, or a drain-spill.  :class:`FrontDoor` wraps a
:class:`~flashmoe_tpu_torch.fabric.engine.ServingFabric` with

* **one** shared :class:`~flashmoe_tpu_torch.telemetry_plane.tracing.
  RequestTracer` installed across every replica (they step
  sequentially on one host thread, so a single listener is race-free)
  on the fabric's clock (the
  :class:`~flashmoe_tpu_torch.fabric.vclock.VirtualClock` when armed, wall
  otherwise) — a request's spans land on ONE track no matter which
  pools it crossed;
* **namespace ownership** — a rid submits through the front door at
  most once (a duplicate raises), and every submit is recorded as a
  ``frontdoor.submit`` decision carrying the router's placement;
* **the fleet export** — :meth:`export_fleet_trace` writes ONE
  ``validate_trace``-gated Perfetto document with a process track per
  pool and flow arrows linking each request's prefill-pool span to
  its decode-pool resume
  (:func:`~flashmoe_tpu_torch.profiler.export.fleet_trace_document`);
* **attribution** — :meth:`attribution` decomposes every retired
  request's measured latency into critical-path components
  (:mod:`flashmoe_tpu_torch.telemetry_plane.attribution`), feeding the
  per-component ``/metrics`` sketches.
"""

from __future__ import annotations

import json
import os
import time

from flashmoe_tpu_torch.telemetry_plane.tracing import RequestTracer


class FrontDoor:
    """Trace/session authority over one fabric.  Construct AFTER the
    fabric (it arms the shared tracer on the fabric's replicas); call
    :meth:`close` (or close the fabric) when done so the span listener
    uninstalls."""

    def __init__(self, fabric, *, metrics_obj=None, brownout=None,
                 tracer=None, seen=None, peer=None):
        """``brownout``: a :class:`~flashmoe_tpu_torch.runtime.controller.
        BrownoutConfig` arming hysteretic admission shedding — while a
        brownout episode is active, :meth:`submit` sheds (or degrades)
        new requests instead of feeding an overloaded fleet.
        ``tracer`` / ``seen`` / ``peer``: the
        :class:`FrontDoorCluster` seams — peers of a replicated door
        share ONE tracer and ONE rid namespace, each tagging its
        submits with its ``peer`` id; a standalone door (defaults)
        owns both."""
        self.fabric = fabric
        self.metrics = (metrics_obj if metrics_obj is not None
                        else fabric.metrics)
        self.peer = peer
        self._owns_tracer = tracer is None
        if tracer is None:
            clock = (fabric.vclock if fabric.vclock is not None
                     else time.monotonic)
            tracer = RequestTracer(metrics_obj=self.metrics,
                                   clock=clock)
            tracer.install()
        self.tracer = tracer
        for e in fabric.engines:
            e.tracer = self.tracer
        self._seen: set = seen if seen is not None else set()
        self.sessions: dict = {}
        # ---- brownout state (the controller's discipline: debounce /
        # cooldown / budget around a hysteresis band) ----
        self.brownout = brownout
        self._bo_active = False
        self._bo_breach = 0
        self._bo_clear = 0
        self._bo_cooldown_until = -1
        self._bo_episodes = 0
        self._bo_last_retries = 0
        self.shed_rids: list = []
        self.degraded_rids: list = []

    # ---- namespace ----------------------------------------------------

    def submit(self, req, arrival_step: int = 0, *,
               session=None) -> int | None:
        """Submit one request through the front door: route it, record
        the placement, own its rid.  Returns the chosen replica — or
        ``None`` when an active brownout SHED the request (it never
        enters the fabric; the rid stays owned so a retry under the
        same rid still raises)."""
        if req.rid in self._seen:
            raise ValueError(
                f"rid {req.rid} already submitted through this front "
                f"door — the trace namespace is owned here, not split "
                f"per replica")
        self._seen.add(req.rid)
        if self._bo_active:
            bo = self.brownout
            depth = self._fleet_depth()
            if bo.mode == "shed":
                self.shed_rids.append(req.rid)
                self.metrics.count("frontdoor.sheds")
                self.metrics.decision(
                    "frontdoor.shed", rid=req.rid, peer=self.peer,
                    mode="reject", step=self.fabric.step_idx,
                    queue_depth=round(depth, 3),
                    episode=self._bo_episodes)
                return None
            capped = min(req.max_new_tokens, bo.degrade_max_new)
            if capped < req.max_new_tokens:
                import dataclasses as _dc

                req = _dc.replace(req, max_new_tokens=capped)
                self.degraded_rids.append(req.rid)
                self.metrics.count("frontdoor.degraded")
                self.metrics.decision(
                    "frontdoor.shed", rid=req.rid, peer=self.peer,
                    mode="degrade", step=self.fabric.step_idx,
                    queue_depth=round(depth, 3),
                    max_new_tokens=capped,
                    episode=self._bo_episodes)
        choice = self.fabric.submit(req, arrival_step, session=session)
        if session is not None:
            self.sessions.setdefault(session, []).append(req.rid)
        self.metrics.count("frontdoor.submits")
        self.metrics.decision(
            "frontdoor.submit", rid=req.rid, session=session,
            replica=int(choice), arrival_step=int(arrival_step),
            peer=self.peer, submitted=len(self._seen))
        return choice

    # ---- brownout (hysteretic admission control) ----------------------

    def _fleet_depth(self) -> float:
        """Mean (queue + active) depth per LIVE replica — crashed
        replicas neither hold work nor count toward capacity."""
        fab = self.fabric
        live = [e for i, e in enumerate(fab.engines)
                if i not in fab._killed and i not in fab._crashed]
        if not live:
            return 0.0
        return sum(len(e.queue) + len(e._active()) for e in live) \
            / len(live)

    def _retry_pressure(self) -> int:
        """Handoff-transport retries since the previous observation."""
        transport = getattr(self.fabric.handoff, "transport", None)
        if transport is None:
            return 0
        now = transport.retries_total
        delta = now - self._bo_last_retries
        self._bo_last_retries = now
        return delta

    def observe_brownout(self, step: int) -> None:
        """One admission-control observation (call once per fabric
        step; :meth:`run` does).  Enter/exit transitions are
        ``frontdoor.brownout`` decisions; both directions are debounced
        and entries respect the cooldown and the episode budget."""
        bo = self.brownout
        if bo is None:
            return
        depth = self._fleet_depth()
        retries = self._retry_pressure()
        breach = depth > bo.queue_high or retries >= bo.retry_high
        if self._bo_active:
            calm = depth < bo.queue_low and retries == 0
            self._bo_clear = self._bo_clear + 1 if calm else 0
            if self._bo_clear >= bo.debounce_steps:
                self._bo_active = False
                self._bo_clear = 0
                self._bo_cooldown_until = step + bo.cooldown_steps
                self.metrics.decision(
                    "frontdoor.brownout", state="exit", step=step,
                    peer=self.peer, queue_depth=round(depth, 3),
                    retries=retries, episode=self._bo_episodes,
                    cooldown_until=self._bo_cooldown_until)
            return
        in_cooldown = step < self._bo_cooldown_until
        budget_left = self._bo_episodes < bo.episode_budget
        self._bo_breach = (self._bo_breach + 1
                           if breach and not in_cooldown and budget_left
                           else 0)
        if self._bo_breach >= bo.debounce_steps:
            self._bo_active = True
            self._bo_breach = 0
            self._bo_episodes += 1
            self.metrics.count("frontdoor.brownouts")
            self.metrics.decision(
                "frontdoor.brownout", state="enter", step=step,
                peer=self.peer, queue_depth=round(depth, 3),
                retries=retries, mode=bo.mode,
                episode=self._bo_episodes,
                budget_left=bo.episode_budget - self._bo_episodes)

    def run(self, requests=None, arrivals=None, *, sessions=None,
            until=None) -> dict:
        """Submit ``requests`` through the front door and drive the
        fabric to completion (the :meth:`ServingFabric.run` twin).

        With :attr:`brownout` armed the drive is STAGED: each request
        submits only when the fabric reaches its arrival step, so the
        admission verdict sees the queue pressure that actually exists
        at arrival time (an upfront bulk submit would let every request
        through before the first observation)."""
        if self.brownout is None:
            for idx, req in enumerate(requests or ()):
                self.submit(req,
                            int(arrivals[idx]) if arrivals else 0,
                            session=sessions[idx] if sessions else None)
            return self.fabric.run(until=until)
        waiting = [(int(arrivals[idx]) if arrivals else 0, req,
                    sessions[idx] if sessions else None)
                   for idx, req in enumerate(requests or ())]
        i = 0
        while i < len(waiting) or self.fabric.pending():
            if until is not None and until():
                break
            step = self.fabric.step_idx
            while i < len(waiting) and waiting[i][0] <= step:
                arrival, req, session = waiting[i]
                self.submit(req, arrival, session=session)
                i += 1
            if step >= self.fabric.serve.max_steps:
                raise RuntimeError(
                    f"fabric exceeded max_steps="
                    f"{self.fabric.serve.max_steps} with work pending")
            self.fabric.step()
            self.observe_brownout(self.fabric.step_idx)
        out: dict = {}
        for e in self.fabric.engines:
            out.update(e.outputs)
        return out

    # ---- trace views --------------------------------------------------

    def validate(self) -> list[str]:
        """The tracer's no-orphan / contiguity gate over the WHOLE
        fleet's requests (empty = clean)."""
        return self.tracer.validate()

    def fleet_trace_document(self) -> dict:
        from flashmoe_tpu_torch.profiler.export import fleet_trace_document

        return fleet_trace_document(self.tracer, self.fabric._placement,
                                    replicas=self.fabric.n_replicas)

    def export_fleet_trace(self, path: str) -> dict:
        from flashmoe_tpu_torch.profiler.export import write_fleet_trace

        return write_fleet_trace(self.tracer, self.fabric._placement,
                                 path, replicas=self.fabric.n_replicas)

    def export_jsonl(self, path: str) -> int:
        """The fleet's ``serve_trace_span`` records (one shard — the
        front door owns the namespace, so there is nothing to merge)."""
        return self.tracer.export_jsonl(path)

    # ---- attribution --------------------------------------------------

    def attribution(self, *, feed_metrics: bool = True) -> dict:
        """Per-request critical-path attribution for every retired
        request (``{rid: {components, dominant, sum_ok, ...}}``),
        spill-aware via the router's ``fabric.route`` decisions.  With
        ``feed_metrics`` (default) the per-component sketches land on
        the fabric's metrics object and each request emits a
        ``serve.attribution`` decision."""
        from flashmoe_tpu_torch.telemetry_plane.attribution import (
            attribute_tracer, spilled_rids,
        )

        spilled = spilled_rids(
            r for r in self.metrics.decisions
            if r.get("decision") == "fabric.route")
        return attribute_tracer(
            self.tracer, spilled=spilled,
            metrics_obj=self.metrics if feed_metrics else None)

    def brownout_snapshot(self) -> dict:
        """Live view of the admission controller."""
        return {
            "armed": self.brownout is not None,
            "active": self._bo_active,
            "episodes": self._bo_episodes,
            "shed": len(self.shed_rids),
            "degraded": len(self.degraded_rids),
        }

    def close(self) -> None:
        if not self._owns_tracer:
            return                      # the cluster owns the listener
        self.tracer.uninstall()
        for e in self.fabric.engines:
            if e.tracer is self.tracer:
                e.tracer = None


class FrontDoorCluster:
    """N replicated front-door peers over one fabric: the door itself
    is no longer a single process.

    Ownership is **leased by namespace shard**: a request's rid (or
    session key) crc32-hashes to one of ``n_shards`` shards, and each
    shard's lease names the PEER that owns submissions for it plus an
    **epoch** number.  All peers share ONE
    :class:`~flashmoe_tpu_torch.telemetry_plane.tracing.RequestTracer` and
    ONE rid namespace (the trace authority is the cluster, not a
    peer), so when :meth:`fail_door` kills a peer its shards fail over
    to the survivors — epochs bump, a ``frontdoor.failover`` decision
    per shard — and the post-failover fleet Perfetto document still
    validates with zero orphan spans: no request's identity was split
    across the transition.

    With ``store`` (a :class:`~flashmoe_tpu_torch.fabric.leasestore.
    LeaseStore`) the lease table lives OUTSIDE the process: every
    owner read and every failover write goes through the fcntl-locked,
    CRC-framed, epoch-fenced file — peers in separate OS processes
    share it, a failover's epoch bumps fence off any zombie peer
    re-asserting its old leases, and a writer killed mid-append is
    rolled back to the last intact record.  ``store=None`` (default)
    keeps the in-memory table."""

    def __init__(self, fabric, n_doors: int = 2, *,
                 n_shards: int = 8, metrics_obj=None, store=None):
        if n_doors < 1:
            raise ValueError(f"cluster needs >= 1 door, got {n_doors}")
        if n_shards < n_doors:
            raise ValueError(
                f"n_shards ({n_shards}) must be >= n_doors "
                f"({n_doors}) so every peer owns a lease")
        self.fabric = fabric
        self.metrics = (metrics_obj if metrics_obj is not None
                        else fabric.metrics)
        clock = (fabric.vclock if fabric.vclock is not None
                 else time.monotonic)
        self.tracer = RequestTracer(metrics_obj=self.metrics,
                                    clock=clock)
        self.tracer.install()
        self._seen: set = set()
        self.doors = [
            FrontDoor(fabric, metrics_obj=self.metrics,
                      tracer=self.tracer, seen=self._seen, peer=i)
            for i in range(n_doors)
        ]
        self.n_shards = int(n_shards)
        self.store = store
        #: shard -> {"owner": peer id, "epoch": lease generation} (the
        #: in-memory table; with ``store`` the external file is the
        #: authority and this dict is unused)
        self.leases = {s: {"owner": s % n_doors, "epoch": 0}
                       for s in range(self.n_shards)}
        if store is not None:
            # only missing shards are seeded: a peer joining an
            # existing store adopts the live table, never resets it
            store.init_leases({s: s % n_doors
                               for s in range(self.n_shards)})
        self._dead: set = set()

    @property
    def n_doors(self) -> int:
        return len(self.doors)

    def shard_of(self, rid, session=None) -> int:
        import zlib

        key = session if session is not None else rid
        return zlib.crc32(str(key).encode()) % self.n_shards

    def _lease_table(self) -> dict:
        """The live lease table: the external store's last intact
        state when one is attached, else the in-memory dict."""
        if self.store is not None:
            return {s: {"owner": ls.owner, "epoch": ls.epoch}
                    for s, ls in self.store.leases().items()}
        return self.leases

    def owner_of(self, rid, session=None) -> int:
        return self._lease_table()[self.shard_of(rid, session)]["owner"]

    def submit(self, req, arrival_step: int = 0, *,
               session=None) -> int | None:
        """Submit through the peer whose lease owns the request's
        namespace shard."""
        owner = self.owner_of(req.rid, session)
        if owner in self._dead:
            raise RuntimeError(
                f"lease for shard {self.shard_of(req.rid, session)} "
                f"names dead peer {owner} — failover did not run")
        return self.doors[owner].submit(req, arrival_step,
                                        session=session)

    def fail_door(self, peer: int) -> int:
        """Kill peer ``peer``: every lease it held fails over to a
        survivor (crc32-deterministic choice, epoch bumped).  Returns
        the number of shards that moved."""
        p = int(peer)
        if not 0 <= p < self.n_doors:
            raise ValueError(f"peer {p} out of range "
                             f"[0, {self.n_doors})")
        if p in self._dead:
            return 0
        survivors = [i for i in range(self.n_doors)
                     if i not in self._dead and i != p]
        if not survivors:
            raise RuntimeError(
                "refusing to kill the last live front-door peer — "
                "the namespace would have no owner")
        self._dead.add(p)
        moved = 0
        table = self._lease_table()
        for shard in sorted(table):
            lease = table[shard]
            if lease["owner"] != p:
                continue
            new = survivors[shard % len(survivors)]
            epoch = lease["epoch"] + 1
            if self.store is not None:
                from flashmoe_tpu_torch.fabric.leasestore import \
                    StaleLeaseError

                try:
                    self.store.write_lease(shard, new, epoch,
                                           reason="failover")
                except StaleLeaseError:
                    # a racing peer already moved this shard at a
                    # newer epoch — its failover stands, not ours
                    continue
            else:
                self.leases[shard]["owner"] = new
                self.leases[shard]["epoch"] = epoch
            moved += 1
            self.metrics.count("frontdoor.failovers")
            self.metrics.decision(
                "frontdoor.failover", shard=shard, from_peer=p,
                to_peer=new, epoch=epoch,
                survivors=list(survivors))
        return moved

    def run(self, requests=None, arrivals=None, *, sessions=None,
            fail_at=None, fail_peer: int = 0, until=None) -> dict:
        """Drive the fleet through the cluster, optionally killing
        peer ``fail_peer`` when the fabric reaches step ``fail_at`` —
        requests arriving after the failover submit through the new
        lease owners, on the SAME shared tracer/namespace."""
        waiting = [(int(arrivals[idx]) if arrivals else 0, req,
                    sessions[idx] if sessions else None)
                   for idx, req in enumerate(requests or ())]
        i = 0
        failed = False
        while i < len(waiting) or self.fabric.pending():
            if until is not None and until():
                break
            step = self.fabric.step_idx
            if fail_at is not None and not failed and step >= fail_at:
                self.fail_door(fail_peer)
                failed = True
            while i < len(waiting) and waiting[i][0] <= step:
                arrival, req, session = waiting[i]
                self.submit(req, arrival, session=session)
                i += 1
            if step >= self.fabric.serve.max_steps:
                raise RuntimeError(
                    f"fabric exceeded max_steps="
                    f"{self.fabric.serve.max_steps} with work pending")
            self.fabric.step()
        out: dict = {}
        for e in self.fabric.engines:
            out.update(e.outputs)
        return out

    # ---- trace views (the CLUSTER is the authority) -------------------

    def validate(self) -> list[str]:
        return self.tracer.validate()

    def fleet_trace_document(self) -> dict:
        from flashmoe_tpu_torch.profiler.export import fleet_trace_document

        return fleet_trace_document(self.tracer, self.fabric._placement,
                                    replicas=self.fabric.n_replicas)

    def export_fleet_trace(self, path: str) -> dict:
        from flashmoe_tpu_torch.profiler.export import write_fleet_trace

        return write_fleet_trace(self.tracer, self.fabric._placement,
                                 path, replicas=self.fabric.n_replicas)

    def export_door_shards(self, dirpath: str) -> dict:
        """Write one telemetry shard per LIVE door
        (``telemetry.door<i>.jsonl``): the trace records it is an
        authority for plus every decision it witnessed.  In a
        cross-process deployment each door writes its own shard;
        ``observe --merge`` re-joins them into one fleet view, deduping
        double-witnessed records — the externalized trace-authority
        story (zero orphan spans after the merge)."""
        recs = [*self.tracer.records(),
                *(dict(d) for d in self.metrics.decisions)]
        out = {}
        for i in range(self.n_doors):
            if i in self._dead:
                continue
            path = os.path.join(dirpath, f"telemetry.door{i}.jsonl")
            with open(path, "w") as fh:
                for r in recs:
                    fh.write(json.dumps(r, default=str) + "\n")
            out[f"door{i}"] = {"path": path, "records": len(recs)}
        return out

    def snapshot(self) -> dict:
        """Live ``/vars`` view of the lease table."""
        table = self._lease_table()
        return {
            "doors": self.n_doors,
            "dead": sorted(self._dead),
            "shards": self.n_shards,
            "external_store": (self.store.path
                               if self.store is not None else None),
            "leases": {s: dict(v) for s, v in table.items()},
            "max_epoch": max(v["epoch"] for v in table.values()),
        }

    def close(self) -> None:
        self.tracer.uninstall()
        for e in self.fabric.engines:
            if e.tracer is self.tracer:
                e.tracer = None
