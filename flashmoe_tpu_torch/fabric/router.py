"""Request router over N engine replicas.

Counterpart of ``flashmoe_tpu/fabric/router.py`` (no JAX in it; the port
keeps its own copy).  Join-shortest-queue with session affinity: a
request that names a session (or, failing that, its rid) hashes to a
preferred replica so a
conversation's KV pages keep landing where its earlier turns decoded;
the preference yields to load only when that replica is unhealthy or
draining.  Queue depth comes from each replica's ``/healthz`` snapshot
(``queue_depth + active_requests``), so the router sees exactly what an
external probe of the engine would see — there is no second bookkeeping
path to drift.

Every placement is recorded as a ``fabric.route`` decision; the runtime
controller morphs the rotation through :meth:`ReplicaRouter.drain` /
:meth:`ReplicaRouter.undrain` (the debounce/cooldown/budget discipline
lives in :class:`~flashmoe_tpu_torch.runtime.controller.RuntimeController`,
not here — the router just executes the verdict).

Ties break on the lowest replica id, so a fabric drill replays
bit-identically: same trace, same health sequence, same placements.
"""

from __future__ import annotations

import zlib

from flashmoe_tpu_torch.utils.telemetry import metrics as _global_metrics


class ReplicaRouter:
    """Pick a decode replica for each request.

    ``health_fns`` is one zero-arg callable per replica returning the
    engine's ``/healthz`` dict (:meth:`ServingEngine._health_snapshot`);
    a callable that raises marks its replica unhealthy for that
    placement only — health is re-probed per route, never cached."""

    def __init__(self, health_fns, *, metrics_obj=None, affinity=True):
        self.health_fns = list(health_fns)
        if not self.health_fns:
            raise ValueError("ReplicaRouter needs >= 1 replica")
        self.affinity = bool(affinity)
        self.metrics = (metrics_obj if metrics_obj is not None
                        else _global_metrics)
        self._draining: set[int] = set()
        self._failed: set[int] = set()
        self.routed = [0] * len(self.health_fns)

    @property
    def n_replicas(self) -> int:
        return len(self.health_fns)

    def drain(self, replica: int) -> None:
        """Take ``replica`` out of the rotation (in-flight work keeps
        decoding; only NEW placements avoid it)."""
        self._check(replica)
        self._draining.add(int(replica))

    def undrain(self, replica: int) -> None:
        """Return ``replica`` to the rotation."""
        self._check(replica)
        self._draining.discard(int(replica))

    def draining(self) -> tuple[int, ...]:
        return tuple(sorted(self._draining))

    def mark_failed(self, replica: int) -> None:
        """Declare ``replica`` DEAD: unlike a drain (which only steers
        new placements while in-flight work keeps decoding), a failed
        replica is excluded even from the everyone-is-draining fallback
        rotation — its requests must MIGRATE, there is nothing left to
        decode them.  The fabric calls this from its crash detector."""
        self._check(replica)
        self._failed.add(int(replica))
        self._draining.discard(int(replica))

    def failed(self) -> tuple[int, ...]:
        return tuple(sorted(self._failed))

    def _check(self, replica: int) -> None:
        if not 0 <= int(replica) < self.n_replicas:
            raise ValueError(f"replica {replica} out of range "
                             f"[0, {self.n_replicas})")

    def _preferred(self, rid, session) -> int | None:
        if not self.affinity:
            return None
        key = session if session is not None else rid
        if key is None:
            return None
        return zlib.crc32(str(key).encode()) % self.n_replicas

    def _load(self, replica: int):
        """(queue_depth + active_requests, healthy) via ``/healthz``."""
        try:
            h = self.health_fns[replica]()
        except Exception:
            return None, False
        depth = int(h.get("queue_depth", 0)) + int(
            h.get("active_requests", 0))
        return depth, bool(h.get("ok", True))

    def route(self, rid=None, *, session=None) -> int:
        """Place one request; returns the chosen replica id."""
        loads = [self._load(i) for i in range(self.n_replicas)]
        eligible = [i for i, (d, ok) in enumerate(loads)
                    if ok and i not in self._draining
                    and i not in self._failed]
        if not eligible:
            # every replica draining/unhealthy: fall back to the full
            # rotation rather than dropping the request on the floor —
            # but never to a FAILED replica, which cannot decode at all
            eligible = [i for i in range(self.n_replicas)
                        if i not in self._failed]
        if not eligible:
            raise RuntimeError(
                "every replica has failed — nothing left to route to")
        preferred = self._preferred(rid, session)
        if preferred in eligible:
            choice, why = preferred, "affinity"
        else:
            choice = min(eligible, key=lambda i: (loads[i][0], i))
            why = "jsq" if preferred is None else "jsq_spill"
        self.routed[choice] += 1
        self.metrics.count("fabric.routed")
        self.metrics.decision(
            "fabric.route", rid=rid, session=session,
            replica=int(choice), policy=why,
            preferred=preferred,
            queue_depths=[d for d, _ in loads],
            draining=list(self.draining()))
        return choice

    def snapshot(self) -> dict:
        """Live ``/vars`` view of the rotation."""
        return {
            "replicas": self.n_replicas,
            "affinity": self.affinity,
            "draining": list(self.draining()),
            "failed": list(self.failed()),
            "routed": list(self.routed),
        }
