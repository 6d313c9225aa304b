"""Deterministic virtual clock for the serving fabric.

Counterpart of ``flashmoe_tpu/fabric/vclock.py`` (no JAX in it; the port
keeps its own copy).

Every latency number the fabric used to report was either wall-clock
host time (real, but noisy and DCN-free: the handoff codec runs
in-process) or a priced model (`kv_handoff_ms`, deterministic but never
*experienced* by a request).  :class:`VirtualClock` closes the gap: the
fabric steps on virtual time, the handoff ADVANCES that time by its
modeled DCN cost (plus optional chaos latency/jitter from a
:class:`~flashmoe_tpu_torch.chaos.FaultPlan`), and every TTFT/TPOT/step
measurement the engine takes through its ``clock`` seam is therefore
*measured under* the delay the model priced — so the overlap verdict
becomes a measured quantity (``fabric.handoff_drift`` reconciles it
against the priced one per transfer).

Semantics (per decode replica = per **lane**, because the fabric steps
its replicas sequentially on one host thread while the real fleet runs
them in parallel):

* each engine step costs one decode **tick** (``tick_ms``, resolved
  from ``PoolPlan.decode_ms`` by the fabric) of lane time;
* a handoff advances the active lane by its measured DCN cost
  *immediately* (inside the ``serve.handoff`` span, so the request's
  own prefill span absorbs the wait);
* at the end of the step the engine advances the lane by
  ``max(0, tick - handoff_ms_this_step)`` — total virtual step
  duration ``max(tick, handoffs)``, i.e. transfers overlap the decode
  tick and only the *exposed* remainder stretches the step.

Per-transfer accounting: with ``H`` the handoff time already spent
this step, a transfer of ``m`` ms hides ``min(m, max(0, tick - H))``
and exposes the rest.  With ``tick = PoolPlan.decode_ms``, no chaos
and one transfer per step this reproduces the priced verdict
``m <= decode_ms`` exactly — the reconciliation invariant
``tests/test_torch_fabric_wire.py`` holds.

``VirtualClock`` is callable and returns SECONDS (the
``time.monotonic`` protocol), so it drops into every existing clock
seam.  Determinism: no wall reads, no randomness — chaos jitter is a
crc32 hash of ``(plan.seed, transfer index)``.
"""

from __future__ import annotations

import zlib

#: faults a VirtualClock knows how to inject (chaos drill matrix rows)
DCN_FAULTS = ("dcn_latency", "dcn_jitter")


class VirtualClock:
    """Callable virtual clock with one lane per decode replica.

    ``tick_ms``: virtual cost of one engine step (``None`` = resolved
    later by the fabric from its pool plan, fallback 1.0).
    ``lanes``: replica count (grown on demand via :meth:`ensure_lanes`).
    ``plan``: an optional armed :class:`~flashmoe_tpu_torch.chaos.FaultPlan`
    whose fault is one of :data:`DCN_FAULTS` — it perturbs transfers
    in ``[plan.step, plan.step + plan.duration)`` (transfer index, not
    engine step) by ``plan.latency_ms`` / a deterministic jitter in
    ``[0, plan.jitter_ms]``."""

    def __init__(self, *, tick_ms: float | None = None, lanes: int = 1,
                 plan=None):
        if plan is not None and plan.fault not in DCN_FAULTS:
            raise ValueError(
                f"VirtualClock only injects {DCN_FAULTS}, got plan "
                f"fault {plan.fault!r}")
        self.tick_ms = tick_ms
        self.plan = plan
        self._lane_s = [0.0] * max(1, int(lanes))
        self._step_handoff_ms = [0.0] * len(self._lane_s)
        self._active = 0
        self._handoffs = 0
        #: per-transfer measured accounting (what handoff_drift records)
        self.transfers: list[dict] = []

    # ---- lanes --------------------------------------------------------

    def ensure_lanes(self, n: int) -> None:
        while len(self._lane_s) < n:
            self._lane_s.append(0.0)
            self._step_handoff_ms.append(0.0)

    def use_lane(self, i: int) -> None:
        """Make lane ``i`` the active one — the fabric calls this
        before stepping replica ``i`` (single-threaded, so the shared
        tracer's timestamps read replica-local time)."""
        self.ensure_lanes(int(i) + 1)
        self._active = int(i)

    @property
    def active_lane(self) -> int:
        return self._active

    # ---- the time.monotonic protocol ---------------------------------

    def __call__(self) -> float:
        return self._lane_s[self._active]

    def now_ms(self) -> float:
        return self._lane_s[self._active] * 1e3

    def advance_ms(self, ms: float) -> None:
        self._lane_s[self._active] += float(ms) / 1e3

    # ---- chaos --------------------------------------------------------

    def _chaos_ms(self, index: int) -> float:
        p = self.plan
        if p is None:
            return 0.0
        if not (p.step <= index < p.step + p.duration):
            return 0.0
        if p.fault == "dcn_latency":
            return float(p.latency_ms)
        # dcn_jitter: deterministic fraction of jitter_ms per transfer
        frac = (zlib.crc32(f"{p.seed}:{index}".encode()) % 10007) / 10006.0
        return float(p.jitter_ms) * frac

    # ---- fabric hooks -------------------------------------------------

    def on_handoff(self, modeled_ms: float, *, rid=None,
                   replica=None, extra_ms: float = 0.0) -> dict:
        """One KV-page transfer lands on the active lane: advance by
        the measured cost (modeled + chaos + ``extra_ms``) and account
        how much of it hides under the remaining decode-tick budget.
        ``extra_ms`` is transport overhead the wire actually spent —
        retry retransmissions and backoff
        (:class:`~flashmoe_tpu_torch.fabric.transport.HandoffTransport`) —
        so a retried handoff is *experienced* by the request's TTFT,
        not just counted.  Returns the per-transfer accounting dict
        (also kept in :attr:`transfers`)."""
        index = self._handoffs
        self._handoffs += 1
        chaos = self._chaos_ms(index)
        measured = float(modeled_ms) + chaos + float(extra_ms)
        tick = float(self.tick_ms) if self.tick_ms is not None else 0.0
        lane = self._active
        budget = max(0.0, tick - self._step_handoff_ms[lane])
        hidden = min(measured, budget)
        exposed = measured - hidden
        self._step_handoff_ms[lane] += measured
        self.advance_ms(measured)
        acct = {
            "index": index, "rid": rid,
            "replica": (int(replica) if replica is not None else None),
            "lane": lane,
            "modeled_ms": round(float(modeled_ms), 6),
            "chaos_ms": round(chaos, 6),
            "retry_ms": round(float(extra_ms), 6),
            "measured_ms": round(measured, 6),
            "hidden_ms": round(hidden, 6),
            "exposed_ms": round(exposed, 6),
            "tick_ms": round(tick, 6),
        }
        self.transfers.append(acct)
        return acct

    def complete_step(self) -> float:
        """The engine finished one step on the active lane: advance by
        the decode tick MINUS the handoff time the step already spent
        (never negative — a handoff-saturated step is stretched by its
        transfers, not double-billed).  Returns the idle advance."""
        tick = float(self.tick_ms) if self.tick_ms is not None else 0.0
        lane = self._active
        idle = max(0.0, tick - self._step_handoff_ms[lane])
        if idle:
            self.advance_ms(idle)
        self._step_handoff_ms[lane] = 0.0
        return idle

    # ---- rollups ------------------------------------------------------

    @property
    def measured_ms_total(self) -> float:
        return sum(t["measured_ms"] for t in self.transfers)

    @property
    def hidden_ms_total(self) -> float:
        return sum(t["hidden_ms"] for t in self.transfers)

    def hidden_fraction(self) -> float | None:
        """Fleet-wide measured hidden fraction (None = no transfers)."""
        total = self.measured_ms_total
        if total <= 0:
            return None if not self.transfers else 1.0
        return self.hidden_ms_total / total

    def snapshot(self) -> dict:
        """Live ``/vars`` view."""
        hf = self.hidden_fraction()
        return {
            "tick_ms": self.tick_ms,
            "lanes": len(self._lane_s),
            "lane_s": [round(s, 9) for s in self._lane_s],
            "transfers": len(self.transfers),
            "measured_ms_total": round(self.measured_ms_total, 6),
            "hidden_ms_total": round(self.hidden_ms_total, 6),
            "hidden_fraction": (round(hf, 6) if hf is not None else None),
            "fault": (self.plan.fault if self.plan is not None else None),
        }
