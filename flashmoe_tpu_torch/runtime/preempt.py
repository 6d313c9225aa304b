"""Preemption notices: SIGTERM turned into a graceful drain.

Counterpart of ``flashmoe_tpu/runtime/preempt.py`` (pure host code, ported
whole).  :class:`PreemptionListener` turns the asynchronous signal into a
flag that :func:`flashmoe_tpu_torch.runtime.resilient.resilient_train`
polls once a step.  On a notice the loop finishes the step in flight,
writes a final checkpoint with the data loader's cursor, records a
``preempt.drain`` decision and returns; the supervisor (or the cluster
scheduler) resumes from exactly that step.

Signal handlers install only from the main thread (a CPython rule), so the
listener also takes a programmatic :meth:`notify`, with which tests inject
notices without touching the process's signal state.
"""

from __future__ import annotations

import signal
import time

from flashmoe_tpu_torch.utils.telemetry import metrics as _telemetry

#: default signals a preemption notice arrives on: SIGTERM is what
#: schedulers send at eviction; SIGUSR1 is the conventional early-warning
#: channel (e.g. a node-watcher forwarding the cloud preemption notice)
DEFAULT_SIGNALS = (signal.SIGTERM, signal.SIGUSR1)


class PreemptionListener:
    """A latched preemption flag with an optional signal hookup.

    ``grace_s`` is the scheduler's kill window: the time between the
    notice and the hard kill.  The drain path reports how much of it was
    left when the final checkpoint landed (``remaining_grace_s``), so an
    operator can see how close a run is to losing the race.
    """

    def __init__(self, grace_s: float = 30.0):
        self.grace_s = float(grace_s)
        # the latch is deliberately LOCK-FREE: notify() runs inside a
        # signal handler, which CPython executes on the main thread
        # between bytecodes — taking any lock there (threading.Lock,
        # or Event's internal condition) deadlocks if the interrupted
        # frame holds it (e.g. a clear() racing a re-sent SIGTERM).
        # Plain attribute writes are atomic under the GIL; the worst
        # race is two near-simultaneous notices both stamping the
        # clock, which is harmless (same instant)
        self._requested = False
        self._notice_t: float | None = None
        self._source: str | None = None
        self._installed: dict[int, object] = {}

    # ------------------------------------------------------------------
    # Notice
    # ------------------------------------------------------------------

    @property
    def requested(self) -> bool:
        """True once a notice has arrived (signal or programmatic)."""
        return self._requested

    def notify(self, source: str = "program") -> None:
        """Latch a preemption notice.  Async-signal-safe (no locks).
        Idempotent: only the FIRST notice starts the grace clock — a
        scheduler re-sending SIGTERM must not push the deadline out."""
        if self._requested:
            return
        self._notice_t = time.monotonic()
        self._source = source
        self._requested = True
        try:
            _telemetry.decision("preempt.notice", source=source,
                                grace_s=self.grace_s)
        except Exception:  # noqa: BLE001 — the latch must survive
            pass

    def clear(self) -> None:
        """Reset the latch (a new incarnation after a supervised
        restart).  Installed signal handlers stay installed.  Order
        matters against a signal interrupting this very call: the flag
        drops FIRST, so a notice landing mid-clear re-latches fully and
        survives (at worst its clock fields are wiped by the rest of
        this clear — a drain with unknown grace beats a lost notice and
        a hard kill)."""
        self._requested = False
        self._notice_t = None
        self._source = None

    @property
    def source(self) -> str | None:
        return self._source

    def notice_age_s(self) -> float | None:
        """Seconds since the notice, or None before one arrives."""
        t = self._notice_t
        return None if t is None else time.monotonic() - t

    def remaining_grace_s(self) -> float | None:
        """Grace budget left (may be negative: the drain lost the race)."""
        age = self.notice_age_s()
        return None if age is None else self.grace_s - age

    def wait(self, timeout: float | None = None,
             poll_s: float = 0.02) -> bool:
        """Block until a notice arrives (tests / supervisor idle
        loops).  Polls the lock-free latch rather than waiting on an
        Event — see ``__init__`` for why no Event exists."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while not self._requested:
            if deadline is not None and time.monotonic() >= deadline:
                return False
            time.sleep(poll_s)
        return True

    # ------------------------------------------------------------------
    # Signal hookup
    # ------------------------------------------------------------------

    def install(self, signals=DEFAULT_SIGNALS) -> "PreemptionListener":
        """Register handlers for ``signals`` (main thread only — a
        CPython constraint on ``signal.signal``).  Previous handlers are
        remembered and restored by :meth:`uninstall`.  Returns self."""
        for sig in signals:
            if sig in self._installed:
                continue
            prev = signal.signal(
                sig, lambda signum, frame: self.notify(
                    source=signal.Signals(signum).name))
            self._installed[sig] = prev
        return self

    def uninstall(self) -> None:
        """Restore the pre-install handlers (idempotent)."""
        for sig, prev in list(self._installed.items()):
            try:
                signal.signal(sig, prev)
            except (ValueError, TypeError):
                pass  # not main thread / handler gone: nothing to restore
            del self._installed[sig]

    def __enter__(self) -> "PreemptionListener":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()
