"""Host-side span clock: per-step, per-phase wall durations.

Counterpart of ``flashmoe_tpu/profiler/spans.py``.  The EP layers wrap
their phases in :func:`flashmoe_tpu_torch.utils.telemetry.trace_span`.
While a :class:`PhaseTimeline` is armed (:func:`install` /
:func:`profiling`) the spans report their host enter and exit instants
here, and with ``MoEConfig.profile_phases`` on the layers also call
:func:`fence` on each phase's result.  The port always runs eagerly, and
a fence waits on a CUDA event recorded on the current stream behind the
phase's work, so each span's exit instant is device-complete time and a
step's phase durations sum to (nearly) its wall time.  On CPU tensors the
work is already done when the op returns, and a fence waits on nothing.

A fence orders nothing and writes nothing: ``profile_phases`` changes no
output bit, with or without a timeline armed.  With no timeline armed a
fence is one ``None`` check.  Phase spans are recorded only while a step
is open (:meth:`PhaseTimeline.begin_step`); the trainer's host sections
(``train.data_pull``, ``train.step``, ``train.checkpoint``,
``train.drain``) are recorded whenever a timeline is armed.
"""

from __future__ import annotations

import contextlib
import time

#: the armed timeline (one slot; host-side — profiling is a process
#: activity, not a per-config one)
_ACTIVE: list = [None]


def active() -> "PhaseTimeline | None":
    return _ACTIVE[0]


def merged_phase(name: str) -> str:
    """Canonical phase of a span name: chunked pipeline spans
    (``moe.expert.3``) merge onto their base phase (``moe.expert``)."""
    head, _, tail = name.rpartition(".")
    return head if head and tail.isdigit() else name


class PhaseTimeline:
    """Collector for spans, host sections, per-step phase totals and
    counter samples: what the cost ledger joins and the Perfetto exporter
    renders.

    ``spans``: every closed span, host-clock ``ts_ms`` / ``dur_ms``
    relative to the timeline's birth (``sections`` likewise for the host
    sections).  ``steps``: one record per :meth:`begin_step` /
    :meth:`end_step` window with the merged per-phase totals.
    ``counters``: (name, ts_ms, value) samples (Perfetto counter tracks).
    ``overlapped_ms``: optionally, the same computation's per-step time
    with no fence, set by the ledger's profiling run for the measured-overlap
    cross-check."""

    def __init__(self, label: str = ""):
        self.label = label
        self.spans: list[dict] = []
        self.steps: list[dict] = []
        self.counters: list[dict] = []
        self.sections: list[dict] = []
        self.overlapped_ms: float | None = None
        self.meta: dict = {}
        self._birth = time.perf_counter()
        self._cur: dict | None = None

    # ---- clock --------------------------------------------------------

    def _now_ms(self) -> float:
        return (time.perf_counter() - self._birth) * 1e3

    # ---- steps --------------------------------------------------------

    def begin_step(self, step: int) -> None:
        """Open a profiled step: phase spans are only recorded while a
        step is open."""
        self._cur = {"step": int(step), "t0_ms": self._now_ms(),
                     "phases": {}, "wall_ms": None}

    def end_step(self) -> dict:
        rec = self._cur
        if rec is None:
            raise RuntimeError("end_step without begin_step")
        rec["wall_ms"] = self._now_ms() - rec["t0_ms"]
        rec["phases"] = {k: round(v, 6) for k, v in rec["phases"].items()}
        self.steps.append(rec)
        self._cur = None
        return rec

    # ---- span listener (telemetry.trace_span calls these) -------------

    def span_enter(self, name: str):
        if self._cur is None:
            return None
        return self._now_ms()

    def span_exit(self, name: str, tok) -> None:
        if tok is None or self._cur is None:
            return
        now = self._now_ms()
        dur = now - tok
        self.spans.append({
            "name": name, "phase": merged_phase(name),
            "ts_ms": round(tok, 6), "dur_ms": round(dur, 6),
            "step": self._cur["step"], "kind": "phase",
        })
        ph = merged_phase(name)
        self._cur["phases"][ph] = self._cur["phases"].get(ph, 0.0) + dur

    # ---- host sections (trainer-level) ---------------------------------

    @contextlib.contextmanager
    def section(self, name: str, step: int | None = None):
        t0 = self._now_ms()
        try:
            yield
        finally:
            self.sections.append({
                "name": name, "ts_ms": round(t0, 6),
                "dur_ms": round(self._now_ms() - t0, 6),
                "step": step, "kind": "section",
            })

    # ---- counters -----------------------------------------------------

    def counter(self, name: str, value: float,
                step: int | None = None) -> None:
        self.counters.append({"name": name, "ts_ms": round(
            self._now_ms(), 6), "value": float(value), "step": step})

    # ---- summaries ----------------------------------------------------

    def phase_means(self) -> dict[str, float]:
        """Mean per-step duration of every merged phase (ms)."""
        sums: dict[str, float] = {}
        counts: dict[str, int] = {}
        for rec in self.steps:
            for ph, ms in rec["phases"].items():
                sums[ph] = sums.get(ph, 0.0) + ms
                counts[ph] = counts.get(ph, 0) + 1
        return {ph: sums[ph] / counts[ph] for ph in sorted(sums)}

    def step_wall_means(self) -> float | None:
        if not self.steps:
            return None
        return sum(s["wall_ms"] for s in self.steps) / len(self.steps)

    def step_records(self) -> list[dict]:
        """Flight-recorder-shaped records: one per profiled step, with
        the per-phase breakdown flattened to ``phase_ms.<name>``."""
        out = []
        for rec in self.steps:
            flat = {"step": rec["step"],
                    "step_ms": round(rec["wall_ms"], 6)}
            for ph, ms in rec["phases"].items():
                flat[f"phase_ms.{ph}"] = ms
            out.append(flat)
        return out


# ----------------------------------------------------------------------
# Arming
# ----------------------------------------------------------------------

def install(tl: PhaseTimeline) -> PhaseTimeline:
    """Arm ``tl``: trace_span sites report to it and :func:`fence`
    starts blocking.  One timeline at a time (profiling is a process
    activity); re-installing replaces."""
    from flashmoe_tpu_torch.utils.telemetry import set_span_listener

    _ACTIVE[0] = tl
    set_span_listener(tl)
    return tl


def uninstall() -> None:
    from flashmoe_tpu_torch.utils.telemetry import set_span_listener

    _ACTIVE[0] = None
    set_span_listener(None)


@contextlib.contextmanager
def profiling(tl: PhaseTimeline | None = None):
    """Arm a timeline for the duration of the block (and yield it)."""
    tl = tl if tl is not None else PhaseTimeline()
    install(tl)
    try:
        yield tl
    finally:
        uninstall()


# ----------------------------------------------------------------------
# Phase fencing
# ----------------------------------------------------------------------

def fence(x):
    """Wait until the device work behind ``x``'s tensor leaves has
    completed (the phase boundary of a profiled run): a CUDA event is
    recorded on each leaf device's current stream and synchronized.  CPU
    leaves need nothing.  With no timeline armed: one ``None`` check.
    Returns ``x`` unchanged."""
    if _ACTIVE[0] is None:
        return x
    import torch

    from flashmoe_tpu_torch.tree import tree_leaves

    devices = {leaf.device for leaf in tree_leaves(x)
               if isinstance(leaf, torch.Tensor) and leaf.is_cuda}
    for dev in devices:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        ev.synchronize()
    return x


def section(name: str, step: int | None = None):
    """A host section on the armed timeline, or a no-op context when
    nothing is armed (the trainer calls this every step)."""
    tl = _ACTIVE[0]
    if tl is None:
        return contextlib.nullcontext()
    return tl.section(name, step=step)
