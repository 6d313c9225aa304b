"""SLO watchdog: step / phase-time budgets with breach escalation.

Counterpart of ``flashmoe_tpu/profiler/slo.py``.  Declare a wall-time
budget for the step (and optionally per MoE phase, or per serving
request's TTFT / TPOT), and the watchdog narrates compliance:

* every violation is a ``slo.breach`` decision (target, measured against
  budget, the consecutive count) and a ``slo.breaches`` count;
* the first in-budget observation after a breach run is a
  ``slo.recovered`` decision, so the stream reads as breach episodes;
* ``consecutive`` breaches of the step budget escalate once an episode:
  with ``demote_backend`` naming a path, the watchdog calls
  :func:`flashmoe_tpu_torch.planner.select.report_path_failure`, so the
  next ``'auto'`` resolution runs off that path.

Budgets come from an :class:`SLOConfig` built in code or read from a
YAML sidecar (:meth:`SLOConfig.from_yaml`: PyYAML when it imports, else
a dependency-free parser of the flat schema)::

    step_ms: 250          # budget for one train step
    consecutive: 3        # breaches before escalation
    demote_backend: ragged
    phase_ms:
      moe.expert: 120
      moe.a2a_dispatch: 40

``runtime.trainer.train(..., slo=...)``, ``runtime.resilient.
resilient_train(..., slo=...)``, ``supervise`` and the serving engine
feed it.
"""

from __future__ import annotations

import dataclasses

from flashmoe_tpu_torch.utils.telemetry import Metrics, metrics as _global


@dataclasses.dataclass(frozen=True)
class SLOConfig:
    """Budgets and escalation policy (immutable; the watchdog carries
    the mutable episode state)."""

    step_ms: float | None = None
    phase_ms: tuple = ()            # ((phase, budget_ms), ...)
    consecutive: int = 3            # step breaches before escalation
    demote_backend: str | None = None
    # serving budgets (flashmoe_tpu_torch/serving/engine.py): per-request
    # time-to-first-token and time-per-output-token — point
    # observations judged at retirement via :meth:`SLOWatchdog.
    # observe_request`, each violation its own ``slo.breach``
    ttft_ms: float | None = None
    tpot_ms: float | None = None

    def __post_init__(self):
        for name, v in (("step_ms", self.step_ms),
                        ("ttft_ms", self.ttft_ms),
                        ("tpot_ms", self.tpot_ms)):
            if v is not None and v <= 0:
                raise ValueError(f"{name} budget must be > 0, got {v}")
        if self.consecutive < 1:
            raise ValueError("consecutive must be >= 1")
        for ph, ms in self.phase_ms:
            if ms <= 0:
                raise ValueError(f"phase budget {ph!r} must be > 0")

    @property
    def phase_budgets(self) -> dict:
        return dict(self.phase_ms)

    @classmethod
    def from_dict(cls, raw: dict) -> "SLOConfig":
        known = {"step_ms", "consecutive", "demote_backend", "phase_ms",
                 "ttft_ms", "tpot_ms"}
        unknown = set(raw) - known
        if unknown:
            raise ValueError(f"unknown SLO keys {sorted(unknown)}; "
                             f"known: {sorted(known)}")
        phases = raw.get("phase_ms") or {}
        if not isinstance(phases, dict):
            raise ValueError("phase_ms must be a mapping of "
                             "phase -> budget ms")
        phase_ms = []
        for k, v in sorted(phases.items()):
            try:
                phase_ms.append((str(k), float(v)))
            except (TypeError, ValueError):
                raise ValueError(f"phase_ms[{k!r}] must be a number, "
                                 f"got {v!r}") from None
        cons = raw.get("consecutive")
        try:
            return cls(
                step_ms=(float(raw["step_ms"])
                         if raw.get("step_ms") is not None else None),
                consecutive=int(cons) if cons is not None else 3,
                demote_backend=raw.get("demote_backend") or None,
                phase_ms=tuple(phase_ms),
                ttft_ms=(float(raw["ttft_ms"])
                         if raw.get("ttft_ms") is not None else None),
                tpot_ms=(float(raw["tpot_ms"])
                         if raw.get("tpot_ms") is not None else None),
            )
        except TypeError as e:
            # a null/list where a scalar belongs: surface the documented
            # ValueError instead of a bare TypeError
            raise ValueError(f"bad SLO sidecar value: {e}") from None

    @classmethod
    def from_yaml(cls, path: str) -> "SLOConfig":
        """Load the YAML sidecar.  PyYAML when importable; otherwise a
        minimal parser for the documented flat two-level schema (maps
        of scalars, one nested ``phase_ms`` map)."""
        with open(path) as f:
            text = f.read()
        try:
            import yaml  # noqa: PLC0415 — optional dependency

            raw = yaml.safe_load(text) or {}
        except ImportError:
            raw = _parse_flat_yaml(text)
        if not isinstance(raw, dict):
            raise ValueError(f"SLO sidecar {path!r} must be a mapping")
        return cls.from_dict(raw)


def _parse_flat_yaml(text: str) -> dict:
    """Dependency-free subset parser: ``key: value`` lines, one level
    of nesting for mapping values, ``#`` comments.  A bare ``key:``
    with no indented children is YAML null (PyYAML parity), not an
    empty mapping."""
    out: dict = {}
    current: tuple[str, dict] | None = None  # open (key, mapping)

    def _close():
        # a "key:" that gathered no children parses as null, exactly
        # as PyYAML's safe_load would
        nonlocal current
        if current is not None and not current[1]:
            out[current[0]] = None
        current = None

    for line in text.splitlines():
        stripped = line.split("#", 1)[0].rstrip()
        if not stripped.strip():
            continue
        indented = stripped.startswith((" ", "\t"))
        key, sep, val = stripped.strip().partition(":")
        if not sep:
            raise ValueError(f"unparseable SLO line: {line!r}")
        val = val.strip()
        if indented:
            if current is None:
                raise ValueError(f"indented line outside a mapping: "
                                 f"{line!r}")
            current[1][key] = _scalar(val)
        elif val == "":
            _close()
            current = (key, out.setdefault(key, {}))
        else:
            _close()
            out[key] = _scalar(val)
    _close()
    return out


def _scalar(v: str):
    if v.lower() in ("null", "none", "~", ""):
        return None
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    return v.strip("'\"")


class SLOWatchdog:
    """Feed it every step; it narrates budget compliance and escalates
    sustained step-budget breaches into path demotion."""

    def __init__(self, slo: SLOConfig, metrics: Metrics | None = None):
        self.slo = slo
        self.metrics = metrics if metrics is not None else _global
        self._consecutive = 0           # step-budget breach run length
        self._breached: set = set()     # targets currently in breach
        self._escalated = False         # once per breach episode

    @property
    def consecutive_breaches(self) -> int:
        return self._consecutive

    def snapshot(self) -> dict:
        """Episode state for the live ``/healthz`` endpoint: which
        targets are currently in breach, the step-budget run length,
        whether this episode already escalated, and the budgets being
        judged against."""
        return {
            "consecutive_step_breaches": self._consecutive,
            "in_breach": sorted(self._breached),
            "escalated": self._escalated,
            "budgets": {
                k: v for k, v in (
                    ("step_ms", self.slo.step_ms),
                    ("ttft_ms", self.slo.ttft_ms),
                    ("tpot_ms", self.slo.tpot_ms),
                ) if v is not None
            },
        }

    def observe_request(self, step: int, request_id,
                        *, ttft_ms: float | None = None,
                        tpot_ms: float | None = None,
                        dominant: str | None = None) -> list[dict]:
        """Judge one completed serving request against the TTFT/TPOT
        budgets.  Point observations — requests are independent, so
        each violation is its own ``slo.breach`` (target ``ttft`` /
        ``tpot``, with the request id) and there is no recovery pair
        or escalation run: the step budget remains the escalation
        channel.  ``dominant``: the request's critical-path attribution
        verdict (:mod:`flashmoe_tpu_torch.telemetry_plane.attribution`) — carried on the
        breach so the decision names WHERE the budget went, not just
        that it went.  Returns the breach records raised."""
        events: list[dict] = []
        for target, measured, budget in (
                ("ttft", ttft_ms, self.slo.ttft_ms),
                ("tpot", tpot_ms, self.slo.tpot_ms)):
            if budget is None or measured is None:
                continue
            if measured > budget:
                self.metrics.count("slo.breaches")
                events.append(self.metrics.decision(
                    "slo.breach", target=target, step=int(step),
                    request=request_id,
                    measured_ms=round(float(measured), 3),
                    budget_ms=float(budget), consecutive=None,
                    dominant=dominant))
        return events

    def observe_step(self, step: int, step_ms: float,
                     phases: dict | None = None) -> list[dict]:
        """Compare one step (and optionally its phase breakdown)
        against the budgets.  Returns the breach records raised this
        step (empty = within budget)."""
        events: list[dict] = []
        targets: list[tuple[str, float, float]] = []
        if self.slo.step_ms is not None:
            targets.append(("step", float(step_ms), self.slo.step_ms))
        if phases:
            for ph, budget in self.slo.phase_budgets.items():
                if ph in phases:
                    targets.append((ph, float(phases[ph]), budget))

        for target, measured, budget in targets:
            if measured > budget:
                if target == "step":
                    self._consecutive += 1
                self._breached.add(target)
                self.metrics.count("slo.breaches")
                rec = self.metrics.decision(
                    "slo.breach", target=target, step=int(step),
                    measured_ms=round(measured, 3),
                    budget_ms=float(budget),
                    consecutive=(self._consecutive
                                 if target == "step" else None))
                events.append(rec)
            elif target in self._breached:
                self._breached.discard(target)
                if target == "step":
                    self._consecutive = 0
                    self._escalated = False
                self.metrics.count("slo.recoveries")
                self.metrics.decision(
                    "slo.recovered", target=target, step=int(step),
                    measured_ms=round(measured, 3),
                    budget_ms=float(budget))
            elif target == "step":
                self._consecutive = 0
                self._escalated = False

        if (self._consecutive >= self.slo.consecutive
                and not self._escalated):
            self._escalated = True
            self.metrics.count("slo.escalations")
            if self.slo.demote_backend:
                # sustained breach -> the planner's path demotion: the
                # next 'auto' resolution re-plans off this backend
                from flashmoe_tpu_torch.planner.select import (
                    report_path_failure)

                report_path_failure(
                    self.slo.demote_backend,
                    f"slo: step budget {self.slo.step_ms} ms breached "
                    f"{self._consecutive} consecutive steps "
                    f"(last step {int(step)})")
        return events


def as_watchdog(slo):
    """An :class:`SLOConfig`'s watchdog (on the global registry), a
    prebuilt watchdog as is, or None: what the engine and the training
    loops accept as ``slo``."""
    if slo is None:
        return None
    return SLOWatchdog(slo) if isinstance(slo, SLOConfig) else slo
