"""The phase profiler and its consumers.

Counterpart of ``flashmoe_tpu/profiler/``:

* :mod:`~flashmoe_tpu_torch.profiler.spans`: a host-side span clock on
  the layers' ``trace_span`` sites; with ``MoEConfig.profile_phases`` the
  layers fence each phase on a CUDA event, so an armed
  :class:`~flashmoe_tpu_torch.profiler.spans.PhaseTimeline` measures
  device-complete per-phase wall time (gate, dispatch, exchanges, expert
  FFN, combine);
* :mod:`~flashmoe_tpu_torch.profiler.ledger`: each measured phase against
  the planner's prediction of that phase (``planner.phase_drift``);
* :mod:`~flashmoe_tpu_torch.profiler.export`: Chrome-trace / Perfetto
  documents of timelines and of the request tracer;
* :mod:`~flashmoe_tpu_torch.profiler.slo`: the step / phase-time SLO
  watchdog, escalating into the planner's path demotion;
* :mod:`~flashmoe_tpu_torch.profiler.postmortem`: crash bundles.

Import the submodules directly; this ``__init__`` stays light because
the layers import :mod:`~flashmoe_tpu_torch.profiler.spans` at load.
"""

from flashmoe_tpu_torch.profiler import spans  # noqa: F401
