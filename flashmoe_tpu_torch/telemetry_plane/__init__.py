"""The live telemetry plane: what the job looks like while it runs.

Counterpart of ``flashmoe_tpu/telemetry_plane/``:

* :mod:`~flashmoe_tpu_torch.telemetry_plane.sketch`: bounded-memory
  streaming quantiles and windowed rates (``Metrics.sketch``);
* :mod:`~flashmoe_tpu_torch.telemetry_plane.tracing`: the serving
  engine's request-scoped tracer;
* :mod:`~flashmoe_tpu_torch.telemetry_plane.attribution`: a retired
  request's latency split into its critical-path components;
* :mod:`~flashmoe_tpu_torch.telemetry_plane.server`: the ``/metrics``,
  ``/healthz`` and ``/vars`` scrape endpoints;
* :mod:`~flashmoe_tpu_torch.telemetry_plane.regression`: the
  perf-regression sentry over the port's run history, behind
  ``observe.py --regression``.

Import the submodules directly; this ``__init__`` stays light.
"""
