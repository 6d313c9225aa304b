"""The live telemetry plane: what the job looks like while it runs.

Counterpart of ``flashmoe_tpu/telemetry_plane/``:

* :mod:`~flashmoe_tpu_torch.telemetry_plane.sketch`: bounded-memory
  streaming quantiles and windowed rates (``Metrics.sketch``);
* :mod:`~flashmoe_tpu_torch.telemetry_plane.tracing`: the serving
  engine's request-scoped tracer;
* :mod:`~flashmoe_tpu_torch.telemetry_plane.attribution`: a retired
  request's latency split into its critical-path components;
* :mod:`~flashmoe_tpu_torch.telemetry_plane.server`: the ``/metrics``,
  ``/healthz`` and ``/vars`` scrape endpoints.

JAX's ``regression`` module (the perf-regression sentry over the run
history its ``bench.py`` writes and ``observe.py --regression`` reads)
waits for the port's benchmark (ROADMAP "The port's benchmark").  Import
the submodules directly; this ``__init__`` stays light.
"""
