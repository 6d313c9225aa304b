"""Serving drill CLI: a seeded multi-request continuous-batching run.

Usage::

    python -m flashmoe_tpu_torch.serving                  # on the card
    python -m flashmoe_tpu_torch.serving --device cpu     # on the CPU
    python -m flashmoe_tpu_torch.serving --requests 12 --max-batch 8 \\
        --max-new 8 --arrival-every 2 --seed 7 --obs-dir obs/
    python -m flashmoe_tpu_torch.serving --trace --telemetry-port 9464 \\
        --ttft-slo-ms 50 --obs-dir obs/   # live plane, request traces

Counterpart of ``python -m flashmoe_tpu.serving``, with its flags: a
small MoE transformer on random weights through the engine under a
seeded arrival trace; prints one JSON summary line (requests completed,
tokens/s, TTFT / TPOT, queue depth, cache occupancy, evictions, the
plans) and, with ``--obs-dir``, writes ``flight.jsonl`` and
``decisions.jsonl``.  It runs on the card unless ``--device cpu`` is
given; without a GPU it fails.  ``--hidden`` defaults to JAX's 64 (two
heads of 32) on every device.  ``--ttft-slo-ms`` / ``--tpot-slo-ms`` arm the SLO watchdog
(``slo.breach`` decisions), ``--telemetry-port`` the scrape server for
the run (its port joins the summary), and ``--trace`` the request tracer:
with ``--obs-dir`` it writes ``trace.jsonl``, ``request_trace.json``
(Perfetto) and the per-host shard, and the summary carries the tracer's
``trace_problems``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m flashmoe_tpu_torch.serving",
        description="seeded continuous-batching serving drill")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--arrival-every", type=int, default=1,
                    help="engine steps between arrival pairs (the "
                         "seeded arrival trace)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--num-pages", type=int, default=64)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--experts", type=int, default=4)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--vocab", type=int, default=256)
    ap.add_argument("--device", default="cuda",
                    help="where to serve: 'cuda' (default; fails without "
                         "a GPU) or 'cpu'")
    ap.add_argument("--ttft-slo-ms", type=float, default=None,
                    help="per-request time-to-first-token budget "
                         "(slo.breach decisions on violation)")
    ap.add_argument("--tpot-slo-ms", type=float, default=None)
    ap.add_argument("--obs-dir", default=os.environ.get(
        "FLASHMOE_OBS_DIR"),
        help="write flight.jsonl + decisions.jsonl here")
    ap.add_argument("--telemetry-port", type=int, default=None,
                    metavar="PORT",
                    help="serve /metrics, /healthz and /vars on this port "
                         "for the run (0: ephemeral; default off)")
    ap.add_argument("--trace", action="store_true",
                    help="trace every request: trace.jsonl and the "
                         "Perfetto request_trace.json into --obs-dir")
    ap.add_argument("--json", action="store_true",
                    help="(default) emit the JSON summary line")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("python -m flashmoe_tpu_torch.serving: no CUDA device (pass "
              "--device cpu to serve on the CPU)", file=sys.stderr)
        return 2

    from flashmoe_tpu_torch.models.transformer import init_params
    from flashmoe_tpu_torch.serving.engine import ServeConfig, ServingEngine
    from flashmoe_tpu_torch.serving.loadgen import (build_requests,
                                                    tiny_config)
    from flashmoe_tpu_torch.utils.telemetry import FlightRecorder, metrics

    cfg = tiny_config(hidden=args.hidden, experts=args.experts,
                      layers=args.layers, vocab=args.vocab)
    params = init_params(
        torch.Generator(device=device).manual_seed(args.seed), cfg)
    reqs, arrivals = build_requests(
        args.requests, vocab=args.vocab, prompt_len=args.prompt_len,
        max_new=args.max_new, seed=args.seed,
        arrival_every=args.arrival_every,
        temperature=args.temperature)
    slo = None
    if args.ttft_slo_ms or args.tpot_slo_ms:
        from flashmoe_tpu_torch.profiler.slo import SLOConfig

        slo = SLOConfig(ttft_ms=args.ttft_slo_ms,
                        tpot_ms=args.tpot_slo_ms)

    recorder = FlightRecorder()
    serve = ServeConfig(
        max_batch=args.max_batch, page_size=args.page_size,
        num_pages=args.num_pages,
        max_pages_per_slot=max(
            2, -(-(args.prompt_len + args.max_new) // args.page_size)
            + 1),
        ctx_bucket_pages=1,
        prompt_bucket=args.page_size)
    t0 = time.monotonic()
    engine = ServingEngine(params, cfg, serve, recorder=recorder,
                           slo=slo, tracer=args.trace,
                           telemetry_port=args.telemetry_port)
    try:
        engine.run(reqs, arrivals)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall_s = time.monotonic() - t0

        summary = engine.summary()
        summary["wall_s"] = round(wall_s, 3)
        summary["tokens_per_sec"] = round(summary["tokens"] / wall_s, 1) \
            if wall_s > 0 else None
        summary["slo_breaches"] = int(
            metrics.counters.get("slo.breaches", 0))
        summary["device"] = (torch.cuda.get_device_name(device)
                             if device.type == "cuda" else "cpu")
        if args.telemetry_port is not None:
            summary["telemetry_port"] = engine.telemetry.port
        if args.obs_dir:
            os.makedirs(args.obs_dir, exist_ok=True)
            recorder.export_jsonl(os.path.join(args.obs_dir,
                                               "flight.jsonl"))
            metrics.dump_decisions_jsonl(
                os.path.join(args.obs_dir, "decisions.jsonl"))
            summary["obs_dir"] = args.obs_dir
            if engine.tracer is not None:
                from flashmoe_tpu_torch.profiler.export import (
                    write_request_trace)
                from flashmoe_tpu_torch.telemetry_plane.server import (
                    host_shard_path)

                summary["trace_problems"] = engine.tracer.validate()
                engine.tracer.export_jsonl(
                    os.path.join(args.obs_dir, "trace.jsonl"))
                write_request_trace(
                    engine.tracer,
                    os.path.join(args.obs_dir, "request_trace.json"))
                # this process's spans under its host id
                engine.tracer.export_jsonl(host_shard_path(args.obs_dir))
    finally:
        engine.close()
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
