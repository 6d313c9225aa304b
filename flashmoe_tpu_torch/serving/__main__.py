"""Serving drill CLI: a seeded multi-request continuous-batching run.

Usage::

    python -m flashmoe_tpu_torch.serving                  # on the card
    python -m flashmoe_tpu_torch.serving --device cpu     # on the CPU
    python -m flashmoe_tpu_torch.serving --requests 12 --max-batch 8 \\
        --max-new 8 --arrival-every 2 --seed 7 --obs-dir obs/

Counterpart of ``python -m flashmoe_tpu.serving``, with its flags: a
small MoE transformer on random weights through the engine under a
seeded arrival trace; prints one JSON summary line (requests completed,
tokens/s, TTFT / TPOT, queue depth, cache occupancy, evictions, the
plans) and, with ``--obs-dir``, writes ``flight.jsonl`` and
``decisions.jsonl``.  It runs on the card unless ``--device cpu`` is
given; without a GPU it fails.  On the card ``--hidden`` defaults to
128 (JAX's 64 makes heads of 32, which the flash attention kernel does
not take).  ``--ttft-slo-ms`` / ``--tpot-slo-ms``,
``--telemetry-port`` and ``--trace`` reach keywords the engine refuses
(ROADMAP "Host-side planes") and raise ``NotImplementedError``.
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
    ap.add_argument("--hidden", type=int, default=None,
                    help="model width: by default 64 on the CPU (two "
                         "heads of 32) and 128 on the card, whose flash "
                         "attention kernel takes heads of 64 or 128")
    ap.add_argument("--experts", type=int, default=4)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--vocab", type=int, default=256)
    ap.add_argument("--device", default="cuda",
                    help="where to serve: 'cuda' (default; fails without "
                         "a GPU) or 'cpu'")
    ap.add_argument("--ttft-slo-ms", type=float, default=None,
                    help="refused: the SLO watchdog is not ported")
    ap.add_argument("--tpot-slo-ms", type=float, default=None,
                    help="refused: the SLO watchdog is not ported")
    ap.add_argument("--obs-dir", default=os.environ.get(
        "FLASHMOE_OBS_DIR"),
        help="write flight.jsonl + decisions.jsonl here")
    ap.add_argument("--telemetry-port", type=int, default=None,
                    metavar="PORT",
                    help="refused: the live telemetry plane is not ported")
    ap.add_argument("--trace", action="store_true",
                    help="refused: request tracing is not ported")
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

    if args.hidden is None:
        args.hidden = 128 if device.type == "cuda" else 64
    cfg = tiny_config(hidden=args.hidden, experts=args.experts,
                      layers=args.layers, vocab=args.vocab)
    params = init_params(
        torch.Generator(device=device).manual_seed(args.seed), cfg)
    reqs, arrivals = build_requests(
        args.requests, vocab=args.vocab, prompt_len=args.prompt_len,
        max_new=args.max_new, seed=args.seed,
        arrival_every=args.arrival_every,
        temperature=args.temperature)
    slo = ((args.ttft_slo_ms, args.tpot_slo_ms)
           if args.ttft_slo_ms or args.tpot_slo_ms else None)

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
    engine.run(reqs, arrivals)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall_s = time.monotonic() - t0

    summary = engine.summary()
    summary["wall_s"] = round(wall_s, 3)
    summary["tokens_per_sec"] = round(summary["tokens"] / wall_s, 1) \
        if wall_s > 0 else None
    summary["slo_breaches"] = int(metrics.counters.get("slo.breaches", 0))
    summary["device"] = (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu")
    if args.obs_dir:
        os.makedirs(args.obs_dir, exist_ok=True)
        recorder.export_jsonl(os.path.join(args.obs_dir, "flight.jsonl"))
        metrics.dump_decisions_jsonl(
            os.path.join(args.obs_dir, "decisions.jsonl"))
        summary["obs_dir"] = args.obs_dir
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
