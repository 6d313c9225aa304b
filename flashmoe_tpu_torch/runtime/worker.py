"""Per-process worker entry point.

Counterpart of ``flashmoe_tpu/runtime/worker.py``: initialize the runtime,
build random weights and inputs sized from the config, run the MoE layer
forward (optionally a timed loop) and print one JSON line.

    python -m flashmoe_tpu_torch.runtime.worker [config.json] [--bench]
        [--device cpu]

The weights come from a ``torch.Generator`` seeded with 0 on every rank
(JAX seeds them by rank), the tokens from one seeded with 1 + rank, on the
runtime's device.  One process runs ``moe_layer``; a process world whose
ep spans its processes runs ``ep_moe_layer`` over the process mesh, each
rank on its own ``sequence_len * mini_batch`` tokens.  The line holds
JAX's keys (``rank``, ``output_shape``, ``finite``,
``num_local_experts``) and the output's sum and sum of squares; with
``--bench``, ``moe_fwd_ms``, the mean of ``--trials`` calls after
``--skip`` warm-up calls (CUDA events on the card, the host clock on the
CPU), and the device's name.  Without ``--device cpu`` it needs a GPU and
exits 2 otherwise.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from flashmoe_tpu_torch.config import MoEConfig
from flashmoe_tpu_torch.models.reference import init_moe_params
from flashmoe_tpu_torch.ops.moe import moe_layer
from flashmoe_tpu_torch.parallel.ep import ep_moe_layer
from flashmoe_tpu_torch.runtime import bootstrap
from flashmoe_tpu_torch.tree import tree_map


def _timed_ms(fwd, trials: int, device: torch.device) -> float:
    """Mean ms of ``trials`` calls of ``fwd`` in a row."""
    if device.type == "cuda":
        start, end = torch.cuda.Event(True), torch.cuda.Event(True)
        start.record()
        for _ in range(trials):
            fwd()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / trials
    t0 = time.perf_counter()
    for _ in range(trials):
        fwd()
    return (time.perf_counter() - t0) * 1e3 / trials


def _emit(rec: dict) -> None:
    """One JSON line in one write: the lines of several workers sharing a
    stream never interleave."""
    sys.stdout.write(json.dumps(rec) + "\n")
    sys.stdout.flush()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("config", nargs="?", default=None,
                    help="path to a flashmoe-style config JSON")
    ap.add_argument("--bench", action="store_true",
                    help="timed loop (skip + trials)")
    ap.add_argument("--trials", type=int, default=32)
    ap.add_argument("--skip", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        print("worker: no CUDA device (pass --device cpu to run on the "
              "CPU)", file=sys.stderr)
        return 2

    cfg = MoEConfig.from_json(args.config) if args.config else MoEConfig()
    rt = bootstrap.initialize(cfg, use_decider=False, device=args.device)
    try:
        cfg, dev = rt.cfg, rt.device
        params = init_moe_params(torch.Generator(dev).manual_seed(0), cfg,
                                 device=dev)
        params = tree_map(lambda p: p.to(cfg.dtype), params)
        x = torch.randn((cfg.tokens, cfg.hidden_size),
                        generator=torch.Generator(dev).manual_seed(
                            1 + rt.process_id),
                        dtype=cfg.dtype, device=dev)
        if 1 < cfg.ep <= rt.num_processes:
            def fwd():
                return ep_moe_layer(params, x, cfg, rt.mesh).out
        else:
            def fwd():
                return moe_layer(params, x, cfg).out

        with torch.no_grad():
            out = fwd()
            if args.bench:
                for _ in range(args.skip):
                    fwd()
                ms = _timed_ms(fwd, args.trials, dev)
                _emit({
                    "rank": rt.process_id, "moe_fwd_ms": round(ms, 3),
                    "tokens": cfg.tokens, "num_experts": cfg.num_experts,
                    "devices": rt.num_processes,
                    "device": (torch.cuda.get_device_name(dev)
                               if dev.type == "cuda" else "cpu")})
            else:
                o = out.double()
                _emit({
                    "rank": rt.process_id,
                    "output_shape": list(out.shape),
                    "finite": bool(torch.isfinite(out).all()),
                    "num_local_experts": rt.num_local_experts,
                    "out_sum": float(o.sum()),
                    "out_sumsq": float((o * o).sum())})
    finally:
        bootstrap.finalize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
