"""End-to-end training CLI.

Counterpart of ``flashmoe_tpu/runtime/train_cli.py``: a preset or a JSON
config, the runtime bootstrap, the native token loader, the train step,
and with ``--checkpoint-dir`` the resilient loop with periodic
checkpoints, SIGTERM / SIGUSR1 drains and resume.  Runs on the card unless
``--device cpu`` is given (without a GPU it exits 2 otherwise).

    python -m flashmoe_tpu_torch.runtime.train_cli --preset mixtral-8x7b \\
        --num-layers 1 --data tokens.bin --steps 100 --batch 4 \\
        --checkpoint-dir ckpt/ --async-save
    python -m flashmoe_tpu_torch.runtime.train_cli --config cfg.json \\
        --synthetic --device cpu

``--synthetic`` trains on random tokens drawn from a ``torch.Generator``
seeded with the step index on the device (JAX draws from
``PRNGKey(step)``: the streams differ).  Each logged step prints
``{"step": i, ...}`` to stderr (every ``--log-every``-th and the last;
with ``--checkpoint-dir``, each such step as it completes, a replayed
step again); the last stdout line is the run's summary (JAX's keys:
the metrics' counters and step timer, ``final_loss``, ``steps``).  A step
is timed until its work on the device has completed.
``--telemetry-port`` serves ``/metrics``, ``/healthz`` and ``/vars`` for
the run.
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys

import torch

from flashmoe_tpu_torch.config import MoEConfig, dtype_from_name
from flashmoe_tpu_torch.models.presets import PRESETS
from flashmoe_tpu_torch.runtime import bootstrap
from flashmoe_tpu_torch.runtime.data import TokenLoader
from flashmoe_tpu_torch.runtime.elastic import train_mesh
from flashmoe_tpu_torch.runtime.resilient import (ResilienceConfig,
                                                  _block_until_ready,
                                                  resilient_train,
                                                  scalar_metrics)
from flashmoe_tpu_torch.runtime.trainer import (GradGuardConfig, init_state,
                                                make_optimizer,
                                                make_train_step)
from flashmoe_tpu_torch.utils.telemetry import Metrics


def _synthetic_batches(cfg: MoEConfig, batch: int, device):
    for i in itertools.count():
        g = torch.Generator(device=device).manual_seed(i)
        yield {"tokens": torch.randint(
            0, cfg.vocab_size, (batch, cfg.sequence_len + 1), generator=g,
            device=device, dtype=torch.int32)}


def _log(i: int, rec: dict) -> None:
    print(json.dumps({"step": i, **rec}), file=sys.stderr, flush=True)


def _parse_overrides(cfg: MoEConfig, args) -> MoEConfig:
    overrides = {"is_training": True}
    if args.num_layers:
        overrides["num_layers"] = args.num_layers
    for kv in args.set:
        k, _, v = kv.partition("=")
        cur = getattr(cfg, k)  # raises on an unknown field
        if isinstance(cur, torch.dtype):
            overrides[k] = dtype_from_name(v)
        elif isinstance(cur, bool):
            overrides[k] = v.lower() in ("1", "true", "yes")
        elif isinstance(cur, int):
            overrides[k] = int(v)
        elif isinstance(cur, float):
            overrides[k] = float(v)
        else:
            overrides[k] = v
    return cfg.replace(**overrides)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    src = ap.add_mutually_exclusive_group()
    src.add_argument("--preset", choices=sorted(PRESETS))
    src.add_argument("--config", help="flashmoe-style config JSON path")
    ap.add_argument("--data", help="binary int32 token file")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=100)
    ap.add_argument("--async-save", action="store_true",
                    help="hand checkpoint writes to the background writer; "
                         "the step loop pays only the copy to pinned host "
                         "memory")
    ap.add_argument("--grace-s", type=float, default=30.0,
                    help="preemption grace window: SIGTERM/SIGUSR1 drain "
                         "a final checkpoint and the loader's cursor")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--metrics-jsonl", default=None)
    ap.add_argument("--telemetry-port", type=int, default=None,
                    metavar="PORT",
                    help="serve live /metrics, /healthz and /vars on "
                         "this port for the run's duration (0 = "
                         "ephemeral; default off = no thread)")
    ap.add_argument("--grad-guard", action="store_true",
                    help="skip non-finite or spiking updates on the device")
    ap.add_argument("--grad-spike-factor", type=float, default=10.0)
    ap.add_argument("--num-layers", type=int, default=None,
                    help="override (e.g. shrink a preset for a smoke run)")
    ap.add_argument("--set", action="append", default=[],
                    metavar="FIELD=VALUE",
                    help="override any MoEConfig field (repeatable), e.g. "
                         "--set sequence_len=256")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        print("train_cli: no CUDA device (pass --device cpu to run on the "
              "CPU)", file=sys.stderr)
        return 2

    if args.preset:
        cfg = PRESETS[args.preset]()
    elif args.config:
        cfg = MoEConfig.from_json(args.config)
    else:
        cfg = MoEConfig()
    cfg = _parse_overrides(cfg, args)

    rt = bootstrap.initialize(cfg, device=args.device)
    cfg, dev = rt.cfg, rt.device
    mesh = train_mesh(cfg, rt.mesh.size, dev)
    print(f"mesh={dict(rt.mesh.shape)} experts={cfg.num_experts} "
          f"layers={cfg.num_layers} device={dev}", file=sys.stderr)

    if args.data and not args.synthetic:
        data = TokenLoader(args.data, args.batch, cfg.sequence_len,
                           device=dev)
        print(f"data={args.data} native={data.is_native}", file=sys.stderr)
    else:
        data = _synthetic_batches(cfg, args.batch, dev)

    optimizer = make_optimizer(cfg, lr=args.lr, total_steps=args.steps)
    guard = (GradGuardConfig(spike_factor=args.grad_spike_factor)
             if args.grad_guard else None)
    state = init_state(torch.Generator(device=dev).manual_seed(0), cfg,
                       optimizer, guard=guard)
    step = make_train_step(cfg, optimizer, guard=guard, mesh=mesh)

    def logged(s, b):
        ns, m = step(s, b)
        i = int(s.step)
        if i % args.log_every == 0 or i == args.steps - 1:
            _log(i, scalar_metrics(m))
        return ns, m

    metrics = Metrics()
    try:
        if args.checkpoint_dir:
            from flashmoe_tpu_torch.runtime.preempt import PreemptionListener

            rcfg = ResilienceConfig(checkpoint_dir=args.checkpoint_dir,
                                    checkpoint_every=args.checkpoint_every,
                                    async_save=args.async_save)
            # a TokenLoader's cursor rides every manifest, so a restarted
            # run continues the exact token stream
            preempt = PreemptionListener(grace_s=args.grace_s).install()
            try:
                state, history = resilient_train(
                    state, logged, data, args.steps, rcfg=rcfg,
                    metrics=metrics, preempt=preempt, cfg=cfg,
                    telemetry_port=args.telemetry_port)
            finally:
                preempt.uninstall()
            if preempt.requested:
                print(f"preempted: drained at step {int(state.step)} "
                      f"(checkpoint + loader state in "
                      f"{args.checkpoint_dir}); re-run to resume",
                      file=sys.stderr)
        else:
            server = None
            progress = {"step": 0}
            if args.telemetry_port is not None:
                from flashmoe_tpu_torch.runtime.telemetry_hooks import (
                    train_server)

                server = train_server(args.telemetry_port, cfg, mesh,
                                      num_steps=args.steps,
                                      progress=progress,
                                      metrics_obj=metrics)
            history = []
            try:
                for i in range(args.steps):
                    progress["step"] = i
                    with metrics.timer("step"):
                        state, m = step(state, next(data))
                        _block_until_ready(m)
                    if i % args.log_every == 0 or i == args.steps - 1:
                        rec = scalar_metrics(m)
                        history.append(rec)
                        _log(i, rec)
            finally:
                if server is not None:
                    server.stop()
    finally:
        if isinstance(data, TokenLoader):
            data.close()
        bootstrap.finalize()

    summary = dict(metrics.summary(),
                   final_loss=history[-1].get("loss") if history else None,
                   steps=args.steps)
    if args.metrics_jsonl:
        metrics.dump_jsonl(args.metrics_jsonl, steps=args.steps)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
