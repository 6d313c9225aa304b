"""Chaos drill CLI: ``python -m flashmoe_tpu_torch.chaos``.

Counterpart of ``flashmoe_tpu/chaos/__main__.py``, with its flags.  Runs
the fault matrix against a small model and reports, per fault: recovery
outcome, the tier that absorbed it, loss of work and the telemetry
evidence.  Exit code 0 iff every drilled fault recovered.  Without
``--faults`` / ``--fault`` the matrix is every fault, the serving
fabric's included.

``--obs-dir`` exports ``decisions.jsonl`` (every structured decision the
drills produced, each with its ``fault``) and ``drill_results.jsonl``
(one result object per fault).  The drills run on the card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m flashmoe_tpu_torch.chaos",
        description="drill the fault-tolerance ladder")
    p.add_argument("--faults", default=None,
                   help="comma-separated subset (default: all)")
    p.add_argument("--fault", action="append", default=None,
                   metavar="NAME",
                   help="drill a single fault (repeatable; composes "
                        "with --faults)")
    p.add_argument("--steps", type=int, default=6,
                   help="training steps per drill (default 6)")
    p.add_argument("--checkpoint-every", type=int, default=2,
                   help="checkpoint interval (default 2)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--obs-dir", default=None,
                   help="export decisions.jsonl + drill_results.jsonl here")
    p.add_argument("--json", action="store_true",
                   help="print results as JSON instead of the table")
    p.add_argument("--device", default="cuda",
                   help="torch device the drills run on (default cuda)")
    args = p.parse_args(argv)

    import torch

    from flashmoe_tpu_torch.chaos import FAULTS
    from flashmoe_tpu_torch.chaos.drill import run_drill

    faults = ([f.strip() for f in args.faults.split(",") if f.strip()]
              if args.faults else [])
    for f in args.fault or []:
        if f.strip() and f.strip() not in faults:
            faults.append(f.strip())
    if not args.faults and not args.fault:
        faults = list(FAULTS)
    if not faults:
        # '--faults ,' must not report "all recovered" over zero drills
        p.error(f"--faults selected no fault; known: {list(FAULTS)}")
    unknown = [f for f in faults if f not in FAULTS]
    if unknown:
        p.error(f"unknown fault(s) {unknown}; known: {list(FAULTS)}")
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        print("python -m flashmoe_tpu_torch.chaos: no CUDA device (pass "
              "--device cpu to drill on the CPU)", file=sys.stderr)
        return 2

    results = [run_drill(f, num_steps=args.steps,
                         checkpoint_every=args.checkpoint_every,
                         seed=args.seed, device=args.device)
               for f in faults]

    if args.obs_dir:
        os.makedirs(args.obs_dir, exist_ok=True)
        with open(os.path.join(args.obs_dir, "decisions.jsonl"), "w") as f:
            for r in results:
                for d in r.decisions:
                    f.write(json.dumps(dict(d, fault=r.fault)) + "\n")
        with open(os.path.join(args.obs_dir,
                               "drill_results.jsonl"), "w") as f:
            for r in results:
                f.write(json.dumps(r.to_json()) + "\n")

    if args.json:
        print(json.dumps([r.to_json() for r in results], indent=2))
    else:
        w = max(len(r.fault) for r in results)
        print(f"{'fault':<{w}}  {'tier':<24} {'ok':<4} {'rerun':>5} "
              f"{'wall_s':>7}  evidence")
        for r in results:
            ev = ", ".join(r.evidence["decision_names"]) or "-"
            status = "PASS" if r.recovered else "FAIL"
            print(f"{r.fault:<{w}}  {r.expected_tier:<24} {status:<4} "
                  f"{r.steps_rerun:>5} {r.wall_s:>7.1f}  {ev}")
            if not r.recovered:
                print(f"{'':<{w}}    -> {r.reason}")
        n_ok = sum(r.recovered for r in results)
        print(f"\n{n_ok}/{len(results)} faults recovered at their "
              f"intended tier")
    return 0 if all(r.recovered for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
