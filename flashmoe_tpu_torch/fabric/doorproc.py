"""Front-door peer as a separate OS process (the cross-process drill).

Counterpart of ``flashmoe_tpu/fabric/doorproc.py`` (no JAX in it; the
port keeps its own copy).  It touches no device: it needs only the lease
store and a metrics object.

``python -m flashmoe_tpu_torch.fabric.doorproc --store PATH --peer 1
--telemetry OUT.jsonl`` runs one door peer against an EXTERNAL
:class:`~flashmoe_tpu_torch.fabric.leasestore.LeaseStore` shared with the
parent process through the filesystem — nothing else is shared.  The
child:

* publishes monotonic ``door<peer>`` heartbeats into the store every
  iteration (the liveness the parent's watchdog could consume);
* caches the epochs of the shards it owns at startup and watches them:
  when another process advances an epoch (the parent's
  ``fail_door(peer)`` failing this door over), the child plays the
  ZOMBIE — it re-asserts the shard with the fencing token it believes
  is current (``cached_epoch + 1``).  The store must REFUSE the stale
  epoch (``frontdoor.fence`` decision, recorded in this process's own
  telemetry shard) — that refusal, crossing a real process boundary
  through fcntl locks, is the split-brain guard the drill proves;
* flushes its telemetry shard (decisions + beat records, JSONL) every
  iteration, so the parent can ``observe --merge`` the per-door shards
  even after killing the child with ``SIGKILL``.

Exit codes: ``3`` = fenced (the expected drill outcome), ``0`` = ran
all iterations unfenced, ``2`` = bad invocation.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _flush_telemetry(path: str, metrics, beats: list) -> None:
    with open(path, "w") as fh:
        for rec in (*beats, *metrics.decisions):
            fh.write(json.dumps(rec, default=str) + "\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m flashmoe_tpu_torch.fabric.doorproc",
        description="one front-door peer in its own OS process, "
                    "sharing only the external lease store")
    ap.add_argument("--store", required=True,
                    help="path of the shared LeaseStore file")
    ap.add_argument("--peer", type=int, required=True,
                    help="this door's peer id")
    ap.add_argument("--telemetry", required=True,
                    help="this door's telemetry shard "
                         "(telemetry.door<peer>.jsonl)")
    ap.add_argument("--iterations", type=int, default=400)
    ap.add_argument("--interval", type=float, default=0.025,
                    help="seconds between heartbeat/refresh rounds")
    args = ap.parse_args(argv)

    from flashmoe_tpu_torch.fabric.leasestore import (LeaseStore,
                                                      StaleLeaseError)
    from flashmoe_tpu_torch.utils.telemetry import Metrics

    metrics = Metrics()
    store = LeaseStore(args.store, metrics_obj=metrics, peer=args.peer)
    owned = {s: ls.epoch for s, ls in store.leases().items()
             if ls.owner == args.peer}
    beats: list = []
    key = f"door{args.peer}"
    for seq in range(1, args.iterations + 1):
        store.heartbeat(key, seq, ts_ms=time.monotonic() * 1e3,
                        phase="alive", step=seq)
        beats.append({"kind": "doorproc_beat", "peer": args.peer,
                      "seq": seq, "step": seq})
        table = store.leases()
        for shard, cached in sorted(owned.items()):
            cur = table.get(shard)
            if cur is None or cur.epoch <= cached:
                continue
            # someone moved our shard while we weren't looking — the
            # zombie arm: re-assert with the token we BELIEVE is next.
            # The store must refuse it (stale epoch) and that refusal
            # is this process's exit condition.
            try:
                store.write_lease(shard, args.peer, cached + 1,
                                  reason="zombie_reassert")
            except StaleLeaseError:
                _flush_telemetry(args.telemetry, metrics, beats)
                print(f"door{args.peer}: fenced off shard {shard} "
                      f"(stale epoch {cached + 1} vs {cur.epoch})",
                      file=sys.stderr)
                return 3
            # an accepted re-assert means nobody actually advanced
            # past us — adopt the new epoch
            owned[shard] = cached + 1
        _flush_telemetry(args.telemetry, metrics, beats)
        time.sleep(args.interval)
    _flush_telemetry(args.telemetry, metrics, beats)
    return 0


if __name__ == "__main__":
    sys.exit(main())
