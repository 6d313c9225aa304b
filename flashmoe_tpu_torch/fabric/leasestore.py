"""External fenced lease store: the cross-process front-door seam.

Counterpart of ``flashmoe_tpu/fabric/leasestore.py`` (no JAX in it; the
port keeps its own copy, on the port's CRC32 helper).  The lease table
lives outside the process: a single file any number of OS processes
share, with the three properties a real lease service needs:

* **mutual exclusion** — every read-modify-write runs under an
  exclusive :func:`fcntl.flock` on the store file, so two doors racing
  a failover serialize at the kernel, not in Python;
* **torn-write recovery** — the store is an append-only log of
  CRC-framed full-table records (``<magic, body_len, body_crc32>`` +
  JSON body, the :mod:`flashmoe_tpu_torch.utils.integrity` + checkpoint-
  manifest idiom).  A writer killed mid-append leaves a torn tail; the
  next reader's scan stops at the first frame whose CRC refuses, and
  the next WRITER truncates the garbage back to the last intact record
  (a ``frontdoor.lease_repair`` decision) — the store never serves a
  half-written epoch;
* **epoch fencing** — every lease write carries the epoch the writer
  believes it is advancing to.  A write at an epoch <= the stored one
  is REFUSED (``frontdoor.fence`` decision, ``StaleLeaseError``): a
  partitioned zombie door re-asserting its old leases after a failover
  cannot clobber the new owner — the fencing-token discipline of
  Chubby/ZooKeeper leases, drilled by the ``lease_split_brain`` chaos
  row.

The same table carries the decode replicas' **sub-step heartbeats**
(monotonic ``seq`` bumped at every engine-step phase boundary,
vclock-stamped when the fabric's virtual clock is armed), and
:class:`HeartbeatWatchdog` turns them into stall detection: a replica
whose seq stops advancing while it still holds work is declared
stalled after ``misses_to_stall`` consecutive missed observations
(deadline hysteresis — a slow-but-alive replica that beats every other
step never trips), triggering the fence+evacuate+adopt migration
path mid-step, not at the step boundary.
"""

from __future__ import annotations

import dataclasses
import fcntl
import json
import os
import struct

from flashmoe_tpu_torch.utils.integrity import crc32_bytes
from flashmoe_tpu_torch.utils.telemetry import metrics as _global_metrics

#: record frame: magic + body length + body crc32 (little-endian)
_MAGIC = b"FML1"
_HDR = struct.Struct("<4sII")


class LeaseStoreError(RuntimeError):
    """The store file is unusable (not a torn tail — those recover)."""


class StaleLeaseError(LeaseStoreError):
    """A lease write was fenced off: its epoch is not newer than the
    stored one.  The writer holds a revoked lease and must stand
    down."""


def _frame(state: dict) -> bytes:
    body = json.dumps(state, sort_keys=True).encode()
    return _HDR.pack(_MAGIC, len(body), crc32_bytes(body)) + body


def _scan(blob: bytes) -> tuple[dict | None, int, int]:
    """Walk the record log.  Returns ``(last intact state, offset just
    past it, torn bytes beyond it)`` — a torn/corrupt tail never hides
    the intact history before it."""
    state, pos = None, 0
    n = len(blob)
    while pos + _HDR.size <= n:
        magic, blen, crc = _HDR.unpack_from(blob, pos)
        body_at = pos + _HDR.size
        if magic != _MAGIC or body_at + blen > n:
            break                       # torn header or truncated body
        body = blob[body_at:body_at + blen]
        if crc32_bytes(body) != crc:
            break                       # torn/corrupted body
        try:
            state = json.loads(body.decode())
        except ValueError:
            break
        pos = body_at + blen
    return state, pos, n - pos


@dataclasses.dataclass(frozen=True)
class Lease:
    """One shard's lease row."""

    shard: int
    owner: int
    epoch: int


class LeaseStore:
    """File-backed fenced lease + heartbeat table.

    ``path``: the store file (created empty on first use).
    ``n_shards``: the namespace shard count the lease table covers.
    ``peer``: this process's door/peer id, stamped on its fencing
    decisions so a merged fleet view names WHO was refused."""

    def __init__(self, path: str, *, n_shards: int = 8,
                 metrics_obj=None, peer=None):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.path = str(path)
        self.n_shards = int(n_shards)
        self.peer = peer
        self.metrics = (metrics_obj if metrics_obj is not None
                        else _global_metrics)
        self.repairs = 0
        self.fenced = 0
        # touch the file so every later open can be "r+b"
        with open(self.path, "ab"):
            pass

    # ---- framing / locking -------------------------------------------

    def _load(self, fh) -> tuple[dict, int, int]:
        fh.seek(0)
        state, good_end, torn = _scan(fh.read())
        if state is None:
            state = {"leases": {}, "beats": {}}
        return state, good_end, torn

    def _repair(self, fh, good_end: int, torn: int,
                state: dict) -> None:
        """Roll a torn tail back to the last intact record — the
        recovery arm of the checkpoint-manifest idiom, drilled by
        ``lease_torn_write``."""
        fh.truncate(good_end)
        self.repairs += 1
        epochs = [v["epoch"] for v in state["leases"].values()]
        self.metrics.count("frontdoor.lease_repairs")
        self.metrics.decision(
            "frontdoor.lease_repair", peer=self.peer,
            torn_bytes=int(torn), restored_offset=int(good_end),
            restored_epoch=(max(epochs) if epochs else None))

    def _write(self, fh, state: dict) -> None:
        fh.seek(0, os.SEEK_END)
        fh.write(_frame(state))
        fh.flush()
        os.fsync(fh.fileno())

    def _mutate(self, fn):
        """One locked read-modify-write round: load the last intact
        state (repairing any torn tail first), apply ``fn`` (which may
        raise to refuse), append the new record."""
        with open(self.path, "r+b") as fh:
            fcntl.flock(fh.fileno(), fcntl.LOCK_EX)
            try:
                state, good_end, torn = self._load(fh)
                if torn:
                    self._repair(fh, good_end, torn, state)
                out = fn(state)
                self._write(fh, state)
                return out
            finally:
                fcntl.flock(fh.fileno(), fcntl.LOCK_UN)

    def read(self) -> dict:
        """The last intact table state (shared-lock snapshot; a torn
        tail is SKIPPED here and repaired by the next writer)."""
        with open(self.path, "rb") as fh:
            fcntl.flock(fh.fileno(), fcntl.LOCK_SH)
            try:
                state, _end, _torn = self._load(fh)
                return state
            finally:
                fcntl.flock(fh.fileno(), fcntl.LOCK_UN)

    # ---- leases (epoch-fenced) ---------------------------------------

    def init_leases(self, owners: dict[int, int]) -> None:
        """Seed the lease table at epoch 0 — only shards not already
        present are written, so a second process joining an existing
        store adopts the live table instead of resetting it."""
        def fn(state):
            for shard, owner in owners.items():
                state["leases"].setdefault(
                    str(int(shard)), {"owner": int(owner), "epoch": 0})
        self._mutate(fn)

    def leases(self) -> dict[int, Lease]:
        return {int(s): Lease(int(s), int(v["owner"]), int(v["epoch"]))
                for s, v in self.read()["leases"].items()}

    def write_lease(self, shard: int, owner: int, epoch: int, *,
                    reason: str | None = None) -> Lease:
        """Advance one shard's lease — REFUSED (``StaleLeaseError`` +
        ``frontdoor.fence`` decision) unless ``epoch`` is strictly newer
        than the stored one.  The refusal is the split-brain guard: a
        zombie peer re-asserting a revoked lease cannot take the shard
        back."""
        def fn(state):
            cur = state["leases"].get(str(int(shard)),
                                      {"owner": -1, "epoch": -1})
            if int(epoch) <= int(cur["epoch"]):
                self.fenced += 1
                self.metrics.count("frontdoor.fences")
                self.metrics.decision(
                    "frontdoor.fence", shard=int(shard),
                    peer=self.peer, claimant=int(owner),
                    stale_epoch=int(epoch),
                    current_epoch=int(cur["epoch"]),
                    current_owner=int(cur["owner"]),
                    refused=True, reason=reason)
                raise StaleLeaseError(
                    f"lease write for shard {shard} at epoch {epoch} "
                    f"refused: store holds epoch {cur['epoch']} "
                    f"(owner {cur['owner']}) — claimant {owner} is "
                    f"fenced off")
            state["leases"][str(int(shard))] = {
                "owner": int(owner), "epoch": int(epoch)}
            return Lease(int(shard), int(owner), int(epoch))
        return self._mutate(fn)

    # ---- heartbeats --------------------------------------------------

    def heartbeat(self, key, seq: int, *, ts_ms: float = 0.0,
                  phase: str | None = None,
                  step: int | None = None) -> bool:
        """Publish one monotonic heartbeat for ``key`` (a replica id or
        a door name).  A stale ``seq`` (<= the stored one) is dropped —
        heartbeats only ever advance.  Returns whether it landed."""
        def fn(state):
            cur = state["beats"].get(str(key))
            if cur is not None and int(seq) <= int(cur["seq"]):
                return False
            state["beats"][str(key)] = {
                "seq": int(seq), "ts_ms": round(float(ts_ms), 6),
                "phase": phase,
                "step": (int(step) if step is not None else None)}
            return True
        return self._mutate(fn)

    def beats(self) -> dict:
        return dict(self.read()["beats"])

    # ---- chaos / test seams ------------------------------------------

    def tear_last_record(self, keep_fraction: float = 0.5) -> int:
        """Simulate a writer killed mid-append (``kill -9`` during
        :meth:`_write`): truncate the newest record mid-body so its CRC
        can no longer verify.  Returns the bytes torn off.  The next
        reader must recover the PREVIOUS intact state — the
        ``lease_torn_write`` drill's injection."""
        with open(self.path, "r+b") as fh:
            fcntl.flock(fh.fileno(), fcntl.LOCK_EX)
            try:
                fh.seek(0)
                blob = fh.read()
                _state, good_end, _torn = _scan(blob)
                if good_end == 0:
                    return 0
                # find the start of the LAST intact record
                prev_end = 0
                pos = 0
                while pos < good_end:
                    _m, blen, _c = _HDR.unpack_from(blob, pos)
                    nxt = pos + _HDR.size + blen
                    if nxt >= good_end:
                        prev_end = pos
                        break
                    pos = nxt
                last_len = good_end - prev_end
                cut = prev_end + max(_HDR.size + 1,
                                     int(last_len * keep_fraction))
                cut = min(cut, good_end - 1)
                fh.truncate(cut)
                return len(blob) - cut
            finally:
                fcntl.flock(fh.fileno(), fcntl.LOCK_UN)

    def snapshot(self) -> dict:
        """Live ``/vars`` view."""
        state = self.read()
        epochs = [v["epoch"] for v in state["leases"].values()]
        return {
            "path": self.path,
            "shards": self.n_shards,
            "leases": state["leases"],
            "beats": state["beats"],
            "max_epoch": (max(epochs) if epochs else None),
            "repairs": self.repairs,
            "fenced": self.fenced,
        }


@dataclasses.dataclass(frozen=True)
class HeartbeatConfig:
    """Arms sub-step heartbeat publication + stall detection on a
    :class:`~flashmoe_tpu_torch.fabric.engine.ServingFabric`.

    ``misses_to_stall``: consecutive fabric-step observations with no
    fresh heartbeat before a replica is declared stalled.  >= 2 is the
    deadline hysteresis: a slow-but-alive replica that publishes at
    least every other observation never false-positives (drilled by
    ``tests/test_torch_fabric_wire.py``).  ``store_path``: where the lease
    store lives; ``None`` lets the fabric place it in a tempdir."""

    misses_to_stall: int = 2
    store_path: str | None = None

    def __post_init__(self):
        if self.misses_to_stall < 1:
            raise ValueError(
                f"misses_to_stall must be >= 1, "
                f"got {self.misses_to_stall}")


class HeartbeatPublisher:
    """The engine-side half: a callable ``(phase)`` the
    :class:`~flashmoe_tpu_torch.serving.engine.ServingEngine` invokes at every
    step-phase boundary (enter/admit/prefill/sample/decode/end).  Each
    call bumps the replica's monotonic ``seq`` in the store, stamped
    with virtual time when the fabric's clock is armed — so the
    watchdog can see WHERE inside a step a replica froze."""

    def __init__(self, store: LeaseStore, replica: int, *,
                 clock=None, step_fn=None):
        self.store = store
        self.replica = int(replica)
        self._clock = clock
        self._step_fn = step_fn
        self.seq = 0

    def __call__(self, phase: str) -> None:
        self.seq += 1
        ts = (self._clock() * 1e3 if self._clock is not None else 0.0)
        self.store.heartbeat(
            self.replica, self.seq, ts_ms=ts, phase=phase,
            step=(self._step_fn() if self._step_fn is not None
                  else None))


class HeartbeatWatchdog:
    """The fabric-side half: one observation per fabric step.  A
    replica with pending work whose stored ``seq`` did not advance
    since the last observation takes a miss (``fabric.heartbeat_miss``
    decision); ``misses_to_stall`` consecutive misses declare it
    stalled (``fabric.heartbeat_stall`` — detection latency in ms of
    virtual decode time) and the fabric runs the fence+evacuate+adopt
    migration.  Any fresh beat resets the miss count — the hysteresis
    that keeps a merely slow replica out of the morgue."""

    def __init__(self, store: LeaseStore, *, misses_to_stall: int = 2,
                 tick_ms: float | None = None, metrics_obj=None):
        self.store = store
        self.misses_to_stall = int(misses_to_stall)
        self.tick_ms = tick_ms
        self.metrics = (metrics_obj if metrics_obj is not None
                        else _global_metrics)
        self._last_seq: dict[int, int] = {}
        self._misses: dict[int, int] = {}
        self.stalled_total = 0

    def observe(self, step: int, replicas, *, pending=None) -> list[int]:
        """One post-step sweep over ``replicas``.  ``pending(r)`` gates
        the miss accounting: an idle replica owes no heartbeat.
        Returns the replicas newly declared stalled this observation."""
        beats = self.store.beats()
        stalled: list[int] = []
        for r in replicas:
            r = int(r)
            row = beats.get(str(r))
            seq = int(row["seq"]) if row is not None else -1
            if seq > self._last_seq.get(r, -1):
                self._last_seq[r] = seq
                self._misses[r] = 0
                continue
            if pending is not None and not pending(r):
                continue                # idle: no beat owed
            self._misses[r] = self._misses.get(r, 0) + 1
            self.metrics.count("fabric.heartbeat_misses")
            self.metrics.decision(
                "fabric.heartbeat_miss", replica=r, step=int(step),
                misses=self._misses[r], last_seq=seq,
                last_phase=(row or {}).get("phase"),
                budget_left=self.misses_to_stall - self._misses[r])
            if self._misses[r] >= self.misses_to_stall:
                detect_ms = (self._misses[r] * float(self.tick_ms)
                             if self.tick_ms else 0.0)
                self.stalled_total += 1
                self.metrics.count("fabric.heartbeat_stalls")
                self.metrics.sketch("fabric.heartbeat_detect_ms",
                                    detect_ms)
                self.metrics.decision(
                    "fabric.heartbeat_stall", replica=r,
                    step=int(step), misses=self._misses[r],
                    last_seq=seq, last_phase=(row or {}).get("phase"),
                    last_step=(row or {}).get("step"),
                    detect_ms=round(detect_ms, 6))
                stalled.append(r)
                self._misses[r] = 0
        return stalled

    def snapshot(self) -> dict:
        return {
            "misses_to_stall": self.misses_to_stall,
            "tick_ms": self.tick_ms,
            "misses": dict(self._misses),
            "stalled_total": self.stalled_total,
        }
