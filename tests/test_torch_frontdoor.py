"""PyTorch port: the front door (``flashmoe_tpu_torch/fabric/frontdoor.py``,
``fabric/doorproc.py``), the fleet trace (``profiler/export.py``) and the
trace split (``serving/loadgen.py``) against the JAX package's on the CPU.

The door's logic (namespace ownership, brownout shedding and degrading,
the cluster's lease failover) runs over one deterministic stand-in fabric
that both packages' doors drive: the decision streams, shed lists and
lease tables equal JAX's.  The fleet trace document and the attribution
equal JAX's on the same tracer events.  A real port fabric then holds
the door's invariants (conservation under shedding, tokens through a
failover), and one ``doorproc`` child process per arm runs under a
timeout: one fenced off the store after a failover, one killed with
SIGKILL and reaped."""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import time

import pytest
import torch

from flashmoe_tpu.fabric import frontdoor as jfd
from flashmoe_tpu.fabric import leasestore as jls
from flashmoe_tpu.profiler import export as jexport
from flashmoe_tpu.runtime import controller as jctl
from flashmoe_tpu.serving import engine as jeng
from flashmoe_tpu.telemetry_plane import tracing as jtracing
from flashmoe_tpu.utils.telemetry import Metrics as JaxMetrics
from flashmoe_tpu_torch.fabric import FrontDoor, FrontDoorCluster, \
    ServingFabric, VirtualClock
from flashmoe_tpu_torch.fabric import frontdoor as tfd
from flashmoe_tpu_torch.fabric import leasestore as tls
from flashmoe_tpu_torch.models.transformer import init_params
from flashmoe_tpu_torch.profiler import export as texport
from flashmoe_tpu_torch.runtime import controller as tctl
from flashmoe_tpu_torch.serving import engine as teng
from flashmoe_tpu_torch.serving import loadgen as tload
from flashmoe_tpu_torch.telemetry_plane import tracing as ttracing
from flashmoe_tpu_torch.utils.telemetry import Metrics

from test_torch_profiler import _traced

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT_S = 60.0


class _StubEngine:
    """A replica whose requests take ``max_new_tokens`` steps once
    admitted, two slots a replica."""

    def __init__(self):
        self.queue, self.slots, self.outputs = [], [], {}
        self.tracer = None

    def _active(self):
        return list(self.slots)

    def pending(self):
        return bool(self.queue or self.slots)

    def step(self):
        for s in list(self.slots):
            s[1] -= 1
            if s[1] <= 0:
                self.slots.remove(s)
                self.outputs[s[0].rid] = list(s[0].prompt) + [0] * \
                    s[0].max_new_tokens
        while self.queue and len(self.slots) < 2:
            req = self.queue.pop(0)
            self.slots.append([req, req.max_new_tokens])


class _StubFabric:
    """What a door reads of a fabric, deterministic: replicas chosen by
    the shortest queue, lowest id first."""

    def __init__(self, metrics, n=2):
        self.metrics, self.vclock = metrics, None
        self.engines = [_StubEngine() for _ in range(n)]
        self.n_replicas, self.step_idx = n, 0
        self._killed, self._crashed, self._placement = set(), set(), {}
        self.handoff = type("H", (), {"transport": None})()
        self.serve = type("S", (), {"max_steps": 500})()

    def submit(self, req, arrival_step=0, *, session=None):
        i = min(range(self.n_replicas),
                key=lambda r: (len(self.engines[r].queue)
                               + len(self.engines[r].slots), r))
        self.engines[i].queue.append(req)
        self._placement[req.rid] = i
        return i

    def pending(self):
        return any(e.pending() for e in self.engines)

    def step(self):
        for e in self.engines:
            e.step()
        self.step_idx += 1

    def run(self, until=None):
        while self.pending():
            self.step()
        return {k: v for e in self.engines for k, v in e.outputs.items()}


def _flood(eng_mod, n=12, max_new=6):
    return [eng_mod.Request(rid=i, prompt=(1, 2, 3), max_new_tokens=max_new)
            for i in range(n)]


ARRIVALS = [0, 0, 0, 0, 1, 1, 2, 2, 3, 5, 8, 9]


def _door_run(fd_mod, ctl_mod, eng_mod, metrics_cls, **bo):
    mx = metrics_cls()
    fab = _StubFabric(mx)
    door = fd_mod.FrontDoor(fab, brownout=ctl_mod.BrownoutConfig(**bo))
    try:
        out = door.run(_flood(eng_mod), ARRIVALS)
        return (out, door.shed_rids, door.degraded_rids,
                door.brownout_snapshot(), mx.decisions)
    finally:
        door.close()


@pytest.mark.parametrize("bo", [
    dict(queue_high=2.0, queue_low=0.5, debounce_steps=1, cooldown_steps=2,
         episode_budget=2),
    dict(queue_high=1.5, queue_low=1.0, debounce_steps=2,
         cooldown_steps=1),
    dict(queue_high=2.0, queue_low=0.5, mode="degrade", degrade_max_new=2,
         debounce_steps=1, cooldown_steps=2)], ids=["shed", "slow", "degrade"])
def test_brownout_equals_jax(bo):
    got = _door_run(tfd, tctl, teng, Metrics, **bo)
    want = _door_run(jfd, jctl, jeng, JaxMetrics, **bo)
    assert got == want
    out, shed, degraded = got[:3]
    assert shed or degraded
    assert len(out) + len(shed) == len(ARRIVALS)   # conservation


def test_namespace_is_owned_at_the_door():
    msgs = []
    for fd_mod, eng_mod, metrics_cls in ((tfd, teng, Metrics),
                                         (jfd, jeng, JaxMetrics)):
        mx = metrics_cls()
        door = fd_mod.FrontDoor(_StubFabric(mx))
        try:
            req = _flood(eng_mod, 1)[0]
            door.submit(req, 0, session="alice")
            with pytest.raises(ValueError, match="already submitted") as e:
                door.submit(req, 1)
            msgs.append((str(e.value), door.sessions, mx.decisions))
        finally:
            door.close()
    assert msgs[0] == msgs[1]


def _cluster_run(fd_mod, ls_mod, eng_mod, metrics_cls, path):
    mx = metrics_cls()
    store = (None if path is None else
             ls_mod.LeaseStore(str(path), metrics_obj=mx, peer=0))
    cl = fd_mod.FrontDoorCluster(_StubFabric(mx), n_doors=3, n_shards=8,
                                 metrics_obj=mx, store=store)
    try:
        out = cl.run(_flood(eng_mod), ARRIVALS, fail_at=2, fail_peer=1)
        snap = cl.snapshot()
        snap["external_store"] = snap["external_store"] is not None
        errs = []
        for bad in (lambda: cl.fail_door(0), lambda: cl.fail_door(2),
                    lambda: cl.fail_door(7)):
            try:
                errs.append(bad())
            except (RuntimeError, ValueError) as e:
                errs.append(str(e))
        return out, snap, errs, [cl.owner_of(r) for r in range(12)], \
            mx.decisions
    finally:
        cl.close()


@pytest.mark.parametrize("external", [False, True])
def test_cluster_failover_equals_jax(tmp_path, external):
    got = _cluster_run(tfd, tls, teng, Metrics,
                       tmp_path / "t.bin" if external else None)
    want = _cluster_run(jfd, jls, jeng, JaxMetrics,
                        tmp_path / "j.bin" if external else None)
    assert got == want
    fo = [d for d in got[-1] if d["decision"] == "frontdoor.failover"]
    assert fo and fo[0]["from_peer"] == 1
    assert all(d["epoch"] >= 1 and d["to_peer"] != d["from_peer"]
               for d in fo)


def test_fleet_trace_and_attribution_equal_jax(tmp_path):
    """The same tracer events and placement: JAX's fleet document (its
    producer aside), written and validated, and JAX's attribution."""
    docs = []
    for tr_mod, exp in ((ttracing, texport), (jtracing, jexport)):
        tr = _traced(tr_mod)
        doc = exp.write_fleet_trace(tr, {0: 1, 1: 0},
                                    str(tmp_path / f"{exp.__name__}.json"),
                                    replicas=2)
        assert exp.validate_trace(doc) == []
        docs.append(doc)
    assert docs[0]["traceEvents"] == docs[1]["traceEvents"]
    assert any(e["ph"] == "s" for e in docs[0]["traceEvents"])
    assert texport.fleet_trace_events(_traced(ttracing), {}) == \
        jexport.fleet_trace_events(_traced(jtracing), {})
    att = []
    for fd_mod, tr_mod, metrics_cls in ((tfd, ttracing, Metrics),
                                        (jfd, jtracing, JaxMetrics)):
        mx = metrics_cls()
        mx.decision("fabric.route", rid=1, replica=0, policy="jsq_spill")
        door = fd_mod.FrontDoor(_StubFabric(mx), tracer=_traced(tr_mod))
        att.append((door.attribution(), mx.decisions))
    assert att[0] == att[1]


def test_split_and_merge_traces():
    """The split keeps JAX's rid rule and remainder rule and merges back
    in arrival order; every request is drawn from its replica's seed."""
    splits = tload.split_requests(7, replicas=3, vocab=64, prompt_len=5,
                                  max_new=3, seed=11, arrival_every=2)
    assert [len(r) for r, _ in splits] == [3, 2, 2]
    assert [[q.rid for q in r] for r, _ in splits] == \
        [[0, 3, 6], [1, 4], [2, 5]]
    again = tload.split_requests(7, replicas=3, vocab=64, prompt_len=5,
                                 max_new=3, seed=11, arrival_every=2)
    assert [[q.prompt for q in r] for r, _ in splits] == \
        [[q.prompt for q in r] for r, _ in again]
    reqs, arrivals = tload.merge_traces(splits)
    assert arrivals == sorted(arrivals) and len(reqs) == 7
    assert sorted(q.rid for q in reqs) == list(range(7))
    with pytest.raises(ValueError, match="replicas=0"):
        tload.split_requests(1, replicas=0, vocab=8, prompt_len=2,
                             max_new=1, seed=0, arrival_every=1)


# ----------------------------------------------------------------------
# A real fabric behind the door
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def small():
    cfg = tload.tiny_config()
    params = init_params(torch.Generator().manual_seed(0), cfg,
                         device="cpu")
    serve = teng.ServeConfig(max_batch=2, page_size=8, num_pages=64,
                             max_pages_per_slot=4, ctx_bucket_pages=1,
                             prompt_bucket=8)
    reqs, arrivals = tload.build_requests(
        6, vocab=cfg.vocab_size, prompt_len=8, max_new=4, seed=0,
        arrival_every=1)
    base = teng.ServingEngine(params, cfg, serve,
                              metrics_obj=Metrics()).run(reqs, arrivals)
    return cfg, params, serve, reqs, arrivals, base


def test_real_fabric_cluster_failover_and_brownout(small, monkeypatch):
    """A door cluster fails over mid-trace on a real 2-replica fabric:
    tokens equal the single engine's and the fleet trace validates; a
    shedding door conserves every request."""
    cfg, params, serve, reqs, arrivals, base = small
    monkeypatch.setenv("FLASHMOE_MOCK_FABRIC", "2")
    mx = Metrics()
    fab = ServingFabric(params, cfg, serve, metrics_obj=mx,
                        vclock=VirtualClock())
    cl = FrontDoorCluster(fab, n_doors=2, n_shards=8, metrics_obj=mx)
    try:
        out = cl.run(reqs, arrivals, fail_at=2, fail_peer=0)
        assert cl.validate() == []
        assert texport.validate_trace(cl.fleet_trace_document()) == []
    finally:
        cl.close()
        fab.close()
    assert out == base
    flood, _ = tload.build_requests(10, vocab=cfg.vocab_size, prompt_len=8,
                                    max_new=6, seed=1, arrival_every=0)
    fab = ServingFabric(params, cfg, serve, metrics_obj=Metrics(),
                        vclock=VirtualClock())
    door = FrontDoor(fab, brownout=tctl.BrownoutConfig(
        queue_high=2.0, queue_low=0.5, debounce_steps=1,
        cooldown_steps=2, episode_budget=2))
    try:
        out = door.run(flood, [0, 0, 0, 0, 2, 2, 3, 3, 4, 5])
        assert door.validate() == []
        att = door.attribution()
    finally:
        door.close()
        fab.close()
    assert door.shed_rids and len(out) + len(door.shed_rids) == 10
    assert att and all(a["sum_ok"] for a in att.values())


# ----------------------------------------------------------------------
# The door as its own process
# ----------------------------------------------------------------------

def _child(store, peer, shard):
    return subprocess.Popen(
        [sys.executable, "-m", "flashmoe_tpu_torch.fabric.doorproc",
         "--store", str(store), "--peer", str(peer), "--telemetry",
         str(shard), "--iterations", "3000", "--interval", "0.02"],
        cwd=HERE, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def test_doorproc_child_is_fenced_and_a_killed_child_is_reaped(tmp_path):
    """Peer 1 in a child process sharing only the lease store: after the
    parent fails it over, the child re-asserts its shard at its stale
    epoch, the store refuses it and the child exits 3 with the refusal in
    its own telemetry shard.  A second child is killed with SIGKILL and
    reaped.  Both are waited on under a timeout."""
    store_path = tmp_path / "leases.bin"
    mx = Metrics()
    store = tls.LeaseStore(str(store_path), metrics_obj=mx, peer=0)
    cl = FrontDoorCluster(_StubFabric(mx), n_doors=2, n_shards=8,
                          metrics_obj=mx, store=store)
    fenced = _child(store_path, 1, tmp_path / "telemetry.door1.jsonl")
    doomed = _child(store_path, 0, tmp_path / "telemetry.door0.jsonl")
    try:
        deadline = time.monotonic() + CHILD_TIMEOUT_S
        while not {"door0", "door1"} <= set(store.beats()):
            assert time.monotonic() < deadline, "no child heartbeat"
            assert fenced.poll() is None and doomed.poll() is None, (
                fenced.poll(), doomed.poll())
            time.sleep(0.05)
        doomed.send_signal(signal.SIGKILL)
        assert doomed.wait(timeout=CHILD_TIMEOUT_S) == -signal.SIGKILL
        assert cl.fail_door(1) == 4
        assert fenced.wait(timeout=CHILD_TIMEOUT_S) == 3
    finally:
        for proc in (fenced, doomed):
            if proc.poll() is None:
                proc.kill()
            proc.wait(timeout=CHILD_TIMEOUT_S)
            proc.stdout.close()
            proc.stderr.close()
        cl.close()
    shard = [json.loads(line) for line in
             (tmp_path / "telemetry.door1.jsonl").read_text().splitlines()]
    fences = [r for r in shard if r.get("decision") == "frontdoor.fence"]
    assert len(fences) == 1 and fences[0]["refused"] and \
        fences[0]["peer"] == 1
    assert any(r.get("kind") == "doorproc_beat" for r in shard)
    assert all(ls.owner == 0 for ls in store.leases().values())
    assert dataclasses.astuple(store.leases()[1])[2] == 1
