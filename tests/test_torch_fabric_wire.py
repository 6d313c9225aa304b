"""PyTorch port: the fabric's wire and liveness planes
(``flashmoe_tpu_torch/fabric/{transport,leasestore,vclock}.py``) against
the JAX package's on the CPU.

The same numpy KV payloads go through both packages' frame code: the
frames' bytes, dtype names, shapes and per-page CRC32s equal JAX's, and
so do the packed TCP blobs (bfloat16 and float8 frames included, which
JAX carries through ``ml_dtypes``).  The transport's retry ladder under
each injected fault (corrupt, timeout, partition; on the in-process and
the localhost TCP wire) gives JAX's decision stream and result
accounting; the give-up arm raises JAX's error.  Every TCP wire here has
a receive deadline of its own and is closed in a ``finally``.  The lease
store writes JAX's file byte for byte under the same operations
(fencing, torn-write repair), and the heartbeat watchdog and the virtual
clock account as JAX's do."""

import dataclasses
import socket
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashmoe_tpu import chaos as jchaos
from flashmoe_tpu.fabric import handoff as jho
from flashmoe_tpu.fabric import leasestore as jls
from flashmoe_tpu.fabric import transport as jtr
from flashmoe_tpu.fabric import vclock as jvc
from flashmoe_tpu.utils.telemetry import Metrics as JaxMetrics
from flashmoe_tpu_torch import chaos as tchaos
from flashmoe_tpu_torch.fabric import handoff as tho
from flashmoe_tpu_torch.fabric import leasestore as tls
from flashmoe_tpu_torch.fabric import transport as ttr
from flashmoe_tpu_torch.fabric import vclock as tvc
from flashmoe_tpu_torch.utils.telemetry import Metrics

#: every socket in this file gives up after this long
RECV_TIMEOUT_S = 5.0


def _kv(seed=0, l=2, nkv=2, t=16, d=8):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((l, nkv, t, d)).astype(np.float32),
            rng.standard_normal((l, nkv, t, d)).astype(np.float32))


def _payloads(wire, seed=0):
    """(JAX's payload, the port's) of one KV run on ``wire``."""
    k, v = _kv(seed)
    return (jho.encode_kv_run(jnp.asarray(k), jnp.asarray(v), 8,
                              jho.wr.resolve(wire)),
            tho.encode_kv_run(torch.from_numpy(k), torch.from_numpy(v), 8,
                              tho.wr.resolve(wire)))


def _frame_view(frames):
    """Each frame as (bytes, dtype name, shape, CRCs)."""
    out = {}
    for field, fr in frames.items():
        out[field] = None if fr is None else (
            fr.buf, str(fr.dtype).removeprefix("torch.")
            if isinstance(fr.dtype, torch.dtype) else np.dtype(fr.dtype).name,
            tuple(fr.shape), tuple(fr.page_crcs))
    return out


@pytest.mark.parametrize("wire", [None, "bf16", "e4m3", "e5m2"])
def test_frames_and_packed_blob_equal_jax(wire):
    jp, tp = _payloads(wire)
    jf, tf = jtr.encode_frames(jp), ttr.encode_frames(tp)
    assert _frame_view(tf) == _frame_view(jf)
    assert ttr._pack_frames(tf) == jtr._pack_frames(jf)
    assert ttr.verify_frames(tf) == jtr.verify_frames(jf) == []
    # the receiver's rebuild is the sent payload, bit for bit
    back = ttr.decode_frames(tf, tp)
    for a, b in ((back.k, tp.k), (back.v, tp.v),
                 (back.k_qscale, tp.k_qscale), (back.v_qscale, tp.v_qscale)):
        if b is None:
            assert a is None
        else:
            assert a.dtype == b.dtype and torch.equal(
                a.view(torch.uint8), b.view(torch.uint8))


def test_tampered_frame_is_named_by_its_pages():
    jp, tp = _payloads("e4m3", seed=3)
    jf, tf = jtr.encode_frames(jp), ttr.encode_frames(tp)
    for field in ("k", "v_qscale"):
        jf2, tf2 = dict(jf), dict(tf)
        jf2[field] = jtr._tampered(jf[field])
        tf2[field] = ttr._tampered(tf[field])
        assert tf2[field].buf == jf2[field].buf
        assert ttr.verify_frames(tf2) == jtr.verify_frames(jf2) != []


def _plan(mod, fault, **kw):
    return mod.FaultPlan(fault, **kw)


def _ladder(tr_mod, chaos_mod, payloads, metrics, *, wire, fault,
            once=True, tamper=None):
    """Two transfers through one transport with ``fault`` armed on the
    first: each result's accounting, or the error that ended it."""
    plan = (None if fault is None else
            _plan(chaos_mod, fault, step=0, duration=1, once=once))
    t = tr_mod.HandoffTransport(metrics_obj=metrics, wire=wire, plan=plan,
                                tamper_fn=tamper)
    if t._wire is not None:
        t._wire.recv_timeout_s = RECV_TIMEOUT_S
    log = []
    try:
        for i, p in enumerate(payloads):
            try:
                r = t.send(p, modeled_ms=0.5, rid=i, replica=i % 2)
            except tr_mod.HandoffTransportError as e:
                log.append(("error", str(e)))
                continue
            log.append((r.attempts, r.retries, r.corrupt_pages, r.timeouts,
                        round(r.retry_ms, 9)))
        snap = t.snapshot()
        snap.pop("wire_drops")
        log.append(snap)
    finally:
        t.close()
    return log


@pytest.mark.parametrize("wire", ["inproc", "tcp"])
@pytest.mark.parametrize("fault,once", [
    (None, True), ("handoff_corrupt", True), ("handoff_timeout", True),
    ("net_partition", True), ("handoff_corrupt", False)])
def test_retry_ladder_equals_jax(wire, fault, once):
    jm, tm = JaxMetrics(), Metrics()
    jp = [_payloads("e4m3", seed=s)[0] for s in (0, 1)]
    tp = [_payloads("e4m3", seed=s)[1] for s in (0, 1)]
    want = _ladder(jtr, jchaos, jp, jm, wire=wire, fault=fault, once=once)
    got = _ladder(ttr, tchaos, tp, tm, wire=wire, fault=fault, once=once)
    assert got == want
    assert tm.decisions == jm.decisions
    if fault == "net_partition" and wire == "tcp":
        parts = [d for d in tm.decisions
                 if d["decision"] == "fabric.partition"]
        assert parts and parts[0]["dropped_bytes"] > 0


def test_tamper_seam_and_constructor_errors_equal_jax():
    jm, tm = JaxMetrics(), Metrics()
    tamper = (lambda index, attempt: index == 1 and attempt <= 2)
    jp = [_payloads(None, seed=s)[0] for s in (0, 1)]
    tp = [_payloads(None, seed=s)[1] for s in (0, 1)]
    assert _ladder(ttr, tchaos, tp, tm, wire="inproc", fault=None,
                   tamper=tamper) == \
        _ladder(jtr, jchaos, jp, jm, wire="inproc", fault=None,
                tamper=tamper)
    assert tm.decisions == jm.decisions
    msgs = []
    for tr_mod, chaos_mod in ((jtr, jchaos), (ttr, tchaos)):
        got = []
        for kw in (dict(plan=chaos_mod.FaultPlan("nan_grad")),
                   dict(max_retries=-1), dict(wire="carrier_pigeon")):
            with pytest.raises(ValueError) as e:
                tr_mod.HandoffTransport(**kw)
            got.append(str(e.value))
        msgs.append(got)
    assert msgs[0] == msgs[1]
    assert [ttr.wire_overhead_ms(b, w) for b in (0, 4096) for w in
            ttr.WIRE_MODES] == [jtr.wire_overhead_ms(b, w) for b in
                                (0, 4096) for w in jtr.WIRE_MODES]


def test_tcp_wire_drops_a_partial_transfer_and_heals():
    """A transfer cut mid-stream really crosses the socket and the
    receiver discards it; the next one arrives whole."""
    wire = ttr._TcpWire(recv_timeout_s=RECV_TIMEOUT_S)
    try:
        frames = ttr.encode_frames(_payloads("bf16")[1])
        lost = wire.drop_mid_transfer(frames, fraction=0.3)
        assert lost > 0
        got = wire.roundtrip(frames)
        assert _frame_view(got) == _frame_view(frames)
        deadline = time.monotonic() + RECV_TIMEOUT_S
        while wire.partial_drops < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert wire.snapshot()["partial_drops"] == 1
    finally:
        wire.close()
    assert not wire._thread.is_alive()


def test_tcp_wire_real_timeout_and_reset_retry():
    """A receiver that hands nothing back inside the deadline is a real
    timeout; a dead connection is a real reset; both retry to a whole
    payload."""
    mx = Metrics()
    t = ttr.HandoffTransport(metrics_obj=mx, wire="tcp", timeout_ms=1.0)
    t._wire.recv_timeout_s = 0.3
    p = _payloads("e4m3")[1]
    real = t._wire._rx
    try:
        # the first attempt's delivery is swallowed: a real recv timeout
        swallow = {"n": 1}

        class Swallow:
            def put(self, item):
                if swallow["n"]:
                    swallow["n"] -= 1
                    return
                real.put(item)

            def get(self, timeout=None):
                return real.get(timeout=timeout)

        t._wire._rx = Swallow()
        r = t.send(p, modeled_ms=0.5, rid=0)
        assert (r.attempts, r.timeouts) == (2, 1)
        t._wire._rx = real
        # a connection the peer closed under us: a real reset
        t._wire._sock.close()
        t._wire._sock = socket.socket()
        r = t.send(p, modeled_ms=0.5, rid=1)
        assert r.retries == 1 and t.reset_total == 1
        assert torch.equal(r.payload.k.view(torch.uint8),
                           p.k.view(torch.uint8))
        reasons = [d["reason"] for d in mx.decisions
                   if d["decision"] == "fabric.handoff_retry"]
        assert reasons == ["timeout", "reset"]
    finally:
        t.close()


# ----------------------------------------------------------------------
# The lease store
# ----------------------------------------------------------------------

def _store_script(mod, path, metrics):
    """One run of lease operations: seeding, fenced writes, a torn tail
    skipped on read and repaired on write, heartbeats."""
    s = mod.LeaseStore(str(path), n_shards=4, metrics_obj=metrics, peer=7)
    log = []

    def do(fn, *a, **kw):
        try:
            got = fn(*a, **kw)
            log.append(("ok", dataclasses.astuple(got)
                        if dataclasses.is_dataclass(got) else got))
        except mod.LeaseStoreError as e:
            log.append((type(e).__name__, str(e)))

    do(s.init_leases, {i: i % 2 for i in range(4)})
    do(s.init_leases, {0: 1, 9: 0})
    do(s.write_lease, 2, 1, 1, reason="failover")
    do(s.write_lease, 2, 0, 1, reason="zombie")
    do(s.write_lease, 2, 0, 0)
    log.append(sorted((k, dataclasses.astuple(v))
                      for k, v in s.leases().items()))
    do(s.heartbeat, 3, 1, ts_ms=1.5, phase="admit", step=0)
    do(s.heartbeat, 3, 1, ts_ms=2.0)
    do(s.heartbeat, "door1", 5, phase="alive")
    do(s.write_lease, 1, 0, 4)
    log.append(s.tear_last_record(keep_fraction=0.4))
    log.append(s.read())
    do(s.write_lease, 1, 0, 2, reason="after_tear")
    log.append(s.snapshot() | {"path": None})
    with open(path, "rb") as fh:
        log.append(fh.read())
    return log


def test_lease_store_equals_jax(tmp_path):
    jm, tm = JaxMetrics(), Metrics()
    want = _store_script(jls, tmp_path / "jax.bin", jm)
    got = _store_script(tls, tmp_path / "port.bin", tm)
    assert got == want
    assert tm.decisions == jm.decisions
    names = [d["decision"] for d in tm.decisions]
    assert names.count("frontdoor.fence") == 2
    assert names.count("frontdoor.lease_repair") == 1
    for mod in (jls, tls):
        with pytest.raises(ValueError, match="n_shards"):
            mod.LeaseStore(str(tmp_path / "x.bin"), n_shards=0)


def _watch_script(mod, path, metrics):
    """Heartbeats through a publisher, a slow-but-alive replica, a hung
    one and an idle one, under the watchdog."""
    store = mod.LeaseStore(str(path), metrics_obj=metrics)
    clock = iter(range(1000))
    pubs = [mod.HeartbeatPublisher(store, r, clock=lambda: next(clock),
                                   step_fn=lambda r=r: 10 + r)
            for r in range(3)]
    dog = mod.HeartbeatWatchdog(store, misses_to_stall=2, tick_ms=0.5,
                                metrics_obj=metrics)
    log = []
    for step in range(8):
        pubs[0]("decode")                    # beats every step
        if step % 2 == 0:
            pubs[1]("sample")                # beats every other step
        if step < 3:
            pubs[2]("admit")                 # hangs after step 2
        log.append(dog.observe(step, [0, 1, 2, 3],
                               pending=lambda r: r != 3))
    log.append(dog.snapshot())
    log.append(store.beats())
    return log


def test_heartbeat_watchdog_equals_jax(tmp_path):
    jm, tm = JaxMetrics(), Metrics()
    want = _watch_script(jls, tmp_path / "j.bin", jm)
    got = _watch_script(tls, tmp_path / "t.bin", tm)
    assert got == want
    assert tm.decisions == jm.decisions
    # only the hung replica stalls: the slow one and the idle one never
    stalls = [r for r in got[:8] if r]
    assert stalls and all(r == [2] for r in stalls)
    for mod in (jls, tls):
        with pytest.raises(ValueError, match="misses_to_stall"):
            mod.HeartbeatConfig(misses_to_stall=0)


# ----------------------------------------------------------------------
# The virtual clock
# ----------------------------------------------------------------------

def _clock_script(mod, chaos_mod, fault):
    plan = (None if fault is None else chaos_mod.FaultPlan(
        fault, step=1, duration=3, latency_ms=7.0, jitter_ms=9.0, seed=5))
    vc = mod.VirtualClock(tick_ms=2.0, lanes=1, plan=plan)
    log = []
    for step in range(4):
        for lane in (0, 2):
            vc.use_lane(lane)
            for extra in (0.0, 0.25 * step):
                log.append(vc.on_handoff(1.5, rid=step, replica=lane,
                                         extra_ms=extra))
            log.append((vc.complete_step(), vc(), vc.now_ms(),
                        vc.active_lane))
    log += [vc.hidden_fraction(), vc.snapshot(), vc.transfers]
    return log


@pytest.mark.parametrize("fault", [None, "dcn_latency", "dcn_jitter"])
def test_virtual_clock_accounting_equals_jax(fault):
    assert _clock_script(tvc, tchaos, fault) == \
        _clock_script(jvc, jchaos, fault)
    for mod, chaos_mod in ((jvc, jchaos), (tvc, tchaos)):
        with pytest.raises(ValueError, match="only injects"):
            mod.VirtualClock(plan=chaos_mod.FaultPlan("nan_grad"))
        assert mod.VirtualClock().hidden_fraction() is None
