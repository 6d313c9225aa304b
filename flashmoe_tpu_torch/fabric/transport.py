"""Failable KV-handoff transport: real wire semantics, in-process.

Counterpart of ``flashmoe_tpu/fabric/transport.py``.  The transport seam
behind :class:`~flashmoe_tpu_torch.fabric.handoff.KVHandoff` that makes the
handoff failable, with the failure semantics a real inter-host transport
has:

* **wire frames** — every transfer serializes each payload field
  (K/V pages plus their ``_qscale`` sidecars) to raw bytes and attaches
  a per-page CRC32 checksum sidecar
  (:func:`flashmoe_tpu_torch.utils.integrity.crc32_pages` — the same CRC32
  helper the checkpoint manifests use), riding the frame the way the
  quant scales ride the page payload;
* **receiver verification** — the receive side recomputes every page
  checksum before the bytes are allowed anywhere near the paged cache;
  a mismatch is a ``fabric.handoff_corrupt`` decision naming the bad
  pages, never a silent garbage decode;
* **timeout + bounded retry** — a failed attempt (corrupt or timed
  out) retries after a capped exponential backoff, at most
  ``max_retries`` times, each retry recorded as a
  ``fabric.handoff_retry`` decision; the wasted wire time (the garbage
  attempt's modeled DCN cost, or the timeout window) plus the backoff
  is returned as ``retry_ms`` so the caller prices it through the
  virtual clock — retries are *experienced* by the request's TTFT,
  reconciled per transfer by the ``fabric.handoff_drift`` verdicts;
* **deterministic chaos** — an armed
  :class:`~flashmoe_tpu_torch.chaos.FaultPlan` with fault
  ``handoff_corrupt`` / ``handoff_timeout`` perturbs the first attempt
  of every transfer in ``[plan.step, plan.step + plan.duration)``
  (TRANSFER index, like the DCN faults).  With ``plan.once`` (default)
  the retry is clean — exactly one retry per faulted transfer; with
  ``once=False`` every attempt fails and the bounded budget surfaces
  as a :class:`HandoffTransportError` (the give-up arm).

* **a real socket wire** — ``wire="tcp"`` moves every transfer across
  a localhost TCP connection (stdlib :mod:`socket`, length-prefixed
  frame protocol, a receiver thread that rebuilds frames FROM THE
  STREAM): connection reset, partial read, and recv timeout become
  *real* kernel failure modes that feed the same retry ladder as the
  injected faults, and the ``net_partition`` chaos fault drops a
  transfer mid-stream for real (partial bytes cross, the receiver
  discards them, the sender reconnects on retry).  The default
  ``wire="inproc"`` is a byte copy in the process: zero threads, zero
  sockets.

A frame carries what JAX's carries for the same payload: the same bytes,
dtype name, shape and per-page CRC32s.  numpy has no bfloat16 or float8
(JAX takes those through ``ml_dtypes``), so a tensor crosses the host as
its raw bytes (``Tensor.view(torch.uint8)``) and is rebuilt on the
sending payload's device by viewing the received bytes as the named
torch dtype.

The byte path is exact: with no fault armed, ``send`` returns a
payload rebuilt from the received bytes that is bit-identical to the
sent one, so the fabric's token-bit-equality gates hold with the
transport on — on either wire.
"""

from __future__ import annotations

import dataclasses
import json
import queue
import socket
import struct
import threading

import torch

from flashmoe_tpu_torch.fabric.handoff import KVPagePayload, dtype_name
from flashmoe_tpu_torch.utils.integrity import crc32_pages
from flashmoe_tpu_torch.utils.telemetry import metrics as _global_metrics

#: serving faults the transport knows how to inject (chaos matrix rows)
TRANSPORT_FAULTS = ("handoff_corrupt", "handoff_timeout",
                    "net_partition")

#: transport wire modes: in-process byte copy (default) vs a real
#: localhost TCP socket pair
WIRE_MODES = ("inproc", "tcp")

#: modeled per-transfer cost of the tcp leg over inproc (connect
#: amortization + length-prefixed framing + syscall pair) — the
#: deterministic basis of the ``fabric_wire_overhead_ms`` sentry row
TCP_OVERHEAD_BASE_MS = 0.05
TCP_OVERHEAD_PER_KIB_MS = 0.0002


def wire_overhead_ms(payload_bytes: int, wire: str = "inproc") -> float:
    """Modeled extra latency of carrying one transfer on ``wire``
    versus the in-process copy (deterministic, for the perf sentry)."""
    if wire != "tcp":
        return 0.0
    return TCP_OVERHEAD_BASE_MS + (
        float(payload_bytes) / 1024.0) * TCP_OVERHEAD_PER_KIB_MS

#: the bytes a chaos corruption stamps mid-page (the checkpoint
#: tamper idiom — ``chaos._corrupt_latest_checkpoint`` flips the same)
_TAMPER = b"\xde\xad\xbe\xef"


class HandoffTransportError(RuntimeError):
    """A transfer exhausted its retry budget — the handoff failed for
    real and the caller must treat the prefill as undelivered."""


@dataclasses.dataclass(frozen=True)
class WireFrame:
    """One payload field on the wire: raw bytes + enough metadata to
    rebuild the array + the per-page CRC32 sidecar."""

    buf: bytes
    dtype: object                  # torch.dtype
    shape: tuple
    page_crcs: tuple

    def verify(self) -> list:
        """Indices of pages whose received bytes fail their checksum."""
        got = crc32_pages(self.buf, len(self.page_crcs))
        return [i for i, (w, g) in enumerate(zip(self.page_crcs, got))
                if w != g]


def tensor_bytes(t) -> bytes:
    """A tensor's raw bytes in C order (numpy's ``tobytes``), copied to
    the host: any dtype, bfloat16 and float8 included."""
    t = t.detach().contiguous()
    if t.numel() == 0:
        return b""
    return t.reshape(-1).view(torch.uint8).cpu().numpy().tobytes()


def _to_frame(arr, pages: int) -> WireFrame | None:
    if arr is None:
        return None
    buf = tensor_bytes(arr)
    return WireFrame(buf, arr.dtype, tuple(arr.shape),
                     crc32_pages(buf, pages))


def _from_frame(frame: WireFrame | None, device):
    if frame is None:
        return None
    if not frame.buf:
        return torch.empty(frame.shape, dtype=frame.dtype, device=device)
    raw = torch.frombuffer(bytearray(frame.buf), dtype=torch.uint8)
    return raw.view(frame.dtype).reshape(frame.shape).to(device)


def encode_frames(payload: KVPagePayload) -> dict:
    """Serialize one payload into wire frames, one per field, each with
    its per-page checksum sidecar."""
    n = max(1, payload.pages)
    return {
        "k": _to_frame(payload.k, n),
        "v": _to_frame(payload.v, n),
        "k_qscale": _to_frame(payload.k_qscale, n),
        "v_qscale": _to_frame(payload.v_qscale, n),
    }


def verify_frames(frames: dict) -> list:
    """Every ``(field, page)`` whose received bytes fail the sidecar
    checksum (empty = the transfer verified clean)."""
    bad = []
    for field, frame in frames.items():
        if frame is None:
            continue
        bad.extend((field, p) for p in frame.verify())
    return bad


def decode_frames(frames: dict, payload: KVPagePayload) -> KVPagePayload:
    """Rebuild the payload FROM THE RECEIVED BYTES (not the sender's
    arrays) — the wire is real: what the decode pool caches is what
    crossed, bit-identical only because the transfer verified.  The
    tensors land on the device of ``payload``'s."""
    dev = payload.k.device
    return dataclasses.replace(
        payload,
        k=_from_frame(frames["k"], dev), v=_from_frame(frames["v"], dev),
        k_qscale=_from_frame(frames["k_qscale"], dev),
        v_qscale=_from_frame(frames["v_qscale"], dev))


def _tampered(frame: WireFrame) -> WireFrame:
    """Corrupt one frame's bytes mid-buffer (checksums kept — the
    RECEIVER must notice, that is the whole point)."""
    buf = frame.buf
    if not buf:
        return frame
    mid = max(0, len(buf) // 2 - len(_TAMPER))
    out = buf[:mid] + _TAMPER[:len(buf) - mid] + buf[mid + len(_TAMPER):]
    return dataclasses.replace(frame, buf=out[:len(buf)])


_LEN = struct.Struct("<I")
_WIRE_FIELDS = ("k", "v", "k_qscale", "v_qscale")


class _WireReset(OSError):
    """The kernel socket failed mid-attempt (reset / broken pipe /
    refused) — the attempt's bytes are gone; retry on a fresh
    connection."""


class _WireTimeout(OSError):
    """The receiver produced nothing inside the recv deadline."""


class _PartialTransfer(Exception):
    """The stream ended mid-transfer — the receiver drops the bytes."""


def _dtype_of(name: str):
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"wire frame names an unknown dtype {name!r}")
    return dt


def _pack_frames(frames: dict) -> bytes:
    """Length-prefixed wire encoding of one transfer: a JSON header
    (field order, dtype, shape, per-page CRC sidecar, byte counts)
    followed by the raw frame buffers."""
    header, bufs = [], []
    for field in _WIRE_FIELDS:
        fr = frames.get(field)
        if fr is None:
            header.append(None)
            continue
        header.append({"field": field,
                       "dtype": dtype_name(fr.dtype),
                       "shape": list(fr.shape),
                       "page_crcs": list(fr.page_crcs),
                       "nbytes": len(fr.buf)})
        bufs.append(fr.buf)
    hjson = json.dumps(header).encode()
    return _LEN.pack(len(hjson)) + hjson + b"".join(bufs)


class _TcpWire:
    """The localhost TCP leg: one server socket, a receiver thread
    that rebuilds :class:`WireFrame` dicts from the byte stream, and a
    sender connection that reconnects after a reset.  Everything the
    receiver hands back came off the kernel socket — a transfer the
    stream truncates (``net_partition``, or a real peer death) is
    discarded at the first short read, never delivered."""

    def __init__(self, *, recv_timeout_s: float = 5.0):
        self.recv_timeout_s = float(recv_timeout_s)
        self._srv = socket.create_server(("127.0.0.1", 0))
        self._srv.settimeout(0.2)
        self.port = self._srv.getsockname()[1]
        self._rx: queue.Queue = queue.Queue()
        self._stop = False
        self._sock = None
        self.partial_drops = 0
        self._thread = threading.Thread(
            target=self._serve, name="flashmoe-kv-wire", daemon=True)
        self._thread.start()

    # ---- receiver thread ---------------------------------------------

    def _recv_exact(self, conn, n: int):
        chunks, got = [], 0
        while got < n:
            try:
                b = conn.recv(min(1 << 16, n - got))
            except socket.timeout:
                if self._stop:
                    return None
                continue
            except OSError:
                return None
            if not b:
                return None
            chunks.append(b)
            got += len(b)
        return b"".join(chunks)

    def _read_transfer(self, conn):
        """One transfer off the stream.  ``None`` = clean EOF before a
        transfer started; a short read mid-transfer raises
        :class:`_PartialTransfer` and the bytes are dropped."""
        raw = self._recv_exact(conn, _LEN.size)
        if raw is None:
            return None
        (hlen,) = _LEN.unpack(raw)
        hraw = self._recv_exact(conn, hlen)
        if hraw is None:
            raise _PartialTransfer
        frames = {f: None for f in _WIRE_FIELDS}
        for entry in json.loads(hraw.decode()):
            if entry is None:
                continue
            buf = self._recv_exact(conn, entry["nbytes"])
            if buf is None:
                raise _PartialTransfer
            frames[entry["field"]] = WireFrame(
                buf, _dtype_of(entry["dtype"]), tuple(entry["shape"]),
                tuple(entry["page_crcs"]))
        return frames

    def _serve(self):
        while not self._stop:
            try:
                conn, _addr = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            conn.settimeout(0.2)
            with conn:
                while not self._stop:
                    try:
                        frames = self._read_transfer(conn)
                    except _PartialTransfer:
                        self.partial_drops += 1
                        break
                    except Exception:
                        break
                    if frames is None:
                        break
                    self._rx.put(frames)

    # ---- sender side --------------------------------------------------

    def _connect(self):
        if self._sock is None:
            self._sock = socket.create_connection(
                ("127.0.0.1", self.port), timeout=self.recv_timeout_s)
        return self._sock

    def _reset(self):
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def roundtrip(self, frames: dict) -> dict:
        """One attempt: the transfer crosses the kernel socket and the
        RECEIVER's rebuild comes back.  Raises :class:`_WireReset` on a
        send-side socket failure, :class:`_WireTimeout` when nothing
        arrives inside the deadline."""
        blob = _pack_frames(frames)
        try:
            self._connect().sendall(blob)
        except OSError as e:
            self._reset()
            raise _WireReset(str(e)) from e
        try:
            return self._rx.get(timeout=self.recv_timeout_s)
        except queue.Empty:
            self._reset()
            raise _WireTimeout(
                f"no transfer received within "
                f"{self.recv_timeout_s}s") from None

    def drop_mid_transfer(self, frames: dict,
                          fraction: float = 0.5) -> int:
        """``net_partition`` injection: push a partial transfer, then
        hard-close the connection.  The partial bytes REALLY cross the
        kernel socket and the receiver REALLY discards them at the
        short read — returns the bytes that never made it."""
        blob = _pack_frames(frames)
        cut = max(1, min(len(blob) - 1, int(len(blob) * fraction)))
        try:
            self._connect().sendall(blob[:cut])
        except OSError:
            pass
        self._reset()
        return len(blob) - cut

    def close(self):
        self._stop = True
        self._reset()
        try:
            self._srv.close()
        except OSError:
            pass
        self._thread.join(timeout=2.0)

    def snapshot(self) -> dict:
        return {"port": self.port,
                "partial_drops": self.partial_drops,
                "recv_timeout_s": self.recv_timeout_s}


@dataclasses.dataclass(frozen=True)
class TransferResult:
    """What one :meth:`HandoffTransport.send` experienced."""

    payload: KVPagePayload         # rebuilt from the received bytes
    attempts: int
    retries: int
    corrupt_pages: int
    timeouts: int
    retry_ms: float                # wasted wire time + backoff, priced
                                   # through the vclock by the caller


class HandoffTransport:
    """In-process transport with wire failure semantics.

    ``max_retries``: retry budget per transfer (attempts beyond
    ``1 + max_retries`` raise :class:`HandoffTransportError`).
    ``timeout_ms``: the per-attempt deadline — an injected
    ``handoff_timeout`` attempt stalls for exactly this long before it
    is abandoned.  ``backoff_ms`` / ``backoff_cap_ms``: capped
    exponential backoff between attempts (``min(cap, base * 2**(n-1))``
    after the n-th failure).  ``plan``: an armed
    :class:`~flashmoe_tpu_torch.chaos.FaultPlan` whose fault is one of
    :data:`TRANSPORT_FAULTS`.  ``tamper_fn``: test seam — a callable
    ``(transfer_index, attempt) -> bool`` that forces corruption on a
    given attempt (the CRC tamper drill).  ``wire``: one of
    :data:`WIRE_MODES` — ``"tcp"`` carries every transfer over a real
    localhost socket (close the transport when done)."""

    def __init__(self, *, metrics_obj=None, max_retries: int = 2,
                 timeout_ms: float = 50.0, backoff_ms: float = 5.0,
                 backoff_cap_ms: float = 40.0, plan=None,
                 tamper_fn=None, wire: str = "inproc"):
        if plan is not None and plan.fault not in TRANSPORT_FAULTS:
            raise ValueError(
                f"HandoffTransport only injects {TRANSPORT_FAULTS}, "
                f"got plan fault {plan.fault!r}")
        if max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, "
                             f"got {max_retries}")
        if wire not in WIRE_MODES:
            raise ValueError(f"wire must be one of {WIRE_MODES}, "
                             f"got {wire!r}")
        self.metrics = (metrics_obj if metrics_obj is not None
                        else _global_metrics)
        self.max_retries = int(max_retries)
        self.timeout_ms = float(timeout_ms)
        self.backoff_ms = float(backoff_ms)
        self.backoff_cap_ms = float(backoff_cap_ms)
        self.plan = plan
        self.tamper_fn = tamper_fn
        self.wire = wire
        self._wire = _TcpWire() if wire == "tcp" else None
        self.transfers = 0
        self.retries_total = 0
        self.corrupt_total = 0
        self.timeout_total = 0
        self.partition_total = 0
        self.reset_total = 0
        self.retry_ms_total = 0.0

    # ---- chaos --------------------------------------------------------

    def _fault(self, index: int, attempt: int) -> str | None:
        """Which fault (if any) hits this attempt.  Chaos fires on the
        first attempt of every transfer in the plan window; with
        ``plan.once`` (default) the retry is clean, else every attempt
        fails until the budget gives up."""
        if self.tamper_fn is not None \
                and self.tamper_fn(index, attempt):
            return "handoff_corrupt"
        p = self.plan
        if p is None:
            return None
        if not (p.step <= index < p.step + p.duration):
            return None
        if attempt > 1 and p.once:
            return None
        return p.fault

    def _backoff(self, failures: int) -> float:
        return min(self.backoff_cap_ms,
                   self.backoff_ms * (2.0 ** (failures - 1)))

    # ---- the wire -----------------------------------------------------

    def _transmit(self, frames: dict, *, tamper: bool) -> dict:
        """One attempt: the frames cross the wire — an in-process copy
        by default, the kernel socket under ``wire="tcp"``.  A tampered
        attempt corrupts the largest frame's bytes BEFORE they ship —
        the sidecar checksums ride untouched (in the tcp header), so
        the receiver's verify catches it."""
        tx = frames
        if tamper:
            victim, size = None, -1
            for field, frame in frames.items():
                if frame is not None and len(frame.buf) > size:
                    victim, size = field, len(frame.buf)
            tx = dict(frames)
            if victim is not None:
                tx[victim] = _tampered(tx[victim])
        if self._wire is None:
            return tx
        return self._wire.roundtrip(tx)

    def send(self, payload: KVPagePayload, *, modeled_ms: float = 0.0,
             rid=None, replica: int = 0) -> TransferResult:
        """Move one payload across the wire with verify + retry.
        Returns the payload rebuilt from the received (verified) bytes
        plus the transfer's failure accounting."""
        frames = encode_frames(payload)
        index = self.transfers
        self.transfers += 1
        attempts = 0
        retry_ms = 0.0
        corrupt_pages = 0
        timeouts = 0
        rx = frames
        while True:
            attempts += 1
            fault = self._fault(index, attempts)
            if fault == "handoff_timeout":
                # the attempt never completes: pay the full deadline,
                # back off, retransmit
                timeouts += 1
                self.timeout_total += 1
                back = self._backoff(attempts)
                retry_ms += self.timeout_ms + back
                self.metrics.count("fabric.handoff_retries")
                self.metrics.decision(
                    "fabric.handoff_retry", rid=rid,
                    replica=int(replica), transfer=index,
                    attempt=attempts, reason="timeout",
                    wasted_ms=round(self.timeout_ms, 6),
                    backoff_ms=round(back, 6),
                    budget_left=self.max_retries - (attempts - 1) - 1)
                self._check_budget(attempts, index, rid, replica,
                                   "timeout")
                continue
            if fault == "net_partition":
                # the wire drops mid-transfer: on tcp, partial bytes
                # REALLY cross and the receiver REALLY discards them;
                # inproc models the same drop.  Either way the
                # attempt's modeled wire time was wasted.
                dropped = (self._wire.drop_mid_transfer(frames)
                           if self._wire is not None else None)
                self.partition_total += 1
                back = self._backoff(attempts)
                retry_ms += float(modeled_ms) + back
                self.metrics.count("fabric.partitions")
                self.metrics.decision(
                    "fabric.partition", rid=rid, replica=int(replica),
                    transfer=index, attempt=attempts, wire=self.wire,
                    dropped_bytes=dropped, injected=True)
                self.metrics.count("fabric.handoff_retries")
                self.metrics.decision(
                    "fabric.handoff_retry", rid=rid,
                    replica=int(replica), transfer=index,
                    attempt=attempts, reason="reset",
                    wasted_ms=round(float(modeled_ms), 6),
                    backoff_ms=round(back, 6),
                    budget_left=self.max_retries - (attempts - 1) - 1)
                self._check_budget(attempts, index, rid, replica,
                                   "reset")
                continue
            try:
                rx = self._transmit(
                    frames, tamper=(fault == "handoff_corrupt"))
            except _WireReset as e:
                # a REAL kernel-socket failure (connection reset,
                # broken pipe, partial write) — the same ladder as the
                # injected partition
                self.reset_total += 1
                back = self._backoff(attempts)
                retry_ms += float(modeled_ms) + back
                self.metrics.count("fabric.partitions")
                self.metrics.decision(
                    "fabric.partition", rid=rid, replica=int(replica),
                    transfer=index, attempt=attempts, wire=self.wire,
                    dropped_bytes=None, injected=False,
                    error=str(e)[:80])
                self.metrics.count("fabric.handoff_retries")
                self.metrics.decision(
                    "fabric.handoff_retry", rid=rid,
                    replica=int(replica), transfer=index,
                    attempt=attempts, reason="reset",
                    wasted_ms=round(float(modeled_ms), 6),
                    backoff_ms=round(back, 6),
                    budget_left=self.max_retries - (attempts - 1) - 1)
                self._check_budget(attempts, index, rid, replica,
                                   "reset")
                continue
            except _WireTimeout:
                # a REAL recv deadline: the receiver produced nothing
                timeouts += 1
                self.timeout_total += 1
                back = self._backoff(attempts)
                retry_ms += self.timeout_ms + back
                self.metrics.count("fabric.handoff_retries")
                self.metrics.decision(
                    "fabric.handoff_retry", rid=rid,
                    replica=int(replica), transfer=index,
                    attempt=attempts, reason="timeout",
                    wasted_ms=round(self.timeout_ms, 6),
                    backoff_ms=round(back, 6),
                    budget_left=self.max_retries - (attempts - 1) - 1)
                self._check_budget(attempts, index, rid, replica,
                                   "timeout")
                continue
            bad = verify_frames(rx)
            if bad:
                # garbage crossed the wire: the bytes were paid for,
                # the checksum refused them at the receiver
                corrupt_pages += len(bad)
                self.corrupt_total += len(bad)
                self.metrics.count("fabric.handoff_corrupts")
                self.metrics.decision(
                    "fabric.handoff_corrupt", rid=rid,
                    replica=int(replica), transfer=index,
                    attempt=attempts, bad_pages=bad[:4],
                    bad_page_count=len(bad))
                back = self._backoff(attempts)
                retry_ms += float(modeled_ms) + back
                self.metrics.count("fabric.handoff_retries")
                self.metrics.decision(
                    "fabric.handoff_retry", rid=rid,
                    replica=int(replica), transfer=index,
                    attempt=attempts, reason="corrupt",
                    wasted_ms=round(float(modeled_ms), 6),
                    backoff_ms=round(back, 6),
                    budget_left=self.max_retries - (attempts - 1) - 1)
                self._check_budget(attempts, index, rid, replica,
                                   "corrupt")
                continue
            break
        retries = attempts - 1
        self.retries_total += retries
        self.retry_ms_total += retry_ms
        if retry_ms:
            self.metrics.sketch("fabric.handoff_retry_ms", retry_ms)
        return TransferResult(
            payload=decode_frames(rx, payload), attempts=attempts,
            retries=retries, corrupt_pages=corrupt_pages,
            timeouts=timeouts, retry_ms=retry_ms)

    def _check_budget(self, attempts: int, index: int, rid, replica,
                      reason: str) -> None:
        if attempts >= 1 + self.max_retries:
            raise HandoffTransportError(
                f"KV handoff transfer {index} (rid={rid}, replica="
                f"{replica}) failed after {attempts} attempts "
                f"({reason}); retry budget max_retries="
                f"{self.max_retries} exhausted")

    def close(self) -> None:
        """Tear down the wire (tcp: close sockets, join the receiver
        thread).  Safe to call twice; a no-op for ``inproc``."""
        if self._wire is not None:
            self._wire.close()
            self._wire = None

    def snapshot(self) -> dict:
        """Live ``/vars`` view of the transport."""
        return {
            "transfers": self.transfers,
            "retries_total": self.retries_total,
            "corrupt_total": self.corrupt_total,
            "timeout_total": self.timeout_total,
            "partition_total": self.partition_total,
            "reset_total": self.reset_total,
            "retry_ms_total": round(self.retry_ms_total, 6),
            "max_retries": self.max_retries,
            "timeout_ms": self.timeout_ms,
            "wire": self.wire,
            "wire_drops": (self._wire.partial_drops
                           if self._wire is not None else 0),
            "fault": (self.plan.fault if self.plan is not None
                      else None),
        }
