"""KV-page handoff: prefill-pool -> decode-pool page streaming.

Counterpart of ``flashmoe_tpu/fabric/handoff.py``.  In a disaggregated
fabric the prefill pool computes a prompt's KV run and the decode pool
owns the paged cache the tokens decode against; the run crosses as whole
pages.  This module is that boundary:

* **codec**: :func:`encode_kv_run` / :func:`decode_kv_run` reuse the
  per-hop wire codec (:mod:`flashmoe_tpu_torch.ops.wire`, plain torch as
  JAX's is plain XLA) over page payloads: each (layer, page) block
  quantizes as one wire row, so an fp8 wire's f32 scales ride a
  ``_qscale`` sidecar with one entry per page.  ``wire=None`` is the
  exact path: the tensors pass through untouched, on the card, with no
  host copy, which is what keeps the fabric's streams bit-equal to the
  single-pool engine's;
* **pricing**: every handoff is priced through
  :func:`flashmoe_tpu_torch.planner.model.kv_handoff_ms` and recorded as
  a ``fabric.handoff`` decision carrying the modeled DCN cost and
  whether it hides under the decode pool's per-step objective;
* **streamer**: :class:`KVHandoff` is the engine-facing seam, the
  ``prefill_fn`` a decode replica's
  :class:`~flashmoe_tpu_torch.serving.engine.ServingEngine` calls at
  admission: the prefill runs "in the prefill pool" (the engine's own
  :func:`~flashmoe_tpu_torch.serving.engine._prefill_padded`, so the
  same kernels) and only pages cross.
"""

from __future__ import annotations

import dataclasses

import torch

from flashmoe_tpu_torch.config import MoEConfig
from flashmoe_tpu_torch.ops import wire as wr
from flashmoe_tpu_torch.utils.telemetry import metrics as _global_metrics
from flashmoe_tpu_torch.utils.telemetry import trace_span


def dtype_name(dtype) -> str:
    """A torch dtype's numpy-style name (``"bfloat16"``,
    ``"float8_e4m3fn"``, ``"float32"``): the name JAX's frames and
    wire codec carry."""
    return str(dtype).removeprefix("torch.")


@dataclasses.dataclass(frozen=True)
class KVPagePayload:
    """One prefill run's wire form: K/V page payloads plus the per-page
    f32 ``_qscale`` sidecars (``None`` on exact and plain-cast wires).
    ``shape`` is the dense ``[L, N_kv, T, D]`` the decode side
    restores."""

    k: torch.Tensor
    v: torch.Tensor
    k_qscale: torch.Tensor | None
    v_qscale: torch.Tensor | None
    shape: tuple
    page_size: int
    wire: str                      # canonical name, 'off' = exact

    @property
    def pages(self) -> int:
        _, _, t, _ = self.shape
        return t // self.page_size

    @property
    def payload_bytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.k, self.v, self.k_qscale, self.v_qscale)
                   if t is not None)


def _page_rows(seq_kv, page_size: int):
    """[L, N_kv, T, D] -> [L * n_pages, N_kv * page * D]: one wire row
    per (layer, page), the granularity the ``_qscale`` sidecar keys."""
    l, nkv, t, d = seq_kv.shape
    if t % page_size:
        raise ValueError(f"KV run of {t} positions does not fill whole "
                         f"pages of {page_size}")
    n = t // page_size
    rows = seq_kv.reshape(l, nkv, n, page_size, d)
    rows = rows.permute(0, 2, 1, 3, 4)          # [L, n, N_kv, page, D]
    return rows.reshape(l * n, nkv * page_size * d)


def _unpage_rows(rows, shape, page_size: int, out_dtype):
    l, nkv, t, d = shape
    n = t // page_size
    seq = rows.reshape(l, n, nkv, page_size, d).permute(0, 2, 1, 3, 4)
    return seq.reshape(l, nkv, t, d).to(out_dtype)


def encode_kv_run(k_seq, v_seq, page_size: int,
                  wire_dtype) -> KVPagePayload:
    """Quantize one prefill run for the handoff wire.  ``wire_dtype``
    ``None`` is the exact path: the tensors ride untouched (no cast, no
    sidecar)."""
    shape = tuple(k_seq.shape)
    if wire_dtype is None:
        return KVPagePayload(k_seq, v_seq, None, None, shape,
                             int(page_size), "off")
    kp, ks = wr.encode(_page_rows(k_seq, page_size), wire_dtype)
    vp, vs = wr.encode(_page_rows(v_seq, page_size), wire_dtype)
    return KVPagePayload(kp, vp, ks, vs, shape, int(page_size),
                         wr.canonical_name(dtype_name(wire_dtype)))


def decode_kv_run(payload: KVPagePayload, out_dtype):
    """Invert :func:`encode_kv_run` -> (k_seq, v_seq) at ``out_dtype``.
    The 'off' arm returns the tensors untouched (bit-exact)."""
    if payload.wire == "off":
        return payload.k, payload.v
    k = _unpage_rows(
        wr.decode(payload.k, payload.k_qscale, torch.float32),
        payload.shape, payload.page_size, out_dtype)
    v = _unpage_rows(
        wr.decode(payload.v, payload.v_qscale, torch.float32),
        payload.shape, payload.page_size, out_dtype)
    return k, v


class KVHandoff:
    """The prefill-pool side of the fabric: computes the prefill with the
    engine's own :func:`_prefill_padded`, streams the KV run through the
    page codec, and hands the decode replica exactly what its local
    prefill would have produced (bit-equal with the wire off).

    Bind one per fabric; :meth:`prefill_fn` closes over the target
    replica id so each engine's ``fabric.handoff`` decisions name their
    destination.  ``decode_step_ms``: the decode pool's modeled per-step
    objective (``PoolPlan.decode_ms``) the handoff must hide under; None
    omits the overlap verdict.  ``vclock``: a
    :class:`~flashmoe_tpu_torch.fabric.vclock.VirtualClock` every
    transfer advances by its measured cost, reconciled against the priced
    one per transfer (``fabric.handoff_drift``).  ``transport``: a
    :class:`~flashmoe_tpu_torch.fabric.transport.HandoffTransport`: the
    payload crosses a failable wire (per-page CRC32, timeout and bounded
    retry) and the decode pool caches the received bytes; None keeps the
    in-process path, which copies nothing."""

    def __init__(self, params, cfg: MoEConfig, page_size: int, *,
                 wire=None, metrics_obj=None,
                 decode_step_ms: float | None = None, vclock=None,
                 transport=None):
        self.params = params
        self.cfg = cfg
        self.page_size = int(page_size)
        name = wire if wire is not None else cfg.kv_wire_dtype
        self.wire_dtype = wr.resolve(name)
        self.wire_name = wr.canonical_name(name)
        self.metrics = (metrics_obj if metrics_obj is not None
                        else _global_metrics)
        self.decode_step_ms = decode_step_ms
        self.vclock = vclock
        self.transport = transport
        self.count = 0
        self.bytes_moved = 0
        self.modeled_ms_total = 0.0
        self.measured_ms_total = 0.0
        self.hidden_ms_total = 0.0
        self.drift_agree = 0
        self.drift_total = 0

    def prefill_fn(self, replica: int):
        """The ``ServingEngine(prefill_fn=...)`` seam for one decode
        replica."""
        def fn(prompt_padded, true_len, *, rid=None):
            return self.prefill(prompt_padded, true_len,
                                replica=replica, rid=rid)
        return fn

    def prefill(self, prompt_padded, true_len: int, *,
                replica: int = 0, rid=None):
        """Prefill in the prefill pool, hand pages to ``replica``.
        Returns ``(logits, k_seq, v_seq)``, the engine's prefill
        contract, where the KV run has crossed the handoff wire."""
        from flashmoe_tpu_torch.planner.model import kv_handoff_ms
        from flashmoe_tpu_torch.serving import engine as _engine

        logits, k_seq, v_seq = _engine._prefill_padded(
            self.params, self.cfg, prompt_padded, int(true_len))
        acct = None
        retry_ms = 0.0
        retries = 0
        with trace_span("serve.handoff"):
            payload = encode_kv_run(k_seq, v_seq, self.page_size,
                                    self.wire_dtype)
            ms = kv_handoff_ms(self.cfg, payload.pages, self.page_size,
                               wire=self.wire_dtype)
            if self.transport is not None:
                # the failable wire: what the decode pool caches is what
                # crossed
                result = self.transport.send(payload, modeled_ms=ms,
                                             rid=rid, replica=replica)
                payload = result.payload
                retry_ms = result.retry_ms
                retries = result.retries
            k_out, v_out = decode_kv_run(payload, self.cfg.dtype)
            if self.vclock is not None:
                # advance virtual time inside the serve.handoff span: the
                # request's prefill span absorbs the wait (and any retry)
                acct = self.vclock.on_handoff(ms, rid=rid,
                                              replica=replica,
                                              extra_ms=retry_ms)
        self.count += 1
        self.bytes_moved += payload.payload_bytes
        self.modeled_ms_total += ms
        overlapped = (None if self.decode_step_ms is None
                      else bool(ms <= self.decode_step_ms))
        self.metrics.count("fabric.handoffs")
        self.metrics.sketch("fabric.handoff_ms", ms)
        self.metrics.decision(
            "fabric.handoff", rid=rid, replica=int(replica),
            pages=payload.pages, wire=self.wire_name,
            payload_kb=round(payload.payload_bytes / 1024, 3),
            modeled_dcn_ms=round(ms, 6),
            decode_step_ms=(round(self.decode_step_ms, 6)
                            if self.decode_step_ms is not None else None),
            overlapped=overlapped, retries=retries,
            retry_ms=round(retry_ms, 6))
        if acct is not None:
            self._reconcile(acct, ms, rid, replica, overlapped)
        return logits, k_out, v_out

    def _reconcile(self, acct: dict, modeled_ms: float, rid,
                   replica: int, overlapped_priced) -> None:
        """Measured-vs-priced verdict for one transfer: the virtual clock
        experienced ``acct``; the planner priced ``modeled_ms`` against
        the whole decode tick (``fabric.handoff_drift``)."""
        measured = acct["measured_ms"]
        hidden = acct["hidden_ms"]
        self.measured_ms_total += measured
        self.hidden_ms_total += hidden
        overlapped_measured = bool(acct["exposed_ms"] <= 1e-9)
        hf_measured = (hidden / measured) if measured > 0 else 1.0
        hf_priced = None
        if self.decode_step_ms is not None:
            hf_priced = (min(modeled_ms, self.decode_step_ms)
                         / modeled_ms if modeled_ms > 0 else 1.0)
        agree = (None if overlapped_priced is None
                 else bool(overlapped_measured == overlapped_priced))
        self.drift_total += 1
        if agree:
            self.drift_agree += 1
        self.metrics.sketch("fabric.handoff_drift_ms",
                            measured - modeled_ms)
        self.metrics.decision(
            "fabric.handoff_drift", rid=rid, replica=int(replica),
            modeled_dcn_ms=round(modeled_ms, 6),
            chaos_ms=acct["chaos_ms"],
            retry_ms=acct.get("retry_ms", 0.0),
            measured_dcn_ms=round(measured, 6),
            tick_ms=acct["tick_ms"],
            hidden_ms=round(hidden, 6),
            exposed_ms=acct["exposed_ms"],
            hidden_frac_measured=round(hf_measured, 6),
            hidden_frac_priced=(round(hf_priced, 6)
                                if hf_priced is not None else None),
            overlapped_priced=overlapped_priced,
            overlapped_measured=overlapped_measured, agree=agree)

    def snapshot(self) -> dict:
        """Live ``/vars`` view of the handoff link."""
        out = {
            "wire": self.wire_name,
            "handoffs": self.count,
            "bytes_moved": self.bytes_moved,
            "modeled_ms_total": round(self.modeled_ms_total, 6),
            "decode_step_ms": self.decode_step_ms,
        }
        if self.vclock is not None:
            out.update(
                measured_ms_total=round(self.measured_ms_total, 6),
                hidden_ms_total=round(self.hidden_ms_total, 6),
                hidden_fraction=(
                    round(self.hidden_ms_total / self.measured_ms_total,
                          6) if self.measured_ms_total > 0 else None),
                verdicts_agree=self.drift_agree,
                verdicts_total=self.drift_total)
        if self.transport is not None:
            out["transport"] = self.transport.snapshot()
        return out
