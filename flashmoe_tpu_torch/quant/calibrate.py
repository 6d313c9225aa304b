"""Post-training calibration: absmax against percentile clipping, judged
on an activation sample.

Counterpart of ``flashmoe_tpu/quant/calibrate.py``.  Percentile clipping
caps each channel's scale at the ``p``-th percentile of its |weights|
(values beyond it saturate), trading rare saturation for finer
resolution elsewhere.  :func:`calibrate` scores each candidate by the
expert FFN's relative output error on an activation sample and keeps
the smallest.  The sample comes from a ``torch.Generator``: JAX's PRNG
stream cannot be reproduced, so a caller that wants JAX's choice passes
the same sample to both.
"""

from __future__ import annotations

import dataclasses

import torch

from flashmoe_tpu_torch.models.reference import activation_fn
from flashmoe_tpu_torch.quant import core
from flashmoe_tpu_torch.quant.state import QUANT_WEIGHT_KEYS

#: candidate clip percentiles (100 = plain absmax, always a candidate, so
#: calibration is never worse than none on the sample it measures)
DEFAULT_PERCENTILES = (100.0, 99.99, 99.9, 99.5)


@dataclasses.dataclass(frozen=True)
class CalibrationResult:
    """The winning clip for one expert FFN param group: per-key absmax
    caps (``clip``, for :func:`~flashmoe_tpu_torch.quant.state.
    quantize_state`), the winning ``percentile``, its relative L2 output
    error on the sample, and every candidate's error (``report``, rounded
    to 8 digits)."""

    qname: str
    percentile: float
    clip: dict
    output_rel_err: float
    report: dict


def activation_sample(cfg, n_tokens: int = 512, seed: int = 0, *,
                      generator: torch.Generator | None = None,
                      device=None) -> torch.Tensor:
    """[n_tokens, H] f32 standard-normal rows from ``generator`` (by
    default a new one on ``device``, "cuda" unless given, seeded with
    ``seed``)."""
    if generator is None:
        generator = torch.Generator(
            device=device or "cuda").manual_seed(seed)
    return torch.randn((n_tokens, cfg.hidden_size), generator=generator,
                       dtype=torch.float32,
                       device=device or generator.device)


def _channel_percentile(w, pct: float) -> torch.Tensor:
    """Per-channel |w| percentile over the K axis of an [..., K, N]
    weight, keepdims (``jnp.percentile``'s linear interpolation, in f32),
    by selection along K: ``torch.quantile`` refuses inputs above 2^24
    elements."""
    aw = w.float().abs()
    k = aw.shape[-2]
    q = torch.tensor(pct, dtype=torch.float32) / 100
    pos = q * (k - 1)
    lo, hi = torch.floor(pos), torch.ceil(pos)
    w_hi = pos - lo
    w_lo = 1 - w_hi
    lo_i = int(torch.clamp(lo, 0, k - 1))
    hi_i = int(torch.clamp(hi, 0, k - 1))
    v_lo = torch.kthvalue(aw, lo_i + 1, dim=-2, keepdim=True).values
    v_hi = (v_lo if hi_i == lo_i else
            torch.kthvalue(aw, hi_i + 1, dim=-2, keepdim=True).values)
    out = v_lo * w_lo.to(aw.device) + v_hi * w_hi.to(aw.device)
    return torch.where(torch.isnan(aw).any(-2, keepdim=True),
                       torch.full_like(out, float("nan")), out)


def _ffn_out(params, x, cfg) -> torch.Tensor:
    """The expert FFN on the sample, every row through every expert
    (calibration wants weight coverage, not routing), in f32:
    [E, S, H]."""
    act = activation_fn(cfg.hidden_act)
    up = torch.einsum("sh,ehi->esi", x, params["w_up"].float())
    up = up + params["b_up"][:, None, :].float()
    if cfg.gated_ffn and "w_gate" in params:
        g = torch.einsum("sh,ehi->esi", x, params["w_gate"].float())
        hid = act(g) * up
    else:
        hid = act(up)
    return torch.einsum("esi,eih->esh", hid, params["w_down"].float())


def calibrate(params: dict, cfg, qname: str, *, sample=None,
              percentiles=DEFAULT_PERCENTILES,
              group_size: int | None = None) -> CalibrationResult:
    """The clip percentile with the least output error of the quantized
    expert FFN on the sample (``activation_sample(cfg)`` on the weights'
    device when None), for one flat expert FFN param dict."""
    qname = core.canonical_name(qname)
    if qname == "off":
        raise ValueError("calibrate needs a quant dtype, not 'off'")
    x = (sample if sample is not None
         else activation_sample(cfg, device=params["w_up"].device))
    ref = _ffn_out(params, x, cfg)
    ref_norm = torch.sqrt(torch.sum(ref ** 2)) + 1e-9

    best = None
    report: dict[str, float] = {}
    for pct in percentiles:
        clip = {}
        qp = dict(params)
        for k in QUANT_WEIGHT_KEYS:
            if k not in params:
                continue
            c = (None if pct >= 100.0
                 else _channel_percentile(params[k], pct))
            if c is not None:
                clip[k] = c
            qp[k] = core.roundtrip(params[k], qname, group_size=group_size,
                                   clip=c)
        out = _ffn_out(qp, x, cfg)
        err = float(torch.sqrt(torch.sum((out - ref) ** 2)) / ref_norm)
        report[f"p{pct:g}"] = round(err, 8)
        if best is None or err < best[0]:
            best = (err, pct, clip)
    err, pct, clip = best
    return CalibrationResult(qname=qname, percentile=pct, clip=clip,
                             output_rel_err=err, report=report)
