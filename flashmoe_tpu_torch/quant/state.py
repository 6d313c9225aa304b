"""Quantized expert storage: the state, its checkpoint metadata block and
the one layer-boundary compute hook.

Counterpart of ``flashmoe_tpu/quant/state.py``.  A quantized parameter
dict is the ordinary MoE dict with each expert FFN weight (``w_up`` /
``w_gate`` / ``w_down``) holding its int8 / e4m3 payload (same shape)
and a sibling ``<key>_qscale`` f32 tensor holding its scales.  Biases,
``gate_w`` and the shared experts stay at full precision.  Scale tensors
lead with the expert axis, so the ep mesh shards them with their
payloads.  Trees are walked through :mod:`flashmoe_tpu_torch.tree`.
"""

from __future__ import annotations

import dataclasses
import json
import zlib

import torch

from flashmoe_tpu_torch.quant import core
from flashmoe_tpu_torch.tree import map_subtrees, subtrees

#: the expert FFN weight keys the quantizer owns ([E, K, N] layout)
QUANT_WEIGHT_KEYS = ("w_up", "w_gate", "w_down")
#: sibling key carrying a payload's f32 scales
SCALE_SUFFIX = "_qscale"


def _is_expert_dict(d) -> bool:
    """An expert FFN param group: a dict whose ``w_up`` is the stacked
    [E, H, I] expert tensor (``shared_w_up`` is 2-D and stays out)."""
    return (isinstance(d, dict) and "w_up" in d
            and getattr(d["w_up"], "ndim", 0) == 3)


def _has_scales(params: dict) -> bool:
    return any(k + SCALE_SUFFIX in params for k in QUANT_WEIGHT_KEYS)


def _dtype_name(dtype) -> str:
    """JAX's spelling of a payload dtype ('int8', 'float8_e4m3fn')."""
    return str(dtype).removeprefix("torch.")


def is_quantized(params) -> bool:
    """Whether any expert FFN group in ``params`` carries payload + scale
    pairs."""
    return any(_has_scales(d) for d in subtrees(_is_expert_dict, params))


@dataclasses.dataclass
class QuantizedExpertState:
    """A quantized parameter tree (``params``, layer-ready) and its
    JSON-able ``quant`` block (``meta``, :func:`quant_metadata`)."""

    params: dict
    meta: dict

    def dequantize(self, out_dtype=None) -> dict:
        return dequantize_state(self.params, out_dtype)


def quantize_ffn_params(params: dict, qname: str, *,
                        group_size: int | None = None,
                        clip: dict | None = None) -> dict:
    """Quantize one flat expert FFN param dict: each
    :data:`QUANT_WEIGHT_KEYS` present is replaced by its payload, with a
    ``<key>_qscale`` sibling.  ``clip``: optional per-key absmax caps
    (:attr:`~flashmoe_tpu_torch.quant.calibrate.CalibrationResult.clip`)."""
    out = dict(params)
    for k in QUANT_WEIGHT_KEYS:
        if k not in params:
            continue
        payload, scales = core.quantize_channelwise(
            params[k], qname, group_size=group_size,
            clip=None if clip is None else clip.get(k))
        out[k] = payload
        out[k + SCALE_SUFFIX] = scales
    return out


def _dequant_ffn_params(params: dict, out_dtype=None) -> dict:
    """Invert :func:`quantize_ffn_params` on one flat dict (unquantized
    dicts pass through)."""
    out = dict(params)
    for k in QUANT_WEIGHT_KEYS:
        sk = k + SCALE_SUFFIX
        if sk not in out:
            continue
        out[k] = core.dequantize_channelwise(
            out[k], out.pop(sk),
            out_dtype if out_dtype is not None else torch.float32)
    return out


def quantize_state(params, qname: str, *, group_size: int | None = None,
                   calibration=None) -> QuantizedExpertState:
    """Post-training quantization of every expert FFN group in a flat MoE
    dict or a nested transformer tree."""
    clip = getattr(calibration, "clip", calibration)
    qparams = map_subtrees(_is_expert_dict, lambda d: quantize_ffn_params(
        d, qname, group_size=group_size, clip=clip), params)
    return QuantizedExpertState(params=qparams,
                                meta=quant_metadata(qparams))


def dequantize_state(params, out_dtype=None) -> dict:
    """A quantized tree (or :class:`QuantizedExpertState`) back to
    full-precision weights (f32 unless ``out_dtype``), scale keys dropped;
    unquantized trees pass through."""
    if isinstance(params, QuantizedExpertState):
        params = params.params
    return map_subtrees(_is_expert_dict,
                        lambda d: _dequant_ffn_params(d, out_dtype), params)


def quant_metadata(params) -> dict | None:
    """The ``quant`` manifest block of a tree: store dtype, group sizes,
    quantized key census and a CRC32 of the block's sorted JSON, equal to
    the JAX package's for the same tree.  ``None`` when unquantized."""
    if isinstance(params, QuantizedExpertState):
        params = params.params
    dtypes = set()
    groups = set()
    keys: dict[str, int] = {}
    for d in subtrees(_is_expert_dict, params):
        for k in QUANT_WEIGHT_KEYS:
            sk = k + SCALE_SUFFIX
            if sk not in d:
                continue
            keys[k] = keys.get(k, 0) + 1
            dtypes.add(_dtype_name(d[k].dtype))
            kdim = d[k].shape[-2]
            ngroups = d[sk].shape[-2]
            groups.add(0 if ngroups == 1 else kdim // ngroups)
    if not keys:
        return None
    name = {"int8": "int8", "float8_e4m3fn": "e4m3"}.get(
        next(iter(dtypes)) if len(dtypes) == 1 else "", "mixed")
    block = {
        "version": 1,
        "dtype": name,
        "payload_dtypes": sorted(dtypes),
        "group_sizes": sorted(int(g) for g in groups),
        "keys": {k: keys[k] for k in sorted(keys)},
        "scale_suffix": SCALE_SUFFIX,
    }
    block["crc32"] = _meta_crc(block)
    return block


def _meta_crc(block: dict) -> int:
    body = {k: v for k, v in block.items() if k != "crc32"}
    return zlib.crc32(json.dumps(body, sort_keys=True).encode("utf-8"))


def verify_quant_metadata(block: dict | None) -> bool:
    """CRC-check a ``quant`` block (True for None: no block is a legacy
    manifest, not a corrupt one)."""
    if block is None:
        return True
    if not isinstance(block, dict) or "crc32" not in block:
        return False
    return _meta_crc(block) == block["crc32"]


def quant_bytes_saved(params, full_dtype=torch.float32) -> int:
    """Bytes a quantized tree frees against holding the same weights at
    ``full_dtype``, the scales charged against the saving; 0 when
    unquantized."""
    full = full_dtype.itemsize
    saved = 0
    for d in subtrees(_is_expert_dict, params):
        for k in QUANT_WEIGHT_KEYS:
            sk = k + SCALE_SUFFIX
            if sk not in d:
                continue
            payload, scales = d[k], d[sk]
            saved += payload.numel() * (full - payload.element_size())
            saved -= scales.numel() * 4
    return int(max(saved, 0))


def ffn_compute_params(params: dict, cfg, out_dtype=torch.float32) -> dict:
    """The layer-boundary hook: the weights one flat MoE param dict's
    expert FFN computes with, by ``cfg.expert_quant``.

    * ``None``: the dict itself, untouched (a quantized dict is refused,
      :func:`ensure_unquantized`);
    * set, with payloads and scales: the payloads dequantize to
      ``out_dtype`` (f32 as in JAX; a layer passes the dtype it casts
      the weights to, which gives the same values with one rounding and
      no f32 copy);
    * set, on full-precision weights: the quantize-dequantize round trip
      in the weights' dtype (fake quantization)."""
    qname = getattr(cfg, "expert_quant", None)
    if qname is None:
        ensure_unquantized(params)
        return params
    if _has_scales(params):
        return _dequant_ffn_params(params, out_dtype)
    out = dict(params)
    for k in QUANT_WEIGHT_KEYS:
        if k in out:
            out[k] = core.roundtrip(out[k], qname)
    return out


def weight_quant_error(params: dict, cfg) -> torch.Tensor | None:
    """``MoEStats.quant_error`` of one layer's weights: the max over the
    weight keys of :func:`~flashmoe_tpu_torch.quant.core.roundtrip_error`
    on full-precision weights under ``cfg.expert_quant``; ``None`` when
    quant is off or the dict is already quantized (its loss is baked in)."""
    qname = getattr(cfg, "expert_quant", None)
    if qname is None or _has_scales(params):
        return None
    err = None
    for k in QUANT_WEIGHT_KEYS:
        if k not in params:
            continue
        e = core.roundtrip_error(params[k], qname)
        err = e if err is None else torch.maximum(err, e)
    return err


def ensure_unquantized(params: dict) -> None:
    """The quant-off guard of every layer path: refuse a quantized dict
    whose scales a quant-off config would ignore (matmuls of raw
    payloads are finite garbage, not an error)."""
    if _has_scales(params):
        raise ValueError(
            "params carry quantized expert weights (+_qscale scales) "
            "but cfg.expert_quant is None; set expert_quant to the "
            "state's store dtype or dequantize_state() the params "
            "first")
