"""Weight-quantization codec: symmetric absmax per-output-channel (and
optional per-K-group) int8 / fp8-e4m3 with f32 scales.

Counterpart of ``flashmoe_tpu/quant/core.py``, with the same layout
(every expert FFN weight ``[..., K, N]``, the contraction K second to
last, the output channels N last, so scales are ``[..., 1, N]``
per-channel or ``[..., K // g, N]`` with a K-group size ``g``) and the
same arithmetic, so that payloads and scales are bit-equal to JAX's on
the same f32 input: the scale is ``amax / qmax`` in f32 (1.0 on an
all-zero channel), the weight is divided by it in f32, int8 rounds half
to even and clips to +-127 (no -128, so negation round-trips), e4m3
clips to +-448 and casts with round-to-nearest-even.

Dequantization computes ``payload.f32 * scale`` in f32 and rounds once
to ``out_dtype``: the value of JAX's ``dequantize(..., f32).astype(dt)``
without an f32 temporary of the whole matrix when ``dt`` is narrower.
"""

from __future__ import annotations

import torch

_FP8_E4M3 = getattr(torch, "float8_e4m3fn", None)

_ALIASES = {
    "int8": "int8",
    "i8": "int8",
    "e4m3": "e4m3",
    "float8_e4m3fn": "e4m3",
    "fp8": "e4m3",
}

QUANT_NAMES = tuple(sorted(_ALIASES))

_INT8_QMAX = 127.0


def canonical_name(name: str | None) -> str:
    """Canonical store name ('int8' / 'e4m3'), or 'off' for ``None``."""
    if name is None:
        return "off"
    key = _ALIASES.get(str(name).lower())
    if key is None:
        raise ValueError(
            f"unknown expert_quant dtype {name!r}; supported: "
            f"{QUANT_NAMES}")
    return key


def resolve(name: str | None):
    """Store name -> payload dtype (``torch.int8`` or
    ``torch.float8_e4m3fn``), or ``None`` for off; ``ValueError`` for an
    unknown name and for e4m3 on a torch build without float8."""
    if name is None:
        return None
    key = canonical_name(name)
    if key == "int8":
        return torch.int8
    if _FP8_E4M3 is None:
        raise ValueError(
            f"expert_quant={name!r} needs float8 support this torch "
            f"build lacks; use expert_quant='int8' or None")
    return _FP8_E4M3


def is_quant_dtype(dtype) -> bool:
    """Whether ``dtype`` is one of the stores' 1-byte payload dtypes."""
    return dtype in (torch.int8, _FP8_E4M3)


def weight_itemsize(name: str | None, compute_dtype) -> float:
    """Bytes one expert-weight element streams: 1 for both stores, the
    compute dtype's size when quant is off."""
    if name is None:
        return float(compute_dtype.itemsize)
    canonical_name(name)  # validate
    return 1.0


def scale_overhead_bytes(name: str | None, n_channels: int,
                         n_groups: int = 1) -> float:
    """Bytes of the f32 scales beside a quantized matrix: one f32 per
    (K-group, output channel), 0 when quant is off."""
    if name is None:
        return 0.0
    return 4.0 * n_channels * max(n_groups, 1)


def _qmax(qdtype) -> float:
    if qdtype == torch.int8:
        return _INT8_QMAX
    return float(torch.finfo(qdtype).max)


def _check_group(k: int, group_size: int | None) -> int:
    g = int(group_size) if group_size else k
    if g < 1 or k % g:
        raise ValueError(
            f"quant group_size={group_size} must divide the "
            f"contraction dim K={k}")
    return g


def quantize_channelwise(w, qname: str, *, group_size: int | None = None,
                         clip=None):
    """Quantize ``w`` (``[..., K, N]``) to the ``qname`` store.

    Returns ``(payload, scales)``: ``payload`` has ``w``'s shape at the
    store dtype, ``scales`` is ``[..., K // g, N]`` f32 (``g = K`` when
    ``group_size`` is None).  ``clip`` (optional, broadcastable to the
    scale shape) caps each channel's absmax: values beyond it
    saturate."""
    qd = resolve(qname)
    if qd is None:
        raise ValueError("cannot quantize with expert_quant off")
    *lead, k, n = w.shape
    g = _check_group(k, group_size)
    wf = w.float().reshape(*lead, k // g, g, n)
    amax = wf.abs().amax(-2)  # [..., K//g, N]
    if clip is not None:
        amax = torch.minimum(amax, torch.as_tensor(
            clip, dtype=torch.float32, device=amax.device))
    qmax = _qmax(qd)
    # all-zero channels keep scale 1.0 (0 / 1 -> 0 exactly)
    scale = torch.where(amax > 0, amax / qmax, torch.ones_like(amax))
    scaled = wf / scale[..., None, :]
    if qd == torch.int8:
        payload = torch.clamp(torch.round(scaled), -_INT8_QMAX,
                              _INT8_QMAX).to(torch.int8)
    else:
        payload = torch.clamp(scaled, -qmax, qmax).to(qd)
    return payload.reshape(w.shape), scale


def dequantize_channelwise(payload, scales, out_dtype=torch.float32):
    """Invert :func:`quantize_channelwise`: ``(payload [..., K, N],
    scales [..., G, N])`` -> ``out_dtype`` weights, each element
    ``payload.f32 * scale`` rounded once.  The group size is read off the
    shapes."""
    *lead, k, n = payload.shape
    gcount = scales.shape[-2]
    if gcount < 1 or k % gcount:
        raise ValueError(
            f"scale groups {gcount} do not divide K={k}")
    g = k // gcount
    if payload.dtype != torch.int8:
        # torch does not promote float8 in arithmetic; every e4m3 value
        # (NaN too) is exact in f16
        payload = payload.to(torch.float16)
    out = torch.empty(payload.shape, dtype=out_dtype, device=payload.device)
    # one product per element in f32 (the inputs' common dtype), stored
    # in out_dtype
    torch.mul(payload.reshape(*lead, gcount, g, n),
              scales.float()[..., None, :],
              out=out.view(*lead, gcount, g, n))
    return out


def roundtrip(w, qname: str, *, group_size: int | None = None, clip=None):
    """Quantize + dequantize without storing: the weights the layers
    compute with under fake quantization, in ``w``'s dtype."""
    payload, scales = quantize_channelwise(w, qname, group_size=group_size,
                                           clip=clip)
    return dequantize_channelwise(payload, scales, w.dtype)


def roundtrip_error(w, qname: str, *,
                    group_size: int | None = None) -> torch.Tensor:
    """Mean relative L1 quantization error of the store on ``w`` (f32
    scalar): ``sum|w - rt(w)| / (sum|w| + 1e-9)``."""
    wf = w.float()
    rt = roundtrip(wf, qname, group_size=group_size)
    num = torch.sum(torch.abs(wf - rt))
    den = torch.sum(torch.abs(wf)) + 1e-9
    return (num / den).float()
