"""Wire-dtype compression of the expert-parallel exchange payload.

Counterpart of ``flashmoe_tpu/ops/wire.py:55-184``.  Rows are encoded
just before an exchange and decoded just after, so every compute stage
stays at the compute dtype.  ``bf16`` is a plain cast; ``e4m3`` and
``e5m2`` (``torch.float8_e4m3fn`` / ``torch.float8_e5m2``) divide each row
by ``amax(|row|) / finfo.max`` and carry that f32 scale beside the
payload.  An all-zero row keeps scale 1; a non-finite row stays
non-finite across the wire (a NaN amax keeps scale 1 and the NaN elements,
an Inf amax makes the scale Inf and the decode 0 * Inf = NaN), so the
tier-0 health mask still trips on the far side.  Plain torch arithmetic.
"""

from __future__ import annotations

import torch

_ALIASES = {
    "bf16": "bf16",
    "bfloat16": "bf16",
    "e4m3": "e4m3",
    "float8_e4m3fn": "e4m3",
    "fp8": "e4m3",
    "e5m2": "e5m2",
    "float8_e5m2": "e5m2",
}

_DTYPES = {
    "bf16": torch.bfloat16,
    "e4m3": torch.float8_e4m3fn,
    "e5m2": torch.float8_e5m2,
}

WIRE_NAMES = tuple(sorted(_ALIASES))


def canonical_name(name: str | None) -> str:
    """Canonical wire name ('bf16' / 'e4m3' / 'e5m2'), or 'off' for
    ``None``."""
    if name is None:
        return "off"
    key = _ALIASES.get(str(name).lower())
    if key is None:
        raise ValueError(
            f"unknown wire dtype {name!r}; supported: {WIRE_NAMES}")
    return key


def resolve(name: str | None):
    """Wire name -> torch dtype, or ``None`` for ``None`` (wire off).
    Raises ``ValueError`` on an unknown name."""
    if name is None:
        return None
    return _DTYPES[canonical_name(name)]


def is_fp8(wire_dtype) -> bool:
    """True for the scaled fp8 wires, False for bf16 and None."""
    return wire_dtype is not None and wire_dtype.itemsize == 1


def encode(x, wire_dtype):
    """``x`` ([..., H], rows on the last axis) for the wire: ``(payload,
    scales)``, ``scales`` the [...] f32 per-row factors of an fp8 wire and
    ``None`` for a plain cast."""
    if not is_fp8(wire_dtype):
        return x.to(wire_dtype), None
    xf = x.float()
    amax = xf.abs().amax(-1, keepdim=True)
    fmax = torch.finfo(wire_dtype).max
    scale = torch.where(amax > 0, amax / fmax, torch.ones_like(amax))
    return (xf / scale).to(wire_dtype), scale[..., 0]


def decode(payload, scales, out_dtype):
    """Invert :func:`encode` to ``out_dtype``; ``scales=None`` is the
    plain-cast wire."""
    if scales is None:
        return payload.to(out_dtype)
    return (payload.float() * scales[..., None].float()).to(out_dtype)


def roundtrip(x, wire_dtype):
    """encode + decode without an exchange: what the far side sees."""
    payload, scales = encode(x, wire_dtype)
    return decode(payload, scales, x.dtype)


def roundtrip_error(x, wire_dtype) -> torch.Tensor:
    """Mean relative L1 error of the wire on ``x`` (f32 scalar):
    ``sum|x - rt(x)| / (sum|x| + 1e-9)``."""
    xf = x.float()
    rt = roundtrip(xf, wire_dtype).float()
    return (xf - rt).abs().sum() / (xf.abs().sum() + 1e-9)
