"""Quantized expert storage: int8 / e4m3 expert FFN weights with f32
per-output-channel (or per-K-group) scales.

Counterpart of ``flashmoe_tpu/quant/``, with its exports:

* :mod:`~flashmoe_tpu_torch.quant.core`: the codec, bit-equal to JAX's;
* :mod:`~flashmoe_tpu_torch.quant.state`: the quantized parameter tree,
  its CRC'd metadata block and :func:`ffn_compute_params`, the hook every
  MoE layer calls at its boundary;
* :mod:`~flashmoe_tpu_torch.quant.calibrate`: absmax against percentile
  clipping, scored on an activation sample.

Under ``MoEConfig.expert_quant`` a pre-quantized tree dequantizes at the
layer boundary (single device, collective ep layer), or streams its
1-byte payloads into the fused kernel, which dequantizes each weight
tile on chip; full-precision weights are fake-quantized; with
``expert_quant=None`` no quant code runs and a quantized tree is
refused.
"""

from flashmoe_tpu_torch.quant.calibrate import (  # noqa: F401
    CalibrationResult, activation_sample, calibrate,
)
from flashmoe_tpu_torch.quant.core import (  # noqa: F401
    QUANT_NAMES, canonical_name, dequantize_channelwise,
    quantize_channelwise, resolve, roundtrip, roundtrip_error,
    scale_overhead_bytes, weight_itemsize,
)
from flashmoe_tpu_torch.quant.state import (  # noqa: F401
    QUANT_WEIGHT_KEYS, QuantizedExpertState, SCALE_SUFFIX,
    dequantize_state, ensure_unquantized, ffn_compute_params,
    is_quantized, quant_bytes_saved, quant_metadata,
    quantize_ffn_params, quantize_state, verify_quant_metadata,
    weight_quant_error,
)
