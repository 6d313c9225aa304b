"""Weights across: the JAX package's parameter tree into the port's.

The JAX tree is handed over as nested dicts and lists of numpy arrays
(``jax.tree_util.tree_map(np.asarray, params)``), so this module needs
no JAX.  The port keeps the JAX layout at its public functions (MoE
layer: ``gate_w [H, E]``, ``w_up [E, H, I]``, ``b_up``, ``w_down
[E, I, H]``, ``b_down``, ``w_gate``, ``shared_*``; transformer:
``embed``, ``final_norm``, ``lm_head`` and a list of ``layers`` with
``attn_norm``, ``ffn_norm``, ``wq``/``wk``/``wv``/``wo`` and ``moe``),
so each array crosses as it is.  A kernel that wants another layout
re-lays its weights itself.
"""

from __future__ import annotations

import numpy as np
import torch

# numpy cannot name bfloat16; arrays that JAX hands over as ml_dtypes
# bfloat16 cross through float32, which holds every bf16 value exactly
_NP_NAMES = {"bfloat16": torch.bfloat16}


def tensor_from_numpy(a, device="cuda") -> torch.Tensor:
    """One array -> tensor of the same dtype (bf16 kept as bf16) on
    ``device``."""
    a = np.asarray(a)
    want = _NP_NAMES.get(a.dtype.name)
    if want is not None:
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=want)
    return torch.from_numpy(np.array(a)).to(device)  # a writable copy


def params_from_numpy(tree, device="cuda"):
    """Nested dicts/lists/tuples of numpy arrays -> the same nesting of
    tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    if tree is None:
        return None
    return tensor_from_numpy(tree, device)
