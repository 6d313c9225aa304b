"""Weights and train states across: the JAX package's trees into the port's.

The JAX tree is handed over as nested dicts and lists of numpy arrays
(``jax.tree_util.tree_map(np.asarray, params)``), so this module needs
no JAX.  The port keeps the JAX layout at its public functions (MoE
layer: ``gate_w [H, E]``, ``w_up [E, H, I]``, ``b_up``, ``w_down
[E, I, H]``, ``b_down``, ``w_gate``, ``shared_*``; transformer:
``embed``, ``final_norm``, ``lm_head`` and a list of ``layers`` with
``attn_norm``, ``ffn_norm``, ``wq``/``wk``/``wv``/``wo`` and ``moe``),
so each array crosses as it is.  A kernel that wants another layout
re-lays its weights itself.  :func:`train_state_from_numpy` carries a
JAX ``TrainState`` (parameters, the optax AdamW state, step and gradient
guard) the same way, so a run started in JAX continues in the port.
"""

from __future__ import annotations

import numpy as np
import torch

from flashmoe_tpu_torch.runtime.trainer import (AdamWState, GuardState,
                                                TrainState)
from flashmoe_tpu_torch.tree import tree_map

# numpy cannot name bfloat16; arrays that JAX hands over as ml_dtypes
# bfloat16 cross through float32, which holds every bf16 value exactly
_NP_NAMES = {"bfloat16": torch.bfloat16}
# ml_dtypes float8 arrays (a quantized expert store's e4m3 payloads) cross
# as their raw bytes, reinterpreted
_NP_BYTES = {"float8_e4m3fn": torch.float8_e4m3fn}


def tensor_from_numpy(a, device="cuda") -> torch.Tensor:
    """One array -> tensor of the same dtype (bf16 kept as bf16, e4m3 bit
    for bit) on ``device``."""
    a = np.asarray(a)
    want = _NP_NAMES.get(a.dtype.name)
    if want is not None:
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=want)
    raw = _NP_BYTES.get(a.dtype.name)
    if raw is not None:
        return torch.from_numpy(np.array(a).view(np.uint8)).view(raw).to(
            device)
    return torch.from_numpy(np.array(a)).to(device)  # a writable copy


def params_from_numpy(tree, device="cuda"):
    """Nested dicts/lists/tuples of numpy arrays -> the same nesting of
    tensors on ``device``."""
    return tree_map(lambda a: tensor_from_numpy(a, device), tree)


def _named_tuples(tree):
    """Every NamedTuple node inside nested tuples, depth first."""
    if hasattr(tree, "_fields"):
        yield tree
    if isinstance(tree, tuple):
        for v in tree:
            yield from _named_tuples(v)


def train_state_from_numpy(state, device="cuda") -> TrainState:
    """A JAX ``TrainState`` whose leaves are numpy arrays
    (``jax.tree_util.tree_map(np.asarray, state)``) -> the port's
    :class:`TrainState` on ``device``.

    The optimizer state is the chain ``make_optimizer`` builds:
    ``clip_by_global_norm``'s empty state, then ``adamw``'s
    ``ScaleByAdamState(count, mu, nu)``, its weight decay's empty state and
    ``ScaleByScheduleState(count)``.  Both counts must agree, as they do
    in every state that chain produces."""
    nodes = list(_named_tuples(state.opt_state))
    adam = [n for n in nodes if set(n._fields) == {"count", "mu", "nu"}]
    sched = [n for n in nodes if tuple(n._fields) == ("count",)]
    if len(adam) != 1 or len(sched) != 1:
        raise ValueError(
            f"expected one ScaleByAdamState and one ScaleByScheduleState in "
            f"the optimizer state, found {[type(n).__name__ for n in nodes]}")
    adam, sched = adam[0], sched[0]
    if int(adam.count) != int(sched.count):
        raise ValueError(f"adam count {int(adam.count)} != schedule count "
                         f"{int(sched.count)}")
    opt = AdamWState(tensor_from_numpy(adam.count, device),
                     params_from_numpy(adam.mu, device),
                     params_from_numpy(adam.nu, device))
    guard = None
    if state.guard is not None:
        guard = GuardState(tensor_from_numpy(state.guard.norm_ema, device),
                           tensor_from_numpy(state.guard.seen, device))
    return TrainState(params_from_numpy(state.params, device), opt,
                      tensor_from_numpy(state.step, device), guard)
