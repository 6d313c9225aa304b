"""Fault injection points: the chaos harness's data plane.

Counterpart of ``flashmoe_tpu/chaos/inject.py``.  A small registry,
importable from the hot-path ops without the runtime.  A point is *armed*
on the host; the hook sites in :mod:`flashmoe_tpu_torch.ops.moe`,
:mod:`flashmoe_tpu_torch.ops.gate`, :mod:`flashmoe_tpu_torch.parallel.ep`,
:mod:`flashmoe_tpu_torch.runtime.trainer` and
:mod:`flashmoe_tpu_torch.runtime.throughput` test :func:`is_armed` with a
plain Python ``if``, so a disarmed registry adds no work to any step.

The port runs eagerly: an armed point takes effect at the next call, and
re-arming between two steps changes the second.  JAX's decision is made
when a computation is traced, and its remat cache keys on
:func:`trace_signature`; the port keeps that function for parity, and no
cache of the port reads it.

Points:

=================  ==========================================  =========
point              hook site                                   spec keys
=================  ==========================================  =========
``nan_expert``     capacity expert-output buffers [E, C, H]    expert
                   (ops/moe.py, parallel/ep.py)
``skewed_routing`` router logits (ops/gate.py router_plain,    expert,
                   and the gate kernel's bias operand)         bias
``nan_grad``       trainer gradients at one step               step
``grad_spike``     trainer gradients at one step               step,
                                                               scale
``probe_rates``    per-device throughput probe                 rates
                   (runtime/throughput.py device_rates: the
                   reading a degraded device would give)
=================  ==========================================  =========

Host-level faults (``slow_step``, ``corrupt_ckpt``, ``path_raise``,
``preempt``, ``device_loss``) live in :func:`flashmoe_tpu_torch.chaos.
make_injector` and :func:`flashmoe_tpu_torch.chaos.wrap_step`.
"""

from __future__ import annotations

import torch

from flashmoe_tpu_torch.tree import tree_map

_ARMED: dict[str, dict] = {}

POINTS = ("nan_expert", "skewed_routing", "nan_grad", "grad_spike",
          "probe_rates")


def arm(point: str, **spec) -> None:
    """Arm an injection point.  Idempotent; a later arm replaces the
    spec.  The next call through the hook site sees it."""
    if point not in POINTS:
        raise ValueError(f"unknown injection point {point!r}; "
                         f"in-graph points: {POINTS}")
    _ARMED[point] = dict(spec)


def disarm(point: str | None = None) -> None:
    """Disarm one point, or everything when ``point`` is None."""
    if point is None:
        _ARMED.clear()
    else:
        _ARMED.pop(point, None)


def is_armed(point: str) -> bool:
    return point in _ARMED


def spec(point: str) -> dict:
    return dict(_ARMED.get(point, {}))


def trace_signature() -> tuple:
    """Hashable snapshot of the armed registry: () when disarmed, a
    distinct tuple for each armed spec otherwise (JAX's static remat
    key; kept for parity)."""
    return tuple(sorted(
        (point, tuple(sorted(sp.items()))) for point, sp in _ARMED.items()
    ))


# ----------------------------------------------------------------------
# Appliers: called from the hook sites only when is_armed()
# ----------------------------------------------------------------------

def poison_expert(ybuf: torch.Tensor) -> torch.Tensor:
    """NaN one expert's slab of a capacity-format output [E, C, H]."""
    e = int(_ARMED["nan_expert"].get("expert", 0)) % ybuf.shape[0]
    out = ybuf.clone()
    out[e] = float("nan")
    return out


def poison_local_expert(ylocs: list, ep_ranks, num_experts: int, *,
                        local_offset: int = 0,
                        local_total: int | None = None) -> list:
    """NaN the armed global expert's rows of the pre-exchange buffers
    ``[nE, rows, H]`` of the held ranks (``ylocs[i]`` is the buffer of the
    rank whose ep coordinate is ``ep_ranks[i]``): only the expert's owner
    poisons, at its local row, before the return exchange, so the NaN
    crosses the transport (a wire included) before any health mask sees
    it.  JAX's form reads its rank from ``axis_index`` inside
    ``shard_map``; the port's local mesh holds every rank's buffer in one
    list, so the ranks come in beside them.

    A buffer may be a chunk of the owner's local experts: ``local_total``
    is the owner's whole local-expert count (default: the buffer's own
    leading dim) and ``local_offset`` the first local expert it covers.
    A chunk without the armed expert is returned untouched."""
    nrows = ylocs[0].shape[0]
    total = local_total if local_total is not None else nrows
    e = int(_ARMED["nan_expert"].get("expert", 0)) % num_experts
    row = e % total - local_offset
    if row < 0 or row >= nrows:
        return list(ylocs)  # armed expert lives in another chunk
    out = []
    for y, r in zip(ylocs, ep_ranks):
        if int(r) == e // total:
            y = y.clone()
            y[row] = float("nan")
        out.append(y)
    return out


def logit_bias(num_experts: int) -> tuple[int, float] | None:
    """The armed ``skewed_routing`` point as ``(expert, bias)``, or None
    when it is disarmed: the operand the gate kernel adds to that
    expert's logit (``csrc/gate.cu``), as :func:`poison_logits` adds it
    to the plain router's."""
    if "skewed_routing" not in _ARMED:
        return None
    s = _ARMED["skewed_routing"]
    return int(s.get("expert", 0)) % num_experts, float(s.get("bias", 100.0))


def poison_logits(logits: torch.Tensor) -> torch.Tensor:
    """Bias the router logits [S, E] hard toward one expert: every
    token's top-1 collapses onto it, whatever its input."""
    e, bias = logit_bias(logits.shape[-1])
    out = logits.clone()
    out[:, e] += bias
    return out


def _is_float(g) -> bool:
    return torch.is_tensor(g) and g.is_floating_point()


def poison_grads(grads, step: torch.Tensor):
    """Apply the armed gradient faults at their target step.  ``step`` is
    the state's step tensor, compared with the armed step on its device:
    nothing is read back to the host."""
    if "nan_grad" in _ARMED:
        at = int(_ARMED["nan_grad"].get("step", 0))
        hit = step == at
        grads = tree_map(
            lambda g: torch.where(hit, torch.full_like(g, float("nan")), g)
            if _is_float(g) else g, grads)
    if "grad_spike" in _ARMED:
        s = _ARMED["grad_spike"]
        at = int(s.get("step", 0))
        scale = float(s.get("scale", 1e4))
        hit = step == at
        grads = tree_map(
            lambda g: torch.where(hit, g * torch.tensor(scale, dtype=g.dtype,
                                                        device=g.device), g)
            if _is_float(g) else g, grads)
    return grads
