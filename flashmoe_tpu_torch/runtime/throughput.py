"""Expert-FFN throughput probe (the reference's ``mT``).

Counterpart of ``flashmoe_tpu/runtime/throughput.py:74,101``: a synthetic
capacity buffer of ``experts`` x ``rows_per_expert`` rows through the
port's grouped FFN (B2 on the card), timed over a chain of ``chain``
calls and over a chain of one, each the median of ``trials``; their
difference over ``chain - 1`` is one call (JAX differences two jitted
chains the same way).  On the card the chains are timed on CUDA events,
on the CPU on the host clock.  The result is experts per ms, cached per
(device kind, shape), or per device when one is named.  The Decider
(ROADMAP "Host-side planes") will read it.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from flashmoe_tpu_torch.config import MoEConfig
from flashmoe_tpu_torch.models.reference import init_moe_params
from flashmoe_tpu_torch.ops.expert import capacity_buffer_ffn
from flashmoe_tpu_torch.tree import tree_map

_cache: dict = {}


def _chain_ms(fn, n: int, device: torch.device) -> float:
    """Milliseconds of ``n`` calls of ``fn`` in a row (after their inputs
    are ready): CUDA events on the card, the host clock elsewhere."""
    if device.type == "cuda":
        start, end = torch.cuda.Event(True), torch.cuda.Event(True)
        torch.cuda.synchronize(device)
        start.record()
        fn(n)
        end.record()
        end.synchronize()
        return start.elapsed_time(end)
    t0 = time.perf_counter()
    fn(n)
    return (time.perf_counter() - t0) * 1e3


def _measure(cfg: MoEConfig, e: int, rows_per_expert: int, chain: int,
             trials: int, device: torch.device) -> float:
    """One uncached probe on ``device``: experts per ms."""
    pcfg = cfg.replace(num_experts=e, num_shared_experts=0,
                       expert_top_k=min(cfg.expert_top_k, e), ep=1, dp=1,
                       tp=1, sp=1, pp=1, expert_quant=None)
    params = init_moe_params(torch.Generator(device).manual_seed(0), pcfg,
                             device=device)
    params = tree_map(lambda p: p.to(cfg.dtype), params)
    xs = torch.randn((e, rows_per_expert, cfg.hidden_size),
                     generator=torch.Generator(device).manual_seed(1),
                     dtype=cfg.dtype, device=device)

    def run(n: int):
        y = xs
        for _ in range(n):
            y = capacity_buffer_ffn(y, params, pcfg).to(xs.dtype)
        return y

    def med(n: int) -> float:
        run(n)  # warm up (the kernels' first launch included)
        return float(np.median([_chain_ms(run, n, device)
                                for _ in range(trials)]))

    t1, tn = med(1), med(chain)
    per_iter_ms = max((tn - t1) / (chain - 1), 1e-9)
    return e / per_iter_ms


def measure_expert_throughput(cfg: MoEConfig, *, experts: int | None = None,
                              rows_per_expert: int = 256, chain: int = 8,
                              trials: int = 3, device=None) -> float:
    """Median throughput in experts per ms of this device kind (the card
    by default).  ``device``: probe that device and cache per device, the
    form :func:`device_rates` uses."""
    e = experts or min(cfg.num_experts, 8)
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    key = (("dev", str(dev)) if device is not None else kind, e,
           rows_per_expert, cfg.hidden_size, cfg.intermediate_size,
           str(cfg.dtype))
    if key not in _cache:
        _cache[key] = _measure(cfg, e, rows_per_expert, chain, trials, dev)
    return _cache[key]


def device_rates(cfg: MoEConfig, n_devices: int, *,
                 rows_per_expert: int = 64, chain: int = 4,
                 trials: int = 2, fresh: bool = False, device="cuda"):
    """Per-rank throughput ``[n_devices]`` (experts per ms): the process's
    device probed once, its reading repeated for every virtual rank (they
    share it).  ``fresh`` drops the cached reading first."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if fresh:
        _cache.pop((("dev", str(dev)), min(cfg.num_experts, 8),
                    rows_per_expert, cfg.hidden_size,
                    cfg.intermediate_size, str(cfg.dtype)), None)
    rate = measure_expert_throughput(
        cfg, rows_per_expert=rows_per_expert, chain=chain, trials=trials,
        device=dev)
    return np.full(n_devices, rate, dtype=np.float64)
