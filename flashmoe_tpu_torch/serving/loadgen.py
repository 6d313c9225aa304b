"""Seeded load generation for the serving engine.

Counterpart of the parts of ``flashmoe_tpu/serving/loadgen.py`` the
engine's drills and CLI use: :func:`tiny_config`, :func:`build_requests`
and :func:`pctl`.  Offered load is the arrival gap of the seeded trace
(requests arrive in pairs every ``arrival_every`` engine steps).  The
offered-load sweep (``serve_load_sweep``) belongs to the port's
benchmark and the fabric sweeps to the serving fabric (ROADMAP).
"""

from __future__ import annotations

import numpy as np
import torch

from flashmoe_tpu_torch.config import MoEConfig


def tiny_config(*, hidden: int = 64, experts: int = 4, layers: int = 2,
                vocab: int = 256) -> MoEConfig:
    """The CPU-sized serving drill model (dropless, the engine's
    requirement): ``flashmoe_tpu/serving/loadgen.py:17``'s fields."""
    return MoEConfig(
        num_experts=experts, expert_top_k=min(2, experts),
        hidden_size=hidden, intermediate_size=2 * hidden,
        sequence_len=128, num_layers=layers, moe_frequency=2,
        vocab_size=vocab, num_heads=2, drop_tokens=False,
        dtype=torch.float32, param_dtype=torch.float32)


def build_requests(n: int, *, vocab: int, prompt_len: int,
                   max_new: int, seed: int, arrival_every: int,
                   temperature: float = 0.0,
                   repetitive: bool = False):
    """The seeded trace: ``n`` requests with deterministic prompts and
    staggered arrivals (one pair every ``arrival_every`` engine steps).
    Prompts come from ``numpy.random.default_rng(seed)`` (the JAX
    package draws them from JAX keys, so the token values differ).
    ``repetitive`` tiles each prompt from a per-request random bigram
    motif, where the n-gram drafter finds suffix matches to propose
    from.  Request i is seeded ``seed + i``."""
    from flashmoe_tpu_torch.serving.engine import Request

    rng = np.random.default_rng(seed)
    if repetitive:
        motif = rng.integers(0, vocab, (n, 2))
        reps = -(-prompt_len // 2)
        toks = [(list(motif[i]) * reps)[:prompt_len] for i in range(n)]
    else:
        toks = rng.integers(0, vocab, (n, prompt_len))
    reqs = [Request(rid=i, prompt=tuple(int(t) for t in toks[i]),
                    max_new_tokens=max_new, temperature=temperature,
                    seed=seed + i)
            for i in range(n)]
    arrivals = [(i // 2) * arrival_every for i in range(n)]
    return reqs, arrivals


def pctl(values, q: float):
    """Nearest-rank percentile (None on empty), rounded to 3 decimals:
    the serving percentile of the JAX package's reports."""
    if not values:
        return None
    v = sorted(values)
    return round(v[min(len(v) - 1, int(q * len(v)))], 3)
