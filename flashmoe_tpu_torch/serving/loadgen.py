"""Seeded load generation for the serving engine.

Counterpart of the parts of ``flashmoe_tpu/serving/loadgen.py`` the
engine's and the fabric's drills and CLI use: :func:`tiny_config`,
:func:`build_requests`, :func:`pctl`, and the per-replica trace split
(:func:`split_requests`, :func:`merge_traces`).  Offered load is the
arrival gap of the seeded trace (requests arrive in pairs every
``arrival_every`` engine steps).  The offered-load sweeps
(``serve_load_sweep``, ``fabric_load_sweep``, ``fabric_fault_sweep``)
belong to the port's benchmark (ROADMAP).
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


def split_requests(n: int, *, replicas: int, vocab: int,
                   prompt_len: int, max_new: int, seed: int,
                   arrival_every: int, temperature: float = 0.0):
    """Deterministic per-replica trace split
    (``flashmoe_tpu/serving/loadgen.py:297``): replica ``r``'s trace is
    seeded from ``numpy.random.SeedSequence((seed, r))`` (JAX folds ``r``
    into ``PRNGKey(seed)``), so N independent drill processes, one a
    replica, generate disjoint, reproducible loads with no coordination;
    rids are globally unique, ``rid * replicas + r``, as JAX's.  Returns
    ``[(requests, arrivals), ...]``, one pair a replica; requests total
    ``n`` (the remainder spreads over the lowest replica ids)."""
    import dataclasses

    if replicas < 1:
        raise ValueError(f"replicas={replicas} must be >= 1")
    out = []
    for r in range(replicas):
        count = n // replicas + (1 if r < n % replicas else 0)
        sub = int(np.random.SeedSequence((seed, r)).generate_state(1)[0]) \
            % (2**31 - 1)
        reqs, arrivals = build_requests(
            count, vocab=vocab, prompt_len=prompt_len, max_new=max_new,
            seed=sub, arrival_every=arrival_every,
            temperature=temperature)
        reqs = [dataclasses.replace(q, rid=q.rid * replicas + r)
                for q in reqs]
        out.append((reqs, arrivals))
    return out


def merge_traces(splits):
    """Merge per-replica traces back into one arrival-ordered stream
    (ties break on rid): what a single fabric front door submits when
    the split generated the load."""
    merged = []
    for reqs, arrivals in splits:
        merged.extend(zip(arrivals, reqs))
    merged.sort(key=lambda p: (p[0], p[1].rid))
    return [q for _, q in merged], [a for a, _ in merged]
