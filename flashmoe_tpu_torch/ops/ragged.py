"""Dropless MoE: ragged token grouping for the grouped FFN.

Counterpart of ``flashmoe_tpu/ops/ragged.py:30-138``; plain torch.  The
(token, k) assignments are sorted by expert (stable, k-major), each
expert's segment is padded up to the row tile, and the grouped FFN runs
over the result with one expert id per row tile.  No token is dropped.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from flashmoe_tpu_torch.config import MoEConfig


class RaggedPlan(NamedTuple):
    """Ragged grouping of (token, k) assignments by expert.

    position: [S, K] destination row of each assignment in the sorted,
              segment-padded buffer.
    tile_gid: [T_pad // block_m] expert id per row tile.
    counts:   [E] assignments per expert.
    num_rows: [] populated + padded rows (<= T_pad); rows past it belong
              to no expert.
    src_tok:  [T_pad] source token per buffer row (pad rows: token 0).
    present:  [T_pad] bool, True for populated rows.
    """

    position: torch.Tensor
    tile_gid: torch.Tensor
    counts: torch.Tensor
    num_rows: torch.Tensor
    src_tok: torch.Tensor
    present: torch.Tensor


def padded_total_rows(cfg: MoEConfig, s: int, block_m: int) -> int:
    """Static upper bound on the grouped buffer: every assignment plus up
    to block_m - 1 pad rows per expert."""
    total = s * cfg.expert_top_k + cfg.num_experts * block_m
    return ((total + block_m - 1) // block_m) * block_m


def make_ragged_plan(expert_idx, cfg: MoEConfig, block_m: int) -> RaggedPlan:
    """The expert-sorted, tile-padded layout.  Pure integer work."""
    s, k = expert_idx.shape
    e = cfg.num_experts
    dev = expert_idx.device
    flat_e = expert_idx.long().T.reshape(-1)  # k-major
    n = flat_e.shape[0]

    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    unpadded_starts = torch.searchsorted(
        sorted_e, torch.arange(e, dtype=torch.long, device=dev))
    counts = torch.cat([unpadded_starts[1:],
                        unpadded_starts.new_full((1,), n)]) - unpadded_starts
    padded = ((counts + block_m - 1) // block_m) * block_m
    seg_starts = torch.cat([padded.new_zeros(1), torch.cumsum(padded, 0)[:-1]])

    sorted_pos = torch.argsort(order)  # inverse permutation
    rank = sorted_pos - unpadded_starts[flat_e]
    position = (seg_starts[flat_e] + rank).reshape(k, s).T

    t_pad = padded_total_rows(cfg, s, block_m)
    n_tiles = t_pad // block_m
    tile_starts = torch.arange(n_tiles, dtype=torch.long, device=dev) * block_m
    seg_ends = seg_starts + padded
    # tiles past every segment clamp to the last expert (and are skipped)
    tile_gid = torch.clamp(
        torch.searchsorted(seg_ends, tile_starts, right=True), 0, e - 1)

    rows = torch.arange(t_pad, dtype=torch.long, device=dev)
    e_row = torch.clamp(torch.searchsorted(seg_ends, rows, right=True),
                        0, e - 1)
    row_rank = rows - seg_starts[e_row]
    present = row_rank < counts[e_row]
    sorted_idx = unpadded_starts[e_row] + torch.minimum(
        row_rank, torch.clamp(counts[e_row] - 1, min=0))
    src_tok = torch.where(present, order[torch.clamp(sorted_idx, 0, n - 1)]
                          % s, torch.zeros_like(rows))
    return RaggedPlan(position, tile_gid, counts, seg_ends[-1], src_tok,
                      present)


def ragged_dispatch(x, plan: RaggedPlan, cfg: MoEConfig, block_m: int):
    """Gather tokens into the expert-sorted padded buffer: [T_pad, H]."""
    return torch.where(plan.present[:, None], x[plan.src_tok],
                       torch.zeros((), dtype=x.dtype, device=x.device))


def ragged_combine(y, plan: RaggedPlan, combine_weights, cfg: MoEConfig):
    """Each token's K expert outputs, weighted and summed in f32."""
    s, k = plan.position.shape
    gathered = y[plan.position.reshape(-1)].reshape(s, k, -1).float()
    return torch.einsum("skh,sk->sh", gathered, combine_weights.float())
