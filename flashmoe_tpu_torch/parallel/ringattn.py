"""Ring attention: sequence parallelism over the ``sp`` mesh axis.

Counterpart of ``flashmoe_tpu/parallel/ringattn.py``.  Each sp rank
holds a sequence shard of q, k and v; the kv shards rotate around the
ring (:meth:`flashmoe_tpu_torch.parallel.mesh.Mesh.ppermute`, JAX's
``ppermute`` by +1), and each rank folds every arriving kv block into
its queries' online-softmax accumulator (m, l, acc), the recursion of
the flash kernel.  As in JAX the block's two products are plain
products with f32 accumulation (einsums outside any Pallas kernel
there), ``p`` rounded to v's dtype before the second.

Causal masking works on global positions: rank r's queries start at
``r * T_loc``; the kv shard arriving at step s came from rank ``(r - s)
mod D``.  A block wholly above the diagonal (its source after r) is not
computed: its contribution is exactly nothing (l and o zero, its max
clamped to ``NEG_INF / 2`` below the running max that the diagonal block
of step 0 set), so skipping it leaves every bit of the result and its
gradient as JAX's zero contribution gives them.  On a local mesh the
ranks are virtual: each step runs every rank's block in turn.  The
function is differentiable through autograd.
"""

from __future__ import annotations

import torch

from flashmoe_tpu_torch.ops.attention import NEG_INF


def _block_attn(q, k, v, q_off: int, kv_off: int, scale: float,
                causal: bool):
    """One (q-shard, kv-shard) partial (``ringattn.py:33``): returns
    (m, l, o unnormalized), all f32."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        qi = torch.arange(q.shape[2], device=q.device)[:, None] + q_off
        ki = torch.arange(k.shape[2], device=q.device)[None, :] + kv_off
        s = torch.where(qi >= ki, s, torch.full((), NEG_INF,
                                                device=q.device))
    m = s.amax(-1, keepdim=True)  # [B, N, Tq, 1]
    # fully-masked rows: exp(NEG_INF - NEG_INF) would give 1s; clamp m
    m_safe = torch.clamp(m, min=NEG_INF / 2)
    p = torch.exp(s - m_safe)
    p = torch.where(s <= NEG_INF, torch.zeros((), device=q.device), p)
    l = p.sum(-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), v.float())
    return m_safe, l, o


def ring_attention(q, k, v, mesh, *, axis: str = "sp", causal: bool = True,
                   scale: float | None = None):
    """Ring attention over the sequence axis (``ringattn.py:94``).

    q/k/v: [B, N, T, D] global; T shards over ``axis`` of ``mesh`` (a
    local :class:`~flashmoe_tpu_torch.parallel.mesh.Mesh`; the ranks off
    ``axis`` hold replicas, computed once).  Returns [B, N, T, D] in q's
    dtype."""
    n = mesh.shape[axis]
    t = q.shape[2]
    if t % n:
        raise ValueError(f"sequence length {t} does not split over "
                         f"{axis}={n}")
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    t_loc = t // n
    qs = q.chunk(n, dim=2)
    ks, vs = list(k.chunk(n, dim=2)), list(v.chunk(n, dim=2))
    run = [None] * n  # per rank: (m_run, l_run, acc)
    for step in range(n):
        for r in range(n):
            src = (r - step) % n
            if causal and src > r:
                continue  # wholly above the diagonal: no contribution
            m_blk, l_blk, o_blk = _block_attn(qs[r], ks[r], vs[r],
                                              r * t_loc, src * t_loc,
                                              scale, causal)
            if run[r] is None:
                m_run = torch.full_like(m_blk, NEG_INF)
                l_run, acc = torch.zeros_like(l_blk), torch.zeros_like(o_blk)
            else:
                m_run, l_run, acc = run[r]
            m_new = torch.maximum(m_run, m_blk)
            a_run = torch.exp(m_run - m_new)
            a_blk = torch.exp(m_blk - m_new)
            run[r] = (m_new, l_run * a_run + l_blk * a_blk,
                      acc * a_run + o_blk * a_blk)
        # rotate kv to the next rank (receive from rank - 1)
        ks, vs = mesh.ppermute(ks, axis), mesh.ppermute(vs, axis)
    return torch.cat([(acc / torch.clamp(l_run, min=1e-30)).to(q.dtype)
                      for _, l_run, acc in run], dim=2)
