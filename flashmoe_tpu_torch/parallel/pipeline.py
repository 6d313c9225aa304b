"""Pipeline parallelism: the GPipe and interleaved microbatch schedules over
the ``pp`` mesh axis.

Counterpart of ``flashmoe_tpu/parallel/pipeline.py``.  The layers split
into ``pp * interleave`` contiguous chunks; stage s owns chunks ``l * pp
+ s`` (lap l).  The schedule is JAX's tick table, not a loop over
microbatches: ``interleave * M + pp - 1`` ticks, at each of which every
stage whose local tick ``u = t - s`` lies in ``[0, interleave * M)``
runs one chunk on one microbatch (group ``g``, lap ``l``, offset ``r``,
microbatch ``g * pp + r``) and hands its activation to the next stage by
a ring shift over pp (:meth:`~flashmoe_tpu_torch.parallel.mesh.Mesh.
ppermute`).  Stage 0 injects the embedding at lap 0; the last stage's
last lap runs the final norm, the lm head and the cross-entropy
(:func:`lm_head_ce`), only at the ticks where it finishes a microbatch
(JAX's ``lax.cond``).  On a local mesh the stages are virtual ranks of
one device and run in turn within a tick; a stage outside its window
(JAX computes it and masks the result) is not run.

Tokens shard over dp, and over ep when the mesh has one and the model
has experts (the DP x PP x EP layout): each (dp, ep) shard runs its own
pipeline, and inside a stage the MoE layers run the collective
expert-parallel layer (:func:`flashmoe_tpu_torch.parallel.ep.
ep_moe_layer`, whatever ``cfg.moe_backend`` says, as JAX's stage runs
``_ep_moe_shard``) over the (dp, ep) ranks, each exchange within one dp
group.  Without ep each dp shard runs :func:`flashmoe_tpu_torch.ops.moe.
moe_layer` on its own tokens.  The stage's attention takes no mesh (no
sp inside a stage, as in JAX); the mesh's tp and sp ranks hold replicas
and are computed once.  Each layer is rematerialised in the backward
(``torch.utils.checkpoint``, JAX's ``nothing_saveable``).  The stage
lists hold the original parameter tensors, so autograd carries every
gradient back to ``params``.
"""

from __future__ import annotations

import torch
import torch.utils.checkpoint

from flashmoe_tpu_torch.config import MoEConfig
from flashmoe_tpu_torch.kernels import _build
from flashmoe_tpu_torch.models import transformer as tfm
from flashmoe_tpu_torch.ops.moe import moe_layer
from flashmoe_tpu_torch.parallel.ep import ep_moe_layer
from flashmoe_tpu_torch.parallel.mesh import make_mesh


def stack_stage_params(params, cfg: MoEConfig, pp: int, interleave: int = 1):
    """Per-stage layer lists (``pipeline.py:40``): returns
    ``(stage_layers, io_params)``, ``stage_layers[s][l]`` the list of the
    ``layers_per_chunk`` layer dicts of global chunk ``c = l * pp + s``
    (layers ``[c * lpc, (c + 1) * lpc)``, the Megatron interleaved
    assignment), ``io_params`` the embed, final norm and lm head.  The
    dicts are the ones of ``params``: nothing is copied."""
    v = interleave
    if cfg.num_layers % (pp * v):
        raise ValueError(
            f"num_layers {cfg.num_layers} not divisible by "
            f"pp*interleave={pp * v}")
    lpc = cfg.num_layers // (pp * v)
    moe_set = set(cfg.moe_layer_indices)
    uniform = all(i in moe_set for i in range(cfg.num_layers)) or not moe_set
    if not uniform:
        raise ValueError(
            "pipeline stages need a uniform layer pattern "
            "(moe_frequency=1 or num_experts=1)"
        )
    layers = params["layers"]
    stage_layers = [[[layers[(l * pp + s) * lpc + i] for i in range(lpc)]
                     for l in range(v)] for s in range(pp)]
    io_params = {k: params[k] for k in ("embed", "final_norm", "lm_head")}
    return stage_layers, io_params


def _block_in_stage(layer, x, cfg: MoEConfig, li: int, ep_mesh, dp: int,
                    use_kernels: bool):
    """One transformer block of a stage (``pipeline.py:76``) on the
    stage's microbatch rows of every token shard, x: [n * bm, T, H].
    With ``ep_mesh`` (the (dp, ep) ranks) the MoE sub-block runs the
    collective expert-parallel layer; else each of the ``dp`` shards
    runs the one-device layer.  Returns (x, the MoE losses' mean over
    the shards)."""
    a = tfm.attention(layer, tfm.rms_norm(x, layer["attn_norm"]), cfg,
                      use_kernels=use_kernels)
    x = x + a
    xf = tfm.rms_norm(x, layer["ffn_norm"])
    b, t, h = xf.shape
    lcfg = tfm.layer_cfg(cfg, li)
    if ep_mesh is not None and lcfg.num_experts > 1:
        o = ep_moe_layer(layer["moe"], xf.reshape(b * t, h), lcfg, ep_mesh,
                         token_axes=("dp", "ep"), use_kernels=use_kernels)
        out, loss = o.out, o.aux_loss + o.z_loss
    else:
        shards = [moe_layer(layer["moe"], c.reshape(-1, h), lcfg,
                            use_kernels=use_kernels) for c in xf.chunk(dp)]
        out = torch.cat([o.out for o in shards])
        loss = torch.stack([o.aux_loss + o.z_loss
                            for o in shards]).sum(0) / dp
    return x + out.reshape(b, t, h).to(x.dtype), loss


def _stage_apply(chunk: list, x, cfg: MoEConfig, ep_mesh, dp: int,
                 use_kernels: bool):
    """Run one chunk's layers on x (``pipeline.py:103``), each
    rematerialised in the backward.  As in JAX every layer takes the
    first MoE layer's index (the stages are uniform)."""
    aux = torch.zeros((), dtype=cfg.accum_dtype, device=x.device)
    li0 = 0 if cfg.num_experts == 1 else cfg.moe_layer_indices[0]
    for layer in chunk:
        if torch.is_grad_enabled():
            # the block draws no random numbers: no RNG state to replay
            x, loss = torch.utils.checkpoint.checkpoint(
                _block_in_stage, layer, x, cfg, li0, ep_mesh, dp,
                use_kernels, use_reentrant=False, preserve_rng_state=False)
        else:
            x, loss = _block_in_stage(layer, x, cfg, li0, ep_mesh, dp,
                                      use_kernels)
        aux = aux + loss
    return x, aux


def lm_head_ce(io_params, cfg: MoEConfig, y, tgt):
    """The last stage's head on a finished microbatch: final norm, the
    vocab GEMM, log-softmax and the mean next-token NLL.  ``calls``
    counts its runs."""
    lm_head_ce.calls += 1
    logp = torch.log_softmax(tfm.lm_head(io_params, cfg, y).float(), dim=-1)
    return -torch.gather(logp, -1, tgt[..., None].long())[..., 0].mean()


lm_head_ce.calls = 0


def tick_table(pp: int, num_microbatches: int, interleave: int = 1):
    """JAX's schedule (``pipeline.py:181-191``): for each tick, for each
    stage, ``(lap, microbatch)`` of the chunk it runs, or None outside
    its window."""
    v, m = interleave, num_microbatches
    table = []
    for t in range(v * m + pp - 1):
        row = []
        for s in range(pp):
            u = t - s
            if not 0 <= u < v * m:
                row.append(None)
                continue
            g, lap, r = u // (v * pp), (u % (v * pp)) // pp, u % pp
            row.append((lap, min(g * pp + r, m - 1)))
        table.append(row)
    return table


def pipeline_loss(params, batch, cfg: MoEConfig, mesh, *,
                  num_microbatches: int = 2, interleave: int = 1,
                  use_kernels: bool | None = None):
    """Pipelined loss over the pp axis of ``mesh`` (``pipeline.py:128``).
    batch["tokens"]: [B, T+1] with B divisible by the token shards (dp,
    times ep with experts) times ``num_microbatches``.

    ``interleave`` > 1 runs the Megatron-style interleaved schedule (each
    stage owns ``interleave`` chunks; microbatches go in groups of pp,
    which must divide ``num_microbatches``); 1 is GPipe.  Returns
    ``(ce + aux, {"ce": ce, "aux": aux})``: ce the mean over the
    finished microbatches, aux the MoE losses summed over stages and
    averaged over microbatches and token shards.  Differentiable: the
    gradients land on ``params``' tensors."""
    pp = mesh.pp
    if pp <= 1:
        raise ValueError("pipeline_loss needs a pp>1 mesh")
    v = interleave
    if v < 1:
        raise ValueError(f"interleave must be >= 1, got {v}")
    m = num_microbatches
    if v > 1 and m % pp:
        raise ValueError(
            f"interleaved schedule needs num_microbatches "
            f"({m}) divisible by pp ({pp})")
    ep, dp = mesh.ep, mesh.dp
    use_ep = ep > 1 and cfg.num_experts > 1
    if use_ep and cfg.num_experts % ep:
        raise ValueError(f"E={cfg.num_experts} not divisible by ep={ep}")
    stages, io_params = stack_stage_params(params, cfg, pp, interleave=v)
    tokens = batch["tokens"]
    uk = _build.use_kernels_for(tokens, use_kernels)
    n = dp * ep if use_ep else dp  # token shards, in (dp, ep) order
    b, t1 = tokens.shape
    if b % (n * m):
        raise ValueError(f"batch of {b} rows does not split into {n} token "
                         f"shards x {m} microbatches")
    bm = b // (n * m)
    # [m, n * bm, T]: microbatch mb of every shard, the shards in order
    rows = tokens.reshape(n, m, bm, t1).transpose(0, 1).reshape(
        m, n * bm, t1)
    inp, tgt = rows[..., :-1], rows[..., 1:]
    ep_mesh = (make_mesh(dp=dp, pp=1, ep=ep, tp=1, sp=1,
                         device=mesh.device) if use_ep else None)
    embed = io_params["embed"].to(cfg.dtype)

    loss_sum = torch.zeros((), dtype=torch.float32, device=tokens.device)
    aux_sum = torch.zeros((), dtype=cfg.accum_dtype, device=tokens.device)
    cnt = 0
    act = [None] * pp
    for row in tick_table(pp, m, v):
        out = [None] * pp
        for s, job in enumerate(row):
            if job is None:
                continue  # outside this stage's window
            lap, mb = job
            x = embed[inp[mb]] if s == 0 and lap == 0 else act[s]
            y, aux = _stage_apply(stages[s][lap], x, cfg, ep_mesh, dp, uk)
            aux_sum = aux_sum + aux
            if s == pp - 1 and lap == v - 1:  # a microbatch is finished
                loss_sum = loss_sum + lm_head_ce(io_params, cfg, y, tgt[mb])
                cnt += 1
            out[s] = y
        act = mesh.ppermute(out, "pp")
    ce = loss_sum / max(cnt, 1)
    aux = aux_sum / m
    return ce + aux, {"ce": ce, "aux": aux}
