"""The MoE transformer: forward, loss and a plain SGD step.

Counterpart of ``flashmoe_tpu/models/transformer.py:44-317``: pre-norm
blocks with RoPE (half-split) and GQA attention, an MoE FFN on every
``moe_frequency``-th layer (a dense FFN elsewhere), final RMS norm and an
lm head whose logits are f32; next-token cross-entropy plus the MoE
losses.  Parameters are nested dicts of tensors in the JAX layout.  One
device: the config refuses the mesh axes, and there is no expert-parallel
branch.  With ``cfg.is_training`` every block is rematerialised in the
backward.  Causal self-attention runs the flash kernel on CUDA tensors
(outside autograd) and the MoE layers run the gate and grouped FFN
kernels, forward and backward.
"""

from __future__ import annotations

import math

import torch
import torch.utils.checkpoint

from flashmoe_tpu_torch.config import MoEConfig
from flashmoe_tpu_torch.kernels import _build
from flashmoe_tpu_torch.models.reference import dot_f32, init_moe_params
from flashmoe_tpu_torch.ops.attention import flash_attention
from flashmoe_tpu_torch.ops.moe import moe_layer
from flashmoe_tpu_torch.tree import tree_leaves, tree_map


def init_params(generator: torch.Generator, cfg: MoEConfig,
                device=None) -> dict:
    """Random parameter tree (the JAX layout and distributions), on
    ``device``, by default the generator's device."""
    device = generator.device if device is None else device
    h = cfg.hidden_size
    nh, nkv, dh = (cfg.num_heads, cfg.resolved_num_kv_heads,
                   cfg.resolved_head_dim)
    dt = cfg.param_dtype

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=generator, dtype=dt, device=device)
        return w / math.sqrt(fan_in)

    def ones(n):
        return torch.ones((n,), dtype=dt, device=device)

    params = {
        "embed": dense((cfg.vocab_size, h), 1.0) * 0.02,
        "final_norm": ones(h),
        "lm_head": dense((h, cfg.vocab_size), h),
        "layers": [],
    }
    moe_set = set(cfg.moe_layer_indices)
    for li in range(cfg.num_layers):
        layer = {
            "attn_norm": ones(h),
            "ffn_norm": ones(h),
            "wq": dense((h, nh * dh), h),
            "wk": dense((h, nkv * dh), h),
            "wv": dense((h, nkv * dh), h),
            "wo": dense((nh * dh, h), nh * dh),
        }
        layer["moe"] = init_moe_params(
            generator, cfg if li in moe_set else _dense_cfg(cfg), device)
        params["layers"].append(layer)
    return params


def _dense_cfg(cfg: MoEConfig) -> MoEConfig:
    return cfg.replace(num_experts=1, expert_top_k=1, num_shared_experts=0)


def layer_cfg(cfg: MoEConfig, li: int) -> MoEConfig:
    """Layer li's FFN config: the MoE config or its one-expert dense form."""
    return cfg if li in cfg.moe_layer_indices else _dense_cfg(cfg)


def rms_norm(x, w, eps=1e-6):
    """RMS norm computed in f32, returned in x's dtype."""
    xf = x.float()
    xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * w.float()).to(x.dtype)


def _rope(q, k, positions, theta):
    """Rotary embeddings, half-split (not interleaved).  q/k: [B, T, N, D];
    positions: [B, T]."""
    half = q.shape[-1] // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=q.device) / half)
    angles = positions[..., None].float() * freq  # [B, T, half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]

    def rot(x):
        x1, x2 = x[..., :half].float(), x[..., half:].float()
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                         dim=-1).to(x.dtype)

    return rot(q), rot(k)


def qkv(layer, x, cfg: MoEConfig, positions):
    """Projections + RoPE.  x: [B, T, H] -> q [B, T, N, D], k/v
    [B, T, NKV, D]."""
    b, t, _ = x.shape
    nh, nkv, dh = (cfg.num_heads, cfg.resolved_num_kv_heads,
                   cfg.resolved_head_dim)
    q = (x @ layer["wq"].to(x.dtype)).reshape(b, t, nh, dh)
    k = (x @ layer["wk"].to(x.dtype)).reshape(b, t, nkv, dh)
    v = (x @ layer["wv"].to(x.dtype)).reshape(b, t, nkv, dh)
    q, k = _rope(q, k, positions, cfg.rope_theta)
    return q, k, v


def attention(layer, x, cfg: MoEConfig, positions=None,
              use_kernels: bool | None = None):
    """Causal self-attention with RoPE and GQA.  x: [B, T, H].

    The flash kernel runs on CUDA tensors outside autograd.  With grad
    enabled and an input of the attention requiring grad (a training step)
    the plain version runs instead, differentiated by torch: the kernel
    has no backward, as the JAX package's has none
    (:func:`flashmoe_tpu_torch.ops.attention.flash_attention`)."""
    b, t, _ = x.shape
    if positions is None:
        positions = torch.arange(t, device=x.device)[None, :].expand(b, t)
    q, k, v = qkv(layer, x, cfg, positions)
    qh, kh, vh = (a.transpose(1, 2).contiguous() for a in (q, k, v))
    ctx = flash_attention(qh, kh, vh, causal=True, use_kernels=use_kernels)
    ctx = ctx.transpose(1, 2).reshape(b, t, -1).to(x.dtype)
    return ctx @ layer["wo"].to(x.dtype)


def _ffn(layer, x, cfg: MoEConfig, li: int, use_kernels: bool | None):
    """FFN sub-block: MoE or dense.  Returns (out, aux + z losses, the
    layer's MoEStats or None)."""
    b, t, h = x.shape
    o = moe_layer(layer["moe"], x.reshape(b * t, h), layer_cfg(cfg, li),
                  use_kernels=use_kernels)
    return (o.out.reshape(b, t, h).to(x.dtype), o.aux_loss + o.z_loss,
            o.stats)


def block(layer, x, cfg: MoEConfig, li: int,
          use_kernels: bool | None = None):
    """One pre-norm block.  Returns (x, moe_losses, moe_stats), the stats
    the layer's MoEStats when ``cfg.collect_stats`` and it is an MoE
    layer, else None."""
    x = x + attention(layer, rms_norm(x, layer["attn_norm"]), cfg,
                      use_kernels=use_kernels)
    f, moe_loss, moe_stats = _ffn(layer, rms_norm(x, layer["ffn_norm"]),
                                  cfg, li, use_kernels)
    return x + f, moe_loss, moe_stats


def lm_head(params, cfg: MoEConfig, x):
    """Final norm + lm head: [..., H] -> [..., V] f32 logits."""
    h = rms_norm(x, params["final_norm"])
    return dot_f32(h.to(cfg.dtype), params["lm_head"].to(cfg.dtype))


def forward(params, tokens, cfg: MoEConfig, use_kernels: bool | None = None):
    """tokens: [B, T] int -> (logits [B, T, V] f32, summed MoE losses).
    With ``cfg.collect_stats`` a third element: the tuple of the MoE
    layers' :class:`MoEStats`, in layer order.

    With ``cfg.is_training`` each block runs under
    ``torch.utils.checkpoint`` (non-reentrant): its activations are not
    kept, and the backward recomputes the block, the counterpart of
    ``jax.checkpoint(block, policy=nothing_saveable)``.  The recompute
    reruns the gate and the grouped FFN's forward; the gate kernel's
    block-ordered sums give it the same routing."""
    uk = _build.use_kernels_for(tokens, use_kernels)
    x = params["embed"].to(cfg.dtype)[tokens]
    total_aux = torch.zeros((), dtype=cfg.accum_dtype, device=x.device)
    layer_stats = []
    for li, layer in enumerate(params["layers"]):
        if cfg.is_training:
            # the block draws no random numbers: no RNG state to replay
            x, moe_loss, moe_stats = torch.utils.checkpoint.checkpoint(
                block, layer, x, cfg, li, uk, use_reentrant=False,
                preserve_rng_state=False)
        else:
            x, moe_loss, moe_stats = block(layer, x, cfg, li, use_kernels=uk)
        total_aux = total_aux + moe_loss
        if moe_stats is not None:
            layer_stats.append(moe_stats)
    if cfg.collect_stats:
        return lm_head(params, cfg, x), total_aux, tuple(layer_stats)
    return lm_head(params, cfg, x), total_aux


def loss_fn(params, batch, cfg: MoEConfig, use_kernels: bool | None = None):
    """Next-token cross-entropy + MoE aux losses.

    batch: dict with "tokens" [B, T] (inputs are tokens[:, :-1], targets
    tokens[:, 1:]) and optionally "mask" [B, T - 1] weighting each target.
    Returns ``(loss, {"ce": ce, "aux": aux})``, and with
    ``cfg.collect_stats`` ``"moe_stats"``, the MoE layers' stats."""
    tokens = batch["tokens"]
    inp, tgt = tokens[:, :-1], tokens[:, 1:]
    logits, aux, *stats = forward(params, inp, cfg, use_kernels)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, tgt[..., None].long())[..., 0]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones_like(nll)
    ce = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    metrics = {"ce": ce, "aux": aux}
    if cfg.collect_stats:
        metrics["moe_stats"] = stats[0]
    return ce + aux, metrics


def value_and_grad(params, batch, cfg: MoEConfig,
                   use_kernels: bool | None = None):
    """``(loss, metrics, grads)`` of :func:`loss_fn`: grads in the nesting
    of ``params``, one tensor for every floating-point leaf, None for the
    others.  A leaf the loss does not reach (a dense layer's ``gate_w``)
    gets zeros, as ``jax.grad`` gives it."""
    leaves = tree_map(
        lambda p: p.detach().requires_grad_(True)
        if p.is_floating_point() else p, params)
    wrt = [p for p in tree_leaves(leaves) if p.requires_grad]
    loss, metrics = loss_fn(leaves, batch, cfg, use_kernels)
    flat = iter(torch.autograd.grad(loss, wrt, allow_unused=True,
                                    materialize_grads=True))
    grads = tree_map(lambda p: next(flat) if p.requires_grad else None,
                     leaves)
    return loss.detach(), tree_map(torch.Tensor.detach, metrics), grads


def sgd_train_step(params, batch, cfg: MoEConfig, lr: float = 1e-3,
                   use_kernels: bool | None = None):
    """Minimal train step (plain SGD); the full optimizer path lives in
    :mod:`flashmoe_tpu_torch.runtime.trainer`.  Returns ``(params, loss,
    metrics)``."""
    loss, metrics, grads = value_and_grad(params, batch, cfg, use_kernels)
    params = tree_map(
        lambda p, g: (p - lr * g.to(p.dtype)).to(p.dtype)
        if g is not None else p, params, grads)
    return params, loss, metrics
