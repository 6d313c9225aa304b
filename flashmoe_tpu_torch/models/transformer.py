"""The MoE transformer, inference only.

Counterpart of ``flashmoe_tpu/models/transformer.py:44-276``: pre-norm
blocks with RoPE (half-split) and GQA attention, an MoE FFN on every
``moe_frequency``-th layer (a dense FFN elsewhere), final RMS norm and an
lm head whose logits are f32.  Parameters are nested dicts of tensors in
the JAX layout.  One device: the config refuses the mesh axes, and there
is no remat and no expert-parallel branch.  Causal self-attention runs the
flash kernel on CUDA tensors and the MoE layers run the gate and grouped
FFN kernels.
"""

from __future__ import annotations

import math

import torch

from flashmoe_tpu_torch.config import MoEConfig
from flashmoe_tpu_torch.kernels import _build
from flashmoe_tpu_torch.models.reference import dot_f32, init_moe_params
from flashmoe_tpu_torch.ops.attention import flash_attention
from flashmoe_tpu_torch.ops.moe import moe_layer


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
    """Causal self-attention with RoPE and GQA.  x: [B, T, H]."""
    b, t, _ = x.shape
    if positions is None:
        positions = torch.arange(t, device=x.device)[None, :].expand(b, t)
    q, k, v = qkv(layer, x, cfg, positions)
    qh, kh, vh = (a.transpose(1, 2).contiguous() for a in (q, k, v))
    ctx = flash_attention(qh, kh, vh, causal=True, use_kernels=use_kernels)
    ctx = ctx.transpose(1, 2).reshape(b, t, -1).to(x.dtype)
    return ctx @ layer["wo"].to(x.dtype)


def _ffn(layer, x, cfg: MoEConfig, li: int, use_kernels: bool | None):
    """FFN sub-block: MoE or dense.  Returns (out, aux + z losses)."""
    b, t, h = x.shape
    o = moe_layer(layer["moe"], x.reshape(b * t, h), layer_cfg(cfg, li),
                  use_kernels=use_kernels)
    return o.out.reshape(b, t, h).to(x.dtype), o.aux_loss + o.z_loss


def block(layer, x, cfg: MoEConfig, li: int,
          use_kernels: bool | None = None):
    """One pre-norm block.  Returns (x, moe_losses)."""
    x = x + attention(layer, rms_norm(x, layer["attn_norm"]), cfg,
                      use_kernels=use_kernels)
    f, moe_loss = _ffn(layer, rms_norm(x, layer["ffn_norm"]), cfg, li,
                       use_kernels)
    return x + f, moe_loss


def lm_head(params, cfg: MoEConfig, x):
    """Final norm + lm head: [..., H] -> [..., V] f32 logits."""
    h = rms_norm(x, params["final_norm"])
    return dot_f32(h.to(cfg.dtype), params["lm_head"].to(cfg.dtype))


def forward(params, tokens, cfg: MoEConfig, use_kernels: bool | None = None):
    """tokens: [B, T] int -> (logits [B, T, V] f32, summed MoE losses)."""
    uk = _build.use_kernels_for(tokens, use_kernels)
    x = params["embed"].to(cfg.dtype)[tokens]
    total_aux = torch.zeros((), dtype=cfg.accum_dtype, device=x.device)
    for li, layer in enumerate(params["layers"]):
        x, moe_loss = block(layer, x, cfg, li, use_kernels=uk)
        total_aux = total_aux + moe_loss
    return lm_head(params, cfg, x), total_aux
