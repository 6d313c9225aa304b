"""Dense-math reference MoE: the port's numerical oracle.

Counterpart of ``flashmoe_tpu/models/reference.py``.  Every expert is
evaluated on every token and combined through a dense [S, E] weight
matrix, so routing, capacity and permutation cannot hide errors.  Where
the JAX code asks for ``preferred_element_type=float32`` the operands are
upcast to float32 first: the products of bf16 values are exact in
float32, so that is the same arithmetic.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from flashmoe_tpu_torch.config import Activation, MoEConfig


def activation_fn(name: str):
    """relu, gelu (tanh approximation, as ``jax.nn.gelu``) or silu."""
    return {
        Activation.RELU: torch.relu,
        Activation.GELU: lambda x: F.gelu(x, approximate="tanh"),
        Activation.SILU: F.silu,
    }[name]


def dot_f32(a, b):
    """``jnp.dot(a, b, preferred_element_type=float32)``."""
    return torch.matmul(a.float(), b.float())


def top_k_lowest_index(values, k: int):
    """Top-k along the last axis; on equal values the lowest index wins
    (``jax.lax.top_k``'s order; ``torch.topk`` promises none)."""
    v, i = torch.sort(values, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def init_moe_params(generator: torch.Generator, cfg: MoEConfig,
                    device=None) -> dict:
    """Random MoE-layer parameters, the JAX layout and distributions:
    ``gate_w [H, E]``, ``w_up``/``w_gate [E, H, I]``, ``w_down [E, I, H]``,
    zero biases, normal weights scaled by 1/sqrt(fan_in).  On ``device``,
    by default the generator's device."""
    device = generator.device if device is None else device
    h, i, e = cfg.hidden_size, cfg.intermediate_size, cfg.num_experts
    dt = cfg.param_dtype

    def normal(shape, fan_in):
        w = torch.randn(shape, generator=generator, dtype=dt, device=device)
        return w / math.sqrt(fan_in)

    p = {
        "gate_w": normal((h, e), h),
        "w_up": normal((e, h, i), h),
        "b_up": torch.zeros((e, i), dtype=dt, device=device),
        "w_down": normal((e, i, h), i),
        "b_down": torch.zeros((e, h), dtype=dt, device=device),
    }
    if cfg.gated_ffn:
        p["w_gate"] = normal((e, h, i), h)
    if cfg.num_shared_experts:
        si = i * cfg.num_shared_experts
        p["shared_w_up"] = normal((h, si), h)
        p["shared_w_down"] = normal((si, h), si)
        if cfg.gated_ffn:
            p["shared_w_gate"] = normal((h, si), h)
    return p


def reference_gate(x, gate_w, cfg: MoEConfig):
    """Gate: logits -> softmax -> top-k.  Returns (combine_weights [S, E],
    top_idx [S, K], router_probs [S, E], aux_loss)."""
    logits = dot_f32(x, gate_w)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_idx = top_k_lowest_index(probs, cfg.expert_top_k)
    norm_top = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-20)
    one_hot = F.one_hot(top_idx, cfg.num_experts).to(probs.dtype)
    combine_weights = torch.einsum("sk,ske->se", norm_top, one_hot)
    density = one_hot.sum(1).mean(0)
    aux_loss = cfg.num_experts * torch.sum(density * probs.mean(0))
    return combine_weights, top_idx, probs, aux_loss


def expert_ffn(x, p, cfg: MoEConfig, e: int):
    """Single-expert FFN: up GEMM (+bias) -> act -> down GEMM (+bias)."""
    act = activation_fn(cfg.hidden_act)
    up = dot_f32(x, p["w_up"][e]) + p["b_up"][e].float()
    if cfg.gated_ffn:
        hidden = act(dot_f32(x, p["w_gate"][e])) * up
    else:
        hidden = act(up)
    down = dot_f32(hidden.to(cfg.dtype), p["w_down"][e])
    return down + p["b_down"][e].float()


def shared_expert_ffn(x, p, cfg: MoEConfig):
    """The always-on shared experts, as one wide FFN."""
    act = activation_fn(cfg.hidden_act)
    up = dot_f32(x, p["shared_w_up"])
    if cfg.gated_ffn:
        hidden = act(dot_f32(x, p["shared_w_gate"])) * up
    else:
        hidden = act(up)
    return dot_f32(hidden.to(cfg.dtype), p["shared_w_down"])


def reference_moe(params, x, cfg: MoEConfig):
    """Full dense-math MoE layer.  x: [S, H] -> (out [S, H], aux_loss)."""
    combine_weights, _, _, aux = reference_gate(x, params["gate_w"], cfg)
    xs = x.to(cfg.dtype)
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for e in range(cfg.num_experts):
        out += combine_weights[:, e:e + 1] * expert_ffn(xs, params, cfg, e)
    if cfg.num_shared_experts:
        out = out + shared_expert_ffn(xs, params, cfg)
    return out.to(cfg.dtype), aux
