"""Model-family presets, at the same values as
``flashmoe_tpu/models/presets.py``.  Pass ``**overrides`` to resize (for
example fewer layers for a smoke run)."""

from __future__ import annotations

import torch

from flashmoe_tpu_torch.config import Activation, MoEConfig


def mixtral_8x7b(**overrides) -> MoEConfig:
    """Mixtral-8x7B: 8 experts, top-2, SwiGLU, GQA 32/8."""
    base = dict(
        num_experts=8, expert_top_k=2, hidden_size=4096,
        intermediate_size=14336, num_layers=32, moe_frequency=1,
        vocab_size=32000, num_heads=32, num_kv_heads=8,
        sequence_len=4096, gated_ffn=True, hidden_act=Activation.SILU,
        rope_theta=1e6, drop_tokens=False, dtype=torch.bfloat16,
    )
    base.update(overrides)
    return MoEConfig(**base)


def deepseek_moe_16b(**overrides) -> MoEConfig:
    """DeepSeekMoE-16B: 64 routed + 2 shared experts, top-6, fine-grained."""
    base = dict(
        num_experts=64, expert_top_k=6, num_shared_experts=2,
        hidden_size=2048, intermediate_size=1408, num_layers=28,
        moe_frequency=1, vocab_size=102400, num_heads=16,
        sequence_len=4096, gated_ffn=True, hidden_act=Activation.SILU,
        drop_tokens=False, dtype=torch.bfloat16,
    )
    base.update(overrides)
    return MoEConfig(**base)


def switch_base(**overrides) -> MoEConfig:
    """Switch-Transformer-Base flavour: top-1 routing, capacity + drops."""
    base = dict(
        num_experts=128, expert_top_k=1, hidden_size=768,
        intermediate_size=3072, num_layers=12, moe_frequency=2,
        vocab_size=32128, num_heads=12, sequence_len=512,
        capacity_factor=1.25, drop_tokens=True,
        hidden_act=Activation.RELU, dtype=torch.bfloat16,
    )
    base.update(overrides)
    return MoEConfig(**base)


def flashmoe_reference(**overrides) -> MoEConfig:
    """The FlashMoE reference benchmark config
    (``csrc/flashmoe_config.json``: E=64 top-2 H=2048 I=2048 S=8192)."""
    base = dict(
        num_experts=64, expert_top_k=2, hidden_size=2048,
        intermediate_size=2048, num_layers=2, moe_frequency=2,
        vocab_size=50257, num_heads=16, sequence_len=8192,
        capacity_factor=1.0, drop_tokens=True, dtype=torch.bfloat16,
    )
    base.update(overrides)
    return MoEConfig(**base)


PRESETS = {
    "mixtral-8x7b": mixtral_8x7b,
    "deepseek-moe-16b": deepseek_moe_16b,
    "switch-base": switch_base,
    "flashmoe-reference": flashmoe_reference,
}
