"""Autoregressive generation with a KV cache.

Counterpart of ``flashmoe_tpu/models/generate.py``.  The JAX ``lax.scan``
over decode steps is a Python loop here, and the cache is written in
place.  Prefill runs the full prompt through every layer at once: its
causal attention over the prompt is the flash kernel on CUDA tensors.
Decode attends over the cache with plain torch matmuls (an einsum outside
any kernel in the JAX package too).  Unlike the JAX file, the MoE layers
of prefill and of every decode step run the gate and grouped-FFN kernels
on CUDA tensors.

Greedy decoding is what is held equal to the JAX package.  Sampled draws
come from a ``torch.Generator``; JAX's ``fold_in`` key streams cannot be
reproduced.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from flashmoe_tpu_torch.config import MoEConfig
from flashmoe_tpu_torch.kernels import _build
from flashmoe_tpu_torch.models.transformer import _ffn, lm_head, qkv, rms_norm
from flashmoe_tpu_torch.ops.attention import NEG_INF, flash_attention


class KVCache(NamedTuple):
    k: torch.Tensor  # [L, B, N_kv, T_max, D]
    v: torch.Tensor


def init_cache(cfg: MoEConfig, batch: int, max_len: int,
               device="cuda") -> KVCache:
    shape = (cfg.num_layers, batch, cfg.resolved_num_kv_heads, max_len,
             cfg.resolved_head_dim)
    return KVCache(torch.zeros(shape, dtype=cfg.dtype, device=device),
                   torch.zeros(shape, dtype=cfg.dtype, device=device))


def _decode_step(params, cfg: MoEConfig, x, cache: KVCache, pos: int,
                 use_kernels: bool | None = None):
    """One token through all layers.  x: [B, 1, H]; pos: the position
    being written.  Writes the cache in place; returns (logits [B, V],
    cache)."""
    uk = _build.use_kernels_for(x, use_kernels)
    b = x.shape[0]
    nh, nkv, dh = (cfg.num_heads, cfg.resolved_num_kv_heads,
                   cfg.resolved_head_dim)
    positions = torch.full((b, 1), pos, device=x.device)
    t_max = cache.k.shape[3]
    live = (torch.arange(t_max, device=x.device) <= pos)[None, None, None]
    for li, layer in enumerate(params["layers"]):
        q, k, v = qkv(layer, rms_norm(x, layer["attn_norm"]), cfg, positions)
        cache.k[li, :, :, pos] = k[:, 0]
        cache.v[li, :, :, pos] = v[:, 0]
        kk, vv = cache.k[li], cache.v[li]
        if nkv != nh:
            kk = kk.repeat_interleave(nh // nkv, dim=1)
            vv = vv.repeat_interleave(nh // nkv, dim=1)
        qh = q.transpose(1, 2)  # [B, N, 1, D]
        logits = torch.einsum("bntd,bnsd->bnts", qh.float(), kk.float()) \
            * (dh ** -0.5)
        logits = torch.where(live, logits,
                             torch.full((), NEG_INF, device=x.device))
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        ctx = torch.einsum("bnts,bnsd->bntd", probs.float(), vv.float())
        ctx = ctx.transpose(1, 2).reshape(b, 1, nh * dh).to(x.dtype)
        x = x + ctx @ layer["wo"].to(x.dtype)
        x = x + _ffn(layer, rms_norm(x, layer["ffn_norm"]), cfg, li, uk)[0]
    return lm_logits(params, cfg, x), cache


def prefill_forward(params, cfg: MoEConfig, prompt, cache: KVCache,
                    use_kernels: bool | None = None):
    """The full prompt through every layer at once, writing cache
    positions [0, T0).  prompt: [B, T0].  Returns (x [B, T0, H] before
    the final norm, cache)."""
    uk = _build.use_kernels_for(prompt, use_kernels)
    b, t0 = prompt.shape
    x = params["embed"].to(cfg.dtype)[prompt]
    positions = torch.arange(t0, device=x.device)[None, :].expand(b, t0)
    for li, layer in enumerate(params["layers"]):
        q, k, v = qkv(layer, rms_norm(x, layer["attn_norm"]), cfg, positions)
        qh, kh, vh = (a.transpose(1, 2).contiguous() for a in (q, k, v))
        cache.k[li, :, :, :t0] = kh
        cache.v[li, :, :, :t0] = vh
        ctx = flash_attention(qh, kh, vh, causal=True, use_kernels=uk)
        ctx = ctx.transpose(1, 2).reshape(b, t0, -1).to(x.dtype)
        x = x + ctx @ layer["wo"].to(x.dtype)
        x = x + _ffn(layer, rms_norm(x, layer["ffn_norm"]), cfg, li, uk)[0]
    return x, cache


def lm_logits(params, cfg: MoEConfig, h):
    """Final norm + lm head on [B, 1, H] hidden states -> [B, V] f32."""
    return lm_head(params, cfg, h)[:, 0]


def prefill_batched(params, cfg: MoEConfig, prompt, cache: KVCache,
                    use_kernels: bool | None = None):
    """Single-pass prefill: (logits [B, V] at the last prompt position,
    filled cache)."""
    x, cache = prefill_forward(params, cfg, prompt, cache, use_kernels)
    return lm_logits(params, cfg, x[:, -1:]), cache


def prefill_loop(params, cfg: MoEConfig, prompt, cache: KVCache,
                 use_kernels: bool | None = None):
    """One-token-at-a-time prefill: exact per-step capacity semantics."""
    b, t0 = prompt.shape
    embed = params["embed"].to(cfg.dtype)
    logits = None
    for i in range(t0):
        x = embed[prompt[:, i]][:, None, :]
        logits, cache = _decode_step(params, cfg, x, cache, i, use_kernels)
    return logits, cache


def sample_tokens(logits, generator: torch.Generator | None = None, *,
                  temperature: float = 0.0, top_k: int = 0,
                  top_p: float = 1.0):
    """Next tokens from [B, V] f32 logits -> [B] int64.  ``temperature=0``
    is greedy (argmax, first maximum); otherwise top-k, then nucleus
    truncation, then a draw from ``generator``."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    if not 0 < top_p <= 1.0:
        raise ValueError(f"top_p={top_p} must be in (0, 1]")
    if top_k < 0:
        raise ValueError(f"top_k={top_k} must be >= 0")
    logits = logits.float() / temperature
    neg = torch.full((), NEG_INF, device=logits.device)
    if top_k and top_k < logits.shape[-1]:
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = torch.where(logits < kth, neg, logits)
    if top_p < 1.0:
        sorted_desc = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_desc, dim=-1)
        keep = (torch.cumsum(probs, dim=-1) - probs) < top_p
        thresh = torch.where(keep, sorted_desc,
                             torch.full((), float("inf"),
                                        device=logits.device))
        logits = torch.where(logits < thresh.min(-1, keepdim=True).values,
                             neg, logits)
    return torch.multinomial(torch.softmax(logits, dim=-1), 1,
                             generator=generator)[:, 0]


def generate(params, prompt, cfg: MoEConfig, *, max_new_tokens: int = 32,
             temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
             stop_tokens: tuple = (), pad_token: int = 0,
             generator: torch.Generator | None = None,
             prefill: str = "auto", use_kernels: bool | None = None):
    """Greedy (temperature=0) or sampled decoding.  prompt: [B, T0] ->
    [B, T0 + max_new_tokens].

    ``stop_tokens`` retire a row: the stop token is emitted and every later
    position is ``pad_token``.  ``prefill``: 'batched' (one pass over the
    prompt), 'loop' (one token at a time) or 'auto' (batched for dropless
    configs, loop when ``drop_tokens``, whose capacity competition is per
    step)."""
    b, t0 = prompt.shape
    if prefill == "auto":
        prefill = "loop" if cfg.drop_tokens else "batched"
    if prefill not in ("batched", "loop"):
        raise ValueError(
            f"prefill={prefill!r} not in ('auto', 'batched', 'loop')")
    cache = init_cache(cfg, b, t0 + max_new_tokens, prompt.device)
    fill = prefill_batched if prefill == "batched" else prefill_loop
    logits, cache = fill(params, cfg, prompt, cache, use_kernels)

    stops = torch.tensor(stop_tokens, device=prompt.device) \
        if stop_tokens else None
    done = torch.zeros((b,), dtype=torch.bool, device=prompt.device)
    embed = params["embed"].to(cfg.dtype)
    toks = []
    for i in range(max_new_tokens):
        tok = sample_tokens(logits, generator, temperature=temperature,
                            top_k=top_k, top_p=top_p)
        if stops is not None:
            tok = torch.where(done, torch.full_like(tok, pad_token), tok)
            done = done | torch.isin(tok, stops)
        toks.append(tok)
        if i + 1 < max_new_tokens:  # the last step's logits go unused
            logits, cache = _decode_step(params, cfg,
                                         embed[tok][:, None, :], cache,
                                         t0 + i, use_kernels)
    if not toks:
        return prompt
    return torch.cat([prompt, torch.stack(toks, dim=1).to(prompt.dtype)],
                     dim=1)
