"""The MoE transformer: forward, loss and a plain SGD step.

Counterpart of ``flashmoe_tpu/models/transformer.py:44-317``: pre-norm
blocks with RoPE (half-split) and GQA attention, an MoE FFN on every
``moe_frequency``-th layer (a dense FFN elsewhere), final RMS norm and an
lm head whose logits are f32; next-token cross-entropy plus the MoE
losses.  Parameters are nested dicts of tensors in the JAX layout.  With
a ``mesh`` (:mod:`flashmoe_tpu_torch.parallel.mesh`, dp x pp x ep x tp x
sp ranks) and ``cfg.ep > 1`` the MoE layers run expert-parallel with
their tokens over (dp, ep[, sp]), by ``cfg.moe_backend`` as JAX's
``_ffn`` routes them: the fused kernel's layer or the dropless ragged
layer (without shared experts) at tp 1, else the collective layer, with
tensor-parallel experts at ``cfg.tp > 1``; with ``cfg.sp > 1``
attention is ring attention over sp.  Pipeline parallelism over pp is
:mod:`flashmoe_tpu_torch.parallel.pipeline`.  ``forward``, ``loss_fn``,
``value_and_grad`` and ``sgd_train_step`` take the mesh.  With ``cfg.is_training`` every block
is rematerialised in the backward, except the blocks whose MoE layer is
the fused kernel's (as in JAX: its backward recomputes what it needs).
Causal self-attention runs the flash kernel on CUDA tensors (outside
autograd) and the MoE layers run the gate and grouped FFN kernels,
forward and backward.
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
from flashmoe_tpu_torch.parallel.ep import ep_moe_layer
from flashmoe_tpu_torch.parallel.fused import fused_ep_moe_layer
from flashmoe_tpu_torch.parallel.mesh import AXES
from flashmoe_tpu_torch.parallel.ragged_ep import ragged_ep_moe_layer
from flashmoe_tpu_torch.parallel.ringattn import ring_attention
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
              use_kernels: bool | None = None, mesh=None):
    """Causal self-attention with RoPE and GQA.  x: [B, T, H].

    With a ``mesh`` and ``cfg.sp > 1`` it is ring attention over the sp
    axis on the GQA-repeated heads (:func:`flashmoe_tpu_torch.parallel.
    ringattn.ring_attention`, as ``flashmoe_tpu/models/transformer.py:
    131-142``).  Otherwise the flash kernel runs on CUDA tensors outside
    autograd.  With grad enabled and an input of the attention requiring
    grad (a training step) the plain version runs instead, differentiated
    by torch: the kernel has no backward, as the JAX package's has none
    (:func:`flashmoe_tpu_torch.ops.attention.flash_attention`)."""
    b, t, _ = x.shape
    if positions is None:
        positions = torch.arange(t, device=x.device)[None, :].expand(b, t)
    q, k, v = qkv(layer, x, cfg, positions)
    if mesh is not None and cfg.sp > 1:
        check_mesh(cfg, mesh)
        rep = cfg.num_heads // cfg.resolved_num_kv_heads
        if rep > 1:  # GQA: repeat the kv heads (jnp.repeat)
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
        ctx = ring_attention(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), mesh, causal=True)
    else:
        qh, kh, vh = (a.transpose(1, 2).contiguous() for a in (q, k, v))
        ctx = flash_attention(qh, kh, vh, causal=True,
                              use_kernels=use_kernels)
    ctx = ctx.transpose(1, 2).reshape(b, t, -1).to(x.dtype)
    return ctx @ layer["wo"].to(x.dtype)


def _fused_block(cfg: MoEConfig, li: int, mesh) -> bool:
    """Whether layer li's MoE runs the fused kernel's layer."""
    return (mesh is not None and cfg.ep > 1 and cfg.tp == 1
            and cfg.moe_backend == "fused"
            and li in cfg.moe_layer_indices)


def check_mesh(cfg: MoEConfig, mesh) -> None:
    """Refuse a mesh whose axes are not the config's dp x pp x ep x tp x
    sp."""
    want = {a: getattr(cfg, a) for a in AXES}
    if mesh.shape != want:
        have = " x ".join(f"{a} {n}" for a, n in mesh.shape.items())
        raise ValueError(
            f"mesh of {mesh.size} ranks ({have}) for "
            + " x ".join(f"{a}={n}" for a, n in want.items()))


def _ffn(layer, x, cfg: MoEConfig, li: int, use_kernels: bool | None,
         mesh=None):
    """FFN sub-block: MoE (expert-parallel with a mesh and ep > 1, through
    the layer ``cfg.moe_backend`` names, its tokens over the mesh's
    ("dp", "ep") axes and "sp" when sp > 1, as ``flashmoe_tpu/models/
    transformer.py:166-209``) or dense.  Returns (out, aux + z losses, the
    layer's MoEStats or None)."""
    b, t, h = x.shape
    lcfg = layer_cfg(cfg, li)
    flat = x.reshape(b * t, h)
    if mesh is not None and lcfg.num_experts > 1 and cfg.ep > 1:
        check_mesh(cfg, mesh)
        axes = ("dp", "ep") + (("sp",) if cfg.sp > 1 else ())
        backend = cfg.moe_backend
        if backend == "fused" and cfg.tp == 1:
            layer_fn = fused_ep_moe_layer
        elif (backend == "ragged" and cfg.tp == 1
                and not lcfg.num_shared_experts):
            layer_fn = ragged_ep_moe_layer
        else:
            layer_fn = ep_moe_layer
        o = layer_fn(layer["moe"], flat, lcfg, mesh, token_axes=axes,
                     use_kernels=use_kernels)
    else:
        o = moe_layer(layer["moe"], flat, lcfg, use_kernels=use_kernels)
    return (o.out.reshape(b, t, h).to(x.dtype), o.aux_loss + o.z_loss,
            o.stats)


def block(layer, x, cfg: MoEConfig, li: int,
          use_kernels: bool | None = None, mesh=None):
    """One pre-norm block.  Returns (x, moe_losses, moe_stats), the stats
    the layer's MoEStats when ``cfg.collect_stats`` and it is an MoE
    layer, else None."""
    x = x + attention(layer, rms_norm(x, layer["attn_norm"]), cfg,
                      use_kernels=use_kernels, mesh=mesh)
    f, moe_loss, moe_stats = _ffn(layer, rms_norm(x, layer["ffn_norm"]),
                                  cfg, li, use_kernels, mesh)
    return x + f, moe_loss, moe_stats


def lm_head(params, cfg: MoEConfig, x):
    """Final norm + lm head: [..., H] -> [..., V] f32 logits."""
    h = rms_norm(x, params["final_norm"])
    return dot_f32(h.to(cfg.dtype), params["lm_head"].to(cfg.dtype))


def forward(params, tokens, cfg: MoEConfig, use_kernels: bool | None = None,
            *, mesh=None):
    """tokens: [B, T] int -> (logits [B, T, V] f32, summed MoE losses).
    With ``cfg.collect_stats`` a third element: the tuple of the MoE
    layers' :class:`MoEStats`, in layer order.  ``mesh``: the model's
    mesh (:mod:`flashmoe_tpu_torch.parallel.mesh`; its axes must be the
    config's dp x pp x ep x tp x sp), None for one device: with ep > 1
    the MoE layers run expert-parallel, the B * T tokens over its (dp,
    ep[, sp]) ranks, and with sp > 1 attention is ring attention over
    sp.  On a local mesh the result is the one-device function of the
    whole batch (up to the capacity each token shard gets), so autograd
    gives the gradient's mean over dp that JAX's all-reduce gives.

    With ``cfg.is_training`` each block runs under
    ``torch.utils.checkpoint`` (non-reentrant): its activations are not
    kept, and the backward recomputes the block, the counterpart of
    ``jax.checkpoint(block, policy=nothing_saveable)``.  The recompute
    reruns the gate and the grouped FFN's forward; the gate kernel's
    block-ordered sums give it the same routing.  A block whose MoE layer
    is the fused kernel's is not rematerialised, as in JAX."""
    uk = _build.use_kernels_for(tokens, use_kernels)
    x = params["embed"].to(cfg.dtype)[tokens]
    total_aux = torch.zeros((), dtype=cfg.accum_dtype, device=x.device)
    layer_stats = []
    for li, layer in enumerate(params["layers"]):
        if cfg.is_training and not _fused_block(cfg, li, mesh):
            # the block draws no random numbers: no RNG state to replay
            x, moe_loss, moe_stats = torch.utils.checkpoint.checkpoint(
                block, layer, x, cfg, li, uk, mesh, use_reentrant=False,
                preserve_rng_state=False)
        else:
            x, moe_loss, moe_stats = block(layer, x, cfg, li, use_kernels=uk,
                                           mesh=mesh)
        total_aux = total_aux + moe_loss
        if moe_stats is not None:
            layer_stats.append(moe_stats)
    if cfg.collect_stats:
        return lm_head(params, cfg, x), total_aux, tuple(layer_stats)
    return lm_head(params, cfg, x), total_aux


def loss_fn(params, batch, cfg: MoEConfig, use_kernels: bool | None = None,
            *, mesh=None):
    """Next-token cross-entropy + MoE aux losses.

    batch: dict with "tokens" [B, T] (inputs are tokens[:, :-1], targets
    tokens[:, 1:]) and optionally "mask" [B, T - 1] weighting each target.
    ``mesh`` as in :func:`forward`.
    Returns ``(loss, {"ce": ce, "aux": aux})``, and with
    ``cfg.collect_stats`` ``"moe_stats"``, the MoE layers' stats."""
    tokens = batch["tokens"]
    inp, tgt = tokens[:, :-1], tokens[:, 1:]
    logits, aux, *stats = forward(params, inp, cfg, use_kernels, mesh=mesh)
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
                   use_kernels: bool | None = None, *, mesh=None):
    """``(loss, metrics, grads)`` of :func:`loss_fn` (over ``mesh``, as in
    :func:`forward`): grads in the nesting
    of ``params``, one tensor for every floating-point leaf, None for the
    others.  A leaf the loss does not reach (a dense layer's ``gate_w``)
    gets zeros, as ``jax.grad`` gives it."""
    leaves = tree_map(
        lambda p: p.detach().requires_grad_(True)
        if p.is_floating_point() else p, params)
    wrt = [p for p in tree_leaves(leaves) if p.requires_grad]
    loss, metrics = loss_fn(leaves, batch, cfg, use_kernels, mesh=mesh)
    flat = iter(torch.autograd.grad(loss, wrt, allow_unused=True,
                                    materialize_grads=True))
    grads = tree_map(lambda p: next(flat) if p.requires_grad else None,
                     leaves)
    return loss.detach(), tree_map(torch.Tensor.detach, metrics), grads


def sgd_train_step(params, batch, cfg: MoEConfig, lr: float = 1e-3,
                   use_kernels: bool | None = None, *, mesh=None):
    """Minimal train step (plain SGD, over ``mesh`` as in
    :func:`forward`); the full optimizer path lives in
    :mod:`flashmoe_tpu_torch.runtime.trainer`.  Returns ``(params, loss,
    metrics)``."""
    loss, metrics, grads = value_and_grad(params, batch, cfg, use_kernels,
                                          mesh=mesh)
    params = tree_map(
        lambda p, g: (p - lr * g.to(p.dtype)).to(p.dtype)
        if g is not None else p, params, grads)
    return params, loss, metrics
