"""Attention: the flash-attention kernel and its plain version.

Counterpart of ``flashmoe_tpu/ops/attention.py``.  Layout [B, N, T, D].

* :func:`attention_plain` is ``attention_xla``: f32 logits, softmax,
  probabilities rounded to v's dtype, f32 context.
* :func:`flash_attention` is the blockwise causal attention; on CUDA it
  launches the hand-written Hopper kernel of ``csrc/flash_attention.cu``
  (the port of ``_flash_kernel``).  k and v may carry fewer heads than q
  (GQA): query head n reads kv head n // (N // NKV), which is what
  repeating the kv heads with ``repeat_interleave`` (``jnp.repeat``)
  gives.
"""

from __future__ import annotations

import torch

from flashmoe_tpu_torch.kernels import _build

NEG_INF = -1e30
FLASH_HEAD_DIMS = (64, 128)


def attention_plain(q, k, v, *, causal: bool = True):
    """Plain attention.  q: [B, N, Tq, D], k/v: [B, N, Tk, D]."""
    d = q.shape[-1]
    logits = torch.einsum("bntd,bnsd->bnts", q.float(), k.float()) \
        * d ** -0.5
    if causal:
        tq, tk = q.shape[2], k.shape[2]
        qi = torch.arange(tq, device=q.device)[:, None]
        ki = torch.arange(tk, device=q.device)[None, :]
        logits = torch.where(qi >= ki, logits,
                             torch.full((), NEG_INF, device=q.device))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bnts,bnsd->bntd", probs.to(v.dtype).float(),
                       v.float())
    return out.to(q.dtype)


def _check(q, k, v):
    b, n, t, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (t, d) \
            or n % k.shape[1]:
        raise ValueError(f"flash_attention shapes: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")


def flash_attention_plain(q, k, v, *, causal: bool = True):
    """Plain version of :func:`flash_attention`: GQA heads repeated, then
    :func:`attention_plain`."""
    _check(q, k, v)
    rep = q.shape[1] // k.shape[1]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    return attention_plain(q, k, v, causal=causal)


def flash_attention_cuda(q, k, v, *, causal: bool = True):
    """The flash-attention kernel on CUDA tensors: q [B, N, T, D], k/v
    [B, NKV, T, D] with NKV dividing N, D in (64, 128), bf16 or f32."""
    _check(q, k, v)
    b, n, t, d = q.shape
    if d not in FLASH_HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda takes D in "
                         f"{FLASH_HEAD_DIMS}, got {d}")
    if q.dtype not in (torch.bfloat16, torch.float32) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention_cuda takes bf16 or f32 q/k/v of "
                         f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    _build.refuse_autograd("flash_attention_cuda", q, k, v)
    _build.require_cuda("flash_attention_cuda", q, k, v)
    o = torch.empty_like(q)
    lib = _build.library()
    with torch.cuda.device(q.device):
        err = lib.fm_flash_attention(
            int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), o.data_ptr(), b, n, k.shape[1], t, d, d ** -0.5,
            int(causal), _build.stream_of(q))
    _build.check(err, "fm_flash_attention")
    flash_attention_cuda.launches += 1
    return o


flash_attention_cuda.launches = 0


def flash_attention(q, k, v, *, causal: bool = True,
                    use_kernels: bool | None = None):
    """Blockwise attention, q: [B, N, T, D], k/v: [B, NKV, T, D].  The
    kernel on CUDA tensors, the plain version on CPU ones (or with
    ``use_kernels=False``).

    Under autograd (grad enabled and q, k or v requiring grad) the plain
    version runs, differentiated by torch: the kernel has no backward, as
    the JAX package's ``_flash_kernel`` has none."""
    uk = _build.use_kernels_for(q, use_kernels) and not (
        torch.is_grad_enabled()
        and any(t.requires_grad for t in (q, k, v)))
    fn = flash_attention_cuda if uk else flash_attention_plain
    return fn(q, k, v, causal=causal)
