"""Attention: the flash-attention kernel and its plain version.

Counterpart of ``flashmoe_tpu/ops/attention.py``.  Layout [B, N, T, D].

* :func:`attention_plain` is ``attention_xla``: f32 logits, softmax,
  probabilities rounded to v's dtype, f32 context.
* :func:`flash_attention` is the blockwise causal attention; on CUDA it
  launches the hand-written Hopper kernel of ``csrc/flash_attention.cu``
  (the port of ``_flash_kernel``).  k and v may carry fewer heads than q
  (GQA): query head n reads kv head n // (N // NKV), which is what
  repeating the kv heads with ``repeat_interleave`` (``jnp.repeat``)
  gives.  The kernel takes every head dim up to 256: its launch's head
  dim is a multiple of 8, so q, k and v of another D are copied with zero
  columns up to the next multiple (S = Q K^T and the true D's scale
  unchanged) and the output's first D columns kept.  A head dim past 256
  raises on the card.
"""

from __future__ import annotations

import itertools

import torch
import torch.nn.functional as F

from flashmoe_tpu_torch.kernels import _build

NEG_INF = -1e30
#: the launch's head dims: a multiple of 8 (a TMA row stride is a multiple
#: of 16 bytes; other head dims are padded, flash_pad) up to 256 (four
#: 64-column boxes; csrc/flash_attention.cu)
FLASH_HEAD_DIM_STEP = 8
FLASH_MAX_HEAD_DIM = 256
#: the bf16 kernel's schedule (csrc/flash_attention.cu): packed (head,
#: query) rows of a consumer warpgroup's tile, keys of a stage, tiles of a
#: block (FA_ROWS, FA_BK, FA_CONSUMERS)
FLASH_ROWS = 64
FLASH_KEYS = 64
FLASH_TILES = 2


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


def flash_head_dim_ok(d: int) -> bool:
    """Whether ``d`` is a head dim the kernel's launch takes as it is."""
    return 0 < d <= FLASH_MAX_HEAD_DIM and d % FLASH_HEAD_DIM_STEP == 0


def flash_pad(q, k, v):
    """q, k and v with their head dim copied up to the next multiple of
    ``FLASH_HEAD_DIM_STEP`` with zero columns (the same tensors when it
    is one already)."""
    d = q.shape[-1]
    pad = -d % FLASH_HEAD_DIM_STEP
    if not pad:
        return q, k, v
    return tuple(F.pad(t, (0, pad)) for t in (q, k, v))


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


def flash_pack(n: int, nkv: int) -> int:
    """Query heads of one kv head packed into a kernel tile: the largest
    of 8, 4, 2, 1 that divides the GQA ratio ``n // nkv``."""
    p = 8
    while (n // nkv) % p:
        p //= 2
    return p


def flash_items(b: int, n: int, nkv: int, t: int, causal: bool = True):
    """The bf16 flash-attention kernel's work items (``fa_item`` in
    ``csrc/flash_attention.cu``), longest first.  A tile packs P =
    :func:`flash_pack` query heads of one kv head by ``FLASH_ROWS // P``
    queries; an item holds ``FLASH_TILES`` tiles on consecutive query
    ranges of one (batch, kv head, head group), one for each consumer
    warpgroup; items go in order of decreasing first query, the ones with
    the most key blocks first.  Returns ``(batch, kv head, heads, tiles,
    key blocks)`` for each item: ``tiles`` holds ``(q0, q1, key blocks)``
    for each tile, its queries ``[q0, q1)`` cut at T (empty, with no key
    blocks, past it), its key blocks of ``FLASH_KEYS`` keys up to the
    causal reach of its last query; the item loads the most of its tiles'
    key blocks."""
    g, p = n // nkv, flash_pack(n, nkv)
    rq = FLASH_ROWS // p
    span = FLASH_TILES * rq
    all_kb = -(-t // FLASH_KEYS)
    items = []
    for qb in reversed(range(-(-t // span))):
        for bi in range(b):
            for kvh in range(nkv):
                for sg in range(g // p):
                    tiles = []
                    for w in range(FLASH_TILES):
                        q0 = qb * span + w * rq
                        q1 = min(q0 + rq, t)
                        kb = 0 if q0 >= t else \
                            min(all_kb, (q0 + rq - 1) // FLASH_KEYS + 1) \
                            if causal else all_kb
                        tiles.append((q0, max(q0, q1), kb))
                    h0 = kvh * g + sg * p
                    items.append((bi, kvh, tuple(range(h0, h0 + p)), tiles,
                                  max(kb for *_, kb in tiles)))
    return items


def flash_block_walk(b: int, n: int, nkv: int, t: int, sms: int,
                     causal: bool = True):
    """The order in which the kernel's persistent grid of ``min(items,
    sms)`` blocks walks :func:`flash_items` (``fa_walk``): block ``k`` of
    ``g`` takes items k, 2 g - 1 - k, 2 g + k, 4 g - 1 - k, ... (a snake,
    so each block's key blocks add up to about the same).  Returns
    ``(block, *item)`` for each item, block by block, each block's items
    in the order it takes them."""
    items = flash_items(b, n, nkv, t, causal)
    grid = min(len(items), sms)
    walk = []
    for blk in range(grid):
        for j in itertools.count():
            i = (j + 1) * grid - 1 - blk if j % 2 else j * grid + blk
            if i >= len(items):
                break
            walk.append((blk, *items[i]))
    return walk


def flash_walk_plain(q, k, v, *, causal: bool = True, sms: int = 132,
                     scale: float | None = None):
    """Flash attention by :func:`flash_block_walk`'s tiles, with the
    kernel's arithmetic: per key block of ``FLASH_KEYS`` keys, f32 scores
    scaled (by ``scale``, D ** -0.5 when None) then masked to NEG_INF, the online max, alpha and row sum of
    the unrounded p, p rounded to v's dtype before P . V in f32, and acc /
    max(l, 1e-30) rounded once.  Rows no tile covers stay NaN, so a gap in
    the walk shows."""
    _check(q, k, v)
    b, n, t, d = q.shape
    scale = d ** -0.5 if scale is None else scale
    out = torch.full(q.shape, float("nan"), dtype=torch.float32,
                     device=q.device)
    for _, bi, kvh, heads, tiles, _ in flash_block_walk(
            b, n, k.shape[1], t, sms, causal):
        hs = list(heads)
        for q0, q1, nkb in tiles:
            if q1 == q0:
                continue
            qt = q[bi, hs, q0:q1].float()                 # [P, rq, D]
            qi = torch.arange(q0, q1, device=q.device)[:, None]
            m = torch.full((len(hs), q1 - q0, 1), NEG_INF, device=q.device)
            l = torch.zeros_like(m)
            acc = torch.zeros((len(hs), q1 - q0, d), device=q.device)
            for kb in range(nkb):
                k0, k1 = kb * FLASH_KEYS, min(kb * FLASH_KEYS + FLASH_KEYS, t)
                kt = k[bi, kvh, k0:k1].float()
                vt = v[bi, kvh, k0:k1]
                s = torch.einsum("hqd,kd->hqk", qt, kt) * scale
                ki = torch.arange(k0, k1, device=q.device)[None, :]
                if causal:
                    s = torch.where(ki > qi, torch.full((), NEG_INF), s)
                m_new = torch.maximum(m, s.amax(-1, keepdim=True))
                p = torch.exp(s - m_new)
                alpha = torch.exp(m - m_new)
                l = l * alpha + p.sum(-1, keepdim=True)
                acc = acc * alpha + torch.einsum(
                    "hqk,kd->hqd", p.to(v.dtype).float(), vt.float())
                m = m_new
            out[bi, hs, q0:q1] = acc / torch.clamp(l, min=1e-30)
    return out.to(q.dtype)


def flash_args(q, k, v, *, causal: bool = True,
               scale: float | None = None):
    """The arguments of one call of ``fm_flash_attention`` on checked CUDA
    tensors of a head dim the launch takes (:func:`flash_head_dim_ok`),
    with its output made here: ``(args, o)``.  ``scale`` is D ** -0.5
    when None (a padded call passes the true D's)."""
    b, n, t, d = q.shape
    o = torch.empty_like(q)
    args = (int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), o.data_ptr(), b, n, k.shape[1], t, d,
            d ** -0.5 if scale is None else scale, int(causal),
            _build.stream_of(q))
    return args, o


def flash_attention_cuda(q, k, v, *, causal: bool = True):
    """The flash-attention kernel on CUDA tensors: q [B, N, T, D], k/v
    [B, NKV, T, D] with NKV dividing N and D <= 256, bf16 or f32.  A
    head dim off the launch's step of 8 runs on zero-padded copies
    (:func:`flash_pad`) at the true D's scale."""
    _check(q, k, v)
    b, n, t, d = q.shape
    if not 0 < d <= FLASH_MAX_HEAD_DIM:
        raise ValueError(f"flash_attention_cuda takes a head dim D <= "
                         f"{FLASH_MAX_HEAD_DIM}, got {d}")
    if q.dtype not in (torch.bfloat16, torch.float32) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention_cuda takes bf16 or f32 q/k/v of "
                         f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    _build.refuse_autograd("flash_attention_cuda", q, k, v)
    _build.require_cuda("flash_attention_cuda", q, k, v)
    qkv = flash_pad(q, k, v)  # held until the launch is queued
    args, o = flash_args(*qkv, causal=causal, scale=d ** -0.5)
    with torch.cuda.device(q.device):
        err = _build.library().fm_flash_attention(*args)
    _build.check(err, "fm_flash_attention")
    flash_attention_cuda.launches += 1
    return o if o.shape[-1] == d else o[..., :d].contiguous()


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
