"""Grouped expert FFN: up GEMM -> (+bias) -> activation -> down GEMM -> (+bias).

Counterpart of ``flashmoe_tpu/ops/expert.py``:

* :func:`expert_ffn_dense`, the batched per-expert FFN over an [E, C, H]
  capacity buffer (plain torch, as the JAX XLA path);
* :func:`grouped_ffn`, the FFN over expert-sorted rows with one expert id
  per row tile: :func:`grouped_ffn_cuda` launches the hand-written Hopper
  kernel of ``csrc/grouped_ffn.cu`` (the port of ``_ffn_kernel``), and
  :func:`grouped_ffn_plain` is its plain torch version;
* :func:`capacity_buffer_ffn`, the grouped FFN over a capacity buffer;
* the gather-fused inference FFN: :func:`grouped_ffn_tokens` reads each
  row of the grouped layout from the token matrix by its source token:
  :func:`grouped_ffn_tokens_cuda` launches ``fm_grouped_ffn_tokens``
  (``csrc/grouped_ffn.cu``, the port of ``_ffn_gather_kernel``) and
  :func:`grouped_ffn_tokens_plain` is its plain version;
  :func:`grouped_ffn_tokens_ad` differentiates it by re-gathering, and
  :func:`capacity_ffn_gather` runs it over a capacity plan;
* the training path: :func:`grouped_ffn_ad`, a ``torch.autograd.Function``
  whose forward is the residual-saving FFN (:func:`grouped_ffn_res_cuda`,
  the port of ``_ffn_res_kernel``) and whose backward,
  :func:`ffn_backward_core`, runs the grouped matmul
  (:func:`grouped_matmul_cuda`, ``csrc/grouped_matmul.cu``, the port of
  ``_gmm_kernel``) for dHidden and dX and the transposed grouped matmul
  (:func:`tgmm_cuda`, ``csrc/tgmm.cu``, the port of ``_tgmm_kernel``) for
  the weight gradients; :func:`capacity_buffer_ffn_ad` over a capacity
  buffer.

Every weight is taken in the input dtype (the callers cast), so a gated
FFN's gate GEMM runs in the same dtype as its up GEMM.  Each ``*_cuda``
wrapper launches its kernel on CUDA tensors or raises, and refuses to run
under autograd on an input that requires grad (its output would carry no
gradient); each ``*_plain`` is its plain torch version, which CPU tensors
get.
"""

from __future__ import annotations

import functools

import torch

from flashmoe_tpu_torch.config import Activation, MoEConfig
from flashmoe_tpu_torch.kernels import _build
from flashmoe_tpu_torch.models.reference import activation_fn, dot_f32
from flashmoe_tpu_torch.ops import dispatch as dsp

#: row tile of the CUDA kernels (csrc/gemm_tile.cuh FBM); the plans' block
#: must be a multiple of it
ROW_TILE = 64
#: output columns of a Hopper kernel's widest tile (csrc/grouped_matmul.cu
#: HG_BN, csrc/grouped_ffn.cu FH_COLS)
HOPPER_COLS = 256
#: largest intermediate chunk of the plain version's down-GEMM accumulation
PLAIN_BLOCK_I = 512

_ACT_CODE = {Activation.RELU: 0, Activation.GELU: 1, Activation.SILU: 2}


def expert_ffn_dense(xs, params, cfg: MoEConfig):
    """Batched per-expert FFN on the capacity buffer: [E, C, H] -> same."""
    act = activation_fn(cfg.hidden_act)
    dt = xs.dtype
    up = torch.einsum("ech,ehi->eci", xs.float(),
                      params["w_up"].to(dt).float()) \
        + params["b_up"][:, None, :].float()
    if cfg.gated_ffn:
        g = torch.einsum("ech,ehi->eci", xs.float(),
                         params["w_gate"].to(dt).float())
        hidden = act(g) * up
    else:
        hidden = act(up)
    down = torch.einsum("eci,eih->ech", hidden.to(dt).float(),
                        params["w_down"].to(dt).float()) \
        + params["b_down"][:, None, :].float()
    return down.to(dt)


def _auto_block(dim: int, cap: int) -> int:
    """Largest chunk <= cap that divides dim."""
    for b in (512, 448, 384, 320, 256, 192, 128, 64, 32, 16, 8):
        if b <= cap and dim % b == 0:
            return b
    raise ValueError(f"dimension {dim} not a multiple of 8")


def _check_ffn_args(x, tile_gid, w_up, b_up, w_down, b_down, w_gate, gated,
                    block_m, rows=None):
    """Shapes of a grouped FFN call; ``rows``, the rows of the grouped
    layout, defaults to x's (the gather-fused FFN has one per src_tok)."""
    t, h = x.shape
    t = t if rows is None else rows
    e, h2, i = w_up.shape
    if h2 != h or w_down.shape != (e, i, h) or b_up.shape != (e, i) \
            or b_down.shape != (e, h):
        raise ValueError(
            f"grouped_ffn shapes: x {tuple(x.shape)}, w_up "
            f"{tuple(w_up.shape)}, b_up {tuple(b_up.shape)}, w_down "
            f"{tuple(w_down.shape)}, b_down {tuple(b_down.shape)}")
    if gated and (w_gate is None or w_gate.shape != w_up.shape):
        raise ValueError("gated_ffn requires w_gate shaped like w_up")
    if t % block_m or tile_gid.shape != (t // block_m,):
        raise ValueError(f"rows {t} must be a multiple of block_m={block_m} "
                         f"with one tile_gid per tile, got "
                         f"{tuple(tile_gid.shape)}")


def _row_gid(tile_gid, block_m: int, rows: int, num_rows):
    """Expert of each live row: rows at or past ``num_rows`` are cut."""
    live = rows if num_rows is None else int(num_rows)
    return tile_gid.long().repeat_interleave(block_m)[:live]


def grouped_ffn_res_plain(x, tile_gid, w_up, b_up, w_down, b_down,
                          w_gate=None, *, act_name: str, gated: bool = False,
                          block_m: int, num_rows=None):
    """Plain torch version of the residual-saving grouped FFN: returns
    ``(y, u, g)``, y the FFN output, u = x @ w_up[e] + b_up[e] and g =
    x @ w_gate[e] the pre-activations, all in x's dtype (g is None when
    not gated).  Rows at or past ``num_rows`` come back zero in all three.

    The down GEMM accumulates in f32 over chunks of the intermediate
    dimension, as the TPU kernel's grid did."""
    _check_ffn_args(x, tile_gid, w_up, b_up, w_down, b_down, w_gate, gated,
                    block_m)
    act = activation_fn(act_name)
    t, h = x.shape
    i = w_up.shape[2]
    bi = _auto_block(i, PLAIN_BLOCK_I)
    row_gid = _row_gid(tile_gid, block_m, t, num_rows)
    out = torch.zeros((t, h), dtype=x.dtype, device=x.device)
    u = torch.zeros((t, i), dtype=x.dtype, device=x.device)
    g = torch.zeros((t, i), dtype=x.dtype, device=x.device) if gated \
        else None
    for e in torch.unique(row_gid).tolist():
        rows = torch.nonzero(row_gid == e).reshape(-1)
        xe = x[rows]
        up = dot_f32(xe, w_up[e]) + b_up[e].float()
        u[rows] = up.to(x.dtype)
        if gated:
            gf = dot_f32(xe, w_gate[e])
            g[rows] = gf.to(x.dtype)
            hidden = act(gf) * up
        else:
            hidden = act(up)
        hidden = hidden.to(x.dtype)
        acc = torch.zeros((rows.numel(), h), dtype=torch.float32,
                          device=x.device)
        for j in range(0, i, bi):
            acc += dot_f32(hidden[:, j:j + bi], w_down[e, j:j + bi])
        out[rows] = (acc + b_down[e].float()).to(x.dtype)
    return out, u, g


def grouped_ffn_plain(x, tile_gid, w_up, b_up, w_down, b_down, w_gate=None,
                      *, act_name: str, gated: bool = False, block_m: int,
                      num_rows=None):
    """Plain torch version of the grouped FFN (see :func:`grouped_ffn`):
    the output of :func:`grouped_ffn_res_plain`."""
    return grouped_ffn_res_plain(
        x, tile_gid, w_up, b_up, w_down, b_down, w_gate, act_name=act_name,
        gated=gated, block_m=block_m, num_rows=num_rows)[0]


def _ffn_kernel(name, res, x, tile_gid, w_up, b_up, w_down, b_down, w_gate,
                act_name, gated, block_m, num_rows, src_tok=None):
    """Launch ``fm_grouped_ffn`` (res False), ``fm_grouped_ffn_res`` (res
    True) or, given ``src_tok``, ``fm_grouped_ffn_tokens``; returns
    ``(out, u, g)``, u and g None unless res."""
    rows = None if src_tok is None else src_tok.numel()
    _check_ffn_args(x, tile_gid, w_up, b_up, w_down, b_down, w_gate, gated,
                    block_m, rows)
    _build.refuse_autograd(name, x, w_up, b_up, w_down, b_down, w_gate)
    s, h = x.shape
    t = s if rows is None else rows
    i = w_up.shape[2]
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name} takes bf16 or f32, got {x.dtype}")
    weights = [w_up, w_down] + ([w_gate] if gated else [])
    if any(w.dtype != x.dtype for w in weights):
        raise ValueError(f"{name}: weights must have x's dtype")
    if any(d % ROW_TILE for d in (t, h, i, block_m)):
        raise ValueError(f"{name} needs T, H, I, block_m % {ROW_TILE} == 0, "
                         f"got {t}, {h}, {i}, {block_m}")
    gid = tile_gid.to(torch.int32).contiguous()
    b_up32 = b_up.float().contiguous()
    b_down32 = b_down.float().contiguous()
    tensors = [x, gid, b_up32, b_down32, *weights]
    if src_tok is not None:
        src_tok = src_tok.to(torch.int32).contiguous()
        tensors.append(src_tok)
    nrow = None
    if num_rows is not None:
        nrow = num_rows.reshape(1).to(torch.int32).contiguous()
        tensors.append(nrow)
    _build.require_cuda(name, *tensors)
    if src_tok is not None and t:
        lo, hi = torch.aminmax(src_tok)
        if int(lo) < 0 or int(hi) >= s:
            raise ValueError(f"{name}: src_tok must lie in [0, {s}), got "
                             f"[{int(lo)}, {int(hi)}]")
    dev = dict(dtype=x.dtype, device=x.device)
    hidden = torch.empty((t, i), **dev)
    out = torch.empty((t, h), **dev)
    u = torch.empty((t, i), **dev) if res else None
    g = torch.empty((t, i), **dev) if res and gated else None
    bf16 = x.dtype == torch.bfloat16
    head = (int(bf16), int(gated), _ACT_CODE[act_name], x.data_ptr())
    common = (*head, gid.data_ptr(), block_m,
              None if nrow is None else nrow.data_ptr(), w_up.data_ptr(),
              w_gate.data_ptr() if gated else None, b_up32.data_ptr(),
              w_down.data_ptr(), b_down32.data_ptr())
    # bf16 B2, B3 and B6 (the Hopper FFN): the work list's buffer and the
    # persistent grid
    plan = torch.empty((4 * (t // ROW_TILE) + 1,), dtype=torch.int32,
                       device=x.device) if bf16 else None
    tail = (None if plan is None else plan.data_ptr(), t, h, i,
            w_up.shape[0], _sm_count(x.device.index))
    lib = _build.library()
    with torch.cuda.device(x.device):
        if src_tok is not None:
            err = lib.fm_grouped_ffn_tokens(
                *head, src_tok.data_ptr(), *common[len(head):],
                hidden.data_ptr(), out.data_ptr(), *tail,
                _build.stream_of(x))
        elif res:
            err = lib.fm_grouped_ffn_res(
                *common, u.data_ptr(), None if g is None else g.data_ptr(),
                hidden.data_ptr(), out.data_ptr(), *tail,
                _build.stream_of(x))
        else:
            err = lib.fm_grouped_ffn(*common, hidden.data_ptr(),
                                     out.data_ptr(), *tail,
                                     _build.stream_of(x))
    _build.check(err, "fm_grouped_ffn_tokens" if src_tok is not None
                 else "fm_grouped_ffn_res" if res else "fm_grouped_ffn")
    return out, u, g


def grouped_ffn_cuda(x, tile_gid, w_up, b_up, w_down, b_down, w_gate=None,
                     *, act_name: str, gated: bool = False, block_m: int,
                     num_rows=None):
    """The grouped FFN kernel (``csrc/grouped_ffn.cu``) on CUDA tensors.

    x bf16 or f32, every weight in x's dtype, biases of any float dtype
    (added in f32).  T, H, I and block_m must be multiples of 64.  Rows at
    or past ``num_rows`` (a 0-d or [1] integer tensor) come back zero.
    bf16 runs the Hopper FFN (TMA + wgmma, a persistent grid over the
    grouped matmul's work list, :func:`gmm_work_list`, built on the
    device); f32 the 64 x 64 tile."""
    out, _, _ = _ffn_kernel("grouped_ffn_cuda", False, x, tile_gid, w_up,
                            b_up, w_down, b_down, w_gate, act_name, gated,
                            block_m, num_rows)
    grouped_ffn_cuda.launches += 1
    return out


grouped_ffn_cuda.launches = 0


def grouped_ffn_res_cuda(x, tile_gid, w_up, b_up, w_down, b_down,
                         w_gate=None, *, act_name: str, gated: bool = False,
                         block_m: int, num_rows=None):
    """The residual-saving grouped FFN kernel (``fm_grouped_ffn_res`` in
    ``csrc/grouped_ffn.cu``) on CUDA tensors: ``(y, u, g)`` as
    :func:`grouped_ffn_res_plain`, with :func:`grouped_ffn_cuda`'s
    arguments and limits.  Rows at or past ``num_rows`` are zero in y, u
    and g.  bf16 runs :func:`grouped_ffn_cuda`'s Hopper FFN, whose up pass
    also writes u and g (y is :func:`grouped_ffn_cuda`'s output bit for
    bit); f32 the 64 x 64 tile."""
    out = _ffn_kernel("grouped_ffn_res_cuda", True, x, tile_gid, w_up, b_up,
                      w_down, b_down, w_gate, act_name, gated, block_m,
                      num_rows)
    grouped_ffn_res_cuda.launches += 1
    return out


grouped_ffn_res_cuda.launches = 0


def grouped_ffn(x, tile_gid, w_up, b_up, w_down, b_down, w_gate=None, *,
                act_name: str, gated: bool = False, block_m: int = ROW_TILE,
                num_rows=None, use_kernels: bool | None = None):
    """Grouped FFN over row-sorted tokens.

    x: [T, H], grouped so the rows of one ``block_m`` row tile share an
    expert; tile_gid: [T // block_m] expert of each row tile; w_up /
    w_gate: [E, H, I]; b_up: [E, I]; w_down: [E, I, H]; b_down: [E, H].
    Returns [T, H] in x's dtype.  With ``num_rows`` the rows at or past it
    (a ragged plan's padded tail) are returned as zeros.  The kernel on
    CUDA tensors, the plain version on CPU ones (or with
    ``use_kernels=False``).  Not differentiable through the kernel: use
    :func:`grouped_ffn_ad` for training."""
    fn = grouped_ffn_cuda if _build.use_kernels_for(x, use_kernels) \
        else grouped_ffn_plain
    return fn(x, tile_gid, w_up, b_up, w_down, b_down, w_gate,
              act_name=act_name, gated=gated, block_m=block_m,
              num_rows=num_rows)


# ----------------------------------------------------------------------
# the gather-fused FFN: rows read from the token matrix by source token
# ----------------------------------------------------------------------

def grouped_ffn_tokens_plain(x, src_tok, tile_gid, w_up, b_up, w_down,
                             b_down, w_gate=None, *, act_name: str,
                             gated: bool = False, block_m: int,
                             num_rows=None):
    """Plain torch version of the gather-fused grouped FFN:
    :func:`grouped_ffn_plain` over the gathered rows ``x[src_tok]``."""
    return grouped_ffn_plain(
        x[src_tok.long()], tile_gid, w_up, b_up, w_down, b_down, w_gate,
        act_name=act_name, gated=gated, block_m=block_m, num_rows=num_rows)


def grouped_ffn_tokens_cuda(x, src_tok, tile_gid, w_up, b_up, w_down,
                            b_down, w_gate=None, *, act_name: str,
                            gated: bool = False, block_m: int,
                            num_rows=None):
    """The gather-fused grouped FFN kernel (``fm_grouped_ffn_tokens`` in
    ``csrc/grouped_ffn.cu``) on CUDA tensors: :func:`grouped_ffn_cuda` on
    ``x[src_tok]``, without that buffer.  x: [S, H]; src_tok: [T] integer,
    each in [0, S) (checked); the rest as :func:`grouped_ffn_cuda`, with
    T, H, I and block_m multiples of 64."""
    out, _, _ = _ffn_kernel("grouped_ffn_tokens_cuda", False, x, tile_gid,
                            w_up, b_up, w_down, b_down, w_gate, act_name,
                            gated, block_m, num_rows, src_tok=src_tok)
    grouped_ffn_tokens_cuda.launches += 1
    return out


grouped_ffn_tokens_cuda.launches = 0


def grouped_ffn_tokens(x, src_tok, tile_gid, w_up, b_up, w_down, b_down,
                       w_gate=None, *, act_name: str, gated: bool = False,
                       block_m: int = ROW_TILE, num_rows=None,
                       use_kernels: bool | None = None):
    """Grouped FFN reading token rows directly (``grouped_ffn_tokens``):
    x [S, H] in token order, src_tok [T] the source token of each row of
    the grouped layout, tile_gid [T // block_m]; returns [T, H] in layout
    order.  Rows whose slot is unpopulated compute their src_tok (token 0)
    and the combine never reads them; rows at or past ``num_rows`` come
    back zero.  The kernel on CUDA tensors, the plain version on CPU ones
    (or with ``use_kernels=False``)."""
    fn = grouped_ffn_tokens_cuda if _build.use_kernels_for(x, use_kernels) \
        else grouped_ffn_tokens_plain
    return fn(x, src_tok, tile_gid, w_up, b_up, w_down, b_down, w_gate,
              act_name=act_name, gated=gated, block_m=block_m,
              num_rows=num_rows)


def hopper_tile_mn_cuda(a, b):
    """c [64, N] f32 = a [64, K] @ b [K, N] on one block of the Hopper
    FFN's MN-major mainloop (``fm_hopper_tile_mn``, ``csrc/grouped_ffn.cu``):
    the check of the descriptors through which B2 and B3 read their
    [K, N] weights in place.  bf16 CUDA tensors, K a multiple of 64, N 128
    or 256; its plain version is ``dot_f32(a, b)``."""
    (m, k), (k2, n) = a.shape, b.shape
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16 or m != 64 \
            or k2 != k or k % 64 or n not in (128, 256):
        raise ValueError(f"hopper_tile_mn_cuda takes bf16 [64, K] @ [K, N], "
                         f"K % 64 == 0, N 128 or 256; got {a.dtype} "
                         f"{tuple(a.shape)} @ {b.dtype} {tuple(b.shape)}")
    _build.require_cuda("hopper_tile_mn_cuda", a, b)
    c = torch.empty((64, n), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        err = _build.library().fm_hopper_tile_mn(
            a.data_ptr(), b.data_ptr(), c.data_ptr(), k, n,
            _build.stream_of(a))
    _build.check(err, "fm_hopper_tile_mn")
    hopper_tile_mn_cuda.launches += 1
    return c


hopper_tile_mn_cuda.launches = 0


# ----------------------------------------------------------------------
# the backward kernels: grouped matmul and transposed grouped matmul
# ----------------------------------------------------------------------

def _tile_rows(x, tile_gid) -> int:
    """Rows per tile, from the row count and the number of tiles."""
    t, nt = x.shape[0], tile_gid.numel()
    if nt == 0 or t % nt:
        raise ValueError(f"rows {t} are not a whole number of {nt} tiles")
    return t // nt


def _check_gmm(x, w, transpose_w):
    t, k = x.shape
    e, a, b = w.shape
    kw, n = (b, a) if transpose_w else (a, b)
    if kw != k:
        raise ValueError(f"contraction mismatch: x K={k}, w K={kw}")
    return t, k, n


def grouped_matmul_plain(x, tile_gid, w, *, transpose_w: bool = False,
                         out_dtype=None, num_rows=None):
    """Plain torch version of the grouped matmul: out[T, N] = x[T, K] @
    w[gid(tile)] (w [E, K, N]), or with ``transpose_w`` @ w[gid]^T (w
    [E, N, K], contracted on its last dim), accumulated in f32 and
    returned in ``out_dtype`` (default x's).  Rows at or past
    ``num_rows`` come back zero."""
    t, _, n = _check_gmm(x, w, transpose_w)
    bm = _tile_rows(x, tile_gid)
    row_gid = _row_gid(tile_gid, bm, t, num_rows)
    out = torch.zeros((t, n), dtype=out_dtype or x.dtype, device=x.device)
    for e in torch.unique(row_gid).tolist():
        rows = torch.nonzero(row_gid == e).reshape(-1)
        we = w[e].T if transpose_w else w[e]
        out[rows] = dot_f32(x[rows], we).to(out.dtype)
    return out


def gmm_work_list(tile_gid, block_m: int, rows: int, num_rows=None):
    """The Hopper grouped matmul's work list (``gmm_plan`` in
    ``csrc/grouped_matmul.cu``, which builds it on the device), in Python:
    items ``(first tile, tiles, expert)`` over the ROW_TILE-row tiles.
    Each run of consecutive tiles with one expert is cut greedily from its
    start into items of two tiles and, when the run is odd, a last item of
    one.  Tiles at or past ``num_rows`` have expert -1 (zeros, no loads)
    and form runs of their own."""
    tiles = rows // ROW_TILE
    gid = [int(g) for g in tile_gid.tolist()]
    live = rows if num_rows is None else int(num_rows)
    key = [-1 if t * ROW_TILE >= live else gid[t * ROW_TILE // block_m]
           for t in range(tiles)]
    items, run0 = [], 0
    for t in range(tiles):
        if t and key[t] != key[t - 1]:
            run0 = t
        if (t - run0) % 2 == 0:
            two = t + 1 < tiles and key[t + 1] == key[t]
            items.append((t, 2 if two else 1, key[t]))
    return items


def ffn_tile_walk(tile_gid, block_m: int, rows: int, n: int, sms: int,
                  operands: int = 1, num_rows=None):
    """The output tiles of one pass of the Hopper FFN (``FfnWalk`` in
    ``csrc/grouped_ffn.cu``) in the order its persistent grid of ``sms``
    blocks walks them: the items of :func:`gmm_work_list` against column
    blocks of ``HOPPER_COLS // operands`` columns (the gated up pass holds
    up and gate side by side), the last block cut at ``n``.  Item-fastest
    (tile t is item ``t % items`` of column block ``t // items``) unless
    the items outnumber ``sms`` and the column blocks number at most a
    quarter of it; then column-fastest (column block ``t % ncols`` of
    item ``t // ncols``).
    Returns ``(first row tile, tiles, expert, n0, n1)`` for each; expert
    -1 past ``num_rows``."""
    items = gmm_work_list(tile_gid, block_m, rows, num_rows)
    cols = HOPPER_COLS // operands
    ncols = -(-n // cols)
    inner = len(items) > sms and 4 * ncols <= sms
    walk = []
    for t in range(len(items) * ncols):
        item, col = (t // ncols, t % ncols) if inner else \
            (t % len(items), t // len(items))
        walk.append((*items[item], col * cols, min(col * cols + cols, n)))
    return walk


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def gmm_hopper_args(x, gid, w, out_dtype, num_rows=None):
    """The arguments of one call of the Hopper grouped matmul
    (``fm_grouped_matmul_hopper``: the work-list launch, then the GEMM) on
    checked CUDA tensors (bf16 x [T, K], int32 ``gid``, bf16 w [E, N, K],
    ``num_rows`` int32 [1] or None), with its output and the work list's
    buffer (:func:`gmm_work_list`'s items as int32 rows of 4, then their
    count) made here: ``(args, out, plan)``."""
    t, k = x.shape
    e, n, _ = w.shape
    out = torch.empty((t, n), dtype=out_dtype, device=x.device)
    plan = torch.empty((4 * (t // ROW_TILE) + 1,), dtype=torch.int32,
                       device=x.device)
    tiles = t // ROW_TILE * -(-n // HOPPER_COLS)
    args = (int(out_dtype == torch.float32), x.data_ptr(), gid.data_ptr(),
            t // gid.numel(), None if num_rows is None else
            num_rows.data_ptr(), w.data_ptr(), out.data_ptr(),
            plan.data_ptr(), t, k, n, e,
            min(tiles, _sm_count(x.device.index)), _build.stream_of(x))
    return args, out, plan


def grouped_matmul_cuda(x, tile_gid, w, *, transpose_w: bool = False,
                        out_dtype=None, num_rows=None):
    """The grouped matmul kernels (``csrc/grouped_matmul.cu``) on CUDA
    tensors: :func:`grouped_matmul_plain`'s function.  x and w bf16 or f32
    of one dtype, out_dtype f32 or x's; T, K, N and the row tile must be
    multiples of 64.  bf16 with ``transpose_w`` (every call of the training
    backward) runs the Hopper kernel (``fm_grouped_matmul_hopper``,
    counted also in ``grouped_matmul_cuda.hopper_launches``) after a
    one-block launch that builds its work list (:func:`gmm_work_list`)
    from ``tile_gid`` on the device; f32 and bf16 with w [E, K, N] run the
    64 x 64 tile kernel (``fm_grouped_matmul``)."""
    _build.refuse_autograd("grouped_matmul_cuda", x, w)
    t, k, n = _check_gmm(x, w, transpose_w)
    bm = _tile_rows(x, tile_gid)
    out_dtype = out_dtype or x.dtype
    if x.dtype not in (torch.bfloat16, torch.float32) or w.dtype != x.dtype \
            or out_dtype not in (torch.float32, x.dtype):
        raise ValueError(f"grouped_matmul_cuda takes bf16 or f32 x and w of "
                         f"one dtype and an f32 or x-dtype output, got "
                         f"{x.dtype}, {w.dtype} -> {out_dtype}")
    if any(d % ROW_TILE for d in (t, k, n, bm)):
        raise ValueError(f"grouped_matmul_cuda needs T, K, N and the row "
                         f"tile % {ROW_TILE} == 0, got {t}, {k}, {n}, {bm}")
    gid = tile_gid.to(torch.int32).contiguous()
    tensors = [x, gid, w]
    nrow = None
    if num_rows is not None:
        nrow = num_rows.reshape(1).to(torch.int32).contiguous()
        tensors.append(nrow)
    _build.require_cuda("grouped_matmul_cuda", *tensors)
    hopper = x.dtype == torch.bfloat16 and transpose_w
    if hopper:
        args, out, _plan = gmm_hopper_args(x, gid, w, out_dtype, nrow)
    else:
        out = torch.empty((t, n), dtype=out_dtype, device=x.device)
        args = (int(x.dtype == torch.bfloat16), int(transpose_w),
                int(out_dtype == torch.float32), x.data_ptr(),
                gid.data_ptr(), bm, None if nrow is None else nrow.data_ptr(),
                w.data_ptr(), out.data_ptr(), t, k, n, _build.stream_of(x))
    name = "fm_grouped_matmul_hopper" if hopper else "fm_grouped_matmul"
    with torch.cuda.device(x.device):
        err = getattr(_build.library(), name)(*args)
    _build.check(err, name)
    grouped_matmul_cuda.launches += 1
    grouped_matmul_cuda.hopper_launches += hopper
    return out


grouped_matmul_cuda.launches = 0
grouped_matmul_cuda.hopper_launches = 0


def grouped_matmul(x, tile_gid, w, *, transpose_w: bool = False,
                   out_dtype=None, num_rows=None,
                   use_kernels: bool | None = None):
    """The grouped matmul: the kernel on CUDA tensors, the plain version
    on CPU ones (or with ``use_kernels=False``)."""
    fn = grouped_matmul_cuda if _build.use_kernels_for(x, use_kernels) \
        else grouped_matmul_plain
    return fn(x, tile_gid, w, transpose_w=transpose_w, out_dtype=out_dtype,
              num_rows=num_rows)


def _check_tgmm(x, dy):
    if x.shape[0] != dy.shape[0]:
        raise ValueError(f"row mismatch {x.shape[0]} vs {dy.shape[0]}")


def tgmm_plain(x, dy, tile_gid, num_experts: int, *, num_rows=None):
    """Plain torch version of the transposed grouped matmul: dW[E, K, N] =
    per expert, the sum over its rows of x[r]^T dy[r], in f32.  An expert
    that owns no live row gets exactly 0."""
    _check_tgmm(x, dy)
    bm = _tile_rows(x, tile_gid)
    row_gid = _row_gid(tile_gid, bm, x.shape[0], num_rows)
    dw = torch.zeros((num_experts, x.shape[1], dy.shape[1]),
                     dtype=torch.float32, device=x.device)
    for e in torch.unique(row_gid).tolist():
        rows = torch.nonzero(row_gid == e).reshape(-1)
        dw[e] = dot_f32(x[rows].T, dy[rows])
    return dw


def tgmm_cuda(x, dy, tile_gid, num_experts: int, *, num_rows=None):
    """The transposed grouped matmul kernel (``csrc/tgmm.cu``) on CUDA
    tensors: :func:`tgmm_plain`'s function.  ``tile_gid`` must be
    nondecreasing (the capacity and ragged layouts are expert-major); each
    expert's row range comes from a searchsorted over it, cut at
    ``num_rows``.  x and dy bf16 or f32 of one dtype; K, N and the row
    tile must be multiples of 64."""
    _build.refuse_autograd("tgmm_cuda", x, dy)
    _check_tgmm(x, dy)
    bm = _tile_rows(x, tile_gid)
    t, k = x.shape
    n = dy.shape[1]
    if x.dtype not in (torch.bfloat16, torch.float32) or dy.dtype != x.dtype:
        raise ValueError(f"tgmm_cuda takes bf16 or f32 x and dy of one "
                         f"dtype, got {x.dtype}, {dy.dtype}")
    if any(d % ROW_TILE for d in (k, n, bm)):
        raise ValueError(f"tgmm_cuda needs K, N and the row tile % "
                         f"{ROW_TILE} == 0, got {k}, {n}, {bm}")
    gid = tile_gid.long()
    experts = torch.arange(num_experts, device=gid.device)
    start = torch.searchsorted(gid, experts) * bm
    end = torch.searchsorted(gid, experts, right=True) * bm
    if num_rows is not None:
        live = (num_rows.reshape(()).long() + bm - 1) // bm * bm
        end = torch.minimum(end, live)
        start = torch.minimum(start, end)
    start = start.to(torch.int32)
    end = end.to(torch.int32)
    _build.require_cuda("tgmm_cuda", x, dy, start, end)
    dw = torch.empty((num_experts, k, n), dtype=torch.float32,
                     device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.fm_tgmm(int(x.dtype == torch.bfloat16), x.data_ptr(),
                          dy.data_ptr(), start.data_ptr(), end.data_ptr(),
                          dw.data_ptr(), num_experts, k, n,
                          _build.stream_of(x))
    _build.check(err, "fm_tgmm")
    tgmm_cuda.launches += 1
    return dw


tgmm_cuda.launches = 0


def tgmm(x, dy, tile_gid, num_experts: int, *, num_rows=None,
         use_kernels: bool | None = None):
    """The transposed grouped matmul: the kernel on CUDA tensors, the
    plain version on CPU ones (or with ``use_kernels=False``)."""
    fn = tgmm_cuda if _build.use_kernels_for(x, use_kernels) else tgmm_plain
    return fn(x, dy, tile_gid, num_experts, num_rows=num_rows)


def segment_bias_grad(d, tile_gid, num_experts: int):
    """db[E, N] = per-expert row sum of d[T, N]: tile sums, then a one-hot
    product (``_segment_bias_grad``; no atomics, so the order is fixed)."""
    nt = tile_gid.numel()
    per_tile = d.reshape(nt, -1, d.shape[-1]).sum(1)
    oh = torch.nn.functional.one_hot(tile_gid.long(), num_experts).to(
        per_tile.dtype)
    return torch.einsum("tn,te->en", per_tile, oh)


# ----------------------------------------------------------------------
# residual-saving forward + backward: the training path
# ----------------------------------------------------------------------

def ffn_backward_core(x, tile_gid, w_up, w_down, w_gate, u, g, dy, *,
                      act_name: str, gated: bool, num_rows=None,
                      use_kernels: bool | None = None):
    """The grouped FFN's backward over the pre-activation residuals (u, g)
    (``ffn_backward_core``).  dHidden and dX run on the grouped matmul
    (weights contracted on their last dim), the weight gradients on the
    transposed grouped matmul; the activation's derivative is torch
    autograd of :func:`activation_fn`.  Rounding as the JAX function: dy,
    d_gate and d_up cast to x's dtype before the GEMMs, hidden recomputed
    as ``(act(g) * u)`` in x's dtype.  Returns f32 ``(dx, d_wu, d_bu, d_wd,
    d_bd, d_wg)``, d_wg None when not gated."""
    act = activation_fn(act_name)
    e = w_up.shape[0]
    dt = x.dtype
    kw = dict(num_rows=num_rows, use_kernels=use_kernels)
    dyc = dy.to(dt)

    def vjp(pre, ct):
        """act(pre) and its cotangent ct through act."""
        with torch.enable_grad():
            leaf = pre.detach().requires_grad_(True)
            val = act(leaf)
            (grad,) = torch.autograd.grad(val, leaf, ct)
        return val.detach(), grad

    # dHidden = dy @ w_down^T   [T, I]
    d_hidden = grouped_matmul(dyc, tile_gid, w_down, transpose_w=True,
                              out_dtype=torch.float32, **kw)
    uf = u.float()
    if gated:
        act_g, d_gate = vjp(g.float(), d_hidden * uf)
        d_up = d_hidden * act_g
        hidden = (act_g * uf).to(dt)
        d_gate_c = d_gate.to(dt)
        dx = grouped_matmul(d_gate_c, tile_gid, w_gate, transpose_w=True,
                            out_dtype=torch.float32, **kw) \
            + grouped_matmul(d_up.to(dt), tile_gid, w_up, transpose_w=True,
                             out_dtype=torch.float32, **kw)
        d_wg = tgmm(x, d_gate_c, tile_gid, e, **kw)
    else:
        act_u, d_up = vjp(uf, d_hidden)
        hidden = act_u.to(dt)
        dx = grouped_matmul(d_up.to(dt), tile_gid, w_up, transpose_w=True,
                            out_dtype=torch.float32, **kw)
        d_wg = None
    d_wu = tgmm(x, d_up.to(dt), tile_gid, e, **kw)
    d_wd = tgmm(hidden, dyc, tile_gid, e, **kw)
    d_bu = segment_bias_grad(d_up, tile_gid, e)
    d_bd = segment_bias_grad(dy.float(), tile_gid, e)
    return dx, d_wu, d_bu, d_wd, d_bd, d_wg


class _GroupedFFNAD(torch.autograd.Function):
    """Forward: the residual-saving FFN (kernel or plain); backward:
    :func:`ffn_backward_core`.  Gradient dtypes follow ``_gffn_bwd``."""

    @staticmethod
    def forward(ctx, x, tile_gid, w_up, b_up, w_down, b_down, w_gate,
                act_name, gated, block_m, num_rows, use_kernels):
        res = grouped_ffn_res_cuda if use_kernels else grouped_ffn_res_plain
        y, u, g = res(x, tile_gid, w_up, b_up, w_down, b_down, w_gate,
                      act_name=act_name, gated=gated, block_m=block_m,
                      num_rows=num_rows)
        ctx.save_for_backward(x, tile_gid, w_up, w_down, w_gate, u, g,
                              num_rows)
        ctx.conf = (act_name, gated, use_kernels, b_up.dtype, b_down.dtype)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, tile_gid, w_up, w_down, w_gate, u, g, num_rows = ctx.saved_tensors
        act_name, gated, use_kernels, bu_dt, bd_dt = ctx.conf
        dx, d_wu, d_bu, d_wd, d_bd, d_wg = ffn_backward_core(
            x, tile_gid, w_up, w_down, w_gate, u, g, dy.contiguous(),
            act_name=act_name, gated=gated, num_rows=num_rows,
            use_kernels=use_kernels)
        return (dx.to(x.dtype), None, d_wu.to(w_up.dtype), d_bu.to(bu_dt),
                d_wd.to(w_down.dtype), d_bd.to(bd_dt),
                d_wg.to(w_gate.dtype) if gated else None,
                None, None, None, None, None)


def grouped_ffn_ad(x, tile_gid, w_up, b_up, w_down, b_down, w_gate=None, *,
                   act_name: str, gated: bool = False,
                   block_m: int = ROW_TILE, num_rows=None,
                   use_kernels: bool | None = None):
    """Differentiable grouped FFN (:func:`grouped_ffn`'s arguments).

    With grad enabled and an input requiring grad, a
    ``torch.autograd.Function``: the residual-saving forward (kernel on
    CUDA tensors, plain version on CPU ones or with ``use_kernels=False``)
    saves x, the weights and the pre-activations u and g, and the backward
    is :func:`ffn_backward_core` on the grouped matmul and transposed
    grouped matmul.  Otherwise plain :func:`grouped_ffn`, as JAX's
    ``custom_vjp`` primal."""
    uk = _build.use_kernels_for(x, use_kernels)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, w_up, b_up, w_down, b_down, w_gate)):
        return _GroupedFFNAD.apply(x, tile_gid, w_up, b_up, w_down, b_down,
                                   w_gate, act_name, gated, block_m,
                                   num_rows, uk)
    return grouped_ffn(x, tile_gid, w_up, b_up, w_down, b_down, w_gate,
                       act_name=act_name, gated=gated, block_m=block_m,
                       num_rows=num_rows, use_kernels=uk)


class _GroupedFFNTokensAD(torch.autograd.Function):
    """Forward: the gather-fused FFN (kernel or plain), which keeps no
    residuals.  Backward (``_gft_bwd``): the layout's rows re-gathered from
    x, the cotangent pulled back through :func:`grouped_ffn_ad` (the
    residual-saving forward again, then its grouped-matmul backward), and
    dX scatter-added to token order in f32 before the cast to x's dtype."""

    @staticmethod
    def forward(ctx, x, src_tok, tile_gid, w_up, b_up, w_down, b_down,
                w_gate, act_name, gated, block_m, num_rows, use_kernels):
        fn = grouped_ffn_tokens_cuda if use_kernels \
            else grouped_ffn_tokens_plain
        y = fn(x, src_tok, tile_gid, w_up, b_up, w_down, b_down, w_gate,
               act_name=act_name, gated=gated, block_m=block_m,
               num_rows=num_rows)
        ctx.save_for_backward(x, src_tok, tile_gid, w_up, b_up, w_down,
                              b_down, w_gate, num_rows)
        ctx.conf = (act_name, gated, block_m, use_kernels)
        return y

    @staticmethod
    def backward(ctx, dy):
        (x, src_tok, tile_gid, w_up, b_up, w_down, b_down, w_gate,
         num_rows) = ctx.saved_tensors
        act_name, gated, block_m, use_kernels = ctx.conf
        src = src_tok.long()
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_(True)
                      for t in (x[src], w_up, b_up, w_down, b_down, w_gate)]
            y = grouped_ffn_ad(
                leaves[0], tile_gid, *leaves[1:], act_name=act_name,
                gated=gated, block_m=block_m, num_rows=num_rows,
                use_kernels=use_kernels)
            wrt = [t for t in leaves if t is not None]
            grads = list(torch.autograd.grad(y, wrt, dy))
        dxb, d_wu, d_bu, d_wd, d_bd = grads[:5]
        d_wg = grads[5] if gated else None
        dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        dx.index_add_(0, src, dxb.float())
        return (dx.to(x.dtype), None, None, d_wu, d_bu, d_wd, d_bd, d_wg,
                None, None, None, None, None)


def grouped_ffn_tokens_ad(x, src_tok, tile_gid, w_up, b_up, w_down, b_down,
                          w_gate=None, *, act_name: str, gated: bool = False,
                          block_m: int = ROW_TILE, num_rows=None,
                          use_kernels: bool | None = None):
    """Differentiable gather-fused FFN (:func:`grouped_ffn_tokens`'s
    arguments).  With grad enabled and an input requiring grad, a
    ``torch.autograd.Function`` whose backward re-gathers and reuses
    :func:`grouped_ffn_ad` (one forward recomputed, paid only by whoever
    differentiates the inference path); otherwise plain
    :func:`grouped_ffn_tokens`."""
    uk = _build.use_kernels_for(x, use_kernels)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, w_up, b_up, w_down, b_down, w_gate)):
        return _GroupedFFNTokensAD.apply(x, src_tok, tile_gid, w_up, b_up,
                                         w_down, b_down, w_gate, act_name,
                                         gated, block_m, num_rows, uk)
    return grouped_ffn_tokens(x, src_tok, tile_gid, w_up, b_up, w_down,
                              b_down, w_gate, act_name=act_name, gated=gated,
                              block_m=block_m, num_rows=num_rows,
                              use_kernels=uk)


def _capacity_tiling(c: int) -> tuple[int, int]:
    """``(block_m, padded_capacity)`` for a capacity buffer: the kernel's
    row tile, and the capacity rounded up to it.  (The JAX version
    consults a TPU-measured tuning table, which does not carry over.)"""
    bm = ROW_TILE
    return bm, ((c + bm - 1) // bm) * bm


def _capacity_grouped(ffn, xs, params, cfg: MoEConfig, use_kernels):
    """``ffn`` (grouped_ffn or grouped_ffn_ad) on an [E, C, H] capacity
    buffer.  The buffer is expert-major, so the expert of row tile t is
    t // (Cp / block_m); C is padded up to the row tile and the pad rows
    dropped again."""
    e, c, h = xs.shape
    bm, cp = _capacity_tiling(c)
    if cp != c:
        xs = torch.nn.functional.pad(xs, (0, 0, 0, cp - c))
    x = xs.reshape(e * cp, h)
    tiles_per_e = cp // bm
    tile_gid = torch.arange(e * tiles_per_e, device=x.device) // tiles_per_e
    dt = x.dtype
    out = ffn(
        x, tile_gid, params["w_up"].to(dt), params["b_up"],
        params["w_down"].to(dt), params["b_down"],
        params["w_gate"].to(dt) if cfg.gated_ffn else None,
        act_name=cfg.hidden_act, gated=cfg.gated_ffn, block_m=bm,
        use_kernels=use_kernels)
    return out.reshape(e, cp, h)[:, :c, :]


def capacity_buffer_ffn(xs, params, cfg: MoEConfig,
                        use_kernels: bool | None = None):
    """The grouped FFN on an [E, C, H] capacity buffer."""
    return _capacity_grouped(grouped_ffn, xs, params, cfg, use_kernels)


def capacity_buffer_ffn_ad(xs, params, cfg: MoEConfig,
                           use_kernels: bool | None = None):
    """The differentiable grouped FFN (:func:`grouped_ffn_ad`) on an
    [E, C, H] capacity buffer; autograd flows through the reshapes."""
    return _capacity_grouped(grouped_ffn_ad, xs, params, cfg, use_kernels)


def capacity_ffn_gather(x, plan, cfg: MoEConfig, capacity: int, params, *,
                        use_kernels: bool | None = None):
    """The capacity arm's FFN with the dispatch gather fused into the
    kernel (differentiable through :func:`grouped_ffn_tokens_ad`): the
    capacity padded to the row tile, each slot's source token from the
    plan.  Returns ``([E, Cp, H], Cp)``; the combine must take the padded
    capacity Cp so that flat slot indices line up.  Cp is the port's own
    (:func:`_capacity_tiling`), so it may differ from the JAX package's."""
    e, h = cfg.num_experts, x.shape[1]
    bm, cp = _capacity_tiling(capacity)
    src_tok, _ = dsp.dispatch_indices(plan, cfg, cp)
    tiles_per_e = cp // bm
    tile_gid = torch.arange(e * tiles_per_e, device=x.device) // tiles_per_e
    dt = x.dtype
    y = grouped_ffn_tokens_ad(
        x, src_tok.reshape(-1), tile_gid, params["w_up"].to(dt),
        params["b_up"], params["w_down"].to(dt), params["b_down"],
        params["w_gate"].to(dt) if cfg.gated_ffn else None,
        act_name=cfg.hidden_act, gated=cfg.gated_ffn, block_m=bm,
        use_kernels=use_kernels)
    return y.reshape(e, cp, h), cp
