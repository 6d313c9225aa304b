"""Grouped expert FFN: up GEMM -> (+bias) -> activation -> down GEMM -> (+bias).

Counterpart of the forward entries of ``flashmoe_tpu/ops/expert.py``:

* :func:`expert_ffn_dense`, the batched per-expert FFN over an [E, C, H]
  capacity buffer (plain torch, as the JAX XLA path);
* :func:`grouped_ffn`, the FFN over expert-sorted rows with one expert id
  per row tile: :func:`grouped_ffn_cuda` launches the hand-written Hopper
  kernel of ``csrc/grouped_ffn.cu`` (the port of ``_ffn_kernel``), and
  :func:`grouped_ffn_plain` is its plain torch version;
* :func:`capacity_buffer_ffn`, the grouped FFN over a capacity buffer.

Every weight is taken in the input dtype (the callers cast), so a gated
FFN's gate GEMM runs in the same dtype as its up GEMM.
"""

from __future__ import annotations

import torch

from flashmoe_tpu_torch.config import Activation, MoEConfig
from flashmoe_tpu_torch.kernels import _build
from flashmoe_tpu_torch.models.reference import activation_fn, dot_f32

#: row tile of the CUDA kernel (csrc/grouped_ffn.cu FBM); the plans' block
#: must be a multiple of it
ROW_TILE = 64
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
                    block_m):
    t, h = x.shape
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


def grouped_ffn_plain(x, tile_gid, w_up, b_up, w_down, b_down, w_gate=None,
                      *, act_name: str, gated: bool = False, block_m: int,
                      num_rows=None):
    """Plain torch version of the grouped FFN (see :func:`grouped_ffn`).

    The down GEMM accumulates in f32 over chunks of the intermediate
    dimension, as the TPU kernel's grid did."""
    _check_ffn_args(x, tile_gid, w_up, b_up, w_down, b_down, w_gate, gated,
                    block_m)
    act = activation_fn(act_name)
    t, h = x.shape
    i = w_up.shape[2]
    bi = _auto_block(i, PLAIN_BLOCK_I)
    live = t if num_rows is None else int(num_rows)
    row_gid = tile_gid.long().repeat_interleave(block_m)[:live]
    out = torch.zeros((t, h), dtype=x.dtype, device=x.device)
    for e in torch.unique(row_gid).tolist():
        rows = torch.nonzero(row_gid == e).reshape(-1)
        xe = x[rows]
        up = dot_f32(xe, w_up[e]) + b_up[e].float()
        if gated:
            hidden = act(dot_f32(xe, w_gate[e])) * up
        else:
            hidden = act(up)
        hidden = hidden.to(x.dtype)
        acc = torch.zeros((rows.numel(), h), dtype=torch.float32,
                          device=x.device)
        for j in range(0, i, bi):
            acc += dot_f32(hidden[:, j:j + bi], w_down[e, j:j + bi])
        out[rows] = (acc + b_down[e].float()).to(x.dtype)
    return out


def grouped_ffn_cuda(x, tile_gid, w_up, b_up, w_down, b_down, w_gate=None,
                     *, act_name: str, gated: bool = False, block_m: int,
                     num_rows=None):
    """The grouped FFN kernel (``csrc/grouped_ffn.cu``) on CUDA tensors.

    x bf16 or f32, every weight in x's dtype, biases of any float dtype
    (added in f32).  T, H, I and block_m must be multiples of 64.  Rows at
    or past ``num_rows`` (a 0-d or [1] integer tensor) come back zero."""
    _check_ffn_args(x, tile_gid, w_up, b_up, w_down, b_down, w_gate, gated,
                    block_m)
    t, h = x.shape
    i = w_up.shape[2]
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"grouped_ffn_cuda takes bf16 or f32, got {x.dtype}")
    weights = [w_up, w_down] + ([w_gate] if gated else [])
    if any(w.dtype != x.dtype for w in weights):
        raise ValueError("grouped_ffn_cuda: weights must have x's dtype")
    if any(d % ROW_TILE for d in (t, h, i, block_m)):
        raise ValueError(f"grouped_ffn_cuda needs T, H, I, block_m % "
                         f"{ROW_TILE} == 0, got {t}, {h}, {i}, {block_m}")
    gid = tile_gid.to(torch.int32).contiguous()
    b_up32 = b_up.float().contiguous()
    b_down32 = b_down.float().contiguous()
    tensors = [x, gid, b_up32, b_down32, *weights]
    nrow = None
    if num_rows is not None:
        nrow = num_rows.reshape(1).to(torch.int32).contiguous()
        tensors.append(nrow)
    _build.require_cuda("grouped_ffn_cuda", *tensors)
    hidden = torch.empty((t, i), dtype=x.dtype, device=x.device)
    out = torch.empty((t, h), dtype=x.dtype, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.fm_grouped_ffn(
            int(x.dtype == torch.bfloat16), int(gated), _ACT_CODE[act_name],
            x.data_ptr(), gid.data_ptr(), block_m,
            None if nrow is None else nrow.data_ptr(), w_up.data_ptr(),
            w_gate.data_ptr() if gated else None, b_up32.data_ptr(),
            w_down.data_ptr(), b_down32.data_ptr(), hidden.data_ptr(),
            out.data_ptr(), t, h, i, _build.stream_of(x))
    _build.check(err, "fm_grouped_ffn")
    grouped_ffn_cuda.launches += 1
    return out


grouped_ffn_cuda.launches = 0


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
    ``use_kernels=False``)."""
    fn = grouped_ffn_cuda if _build.use_kernels_for(x, use_kernels) \
        else grouped_ffn_plain
    return fn(x, tile_gid, w_up, b_up, w_down, b_down, w_gate,
              act_name=act_name, gated=gated, block_m=block_m,
              num_rows=num_rows)


def _capacity_tiling(c: int) -> tuple[int, int]:
    """``(block_m, padded_capacity)`` for a capacity buffer: the kernel's
    row tile, and the capacity rounded up to it.  (The JAX version
    consults a TPU-measured tuning table, which does not carry over.)"""
    bm = ROW_TILE
    return bm, ((c + bm - 1) // bm) * bm


def capacity_buffer_ffn(xs, params, cfg: MoEConfig,
                        use_kernels: bool | None = None):
    """The grouped FFN on an [E, C, H] capacity buffer.  The buffer is
    expert-major, so the expert of row tile t is t // (Cp / block_m); C is
    padded up to the row tile and the pad rows dropped again."""
    e, c, h = xs.shape
    bm, cp = _capacity_tiling(c)
    if cp != c:
        xs = torch.nn.functional.pad(xs, (0, 0, 0, cp - c))
    x = xs.reshape(e * cp, h)
    tiles_per_e = cp // bm
    tile_gid = torch.arange(e * tiles_per_e, device=x.device) // tiles_per_e
    dt = x.dtype
    out = grouped_ffn(
        x, tile_gid, params["w_up"].to(dt), params["b_up"],
        params["w_down"].to(dt), params["b_down"],
        params["w_gate"].to(dt) if cfg.gated_ffn else None,
        act_name=cfg.hidden_act, gated=cfg.gated_ffn, block_m=bm,
        use_kernels=use_kernels)
    return out.reshape(e, cp, h)[:, :c, :]
