"""PyTorch port: the pure-Python schedule of the Hopper grouped matmul
(CPU) and its dead-tile rule.  The bf16 B7 kernel
(``csrc/grouped_matmul.cu``: ``gmm_hopper``, both layouts of w) walks the
items of its work list against 256-column blocks, item-fastest, on a
persistent grid; here that walk (``gmm_tile_walk``) is held against a
brute-force expectation, and
the function it implies (``gmm_walk_plain``: f32 sums in K steps of 64)
against the JAX package's ``grouped_matmul(transpose_w=False)`` (Pallas,
interpret mode) on the same numpy inputs, f32 at tests/test_expert.py's
2e-4.  A ``tile_gid`` entry of -1 marks a dead tile: zeros on its rows,
every other row unchanged (``gmm_work_list``, ``grouped_matmul_plain``)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashmoe_tpu.ops import expert as jexp
from flashmoe_tpu_torch.ops import expert as texp

ROW = texp.ROW_TILE
TOL = 2e-4  # f32 sums of the same products in another order


def _row_experts(gid, block_m, rows, num_rows):
    """Brute force: the expert of every row, -1 on dead tiles and past
    num_rows."""
    e = np.repeat(gid, block_m)[:rows].astype(int)
    if num_rows is not None:
        e[num_rows:] = -1
    return e


def _random_plan(rng, case):
    """A random tile map (sorted or not, some experts without tiles, some
    tiles dead), its row tile, rows and live-row cut."""
    bm = ROW * int(rng.choice([1, 2]))
    nt = int(rng.integers(1, 30))
    gid = rng.integers(0, int(rng.integers(1, 9)), nt).astype(np.int32)
    if case % 2:
        gid = np.sort(gid)
    gid[rng.random(nt) < 0.3] = -1
    rows = nt * bm
    num_rows = None if case % 3 == 0 else \
        int(rng.integers(0, rows // ROW + 1)) * ROW
    return gid, bm, rows, num_rows


def _nrow(num_rows):
    return None if num_rows is None else torch.tensor(num_rows)


@pytest.mark.parametrize("sms", [1, 7, 132])
def test_gmm_tile_walk_covers_every_output_once(sms):
    """Random plans with dead tiles and live-row cuts, N of 64 x odd and
    of whole blocks, grids of 1, 7 and 132 SMs: every 64 x 64 block of
    the output lies in exactly one tile; tiles run over every 256-column
    block (cut at N) in turn, ``gmm_work_list``'s items fastest; tile t
    goes to block t % grid, grid the largest count <= the launched blocks
    coprime to the item count; every row of a tile has the tile's expert
    (-1 on dead tiles and past num_rows)."""
    rng = np.random.default_rng(sms)
    for case in range(60):
        gid, bm, rows, num_rows = _random_plan(rng, case)
        n = 64 * int(rng.choice([1, 3, 4, 5, 8]))
        walk = texp.gmm_tile_walk(torch.from_numpy(gid), bm, rows, n, sms,
                                  _nrow(num_rows))
        items = texp.gmm_work_list(torch.from_numpy(gid), bm, rows,
                                   _nrow(num_rows))
        ncols = -(-n // texp.HOPPER_COLS)
        assert len(walk) == len(items) * ncols
        launched = min(rows // ROW * ncols, sms)
        grid = max(g for g in range(1, launched + 1)
                   if math.gcd(g, len(items)) == 1)
        order = [(i, c) for c in range(ncols) for i in range(len(items))]
        experts = _row_experts(gid, bm, rows, num_rows)
        seen = np.zeros((rows // ROW, n // 64), int)
        for t, (block, t0, tiles, e, n0, n1) in enumerate(walk):
            item, col = order[t]
            assert block == t % grid
            assert (t0, tiles, e) == items[item]
            assert (n0, n1) == (col * texp.HOPPER_COLS,
                                min(n0 + texp.HOPPER_COLS, n))
            assert (experts[t0 * ROW:(t0 + tiles) * ROW] == e).all()
            seen[t0:t0 + tiles, n0 // 64:n1 // 64] += 1
        assert (seen == 1).all()



@pytest.mark.parametrize("k,n,gid,dead", [
    (192, 320, (0, 0, 2, 2, 2), (1, 4)),
    (320, 192, (1, 1, 1, 1, 3), (0, 1, 2, 3, 4)),
    (256, 512, (0, 2, 2, 3), ()),
    (64, 64, (3, 0, 0, 1, 1, 1), (2,)),
], ids=["k192_n320", "k320_n192_all_dead", "whole_blocks", "k64_unsorted"])
def test_gmm_walk_computes_jax_grouped_matmul(k, n, gid, dead):
    """The walk's function (each tile the f32 sum of its K steps of 64)
    against JAX's interpret-mode ``grouped_matmul`` with w [E, K, N]: K
    or N not multiples of 256, experts with no rows; the tiles marked
    dead (-1 in the port's map) exactly 0 and every other row as JAX's,
    on grids of 3 and 132 blocks."""
    e = 4
    gid = np.asarray(gid, np.int32)
    rng = np.random.default_rng(k + n)
    x = rng.standard_normal((gid.size * ROW, k)).astype(np.float32)
    w = rng.standard_normal((e, k, n)).astype(np.float32)
    want = np.array(jexp.grouped_matmul(
        jnp.asarray(x), jnp.asarray(gid), jnp.asarray(w), block_m=ROW,
        out_dtype=jnp.float32, interpret=True))
    live = gid.copy()
    live[list(dead)] = -1
    rows_dead = np.repeat(live < 0, ROW)
    want[rows_dead] = 0.0
    for sms in (3, 132):
        walk = texp.gmm_tile_walk(torch.from_numpy(live), ROW, x.shape[0],
                                  n, sms)
        got = texp.gmm_walk_plain(torch.from_numpy(x), torch.from_numpy(w),
                                  walk).numpy()
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
        assert not got[rows_dead].any()


@pytest.mark.parametrize("transpose_w", [False, True], ids=["w", "wT"])
def test_dead_tiles_zero_their_rows_only(transpose_w):
    """Brute force of the -1 rule on random plans: ``gmm_work_list``'s
    items of dead tiles have expert -1 and every other item its tiles'
    expert; ``grouped_matmul_plain`` returns exact zeros on the rows of
    dead tiles and past num_rows, and on every other row exactly what the
    full map gives (in both layouts of w)."""
    rng = np.random.default_rng(11 + transpose_w)
    k, n, e = 64, 128, 8
    for case in range(20):
        gid, bm, rows, num_rows = _random_plan(rng, case)
        full = np.where(gid < 0, rng.integers(0, e, gid.size), gid)
        full = full.astype(np.int32)
        experts = _row_experts(gid, bm, rows, num_rows)
        for t0, tiles, ex in texp.gmm_work_list(
                torch.from_numpy(gid), bm, rows, _nrow(num_rows)):
            assert (experts[t0 * ROW:(t0 + tiles) * ROW] == ex).all()
        x = torch.from_numpy(rng.standard_normal((rows, k)).astype(
            np.float32))
        w = torch.from_numpy(rng.standard_normal(
            (e, n, k) if transpose_w else (e, k, n)).astype(np.float32))
        kw = dict(transpose_w=transpose_w, out_dtype=torch.float32,
                  num_rows=_nrow(num_rows))
        got = texp.grouped_matmul_plain(x, torch.from_numpy(gid), w, **kw)
        ref = texp.grouped_matmul_plain(x, torch.from_numpy(full), w, **kw)
        dead = torch.from_numpy(experts < 0)
        assert not got[dead].any()
        assert torch.equal(got[~dead], ref[~dead])
