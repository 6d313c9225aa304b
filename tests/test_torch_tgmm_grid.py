"""PyTorch port: the pure-Python schedule of the Hopper transposed grouped
matmul (CPU).  The bf16 B8 kernel (``csrc/tgmm.cu``: ``tgmm_hopper``)
walks output tiles of 128 K-rows by 256 N-columns of each expert on a
persistent grid, each tile summing its expert's 64-row steps in order;
here that walk (``tgmm_tile_walk``) is held against a brute-force
expectation, and the function it implies (``tgmm_walk_plain``) against
the JAX package's ``tgmm`` (Pallas, interpret mode) and the port's
``tgmm_plain`` on the same numpy inputs, f32 at tests/test_expert.py's
2e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashmoe_tpu.ops import expert as jexp
from flashmoe_tpu_torch.ops import expert as texp

ROW = texp.ROW_TILE
TOL = 2e-4  # f32 sums of the same products in another order


def _plan(rng, e, max_tiles):
    """A nondecreasing tile_gid over ``e`` experts, some with no tile."""
    counts = rng.integers(0, max_tiles + 1, e)
    counts[rng.integers(0, e)] = 0
    if counts.sum() == 0:
        counts[-1] = 1
    return np.repeat(np.arange(e), counts).astype(np.int32)


def _ranges(gid, e, num_rows):
    start, end = texp.tgmm_row_ranges(
        torch.from_numpy(gid), ROW, e,
        None if num_rows is None else torch.tensor(num_rows))
    return start.tolist(), end.tolist()


@pytest.mark.parametrize("sms", [1, 7, 132])
def test_tgmm_tile_walk_covers_every_output_once(sms):
    """Random plans (experts with no tiles, live-row cuts that are
    multiples of 64), K and N of 64 x odd (tiles overhanging both edges)
    and of whole tiles, grids of 1, 7 and 132 blocks: every element of
    [E, K, N] lies in exactly one tile; tiles go to blocks round robin in
    the order (expert, k tile, n tile) with n fastest; a tile's row steps
    are its expert's live 64-row tiles in increasing order, none for an
    expert without live rows."""
    rng = np.random.default_rng(sms)
    for case in range(40):
        e = int(rng.integers(1, 9))
        gid = _plan(rng, e, 4)
        rows = gid.size * ROW
        k = 64 * int(rng.choice([1, 3, 5, 4, 6]))
        n = 64 * int(rng.choice([1, 3, 7, 4, 8]))
        num_rows = None if case % 3 == 0 else \
            int(rng.integers(0, gid.size + 1)) * ROW
        start, end = _ranges(gid, e, num_rows)
        walk = texp.tgmm_tile_walk(start, end, k, n, sms)
        kt, nt = -(-k // texp.TGMM_ROWS), -(-n // texp.HOPPER_COLS)
        assert len(walk) == e * kt * nt == texp.tgmm_tiles(e, k, n)
        grid = min(len(walk), sms)
        seen = np.zeros((e, k // 64, n // 64), int)
        live = rows if num_rows is None else num_rows
        for t, (block, ex, k0, k1, n0, n1, steps) in enumerate(walk):
            assert block == t % grid
            assert (ex, k0 // texp.TGMM_ROWS, n0 // texp.HOPPER_COLS) == (
                t // (kt * nt), t % (kt * nt) // nt, t % nt)
            assert k1 == min(k0 + texp.TGMM_ROWS, k)
            assert n1 == min(n0 + texp.HOPPER_COLS, n)
            seen[ex, k0 // 64:k1 // 64, n0 // 64:n1 // 64] += 1
            own = [r for r in range(0, min(live, rows), ROW)
                   if gid[r // ROW] == ex]
            assert [r0 for r0, _ in steps] == own
            assert all(r1 - r0 == ROW for r0, r1 in steps)
        assert (seen == 1).all()


@pytest.mark.parametrize("k,n,gid", [
    (192, 320, (0, 0, 2, 2, 2)),
    (320, 192, (1, 1, 1, 1, 3)),
    (256, 512, (0, 2, 2, 3)),
], ids=["k192_n320_e1_empty", "k320_n192_e0_e2_empty", "whole_tiles"])
def test_tgmm_walk_computes_jax_tgmm(k, n, gid):
    """The walk's function (each tile the f32 sum of its row steps)
    against JAX's interpret-mode ``tgmm``, which zeroes experts absent
    from tile_gid: K or N of 64 x odd, experts with no rows (exactly 0 in
    both), grids of 3 and 132 blocks."""
    e = 4
    gid = np.asarray(gid, np.int32)
    rng = np.random.default_rng(k + n)
    x = rng.standard_normal((gid.size * ROW, k)).astype(np.float32)
    dy = rng.standard_normal((gid.size * ROW, n)).astype(np.float32)
    want = np.asarray(jexp.tgmm(jnp.asarray(x), jnp.asarray(dy),
                                jnp.asarray(gid), e, block_m=ROW,
                                interpret=True))
    start, end = _ranges(gid, e, None)
    for sms in (3, 132):
        walk = texp.tgmm_tile_walk(start, end, k, n, sms)
        got = texp.tgmm_walk_plain(torch.from_numpy(x), torch.from_numpy(dy),
                                   walk, e).numpy()
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
        for ex in set(range(e)) - set(gid.tolist()):
            assert not got[ex].any()


@pytest.mark.parametrize("live", [0, 2, 4, 7])
def test_tgmm_walk_honours_num_rows(live):
    """A live-row cut (``num_rows``, whole 64-row tiles): the walk's
    function equals the port's ``tgmm_plain`` with the same cut, experts
    whose rows all lie past it exactly 0; rows past the cut are NaN and
    must not be read."""
    e, k, n = 3, 192, 320
    gid = np.array([0, 0, 1, 1, 1, 2, 2], np.int32)
    rng = np.random.default_rng(live)
    x = rng.standard_normal((gid.size * ROW, k)).astype(np.float32)
    dy = rng.standard_normal((gid.size * ROW, n)).astype(np.float32)
    x[live * ROW:] = np.nan
    xt, dyt = torch.from_numpy(x), torch.from_numpy(dy)
    nrow = torch.tensor(live * ROW)
    want = texp.tgmm_plain(xt, dyt, torch.from_numpy(gid), e, num_rows=nrow)
    start, end = _ranges(gid, e, live * ROW)
    got = texp.tgmm_walk_plain(xt, dyt, texp.tgmm_tile_walk(
        start, end, k, n, 5), e)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL,
                               atol=TOL)
    for ex in set(range(e)) - set(gid[:live].tolist()):
        assert not got[ex].any()
