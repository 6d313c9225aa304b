"""PyTorch port: the pure-Python schedules of the two-pass gate's Hopper
kernels (CPU).  bf16 pass 1 (B4a, ``csrc/gate_tiled.cu``:
``gate_pass1_hopper``) walks 64-token tiles on a persistent grid, each
against all experts in 256-expert tiles whose columns its two consumer
warpgroups split, carries each warpgroup's (m, se) and top-k through
selection rounds and merges the two; pass 2 (B4b: ``gate_pass2``) adds
[64 tokens x 128 experts] panels and reduces each expert chunk's partials
in panel order.  Here those schedules (``gate_pass1_items``,
``gate_pass1_block_walk``, ``gate_pass2_plan``) are held against brute
force, and the functions they imply (``gate_pass1_walk``,
``gate_pass2_walk``) against the JAX package's passes
(``_gate_pass1_kernel``, ``_gate_pass2_kernel``, Pallas, interpret mode)
and ``router_pallas_tiled``: ids exact, f32 values at 2e-4."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from flashmoe_tpu.config import LANE
from flashmoe_tpu.config import MoEConfig as JaxConfig
from flashmoe_tpu.ops.gate import (_ET, _gate_pass1_kernel,
                                   _gate_pass2_kernel, router_pallas_tiled)
from flashmoe_tpu_torch.config import MoEConfig as TorchConfig
from flashmoe_tpu_torch.ops import gate as tg

TOL = 2e-4  # f32: sums of the same terms in another order


def _inputs(s, h, e, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((s, h)).astype(np.float32)
    w = (rng.standard_normal((h, e)) / np.sqrt(h)).astype(np.float32)
    return x, w


def _bm(s):
    return next(b for b in (128, 64, 32, 16, 8) if s % b == 0)


@functools.partial(jax.jit, static_argnames=("k", "e"))
def _jax_pass1(x, w, k, e):
    """JAX's pass 1 (``_gate_pass1_kernel``) in interpret mode, launched as
    ``router_pallas_tiled`` launches it: (logits, m, se, top values, top
    ids), the lane-wide outputs cut to their first column / K columns."""
    s, h = x.shape
    nj = -(-e // _ET)
    bm = _bm(s)
    w_pad = jnp.zeros((h, nj * _ET), w.dtype).at[:, :e].set(w)
    lane = pl.BlockSpec((bm, LANE), lambda i, j: (i, 0))
    lane_f = jax.ShapeDtypeStruct((s, LANE), jnp.float32)
    logits, m, se, tv, ti = pl.pallas_call(
        functools.partial(_gate_pass1_kernel, k=k, e=e, et=_ET, spill=True),
        grid=(s // bm, nj),
        in_specs=[pl.BlockSpec((bm, h), lambda i, j: (i, 0)),
                  pl.BlockSpec((h, _ET), lambda i, j: (0, j))],
        out_specs=[pl.BlockSpec((bm, _ET), lambda i, j: (i, j))] + [lane] * 4,
        out_shape=[jax.ShapeDtypeStruct((s, nj * _ET), jnp.float32),
                   lane_f, lane_f, lane_f,
                   jax.ShapeDtypeStruct((s, LANE), jnp.int32)],
        scratch_shapes=[pltpu.VMEM((bm, LANE), jnp.float32)] * 3
        + [pltpu.VMEM((bm, LANE), jnp.int32)],
        interpret=True,
    )(x, w_pad)
    return logits[:, :e], m[:, 0], se[:, 0], tv[:, :k], ti[:, :k]


@functools.partial(jax.jit, static_argnames=("k", "e"))
def _jax_pass2(logits, m, se, ti, k, e):
    """JAX's pass 2 (``_gate_pass2_kernel``) in interpret mode on pass-1
    outputs: (probs_sum [E], counts [E], zsum)."""
    s = logits.shape[0]
    nj = -(-e // _ET)
    bm = _bm(s)
    px = nj * _ET
    lanes = [jnp.broadcast_to(v[:, None], (s, LANE)) for v in (m, se)]
    ti_l = jnp.zeros((s, LANE), jnp.int32).at[:, :k].set(ti)
    lg = jnp.zeros((s, px), jnp.float32).at[:, :e].set(logits)
    lane = pl.BlockSpec((bm, LANE), lambda j, i: (i, 0))
    stats = pl.pallas_call(
        functools.partial(_gate_pass2_kernel, k=k, e=e, et=_ET),
        grid=(nj, s // bm),
        in_specs=[pl.BlockSpec((bm, _ET), lambda j, i: (i, j)), lane, lane,
                  lane],
        out_specs=pl.BlockSpec((8, _ET), lambda j, i: (0, j)),
        out_shape=jax.ShapeDtypeStruct((8, px), jnp.float32),
        interpret=True,
    )(lg, *lanes, ti_l)
    return stats[0, :e], stats[1, :e], stats[2, 0]


# ----------------------------------------------------------------------
# pass 1: the schedule against brute force
# ----------------------------------------------------------------------

@pytest.mark.parametrize("s,e", [(1, 300), (40, 300), (72, 257),
                                 (130, 512), (64, 1280), (200, 8),
                                 (5, 301)])
def test_pass1_items_see_every_logit_once(s, e):
    """Every (token, expert) logit lies in exactly one item's rows and one
    warpgroup's columns of one of its expert tiles; an item is one 64-token
    tile against all E experts (no split of E at any S); the expert tiles
    are 256 wide and the same in every item and at every S, warpgroup 0
    taking the first 128 columns of each, 1 the rest; a warpgroup's
    columns grow from tile to tile, so its top-k meets them in expert
    order."""
    seen = np.zeros((s, e), int)
    items = tg.gate_pass1_items(s, e)
    assert [t for t, *_ in items] == list(range(-(-s // 64)))
    for t, rows, tiles in items:
        assert rows == range(64 * t, min(64 * t + 64, s))
        assert tiles == tg.gate_pass1_items(1, e)[0][2]
        assert [e0 for e0, _ in tiles] == list(range(0, e, 256))
        for wg in range(2):
            cols = [c for _, cc in tiles for c in cc[wg]]
            assert cols == sorted(cols)
        for e0, (c0, c1) in tiles:
            assert c0.start == min(e0, e) and c0.stop == c1.start
            assert len(c0) <= 128 and len(c1) <= 128
            assert c1.stop == min(e0 + 256, e)
            for c in (c0, c1):
                seen[rows.start:rows.stop, c.start:c.stop] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("sms", [3, 132])
@pytest.mark.parametrize("s", [1, 200, 8192])
def test_pass1_block_walk_takes_every_tile_once(s, sms):
    """The persistent grid: min(tiles, SMs) blocks, block b takes tiles b,
    b + grid, ... in order; every tile once."""
    walk = tg.gate_pass1_block_walk(s, sms)
    tiles = -(-s // 64)
    grid = min(tiles, sms)
    assert sorted(t for _, t in walk) == list(range(tiles))
    by_block = {}
    for b, t in walk:
        by_block.setdefault(b, []).append(t)
    assert sorted(by_block) == list(range(grid))
    for b, ts in by_block.items():
        assert ts == list(range(b, tiles, grid))


# ----------------------------------------------------------------------
# pass 1: the walk's function against JAX's pass 1
# ----------------------------------------------------------------------

def _check_pass1(x, w, k):
    e = w.shape[1]
    _, jm, jse, jv, ji = (np.asarray(a) for a in _jax_pass1(
        jnp.asarray(x), jnp.asarray(w), k=k, e=e))
    m, se, top_p, top_i = tg.gate_pass1_walk(torch.from_numpy(x),
                                             torch.from_numpy(w), k)
    np.testing.assert_array_equal(top_i.numpy(), ji)
    np.testing.assert_allclose(m.numpy(), jm, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(se.numpy(), jse, rtol=TOL, atol=TOL)
    want_p = np.exp(jv - jm[:, None]) / np.maximum(jse, 1e-30)[:, None]
    np.testing.assert_allclose(top_p.numpy(), want_p, rtol=TOL, atol=TOL)
    return top_i


@pytest.mark.parametrize("e,k,s", [(300, 1, 40), (300, 10, 72),
                                   (1280, 10, 136), (300, 64, 40),
                                   (1280, 64, 72), (512, 10, 64)],
                         ids=["e300k1", "e300k10_s72", "e1280k10_s136",
                              "e300k64", "e1280k64_s72", "e512k10"])
def test_pass1_walk_computes_jax_pass1(e, k, s):
    """m, se, the top-k ids (exact) and their probabilities against JAX's
    pass-1 kernel on the same numpy inputs, at S that are not multiples of
    the 64-token tile, E that leave a warpgroup's columns short or empty
    in the last expert tile, and K 1, 10 and 64."""
    x, w = _inputs(s, 64, e, seed=e + k + s)
    _check_pass1(x, w, k)


def test_pass1_walk_breaks_ties_by_lowest_id():
    """Equal logits within a warpgroup's tile, across its tiles and across
    the two warpgroups: the lowest ids win, as in JAX's merge."""
    e, h, s = 700, 64, 16
    w = np.zeros((h, e), np.float32)
    w[0, [5, 70, 130, 200, 299, 384, 640, 699]] = 1.0  # tied at the top
    w[0, [1, 2, 600]] = 0.5
    w[1, 3:] = np.linspace(-0.1, 0.1, e - 3)
    x = np.zeros((s, h), np.float32)
    x[:, 0] = 1.0
    x[8:, 1] = np.arange(1, 9, dtype=np.float32) * 1e-3
    top_i = _check_pass1(x, w, 10)
    assert top_i[0].tolist()[:8] == [5, 70, 130, 200, 299, 384, 640, 699]


def quad_spread_logits(s, e):
    """[S, E] logits whose top-10 is spread over the four threads of a quad
    in pass 1's first expert tile (thread q holds the tile's columns 8 j +
    2 q + {0, 1}): each thread two large logits, tied across threads, and
    one medium, the top-10 taking two mediums; every other logit small.
    All values are exact in bf16."""
    lg = -1.0 - (np.arange(e) % 7)[None, :] * 0.125 + np.zeros((s, 1))
    for q in range(4):
        lg[:, 2 * q] = 16 + 2 * q
        lg[:, 8 + 2 * q] = 12 + 2 * q
        lg[:, 16 + 2 * q] = 4 + 0.5 * q
    lg[:, 24:128:3] += 0.25 * (np.arange(s) % 4)[:, None]
    return lg.astype(np.float32)


def test_pass1_walk_takes_a_top_k_spread_over_the_quad():
    """A top-10 spread over a quad's threads, with large logits tied
    across threads: ids exact against JAX's pass 1."""
    s, e, k = 8, 300, 10
    x = np.eye(s, 64, dtype=np.float32)
    w = np.zeros((64, e), np.float32)
    w[:s] = quad_spread_logits(s, e)
    top_i = _check_pass1(x, w, k)
    assert sorted(top_i[0].tolist()) == [0, 2, 4, 6, 8, 10, 12, 14, 20, 22]


@pytest.mark.parametrize("e,k,s,need_stats", [(300, 10, 40, True),
                                              (1280, 2, 72, False),
                                              (600, 64, 24, True)],
                         ids=["e300k10_stats", "e1280k2", "e600k64_stats"])
def test_walks_compute_router_pallas_tiled(e, k, s, need_stats):
    """The two walks as a router against JAX's ``router_pallas_tiled`` in
    interpret mode: ids and counts exact, weights and losses at 2e-4."""
    jc = JaxConfig(num_experts=e, expert_top_k=k, hidden_size=64,
                   router_z_loss_coef=0.01, dtype=jnp.float32)
    tc = TorchConfig(num_experts=e, expert_top_k=k, hidden_size=64,
                     router_z_loss_coef=0.01, dtype=torch.float32)
    x, w = _inputs(s, 64, e, seed=k)
    want = router_pallas_tiled(jnp.asarray(x), jnp.asarray(w), jc,
                               interpret=True, need_stats=need_stats)

    def pass1(x, w, k, need_logits):
        m, se, top_p, top_i = tg.gate_pass1_walk(x, w, k)
        return tg.dot_f32(x, w), m, se, top_p, top_i

    def pass2(logits, m, se, top_i, e):
        return tg.gate_pass2_walk(logits, m, se, top_i, e)

    got = tg._router_tiled(pass1, pass2, torch.from_numpy(x),
                           torch.from_numpy(w), tc, need_stats)
    np.testing.assert_array_equal(got.expert_idx.numpy(),
                                  np.asarray(want.expert_idx))
    np.testing.assert_array_equal(got.expert_counts.numpy(),
                                  np.asarray(want.expert_counts))
    for name in ("combine_weights", "probs_mean", "aux_loss", "z_loss"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=TOL, atol=TOL, err_msg=name)


# ----------------------------------------------------------------------
# pass 2: the plan against brute force, its function against JAX's
# ----------------------------------------------------------------------

@pytest.mark.parametrize("s,e", [(1, 300), (40, 300), (130, 512),
                                 (257, 1280), (64, 301), (8192, 512)])
def test_pass2_plan_counts_every_element_once(s, e):
    """Every logit lies in exactly one block's panel and chunk (64 tokens
    by 128 experts, clipped at S and E, the chunk fastest); every token's
    lse^2 in exactly one panel of the first chunk; each chunk's blocks,
    one a panel, are reduced in panel order."""
    seen = np.zeros((s, e), int)
    plan = tg.gate_pass2_plan(s, e)
    chunks = -(-e // 128)
    assert len(plan) == -(-s // 64) * chunks
    for n, (rows, cols) in enumerate(plan):
        assert rows.start == 64 * (n // chunks) and len(rows) <= 64
        assert cols.start == 128 * (n % chunks) and len(cols) <= 128
        seen[rows.start:rows.stop, cols.start:cols.stop] += 1
    assert (seen == 1).all()
    z_rows = [r for rows, cols in plan if cols.start == 0 for r in rows]
    assert z_rows == list(range(s))


@pytest.mark.parametrize("s,e,k", [(40, 300, 10), (200, 1280, 64),
                                   (72, 301, 3), (8, 600, 1)],
                         ids=["e300k10", "e1280k64", "e301", "e600k1"])
def test_pass2_walk_computes_jax_pass2(s, e, k):
    """Probability sums and the z sum at 2e-4 and counts exact, against
    JAX's pass-2 kernel on the same pass-1 outputs (JAX's own)."""
    x, w = _inputs(s, 64, e, seed=s + e)
    lg, m, se, _, ti = _jax_pass1(jnp.asarray(x), jnp.asarray(w), k=k, e=e)
    jp, jc, jz = (np.asarray(a) for a in _jax_pass2(lg, m, se, ti, k=k, e=e))
    got = tg.gate_pass2_walk(*(torch.from_numpy(np.array(a))
                               for a in (lg, m, se, ti)), e)
    np.testing.assert_allclose(got[0].numpy(), jp, rtol=TOL, atol=1e-6)
    np.testing.assert_array_equal(got[1].numpy(), jc.astype(np.int64))
    np.testing.assert_allclose(float(got[2]), float(jz), rtol=TOL)
