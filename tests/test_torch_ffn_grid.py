"""PyTorch port: the pure-Python grid of the Hopper grouped FFN (CPU).
The bf16 B2, B3 and B6 kernels (``csrc/grouped_ffn.cu``) walk the grouped
matmul's work list against column blocks of their weights; here that walk
(``ffn_tile_walk``) is held against a brute-force expectation on random
plans, and the function it implies (each tile's rows through its expert's
up and down passes, zeros past num_rows; B6's u and g beside hidden)
against the JAX package's ``grouped_ffn``, ``grouped_ffn_tokens`` and
``_grouped_ffn_res`` (Pallas, interpret mode) on the same numpy inputs,
f32 at tests/test_expert.py's 2e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashmoe_tpu.ops import expert as jexp
from flashmoe_tpu_torch.models.reference import activation_fn
from flashmoe_tpu_torch.ops import expert as texp

ROW = texp.ROW_TILE


def _row_experts(gid, block_m, rows, num_rows):
    """Brute force: the expert of every row, -1 past num_rows."""
    e = np.repeat(gid, block_m)[:rows].astype(int)
    if num_rows is not None:
        e[num_rows:] = -1
    return e


@pytest.mark.parametrize("operands", [1, 2], ids=["one_operand", "gated"])
def test_ffn_tile_walk_covers_every_tile_once(operands):
    """Random plans (sorted and unsorted tile ids, experts with no tiles,
    row tiles of 64 and 128, with and without a ragged tail), widths that
    are and are not multiples of the column tile, and grids of 8 to 132
    blocks: every (64-row tile, 64-column block) lies in exactly one
    walked tile, every row of a tile has the tile's expert, column blocks
    are whole tiles of 256 / operands columns but the last, and the walk
    goes column-fastest exactly when the items outnumber the grid and the
    column blocks number at most a quarter of it, else item-fastest."""
    rng = np.random.default_rng(11 + operands)
    cols = texp.HOPPER_COLS // operands
    orders = set()
    for case in range(120):
        bm = ROW * int(rng.choice([1, 2]))
        nt = int(rng.integers(1, 30))
        gid = rng.integers(0, int(rng.integers(1, 9)), nt).astype(np.int32)
        if case % 2:
            gid = np.sort(gid)
        rows = nt * bm
        n = 64 * int(rng.integers(1, 17))
        sms = int(rng.choice([8, 16, 132]))
        num_rows = None if case % 3 == 0 else \
            int(rng.integers(0, rows // ROW + 1)) * ROW
        nrow = None if num_rows is None else torch.tensor(num_rows)
        experts = _row_experts(gid, bm, rows, num_rows)
        walk = texp.ffn_tile_walk(torch.from_numpy(gid), bm, rows, n, sms,
                                  operands, nrow)
        items = texp.gmm_work_list(torch.from_numpy(gid), bm, rows, nrow)
        ncols = -(-n // cols)
        inner = len(items) > sms and 4 * ncols <= sms
        orders.add(inner)
        assert len(walk) == len(items) * ncols
        seen = np.zeros((rows // ROW, n // 64), int)
        for t, (t0, tiles, e, n0, n1) in enumerate(walk):
            item, col = (t // ncols, t % ncols) if inner else \
                (t % len(items), t // len(items))
            assert (t0, tiles, e) == items[item]
            assert n0 == col * cols and n0 % 64 == 0
            assert n1 - n0 == min(cols, n - n0) and n1 % 64 == 0
            seen[t0:t0 + tiles, n0 // 64:n1 // 64] += 1
            assert (experts[t0 * ROW:(t0 + tiles) * ROW] == e).all()
        assert (seen == 1).all()
    assert orders == {False, True}


def _inputs(e, h, i, gated, seed):
    rng = np.random.default_rng(seed)

    def normal(shape, fan_in):
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
            np.float32)

    p = {"w_up": normal((e, h, i), h), "w_down": normal((e, i, h), i),
         "b_up": normal((e, i), 8), "b_down": normal((e, h), 8)}
    if gated:
        p["w_gate"] = normal((e, h, i), h)
    return p, rng


def _walk_ffn_res(x, gid, p, act_name, gated, num_rows, sms):
    """The FFN computed tile by tile over ffn_tile_walk, as the two
    passes of the Hopper kernel do: the up pass writes hidden for the
    walked tiles with an expert (f32 bias, activation), and with them the
    residuals the residual-saving forward keeps, u = up + b_up and g, the
    gate's product (zeros for the tiles past num_rows); the down pass
    each tile's output, and zeros for the tiles past num_rows.  Returns
    (out, u, g), g None when not gated."""
    t, h = x.shape
    i = p["w_up"].shape[2]
    act = activation_fn(act_name)
    w = {k: torch.from_numpy(v) for k, v in p.items()}
    gid_t = torch.from_numpy(gid)
    nrow = None if num_rows is None else torch.tensor(num_rows)
    hidden = torch.full((t, i), float("nan"))
    u = torch.full((t, i), float("nan"))
    g = torch.full((t, i), float("nan")) if gated else None
    for t0, tiles, e, n0, n1 in texp.ffn_tile_walk(
            gid_t, ROW, t, i, sms, 2 if gated else 1, nrow):
        r = slice(t0 * ROW, (t0 + tiles) * ROW)
        if e < 0:
            u[r, n0:n1] = 0.0
            if gated:
                g[r, n0:n1] = 0.0
            continue
        u[r, n0:n1] = x[r] @ w["w_up"][e, :, n0:n1] + w["b_up"][e, n0:n1]
        if gated:
            g[r, n0:n1] = x[r] @ w["w_gate"][e, :, n0:n1]
        hidden[r, n0:n1] = (act(g[r, n0:n1]) * u[r, n0:n1] if gated
                            else act(u[r, n0:n1]))
    out = torch.full((t, h), float("nan"))
    for t0, tiles, e, n0, n1 in texp.ffn_tile_walk(gid_t, ROW, t, h, sms,
                                                   1, nrow):
        r = slice(t0 * ROW, (t0 + tiles) * ROW)
        out[r, n0:n1] = 0.0 if e < 0 else \
            hidden[r] @ w["w_down"][e, :, n0:n1] + w["b_down"][e, n0:n1]
    return out, u, g


def _walk_ffn(x, gid, p, act_name, gated, num_rows, sms):
    """The output of :func:`_walk_ffn_res`: the two passes of B2."""
    return _walk_ffn_res(x, gid, p, act_name, gated, num_rows, sms)[0]


_CASES = [(True, "silu"), (False, "gelu"), (False, "relu")]


@pytest.mark.parametrize("gated,act", _CASES,
                         ids=["gated_silu", "gelu", "relu"])
def test_ffn_tile_walk_computes_jax_grouped_ffn(gated, act):
    """Odd and even runs of tiles, an expert with none, I and H that are
    not multiples of the column tile; with and without a ragged tail;
    both walk orders (with a grid of 4 blocks the down pass walks
    column-fastest here; with 8, every pass item-fastest)."""
    e, h, i = 4, 192, 320
    p, rng = _inputs(e, h, i, gated, seed=21)
    gid = np.array([2, 2, 2, 0, 3, 3, 0], np.int32)
    x = rng.standard_normal((gid.size * ROW, h)).astype(np.float32)
    want = np.asarray(jexp.grouped_ffn(
        jnp.asarray(x), jnp.asarray(gid), p["w_up"], p["b_up"], p["w_down"],
        p["b_down"], p.get("w_gate"), act_name=act, gated=gated,
        block_m=ROW, block_i=64, interpret=True))
    for num_rows, sms in ((None, 8), (5 * ROW, 8), (5 * ROW, 4)):
        got = _walk_ffn(torch.from_numpy(x), gid, p, act, gated, num_rows,
                        sms)
        ref = want.copy()
        if num_rows is not None:
            ref[num_rows:] = 0.0
        np.testing.assert_allclose(got.numpy(), ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("gated,act", _CASES[:2], ids=["gated_silu", "gelu"])
def test_ffn_tile_walk_computes_jax_grouped_ffn_tokens(gated, act):
    """The gather-fused FFN: the walk over the rows x[src_tok] against
    JAX's grouped_ffn_tokens, which reads each row by its source token."""
    e, h, i, s = 3, 128, 256, 50
    p, rng = _inputs(e, h, i, gated, seed=31)
    gid = np.array([1, 1, 0, 2, 2], np.int32)
    x = rng.standard_normal((s, h)).astype(np.float32)
    src = rng.integers(0, s, gid.size * ROW).astype(np.int32)
    want = np.asarray(jexp.grouped_ffn_tokens(
        jnp.asarray(x), jnp.asarray(src), jnp.asarray(gid), p["w_up"],
        p["b_up"], p["w_down"], p["b_down"], p.get("w_gate"), act_name=act,
        gated=gated, block_m=ROW, block_i=64, interpret=True))
    got = _walk_ffn(torch.from_numpy(x)[torch.from_numpy(src).long()], gid,
                    p, act, gated, None, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("gated,act", _CASES, ids=["gated_silu", "gelu",
                                                   "relu"])
def test_ffn_tile_walk_computes_jax_grouped_ffn_res(gated, act):
    """The residual-saving forward (B6, the Hopper FFN whose up pass also
    writes u and g): the walk's y, u and g against JAX's
    ``_grouped_ffn_res`` (Pallas, interpret mode) on the same inputs, with
    and without a ragged tail (zeros past num_rows in all three), in both
    walk orders."""
    e, h, i = 4, 192, 320
    p, rng = _inputs(e, h, i, gated, seed=41)
    gid = np.array([1, 1, 3, 0, 0, 0, 2], np.int32)
    x = rng.standard_normal((gid.size * ROW, h)).astype(np.float32)
    want = [np.asarray(a) for a in jexp._grouped_ffn_res(
        jnp.asarray(x), jnp.asarray(gid), p["w_up"], p["b_up"], p["w_down"],
        p["b_down"], p.get("w_gate"), act_name=act, gated=gated,
        block_m=ROW, block_i=64, interpret=True)]
    for num_rows, sms in ((None, 8), (4 * ROW, 8), (4 * ROW, 4)):
        got = _walk_ffn_res(torch.from_numpy(x), gid, p, act, gated,
                            num_rows, sms)
        for name, a, ref in zip("yug", got, want):
            if name == "g" and not gated:
                assert a is None
                continue
            ref = ref.copy()
            if num_rows is not None:
                ref[num_rows:] = 0.0
            np.testing.assert_allclose(a.numpy(), ref, rtol=2e-4,
                                       atol=2e-4, err_msg=name)
