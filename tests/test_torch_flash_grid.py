"""PyTorch port: the pure-Python schedule of the Hopper flash attention
(CPU).  The bf16 B9 kernel (``csrc/flash_attention.cu``: ``flash_hopper``)
packs query heads of one kv head into 64-row tiles, pairs two tiles on
consecutive query ranges in a work item, orders the items longest first,
walks them on a persistent grid in a snake and each tile's 64-key blocks
up to its causal reach; here that schedule (``flash_items``,
``flash_block_walk``) is held against a brute-force expectation, and the
function it implies (``flash_walk_plain``, the kernel's online softmax
block by block) against the JAX package's ``flash_attention`` (Pallas,
interpret mode) and the port's plain attention, f32 at
tests/test_attention.py's 2e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # one intra-op thread a test worker

from flashmoe_tpu.ops.attention import flash_attention
from flashmoe_tpu_torch.ops import attention as tatt

TOL = 2e-4  # f32: sums of the same products in another order


def _qkv(b, n, nkv, t, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, n, t, d)).astype(np.float32),
            rng.standard_normal((b, nkv, t, d)).astype(np.float32),
            rng.standard_normal((b, nkv, t, d)).astype(np.float32))


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("ratio,n", [(1, 2), (4, 8), (8, 16), (3, 6)],
                         ids=["gqa1", "gqa4", "gqa8", "gqa3"])
@pytest.mark.parametrize("t", [1, 63, 200, 272])
def test_flash_block_walk_covers_every_row_once(t, ratio, n, causal):
    """Every (batch, head, query) row lies in exactly one tile of one
    item; a tile packs flash_pack heads (8, 4, 1 and 1 here) of one kv
    head, all of that kv head's group; its key blocks reach its last query
    (every key block without the causal mask) and none past T; an item
    loads the most of its tiles' key blocks; items go in order of
    decreasing first query, so their key-block counts never increase;
    each block of a persistent grid (3 and 132 blocks) takes its items in
    the snake order k, 2 g - 1 - k, 2 g + k, ..., every item once."""
    b, nkv = 2, n // ratio
    p = tatt.flash_pack(n, nkv)
    assert p == {1: 1, 4: 4, 8: 8, 3: 1}[ratio]
    rq = tatt.FLASH_ROWS // p
    all_kb = -(-t // tatt.FLASH_KEYS)
    items = tatt.flash_items(b, n, nkv, t, causal)
    seen = np.zeros((b, n, t), int)
    for bi, kvh, heads, tiles, nkb in items:
        assert len(heads) == p
        assert all(h // ratio == kvh for h in heads)
        assert len(tiles) == tatt.FLASH_TILES
        assert tiles[1][0] == tiles[0][0] + rq
        for q0, q1, kb in tiles:
            seen[bi, list(heads), q0:q1] += 1
            if q0 >= t:
                assert (q1, kb) == (q0, 0)
                continue
            assert q1 == min(q0 + rq, t)
            assert kb == ((q1 - 1) // tatt.FLASH_KEYS + 1 if causal
                          else all_kb)
        assert nkb == max(kb for *_, kb in tiles)
    assert (seen == 1).all()
    firsts = [tiles[0][0] for *_, tiles, _ in items]
    assert firsts == sorted(firsts, reverse=True)
    counts = [nkb for *_, nkb in items]
    assert counts == sorted(counts, reverse=True)
    for sms in (3, 132):
        walk = tatt.flash_block_walk(b, n, nkv, t, sms, causal)
        g = min(len(items), sms)
        order = {}
        for blk, *item in walk:
            order.setdefault(blk, []).append(items.index(tuple(item)))
        assert sorted(order) == list(range(g))
        for blk, got in order.items():
            want = [j * g + blk if j % 2 == 0 else (j + 1) * g - 1 - blk
                    for j in range(len(got))]
            assert got == want
        assert sorted(i for got in order.values() for i in got) == \
            list(range(len(items)))


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("t,ratio", [(128, 1), (128, 4), (256, 8)],
                         ids=["t128_gqa1", "t128_gqa4", "t256_gqa8"])
def test_flash_walk_computes_jax_flash_attention(t, ratio, causal):
    """The walk's function against JAX's interpret-mode
    ``flash_attention`` (T a multiple of its 128-query block), with the
    kv heads repeated for JAX as ``jnp.repeat`` does."""
    b, nkv, d = 1, 2, 64
    q, k, v = _qkv(b, nkv * ratio, nkv, t, d, seed=t + ratio)
    kr, vr = (np.repeat(a, ratio, axis=1) for a in (k, v))
    want = np.asarray(flash_attention(jnp.asarray(q), jnp.asarray(kr),
                                      jnp.asarray(vr), causal=causal,
                                      interpret=True))
    got = tatt.flash_walk_plain(*map(torch.from_numpy, (q, k, v)),
                                causal=causal, sms=5)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("ratio", [1, 4, 8])
@pytest.mark.parametrize("t", [1, 63, 200, 272])
def test_flash_walk_computes_plain_attention(t, ratio, causal):
    """The walk's function at every T (one token, a partial key block,
    T past a multiple of the tile) against the port's plain attention
    with the GQA heads repeated, D 64 and 128."""
    nkv = 2
    for d in (64, 128):
        q, k, v = map(torch.from_numpy,
                      _qkv(1, nkv * ratio, nkv, t, d, seed=t * ratio + d))
        got = tatt.flash_walk_plain(q, k, v, causal=causal)
        want = tatt.flash_attention_plain(q, k, v, causal=causal)
        assert not torch.isnan(got).any()
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("t", [200, 256])
@pytest.mark.parametrize("d", [32, 80, 96, 192, 256])
def test_flash_walk_at_other_head_dims(d, t):
    """The walk's function at the kernel's other head dims (NB =
    ceil(D / 64) boxes, the columns past D zero) against the port's plain
    attention and, at T 256, JAX's interpret-mode ``flash_attention``,
    GQA 4."""
    q, k, v = _qkv(1, 8, 2, t, d, seed=d * t)
    got = tatt.flash_walk_plain(*map(torch.from_numpy, (q, k, v)), sms=7)
    want = tatt.flash_attention_plain(*map(torch.from_numpy, (q, k, v)))
    assert not torch.isnan(got).any()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL,
                               atol=TOL)
    if t % 128 == 0:
        kr, vr = (np.repeat(a, 4, axis=1) for a in (k, v))
        jwant = np.asarray(flash_attention(jnp.asarray(q), jnp.asarray(kr),
                                           jnp.asarray(vr), causal=True,
                                           interpret=True))
        np.testing.assert_allclose(got.numpy(), jwant, rtol=TOL, atol=TOL)
