"""PyTorch port: the pure-Python grids of the gate kernel and the Hopper
grouped matmul (CPU).  The gate's split of H into slices and the grouped
matmul's work list decide what each block of those kernels computes; here
each is held against a brute-force expectation on random shapes and
plans, and the function they imply (partial logits added in slice order;
each item's rows against its expert) against the JAX package on the same
numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashmoe_tpu.ops import expert as jexp
from flashmoe_tpu_torch.ops import expert as texp
from flashmoe_tpu_torch.ops import gate as tgate

ROW = texp.ROW_TILE


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_gate_split_covers_h_in_whole_chunks(dtype):
    """Every slice is a non-empty run of whole 64-byte chunks, the slices
    tile [0, H) in order, their number never depends on S, and the
    partial logits they write and read (8 E bytes a slice and token) stay
    within half of x's bytes wherever more than one slice runs."""
    rng = np.random.default_rng(0)
    ch = 64 // dtype.itemsize
    for _ in range(200):
        s = int(rng.integers(1, 20000))
        h = 32 * int(rng.integers(1, 260))
        e = int(rng.integers(1, 257))
        tiles, split = tgate.gate_split(s, h, e, dtype)
        assert tiles == -(-s // tgate.GATE_TOKENS)
        assert (tiles, split) == (tiles, tgate.gate_split(1, h, e, dtype)[1])
        assert 1 <= split <= min(h // ch, tgate.GATE_MAX_SPLIT)
        assert split == 1 or 8 * e * split <= h * dtype.itemsize // 2
        slices = tgate.gate_slices(h, split, dtype)
        assert [i for r in slices for i in r] == list(range(h))
        assert all(len(r) and len(r) % ch == 0 and r.start % ch == 0
                   for r in slices)


def test_gate_grid_fills_the_card_at_prefill_and_decode():
    """Mixtral's gate (H 4096, E 8): at least two waves of blocks on 132
    SMs at a prefill of 1024 tokens, and 32 blocks at a decode step of
    4."""
    tiles, split = tgate.gate_split(1024, 4096, 8, torch.bfloat16)
    assert tiles * split >= 2 * 132
    tiles, split = tgate.gate_split(4, 4096, 8, torch.bfloat16)
    assert tiles * split == 32


def test_gate_split_merge_matches_jax_logits():
    """The kernel's logits are the slices' partial products added in
    slice order; on the same inputs that sum matches JAX's f32 logits."""
    rng = np.random.default_rng(1)
    s, h, e = 37, 1024, 8
    x = rng.standard_normal((s, h), dtype=np.float32)
    w = (rng.standard_normal((h, e)) / np.sqrt(h)).astype(np.float32)
    _, split = tgate.gate_split(s, h, e, torch.float32)
    assert split > 1
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    got = torch.zeros(s, e)
    for r in tgate.gate_slices(h, split, torch.float32):
        got = got + tx[:, r.start:r.stop] @ tw[r.start:r.stop]
    want = np.asarray(jnp.dot(jnp.asarray(x), jnp.asarray(w),
                              preferred_element_type=jnp.float32))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _row_experts(gid, block_m, rows, num_rows):
    """Brute force: the expert of every row, -1 past num_rows."""
    e = np.repeat(gid, block_m)[:rows].astype(int)
    if num_rows is not None:
        e[num_rows:] = -1
    return e


def test_gmm_work_list_covers_every_tile_once_with_its_expert():
    """Random plans (sorted and unsorted tile ids, experts with no tiles,
    row tiles of 64 and 128, with and without a ragged tail): every
    64-row tile lies in exactly one item, every row of an item has the
    item's expert, and each run of one expert is cut into items of two
    tiles from its start, an odd run ending in an item of one."""
    rng = np.random.default_rng(2)
    for case in range(150):
        bm = ROW * int(rng.choice([1, 2]))
        nt = int(rng.integers(1, 40))
        gid = rng.integers(0, int(rng.integers(1, 9)), nt).astype(np.int32)
        if case % 2:
            gid = np.sort(gid)
        rows = nt * bm
        num_rows = None if case % 3 == 0 else \
            int(rng.integers(0, rows // ROW + 1)) * ROW
        experts = _row_experts(gid, bm, rows, num_rows)
        items = texp.gmm_work_list(torch.from_numpy(gid), bm, rows,
                                   None if num_rows is None
                                   else torch.tensor(num_rows))
        seen = np.zeros(rows // ROW, int)
        for t0, tiles, e in items:
            assert tiles in (1, 2)
            seen[t0:t0 + tiles] += 1
            assert (experts[t0 * ROW:(t0 + tiles) * ROW] == e).all()
            if tiles == 1 and t0 + 1 < rows // ROW:
                assert experts[(t0 + 1) * ROW] != e
        assert (seen == 1).all()
        tile_e = experts[::ROW]
        runs = np.split(tile_e, np.flatnonzero(np.diff(tile_e)) + 1)
        assert len(items) == sum(-(-len(r) // 2) for r in runs)


def test_gmm_work_list_computes_jax_grouped_matmul():
    """Each item's rows times its expert's weight (zeros for tiles past
    num_rows), on the same inputs as JAX's grouped_matmul (Pallas,
    interpret mode): the function the Hopper kernel computes from its
    work list."""
    rng = np.random.default_rng(3)
    gid = np.array([0, 0, 0, 2, 2, 3, 3], np.int32)
    k, n = 64, 128
    x = rng.standard_normal((gid.size * ROW, k), dtype=np.float32)
    w = rng.standard_normal((4, n, k), dtype=np.float32)
    want = np.asarray(jexp.grouped_matmul(
        jnp.asarray(x), jnp.asarray(gid), jnp.asarray(w), transpose_w=True,
        block_m=ROW, out_dtype=jnp.float32, interpret=True))
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    for num_rows in (None, 4 * ROW):
        got = torch.full((x.shape[0], n), float("nan"))
        for t0, tiles, e in texp.gmm_work_list(
                torch.from_numpy(gid), ROW, x.shape[0],
                None if num_rows is None else torch.tensor(num_rows)):
            rows = slice(t0 * ROW, (t0 + tiles) * ROW)
            got[rows] = 0.0 if e < 0 else tx[rows] @ tw[e].T
        ref = want.copy()
        if num_rows is not None:
            ref[num_rows:] = 0.0
        np.testing.assert_allclose(got.numpy(), ref, rtol=2e-4, atol=2e-4)
