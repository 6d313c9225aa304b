"""PyTorch port: the fused expert-parallel kernel's task list (CPU).

The bf16 kernel (``csrc/fused_ep.cu``) takes tasks of up to two 64-row
tiles of one expert, paired across a unit's sources, against one column
tile (``fused.task_order``).  Here that list is held against what the
kernel's protocol needs, on random source orders and counts: each (tile,
column tile, kind) once, items of one expert, every down task after the
up tasks of its tiles, and flag words that the tasks raise exactly once
and wait for exactly as raised, inside the layout the wrapper allocates.
The function the walk implies (each task's columns of its live tiles,
in the list's order) is held against the JAX package's ``grouped_ffn``
(Pallas, interpret mode) on each owner's received rows, f32 at
tests/test_expert.py's 2e-4.  JAX's fused layer itself is never called
here: its interpret-mode barrier is the tier-1 hang.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashmoe_tpu.ops import expert as jexp
from flashmoe_tpu_torch.models.reference import activation_fn
from flashmoe_tpu_torch.parallel import fused

ROW = fused.ROW_TILE


def _random_src_order(rng, d):
    """Own-first permutations, one a rank."""
    rows = []
    for r in range(d):
        rest = [s for s in range(d) if s != r]
        rng.shuffle(rest)
        rows.append([r] + rest)
    return fused.check_src_order(np.array(rows), d)


def _decode(code, nlx, n_tiles):
    """(src, e, t) of a tile code, as the kernel's ep_tile."""
    return code // (nlx * n_tiles), (code // n_tiles) % nlx, code % n_tiles


def _live(counts, src, dst, e, t, cap):
    """Rows of tile t that src sends dst's expert e (the kernel's
    sent_rows, clamped to the capacity)."""
    return min(ROW, min(int(counts[src, dst, e]), cap) - t * ROW)


def _code_live(counts, code, dst, nlx, n_tiles, cap):
    """:func:`_live` of the tile with code ``code`` at rank dst."""
    src, e, t = _decode(code, nlx, n_tiles)
    return _live(counts, src, dst, e, t, cap)


@pytest.mark.parametrize("schedule", fused.SCHEDULES)
def test_task_list_meets_the_kernel_protocol(schedule):
    """Random worlds (1 to 6 ranks, 1 to 3 experts a rank, 1 to 3 row
    tiles a slab, gated or not, H and I of 1 to 5 column tiles), random
    own-first source orders and counts (some slabs empty):

    * each rank lists the same number of tasks, 4 int32 a task;
    * each (tile, column tile, kind) appears exactly once, and an item's
      two tiles are distinct tiles of one local expert;
    * every down task comes after all up tasks of each of its tiles;
    * walking the list as the kernel does (tiles with no rows skipped),
      the up flags (owner's heap) and return flags (source's heap) are
      each raised once, every wait (dispatch flags of the up tasks, all
      up flags of a down task's tiles, phase 3's return flags of every
      tile a rank sent) meets a flag that is raised, and every index lies
      inside the flag words the wrapper allocates."""
    rng = np.random.default_rng(
        [7, fused.SCHEDULES.index(schedule)])
    for _ in range(60):
        d = int(rng.integers(1, 7))
        nlx = int(rng.integers(1, 4))
        n_tiles = int(rng.integers(1, 4))
        cap = n_tiles * ROW - int(rng.integers(0, ROW))
        gated = bool(rng.integers(0, 2))
        h = 64 * int(rng.integers(1, 21))
        i = 64 * int(rng.integers(1, 11))
        n_up, n_down = fused.col_tiles(i, gated), fused.col_tiles(h)
        so = _random_src_order(rng, d)
        counts = rng.integers(0, cap + 1, (d, d, nlx))
        counts[rng.random((d, d, nlx)) < 0.3] = 0
        order = fused.task_order(so, nlx, n_tiles, n_up, n_down, schedule)
        assert order.dtype == np.int32 and order.ndim == 3
        assert order.shape[0] == d and order.shape[2] == 4
        n_flags = d * nlx * n_tiles * (1 + n_up + n_down)
        flags = fused._Flags(None, d, n_flags, "cpu")
        assert flags.stride >= 16 + 4 * n_flags
        n = d * nlx * n_tiles
        raised = {}  # (heap, word) -> times raised
        waits = set()

        def raise_(heap, word):
            assert 0 <= word < n_flags
            raised[heap, word] = raised.get((heap, word), 0) + 1

        # phase 1: a dispatch flag for every occupied tile, in its owner
        for src in range(d):
            for dst in range(d):
                for e in range(nlx):
                    for t in range(n_tiles):
                        if _live(counts, src, dst, e, t, cap) > 0:
                            raise_(dst, (src * nlx + e) * n_tiles + t)
        for r in range(d):
            seen, ups = set(), set()
            for a, b, kj, zero in order[r]:
                kind, j = kj >> 16, kj & 0xffff
                assert zero == 0 and kind in (0, 1)
                assert j < (n_down if kind else n_up)
                codes = [c for c in (a, b) if c >= 0]
                assert a >= 0 and len(set(codes)) == len(codes)
                tiles = [_decode(c, nlx, n_tiles) for c in codes]
                assert len({e for _, e, _ in tiles}) == 1
                for c, (src, e, t) in zip(codes, tiles):
                    assert 0 <= src < d and (c, kind, j) not in seen
                    seen.add((c, kind, j))
                    if kind:
                        assert all((c, jj) in ups for jj in range(n_up))
                    else:
                        ups.add((c, j))
                    if _live(counts, src, r, e, t, cap) <= 0:
                        continue  # the kernel skips a tile with no rows
                    tile = (src * nlx + e) * n_tiles + t
                    if kind == 0:
                        waits.add((r, tile))
                        raise_(r, n + tile * n_up + j)
                    else:
                        waits.update((r, n + tile * n_up + jj)
                                     for jj in range(n_up))
                        raise_(src, n * (1 + n_up)
                               + ((r * nlx + e) * n_tiles + t) * n_down + j)
            assert len(seen) == d * nlx * n_tiles * (n_up + n_down)
            assert order.shape[1] == len(order[r])
        # phase 3: each rank waits for every return of a tile it sent
        for r in range(d):
            for dst in range(d):
                for e in range(nlx):
                    for t in range(n_tiles):
                        if _live(counts, r, dst, e, t, cap) > 0:
                            waits.update(
                                (r, n * (1 + n_up) + ((dst * nlx + e)
                                                      * n_tiles + t)
                                 * n_down + j) for j in range(n_down))
        assert set(raised.values()) <= {1}
        assert waits == set(raised)


def test_items_pair_live_tiles_at_the_ep_path_shapes():
    """At the ep path's shapes (8 ranks, one expert each, slabs of 128
    rows of which about 32 live, so tile 1 of every slab is empty), the
    remote unit's items pair tile 0 of two sources: of the items that
    hold a live tile, all but one hold two, so both consumer warpgroups
    of a block work.  Pairing within a slab would pair each live tile
    with an empty one."""
    d, nlx, n_tiles = 8, 1, 2
    counts = np.full((d, d, nlx), 32)
    order = fused.task_order(fused.default_ring(d), nlx, n_tiles, 1, 1,
                             "batched")
    for r in range(d):
        live = []
        for a, b, kj, _ in order[r]:
            if kj:  # the up tasks of column tile 0 only
                continue
            n = sum(_code_live(counts, c, r, nlx, n_tiles, 128) > 0
                    for c in (a, b) if c >= 0)
            if n:
                live.append(n)
        # the own slab's item (one live tile), then the remote unit's
        assert live[0] == 1
        assert sorted(live[1:]) == [1] * ((d - 1) % 2) + [2] * ((d - 1) // 2)
        within = [(c, c + 1) for c in range(0, d * n_tiles, n_tiles)]
        assert all(sum(_code_live(counts, c, r, nlx, n_tiles, 128) > 0
                       for c in item) == 1 for item in within)


def _shard(rng, d, nlx, cap, h, i, gated):
    """f32 shard arguments: slabs, counts (some slabs empty), weights."""
    def normal(shape, fan_in):
        return torch.from_numpy(
            (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
                np.float32))

    counts = rng.integers(0, cap + 1, (d, d, nlx))
    counts[0, -1] = 0
    x_send = normal((d, d, nlx, cap, h), 1)
    w = {"w_up": normal((d * nlx, h, i), h),
         "w_down": normal((d * nlx, i, h), i),
         "b_up": normal((d * nlx, i), 8), "b_down": normal((d * nlx, h), 8),
         "w_gate": normal((d * nlx, h, i), h) if gated else None}
    return torch.from_numpy(counts), x_send, w


def _walk_fused(counts, x_send, w, so, schedule, act_name, gated):
    """The function the task list implies, as the kernel computes it:
    phase 1 puts each occupied slab's rows into its owner's x_recv (the
    rest of a tile NaN), each up task writes its column tile of its live
    tiles' hidden rows, each down task its column tile of the populated
    rows of y_back[src, owner, e, slot], in the list's order; a down task
    finds every hidden column of its tiles written.  Returns y_back with
    NaN past each count."""
    d, _, nlx, cap, h = x_send.shape
    i = w["w_up"].shape[-1]
    act = activation_fn(act_name)
    ch = -(-cap // ROW) * ROW
    n_tiles = ch // ROW
    n_up, n_down = fused.col_tiles(i, gated), fused.col_tiles(h)
    up_cols = fused.TASK_COLS // (2 if gated else 1)
    nan = float("nan")
    x_recv = torch.full((d, d, nlx, ch, h), nan)
    for src in range(d):
        for r in range(d):
            for e in range(nlx):
                c = int(counts[src, r, e])
                x_recv[r, src, e, :c] = x_send[src, r, e, :c]
    hidden = torch.full((d, d, nlx, ch, i), nan)
    y_back = torch.full((d, d, nlx, ch, h), nan)
    order = fused.task_order(so, nlx, n_tiles, n_up, n_down, schedule)
    for r in range(d):
        for a, b, kj, _ in order[r]:
            kind, j = kj >> 16, kj & 0xffff
            for code in (a, b):
                if code < 0:
                    continue
                src, e, t = _decode(code, nlx, n_tiles)
                rows = _live(counts, src, r, e, t, cap)
                if rows <= 0:
                    continue
                ge, rs = r * nlx + e, slice(t * ROW, (t + 1) * ROW)
                if kind == 0:
                    n0, n1 = j * up_cols, min((j + 1) * up_cols, i)
                    xt = x_recv[r, src, e, rs]
                    up = xt @ w["w_up"][ge, :, n0:n1] + w["b_up"][ge, n0:n1]
                    hidden[r, src, e, rs, n0:n1] = (
                        act(xt @ w["w_gate"][ge, :, n0:n1]) * up if gated
                        else act(up))
                else:
                    n0, n1 = j * fused.TASK_COLS, min(
                        (j + 1) * fused.TASK_COLS, h)
                    hid = hidden[r, src, e, rs][:rows]
                    assert not hid.isnan().any()
                    y_back[src, r, e, t * ROW:t * ROW + rows, n0:n1] = (
                        hid @ w["w_down"][ge, :, n0:n1]
                        + w["b_down"][ge, n0:n1])
    return y_back[:, :, :, :cap]


@pytest.mark.parametrize("d,gated,act,schedule", [
    (3, True, "silu", "batched"), (3, True, "silu", "stream"),
    (2, False, "gelu", "rowwin")],
    ids=["ep3_swiglu_batched", "ep3_swiglu_stream", "ep2_gelu_rowwin"])
def test_task_walk_computes_jax_grouped_ffn(d, gated, act, schedule):
    """The walk over the task list against JAX's ``grouped_ffn`` (Pallas,
    interpret mode) on each owner's received rows (every source's rows of
    each of its experts, padded to the 64-row tile): equal within 2e-4 at
    every populated row, capacity above the row tile, H and I that are
    not multiples of the column tile, a random source order."""
    nlx, cap, h, i = 2, 96, 320, 320
    rng = np.random.default_rng(51 + d)
    counts, x_send, w = _shard(rng, d, nlx, cap, h, i, gated)
    so = _random_src_order(rng, d)
    got = _walk_fused(counts, x_send, w, so, schedule, act, gated)
    for r in range(d):
        rows, gid, where = [], [], []
        for e in range(nlx):
            n = 0
            for s in range(d):
                c = int(counts[s, r, e])
                rows.append(x_send[s, r, e, :c])
                where.append((s, e, c))
                n += c
            pad = -(-n // ROW) * ROW - n
            rows.append(torch.zeros(pad, h))
            where.append((None, e, pad))
            gid += [e] * ((n + pad) // ROW)
        if not gid:
            continue
        own = slice(r * nlx, (r + 1) * nlx)
        want = np.asarray(jexp.grouped_ffn(
            jnp.asarray(torch.cat(rows).numpy()), jnp.asarray(gid, np.int32),
            w["w_up"][own].numpy(), w["b_up"][own].numpy(),
            w["w_down"][own].numpy(), w["b_down"][own].numpy(),
            None if w["w_gate"] is None else w["w_gate"][own].numpy(),
            act_name=act, gated=gated, block_m=ROW, block_i=64,
            interpret=True))
        at = 0
        for s, e, c in where:
            if s is not None:
                np.testing.assert_allclose(got[s, r, e, :c].numpy(),
                                           want[at:at + c], rtol=2e-4,
                                           atol=2e-4)
            at += c
