"""PyTorch port: the fused layer's backward (``_FusedCore``,
``_FusedCombineCore`` and ``_ffn_bwd_from_dy`` in
``flashmoe_tpu_torch/parallel/fused.py``), with the kernel's plain version
as the forward on the CPU, against ``jax.grad`` of the JAX package's
collective ``ep_moe_layer(use_pallas=False)`` on the same numpy inputs:
the same comparison as JAX's own
``test_fused_gradients_match_collective_path`` (JAX's fused layer itself
runs only in Pallas interpret mode, which these tests never call)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashmoe_tpu.parallel import ep as jep
from flashmoe_tpu.parallel.mesh import make_mesh
from flashmoe_tpu_torch.convert import params_from_numpy
from flashmoe_tpu_torch.parallel import fused
from flashmoe_tpu_torch.parallel.mesh import local_mesh

from test_torch_ep import LAYER, TOL, _cfgs, jax0, moe_params, tokens

CASES = {
    # name: (ep, config fields)
    "plain": (4, dict(drop_tokens=False)),
    "gated": (4, dict(drop_tokens=False, gated_ffn=True,
                      hidden_act="silu")),
    "drops": (4, dict(capacity_factor=1.0)),
    "gated_shared_ep2": (2, dict(gated_ffn=True, hidden_act="gelu",
                                 num_shared_experts=1,
                                 capacity_factor=1.25)),
}


def _jax_grads(p, x, jc, ep):
    mesh = make_mesh(jc, dp=1, devices=jax.devices()[:ep])

    def jloss(jp, jx, cfg, mesh):
        o = jep.ep_moe_layer(jp, jx, cfg, mesh, use_pallas=False)
        return jnp.sum(o.out.astype(jnp.float32) ** 2) + o.aux_loss

    jp = {k: jnp.asarray(v) for k, v in p.items()}
    wp, wx = jax0(jax.grad(jloss, argnums=(0, 1)), jp, jnp.asarray(x),
                  cfg=jc, mesh=mesh)
    return {"x": np.asarray(wx), **{k: np.asarray(v) for k, v in wp.items()}}


def _port_grads(p, x, tc, ep):
    leaves = {k: v.requires_grad_(True)
              for k, v in params_from_numpy(p, device="cpu").items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    o = fused.fused_ep_moe_layer(leaves, tx, tc, local_mesh(ep))
    loss = (o.out.float() ** 2).sum() + o.aux_loss
    grads = torch.autograd.grad(loss, [tx, *leaves.values()])
    return dict(zip(["x", *leaves], grads))


@pytest.mark.parametrize("combine", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_fused_gradients_match_jax(case, combine, monkeypatch):
    """Every leaf's gradient and the input's, through the layer combine
    (``_FusedCore``) and the in-kernel combine (``_FusedCombineCore``,
    whose ``w_sorted`` carries the router's gradient)."""
    if combine:
        monkeypatch.setenv("FLASHMOE_FUSED_COMBINE", "1")
    ep, fields = CASES[case]
    jc, tc = _cfgs(**{**LAYER, "sequence_len": 32 * ep, "ep": ep, **fields})
    p, x = moe_params(tc, seed=ep + 20), tokens(tc, seed=ep + 20)
    want = _jax_grads(p, x, jc, ep)
    got = _port_grads(p, x, tc.replace(moe_backend="fused"), ep)
    assert set(got) == set(want)
    for name, g in got.items():
        w = want[name]
        np.testing.assert_allclose(
            g.numpy(), w, rtol=TOL["f32"],
            atol=TOL["f32"] * max(1.0, float(np.abs(w).max())),
            err_msg=name)


def test_combine_backward_masks_unwritten_rows():
    """``_FusedCombineCore``'s backward on a y_sorted whose unwritten rows
    hold NaN (as the kernel leaves them): every gradient stays finite and
    equals the one with zeros there."""
    ep = 4
    _, tc = _cfgs(**{**LAYER, "sequence_len": 32 * ep, "ep": ep,
                     "capacity_factor": 1.0})
    p, x = moe_params(tc, 9), tokens(tc, 9)
    shard = fused.fused_shard

    def nan_tail(*a, return_sorted=False, **kw):
        out = shard(*a, return_sorted=return_sorted, **kw)
        if not return_sorted:
            return out
        out, y_sorted = out
        written = torch.zeros(y_sorted.shape[:2], dtype=torch.bool)
        pos = kw["recv_pos"].transpose(0, 1).long()  # [src, owner, e, C]
        live = torch.arange(pos.shape[-1]) < a[0][..., None]
        for s in range(pos.shape[0]):
            written[s, pos[s][live[s]]] = True
        return out, torch.where(written[..., None], y_sorted,
                                torch.full((), float("nan")))

    mp = pytest.MonkeyPatch()
    mp.setenv("FLASHMOE_FUSED_COMBINE", "1")
    try:
        clean = _port_grads(p, x, tc.replace(moe_backend="fused"), ep)
        mp.setattr(fused, "fused_shard", nan_tail)
        dirty = _port_grads(p, x, tc.replace(moe_backend="fused"), ep)
    finally:
        mp.undo()
    for name in clean:
        assert bool(torch.isfinite(dirty[name]).all()), name
        torch.testing.assert_close(dirty[name], clean[name], rtol=0, atol=0)


# the fused backward's recompute over the occupied slab tiles only: cases
# with slabs of 0 rows, of every row (a source's whole capacity) and in
# between, C of several 64-row tiles
DEAD_CASES = {
    # name: (ep, config fields)
    "dropless": (2, dict(drop_tokens=False)),
    "gated_dropless": (2, dict(drop_tokens=False, gated_ffn=True,
                               hidden_act="silu")),
    "drops": (2, dict(capacity_factor=2.0)),
}


def _skewed(tc, seed):
    """Parameters and tokens whose routing leaves slabs empty (no token
    picks expert 7), fills one to its capacity (every token of rank 0
    picks expert 0; dropping past the capacity when ``drop_tokens``) and
    leaves the others partial."""
    p, x = moe_params(tc, seed), tokens(tc, seed)
    s_loc = tc.tokens // tc.ep
    x[:, 0] = np.abs(x[:, 0]) + 3.0
    x[:s_loc, 1] = np.abs(x[:s_loc, 1]) + 10.0
    x[s_loc:, 1] = -np.abs(x[s_loc:, 1])
    p["gate_w"][0, 7] = -5.0
    p["gate_w"][1, 0] = 5.0
    return p, x


def _full_map(gid, counts, ch):
    return gid


def test_dead_tile_gid_marks_tiles_past_each_count():
    """Brute force on random counts (0, partial, a whole slab): entry
    (expert e, source s, tile j) of the map keeps the full map's expert
    where 64 j < counts[s, e] and is -1 elsewhere."""
    rng = np.random.default_rng(4)
    for _ in range(20):
        d, nlx = (int(v) for v in rng.integers(1, 5, 2))
        ch = 64 * int(rng.integers(1, 5))
        counts = torch.from_numpy(rng.integers(0, ch + 1, (d, nlx)))
        tiles = d * ch // 64
        gid = torch.arange(nlx * tiles) // tiles
        got = fused.dead_tile_gid(gid, counts, ch).tolist()
        want = [e if 64 * j < int(counts[s, e]) else -1
                for e in range(nlx) for s in range(d)
                for j in range(ch // 64)]
        assert got == want


@pytest.mark.parametrize("combine", [False, True],
                         ids=["layer_combine", "in_kernel_combine"])
@pytest.mark.parametrize("case", list(DEAD_CASES))
def test_dead_tile_map_changes_no_gradient(case, combine, monkeypatch):
    """Through the layer (``_FusedCore``, and ``_FusedCombineCore`` with
    the in-kernel combine), on the plain path: the gradients with the
    recompute's dead-tile map equal, bit for bit, those with the full map
    (every slab row recomputed, as JAX does), on a routing whose counts
    include 0, the whole capacity and partial slabs with dead tiles."""
    if combine:
        monkeypatch.setenv("FLASHMOE_FUSED_COMBINE", "1")
    ep, fields = DEAD_CASES[case]
    _, tc = _cfgs(**{**LAYER, "sequence_len": 160 * ep, "ep": ep, **fields})
    tc = tc.replace(moe_backend="fused")
    p, x = _skewed(tc, 31)
    seen, dead_map = [], fused.dead_tile_gid

    def spy(gid, counts, ch):
        seen.append((counts.clone(), ch))
        return dead_map(gid, counts, ch)

    monkeypatch.setattr(fused, "dead_tile_gid", spy)
    got = _port_grads(p, x, tc, ep)
    monkeypatch.setattr(fused, "dead_tile_gid", _full_map)
    want = _port_grads(p, x, tc, ep)
    counts = torch.stack([c for c, _ in seen])
    ch, cap = seen[0][1], tc.capacity_for(tc.tokens // ep)
    assert len(seen) == ep and ch // 64 >= 2
    assert (counts == 0).any() and (counts == cap).any()
    assert ((counts > 0) & (counts <= ch - 64)).any()  # a live, a dead tile
    for name, g in got.items():
        assert torch.equal(g, want[name]), name


def test_fused_core_dead_tiles_ignore_rows_past_counts(monkeypatch):
    """``_FusedCore`` straight on slabs whose rows past each count hold
    random values (the layer's dispatch leaves zeros there, the contract
    only leaves them unread), under a loss that reads the counted rows
    only: the dead-tile map's gradients equal the full map's bit for bit,
    with counts of 0, 1, partial and the whole slab."""
    d, nlx, c, h, i = 2, 2, 160, 64, 64
    rng = np.random.default_rng(5)

    def leaf(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32)).requires_grad_(True)

    e = d * nlx
    prims = (leaf(d, d, nlx, c, h), leaf(e, h, i, scale=h ** -0.5),
             leaf(e, i), leaf(e, i, h, scale=i ** -0.5), leaf(e, h),
             leaf(e, h, i, scale=h ** -0.5))
    send_cnt = torch.tensor([[[0, 160], [37, 64]], [[100, 1], [160, 0]]])
    kw = dict(act_name="silu", gated=True, schedule="stream",
              use_kernels=False)
    live = (torch.arange(c) < send_cnt[..., None])[..., None]

    def grads():
        y = fused._FusedCore.apply(*prims, send_cnt,
                                   fused.check_src_order(None, d),
                                   local_mesh(d), kw)
        loss = (torch.where(live, y, torch.zeros(())) ** 2).sum()
        return torch.autograd.grad(loss, prims)

    got = grads()
    monkeypatch.setattr(fused, "dead_tile_gid", _full_map)
    want = grads()
    for k, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), k


def test_kernel_wrapper_still_refuses_autograd():
    ep = 2
    _, tc = _cfgs(**{**LAYER, "sequence_len": 64, "ep": ep})
    fi = fused.fused_inputs(params_from_numpy(moe_params(tc, 0),
                                              device="cpu"),
                            torch.zeros(64, 64), tc, local_mesh(ep))
    args = list(fi.args)
    args[3] = args[3].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="autograd"):
        fused.fused_shard_cuda(*args, **{k: v for k, v in fi.kw.items()
                                         if k != "use_kernels"})
