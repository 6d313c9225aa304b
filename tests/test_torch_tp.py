"""PyTorch port: tensor-parallel experts in the collective EP layer.

``ep_moe_layer`` on a local mesh of ep x tp virtual ranks (each expert's
intermediate dimension Megatron-split over tp, the FFN summed over each
tp group) against the JAX package's ``ep_moe_layer(use_pallas=False)`` on
``make_mesh(ep=..., tp=2)`` of the 8-device CPU mesh, on the same numpy
inputs: forward and the gradients of ``sum(out**2) + aux``; the mesh's
tp placement; and the process mesh's refusal of tp."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashmoe_tpu.parallel import ep as jep
from flashmoe_tpu.parallel.mesh import make_mesh
from flashmoe_tpu_torch.convert import params_from_numpy
from flashmoe_tpu_torch.parallel import ep as tep
from flashmoe_tpu_torch.parallel.mesh import Mesh, local_mesh

from test_torch_ep import (LAYER, TOL, _cfgs, assert_layer, jax0,
                           moe_params, tokens)

CASES = {
    # name: (dtype, ep, config fields)
    "ep2_tp2": ("f32", 2, dict(drop_tokens=False)),
    "ep2_tp2_gated_shared_stats": ("f32", 2, dict(
        gated_ffn=True, hidden_act="silu", num_shared_experts=1,
        collect_stats=True)),
    "ep4_tp2_chunked": ("f32", 4, dict(a2a_chunks=2, capacity_factor=1.0)),
    "ep4_tp2_bf16_gated": ("bf16", 4, dict(gated_ffn=True,
                                           hidden_act="silu")),
}


def _mesh_cfgs(case):
    dtype, ep, fields = CASES[case]
    jc, tc = _cfgs(dtype, **{**LAYER, "sequence_len": 32 * ep, "ep": ep,
                             "tp": 2, **fields})
    return dtype, ep, jc, tc


def _jax_layer(jc, ep, p, x):
    mesh = make_mesh(jc, dp=1, ep=ep, tp=2, devices=jax.devices()[:2 * ep])
    return jax0(jep.ep_moe_layer, {k: jnp.asarray(v) for k, v in p.items()},
                jnp.asarray(x), cfg=jc, mesh=mesh, use_pallas=False)


@pytest.mark.parametrize("case", list(CASES))
def test_tp_layer_matches_jax(case):
    dtype, ep, jc, tc = _mesh_cfgs(case)
    p, x = moe_params(tc, seed=ep), tokens(tc, seed=ep)
    want = _jax_layer(jc, ep, p, x)
    got = tep.ep_moe_layer(params_from_numpy(p, device="cpu"),
                           torch.from_numpy(x), tc, local_mesh(ep, tp=2))
    assert_layer(got, want, TOL[dtype])


@pytest.mark.parametrize("case", ["ep2_tp2", "ep4_tp2_chunked"])
def test_tp_gradients_match_jax(case):
    """d(sum(out**2) + aux) w.r.t. x and every parameter leaf, against
    ``jax.grad`` of JAX's layer on its ep x tp mesh."""
    dtype, ep, jc, tc = _mesh_cfgs(case)
    p, x = moe_params(tc, seed=ep + 1), tokens(tc, seed=ep + 1)
    mesh = make_mesh(jc, dp=1, ep=ep, tp=2, devices=jax.devices()[:2 * ep])

    def jloss(jp, jx, cfg, mesh):
        o = jep.ep_moe_layer(jp, jx, cfg, mesh, use_pallas=False)
        return jnp.sum(o.out.astype(jnp.float32) ** 2) + o.aux_loss

    jp = {k: jnp.asarray(v) for k, v in p.items()}
    wx, wp = jax0(jax.grad(jloss, argnums=(0, 1)), jp, jnp.asarray(x),
                  cfg=jc, mesh=mesh)[::-1]
    leaves = {k: v.requires_grad_(True)
              for k, v in params_from_numpy(p, device="cpu").items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    o = tep.ep_moe_layer(leaves, tx, tc, local_mesh(ep, tp=2))
    loss = (o.out.float() ** 2).sum() + o.aux_loss
    grads = torch.autograd.grad(loss, [tx, *leaves.values()])
    scale = lambda w: max(1.0, float(np.abs(np.asarray(w)).max()))
    for name, g, w in zip(["x", *leaves], grads,
                          [wx, *(wp[k] for k in leaves)]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   rtol=TOL[dtype],
                                   atol=TOL[dtype] * scale(w), err_msg=name)


def test_tp_mesh_places_megatron_slices():
    """Rank r is ep rank r // tp, tp rank r % tp: its experts' column
    slices of w_up / w_gate / b_up, row slice of w_down (contiguous
    copies), b_down and gate_w whole; tokens replicated over tp; the tp
    sum and the ep reductions over the right ranks."""
    _, tc = _cfgs(**LAYER, gated_ffn=True, ep=2, tp=2)
    p = params_from_numpy(moe_params(tc, 3), device="cpu")
    m = local_mesh(2, tp=2)
    assert (m.size, m.ep, m.tp) == (4, 2, 2)
    shards = m.shard_params(p)
    i = tc.intermediate_size // 2
    for r, sp in enumerate(shards):
        e, t = divmod(r, 2)
        ex = slice(4 * e, 4 * e + 4)
        cols = slice(t * i, (t + 1) * i)
        for k in ("w_up", "w_gate"):
            assert torch.equal(sp[k], p[k][ex, :, cols])
            assert sp[k].is_contiguous()
        assert torch.equal(sp["b_up"], p["b_up"][ex, cols])
        assert torch.equal(sp["w_down"], p["w_down"][ex, cols])
        assert sp["w_down"].is_contiguous()
        assert torch.equal(sp["b_down"], p["b_down"][ex])
        assert sp["gate_w"] is p["gate_w"]
    x = torch.arange(8.0).reshape(4, 2)
    xs = m.split(x)
    assert [t.tolist() for t in xs[::2]] == [t.tolist() for t in xs[1::2]]
    assert torch.equal(m.join(xs), x)
    ts = [torch.tensor([float(r)]) for r in range(4)]
    assert [float(t) for t in m.tp_psum(ts)] == [1.0, 1.0, 5.0, 5.0]
    assert float(m.psum(ts)) == 2.0  # tp rank 0 of each ep rank
    a2a = m.all_to_all([torch.tensor([10.0 * r, 10.0 * r + 1])
                        for r in range(4)])
    assert [t.tolist() for t in a2a] == [[0, 20], [10, 30], [1, 21],
                                         [11, 31]]


def test_process_mesh_refuses_tp():
    with pytest.raises(NotImplementedError, match="multi-GPU transport"):
        Mesh(4, (0,), group=object(), tp=2)
