"""PyTorch port: the five-axis mesh (dp, pp, ep, tp, sp) against the JAX
package on its 8-device CPU mesh, on the same numpy inputs: ``make_mesh``'s
sizes, dp fold and errors; the placement specs, ``shard_params``' blocks
and ``state_shardings`` leaf for leaf; the three EP layers with tokens
over (dp, ep, sp), a capacity case among them; ``forward`` over
dp 2 x ep 2 x sp 2; and one dp x ep train step.  JAX's sharded functions
are jitted at XLA's CPU optimisation level 0.  The fused layer is held
against the port's collective layer (JAX's runs only in interpret
mode)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from flashmoe_tpu.models import transformer as jtf
from flashmoe_tpu.parallel import ep as jep
from flashmoe_tpu.parallel import mesh as jmesh
from flashmoe_tpu.parallel import ragged_ep as jrag
from flashmoe_tpu.runtime import trainer as jtrainer
from flashmoe_tpu_torch.convert import (params_from_numpy,
                                        train_state_from_numpy)
from flashmoe_tpu_torch.models import transformer as ttf
from flashmoe_tpu_torch.parallel import ep as tep
from flashmoe_tpu_torch.parallel import fused as tfused
from flashmoe_tpu_torch.parallel import mesh as tmesh
from flashmoe_tpu_torch.parallel import ragged_ep as trag
from flashmoe_tpu_torch.runtime import trainer as ttrainer

from test_torch_ep import LAYER, TOL, assert_close, assert_layer, jax0, \
    moe_params
from test_torch_ep import _cfgs as _layer_cfgs
from test_torch_train import (_assert_tree_close, _batches, _cfgs,
                              _compile, _numpy_params)

AXES3 = ("dp", "ep", "sp")


def _jmesh(jc, n=8, **kw):
    return jmesh.make_mesh(jc, devices=jax.devices()[:n], **kw)


def _tmesh(tc, **kw):
    return tmesh.make_mesh(tc, device="cpu", **kw)


# ----------------------------------------------------------------------
# the mesh and the specs
# ----------------------------------------------------------------------

MESHES = [
    # (config fields, make_mesh keywords, ranks)
    (dict(ep=2, sp=2), {}, 8),             # dp folds to 2
    (dict(ep=2), dict(dp=2, pp=2), 8),
    (dict(pp=4, dp=2), {}, 8),
    (dict(ep=2, tp=2), {}, 4),
    (dict(ep=2), dict(dp=1), 8),           # dp pinned: refused
    (dict(ep=2, sp=2), {}, 6),             # 6 % 4: refused
    ({}, dict(ep=3), 4),
]


@pytest.mark.parametrize("case", range(len(MESHES)))
def test_make_mesh_matches_jax(case):
    fields, kw, n = MESHES[case]
    jc, tc = _layer_cfgs(**LAYER, **fields)
    try:
        want = dict(_jmesh(jc, n, **kw).shape)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            _tmesh(tc, devices=n, **kw)
        assert str(got.value) == str(e)
        return
    m = _tmesh(tc, devices=list(range(n)), **kw)
    assert m.shape == want and list(m.shape) == list(tmesh.AXES)
    assert m.size == n and m.ranks == tuple(range(n))
    # rank r is the row-major index over the axes, as JAX's device array
    jm = _jmesh(jc, n, **kw)
    for r, dev in enumerate(jm.devices.flat):
        where = np.argwhere(jm.devices == dev)[0]
        assert tuple(m.coord(r, a) for a in tmesh.AXES) == tuple(where)


SPEC_CFGS = [
    dict(ep=2),
    dict(ep=2, tp=2, gated_ffn=True, num_shared_experts=1),
    dict(tp=2, num_layers=4, moe_frequency=2),
    dict(num_experts=1, expert_top_k=1),
]


def _spec_leaves(tree):
    return jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, (P, tuple)) and all(
            a is None or isinstance(a, (str, tuple)) for a in x))


@pytest.mark.parametrize("case", range(len(SPEC_CFGS)))
def test_specs_match_jax(case):
    jc, tc = _layer_cfgs(**{**LAYER, "num_layers": 2, **SPEC_CFGS[case]})
    want = jmesh.moe_param_specs(jc)
    got = tmesh.moe_param_specs(tc)
    assert got == {k: tuple(v) for k, v in want.items()}
    assert tmesh.token_spec() == tuple(jmesh.token_spec())
    jt = jmesh.transformer_param_specs(jc)
    tt = tmesh.transformer_param_specs(tc)
    assert jax.tree_util.tree_structure(jt, is_leaf=lambda x: isinstance(
        x, P)) == jax.tree_util.tree_structure(
        tt, is_leaf=lambda x: isinstance(x, tuple))
    assert [tuple(s) for s in _spec_leaves(jt)] == _spec_leaves(tt)


def test_shard_params_blocks_match_jax():
    """Each rank's blocks of every MoE leaf equal the data JAX's
    ``shard_params`` puts on that rank's device (dp 2 x ep 2 x tp 2)."""
    jc, tc = _layer_cfgs(**LAYER, ep=2, tp=2, dp=2, gated_ffn=True,
                         num_shared_experts=1, sequence_len=64)
    p = moe_params(tc, seed=4)
    jm = _jmesh(jc)
    placed = jmesh.shard_params({k: jnp.asarray(v) for k, v in p.items()},
                                jc, jm)
    got = tmesh.shard_params(params_from_numpy(p, device="cpu"), tc,
                             _tmesh(tc))
    for k, arr in placed.items():
        by_dev = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
        for r, dev in enumerate(jm.devices.flat):
            np.testing.assert_array_equal(got[r][k].numpy(), by_dev[dev],
                                          err_msg=f"{k} rank {r}")


@pytest.mark.parametrize("guard", [False, True], ids=["plain", "guard"])
def test_state_shardings_match_jax(guard):
    jc, tc = _cfgs(ep=2, tp=2, num_shared_experts=1, moe_frequency=2)
    jopt = jtrainer.make_optimizer(jc)
    params = jax.tree_util.tree_map(jnp.asarray, _numpy_params(jc))
    jstate = jtrainer.TrainState(
        params, jopt.init(params), jnp.zeros((), jnp.int32),
        jtrainer.init_guard_state() if guard else None)
    want = jtrainer.state_shardings(jstate, jc, _jmesh(jc, 4))
    tstate = train_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstate), device="cpu")
    got = ttrainer.state_shardings(tstate, tc, _tmesh(tc))

    def specs(tree):
        return [tuple(s.spec) for s in jax.tree_util.tree_leaves(tree)]

    assert specs(want.params) == _spec_leaves(got.params)
    adam, sched = want.opt_state[1][0], want.opt_state[1][2]
    assert specs(adam.mu) == _spec_leaves(got.opt_state.mu)
    assert specs(adam.nu) == _spec_leaves(got.opt_state.nu)
    assert got.opt_state.count == tuple(adam.count.spec) \
        == tuple(sched.count.spec) == ()
    assert got.step == tuple(want.step.spec) == ()
    if guard:
        assert list(got.guard) == [tuple(s.spec) for s in want.guard]
    else:
        assert got.guard is None and want.guard is None


# ----------------------------------------------------------------------
# the EP layers with tokens over (dp, ep, sp)
# ----------------------------------------------------------------------

LAYER_CASES = {
    # name: (layer, config fields)
    "collective_cf1.0_stats": ("collective", dict(capacity_factor=1.0,
                                                  collect_stats=True)),
    "collective_gated_shared": ("collective", dict(
        gated_ffn=True, hidden_act="silu", num_shared_experts=1,
        drop_tokens=False)),
    "ragged_stats": ("ragged", dict(drop_tokens=False, collect_stats=True)),
}


@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_ep_layers_over_token_axes_match_jax(case):
    """dp 2 x ep 2 x sp 2: rank (d, e, s) holds token shard d * 4 + e * 2
    + s.  In the capacity case which tokens share a shard decides which
    are dropped: a shard order other than JAX's drops other tokens."""
    layer, fields = LAYER_CASES[case]
    jc, tc = _layer_cfgs(**{**LAYER, "sequence_len": 256, "ep": 2, "dp": 2,
                            "sp": 2, **fields})
    p = moe_params(tc, seed=11)
    x = np.random.default_rng(12).standard_normal((256, 64)).astype(
        np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    if layer == "ragged":
        want = jax0(jrag.ragged_ep_moe_layer, jp, jnp.asarray(x), cfg=jc,
                    mesh=_jmesh(jc), token_axes=AXES3)
        fn = trag.ragged_ep_moe_layer
    else:
        want = jax0(jep.ep_moe_layer, jp, jnp.asarray(x), cfg=jc,
                    mesh=_jmesh(jc), use_pallas=False, token_axes=AXES3)
        fn = tep.ep_moe_layer
    got = fn(params_from_numpy(p, device="cpu"), torch.from_numpy(x), tc,
             _tmesh(tc), token_axes=AXES3)
    assert_layer(got, want, TOL["f32"])
    if tc.drop_tokens:
        assert float(got.stats.dropped_fraction) > 0.05  # drops happen
    if layer == "collective":
        # the fused layer: one kernel world per (dp, sp) fibre
        fz = tfused.fused_ep_moe_layer(params_from_numpy(p, device="cpu"),
                                       torch.from_numpy(x), tc, _tmesh(tc),
                                       token_axes=AXES3)
        assert_close(fz.out, want.out, TOL["f32"])
        assert torch.equal(fz.expert_counts, got.expert_counts)
        torch.testing.assert_close(fz.aux_loss, got.aux_loss)


# ----------------------------------------------------------------------
# the model over dp x ep x sp, and a dp train step
# ----------------------------------------------------------------------

MODEL = dict(num_experts=4, expert_top_k=2, hidden_size=64,
             intermediate_size=128, num_layers=2, vocab_size=256,
             num_heads=4, num_kv_heads=2, capacity_factor=1.0)


@pytest.mark.parametrize("backend", ["collective", "ragged"])
def test_forward_over_dp_ep_sp_matches_jax(backend):
    """JAX's ``test_sequence_parallel_forward`` layout: ring attention
    over sp, the MoE layers' tokens over (dp, ep, sp); the fused backend
    against the collective one."""
    jc, tc = _layer_cfgs(**MODEL, ep=2, sp=2, dp=2, moe_backend=backend,
                         drop_tokens=backend == "collective")
    jparams = jax.tree_util.tree_map(jnp.asarray, _numpy_params(jc))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    tok = np.random.default_rng(2).integers(0, 256, (2, 32)).astype(np.int32)
    want, waux = jax0(jtf.forward, jparams, jnp.asarray(tok), cfg=jc,
                      mesh=_jmesh(jc), use_pallas=False)
    m = _tmesh(tc)
    got, aux = ttf.forward(tparams, torch.from_numpy(tok), tc, mesh=m)
    assert_close(got, want, TOL["f32"])
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-5)
    if backend == "collective":
        fz, faux = ttf.forward(tparams, torch.from_numpy(tok),
                               tc.replace(moe_backend="fused"), mesh=m)
        torch.testing.assert_close(fz, got, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(faux, aux)
    with pytest.raises(ValueError, match="mesh of 2 ranks"):
        ttf.forward(tparams, torch.from_numpy(tok), tc,
                    mesh=_tmesh(tc.replace(dp=1, sp=1)))


def test_dp_train_step_matches_jax():
    """One ``make_train_step`` step over dp 2 x ep 2 from the same state
    as JAX's jitted step (the batch over dp, the MoE tokens over (dp,
    ep)): losses, metrics, parameters and moments."""
    jc, tc = _cfgs(ep=2, dp=2, moe_frequency=1)
    lr = 1e-3
    jopt = jtrainer.make_optimizer(jc, lr=lr, warmup_steps=1, total_steps=4)
    jm = _jmesh(jc, 4)
    jstep = jtrainer.make_train_step(jc, jm, jopt, use_pallas=False)
    params = jax.tree_util.tree_map(jnp.asarray, _numpy_params(jc))
    jstate = jtrainer.TrainState(params, jopt.init(params),
                                 jnp.zeros((), jnp.int32))
    jstate = jax.device_put(jstate, jtrainer.state_shardings(jstate, jc, jm))
    tstate = train_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstate), device="cpu")
    tokens = _batches(1, seed=8)[0]
    batch = {"tokens": jnp.asarray(tokens)}
    jstate, jmet = _compile(jstep, jstate, batch)(jstate, batch)
    topt = ttrainer.make_optimizer(tc, lr=lr, warmup_steps=1, total_steps=4)
    step = ttrainer.make_train_step(tc, topt, mesh=_tmesh(tc))
    tstate, tmet = step(tstate, {"tokens": torch.from_numpy(tokens)})
    for k in ("loss", "ce", "aux", "grad_norm"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                   rtol=1e-4, err_msg=k)
    _assert_tree_close(tstate.params, jstate.params, rtol=0, atol=lr / 100)
    _assert_tree_close(tstate.opt_state.mu, jstate.opt_state[1][0].mu,
                       rtol=2e-3, atol=1e-5)
