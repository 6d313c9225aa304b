"""PyTorch port: the dropless ragged EP layer
(``flashmoe_tpu_torch/parallel/ragged_ep.py``) against the JAX package's
``ragged_ep_moe_layer(use_pallas=False, exchange="dense")`` on the
8-device CPU mesh, on the same numpy inputs.  Two cases take its Pallas
arm in interpret mode instead: bf16 (on bf16 weights), because JAX's XLA
fallback rounds every einsum and bias add to bf16, where the Pallas
kernel that B2 ports, and the port, accumulate in f32; and tier-0
degradation, because the fallback's one-hot weight selection spreads one
expert's NaN weight (0 * NaN) to every row of its rank, where the kernel
keeps it in that expert's rows.  Then: the layer over both of the
port's exchanges, its gradients against ``jax.grad``, the regroup maps
integer for integer, ``decode_moe_rows`` against JAX's inside a
``shard_map``, the process mesh over gloo against the local mesh, and the
FFN's ``num_rows`` tail."""

import functools
import multiprocessing

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from flashmoe_tpu.parallel import ragged_ep as jrag
from flashmoe_tpu.parallel.mesh import make_mesh
from flashmoe_tpu.utils.compat import shard_map
from flashmoe_tpu_torch.convert import params_from_numpy
from flashmoe_tpu_torch.parallel import ragged_ep as trag
from flashmoe_tpu_torch.parallel.mesh import local_mesh

from test_torch_ep import (LAYER, TOL, _cfgs, _free_port, assert_layer,
                           jax0, moe_params, tokens)

CASES = {
    # name: (dtype, ep, config fields)
    "ep2": ("f32", 2, {}),
    "ep4": ("f32", 4, {}),
    "ep8_gated": ("f32", 8, dict(gated_ffn=True, hidden_act="silu")),
    "ep4_bf16_gated": ("bf16", 4, dict(gated_ffn=True, hidden_act="silu")),
    "ep4_sloc_40": ("f32", 4, dict(sequence_len=160)),
    "ep4_chunked_stats": ("f32", 4, dict(a2a_chunks=2, collect_stats=True)),
    "ep4_e4m3_wires_stats": ("f32", 4, dict(
        wire_dtype="e4m3", wire_dtype_combine="e5m2", collect_stats=True)),
    "ep4_chunked_bf16_wire": ("bf16", 4, dict(
        a2a_chunks=2, wire_dtype="bf16", collect_stats=True)),
    "ep4_degrade_stats": ("f32", 4, dict(degrade_unhealthy_experts=True,
                                         collect_stats=True)),
}


def _case(case, **extra):
    dtype, ep, fields = CASES[case]
    kw = {**LAYER, "sequence_len": 32 * ep, "ep": ep,
          "moe_backend": "ragged", "drop_tokens": False, **fields, **extra}
    jc, tc = _cfgs(dtype, **kw)
    return dtype, ep, jc, tc


def _jax_mesh(jc, ep):
    return make_mesh(jc, dp=1, devices=jax.devices()[:ep])


def jax_ragged(p, x, jc, ep):
    pallas = jc.dtype == jnp.bfloat16 or jc.degrade_unhealthy_experts
    return jax0(jrag.ragged_ep_moe_layer,
                {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                cfg=jc, mesh=_jax_mesh(jc, ep), use_pallas=pallas,
                interpret=pallas, exchange="dense")


def _inputs(tc, seed):
    """numpy weights (bf16 ones for a bf16 layer) and f32 tokens."""
    p, x = moe_params(tc, seed=seed), tokens(tc, seed=seed)
    if tc.degrade_unhealthy_experts:
        p["w_down"][3, 0, 0] = np.nan  # expert 3 is sick
    if tc.dtype == torch.bfloat16:
        p = {k: v.astype(jnp.bfloat16) for k, v in p.items()}
    return p, x


@pytest.mark.parametrize("exchange", ["ragged", "dense"])
@pytest.mark.parametrize("case", list(CASES))
def test_ragged_layer_matches_jax(case, exchange):
    dtype, ep, jc, tc = _case(case)
    p, x = _inputs(tc, ep)
    want = jax_ragged(p, x, jc, ep)
    got = trag.ragged_ep_moe_layer(params_from_numpy(p, device="cpu"),
                                   torch.from_numpy(x), tc, local_mesh(ep),
                                   exchange=exchange)
    tol = 1e-3 if tc.wire_dtype == "e4m3" else TOL[dtype]
    assert_layer(got, want, tol)
    assert int(got.expert_counts.sum()) == tc.tokens * tc.expert_top_k
    if tc.degrade_unhealthy_experts:
        assert float(got.stats.masked_experts) > 0
        assert bool(torch.isfinite(got.out).all())


def test_every_token_to_one_expert():
    """All tokens to one expert on one rank: the worst case the buffer is
    sized for, which capacity EP drops and dropless must not."""
    _, ep, jc, tc = _case("ep4", expert_top_k=1)
    p, x = _inputs(tc, 5)
    p["gate_w"] = np.zeros_like(p["gate_w"])
    p["gate_w"][:, 5] = 1.0
    x = np.abs(x) + 0.1
    want = jax_ragged(p, x, jc, ep)
    got = trag.ragged_ep_moe_layer(params_from_numpy(p, device="cpu"),
                                   torch.from_numpy(x), tc, local_mesh(ep))
    assert_layer(got, want, TOL["f32"])
    assert int(got.expert_counts[5]) == tc.tokens


@pytest.mark.parametrize("case", ["ep4", "ep4_chunked_stats"])
def test_ragged_gradients_match_jax(case):
    """d(sum(out**2) + aux) w.r.t. x and every parameter leaf, both
    exchanges, against ``jax.grad`` of JAX's layer."""
    _, ep, jc, tc = _case(case, gated_ffn=True, hidden_act="silu")
    p, x = _inputs(tc, ep + 3)

    def jloss(jp, jx, cfg, mesh):
        o = jrag.ragged_ep_moe_layer(jp, jx, cfg, mesh, use_pallas=False,
                                     exchange="dense")
        return jnp.sum(o.out.astype(jnp.float32) ** 2) + o.aux_loss

    jp = {k: jnp.asarray(v) for k, v in p.items()}
    wp, wx = jax0(jax.grad(jloss, argnums=(0, 1)), jp, jnp.asarray(x),
                  cfg=jc, mesh=_jax_mesh(jc, ep))
    for exchange in ("ragged", "dense"):
        leaves = {k: v.requires_grad_(True)
                  for k, v in params_from_numpy(p, device="cpu").items()}
        tx = torch.from_numpy(x).requires_grad_(True)
        o = trag.ragged_ep_moe_layer(leaves, tx, tc, local_mesh(ep),
                                     exchange=exchange)
        loss = (o.out.float() ** 2).sum() + o.aux_loss
        grads = torch.autograd.grad(loss, [tx, *leaves.values()])
        for name, g, w in zip(["x", *leaves], grads,
                              [wx, *(wp[k] for k in leaves)]):
            w = np.asarray(w)
            np.testing.assert_allclose(
                g.numpy(), w, rtol=TOL["f32"],
                atol=TOL["f32"] * max(1.0, float(np.abs(w).max())),
                err_msg=f"{exchange} {name}")


def test_regroup_maps_equal_jax():
    """``_regroup_maps`` on random count matrices (empty sources and
    experts included), integer for integer against JAX's."""
    rng = np.random.default_rng(0)
    for d, ne, bm, n_assign in ((2, 4, 64, 64), (4, 2, 64, 40),
                                (8, 1, 128, 32), (4, 3, 64, 100)):
        for _ in range(3):
            cm = rng.multinomial(n_assign, np.ones(d * ne) / (d * ne),
                                 size=1).reshape(d, ne) * \
                (rng.random((d, ne)) < 0.8)
            sizes = cm.sum(1).astype(np.int32)
            offs = (np.cumsum(sizes) - sizes).astype(np.int32)
            bound = d * n_assign
            want = jax.jit(jrag._regroup_maps, static_argnums=(3, 4))(
                jnp.asarray(cm, jnp.int32), jnp.asarray(offs),
                jnp.asarray(sizes), bound, bm)
            got = trag._regroup_maps(torch.from_numpy(cm), torch.from_numpy(
                offs), torch.from_numpy(sizes), bound, bm)
            np.testing.assert_array_equal(got[0].numpy(),
                                          np.asarray(want[0]))
            assert got[1] == want[1]
            np.testing.assert_array_equal(got[2].numpy(),
                                          np.asarray(want[2]))
            assert int(got[3]) == int(want[3])
            epad = -(-cm.sum(0) // bm) * bm
            assert int(got[4]) == int(epad.sum())


def test_decode_moe_rows_matches_jax_inside_shard_map():
    """Each rank's decode rows (two a rank) through ``decode_moe_rows``,
    against JAX's called inside a ``shard_map`` over the ep axis."""
    _, ep, jc, tc = _case("ep4", gated_ffn=True, hidden_act="silu",
                          sequence_len=8)
    p, x = _inputs(tc, 11)
    mesh = _jax_mesh(jc, ep)

    def body(jp, jx, cfg):
        o = jrag.decode_moe_rows(jp, jx, cfg, exchange="dense")
        return o.out, o.expert_counts

    specs = {k: P("ep") if k != "gate_w" else P() for k in p}
    fn = shard_map(functools.partial(body, cfg=jc), mesh=mesh,
                   in_specs=(specs, P("ep", None)),
                   out_specs=(P("ep", None), P()), check_vma=False)
    want, counts = jax0(fn, {k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x))
    m = local_mesh(ep)
    tx = torch.from_numpy(x)
    for exchange in ("ragged", "dense"):
        got = trag.decode_moe_rows(
            m.shard_params(params_from_numpy(p, device="cpu")), m.split(tx),
            tc, m, exchange=exchange)
        assert [o.shape[0] for o in got.out] == [2] * ep
        np.testing.assert_allclose(torch.cat(got.out).numpy(),
                                   np.asarray(want), rtol=TOL["f32"],
                                   atol=TOL["f32"])
        assert np.array_equal(got.expert_counts.numpy(), np.asarray(counts))


def test_num_rows_tail_changes_nothing(monkeypatch):
    """The FFN handed the live padded row count gives the same outputs
    and gradients as over the whole worst-case buffer."""
    _, ep, _, tc = _case("ep4_chunked_stats", gated_ffn=True,
                         hidden_act="silu")
    p, x = _inputs(tc, 2)

    def run():
        leaves = {k: v.requires_grad_(True)
                  for k, v in params_from_numpy(p, device="cpu").items()}
        tx = torch.from_numpy(x).requires_grad_(True)
        o = trag.ragged_ep_moe_layer(leaves, tx, tc, local_mesh(ep))
        loss = (o.out.float() ** 2).sum() + o.aux_loss
        return [o.out.detach(), *torch.autograd.grad(
            loss, [tx, *leaves.values()])]

    seen = []
    ffn = trag._grouped_ffn

    def spy(*a, num_rows=None, **kw):
        seen.append(int(num_rows))
        return ffn(*a, num_rows=num_rows, **kw)

    monkeypatch.setattr(trag, "_grouped_ffn", spy)
    tail = run()
    # a few live tiles of the worst-case buffer: 4 x 64 tokens x top-2
    # over 4 x 4 local experts, each padded to the 64-row tile
    assert seen and max(seen) < 4 * 2 * 64 + 4 * 64
    monkeypatch.setattr(
        trag, "_grouped_ffn",
        lambda *a, num_rows=None, **kw: ffn(*a, num_rows=None, **kw))
    whole = run()
    for a, b in zip(tail, whole):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_layer_refusals():
    _, _, _, tc = _case("ep2")
    p = params_from_numpy(moe_params(tc, 0), device="cpu")
    x = torch.zeros(tc.tokens, tc.hidden_size)
    with pytest.raises(ValueError, match="exchange"):
        trag.ragged_ep_moe_layer(p, x, tc, local_mesh(2), exchange="x")
    with pytest.raises(ValueError, match="tp 1"):
        trag.ragged_ep_moe_layer(p, x, tc.replace(moe_backend="collective"),
                                 local_mesh(1, tp=2))
    with pytest.raises(NotImplementedError, match="shared experts"):
        trag.ragged_ep_moe_layer(p, x, tc.replace(
            moe_backend="collective", num_shared_experts=1), local_mesh(2))


def _gloo_rank(rank, world, port, p, x, cfg, queue):
    import torch.distributed as dist

    from flashmoe_tpu_torch.parallel.mesh import process_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        s = x.shape[0] // world
        for exchange in ("ragged", "dense"):
            o = trag.ragged_ep_moe_layer(p, x[rank * s:(rank + 1) * s], cfg,
                                         process_mesh(), exchange=exchange)
            queue.put((rank, exchange, o.out.numpy(), o.aux_loss.numpy(),
                       o.expert_counts.numpy(),
                       [t.numpy() for t in o.stats]))
    finally:
        dist.destroy_process_group()


def test_process_mesh_over_gloo_equals_local_mesh():
    """Two processes, one rank each, over gloo (the ragged exchange as
    ``all_to_all_single`` with split sizes, then the dense one): the same
    outputs, losses, counts and stats as the local mesh; a 60 s join
    bound makes a hang a failure."""
    _, _, _, tc = _case("ep2", collect_stats=True, wire_dtype="e4m3",
                        a2a_chunks=2)
    p = params_from_numpy(moe_params(tc, 7), device="cpu")
    x = torch.from_numpy(tokens(tc, 7))
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_gloo_rank,
                         args=(r, 2, port, p, x, tc, queue))
             for r in range(2)]
    for proc in procs:
        proc.start()
    try:
        got = {(r, ex): rest for r, ex, *rest in
               (queue.get(timeout=60) for _ in range(2 * len(procs)))}
    finally:
        for proc in procs:
            proc.join(timeout=60)
            if proc.is_alive():
                proc.kill()
    assert all(proc.exitcode == 0 for proc in procs)
    for exchange in ("ragged", "dense"):
        want = trag.ragged_ep_moe_layer(p, x, tc, local_mesh(2),
                                        exchange=exchange)
        out = np.concatenate([got[0, exchange][0], got[1, exchange][0]])
        np.testing.assert_array_equal(out, want.out.numpy())
        for r in range(2):
            _, aux, counts, stats = got[r, exchange]
            np.testing.assert_array_equal(counts,
                                          want.expert_counts.numpy())
            np.testing.assert_allclose(aux, want.aux_loss.numpy(),
                                       rtol=1e-6)
            for name, g, w in zip(want.stats._fields, stats, want.stats):
                np.testing.assert_allclose(g, w.numpy(), rtol=1e-6,
                                           atol=1e-7, err_msg=name)
