"""PyTorch port: the expert-parallel MoE layer over collectives against the
JAX package's ``ep_moe_layer(use_pallas=False)`` on the 8-device CPU mesh,
on the same numpy inputs (the port's local mesh holds every rank in one
process and runs the kernels' plain versions on the CPU); the mesh's
exchanges, the process mesh over gloo, and ``forward`` with a mesh."""

import functools
import multiprocessing
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashmoe_tpu.config import MoEConfig as JaxConfig
from flashmoe_tpu.models import transformer as jtf
from flashmoe_tpu.parallel import ep as jep
from flashmoe_tpu.parallel.mesh import make_mesh
from flashmoe_tpu_torch.config import MoEConfig as TorchConfig
from flashmoe_tpu_torch.convert import params_from_numpy
from flashmoe_tpu_torch.models import transformer as ttf
from flashmoe_tpu_torch.parallel import ep as tep
from flashmoe_tpu_torch.parallel.mesh import local_mesh

_DT = {"f32": (jnp.float32, torch.float32),
       "bf16": (jnp.bfloat16, torch.bfloat16)}
# the JAX package's oracle tolerances (tests/test_moe_layer.py)
TOL = {"f32": 2e-4, "bf16": 5e-3}
LAYER = dict(num_experts=8, expert_top_k=2, hidden_size=64,
             intermediate_size=64)


def _cfgs(dtype="f32", **kw):
    jd, td = _DT[dtype]
    return (JaxConfig(dtype=jd, param_dtype=jnp.float32, **kw),
            TorchConfig(dtype=td, param_dtype=torch.float32, **kw))


def moe_params(cfg, seed):
    """MoE-layer parameters from numpy (biases nonzero)."""
    rng = np.random.default_rng(seed)
    e, h, i = cfg.num_experts, cfg.hidden_size, cfg.intermediate_size

    def normal(shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    p = {"gate_w": normal((h, e), h ** -0.5),
         "w_up": normal((e, h, i), h ** -0.5), "b_up": normal((e, i), 0.1),
         "w_down": normal((e, i, h), i ** -0.5),
         "b_down": normal((e, h), 0.1)}
    if cfg.gated_ffn:
        p["w_gate"] = normal((e, h, i), h ** -0.5)
    if cfg.num_shared_experts:
        si = i * cfg.num_shared_experts
        p["shared_w_up"] = normal((h, si), h ** -0.5)
        p["shared_w_down"] = normal((si, h), si ** -0.5)
        if cfg.gated_ffn:
            p["shared_w_gate"] = normal((h, si), h ** -0.5)
    return p


def tokens(cfg, seed):
    """[S, H] f32 tokens from numpy."""
    return np.random.default_rng(seed + 100).standard_normal(
        (cfg.tokens, cfg.hidden_size)).astype(np.float32)


def jax0(fn, *args, **static):
    """``fn(*args, **static)``, the JAX reference jitted and compiled at
    XLA's CPU optimisation level 0 (an eager shard_map takes some 20 s to
    trace here, the jitted one about 1 s)."""
    return jax.jit(functools.partial(fn, **static)).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)


def jax_ep(p, x, jc, ep, **kw):
    mesh = make_mesh(jc, dp=1, devices=jax.devices()[:ep])
    return jax0(jep.ep_moe_layer, {k: jnp.asarray(v) for k, v in p.items()},
                jnp.asarray(x), cfg=jc, mesh=mesh, use_pallas=False, **kw)


def assert_close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def assert_layer(got, want, tol):
    assert_close(got.out, want.out, tol)
    assert np.array_equal(got.expert_counts.numpy(),
                          np.asarray(want.expert_counts))
    np.testing.assert_allclose(float(got.aux_loss), float(want.aux_loss),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(got.z_loss), float(want.z_loss),
                               rtol=1e-5, atol=1e-7)
    if want.stats is None:
        assert got.stats is None
        return
    for name, g, w in zip(want.stats._fields, got.stats, want.stats):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


CASES = {
    # name: (dtype, ep, config fields, layer keywords)
    "ep2_dropless": ("f32", 2, dict(drop_tokens=False), {}),
    "ep4_cf1.0": ("f32", 4, dict(capacity_factor=1.0), {}),
    "ep8_gated_shared_stats": ("f32", 8, dict(
        gated_ffn=True, hidden_act="silu", num_shared_experts=1,
        capacity_factor=1.25, collect_stats=True), {}),
    "ep4_hier": ("f32", 4, dict(capacity_factor=1.25), dict(dcn_inner=2)),
    "ep8_hier_chunked": ("f32", 8, dict(num_experts=16, a2a_chunks=2),
                         dict(dcn_inner=2)),
    "ep4_chunked_stats": ("f32", 4, dict(a2a_chunks=2, collect_stats=True,
                                         capacity_factor=1.0), {}),
    "ep4_bf16_wire_bf16": ("bf16", 4, dict(
        wire_dtype="bf16", wire_dtype_combine="bf16",
        collect_stats=True), {}),
    "ep4_e4m3_wires_stats": ("f32", 4, dict(
        wire_dtype="e4m3", wire_dtype_combine="e5m2",
        collect_stats=True), {}),
    "ep8_hier_dcn_e4m3": ("f32", 8, dict(
        wire_dtype_dcn="e4m3", a2a_chunks=1, collect_stats=True),
        dict(dcn_inner=4)),
    "ep4_degrade_stats": ("f32", 4, dict(
        degrade_unhealthy_experts=True, collect_stats=True), {}),
    "ep2_skip_exchange": ("f32", 2, {}, dict(skip_exchange=True)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_ep_layer_matches_jax(case):
    dtype, ep, fields, kw = CASES[case]
    jc, tc = _cfgs(dtype, **{**LAYER, "sequence_len": 32 * ep, "ep": ep,
                             **fields})
    p = moe_params(tc, seed=ep)
    if tc.degrade_unhealthy_experts:
        p["w_down"][3, 0, 0] = np.nan  # expert 3 (on rank 1) is sick
    x = tokens(tc, seed=ep)
    want = jax_ep(p, x, jc, ep, **kw)
    got = tep.ep_moe_layer(params_from_numpy(p, device="cpu"),
                           torch.from_numpy(x), tc, local_mesh(ep), **kw)
    tol = TOL[dtype]
    if tc.wire_dtype == "e4m3" or tc.wire_dtype_dcn == "e4m3":
        # both sides decode the same fp8 payloads; the expert GEMMs then
        # sum them in another order
        tol = 1e-3
    assert_layer(got, want, tol)
    if tc.degrade_unhealthy_experts:
        assert float(got.stats.masked_experts) == 4.0  # one per rank
        assert bool(torch.isfinite(got.out).all())


def test_hierarchical_exchange_is_the_flat_one():
    """The two-stage exchange (both orders) equals the flat all-to-all,
    and the mesh's all_to_all is the transpose of the rank axes."""
    d, m = 8, local_mesh(8)
    ts = [torch.arange(d * 3, dtype=torch.float32).reshape(d, 3) + 100 * r
          for r in range(d)]
    flat = m.all_to_all(ts)
    for r in range(d):
        assert torch.equal(flat[r], torch.stack([ts[s][r] for s in range(d)]))
    for inner in (2, 4):
        for reverse in (False, True):
            got = tep._hierarchical_a2a(m, ts, d, inner, reverse=reverse)
            assert all(torch.equal(a, b) for a, b in zip(got, flat))


def test_local_mesh_holds_its_ranks_on_its_device():
    """A local mesh given a device splits tokens there and refuses tokens
    elsewhere; without one it takes them wherever they are."""
    x = torch.arange(8.0).reshape(4, 2)
    assert [t.tolist() for t in local_mesh(2, device="cpu").split(x)] == [
        [[0.0, 1.0], [2.0, 3.0]], [[4.0, 5.0], [6.0, 7.0]]]
    assert len(local_mesh(4).split(x)) == 4
    with pytest.raises(ValueError, match="holds its ranks on meta"):
        local_mesh(2, device="meta").split(x)


def test_chunk_divisor_and_config_errors():
    with pytest.raises(ValueError, match="divide the local-expert"):
        TorchConfig(**LAYER, ep=4, a2a_chunks=3)
    with pytest.raises(ValueError, match="divide evenly over ep"):
        TorchConfig(**LAYER, ep=3)
    # ported: the ragged backend and tp construct
    assert TorchConfig(**LAYER, ep=2, moe_backend="ragged").ep == 2
    assert TorchConfig(**LAYER, ep=2, tp=2).tp == 2
    # the refusals that remain, with JAX's errors or the ROADMAP title
    with pytest.raises(ValueError, match="does not support shared experts"):
        TorchConfig(**LAYER, ep=2, moe_backend="ragged",
                    num_shared_experts=1)
    with pytest.raises(ValueError, match="'Host-side planes'"):
        TorchConfig(**LAYER, ep=2, moe_backend="auto")
    # the knobs of later slices, by their ROADMAP titles
    with pytest.raises(NotImplementedError, match="'Host-side planes'"):
        TorchConfig(**LAYER, profile_phases=True)
    for knob, val in (("kv_wire_dtype", "e4m3"), ("serving_mode", "decode")):
        with pytest.raises(NotImplementedError, match="'Serving fabric'"):
            TorchConfig(**LAYER, **{knob: val})
    for backend in ("fused", "ragged"):
        with pytest.raises(ValueError, match="tp>1"):
            TorchConfig(**LAYER, ep=2, tp=2, moe_backend=backend)
    with pytest.raises(ValueError, match="expert_quant does not compose"):
        TorchConfig(**LAYER, ep=2, tp=2, expert_quant="int8")
    # ported: dp, sp and pp construct; a process mesh refuses them
    from flashmoe_tpu_torch.parallel.mesh import Mesh

    title = "'Blocked on hardware: the multi-GPU transport'"
    for axis in ("dp", "sp", "pp"):
        assert getattr(TorchConfig(**LAYER, ep=2, **{axis: 2}), axis) == 2
        with pytest.raises(NotImplementedError, match=title):
            Mesh(4, (0,), group=object(), **{axis: 2})
    # the shard body re-checks against the mesh it is given
    tc = TorchConfig(**LAYER, sequence_len=64, a2a_chunks=4)
    p = params_from_numpy(moe_params(tc, 0), device="cpu")
    with pytest.raises(ValueError, match="a2a_chunks=4 does not divide"):
        tep.ep_moe_layer(p, torch.zeros(64, 64), tc, local_mesh(4))


def test_process_exchange_groups_match_local(monkeypatch):
    """The process mesh's grouped exchange (the two-stage hops) over four
    threads, one rank each, through an in-memory ``all_to_all_single``:
    every rank gets what the local mesh gives it, fp8 payloads too."""
    import threading

    import torch.distributed as dist

    from flashmoe_tpu_torch.parallel.mesh import Mesh

    d = 4
    board, where = {}, threading.local()
    barrier = threading.Barrier(d, timeout=30)

    def fake_a2a(out, inp, output_split_sizes, input_split_sizes, group):
        board[where.rank] = (inp, input_split_sizes)
        barrier.wait()
        got = []
        for s in range(d):
            src, sizes = board[s]
            off = sum(sizes[:where.rank])
            got.append(src[off:off + sizes[where.rank]])
        out.copy_(torch.cat(got))
        barrier.wait()

    monkeypatch.setattr(dist, "all_to_all_single", fake_a2a)
    ts = [(torch.arange(d * 6, dtype=torch.float32).reshape(d, 2, 3)
           + 100 * r).to(torch.float8_e5m2) for r in range(d)]
    want = {rev: tep._hierarchical_a2a(local_mesh(d), ts, d, 2, reverse=rev)
            for rev in (False, True)}
    got, errors = {}, []

    def run(r):
        where.rank = r
        try:
            m = Mesh(d, (r,), group=object())
            for rev in (False, True):
                got[r, rev] = tep._hierarchical_a2a(m, [ts[r]], d, 2,
                                                    reverse=rev)[0]
        except Exception as e:  # reported below, with the rank
            errors.append((r, e))
            barrier.abort()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(d)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not errors and not any(t.is_alive() for t in threads), errors
    for (r, rev), g in got.items():
        assert torch.equal(g.view(torch.uint8), want[rev][r].view(torch.uint8))
    assert len(got) == 2 * d


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _gloo_rank(rank, world, port, p, x, cfg, queue):
    import torch.distributed as dist

    from flashmoe_tpu_torch.parallel.mesh import process_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        s = x.shape[0] // world
        o = tep.ep_moe_layer(p, x[rank * s:(rank + 1) * s], cfg,
                             process_mesh(), dcn_inner=None)
        # numpy arrays travel by value (a tensor would travel as a file
        # descriptor, which dies with this process)
        queue.put((rank, o.out.numpy(), o.aux_loss.numpy(),
                   o.expert_counts.numpy(), [t.numpy() for t in o.stats]))
    finally:
        dist.destroy_process_group()


def test_process_mesh_over_gloo_equals_local_mesh():
    """Two processes, one rank each, over gloo: the same outputs, losses,
    counts and stats as the local mesh; a 60 s join bound makes a hang a
    failure."""
    _, tc = _cfgs(**LAYER, sequence_len=64, ep=2, collect_stats=True,
                  wire_dtype="e4m3")
    p = params_from_numpy(moe_params(tc, 7), device="cpu")
    x = torch.from_numpy(tokens(tc, 7))
    want = tep.ep_moe_layer(p, x, tc, local_mesh(2))
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_gloo_rank,
                         args=(r, 2, port, p, x, tc, queue))
             for r in range(2)]
    for proc in procs:
        proc.start()
    try:
        got = dict((r, rest) for r, *rest in
                   (queue.get(timeout=60) for _ in procs))
    finally:
        for proc in procs:
            proc.join(timeout=60)
            if proc.is_alive():
                proc.kill()
    assert all(proc.exitcode == 0 for proc in procs)
    out = np.concatenate([got[0][0], got[1][0]])
    np.testing.assert_array_equal(out, want.out.numpy())
    for r in range(2):
        _, aux, counts, stats = got[r]
        np.testing.assert_array_equal(counts, want.expert_counts.numpy())
        np.testing.assert_allclose(aux, want.aux_loss.numpy(), rtol=1e-6)
        for name, g, w in zip(want.stats._fields, stats, want.stats):
            np.testing.assert_allclose(g, w.numpy(), rtol=1e-6, atol=1e-7,
                                       err_msg=name)


def test_forward_with_mesh_matches_jax_and_one_device():
    """``forward`` with an ep mesh (collective and fused backends) against
    JAX's forward on its mesh and the port's one-device forward."""
    kw = dict(num_experts=8, expert_top_k=2, hidden_size=64,
              intermediate_size=64, num_layers=2, vocab_size=64,
              num_heads=2, sequence_len=16, drop_tokens=False, ep=4)
    jc, tc = _cfgs(**kw)
    jparams = jtf.init_params(jax.random.PRNGKey(0), jc)
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    tparams = params_from_numpy(np_params, device="cpu")
    tok = np.random.default_rng(0).integers(0, 64, (2, 16)).astype(np.int32)
    mesh = make_mesh(jc, dp=1, devices=jax.devices()[:4])
    want, _ = jax0(jtf.forward, jparams, jnp.asarray(tok), cfg=jc,
                   mesh=mesh, use_pallas=False)
    one, _ = ttf.forward(tparams, torch.from_numpy(tok), tc.replace(ep=1))
    for backend in ("collective", "fused"):
        got, aux = ttf.forward(tparams, torch.from_numpy(tok),
                               tc.replace(moe_backend=backend),
                               mesh=local_mesh(4))
        assert_close(got, want, TOL["f32"])
        torch.testing.assert_close(got, one, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="mesh of 2 ranks"):
        ttf.forward(tparams, torch.from_numpy(tok), tc, mesh=local_mesh(2))
