"""PyTorch port: the two-pass expert-tiled gate and the router's choice of
gate against the JAX package, on the same numpy inputs (CPU; the port
runs the kernels' plain versions there)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # one intra-op thread a test worker

from flashmoe_tpu.config import MoEConfig as JaxConfig
from flashmoe_tpu.ops.gate import apply_replicas as jax_apply_replicas
from flashmoe_tpu.ops.gate import gate_vmem_bytes as jax_gate_vmem_bytes
from flashmoe_tpu.ops.gate import router as jax_router
from flashmoe_tpu.ops.gate import router_pallas_tiled, router_xla
from flashmoe_tpu_torch.config import MoEConfig as TorchConfig
from flashmoe_tpu_torch.ops import gate as tg


def _jax0(fn, *args, **static):
    """``fn(*args, **static)``, the JAX reference jitted and compiled at
    XLA's CPU optimisation level 0, which halves the compile of these
    small programs."""
    return jax.jit(functools.partial(fn, **static)).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)


def _router_xla(x, w, jc):
    return _jax0(router_xla, x, w, cfg=jc)


def _cfgs(**kw):
    return (JaxConfig(dtype=jnp.float32, **kw),
            TorchConfig(dtype=torch.float32, **kw))


def _inputs(s, h, e, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((s, h), dtype=np.float32)
    w = (rng.standard_normal((h, e)) / np.sqrt(h)).astype(np.float32)
    return x, w


def _assert_router_equal(got, want):
    """Ids and counts exact; f32 values at 1e-4 (sums in another
    order: the TPU kernel rescales its running sum tile by tile)."""
    np.testing.assert_array_equal(got.expert_idx.numpy(),
                                  np.asarray(want.expert_idx))
    np.testing.assert_array_equal(got.expert_counts.numpy(),
                                  np.asarray(want.expert_counts))
    np.testing.assert_allclose(got.combine_weights.numpy(),
                               np.asarray(want.combine_weights),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.probs_mean.numpy(),
                               np.asarray(want.probs_mean),
                               rtol=1e-4, atol=1e-7)
    for name in ("aux_loss", "z_loss"):
        np.testing.assert_allclose(float(getattr(got, name)),
                                   float(getattr(want, name)), rtol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("e,k,need_stats", [(600, 2, True),
                                            (1280, 6, False)],
                         ids=["e600k2_stats", "e1280k6_no_stats"])
def test_router_tiled_plain_matches_pallas_interpret(e, k, need_stats):
    """Both passes against the TPU kernels themselves (interpret mode),
    with the statistics pass and without (counts from the ids, aux and z
    losses 0)."""
    jc, tc = _cfgs(num_experts=e, expert_top_k=k, hidden_size=64,
                   router_z_loss_coef=0.01)
    x, w = _inputs(32, 64, e, seed=e + k)
    want = _jax0(router_pallas_tiled, jnp.asarray(x), jnp.asarray(w),
                 cfg=jc, interpret=True, need_stats=need_stats)
    got = tg.router_tiled_plain(torch.from_numpy(x), torch.from_numpy(w),
                                tc, need_stats)
    _assert_router_equal(got, want)
    assert (float(got.aux_loss) > 0) == need_stats


@pytest.mark.parametrize("e,k", [(300, 2), (600, 33), (1280, 64)],
                         ids=["e300k2", "e600k33", "e1280k64"])
def test_router_tiled_plain_matches_router_xla(e, k):
    """With the statistics pass the tiled gate is router_xla's function,
    K = 64 (the merge's limit) included."""
    jc, tc = _cfgs(num_experts=e, expert_top_k=k, hidden_size=128,
                   router_z_loss_coef=0.01)
    x, w = _inputs(40, 128, e, seed=k)
    want = _router_xla(jnp.asarray(x), jnp.asarray(w), jc)
    got = tg.router_tiled_plain(torch.from_numpy(x), torch.from_numpy(w),
                                tc, True)
    _assert_router_equal(got, want)


@pytest.mark.parametrize("e,k,h", [(64, 33, 64), (300, 2, 64),
                                   (18944, 2, 128)],
                         ids=["e64k33_single", "e300_single", "e18944_tiled"])
def test_router_matches_jax_router_choice(e, k, h):
    """The port's router against JAX router(use_pallas, interpret) where
    the two choose different gates.  E <= 256 with K > 32 and E = 300
    both take the port's two-pass gate while JAX, within its VMEM budget,
    takes its single-tile gate, which always computes the statistics; so
    the port runs pass 2 there, and aux_loss agrees.  At E = 18944 both
    take the two-pass gate without pass 2: aux_loss 0 on both sides.
    JAX takes router_xla at S % 8 != 0, so the port runs pass 2 there
    too."""
    s = 8
    jc, tc = _cfgs(num_experts=e, expert_top_k=k, hidden_size=h)
    x, w = _inputs(s, h, e, seed=k)
    fits = jax_gate_vmem_bytes(s, h, e, jnp.float32) <= 12 * 2**20
    assert fits == (e < 18944)
    for ss in (s, 12):
        assert tg.gate_vmem_bytes(ss, h, e, torch.float32) \
            == jax_gate_vmem_bytes(ss, h, e, jnp.float32)
    assert tg.tiled_need_stats(tc, s, h, torch.float32) == fits
    assert tg.tiled_need_stats(tc, 12, h, torch.float32)
    want = _jax0(jax_router, jnp.asarray(x), jnp.asarray(w), cfg=jc,
                 use_pallas=True, interpret=True)
    got = tg.router(torch.from_numpy(x), torch.from_numpy(w), tc)
    _assert_router_equal(got, want)
    assert (float(got.aux_loss) == 0) == (not fits)


def test_router_takes_plain_router_past_the_merge():
    """2K > 128: the plain router by configuration, as JAX router takes
    router_xla."""
    jc, tc = _cfgs(num_experts=300, expert_top_k=65, hidden_size=64)
    x, w = _inputs(16, 64, 300, seed=3)
    want = _router_xla(jnp.asarray(x), jnp.asarray(w), jc)
    got = tg.router(torch.from_numpy(x), torch.from_numpy(w), tc)
    _assert_router_equal(got, want)


def test_tiled_gate_breaks_ties_by_lowest_expert_id():
    """Equal logits across and within expert tiles: the lowest ids win,
    in the order router_xla gives."""
    e, h = 300, 64
    jc, tc = _cfgs(num_experts=e, expert_top_k=4, hidden_size=h)
    w = np.zeros((h, e), np.float32)
    w[0, [5, 70, 130, 200, 299]] = 1.0  # five experts tied at the top
    w[0, [1, 2]] = 0.5
    x = np.zeros((8, h), np.float32)
    x[:, 0] = 1.0
    want = _router_xla(jnp.asarray(x), jnp.asarray(w), jc)
    got = tg.router_tiled_plain(torch.from_numpy(x), torch.from_numpy(w),
                                tc, True)
    assert got.expert_idx[0].tolist() == [5, 70, 130, 200]
    _assert_router_equal(got, want)


def test_apply_replicas_matches_jax():
    e = 300
    jc, tc = _cfgs(num_experts=e, expert_top_k=2, hidden_size=64,
                   expert_replicas=((7, 11), (3, 250)))
    x, w = _inputs(24, 64, e, seed=9)
    w[:, 7] += 0.5  # make expert 7 hot
    want = _jax0(lambda x, w: jax_apply_replicas(router_xla(x, w, jc), jc),
                 jnp.asarray(x), jnp.asarray(w))
    got = tg.router(torch.from_numpy(x), torch.from_numpy(w), tc)
    _assert_router_equal(got, want)
    assert 0 < int(got.expert_counts[11]) and 0 < int(got.expert_counts[7])


@pytest.mark.parametrize("kw", [
    dict(expert_replicas=[(1, 2)]), dict(expert_replicas=((1, 1),)),
    dict(expert_replicas=((1, 9),)), dict(expert_replicas=((1, 2), (3, 2))),
    dict(expert_replicas=((1, 2), (1, 3))),
    dict(expert_replicas=((1, 2), (2, 3))),
], ids=["list", "self", "range", "slot_twice", "hot_twice", "chain"])
def test_replica_map_validation_matches_jax(kw):
    with pytest.raises(ValueError) as jerr:
        JaxConfig(num_experts=8, **kw)
    with pytest.raises(ValueError) as terr:
        TorchConfig(num_experts=8, **kw)
    assert str(terr.value) == str(jerr.value)


def test_tiled_router_backward_recomputes_plain_router():
    """Through the two-pass gate, the gradients of the combine weights and
    the aux loss are router_plain's (the JAX custom VJP's backward)."""
    _, tc = _cfgs(num_experts=300, expert_top_k=3, hidden_size=64,
                  router_z_loss_coef=0.01)
    x, w = (torch.from_numpy(a) for a in _inputs(16, 64, 300, seed=4))
    ct = torch.randn(16, 3, generator=torch.Generator().manual_seed(0))

    def grads(fn):
        xs, ws = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        o = fn(xs, ws, tc)
        loss = (o.combine_weights * ct).sum() + o.aux_loss + o.z_loss
        return torch.autograd.grad(loss, (xs, ws))

    for g, p in zip(grads(tg.router), grads(tg.router_plain)):
        torch.testing.assert_close(g, p, rtol=1e-5, atol=1e-6)


def test_tiled_gate_kernels_refuse_cpu_tensors():
    x, w = (torch.from_numpy(a) for a in _inputs(16, 64, 300))
    with pytest.raises(ValueError, match="cuda"):
        tg.gate_pass1_cuda(x, w, 2, True)
    with pytest.raises(ValueError, match="K <="):
        tg.gate_pass1_cuda(x, w, 65, True)
    logits, m, se, _, top_i = tg.gate_pass1_plain(x, w, 2, True)
    with pytest.raises(ValueError, match="cuda"):
        tg.gate_pass2_cuda(logits, m, se, top_i, 300)


# ----------------------------------------------------------------------
# the armed skew through the two-pass gate (B4a's logit-bias operand)
# ----------------------------------------------------------------------

@pytest.fixture
def _disarm():
    from flashmoe_tpu import chaos as jchaos
    from flashmoe_tpu_torch import chaos as tchaos

    jchaos.clear()
    tchaos.clear()
    yield
    jchaos.clear()
    tchaos.clear()


def _arm_both(**spec):
    from flashmoe_tpu.chaos import inject as jinject
    from flashmoe_tpu_torch.chaos import inject as tinject

    jinject.arm("skewed_routing", **spec)
    tinject.arm("skewed_routing", **spec)


def _assert_ids_near(got_ids, want_ids, want_probs, k):
    """Ids exact, except where JAX's k-th and (k+1)-th probabilities lie
    within 1e-4 of each other (a near tie, PR 5's rule)."""
    got_ids, want_ids = np.asarray(got_ids), np.asarray(want_ids)
    diff = (np.sort(got_ids, -1) != np.sort(want_ids, -1)).any(-1)
    top = -np.sort(-np.asarray(want_probs), -1)
    gaps = top[:, k - 1] - top[:, k]
    assert (gaps[diff] <= 1e-4).all(), gaps[diff]
    same = ~diff
    np.testing.assert_array_equal(got_ids[same], want_ids[same])
    return same


@pytest.mark.parametrize("bias", [100.0, 10.0], ids=["gap100", "bias10"])
@pytest.mark.parametrize("e,k", [(300, 2), (300, 10), (512, 2), (512, 10)])
def test_armed_tiled_gate_equals_jax_armed_router(_disarm, e, k, bias):
    """Armed skew past the single tile: the port's router (the two-pass
    gate, pass 1 biased; its plain version on the CPU) and the walks of
    both kernels' schedules against JAX's armed router (``router_xla``).
    Ids exact but at near ties; weights and probability sums at 2e-4.  At
    a logit gap past 87 every other probability is subnormal, 0 in
    both, and the zeros take the lowest other ids in both."""
    jc, tc = _cfgs(num_experts=e, expert_top_k=k, hidden_size=64,
                   router_z_loss_coef=0.01)
    x, w = _inputs(48, 64, e, seed=e + k)
    target = 7 if e == 300 else e + 9  # taken mod E: expert 9 at E 512
    _arm_both(expert=target, bias=bias)
    hot = target % e
    want = jax_router(jnp.asarray(x), jnp.asarray(w), jc, use_pallas=True)
    logits = np.asarray(x, np.float64) @ np.asarray(w, np.float64)
    logits[:, hot] += bias
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    got = tg.router(xt, wt, tc)
    same = _assert_ids_near(got.expert_idx, want.expert_idx, probs, k)
    assert bool((got.expert_idx == hot).any(-1).all())
    if bias > 87:
        assert same.all()
        others = [i for i in range(k) if i != hot][:k - 1]
        np.testing.assert_array_equal(got.expert_idx[:, 1:].numpy(),
                                      np.broadcast_to(others, (48, k - 1)))
    if same.all():
        np.testing.assert_array_equal(got.expert_counts.numpy(),
                                      np.asarray(want.expert_counts))
    np.testing.assert_allclose(got.combine_weights.detach().numpy()[same],
                               np.asarray(want.combine_weights)[same],
                               rtol=2e-4, atol=2e-4)
    for name in ("probs_mean", "aux_loss", "z_loss"):
        np.testing.assert_allclose(
            getattr(got, name).detach().numpy(),
            np.asarray(getattr(want, name)), rtol=2e-4, atol=2e-4,
            err_msg=name)
    # the kernels' schedules: pass 1's walk, then pass 2's on the biased
    # spilled logits
    m, se, top_p, top_i = tg.gate_pass1_walk(xt, wt, k)
    spilled = tg.gate_pass1_plain(xt, wt, k, True)[0]
    probs_sum, counts, zsum = tg.gate_pass2_walk(spilled, m, se, top_i, e)
    same_w = _assert_ids_near(top_i, want.expert_idx, probs, k)
    assert bool((top_i == hot).any(-1).all())
    cw = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-20)
    np.testing.assert_allclose(cw.numpy()[same_w],
                               np.asarray(want.combine_weights)[same_w],
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose((probs_sum / 48).numpy(),
                               np.asarray(want.probs_mean), rtol=2e-4,
                               atol=2e-4)
    if same_w.all():
        np.testing.assert_array_equal(counts.numpy(),
                                      np.asarray(want.expert_counts))
    np.testing.assert_allclose(
        float(zsum) / 48 * 0.01, float(want.z_loss), rtol=2e-4)


def test_unarmed_walk_is_unchanged_by_arming(_disarm):
    """Arming changes pass 1 only while armed: the unarmed walk and plain
    pass 1 give the same bits before and after an armed call."""
    x, w = (torch.from_numpy(a) for a in _inputs(70, 64, 512, seed=3))
    before = tg.gate_pass1_walk(x, w, 10)
    plain = tg.gate_pass1_plain(x, w, 10, True)
    _arm_both(expert=5, bias=100.0)
    armed = tg.gate_pass1_walk(x, w, 10)
    assert bool((armed[3] == 5).any(-1).all())
    assert not bool((before[3] == 5).any(-1).all())
    from flashmoe_tpu_torch.chaos import inject as tinject

    tinject.disarm()
    for a, b in zip(tg.gate_pass1_walk(x, w, 10), before):
        assert torch.equal(a, b)
    for a, b in zip(tg.gate_pass1_plain(x, w, 10, True), plain):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_pass1_args_carry_the_armed_bias(_disarm, monkeypatch, dtype):
    """``gate_pass1_args`` carries ``(bias_e, bias)`` and the scratch of
    the first K logits at the slots of ``fm_gate_pass1``'s C signature:
    ``(-1, 0)`` and a null scratch disarmed, ``(expert mod E, bias)`` and
    an [S, K] f32 scratch armed."""
    from flashmoe_tpu_torch.kernels import _build

    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    sig = _build.SIGNATURES["fm_gate_pass1"]
    x = torch.zeros(16, 64, dtype=dtype)
    w = torch.zeros(64, 300, dtype=dtype)
    args, out, keep = tg.gate_pass1_args(x, w, 4, True)
    assert len(args) == len(sig)
    assert args[8:11] == (-1, 0.0, None) and keep[2] is None
    assert sig[8] is sig[3] and sig[9] is not sig[8] \
        and sig[10] is sig[1]                 # int, float, pointer
    _arm_both(expert=305, bias=25.0)
    args, out, keep = tg.gate_pass1_args(x, w, 4, False)
    assert len(args) == len(sig)
    assert args[8:10] == (5, 25.0)
    head = keep[2]
    assert head.shape == (16, 4) and head.dtype == torch.float32
    assert args[10] == head.data_ptr() and args[11] is None
