"""PyTorch port: the Decider (``flashmoe_tpu_torch/parallel/decider.py``),
its native twin (``flashmoe_tpu_torch/csrc/host/decider.cpp``) and the
bootstrap's group plan against the JAX package's on the CPU.

Every scenario of ``tests/test_decider.py`` and ``tests/test_native.py``
runs through both Deciders over adjacencies and workers built from the
same arrays: groups, local experts, owners and replicas are equal
exactly.  ``form_groups`` and ``initialize(use_decider=True)`` run under
``FLASHMOE_MOCK_SLICES`` with JAX's adjacency patched to the port's
(the local-mesh row: JAX's CPU adjacency scales its latencies by torus
hops, which a card's virtual ranks do not have)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashmoe_tpu.config import MoEConfig as JaxConfig
from flashmoe_tpu.parallel import decider as jdec
from flashmoe_tpu.parallel import topology as jtop
from flashmoe_tpu.runtime import bootstrap as jboot
from flashmoe_tpu_torch.config import MoEConfig
from flashmoe_tpu_torch.parallel import decider as tdec
from flashmoe_tpu_torch.parallel import topology as ttop
from flashmoe_tpu_torch.parallel.mesh import local_mesh
from flashmoe_tpu_torch.runtime import _native
from flashmoe_tpu_torch.runtime import bootstrap as tboot
from test_torch_planner import _to_port


def _both_adj(alpha, beta):
    return (jtop.Adjacency(alpha.copy(), beta.copy()),
            ttop.Adjacency(alpha.copy(), beta.copy()))


def _both_workers(thr, mem):
    return ([jtop.WorkerAttr(throughput=t, memory_gb=m)
             for t, m in zip(thr, mem)],
            [ttop.WorkerAttr(throughput=t, memory_gb=m)
             for t, m in zip(thr, mem)])


def _island(n=8, cut=4, slow_alpha=0.5, slow_beta=0.05):
    alpha = np.full((n, n), 0.01)
    beta = np.full((n, n), 0.001)
    for i in range(n):
        for j in range(n):
            if (i < cut) != (j < cut):
                alpha[i, j] = slow_alpha
                beta[i, j] = slow_beta
        alpha[i, i] = beta[i, i] = 0
    return alpha, beta


def _gateway():
    n = 4
    alpha = np.zeros((n, n))
    beta = np.zeros((n, n))
    for i in range(n):
        for j in range(n):
            if i == j:
                continue
            if (i < 2) == (j < 2):
                beta[i, j] = 0.05 if i < 2 else 0.001
            else:
                alpha[i, j] = 10.0
                beta[i, j] = 0.002
    return alpha, beta


def _flat(n=4):
    alpha = np.full((n, n), 0.01)
    beta = np.full((n, n), 0.001)
    np.fill_diagonal(alpha, 0)
    np.fill_diagonal(beta, 0)
    return alpha, beta


HOT = np.ones(8)
HOT[0] = 10.0
SKEW = np.linspace(3.0, 1.0, 16)
SKEW[5] = 20.0
GW_CFG = dict(num_experts=8, expert_top_k=2, hidden_size=256,
              intermediate_size=512, sequence_len=128, vocab_size=8192,
              num_layers=1)

# (name, config, adjacency arrays, (rates, memory), decide's keywords):
# tests/test_decider.py's and tests/test_native.py's scenarios
SCENARIOS = [
    ("all_assigned", dict(num_experts=16, expert_top_k=2), _island(),
     ([1.0] * 8, [16.0] * 8), {}),
    ("rate_proportional", dict(num_experts=16, expert_top_k=2), _island(),
     ([3.0, 3.0] + [1.0] * 6, [16.0] * 8), {}),
    ("islands_apart", dict(num_experts=8, expert_top_k=2, hidden_size=4096,
                           sequence_len=8192, mini_batch=4),
     _island(slow_alpha=1000.0, slow_beta=100.0), ([1.0] * 8, [16.0] * 8),
     {}),
    ("memory_forcing", dict(num_experts=64, expert_top_k=2,
                            hidden_size=4096, intermediate_size=4096),
     _island(slow_alpha=1000.0, slow_beta=100.0), ([1.0] * 8, [2.0] * 8),
     {}),
    ("gateway_train", dict(GW_CFG, is_training=True), _gateway(),
     ([1.0] * 4, [16.0] * 4), {}),
    ("gateway_max_beta", dict(GW_CFG, is_training=True), _gateway(),
     ([1.0] * 4, [16.0] * 4), dict(price_mode="max_beta")),
    ("gateway_infer", dict(GW_CFG, is_training=False), _gateway(),
     ([1.0] * 4, [16.0] * 4), {}),
    ("hot_expert", dict(num_experts=8, expert_top_k=2), _flat(),
     ([1.0] * 4, [16.0] * 4), dict(expert_costs=HOT)),
    ("slow_device", dict(num_experts=8, expert_top_k=2), _flat(),
     ([0.25, 1.0, 1.0, 1.0], [16.0] * 4),
     dict(expert_costs=np.where(np.arange(8) == 0, 8.0, 1.0))),
    ("replicate", dict(num_experts=8, expert_top_k=2), _flat(),
     ([1.0] * 4, [64.0] * 4), dict(expert_costs=HOT, replicate=True)),
    ("replicate_tight", dict(num_experts=8, expert_top_k=2), _flat(),
     ([1.0] * 4, [0.001] * 4), dict(expert_costs=HOT, replicate=True)),
    ("skewed", dict(num_experts=16, expert_top_k=2), _flat(),
     ([1.0, 1.5, 1.0, 1.5], [64.0] * 4),
     dict(expert_costs=SKEW, replicate=True)),
    ("sliced", dict(num_experts=8, expert_top_k=2, hidden_size=128,
                    intermediate_size=256, sequence_len=128),
     _island(slow_alpha=0.01, slow_beta=0.04), ([1.0] * 8, [64.0] * 8),
     dict(expert_costs=np.array([100.0, 90.0, 10.0, 9.0, 8.0, 7.0, 6.0,
                                 5.0]), slice_of=[0] * 4 + [1] * 4)),
    # tests/test_native.py's three
    ("native_uniform", dict(num_experts=16, expert_top_k=2,
                            hidden_size=1024, intermediate_size=1024,
                            sequence_len=8192), _island(),
     ([1.0] * 8, [16.0] * 8), {}),
    ("native_islands", dict(num_experts=16, expert_top_k=2,
                            hidden_size=4096, intermediate_size=1024,
                            sequence_len=8192, mini_batch=4),
     _island(slow_alpha=1000.0, slow_beta=100.0), ([1.0] * 8, [16.0] * 8),
     {}),
    ("native_hetero", dict(num_experts=16, expert_top_k=2,
                           hidden_size=1024, intermediate_size=1024,
                           sequence_len=8192), _island(),
     ([3.0, 3.0] + [1.0] * 6, [16.0] * 8), {}),
]
IDS = [s[0] for s in SCENARIOS]


def _same(jp, tp):
    assert tp.groups == jp.groups
    assert tp.local_experts == jp.local_experts
    assert tp.expert_owner == jp.expert_owner
    assert tp.replicas == jp.replicas


@pytest.mark.parametrize("name,kw,arrays,attrs,dkw", SCENARIOS, ids=IDS)
def test_decide_equals_jax(name, kw, arrays, attrs, dkw):
    jc = JaxConfig(**kw)
    jadj, tadj = _both_adj(*arrays)
    jw, tw = _both_workers(*attrs)
    jp = jdec.decide(jadj, jw, jc, native=False, **dkw)
    tp = tdec.decide(tadj, tw, _to_port(jc), native=False, **dkw)
    _same(jp, tp)
    # decide's "auto" takes the native arm where it applies: the same
    tp_auto = tdec.decide(tadj, tw, _to_port(jc), **dkw)
    _same(jp, tp_auto)


@pytest.mark.parametrize(
    "name,kw,arrays,attrs,dkw",
    [s for s in SCENARIOS if not s[4]],
    ids=[s[0] for s in SCENARIOS if not s[4]])
def test_native_decider_equals_python(name, kw, arrays, attrs, dkw):
    assert _native.load() is not None, "g++ builds the host library"
    cfg = _to_port(JaxConfig(**kw))
    _, tadj = _both_adj(*arrays)
    _, tw = _both_workers(*attrs)
    py = tdec.decide(tadj, tw, cfg, native=False)
    cc = tdec.decide(tadj, tw, cfg, native=True)
    _same(py, cc)


def test_native_abi_and_required_arm(monkeypatch):
    assert _native.load().flashmoe_native_abi_version() == 1
    cfg = MoEConfig(num_experts=8, expert_top_k=2)
    tadj = ttop.Adjacency(*_flat())
    tw = _both_workers([1.0] * 4, [16.0] * 4)[1]
    monkeypatch.setattr(_native, "native_decide", lambda *a, **k: None)
    with pytest.raises(RuntimeError, match="native decider unavailable"):
        tdec.decide(tadj, tw, cfg, native=True)
    assert tdec.decide(tadj, tw, cfg).groups == [[0, 1, 2, 3]]


@pytest.mark.parametrize("loads,rates,replicate", [
    (np.where(np.arange(8) == 0, 64.0, 0.0), [0.25, 1.0, 1.0, 1.0], False),
    (np.where(np.arange(8) == 0, 64.0, 0.0), [0.25, 1.0, 1.0, 1.0], True),
    (np.ones(8), None, False),
    (np.array([5.0, 1.0, 0.0, 3.0, 9.0, 0.0, 2.0, 4.0]), [1.0, 2.0, 1.0,
                                                           0.5], True),
])
def test_rebalance_placement_equals_jax(loads, rates, replicate):
    jc = JaxConfig(num_experts=8, expert_top_k=1)
    r = None if rates is None else np.array(rates)
    jp = jdec.rebalance_placement(loads, 4, jc, rates=r,
                                  replicate=replicate)
    tp = tdec.rebalance_placement(loads, 4, _to_port(jc), rates=r,
                                  replicate=replicate)
    _same(jp, tp)
    assert tdec.placement_permutation(tp) == \
        jdec.placement_permutation(jp)
    for bad in ((np.ones(8), 3), (np.ones(7), 4)):
        with pytest.raises(ValueError) as te:
            tdec.rebalance_placement(bad[0], bad[1], _to_port(jc))
        with pytest.raises(ValueError) as je:
            jdec.rebalance_placement(bad[0], bad[1], jc)
        assert str(te.value) == str(je.value)


def test_helpers_equal_jax():
    jc = JaxConfig(num_experts=16, expert_top_k=2)
    for n in (1, 3, 4, 16):
        assert dataclasses.asdict(tdec.uniform_placement(
            n, _to_port(jc))) == dataclasses.asdict(
                jdec.uniform_placement(n, jc))
    for g in (1, 2, 4):
        assert tdec.ring_allreduce_ms(100.0, g, 0.1, 0.01) == \
            jdec.ring_allreduce_ms(100.0, g, 0.1, 0.01)
    args = dict(total_expert_cost_ms=3.0, comm_mbytes=2.0,
                grad_buffer_mb=1.0, gamma=2.0)
    assert tdec.group_objective([0, 1], [1.0, 2.0], 0.5,
                                tdec.CostArgs(**args), 0.25) == \
        jdec.group_objective([0, 1], [1.0, 2.0], 0.5,
                             jdec.CostArgs(**args), 0.25)
    costs = [100.0, 90.0, 10.0, 9.0, 8.0, 7.0, 6.0, 5.0]
    assert tdec.assign_experts_sliced(
        list(range(8)), [1.0] * 8, 8, [0] * 4 + [1] * 4, costs) == \
        jdec.assign_experts_sliced(list(range(8)), [1.0] * 8, 8,
                                   [0] * 4 + [1] * 4, costs)


# ----------------------------------------------------------------------
# the group plan and the bootstrap
# ----------------------------------------------------------------------

F32 = dict(num_experts=8, expert_top_k=2, hidden_size=128,
           intermediate_size=256, sequence_len=128)


@pytest.fixture
def port_adjacency(monkeypatch):
    """JAX's bootstrap pricing the port's adjacency (the local-mesh row,
    the same mocked slices)."""
    def adj(devices=None, platform=None):
        n = len(list(devices if devices is not None else jax.devices()))
        return jtop.Adjacency(*_port_arrays(n))

    monkeypatch.setattr(jboot, "ici_adjacency", adj)
    monkeypatch.setenv("FLASHMOE_MEMORY_GB", "64")
    jboot.finalize()
    tboot.finalize()
    yield
    jboot.finalize()
    tboot.finalize()


def _port_arrays(n):
    a = ttop.ici_adjacency(n, platform="local")
    return a.alpha, a.beta


@pytest.mark.parametrize("mock", [None, "2", "4"])
@pytest.mark.parametrize("expensive", [False, True])
def test_form_groups_equals_jax(port_adjacency, monkeypatch, mock,
                                expensive):
    if mock is not None:
        monkeypatch.setenv("FLASHMOE_MOCK_SLICES", mock)
    jc = JaxConfig(**F32, dtype=jnp.float32, param_dtype=jnp.float32)
    alpha, beta = _port_arrays(8)
    if expensive:
        # DCN priced out of the per-step exchange: one group a slice
        sids = ttop.device_slice_ids([0] * 8)
        cross = np.array([[sids[i] != sids[j] for j in range(8)]
                          for i in range(8)])
        alpha = np.where(cross, alpha * 1e4, alpha)
        beta = np.where(cross, beta * 1e4, beta)
    jadj, tadj = _both_adj(alpha, beta)
    jw, tw = _both_workers([1.0] * 8, [64.0] * 8)
    jp = jboot.form_groups(jc, jax.devices()[:8], adj=jadj, workers=jw)
    tp = tboot.form_groups(_to_port(jc), 8, adj=tadj, workers=tw)
    for f in ("mapping", "dp", "ep", "dcn_inner", "slices", "groups"):
        assert getattr(tp, f) == getattr(jp, f), f
    _same(jp.placement, tp.placement)
    # the defaults: the port's adjacency and unprobed workers
    tq = tboot.form_groups(_to_port(jc), 8)
    jq = jboot.form_groups(jc, jax.devices()[:8])
    assert (tq.mapping, tq.dp, tq.ep, tq.dcn_inner) == \
        (jq.mapping, jq.dp, jq.ep, jq.dcn_inner)


@pytest.mark.parametrize("mock", [None, "2", "4"])
@pytest.mark.parametrize("ep", [1, 8])
def test_initialize_publishes_jax_plan_and_src_order(port_adjacency,
                                                     monkeypatch, mock, ep):
    from flashmoe_tpu_torch.utils.telemetry import metrics

    if mock is not None:
        monkeypatch.setenv("FLASHMOE_MOCK_SLICES", mock)
    kw = dict(F32, ep=ep)
    jrt = jboot.initialize(JaxConfig(**kw, dtype=jnp.float32,
                                     param_dtype=jnp.float32),
                           measure=False)
    trt = tboot.initialize(MoEConfig(**kw, dtype=torch.float32,
                                     param_dtype=torch.float32),
                           devices=8, device="cpu")
    assert trt.cfg.ep == jrt.cfg.ep
    assert trt.dcn_inner == jrt.dcn_inner
    if jrt.src_order is None:
        assert trt.src_order is None
    else:
        np.testing.assert_array_equal(trt.src_order,
                                      np.asarray(jrt.src_order))
    jg, tg = jrt.group_plan, trt.group_plan
    assert (tg.mapping, tg.dp, tg.ep, tg.groups) == \
        (jg.mapping, jg.dp, jg.ep, jg.groups)
    rec = metrics.last_decision("bootstrap.groups")
    assert rec["mapping"] == jg.mapping and rec["adopted_ep"] == trt.cfg.ep
    # the runtime's tables apply to its own world only
    d = trt.cfg.ep
    mesh = local_mesh(d)
    if trt.src_order is not None:
        assert tboot.current_src_order(mesh, d) is trt.src_order
    assert tboot.current_src_order(local_mesh(2), 2) is None
    assert tboot.current_dcn_inner(mesh, d) == (
        trt.dcn_inner if trt.dcn_inner and 1 < trt.dcn_inner < d
        else None)
    tboot.finalize()
    assert tboot.current_dcn_inner(mesh, d) is None
