"""PyTorch port: the runtime controller (``flashmoe_tpu_torch/runtime/
controller.py``) against the JAX package's, the counterpart of
``tests/test_controller.py``.

The same observation sequences (step times; metrics dicts with drop
fractions, imbalance and expert loads; phase ledgers; fabric depths;
draft acceptance rates) feed JAX's and the port's controller side by
side: every boundary's action, the decision timeline, ``snapshot()`` and
``state_dict()`` must be equal (JSON-equal: tuples compare as lists).
Where a scenario morphs at a width above one, JAX's planner prices the
port's rows and byte model (``test_torch_planner.port_model``).
``permute_expert_state`` is held bit for bit against JAX's on the same
numpy train state, and the loops (``train``, ``resilient_train`` with
``rebuild_step``, ``supervise`` with ``ResilienceConfig.adapt``) run at
the drill configuration on the CPU, held to JAX's own assertions
(``tests/test_chaos.py:997``)."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashmoe_tpu.chaos import inject as jinject
from flashmoe_tpu.runtime import controller as jctl
from flashmoe_tpu.runtime import trainer as jtrainer
from flashmoe_tpu.utils.telemetry import Metrics as JaxMetrics
from flashmoe_tpu_torch import chaos as tchaos
from flashmoe_tpu_torch.chaos import inject as tinject
from flashmoe_tpu_torch.chaos.drill import data_stream, drill_config
from flashmoe_tpu_torch.convert import (params_from_numpy,
                                        train_state_from_numpy)
from flashmoe_tpu_torch.models import transformer as ttf
from flashmoe_tpu_torch.ops import moe as tmoe
from flashmoe_tpu_torch.runtime import bootstrap as tboot
from flashmoe_tpu_torch.runtime import checkpoint as tckpt
from flashmoe_tpu_torch.runtime import controller as tctl
from flashmoe_tpu_torch.runtime import resilient as tres
from flashmoe_tpu_torch.runtime import trainer as ttrainer
from flashmoe_tpu_torch.tree import tree_leaves
from flashmoe_tpu_torch.utils.telemetry import Metrics as TorchMetrics

from test_torch_ep import _cfgs, moe_params, tokens
from test_torch_planner import _fresh_planner, jax_rows, port_model  # noqa: F401

BASE = dict(num_experts=8, expert_top_k=2, hidden_size=64,
            intermediate_size=128, sequence_len=64, collect_stats=True,
            is_training=True)
CCFG = dict(debounce_steps=2, cooldown_steps=4, baseline_steps=2,
            ema_decay=0.5)


@pytest.fixture(autouse=True)
def _clean():
    jinject.disarm()
    tchaos.clear()
    yield
    jinject.disarm()
    tchaos.clear()


def _stats(load, dropped=0.0):
    load = np.asarray(load, dtype=np.float64)
    mean = max(float(load.mean()), 1e-9)
    return {"expert_load": load.tolist(),
            "dropped_fraction": float(dropped),
            "imbalance": float(load.max()) / mean}


def _json(x):
    return json.loads(json.dumps(x))


class Pair:
    """JAX's controller and the port's, built from the same fields."""

    def __init__(self, cfg=None, ccfg=None, **kw):
        jc, tc = _cfgs("f32", **{**BASE, **(cfg or {})})
        cc = {**CCFG, **(ccfg or {})}
        self.jm, self.tm = JaxMetrics(), TorchMetrics()
        self.j = jctl.RuntimeController(
            jc, jctl.ControllerConfig(**cc), metrics=self.jm, **kw)
        self.t = tctl.RuntimeController(
            tc, tctl.ControllerConfig(**cc), metrics=self.tm,
            device="cpu", **kw)

    def both(self, name, *a, **kw):
        """Call ``name`` on both; their results must be equal."""
        rj = getattr(self.j, name)(*a, **kw)
        rt = getattr(self.t, name)(*a, **kw)
        assert _act(rt) == _act(rj), (name, a)
        return rt

    def check(self):
        assert self.t.timeline == _json(self.j.timeline)
        assert [d for d in self.tm.decisions] == _json(self.jm.decisions)
        assert _json(self.t.snapshot()) == _json(self.j.snapshot())
        sd = self.t.state_dict()
        assert _json(sd) == _json(self.j.state_dict())
        for name in ("drop_ema", "imbalance_ema", "step_ms_ema",
                     "baseline_ms", "a2a_share_ema", "fab_queue_ema",
                     "spec_accept_ema", "cooldown_until", "morphs_used",
                     "replaces_used", "wire_morphs_used",
                     "replica_morphs_used", "spec_morphs_used"):
            assert getattr(self.t, name) == getattr(self.j, name), name
        if self.j.load_ema is None:
            assert self.t.load_ema is None
        else:
            np.testing.assert_array_equal(self.t.load_ema, self.j.load_ema)
        for d in range(self.t.n_devices):
            assert self.t.device_load_share(d) == \
                self.j.device_load_share(d)
        # the state round-trips through JSON into a fresh controller
        fresh = tctl.RuntimeController(self.t.cfg, self.t.ccfg,
                                       metrics=TorchMetrics(),
                                       n_devices=self.t.n_devices,
                                       slices=self.t.slices, device="cpu")
        fresh.load_state_dict(json.loads(json.dumps(sd)))
        assert _json(fresh.state_dict()) == _json(sd)
        assert fresh.cfg_overrides == self.t.cfg_overrides


def _act(a):
    if a is None:
        return None
    return _json({"type": type(a).__name__, **dataclasses.asdict(a),
                  "needs_rebuild": getattr(a, "needs_rebuild", None)})


SKEWED = {"moe_stats": [_stats([60, 1, 1, 1, 1, 1, 1, 1], 0.3)]}
CALM = {"moe_stats": [_stats(np.ones(8), 0.0)]}
BLIP = {"moe_stats": [_stats([60, 1, 1, 1, 1, 1, 1, 1], 0.5)]}
HOT = {"moe_stats": [_stats([64, 0, 0, 0, 0, 0, 0, 0])]}
A2A_HEAVY = {"phase_ms": {"moe.gate": 1.0, "moe.a2a_dispatch": 5.0,
                          "moe.expert": 2.0, "moe.a2a_combine": 4.0,
                          "moe.combine": 0.5}}
A2A_LIGHT = {"phase_ms": {"moe.gate": 1.0, "moe.a2a_dispatch": 0.5,
                          "moe.expert": 9.0, "moe.a2a_combine": 0.5,
                          "moe.combine": 0.5}}


def _steps(p, seq, start=0, act=True, **act_kw):
    """Observe each (step_ms, metrics) and ask after each."""
    for i, (ms, m) in enumerate(seq, start):
        p.both("observe_step", i, ms, m)
        if act:
            p.both("maybe_act", i + 1, **act_kw)


# ----------------------------------------------------------------------
# validation
# ----------------------------------------------------------------------

@pytest.mark.parametrize("cls, kw", [
    ("ControllerConfig", dict(debounce_steps=0)),
    ("ControllerConfig", dict(cooldown_steps=-1)),
    ("ControllerConfig", dict(ema_decay=1.5)),
    ("ControllerConfig", dict(slow_factor=0.9)),
    ("ControllerConfig", dict(a2a_share_high=1.0)),
    ("ControllerConfig", dict(replica_queue_low=5.0,
                              replica_queue_high=4.0)),
    ("ControllerConfig", dict(spec_accept_floor=1.5)),
    ("BrownoutConfig", dict(queue_low=7.0)),
    ("BrownoutConfig", dict(mode="drop")),
    ("BrownoutConfig", dict(degrade_max_new=0)),
    ("BrownoutConfig", dict(debounce_steps=0)),
    ("BrownoutConfig", dict(cooldown_steps=-1)),
    ("BrownoutConfig", dict(episode_budget=0)),
    ("BrownoutConfig", dict(retry_high=0)),
])
def test_config_validation_equals_jax(cls, kw):
    with pytest.raises(ValueError) as want:
        getattr(jctl, cls)(**kw)
    with pytest.raises(ValueError, match=str(want.value).replace(
            "(", r"\(").replace(")", r"\)")):
        getattr(tctl, cls)(**kw)
    assert dataclasses.asdict(getattr(tctl, cls)()) == \
        dataclasses.asdict(getattr(jctl, cls)())


@pytest.mark.parametrize("pairs", [((2, 2),), ((0, 9),), ((0, 3), (1, 3)),
                                   ((0, 1), (1, 2)), ((0, 1), (0, 2)),
                                   ((0,),)])
def test_expert_replicas_validation_equals_jax(pairs):
    from flashmoe_tpu.config import MoEConfig as JaxConfig
    from flashmoe_tpu_torch.config import MoEConfig as TorchConfig

    with pytest.raises(ValueError) as want:
        JaxConfig(**BASE, expert_replicas=pairs)
    with pytest.raises(ValueError) as got:
        TorchConfig(**BASE, expert_replicas=pairs)
    assert str(got.value) == str(want.value)
    jc, tc = _cfgs("f32", **BASE, expert_replicas=((0, 3), (1, 4)))
    assert tc.expert_replicas == jc.expert_replicas


def test_controller_needs_a_divisible_width():
    with pytest.raises(ValueError, match="must divide"):
        Pair(n_devices=3)


# ----------------------------------------------------------------------
# decision streams (tests/test_controller.py)
# ----------------------------------------------------------------------

def test_skew_trigger_debounces_and_resets_on_clear():
    p = Pair()
    _steps(p, [(10.0, SKEWED)])
    assert p.t._skew_run == 1
    _steps(p, [(10.0, CALM)] * 5, start=1)
    assert p.t._skew_run == 0
    p.check()


def test_one_step_blip_never_triggers():
    p = Pair()
    _steps(p, [(10.0, CALM)] * 4 + [(10.0, BLIP)] + [(10.0, CALM)] * 7)
    assert p.t.morphs_used == 0 and not p.t.timeline
    p.check()


def test_morph_after_debounce_budget_and_cooldown():
    p = Pair(ccfg=dict(morph_budget=1, enable_replace=False))
    _steps(p, [(10.0, SKEWED)] * 12)
    assert p.t.morphs_used == 1
    assert p.t.cfg_overrides == {"drop_tokens": False}
    names = [d["decision"] for d in p.t.timeline]
    assert names[0] == "controller.morph" and "controller.cooldown" in names
    p.check()


def test_morph_requires_rebuild_capability():
    p = Pair(ccfg=dict(debounce_steps=1, cooldown_steps=2,
                       enable_replace=False))
    _steps(p, [(10.0, SKEWED)] * 3, can_rebuild=False)
    assert p.t.morphs_used == 0
    _steps(p, [(10.0, SKEWED)], start=3)
    assert p.t.morphs_used == 1
    p.check()


def test_morph_at_width_reselects_with_the_ports_rows(port_model):
    """At 8 ranks the morph re-selects through the planner: the same
    overrides (ragged where the drop trigger prices it feasible), the
    same predicted ms, as JAX's planner on the port's rows."""
    cfg = dict(num_experts=16, ep=8, sequence_len=128,
               moe_backend="collective")
    for ccfg in (dict(enable_replace=False),
                 dict(enable_replace=False, drop_high=0.9)):
        p = Pair(cfg=cfg, ccfg=ccfg, gen="h100")
        hot = {"moe_stats": [_stats([60] + [1] * 15, 0.3)]}
        _steps(p, [(10.0, hot), (10.0, hot), (500.0, hot), (500.0, hot)])
        p.check()
        assert p.t.morphs_used == 1
        rec = p.t.timeline[0]
        assert rec["decision"] == "controller.morph"


@pytest.mark.parametrize("rates", [(0.25, 1.0, 1.0, 1.0), None])
def test_slow_trigger_plans_replacement(rates):
    p = Pair(cfg=dict(expert_top_k=1), ccfg=dict(enable_morph=False),
             n_devices=4, rates_fn=lambda: rates)
    _steps(p, [(10.0, HOT), (10.0, HOT), (900.0, HOT), (900.0, HOT)],
           act=False)
    act = p.both("maybe_act", 4)
    assert isinstance(act, tctl.ReplaceAction) and act.replica_pairs
    if rates:
        # the hot expert leaves the slow device (slots 0..1)
        assert act.perm.index(0) // 2 != 0
    assert p.t.timeline[-1]["rates"] == (list(rates) if rates else None)
    _steps(p, [(10.0, HOT)] * 6, start=4)
    p.check()


def test_default_rates_fn_reads_the_probe_seam():
    tinject.arm("probe_rates", rates=(0.25, 1.0, 1.0, 1.0))
    jinject.arm("probe_rates", rates=(0.25, 1.0, 1.0, 1.0))
    p = Pair(cfg=dict(expert_top_k=1), ccfg=dict(enable_morph=False),
             n_devices=4)
    _steps(p, [(10.0, HOT), (10.0, HOT), (900.0, HOT), (900.0, HOT)])
    assert p.t.timeline[-1]["rates"] == [0.25, 1.0, 1.0, 1.0]
    p.check()


def test_probe_failure_degrades_to_uniform_rates():
    def boom():
        raise RuntimeError("wedged tunnel")

    p = Pair(cfg=dict(expert_top_k=1), ccfg=dict(enable_morph=False),
             n_devices=4, rates_fn=boom)
    _steps(p, [(10.0, HOT), (10.0, HOT), (900.0, HOT), (900.0, HOT)])
    names = [d["decision"] for d in p.t.timeline]
    assert names == ["controller.probe_error", "controller.replace"]
    assert p.t.timeline[-1]["rates"] is None
    p.check()


def test_default_probe_on_the_cpu_gives_uniform_rates():
    """No seam armed: the default ``rates_fn`` probes the controller's
    device (one reading for every virtual rank)."""
    _, tc = _cfgs("f32", **{**BASE, "expert_top_k": 1})
    c = tctl.RuntimeController(tc, tctl.ControllerConfig(**CCFG),
                               metrics=TorchMetrics(), n_devices=4,
                               device="cpu")
    rates = c.rates_fn()
    assert rates.shape == (4,) and np.all(rates == rates[0]) and rates[0] > 0


def test_replace_noop_when_layout_already_balanced():
    p = Pair(ccfg=dict(enable_morph=False), n_devices=4,
             rates_fn=lambda: None)
    balanced = {"moe_stats": [_stats(np.ones(8))]}
    _steps(p, [(10.0, balanced), (10.0, balanced), (900.0, balanced),
               (900.0, balanced)])
    assert p.t.replaces_used == 0 and "noop" in p.t.timeline[-1]["reason"]
    p.check()


def test_action_resets_baseline_for_the_new_regime():
    p = Pair(ccfg=dict(debounce_steps=1, cooldown_steps=3,
                       enable_replace=False))
    _steps(p, [(10.0, SKEWED)])
    assert p.t.baseline_ms is None and p.t.step_ms_ema is None
    p.check()


def test_real_stats_streams_equal_jax():
    """``moe_stats`` as the layers' own MoEStats: the same numpy layer
    through JAX's ``moe_layer`` and the port's feeds each controller."""
    from flashmoe_tpu.ops.moe import moe_layer as jmoe_layer

    jc, tc = _cfgs("f32", **BASE)
    p = Pair()
    for s in range(3):
        params = moe_params(tc, seed=s)
        params["gate_w"][:, 0] += 3.0   # a hot expert
        x = tokens(tc, seed=s)
        want = jmoe_layer({k: jnp.asarray(v) for k, v in params.items()},
                          jnp.asarray(x), jc, use_pallas=False)
        got = tmoe.moe_layer(params_from_numpy(params, device="cpu"),
                             torch.from_numpy(x), tc)
        p.j.observe_step(s, 10.0, {"moe_stats": [want.stats]})
        p.t.observe_step(s, 10.0, {"moe_stats": [got.stats]})
        p.both("maybe_act", s + 1)
    np.testing.assert_allclose(p.t.load_ema, p.j.load_ema, rtol=1e-6)
    assert p.t.drop_ema == pytest.approx(p.j.drop_ema, rel=1e-5)
    assert [d["decision"] for d in p.t.timeline] == \
        [d["decision"] for d in p.j.timeline]


@pytest.mark.parametrize("case", ["fires", "single_slice", "reset",
                                  "cooldown"])
def test_wire_morph_equals_jax(case):
    off = dict(enable_morph=False, enable_replace=False)
    if case == "fires":
        p = Pair(ccfg=off, slices=2)
        _steps(p, [(10.0, A2A_HEAVY)] * 20)
        assert p.t.cfg_overrides == {"wire_dtype_dcn": "e4m3"}
        assert p.t.apply_to(p.t.cfg).wire_dtype_dcn == "e4m3"
    elif case == "single_slice":
        p = Pair(ccfg=dict(off, debounce_steps=1))
        _steps(p, [(10.0, A2A_HEAVY)] * 3)
        assert p.t.slices == 1 and not p.t.timeline
    elif case == "reset":
        p = Pair(ccfg=dict(off, debounce_steps=3), slices=4)
        _steps(p, [(10.0, A2A_HEAVY)] * 2 + [(10.0, A2A_LIGHT)])
        assert p.t._a2a_run == 0
    else:
        p = Pair(ccfg=dict(off, debounce_steps=1, cooldown_steps=6,
                           wire_morph_dtype="bf16", wire_morph_budget=2),
                 slices=2)
        _steps(p, [(10.0, A2A_HEAVY)])
        for c in (p.j, p.t):
            c.overrides.pop("wire_dtype_dcn")
        _steps(p, [(10.0, A2A_HEAVY)] * 3, start=1)
        assert p.t.timeline[-1]["decision"] == "controller.cooldown"
    p.check()


def _spec_pair(**cc):
    return Pair(ccfg={"enable_spec_morph": True, "spec_accept_floor": 0.5,
                      **cc})


@pytest.mark.parametrize("case", ["fires", "cooldown", "floor"])
def test_spec_morph_equals_jax(case):
    if case == "fires":
        p = _spec_pair()
        for i, ar in enumerate([None, 0.2, 0.9, 0.2, 0.1]):
            p.both("observe_spec", i, ar)
            p.both("maybe_morph_spec", i + 1)
        for s in range(10, 20):
            p.both("observe_spec", s, 0.0)
        p.both("maybe_morph_spec", 20)
        assert p.t.spec_morphs_used == 1
    elif case == "cooldown":
        p = _spec_pair(spec_morph_budget=2)
        for i, ar in enumerate([0.1, 0.1, 0.1, 0.1]):
            p.both("observe_spec", i, ar)
            p.both("maybe_morph_spec", i + 1)
        p.both("observe_spec", 20, 0.0)
        p.both("observe_spec", 21, 0.0)
        p.both("maybe_morph_spec", 22, spec_on=False)
    else:
        p = _spec_pair(spec_accept_floor=None)
        for i, (ar, be) in enumerate([(0.3, 0.4), (0.3, 0.2), (0.1, None),
                                      (0.1, 0.3), (0.1, 0.3)]):
            p.both("observe_spec", i, ar, break_even=be)
            p.both("maybe_morph_spec", i + 1)
        assert p.t.spec_morphs_used == 1
    p.check()


@pytest.mark.parametrize("depths", [
    [[9.0, 9.0], [8.0, 7.0], [9.0, 9.0], [6.0, 5.0], [9.0, 9.0]],
    [[0.0, 0.0, 1.0], [0.0, 0.0, 0.0], [0.1, 0.0, 0.0], [0.0] * 3,
     [0.0] * 3, [7.0, 8.0, 9.0], [9.0] * 3, [9.0] * 3, [9.0] * 3,
     [9.0] * 3, [9.0] * 3],
])
def test_replica_morph_equals_jax(depths):
    """The fabric-facing trigger, ported whole: drain on sustained
    idleness, undrain on sustained pressure, same cooldown and budget."""
    p = Pair(ccfg=dict(enable_replica_morph=True, debounce_steps=2,
                       cooldown_steps=2))
    draining = set()
    for i, d in enumerate(depths):
        p.both("observe_fabric", i, d)
        act = p.both("maybe_morph_replicas", i + 1, draining=draining)
        if act is not None:
            (draining.add if act.kind == "drain"
             else draining.discard)(act.replica)
    p.check()


# ----------------------------------------------------------------------
# state, manifests, slices
# ----------------------------------------------------------------------

def test_state_dict_roundtrip_and_monotonic_budgets():
    p = Pair()
    for c in (p.j, p.t):
        c.overrides = {"drop_tokens": False, "expert_replicas": ((2, 5),)}
        c.morphs_used, c.replaces_used = 1, 2
    p.check()
    sd = p.t.state_dict()
    c2 = Pair().t
    c2.morphs_used = 5
    c2.load_state_dict(sd)
    assert c2.morphs_used == 5 and c2.replaces_used == 2
    assert isinstance(c2.overrides["expert_replicas"], tuple)
    c2.load_state_dict({"overrides": {"drop_tokens": False}})
    assert "expert_replicas" not in c2.cfg_overrides


def test_manifest_carries_controller_state(tmp_path):
    cfg = drill_config()
    state = ttrainer.init_state(torch.Generator().manual_seed(0), cfg,
                                ttrainer.make_optimizer(cfg))
    d = str(tmp_path / "ckpt")
    cs = {"overrides": {"drop_tokens": False}, "morphs_used": 1,
          "replaces_used": 0, "timeline": []}
    tckpt.save(d, state, step=2, controller_state=cs)
    assert tckpt.load_controller_state(d, 2) == cs
    tckpt.save(d, state, step=3)
    assert tckpt.load_controller_state(d, 3) is None


@pytest.mark.parametrize("mock", [None, "1", "2", "banana"])
def test_detected_slices_equals_jax(monkeypatch, mock):
    """JAX's process holds the 8 CPU devices; the port's ranks are the
    bootstrapped runtime's (8 virtual ranks of the CPU)."""
    if mock is None:
        monkeypatch.delenv("FLASHMOE_MOCK_SLICES", raising=False)
    else:
        monkeypatch.setenv("FLASHMOE_MOCK_SLICES", mock)
    want = jctl.detected_slices()
    tboot.finalize()
    try:
        if mock != "banana":
            tboot.initialize(_cfgs("f32", **BASE)[1], devices=8,
                             device="cpu")
        assert tctl.detected_slices() == want
        assert Pair().t.slices == want
    finally:
        tboot.finalize()


def test_detected_slices_without_a_runtime_is_the_process_world(
        monkeypatch):
    monkeypatch.setenv("FLASHMOE_MOCK_SLICES", "2")
    tboot.finalize()
    assert tctl.detected_slices() == 1


# ----------------------------------------------------------------------
# permute_expert_state
# ----------------------------------------------------------------------

def _np_states(seed=0, **over):
    """A JAX train state with random AdamW moments, as numpy, and the
    port's copy of it."""
    jc, tc = _cfgs("f32", **{**BASE, "num_layers": 2, "vocab_size": 256,
                             "num_heads": 2, "collect_stats": False,
                             "drop_tokens": False, **over})
    opt = jtrainer.make_optimizer(jc, total_steps=4)
    state = jtrainer.init_state(jax.random.PRNGKey(seed), jc, opt)
    rng = np.random.default_rng(seed)
    state = jax.tree_util.tree_map(np.asarray, state)
    state = state._replace(opt_state=jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape).astype(a.dtype)
                   if a.dtype == np.float32 and a.ndim else a),
        state.opt_state))
    return jc, tc, state, train_state_from_numpy(state, device="cpu")


@pytest.mark.parametrize("perm, pairs", [
    ((3, 1, 0, 2, 7, 6, 5, 4), ()),
    ((1, 0, 2, 3, 4, 5, 6, 7), ((1, 4),)),
    ((7, 6, 5, 4, 3, 2, 1, 0), ((0, 3), (5, 6))),
])
def test_permute_expert_state_bit_equal_to_jax(perm, pairs):
    jc, tc, jstate, tstate = _np_states()
    want = jctl.permute_expert_state(
        jax.tree_util.tree_map(jnp.asarray, jstate), jc, perm, pairs)
    got = tctl.permute_expert_state(tstate, tc, perm, pairs)
    want_np = train_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, want), device="cpu")
    for a, b in zip(tree_leaves(got), tree_leaves(want_np)):
        assert torch.equal(a, b)
    # every moment moved with its expert: the port's own check
    w = tstate.params["layers"][1]["moe"]["w_up"]
    for tree_old, tree_new in ((tstate.params, got.params),
                               (tstate.opt_state.mu, got.opt_state.mu),
                               (tstate.opt_state.nu, got.opt_state.nu)):
        old = tree_old["layers"][1]["moe"]
        new = tree_new["layers"][1]["moe"]
        exp = old["w_up"][list(perm)].clone()
        for hot, slot in pairs:
            exp[slot] = exp[hot]
        assert torch.equal(new["w_up"], exp)
        assert torch.equal(new["gate_w"], old["gate_w"][:, list(perm)])
    assert w.shape[0] == 8


def test_permute_expert_state_preserves_function():
    _, tc, _, tstate = _np_states(seed=1)
    toks = torch.randint(0, 256, (2, tc.sequence_len),
                         generator=torch.Generator().manual_seed(1))
    base = ttf.forward(tstate.params, toks, tc)[0]
    perm = (3, 1, 0, 2, 7, 6, 5, 4)
    st2 = tctl.permute_expert_state(tstate, tc, perm)
    out = ttf.forward(st2.params, toks, tc)[0]
    np.testing.assert_allclose(out.numpy(), base.numpy(), rtol=2e-5,
                               atol=2e-5)
    with pytest.raises(ValueError, match="permutation"):
        tctl.permute_expert_state(tstate, tc, (0, 0, 1, 2, 3, 4, 5, 6))
    # apply_action: a morph leaves the state as it is
    c = tctl.RuntimeController(tc, device="cpu")
    assert c.apply_action(tctl.MorphAction({}, "skew", ""), tstate) \
        is tstate


def test_replica_routing_equals_jax():
    """With the victim's FFN weights the hot expert's copy, the replica
    split routes as JAX's (counts exactly, outputs at 2e-4), and the hot
    slot's load splits across the pair."""
    from flashmoe_tpu.ops.moe import moe_layer as jmoe_layer

    jc, tc = _cfgs("f32", **{**BASE, "drop_tokens": False})
    p = moe_params(tc, seed=3)
    x = tokens(tc, seed=3)
    base = tmoe.moe_layer(params_from_numpy(p, device="cpu"),
                          torch.from_numpy(x), tc)
    counts = base.expert_counts.numpy()
    hot, victim = int(counts.argmax()), int(counts.argmin())
    p2 = {k: v.copy() for k, v in p.items()}
    for k in ("w_up", "b_up", "w_down", "b_down"):
        p2[k][victim] = p2[k][hot]
    jr = jc.replace(expert_replicas=((hot, victim),))
    tr = tc.replace(expert_replicas=((hot, victim),))
    want = jmoe_layer({k: jnp.asarray(v) for k, v in p2.items()},
                      jnp.asarray(x), jr, use_pallas=False)
    got = tmoe.moe_layer(params_from_numpy(p2, device="cpu"),
                         torch.from_numpy(x), tr)
    np.testing.assert_array_equal(got.expert_counts.numpy(),
                                  np.asarray(want.expert_counts))
    np.testing.assert_allclose(got.out.numpy(), np.asarray(want.out),
                               rtol=2e-4, atol=2e-4)
    assert got.expert_counts[hot] < base.expert_counts[hot]
    assert got.expert_counts[victim] > base.expert_counts[victim]
    assert got.expert_counts.sum() == base.expert_counts.sum()


# ----------------------------------------------------------------------
# the loops at the drill configuration
# ----------------------------------------------------------------------

def _skew_ctrl(cfg, **cc):
    base = dict(debounce_steps=2, cooldown_steps=3, baseline_steps=2,
                ema_decay=0.5, morph_budget=1, enable_replace=False)
    base.update(cc)
    return tctl.RuntimeController(cfg, tctl.ControllerConfig(**base),
                                  metrics=TorchMetrics(), device="cpu")


def test_train_with_a_controller_morphs_under_sustained_skew():
    cfg = drill_config()
    tinject.arm("skewed_routing", expert=0, bias=100.0)
    ctl = _skew_ctrl(cfg)
    state, hist = ttrainer.train(
        cfg, data_stream(cfg, 2, 0, "cpu"), 6,
        generator=torch.Generator().manual_seed(0), log_every=1,
        controller=ctl)
    morphs = [d for d in ctl.timeline if d["decision"] == "controller.morph"]
    assert len(morphs) == 1 and morphs[0]["dropless"]
    assert morphs[0]["overrides"] == {"drop_tokens": False}
    assert ctl.cfg_overrides == {"drop_tokens": False}
    assert int(state.step) == 6 and len(hist) == 6
    # after the morph the rebuilt step drops nothing
    after = [h["moe"][0]["dropped_fraction"] for h in hist[morphs[0]["step"]:]]
    assert after and max(after) == 0.0
    assert ctl.drop_ema < ctl.ccfg.drop_high


def test_resilient_train_rebuilds_and_restores_the_plan(tmp_path):
    """A morph forces a checkpoint whose manifest carries the plan; a new
    run from that directory reloads the plan and rebuilds its step on
    the plan's overrides before its first step."""
    cfg = drill_config()
    opt = ttrainer.make_optimizer(cfg, total_steps=10)
    built = []

    def rebuild(ov):
        built.append(dict(ov))
        return ttrainer.make_train_step(cfg.replace(**ov), opt)

    tinject.arm("skewed_routing", expert=0, bias=100.0)
    ctl = _skew_ctrl(cfg)
    state = ttrainer.init_state(torch.Generator().manual_seed(0), cfg, opt)
    rcfg = tres.ResilienceConfig(checkpoint_dir=str(tmp_path / "ck"),
                                 checkpoint_every=10)
    m = TorchMetrics()
    final, _ = tres.resilient_train(
        state, rebuild({}), data_stream(cfg, 2, 0, "cpu"), 6, rcfg=rcfg,
        metrics=m, cfg=cfg, controller=ctl, rebuild_step=rebuild)
    act = next(d for d in ctl.timeline if d["decision"] ==
               "controller.morph")
    forced = act["step"]
    assert built == [{}, {"drop_tokens": False}]
    plan = tckpt.load_controller_state(rcfg.checkpoint_dir, forced)
    assert plan["overrides"] == {"drop_tokens": False}
    assert plan["morphs_used"] == 1
    assert m.counters["checkpoints"] == 2   # the forced one and the last
    # resume with a fresh controller: the plan and budget come back
    tchaos.clear()
    built.clear()
    ctl2 = _skew_ctrl(cfg)
    out, _ = tres.resilient_train(
        ttrainer.init_state(torch.Generator().manual_seed(0), cfg, opt),
        rebuild({}), data_stream(cfg, 2, 0, "cpu"), 8, rcfg=rcfg,
        metrics=TorchMetrics(), cfg=cfg, controller=ctl2,
        rebuild_step=rebuild)
    assert int(out.step) == 8
    assert built == [{}, {"drop_tokens": False}]
    assert ctl2.morphs_used == 1
    assert ctl2.cfg_overrides == {"drop_tokens": False}
    # without rebuild_step no rebuilding action is offered
    ctl3 = _skew_ctrl(cfg)
    tinject.arm("skewed_routing", expert=0, bias=100.0)
    tres.resilient_train(
        ttrainer.init_state(torch.Generator().manual_seed(0), cfg, opt),
        ttrainer.make_train_step(cfg, opt), data_stream(cfg, 2, 0, "cpu"),
        3, rcfg=tres.ResilienceConfig(checkpoint_dir=str(tmp_path / "c3"),
                                      checkpoint_every=10),
        metrics=TorchMetrics(), controller=ctl3)
    assert ctl3.morphs_used == 0


def test_supervise_adapt_morph_survives_a_restart(tmp_path):
    """JAX's ``test_supervise_controller_morphs_and_plan_survives_restart``
    (``tests/test_chaos.py:997``): a sustained skew morphs the job; a
    drain restarts it, and the next incarnation resumes the morphed plan
    and the spent budget from the manifest (no second morph)."""
    from flashmoe_tpu_torch.runtime.data import TokenLoader, write_token_file
    from flashmoe_tpu_torch.runtime.preempt import PreemptionListener

    cfg = drill_config()
    tok = str(tmp_path / "tokens.bin")
    rng = np.random.default_rng(3)
    write_token_file(tok, rng.integers(
        0, cfg.vocab_size, size=40 * (cfg.sequence_len + 1),
        dtype=np.int32))
    tinject.arm("skewed_routing", expert=0, bias=100.0)
    rcfg = tres.ResilienceConfig(
        checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=2,
        adapt=tctl.ControllerConfig(debounce_steps=2, cooldown_steps=3,
                                    baseline_steps=2, ema_decay=0.5,
                                    morph_budget=1, enable_replace=False))
    pl = PreemptionListener()
    fired = {"n": 0}

    def poke(i):
        if i == 6 and not fired["n"]:
            fired["n"] = 1
            pl.notify("test")

    metrics = TorchMetrics()
    final, hist = tres.supervise(
        cfg, lambda fcfg: TokenLoader(tok, 2, fcfg.sequence_len, seed=3,
                                      native=False, device="cpu"),
        10, rcfg, metrics=metrics, preempt=pl, devices_fn=lambda: 1,
        fail_injector=poke, device="cpu")
    assert int(final.step) == 10
    morphs = [d for d in metrics.decisions
              if d["decision"] == "controller.morph"]
    assert len(morphs) == 1 and morphs[0]["dropless"]
    assert metrics.counters["preempt_drains"] == 1
    assert metrics.last_decision("supervisor.resume") is not None
    plan = tckpt.load_controller_state(rcfg.checkpoint_dir, 10)
    assert plan is not None and plan["morphs_used"] == 1
    assert plan["overrides"] == {"drop_tokens": False}


def test_supervise_resume_resets_demoted_paths(tmp_path):
    """A resumed incarnation clears the planner's demoted paths, as
    JAX's supervisor does (``controller.demotion_reset``)."""
    from flashmoe_tpu_torch.planner import select as tselect
    from flashmoe_tpu_torch.runtime.preempt import PreemptionListener

    cfg = drill_config()
    rcfg = tres.ResilienceConfig(checkpoint_dir=str(tmp_path / "ck"),
                                 checkpoint_every=2)
    pl = PreemptionListener()

    def poke(i):
        if i == 3 and not pl.requested and "ragged" not in \
                tselect.failed_backends():
            tselect.report_path_failure("ragged", "test")
            pl.notify("test")

    metrics = TorchMetrics()
    try:
        final, _ = tres.supervise(
            cfg, lambda fcfg: data_stream(fcfg, 2, 0, "cpu"), 5, rcfg,
            metrics=metrics, preempt=pl, fail_injector=poke, device="cpu")
        assert int(final.step) == 5
        rec = metrics.last_decision("controller.demotion_reset")
        assert rec is not None and rec["dropped"] == ["ragged"]
        assert not tselect.failed_backends()
    finally:
        tselect.reset_path_failures()
