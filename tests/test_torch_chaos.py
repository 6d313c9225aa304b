"""PyTorch port: the chaos harness (``flashmoe_tpu_torch/chaos/``) against
the JAX package's on the CPU.

The registries equal JAX's; each applier equals JAX's exactly on the
same numpy arrays (``poison_local_expert`` against JAX's inside a
``shard_map`` over the 8-device CPU mesh, chunk offsets included); the
armed router and layers match JAX's (ids exactly, floats at the JAX
package's f32 tolerance 2e-4, the fp8 wire at the collective layer
test's 1e-3: both sides decode the same fp8 payloads and sum them in
another order); the host-level faults behave as JAX's tests of them
(``tests/test_chaos.py:839-899``).  JAX's drill matrix is marked slow
there (it compiles a train step for every drill), so each of the
port's training-ladder drills is held to that test's own assertions
(``tests/test_chaos.py:758-781``) instead of to a JAX run, and each of
the serving fabric's ten drills to the assertions of JAX's tests of it.
The tests that call ``run_drill`` are marked slow, as the repository's
lint asks of every drill (``flashmoe_tpu/staticcheck/lint.py``,
``slow-mark``); the fast gates drill through the CLI (two training
faults; the fabric's ten, each a CPU-second or less)."""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # one intra-op thread a test worker
from jax.sharding import Mesh, PartitionSpec as P

import flashmoe_tpu.chaos as jchaos
import flashmoe_tpu_torch.chaos as tchaos
from flashmoe_tpu.chaos import inject as jinject
from flashmoe_tpu.ops import gate as jgate
from flashmoe_tpu.ops import moe as jmoe
from flashmoe_tpu.runtime import throughput as jthroughput
from flashmoe_tpu.utils.compat import shard_map
from flashmoe_tpu_torch.chaos import drill as tdrill
from flashmoe_tpu_torch.chaos import inject as tinject
from flashmoe_tpu_torch.chaos.__main__ import main as chaos_main
from flashmoe_tpu_torch.convert import params_from_numpy
from flashmoe_tpu_torch.ops import gate as tgate
from flashmoe_tpu_torch.ops import moe as tmoe
from flashmoe_tpu_torch.parallel import ep as tep
from flashmoe_tpu_torch.parallel.mesh import local_mesh
from flashmoe_tpu_torch.planner import select as tselect
from flashmoe_tpu_torch.runtime import checkpoint as tckpt
from flashmoe_tpu_torch.runtime import throughput as tthroughput
from flashmoe_tpu_torch.runtime.preempt import PreemptionListener
from flashmoe_tpu_torch.runtime.resilient import ResilienceConfig

from test_torch_ep import LAYER, TOL, _cfgs, assert_layer, jax_ep, \
    moe_params, tokens


@pytest.fixture(autouse=True)
def _clean_chaos():
    jchaos.clear()
    tchaos.clear()
    yield
    jchaos.clear()
    tchaos.clear()


def _arm_both(point, **spec):
    jinject.arm(point, **spec)
    tinject.arm(point, **spec)


def _equal(got: torch.Tensor, want) -> None:
    """Bit equality, NaNs in the same places."""
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ----------------------------------------------------------------------
# registries
# ----------------------------------------------------------------------

def test_registries_equal_jax():
    assert tchaos.FAULTS == jchaos.FAULTS
    assert tchaos.EXPECTED_TIER == jchaos.EXPECTED_TIER
    assert tinject.POINTS == jinject.POINTS
    import dataclasses

    assert [(f.name, f.default) for f in dataclasses.fields(
        tchaos.FaultPlan)] == [(f.name, f.default) for f in
                               dataclasses.fields(jchaos.FaultPlan)]
    with pytest.raises(ValueError, match="unknown fault"):
        tchaos.FaultPlan("meteor_strike")
    with pytest.raises(ValueError, match="unknown injection point"):
        tinject.arm("meteor_strike")
    # the training ladder: every fault but the serving fabric's
    assert set(tdrill.TRAINING_FAULTS) == {
        f for f, t in jchaos.EXPECTED_TIER.items()
        if not t.startswith(("monitor:", "fabric:"))}


def test_arming_and_trace_signature_equal_jax():
    assert tinject.trace_signature() == jinject.trace_signature() == ()
    for plan in (jchaos.FaultPlan("nan_expert", expert=3),
                 jchaos.FaultPlan("skew_sustained", expert=2, bias=7.0),
                 jchaos.FaultPlan("nan_grad", step=4),
                 jchaos.FaultPlan("grad_spike", step=1, scale=50.0),
                 jchaos.FaultPlan("slow_step")):
        jchaos.arm_plan(plan)
        tchaos.arm_plan(tchaos.FaultPlan(**vars(plan)))
    assert tinject.trace_signature() == jinject.trace_signature()
    for point in tinject.POINTS:
        assert tinject.is_armed(point) == jinject.is_armed(point)
        assert tinject.spec(point) == jinject.spec(point)
    tinject.disarm("nan_grad")
    assert not tinject.is_armed("nan_grad")
    tchaos.clear()
    assert tinject.trace_signature() == ()


# ----------------------------------------------------------------------
# appliers, exactly
# ----------------------------------------------------------------------

def _grads(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": {"c": rng.standard_normal(5).astype(np.float32),
                  "n": np.arange(4, dtype=np.int32)},
            "d": [rng.standard_normal((2, 2)).astype(np.float32)]}


@pytest.mark.parametrize("point, spec, step", [
    ("nan_grad", dict(step=3), 3), ("nan_grad", dict(step=3), 2),
    ("grad_spike", dict(step=1, scale=1e4), 1),
    ("grad_spike", dict(step=1, scale=1e4), 5),
])
def test_poison_grads_equal_jax(point, spec, step):
    g = _grads(step)
    _arm_both(point, **spec)
    want = jinject.poison_grads(jax.tree_util.tree_map(jnp.asarray, g),
                                jnp.asarray(step, jnp.int32))
    got = tinject.poison_grads(params_from_numpy(g, device="cpu"),
                               torch.tensor(step, dtype=torch.int32))
    _equal(got["a"], want["a"])
    _equal(got["b"]["c"], want["b"]["c"])
    _equal(got["b"]["n"], want["b"]["n"])
    _equal(got["d"][0], want["d"][0])
    hit = step == spec["step"]
    assert bool(np.isnan(got["a"].numpy()).all()) == (
        hit and point == "nan_grad")


def test_poison_expert_and_logits_equal_jax():
    rng = np.random.default_rng(0)
    y = rng.standard_normal((4, 3, 8)).astype(np.float32)
    logits = rng.standard_normal((6, 4)).astype(np.float32)
    _arm_both("nan_expert", expert=6)   # 6 % 4 = expert 2
    _arm_both("skewed_routing", expert=1, bias=25.0)
    _equal(tinject.poison_expert(torch.from_numpy(y)),
           jinject.poison_expert(jnp.asarray(y)))
    _equal(tinject.poison_logits(torch.from_numpy(logits)),
           jinject.poison_logits(jnp.asarray(logits)))


@pytest.mark.parametrize("e, d, nrows, offset, total, expert", [
    (8, 4, 2, 0, None, 5),     # the serial slab: owner 2, row 1
    (16, 4, 2, 0, 4, 5),       # chunk 0 of 2: expert 5 is owner 1, row 1
    (16, 4, 2, 2, 4, 6),       # chunk 1 of 2: owner 1, row 2 -> row 0
    (16, 4, 2, 2, 4, 4),       # chunk 1 does not hold expert 4 (row 0)
    (8, 8, 1, 0, None, 7),     # one expert a rank, the last rank
])
def test_poison_local_expert_equal_jax(devices, e, d, nrows, offset, total,
                                       expert):
    rng = np.random.default_rng(e + d + offset)
    ys = rng.standard_normal((d, nrows, 3, 4)).astype(np.float32)
    _arm_both("nan_expert", expert=expert)
    mesh = Mesh(np.array(devices[:d]), ("ep",))
    fn = shard_map(
        lambda y: jinject.poison_local_expert(
            y, "ep", e, local_offset=offset, local_total=total),
        mesh=mesh, in_specs=P("ep"), out_specs=P("ep"))
    want = np.asarray(jax.jit(fn)(jnp.asarray(ys.reshape(d * nrows, 3,
                                                         4))))
    got = tinject.poison_local_expert(
        [torch.from_numpy(y) for y in ys], list(range(d)), e,
        local_offset=offset, local_total=total)
    np.testing.assert_array_equal(torch.cat(got).numpy(), want)


def test_probe_rates_seam_equal_jax():
    from flashmoe_tpu.config import MoEConfig as JaxConfig
    from flashmoe_tpu_torch.config import MoEConfig as TorchConfig

    for rates, n in (((0.25, 1.0, 1.0, 1.0), 4), ((0.5, 2.0), 4),
                     ((0.5, 2.0, 3.0), 2)):
        _arm_both("probe_rates", rates=rates)
        got = tthroughput.device_rates(TorchConfig(), n)
        want = jthroughput.device_rates(JaxConfig(), n)
        np.testing.assert_array_equal(got, want)


# ----------------------------------------------------------------------
# the armed router and layers
# ----------------------------------------------------------------------

@pytest.mark.parametrize("e, k", [(8, 2), (300, 2)])
def test_router_under_skew_equals_jax(e, k):
    """Armed skew, against JAX's router, which takes router_xla: at E 8
    the single-tile gate's plain version adds the bias (the gate kernel
    takes it as an operand); E 300 takes the two-pass gate armed or not,
    its pass 1 biased and keeping the router's rule for subnormal
    probabilities (bias 100: the second choice is expert 0, as in JAX's).
    Ids exactly, weights at 2e-4."""
    jc, tc = _cfgs("f32", num_experts=e, expert_top_k=k, hidden_size=64,
                   intermediate_size=64, sequence_len=64)
    rng = np.random.default_rng(e)
    x = rng.standard_normal((64, 64)).astype(np.float32)
    w = (rng.standard_normal((64, e)) * 0.125).astype(np.float32)
    _arm_both("skewed_routing", expert=3, bias=100.0)
    want = jgate.router(jnp.asarray(x), jnp.asarray(w), jc, use_pallas=True)
    got = tgate.router(torch.from_numpy(x), torch.from_numpy(w), tc)
    np.testing.assert_array_equal(got.expert_idx.numpy(),
                                  np.asarray(want.expert_idx))
    assert bool((got.expert_idx[:, 0] == 3).all())
    np.testing.assert_array_equal(got.expert_counts.numpy(),
                                  np.asarray(want.expert_counts))
    for name in ("combine_weights", "probs_mean", "aux_loss", "z_loss"):
        np.testing.assert_allclose(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)),
            rtol=2e-4, atol=2e-4, err_msg=name)
    # disarmed, the router is the unpoisoned one again
    tchaos.clear()
    calm = tgate.router(torch.from_numpy(x), torch.from_numpy(w), tc)
    assert not bool((calm.expert_idx[:, 0] == 3).all())


def test_gate_kernel_launch_takes_the_armed_bias(monkeypatch):
    """The gate kernel's launch carries the armed skew as its bias
    operand, ``(expert mod E, bias)``, and ``(-1, 0)`` disarmed, at the
    slots of ``fm_gate``'s C signature.  Past the single tile (E 300) the
    armed router takes the two-pass gate's kernel route, whose pass 1
    takes the same operand, and equals JAX's armed router."""
    from flashmoe_tpu_torch.config import MoEConfig
    from flashmoe_tpu_torch.kernels import _build

    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    x, w = torch.zeros(16, 64), torch.zeros(64, 8)
    cfg = MoEConfig(num_experts=8, expert_top_k=2, hidden_size=64)
    sig = _build.SIGNATURES["fm_gate"]
    args, _, _ = tgate.gate_args(x, w, cfg)
    assert len(args) == len(sig) and args[9:11] == (-1, 0.0)
    tinject.arm("skewed_routing", expert=11, bias=25.0)
    args, _, _ = tgate.gate_args(x, w, cfg)
    assert args[9:11] == (3, 25.0)
    assert sig[9] is sig[3] and sig[10] is sig[8]  # int, float
    jc, big = _cfgs("f32", num_experts=300, expert_top_k=2, hidden_size=64,
                    intermediate_size=64, sequence_len=16)
    rng = np.random.default_rng(11)
    xb = rng.standard_normal((16, 64)).astype(np.float32)
    wb = (rng.standard_normal((64, 300)) * 0.125).astype(np.float32)
    _arm_both("skewed_routing", expert=11, bias=25.0)
    want = jgate.router(jnp.asarray(xb), jnp.asarray(wb), jc,
                        use_pallas=True)
    # the kernel route: the two-pass gate's wrapper, run by its plain
    # version here (no card), with pass 2 (JAX's armed router_xla always
    # forms the statistics)
    seen = []

    def tiled(*a, need_stats):
        seen.append(need_stats)
        return tgate.router_tiled_plain(*a, need_stats=need_stats)

    monkeypatch.setattr(_build, "use_kernels_for", lambda t, uk: True)
    monkeypatch.setattr(tgate, "router_tiled_cuda", tiled)
    got = tgate.router(torch.from_numpy(xb), torch.from_numpy(wb), big)
    assert seen == [True]
    np.testing.assert_array_equal(got.expert_idx.numpy(),
                                  np.asarray(want.expert_idx))
    assert bool((got.expert_idx[:, 0] == 11).all())
    np.testing.assert_array_equal(got.expert_counts.numpy(),
                                  np.asarray(want.expert_counts))
    for name in ("combine_weights", "probs_mean", "aux_loss", "z_loss"):
        np.testing.assert_allclose(
            getattr(got, name).detach().numpy(),
            np.asarray(getattr(want, name)), rtol=2e-4, atol=2e-4,
            err_msg=name)


@pytest.mark.parametrize("degrade", [True, False])
def test_moe_layer_nan_expert_equals_jax(degrade):
    jc, tc = _cfgs("f32", **LAYER, sequence_len=64, collect_stats=True,
                   capacity_factor=2.0, degrade_unhealthy_experts=degrade)
    p = moe_params(tc, seed=5)
    x = tokens(tc, seed=5)
    _arm_both("nan_expert", expert=2)
    want = jmoe.moe_layer({k: jnp.asarray(v) for k, v in p.items()},
                          jnp.asarray(x), jc, use_pallas=False)
    got = tmoe.moe_layer(params_from_numpy(p, device="cpu"),
                         torch.from_numpy(x), tc)
    if degrade:
        assert_layer(got, want, TOL["f32"])
        assert float(got.stats.masked_experts) == 1.0
        assert bool(torch.isfinite(got.out).all())
    else:
        assert not bool(torch.isfinite(got.out).all())
        np.testing.assert_array_equal(
            torch.isfinite(got.out).numpy(),
            np.isfinite(np.asarray(want.out)))


@pytest.mark.parametrize("case", ["raw", "e4m3", "e4m3_chunked"])
def test_ep_layer_nan_expert_equals_jax(case):  # staticcheck: ok 8 ranks, 256 f32 tokens: seconds a case
    """The poisoned expert's NaN crosses the exchange (and the fp8 wire)
    before the health mask: every one of the 8 ranks masks exactly its
    own exposure to the one armed expert (JAX's assertions,
    ``tests/test_chaos.py:186-248``), and the layer equals JAX's."""
    fields = dict(degrade_unhealthy_experts=True, collect_stats=True)
    expert = 1
    if case != "raw":
        fields.update(wire_dtype="e4m3", wire_dtype_combine="e4m3")
    if case == "e4m3_chunked":
        # global expert 5: owner rank 2, local row 1, chunk 1 of 2
        fields.update(num_experts=16, a2a_chunks=2)
        expert = 5
    jc, tc = _cfgs("f32", **{**LAYER, "sequence_len": 256, "ep": 8,
                             **fields})
    p = moe_params(tc, seed=8)
    x = tokens(tc, seed=8)
    _arm_both("nan_expert", expert=expert)
    want = jax_ep(p, x, jc, 8)
    got = tep.ep_moe_layer(params_from_numpy(p, device="cpu"),
                           torch.from_numpy(x), tc, local_mesh(8))
    assert bool(torch.isfinite(got.out).all())
    assert float(got.stats.masked_experts) == 8.0
    assert float(got.stats.masked_fraction) > 0.0
    assert_layer(got, want, TOL["f32"] if case == "raw" else 1e-3)
    # degradation off: the NaN reaches the output, as in JAX
    off = tc.replace(degrade_unhealthy_experts=False)
    sick = tep.ep_moe_layer(params_from_numpy(p, device="cpu"),
                            torch.from_numpy(x), off, local_mesh(8))
    assert not bool(torch.isfinite(sick.out).all())


def test_rearmed_injection_changes_the_next_step():
    """JAX's ``test_rearmed_injection_survives_remat_cache``
    (``tests/test_chaos.py:899``): re-arming between two builds changes
    the second.  The port runs eagerly, so arming between two calls of
    one loss suffices."""
    from flashmoe_tpu_torch.models import transformer

    cfg = tdrill.drill_config(num_layers=1, sequence_len=16,
                              vocab_size=64, intermediate_size=64)
    params = transformer.init_params(torch.Generator().manual_seed(0), cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, cfg.sequence_len + 1),
                         generator=torch.Generator().manual_seed(1))

    def load():
        return transformer.loss_fn(params, {"tokens": toks}, cfg)[1][
            "moe_stats"][0].expert_load

    calm = load()
    tinject.arm("skewed_routing", expert=0, bias=100.0)
    skewed = load()
    tchaos.clear()
    n_tok = 2 * cfg.sequence_len
    assert float(calm.max()) < n_tok * 0.95
    assert float(skewed[0]) >= n_tok * 0.95
    assert torch.equal(load(), calm)


# ----------------------------------------------------------------------
# host-level faults (tests/test_chaos.py:839-899)
# ----------------------------------------------------------------------

def test_fault_plan_duration_validates():
    with pytest.raises(ValueError, match="duration"):
        tchaos.FaultPlan("slow_step", duration=0)
    assert tchaos.FaultPlan("slow_step").duration == 1


@pytest.mark.parametrize("fault, kw, shares", [
    ("slow_step", dict(step=2, duration=3, sleep_s=0.5), None),
    ("slow_step", dict(step=2, duration=3, sleep_s=0.5, once=False), None),
    ("slow_device", dict(step=1, duration=2, sleep_s=10.0),
     {1: 0.5, 2: 0.0}),
])
def test_wrap_step_stalls_equal_jax(monkeypatch, fault, kw, shares):
    """The stall windows: each visited step of a ``slow_step`` window at
    most once under ``once``, a ``slow_device`` stall priced from the load
    share; the same sleeps as JAX's wrapper on the same visits."""
    slept = {"jax": [], "torch": []}
    side = {"now": "jax"}
    # both modules sleep through the one time module
    monkeypatch.setattr(tchaos.time, "sleep",
                        lambda s: slept[side["now"]].append(s))
    share = (lambda i: shares.get(i, 1.0)) if shares else None
    wrapped = {
        "jax": jchaos.wrap_step(lambda s, b: (s, {}),
                                jchaos.FaultPlan(fault, **kw),
                                load_share=share),
        "torch": tchaos.wrap_step(lambda s, b: (s, {}),
                                  tchaos.FaultPlan(fault, **kw),
                                  load_share=share)}
    for name, fn in wrapped.items():
        side["now"] = name
        for i in range(7):
            st = types.SimpleNamespace(step=torch.tensor(i)
                                       if name == "torch" else i)
            fn(st, None)
            fn(st, None)
    assert slept["torch"] == slept["jax"]
    if fault == "slow_step" and kw.get("once", True):
        assert slept["torch"] == [0.5] * 3
    if fault == "slow_device":
        assert slept["torch"] == [5.0] * 2
    passthrough = tchaos.wrap_step(len, tchaos.FaultPlan("nan_grad"))
    assert passthrough is len


def _raises(inj, i):
    try:
        inj(i)
    except Exception as e:  # noqa: BLE001 - the fault's raise is recorded
        return type(e).__name__
    return None


@pytest.mark.parametrize("fault", ["path_raise", "preempt", "device_loss",
                                   "nan_grad"])
def test_make_injector_equals_jax(fault):
    """The injector's raise (or notice) at each visited step equals
    JAX's: ``path_raise`` raises the port's ``PathFailure`` once,
    ``preempt`` notifies the listener, ``device_loss`` raises until the
    retry budget is spent, in-graph faults never raise."""
    from flashmoe_tpu.runtime.preempt import PreemptionListener as JPL

    rcfg = ResilienceConfig(max_retries=2)
    jpl, tpl = JPL(), PreemptionListener()
    jinj = jchaos.make_injector(jchaos.FaultPlan(fault, step=2), rcfg,
                                preempt=jpl)
    tinj = tchaos.make_injector(tchaos.FaultPlan(fault, step=2), rcfg,
                                preempt=tpl)
    visits = [0, 1, 2, 2, 2, 2, 2, 3]
    got = [_raises(tinj, i) for i in visits]
    assert got == [_raises(jinj, i) for i in visits]
    assert tpl.requested == jpl.requested == (fault == "preempt")
    if fault == "path_raise":
        assert got.count("PathFailure") == 1
    if fault == "device_loss":
        assert got.count("RuntimeError") == rcfg.max_retries + 1


def test_corrupt_ckpt_fault_breaks_the_newest_manifest_crc(tmp_path):
    """The ``corrupt_ckpt`` fault flips bytes in the largest payload file
    of the newest checkpoint (one raw file a leaf in the port): the
    manifest's CRC32 catches it, the older step stays intact, and the
    injector's crash follows."""
    from flashmoe_tpu_torch.runtime.trainer import (init_state,
                                                    make_optimizer)

    cfg = tdrill.drill_config()
    state = init_state(torch.Generator().manual_seed(0), cfg,
                       make_optimizer(cfg))
    d = str(tmp_path / "ck")
    tckpt.save(d, state, step=2)
    tckpt.save(d, state, step=4)
    inj = tchaos.make_injector(
        tchaos.FaultPlan("corrupt_ckpt", step=5),
        ResilienceConfig(checkpoint_dir=d))
    inj(4)
    assert tckpt.verify(d, 4)
    with pytest.raises(RuntimeError, match="corrupting newest"):
        inj(5)
    inj(5)   # once: the second visit is clean
    assert not tckpt.verify(d, 4) and tckpt.verify(d, 2)
    assert tchaos._corrupt_latest_checkpoint(str(tmp_path / "none")) is None


# ----------------------------------------------------------------------
# the drill matrix (tests/test_chaos.py:758-781) and the CLI
# ----------------------------------------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("fault", tdrill.TRAINING_FAULTS)
def test_drill_recovers_at_its_tier(fault, tmp_path):
    r = tdrill.run_drill(fault, workdir=str(tmp_path), device="cpu")
    assert r.recovered, r.reason
    assert r.expected_tier == jchaos.EXPECTED_TIER[fault]
    want = 12 if r.expected_tier.startswith("controller") else 6
    assert r.final_step == want
    if r.expected_tier.startswith(("tier0", "tier1", "controller")):
        assert r.steps_rerun == 0
    if fault == "slow_device":
        assert r.evidence["action"]["rates"] == [0.25, 1.0, 1.0, 1.0]
        assert r.evidence["post_ms"] < 0.5 * r.evidence["pre_ms"]
    if fault == "skew_sustained":
        assert r.evidence["action"]["dropless"]
        assert r.evidence["drop_ema_end"] < 0.05
    if fault == "device_loss":
        worlds = [w for w in r.evidence["worlds"] if w]
        assert worlds and min(worlds) == 1
    json.dumps(r.to_json())
    assert not tinject.trace_signature()
    assert not tselect.failed_backends()


def test_drill_cli_exports_obs_artifacts(tmp_path, capsys):
    obs = tmp_path / "obs"
    rc = chaos_main(["--faults", "nan_grad,path_raise", "--obs-dir",
                     str(obs), "--device", "cpu", "--json"])
    assert rc == 0
    results = [json.loads(line) for line in
               (obs / "drill_results.jsonl").read_text().splitlines()]
    assert {r["fault"] for r in results} == {"nan_grad", "path_raise"}
    assert [r["fault"] for r in json.loads(capsys.readouterr().out)] == \
        [r["fault"] for r in results]
    decisions = [json.loads(line) for line in
                 (obs / "decisions.jsonl").read_text().splitlines()]
    names = {d["decision"] for d in decisions}
    assert "trainer.grad_skip" in names and "planner.fallback" in names
    assert {d["fault"] for d in decisions} == {"nan_grad", "path_raise"}


FABRIC_FAULTS = [f for f in tchaos.FAULTS if f not in tdrill.TRAINING_FAULTS]


def test_drill_cli_rejects_unknown_and_fabric_faults(capsys, monkeypatch):
    """Unknown faults are refused; the serving fabric's ten are accepted
    and handed to ``run_drill`` on the asked device (two of them run in
    the fast gate below, all ten in the slow drill tests)."""
    for argv in (["--faults", "meteor_strike"], ["--faults", ","],
                 ["--fault", "meteor_strike"]):
        with pytest.raises(SystemExit):
            chaos_main(argv + ["--device", "cpu"])
    capsys.readouterr()
    asked = []

    def drilled(fault, **kw):
        asked.append((fault, kw["device"]))
        return tdrill.DrillResult(
            fault, tchaos.EXPECTED_TIER[fault], True, "", 0, 0, 0.0,
            {"decision_names": []}, [])

    monkeypatch.setattr(tdrill, "run_drill", drilled)
    assert len(FABRIC_FAULTS) == 10
    assert chaos_main(["--faults", ",".join(FABRIC_FAULTS), "--device",
                       "cpu", "--json"]) == 0
    assert asked == [(f, "cpu") for f in FABRIC_FAULTS]
    assert [r["fault"] for r in json.loads(capsys.readouterr().out)] == \
        FABRIC_FAULTS


def test_drill_cli_drives_a_vclock_and_a_fabric_fault(tmp_path, capsys):
    """The fast gate: ``dcn_jitter`` surfaces in the drift verdicts and
    ``replica_crash`` migrates, each recovering at its tier, with the
    evidence in the exported artifacts."""
    obs = tmp_path / "obs"
    assert chaos_main(["--fault", "dcn_jitter", "--fault", "replica_crash",
                       "--obs-dir", str(obs), "--device", "cpu"]) == 0
    assert "2/2 faults recovered" in capsys.readouterr().out
    results = {r["fault"]: r for r in map(json.loads, (
        obs / "drill_results.jsonl").read_text().splitlines())}
    jit, crash = results["dcn_jitter"], results["replica_crash"]
    assert jit["expected_tier"] == "monitor:handoff_drift"
    assert jit["evidence"]["perturbed_transfers"] >= 1
    assert crash["expected_tier"] == "fabric:migrate"
    assert crash["evidence"]["bit_equal_to_baseline"]
    assert crash["evidence"]["crashes"] == 1
    assert crash["evidence"]["migrations"] >= 1
    names = {(d["fault"], d["decision"]) for d in map(json.loads, (
        obs / "decisions.jsonl").read_text().splitlines())}
    assert ("dcn_jitter", "fabric.handoff_drift") in names
    assert ("replica_crash", "fabric.migrate") in names


@pytest.mark.slow
def test_run_drill_refuses_fabric_and_unknown_faults():
    """The fabric's drills run through ``run_drill`` (the unknown fault
    stays refused), and ``run_matrix``'s default is every fault."""
    for fault in FABRIC_FAULTS:
        r = tdrill.run_drill(fault, device="cpu")
        assert r.recovered, (fault, r.reason)
    with pytest.raises(ValueError, match="unknown fault"):
        tdrill.run_drill("meteor_strike", device="cpu")
    import inspect

    assert inspect.signature(tdrill.run_matrix).parameters[
        "faults"].default == tchaos.FAULTS == jchaos.FAULTS


@pytest.mark.slow
@pytest.mark.parametrize("fault", FABRIC_FAULTS)
def test_fabric_drill_holds_jax_assertions(fault):
    """Each fabric drill against the assertions of JAX's own tests of it
    (``tests/test_fault_fabric.py``, ``tests/test_frontdoor.py``)."""
    r = tdrill.run_drill(fault, device="cpu")
    ev = r.evidence
    assert r.recovered, r.reason
    assert r.expected_tier == jchaos.EXPECTED_TIER[fault]
    assert ev["completed"] == 6 and ev["trace_errors"] == []
    if fault in ("dcn_latency", "dcn_jitter"):
        assert ev["perturbed_transfers"] >= 1
        assert all(a is not False for a in ev["clean_agree"])
        assert all(ev["attribution_sum_ok"])
        return
    assert ev["bit_equal_to_baseline"] and ev["fleet_trace_events"] > 0
    want = {"replica_crash": ("crashes", 1),
            "handoff_corrupt": ("corrupt", 2),
            "handoff_timeout": ("retries", 2),
            "net_partition": ("partitions", 2),
            "replica_stall": ("stalls", 1),
            "lease_torn_write": ("restored_epoch", 1)}.get(fault)
    if want is not None:
        assert ev[want[0]] == want[1]
    if fault == "lease_split_brain":
        assert ev["zombie_refused"] == ev["zombie_attempts"] >= 1
    if fault == "frontdoor_loss":
        assert ev["failovers"] >= 1
