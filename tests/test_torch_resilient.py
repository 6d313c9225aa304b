"""PyTorch port: the resilient loop, preemption, elastic resume and the
supervisor on the CPU.  ``resilient_train`` with a NaN injected at one
step and a checkpoint every 2 steps against JAX's ``resilient_train`` on
the same numpy weights and token file (per-step losses within 2e-4, the
same failure, restore and replay steps); the retry budget; the deadline
(a host sleep); a preemption drain and resume bit-equal to an unbroken
run; ``fold_parallelism`` against JAX's on every case of JAX's tests;
``elastic_resume`` and ``supervise`` from 8 virtual ranks to 4."""

import signal
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashmoe_tpu.config import MoEConfig as JaxConfig
from flashmoe_tpu.models import transformer as jtf
from flashmoe_tpu.parallel.mesh import make_mesh as jax_make_mesh
from flashmoe_tpu.runtime import data as jdata
from flashmoe_tpu.runtime import elastic as jelastic
from flashmoe_tpu.runtime import resilient as jres
from flashmoe_tpu.runtime import trainer as jtrainer
from flashmoe_tpu.utils.telemetry import Metrics as JaxMetrics
from flashmoe_tpu_torch.config import MoEConfig as TorchConfig
from flashmoe_tpu_torch.convert import params_from_numpy
from flashmoe_tpu_torch.runtime import checkpoint as ckpt
from flashmoe_tpu_torch.runtime import data as tdata
from flashmoe_tpu_torch.runtime import elastic
from flashmoe_tpu_torch.runtime import resilient as tres
from flashmoe_tpu_torch.runtime import trainer as ttrainer
from flashmoe_tpu_torch.runtime.preempt import PreemptionListener
from flashmoe_tpu_torch.tree import tree_leaves
from flashmoe_tpu_torch.utils.telemetry import Metrics

# two layers, the first dense and the second a gated-SiLU dropless MoE
MODEL = dict(num_experts=4, expert_top_k=2, hidden_size=64,
             intermediate_size=64, num_layers=2, moe_frequency=2,
             vocab_size=64, num_heads=2, num_kv_heads=1, sequence_len=8,
             gated_ffn=True, hidden_act="silu", drop_tokens=False,
             is_training=True)
TC = TorchConfig(dtype=torch.float32, param_dtype=torch.float32, **MODEL)
JC = JaxConfig(dtype=jnp.float32, param_dtype=jnp.float32, **MODEL)
STEPS = 6


@pytest.fixture(scope="module")
def token_file(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("tok") / "tokens.bin")
    rng = np.random.default_rng(11)
    tdata.write_token_file(p, rng.integers(0, MODEL["vocab_size"],
                                           size=16 * 9))
    return p


def _numpy_params(seed=0):
    rng = np.random.default_rng(seed)

    def fill(leaf):
        if len(leaf.shape) == 1:
            return (1 + 0.1 * rng.standard_normal(leaf.shape)).astype(
                np.float32)
        return (rng.standard_normal(leaf.shape)
                / np.sqrt(leaf.shape[-2])).astype(np.float32)

    shapes = jax.eval_shape(lambda k: jtf.init_params(k, JC),
                            jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(fill, shapes)


def _torch_state(np_params, opt):
    params = params_from_numpy(np_params, device="cpu")
    return ttrainer.TrainState(params, opt.init(params),
                               torch.zeros((), dtype=torch.int32))


def _loader(path, native=False):
    return tdata.TokenLoader(path, 2, 8, seed=3, native=native,
                             device="cpu")


def _nan_once(step_fn, at, nan, ran):
    """``step_fn`` recording each executed step index in ``ran``; its
    first run of step ``at`` reports a NaN loss."""
    def wrapped(s, b):
        i = int(s.step)
        ns, m = step_fn(s, b)
        ran.append(i)
        if i == at and ran.count(at) == 1:
            m = dict(m, loss=nan)
        return ns, m
    return wrapped


def test_nan_step_recovers_like_jax(token_file, tmp_path):
    np_params = _numpy_params()
    # JAX: its jitted train step on one CPU device, XLA at level 0
    mesh = jax_make_mesh(JC, dp=1, devices=jax.devices()[:1])
    jopt = jtrainer.make_optimizer(JC, total_steps=8)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    jstate = jtrainer.TrainState(jparams, jopt.init(jparams),
                                 jnp.asarray(0, jnp.int32))
    jstate = jax.device_put(jstate, jtrainer.state_shardings(jstate, JC,
                                                             mesh))
    jloader = jdata.TokenLoader(token_file, 2, 8, seed=3, native=False)
    jstep = jtrainer.make_train_step(JC, mesh, jopt).lower(
        jstate, {"tokens": jnp.zeros((2, 9), jnp.int32)}).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    jran, jm = [], JaxMetrics()
    jfinal, jhist = jres.resilient_train(
        jstate, _nan_once(jstep, 3, jnp.float32("nan"), jran), jloader,
        STEPS, rcfg=jres.ResilienceConfig(
            checkpoint_dir=str(tmp_path / "j"), checkpoint_every=2),
        metrics=jm)
    # the port on the same weights and token file
    topt = ttrainer.make_optimizer(TC, total_steps=8)
    tran, tm = [], Metrics()
    tfinal, thist = tres.resilient_train(
        _torch_state(np_params, topt),
        _nan_once(ttrainer.make_train_step(TC, topt), 3,
                  torch.tensor(float("nan")), tran),
        _loader(token_file), STEPS, rcfg=tres.ResilienceConfig(
            checkpoint_dir=str(tmp_path / "t"), checkpoint_every=2),
        metrics=tm)
    # step 3 fails, the checkpoint at 2 is restored and 2, 3 replayed
    assert tran == jran == [0, 1, 2, 3, 2, 3, 4, 5]
    assert int(tfinal.step) == int(jfinal.step) == STEPS
    for k in ("failures", "restores", "checkpoints", "steps"):
        assert tm.counters[k] == jm.counters[k], k
    assert tm.counters["failures"] == tm.counters["restores"] == 1
    got = np.array([h["loss"] for h in thist])
    want = np.array([h["loss"] for h in jhist])
    assert len(got) == len(want) == 7
    np.testing.assert_allclose(got, want, rtol=2e-4)
    # the replayed step 2 ran on its first run's state and batch
    assert got[3] == got[2]


def test_retry_budget_exhausted_saves_the_last_good_state(token_file,
                                                          tmp_path):
    opt = ttrainer.make_optimizer(TC, total_steps=8)
    state = _torch_state(_numpy_params(), opt)
    rcfg = tres.ResilienceConfig(checkpoint_dir=str(tmp_path / "ck"),
                                 checkpoint_every=4, max_retries=2)

    def always_fail(i):
        if i == 1:
            raise RuntimeError("permanent fault")

    m = Metrics()
    with pytest.raises(tres.StepFailure, match="failed 3 times") as e:
        tres.resilient_train(state, ttrainer.make_train_step(TC, opt),
                             _loader(token_file), 4, rcfg=rcfg, metrics=m,
                             fail_injector=always_fail)
    # no checkpoint yet: each retry restarts from the step-0 state, so
    # step 0 ran three times before the abort
    assert len(e.value.partial_history) == 3
    assert m.counters["failures"] == 3 and m.counters["restores"] == 2
    # the emergency save kept step 1's state, and its verifies
    assert ckpt.latest_step(rcfg.checkpoint_dir) == 1
    assert ckpt.verify(rcfg.checkpoint_dir, 1)


def test_deadline_abandons_a_slow_step_and_replays_it(token_file, tmp_path,
                                                      monkeypatch):
    made = []
    real = tres._make_deadline_executor
    monkeypatch.setattr(tres, "_make_deadline_executor",
                        lambda: made.append(1) or real())
    opt = ttrainer.make_optimizer(TC, total_steps=8)
    step = ttrainer.make_train_step(TC, opt)
    slept = []

    def slow_once(s, b):
        if int(s.step) == 1 and not slept:
            slept.append(1)
            import time
            time.sleep(3.0)  # the host stalls; the step runs after it
        return step(s, b)

    m = Metrics()
    final, hist = tres.resilient_train(
        _torch_state(_numpy_params(), opt), slow_once, _loader(token_file),
        3, rcfg=tres.ResilienceConfig(checkpoint_dir=str(tmp_path / "ck"),
                                      checkpoint_every=2,
                                      step_timeout_s=1.5), metrics=m)
    # before the first checkpoint the retry restarts from step 0
    assert int(final.step) == 3 and len(hist) == 4
    assert m.counters["failures"] == 1 and m.counters["restores"] == 1
    # one executor for the run, one more after the abandoned timeout
    assert len(made) == 2


@pytest.mark.parametrize("native", [False, True])
def test_drain_and_resume_equal_an_unbroken_run_bit_for_bit(token_file,
                                                            tmp_path,
                                                            native):
    np_params = _numpy_params(1)
    opt = ttrainer.make_optimizer(TC, total_steps=8)
    step = ttrainer.make_train_step(TC, opt)
    _, unbroken = tres.resilient_train(
        _torch_state(np_params, opt), step, _loader(token_file, native),
        STEPS, rcfg=tres.ResilienceConfig(
            checkpoint_dir=str(tmp_path / "a"), checkpoint_every=2))
    rcfg = tres.ResilienceConfig(checkpoint_dir=str(tmp_path / "b"),
                                 checkpoint_every=2, async_save=True)
    pl = PreemptionListener(grace_s=5.0)
    m = Metrics()

    def poke(i):
        if i == 3:  # the notice lands while step 3 runs
            pl.notify("test")

    mid, first = tres.resilient_train(
        _torch_state(np_params, opt), step, _loader(token_file, native),
        STEPS, rcfg=rcfg, metrics=m, fail_injector=poke, preempt=pl)
    assert int(mid.step) == 4 and len(first) == 4
    assert m.counters["preempt_drains"] == 1
    rec = m.last_decision("preempt.drain")
    assert rec["step"] == 4 and rec["source"] == "test" \
        and 0 < rec["remaining_grace_s"] <= 5.0
    assert ckpt.latest_step(rcfg.checkpoint_dir) == 4
    assert ckpt.load_loader_state(rcfg.checkpoint_dir, 4)["cursor"] == 8
    # a fresh process: a new step-0 state and loader resume at 4
    m2 = Metrics()
    final, rest = tres.resilient_train(
        _torch_state(np_params, opt), step, _loader(token_file, native),
        STEPS, rcfg=rcfg, metrics=m2)
    assert int(final.step) == STEPS and len(rest) == 2
    assert m2.counters["resumes"] == m2.counters["loader_restores"] == 1
    assert [h["loss"] for h in first + rest] == \
        [h["loss"] for h in unbroken]


def test_listener_signal_install_uninstall():
    pl = PreemptionListener(grace_s=1.0)
    before = signal.getsignal(signal.SIGUSR1)
    with pl:
        assert not pl.requested
        signal.raise_signal(signal.SIGUSR1)
        assert pl.wait(timeout=5) and pl.source == "SIGUSR1"
        assert pl.remaining_grace_s() <= 1.0
    assert signal.getsignal(signal.SIGUSR1) is before
    pl.clear()
    assert not pl.requested and pl.notice_age_s() is None


FOLD_CASES = [  # (config overrides, devices): every case of JAX's tests
    (dict(ep=4), 7), (dict(num_experts=7, ep=1), 4),
    (dict(num_experts=6, ep=6), 4), (dict(ep=4), 1),
    (dict(num_experts=8, ep=1), 4), (dict(ep=2, pp=2), 4),
    (dict(ep=2, tp=2), 4), (dict(ep=2, sp=2), 4),
    (dict(ep=2, pp=2, tp=2), 8), (dict(ep=2), 6), (dict(ep=4), 2),
]


@pytest.mark.parametrize("over, n", FOLD_CASES)
def test_fold_parallelism_equals_jax(over, n):
    base = dict(num_experts=4, expert_top_k=2, hidden_size=64,
                intermediate_size=128, sequence_len=32, num_layers=1,
                vocab_size=256, num_heads=2, is_training=True)
    base.update(over)
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        j = jelastic.fold_parallelism(JaxConfig(**base), n)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        t = elastic.fold_parallelism(TorchConfig(**base), n)
    axes = ("ep", "dp", "pp", "tp", "sp")
    assert [getattr(t, a) for a in axes] == [getattr(j, a) for a in axes]
    assert [str(w.message) for w in tw] == [str(w.message) for w in jw]


def test_elastic_resume_eight_ranks_to_four(token_file, tmp_path):
    cfg = TC.replace(ep=4)
    f8 = elastic.fold_parallelism(cfg, 8)
    assert (f8.ep, f8.dp) == (4, 2)
    opt = ttrainer.make_optimizer(f8, total_steps=8)
    guard = ttrainer.GradGuardConfig()
    state = ttrainer.init_state(torch.Generator().manual_seed(0), f8, opt,
                                guard=guard)
    step8 = ttrainer.make_train_step(f8, opt, guard=guard,
                                     mesh=elastic.train_mesh(f8, 8, "cpu"))
    d = str(tmp_path / "ck")
    mid, _ = tres.resilient_train(
        state, step8, _loader(token_file), 2,
        rcfg=tres.ResilienceConfig(checkpoint_dir=d, checkpoint_every=2))
    loader = _loader(token_file)
    with pytest.raises(ValueError, match="GuardState.*guard="):
        elastic.elastic_resume(cfg, d, devices=4, device="cpu")
    new, mesh4, f4, opt4 = elastic.elastic_resume(
        cfg, d, devices=list(range(4)), guard=guard, loader=loader,
        device="cpu")
    assert (f4.ep, f4.dp) == (4, 1) and mesh4.size == 4
    assert int(new.step) == 2 and loader.state_dict()["cursor"] == 4
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(new), tree_leaves(mid)))
    step4 = ttrainer.make_train_step(f4, opt4, guard=guard, mesh=mesh4)
    out, m = step4(new, next(loader))
    assert int(out.step) == 3 and np.isfinite(float(m["loss"]))


def test_supervise_drains_and_resumes_on_fewer_ranks(token_file, tmp_path):
    worlds = iter([8, 4, 4])
    pl = PreemptionListener()
    fired = []

    def poke(i):
        if i == 3 and not fired:
            fired.append(i)
            pl.notify("test")

    m = Metrics()
    final, hist = tres.supervise(
        TC.replace(ep=4), lambda fcfg: _loader(token_file), STEPS,
        tres.ResilienceConfig(checkpoint_dir=str(tmp_path / "ck"),
                              checkpoint_every=2),
        metrics=m, preempt=pl, devices_fn=lambda: next(worlds),
        fail_injector=poke, device="cpu")
    assert int(final.step) == STEPS and len(hist) == STEPS
    assert m.counters["preempt_drains"] == m.counters["preempt_restarts"] \
        == 1
    d = m.last_decision("supervisor.resume")
    assert (d["step"], d["world"], d["ep"], d["dp"]) == (4, 4, 4, 1)
    assert m.counters["loader_restores"] == 1 and not pl.requested
    assert all(np.isfinite(h["loss"]) for h in hist)
