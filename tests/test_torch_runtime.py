"""PyTorch port: the bootstrap, the API facade, the throughput probe, the
trainer's host hooks and the CLIs on the CPU.  ``get_bookkeeping`` and
``get_compiled_config`` against JAX's for the same config (the Decider
off); the runtime controller's keywords run under a sustained skew, the
planes' (``slo``, ``telemetry_port``, ``postmortem_dir``, the Decider)
run, the serving fabric's drill and the perf sentry over the port's
own history run; ``slurm_command`` is JAX's with the port's worker; three
subprocess runs: the worker CLI, ``run_moe(2)`` on gloo against a local
mesh of 2, and ``train_cli --synthetic --device cpu``, whose summary has
JAX's keys."""

import contextlib
import io
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # one intra-op thread a test worker

import flashmoe_tpu as jfm
import flashmoe_tpu_torch as tfm
from flashmoe_tpu.config import MoEConfig as JaxConfig
from flashmoe_tpu.runtime import bootstrap as jboot
from flashmoe_tpu.utils.telemetry import Metrics as JaxMetrics
from flashmoe_tpu_torch.config import MoEConfig as TorchConfig
from flashmoe_tpu_torch.models.reference import init_moe_params
from flashmoe_tpu_torch.ops.moe import moe_layer
from flashmoe_tpu_torch.parallel.ep import ep_moe_layer
from flashmoe_tpu_torch.parallel.mesh import local_mesh
from flashmoe_tpu_torch.runtime import bootstrap as tboot
from flashmoe_tpu_torch.runtime import resilient as tres
from flashmoe_tpu_torch.runtime import throughput
from flashmoe_tpu_torch.runtime import trainer as ttrainer
from flashmoe_tpu_torch.tree import tree_map
from flashmoe_tpu_torch.utils import telemetry as ttel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(num_experts=4, expert_top_k=2, hidden_size=64,
             intermediate_size=128, sequence_len=32)


def setup_function(_):
    jboot.finalize()
    tboot.finalize()


@pytest.mark.parametrize("over, n", [
    (dict(num_experts=8), 8), (dict(num_experts=6, ep=2), 8),
    (dict(num_experts=8, ep=4, dtype="f32"), 8), (dict(num_experts=8), 1),
])
def test_bookkeeping_and_compiled_config_equal_jax(over, n):
    raw = dict(hidden_size=128, intermediate_size=256, **over)
    if "dtype" in raw:
        raw["torch_dtype"] = raw.pop("dtype")
    jrt = jboot.initialize(JaxConfig.from_json(dict(raw)),
                           use_decider=False) if n == 8 else None
    trt = tboot.initialize(TorchConfig.from_json(dict(raw)),
                           use_decider=False, devices=n, device="cpu")
    if jrt is not None:
        assert tfm.get_bookkeeping() == jfm.get_bookkeeping()
        assert tfm.get_compiled_config() == jfm.get_compiled_config()
        assert tfm.get_num_local_experts() == jfm.get_num_local_experts()
    else:
        assert tfm.get_bookkeeping()["mesh"] == {
            "dp": 1, "pp": 1, "ep": 1, "tp": 1, "sp": 1}
        assert tfm.get_num_local_experts() == 8
    assert tboot.get_runtime() is trt and tboot.initialize() is trt
    jboot.finalize()
    tboot.finalize()
    with pytest.raises(RuntimeError, match="not initialized"):
        tboot.get_runtime()
    # before initialize: the default config, JAX's dict
    assert tfm.get_compiled_config() == jfm.get_compiled_config()


def test_refusals_name_their_roadmap_items(tmp_path):
    from flashmoe_tpu_torch import observe
    from flashmoe_tpu_torch.chaos.__main__ import main as chaos_main
    from flashmoe_tpu_torch.profiler import postmortem as pm
    from flashmoe_tpu_torch.profiler.slo import SLOConfig, SLOWatchdog

    state = ttrainer.TrainState({"w": torch.zeros(2)}, {}, torch.tensor(0))
    # the runtime controller, the serving fabric and the perf sentry run
    # now
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert chaos_main(["--fault", "replica_crash", "--device",
                           "cpu"]) == 0
    assert "1/1 faults recovered" in out.getvalue()
    assert TorchConfig(**SMALL, serving_mode="decode").serving_mode == \
        "decode"
    # the perf sentry runs over the port's own history: clean, rc 0
    from flashmoe_tpu_torch.telemetry_plane import regression as treg

    history = str(tmp_path / "history_torch.jsonl")
    for run in ("r1", "r2"):
        treg.append_run(history, treg.reference_points("h100"), run=run)
    with contextlib.redirect_stdout(io.StringIO()) as rep:
        assert observe.main(["--regression", "--ci", history]) == 0
    assert "all within tolerance" in rep.getvalue()
    # ported with the planes: slo, telemetry_port and postmortem_dir run

    def step_fn(s, b):
        return s._replace(step=s.step + 1), {"loss": torch.tensor(1.0)}

    def failing(s, b):
        raise RuntimeError("step fails")

    rcfg = tres.ResilienceConfig(checkpoint_dir=str(tmp_path / "ck"),
                                 checkpoint_every=10, max_retries=1,
                                 emergency_save=False)
    m = ttel.Metrics()
    wd = SLOWatchdog(SLOConfig(step_ms=1e-9, consecutive=2), metrics=m)
    out, hist = tres.resilient_train(state, step_fn, iter(range(9)), 3,
                                     rcfg=rcfg, metrics=m, slo=wd,
                                     telemetry_port=0)
    assert int(out.step) == 3 and len(hist) == 3
    assert m.counters["slo.breaches"] == 3
    assert m.counters["decision.telemetry.server_stop"] == 1
    with pytest.raises(tres.StepFailure) as e:
        tres.resilient_train(state, failing, iter(range(9)), 2,
                             rcfg=tres.ResilienceConfig(
                                 checkpoint_dir=str(tmp_path / "ck2"),
                                 max_retries=1, emergency_save=False),
                             metrics=ttel.Metrics(),
                             postmortem_dir=str(tmp_path / "pm"),
                             cfg=TorchConfig(**SMALL))
    b = pm.load_bundle(e.value.postmortem_bundle)
    assert "step fails" in b["traceback"] and b["config"] is not None
    # the Decider over more than one rank
    rt = tboot.initialize(TorchConfig(**SMALL), devices=2, device="cpu")
    assert rt.group_plan is not None and rt.cfg.ep == 2
    tboot.finalize()
    assert tboot.initialize(TorchConfig(**SMALL), device="cpu").cfg.ep == 1


@pytest.mark.parametrize("keyword", ["train", "resilient_train",
                                     "supervise", "adapt"])
def test_controller_keywords_run(keyword, tmp_path):
    """``train(controller=)``, ``resilient_train(controller=,
    rebuild_step=)``, ``supervise(controller=)`` and
    ``ResilienceConfig.adapt`` run at the drill configuration under a
    sustained routing skew: one ``controller.morph`` to the dropless
    layer, and the loop reaches its last step."""
    from flashmoe_tpu_torch import chaos
    from flashmoe_tpu_torch.chaos.drill import data_stream, drill_config
    from flashmoe_tpu_torch.runtime.controller import (ControllerConfig,
                                                       RuntimeController)

    ccfg = ControllerConfig(debounce_steps=2, cooldown_steps=3,
                            baseline_steps=2, ema_decay=0.5, morph_budget=1,
                            enable_replace=False)
    cfg = drill_config()
    m = ttel.Metrics()
    ctl = None if keyword == "adapt" else RuntimeController(
        cfg, ccfg, metrics=m, device="cpu")
    chaos.inject.arm("skewed_routing", expert=0, bias=100.0)
    try:
        rcfg = tres.ResilienceConfig(
            checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=3,
            adapt=ccfg if keyword == "adapt" else None)
        if keyword == "train":
            state, _ = ttrainer.train(
                cfg, data_stream(cfg, 2, 0, "cpu"), 7,
                generator=torch.Generator().manual_seed(0), controller=ctl)
        elif keyword == "resilient_train":
            opt = ttrainer.make_optimizer(cfg, total_steps=7)

            def rebuild(ov):
                return ttrainer.make_train_step(cfg.replace(**ov), opt)

            state, _ = tres.resilient_train(
                ttrainer.init_state(torch.Generator().manual_seed(0), cfg,
                                    opt),
                rebuild({}), data_stream(cfg, 2, 0, "cpu"), 7, rcfg=rcfg,
                metrics=m, controller=ctl, rebuild_step=rebuild)
        else:
            state, _ = tres.supervise(
                cfg, lambda fcfg: data_stream(fcfg, 2, 0, "cpu"), 7, rcfg,
                metrics=m, controller=ctl, device="cpu")
    finally:
        chaos.clear()
    assert int(state.step) == 7
    morphs = [d for d in m.decisions if d["decision"] == "controller.morph"]
    assert len(morphs) == 1 and morphs[0]["dropless"]
    assert morphs[0]["overrides"] == {"drop_tokens": False}


def test_throughput_probe_on_the_cpu():
    cfg = TorchConfig(**SMALL, dtype=torch.float32)
    rate = throughput.measure_expert_throughput(
        cfg, rows_per_expert=64, chain=3, trials=2, device="cpu")
    assert np.isfinite(rate) and rate > 0
    # cached per device; device_rates repeats the device's reading
    assert throughput.measure_expert_throughput(
        cfg, rows_per_expert=64, device="cpu") == rate
    rates = throughput.device_rates(cfg, 3, rows_per_expert=64,
                                    device="cpu")
    assert rates.shape == (3,) and np.all(rates == rates[0])


def test_train_flight_recorder_histogram_and_grad_skip(tmp_path):
    """``train``'s host hooks: every step recorded and flushed in append
    mode, the ``trainer.step_ms`` histogram, and a ``trainer.grad_skip``
    decision for a step whose update the guard skipped."""
    cfg = TorchConfig(**SMALL, num_layers=1, vocab_size=64, num_heads=2,
                      is_training=True, drop_tokens=False,
                      dtype=torch.float32, param_dtype=torch.float32)
    tokens = torch.randint(0, 64, (2, 33),
                           generator=torch.Generator().manual_seed(0))
    bad = {"tokens": tokens, "mask": torch.full((2, 32), float("nan"))}
    batches = iter([{"tokens": tokens}, bad, {"tokens": tokens}])
    before = ttel.metrics.histograms.get("trainer.step_ms")
    n0 = before.n if before is not None else 0
    path = str(tmp_path / "flight.jsonl")
    _, hist = ttrainer.train(
        cfg, batches, 3, generator=torch.Generator().manual_seed(0),
        log_every=10, guard=ttrainer.GradGuardConfig(), flight_path=path,
        flight_flush_every=2)
    recs = [json.loads(ln) for ln in open(path)]
    assert [r["step"] for r in recs] == [0, 1, 2]
    assert [r["grad_ok"] for r in recs] == [1.0, 0.0, 1.0]
    assert all(r["step_ms"] > 0 for r in recs) and len(hist) == 2
    assert ttel.metrics.histograms["trainer.step_ms"].n == n0 + 3
    skip = ttel.metrics.last_decision("trainer.grad_skip")
    assert skip["step"] == 1 and np.isnan(skip["grad_norm"])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _write_cfg(tmp_path, **over) -> str:
    p = tmp_path / "cfg.json"
    p.write_text(json.dumps(dict(SMALL, torch_dtype=0, hidden_act=1,
                                 **over)))
    return str(p)


def _worker_inputs(cfg, rank):
    params = init_moe_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    params = tree_map(lambda p: p.to(cfg.dtype), params)
    x = torch.randn((cfg.tokens, cfg.hidden_size),
                    generator=torch.Generator().manual_seed(1 + rank),
                    dtype=cfg.dtype)
    return params, x


def _sums(t) -> tuple[float, float]:
    t = t.double()
    return float(t.sum()), float((t * t).sum())


def test_worker_cli_matches_moe_layer(tmp_path):
    cfg_path = _write_cfg(tmp_path)
    out = subprocess.run(
        [sys.executable, "-m", "flashmoe_tpu_torch.runtime.worker",
         cfg_path, "--device", "cpu"], capture_output=True, text=True,
        timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    cfg = TorchConfig.from_json(cfg_path)
    params, x = _worker_inputs(cfg, 0)
    want = moe_layer(params, x, cfg).out
    assert rec["rank"] == 0 and rec["finite"] is True
    assert rec["output_shape"] == [32, 64] and rec["num_local_experts"] == 4
    np.testing.assert_allclose([rec["out_sum"], rec["out_sumsq"]],
                               _sums(want), rtol=1e-6)


def test_run_moe_two_processes_on_gloo_match_a_local_mesh(tmp_path,
                                                          capfd):
    cfg_path = _write_cfg(tmp_path)
    rc = tfm.run_moe(2, config_path=cfg_path, device="cpu",
                     coordinator=f"127.0.0.1:{_free_port()}", timeout=60)
    assert rc == 0
    recs = sorted((json.loads(ln) for ln in capfd.readouterr().out
                   .splitlines() if ln.startswith('{"rank"')),
                  key=lambda r: r["rank"])
    assert [r["rank"] for r in recs] == [0, 1]
    # the same weights on both ranks, each rank its own tokens: a local
    # mesh of 2 on the concatenated tokens
    cfg = TorchConfig.from_json(cfg_path).replace(ep=2)
    params, x0 = _worker_inputs(cfg, 0)
    _, x1 = _worker_inputs(cfg, 1)
    want = ep_moe_layer(params, torch.cat([x0, x1]), cfg,
                        local_mesh(2)).out
    for r, part in zip(recs, want.split(cfg.tokens)):
        assert r["finite"] and r["output_shape"] == [32, 64]
        assert r["num_local_experts"] == 2
        np.testing.assert_allclose([r["out_sum"], r["out_sumsq"]],
                                   _sums(part), rtol=1e-5, atol=1e-6)


def test_train_cli_synthetic_summary_has_jax_keys(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "flashmoe_tpu_torch.runtime.train_cli",
         "--synthetic", "--device", "cpu", "--steps", "3", "--batch", "2",
         "--log-every", "1", "--metrics-jsonl", str(tmp_path / "m.jsonl"),
         "--set", "hidden_size=64", "--set", "intermediate_size=128",
         "--set", "vocab_size=64", "--set", "sequence_len=16", "--set",
         "num_heads=2", "--set", "num_experts=4", "--set",
         "dtype=float32"], capture_output=True, text=True, timeout=120,
        cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    # JAX's CLI without a checkpoint directory: its Metrics' step timer,
    # final_loss and steps
    jm = JaxMetrics()
    for _ in range(3):
        with jm.timer("step"):
            pass
    assert set(summary) == set(jm.summary()) | {"final_loss", "steps"}
    steps = [json.loads(ln) for ln in out.stderr.splitlines()
             if ln.startswith('{"step"')]
    assert [s["step"] for s in steps] == [0, 1, 2]
    assert summary["final_loss"] == steps[-1]["loss"] and \
        np.isfinite(summary["final_loss"]) and summary["steps"] == 3
    dumped = json.loads((tmp_path / "m.jsonl").read_text())
    assert dumped["step_calls"] == 3 and dumped["steps"] == 3


@pytest.mark.parametrize("n_nodes, path", [(1, "cfg.json"),
                                           (16, "/jobs/mixtral.json")])
def test_slurm_command_is_jaxs_with_the_ports_worker(n_nodes, path):
    from flashmoe_tpu.runtime import launcher as jlauncher
    from flashmoe_tpu_torch.runtime import launcher as tlauncher

    want = jlauncher.slurm_command(n_nodes, path).replace(
        "flashmoe_tpu.runtime.worker", "flashmoe_tpu_torch.runtime.worker")
    assert tlauncher.slurm_command(n_nodes, path) == want
    assert "-m flashmoe_tpu_torch.runtime.worker " in want
