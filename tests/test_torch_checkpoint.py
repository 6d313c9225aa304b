"""PyTorch port: checkpoints (``runtime/checkpoint.py``) on the CPU, one
test for each behaviour of the JAX package's ``tests/test_checkpoint.py``
(the round trip with and without the guard, the empty directory, async
saves, the newest-wins queue, no drop across directories, writer errors,
a kill between payload and manifest, the loader and quant blocks,
``has_guard``), a corrupted file that falls back, retention, and the
manifest's keys against a JAX checkpoint of the same state."""

import json
import os
import shutil
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashmoe_tpu.runtime import checkpoint as jckpt
from flashmoe_tpu.runtime.trainer import TrainState as JaxTrainState
from flashmoe_tpu_torch.config import MoEConfig
from flashmoe_tpu_torch.runtime import checkpoint as ckpt
from flashmoe_tpu_torch.runtime.trainer import (GradGuardConfig, TrainState,
                                                init_guard_state, init_state,
                                                make_optimizer,
                                                make_train_step)
from flashmoe_tpu_torch.tree import tree_leaves
from flashmoe_tpu_torch.utils.telemetry import metrics as global_metrics

CFG = MoEConfig(num_experts=4, expert_top_k=2, hidden_size=64,
                intermediate_size=128, sequence_len=16, num_layers=2,
                moe_frequency=2, vocab_size=128, num_heads=2,
                drop_tokens=False, is_training=True, dtype=torch.float32,
                param_dtype=torch.bfloat16)


def _tiny_state(step: int) -> TrainState:
    g = torch.Generator().manual_seed(step)
    return TrainState(params={"w": torch.randn(16, 16, generator=g)},
                      opt_state={"m": torch.zeros(16, 16)},
                      step=torch.tensor(step, dtype=torch.int32))


def _equal(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("guarded", [False, True])
def test_save_restore_roundtrip(guarded, tmp_path):
    guard = GradGuardConfig() if guarded else None
    opt = make_optimizer(CFG, total_steps=4)
    state = init_state(torch.Generator().manual_seed(0), CFG, opt,
                       guard=guard)
    step = make_train_step(CFG, opt, guard=guard)
    tokens = torch.randint(0, CFG.vocab_size, (2, 17),
                           generator=torch.Generator().manual_seed(1))
    state, _ = step(state, {"tokens": tokens})
    d = str(tmp_path / "ck")
    assert ckpt.save(d, state) == 1 and ckpt.latest_step(d) == 1
    assert ckpt.has_guard(d, 1) is guarded
    # a template of other values: every leaf comes back bit for bit, bf16
    # params and int32 counts included
    fresh = init_state(torch.Generator().manual_seed(42), CFG, opt,
                       guard=guard)
    restored = ckpt.restore(d, fresh)
    assert _equal(restored, state)
    assert restored.params["embed"].dtype == torch.bfloat16
    # and into a template on 'meta', which allocates nothing
    assert _equal(ckpt.restore(d, ckpt.abstract_state(state),
                               device="cpu"), state)
    with pytest.raises(ValueError, match="device="):
        ckpt.restore(d, ckpt.abstract_state(state))
    # training continues from the restored state
    state2, m = step(restored, {"tokens": tokens})
    assert int(state2.step) == 2 and np.isfinite(float(m["loss"]))


def test_guarded_template_over_guard_free_checkpoint(tmp_path):
    """JAX's ``_fresh_guard``: a guard-free checkpoint restores into a
    guarded template with a fresh GuardState; the other direction names
    the leaves the template lacks."""
    d = str(tmp_path / "ck")
    ckpt.save(d, _tiny_state(1))
    got = ckpt.restore(d, _tiny_state(9)._replace(
        guard=init_guard_state("cpu")))
    assert float(got.guard.norm_ema) == 0.0 and int(got.guard.seen) == 0
    ckpt.save(d, _tiny_state(2)._replace(guard=init_guard_state("cpu")))
    with pytest.raises(ValueError, match="guard"):
        ckpt.restore(d, _tiny_state(9), step=2)


def test_latest_step_empty(tmp_path):
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    assert ckpt.intact_steps(str(tmp_path / "none")) == []
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), _tiny_state(0))


def test_async_save_verifies_and_restores(tmp_path):
    d = str(tmp_path / "ck")
    state = _tiny_state(1)
    cursor = {"epoch": 0, "cursor": 2, "seed": 7, "shuffle": True}
    ckpt.save(d, state, blocking=False, loader_state=cursor)
    assert ckpt.wait_for_saves() == []
    assert ckpt.latest_step(d) == 1 and ckpt.verify(d, 1)
    assert ckpt.load_loader_state(d, 1) == cursor
    assert _equal(ckpt.restore(d, _tiny_state(9)), state)


def test_async_queue_is_newest_wins(tmp_path, monkeypatch):
    d = str(tmp_path / "ck")
    gate = threading.Event()
    real = ckpt._write_sync
    stalled = {"n": 0}

    def slow_write(directory, state, step, loader_state,
                   controller_state=None):
        stalled["n"] += 1
        if stalled["n"] == 1:
            gate.wait(timeout=30)
        real(directory, state, step, loader_state)

    monkeypatch.setattr(ckpt, "_write_sync", slow_write)
    before = ckpt.async_save_stats()
    ckpt.save(d, _tiny_state(1), blocking=False)  # in flight, stalled
    for _ in range(500):
        if stalled["n"]:
            break
        time.sleep(0.01)
    assert stalled["n"] == 1
    for s in (2, 3, 4):  # depth 1: 2 and 3 are replaced by 4
        ckpt.save(d, _tiny_state(s), blocking=False)
    gate.set()
    assert ckpt.wait_for_saves() == []
    after = ckpt.async_save_stats()
    assert after["dropped"] - before["dropped"] == 2
    assert after["completed"] - before["completed"] == 2  # 1 and 4
    assert ckpt.all_steps(d) == [1, 4] and ckpt.verify(d, 4)


def test_async_queue_never_drops_across_directories(tmp_path):
    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    before = ckpt.async_save_stats()
    ckpt.save(d1, _tiny_state(1), blocking=False)
    ckpt.save(d2, _tiny_state(1), blocking=False)
    assert ckpt.wait_for_saves() == []
    assert ckpt.async_save_stats()["dropped"] == before["dropped"]
    assert ckpt.latest_step(d1) == ckpt.latest_step(d2) == 1
    assert ckpt.verify(d1, 1) and ckpt.verify(d2, 1)


def test_async_writer_error_is_surfaced_not_raised(tmp_path, monkeypatch):
    def boom(directory, state, step, loader_state, controller_state=None):
        raise OSError("disk on fire")

    monkeypatch.setattr(ckpt, "_write_sync", boom)
    ckpt.save(str(tmp_path / "ck"), _tiny_state(1), blocking=False)
    errors = ckpt.wait_for_saves()
    assert len(errors) == 1 and "disk on fire" in str(errors[0])
    assert ckpt.wait_for_saves() == []  # drained once
    assert global_metrics.last_decision("checkpoint.async_error")["step"] \
        == 1


def test_kill_between_payload_and_manifest_keeps_previous_step(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save(d, _tiny_state(1))
    ckpt.save(d, _tiny_state(2))
    # a kill mid-payload leaves a private directory no query sees
    shutil.copytree(ckpt.step_dir(d, 2), os.path.join(d, ".tmp-3-999-1"))
    assert ckpt.latest_step(d) == 2 and ckpt.all_steps(d) == [1, 2]
    assert int(ckpt.restore(d, _tiny_state(9)).step) == 2
    # a kill between the payload's rename and the manifest: a complete
    # manifest-less step, restorable; the previous step still verifies
    os.remove(os.path.join(d, "manifest-2.json"))
    assert ckpt.verify(d, 2) and ckpt.verify(d, 1)
    assert int(ckpt.restore(d, _tiny_state(9)).step) == 2
    assert ckpt.load_loader_state(d, 2) is None


def test_manifest_loader_state_roundtrip_and_legacy(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save(d, _tiny_state(1))
    assert ckpt.load_loader_state(d, 1) is None
    assert ckpt.load_controller_state(d, 1) is None
    cursor = {"epoch": 1, "cursor": 3, "seed": 0, "shuffle": False}
    ckpt.save(d, _tiny_state(2), loader_state=cursor,
              controller_state={"plan": [1, 2]})
    assert ckpt.load_loader_state(d, 2) == cursor
    assert ckpt.load_controller_state(d, 2) == {"plan": [1, 2]}
    assert ckpt.verify(d, 2)
    loader = type("L", (), {"load_state_dict": lambda self, s:
                            setattr(self, "got", s)})()
    assert ckpt.restore_loader_state(d, 2, loader) and loader.got == cursor
    assert not ckpt.restore_loader_state(d, 1, loader)
    assert not ckpt.restore_loader_state(d, 2, None)


def test_quant_manifest_block_and_backcompat(tmp_path):
    from flashmoe_tpu_torch import quant as qt
    from flashmoe_tpu_torch.models.reference import init_moe_params

    d = str(tmp_path / "ck")
    ckpt.save(d, _tiny_state(1))
    assert ckpt.load_quant_metadata(d, 1) is None
    qcfg = MoEConfig(num_experts=4, hidden_size=64, intermediate_size=128,
                     dtype=torch.float32, param_dtype=torch.float32)
    params = init_moe_params(torch.Generator().manual_seed(0), qcfg)
    qs = qt.quantize_state(params, "int8")
    state = TrainState(params={"moe": dict(qs.params)}, opt_state={},
                       step=torch.tensor(2, dtype=torch.int32))
    ckpt.save(d, state, blocking=False)
    assert ckpt.wait_for_saves() == []
    meta = ckpt.load_quant_metadata(d, 2)
    assert meta is not None and meta["dtype"] == "int8"
    assert qt.verify_quant_metadata(meta) and ckpt.verify(d, 2)
    restored = ckpt.restore(d, state)
    assert restored.params["moe"]["w_up"].dtype == torch.int8
    want = qt.dequantize_state(state.params["moe"])
    got = qt.dequantize_state(restored.params["moe"])
    for k in ("w_up", "w_down"):
        assert torch.equal(got[k], want[k])
    mpath = os.path.join(d, "manifest-2.json")
    with open(mpath) as f:
        manifest = json.load(f)
    manifest["quant"]["dtype"] = "e4m3"
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(ckpt.CheckpointCorruptionError,
                       match="quant metadata"):
        ckpt.load_quant_metadata(d, 2)


def test_has_guard_probe(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save(d, _tiny_state(1))
    assert ckpt.has_guard(d, 1) is False
    ckpt.save(d, _tiny_state(2)._replace(guard=init_guard_state("cpu")))
    assert ckpt.has_guard(d, 2) is True
    assert ckpt.has_guard(d, 7) is None


@pytest.mark.parametrize("fault", ["flip", "truncate", "remove"])
def test_corrupted_step_falls_back_to_newest_intact(fault, tmp_path):
    d = str(tmp_path / "ck")
    for s in (1, 2, 3):
        ckpt.save(d, _tiny_state(s))
    leaf = os.path.join(ckpt.step_dir(d, 3), "00000.bin")
    if fault == "flip":
        with open(leaf, "r+b") as f:
            f.seek(5)
            b = f.read(1)
            f.seek(5)
            f.write(bytes([b[0] ^ 0x40]))
    elif fault == "truncate":
        with open(leaf, "r+b") as f:
            f.truncate(10)
    else:
        os.remove(leaf)
    assert not ckpt.verify(d, 3) and ckpt.intact_steps(d) == [1, 2]
    got = ckpt.restore(d, _tiny_state(9))
    assert _equal(got, _tiny_state(2))
    rec = global_metrics.last_decision("checkpoint.fallback")
    assert rec["corrupt_step"] == 3 and rec["restored_step"] == 2 \
        and rec["lost_steps"] == 1
    with pytest.raises(ckpt.CheckpointCorruptionError):
        ckpt.restore(d, _tiny_state(9), fallback=False)
    # every step corrupt: nothing intact is left
    for s in (1, 2):
        os.remove(os.path.join(ckpt.step_dir(d, s), "00000.bin"))
    with pytest.raises(ckpt.CheckpointCorruptionError):
        ckpt.restore(d, _tiny_state(9))


def test_retention_and_emergency_save(tmp_path):
    d = str(tmp_path / "ck")
    for s in range(1, 6):
        ckpt.save(d, _tiny_state(s))
    assert ckpt.all_steps(d) == [3, 4, 5]
    assert sorted(f for f in os.listdir(d) if f.startswith("manifest")) \
        == ["manifest-3.json", "manifest-4.json", "manifest-5.json"]
    # the step is on disk: nothing to do; a new one is saved; never raises
    assert ckpt.emergency_save(d, _tiny_state(5)) is None
    assert ckpt.emergency_save(d, _tiny_state(6)) == 6
    assert ckpt.emergency_save(str(tmp_path / "f"), object()) is None
    # re-saving a step replaces it (a rewound run saving it again)
    ckpt.save(d, _tiny_state(6)._replace(params={"w": torch.zeros(16, 16)}))
    assert ckpt.verify(d, 6)
    assert float(ckpt.restore(d, _tiny_state(0)).params["w"].abs().sum()) \
        == 0.0


def test_manifest_keys_equal_jax(tmp_path):
    """The manifest has JAX's top-level keys and blocks for the same
    state and cursor (its payload files are the port's own)."""
    w = np.arange(256, dtype=np.float32).reshape(16, 16)
    cursor = {"epoch": 0, "cursor": 1, "seed": 2, "shuffle": True}
    jd, td = str(tmp_path / "j"), str(tmp_path / "t")
    jckpt.save(jd, JaxTrainState(params={"w": jnp.asarray(w)},
                                 opt_state={"m": jnp.zeros((16, 16))},
                                 step=jnp.asarray(1, jnp.int32)),
               loader_state=cursor)
    jckpt.close_manager(jd)
    ckpt.save(td, TrainState(params={"w": torch.from_numpy(w)},
                             opt_state={"m": torch.zeros(16, 16)},
                             step=torch.tensor(1, dtype=torch.int32)),
              loader_state=cursor)
    with open(os.path.join(jd, "manifest-1.json")) as f:
        jm = json.load(f)
    with open(os.path.join(td, "manifest-1.json")) as f:
        tm = json.load(f)
    assert set(tm) == set(jm) == {"step", "files", "loader"}
    assert tm["step"] == jm["step"] and tm["loader"] == jm["loader"]
    assert all(set(v) == {"size", "crc32"} for v in tm["files"].values())
