"""PyTorch port: the runtime's host pieces against the JAX package on the
CPU: the config file (``MoEConfig.from_json`` / ``to_json``), the CRC32
helpers, the token loader (both arms, two epochs, shuffled and not, its
cursor), the telemetry the runtime writes (``Histogram``, ``Metrics``'
timers, summary and JSONL dump, the flight recorder's offset-aware
export), and the refusal of the knobs of later slices."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashmoe_tpu.config import MoEConfig as JaxConfig
from flashmoe_tpu.runtime import data as jdata
from flashmoe_tpu.utils import integrity as jint
from flashmoe_tpu.utils import telemetry as jtel
from flashmoe_tpu_torch.config import MoEConfig as TorchConfig
from flashmoe_tpu_torch.runtime import data as tdata
from flashmoe_tpu_torch.runtime import _native
from flashmoe_tpu_torch.utils import integrity as tint
from flashmoe_tpu_torch.utils import telemetry as ttel

# csrc/flashmoe_config.json's style: int hidden_act and torch_dtype, 0/1
# booleans (tests/test_config.py's dict)
REFERENCE_JSON = {
    "capacity_factor": 1, "drop_tokens": 1, "expert_top_k": 2,
    "global_batch": 1, "is_training": 0, "hidden_act": 0,
    "hidden_size": 2048, "intermediate_size": 2048, "mini_batch": 1,
    "moe_frequency": 2, "num_experts": 64, "num_layers": 2,
    "sequence_len": 8192, "torch_dtype": 1, "vocab_size": 50257,
}


def _as_jax_dict(cfg) -> dict:
    """A config's fields with dtypes by name, the JSON view of both."""
    d = json.loads(cfg.to_json())
    d["expert_replicas"] = [list(p) for p in d["expert_replicas"]]
    return d


@pytest.mark.parametrize("raw", [
    REFERENCE_JSON,
    dict(REFERENCE_JSON, torch_dtype=0, hidden_act=1, drop_tokens=0,
         is_training=1, unknown_key=3),
    {"num_experts": 8, "hidden_size": 128, "intermediate_size": 256,
     "hidden_act": "silu", "gated_ffn": True, "torch_dtype": "f32"},
])
def test_from_json_and_to_json_equal_jax(raw, tmp_path):
    jc = JaxConfig.from_json(dict(raw))
    tc = TorchConfig.from_json(dict(raw))
    assert _as_jax_dict(tc) == _as_jax_dict(jc)
    assert json.loads(tc.to_json())["dtype"] in ("bfloat16", "float32")
    # a path reads as the dict does, and the port reads its own file back
    p = tmp_path / "cfg.json"
    p.write_text(json.dumps(raw))
    assert TorchConfig.from_json(str(p)) == tc
    p.write_text(tc.to_json())
    assert TorchConfig.from_json(str(p)) == tc


def test_to_json_round_trip_every_field(tmp_path):
    tc = TorchConfig(num_experts=8, hidden_size=128, intermediate_size=256,
                     dtype=torch.float32, param_dtype=torch.bfloat16,
                     expert_replicas=((0, 3),), a2a_chunks=2, ep=2,
                     wire_dtype="bf16", global_batch=4, router_jitter=0.1)
    back = TorchConfig.from_json(json.loads(tc.to_json()))
    assert back == tc
    jc = JaxConfig(num_experts=8, hidden_size=128, intermediate_size=256,
                   dtype=jnp.float32, param_dtype=jnp.bfloat16,
                   expert_replicas=((0, 3),), a2a_chunks=2, ep=2,
                   wire_dtype="bf16", global_batch=4, router_jitter=0.1)
    assert json.loads(tc.to_json()) == json.loads(jc.to_json()) | {
        "expert_replicas": [[0, 3]]}


@pytest.mark.parametrize("data", [b"", b"flashmoe", bytes(range(256)) * 17])
def test_crc_equals_jax(data, tmp_path):
    assert tint.crc32_bytes(data) == jint.crc32_bytes(data)
    assert tint.crc32_bytes(data, 7) == jint.crc32_bytes(data, 7)
    for pages in (1, 3, 8):
        assert tint.crc32_pages(data, pages) == jint.crc32_pages(data, pages)
    p = tmp_path / "blob"
    p.write_bytes(data)
    assert tint.crc32_file(str(p), chunk=1000) == jint.crc32_file(str(p))


@pytest.fixture(scope="module")
def token_file(tmp_path_factory):
    """13 windows of 9 tokens (and a ragged tail), seeded numpy."""
    p = str(tmp_path_factory.mktemp("tok") / "tokens.bin")
    rng = np.random.default_rng(3)
    tdata.write_token_file(p, rng.integers(0, 1000, size=13 * 9 + 4))
    return p


def _native_arm() -> bool:
    return _native.load() is not None


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("native", [False, True])
def test_loader_batches_equal_jax_over_two_epochs(token_file, shuffle,
                                                  native):
    if native and not _native_arm():
        pytest.fail("g++ could not build the port's native loader")
    jl = jdata.TokenLoader(token_file, 3, 8, seed=5, shuffle=shuffle,
                           native=False)
    tl = tdata.TokenLoader(token_file, 3, 8, seed=5, shuffle=shuffle,
                           native=native, device="cpu")
    assert tl.is_native is native and tl.num_windows == 13
    for _ in range(9):  # 27 windows: past the second epoch's start
        got = next(tl)["tokens"]
        assert got.dtype == torch.int32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(next(jl)["tokens"]))
        assert tl.state_dict() == jl.state_dict()
    tl.close()
    jl.close()
    with pytest.raises(RuntimeError, match="closed"):
        next(tl)


@pytest.mark.parametrize("native", [False, True])
def test_loader_state_dict_resumes_mid_epoch(token_file, native):
    a = tdata.TokenLoader(token_file, 2, 8, seed=9, native=native,
                          device="cpu")
    for _ in range(4):
        next(a)
    st = a.state_dict()
    assert st == {"epoch": 0, "cursor": 8, "seed": 9, "shuffle": True}
    want = [next(a)["tokens"] for _ in range(5)]
    # a fresh loader of another seed takes the state's seed and position
    b = tdata.TokenLoader(token_file, 2, 8, seed=1, native=native,
                          device="cpu")
    b.load_state_dict(st)
    for w in want:
        assert torch.equal(next(b)["tokens"], w)
    # the same cursor through JAX's loader
    j = jdata.TokenLoader(token_file, 2, 8, seed=1, native=False)
    j.load_state_dict(st)
    np.testing.assert_array_equal(np.asarray(next(j)["tokens"]),
                                  want[0].numpy())
    with pytest.raises(ValueError, match="out of range"):
        b.load_state_dict(dict(st, cursor=99))
    if native:
        with pytest.raises(ValueError, match="batch boundary"):
            b.load_state_dict(dict(st, cursor=3))
    for ld in (a, b, j):
        ld.close()


def test_histogram_and_summary_equal_jax(tmp_path):
    values = [0.0004, 0.7, 3.0, 3.0, 12.5, 480.0, 9000.0]
    jh, th = jtel.Histogram(), ttel.Histogram()
    for v in values:
        jh.observe(v)
        th.observe(v)
    assert th.counts == jh.counts and th.summary() == jh.summary()
    for q in (0.1, 0.5, 0.9, 0.99):
        assert th.percentile(q) == jh.percentile(q)
    jm, tm = jtel.Metrics(), ttel.Metrics()
    for m in (jm, tm):
        m.count("steps")
        m.count("steps", 2.0)
        m.gauge("depth", 3)
        for v in values:
            m.histogram("trainer.step_ms", v)
        m.times["step"] += [0.001, 0.003, 0.002]
        with m.timer("save"):
            pass
    js, ts = jm.summary(), tm.summary()
    assert set(ts) == set(js)
    assert {k: v for k, v in ts.items() if not k.startswith("save")} == \
        {k: v for k, v in js.items() if not k.startswith("save")}
    rec = tm.dump_jsonl(str(tmp_path / "m.jsonl"), steps=4)
    assert rec["steps"] == 4
    line = json.loads((tmp_path / "m.jsonl").read_text().splitlines()[0])
    assert line["step_calls"] == 3 and line["steps"] == 4


def test_flight_recorder_offset_export_equals_jax(tmp_path):
    jr, tr = jtel.FlightRecorder(capacity=4), ttel.FlightRecorder(capacity=4)
    jm, tm = jtel.Metrics(), ttel.Metrics()
    jc = tc = 0
    for i in range(11):
        jr.record(step=i)
        tr.record(step=i)
        if i in (2, 9):  # the ring drops steps 3 and 4 between flushes
            jc = jr.export_jsonl(str(tmp_path / "j.jsonl"), start=jc,
                                 metrics_obj=jm)
            tc = tr.export_jsonl(str(tmp_path / "t.jsonl"), start=tc,
                                 metrics_obj=tm)
    assert tc == jc == 10 and tr.total_recorded == 11
    assert (tmp_path / "t.jsonl").read_text() == \
        (tmp_path / "j.jsonl").read_text()
    assert tm.counters["flight.export_lost"] == \
        jm.counters["flight.export_lost"] == 3
    assert tr.export_jsonl(str(tmp_path / "t2.jsonl")) == len(tr) == 4


@pytest.mark.parametrize("knob, value, item", [
    ("kv_wire_dtype", "e4m3", "Serving fabric"),
    ("serving_mode", "decode", "Serving fabric"),
    # ported with the phase profiler: the knob constructs and round-trips
    pytest.param("profile_phases", True, None,
                 id="profile_phases-True-Host-side planes"),
])
def test_config_refuses_later_slices_knobs(knob, value, item):
    if item is None:
        cfg = TorchConfig(**{knob: value})
        assert getattr(cfg, knob) == value
        assert getattr(TorchConfig.from_json(json.loads(cfg.to_json())),
                       knob) == value
        return
    with pytest.raises(NotImplementedError, match=item):
        TorchConfig(**{knob: value})
    with pytest.raises(ValueError, match="serving_mode"):
        TorchConfig(serving_mode="both")
