"""PyTorch port: the offered-load sweeps (``serving/loadgen.py``:
``serve_load_sweep``, ``fabric_load_sweep``, ``fabric_fault_sweep``)
against the JAX package's on the CPU.

Both packages run on the same numpy weights of ``tiny_config`` and the
same requests (the port's seeded trace, handed to JAX's sweeps as its
own ``Request``s), the fabric's points in a world of 8 ranks (JAX: its 8
CPU devices; the port: a runtime of 8 virtual ranks).  JAX's sweeps run
once, in a module fixture, as do the port's.  Deterministic fields equal
JAX's exactly: record keys in order, ``metric`` identity strings, token
and step counts, handoff counts, the router's placement histograms,
speculation's acceptance and ``bit_equal_to_baseline``, the fault
drills' ledgers, the brownout's shed fraction, the virtual clock's
handoff verdicts and attribution; every engine's greedy streams equal
JAX's.  ``handoff_ms_modeled`` and ``handoff_ms_measured`` are held at
rtol 1e-9 with JAX's DCN row patched to the port's.  Wall-clock fields
and the virtual clock's decode tick (``tick_ms``, priced on each
package's own rows) are held by key and type."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # one intra-op thread a test worker

from flashmoe_tpu.fabric import engine as jfeng
from flashmoe_tpu.models import transformer as jtf
from flashmoe_tpu.parallel import topology as jtop
from flashmoe_tpu.serving import engine as jeng
from flashmoe_tpu.serving import loadgen as jload
from flashmoe_tpu.telemetry_plane import regression as jreg
from flashmoe_tpu_torch.convert import params_from_numpy
from flashmoe_tpu_torch.fabric import engine as tfeng
from flashmoe_tpu_torch.fabric.topo import ENV_MOCK_FABRIC
from flashmoe_tpu_torch.models import transformer as ttf
from flashmoe_tpu_torch.parallel import topology as ttop
from flashmoe_tpu_torch.runtime import bootstrap as tboot
from flashmoe_tpu_torch.serving import engine as teng
from flashmoe_tpu_torch.serving import loadgen as tload
from flashmoe_tpu_torch.telemetry_plane import regression as treg

from test_torch_serving import TCFG, numpy_params

#: each sweep as both packages run it: (name, function, args, kwargs)
SERVE = [
    ("plain", "serve_load_sweep", ([4, 1],), {}),
    ("spec", "serve_load_sweep", ([4, 1],), {"speculate": 2}),
    ("telemetry", "serve_load_sweep", ([2],), {"telemetry_port": 0}),
]
FABRIC = [
    ("wall_inproc", "fabric_load_sweep", ([4, 1],),
     {"replica_counts": (1, 2)}),
    ("vclock_inproc", "fabric_load_sweep", ([4, 1],),
     {"replica_counts": (1, 2), "vclock": True}),
    ("wall_tcp", "fabric_load_sweep", ([2],),
     {"replica_counts": (1, 2), "wire": "tcp"}),
    ("vclock_tcp_telemetry", "fabric_load_sweep", ([2],),
     {"replica_counts": (2,), "vclock": True, "wire": "tcp",
      "telemetry_port": 0}),
]
FAULTS = [("faults", "fabric_fault_sweep",
           (["replica_crash", "handoff_corrupt"],), {})]
SWEEPS = SERVE + FABRIC + FAULTS

#: fields read off the wall clock (or the live scrape's port), held by
#: key and type
WALL = {"value", "vs_baseline", "vs_single", "ttft_ms_p50", "ttft_ms_p99",
        "tpot_ms_p50", "tpot_ms_p99", "baseline_tpot_ms_p50",
        "baseline_tpot_ms_p99", "wall_ms", "telemetry_port",
        "telemetry_scrape"}
#: the virtual clock's decode tick, priced on each package's own rows
#: (JAX's TPU rows, the port's H100 row), held by key and type
PRICED = {"tick_ms"}
#: the handoffs' priced and virtual-clock ms, at rtol 1e-9
RTOL_KEYS = {"handoff_ms_modeled", "handoff_ms_measured"}


class _Recorder:
    """Record every engine and fabric a sweep builds, in order."""

    def __init__(self, mp, *mods):
        self.made = []
        for mod, name in mods:
            base = getattr(mod, name)
            made = self.made

            class Rec(base):
                def __init__(self, *a, **kw):
                    super().__init__(*a, **kw)
                    made.append(self)

            mp.setattr(mod, name, Rec)


def _streams(obj) -> dict:
    """{rid: tokens} of an engine, or of a fabric's replicas."""
    out = {}
    for e in getattr(obj, "engines", [obj]):
        out.update({int(r): [int(t) for t in toks]
                    for r, toks in e.outputs.items()})
    return out


def _to_jax(reqs):
    return [jeng.Request(**dataclasses.asdict(r)) for r in reqs]


@pytest.fixture(scope="module")
def tree():
    return numpy_params()


@pytest.fixture(scope="module")
def jax_runs(tree):
    """JAX's sweeps on the numpy weights and the port's requests."""
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)

    def build(n, **kw):
        reqs, arrivals = tload.build_requests(n, **kw)
        return _to_jax(reqs), arrivals

    def split(n, **kw):
        return [(_to_jax(r), a) for r, a in tload.split_requests(n, **kw)]

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtf, "init_params", lambda key, cfg: jtree)
        mp.setattr(jload, "build_requests", build)
        mp.setattr(jload, "split_requests", split)
        mp.setattr(jtop, "_DCN_SPEC", ttop._DCN_SPEC)
        mp.delenv(ENV_MOCK_FABRIC, raising=False)
        for name, fn, args, kw in SWEEPS:
            rec = _Recorder(mp, (jeng, "ServingEngine"),
                            (jfeng, "ServingFabric"))
            records = getattr(jload, fn)(*args, **kw)
            out[name] = (records, [_streams(o) for o in rec.made])
    return out


@pytest.fixture(scope="module")
def port_runs(tree):
    """The port's sweeps on the same weights, in a world of 8 virtual
    CPU ranks."""
    params = params_from_numpy(tree, device="cpu")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttf, "init_params", lambda gen, cfg, device=None: params)
        mp.delenv(ENV_MOCK_FABRIC, raising=False)
        tboot.finalize()
        tboot.initialize(TCFG, devices=8, device="cpu")
        try:
            for name, fn, args, kw in SWEEPS:
                rec = _Recorder(mp, (teng, "ServingEngine"),
                                (tfeng, "ServingFabric"))
                records = getattr(tload, fn)(*args, device="cpu", **kw)
                out[name] = (records, [_streams(o) for o in rec.made])
        finally:
            tboot.finalize()
    return out


def _kind(v):
    return "number" if isinstance(v, (int, float)) \
        and not isinstance(v, bool) else type(v).__name__


def assert_records(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w), g["metric"]
        for key in g:
            a, b = g[key], w[key]
            exact = key not in WALL | PRICED or (
                key == "value" and g["unit"] == "frac")
            if key in RTOL_KEYS:
                np.testing.assert_allclose(a, b, rtol=1e-9, err_msg=key)
            elif exact:
                assert a == b, (g["metric"], key, a, b)
            else:
                assert _kind(a) == _kind(b), (g["metric"], key, a, b)


@pytest.mark.parametrize("name", [s[0] for s in SWEEPS])
def test_sweep_records_equal_jax(jax_runs, port_runs, name):
    assert_records(port_runs[name][0], jax_runs[name][0])


@pytest.mark.parametrize("name", [s[0] for s in SERVE + FABRIC])
def test_sweep_greedy_streams_equal_jax(jax_runs, port_runs, name):
    """Every engine (and fabric) a sweep builds, in order: the port's
    greedy streams equal JAX's, token for token."""
    got, want = port_runs[name][1], jax_runs[name][1]
    assert len(got) == len(want) and got
    for g, w in zip(got, want):
        assert g == w


def test_sweep_identities_and_guarantees(port_runs):
    """The identity tags of the armed runs, speculation's exactness, the
    live scrape's quantiles, the fault drills' recovery and the
    brownout's shed fraction, on the port's records alone."""
    spec = port_runs["spec"][0]
    assert all(r["metric"].endswith(",spec=k2]")
               and r["bit_equal_to_baseline"] for r in spec)
    tel = port_runs["telemetry"][0][0]
    assert tel["metric"] == "serve_load[every=2,B=4,req=8,telemetry]"
    assert tel["telemetry_scrape"]["ok"]
    assert tel["telemetry_scrape"]["has_ttft_quantiles"]
    vt = port_runs["vclock_tcp_telemetry"][0][0]
    assert vt["metric"] == \
        "fabric_load[replicas=2,every=2,req=8,telemetry,vclock,wire=tcp]"
    assert vt["wire_transfers"] == vt["handoffs"] > 0
    assert vt["pools_formed"] and vt["trace_errors"] == 0
    faults = port_runs["faults"][0]
    assert [r["metric"] for r in faults] == [
        "fabric_fault[replica_crash]", "fabric_fault[handoff_corrupt]",
        "fabric_shed[brownout]"]
    assert all(r["recovered"] and "error" not in r for r in faults[:2])
    shed = faults[-1]
    assert shed["unit"] == "frac" and shed["value"] == \
        round(shed["shed"] / shed["offered"], 4) and shed["shed"] > 0


def test_sweep_points_key_the_sentry_as_jax(jax_runs, port_runs):
    """The records' points for the regression sentry carry JAX's keys
    and units."""
    for name, *_ in SWEEPS:
        got = treg.collect_points(port_runs[name][0])
        want = jreg.collect_points(jax_runs[name][0])
        assert sorted(got) == sorted(want)
        assert {k: v["unit"] for k, v in got.items()} == \
            {k: v["unit"] for k, v in want.items()}


@pytest.mark.parametrize("fn, kw, match", [
    ("serve_load_sweep", {"loads": [0]}, "offered-load gap"),
    ("fabric_load_sweep", {"loads": [2], "wire": "udp"}, "wire"),
    ("fabric_load_sweep", {"loads": [2], "replica_counts": (0,)},
     "replica count"),
    ("fabric_fault_sweep", {"faults": ["nan_grad"]}, "not serving faults"),
])
def test_sweep_refusals_equal_jax(fn, kw, match):
    """Both refuse the same arguments, with the same message."""
    with pytest.raises(ValueError, match=match) as want:
        getattr(jload, fn)(**kw)
    with pytest.raises(ValueError, match=match) as got:
        getattr(tload, fn)(device="cpu", **kw)
    assert str(got.value) == str(want.value)
