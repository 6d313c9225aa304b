"""PyTorch port: the perf-regression sentry
(``flashmoe_tpu_torch/telemetry_plane/regression.py``) against the JAX
package's on the CPU.

The same record piles and histories go through both: the collected
points, the history files written and read back, the reports (every
unit's direction, the zero baseline, the rolling window, the decisions
emitted) and their text equal JAX's exactly.  ``reference_points`` is
priced on the port's planner (``"h100"``): it is deterministic, keyed as
JAX's with the generation swapped, and a history seeded twice from it
checks clean."""

import json

import pytest
import torch
torch.set_num_threads(1)  # one intra-op thread a test worker

from flashmoe_tpu.telemetry_plane import regression as jreg
from flashmoe_tpu.utils.telemetry import Metrics as JaxMetrics
from flashmoe_tpu_torch.telemetry_plane import regression as treg
from flashmoe_tpu_torch.utils.telemetry import Metrics

#: a record pile with every kind of record the sentry reads or skips
PILE = [
    {"metric": "serve_load[every=1,B=4,req=8]", "value": 120.5,
     "unit": "tokens_per_sec", "ttft_ms_p50": 3.5, "ttft_ms_p99": 9.25,
     "tpot_ms_p50": 1.5},
    {"metric": "fabric_fault[replica_crash]", "value": 40, "unit": "ms"},
    {"metric": "fabric_shed[brownout]", "value": 0.3, "unit": "frac"},
    {"metric": "planner[x]", "value": 2.0, "unit": "ms",
     "predicted_ms": 1.75},
    {"metric": "skipped[x]", "value": 1.0, "unit": "ms", "skipped": True},
    {"metric": "partial[x]", "value": 1.0, "unit": "ms", "partial": True},
    {"metric": "error[x]", "value": 1.0, "unit": "ms", "error": "boom"},
    {"metric": "bool[x]", "value": True, "unit": "ms"},
    {"metric": "str[x]", "value": "1.0", "unit": "ms"},
    {"metric": 7, "value": 1.0},
    {"metric": "no_unit[x]", "value": 5},
    "not a record",
]


def test_collect_points_equal_jax():
    got = treg.collect_points(PILE)
    assert got == jreg.collect_points(PILE)
    assert "skipped[x]" not in got and "bool[x]" not in got
    assert got["serve_load[every=1,B=4,req=8].ttft_ms_p99"] == \
        {"value": 9.25, "unit": "ms"}


def test_constants_equal_jax():
    assert treg.UNIT_TOLERANCE == jreg.UNIT_TOLERANCE
    assert treg._DIR == jreg._DIR
    assert treg.DEFAULT_TOLERANCE == jreg.DEFAULT_TOLERANCE
    # the port's own history: the JAX package's holds TPU rows
    assert treg.DEFAULT_HISTORY == "obs/history_torch.jsonl"
    assert treg.DEFAULT_HISTORY != jreg.DEFAULT_HISTORY
    for unit in list(treg.UNIT_TOLERANCE) + ["unknown"]:
        for over in (None, {unit: 0.5}, {"other": 0.5}):
            assert treg._tolerance(unit, over) == \
                jreg._tolerance(unit, over)


def test_append_and_load_history_equal_jax(tmp_path):
    """Both write the same lines and read each other's files alike,
    comments, blanks and broken lines skipped; an empty run writes
    nothing."""
    pts = treg.collect_points(PILE)
    tp, jp = tmp_path / "t" / "h.jsonl", tmp_path / "j" / "h.jsonl"
    meta = {"device": "cpu"}
    assert treg.append_run(str(tp), pts, run="r1", meta=meta) == \
        jreg.append_run(str(jp), pts, run="r1", meta=meta)
    assert treg.append_run(str(tp), {}, run="r2") == {} == \
        jreg.append_run(str(jp), {}, run="r2")
    assert tp.read_text() == jp.read_text()
    with open(tp, "a") as f:
        f.write("\n# a comment\nnot json\n[1, 2]\n"
                + json.dumps({"run": "x", "metrics": 3}) + "\n")
    assert treg.load_history(str(tp)) == jreg.load_history(str(tp))
    assert len(treg.load_history(str(tp))) == 1
    assert treg.load_history(str(tmp_path / "none")) == [] == \
        jreg.load_history(str(tmp_path / "none"))
    # a run without a name is stamped with the time
    assert isinstance(treg.append_run(str(tp), pts)["run"], str)


def _runs(*values, unit="ms", key="m[x]", extra=None):
    runs = []
    for i, v in enumerate(values):
        metrics = {key: {"value": v, "unit": unit}}
        if extra and i == len(values) - 1:
            metrics.update(extra)
        runs.append({"run": f"r{i}", "meta": {}, "metrics": metrics})
    return runs


CASES = {
    "one_run": _runs(1.0),
    "flat": _runs(1.0, 1.0, 1.0),
    "ms_up": _runs(1.0, 1.0, 1.2),
    "ms_regressed": _runs(1.0, 1.0, 1.3),
    "ms_improved": _runs(1.0, 1.0, 0.7),
    "tps_down": _runs(100.0, 100.0, 80.0, unit="tokens_per_sec"),
    "tps_up": _runs(100.0, 100.0, 130.0, unit="tokens_per_sec"),
    "frac_up": _runs(0.2, 0.2, 0.3, unit="frac"),
    "hidden_down": _runs(1.0, 1.0, 0.5, unit="hidden_frac"),
    "accept_up": _runs(0.2, 0.2, 0.4, unit="accept_rate"),
    "unknown_unit": _runs(1.0, 1.0, 1.3, unit="widgets"),
    "zero_to_zero": _runs(0.0, 0.0, 0.0),
    "zero_to_up_ms": _runs(0.0, 0.0, 1.0),
    "zero_to_up_tps": _runs(0.0, 0.0, 5.0, unit="tokens_per_sec"),
    "even_window": _runs(1.0, 3.0, 2.0, 4.0, 3.6),
    "window_cut": _runs(100.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.4),
    "new_metrics": _runs(1.0, 1.0, extra={f"n{i}[x]": {"value": 1.0,
                                                       "unit": "ms"}
                                          for i in range(10)}),
}


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("baseline_n", [5, 2])
def test_check_regression_and_render_equal_jax(name, baseline_n):
    """The report, its text and the decisions emitted, for each unit's
    direction, a zero baseline, an even window, the window's cut and a
    run without history."""
    runs = CASES[name]
    tm, jm = Metrics(), JaxMetrics()
    got = treg.check_regression(runs, baseline_n=baseline_n,
                                metrics_obj=tm)
    want = jreg.check_regression(runs, baseline_n=baseline_n,
                                 metrics_obj=jm)
    assert got == want
    assert treg.render_text(got) == jreg.render_text(want)
    strip = [{k: v for k, v in d.items() if k not in ("t", "ts", "time")}
             for d in tm.decisions]
    assert strip == [{k: v for k, v in d.items()
                      if k not in ("t", "ts", "time")} for d in jm.decisions]
    assert len(tm.decisions) == len(got["regressions"])
    json.dumps(got)  # the --json report stays valid JSON


def test_tolerance_overrides_equal_jax():
    runs = CASES["ms_up"]
    over = {"ms": 0.1}
    assert treg.check_regression(runs, tolerances=over,
                                 metrics_obj=Metrics()) == \
        jreg.check_regression(runs, tolerances=over,
                              metrics_obj=JaxMetrics())


def test_reference_points_keyed_as_jax_and_check_clean(tmp_path):
    got = treg.reference_points("h100")
    assert got == treg.reference_points("h100")
    want = jreg.reference_points("v5e")
    assert sorted(got) == sorted(k.replace("v5e", "h100") for k in want)
    assert {k: v["unit"] for k, v in got.items()} == \
        {k.replace("v5e", "h100"): v["unit"] for k, v in want.items()}
    assert all(isinstance(v["value"], float) and v["value"] >= 0
               for v in got.values())
    assert treg.reference_points() == got
    assert got["fabric_shed_frac[brownout,reference]"] == \
        want["fabric_shed_frac[brownout,reference]"]
    hist = str(tmp_path / "history_torch.jsonl")
    for run in ("seed-1", "seed-2"):
        treg.append_run(hist, got, run=run)
    rep = treg.check_regression(treg.load_history(hist),
                                metrics_obj=Metrics())
    assert rep["compared"] == len(got) and not rep["regressions"] \
        and not rep["improvements"]
    assert treg.render_text(rep).endswith("all within tolerance")


@pytest.mark.parametrize("knobs", [
    {}, {"queue_high": 3.0, "queue_low": 0.5}, {"debounce_steps": 2},
    {"cooldown_steps": 0, "episode_budget": 1}, {"queue_low": 3.5},
])
def test_reference_shed_frac_equal_jax(knobs):
    from flashmoe_tpu.runtime.controller import BrownoutConfig as JBo
    from flashmoe_tpu_torch.runtime.controller import BrownoutConfig as TBo

    assert treg._reference_shed_frac(TBo(**knobs)) == \
        jreg._reference_shed_frac(JBo(**knobs))
