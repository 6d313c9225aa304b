"""Predicted-against-measured cost ledger: the measured phase timeline
joined against the analytical planner, phase by phase.

Counterpart of ``flashmoe_tpu/profiler/ledger.py``.  The drift monitor
(:mod:`flashmoe_tpu_torch.planner.drift`) compares a whole layer with its
prediction; this module prices each phase the profiler measures (gate,
dispatch exchange, expert FFN, combine exchange; the fused kernel's one
span) with the planner's own primitives, and records one
``planner.phase_drift`` decision per phase through
:func:`~flashmoe_tpu_torch.planner.drift.record_phase_drift`.  An
exchange leg drifting alone points at the transport model, the expert
phase alone at the roofline.

It also checks the chunked-overlap story: the fenced timeline's phase sum
over the same call's unfenced time is a measured overlap fraction,
judged against ``overlap.chunked_overlap_bound`` through
``planner.overlap_drift``.  The port runs eagerly, so its unfenced call
is the layer as it runs (JAX times a jitted, overlap-scheduled graph).

:func:`run_ledger_matrix` drives the matrix (flat / hierarchical /
ragged x {serial, chunked} x {wire off, e4m3}) over ``local_mesh(d)``.
"""

from __future__ import annotations

import os
import time

from flashmoe_tpu_torch.config import MoEConfig
from flashmoe_tpu_torch.profiler.spans import PhaseTimeline

#: the ledger's join keys: the four phases of the reference kernel's
#: thesis, and the fused kernel's one span, which holds all of its
#: exchange and FFN work (the scatter / gather phases ``moe.dispatch`` /
#: ``moe.combine`` are measured too, and priced inside no term)
PHASES = ("moe.gate", "moe.a2a_dispatch", "moe.expert",
          "moe.a2a_combine", "moe.fused_kernel")


def predicted_phase_ms(cfg: MoEConfig, d: int = 1, gen: str = "local", *,
                       path: str = "collective", slices: int = 1,
                       links: int | None = None,
                       mxu_fraction: float = 1.0) -> dict[str, float]:
    """Per-phase predicted latency (ms) at (cfg, d ranks, ``gen``'s spec
    row): the planner's cost decomposition cut at the profiler's phase
    boundaries, from the same primitives (the row's peaks at one rank's
    share, ``planner.model.slab_bytes``, ``analysis.wire_row_bytes`` and
    the per-leg formula ``planner.model.a2a_leg_ms``), as
    ``flashmoe_tpu/profiler/ledger.py:49`` prices them.  ``gen``:
    ``"local"`` for a local mesh (the default), the card's row otherwise.
    ``links``: by default the row's count.  ``path="fused"`` also prices
    ``moe.fused_kernel``: the expert FFN and both legs at the kernel's
    32-padded raw slab, in series."""
    from flashmoe_tpu_torch.analysis import wire_row_bytes
    from flashmoe_tpu_torch.planner.model import (_dtype_peak, a2a_leg_ms,
                                                  slab_bytes)

    d = max(d, 1)
    peak_fs, hbm_bs = _dtype_peak(gen, cfg, d)
    peak_fs *= max(min(mxu_fraction, 1.0), 1e-6)
    s_loc = max(cfg.tokens // d, 1)
    h, i_dim, e = cfg.hidden_size, cfg.intermediate_size, cfg.num_experts
    dt = cfg.dtype.itemsize
    n = cfg.a2a_chunks or 1

    # gate: router logits GEMM on local tokens (+ x and gate_w reads)
    gate_fl = 2.0 * s_loc * h * e
    gate_by = s_loc * h * dt + h * e * 4
    out = {"moe.gate": max(gate_fl / peak_fs, gate_by / hbm_bs) * 1e3}

    # expert FFN: routed rows this rank computes under uniform routing
    rows = s_loc * cfg.expert_top_k
    gemms = 3 if cfg.gated_ffn else 2
    ffn_fl = gemms * 2.0 * rows * h * i_dim
    nlx = max(e // d, 1)
    w_by = gemms * nlx * h * i_dim * dt        # local weights, once
    act_by = (2 * h + i_dim) * rows * dt       # rows in/out + hidden
    out["moe.expert"] = max(ffn_fl / peak_fs,
                            (w_by + act_by) / hbm_bs) * 1e3

    if d > 1:
        def leg(which: str) -> float:
            # the DCN wire applies only where the layer runs the
            # two-stage exchange; the ragged transport is flat-only
            hop = ("dcn" if path != "ragged"
                   and d // max(slices, 1) > 1 else "ici")
            if path == "ragged":
                slab = rows / d * wire_row_bytes(cfg, which)
                dcn_slab = rows / d * wire_row_bytes(cfg, which, hop)
            elif path == "fused":
                slab = dcn_slab = slab_bytes(cfg, d, padded=True)
            else:
                slab = slab_bytes(cfg, d, leg=which)
                dcn_slab = slab_bytes(cfg, d, leg=which, hop=hop)
            ici, dcn = a2a_leg_ms(slab, "hierarchical", d=d, gen=gen,
                                  slices=slices, links=links, chunks=n,
                                  dcn_slab=dcn_slab)
            return ici + dcn

        out["moe.a2a_dispatch"] = leg("dispatch")
        out["moe.a2a_combine"] = leg("combine")
    if path == "fused":
        out["moe.fused_kernel"] = (out["moe.expert"]
                                   + out.get("moe.a2a_dispatch", 0.0)
                                   + out.get("moe.a2a_combine", 0.0))
    return out


def profile_moe_phases(cfg: MoEConfig, mesh, *, path: str = "collective",
                       steps: int = 1, dcn_inner: int | None = None,
                       seed: int = 0, overlapped: bool = True,
                       recorder=None, label: str = "", params=None,
                       x=None, use_kernels: bool | None = None
                       ) -> PhaseTimeline:
    """Measure the phase timeline of one MoE layer point
    (``flashmoe_tpu/profiler/ledger.py:116``).

    Runs the layer (``path``: 'collective', 'ragged' or 'fused') with
    ``profile_phases=True`` and a timeline armed, ``steps`` times: the
    fences make every span's duration device-complete wall time.  Stats
    collection is forced on so the imbalance counter track has data.
    ``params`` / ``x``: the layer's weights and tokens (random from
    ``seed`` on the mesh's device when None).

    ``overlapped=True`` also times the same call with no timeline armed
    (its fences are then no-ops: the port runs eagerly, so this is the
    layer as it runs unprofiled), the median of 3 on the host clock after
    the device has finished, stored on ``timeline.overlapped_ms``.
    ``recorder``: a FlightRecorder to land per-step phase records in."""
    import torch

    from flashmoe_tpu_torch.models.reference import init_moe_params
    from flashmoe_tpu_torch.profiler import spans
    from flashmoe_tpu_torch.tree import tree_map

    pcfg = cfg.replace(profile_phases=True, collect_stats=True)
    device = mesh.device or "cpu"
    if params is None:
        g = torch.Generator(device).manual_seed(seed)
        params = tree_map(lambda p: p.to(pcfg.dtype),
                          init_moe_params(g, pcfg, device=device))
    if x is None:
        g = torch.Generator(device).manual_seed(seed + 1)
        x = torch.randn((pcfg.tokens, pcfg.hidden_size), generator=g,
                        device=device, dtype=pcfg.dtype)

    if path == "ragged":
        from flashmoe_tpu_torch.parallel.ragged_ep import (
            ragged_ep_moe_layer)

        def run(c):
            return ragged_ep_moe_layer(params, x, c, mesh,
                                       use_kernels=use_kernels)
    elif path == "fused":
        from flashmoe_tpu_torch.parallel.fused import fused_ep_moe_layer

        def run(c):
            return fused_ep_moe_layer(params, x, c, mesh,
                                      use_kernels=use_kernels)
    else:
        from flashmoe_tpu_torch.parallel.ep import ep_moe_layer

        def run(c):
            return ep_moe_layer(params, x, c, mesh,
                                dcn_inner=(dcn_inner or 0),
                                use_kernels=use_kernels)

    def sync():
        if x.is_cuda:
            torch.cuda.synchronize(x.device)

    tl = PhaseTimeline(label=label or f"{path} d={mesh.ep}")
    tl.meta = {
        "path": path, "d": int(mesh.ep),
        "chunks": cfg.a2a_chunks or 1, "dcn_inner": dcn_inner,
        "wire": cfg.wire_dtype or "off",
        "wire_combine": cfg.wire_dtype_combine or "off",
    }
    with torch.no_grad():
        with spans.profiling(tl):
            for i in range(max(steps, 1)):
                sync()
                tl.begin_step(i)
                out = run(pcfg)
                sync()
                tl.end_step()
                if out.stats is not None:
                    tl.counter("moe.load_imbalance",
                               float(out.stats.imbalance), step=i)
                if recorder is not None:
                    recorder.record(**tl.step_records()[-1], **tl.meta)
                    tl.counter("flight.queue_depth", len(recorder), step=i)
        if overlapped:
            times = []
            for _ in range(3):
                sync()
                t0 = time.perf_counter()
                run(pcfg)
                sync()
                times.append(time.perf_counter() - t0)
            tl.overlapped_ms = sorted(times)[len(times) // 2] * 1e3
    return tl


def phase_ledger(tl: PhaseTimeline, cfg: MoEConfig, *, d: int, gen: str,
                 path: str, slices: int = 1, links: int | None = None,
                 mxu_fraction: float = 1.0, warn: bool = False
                 ) -> tuple[list[dict], dict | None]:
    """Join a measured timeline against the per-phase predictions.

    Returns ``(rows, overlap)``: one row per joined phase (each also
    recorded as a ``planner.phase_drift`` decision), and — when the
    timeline carries an unfenced step time at d > 1 on an exchange
    path, the measured-vs-bound overlap fraction, recorded through the
    ``planner.overlap_drift`` monitor."""
    from flashmoe_tpu_torch.ops import wire as wr
    from flashmoe_tpu_torch.planner.drift import (record_overlap_drift,
                                                  record_phase_drift)

    measured = tl.phase_means()
    pred = predicted_phase_ms(cfg, d, gen, path=path, slices=slices,
                              links=links, mxu_fraction=mxu_fraction)
    rows = []
    for ph in PHASES:
        if ph not in measured or ph not in pred:
            continue
        rec = record_phase_drift(cfg, path, ph, measured[ph],
                                 predicted_ms=pred[ph], d=d, gen=gen,
                                 warn=warn)
        rows.append({
            "phase": ph, "path": path, "gen": gen, "d": int(d),
            "chunks": rec.chunks, "wire": rec.wire,
            "measured_ms": round(measured[ph], 6),
            "predicted_ms": round(pred[ph], 6),
            "rel_error": round(rec.rel_error, 4),
            "exceeded": rec.exceeded,
        })

    overlap = None
    if tl.overlapped_ms and d > 1 and path != "fused":
        from flashmoe_tpu_torch.parallel.overlap import (
            chunked_overlap_bound)

        n = cfg.a2a_chunks or 1
        serial_ms = sum(measured.values())  # fenced = fully serialized
        frac = serial_ms / tl.overlapped_ms
        bound = chunked_overlap_bound(
            cfg, d, gen, n, links=links, mxu_fraction=mxu_fraction,
            path="ragged" if path == "ragged" else "collective",
        )["overlap_efficiency_bound"]
        odr = record_overlap_drift(path, frac,
                                   predicted_fraction=bound, gen=gen,
                                   d=d, chunks=n, warn=warn)
        overlap = {
            "path": path, "gen": gen, "d": int(d), "chunks": n,
            "wire": (f"{wr.canonical_name(cfg.wire_dtype)}/"
                     f"{wr.canonical_name(cfg.wire_dtype_combine)}"),
            "serial_phase_sum_ms": round(serial_ms, 6),
            "overlapped_ms": round(tl.overlapped_ms, 6),
            "measured_fraction": round(frac, 4),
            "predicted_fraction": round(bound, 4),
            "exceeded": odr.exceeded,
        }
    return rows, overlap


# ----------------------------------------------------------------------
# The acceptance matrix (bench.py --profile / tests)
# ----------------------------------------------------------------------

#: (name, ep width, dcn_inner, profiler path, planner slices)
MATRIX_PATHS = (
    ("flat", 2, None, "collective", 1),
    ("hierarchical", 4, 2, "collective", 2),
    ("ragged", 2, None, "ragged", 1),
)
MATRIX_CHUNKS = (None, 2)
MATRIX_WIRES = (None, "e4m3")


def ledger_config(ep: int) -> MoEConfig:
    """The matrix's measurement point (``ledger.py:304``): E 8, top-2, H
    64, I 128, 64 tokens a rank, dropless, f32."""
    import torch

    return MoEConfig(num_experts=8, expert_top_k=2, hidden_size=64,
                     intermediate_size=128, sequence_len=64 * ep,
                     drop_tokens=False, ep=ep, dtype=torch.float32,
                     param_dtype=torch.float32)


def run_ledger_matrix(obs_dir: str | None = None, *, quick: bool = False,
                      steps: int = 1, gen: str | None = None,
                      device=None, overlapped: bool = True,
                      warn: bool = False) -> list[dict]:
    """Profile and ledger every matrix point over ``local_mesh(d)`` on
    ``device`` (the CPU by default); write the artifacts
    (``ledger.py:316``).

    ``quick`` restricts to the first point (flat x serial x wire off).
    Artifacts into ``obs_dir``: ``ledger.jsonl`` (one line per joined
    phase and one ``overlap`` line per point), ``trace.json`` (every
    point, one Perfetto process each) and ``flight.jsonl``.  ``gen``:
    the spec row, by default ``FLASHMOE_TPU_GEN`` or ``"local"``.
    Returns the per-point summary records."""
    import json

    from flashmoe_tpu_torch.ops import wire as wr
    from flashmoe_tpu_torch.parallel.mesh import local_mesh
    from flashmoe_tpu_torch.profiler.export import write_trace
    from flashmoe_tpu_torch.utils.telemetry import FlightRecorder

    gen = gen or os.environ.get("FLASHMOE_TPU_GEN") or "local"
    records: list[dict] = []
    timelines: list[PhaseTimeline] = []
    labels: list[str] = []
    ledger_rows: list[dict] = []
    recorder = FlightRecorder()

    for pname, ep, dcn_inner, ppath, slices in MATRIX_PATHS:
        base = ledger_config(ep)
        mesh = local_mesh(ep, device=device)
        for chunks in MATRIX_CHUNKS:
            for wire in MATRIX_WIRES:
                cfg = base.replace(a2a_chunks=chunks, wire_dtype=wire)
                label = (f"{pname} chunks={chunks or 1} "
                         f"wire={wr.canonical_name(wire)}")
                tl = profile_moe_phases(
                    cfg, mesh, path=ppath, steps=steps,
                    dcn_inner=dcn_inner, overlapped=overlapped,
                    recorder=recorder, label=label)
                rows, overlap = phase_ledger(
                    tl, cfg, d=ep, gen=gen,
                    path=pname if pname == "hierarchical" else ppath,
                    slices=slices, warn=warn)
                # rows carry BOTH names: "path" is the planner's path
                # (the planner.phase_drift join key; "collective" IS
                # the flat transport) and "point" is the matrix point
                # the docs/bench records speak (flat/hierarchical/
                # ragged), so either vocabulary filters ledger.jsonl
                rows = [dict(r, point=pname) for r in rows]
                ledger_rows.extend(rows)
                if overlap is not None:
                    ledger_rows.append(dict(overlap, record="overlap",
                                            point=pname))
                timelines.append(tl)
                labels.append(label)
                records.append({
                    "metric": f"phase_ledger[{pname},"
                              f"chunks={chunks or 1},"
                              f"wire={wr.canonical_name(wire)}]",
                    "value": round(sum(r["measured_ms"]
                                       for r in rows), 3),
                    "unit": "ms", "path": pname, "gen": gen, "d": ep,
                    "a2a_chunks": chunks or 1,
                    "wire_dtype": wr.canonical_name(wire),
                    "step_ms": round(tl.step_wall_means() or 0.0, 3),
                    "overlapped_ms": (round(tl.overlapped_ms, 3)
                                      if tl.overlapped_ms else None),
                    "phases": {r["phase"]: r["measured_ms"]
                               for r in rows},
                    "phase_drift": {r["phase"]: r["rel_error"]
                                    for r in rows},
                    "overlap": overlap,
                })
                if quick:
                    break
            if quick:
                break
        if quick:
            break

    if obs_dir:
        os.makedirs(obs_dir, exist_ok=True)
        with open(os.path.join(obs_dir, "ledger.jsonl"), "w") as f:
            for row in ledger_rows:
                f.write(json.dumps(row) + "\n")
        write_trace(timelines, os.path.join(obs_dir, "trace.json"),
                    labels=labels)
        recorder.export_jsonl(os.path.join(obs_dir, "flight.jsonl"))
    return records
