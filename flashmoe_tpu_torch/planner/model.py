"""Predicted latency per execution path: the roofline synthesis.

Counterpart of ``flashmoe_tpu/planner/model.py``: the byte model
(:mod:`flashmoe_tpu_torch.analysis`), the spec rows
(:mod:`flashmoe_tpu_torch.parallel.topology`) and the overlap shapes
combine into one predicted time a path, decomposed into the terms that
produce it.  Per rank, one MoE-layer forward, ``d`` ranks, uniform
routing:

  compute_ms   ``PathCost.flops`` at the row's peak for ``cfg.dtype``
               times ``mxu_fraction`` (bf16: the tensor-core peak; f32:
               the row's own f32 rate, 67 against 989 TFLOP/s on an
               H100, where JAX halves its bf16 peak).
  hbm_ms       ``PathCost.total_bytes`` at the row's HBM rate.
  chip_ms      max(compute_ms, hbm_ms).
  ici_ms       both exchange legs over the row's links, alpha included,
               each leg at its wire row size.
  dcn_ms       the cross-node share when the ep axis spans nodes.
  serial_ms    chip_ms + ici_ms + dcn_ms (+ the dp ring when priced).
  total_ms     serial for the exchange layers (the chunked-pipeline
               makespan with ``a2a_chunks``); the fused kernel's arrival
               overlap for the fused rows (JAX's shapes; ``batched``
               and ``rowwin``, one processing order in the port, both
               with the per-row-tile return tail).

On the ``"local"`` row each rank holds a 1/d share of the card's rates
(:func:`flashmoe_tpu_torch.parallel.topology.rank_share`), so a rank's
predicted time is the layer's time on the card.  ``links`` defaults to
the row's link count.  Rows the configuration cannot run are kept,
marked infeasible with the reason.
"""

from __future__ import annotations

import dataclasses

from flashmoe_tpu_torch.analysis import (
    PathCost, a2a_transport_cost, chunked_pipeline_ms, path_costs,
)
from flashmoe_tpu_torch.config import MoEConfig

# planner path name -> the moe_backend string that runs it
BACKEND_OF = {
    "collective": "collective",
    # the collective layer: on a bootstrapped multi-slice world it runs
    # the two-stage exchange at the runtime's blocking (current_dcn_inner)
    "hierarchical": "collective",
    "ragged": "ragged",
    "fused[batched]": "fused",
    "fused[resident]": "fused",
    "fused[stream]": "fused",
    "fused[rowwin]": "fused",
    "fused_combine": "fused",
    # single-rank paths (d == 1): ops/moe.py, not an ep backend
    "xla": "local",
    "explicit": "local",
    "gather": "local",
}


@dataclasses.dataclass(frozen=True)
class PathPrediction:
    """One explain-table row: the predicted latency decomposition of a
    single candidate path."""

    path: str
    backend: str
    schedule: str | None
    compute_ms: float
    hbm_ms: float
    ici_ms: float
    dcn_ms: float
    serial_ms: float
    total_ms: float
    feasible: bool
    note: str
    cost: PathCost
    wire: str = "off/off"
    a2a_chunks: int = 1
    dp_allreduce_ms: float = 0.0
    quant: str = "off"

    @property
    def family(self) -> str:
        """Path name without the schedule ('fused[batched]' -> 'fused')."""
        return self.path.split("[")[0]


def _dtype_peak(gen: str, cfg: MoEConfig, d: int = 1) -> tuple[float, float]:
    """(peak FLOP/s at cfg.dtype, HBM B/s) of one of ``d`` ranks on the
    row: the row's f32 rate for a 4-byte dtype, not half its bf16 rate.
    ``ValueError`` on an unknown row."""
    from flashmoe_tpu_torch.parallel.topology import (
        chip_spec, f32_tflops, rank_share)

    peak_tf, hbm_gb = chip_spec(gen)
    if cfg.dtype.itemsize >= 4:
        peak_tf = f32_tflops(gen)
    share = rank_share(gen, d)
    return peak_tf * 1e12 * share, hbm_gb * 1e9 * share


def _ici_link(gen: str, d: int = 1) -> tuple[float, float]:
    """(alpha_ms, one-way B/ms a link) for one of ``d`` ranks."""
    from flashmoe_tpu_torch.parallel.topology import _ICI_SPECS, rank_share

    lat_us, gbps = _ICI_SPECS[gen]
    return lat_us / 1e3, gbps * 1e6 * rank_share(gen, d)


def _links(gen: str, links: int | None) -> int:
    from flashmoe_tpu_torch.parallel.topology import link_count

    return link_count(gen) if links is None else links


def a2a_leg_ms(slab: float, kind: str, *, d: int, gen: str,
               slices: int = 1, links: int | None = None,
               chunks: int = 1,
               dcn_slab: float | None = None) -> tuple[float, float]:
    """(ici_ms, dcn_ms) of one exchange leg moving a ``slab`` of bytes to
    each peer, message alphas times ``chunks``; across ``slices`` > 1
    the ``kind`` row of :func:`~flashmoe_tpu_torch.analysis.
    a2a_transport_cost`."""
    links = _links(gen, links)
    a_ici, bw_link = _ici_link(gen, d)
    if slices > 1:
        t = a2a_transport_cost(d, d // slices, slab, gen=gen,
                               links=links, chunks=chunks,
                               dcn_slab_bytes=dcn_slab)[kind]
        return t["ici_ms"], t["dcn_ms"]
    return (d - 1) * (chunks * a_ici + slab / (bw_link * links)), 0.0


def slab_bytes(cfg: MoEConfig, d: int, *, padded: bool = False,
               leg: str = "dispatch", hop: str = "ici") -> float:
    """One (dest-rank) capacity slab at ``leg``'s wire row size (``hop``
    'dcn': the cross-node wire); ``padded``: the fused kernel's slab,
    raw rows at the 32-padded capacity."""
    from flashmoe_tpu_torch.analysis import wire_row_bytes
    from flashmoe_tpu_torch.parallel.ep import local_capacity

    s_loc = cfg.tokens // d
    cap = local_capacity(cfg, s_loc)
    nlx = cfg.num_experts // d
    if padded:
        cap = -(-cap // 32) * 32
        return nlx * cap * cfg.hidden_size * cfg.dtype.itemsize
    return nlx * cap * wire_row_bytes(cfg, leg, hop)


def ring_allreduce_ms(grad_mb: float, group_sizes, bottleneck_beta: float,
                      bottleneck_alpha: float = 0.0) -> float:
    """The ring all-reduce's time, ``2 (G-1)`` chunks of ``grad / G``
    over the bottleneck edge (the port's copy of
    ``flashmoe_tpu/parallel/decider.py:58``)."""
    g = len(group_sizes) if hasattr(group_sizes, "__len__") else group_sizes
    if g <= 1:
        return 0.0
    return 2.0 * (g - 1) * (bottleneck_alpha
                            + (grad_mb / g) * bottleneck_beta)


def dp_allreduce_ms(cfg: MoEConfig, dp: int, gen: str, *,
                    over_dcn: bool = False,
                    links: int | None = None) -> float:
    """Per-step gradient all-reduce of the dp axis over the NIC
    (``over_dcn``) or the row's links; 0 for inference or ``dp <= 1``."""
    if dp <= 1 or not cfg.is_training:
        return 0.0
    from flashmoe_tpu_torch.parallel.topology import (
        _DCN_SPEC, _ICI_SPECS, rank_share)

    grad_mb = cfg.param_count * cfg.param_dtype.itemsize / 1e6
    if over_dcn:
        lat_us, gbps = _DCN_SPEC
        beta = 1e3 / (gbps * 1e3)
    else:
        lat_us, gbps = _ICI_SPECS[gen]
        beta = 1e3 / (gbps * rank_share(gen, dp) * 1e3
                      * max(_links(gen, links), 1))
    return ring_allreduce_ms(grad_mb, dp, beta, lat_us / 1e3)


def kv_page_mb(cfg: MoEConfig, page_size: int, *, wire=None) -> float:
    """MB one KV page pair (K and V, all layers) weighs on the handoff
    wire, with the fp8 wires' per-(layer, page) f32 scales."""
    from flashmoe_tpu_torch.ops import wire as wr

    wire_dt = wr.resolve(wire) if isinstance(wire, str) else wire
    nkv, dh = cfg.resolved_num_kv_heads, cfg.resolved_head_dim
    row = nkv * int(page_size) * dh
    per_layer = 2 * (wr.payload_row_bytes(wire_dt, row, cfg.dtype)
                     + wr.scale_bytes(wire_dt))
    return cfg.num_layers * per_layer / 1e6


def kv_handoff_ms(cfg: MoEConfig, pages: int, page_size: int, *,
                  wire=None) -> float:
    """Modeled time to stream one prefill's ``pages`` KV pages to a
    decode replica: one message over the NIC row."""
    from flashmoe_tpu_torch.parallel.topology import _DCN_SPEC

    lat_us, gbps = _DCN_SPEC
    mb = max(int(pages), 0) * kv_page_mb(cfg, page_size, wire=wire)
    return lat_us / 1e3 + (mb / 1e3) / gbps * 1e3


#: decode tokens a step priced when ``mode='decode'`` and no batch is given
DECODE_TOKENS_DEFAULT = 64


def decode_shape(cfg: MoEConfig, d: int = 1,
                 decode_tokens: int | None = None,
                 verify_tokens: int | None = None) -> MoEConfig:
    """The per-step problem of a decode engine: ``tokens`` = the decode
    batch rounded up to a multiple of ``d`` (times ``verify_tokens + 1``
    for a speculative verify span), inference mode."""
    toks = int(decode_tokens if decode_tokens else DECODE_TOKENS_DEFAULT)
    if toks < 1:
        raise ValueError(f"decode_tokens={decode_tokens!r} must be >= 1")
    if verify_tokens is not None and int(verify_tokens) < 0:
        raise ValueError(
            f"verify_tokens={verify_tokens!r} must be >= 0")
    d = max(int(d), 1)
    toks = -(-toks // d) * d
    toks *= 1 + int(verify_tokens or 0)
    return cfg.replace(sequence_len=toks, mini_batch=1,
                       is_training=False)


def predict_paths(cfg: MoEConfig, d: int = 1, gen: str = "h100", *,
                  slices: int = 1, links: int | None = None,
                  mxu_fraction: float = 1.0, mode: str = "training",
                  decode_tokens: int | None = None,
                  verify_tokens: int | None = None,
                  dp: int = 1, dp_over_dcn: bool = False
                  ) -> list[PathPrediction]:
    """Every candidate path's predicted latency at (cfg, d ranks, spec
    row ``gen``), fastest feasible first, infeasible last.  ``slices``:
    nodes the ep axis spans; ``links``: links a rank stripes an exchange
    over (default the row's); ``mode``: 'training', 'prefill' (inference
    feasibility) or 'decode' (:func:`decode_shape` first); ``dp`` /
    ``dp_over_dcn``: price the dp ring into every row."""
    if mode not in ("training", "prefill", "decode"):
        raise ValueError(
            f"mode {mode!r} not in ('training', 'prefill', 'decode')")
    if verify_tokens and mode != "decode":
        raise ValueError("verify_tokens prices the speculative verify "
                         "span — decode mode only")
    if mode == "decode":
        cfg = decode_shape(cfg, d, decode_tokens, verify_tokens)
    elif mode == "prefill" and cfg.is_training:
        cfg = cfg.replace(is_training=False)
    peak_fs, hbm_bs = _dtype_peak(gen, cfg, d)   # validates gen first
    if d < 1:
        raise ValueError(f"d={d} must be >= 1")
    if d > 1 and cfg.num_experts % d:
        raise ValueError(f"E={cfg.num_experts} not divisible by d={d}")
    if d > 1 and cfg.tokens % d:
        raise ValueError(f"S={cfg.tokens} not divisible by d={d}")
    if slices < 1 or d % slices:
        raise ValueError(f"d={d} not divisible into {slices} slices")
    links = _links(gen, links)
    mxu_fraction = max(min(mxu_fraction, 1.0), 1e-6)
    a_ici, bw_link = _ici_link(gen, d)
    rows = []

    from flashmoe_tpu_torch.ops import wire as wr
    from flashmoe_tpu_torch.quant import core as qcore

    wire_tag = (f"{wr.canonical_name(cfg.wire_dtype)}/"
                f"{wr.canonical_name(cfg.wire_dtype_combine)}")
    wire_dcn_tag = wr.canonical_name(cfg.wire_dtype_dcn)
    if wire_dcn_tag != "off":
        wire_tag += f"/dcn:{wire_dcn_tag}"
    wire_on = wire_tag != "off/off"
    quant_tag = qcore.canonical_name(cfg.expert_quant)
    ar_ms = dp_allreduce_ms(cfg, dp, gen, over_dcn=dp_over_dcn,
                            links=links)
    n_chunks = cfg.a2a_chunks or 1
    if n_chunks > 1 and d > 1 and (cfg.num_experts // d) % n_chunks:
        raise ValueError(
            f"a2a_chunks={n_chunks} does not divide the local-expert "
            f"axis (num_experts={cfg.num_experts} // d={d} = "
            f"{cfg.num_experts // d})")

    def chip(cost):
        compute_ms = cost.flops / (peak_fs * mxu_fraction) * 1e3
        return compute_ms, max(compute_ms, cost.total_bytes / hbm_bs * 1e3)

    def mk(path, cost, ici_ms, dcn_ms, total_ms=None, schedule=None,
           feasible=True, note="", wire="off/off", chunks=1):
        compute_ms, chip_ms = chip(cost)
        hbm_ms = cost.total_bytes / hbm_bs * 1e3
        serial_ms = chip_ms + ici_ms + dcn_ms + ar_ms
        rows.append(PathPrediction(
            path=path, backend=BACKEND_OF[path], schedule=schedule,
            compute_ms=compute_ms, hbm_ms=hbm_ms, ici_ms=ici_ms,
            dcn_ms=dcn_ms, serial_ms=serial_ms,
            total_ms=serial_ms if total_ms is None else total_ms + ar_ms,
            feasible=feasible, note=note, cost=cost, wire=wire,
            a2a_chunks=chunks, dp_allreduce_ms=ar_ms, quant=quant_tag))

    if d == 1:
        for p in ("xla", "explicit", "gather"):
            infeas = p == "gather" and cfg.is_training
            mk(p, path_costs(cfg, p, d_world=1), 0.0, 0.0,
               feasible=not infeas,
               note="inference-only kernel" if infeas else "on-chip roofline")
        rows.sort(key=lambda r: (not r.feasible, r.total_ms))
        return rows

    from flashmoe_tpu_torch.analysis import wire_row_bytes
    from flashmoe_tpu_torch.parallel.fused import schedule_table

    def one_leg(slab, dcn_slab=None, *, kind):
        return a2a_leg_ms(slab, kind, d=d, gen=gen, slices=slices,
                          links=links, chunks=n_chunks, dcn_slab=dcn_slab)

    def xla_row(path, cost, slab_by_leg, kind, note):
        """One exchange-layer row: each leg at its own wire row size and
        chunked alpha; with a2a_chunks > 1 the pipelined makespan."""
        legs = [one_leg(*(slab if isinstance(slab, tuple) else (slab,)),
                        kind=kind) for slab in slab_by_leg]
        ici = sum(leg[0] for leg in legs)
        dcn = sum(leg[1] for leg in legs)
        total = None
        if n_chunks > 1:
            total = chunked_pipeline_ms(chip(cost)[1], sum(legs[0]),
                                        sum(legs[1]), n_chunks)
            note += f" [chunked a2a x{n_chunks} pipeline]"
        mk(path, cost, ici, dcn, total_ms=total, wire=wire_tag,
           note=note, chunks=n_chunks)

    slab_legs = [slab_bytes(cfg, d, leg="dispatch"),
                 slab_bytes(cfg, d, leg="combine")]
    wire_note = f" [wire {wire_tag}]" if wire_on else ""

    coll_note = ("capacity slabs" if n_chunks > 1 else
                 "serialized a2a (the layer cannot hide it)")
    xla_row("collective", path_costs(cfg, "explicit", d_world=d),
            slab_legs, "flat", coll_note + wire_note)

    if slices > 1:
        dcn_applies = d // slices > 1 and wire_dcn_tag != "off"
        hier_legs = [(slab_bytes(cfg, d, leg=leg),
                      slab_bytes(cfg, d, leg=leg,
                                 hop="dcn" if dcn_applies else "ici"))
                     for leg in ("dispatch", "combine")]
        hier_note = "one aggregated DCN message per slice pair"
        if dcn_applies:
            hier_note += f" [dcn hop {wire_dcn_tag}]"
        elif wire_dcn_tag != "off":
            hier_note += " [dcn wire inert: one rank per slice]"
        xla_row("hierarchical", path_costs(cfg, "explicit", d_world=d),
                hier_legs, "hierarchical", hier_note + wire_note)

    rag = path_costs(cfg, "ragged", d_world=d)
    rag_rows = (cfg.tokens // d) * cfg.expert_top_k / d
    xla_row("ragged", rag,
            [rag_rows * wire_row_bytes(cfg, "dispatch"),
             rag_rows * wire_row_bytes(cfg, "combine")], "flat",
            "uniform-routing expectation; skew moves more" + wire_note)

    meta = schedule_table(cfg, d)
    nrt_rowwin = schedule_table(cfg, d, schedule="rowwin")["n_row_tiles"]
    nlx = max(cfg.num_experts // d, 1)
    pslab = slab_bytes(cfg, d, padded=True)
    t_x = (d - 1) * (a_ici + pslab / (bw_link * links))

    def fused_total(cost, sched):
        c = chip(cost)[1]
        if sched in ("batched", "rowwin"):
            # one processing order in the port (own slab, then the remote
            # slabs expert-major); a down task stores each tile's rows as
            # it finishes them, so only the last tile's rows trail
            return (max(c / d, t_x) + (d - 1) / d * c
                    + t_x / max(nlx * nrt_rowwin, 1))
        return max(c, t_x + c / d) + t_x / max(d - 1, 1)

    def fused_why_out(sched=None):
        if wire_on:
            return "wire-dtype compression is exchange-layer only"
        if slices > 1:
            return "the fused kernel runs within one node"
        if sched == "batched":
            return "batched needs two ranks"
        return "infeasible"

    for sched in ("batched", "resident", "stream", "rowwin"):
        cost = path_costs(cfg, "fused", d_world=d, schedule=sched)
        ok = meta["feasible"][sched] and slices == 1 and not wire_on
        mk(f"fused[{sched}]", cost, 2 * t_x, 0.0,
           total_ms=fused_total(cost, sched), schedule=sched, feasible=ok,
           note="in-kernel arrival overlap" if ok else fused_why_out(sched))

    # the in-kernel combine at the resolved schedule; B5's combine runs at
    # every weight store (JAX's has no quant arm)
    sched = meta["schedule"]
    cost = path_costs(cfg, "fused_combine", d_world=d)
    ok = meta["feasible"][sched] and slices == 1 and not wire_on
    mk("fused_combine", cost, 2 * t_x, 0.0,
       total_ms=fused_total(cost, sched), schedule=sched, feasible=ok,
       note=("sorted per-row returns; combine off the critical path"
             if ok else fused_why_out(sched)))

    rows.sort(key=lambda r: (not r.feasible, r.total_ms))
    return rows


# ----------------------------------------------------------------------
# Speculative-decode economics
# ----------------------------------------------------------------------

def speculate_tokens_per_step(accept_rate: float, k: int) -> float:
    """Expected tokens a verify step emits with ``k`` drafts, each
    position accepted with probability ``accept_rate``:
    ``(1 - p^(k+1)) / (1 - p)``, ``k + 1`` at p = 1."""
    p = min(max(float(accept_rate), 0.0), 1.0)
    k = int(k)
    if k < 0:
        raise ValueError(f"k={k} must be >= 0")
    if p >= 1.0:
        return float(k + 1)
    return (1.0 - p ** (k + 1)) / (1.0 - p)


def _best_decode_ms(cfg: MoEConfig, d: int, gen: str, *,
                    decode_tokens: int | None,
                    verify_tokens: int | None) -> float:
    rows = predict_paths(cfg, d, gen, mode="decode",
                         decode_tokens=decode_tokens,
                         verify_tokens=verify_tokens)
    best = next((r for r in rows if r.feasible), rows[0])
    return best.total_ms


def _decode_pair(cfg, d, gen, decode_tokens, verify_tokens):
    k = int(verify_tokens)
    if k < 1:
        raise ValueError(f"verify_tokens={verify_tokens} must be >= 1")
    t1 = _best_decode_ms(cfg, d, gen, decode_tokens=decode_tokens,
                         verify_tokens=None)
    tk = _best_decode_ms(cfg, d, gen, decode_tokens=decode_tokens,
                         verify_tokens=k)
    return k, t1, tk


def speculate_uplift(cfg: MoEConfig, d: int = 1, gen: str = "h100", *,
                     decode_tokens: int | None = None,
                     verify_tokens: int = 3,
                     accept_rate: float = 0.7) -> dict:
    """Modeled tokens-per-step uplift of draft-then-verify at
    ``accept_rate``: ``E[n](p) x t1 / tk``."""
    k, t1, tk = _decode_pair(cfg, d, gen, decode_tokens, verify_tokens)
    e_n = speculate_tokens_per_step(accept_rate, k)
    cost_ratio = tk / t1 if t1 > 0 else float("inf")
    return {
        "verify_tokens": k,
        "accept_rate": float(accept_rate),
        "t1_ms": t1,
        "tk_ms": tk,
        "cost_ratio": cost_ratio,
        "tokens_per_step": e_n,
        "uplift": e_n / cost_ratio if cost_ratio else float("inf"),
    }


def speculate_break_even(cfg: MoEConfig, d: int = 1, gen: str = "h100",
                         *, decode_tokens: int | None = None,
                         verify_tokens: int = 3) -> float:
    """The acceptance rate at which speculation pays for its verify span
    (``E[n](p) = tk / t1`` by bisection); 1.0 when even perfect
    acceptance cannot pay, 0.0 when the span is free."""
    k, t1, tk = _decode_pair(cfg, d, gen, decode_tokens, verify_tokens)
    ratio = tk / t1 if t1 > 0 else float("inf")
    if ratio <= 1.0:
        return 0.0
    if ratio >= k + 1:
        return 1.0
    lo, hi = 0.0, 1.0
    for _ in range(60):
        mid = (lo + hi) / 2
        if speculate_tokens_per_step(mid, k) < ratio:
            lo = mid
        else:
            hi = mid
    return (lo + hi) / 2


def explain_table(preds: list[PathPrediction], *, markdown: bool = True
                  ) -> str:
    """The explain table the CLI and ``chip_smoke.py`` print."""
    hdr = ("| path | compute ms | HBM ms | ICI ms | DCN ms | serial ms "
           "| predicted ms | note |")
    lines = [hdr, "|---|---|---|---|---|---|---|---|"]
    for p in preds:
        star = "" if p.feasible else " (infeasible)"
        lines.append(
            f"| {p.path}{star} | {p.compute_ms:.3f} | {p.hbm_ms:.3f} | "
            f"{p.ici_ms:.3f} | {p.dcn_ms:.3f} | {p.serial_ms:.3f} | "
            f"{p.total_ms:.3f} | {p.note} |")
    return "\n".join(lines)
