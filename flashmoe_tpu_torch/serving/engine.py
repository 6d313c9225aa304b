"""Continuous-batching serving engine over the paged KV cache.

Counterpart of ``flashmoe_tpu/serving/engine.py``.  One fixed decode
batch of ``max_batch`` slots; requests join and leave per step:

* admission: queued requests whose arrival step has passed take a free
  slot when the page pool can hold their prompt; a whole-prompt prefill
  (:func:`flashmoe_tpu_torch.models.generate.prefill_forward` at the
  padded length) writes their pages in one shot, or, with
  ``prefill_chunk``, one fixed-size chunk a step; ``serve.admit``;
* decode: one step advances every decoding slot: sample from each
  slot's pending logits (greedy / temperature / top-k / top-p, per
  request), feed the sampled tokens, paged attention over each slot's
  block table, the MoE FFN on the batch rows;
* retirement: a slot leaves when it emits a stop token or its
  ``max_new_tokens``-th token (``serve.retire`` with TTFT / TPOT); its
  pages return to the pool;
* eviction: when decode needs a page and the pool is dry, the youngest
  request goes back to the head of the queue (``serve.evict``); its
  delivered tokens stand, and it later re-prefills prompt + generated
  tokens and continues;
* speculation (``ServeConfig.speculate``): n-gram drafts verified in one
  ``k + 1``-position forward, only canonical samples emitted.

The host logic is a pure function of the submitted requests and their
arrival steps, and the page allocator is LIFO, so a seeded drill replays
exactly.  Paged attention is plain torch (a gather, then f32 products
under the ``-1e30`` length mask, as in JAX, where it is an einsum
outside any Pallas kernel).  The MoE layers go through the port's
``_ffn`` / ``moe_layer``: on CUDA tensors they run the gate (B1) and the
grouped FFN (B2, or B3 under ``gather_fused``), and the whole-prompt
prefill runs the flash-attention kernel (B9); JAX's engine takes its
XLA arm everywhere.  With ``ep_shards > 1`` the decode and verify steps
run over a local mesh of that many expert-parallel ranks: each rank
attends over its own slot rows and its partition of the page slab, and
the MoE layers run :func:`flashmoe_tpu_torch.parallel.ragged_ep.
decode_moe_rows`.

The sampler keys each draw on (request seed, token index) through a
``torch.Generator`` on the logits' device (Gumbel-max), where JAX folds
the index into a ``PRNGKey``: a request's stream does not depend on the
batch it shares, and the verify step can recompute the canonical sample
of any drafted position.  The live plane (the request tracer, the scrape
server) and the SLO watchdog are wired as in JAX
(``flashmoe_tpu/serving/engine.py:721-800, 935-991``), and so are the
serving fabric's seams (``:736-784, 1025-1066``): a handed-off prefill
(``prefill_fn``), per-replica latency sketches (``replica_tag``), the
pool plan in ``/vars`` (``pools_info``), sub-step heartbeats
(``heartbeat_fn``) and crash migration (:meth:`ServingEngine.evacuate`,
:meth:`ServingEngine.adopt`).
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from flashmoe_tpu_torch import quant as qt
from flashmoe_tpu_torch.config import MoEConfig
from flashmoe_tpu_torch.kernels import _build
from flashmoe_tpu_torch.models.generate import (init_cache, lm_logits,
                                                lm_logits_span,
                                                prefill_forward)
from flashmoe_tpu_torch.models.transformer import _ffn, qkv, rms_norm
from flashmoe_tpu_torch.ops.attention import NEG_INF
from flashmoe_tpu_torch.parallel import ragged_ep
from flashmoe_tpu_torch.parallel.mesh import local_mesh
from flashmoe_tpu_torch.serving.kvcache import (SCRATCH_PAGE, PagePool,
                                                ShardedPagePool,
                                                ctx_pages_bucket,
                                                gather_ctx,
                                                init_paged_cache,
                                                prompt_pad, store_prefill,
                                                store_tokens)
from flashmoe_tpu_torch.serving.speculate import (DraftState, SpecConfig,
                                                  spec_stats_fields)
from flashmoe_tpu_torch.telemetry_plane.sketch import WindowedRate
from flashmoe_tpu_torch.utils.telemetry import metrics as _global_metrics
from flashmoe_tpu_torch.utils.telemetry import trace_span

def _refuse(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported yet: it waits for the ROADMAP item {item}")


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request.  ``seed`` keys the per-request sampler
    (with the token index, so sampling is independent of batch
    composition); ``stop_tokens`` retire the request the step one is
    emitted (the stop token itself is delivered)."""

    rid: int
    prompt: tuple
    max_new_tokens: int = 16
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    stop_tokens: tuple = ()
    seed: int = 0

    def __post_init__(self):
        if not self.prompt:
            raise ValueError(f"request {self.rid}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(f"request {self.rid}: max_new_tokens must "
                             f"be >= 1")
        if not 0 < self.top_p <= 1.0:
            raise ValueError(f"request {self.rid}: top_p must be in "
                             f"(0, 1]")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Engine shape knobs.

    ``num_pages`` includes the reserved scratch page; ``prompt_bucket``
    must be a multiple of ``page_size`` (prefilled pages are written
    whole); ``ctx_bucket_pages`` is the decode gather's granularity.
    ``prefill_chunk`` (tokens, a multiple of ``page_size``) bounds the
    per-step prefill budget: a longer prompt is admitted one chunk a
    step.  ``ep_shards`` > 1 runs the decode step over that many
    expert-parallel ranks, the page slab partitioned alongside the
    experts.  ``speculate`` (a :class:`SpecConfig`, None = off) arms
    speculative multi-token decoding."""

    max_batch: int = 8
    page_size: int = 8
    num_pages: int = 64
    max_pages_per_slot: int = 8
    ctx_bucket_pages: int = 2
    prompt_bucket: int = 8
    pad_token: int = 0
    max_steps: int = 10_000
    prefill_chunk: int | None = None
    ep_shards: int = 1
    speculate: SpecConfig | None = None

    def __post_init__(self):
        if self.speculate is not None \
                and not isinstance(self.speculate, SpecConfig):
            raise ValueError(
                f"speculate must be a SpecConfig or None, got "
                f"{type(self.speculate).__name__}")
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if self.page_size < 1:
            raise ValueError("page_size must be >= 1")
        if self.num_pages < 2:
            raise ValueError("num_pages must be >= 2 (page 0 is the "
                             "scratch page)")
        if not 1 <= self.ctx_bucket_pages <= self.max_pages_per_slot:
            raise ValueError("ctx_bucket_pages must be in "
                             "[1, max_pages_per_slot]")
        if self.prompt_bucket < self.page_size \
                or self.prompt_bucket % self.page_size:
            raise ValueError(
                f"prompt_bucket={self.prompt_bucket} must be a "
                f"positive multiple of page_size={self.page_size} "
                f"(prefill writes whole pages)")
        if self.prefill_chunk is not None and (
                self.prefill_chunk < self.page_size
                or self.prefill_chunk % self.page_size):
            raise ValueError(
                f"prefill_chunk={self.prefill_chunk} must be a "
                f"positive multiple of page_size={self.page_size} "
                f"(chunks write whole pages)")
        if self.ep_shards < 1:
            raise ValueError("ep_shards must be >= 1")
        if self.ep_shards > 1:
            if self.max_batch % self.ep_shards:
                raise ValueError(
                    f"ep_shards={self.ep_shards} must divide "
                    f"max_batch={self.max_batch} (the slot grid is "
                    f"row-partitioned across shards)")
            if self.num_pages % self.ep_shards:
                raise ValueError(
                    f"ep_shards={self.ep_shards} must divide "
                    f"num_pages={self.num_pages} (the page slab is "
                    f"partitioned across shards)")
            if self.num_pages // self.ep_shards < 2:
                raise ValueError(
                    f"num_pages={self.num_pages} leaves fewer than 2 "
                    f"pages per shard at ep_shards={self.ep_shards} "
                    f"(each shard reserves its own scratch page)")

    @property
    def max_context(self) -> int:
        return self.max_pages_per_slot * self.page_size


@dataclasses.dataclass
class _QueueEntry:
    """One queued (or evicted and requeued) request."""

    arrival_step: int
    req: Request                   # current incarnation (the prompt grows
                                   # across evictions)
    orig: Request                  # pre-eviction identity (output key)
    arrival_s: float | None        # clock when the arrival step was
                                   # reached (TTFT base); None until then
    first_token_s: float | None    # survives eviction: the client already
                                   # holds the first token


@dataclasses.dataclass
class _Slot:
    """Host-side state of one occupied batch slot."""

    req: Request
    orig: Request
    pages: list
    length: int                    # cache positions written
    emitted: list                  # tokens delivered this incarnation
    admit_step: int
    arrival_s: float
    first_token_s: float | None
    prefill_pos: int | None = None  # next chunk start (chunked prefill in
                                    # flight); None = decoding
    prefill_toks: object = None     # padded np prompt for the chunks
    draft: object = None            # DraftState, rebuilt from prompt +
                                    # emitted, so it survives eviction
    spec_drafted: int = 0           # drafts proposed this incarnation
    spec_accepted: int = 0          # ... and accepted (= canonical)


# ----------------------------------------------------------------------
# Device steps (plain functions on tensors; the cache is written in place)
# ----------------------------------------------------------------------

def _paged_attention(q, k_pages, v_pages, tables, pos, dtype):
    """Causal GQA attention of ``q`` [B, T, N, D] over each row's pages:
    ``tables`` [B, n] page ids into ``k_pages`` / ``v_pages``
    [P, N_kv, page, D]; ``pos`` [B or 1, T] the query positions, key s
    visible iff s <= pos.  f32 products and softmax, probabilities
    rounded to ``dtype`` before the second product, as JAX's einsums.
    Returns [B, T, N * D] in ``dtype``."""
    b, t, nh, dh = q.shape
    kk = gather_ctx(k_pages, tables).float()  # [B, N_kv, S, D]
    vv = gather_ctx(v_pages, tables).float()
    nkv, s = kk.shape[1], kk.shape[2]
    rep = nh // nkv
    # head n reads kv head n // rep (jnp.repeat along the head axis)
    qh = q.transpose(1, 2).float().reshape(b, nkv, rep * t, dh)
    logits = (qh @ kk.transpose(-1, -2)) * (dh ** -0.5)
    live = (torch.arange(s, device=q.device)
            <= pos[:, None, None, :, None])  # [B, 1, 1, T, S]
    logits = torch.where(live, logits.view(b, nkv, rep, t, s),
                         torch.full((), NEG_INF, device=q.device))
    probs = torch.softmax(logits, dim=-1).to(dtype).float()
    ctx = probs.view(b, nkv, rep * t, s) @ vv
    return ctx.view(b, nh, t, dh).transpose(1, 2).reshape(
        b, t, nh * dh).to(dtype)


def _span_pages(tables, pos, page):
    """Write targets of positions ``pos`` [B, T] through ``tables``
    [B, n]: (page ids, rows), positions past the gathered context routed
    to the scratch page (a slot drafted into its context ceiling; the
    host never reads those columns)."""
    ntab = tables.shape[1]
    valid = pos < ntab * page
    pidx = torch.clamp(pos // page, 0, ntab - 1)
    page_ids = torch.where(valid, tables.gather(1, pidx),
                           torch.full_like(pidx, SCRATCH_PAGE))
    return page_ids, torch.where(valid, pos % page, torch.zeros_like(pos))


def _paged_layers(params, cfg: MoEConfig, k_pages, v_pages, x, pos, tables,
                  ffn, ranks: int = 1):
    """Every layer over paged K/V.  x: [B, T, H] at positions ``pos``
    [B, T] (or [1, T] for one row), block tables ``tables`` [B, n].  Each
    of ``ranks`` equal row blocks writes and reads its own equal block of
    the page slab through rank-local ids (one rank: the whole slab).
    ``ffn(li, layer, f_in)`` is the FFN sub-block."""
    b = x.shape[0]
    rows_r = b // ranks
    pages_r = k_pages.shape[1] // ranks
    page = k_pages.shape[3]
    page_ids, rows = _span_pages(tables, pos.expand(b, -1), page)
    for li, layer in enumerate(params["layers"]):
        q, k, v = qkv(layer, rms_norm(x, layer["attn_norm"]), cfg,
                      pos.expand(b, -1))
        ctx = []
        for r in range(ranks):
            rs = slice(r * rows_r, (r + 1) * rows_r)
            ps = slice(r * pages_r, (r + 1) * pages_r)
            kp, vp = k_pages[li, ps], v_pages[li, ps]
            store_tokens(kp, k[rs], page_ids[rs], rows[rs])
            store_tokens(vp, v[rs], page_ids[rs], rows[rs])
            ctx.append(_paged_attention(q[rs], kp, vp, tables[rs],
                                        pos[rs] if pos.shape[0] > 1
                                        else pos, x.dtype))
        ctx = torch.cat(ctx) if ranks > 1 else ctx[0]
        x = x + ctx @ layer["wo"].to(x.dtype)
        x = x + ffn(li, layer, rms_norm(x, layer["ffn_norm"]))
    return x


def _local_ffn(cfg: MoEConfig, uk: bool):
    return lambda li, layer, f: _ffn(layer, f, cfg, li, uk)[0]


@torch.no_grad()
def _prefill_padded(params, cfg: MoEConfig, prompt_padded, true_len: int):
    """Prefill one padded prompt: [1, T_pad] -> (logits [V] at the true
    last position, k_seq / v_seq [L, N_kv, T_pad, D]).  Pad positions
    compute garbage no causal query before them sees; their rows land in
    pages the length mask never exposes."""
    cache = init_cache(cfg, 1, prompt_padded.shape[1], prompt_padded.device)
    x, cache = prefill_forward(params, cfg, prompt_padded, cache)
    logits = lm_logits(params, cfg, x[:, true_len - 1:true_len])[0]
    return logits, cache.k[:, 0], cache.v[:, 0]


@torch.no_grad()
def _prefill_chunk(params, cfg: MoEConfig, k_pages, v_pages, chunk_toks,
                   block_table, chunk_page_ids, start_pos: int,
                   rel_last: int):
    """Prefill one fixed-size chunk of a long prompt into the paged cache.

    chunk_toks: [1, C]; block_table: [n] page ids covering positions
    [0, start_pos + C) (bucketed, scratch-padded); chunk_page_ids:
    [C / page] the pages this chunk writes; start_pos: the absolute
    position of the chunk's first token; rel_last: the in-chunk index of
    the prompt's last token (clipped; only the chunk holding it keeps its
    logits).  The chunk's K/V land in their pages before the gather, so
    in-chunk causal attention reads them as decode does.  Returns
    (logits [V], k_pages, v_pages)."""
    uk = _build.use_kernels_for(chunk_toks, None)
    c = chunk_toks.shape[1]
    first = start_pos // k_pages.shape[3]
    # the chunk's positions write (and read back) chunk_page_ids
    table = block_table.clone()
    table[first:first + chunk_page_ids.shape[0]] = chunk_page_ids
    pos = start_pos + torch.arange(c, device=chunk_toks.device)[None, :]
    x = params["embed"].to(cfg.dtype)[chunk_toks]
    x = _paged_layers(params, cfg, k_pages, v_pages, x, pos, table[None],
                      _local_ffn(cfg, uk))
    return (lm_logits(params, cfg, x[:, rel_last:rel_last + 1])[0],
            k_pages, v_pages)


@torch.no_grad()
def _paged_decode_step(params, cfg: MoEConfig, k_pages, v_pages, toks,
                       block_tables, positions):
    """One decode step for the whole slot grid.

    toks: [B] tokens to feed; block_tables: [B, n] page ids (bucketed);
    positions: [B] write positions (each slot's current length; inactive
    slots pass 0 with an all-scratch table).  Returns (logits [B, V] f32,
    k_pages, v_pages): ``generate._decode_step``'s per-layer arithmetic
    with per-slot positions and paged K/V."""
    uk = _build.use_kernels_for(toks, None)
    x = params["embed"].to(cfg.dtype)[toks][:, None, :]
    x = _paged_layers(params, cfg, k_pages, v_pages, x, positions[:, None],
                      block_tables, _local_ffn(cfg, uk))
    return lm_logits(params, cfg, x), k_pages, v_pages


@torch.no_grad()
def _paged_verify_step(params, cfg: MoEConfig, k_pages, v_pages, toks,
                       block_tables, positions):
    """Speculative verify: score a ``T = draft_tokens + 1`` position span
    per slot in one forward.

    toks: [B, T]: column 0 the last sampled token, columns 1..k the
    drafts (padded); positions: [B] base write positions (column t lands
    at ``positions + t``).  Returns (logits [B, T, V] f32, k_pages,
    v_pages): column t is the next-token distribution after feeding
    column t.  Rejected columns do write rows; the host rolls back its
    block tables and lengths, and the next step's span overwrites those
    rows before any causal mask exposes them."""
    uk = _build.use_kernels_for(toks, None)
    pos = positions[:, None] + torch.arange(toks.shape[1],
                                            device=toks.device)[None, :]
    x = params["embed"].to(cfg.dtype)[toks]
    x = _paged_layers(params, cfg, k_pages, v_pages, x, pos, block_tables,
                      _local_ffn(cfg, uk))
    return lm_logits_span(params, cfg, x), k_pages, v_pages


def _ep_ffn(cfg: MoEConfig, mesh, shards, uk: bool):
    """The FFN sub-block of the EP-sharded steps: each rank's rows (one
    contiguous block of ``x``'s rows a rank) through
    :func:`ragged_ep.decode_moe_rows` on its expert shard; dense layers on
    each rank's rows."""
    def ffn(li, layer, f):
        b, t, h = f.shape
        rows = f.reshape(b * t, h).split(b * t // mesh.ep)
        if li in cfg.moe_layer_indices:
            outs = ragged_ep.decode_moe_rows(shards[li], list(rows), cfg,
                                             mesh, use_kernels=uk).out
        else:
            outs = [_ffn(layer, r[None], cfg, li, uk)[0][0] for r in rows]
        return torch.cat(outs).reshape(b, t, h).to(f.dtype)
    return ffn


@torch.no_grad()
def _ep_decode_step(params, shards, cfg: MoEConfig, mesh, k_pages, v_pages,
                    toks, block_tables, positions):
    """The EP-sharded twin of :func:`_paged_decode_step` (``engine.py:
    495``) over the ``mesh.ep`` ranks of a local mesh: rank r holds slot
    rows [r * B/d, (r + 1) * B/d) and pages [r * P/d, (r + 1) * P/d) of
    the slab; ``block_tables`` carry rank-local page ids.  ``shards``:
    each layer's per-rank expert shards (``Mesh.shard_params``)."""
    uk = _build.use_kernels_for(toks, None)
    x = params["embed"].to(cfg.dtype)[toks][:, None, :]
    x = _paged_layers(params, cfg, k_pages, v_pages, x, positions[:, None],
                      block_tables, _ep_ffn(cfg, mesh, shards, uk),
                      ranks=mesh.ep)
    return lm_logits(params, cfg, x), k_pages, v_pages


@torch.no_grad()
def _ep_verify_step(params, shards, cfg: MoEConfig, mesh, k_pages,
                    v_pages, toks, block_tables, positions):
    """The EP-sharded twin of :func:`_paged_verify_step` (``engine.py:
    596``), ranks as in :func:`_ep_decode_step`."""
    uk = _build.use_kernels_for(toks, None)
    pos = positions[:, None] + torch.arange(toks.shape[1],
                                            device=toks.device)[None, :]
    x = params["embed"].to(cfg.dtype)[toks]
    x = _paged_layers(params, cfg, k_pages, v_pages, x, pos, block_tables,
                      _ep_ffn(cfg, mesh, shards, uk), ranks=mesh.ep)
    return lm_logits_span(params, cfg, x), k_pages, v_pages


_MASK64 = (1 << 64) - 1


def draw_seed(seed: int, index: int) -> int:
    """The generator seed of token ``index`` of a request seeded ``seed``
    (a splitmix64 finalizer over the pair)."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(index) + 1) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) & ((1 << 63) - 1)


@torch.no_grad()
def _sample_scores(logits, seeds, indices, temps, top_ks, top_ps):
    """The scores whose row-wise argmax :func:`_sample_dynamic` takes:
    ``logits`` [R, V] f32 on greedy rows; on sampled rows the logits over
    the temperature, truncated to the top-k, then to the nucleus over the
    sorted row (``_sample_dynamic``, ``engine.py:694``), plus Gumbel
    noise from a generator seeded by :func:`draw_seed` on the logits'
    device.  The knobs are host sequences of R: request seed, token
    index, temperature (<= 0: greedy), top-k, top-p."""
    scores = logits.float()
    sampled = [i for i, t in enumerate(temps) if t > 0.0]
    if not sampled:
        return scores
    dev = logits.device
    v = logits.shape[-1]
    rows = torch.tensor(sampled, device=dev)
    temps_t = torch.tensor([temps[i] for i in sampled],
                           dtype=torch.float32, device=dev)
    ks = torch.tensor([top_ks[i] for i in sampled], device=dev)
    ps = torch.tensor([top_ps[i] for i in sampled], dtype=torch.float32,
                      device=dev)
    neg = torch.full((), NEG_INF, device=dev)
    scaled = scores[rows] / torch.clamp(temps_t, min=1e-6)[:, None]
    sort_desc = torch.sort(scaled, dim=-1, descending=True).values
    kth = sort_desc.gather(1, torch.clamp(ks - 1, 0, v - 1)[:, None])
    use_k = (ks > 0) & (ks < v)
    scaled = torch.where(use_k[:, None] & (scaled < kth), neg, scaled)
    sort_desc = torch.sort(scaled, dim=-1, descending=True).values
    probs = torch.softmax(sort_desc, dim=-1)
    keep = (torch.cumsum(probs, dim=-1) - probs) < ps[:, None]
    thresh = torch.where(keep, sort_desc,
                         torch.full((), float("inf"), device=dev)).min(
        dim=-1, keepdim=True).values
    scaled = torch.where(scaled < thresh, neg, scaled)
    noise = torch.stack([
        torch.rand(v, device=dev, generator=torch.Generator(
            device=dev).manual_seed(draw_seed(seeds[i], indices[i])))
        for i in sampled])
    return scores.index_put((rows,), scaled - torch.log(-torch.log(noise)))


def _sample_dynamic(logits, seeds, indices, temps, top_ks, top_ps):
    """One token a row of ``logits`` [R, V] f32, each row with its own
    knobs (:func:`_sample_scores`).  Temperature <= 0 takes the exact
    argmax (first maximum, as ``sample_tokens``' greedy arm); other rows
    are a Gumbel-max draw keyed by (request seed, token index), so a
    request's stream does not depend on the rows beside it.  Returns [R]
    int64."""
    return torch.argmax(_sample_scores(logits, seeds, indices, temps,
                                       top_ks, top_ps), dim=-1)


class ServingEngine:
    """Multi-request continuous-batching engine (host loop + device
    steps).  See the module docstring for the lifecycle.

    ``params`` live on the device the engine serves on (the card unless
    the caller made them on the CPU); the page pool is allocated there.
    ``recorder``: a :class:`~flashmoe_tpu_torch.utils.telemetry.
    FlightRecorder` for ``serve_step`` / ``serve_request`` records;
    ``metrics_obj``: the :class:`~flashmoe_tpu_torch.utils.telemetry.
    Metrics` for decisions and sketches (the process-wide one by
    default); ``mesh``: a local mesh of ``ep_shards`` ranks for the
    EP-sharded decode (made when None); ``clock``: a zero-argument
    seconds source replacing ``time.monotonic`` for every latency.
    ``tracer``: True (or a :class:`~flashmoe_tpu_torch.telemetry_plane.
    tracing.RequestTracer`) traces every request's lifecycle;
    ``telemetry_port``: serve ``/metrics``, ``/healthz`` and ``/vars`` on
    that port (0: an ephemeral one) until :meth:`close`; ``slo``: an
    :class:`~flashmoe_tpu_torch.profiler.slo.SLOConfig` (or a watchdog)
    judging every step and every retired request's TTFT / TPOT.  The
    token streams are the same with any of them on.

    The serving fabric's seams (``flashmoe_tpu/serving/engine.py:
    739-760``): ``prefill_fn(prompt_padded, true_len, *, rid)`` replaces
    the local prefill and honours :func:`_prefill_padded`'s contract
    (logits [V], k_seq / v_seq [L, N_kv, T_pad, D]); a handed-off prefill
    is always whole (``prefill_chunk`` applies to the local path only).
    ``replica_tag`` (e.g. ``"r0"``) also keys this engine's TTFT / TPOT
    sketches per replica; ``pools_info`` is shown as is in ``/vars``.  A
    ``clock`` with a ``complete_step`` method (a
    :class:`~flashmoe_tpu_torch.fabric.vclock.VirtualClock`) has its
    decode tick charged at the end of every step.
    ``heartbeat_fn(phase)`` is called at every phase boundary of a step
    (``admit``, ``prefill``, ``sample``, ``decode``, ``end``): a replica
    that hangs mid-step stops beating mid-step."""

    def __init__(self, params, cfg: MoEConfig,
                 serve: ServeConfig | None = None, *,
                 recorder=None, mesh=None, metrics_obj=None, clock=None,
                 tracer=None, telemetry_port=None, slo=None,
                 prefill_fn=None, replica_tag=None, pools_info=None,
                 heartbeat_fn=None):
        if cfg.drop_tokens:
            raise ValueError(
                "the serving engine requires a dropless config "
                "(drop_tokens=False): inactive/retired batch slots "
                "must never compete with live requests for capacity "
                "slots, and decode batches are token-count-tiny anyway")
        self.cfg = cfg
        self.serve = serve if serve is not None else ServeConfig()
        self.mesh = mesh
        self.recorder = recorder
        self.metrics = metrics_obj if metrics_obj is not None \
            else _global_metrics
        self._prefill_fn = prefill_fn
        self.replica_tag = replica_tag
        self.pools_info = pools_info
        self._heartbeat = heartbeat_fn
        self._clock = clock if clock is not None else time.monotonic
        # a virtual clock (duck-typed on complete_step) is also charged a
        # decode tick at the end of every step
        self._vclock = clock if hasattr(clock, "complete_step") else None
        from flashmoe_tpu_torch.profiler.slo import as_watchdog

        self.watchdog = as_watchdog(slo)
        # ---- the live telemetry plane (off by default: no thread, and
        # the token streams are the same either way)
        self.tracer = None
        if tracer:
            from flashmoe_tpu_torch.telemetry_plane.tracing import (
                RequestTracer)

            self.tracer = (tracer if isinstance(tracer, RequestTracer)
                           else RequestTracer(metrics_obj=self.metrics,
                                              clock=self._clock))
            self.tracer.install()
        self.telemetry = None
        if telemetry_port is not None:
            from flashmoe_tpu_torch.telemetry_plane.server import (
                maybe_server)

            self.telemetry = maybe_server(
                telemetry_port, metrics_fn=lambda: self.metrics,
                health_fn=self._health_snapshot,
                vars_fn=self._vars_snapshot)
        self._rates = {"tokens": WindowedRate(), "admits": WindowedRate(),
                       "evictions": WindowedRate()}

        # ---- quantized expert storage: quantize once at load; the
        # bytes the narrow store frees are reported as KV-page headroom
        if isinstance(params, qt.QuantizedExpertState):
            params = params.params
        self.quant_info = None
        if cfg.expert_quant is not None:
            if not qt.is_quantized(params):
                params = qt.quantize_state(params, cfg.expert_quant).params
            self.quant_info = {
                "expert_quant": qt.canonical_name(cfg.expert_quant),
                "freed_bytes": qt.quant_bytes_saved(params,
                                                    cfg.param_dtype),
            }
        self.params = params
        self.device = params["embed"].device

        # ---- EP-sharded decode over a local mesh of virtual ranks -----
        self._ep_shards = None
        d = self.serve.ep_shards
        if d > 1:
            if cfg.num_experts % d:
                raise ValueError(
                    f"ep_shards={d} must divide num_experts="
                    f"{cfg.num_experts} (every shard holds the same "
                    f"local expert count)")
            if cfg.num_shared_experts:
                raise ValueError(
                    "EP-sharded decode requires num_shared_experts=0 "
                    "(the ragged EP path has no shared-expert arm)")
            if self.mesh is None:
                self.mesh = local_mesh(d, device=self.device)
            elif not self.mesh.is_local:
                raise _refuse("EP-sharded decode over a process mesh",
                              "'Blocked on hardware: the multi-GPU "
                              "transport'")
            elif self.mesh.ep != d or self.mesh.size != d:
                raise ValueError(
                    f"ep_shards={d} needs a mesh of {d} ep ranks at tp 1, "
                    f"got {self.mesh!r}")
            self._ep_shards = [self.mesh.shard_params(layer["moe"])
                               if li in cfg.moe_layer_indices else None
                               for li, layer in enumerate(params["layers"])]

        # ---- speculative decoding -------------------------------------
        self._spec = self.serve.speculate
        self._spec_steps = 0     # steps that ran a verify forward
        self._spec_drafted = 0
        self._spec_accepted = 0
        if self._spec is not None:
            self.metrics.decision(
                "serve.spec", event="armed",
                draft_tokens=self._spec.draft_tokens,
                ngram=self._spec.ngram, source=self._spec.source)

        self.cache = init_paged_cache(cfg, self.serve.num_pages,
                                      self.serve.page_size, self.device)
        self.pool = (ShardedPagePool(self.serve.num_pages, d) if d > 1
                     else PagePool(self.serve.num_pages))
        if self.quant_info is not None:
            page_bytes = sum(t.numel() * t.element_size()
                             for t in self.cache) / self.serve.num_pages
            extra = int(self.quant_info["freed_bytes"] // page_bytes)
            self.quant_info.update(
                page_bytes=int(page_bytes), extra_kv_pages=extra)
            self.metrics.decision(
                "serve.quant",
                expert_quant=self.quant_info["expert_quant"],
                freed_mb=round(self.quant_info["freed_bytes"] / 2**20,
                               3),
                extra_kv_pages=extra,
                num_pages=self.serve.num_pages)
            self.metrics.gauge("serve.quant_freed_mb",
                               self.quant_info["freed_bytes"] / 2**20)
        self.queue: deque = deque()
        self.slots: list[_Slot | None] = [None] * self.serve.max_batch
        self._logits = torch.zeros((self.serve.max_batch, cfg.vocab_size),
                                   dtype=torch.float32, device=self.device)
        self.step_idx = 0
        self.outputs: dict[int, list] = {}
        self.stats = {
            "submitted": 0, "completed": 0, "evictions": 0, "adopted": 0,
            "tokens": 0, "steps": 0, "max_queue_depth": 0,
            "max_active": 0, "decode_buckets": set(),
            "prefill_buckets": set(), "peak_occupancy": 0.0,
        }
        self._record_plan()

    # ---- planner wiring ----------------------------------------------

    def _record_plan(self) -> None:
        """Resolve the prefill- and decode-priced plans once and record
        them as one ``serve.plan`` decision (``flashmoe_tpu/serving/
        engine.py:913-932``): decode is priced at the slot grid's width
        a step.  ``'auto'`` resolves through the planner; other configs
        pass through as ``(cfg.moe_backend, cfg.a2a_chunks)``."""
        from flashmoe_tpu_torch.planner.select import resolve_moe_plan

        cfg = self.cfg
        pre_b, pre_c = resolve_moe_plan(cfg, self.mesh, mode="prefill")
        dec_b, dec_c = resolve_moe_plan(
            cfg, self.mesh, mode="decode",
            decode_tokens=self.serve.max_batch)
        self.decode_plan = (dec_b, dec_c)
        self.prefill_plan = (pre_b, pre_c)
        self.metrics.decision(
            "serve.plan",
            prefill_backend=pre_b, prefill_chunks=pre_c or 1,
            decode_backend=dec_b, decode_chunks=dec_c or 1,
            decode_tokens=self.serve.max_batch,
            heterogeneous=(pre_b, pre_c) != (dec_b, dec_c),
            ep=cfg.ep, moe_backend=cfg.moe_backend)

    # ---- live-plane snapshots ----------------------------------------

    def _health_snapshot(self) -> dict:
        """The ``/healthz`` document: the engine's load and the SLO
        watchdog's episode state."""
        doc = {
            "steps": self.step_idx,
            "queue_depth": len(self.queue),
            "active_requests": len(self._active()),
            "cache_occupancy": round(self.pool.occupancy, 4),
            "completed": self.stats["completed"],
            "evictions": self.stats["evictions"],
        }
        if self.replica_tag is not None:
            doc["replica"] = self.replica_tag
        if self.serve.speculate is not None:
            doc["spec"] = self.spec_snapshot()
        if self.watchdog is not None:
            doc["slo"] = self.watchdog.snapshot()
        return doc

    def _vars_snapshot(self) -> dict:
        """The ``/vars`` document: the plans this engine resolved and
        its shape knobs."""
        cfg = self.cfg
        return {
            "prefill_plan": list(self.prefill_plan),
            "decode_plan": list(self.decode_plan),
            "serve": dataclasses.asdict(self.serve),
            "config": {
                "num_experts": cfg.num_experts,
                "expert_top_k": cfg.expert_top_k,
                "hidden_size": cfg.hidden_size,
                "intermediate_size": cfg.intermediate_size,
                "num_layers": cfg.num_layers,
                "moe_backend": cfg.moe_backend,
                "serving_mode": cfg.serving_mode,
                "wire_dtype": cfg.wire_dtype,
                "a2a_chunks": cfg.a2a_chunks,
                "expert_quant": cfg.expert_quant,
                "kv_wire_dtype": cfg.kv_wire_dtype,
                "ep": cfg.ep,
            },
            "quant": self.quant_info,
            "tracing": self.tracer is not None,
            "replica": self.replica_tag,
            "pools": self.pools_info,
        }

    def close(self) -> None:
        """Tear down the live plane (the scrape server's thread, the
        tracer's listener).  Idempotent."""
        if self.telemetry is not None:
            self.telemetry.stop()
            self.telemetry = None
        if self.tracer is not None:
            self.tracer.uninstall()

    # ---- submission --------------------------------------------------

    def submit(self, req: Request, arrival_step: int = 0) -> None:
        # the bucketed full lifetime must fit the slot context, so an
        # evicted request's resumed (longer, re-bucketed) prompt plus its
        # remaining budget is covered by the same bound
        need = prompt_pad(len(req.prompt) + req.max_new_tokens,
                          self.serve.prompt_bucket)
        if need > self.serve.max_context:
            raise ValueError(
                f"request {req.rid}: bucketed prompt + max_new_tokens "
                f"({need}) exceeds the slot context "
                f"{self.serve.max_context} "
                f"(max_pages_per_slot x page_size)")
        # ... and the whole pool: a request the allocator can never serve
        # would park at the queue head and spin through max_steps
        need_pages = need // self.serve.page_size
        allocatable = (self.serve.num_pages // self.serve.ep_shards) - 1
        if need_pages > allocatable:
            raise ValueError(
                f"request {req.rid}: lifetime needs {need_pages} pages "
                f"but the pool only holds {allocatable} "
                f"allocatable pages"
                + (f" per shard (ep_shards={self.serve.ep_shards})"
                   if self.serve.ep_shards > 1 else ""))
        self.queue.append(_QueueEntry(int(arrival_step), req, req,
                                      None, None))
        self.stats["submitted"] += 1

    # ---- crash migration (the fabric's recovery path) ----------------

    def evacuate(self) -> tuple:
        """Crash evacuation (``flashmoe_tpu/serving/engine.py:1025``):
        every active slot goes back through the eviction path (its resumed
        prompt carries its delivered tokens, its pages free, its trace
        step span closes), then the whole queue is handed over.  Returns
        ``(inflight, queued)``: the evicted in-flight entries in admission
        order, and the entries that were still queued.  The engine is
        empty afterwards."""
        queued = list(self.queue)
        while self._evict_youngest():
            pass
        # evictions requeue at the front, youngest first: the front now
        # reads oldest-admitted .. youngest, then the queued entries
        inflight = list(self.queue)[:len(self.queue) - len(queued)]
        self.queue.clear()
        return inflight, queued

    def adopt(self, entry: _QueueEntry, *, front: bool = False) -> None:
        """Adopt a migrated queue entry from a crashed replica, keeping
        its arrival and first-token clocks and its resumed prompt.
        ``front=True`` resumes it ahead of local work, admittable at once
        (this engine's step counter may trail the dead replica's)."""
        if front:
            entry.arrival_step = min(entry.arrival_step, self.step_idx)
            self.queue.appendleft(entry)
        else:
            self.queue.append(entry)
        self.stats["adopted"] += 1

    # ---- internals ---------------------------------------------------

    def _active(self) -> list:
        return [i for i, s in enumerate(self.slots) if s is not None]

    def _decoding(self) -> list:
        """Occupied slots whose prefill has completed."""
        return [i for i, s in enumerate(self.slots)
                if s is not None and s.prefill_pos is None]

    # ---- shard-aware page accounting (ep_shards == 1: slots hold global
    # page ids; sharded: each slot belongs to the shard owning its row
    # block and holds shard-local ids, made global only at the whole-page
    # prefill writes) ---------------------------------------------------

    def _shard_of(self, slot: int) -> int:
        return slot // (self.serve.max_batch // self.serve.ep_shards)

    def _alloc_pages(self, slot: int, n: int):
        if self.serve.ep_shards > 1:
            return self.pool.alloc(n, self._shard_of(slot))
        return self.pool.alloc(n)

    def _free_slot_pages(self, slot: int, pages) -> None:
        if self.serve.ep_shards > 1:
            self.pool.free(pages, self._shard_of(slot))
        else:
            self.pool.free(pages)

    def _global_pages(self, slot: int, pages):
        if self.serve.ep_shards > 1:
            return self.pool.to_global(pages, self._shard_of(slot))
        return pages

    def _shard_free_pages(self, slot: int) -> int:
        if self.serve.ep_shards > 1:
            return self.pool.shard_free_pages(self._shard_of(slot))
        return self.pool.free_pages

    def _arrived_head(self) -> bool:
        return bool(self.queue) \
            and self.queue[0].arrival_step <= self.step_idx

    def _mark_arrivals(self) -> None:
        """Stamp the clock on every queue entry whose arrival step has
        been reached (the TTFT base); a future arrival accrues none."""
        now = self._clock()
        for entry in self.queue:
            if entry.arrival_s is None \
                    and entry.arrival_step <= self.step_idx:
                entry.arrival_s = now
                if self.tracer is not None:
                    self.tracer.on_arrival(entry.orig.rid)

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a), dtype=torch.long,
                               device=self.device)

    def _admit(self) -> None:
        sv = self.serve
        while self._arrived_head() and None in self.slots:
            entry = self.queue[0]
            req, orig = entry.req, entry.orig
            t0 = len(req.prompt)
            t_pad = prompt_pad(t0, sv.prompt_bucket)
            chunk = sv.prefill_chunk
            # a handed-off prefill is always whole: chunking applies to
            # the local path only
            chunked = (chunk is not None and t_pad > chunk
                       and self._prefill_fn is None)
            n_pages = (chunk if chunked else t_pad) // sv.page_size
            # the first free slot whose shard can hold the pages (LIFO
            # alloc never partially succeeds)
            slot = None
            for i, s in enumerate(self.slots):
                if s is None and self._shard_free_pages(i) >= n_pages:
                    slot = i
                    break
            if slot is None:
                break                      # head-of-line: deterministic
            pages = self._alloc_pages(slot, n_pages)
            self.queue.popleft()
            if self.tracer is not None:
                # closes the queued span and arms prefill attribution
                self.tracer.on_admit(orig.rid, self.step_idx,
                                     resumed=req is not orig)
            if chunked:
                # whole chunks; trailing all-pad chunks past the true end
                # never run (_advance_prefill stops at the last token's)
                t_pad_c = ((t_pad + chunk - 1) // chunk) * chunk
                toks = np.full((t_pad_c,), sv.pad_token, np.int64)
                toks[:t0] = req.prompt
                self.slots[slot] = _Slot(
                    req=req, orig=orig, pages=list(pages), length=0,
                    emitted=[], admit_step=self.step_idx,
                    arrival_s=entry.arrival_s,
                    first_token_s=entry.first_token_s,
                    prefill_pos=0, prefill_toks=toks)
                self.stats["prefill_buckets"].add(chunk)
            else:
                prompt = np.full((1, t_pad), sv.pad_token, np.int64)
                prompt[0, :t0] = req.prompt
                with trace_span("serve.prefill"):
                    if self._prefill_fn is not None:
                        logits, k_seq, v_seq = self._prefill_fn(
                            self._tensor(prompt), t0, rid=orig.rid)
                    else:
                        logits, k_seq, v_seq = _prefill_padded(
                            self.params, self.cfg, self._tensor(prompt), t0)
                    page_ids = self._tensor(self._global_pages(slot, pages))
                    store_prefill(self.cache.k_pages, k_seq, page_ids)
                    store_prefill(self.cache.v_pages, v_seq, page_ids)
                self._logits[slot] = logits
                self.slots[slot] = _Slot(
                    req=req, orig=orig, pages=list(pages), length=t0,
                    emitted=[], admit_step=self.step_idx,
                    arrival_s=entry.arrival_s,
                    first_token_s=entry.first_token_s)
                self.stats["prefill_buckets"].add(t_pad)
            self._rates["admits"].add()
            self.metrics.decision(
                "serve.admit", rid=orig.rid, step=self.step_idx,
                slot=slot, prompt_tokens=t0, pages=n_pages,
                resumed=req is not orig, chunked=chunked,
                queue_depth=len(self.queue))

    def _advance_prefill(self) -> None:
        """Advance every mid-prefill slot by exactly one chunk (slot
        order).  The chunk holding the prompt's last token finishes the
        prefill: its logits arm the sampler, and the slot joins this
        step's sampling pass."""
        sv = self.serve
        chunk = sv.prefill_chunk
        for i, s in enumerate(self.slots):
            if s is None or s.prefill_pos is None:
                continue
            pos = s.prefill_pos
            t0 = len(s.req.prompt)
            # this chunk's pages (the first chunk's came at admission);
            # eviction fallback as in _grow_pages
            need_pages = (pos + chunk) // sv.page_size
            while len(s.pages) < need_pages:
                got = self._alloc_pages(i, need_pages - len(s.pages))
                if got is not None:
                    s.pages.extend(got)
                    continue
                shard = (self._shard_of(i) if sv.ep_shards > 1
                         else None)
                if not self._evict_youngest(shard):
                    raise RuntimeError("page pool exhausted with no "
                                       "evictable request")
                if self.slots[i] is None:   # we evicted ourselves
                    break
            if self.slots[i] is None:
                continue
            n_ctx_pages = ctx_pages_bucket(
                pos + chunk, sv.page_size, sv.ctx_bucket_pages,
                sv.max_pages_per_slot)
            # the chunk addresses the global page slab (it runs outside
            # the EP ranks); scratch fill rows are masked
            gpages = self._global_pages(i, s.pages)
            table = np.full((n_ctx_pages,), SCRATCH_PAGE, np.int64)
            table[:len(gpages)] = gpages
            first_pg = pos // sv.page_size
            chunk_ids = gpages[first_pg:need_pages]
            rel_last = min(max(t0 - 1 - pos, 0), chunk - 1)
            toks = s.prefill_toks[pos:pos + chunk]
            if self.tracer is not None:
                # chunks interleave across slots: re-arm attribution
                self.tracer.on_prefill_chunk(s.orig.rid)
            with trace_span("serve.prefill_chunk"):
                logits, _, _ = _prefill_chunk(
                    self.params, self.cfg, self.cache.k_pages,
                    self.cache.v_pages, self._tensor(toks)[None, :],
                    self._tensor(table), self._tensor(chunk_ids), pos,
                    rel_last)
            s.prefill_pos = pos + chunk
            if pos <= t0 - 1 < pos + chunk:
                # prefill complete: arm the sampler, join decode
                self._logits[i] = logits
                s.prefill_pos = None
                s.prefill_toks = None
                s.length = t0

    def _evict_youngest(self, shard: int | None = None) -> bool:
        """Preempt the most recently admitted request back to the queue
        head; its pages free at once.  False when no active slot remains.
        ``shard`` restricts the victims to one page shard (only a
        same-shard eviction frees the pages the caller needs).  A request
        evicted mid-chunked-prefill resumes from scratch; delivered
        tokens ride the resumed prompt either way."""
        active = self._active()
        if shard is not None:
            active = [i for i in active if self._shard_of(i) == shard]
        if not active:
            return False
        victim = max(active, key=lambda i: (self.slots[i].admit_step,
                                            self.slots[i].req.rid))
        s = self.slots[victim]
        self._free_slot_pages(victim, s.pages)
        if self.tracer is not None:
            self.tracer.on_evict(s.orig.rid, self.step_idx)
        delivered = self._delivered(s)
        remaining = s.orig.max_new_tokens - delivered
        # the resumed prompt carries every delivered token (across any
        # number of evictions)
        resumed = dataclasses.replace(
            s.req,
            prompt=tuple(s.req.prompt) + tuple(s.emitted),
            max_new_tokens=max(remaining, 1))
        # requeued at the front; the arrival and first-token clocks
        # survive (the client already holds the delivered tokens)
        self.queue.appendleft(_QueueEntry(
            self.step_idx, resumed, s.orig, s.arrival_s,
            s.first_token_s))
        self.slots[victim] = None
        self.stats["evictions"] += 1
        self._rates["evictions"].add()
        self.metrics.count("serve.evictions")
        self.metrics.decision(
            "serve.evict", rid=s.orig.rid, step=self.step_idx,
            slot=victim, freed_pages=len(s.pages),
            emitted=delivered)
        return True

    def _delivered(self, s: _Slot) -> int:
        """Tokens delivered across incarnations."""
        return len(s.req.prompt) - len(s.orig.prompt) + len(s.emitted)

    def _grow_pages(self, span: int = 0) -> None:
        """Allocate the next page for every decoding slot whose write
        position crosses its allocated frontier, evicting the youngest
        request when the pool runs dry.  ``span`` extra positions (the
        verify step's drafts) are pre-covered; the target index clamps to
        the slot's table width."""
        shard = (self._shard_of if self.serve.ep_shards > 1
                 else lambda i: None)
        for i in list(self._decoding()):
            s = self.slots[i]
            if s is None:
                continue
            need_idx = min((s.length + span) // self.serve.page_size,
                           self.serve.max_pages_per_slot - 1)
            while need_idx >= len(s.pages):
                got = self._alloc_pages(i, 1)
                if got is not None:
                    s.pages.extend(got)
                    continue
                if not self._evict_youngest(shard(i)):
                    raise RuntimeError("page pool exhausted with no "
                                       "evictable request")
                if self.slots[i] is None:   # we evicted ourselves
                    break

    def _step_inputs(self, active, t_span: int):
        """Host-built inputs of a decode (``t_span`` 1) or verify step:
        (feed [B, T], positions [B], tables [B, n_ctx]); the gather width
        is bucketed on the longest active span."""
        sv = self.serve
        feed = np.full((sv.max_batch, t_span), sv.pad_token, np.int64)
        positions = np.zeros((sv.max_batch,), np.int64)
        tables = np.full((sv.max_batch, sv.max_pages_per_slot),
                         SCRATCH_PAGE, np.int64)
        longest = 1
        for i in active:
            s = self.slots[i]
            feed[i, 0] = s.emitted[-1]
            positions[i] = s.length
            tables[i, :len(s.pages)] = s.pages
            longest = max(longest, s.length + t_span)
        n_ctx = ctx_pages_bucket(longest, sv.page_size,
                                 sv.ctx_bucket_pages,
                                 sv.max_pages_per_slot)
        self.stats["decode_buckets"].add(n_ctx)
        return feed, positions, tables[:, :n_ctx]

    def _spec_decode(self, active) -> int | None:
        """Speculative decode step: draft, verify the span in one
        forward, emit the drafted prefix the engine's own sampler agrees
        with.  A draft at token index j is emitted iff it equals the
        canonical sample of index j, drawn from the verify span's column
        before it with (seed, j); the stream is therefore the
        non-speculative one for every sampling arm.

        Returns the number of extra tokens emitted (accepted drafts), or
        None when no slot drafted anything (the caller then runs the
        plain one-token step)."""
        sv = self.serve
        k = self._spec.draft_tokens
        drafts: dict[int, list] = {}
        with trace_span("serve.draft"):
            for i in active:
                s = self.slots[i]
                hist = list(s.req.prompt) + s.emitted
                if s.draft is None:
                    s.draft = DraftState(self._spec, hist)
                else:
                    s.draft.sync(hist)
                dr = s.draft.draft(k)
                # within the remaining token budget and the context
                # ceiling: every accepted draft's row lands in a page
                dr = dr[:max(0, s.orig.max_new_tokens
                             - self._delivered(s))]
                dr = dr[:max(0, sv.max_context - 1 - s.length)]
                if dr:
                    drafts[i] = [int(t) for t in dr]
        if not drafts:
            return None

        # pre-cover the span's write positions (may evict: re-fetch)
        self._grow_pages(span=k)
        active = self._decoding()
        if not active:
            return 0

        feed, positions, tables = self._step_inputs(active, k + 1)
        for i, dr in drafts.items():
            if self.slots[i] is not None:
                feed[i, 1:1 + len(dr)] = dr
        args = (self.cache.k_pages, self.cache.v_pages, self._tensor(feed),
                self._tensor(tables), self._tensor(positions))
        with trace_span("serve.verify"):
            if self._ep_shards is not None:
                span_logits, _, _ = _ep_verify_step(
                    self.params, self._ep_shards, self.cfg, self.mesh,
                    *args)
            else:
                span_logits, _, _ = _paged_verify_step(
                    self.params, self.cfg, *args)
        self._spec_steps += 1

        # the canonical sample of every drafted position: column t's
        # logits, token index delivered + t (emitted holds tok_0)
        cells = [(i, t) for i in active for t in range(len(drafts.get(i,
                                                                      ())))]
        cand = {}
        if cells:
            reqs = [self.slots[i].req for i, _ in cells]
            got = _sample_dynamic(
                span_logits[[i for i, _ in cells], [t for _, t in cells]],
                [r.seed for r in reqs],
                [self._delivered(self.slots[i]) + t for i, t in cells],
                [r.temperature for r in reqs], [r.top_k for r in reqs],
                [r.top_p for r in reqs]).tolist()
            cand = dict(zip(cells, got))

        # accept the agreeing prefix; roll back the rest
        n_extra = 0
        accepted_cols = np.zeros((sv.max_batch,), np.int64)
        for i in active:
            s = self.slots[i]
            dr = drafts.get(i, [])
            self._spec_drafted += len(dr)
            s.spec_drafted += len(dr)
            a = 0
            done = False
            for t in range(len(dr)):
                if cand[(i, t)] != dr[t]:
                    break
                tok = dr[t]
                s.emitted.append(tok)
                a += 1
                n_extra += 1
                done = (tok in s.req.stop_tokens
                        or self._delivered(s) >= s.orig.max_new_tokens)
                if done:
                    break
            self._spec_accepted += a
            s.spec_accepted += a
            accepted_cols[i] = a
            s.length += 1 + a
            # roll the block table back past the accepted frontier:
            # rejected-draft rows free their surplus pages (LIFO, so the
            # next growth redraws the same ids); rows inside kept pages
            # are overwritten by the next span before a mask exposes them
            keep = (s.length - 1) // sv.page_size + 1
            if keep < len(s.pages):
                surplus = s.pages[keep:]
                del s.pages[keep:]
                self._free_slot_pages(i, surplus)
            if done:
                self._retire(i, s)
        # pending logits: the column after each slot's last emitted token
        self._logits = span_logits[
            torch.arange(sv.max_batch, device=self.device),
            self._tensor(accepted_cols)]
        return n_extra

    def set_speculate(self, enabled: bool, *, reason=None) -> None:
        """Turn speculation on or off at a step boundary.  The token
        streams are unchanged either way."""
        if enabled and self.serve.speculate is None:
            raise ValueError(
                "cannot enable speculation: ServeConfig.speculate was "
                "never configured on this engine")
        was = self._spec is not None
        self._spec = self.serve.speculate if enabled else None
        if (self._spec is not None) != was:
            self.metrics.decision(
                "serve.spec",
                event="morph_on" if enabled else "morph_off",
                step=self.step_idx, reason=reason)

    def spec_snapshot(self) -> dict:
        """Acceptance statistics so far."""
        return dict(
            spec_stats_fields(self._spec_drafted, self._spec_accepted,
                              self._spec_steps),
            spec_steps=self._spec_steps,
            spec_on=self._spec is not None)

    def _retire(self, slot: int, s: _Slot) -> None:
        now = self._clock()
        self._free_slot_pages(slot, s.pages)
        self.slots[slot] = None
        out = (list(s.orig.prompt)
               + list(s.req.prompt[len(s.orig.prompt):])
               + list(s.emitted))
        self.outputs[s.orig.rid] = out
        self.stats["completed"] += 1
        n_tok = self._delivered(s)
        ttft_ms = ((s.first_token_s - s.arrival_s) * 1e3
                   if s.first_token_s is not None else None)
        tpot_ms = None
        if s.first_token_s is not None and n_tok > 1:
            tpot_ms = (now - s.first_token_s) * 1e3 / (n_tok - 1)
        if ttft_ms is not None:
            self.metrics.sketch("serve.ttft_ms", ttft_ms)
        if tpot_ms is not None:
            self.metrics.sketch("serve.tpot_ms", tpot_ms)
        # replica-keyed twins on the fabric's shared metrics object
        if self.replica_tag is not None:
            if ttft_ms is not None:
                self.metrics.sketch(f"serve.{self.replica_tag}.ttft_ms",
                                    ttft_ms)
            if tpot_ms is not None:
                self.metrics.sketch(f"serve.{self.replica_tag}.tpot_ms",
                                    tpot_ms)
        if self.tracer is not None:
            self.tracer.on_retire(s.orig.rid, self.step_idx,
                                  tokens=n_tok, ttft_ms=ttft_ms,
                                  tpot_ms=tpot_ms)
        spec_kw = {}
        if self.serve.speculate is not None:
            spec_kw = {
                "spec_drafted": s.spec_drafted,
                "spec_accepted": s.spec_accepted,
                "accept_rate": (round(s.spec_accepted / s.spec_drafted,
                                      6) if s.spec_drafted else None),
            }
        self.metrics.decision(
            "serve.retire", rid=s.orig.rid, step=self.step_idx,
            slot=slot, tokens=n_tok,
            ttft_ms=round(ttft_ms, 3) if ttft_ms is not None else None,
            tpot_ms=round(tpot_ms, 3) if tpot_ms is not None else None,
            **spec_kw)
        if self.recorder is not None:
            self.recorder.record(
                kind="serve_request", step=self.step_idx,
                rid=s.orig.rid, tokens=n_tok, ttft_ms=ttft_ms,
                tpot_ms=tpot_ms, **spec_kw)
        if self.watchdog is not None:
            dominant = None
            if self.tracer is not None:
                # name the critical path's largest component on any
                # breach this retirement raises
                from flashmoe_tpu_torch.telemetry_plane.attribution import (
                    attribute_track)

                dominant = attribute_track(
                    self.tracer.request_track(s.orig.rid))["dominant"]
            self.watchdog.observe_request(
                self.step_idx, s.orig.rid, ttft_ms=ttft_ms,
                tpot_ms=tpot_ms, dominant=dominant)

    # ---- the engine step ---------------------------------------------

    def step(self) -> dict:
        """One engine iteration: admit -> sample/retire -> decode.
        Returns the step's flight record (also appended to the recorder
        when one is attached)."""
        t0_s = self._clock()
        sv = self.serve
        if self.tracer is not None:
            # the step window opens before admissions: everything in this
            # step rides a serve.step span on each active request's track
            self.tracer.begin_step(
                self.step_idx,
                [self.slots[i].orig.rid for i in self._active()])
        self._mark_arrivals()
        self._admit()
        self._beat("admit")
        self._advance_prefill()
        self._beat("prefill")

        # sample each decoding slot's next token from its pending logits
        # (slots mid-chunked-prefill have none yet)
        emitted_now = 0
        active = self._decoding()
        if active:
            reqs = [self.slots[i].req for i in active]
            toks = _sample_dynamic(
                self._logits[self._tensor(active)],
                [r.seed for r in reqs],
                [self._delivered(self.slots[i]) for i in active],
                [r.temperature for r in reqs], [r.top_k for r in reqs],
                [r.top_p for r in reqs]).tolist()
            now = self._clock()
            for i, tok in zip(active, toks):
                s = self.slots[i]
                s.emitted.append(tok)
                emitted_now += 1
                if s.first_token_s is None:
                    s.first_token_s = now
                done = (tok in s.req.stop_tokens
                        or self._delivered(s) >= s.orig.max_new_tokens)
                if done:
                    self._retire(i, s)
        self.stats["tokens"] += emitted_now
        self._beat("sample")

        # feed the survivors one decode step: speculative (draft + span
        # verify, possibly emitting extra tokens) when armed and anything
        # drafted, else the plain one-token step
        active = self._decoding()
        if active:
            self._grow_pages()
            active = self._decoding()
        n_extra = None
        if active and self._spec is not None:
            n_extra = self._spec_decode(active)
            if n_extra is not None:
                emitted_now += n_extra
                self.stats["tokens"] += n_extra
        if active and n_extra is None:
            feed, positions, tables = self._step_inputs(active, 1)
            args = (self.cache.k_pages, self.cache.v_pages,
                    self._tensor(feed[:, 0]), self._tensor(tables),
                    self._tensor(positions))
            with trace_span("serve.decode"):
                if self._ep_shards is not None:
                    self._logits, _, _ = _ep_decode_step(
                        self.params, self._ep_shards, self.cfg, self.mesh,
                        *args)
                else:
                    self._logits, _, _ = _paged_decode_step(
                        self.params, self.cfg, *args)
            for i in active:
                self.slots[i].length += 1
        self._beat("decode")

        if self._vclock is not None:
            # the decode tick is charged inside the step window: a step
            # lasts max(tick, its handoffs) of virtual time
            self._vclock.complete_step()
        if self.tracer is not None:
            self.tracer.end_step()
        step_ms = (self._clock() - t0_s) * 1e3
        n_active = len(self._active())
        qd = len(self.queue)
        occ = self.pool.occupancy
        self.stats["steps"] += 1
        self.stats["max_queue_depth"] = max(self.stats["max_queue_depth"],
                                            qd)
        self.stats["max_active"] = max(self.stats["max_active"], n_active)
        self.stats["peak_occupancy"] = max(self.stats["peak_occupancy"],
                                           occ)
        self.metrics.gauge("serve.queue_depth", qd)
        self.metrics.gauge("serve.active_requests", n_active)
        self.metrics.gauge("serve.cache_occupancy", occ)
        self.metrics.sketch("serve.step_ms", step_ms)
        self.metrics.sketch("serve.queue_depth_dist", qd)
        self.metrics.gauge("serve.tokens_per_s",
                           self._rates["tokens"].add(emitted_now))
        self.metrics.gauge("serve.admits_per_s",
                           self._rates["admits"].rate())
        self.metrics.gauge("serve.evictions_per_s",
                           self._rates["evictions"].rate())
        rec = {
            "kind": "serve_step", "step": self.step_idx,
            "active": n_active, "queue_depth": qd,
            "pages_used": self.pool.used_pages,
            "cache_occupancy": round(occ, 4),
            "tokens": emitted_now,
            "completed": self.stats["completed"],
            "step_ms": round(step_ms, 3),
        }
        if self.serve.speculate is not None:
            rec["spec_tokens"] = int(n_extra or 0)
            rec["spec_on"] = self._spec is not None
        if self.recorder is not None:
            self.recorder.record(**rec)
        if self.watchdog is not None:
            self.watchdog.observe_step(self.step_idx, step_ms)
        self.step_idx += 1
        self._beat("end")
        return rec

    def _beat(self, phase: str) -> None:
        if self._heartbeat is not None:
            self._heartbeat(phase)

    # ---- running to completion ---------------------------------------

    def pending(self) -> bool:
        return bool(self.queue) or bool(self._active())

    def run(self, requests=None, arrivals=None, *, until=None) -> dict:
        """Drive to completion.  ``requests``: iterable of
        :class:`Request`; ``arrivals``: their arrival steps (default all
        0).  ``until``: an optional zero-argument predicate that pauses
        the drive when it turns true (a mid-run scrape; ``run()`` again
        finishes), as JAX's engine takes it.  Returns {rid: full token
        list (prompt + generated)}."""
        for idx, req in enumerate(requests or ()):
            self.submit(req, int(arrivals[idx]) if arrivals else 0)
        while self.pending() and not (until is not None and until()):
            if self.step_idx >= self.serve.max_steps:
                raise RuntimeError(
                    f"engine exceeded max_steps={self.serve.max_steps} "
                    f"with work pending")
            self.step()
        return dict(self.outputs)

    def summary(self) -> dict:
        s = dict(self.stats)
        s["decode_buckets"] = sorted(s["decode_buckets"])
        s["prefill_buckets"] = sorted(s["prefill_buckets"])
        tt = self.metrics.sketches.get("serve.ttft_ms")
        if tt is not None and tt.n:
            s["ttft_ms_mean"] = round(tt.mean, 3)
            s["ttft_ms_max"] = round(tt.max, 3)
            s["ttft_ms_p99"] = round(tt.quantile(0.99), 3)
        tp = self.metrics.sketches.get("serve.tpot_ms")
        if tp is not None and tp.n:
            s["tpot_ms_mean"] = round(tp.mean, 3)
        if self.serve.speculate is not None:
            s.update(self.spec_snapshot())
        s["decode_plan"] = list(self.decode_plan)
        s["prefill_plan"] = list(self.prefill_plan)
        if self.quant_info is not None:
            s["expert_quant"] = self.quant_info["expert_quant"]
            s["quant_freed_mb"] = round(
                self.quant_info["freed_bytes"] / 2**20, 3)
            s["quant_extra_kv_pages"] = self.quant_info["extra_kv_pages"]
        return s
