"""Paged KV cache: block-table indirection over a fixed page pool.

Counterpart of ``flashmoe_tpu/serving/kvcache.py``:

* the device holds one fixed pool ``[L, P, N_kv, page, D]`` of KV pages
  (:class:`PagedKVCache`), written in place;
* each request owns a list of page ids (its block table); position ``t``
  of a request lives in page ``table[t // page]``, row ``t % page``:
  integer indirection, scattered with ``index_put_`` / ``index_copy_``
  and gathered with ``index_select``;
* a host-side LIFO free list (:class:`PagePool`) hands pages out and
  takes them back on retirement and eviction, so page placement is a
  pure function of the alloc/free sequence;
* attention reads a bucketed number of pages (:func:`ctx_pages_bucket`),
  so the gather widths come from a small set.

Page 0 is the scratch page (:data:`SCRATCH_PAGE`): never allocated, it
takes the KV writes of inactive batch slots (their block tables point
every entry at it) and backs the unallocated block-table entries of
active requests, which the per-request length mask reads back with
exactly zero attention weight.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from flashmoe_tpu_torch.config import MoEConfig

#: page id reserved as the write target of inactive slots and the backing
#: of unallocated block-table entries: never handed out by
#: :class:`PagePool`, never read back with non-zero attention weight
SCRATCH_PAGE = 0


class PagedKVCache(NamedTuple):
    """The device-side page pool.  ``k_pages`` / ``v_pages``:
    ``[L, P, N_kv, page, D]``.  Block tables and lengths live on the host
    (the engine's slot state) and ride into each step as index tensors."""

    k_pages: torch.Tensor
    v_pages: torch.Tensor

    @property
    def num_pages(self) -> int:
        return self.k_pages.shape[1]

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[3]


def init_paged_cache(cfg: MoEConfig, num_pages: int, page_size: int,
                     device="cuda") -> PagedKVCache:
    """Allocate the pool on ``device``.  ``num_pages`` includes the
    scratch page."""
    if num_pages < 2:
        raise ValueError(f"num_pages={num_pages} must be >= 2 (page 0 "
                         f"is the reserved scratch page)")
    if page_size < 1:
        raise ValueError(f"page_size={page_size} must be >= 1")
    shape = (cfg.num_layers, num_pages, cfg.resolved_num_kv_heads,
             page_size, cfg.resolved_head_dim)
    return PagedKVCache(
        torch.zeros(shape, dtype=cfg.dtype, device=device),
        torch.zeros(shape, dtype=cfg.dtype, device=device))


# ----------------------------------------------------------------------
# Page ops of the engine's device steps (in place)
# ----------------------------------------------------------------------

def store_token(pages, token_kv, page_ids, rows):
    """Scatter one decode step's per-slot K (or V) into its pages, in
    place.  pages: ``[P, N_kv, page, D]`` (one layer's pool); token_kv:
    ``[B, N_kv, D]``; page_ids / rows: ``[B]`` int64 (inactive slots pass
    ``SCRATCH_PAGE`` / 0; their duplicate writes race, but scratch rows
    are never read back with non-zero weight).  Returns ``pages``."""
    pages[page_ids, :, rows] = token_kv.to(pages.dtype)
    return pages


def store_tokens(pages, span_kv, page_ids, rows):
    """Scatter a verify step's span into its pages, in place: the
    multi-position twin of :func:`store_token`.  span_kv:
    ``[B, T, N_kv, D]``; page_ids / rows: ``[B, T]``.  The two index
    tensors are split by the head axis's slice, so the broadcast
    ``[B, T]`` dims lead the indexed result, which aligns with
    ``span_kv``."""
    pages[page_ids, :, rows] = span_kv.to(pages.dtype)
    return pages


def gather_ctx(pages, block_tables):
    """Each slot's context window from its pages.  pages:
    ``[P, N_kv, page, D]``; block_tables: ``[B, n]`` page ids (already cut
    to the bucketed page count).  Returns ``[B, N_kv, n * page, D]``: rows
    past a request's length are scratch or stale and must be masked by
    the caller's length mask."""
    b, n = block_tables.shape
    _, nkv, page, d = pages.shape
    g = pages.index_select(0, block_tables.reshape(-1))
    return g.view(b, n, nkv, page, d).transpose(1, 2).reshape(
        b, nkv, n * page, d)


def store_prefill(pages, seq_kv, page_ids):
    """Scatter a prefilled dense K (or V) run into its pages, every layer
    at once, in place.  pages: ``[L, P, N_kv, page, D]``; seq_kv:
    ``[L, N_kv, T_pad, D]`` with ``T_pad = len(page_ids) * page``;
    page_ids: ``[n]``.  Rows past the true prompt length are garbage the
    length mask never exposes."""
    l, nkv, t_pad, d = seq_kv.shape
    n = page_ids.shape[0]
    page = pages.shape[3]
    if t_pad != n * page:
        raise ValueError(f"prefill run of {t_pad} rows does not fill "
                         f"{n} pages of {page}")
    chunks = seq_kv.reshape(l, nkv, n, page, d).transpose(1, 2)
    pages.index_copy_(1, page_ids, chunks.to(pages.dtype))
    return pages


# ----------------------------------------------------------------------
# Bucketed gather widths
# ----------------------------------------------------------------------

def ctx_pages_bucket(max_tokens: int, page_size: int, bucket_pages: int,
                     max_pages: int) -> int:
    """The number of pages the decode step gathers for a batch whose
    longest request spans ``max_tokens`` written positions: rounded up to
    ``bucket_pages`` granularity, clamped to ``max_pages``."""
    if max_tokens < 1:
        max_tokens = 1
    pages = -(-max_tokens // page_size)
    pages = -(-pages // bucket_pages) * bucket_pages
    return min(max(pages, bucket_pages), max_pages)


def prompt_pad(t0: int, bucket: int) -> int:
    """Prompt length padded to the prefill bucket."""
    return -(-max(t0, 1) // bucket) * bucket


# ----------------------------------------------------------------------
# Host-side page allocator
# ----------------------------------------------------------------------

class PagePool:
    """Deterministic LIFO free list over pages ``1..num_pages-1`` (page 0
    is scratch): allocation order is a pure function of the alloc/free
    call sequence, which the engine derives from its arrival trace."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError(f"num_pages={num_pages} must be >= 2")
        self.num_pages = num_pages
        # LIFO: lowest ids on top first, and freed pages come back on
        # top, so an evictee's pages are the next admission's
        self._free = list(range(num_pages - 1, 0, -1))

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return (self.num_pages - 1) - len(self._free)

    @property
    def occupancy(self) -> float:
        """Allocated fraction of the allocatable pool (scratch excluded)."""
        total = self.num_pages - 1
        return self.used_pages / total if total else 0.0

    def alloc(self, n: int) -> list[int] | None:
        """Pop ``n`` pages, or ``None`` (no partial allocation) when fewer
        remain: the caller then defers admission or evicts."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} pages")
        if n > len(self._free):
            return None
        return [self._free.pop() for _ in range(n)]

    def free(self, pages) -> None:
        """Return pages to the pool (in reverse, so re-allocating the same
        count yields the ids the evictee held, in order)."""
        for p in reversed(list(pages)):
            if not 0 < p < self.num_pages:
                raise ValueError(f"page id {p} out of range")
            if p in self._free:
                raise ValueError(f"double free of page {p}")
            self._free.append(p)


class ShardedPagePool:
    """The EP-sharded twin of :class:`PagePool`: the slab is cut into
    ``shards`` equal contiguous blocks, one per expert-parallel rank,
    each with its own LIFO free list over shard-local ids.  Each shard's
    local page 0 is its own scratch page; :meth:`to_global` maps local
    ids to slab-global ones for the whole-page writes of prefill."""

    def __init__(self, num_pages: int, shards: int):
        if shards < 1:
            raise ValueError(f"shards={shards} must be >= 1")
        if num_pages % shards:
            raise ValueError(f"num_pages={num_pages} must divide "
                             f"evenly across {shards} shards")
        self.num_pages = num_pages
        self.shards = shards
        self.pages_per_shard = num_pages // shards
        if self.pages_per_shard < 2:
            raise ValueError(
                f"num_pages={num_pages} leaves fewer than 2 pages per "
                f"shard across {shards} shards (each shard reserves "
                f"its own scratch page)")
        self._pools = [PagePool(self.pages_per_shard)
                       for _ in range(shards)]

    @property
    def free_pages(self) -> int:
        return sum(p.free_pages for p in self._pools)

    @property
    def used_pages(self) -> int:
        return sum(p.used_pages for p in self._pools)

    @property
    def occupancy(self) -> float:
        total = self.num_pages - self.shards   # one scratch per shard
        return self.used_pages / total if total else 0.0

    def shard_free_pages(self, shard: int) -> int:
        return self._pools[shard].free_pages

    def alloc(self, n: int, shard: int) -> list[int] | None:
        """Pop ``n`` shard-local ids from ``shard``'s free list (``None``
        on shortfall: no partial allocation, no spill to another shard)."""
        return self._pools[shard].alloc(n)

    def free(self, pages, shard: int) -> None:
        self._pools[shard].free(pages)

    def to_global(self, pages, shard: int) -> list[int]:
        """Shard-local -> slab-global ids."""
        base = shard * self.pages_per_shard
        return [base + int(p) for p in pages]
