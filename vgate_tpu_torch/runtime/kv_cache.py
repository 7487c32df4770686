"""Paged KV cache: geometry, page allocator and device buffers.

Layout: ``[num_layers, kv_heads, num_pages, page_size, head_dim]`` per K
and V (int8 pools add a bf16 scale pool of the same shape minus
head_dim, ops/kv_quant.py), head-major so one page of one head is a
contiguous ``(page_size, head_dim)`` tile — the unit the paged-decode kernel reads
(vgate_tpu_torch/csrc/paged_decode.cu).  **Page 0 is a reserved trash
page** that absorbs writes from padded positions and idle decode slots
so device code never branches on validity; it is never read as live
context.  The allocator is the reference's host-side policy, unchanged.
"""

from __future__ import annotations

from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional

import torch

from vgate_tpu_torch import faults
from vgate_tpu_torch.logging_config import get_logger
from vgate_tpu_torch.models.specs import ModelSpec
from vgate_tpu_torch.ops.kv_quant import SCALE_DTYPE, QuantPages
from vgate_tpu_torch.runtime import engine_metrics as metrics
from vgate_tpu_torch.utils.math import cdiv

logger = get_logger(__name__)


def _page_bytes(
    num_layers: int, page_size: int, kv_heads: int, head_dim: int,
    dtype_bytes: int, scale_bytes: int = 0,
) -> int:
    """Bytes one page occupies across all layers, K and V together — the
    single source of truth for page sizing (used by both KVGeometry and
    auto_num_pages).  ``scale_bytes`` is the per-token-per-head
    quantization-scale overhead (0 for plain bf16/f32 pools; int8 KV
    stores one bf16 scale per (page, head, slot) — ops/kv_quant.py)."""
    return (
        2 * num_layers * page_size * kv_heads
        * (head_dim * dtype_bytes + scale_bytes)
    )


@dataclass(frozen=True)
class KVGeometry:
    num_layers: int
    num_pages: int  # includes the reserved trash page(s)
    page_size: int
    kv_heads: int
    head_dim: int
    max_model_len: int
    dtype_bytes: int = 2  # bf16 default
    # reserved trash pages: 1 normally, sp under sequence-parallel decode
    # (one local trash per pool shard, parallel/sp_decode.py)
    num_reserved: int = 1
    # per-token-per-head scale bytes: 0 for plain pools, 2 (bf16) for
    # int8 KV (kv_cache.dtype: int8 — ops/kv_quant.py)
    scale_bytes: int = 0
    # reporting name for /stats, drills and bench artifacts
    kv_dtype: str = "bf16"
    # sequence parallelism: the pool's page axis shards contiguously over
    # this many ranks, each holding ``local_pages`` of the ``num_pages``
    # global pages (parallel/sp_decode.py)
    shards: int = 1

    @property
    def local_pages(self) -> int:
        """Pages this rank's pool holds."""
        return self.num_pages // self.shards

    @property
    def pages_per_seq(self) -> int:
        return cdiv(self.max_model_len, self.page_size)

    @property
    def page_bytes(self) -> int:
        return _page_bytes(
            self.num_layers, self.page_size, self.kv_heads, self.head_dim,
            self.dtype_bytes, self.scale_bytes,
        )

    @property
    def total_tokens(self) -> int:
        return (self.num_pages - self.num_reserved) * self.page_size


def reserved_page_ids(num_pages: int, sp: int) -> list:
    """Global ids of the per-shard trash pages (local page 0 of each
    contiguous shard block).  sp == 1 degenerates to [0]."""
    shard = num_pages // max(1, sp)
    return [i * shard for i in range(max(1, sp))]


def auto_num_pages(
    spec: ModelSpec,
    page_size: int,
    hbm_utilization: float,
    device: torch.device,
    dtype_bytes: int = 2,
    fallback: int = 512,
    hard_cap: int = 65536,
    scale_bytes: int = 0,
    budget_bytes: Optional[int] = None,
) -> int:
    """Size the page pool from the device memory still free once weights
    are resident (the serving analogue of vLLM's gpu_memory_utilization).

    On CUDA the budget is ``torch.cuda.mem_get_info``: the free bytes
    minus the share of the card ``hbm_utilization`` leaves unused; the
    allocator's cached blocks (a weight init's fp32 temporaries) are
    released first, so they count as free.  On
    the CPU (tests) the pool is ``fallback`` pages.  There is no guessed
    per-card default: a CUDA device always reports its memory.
    ``budget_bytes`` sizes against that many bytes instead, on any
    device.  ``dtype_bytes`` is the KV element width and ``scale_bytes``
    the per-token-per-head quantization-scale overhead (int8 KV: 1 and 2,
    so one budget holds ~1.97x the bf16 page count at head_dim 128).
    """
    if budget_bytes is None:
        if device.type != "cuda":
            return fallback
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info(device)
        budget_bytes = max(0, free - (1.0 - hbm_utilization) * total)
    page_bytes = _page_bytes(
        spec.num_layers, page_size, spec.num_kv_heads, spec.head_dim,
        dtype_bytes, scale_bytes,
    )
    pages = int(budget_bytes // page_bytes)
    return max(16, min(pages, hard_cap))


class PageAllocator:
    """Refcounting free-list allocator with a content-hash index for
    **automatic prefix caching**.

    Page 0 is the reserved trash page; with ``num_shards`` (sp) > 1 the
    first page of each contiguous pool shard ``{i * num_pages/sp}`` is
    reserved instead, so every sp shard has a LOCAL trash page
    (parallel/sp_decode.py) — the degenerate num_shards=1 case reserves
    exactly {0}.

    A page whose content corresponds to a full page of prompt tokens can be
    ``register``ed under a chain hash; a later prompt with the same prefix
    ``lookup``s the hash and shares the page (refcount++) instead of
    recomputing its KV.  Pages released to refcount 0 keep their content and
    park in an LRU of *evictable* cached pages — reusable until ``allocate``
    needs the space (vLLM's automatic-prefix-caching capability, which the
    reference can't reach because vLLM hides it; here it is first-party).
    """

    def __init__(self, num_pages: int, num_shards: int = 1) -> None:
        self.num_pages = num_pages
        self.reserved = frozenset(reserved_page_ids(num_pages, num_shards))
        self._free: Deque[int] = deque(
            p for p in range(num_pages) if p not in self.reserved
        )
        self._refs: Dict[int, int] = {}
        self._hash_to_page: Dict[int, int] = {}
        self._page_hash: Dict[int, int] = {}
        # refcount-0 pages with live cached content, in LRU order
        self._evictable: "OrderedDict[int, None]" = OrderedDict()
        # radix-tree prefix cache (runtime/radix_cache.py): holds its own
        # references on cached pages and reclaims them on demand when
        # the free list runs short — the tree-mode replacement for the
        # flat _evictable LRU above
        self._reclaimer = None
        self.prefix_hits = 0
        self.prefix_evictions = 0
        # set by the engine when the pool stores int8 KV (kv_cache.dtype:
        # int8): every in-use page then holds quantized content, and the
        # vgt_kv_quantized_pages gauge tracks it alongside KV_PAGES_IN_USE
        self.quantized = False
        self._allocatable = num_pages - len(self.reserved)
        metrics.KV_PAGES_TOTAL.set(self._allocatable)
        self._set_in_use(0)

    def _set_in_use(self, used: int) -> None:
        metrics.KV_PAGES_IN_USE.set(used)
        metrics.KV_QUANTIZED_PAGES.set(used if self.quantized else 0)

    def set_reclaimer(self, reclaimer) -> None:
        """Attach a cache that can free refcounted pages on demand
        (``evictable_pages() -> int`` and ``reclaim(n) -> int freed``).
        Reclaimable pages count as obtainable in ``num_free``."""
        self._reclaimer = reclaimer

    @property
    def num_allocatable(self) -> int:
        """Total non-reserved pages (the pool size stats should report)."""
        return self._allocatable

    @property
    def num_free(self) -> int:
        """Pages obtainable by allocate(): truly free + evictable cached
        (flat LRU or reclaimable radix-tree pages)."""
        return len(self._free) + self.num_cached

    @property
    def num_truly_free(self) -> int:
        """Pages obtainable without evicting cache — the proactive-trim
        watermark (radix_cache.trim_to_watermark) keys off this so
        eviction cost is paid ahead of the allocation hot path."""
        return len(self._free)

    @property
    def num_used(self) -> int:
        return self._allocatable - self.num_free

    @property
    def num_cached(self) -> int:
        if self._reclaimer is not None:
            return self._reclaimer.evictable_pages()
        return len(self._evictable)

    def allocate(self, n: int) -> Optional[List[int]]:
        """All-or-nothing allocation of n pages; None when insufficient.
        Evicts least-recently-used cached pages when the free list runs
        short."""
        faults.check("kv_alloc", payload=n)
        if n > self.num_free:
            return None
        if self._reclaimer is not None:
            short = n - len(self._free)
            if short > 0 and self._reclaimer.reclaim(short) < short:
                # a reclaimable page was still referenced (lock races
                # are excluded by design; defensive all-or-nothing)
                return None  # pragma: no cover - lock invariant holds
        pages = []
        for _ in range(n):
            if self._free:
                page = self._free.popleft()
            else:  # evict the LRU cached page (flat-chain mode)
                page, _ = self._evictable.popitem(last=False)
                self._drop_hash(page)
                self.prefix_evictions += 1
                metrics.PREFIX_EVICTIONS.labels(reason="lru").inc()
            self._refs[page] = 1
            pages.append(page)
        self._set_in_use(self.num_used)
        return pages

    def refcount(self, page: int) -> int:
        """Live reference count of a page (0 = free/parked)."""
        return self._refs.get(page, 0)

    def retain(self, pages: List[int]) -> None:
        """Take an extra reference on already-allocated pages (prefix
        sharing: the radix tree and each matching sequence hold their
        own reference; release() drops them symmetrically)."""
        for page in pages:
            refs = self._refs.get(page, 0)
            if refs <= 0:
                # a retained page must already be live — retaining a
                # free page would let allocate() hand it out again
                raise ValueError(f"retain of unreferenced page {page}")
            self._refs[page] = refs + 1
        self._set_in_use(self.num_used)

    def release(self, pages: List[int]) -> None:
        for page in pages:
            if not 0 <= page < self.num_pages or page in self.reserved:
                raise ValueError(f"bad page id {page}")
            refs = self._refs.get(page, 1) - 1
            if refs > 0:
                self._refs[page] = refs
                continue
            self._refs.pop(page, None)
            if page in self._page_hash:
                # content stays reusable until evicted
                self._evictable[page] = None
                self._evictable.move_to_end(page)
            else:
                self._free.append(page)
        self._set_in_use(self.num_used)
        if self._reclaimer is None and self._page_hash:
            metrics.PREFIX_CACHED_PAGES.set(len(self._evictable))

    # ----------------------------------------------------- prefix caching

    def register(self, page: int, content_hash: int) -> None:
        """Index a page's content under its prefix-chain hash.  On a hash
        collision with a live mapping, the existing page wins (both hold
        identical content by construction)."""
        if content_hash in self._hash_to_page:
            return
        self._hash_to_page[content_hash] = page
        self._page_hash[page] = content_hash

    def peek(self, content_hash: int) -> Optional[int]:
        """Check whether a page is cached for this hash WITHOUT taking a
        reference (scheduler admissibility probes must not mutate
        refcounts)."""
        return self._hash_to_page.get(content_hash)

    def is_evictable(self, page: int) -> bool:
        """True when the page is parked in the refcount-0 LRU: a prefix
        lookup() would revive it OUT of the allocatable pool, so
        admissibility math must not count it as free AND matched."""
        return page in self._evictable

    def lookup(self, content_hash: int) -> Optional[int]:
        """Find a cached page for this hash and take a reference to it."""
        page = self._hash_to_page.get(content_hash)
        if page is None:
            return None
        if page in self._evictable:  # revive a parked page
            del self._evictable[page]
            self._refs[page] = 1
            metrics.PREFIX_CACHED_PAGES.set(len(self._evictable))
        else:
            self._refs[page] = self._refs.get(page, 0) + 1
        self._set_in_use(self.num_used)
        return page

    def _drop_hash(self, page: int) -> None:
        h = self._page_hash.pop(page, None)
        if h is not None and self._hash_to_page.get(h) == page:
            del self._hash_to_page[h]


def make_kv_buffers(
    geometry: KVGeometry, dtype: torch.dtype, device: torch.device
):
    """Allocate the K/V page pools directly on ``device``: zeros of
    ``dtype``, or with ``geometry.kv_dtype == "int8"`` two
    :class:`~vgate_tpu_torch.ops.kv_quant.QuantPages` (int8 data zeroed,
    bf16 scales set to 1, as the reference's).

    The pools are updated IN PLACE by every forward (the reference
    donates them through each jitted call instead); all writers and
    readers run on one CUDA stream, so stream order is the only
    ordering the engine relies on."""
    shape = (
        geometry.num_layers,
        geometry.kv_heads,
        geometry.local_pages,
        geometry.page_size,
        geometry.head_dim,
    )
    if geometry.kv_dtype == "int8":

        def pool():
            return QuantPages(
                torch.zeros(shape, dtype=torch.int8, device=device),
                torch.ones(shape[:-1], dtype=SCALE_DTYPE, device=device),
            )

        k, v = pool(), pool()
        nbytes = 2 * sum(
            t.numel() * t.element_size() for t in (k.data, k.scale)
        )
    else:
        k = torch.zeros(shape, dtype=dtype, device=device)
        v = torch.zeros(shape, dtype=dtype, device=device)
        nbytes = 2 * k.numel() * k.element_size()
    logger.info(
        "kv cache allocated",
        extra={
            "extra_data": {
                "pages": geometry.local_pages,
                "tokens_capacity": geometry.total_tokens,
                "kv_dtype": geometry.kv_dtype,
                "mb": round(nbytes / 1e6),
            }
        },
    )
    return k, v
