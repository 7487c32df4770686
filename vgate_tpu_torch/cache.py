"""Async LRU result cache.

Mirrors the reference's cache contract (vgate/cache.py:28-104): keys are
``sha256(prompt|temperature|top_p|max_tokens)[:16]`` (cache.py:48-56), an
``OrderedDict`` under an asyncio lock provides LRU semantics with eviction at
``max_size`` (cache.py:85-89), and hit/miss/eviction stats are exported
(cache.py:94-104).
"""

from __future__ import annotations

import asyncio
import hashlib
from collections import OrderedDict
from typing import Any, Dict, List, Optional

from vgate_tpu_torch import metrics
from vgate_tpu_torch.tracing import get_tracer

tracer = get_tracer(__name__)


class ResultCache:
    def __init__(self, max_size: int = 1024, enabled: bool = True) -> None:
        self.max_size = max_size
        self.enabled = enabled
        self._store: "OrderedDict[str, Any]" = OrderedDict()
        self._lock = asyncio.Lock()
        self._hits = 0
        self._misses = 0
        self._evictions = 0

    @staticmethod
    def make_key(  # noqa: PLR0913 — mirrors the sampling surface
        prompt: str,
        temperature: float,
        top_p: float,
        max_tokens: int,
        top_k: int = 0,
        stop: Optional[List[str]] = None,
        seed: Optional[int] = None,
        logprobs=None,
        variant: int = 0,
        penalties=None,
        stop_token_ids: Optional[List[int]] = None,
        min_tokens: int = 0,
        logit_bias=None,
    ) -> str:
        """Stable digest over the request-identity fields (reference:
        vgate/cache.py:48-56; top_k/stop/seed/logprobs/logit_bias added
        for the TPU sampler — they change the result, so they must
        change the key; ``variant`` salts the i-th of an n-choices
        request so the n submissions don't dedup into one generation)."""
        blob = (
            f"{prompt}|{temperature}|{top_p}|{max_tokens}|{top_k}"
            f"|{stop or []}|{seed}|{logprobs}|{variant}|{penalties}"
            f"|{stop_token_ids or []}|{min_tokens}|{logit_bias}"
        )
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    async def get(self, key: str) -> Optional[Any]:
        if not self.enabled:
            return None
        with tracer.start_as_current_span("cache.get"):
            async with self._lock:
                if key in self._store:
                    self._store.move_to_end(key)
                    self._hits += 1
                    metrics.CACHE_HITS.inc()
                    return self._store[key]
                self._misses += 1
                metrics.CACHE_MISSES.inc()
                return None

    async def put(self, key: str, value: Any) -> None:
        if not self.enabled:
            return
        with tracer.start_as_current_span("cache.put"):
            async with self._lock:
                if key in self._store:
                    self._store.move_to_end(key)
                self._store[key] = value
                while len(self._store) > self.max_size:
                    self._store.popitem(last=False)
                    self._evictions += 1
                    metrics.CACHE_EVICTIONS.inc()
                metrics.CACHE_SIZE.set(len(self._store))

    async def clear(self) -> None:
        async with self._lock:
            self._store.clear()
            metrics.CACHE_SIZE.set(0)

    def get_stats(self) -> Dict[str, Any]:
        total = self._hits + self._misses
        return {
            "enabled": self.enabled,
            "size": len(self._store),
            "max_size": self.max_size,
            "hits": self._hits,
            "misses": self._misses,
            "evictions": self._evictions,
            "hit_rate": (self._hits / total) if total else 0.0,
        }
