"""Overload protection: token-budget admission control, priority
tiers, and the adaptive brownout pressure controller.

Before this subsystem, admission was unconditionally FIFO: every
request was enqueued however deep the queue or full the KV pool, so a
traffic spike became unbounded queue growth and mass deadline 504s —
work was shed only *after* it had been accepted.  The pieces here make
the server refuse work it cannot finish and degrade gracefully:

* :class:`AdmissionController` — estimates each request's cost
  (prompt tokens + ``max_tokens``) at submit time, tracks the
  admitted-but-unsettled token backlog and an EWMA of observed decode
  throughput, and rejects with a typed error (503 + ``Retry-After``,
  or 429 for the per-key in-flight cap) when a limit is hit.  Limits
  are tier-scaled so the **batch** tier sheds first and
  **interactive** last (strict-priority shedding).
* :class:`TierQueue` — the gateway batcher's priority-tiered queue
  with weighted dequeue (``admission.tier_weights`` per fill cycle).
* :class:`PressureController` — a small hysteresis state machine over
  a composite pressure score (predicted queue wait, KV occupancy,
  recent shed rate) that walks through declared degradation steps:
  clamp ``max_tokens`` → shrink the batch window → disable
  speculative decoding → bypass result-cache writes — and restores
  them one level at a time once the score has stayed low for
  ``admission.brownout_hold_s``.

Pure host-side policy, no JAX, no asyncio: fully unit-testable with an
injected clock.  The batcher owns one controller pair per process and
surfaces their state through ``/health``, ``/stats`` and the flight
recorder's ``overload`` tick entries (docs/operations.md runbook).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional

from vgate_tpu_torch import metrics
from vgate_tpu_torch.errors import ClientQuotaExceededError, ServerOverloadedError
from vgate_tpu_torch.logging_config import get_logger

logger = get_logger(__name__)

TIERS = ("interactive", "standard", "batch")
TIER_RANK = {"interactive": 0, "standard": 1, "batch": 2}
RANK_TIER = {rank: name for name, rank in TIER_RANK.items()}

# degradation steps, in engage order (level N activates steps[:N])
BROWNOUT_STEPS = (
    "clamp_max_tokens",
    "shrink_batch_window",
    "disable_speculative",
    "bypass_cache_writes",
)


def tier_rank(name: Optional[str]) -> int:
    """Tier name -> numeric rank (0 = most important); unknown/None maps
    to standard so a malformed tier can never jump the queue."""
    return TIER_RANK.get(name or "", TIER_RANK["standard"])


def estimate_prompt_tokens(prompt: str) -> int:
    """Cheap submit-time estimate (~4 chars/token, the BPE rule of
    thumb).  Admission must not tokenize on the event loop — the
    estimate only needs to be order-of-magnitude right, since limits
    are set in the hundreds of thousands of tokens."""
    return max(1, len(prompt) // 4)


class PrefixHintIndex:
    """Gateway-side predictor of prefix-cache hits, for cache-aware
    admission: a 90%-cached request must not be shed as if it were cold.

    The engine's radix tree is token-indexed and lives on the engine
    thread; admission runs on the event loop and must not tokenize.  So
    the gateway keeps its own coarse, text-level mirror: a rolling
    chain hash over fixed-size character blocks of every prompt it has
    SUBMITTED (once a prompt reaches the engine, its prefix will be in
    the tree within one prefill).  A new prompt's predicted cached
    tokens = matched chain blocks * BLOCK_CHARS / 4 (the same
    chars-per-token rule as the cost estimate itself).  Mispredictions
    only skew the admission *estimate* — the backlog limits are set in
    hundreds of thousands of tokens and self-correct as requests
    settle.  Bounded LRU; event-loop-only (no locking — callers are
    ``AdmissionController.estimate_cost`` / ``note_submitted`` on the
    loop thread)."""

    BLOCK_CHARS = 256

    def __init__(self, max_blocks: int = 65536) -> None:
        from collections import OrderedDict

        self._seen: "OrderedDict[int, None]" = OrderedDict()
        self.max_blocks = max_blocks

    def _chain(self, prompt: str):
        h = 0
        for start in range(
            0, len(prompt) - self.BLOCK_CHARS + 1, self.BLOCK_CHARS
        ):
            # builtin hash chaining: collisions only skew an estimate,
            # never correctness (the engine matches real tokens)
            h = hash((h, prompt[start : start + self.BLOCK_CHARS]))
            yield h

    def observe(self, prompt: str) -> None:
        for key in self._chain(prompt):
            if key in self._seen:
                self._seen.move_to_end(key)
            else:
                self._seen[key] = None
        while len(self._seen) > self.max_blocks:
            self._seen.popitem(last=False)

    def estimate_cached_chars(self, prompt: str) -> int:
        matched = 0
        for key in self._chain(prompt):
            if key not in self._seen:
                break
            self._seen.move_to_end(key)
            matched += self.BLOCK_CHARS
        return matched


class AdmissionController:
    """Token-budget admission control with strict-priority shedding.

    Thread-safe: ``admit``/``release`` run on the event loop, while
    ``observe_completion`` may be called from batch tasks and the
    signals provider reads engine state across the thread boundary.
    """

    REJECT_REASONS = (
        "backlog_tokens",
        "backlog_requests",
        "would_miss_slo",
        "kv_pressure",
        "per_key_inflight",
    )

    def __init__(
        self,
        cfg: Any,
        signals: Optional[Callable[[], Dict[str, Any]]] = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.cfg = cfg
        self._signals = signals or (lambda: {})
        self._clock = clock
        self._lock = threading.Lock()
        self._queued_tokens = 0
        self._queued_requests = 0
        self._inflight_by_key: Dict[str, int] = {}
        # throughput EWMA over ~1s completion windows
        self._tput = max(1.0, float(cfg.throughput_init_tps))
        self._win_tokens = 0
        self._win_t0 = self._clock()
        # per-event shed-rate EWMA (0 = all admitted, 1 = all rejected);
        # one of the three pressure-score inputs
        self._reject_ewma = 0.0
        # cache-aware admission (admission.prefix_discount > 0): the
        # text-level hint index predicting each prompt's prefix-cache
        # hit, so warm requests are charged their *suffix* cost.  The
        # gateway only enables it when the engine's prefix cache is on.
        self.hints: Optional[PrefixHintIndex] = (
            PrefixHintIndex()
            if float(getattr(cfg, "prefix_discount", 0.0)) > 0
            else None
        )
        self.total_discounted_tokens = 0
        self.total_admitted = 0
        self.total_rejected: Dict[str, int] = {
            r: 0 for r in self.REJECT_REASONS
        }

    # -- tier resolution --

    def resolve_tier(
        self, requested: Optional[str], api_key: Optional[str]
    ) -> str:
        """Effective tier: the request's own ``priority`` field, capped
        by the key's configured tier (a batch-mapped key cannot claim
        interactive), defaulting to ``admission.default_tier``."""
        mapped = (
            self.cfg.key_tiers.get(api_key) if api_key else None
        )
        tier = requested or mapped or self.cfg.default_tier
        if tier not in TIER_RANK:
            tier = self.cfg.default_tier
        if mapped is not None and tier_rank(tier) < tier_rank(mapped):
            tier = mapped
        return tier

    def _fraction(self, tier: str) -> float:
        return max(
            0.05, float(self.cfg.tier_fractions.get(tier, 1.0))
        )

    # -- cache-aware cost estimation --

    def estimate_cost(
        self, prompt: str, max_tokens: int, prefix_cached: bool = True
    ) -> int:
        """Estimated tokens this request will actually COST the engine:
        prompt estimate minus the predicted prefix-cache hit (capped at
        ``admission.prefix_discount`` of the prompt part — decode cost
        is never discounted), plus ``max_tokens``.  ``prefix_cached``
        false (engine cache off) skips the discount.  Callers must pass
        the SAME value to admit() and release() — compute once."""
        est = estimate_prompt_tokens(prompt)
        if self.hints is not None and prefix_cached:
            cached = self.hints.estimate_cached_chars(prompt) // 4
            discount = min(
                cached, int(est * float(self.cfg.prefix_discount))
            )
            if discount > 0:
                self.total_discounted_tokens += discount
                est -= discount
        return est + max_tokens

    def note_submitted(self, prompt: str) -> None:
        """Record a successfully admitted+enqueued prompt in the hint
        index: its prefix will be resident after one prefill, so later
        prompts sharing it predict as (partially) cached."""
        if self.hints is not None:
            self.hints.observe(prompt)

    # -- the admission decision --

    def predicted_wait_s(self) -> float:
        with self._lock:
            backlog = self._queued_tokens
            tput = self._tput
        return backlog / max(1.0, tput)

    def _kv_signals(self) -> Dict[str, Any]:
        try:
            return self._signals() or {}
        except Exception:  # pragma: no cover - defensive
            return {}

    def _token_limit(self, sig: Dict[str, Any]) -> int:
        """Effective backlog token limit: the static config value, or —
        with ``admission.auto_token_budget`` — scaled to the engine's
        resident KV token capacity, so a kv_cache.dtype flip that
        doubles resident tokens (int8, ops/kv_quant.py) raises the
        admission budget with it."""
        limit = int(self.cfg.max_queued_tokens)
        if limit <= 0:
            # 0 = unlimited (config.yaml); scaling can only RAISE a
            # finite limit, never conjure one out of the sentinel
            return 0
        auto = float(getattr(self.cfg, "auto_token_budget", 0.0))
        capacity = sig.get("kv_token_capacity")
        if auto > 0 and capacity:
            limit = max(limit, int(auto * float(capacity)))
        return limit

    def admit(
        self,
        cost: int,
        tier: str = "standard",
        deadline_s: Optional[float] = None,
    ) -> None:
        """Admit ``cost`` estimated tokens at ``tier`` or raise
        ``ServerOverloadedError`` (-> 503).  Capacity only — the
        per-key fairness cap is :meth:`acquire_inflight`, charged once
        per HTTP request by the handlers (NOT per internal fan-out
        submit: an n=5 chat request is one client action, and a per-key
        429 must never pollute the server-wide shed-rate signal the
        brownout controller reads).  On success the cost is registered;
        the caller MUST pair it with exactly one :meth:`release` when
        the request settles (any outcome)."""
        if not self.cfg.enabled:
            with self._lock:
                self._register(cost)
            return
        frac = self._fraction(tier)
        # the KV/capacity reads cross into engine state; do them
        # outside the lock
        need_sig = (
            self.cfg.kv_free_watermark > 0
            or float(getattr(self.cfg, "auto_token_budget", 0.0)) > 0
        )
        sig = self._kv_signals() if need_sig else {}
        kv_free = (
            float(sig["kv_free_ratio"])
            if self.cfg.kv_free_watermark > 0
            and sig.get("kv_free_ratio") is not None
            else None
        )
        kv_watermark = float(self.cfg.kv_free_watermark)
        # host-swap pressure relief: with the swap tier on and healthy
        # (>= 25% host-pool headroom), a KV squeeze no longer means
        # recompute storms — preempted/demoted work resumes via a
        # cheap swap-in, so the cost model charges swap-in instead of
        # full re-prefill and admission can run the device pool hotter
        # before shedding kv_pressure.  An exhausted host pool restores
        # the full watermark: degradation stays graceful, not blind.
        relief = float(getattr(self.cfg, "swap_kv_relief", 0.0))
        if (
            kv_free is not None
            and 0 < relief < 1.0
            and sig.get("kv_swap_enabled")
            and float(sig.get("kv_host_free_ratio", 0.0)) >= 0.25
        ):
            kv_watermark *= relief
        token_limit = self._token_limit(sig)
        with self._lock:
            reason: Optional[str] = None
            if self.cfg.max_queued_requests > 0 and (
                self._queued_requests
                >= max(1, int(self.cfg.max_queued_requests * frac))
            ):
                reason = "backlog_requests"
            elif token_limit > 0 and (
                self._queued_tokens + cost > int(token_limit * frac)
            ):
                reason = "backlog_tokens"
            elif kv_free is not None and (
                kv_free < min(1.0, kv_watermark / frac)
            ):
                reason = "kv_pressure"
            elif (
                self.cfg.reject_would_miss_slo
                and deadline_s is not None
                and self._queued_tokens / max(1.0, self._tput)
                > deadline_s
            ):
                # the completion would arrive past the client's own
                # deadline: cheaper to refuse at the door than to burn
                # queue + decode on a guaranteed 504
                reason = "would_miss_slo"

            self._reject_ewma += 0.05 * (
                (1.0 if reason else 0.0) - self._reject_ewma
            )
            if reason is None:
                self._register(cost)
                self.total_admitted += 1
                return
            self.total_rejected[reason] += 1
            retry_after = min(
                30.0,
                max(1.0, self._queued_tokens / max(1.0, self._tput)),
            )
        metrics.ADMISSION_REJECTIONS.labels(
            reason=reason, tier=tier
        ).inc()
        raise ServerOverloadedError(
            f"server overloaded ({reason}): rejected at admission for "
            f"tier {tier!r}; retry after {retry_after:.0f}s",
            retry_after=retry_after,
            shed_reason=reason,
            tier=tier,
        )

    def _register(self, cost: int) -> None:
        # caller holds the lock
        if self._queued_requests == 0 and self._win_tokens == 0:
            # idle -> busy edge: anchor the throughput window to the
            # busy period, so idle time never counts as decode time
            self._win_t0 = self._clock()
        self._queued_tokens += cost
        self._queued_requests += 1
        metrics.ADMISSION_QUEUED_TOKENS.set(self._queued_tokens)
        metrics.ADMISSION_QUEUED_REQUESTS.set(self._queued_requests)

    def release(self, cost: int) -> None:
        """Settle one admitted request (success, failure or cancel)."""
        with self._lock:
            self._queued_tokens = max(0, self._queued_tokens - cost)
            self._queued_requests = max(0, self._queued_requests - 1)
            metrics.ADMISSION_QUEUED_TOKENS.set(self._queued_tokens)
            metrics.ADMISSION_QUEUED_REQUESTS.set(self._queued_requests)

    def _dec_inflight(self, api_key: str) -> None:
        # caller holds the lock.  Empty entries are dropped, not kept
        # at 0: the key space is client-controlled and must not leak.
        n = self._inflight_by_key.get(api_key, 0) - 1
        if n > 0:
            self._inflight_by_key[api_key] = n
        else:
            self._inflight_by_key.pop(api_key, None)

    def acquire_inflight(
        self, api_key: Optional[str], tier: Optional[str] = None
    ) -> Callable[[], None]:
        """The per-key fairness cap: one in-flight slot per CLIENT
        request (handlers call this once per HTTP request, so an n=5
        fan-out charges the key once).  Raises
        ``ClientQuotaExceededError`` (-> 429) over the cap, else
        returns the (idempotent) release callable.  Deliberately does
        NOT feed the shed-rate EWMA — one client at its own cap is not
        server-wide overload and must not engage the brownout."""
        if (
            not self.cfg.enabled
            or self.cfg.per_key_max_inflight <= 0
            or api_key is None
        ):
            return lambda: None
        with self._lock:
            if (
                self._inflight_by_key.get(api_key, 0)
                >= self.cfg.per_key_max_inflight
            ):
                self.total_rejected["per_key_inflight"] += 1
                metrics.ADMISSION_REJECTIONS.labels(
                    reason="per_key_inflight",
                    tier=tier or self.resolve_tier(None, api_key),
                ).inc()
                raise ClientQuotaExceededError(
                    f"API key already has "
                    f"{self.cfg.per_key_max_inflight} requests in flight",
                )
            self._inflight_by_key[api_key] = (
                self._inflight_by_key.get(api_key, 0) + 1
            )
        released = [False]

        def _release() -> None:
            if released[0]:
                return
            released[0] = True
            with self._lock:
                self._dec_inflight(api_key)

        return _release

    # -- throughput observation --

    # windows stretched past this are not capacity samples: the server
    # sat (partly) idle, and folding them in would let offered load
    # masquerade as capacity (a trickle would read as ~0 tok/s and a
    # later burst as an hours-long predicted wait)
    STALE_WINDOW_S = 30.0

    def observe_completion(self, tokens: int) -> None:
        """Feed generated-token counts (once per unique generation — the
        batcher calls this for dedup-group LEADS only, so shared compute
        is not double-counted) into the decode-throughput EWMA.  Windows
        are anchored to busy periods (_register resets the window on the
        idle->busy edge) and stale windows are discarded, so the EWMA
        tracks capacity, not offered load."""
        now = self._clock()
        with self._lock:
            self._win_tokens += max(0, int(tokens))
            dt = now - self._win_t0
            if dt < 1.0:
                return
            if dt <= self.STALE_WINDOW_S:
                rate = self._win_tokens / dt
                a = self.cfg.throughput_alpha
                self._tput = max(1.0, a * rate + (1 - a) * self._tput)
            self._win_tokens = 0
            self._win_t0 = now
        metrics.ADMISSION_THROUGHPUT.set(self._tput)
        metrics.ADMISSION_PREDICTED_WAIT.set(self.predicted_wait_s())

    def shed_rate(self) -> float:
        with self._lock:
            return self._reject_ewma

    # -- introspection --

    def get_stats(self) -> Dict[str, Any]:
        # KV capacity attribution (outside the lock: crosses into
        # engine state): the token limit actually in force plus the
        # kv dtype/capacity it derives from, so an operator reading
        # /stats sees WHY the budget is what it is
        sig = self._kv_signals()
        token_limit = self._token_limit(sig)
        kv_block = {
            k: sig[k]
            for k in ("kv_dtype", "kv_token_capacity")
            if k in sig
        }
        with self._lock:
            return {
                "enabled": bool(self.cfg.enabled),
                "queued_tokens": self._queued_tokens,
                "queued_requests": self._queued_requests,
                "max_queued_tokens": self.cfg.max_queued_tokens,
                "effective_max_queued_tokens": token_limit,
                **kv_block,
                "max_queued_requests": self.cfg.max_queued_requests,
                "predicted_wait_s": round(
                    self._queued_tokens / max(1.0, self._tput), 3
                ),
                "throughput_tps": round(self._tput, 1),
                "inflight_keys": len(self._inflight_by_key),
                "admitted": self.total_admitted,
                "rejected": dict(self.total_rejected),
                "prefix_discounted_tokens": self.total_discounted_tokens,
            }


class TierQueue:
    """Priority-tiered request holder for the gateway batcher.

    Entries must expose a ``tier_rank`` attribute (0 = interactive).
    Not itself locked — the batcher serializes access under its
    asyncio queue lock, exactly like the flat list it replaces."""

    def __init__(self, weights: Optional[Dict[str, int]] = None) -> None:
        self._qs: Dict[int, List[Any]] = {r: [] for r in RANK_TIER}
        weights = weights or {}
        self._weights = {
            rank: max(1, int(weights.get(name, 1)))
            for name, rank in TIER_RANK.items()
        }
        # rank the next fill cycle starts at: when a batch is too small
        # to reach every non-empty tier in one cycle, service rotates
        # across calls instead of re-starving the tail tiers
        self._resume = 0

    def append(self, req: Any) -> None:
        self._qs[getattr(req, "tier_rank", 1)].append(req)

    def remove(self, req: Any) -> None:
        self._qs[getattr(req, "tier_rank", 1)].remove(req)

    def clear(self) -> None:
        for q in self._qs.values():
            q.clear()

    def drain(self) -> List[Any]:
        """Every queued request in tier order, emptying the queue."""
        out: List[Any] = []
        for rank in sorted(self._qs):
            out.extend(self._qs[rank])
            self._qs[rank].clear()
        return out

    def take(self, n: int) -> List[Any]:
        """Weighted dequeue: repeat fill cycles taking up to
        ``tier_weights[tier]`` requests per tier in priority order —
        but each cycle RESERVES one slot per lower non-empty tier, so
        an interactive weight >= the batch size can never fill every
        cycle alone: lower tiers keep a guaranteed trickle of service
        under sustained higher-tier load (no starvation) while
        interactive still dominates each batch."""
        out: List[Any] = []
        while len(out) < n and len(self):
            nonempty = [r for r in sorted(self._qs) if self._qs[r]]
            # resume where the previous cycle ran out of budget, so a
            # batch size smaller than the number of non-empty tiers
            # still rotates service instead of starving the tail
            start = 0
            for i, rank in enumerate(nonempty):
                if rank >= self._resume:
                    start = i
                    break
            order = nonempty[start:] + nonempty[:start]
            budget = n - len(out)
            served_all = True
            for i, rank in enumerate(order):
                if budget <= 0:
                    self._resume = rank
                    served_all = False
                    break
                q = self._qs[rank]
                reserve = len(order) - i - 1
                quota = min(
                    self._weights[rank],
                    len(q),
                    max(1, budget - reserve),
                    budget,
                )
                out.extend(q[:quota])
                del q[:quota]
                budget -= quota
            if served_all:
                self._resume = 0
        return out

    def depths(self) -> Dict[str, int]:
        return {
            RANK_TIER[rank]: len(q) for rank, q in self._qs.items()
        }

    def __len__(self) -> int:
        return sum(len(q) for q in self._qs.values())

    def __bool__(self) -> bool:
        return any(self._qs.values())

    def __contains__(self, req: Any) -> bool:
        return req in self._qs[getattr(req, "tier_rank", 1)]

    def __iter__(self) -> Iterable[Any]:
        for rank in sorted(self._qs):
            yield from self._qs[rank]


class PressureController:
    """Adaptive brownout: walks the declared degradation steps as a
    composite pressure score rises, and restores them — one level at a
    time, with hysteresis — as it falls.

    Score inputs (max of the normalized three):

    * predicted queue wait vs ``admission.target_wait_s``
    * KV free-page ratio vs twice the admission watermark
    * the admission controller's recent shed-rate EWMA

    Engaging is immediate (overload needs a fast reaction); releasing
    a level requires the score below ``engage * release_ratio`` for
    ``brownout_hold_s`` so the controller cannot flap around a
    threshold.
    """

    def __init__(
        self,
        cfg: Any,
        admission: AdmissionController,
        signals: Optional[Callable[[], Dict[str, Any]]] = None,
        on_transition: Optional[Callable[..., Any]] = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.cfg = cfg
        self.admission = admission
        self._signals = signals or (lambda: {})
        self.on_transition = on_transition
        self._clock = clock
        self._lock = threading.Lock()
        self.level = 0
        self.score = 0.0
        self._last_update = 0.0
        self._below_since: Optional[float] = None
        self._level_since = self._clock()
        self.total_transitions = 0

    # -- scoring --

    def _compute_score(self) -> float:
        wait_score = self.admission.predicted_wait_s() / max(
            0.001, self.cfg.target_wait_s
        )
        kv_score = 0.0
        try:
            sig = self._signals() or {}
        except Exception:  # pragma: no cover - defensive
            sig = {}
        kv_free = sig.get("kv_free_ratio")
        wm = float(self.cfg.kv_free_watermark)
        if kv_free is not None and wm > 0:
            # 0 with >= 2x watermark free, 1.0 exactly at the watermark
            kv_score = max(0.0, (2 * wm - float(kv_free)) / wm)
        shed_score = self.admission.shed_rate() / 0.5
        return min(2.0, max(wait_score, kv_score, shed_score))

    def maybe_update(self, now: Optional[float] = None) -> None:
        """Rate-limited recompute; piggybacked on batcher submit and
        batch-loop ticks so no dedicated timer task is needed."""
        if not self.cfg.brownout_enabled:
            return
        now = self._clock() if now is None else now
        with self._lock:
            if (
                now - self._last_update
                < self.cfg.brownout_update_interval_s
            ):
                return
            self._last_update = now
        self._update(now)

    def _update(self, now: float) -> None:
        score = self._compute_score()
        engage = self.cfg.brownout_engage
        target = 0
        for i, threshold in enumerate(engage):
            if score >= threshold:
                target = i + 1
        with self._lock:
            self.score = score
            new_level = self.level
            if target > self.level:
                new_level = target
                self._below_since = None
            elif self.level > 0:
                release_at = (
                    engage[self.level - 1]
                    * self.cfg.brownout_release_ratio
                )
                if score < release_at:
                    if self._below_since is None:
                        self._below_since = now
                    elif (
                        now - self._below_since
                        >= self.cfg.brownout_hold_s
                    ):
                        new_level = self.level - 1
                        # the timer restarts at the step-down, so a
                        # sustained low score releases one level per
                        # hold period (not per two update cycles)
                        self._below_since = now
                else:
                    self._below_since = None
            prev, transitioned = self.level, new_level != self.level
            if transitioned:
                self.level = new_level
                self._level_since = now
                self.total_transitions += 1
        metrics.PRESSURE_SCORE.set(round(score, 4))
        if not transitioned:
            return
        metrics.PRESSURE_LEVEL.set(new_level)
        metrics.PRESSURE_TRANSITIONS.labels(
            direction="up" if new_level > prev else "down"
        ).inc()
        logger.warning(
            "brownout level change",
            extra={
                "extra_data": {
                    "level": new_level,
                    "prev": prev,
                    "score": round(score, 3),
                    "steps": self.active_steps(),
                }
            },
        )
        if self.on_transition is not None:
            try:
                self.on_transition(
                    level=new_level, prev=prev, score=round(score, 3)
                )
            except Exception:  # pragma: no cover - observer must not break serving
                logger.error("pressure transition hook failed", exc_info=True)

    # -- the degradation steps --

    def clamp_max_tokens(self, requested: int) -> int:
        if self.level >= 1 and self.cfg.brownout_max_tokens > 0:
            return min(requested, self.cfg.brownout_max_tokens)
        return requested

    def effective_wait_ms(self, base_ms: float) -> float:
        if self.level >= 2 and self.cfg.brownout_wait_ms > 0:
            return min(base_ms, self.cfg.brownout_wait_ms)
        return base_ms

    @property
    def spec_disabled(self) -> bool:
        return self.level >= 3

    @property
    def cache_write_bypass(self) -> bool:
        return self.level >= 4

    def active_steps(self) -> List[str]:
        return list(BROWNOUT_STEPS[: self.level])

    # -- introspection --

    def brief(self) -> Dict[str, Any]:
        """Compact block for /health."""
        return {
            "level": self.level,
            "score": round(self.score, 3),
            "steps": self.active_steps(),
        }

    def get_stats(self) -> Dict[str, Any]:
        return {
            "enabled": bool(self.cfg.brownout_enabled),
            "level": self.level,
            "score": round(self.score, 3),
            "steps": self.active_steps(),
            "level_age_s": round(self._clock() - self._level_since, 1),
            "transitions": self.total_transitions,
        }
