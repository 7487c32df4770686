"""Dynamic request batcher with in-batch deduplication and result caching.

Reproduces the reference batcher's externally observable semantics
(vgate/batcher.py:47-411):

* a batch fires when the queue reaches ``max_batch_size`` or every
  ``max_wait_time_ms`` via a background loop (batcher.py:177-190);
* identical requests inside a batch collapse to one inference, keyed by the
  result-cache key (batcher.py:236-266);
* results fan back through per-request ``asyncio.Future``s (batcher.py:302-308)
  and one inference failure fails every future in the batch (batcher.py:310-324);
* cache hits return on a sub-ms fast path before queuing (batcher.py:149-155).

Deliberate departures from the reference:

* **Per-request sampling params survive batching.**  The reference applies the
  first request's temperature/top_p to the whole batch (batcher.py:271); here
  every unique request carries its own ``SamplingParams`` into the backend.
* **No stop-the-world inference lock.**  The reference serializes all batches
  behind one asyncio lock (batcher.py:79,195) because concurrent
  ``vLLM.generate`` calls corrupt its engine.  The torch_cuda backend has its own
  continuous-batching scheduler that admits new sequences between decode
  steps, so batches here are pushed through ``generate_async`` concurrently;
  only backends without async support fall back to a serialized thread-pool
  hop (the reference's run_in_executor pattern, batcher.py:326-361).
"""

from __future__ import annotations

import asyncio
import dataclasses
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from vgate_tpu_torch import metrics
from vgate_tpu_torch.admission import (
    AdmissionController,
    PressureController,
    TierQueue,
    tier_rank,
)
from vgate_tpu_torch.backends.base import GenerationResult, SamplingParams
from vgate_tpu_torch.cache import ResultCache
from vgate_tpu_torch.config import VGTConfig, get_config
from vgate_tpu_torch.engine import VGTEngine
from vgate_tpu_torch.errors import (
    ClientDisconnectError,
    EngineRecoveringError,
    ServerDrainingError,
    raise_for_state,
)
from vgate_tpu_torch.lifecycle import CancelToken, all_of
from vgate_tpu_torch.logging_config import get_logger
from vgate_tpu_torch.observability.reqtrace import (
    RequestMeta,
    emit_gateway_phases,
)
from vgate_tpu_torch.tracing import capture_context, context_trace_id, get_tracer

logger = get_logger(__name__)
tracer = get_tracer(__name__)

# finish_reasons that mark a PARTIAL generation (cancelled or
# deadline-shed): never stored in the ResultCache — a later identical
# request must get the full completion, not a truncated replay
UNCACHEABLE_FINISH = frozenset({"abort", "deadline"})

# extra wait past a request's deadline when the ENGINE enforces it (a
# typed shed with partial metadata is coming; it trails the nominal
# deadline by up to a tick, which a first-contact compile can stretch
# to seconds).  Pure safety net against enforcement failing outright.
ENGINE_SHED_GRACE_S = 30.0

# Obligation contracts (vgtlint obligations checker).  Two invariants
# live in this module — a created future is settled on every exception
# arm, and "the admission backlog releases exactly once, whatever the
# outcome"; every CFG path from a charge/create must reach its
# release/settle or the hand-off that guarantees it (the future's
# done-callback fires on set_result, set_exception AND cancel).
VGT_OBLIGATIONS = {
    "admission-backlog": {
        "acquire": ("self.admission.admit",),
        "release": ("self.admission.release",),
        "transfer": ("*.add_done_callback",),
    },
    "request-future": {
        "acquire": ("*.create_future",),
        "release": ("*.set_result", "*.set_exception", "*.cancel"),
        "transfer": ("*.add_done_callback",),
    },
}


@dataclass
class BatchRequest:
    """One queued request (reference: vgate/batcher.py:35-44)."""

    request_id: str
    prompt: str
    params: SamplingParams
    cache_key: str
    future: "asyncio.Future[Dict[str, Any]]"
    enqueued_at: float = field(default_factory=time.perf_counter)
    # client-disconnect propagation: queued → dequeue + fail fast;
    # dispatched → the backend registered seq.request_abort on it
    token: Optional[CancelToken] = None
    # absolute deadline (enqueued_at + timeout_s); dedup groups pick the
    # member with the MOST headroom as lead so a short-deadline twin
    # can't shed a patient one's generation
    deadline_t: Optional[float] = None
    # set at dispatch when THIS request's params (deadline included)
    # reached an engine that sheds past-deadline sequences itself —
    # true for group leads on the async engine path.  Non-leads (their
    # tighter deadline is NOT the one the engine enforces) and sync
    # backends keep False, so their backstop fires exactly on time.
    engine_enforced: bool = False
    # observability (observability/reqtrace.py): request id + the OTel
    # context captured while the HTTP span was active, so engine phase
    # spans parent on the request's trace across the thread boundary
    meta: Optional[RequestMeta] = None
    # priority tier rank (admission.py: 0 interactive, 1 standard,
    # 2 batch) — selects the TierQueue lane and rides params.priority
    # into the engine scheduler
    tier_rank: int = 1


class RequestBatcher:
    def __init__(
        self,
        engine: VGTEngine,
        config: Optional[VGTConfig] = None,
        cache: Optional[ResultCache] = None,
    ) -> None:
        self.config = config or get_config()
        self.engine = engine
        self.cache = cache or ResultCache(
            max_size=self.config.cache.max_size,
            enabled=self.config.cache.enabled,
        )
        self._queue: TierQueue = TierQueue(
            weights=self.config.admission.tier_weights
        )
        self._queue_lock = asyncio.Lock()
        # overload protection (vgate_tpu_torch/admission.py): token-budget
        # admission + the adaptive brownout controller.  The signals
        # provider reads cheap engine-side gauges (KV free ratio,
        # engine queue depth) through the backend when it has them.
        self.admission = AdmissionController(
            self.config.admission, signals=self._pressure_signals
        )
        # cache-aware admission discounts only make sense when the
        # engine actually shares prefixes: mirror the engine's own gate
        # (engine_core disables the prefix cache under pp > 1 — the
        # suffix-prefill program only exists on the pp == 1 layout), or
        # pp deployments would discount hits that can never occur
        self._prefix_cache_on = bool(
            self.config.device.prefix_cache.enabled
            and int(self.config.device.pp) == 1
        )
        # brownout L4 mirror (set by _on_pressure_transition): while
        # the engine's tree inserts are suspended, submitted prompts do
        # NOT become cache-resident, so the hint index must stop
        # learning them (note_prompt_submitted)
        self._prefix_insert_suspended = False
        self.pressure = PressureController(
            self.config.admission,
            self.admission,
            signals=self._pressure_signals,
            on_transition=self._on_pressure_transition,
        )
        self._loop_task: Optional[asyncio.Task] = None
        self._running = False
        # set by stop(): submissions racing shutdown must fail fast, not
        # enqueue behind the leftover sweep and hang
        self._stopped = False
        # set by begin_drain() (SIGTERM): new submissions are rejected
        # with a retryable 503 while in-flight work runs to completion
        self._draining = False
        self._drain_retry_after = 2.0
        # memoized: does the backend's settled path accept cancel_tokens?
        self._settled_takes_tokens: Optional[bool] = None
        # memoized: does it accept request_meta (the engine then emits
        # exact phase spans; otherwise the batcher approximates them)?
        self._settled_takes_meta: Optional[bool] = None
        self._obs_enabled = self.config.observability.enabled
        # Backends without generate_async share one worker hop at a time
        # (the reference's global _inference_lock, batcher.py:79).
        self._sync_lock = asyncio.Lock()
        # Stats mirrored by /stats (reference: batcher.py:401-411).
        self._total_requests = 0
        self._total_batches = 0
        self._total_deduped = 0
        self._total_cache_hits = 0

    # -- lifecycle (reference: vgate/batcher.py:89-114) --

    async def start(self) -> None:
        if self._running:
            return
        self._running = True
        self._loop_task = asyncio.create_task(self._batch_loop())
        logger.info(
            "batcher started",
            extra={
                "extra_data": {
                    "max_batch_size": self.config.batch.max_batch_size,
                    "max_wait_time_ms": self.config.batch.max_wait_time_ms,
                }
            },
        )

    async def stop(self) -> None:
        """Drain the queue, then cancel the loop (reference: batcher.py:103-114).

        The drain loops until the queue is empty — one ``_process_batch``
        only takes ``max_batch_size`` requests, and anything left behind
        would hang its client forever.  A dead/fatal engine still
        resolves every future: per-request failures come back through the
        settled path, and whatever survives the drain (e.g. racing
        submissions) is failed explicitly below."""
        self._running = False
        self._stopped = True
        while self._queue:
            await self._process_batch()
        if self._loop_task is not None:
            self._loop_task.cancel()
            try:
                await self._loop_task
            except asyncio.CancelledError:
                pass
            self._loop_task = None
        async with self._queue_lock:
            leftovers = self._queue.drain()
            metrics.PENDING_REQUESTS.set(0)
        for req in leftovers:
            if not req.future.done():
                req.future.set_exception(
                    EngineRecoveringError(
                        "server shut down before the request could run"
                    )
                )

    # -- overload protection (vgate_tpu_torch/admission.py) --

    def _pressure_signals(self) -> Dict[str, Any]:
        """Cheap engine-side gauges for admission + brownout: KV
        free-page ratio and engine queue depth.  Backends without the
        surface (dry-run, external adapters) contribute nothing — the
        controllers then run on gateway-side signals alone."""
        fn = getattr(self.engine.backend, "pressure_signals", None)
        if fn is None:
            return {}
        try:
            return fn() or {}
        except Exception:  # pragma: no cover - mid-restart races
            return {}

    def _on_pressure_transition(
        self, level: int, prev: int, score: float
    ) -> None:
        """Brownout level changed: apply the engine-side step
        (speculative decoding on/off at the L3 boundary) and leave an
        ``overload`` tick in the flight recorder so post-mortems show
        when degradation engaged relative to the dispatch stream."""
        set_spec = getattr(
            self.engine.backend, "set_spec_suspended", None
        )
        if set_spec is not None:
            try:
                set_spec(level >= 3)
            except Exception:  # pragma: no cover - mid-restart races
                logger.error("set_spec_suspended failed", exc_info=True)
        # level 4's "bypass cache writes" covers the KV prefix tree too:
        # stop inserting, keep serving hits (runtime/radix_cache.py).
        # The gateway's hint index follows the same policy — granting
        # the admission discount for prefixes that will never become
        # resident would admit MORE work exactly as pressure rises
        self._prefix_insert_suspended = level >= 4
        set_insert = getattr(
            self.engine.backend, "set_prefix_insert_suspended", None
        )
        if set_insert is not None:
            try:
                set_insert(level >= 4)
            except Exception:  # pragma: no cover - mid-restart races
                logger.error(
                    "set_prefix_insert_suspended failed", exc_info=True
                )
        # resolve the recorder at call time: supervised engines swap
        # cores (and recorders) across restarts
        core = getattr(self.engine.backend, "core", None)
        flight = getattr(core, "flight", None)
        if flight is not None:
            flight.record_tick(
                "overload",
                level=level,
                prev=prev,
                score=score,
                steps=self.pressure.active_steps(),
                queue_depth=len(self._queue),
            )

    def note_prompt_submitted(self, prompt: str) -> None:
        """Teach the admission hint index that this prompt reached the
        engine — its prefix will be tree-resident after one prefill, so
        later prompts sharing it admit at their suffix cost.  Gated off
        while brownout L4 has the engine's tree inserts suspended: the
        prefix will NOT become resident then, and learning it would
        grant discounts for hits that cannot materialize."""
        if self._prefix_cache_on and not self._prefix_insert_suspended:
            self.admission.note_submitted(prompt)

    # -- graceful drain (vgate_tpu_torch/lifecycle.py DrainController) --

    def begin_drain(self, retry_after_s: float = 2.0) -> None:
        """SIGTERM: stop admitting (new submissions raise the retryable
        ``ServerDrainingError`` → 503 + Retry-After) while queued and
        dispatched work keeps flowing to completion."""
        self._draining = True
        self._drain_retry_after = retry_after_s

    def fail_pending(self, exc: Optional[BaseException] = None) -> int:
        """Drain-timeout straggler sweep: fail every still-QUEUED future
        (dispatched work is the engine's ``abort_in_flight``).  Sync and
        loop-thread-only by design — it must run to completion without
        yielding so no batch fire can interleave."""
        exc = exc or ServerDrainingError(
            "server shut down before the request could run",
            retry_after=self._drain_retry_after,
        )
        leftovers = self._queue.drain()
        metrics.PENDING_REQUESTS.set(0)
        failed = 0
        for req in leftovers:
            if not req.future.done():
                req.future.set_exception(exc)
                failed += 1
        return failed

    # -- submission (reference: vgate/batcher.py:116-182) --

    async def submit(
        self,
        prompt: str,
        max_tokens: Optional[int] = None,
        min_tokens: int = 0,
        temperature: Optional[float] = None,
        top_p: Optional[float] = None,
        top_k: Optional[int] = None,
        stop: Optional[List[str]] = None,
        stop_token_ids: Optional[List[int]] = None,
        seed: Optional[int] = None,
        request_id: Optional[str] = None,
        timeout_s: Optional[float] = None,
        logprobs: bool = False,
        top_logprobs: int = 0,
        variant: int = 0,
        frequency_penalty: float = 0.0,
        presence_penalty: float = 0.0,
        logit_bias: Optional[Dict[int, float]] = None,
        cancel_token: Optional[CancelToken] = None,
        priority: Optional[str] = None,
        api_key: Optional[str] = None,
    ) -> Dict[str, Any]:
        if self._draining:
            raise ServerDrainingError(
                retry_after=self._drain_retry_after
            )
        self.pressure.maybe_update()
        tier = self.admission.resolve_tier(priority, api_key)
        inf = self.config.inference
        # brownout level >= 1 clamps every request's completion budget:
        # the clamp happens BEFORE the cache key is built, so clamped
        # and unclamped results never collide in the cache
        effective_max_tokens = self.pressure.clamp_max_tokens(
            max_tokens if max_tokens is not None else inf.max_tokens
        )
        params = SamplingParams(
            max_tokens=effective_max_tokens,
            min_tokens=min_tokens,
            temperature=(
                temperature if temperature is not None else inf.temperature
            ),
            top_p=top_p if top_p is not None else inf.top_p,
            top_k=top_k if top_k is not None else inf.top_k,
            stop=stop,
            stop_token_ids=stop_token_ids,
            seed=seed,
            logprobs=logprobs,
            top_logprobs=top_logprobs,
            frequency_penalty=frequency_penalty,
            presence_penalty=presence_penalty,
            logit_bias=logit_bias,
            # the engine sheds past-deadline sequences between decode
            # ticks (504 + partial-tokens metadata); excluded from the
            # cache key below — completed results don't depend on it
            timeout_s=timeout_s,
            # rides into the engine scheduler: admit interactive
            # first, preempt batch first (also not cache identity)
            priority=tier_rank(tier),
        )
        request_id = request_id or uuid.uuid4().hex[:12]
        # capture the request's trace context BEFORE opening the
        # batcher.submit span, so the engine's phase spans become direct
        # children of the HTTP request span (siblings of batcher.submit)
        # rather than grandchildren through a span that ends early
        trace_ctx = capture_context() if self._obs_enabled else None
        with tracer.start_as_current_span("batcher.submit"):
            self._total_requests += 1
            cache_key = ResultCache.make_key(
                prompt,
                params.temperature,
                params.top_p,
                params.max_tokens,
                params.top_k,
                stop=params.stop,
                stop_token_ids=params.stop_token_ids,
                min_tokens=params.min_tokens,
                seed=params.seed,
                # responses differ in content, so logprob requests must
                # not collide with plain ones in the cache/dedup key
                logprobs=(params.logprobs, params.top_logprobs),
                variant=variant,
                penalties=(
                    params.frequency_penalty, params.presence_penalty
                ),
                # biased requests must not dedup/cache-hit against
                # unbiased ones (sorted for key stability)
                logit_bias=(
                    tuple(sorted(params.logit_bias.items()))
                    if params.logit_bias
                    else None
                ),
            )
            cached = await self.cache.get(cache_key)
            if cached is not None:
                self._total_cache_hits += 1
                result = dict(cached)
                result["cached"] = True
                return result

            # Fail fast instead of queuing into a dead/recovering
            # engine: the health state machine (runtime/supervisor.py)
            # says a batch fired now cannot succeed, so the client gets
            # an immediate retryable 503 + Retry-After rather than a
            # max_wait_time_ms queue hop into a crash.  AFTER the cache
            # lookup: a cache-servable request needs no engine.
            state_fn = getattr(self.engine.backend, "serving_state", None)
            if state_fn is not None:
                raise_for_state(
                    state_fn(),
                    retry_after=getattr(
                        getattr(self.engine.backend, "core", None),
                        "retry_after_s",
                        1.0,
                    ),
                )

            # admission control: refuse work the server cannot finish
            # (503/429 + Retry-After) instead of queuing it into a
            # deadline 504.  After the cache lookup (a cache-servable
            # request costs nothing) and the health fail-fast (a
            # recovering engine's 503 is the more truthful answer).
            # cache-aware cost: the estimated prompt cost is discounted
            # by the predicted prefix-cache hit (admission.PrefixHintIndex)
            # so a mostly-cached multi-turn request is charged its
            # suffix, not re-charged its whole transcript every turn
            cost = self.admission.estimate_cost(
                prompt,
                params.max_tokens,
                prefix_cached=self._prefix_cache_on,
            )
            self.admission.admit(cost, tier=tier, deadline_s=timeout_s)
            try:
                request = BatchRequest(
                    request_id=request_id,
                    prompt=prompt,
                    params=params,
                    cache_key=cache_key,
                    future=asyncio.get_running_loop().create_future(),
                    token=cancel_token,
                    deadline_t=(
                        time.perf_counter() + timeout_s
                        if timeout_s is not None
                        else None
                    ),
                    meta=RequestMeta(
                        request_id=request_id, trace_ctx=trace_ctx
                    ),
                    tier_rank=tier_rank(tier),
                )
                # the backlog releases exactly once, whatever the
                # outcome — done callbacks fire on set_result,
                # set_exception AND cancel, covering every settle path
                # below
                request.future.add_done_callback(
                    lambda _f, c=cost: self.admission.release(c)
                )
            except BaseException:
                # a raise between the charge and the done-callback
                # registration (the only release mechanism) would leak
                # the admitted backlog forever
                self.admission.release(cost)
                raise
            try:
                async with self._queue_lock:
                    if self._stopped:
                        # shutdown raced past the cache lookup: nothing
                        # will ever drain the queue again; the except
                        # arm below cancels the future on the way out
                        raise EngineRecoveringError(
                            "server is shutting down; retry another "
                            "replica"
                        )
                    self._queue.append(request)
                    metrics.PENDING_REQUESTS.set(len(self._queue))
                    trigger = (
                        len(self._queue)
                        >= self.config.batch.max_batch_size
                    )
            except BaseException:
                # shutdown race, a raise before the append, or a
                # CANCELLATION while awaiting the contended queue lock:
                # the never-queued future would stay pending forever —
                # nothing would settle it, so the done-callback release
                # (the only backlog return mechanism) would never fire.
                # Cancelling it settles the future and fires that
                # callback.
                if not request.future.done():
                    request.future.cancel()
                raise
            self.note_prompt_submitted(prompt)
            if cancel_token is not None:
                # client disconnect: a queued request dequeues + fails
                # fast; a dispatched one is aborted by the backend (it
                # registered seq.request_abort on this same token)
                cancel_token.add_callback(
                    lambda: self._on_cancel(request)
                )
            if trigger:
                asyncio.ensure_future(self._process_batch())
            try:
                if timeout_s is None:
                    return await request.future
                try:
                    # shield: a wait_for timeout must not CANCEL the
                    # future — the engine-enforced branch below keeps
                    # awaiting it, and the engine's typed shed still
                    # needs somewhere to land
                    return await asyncio.wait_for(
                        asyncio.shield(request.future), timeout_s
                    )
                except asyncio.TimeoutError:
                    pass
                if request.engine_enforced:
                    # THIS request's deadline reached the engine (it
                    # led its dispatch group), so a typed
                    # DeadlineExceededError with partial metadata is
                    # imminent — the shed can trail the nominal
                    # deadline by a tick, and a first-contact XLA
                    # compile can stretch one tick to seconds.  Wait it
                    # out generously rather than race it with a
                    # metadata-less 504; the outer timeout below is
                    # only the safety net for enforcement failing
                    # entirely.  Non-leads (a tighter deadline the
                    # engine is NOT enforcing), sync backends and
                    # still-queued requests get no grace: their wait IS
                    # the deadline.
                    # a grace timeout propagates as TimeoutError and
                    # correctly skips the queue-removal below (an
                    # engine-enforced request was already dispatched)
                    return await asyncio.wait_for(
                        request.future, ENGINE_SHED_GRACE_S
                    )
                # giving up: settle the future so later batch fan-out
                # skips it, and shed the abandoned work — a still-queued
                # request must not occupy a future batch (its client is
                # gone; generating the completion would amplify the
                # overload).  If already dispatched, the engine finishes
                # it; only the wait ends.
                request.future.cancel()
                async with self._queue_lock:
                    if request in self._queue:
                        self._queue.remove(request)
                        metrics.PENDING_REQUESTS.set(len(self._queue))
                raise asyncio.TimeoutError()
            except asyncio.CancelledError:
                # the AWAITING TASK died — aiohttp cancels handler tasks
                # on client disconnect when handler_cancellation is on
                # (the gateway's watcher covers the default-off case),
                # or a direct caller was torn down.  Fire the token so
                # queued work dequeues and dispatched work aborts in the
                # engine instead of decoding for nobody.
                if cancel_token is not None:
                    cancel_token.cancel("client_disconnect")
                elif request in self._queue:
                    # sync removal, no await: a cancelled task must not
                    # block on the queue lock (it can be re-cancelled),
                    # and list mutation on the loop thread is atomic
                    # with respect to every coroutine critical section
                    self._queue.remove(request)
                    metrics.PENDING_REQUESTS.set(len(self._queue))
                    metrics.CANCELLED_REQUESTS.labels(
                        reason="client_disconnect"
                    ).inc()
                raise

    def _on_cancel(self, request: BatchRequest) -> None:
        """CancelToken callback (runs on the canceller's thread — the
        event loop for the gateway's disconnect watcher): dequeue a
        still-queued request and fail its future fast.  Dispatched
        requests are the backend's job (it registered the engine abort
        on the same token)."""
        if request.future.done():
            return
        try:
            loop = request.future.get_loop()
        except RuntimeError:  # pragma: no cover - future already dead
            return
        loop.call_soon_threadsafe(
            lambda: asyncio.ensure_future(self._drop_cancelled(request))
        )

    async def _drop_cancelled(self, request: BatchRequest) -> None:
        async with self._queue_lock:
            if request in self._queue:
                self._queue.remove(request)
                metrics.PENDING_REQUESTS.set(len(self._queue))
                # released HERE (never dispatched): count the
                # cancellation at this site; dispatched requests are
                # counted by the engine's abort path instead
                metrics.CANCELLED_REQUESTS.labels(
                    reason="client_disconnect"
                ).inc()
        if not request.future.done():
            request.future.set_exception(
                ClientDisconnectError(
                    "client disconnected before the request completed"
                )
            )
            # the waiter may already be dead (handler task cancelled on
            # disconnect): mark the exception retrieved so GC doesn't
            # log "exception was never retrieved"
            request.future.exception()

    # -- batch firing (reference: vgate/batcher.py:184-324) --

    async def _batch_loop(self) -> None:
        while self._running:
            # re-read per iteration: brownout level >= 2 shrinks the
            # batch window so queued work reaches the engine sooner
            # under pressure, and restores it on recovery
            wait_s = (
                self.pressure.effective_wait_ms(
                    self.config.batch.max_wait_time_ms
                )
                / 1000.0
            )
            await asyncio.sleep(wait_s)
            self.pressure.maybe_update()
            if self._queue:
                await self._process_batch()

    async def _process_batch(self) -> None:
        async with self._queue_lock:
            # weighted dequeue across the priority tiers (admission.py
            # TierQueue): interactive dominates each fill cycle, batch
            # keeps a trickle so it cannot starve outright
            batch = self._queue.take(self.config.batch.max_batch_size)
            metrics.PENDING_REQUESTS.set(len(self._queue))
        if not batch:
            return
        with tracer.start_as_current_span("batcher.process_batch") as span:
            start = time.perf_counter()
            now = start
            for req in batch:
                metrics.QUEUE_TIME.observe(now - req.enqueued_at)
            # In-batch dedup: group by cache key (reference: batcher.py:236-266).
            groups: Dict[str, List[BatchRequest]] = {}
            for req in batch:
                groups.setdefault(req.cache_key, []).append(req)
            # the group lead's SamplingParams reach the engine, deadline
            # included — so lead = the member with the MOST headroom
            # (None = unbounded), or a 50ms-deadline twin would shed a
            # patient client's generation with it
            unique = [
                max(
                    reqs,
                    key=lambda r: (
                        r.deadline_t is None,
                        r.deadline_t or 0.0,
                    ),
                )
                for reqs in groups.values()
            ]
            n_duplicates = len(batch) - len(unique)
            self._total_deduped += n_duplicates
            if n_duplicates:
                metrics.DEDUP_REQUESTS.inc(n_duplicates)
            metrics.DEDUP_RATIO.set(n_duplicates / len(batch))
            metrics.BATCH_SIZE.observe(len(batch))
            metrics.UNIQUE_PROMPTS.observe(len(unique))
            metrics.BATCHES_TOTAL.inc()
            self._total_batches += 1
            span.set_attribute("batch.size", len(batch))
            span.set_attribute("batch.unique", len(unique))

            try:
                results = await self._run_batch_inference(unique, groups)
            except Exception as exc:  # fail the whole batch (batcher.py:310-324)
                metrics.INFERENCE_ERRORS.labels(
                    error_type=type(exc).__name__
                ).inc()
                logger.error(
                    "batch inference failed",
                    extra={"extra_data": {"batch_size": len(batch)}},
                    exc_info=True,
                )
                for req in batch:
                    if not req.future.done():
                        req.future.set_exception(exc)
                return

            elapsed = time.perf_counter() - start
            metrics.observe_with_exemplar(metrics.BATCH_PROCESSING_TIME, elapsed)
            for lead, result in zip(unique, results):
                if isinstance(result, BaseException):
                    # settled path: only THIS group failed (e.g. deadline
                    # shed); its neighbours keep their completions
                    metrics.INFERENCE_ERRORS.labels(
                        error_type=type(result).__name__
                    ).inc()
                    for req in groups[lead.cache_key]:
                        if not req.future.done():
                            req.future.set_exception(result)
                    continue
                payload = self._normalize(lead, result)
                # decode-throughput EWMA feed for admission's queue-wait
                # estimate — once per unique generation (leads only, so
                # dedup followers don't double-count shared compute)
                self.admission.observe_completion(
                    payload.get("num_tokens", 0)
                )
                if self._obs_enabled and not self._settled_takes_meta:
                    # black-box backend (dry-run / external adapters):
                    # approximate the engine phase spans from reported
                    # ttft/gen_time so the trace still attributes queue
                    # vs prefill vs decode
                    emit_gateway_phases(
                        lead.meta,
                        lead.enqueued_at,
                        start,
                        payload.get("metrics", {}),
                        time.perf_counter(),
                    )
                if (
                    payload.get("finish_reason") not in UNCACHEABLE_FINISH
                    and not self.pressure.cache_write_bypass
                ):
                    # cancelled/deadline-shed results are PARTIAL: caching
                    # one would replay a truncated generation to every
                    # later identical request.  Brownout level >= 4 skips
                    # the write path entirely (reads stay on — they only
                    # help under overload).  `resumed`/`migrated` are
                    # per-delivery provenance (THIS response rode a
                    # restart / a live migration), never cache content.
                    await self.cache.put(
                        lead.cache_key,
                        {
                            k: v
                            for k, v in payload.items()
                            if k not in ("resumed", "migrated",
                                         "disaggregated")
                        },
                    )
                for req in groups[lead.cache_key]:
                    if not req.future.done():
                        out = dict(payload)
                        out["cached"] = False
                        # deduped followers share the lead's computation
                        # but must carry their OWN request id
                        out["request_id"] = req.request_id
                        req.future.set_result(out)

    async def _run_batch_inference(
        self,
        unique: List[BatchRequest],
        groups: Optional[Dict[str, List[BatchRequest]]] = None,
    ) -> List[GenerationResult]:
        """Dispatch to the backend, preferring its async path
        (reference thread hop: vgate/batcher.py:326-399)."""
        prompts = [req.prompt for req in unique]
        # re-anchor each deadline to the REMAINING budget at dispatch:
        # the engine measures timeout_s from its own arrival, so without
        # this, time spent queued here would silently extend the
        # client's end-to-end deadline — and under congestion the
        # metadata-less gateway backstop would beat the typed engine
        # shed (partial_tokens) exactly when clients most need it
        now = time.perf_counter()
        params = [
            req.params
            if req.deadline_t is None
            else dataclasses.replace(
                req.params,
                timeout_s=max(0.001, req.deadline_t - now),
            )
            for req in unique
        ]
        backend = self.engine.backend
        with tracer.start_as_current_span("batcher.inference"):
            # prefer the settled path: per-request failures (deadline shed,
            # queue full) stay per-request instead of failing the batch
            gen_settled = getattr(backend, "generate_settled_async", None)
            gen_async = getattr(backend, "generate_async", None)
            if gen_settled is not None or gen_async is not None:
                # the engine will enforce each LEAD's deadline (its
                # params carry it); a deduped non-lead with a tighter
                # deadline stays un-enforced and its submit() backstop
                # fires exactly on time instead of waiting out the
                # engine-shed grace
                for req in unique:
                    if req.deadline_t is not None:
                        req.engine_enforced = True
            if gen_settled is not None:
                if self._settled_takes_tokens is None:
                    import inspect

                    try:
                        sig_params = inspect.signature(
                            gen_settled
                        ).parameters
                    except (TypeError, ValueError):
                        sig_params = {}
                    self._settled_takes_tokens = (
                        "cancel_tokens" in sig_params
                    )
                    self._settled_takes_meta = (
                        "request_meta" in sig_params
                    )
                kwargs = {}
                if self._settled_takes_meta and self._obs_enabled:
                    # the engine emits exact per-phase spans and stamps
                    # flight records with request/trace ids (dedup
                    # followers share the lead's compute, so only the
                    # lead's trace shows engine phases)
                    kwargs["request_meta"] = [
                        req.meta for req in unique
                    ]
                if self._settled_takes_tokens and any(
                    req.token is not None for req in unique
                ):
                    # per dedup GROUP, not per lead: the shared
                    # generation aborts only when EVERY member's client
                    # cancelled — one disconnected twin must not
                    # truncate a still-connected twin's completion
                    kwargs["cancel_tokens"] = [
                        all_of(
                            [
                                r.token
                                for r in (
                                    groups[lead.cache_key]
                                    if groups
                                    else [lead]
                                )
                            ]
                        )
                        for lead in unique
                    ]
                return await gen_settled(prompts, params, **kwargs)
            if gen_async is not None:
                return await gen_async(prompts, params)
            async with self._sync_lock:
                loop = asyncio.get_running_loop()
                return await loop.run_in_executor(
                    None, lambda: backend.generate(prompts, params)
                )

    @staticmethod
    def _normalize(req: BatchRequest, result: GenerationResult) -> Dict[str, Any]:
        out = result.to_dict()
        m = out.get("metrics", {})
        # exemplar trace id from the request's CAPTURED context — this
        # runs on the batch task, where the active span (if any) is the
        # batch-scoped batcher.process_batch, whose trace id must NOT
        # leak onto request-scoped histograms; no valid request trace
        # means plain observations, not the fallback lookup
        trace_id = (
            context_trace_id(req.meta.trace_ctx) if req.meta else None
        )
        if "ttft" in m:
            if trace_id:
                metrics.observe_with_exemplar(
                    metrics.TTFT, m["ttft"], trace_id=trace_id
                )
            else:
                metrics.TTFT.observe(m["ttft"])
        if "tpot" in m:
            if trace_id:
                metrics.observe_with_exemplar(
                    metrics.TPOT, m["tpot"], trace_id=trace_id
                )
            else:
                metrics.TPOT.observe(m["tpot"])
        if result.num_tokens:
            metrics.GENERATED_TOKENS.inc(result.num_tokens)
        if result.prompt_tokens:
            metrics.PROMPT_TOKENS.inc(result.prompt_tokens)
        if m.pop("resumed", 0):
            # the engine checkpointed & replayed this generation across
            # a restart/failover: lift the marker to a typed response
            # flag (like `cached`) — and strip it from the metrics dict
            # so a later ResultCache hit of this payload doesn't claim
            # a restart that never touched the cached reader
            out["resumed"] = True
        if m.pop("migrated", 0):
            # same contract for PLANNED movement (replica drain /
            # rebalance / scale-down): per-delivery provenance, never
            # cache content
            out["migrated"] = True
        if m.pop("disaggregated", 0):
            # prefill→decode KV handoff (pod.roles): this generation
            # prefilled on one worker and decoded on another
            out["disaggregated"] = True
        out["request_id"] = req.request_id
        return out

    # -- stats (reference: vgate/batcher.py:401-411) --

    def get_metrics(self) -> Dict[str, Any]:
        return {
            "total_requests": self._total_requests,
            "total_batches": self._total_batches,
            "total_deduplicated": self._total_deduped,
            "total_cache_hits": self._total_cache_hits,
            "pending_requests": len(self._queue),
            "pending_by_tier": self._queue.depths(),
            "avg_batch_size": (
                (self._total_requests - self._total_cache_hits)
                / self._total_batches
                if self._total_batches
                else 0.0
            ),
            "running": self._running,
        }
