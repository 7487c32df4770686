"""The aiohttp gateway application of the PyTorch/CUDA port.

A copy of vgate_tpu/server/app.py over the port's engine:
``/health`` (+ ``/live`` and ``/ready``), ``/v1/chat/completions``
(plain and SSE), ``/v1/completions``, ``/v1/embeddings``,
``/v1/models``, ``/metrics``, ``/stats``, ``/v1/benchmark``,
``/debug/faults``, and the engine's self-observation: ``/debug/flight``,
``/debug/perf``, ``/debug/spans`` (with ``VGT_MEMTRACE``),
``/debug/requests``, ``/debug/requests/{ident}`` and ``/v1/profile`` (a
``torch.profiler`` trace).  With a worker pod (``pod.workers > 0``):
``/debug/pod`` and ``/admin/replicas`` (GET, and one worker's drain and
undrain; add and DELETE answer the pod's refusal).  With data
parallelism (``device.dp > 1``, runtime/dp_engine.py) ``/admin/replicas``
also adds a replica on a banked device slice (POST) and removes one
(DELETE), and SIGUSR1 drains the replica named by
``$VGT_DRAIN_REPLICA``; every replica operation answers 409 while
``migration.enabled`` is false.
``/v1/embeddings``
serves the backend's encoder (models/encoder.py).
Engine + batcher construction happens in ``on_startup``, not at module
import.

Serve with ``python -m vgate_tpu_torch.server.app``; the config comes
from ``VGT_SECTION__KEY`` variables and the YAML named by
``VGT_CONFIG_PATH`` (vgate_tpu_torch/config.py).
"""

from __future__ import annotations

import asyncio
import json
import os
import signal
import statistics
import tempfile
import time
import uuid
from typing import Any, Dict, Optional

from aiohttp import web
from pydantic import ValidationError

from vgate_tpu_torch import metrics
from vgate_tpu_torch.admission import tier_rank
from vgate_tpu_torch.batcher import RequestBatcher
from vgate_tpu_torch.config import VGTConfig, get_config
from vgate_tpu_torch.engine import VGTEngine
from vgate_tpu_torch.errors import (
    ClientDisconnectError,
    ClientQuotaExceededError,
    DeadlineExceededError,
    DuplicateRequestError,
    MigrationError,
    MigrationRefusedError,
    PoisonRequestError,
    RetryableError,
    ServerDrainingError,
    state_is_alive,
    state_is_ready,
)
from vgate_tpu_torch.lifecycle import CancelToken, DrainController
from vgate_tpu_torch.logging_config import get_logger, setup_logging
from vgate_tpu_torch.observability.reqtrace import RequestMeta
from vgate_tpu_torch.runtime.journal import PENDING as _JOURNAL_PENDING
from vgate_tpu_torch.runtime.journal import RequestJournal
from vgate_tpu_torch.runtime.scheduler import EngineBusyError
from vgate_tpu_torch.security import build_security_middleware, extract_api_key
from vgate_tpu_torch.server.openai_models import (
    BenchmarkRequest,
    ChatCompletion,
    ChatCompletionRequest,
    Completion,
    CompletionRequest,
    ChatMessage,
    Choice,
    EmbeddingData,
    TextChoice,
    EmbeddingRequest,
    EmbeddingResponse,
    Usage,
    messages_to_prompt,
)
from vgate_tpu_torch.tracing import (
    capture_context,
    get_tracer,
    init_tracing,
    shutdown_tracing,
)
from vgate_tpu_torch.version import __version__

logger = get_logger(__name__)
tracer = get_tracer(__name__)

# Obligation contracts (vgtlint obligations checker): the true-
# streaming path charges the admission backlog OUTSIDE the batcher, and
# every handler holds a per-key in-flight fairness slot — both must be
# returned on every CFG path (a raise between the charge and its
# try/finally would leak the budget forever).
VGT_OBLIGATIONS = {
    "admission-backlog": {
        "acquire": ("*.admission.admit",),
        "release": ("*.admission.release",),
    },
    "inflight-slot": {
        "acquire": ("*.acquire_inflight",),
        "release": ("release_slot",),
    },
}

# asyncio.timeout is 3.11+; aiohttp's async_timeout dependency is the
# same context manager for the 3.10 interpreters this serves on
if hasattr(asyncio, "timeout"):  # pragma: no cover - py3.11+ images
    _timeout_ctx = asyncio.timeout
else:
    from async_timeout import timeout as _timeout_ctx

_QUIET_PATHS = {"/health", "/health/live", "/health/ready", "/metrics"}
# excluded from the drain's in-flight count: probes/scrapes (and /stats
# polls watching the drain itself) must never hold a drain open
_UNCOUNTED_PATHS = _QUIET_PATHS | {"/stats"}


def _drain_counted(path: str) -> bool:
    """Should this request hold a graceful drain open?  Probe, scrape
    and introspection surfaces (/debug — operators use it to watch a
    drain or diagnose the reason for one) never do, and neither do the
    /admin replica operations operators drive DURING a rollout."""
    return (
        path not in _UNCOUNTED_PATHS
        and not path.startswith("/debug")
        and not path.startswith("/admin")
    )
# non-standard but conventional (nginx): the client closed the
# connection before the response could be written — nobody reads the
# body, but metrics/logs get a truthful status
_STATUS_CLIENT_CLOSED = 499


def _error(status: int, message: str, err_type: str) -> web.Response:
    return web.json_response(
        {"error": {"message": message, "type": err_type}}, status=status
    )


class _InflightCounter:
    """Mutable in-place counter (aiohttp deprecates reassigning app keys
    after startup); single-threaded on the event loop, so bare +=."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0


@web.middleware
async def observability_middleware(request: web.Request, handler):
    """Request metrics + latency + X-Request-ID (reference: main.py:118-172).
    Also maintains the app-level in-flight counter the graceful drain
    waits on (probe/metrics paths excluded — a scraper must never hold
    the drain open)."""
    request_id = request.headers.get("X-Request-ID", uuid.uuid4().hex[:16])
    # visible to handlers (the streaming path stamps it onto the engine
    # sequence so /debug/requests/{X-Request-ID} finds the record)
    request["request_id"] = request_id
    start = time.perf_counter()
    metrics.REQUESTS_IN_PROGRESS.inc()
    counted = _drain_counted(request.path)
    if counted:
        request.app["inflight"].value += 1
    try:
        with tracer.start_as_current_span(
            f"{request.method} {request.path}"
        ) as span:
            span.set_attribute("http.method", request.method)
            span.set_attribute("http.route", request.path)
            response = await handler(request)
    except web.HTTPException as exc:
        metrics.REQUEST_COUNT.labels(
            method=request.method, endpoint=request.path, status=exc.status
        ).inc()
        raise
    except Exception:
        metrics.REQUEST_COUNT.labels(
            method=request.method, endpoint=request.path, status=500
        ).inc()
        logger.error("unhandled error", exc_info=True)
        return _error(500, "Internal server error", "server_error")
    finally:
        metrics.REQUESTS_IN_PROGRESS.dec()
        if counted:
            request.app["inflight"].value -= 1
    elapsed = time.perf_counter() - start
    metrics.inc_with_exemplar(
        metrics.REQUEST_COUNT.labels(
            method=request.method,
            endpoint=request.path,
            status=response.status,
        )
    )
    metrics.observe_with_exemplar(
        metrics.REQUEST_LATENCY.labels(
            method=request.method, endpoint=request.path
        ),
        elapsed,
    )
    response.headers["X-Request-ID"] = request_id
    if request.path not in _QUIET_PATHS:
        logger.info(
            "request complete",
            extra={
                "extra_data": {
                    "method": request.method,
                    "path": request.path,
                    "status": response.status,
                    "latency_ms": round(elapsed * 1000, 2),
                    "request_id": request_id,
                }
            },
        )
    return response


def _retry_after(exc: BaseException, default: float = 1.0) -> str:
    """Whole-second ``Retry-After`` header value from an error's hint."""
    return str(max(1, int(round(getattr(exc, "retry_after", default)))))


def _unavailable_503(exc: BaseException, message: str) -> web.Response:
    """503 + Retry-After for every RetryableError flavor, carrying the
    error's ``reason`` (overloaded | draining | recovering | dead |
    unavailable) so clients — the SDK's typed ``ServerOverloadedError``
    among them — can tell deliberate load shedding from a replica going
    away without parsing message strings."""
    resp = web.json_response(
        {
            "error": {
                "message": message,
                "type": "overloaded_error",
                "reason": getattr(exc, "reason", "unavailable"),
            }
        },
        status=503,
    )
    resp.headers["Retry-After"] = _retry_after(exc)
    return resp


def _quota_429(exc: ClientQuotaExceededError) -> web.Response:
    """429 + Retry-After for the per-key in-flight cap — the rate-limit
    status (client-scoped fairness), distinct from the 503 the
    admission controller uses for whole-server shedding."""
    resp = _error(429, str(exc), "rate_limit_error")
    resp.headers["Retry-After"] = _retry_after(exc)
    return resp


# ------------------------------------------------ idempotency (journal)

_IDEMPOTENCY_HEADER = "Idempotency-Key"
# inherited-pending poll cadence: the startup replay (or an adopted
# worker's done frame) settles the record; sub-second detection is
# plenty against whole-seconds of decode
_IDEM_AWAIT_POLL_S = 0.25


def _duplicate_409(exc: DuplicateRequestError) -> web.Response:
    """409 for a retried Idempotency-Key whose original attempt is
    still in flight in THIS gateway lifetime — two generations must
    never race under one key.  Retry-After tells well-behaved clients
    when the original will plausibly have settled."""
    resp = web.json_response(
        {
            "error": {
                "message": str(exc),
                "type": "duplicate_request_error",
                "reason": getattr(exc, "reason", "duplicate_request"),
            }
        },
        status=409,
    )
    resp.headers["Retry-After"] = _retry_after(exc)
    return resp


def _replay_response(result: Dict[str, Any]) -> web.Response:
    """Serve a journaled result body for a retried key: identical
    payload, zero recompute, marked ``replayed`` so clients can tell."""
    body = dict(result)
    body["replayed"] = True
    return web.json_response(body)


async def _idempotency_begin(
    request: web.Request,
    endpoint: str,
    snapshot: Optional[Dict[str, Any]],
) -> tuple:
    """Admission decision for a keyed request: ``(key, response)``.

    ``key`` is None when the request is unkeyed/ineligible (no journal
    configured, no header, or ``snapshot`` is None — fan-out shapes the
    startup replay cannot reconstruct).  ``response`` short-circuits
    the handler: a settled key replays its stored body
    (``vgt_journal_replays{outcome="served"}``), a same-lifetime
    pending key 409s (``outcome="duplicate"``), and a pending key
    INHERITED from a crashed predecessor waits here for the startup
    replay / adopted worker to settle it — never a dead-end 409 for
    work the crash orphaned."""
    journal: Optional[RequestJournal] = request.app.get("journal")
    key = request.headers.get(_IDEMPOTENCY_HEADER)
    if journal is None or not key or snapshot is None:
        return None, None
    engine: VGTEngine = request.app["engine"]
    deadline = (
        time.monotonic() + engine.config.server.request_timeout_s
    )
    while True:
        try:
            outcome, result = journal.begin(
                key, request["request_id"], endpoint, snapshot
            )
        except DuplicateRequestError as exc:
            metrics.JOURNAL_REPLAYS.labels(outcome="duplicate").inc()
            return key, _duplicate_409(exc)
        if outcome == "replay" and result is not None:
            metrics.JOURNAL_REPLAYS.labels(outcome="served").inc()
            return key, _replay_response(result)
        if outcome == "fresh":
            return key, None
        # "await": inherited pending — the replay owns it; poll
        if time.monotonic() >= deadline:
            metrics.JOURNAL_REPLAYS.labels(outcome="failed").inc()
            return key, _error(
                504,
                f"Idempotency-Key {key!r} was accepted by a previous "
                "gateway and its replay did not settle in time",
                "timeout_error",
            )
        await asyncio.sleep(_IDEM_AWAIT_POLL_S)


def _journal_settle(
    request: web.Request, key: Optional[str], body: Dict[str, Any]
) -> None:
    if not key:
        return
    journal: Optional[RequestJournal] = request.app.get("journal")
    if journal is not None:
        journal.settle(key, body)


def _journal_fail(request: web.Request, key: Optional[str]) -> None:
    """Release a key after a terminal failure so a retry runs fresh
    instead of replaying an error or 409ing forever."""
    if not key:
        return
    journal: Optional[RequestJournal] = request.app.get("journal")
    if journal is not None:
        journal.fail(key)


def _request_api_key(request: web.Request) -> Optional[str]:
    """Bearer key for tier mapping + per-key caps: the security
    middleware stashes it when auth is on; otherwise fall back to
    extracting it directly so admission.key_tiers works on deployments
    without auth enabled."""
    return request.get("api_key") or extract_api_key(request)


def _effective_timeout(request: web.Request, body_timeout) -> float:
    """Per-request end-to-end deadline in seconds: the tightest of the
    server cap (``server.request_timeout_s``), the ``X-Request-Timeout``
    header and the ``timeout`` body field.  Raises ValueError (→ 422)
    on a malformed/non-positive header."""
    engine: VGTEngine = request.app["engine"]
    timeout = engine.config.server.request_timeout_s
    header = request.headers.get("X-Request-Timeout")
    if header is not None:
        try:
            value = float(header)
        except ValueError:
            raise ValueError(
                f"X-Request-Timeout must be seconds, got {header!r}"
            )
        if value <= 0:
            raise ValueError(
                f"X-Request-Timeout must be positive, got {value}"
            )
        timeout = min(timeout, value)
    if body_timeout is not None:
        timeout = min(timeout, body_timeout)
    return timeout


def _watch_disconnect(
    request: web.Request, token: CancelToken, poll_s: float = 0.25
) -> "asyncio.Task":
    """Disconnect watcher for non-streaming handlers: aiohttp does not
    cancel handler tasks when the peer goes away (default
    handler_cancellation=False), so generation for a vanished client
    would decode to completion.  Poll the transport; on close, fire the
    request's CancelToken — the batcher dequeues a queued request, the
    backend aborts a decoding one (slot + KV pages free within a tick).
    The caller cancels the task when the request settles first.  The
    0.25s cadence keeps per-request polling cost negligible — the shed
    saves whole seconds of decode, so sub-second detection is plenty.
    (Deployments running handler_cancellation=True get the same effect
    via batcher.submit's CancelledError path, with no polling at all.)"""

    async def _watch() -> None:
        while not token.cancelled:
            transport = request.transport
            if transport is None or transport.is_closing():
                token.cancel("client_disconnect")
                return
            await asyncio.sleep(poll_s)

    return asyncio.ensure_future(_watch())


@web.middleware
async def drain_middleware(request: web.Request, handler):
    """One admission gate for every work-accepting endpoint while the
    server drains (SIGTERM received): POSTs under /v1/ shed with 503 +
    Retry-After.  A single middleware instead of per-handler checks so
    a newly added endpoint can never silently miss the gate; GETs
    (health, stats, metrics, models) stay up for observers, and the
    batcher's own ServerDrainingError covers non-HTTP callers."""
    drain: Optional[DrainController] = request.app.get("drain")
    if (
        drain is not None
        and drain.draining
        and request.method == "POST"
        and request.path.startswith("/v1/")
    ):
        exc = ServerDrainingError(retry_after=drain.retry_after_s)
        return _unavailable_503(exc, str(exc))
    return await handler(request)


def _engine_health(engine: Optional[VGTEngine]) -> Dict[str, Any]:
    """Engine liveness/state block — ALWAYS present in /health, even for
    backends without device_health (satellite fix): state-machine
    position (runtime/supervisor.py) and scheduler queue depth."""
    if engine is None:
        return {"state": "starting", "alive": False, "ready": False}
    health_fn = getattr(engine.backend, "serving_health", None)
    if health_fn is not None:
        try:
            return health_fn()
        except Exception:
            logger.error("serving_health failed", exc_info=True)
            return {"state": "dead", "alive": False, "ready": False}
    # backends without the full recovery surface (dry-run, vllm,
    # sglang): use their state string when they expose one, else
    # loaded == serving
    state_fn = getattr(engine.backend, "serving_state", None)
    state = state_fn() if state_fn is not None else "serving"
    return {
        "state": state,
        "alive": state_is_alive(state),
        "ready": state_is_ready(state),
        "queue_depth": 0,
    }


async def health(request: web.Request) -> web.Response:
    """Combined health report (reference: main.py:199-204) — readiness
    semantics: 200 only while the engine can accept work.  Split probes
    live at /health/live and /health/ready (docs/operations.md)."""
    engine: Optional[VGTEngine] = request.app.get("engine")
    eng = _engine_health(engine)
    drain: Optional[DrainController] = request.app.get("drain")
    if drain is not None and drain.draining:
        # SIGTERM received: leave the LB set (ready 503) while in-flight
        # work finishes; liveness is untouched
        eng["state"] = "draining"
        eng["ready"] = False
    batcher: Optional[RequestBatcher] = request.app.get("batcher")
    if batcher is not None:
        eng["batcher_pending"] = len(batcher._queue)
    body: Dict[str, Any] = {
        "status": (
            "ok" if eng.get("ready")
            else ("starting" if engine is None else eng["state"])
        ),
        "version": __version__,
        "engine": eng,
    }
    if batcher is not None:
        # overload surface: brownout level + active degradation steps
        # (admission detail lives in /stats)
        body["pressure"] = batcher.pressure.brief()
    if engine is not None:
        body["model"] = engine.config.model.model_id
        body["engine_type"] = type(engine.backend).__name__
        device_health = getattr(engine.backend, "device_health", None)
        if device_health is not None:
            body["device"] = device_health()
    status = 200 if eng.get("ready") else 503
    resp = web.json_response(body, status=status)
    if status == 503:
        resp.headers["Retry-After"] = "5"
    return resp


async def health_live(request: web.Request) -> web.Response:
    """Liveness probe: 200 unless the health state machine is DEAD (the
    orchestrator should then recycle the pod).  Startup and RECOVERING
    are alive — killing a pod mid-recovery only loses the warm weights."""
    engine: Optional[VGTEngine] = request.app.get("engine")
    eng = _engine_health(engine)
    alive = engine is None or eng.get("alive", True)
    return web.json_response(
        {"status": "ok" if alive else "dead", "engine": eng},
        status=200 if alive else 503,
    )


async def health_ready(request: web.Request) -> web.Response:
    """Readiness probe: 200 only in SERVING/DEGRADED — while RECOVERING
    or DEAD the pod must leave the load-balancer set instead of queuing
    traffic into a dead engine."""
    engine: Optional[VGTEngine] = request.app.get("engine")
    eng = _engine_health(engine)
    drain: Optional[DrainController] = request.app.get("drain")
    if drain is not None and drain.draining:
        eng["state"] = "draining"
        eng["ready"] = False
    ready = engine is not None and eng.get("ready", False)
    resp = web.json_response(
        {"status": "ok" if ready else eng["state"], "engine": eng},
        status=200 if ready else 503,
    )
    if not ready:
        resp.headers["Retry-After"] = "5"
    return resp


def _build_prompt(engine: VGTEngine, messages) -> str:
    """Prefer the model tokenizer's own chat template (HF tokenizers ship
    one); fall back to the reference's "Role: content" flattening
    (main.py:190-196) for byte/dry-run tokenizers."""
    core = getattr(engine.backend, "core", None)
    tokenizer = getattr(core, "tokenizer", None)
    render = getattr(tokenizer, "apply_chat_template", None)
    if render is not None:
        try:
            rendered = render([m.model_dump() for m in messages])
            if rendered:
                return rendered
        except Exception:
            logger.warning(
                "chat template rendering failed; using flattening",
                exc_info=True,
            )
    return messages_to_prompt(messages)



def _n_plan(engine: VGTEngine, temperature, seed, n: int):
    """(n_submits, deterministic): greedy unseeded requests are
    deterministic, so one generation serves all n choices."""
    eff = (
        temperature
        if temperature is not None
        else engine.config.inference.temperature
    )
    deterministic = eff <= 0.0 and seed is None
    return (1 if deterministic else n), deterministic


async def _settle_submits(engine: VGTEngine, coros):
    """Gather submissions (settling everything — a plain gather would
    propagate the first failure while sibling generations keep running
    unobserved) and map failures to the standard HTTP responses.
    Returns (results, None) or (None, error_response)."""
    try:
        settled = await asyncio.gather(*coros, return_exceptions=True)
        for item in settled:
            if isinstance(item, BaseException):
                raise item
        return list(settled), None
    except DeadlineExceededError as exc:
        # engine-shed deadline: 504 with partial-generation metadata so
        # the client can tell "slow but generating" from "stuck", plus
        # the flight recorder's phase breakdown (queue/prefill/decode)
        # answering WHERE the budget went
        resp = web.json_response(
            {
                "error": {
                    "message": str(exc),
                    "type": "timeout_error",
                    "partial_tokens": exc.partial_tokens,
                    "partial_text": exc.partial_text,
                    "phases": exc.phases,
                }
            },
            status=504,
        )
        return None, resp
    except asyncio.TimeoutError:
        return None, _error(
            504,
            "Request exceeded its deadline "
            f"(server cap {engine.config.server.request_timeout_s:.0f}s)",
            "timeout_error",
        )
    except ClientDisconnectError:
        # nobody is listening; the 499 is for metrics/logs only
        return None, web.json_response(
            {
                "error": {
                    "message": "client closed the connection",
                    "type": "client_disconnect",
                }
            },
            status=_STATUS_CLIENT_CLOSED,
        )
    except PoisonRequestError as exc:
        # quarantined: resending can never succeed, so NOT retryable
        return None, _error(400, str(exc), "invalid_request_error")
    except ClientQuotaExceededError as exc:
        # per-key in-flight cap (admission.per_key_max_inflight): the
        # client-scoped 429, not the server-scoped 503
        return None, _quota_429(exc)
    except RetryableError as exc:
        # admission shed / engine crashed / draining / dead: retryable
        # 503 carrying the server-suggested backoff and the reason
        return None, _unavailable_503(exc, f"Engine unavailable: {exc}")
    except EngineBusyError as exc:
        return None, _unavailable_503(exc, f"Engine overloaded: {exc}")
    except Exception as exc:
        return None, _error(500, f"Inference failed: {exc}", "server_error")


def _chat_snapshot(
    payload: ChatCompletionRequest,
    prompt: str,
    logit_bias,
    timeout_s: float,
    model: str,
) -> Optional[Dict[str, Any]]:
    """Journal snapshot for one chat completion — everything the
    startup replay needs to push the SAME work back through
    ``batcher.submit``.  n>1 fan-out returns None (ineligible: the
    replay reconstructs exactly one generation)."""
    if payload.n != 1:
        return None
    return {
        "model": model,
        "prompt": prompt,
        "submit": {
            "max_tokens": payload.effective_max_tokens(),
            "min_tokens": payload.min_tokens,
            "temperature": payload.temperature,
            "top_p": payload.top_p,
            "top_k": payload.top_k,
            "stop": payload.stop_list(),
            "stop_token_ids": payload.stop_token_ids,
            "seed": payload.seed,
            "timeout_s": timeout_s,
            "logprobs": payload.logprobs or bool(payload.top_logprobs),
            "top_logprobs": payload.top_logprobs or 0,
            "frequency_penalty": payload.frequency_penalty or 0.0,
            "presence_penalty": payload.presence_penalty or 0.0,
            "logit_bias": logit_bias,
        },
    }


async def chat_completions(request: web.Request) -> web.Response:
    """POST /v1/chat/completions (reference: main.py:207-252)."""
    try:
        payload = ChatCompletionRequest(**await request.json())
    except (ValidationError, ValueError) as exc:
        return _error(422, f"Invalid request: {exc}", "invalid_request_error")
    if not payload.messages:
        return _error(422, "messages must be non-empty", "invalid_request_error")
    try:
        # bind once: invalid keys -> 422 (not a 500), and the submit
        # fan-out below reuses the normalized dict per choice
        logit_bias = payload.logit_bias_ints()
    except ValueError as exc:
        return _error(
            422, f"Invalid logit_bias: {exc}", "invalid_request_error"
        )
    batcher: RequestBatcher = request.app["batcher"]
    engine: VGTEngine = request.app["engine"]
    try:
        timeout_s = _effective_timeout(request, payload.timeout)
    except ValueError as exc:
        return _error(422, str(exc), "invalid_request_error")
    prompt = _build_prompt(engine, payload.messages)

    if payload.stream:
        if payload.n > 1:
            return _error(
                422, "n > 1 is not supported with stream=true",
                "invalid_request_error",
            )
        stream_key = _request_api_key(request)
        tier = batcher.admission.resolve_tier(
            payload.priority, stream_key
        )
        # one per-key slot per CLIENT request (the fairness cap must
        # never count internal fan-out, and a 429 here is a real
        # status line, not an SSE event).  The slot is acquired LAST
        # before the try that owns its release: anything that can
        # raise in between would leak the slot forever (obligations
        # checker, R001).
        if getattr(engine.backend, "stream_async", None) is None:
            # replay path: token-budget admission happens inside
            # batcher.submit
            try:
                release_slot = batcher.admission.acquire_inflight(
                    stream_key, tier=tier
                )
            except ClientQuotaExceededError as exc:
                return _quota_429(exc)
            try:
                return await _stream_chat(
                    request, payload, prompt, logit_bias, timeout_s
                )
            finally:
                release_slot()
        # true-streaming path bypasses the batcher, so admission runs
        # here — while the status line is still ours, a rejected stream
        # gets a real 503 instead of an SSE error event
        batcher.pressure.maybe_update()
        # same brownout clamp _stream_chat applies to the params: the
        # backlog must be charged what the engine will actually decode
        # — discounted by the predicted prefix-cache hit, like the
        # batcher path (admission.PrefixHintIndex)
        cost = batcher.admission.estimate_cost(
            prompt,
            batcher.pressure.clamp_max_tokens(
                payload.effective_max_tokens()
                or engine.config.inference.max_tokens
            ),
            prefix_cached=batcher._prefix_cache_on,
        )
        try:
            release_slot = batcher.admission.acquire_inflight(
                stream_key, tier=tier
            )
        except ClientQuotaExceededError as exc:
            return _quota_429(exc)
        try:
            batcher.admission.admit(cost, tier=tier, deadline_s=timeout_s)
        except RetryableError as exc:
            release_slot()
            return _unavailable_503(exc, str(exc))
        except BaseException:
            # an unexpected raise from admit must return the slot too
            release_slot()
            raise
        try:
            batcher.note_prompt_submitted(prompt)
            return await _stream_chat(
                request, payload, prompt, logit_bias, timeout_s,
                tier=tier,
            )
        finally:
            # nested so neither release can leak the other by raising
            try:
                release_slot()
            finally:
                batcher.admission.release(cost)

    # n choices run as n engine requests sampled concurrently (the
    # variant salt keeps them from deduping; prefix caching shares
    # their prompt KV); seeded requests use seed+i per choice.
    n_submits, deterministic = _n_plan(
        engine, payload.temperature, payload.seed, payload.n
    )
    # idempotency gate BEFORE any resource acquisition: a replayed or
    # duplicate key must not charge admission or burn a fairness slot
    idem_key, idem_resp = await _idempotency_begin(
        request,
        "/v1/chat/completions",
        _chat_snapshot(
            payload,
            prompt,
            logit_bias,
            timeout_s,
            payload.model or engine.config.model.model_id,
        ),
    )
    if idem_resp is not None:
        return idem_resp
    api_key = _request_api_key(request)
    # the per-key fairness cap charges the CLIENT request once — its n
    # fan-out submits below are one client action, not n.  Watcher
    # setup precedes the slot acquisition: nothing may raise between
    # acquiring the slot and the try/finally that returns it
    # (obligations checker, R001).
    token = CancelToken()
    watcher = _watch_disconnect(request, token)
    try:
        release_slot = batcher.admission.acquire_inflight(
            api_key,
            tier=batcher.admission.resolve_tier(payload.priority, api_key),
        )
    except ClientQuotaExceededError as exc:
        watcher.cancel()
        _journal_fail(request, idem_key)
        return _quota_429(exc)
    except BaseException:
        # the polling watcher task must not outlive a failed acquire
        watcher.cancel()
        _journal_fail(request, idem_key)
        raise
    try:
        settled, err = await _settle_submits(
            engine,
            (
                batcher.submit(
                    prompt,
                    max_tokens=payload.effective_max_tokens(),
                    min_tokens=payload.min_tokens,
                    temperature=payload.temperature,
                    top_p=payload.top_p,
                    top_k=payload.top_k,
                    stop=payload.stop_list(),
                    stop_token_ids=payload.stop_token_ids,
                    seed=(
                        payload.seed + i if payload.seed is not None else None
                    ),
                    timeout_s=timeout_s,
                    logprobs=payload.logprobs or bool(payload.top_logprobs),
                    top_logprobs=payload.top_logprobs or 0,
                    variant=i,
                    frequency_penalty=payload.frequency_penalty or 0.0,
                    presence_penalty=payload.presence_penalty or 0.0,
                    logit_bias=logit_bias,
                    cancel_token=token,
                    priority=payload.priority,
                    api_key=api_key,
                    # the gateway's X-Request-ID (middleware-assigned
                    # when absent) so /debug/requests/{X-Request-ID}
                    # finds the engine record; extra n-variants get a
                    # disambiguating suffix
                    request_id=(
                        request["request_id"] if i == 0
                        else f"{request['request_id']}:{i}"
                    ),
                )
                for i in range(n_submits)
            ),
        )
    except BaseException:
        # cancellation (or anything _settle_submits lets escape) must
        # release the key, or every retry 409s for the whole lifetime
        _journal_fail(request, idem_key)
        raise
    finally:
        # nested so a raising watcher.cancel cannot leak the slot
        try:
            watcher.cancel()
        finally:
            release_slot()
    if err is not None:
        _journal_fail(request, idem_key)
        return err
    results = (settled * (payload.n if deterministic else 1))[: payload.n]
    result = results[0]
    # usage is PER-CHOICE: n deterministic (temperature 0) choices share
    # one generation but still bill n x its tokens, exactly like n
    # sampled choices — clients see uniform accounting regardless of
    # whether the engine deduped the compute (a documented decision:
    # per-choice semantics over actual-compute semantics)
    completion_tokens = sum(r.get("num_tokens", 0) for r in results)
    completion = ChatCompletion(
        model=payload.model or engine.config.model.model_id,
        choices=[
            Choice(
                index=i,
                message=ChatMessage(role="assistant", content=r["text"]),
                finish_reason=r.get("finish_reason", "stop"),
                logprobs=(
                    {"content": r["logprobs"]}
                    if r.get("logprobs") is not None
                    else None
                ),
            )
            for i, r in enumerate(results)
        ],
        usage=Usage(
            prompt_tokens=result.get("prompt_tokens", 0),
            completion_tokens=completion_tokens,
            total_tokens=result.get("prompt_tokens", 0)
            + completion_tokens,
        ),
        cached=result.get("cached", False),
        resumed=result.get("resumed", False),
        migrated=result.get("migrated", False),
        disaggregated=result.get("disaggregated", False),
        metrics=result.get("metrics", {}),
    )
    body = completion.model_dump()
    _journal_settle(request, idem_key, body)
    return web.json_response(body)


async def _stream_chat(
    request: web.Request, payload: ChatCompletionRequest, prompt: str,
    logit_bias=None, timeout_s: Optional[float] = None,
    tier: Optional[str] = None,
) -> web.StreamResponse:
    """SSE streaming.  Uses the backend's token stream when it has one;
    otherwise generates fully and replays in chunks (dry-run path).
    Client disconnect mid-stream already propagates: closing the
    response generator aborts the engine sequence (stream_async's
    finally clause); ``timeout_s`` is the request's effective deadline
    (surfaced as an SSE timeout_error event — the 200 is on the wire)."""
    engine: VGTEngine = request.app["engine"]
    batcher: RequestBatcher = request.app["batcher"]
    if timeout_s is None:
        timeout_s = engine.config.server.request_timeout_s
    resp = web.StreamResponse(
        status=200,
        headers={
            "Content-Type": "text/event-stream",
            "Cache-Control": "no-cache",
        },
    )
    await resp.prepare(request)
    completion_id = f"chatcmpl-{uuid.uuid4().hex[:24]}"
    model_id = payload.model or engine.config.model.model_id

    def _chunk(
        delta: Dict[str, Any],
        finish: Optional[str] = None,
        logprobs: Optional[list] = None,
    ) -> bytes:
        choice: Dict[str, Any] = {
            "index": 0, "delta": delta, "finish_reason": finish,
        }
        if logprobs is not None:
            choice["logprobs"] = {"content": logprobs}
        body = {
            "id": completion_id,
            "object": "chat.completion.chunk",
            "created": int(time.time()),
            "model": model_id,
            "choices": [choice],
        }
        return f"data: {json.dumps(body)}\n\n".encode()

    await resp.write(_chunk({"role": "assistant"}))
    finish_reason = {"value": "stop"}
    want_usage = bool(
        payload.stream_options and payload.stream_options.include_usage
    )
    usage_box: Dict[str, Any] = {"value": None}

    def _usage_chunk() -> bytes:
        # OpenAI stream_options.include_usage: a final pre-[DONE] chunk
        # with an EMPTY choices list carrying the usage
        body = {
            "id": completion_id,
            "object": "chat.completion.chunk",
            "created": int(time.time()),
            "model": model_id,
            "choices": [],
            "usage": usage_box["value"],
        }
        return f"data: {json.dumps(body)}\n\n".encode()

    stream_fn = getattr(engine.backend, "stream_async", None)
    if stream_fn is not None:
        params = engine.backend.create_sampling_params(
            max_tokens=batcher.pressure.clamp_max_tokens(
                payload.effective_max_tokens()
                or engine.config.inference.max_tokens
            ),
            min_tokens=payload.min_tokens,
            temperature=(
                payload.temperature
                if payload.temperature is not None
                else engine.config.inference.temperature
            ),
            top_p=(
                payload.top_p
                if payload.top_p is not None
                else engine.config.inference.top_p
            ),
            top_k=(
                payload.top_k
                if payload.top_k is not None
                else engine.config.inference.top_k
            ),
            stop=payload.stop_list(),
            stop_token_ids=payload.stop_token_ids,
            seed=payload.seed,
            logprobs=payload.logprobs or bool(payload.top_logprobs),
            top_logprobs=payload.top_logprobs or 0,
            frequency_penalty=payload.frequency_penalty or 0.0,
            presence_penalty=payload.presence_penalty or 0.0,
            logit_bias=logit_bias,
            priority=tier_rank(tier) if tier else 1,
        )
        try:
            import inspect

            kwargs = {}
            stream_params = inspect.signature(stream_fn).parameters
            if "on_finish" in stream_params:
                kwargs["on_finish"] = (
                    lambda r: finish_reason.__setitem__("value", r)
                )
            if "on_usage" in stream_params:
                # always captured (emission to the client stays gated
                # on want_usage): streaming bypasses the batcher, so
                # this is where its completions feed the admission
                # throughput EWMA
                kwargs["on_usage"] = (
                    lambda u: usage_box.__setitem__("value", u)
                )
            if (
                "request_meta" in stream_params
                and engine.config.observability.enabled
            ):
                # streaming bypasses the batcher, so the trace context
                # and request id cross the seam here instead
                kwargs["request_meta"] = RequestMeta(
                    request_id=request.get("request_id"),
                    trace_ctx=capture_context(),
                )
            async with _timeout_ctx(timeout_s):
                async for piece in stream_fn(prompt, params, **kwargs):
                    if isinstance(piece, dict):  # logprobs-carrying delta
                        await resp.write(
                            _chunk(
                                {"content": piece["text"]},
                                logprobs=piece["logprobs"] or None,
                            )
                        )
                    else:
                        await resp.write(_chunk({"content": piece}))
            if usage_box["value"] is not None:
                batcher.admission.observe_completion(
                    usage_box["value"].get("completion_tokens", 0)
                )
        # both spellings: on py3.10 the async_timeout shim raises
        # asyncio.TimeoutError, which is NOT the builtin TimeoutError
        # there (they merged in 3.11)
        except (TimeoutError, asyncio.TimeoutError):
            await resp.write(
                b'data: {"error": {"message": "request timed out", '
                b'"type": "timeout_error"}}\n\n'
            )
            await resp.write(b"data: [DONE]\n\n")
            await resp.write_eof()
            return resp
        except (RetryableError, PoisonRequestError) as exc:
            # engine crashed mid-stream (or the prompt is quarantined):
            # the 200 is already on the wire, so the failure travels as
            # an SSE error event the client can act on
            err_type = (
                "invalid_request_error"
                if isinstance(exc, PoisonRequestError)
                else "overloaded_error"
            )
            await resp.write(
                f'data: {{"error": {{"message": {json.dumps(str(exc))}, '
                f'"type": "{err_type}"}}}}\n\n'.encode()
            )
            await resp.write(b"data: [DONE]\n\n")
            await resp.write_eof()
            return resp
    else:
        try:
            result = await batcher.submit(
                prompt,
                max_tokens=payload.effective_max_tokens(),
                min_tokens=payload.min_tokens,
                temperature=payload.temperature,
                top_p=payload.top_p,
                top_k=payload.top_k,
                stop=payload.stop_list(),
                stop_token_ids=payload.stop_token_ids,
                seed=payload.seed,
                timeout_s=timeout_s,
                logprobs=payload.logprobs or bool(payload.top_logprobs),
                top_logprobs=payload.top_logprobs or 0,
                frequency_penalty=payload.frequency_penalty or 0.0,
                presence_penalty=payload.presence_penalty or 0.0,
                logit_bias=logit_bias,
                priority=payload.priority,
                api_key=_request_api_key(request),
            )
        except (
            asyncio.TimeoutError, DeadlineExceededError, EngineBusyError,
            RetryableError, PoisonRequestError, ClientQuotaExceededError,
        ) as exc:
            # the 200 + role chunk are already on the wire: deliver the
            # failure as an SSE error event, not a reset connection
            if isinstance(
                exc, (asyncio.TimeoutError, DeadlineExceededError)
            ):
                err_type = "timeout_error"
            elif isinstance(exc, PoisonRequestError):
                err_type = "invalid_request_error"
            elif isinstance(exc, ClientQuotaExceededError):
                err_type = "rate_limit_error"
            else:
                err_type = "overloaded_error"
            await resp.write(
                f'data: {{"error": {{"message": "{err_type}", '
                f'"type": "{err_type}"}}}}\n\n'.encode()
            )
            await resp.write(b"data: [DONE]\n\n")
            await resp.write_eof()
            return resp
        finish_reason["value"] = result.get("finish_reason", "stop")
        if want_usage:
            pt = result.get("prompt_tokens", 0)
            ct = result.get("num_tokens", 0)
            usage_box["value"] = {
                "prompt_tokens": pt,
                "completion_tokens": ct,
                "total_tokens": pt + ct,
            }
        text = result["text"]
        step = max(1, len(text) // 16)
        for i in range(0, len(text), step):
            await resp.write(_chunk({"content": text[i : i + step]}))
        # replayed (non-streaming-backend) path: deliver the whole
        # logprobs content with the closing chunk
        if result.get("logprobs") is not None:
            await resp.write(
                _chunk(
                    {}, finish=finish_reason["value"],
                    logprobs=result["logprobs"],
                )
            )
            if want_usage and usage_box["value"] is not None:
                await resp.write(_usage_chunk())
            await resp.write(b"data: [DONE]\n\n")
            await resp.write_eof()
            return resp
    await resp.write(_chunk({}, finish=finish_reason["value"]))
    if want_usage and usage_box["value"] is not None:
        await resp.write(_usage_chunk())
    await resp.write(b"data: [DONE]\n\n")
    await resp.write_eof()
    return resp


def _legacy_logprobs(entries, offset0: int = 0):
    """Chat-shape logprob entries -> the legacy /v1/completions schema
    ({tokens, token_logprobs, top_logprobs, text_offset}) that legacy
    consumers (e.g. eval harnesses) read."""
    if entries is None:
        return None
    tokens, token_lps, tops, offsets = [], [], [], []
    pos = offset0
    for e in entries:
        tokens.append(e["token"])
        token_lps.append(e["logprob"])
        tops.append({t["token"]: t["logprob"] for t in e["top_logprobs"]})
        offsets.append(pos)
        pos += len(e["token"])
    return {
        "tokens": tokens,
        "token_logprobs": token_lps,
        "top_logprobs": tops,
        "text_offset": offsets,
    }


def _completion_snapshot(
    payload: CompletionRequest,
    prompts,
    logit_bias,
    timeout_s: float,
    model: str,
) -> Optional[Dict[str, Any]]:
    """Journal snapshot for one legacy completion.  Multi-prompt,
    n>1/best_of fan-out and echo return None (ineligible shapes: the
    startup replay reconstructs exactly one plain generation)."""
    if (
        len(prompts) != 1
        or payload.n != 1
        or (payload.best_of or 1) != 1
        or payload.echo
    ):
        return None
    return {
        "model": model,
        "prompt": prompts[0],
        "submit": {
            "max_tokens": payload.max_tokens,
            "min_tokens": payload.min_tokens,
            "temperature": payload.temperature,
            "top_p": payload.top_p,
            "top_k": payload.top_k,
            "stop": payload.stop_list(),
            "stop_token_ids": payload.stop_token_ids,
            "seed": payload.seed,
            "timeout_s": timeout_s,
            "logprobs": payload.logprobs is not None,
            "top_logprobs": payload.logprobs or 0,
            "frequency_penalty": payload.frequency_penalty or 0.0,
            "presence_penalty": payload.presence_penalty or 0.0,
            "logit_bias": logit_bias,
        },
    }


async def completions(request: web.Request) -> web.Response:
    """POST /v1/completions — the legacy text-completion surface (no chat
    template; the prompt goes to the engine verbatim).  Supports string or
    list-of-strings prompts, n choices per prompt, stop/seed/logprobs with
    the same semantics as chat.

    ``echo`` limitation (documented): echo=true prepends the
    prompt TEXT but logprobs arrays cover COMPLETION tokens only — there
    are no prompt-token entries, and max_tokens >= 1 is enforced, so the
    max_tokens=0 echo+logprobs loglikelihood-scoring idiom some eval
    harnesses use is not supported (the engine's prompt pass computes
    last-position logits only; scoring all prompt positions is a
    different device program).  ``text_offset`` still accounts for the
    echoed prompt, so completion-token offsets are correct."""
    try:
        payload = CompletionRequest(**await request.json())
    except (ValidationError, ValueError) as exc:
        return _error(422, f"Invalid request: {exc}", "invalid_request_error")
    if payload.stream:
        return _error(
            422, "stream is not supported on /v1/completions "
            "(use /v1/chat/completions for SSE)", "invalid_request_error",
        )
    try:
        logit_bias = payload.logit_bias_ints()  # invalid -> 422
    except ValueError as exc:
        return _error(
            422, f"Invalid logit_bias: {exc}", "invalid_request_error"
        )
    prompts = payload.prompt_list()
    if not prompts:
        return _error(422, "prompt must be non-empty", "invalid_request_error")
    if payload.best_of is not None and payload.best_of < payload.n:
        return _error(
            422, f"best_of ({payload.best_of}) must be >= n ({payload.n})",
            "invalid_request_error",
        )
    best_of = payload.best_of or payload.n
    batcher: RequestBatcher = request.app["batcher"]
    engine: VGTEngine = request.app["engine"]
    try:
        timeout_s = _effective_timeout(request, payload.timeout)
    except ValueError as exc:
        return _error(422, str(exc), "invalid_request_error")
    n_submits, deterministic = _n_plan(
        engine, payload.temperature, payload.seed, best_of
    )
    # legacy semantics: logprobs=0 still returns per-token logprobs, with
    # zero alternatives
    want_lp = payload.logprobs is not None
    # best_of > n ranks candidates by mean token logprob server-side, so
    # logprobs are requested internally even when the client didn't ask
    ranking = not deterministic and best_of > payload.n

    # idempotency gate BEFORE any resource acquisition (same ordering
    # contract as chat)
    idem_key, idem_resp = await _idempotency_begin(
        request,
        "/v1/completions",
        _completion_snapshot(
            payload,
            prompts,
            logit_bias,
            timeout_s,
            payload.model or engine.config.model.model_id,
        ),
    )
    if idem_resp is not None:
        return idem_resp
    api_key = _request_api_key(request)
    # per-key cap: one slot per client request, not per fan-out submit.
    # Watcher setup precedes the slot acquisition: nothing may raise
    # between acquiring the slot and the try/finally that returns it
    # (obligations checker, R001).
    token = CancelToken()
    watcher = _watch_disconnect(request, token)
    try:
        release_slot = batcher.admission.acquire_inflight(
            api_key,
            tier=batcher.admission.resolve_tier(payload.priority, api_key),
        )
    except ClientQuotaExceededError as exc:
        watcher.cancel()
        _journal_fail(request, idem_key)
        return _quota_429(exc)
    except BaseException:
        # the polling watcher task must not outlive a failed acquire
        watcher.cancel()
        _journal_fail(request, idem_key)
        raise
    try:
        settled, err = await _settle_submits(
            engine,
            (
                batcher.submit(
                    p,
                    max_tokens=payload.max_tokens,
                    min_tokens=payload.min_tokens,
                    temperature=payload.temperature,
                    top_p=payload.top_p,
                    top_k=payload.top_k,
                    stop=payload.stop_list(),
                    stop_token_ids=payload.stop_token_ids,
                    seed=(
                        payload.seed + i if payload.seed is not None else None
                    ),
                    timeout_s=timeout_s,
                    logprobs=want_lp or ranking,
                    top_logprobs=payload.logprobs or 0,
                    # globally unique salt: duplicate prompts in the list must
                    # not dedup into one sample
                    variant=pi * best_of + i,
                    frequency_penalty=payload.frequency_penalty or 0.0,
                    presence_penalty=payload.presence_penalty or 0.0,
                    logit_bias=logit_bias,
                    cancel_token=token,
                    priority=payload.priority,
                    api_key=api_key,
                    request_id=(
                        request["request_id"]
                        if pi == 0 and i == 0
                        else (
                            f"{request['request_id']}"
                            f":{pi * best_of + i}"
                        )
                    ),
                )
                for pi, p in enumerate(prompts)
                for i in range(n_submits)
            ),
        )
    except BaseException:
        # cancellation must release the key (same contract as chat)
        _journal_fail(request, idem_key)
        raise
    finally:
        # nested so a raising watcher.cancel cannot leak the slot
        try:
            watcher.cancel()
        finally:
            release_slot()
    if err is not None:
        _journal_fail(request, idem_key)
        return err

    def mean_logprob(r) -> float:
        entries = r.get("logprobs") or []
        if not entries:
            return float("-inf")
        return sum(e["logprob"] for e in entries) / len(entries)

    choices = []
    prompt_tokens = 0
    completion_tokens = 0
    idx = 0
    for pi, p in enumerate(prompts):
        per_prompt = settled[pi * n_submits : (pi + 1) * n_submits]
        if ranking:
            # keep the n best candidates (OpenAI legacy: "the one with
            # the highest log probability per token"); the discarded
            # ones still burned decode steps, so usage counts ALL
            # best_of generations (the OpenAI accounting)
            ranked = sorted(per_prompt, key=mean_logprob, reverse=True)
            per_prompt = ranked[: payload.n]
            completion_tokens += sum(
                r.get("num_tokens", 0) for r in ranked[payload.n :]
            )
            if not want_lp:  # internal-only logprobs: strip from output
                per_prompt = [
                    {k: v for k, v in r.items() if k != "logprobs"}
                    for r in per_prompt
                ]
        per_prompt = (list(per_prompt) * payload.n)[: payload.n]
        prompt_tokens += per_prompt[0].get("prompt_tokens", 0)
        for r in per_prompt:
            text = r["text"]
            offset0 = 0
            if payload.echo:
                text = p + text
                offset0 = len(p)
            choices.append(
                TextChoice(
                    index=idx,
                    text=text,
                    finish_reason=r.get("finish_reason", "stop"),
                    logprobs=_legacy_logprobs(
                        r.get("logprobs"), offset0
                    ),
                )
            )
            completion_tokens += r.get("num_tokens", 0)
            idx += 1
    completion = Completion(
        model=payload.model or engine.config.model.model_id,
        choices=choices,
        usage=Usage(
            prompt_tokens=prompt_tokens,
            completion_tokens=completion_tokens,
            total_tokens=prompt_tokens + completion_tokens,
        ),
    )
    body = completion.model_dump()
    _journal_settle(request, idem_key, body)
    return web.json_response(body)


async def embeddings(request: web.Request) -> web.Response:
    """POST /v1/embeddings (reference: main.py:255-275)."""
    try:
        payload = EmbeddingRequest(**await request.json())
    except (ValidationError, ValueError) as exc:
        return _error(422, f"Invalid request: {exc}", "invalid_request_error")
    inputs = [payload.input] if isinstance(payload.input, str) else payload.input
    if not inputs:
        return _error(422, "input must be non-empty", "invalid_request_error")
    engine: VGTEngine = request.app["engine"]
    batcher: RequestBatcher = request.app["batcher"]
    try:
        timeout_s = _effective_timeout(request, None)
    except ValueError as exc:
        return _error(422, str(exc), "invalid_request_error")
    # idempotency: embeddings are deterministic, so a settled key's
    # stored body IS the recompute — replay serves it with zero work.
    # (An inherited pending embedding is NOT resubmitted at startup —
    # the retry recomputes fresh; see _replay_journal_pending.)
    idem_key, idem_resp = await _idempotency_begin(
        request, "/v1/embeddings", {"inputs": list(inputs)}
    )
    if idem_resp is not None:
        return idem_resp
    # embeddings skip the token-budget path (no decode backlog), but
    # the per-key in-flight fairness cap still applies
    emb_key = _request_api_key(request)
    # loop lookup BEFORE the slot acquisition: nothing may raise
    # between acquiring the slot and the try/finally that returns it
    # (obligations checker, R001)
    loop = asyncio.get_running_loop()
    try:
        release_slot = batcher.admission.acquire_inflight(
            emb_key,
            tier=batcher.admission.resolve_tier(
                payload.priority, emb_key
            ),
        )
    except ClientQuotaExceededError as exc:
        _journal_fail(request, idem_key)
        return _quota_429(exc)
    try:
        # the encoder pass is a sync executor hop (can't be cancelled
        # mid-flight), but the CLIENT's deadline is still honored with a
        # typed 504 — otherwise the SDK's embeddings timeout kwarg would
        # degrade to a transport timeout that gets retried as a
        # connection error
        result = await asyncio.wait_for(
            loop.run_in_executor(
                None, lambda: engine.embeddings(inputs)
            ),
            timeout_s,
        )
    except asyncio.TimeoutError:
        _journal_fail(request, idem_key)
        return _error(
            504,
            f"embedding request exceeded its deadline ({timeout_s:.3f}s)",
            "timeout_error",
        )
    except BaseException:
        _journal_fail(request, idem_key)
        raise
    finally:
        release_slot()
    response = EmbeddingResponse(
        data=[
            EmbeddingData(index=i, embedding=vec)
            for i, vec in enumerate(result["embeddings"])
        ],
        model=result["model"],
        usage=Usage(**result["usage"], completion_tokens=0),
    )
    body = response.model_dump()
    _journal_settle(request, idem_key, body)
    return web.json_response(body)


async def list_models(request: web.Request) -> web.Response:
    engine: VGTEngine = request.app["engine"]
    cfg = engine.config.model
    return web.json_response(
        {
            "object": "list",
            "data": [
                {
                    "id": cfg.model_id,
                    "object": "model",
                    "owned_by": "vgate-tpu",
                },
                {
                    "id": cfg.embedding_model_id,
                    "object": "model",
                    "owned_by": "vgate-tpu",
                },
            ],
        }
    )


async def prometheus_metrics(request: web.Request) -> web.Response:
    """GET /metrics with OpenMetrics negotiation (reference: main.py:278-295)."""
    body, content_type = metrics.render_metrics(request.headers.get("Accept", ""))
    return web.Response(body=body, content_type=content_type.split(";")[0],
                        charset="utf-8")


async def get_stats(request: web.Request) -> web.Response:
    """GET /stats mirroring batcher+cache+config state
    (reference: main.py:298-334)."""
    batcher: RequestBatcher = request.app["batcher"]
    engine: VGTEngine = request.app["engine"]
    stats = {
        # build identity (version / git sha / jax) — the same labels
        # vgt_build_info exports, so a scrape and a /stats curl agree
        # on exactly which build is serving
        "build": metrics.build_fingerprint(),
        "batcher": batcher.get_metrics(),
        "cache": batcher.cache.get_stats(),
        "admission": {
            **batcher.admission.get_stats(),
            "pressure": batcher.pressure.get_stats(),
            "queue_depths": batcher._queue.depths(),
        },
        "config": {
            "max_batch_size": engine.config.batch.max_batch_size,
            "max_wait_time_ms": engine.config.batch.max_wait_time_ms,
            "cache_enabled": engine.config.cache.enabled,
            "engine_type": engine.config.model.engine_type,
            "model": engine.config.model.model_id,
            # configured KV storage format — the engine section carries
            # the *resolved* dtype, but backends without get_stats
            # (dry-run drills) still need the config attributed
            "kv_dtype": engine.config.kv_cache.dtype,
        },
    }
    engine_stats = getattr(engine.backend, "get_stats", None)
    if engine_stats is not None:
        try:
            stats["engine"] = engine_stats()
        except Exception as exc:
            # a mid-rebuild or dead engine must not take the whole
            # stats surface down with a 500 — operators need /stats
            # MOST while the engine is unhealthy
            logger.error("engine stats failed", exc_info=True)
            stats["engine"] = {"error": f"{type(exc).__name__}: {exc}"}
    return web.json_response(stats)


def _faults_http_enabled() -> bool:
    """The live fault-arming surface is OFF unless the process opted in
    with ``VGT_FAULTS_HTTP=1`` — drills and the loadlab chaos arm set
    it; a production deployment never should (an armed fault is a real
    outage, auth or no auth)."""
    return os.environ.get("VGT_FAULTS_HTTP") == "1"


def _flight_recorder(request: web.Request):
    """The live engine's flight recorder, or None for backends without
    one (dry-run, external adapters).  Supervised engines delegate
    through EngineSupervisor.__getattr__ to the current core."""
    engine: Optional[VGTEngine] = request.app.get("engine")
    core = getattr(engine.backend, "core", None) if engine else None
    return getattr(core, "flight", None)


def _debug_n(request: web.Request, default: int = 128) -> int:
    try:
        n = int(request.query.get("n", default))
    except ValueError:
        return default
    return max(1, min(n, 4096))


async def debug_flight(request: web.Request) -> web.Response:
    """GET /debug/flight?n= — the engine flight recorder's most recent
    ticks (dispatches, readbacks, recompiles, sheds, aborts, crashes).
    Auth-gated like every non-exempt path; excluded from drain
    accounting like /stats."""
    rec = _flight_recorder(request)
    if rec is None:
        return web.json_response(
            {"enabled": False, "ticks": [],
             "reason": "engine has no flight recorder"}
        )
    return web.json_response(
        {"enabled": rec.enabled, "ticks": rec.ticks(_debug_n(request))}
    )


async def debug_requests(request: web.Request) -> web.Response:
    """GET /debug/requests?n= — in-flight and recently completed request
    records with per-phase timings."""
    rec = _flight_recorder(request)
    if rec is None:
        return web.json_response(
            {"enabled": False, "live": [], "completed": [],
             "reason": "engine has no flight recorder"}
        )
    return web.json_response(
        {
            "enabled": rec.enabled,
            "live": rec.live_requests(),
            "completed": rec.requests(_debug_n(request)),
        }
    )


async def debug_request_detail(request: web.Request) -> web.Response:
    """GET /debug/requests/{ident} — one request record by request id,
    trace id, or engine seq id (newest attempt wins)."""
    rec = _flight_recorder(request)
    if rec is None:
        return _error(
            404, "engine has no flight recorder", "invalid_request_error"
        )
    record = rec.find_request(request.match_info["ident"])
    if record is None:
        return _error(
            404,
            f"no request record for {request.match_info['ident']!r} "
            "(records are bounded rings; it may have aged out)",
            "invalid_request_error",
        )
    return web.json_response(record)


async def debug_perf(request: web.Request) -> web.Response:
    """GET /debug/perf — the engine's perf-attribution snapshot
    (observability/perf.py): rolling-window phase decomposition +
    tok/s / MFU / HBM-roofline / host-overhead gauges, the compile
    ledger, and the last /v1/profile capture.  Auth-gated like every
    non-exempt path; excluded from drain accounting like /debug."""
    engine: Optional[VGTEngine] = request.app.get("engine")
    core = getattr(engine.backend, "core", None) if engine else None
    snapshot_fn = getattr(core, "perf_snapshot", None)
    if snapshot_fn is None:
        return web.json_response(
            {"enabled": False,
             "reason": "engine has no perf recorder"}
        )
    try:
        return web.json_response(snapshot_fn())
    except Exception as exc:
        # a mid-rebuild engine must not 500 the attribution surface —
        # operators read it exactly while chasing a perf problem
        logger.error("perf snapshot failed", exc_info=True)
        return web.json_response(
            {"enabled": False,
             "error": f"{type(exc).__name__}: {exc}"}
        )


async def debug_pod(request: web.Request) -> web.Response:
    """GET /debug/pod — pod topology and RPC-plane detail: per-worker
    pid/epoch/role/state/beat-age/compiling/last-fatal plus in-flight
    load, the live KV-handoff table (state, worker pair, age), and the
    fencing/orphan counters.  Answers ``enabled: false`` (not 404) when
    the engine is not a worker pod, so probes read the same shape in
    every mode."""
    engine: Optional[VGTEngine] = request.app.get("engine")
    core = getattr(engine.backend, "core", None) if engine else None
    pod_fn = getattr(core, "pod_debug", None)
    if pod_fn is None:
        return web.json_response(
            {"enabled": False,
             "reason": "engine is not a worker pod (pod.workers = 0)"}
        )
    try:
        return web.json_response({"enabled": True, **pod_fn()})
    except Exception as exc:
        # a pod mid-failover must not 500 its own diagnosis surface
        logger.error("pod debug failed", exc_info=True)
        return web.json_response(
            {"enabled": True,
             "error": f"{type(exc).__name__}: {exc}"}
        )


def _replica_manager_of(app: web.Application):
    """The replica manager behind the /admin/replicas surface and the
    SIGUSR1 drain path — the dp ReplicatedEngine or the worker pod — or
    None: a dp=1 engine (EngineCore / EngineSupervisor) has no
    in-process migration target."""
    engine: Optional[VGTEngine] = app.get("engine")
    core = getattr(engine.backend, "core", None) if engine else None
    if core is not None and hasattr(core, "drain_replica"):
        return core
    return None


def _replica_manager(request: web.Request):
    return _replica_manager_of(request.app)


def _migration_enabled(request: web.Request) -> bool:
    config: VGTConfig = request.app["config"]
    return bool(config.migration.enabled)


def _replica_idx(request: web.Request) -> int:
    try:
        return int(request.match_info["idx"])
    except (KeyError, ValueError):
        raise web.HTTPNotFound(
            text=json.dumps(
                {"error": {"message": "replica index must be an integer",
                           "type": "invalid_request_error"}}
            ),
            content_type="application/json",
        )


async def _run_replica_op(
    request: web.Request, fn, idx_op: bool = True
) -> web.Response:
    """Run one blocking replica operation in the executor (a drain
    blocks on the worker's evacuation) and map the typed errors:
    ValueError → 404 (no such replica, for ``idx_op`` ops),
    MigrationRefusedError → 409 (nothing moved; the body says why),
    and 409 while ``migration.enabled`` is false."""
    if not _migration_enabled(request):
        return _error(
            409,
            "live migration is disabled (migration.enabled=false)",
            "invalid_request_error",
        )
    core = _replica_manager(request)
    if core is None:
        return _error(
            409,
            "replica operations require device.dp > 1 or a worker pod "
            "(pod.workers > 0; a single engine drains via SIGTERM)",
            "invalid_request_error",
        )
    loop = asyncio.get_running_loop()
    try:
        result = await loop.run_in_executor(None, lambda: fn(core))
    except ValueError as exc:
        if idx_op:
            return _error(404, str(exc), "invalid_request_error")
        return _error(500, str(exc), "migration_error")
    except MigrationRefusedError as exc:
        return _error(409, str(exc), "migration_refused")
    except MigrationError as exc:
        return _error(500, str(exc), "migration_error")
    return web.json_response(result)


async def admin_replicas(request: web.Request) -> web.Response:
    """GET /admin/replicas — the dp fleet's per-replica (or the pod's
    per-worker) health detail (state, drain marks, migration counters);
    200 with a dp=1 note for a single engine so dashboards can probe
    unconditionally."""
    core = _replica_manager(request)
    if core is None:
        return web.json_response(
            {"dp": 1, "replicas": [],
             "note": "no replica manager (dp=1 or external backend)"}
        )
    return web.json_response(core.health())


async def admin_drain_replica(request: web.Request) -> web.Response:
    """POST /admin/replicas/{idx}/drain — stop new placements on the
    worker and move its residents to the least-loaded survivors (they
    complete elsewhere, marked migrated).  Health reports DEGRADED until
    undrain."""
    idx = _replica_idx(request)
    return await _run_replica_op(
        request, lambda core: core.drain_replica(idx)
    )


async def admin_undrain_replica(request: web.Request) -> web.Response:
    """POST /admin/replicas/{idx}/undrain — return a drained worker to
    the placement rotation."""
    idx = _replica_idx(request)
    return await _run_replica_op(
        request, lambda core: core.undrain_replica(idx)
    )


async def admin_add_replica(request: web.Request) -> web.Response:
    """POST /admin/replicas — grow the dp degree on a banked device
    slice (elastic dp; see ReplicatedEngine.add_replica).  A pod's
    worker count is fixed at boot: answered with the pod's
    MigrationRefusedError (409)."""
    return await _run_replica_op(
        request, lambda core: core.add_replica(), idx_op=False
    )


async def admin_remove_replica(request: web.Request) -> web.Response:
    """DELETE /admin/replicas/{idx} — drain, migrate, tear down, and
    bank the device slice (elastic dp scale-down).  A pod refuses it
    (409): drain the worker instead."""
    idx = _replica_idx(request)
    return await _run_replica_op(
        request, lambda core: core.remove_replica(idx)
    )


async def debug_spans(request: web.Request) -> web.Response:
    """GET /debug/spans — in-memory span export, for drills and tests
    that assert trace parentage.  Empty unless the server was launched
    with ``VGT_MEMTRACE=1``.  An engine that exports spans of its own
    (a pod's workers, ``collect_spans``) adds them."""
    recorder = request.app.get("memtrace")
    spans = []
    if recorder is not None:
        for s in recorder.spans():
            spans.append(
                {
                    "name": s.name,
                    "trace_id": s.trace_id_hex,
                    "span_id": s.span_id_hex,
                    "parent_span_id": s.parent_span_id_hex,
                    "start_ns": s.start_time,
                    "end_ns": s.end_time,
                    "worker": "gateway",
                    "attributes": {
                        k: v
                        for k, v in (s.attributes or {}).items()
                        if isinstance(v, (str, int, float, bool))
                    },
                }
            )
    engine: Optional[VGTEngine] = request.app.get("engine")
    core = getattr(engine.backend, "core", None) if engine else None
    collect = getattr(core, "collect_spans", None)
    if collect is not None:
        try:
            spans.extend(collect())
        except Exception:
            logger.error("worker span collection failed", exc_info=True)
    return web.json_response(
        {"enabled": recorder is not None, "spans": spans}
    )


async def debug_faults(request: web.Request) -> web.Response:
    """GET /debug/faults — armed-fault inventory (same payload shape as
    the /stats faults block)."""
    from vgate_tpu_torch import faults

    return web.json_response(
        {"enabled": _faults_http_enabled(), "armed": faults.snapshot()}
    )


async def debug_faults_arm(request: web.Request) -> web.Response:
    """POST /debug/faults {"faults": "point:mode[:k=v...]", "chaos": p}
    — arm fault points on the LIVE server (the loadlab chaos arm:
    scenarios replay the fault drills mid-cell, under measured
    load).  Parsing is exactly ``VGT_FAULTS``/``VGT_CHAOS`` env syntax
    via faults.arm_from_env; gated on VGT_FAULTS_HTTP=1 plus the usual
    auth middleware."""
    from vgate_tpu_torch import faults

    if not _faults_http_enabled():
        return _error(
            403,
            "live fault arming is disabled (start the server with "
            "VGT_FAULTS_HTTP=1 to enable this drill-only surface)",
            "invalid_request_error",
        )
    try:
        body = await request.json()
    except Exception:
        body = None
    if not isinstance(body, dict):
        return _error(
            400, "body must be a JSON object", "invalid_request_error"
        )
    spec = body.get("faults", "")
    chaos = body.get("chaos", "")
    if not spec and not chaos:
        return _error(
            400, "provide 'faults' (VGT_FAULTS syntax) and/or 'chaos' "
            "(probability)", "invalid_request_error",
        )
    env: Dict[str, str] = {}
    if spec:
        env["VGT_FAULTS"] = str(spec)
    if chaos:
        env["VGT_CHAOS"] = str(chaos)
    armed = faults.arm_from_env(env)
    logger.warning(
        "faults armed via HTTP", extra={"extra_data": {
            "spec": spec, "chaos": chaos, "armed": armed,
        }},
    )
    return web.json_response(
        {"armed": armed, "active": faults.snapshot()}
    )


async def debug_faults_disarm(request: web.Request) -> web.Response:
    """DELETE /debug/faults[?point=] — disarm (all points by default)."""
    from vgate_tpu_torch import faults

    if not _faults_http_enabled():
        return _error(
            403,
            "live fault arming is disabled (start the server with "
            "VGT_FAULTS_HTTP=1 to enable this drill-only surface)",
            "invalid_request_error",
        )
    faults.disarm(request.query.get("point") or None)
    return web.json_response({"armed": 0, "active": faults.snapshot()})


async def run_benchmark(request: web.Request) -> web.Response:
    """POST /v1/benchmark through the full pipeline incl. batching + cache
    (reference: main.py:343-386)."""
    try:
        raw = await request.json() if request.can_read_body else {}
        payload = BenchmarkRequest(**(raw or {}))
    except (ValidationError, ValueError) as exc:
        return _error(422, f"Invalid request: {exc}", "invalid_request_error")
    config = request.app["engine"].config
    prompts = payload.prompts or config.benchmark.prompts
    rounds = payload.rounds or config.benchmark.rounds
    max_tokens = payload.max_tokens or config.benchmark.max_tokens
    batcher: RequestBatcher = request.app["batcher"]

    latencies: list[float] = []
    total_tokens = 0
    bench_start = time.perf_counter()
    try:
        for _ in range(rounds):
            starts = time.perf_counter()
            results = await asyncio.gather(
                *[
                    batcher.submit(prompt, max_tokens=max_tokens)
                    for prompt in prompts
                ]
            )
            latencies.append(time.perf_counter() - starts)
            total_tokens += sum(r.get("num_tokens", 0) for r in results)
    except PoisonRequestError as exc:
        return _error(400, str(exc), "invalid_request_error")
    except ClientQuotaExceededError as exc:
        return _quota_429(exc)
    except (RetryableError, EngineBusyError) as exc:
        # batcher.submit raises these routinely while the engine is
        # recovering or shedding — map them like every other handler
        # instead of a 500
        return _unavailable_503(exc, f"Engine unavailable: {exc}")
    wall = time.perf_counter() - bench_start
    latencies_ms = sorted(l * 1000 for l in latencies)
    return web.json_response(
        {
            "rounds": rounds,
            "prompts_per_round": len(prompts),
            "latency_ms": {
                "mean": statistics.mean(latencies_ms),
                "p50": latencies_ms[len(latencies_ms) // 2],
                "p95": latencies_ms[min(len(latencies_ms) - 1,
                                        int(len(latencies_ms) * 0.95))],
            },
            "total_tokens": total_tokens,
            "tokens_per_second": total_tokens / wall if wall > 0 else 0.0,
        }
    )


async def capture_profile(request: web.Request) -> web.Response:
    """POST /v1/profile — capture a ``torch.profiler`` trace (host ops and
    the card's kernels) while serving continues, written as a Chrome
    trace; OTel request tracing stays separate.  Body:
    ``{"duration_ms": 1000, "out_dir": "/tmp/..."}`` (both optional;
    out_dir must live under the system temp dir — traces are written as
    the service user, so arbitrary paths are rejected)."""
    engine: Optional[VGTEngine] = request.app.get("engine")
    core = getattr(engine.backend, "core", None) if engine else None
    if core is None or not hasattr(core, "capture_profile"):
        # a client error (this deployment can never profile), not a
        # conflict: 409 is reserved for the concurrent-capture case
        return _error(
            400,
            "profiling requires the torch_cuda engine",
            "invalid_request_error",
        )
    try:
        raw = await request.json() if request.can_read_body else {}
    except ValueError:
        raw = {}
    if not isinstance(raw, dict):
        return _error(
            422, "body must be a JSON object", "invalid_request_error"
        )
    try:
        duration_s = float(raw.get("duration_ms", 1000)) / 1000.0
    except (TypeError, ValueError):
        return _error(
            422, "duration_ms must be a number", "invalid_request_error"
        )
    out_dir = raw.get("out_dir")
    if out_dir is not None:
        tmp_root = os.path.realpath(tempfile.gettempdir())
        resolved = os.path.realpath(str(out_dir))
        if not resolved.startswith(tmp_root + os.sep):
            return _error(
                422,
                f"out_dir must be under {tmp_root}",
                "invalid_request_error",
            )
        out_dir = resolved
    # lock lives in app state: a module-level asyncio.Lock would bind to
    # the first event loop that touches it and break across app restarts
    lock: asyncio.Lock = request.app["profile_lock"]
    # acquire non-blocking: a concurrent capture must get an immediate 409,
    # never queue behind a running (up to 60 s) whole-process trace
    if lock.locked():
        return _error(
            409, "a profile capture is already running",
            "invalid_request_error",
        )
    await lock.acquire()
    try:
        loop = asyncio.get_running_loop()
        result = await loop.run_in_executor(
            None, lambda: core.capture_profile(duration_s, out_dir)
        )
    finally:
        lock.release()
    return web.json_response(result)


def _raise_graceful_exit() -> None:
    # GracefulExit subclasses SystemExit, so raising it inside the drain
    # task propagates through the loop and ends web.run_app's
    # run_forever — the normal aiohttp shutdown path (cleanup hooks run)
    raise web.GracefulExit()


def _build_drain_controller(
    app: web.Application, config: VGTConfig
) -> DrainController:
    """Graceful drain wiring (vgate_tpu_torch/lifecycle.py): SIGTERM →
    ready=503 + admission stop → in-flight completes (up to
    lifecycle.drain_timeout_s) → straggler abort → process exit."""
    lc = config.lifecycle

    def stop_admission() -> None:
        batcher: Optional[RequestBatcher] = app.get("batcher")
        if batcher is not None:
            batcher.begin_drain(retry_after_s=lc.drain_retry_after_s)

    def abort_stragglers() -> None:
        batcher: Optional[RequestBatcher] = app.get("batcher")
        if batcher is not None:
            batcher.fail_pending()
        engine: Optional[VGTEngine] = app.get("engine")
        abort_fn = getattr(engine.backend, "abort_in_flight", None) if (
            engine is not None
        ) else None
        if abort_fn is not None:
            abort_fn("drain")

    return DrainController(
        drain_timeout_s=lc.drain_timeout_s,
        poll_s=lc.drain_poll_ms / 1000.0,
        retry_after_s=lc.drain_retry_after_s,
        stop_admission=stop_admission,
        inflight=lambda: app["inflight"].value,
        abort_stragglers=abort_stragglers,
        on_complete=_raise_graceful_exit,
    )


def _journal_body(
    endpoint: str,
    model: str,
    text: str,
    finish_reason: str,
    prompt_tokens: int,
    completion_tokens: int,
) -> Optional[Dict[str, Any]]:
    """Compact response body for a journal record settled WITHOUT its
    original HTTP handler (adopted worker finish, or startup
    resubmission).  Token identity is the contract — the text and
    finish_reason are exactly what the original generation produced;
    envelope fields the gateway mints per-response (id, created) are
    fresh.  Returns None for endpoints with no replayable shape."""
    usage = Usage(
        prompt_tokens=prompt_tokens,
        completion_tokens=completion_tokens,
        total_tokens=prompt_tokens + completion_tokens,
    )
    if endpoint == "/v1/chat/completions":
        return ChatCompletion(
            model=model,
            choices=[
                Choice(
                    index=0,
                    message=ChatMessage(role="assistant", content=text),
                    finish_reason=finish_reason,
                )
            ],
            usage=usage,
        ).model_dump()
    if endpoint == "/v1/completions":
        return Completion(
            model=model,
            choices=[
                TextChoice(
                    index=0, text=text, finish_reason=finish_reason
                )
            ],
            usage=usage,
        ).model_dump()
    return None


def _wire_survivability(
    app: web.Application,
    config: VGTConfig,
    engine: VGTEngine,
    batcher: RequestBatcher,
    loop: asyncio.AbstractEventLoop,
) -> None:
    """Gateway-crash survivability wiring: build the request journal,
    reconcile its inherited pending records against the pod's adopted
    in-flight work, and resubmit the rest.

    Three fates for a record the predecessor accepted but never
    settled:

    * its generation is STILL RUNNING on an adopted worker — the
      ``on_adopted_done`` hook settles the record when the done frame
      lands (a waiting client retry then serves it);
    * it already FINISHED while the worker was orphaned — the buffered
      done frame replays during adoption and parks in
      ``drain_adopted_results``; settled here, synchronously;
    * nobody holds it (worker died too / no pod) — resubmitted through
      the normal admission path (``vgt_journal_replays{outcome=
      "resubmitted"}``), so the promise survives even when the client
      never retries.
    """
    gcfg = config.gateway
    journal = RequestJournal(
        gcfg.journal_path or None,
        fsync=gcfg.journal_fsync,
        max_bytes=gcfg.journal_max_bytes,
        retention_s=gcfg.journal_retention_s,
    )
    app["journal"] = journal
    pod = getattr(engine.backend, "core", None)
    adoption = getattr(pod, "adopted_request_ids", None) is not None
    inherited = [r for r in journal.pending() if r.inherited]
    if inherited and not adoption:
        # pod boots count restarts off the worker registry scan; a
        # journal-only (non-pod) deployment counts them here
        metrics.GATEWAY_RESTARTS.inc()
    if not inherited:
        return
    by_rid = {r.request_id: r.key for r in inherited if r.request_id}

    def _on_adopted(
        request_id: str,
        result: Optional[Dict[str, Any]],
        error: Optional[str],
    ) -> None:
        # fires on a pod RPC reader thread — the journal carries its
        # own lock, so settling here is safe
        key = by_rid.get(str(request_id))
        if key is None:
            return
        rec = journal.lookup(key)
        if rec is None or rec.state != _JOURNAL_PENDING:
            return
        body = None
        if result is not None:
            body = _journal_body(
                rec.endpoint,
                str(
                    (rec.snapshot or {}).get("model")
                    or config.model.model_id
                ),
                str(result.get("text") or ""),
                str(result.get("finish_reason") or "stop"),
                0,
                int(result.get("generated_tokens") or 0),
            )
        if body is None:
            journal.fail(key)
            metrics.JOURNAL_REPLAYS.labels(outcome="failed").inc()
            logger.warning(
                "adopted request failed; journal key released",
                extra={
                    "extra_data": {
                        "request_id": request_id, "error": error,
                    }
                },
            )
            return
        journal.settle(key, body)
        logger.info(
            "adopted request settled into journal",
            extra={"extra_data": {"request_id": request_id}},
        )

    adopted_rids: set = set()
    if adoption:
        pod.on_adopted_done = _on_adopted
        adopted_rids = set(pod.adopted_request_ids)
        for rid, (result, error) in pod.drain_adopted_results().items():
            adopted_rids.add(rid)
            _on_adopted(rid, result, error)

    to_resubmit = []
    for rec in inherited:
        cur = journal.lookup(rec.key)
        if cur is None or cur.state != _JOURNAL_PENDING:
            continue
        if rec.request_id and rec.request_id in adopted_rids:
            continue  # the adopted worker finishes it; the hook settles
        to_resubmit.append(rec)
    if not to_resubmit:
        return

    async def _replay_journal_pending() -> None:
        for rec in to_resubmit:
            snap = rec.snapshot or {}
            prompt = snap.get("prompt")
            kw = dict(snap.get("submit") or {})
            if rec.endpoint not in (
                "/v1/chat/completions", "/v1/completions"
            ) or not isinstance(prompt, str):
                # no replayable shape (embeddings recompute fresh on
                # retry; malformed snapshots never crash the boot)
                journal.fail(rec.key)
                metrics.JOURNAL_REPLAYS.labels(outcome="failed").inc()
                continue
            lb = kw.pop("logit_bias", None)
            if lb:
                try:
                    # JSON round-trip stringified the token-id keys
                    kw["logit_bias"] = {
                        int(k): float(v) for k, v in lb.items()
                    }
                except (TypeError, ValueError):
                    pass
            try:
                result = await batcher.submit(
                    prompt,
                    request_id=(
                        f"{rec.request_id or rec.key}:journal-replay"
                    ),
                    **kw,
                )
            except asyncio.CancelledError:
                raise
            except BaseException:  # noqa: BLE001 — typed engine errors
                logger.warning(
                    "journal replay resubmission failed",
                    exc_info=True,
                    extra={"extra_data": {"key": rec.key}},
                )
                journal.fail(rec.key)
                metrics.JOURNAL_REPLAYS.labels(outcome="failed").inc()
                continue
            body = _journal_body(
                rec.endpoint,
                str(snap.get("model") or config.model.model_id),
                str(result.get("text") or ""),
                str(result.get("finish_reason") or "stop"),
                int(result.get("prompt_tokens") or 0),
                int(result.get("num_tokens") or 0),
            )
            journal.settle(rec.key, body or {})
            metrics.JOURNAL_REPLAYS.labels(outcome="resubmitted").inc()
            logger.info(
                "journal pending record resubmitted and settled",
                extra={"extra_data": {"key": rec.key}},
            )

    # runs after startup completes (the batcher is started by then)
    app["journal_replay_task"] = loop.create_task(
        _replay_journal_pending()
    )


async def _on_startup(app: web.Application) -> None:
    config: VGTConfig = app["config"]
    app["profile_lock"] = asyncio.Lock()
    init_tracing(config)
    if os.environ.get("VGT_MEMTRACE"):
        # drill/test span evidence without the OTel SDK: record this
        # process's spans (the HTTP span and the engine's phase spans
        # among them) for /debug/spans
        try:
            from vgate_tpu_torch.observability.memtrace import (
                MemorySpanRecorder,
            )

            app["memtrace"] = MemorySpanRecorder().install()
        except Exception:
            logger.warning(
                "VGT_MEMTRACE set but span recorder install failed",
                exc_info=True,
            )
    loop = asyncio.get_running_loop()
    # Model load can take minutes; do it off the event loop.
    engine = await loop.run_in_executor(None, lambda: VGTEngine(config))
    app["engine"] = engine
    batcher = RequestBatcher(engine, config)
    app["batcher"] = batcher
    drain = _build_drain_controller(app, config)
    app["drain"] = drain
    if config.lifecycle.drain_enabled:
        try:
            # replaces aiohttp's default SIGTERM → immediate GracefulExit
            # with drain-then-exit; k8s preStop + termination grace give
            # the drain its window (k8s/base/deployment.yaml)
            loop.add_signal_handler(signal.SIGTERM, drain.begin)
            app["drain_signal_installed"] = True
        except (NotImplementedError, RuntimeError, ValueError):
            # non-main thread / platforms without signal support: drain
            # stays reachable programmatically (drain.begin())
            app["drain_signal_installed"] = False
    if config.migration.enabled:
        # replica drain without an HTTP round trip: a preStop hook (or an
        # operator) sends SIGUSR1 and the replica named by
        # $VGT_DRAIN_REPLICA (an index, default 0) drains — the
        # live-migration twin of the SIGTERM whole-process drain
        def _signal_drain_replica() -> None:
            raw = os.environ.get("VGT_DRAIN_REPLICA", "0")
            try:
                idx = int(raw)
            except ValueError:
                logger.error(
                    "VGT_DRAIN_REPLICA=%r is not a replica index", raw
                )
                return
            core = _replica_manager_of(app)
            if core is None:
                logger.error(
                    "SIGUSR1 replica drain ignored: no replica "
                    "manager (dp=1 or external backend)"
                )
                return
            logger.warning(
                "SIGUSR1: draining replica via VGT_DRAIN_REPLICA",
                extra={"extra_data": {"replica": idx}},
            )

            def _do() -> None:
                try:
                    core.drain_replica(idx)
                except Exception:
                    logger.error(
                        "signal-initiated replica drain failed",
                        exc_info=True,
                    )

            loop.run_in_executor(None, _do)

        try:
            loop.add_signal_handler(
                signal.SIGUSR1, _signal_drain_replica
            )
            app["replica_drain_signal_installed"] = True
        except (NotImplementedError, RuntimeError, ValueError):
            app["replica_drain_signal_installed"] = False
    metrics.init_app_info(
        __version__, config.model.model_id, config.model.engine_type
    )
    try:
        _wire_survivability(app, config, engine, batcher, loop)
    except Exception:
        # a corrupt journal must never stop the gateway from serving
        logger.error(
            "request-journal wiring failed; idempotency replay "
            "disabled for this lifetime",
            exc_info=True,
        )
        app.pop("journal", None)
    await batcher.start()


async def _on_cleanup(app: web.Application) -> None:
    if app.get("drain_signal_installed"):
        try:
            asyncio.get_running_loop().remove_signal_handler(signal.SIGTERM)
        except (NotImplementedError, RuntimeError, ValueError):
            pass
    if app.get("replica_drain_signal_installed"):
        try:
            asyncio.get_running_loop().remove_signal_handler(signal.SIGUSR1)
        except (NotImplementedError, RuntimeError, ValueError):
            pass
    replay_task: Optional[asyncio.Task] = app.get("journal_replay_task")
    if replay_task is not None and not replay_task.done():
        replay_task.cancel()
        try:
            await replay_task
        except (asyncio.CancelledError, Exception):
            pass
    batcher: Optional[RequestBatcher] = app.get("batcher")
    if batcher is not None:
        await batcher.stop()
    engine: Optional[VGTEngine] = app.get("engine")
    if engine is not None:
        engine.shutdown()
    journal: Optional[RequestJournal] = app.get("journal")
    if journal is not None:
        journal.close()
    shutdown_tracing()


def create_app(config: Optional[VGTConfig] = None) -> web.Application:
    config = config or get_config()
    setup_logging(config)
    app = web.Application(
        middlewares=[
            build_security_middleware(config),
            observability_middleware,
            drain_middleware,
        ],
        client_max_size=32 * 1024 * 1024,
    )
    app["config"] = config
    # client-facing requests in flight (the graceful drain waits on it)
    app["inflight"] = _InflightCounter()
    app.router.add_get("/health", health)
    app.router.add_get("/health/live", health_live)
    app.router.add_get("/health/ready", health_ready)
    app.router.add_post("/v1/chat/completions", chat_completions)
    app.router.add_post("/v1/completions", completions)
    app.router.add_post("/v1/embeddings", embeddings)
    app.router.add_get("/v1/models", list_models)
    app.router.add_get("/metrics", prometheus_metrics)
    app.router.add_get("/stats", get_stats)
    # drill-only chaos surface (403 unless VGT_FAULTS_HTTP=1): the
    # loadlab chaos arm replays fault drills mid-cell through it
    app.router.add_get("/debug/flight", debug_flight)
    app.router.add_get("/debug/requests", debug_requests)
    app.router.add_get("/debug/requests/{ident}", debug_request_detail)
    app.router.add_get("/debug/perf", debug_perf)
    app.router.add_get("/debug/pod", debug_pod)
    app.router.add_get("/debug/spans", debug_spans)
    app.router.add_get("/debug/faults", debug_faults)
    app.router.add_post("/debug/faults", debug_faults_arm)
    app.router.add_delete("/debug/faults", debug_faults_disarm)
    # replica operations over dp replicas or a worker pod, auth-gated
    # like every non-exempt path; add and DELETE exist only for those (a
    # pod refuses them; a single engine keeps the 404 it had)
    app.router.add_get("/admin/replicas", admin_replicas)
    app.router.add_post(
        "/admin/replicas/{idx}/drain", admin_drain_replica
    )
    app.router.add_post(
        "/admin/replicas/{idx}/undrain", admin_undrain_replica
    )
    if config.pod.workers > 0 or config.device.dp > 1:
        app.router.add_post("/admin/replicas", admin_add_replica)
        app.router.add_delete(
            "/admin/replicas/{idx}", admin_remove_replica
        )
    app.router.add_post("/v1/benchmark", run_benchmark)
    app.router.add_post("/v1/profile", capture_profile)
    app.on_startup.append(_on_startup)
    app.on_cleanup.append(_on_cleanup)
    return app


def main() -> None:
    config = get_config()
    app = create_app(config)
    web.run_app(app, host=config.server.host, port=config.server.port)


if __name__ == "__main__":
    main()
