"""Serving error taxonomy for the recovery path.

The engine's fault handling distinguishes three client-visible outcomes:

* **Retryable** — the failure is about *when* the request arrived, not
  *what* it asked for: the engine crashed mid-flight and is restarting,
  or has been torn down.  Clients should back off ``retry_after``
  seconds and resend; the gateway maps these to 503 + ``Retry-After``
  so the SDK's existing backoff honors the server's suggestion.
* **Poison** — the request itself is the suspected crash cause and has
  been quarantined (vgate_tpu_torch/runtime/supervisor.py); resending it will
  never succeed, so the gateway maps it to a 400.
* **Deadline / cancellation** — the *client's* time budget ran out
  (``DeadlineExceededError`` → 504 with partial-tokens metadata) or the
  client went away (``ClientDisconnectError``, nothing left to answer).
  Both shed the sequence between decode ticks and free its KV pages
  immediately instead of burning the batch to completion.

Kept free of imports from the runtime so every layer (scheduler,
batcher, server, client-facing docs) can reference one taxonomy without
cycles.

Completeness is enforced statically: the ``error-taxonomy`` checker
(scripts/vgt_lint.py) requires every class here to carry an HTTP
mapping in server/app.py, a machine-readable ``reason``, an SDK-twin
declaration (``sdk_twin`` — the vgate_tpu_client class this surfaces
as, verified to exist), and a docs mention (the error table in
docs/operations.md).  Internal-only classes justify themselves with an
inline ``vgt-lint`` suppression instead — see docs/static_analysis.md.
"""

from __future__ import annotations


# The single source of truth for deriving probe answers from a health
# state string (supervisor.health, backend.serving_health and the
# gateway's /health handlers all consult these — they must never
# disagree about what counts as ready).
READY_STATES = ("serving", "degraded")


def state_is_ready(state: str) -> bool:
    """May this engine accept new work (readiness probe)?"""
    return state in READY_STATES


def state_is_alive(state: str) -> bool:
    """Is a pod restart NOT warranted (liveness probe)?"""
    return state != "dead"


def raise_for_state(
    state: str, retry_after: float = 1.0, detail: str = None
) -> None:
    """The one state -> admission-error mapping (supervisor gate and
    batcher fail-fast both use it; they must never disagree).  No-op for
    ready states."""
    if state == "dead":
        raise EngineDeadError(
            "engine is dead (restart budget exhausted or unrecoverable "
            "fault" + (f": {detail}" if detail else "") + ")"
        )
    if state == "recovering":
        raise EngineRecoveringError(
            "engine is restarting after a crash; retry shortly",
            retry_after=retry_after,
        )


class RetryableError(RuntimeError):
    """A transient serving failure the client should retry after
    ``retry_after`` seconds (surfaced as 503 + ``Retry-After``).

    ``reason`` travels in the error body so clients can tell apart the
    503 flavors (overloaded vs draining vs recovering vs dead) without
    parsing messages — the SDK maps "overloaded" to its typed
    ``ServerOverloadedError``."""

    reason = "unavailable"
    # SDK class the 503 surfaces as when `reason` carries no more
    # specific mapping (vgate_tpu_client/exceptions.py); subclasses
    # with a typed twin override it
    sdk_twin = "ServerError"

    def __init__(self, message: str, retry_after: float = 1.0) -> None:
        super().__init__(message)
        self.retry_after = max(1.0, float(retry_after))


class EngineRecoveringError(RetryableError):
    """The engine crashed and a supervised restart is in progress; the
    request was failed fast (or shed at admission) instead of queuing
    into a dead engine."""

    reason = "recovering"


# vgt-lint: disable=error-taxonomy -- watchdog-internal: classified transient and contained before any gateway surface; clients only ever see the EngineRecoveringError the restart produces
class EngineStalledError(RuntimeError):
    """The engine loop stopped heartbeating: a decode/prefill dispatch
    (or its readback) has been stuck past ``recovery.step_stall_s`` —
    the wedged-engine failure mode (Mosaic hang, stuck TPU grant) that
    a crash-only supervisor never sees, because nothing ever *raises*.
    Declared by the watchdog (supervisor / dp repair thread) OFF the
    engine thread; ``fault_kind`` classifies it transient so the
    existing supervised path applies: stall → checkpoint → rebuild →
    replay."""

    fault_kind = "transient"
    reason = "stalled"  # flight/stats attribution, never a response body

    def __init__(
        self,
        message: str,
        stalled_s: float = 0.0,
        phase: str = "unknown",
    ) -> None:
        super().__init__(message)
        self.stalled_s = stalled_s
        self.phase = phase


class ResumeExhaustedError(RetryableError):
    """This request's in-flight generation was checkpointed across
    ``recovery.max_resume_attempts`` engine restarts and still never
    finished — replaying it again is more likely to be the *cause* of
    the crashes than their victim, so the supervisor gives up on it
    with a retryable 503 (the client may resend; the poison quarantine
    catches true repeat offenders by fingerprint)."""

    reason = "recovering"


class EngineDeadError(RetryableError):
    """The engine exhausted its restart budget (or hit an unrecoverable
    fault) and will not come back in this process.  Still retryable from
    the client's point of view — another replica behind the LB can serve
    it while the liveness probe recycles this pod."""

    reason = "dead"

    def __init__(self, message: str, retry_after: float = 30.0) -> None:
        super().__init__(message, retry_after=retry_after)


class ServerDrainingError(RetryableError):
    """This replica received SIGTERM and is draining in-flight work; new
    admissions are rejected with 503 + ``Retry-After`` so the client (or
    the LB) resends against a replica that is staying up."""

    reason = "draining"

    def __init__(self, message: str = None, retry_after: float = 2.0) -> None:
        super().__init__(
            message
            or "server is draining for shutdown; retry another replica",
            retry_after=retry_after,
        )


class ServerOverloadedError(RetryableError):
    """Admission control refused the request at the door (503 +
    ``Retry-After``): the queued-token backlog is over budget, the
    predicted queue wait would blow the request's own deadline, or the
    KV pool is below its free-page watermark (vgate_tpu_torch/admission.py).
    Rejecting here is deliberate load shedding — the work was *never
    accepted*, so retrying after the suggested backoff (ideally against
    another replica) is safe and expected.  ``shed_reason`` says which
    limit fired (backlog_tokens | backlog_requests | would_miss_slo |
    kv_pressure); ``tier`` is the priority tier the request was judged
    at (batch sheds first, interactive last)."""

    reason = "overloaded"
    sdk_twin = "ServerOverloadedError"

    def __init__(
        self,
        message: str,
        retry_after: float = 1.0,
        shed_reason: str = "backlog_tokens",
        tier: str = "standard",
    ) -> None:
        super().__init__(message, retry_after=retry_after)
        self.shed_reason = shed_reason
        self.tier = tier


class KVCapacityError(RetryableError):
    """The paged KV pool ran out mid-generation and nothing could be
    preempted to make room (the sequence was alone, or preempt-on-oom
    is off): the request's context genuinely does not fit the pool
    RIGHT NOW.  A transient *capacity* condition, not a malformed
    request — mapped to 503 + ``Retry-After`` with body reason
    ``"kv_capacity"`` (SDK: typed ``KVCapacityError``) so clients and
    load balancers retry against a less-loaded replica instead of
    treating an opaque 500 as a server bug.  With the host-RAM swap
    tier (``kv_cache.host_swap_bytes``) these exhaustions become rarer
    still: preemption parks KV instead of destroying it."""

    reason = "kv_capacity"
    sdk_twin = "KVCapacityError"

    def __init__(self, message: str, retry_after: float = 2.0) -> None:
        super().__init__(message, retry_after=retry_after)


class WorkerLostError(RetryableError):
    """An engine worker process went away mid-request (crash, kill -9,
    OOM, socket EOF, or heartbeat timeout) and the request could not be
    resubmitted to a surviving worker (no survivor, resume budget
    exhausted, or the resubmit itself failed).  Retryable: the pod is
    DEGRADED while the supervised respawn runs, and another worker (or
    the respawned one, once canary-gated back in) serves the retry.
    The common case never raises this at all — in-flight sequences are
    checkpoint-folded and resubmitted to survivors with zero 5xx
    (runtime/pod_engine.py)."""

    reason = "worker_lost"

    def __init__(self, message: str, retry_after: float = 2.0) -> None:
        super().__init__(message, retry_after=retry_after)


class WorkerFencedError(RetryableError):
    """An RPC frame carried a stale fencing epoch: the sender belongs
    to a previous incarnation of the worker slot (a zombie the gateway
    already declared lost and replaced, or a gateway talking to a
    restarted worker with pre-restart state).  The frame was rejected
    — late work from a fenced incarnation must never interleave with
    the live one's token stream (the PR-5 stale-wake epoch guard,
    cross-process).  Clients only ever see this as a routine retryable
    503 if a fenced rejection reaches a submission path; zombie frames
    the gateway discards are counted by ``vgt_pod_fenced_frames``
    instead of surfacing anywhere."""

    reason = "worker_fenced"


class WorkerOrphanedError(RetryableError):
    """A submit reached a worker that has outlived its gateway
    (``pod.orphan_grace_s`` > 0, gateway socket gone): the worker is
    finishing its in-flight decodes and waiting for a successor gateway
    to adopt it, and accepts no new work in between — an orphan that
    kept taking submits could never be reconciled against the
    successor's journal.  Retryable: by the time the client retries,
    either a new gateway has adopted the worker or the orphan grace
    expired and the pod respawned it."""

    reason = "worker_orphaned"

    def __init__(self, message: str, retry_after: float = 2.0) -> None:
        super().__init__(message, retry_after=retry_after)


class IntegrityError(RetryableError):
    """Silent data corruption detected (vgate_tpu_torch/integrity.py): an
    output sentinel tripped on a decode readback (NaN/Inf, all-zero or
    saturated logit rows, token ids outside the vocabulary, entropy
    collapse), a weight checksum sweep found a shard whose bits no
    longer match the load-time baseline, or a canary self-probe's
    pinned greedy output stopped matching its recorded fingerprint.

    ``fault_kind = "corrupt"`` routes the supervisor / dp repair loop
    to the **reload** rebuild path: weights-kept restarts would carry
    the corruption into every new incarnation.  Retryable from the
    client's view (503 + Retry-After — a healthy replica or the
    reloaded engine serves the retry); the poisoned chunk was discarded
    before any of its tokens reached a client.

    ``integrity_kind`` names the detector (logit_nonfinite |
    logit_zero | logit_saturated | token_range | entropy_collapse |
    checksum_mismatch | canary); ``sequences`` carries per-sequence
    attribution (seq_id/request_id dicts) for observability."""

    reason = "corrupt"
    fault_kind = "corrupt"

    def __init__(
        self,
        message: str,
        kind: str = "unknown",
        sequences: list = None,
        detail: dict = None,
        retry_after: float = 1.0,
    ) -> None:
        super().__init__(message, retry_after=retry_after)
        self.integrity_kind = kind
        self.sequences = list(sequences or [])
        self.detail = dict(detail or {})


class MigrationError(RuntimeError):
    """A planned sequence movement (replica drain, hot-replica
    rebalance, dp scale-down) could not complete — the operational
    error family behind the /admin/replicas surface.  Operator-facing:
    never sent to generation clients (their sequences either stayed put
    or already failed typed).  The admin surface maps it to a 500 with
    type ``migration_error``; operators drive it with curl, so the
    ``sdk_twin`` is the SDK's generic 5xx class."""

    reason = "migration_error"
    sdk_twin = "ServerError"


class MigrationRefusedError(MigrationError):
    """The migration was refused at PLACEMENT time, before any sequence
    was evacuated: no eligible target replica exists (all dead /
    draining / the last one), the target fleet serves a different
    ``kv_cache.dtype`` than the source (continuing a generation against
    a different KV storage format would splice two numerically
    different streams mid-stream), or the deployment has no migration
    target at all (dp == 1).  Maps to a 409 on the admin surface —
    nothing moved, nothing was lost (a 409 reaches the SDK as the
    generic ``VGTError`` fall-through)."""

    reason = "migration_refused"
    sdk_twin = "VGTError"


class HandoffError(MigrationError):
    """A disaggregated prefill→decode KV handoff (pod.roles;
    runtime/pod_engine.py) failed.  Internal to the handoff plane:
    NEVER client-visible — every failure branch either retries, falls
    back to monolithic decode on the prefill worker, or rides the
    worker-loss replay, all of which keep the request streaming."""

    reason = "handoff_error"
    sdk_twin = "ServerError"


class HandoffTransferError(HandoffError):
    """The chunked KV transfer itself broke: coverage gap (dropped
    chunk), digest mismatch (garbled bytes), oversized/overlapping
    frame, or an undecodable payload.  The gateway retries the transfer
    (bounded by ``pod.transfer_max_retries``, possibly to a different
    decode worker) and then falls back to monolithic decode."""

    reason = "handoff_transfer_error"


class HandoffStaleError(HandoffError):
    """The staged handoff no longer matches the live sequence: the
    prefill worker's engine restarted and replayed it, the hold was
    released, or the staging epoch moved on.  Not retryable against the
    same staging — the gateway abandons the handoff (the sequence is
    already decoding monolithically or riding the loss replay)."""

    reason = "handoff_stale"


class ClientQuotaExceededError(RuntimeError):
    """This API key already has ``admission.per_key_max_inflight``
    requests in flight — a per-client fairness cap, not server-wide
    overload, so it maps to a **429** + ``Retry-After`` (the rate-limit
    status the SDK's backoff already understands) rather than the 503
    the admission controller uses for whole-server shedding."""

    # matches the admission controller's shed-reason label for this cap
    # (vgt_admission_rejections{reason="per_key_inflight"})
    reason = "per_key_inflight"
    sdk_twin = "RateLimitError"

    def __init__(self, message: str, retry_after: float = 1.0) -> None:
        super().__init__(message)
        self.retry_after = max(1.0, float(retry_after))


class DeadlineExceededError(RuntimeError):
    """The request's end-to-end deadline (``X-Request-Timeout`` header /
    ``timeout`` body field, capped by ``server.request_timeout_s``)
    passed before generation finished.  The sequence was shed between
    decode ticks — KV pages and its slot freed immediately — and the
    gateway maps this to a **504** carrying partial-generation metadata
    (tokens produced before the shed), so the client can distinguish
    "slow but working" from "nothing happened".  Not retryable as-is:
    the same request will blow the same budget; the client should raise
    its deadline instead."""

    reason = "deadline_exceeded"
    sdk_twin = "DeadlineExceeded"

    def __init__(
        self,
        message: str,
        partial_text: str = "",
        partial_tokens: int = 0,
        deadline_s: float = 0.0,
        phases: dict = None,
    ) -> None:
        super().__init__(message)
        self.partial_text = partial_text
        self.partial_tokens = partial_tokens
        self.deadline_s = deadline_s
        # per-phase breakdown of where the budget went (queue_s /
        # prefill_s / decode_s, from the engine flight recorder) so a
        # 504's metadata answers "slow where?" — empty when the shed
        # happened before any phase attribution existed
        self.phases = dict(phases or {})


# vgt-lint: disable=error-taxonomy -- never serialized: there is no client left to type a response (or an SDK twin) for; it exists so futures/metrics see a typed outcome
class ClientDisconnectError(RuntimeError):
    """The client went away while its request was queued or decoding;
    the work was cancelled (dequeued, or aborted between decode ticks)
    instead of running to completion for nobody.  Never serialized to a
    response — there is no one left to read it — but it travels through
    futures so bookkeeping (metrics, logs) sees a typed outcome."""

    reason = "client_disconnect"  # metrics/log attribution only


class PoisonRequestError(ValueError):
    """This request was in flight across enough engine crashes (or an
    injected poison fault named it) that the supervisor quarantined it:
    it is rejected at submission so it cannot crash the next engine
    incarnation.  Not retryable — mapped to a 400 (the SDK's generic
    ``VGTError`` fall-through for 4xx)."""

    reason = "poison"
    sdk_twin = "VGTError"


class DuplicateRequestError(ValueError):
    """An ``Idempotency-Key`` arrived while a request carrying the same
    key is still in flight on this gateway — a concurrent duplicate,
    not a retry of a settled one (that replays the stored result) and
    not a fresh request (that mints a new key).  Mapped to a 409: the
    client should wait for its original attempt rather than race two
    generations under one key.  ``retry_after`` hints how long."""

    reason = "duplicate_request"
    sdk_twin = "VGTError"

    def __init__(self, message: str, retry_after: float = 1.0) -> None:
        super().__init__(message)
        self.retry_after = retry_after
