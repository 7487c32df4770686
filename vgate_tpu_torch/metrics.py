"""Prometheus metrics registry.

Recreates the reference's metric surface (vgate/metrics.py:51-196) under the
``vgt_`` namespace, plus TPU-engine metrics the reference could not have
(device step time, KV-page occupancy, prefill/decode token counters).
``_safe_metric`` keeps re-registration idempotent so test re-imports don't
blow up (reference: vgate/metrics.py:26-44).  Exemplar attachment (trace-id
correlation, reference main.py:142-153) is supported through the
``observe_with_exemplar`` / ``inc_with_exemplar`` helpers.
"""

from __future__ import annotations

import os
import subprocess
from typing import Any, Dict, Optional

from prometheus_client import (
    REGISTRY,
    Counter,
    Gauge,
    Histogram,
    Info,
    generate_latest,
)
from prometheus_client.openmetrics import exposition as om_exposition

from vgate_tpu_torch.tracing import get_current_trace_id


def _safe_metric(cls, name: str, documentation: str, **kwargs: Any):
    """Return the existing collector when already registered
    (reference: vgate/metrics.py:26-44)."""
    try:
        return cls(name, documentation, **kwargs)
    except ValueError:
        collector = REGISTRY._names_to_collectors.get(name)
        if collector is None:  # pragma: no cover
            raise
        return collector


# --- HTTP request metrics (reference: vgate/metrics.py:57-77) ---
REQUEST_COUNT = _safe_metric(
    Counter,
    "vgt_requests",
    "HTTP requests processed",
    labelnames=("method", "endpoint", "status"),
)
REQUEST_LATENCY = _safe_metric(
    Histogram,
    "vgt_request_latency_seconds",
    "HTTP request latency",
    labelnames=("method", "endpoint"),
    buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 30, 60),
)
REQUESTS_IN_PROGRESS = _safe_metric(
    Gauge, "vgt_requests_in_progress", "In-flight HTTP requests"
)

# --- batching metrics (reference: vgate/metrics.py:83-114) ---
BATCH_SIZE = _safe_metric(
    Histogram,
    "vgt_batch_size",
    "Requests per processed batch",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128),
)
BATCH_PROCESSING_TIME = _safe_metric(
    Histogram,
    "vgt_batch_processing_seconds",
    "Wall time to process one batch",
    buckets=(0.01, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 30, 60),
)
QUEUE_TIME = _safe_metric(
    Histogram,
    "vgt_queue_time_seconds",
    "Time a request waited in the batch queue",
    buckets=(0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1),
)
PENDING_REQUESTS = _safe_metric(
    Gauge, "vgt_pending_requests", "Requests waiting in the batch queue"
)
BATCHES_TOTAL = _safe_metric(Counter, "vgt_batches", "Batches processed")

# --- inference metrics (reference: vgate/metrics.py:120-152) ---
TTFT = _safe_metric(
    Histogram,
    "vgt_time_to_first_token_seconds",
    "Time to first token",
    buckets=(0.01, 0.025, 0.05, 0.1, 0.2, 0.5, 1, 2, 5),
)
TPOT = _safe_metric(
    Histogram,
    "vgt_time_per_output_token_seconds",
    "Mean time per output token",
    buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25),
)
GENERATED_TOKENS = _safe_metric(
    Counter, "vgt_generated_tokens", "Output tokens generated"
)
PROMPT_TOKENS = _safe_metric(
    Counter, "vgt_prompt_tokens", "Prompt tokens processed"
)
INFERENCE_ERRORS = _safe_metric(
    Counter,
    "vgt_inference_errors",
    "Inference failures",
    labelnames=("error_type",),
)
UNIQUE_PROMPTS = _safe_metric(
    Histogram,
    "vgt_unique_prompts_per_batch",
    "Unique prompts per batch after dedup",
    buckets=(1, 2, 4, 8, 16, 32, 64),
)

# --- cache metrics (reference: vgate/metrics.py:158-180) ---
CACHE_HITS = _safe_metric(Counter, "vgt_cache_hits", "Result-cache hits")
CACHE_MISSES = _safe_metric(Counter, "vgt_cache_misses", "Result-cache misses")
CACHE_SIZE = _safe_metric(Gauge, "vgt_cache_size", "Entries in result cache")
CACHE_EVICTIONS = _safe_metric(
    Counter, "vgt_cache_evictions", "Result-cache LRU evictions"
)

# --- dedup metrics (reference: vgate/metrics.py:186-196) ---
DEDUP_REQUESTS = _safe_metric(
    Counter, "vgt_deduplicated_requests", "Requests answered by in-batch dedup"
)
DEDUP_RATIO = _safe_metric(
    Gauge, "vgt_dedup_ratio", "Duplicate fraction of the last batch"
)

# --- TPU engine metrics (no reference equivalent; engine lives in-house) ---
ENGINE_STEP_TIME = _safe_metric(
    Histogram,
    "vgt_engine_step_seconds",
    "Device time per continuous-batching step",
    labelnames=("kind",),  # prefill | decode
    buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 5),
)
KV_PAGES_IN_USE = _safe_metric(
    Gauge, "vgt_kv_pages_in_use", "Allocated KV-cache pages"
)
KV_PAGES_TOTAL = _safe_metric(
    Gauge, "vgt_kv_pages_total", "Total KV-cache pages"
)
KV_DTYPE = _safe_metric(
    Gauge,
    "vgt_kv_dtype",
    "Configured KV-cache storage dtype (1 on the active dtype's label; "
    "kv_cache.dtype — int8 halves page bytes and ~doubles resident "
    "capacity, ops/kv_quant.py)",
    labelnames=("dtype",),  # bf16 | f32 | f16 | int8
)
KV_QUANTIZED_PAGES = _safe_metric(
    Gauge,
    "vgt_kv_quantized_pages",
    "KV pages currently holding int8-quantized content (equals pages "
    "in use under kv_cache.dtype=int8, 0 otherwise)",
)
KV_QUANT_DRIFT_TOKENS = _safe_metric(
    Counter,
    "vgt_kv_quant_drift_tokens",
    "Greedy tokens that diverged from the full-precision KV oracle in "
    "the kv_quant A/B (bench.py VGT_BENCH_SCENARIO=kv_quant; counts "
    "tokens past the first divergence across compared streams)",
)
ACTIVE_SEQUENCES = _safe_metric(
    Gauge, "vgt_active_sequences", "Sequences resident in decode slots"
)
PREEMPTED_SEQUENCES = _safe_metric(
    Counter, "vgt_preempted_sequences", "Sequences preempted for KV pressure"
)
PREEMPT_RECOMPUTE_TOKENS = _safe_metric(
    Counter,
    "vgt_preempt_recompute_tokens",
    "Tokens re-prefilled because a KV-pressure preemption destroyed "
    "their KV (the waste the host swap tier eliminates: with "
    "kv_cache.host_swap_bytes > 0 preemption parks pages host-side "
    "and this counter stays flat while vgt_kv_swap_*_pages move)",
)
KV_SWAP_OUT_PAGES = _safe_metric(
    Counter,
    "vgt_kv_swap_out_pages",
    "KV pages swapped device->host into the pinned host pool "
    "(runtime/kv_swap.py): kind=preempt is a preemption victim's "
    "resident KV, kind=prefix is a radix-cache leaf demoted by "
    "pressure/LRU eviction (victim cache)",
    labelnames=("kind",),  # preempt | prefix
)
KV_SWAP_IN_PAGES = _safe_metric(
    Counter,
    "vgt_kv_swap_in_pages",
    "KV pages swapped host->device: kind=preempt resumes a preempted "
    "sequence token-identically with zero recompute, kind=prefix "
    "promotes a demoted radix leaf back on a prefix match",
    labelnames=("kind",),  # preempt | prefix
)
KV_SWAP_DISCARD_PAGES = _safe_metric(
    Counter,
    "vgt_kv_swap_discard_pages",
    "Host-pool pages discarded without a swap-in, by reason: settled "
    "(owner finished/failed/aborted), stale (epoch moved under a "
    "checkpoint/migration fold), capacity (prefix victim-cache LRU "
    "drop to make room for a preemption swap-out), no_fit (swap-in "
    "could not allocate and the sequence fell back to recompute)",
    labelnames=("reason",),
)
KV_HOST_POOL_BYTES = _safe_metric(
    Gauge,
    "vgt_kv_host_pool_bytes",
    "Bytes of KV currently parked in the host-RAM swap pool "
    "(kv_cache.host_swap_bytes is the budget; sustained occupancy "
    "near the budget with rising discard[capacity] means the pool is "
    "thrashing — docs/operations.md KV pressure tiers runbook)",
)
ENGINE_QUEUE_DEPTH = _safe_metric(
    Gauge, "vgt_engine_queue_depth", "Sequences waiting for engine admission"
)
RECOMPILES = _safe_metric(
    Counter,
    "vgt_engine_compilations",
    "XLA compilations triggered",
    labelnames=("kind",),
)

# --- decode-loop perf attribution (observability/perf.py; /debug/perf) ---
TICK_PHASE_SECONDS = _safe_metric(
    Counter,
    "vgt_tick_phase_seconds",
    "Engine-tick wall time attributed by phase: host (scheduler/"
    "admission/bookkeeping between dispatches), dispatch (jitted-call "
    "trace+enqueue; first-compiles land here and in the compile "
    "ledger), device (host blocked on device execution at the readback "
    "boundary), readback (device->host transfer), detok (token append/"
    "stop detection/stream callbacks).  rate() by phase gives the live "
    "time split the tick->megatick refactor is judged against",
    labelnames=("phase",),  # host | dispatch | device | readback | detok
)
RECOMPILES_BY_VARIANT = _safe_metric(
    Counter,
    "vgt_recompiles",
    "Compile-ledger entries observed at fresh-variant first dispatches, "
    "by program family (prefill | suffix_prefill | chunked_prefill | "
    "decode | spec_verify).  Steady state compiles each variant once; "
    "sustained increase under load is a recompile storm "
    "(VgtRecompileStorm) — per-variant signatures in /debug/perf",
    labelnames=("variant",),
)
DECODE_MFU = _safe_metric(
    Gauge,
    "vgt_decode_mfu",
    "Live model-FLOPs utilization over the perf window (2 FLOPs per "
    "param per generated token vs the mesh's peak, "
    "observability/roofline.py — the same peak table bench.py reads).  "
    "0 off the peak table (e.g. CPU dry-runs); dp>1 reports the last-"
    "flushed replica (exact per-replica values: /debug/perf)",
)
DECODE_HBM_ROOFLINE_PCT = _safe_metric(
    Gauge,
    "vgt_decode_hbm_roofline_pct",
    "Live percent of the device's HBM roofline achieved by decode over "
    "the perf window (modeled traffic: weights streamed once per step "
    "plus resident-context KV reads, over host-observed device time).  "
    "The ROADMAP target is >=40; dp>1 reports the last-flushed replica",
)
HOST_OVERHEAD_RATIO = _safe_metric(
    Gauge,
    "vgt_host_overhead_ratio",
    "Fraction of engine-tick wall spent in the host phase (scheduler/"
    "admission/bookkeeping between dispatches) over the perf window — "
    "the overhead a device-resident multi-step decode loop amortizes; "
    "high values under decode load mean the engine is host-bound "
    "(VgtHostOverheadHigh, docs/operations.md)",
)

# --- recovery / health state machine (runtime/supervisor.py) ---
ENGINE_RESTARTS = _safe_metric(
    Counter, "vgt_engine_restarts", "Supervised engine restarts"
)
ENGINE_CRASHES = _safe_metric(
    Counter,
    "vgt_engine_crashes",
    "Engine-loop fatal errors by classification",
    labelnames=("kind",),  # transient | poison | unrecoverable
)
HEALTH_STATE = _safe_metric(
    Gauge,
    "vgt_engine_health_state",
    "Serving health state machine (1 on the current state's label)",
    labelnames=("state",),  # serving | degraded | recovering | dead
)
STATE_TRANSITIONS = _safe_metric(
    Counter,
    "vgt_engine_state_transitions",
    "Health state machine transitions",
    labelnames=("from_state", "to_state"),
)
QUARANTINED_REQUESTS = _safe_metric(
    Counter,
    "vgt_quarantined_requests",
    "Requests quarantined as suspected engine poison",
)
TIME_IN_DEGRADED = _safe_metric(
    Counter,
    "vgt_time_in_degraded_seconds",
    "Cumulative seconds spent in the DEGRADED health state",
)
FAULTS_INJECTED = _safe_metric(
    Counter,
    "vgt_faults_injected",
    "Armed fault-injection probes that fired (vgate_tpu_torch/faults.py)",
    labelnames=("point", "mode"),
)

# --- in-flight request survival: checkpoint/replay, stall watchdog, dp failover ---
RESUMED_SEQUENCES = _safe_metric(
    Counter,
    "vgt_resumed_sequences",
    "In-flight sequences checkpointed across an engine restart/failover "
    "and replayed to completion instead of failing with a 503",
)
LOST_SEQUENCES = _safe_metric(
    Counter,
    "vgt_lost_sequences",
    "Checkpointed in-flight sequences that could NOT be replayed, "
    "by reason",
    # quarantined | max_attempts | resubmit_failed | no_replica | shutdown
    labelnames=("reason",),
)
ENGINE_STALLS = _safe_metric(
    Counter,
    "vgt_engine_stalls",
    "Wedged-engine detections by the hang watchdog (heartbeat stale "
    "past recovery.step_stall_s; compile-aware)",
)
DP_REPLICAS_ALIVE = _safe_metric(
    Gauge,
    "vgt_dp_replicas_alive",
    "Data-parallel replica engines currently able to serve",
)
DP_REPLICAS_TOTAL = _safe_metric(
    Gauge,
    "vgt_dp_replicas_total",
    "Configured data-parallel replica engines (tpu.dp)",
)

# --- planned live migration: replica drain, rebalance, elastic dp ---
MIGRATIONS = _safe_metric(
    Counter,
    "vgt_migrations",
    "In-flight sequences moved between dp replicas by PLANNED "
    "migration (checkpoint + replay without a crash), by reason",
    labelnames=("reason",),  # drain | rebalance | scale_down | corrupt
)
MIGRATION_SECONDS = _safe_metric(
    Histogram,
    "vgt_migration_seconds",
    "Wall time of one planned migration operation (evacuate the "
    "source + replay every moved sequence onto its target)",
    buckets=(0.01, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 30),
)
REPLICAS_DRAINING = _safe_metric(
    Gauge,
    "vgt_replicas_draining",
    "dp replicas currently marked draining (no new placements; "
    "residents migrated to survivors)",
)

# --- process-isolated worker pod (pod.workers > 0): gateway/worker split ---
POD_WORKERS_ALIVE = _safe_metric(
    Gauge,
    "vgt_pod_workers_alive",
    "Engine worker PROCESSES currently serving (passed the canary "
    "gate, heartbeat fresh)",
)
POD_WORKERS_TOTAL = _safe_metric(
    Gauge,
    "vgt_pod_workers_total",
    "Configured engine worker processes (pod.workers)",
)
POD_WORKER_RESTARTS = _safe_metric(
    Counter,
    "vgt_pod_worker_restarts",
    "Worker processes respawned by the gateway supervisor and admitted "
    "back through the canary gate",
)
POD_WORKER_LOSSES = _safe_metric(
    Counter,
    "vgt_pod_worker_losses",
    "Worker incarnations declared lost by the gateway, by signal",
    # crash (pid exited) | heartbeat (wedged/zombie) | eof (conn died)
    labelnames=("reason",),
)
POD_FENCED_FRAMES = _safe_metric(
    Counter,
    "vgt_pod_fenced_frames",
    "Late frames from a fenced (replaced) worker incarnation discarded "
    "by the gateway's epoch check instead of corrupting live streams",
)

# --- gateway survivability (pod.orphan_grace_s + gateway.journal_*) ---
GATEWAY_RESTARTS = _safe_metric(
    Counter,
    "vgt_gateway_restarts",
    "Gateway boots that found survivable state left by a predecessor "
    "(orphaned-worker registry records and/or a non-empty request "
    "journal) — incremented by the successor, since the dead gateway "
    "cannot",
)
WORKERS_ADOPTED = _safe_metric(
    Counter,
    "vgt_workers_adopted",
    "Orphaned worker incarnations a restarting gateway re-helloed with "
    "a bumped fencing epoch and took back into routing (warm weights, "
    "compile ledger and radix cache preserved — no respawn)",
)
WORKERS_ORPHANED = _safe_metric(
    Counter,
    "vgt_workers_orphaned",
    "Live orphaned workers discovered in the registry at gateway boot "
    "(workers that outlived their gateway under pod.orphan_grace_s and "
    "were still within grace when the successor scanned)",
)
ORPHAN_EXPIRED = _safe_metric(
    Counter,
    "vgt_orphan_expired",
    "Registry records of orphaned workers whose grace expired (or that "
    "died) before a successor gateway could adopt them — each one is a "
    "full engine re-warm the orphan grace failed to prevent",
)
JOURNAL_REPLAYS = _safe_metric(
    Counter,
    "vgt_journal_replays",
    "Idempotency-journal replay decisions: served (retried key "
    "answered from the settled result, zero recompute), resubmitted "
    "(accepted-but-unsettled record re-entered admission at startup), "
    "duplicate (key still in flight -> typed 409), failed (record "
    "unreplayable and skipped)",
    labelnames=("outcome",),  # served | resubmitted | duplicate | failed
)
JOURNAL_BYTES = _safe_metric(
    Gauge,
    "vgt_journal_bytes",
    "Current on-disk size of the idempotency request journal "
    "(compaction past gateway.journal_max_bytes drops settled/expired "
    "records and rewrites the file)",
)

# --- disaggregated prefill/decode pools (pod.roles): KV handoff plane ---
POOL_WORKERS = _safe_metric(
    Gauge,
    "vgt_pool_workers",
    "Live engine workers per disaggregation role (pod.roles; "
    "prefill | decode | mixed)",
    labelnames=("role",),
)
HANDOFF_TOTAL = _safe_metric(
    Counter,
    "vgt_handoff_total",
    "Prefill→decode KV handoffs by terminal outcome: ok (decode worker "
    "accepted and continued the stream), retried (one bounded transfer "
    "retry consumed), fallback_monolithic (handoff abandoned, decode "
    "continued on the prefill worker — latency, never a 5xx), failed "
    "(handoff raced a loss/abort; the request rides the replay path)",
    labelnames=("outcome",),  # ok | retried | fallback_monolithic | failed
)
HANDOFF_ACTIVE = _safe_metric(
    Gauge,
    "vgt_handoff_active",
    "KV handoffs currently in flight (PREFILLING..ACCEPTED, not yet "
    "settled to an outcome)",
)
HANDOFF_SECONDS = _safe_metric(
    Histogram,
    "vgt_handoff_seconds",
    "Wall time of one successful KV handoff (staged on the prefill "
    "worker → decode worker accepted and resumed the stream)",
    buckets=(0.01, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 30),
)
HANDOFF_BYTES = _safe_metric(
    Histogram,
    "vgt_handoff_bytes",
    "Packed KV payload size of one successful handoff transfer",
    buckets=(
        64 * 1024, 256 * 1024, 1024 * 1024, 4 * 1024 * 1024,
        16 * 1024 * 1024, 64 * 1024 * 1024, 256 * 1024 * 1024,
    ),
)

# --- RPC plane telemetry: every gateway↔worker verb is now on the
# --- request critical path, so it gets the same latency/size evidence
# --- as the HTTP plane ---
RPC_CALL_SECONDS = _safe_metric(
    Histogram,
    "vgt_rpc_call_seconds",
    "Gateway-observed round-trip latency of one worker RPC call, by "
    "verb (send → typed reply; includes worker queueing and execution)",
    labelnames=("verb",),
    buckets=(
        0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
        0.25, 0.5, 1, 2.5, 5, 10, 30,
    ),
)
RPC_BYTES = _safe_metric(
    Histogram,
    "vgt_rpc_bytes",
    "Encoded frame payload size on the gateway↔worker plane, by "
    "direction (sent = gateway→worker calls/notifies, received = "
    "worker→gateway replies and stream frames)",
    labelnames=("direction",),  # sent | received
    buckets=(
        256, 1024, 4096, 16 * 1024, 64 * 1024, 256 * 1024,
        1024 * 1024, 4 * 1024 * 1024,
    ),
)
POD_HEARTBEAT_AGE = _safe_metric(
    Gauge,
    "vgt_pod_heartbeat_age_seconds",
    "Gateway-observed age of the freshest heartbeat reply per worker "
    "index (approaches pod.heartbeat_timeout_s before a liveness "
    "declaration; a sawtooth near the ping interval is healthy)",
    labelnames=("worker",),
)
POD_WORKER_INFLIGHT = _safe_metric(
    Gauge,
    "vgt_pod_worker_inflight",
    "Sequences resident on each worker as self-reported in its last "
    "heartbeat reply (imbalance across decode workers signals a "
    "placement or handoff problem)",
    labelnames=("worker",),
)
HANDOFF_STATE_SECONDS = _safe_metric(
    Histogram,
    "vgt_handoff_state_seconds",
    "Dwell time of one KV handoff in each state-machine state "
    "(staged = prefill done → transfer begun, transfer = chunks moving "
    "gateway-relayed, accept = commit sent → decode worker resumed); "
    "attributes WHERE a slow handoff spends its time",
    labelnames=("state",),  # staged | transfer | accept
    buckets=(0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10),
)

# --- request lifecycle: deadlines, cancellation, graceful drain ---
CANCELLED_REQUESTS = _safe_metric(
    Counter,
    "vgt_cancelled_requests",
    "Requests cancelled before completion, by reason",
    labelnames=("reason",),  # client_disconnect | deadline | drain
)
DEADLINE_PARTIAL_TOKENS = _safe_metric(
    Histogram,
    "vgt_deadline_partial_tokens",
    "Tokens already generated when a deadline shed the request",
    buckets=(0, 1, 2, 4, 8, 16, 32, 64, 128, 256, 512),
)
DRAINING = _safe_metric(
    Gauge, "vgt_draining", "1 while the server is draining for shutdown"
)
DRAINED_REQUESTS = _safe_metric(
    Counter,
    "vgt_drained_requests",
    "In-flight requests that completed during a graceful drain",
)
DRAIN_DURATION = _safe_metric(
    Histogram,
    "vgt_drain_seconds",
    "Graceful drain wall time (SIGTERM to drained/aborted)",
    buckets=(0.1, 0.5, 1, 2.5, 5, 10, 30, 60, 120),
)

# --- overload protection: admission control + brownout (vgate_tpu_torch/admission.py) ---
ADMISSION_REJECTIONS = _safe_metric(
    Counter,
    "vgt_admission_rejections",
    "Requests refused at admission, by limit hit and priority tier",
    # reason: backlog_tokens | backlog_requests | would_miss_slo |
    #         kv_pressure | per_key_inflight
    labelnames=("reason", "tier"),
)
ADMISSION_QUEUED_TOKENS = _safe_metric(
    Gauge,
    "vgt_admission_queued_tokens",
    "Estimated prompt+completion tokens admitted but not yet settled",
)
ADMISSION_QUEUED_REQUESTS = _safe_metric(
    Gauge,
    "vgt_admission_queued_requests",
    "Requests admitted but not yet settled",
)
ADMISSION_PREDICTED_WAIT = _safe_metric(
    Gauge,
    "vgt_admission_predicted_wait_seconds",
    "Estimated queue wait for newly admitted work "
    "(token backlog / decode-throughput EWMA)",
)
ADMISSION_THROUGHPUT = _safe_metric(
    Gauge,
    "vgt_admission_decode_throughput",
    "Decode-throughput EWMA (tokens/s) feeding the wait estimate",
)
PRESSURE_LEVEL = _safe_metric(
    Gauge,
    "vgt_pressure_level",
    "Adaptive brownout level (0 = normal .. 4 = maximum degradation)",
)
PRESSURE_SCORE = _safe_metric(
    Gauge,
    "vgt_pressure_score",
    "Composite overload pressure score driving the brownout controller",
)
PRESSURE_TRANSITIONS = _safe_metric(
    Counter,
    "vgt_pressure_transitions",
    "Brownout level transitions by direction",
    labelnames=("direction",),  # up | down
)

# --- silent-corruption defense (vgate_tpu_torch/integrity.py) ---
INTEGRITY_EVENTS = _safe_metric(
    Counter,
    "vgt_integrity_events",
    "Silent-corruption defense events by kind: output-sentinel trips "
    "(logit_nonfinite | logit_zero | logit_saturated | token_range | "
    "entropy_collapse), weight checksum_mismatch, canary_pass / "
    "canary_fail self-probes, and corrupt_reload / "
    "rebuild_verify_failed recovery actions",
    labelnames=("kind",),
)
WEIGHT_VERIFY_SECONDS = _safe_metric(
    Histogram,
    "vgt_weight_verify_seconds",
    "Wall time of one weight-checksum operation (baseline record, "
    "budgeted idle-sweep slice, or full rebuild-time verification)",
    buckets=(0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5, 30),
)
WEIGHT_LEAVES_VERIFIED = _safe_metric(
    Counter,
    "vgt_weight_leaves_verified",
    "Weight-tree leaves whose checksum was re-verified against the "
    "load-time baseline (idle sweep + rebuild verification)",
)
CANARY_FAILURES = _safe_metric(
    Counter,
    "vgt_canary_failures",
    "Canary self-probes that failed (fingerprint mismatch, probe "
    "error, or timeout) — a failing canary quarantines the replica "
    "and triggers a weight reload",
)
CORRUPT_QUARANTINED = _safe_metric(
    Gauge,
    "vgt_replicas_quarantined_corrupt",
    "Replicas currently quarantined for suspected silent corruption "
    "(excluded from routing/placement until their post-reload canary "
    "passes)",
)
CORRUPT_RELOADS = _safe_metric(
    Counter,
    "vgt_corrupt_reloads",
    "Engine rebuilds that RELOADED weights from the checkpoint "
    "because the fatal was classified corrupt (vs the weights-kept "
    "restart path)",
)

# --- cross-request KV prefix cache (runtime/radix_cache.py + kv_cache.py) ---
PREFIX_HIT_TOKENS = _safe_metric(
    Counter,
    "vgt_prefix_hit_tokens",
    "Prompt tokens served from shared KV pages instead of prefilled "
    "(prefix-cache hits, radix or flat-chain)",
)
PREFIX_HIT_PAGES = _safe_metric(
    Counter,
    "vgt_prefix_hit_pages",
    "Whole KV pages shared at admission via the prefix cache",
)
PREFIX_CACHED_PAGES = _safe_metric(
    Gauge,
    "vgt_prefix_cached_pages",
    "KV pages holding reusable cached prefix content not referenced by "
    "any running sequence (reclaimable under pressure)",
)
PREFIX_EVICTIONS = _safe_metric(
    Counter,
    "vgt_prefix_evictions",
    "Cached prefix pages evicted, by reason (lru = reclaimed on "
    "allocation demand, pressure = proactive trim below "
    "tpu.prefix_cache.evict_watermark)",
    labelnames=("reason",),  # lru | pressure
)
PREFIX_COW_COPIES = _safe_metric(
    Counter,
    "vgt_prefix_cow_copies",
    "Copy-on-write page copies: a request diverged inside a shared KV "
    "page and the shared head was device-copied into a fresh page",
)

INFO = _safe_metric(Info, "vgt_build", "Framework build information")


def build_fingerprint() -> Dict[str, str]:
    """Deploy-identifying facts stamped once at startup: version, git
    sha, and the torch build actually loaded.  One authoritative dict
    feeds both ``vgt_build_info`` and the ``/stats`` ``build`` block so
    Grafana panels and loadlab artifacts correlate perf deltas with
    deploys from the same fingerprint.  Every field degrades to
    "unknown" rather than failing startup — a server without a .git
    directory (container image) still exports the metric."""
    git_sha = os.environ.get("VGT_BUILD_GIT_SHA") or ""
    if not git_sha:
        try:
            repo_root = os.path.dirname(os.path.dirname(__file__))
            out = subprocess.run(
                ["git", "-C", repo_root, "rev-parse", "HEAD"],
                capture_output=True, text=True, timeout=5,
            )
            if out.returncode == 0:
                git_sha = out.stdout.strip()
        except (OSError, subprocess.SubprocessError):
            git_sha = ""
    torch_version = ""
    try:
        import torch

        torch_version = getattr(torch, "__version__", "") or ""
    except Exception:
        torch_version = ""
    from vgate_tpu_torch.version import __version__

    return {
        "version": __version__,
        "git_sha": git_sha or "unknown",
        "torch": torch_version or "unknown",
    }


def init_app_info(version: str, model_id: str, engine_type: str) -> None:
    """Populate the info metric (reference: vgate/metrics.py:199-204),
    extended with the deploy fingerprint (git sha + torch build)."""
    fp = build_fingerprint()
    INFO.info(
        {
            "version": version,
            "model": model_id,
            "engine_type": engine_type,
            "git_sha": fp["git_sha"],
            "torch": fp["torch"],
        }
    )


def _exemplar(trace_id: Optional[str] = None) -> Optional[Dict[str, str]]:
    trace_id = trace_id or get_current_trace_id()
    if trace_id:
        return {"trace_id": trace_id}
    return None


def observe_with_exemplar(
    histogram_child, value: float, trace_id: Optional[str] = None
) -> None:
    """Attach a trace id as an exemplar when available (reference
    exemplar wiring: main.py:142-153).  ``trace_id`` overrides the
    active-span lookup for observations made OFF the request's
    thread/context — the engine thread and the batcher's batch task
    observe TTFT/TPOT/step-time with the owning request's captured id."""
    try:
        histogram_child.observe(value, exemplar=_exemplar(trace_id))
    except (TypeError, ValueError):  # pragma: no cover
        histogram_child.observe(value)


def inc_with_exemplar(
    counter_child, value: float = 1.0, trace_id: Optional[str] = None
) -> None:
    try:
        counter_child.inc(value, exemplar=_exemplar(trace_id))
    except (TypeError, ValueError):  # pragma: no cover
        counter_child.inc(value)


PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
OPENMETRICS_CONTENT_TYPE = (
    "application/openmetrics-text; version=1.0.0; charset=utf-8"
)


def render_metrics(accept_header: str = "") -> tuple[bytes, str]:
    """Render the registry, negotiating OpenMetrics when requested
    (reference: main.py:278-295)."""
    if "application/openmetrics-text" in (accept_header or ""):
        return (
            om_exposition.generate_latest(REGISTRY),
            OPENMETRICS_CONTENT_TYPE,
        )
    return generate_latest(REGISTRY), PROMETHEUS_CONTENT_TYPE
