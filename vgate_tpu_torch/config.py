"""Configuration of the PyTorch/CUDA port, as plain dataclasses.

``load_config(**sections)`` takes the same section dicts as the
reference's ``vgate_tpu.config.load_config`` (one test dict configures
both engines), except that the reference's ``tpu`` section is the
``device`` section here.  Only the keys this port serves are accepted:
an unknown section or key raises ``TypeError``, and a switch for a
feature the port does not have yet raises :class:`NotPortedError`
naming the ROADMAP queue that owns it — a setting is never silently
ignored.  The gateway's sections (``server``, ``batch``, ``cache``,
``gateway``, ``lifecycle``, ``admission``, ``security``,
``rate_limit``, ``metrics``, ``benchmark``) and the sections of
supervision, integrity and self-observation (``recovery``,
``integrity``, ``observability``) take the reference's field names,
defaults and validators.

Layers, lowest first, as in the reference: the defaults, the YAML file
named by ``VGT_CONFIG_PATH`` (only when that variable is set: the
repo's ``config.yaml`` is the reference's, with a ``tpu`` section this
port does not have), the ``VGT_SECTION__KEY`` environment variables,
then the caller's sections.  PyYAML is imported only to read that file,
so the engine path runs without it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

VALID_ENGINE_TYPES = ("torch_cuda", "dry_run")
VALID_DTYPES = ("bfloat16", "float32")
VALID_QUANTIZATION = ("int8", "int4")
VALID_KV_DTYPES = ("auto", "bf16", "int8")
# the admission tiers (vgate_tpu_torch/admission.py ``TIERS``), kept here
# so the config imports nothing of the HTTP layer
VALID_TIERS = ("interactive", "standard", "batch")

ENV_PREFIX = "VGT_"
CONFIG_PATH_ENV = "VGT_CONFIG_PATH"


class NotPortedError(ValueError):
    """A configured feature exists in the reference but not in the port
    yet.  The message names the ROADMAP queue that will bring it."""


@dataclass
class ModelConfig:
    model_id: str = "Qwen/Qwen2.5-1.5B-Instruct"
    engine_type: str = "torch_cuda"
    checkpoint_path: Optional[str] = None
    tokenizer_path: Optional[str] = None
    dtype: str = "bfloat16"
    # weight-only int8/int4 (ops/quant.py), quantized at load; on the
    # card every quantized projection runs the dequant-matmul kernels
    # (K4/K5).  The reference also keeps a ``tpu.quant_kernel`` switch,
    # off by default only because its TPU compiler hung on those kernels;
    # nothing here has that fault, so the port has no such switch.
    quantization: Optional[str] = None
    max_model_len: int = 2048
    # the encoder behind /v1/embeddings (models/encoder.py), loaded from
    # embedding_checkpoint_path when that directory exists, else random
    embedding_model_id: str = "BAAI/bge-base-en-v1.5"
    embedding_checkpoint_path: Optional[str] = None
    # speculative decoding with a draft MODEL (device.speculative_k > 0,
    # runtime/speculative.py DraftModelDrafter) instead of prompt
    # lookup; None keeps n-gram drafting
    draft_model_id: Optional[str] = None
    draft_checkpoint_path: Optional[str] = None


@dataclass
class PrefixCacheConfig:
    """Cross-request KV prefix sharing (runtime/radix_cache.py), with the
    reference's fields and defaults (vgate_tpu/config.py
    ``PrefixCacheConfig``).  ``device.prefix_cache`` also takes a bare
    bool, coerced to ``{"enabled": value}`` as the reference does."""

    enabled: bool = True
    # page-granular radix tree (COW partial pages, generated-token
    # reuse); false keeps the flat whole-page hash chain
    radix: bool = True
    # full pages a match must share to be taken at all
    min_share_pages: int = 1
    # copy-on-write of the shared head of a diverging page
    cow: bool = True
    # shared in-page tokens below this are recomputed, not copied
    cow_min_tokens: int = 8
    # index a finished sequence's generated tokens too (multi-turn chat)
    insert_generated: bool = True
    # prefer admitting waiting work that shares resident tree nodes
    cache_aware_sched: bool = True
    # keep this fraction of the pool truly free by trimming cold cache
    evict_watermark: float = 0.08


@dataclass
class DeviceConfig:
    """Engine shape settings; the reference's ``tpu`` section."""

    # torch device the engine runs on; "cuda" raises when no GPU exists
    device: str = "cuda"
    kv_page_size: int = 32
    kv_num_pages: int = 0  # 0 => size from free device memory
    # this engine's share of the card in bytes (0 = the whole card): the
    # pool gets what the share leaves once the engine's own weights are
    # resident, never what happens to be free at boot.  A pod whose
    # workers share one card writes hbm_utilization x total / N here.
    kv_budget_bytes: int = 0
    hbm_utilization: float = 0.9
    max_batch_slots: int = 32
    prefill_buckets: List[int] = field(
        default_factory=lambda: [128, 256, 512, 1024, 2048]
    )
    # decode steps run per host readback, and readbacks kept in flight
    decode_chunk: int = 8
    decode_pipeline: int = 2
    # prompts admitted per tick while sequences decode (0 = unlimited),
    # and same-bucket prompts stacked into one prompt pass
    prefill_admit_limit: int = 8
    prefill_batch_max: int = 8
    # cross-request KV reuse; a bare bool or a dict is coerced to a
    # PrefixCacheConfig by load_config
    prefix_cache: Any = field(default_factory=PrefixCacheConfig)
    # chunked prefill: cap the bucket ladder at this many tokens and run
    # longer prompts as serial suffix passes (0 = off)
    prefill_chunk: int = 0
    # >1: decode attention serves this many slots per CTA (K6, the
    # blocked grid B/N x KV instead of K1's B x KV); the reference's key
    # and default.  A batch N does not divide, and int8 pools, take K1.
    decode_block_slots: int = 1
    # speculative decoding: verify up to `speculative_k` drafted tokens
    # a slot in ONE forward pass (models/decoder.py spec_verify_forward
    # on K3); greedy rows by argmax match, sampled rows by rejection
    # sampling.  0 = off.  Drafts come from prompt lookup (an n-gram of
    # `speculative_ngram` tokens) or from model.draft_model_id, which
    # sees the last `draft_window` tokens (rounded up to 8).
    speculative_k: int = 0
    speculative_ngram: int = 2
    draft_window: int = 128
    # W8A8/W4A8 (ops/quant.py int8_native_einsum): per-token int8
    # activations against the int8 (or int4) weights, an exact int32
    # product; takes effect only with model.quantization, as in the
    # reference (the engine logs its warning otherwise)
    int8_native: bool = False
    # the mesh axes (parallel/mesh.py): tp > 1 shards the model over tp
    # ranks and ep > 1 a MoE model's experts over ep, one process a rank
    # (ep x tp ranks; tp 0 takes every visible device); pp > 1 splits the
    # layers over pp pipeline stages (parallel/pipeline.py); sp > 1 splits
    # each prompt's rows and the KV pool's pages over sp ranks
    # (parallel/ring_attention.py, parallel/sp_decode.py); a stage or an
    # sp rank with tp or ep > 1 is itself an ep x tp group (pp x ep x sp
    # x tp processes, sp x pp refused); dp > 1 serves
    # dp replicas of a one-device engine in this process behind a router
    # (runtime/dp_engine.py)
    dp: int = 1
    tp: int = 1
    sp: int = 1
    pp: int = 1
    ep: int = 1
    # port-only: each rank's device, rank 0 first (empty = derived from
    # `device`, pp, ep, sp and tp).  Naming one card more than once runs that many
    # ranks on it, over a gloo device group: the one-card test layout.
    # With dp > 1 it names dp x ep x tp devices, replica i taking slice i
    # (one device a replica: ["cuda:0", "cuda:0"] puts two on one card).
    devices: List[str] = field(default_factory=list)


@dataclass
class KVCacheConfig:
    """What the KV pages hold (the reference's ``kv_cache`` section):
    ``auto`` the model dtype, ``bf16`` bf16 whatever the model dtype,
    ``int8`` int8 K/V plus one bf16 scale per (page, head, slot),
    quantized on write (ops/kv_quant.py) — ~1.97x the bf16 page count
    for one budget at head_dim 128."""

    dtype: str = "auto"
    host_swap_bytes: int = 0


@dataclass
class SchedulerConfig:
    max_queue_size: int = 512
    admission_deadline_ms: float = 0.0
    preempt_on_oom: bool = True


@dataclass
class InferenceConfig:
    max_tokens: int = 256
    temperature: float = 0.7
    top_p: float = 0.95
    top_k: int = 0


@dataclass
class LoggingConfig:
    level: str = "INFO"
    format: str = "console"  # "json" | "console"


@dataclass
class TracingConfig:
    enabled: bool = False
    endpoint: str = "localhost:4317"
    sample_rate: float = 1.0
    service_name: str = "vgate-tpu-torch"


@dataclass
class RecoveryConfig:
    """Supervised engine recovery (runtime/supervisor.py): a fatal
    engine-loop error, a watchdog stall or a detected corruption tears
    the core down and rebuilds it instead of ending serving; the
    reference's fields and defaults (vgate_tpu/config.py
    ``RecoveryConfig``, where each is documented)."""

    enabled: bool = True
    max_restarts: int = 3
    restart_window_s: float = 300.0
    backoff_base_s: float = 0.25
    backoff_cap_s: float = 30.0
    degraded_probation_s: float = 30.0
    poison_threshold: int = 2
    # checkpoint in-flight sequences at a crash and replay them into the
    # rebuilt core as prefill-continues
    resume_in_flight: bool = True
    max_resume_attempts: int = 3
    # hang watchdog (0 disables); beats stamped ``compiling`` (a graph
    # capture, a kernel's first nvcc build) get compile_grace_s instead
    step_stall_s: float = 120.0
    compile_grace_s: float = 900.0


@dataclass
class IntegrityConfig:
    """Silent-corruption defense (integrity.py): output sentinels, the
    budgeted weight-checksum sweep on idle ticks, canary self-probes and
    the reload-on-corrupt rebuild; the reference's fields and defaults
    (vgate_tpu/config.py ``IntegrityConfig``)."""

    enabled: bool = True
    sentinels_enabled: bool = True
    # the per-slot guard word written inside the decode chunk
    logit_guard: bool = True
    saturate_threshold: float = 1.0e4
    entropy_window: int = 64
    entropy_min_distinct: int = 2
    entropy_min_temp: float = 0.5
    sweep_enabled: bool = True
    sweep_interval_s: float = 30.0
    sweep_leaves_per_tick: int = 2
    canary_enabled: bool = True
    canary_interval_s: float = 0.0
    canary_prompt_len: int = 8
    canary_max_tokens: int = 8
    canary_record_on_start: bool = False
    canary_timeout_s: float = 60.0
    canary_compile_grace_s: float = 900.0


@dataclass
class ObservabilityConfig:
    """The flight recorder, engine phase spans and perf attribution
    (observability/); the reference's fields and defaults
    (vgate_tpu/config.py ``ObservabilityConfig``)."""

    enabled: bool = True
    flight_ticks: int = 512
    flight_requests: int = 256
    crash_dump_ticks: int = 64
    redact_prompts: bool = True
    prompt_preview_chars: int = 48
    perf_enabled: bool = True
    perf_window_s: float = 30.0
    perf_ticks: int = 4096
    perf_compile_ledger_max: int = 256


# -- the gateway's sections (vgate_tpu/config.py, same names, defaults
# and validators; the docs of each field live there) --


@dataclass
class ServerConfig:
    host: str = "0.0.0.0"
    port: int = 8000
    request_timeout_s: float = 300.0


@dataclass
class BatchConfig:
    """Gateway-side dynamic batching (server/app.py, batcher.py)."""

    max_batch_size: int = 8
    max_wait_time_ms: float = 50.0


@dataclass
class CacheConfig:
    """The gateway's result cache (cache.py)."""

    enabled: bool = True
    max_size: int = 1024


@dataclass
class PodConfig:
    """Process-isolated engine workers (runtime/pod_engine.py and
    runtime/worker.py), with the reference's 17 fields, defaults and
    validators (vgate_tpu/config.py ``PodConfig``): the gateway process
    runs the HTTP surface, batcher and admission; each engine lives in
    its own worker process, reached over length-prefixed frames on a
    unix-domain (or localhost TCP) socket.  ``workers=0`` (the default)
    keeps the in-process engines; the restart budget and backoff and the
    canary gate reuse ``recovery.*`` and ``integrity.*``.  On one card,
    N workers share it, each in its own CUDA context."""

    # engine worker processes; 0 = in-process engines
    workers: int = 0
    # uds = unix-domain sockets under socket_dir (default: a private
    # tempdir); tcp = 127.0.0.1:port_base+i
    transport: str = "uds"
    socket_dir: str = ""
    port_base: int = 9310
    # worker interpreter override; empty = sys.executable
    python: str = ""
    # every connect and every call carries a deadline
    connect_timeout_s: float = 10.0
    call_timeout_s: float = 30.0
    # worker boot -> hello budget (imports, weights, pools)
    spawn_timeout_s: float = 180.0
    # heartbeat liveness: ping cadence, and the age past which a worker
    # is declared lost (the engine beat rides back on each ping)
    heartbeat_interval_s: float = 0.5
    heartbeat_timeout_s: float = 10.0
    # frame-size ceiling, both directions
    max_frame_bytes: int = 8 * 1024 * 1024
    # one role per worker, each "prefill" | "decode" | "mixed"; empty
    # keeps every worker "mixed"
    roles: List[str] = field(default_factory=list)
    # the KV handoff's transfer plane: chunk size, retries before the
    # monolithic fallback, per-RPC deadline, and the host staging floor
    # injected into role-split workers
    transfer_chunk_bytes: int = 1 * 1024 * 1024
    transfer_max_retries: int = 3
    transfer_timeout_s: float = 30.0
    transfer_staging_bytes: int = 64 * 1024 * 1024
    # how long a worker outlives its gateway (0: gateway EOF drains it)
    orphan_grace_s: float = 0.0


@dataclass
class MigrationConfig:
    """Planned live request migration (runtime/dp_engine.py and
    /admin/replicas), with the reference's 10 fields and defaults
    (vgate_tpu/config.py ``MigrationConfig``): drain a replica for a
    rolling deploy with zero 5xx, rebalance long decodes off a pressured
    replica, grow and shrink the dp degree without a restart.  Needs
    device.dp > 1 (a dp=1 deployment has no in-process migration target;
    it drains by SIGTERM)."""

    # master switch for the admin drain/undrain/scale surface and the
    # VGT_DRAIN_REPLICA signal path
    enabled: bool = True
    # how long an evacuation may wait for the source engine loop to
    # checkpoint the selected sequences
    evacuate_timeout_s: float = 30.0
    # the rebalancing thread (vgt-dp-balance): moves the longest-running
    # decodes off a pressured replica while a sibling sits idle, with
    # hysteresis, a rate limit and a bounded batch
    rebalance_enabled: bool = True
    rebalance_interval_s: float = 2.0
    # hot: kv_free_ratio at or below this, or queue depth at or above
    # hot_queue_depth (the pressure_signals admission keys off)
    hot_kv_free_ratio: float = 0.15
    hot_queue_depth: int = 8
    # idle: at least this free-KV ratio and an empty engine queue
    idle_kv_free_ratio: float = 0.5
    # continuously hot this long before the first move
    rebalance_hold_s: float = 10.0
    # at most one move batch per cooldown window
    rebalance_cooldown_s: float = 30.0
    # sequences moved a batch (longest-running decodes first)
    max_moves_per_cycle: int = 2
    # never move a decode younger than this many generated tokens
    min_generated_tokens: int = 8


@dataclass
class GatewayConfig:
    """The Idempotency-Key request journal (runtime/journal.py); an
    empty path keeps keys for one gateway lifetime, in memory."""

    journal_path: str = ""
    journal_fsync: bool = True
    journal_max_bytes: int = 16 * 1024 * 1024
    journal_retention_s: float = 3600.0


@dataclass
class LifecycleConfig:
    """Graceful drain on SIGTERM (lifecycle.py DrainController)."""

    drain_enabled: bool = True
    drain_timeout_s: float = 30.0
    drain_poll_ms: float = 50.0
    drain_retry_after_s: float = 2.0


@dataclass
class AdmissionConfig:
    """Token-budget admission, priority tiers and the brownout levels
    (admission.py)."""

    enabled: bool = True
    max_queued_tokens: int = 200_000
    auto_token_budget: float = 0.0
    max_queued_requests: int = 256
    reject_would_miss_slo: bool = True
    kv_free_watermark: float = 0.05
    swap_kv_relief: float = 0.5
    per_key_max_inflight: int = 0
    key_tiers: Dict[str, str] = field(default_factory=dict)
    default_tier: str = "standard"
    tier_weights: Dict[str, int] = field(
        default_factory=lambda: {
            "interactive": 8, "standard": 4, "batch": 1,
        }
    )
    tier_fractions: Dict[str, float] = field(
        default_factory=lambda: {
            "interactive": 1.0, "standard": 0.85, "batch": 0.6,
        }
    )
    throughput_alpha: float = 0.3
    throughput_init_tps: float = 400.0
    prefix_discount: float = 0.9
    brownout_enabled: bool = True
    target_wait_s: float = 5.0
    brownout_update_interval_s: float = 0.5
    brownout_hold_s: float = 10.0
    brownout_release_ratio: float = 0.8
    brownout_engage: List[float] = field(
        default_factory=lambda: [0.5, 0.7, 0.85, 0.95]
    )
    brownout_max_tokens: int = 128
    brownout_wait_ms: float = 10.0


@dataclass
class SecurityConfig:
    """API-key auth (security.py)."""

    enabled: bool = False
    api_keys: List[str] = field(default_factory=list)
    exempt_paths: List[str] = field(
        default_factory=lambda: [
            "/health", "/health/live", "/health/ready", "/metrics",
        ]
    )


@dataclass
class RateLimitConfig:
    """Sliding-window rate limiting (security.py)."""

    enabled: bool = False
    requests_per_minute: int = 60
    per_key_limits: Dict[str, int] = field(default_factory=dict)


@dataclass
class MetricsConfig:
    enabled: bool = True


@dataclass
class BenchmarkConfig:
    """Defaults of ``POST /v1/benchmark``."""

    prompts: List[str] = field(
        default_factory=lambda: [
            "Explain the benefits of systolic arrays in two sentences.",
            "Write a haiku about high-bandwidth memory.",
            "What is sequence parallelism?",
        ]
    )
    rounds: int = 3
    warmup_rounds: int = 1
    max_tokens: int = 64


@dataclass
class VGTConfig:
    server: ServerConfig = field(default_factory=ServerConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    device: DeviceConfig = field(default_factory=DeviceConfig)
    kv_cache: KVCacheConfig = field(default_factory=KVCacheConfig)
    batch: BatchConfig = field(default_factory=BatchConfig)
    cache: CacheConfig = field(default_factory=CacheConfig)
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    lifecycle: LifecycleConfig = field(default_factory=LifecycleConfig)
    gateway: GatewayConfig = field(default_factory=GatewayConfig)
    admission: AdmissionConfig = field(default_factory=AdmissionConfig)
    inference: InferenceConfig = field(default_factory=InferenceConfig)
    logging: LoggingConfig = field(default_factory=LoggingConfig)
    metrics: MetricsConfig = field(default_factory=MetricsConfig)
    tracing: TracingConfig = field(default_factory=TracingConfig)
    observability: ObservabilityConfig = field(
        default_factory=ObservabilityConfig
    )
    recovery: RecoveryConfig = field(default_factory=RecoveryConfig)
    integrity: IntegrityConfig = field(default_factory=IntegrityConfig)
    security: SecurityConfig = field(default_factory=SecurityConfig)
    rate_limit: RateLimitConfig = field(default_factory=RateLimitConfig)
    benchmark: BenchmarkConfig = field(default_factory=BenchmarkConfig)
    pod: PodConfig = field(default_factory=PodConfig)
    migration: MigrationConfig = field(default_factory=MigrationConfig)


def _not_ported(what: str, where: str) -> NotPortedError:
    return NotPortedError(f"{what} is not ported yet (ROADMAP {where})")


def _coerce_prefix_cache(value: Any) -> PrefixCacheConfig:
    """A bare bool is the master switch; a dict names fields."""
    if isinstance(value, PrefixCacheConfig):
        return value
    if isinstance(value, bool):
        value = {"enabled": value}
    if not isinstance(value, dict):
        raise TypeError(
            f"device.prefix_cache must be a bool or a dict, got {value!r}"
        )
    return _section(PrefixCacheConfig, value, "device.prefix_cache")


def _check(cfg: VGTConfig) -> None:
    """Reject values the port cannot serve, loudly."""
    from vgate_tpu_torch.models.specs import spec_for_model_id

    m, d = cfg.model, cfg.device
    if m.engine_type not in VALID_ENGINE_TYPES:
        raise ValueError(
            f"model.engine_type must be one of {VALID_ENGINE_TYPES}, "
            f"got {m.engine_type!r}"
        )
    if m.dtype not in VALID_DTYPES:
        raise ValueError(
            f"model.dtype must be one of {VALID_DTYPES}, got {m.dtype!r}"
        )
    if m.quantization is not None and m.quantization not in VALID_QUANTIZATION:
        raise ValueError(
            f"model.quantization must be one of {VALID_QUANTIZATION} or "
            f"None, got {m.quantization!r}"
        )
    if cfg.kv_cache.dtype not in VALID_KV_DTYPES:
        raise ValueError(
            f"kv_cache.dtype must be one of {VALID_KV_DTYPES}, got "
            f"{cfg.kv_cache.dtype!r}"
        )
    if cfg.kv_cache.host_swap_bytes < 0:
        raise ValueError(
            "kv_cache.host_swap_bytes must be >= 0 (0 disables)"
        )
    pc = d.prefix_cache
    if pc.min_share_pages < 1:
        raise ValueError("prefix_cache.min_share_pages must be >= 1")
    if not 0.0 <= pc.evict_watermark < 1.0:
        raise ValueError("prefix_cache.evict_watermark must be in [0, 1)")
    if d.sp > 1 and d.pp > 1:
        raise ValueError(
            f"sp={d.sp} and pp={d.pp} cannot combine: ring-"
            "attention prefill and the pipeline relay restructure "
            "the same forward along incompatible axes (sequence-"
            "inside-layers vs layers-across-stages) — a permanent "
            "design exclusion, not a missing feature; rationale and "
            "the supported matrix: docs/composition.md. For large "
            "meshes use sp*tp (long context) or pp*tp (deep model) "
            "with dp over the remainder."
        )
    if d.dp < 1:
        raise ValueError("device.dp must be >= 1")
    if d.tp < 0 or d.ep < 0 or d.pp < 0 or d.sp < 0:
        raise ValueError(
            "device.tp, device.ep, device.pp and device.sp must be >= 0 (0 "
            "= every visible device)"
        )
    if [d.tp, d.ep, d.pp, d.sp].count(0) > 1:
        raise ValueError("at most one mesh axis may be 0 (auto)")
    if d.dp > 1 and (d.tp != 1 or d.ep != 1 or d.pp != 1 or d.sp != 1):
        # torch.distributed's default group is every mesh's control
        # group, so a process holds one mesh, and dp replicas share it
        raise _not_ported(
            "device.dp>1 with device.tp, device.ep, device.pp or device.sp "
            "other than 1 (a dp replica that is itself a mesh)",
            "queue 1, item 10b (rest)",
        )
    fixed = max(d.tp, 1) * max(d.ep, 1) * max(d.pp, 1) * max(d.sp, 1)
    if d.dp > 1 and d.devices and len(d.devices) != d.dp:
        raise ValueError(
            f"device.devices names {len(d.devices)} devices but device.dp "
            f"is {d.dp}: name one device a replica"
        )
    if d.dp == 1 and d.devices and (
        len(d.devices) % fixed
        or (d.tp and d.ep and d.pp and d.sp and len(d.devices) != fixed)
    ):
        raise ValueError(
            f"device.devices names {len(d.devices)} devices but device.tp "
            f"is {d.tp}, device.ep {d.ep}, device.pp {d.pp} and device.sp "
            f"{d.sp}: their product must cover every device"
        )
    if d.kv_page_size <= 0 or d.max_batch_slots <= 0:
        raise ValueError("kv_page_size and max_batch_slots must be > 0")
    if d.decode_block_slots < 1:
        raise ValueError("device.decode_block_slots must be >= 1")
    if d.kv_budget_bytes < 0:
        raise ValueError("device.kv_budget_bytes must be >= 0")
    _check_pod(cfg.pod)
    spec = spec_for_model_id(m.model_id)
    # the mesh known at load (an axis at 0 counts as 1 without a device
    # list; the engine resolves it against the devices and checks again)
    ranks = len(d.devices) // d.dp or fixed
    if ranks > 1:
        from vgate_tpu_torch.parallel.sharding import check_mesh_config

        rest = ranks // fixed  # the axis at 0, if any
        tp, ep, pp, sp = (x or rest for x in (d.tp, d.ep, d.pp, d.sp))
        check_mesh_config(cfg, spec, tp, ep, pp, sp)
    if spec.is_encoder:
        # the reference has no decoder for an encoder either: it is
        # served behind /v1/embeddings
        raise ValueError(
            f"{spec.name} is an encoder, not a generation model: name it "
            "as model.embedding_model_id (served by /v1/embeddings)"
        )
    _check_gateway(cfg)


def _check_pod(pod: PodConfig) -> None:
    """The reference's ``PodConfig`` validators, in its order."""
    if pod.workers < 0:
        raise ValueError("pod.workers must be >= 0")
    if pod.transport not in ("uds", "tcp"):
        raise ValueError(
            f"pod.transport must be 'uds' or 'tcp', got {pod.transport!r}"
        )
    for r in pod.roles:
        if r not in ("prefill", "decode", "mixed"):
            raise ValueError(
                "pod.roles entries must be 'prefill', 'decode' or "
                f"'mixed', got {r!r}"
            )
    for name in ("transfer_chunk_bytes", "transfer_max_retries",
                 "transfer_timeout_s", "transfer_staging_bytes"):
        if getattr(pod, name) <= 0:
            raise ValueError(f"pod.{name} must be > 0")
    if pod.orphan_grace_s < 0:
        raise ValueError("pod.orphan_grace_s must be >= 0")
    if pod.roles and len(pod.roles) != pod.workers:
        raise ValueError(
            f"pod.roles has {len(pod.roles)} entries but "
            f"pod.workers={pod.workers}; give one role per worker "
            "(or leave roles empty for an all-mixed pod)"
        )


def _check_gateway(cfg: VGTConfig) -> None:
    """The reference's validators on the gateway's sections."""
    if cfg.logging.format not in ("json", "console"):
        raise ValueError("logging.format must be 'json' or 'console'")
    for name in ("journal_max_bytes", "journal_retention_s"):
        if getattr(cfg.gateway, name) <= 0:
            raise ValueError(f"gateway.{name} must be > 0")
    adm = cfg.admission
    if adm.default_tier not in VALID_TIERS:
        raise ValueError(
            f"admission.default_tier must be one of {VALID_TIERS}, "
            f"got {adm.default_tier!r}"
        )
    for key, tier in adm.key_tiers.items():
        if tier not in VALID_TIERS:
            raise ValueError(
                f"admission.key_tiers[{key!r}] must be one of "
                f"{VALID_TIERS}, got {tier!r}"
            )
    if not 0.0 <= adm.prefix_discount <= 1.0:
        raise ValueError("admission.prefix_discount must be in [0, 1]")
    engage = adm.brownout_engage
    if len(engage) != 4 or any(b <= a for a, b in zip(engage, engage[1:])):
        raise ValueError(
            "admission.brownout_engage must be 4 strictly "
            f"ascending thresholds, got {engage!r}"
        )


def _section(cls, values: Dict[str, Any], name: str):
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(values) - known)
    if unknown:
        raise TypeError(f"unknown key(s) in section {name!r}: {unknown}")
    return cls(**values)


def _coerce(raw: str) -> Any:
    """An environment string: JSON first, then bool words, else the
    string itself (the reference's parsing)."""
    try:
        return json.loads(raw)
    except (ValueError, TypeError):
        lowered = raw.lower()
        if lowered in ("true", "yes", "on"):
            return True
        if lowered in ("false", "no", "off"):
            return False
        return raw


def _env_overrides(
    environ: Optional[Dict[str, str]] = None,
) -> Dict[str, Any]:
    """``VGT_SECTION__KEY=value`` variables as nested section dicts
    (``VGT_DEVICE__PREFIX_CACHE__ENABLED`` nests one level deeper).
    Flat flags such as ``VGT_DRY_RUN`` are read where they apply."""
    environ = os.environ if environ is None else environ
    result: Dict[str, Any] = {}
    for name, raw in environ.items():
        if not name.startswith(ENV_PREFIX) or name == CONFIG_PATH_ENV:
            continue
        path = name[len(ENV_PREFIX):].lower().split("__")
        if len(path) < 2:
            continue
        node = result
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = _coerce(raw)
    return result


def _yaml_values() -> Dict[str, Any]:
    """The YAML file named by ``VGT_CONFIG_PATH``, when that is set and
    the file exists (as the reference reads it)."""
    path = os.environ.get(CONFIG_PATH_ENV)
    if not path or not os.path.exists(path):
        return {}
    import yaml

    with open(path) as fh:
        data = yaml.safe_load(fh) or {}
    if not isinstance(data, dict):
        raise ValueError(f"config file {path} must contain a mapping")
    return data


def _deep_merge(base: Dict[str, Any], over: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(base)
    for key, val in over.items():
        if isinstance(out.get(key), dict) and isinstance(val, dict):
            out[key] = _deep_merge(out[key], val)
        else:
            out[key] = val
    return out


def _build(merged: Dict[str, Any]) -> VGTConfig:
    classes = {
        f.name: f.default_factory for f in dataclasses.fields(VGTConfig)
    }
    unknown = sorted(set(merged) - set(classes))
    if unknown:
        raise TypeError(f"unknown config section(s): {unknown}")
    built = {
        name: _section(classes[name], dict(values or {}), name)
        for name, values in merged.items()
    }
    cfg = VGTConfig(**built)
    cfg.device.prefix_cache = _coerce_prefix_cache(cfg.device.prefix_cache)
    _check(cfg)
    return cfg


def config_from_dict(values: Dict[str, Any]) -> VGTConfig:
    """A resolved config from its ``dataclasses.asdict`` form (a pod's
    worker config file), with the same checks as :func:`load_config`
    but without the environment and the ``VGT_CONFIG_PATH`` file: the
    writer resolved those already."""
    return _build({k: dict(v or {}) for k, v in values.items()})


def load_config(**sections: Dict[str, Any]) -> VGTConfig:
    """Build a config from section dicts, e.g.
    ``load_config(model={"model_id": "tiny-dense"}, device={...})``,
    over the environment and the ``VGT_CONFIG_PATH`` YAML (the caller's
    values win, then the environment's, then the file's)."""
    merged = _deep_merge(_yaml_values(), _env_overrides())
    return _build(_deep_merge(
        merged, {k: dict(v or {}) for k, v in sections.items()}
    ))


_config_lock = threading.Lock()
_config: Optional[VGTConfig] = None


def get_config() -> VGTConfig:
    """Process-wide default config (``load_config()`` on first use: the
    defaults under the environment and the ``VGT_CONFIG_PATH`` file)."""
    global _config
    with _config_lock:
        if _config is None:
            _config = load_config()
        return _config


def set_config(config: VGTConfig) -> None:
    global _config
    with _config_lock:
        _config = config


def reset_config() -> None:
    """Drop the process-wide config so the next ``get_config`` rebuilds
    it."""
    global _config
    with _config_lock:
        _config = None
