"""Configuration of the PyTorch/CUDA port, as plain dataclasses.

``load_config(**sections)`` takes the same section dicts as the
reference's ``vgate_tpu.config.load_config`` (one test dict configures
both engines), except that the reference's ``tpu`` section is the
``device`` section here.  Only the keys this port serves are accepted:
an unknown section or key raises ``TypeError``, and a switch for a
feature the port does not have yet raises :class:`NotPortedError`
naming the ROADMAP queue that owns it — a setting is never silently
ignored.

There is no YAML or environment layer: the machine the port targets has
no PyYAML, and callers build the config in code.
"""

from __future__ import annotations

import dataclasses
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

VALID_ENGINE_TYPES = ("torch_cuda", "dry_run")
VALID_DTYPES = ("bfloat16", "float32")
VALID_QUANTIZATION = ("int8", "int4")
VALID_KV_DTYPES = ("auto", "bf16", "int8")


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
    draft_model_id: Optional[str] = None


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
    # reference switches the port cannot serve yet: any non-default
    # value raises NotPortedError (see _check)
    speculative_k: int = 0
    # W8A8 (dynamic int8 activations): pure jnp in the reference
    int8_native: bool = False
    dp: int = 1
    tp: int = 1
    sp: int = 1
    pp: int = 1
    ep: int = 1


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
    format: str = "console"


@dataclass
class TracingConfig:
    enabled: bool = False
    endpoint: str = "localhost:4317"
    sample_rate: float = 1.0
    service_name: str = "vgate-tpu-torch"


@dataclass
class VGTConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    device: DeviceConfig = field(default_factory=DeviceConfig)
    kv_cache: KVCacheConfig = field(default_factory=KVCacheConfig)
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    inference: InferenceConfig = field(default_factory=InferenceConfig)
    logging: LoggingConfig = field(default_factory=LoggingConfig)
    tracing: TracingConfig = field(default_factory=TracingConfig)


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
    if m.draft_model_id:
        raise _not_ported("model.draft_model_id", "queue 1, item 8")
    if cfg.kv_cache.dtype not in VALID_KV_DTYPES:
        raise ValueError(
            f"kv_cache.dtype must be one of {VALID_KV_DTYPES}, got "
            f"{cfg.kv_cache.dtype!r}"
        )
    if cfg.kv_cache.host_swap_bytes:
        raise _not_ported("kv_cache.host_swap_bytes", "queue 1, item 5")
    pc = d.prefix_cache
    if pc.min_share_pages < 1:
        raise ValueError("prefix_cache.min_share_pages must be >= 1")
    if not 0.0 <= pc.evict_watermark < 1.0:
        raise ValueError("prefix_cache.evict_watermark must be in [0, 1)")
    if d.speculative_k > 0:
        raise _not_ported("device.speculative_k", "queue 1, item 8")
    if d.int8_native:
        raise _not_ported("device.int8_native (W8A8)", "queue 1, item 9")
    for axis in ("dp", "tp", "sp", "pp", "ep"):
        # tp=0 is the reference's "all devices", one device here
        if getattr(d, axis) > 1:
            raise _not_ported(f"device.{axis}>1", "queue 1, item 10")
    if d.kv_page_size <= 0 or d.max_batch_slots <= 0:
        raise ValueError("kv_page_size and max_batch_slots must be > 0")
    spec = spec_for_model_id(m.model_id)
    if spec.is_moe and m.quantization:
        raise _not_ported(
            f"model.quantization={m.quantization!r} of MoE model "
            f"{spec.name} (expert quantization)", "queue 1, item 9"
        )
    if spec.is_moe:
        raise _not_ported(f"MoE model {spec.name}", "queue 1, item 9")
    if spec.is_encoder:
        raise _not_ported(f"encoder model {spec.name}", "queue 1, item 8")
    if (
        spec.ffn_sandwich or spec.sliding_window or spec.attn_softcap
        or spec.final_softcap or spec.embed_scale or spec.unit_offset_norm
        or spec.act != "silu" or spec.query_scale
    ):
        raise _not_ported(
            f"Gemma-2 family model {spec.name}", "queue 1, item 9"
        )


def _section(cls, values: Dict[str, Any], name: str):
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(values) - known)
    if unknown:
        raise TypeError(f"unknown key(s) in section {name!r}: {unknown}")
    return cls(**values)


def load_config(**sections: Dict[str, Any]) -> VGTConfig:
    """Build a config from section dicts, e.g.
    ``load_config(model={"model_id": "tiny-dense"}, device={...})``."""
    classes = {
        f.name: f.default_factory for f in dataclasses.fields(VGTConfig)
    }
    unknown = sorted(set(sections) - set(classes))
    if unknown:
        raise TypeError(f"unknown config section(s): {unknown}")
    built = {
        name: _section(classes[name], dict(values or {}), name)
        for name, values in sections.items()
    }
    cfg = VGTConfig(**built)
    cfg.device.prefix_cache = _coerce_prefix_cache(cfg.device.prefix_cache)
    _check(cfg)
    return cfg


_config_lock = threading.Lock()
_config: Optional[VGTConfig] = None


def get_config() -> VGTConfig:
    """Process-wide default config (built from defaults on first use)."""
    global _config
    with _config_lock:
        if _config is None:
            _config = load_config()
        return _config
