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
    quantization: Optional[str] = None
    max_model_len: int = 2048
    draft_model_id: Optional[str] = None


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
    # reference switches the port cannot serve yet: any non-default
    # value raises NotPortedError (see _check)
    prefix_cache: Any = False
    prefill_chunk: int = 0
    speculative_k: int = 0
    dp: int = 1
    tp: int = 1
    sp: int = 1
    pp: int = 1
    ep: int = 1


@dataclass
class KVCacheConfig:
    dtype: str = "auto"  # pools store the model dtype; int8 not ported
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


def _prefix_cache_enabled(value: Any) -> bool:
    if isinstance(value, dict):
        return bool(value.get("enabled", True))
    return bool(value)


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
    if m.quantization:
        raise _not_ported(
            f"model.quantization={m.quantization!r}", "queue 1, item 9"
        )
    if m.draft_model_id:
        raise _not_ported("model.draft_model_id", "queue 1, item 8")
    if cfg.kv_cache.dtype != "auto":
        raise _not_ported(
            f"kv_cache.dtype={cfg.kv_cache.dtype!r}", "queue 1, item 9"
        )
    if cfg.kv_cache.host_swap_bytes:
        raise _not_ported("kv_cache.host_swap_bytes", "queue 1, item 5")
    if _prefix_cache_enabled(d.prefix_cache):
        raise _not_ported(
            "device.prefix_cache (needs kernel K3)", "queue 1, item 5"
        )
    if d.prefill_chunk > 0:
        raise _not_ported(
            "device.prefill_chunk (needs kernel K3)", "queue 1, item 5"
        )
    if d.speculative_k > 0:
        raise _not_ported("device.speculative_k", "queue 1, item 8")
    for axis in ("dp", "tp", "sp", "pp", "ep"):
        # tp=0 is the reference's "all devices", one device here
        if getattr(d, axis) > 1:
            raise _not_ported(f"device.{axis}>1", "queue 1, item 10")
    if d.kv_page_size <= 0 or d.max_batch_slots <= 0:
        raise ValueError("kv_page_size and max_batch_slots must be > 0")
    spec = spec_for_model_id(m.model_id)
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
