"""OpenAI-format request/response models (reference shapes:
vgate-client/vgate_client/models.py:27-97 and main.py:207-275)."""

from __future__ import annotations

import math
import time
import uuid
from typing import Any, Dict, List, Optional, Union

from pydantic import BaseModel, Field, field_validator

from vgate_tpu_torch.admission import TIERS

# priority tier for admission + scheduling: admission sheds batch
# first and interactive last; a key's configured tier caps the field.
# Validated against the canonical vocabulary (admission.TIERS) so a
# new tier needs exactly one definition site.
Priority = Optional[str]


def _check_priority(v: Optional[str]) -> Optional[str]:
    if v is not None and v not in TIERS:
        raise ValueError(
            f"priority must be one of {TIERS}, got {v!r}"
        )
    return v


def _logit_bias_ints(
    raw: Optional[Dict[str, float]],
) -> Optional[Dict[int, float]]:
    """OpenAI logit_bias uses stringified token-id keys; normalize to
    int keys with biases clamped to the documented [-100, 100] range.
    Non-numeric or NEGATIVE keys raise ValueError (surfaced as a 422 —
    a negative id would wrap to the end of the vocab in the device
    scatter instead of being dropped), and the entry count caps at 300
    (the OpenAI limit): K sizes device arrays and compiled program
    variants, so it must not be client-controlled without bound."""
    if not raw:
        return None
    if len(raw) > 300:
        raise ValueError(
            f"at most 300 logit_bias entries allowed, got {len(raw)}"
        )
    out: Dict[int, float] = {}
    for k, v in raw.items():
        tid = int(k)
        if not 0 <= tid <= 2**31 - 1:
            # negative ids would WRAP in the device scatter; ids past
            # int32 would overflow the device arrays (ids merely >= the
            # vocab size drop harmlessly on device)
            raise ValueError(
                f"token id must be in [0, 2**31-1], got {tid}"
            )
        val = float(v)
        if not math.isfinite(val):
            # NaN would silently clamp to +100 (a hard force) — reject
            raise ValueError(f"bias for token {tid} must be finite")
        out[tid] = max(-100.0, min(100.0, val))
    return out


class ChatMessage(BaseModel):
    role: str
    content: str


class StreamOptions(BaseModel):
    """OpenAI stream_options: include_usage adds a final pre-[DONE]
    chunk carrying the request's token usage (empty choices list)."""

    include_usage: bool = False


class ChatCompletionRequest(BaseModel):
    model: Optional[str] = None
    messages: List[ChatMessage]
    max_tokens: Optional[int] = Field(default=None, ge=1)
    # the current OpenAI name for the same knob; wins when both are set
    max_completion_tokens: Optional[int] = Field(default=None, ge=1)
    temperature: Optional[float] = None
    top_p: Optional[float] = None
    top_k: Optional[int] = None
    stop: Optional[Union[str, List[str]]] = None
    stop_token_ids: Optional[List[int]] = None
    # suppress eos/stop tokens until this many are generated
    min_tokens: int = Field(default=0, ge=0)
    seed: Optional[int] = None
    stream: bool = False
    stream_options: Optional[StreamOptions] = None
    user: Optional[str] = None
    # OpenAI logprobs: chosen-token logprob per position; top_logprobs
    # (0..8) adds that many alternatives per position
    logprobs: bool = False
    top_logprobs: Optional[int] = Field(default=None, ge=0, le=8)
    # number of choices to generate (sampled independently; seeded
    # requests use seed+i per choice).  n>1 is non-streaming only.
    n: int = Field(default=1, ge=1, le=8)
    frequency_penalty: Optional[float] = Field(
        default=None, ge=-2.0, le=2.0
    )
    presence_penalty: Optional[float] = Field(
        default=None, ge=-2.0, le=2.0
    )
    # OpenAI logit_bias: token-id (stringified, per the OpenAI schema)
    # -> additive bias in [-100, 100]
    logit_bias: Optional[Dict[str, float]] = None
    # end-to-end deadline in seconds (the body-field twin of the
    # X-Request-Timeout header; the tighter of the two wins, both
    # capped by server.request_timeout_s).  Past it the request is shed
    # between decode ticks: 504 with partial-tokens metadata.
    timeout: Optional[float] = Field(default=None, gt=0)
    # priority tier for admission + scheduling (None -> the key's
    # configured tier, else admission.default_tier)
    priority: Priority = None

    _check_priority = field_validator("priority")(_check_priority)

    def logit_bias_ints(self) -> Optional[Dict[int, float]]:
        """OpenAI sends string token-id keys; normalize + clamp."""
        return _logit_bias_ints(self.logit_bias)

    def stop_list(self) -> Optional[List[str]]:
        """OpenAI accepts a bare string or a list; normalize to a list."""
        if self.stop is None:
            return None
        stops = [self.stop] if isinstance(self.stop, str) else self.stop
        return [s for s in stops if s] or None

    def effective_max_tokens(self) -> Optional[int]:
        if self.max_completion_tokens is not None:
            return self.max_completion_tokens
        return self.max_tokens


class Usage(BaseModel):
    prompt_tokens: int = 0
    completion_tokens: int = 0
    total_tokens: int = 0


class Choice(BaseModel):
    index: int = 0
    message: ChatMessage
    finish_reason: str = "stop"
    # {"content": [{token, token_id, logprob, top_logprobs: [...]}, ...]}
    logprobs: Optional[Dict[str, Any]] = None


class ChatCompletion(BaseModel):
    id: str = Field(default_factory=lambda: f"chatcmpl-{uuid.uuid4().hex[:24]}")
    object: str = "chat.completion"
    created: int = Field(default_factory=lambda: int(time.time()))
    model: str = ""
    choices: List[Choice] = Field(default_factory=list)
    usage: Usage = Field(default_factory=Usage)
    cached: bool = False
    # generation survived an engine restart/failover via in-flight
    # checkpoint & replay (docs/operations.md); like `cached`, a vgt
    # extension to the OpenAI shape
    resumed: bool = False
    # generation was LIVE-MIGRATED between dp replicas by a planned
    # operation (replica drain / rebalance / scale-down) — explains a
    # one-off latency blip during a rolling deploy
    migrated: bool = False
    # generation prefilled on one pod worker and decoded on another via
    # the epoch-fenced KV handoff (pod.roles disaggregation) — the
    # per-request provenance flag for the disagg_vs_monolithic A/B
    disaggregated: bool = False
    metrics: Dict[str, float] = Field(default_factory=dict)


class CompletionRequest(BaseModel):
    """Legacy /v1/completions (text in, text out — no chat template);
    the prompt may be a string or a list of strings."""

    model: Optional[str] = None
    prompt: Union[str, List[str]]
    max_tokens: Optional[int] = Field(default=None, ge=1)
    temperature: Optional[float] = None
    top_p: Optional[float] = None
    top_k: Optional[int] = None
    stop: Optional[Union[str, List[str]]] = None
    stop_token_ids: Optional[List[int]] = None
    # suppress eos/stop tokens until this many are generated
    min_tokens: int = Field(default=0, ge=0)
    seed: Optional[int] = None
    logprobs: Optional[int] = Field(default=None, ge=0, le=8)
    n: int = Field(default=1, ge=1, le=8)
    # legacy best_of: generate this many candidates server-side and
    # return the n with the highest mean token logprob (must be >= n)
    best_of: Optional[int] = Field(default=None, ge=1, le=16)
    echo: bool = False
    stream: bool = False  # declared so stream=true can be rejected, not
    # silently ignored (SSE is the chat endpoint's surface)
    frequency_penalty: Optional[float] = Field(
        default=None, ge=-2.0, le=2.0
    )
    presence_penalty: Optional[float] = Field(
        default=None, ge=-2.0, le=2.0
    )
    logit_bias: Optional[Dict[str, float]] = None
    # end-to-end deadline in seconds (same semantics as the chat
    # endpoint's field; tightest of body/header/server cap wins)
    timeout: Optional[float] = Field(default=None, gt=0)
    # priority tier for admission + scheduling
    priority: Priority = None

    _check_priority = field_validator("priority")(_check_priority)

    def logit_bias_ints(self) -> Optional[Dict[int, float]]:
        return _logit_bias_ints(self.logit_bias)

    def stop_list(self) -> Optional[List[str]]:
        if self.stop is None:
            return None
        stops = [self.stop] if isinstance(self.stop, str) else self.stop
        return [s for s in stops if s] or None

    def prompt_list(self) -> List[str]:
        return [self.prompt] if isinstance(self.prompt, str) else list(
            self.prompt
        )


class TextChoice(BaseModel):
    index: int = 0
    text: str = ""
    finish_reason: str = "stop"
    logprobs: Optional[Dict[str, Any]] = None


class Completion(BaseModel):
    id: str = Field(default_factory=lambda: f"cmpl-{uuid.uuid4().hex[:24]}")
    object: str = "text_completion"
    created: int = Field(default_factory=lambda: int(time.time()))
    model: str = ""
    choices: List[TextChoice] = Field(default_factory=list)
    usage: Usage = Field(default_factory=Usage)


class EmbeddingRequest(BaseModel):
    model: Optional[str] = None
    input: Union[str, List[str]]
    user: Optional[str] = None
    # accepted for SDK symmetry; embeddings skip the token-budget path,
    # so only the per-key in-flight cap applies to them
    priority: Priority = None

    _check_priority = field_validator("priority")(_check_priority)


class EmbeddingData(BaseModel):
    object: str = "embedding"
    index: int = 0
    embedding: List[float] = Field(default_factory=list)


class EmbeddingResponse(BaseModel):
    object: str = "list"
    data: List[EmbeddingData] = Field(default_factory=list)
    model: str = ""
    usage: Usage = Field(default_factory=Usage)


class BenchmarkRequest(BaseModel):
    prompts: Optional[List[str]] = None
    rounds: Optional[int] = None
    max_tokens: Optional[int] = None


def messages_to_prompt(messages: List[ChatMessage]) -> str:
    """Flatten chat messages to a single prompt
    (reference: main.py:190-196, "Role: content\\n...\\nAssistant:")."""
    lines = [f"{m.role.capitalize()}: {m.content}" for m in messages]
    lines.append("Assistant:")
    return "\n".join(lines)
