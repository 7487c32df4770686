"""Backend protocol + the dry-run backend.

The reference pins the engine seam to four methods — ``load_model``,
``create_sampling_params``, ``generate``, ``shutdown`` — with outputs
normalized to ``{text, token_ids, num_tokens, metrics}``
(vgate/backends/base.py:21-34, vgate/backends/vllm_backend.py:53-69).  We
keep that seam and strengthen it in two ways the TPU engine needs:

* ``SamplingParams`` is an explicit per-request dataclass, and ``generate``
  accepts one per prompt — fixing the reference quirk where the whole batch
  inherits the first request's temperature/top_p (vgate/batcher.py:271).
* Backends may implement ``generate_async`` for engines with their own
  continuous-batching scheduler; callers fall back to running the sync
  ``generate`` in a thread pool otherwise.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Protocol, Sequence, runtime_checkable


@dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling controls, honored per sequence inside a batch."""

    max_tokens: int = 256
    # suppress eos/stop tokens on device until this many tokens exist
    min_tokens: int = 0
    temperature: float = 0.7
    top_p: float = 0.95
    top_k: int = 0  # 0 disables top-k
    stop: Optional[List[str]] = None
    # extra token ids that end generation with finish_reason "stop"
    # (beyond the model's eos) — the id-level sibling of `stop` strings
    stop_token_ids: Optional[List[int]] = None
    seed: Optional[int] = None
    # OpenAI-style logprobs: return the chosen token's log-probability
    # (raw-logit log-softmax) and, when top_logprobs > 0, the top
    # alternatives per position (clamped to the engine's LOGPROBS_K).
    logprobs: bool = False
    top_logprobs: int = 0
    # OpenAI penalties over generated tokens (-2..2): frequency scales
    # with the count, presence is a flat once-seen offset.
    frequency_penalty: float = 0.0
    presence_penalty: float = 0.0
    # OpenAI logit_bias: {token_id: additive bias in [-100, 100]},
    # applied to the logits before sampling at every position.
    logit_bias: Optional[Dict[int, float]] = None
    # End-to-end request deadline in seconds, measured from engine
    # arrival.  The engine sheds the sequence between decode ticks once
    # it passes (DeadlineExceededError with partial-tokens metadata →
    # 504 at the gateway).  None = only server.request_timeout_s
    # applies.  NOT part of the result-cache identity: a completed
    # result is the same whatever budget produced it.
    timeout_s: Optional[float] = None
    # Priority-tier rank (vgate_tpu_torch/admission.py: 0 = interactive,
    # 1 = standard, 2 = batch).  The engine scheduler admits
    # lower-rank sequences first and preempts higher-rank ones first
    # under KV pressure.  Like timeout_s, NOT part of the cache key.
    priority: int = 1

    @property
    def has_penalties(self) -> bool:
        return bool(self.frequency_penalty or self.presence_penalty)


@dataclass
class GenerationResult:
    """Normalized backend output (reference: vllm_backend.py:64-69)."""

    text: str
    token_ids: List[int] = field(default_factory=list)
    num_tokens: int = 0
    prompt_tokens: int = 0
    metrics: Dict[str, float] = field(default_factory=dict)
    finish_reason: str = "stop"
    # per-token logprob entries (OpenAI shape) when requested, else None
    logprobs: Optional[List[Dict[str, Any]]] = None

    def to_dict(self) -> Dict[str, Any]:
        out = {
            "text": self.text,
            "token_ids": self.token_ids,
            "num_tokens": self.num_tokens,
            "prompt_tokens": self.prompt_tokens,
            "metrics": self.metrics,
            "finish_reason": self.finish_reason,
        }
        if self.logprobs is not None:
            out["logprobs"] = self.logprobs
        return out


@runtime_checkable
class InferenceBackend(Protocol):
    """The 4-method engine seam (reference: vgate/backends/base.py:21-34)."""

    def load_model(self, model_config: Any) -> None: ...

    def create_sampling_params(self, **kwargs: Any) -> SamplingParams: ...

    def generate(
        self,
        prompts: Sequence[str],
        sampling_params: Sequence[SamplingParams],
    ) -> List[GenerationResult]: ...

    def shutdown(self) -> None: ...


class DryRunBackend:
    """Echo backend for CI / CPU containers / gateway tests
    (reference: DryRunBackend at vgate/backends/base.py:37-62)."""

    def __init__(self) -> None:
        self.model_id = "dry-run"
        self.calls = 0

    def load_model(self, config: Any) -> None:
        model_cfg = getattr(config, "model", config)
        self.model_id = getattr(model_cfg, "model_id", "dry-run")

    def create_sampling_params(self, **kwargs: Any) -> SamplingParams:
        return SamplingParams(**kwargs)

    def generate(
        self,
        prompts: Sequence[str],
        sampling_params: Sequence[SamplingParams],
    ) -> List[GenerationResult]:
        # the fault point the torch backend probes too: drills inject
        # latency or failures into dry-run serving (scripts/drain_check.sh
        # arms backend_generate:delay)
        from vgate_tpu_torch import faults

        faults.check("backend_generate")
        self.calls += 1
        start = time.perf_counter()
        results = []
        for prompt in prompts:
            text = f"[dry-run] echo: {prompt[:80]}"
            elapsed = time.perf_counter() - start
            results.append(
                GenerationResult(
                    text=text,
                    token_ids=list(range(8)),
                    num_tokens=8,
                    prompt_tokens=max(1, len(prompt.split())),
                    metrics={
                        "ttft": elapsed,
                        "gen_time": elapsed,
                        "tpot": elapsed / 8,
                    },
                )
            )
        return results

    def embed(self, inputs: Sequence[str]) -> List[List[float]]:
        """Deterministic fake embeddings (reference mock: engine.py:93-111)."""
        return [[(i % 100) * 0.01 for i in range(768)] for _ in inputs]

    def shutdown(self) -> None:
        pass
