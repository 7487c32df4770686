"""Engine wrapper + backend factory (the port's vgate_tpu/engine.py).

``VGTEngine`` is the entry point the gateway calls: it builds the backend
the config names (``torch_cuda`` or ``dry_run``), and derives TTFT/TPOT
for single chat completions from the backend's metrics.  Embeddings are
the dry-run backend's mock vectors; on ``torch_cuda`` they raise
:class:`NotPortedError` until the encoder is ported (ROADMAP queue 1,
item 8), and the gateway answers 501 — never mock vectors passed off as
a model's.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional, Sequence

from vgate_tpu_torch.backends.base import (
    GenerationResult,
    InferenceBackend,
    SamplingParams,
)
from vgate_tpu_torch.config import NotPortedError, VGTConfig, get_config
from vgate_tpu_torch.logging_config import get_logger
from vgate_tpu_torch.tracing import get_tracer

logger = get_logger(__name__)
tracer = get_tracer(__name__)

DRY_RUN_ENV = "VGT_DRY_RUN"


def _create_backend(engine_type: str) -> InferenceBackend:
    """Factory with lazy imports."""
    if os.environ.get(DRY_RUN_ENV, "").lower() in ("1", "true", "yes"):
        engine_type = "dry_run"
    if engine_type == "dry_run":
        from vgate_tpu_torch.backends.base import DryRunBackend

        return DryRunBackend()
    if engine_type == "torch_cuda":
        from vgate_tpu_torch.backends.torch_backend import TorchCUDABackend

        return TorchCUDABackend()
    raise ValueError(f"Unknown engine_type: {engine_type!r}")


class VGTEngine:
    """Thin orchestration layer over a backend."""

    def __init__(self, config: Optional[VGTConfig] = None) -> None:
        self.config = config or get_config()
        self.backend = _create_backend(self.config.model.engine_type)
        self.backend.load_model(self.config)
        logger.info(
            "engine ready",
            extra={
                "extra_data": {
                    "engine_type": type(self.backend).__name__,
                    "model": self.config.model.model_id,
                }
            },
        )

    def chat_completions(
        self,
        prompt: str,
        max_tokens: Optional[int] = None,
        temperature: Optional[float] = None,
        top_p: Optional[float] = None,
        top_k: Optional[int] = None,
    ) -> Dict[str, Any]:
        """Single-prompt generation with TTFT/TPOT accounting."""
        inf = self.config.inference
        params = self.backend.create_sampling_params(
            max_tokens=max_tokens if max_tokens is not None else inf.max_tokens,
            temperature=(
                temperature if temperature is not None else inf.temperature
            ),
            top_p=top_p if top_p is not None else inf.top_p,
            top_k=top_k if top_k is not None else inf.top_k,
        )
        with tracer.start_as_current_span("engine.chat_completions"):
            start = time.perf_counter()
            result = self.backend.generate([prompt], [params])[0]
            wall = time.perf_counter() - start
        metrics = dict(result.metrics)
        metrics.setdefault("ttft", wall)
        if result.num_tokens:
            metrics.setdefault("tpot", wall / result.num_tokens)
        metrics["total_time"] = wall
        out = result.to_dict()
        out["metrics"] = metrics
        return out

    def generate_batch(
        self,
        prompts: Sequence[str],
        sampling_params: Sequence[SamplingParams],
    ) -> List[GenerationResult]:
        return self.backend.generate(list(prompts), list(sampling_params))

    def embeddings(self, inputs: Sequence[str]) -> Dict[str, Any]:
        """Embedding vectors from the backend's ``embed`` (the dry-run
        backend's are the reference's mock vectors)."""
        embed = getattr(self.backend, "embed", None)
        if embed is None:
            raise NotPortedError(
                f"embeddings on engine_type "
                f"{self.config.model.engine_type!r} are not ported yet "
                "(ROADMAP queue 1, item 8)"
            )
        with tracer.start_as_current_span("engine.embeddings"):
            vectors = embed(list(inputs))
        total_tokens = sum(max(1, len(text.split())) for text in inputs)
        return {
            "embeddings": vectors,
            "model": self.config.model.embedding_model_id,
            "usage": {
                "prompt_tokens": total_tokens,
                "total_tokens": total_tokens,
            },
        }

    def shutdown(self) -> None:
        self.backend.shutdown()
