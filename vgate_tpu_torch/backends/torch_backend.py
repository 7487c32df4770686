"""The PyTorch/CUDA backend behind the 4-method protocol
(``load_model`` / ``create_sampling_params`` / ``generate`` /
``shutdown``), the counterpart of vgate_tpu/backends/jax_backend.py's
``JaxTPUBackend``.  It builds one plain :class:`EngineCore`; the
supervised, data-parallel and pod engines are not ported yet."""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

from vgate_tpu_torch.backends.base import GenerationResult, SamplingParams
from vgate_tpu_torch.config import get_config
from vgate_tpu_torch.logging_config import get_logger
from vgate_tpu_torch.runtime.engine_core import EngineCore

logger = get_logger(__name__)


class TorchCUDABackend:
    """Continuous-batching engine on one torch device."""

    def __init__(self) -> None:
        self.core: Optional[EngineCore] = None

    def load_model(self, config: Any) -> None:
        config = config if hasattr(config, "device") else get_config()
        self.core = EngineCore(config)
        self.core.start()
        logger.info(
            "torch_cuda backend ready",
            extra={
                "extra_data": {
                    "model": self.core.spec.name,
                    "device": str(self.core.device),
                    "kv_pages": self.core.geometry.num_pages,
                }
            },
        )

    def create_sampling_params(self, **kwargs: Any) -> SamplingParams:
        return SamplingParams(**kwargs)

    def generate(
        self,
        prompts: Sequence[str],
        sampling_params: Sequence[SamplingParams],
    ) -> List[GenerationResult]:
        assert self.core is not None, "load_model not called"
        raw = self.core.generate(prompts, sampling_params)
        return [GenerationResult(**r) for r in raw]

    def shutdown(self) -> None:
        if self.core is not None:
            self.core.stop()
            self.core = None
