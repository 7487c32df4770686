"""The PyTorch/CUDA backend (`engine_type: torch_cuda`), the counterpart
of vgate_tpu/backends/jax_backend.py's ``JaxTPUBackend``.

It builds one :class:`EngineCore`, wrapped by default in the
:class:`~vgate_tpu_torch.runtime.supervisor.EngineSupervisor`
(``recovery.enabled``, as the reference does), or, with
``pod.workers > 0``, the :class:`~vgate_tpu_torch.runtime.pod_engine.PodEngine`
of worker processes, or, with ``device.dp > 1``, the
:class:`~vgate_tpu_torch.runtime.dp_engine.ReplicatedEngine` of dp
replicas in this process (unsupervised: it fails over and repairs its
replicas itself), behind the 4-method protocol
(``load_model`` / ``create_sampling_params`` / ``generate`` /
``shutdown``), plus the async surface the gateway uses when a backend
has it: ``generate_settled_async`` (batches whose sequences join the
running engine between decode steps, failures settled per slot, one
cancel token a slot), ``generate_async``, ``stream_async`` (text deltas
with stop-string holdback, and logprobs), ``abort_in_flight`` (the
drain's straggler sweep), ``pressure_signals`` and
``set_prefix_insert_suspended`` and ``set_spec_suspended`` (admission
and brownout), ``embed`` (the encoder behind /v1/embeddings,
:class:`Embedder`), and the health and stats reads.
"""

from __future__ import annotations

import asyncio
import os
import threading
from typing import Any, AsyncIterator, Dict, List, Optional, Sequence

import numpy as np
import torch

from vgate_tpu_torch import faults
from vgate_tpu_torch.backends.base import GenerationResult, SamplingParams
from vgate_tpu_torch.config import get_config
from vgate_tpu_torch.errors import state_is_alive, state_is_ready
from vgate_tpu_torch.logging_config import get_logger
from vgate_tpu_torch.runtime import engine_metrics as metrics
from vgate_tpu_torch.models.specs import spec_for_model_id
from vgate_tpu_torch.runtime.engine_core import (
    _DTYPES,
    EngineCore,
    resolve_device,
)
from vgate_tpu_torch.runtime.sequence import SeqStatus
from vgate_tpu_torch.utils.math import bucket_for

logger = get_logger(__name__)


class Embedder:
    """The encoder model behind /v1/embeddings (the reference backend's
    ``Embedder``): inputs framed as BOS + ids + EOS, padded to the
    smallest of the 32/128/512-token buckets that holds the longest, in
    batches of up to 64 (a power of two), one forward a batch
    (models/encoder.py ``encode_forward``) under a lock.  Weights come
    from a safetensors directory, else random init from seed 0 on
    ``device`` (logged: such vectors mean nothing); ``params`` skips
    loading."""

    BUCKETS = (32, 128, 512)
    MAX_BATCH = 64

    def __init__(
        self,
        model_id: str,
        checkpoint_path: Optional[str],
        dtype: torch.dtype = torch.float32,
        device: torch.device | str = "cpu",
        params: Optional[Dict[str, Any]] = None,
    ) -> None:
        from vgate_tpu_torch.models import encoder
        from vgate_tpu_torch.runtime.tokenizer import get_tokenizer

        self.spec = spec_for_model_id(model_id)
        if not self.spec.is_encoder:
            raise ValueError(f"{model_id} is not an encoder model")
        self.tokenizer = get_tokenizer(self.spec, checkpoint_path)
        self.device = torch.device(device)
        if params is not None:
            self.params = params
        elif checkpoint_path and os.path.isdir(checkpoint_path):
            self.params = encoder.encoder_params_from_safetensors(
                self.spec, checkpoint_path, self.device, dtype
            )
        else:
            logger.warning(
                "no embedding checkpoint found; using random-init weights",
                extra={"extra_data": {"model": model_id,
                                      "path": checkpoint_path}},
            )
            gen = torch.Generator(device=self.device)
            gen.manual_seed(0)
            self.params = encoder.init_encoder_params(
                self.spec, gen, dtype, self.device
            )
        self._forward = encoder.encode_forward
        self._lock = threading.Lock()

    def embed(self, inputs: Sequence[str]) -> List[List[float]]:
        max_len = self.spec.max_position_embeddings
        ids = [self.tokenizer.encode(t)[: max_len - 2] for t in inputs]
        longest = max(1, max(len(i) for i in ids))
        S = bucket_for(
            min(longest + 2, max_len),
            [b for b in self.BUCKETS if b <= max_len] + [max_len],
        )
        B = max(1, min(self.MAX_BATCH, 1 << (len(ids) - 1).bit_length()))
        out: List[List[float]] = []
        with self._lock, torch.inference_mode():
            for chunk_start in range(0, len(ids), B):
                chunk = ids[chunk_start : chunk_start + B]
                tokens = np.zeros((B, S), np.int32)
                mask = np.zeros((B, S), np.int32)
                for row, seq_ids in enumerate(chunk):
                    full = [self.tokenizer.bos_id, *seq_ids,
                            self.tokenizer.eos_id]
                    tokens[row, : len(full)] = full
                    mask[row, : len(full)] = 1
                vecs = self._forward(
                    self.params, self.spec,
                    torch.from_numpy(tokens).to(self.device),
                    torch.from_numpy(mask).to(self.device),
                )
                out.extend(vecs[: len(chunk)].float().cpu().tolist())
        return out


class TorchCUDABackend:
    """Continuous-batching engine on one torch device."""

    def __init__(self) -> None:
        self.core: Optional[EngineCore] = None
        self._config: Optional[Any] = None
        self._embedder: Optional[Embedder] = None
        self._embedder_lock = threading.Lock()

    # -- protocol --

    def load_model(self, config: Any) -> None:
        config = config if hasattr(config, "device") else get_config()
        self._config = config
        if config.pod.workers > 0:
            # process-isolated workers: the gateway routes over N engine
            # processes with fencing and failover, ahead of the
            # supervisor (each worker runs its own engine stack)
            from vgate_tpu_torch.runtime.pod_engine import PodEngine

            self.core = PodEngine(config)
        elif config.device.dp > 1:
            # dp replicas have their own failover; unsupervised
            from vgate_tpu_torch.runtime.dp_engine import ReplicatedEngine

            self.core = ReplicatedEngine(config)
        elif config.recovery.enabled:
            from vgate_tpu_torch.runtime.supervisor import EngineSupervisor

            self.core = EngineSupervisor(config)
        else:
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
        faults.check("backend_generate")
        raw = self.core.generate(prompts, sampling_params)
        return [GenerationResult(**r) for r in raw]

    def shutdown(self) -> None:
        """Stop the engine; a tp group's followers and process groups go
        with it (``close``), so none outlives the backend."""
        if self.core is not None:
            # a pod has no followers of its own: it stops
            getattr(self.core, "close", self.core.stop)()
            self.core = None

    def abort_in_flight(self, reason: str = "drain") -> None:
        """Graceful-drain straggler sweep: request-abort every waiting and
        running sequence at the engine's next tick."""
        if self.core is not None:
            self.core.abort_in_flight(reason)

    def set_prefix_insert_suspended(self, flag: bool) -> None:
        """Brownout L4 (admission.py "bypass cache writes")."""
        if self.core is not None:
            self.core.set_prefix_insert_suspended(bool(flag))

    def set_spec_suspended(self, flag: bool) -> None:
        """Brownout L3 (admission.py): suspend or resume speculative
        decoding on the live core (a supervisor delegates)."""
        if self.core is not None:
            self.core.set_spec_suspended(bool(flag))

    # -- embeddings --

    def embed(self, inputs: Sequence[str]) -> List[List[float]]:
        """Encoder vectors for ``inputs`` (``model.embedding_model_id``
        in the model dtype on the engine's device, from
        ``model.embedding_checkpoint_path``), the encoder built at the
        first call."""
        with self._embedder_lock:
            if self._embedder is None:
                config = self._config or get_config()
                self._embedder = Embedder(
                    config.model.embedding_model_id,
                    config.model.embedding_checkpoint_path,
                    _DTYPES[config.model.dtype],
                    device=resolve_device(config.device.device),
                )
        return self._embedder.embed(inputs)

    def pressure_signals(self) -> Dict[str, Any]:
        """KV and queue gauges for gateway admission and brownout; empty
        before the engine is loaded."""
        if self.core is None:
            return {}
        return self.core.pressure_signals()

    # -- async extensions used by the gateway --

    async def generate_settled_async(
        self,
        prompts: Sequence[str],
        sampling_params: Sequence[SamplingParams],
        cancel_tokens: Optional[Sequence[Any]] = None,
        request_meta: Optional[Sequence[Any]] = None,
    ) -> List[Any]:
        """Like ``generate_async``, but a failure is returned in its slot
        (the exception in place of a GenerationResult), so one shed or
        failed sequence never discards its batchmates' generations.

        ``cancel_tokens`` (one ``lifecycle.CancelToken`` or None a
        prompt): a token cancelled while its sequence is in the engine
        aborts exactly that sequence (slot and pages freed within one
        tick; it settles with finish_reason "abort").  ``request_meta``
        (one ``RequestMeta`` or None a prompt) rides on each sequence."""
        assert self.core is not None
        faults.check("backend_generate")
        loop = asyncio.get_running_loop()
        seqs: List[Any] = []
        # queued as one wave, as ``EngineCore.generate`` queues a batch
        with self.core._submit_lock:
            for i, (p, sp) in enumerate(zip(prompts, sampling_params)):
                try:
                    seq = self.core.submit_prompt(
                        p, sp, meta=request_meta[i] if request_meta else None
                    )
                except Exception as exc:  # queue full / dead engine
                    seqs.append(exc)
                    continue
                seqs.append(seq)
        for seq, token in zip(seqs, cancel_tokens or ()):
            if token is not None and not isinstance(seq, BaseException):
                # a token cancelled before this point fires at once
                # (add_callback runs late registrants inline)
                token.add_callback(
                    lambda s=seq, t=token: s.request_abort(
                        t.reason or "client_disconnect"
                    )
                )
        live = [s for s in seqs if not isinstance(s, BaseException)]

        def wait_all() -> None:
            for seq in live:
                seq.done_event.wait()

        try:
            await loop.run_in_executor(None, wait_all)
        except asyncio.CancelledError:
            # the awaiting task died: release the engine work it held, or
            # a dropped client keeps decoding
            for seq in live:
                seq.request_abort()
            raise
        results: List[Any] = []
        for seq in seqs:
            if isinstance(seq, BaseException):
                results.append(seq)
            elif seq.status is SeqStatus.FAILED:
                results.append(seq.error)
            else:
                results.append(self._result(seq))
        return results

    def _result(self, seq: Any) -> GenerationResult:
        core = self.core
        return GenerationResult(
            text=core.final_text(seq),
            token_ids=list(seq.generated_ids),
            num_tokens=seq.num_output_tokens,
            prompt_tokens=seq.orig_prompt_len,
            finish_reason=seq.finish_reason,
            metrics={
                "ttft": seq.ttft or 0.0,
                "tpot": seq.tpot or 0.0,
                "gen_time": (seq.finish_t or 0.0) - seq.arrival_t,
                **seq.resume_metrics(),
            },
            logprobs=(
                core.logprob_entries(seq) if seq.params.logprobs else None
            ),
        )

    async def generate_async(
        self,
        prompts: Sequence[str],
        sampling_params: Sequence[SamplingParams],
    ) -> List[GenerationResult]:
        """Submit into the running engine and await completion without
        blocking the event loop; raises the first failure."""
        settled = await self.generate_settled_async(prompts, sampling_params)
        for item in settled:
            if isinstance(item, BaseException):
                raise item
        return settled

    async def stream_async(
        self,
        prompt: str,
        params: SamplingParams,
        on_finish: Optional[Any] = None,
        on_usage: Optional[Any] = None,
        request_meta: Optional[Any] = None,
    ) -> AsyncIterator[Any]:
        """Text deltas for SSE streaming.  A tail as long as the longest
        stop string is held back, so a stop string arriving across tokens
        is never partly emitted, and so is a trailing incomplete
        character, so the deltas join to the final text.  With ``params.logprobs`` each yield is
        ``{"text": delta, "logprobs": [entries of the tokens consumed
        since the previous yield]}``; otherwise a bare string.  After the
        last delta, ``on_usage`` gets the token usage and ``on_finish``
        the finish reason.

        The engine calls ``on_token`` on its own thread, inside chunk
        readback: it only hands the token to this loop."""
        assert self.core is not None
        core = self.core
        loop = asyncio.get_running_loop()
        q: "asyncio.Queue[Optional[int]]" = asyncio.Queue()

        def on_token(token: int) -> None:
            try:
                loop.call_soon_threadsafe(q.put_nowait, token)
            except RuntimeError:
                pass  # loop closed: the consumer left, the abort follows

        seq = core.submit_prompt(
            prompt, params, stream_cb=on_token, meta=request_meta
        )

        def on_done() -> None:
            seq.done_event.wait()
            try:
                loop.call_soon_threadsafe(q.put_nowait, None)
            except RuntimeError:
                pass

        threading.Thread(target=on_done, daemon=True).start()

        emitted = ""
        ids: List[int] = []
        pending_lp: List[Any] = []

        def wrap(delta: str):
            if not params.logprobs:
                return delta
            out = {"text": delta, "logprobs": pending_lp[:]}
            pending_lp.clear()
            return out

        stops = params.stop or []
        longest_stop = max((len(s) for s in stops), default=0)
        completed = False
        try:
            while True:
                token = await q.get()
                if token is None:
                    # flush the held-back tail: the engine's stop match
                    # (final_text truncates at it) is authoritative
                    final = core.final_text(seq)
                    if len(final) > len(emitted) or pending_lp:
                        yield wrap(final[len(emitted):])
                    break
                ids.append(token)
                if params.logprobs and len(seq.logprob_data) >= len(ids):
                    lp, top = seq.logprob_data[len(ids) - 1]
                    pending_lp.append(core.lp_entry(token, lp, top))
                text = core.tokenizer.decode(ids)
                if stops:
                    cut = min(
                        (i for i in (text.find(s) for s in stops) if i != -1),
                        default=-1,
                    )
                    if cut >= 0:
                        if cut > len(emitted) or pending_lp:
                            # even a zero-length delta: the entries of the
                            # stop-completing tokens must not vanish
                            yield wrap(text[len(emitted):cut])
                        break
                    text = text[: max(len(emitted), len(text) - longest_stop)]
                # an incomplete multi-byte character decodes to U+FFFD at
                # the tail and may still become another character with
                # the next token: hold it back, so the deltas always join
                # to the final text (the reference emits it at once)
                text = text[: max(len(emitted), len(text.rstrip("\ufffd")))]
                if len(text) > len(emitted):
                    delta = text[len(emitted):]
                    emitted = text
                    yield wrap(delta)
            completed = True
        finally:
            if not completed and not seq.done_event.is_set():
                # the consumer went away mid-stream (an SSE client
                # disconnect closes this generator): stop decoding for it
                seq.request_abort()
        if seq.status is SeqStatus.FAILED:
            raise seq.error  # type: ignore[misc]
        # streams bypass the batcher, where plain requests' TTFT/TPOT are
        # observed
        for hist, value in ((metrics.TTFT, seq.ttft),
                            (metrics.TPOT, seq.tpot)):
            if value is not None:
                hist.observe(value)
        if on_usage is not None:
            on_usage({
                "prompt_tokens": seq.orig_prompt_len,
                "completion_tokens": seq.num_output_tokens,
                "total_tokens": seq.orig_prompt_len + seq.num_output_tokens,
            })
        if on_finish is not None:
            on_finish(seq.finish_reason)

    # -- introspection --

    def device_health(self) -> Dict[str, Any]:
        if self.core is None:
            return {"alive": False, "error": "not loaded"}
        return self.core.device_health()

    def serving_state(self) -> str:
        """Health-state-machine position ("serving" | "degraded" |
        "recovering" | "dead"); an unsupervised core is "serving" while
        alive and "dead" after a fatal."""
        if self.core is None:
            return "dead"
        state = getattr(self.core, "state", None)
        if state is not None:
            return state.value
        if getattr(self.core, "_fatal", None) is not None:
            return "dead"
        return "serving"

    def serving_health(self) -> Dict[str, Any]:
        """The engine block of /health: the supervisor's health block
        (state, restarts, resumed, lost, quarantine, integrity) when
        supervised, else state, liveness, readiness and the scheduler's
        queue depth."""
        health_fn = getattr(self.core, "health", None)
        if health_fn is not None:
            return health_fn()
        state = self.serving_state()
        body: Dict[str, Any] = {
            "state": state,
            "alive": state_is_alive(state),
            "ready": state_is_ready(state),
        }
        if self.core is not None:
            sched = self.core.scheduler
            body["queue_depth"] = len(sched.waiting)
            body["running"] = len(sched.running)
        return body

    def get_stats(self) -> Dict[str, Any]:
        if self.core is None:
            return {}
        return self.core.get_stats()
