"""Cross-thread request tracing: one span tree per request.

The HTTP span lives on the event loop; the engine runs on its own
thread.  The batcher captures the request's OTel context at submission
(:class:`RequestMeta`) and threads it through the backend seam to the
engine, which emits **phase spans** parented on it:

    POST /v1/chat/completions          (gateway, server/app.py)
      ├── batcher.submit               (gateway)
      ├── engine.queue                 (submission → admission)
      ├── engine.prefill               (bucket/compile attributes)
      ├── engine.decode                (shed/abort/preempt events)
      └── engine.detokenize            (final text assembly)

Spans are created with explicit timestamps from the engine's
perf_counter anchors, so the tree is exact even though it is assembled
off the request thread.  Everything degrades to no-ops when the OTel
API is absent, no provider is installed, or
``observability.enabled=false`` — exactly the contract tracing.py keeps.

Backends that cannot accept :class:`RequestMeta` (dry-run, external
vLLM/SGLang adapters) still produce the same tree: the batcher emits
approximate phase spans from the backend's reported ttft/gen_time
(:func:`emit_gateway_phases`), attributed ``approximate: true``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, Optional

from vgate_tpu_torch import tracing

_TRACER_NAME = "vgate_tpu_torch.engine"


@dataclass
class RequestMeta:
    """Per-request identity + trace context crossing the backend seam."""

    request_id: Optional[str] = None
    trace_ctx: Any = None  # captured OTel context, or None


class _NsClock:
    """Maps perf_counter readings onto epoch nanoseconds using one
    anchor pair, so spans built from engine timings carry real
    timestamps."""

    __slots__ = ("wall_ns", "pc")

    def __init__(self) -> None:
        self.wall_ns = time.time_ns()
        self.pc = time.perf_counter()

    def ns(self, pc: Optional[float] = None) -> int:
        if pc is None:
            pc = time.perf_counter()
        return self.wall_ns + int((pc - self.pc) * 1e9)


class RequestTrace:
    """Engine-side phase-span emitter attached to a runtime Sequence.

    All methods are cheap no-ops when the request carried no trace
    context (or observability is disabled); call sites stay
    unconditional.  Phases may restart (preemption re-queues and
    re-prefills) — each ``start`` opens a fresh span, so the trace
    shows the true execution history."""

    def __init__(self, meta: RequestMeta, enabled: bool = True) -> None:
        self.request_id = meta.request_id
        self.trace_id = tracing.context_trace_id(meta.trace_ctx)
        self._ctx = meta.trace_ctx
        # gate on a VALID trace id, not just a context object: the OTel
        # API's get_current() returns an (empty) Context even with no
        # active span, and building no-op span objects per phase on the
        # engine hot path would be pure waste when tracing is off
        self._emit = bool(enabled and self.trace_id is not None)
        self._clock = _NsClock() if self._emit else None
        self._tracer = (
            tracing.get_tracer(_TRACER_NAME) if self._emit else None
        )
        self._open: Dict[str, Any] = {}

    def start(
        self,
        phase: str,
        start_pc: Optional[float] = None,
        **attrs: Any,
    ) -> None:
        if not self._emit:
            return
        span = self._tracer.start_span(
            f"engine.{phase}",
            context=self._ctx,
            start_time=self._clock.ns(start_pc),
        )
        if attrs:
            span.set_attributes(attrs)
        if self.request_id:
            span.set_attribute("request.id", self.request_id)
        self._open[phase] = span

    def end(
        self,
        phase: str,
        end_pc: Optional[float] = None,
        **attrs: Any,
    ) -> None:
        if not self._emit:
            return
        span = self._open.pop(phase, None)
        if span is None:
            return
        if attrs:
            span.set_attributes(attrs)
        span.end(end_time=self._clock.ns(end_pc))

    def event(self, name: str, **attrs: Any) -> None:
        """Attach an event to the most relevant open phase span
        (decode > prefill > queue)."""
        if not self._emit:
            return
        for phase in ("decode", "prefill", "queue"):
            span = self._open.get(phase)
            if span is not None:
                span.add_event(name, attrs or None)
                return

    def preempted(self) -> None:
        """KV-pressure preemption: the sequence leaves its slot and
        re-enters the waiting queue — close the active compute phase
        and open a fresh queue span."""
        if not self._emit:
            return
        self.event("preempted")
        self.end("decode", preempted=True)
        self.end("prefill", preempted=True)
        self.start("queue", preempted=True)

    def resumed(self) -> None:
        """Engine crash/stall checkpoint: the sequence survives into a
        rebuilt (or surviving dp) engine — close the active compute
        phase and re-enter queue, like preemption, so the span tree
        shows the restart gap truthfully instead of one decode span
        silently spanning two engine incarnations."""
        if not self._emit:
            return
        self.event("engine_restart")
        if "queue" in self._open:
            # checkpointed while still WAITING: the queue span simply
            # keeps running across the restart
            return
        self.end("decode", resumed=True)
        self.end("prefill", resumed=True)
        self.start("queue", resumed=True)

    def migrated(self) -> None:
        """Planned live migration (replica drain / rebalance /
        scale-down): the sequence moves to another replica — span
        continuation mirrors :meth:`resumed`, with a ``migrated``
        event instead of ``engine_restart`` so a trace reads as an
        operational move, not a crash."""
        if not self._emit:
            return
        self.event("migrated")
        if "queue" in self._open:
            # evacuated while still WAITING: the queue span simply
            # keeps running across the move
            return
        self.end("decode", migrated=True)
        self.end("prefill", migrated=True)
        self.start("queue", migrated=True)

    def close(self, error: Optional[BaseException] = None) -> None:
        """Settle: end every open phase span.  Idempotent; later
        detokenize spans may still be emitted."""
        if not self._emit:
            return
        for phase in list(self._open):
            span = self._open.pop(phase)
            if error is not None:
                span.record_exception(error)
                span.set_attribute("error.type", type(error).__name__)
            span.end(end_time=self._clock.ns())

    def span(self, phase: str, **attrs: Any):
        """Context manager for a synchronous phase (detokenize)."""
        return _PhaseSpan(self, phase, attrs)


class _PhaseSpan:
    __slots__ = ("_trace", "_phase", "_attrs")

    def __init__(self, trace: RequestTrace, phase: str, attrs) -> None:
        self._trace = trace
        self._phase = phase
        self._attrs = attrs

    def __enter__(self):
        self._trace.start(self._phase, **self._attrs)
        return self

    def __exit__(self, *exc):
        self._trace.end(self._phase)
        return False


def emit_gateway_phases(
    meta: Optional[RequestMeta],
    enqueued_pc: float,
    dispatched_pc: float,
    result_metrics: Dict[str, Any],
    end_pc: float,
) -> None:
    """Approximate phase spans for black-box backends (dry-run, vLLM,
    SGLang): the batcher knows when the request queued and dispatched,
    and the backend reports ttft/gen_time — enough to attribute queue
    vs prefill vs decode without engine cooperation.  The torch_cuda
    backend never reaches this path (it accepts RequestMeta and the
    engine emits exact spans instead)."""
    if meta is None or tracing.context_trace_id(meta.trace_ctx) is None:
        return
    tracer = tracing.get_tracer(_TRACER_NAME)
    clock = _NsClock()

    def _span(name: str, start_pc: float, stop_pc: float, **attrs):
        span = tracer.start_span(
            f"engine.{name}",
            context=meta.trace_ctx,
            start_time=clock.ns(start_pc),
        )
        span.set_attribute("approximate", True)
        if meta.request_id:
            span.set_attribute("request.id", meta.request_id)
        for key, val in attrs.items():
            span.set_attribute(key, val)
        span.end(end_time=clock.ns(stop_pc))

    ttft = float(result_metrics.get("ttft") or 0.0)
    prefill_end = min(dispatched_pc + ttft, end_pc)
    _span("queue", enqueued_pc, dispatched_pc)
    _span("prefill", dispatched_pc, prefill_end)
    _span("decode", prefill_end, end_pc)
