"""A minimal in-memory span recorder built on the OpenTelemetry *API*
(a copy of vgate_tpu/observability/memtrace.py for the port).

This environment ships the OTel API but not the SDK, and ``tracing.py``
degrades to no-op spans in that case — which leaves the span taxonomy
untestable.  This module implements just enough of the API's
``TracerProvider``/``Tracer``/``Span`` surface to record real span trees
(ids, parents, attributes, events, timestamps) into a bounded in-memory
list, with correct context propagation via the API's contextvars
runtime.  Installed through
:func:`vgate_tpu_torch.tracing.set_tracer_provider_override`, so it wins over
the global provider without touching OTel's set-once global state.

Test/dev tooling only — production tracing goes through ``init_tracing``
and the real SDK when present.
"""

from __future__ import annotations

import random
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

try:
    from opentelemetry import trace as _trace
    from opentelemetry.trace import (
        INVALID_SPAN,
        SpanContext,
        TraceFlags,
    )
except ImportError:  # pragma: no cover - OTel API absent
    _trace = None

_ids = random.Random()
_ids_lock = threading.Lock()


def _gen_ids(parent_sc) -> "SpanContext":
    with _ids_lock:
        trace_id = (
            parent_sc.trace_id
            if parent_sc is not None and parent_sc.is_valid
            else _ids.getrandbits(128)
        )
        span_id = _ids.getrandbits(64)
    return SpanContext(
        trace_id=trace_id,
        span_id=span_id,
        is_remote=False,
        trace_flags=TraceFlags(TraceFlags.SAMPLED),
    )


class MemorySpan(_trace.Span if _trace is not None else object):
    """Recording span: attributes/events/status land on the object; the
    recorder keeps every started span (ended or not) in order."""

    def __init__(
        self,
        name: str,
        context: "SpanContext",
        parent: Optional["SpanContext"],
        attributes: Optional[Dict[str, Any]] = None,
        start_time: Optional[int] = None,
    ) -> None:
        self.name = name
        self._context = context
        self.parent = parent
        self.attributes: Dict[str, Any] = dict(attributes or {})
        self.events: List[tuple] = []
        self.status: Optional[Any] = None
        self.recorded_exceptions: List[BaseException] = []
        self.start_time = (
            start_time if start_time is not None else time.time_ns()
        )
        self.end_time: Optional[int] = None

    # -- OTel API Span surface --

    def get_span_context(self) -> "SpanContext":
        return self._context

    def set_attribute(self, key: str, value: Any) -> None:
        self.attributes[key] = value

    def set_attributes(self, attributes: Dict[str, Any]) -> None:
        self.attributes.update(attributes)

    def add_event(
        self, name: str, attributes: Any = None, timestamp: Any = None
    ) -> None:
        self.events.append(
            (name, dict(attributes or {}), timestamp or time.time_ns())
        )

    def add_link(self, context: Any, attributes: Any = None) -> None:
        pass

    def update_name(self, name: str) -> None:
        self.name = name

    def is_recording(self) -> bool:
        return self.end_time is None

    def set_status(self, status: Any, description: Any = None) -> None:
        self.status = status

    def record_exception(
        self,
        exception: BaseException,
        attributes: Any = None,
        timestamp: Any = None,
        escaped: bool = False,
    ) -> None:
        self.recorded_exceptions.append(exception)
        self.add_event(
            "exception", {"exception.type": type(exception).__name__}
        )

    def end(self, end_time: Optional[int] = None) -> None:
        if self.end_time is None:
            self.end_time = (
                end_time if end_time is not None else time.time_ns()
            )

    # -- convenience for assertions --

    @property
    def trace_id_hex(self) -> str:
        return format(self._context.trace_id, "032x")

    @property
    def span_id_hex(self) -> str:
        return format(self._context.span_id, "016x")

    @property
    def parent_span_id_hex(self) -> Optional[str]:
        if self.parent is None or not self.parent.is_valid:
            return None
        return format(self.parent.span_id, "016x")

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"MemorySpan({self.name!r}, trace={self.trace_id_hex[:8]}, "
            f"span={self.span_id_hex[:8]}, "
            f"parent={(self.parent_span_id_hex or 'root')[:8]})"
        )


class MemoryTracer(_trace.Tracer if _trace is not None else object):
    def __init__(self, recorder: "MemorySpanRecorder") -> None:
        self._recorder = recorder

    def start_span(
        self,
        name: str,
        context: Any = None,
        kind: Any = None,
        attributes: Any = None,
        links: Any = None,
        start_time: Optional[int] = None,
        record_exception: bool = True,
        set_status_on_exception: bool = True,
    ) -> MemorySpan:
        parent_span = _trace.get_current_span(context)
        parent_sc = None
        if parent_span is not None and parent_span is not INVALID_SPAN:
            sc = parent_span.get_span_context()
            if sc is not None and sc.is_valid:
                parent_sc = sc
        span = MemorySpan(
            name,
            _gen_ids(parent_sc),
            parent_sc,
            attributes=attributes,
            start_time=start_time,
        )
        self._recorder._record(span)
        return span

    @contextmanager
    def start_as_current_span(
        self,
        name: str,
        context: Any = None,
        kind: Any = None,
        attributes: Any = None,
        links: Any = None,
        start_time: Optional[int] = None,
        record_exception: bool = True,
        set_status_on_exception: bool = True,
        end_on_exit: bool = True,
    ):
        span = self.start_span(
            name, context=context, attributes=attributes,
            start_time=start_time,
        )
        with _trace.use_span(
            span,
            end_on_exit=end_on_exit,
            record_exception=record_exception,
            set_status_on_exception=set_status_on_exception,
        ) as active:
            yield active


class MemorySpanRecorder:
    """TracerProvider + span store.  ``install()`` routes every
    ``vgate_tpu_torch.tracing.get_tracer`` through it; ``uninstall()`` (or the
    test harness's ``reset_tracing``) restores the default path."""

    def __init__(self, max_spans: int = 10_000) -> None:
        self._spans: "deque[MemorySpan]" = deque(maxlen=max_spans)
        self._lock = threading.Lock()

    # -- TracerProvider surface --

    def get_tracer(self, name: str, *a: Any, **k: Any) -> MemoryTracer:
        return MemoryTracer(self)

    # -- recording --

    def _record(self, span: MemorySpan) -> None:
        with self._lock:
            self._spans.append(span)

    def spans(self, name: Optional[str] = None) -> List[MemorySpan]:
        """Started spans in start order (optionally filtered by name)."""
        with self._lock:
            out = list(self._spans)
        if name is not None:
            out = [s for s in out if s.name == name]
        return out

    def finished_spans(self) -> List[MemorySpan]:
        return [s for s in self.spans() if s.end_time is not None]

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()

    # -- lifecycle --

    def install(self) -> "MemorySpanRecorder":
        from vgate_tpu_torch import tracing

        if _trace is None:  # pragma: no cover - OTel API absent
            raise RuntimeError(
                "the opentelemetry API is required for span recording"
            )
        tracing.set_tracer_provider_override(self)
        return self

    def uninstall(self) -> None:
        from vgate_tpu_torch import tracing

        tracing.set_tracer_provider_override(None)
