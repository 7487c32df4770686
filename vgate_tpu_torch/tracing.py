"""Request tracing on the OpenTelemetry API with graceful degradation.

The reference defers all OTel SDK imports so the module loads without the SDK
installed (vgate/tracing.py:24-26, 97-108); we keep that contract.  In this
environment only the OTel *API* is present, so when the SDK (or the OTLP
exporter) is missing, ``init_tracing`` silently leaves the API's built-in
no-op tracer in place — every span call site stays unconditional.
"""

from __future__ import annotations

import logging
from typing import Any, Optional

logger = logging.getLogger(__name__)

_initialized = False
_provider: Any = None
# test/dev tracer-provider override (observability.memtrace installs an
# in-memory recorder here): consulted by every get_tracer() call so it
# takes effect even for tracers bound at module import time
_override_provider: Any = None

try:  # The OTel API is a light dependency; tolerate even its absence.
    from opentelemetry import trace as _otel_trace
except ImportError:  # pragma: no cover
    _otel_trace = None

try:
    from opentelemetry import context as _otel_context
except ImportError:  # pragma: no cover
    _otel_context = None


class _NoopSpan:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set_attribute(self, *a, **k):
        pass

    def set_attributes(self, *a, **k):
        pass

    def record_exception(self, *a, **k):
        pass

    def set_status(self, *a, **k):
        pass

    def add_event(self, *a, **k):
        pass

    def is_recording(self):
        return False

    def end(self, *a, **k):
        pass


class _NoopTracer:
    def start_as_current_span(self, *a, **k):
        return _NoopSpan()

    def start_span(self, *a, **k):
        return _NoopSpan()


def init_tracing(config=None) -> bool:
    """Initialise the tracer provider if the SDK is available and tracing is
    enabled (reference: vgate/tracing.py:38-94).  Returns True when a real
    provider was installed."""
    global _initialized, _provider
    if config is None:
        from vgate_tpu_torch.config import get_config

        config = get_config()
    if _initialized:
        return _provider is not None
    _initialized = True
    if not config.tracing.enabled or _otel_trace is None:
        return False
    try:
        from opentelemetry.sdk.resources import Resource
        from opentelemetry.sdk.trace import TracerProvider
        from opentelemetry.sdk.trace.export import BatchSpanProcessor
        from opentelemetry.sdk.trace.sampling import TraceIdRatioBased
        from opentelemetry.exporter.otlp.proto.grpc.trace_exporter import (
            OTLPSpanExporter,
        )
    except ImportError:
        logger.warning(
            "tracing.enabled=true but the OpenTelemetry SDK is not "
            "installed; spans will be no-ops"
        )
        return False

    resource = Resource.create({"service.name": config.tracing.service_name})
    provider = TracerProvider(
        resource=resource,
        sampler=TraceIdRatioBased(config.tracing.sample_rate),
    )
    provider.add_span_processor(
        BatchSpanProcessor(OTLPSpanExporter(endpoint=config.tracing.endpoint))
    )
    _otel_trace.set_tracer_provider(provider)
    _provider = provider
    return True


class _ProxyTracer:
    """Late-binding tracer: resolves the live tracer at each span call so
    a provider installed AFTER module import (init_tracing, or the
    in-memory recorder observability.memtrace puts in
    ``set_tracer_provider_override``) is honored by tracers that were
    bound at import time (``tracer = get_tracer(__name__)``)."""

    __slots__ = ("_name",)

    def __init__(self, name: str) -> None:
        self._name = name

    def _resolve(self):
        if _override_provider is not None:
            return _override_provider.get_tracer(self._name)
        return _otel_trace.get_tracer(self._name)

    def start_as_current_span(self, *a, **k):
        return self._resolve().start_as_current_span(*a, **k)

    def start_span(self, *a, **k):
        return self._resolve().start_span(*a, **k)


def get_tracer(name: str):
    """Tracer accessor; returns a no-op tracer when OTel is absent
    (reference: vgate/tracing.py:97-108)."""
    if _otel_trace is None:
        return _NoopTracer()
    return _ProxyTracer(name)


def set_tracer_provider_override(provider) -> None:
    """Install (or with None, remove) a process-local tracer provider
    that wins over the OTel global.  Exists so tests and dev tooling can
    record spans without the OTel SDK (observability/memtrace.py); not a
    serving configuration surface."""
    global _override_provider
    _override_provider = provider


def capture_context() -> Optional[Any]:
    """Snapshot the current OTel context (the active span rides in it)
    for cross-thread propagation — the batcher captures it per request
    and the engine thread parents its phase spans on it.  None when the
    OTel API is absent."""
    if _otel_context is None:
        return None
    return _otel_context.get_current()


def context_trace_id(ctx: Any) -> Optional[str]:
    """Hex trace id of the span carried by a captured context (exemplar
    attachment off the request thread), or None."""
    if ctx is None or _otel_trace is None:
        return None
    span = _otel_trace.get_current_span(ctx)
    sc = span.get_span_context()
    if sc is None or not sc.is_valid:
        return None
    return format(sc.trace_id, "032x")


def context_span_id(ctx: Any) -> Optional[str]:
    if ctx is None or _otel_trace is None:
        return None
    span = _otel_trace.get_current_span(ctx)
    sc = span.get_span_context()
    if sc is None or not sc.is_valid:
        return None
    return format(sc.span_id, "016x")


def context_to_traceparent(ctx: Any) -> Optional[str]:
    """Encode a captured context's active span as a W3C ``traceparent``
    header value (``00-<trace>-<span>-<flags>``) for the gateway →
    worker RPC plane.  The pod frame protocol is JSON, not HTTP, so the
    value rides as a plain frame field; the W3C wire format keeps it
    interoperable with anything downstream that speaks trace context.
    None when OTel is absent or the context carries no valid span."""
    if ctx is None or _otel_trace is None:
        return None
    span = _otel_trace.get_current_span(ctx)
    sc = span.get_span_context()
    if sc is None or not sc.is_valid:
        return None
    return (
        f"00-{sc.trace_id:032x}-{sc.span_id:016x}-"
        f"{int(sc.trace_flags):02x}"
    )


def context_from_traceparent(header: Optional[str]) -> Optional[Any]:
    """Decode a W3C ``traceparent`` value into an OTel context carrying
    a remote ``NonRecordingSpan`` — the worker-side half of
    :func:`context_to_traceparent`.  Spans started under the returned
    context parent onto the gateway's span, so one trace spans all pod
    processes.  Returns None (spans stay local roots) on any malformed
    input: a worker must never fail a submit over a bad trace header."""
    if not header or _otel_trace is None:
        return None
    try:
        parts = header.split("-")
        if len(parts) != 4 or parts[0] != "00":
            return None
        trace_id = int(parts[1], 16)
        span_id = int(parts[2], 16)
        flags = int(parts[3], 16)
        if len(parts[1]) != 32 or len(parts[2]) != 16:
            return None
        sc = _otel_trace.SpanContext(
            trace_id=trace_id,
            span_id=span_id,
            is_remote=True,
            trace_flags=_otel_trace.TraceFlags(flags),
        )
        if not sc.is_valid:
            return None
        return _otel_trace.set_span_in_context(
            _otel_trace.NonRecordingSpan(sc)
        )
    except (ValueError, AttributeError):
        return None


def get_current_trace_id() -> Optional[str]:
    """Hex trace id of the active span for logs/exemplars
    (reference: vgate/tracing.py:123-136)."""
    if _otel_trace is None:
        return None
    span = _otel_trace.get_current_span()
    ctx = span.get_span_context()
    if ctx is None or not ctx.is_valid:
        return None
    return format(ctx.trace_id, "032x")


def get_current_span_id() -> Optional[str]:
    if _otel_trace is None:
        return None
    span = _otel_trace.get_current_span()
    ctx = span.get_span_context()
    if ctx is None or not ctx.is_valid:
        return None
    return format(ctx.span_id, "016x")


def shutdown_tracing() -> None:
    global _initialized, _provider
    if _provider is not None:
        try:
            _provider.shutdown()
        except Exception:  # pragma: no cover
            pass
    _provider = None
    _initialized = False


def reset_tracing() -> None:
    """Test hook mirroring the reference's autouse reset fixture
    (tests/conftest.py:242-249 in the reference)."""
    shutdown_tracing()
    set_tracer_provider_override(None)
