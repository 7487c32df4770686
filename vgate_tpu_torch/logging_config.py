"""Structured logging: JSON and ANSI console formatters with trace-id
injection (reference: vgate/logging_config.py:46-108).

Every log record gets ``trace_id``/``span_id`` from the active OTel span when
one exists, and an ``extra_data`` dict passed via ``extra={"extra_data": ...}``
is merged into the JSON payload (the reference's convention, e.g.
vgate/batcher.py:95-101).
"""

from __future__ import annotations

import contextlib
import json
import logging
import sys
import threading
from datetime import datetime, timezone
from typing import Any, Dict, Optional

from vgate_tpu_torch.tracing import get_current_span_id, get_current_trace_id

# Thread-local request binding: the engine thread has no active OTel
# span (spans are emitted with explicit timestamps, never attached to
# its context), so sequence-scoped log records would lose their
# request/trace identity.  The engine binds the owning request around
# per-sequence work; both formatters fall back to it when the span
# lookup yields nothing.
_bound = threading.local()


def bind_request_fields(
    request_id: Optional[str], trace_id: Optional[str]
):
    """Set the calling thread's bound request identity; returns the
    previous binding (pass it back to restore).  Hot-path friendly: two
    attribute writes, no allocation when both ids are None."""
    prev = getattr(_bound, "fields", None)
    if request_id is None and trace_id is None:
        _bound.fields = None
    else:
        fields = {}
        if request_id:
            fields["request_id"] = request_id
        if trace_id:
            fields["trace_id"] = trace_id
        _bound.fields = fields or None
    return prev


def restore_request_fields(prev) -> None:
    _bound.fields = prev


@contextlib.contextmanager
def bound_request(
    request_id: Optional[str] = None, trace_id: Optional[str] = None
):
    prev = bind_request_fields(request_id, trace_id)
    try:
        yield
    finally:
        restore_request_fields(prev)


def _bound_fields() -> Optional[Dict[str, str]]:
    return getattr(_bound, "fields", None)

_ANSI = {
    "DEBUG": "\033[36m",
    "INFO": "\033[32m",
    "WARNING": "\033[33m",
    "ERROR": "\033[31m",
    "CRITICAL": "\033[35m",
}
_RESET = "\033[0m"


class JSONFormatter(logging.Formatter):
    """One JSON object per line (reference: vgate/logging_config.py:46-75)."""

    def format(self, record: logging.LogRecord) -> str:
        payload: Dict[str, Any] = {
            "timestamp": datetime.fromtimestamp(
                record.created, tz=timezone.utc
            ).isoformat(),
            "level": record.levelname,
            "logger": record.name,
            "message": record.getMessage(),
        }
        trace_id = get_current_trace_id()
        if trace_id:
            payload["trace_id"] = trace_id
            span_id = get_current_span_id()
            if span_id:
                payload["span_id"] = span_id
        else:
            bound = _bound_fields()
            if bound:
                payload.update(bound)
        extra = getattr(record, "extra_data", None)
        if isinstance(extra, dict):
            payload.update(extra)
        if record.exc_info:
            payload["exception"] = self.formatException(record.exc_info)
        return json.dumps(payload, default=str)


class ConsoleFormatter(logging.Formatter):
    """Human-readable colored lines (reference: vgate/logging_config.py:78-108)."""

    def format(self, record: logging.LogRecord) -> str:
        color = _ANSI.get(record.levelname, "")
        ts = datetime.fromtimestamp(record.created).strftime("%H:%M:%S.%f")[:-3]
        parts = [
            f"{ts} {color}{record.levelname:<8}{_RESET} "
            f"{record.name}: {record.getMessage()}"
        ]
        trace_id = get_current_trace_id()
        if trace_id:
            parts.append(f" [trace={trace_id[:8]}]")
        else:
            bound = _bound_fields()
            if bound:
                if "trace_id" in bound:
                    parts.append(f" [trace={bound['trace_id'][:8]}]")
                if "request_id" in bound:
                    parts.append(f" [req={bound['request_id']}]")
        extra = getattr(record, "extra_data", None)
        if isinstance(extra, dict) and extra:
            parts.append(" " + json.dumps(extra, default=str))
        if record.exc_info:
            parts.append("\n" + self.formatException(record.exc_info))
        return "".join(parts)


def setup_logging(config=None) -> None:
    """Install the configured formatter on the root logger
    (reference: vgate/logging_config.py:111-149)."""
    if config is None:
        from vgate_tpu_torch.config import get_config

        config = get_config()
    root = logging.getLogger()
    root.setLevel(getattr(logging, config.logging.level.upper(), logging.INFO))
    for handler in list(root.handlers):
        root.removeHandler(handler)
    handler = logging.StreamHandler(sys.stderr)
    if config.logging.format == "json":
        handler.setFormatter(JSONFormatter())
    else:
        handler.setFormatter(ConsoleFormatter())
    root.addHandler(handler)
    # Quiet noisy third-party loggers.
    for noisy in ("aiohttp.access", "urllib3", "jax._src"):
        logging.getLogger(noisy).setLevel(logging.WARNING)


def get_logger(name: str) -> logging.Logger:
    return logging.getLogger(name)


class LogContext:
    """Context helper binding fields onto every log call
    (reference: vgate/logging_config.py:165-196)."""

    def __init__(self, logger: logging.Logger, **fields: Any) -> None:
        self._logger = logger
        self._fields = fields

    def _log(self, level: int, msg: str, **extra: Any) -> None:
        merged = {**self._fields, **extra}
        self._logger.log(level, msg, extra={"extra_data": merged})

    def debug(self, msg: str, **extra: Any) -> None:
        self._log(logging.DEBUG, msg, **extra)

    def info(self, msg: str, **extra: Any) -> None:
        self._log(logging.INFO, msg, **extra)

    def warning(self, msg: str, **extra: Any) -> None:
        self._log(logging.WARNING, msg, **extra)

    def error(self, msg: str, **extra: Any) -> None:
        self._log(logging.ERROR, msg, **extra)
