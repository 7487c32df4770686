"""The engine path's view of the Prometheus series.

The engine's modules (scheduler, KV pool, radix tree, host swap tier,
engine core, backend) set the same series the reference's do, through
``from vgate_tpu_torch.runtime import engine_metrics as metrics``, so
their lines read as the reference's ``metrics.X.labels(...).inc()``.

Where prometheus_client imports, every name resolves to the collector of
``vgate_tpu_torch.metrics`` (the registry ``/metrics`` serves).  Where
it does not (a machine with the engine but not the HTTP layer), every
series resolves to a stand-in whose ``labels``, ``inc``, ``set`` and
``observe`` do nothing, and ``observe_with_exemplar`` does nothing.

Every call is made on the host side of a readback, never inside a
captured decode body (runtime/decode_graph.py).
"""

from __future__ import annotations

from typing import Any

try:
    from vgate_tpu_torch import metrics as _registry
except ImportError:  # no prometheus_client: nothing serves /metrics
    _registry = None


class _Noop:
    """A series that records nothing."""

    def labels(self, *args: Any, **kwargs: Any) -> "_Noop":
        return self

    def inc(self, amount: float = 1.0) -> None:
        pass

    def set(self, value: float) -> None:
        pass

    def observe(self, value: float) -> None:
        pass


_NOOP = _Noop()


def _observe_noop(histogram_child: Any, value: float,
                  trace_id: Any = None) -> None:
    pass


def __getattr__(name: str) -> Any:
    if _registry is not None:
        return getattr(_registry, name)
    if name == "observe_with_exemplar":
        return _observe_noop
    if name.isupper():
        return _NOOP
    raise AttributeError(name)
