"""Request cancellation tokens + the graceful-drain controller.

Two lifecycle primitives the serving stack threads through every layer
(the production-tail behaviors the vLLM/TGI serving comparison in
PAPERS.md identifies):

* :class:`CancelToken` — a thread-safe, one-shot cancellation signal a
  gateway handler arms when its client disconnects.  The batcher
  registers a dequeue callback on it while the request is queued; the
  backend registers ``seq.request_abort`` once the request is in the
  engine — so a disconnect frees the scheduler slot and KV pages within
  one decode tick instead of decoding to completion for nobody
  (the gap documented at backends/torch_backend.py's settled path).
* :class:`DrainController` — owns graceful shutdown: SIGTERM flips
  ``/health/ready`` to 503 ("draining"), admission stops with
  ``Retry-After``, in-flight requests finish up to
  ``lifecycle.drain_timeout_s``, stragglers are aborted, then the
  process exits.  k8s wiring: preStop sleep + terminationGracePeriodSeconds
  (k8s/base/deployment.yaml, docs/operations.md).

Kept free of server/engine imports so every layer can use the tokens
without cycles; the controller takes its integration points as
callables wired at app startup.  The drain's metrics are imported where
they are set, so the tokens import without prometheus_client (the
card's machine drives the backend with them, without the HTTP layer).
"""

from __future__ import annotations

import asyncio
import threading
import time
from typing import Any, Callable, List, Optional

from vgate_tpu_torch.logging_config import get_logger

logger = get_logger(__name__)

CANCEL_REASONS = ("client_disconnect", "deadline", "drain")


class CancelToken:
    """One-shot, thread-safe cancellation signal.

    ``cancel(reason)`` runs every registered callback exactly once (a
    callback added after cancellation runs immediately).  Callbacks must
    be cheap and non-raising-critical — they run on the canceller's
    thread (usually the event loop) and a failing callback must never
    mask the others, so exceptions are logged and swallowed.
    """

    __slots__ = ("_lock", "_cancelled", "_reason", "_callbacks")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._cancelled = False
        self._reason: Optional[str] = None
        self._callbacks: List[Callable[[], Any]] = []

    @property
    def cancelled(self) -> bool:
        return self._cancelled

    @property
    def reason(self) -> Optional[str]:
        return self._reason

    def cancel(self, reason: str = "client_disconnect") -> bool:
        """Fire the token.  Returns True on the first (effective) call."""
        with self._lock:
            if self._cancelled:
                return False
            self._cancelled = True
            self._reason = reason
            callbacks, self._callbacks = self._callbacks, []
        # NB no metric here: vgt_cancelled_requests counts where the
        # work is actually released (batcher dequeue / scheduler abort
        # / deadline shed), so one request can never count twice
        for cb in callbacks:
            try:
                cb()
            except Exception:  # pragma: no cover - defensive
                logger.error("cancel callback failed", exc_info=True)
        return True

    def add_callback(self, cb: Callable[[], Any]) -> None:
        with self._lock:
            if not self._cancelled:
                self._callbacks.append(cb)
                return
        # already cancelled: run inline so late registrants (e.g. a
        # backend that received the request after the disconnect) still
        # release their work
        try:
            cb()
        except Exception:  # pragma: no cover - defensive
            logger.error("cancel callback failed", exc_info=True)


def all_of(tokens: List[Optional["CancelToken"]]) -> Optional["CancelToken"]:
    """Composite token that fires only when EVERY input token has fired
    — the dedup-group semantics: one disconnected duplicate requester
    must not abort the shared generation that still-connected twins are
    waiting on.  Any None entry (a member that can never cancel) or an
    empty list makes the composite never fire, so None is returned."""
    if not tokens or any(t is None for t in tokens):
        return None
    if len(tokens) == 1:
        return tokens[0]
    combined = CancelToken()
    state = {"remaining": len(tokens)}
    lock = threading.Lock()

    def on_member(token: "CancelToken") -> None:
        with lock:
            state["remaining"] -= 1
            fire = state["remaining"] == 0
        if fire:
            combined.cancel(token.reason or "client_disconnect")

    for t in tokens:
        t.add_callback(lambda t=t: on_member(t))
    return combined


class DrainController:
    """Graceful-drain state machine for one serving process.

    Integration points (wired in server/app.py startup):

    * ``stop_admission`` — flip the batcher into draining mode (new
      submissions raise ``ServerDrainingError``);
    * ``inflight`` — callable returning the number of client-facing
      requests still being answered (the gateway middleware's counter);
    * ``abort_stragglers`` — cancel whatever is still running once
      ``drain_timeout_s`` passes (batcher pending futures + engine
      sequences);
    * ``on_complete`` — exit the process (raise ``GracefulExit`` under
      aiohttp's run_app); tests substitute a recorder.
    """

    def __init__(
        self,
        drain_timeout_s: float = 30.0,
        poll_s: float = 0.05,
        retry_after_s: float = 2.0,
        stop_admission: Optional[Callable[[], Any]] = None,
        inflight: Optional[Callable[[], int]] = None,
        abort_stragglers: Optional[Callable[[], Any]] = None,
        on_complete: Optional[Callable[[], Any]] = None,
    ) -> None:
        self.drain_timeout_s = drain_timeout_s
        self.poll_s = max(0.005, poll_s)
        self.retry_after_s = retry_after_s
        self.stop_admission = stop_admission
        self.inflight = inflight
        self.abort_stragglers = abort_stragglers
        self.on_complete = on_complete
        self._draining = False
        self._drained = asyncio.Event()
        self._task: Optional[asyncio.Task] = None
        self.started_t: Optional[float] = None
        self.aborted_stragglers = 0

    @property
    def draining(self) -> bool:
        return self._draining

    def begin(self) -> None:
        """Start the drain (idempotent; safe to call from a signal
        handler — it only schedules work on the running loop)."""
        if self._draining:
            return
        from vgate_tpu_torch import metrics

        self._draining = True
        self.started_t = time.perf_counter()
        metrics.DRAINING.set(1)
        logger.warning(
            "SIGTERM: draining — admission stopped, /health/ready now 503",
            extra={
                "extra_data": {"drain_timeout_s": self.drain_timeout_s}
            },
        )
        if self.stop_admission is not None:
            try:
                self.stop_admission()
            except Exception:  # pragma: no cover - defensive
                logger.error("stop_admission failed", exc_info=True)
        self._task = asyncio.ensure_future(self._drain())

    async def _drain(self) -> None:
        from vgate_tpu_torch import metrics

        start = self.started_t or time.perf_counter()
        deadline = start + self.drain_timeout_s
        baseline = self.inflight() if self.inflight is not None else 0
        while (
            self.inflight is not None
            and self.inflight() > 0
            and time.perf_counter() < deadline
        ):
            await asyncio.sleep(self.poll_s)
        leftover = self.inflight() if self.inflight is not None else 0
        completed = max(0, baseline - leftover)
        if completed:
            metrics.DRAINED_REQUESTS.inc(completed)
        if leftover > 0:
            self.aborted_stragglers = leftover
            logger.warning(
                "drain timeout: aborting stragglers",
                extra={"extra_data": {"stragglers": leftover}},
            )
            if self.abort_stragglers is not None:
                try:
                    self.abort_stragglers()
                except Exception:  # pragma: no cover - defensive
                    logger.error("abort_stragglers failed", exc_info=True)
            # give the aborts one poll to unwind handlers so their
            # (error) responses flush before teardown closes the loop
            grace = min(1.0, self.drain_timeout_s)
            end = time.perf_counter() + grace
            while (
                self.inflight is not None
                and self.inflight() > 0
                and time.perf_counter() < end
            ):
                await asyncio.sleep(self.poll_s)
        elapsed = time.perf_counter() - start
        metrics.DRAIN_DURATION.observe(elapsed)
        logger.warning(
            "drain complete",
            extra={
                "extra_data": {
                    "seconds": round(elapsed, 3),
                    "completed_inflight": completed,
                    "aborted_stragglers": self.aborted_stragglers,
                }
            },
        )
        self._drained.set()
        if self.on_complete is not None:
            # via call_soon, not inline: on_complete typically raises
            # GracefulExit (a SystemExit), which propagates cleanly out
            # of run_forever from a callback but would land in this
            # task's result slot (never retrieved) if raised here
            asyncio.get_running_loop().call_soon(self.on_complete)

    async def wait_drained(self, timeout: Optional[float] = None) -> bool:
        """Test/ops helper: block until the drain finished."""
        try:
            await asyncio.wait_for(self._drained.wait(), timeout)
            return True
        except asyncio.TimeoutError:
            return False
