"""The engine flight recorder: a post-mortem record of engine execution
(a copy of vgate_tpu/observability/flight.py for the port).

Two lock-cheap ring buffers (CPython ``deque.append`` is atomic under
the GIL, so the engine thread's hot path takes no lock; snapshot readers
copy defensively):

* **ticks** — one entry per engine dispatch/readback (prefill group,
  decode chunk readback, speculative round) plus event entries
  (recompile, shed, abort, preempt, crash), each carrying batch size,
  bucket, step time, KV-page occupancy and queue depth;
* **requests** — one bounded record per completed request with
  per-phase durations (queue → prefill → decode), admission bucket,
  token counts and final status, plus a live view of in-flight
  requests.

The supervisor dumps ``crash_snapshot()`` as structured JSON on every
crash classification (and keeps it for ``/stats → engine.last_crash``);
the gateway serves the live rings through ``/debug/flight`` and
``/debug/requests``.  Prompt *text* never enters a record unless
``observability.redact_prompts`` is explicitly disabled (then a short
preview is kept); token counts and fingerprints are always safe to log.
"""

from __future__ import annotations

import itertools
import time
from collections import deque
from typing import Any, Dict, List, Optional


def _now_wall() -> float:
    return time.time()


class FlightRecorder:
    """Owned by one EngineCore; rebuilt fresh on supervised restart like
    the scheduler (the pre-crash rings live on in the supervisor's
    last-crash snapshot)."""

    def __init__(self, cfg: Optional[Any] = None) -> None:
        # cfg is the config's observability section; default-construct
        # one when absent so direct EngineCore tests need no config.
        if cfg is None:
            from vgate_tpu_torch.config import ObservabilityConfig

            cfg = ObservabilityConfig()
        self.enabled = bool(cfg.enabled)
        self.redact_prompts = bool(cfg.redact_prompts)
        self.preview_chars = int(cfg.prompt_preview_chars)
        self.crash_dump_ticks = int(cfg.crash_dump_ticks)
        self._ticks: "deque[Dict[str, Any]]" = deque(
            maxlen=max(1, int(cfg.flight_ticks))
        )
        self._requests: "deque[Dict[str, Any]]" = deque(
            maxlen=max(1, int(cfg.flight_requests))
        )
        # in-flight request records keyed by seq_id; engine-thread-owned
        # (admit and close both run there), snapshots copy defensively
        self._live: Dict[int, Dict[str, Any]] = {}
        self._tick_counter = itertools.count()

    # ------------------------------------------------------------- ticks

    def record_tick(self, kind: str, **fields: Any) -> None:
        """One engine dispatch/readback or event.  Standard fields the
        engine passes: batch, bucket, step_s, kv_used, kv_free,
        queue_depth; event entries add whatever identifies the event
        (seq_id, request_id, reason, error)."""
        if not self.enabled:
            return
        entry: Dict[str, Any] = {
            "n": next(self._tick_counter),
            "t": _now_wall(),
            "kind": kind,
        }
        entry.update(fields)
        self._ticks.append(entry)

    def ticks(self, n: Optional[int] = None) -> List[Dict[str, Any]]:
        out = list(self._ticks)
        if n is not None and n >= 0:
            out = out[-n:]
        return out

    # ---------------------------------------------------------- requests

    # Phase accounting is CUMULATIVE: a record is always "in" exactly
    # one phase (queue_s -> prefill_s -> decode_s, and back to queue_s
    # on preemption); transitions accrue the elapsed time into the
    # finished phase's bucket.  Plain first_token/admit subtraction
    # would go negative after a preemption (Sequence.first_token_t
    # survives reset_for_recompute while the admission time moves).

    @staticmethod
    def _accrue(rec: Dict[str, Any], now: float) -> None:
        phase = rec.get("_phase")
        start = rec.get("_phase_start")
        if phase is not None and start is not None:
            rec[phase] = round(rec.get(phase, 0.0) + (now - start), 6)

    @staticmethod
    def _enter(rec: Dict[str, Any], phase: str, now: float) -> None:
        rec["_phase"] = phase
        rec["_phase_start"] = now

    def on_admit(
        self,
        seq: Any,
        bucket: int,
        cached_len: int = 0,
        preview: Optional[str] = None,
    ) -> None:
        """Engine thread, at admission: opens the live record (or, for
        a preempted re-admission, folds the renewed queue wait into the
        existing one) and enters the prefill phase."""
        if not self.enabled:
            return
        now_pc = time.perf_counter()
        rec = self._live.get(seq.seq_id)
        if rec is None:
            rec = {
                "seq_id": seq.seq_id,
                "request_id": getattr(seq, "request_id", None),
                "trace_id": getattr(
                    getattr(seq, "trace", None), "trace_id", None
                ),
                "arrival_t": _now_wall() - (now_pc - seq.arrival_t),
                "queue_s": round(now_pc - seq.arrival_t, 6),
                "bucket": bucket,
                "cached_tokens": cached_len,
                "prompt_tokens": seq.num_prompt_tokens,
                "deadline_s": seq.params.timeout_s,
                "status": "running",
            }
            if preview is not None and not self.redact_prompts:
                rec["prompt_preview"] = preview[: self.preview_chars]
            self._live[seq.seq_id] = rec
        else:
            # re-admission after preemption: close the renewed queue
            # phase (opened by on_preempt) and note the new bucket
            self._accrue(rec, now_pc)
            rec["bucket"] = bucket
            rec["cached_tokens"] = cached_len
        rec["preemptions"] = seq.preempt_count
        self._enter(rec, "prefill_s", now_pc)

    def on_first_token(self, seq: Any) -> None:
        """Engine thread, when a prefill's sampled token lands: accrue
        the prefill phase and enter decode."""
        rec = self._live.get(seq.seq_id)
        if rec is None:
            return
        now = time.perf_counter()
        self._accrue(rec, now)
        self._enter(rec, "decode_s", now)

    def on_preempt(self, seq: Any) -> None:
        """Engine thread, KV-pressure preemption: the sequence left its
        slot for the waiting queue — accrue the interrupted compute
        phase and re-enter queue time."""
        rec = self._live.get(seq.seq_id)
        if rec is None:
            return
        now = time.perf_counter()
        self._accrue(rec, now)
        self._enter(rec, "queue_s", now)

    def phases_of(self, seq: Any) -> Dict[str, float]:
        """Per-phase durations so far for a LIVE sequence — attached to
        deadline-shed 504 metadata so clients see where the budget
        went.  Empty when the recorder is disabled (a bare
        ``queue_s = elapsed`` would misattribute decode time)."""
        if not self.enabled:
            return {}
        now = time.perf_counter()
        rec = self._live.get(seq.seq_id)
        if rec is None:
            return {"queue_s": round(now - seq.arrival_t, 6)}
        view = dict(rec)
        self._accrue(view, now)
        return {
            key: view[key]
            # transfer_s exists only on disaggregated-pod records (the
            # gateway grafts the KV-handoff wall time onto the merged
            # view); include it so shed metadata decomposes the same
            # way /debug/requests does
            for key in ("queue_s", "prefill_s", "transfer_s", "decode_s")
            if key in view
        }

    def on_close(self, seq: Any) -> None:
        """Engine thread (plus stop/fail paths), when a sequence
        settles: accrues the final phase and moves the record to the
        completed ring.  A sequence that settles WITHOUT ever being
        admitted (deadline/admission shed from the waiting queue, drain
        sweep, crash containment) still gets a queue-only record — the
        queued-forever case is exactly what operators diagnose."""
        if not self.enabled:
            return
        end = seq.finish_t or time.perf_counter()
        rec = self._live.pop(seq.seq_id, None)
        if rec is None:
            rec = {
                "seq_id": seq.seq_id,
                "request_id": getattr(seq, "request_id", None),
                "trace_id": getattr(
                    getattr(seq, "trace", None), "trace_id", None
                ),
                "arrival_t": _now_wall() - (end - seq.arrival_t),
                "queue_s": round(end - seq.arrival_t, 6),
                "bucket": None,
                "cached_tokens": 0,
                "prompt_tokens": seq.num_prompt_tokens,
                "deadline_s": seq.params.timeout_s,
            }
        self._accrue(rec, end)
        rec.pop("_phase", None)
        rec.pop("_phase_start", None)
        rec.setdefault("prefill_s", 0.0)
        rec.setdefault("decode_s", 0.0)
        rec["total_s"] = round(end - seq.arrival_t, 6)
        rec["generated_tokens"] = seq.num_generated
        rec["preemptions"] = seq.preempt_count
        if seq.error is not None:
            rec["status"] = "failed"
            rec["error"] = (
                f"{type(seq.error).__name__}: {seq.error}"
            )
        else:
            rec["status"] = "finished"
            rec["finish_reason"] = seq.finish_reason
        self._requests.append(rec)

    def requests(self, n: Optional[int] = None) -> List[Dict[str, Any]]:
        """Completed request records, oldest first."""
        out = list(self._requests)
        if n is not None and n >= 0:
            out = out[-n:]
        return out

    def live_requests(self) -> List[Dict[str, Any]]:
        """In-flight records (defensive copies; the in-progress phase
        accrued to now, bookkeeping keys stripped)."""
        out = []
        now = time.perf_counter()
        for rec in list(self._live.values()):
            rec = dict(rec)
            self._accrue(rec, now)
            rec.pop("_phase", None)
            rec.pop("_phase_start", None)
            out.append(rec)
        return out

    def find_request(self, ident: str) -> Optional[Dict[str, Any]]:
        """Lookup by request_id, trace_id, or seq_id (newest match wins
        so a retried request id returns its latest attempt)."""
        pools = [self.live_requests(), self.requests()]
        for pool in pools:
            for rec in reversed(pool):
                if ident in (
                    rec.get("request_id"),
                    rec.get("trace_id"),
                    str(rec.get("seq_id")),
                ):
                    return rec
        return None

    # ------------------------------------------------------------- crash

    def crash_snapshot(self, error: Optional[BaseException] = None) -> Dict[str, Any]:
        """Structured post-mortem: the last ``crash_dump_ticks`` ticks
        plus whatever was in flight.  The supervisor logs this on every
        crash classification and keeps it for /stats."""
        return {
            "time": _now_wall(),
            "error": (
                f"{type(error).__name__}: {error}" if error else None
            ),
            "ticks": self.ticks(self.crash_dump_ticks),
            "in_flight": self.live_requests(),
        }

    def get_stats(self) -> Dict[str, Any]:
        return {
            "enabled": self.enabled,
            "ticks_recorded": len(self._ticks),
            "requests_recorded": len(self._requests),
            "in_flight": len(self._live),
        }
