"""Supervised engine recovery + the serving health state machine.

The port's copy of vgate_tpu/runtime/supervisor.py.  The engine core
treats any step-loop exception as terminal: ``_fatal`` is set, every
owed future fails or is checkpointed, and all later submissions raise.
On a GPU a CUDA out-of-memory error or a failed launch is a normal
event, so serving must not end there.  ``EngineSupervisor`` wraps one
:class:`~vgate_tpu_torch.runtime.engine_core.EngineCore` and:

* watches for the fatal state (the core's ``on_fatal`` hook fires from
  the engine thread once the crash is contained);
* classifies the error — **transient** (restart), **poison** (a specific
  request keeps crashing the engine: quarantine it, then restart), or
  **unrecoverable** (straight to ``DEAD``);
* tears the core down and rebuilds it with capped exponential backoff
  and a sliding-window restart budget.  Weights are KEPT (the previous
  incarnation's already-quantized tree on the card is passed back
  through ``EngineCore(params=...)`` — no reload, no re-quantize); KV
  pages, decode graphs and scheduler state are rebuilt fresh;
* fails in-flight requests with the retryable
  :class:`~vgate_tpu_torch.errors.EngineRecoveringError` (503 + Retry-After at
  the gateway) and rejects new submissions fast while ``RECOVERING``;
* quarantines suspected poison requests by prompt fingerprint so a
  client retry cannot re-crash the next incarnation.

Health state machine, surfaced through /health (readiness vs liveness
split) and /stats::

    SERVING ──crash──▶ RECOVERING ──restart ok──▶ DEGRADED ──probation──▶ SERVING
       ▲                   │
       └───────────────────┴──budget exhausted / unrecoverable──▶ DEAD

``DEGRADED`` is post-restart probation: the engine serves, but /health
reports the reduced confidence; one crash-free probation window promotes
it back to ``SERVING``.  ``DEAD`` fails the liveness probe so the
orchestrator recycles the pod.

One device only: the port has no data-parallel engine yet.  Real
errors are classified transient, as in the reference, and the restart
budget bounds a wrong classification: a CUDA error that poisons the
process's context fails every rebuild, each rebuild counts against the
budget, and the engine lands in DEAD.
"""

from __future__ import annotations

import enum
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence as Seq

from vgate_tpu_torch import faults
from vgate_tpu_torch.backends.base import SamplingParams
from vgate_tpu_torch.config import VGTConfig, get_config
from vgate_tpu_torch.errors import (
    EngineDeadError,
    EngineRecoveringError,
    EngineStalledError,
    IntegrityError,
    MigrationRefusedError,
    PoisonRequestError,
    raise_for_state,
    state_is_alive,
    state_is_ready,
)
from vgate_tpu_torch.integrity import CanaryKeeper
from vgate_tpu_torch.logging_config import get_logger
from vgate_tpu_torch.runtime import engine_metrics as metrics
from vgate_tpu_torch.runtime.engine_core import (
    EngineCore,
    rebuild_core,
    replay_into,
)
from vgate_tpu_torch.runtime.sequence import Sequence

logger = get_logger(__name__)

# Threading contract: state shared between the watcher thread, canary
# probe threads and serving-path callers (_state, _pending_resume,
# _quarantine, _suspect_counts, _restart_times) mutates only under the
# supervisor RLock.


class HealthState(enum.Enum):
    SERVING = "serving"
    DEGRADED = "degraded"
    RECOVERING = "recovering"
    DEAD = "dead"


def classify_heartbeat(
    heartbeat: Optional[Dict[str, Any]],
    now: float,
    step_stall_s: float,
    compile_grace_s: float,
) -> Optional[Dict[str, Any]]:
    """Hang-watchdog verdict for one engine heartbeat: ``None`` while
    healthy, else ``{"stalled_s", "limit_s", "phase", "compiling"}``.

    Compile-aware: a beat stamped ``compiling=True`` (a decode graph's
    capture, a kernel's first nvcc build — either can legitimately
    pause the loop for minutes) is judged against ``compile_grace_s`` instead of
    ``step_stall_s``.  Pure function of (beat, now) so tests drive it
    with fake clocks; ``step_stall_s <= 0`` disables the watchdog."""
    if step_stall_s <= 0 or not heartbeat:
        return None
    limit = (
        compile_grace_s
        if heartbeat.get("compiling")
        else step_stall_s
    )
    stalled_s = now - heartbeat.get("t", now)
    if stalled_s <= limit:
        return None
    return {
        "stalled_s": round(stalled_s, 3),
        "limit_s": limit,
        "phase": heartbeat.get("kind", "unknown"),
        "compiling": bool(heartbeat.get("compiling")),
    }


def restart_budget_remaining(
    restart_times: Seq[float], recovery: Any, now: Optional[float] = None
) -> int:
    """Restarts still available inside the sliding window — the ONE
    formula behind the `restarts_remaining` field in the supervisor's
    and the dp router's /health blocks (they must never diverge from
    the budget the repair loops actually enforce)."""
    now = time.monotonic() if now is None else now
    in_window = sum(
        1 for t in restart_times if now - t < recovery.restart_window_s
    )
    return max(0, recovery.max_restarts - in_window)


def classify_fatal(exc: BaseException) -> str:
    """transient | poison | unrecoverable | corrupt.  Injected faults
    carry their kind (faults.InjectedFault.fault_kind), and
    IntegrityError (sentinel trip / checksum mismatch / canary failure;
    fault_kind = "corrupt") routes to the reload-on-corrupt rebuild —
    a weights-kept restart would preserve the corruption.  Real errors
    default to transient — a restart is cheap relative to killing
    serving, and the restart budget bounds misclassification."""
    kind = getattr(exc, "fault_kind", None)
    if kind in faults.FAULT_KINDS:
        return kind
    if isinstance(exc, MemoryError):
        return "unrecoverable"
    return "transient"


class EngineSupervisor:
    """Owns the live EngineCore and the recovery loop.  Exposes the same
    serving surface the backend drives (submit/generate/stop/stats/...);
    everything not intercepted here delegates to the live core."""

    def __init__(
        self,
        config: Optional[VGTConfig] = None,
        devices: Optional[list] = None,
    ) -> None:
        self.config = config or get_config()
        self._recovery = self.config.recovery
        # the mesh's devices (the reference's argument), for every
        # incarnation of the core
        self._devices = devices
        self._lock = threading.RLock()
        self._state = HealthState.SERVING
        self._degraded_since: Optional[float] = None
        self._time_in_degraded = 0.0
        self._restart_times: List[float] = []
        self._quarantine: set = set()
        self._suspect_counts: Dict[str, int] = {}
        self._crash_event = threading.Event()
        self._stopping = False
        self._watcher: Optional[threading.Thread] = None
        self.total_crashes = 0
        self.total_restarts = 0
        self.total_stalls = 0
        # in-flight survival accounting (recovery.resume_in_flight):
        # sequences checkpointed at a crash/stall and replayed into the
        # rebuilt core vs given up on (quarantined / max attempts /
        # resubmit failure)
        self.total_resumed = 0
        self.total_lost = 0
        # checkpointed sequences awaiting the rebuilt core; failed with
        # a terminal error if the engine lands DEAD or stop() wins
        self._pending_resume: List[Sequence] = []
        # introspection record of the most recent checkpoint/replay
        # (/stats → engine.supervisor.last_resume): counts + per-seq
        # checkpoint summaries, never token content
        self.last_resume: Optional[Dict[str, Any]] = None
        self.transitions: List[tuple] = []
        self.last_fatal: Optional[str] = None
        # silent-corruption defense (vgate_tpu/integrity.py): canary
        # keeper (pinned greedy probe; first run records, later runs
        # verify), reload accounting, and the quarantined_corrupt mark
        # — True from a corrupt-classified fatal until the post-reload
        # canary passes (readiness stays red the whole time: the state
        # machine holds RECOVERING, so no traffic reaches the suspect
        # core).
        self._integrity_cfg = self.config.integrity
        self._canary: Optional[CanaryKeeper] = (
            CanaryKeeper(self._integrity_cfg)
            if self._integrity_cfg.enabled
            and self._integrity_cfg.canary_enabled
            else None
        )
        self.quarantined_corrupt = False
        self.total_corrupt_reloads = 0
        self.total_canary_failures = 0
        self.last_integrity: Optional[Dict[str, Any]] = None
        self._next_canary_t = (
            time.monotonic() + self._integrity_cfg.canary_interval_s
            if self._canary is not None
            and self._integrity_cfg.canary_interval_s > 0
            else None
        )
        # timer probes run OFF the watcher thread (one at a time): a
        # probe blocking on a wedged core must not suspend the stall
        # watchdog, whose whole job is noticing that wedge
        self._canary_probe: Optional[threading.Thread] = None
        # flight-recorder snapshot of the most recent crash (ticks +
        # in-flight requests at the moment of death) — logged on every
        # crash classification and surfaced via /stats engine.last_crash
        self.last_crash: Optional[Dict[str, Any]] = None
        # first build: construction failures (bad config, weight-load
        # faults) propagate — there is nothing to recover *to* yet
        self.core = EngineCore(self.config, devices=devices)
        self._attach(self.core)
        self._set_state_metric(self._state)

    # ------------------------------------------------------------- lifecycle

    def start(self) -> None:
        self.core.start()
        if (
            self._canary is not None
            and self._integrity_cfg.canary_record_on_start
            and self._canary.expected is None
        ):
            # baseline the fingerprint against the KNOWN-GOOD boot
            # core (fresh from the checkpoint): every later gate then
            # VERIFIES rather than re-records — without this a reload
            # from a corrupt on-disk checkpoint would baseline garbage
            self._canary.check(self.core, context="boot")
        if self._watcher is None:
            self._watcher = threading.Thread(
                target=self._watch_loop, name="vgt-supervisor", daemon=True
            )
            self._watcher.start()

    def stop(self) -> None:
        self._stopping = True
        self._crash_event.set()
        if self._watcher is not None:
            self._watcher.join(timeout=30)
            self._watcher = None
        # checkpointed work that never reached a rebuilt core is still
        # owed an answer (core.stop() covers its own _checkpointed)
        self._fail_pending_resume(
            EngineRecoveringError(
                "engine stopped before the checkpointed request could "
                "be replayed"
            ),
            reason="shutdown",
        )
        self.core.stop()

    def close(self) -> None:
        """Stop, then stop the live core's mesh followers and groups."""
        self.stop()
        self.core.close()

    # ------------------------------------------------------------ the state

    @property
    def state(self) -> HealthState:
        """Current health state, with the lazy DEGRADED -> SERVING
        promotion: one crash-free probation window restores full
        confidence without a dedicated timer thread."""
        with self._lock:
            if (
                self._state is HealthState.DEGRADED
                and self._degraded_since is not None
                and time.monotonic() - self._degraded_since
                >= self._recovery.degraded_probation_s
            ):
                self._transition(HealthState.SERVING)
            return self._state

    def _transition(self, new: HealthState) -> None:
        with self._lock:
            old = self._state
            if old is new:
                return
            now = time.monotonic()
            if old is HealthState.DEGRADED and self._degraded_since is not None:
                dt = now - self._degraded_since
                self._time_in_degraded += dt
                metrics.TIME_IN_DEGRADED.inc(dt)
                self._degraded_since = None
            if new is HealthState.DEGRADED:
                self._degraded_since = now
            self._state = new
            self.transitions.append((old.value, new.value))
            metrics.STATE_TRANSITIONS.labels(
                from_state=old.value, to_state=new.value
            ).inc()
            self._set_state_metric(new)
        logger.warning(
            "engine health transition",
            extra={"extra_data": {"from": old.value, "to": new.value}},
        )

    @staticmethod
    def _set_state_metric(current: HealthState) -> None:
        for s in HealthState:
            metrics.HEALTH_STATE.labels(state=s.value).set(
                1.0 if s is current else 0.0
            )

    @property
    def retry_after_s(self) -> float:
        """Suggested client backoff: the next restart attempt's backoff
        (plus margin) while recovering, else the floor of 1s."""
        rec = self._recovery
        backoff = min(
            rec.backoff_cap_s,
            rec.backoff_base_s * (2 ** len(self._restart_times)),
        )
        return max(1.0, backoff)

    # ----------------------------------------------------------- recovery

    def _attach(self, core: EngineCore) -> None:
        core.on_fatal = self._on_fatal

    def _on_fatal(self, exc: BaseException) -> None:
        """Runs on the dying engine thread after the crash is contained
        (futures failed, slots cleared): flip to RECOVERING and hand off
        to the watcher thread."""
        with self._lock:
            self.total_crashes += 1
            self.last_fatal = f"{type(exc).__name__}: {exc}"
            if self._state is not HealthState.DEAD:
                self._transition(HealthState.RECOVERING)
        self._crash_event.set()

    def _watch_loop(self) -> None:
        while not self._stopping:
            fired = self._crash_event.wait(timeout=0.25)
            if self._stopping:
                return
            if not fired:
                # idle poll doubles as the hang watchdog: a wedged
                # engine (a stuck wait on the card) never raises,
                # so nothing would ever set the crash event — the
                # monitor must declare the fault itself
                self._check_stall()
                # ... and as the slow-timer canary (integrity.
                # canary_interval_s): wrong answers never raise either
                self._maybe_canary()
                continue
            self._crash_event.clear()
            if self.core._fatal is not None:
                try:
                    self._handle_crash()
                except Exception:  # pragma: no cover - defensive
                    logger.error(
                        "supervisor crash handler failed", exc_info=True
                    )
                    self._fail_pending_resume(
                        EngineDeadError(
                            "supervisor crash handler failed; "
                            "in-flight work cannot be replayed"
                        ),
                        reason="resubmit_failed",
                    )
                    self._transition(HealthState.DEAD)

    def _check_stall(self) -> None:
        """Classify the live core's heartbeat; a stale beat becomes an
        EngineStalledError declared through the core's containment, so
        the existing crash path applies: stall → checkpoint → rebuild →
        replay."""
        rec = self._recovery
        core = self.core
        if (
            rec.step_stall_s <= 0
            or core._fatal is not None
            or not core._running
        ):
            return
        verdict = classify_heartbeat(
            getattr(core, "_heartbeat", None),
            time.monotonic(),
            rec.step_stall_s,
            rec.compile_grace_s,
        )
        if verdict is None:
            return
        exc = EngineStalledError(
            "engine heartbeat stale for "
            f"{verdict['stalled_s']:.1f}s (limit "
            f"{verdict['limit_s']:.1f}s) at phase "
            f"{verdict['phase']!r}; declaring the engine wedged",
            stalled_s=verdict["stalled_s"],
            phase=verdict["phase"],
        )
        logger.error(
            "engine stall detected by watchdog",
            extra={"extra_data": verdict},
        )
        if core.declare_stalled(exc):
            self.total_stalls += 1
            metrics.ENGINE_STALLS.inc()

    def _maybe_canary(self) -> None:
        """Slow-timer canary self-probe (integrity.canary_interval_s >
        0): a pinned greedy prompt whose output fingerprint must match
        the recorded one.  A mismatch is a silent-corruption fatal —
        declared through the core's containment (like the stall
        watchdog) so the standard path applies: checkpoint → reload →
        canary → replay.  The probe itself runs on its own thread (a
        probe blocked on a wedged core must not suspend the stall
        watchdog) and only on an IDLE engine: under live traffic the
        sentinels already watch every readback, and a probe queued
        behind a loaded engine would time out and read as corruption."""
        if self._next_canary_t is None or self._canary is None:
            return
        now = time.monotonic()
        if now < self._next_canary_t:
            return
        if self._canary_probe is not None and self._canary_probe.is_alive():
            return  # previous probe still in flight
        self._next_canary_t = now + self._integrity_cfg.canary_interval_s
        if self.state not in (HealthState.SERVING, HealthState.DEGRADED):
            return
        core = self.core
        if core._fatal is not None or not core._running:
            return
        try:
            if core.scheduler.has_work():
                return  # busy: re-probe at the next interval
        except Exception:  # pragma: no cover - mid-rebuild
            return
        self._canary_probe = threading.Thread(
            target=self._run_timer_canary,
            args=(core,),
            name="vgt-canary",
            daemon=True,
        )
        self._canary_probe.start()

    def _run_timer_canary(self, core: EngineCore) -> None:
        result = self._canary.check(core, context="timer")
        self.last_integrity = {"canary": result}
        if result["ok"]:
            return
        self.total_canary_failures += 1
        exc = IntegrityError(
            "slow-timer canary self-probe failed: "
            + str(result.get("error") or "fingerprint mismatch"),
            kind="canary",
            detail={
                k: v for k, v in result.items() if k != "ok"
            },
        )
        core.declare_stalled(exc)

    def _fail_pending_resume(
        self, exc: BaseException, reason: str
    ) -> None:
        with self._lock:
            pending, self._pending_resume = self._pending_resume, []
        for seq in pending:
            self.total_lost += 1
            metrics.LOST_SEQUENCES.labels(reason=reason).inc()
            seq.fail(exc)

    def _sleep(self, seconds: float) -> None:
        deadline = time.monotonic() + seconds
        while not self._stopping and time.monotonic() < deadline:
            time.sleep(min(0.05, deadline - time.monotonic()))

    def _update_quarantine(self, exc: BaseException, kind: str) -> None:
        with self._lock:
            self._update_quarantine_locked(exc, kind)

    def _update_quarantine_locked(
        self, exc: BaseException, kind: str
    ) -> None:
        # (fingerprint, resume_count) pairs of the residents at death
        suspects = list(self.core._fatal_suspects)
        if kind == "poison":
            # the fault names its victim; fall back to every resident
            # request when it doesn't
            named = getattr(exc, "fingerprint", None)
            for fp in [named] if named else [s[0] for s in suspects]:
                if fp and fp not in self._quarantine:
                    self._quarantine.add(fp)
                    metrics.QUARANTINED_REQUESTS.inc()
                    logger.error(
                        "request quarantined as engine poison",
                        extra={"extra_data": {"fingerprint": fp}},
                    )
            return
        if kind == "corrupt":
            # checksum/canary corruption is the HARDWARE's fault, never
            # the residents': counting those toward a poison streak
            # would quarantine innocent traffic for a flipped bit.  But
            # a SENTINEL trip names the sequences whose logit rows went
            # bad — a prompt that deterministically overflows into NaN
            # logits would otherwise drive an unbounded reload loop
            # (sentinel → reload → client retries → sentinel ...), so
            # the ATTRIBUTED fingerprints run the same repeat-offender
            # streak as transient crashes below.
            attributed = {
                s.get("fingerprint")
                for s in getattr(exc, "sequences", ())
                if s.get("fingerprint")
            }
            if not attributed:
                return
            suspects = [
                (fp, rc) for fp, rc in suspects if fp in attributed
            ]
        elif kind != "transient":
            return
        # transient path: count repeat offenders — a request FRESHLY
        # SUBMITTED into `poison_threshold` consecutive crashes is
        # quarantined.  Only fresh submissions (resume_count == 0)
        # increment the streak: the signal is CLIENT persistence (keep
        # resubmitting the prompt that kills the engine), and with
        # resume_in_flight the engine's own replays put every innocent
        # bystander in flight across consecutive crashes by design —
        # counting those would quarantine all traffic after any two
        # rapid crashes.  A replayed sequence still KEEPS its streak
        # (presence in this crash, no reset); the engine's
        # max_resume_attempts bounds its replays, and the client's
        # retry after that typed 503 is exactly the fresh submission
        # that advances the streak.
        new_counts: Dict[str, int] = {}
        for fp, resume_count in suspects:
            prior = self._suspect_counts.get(fp, 0)
            count = prior + (1 if resume_count == 0 else 0)
            if count >= self._recovery.poison_threshold:
                if fp not in self._quarantine:
                    self._quarantine.add(fp)
                    metrics.QUARANTINED_REQUESTS.inc()
                    logger.error(
                        "repeat-offender request quarantined",
                        extra={
                            "extra_data": {
                                "fingerprint": fp, "crashes": count,
                            }
                        },
                    )
            elif count > 0:
                new_counts[fp] = count
        # requests NOT in this crash reset their streak (consecutive
        # involvement is the poison signal, not lifetime involvement)
        self._suspect_counts = new_counts

    def _handle_crash(self) -> None:
        exc = self.core._fatal
        assert exc is not None
        kind = classify_fatal(exc)
        metrics.ENGINE_CRASHES.labels(kind=kind).inc()
        logger.error(
            "engine crashed; supervisor recovering",
            extra={
                "extra_data": {
                    "kind": kind, "error": f"{type(exc).__name__}: {exc}",
                }
            },
        )
        # post-mortem: dump the dead core's flight recorder (its final
        # tick is the faulting dispatch) as one structured log record,
        # and keep it for /stats → engine.last_crash — the rings
        # themselves die with the core at rebuild
        flight = getattr(self.core, "flight", None)
        if flight is not None:
            # prefer the snapshot the dying engine thread took before
            # containment swept its residents; fall back to a fresh one
            # (still carries the ticks) for cores that died another way
            snapshot = (
                getattr(self.core, "_crash_snapshot", None)
                or flight.crash_snapshot(exc)
            )
            snapshot["classification"] = kind
            self.last_crash = snapshot
            logger.error(
                "engine crash flight-recorder snapshot",
                extra={"extra_data": {"flight": snapshot}},
            )
        # claim the checkpointed in-flight sequences BEFORE the rebuild
        # loop (the old core's stop() would otherwise fail them) and
        # record the snapshot for /stats — counts and token counts only
        with self._lock:
            self._pending_resume.extend(self.core.take_checkpointed())
            # containment may have given up on sequences itself
            # (max_resume_attempts): fold those into the lost total
            self.total_lost += self.core.take_resume_losses()
            if self._pending_resume:
                self.last_resume = {
                    "time": time.time(),
                    "cause": f"{type(exc).__name__}: {exc}",
                    "checkpointed": len(self._pending_resume),
                    "sequences": [
                        s.checkpoint_summary()
                        for s in self._pending_resume
                    ],
                }
        self._update_quarantine(exc, kind)
        if kind == "unrecoverable":
            self._fail_pending_resume(
                EngineDeadError(
                    "engine hit an unrecoverable fault; checkpointed "
                    "in-flight work cannot be replayed"
                ),
                reason="resubmit_failed",
            )
            self._transition(HealthState.DEAD)
            return
        # reload-on-corrupt: a corrupt-classified fatal (sentinel trip,
        # checksum mismatch, canary failure) must NOT keep the old tree
        # — the corruption would ride the weights-kept path into every
        # incarnation.  The replica is marked quarantined_corrupt until
        # its post-reload canary passes; the state machine already
        # holds RECOVERING (readiness red), so no traffic can land on
        # the suspect core meanwhile.
        # (integrity disabled ⇒ corrupt classification is inert and the
        # weights-kept path applies, preserving pre-integrity behavior)
        reload_weights = (
            kind == "corrupt" and self._integrity_cfg.enabled
        )
        if reload_weights:
            self.quarantined_corrupt = True
            metrics.CORRUPT_QUARANTINED.set(1)
            self.last_integrity = {
                "cause": f"{type(exc).__name__}: {exc}",
                "kind": getattr(exc, "integrity_kind", "unknown"),
                "sequences": list(getattr(exc, "sequences", ())),
                "detail": dict(getattr(exc, "detail", {})),
                "time": time.time(),
            }
        rec = self._recovery
        while not self._stopping:
            now = time.monotonic()
            with self._lock:
                self._restart_times = [
                    t for t in self._restart_times
                    if now - t < rec.restart_window_s
                ]
            if len(self._restart_times) >= rec.max_restarts:
                logger.error(
                    "restart budget exhausted; engine is DEAD",
                    extra={
                        "extra_data": {
                            "max_restarts": rec.max_restarts,
                            "window_s": rec.restart_window_s,
                        }
                    },
                )
                self._fail_pending_resume(
                    EngineDeadError(
                        "engine restart budget exhausted; checkpointed "
                        "in-flight work cannot be replayed"
                    ),
                    reason="resubmit_failed",
                )
                self._transition(HealthState.DEAD)
                return
            backoff = min(
                rec.backoff_cap_s,
                rec.backoff_base_s * (2 ** len(self._restart_times)),
            )
            self._sleep(backoff)
            if self._stopping:
                return
            with self._lock:
                self._restart_times.append(time.monotonic())
            try:
                # shared teardown/rebuild sequence (engine_core.
                # rebuild_core): stop, free the dead incarnation's
                # device KV pool before the new one sizes, weights
                # kept (checksum-verified first) or RELOADED for
                # corrupt fatals, brownout spec-suspension carried over
                new_core = rebuild_core(
                    self.core, self.config, self._devices,
                    reload_weights=reload_weights,
                )
            except IntegrityError:
                # the kept tree failed its rebuild-time checksum
                # verification: the crash itself was a symptom of the
                # corruption — escalate this recovery to a full reload
                logger.error(
                    "kept-weights rebuild failed checksum "
                    "verification; escalating to weight reload",
                    exc_info=True,
                )
                self.quarantined_corrupt = True
                metrics.CORRUPT_QUARANTINED.set(1)
                reload_weights = True
                continue  # burns budget via _restart_times; retry
            except Exception:
                logger.error(
                    "engine rebuild attempt failed", exc_info=True
                )
                continue  # burns budget via _restart_times; retry
            self._attach(new_core)
            self.core = new_core
            if self._stopping:
                # stop() raced the rebuild (its join timed out while we
                # were constructing): never start an engine nothing owns
                # (stop() fails the pending-resume sequences)
                new_core.stop()
                return
            if reload_weights:
                # counted per reload REBUILD (not per canary verdict)
                # so health integrity.corrupt_reloads tracks the
                # vgt_corrupt_reloads Prometheus counter exactly
                self.total_corrupt_reloads += 1
            if reload_weights and self._canary is not None:
                # the reloaded core must prove itself BEFORE any work
                # (replays included) lands on it: start, probe, and
                # only a matching canary fingerprint lifts the
                # quarantine.  A failing canary tears this incarnation
                # down and retries the reload — bounded by the same
                # restart budget as any other rebuild.
                new_core.start()
                result = self._canary.check(new_core, context="reload")
                self.last_integrity = dict(
                    self.last_integrity or {}, canary=result
                )
                if not result["ok"]:
                    self.total_canary_failures += 1
                    logger.error(
                        "post-reload canary FAILED; tearing the "
                        "incarnation down and retrying the reload",
                        extra={"extra_data": result},
                    )
                    new_core.stop()
                    continue
                self.quarantined_corrupt = False
                metrics.CORRUPT_QUARANTINED.set(0)
                self._replay(new_core)
            else:
                if reload_weights:
                    # canary disabled: trust the fresh load
                    self.quarantined_corrupt = False
                    metrics.CORRUPT_QUARANTINED.set(0)
                # replay checkpointed in-flight work into the rebuilt
                # core BEFORE it starts: the first tick then admits the
                # replays ahead of (racing) fresh client traffic
                self._replay(new_core)
                new_core.start()
            self.total_restarts += 1
            metrics.ENGINE_RESTARTS.inc()
            self._transition(HealthState.DEGRADED)
            logger.warning(
                "engine restarted",
                extra={
                    "extra_data": {
                        "restarts": self.total_restarts,
                        "backoff_s": backoff,
                        **(
                            {"weights_reloaded": True}
                            if reload_weights
                            else {}
                        ),
                    }
                },
            )
            return

    def _replay(self, core: Any) -> None:
        """Re-submit the checkpointed in-flight sequences into a rebuilt
        core as prefill-continues (prepare_resume already folded each
        partial generation into its prompt).  Quarantined fingerprints
        are excluded — a poison request must not ride the replay path
        back into the engine it keeps crashing; deadlines stay anchored
        (absolute deadline_t survives the checkpoint), so a blown
        budget sheds with the normal 504 + partials on the new core.
        ``core`` only needs submit_existing + flight, so tests drive
        this with fakes."""
        with self._lock:
            pending, self._pending_resume = self._pending_resume, []
        replayed = 0
        for seq in pending:
            outcome = replay_into(
                core, seq, self._quarantine,
                retry_after=self.retry_after_s,
            )
            if outcome == "replayed":
                replayed += 1
                self.total_resumed += 1
            else:
                self.total_lost += 1
        if self.last_resume is not None:
            self.last_resume["replayed"] = replayed
        if pending:
            logger.warning(
                "replayed checkpointed in-flight work into rebuilt "
                "engine",
                extra={
                    "extra_data": {
                        "checkpointed": len(pending),
                        "replayed": replayed,
                    }
                },
            )

    # ----------------------------------------------------------- submission

    def _gate(self, prompt_ids: List[int]) -> None:
        raise_for_state(
            self.state.value,
            retry_after=self.retry_after_s,
            detail=self.last_fatal,
        )
        if not self._quarantine:
            return  # steady state: skip the O(prompt) fingerprint
        fp = faults.fingerprint(prompt_ids)
        if fp in self._quarantine:
            raise PoisonRequestError(
                f"request {fp} is quarantined: it was in flight across "
                "repeated engine crashes (or was named by a poison "
                "fault) and will not be admitted again"
            )

    def evacuate(self, *args: Any, **kwargs: Any) -> None:
        """Refused, deliberately: a supervised one-device deployment has
        no in-process replica to replay the checkpoints into.  Use the
        SIGTERM graceful drain for single-replica rollouts; live
        migration needs data parallelism (not ported)."""
        raise MigrationRefusedError(
            "dp=1 deployment has no migration target; use the SIGTERM "
            "graceful drain for rollouts (live migration requires "
            "device.dp > 1, not ported)"
        )

    def submit_tokens(
        self,
        prompt_ids: List[int],
        params: SamplingParams,
        stream_cb: Optional[Callable[[int], Any]] = None,
        meta: Optional[Any] = None,
    ) -> Sequence:
        self._gate(list(prompt_ids))
        try:
            return self.core.submit_tokens(
                prompt_ids, params, stream_cb, meta=meta
            )
        except EngineRecoveringError:
            raise
        except RuntimeError as exc:
            if self.core._fatal is not None:
                # crashed between the gate and the submit
                raise EngineRecoveringError(
                    "engine crashed during submission; retry shortly",
                    retry_after=self.retry_after_s,
                ) from exc
            raise

    def submit_prompt(
        self,
        prompt: str,
        params: SamplingParams,
        stream_cb: Optional[Callable[[int], Any]] = None,
        meta: Optional[Any] = None,
    ) -> Sequence:
        return self.submit_tokens(
            self.core.encode_prompt(prompt), params, stream_cb, meta=meta
        )

    def generate(
        self, prompts: Seq[str], params: Seq[SamplingParams]
    ) -> List[Dict[str, Any]]:
        """Blocking batch API (mirrors EngineCore.generate) routed through
        the supervisor's gate so quarantine/health checks apply.  The
        batch is queued under the live core's submit lock, so it is
        admitted as one wave, as ``EngineCore.generate`` admits it."""
        with self.core._submit_lock:
            seqs = [
                self.submit_prompt(p, sp)
                for p, sp in zip(prompts, params)
            ]
        # the live core at each result: a rebuild may have replaced it
        return [self.core.result_dict(seq) for seq in seqs]

    # -------------------------------------------------------- introspection

    def health(self) -> Dict[str, Any]:
        """The health block /health and /stats surface: state machine
        position, restart accounting, quarantine size, queue depth."""
        state = self.state
        try:
            sched = self.core.scheduler.get_stats()
            queue_depth = sched["waiting"]
            running = sched["running"]
        except Exception:  # mid-rebuild: scheduler may not exist yet
            queue_depth = 0
            running = 0
        degraded_s = self._time_in_degraded
        if self._degraded_since is not None:
            degraded_s += time.monotonic() - self._degraded_since
        out = {
            "state": state.value,
            "alive": state_is_alive(state.value),
            "ready": state_is_ready(state.value),
            "crashes": self.total_crashes,
            "restarts": self.total_restarts,
            # satellite fix: operators could not see how close a
            # replica was to DEAD
            "restarts_remaining": restart_budget_remaining(
                self._restart_times, self._recovery
            ),
            "stalls": self.total_stalls,
            "resumed": self.total_resumed,
            "lost": self.total_lost,
            "quarantined": len(self._quarantine),
            "queue_depth": queue_depth,
            "running": running,
            "time_in_degraded_s": round(degraded_s, 3),
            "last_fatal": self.last_fatal,
            "transitions": list(self.transitions[-8:]),
        }
        if self._integrity_cfg.enabled:
            out["integrity"] = {
                "quarantined_corrupt": self.quarantined_corrupt,
                "corrupt_reloads": self.total_corrupt_reloads,
                "canary_failures": self.total_canary_failures,
                **(
                    {"canary": self._canary.stats()}
                    if self._canary is not None
                    else {}
                ),
                "last": self.last_integrity,
            }
        return out

    def device_health(self) -> Dict[str, Any]:
        if self.state is HealthState.DEAD:
            return {"alive": False, "state": "dead", "error": self.last_fatal}
        out = self.core.device_health()
        out["state"] = self.state.value
        return out

    def get_stats(self) -> Dict[str, Any]:
        try:
            stats = self.core.get_stats()
        except Exception:  # mid-rebuild
            stats = {}
        stats["supervisor"] = self.health()
        # always present (None until a crash happens) so operators can
        # discover the fields without inducing one; docs/operations.md
        stats["last_crash"] = self.last_crash
        stats["last_resume"] = self.last_resume
        armed = faults.snapshot()
        if armed:
            stats["faults_armed"] = armed
        return stats

    def __getattr__(self, name: str) -> Any:
        # serving surface not intercepted above (tokenizer, spec,
        # geometry, warmup, final_text, logprob_entries, ...) delegates
        # to the live core.  __getattr__ only fires for attributes not
        # found on the supervisor itself; guard against recursion while
        # __init__ is still building the first core.
        core = self.__dict__.get("core")
        if core is None:
            raise AttributeError(name)
        return getattr(core, name)
