"""Per-request sequence state tracked by the continuous-batching scheduler."""

from __future__ import annotations

import enum
import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional

from vgate_tpu_torch.backends.base import SamplingParams

_seq_counter = itertools.count()


class SeqStatus(enum.Enum):
    WAITING = "waiting"
    RUNNING = "running"
    FINISHED = "finished"
    FAILED = "failed"


@dataclass
class Sequence:
    prompt_ids: List[int]
    params: SamplingParams
    seq_id: int = field(default_factory=lambda: next(_seq_counter))
    status: SeqStatus = SeqStatus.WAITING
    # tokens generated since the last (re-)prefill — the decode feed
    output_ids: List[int] = field(default_factory=list)
    # every token ever generated, surviving preemption/recompute — the result
    generated_ids: List[int] = field(default_factory=list)
    pages: List[int] = field(default_factory=list)
    slot: Optional[int] = None
    finish_reason: str = "stop"
    error: Optional[BaseException] = None
    # timing
    arrival_t: float = field(default_factory=time.perf_counter)
    first_token_t: Optional[float] = None
    finish_t: Optional[float] = None
    # delivery
    done_event: threading.Event = field(default_factory=threading.Event)
    stream_cb: Optional[Callable[[int], Any]] = None
    preempt_count: int = 0
    orig_prompt_len: int = 0
    # set when a stop string matched: the final text truncated at the match
    # (the raw generated_ids still contain the overshoot tokens)
    text_override: Optional[str] = None
    # per-delivered-token logprob data, aligned with generated_ids (only
    # filled when params.logprobs): (chosen_lp, [(token_id, lp), ...])
    logprob_data: List[tuple] = field(default_factory=list)
    # client-side cancellation (e.g. SSE disconnect): set from ANY
    # thread; the engine thread honors it at its next tick, finishing
    # the sequence with reason "abort" and freeing its slot/pages —
    # the capability vLLM exposes as abort_request, first-party here
    abort_requested: bool = False
    # why the abort was requested — labels the cancellation metric
    # (client_disconnect | drain)
    abort_reason: str = "client_disconnect"
    # absolute perf_counter deadline (arrival_t + params.timeout_s);
    # the engine sheds the sequence between decode ticks once passed
    deadline_t: Optional[float] = None
    # observability identity (observability/reqtrace.py): the gateway's
    # request id, and the per-request phase-span emitter — both optional
    # so direct engine callers (tests, bench drivers) pay nothing
    request_id: Optional[str] = None
    trace: Optional[Any] = None
    # the gateway's RequestMeta (observability/reqtrace.py), kept for
    # the phase spans the flight recorder will parent on it
    meta: Optional[Any] = None
    # settle observer, invoked exactly once from finish()/fail() — the
    # engine's flight recorder closes the request record here so every
    # settle path (scheduler sheds included) is covered by one hook
    on_settle: Optional[Callable[["Sequence"], Any]] = None
    _settle_notified: bool = False
    # engine restarts this sequence was checkpointed across and replayed
    # into the rebuilt core (crash, poison sweep, or watchdog stall).
    # recovery.max_resume_attempts caps it; >0 marks the final result
    # `resumed` so clients can see the latency blip's cause.
    resume_count: int = 0
    # PLANNED movements (replica drain, hot-replica rebalance, dp
    # scale-down) this sequence rode — the operational twin of
    # resume_count, counted separately because a migration is not a
    # failure: it never spends the crash-resume budget
    # (recovery.max_resume_attempts) and surfaces as `migrated`, not
    # `resumed`, on the final result.
    migrate_count: int = 0
    # KV storage format the generated prefix was sampled under, stamped
    # by fatal containment when the sequence is checkpointed (engine
    # geometry.kv_dtype — "bf16"/"f32"/"int8").  submit_existing on the
    # replay target refuses a mismatch: continuing an int8-sampled
    # prefix against a bf16 pool (or vice versa) would splice two
    # numerically different streams mid-generation.
    kv_dtype: Optional[str] = None
    # times this sequence's KV was parked in the host swap pool at
    # preemption (runtime/kv_swap.py) instead of being recomputed —
    # the operational twin of preempt_count for the swap tier.  The
    # live ticket itself rides on the private `_swap_ticket` attribute
    # (manager-owned; validity is epoch-guarded by preempt_count).
    swap_count: int = 0
    # Disaggregated prefill→decode handoff (pod.roles; runtime/
    # handoff.py).  handoff_requested is the submit-time wire flag: the
    # engine stages the sequence's KV for transfer once the first token
    # exists (then clears the flag).  handoff_count is bumped by the
    # GATEWAY when a decode worker accepts the transfer; >0 surfaces as
    # `disaggregated` on the final result.  The engine-side hold marker
    # rides on the private `_handoff_hold` attribute (scheduler-owned).
    handoff_requested: bool = False
    handoff_count: int = 0
    # integrity canary self-probe (vgate_tpu_torch/integrity.py): ranks ahead
    # of client traffic at admission (a probe stuck behind a deep queue
    # can't verify anything in time) and is NEVER checkpointed/replayed
    # or counted as a poison suspect — a canary in flight across a
    # crash is simply failed; its keeper re-probes the rebuilt core.
    canary: bool = False

    def __post_init__(self) -> None:
        if self.orig_prompt_len == 0:
            self.orig_prompt_len = len(self.prompt_ids)
        if self.deadline_t is None and self.params.timeout_s is not None:
            self.deadline_t = self.arrival_t + self.params.timeout_s

    def past_deadline(self, now: Optional[float] = None) -> bool:
        if self.deadline_t is None:
            return False
        return (now if now is not None else time.perf_counter()) >= (
            self.deadline_t
        )

    @property
    def num_prompt_tokens(self) -> int:
        return len(self.prompt_ids)

    @property
    def num_output_tokens(self) -> int:
        return len(self.generated_ids)

    @property
    def total_len(self) -> int:
        """Tokens whose KV is (or will be) resident."""
        return len(self.prompt_ids) + len(self.output_ids)

    @property
    def num_generated(self) -> int:
        """Generated tokens across preemptions (output_ids may have been
        folded into prompt_ids by reset_for_recompute)."""
        return len(self.generated_ids)

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_t is None:
            return None
        return self.first_token_t - self.arrival_t

    @property
    def tpot(self) -> Optional[float]:
        if self.finish_t is None or self.first_token_t is None:
            return None
        n = max(1, self.num_output_tokens - 1)
        return (self.finish_t - self.first_token_t) / n

    def append_token(self, token: int) -> None:
        if self.first_token_t is None:
            self.first_token_t = time.perf_counter()
        self.output_ids.append(token)
        self.generated_ids.append(token)
        if self.stream_cb is not None:
            self.stream_cb(token)

    def request_abort(self, reason: str = "client_disconnect") -> None:
        """Ask the engine to drop this sequence (thread-safe, advisory:
        tokens already in flight may still append before the engine
        processes the abort).  ``reason`` labels the cancellation
        metric: "client_disconnect" (the default) or "drain"."""
        self.abort_reason = reason
        self.abort_requested = True

    def _notify_settle(self) -> None:
        if self._settle_notified or self.on_settle is None:
            return
        self._settle_notified = True
        # the observer is the engine's bound method: a settled sequence a
        # caller keeps must not keep that engine (and its KV pool) alive
        hook, self.on_settle = self.on_settle, None
        try:
            hook(self)
        except Exception:
            pass  # observability must never break delivery

    def finish(self, reason: str) -> None:
        self.status = SeqStatus.FINISHED
        self.finish_reason = reason
        self.finish_t = time.perf_counter()
        self._notify_settle()
        self.done_event.set()

    def fail(self, exc: BaseException) -> None:
        self.status = SeqStatus.FAILED
        self.error = exc
        self.finish_t = time.perf_counter()
        self._notify_settle()
        self.done_event.set()

    def reset_for_recompute(self) -> None:
        """Preemption: drop residency, keep generated tokens in the prompt so
        decode resumes exactly where it stopped after re-prefill."""
        self.prompt_ids = self.prompt_ids + self.output_ids
        self.output_ids = []
        self.pages = []
        self.slot = None
        self.status = SeqStatus.WAITING
        self.preempt_count += 1

    def reset_for_swap(self) -> None:
        """Preemption with the KV parked in the host swap pool
        (runtime/kv_swap.py): drop residency but keep the prompt/output
        split intact — re-admission scatters the saved pages back and
        decode resumes at the same position with ZERO recompute.  The
        preempt_count bump is still the staleness epoch: in-flight
        chunk readbacks discard this sequence's late tokens, and the
        swap ticket (stamped with the post-bump epoch) goes stale if
        anything else folds the sequence before re-admission."""
        self.pages = []
        self.slot = None
        self.status = SeqStatus.WAITING
        self.preempt_count += 1

    def checkpoint_summary(self) -> dict:
        """The loggable fields of :meth:`checkpoint` WITHOUT
        materializing the token-list copies — containment-path
        introspection (supervisor last_resume) runs exactly when the
        process may be dying of memory pressure, and only ever reads
        counts.  Must mirror SequenceCheckpoint.as_dict (pinned by
        tests/test_resume.py)."""
        return {
            "seq_id": self.seq_id,
            "request_id": self.request_id,
            "trace_id": getattr(self.trace, "trace_id", None),
            "prompt_tokens": self.orig_prompt_len,
            "generated_tokens": len(self.generated_ids),
            "resume_count": self.resume_count,
            "migrate_count": self.migrate_count,
            "swap_count": self.swap_count,
            "deadline_t": self.deadline_t,
            "kv_dtype": self.kv_dtype,
        }

    def resume_metrics(self) -> dict:
        """The `resumed`/`migrated` entries for a result's metrics dict
        (empty when the generation rode neither a restart nor a planned
        migration) — one definition for every result-assembly site
        (engine, supervisor, dp router, backend); the batcher lifts
        them to the response's `resumed`/`migrated` flags."""
        out: dict = {}
        if self.resume_count:
            out["resumed"] = float(self.resume_count)
        if self.migrate_count:
            out["migrated"] = float(self.migrate_count)
        if self.handoff_count:
            out["disaggregated"] = float(self.handoff_count)
        return out

    def checkpoint(self) -> "SequenceCheckpoint":
        """Snapshot this sequence's resumable state (engine crash/stall
        containment).  Pure data — safe to log, introspect via /stats,
        or rebuild a sequence from (:meth:`Sequence.from_checkpoint`)."""
        return SequenceCheckpoint(
            prompt_ids=list(self.prompt_ids[: self.orig_prompt_len]),
            generated_ids=list(self.generated_ids),
            params=self.params,
            seq_id=self.seq_id,
            arrival_t=self.arrival_t,
            deadline_t=self.deadline_t,
            first_token_t=self.first_token_t,
            preempt_count=self.preempt_count,
            resume_count=self.resume_count,
            migrate_count=self.migrate_count,
            swap_count=self.swap_count,
            request_id=self.request_id,
            trace_id=getattr(self.trace, "trace_id", None),
            kv_dtype=self.kv_dtype,
        )

    @classmethod
    def from_checkpoint(cls, cp: "SequenceCheckpoint") -> "Sequence":
        """Rebuild a WAITING prefill-continue sequence from a checkpoint:
        the partial generation folds into the prompt (exactly like
        preemption's recompute), so after re-prefill decode resumes at
        the next position.  Delivery plumbing (done_event, stream_cb,
        on_settle) is fresh — the live replay path mutates the original
        object via :meth:`prepare_resume` instead, so the client keeps
        its future; this constructor serves tests and any out-of-process
        resume."""
        seq = cls(
            prompt_ids=list(cp.prompt_ids) + list(cp.generated_ids),
            params=cp.params,
            seq_id=cp.seq_id,
            generated_ids=list(cp.generated_ids),
            arrival_t=cp.arrival_t,
            first_token_t=cp.first_token_t,
            orig_prompt_len=len(cp.prompt_ids),
            preempt_count=cp.preempt_count,
            resume_count=cp.resume_count + 1,
            migrate_count=cp.migrate_count,
            swap_count=cp.swap_count,
            request_id=cp.request_id,
            kv_dtype=cp.kv_dtype,
        )
        # absolute deadline survives verbatim: the replay runs on the
        # request's ORIGINAL budget, not a fresh one
        seq.deadline_t = cp.deadline_t
        return seq

    def _fold_for_replay(self) -> None:
        """Shared checkpoint fold behind :meth:`prepare_resume` (crash/
        stall containment) and :meth:`prepare_migrate` (planned
        movement): fold the generation into the prompt
        (prefill-continue) and return to WAITING so the replayer can
        re-submit this very object — every external reference
        (done_event waiter, stream_cb, cancel-token abort hooks,
        deadline) stays valid.  The preempt_count bump doubles as the
        staleness epoch: an engine thread with this sequence still in
        flight discards its late readbacks against it."""
        # a handoff hold does not survive a fold: the staged ticket is
        # invalidated by the epoch bump below, and a replayed sequence
        # still marked held would be skipped by admission forever
        if getattr(self, "_handoff_hold", False):
            self._handoff_hold = False
        self.handoff_requested = False
        # the radix-tree path locks and probe memo belong to the source
        # core's tree: a crash fold never unlocks them there (the core is
        # dying), and the replay target's scheduler must not unlock them
        # as its own (its evictable count would grow by pages it does not
        # hold).  A planned fold released them with the residency first.
        self._radix_match = None
        self._radix_insert_node = None
        self._radix_probe_cache = None
        if self.status is SeqStatus.RUNNING or self.output_ids:
            self.reset_for_recompute()
        else:
            # never admitted (or already folded by preemption): nothing
            # resident to fold — just make the queue state explicit
            self.pages = []
            self.slot = None
            self.status = SeqStatus.WAITING

    def prepare_resume(self) -> None:
        """Engine crash/stall checkpoint, live-object form (see
        :meth:`_fold_for_replay`); counts against
        recovery.max_resume_attempts and marks the result `resumed`."""
        self._fold_for_replay()
        self.resume_count += 1

    def prepare_migrate(self) -> None:
        """PLANNED checkpoint (replica drain / rebalance / scale-down),
        live-object form (see :meth:`_fold_for_replay`).  Deliberately
        does NOT touch resume_count: a migration is an operational
        choice, not a crash, so it must never spend the request's
        crash-resume budget — the result is marked `migrated` instead."""
        self._fold_for_replay()
        self.migrate_count += 1


@dataclass
class SequenceCheckpoint:
    """One in-flight sequence's resumable state, snapshotted by fatal
    containment (crash, poison sweep, watchdog stall) before the engine
    is torn down.  RNG continuation is implicit: sampling derives from
    ``(seed, step=num_generated)`` for seeded requests and the engine
    base key is config-derived, so a restored greedy or seeded sequence
    continues the identical token stream; unseeded temperature>0
    requests resume distribution-correct (not token-identical), exactly
    like a KV-pressure preemption."""

    prompt_ids: List[int]  # the ORIGINAL prompt (pre-fold)
    generated_ids: List[int]  # everything generated so far
    params: SamplingParams
    seq_id: int
    arrival_t: float
    deadline_t: Optional[float]  # absolute: the original budget
    first_token_t: Optional[float]
    preempt_count: int
    resume_count: int
    request_id: Optional[str]
    trace_id: Optional[str]
    # KV storage format the generation ran under (engine
    # geometry.kv_dtype); a replay target with a different format must
    # refuse the checkpoint instead of splicing numerics
    kv_dtype: Optional[str] = None
    # planned movements ridden so far (drain/rebalance/scale-down)
    migrate_count: int = 0
    # host-swap preemptions ridden so far (runtime/kv_swap.py); the
    # parked KV itself never travels in a checkpoint — containment
    # folds a swapped sequence back to the recompute path
    swap_count: int = 0

    def as_dict(self) -> dict:
        """Loggable summary (token *counts*, never token content — the
        prompt may be sensitive; observability.redact_prompts applies
        to previews elsewhere)."""
        return {
            "seq_id": self.seq_id,
            "request_id": self.request_id,
            "trace_id": self.trace_id,
            "prompt_tokens": len(self.prompt_ids),
            "generated_tokens": len(self.generated_ids),
            "resume_count": self.resume_count,
            "migrate_count": self.migrate_count,
            "swap_count": self.swap_count,
            "deadline_t": self.deadline_t,
            "kv_dtype": self.kv_dtype,
        }
