"""Engine worker process — one engine behind a frame-protocol socket.

``python -m vgate_tpu_torch.runtime.worker`` is the process the
gateway's PodEngine (runtime/pod_engine.py) spawns per worker slot when
``pod.workers > 0``: it builds the SAME engine stack the in-process
path builds (EngineCore, wrapped in EngineSupervisor + stall watchdog
when ``recovery.enabled``) on the engine's device, binds a unix-domain
or localhost-TCP listener, and serves the length-prefixed JSON frame
protocol (runtime/rpc.py) to exactly one gateway connection.  Several
workers may share one card, each in its own CUDA context: the pod
writes each one's share of the card into ``device.kv_budget_bytes``, so
no pool is sized from the memory that happens to be free at boot.  A
worker runs the kernels or fails its boot: there is no plain fallback
on the card (its canary gate runs them before it is routed to).  It
imports nothing of the HTTP layer.

Process-level contracts:

* **Fencing epoch** — the gateway assigns each worker *incarnation* a
  monotonically-increasing epoch (``--epoch``).  Every frame this
  process sends is stamped with it, and every inbound request frame is
  checked against it: a stale RPC (addressed to a previous incarnation
  of this slot) is answered with a typed ``WorkerFencedError`` reply
  and never touches the engine — the supervisor's stale-wake epoch guard,
  cross-process.
* **One connection, then exit (or orphan mode)** — the gateway owns
  the worker's lifecycle.  When the gateway connection reaches EOF
  (gateway died or declared this worker lost and moved on) and
  ``pod.orphan_grace_s`` is 0 (the default), the worker drains and
  exits rather than lingering as an unsupervised orphan; a respawn is
  always a fresh process with a fresh epoch.  With a grace > 0 the
  worker instead enters an explicit ORPHANED state: in-flight decodes
  run to completion (their token/done/err frames buffered, bounded,
  for ordered replay), new submits are refused with the typed
  retryable ``WorkerOrphanedError``, the registry record under the
  pod's socket dir keeps a liveness beat, and a successor gateway may
  re-accept the listener and take the incarnation over with the
  ``adopt`` verb (a bumped fencing epoch — stale successors are
  fenced).  Only when the grace expires does the worker self-terminate
  through the same drain fold as SIGTERM.
* **SIGTERM drain** — evacuate resident sequences (the planned
  checkpoint fold), ship their checkpoints to the gateway in an
  ``evacuated`` notification, stop the engine, exit 0.
* **Engine thread never blocks on the network** — token/done/err
  frames are enqueued to a dedicated sender thread; a slow or dead
  gateway costs queue memory, never a stalled decode tick.

Wire protocol (all frames carry the fencing epoch ``"e"``):

* request:      ``{"op": <verb>, "id": n, "e": E, ...}`` → one reply
  ``{"op": "reply", "id": n, "e": E, "ok": bool, "data"|"error": ...}``
* notification (no ``"id"``, no reply): gateway→worker ``abort``,
  ``set_spec_suspended``, ``set_prefix_insert_suspended``;
  worker→gateway ``tok`` / ``done`` / ``err`` (keyed by the gateway's
  ``sid``) and ``evacuated``.
"""

from __future__ import annotations

import argparse
import base64
import binascii
import json
import logging
import os
import queue
import signal
import socket
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Set

from vgate_tpu_torch import faults, tracing
from vgate_tpu_torch.backends.base import SamplingParams
from vgate_tpu_torch.config import VGTConfig, config_from_dict, set_config
from vgate_tpu_torch.errors import (
    HandoffStaleError,
    HandoffTransferError,
    WorkerFencedError,
    WorkerOrphanedError,
    state_is_alive,
    state_is_ready,
)
from vgate_tpu_torch.logging_config import bound_request
from vgate_tpu_torch.observability.reqtrace import RequestMeta, RequestTrace
from vgate_tpu_torch.runtime import handoff as handoff_mod
from vgate_tpu_torch.runtime import rpc
from vgate_tpu_torch.runtime.sequence import Sequence, SeqStatus

logger = logging.getLogger(__name__)

# In-memory span recorder installed when the worker starts with
# VGT_MEMTRACE=1 (drills/tests): the ``spans`` verb exports what it
# recorded so cross-process span parentage is verifiable end to end.
_MEMTRACE: Optional[Any] = None

# Threading contract (the reference's thread-discipline checker).
# Lock order: _send_lock is a LEAF — frame assembly happens before
# acquisition and nothing is called under it but socket.sendall.
# _seq_lock guards the sid→entry map; snapshot under it, act outside.
VGT_COMPONENTS: Dict[str, str] = {}
VGT_LOCK_GUARDS = {
    "_seqs": "_seq_lock",
    "_staged": "_seq_lock",
    "_xfers": "_seq_lock",
    "_xfer_committed": "_seq_lock",
    "_xfer_committing": "_seq_lock",
    "_orphan_frames": "_orphan_lock",
}

# Sender-queue ceiling: a gateway that stopped reading gets its worker
# torn down (queue overflow → connection abandoned) instead of growing
# the heap without bound.
_SEND_QUEUE_MAX = 8192

# Orphan-mode frame buffer ceiling (token frames only — done/err
# frames are kept unconditionally because the done frame carries the
# authoritative full text, which is what the successor's idempotency
# replay serves).  Overflow drops the OLDEST token frame: ring
# semantics, bounded memory, and the terminal frame still reconstructs
# the result.
_ORPHAN_BUF_MAX = 4096

# notification ops that buffer while orphaned; replies never do — the
# adoption handshake itself must reach the wire
_ORPHAN_BUFFERED_OPS = frozenset({"tok", "done", "err", "evacuated"})


def wire_error(exc: BaseException) -> Dict[str, Any]:
    """Serialize an exception for a reply/err frame — class name keyed
    into the errors-module taxonomy so the gateway rebuilds the TYPED
    error (503-with-reason mapping intact), plus the retryable hint."""
    out: Dict[str, Any] = {
        "type": type(exc).__name__,
        "message": str(exc),
        "reason": getattr(exc, "reason", None),
    }
    retry_after = getattr(exc, "retry_after", None)
    if retry_after is not None:
        out["retry_after"] = float(retry_after)
    return out


def unwire_error(err: Dict[str, Any]) -> BaseException:
    """Rebuild a typed exception from a wire error dict.  Unknown or
    unconstructible types degrade to a generic RuntimeError carrying
    the original class name — never a crash in the error path."""
    from vgate_tpu_torch import errors as _errors

    name = str(err.get("type", "RuntimeError"))
    message = str(err.get("message", ""))
    retry_after = err.get("retry_after")
    cls = getattr(_errors, name, None)
    if isinstance(cls, type) and issubclass(cls, BaseException):
        try:
            if retry_after is not None:
                return cls(message, retry_after=float(retry_after))
            return cls(message)
        except TypeError:
            try:
                return cls(message)
            except TypeError:
                pass
    if retry_after is not None:
        return _errors.RetryableError(
            f"{name}: {message}", retry_after=float(retry_after)
        )
    return RuntimeError(f"{name}: {message}")


def params_from_wire(raw: Dict[str, Any]) -> SamplingParams:
    """SamplingParams from a JSON dict: unknown keys dropped (version
    skew tolerance), ``logit_bias`` keys re-coerced to int (JSON object
    keys are strings)."""
    import dataclasses

    fields = {f.name for f in dataclasses.fields(SamplingParams)}
    kwargs = {k: v for k, v in raw.items() if k in fields}
    bias = kwargs.get("logit_bias")
    if bias:
        kwargs["logit_bias"] = {int(k): float(v) for k, v in bias.items()}
    return SamplingParams(**kwargs)


def params_to_wire(params: SamplingParams) -> Dict[str, Any]:
    import dataclasses

    return dataclasses.asdict(params)


class _Entry:
    """One in-flight sequence's worker-side bookkeeping."""

    __slots__ = ("sid", "seq", "cancelled")

    def __init__(self, sid: int, seq: Sequence) -> None:
        self.sid = sid
        self.seq = seq
        self.cancelled = False  # evacuated/aborted: waiter stays silent


class _Staged:
    """One staged prefill→decode handoff (runtime/handoff.py) awaiting
    the gateway's pull transfer.  ``payload`` is a direct reference to
    the swap ticket's chunked host KV taken ON the engine thread at
    stage time, so a later discard nulling the ticket's own reference
    cannot race the packing; ``epoch`` is the sequence's preempt_count at
    stage — any fold since invalidates every fetch (HandoffStaleError).
    ``blob``/``digest`` cache the packed wire form lazily (first
    fetch)."""

    __slots__ = (
        "sid", "seq", "payload", "num_pages", "nbytes", "epoch",
        "blob", "digest",
    )

    def __init__(
        self, sid: int, seq: Sequence, payload: Any,
        num_pages: int, nbytes: int, epoch: int,
    ) -> None:
        self.sid = sid
        self.seq = seq
        self.payload = payload
        self.num_pages = num_pages
        self.nbytes = nbytes
        self.epoch = epoch
        self.blob: Optional[bytes] = None
        self.digest: Optional[int] = None


class WorkerServer:
    """The worker main object: engine + one-connection frame server."""

    def __init__(
        self,
        config: VGTConfig,
        epoch: int,
        index: int,
        registry_dir: Optional[str] = None,
        address: Optional[str] = None,
    ) -> None:
        self.config = config
        self.epoch = int(epoch)
        self.index = int(index)
        self.max_frame_bytes = int(config.pod.max_frame_bytes)
        # Gateway-crash survivability (pod.orphan_grace_s): registry
        # record + liveness beat so a successor gateway can find and
        # adopt this incarnation; orphan frame buffer for ordered
        # replay after adoption.
        self.registry_dir = registry_dir
        self.address = address
        self.orphan_grace_s = float(config.pod.orphan_grace_s)
        self._orphan_lock = threading.Lock()
        self._orphan_frames: List[Dict[str, Any]] = []
        self._orphan_tok_count = 0
        self._orphan_buffering = False
        self._orphaned = False
        self._orphan_deadline: Optional[float] = None
        self._adoptions = 0
        self._exit_reason: Optional[str] = None
        self._exit_recorded = False
        self._started_t = time.time()
        self._build_engine()
        self._seq_lock = threading.Lock()
        self._seqs: Dict[int, _Entry] = {}
        # Disaggregated prefill/decode (pod.roles) handoff state.  On a
        # prefill worker, _staged holds packed-KV staging records keyed
        # by sid; on a decode worker, _xfers holds in-progress chunk
        # reassemblies keyed by the gateway's per-attempt transfer id.
        # _xfer_committed remembers recently-committed transfer ids so
        # a gateway retry after a lost commit reply is answered
        # idempotently instead of double-admitting; _xfer_committing
        # rejects a CONCURRENT duplicate commit (two admissions of the
        # same sequence would diverge).
        self._staged: Dict[int, _Staged] = {}
        self._xfers: Dict[str, handoff_mod.ChunkAssembler] = {}
        self._xfer_committed: Set[str] = set()
        self._xfer_committing: Set[str] = set()
        self._staging_cap = max(
            int(config.pod.transfer_staging_bytes),
            int(config.kv_cache.host_swap_bytes),
        )
        self._send_lock = threading.Lock()
        self._send_q: "queue.Queue[Optional[bytes]]" = queue.Queue(
            maxsize=_SEND_QUEUE_MAX
        )
        self._conn: Optional[socket.socket] = None
        self._stopping = threading.Event()
        self._fenced_rejects = 0

    # ------------------------------------------------------------ engine

    def _build_engine(self) -> None:
        # import here so ``--help`` / unit tests of the wire helpers
        # never pay the torch engine's import
        from vgate_tpu_torch.runtime.engine_core import EngineCore

        t0 = time.perf_counter()
        if self.config.recovery.enabled:
            from vgate_tpu_torch.runtime.supervisor import EngineSupervisor

            self.engine: Any = EngineSupervisor(self.config)
        else:
            self.engine = EngineCore(self.config)
        self.engine.start()
        self.boot_s = time.perf_counter() - t0

    def _inner(self) -> Any:
        """The live EngineCore behind an optional supervisor wrapper —
        for surfaces the supervisor deliberately refuses or does not
        re-export (evacuate, the raw heartbeat)."""
        return getattr(self.engine, "core", self.engine)

    # ------------------------------------------------------------- wire out

    def _stamp(self, frame: Dict[str, Any]) -> Dict[str, Any]:
        frame["e"] = self.epoch
        return frame

    def _enqueue(self, frame: Dict[str, Any]) -> None:
        """Queue a frame for the sender thread (never blocks the engine
        thread; overflow abandons the connection — the gateway has
        stopped reading and will declare us lost anyway).  While
        orphaned, notification frames are buffered UN-encoded instead
        (the epoch is stamped at encode time, so replay after adoption
        carries the successor's epoch, not the dead gateway's)."""
        if frame.get("op") in _ORPHAN_BUFFERED_OPS:
            with self._orphan_lock:
                if self._orphan_buffering:
                    self._buffer_orphan_frame_locked(frame)
                    return
        self._enqueue_wire(frame)

    def _buffer_orphan_frame_locked(self, frame: Dict[str, Any]) -> None:
        """The caller holds ``_orphan_lock``."""
        if frame.get("op") == "tok":
            if self._orphan_tok_count >= _ORPHAN_BUF_MAX:
                # ring: drop the OLDEST token frame; the done frame's
                # full text survives regardless
                for i, old in enumerate(self._orphan_frames):
                    if old.get("op") == "tok":
                        del self._orphan_frames[i]
                        self._orphan_tok_count -= 1
                        break
            self._orphan_tok_count += 1
        self._orphan_frames.append(frame)

    def _enqueue_wire(self, frame: Dict[str, Any]) -> None:
        try:
            data = rpc.encode_frame(self._stamp(frame), self.max_frame_bytes)
        except rpc.FrameError:
            logger.error("outbound frame oversized; dropped", exc_info=True)
            return
        try:
            self._send_q.put_nowait(data)
        except queue.Full:
            logger.error(
                "sender queue overflow (gateway not reading); "
                "abandoning connection"
            )
            self._teardown_conn()

    def _sender_loop(self) -> None:
        while True:
            data = self._send_q.get()
            if data is None:
                return
            conn = self._conn
            if conn is None:
                continue
            try:
                # faults wire probe applies at the frame layer via
                # send_frame for requests; raw pre-encoded frames go
                # through the same probe here so token streams are
                # chaos-coverable too
                if faults.is_active():
                    verdict = faults.wire_action("rpc_send")
                    if verdict == "drop":
                        continue
                    if verdict == "garble":
                        data = rpc._garble(data)
                with self._send_lock:
                    conn.sendall(data)
            except OSError:
                self._teardown_conn()

    def _teardown_conn(self) -> None:
        conn, self._conn = self._conn, None
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass

    def _reply(self, cid: Any, data: Any) -> None:
        self._enqueue({"op": "reply", "id": cid, "ok": True, "data": data})

    def _reply_err(self, cid: Any, exc: BaseException) -> None:
        self._enqueue(
            {"op": "reply", "id": cid, "ok": False, "error": wire_error(exc)}
        )

    # ------------------------------------------------------------- verbs

    def _verb_hello(self, frame: Dict[str, Any]) -> Dict[str, Any]:
        inner = self._inner()
        geometry = inner.geometry
        return {
            "pid": os.getpid(),
            "epoch": self.epoch,
            "index": self.index,
            "model": inner.spec.name,
            "vocab_size": int(inner.spec.vocab_size),
            # one device per engine: the reference's single-device mesh
            "mesh": {"dp": 1, "tp": 1, "sp": 1, "pp": 1, "ep": 1},
            "geometry": {
                "num_pages": int(geometry.num_pages),
                "page_size": int(getattr(geometry, "page_size", 0)),
                "kv_dtype": getattr(geometry, "kv_dtype", None),
            },
            "kv_dtype": getattr(geometry, "kv_dtype", None),
            "load_time_s": float(
                getattr(inner, "load_time_s", 0.0) or 0.0
            ),
            "boot_s": self.boot_s,
            "device_health": inner.device_health(),
        }

    def _verb_ping(self, frame: Dict[str, Any]) -> Dict[str, Any]:
        """Liveness + engine beat + pressure in one cheap round-trip —
        the gateway's monitor classifies the beat with the supervisor's
        classifier (compile-grace-aware), so the worker only reports
        raw age, never a verdict."""
        inner = self._inner()
        now = time.monotonic()
        beat = getattr(inner, "_heartbeat", None) or {}
        data: Dict[str, Any] = {
            "state": self._state(),
            "fenced_rejects": self._fenced_rejects,
            "orphaned": self._orphaned,
            "adoptions": self._adoptions,
        }
        if beat:
            data["beat"] = {
                "age_s": max(0.0, now - float(beat.get("t", now))),
                "kind": beat.get("kind"),
                "compiling": bool(beat.get("compiling", False)),
            }
        try:
            data["pressure"] = self.engine.pressure_signals()
        except Exception:
            pass
        with self._seq_lock:
            data["inflight"] = len(self._seqs)
        return data

    def _state(self) -> str:
        state = getattr(self.engine, "state", None)
        if state is not None:
            return state.value
        if getattr(self.engine, "_fatal", None) is not None:
            return "dead"
        return "serving"

    def _attach_trace(self, seq: Sequence, frame: Dict[str, Any]) -> None:
        """Rebuild the gateway's trace identity on a submitted sequence.

        ``submit_existing`` (unlike ``submit_tokens``) constructs no
        RequestTrace — it was built for in-process replays that already
        carry one.  A gateway submit is client traffic crossing a
        process boundary, so the engine spans this worker emits
        (engine.queue/prefill/decode/detokenize) would otherwise be
        orphaned roots: decode the W3C ``traceparent`` the gateway
        stamped on the frame into a remote parent context and open the
        queue span at the sequence's local arrival anchor.  Degrades to
        a silent no-op when the recorder is off or the frame carries no
        (or a malformed) trace header."""
        flight = getattr(self._inner(), "flight", None)
        if flight is None or not flight.enabled:
            return
        ctx = tracing.context_from_traceparent(frame.get("traceparent"))
        meta = RequestMeta(
            request_id=frame.get("request_id"), trace_ctx=ctx
        )
        seq.trace = RequestTrace(meta)
        seq.trace.start("queue", start_pc=seq.arrival_t)

    def _verb_submit(self, frame: Dict[str, Any]) -> Dict[str, Any]:
        if self._orphaned:
            # an orphan that took new work could never be reconciled
            # against the successor gateway's journal
            raise WorkerOrphanedError(
                "worker is orphaned (gateway gone, grace running): "
                "finishing in-flight decodes, accepting no new submits"
            )
        sid = int(frame["sid"])
        raw_params = dict(frame.get("params") or {})
        remaining_s = frame.get("remaining_s")
        if remaining_s is not None:
            # the gateway ships the REMAINING budget so the absolute
            # deadline survives the process hop (clock domains differ);
            # fold it in before construction — SamplingParams is frozen
            raw_params["timeout_s"] = max(0.01, float(remaining_s))
        params = params_from_wire(raw_params)
        prompt_ids = [int(t) for t in frame.get("prompt_ids") or []]
        generated = [int(t) for t in frame.get("generated_ids") or []]
        handoff = bool(frame.get("handoff"))
        if handoff:
            # re-arm on every handoff submit: cheap, and it survives a
            # supervisor core rebuild (the rebuilt core starts with the
            # callback unset)
            self._inner().on_handoff_staged = self._on_handoff_staged

        entry_cell: List[_Entry] = []

        def on_token(token: int) -> None:
            entry = entry_cell[0]
            if entry.cancelled:
                return
            lp = None
            seq = entry.seq
            # _attach_logprob runs before append_token on every engine
            # path, so the just-appended token's data is the last entry
            if seq.params.logprobs and len(seq.logprob_data) >= len(
                seq.generated_ids
            ):
                lp = seq.logprob_data[len(seq.generated_ids) - 1]
            self._enqueue(
                {"op": "tok", "sid": sid, "t": int(token), "lp": lp}
            )

        # Build the Sequence ourselves (both fresh and resubmit paths)
        # and admit it via submit_existing: the entry is fully wired
        # BEFORE the engine thread can fire on_token, and a resubmit's
        # fold (prefill-continue; RNG continuation is implicit — see
        # SequenceCheckpoint's docstring) is just the generated prefix.
        seq = Sequence(
            prompt_ids=prompt_ids + generated,
            params=params,
            generated_ids=list(generated),
            orig_prompt_len=len(prompt_ids),
            resume_count=int(frame.get("resume_count", 0)),
            migrate_count=int(frame.get("migrate_count", 0)),
            preempt_count=int(frame.get("preempt_count", 0)),
            request_id=frame.get("request_id"),
            kv_dtype=frame.get("kv_dtype"),
            stream_cb=on_token,
        )
        seq.handoff_requested = handoff
        self._attach_trace(seq, frame)
        entry = _Entry(sid, seq)
        entry_cell.append(entry)
        # supervisor deployments: apply the same admission gate
        # submit_tokens runs (health state + poison quarantine) —
        # submit_existing deliberately skips it for in-process replays,
        # but a gateway submit is client traffic
        gate = getattr(self.engine, "_gate", None)
        if gate is not None:
            gate(list(prompt_ids))
        with self._seq_lock:
            self._seqs[sid] = entry
        try:
            self.engine.submit_existing(seq)
        except BaseException:
            with self._seq_lock:
                self._seqs.pop(sid, None)
            raise
        with bound_request(
            seq.request_id, getattr(seq.trace, "trace_id", None)
        ):
            # bound so a grep by the gateway's X-Request-ID finds the
            # worker-side admission too, not just the gateway log line
            logger.info(
                "submitted gateway sequence",
                extra={
                    "extra_data": {
                        "sid": sid,
                        "seq_id": seq.seq_id,
                        "prompt_tokens": len(prompt_ids),
                        "handoff": handoff,
                    }
                },
            )
        threading.Thread(
            target=self._waiter, args=(entry,), daemon=True,
            name=f"vgt-worker-waiter-{sid}",
        ).start()
        return {"sid": sid, "seq_id": seq.seq_id}

    def _waiter(self, entry: _Entry) -> None:
        """Settle observer for one sequence: ships the terminal frame
        when the engine finishes/fails it.  Polling wait so an
        evacuation (which never settles the sequence) releases the
        thread via the cancelled flag."""
        seq = entry.seq
        while not seq.done_event.wait(timeout=0.5):
            if entry.cancelled or self._stopping.is_set():
                return
        if entry.cancelled:
            return
        with self._seq_lock:
            self._seqs.pop(entry.sid, None)
        with bound_request(
            seq.request_id, getattr(seq.trace, "trace_id", None)
        ):
            logger.info(
                "sequence settled",
                extra={
                    "extra_data": {
                        "sid": entry.sid,
                        "status": seq.status.name,
                        "generated_tokens": seq.num_generated,
                        "finish_reason": seq.finish_reason,
                    }
                },
            )
        if seq.status is SeqStatus.FAILED:
            self._enqueue(
                {
                    "op": "err",
                    "sid": entry.sid,
                    "error": wire_error(
                        seq.error or RuntimeError("unknown failure")
                    ),
                }
            )
            return
        lp = list(seq.logprob_data) if seq.params.logprobs else None
        self._enqueue(
            {
                "op": "done",
                "sid": entry.sid,
                "finish_reason": seq.finish_reason,
                "text": self.engine.final_text(seq),
                "lp": lp,
                "resume_count": seq.resume_count,
                "migrate_count": seq.migrate_count,
                "preempt_count": seq.preempt_count,
            }
        )

    def _verb_abort(self, frame: Dict[str, Any]) -> Dict[str, Any]:
        sid = int(frame["sid"])
        reason = str(frame.get("reason", "client_disconnect"))
        with self._seq_lock:
            entry = self._seqs.get(sid)
            # an aborted staged handoff will never be fetched again; the
            # scheduler's abort path reaps the swap ticket itself
            self._staged.pop(sid, None)
        if entry is not None and entry.seq is not None:
            entry.seq.request_abort(reason)
        return {"aborted": entry is not None}

    # ------------------------------------------------- handoff (pod.roles)
    #
    # Prefill side: the engine stages a finished prefill (KV folded to
    # the host swap pool) and fires on_handoff_staged on its own
    # thread; we notify the gateway, which pulls the packed KV in
    # chunks (handoff_fetch) and finally tells us the outcome
    # (handoff_done / handoff_cancel).  Decode side: the gateway pushes
    # chunks (handoff_put) and commits (handoff_commit) — an atomic,
    # idempotent admission that adopts the KV pages with zero
    # recompute.  All transfer corruption surfaces as TYPED errors
    # (HandoffTransferError / HandoffStaleError); the gateway owns
    # retry and monolithic fallback.

    def _on_handoff_staged(self, seq: Sequence, staged: bool) -> None:
        """EngineCore callback, runs ON the engine thread: register the
        staging record and notify the gateway (or report fallback if
        the engine could not stage)."""
        with self._seq_lock:
            entry = None
            for e in self._seqs.values():
                if e.seq is seq:
                    entry = e
                    break
        if entry is None or entry.cancelled:
            return
        if not staged:
            self._enqueue({"op": "handoff_fallback", "sid": entry.sid})
            return
        ticket = getattr(seq, "_swap_ticket", None)
        if ticket is None or not ticket.payload:
            # staged but the ticket vanished (defensive): tell the
            # gateway to fall back; the engine's release path resumes
            # local decode
            self._inner().handoff_cancel(seq)
            self._enqueue({"op": "handoff_fallback", "sid": entry.sid})
            return
        st = _Staged(
            entry.sid, seq, ticket.payload, int(ticket.num_pages),
            int(ticket.nbytes), int(seq.preempt_count),
        )
        with self._seq_lock:
            self._staged[entry.sid] = st
        self._enqueue(
            {
                "op": "handoff_staged",
                "sid": entry.sid,
                "pages": st.num_pages,
                "nbytes": st.nbytes,
                "base_len": len(seq.prompt_ids),
                "generated_ids": [int(t) for t in seq.generated_ids],
                "resume_count": seq.resume_count,
                "migrate_count": seq.migrate_count,
                "preempt_count": seq.preempt_count,
                "swap_count": seq.swap_count,
                "kv_dtype": seq.kv_dtype,
            }
        )

    def _verb_handoff_fetch(self, frame: Dict[str, Any]) -> Dict[str, Any]:
        """Serve one chunk of the staged, packed KV blob.  Validity is
        re-checked per fetch: any fold/abort since staging (supervisor
        replay, deadline abort) invalidates the bytes — stale KV must
        never leave this process."""
        sid = int(frame["sid"])
        off = int(frame.get("off", 0))
        n = int(frame.get("n", 0))
        with self._seq_lock:
            st = self._staged.get(sid)
        if st is None:
            raise HandoffStaleError(f"no staged handoff for sid {sid}")
        seq = st.seq
        if (
            not getattr(seq, "_handoff_hold", False)
            or seq.preempt_count != st.epoch
            or seq.status is not SeqStatus.WAITING
        ):
            with self._seq_lock:
                self._staged.pop(sid, None)
            raise HandoffStaleError(
                f"staged handoff for sid {sid} invalidated "
                f"(status={seq.status.name}, epoch {seq.preempt_count} "
                f"vs staged {st.epoch})"
            )
        blob = st.blob
        digest = st.digest
        if blob is None:
            packed = handoff_mod.pack_payload(
                handoff_mod.ticket_to_tree(st.payload)
            )
            packed_digest = handoff_mod.payload_digest(packed)
            # CAS under the lock: a retry racing a timed-out fetch may
            # pack concurrently; first publication wins so every chunk
            # of one transfer comes from ONE byte-identical blob
            with self._seq_lock:
                if st.blob is None:
                    st.blob = packed
                    st.digest = packed_digest
                blob = st.blob
                digest = st.digest
        if off < 0 or off > len(blob):
            raise HandoffTransferError(
                f"fetch offset {off} out of bounds (blob {len(blob)}B)"
            )
        # b64 expands 4/3; leave frame headroom for the JSON envelope
        limit = max(1, (self.max_frame_bytes * 3) // 5)
        n = min(n if n > 0 else limit, limit)
        data = base64.b64encode(blob[off:off + n]).decode("ascii")
        return {
            "total": len(blob),
            "digest": digest,
            "pages": st.num_pages,
            "data": data,
        }

    def _verb_handoff_cancel(self, frame: Dict[str, Any]) -> Dict[str, Any]:
        """Gateway gave up on the transfer: drop staging and resume the
        sequence locally (monolithic decode via swap-in, zero
        recompute)."""
        sid = int(frame["sid"])
        with self._seq_lock:
            st = self._staged.pop(sid, None)
            entry = self._seqs.get(sid)
        if st is not None and entry is not None and not entry.cancelled:
            self._inner().handoff_cancel(st.seq)
            return {"resumed": True}
        return {"resumed": False}

    def _verb_handoff_done(self, frame: Dict[str, Any]) -> Dict[str, Any]:
        """Transfer accepted by the decode worker: this worker's copy is
        now surplus.  Cancel the entry (the waiter stays silent — the
        sequence never settles here; the gateway owns the client) and
        let the engine evacuate the held sequence + discard its swap
        ticket."""
        sid = int(frame["sid"])
        with self._seq_lock:
            st = self._staged.pop(sid, None)
            entry = self._seqs.pop(sid, None)
        if entry is not None:
            entry.cancelled = True
        if st is not None:
            self._inner().handoff_done(st.seq)
        return {"ok": st is not None}

    def _verb_handoff_put(self, frame: Dict[str, Any]) -> Dict[str, Any]:
        """Accept one chunk of an inbound KV transfer (decode side).
        Byte-identical redelivery is idempotent; conflicting overlap,
        truncation past total, or undecodable data is a typed error."""
        xid = str(frame["xfer"])
        off = int(frame.get("off", 0))
        total = int(frame.get("total", 0))
        try:
            data = base64.b64decode(
                str(frame.get("data", "")), validate=True
            )
        except (binascii.Error, ValueError) as exc:
            raise HandoffTransferError(
                f"undecodable transfer chunk: {exc}"
            ) from exc
        with self._seq_lock:
            if xid in self._xfer_committed:
                return {"got": total, "dup": True}
            asm = self._xfers.get(xid)
            if asm is None:
                asm = handoff_mod.ChunkAssembler(total, self._staging_cap)
                self._xfers[xid] = asm
        if asm.total != total:
            raise HandoffTransferError(
                f"transfer {xid}: total mismatch "
                f"({total} vs first-seen {asm.total})"
            )
        got = asm.put(off, data)
        return {"got": got}

    def _verb_handoff_commit(self, frame: Dict[str, Any]) -> Dict[str, Any]:
        """Finalize an inbound transfer: verify completeness + digest,
        unpack the KV pytree, and admit the sequence with the adopted
        pages (zero recompute).  Idempotent on retry; a concurrent
        duplicate is refused (double admission would diverge)."""
        xid = str(frame["xfer"])
        sid = int(frame["sid"])
        with self._seq_lock:
            if xid in self._xfer_committed or sid in self._seqs:
                # retry of a commit whose reply was lost — the sequence
                # is already (or still) admitted; re-accepting is a
                # no-op for the gateway
                return {"accepted": True, "dup": True}
            if xid in self._xfer_committing:
                raise HandoffTransferError(
                    f"transfer {xid}: commit already in progress"
                )
            self._xfer_committing.add(xid)
        try:
            return self._handoff_commit_locked_out(xid, sid, frame)
        finally:
            with self._seq_lock:
                self._xfer_committing.discard(xid)

    def _handoff_commit_locked_out(
        self, xid: str, sid: int, frame: Dict[str, Any]
    ) -> Dict[str, Any]:
        with self._seq_lock:
            asm = self._xfers.get(xid)
        if asm is None:
            raise HandoffTransferError(f"unknown transfer {xid}")
        blob = asm.complete()  # typed error on gaps → gateway retries
        want_digest = int(frame.get("digest", 0))
        got_digest = handoff_mod.payload_digest(blob)
        if got_digest != want_digest:
            # drop the assembler so the retry rebuilds from scratch —
            # we cannot tell WHICH chunk was garbled
            with self._seq_lock:
                self._xfers.pop(xid, None)
            raise HandoffTransferError(
                f"transfer {xid}: payload digest mismatch "
                f"(got {got_digest}, want {want_digest})"
            )
        from vgate_tpu_torch.runtime.engine_core import SWAP_CHUNK_PAGES

        payload = handoff_mod.tree_to_ticket(
            handoff_mod.unpack_payload(blob), SWAP_CHUNK_PAGES
        )

        raw_params = dict(frame.get("params") or {})
        remaining_s = frame.get("remaining_s")
        if remaining_s is not None:
            raw_params["timeout_s"] = max(0.01, float(remaining_s))
        params = params_from_wire(raw_params)
        prompt_ids = [int(t) for t in frame.get("prompt_ids") or []]
        generated = [int(t) for t in frame.get("generated_ids") or []]
        base_len = int(frame.get("base_len", len(prompt_ids)))
        num_pages = int(frame.get("pages", 0))
        full = prompt_ids + generated
        if base_len <= 0 or base_len > len(full):
            raise HandoffTransferError(
                f"transfer {xid}: base_len {base_len} out of range"
            )
        inner = self._inner()
        page_size = int(getattr(inner.geometry, "page_size", 0) or 1)
        want_pages = (max(1, len(full) - 1) + page_size - 1) // page_size
        if num_pages != want_pages:
            raise HandoffTransferError(
                f"transfer {xid}: page-count mismatch "
                f"({num_pages} shipped, geometry wants {want_pages})"
            )

        entry_cell: List[_Entry] = []

        def on_token(token: int) -> None:
            entry = entry_cell[0]
            if entry.cancelled:
                return
            lp = None
            seq = entry.seq
            if seq.params.logprobs and len(seq.logprob_data) >= len(
                seq.generated_ids
            ):
                lp = seq.logprob_data[len(seq.generated_ids) - 1]
            self._enqueue(
                {"op": "tok", "sid": sid, "t": int(token), "lp": lp}
            )

        # swap-shape construction: prompt/output split at the PREFILL
        # worker's fold point so total_len ↔ shipped page count agree;
        # orig_prompt_len keeps the client-visible text boundary
        seq = Sequence(
            prompt_ids=full[:base_len],
            params=params,
            output_ids=full[base_len:],
            generated_ids=list(generated),
            orig_prompt_len=len(prompt_ids),
            resume_count=int(frame.get("resume_count", 0)),
            migrate_count=int(frame.get("migrate_count", 0)),
            preempt_count=int(frame.get("preempt_count", 0)),
            swap_count=int(frame.get("swap_count", 0)),
            handoff_count=int(frame.get("handoff_count", 1)),
            request_id=frame.get("request_id"),
            kv_dtype=frame.get("kv_dtype"),
            stream_cb=on_token,
        )
        seq._handoff_adopt = (payload, num_pages)
        self._attach_trace(seq, frame)
        entry = _Entry(sid, seq)
        entry_cell.append(entry)
        gate = getattr(self.engine, "_gate", None)
        if gate is not None:
            gate(list(prompt_ids))
        with self._seq_lock:
            self._seqs[sid] = entry
        try:
            self.engine.submit_existing(seq)
        except BaseException:
            with self._seq_lock:
                self._seqs.pop(sid, None)
            raise
        with bound_request(
            seq.request_id, getattr(seq.trace, "trace_id", None)
        ):
            logger.info(
                "handoff commit: adopted sequence",
                extra={
                    "extra_data": {
                        "sid": sid,
                        "xfer": xid,
                        "pages": num_pages,
                        "generated_tokens": len(generated),
                    }
                },
            )
        threading.Thread(
            target=self._waiter, args=(entry,), daemon=True,
            name=f"vgt-worker-waiter-{sid}",
        ).start()
        with self._seq_lock:
            self._xfers.pop(xid, None)
            self._xfer_committed.add(xid)
            if len(self._xfer_committed) > 4096:
                self._xfer_committed.clear()
        return {"accepted": True, "seq_id": seq.seq_id}

    def _verb_handoff_abort(self, frame: Dict[str, Any]) -> Dict[str, Any]:
        """Drop a partial inbound transfer (gateway retry or give-up).
        Post-commit cancellation goes through the normal abort verb —
        the sequence is registered in _seqs by then."""
        xid = str(frame["xfer"])
        with self._seq_lock:
            dropped = self._xfers.pop(xid, None) is not None
        return {"dropped": dropped}

    def _verb_abort_all(self, frame: Dict[str, Any]) -> Dict[str, Any]:
        fn = getattr(self.engine, "abort_in_flight", None)
        if fn is not None:
            fn(str(frame.get("reason", "drain")))
        return {}

    def _verb_evacuate(self, frame: Dict[str, Any]) -> Dict[str, Any]:
        """Planned movement across the process boundary: checkpoint
        the named (or all) resident sequences without a fatal; the
        gateway owns the replay.  Bypasses the supervisor's dp=1
        refusal deliberately — here there IS a migration target, it
        just lives in another process."""
        sids = frame.get("sids")
        reason = str(frame.get("reason", "drain"))
        # "timeout_s" on the wire: the bare name would collide with the
        # client-side call() deadline kwarg
        timeout = float(frame.get("timeout_s", 30.0))
        with self._seq_lock:
            entries = dict(self._seqs)
        if sids is not None:
            wanted = {int(s) for s in sids}
            entries = {s: e for s, e in entries.items() if s in wanted}
        seq_ids = [
            e.seq.seq_id for e in entries.values() if e.seq is not None
        ]
        evacuated = self._inner().evacuate(
            None if sids is None else seq_ids,
            reason=reason,
            timeout=timeout,
        )
        out = []
        by_seq_id = {
            e.seq.seq_id: e for e in entries.values() if e.seq is not None
        }
        for seq in evacuated:
            entry = by_seq_id.get(seq.seq_id)
            if entry is None:
                continue
            entry.cancelled = True
            with self._seq_lock:
                self._seqs.pop(entry.sid, None)
            out.append({"sid": entry.sid, **seq.checkpoint().as_dict()})
        return {"evacuated": out}

    def _verb_health(self, frame: Dict[str, Any]) -> Dict[str, Any]:
        health_fn = getattr(self.engine, "health", None)
        if health_fn is not None:
            return health_fn()
        state = self._state()
        return {
            "state": state,
            "alive": state_is_alive(state),
            "ready": state_is_ready(state),
        }

    def _verb_stats(self, frame: Dict[str, Any]) -> Dict[str, Any]:
        """The engine's stats, plus two port-only keys: this process's
        kernel launches by wrapper (the counts live in the wrappers of
        the process that launched them) and its memory."""
        from vgate_tpu_torch.ops.kernels import launch_counts

        return {
            **self.engine.get_stats(),
            "kernel_launches": launch_counts(),
            "memory": self._memory(),
        }

    def _verb_reset_launches(self, frame: Dict[str, Any]) -> Dict[str, Any]:
        """Port-only: set this process's kernel launch counts to 0."""
        from vgate_tpu_torch.ops.kernels import launch_counts

        return launch_counts(reset=True)

    def _memory(self) -> Dict[str, Any]:
        """Weights, pool pages and the device's peak bytes of this
        worker (None off the card)."""
        import torch

        from vgate_tpu_torch.integrity import leaves_with_path

        inner = self._inner()
        weights = sum(
            int(leaf.numel()) * int(leaf.element_size())
            for _, leaf in leaves_with_path(inner.params)
            if isinstance(leaf, torch.Tensor)
        )
        dev = getattr(inner, "device", None)
        cuda = dev is not None and dev.type == "cuda"
        return {
            "weights_bytes": weights,
            "pool_pages": int(inner.geometry.num_pages),
            "pool_bytes": int(inner.geometry.num_pages)
            * int(inner.geometry.page_bytes),
            "peak_bytes": (
                int(torch.cuda.max_memory_allocated(dev)) if cuda else None
            ),
            "budget_bytes": int(self.config.device.kv_budget_bytes),
        }

    def _verb_pressure(self, frame: Dict[str, Any]) -> Dict[str, Any]:
        return self.engine.pressure_signals()

    def _verb_flight(self, frame: Dict[str, Any]) -> Dict[str, Any]:
        """Flight-recorder tick ring + stats for the gateway's merged
        pod view (/debug/flight).  Bounded by the recorder's own ring
        size, so the reply always fits the frame cap."""
        flight = getattr(self._inner(), "flight", None)
        if flight is None:
            return {"enabled": False, "ticks": [], "stats": {}}
        n = frame.get("n")
        return {
            "enabled": bool(flight.enabled),
            "ticks": flight.ticks(int(n) if n is not None else None),
            "stats": flight.get_stats(),
        }

    def _verb_requests(self, frame: Dict[str, Any]) -> Dict[str, Any]:
        """Per-request flight records (live + completed) for the
        gateway's merged /debug/requests view."""
        flight = getattr(self._inner(), "flight", None)
        if flight is None:
            return {"enabled": False, "live": [], "completed": []}
        n = frame.get("n")
        return {
            "enabled": bool(flight.enabled),
            "live": flight.live_requests(),
            "completed": flight.requests(
                int(n) if n is not None else None
            ),
        }

    def _verb_spans(self, frame: Dict[str, Any]) -> Dict[str, Any]:
        """Export memtrace-recorded spans (drill/test tooling: empty
        unless the pod was launched with VGT_MEMTRACE=1) so span
        parentage across the RPC boundary is verifiable from outside
        this process."""
        rec = _MEMTRACE
        if rec is None:
            return {"enabled": False, "spans": []}
        out = []
        for s in rec.spans():
            out.append(
                {
                    "name": s.name,
                    "trace_id": s.trace_id_hex,
                    "span_id": s.span_id_hex,
                    "parent_span_id": s.parent_span_id_hex,
                    "start_ns": s.start_time,
                    "end_ns": s.end_time,
                    "attributes": {
                        k: v
                        for k, v in s.attributes.items()
                        if isinstance(v, (str, int, float, bool))
                    },
                }
            )
        return {"enabled": True, "spans": out}

    def _verb_perf(self, frame: Dict[str, Any]) -> Dict[str, Any]:
        fn = getattr(self._inner(), "perf_snapshot", None)
        return fn() if fn is not None else {}

    def _verb_warmup(self, frame: Dict[str, Any]) -> Dict[str, Any]:
        buckets = frame.get("buckets")
        return {"seconds": float(self._inner().warmup(buckets))}

    def _verb_canary(self, frame: Dict[str, Any]) -> Dict[str, Any]:
        """Pinned greedy self-probe, run on demand for the
        gateway's respawn gate: returns the output fingerprint; the
        gateway compares against the fleet's recorded one."""
        from vgate_tpu_torch.integrity import (
            canary_fingerprint,
            canary_prompt_ids,
        )

        inner = self._inner()
        cfg = self.config.integrity
        ids = canary_prompt_ids(
            inner.spec.vocab_size, cfg.canary_prompt_len
        )
        params = SamplingParams(
            temperature=0.0, max_tokens=cfg.canary_max_tokens
        )
        seq = Sequence(prompt_ids=ids, params=params, canary=True)
        timeout = cfg.canary_timeout_s
        if getattr(inner, "total_steps", 1) == 0:
            timeout += cfg.canary_compile_grace_s
        inner.submit_existing(seq)
        if not seq.done_event.wait(timeout=timeout):
            seq.request_abort(reason="drain")
            raise TimeoutError(
                f"canary self-probe timed out after {timeout}s"
            )
        if seq.status is SeqStatus.FAILED:
            raise RuntimeError(
                f"canary self-probe failed: {seq.error}"
            )
        out = list(seq.generated_ids)
        return {
            "fingerprint": canary_fingerprint(out),
            "tokens": len(out),
        }

    def _verb_set_spec_suspended(self, frame: Dict[str, Any]) -> Dict[str, Any]:
        fn = getattr(self.engine, "set_spec_suspended", None)
        if fn is not None:
            fn(bool(frame.get("flag", False)))
        return {}

    def _verb_set_prefix_insert_suspended(
        self, frame: Dict[str, Any]
    ) -> Dict[str, Any]:
        fn = getattr(self.engine, "set_prefix_insert_suspended", None)
        if fn is not None:
            fn(bool(frame.get("flag", False)))
        return {}

    def _verb_stop(self, frame: Dict[str, Any]) -> Dict[str, Any]:
        self._exit_reason = self._exit_reason or "gateway_stop"
        self._stopping.set()
        return {"stopping": True}

    # ---------------------------------------------- orphan mode / adoption

    def _verb_orphan_status(self, frame: Dict[str, Any]) -> Dict[str, Any]:
        """Read-only adoption-handshake probe — epoch-EXEMPT (a
        successor gateway holding a bumped epoch must be able to ask
        before it adopts)."""
        with self._seq_lock:
            inflight = len(self._seqs)
        with self._orphan_lock:
            buffered = len(self._orphan_frames)
        remaining = None
        if self._orphan_deadline is not None:
            remaining = max(0.0, self._orphan_deadline - time.monotonic())
        return {
            "pid": os.getpid(),
            "index": self.index,
            "epoch": self.epoch,
            "orphaned": self._orphaned,
            "orphan_grace_s": self.orphan_grace_s,
            "grace_remaining_s": remaining,
            "inflight": inflight,
            "buffered_frames": buffered,
            "adoptions": self._adoptions,
            "state": self._state(),
        }

    def _verb_adopt(self, frame: Dict[str, Any]) -> Dict[str, Any]:
        """Take this incarnation over for a successor gateway.  Epoch-
        exempt from the strict-equality check, but the proposed epoch
        must be STRICTLY NEWER than the current one — a stale successor
        (or a double adopt racing a fresher one) is fenced exactly like
        a zombie worker frame.  The reply carries everything the
        successor needs to reconcile: in-flight sids with their request
        ids and progress, plus the buffered-frame count.  Buffered
        frames do NOT flush here — the successor registers the adopted
        sequences first and then sends ``orphan_flush``, so no frame
        can arrive before its sid is routable."""
        proposed = frame.get("e")
        if not isinstance(proposed, int):
            raise ValueError("adopt frame missing a fencing epoch")
        if proposed <= self.epoch:
            raise WorkerFencedError(
                f"adopt epoch {proposed} is not newer than the current "
                f"incarnation epoch {self.epoch}"
            )
        with self._orphan_lock:
            buffered = len(self._orphan_frames)
            buffered_toks: Dict[int, int] = {}
            for f in self._orphan_frames:
                if f.get("op") == "tok":
                    sid = f.get("sid")
                    buffered_toks[sid] = buffered_toks.get(sid, 0) + 1
        with self._seq_lock:
            inflight = [
                {
                    "sid": entry.sid,
                    "request_id": entry.seq.request_id,
                    # tokens already DELIVERED to the predecessor (total
                    # minus still-buffered): the successor pads its shell
                    # to this and the orphan_flush replay appends the
                    # rest, so its count reconciles to the true total
                    "generated_tokens": max(
                        0,
                        entry.seq.num_generated
                        - buffered_toks.get(entry.sid, 0),
                    ),
                    "cancelled": entry.cancelled,
                }
                for entry in self._seqs.values()
            ]
        was_orphaned = self._orphaned
        self.epoch = proposed
        self._orphaned = False
        self._orphan_deadline = None
        self._adoptions += 1
        logger.warning(
            "adopted by successor gateway",
            extra={
                "extra_data": {
                    "epoch": proposed,
                    "inflight": len(inflight),
                    "buffered_frames": buffered,
                    "was_orphaned": was_orphaned,
                }
            },
        )
        self._write_registry("serving")
        return {
            "pid": os.getpid(),
            "index": self.index,
            "epoch": self.epoch,
            "was_orphaned": was_orphaned,
            "inflight": inflight,
            "buffered_frames": buffered,
            "adoptions": self._adoptions,
        }

    def _verb_orphan_flush(self, frame: Dict[str, Any]) -> Dict[str, Any]:
        """Replay the orphan-buffered frames in order (notification —
        the successor sends it AFTER registering the adopted sids).
        Drain-loop shape (the handoff buffer's pattern): keep
        draining until a pass finds the buffer empty, THEN drop the
        buffering flag under the lock, so a frame enqueued concurrently
        by the engine thread can never jump ahead of a buffered one."""
        while True:
            with self._orphan_lock:
                frames = self._orphan_frames
                if not frames:
                    self._orphan_buffering = False
                    self._orphan_tok_count = 0
                    break
                self._orphan_frames = []
                self._orphan_tok_count = 0
            for buffered in frames:
                self._enqueue_wire(buffered)
        return {}

    def _enter_orphan_mode(self, reason: str) -> None:
        self._teardown_conn()
        with self._orphan_lock:
            self._orphan_buffering = True
        self._orphaned = True
        self._orphan_deadline = time.monotonic() + self.orphan_grace_s
        logger.warning(
            "gateway connection lost; entering orphan mode",
            extra={
                "extra_data": {
                    "reason": reason,
                    "grace_s": self.orphan_grace_s,
                    "epoch": self.epoch,
                }
            },
        )
        self._write_registry("orphaned")

    # ------------------------------------------------- registry records

    def _registry_path(self) -> Optional[str]:
        if not self.registry_dir:
            return None
        return os.path.join(self.registry_dir, f"w{self.index}.json")

    def _write_registry(
        self,
        status: Optional[str] = None,
        exit_reason: Optional[str] = None,
        checkpoints: Optional[List[Dict[str, Any]]] = None,
    ) -> None:
        """Atomically (re)write this worker's registry record.  The
        record is how a successor gateway finds a live orphan (socket
        path + pid + epoch + a liveness beat) and how an exited worker
        leaves post-mortem evidence (exit reason + final checkpoint
        summary) instead of silently vanishing from /debug/pod."""
        path = self._registry_path()
        if path is None:
            return
        if status is None:
            status = "orphaned" if self._orphaned else "serving"
        with self._seq_lock:
            inflight = len(self._seqs)
        remaining = None
        if self._orphan_deadline is not None:
            remaining = max(0.0, self._orphan_deadline - time.monotonic())
        record: Dict[str, Any] = {
            "pid": os.getpid(),
            "index": self.index,
            "epoch": self.epoch,
            "address": self.address,
            "status": status,
            "beat": time.time(),
            "started_t": self._started_t,
            "orphan_grace_s": self.orphan_grace_s,
            "grace_remaining_s": remaining,
            "inflight": inflight,
            "adoptions": self._adoptions,
        }
        if exit_reason is not None:
            record["exit_reason"] = exit_reason
        if checkpoints is not None:
            record["checkpoints"] = checkpoints
        # one temp name a thread: the beat thread and a drain can write
        # at once, and with one name a process the first rename takes
        # the other's file, so that write is lost
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        try:
            with open(tmp, "w") as fh:
                json.dump(record, fh, separators=(",", ":"))
            os.replace(tmp, path)
        except OSError:
            logger.warning("registry record write failed", exc_info=True)
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def _registry_beat_loop(self) -> None:
        """Refresh the registry beat while the worker lives — serving
        AND orphaned alike (a successor judges orphan liveness by this
        beat plus the pid)."""
        while not self._stopping.wait(1.0):
            self._write_registry()

    _SLOW_VERBS = frozenset(
        {
            "evacuate", "warmup", "canary", "stats", "perf",
            # fetch packs the KV pytree (CPU-bound, MBs); commit
            # unpacks + admits — neither may stall the ping path
            "handoff_fetch", "handoff_commit",
            # span export can serialize thousands of records
            "spans",
        }
    )

    _VERBS = {
        "hello": _verb_hello,
        "ping": _verb_ping,
        "submit": _verb_submit,
        "abort": _verb_abort,
        "abort_all": _verb_abort_all,
        "evacuate": _verb_evacuate,
        "handoff_fetch": _verb_handoff_fetch,
        "handoff_cancel": _verb_handoff_cancel,
        "handoff_done": _verb_handoff_done,
        "handoff_put": _verb_handoff_put,
        "handoff_commit": _verb_handoff_commit,
        "handoff_abort": _verb_handoff_abort,
        "health": _verb_health,
        "stats": _verb_stats,
        "reset_launches": _verb_reset_launches,
        "pressure": _verb_pressure,
        "perf": _verb_perf,
        "flight": _verb_flight,
        "requests": _verb_requests,
        "spans": _verb_spans,
        "warmup": _verb_warmup,
        "canary": _verb_canary,
        "set_spec_suspended": _verb_set_spec_suspended,
        "set_prefix_insert_suspended": _verb_set_prefix_insert_suspended,
        "stop": _verb_stop,
        "orphan_status": _verb_orphan_status,
        "adopt": _verb_adopt,
        "orphan_flush": _verb_orphan_flush,
    }

    # Adoption-handshake verbs are exempt from the strict-equality
    # epoch check: a successor gateway NECESSARILY holds an epoch this
    # incarnation has never seen (it bumps before it adopts).  adopt
    # enforces strictly-newer itself; orphan_status is read-only.
    _EPOCH_EXEMPT_VERBS = frozenset({"adopt", "orphan_status"})

    # ------------------------------------------------------------ dispatch

    def _dispatch(self, frame: Dict[str, Any]) -> None:
        cid = frame.get("id")
        try:
            if frame.get("op") not in self._EPOCH_EXEMPT_VERBS:
                rpc.check_epoch(frame, self.epoch)
        except rpc.StaleEpochError as exc:
            # a gateway (or tool) addressing a previous incarnation of
            # this slot: reject typed, never touch the engine
            self._fenced_rejects += 1
            logger.warning(
                "fenced stale RPC",
                extra={
                    "extra_data": {
                        "op": frame.get("op"),
                        "got": exc.got,
                        "want": exc.want,
                    }
                },
            )
            if cid is not None:
                self._reply_err(
                    cid,
                    WorkerFencedError(
                        f"stale fencing epoch {exc.got} "
                        f"(worker incarnation is {exc.want})"
                    ),
                )
            return
        except rpc.FrameError as exc:
            # epoch MISSING (vs merely stale): a structural violation —
            # same treatment, typed fence, never touch the engine, and
            # never let it escape into the reader loop
            self._fenced_rejects += 1
            if cid is not None:
                self._reply_err(cid, WorkerFencedError(str(exc)))
            return
        op = frame.get("op")
        handler = self._VERBS.get(op)  # type: ignore[arg-type]
        if handler is None:
            if cid is not None:
                self._reply_err(cid, ValueError(f"unknown verb {op!r}"))
            return
        if op in self._SLOW_VERBS:
            threading.Thread(
                target=self._run_verb,
                args=(handler, frame, cid),
                daemon=True,
                name=f"vgt-worker-{op}",
            ).start()
        else:
            # fast verbs run inline on the reader thread — ping latency
            # IS the liveness signal, it must not queue behind warmup
            self._run_verb(handler, frame, cid)

    def _run_verb(self, handler, frame: Dict[str, Any], cid: Any) -> None:
        try:
            data = handler(self, frame)
        except BaseException as exc:  # noqa: BLE001 — must reach the wire
            if cid is not None:
                self._reply_err(cid, exc)
            else:
                logger.error(
                    "notification verb failed",
                    extra={"extra_data": {"op": frame.get("op")}},
                    exc_info=True,
                )
            return
        if cid is not None:
            self._reply(cid, data)

    # -------------------------------------------------------------- serve

    def serve(self, listener: socket.socket) -> None:
        """Accept the gateway connection and serve frames until EOF,
        protocol violation, or drain.  At ``pod.orphan_grace_s == 0``
        (the default) that is the end of the process — the gateway
        respawns a fresh incarnation; this process never serves two
        connections.  With a grace > 0, EOF enters orphan mode instead
        and the listener stays open so a successor gateway can
        re-accept and adopt this incarnation; the process exits only
        when the grace expires unclaimed (or on drain/stop)."""
        sender = threading.Thread(
            target=self._sender_loop, daemon=True, name="vgt-worker-send"
        )
        sender.start()
        self._write_registry("serving")
        threading.Thread(
            target=self._registry_beat_loop, daemon=True,
            name="vgt-worker-beat",
        ).start()
        listener.settimeout(1.0)
        try:
            while not self._stopping.is_set():
                conn: Optional[socket.socket] = None
                while conn is None and not self._stopping.is_set():
                    if (
                        self._orphaned
                        and self._orphan_deadline is not None
                        and time.monotonic() >= self._orphan_deadline
                    ):
                        logger.warning(
                            "orphan grace expired unclaimed; draining"
                        )
                        self.drain(reason="orphan_expired")
                        return
                    try:
                        conn, _ = listener.accept()
                    except socket.timeout:
                        continue
                if conn is None:
                    return
                if self.orphan_grace_s <= 0:
                    # pre-orphan contract, byte-identical: one
                    # connection for the process lifetime
                    listener.close()
                self._conn = conn
                reason = self._read_conn(conn)
                if self._stopping.is_set():
                    return
                if self.orphan_grace_s <= 0:
                    # grace-0 gateway EOF still routes through the
                    # drain fold so the registry keeps post-mortem
                    # evidence (final checkpoint summary + exit reason)
                    self.drain(reason="gateway_eof")
                    return
                self._enter_orphan_mode(reason)
        finally:
            self.shutdown()

    def _read_conn(self, conn: socket.socket) -> str:
        """Serve one gateway connection until EOF / violation / stop;
        returns why the read loop ended."""
        while not self._stopping.is_set():
            try:
                frame = rpc.recv_frame(conn, self.max_frame_bytes)
            except rpc.FrameError:
                logger.error(
                    "frame protocol violation from gateway; "
                    "tearing down",
                    exc_info=True,
                )
                return "frame_error"
            except OSError:
                return "socket_error"
            if frame is None:
                return "gateway_eof"  # gateway closed: orphaned/replaced
            self._dispatch(frame)
        return "stopping"

    def drain(self, reason: str = "sigterm") -> None:
        """The one checkpoint-fold exit path — SIGTERM, gateway EOF at
        grace 0, and orphan-grace expiry all route through it:
        checkpoint residents, ship them to the gateway (``evacuated``
        notification — buffered when there is no gateway left), write
        the final checkpoint summary + exit reason into the registry
        record (post-mortem evidence even when nobody is listening),
        then stop.  Worker-loss during a pod drain therefore degrades
        exactly like ``_redistribute`` — the gateway replays from its
        own request state either way."""
        try:
            out = self._verb_evacuate({"reason": reason, "timeout_s": 10.0})
        except Exception:
            logger.warning("drain evacuation failed", exc_info=True)
            out = {"evacuated": []}
        summary = [
            {
                "sid": ck.get("sid"),
                "request_id": ck.get("request_id"),
                "generated_tokens": ck.get("generated_tokens"),
            }
            for ck in out.get("evacuated") or []
        ]
        self._exit_reason = self._exit_reason or reason
        self._write_registry(
            "exited", exit_reason=self._exit_reason, checkpoints=summary
        )
        self._exit_recorded = True
        self._enqueue({"op": "evacuated", "reason": reason, **out})
        # let the sender flush before teardown
        deadline = time.monotonic() + 2.0
        while not self._send_q.empty() and time.monotonic() < deadline:
            time.sleep(0.01)
        self._stopping.set()

    def shutdown(self) -> None:
        self._stopping.set()
        if not self._exit_recorded:
            self._exit_recorded = True
            self._write_registry(
                "exited",
                exit_reason=self._exit_reason or "shutdown",
                checkpoints=[],
            )
        self._teardown_conn()
        self._send_q.put(None)
        try:
            self.engine.stop()
        except Exception:
            pass
        # release any waiter threads whose sequences will never settle
        with self._seq_lock:
            for entry in self._seqs.values():
                entry.cancelled = True
            self._seqs.clear()


def _bind_listener(args: argparse.Namespace) -> socket.socket:
    if args.socket:
        try:
            os.unlink(args.socket)
        except FileNotFoundError:
            pass
        listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        listener.bind(args.socket)
    else:
        listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        listener.bind(("127.0.0.1", args.port))
    listener.listen(1)
    return listener


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        description="vgate-tpu PyTorch/CUDA engine worker process"
    )
    group = parser.add_mutually_exclusive_group(required=True)
    group.add_argument("--socket", help="unix-domain socket path to bind")
    group.add_argument("--port", type=int, help="localhost TCP port to bind")
    parser.add_argument(
        "--epoch", type=int, required=True,
        help="fencing epoch of this incarnation (gateway-assigned)",
    )
    parser.add_argument(
        "--config", required=True,
        help="resolved gateway config, JSON (pod.workers forced to 0)",
    )
    parser.add_argument("--index", type=int, default=0, help="worker slot")
    parser.add_argument(
        "--registry-dir", default=None,
        help="directory for the worker registry record (orphan "
        "adoption); defaults to the socket's directory for UDS",
    )
    args = parser.parse_args(argv)

    with open(args.config) as fh:
        config: VGTConfig = config_from_dict(json.load(fh))
    # belt and braces: a worker must never recurse into pod mode, and a
    # worker process hosts exactly one engine
    config.pod.workers = 0
    config.device.dp = 1
    set_config(config)
    faults.arm_from_env()

    if os.environ.get("VGT_MEMTRACE"):
        # drill/test span evidence: record this process's spans so the
        # ``spans`` verb can export them for parentage assertions
        global _MEMTRACE
        try:
            from vgate_tpu_torch.observability.memtrace import (
                MemorySpanRecorder,
            )

            _MEMTRACE = MemorySpanRecorder().install()
        except Exception:
            logger.warning(
                "VGT_MEMTRACE set but span recorder install failed",
                exc_info=True,
            )

    logging.basicConfig(
        level=logging.INFO,
        format=(
            f"%(asctime)s worker[{args.index}"
            f".e{args.epoch}] %(levelname)s %(name)s: %(message)s"
        ),
        stream=sys.stderr,
    )

    registry_dir = args.registry_dir
    if registry_dir is None and args.socket:
        registry_dir = os.path.dirname(os.path.abspath(args.socket))
    address = args.socket or f"127.0.0.1:{args.port}"

    listener = _bind_listener(args)
    server = WorkerServer(
        config, epoch=args.epoch, index=args.index,
        registry_dir=registry_dir, address=address,
    )

    def _on_sigterm(signum, _frame) -> None:
        threading.Thread(
            target=server.drain, daemon=True, name="vgt-worker-drain"
        ).start()

    signal.signal(signal.SIGTERM, _on_sigterm)
    try:
        server.serve(listener)
    finally:
        server.shutdown()
        if args.socket:
            try:
                os.unlink(args.socket)
            except OSError:
                pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
