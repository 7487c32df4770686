"""Gateway-side pod of process-isolated engine workers.

``pod.workers > 0`` replaces the in-process engine stack behind the
backend seam with this router: N worker *processes* (each running the
full EngineCore/EngineSupervisor stack — runtime/worker.py), reached
over the length-prefixed frame protocol (runtime/rpc.py) on unix-domain
or localhost-TCP sockets.  On one card the workers share it, each in
its own CUDA context: an illegal address poisons one context for good,
so only a process boundary contains it — the worker is declared lost,
respawned in a fresh context, and its streams replay on a survivor.
The pod builds every kernel before the first spawn, and writes each
worker's share of the card (``device.kv_budget_bytes``) into the
worker config, so N pools never oversubscribe the card.

PodEngine presents the reference's ``ReplicatedEngine`` surface —
submit/stream/abort, health/stats/pressure, /admin/replicas drain — so
the backend, batcher, admission, metrics and the server never learn
which mode they are in; ``pod.workers = 0`` keeps the in-process path.

Robustness contracts (the point of the process boundary):

* **Heartbeat liveness** — a monitor thread pings every worker at
  ``pod.heartbeat_interval_s``; the worker's engine beat rides back on
  each ping and is judged with the supervisor's classifier
  (``recovery.step_stall_s`` / ``compile_grace_s``), so a first-compile
  pause never reads as death.  No successful ping for
  ``pod.heartbeat_timeout_s`` → the worker is declared lost.
* **Fencing epochs** — every incarnation of a worker slot gets a
  monotonically-increasing epoch; declaring a worker lost bumps the
  slot's epoch IMMEDIATELY, so every late frame from the zombie
  (token, done, reply) mis-stamps against the current epoch and is
  discarded and counted (``vgt_pod_fenced_frames``) instead of
  corrupting the replacement's token streams — the supervisor's stale-wake
  epoch guard, cross-process.
* **Zero-5xx worker loss** — the gateway holds every in-flight
  request's full state (prompt + generated so far), so a crash/kill -9
  /heartbeat loss folds each affected sequence (``prepare_resume``,
  the supervisor's checkpoint fold) and resubmits it to a survivor; RNG
  continuation is implicit (see SequenceCheckpoint), so greedy and
  seeded streams stay token-identical.  Only an exhausted resume
  budget or a fully-dead pod surfaces the typed retryable
  ``WorkerLostError``.
* **Supervised respawn + canary gate** — losses draw on the SAME
  sliding restart budget dp uses (``recovery.max_restarts`` /
  ``restart_window_s``, shared across slots: one sick pod, one
  budget), respawns back off exponentially, and a respawned worker
  must answer the pinned-greedy canary with the pod's recorded
  fingerprint before it becomes routable.
* **Drain / migrate per worker** — /admin/replicas drain maps to the
  ``evacuate`` RPC verb; the returned sequences replay onto survivors
  exactly like dp's ``_redistribute`` (``prepare_migrate``: never
  spends the crash-resume budget).  A worker dying mid-drain falls
  back to the loss path — same fold, same replay, crash counters.
* **Disaggregated prefill/decode pools** (``pod.roles``) — workers can
  be pinned ``prefill`` / ``decode`` / ``mixed``.  New requests route
  to the prefill pool; when the prefill finishes, the worker folds the
  sequence and stages its KV through the host swap pool, and the
  gateway runs an epoch-fenced, checksummed, chunked pull transfer to
  the least-loaded decode worker (runtime/handoff.py state machine:
  PREFILLING → STAGED → TRANSFERRING → ACCEPTED → DECODING).  Every
  failure mode degrades, never 5xxs: transfer garble/timeout retries
  then falls back to *monolithic* decode on the prefill worker
  (swap-in, zero recompute); prefill death mid-transfer re-prefills on
  a survivor via the normal loss path; decode death after ACCEPTED
  rides the existing checkpoint-fold failover.  Tokens stay identical
  either way.
"""

from __future__ import annotations

import base64
import binascii
import dataclasses
import itertools
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import zlib
from collections import deque
from types import SimpleNamespace
from typing import (
    Any,
    Callable,
    Dict,
    List,
    Optional,
    Sequence as Seq,
    Tuple,
)

import torch

from vgate_tpu_torch import faults, tracing
from vgate_tpu_torch.config import VGTConfig, get_config
from vgate_tpu_torch.errors import (
    HandoffStaleError,
    HandoffTransferError,
    MigrationRefusedError,
    ResumeExhaustedError,
    WorkerLostError,
    raise_for_state,
    state_is_alive,
    state_is_ready,
)
from vgate_tpu_torch.logging_config import get_logger
from vgate_tpu_torch.models.specs import spec_for_model_id
from vgate_tpu_torch.observability import perf as perf_attr
from vgate_tpu_torch.runtime import engine_metrics as metrics
from vgate_tpu_torch.runtime import handoff as handoff_mod
from vgate_tpu_torch.backends.base import SamplingParams
from vgate_tpu_torch.runtime.sequence import Sequence, SeqStatus
from vgate_tpu_torch.runtime.supervisor import (
    HealthState,
    classify_heartbeat,
    restart_budget_remaining,
)
from vgate_tpu_torch.runtime.tokenizer import get_tokenizer
from vgate_tpu_torch.runtime.worker import params_to_wire, unwire_error
from vgate_tpu_torch.runtime.worker_client import WorkerClient

logger = get_logger(__name__)

# Threading contract (the reference's thread-discipline checker).
# ONE reentrant pod lock guards topology (worker handles, epochs) and
# the in-flight table together — loss handling moves sequences between
# both atomically.  RPC calls NEVER run under it (snapshot-then-call),
# so a wedged worker can stall an RPC thread but never the pod lock.
VGT_COMPONENTS: Dict[str, str] = {}
VGT_LOCK_GUARDS = {
    "_inflight": "_lock",
    "_orphans": "_lock",
    "_restart_times": "_lock",
    "_handoffs": "_lock",
    "_req_ledger": "_lock",
    "_flight_cache": "_lock",
    "_last_crash": "_lock",
    "_adopted_sids": "_lock",
    "adopted_request_ids": "_lock",
    "adopted_results": "_lock",
}

# spawn-time connect poll cadence (the worker binds its listener before
# building the engine, so the socket appears in milliseconds; the slow
# part — engine build — is budgeted by the hello call's timeout)
_CONNECT_POLL_S = 0.05

# an orphan's registry beat refreshes every second; a record older than
# this with a live pid means the process is wedged, not adoptable
_ADOPT_BEAT_FRESH_S = 10.0


def _pc_to_ns(pc: float) -> int:
    """Epoch nanoseconds for a (recent) perf_counter reading — the same
    anchoring reqtrace's _NsClock does, re-anchored per call so gateway
    handoff spans carry real wall timestamps without a long-lived
    clock object per transfer."""
    return time.time_ns() + int((pc - time.perf_counter()) * 1e9)


class _PodSequence(Sequence):
    """Gateway-side sequence whose abort propagates to the owning
    worker.  Inherits the dataclass-generated ``__init__``; the pod
    wiring rides on class-level defaults overwritten per instance."""

    _pod: Optional["PodEngine"] = None
    _sid: int = -1
    _worker_idx: int = -1
    # the gateway's captured OTel context (the HTTP span rides in it)
    # and its W3C encoding — stamped on every submit / handoff_commit
    # frame so worker engine spans parent onto the HTTP span
    _trace_ctx: Any = None
    _traceparent: Optional[str] = None

    def request_abort(self, reason: str = "client_disconnect") -> None:
        super().request_abort(reason)
        pod = self._pod
        if pod is not None:
            pod._abort_remote(self, reason)


class _Worker:
    """One worker slot's handle: process + connection + incarnation."""

    def __init__(self, idx: int) -> None:
        self.idx = idx
        self.epoch = 0  # bumps on every (re)spawn AND on declared loss
        self.proc: Optional[subprocess.Popen] = None
        self.client: Optional[WorkerClient] = None
        self.hello: Dict[str, Any] = {}
        # down | spawning | serving | dead (budget exhausted)
        self.state = "down"
        self.draining = False
        self.last_fatal: Optional[str] = None
        self.last_ping: Dict[str, Any] = {}
        self.last_ok_t = time.monotonic()
        self.respawning = False
        self.address: Any = None

    @property
    def alive(self) -> bool:
        return self.state == "serving"


def _pid_alive(pid: int) -> bool:
    """Signal-0 liveness probe.  EPERM means the pid exists but isn't
    ours to signal — still alive for adoption purposes."""
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except OSError:
        return True
    return True


class _AdoptedProc:
    """Popen-shaped handle for a worker process this gateway did NOT
    spawn (an orphan adopted from a crashed predecessor's registry).

    The adopted worker is not our child, so ``waitpid`` semantics are
    unavailable; every Popen surface the pod machinery touches —
    ``pid``, ``poll()``, ``returncode``, ``terminate()``, ``kill()``,
    ``wait(timeout)`` — is re-implemented over signal-0 probes so the
    monitor, loss path, ``_kill_proc`` and ``stop()`` treat adopted and
    spawned incarnations identically."""

    __slots__ = ("pid", "returncode")

    def __init__(self, pid: int) -> None:
        self.pid = pid
        self.returncode: Optional[int] = None

    def poll(self) -> Optional[int]:
        if self.returncode is None and not _pid_alive(self.pid):
            # exit status belongs to whoever reaps it (init); -1 marks
            # "gone, status unknown" without pretending to know more
            self.returncode = -1
        return self.returncode

    def _signal(self, sig: int) -> None:
        try:
            os.kill(self.pid, sig)
        except OSError:
            pass

    def terminate(self) -> None:
        self._signal(signal.SIGTERM)

    def kill(self) -> None:
        self._signal(signal.SIGKILL)

    def wait(self, timeout: Optional[float] = None) -> int:
        deadline = (
            None if timeout is None else time.monotonic() + timeout
        )
        while self.poll() is None:
            if deadline is not None and time.monotonic() >= deadline:
                raise subprocess.TimeoutExpired(
                    f"adopted pid {self.pid}", timeout or 0.0
                )
            time.sleep(0.05)
        return self.returncode  # type: ignore[return-value]


class _SourceLost(Exception):
    """Internal marker: the prefill-side connection died mid-transfer.
    The pod loss path owns the sequence (fold + replay on a survivor);
    the transfer thread just stands down."""


class _HandoffRec:
    """Gateway-side record of one prefill→decode handoff transaction
    (state machine in runtime/handoff.py).  Guarded by the pod lock;
    the transfer thread snapshots under it and calls outside it.

    ``buffered``/``terminal`` absorb frames the decode target emits
    between its commit landing and the gateway flipping sequence
    ownership — they replay in order at accept so the client stream
    never drops or reorders a token."""

    __slots__ = (
        "sid", "seq", "prefill_idx", "prefill_epoch", "state",
        "cancelled", "target_idx", "buffered", "terminal", "pages",
        "nbytes", "base_len", "generated_ids", "resume_count",
        "migrate_count", "preempt_count", "swap_count", "kv_dtype",
        "attempts", "t0", "t_staged_pc", "t_transfer_pc",
    )

    def __init__(
        self, sid: int, seq: "_PodSequence", prefill_idx: int,
        prefill_epoch: int,
    ) -> None:
        self.sid = sid
        self.seq = seq
        self.prefill_idx = prefill_idx
        self.prefill_epoch = prefill_epoch
        self.state = handoff_mod.PREFILLING
        self.cancelled = False
        self.target_idx = -1
        self.buffered: List[Dict[str, Any]] = []
        self.terminal: Optional[Any] = None
        self.pages = 0
        self.nbytes = 0
        self.base_len = 0
        self.generated_ids: List[int] = []
        self.resume_count = 0
        self.migrate_count = 0
        self.preempt_count = 0
        self.swap_count = 0
        self.kv_dtype: Optional[str] = None
        self.attempts = 0
        self.t0 = time.monotonic()
        # state-dwell anchors (perf_counter, for span timestamps and
        # vgt_handoff_state_seconds attribution)
        self.t_staged_pc = 0.0
        self.t_transfer_pc = 0.0


class _PodFlight:
    """dp's ``_MergedFlight`` across PROCESS boundaries: fans the worker
    ``flight`` / ``requests`` verbs out to live workers and merges the
    rings by wall time, stamping every entry with its worker index and
    fencing epoch.  Each successful fetch refreshes a per-slot cache;
    when a slot's live view is unavailable (the incarnation crashed, was
    SIGKILLed, or was fenced out on heartbeat loss) the cached entries
    are still merged, marked ``fenced: true`` — the dead incarnation's
    last-known timeline is exactly what a post-mortem needs.  Request
    records additionally get the gateway's per-request handoff ledger
    grafted on (``transfer_s``, outcome, worker pair) so disaggregated
    TTFT decomposes into queue → prefill → transfer → decode.

    Gateway-side events (the batcher's overload tick) land in a local
    ring stamped ``worker: "gateway"`` — there is no RPC verb for
    writing ticks, and the event genuinely happened in this process."""

    def __init__(self, pod: "PodEngine") -> None:
        self._pod = pod
        self._gateway_ticks: "deque[Dict[str, Any]]" = deque(maxlen=512)
        self._tick_counter = itertools.count()

    @property
    def enabled(self) -> bool:
        return bool(self._pod.config.observability.enabled)

    def record_tick(self, kind: str, **fields: Any) -> None:
        if not self.enabled:
            return
        entry: Dict[str, Any] = {
            "n": next(self._tick_counter),
            "t": time.time(),
            "kind": kind,
            "worker": "gateway",
        }
        entry.update(fields)
        self._gateway_ticks.append(entry)

    # ------------------------------------------------------------ fetch

    def _fetch(self) -> List[Dict[str, Any]]:
        """One fan-out round: per worker slot, the live reply (cache
        refreshed under the pod lock) or the cached snapshot of an
        unreachable/fenced incarnation."""
        pod = self._pod
        views: Dict[int, Dict[str, Any]] = {}
        for w in pod._alive_workers():
            client = w.client
            if client is None:
                continue
            try:
                flight = client.call("flight", n=1024)
                reqs = client.call("requests", n=1024)
            except Exception:  # noqa: BLE001 — introspection best-effort
                continue
            view = {
                "worker": w.idx, "epoch": w.epoch, "fenced": False,
                "ticks": flight.get("ticks") or [],
                "stats": flight.get("stats") or {},
                "live": reqs.get("live") or [],
                "completed": reqs.get("completed") or [],
            }
            views[w.idx] = view
            with pod._lock:
                pod._flight_cache[w.idx] = view
        with pod._lock:
            cached = dict(pod._flight_cache)
        for idx, view in cached.items():
            if idx in views:
                continue
            w = pod.workers[idx]
            stale = dict(view)
            stale["fenced"] = (
                not w.alive or stale.get("epoch") != w.epoch
            )
            views[idx] = stale
        return [views[i] for i in sorted(views)]

    def _stamp(
        self, entry: Dict[str, Any], view: Dict[str, Any], graft: bool
    ) -> Dict[str, Any]:
        entry = dict(entry)
        entry["worker"] = view["worker"]
        entry["epoch"] = view["epoch"]
        if view["fenced"]:
            entry["fenced"] = True
        if graft:
            self._graft(entry)
        return entry

    def _graft(self, rec: Dict[str, Any]) -> None:
        """Attach the gateway's handoff ledger entry (transfer_s, the
        handoff outcome, the prefill/decode worker pair) to a request
        record — the worker-side recorder cannot know any of it."""
        rid = rec.get("request_id")
        if not rid:
            return
        with self._pod._lock:
            note = self._pod._req_ledger.get(rid)
            note = dict(note) if note else None
        if note:
            rec.update(note)

    def _merged(
        self, key: str, n: Optional[int], graft: bool = False
    ) -> List[Dict[str, Any]]:
        out = []
        for view in self._fetch():
            for entry in view[key]:
                out.append(self._stamp(entry, view, graft))
        if key == "ticks":
            out.extend(dict(e) for e in self._gateway_ticks)
        out.sort(key=lambda e: e.get("t") or e.get("arrival_t") or 0.0)
        if n is not None and n >= 0:
            out = out[-n:]
        return out

    # --------------------------------------- FlightRecorder's surface

    def ticks(self, n: Optional[int] = None) -> List[Dict[str, Any]]:
        return self._merged("ticks", n)

    def requests(self, n: Optional[int] = None) -> List[Dict[str, Any]]:
        return self._merged("completed", n, graft=True)

    def live_requests(self) -> List[Dict[str, Any]]:
        return self._merged("live", None, graft=True)

    def find_request(self, ident: str) -> Optional[Dict[str, Any]]:
        # newest attempt wins ACROSS workers too (a handoff or failover
        # leaves records for the same request id on several workers)
        best: Optional[Dict[str, Any]] = None
        for view in self._fetch():
            for key in ("live", "completed"):
                for rec in view[key]:
                    if ident not in (
                        rec.get("request_id"),
                        rec.get("trace_id"),
                        str(rec.get("seq_id")),
                    ):
                        continue
                    rec = self._stamp(rec, view, graft=True)
                    if best is None or (rec.get("arrival_t") or 0.0) >= (
                        best.get("arrival_t") or 0.0
                    ):
                        best = rec
        return best

    def get_stats(self) -> Dict[str, Any]:
        return {
            "enabled": self.enabled,
            "workers": [
                {
                    "worker": v["worker"],
                    "epoch": v["epoch"],
                    "fenced": v["fenced"],
                    **(v["stats"] or {}),
                }
                for v in self._fetch()
            ],
        }


class PodEngine:
    """ReplicatedEngine's surface over worker processes."""

    def __init__(self, config: Optional[VGTConfig] = None) -> None:
        self.config = config or get_config()
        pod = self.config.pod
        if pod.workers < 1:
            raise ValueError("PodEngine requires pod.workers >= 1")
        self._pod_cfg = pod
        self._recovery = self.config.recovery
        # disaggregated pools: roles default to all-mixed, which keeps
        # routing and submission byte-identical to a role-less pod
        self._roles: List[str] = (
            list(pod.roles) if pod.roles else ["mixed"] * pod.workers
        )
        self._roles_active = any(r != "mixed" for r in self._roles)
        self.spec = spec_for_model_id(self.config.model.model_id)
        self.tokenizer = get_tokenizer(
            self.spec,
            self.config.model.tokenizer_path
            or self.config.model.checkpoint_path,
        )
        self._lock = threading.RLock()
        # the backend holds it while it queues one batch (EngineCore's
        # wave lock); here it only keeps a batch's sids consecutive
        self._submit_lock = threading.Lock()
        self.device = torch.device(self.config.device.device)
        self._inflight: Dict[int, _PodSequence] = {}
        self._orphans: List[_PodSequence] = []
        self._handoffs: Dict[int, _HandoffRec] = {}
        # per-request gateway annotations (KV-handoff transfer_s and
        # outcome) grafted onto merged flight records; insertion-ordered
        # dict with FIFO eviction so it stays bounded
        self._req_ledger: Dict[str, Dict[str, Any]] = {}
        self._ledger_cap = 2048
        # last-known per-slot flight snapshot (refreshed on every
        # /debug scrape) — survives the incarnation so a crashed
        # worker's timeline stays inspectable, epoch-marked
        self._flight_cache: Dict[int, Dict[str, Any]] = {}
        # gateway-synthesized post-mortem for the most recent worker
        # loss (same shape as FlightRecorder.crash_snapshot)
        self._last_crash: Optional[Dict[str, Any]] = None
        self._tracer = tracing.get_tracer("vgate_tpu_torch.pod")
        self._flight = _PodFlight(self)
        self._sids = itertools.count(1)
        self._rr = itertools.count()
        self._xfer_ids = itertools.count(1)
        self._restart_times: List[float] = []
        self._fenced_clients: List[WorkerClient] = []
        self._zombie_procs: List[subprocess.Popen] = []
        self._stopping = False
        self._monitor: Optional[threading.Thread] = None
        self.total_failovers = 0
        self.total_restarts = 0
        self.total_stalls = 0
        self.total_resumed = 0
        self.total_migrated = 0
        self.total_lost = 0
        self.fenced_frames = 0
        self.total_handoffs = 0
        self.total_handoff_fallbacks = 0
        self.total_handoff_failed = 0
        self._canary_expected: Optional[str] = None
        # gateway-crash survivability (pod.orphan_grace_s): workers
        # adopted from a predecessor's registry instead of respawned
        self.total_adopted = 0
        self.total_orphans_found = 0
        self.total_orphans_expired = 0
        # sid floor across concurrent adoptions — fresh sids must start
        # above every sid the predecessor ever issued to an adoptee
        self._sid_floor = 1
        # sids whose sequence is an adopted SHELL: the gateway holds no
        # prompt for them, so they can finish or fail typed but never
        # replay onto a survivor
        self._adopted_sids: set = set()
        # request_id → sid for adopted in-flight work; app.py reconciles
        # its journal's pending records against this at startup
        self.adopted_request_ids: Dict[str, int] = {}
        # app.py hook: (request_id, result|None, error|None), fired when
        # an adopted shell settles so the journal can settle/fail the
        # matching idempotency record.  Settles that land BEFORE the
        # hook is attached (a short decode finishing during boot) park
        # in adopted_results until drain_adopted_results() collects
        # them — results must never race the app's startup wiring.
        self.on_adopted_done: Optional[
            Callable[[str, Optional[Dict[str, Any]], Optional[str]], Any]
        ] = None
        self.adopted_results: Dict[
            str, Tuple[Optional[Dict[str, Any]], Optional[str]]
        ] = {}

        self._own_socket_dir = not pod.socket_dir
        self.socket_dir = pod.socket_dir or tempfile.mkdtemp(
            prefix="vgt-pod-"
        )
        self._config_path = self._write_worker_config()
        self.workers = [_Worker(i) for i in range(pod.workers)]
        try:
            self._build_kernels()
            self._boot_all()
        except BaseException:
            self.stop()
            raise
        lead = self.workers[0].hello
        # the backend seam logs core.mesh.shape.items() and
        # core.geometry.num_pages; present the lead worker's view plus
        # the pod axis, like dp presents dp=N
        self.mesh = SimpleNamespace(
            shape=dict(lead.get("mesh", {}), workers=pod.workers)
        )
        geo = lead.get("geometry", {})
        self.geometry = SimpleNamespace(
            num_pages=int(geo.get("num_pages", 0)) * pod.workers,
            page_size=int(geo.get("page_size", 0)),
            kv_dtype=geo.get("kv_dtype"),
        )
        self.load_time_s = sum(
            float(w.hello.get("load_time_s", 0.0)) for w in self.workers
        )
        logger.info(
            "pod engine ready",
            extra={
                "extra_data": {
                    "workers": pod.workers,
                    "transport": pod.transport,
                    "model": self.spec.name,
                }
            },
        )

    # ------------------------------------------------------------ boot

    def _write_worker_config(self) -> str:
        """Dump the RESOLVED gateway config for workers (JSON, read by
        ``config.config_from_dict``).  Workers must not recurse into pod
        mode and host exactly one engine.  On a card that the workers
        share, each gets a fixed share of it (``kv_budget_bytes``) to
        size its pool against, unless the pool size is explicit."""
        dump = dataclasses.asdict(self.config)
        dump["pod"]["workers"] = 0
        # roles are gateway routing state; a one-engine worker config
        # with roles but workers=0 would fail the per-worker validator
        dump["pod"]["roles"] = []
        dump["device"]["dp"] = 1
        dev = dump["device"]
        if (
            self.device.type == "cuda"
            and not dev["kv_num_pages"]
            and not dev["kv_budget_bytes"]
        ):
            total = torch.cuda.get_device_properties(
                self.device
            ).total_memory
            dev["kv_budget_bytes"] = int(
                dev["hbm_utilization"] * total / self._pod_cfg.workers
            )
        if self._roles_active:
            # both sides of a KV handoff need the pinned host swap
            # pool (prefill stages out of it, decode adopts into it);
            # floor it at the transfer staging budget so roles work
            # without the operator separately enabling host swap
            dump["kv_cache"]["host_swap_bytes"] = max(
                int(dump["kv_cache"].get("host_swap_bytes") or 0),
                int(dump["pod"].get("transfer_staging_bytes") or 0),
            )
        fd, path = tempfile.mkstemp(
            prefix="vgt-worker-cfg-", suffix=".json", dir=self.socket_dir
        )
        with os.fdopen(fd, "w") as fh:
            json.dump(dump, fh)
        return path

    def _build_kernels(self) -> None:
        """On the card: every kernel built (one ``nvcc`` a source, all
        at once) before the first worker boots, so N cold workers never
        each compile them inside ``spawn_timeout_s``; the workers load
        the cached libraries.  A build that fails fails the boot."""
        if self.device.type != "cuda":
            return
        from vgate_tpu_torch.ops.kernels import _build

        report = _build.build()
        logger.info(
            "pod kernels built",
            extra={"extra_data": {
                name: round(r["seconds"], 2) for name, r in report.items()
            }},
        )

    def _boot_all(self) -> None:
        errors: List[BaseException] = []
        adoptable = self._scan_registry()

        def boot(w: _Worker) -> None:
            try:
                rec = adoptable.get(w.idx)
                if rec is not None:
                    try:
                        self._try_adopt(w, rec)
                        return
                    except BaseException as exc:  # noqa: BLE001
                        # adoption is best-effort: fence + kill the
                        # orphan and fall through to a fresh spawn
                        logger.warning(
                            "worker adoption failed; respawning",
                            extra={
                                "extra_data": {
                                    "worker": w.idx,
                                    "pid": rec.get("pid"),
                                    "error": str(exc),
                                }
                            },
                        )
                        self._abandon_adoption(w, rec)
                self._spawn_and_gate(w)
            except BaseException as exc:  # noqa: BLE001 — collected
                errors.append(exc)

        threads = [
            threading.Thread(
                target=boot, args=(w,), daemon=True,
                name=f"vgt-pod-boot-{w.idx}",
            )
            for w in self.workers
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=self._pod_cfg.spawn_timeout_s + 30.0)
        if errors:
            raise RuntimeError(
                f"pod boot failed: {errors[0]}"
            ) from errors[0]
        if any(not w.alive for w in self.workers):
            raise RuntimeError("pod boot failed: worker never became ready")

    def _worker_env(self, w: _Worker) -> Dict[str, str]:
        env = dict(os.environ)
        # `-m vgate_tpu_torch.runtime.worker` must resolve THIS package
        # no matter what cwd the gateway was launched from
        import vgate_tpu_torch as _pkg

        pkg_root = os.path.dirname(os.path.dirname(_pkg.__file__))
        paths = env.get("PYTHONPATH", "")
        if pkg_root not in paths.split(os.pathsep):
            env["PYTHONPATH"] = (
                pkg_root + (os.pathsep + paths if paths else "")
            )
        # the gateway's own chaos config must not leak into workers —
        # a fault armed for the gateway wire would double-fire
        env.pop("VGT_FAULTS", None)
        env.pop("VGT_CHAOS", None)
        # drills target a SPECIFIC worker's FIRST incarnation:
        # VGT_POD_WORKER_FAULTS="0=decode_step:raise;1=rpc_send:delay:delay=30"
        # (respawned incarnations boot clean — the fault made its point)
        spec = os.environ.get("VGT_POD_WORKER_FAULTS", "")
        if spec and w.epoch == 1:
            for part in spec.split(";"):
                if "=" not in part:
                    continue
                idx_s, fault = part.split("=", 1)
                try:
                    if int(idx_s) == w.idx:
                        env["VGT_FAULTS"] = fault
                except ValueError:
                    continue
        return env

    def _spawn(self, w: _Worker) -> None:
        """Launch one worker incarnation (caller holds no RPCs; the
        epoch was already bumped by the caller)."""
        pod = self._pod_cfg
        if pod.transport == "uds":
            path = os.path.join(
                self.socket_dir, f"w{w.idx}.e{w.epoch}.sock"
            )
            w.address = path
            sock_args = ["--socket", path]
        else:
            # TCP reuses a stable per-slot port, so any previous
            # incarnation still bound to it must die first
            port = pod.port_base + w.idx
            w.address = ("127.0.0.1", port)
            sock_args = ["--port", str(port)]
        cmd = [
            pod.python or sys.executable,
            "-m",
            "vgate_tpu_torch.runtime.worker",
            *sock_args,
            "--epoch",
            str(w.epoch),
            "--config",
            self._config_path,
            "--index",
            str(w.idx),
            # liveness/adoption registry rides in the shared socket dir
            # so a successor gateway (stable pod.socket_dir) finds it
            "--registry-dir",
            self.socket_dir,
        ]
        w.proc = subprocess.Popen(cmd, env=self._worker_env(w))
        logger.info(
            "spawned engine worker",
            extra={
                "extra_data": {
                    "worker": w.idx, "epoch": w.epoch, "pid": w.proc.pid,
                }
            },
        )

    def _connect(self, w: _Worker) -> WorkerClient:
        """Connect to the freshly-spawned worker: poll until its
        listener exists (bound before the engine builds, so this is
        fast), bounded by spawn_timeout_s; a worker that dies while we
        wait fails immediately instead of burning the budget."""
        pod = self._pod_cfg
        deadline = time.monotonic() + pod.spawn_timeout_s
        epoch = w.epoch
        idx = w.idx
        last: Optional[BaseException] = None
        while time.monotonic() < deadline:
            if w.proc is not None and w.proc.poll() is not None:
                raise WorkerLostError(
                    f"worker {idx} (epoch {epoch}) exited with "
                    f"{w.proc.returncode} during boot"
                )
            try:
                return WorkerClient(
                    w.address,
                    epoch,
                    max_frame_bytes=pod.max_frame_bytes,
                    connect_timeout_s=pod.connect_timeout_s,
                    call_timeout_s=pod.call_timeout_s,
                    on_notify=lambda f, i=idx, e=epoch: self._on_frame(
                        i, e, f
                    ),
                    on_lost=lambda exc, i=idx, e=epoch: self._on_lost(
                        i, e, exc
                    ),
                    label=f"worker{idx}.e{epoch}",
                )
            except (FileNotFoundError, ConnectionRefusedError, OSError) as exc:
                last = exc
                time.sleep(_CONNECT_POLL_S)
        raise WorkerLostError(
            f"worker {idx} (epoch {epoch}) never accepted a connection "
            f"within {pod.spawn_timeout_s:.0f}s: {last}"
        ) from last

    def _spawn_and_gate(self, w: _Worker) -> None:
        """Spawn → connect → hello → canary gate → routable.  Raises on
        any step failing; the caller owns retry/budget policy."""
        with self._lock:
            w.epoch += 1
            w.state = "spawning"
            w.draining = False
        self._spawn(w)
        client = self._connect(w)
        try:
            hello = client.call(
                "hello", timeout=self._pod_cfg.spawn_timeout_s
            )
            self._canary_gate(w, client)
        except BaseException:
            client.close()
            raise
        with self._lock:
            w.client = client
            w.hello = hello
            w.last_ok_t = time.monotonic()
            w.last_fatal = None
            w.state = "serving"
        self._set_alive_gauge()
        self._drain_orphans()

    def _canary_gate(self, w: _Worker, client: WorkerClient) -> None:
        """Pinned-greedy gate before the worker becomes routable:
        identical weights + greedy decode ⇒ identical fingerprint
        across every worker and every incarnation.  First answer
        records; every later one must match."""
        icfg = self.config.integrity
        timeout = (
            icfg.canary_timeout_s + icfg.canary_compile_grace_s + 30.0
        )
        reply = client.call("canary", timeout=timeout)
        fp = reply.get("fingerprint")
        with self._lock:
            if self._canary_expected is None:
                self._canary_expected = fp
                return
            expected = self._canary_expected
        if fp != expected:
            metrics.CANARY_FAILURES.inc()
            raise RuntimeError(
                f"worker {w.idx} (epoch {w.epoch}) failed the canary "
                f"gate: fingerprint {fp} != recorded {expected}"
            )

    # ----------------------------------- adoption (gateway restart)

    def _scan_registry(self) -> Dict[int, Dict[str, Any]]:
        """Scan the registry a predecessor gateway shared with its
        workers (stable ``pod.socket_dir``).  A record whose pid is
        alive and whose liveness beat is fresh is an adoption
        candidate; a record that PROMISED a survivor (status serving/
        orphaned) without delivering one counts as an expired orphan —
        that is real work lost to the crash, and the alert rides on
        it.  Any record at all means a prior gateway lifetime ended in
        this registry dir and we are its successor."""
        found: Dict[int, Dict[str, Any]] = {}
        saw_any = False
        for w in self.workers:
            path = os.path.join(self.socket_dir, f"w{w.idx}.json")
            try:
                with open(path, encoding="utf-8") as fh:
                    rec = json.load(fh)
            except (OSError, ValueError):
                continue
            saw_any = True
            status = rec.get("status")
            pid = rec.get("pid")
            alive = (
                isinstance(pid, int) and pid > 0 and _pid_alive(pid)
            )
            try:
                beat_age = time.time() - float(rec.get("beat") or 0.0)
            except (TypeError, ValueError):
                beat_age = float("inf")
            if status not in ("serving", "orphaned"):
                continue  # clean exit post-mortem — nothing to adopt
            if alive and beat_age < _ADOPT_BEAT_FRESH_S:
                found[w.idx] = rec
                self.total_orphans_found += 1
                metrics.WORKERS_ORPHANED.inc()
            else:
                self.total_orphans_expired += 1
                metrics.ORPHAN_EXPIRED.inc()
                if alive:
                    # beat-stale but breathing: wedged — don't adopt,
                    # clear the slot for a fresh spawn
                    try:
                        os.kill(pid, signal.SIGTERM)
                    except OSError:
                        pass
        if saw_any:
            metrics.GATEWAY_RESTARTS.inc()
            logger.warning(
                "predecessor gateway registry found",
                extra={
                    "extra_data": {
                        "adoptable": sorted(found),
                        "expired": self.total_orphans_expired,
                    }
                },
            )
        return found

    def _try_adopt(self, w: _Worker, rec: Dict[str, Any]) -> None:
        """Adopt a live orphan left by a crashed predecessor: connect
        to its persisted address, re-hello it under a bumped fencing
        epoch, inherit its in-flight decodes as shell sequences,
        canary-gate it, then ask it to flush the frames it buffered
        while orphaned.  Warm weights, the compile ledger and the
        radix cache all survive — zero respawns.  Raises on any step
        failing; the caller falls back to a fresh spawn."""
        pod = self._pod_cfg
        with self._lock:
            # strictly newer than every epoch the orphan has seen, and
            # monotonic within this gateway's own bookkeeping
            w.epoch = max(w.epoch, int(rec.get("epoch") or 0)) + 1
            w.state = "spawning"
            w.draining = False
        addr = str(rec.get("address") or "")
        if pod.transport == "uds":
            w.address = addr
        else:
            host, _, port_s = addr.rpartition(":")
            w.address = (host or "127.0.0.1", int(port_s))
        w.proc = _AdoptedProc(int(rec["pid"]))
        client = self._connect(w)
        try:
            adopt = client.call(
                "adopt", timeout=pod.connect_timeout_s + 10.0
            )
            hello = client.call(
                "hello", timeout=pod.spawn_timeout_s
            )
            self._canary_gate(w, client)
        except BaseException:
            client.close()
            raise
        inflight = adopt.get("inflight") or []
        with self._lock:
            max_sid = 0
            for ent in inflight:
                try:
                    sid = int(ent["sid"])
                except (KeyError, TypeError, ValueError):
                    continue
                max_sid = max(max_sid, sid)
                if ent.get("cancelled"):
                    continue  # already aborted; let the worker reap it
                # shell sequence: the gateway holds no prompt for it —
                # it can finish (done carries the authoritative text)
                # or fail typed, but never replay onto a survivor
                shell = _PodSequence(
                    prompt_ids=[0], params=SamplingParams()
                )
                shell._pod = self
                shell._sid = sid
                shell._worker_idx = w.idx
                shell.request_id = ent.get("request_id")
                # pad to the delivered-token count; the orphan_flush
                # replay appends the buffered remainder, so usage
                # totals reconcile
                shell.generated_ids = [0] * int(
                    ent.get("generated_tokens") or 0
                )
                self._inflight[sid] = shell
                self._adopted_sids.add(sid)
                rid = ent.get("request_id")
                if rid:
                    self.adopted_request_ids[str(rid)] = sid
            # fresh sids must start above everything the predecessor
            # ever issued to any adoptee (adoptions run concurrently)
            self._sid_floor = max(self._sid_floor, max_sid + 1)
            self._sids = itertools.count(self._sid_floor)
            w.client = client
            w.hello = hello
            w.last_ok_t = time.monotonic()
            w.last_fatal = None
            w.state = "serving"
            self.total_adopted += 1
        metrics.WORKERS_ADOPTED.inc()
        logger.info(
            "adopted orphan worker",
            extra={
                "extra_data": {
                    "worker": w.idx,
                    "epoch": w.epoch,
                    "pid": rec.get("pid"),
                    "inflight": len(inflight),
                    "buffered_frames": adopt.get("buffered_frames"),
                    "was_orphaned": adopt.get("was_orphaned"),
                }
            },
        )
        try:
            # sids are registered — frames buffered during orphanhood
            # may now replay, in order, re-stamped with the new epoch
            client.notify("orphan_flush")
        except WorkerLostError:
            pass  # connection died post-adopt: the loss path owns it
        self._set_alive_gauge()
        self._drain_orphans()

    def _abandon_adoption(
        self, w: _Worker, rec: Dict[str, Any]
    ) -> None:
        """A failed adoption leaves a live-but-unadoptable orphan.  Its
        epoch is already behind the slot's, so it is fenced; kill it so
        the fresh spawn can take the slot (TCP: rebind the port) and
        count the in-flight work it carried as expired."""
        with self._lock:
            old_client, w.client = w.client, None
            old_proc, w.proc = w.proc, None
            w.state = "down"
        if old_client is not None:
            old_client.close()
        proc = old_proc
        if proc is None:
            pid = rec.get("pid")
            if isinstance(pid, int) and pid > 0:
                proc = _AdoptedProc(pid)
        if proc is not None:
            self._kill_proc(proc)
        with self._lock:
            self.total_orphans_expired += 1
        metrics.ORPHAN_EXPIRED.inc()

    def start(self) -> None:
        self._monitor = threading.Thread(
            target=self._monitor_loop, daemon=True, name="vgt-pod-monitor"
        )
        self._monitor.start()

    # ------------------------------------------------------- frame dispatch

    def _on_frame(self, idx: int, client_epoch: int, frame: Dict[str, Any]) -> None:
        w = self.workers[idx]
        fe = frame.get("e")
        if not isinstance(fe, int) or fe != w.epoch:
            # late frame from a fenced incarnation (zombie declared
            # lost, or replaced after a drain): discard + count — it
            # must never interleave into the live incarnation's streams
            with self._lock:
                self.fenced_frames += 1
            metrics.POD_FENCED_FRAMES.inc()
            return
        op = frame.get("op")
        if op == "tok":
            self._on_token(idx, frame)
        elif op == "done":
            self._on_done(idx, frame)
        elif op == "err":
            self._on_err(idx, frame)
        elif op == "evacuated":
            self._on_evacuated(idx, frame)
        elif op == "handoff_staged":
            self._on_handoff_staged(idx, frame)
        elif op == "handoff_fallback":
            self._on_handoff_fallback(idx, frame)

    def _seq_for(self, idx: int, frame: Dict[str, Any]) -> Optional[_PodSequence]:
        with self._lock:
            seq = self._inflight.get(frame.get("sid"))
        if seq is None or seq._worker_idx != idx:
            return None  # settled, aborted, or resubmitted elsewhere
        return seq

    def _handoff_intercept(self, idx: int, frame: Dict[str, Any]) -> bool:
        """Pre-dispatch hook for tok/done/err frames while a handoff
        record exists for the sid.  Two cases:

        * frame from the DECODE TARGET before ownership flipped —
          buffer it on the record (replayed in order at accept) and
          consume it (return True);
        * frame from the PREFILL worker while the sequence is staged or
          transferring — the worker's own supervisor replayed it
          locally (the fold clears the hold), so the handoff is moot:
          cancel the record and let the frame flow (monolithic decode
          continues on the prefill worker, token-identically).
        """
        sid = frame.get("sid")
        fallback = False
        with self._lock:
            rec = self._handoffs.get(sid)
            if rec is None:
                return False
            if rec.target_idx == idx and not rec.cancelled:
                if frame.get("op") == "tok":
                    rec.buffered.append(frame)
                else:
                    rec.terminal = (frame.get("op"), frame)
                return True
            if rec.prefill_idx == idx and rec.state in (
                handoff_mod.STAGED, handoff_mod.TRANSFERRING
            ):
                self._handoffs.pop(sid, None)
                rec.cancelled = True
                self.total_handoff_fallbacks += 1
                fallback = True
        if fallback:
            metrics.HANDOFF_TOTAL.labels(outcome="fallback_monolithic").inc()
            self._ledger_note(
                rec.seq.request_id, handoff="fallback_monolithic"
            )
        return False

    @staticmethod
    def _apply_token(seq: _PodSequence, frame: Dict[str, Any]) -> None:
        lp = frame.get("lp")
        if lp is not None and seq.params.logprobs:
            # raw (chosen_lp, [(tid, lp), ...]) data — the gateway's
            # lp_entry renders it with its own tokenizer
            seq.logprob_data.append(
                (float(lp[0]), [(int(t), float(l)) for t, l in lp[1]])
            )
        seq.append_token(int(frame["t"]))

    def _on_token(self, idx: int, frame: Dict[str, Any]) -> None:
        if self._handoff_intercept(idx, frame):
            return
        seq = self._seq_for(idx, frame)
        if seq is None:
            return
        self._apply_token(seq, frame)

    def _on_done(self, idx: int, frame: Dict[str, Any]) -> None:
        if self._handoff_intercept(idx, frame):
            return
        seq = self._seq_for(idx, frame)
        if seq is None:
            return
        with self._lock:
            self._inflight.pop(seq._sid, None)
            adopted = seq._sid in self._adopted_sids
            self._adopted_sids.discard(seq._sid)
            # a sequence that finished before its handoff ever staged
            # (short decode) retires the record silently — nothing to
            # transfer, nothing degraded
            rec = self._handoffs.pop(seq._sid, None)
            if rec is not None:
                rec.cancelled = True
        text = frame.get("text")
        if text is not None:
            # the worker's final text is authoritative (stop-string
            # truncation happened against ITS decode state)
            seq.text_override = text
        lp = frame.get("lp")
        if lp is not None and seq.params.logprobs:
            seq.logprob_data = [
                (float(e[0]), [(int(t), float(l)) for t, l in e[1]])
                for e in lp
            ]
        # worker-internal supervisor restarts also bump these; take the
        # max of both views so neither hop under-reports
        seq.resume_count = max(
            seq.resume_count, int(frame.get("resume_count", 0))
        )
        seq.migrate_count = max(
            seq.migrate_count, int(frame.get("migrate_count", 0))
        )
        seq.finish(str(frame.get("finish_reason", "stop")))
        if adopted:
            self._notify_adopted_done(
                seq,
                result={
                    "request_id": seq.request_id,
                    "text": text if text is not None else "",
                    "finish_reason": str(
                        frame.get("finish_reason", "stop")
                    ),
                    "generated_tokens": len(seq.generated_ids),
                },
                error=None,
            )

    def _notify_adopted_done(
        self,
        seq: _PodSequence,
        result: Optional[Dict[str, Any]],
        error: Optional[str],
    ) -> None:
        """Tell the app layer an ADOPTED shell settled so it can settle
        or fail the matching journal record (idempotent replay)."""
        if not seq.request_id:
            return
        rid = str(seq.request_id)
        with self._lock:
            self.adopted_request_ids.pop(rid, None)
            cb = self.on_adopted_done
            if cb is None:
                self.adopted_results[rid] = (result, error)
                return
        try:
            cb(rid, result, error)
        except Exception:  # noqa: BLE001 — observer must not wedge I/O
            logger.exception("on_adopted_done callback failed")

    def drain_adopted_results(
        self,
    ) -> Dict[str, Tuple[Optional[Dict[str, Any]], Optional[str]]]:
        """Adopted settles that landed before ``on_adopted_done`` was
        attached — the app layer collects them right after wiring the
        hook, closing the boot-time race."""
        with self._lock:
            out, self.adopted_results = self.adopted_results, {}
        return out

    def _on_err(self, idx: int, frame: Dict[str, Any]) -> None:
        if self._handoff_intercept(idx, frame):
            return
        seq = self._seq_for(idx, frame)
        if seq is None:
            return
        with self._lock:
            self._inflight.pop(seq._sid, None)
            adopted = seq._sid in self._adopted_sids
            self._adopted_sids.discard(seq._sid)
            rec = self._handoffs.pop(seq._sid, None)
            if rec is not None:
                rec.cancelled = True
        err = unwire_error(frame.get("error") or {})
        seq.fail(err)
        if adopted:
            self._notify_adopted_done(seq, result=None, error=str(err))

    def _on_evacuated(self, idx: int, frame: Dict[str, Any]) -> None:
        """Worker-initiated drain (SIGTERM straight to the worker —
        rolling OS-level restarts): replay its evacuated sequences onto
        survivors as planned movements."""
        sids = [int(e["sid"]) for e in frame.get("evacuated") or []]
        seqs: List[_PodSequence] = []
        with self._lock:
            for sid in sids:
                seq = self._inflight.pop(sid, None)
                if seq is not None:
                    seqs.append(seq)
        for seq in seqs:
            self._replay(seq, exclude=idx, planned=True)

    # ------------------------------------------- KV handoff (pod.roles)

    def _on_handoff_staged(self, idx: int, frame: Dict[str, Any]) -> None:
        """The prefill worker folded + staged the sequence's KV: record
        the transfer metadata (PREFILLING → STAGED) and launch the
        transfer thread.  A staging notification with no live record
        (the request was replayed/aborted meanwhile) is answered with a
        cancel so the worker resumes monolithic decode immediately."""
        sid = int(frame.get("sid", -1))
        with self._lock:
            rec = self._handoffs.get(sid)
            seq = self._inflight.get(sid)
            ok = (
                rec is not None
                and not rec.cancelled
                and seq is not None
                and seq is rec.seq
                and seq._worker_idx == idx
                and rec.state == handoff_mod.PREFILLING
            )
            if ok:
                handoff_mod.advance(rec.state, handoff_mod.STAGED)
                rec.state = handoff_mod.STAGED
                rec.pages = int(frame.get("pages", 0))
                rec.nbytes = int(frame.get("nbytes", 0))
                rec.base_len = int(frame.get("base_len", 0))
                rec.generated_ids = [
                    int(t) for t in frame.get("generated_ids") or []
                ]
                rec.resume_count = int(frame.get("resume_count", 0))
                rec.migrate_count = int(frame.get("migrate_count", 0))
                rec.preempt_count = int(frame.get("preempt_count", 0))
                rec.swap_count = int(frame.get("swap_count", 0))
                rec.kv_dtype = frame.get("kv_dtype")
                rec.t0 = time.monotonic()
                rec.t_staged_pc = time.perf_counter()
        if not ok:
            w = self.workers[idx]
            client = w.client
            if client is not None and not client.dead:
                try:
                    client.notify("handoff_cancel", sid=sid)
                except WorkerLostError:
                    pass
            return
        threading.Thread(
            target=self._run_handoff, args=(rec,), daemon=True,
            name=f"vgt-pod-handoff-{sid}",
        ).start()

    def _on_handoff_fallback(self, idx: int, frame: Dict[str, Any]) -> None:
        """The prefill worker could not stage (host pool refused, abort
        raced the fold): it keeps decoding monolithically."""
        sid = int(frame.get("sid", -1))
        with self._lock:
            rec = self._handoffs.pop(sid, None)
            if rec is not None:
                rec.cancelled = True
                self.total_handoff_fallbacks += 1
        if rec is not None:
            metrics.HANDOFF_TOTAL.labels(outcome="fallback_monolithic").inc()
            self._ledger_note(
                rec.seq.request_id, handoff="fallback_monolithic"
            )

    def _handoff_span(
        self,
        seq: _PodSequence,
        stage: str,
        start_pc: float,
        end_pc: float,
        **attrs: Any,
    ) -> None:
        """Gateway-side ``handoff.<stage>`` span parented on the
        request's captured HTTP-span context — the explicit middle of
        the cross-process trace (prefill worker spans on one side,
        decode worker spans on the other).  No-op without a valid
        trace context, same gate reqtrace uses."""
        ctx = seq._trace_ctx
        if tracing.context_trace_id(ctx) is None:
            return
        span = self._tracer.start_span(
            f"handoff.{stage}",
            context=ctx,
            start_time=_pc_to_ns(start_pc),
        )
        if seq.request_id:
            span.set_attribute("request.id", seq.request_id)
        for key, val in attrs.items():
            span.set_attribute(key, val)
        span.end(end_time=_pc_to_ns(end_pc))

    def _ledger_note(
        self, request_id: Optional[str], **fields: Any
    ) -> None:
        """Record a gateway-side per-request annotation for the merged
        flight view (bounded FIFO; requests without an id — direct
        generate() calls — have no flight record to graft onto)."""
        if not request_id:
            return
        with self._lock:
            entry = self._req_ledger.get(request_id)
            if entry is None:
                while len(self._req_ledger) >= self._ledger_cap:
                    self._req_ledger.pop(
                        next(iter(self._req_ledger))
                    )
                entry = self._req_ledger[request_id] = {}
            entry.update(fields)

    def _run_handoff(self, rec: _HandoffRec) -> None:
        metrics.HANDOFF_ACTIVE.inc()
        try:
            self._handoff_attempts(rec)
        except BaseException:  # noqa: BLE001 — thread must not die loud
            logger.error(
                "handoff transfer thread crashed",
                extra={"extra_data": {"sid": rec.sid}},
                exc_info=True,
            )
            self._handoff_abandon(rec, "failed")
        finally:
            metrics.HANDOFF_ACTIVE.dec()

    def _handoff_attempts(self, rec: _HandoffRec) -> None:
        """Bounded-retry transfer loop.  Every exit is terminal for the
        record: accept (ownership flips to the decode worker), fallback
        (prefill worker resumes monolithic decode, zero recompute), or
        abandon (the loss path owns the sequence)."""
        pod = self._pod_cfg
        while True:
            staged_dwell = False
            with self._lock:
                if rec.cancelled or rec.sid not in self._handoffs:
                    return
                if rec.state == handoff_mod.STAGED:
                    handoff_mod.advance(
                        rec.state, handoff_mod.TRANSFERRING
                    )
                    rec.state = handoff_mod.TRANSFERRING
                    rec.t_transfer_pc = time.perf_counter()
                    staged_dwell = True
            if staged_dwell and rec.t_staged_pc:
                # STAGED → TRANSFERRING happens once per record (a
                # retry stays TRANSFERRING), so the stage dwell and its
                # span are emitted exactly once
                metrics.HANDOFF_STATE_SECONDS.labels(
                    state="staged"
                ).observe(rec.t_transfer_pc - rec.t_staged_pc)
                self._handoff_span(
                    rec.seq, "stage", rec.t_staged_pc,
                    rec.t_transfer_pc, sid=rec.sid,
                    prefill=rec.prefill_idx, pages=rec.pages,
                    nbytes=rec.nbytes,
                )
            target = self._decode_target(exclude=rec.prefill_idx)
            if target is None:
                self._handoff_fallback_monolithic(
                    rec, "no decode-capable worker alive"
                )
                return
            xid = f"h{rec.sid}.{next(self._xfer_ids)}"
            with self._lock:
                rec.target_idx = target.idx
                rec.buffered = []
                rec.terminal = None
            try:
                self._transfer_once(rec, target, xid)
            except HandoffStaleError:
                # the prefill side invalidated the staging (abort, or a
                # worker-internal replay cleared the hold): whoever
                # invalidated it owns the sequence now
                self._handoff_abandon(rec, "fallback_monolithic")
                return
            except _SourceLost:
                # prefill connection died: the pod loss path folds and
                # replays the sequence on a survivor
                self._handoff_abandon(rec, "failed")
                return
            except (
                HandoffTransferError,
                WorkerLostError,
                TimeoutError,
                faults.InjectedFault,
            ) as exc:
                rec.attempts += 1
                with self._lock:
                    committed = bool(rec.buffered or rec.terminal)
                if committed:
                    # the commit actually landed (the target is already
                    # streaming tokens) — the error was a lost/slow
                    # reply.  Finalize instead of retrying.
                    self._finalize_accept(rec, target)
                    return
                # kill any partial/ghost admission on the target before
                # the next attempt or the fallback
                self._kill_target_copy(target, xid, rec.sid)
                if rec.attempts > pod.transfer_max_retries:
                    self._handoff_fallback_monolithic(rec, str(exc))
                    return
                metrics.HANDOFF_TOTAL.labels(outcome="retried").inc()
                logger.warning(
                    "handoff transfer attempt failed; retrying",
                    extra={
                        "extra_data": {
                            "sid": rec.sid,
                            "attempt": rec.attempts,
                            "target": target.idx,
                            "error": str(exc),
                        }
                    },
                )
                continue
            self._finalize_accept(rec, target)
            return

    def _transfer_once(
        self, rec: _HandoffRec, target: _Worker, xid: str
    ) -> None:
        """One pull-relay attempt: fetch chunks from the prefill worker,
        put them to the decode worker, commit.  The ``kv_transfer``
        fault point probes once per chunk (drop/garble/duplicate/delay
        — drills for every framing failure mode)."""
        pod = self._pod_cfg
        pw = self.workers[rec.prefill_idx]
        with self._lock:
            stale_src = pw.epoch != rec.prefill_epoch
        pclient = pw.client
        tclient = target.client
        if stale_src or pclient is None or pclient.dead:
            raise _SourceLost()
        if tclient is None or tclient.dead:
            raise HandoffTransferError(
                f"decode worker {target.idx} has no live connection"
            )
        deadline = time.monotonic() + pod.transfer_timeout_s
        chunk = max(1, int(pod.transfer_chunk_bytes))
        off = 0
        total: Optional[int] = None
        digest = 0
        while total is None or off < total:
            with self._lock:
                if rec.cancelled:
                    raise HandoffStaleError("handoff record cancelled")
            budget = deadline - time.monotonic()
            if budget <= 0:
                raise HandoffTransferError(
                    f"transfer timed out after "
                    f"{pod.transfer_timeout_s:.0f}s"
                )
            try:
                reply = pclient.call(
                    "handoff_fetch", sid=rec.sid, off=off, n=chunk,
                    timeout=budget,
                )
            except WorkerLostError as exc:
                raise _SourceLost() from exc
            total = int(reply.get("total", 0))
            digest = int(reply.get("digest", 0))
            try:
                data = base64.b64decode(
                    str(reply.get("data", "")), validate=True
                )
            except (binascii.Error, ValueError) as exc:
                raise HandoffTransferError(
                    f"undecodable fetch chunk: {exc}"
                ) from exc
            if not data:
                if off >= total:
                    break
                raise HandoffTransferError(
                    f"empty fetch chunk at offset {off}/{total}"
                )
            verdict = (
                faults.wire_action("kv_transfer")
                if faults.is_active()
                else None
            )
            if verdict != "drop":
                out = data
                if verdict == "garble":
                    out = bytes(b ^ 0x55 for b in data[:64]) + data[64:]
                payload = base64.b64encode(out).decode("ascii")
                budget = deadline - time.monotonic()
                if budget <= 0:
                    raise HandoffTransferError("transfer timed out")
                tclient.call(
                    "handoff_put", xfer=xid, off=off, total=total,
                    data=payload, timeout=budget,
                )
                if verdict == "duplicate":
                    tclient.call(
                        "handoff_put", xfer=xid, off=off, total=total,
                        data=payload,
                        timeout=max(1.0, deadline - time.monotonic()),
                    )
            # a dropped chunk leaves a gap: commit raises typed, the
            # attempt retries with a fresh transfer id
            off += len(data)
        if not total:
            raise HandoffTransferError("staged blob is empty")
        seq = rec.seq
        remaining = None
        if seq.deadline_t is not None:
            remaining = max(
                0.01, seq.deadline_t - time.perf_counter()
            )
        budget = deadline - time.monotonic()
        if budget <= 0:
            raise HandoffTransferError("transfer timed out before commit")
        reply = tclient.call(
            "handoff_commit",
            xfer=xid,
            sid=rec.sid,
            digest=digest,
            pages=rec.pages,
            base_len=rec.base_len,
            prompt_ids=[
                int(t) for t in seq.prompt_ids[: seq.orig_prompt_len]
            ],
            generated_ids=[int(t) for t in rec.generated_ids],
            params=params_to_wire(seq.params),
            remaining_s=remaining,
            request_id=seq.request_id,
            traceparent=seq._traceparent,
            resume_count=rec.resume_count,
            migrate_count=rec.migrate_count,
            preempt_count=rec.preempt_count,
            swap_count=rec.swap_count,
            handoff_count=seq.handoff_count + 1,
            kv_dtype=rec.kv_dtype,
            timeout=budget,
        )
        if not reply.get("accepted"):
            raise HandoffTransferError(
                f"decode worker {target.idx} refused commit"
            )

    def _finalize_accept(self, rec: _HandoffRec, target: _Worker) -> bool:
        """Atomically flip sequence ownership to the decode worker
        (TRANSFERRING → ACCEPTED → DECODING), reconcile the client
        token stream to the fold point, replay buffered target frames
        in order, and release the prefill worker's surplus copy."""
        accept_pc = time.perf_counter()
        with self._lock:
            seq = self._inflight.get(rec.sid)
            ok = (
                not rec.cancelled
                and rec.sid in self._handoffs
                and seq is rec.seq
                and seq is not None
                and seq._worker_idx == rec.prefill_idx
                and not seq.done_event.is_set()
            )
            if ok:
                handoff_mod.advance(rec.state, handoff_mod.ACCEPTED)
                rec.state = handoff_mod.ACCEPTED
                seq._worker_idx = target.idx
                seq.handoff_count += 1
                # tok frames still in flight from the prefill worker are
                # fenced by the ownership flip: append the fold-point
                # suffix here so the client stream loses nothing
                for t in rec.generated_ids[len(seq.generated_ids):]:
                    seq.append_token(int(t))
                handoff_mod.advance(rec.state, handoff_mod.DECODING)
                rec.state = handoff_mod.DECODING
        if not ok:
            # the sequence moved under us (loss replay / abort): the
            # current owner's stream is authoritative — kill the
            # decode-side admission so no ghost burns slots
            tclient = target.client
            if tclient is not None and not tclient.dead:
                try:
                    tclient.notify(
                        "abort", sid=rec.sid, reason="handoff_superseded"
                    )
                except WorkerLostError:
                    pass
            self._handoff_abandon(rec, "failed")
            return False
        # drain buffered decode-side frames in arrival order; keep the
        # record registered until the buffer runs dry so the reader
        # thread keeps buffering instead of racing these appends
        terminal = None
        while True:
            with self._lock:
                frames, rec.buffered = rec.buffered, []
                if not frames:
                    terminal = rec.terminal
                    self._handoffs.pop(rec.sid, None)
                    break
            for f in frames:
                self._apply_token(seq, f)
        if terminal is not None:
            kind, f = terminal
            if kind == "done":
                self._on_done(target.idx, f)
            elif kind == "err":
                self._on_err(target.idx, f)
        pw = self.workers[rec.prefill_idx]
        pclient = pw.client
        if pclient is not None and not pclient.dead:
            try:
                pclient.notify("handoff_done", sid=rec.sid)
            except WorkerLostError:
                pass  # dead prefill worker frees the copy by dying
        with self._lock:
            self.total_handoffs += 1
        metrics.HANDOFF_TOTAL.labels(outcome="ok").inc()
        metrics.HANDOFF_SECONDS.observe(time.monotonic() - rec.t0)
        metrics.HANDOFF_BYTES.observe(rec.nbytes)
        end_pc = time.perf_counter()
        if rec.t_transfer_pc:
            metrics.HANDOFF_STATE_SECONDS.labels(
                state="transfer"
            ).observe(accept_pc - rec.t_transfer_pc)
            self._handoff_span(
                seq, "transfer", rec.t_transfer_pc, accept_pc,
                sid=rec.sid, prefill=rec.prefill_idx,
                decode=target.idx, pages=rec.pages,
                nbytes=rec.nbytes, attempts=rec.attempts,
            )
        metrics.HANDOFF_STATE_SECONDS.labels(state="accept").observe(
            end_pc - accept_pc
        )
        self._handoff_span(
            seq, "accept", accept_pc, end_pc,
            sid=rec.sid, decode=target.idx,
        )
        # graft target for the merged flight view: the worker-side
        # recorders each see only their half of the request, so the
        # gateway owns the transfer_s phase and the outcome
        self._ledger_note(
            seq.request_id,
            transfer_s=round(
                end_pc - (rec.t_staged_pc or accept_pc), 6
            ),
            handoff="ok",
            prefill_worker=rec.prefill_idx,
            decode_worker=target.idx,
        )
        logger.info(
            "kv handoff complete",
            extra={
                "extra_data": {
                    "sid": rec.sid,
                    "prefill": rec.prefill_idx,
                    "decode": target.idx,
                    "pages": rec.pages,
                    "nbytes": rec.nbytes,
                    "attempts": rec.attempts,
                }
            },
        )
        return True

    def _kill_target_copy(
        self, target: _Worker, xid: str, sid: int
    ) -> None:
        """Best-effort ghost cleanup on the decode worker after a failed
        attempt: drop the partial reassembly AND abort any admission a
        lost commit reply may have left running (its frames are fenced
        by `_seq_for`'s ownership check either way)."""
        tclient = target.client
        if tclient is None or tclient.dead:
            return
        try:
            tclient.notify("handoff_abort", xfer=xid)
            tclient.notify("abort", sid=sid, reason="handoff_retry")
        except WorkerLostError:
            pass

    def _handoff_fallback_monolithic(
        self, rec: _HandoffRec, detail: str
    ) -> None:
        """Terminal degrade: release the hold on the prefill worker so
        it swap-ins the staged KV and decodes monolithically — zero
        recompute, zero 5xx, token-identical."""
        with self._lock:
            existed = self._handoffs.pop(rec.sid, None) is not None
            rec.cancelled = True
            if existed:
                self.total_handoff_fallbacks += 1
            pw = self.workers[rec.prefill_idx]
            stale_src = pw.epoch != rec.prefill_epoch
        if not existed:
            return
        metrics.HANDOFF_TOTAL.labels(outcome="fallback_monolithic").inc()
        self._ledger_note(
            rec.seq.request_id, handoff="fallback_monolithic"
        )
        logger.warning(
            "handoff degraded to monolithic decode",
            extra={
                "extra_data": {
                    "sid": rec.sid,
                    "prefill": rec.prefill_idx,
                    "detail": detail,
                }
            },
        )
        pclient = pw.client
        if stale_src or pclient is None or pclient.dead:
            return  # the loss path already owns the sequence
        try:
            pclient.call(
                "handoff_cancel", sid=rec.sid,
                timeout=self._pod_cfg.call_timeout_s,
            )
        except (WorkerLostError, TimeoutError):
            # the frame is queued on a live-but-slow connection and
            # will still release the hold when processed; a truly dead
            # worker routes through the loss path instead
            pass

    def _handoff_abandon(self, rec: _HandoffRec, outcome: str) -> None:
        """Drop a record whose sequence somebody else now owns (loss
        replay, abort, worker-local resume).  Counted once."""
        with self._lock:
            existed = self._handoffs.pop(rec.sid, None) is not None
            rec.cancelled = True
            if existed:
                if outcome == "failed":
                    self.total_handoff_failed += 1
                elif outcome == "fallback_monolithic":
                    self.total_handoff_fallbacks += 1
        if existed:
            metrics.HANDOFF_TOTAL.labels(outcome=outcome).inc()
            self._ledger_note(rec.seq.request_id, handoff=outcome)

    def _handoff_stats(self) -> Dict[str, Any]:
        with self._lock:
            active = len(self._handoffs)
            return {
                "active": active,
                "completed": self.total_handoffs,
                "fallback_monolithic": self.total_handoff_fallbacks,
                "failed": self.total_handoff_failed,
                "roles": list(self._roles) if self._roles_active else [],
            }

    # ------------------------------------------------------------- routing

    def _alive_workers(self, exclude: Optional[int] = None) -> List[_Worker]:
        with self._lock:
            return [
                w
                for w in self.workers
                if w.alive and not w.draining and w.idx != exclude
            ]

    def _role(self, idx: int) -> str:
        return self._roles[idx] if 0 <= idx < len(self._roles) else "mixed"

    def _decode_target(self, exclude: Optional[int] = None) -> Optional[_Worker]:
        """Least-loaded decode-capable worker, or None — the caller
        degrades to monolithic decode rather than 5xx."""
        cands = [
            w
            for w in self._alive_workers(exclude=exclude)
            if self._role(w.idx) in ("decode", "mixed")
        ]
        return min(cands, key=self._load) if cands else None

    def _pick_worker(
        self,
        prompt_ids: Optional[List[int]] = None,
        exclude: Optional[int] = None,
        role: Optional[str] = None,
    ) -> _Worker:
        """dp's router, over worker handles: least-loaded among routable
        workers with prefix affinity (each worker's KV prefix cache is
        private — requests sharing a first page stick together unless
        that costs real queueing headroom).  With ``pod.roles`` active,
        ``role`` names the preferred pool (prefill/decode; ``mixed``
        workers belong to both); an empty pool falls through to every
        routable worker — a drained pool degrades, never 500s."""
        candidates = self._alive_workers(exclude=exclude)
        if role is not None and candidates:
            pooled = [
                w
                for w in candidates
                if self._role(w.idx) in (role, "mixed")
            ]
            if pooled:
                candidates = pooled
        if not candidates:
            # fall back to any live worker (a fully-draining pod still
            # serves rather than 500s)
            with self._lock:
                live = [w for w in self.workers if w.alive]
            if not live:
                raise WorkerLostError(
                    "no live engine worker (pod respawning or dead); "
                    "retry shortly",
                    retry_after=self.retry_after_s,
                )
            candidates = live
        offset = next(self._rr) % len(candidates)
        ordered = candidates[offset:] + candidates[:offset]
        best = min(ordered, key=self._load)
        page = self.config.device.kv_page_size
        if (
            prompt_ids is not None
            and len(prompt_ids) >= page
            and self.config.device.prefix_cache.enabled
        ):
            block = bytes(
                b
                for t in prompt_ids[:page]
                for b in int(t).to_bytes(4, "little")
            )
            sticky = self.workers[zlib.crc32(block) % len(self.workers)]
            if (
                sticky.alive
                and not sticky.draining
                and sticky.idx != exclude
                and any(w.idx == sticky.idx for w in candidates)
                and self._load(sticky)
                <= self._load(best)
                + max(2, self.config.device.max_batch_slots // 4)
            ):
                return sticky
        return best

    @staticmethod
    def _load(w: _Worker) -> int:
        sig = w.last_ping.get("pressure") or {}
        return int(sig.get("engine_queue_depth", 0)) + int(
            sig.get("running", 0)
        )

    # ---------------------------------------------------------- submission

    def submit_tokens(
        self,
        prompt_ids: List[int],
        params: Any,
        stream_cb: Optional[Callable[[int], Any]] = None,
        meta: Optional[Any] = None,
    ) -> Sequence:
        raise_for_state(
            self.state.value, retry_after=self.retry_after_s
        )
        seq = _PodSequence(
            prompt_ids=list(prompt_ids),
            params=params,
            stream_cb=stream_cb,
        )
        seq._pod = self
        seq._sid = next(self._sids)
        if meta is not None:
            seq.request_id = getattr(meta, "request_id", None)
            # capture the gateway's OTel context ONCE (the HTTP span
            # rides in it); the W3C encoding travels on every frame
            # that creates engine work in a worker process, so the
            # worker's engine spans parent onto the HTTP span
            seq._trace_ctx = getattr(meta, "trace_ctx", None)
            seq._traceparent = tracing.context_to_traceparent(
                seq._trace_ctx
            )
        self._dispatch_submit(seq)
        return seq

    def _dispatch_submit(
        self, seq: _PodSequence, exclude: Optional[int] = None
    ) -> None:
        """Place a sequence on a worker, retrying over the remaining
        alive workers on connection-level failures (a typed engine
        error — quarantine, overload — propagates immediately)."""
        prompt = seq.prompt_ids[: seq.orig_prompt_len]
        role: Optional[str] = None
        if self._roles_active:
            # fresh (prefill-heavy) work goes to the prefill pool;
            # replays already carrying generated tokens — including
            # post-handoff continuations — belong with the decode pool
            role = (
                "decode"
                if (seq.generated_ids or seq.handoff_count)
                else "prefill"
            )
        tried: set = set()
        last: Optional[BaseException] = None
        for _ in range(len(self.workers)):
            try:
                w = self._pick_worker(prompt, exclude=exclude, role=role)
            except WorkerLostError as exc:
                last = exc
                break
            if w.idx in tried:
                break
            tried.add(w.idx)
            client = w.client
            if client is None:
                continue
            remaining = None
            if seq.deadline_t is not None:
                remaining = seq.deadline_t - time.perf_counter()
                if remaining <= 0:
                    remaining = 0.01  # let the worker shed it typed
            # request a staged handoff only when the chosen worker is a
            # dedicated prefill worker AND a decode-capable target
            # exists right now — otherwise decode monolithically
            want_handoff = (
                role == "prefill"
                and self._role(w.idx) == "prefill"
                and self._decode_target(exclude=w.idx) is not None
            )
            extra = {"handoff": True} if want_handoff else {}
            with self._lock:
                seq._worker_idx = w.idx
                self._inflight[seq._sid] = seq
                if want_handoff:
                    self._handoffs[seq._sid] = _HandoffRec(
                        seq._sid, seq, w.idx, w.epoch
                    )
            try:
                client.call(
                    "submit",
                    sid=seq._sid,
                    prompt_ids=[int(t) for t in prompt],
                    generated_ids=[int(t) for t in seq.generated_ids],
                    params=params_to_wire(seq.params),
                    remaining_s=remaining,
                    request_id=seq.request_id,
                    traceparent=seq._traceparent,
                    resume_count=seq.resume_count,
                    migrate_count=seq.migrate_count,
                    preempt_count=seq.preempt_count,
                    kv_dtype=seq.kv_dtype,
                    **extra,
                )
                return
            except (WorkerLostError, TimeoutError) as exc:
                # connection-level failure: unregister and try the next
                # worker (the loss machinery handles the dead one)
                last = exc
                with self._lock:
                    self._inflight.pop(seq._sid, None)
                    rec = self._handoffs.pop(seq._sid, None)
                    if rec is not None:
                        rec.cancelled = True
                continue
            except BaseException:
                with self._lock:
                    self._inflight.pop(seq._sid, None)
                    rec = self._handoffs.pop(seq._sid, None)
                    if rec is not None:
                        rec.cancelled = True
                raise
        raise last or WorkerLostError(
            "no engine worker accepted the request; retry shortly",
            retry_after=self.retry_after_s,
        )

    def encode_prompt(self, prompt: str) -> List[int]:
        ids = self.tokenizer.encode(prompt)
        max_prompt = self.config.model.max_model_len - 1
        if len(ids) > max_prompt:
            ids = ids[-max_prompt:]
        return ids or [self.tokenizer.bos_id]

    def submit_prompt(
        self,
        prompt: str,
        params: Any,
        stream_cb: Optional[Callable[[int], Any]] = None,
        meta: Optional[Any] = None,
    ) -> Sequence:
        return self.submit_tokens(
            self.encode_prompt(prompt), params, stream_cb, meta=meta
        )

    def generate(
        self, prompts: Seq[str], params: Seq[Any]
    ) -> List[Dict[str, Any]]:
        """Blocking batch API (mirrors EngineCore.generate's shape)."""
        seqs = [self.submit_prompt(p, sp) for p, sp in zip(prompts, params)]
        results = []
        for seq in seqs:
            seq.done_event.wait()
            if seq.status is SeqStatus.FAILED:
                raise seq.error  # type: ignore[misc]
            results.append(
                {
                    "text": self.final_text(seq),
                    "token_ids": list(seq.generated_ids),
                    "num_tokens": seq.num_output_tokens,
                    "prompt_tokens": seq.orig_prompt_len,
                    "finish_reason": seq.finish_reason,
                    "metrics": {
                        "ttft": seq.ttft or 0.0,
                        "tpot": seq.tpot or 0.0,
                        "gen_time": (seq.finish_t or 0.0) - seq.arrival_t,
                        **seq.resume_metrics(),
                    },
                    **(
                        {"logprobs": self.logprob_entries(seq)}
                        if seq.params.logprobs
                        else {}
                    ),
                }
            )
        return results

    # ----------------------------------------------------- result assembly

    def final_text(self, seq: Sequence) -> str:
        if seq.text_override is not None:
            return seq.text_override
        return self.tokenizer.decode(seq.generated_ids)

    def lp_entry(self, tid: int, lp: float, top) -> Dict[str, Any]:
        return {
            "token": self.tokenizer.decode([tid]),
            "token_id": tid,
            "logprob": lp,
            "top_logprobs": [
                {
                    "token": self.tokenizer.decode([i]),
                    "token_id": i,
                    "logprob": l,
                }
                for i, l in top
            ],
        }

    def logprob_entries(self, seq: Sequence) -> List[Dict[str, Any]]:
        return [
            self.lp_entry(tid, lp, top)
            for tid, (lp, top) in zip(seq.generated_ids, seq.logprob_data)
        ]

    # -------------------------------------------------------------- aborts

    def _abort_remote(self, seq: _PodSequence, reason: str) -> None:
        with self._lock:
            if seq._sid not in self._inflight:
                return
            w = (
                self.workers[seq._worker_idx]
                if 0 <= seq._worker_idx < len(self.workers)
                else None
            )
            client = w.client if w is not None and w.alive else None
        if client is None:
            return
        try:
            client.notify("abort", sid=seq._sid, reason=reason)
        except WorkerLostError:
            pass  # loss path owns the sequence from here

    def abort_in_flight(self, reason: str = "drain") -> None:
        for w in self._alive_workers():
            client = w.client
            if client is None:
                continue
            try:
                client.notify("abort_all", reason=reason)
            except WorkerLostError:
                pass

    def set_spec_suspended(self, flag: bool) -> None:
        self._broadcast("set_spec_suspended", flag=bool(flag))

    def set_prefix_insert_suspended(self, flag: bool) -> None:
        self._broadcast("set_prefix_insert_suspended", flag=bool(flag))

    def _broadcast(self, op: str, **fields: Any) -> None:
        # ALL workers, draining included (dp fans brownout toggles out
        # the same way — a draining replica still decodes residents)
        for w in list(self.workers):
            client = w.client
            if client is None or client.dead:
                continue
            try:
                client.notify(op, **fields)
            except WorkerLostError:
                pass

    # ----------------------------------------------------------- liveness

    def _monitor_loop(self) -> None:
        pod = self._pod_cfg
        rec = self._recovery
        while not self._stopping:
            time.sleep(pod.heartbeat_interval_s)
            for w in list(self.workers):
                if self._stopping:
                    return
                if not w.alive:
                    continue
                # crash detection beats the heartbeat timeout: a dead
                # pid is a fact, not a suspicion
                if w.proc is not None and w.proc.poll() is not None:
                    self._handle_loss(
                        w.idx,
                        w.epoch,
                        "crash",
                        f"worker exited with {w.proc.returncode}",
                    )
                    continue
                client = w.client
                if client is None or client.dead:
                    continue  # loss callback owns it
                try:
                    ping = client.call(
                        "ping", timeout=pod.heartbeat_interval_s * 2
                    )
                    w.last_ping = ping
                    w.last_ok_t = time.monotonic()
                except (WorkerLostError, TimeoutError):
                    pass
                now = time.monotonic()
                # gateway-OBSERVED liveness (how long since this worker
                # last answered a ping), as opposed to the worker's own
                # self-reported engine beat — the gap between the two
                # is exactly what diagnoses a wedged RPC plane
                metrics.POD_HEARTBEAT_AGE.labels(
                    worker=str(w.idx)
                ).set(round(max(0.0, now - w.last_ok_t), 3))
                with self._lock:
                    inflight = sum(
                        1
                        for s in self._inflight.values()
                        if s._worker_idx == w.idx
                    )
                metrics.POD_WORKER_INFLIGHT.labels(
                    worker=str(w.idx)
                ).set(inflight)
                if now - w.last_ok_t > pod.heartbeat_timeout_s:
                    # unresponsive but process alive: the zombie case —
                    # fence it out and replace it; its late frames are
                    # discarded by the epoch check
                    self._handle_loss(
                        w.idx,
                        w.epoch,
                        "heartbeat",
                        f"no ping reply for "
                        f"{now - w.last_ok_t:.1f}s",
                    )
                    continue
                beat = (w.last_ping or {}).get("beat")
                if beat and rec.enabled:
                    verdict = classify_heartbeat(
                        {
                            "t": now - float(beat.get("age_s", 0.0)),
                            "kind": beat.get("kind"),
                            "compiling": beat.get("compiling", False),
                        },
                        now,
                        rec.step_stall_s,
                        rec.compile_grace_s,
                    )
                    if verdict is not None:
                        # the worker's OWN supervisor also sees this
                        # stall and restarts in-process; only declare
                        # the worker lost when the wedge outlives the
                        # cross-process budget too
                        if (
                            verdict["stalled_s"]
                            > pod.heartbeat_timeout_s
                        ):
                            with self._lock:
                                self.total_stalls += 1
                            self._handle_loss(
                                w.idx,
                                w.epoch,
                                "heartbeat",
                                f"engine beat stalled "
                                f"{verdict['stalled_s']:.1f}s in "
                                f"{verdict['phase']}",
                            )

    def _on_lost(self, idx: int, epoch: int, exc: Optional[BaseException]) -> None:
        reason = "eof"
        if exc is not None and not isinstance(exc, ConnectionError):
            reason = "crash"
        self._handle_loss(idx, epoch, reason, str(exc) if exc else "EOF")

    def _handle_loss(
        self, idx: int, epoch: int, reason: str, detail: str
    ) -> None:
        """Declare one worker incarnation lost: fence it, fail over its
        in-flight sequences, start the supervised respawn.  Idempotent
        per incarnation — the epoch check makes late/duplicate loss
        signals (reader EOF racing the monitor) no-ops."""
        with self._lock:
            if self._stopping:
                return
            w = self.workers[idx]
            if w.epoch != epoch or w.state not in ("serving",):
                return  # already handled (or a fenced zombie's echo)
            # bump the epoch NOW: from this instant every frame the old
            # incarnation still emits mis-stamps and is discarded
            w.epoch += 1
            w.state = "down"
            w.last_fatal = f"{reason}: {detail}"
            self.total_failovers += 1
            old_client, w.client = w.client, None
            old_proc, w.proc = w.proc, None
            victims = [
                s for s in self._inflight.values() if s._worker_idx == idx
            ]
            lost_handoffs = 0
            for s in victims:
                self._inflight.pop(s._sid, None)
                # a handoff whose prefill side just died: cancel the
                # record so the transfer thread stands down — the
                # replay below re-prefills on a survivor (budgeted)
                rec = self._handoffs.pop(s._sid, None)
                if rec is not None:
                    rec.cancelled = True
                    self.total_handoff_failed += 1
                    lost_handoffs += 1
            # gateway-synthesized post-mortem (the incarnation can no
            # longer report its own): same shape the monolithic
            # supervisor keeps for /stats → engine.last_crash, with
            # the dead incarnation's last cached flight ticks attached
            cache = self._flight_cache.get(idx)
            self._last_crash = {
                "time": time.time(),
                "error": (
                    f"WorkerLost: worker {idx} (epoch {epoch}) — "
                    f"{reason}: {detail}"
                ),
                "worker": idx,
                "epoch": epoch,
                "ticks": (
                    (cache.get("ticks") or [])[-32:]
                    if cache and cache.get("epoch") == epoch
                    else []
                ),
                "in_flight": [
                    {"sid": s._sid, "request_id": s.request_id}
                    for s in victims
                ],
            }
        for _ in range(lost_handoffs):
            metrics.HANDOFF_TOTAL.labels(outcome="failed").inc()
        metrics.POD_WORKER_LOSSES.labels(reason=reason).inc()
        self._set_alive_gauge()
        logger.error(
            "engine worker lost",
            extra={
                "extra_data": {
                    "worker": idx,
                    "epoch": epoch,
                    "reason": reason,
                    "detail": detail,
                    "inflight": len(victims),
                }
            },
        )
        if old_client is not None:
            if reason == "heartbeat" and not old_client.dead:
                # zombie: keep its connection DRAINING so late frames
                # are observed (and counted as fenced) rather than
                # buffered in the kernel; the process is reaped at
                # stop() — killing it here would also kill the drill's
                # evidence that fencing works
                self._fenced_clients.append(old_client)
            else:
                old_client.close()
        if old_proc is not None:
            if reason == "heartbeat" and self._pod_cfg.transport == "uds":
                self._zombie_procs.append(old_proc)
            else:
                # TCP respawn rebinds the same port; a lingering
                # process would hold it
                self._kill_proc(old_proc)
        for s in victims:
            self._replay(s, exclude=idx, planned=False)
        threading.Thread(
            target=self._respawn_loop,
            args=(idx,),
            daemon=True,
            name=f"vgt-pod-respawn-{idx}",
        ).start()

    def _replay(
        self, seq: _PodSequence, exclude: int, planned: bool
    ) -> None:
        """Fold one orphaned sequence and resubmit it to a survivor —
        dp's ``_redistribute``, cross-process.  ``planned`` movements
        (drain/evacuate) never spend the crash-resume budget."""
        if seq.done_event.is_set():
            return
        with self._lock:
            adopted = seq._sid in self._adopted_sids
            if adopted:
                self._adopted_sids.discard(seq._sid)
                self.total_lost += 1
        if adopted:
            # an adopted SHELL has no prompt on this gateway — it rode
            # a predecessor's crash once already and its worker just
            # died too; fail typed (clients retry with their
            # idempotency key) instead of replaying garbage
            metrics.LOST_SEQUENCES.labels(reason="adopted").inc()
            err = WorkerLostError(
                "adopted in-flight request lost its worker before "
                "finishing; retry with the same Idempotency-Key",
                retry_after=self.retry_after_s,
            )
            seq.fail(err)
            self._notify_adopted_done(seq, result=None, error=str(err))
            return
        if seq.abort_requested:
            # the client already walked away; don't burn a survivor's
            # slots replaying it
            seq.finish("abort")
            return
        if planned:
            seq.prepare_migrate()
        else:
            if seq.resume_count >= self._recovery.max_resume_attempts:
                with self._lock:
                    self.total_lost += 1
                metrics.LOST_SEQUENCES.labels(reason="max_attempts").inc()
                seq.fail(
                    ResumeExhaustedError(
                        f"request rode {seq.resume_count} worker losses "
                        "and still never finished; giving up "
                        "(retryable)",
                        retry_after=self.retry_after_s,
                    )
                )
                return
            seq.prepare_resume()
        try:
            self._dispatch_submit(seq, exclude=exclude)
        except WorkerLostError:
            # no survivor right now: park it — the respawn completion
            # replays orphans, and stop()/budget-exhaustion fails them
            with self._lock:
                self._orphans.append(seq)
            return
        except BaseException as exc:  # noqa: BLE001 — typed refusal
            seq.fail(exc)
            return
        with self._lock:
            if planned:
                self.total_migrated += 1
            else:
                self.total_resumed += 1
        if planned:
            metrics.MIGRATIONS.labels(reason="drain").inc()
        else:
            metrics.RESUMED_SEQUENCES.inc()

    def _drain_orphans(self) -> None:
        with self._lock:
            orphans, self._orphans = self._orphans, []
        for seq in orphans:
            if not seq.done_event.is_set():
                try:
                    self._dispatch_submit(seq)
                except BaseException as exc:  # noqa: BLE001
                    seq.fail(
                        exc
                        if isinstance(exc, WorkerLostError)
                        else WorkerLostError(
                            f"orphan replay failed: {exc}",
                            retry_after=self.retry_after_s,
                        )
                    )

    def _fail_orphans(self, detail: str) -> None:
        with self._lock:
            orphans, self._orphans = self._orphans, []
        for seq in orphans:
            if not seq.done_event.is_set():
                with self._lock:
                    self.total_lost += 1
                metrics.LOST_SEQUENCES.labels(reason="no_replica").inc()
                seq.fail(WorkerLostError(detail))

    def _respawn_loop(self, idx: int) -> None:
        """Supervised respawn with the shared sliding restart budget and
        capped exponential backoff; a respawned worker passes the
        canary gate before it becomes routable."""
        w = self.workers[idx]
        rec = self._recovery
        while not self._stopping:
            now = time.monotonic()
            with self._lock:
                if w.respawning:
                    return
                if restart_budget_remaining(
                    self._restart_times, rec, now
                ) <= 0:
                    w.state = "dead"
                    budget_gone = True
                else:
                    budget_gone = False
                    w.respawning = True
                    self._restart_times.append(now)
                    backoff = min(
                        rec.backoff_cap_s,
                        rec.backoff_base_s
                        * (2 ** len(self._restart_times)),
                    )
            if budget_gone:
                logger.error(
                    "worker respawn budget exhausted",
                    extra={"extra_data": {"worker": idx}},
                )
                if self.state is HealthState.DEAD:
                    self._fail_orphans(
                        "pod is dead: worker respawn budget exhausted"
                    )
                return
            time.sleep(backoff)
            try:
                self._spawn_and_gate(w)
                with self._lock:
                    w.respawning = False
                    self.total_restarts += 1
                metrics.POD_WORKER_RESTARTS.inc()
                logger.warning(
                    "engine worker respawned",
                    extra={
                        "extra_data": {
                            "worker": idx, "epoch": w.epoch,
                        }
                    },
                )
                return
            except BaseException as exc:  # noqa: BLE001 — retry loop
                logger.error(
                    "worker respawn attempt failed",
                    extra={
                        "extra_data": {
                            "worker": idx, "error": str(exc),
                        }
                    },
                )
                with self._lock:
                    w.respawning = False
                if w.proc is not None:
                    self._kill_proc(w.proc)
                if w.client is not None:
                    w.client.close()
                continue

    # ------------------------------------------------------------- health

    @property
    def state(self) -> HealthState:
        alive = sum(1 for w in self.workers if w.alive)
        if alive == 0:
            return HealthState.DEAD
        if alive < len(self.workers) or any(
            w.draining for w in self.workers
        ):
            return HealthState.DEGRADED
        return HealthState.SERVING

    @property
    def retry_after_s(self) -> float:
        rec = self._recovery
        with self._lock:
            n = len(self._restart_times)
        return max(
            1.0, min(rec.backoff_cap_s, rec.backoff_base_s * (2 ** n))
        )

    def _set_alive_gauge(self) -> None:
        alive = sum(1 for w in self.workers if w.alive)
        metrics.POD_WORKERS_ALIVE.set(alive)
        metrics.POD_WORKERS_TOTAL.set(len(self.workers))
        counts = {"prefill": 0, "decode": 0, "mixed": 0}
        for w in self.workers:
            if w.alive:
                counts[self._role(w.idx)] += 1
        for role, n in counts.items():
            metrics.POOL_WORKERS.labels(role=role).set(n)

    def _worker_entry(self, w: _Worker, now: float) -> Dict[str, Any]:
        if w.draining:
            state = "draining"
        elif w.alive:
            state = "serving"
        elif w.state == "dead":
            state = "dead"
        elif w.state in ("spawning",) or w.respawning:
            state = "recovering"
        else:
            with self._lock:
                remaining = restart_budget_remaining(
                    self._restart_times, self._recovery, now
                )
            state = "recovering" if remaining > 0 else "dead"
        entry: Dict[str, Any] = {
            "replica": w.idx,
            "state": state,
            "epoch": w.epoch,
            "role": self._role(w.idx),
            "pid": w.proc.pid if w.proc is not None else None,
        }
        if w.last_fatal:
            entry["last_fatal"] = w.last_fatal
        sig = (w.last_ping or {}).get("pressure") or {}
        if sig:
            entry["queue_depth"] = sig.get("engine_queue_depth", 0)
            entry["running"] = sig.get("running", 0)
        beat = (w.last_ping or {}).get("beat")
        if beat:
            entry["beat_age_s"] = round(float(beat.get("age_s", 0.0)), 3)
            entry["compiling"] = bool(beat.get("compiling", False))
        return entry

    def health(self) -> Dict[str, Any]:
        """The /health engine block — ReplicatedEngine's shape with
        per-WORKER detail (state, epoch, pid, last fatal, beat age) so
        operators see which process is out and which incarnation is
        live."""
        now = time.monotonic()
        state = self.state
        self._set_alive_gauge()
        with self._lock:
            draining = sorted(
                w.idx for w in self.workers if w.draining
            )
            restarts_remaining = restart_budget_remaining(
                self._restart_times, self._recovery, now
            )
        return {
            "state": state.value,
            "alive": state_is_alive(state.value),
            "ready": state_is_ready(state.value),
            "dp": len(self.workers),
            "workers": len(self.workers),
            "replicas_alive": sum(1 for w in self.workers if w.alive),
            "replicas_draining": len(draining),
            "draining": draining,
            "replicas": [
                self._worker_entry(w, now) for w in self.workers
            ],
            "failovers": self.total_failovers,
            "restarts": self.total_restarts,
            "restarts_remaining": restarts_remaining,
            "stalls": self.total_stalls,
            "resumed": self.total_resumed,
            "migrated": self.total_migrated,
            "lost": self.total_lost,
            "quarantined": 0,
            "fenced_frames": self.fenced_frames,
            "handoffs": self._handoff_stats(),
            "adoption": {
                "adopted": self.total_adopted,
                "orphans_found": self.total_orphans_found,
                "orphans_expired": self.total_orphans_expired,
                "adopted_inflight": len(self.adopted_request_ids),
            },
        }

    def device_health(self) -> Dict[str, Any]:
        entries = []
        for w in self.workers:
            dev = dict(w.hello.get("device_health") or {})
            dev["worker"] = w.idx
            dev["alive"] = bool(dev.get("alive", False)) and w.alive
            entries.append(dev)
        return {
            "alive": any(e.get("alive") for e in entries),
            "workers": entries,
        }

    # ---------------------------------------------------------- stats/perf

    def _collect(
        self, op: str, timeout: float = 5.0, **fields: Any
    ) -> List[Dict[str, Any]]:
        out = []
        for w in self._alive_workers():
            client = w.client
            if client is None:
                continue
            try:
                out.append(client.call(op, timeout=timeout, **fields))
            except Exception:  # noqa: BLE001 — introspection best-effort
                continue
        return out

    def get_stats(self) -> Dict[str, Any]:
        per_worker = self._collect("stats")
        agg: Dict[str, Any] = {
            key: sum(int(s.get(key, 0)) for s in per_worker)
            for key in (
                "steps",
                "prefills",
                "decode_tokens",
                "state_rebuilds",
                "kv_pages_total",
                "kv_token_capacity",
            )
        }
        agg["scheduler"] = {}
        if per_worker:
            for key, val in (per_worker[0].get("scheduler") or {}).items():
                if isinstance(val, bool):
                    agg["scheduler"][key] = val
                elif isinstance(val, (int, float)):
                    agg["scheduler"][key] = sum(
                        s.get("scheduler", {}).get(key, 0)
                        for s in per_worker
                    )
                elif isinstance(val, dict):
                    agg["scheduler"][key] = {
                        k2: (
                            sum(
                                s.get("scheduler", {})
                                .get(key, {})
                                .get(k2, 0)
                                for s in per_worker
                            )
                            if isinstance(v2, (int, float))
                            and not isinstance(v2, bool)
                            else v2
                        )
                        for k2, v2 in val.items()
                    }
        agg["model"] = self.spec.name
        agg["dp"] = len(self.workers)
        agg["failover"] = {
            "failovers": self.total_failovers,
            "restarts": self.total_restarts,
            "stalls": self.total_stalls,
            "resumed": self.total_resumed,
            "lost": self.total_lost,
            "replicas_alive": sum(1 for w in self.workers if w.alive),
        }
        agg["migration"] = {
            "migrated": self.total_migrated,
            "draining": sorted(
                w.idx for w in self.workers if w.draining
            ),
            "free_slices": 0,
        }
        perfs = [s["perf"] for s in per_worker if "perf" in s]
        if perfs:
            agg["perf"] = perf_attr.merge_stats(perfs)
        agg["mesh"] = dict(self.mesh.shape)
        agg["load_time_s"] = round(self.load_time_s, 2)
        agg["pod"] = {
            "workers": [
                {
                    "worker": w.idx,
                    "epoch": w.epoch,
                    "state": w.state,
                    "role": self._role(w.idx),
                    "draining": w.draining,
                    "pid": w.proc.pid if w.proc is not None else None,
                }
                for w in self.workers
            ],
            "transport": self._pod_cfg.transport,
            "fenced_frames": self.fenced_frames,
            "inflight": len(self._inflight),
            "orphans": len(self._orphans),
            "roles": list(self._roles),
            "handoffs": self._handoff_stats(),
            "adopted": self.total_adopted,
            "orphans_expired": self.total_orphans_expired,
        }
        crashes = [
            s["last_crash"]
            for s in per_worker
            if isinstance(s.get("last_crash"), dict)
        ]
        with self._lock:
            if self._last_crash is not None:
                crashes.append(self._last_crash)
        if crashes:
            # newest post-mortem wins the top-level slot the monolithic
            # supervisor exposes, so /stats → engine.last_crash reads
            # the same in pod mode (worker-internal engine crashes and
            # gateway-declared worker losses both land here)
            agg["last_crash"] = max(
                crashes, key=lambda c: float(c.get("time") or 0.0)
            )
        agg["replicas"] = per_worker
        return agg

    def pressure_signals(self) -> Dict[str, Any]:
        """Worst-of / summed admission gauges from the cached heartbeat
        payloads (never an extra RPC on the admission path)."""
        ratios = []
        depth = running = 0
        for w in self._alive_workers():
            sig = (w.last_ping or {}).get("pressure") or {}
            if "kv_free_ratio" in sig:
                ratios.append(sig["kv_free_ratio"])
            depth += int(sig.get("engine_queue_depth", 0))
            running += int(sig.get("running", 0))
        out: Dict[str, Any] = {
            "engine_queue_depth": depth,
            "running": running,
        }
        if ratios:
            out["kv_free_ratio"] = min(ratios)
        return out

    def perf_snapshot(self) -> Dict[str, Any]:
        snaps = self._collect("perf")
        merged = perf_attr.merge_snapshots(snaps) if snaps else {}
        # stamp the pod topology + handoff outcome counters onto the
        # merged view: loadlab's per-cell /debug/perf delta then lands
        # worker count and handoff outcomes next to the phase seconds,
        # so a disaggregated sweep row shows how many transfers the
        # cell's tok/s number actually paid for
        stats = self._handoff_stats()
        merged["pod"] = {
            "workers": len(self.workers),
            "workers_alive": len(self._alive_workers()),
            "handoffs": {
                key: stats[key]
                for key in ("completed", "fallback_monolithic", "failed")
            },
        }
        return merged

    @property
    def flight(self) -> _PodFlight:
        """The merged pod flight view — app.py's ``_flight_recorder``
        picks this up exactly like dp's ``_MergedFlight``, so
        /debug/flight and /debug/requests work unchanged in pod mode."""
        return self._flight

    def collect_spans(self) -> List[Dict[str, Any]]:
        """Workers' in-memory span recorders (``spans`` verb, armed by
        ``VGT_MEMTRACE=1`` in the worker env), worker-stamped — the
        gateway's /debug/spans merges these with its own recorder so a
        drill can assert cross-process span parentage from one page."""
        out: List[Dict[str, Any]] = []
        for w in self._alive_workers():
            client = w.client
            if client is None:
                continue
            try:
                reply = client.call("spans")
            except Exception:  # noqa: BLE001 — introspection best-effort
                continue
            for span in reply.get("spans") or []:
                span = dict(span)
                span["worker"] = w.idx
                out.append(span)
        return out

    def pod_debug(self) -> Dict[str, Any]:
        """The /debug/pod payload: live topology (per-worker
        incarnation + liveness detail + in-flight load), the mid-air
        handoff table, and the fencing/orphan counters — one page
        answering "which process is sick and what is in the air"."""
        now = time.monotonic()
        entries = [self._worker_entry(w, now) for w in self.workers]
        with self._lock:
            by_worker: Dict[int, int] = {}
            for s in self._inflight.values():
                by_worker[s._worker_idx] = (
                    by_worker.get(s._worker_idx, 0) + 1
                )
            table = [
                {
                    "sid": rec.sid,
                    "request_id": rec.seq.request_id,
                    "state": rec.state,
                    "prefill": rec.prefill_idx,
                    "prefill_epoch": rec.prefill_epoch,
                    "target": (
                        rec.target_idx if rec.target_idx >= 0 else None
                    ),
                    "pages": rec.pages,
                    "nbytes": rec.nbytes,
                    "attempts": rec.attempts,
                    "age_s": round(now - rec.t0, 3),
                }
                for rec in self._handoffs.values()
            ]
            inflight = len(self._inflight)
            orphans = len(self._orphans)
            fenced = self.fenced_frames
            last_crash = self._last_crash
        for entry in entries:
            entry["inflight"] = by_worker.get(entry["replica"], 0)
        return {
            "workers": entries,
            "transport": self._pod_cfg.transport,
            "roles": list(self._roles),
            "inflight": inflight,
            "orphans": orphans,
            "fenced_frames": fenced,
            "handoffs": {**self._handoff_stats(), "table": table},
            "adoption": {
                "adopted": self.total_adopted,
                "orphans_found": self.total_orphans_found,
                "orphans_expired": self.total_orphans_expired,
                "adopted_inflight": sorted(
                    self.adopted_request_ids.values()
                ),
            },
            "last_crash": last_crash,
        }

    def reset_launches(self) -> Dict[int, Dict[str, int]]:
        """Port-only: set every live worker's kernel launch counts to 0
        (their counts before, by worker)."""
        out: Dict[int, Dict[str, int]] = {}
        for w in self._alive_workers():
            client = w.client
            if client is not None:
                out[w.idx] = client.call("reset_launches")
        return out

    def warmup(self, buckets: Optional[List[int]] = None) -> float:
        """Every live worker's warm-up, all at once (each captures its
        own decode graphs in its own process); the sum of their
        seconds."""
        seconds: List[float] = []

        def one(client: WorkerClient) -> None:
            try:
                reply = client.call(
                    "warmup", timeout=self._pod_cfg.spawn_timeout_s,
                    buckets=buckets,
                )
            except Exception:  # noqa: BLE001 — as _collect: best-effort
                return
            seconds.append(float(reply.get("seconds", 0.0)))

        threads = [
            threading.Thread(target=one, args=(w.client,), daemon=True,
                             name=f"vgt-pod-warmup-{w.idx}")
            for w in self._alive_workers() if w.client is not None
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return sum(seconds)

    # ---------------------------------------------------- admin / topology

    def drain_replica(self, idx: int, timeout: float = 30.0) -> Dict[str, Any]:
        """/admin/replicas drain, per worker: evacuate its residents
        over RPC and replay them onto the other workers as planned
        movements.  A worker dying mid-drain falls back to the loss
        path — same fold, same replay, crash counters instead."""
        if not 0 <= idx < len(self.workers):
            raise MigrationRefusedError(f"no worker {idx}")
        w = self.workers[idx]
        if not w.alive:
            raise MigrationRefusedError(
                f"worker {idx} is not serving (state {w.state!r})"
            )
        if not self._alive_workers(exclude=idx):
            raise MigrationRefusedError(
                "no drain target: every other worker is down or "
                "draining"
            )
        with self._lock:
            w.draining = True
        client = w.client
        try:
            reply = client.call(
                "evacuate", timeout=timeout, reason="drain",
                sids=None, timeout_s=timeout,
            )
        except (WorkerLostError, TimeoutError) as exc:
            # the loss machinery (triggered by the same failure) owns
            # the residents; report the drain as degraded-but-handled
            return {
                "drained": 0,
                "fell_back_to_failover": True,
                "error": str(exc),
            }
        moved = 0
        for entry in reply.get("evacuated") or []:
            with self._lock:
                seq = self._inflight.pop(int(entry["sid"]), None)
            if seq is not None:
                self._replay(seq, exclude=idx, planned=True)
                moved += 1
        metrics.REPLICAS_DRAINING.set(
            sum(1 for x in self.workers if x.draining)
        )
        return {"drained": moved, "worker": idx, "epoch": w.epoch}

    def undrain_replica(self, idx: int) -> Dict[str, Any]:
        if not 0 <= idx < len(self.workers):
            raise MigrationRefusedError(f"no worker {idx}")
        with self._lock:
            self.workers[idx].draining = False
        metrics.REPLICAS_DRAINING.set(
            sum(1 for x in self.workers if x.draining)
        )
        return {"worker": idx, "draining": False}

    def add_replica(self, *args: Any, **kwargs: Any) -> None:
        raise MigrationRefusedError(
            "pod.workers is fixed at boot: worker processes own device "
            "slices assigned at spawn; scale the pod by restarting with "
            "a new pod.workers"
        )

    def remove_replica(self, *args: Any, **kwargs: Any) -> None:
        raise MigrationRefusedError(
            "pod.workers is fixed at boot; drain a worker instead "
            "(POST /admin/replicas/{i}/drain) to take it out of "
            "rotation"
        )

    # ---------------------------------------------------------- lifecycle

    def _kill_proc(self, proc: subprocess.Popen) -> None:
        try:
            proc.terminate()
            try:
                proc.wait(timeout=5.0)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=5.0)
        except OSError:
            pass

    def stop(self) -> None:
        self._stopping = True
        with self._lock:
            workers = list(getattr(self, "workers", []))
            fenced = list(self._fenced_clients)
            zombies = list(self._zombie_procs)
            self._fenced_clients.clear()
            self._zombie_procs.clear()
        self._fail_orphans("pod is shutting down")
        for w in workers:
            client = w.client
            if client is not None and not client.dead:
                try:
                    client.call("stop", timeout=2.0)
                except Exception:  # noqa: BLE001 — teardown best-effort
                    pass
                client.close()
            w.client = None
            w.state = "down"
            if w.proc is not None:
                self._kill_proc(w.proc)
        for client in fenced:
            client.close()
        for proc in zombies:
            self._kill_proc(proc)
        if self._monitor is not None:
            self._monitor.join(timeout=2.0)
        try:
            os.unlink(self._config_path)
        except OSError:
            pass
        if self._own_socket_dir:
            try:
                for name in os.listdir(self.socket_dir):
                    try:
                        os.unlink(os.path.join(self.socket_dir, name))
                    except OSError:
                        pass
                os.rmdir(self.socket_dir)
            except OSError:
                pass
