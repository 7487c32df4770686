"""Data parallelism for serving: replica engines + a least-loaded router.

The PyTorch counterpart of vgate_tpu/runtime/dp_engine.py.  Decode for
independent requests is embarrassingly parallel, so data parallelism is
**replication, not collectives**: each of the ``device.dp`` replicas is a
one-device :class:`EngineCore` of its own, in this process, on its slice
of ``device.devices`` (weights replicated, KV pool and continuous-batching
state private), and a router spreads requests across replicas by load,
with prefix affinity.

``ReplicatedEngine`` exposes the surface the backend drives on
``EngineCore`` (submit/generate/warmup/stats/health), so ``dp=1`` and
``dp>1`` are interchangeable behind ``TorchCUDABackend``.

**Replica failover** (recovery.enabled): a replica whose engine died —
fatal crash OR a watchdog-declared stall (the repair thread classifies
each replica's heartbeat like the dp=1 supervisor does) — has its
checkpointed in-flight sequences redistributed to surviving replicas
(recovery.resume_in_flight), so clients see a latency blip instead of
losing every resident request with the replica.  The repair thread then
rebuilds the dead replica in place (weights kept, capped backoff, the
recovery.* restart budget shared across replicas) and ``/health``
reports per-replica state: DEGRADED while n_alive < dp, SERVING once
recovery restores the full complement, DEAD only when no replica can
serve.

**Planned migration** (migration.*): drain/undrain, elastic
add/remove on banked device slices and the rebalancing policy move live
sequences between replicas through ``EngineCore.evacuate`` and
``replay_into``, never spending a request's crash-resume budget.

**One process, several cores** (the port's part).  Replicas that name
one card share it: each sizes its pool against ``hbm_utilization`` x the
card / (replicas on the card), less its own weights
(``device.kv_budget_bytes`` in its config, ``shared_process``), never
against the memory free when it boots, also after a sibling's rebuild or
an ``add_replica``.  The cores guard their own threads' device, capture
their decode graphs on streams of their own, keep their kernel launch
counts apart during captures, and leave cuBLAS's workspaces to the
siblings whose graphs use them (runtime/engine_core.py,
runtime/decode_graph.py).  A replica that is itself a mesh (tp or ep >
1) is not ported (the config refuses it: queue 1, item 10b (rest)).
"""

from __future__ import annotations

import contextlib
import copy
import functools
import itertools
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Sequence as Seq

import torch

from vgate_tpu_torch import faults
from vgate_tpu_torch.backends.base import SamplingParams
from vgate_tpu_torch.config import VGTConfig, get_config
from vgate_tpu_torch.errors import (
    EngineRecoveringError,
    EngineStalledError,
    IntegrityError,
    MigrationError,
    MigrationRefusedError,
    PoisonRequestError,
    state_is_alive,
    state_is_ready,
)
from vgate_tpu_torch.integrity import CanaryKeeper
from vgate_tpu_torch.logging_config import get_logger
from vgate_tpu_torch.observability import perf as perf_attr
from vgate_tpu_torch.parallel.mesh import visible_devices
from vgate_tpu_torch.runtime import engine_metrics as metrics
from vgate_tpu_torch.runtime.engine_core import (
    EngineCore,
    _release_device_state,
    rebuild_core,
    replay_into,
)
from vgate_tpu_torch.runtime.sequence import Sequence, SeqStatus
from vgate_tpu_torch.runtime.supervisor import (
    HealthState,
    classify_fatal,
    classify_heartbeat,
    restart_budget_remaining,
)

logger = get_logger(__name__)

# Threading: fleet topology (replicas, device slices, draining and
# corrupt marks, rebuild bookkeeping) mutates only under _topology_lock;
# structural ops (drain/undrain/add/remove) also hold _structural_lock
# for their whole duration (see _structural), and take _topology_lock
# inside it.


class _MergedFlight:
    """View merging the replicas' flight recorders so /debug works on
    dp>1 pods (each replica records independently; entries are stamped
    with their replica index and merged by wall time).  Pod-level
    writers (the batcher's overload tick) land on one live recorder so
    the merged timeline carries them exactly once."""

    def __init__(self, replicas: List[EngineCore]) -> None:
        self._replicas = replicas

    @property
    def enabled(self) -> bool:
        return any(r.flight.enabled for r in self._replicas)

    def record_tick(self, kind: str, **fields: Any) -> None:
        for core in self._replicas:
            if core.flight.enabled:
                core.flight.record_tick(kind, **fields)
                return

    def _merged(self, method: str, n: Optional[int]) -> List[Dict[str, Any]]:
        out = []
        for i, core in enumerate(self._replicas):
            for entry in getattr(core.flight, method)():
                entry = dict(entry)
                entry["replica"] = i
                out.append(entry)
        out.sort(key=lambda e: e.get("t") or e.get("arrival_t") or 0.0)
        if n is not None and n >= 0:
            out = out[-n:]
        return out

    def ticks(self, n: Optional[int] = None) -> List[Dict[str, Any]]:
        return self._merged("ticks", n)

    def requests(self, n: Optional[int] = None) -> List[Dict[str, Any]]:
        return self._merged("requests", n)

    def live_requests(self) -> List[Dict[str, Any]]:
        return self._merged("live_requests", None)

    def find_request(self, ident: str) -> Optional[Dict[str, Any]]:
        # newest attempt wins ACROSS replicas too (a retry may land on
        # a different replica than the failed original)
        best: Optional[Dict[str, Any]] = None
        for i, core in enumerate(self._replicas):
            record = core.flight.find_request(ident)
            if record is None:
                continue
            record = dict(record)
            record["replica"] = i
            if best is None or (record.get("arrival_t") or 0.0) > (
                best.get("arrival_t") or 0.0
            ):
                best = record
        return best

    def get_stats(self) -> Dict[str, Any]:
        return {
            "enabled": self.enabled,
            "replicas": [r.flight.get_stats() for r in self._replicas],
        }


class RebalancePolicy:
    """Hysteresis-gated, rate-limited rebalancing decisions (pure
    policy, injectable clock — fake-clock unit-testable without an
    engine).  A replica is **hot** while its ``kv_free_ratio`` /
    ``engine_queue_depth`` pressure signals cross the migration.*
    watermarks; a move is decided only when a replica has been
    CONTINUOUSLY hot for ``rebalance_hold_s`` (one pressured tick is
    admission's job, not migration's), an **idle** sibling exists to
    receive the work, and the last move is at least
    ``rebalance_cooldown_s`` old — so the policy can never thrash a
    sequence back and forth between two busy replicas."""

    def __init__(self, cfg: Any, clock: Callable[[], float] = time.monotonic):
        self.cfg = cfg
        self.clock = clock
        # replica idx -> monotonic time it first turned hot; cleared on
        # ANY cool observation (hysteresis: sustained pressure only)
        self._hot_since: Dict[int, float] = {}
        self._last_move_t: Optional[float] = None

    def reset(self) -> None:
        """Topology changed (add/remove/undrain): stale per-index
        hysteresis state must not carry over to a renumbered fleet."""
        self._hot_since.clear()

    def observe(
        self, signals: Dict[int, Dict[str, Any]]
    ) -> Optional[tuple]:
        """One policy tick over {replica_idx: pressure_signals()}.
        Returns ``(hot_idx, cold_idx)`` when a move is due, else None.
        Mutates hysteresis/rate-limit state — call once per interval."""
        now = self.clock()
        cfg = self.cfg
        hot: list = []
        cold: list = []
        for idx, sig in signals.items():
            free = sig.get("kv_free_ratio", 1.0)
            depth = sig.get("engine_queue_depth", 0)
            if (
                free <= cfg.hot_kv_free_ratio
                or depth >= cfg.hot_queue_depth
            ):
                self._hot_since.setdefault(idx, now)
                hot.append((free, idx))
            else:
                self._hot_since.pop(idx, None)
                if free >= cfg.idle_kv_free_ratio and depth == 0:
                    cold.append((free, idx))
        # drop hysteresis state for replicas no longer reporting
        # (dead/draining/removed) so they cannot ripen while absent
        for idx in list(self._hot_since):
            if idx not in signals:
                self._hot_since.pop(idx)
        if not hot or not cold:
            return None
        if (
            self._last_move_t is not None
            and now - self._last_move_t < cfg.rebalance_cooldown_s
        ):
            return None
        ripe = [
            (free, idx)
            for free, idx in hot
            if now - self._hot_since[idx] >= cfg.rebalance_hold_s
        ]
        if not ripe:
            return None
        hot_idx = min(ripe)[1]  # hottest: lowest free ratio
        cold_idx = max(cold)[1]  # coldest: highest free ratio
        self._last_move_t = now
        return hot_idx, cold_idx

    def note_move_failed(self) -> None:
        """The executor moved NOTHING for the decision just issued (no
        eligible victims, kv-dtype mismatch, evacuation failure):
        release the rate-limit stamp so the still-pressured replica is
        re-eligible next tick instead of silently burning a full
        cooldown.  Thrash-safe — nothing moved, so there is nothing to
        ping-pong; retries are bounded by the policy tick interval."""
        self._last_move_t = None


def _structural(fn):
    """Serialize a whole structural op (drain/undrain/add/remove) on
    ``self._structural_lock``.  These ops release ``_topology_lock``
    for the long evacuation/build phase (seconds to minutes on real
    hardware), but decisions keyed on replica indices or the fleet
    size taken BEFORE that phase are reused after it — two concurrent
    removes on dp=2 would otherwise both pass the last-replica guard,
    and a drain's draining-mark could land on a renumbered index.
    Short readers (router, sweep, health, rebalance snapshot) stay on
    ``_topology_lock`` and are never blocked by this."""
    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        with self._structural_lock:
            return fn(self, *args, **kwargs)
    return wrapper


def replica_devices(device_config, devices: Optional[list] = None
                    ) -> List[List[str]]:
    """Each replica's device slice, replica 0 first (one device a
    replica): ``devices`` (the engine's argument), else
    ``device.devices``, else the CPU once a replica, or the first ``dp``
    cards.  A card named more than once holds that many replicas."""
    dp = max(1, device_config.dp)
    if devices is None and device_config.devices:
        devices = list(device_config.devices)
    if devices is None:
        visible = visible_devices(device_config.device)
        if visible == ["cpu"]:
            devices = ["cpu"] * dp
        elif len(visible) < dp:
            raise ValueError(
                f"device.dp={dp} needs {dp} cards but {len(visible)} are "
                "visible; name a card once per replica in device.devices "
                "to run several replicas on one card"
            )
        else:
            devices = visible[:dp]
    devices = [str(d) for d in devices]
    if len(devices) % dp:
        raise ValueError(f"{len(devices)} devices not divisible by dp={dp}")
    per = len(devices) // dp
    return [devices[i * per : (i + 1) * per] for i in range(dp)]


class ReplicatedEngine:
    """``dp`` one-device EngineCore replicas in this process + a load
    router."""

    def __init__(
        self,
        config: Optional[VGTConfig] = None,
        devices: Optional[list] = None,
    ) -> None:
        self.config = config or get_config()
        dp = max(1, self.config.device.dp)
        self._device_slices = replica_devices(self.config.device, devices)
        # each replica sees a dp=1 copy of the config, its slice named
        # explicitly; on a card its share of the card rides in
        # device.kv_budget_bytes (the replicas naming that card, counted
        # at boot: a slice is banked and reused, never invented)
        replica_cfg = copy.deepcopy(self.config)
        replica_cfg.device.dp = 1
        replica_cfg.device.devices = []
        self._replica_cfg = replica_cfg
        self._card_count = {}
        for devs in self._device_slices:
            self._card_count[devs[0]] = self._card_count.get(devs[0], 0) + 1
        self.replicas: List[EngineCore] = []
        try:
            for i in range(dp):
                self.replicas.append(self._build(self._device_slices[i]))
        except BaseException:
            for core in self.replicas:
                self._retire(core)
            raise
        self._rr = itertools.count()
        self._route_lock = threading.Lock()
        # ---- replica failover / repair (recovery.enabled) ----
        self._recovery = self.config.recovery
        self._failover_enabled = bool(self._recovery.enabled)
        self._stopping = False
        self._repair_event = threading.Event()
        self._repair_thread: Optional[threading.Thread] = None
        # rebuild backoff: dead core identity -> next attempt monotonic
        # time (identity, not index — elastic dp can renumber replicas
        # while a rebuild is pending); the restart budget window is
        # SHARED across replicas (a pod crash-looping any subset of its
        # replicas is one sick pod)
        self._next_attempt: Dict[int, float] = {}
        self._restart_times: List[float] = []
        # dead-core identities with a rebuild thread in flight:
        # EngineCore construction takes tens of seconds on real
        # hardware, and running it inline in _sweep would block stall
        # detection and failover for every OTHER replica that long.
        # stop() joins these before stopping replicas, or a rebuild
        # finishing after shutdown would start() an engine nothing
        # owns.
        self._rebuilding: set = set()
        self._rebuild_threads: Dict[int, threading.Thread] = {}
        # ---- planned live migration (migration.*) ----
        self._mig = self.config.migration
        # replica indices marked draining: no NEW placements (router
        # skips them); residents were live-migrated to survivors.
        # DEGRADED-with-detail health until undrained or removed.
        self._draining: set = set()
        # structural changes (replicas list, device slices, draining
        # marks) and the repair sweep serialize on this — index-keyed
        # state must never shift under an iterating thread
        self._topology_lock = threading.RLock()
        # whole-op serialization for drain/undrain/add/remove (see
        # _structural): held across the evacuation phase that
        # _topology_lock deliberately releases
        self._structural_lock = threading.RLock()
        # device slices banked by remove_replica for add_replica to
        # reuse: elastic dp within the boot-time device partition
        self._free_slices: List[list] = []
        self._policy = RebalancePolicy(self._mig)
        self._balance_event = threading.Event()
        self._balance_thread: Optional[threading.Thread] = None
        self.total_migrated = 0
        # poison quarantine, pod-wide (the dp=1 supervisor's, minus the
        # repeat-offender streak — max_resume_attempts bounds replays
        # here): a fingerprint a poison-classified replica fatal names
        # (or its residents, when unnamed) is excluded from failover
        # redistribution AND rejected at submission, so one
        # crash-inducing request cannot serially kill healthy replicas
        self._quarantine: set = set()
        # repeat-offender streaks for sentinel-ATTRIBUTED corrupt
        # fatals (fingerprint -> consecutive trips); see
        # _update_quarantine — the dp twin of the supervisor's
        # transient streak, scoped to attributed sequences only
        self._corrupt_streaks: Dict[str, int] = {}
        # ---- silent-corruption defense (vgate_tpu/integrity.py) ----
        # replica indices quarantined for suspected corruption: routed
        # around (like draining), excluded as failover/migration
        # targets, and unquarantined only by a post-reload canary pass.
        # Renumbered with the fleet (remove_replica), like _draining.
        self._integrity_cfg = self.config.integrity
        self._corrupt: set = set()
        # one pod-wide canary keeper: replicas share weights, so a
        # greedy pinned probe has ONE correct fingerprint — recorded on
        # the first probe, verified everywhere after
        self._canary: Optional[CanaryKeeper] = (
            CanaryKeeper(self._integrity_cfg)
            if self._integrity_cfg.enabled
            and self._integrity_cfg.canary_enabled
            else None
        )
        # slow-timer probe schedule, replica-index keyed; probes run
        # off the repair thread, at most one in flight fleet-wide
        self._next_canary: Dict[int, float] = {}
        self._canary_probe: Optional[threading.Thread] = None
        self.total_corrupt_reloads = 0
        self.total_canary_failures = 0
        self.last_integrity: Optional[Dict[str, Any]] = None
        self.total_failovers = 0
        self.total_restarts = 0
        self.total_stalls = 0
        self.total_resumed = 0
        self.total_lost = 0
        if self._failover_enabled:
            for i, core in enumerate(self.replicas):
                self._attach(i, core)
        metrics.DP_REPLICAS_TOTAL.set(dp)
        metrics.DP_REPLICAS_ALIVE.set(dp)
        # /debug surface parity with dp=1: one merged recorder view
        self.flight = _MergedFlight(self.replicas)
        # convenience aliases: identical across replicas
        lead = self.replicas[0]
        self.spec = lead.spec
        self.tokenizer = lead.tokenizer
        self.geometry = lead.geometry
        self.mesh = lead.mesh
        self.device = lead.device
        self.load_time_s = sum(r.load_time_s for r in self.replicas)
        logger.info(
            "replicated engine ready",
            extra={
                "extra_data": {
                    "dp": dp,
                    "devices": self._device_slices,
                    "model": lead.spec.name,
                }
            },
        )

    # ------------------------------------------------- replica construction

    def _config_for(self, devices: list) -> VGTConfig:
        """The replica config of one device slice: on a card without a
        fixed pool size, its share of the card (``hbm_utilization`` x
        total / replicas naming it), which the core fills less its own
        weights."""
        cfg = self._replica_cfg
        dev = torch.device(devices[0])
        dcfg = cfg.device
        if dev.type != "cuda" or dcfg.kv_num_pages or dcfg.kv_budget_bytes:
            return cfg
        total = torch.cuda.get_device_properties(dev).total_memory
        cfg = copy.deepcopy(cfg)
        cfg.device.kv_budget_bytes = int(
            dcfg.hbm_utilization * total / self._card_count[devices[0]]
        )
        return cfg

    def _build(self, devices: list) -> EngineCore:
        return EngineCore(
            self._config_for(devices), devices=devices, shared_process=True
        )

    @staticmethod
    def _retire(core: EngineCore) -> None:
        """A replica leaving the fleet for good (removed, or built by a
        constructor that failed): stop it and drop its pools, graphs and
        weights now, so a later ``add_replica`` on its slice finds the
        memory free."""
        core.stop()
        _release_device_state(core)
        core.params = None
        core.integrity = None

    @property
    def _submit_lock(self):
        """Every replica's submit lock, held in index order: a batch
        queued under it is admitted as one wave on each replica (the
        backend queues a settled batch so)."""
        return self._all_submit_locks()

    @contextlib.contextmanager
    def _all_submit_locks(self):
        with contextlib.ExitStack() as stack:
            for core in list(self.replicas):
                stack.enter_context(core._submit_lock)
            yield

    # ------------------------------------------------------------- lifecycle

    def start(self) -> None:
        for core in self.replicas:
            core.start()
        if (
            self._canary is not None
            and self._integrity_cfg.canary_record_on_start
            and self._canary.expected is None
        ):
            # one boot-time baseline for the fleet (replicas share
            # weights, greedy ⇒ one correct fingerprint): every later
            # gate VERIFIES instead of re-recording — see the dp=1
            # supervisor's twin for why
            self._canary.check(self.replicas[0], context="boot")
        if self._failover_enabled and self._repair_thread is None:
            self._repair_thread = threading.Thread(
                target=self._repair_loop,
                name="vgt-dp-repair",
                daemon=True,
            )
            self._repair_thread.start()
        if (
            self._mig.enabled
            and self._mig.rebalance_enabled
            and self._balance_thread is None
        ):
            self._balance_thread = threading.Thread(
                target=self._balance_loop,
                name="vgt-dp-balance",
                daemon=True,
            )
            self._balance_thread.start()

    def stop(self) -> None:
        self._stopping = True
        self._repair_event.set()
        self._balance_event.set()
        if self._balance_thread is not None:
            self._balance_thread.join(timeout=30)
            self._balance_thread = None
        if self._repair_thread is not None:
            self._repair_thread.join(timeout=30)
            self._repair_thread = None
        # settle in-flight rebuilds BEFORE stopping replicas: a rebuild
        # finishing after the sweep below would start() a fresh engine
        # (and its HBM KV pool) that nothing ever stops
        for thread in list(self._rebuild_threads.values()):
            thread.join(timeout=30)
        for core in self.replicas:
            core.stop()

    # --------------------------------------------------- failover / repair

    def _attach(self, idx: int, core: EngineCore) -> None:
        # on_fatal makes the core CHECKPOINT its residents at a fatal
        # (resume_in_flight) instead of failing them raw — the repair
        # thread redistributes them to surviving replicas.  The hook
        # runs on the dying replica's engine thread (or the repair
        # thread itself for watchdog stalls), so it only signals.
        core.on_fatal = lambda exc, i=idx: self._on_replica_fatal(i, exc)

    def _on_replica_fatal(self, idx: int, exc: BaseException) -> None:
        logger.error(
            "dp replica engine fatal",
            extra={
                "extra_data": {
                    "replica": idx,
                    "error": f"{type(exc).__name__}: {exc}",
                }
            },
        )
        self._repair_event.set()

    def _repair_loop(self) -> None:
        while not self._stopping:
            self._repair_event.wait(timeout=0.25)
            self._repair_event.clear()
            if self._stopping:
                return
            try:
                self._sweep()
            except Exception:  # pragma: no cover - defensive
                logger.error("dp repair sweep failed", exc_info=True)
            try:
                # slow-timer canary probes run OUTSIDE the sweep's
                # topology lock: a greedy probe takes real decode time
                # and must not block structural ops or stall detection
                self._maybe_canaries()
            except Exception:  # pragma: no cover - defensive
                logger.error("dp canary pass failed", exc_info=True)

    def _sweep(self) -> None:
        """One repair pass: declare stalled replicas (hang watchdog,
        same heartbeat classification as the dp=1 supervisor),
        redistribute dead replicas' checkpointed residents to
        survivors, and rebuild dead replicas once their backoff is
        due.  Holds the topology lock: elastic dp (add/remove_replica)
        must never renumber the fleet under this iteration."""
        rec = self._recovery
        with self._topology_lock:
            self._sweep_locked(rec)

    def _sweep_locked(self, rec) -> None:
        for i in range(len(self.replicas)):
            # fresh clock per replica: heartbeat verdicts and backoff
            # stamps must not age by however long earlier replicas'
            # handling took
            now = time.monotonic()
            core = self.replicas[i]
            if id(core) in self._rebuilding:
                continue  # a rebuild thread owns this slot
            if core._fatal is None:
                if core._running and rec.step_stall_s > 0:
                    verdict = classify_heartbeat(
                        getattr(core, "_heartbeat", None),
                        now,
                        rec.step_stall_s,
                        rec.compile_grace_s,
                    )
                    if verdict is not None:
                        exc = EngineStalledError(
                            f"dp replica {i} heartbeat stale for "
                            f"{verdict['stalled_s']:.1f}s (limit "
                            f"{verdict['limit_s']:.1f}s) at phase "
                            f"{verdict['phase']!r}",
                            stalled_s=verdict["stalled_s"],
                            phase=verdict["phase"],
                        )
                        logger.error(
                            "dp replica stall detected",
                            extra={
                                "extra_data": {
                                    "replica": i, **verdict,
                                }
                            },
                        )
                        if core.declare_stalled(exc):
                            self.total_stalls += 1
                            metrics.ENGINE_STALLS.inc()
                continue
            if not core._containment_done:
                # _fatal publishes before the checkpoint sweep
                # finishes: acting now would take an empty checkpoint
                # and the rebuild's old.stop() would then claim the
                # late-published sequences as shutdown-lost.  Skip this
                # pass; containment's final act is on_fatal, which
                # re-fires the repair event (no spin).
                continue
            # dead replica: classify for the poison quarantine, move
            # its checkpointed residents (they complete on survivors
            # while the rebuild happens), then rebuild when the
            # backoff comes due
            self._update_quarantine(core)
            if (
                self._integrity_cfg.enabled
                and i not in self._corrupt
                and classify_fatal(core._fatal) == "corrupt"
            ):
                # corrupt-classified fatal (sentinel trip / checksum
                # mismatch / canary failure): quarantine the index —
                # routed around, never a failover/migration target —
                # until the post-reload canary passes in _do_rebuild
                self._mark_corrupt(i, core._fatal)
            pending = core.take_checkpointed()
            self.total_lost += core.take_resume_losses()
            if pending:
                self._redistribute(i, pending)
            if i not in self._draining:
                # a draining replica is deliberately leaving (rolling
                # deploy / scale-down): auto-rebuilding it would fight
                # the operator — undrain re-arms repair
                self._maybe_rebuild(i, core, now)
        metrics.DP_REPLICAS_ALIVE.set(
            sum(1 for c in self.replicas if self._alive(c))
        )

    def _update_quarantine(self, core: EngineCore) -> None:
        """Quarantine what a poison-classified replica fatal implicates
        (idempotent per fatal — the fingerprint set dedupes): the named
        victim when the fault carries one, every resident otherwise —
        the dp=1 supervisor's poison path, minus the general transient
        repeat-offender streak (max_resume_attempts bounds automatic
        replays here).  Sentinel-ATTRIBUTED corrupt fatals do run a
        streak (the supervisor's twin): a prompt that deterministically
        NaN-overflows would otherwise corrupt-reload its way through
        every replica — sentinel trip → reload → failover replay /
        client retry → trip again — burning the shared restart budget
        with no containment."""
        exc = core._fatal
        if exc is None:
            return
        kind = classify_fatal(exc)
        if kind == "corrupt":
            attributed = {
                s.get("fingerprint")
                for s in getattr(exc, "sequences", ())
                if s.get("fingerprint")
            }
            threshold = self._recovery.poison_threshold
            new_streaks: Dict[str, int] = {}
            for fp, resume_count in core._fatal_suspects:
                if fp not in attributed:
                    continue
                # replays keep their streak; only fresh submissions
                # (resume_count == 0: the client re-sending the prompt)
                # advance it — the supervisor's transient-streak rule
                count = self._corrupt_streaks.get(fp, 0) + (
                    1 if resume_count == 0 else 0
                )
                if count >= threshold:
                    if fp not in self._quarantine:
                        self._quarantine.add(fp)
                        metrics.QUARANTINED_REQUESTS.inc()
                        logger.error(
                            "request quarantined: repeatedly attributed "
                            "by corrupt-sentinel trips",
                            extra={"extra_data": {
                                "fingerprint": fp, "trips": count,
                            }},
                        )
                elif count > 0:
                    new_streaks[fp] = count
            self._corrupt_streaks = new_streaks
            return
        if kind != "poison":
            return
        named = getattr(exc, "fingerprint", None)
        suspects = (
            [named] if named else [fp for fp, _ in core._fatal_suspects]
        )
        for fp in suspects:
            if fp and fp not in self._quarantine:
                self._quarantine.add(fp)
                metrics.QUARANTINED_REQUESTS.inc()
                logger.error(
                    "request quarantined as dp replica poison",
                    extra={"extra_data": {"fingerprint": fp}},
                )

    def _redistribute(
        self, dead_idx: int, pending: List[Sequence]
    ) -> None:
        """Failover: hand a dead replica's checkpointed sequences to the
        least-loaded SURVIVING replicas (prepare_resume already folded
        each partial generation, so they re-admit as prefill-continues
        with their original deadlines).  Quarantined fingerprints are
        excluded (replay_into) — replaying the request that killed this
        replica would serially kill the survivors.  With no survivor
        the client gets the retryable 503 — the rebuild path cannot be
        waited on without holding futures hostage to a possibly-
        exhausted budget."""
        moved = 0
        # submissions land in the target's _submit_q, which _load
        # cannot see until its engine thread drains it — account for
        # them here or every sequence would pile onto the same
        # "least-loaded" survivor
        extra: Dict[int, int] = {}
        with self._topology_lock:
            dead_core = self.replicas[dead_idx]
        warned_draining = False
        for seq in pending:
            with self._topology_lock:
                eligible = [
                    (j, c) for j, c in enumerate(self.replicas)
                    if self._alive(c)
                    and c is not dead_core
                    # a corrupt-quarantined replica must never receive
                    # failover work — its outputs are suspect until the
                    # post-reload canary passes
                    and j not in self._corrupt
                ]
                draining = set(self._draining)
            # the no-new-placements drain invariant first; but when
            # every survivor is draining, completing the request on
            # one beats failing it — remove_replica re-evacuates, so
            # nothing is lost even if that replica is later torn down
            alive = [c for j, c in eligible if j not in draining]
            if not alive and eligible:
                alive = [c for _, c in eligible]
                if not warned_draining:
                    warned_draining = True
                    logger.warning(
                        "failover placing onto DRAINING replicas: "
                        "no non-draining survivor exists; re-issue "
                        "the drain once the fleet recovers",
                        extra={"extra_data": {
                            "dead_replica": dead_idx,
                            "draining": sorted(draining),
                        }},
                    )
            if not alive:
                self.total_lost += 1
                metrics.LOST_SEQUENCES.labels(reason="no_replica").inc()
                seq.fail(
                    EngineRecoveringError(
                        "every dp replica is down; retry shortly",
                        retry_after=self.retry_after_s,
                    )
                )
                continue
            target = min(
                alive,
                key=lambda c: self._load(c) + extra.get(id(c), 0),
            )
            outcome = replay_into(
                target, seq, self._quarantine,
                retry_after=self.retry_after_s,
                from_replica=dead_idx,
            )
            if outcome != "replayed":
                self.total_lost += 1
                continue
            extra[id(target)] = extra.get(id(target), 0) + 1
            moved += 1
            self.total_resumed += 1
        if moved:
            self.total_failovers += 1
            logger.warning(
                "dp failover: redistributed dead replica's residents",
                extra={
                    "extra_data": {
                        "replica": dead_idx,
                        "checkpointed": len(pending),
                        "moved": moved,
                    }
                },
            )

    def _backoff(self) -> float:
        """Capped exponential backoff from the shared restart history —
        the one formula behind rebuild scheduling AND the Retry-After
        hint (retry_after_s), so they cannot diverge."""
        rec = self._recovery
        return min(
            rec.backoff_cap_s,
            rec.backoff_base_s * (2 ** len(self._restart_times)),
        )

    def _maybe_rebuild(
        self, idx: int, core: EngineCore, now: float
    ) -> None:
        rec = self._recovery
        self._restart_times = [
            t for t in self._restart_times
            if now - t < rec.restart_window_s
        ]
        if len(self._restart_times) >= rec.max_restarts:
            return  # budget exhausted; retried once the window slides
        due = self._next_attempt.get(id(core))
        if due is None:
            # first detection: schedule the rebuild after backoff
            self._next_attempt[id(core)] = now + self._backoff()
            self._repair_event.set()  # re-sweep promptly
            return
        if now < due:
            return
        self._restart_times.append(now)
        # rebuild OFF the sweep thread: construction blocks for tens of
        # seconds on real hardware (KV-pool sizing, mesh setup —
        # potentially minutes when the device itself is sick), and the
        # single repair thread must keep watching the OTHER replicas'
        # heartbeats and failovers meanwhile.  _rebuilding guards the
        # dead core (by identity — elastic dp can renumber the fleet
        # while this runs); the checkpoint was already redistributed
        # above.  The device slice is captured NOW, under the topology
        # lock, for the same reason.
        self._rebuilding.add(id(core))
        devices = self._device_slices[idx]
        thread = threading.Thread(
            target=self._do_rebuild,
            args=(idx, core, devices),
            name=f"vgt-dp-rebuild-{idx}",
            daemon=True,
        )
        self._rebuild_threads[id(core)] = thread
        thread.start()

    def _do_rebuild(
        self, idx: int, old: EngineCore, devices: list
    ) -> None:
        # reload-on-corrupt: a corrupt-classified fatal must not keep
        # the old tree (the corruption would survive the rebuild); a
        # kept tree is checksum-verified inside rebuild_core and a
        # mismatch escalates this rebuild to a reload too
        reload_weights = (
            self._integrity_cfg.enabled
            and old._fatal is not None
            and classify_fatal(old._fatal) == "corrupt"
        )
        try:
            try:
                # shared teardown/rebuild sequence (engine_core.
                # rebuild_core): stop, free the dead incarnation's
                # device KV pool before the new one sizes, weights
                # kept (verified) or reloaded, brownout
                # spec-suspension carried over
                new_core = rebuild_core(
                    old, self._config_for(devices), devices,
                    reload_weights=reload_weights,
                )
            except IntegrityError:
                logger.error(
                    "dp replica kept-weights rebuild failed checksum "
                    "verification; escalating to weight reload",
                    extra={"extra_data": {"replica": idx}},
                    exc_info=True,
                )
                with self._topology_lock:
                    try:
                        slot = self.replicas.index(old)
                    except ValueError:
                        slot = -1
                    if slot >= 0 and slot not in self._corrupt:
                        self._mark_corrupt(slot, old._fatal)
                try:
                    new_core = rebuild_core(
                        old, self._config_for(devices), devices,
                        reload_weights=True,
                    )
                except Exception:
                    logger.error(
                        "dp replica reload rebuild failed",
                        extra={"extra_data": {"replica": idx}},
                        exc_info=True,
                    )
                    with self._topology_lock:
                        self._next_attempt[id(old)] = (
                            time.monotonic() + self._backoff()
                        )
                    return
                reload_weights = True
            except Exception:
                logger.error(
                    "dp replica rebuild attempt failed",
                    extra={"extra_data": {"replica": idx}},
                    exc_info=True,
                )
                with self._topology_lock:
                    self._next_attempt[id(old)] = (
                        time.monotonic() + self._backoff()
                    )
                return
            with self._topology_lock:
                self._next_attempt.pop(id(old), None)
            # swap by IDENTITY, under the topology lock: the fleet may
            # have been renumbered (remove_replica) while this built —
            # a stale index would overwrite the wrong slot
            with self._topology_lock:
                try:
                    slot = self.replicas.index(old)
                except ValueError:
                    slot = -1  # replica was removed mid-rebuild
                if slot >= 0:
                    self._attach(slot, new_core)
                    self.replicas[slot] = new_core
            if slot < 0 or self._stopping:
                new_core.stop()
                return
            new_core.start()
            if self._stopping:
                # stop() raced the start (its join timed out): never
                # leave an engine running that shutdown already swept
                new_core.stop()
                return
            self.total_restarts += 1
            metrics.ENGINE_RESTARTS.inc()
            if reload_weights:
                # counted per reload REBUILD (not per canary verdict)
                # so /stats integrity.corrupt_reloads tracks the
                # vgt_corrupt_reloads Prometheus counter exactly
                self.total_corrupt_reloads += 1
            if slot in self._corrupt:
                # quarantined rebuild: the replica rejoins the
                # placement rotation ONLY after its canary matches the
                # recorded fingerprint.  A failing canary declares a
                # fresh corrupt fatal on the new incarnation — the
                # sweep then schedules another reload under the shared
                # restart budget, and the quarantine holds meanwhile.
                if self._canary is None:
                    self._clear_corrupt(slot, reason="no_canary")
                else:
                    result = self._canary.check(
                        new_core, context=f"reload:replica{slot}"
                    )
                    self.last_integrity = dict(
                        self.last_integrity or {}, canary=result
                    )
                    if result["ok"]:
                        self._clear_corrupt(slot, reason="canary_pass")
                    else:
                        self.total_canary_failures += 1
                        logger.error(
                            "dp replica post-reload canary FAILED; "
                            "replica stays quarantined and reloads "
                            "again",
                            extra={"extra_data": {
                                "replica": slot, **result,
                            }},
                        )
                        new_core.declare_stalled(
                            IntegrityError(
                                "post-reload canary failed: "
                                + str(
                                    result.get("error")
                                    or "fingerprint mismatch"
                                ),
                                kind="canary",
                            )
                        )
            logger.warning(
                "dp replica rebuilt",
                extra={"extra_data": {
                    "replica": slot,
                    **(
                        {"weights_reloaded": True}
                        if reload_weights
                        else {}
                    ),
                }},
            )
        finally:
            with self._topology_lock:
                self._rebuilding.discard(id(old))
                self._rebuild_threads.pop(id(old), None)
            self._repair_event.set()  # re-sweep with the fresh state

    # ------------------------------- silent-corruption defense helpers

    def _mark_corrupt(self, idx: int, exc: Optional[BaseException]) -> None:
        """Quarantine replica ``idx`` as suspected-corrupt: no routing,
        no failover/migration placements, auto-repair reloads weights.
        Callers hold (or are inside) the topology lock OR pass an index
        they just resolved under it."""
        self._corrupt.add(idx)
        metrics.CORRUPT_QUARANTINED.set(len(self._corrupt))
        self.last_integrity = {
            "replica": idx,
            "cause": (
                f"{type(exc).__name__}: {exc}" if exc is not None else None
            ),
            "kind": getattr(exc, "integrity_kind", "unknown"),
            "time": time.time(),
        }
        logger.error(
            "dp replica quarantined for suspected silent corruption",
            extra={"extra_data": self.last_integrity},
        )

    def _clear_corrupt(self, idx: int, reason: str) -> None:
        self._corrupt.discard(idx)
        metrics.CORRUPT_QUARANTINED.set(len(self._corrupt))
        logger.warning(
            "dp replica corruption quarantine lifted",
            extra={"extra_data": {"replica": idx, "reason": reason}},
        )

    def _maybe_canaries(self) -> None:
        """Slow-timer canary pass (integrity.canary_interval_s > 0):
        probe each healthy in-rotation replica on its own schedule.  A
        failing probe quarantines the replica, live-migrates its
        residents OFF (the planned-evacuation path — suspect cores
        never get replays), and declares the corrupt fatal so the
        repair loop reloads its weights."""
        interval = self._integrity_cfg.canary_interval_s
        if self._canary is None or interval <= 0 or self._stopping:
            return
        if self._canary_probe is not None and self._canary_probe.is_alive():
            return  # at most one probe in flight fleet-wide
        now = time.monotonic()
        with self._topology_lock:
            candidates = [
                (i, c) for i, c in enumerate(self.replicas)
                if self._alive(c)
                and i not in self._draining
                and i not in self._corrupt
                and id(c) not in self._rebuilding
            ]
        for i, core in candidates:
            due = self._next_canary.get(i)
            if due is None:
                # stagger first probes one interval out (boot is
                # already covered by the record-on-first-probe rule)
                self._next_canary[i] = now + interval
                continue
            if now < due:
                continue
            try:
                if core.scheduler.has_work():
                    # busy replica: the sentinels already watch its
                    # every readback, and a probe queued behind live
                    # load would time out and read as corruption —
                    # re-probe at the next interval
                    self._next_canary[i] = now + interval
                    continue
            except Exception:  # pragma: no cover - mid-rebuild
                continue
            self._next_canary[i] = now + interval
            # OFF the repair thread: a probe blocked on a wedged core
            # must not suspend fleet-wide stall detection / rebuild
            # scheduling (the watchdog's job is noticing that wedge)
            self._canary_probe = threading.Thread(
                target=self._run_timer_canary,
                args=(i, core),
                name=f"vgt-dp-canary-{i}",
                daemon=True,
            )
            self._canary_probe.start()
            break

    def _run_timer_canary(self, idx: int, core: EngineCore) -> None:
        result = self._canary.check(core, context=f"timer:replica{idx}")
        if result["ok"]:
            return
        self.total_canary_failures += 1
        self._quarantine_corrupt_live(core, result)

    def _quarantine_corrupt_live(
        self, core: EngineCore, result: Dict[str, Any]
    ) -> None:
        """A LIVE replica failed its canary: quarantine by identity
        (indices may have shifted since the caller snapshotted),
        evacuate its residents via the planned-migration path onto
        healthy siblings, then declare the corrupt fatal for a
        reload rebuild."""
        exc = IntegrityError(
            "canary self-probe failed on a live dp replica: "
            + str(result.get("error") or "fingerprint mismatch"),
            kind="canary",
            detail={k: v for k, v in result.items() if k != "ok"},
        )
        with self._topology_lock:
            try:
                slot = self.replicas.index(core)
            except ValueError:
                return  # removed while we probed
            self._mark_corrupt(slot, exc)
        # PR-8 evacuation path: residents migrate OFF the suspect core
        # as planned movements — never replayed back onto it
        try:
            seqs, kind = self._evacuate_all(core, "corrupt")
        except MigrationError:
            seqs, kind = [], "migrate"  # stuck evacuation: containment
            # will checkpoint the residents when the fatal lands below
        if seqs:
            with self._topology_lock:
                targets = [
                    c for j, c in enumerate(self.replicas)
                    if c is not core
                    and self._alive(c)
                    and j not in self._draining
                    and j not in self._corrupt
                ]
                if not targets:
                    # every clean survivor is draining: placing onto an
                    # alive DRAINING sibling beats 503ing the work (the
                    # file-wide zero-loss-beats-drain-purity rule —
                    # _redistribute and _fallback_targets do the same).
                    # Still NEVER the corrupt source or siblings.
                    targets = [
                        c for j, c in enumerate(self.replicas)
                        if c is not core
                        and self._alive(c)
                        and j not in self._corrupt
                    ]
                    if targets:
                        logger.warning(
                            "corrupt-replica evacuation placing onto "
                            "DRAINING replicas: no clean in-rotation "
                            "survivor exists",
                            extra={"extra_data": {"replica": slot}},
                        )
            moved, lost, _ = self._place(
                seqs, targets, "corrupt", slot, kind=kind
            )
            logger.warning(
                "evacuated residents off corrupt-quarantined replica",
                extra={"extra_data": {
                    "replica": slot, "moved": moved, "lost": lost,
                }},
            )
        core.declare_stalled(exc)

    # ------------------------------------ planned migration / elastic dp

    def _require_migration(self) -> None:
        if not self._mig.enabled:
            raise MigrationRefusedError(
                "live migration is disabled (migration.enabled=false)"
            )

    @staticmethod
    def _kv_dtype_of(core: Any) -> Optional[str]:
        geo = getattr(core, "geometry", None)
        return getattr(geo, "kv_dtype", None)

    def _check_placement(
        self, src_core: Any, targets: List[Any]
    ) -> List[Any]:
        """Placement-time migration gate, applied BEFORE any sequence
        is evacuated: raises the typed MigrationRefusedError when no
        live target can accept the source's checkpoints — either none
        exists, or every candidate serves a different kv_cache.dtype
        than the one the source's generations were sampled under
        (submit_existing would refuse each replay with a 503; refusing
        the whole operation up front moves nothing and loses nothing).
        Returns the eligible targets."""
        alive = [c for c in targets if self._alive(c)]
        if not alive:
            raise MigrationRefusedError(
                "no eligible target replica: every other replica is "
                "dead or draining"
            )
        src = self._kv_dtype_of(src_core)
        ok = [
            c for c in alive
            if src is None
            or self._kv_dtype_of(c) is None
            or self._kv_dtype_of(c) == src
        ]
        if not ok:
            have = sorted(
                {str(self._kv_dtype_of(c)) for c in alive}
            )
            raise MigrationRefusedError(
                f"kv-dtype mismatch: the source replica serves "
                f"kv_cache.dtype={src!r} but every live target serves "
                f"{have}; a generation sampled against one KV storage "
                "format cannot continue against another — refusing at "
                "placement time"
            )
        return ok

    def _place(
        self,
        seqs: List[Sequence],
        targets: List[Any],
        reason: str,
        from_replica: int,
        kind: str = "migrate",
        fallback: Optional[EngineCore] = None,
    ) -> tuple:
        """Replay evacuated sequences onto the least-loaded eligible
        targets (the PR-5 redistribution accounting: in-loop `extra`
        counts submissions _load cannot see yet, so a batch never piles
        onto one survivor).  Per-sequence kv-dtype eligibility is
        re-checked here as the backstop — _check_placement gated the
        operation, but a mixed fleet could lose its last compatible
        target mid-flight.  ``kind`` carries provenance: sequences a
        planned operation claimed from a CRASHED replica were folded by
        prepare_resume, so they replay as resumes (resumed:true,
        vgt_resumed_sequences) — stamping them "migrate" would make
        metrics, flight ticks and response flags disagree.  ``fallback``
        is the alive SOURCE when it stays in the fleet (drain,
        rebalance): a sequence whose every target died between the gate
        and this placement folds back where it was running fine instead
        of 503ing — a planned operation must not turn healthy requests
        into errors.  Returns (moved, lost, requeued)."""
        moved = lost = requeued = 0
        extra: Dict[int, int] = {}
        for seq in seqs:
            eligible = [
                c for c in targets
                if self._alive(c)
                and (
                    seq.kv_dtype is None
                    or self._kv_dtype_of(c) is None
                    or self._kv_dtype_of(c) == seq.kv_dtype
                )
            ]
            if not eligible and fallback is not None and self._alive(
                fallback
            ):
                try:
                    fallback.submit_existing(seq)
                    requeued += 1
                    continue
                except (RuntimeError, ValueError):
                    pass  # the source went down too: fall through
            if not eligible:
                lost += 1
                self.total_lost += 1
                metrics.LOST_SEQUENCES.labels(reason="no_replica").inc()
                seq.fail(
                    EngineRecoveringError(
                        "no eligible replica for the migrated request; "
                        "retry shortly",
                        retry_after=self.retry_after_s,
                    )
                )
                continue
            target = min(
                eligible,
                key=lambda c: self._load(c) + extra.get(id(c), 0),
            )
            outcome = replay_into(
                target, seq, self._quarantine,
                retry_after=self.retry_after_s,
                kind=kind,
                reason=reason,
                from_replica=from_replica,
            )
            if outcome != "replayed":
                lost += 1
                self.total_lost += 1
                continue
            extra[id(target)] = extra.get(id(target), 0) + 1
            moved += 1
            if kind == "resume":
                self.total_resumed += 1
            else:
                self.total_migrated += 1
                metrics.MIGRATIONS.labels(reason=reason).inc()
        return moved, lost, requeued

    def _claim_dead(self, core: EngineCore) -> List[Sequence]:
        """A replica died while (or just before) a planned migration:
        wait briefly for containment to publish its checkpoint, then
        claim it — the crash checkpoint carries the same fold/epoch
        guarantees as an evacuation, so the placement path is shared."""
        deadline = time.monotonic() + 5.0
        while (
            not core._containment_done
            and time.monotonic() < deadline
        ):
            time.sleep(0.05)
        self.total_lost += core.take_resume_losses()
        return core.take_checkpointed()

    def _evacuate_all(
        self, core: EngineCore, reason: str
    ) -> tuple:
        """Returns ``(sequences, kind)`` — kind is "migrate" for a live
        planned evacuation (prepare_migrate folded them) and "resume"
        when the residents had to be claimed from a crash checkpoint
        (prepare_resume folded them); _place forwards it so provenance
        flags/metrics/ticks stay truthful."""
        if not self._alive(core):
            return self._claim_dead(core), "resume"
        try:
            return core.evacuate(
                None, reason=reason,
                timeout=self._mig.evacuate_timeout_s,
            ), "migrate"
        except MigrationError:
            # TIMEOUT on a live engine is not death: the sequences
            # stayed put (or the core folds an abandoned evacuation
            # back into its own scheduler).  Propagate so the caller
            # aborts the operation — remove_replica must NOT proceed
            # to stop() a replica still full of live work.  The
            # replica stays marked draining; the operator retries.
            raise
        except RuntimeError:
            # died mid-evacuation: the containment checkpoint owns the
            # residents now — claim and place them the same way
            return self._claim_dead(core), "resume"

    def _fallback_targets(self, idx: int, core: EngineCore) -> List[Any]:
        """A DEAD replica's checkpoints must go somewhere: when every
        non-draining survivor is gone, placing onto alive DRAINING
        survivors (same call _redistribute makes in this situation)
        beats failing the requests — remove_replica re-evacuates, so
        nothing is lost even if that survivor is later torn down.  A
        LIVE source never takes this path: _check_placement refuses
        typed before anything moves."""
        with self._topology_lock:
            fallback = [
                c for j, c in enumerate(self.replicas)
                if j != idx and self._alive(c)
            ]
        if fallback:
            logger.warning(
                "placing dead replica residents onto DRAINING "
                "survivors: no non-draining target exists; re-issue "
                "the drain once the fleet recovers",
                extra={"extra_data": {"replica": idx}},
            )
        return fallback

    @_structural
    def drain_replica(
        self, idx: int, reason: str = "drain"
    ) -> Dict[str, Any]:
        """Mark replica ``idx`` draining (no new placements), then
        live-migrate its residents to the least-loaded eligible
        survivors.  The replica keeps serving anything that raced the
        mark and reports DEGRADED-with-detail health until undrained or
        removed — a rolling deploy drains, replaces the process behind
        the replica, then undrains.  Raises ValueError for an unknown
        index, MigrationRefusedError when no survivor can take the
        work (nothing moves in that case), and MigrationError when the
        evacuation times out — the replica then STAYS marked draining
        with its residents still serving on it; retry the drain."""
        self._require_migration()
        core, targets, already, moved, lost, requeued = (
            self._drain_and_place(idx, reason)
        )
        logger.warning(
            "dp replica draining",
            extra={
                "extra_data": {
                    "replica": idx, "reason": reason,
                    "migrated": moved, "lost": lost,
                    "requeued": requeued,
                    "already_draining": already,
                }
            },
        )
        return {
            "replica": idx,
            "draining": True,
            "migrated": moved,
            "lost": lost,
            "requeued": requeued,
            "already_draining": already,
        }

    def _drain_and_place(
        self, idx: int, reason: str, removing: bool = False
    ) -> tuple:
        """The shared gate → mark → evacuate → place sequence behind
        drain_replica and remove_replica (ONE copy, so placement fixes
        land once).  Returns (core, targets, already, moved, lost,
        requeued).  Raises before anything moves: ValueError for a bad
        index, MigrationRefusedError from the placement gate — plus
        the remove-specific last-replica/mid-rebuild guards when
        ``removing``."""
        with self._topology_lock:
            if not 0 <= idx < len(self.replicas):
                raise ValueError(
                    f"no replica {idx} (dp={len(self.replicas)})"
                )
            if removing:
                if len(self.replicas) <= 1:
                    raise MigrationRefusedError(
                        "cannot remove the last replica; stop the "
                        "server instead"
                    )
                if id(self.replicas[idx]) in self._rebuilding:
                    raise MigrationRefusedError(
                        "replica is mid-rebuild; retry once it settles"
                    )
            already = idx in self._draining
            core = self.replicas[idx]
            targets = [
                c for j, c in enumerate(self.replicas)
                if j != idx and j not in self._draining
            ]
        if self._alive(core):
            # typed placement gate BEFORE the mark: a refused op
            # leaves the fleet exactly as it was
            targets = self._check_placement(core, targets)
        elif not any(self._alive(c) for c in targets):
            # a dead source's checkpoint must not be lost just because
            # every NON-DRAINING sibling is also dead — alive draining
            # survivors can still serve it (same call _redistribute
            # makes; zero-loss beats drain purity)
            targets = self._fallback_targets(idx, core)
        with self._topology_lock:
            self._draining.add(idx)
            metrics.REPLICAS_DRAINING.set(len(self._draining))
        t0 = time.monotonic()
        seqs, kind = self._evacuate_all(core, reason)
        # a drained source STAYS in the fleet: residents whose target
        # died mid-op fold back into it rather than 503.  A removed
        # source is leaving — no fold-back (stop() fails stragglers
        # typed).
        moved, lost, requeued = self._place(
            seqs, targets, reason, idx, kind=kind,
            fallback=None if removing else core,
        )
        if seqs:
            metrics.MIGRATION_SECONDS.observe(time.monotonic() - t0)
        return core, targets, already, moved, lost, requeued

    @_structural
    def undrain_replica(self, idx: int) -> Dict[str, Any]:
        """Return a drained replica to the placement rotation (the
        rolling deploy's rejoin step) and re-arm its auto-repair."""
        self._require_migration()
        with self._topology_lock:
            if not 0 <= idx < len(self.replicas):
                raise ValueError(
                    f"no replica {idx} (dp={len(self.replicas)})"
                )
            was = idx in self._draining
            core = self.replicas[idx]
        canary = None
        if self._canary is not None and was and self._alive(core):
            # an undrained replica sat out of rotation (rolling deploy:
            # possibly a whole new binary/weights under it) — prove it
            # BEFORE it becomes routable: the probe runs while the
            # draining mark still excludes the replica from placement,
            # so corrupt output can never race real traffic.  A failure
            # quarantines it (also rotation-excluding) and triggers the
            # reload path; the undrain below then merely hands it from
            # one exclusion to the other.
            canary = self._canary.check(core, context=f"undrain:{idx}")
            if not canary["ok"]:
                self.total_canary_failures += 1
                self._quarantine_corrupt_live(core, canary)
        with self._topology_lock:
            self._draining.discard(idx)
            metrics.REPLICAS_DRAINING.set(len(self._draining))
        self._policy.reset()
        self._repair_event.set()  # a dead drained replica rebuilds now
        logger.warning(
            "dp replica undrained",
            extra={"extra_data": {"replica": idx, "was_draining": was}},
        )
        out = {"replica": idx, "draining": False, "was_draining": was}
        if canary is not None:
            out["canary"] = {
                k: canary[k] for k in ("ok", "recorded") if k in canary
            }
        return out

    @_structural
    def add_replica(self) -> Dict[str, Any]:
        """Grow the dp degree at runtime by building a fresh replica on
        a banked device slice (remove_replica returns its slice here).
        Growing beyond the boot-time device partition still needs a
        restart with a larger device.dp — slices are reused, not
        invented."""
        self._require_migration()
        with self._topology_lock:
            if not self._free_slices:
                raise MigrationRefusedError(
                    "no free device slice to build a replica on "
                    "(remove_replica banks its slice for reuse; "
                    "growing past the boot-time partition requires a "
                    "restart)"
                )
            devices = self._free_slices.pop()
        try:
            # construction OUTSIDE the lock: it blocks for seconds to
            # minutes on real hardware and the sweep/router must run
            core = self._build(devices)
        except Exception:
            with self._topology_lock:
                self._free_slices.append(devices)
            raise
        core.start()
        canary = None
        if self._canary is not None:
            # a fresh replica (new load on a banked slice) must match
            # the fleet's recorded fingerprint BEFORE it joins the
            # fleet: the probe runs while the core is still unattached
            # (unroutable), so an unproven replica never sees traffic
            canary = self._canary.check(core, context="add")
        with self._topology_lock:
            idx = len(self.replicas)
            self.replicas.append(core)
            self._device_slices.append(devices)
            if self._failover_enabled:
                self._attach(idx, core)
            metrics.DP_REPLICAS_TOTAL.set(len(self.replicas))
            if canary is not None and not canary["ok"]:
                # attach quarantined: visible to the operator, excluded
                # from routing, and the repair loop reloads it
                self._mark_corrupt(idx, None)
        if canary is not None and not canary["ok"]:
            self.total_canary_failures += 1
            core.declare_stalled(
                IntegrityError(
                    "add_replica canary failed: "
                    + str(canary.get("error") or "fingerprint mismatch"),
                    kind="canary",
                )
            )
        self._policy.reset()
        logger.warning(
            "dp replica added",
            extra={"extra_data": {"replica": idx, "dp": idx + 1}},
        )
        out = {"replica": idx, "dp": len(self.replicas)}
        if canary is not None:
            out["canary"] = {
                k: canary[k] for k in ("ok", "recorded") if k in canary
            }
        return out

    @_structural
    def remove_replica(self, idx: int) -> Dict[str, Any]:
        """Shrink the dp degree at runtime: drain + live-migrate the
        replica's residents, tear the engine down, and bank its device
        slice for a later add_replica.  The last replica is never
        removable (that is process shutdown's job)."""
        self._require_migration()
        core, targets, _already, moved, lost, _req = (
            self._drain_and_place(idx, "scale_down", removing=True)
        )
        # final sweep right before teardown: a concurrent drain whose
        # target list was snapshotted before this replica was marked
        # draining (or failover's draining fallback) may have placed
        # work onto it AFTER the evacuation above — stop() would fail
        # those as shutdown losses.  Anything that still lands in the
        # (now tiny) window gets the retryable 503 from stop().
        if self._alive(core):
            seqs2, kind2 = self._evacuate_all(core, "scale_down")
            if seqs2:
                m2, l2, _ = self._place(
                    seqs2, targets, "scale_down", idx, kind=kind2
                )
                moved += m2
                lost += l2
        # the port frees the replica's card memory here (pools, graphs,
        # weights), so an add_replica on its banked slice finds it free
        self._retire(core)
        with self._topology_lock:
            # the slot cannot have shifted: structural ops hold
            # _structural_lock for their full duration and the sweep
            # skips draining replicas' rebuilds
            slot = self.replicas.index(core)
            self.replicas.pop(slot)
            self._free_slices.append(self._device_slices.pop(slot))
            self._draining.discard(slot)
            # renumber the index-keyed draining marks above the gap
            self._draining = {
                i - 1 if i > slot else i for i in self._draining
            }
            # corrupt quarantine and canary schedule are index-keyed
            # too: renumber the same way (the removed replica's marks
            # simply disappear with it)
            self._corrupt.discard(slot)
            self._corrupt = {
                i - 1 if i > slot else i for i in self._corrupt
            }
            metrics.CORRUPT_QUARANTINED.set(len(self._corrupt))
            self._next_canary = {
                (i - 1 if i > slot else i): t
                for i, t in self._next_canary.items()
                if i != slot
            }
            self._next_attempt.pop(id(core), None)
            if self._failover_enabled:
                for j, c in enumerate(self.replicas):
                    self._attach(j, c)
            metrics.DP_REPLICAS_TOTAL.set(len(self.replicas))
            metrics.REPLICAS_DRAINING.set(len(self._draining))
            dp_now = len(self.replicas)
        self._policy.reset()
        logger.warning(
            "dp replica removed",
            extra={
                "extra_data": {
                    "replica": idx, "dp": dp_now,
                    "migrated": moved, "lost": lost,
                }
            },
        )
        return {
            "replica": idx, "dp": dp_now,
            "migrated": moved, "lost": lost,
        }

    # --------------------------------------- hot-replica rebalancing

    def _balance_loop(self) -> None:
        while not self._stopping:
            self._balance_event.wait(
                timeout=max(0.1, self._mig.rebalance_interval_s)
            )
            self._balance_event.clear()
            if self._stopping:
                return
            try:
                self.maybe_rebalance()
            except Exception:  # pragma: no cover - defensive
                logger.error("dp rebalance pass failed", exc_info=True)

    def maybe_rebalance(self) -> Optional[Dict[str, Any]]:
        """One rebalance policy tick: feed live pressure signals to the
        hysteresis policy and execute its decision (move the
        longest-running decodes off the hot replica onto the idle one).
        Returns the move summary, or None when the policy holds."""
        if not self._mig.enabled or not self._mig.rebalance_enabled:
            return None
        with self._topology_lock:
            reps = list(self.replicas)
            # corrupt-quarantined replicas neither shed nor receive
            # rebalance moves
            draining = set(self._draining) | set(self._corrupt)
        if len(reps) < 2:
            return None
        signals: Dict[int, Dict[str, Any]] = {}
        for i, core in enumerate(reps):
            if not self._alive(core) or i in draining:
                continue
            try:
                signals[i] = core.pressure_signals()
            except Exception:  # pragma: no cover - mid-rebuild
                continue
        decision = self._policy.observe(signals)
        if decision is None:
            return None
        hot_idx, cold_idx = decision
        return self._rebalance(reps[hot_idx], reps[cold_idx], hot_idx)

    def _rebalance(
        self, hot: EngineCore, cold: EngineCore, hot_idx: int
    ) -> Optional[Dict[str, Any]]:
        mig = self._mig
        if self._kv_dtype_of(hot) != self._kv_dtype_of(cold):
            self._policy.note_move_failed()
            return None  # mixed-dtype fleet: nothing to move safely
        victims = [
            s for s in hot.scheduler.running
            if s.status is SeqStatus.RUNNING
            and not s.abort_requested
            and s.num_generated >= mig.min_generated_tokens
        ]
        if not victims:
            self._policy.note_move_failed()
            logger.info(
                "rebalance decided but no eligible victim (all "
                "residents below migration.min_generated_tokens)",
                extra={"extra_data": {"replica": hot_idx}},
            )
            return None
        # longest-running decodes first: they free the most KV per
        # move and have the longest remaining co-tenancy with the
        # pressured pool
        victims.sort(key=lambda s: s.num_generated, reverse=True)
        victims = victims[: max(1, mig.max_moves_per_cycle)]
        t0 = time.monotonic()
        try:
            seqs = hot.evacuate(
                [s.seq_id for s in victims],
                reason="rebalance",
                timeout=mig.evacuate_timeout_s,
            )
        except Exception as exc:
            self._policy.note_move_failed()
            logger.warning(
                "rebalance evacuation failed; replica left as-is",
                extra={"extra_data": {
                    "replica": hot_idx,
                    "error": f"{type(exc).__name__}: {exc}",
                }},
            )
            return None
        if not seqs:
            self._policy.note_move_failed()
            return None
        if not self._alive(cold):
            # the target died between the policy decision and
            # placement: fold the victims straight back into the hot
            # replica they were running fine on — an optional
            # optimization must not turn healthy requests into 503s
            requeued = 0
            for seq in seqs:
                try:
                    hot.submit_existing(seq)
                    requeued += 1
                except (RuntimeError, ValueError):
                    self.total_lost += 1
                    metrics.LOST_SEQUENCES.labels(
                        reason="no_replica"
                    ).inc()
                    seq.fail(EngineRecoveringError(
                        "rebalance target died and the source could "
                        "not take the request back; retry shortly",
                        retry_after=self.retry_after_s,
                    ))
            self._policy.note_move_failed()
            logger.warning(
                "rebalance target died before placement; victims "
                "folded back into the source replica",
                extra={"extra_data": {
                    "from": hot_idx, "requeued": requeued,
                    "lost": len(seqs) - requeued,
                }},
            )
            return None
        moved, lost, requeued = self._place(
            seqs, [cold], "rebalance", hot_idx, fallback=hot
        )
        if moved == 0:
            self._policy.note_move_failed()
        metrics.MIGRATION_SECONDS.observe(time.monotonic() - t0)
        logger.warning(
            "dp rebalance moved long decodes off a pressured replica",
            extra={
                "extra_data": {
                    "from": hot_idx, "moved": moved, "lost": lost,
                    "requeued": requeued,
                }
            },
        )
        return {
            "from": hot_idx, "moved": moved, "lost": lost,
            "requeued": requeued,
        }

    def abort_in_flight(self, reason: str = "drain") -> None:
        """Graceful-drain straggler sweep: fan the abort out to every
        replica (without this, dp>1 pods would drop their in-flight
        responses at drain timeout instead of settling them)."""
        for core in self.replicas:
            if self._alive(core):
                core.abort_in_flight(reason)

    def set_spec_suspended(self, flag: bool) -> None:
        """Brownout L3 fan-out: every replica suspends/resumes
        speculative decoding together (dead replicas included — the
        flag is a plain bool store, and a replica revived later must
        not come back drafting under the load being shed)."""
        for core in self.replicas:
            core.set_spec_suspended(flag)

    def set_prefix_insert_suspended(self, flag: bool) -> None:
        """Brownout L4 fan-out: every replica stops/resumes prefix-tree
        inserts together (dead replicas included, same rationale as the
        spec-suspension fan-out)."""
        for core in self.replicas:
            core.set_prefix_insert_suspended(flag)

    def pressure_signals(self) -> Dict[str, Any]:
        """Admission/brownout gauges aggregated across replicas: the
        WORST KV free ratio (one full replica is where new work lands
        when routing prefers prefix affinity) and summed queue depth."""
        ratios = []
        depth = running = 0
        swap_used = swap_budget = swapped_seqs = 0
        swap_free_ratios = []
        with self._topology_lock:
            cores = [
                c for i, c in enumerate(self.replicas)
                if i not in self._draining
            ]
        for core in cores:
            if not self._alive(core):
                continue
            # draining replicas excluded above: their (possibly full)
            # pools take no new placements, so counting them would
            # brown out admission against capacity that isn't offered
            sig = core.pressure_signals()
            if "kv_free_ratio" in sig:
                ratios.append(sig["kv_free_ratio"])
            depth += sig.get("engine_queue_depth", 0)
            running += sig.get("running", 0)
            if sig.get("kv_swap_enabled"):
                # host swap tier: summed occupancy, WORST headroom —
                # admission's swap relief must not run a replica's
                # device pool hot against a sibling's empty host pool
                swap_used += sig.get("kv_host_pool_bytes", 0)
                swap_budget += sig.get("kv_host_pool_budget_bytes", 0)
                swapped_seqs += sig.get("kv_swapped_seqs", 0)
                swap_free_ratios.append(
                    sig.get("kv_host_free_ratio", 0.0)
                )
        out: Dict[str, Any] = {
            "engine_queue_depth": depth, "running": running,
        }
        if ratios:
            out["kv_free_ratio"] = min(ratios)
        if swap_free_ratios:
            out["kv_swap_enabled"] = True
            out["kv_host_pool_bytes"] = swap_used
            out["kv_host_pool_budget_bytes"] = swap_budget
            out["kv_host_free_ratio"] = min(swap_free_ratios)
            out["kv_swapped_seqs"] = swapped_seqs
        return out

    # ----------------------------------------------------------- health

    @property
    def state(self) -> HealthState:
        """Pod-level health: SERVING with the full replica complement,
        DEGRADED while any replica is down OR draining (survivors still
        serve — readiness stays green; the detail block names which
        replica is out and why), DEAD only when no replica can accept
        work (liveness then recycles the pod)."""
        alive = sum(1 for c in self.replicas if self._alive(c))
        if alive == 0:
            return HealthState.DEAD
        if (
            alive < len(self.replicas)
            or self._draining
            or self._corrupt
        ):
            return HealthState.DEGRADED
        return HealthState.SERVING

    def _replica_state(
        self,
        idx: int,
        core: EngineCore,
        draining: set,
        now: float,
        corrupt: set = frozenset(),
    ) -> str:
        # core + draining + corrupt come from the caller's under-lock
        # snapshot: a concurrent remove_replica renumber must not shift
        # the index-keyed marks under this iteration
        if idx in corrupt:
            # suspected silent corruption: out of rotation (alive or
            # mid-reload) until the post-reload canary passes
            return "quarantined_corrupt"
        if idx in draining:
            # deliberately out of rotation (alive or not): auto-repair
            # is suspended until undrain, so "draining" is the truth
            return "draining"
        if self._alive(core):
            return "serving"
        if not self._failover_enabled:
            return "dead"
        window = [
            t for t in self._restart_times
            if now - t < self._recovery.restart_window_s
        ]
        if len(window) >= self._recovery.max_restarts:
            return "dead"  # budget exhausted until the window slides
        return "recovering"

    def health(self) -> Dict[str, Any]:
        """The /health engine block for dp>1 pods: pod state machine
        position plus per-replica detail (state, last fatal, queue
        depth) so operators see WHICH replica is out, not just that
        one is."""
        now = time.monotonic()
        state = self.state
        with self._topology_lock:
            reps = list(self.replicas)
            draining = set(self._draining)
            corrupt = set(self._corrupt)
        replicas = []
        for i, core in enumerate(reps):
            entry: Dict[str, Any] = {
                "replica": i,
                "state": self._replica_state(
                    i, core, draining, now, corrupt
                ),
            }
            fatal = core._fatal
            if fatal is not None:
                entry["last_fatal"] = (
                    f"{type(fatal).__name__}: {fatal}"
                )
            try:
                sched = core.scheduler.get_stats()
                entry["queue_depth"] = sched["waiting"]
                entry["running"] = sched["running"]
            except Exception:  # pragma: no cover - mid-rebuild
                pass
            replicas.append(entry)
        # ONE definition for the gauge (the repair sweep writes it
        # too): liveness, not rotation membership.  An alive draining
        # replica still counts — a planned drain must not sawtooth
        # vgt_dp_replicas_alive between /health scrapes and sweep
        # ticks or fire VgtDpReplicaDown for a deliberate operation.
        alive = sum(1 for c in reps if self._alive(c))
        metrics.DP_REPLICAS_ALIVE.set(alive)
        out = {
            "state": state.value,
            "alive": state_is_alive(state.value),
            "ready": state_is_ready(state.value),
            "dp": len(reps),
            "replicas_alive": alive,
            "replicas_draining": len(draining),
            "draining": sorted(draining),
            "replicas": replicas,
            "failovers": self.total_failovers,
            "restarts": self.total_restarts,
            # restart budget headroom (satellite fix; shared across
            # the fleet — one sick pod, one budget)
            "restarts_remaining": restart_budget_remaining(
                self._restart_times, self._recovery, now
            ),
            "stalls": self.total_stalls,
            "resumed": self.total_resumed,
            "migrated": self.total_migrated,
            "lost": self.total_lost,
            "quarantined": len(self._quarantine),
        }
        if self._integrity_cfg.enabled:
            out["integrity"] = {
                "quarantined_corrupt": sorted(corrupt),
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

    @property
    def retry_after_s(self) -> float:
        """Client backoff suggestion while degraded (the batcher reads
        this off the backend core for its 503s, like the supervisor's)."""
        return max(1.0, self._backoff())

    # ------------------------------------------------------------ routing

    @staticmethod
    def _load(core: EngineCore) -> int:
        return len(core.scheduler.waiting) + len(core.scheduler.running)

    @staticmethod
    def _alive(core: EngineCore) -> bool:
        # a cleanly-STOPPED core (remove_replica teardown) has
        # _fatal None but no loop: submit_existing into it would
        # enqueue into a queue nothing drains — the client's future
        # then hangs forever while metrics count a successful move
        return core._fatal is None and getattr(core, "_running", True)

    def _pick_replica(
        self, prompt_ids: Optional[List[int]] = None
    ) -> EngineCore:
        """Least-loaded replica (queued + resident sequences), round-robin
        on ties so idle replicas fill evenly — with **prefix affinity**:
        each replica's KV prefix cache is private, so requests sharing a
        first prompt page stick to the same replica (cache hits) unless
        that replica is meaningfully more loaded than the best one.

        Failure containment (SURVEY 5.3): a replica whose engine thread
        died (engine-fatal) is routed AROUND — in-flight sequences on it
        fail, but new requests ride the surviving replicas.  A replica
        marked DRAINING (rolling deploy / scale-down) is routed around
        the same way: it finishes what it has, takes nothing new.  Only
        when every replica is dead does the submit surface the fatal."""
        with self._route_lock:
            with self._topology_lock:
                reps = list(self.replicas)
                # corrupt-quarantined replicas route exactly like
                # draining ones: alive, but taking nothing new until
                # the post-reload canary clears them
                draining = set(self._draining) | set(self._corrupt)
            offset = next(self._rr)
            n = len(reps)
            order = [(offset + i) % n for i in range(n)]
            alive = [
                reps[i] for i in order
                if self._alive(reps[i]) and i not in draining
            ]
            if not alive:
                # no placeable replica: fall back to any live one (a
                # fully-draining fleet still serves rather than 500s),
                # else let EngineCore.submit_tokens raise the fatal
                live = [reps[i] for i in order if self._alive(reps[i])]
                return live[0] if live else reps[order[0]]
            best = min(alive, key=self._load)
            page = self.config.device.kv_page_size
            if (
                prompt_ids is not None
                and len(prompt_ids) >= page
                and reps[0].prefix_cache_enabled
            ):
                block = bytes(
                    b for t in prompt_ids[:page] for b in t.to_bytes(4, "little")
                )
                sticky_idx = zlib.crc32(block) % n
                sticky = reps[sticky_idx]
                # affinity wins unless it costs real queueing headroom
                # (or the sticky replica is dead/draining)
                if (
                    self._alive(sticky)
                    and sticky_idx not in draining
                    and self._load(sticky)
                    <= self._load(best)
                    + max(2, self.config.device.max_batch_slots // 4)
                ):
                    return sticky
            return best

    def _gate(self, prompt_ids: List[int]) -> None:
        """Reject quarantined prompts at the door (the supervisor's
        gate, pod-wide): a request a poison-classified replica fatal
        implicated must not be given a fresh replica to kill.  Steady
        state (empty quarantine) skips the O(prompt) fingerprint."""
        if not self._quarantine:
            return
        fp = faults.fingerprint(prompt_ids)
        if fp in self._quarantine:
            raise PoisonRequestError(
                f"request {fp} is quarantined: a poison fault on a dp "
                "replica named it and it will not be admitted again"
            )

    def submit_tokens(
        self,
        prompt_ids: List[int],
        params: SamplingParams,
        stream_cb: Optional[Callable[[int], Any]] = None,
        meta: Optional[Any] = None,
    ) -> Sequence:
        ids = list(prompt_ids)
        self._gate(ids)
        return self._pick_replica(ids).submit_tokens(
            prompt_ids, params, stream_cb, meta=meta
        )

    def submit_prompt(
        self,
        prompt: str,
        params: SamplingParams,
        stream_cb: Optional[Callable[[int], Any]] = None,
        meta: Optional[Any] = None,
    ) -> Sequence:
        ids = self.tokenizer.encode(prompt)
        max_prompt = self.config.model.max_model_len - 1
        if len(ids) > max_prompt:
            ids = ids[-max_prompt:]
        ids = ids or [self.tokenizer.bos_id]
        self._gate(ids)
        return self._pick_replica(ids).submit_tokens(
            ids, params, stream_cb, meta=meta
        )

    def generate(
        self, prompts: Seq[str], params: Seq[SamplingParams]
    ) -> List[Dict[str, Any]]:
        """Blocking batch API: requests spread across replicas and decode
        concurrently (mirrors EngineCore.generate's result shape)."""
        seqs = [
            self.submit_prompt(p, sp) for p, sp in zip(prompts, params)
        ]
        results = []
        for seq in seqs:
            seq.done_event.wait()
            if seq.status is SeqStatus.FAILED:
                raise seq.error  # type: ignore[misc]
            gen_time = (seq.finish_t or 0) - seq.arrival_t
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
                        "gen_time": gen_time,
                        **seq.resume_metrics(),
                    },
                }
            )
        return results

    def final_text(self, seq: Sequence) -> str:
        if seq.text_override is not None:
            return seq.text_override
        return self.tokenizer.decode(seq.generated_ids)

    # the replicas share one spec and tokenizer: these read no core state
    def encode_prompt(self, prompt: str) -> List[int]:
        return self.replicas[0].encode_prompt(prompt)

    def lp_entry(self, tid: int, lp: float, top) -> Dict[str, Any]:
        return self.replicas[0].lp_entry(tid, lp, top)

    def logprob_entries(self, seq: Sequence) -> List[Dict[str, Any]]:
        return self.replicas[0].logprob_entries(seq)

    # ------------------------------------------------------------- utilities

    def warmup(self, buckets: Optional[List[int]] = None) -> float:
        return sum(core.warmup(buckets) for core in self.replicas)

    def capture_profile(
        self, duration_s: float = 1.0, out_dir: Optional[str] = None
    ) -> Dict[str, Any]:
        """torch.profiler traces are process-wide; one capture covers all
        replicas (they share the process and its devices)."""
        return self.replicas[0].capture_profile(duration_s, out_dir)

    def device_health(self) -> Dict[str, Any]:
        healths = [core.device_health() for core in self.replicas]
        alive = [
            h.get("alive", False) and self._alive(core)
            for h, core in zip(healths, self.replicas)
        ]
        # Report platform/device_kind from an ALIVE replica: replica 0
        # may be the dead one, and alive=true must describe a core that
        # can actually serve.  Fall back to healths[0] only when none
        # are alive.
        rep = next(
            (h for h, ok in zip(healths, alive) if ok), healths[0]
        )
        return {
            # serving-capable as long as ANY replica lives (the router
            # steers around dead ones); per-replica detail alongside
            "alive": any(alive),
            "replicas_alive": sum(alive),
            "platform": rep.get("platform"),
            "device_kind": rep.get("device_kind"),
            "num_devices": sum(h.get("num_devices", 0) for h in healths),
            "replicas": len(self.replicas),
        }

    def get_stats(self) -> Dict[str, Any]:
        per_replica = [core.get_stats() for core in list(self.replicas)]
        agg = {
            key: sum(s[key] for s in per_replica)
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
        for key, val in per_replica[0]["scheduler"].items():
            if isinstance(val, (int, float)) and not isinstance(val, bool):
                agg["scheduler"][key] = sum(
                    s["scheduler"][key] for s in per_replica
                )
            elif isinstance(val, dict):
                # nested stat groups (e.g. prefix_cache): sum the numeric
                # sub-keys so DP deployments keep cache observability
                agg["scheduler"][key] = {
                    k2: (
                        sum(s["scheduler"][key][k2] for s in per_replica)
                        if isinstance(v2, (int, float))
                        and not isinstance(v2, bool)
                        else v2
                    )
                    for k2, v2 in val.items()
                }
        if "kv_swap" in per_replica[0]:
            # host swap tier: summed fleet occupancy + counters (the
            # per-replica blocks stay available under "replicas")
            swaps = [s["kv_swap"] for s in per_replica if "kv_swap" in s]
            agg["kv_swap"] = {
                "enabled": any(s["enabled"] for s in swaps),
                "budget_bytes": sum(s["budget_bytes"] for s in swaps),
                "used_bytes": sum(s["used_bytes"] for s in swaps),
                "swapped_seqs": sum(s["swapped_seqs"] for s in swaps),
                "prefix_tickets": sum(
                    s["prefix_tickets"] for s in swaps
                ),
                "swap_out_pages": {
                    k: sum(s["swap_out_pages"].get(k, 0) for s in swaps)
                    for k in ("preempt", "prefix")
                },
                "swap_in_pages": {
                    k: sum(s["swap_in_pages"].get(k, 0) for s in swaps)
                    for k in ("preempt", "prefix")
                },
                # the thrash-detection counter the runbook keys on
                # (rising discard[capacity] = pool too small): reasons
                # are open-ended, so sum over the union of keys
                "discard_pages": {
                    k: sum(s["discard_pages"].get(k, 0) for s in swaps)
                    for k in sorted(
                        {k for s in swaps for k in s["discard_pages"]}
                    )
                },
                "refused": sum(s["refused"] for s in swaps),
            }
        agg["model"] = self.spec.name
        agg["dp"] = len(self.replicas)
        # failover accounting mirrors the dp=1 supervisor block's shape
        agg["failover"] = {
            "failovers": self.total_failovers,
            "restarts": self.total_restarts,
            "stalls": self.total_stalls,
            "resumed": self.total_resumed,
            "lost": self.total_lost,
            "replicas_alive": sum(
                1 for c in self.replicas if self._alive(c)
            ),
        }
        agg["migration"] = {
            "migrated": self.total_migrated,
            "draining": sorted(self._draining),
            "free_slices": len(self._free_slices),
        }
        if self._integrity_cfg.enabled:
            agg["integrity"] = {
                "quarantined_corrupt": sorted(self._corrupt),
                "corrupt_reloads": self.total_corrupt_reloads,
                "canary_failures": self.total_canary_failures,
                **(
                    {"canary": self._canary.stats()}
                    if self._canary is not None
                    else {}
                ),
            }
        # perf attribution: pod aggregate next to the per-replica blocks
        # (observability/perf.py merge — additive sums, wall-weighted
        # ratios), mirroring the _MergedFlight pattern
        agg["perf"] = perf_attr.merge_stats(
            [s["perf"] for s in per_replica if "perf" in s]
        )
        agg["mesh"] = dict(per_replica[0]["mesh"], dp=len(self.replicas))
        agg["load_time_s"] = round(self.load_time_s, 2)
        agg["replicas"] = per_replica
        return agg

    def perf_snapshot(self) -> Dict[str, Any]:
        """The dp /debug/perf payload: every replica's attribution
        snapshot plus the merged pod view (observability/perf.py
        merge_snapshots — the _MergedFlight pattern for perf)."""
        return perf_attr.merge_snapshots(
            [core.perf.snapshot() for core in list(self.replicas)]
        )
