"""Fault-injection registry: named failure points the runtime probes.

Serving-system comparisons judge frameworks on recovery-under-failure
(PAPERS.md, vLLM-vs-TGI), and an in-house engine cannot delegate crash
handling to an external one the way the reference V-Gate did — so the
failure paths must be *testable*.  This module gives deterministic tests
and a chaos mode a way to make any probed site raise, delay, or corrupt
on demand, without monkeypatching engine internals.

Probed sites (each calls :func:`check` with the point name):

==================  ====================================================
``decode_step``     engine_core dispatching a decode chunk / spec round
``prefill``         engine_core dispatching a prefill (payload = the
                    request's original prompt token ids, so a fault can
                    target one poison request via ``match``)
``weight_load``     runtime.weights.load_or_init_params
``kv_alloc``        runtime.kv_cache.PageAllocator.allocate
``backend_generate``  backends.torch_backend generate entry points
``stall``           engine_core tick, probed only while work is resident
                    — arm with ``mode="delay"`` and a ``delay_s`` past
                    ``recovery.step_stall_s`` to simulate a wedged loop
                    (stuck decode step / Mosaic hang) for the hang
                    watchdog; ``raise`` mode is a plain tick crash
``weight_corrupt``  integrity idle sweep (vgate_tpu_torch/integrity.py) —
                    ``corrupt`` mode XOR-flips the bits of one
                    device-resident weight shard (a TRUE silent
                    corruption: the checksum sweep detects it, the
                    canary genuinely fails, and the supervisor/dp
                    repair reloads weights); ``raise`` mode with
                    ``kind=corrupt`` drills the classification path
                    without touching weights
``logit_corrupt``   decode-chunk readback — ``corrupt`` mode scrambles
                    the on-device logit-guard flag word so the output
                    sentinels trip exactly as they would on NaN logits
                    (requires ``integrity.logit_guard``)
``rpc_send``        worker RPC plane (runtime/rpc.py), outbound frame —
                    wire modes apply: ``drop`` discards the frame
                    unsent, ``garble`` scrambles its bytes on the wire
                    (the peer sees a framing violation → typed error +
                    connection teardown), ``delay`` stalls the send,
                    ``raise`` fails it
``rpc_recv``        worker RPC plane, inbound frame — same wire modes,
                    applied after a frame decodes (``garble`` instead
                    corrupts the raw bytes before decoding)
``kv_transfer``     disaggregated prefill→decode KV handoff (runtime/
                    pod_engine.py), probed per transfer chunk — wire
                    modes apply: ``drop`` loses the chunk (coverage gap
                    at commit → typed error → bounded retry), ``garble``
                    corrupts its bytes (digest mismatch at commit),
                    ``duplicate`` ships the chunk twice (idempotent-put
                    drill), ``delay`` widens the kill window, ``raise``
                    fails the transfer call outright
==================  ====================================================

Arming — programmatic (tests)::

    from vgate_tpu_torch import faults
    faults.arm("decode_step", mode="raise", kind="transient", times=1)
    faults.arm("prefill", kind="poison", times=-1,
               match=lambda ids: 666 in ids)

or env-driven (chaos / ops drills), parsed once at import and on demand
via :func:`arm_from_env`::

    VGT_FAULTS="decode_step:raise:times=2,prefill:delay:delay=0.1"
    VGT_CHAOS="0.02"        # every point, raise, 2% per probe

``kind`` feeds the supervisor's error classifier
(vgate_tpu_torch/runtime/supervisor.py): ``transient`` faults trigger a
supervised restart, ``poison`` quarantines the matched request, and
``unrecoverable`` sends the health state machine straight to ``DEAD``.

The disarmed fast path is one module-global boolean read — safe to leave
in hot loops (the kv allocator probes on every page allocation).
"""

from __future__ import annotations

import hashlib
import os
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from vgate_tpu_torch.logging_config import get_logger

logger = get_logger(__name__)

FAULT_POINTS = (
    "decode_step",
    "prefill",
    "weight_load",
    "kv_alloc",
    "backend_generate",
    "stall",
    "weight_corrupt",
    "logit_corrupt",
    "rpc_send",
    "rpc_recv",
    "kv_transfer",
)

# wire modes only make sense where there is a wire: the RPC plane probes
# via wire_action(), everything else probes via check()/corrupt_array()
WIRE_POINTS = ("rpc_send", "rpc_recv", "kv_transfer")
WIRE_MODES = ("drop", "garble", "duplicate")
# frame duplication only makes sense on the chunked KV-handoff plane —
# the request/reply RPC verbs have no idempotent-redelivery semantics
DUPLICATE_POINTS = ("kv_transfer",)

# `corrupt` routes the supervisor/dp repair to the RELOAD rebuild path
# (weights-kept restarts would preserve the corruption) — see
# vgate_tpu_torch/integrity.py and runtime/supervisor.py classify_fatal
FAULT_KINDS = ("transient", "poison", "unrecoverable", "corrupt")

FAULTS_ENV = "VGT_FAULTS"
CHAOS_ENV = "VGT_CHAOS"


class InjectedFault(RuntimeError):
    """Raised by an armed ``raise``-mode fault.  ``fault_kind`` drives the
    supervisor's classification; ``fingerprint`` (when the probe passed a
    payload) names the request the fault targeted."""

    def __init__(
        self,
        point: str,
        kind: str = "transient",
        fingerprint: Optional[str] = None,
    ) -> None:
        super().__init__(f"injected {kind} fault at {point!r}")
        self.point = point
        self.fault_kind = kind
        self.fingerprint = fingerprint


def fingerprint(payload: Any) -> str:
    """Stable identity used by fault matching and the poison quarantine.
    Token-id sequences (the prefill probe's payload) hash by value so a
    list and tuple of the same prompt collide; scalar/string payloads
    (kv_alloc passes a page count, weight_load a checkpoint path) hash
    by repr — check() must never crash on a probe's payload type."""
    if isinstance(payload, (str, bytes)):
        data = payload.encode() if isinstance(payload, str) else payload
    else:
        try:
            data = " ".join(str(int(t)) for t in payload).encode()
        except (TypeError, ValueError):
            data = repr(payload).encode()
    return hashlib.sha1(data).hexdigest()[:16]


@dataclass
class FaultSpec:
    point: str
    mode: str = "raise"  # raise | delay | corrupt | drop | garble
    kind: str = "transient"  # transient | poison | unrecoverable
    times: int = 1  # fires remaining; -1 = unlimited
    probability: float = 1.0
    delay_s: float = 0.05
    # payload predicate: only probes whose payload satisfies it fire
    # (e.g. target one poison prompt).  None matches every probe.
    match: Optional[Callable[[Any], bool]] = None
    fired: int = 0
    _rng: random.Random = field(default_factory=random.Random, repr=False)


_lock = threading.Lock()
_specs: Dict[str, List[FaultSpec]] = {}
# fast-path guard: hot probe sites read one boolean when nothing is armed
_active = False


def is_active() -> bool:
    """True when any fault is armed — hot probe sites whose *payload* is
    costly to build should gate on this before constructing it (check()
    itself already fast-paths, but its arguments are evaluated first)."""
    return _active


def arm(
    point: str,
    mode: str = "raise",
    kind: str = "transient",
    times: int = 1,
    probability: float = 1.0,
    delay_s: float = 0.05,
    match: Optional[Callable[[Any], bool]] = None,
    seed: Optional[int] = None,
) -> FaultSpec:
    """Arm one fault at ``point``.  Returns the spec (its ``fired``
    counter is live, so tests can assert the probe actually tripped)."""
    global _active
    if point not in FAULT_POINTS:
        raise ValueError(
            f"unknown fault point {point!r}; valid: {FAULT_POINTS}"
        )
    if mode not in ("raise", "delay", "corrupt") + WIRE_MODES:
        raise ValueError(f"unknown fault mode {mode!r}")
    if mode in WIRE_MODES and point not in WIRE_POINTS:
        raise ValueError(
            f"mode {mode!r} is wire-only; valid points: {WIRE_POINTS}"
        )
    if mode == "duplicate" and point not in DUPLICATE_POINTS:
        raise ValueError(
            f"mode 'duplicate' is chunk-transfer-only; valid points: "
            f"{DUPLICATE_POINTS}"
        )
    if kind not in FAULT_KINDS:
        raise ValueError(f"unknown fault kind {kind!r}")
    spec = FaultSpec(
        point=point,
        mode=mode,
        kind=kind,
        times=times,
        probability=probability,
        delay_s=delay_s,
        match=match,
    )
    if seed is not None:
        spec._rng.seed(seed)
    with _lock:
        _specs.setdefault(point, []).append(spec)
        _active = True
    logger.warning(
        "fault armed",
        extra={
            "extra_data": {
                "point": point, "mode": mode, "kind": kind,
                "times": times, "probability": probability,
            }
        },
    )
    return spec


def disarm(point: Optional[str] = None) -> None:
    """Disarm every fault at ``point`` (all points when None)."""
    global _active
    with _lock:
        if point is None:
            _specs.clear()
        else:
            _specs.pop(point, None)
        _active = any(_specs.values())


def reset() -> None:
    """Full reset (tests call this between cases)."""
    disarm(None)


def snapshot() -> List[Dict[str, Any]]:
    """Armed-fault inventory for /stats and operator introspection."""
    with _lock:
        return [
            {
                "point": s.point,
                "mode": s.mode,
                "kind": s.kind,
                "times": s.times,
                "probability": s.probability,
                "fired": s.fired,
            }
            for specs in _specs.values()
            for s in specs
        ]


def _take(point: str, payload: Any, modes) -> Optional[FaultSpec]:
    """Pick the first armed spec at ``point`` whose mode is in ``modes``,
    matches, and fires — consuming one charge.  Called with the registry
    lock held.  The mode filter splits the probe families: ``check``
    consumes raise/delay specs, ``corrupt_array``/``take_corrupt``
    consume corrupt specs, and ``wire_action`` (the RPC plane) consumes
    raise/delay/drop/garble specs."""
    global _active
    for spec in _specs.get(point, ()):
        if spec.mode not in modes:
            continue
        if spec.times == 0:
            continue
        if spec.match is not None:
            try:
                if not spec.match(payload):
                    continue
            except Exception:  # a broken predicate must not mask serving
                continue
        if spec.probability < 1.0 and spec._rng.random() >= spec.probability:
            continue
        spec.fired += 1
        if spec.times > 0:
            spec.times -= 1
            if spec.times == 0:
                # prune exhausted one-shots so the hot-path probes get
                # their one-boolean fast path back once nothing is armed
                remaining = [s for s in _specs[point] if s is not spec]
                if remaining:
                    _specs[point] = remaining
                else:
                    del _specs[point]
                _active = any(_specs.values())
        return spec
    return None


def check(point: str, payload: Any = None) -> None:
    """Probe call threaded through the runtime.  No-op unless a matching
    fault is armed; otherwise sleeps (``delay``) or raises
    :class:`InjectedFault` (``raise``).  ``corrupt`` specs are consumed
    by :func:`corrupt_array` at readback sites, not here."""
    if not _active:
        return
    with _lock:
        spec = _take(point, payload, modes=("raise", "delay"))
    if spec is None:
        return
    from vgate_tpu_torch.runtime import engine_metrics as metrics

    metrics.FAULTS_INJECTED.labels(point=point, mode=spec.mode).inc()
    if spec.mode == "delay":
        time.sleep(spec.delay_s)
        return
    fp = fingerprint(payload) if payload is not None else None
    raise InjectedFault(point, kind=spec.kind, fingerprint=fp)


def wire_action(point: str, payload: Any = None) -> Optional[str]:
    """Probe call for the worker RPC plane (vgate_tpu_torch/runtime/rpc.py).
    Returns the wire verdict for one frame: ``None`` (send/deliver it
    untouched, the overwhelmingly common disarmed fast path), ``"drop"``
    (discard the frame silently — the peer sees a missing reply and its
    call deadline fires), ``"garble"`` (the caller scrambles the raw
    frame bytes so the peer hits a framing violation and tears the
    connection down), or ``"duplicate"`` (kv_transfer only: the caller
    ships the chunk twice to drill idempotent redelivery).  ``delay``
    specs sleep here and then deliver;
    ``raise`` specs raise :class:`InjectedFault` at the wire call site."""
    if not _active:
        return None
    if point not in WIRE_POINTS:
        raise ValueError(
            f"wire_action probed at non-wire point {point!r}; "
            f"valid: {WIRE_POINTS}"
        )
    with _lock:
        spec = _take(point, payload, modes=("raise", "delay") + WIRE_MODES)
    if spec is None:
        return None
    from vgate_tpu_torch.runtime import engine_metrics as metrics

    metrics.FAULTS_INJECTED.labels(point=point, mode=spec.mode).inc()
    if spec.mode == "delay":
        time.sleep(spec.delay_s)
        return None
    if spec.mode in WIRE_MODES:
        return spec.mode
    fp = fingerprint(payload) if payload is not None else None
    raise InjectedFault(point, kind=spec.kind, fingerprint=fp)


def corrupt_array(point: str, array):
    """Value-corruption hook for readback sites: when a ``corrupt`` fault
    is armed at ``point`` and fires, returns a deterministically
    scrambled copy of ``array`` (token ids XOR 0x55 — garbage but valid
    int32) so downstream token handling sees corrupted data without the
    probe site knowing array semantics."""
    if not _active:
        return array
    with _lock:
        spec = _take(point, None, modes=("corrupt",))
        if spec is None:
            return array
    from vgate_tpu_torch.runtime import engine_metrics as metrics

    metrics.FAULTS_INJECTED.labels(point=point, mode="corrupt").inc()
    return array ^ 0x55


def take_corrupt(point: str) -> bool:
    """Consume one armed ``corrupt``-mode charge at ``point`` WITHOUT
    transforming an array — for sites whose corruption payload is not a
    simple int-XOR (the integrity sweep bit-flips a float weight shard
    via bitcast; vgate_tpu_torch/integrity.py).  Returns True when a spec
    fired; the caller performs the corruption itself."""
    if not _active:
        return False
    with _lock:
        spec = _take(point, None, modes=("corrupt",))
    if spec is None:
        return False
    from vgate_tpu_torch.runtime import engine_metrics as metrics

    metrics.FAULTS_INJECTED.labels(point=point, mode="corrupt").inc()
    return True


def arm_from_env(environ: Optional[Dict[str, str]] = None) -> int:
    """Parse ``VGT_FAULTS`` / ``VGT_CHAOS`` and arm accordingly; returns
    the number of specs armed.

    ``VGT_FAULTS`` is comma-separated entries ``point:mode[:key=value...]``
    with keys ``kind``, ``times``, ``p`` (probability), ``delay``::

        VGT_FAULTS="decode_step:raise:kind=transient:times=2,kv_alloc:delay:delay=0.01"

    ``VGT_CHAOS=<probability>`` arms an unlimited transient ``raise`` at
    every point with that per-probe probability (the chaos-mode knob the
    chaos test suite and ops drills use)."""
    env = environ if environ is not None else os.environ
    armed = 0
    chaos = env.get(CHAOS_ENV, "").strip()
    if chaos:
        try:
            p = float(chaos)
        except ValueError:
            logger.error("invalid %s=%r (want a probability)", CHAOS_ENV, chaos)
        else:
            if p > 0:
                for point in FAULT_POINTS:
                    arm(point, mode="raise", kind="transient",
                        times=-1, probability=p)
                    armed += 1
    raw = env.get(FAULTS_ENV, "").strip()
    if not raw:
        return armed
    for entry in raw.split(","):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.split(":")
        if len(parts) < 2:
            logger.error("invalid %s entry %r (want point:mode[:k=v])",
                         FAULTS_ENV, entry)
            continue
        point, mode = parts[0], parts[1]
        kwargs: Dict[str, Any] = {}
        bad = False
        for kv in parts[2:]:
            key, _, val = kv.partition("=")
            try:
                if key == "kind":
                    kwargs["kind"] = val
                elif key == "times":
                    kwargs["times"] = int(val)
                elif key == "p":
                    kwargs["probability"] = float(val)
                elif key == "delay":
                    kwargs["delay_s"] = float(val)
                else:
                    raise ValueError(f"unknown key {key!r}")
            except ValueError as exc:
                logger.error("invalid %s entry %r: %s", FAULTS_ENV, entry, exc)
                bad = True
                break
        if bad:
            continue
        try:
            arm(point, mode=mode, **kwargs)
            armed += 1
        except ValueError as exc:
            logger.error("invalid %s entry %r: %s", FAULTS_ENV, entry, exc)
    return armed


# env-armed faults apply process-wide from first import (the engine
# imports this module before any probe can run)
arm_from_env()
