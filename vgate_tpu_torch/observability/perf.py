"""Per-tick perf attribution for the engine loop, a copy of
vgate_tpu/observability/perf.py for the port: where did the time go?

Three pieces, all owned by one :class:`PerfRecorder` that lives next to
the engine's FlightRecorder (engine-thread hot path takes no locks;
snapshot readers copy defensively under the GIL):

* **TickProfile** — every engine tick decomposed into phases:

  - ``host_s``     scheduler/admission/bookkeeping between dispatches
                   (derived: tick wall minus the measured phases, so the
                   five phases sum to the tick wall by construction);
  - ``dispatch_s`` enqueueing a prompt pass or a decode chunk (the FIRST
                   dispatch of a chunk key includes its CUDA-graph
                   capture, and a kernel's first use its ``nvcc`` build —
                   the compile ledger records that share);
  - ``device_s``   host blocked on device execution, measured at the
                   readback the hot path already has: the wait on the
                   readback's CUDA event (no new synchronisation; the
                   one wait is split from the host copy after it);
  - ``readback_s`` the host-side copy of the read-back outputs;
  - ``detok_s``    token append, stop detection, stream callbacks.

  Host-side KV swap traffic (runtime/kv_swap.py) is left in ``host_s``.

* **Compile ledger** — one entry per new static key (a decode graph
  captured, a prompt-pass shape first run) and per kernel built at
  first use, hooked where the engine stamps ``compiling=True``
  heartbeats.  In steady state the ledger is frozen.

* **Rolling window** — live tok/s, MFU and %-of-HBM-roofline computed
  from the engine's own geometry (observability/roofline.py) plus the
  host-overhead ratio (host_s / wall over the window).

Surfaces: ``GET /debug/perf``, the ``/stats`` engine block (``perf``),
and the metrics ``vgt_tick_phase_seconds{phase}`` /
``vgt_recompiles_total{variant}`` / ``vgt_decode_mfu`` /
``vgt_decode_hbm_roofline_pct`` / ``vgt_host_overhead_ratio`` (through
runtime/engine_metrics.py, no-ops without prometheus_client).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Dict, List, Optional

from vgate_tpu_torch.runtime import engine_metrics as metrics
from vgate_tpu_torch.observability.roofline import EngineRoofline

# the fixed phase taxonomy (docs/observability.md "Perf attribution")
PHASES = ("host", "dispatch", "device", "readback", "detok")

# gauges + ledger-size trims run at most this often (engine thread)
_FLUSH_INTERVAL_S = 0.5


class TickProfile:
    """One engine tick's phase decomposition (mutable accumulator while
    the tick runs; frozen by :meth:`PerfRecorder.tick_end`)."""

    __slots__ = (
        "t", "wall", "host", "dispatch", "device", "readback", "detok",
        "tokens", "decode_steps", "decode_bytes", "decode_device_s",
    )

    def __init__(self, t: float) -> None:
        self.t = t
        self.wall = 0.0
        self.host = 0.0
        self.dispatch = 0.0
        self.device = 0.0
        self.readback = 0.0
        self.detok = 0.0
        self.tokens = 0
        self.decode_steps = 0
        self.decode_bytes = 0
        self.decode_device_s = 0.0

    def measured(self) -> float:
        return self.dispatch + self.device + self.readback + self.detok

    def phases(self) -> Dict[str, float]:
        return {
            "host": self.host,
            "dispatch": self.dispatch,
            "device": self.device,
            "readback": self.readback,
            "detok": self.detok,
        }

    def to_dict(self) -> Dict[str, Any]:
        out = {
            f"{name}_s": round(value, 6)
            for name, value in self.phases().items()
        }
        out["wall_s"] = round(self.wall, 6)
        out["tokens"] = self.tokens
        return out


class PerfRecorder:
    """Owned by one EngineCore, rebuilt fresh on supervised restart like
    the flight recorder.  All mutation happens on the engine thread; the
    per-0.5s flush keeps gauge math off the per-tick path."""

    def __init__(
        self,
        cfg: Optional[Any] = None,
        roofline: Optional[EngineRoofline] = None,
        clock: Any = time.perf_counter,
    ) -> None:
        # injectable clock (tests pin window math on a fake clock; the
        # engine always uses perf_counter)
        self._clock = clock
        if cfg is None:
            from vgate_tpu_torch.config import ObservabilityConfig

            cfg = ObservabilityConfig()
        self.enabled = bool(cfg.enabled) and bool(cfg.perf_enabled)
        self.window_s = max(1.0, float(cfg.perf_window_s))
        self.roofline = roofline
        self._ring: "deque[TickProfile]" = deque(
            maxlen=max(16, int(cfg.perf_ticks))
        )
        self._ledger_max = max(16, int(cfg.perf_compile_ledger_max))
        # (program, signature) -> ledger entry, insertion-ordered
        self._ledger: Dict[tuple, Dict[str, Any]] = {}
        self._cur: Optional[TickProfile] = None
        self._next_flush = 0.0
        self._last_profile: Optional[Dict[str, Any]] = None
        # lifetime totals (snapshot deltas drive the loadlab artifact)
        self.total_ticks = 0
        self.total_idle_ticks = 0
        self.total_tokens = 0
        self.total_decode_steps = 0
        self.total_wall_s = 0.0
        self.total_compile_s = 0.0
        self._phase_totals = {name: 0.0 for name in PHASES}
        # monotone per-program compile counters — NOT derived from the
        # evicting ledger, so a recompile storm (which evicts old
        # entries) can never make the loadlab delta go negative
        self._compile_counts: Dict[str, int] = {}
        # label children resolved once: .labels() takes the registry
        # lock per call, and this runs on the loop this module measures
        self._phase_counters = {
            name: metrics.TICK_PHASE_SECONDS.labels(phase=name)
            for name in PHASES
        }

    # ------------------------------------------------- engine hot path

    def tick_begin(self) -> None:
        if not self.enabled:
            return
        self._cur = TickProfile(self._clock())

    def phase(self, name: str, seconds: float) -> None:
        """Accrue measured time into the current tick's ``name`` phase
        (dispatch/device/readback/detok; host is derived)."""
        cur = self._cur
        if cur is None or seconds <= 0:
            return
        setattr(cur, name, getattr(cur, name) + seconds)

    def note_tokens(self, n: int) -> None:
        """Tokens delivered to sequences this tick (decode appends,
        prefill first tokens, accepted speculative runs)."""
        cur = self._cur
        if cur is not None and n > 0:
            cur.tokens += n

    def note_decode(
        self, steps: int, ctx_tokens: int, device_s: float
    ) -> None:
        """One decode-chunk (or spec-verify) readback: ``steps`` fused
        steps over ``ctx_tokens`` total resident context tokens, with
        ``device_s`` of host-observed device time — feeds the modeled
        HBM traffic the roofline gauge divides by."""
        cur = self._cur
        if cur is None:
            return
        cur.decode_steps += steps
        cur.decode_device_s += device_s
        if self.roofline is not None:
            cur.decode_bytes += steps * self.roofline.step_bytes(
                ctx_tokens
            )

    def tick_end(self, worked: bool) -> None:
        """Close the tick: derive ``host_s`` as the unexplained wall
        remainder (clamped at 0 — the explained phases can overshoot
        the wall only by clock noise), push the profile into the
        rolling ring, and feed the phase counters."""
        cur = self._cur
        self._cur = None
        if cur is None:
            return
        now = self._clock()
        cur.wall = now - cur.t
        if not worked and cur.measured() == 0.0 and cur.tokens == 0:
            # no-work ticks are idle polls, not attribution evidence —
            # but the gauge flush still runs on cadence, so an engine
            # going idle decays its window gauges instead of freezing
            # them at the last loaded value
            self.total_idle_ticks += 1
            if now >= self._next_flush:
                self._next_flush = now + _FLUSH_INTERVAL_S
                self._flush_gauges(now)
            return
        cur.host = max(0.0, cur.wall - cur.measured())
        self._ring.append(cur)
        self.total_ticks += 1
        self.total_tokens += cur.tokens
        self.total_decode_steps += cur.decode_steps
        self.total_wall_s += cur.wall
        for name, value in cur.phases().items():
            self._phase_totals[name] += value
            if value > 0:
                self._phase_counters[name].inc(value)
        if now >= self._next_flush:
            self._next_flush = now + _FLUSH_INTERVAL_S
            self._flush_gauges(now)

    def record_compile(
        self,
        program: str,
        signature: Any,
        seconds: float,
        trigger: str,
    ) -> None:
        """One compile observed at a fresh-variant first dispatch (the
        dispatch's duration includes the graph capture or kernel build,
        which run synchronously at the call).  The engine's compiled-variant
        sets gate the call, so each variant lands here exactly once per
        core incarnation; ``count`` > 1 therefore means the SAME
        signature compiled again (it should not, short of a rebuild)."""
        if not self.enabled:
            return
        key = (program, str(signature))
        entry = self._ledger.get(key)
        now = time.time()
        if entry is None:
            if len(self._ledger) >= self._ledger_max:
                # bound the ledger: drop the oldest entry (insertion
                # order ~ compile order; steady state never gets here)
                self._ledger.pop(next(iter(self._ledger)))
            entry = {
                "program": program,
                "signature": str(signature),
                "trigger": trigger,
                "count": 0,
                "seconds": 0.0,
                "first_t": now,
            }
            self._ledger[key] = entry
        entry["count"] += 1
        entry["seconds"] = round(entry["seconds"] + seconds, 6)
        entry["last_t"] = now
        self.total_compile_s += seconds
        self._compile_counts[program] = (
            self._compile_counts.get(program, 0) + 1
        )
        metrics.RECOMPILES_BY_VARIANT.labels(variant=program).inc()

    def note_profile(self, info: Dict[str, Any]) -> None:
        """Link a ``POST /v1/profile`` torch.profiler trace capture to this layer:
        /debug/perf reports the last capture so operators can correlate
        attribution windows with device timelines."""
        self._last_profile = {
            **info, "ts": time.strftime(
                "%Y-%m-%dT%H:%M:%SZ", time.gmtime()
            ),
        }

    # ------------------------------------------------------ aggregates

    def _window_profiles(self, now: float) -> List[TickProfile]:
        # copy before iterating: reader threads (/stats, /debug/perf)
        # walk this while the engine thread appends, and a deque
        # iterator raises on concurrent mutation (list() is atomic
        # enough under the GIL)
        profs = list(self._ring)
        cutoff = now - self.window_s
        out: List[TickProfile] = []
        for prof in reversed(profs):
            if prof.t < cutoff:
                break
            out.append(prof)
        out.reverse()
        return out

    def window(self) -> Dict[str, Any]:
        """Rolling-window aggregates: live tok/s, MFU, %-of-HBM-roofline
        and the host-overhead ratio.  Safe from any thread."""
        now = self._clock()
        profs = self._window_profiles(now)
        phases = {name: 0.0 for name in PHASES}
        wall = 0.0
        tokens = 0
        decode_steps = 0
        decode_bytes = 0
        decode_device_s = 0.0
        for prof in profs:
            for name, value in prof.phases().items():
                phases[name] += value
            wall += prof.wall
            tokens += prof.tokens
            decode_steps += prof.decode_steps
            decode_bytes += prof.decode_bytes
            decode_device_s += prof.decode_device_s
        # offered span: from the oldest in-window tick to now (the
        # engine may have gone idle — tok/s decays over real time)
        span = (now - profs[0].t) if profs else 0.0
        tok_s = tokens / span if span > 0 else 0.0
        mfu = hbm_pct = None
        if self.roofline is not None:
            mfu = self.roofline.mfu(tok_s)
            hbm_pct = self.roofline.hbm_roofline_pct(
                decode_bytes, decode_device_s
            )
        return {
            "window_s": self.window_s,
            "span_s": round(span, 3),
            "ticks": len(profs),
            "tokens": tokens,
            "tokens_per_s": round(tok_s, 2),
            "decode_steps": decode_steps,
            "decode_device_s": round(decode_device_s, 6),
            "phase_seconds": {
                k: round(v, 6) for k, v in phases.items()
            },
            "wall_s": round(wall, 6),
            "host_overhead_ratio": (
                round(phases["host"] / wall, 4) if wall > 0 else None
            ),
            "mfu": None if mfu is None else round(mfu, 4),
            "hbm_roofline_pct": (
                None if hbm_pct is None else round(hbm_pct, 2)
            ),
        }

    def _flush_gauges(self, now: float) -> None:
        # None (no in-window work / device off the peak table) exports
        # as 0 so an engine going idle decays the gauges instead of
        # freezing them at the last loaded value
        win = self.window()
        metrics.HOST_OVERHEAD_RATIO.set(
            win["host_overhead_ratio"] or 0.0
        )
        metrics.DECODE_MFU.set(win["mfu"] or 0.0)
        metrics.DECODE_HBM_ROOFLINE_PCT.set(
            win["hbm_roofline_pct"] or 0.0
        )

    def compile_ledger(self) -> List[Dict[str, Any]]:
        return [dict(entry) for entry in list(self._ledger.values())]

    def totals(self) -> Dict[str, Any]:
        """Lifetime counters — monotone, so the loadlab runner can
        difference two scrapes into a per-cell attribution delta.
        ``compiles`` comes from the dedicated counters, NOT the ledger:
        ledger eviction under a recompile storm must never make a
        delta go negative."""
        compiles = dict(self._compile_counts)
        return {
            "ticks": self.total_ticks,
            "idle_ticks": self.total_idle_ticks,
            "tokens": self.total_tokens,
            "decode_steps": self.total_decode_steps,
            "wall_s": round(self.total_wall_s, 6),
            "phase_seconds": {
                k: round(v, 6) for k, v in self._phase_totals.items()
            },
            "compiles": compiles,
            "compile_seconds": round(self.total_compile_s, 6),
        }

    def snapshot(self) -> Dict[str, Any]:
        """The full /debug/perf payload for one engine core."""
        if not self.enabled:
            return {"enabled": False}
        last = list(self._ring)[-1:]
        return {
            "enabled": True,
            "window": self.window(),
            "totals": self.totals(),
            "last_tick": last[0].to_dict() if last else None,
            "compile_ledger": self.compile_ledger(),
            "roofline": (
                self.roofline.to_dict()
                if self.roofline is not None
                else None
            ),
            "last_profile": self._last_profile,
        }

    def get_stats(self) -> Dict[str, Any]:
        """The compact /stats ``perf`` block."""
        if not self.enabled:
            return {"enabled": False}
        win = self.window()
        return {
            "enabled": True,
            "tokens_per_s": win["tokens_per_s"],
            "mfu": win["mfu"],
            "hbm_roofline_pct": win["hbm_roofline_pct"],
            "host_overhead_ratio": win["host_overhead_ratio"],
            "phase_seconds": self.totals()["phase_seconds"],
            "ticks": self.total_ticks,
            "compiles": self.totals()["compiles"],
            "compile_seconds": round(self.total_compile_s, 6),
        }


# ------------------------------------------------------- dp aggregation

def _weighted_ratio(parts: List[tuple]) -> Optional[float]:
    """Weighted mean of (value, weight) pairs, None-tolerant."""
    num = den = 0.0
    for value, weight in parts:
        if value is None or weight <= 0:
            continue
        num += value * weight
        den += weight
    return round(num / den, 4) if den > 0 else None


def merge_snapshots(
    snaps: List[Dict[str, Any]]
) -> Dict[str, Any]:
    """Fold per-replica /debug/perf snapshots into one pod view
    (runtime/dp_engine.py — the _MergedFlight pattern): additive fields
    sum, ratios average weighted by each replica's measured wall, and
    the per-replica payloads stay attached under ``replicas`` with
    their index."""
    enabled = [s for s in snaps if s.get("enabled")]
    out: Dict[str, Any] = {
        "enabled": bool(enabled),
        "replicas": [
            {"replica": i, **s} for i, s in enumerate(snaps)
        ],
    }
    if not enabled:
        return out
    windows = [s["window"] for s in enabled]
    totals = [s["totals"] for s in enabled]
    agg_window: Dict[str, Any] = {
        "window_s": max(w["window_s"] for w in windows),
        "ticks": sum(w["ticks"] for w in windows),
        "tokens": sum(w["tokens"] for w in windows),
        "tokens_per_s": round(
            sum(w["tokens_per_s"] for w in windows), 2
        ),
        "decode_steps": sum(w["decode_steps"] for w in windows),
        "phase_seconds": {
            name: round(
                sum(w["phase_seconds"][name] for w in windows), 6
            )
            for name in PHASES
        },
        "wall_s": round(sum(w["wall_s"] for w in windows), 6),
        "host_overhead_ratio": _weighted_ratio(
            [(w["host_overhead_ratio"], w["wall_s"]) for w in windows]
        ),
        # replicas are symmetric meshes: fleet MFU/roofline is the
        # token-weighted mean of the per-replica fractions
        "mfu": _weighted_ratio(
            [(w["mfu"], max(1, w["tokens"])) for w in windows]
        ),
        "hbm_roofline_pct": _weighted_ratio(
            [
                (w["hbm_roofline_pct"], w["decode_device_s"])
                for w in windows
            ]
        ),
    }
    agg_compiles: Dict[str, int] = {}
    for t in totals:
        for program, count in t["compiles"].items():
            agg_compiles[program] = (
                agg_compiles.get(program, 0) + count
            )
    agg_totals = {
        "ticks": sum(t["ticks"] for t in totals),
        "idle_ticks": sum(t["idle_ticks"] for t in totals),
        "tokens": sum(t["tokens"] for t in totals),
        "decode_steps": sum(t["decode_steps"] for t in totals),
        "wall_s": round(sum(t["wall_s"] for t in totals), 6),
        "phase_seconds": {
            name: round(
                sum(t["phase_seconds"][name] for t in totals), 6
            )
            for name in PHASES
        },
        "compiles": agg_compiles,
        "compile_seconds": round(
            sum(t["compile_seconds"] for t in totals), 6
        ),
    }
    out["window"] = agg_window
    out["totals"] = agg_totals
    return out


def merge_stats(blocks: List[Dict[str, Any]]) -> Dict[str, Any]:
    """The dp /stats ``perf`` aggregate from per-replica get_stats
    blocks (additive sums; ratio gauges wall/token-weighted like
    merge_snapshots)."""
    enabled = [b for b in blocks if b.get("enabled")]
    if not enabled:
        return {"enabled": False}
    compiles: Dict[str, int] = {}
    for b in enabled:
        for program, count in b.get("compiles", {}).items():
            compiles[program] = compiles.get(program, 0) + count
    wall_of = [
        sum(b["phase_seconds"].values()) for b in enabled
    ]
    # efficiency ratios weight by each replica's live throughput so a
    # near-idle replica cannot drag the pod number — the same weighting
    # family merge_snapshots uses for /debug/perf, keeping the two
    # surfaces consistent
    tok_of = [max(b["tokens_per_s"], 1e-9) for b in enabled]
    return {
        "enabled": True,
        "tokens_per_s": round(
            sum(b["tokens_per_s"] for b in enabled), 2
        ),
        "mfu": _weighted_ratio(
            [(b["mfu"], w) for b, w in zip(enabled, tok_of)]
        ),
        "hbm_roofline_pct": _weighted_ratio(
            [
                (b["hbm_roofline_pct"], w)
                for b, w in zip(enabled, tok_of)
            ]
        ),
        "host_overhead_ratio": _weighted_ratio(
            [
                (b["host_overhead_ratio"], w)
                for b, w in zip(enabled, wall_of)
            ]
        ),
        "phase_seconds": {
            name: round(
                sum(b["phase_seconds"][name] for b in enabled), 6
            )
            for name in PHASES
        },
        "ticks": sum(b["ticks"] for b in enabled),
        "compiles": compiles,
        "compile_seconds": round(
            sum(b["compile_seconds"] for b in enabled), 6
        ),
    }
