"""The serving mesh over ``torch.distributed``: SPMD over processes.

The reference (vgate_tpu/parallel/mesh.py) is single-controller: one
process owns every device of a ``jax.sharding.Mesh`` and GSPMD inserts
the collectives.  The port has no GSPMD, so a mesh of ``pp x ep x sp x
tp`` devices is as many processes, as Megatron runs it, rank
``((pp_index * ep + ep_index) * sp + sp_index) * tp + tp_index`` (the
reference's axis order ``(dp, pp, ep, sp, tp)``: tp innermost, pp
outermost, so with the other axes at 1 a rank is its pipeline stage, or
its sp index):

* **rank 0** is the engine (runtime/engine_core.py).  It owns the
  scheduler, the sequences, the sampling, the readbacks and the gateway.
* **ranks 1..n-1** are followers (parallel/follower.py), spawned by
  :func:`build_mesh`.  Each holds its shard of the weights and its own
  pools, and runs exactly the device programs rank 0 names, on the
  inputs rank 0 sends.

The process groups that join them:

* the **control group** (gloo, the default group, every rank) carries
  host data: each program's name and host arrays (rank 0 broadcasts,
  the followers receive), replies (gathered to rank 0) and the pool
  size (the minimum over the ranks);
* the **device groups** carry the model's collectives on tensors, one
  group a mesh axis (:func:`axis_groups`), each holding the ranks that
  differ only in that axis's indices:

  - the **tp group** (tp index only) carries the all-reduces after the o
    and down products of dense layers and of the vocab-parallel
    embedding, and the logits' all-gather; at tp 1 none is issued;
  - the **expert group** (ep and tp indices, at one pp and sp index)
    carries a MoE layer's one all-reduce, which sums both the experts
    of the other ep ranks and the F partials of the other tp ranks; at
    ep 1 it is the tp group;
  - the **sp group** (sp index only) carries the all-gather of the
    attention partials (parallel/sp_decode.py) and the sum that brings
    each prompt row's last hidden to sp index 0;
  - the **whole group** (every rank) carries the broadcast of each
    decode step's sampled tokens from rank 0 and every point-to-point
    send: the sp ring's hops of K/V blocks (parallel/ring_attention.py,
    between the matching ranks of two sp indices, ``sp_peer``) and the
    pipeline relay's activations (parallel/pipeline.py: each stage to
    the next, and the last stage's hiddens back to stage 0, between the
    matching ranks of two stages, ``stage_rank``).

  A group whose ranks are those of another is that group (at pp = sp =
  1 the expert group is the whole group).  They are NCCL
  when every rank has a card of its own, and gloo on the CPU or when
  ``devices`` names one card more than once (the one-card test layout:
  NCCL refuses two ranks on one card); gloo's collectives then stage the
  card's tensors through host memory.  The choice follows from the
  device list, is logged and is reported in
  ``get_stats()["mesh"]["backend"]``; it is never made after a failure,
  and an NCCL init that fails raises.

A follower's death breaks the mesh: gloo's collectives raise at once on a
closed peer, and rank 0's monitor thread marks the mesh broken (and
aborts an NCCL device group, whose collectives would block), so the
engine's next tick raises :class:`FollowerLostError` into the
supervisor's containment.  The device group's timeout is longer than
``recovery.step_stall_s`` so the supervisor acts first.
"""

from __future__ import annotations

import atexit
import dataclasses
import datetime
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from vgate_tpu_torch.logging_config import get_logger

logger = get_logger(__name__)

AXIS_DP = "dp"
AXIS_PP = "pp"
AXIS_EP = "ep"
AXIS_SP = "sp"
AXIS_TP = "tp"
# the reference's axis order: pp outermost after dp, tp innermost
MESH_AXES = (AXIS_DP, AXIS_PP, AXIS_EP, AXIS_SP, AXIS_TP)

# followers wait on the control group for their next program for as long
# as the engine idles: its waits never time out (a dead rank 0 closes the
# connection, and gloo raises at once)
CONTROL_TIMEOUT = datetime.timedelta(days=7)
# the rendezvous through rank 0's store: a follower's interpreter start
STORE_TIMEOUT = datetime.timedelta(seconds=300)
NCCL_ABORT_TIMEOUT_S = 60.0


class FollowerLostError(RuntimeError):
    """A follower rank exited or its collectives failed: the mesh is
    broken and the supervisor rebuilds it with new followers."""


@dataclass(frozen=True)
class MeshPlan:
    """Resolved mesh geometry."""

    dp: int
    pp: int
    ep: int
    sp: int
    tp: int

    @property
    def shape(self) -> Tuple[int, int, int, int, int]:
        return (self.dp, self.pp, self.ep, self.sp, self.tp)

    @property
    def num_devices(self) -> int:
        return self.dp * self.pp * self.ep * self.sp * self.tp


def resolve_plan(device_config, num_devices: int) -> MeshPlan:
    """Resolve config axis sizes (0 = absorb the remaining devices)
    against ``num_devices``, with the reference's errors."""
    n = num_devices
    dp, pp, ep, sp, tp = (
        device_config.dp,
        getattr(device_config, "pp", 1),
        device_config.ep,
        device_config.sp,
        device_config.tp,
    )
    fixed = [x for x in (dp, pp, ep, sp, tp) if x > 0]
    free = [x for x in (dp, pp, ep, sp, tp) if x == 0]
    used = int(np.prod(fixed)) if fixed else 1
    if len(free) > 1:
        raise ValueError("at most one mesh axis may be 0 (auto)")
    if free:
        if n % used:
            raise ValueError(
                f"devices ({n}) not divisible by fixed axes product ({used})"
            )
        auto = n // used
        dp, pp, ep, sp, tp = [
            x if x > 0 else auto for x in (dp, pp, ep, sp, tp)
        ]
    plan = MeshPlan(dp=dp, pp=pp, ep=ep, sp=sp, tp=tp)
    if plan.num_devices != n:
        raise ValueError(
            f"mesh {plan.shape} covers {plan.num_devices} devices but "
            f"{n} are visible"
        )
    return plan


def visible_devices(device: str) -> List[str]:
    """The devices of ``device``'s kind this process sees: every card,
    or the CPU as one device."""
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() "
                "is false; pass device='cpu' explicitly to run on the CPU"
            )
        return [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    return ["cpu"]


def _named(device: str) -> str:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        return f"cuda:{torch.cuda.current_device()}"
    return str(dev)


def mesh_devices(device_config, devices: Optional[List[Any]] = None
                 ) -> List[str]:
    """Each rank's device, rank 0 first: ``devices`` (the engine's
    argument), else ``device.devices``, else derived from ``device.device``
    and ``pp x ep x sp x tp``: one rank on ``device`` at 1, the CPU once
    per rank, or the first ``pp x ep x sp x tp`` cards (every card with an
    axis at 0).  A list that names one card more than once is the one-card test
    layout."""
    if devices is None and getattr(device_config, "devices", None):
        devices = list(device_config.devices)
    if devices is not None:
        return [_named(str(d)) for d in devices]
    tp, ep = device_config.tp, device_config.ep
    pp = getattr(device_config, "pp", 1)
    sp = getattr(device_config, "sp", 1)
    if tp == 1 and ep == 1 and pp == 1 and sp == 1:
        # resolved by the engine, which refuses a card that is not there
        return [device_config.device]
    visible = visible_devices(device_config.device)
    if visible == ["cpu"]:
        return ["cpu"] * (max(1, tp) * max(1, ep) * max(1, pp) * max(1, sp))
    n = tp * ep * pp * sp or len(visible)
    if n > len(visible):
        raise ValueError(
            f"device.pp={pp} x device.ep={ep} x device.sp={sp} x "
            f"device.tp={tp} needs {n} cards but {len(visible)} are "
            "visible; name a card once per rank in device.devices to run "
            "the ranks on fewer cards"
        )
    return visible[:n]


def device_backend(devices: List[str]) -> str:
    """The device group's backend: NCCL when every rank has a card of
    its own, else gloo."""
    if all(torch.device(d).type == "cuda" for d in devices) and len(
        set(devices)
    ) == len(devices):
        return "nccl"
    return "gloo"


def axis_groups(plan: MeshPlan, axes: Tuple[str, ...]) -> List[List[int]]:
    """Every group of ranks that differ only in ``axes``' indices (one
    group for each index of the other axes, in rank order), each group's
    ranks ascending, so a gather over it comes back in its axes' order."""
    names = (AXIS_PP, AXIS_EP, AXIS_SP, AXIS_TP)
    sizes = (plan.pp, plan.ep, plan.sp, plan.tp)
    grid = np.arange(plan.num_devices // plan.dp).reshape(sizes)
    inner = [names.index(a) for a in axes]
    outer = [i for i in range(len(names)) if i not in inner]
    width = int(np.prod([sizes[i] for i in inner]))
    return np.transpose(grid, outer + inner).reshape(-1, width).tolist()


def device_group_timeout(recovery) -> datetime.timedelta:
    """Longer than the supervisor's stall limits, so its watchdog (and
    the follower monitor) act before a collective times out."""
    return datetime.timedelta(
        seconds=max(recovery.step_stall_s, recovery.compile_grace_s) + 60
    )


# meshes with live followers in this process, for the exit hook
_LIVE: "set[Mesh]" = set()


def _kill_live() -> None:
    for mesh in list(_LIVE):
        mesh.kill_followers()


atexit.register(_kill_live)


class Mesh:
    """One rank's view of the mesh: the plan, every rank's device, this
    rank (its tp and ep index) and its device, the process groups (more
    than one rank) and, on rank 0, the follower processes.  A one-rank
    mesh has no groups and issues no collective."""

    def __init__(self, plan: MeshPlan, devices: List[str], rank: int = 0,
                 backend: Optional[str] = None) -> None:
        self.plan = plan
        self.devices = list(devices)
        self.rank = rank
        self.device = torch.device(self.devices[rank])
        self.backend = backend
        self.ctrl: Any = None
        # the whole device group, and this rank's group on each axis (none
        # where that axis issues no collective: tp at 1, the expert group
        # at tp = ep = 1, sp at 1)
        self.group: Any = None
        self.tp_group: Any = None
        self.expert_group: Any = None
        self.sp_group: Any = None
        self.followers: List[subprocess.Popen] = []
        # why the mesh broke (a follower's exit, a failed collective)
        self.broken: Optional[str] = None
        # rank 0: the program the followers were named and rank 0 has not
        # finished its own part of (runtime/engine_core.py _program)
        self.pending: Optional[str] = None
        self.lock = threading.RLock()
        self._config_path: Optional[str] = None
        self._closed = False

    # ------------------------------------------------------------ geometry

    @property
    def tp(self) -> int:
        return self.plan.tp

    @property
    def ep(self) -> int:
        return self.plan.ep

    @property
    def pp(self) -> int:
        return self.plan.pp

    @property
    def sp(self) -> int:
        return self.plan.sp

    @property
    def tp_rank(self) -> int:
        """This rank's index on the tp axis (innermost)."""
        return self.rank % self.plan.tp

    @property
    def sp_rank(self) -> int:
        """This rank's index on the sp axis (inside its ep index)."""
        return self.rank // self.plan.tp % self.plan.sp

    @property
    def ep_rank(self) -> int:
        """This rank's index on the ep axis (inside its stage)."""
        return self.rank // (self.plan.tp * self.plan.sp) % self.plan.ep

    @property
    def pp_rank(self) -> int:
        """This rank's pipeline stage (outermost)."""
        return self.rank // (self.plan.tp * self.plan.sp * self.plan.ep)

    def stage_rank(self, stage: int) -> int:
        """The rank of ``stage`` (mod pp) at this rank's ep, sp and tp
        index."""
        inner = self.plan.tp * self.plan.sp * self.plan.ep
        return stage % self.plan.pp * inner + self.rank % inner

    def sp_peer(self, index: int) -> int:
        """The rank of sp index ``index`` (mod sp) at this rank's other
        indices."""
        tp = self.plan.tp
        here = self.sp_rank * tp + self.tp_rank
        return self.rank - here + index % self.plan.sp * tp + self.tp_rank

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(MESH_AXES, self.plan.shape))

    @property
    def num_devices(self) -> int:
        return self.plan.num_devices

    @property
    def card_share(self) -> int:
        """How many ranks share this rank's device."""
        return self.devices.count(self.devices[self.rank])

    @property
    def staged(self) -> bool:
        """gloo over a card's tensors: each collective goes through
        host memory."""
        return self.backend == "gloo" and self.device.type == "cuda"

    # -------------------------------------------------- device collectives

    def _failed(self, exc: BaseException) -> None:
        if self.broken is None:
            self.broken = f"collective failed: {exc}"

    def all_reduce(self, t: torch.Tensor,
                   experts: bool = False) -> torch.Tensor:
        """Sum ``t`` over this rank's tp group (with ``experts``, over
        its expert group), in place; returns it."""
        return self._sum(t, self.expert_group if experts else self.tp_group)

    def sp_all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over this rank's sp group, in place; returns it."""
        return self._sum(t, self.sp_group)

    def _sum(self, t: torch.Tensor, group: Any) -> torch.Tensor:
        try:
            if self.staged:
                host = t.cpu()
                dist.all_reduce(host, group=group)
                t.copy_(host)
            else:
                dist.all_reduce(t, group=group)
        except Exception as exc:
            self._failed(exc)
            raise
        return t

    def all_gather_last(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` of this rank's tp group joined along the
        last axis, tp order.  Over NCCL one gather into a ``[tp, ...]``
        buffer (allocated on the calling stream, so a graph capture holds
        it in its pool); over gloo a list of parts."""
        try:
            src = t.contiguous().cpu() if self.staged else t.contiguous()
            if self.backend == "nccl":
                flat = src.new_empty((self.tp, *src.shape))
                dist.all_gather_into_tensor(flat, src, group=self.tp_group)
                return torch.movedim(flat, 0, -2).reshape(
                    *src.shape[:-1], self.tp * src.shape[-1])
            parts = [torch.empty_like(src) for _ in range(self.tp)]
            dist.all_gather(parts, src, group=self.tp_group)
        except Exception as exc:
            self._failed(exc)
            raise
        out = torch.cat(parts, dim=-1)
        return out.to(t.device) if self.staged else out

    def broadcast(self, t: torch.Tensor) -> torch.Tensor:
        """Rank 0's ``t`` into every rank's ``t`` (the whole group), in
        place; returns it."""
        try:
            if self.staged:
                host = t.cpu()
                dist.broadcast(host, src=0, group=self.group)
                if self.rank:
                    t.copy_(host)
            else:
                dist.broadcast(t, src=0, group=self.group)
        except Exception as exc:
            self._failed(exc)
            raise
        return t

    def _p2p(self, t: torch.Tensor, peer: int, send: bool) -> None:
        """One point-to-point send of ``t`` to, or receive into ``t``
        from, rank ``peer`` on the device group (through host memory
        when staged)."""
        op = dist.send if send else dist.recv
        try:
            if self.staged:
                host = t.cpu() if send else torch.empty(t.shape,
                                                        dtype=t.dtype)
                op(host, peer, group=self.group)
                if not send:
                    t.copy_(host)
            else:
                op(t, peer, group=self.group)
        except Exception as exc:
            self._failed(exc)
            raise

    def send_next(self, t: torch.Tensor) -> None:
        """The pipeline relay: ``t`` to the next stage."""
        self._p2p(t, self.stage_rank(self.pp_rank + 1), True)

    def recv_prev(self, t: torch.Tensor) -> torch.Tensor:
        """The pipeline relay: the previous stage's activations into
        ``t``; returns it."""
        self._p2p(t, self.stage_rank(self.pp_rank - 1), False)
        return t

    def send_first(self, t: torch.Tensor) -> None:
        """The last stage's hiddens back to stage 0 (the ring's
        wrap-around link)."""
        self._p2p(t, self.stage_rank(0), True)

    def recv_last(self, t: torch.Tensor) -> torch.Tensor:
        """Stage 0: the last stage's hiddens into ``t``; returns it."""
        self._p2p(t, self.stage_rank(self.pp - 1), False)
        return t

    def ring_shift(self, t: torch.Tensor) -> torch.Tensor:
        """One hop of the sp ring: ``t`` to the next sp rank, and the
        previous sp rank's tensor of the same shape returned.  Posted in
        the pipeline relay's fixed order: sp rank 0 sends, then
        receives; every other rank receives, then sends, so no send
        waits on a peer that is itself waiting on a send (NCCL)."""
        got = torch.empty_like(t)
        nxt, prev = self.sp_peer(self.sp_rank + 1), self.sp_peer(
            self.sp_rank - 1)
        if self.sp_rank == 0:
            self._p2p(t, nxt, True)
            self._p2p(got, prev, False)
        else:
            self._p2p(got, prev, False)
            self._p2p(t, nxt, True)
        return got

    def sp_all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every sp rank's ``t`` stacked on a new leading axis, sp order
        (``[sp, *t.shape]``).  Over NCCL one gather into a buffer
        allocated on the calling stream (a graph capture holds it in its
        pool); over gloo a list of parts."""
        try:
            src = t.contiguous().cpu() if self.staged else t.contiguous()
            if self.backend == "nccl":
                out = src.new_empty((self.sp, *src.shape))
                dist.all_gather_into_tensor(out, src, group=self.sp_group)
                return out
            parts = [torch.empty_like(src) for _ in range(self.sp)]
            dist.all_gather(parts, src, group=self.sp_group)
        except Exception as exc:
            self._failed(exc)
            raise
        out = torch.stack(parts)
        return out.to(t.device) if self.staged else out

    # ------------------------------------------------------ control plane

    def send(self, op: str, **fields: Any) -> None:
        """Rank 0: name the next program, with its host inputs (numpy
        arrays and scalars), to every follower."""
        with self.lock:
            self.check()
            try:
                dist.broadcast_object_list(
                    [{"op": op, **fields}], src=0, group=self.ctrl
                )
            except Exception as exc:
                self._failed(exc)
                raise FollowerLostError(self.broken) from exc

    def recv(self) -> Dict[str, Any]:
        """A follower: the next program rank 0 names (blocks)."""
        box: List[Any] = [None]
        dist.broadcast_object_list(box, src=0, group=self.ctrl)
        return box[0]

    def gather(self, obj: Any) -> Optional[List[Any]]:
        """Every rank's ``obj``, in rank order, on rank 0 (None
        elsewhere)."""
        out = [None] * self.num_devices if self.rank == 0 else None
        dist.gather_object(obj, out, dst=0, group=self.ctrl)
        return out

    def request(self, op: str, **fields: Any) -> List[Any]:
        """Rank 0: ``send`` a program that replies, and return the
        followers' replies in rank order."""
        with self.lock:
            self.send(op, **fields)
            try:
                return self.gather(None)[1:]
            except Exception as exc:
                self._failed(exc)
                raise FollowerLostError(self.broken) from exc

    def all_min(self, value: int) -> int:
        """The smallest of every rank's ``value`` (the pool's page count:
        rank 0's scheduler hands out page ids for every rank)."""
        if self.num_devices == 1:
            return value
        with self.lock:
            t = torch.tensor([int(value)], dtype=torch.int64)
            dist.all_reduce(t, op=dist.ReduceOp.MIN, group=self.ctrl)
            return int(t.item())

    # ---------------------------------------------------------- lifecycle

    def check(self) -> None:
        """Raise :class:`FollowerLostError` if the mesh broke."""
        if self.broken is not None:
            raise FollowerLostError(self.broken)

    def healthy(self) -> bool:
        """Every follower alive and no collective failed."""
        return self.broken is None and all(
            p.poll() is None for p in self.followers
        )

    def _monitor(self) -> None:
        """Rank 0: poll the followers; the first exit breaks the mesh
        (and aborts an NCCL device group, whose collectives would wait
        on the dead rank)."""
        while not self._closed:
            for rank, proc in enumerate(self.followers, start=1):
                rc = proc.poll()
                if rc is not None and not self._closed:
                    if self.broken is None:
                        self.broken = (
                            f"mesh follower rank {rank} exited with code "
                            f"{rc}"
                        )
                    logger.error("mesh follower lost", extra={
                        "extra_data": {"rank": rank, "code": rc}})
                    if self.backend == "nccl":
                        abort = getattr(dist.distributed_c10d,
                                        "_abort_process_group", None)
                        if abort is not None:
                            for group in self._device_groups():
                                abort(group)
                    return
            time.sleep(0.1)

    def _leave_groups(self) -> None:
        """Destroy this rank's groups.  An NCCL group is aborted: its
        graceful shutdown waits for every peer's (seen to hang on the
        card when the peers leave at different times), an abort is
        local."""
        joined = self.ctrl is not None and dist.is_initialized()
        self.ctrl = self.group = self.tp_group = None
        self.expert_group = self.sp_group = None
        if not joined:
            return
        if self.backend != "nccl":
            dist.destroy_process_group()
            return
        # an NCCL communicator is held by every graph that captured its
        # collectives (the caller frees them first); an abort that still
        # waits fails here instead of hanging the gateway
        done = threading.Event()

        def abort() -> None:
            dist.distributed_c10d._abort_process_group()
            done.set()

        threading.Thread(target=abort, name="vgt-tp-abort",
                         daemon=True).start()
        if not done.wait(NCCL_ABORT_TIMEOUT_S):
            raise RuntimeError(
                f"the NCCL groups did not abort in {NCCL_ABORT_TIMEOUT_S} s"
            )

    def kill_followers(self) -> None:
        for proc in self.followers:
            if proc.poll() is None:
                proc.kill()
        for proc in self.followers:
            proc.wait()
        _LIVE.discard(self)

    def shutdown(self, timeout: float = 30.0) -> None:
        """Stop the followers (a ``stop`` program), leave the groups, wait
        up to ``timeout`` for the followers to exit and SIGKILL any still
        running, and remove the followers' config file.  Idempotent."""
        with self.lock:
            if self._closed:
                return
            if self.rank == 0 and self.followers and self.healthy():
                try:
                    self.send("stop")
                except FollowerLostError:
                    pass  # the kill below ends whatever is left
            self._closed = True
        self._leave_groups()
        deadline = time.monotonic() + timeout
        for proc in self.followers:
            try:
                proc.wait(max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass
        self.kill_followers()
        if self._config_path is not None:
            try:
                os.unlink(self._config_path)
            except FileNotFoundError:
                pass
            self._config_path = None

    # ------------------------------------------------------------ bring-up

    def join(self, store: Any, recovery) -> None:
        """Join the process groups as this rank: the control group, the
        whole device group and this rank's group on each axis that issues
        a collective (:meth:`_axis_groups`), then one warm collective on
        each device group and around each point-to-point ring (an NCCL
        communicator or link is built at its first use, which must not
        fall inside a graph capture)."""
        if dist.is_initialized():
            raise RuntimeError(
                "this process already belongs to a process group: one "
                "mesh a process"
            )
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        n = self.num_devices
        dist.init_process_group(
            "gloo", store=store, rank=self.rank, world_size=n,
            timeout=CONTROL_TIMEOUT,
        )
        self.ctrl = dist.group.WORLD
        timeout = device_group_timeout(recovery)
        made: Dict[Tuple[int, ...], Any] = {}
        warm: List[Tuple[Any, int]] = []

        def group_of(ranks: List[int]) -> Any:
            """The group over ``ranks`` (made once: every rank calls
            ``new_group`` for every group, in one order)."""
            key = tuple(ranks)
            if key not in made:
                made[key] = dist.new_group(ranks, backend=self.backend,
                                           timeout=timeout)
                if self.rank in ranks:
                    warm.append((made[key], len(ranks)))
            return made[key]

        self.group = group_of(list(range(n)))
        for attr, axes in self._axis_groups():
            for ranks in axis_groups(self.plan, axes):
                group = group_of(ranks)
                if self.rank in ranks:
                    setattr(self, attr, group)
        for group, size in warm:
            t = torch.ones(
                1, device=self.device if self.backend == "nccl" else "cpu"
            )
            dist.all_reduce(t, group=group)
            if int(t.item()) != size:
                raise RuntimeError(
                    f"device group warm-up summed {t.item()} over "
                    f"{size} ranks"
                )
        if self.pp > 1:
            self._warm_ring()
        if self.sp > 1:
            self._warm_sp_ring()

    def _axis_groups(self) -> List[Tuple[str, Tuple[str, ...]]]:
        """``(attribute, axes)`` of each axis group a collective of this
        mesh uses: the tp group at tp > 1, the expert group (ep and tp)
        at ep or tp > 1, the sp group at sp > 1."""
        out = []
        if self.tp > 1:
            out.append(("tp_group", (AXIS_TP,)))
        if self.tp > 1 or self.ep > 1:
            out.append(("expert_group", (AXIS_EP, AXIS_TP)))
        if self.sp > 1:
            out.append(("sp_group", (AXIS_SP,)))
        return out

    def _device_groups(self) -> List[Any]:
        """This rank's device groups, each once."""
        out: List[Any] = []
        for group in (self.group, self.tp_group, self.expert_group,
                      self.sp_group):
            if group is not None and all(group is not g for g in out):
                out.append(group)
        return out

    def _warm_ring(self) -> None:
        """One value around the pipeline ring, in the relay's order
        (stage 0 sends, then receives from the last stage): NCCL builds
        a point-to-point link at its first use, which must not fall
        inside a graph capture."""
        dev = self.device if self.backend == "nccl" else "cpu"
        t = torch.full((1,), float(self.pp_rank), device=dev)
        if self.pp_rank == 0:
            self.send_next(t)
            self.recv_last(t)
        else:
            self.recv_prev(t)
            t.add_(1)
            if self.pp_rank == self.pp - 1:
                self.send_first(t)
            else:
                self.send_next(t)
        if self.pp_rank == 0 and int(t.item()) != self.pp - 1:
            raise RuntimeError(
                f"pipeline ring warm-up carried {t.item()} around "
                f"{self.pp} stages"
            )

    def _warm_sp_ring(self) -> None:
        """Each sp rank's index once around the sp ring (``ring_shift``):
        NCCL builds its point-to-point links at their first use, which
        must not fall inside a graph capture."""
        dev = self.device if self.backend == "nccl" else "cpu"
        got = self.ring_shift(torch.full((1,), float(self.sp_rank),
                                         device=dev))
        if int(got.item()) != (self.sp_rank - 1) % self.sp:
            raise RuntimeError(
                f"sp ring warm-up carried {got.item()} to sp rank "
                f"{self.sp_rank} of {self.sp}"
            )

    def wait_for_followers(self, store: Any) -> None:
        """Rank 0: wait until every follower has reached the store (each
        sets ``joined<rank>`` before it joins the groups), raising as
        soon as one exits instead of waiting out the rendezvous."""
        keys = [f"joined{rank}" for rank in range(1, self.num_devices)]
        deadline = time.monotonic() + STORE_TIMEOUT.total_seconds()
        while not store.check(keys):
            for rank, proc in enumerate(self.followers, start=1):
                if proc.poll() is not None:
                    raise FollowerLostError(
                        f"mesh follower rank {rank} exited with code "
                        f"{proc.returncode} before joining the mesh"
                    )
            if time.monotonic() > deadline:
                raise FollowerLostError(
                    "mesh followers did not reach the store in "
                    f"{STORE_TIMEOUT.total_seconds():.0f} s"
                )
            time.sleep(0.05)

    def spawn_followers(self, config, port: int) -> None:
        """Rank 0: write the resolved config for the followers and start
        ranks 1..n-1 (``python -m vgate_tpu_torch.parallel.follower``)."""
        dump = dataclasses.asdict(config)
        fd, path = tempfile.mkstemp(prefix="vgt-tp-config-", suffix=".json")
        with os.fdopen(fd, "w") as fh:
            json.dump(dump, fh)
        self._config_path = path
        env = dict(os.environ)
        # the follower module must resolve THIS package whatever the cwd
        import vgate_tpu_torch as _pkg

        root = os.path.dirname(os.path.dirname(_pkg.__file__))
        paths = env.get("PYTHONPATH", "")
        if root not in paths.split(os.pathsep):
            env["PYTHONPATH"] = root + (os.pathsep + paths if paths else "")
        # faults armed for the engine process are not the followers'
        env.pop("VGT_FAULTS", None)
        env.pop("VGT_CHAOS", None)
        for rank in range(1, self.num_devices):
            cmd = [
                sys.executable, "-m", "vgate_tpu_torch.parallel.follower",
                "--config", path, "--rank", str(rank), "--port", str(port),
                "--devices", ",".join(self.devices),
            ]
            self.followers.append(subprocess.Popen(cmd, env=env))
        _LIVE.add(self)
        threading.Thread(
            target=self._monitor, name="vgt-tp-monitor", daemon=True
        ).start()


def build_mesh(config, devices: Optional[List[Any]] = None) -> Mesh:
    """Rank 0's mesh for the engine: resolve the plan against the device
    list (:func:`mesh_devices`), and with more than one rank build the
    kernels (on the
    card, before any follower starts, so no rank runs ``nvcc`` inside a
    collective's wait), start a ``TCPStore`` at a free localhost port,
    spawn the followers and join both groups (the counterpart of the
    reference's ``initialize_distributed``).  A follower that fails to
    start fails the build."""
    dcfg = config.device
    devs = mesh_devices(dcfg, devices)
    plan = resolve_plan(dcfg, len(devs))
    if plan.num_devices == 1:
        return Mesh(plan, devs)
    backend = device_backend(devs)
    mesh = Mesh(plan, devs, 0, backend)
    if mesh.device.type == "cuda":
        from vgate_tpu_torch.ops.kernels import _build

        _build.build()
    store = dist.TCPStore(
        "127.0.0.1", 0, plan.num_devices, True, timeout=STORE_TIMEOUT,
        wait_for_workers=False,
    )
    mesh.spawn_followers(config, store.port)
    try:
        mesh.wait_for_followers(store)
        mesh.join(store, config.recovery)
    except BaseException:
        mesh.shutdown(timeout=0.0)
        raise
    logger.info("mesh built", extra={"extra_data": {
        "shape": mesh.shape, "devices": devs, "backend": backend}})
    return mesh


def join_mesh(config, devices: List[str], rank: int, port: int) -> Mesh:
    """A follower's mesh: the same plan, this rank, both groups joined
    through rank 0's store."""
    plan = resolve_plan(config.device, len(devices))
    mesh = Mesh(plan, devices, rank, device_backend(devices))
    store = dist.TCPStore(
        "127.0.0.1", port, plan.num_devices, False, timeout=STORE_TIMEOUT
    )
    store.set(f"joined{rank}", "1")
    mesh.join(store, config.recovery)
    return mesh
