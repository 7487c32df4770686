"""The ranks of a sequence-parallel group as processes of their own, for
tests/test_torch_sp.py.

:func:`run_ranks` spawns one process a rank; each joins a gloo group
through a store the caller's process serves (parallel/mesh.py, sp x tp
ranks), runs one of the port's sp functions on its part of the inputs
(its sp index's rows or pages, its tp index's heads) and returns what it
computed.  This module imports torch and
the port only: a spawned child imports it, not the test module and its
JAX.
"""

import datetime
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist

from vgate_tpu_torch.parallel.mesh import Mesh, MeshPlan
from vgate_tpu_torch.parallel.ring_attention import ring_prefill_attention
from vgate_tpu_torch.parallel.sp_decode import (
    sp_decode_attention_and_write,
    sp_multitok_attention_and_write,
    sp_suffix_attention_and_write,
)

TIMEOUT = datetime.timedelta(seconds=120)
# the device group's timeout (parallel/mesh.py device_group_timeout)
RECOVERY = SimpleNamespace(step_stall_s=60.0, compile_grace_s=60.0)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _heads(mesh, x, axis):
    """This rank's tp part of ``x``'s head axis ``axis``."""
    n = x.shape[axis] // mesh.tp
    idx = [slice(None)] * x.ndim
    idx[axis] = slice(mesh.tp_rank * n, (mesh.tp_rank + 1) * n)
    return x[tuple(idx)]


def ring(mesh, case):
    """This rank's rows and tp heads of ``ring_prefill_attention`` over
    the case's whole ``q``/``k``/``v`` ``[B, S, *, hd]``, writing the
    prompt's pages into its shard of ``pool`` zeros ``[KV, P, ps, hd]``
    (its kv heads) through ``page_tables``; returns (its output, its K
    and V shards)."""
    r, sp = mesh.sp_rank, mesh.sp
    S = case["q"].shape[1]
    n = S // sp
    rows = slice(r * n, (r + 1) * n)
    KV, P, ps, hd = case["pool_shape"]
    shard = P // sp
    k_pool = torch.zeros(KV // mesh.tp, shard, ps, hd)
    v_pool = torch.zeros(KV // mesh.tp, shard, ps, hd)
    out = ring_prefill_attention(
        _t(_heads(mesh, case["q"][:, rows], 2)),
        _t(_heads(mesh, case["k"][:, rows], 2)),
        _t(_heads(mesh, case["v"][:, rows], 2)), _t(case["lens"]), mesh,
        window=case["window"], softcap=case["softcap"], scale=case["scale"],
        pools=(k_pool, v_pool, _t(case["page_tables"])))
    return out.numpy(), k_pool.numpy(), v_pool.numpy()


AND_WRITE = {"decode": sp_decode_attention_and_write,
             "suffix": sp_suffix_attention_and_write,
             "multitok": sp_multitok_attention_and_write}


def and_write(mesh, case):
    """One of the ``*_attention_and_write`` functions (``case["fn"]``) on
    this rank's shard of the case's global pools and its tp heads;
    returns (its output, its K and V shards after the write)."""
    r, sp = mesh.sp_rank, mesh.sp
    P = case["k_pages"].shape[1]
    shard = slice(r * P // sp, (r + 1) * P // sp)
    k_pool = _t(_heads(mesh, case["k_pages"], 0)[:, shard].copy())
    v_pool = _t(_heads(mesh, case["v_pages"], 0)[:, shard].copy())
    # q, k and v carry their heads second to last
    args = [_t(_heads(mesh, a, a.ndim - 2)) if i < 3 else _t(a)
            for i, a in enumerate(case["args"])]
    out = AND_WRITE[case["fn"]](
        *args[:3], k_pool, v_pool, *args[3:], mesh,
        window=case["window"], softcap=case["softcap"], scale=case["scale"])
    return out.numpy(), k_pool.numpy(), v_pool.numpy()


def groups(mesh, case):
    """The ranks of this rank's tp, expert and sp groups as ``join`` made
    them (None: a group the mesh does not make)."""
    return {name: None if g is None else dist.get_process_group_ranks(g)
            for name, g in (("tp", mesh.tp_group),
                            ("experts", mesh.expert_group),
                            ("sp", mesh.sp_group))}


TASKS = {"ring": ring, "and_write": and_write, "groups": groups}


def rank_main(rank, sp, port, task, cases, out, tp=1) -> None:
    """Rank ``rank`` of ``sp x tp``: ``TASKS[task]`` on every case; puts
    ``(rank, results)`` on ``out``."""
    n = sp * tp
    mesh = Mesh(MeshPlan(1, 1, 1, sp, tp), ["cpu"] * n, rank, "gloo")
    store = dist.TCPStore("127.0.0.1", port, n + 1, False, timeout=TIMEOUT)
    try:
        mesh.join(store, RECOVERY)
        with torch.no_grad():
            out.put((rank, [TASKS[task](mesh, case) for case in cases]))
    finally:
        mesh.shutdown()


def run_ranks(sp, task, cases, tp=1):
    """Every rank's results, in rank order."""
    import multiprocessing as mp

    n = sp * tp
    ctx = mp.get_context("spawn")
    store = dist.TCPStore("127.0.0.1", 0, n + 1, True, timeout=TIMEOUT,
                          wait_for_workers=False)
    out = ctx.Queue()
    procs = [ctx.Process(target=rank_main,
                         args=(rank, sp, store.port, task, cases, out, tp))
             for rank in range(n)]
    for proc in procs:
        proc.start()
    try:
        got = dict(out.get(timeout=TIMEOUT.total_seconds())
                   for _ in range(n))
    finally:
        for proc in procs:
            proc.join(30)
            if proc.is_alive():
                proc.kill()
    assert all(proc.exitcode == 0 for proc in procs), [
        proc.exitcode for proc in procs]
    return [got[r] for r in range(n)]
