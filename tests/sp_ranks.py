"""The ranks of a sequence-parallel group as processes of their own, for
tests/test_torch_sp.py.

:func:`run_ranks` spawns one process a rank; each joins a gloo group
through a store the caller's process serves (parallel/mesh.py, sp ranks
at tp = ep = pp = 1), runs one of the port's sp functions on its part of
the inputs and returns what it computed.  This module imports torch and
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


def ring(mesh, case):
    """This rank's rows of ``ring_prefill_attention`` over the case's
    whole ``q``/``k``/``v`` ``[B, S, *, hd]``, writing the prompt's pages
    into its shard of ``pool`` zeros ``[KV, P, ps, hd]`` through
    ``page_tables``; returns (its output rows, its K and V shards)."""
    r, sp = mesh.sp_rank, mesh.sp
    S = case["q"].shape[1]
    n = S // sp
    rows = slice(r * n, (r + 1) * n)
    KV, P, ps, hd = case["pool_shape"]
    shard = P // sp
    k_pool = torch.zeros(KV, shard, ps, hd)
    v_pool = torch.zeros(KV, shard, ps, hd)
    out = ring_prefill_attention(
        _t(case["q"][:, rows]), _t(case["k"][:, rows]),
        _t(case["v"][:, rows]), _t(case["lens"]), mesh,
        window=case["window"], softcap=case["softcap"], scale=case["scale"],
        pools=(k_pool, v_pool, _t(case["page_tables"])))
    return out.numpy(), k_pool.numpy(), v_pool.numpy()


AND_WRITE = {"decode": sp_decode_attention_and_write,
             "suffix": sp_suffix_attention_and_write,
             "multitok": sp_multitok_attention_and_write}


def and_write(mesh, case):
    """One of the ``*_attention_and_write`` functions (``case["fn"]``) on
    this rank's shard of the case's global pools; returns (its output,
    its K and V shards after the write)."""
    r, sp = mesh.sp_rank, mesh.sp
    P = case["k_pages"].shape[1]
    shard = slice(r * P // sp, (r + 1) * P // sp)
    k_pool = _t(case["k_pages"][:, shard].copy())
    v_pool = _t(case["v_pages"][:, shard].copy())
    args = [_t(a) for a in case["args"]]
    out = AND_WRITE[case["fn"]](
        *args[:3], k_pool, v_pool, *args[3:], mesh,
        window=case["window"], softcap=case["softcap"], scale=case["scale"])
    return out.numpy(), k_pool.numpy(), v_pool.numpy()


TASKS = {"ring": ring, "and_write": and_write}


def rank_main(rank, sp, port, task, cases, out) -> None:
    """Rank ``rank`` of ``sp``: ``TASKS[task]`` on every case; puts
    ``(rank, results)`` on ``out``."""
    mesh = Mesh(MeshPlan(1, 1, 1, sp, 1), ["cpu"] * sp, rank, "gloo")
    store = dist.TCPStore("127.0.0.1", port, sp + 1, False, timeout=TIMEOUT)
    try:
        mesh.join(store, RECOVERY)
        with torch.no_grad():
            out.put((rank, [TASKS[task](mesh, case) for case in cases]))
    finally:
        mesh.shutdown()


def run_ranks(sp, task, cases):
    """Every rank's results, in rank order."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    store = dist.TCPStore("127.0.0.1", 0, sp + 1, True, timeout=TIMEOUT,
                          wait_for_workers=False)
    out = ctx.Queue()
    procs = [ctx.Process(target=rank_main,
                         args=(rank, sp, store.port, task, cases, out))
             for rank in range(sp)]
    for proc in procs:
        proc.start()
    try:
        got = dict(out.get(timeout=TIMEOUT.total_seconds())
                   for _ in range(sp))
    finally:
        for proc in procs:
            proc.join(30)
            if proc.is_alive():
                proc.kill()
    assert all(proc.exitcode == 0 for proc in procs), [
        proc.exitcode for proc in procs]
    return [got[r] for r in range(sp)]
