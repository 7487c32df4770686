"""The stages of a pipeline group as processes of their own, for
tests/test_torch_pp.py.

:func:`run_stages` spawns one process a stage; each joins a gloo group
through a store the caller's process serves, keeps its stage of a tree
(parallel/sharding.py ``shard_params``), runs the port's prompt pass and
one decode step through the relay on its own pools, and returns what it
computed.  This module imports torch and the port only: a spawned child
imports it, not the test module and its JAX.
"""

import datetime
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist

from vgate_tpu_torch.models.decoder import decode_forward, prefill_forward
from vgate_tpu_torch.parallel.mesh import Mesh, MeshPlan
from vgate_tpu_torch.parallel.sharding import local_spec, shard_params
from vgate_tpu_torch.runtime.weights import params_from_jax

TIMEOUT = datetime.timedelta(seconds=120)
# the device group's timeout (parallel/mesh.py device_group_timeout)
RECOVERY = SimpleNamespace(step_stall_s=60.0, compile_grace_s=60.0)


def stage(rank, pp, port, spec, np_tree, cases, out) -> None:
    """Stage ``rank`` of ``pp``: for each case (``tokens`` [B, S],
    ``lens``, ``prefill_pt``, then the decode step's ``next`` tokens at
    positions ``lens`` over tables ``pt``, every row active, on a pool of
    ``num_pages`` pages of ``ps``), the stage-0 logits of both forwards
    (None on the other stages) and the stage's pools.  Puts ``(rank,
    results, the stage's leaf names, its windows)`` on ``out``."""
    mesh = Mesh(MeshPlan(1, pp, 1, 1, 1), ["cpu"] * pp, rank, "gloo")
    store = dist.TCPStore("127.0.0.1", port, pp + 1, False, timeout=TIMEOUT)
    try:
        mesh.join(store, RECOVERY)
        lspec = local_spec(spec, 1, mesh)
        params = shard_params(params_from_jax(np_tree, spec), spec, mesh)
        results = []
        t = torch.from_numpy
        for case in cases:
            B = case["tokens"].shape[0]
            shape = (lspec.num_layers, spec.num_kv_heads, case["num_pages"],
                     case["ps"], spec.head_dim)
            k, v = torch.zeros(shape), torch.zeros(shape)
            prompt = prefill_forward(params, lspec, t(case["tokens"]),
                                     t(case["lens"]), k, v,
                                     t(case["prefill_pt"]))
            step = decode_forward(params, lspec, t(case["next"]),
                                  t(case["lens"]), k, v, t(case["pt"]),
                                  active=torch.ones(B, dtype=torch.bool))
            results.append({
                "prefill": None if prompt is None else prompt.numpy(),
                "decode": None if step is None else step.numpy(),
                "k": k.numpy(), "v": v.numpy()})
        out.put((rank, results, sorted(params), lspec.layer_windows))
    finally:
        mesh.shutdown()


def run_stages(spec, np_tree, pp, cases):
    """Every stage's ``stage`` output, in stage order."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    store = dist.TCPStore("127.0.0.1", 0, pp + 1, True, timeout=TIMEOUT,
                          wait_for_workers=False)
    out = ctx.Queue()
    procs = [ctx.Process(target=stage, args=(rank, pp, store.port, spec,
                                             np_tree, cases, out))
             for rank in range(pp)]
    for proc in procs:
        proc.start()
    try:
        got = dict((r, rest) for r, *rest in
                   (out.get(timeout=TIMEOUT.total_seconds())
                    for _ in range(pp)))
    finally:
        for proc in procs:
            proc.join(30)
            if proc.is_alive():
                proc.kill()
    assert all(proc.exitcode == 0 for proc in procs), [
        proc.exitcode for proc in procs]
    return [got[r] for r in range(pp)]


def np_copy(tree):
    """A tree of numpy arrays, every leaf a plain C-ordered copy."""
    if isinstance(tree, dict):
        return {k: np_copy(v) for k, v in tree.items()}
    return np.array(tree, order="C")
