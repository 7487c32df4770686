"""sp x tp and sp x ep in the port (item 10d (rest), part 2) vs the JAX
package, on the CPU: an sp rank that is itself an ep x tp group.  The
pp compositions, the mesh lines, the leaves and the ring are in tests/
test_torch_compose.py, whose engine pair this file shares.  Held here, in
f32:

* the three write-and-attend bodies on a tp rank's heads, over spawned
  ranks at sp2 x tp2 (tests/sp_ranks.py), against the reference's shard
  bodies with ``tp_ax`` set (the suffix body's replicated over tp: with
  ``tp_ax`` set it raises, a reference fault), within 2e-5 (tests/
  test_ring_attention.py's); each pool shard holds the rank's kv heads
  of its pages, its trash page 0 zeros (the ring is in tests/
  test_torch_compose.py);
* an engine greedy token-identical to the JAX engine at the same mesh:
  tiny-dense at sp2 x tp2 with the prefix cache and chunked prefill
  (ring passes, hits through the sp suffix pass, a chunked prompt);
  tests/test_torch_compose_moe.py runs the same check on tiny-moe at sp2
  x ep2;
* a follower SIGKILLed mid-stream at pp2 x tp2: the supervisor rebuilds
  the four ranks and every stream resumes to a clean run's (here to
  even out the files' times).
"""

import os
import signal
import time
from unittest import mock

import numpy as np
import pytest

import jax.numpy as jnp

from sp_ranks import run_ranks
from test_torch_compose import (
    MESHES,
    SPECS,
    TP,
    _config,
    _heads,
    check_ranks,
    engine_pair,
    j_mesh,
    models,  # noqa: F401  (the fixture)
    run_waves,
)
from test_torch_sp import (  # noqa: F401  (the fixture)
    _and_write_cases,
    reference_shard_map,
)
from vgate_tpu.parallel.sp_decode import reserved_page_ids as j_reserved
from vgate_tpu_torch.backends.base import SamplingParams
from vgate_tpu_torch.runtime.supervisor import EngineSupervisor, HealthState

TOL = 2e-5  # tests/test_ring_attention.py's
SP = 2


@pytest.fixture(scope="module", autouse=True)
def reference_suffix_heads_replicated():
    """The reference's ``sp_suffix_attention_and_write`` with its shard
    body run on every head (``_tp_axis`` None: the specs replicate over
    tp, the reference's own path for heads tp does not divide).  With
    ``tp_ax`` set its body reshapes a tp shard's ``KV/tp`` key heads by
    the global ``KV`` and raises (a reference fault, ROADMAP queue 3), so
    the JAX engine fails its first suffix pass at sp x tp.  The decode
    and verify bodies keep ``tp_ax``.  The JAX package is not edited:
    the reference's decoder imports the name at each call."""
    from vgate_tpu.parallel import sp_decode

    real = sp_decode.sp_suffix_attention_and_write

    def suffix(*args, **kwargs):
        with mock.patch.object(sp_decode, "_tp_axis", lambda *a: None):
            return real(*args, **kwargs)

    sp_decode.sp_suffix_attention_and_write = suffix
    yield
    sp_decode.sp_suffix_attention_and_write = real


def test_and_write_bodies_on_a_tp_ranks_heads_match_reference():
    """``sp_decode_attention_and_write``, ``sp_suffix_attention_and_write``
    and ``sp_multitok_attention_and_write`` on each rank's pool shard and
    tp heads: the output is the reference's on those heads (its decode
    and verify bodies run per (sp, tp) shard, ``tp_ax`` set; the suffix
    body on every head, the fixture above), and the shard the
    reference's on every page but trash page 0, zeros in the port."""
    P = 64
    kw = dict(window=6, softcap=30.0, scale=0.3)
    cases, wants = _and_write_cases(np.random.default_rng(23), P, SP, kw,
                                    mesh=j_mesh(*MESHES["sp2xtp2"]))
    ranks = run_ranks(SP, "and_write", cases, tp=TP)
    shard = P // SP
    for i, (case, (w_out, w_k, w_v)) in enumerate(zip(cases, wants)):
        for rank, results in enumerate(ranks):
            s, t = divmod(rank, TP)
            out, kr, vr = results[i]
            w = np.asarray(w_out)
            np.testing.assert_allclose(out, _heads(w, w.ndim - 2, t),
                                       rtol=TOL, atol=TOL,
                                       err_msg=case["fn"])
            for got, want in ((kr, w_k), (vr, w_v)):
                want = _heads(np.asarray(want), 0, t)[
                    :, s * shard:(s + 1) * shard]
                np.testing.assert_array_equal(got[:, 1:], want[:, 1:])
                assert not got[:, 0].any(), (case["fn"], rank)


def check_sp_engine(models, name, mesh_name, chunk=0):
    """Greedy waves, the same on both engines at the same mesh: cold
    prompts (ring passes), the same prompts again (prefix hits through
    the sp suffix pass) and, with ``chunk``, a prompt past it (chunked
    prefill).  Both reserve the same trash pages; every rank holds its
    kv heads of its shard of the pages and ran every step and pass."""
    spec = SPECS[name][1]
    pp, ep, sp, tp = MESHES[mesh_name]
    j, t = engine_pair(models, name, mesh_name, chunk=chunk)
    try:
        assert t.allocator.reserved == j.allocator.reserved == frozenset(
            j_reserved(64, sp))
        assert tuple(t.k_pages.shape[1:3]) == (spec.num_kv_heads // tp,
                                               64 // sp)
        rng = np.random.default_rng(41)
        cold = [rng.integers(3, spec.vocab_size, size=k).tolist()
                for k in (5, 14, 27)]
        waves = [cold, cold[1:]]
        if chunk:
            waves.append([rng.integers(3, spec.vocab_size,
                                       size=50).tolist()])
        run_waves(j, t, waves, tokens=16)
        ts, stats = check_ranks(t, j, pp * ep * sp * tp)
        assert ts["prefix_cache"]["hit_tokens"] > 0
        if chunk:
            assert ts["prefix_cache"]["chunk_passes"] > 0
        assert all(f["memory"]["pool_pages"] == 64 for f in stats)
    finally:
        j.stop()
        t.close()


def test_sp2xtp2_engine_with_hits_and_chunks_token_identical_to_jax(
        models):
    """``check_sp_engine`` at sp2 x tp2, prefill_chunk 32 (tiny-moe at
    sp2 x ep2: tests/test_torch_compose_moe.py)."""
    check_sp_engine(models, "tiny-dense", "sp2xtp2", chunk=32)


def _wait(seqs, timeout=120.0):
    deadline = time.monotonic() + timeout
    for s in seqs:
        assert s.done_event.wait(max(0.1, deadline - time.monotonic()))
        assert s.error is None, s.error
    return [list(s.generated_ids) for s in seqs]


def test_follower_sigkill_at_pp2xtp2_rebuilds_and_resumes(models):
    """Rank 3 (stage 1, tp index 1) SIGKILLed once every stream has 3
    tokens: the next collective raises, the supervisor contains the crash
    and rebuilds all four ranks, and every stream resumes to a clean
    run's."""
    _, _, ckpt = models["tiny-dense"]
    rng = np.random.default_rng(17)
    prompts = [rng.integers(3, 500, size=k).tolist() for k in (6, 9, 11)]
    params = SamplingParams(max_tokens=12, temperature=0.0)
    sup = EngineSupervisor(_config("tiny-dense", ckpt, {"pp": 2, "tp": 2}))
    sup.start()
    old_followers = list(sup.core.mesh.followers)
    try:
        clean = _wait([sup.submit_tokens(list(p), params) for p in prompts])
        old = sup.core
        victim = old.mesh.followers[2]
        seqs = [sup.submit_tokens(list(p), params) for p in prompts]
        deadline = time.monotonic() + 60
        while not all(len(s.generated_ids) >= 3 for s in seqs):
            assert time.monotonic() < deadline
            time.sleep(0.001)
        os.kill(victim.pid, signal.SIGKILL)
        assert _wait(seqs) == clean
        deadline = time.monotonic() + 60
        while sup.core is old or sup.state not in (HealthState.DEGRADED,
                                                   HealthState.SERVING):
            assert time.monotonic() < deadline
            time.sleep(0.01)
        health = sup.health()
        assert health["restarts"] == 1 and health["lost"] == 0
        assert health["resumed"] >= 1
        new = sup.core
        assert new.mesh is not old.mesh and new.mesh.healthy()
        assert len(new.mesh.followers) == 3
        assert new.spec.pipeline is new.mesh and new.spec.mesh is new.mesh
        assert _wait([sup.submit_tokens(list(p), params)
                      for p in prompts]) == clean
    finally:
        followers = old_followers + list(sup.core.mesh.followers)
        sup.close()
        for proc in followers:
            proc.wait(30)
