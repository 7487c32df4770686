"""The mesh compositions in the port (item 10d (rest), part 2) vs the JAX
package, on the CPU: a pipeline stage, or an sp rank, that is itself an
ep x tp group.

The port's ranks are processes (vgate_tpu_torch/parallel/), rank =
((pp index x ep + ep index) x sp + sp index) x tp + tp index; the JAX side
is the reference's mesh over the conftest's host devices (device order
dp, pp, ep, sp, tp), its sp functions through tests/test_torch_sp.py's
``reference_shard_map``.  Held here, in f32:

* each rank's tp, expert and sp groups (``axis_groups``) and its stage
  and ring peers are the reference device array's lines along the same
  axes (pp2 x tp2, pp2 x ep2, sp2 x tp2, sp2 x ep2 and the two three-axis
  meshes);
* a rank's leaves equal the reference's addressable shards at pp2 x tp2
  (tiny-dense, tiny-gemma2: stage 0's embedding and head vocab-parallel)
  and at pp2 x ep2 (tiny-moe, int8 weights);
* the ring prefill on a tp rank's heads over spawned ranks at sp2 x tp2
  (tests/sp_ranks.py) equals the reference's ring (heads replicated over
  tp) within 2e-5 (tests/test_ring_attention.py's), each pool shard the
  rank's kv heads of the pages it owns, and the groups ``join`` made are
  the reference mesh's lines;
* engines greedy token-identical to the JAX engine at the same mesh:
  tiny-dense and tiny-gemma2 at pp2 x tp2.

tests/test_torch_compose_sp.py holds the sp bodies, the sp x tp engine
and a follower SIGKILL at pp2 x tp2, tests/test_torch_compose_moe.py the
MoE engines at pp2 x ep2 and sp2 x ep2; the three share this file's
helpers.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from reference_uploads import private_uploads
from sp_ranks import run_ranks
from test_torch_pp import SPECS, _hf_state_dict, _jtree
from test_torch_sp import reference_shard_map  # noqa: F401  (the fixture)
from vgate_tpu.backends.base import SamplingParams as JSamplingParams
from vgate_tpu.config import load_config as j_load_config
from vgate_tpu.ops.quant import quantize_decoder_params as j_quantize
from vgate_tpu.parallel.mesh import build_mesh as j_build_mesh
from vgate_tpu.parallel.ring_attention import ring_prefill_attention as j_ring
from vgate_tpu.parallel.sharding import shard_params as j_shard_params
from vgate_tpu.parallel.sp_decode import reserved_page_ids as j_reserved
from vgate_tpu.runtime.engine_core import EngineCore as JEngineCore
from vgate_tpu_torch.backends.base import SamplingParams
from vgate_tpu_torch.config import load_config
from vgate_tpu_torch.parallel.mesh import (
    AXIS_EP,
    AXIS_SP,
    AXIS_TP,
    Mesh,
    MeshPlan,
    axis_groups,
)
from vgate_tpu_torch.parallel.sharding import STAGE0_LEAVES, shard_params
from vgate_tpu_torch.runtime.engine_core import EngineCore
from vgate_tpu_torch.runtime.weights import params_from_jax, quantize_params

SHAPES = {"kv_num_pages": 64, "kv_page_size": 4, "max_batch_slots": 4,
          "prefill_buckets": [8, 16, 32]}

TOL = 2e-5  # tests/test_ring_attention.py's
TP = 2
# (pp, ep, sp, tp)
MESHES = {"pp2xtp2": (2, 1, 1, 2), "pp2xep2": (2, 2, 1, 1),
          "sp2xtp2": (1, 1, 2, 2), "sp2xep2": (1, 2, 2, 1),
          "pp2xep2xtp2": (2, 2, 1, 2), "ep2xsp2xtp2": (1, 2, 2, 2)}


def j_mesh(pp, ep, sp, tp):
    """The reference's mesh of that shape over the first host devices."""
    n = pp * ep * sp * tp
    cfg = j_load_config(tpu={"dp": 1, "pp": pp, "ep": ep, "sp": sp,
                             "tp": tp, "num_devices": n}).tpu
    return j_build_mesh(cfg, devices=jax.devices()[:n])


def reference_lines(jmesh, rank):
    """The device ids of ``rank``'s device's lines in the reference's
    ``[dp, pp, ep, sp, tp]`` device array: along tp, along (ep, tp) and
    along sp, and its neighbours along pp and sp."""
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    [(_, p, e, s, t)] = np.argwhere(ids == jax.devices()[rank].id)
    pp, sp = ids.shape[1], ids.shape[3]
    return {
        "tp": sorted(ids[0, p, e, s, :].tolist()),
        "experts": sorted(ids[0, p, :, s, :].ravel().tolist()),
        "sp": sorted(ids[0, p, e, :, t].tolist()),
        "next_stage": int(ids[0, (p + 1) % pp, e, s, t]),
        "next_sp": int(ids[0, p, e, (s + 1) % sp, t]),
    }


def _member(groups, rank):
    [group] = [g for g in groups if rank in g]
    return group


@pytest.mark.parametrize("name", list(MESHES))
def test_groups_and_peers_are_the_reference_mesh_lines(name):
    """Each rank's tp group (tp index only), expert group (ep and tp
    indices) and sp group (sp index only), and its next stage's and next
    sp index's rank, are its device's lines in the reference mesh."""
    pp, ep, sp, tp = MESHES[name]
    n = pp * ep * sp * tp
    jmesh = j_mesh(pp, ep, sp, tp)
    plan = MeshPlan(1, pp, ep, sp, tp)
    # the host devices' ids are their ranks
    assert [d.id for d in jax.devices()[:n]] == list(range(n))
    for rank in range(n):
        mesh = Mesh(plan, ["cpu"] * n, rank)
        want = reference_lines(jmesh, rank)
        assert _member(axis_groups(plan, (AXIS_TP,)), rank) == want["tp"]
        assert _member(axis_groups(plan, (AXIS_EP, AXIS_TP)),
                       rank) == want["experts"]
        assert _member(axis_groups(plan, (AXIS_SP,)), rank) == want["sp"]
        assert mesh.stage_rank(mesh.pp_rank + 1) == want["next_stage"]
        assert mesh.sp_peer(mesh.sp_rank + 1) == want["next_sp"]


def _heads(x, axis, t):
    """Tp rank ``t``'s part of ``x``'s head axis ``axis`` at tp 2."""
    n = x.shape[axis] // TP
    return np.take(x, range(t * n, (t + 1) * n), axis=axis)


def test_ring_on_a_tp_ranks_heads_matches_reference():
    """Each (sp, tp) rank's rows and heads of the port's ring equal the
    reference's ring over sp2 x tp2 (real rows compared), each rank's
    pool shard holds its kv heads of the pages it owns, and every rank's
    groups are its device's lines in the reference mesh."""
    rng = np.random.default_rng(5)
    B, S, H, KV, hd, ps, P = 2, 32, 8, 2, 16, 4, 32
    q = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    k, v = (rng.normal(size=(B, S, KV, hd)).astype(np.float32)
            for _ in range(2))
    lens = np.array([32, 19], np.int32)
    reserved = set(j_reserved(P, 2))
    free = [p for p in range(1, P) if p not in reserved]
    pt = np.asarray(rng.permutation(free)[:B * S // ps],
                    np.int32).reshape(B, S // ps)
    jmesh = j_mesh(*MESHES["sp2xtp2"])
    want = np.asarray(j_ring(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(lens), jmesh,
                             window=jnp.asarray(8, jnp.int32), softcap=30.0,
                             scale=0.3))
    case = {"q": q, "k": k, "v": v, "lens": lens, "window": 8,
            "softcap": 30.0, "scale": 0.3, "page_tables": pt,
            "pool_shape": (KV, P, ps, hd)}
    ranks = run_ranks(2, "ring", [case], tp=TP)
    k_pool = np.zeros((KV, P, ps, hd), np.float32)
    v_pool = np.zeros_like(k_pool)
    for b in range(B):
        for s in range(S):
            k_pool[:, pt[b, s // ps], s % ps] = k[b, s]
            v_pool[:, pt[b, s // ps], s % ps] = v[b, s]
    n, shard = S // 2, P // 2
    for rank, [(out, kr, vr)] in enumerate(ranks):
        s, t = divmod(rank, TP)
        mine = _heads(want[:, s * n:(s + 1) * n], 2, t)
        for b in range(B):
            real = max(0, min(n, lens[b] - s * n))
            np.testing.assert_allclose(out[b, :real], mine[b, :real],
                                       rtol=TOL, atol=TOL)
        for got, pool in ((kr, k_pool), (vr, v_pool)):
            np.testing.assert_array_equal(
                got, _heads(pool, 0, t)[:, s * shard:(s + 1) * shard])
    for rank, [groups] in enumerate(run_ranks(2, "groups", [None], tp=TP)):
        lines = reference_lines(jmesh, rank)
        assert groups == {"tp": lines["tp"], "experts": lines["experts"],
                          "sp": lines["sp"]}


# ------------------------------------------------------------- leaves


LEAF_CASES = [("tiny-dense", "pp2xtp2", None),
              ("tiny-gemma2", "pp2xtp2", None),
              ("tiny-moe", "pp2xep2", "int8")]


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """{name: (JAX tree, numpy tree, checkpoint dir)} from one draw."""
    from safetensors.torch import save_file

    from pp_ranks import np_copy

    out = {}
    for name, (jspec, spec) in SPECS.items():
        jtree = _jtree(jspec)
        np_tree = np_copy(jax.tree.map(np.asarray, jtree))
        path = tmp_path_factory.mktemp(name)
        save_file(_hf_state_dict(np_tree, spec),
                  str(path / "model.safetensors"))
        out[name] = (jtree, np_tree, str(path))
    return out


@pytest.mark.parametrize("name,mesh_name,quantization", LEAF_CASES,
                         ids=[f"{n}-{m}-{q or 'plain'}"
                              for n, m, q in LEAF_CASES])
def test_rank_leaves_equal_the_reference_addressable_shards(
        models, name, mesh_name, quantization):
    """Every rank's leaves are exactly the reference's shard on that
    rank's device (placed, then quantized, as the reference does): its
    stage's layers, then its tp heads and FFN channels or its ep
    experts; stage 0's embedding and head vocab-parallel over its tp
    group, and past stage 0 none of them."""
    jspec, spec = SPECS[name]
    jtree, np_tree, _ = models[name]
    pp, ep, sp, tp = MESHES[mesh_name]
    n = pp * ep * sp * tp
    jmesh = j_mesh(pp, ep, sp, tp)
    placed = j_shard_params(jtree, jspec, jmesh)
    if quantization:
        placed = j_quantize(placed, jspec, bits=int(quantization[3:]))
    flat_ref = jax.tree_util.tree_flatten_with_path(placed)[0]
    cut = 0
    for rank in range(n):
        tree = params_from_jax(np_tree, spec)
        if quantization:
            tree = quantize_params(tree, spec, quantization)
        mesh = Mesh(MeshPlan(1, pp, ep, sp, tp), ["cpu"] * n, rank)
        tree = shard_params(tree, spec, mesh)
        stage0 = mesh.pp_rank == 0
        for path, leaf in flat_ref:
            what = f"rank {rank} {jax.tree_util.keystr(path)}"
            if path[0].key in STAGE0_LEAVES:
                assert (path[0].key in tree) == stage0, what
                if not stage0:
                    continue
            node = tree
            for key in path:
                node = (getattr(node, key.name) if hasattr(key, "name")
                        else node[key.key])
            [shard] = [s for s in leaf.addressable_shards
                       if s.device == jax.devices()[rank]]
            want = np.asarray(shard.data)
            assert tuple(node.shape) == want.shape, what
            np.testing.assert_array_equal(node.numpy(), want, err_msg=what)
            cut += want.shape != leaf.shape
    assert cut > 0


# ------------------------------------------------------------- engines


def _config(name, ckpt, device, **sections):
    return load_config(
        model={"model_id": name, "engine_type": "torch_cuda",
               "dtype": "float32", "max_model_len": 96,
               "checkpoint_path": ckpt, **sections.pop("model", {})},
        device={"device": "cpu", **SHAPES, "prefix_cache": {"enabled": True},
                **device},
        scheduler={"max_queue_size": 32},
        recovery={"backoff_base_s": 0.05, "backoff_cap_s": 0.5},
        logging={"level": "ERROR"},
        **sections,
    )


def _ticked(core, prompts, params):
    seqs = [core.submit_tokens(list(p), params) for p in prompts]
    for _ in range(20_000):
        if all(s.done_event.is_set() for s in seqs):
            break
        core._tick()
    assert all(s.done_event.is_set() for s in seqs)
    assert all(s.error is None for s in seqs), [s.error for s in seqs]
    return [list(s.generated_ids) for s in seqs]


def engine_pair(models, name, mesh_name, chunk=0, quantization=None):
    """The JAX engine and the port's at ``mesh_name`` on one tree."""
    pp, ep, sp, tp = MESHES[mesh_name]
    n = pp * ep * sp * tp
    jtree, np_tree, ckpt = models[name]
    axes = {"pp": pp, "ep": ep, "sp": sp, "tp": tp}
    model = {"quantization": quantization}
    j = JEngineCore(
        j_load_config(
            model={"model_id": name, "engine_type": "jax_tpu",
                   "dtype": "float32", "max_model_len": 96, **model},
            tpu={"dp": 1, **axes, "num_devices": n, "use_pallas": False,
                 "prefill_chunk": chunk, **SHAPES},
            scheduler={"max_queue_size": 32}, integrity={"enabled": False},
            logging={"level": "ERROR"},
        ),
        params=jtree, devices=jax.devices()[:n],
    )
    try:
        t = EngineCore(_config(name, ckpt, {**axes, "prefill_chunk": chunk},
                               model=model),
                       params=params_from_jax(np_tree, SPECS[name][1]))
    except BaseException:
        j.stop()
        raise
    return j, t


def run_waves(j, t, waves, tokens=12):
    greedy = dict(max_tokens=tokens, temperature=0.0)
    for prompts in waves:
        with private_uploads():
            want = _ticked(j, prompts, JSamplingParams(**greedy))
        got = _ticked(t, prompts, SamplingParams(**greedy))
        assert got == want


def check_ranks(t, j, n):
    """Every follower ran rank 0's steps and passes on its own pool,
    whose trash page 0 stayed zeros; the mesh block is the reference's
    plus the backend."""
    ts = t.get_stats()
    mesh = dict(ts["mesh"])
    assert mesh.pop("backend") == "gloo"
    assert mesh == j.get_stats()["mesh"]
    assert ts["running"] == 0
    assert not t.k_pages[:, :, 0].any()
    stats = t.follower_stats()
    assert len(stats) == n - 1
    for f in stats:
        assert (f["steps"], f["prompt_passes"]) == (ts["steps"],
                                                    ts["prompt_passes"])
        assert f["memory"]["trash_page_zero"]
    return ts, stats


def check_pp_engine(models, name, mesh_name, quantization=None):
    """Two waves, 12 greedy tokens each (a two-row prompt pass, M = 2;
    every decode step M = 2 of the 4 slots; tiny-gemma2's prompts past
    its window of 8): the port's streams at a pp x tp or pp x ep mesh
    equal the JAX engine's at the same mesh, both with the prefix cache
    off as pp forces it.  Stage 1's ranks hold layers only; a tp rank's
    pool holds its kv heads of its stage's layers."""
    spec = SPECS[name][1]
    pp, ep, sp, tp = MESHES[mesh_name]
    j, t = engine_pair(models, name, mesh_name, quantization=quantization)
    try:
        assert not t.prefix_cache_enabled and not j.prefix_cache_enabled
        assert tuple(t.k_pages.shape[:2]) == (spec.num_layers // pp,
                                              spec.num_kv_heads // tp)
        rng = np.random.default_rng(31)
        waves = [[rng.integers(3, spec.vocab_size, size=k).tolist()
                  for k in lengths] for lengths in ((5, 7, 14, 20),
                                                    (6, 11, 9))]
        run_waves(j, t, waves)
        _, stats = check_ranks(t, j, pp * ep * sp * tp)
        for rank, f in enumerate(stats, start=1):
            stage0 = rank < ep * sp * tp
            assert ("embed" in f["memory"]["leaves"]) == stage0
    finally:
        j.stop()
        t.close()


@pytest.mark.parametrize("name", ["tiny-dense", "tiny-gemma2"])
def test_pp2xtp2_engine_token_identical_to_jax(models, name):
    """``check_pp_engine`` at pp2 x tp2 (tiny-moe at pp2 x ep2: tests/
    test_torch_compose_moe.py)."""
    check_pp_engine(models, name, "pp2xtp2")
