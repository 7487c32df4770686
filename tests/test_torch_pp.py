"""Pipeline parallelism in the port (item 10d, first part) vs the JAX
package, on the CPU.

The port's pp group is processes (vgate_tpu_torch/parallel/): at tp = ep
= 1 rank s is stage s, holding layers ``[s*L/pp, (s+1)*L/pp)`` and their
pools; stage 0 also holds the embedding and the head.  The JAX side is
the reference's relay over the conftest's host devices, its pp mesh
built as tests/test_pipeline.py builds it (``tiny_spec`` deepening a
model where pp needs more layers).  Held here, in f32:

* the rank order (rank = (pp index x ep + ep index) x tp + tp index) is
  the reference mesh's device order, ``pp_rank``, ``ep_rank`` and
  ``tp_rank`` included;
* each stage's leaves equal the reference's addressable shards on the
  stage's device, plain and quantized; stage 0 alone holds the
  embedding, final norm and head (a deliberate difference: the
  reference replicates them);
* the prompt pass then one decode step across 2 and 4 processes
  (tests/pp_ranks.py) equal the JAX relay's logits and written KV within
  2e-4 (tests/test_pipeline.py's bound), B = 4 (M = pp microbatches) and
  B = 3 (M = 1), for tiny-dense, tiny-gemma2 (prompts past its window of
  8, so a stage that took local-index windows fails) and tiny-moe; trash
  page 0 stays zeros on every stage (the reference writes its bubble
  steps there; the port runs no bubble step);
* a stage's spec takes its global layers' windows (Gemma-2-9B at pp 2);
* pp=2 engines are greedy token-identical to the JAX engine at pp=2 for
  tiny-dense, tiny-gemma2, tiny-moe and int8-weight tiny-dense, with
  the reference's roofline constants and mesh block, the prefix cache
  off as the reference forces it, and every follower in step;
* a stage-1 follower SIGKILLed mid-stream: the supervisor rebuilds the
  group and every stream resumes to a clean run's; a fault on stage 0
  rebuilds with the same follower, its layers kept; no follower
  outlives the backend's shutdown.
"""

import dataclasses
import os
import signal
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pp_ranks import np_copy, run_stages
from reference_uploads import private_uploads
from vgate_tpu.backends.base import SamplingParams as JSamplingParams
from vgate_tpu.config import load_config as j_load_config
from vgate_tpu.models import decoder as jdec
from vgate_tpu.models.specs import TINY_DENSE as J_DENSE
from vgate_tpu.models.specs import TINY_GEMMA2 as J_GEMMA2
from vgate_tpu.models.specs import TINY_MOE as J_MOE
from vgate_tpu.ops.quant import quantize_decoder_params as j_quantize
from vgate_tpu.parallel.mesh import build_mesh as j_build_mesh
from vgate_tpu.parallel.sharding import kv_pspec, named
from vgate_tpu.parallel.sharding import shard_params as j_shard_params
from vgate_tpu.runtime.engine_core import EngineCore as JEngineCore
from vgate_tpu_torch.backends.base import SamplingParams
from vgate_tpu_torch.config import load_config
from vgate_tpu_torch.models.specs import (
    TINY_DENSE,
    TINY_GEMMA2,
    TINY_MOE,
    spec_for_model_id,
)
from vgate_tpu_torch.parallel.mesh import Mesh, MeshPlan
from vgate_tpu_torch.parallel.sharding import local_spec, shard_params
from vgate_tpu_torch.runtime.engine_core import EngineCore
from vgate_tpu_torch.runtime.supervisor import EngineSupervisor, HealthState
from vgate_tpu_torch.runtime.weights import params_from_jax, quantize_params

TOL = 2e-4  # tests/test_pipeline.py's relay bound
PS = 4
SPECS = {"tiny-dense": (J_DENSE, TINY_DENSE),
         "tiny-gemma2": (J_GEMMA2, TINY_GEMMA2),
         "tiny-moe": (J_MOE, TINY_MOE)}
SHAPES = {"kv_num_pages": 64, "kv_page_size": PS, "max_batch_slots": 4,
          "prefill_buckets": [8, 16, 32]}
STAGE0 = ("embed", "final_norm", "lm_head")


def tiny_spec(name, pp):
    """The (JAX, port) specs of ``name``, deepened to ``pp`` layers where
    pp needs more (tests/test_pipeline.py ``tiny_spec``)."""
    jspec, spec = SPECS[name]
    if spec.num_layers % pp == 0:
        return jspec, spec
    deeper = dict(name=f"{name}-{pp}l", num_layers=pp)
    return (dataclasses.replace(jspec, **deeper),
            dataclasses.replace(spec, **deeper))


def _jtree(jspec):
    return jdec.init_params(jspec, jax.random.PRNGKey(7), jnp.float32)


def j_pp_mesh(pp):
    """tests/test_pipeline.py ``pp_mesh`` at tp 1."""
    cfg = j_load_config(tpu={"dp": 1, "pp": pp, "ep": 1, "sp": 1, "tp": 1,
                             "num_devices": pp}).tpu
    return j_build_mesh(cfg, devices=jax.devices()[:pp])


def _hf_state_dict(tree, spec):
    """The stacked tree under HF names (Qwen2 and Gemma-2 dense, Mixtral
    MoE), each linear weight transposed to ``[out, in]``: what
    ``params_from_safetensors`` reads back, exactly."""
    sd = {"model.embed_tokens.weight": tree["embed"],
          "model.norm.weight": tree["final_norm"]}
    if not spec.tie_embeddings:
        sd["lm_head.weight"] = tree["lm_head"].T
    lay = tree["layers"]
    norms = {"input_norm": "input_layernorm",
             "post_norm": "post_attention_layernorm",
             "pre_ffn_norm": "pre_feedforward_layernorm",
             "post_ffn_norm": "post_feedforward_layernorm"}
    for l in range(spec.num_layers):
        pre = f"model.layers.{l}."
        for key, hf in norms.items():
            if key in lay:
                sd[pre + hf + ".weight"] = lay[key][l]
        for key in ("q", "k", "v", "o"):
            proj = f"{pre}self_attn.{key}_proj."
            sd[proj + "weight"] = lay[key]["w"][l].T
            if "b" in lay[key]:
                sd[proj + "bias"] = lay[key]["b"][l]
        if spec.is_moe:
            moe = pre + "block_sparse_moe."
            sd[moe + "gate.weight"] = lay["router"][l].T
            for e in range(spec.num_experts):
                for key, hf in (("gate", "w1"), ("up", "w3"), ("down", "w2")):
                    sd[f"{moe}experts.{e}.{hf}.weight"] = \
                        lay[key]["w"][l, e].T
        else:
            for key in ("gate", "up", "down"):
                sd[f"{pre}mlp.{key}_proj.weight"] = lay[key]["w"][l].T
    return {k: torch.from_numpy(np.array(v, np.float32, order="C"))
            for k, v in sd.items()}


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """{name: (JAX tree, numpy tree, checkpoint dir)} from one draw."""
    from safetensors.torch import save_file

    out = {}
    for name, (jspec, spec) in SPECS.items():
        jtree = _jtree(jspec)
        np_tree = np_copy(jax.tree.map(np.asarray, jtree))
        path = tmp_path_factory.mktemp(name)
        save_file(_hf_state_dict(np_tree, spec),
                  str(path / "model.safetensors"))
        out[name] = (jtree, np_tree, str(path))
    return out


def _config(name, ckpt, pp=2, **sections):
    device = {"device": "cpu", "pp": pp, **SHAPES,
              "prefix_cache": {"enabled": True},
              **sections.pop("device", {})}
    return load_config(
        model={"model_id": name, "engine_type": "torch_cuda",
               "dtype": "float32", "max_model_len": 96,
               "checkpoint_path": ckpt, **sections.pop("model", {})},
        device=device,
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


def _gone(proc, timeout=30.0):
    try:
        proc.wait(timeout)
    except Exception:
        return False
    return True


# ----------------------------------------------------- geometry, shards


@pytest.mark.parametrize("pp,ep,tp", [(2, 1, 1), (4, 1, 1), (2, 2, 2)],
                         ids=["pp2", "pp4", "pp2xep2xtp2"])
def test_rank_order_is_the_reference_device_order(pp, ep, tp):
    """Rank r sits at the reference mesh's position of its r-th device
    (axis order dp, pp, ep, sp, tp): its stage, ep and tp index, also
    where pp and ep are both above 1."""
    n = pp * ep * tp
    jcfg = j_load_config(tpu={"dp": 1, "pp": pp, "ep": ep, "sp": 1,
                              "tp": tp, "num_devices": n}).tpu
    jmesh = j_build_mesh(jcfg, devices=jax.devices()[:n])
    plan = MeshPlan(1, pp, ep, 1, tp)
    for rank in range(n):
        mesh = Mesh(plan, ["cpu"] * n, rank)
        [where] = np.argwhere(jmesh.devices == jax.devices()[rank])
        assert (mesh.pp_rank, mesh.ep_rank, mesh.tp_rank) == (
            where[1], where[2], where[4])
        assert mesh.stage_rank(mesh.pp_rank) == rank
        assert Mesh(plan, ["cpu"] * n, mesh.stage_rank(
            mesh.pp_rank + 1)).pp_rank == (mesh.pp_rank + 1) % pp


SHARD_CASES = [("tiny-dense", None), ("tiny-gemma2", None),
               ("tiny-moe", None), ("tiny-dense", "int8"),
               ("tiny-dense", "int4"), ("tiny-moe", "int8")]


@pytest.mark.parametrize("name,quantization", SHARD_CASES,
                         ids=[f"{n}-{q or 'plain'}" for n, q in SHARD_CASES])
def test_stage_leaves_equal_the_reference_addressable_shards(
        models, name, quantization):
    """Stage s's every layer leaf is exactly the reference's shard on the
    pp mesh's s-th device (placed, then quantized, as the reference
    does), quantized values and scales included; stage 0 holds the
    embedding, final norm and head whole, stage 1 none of them."""
    jspec, spec = SPECS[name]
    jtree, np_tree, _ = models[name]
    jmesh = j_pp_mesh(2)
    placed = j_shard_params(jtree, jspec, jmesh)
    if quantization:
        placed = j_quantize(placed, jspec, bits=int(quantization[3:]))
    flat_ref = jax.tree_util.tree_flatten_with_path(placed)[0]
    sliced = 0
    for rank in range(2):
        tree = params_from_jax(np_tree, spec)
        if quantization:
            tree = quantize_params(tree, spec, quantization)
        mesh = Mesh(MeshPlan(1, 2, 1, 1, 1), ["cpu", "cpu"], rank)
        tree = shard_params(tree, spec, mesh)
        assert (sorted(tree) == sorted(STAGE0[:2 + (not spec.tie_embeddings)]
                                       + ("layers",))) == (rank == 0)
        device = jmesh.devices.flat[rank]
        for path, leaf in flat_ref:
            if path[0].key in STAGE0:
                assert (path[0].key in tree) == (rank == 0)
                if rank:
                    continue
            node = tree
            for key in path:
                node = (getattr(node, key.name) if hasattr(key, "name")
                        else node[key.key])
            what = jax.tree_util.keystr(path)
            [shard] = [s for s in leaf.addressable_shards
                       if s.device == device]
            want = np.asarray(shard.data)
            assert tuple(node.shape) == want.shape, what
            np.testing.assert_array_equal(node.numpy(), want, err_msg=what)
            sliced += want.shape != leaf.shape
    # every layer leaf of both stages was halved
    assert sliced >= 2 * 7


def test_a_stage_takes_its_global_layers_windows():
    """Gemma-2 alternates windows by the global layer index: stage 1 of
    Gemma-2-9B at pp 2 starts at layer 21, a global layer, so counting
    its layers from 0 would swap every window; tiny-gemma2's stage 1 is
    its global layer 1."""
    gemma = spec_for_model_id("google/gemma-2-9b-it")
    mesh = Mesh(MeshPlan(1, 2, 1, 1, 1), ["cpu", "cpu"], 1)
    stage = local_spec(gemma, 1, mesh)
    assert (stage.first_layer, stage.num_layers) == (21, 21)
    assert stage.layer_windows == gemma.layer_windows[21:]
    local = dataclasses.replace(gemma, num_layers=21).layer_windows
    assert all(a != b for a, b in zip(stage.layer_windows, local))
    tiny = local_spec(TINY_GEMMA2, 1, mesh)
    assert tiny.layer_windows == (0,) and TINY_GEMMA2.layer_windows == (8, 0)
    assert stage.pipeline is mesh and stage.mesh is None


def test_a_stage_pool_holds_its_layers_pages():
    """A stage's pool is ``[L/pp, KV, P, ps, hd]`` and one budget holds
    pp times the pages of the whole model's (the reference sizes a pp
    pool from the whole model's page bytes)."""
    from vgate_tpu_torch.runtime.engine_core import kv_layout

    spec = spec_for_model_id("Qwen/Qwen2.5-7B-Instruct")
    cfg = load_config(model={"model_id": spec.name, "max_model_len": 1 << 16},
                      device={"device": "cpu", "kv_budget_bytes": 1 << 30,
                              "max_batch_slots": 64})
    one = Mesh(MeshPlan(1, 1, 1, 1, 1), ["cpu"])
    whole, _ = kv_layout(cfg, spec, torch.device("cpu"), torch.bfloat16, one)
    for rank in range(2):
        stage = local_spec(spec, 1, Mesh(MeshPlan(1, 2, 1, 1, 1),
                                         ["cpu", "cpu"], rank))
        geo, _ = kv_layout(cfg, stage, torch.device("cpu"), torch.bfloat16,
                           one)
        assert (geo.num_layers, whole.num_layers) == (14, 28)
        assert geo.num_pages == 2 * whole.num_pages


# ------------------------------------------------------------- forwards


FORWARD_CASES = [("tiny-dense", 2), ("tiny-gemma2", 2), ("tiny-moe", 2),
                 ("tiny-dense", 4)]


@pytest.mark.parametrize("name,pp", FORWARD_CASES,
                         ids=[f"{n}-pp{p}" for n, p in FORWARD_CASES])
def test_forwards_across_stages_match_the_jax_relay(models, name, pp):
    """``pp`` stage processes run the prompt pass and one decode step
    through the relay, B = 4 (M = pp) and B = 3 (M = 1): stage 0's
    logits equal the JAX relay's, and every stage's pool its device's
    shard of the relay's KV (trash page 0 aside, zeros in the port),
    within 2e-4."""
    jspec, spec = tiny_spec(name, pp)
    jtree = _jtree(jspec) if pp > 2 else models[name][0]
    np_tree = np_copy(jax.tree.map(np.asarray, jtree))
    jmesh = j_pp_mesh(pp)
    placed = j_shard_params(jtree, jspec, jmesh)
    kv_sharding = named(jmesh, kv_pspec(jspec, jmesh))
    # tiny-gemma2's prompts cross its sliding window of 8
    S = 16 if spec.sliding_window else 8
    cases, wants = [], []
    for B in (4, 3):
        pps = S // PS + 1
        num_pages = 1 + B * pps
        tokens = ((np.arange(B * S).reshape(B, S) * 7 + 3)
                  % spec.vocab_size).astype(np.int32)
        lens = np.asarray([S, S - 1, S - 5, 10][:B] if S == 16
                          else [S, S - 1, S - 3, 2][:B], np.int32)
        pt = (np.arange(B * pps, dtype=np.int32).reshape(B, pps) + 1)
        shape = (jspec.num_layers, jspec.num_kv_heads, num_pages, PS,
                 jspec.head_dim)
        k = jax.device_put(jnp.zeros(shape, jnp.float32), kv_sharding)
        v = jax.device_put(jnp.zeros(shape, jnp.float32), kv_sharding)
        prompt, k, v = jdec.prefill_forward(
            placed, jspec, jnp.asarray(tokens), jnp.asarray(lens), k, v,
            jnp.asarray(pt[:, :S // PS]), mesh=jmesh)
        nxt = np.asarray(jnp.argmax(prompt, -1), np.int32)
        step, k, v = jdec.decode_forward(
            placed, jspec, jnp.asarray(nxt), jnp.asarray(lens), k, v,
            jnp.asarray(pt), active=jnp.ones((B,), bool), mesh=jmesh)
        cases.append({"tokens": tokens, "lens": lens,
                      "prefill_pt": pt[:, :S // PS], "next": nxt, "pt": pt,
                      "num_pages": num_pages, "ps": PS})
        wants.append((np.asarray(prompt), np.asarray(step), k, v))
    stages = run_stages(spec, np_tree, pp, cases)
    n = spec.num_layers // pp
    for rank, (results, leaves, windows) in enumerate(stages):
        assert windows == spec.layer_windows[rank * n:(rank + 1) * n]
        assert ("embed" in leaves) == (rank == 0)
        device = jmesh.devices.flat[rank]
        for B, got, (prompt, step, k, v) in zip((4, 3), results, wants):
            what = f"stage {rank}, B {B}"
            if rank == 0:
                np.testing.assert_allclose(got["prefill"], prompt, atol=TOL,
                                           rtol=TOL, err_msg=what)
                np.testing.assert_allclose(got["decode"], step, atol=TOL,
                                           rtol=TOL, err_msg=what)
            else:
                assert got["prefill"] is None and got["decode"] is None
            for pool, ref in (("k", k), ("v", v)):
                [shard] = [np.asarray(s.data) for s in ref.addressable_shards
                           if s.device == device]
                assert got[pool].shape == shard.shape, what
                np.testing.assert_allclose(got[pool][:, :, 1:],
                                           shard[:, :, 1:], atol=TOL,
                                           rtol=TOL, err_msg=what)
                assert not got[pool][:, :, 0].any(), what


# ---------------------------------------------------------- the engines


ENGINE_CASES = [("tiny-dense", None), ("tiny-gemma2", None),
                ("tiny-moe", None), ("tiny-dense", "int8")]


@pytest.mark.parametrize("name,quantization", ENGINE_CASES,
                         ids=[f"{n}-{q or 'plain'}" for n, q in ENGINE_CASES])
def test_engine_token_identical_to_jax_at_pp2(models, name, quantization):
    """Two waves, 8 greedy tokens each (two prompts of one bucket: a
    prompt pass of two rows, M = 2; every decode step M = 2 of the 4
    slots; tiny-gemma2's prompts past its window): the port's pp=2
    streams equal the JAX engine's at pp=2.  Both turn the prefix cache
    off; the mesh block is the reference's plus the backend; the
    roofline's constants are the reference's (the whole model counted
    once); the follower ran every step and pass, on its own 1-layer
    pool, with no embedding or head."""
    jspec, spec = SPECS[name]
    jtree, np_tree, ckpt = models[name]
    model = {"quantization": quantization}
    j = JEngineCore(
        j_load_config(
            model={"model_id": name, "engine_type": "jax_tpu",
                   "dtype": "float32", "max_model_len": 96, **model},
            tpu={"dp": 1, "pp": 2, "tp": 1, "ep": 1, "sp": 1,
                 "use_pallas": False, **SHAPES},
            scheduler={"max_queue_size": 32}, integrity={"enabled": False},
            logging={"level": "ERROR"},
        ),
        params=jtree, devices=jax.devices()[:2],
    )
    t = EngineCore(_config(name, ckpt, model=model),
                   params=params_from_jax(np_tree, spec))
    try:
        rng = np.random.default_rng(11)
        greedy = dict(max_tokens=8, temperature=0.0)
        for lengths in ((5, 7, 14, 20), (6, 11, 9)):
            prompts = [rng.integers(3, spec.vocab_size, size=n).tolist()
                       for n in lengths]
            with private_uploads():
                want = _ticked(j, prompts, JSamplingParams(**greedy))
            got = _ticked(t, prompts, SamplingParams(**greedy))
            assert got == want
        assert not t.prefix_cache_enabled and not j.prefix_cache_enabled
        assert dataclasses.asdict(t.perf.roofline) == dataclasses.asdict(
            j.perf.roofline)
        ts = t.get_stats()
        mesh = dict(ts["mesh"])
        assert mesh.pop("backend") == "gloo"
        assert mesh == j.get_stats()["mesh"] == {
            "dp": 1, "pp": 2, "ep": 1, "sp": 1, "tp": 1}
        assert ts["running"] == 0 and ts["used_pages"] == 0
        [f] = t.follower_stats()
        assert (f["steps"], f["prompt_passes"]) == (ts["steps"],
                                                    ts["prompt_passes"])
        assert f["memory"]["leaves"] == ["layers"]
        assert f["memory"]["trash_page_zero"]
        assert t.k_pages.shape[0] == 1 and t.spec.first_layer == 0
        assert not t.k_pages[:, :, 0].any()
    finally:
        j.stop()
        t.close()


# ------------------------------------------------------------ recovery


@pytest.fixture
def drill(models):
    _, _, ckpt = models["tiny-dense"]
    rng = np.random.default_rng(17)
    prompts = [rng.integers(3, 500, size=n).tolist() for n in (6, 9, 11)]
    sup = EngineSupervisor(_config("tiny-dense", ckpt))
    sup.start()
    try:
        clean = _wait(_stream_all(sup, prompts))
        yield sup, prompts, clean
    finally:
        followers = list(sup.core.mesh.followers)
        sup.close()
        assert all(_gone(p) for p in followers)


def _stream_all(sup, prompts, tokens=12):
    params = SamplingParams(max_tokens=tokens, temperature=0.0)
    return [sup.submit_tokens(list(p), params) for p in prompts]


def _wait(seqs, timeout=120.0):
    deadline = time.monotonic() + timeout
    for s in seqs:
        assert s.done_event.wait(max(0.1, deadline - time.monotonic()))
        assert s.error is None, s.error
    return [list(s.generated_ids) for s in seqs]


def test_stage_follower_sigkill_mid_stream_rebuilds_and_resumes(drill):
    """Stage 1 SIGKILLed once every stream has 3 tokens: stage 0's next
    receive raises on the closed peer, the supervisor contains the crash
    and rebuilds the group with a new stage-1 process (its layers loaded
    afresh), and every stream resumes to the clean run's."""
    sup, prompts, clean = drill
    old = sup.core
    victim = old.mesh.followers[0]
    seqs = _stream_all(sup, prompts)
    deadline = time.monotonic() + 60
    while not all(len(s.generated_ids) >= 3 for s in seqs):
        assert time.monotonic() < deadline
        time.sleep(0.001)
    os.kill(victim.pid, signal.SIGKILL)
    assert _wait(seqs) == clean
    assert _gone(victim)
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
    assert new.mesh.followers[0].pid != victim.pid
    assert new.spec.pipeline is new.mesh
    assert _wait(_stream_all(sup, prompts)) == clean


def test_stage0_fault_rebuilds_with_the_stage_follower_kept(drill):
    """A ``decode_step`` fault on stage 0 (before the chunk is named to
    the follower): the rebuild is broadcast, so the same stage-1 process
    frees and rebuilds its pool with its layers kept, and the streams
    resume to the clean run's."""
    from vgate_tpu_torch import faults

    sup, prompts, clean = drill
    old = sup.core
    follower = old.mesh.followers[0]
    faults.arm("decode_step", mode="raise", times=1)
    try:
        assert _wait(_stream_all(sup, prompts)) == clean
    finally:
        faults.reset()
    assert sup.health()["restarts"] == 1
    assert sup.core is not old and sup.core.mesh is old.mesh
    assert follower.poll() is None
    [stats] = sup.core.follower_stats()
    assert stats["steps"] > 0 and stats["memory"]["leaves"] == ["layers"]
    assert _wait(_stream_all(sup, prompts)) == clean


def test_no_stage_outlives_backend_shutdown(models):
    """The backend's shutdown stops the supervisor, stage 0 and the
    stage-1 follower, and destroys the process groups."""
    from vgate_tpu_torch.backends.torch_backend import TorchCUDABackend

    _, _, ckpt = models["tiny-dense"]
    backend = TorchCUDABackend()
    backend.load_model(_config("tiny-dense", ckpt))
    followers = list(backend.core.core.mesh.followers)
    assert len(followers) == 1 and followers[0].poll() is None
    out = backend.generate(["hello"], [SamplingParams(max_tokens=4,
                                                      temperature=0.0)])
    assert out[0].num_tokens == 4
    assert backend.core.get_stats()["mesh"]["pp"] == 2
    backend.shutdown()
    assert all(_gone(p, timeout=10) for p in followers)
    assert not torch.distributed.is_initialized()
