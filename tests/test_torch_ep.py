"""Expert parallelism in the port (item 10c) vs the JAX package, on the CPU.

A mesh of ``ep x tp`` ranks is that many processes
(vgate_tpu_torch/parallel/): rank 0 is the engine in this process, the
others followers spawned by the mesh, joined by gloo groups.  The
followers load their shards from a safetensors checkpoint written here
from the JAX tree (HF names: Mixtral's ``block_sparse_moe`` for
``tiny-moe``), so every rank and the JAX engine hold the same values.
The JAX side runs on the conftest's 8 host devices.  Held here, in f32
unless stated:

* the plan and the rank order (rank = ep index x tp + tp index) are the
  reference's device order;
* each rank's shard equals the reference's addressable shard of its
  placed, then quantized, tree, exactly: plain leaves, int8 values and
  scales (a row-parallel scale whole, from the whole input axis), int4
  scales; int4 values compared unpacked, by logical row (the port
  repacks a row-parallel shard, the reference's packed leaf is a slice
  of the global layout);
* the int4 repack is exact, and K5's plain version over two repacked
  row shards sums to the whole product within f32 rounding;
* the prompt, suffix (aligned and copy-on-write) and decode forwards
  across processes match the JAX single-device oracle within 1e-4;
* at tp 1 in bf16, ``_moe_mlp``'s partials of two ep ranks summed in
  bf16 equal the one-rank output bit for bit;
* engines are greedy token-identical to the JAX engine at the same
  mesh through prompt, prefix-hit, copy-on-write, chunked and decode
  programs, and report ``get_stats()["mesh"]["ep"]``;
* a follower SIGKILLed at ep=2: the group rebuilds, rank 0 keeps its
  expert shard, and the streams resume to a clean run's.
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

from reference_uploads import private_uploads
from vgate_tpu.backends.base import SamplingParams as JSamplingParams
from vgate_tpu.config import load_config as j_load_config
from vgate_tpu.models import decoder as jdec
from vgate_tpu.models.specs import TINY_DENSE as J_DENSE
from vgate_tpu.models.specs import TINY_MOE as J_MOE
from vgate_tpu.ops.kv_quant import copy_page_prefix as jcp
from vgate_tpu.ops.quant import quantize_decoder_params as j_quantize
from vgate_tpu.parallel.mesh import build_mesh as j_build_mesh
from vgate_tpu.parallel.mesh import resolve_plan as j_resolve_plan
from vgate_tpu.parallel.sharding import shard_params as j_shard_params
from vgate_tpu.runtime.engine_core import EngineCore as JEngineCore
from vgate_tpu_torch.backends.base import SamplingParams
from vgate_tpu_torch.config import load_config
from vgate_tpu_torch.models import decoder as tdec
from vgate_tpu_torch.models.specs import TINY_DENSE, TINY_MOE
from vgate_tpu_torch.ops.kernels import quant_matmul as qm
from vgate_tpu_torch.ops.kv_quant import copy_page_prefix
from vgate_tpu_torch.ops.quant import (
    PackedQTensor,
    QTensor,
    quantize_tensor,
    shard_int4_rows,
    unpack_int4,
)
from vgate_tpu_torch.parallel.mesh import Mesh, MeshPlan, build_mesh
from vgate_tpu_torch.parallel.mesh import resolve_plan
from vgate_tpu_torch.parallel.sharding import local_spec, shard_params
from vgate_tpu_torch.runtime.engine_core import EngineCore, kv_layout
from vgate_tpu_torch.runtime.kv_cache import make_kv_buffers
from vgate_tpu_torch.runtime.supervisor import EngineSupervisor, HealthState
from vgate_tpu_torch.runtime.weights import params_from_jax, quantize_params

TOL = 1e-4  # tests/test_distributed.py's two-process decode bound
PS = 4
SPECS = {"tiny-moe": (J_MOE, TINY_MOE), "tiny-dense": (J_DENSE, TINY_DENSE)}
SHAPES = {"kv_num_pages": 64, "kv_page_size": PS, "max_batch_slots": 4,
          "prefill_buckets": [8, 16, 32], "prefill_chunk": 8,
          "prefix_cache": {"enabled": True, "cow_min_tokens": 2}}
BITS = {"int8": 8, "int4": 4}


def _jparams(name):
    return jdec.init_params(SPECS[name][0], jax.random.PRNGKey(7),
                            jnp.float32)


def _hf_state_dict(tree, spec):
    """The stacked tree under HF names (Qwen2 for dense, Mixtral for
    MoE: the router ``block_sparse_moe.gate`` ``[E, D]`` and experts
    ``w1``/``w3``/``w2``), each linear weight transposed to ``[out,
    in]``: what ``params_from_safetensors`` reads back, exactly."""
    sd = {"model.embed_tokens.weight": tree["embed"],
          "model.norm.weight": tree["final_norm"],
          "lm_head.weight": tree["lm_head"].T}
    lay = tree["layers"]
    for l in range(spec.num_layers):
        pre = f"model.layers.{l}."
        sd[pre + "input_layernorm.weight"] = lay["input_norm"][l]
        sd[pre + "post_attention_layernorm.weight"] = lay["post_norm"][l]
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
    for name, (_, spec) in SPECS.items():
        jtree = _jparams(name)
        np_tree = jax.tree.map(np.asarray, jtree)
        path = tmp_path_factory.mktemp(name)
        save_file(_hf_state_dict(np_tree, spec),
                  str(path / "model.safetensors"))
        out[name] = (jtree, np_tree, str(path))
    return out


def _jcfg(name, ep, tp, int8_native=False, **model):
    return j_load_config(
        model={"model_id": name, "engine_type": "jax_tpu",
               "dtype": "float32", "max_model_len": 96, **model},
        tpu={"dp": 1, "tp": tp, "ep": ep, "sp": 1, "use_pallas": False,
             "int8_native": int8_native, **SHAPES},
        scheduler={"max_queue_size": 32}, integrity={"enabled": False},
        logging={"level": "ERROR"},
    )


def _config(name, ckpt, ep=2, tp=1, model=None, **sections):
    device = {"device": "cpu", "ep": ep, "tp": tp, **SHAPES,
              **sections.pop("device", {})}
    return load_config(
        model={"model_id": name, "engine_type": "torch_cuda",
               "dtype": "float32", "max_model_len": 96,
               "checkpoint_path": ckpt, **(model or {})},
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


# ------------------------------------------------------ plan and order


@pytest.mark.parametrize("ep,tp", [(2, 1), (1, 2), (2, 2), (4, 2)],
                         ids=["ep2", "tp2", "ep2xtp2", "ep4xtp2"])
def test_plan_and_rank_order_match_the_reference(ep, tp):
    """The port's plan is the reference's, and rank r sits at the
    reference mesh's position of its r-th device (tp innermost)."""
    n = ep * tp
    jcfg = _jcfg("tiny-moe", ep, tp)
    cfg = _config("tiny-moe", None, ep=ep, tp=tp)
    plan = resolve_plan(cfg.device, n)
    jplan = j_resolve_plan(jcfg.tpu, n)
    assert plan.shape == jplan.shape == (1, 1, ep, 1, tp)
    jmesh = j_build_mesh(jcfg.tpu, devices=jax.devices()[:n])
    for rank in range(n):
        mesh = Mesh(plan, ["cpu"] * n, rank=rank)
        [where] = np.argwhere(jmesh.devices == jax.devices()[rank])
        assert (mesh.ep_rank, mesh.tp_rank) == (where[2], where[4])
        assert mesh.rank == mesh.ep_rank * tp + mesh.tp_rank


# ------------------------------------------------------------ sharding


SHARD_CASES = [("tiny-moe", ep, tp, q)
               for ep, tp in ((2, 1), (1, 2), (2, 2))
               for q in (None, "int8", "int4")] + [
    ("tiny-dense", 1, 2, "int8"), ("tiny-dense", 1, 2, "int4")]


def _port_shard(np_tree, spec, ep, tp, rank, quantization):
    """Rank ``rank``'s shard as the engine makes a handed-in tree's:
    quantized whole, then sharded."""
    params = params_from_jax(np_tree, spec)
    if quantization:
        params = quantize_params(params, spec, quantization)
    mesh = Mesh(MeshPlan(1, 1, ep, 1, tp), ["cpu"] * (ep * tp), rank=rank)
    return shard_params(params, spec, mesh), mesh


@pytest.mark.parametrize(
    "name,ep,tp,quantization", SHARD_CASES,
    ids=[f"{n}-ep{e}-tp{t}-{q or 'plain'}" for n, e, t, q in SHARD_CASES])
def test_shards_equal_the_reference_addressable_shards(models, name, ep, tp,
                                                       quantization):
    """Rank r's shard of every leaf is the reference's on the mesh's r-th
    device after ``shard_params`` then ``quantize_decoder_params``:
    exactly for plain leaves, int8 values and every scale; int4 values
    unpacked, by logical row."""
    jspec, spec = SPECS[name]
    jtree, np_tree, _ = models[name]
    n = ep * tp
    jmesh = j_build_mesh(_jcfg(name, ep, tp).tpu, devices=jax.devices()[:n])
    placed = j_shard_params(jtree, jspec, jmesh)
    if quantization:
        placed = j_quantize(placed, jspec, bits=BITS[quantization])
    flat_ref = jax.tree_util.tree_flatten_with_path(placed)[0]
    sliced = 0
    for rank in range(n):
        tree, mesh = _port_shard(np_tree, spec, ep, tp, rank, quantization)
        device = jax.devices()[rank]
        for path, leaf in flat_ref:
            node = tree
            for key in path:
                node = (getattr(node, key.name) if hasattr(key, "name")
                        else node[key.key])
            what = jax.tree_util.keystr(path)
            [shard] = [s for s in leaf.addressable_shards
                       if s.device == device]
            want = np.asarray(shard.data)
            if what.endswith(".q_packed"):
                # the logical rows this rank holds: the reference's slice
                # on every other axis, its tp part of a row-parallel leaf
                full = unpack_int4(torch.from_numpy(np.array(leaf)))
                rows = full.dim() - 2
                index = list(shard.index)
                index[rows] = slice(None)
                row_parallel = path[-2].key == "w" and path[-3].key in (
                    "o", "down") and tp > 1
                if row_parallel:
                    part = full.shape[rows] // tp
                    index[rows] = slice(mesh.tp_rank * part,
                                        (mesh.tp_rank + 1) * part)
                got = unpack_int4(node)
                np.testing.assert_array_equal(got.numpy(),
                                              full[tuple(index)].numpy(),
                                              err_msg=what)
                sliced += got.shape != full.shape
                continue
            assert tuple(node.shape) == want.shape, what
            np.testing.assert_array_equal(node.numpy(), want, err_msg=what)
            sliced += want.shape != leaf.shape
    # the expert leaves (and under tp the heads and channels) were split
    assert sliced >= n * 3


def test_int4_repack_is_exact_and_k5_row_shards_sum_to_the_product():
    """``shard_int4_rows`` is the logical rows' slice packed again, and
    K5's plain version over two repacked row shards, each against its
    half of the activations, sums to the whole product (f32)."""
    rng = np.random.default_rng(4)
    w = torch.from_numpy(rng.standard_normal((64, 24)).astype(np.float32))
    full = quantize_tensor(w, 4)
    rows = unpack_int4(full.q_packed)
    x = torch.from_numpy(rng.standard_normal((5, 64)).astype(np.float32))
    whole = qm.int4_matmul_plain(x, full.q_packed, full.scale,
                                 out_dtype=torch.float32)
    parts = []
    for index in range(2):
        shard = shard_int4_rows(full.q_packed, index, 2)
        assert tuple(shard.shape) == (16, 24)
        np.testing.assert_array_equal(
            unpack_int4(shard).numpy(),
            rows[32 * index:32 * (index + 1)].numpy())
        parts.append(qm.int4_matmul_plain(
            x[:, 32 * index:32 * (index + 1)], shard, full.scale,
            out_dtype=torch.float32))
    np.testing.assert_allclose((parts[0] + parts[1]).numpy(), whole.numpy(),
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="does not split"):
        shard_int4_rows(full.q_packed, 0, 3)


LOAD_CASES = [("tiny-moe", ep, tp, q)
              for ep, tp in ((1, 1), (2, 1), (1, 2), (2, 2))
              for q in (None, "int8", "int4")] + [
    ("tiny-dense", 1, tp, q) for tp in (1, 2) for q in ("int8", "int4")]


def _tree_leaves(tree, path=()):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _tree_leaves(tree[key], path + (key,))
    elif isinstance(tree, tuple):
        for i, part in enumerate(tree):
            yield path + (type(tree).__name__, i), part
    else:
        yield path, tree


@pytest.mark.parametrize("source", ["init", "checkpoint"])
@pytest.mark.parametrize(
    "name,ep,tp,quantization", LOAD_CASES,
    ids=[f"{n}-ep{e}-tp{t}-{q or 'plain'}" for n, e, t, q in LOAD_CASES])
def test_load_quantizes_each_leaf_whole_then_keeps_the_rank_shard(
        models, source, name, ep, tp, quantization):
    """The random init and the checkpoint loader, with ``quantization``
    and a rank's mesh, hold exactly what the whole tree quantized
    afterwards and then sharded holds (one rank: quantized afterwards),
    for every rank: the keep hook quantizes each leaf whole (a MoE
    layer at a time) before it slices it."""
    from vgate_tpu_torch.runtime.weights import (
        load_or_init_params,
        params_from_getter,
    )

    _, spec = SPECS[name]
    _, np_tree, _ = models[name]
    sd = _hf_state_dict(np_tree, spec)
    n = ep * tp

    def load(mesh, q):
        if source == "init":
            return load_or_init_params(spec, None, torch.device("cpu"),
                                       torch.float32, seed=3,
                                       quantization=q, shard=mesh)
        return params_from_getter(spec, sd.__getitem__, "cpu", torch.float32,
                                  q, mesh)

    for rank in range(n):
        mesh = (None if n == 1 else
                Mesh(MeshPlan(1, 1, ep, 1, tp), ["cpu"] * n, rank=rank))
        # the whole tree unquantized, quantized afterwards, then sharded
        want = load(None, None)
        if quantization:
            want = quantize_params(want, spec, quantization)
        if mesh is not None:
            want = shard_params(want, spec, mesh)
        got = load(mesh, quantization)
        pairs = list(zip(_tree_leaves(got), _tree_leaves(want)))
        assert len(pairs) == len(list(_tree_leaves(want)))
        for (path, a), (wpath, b) in pairs:
            assert path == wpath
            assert a.dtype == b.dtype and torch.equal(a, b), (rank, path)
        if quantization:
            assert isinstance(got["layers"]["o"]["w"],
                              QTensor if quantization == "int8"
                              else PackedQTensor)


# ------------------------------------------------------------- forwards


def _oracle_pools(spec, P):
    shape = (spec.num_layers, spec.num_kv_heads, P, PS, spec.head_dim)
    return np.zeros(shape, np.float32), np.zeros(shape, np.float32)


@pytest.mark.parametrize("ep,tp", [(2, 1), (2, 2)], ids=["ep2", "ep2xtp2"])
def test_forwards_across_processes_match_the_jax_oracle(models, ep, tp):
    """Rank 0 here and its followers run tiny-moe's prompt pass, a decode
    step, an aligned and a copy-on-write suffix pass over their shards
    (each rank 4/ep experts and F/tp channels) and pools; rank 0's
    logits match the JAX single-device forwards within 1e-4."""
    jspec, spec = SPECS["tiny-moe"]
    jtree, np_tree, ckpt = models["tiny-moe"]
    config = _config("tiny-moe", ckpt, ep=ep, tp=tp)
    mesh = build_mesh(config)
    try:
        assert (mesh.ep, mesh.tp, mesh.backend) == (ep, tp, "gloo")
        lspec = local_spec(spec, tp, mesh)
        assert lspec.expert_range == (0, spec.num_experts // ep)
        params = shard_params(params_from_jax(np_tree, spec), spec, mesh)
        assert params["layers"]["gate"]["w"].shape[1] == \
            spec.num_experts // ep
        geo, dtype = kv_layout(config, lspec, torch.device("cpu"),
                               torch.float32, mesh)
        P = geo.num_pages
        tk, tv = make_kv_buffers(geo, dtype, torch.device("cpu"))
        jk, jv = (jnp.asarray(a) for a in _oracle_pools(jspec, P))
        rng = np.random.default_rng(3)
        t = torch.from_numpy

        def close(got, want, what):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=TOL, rtol=TOL, err_msg=what)

        B, S = 2, 16
        tokens = rng.integers(3, spec.vocab_size, (B, S)).astype(np.int32)
        lens = np.array([12, 7], np.int32)
        pt = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
        mesh.send("prefill", tokens=tokens, seq_lens=lens, page_tables=pt)
        got = tdec.prefill_forward(params, lspec, t(tokens), t(lens), tk, tv,
                                   t(pt))
        want, jk, jv = jdec.prefill_forward(
            jtree, jspec, jnp.asarray(tokens), jnp.asarray(lens), jk, jv,
            jnp.asarray(pt))
        close(got, want, "prefill")
        slots = config.device.max_batch_slots
        nxt = np.zeros(slots, np.int32)
        nxt[:B] = np.argmax(np.asarray(want), -1)
        positions = np.zeros(slots, np.int32)
        positions[:B] = lens
        table = np.zeros((slots, geo.pages_per_seq), np.int32)
        table[0, :5] = [1, 2, 3, 4, 9]
        table[1, :3] = [5, 6, 10]
        active = np.arange(slots) < B
        mesh.send("decode_state", tokens=nxt, positions=positions,
                  active=active, page_tables=table)
        mesh.send("decode", key=None, num_steps=1, max_position=95,
                  graphs=False)
        got = tdec.decode_forward(params, lspec, t(nxt), t(positions), tk,
                                  tv, t(table), active=t(active))
        # the step's sampled tokens, which the followers wait for
        mesh.broadcast(torch.zeros(slots, dtype=torch.int32))
        want, jk, jv = jdec.decode_forward(
            jtree, jspec, jnp.asarray(nxt), jnp.asarray(positions), jk, jv,
            jnp.asarray(table), active=jnp.asarray(active))
        # the active rows; the idle ones read trash page 0, zeros in the
        # port (ops/kv_quant.py kv_write), and agree with each other
        close(got[:B], want[:B], "decode")
        idle = got[B:]
        assert torch.isfinite(idle).all()
        torch.testing.assert_close(idle, idle[:1].expand_as(idle),
                                   atol=TOL, rtol=TOL)
        for start, unaligned in ((12, False), (10, True)):
            suffix = rng.integers(3, spec.vocab_size, 9).astype(np.int32)
            tok = np.zeros((1, 12), np.int32)
            tok[0, :9] = suffix
            if unaligned:
                mesh.send("cow", page=(3, 11, 2))
                for pool in (tk, tv):
                    copy_page_prefix(pool, 3, 11, 2)
                jk = jcp(jk, 3, 11, jnp.arange(PS) < 2)
                jv = jcp(jv, 3, 11, jnp.arange(PS) < 2)
                own = np.array([[11, 12, 13, 14]], np.int32)
                ctx = np.array([[1, 2, 11, 12, 13, 14, 0, 0]], np.int32)
            else:
                own = np.array([[15, 16, 17]], np.int32)
                ctx = np.array([[1, 2, 3, 15, 16, 17, 0, 0]], np.int32)
            args = (tok, np.array([start], np.int32),
                    np.array([9], np.int32), own, ctx)
            mesh.send("suffix", tokens=args[0], prefix_lens=args[1],
                      suffix_lens=args[2], suffix_pt=own, ctx_pt=ctx,
                      unaligned=unaligned)
            got = tdec.prefill_suffix_forward(
                params, lspec, *(t(a) for a in args[:3]), tk, tv,
                *(t(a) for a in args[3:]), unaligned=unaligned)
            want, jk, jv = jdec.prefill_suffix_forward(
                jtree, jspec, *(jnp.asarray(a) for a in args[:3]), jk, jv,
                *(jnp.asarray(a) for a in args[3:]), unaligned=unaligned)
            close(got, want, f"suffix from {start}")
        # every ep rank holds the pool of its tp heads: rank 0 the first
        kv = spec.num_kv_heads // tp
        # (every page but trash page 0, which holds zeros in the port)
        np.testing.assert_allclose(tk.numpy()[:, :, 1:],
                                   np.asarray(jk)[:, :kv, 1:],
                                   atol=TOL, rtol=TOL)
        assert not tk[:, :, 0].any()
        stats = mesh.request("stats")
        assert len(stats) == ep * tp - 1
        for s in stats:
            assert s["prompt_passes"] == 3 and s["steps"] == 1
            assert s["memory"]["pool_pages"] == P
    finally:
        mesh.shutdown()
    assert all(_gone(p) for p in mesh.followers)


class _Partial:
    """A mesh stand-in for one rank's ``_moe_mlp``: its experts, no
    collective (the test sums the ranks' partials itself)."""

    tp = 1

    def all_reduce(self, t, experts=False):
        return t


@pytest.mark.parametrize("quantization", [None, "int8"])
def test_moe_mlp_over_ep2_equals_one_rank_bit_for_bit_in_bf16(quantization):
    """At tp 1 a token's output is at most K = 2 non-zero partials: the
    two ep ranks' partials summed in bf16 (as the expert group's
    all-reduce sums them) equal the one-rank ``_moe_mlp`` exactly, at a
    decode step's 4 rows and a prompt pass's 32."""
    spec = TINY_MOE
    gen = torch.Generator().manual_seed(11)
    params = tdec.init_params(spec, gen, dtype=torch.bfloat16,
                              quantization=quantization)
    lp = tdec.layer_params(params, 0)
    rng = np.random.default_rng(12)
    E = spec.num_experts
    for T in (4, 32):
        x = torch.from_numpy(
            rng.standard_normal((T, spec.hidden_size)).astype(np.float32)
        ).bfloat16()
        whole = tdec._moe_mlp(x, lp, spec)
        parts = []
        for rank in range(2):
            first = rank * E // 2
            local = dataclasses.replace(spec, mesh=_Partial(),
                                        expert_range=(first, E // 2))
            llp = dict(lp)
            for name in ("gate", "up", "down"):
                w = lp[name]["w"]
                llp[name] = {"w": type(w)(*(p[first:first + E // 2]
                                            for p in w))
                             if isinstance(w, tuple)
                             else w[first:first + E // 2]}
            parts.append(tdec._moe_mlp(x, llp, local))
        assert bool((parts[0] != 0).any()) and bool((parts[1] != 0).any())
        assert torch.equal(parts[0] + parts[1], whole), T


# ---------------------------------------------------------- the engines


class Pair:
    """The JAX EngineCore over ``jax.devices()[:ep*tp]`` and the port's
    EngineCore (rank 0 here, followers in their processes) on one tree;
    ``wave`` queues the same requests in both, then ticks each by hand,
    the JAX engine inside ``private_uploads``."""

    def __init__(self, models, name, ep, tp, quantization=None,
                 int8_native=False):
        jtree, np_tree, ckpt = models[name]
        model = {"quantization": quantization}
        device = {"int8_native": int8_native}
        self.j = JEngineCore(_jcfg(name, ep, tp, int8_native, **model),
                             params=jtree,
                             devices=jax.devices()[:ep * tp])
        self.t = EngineCore(
            _config(name, ckpt, ep=ep, tp=tp, model=model, device=device),
            params=params_from_jax(np_tree, SPECS[name][1]))

    def wave(self, prompts, tokens):
        with private_uploads():
            want = _ticked(self.j, prompts,
                           JSamplingParams(max_tokens=tokens,
                                           temperature=0.0))
        got = _ticked(self.t, prompts,
                      SamplingParams(max_tokens=tokens, temperature=0.0))
        assert got == want
        return got

    def close(self):
        self.j.stop()
        self.t.close()


ENGINE_CASES = [
    ("tiny-moe", 2, 1, None, False),
    ("tiny-moe", 2, 2, None, False),
    ("tiny-moe", 2, 1, "int8", False),
    ("tiny-moe", 2, 1, "int4", False),
    ("tiny-moe", 2, 1, "int8", True),
    ("tiny-dense", 1, 2, "int8", False),
    ("tiny-dense", 1, 2, "int4", False),
]


@pytest.mark.parametrize(
    "name,ep,tp,quantization,int8_native", ENGINE_CASES,
    ids=[f"{n}-ep{e}-tp{t}-{q or 'plain'}" + ("-w8a8" if i else "")
         for n, e, t, q, i in ENGINE_CASES])
def test_engine_token_identical_to_jax(models, name, ep, tp, quantization,
                                       int8_native):
    """A cold chunked prompt, then a prefix hit and a copy-on-write
    divergence beside a third prompt, 12 greedy tokens each: the port's
    streams equal the JAX engine's at the same mesh, with equal
    prefix-cache counters; the mesh block is the reference's plus the
    backend, and every follower ran rank 0's steps and passes."""
    spec = SPECS[name][1]
    pair = Pair(models, name, ep, tp, quantization, int8_native)
    try:
        rng = np.random.default_rng(11)
        base = rng.integers(3, spec.vocab_size, size=14).tolist()
        pair.wave([base], tokens=4)
        hit, cow, other = pair.wave(
            [base, base[:10] + [21, 22, 23, 24, 25],
             rng.integers(3, spec.vocab_size, size=13).tolist()],
            tokens=12,
        )
        assert len(hit) == len(cow) == len(other) == 12
        t, j = pair.t.get_stats(), pair.j.get_stats()
        tpc = t["scheduler"]["prefix_cache"]
        jpc = j["scheduler"]["prefix_cache"]
        for key in ("hit_tokens", "cow_copies"):
            assert tpc[key] == jpc[key], key
        assert tpc["hit_tokens"] > 0 and tpc["cow_copies"] > 0
        assert t["prefix_cache"]["chunked_prefills"] >= 2
        assert t["running"] == 0 and t["used_pages"] == 0
        mesh = dict(t["mesh"])
        assert mesh.pop("backend") == "gloo"
        assert mesh == j["mesh"] == {"dp": 1, "pp": 1, "ep": ep, "sp": 1,
                                     "tp": tp}
        assert pair.t.spec.int8_native == int8_native
        gate = pair.t.params["layers"]["gate"]["w"]
        if quantization:
            assert isinstance(gate, PackedQTensor if quantization == "int4"
                              else QTensor)
        if spec.is_moe:
            vals = gate[0] if quantization else gate
            assert vals.shape[1] == spec.num_experts // ep
        followers = pair.t.follower_stats()
        assert len(followers) == ep * tp - 1
        for f in followers:
            assert f["steps"] == t["steps"]
            assert f["prompt_passes"] == t["prompt_passes"]
    finally:
        pair.close()


def test_refusals_left_on_an_expert_mesh():
    """An ep the experts do not split into and the reference's plain-mesh
    errors, at load; dense ep over replicated layers is served."""
    from vgate_tpu_torch.config import NotPortedError

    with pytest.raises(NotPortedError, match="num_experts=4 is not "
                       "divisible by device.ep=3"):
        load_config(model={"model_id": "tiny-moe"},
                    device={"device": "cpu", "ep": 3})
    with pytest.raises(ValueError, match=r"int8 requires a plain mesh, "
                       r"got \{'ep': 2\}"):
        load_config(model={"model_id": "tiny-moe"},
                    device={"device": "cpu", "ep": 2},
                    kv_cache={"dtype": "int8"})


# ------------------------------------------------------------ recovery


def test_follower_sigkill_at_ep2_rebuilds_keeps_shards_and_resumes(models):
    """The follower (ep rank 1) SIGKILLed once every stream has 3 tokens:
    the supervisor rebuilds the group with a new follower, which loads
    its experts afresh, while rank 0 keeps its expert shard; every
    stream resumes to the clean run's tokens."""
    _, _, ckpt = models["tiny-moe"]
    rng = np.random.default_rng(17)
    prompts = [rng.integers(3, 500, size=n).tolist() for n in (6, 9, 11)]
    params = SamplingParams(max_tokens=12, temperature=0.0)
    sup = EngineSupervisor(_config("tiny-moe", ckpt))
    sup.start()
    followers = []
    try:
        def wait(seqs, timeout=120.0):
            deadline = time.monotonic() + timeout
            for s in seqs:
                assert s.done_event.wait(max(0.1, deadline - time.monotonic()))
                assert s.error is None, s.error
            return [list(s.generated_ids) for s in seqs]

        clean = wait([sup.submit_tokens(list(p), params) for p in prompts])
        old = sup.core
        gate = old.params["layers"]["gate"]["w"]
        assert gate.shape[1] == TINY_MOE.num_experts // 2
        [before] = old.follower_stats()
        victim = old.mesh.followers[0]
        followers.append(victim)
        seqs = [sup.submit_tokens(list(p), params) for p in prompts]
        deadline = time.monotonic() + 60
        while not all(len(s.generated_ids) >= 3 for s in seqs):
            assert time.monotonic() < deadline
            time.sleep(0.001)
        os.kill(victim.pid, signal.SIGKILL)
        assert wait(seqs) == clean
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
        followers.extend(new.mesh.followers)
        assert new.mesh is not old.mesh and new.mesh.healthy()
        assert new.get_stats()["mesh"]["ep"] == 2
        # rank 0's shard kept; the new follower's loaded to the same size
        assert new.params["layers"]["gate"]["w"] is gate
        [after] = new.follower_stats()
        assert after["memory"]["weights_bytes"] == \
            before["memory"]["weights_bytes"]
        assert wait([sup.submit_tokens(list(p), params)
                     for p in prompts]) == clean
    finally:
        sup.close()
    assert all(_gone(p) for p in followers)
