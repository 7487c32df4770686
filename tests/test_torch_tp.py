"""Tensor parallelism in the port (item 10a) vs the JAX package, on the CPU.

The port's tp group is SPMD over processes (vgate_tpu_torch/parallel/):
rank 0 is the engine in this process, rank 1 a follower spawned by the
mesh (``python -m vgate_tpu_torch.parallel.follower``), joined by gloo
groups.  The follower loads its shard from a safetensors checkpoint
written here from the JAX tree (HF names, linear weights ``[out, in]``),
so every rank and the JAX engine hold the same values.  Held here, in
f32:

* each leaf of the port's shard equals the reference's addressable shard
  of ``shard_params`` over ``jax.devices()[:2]`` (exactly);
* the prompt, suffix (aligned and copy-on-write) and decode forwards of
  two ranks match the JAX single-device oracle within 1e-4 (the bound of
  tests/test_distributed.py's two-process decode step);
* a tp=2 ``EngineCore`` is token-identical to the JAX ``EngineCore`` at
  tp=2 through prompt, prefix-hit, copy-on-write and chunked passes and
  decode, on tiny-dense and tiny-gemma2, and its ``get_stats()["mesh"]``
  is the reference's plus the device group's backend;
* seeded sampled streams at tp=2 equal the port's tp=1 streams (rank 0
  samples, as one engine would);
* the refusals under a model-parallel mesh;
* a follower SIGKILLed mid-stream or a fault on rank 0 under the
  supervisor: the group rebuilds and every stream equals a clean run's;
  no follower outlives ``shutdown``.
"""

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
from vgate_tpu.models.specs import TINY_GEMMA2 as J_GEMMA2
from vgate_tpu.ops.kv_quant import copy_page_prefix as jcp
from vgate_tpu.parallel.mesh import build_mesh as j_build_mesh
from vgate_tpu.parallel.sharding import shard_params as j_shard_params
from vgate_tpu.runtime.engine_core import EngineCore as JEngineCore
from vgate_tpu_torch import faults
from vgate_tpu_torch.backends.base import SamplingParams
from vgate_tpu_torch.config import NotPortedError, load_config
from vgate_tpu_torch.models import decoder as tdec
from vgate_tpu_torch.models.specs import TINY_DENSE, TINY_GEMMA2
from vgate_tpu_torch.ops.kv_quant import copy_page_prefix
from vgate_tpu_torch.parallel.mesh import Mesh, MeshPlan, build_mesh
from vgate_tpu_torch.parallel.sharding import local_spec, shard_params
from vgate_tpu_torch.parallel.tp_attention import tp_divisible
from vgate_tpu_torch.runtime.engine_core import EngineCore, kv_layout
from vgate_tpu_torch.runtime.kv_cache import make_kv_buffers
from vgate_tpu_torch.runtime.supervisor import EngineSupervisor, HealthState
from vgate_tpu_torch.runtime.weights import params_from_jax

TOL = 1e-4  # tests/test_distributed.py's two-process decode bound
PS = 4
SPECS = {"tiny-dense": (J_DENSE, TINY_DENSE),
         "tiny-gemma2": (J_GEMMA2, TINY_GEMMA2)}
SHAPES = {"kv_num_pages": 64, "kv_page_size": PS, "max_batch_slots": 4,
          "prefill_buckets": [8, 16, 32], "prefill_chunk": 8,
          "prefix_cache": {"enabled": True, "cow_min_tokens": 2}}


def _jparams(name):
    return jdec.init_params(SPECS[name][0], jax.random.PRNGKey(7),
                            jax.numpy.float32)


def _hf_state_dict(tree, spec):
    """The port's (and the reference's) stacked tree under HF names, each
    linear weight transposed to ``[out, in]``: what ``params_from_
    safetensors`` reads back, exactly."""
    sd = {"model.embed_tokens.weight": tree["embed"],
          "model.norm.weight": tree["final_norm"]}
    if not spec.tie_embeddings:
        sd["lm_head.weight"] = tree["lm_head"].T
    lay = tree["layers"]
    names = {"input_norm": "input_layernorm",
             "post_norm": "post_attention_layernorm",
             "pre_ffn_norm": "pre_feedforward_layernorm",
             "post_ffn_norm": "post_feedforward_layernorm"}
    projs = {"q": "self_attn.q_proj", "k": "self_attn.k_proj",
             "v": "self_attn.v_proj", "o": "self_attn.o_proj",
             "gate": "mlp.gate_proj", "up": "mlp.up_proj",
             "down": "mlp.down_proj"}
    for l in range(spec.num_layers):
        pre = f"model.layers.{l}."
        for key, hf in names.items():
            if key in lay:
                sd[pre + hf + ".weight"] = lay[key][l]
        for key, hf in projs.items():
            sd[pre + hf + ".weight"] = lay[key]["w"][l].T
            if "b" in lay[key]:
                sd[pre + hf + ".bias"] = lay[key]["b"][l]
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


def _config(name, ckpt, tp=2, **sections):
    device = {"device": "cpu", "tp": tp, **SHAPES,
              **sections.pop("device", {})}
    return load_config(
        model={"model_id": name, "engine_type": "torch_cuda",
               "dtype": "float32", "max_model_len": 96,
               "checkpoint_path": ckpt},
        device=device,
        scheduler={"max_queue_size": 32},
        recovery={"backoff_base_s": 0.05, "backoff_cap_s": 0.5},
        logging={"level": "ERROR"},
        **sections,
    )


def _port_core(models, name, tp=2, **sections):
    jtree, np_tree, ckpt = models[name]
    return EngineCore(_config(name, ckpt, tp=tp, **sections),
                      params=params_from_jax(np_tree, SPECS[name][1]))


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


# ------------------------------------------------------------- sharding


@pytest.mark.parametrize("name", list(SPECS))
def test_shards_equal_the_reference_addressable_shards(models, name):
    """Rank r's shard of every leaf is exactly the reference's shard on
    the mesh's r-th device (``param_pspecs`` over tp=2)."""
    jspec, spec = SPECS[name]
    jtree, np_tree, _ = models[name]
    jcfg = j_load_config(
        model={"model_id": name, "engine_type": "jax_tpu",
               "dtype": "float32"},
        tpu={"dp": 1, "tp": 2, "ep": 1, "sp": 1, "use_pallas": False},
        logging={"level": "ERROR"},
    )
    jmesh = j_build_mesh(jcfg.tpu, devices=jax.devices()[:2])
    placed = j_shard_params(jtree, jspec, jmesh)
    flat_ref = jax.tree_util.tree_flatten_with_path(placed)[0]
    sharded_leaves = 0
    for rank in range(2):
        mesh = Mesh(MeshPlan(1, 1, 1, 1, 2), ["cpu", "cpu"], rank=rank)
        tree = shard_params(params_from_jax(np_tree, spec), spec, mesh)
        device = jmesh.devices.flat[rank]
        for path, leaf in flat_ref:
            node = tree
            for key in path:
                node = node[key.key]
            [want] = [np.asarray(s.data) for s in leaf.addressable_shards
                      if s.device == device]
            assert node.shape == want.shape, jax.tree_util.keystr(path)
            np.testing.assert_array_equal(node.numpy(), want)
            sharded_leaves += want.shape != leaf.shape
    # q/k/v/o, gate/up/down (and the biases, the vocab) were split
    assert sharded_leaves >= 2 * 7


def test_local_spec_takes_a_ranks_heads():
    """A rank's spec has H/tp, KV/tp and F/tp, the vocab whole: Qwen2.5-7B
    at tp=2 is 14/2 heads a rank (G = 7 unchanged), at tp=4 7/1."""
    from vgate_tpu_torch.models.specs import QWEN25_7B

    spec = local_spec(QWEN25_7B, 2)
    assert (spec.num_heads, spec.num_kv_heads, spec.intermediate_size) == (
        14, 2, 9472)
    assert spec.vocab_size == QWEN25_7B.vocab_size
    assert spec.num_heads // spec.num_kv_heads == 7
    four = local_spec(QWEN25_7B, 4)
    assert (four.num_heads, four.num_kv_heads) == (7, 1)
    assert local_spec(QWEN25_7B, 1) is QWEN25_7B
    assert tp_divisible(Mesh(MeshPlan(1, 1, 1, 1, 2), ["cpu"] * 2), 28, 4)
    assert not tp_divisible(Mesh(MeshPlan(1, 1, 1, 1, 1), ["cpu"]), 28, 4)


# ------------------------------------------------------------- forwards


def _oracle_pools(spec, P):
    shape = (spec.num_layers, spec.num_kv_heads, P, PS, spec.head_dim)
    return np.zeros(shape, np.float32), np.zeros(shape, np.float32)


@pytest.mark.parametrize("name", list(SPECS))
def test_forwards_across_two_processes_match_the_jax_oracle(models, name):
    """Rank 0 here and a follower process run the prompt pass, a decode
    step, an aligned and a copy-on-write suffix pass over their shards
    and pools; rank 0's all-gathered logits match the JAX single-device
    forwards within 1e-4."""
    jspec, spec = SPECS[name]
    jtree, np_tree, ckpt = models[name]
    config = _config(name, ckpt)
    mesh = build_mesh(config)
    try:
        assert mesh.tp == 2 and mesh.backend == "gloo"
        lspec = local_spec(spec, 2, mesh)
        params = shard_params(params_from_jax(np_tree, spec), spec, mesh)
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

        # a prompt pass: 12 and 7 tokens
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
        # a decode step at positions 12 and 7 over the engine's 4 slots
        # (2 idle) and full-width tables
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
        # the step's sampled tokens, which the follower waits for
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
        # suffix passes over row 0's resident 12 tokens (3 pages): from
        # the page boundary, then from 10 tokens after copying the head
        # of page 3 into a page of its own
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
        # rank 0's pool holds the first KV/2 heads of the oracle's
        kv = spec.num_kv_heads // 2
        # (every page but trash page 0, which holds zeros in the port)
        np.testing.assert_allclose(tk.numpy()[:, :, 1:],
                                   np.asarray(jk)[:, :kv, 1:],
                                   atol=TOL, rtol=TOL)
        assert not tk[:, :, 0].any()
        assert tuple(tk.shape) == (spec.num_layers, kv, P, PS, spec.head_dim)
        [stats] = mesh.request("stats")
        assert stats["prompt_passes"] == 3 and stats["steps"] == 1
        assert stats["memory"]["pool_pages"] == P
    finally:
        mesh.shutdown()
    assert all(_gone(p) for p in mesh.followers)


# ---------------------------------------------------------- the engines


class Pair:
    """The JAX EngineCore at tp=2 over ``jax.devices()[:2]`` and the
    port's tp=2 EngineCore (rank 0 here, a follower process) on one tree;
    ``wave`` queues the same requests in both, then ticks each by hand,
    the JAX engine inside ``private_uploads``."""

    def __init__(self, models, name):
        jtree, _, _ = models[name]
        self.j = JEngineCore(
            j_load_config(
                model={"model_id": name, "engine_type": "jax_tpu",
                       "dtype": "float32", "max_model_len": 96},
                tpu={"dp": 1, "tp": 2, "ep": 1, "sp": 1,
                     "use_pallas": False, **SHAPES},
                scheduler={"max_queue_size": 32},
                integrity={"enabled": False}, logging={"level": "ERROR"},
            ),
            params=jtree, devices=jax.devices()[:2],
        )
        self.t = _port_core(models, name)

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


@pytest.mark.parametrize("name", list(SPECS))
def test_engine_token_identical_to_jax_at_tp2(monkeypatch, models, name):
    """A cold chunked prompt, then a prefix hit and a copy-on-write
    divergence beside a third prompt, 16 greedy tokens each: the port's
    tp=2 streams equal the JAX engine's at tp=2, with equal prefix-cache
    counters; the mesh block is the reference's plus the backend; rank
    0's pools hold KV/2 heads, and every attention call (K1, K2, K3 on
    the card) gets H/2 query heads and KV/2 kv heads."""
    spec = SPECS[name][1]
    heads = []
    for fn in ("paged_decode_attention", "flash_prefill_attention",
               "paged_multitok_attention"):
        def spy(q, k, *args, _real=getattr(tdec, fn), **kwargs):
            kv = k.shape[0] if k.dim() == 4 else k.shape[2]
            heads.append((q.shape[-2], kv))
            return _real(q, k, *args, **kwargs)
        monkeypatch.setattr(tdec, fn, spy)
    pair = Pair(models, name)
    try:
        rng = np.random.default_rng(11)
        base = rng.integers(3, spec.vocab_size, size=14).tolist()
        pair.wave([base], tokens=4)
        hit, cow, other = pair.wave(
            [base, base[:10] + [21, 22, 23, 24, 25],
             rng.integers(3, spec.vocab_size, size=13).tolist()],
            tokens=16,
        )
        assert len(hit) == len(cow) == len(other) == 16
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
        assert mesh == j["mesh"] == {"dp": 1, "pp": 1, "ep": 1, "sp": 1,
                                     "tp": 2}
        assert pair.t.device_health()["num_devices"] == 2
        assert tuple(pair.t.k_pages.shape)[1] == spec.num_kv_heads // 2
        assert set(heads) == {(spec.num_heads // 2, spec.num_kv_heads // 2)}
        [f] = pair.t.follower_stats()
        assert f["steps"] == t["steps"]
        assert f["prompt_passes"] == t["prompt_passes"]
        assert f["memory"]["pool_pages"] == pair.t.geometry.num_pages
    finally:
        pair.close()


def test_sampled_streams_at_tp2_equal_tp1_with_the_same_seed(models):
    """Rank 0 samples from the gathered logits with the engine's
    generator, so seeded and unseeded sampled streams at tp=2 are the
    port's tp=1 streams."""
    rng = np.random.default_rng(5)
    prompts = [rng.integers(3, 500, size=n).tolist() for n in (5, 9, 12)]
    outs = []
    for tp in (1, 2):
        core = _port_core(models, "tiny-dense", tp=tp)
        try:
            seeded = _ticked(core, prompts, SamplingParams(
                max_tokens=10, temperature=0.9, top_p=0.9, top_k=40,
                seed=1234))
            unseeded = _ticked(core, prompts[:2], SamplingParams(
                max_tokens=10, temperature=0.7))
            outs.append((seeded, unseeded))
        finally:
            core.close()
    assert outs[1] == outs[0]


# ------------------------------------------------------------ refusals


@pytest.mark.parametrize(
    "sections,error,match",
    [
        ({"kv_cache": {"dtype": "int8"}}, ValueError,
         r"kv_cache.dtype=int8 requires a plain mesh, got \{'tp': 2\}"),
        ({"kv_cache": {"host_swap_bytes": 1 << 20}}, ValueError,
         r"kv_cache.host_swap_bytes requires a plain mesh, got \{'tp': 2\}"),
        ({"device": {"speculative_k": 2}}, NotPortedError,
         r"speculative decoding .* item 10d"),
        # MoE and quantized weights serve under a mesh since item 10c:
        # an ep the experts do not split into, and int8 KV beside int8
        # weights, still refuse
        ({"model": {"model_id": "tiny-moe"}, "device": {"ep": 3}},
         NotPortedError, r"num_experts=4 is not divisible by device.ep=3"),
        ({"model": {"quantization": "int8"}, "kv_cache": {"dtype": "int8"}},
         ValueError,
         r"kv_cache.dtype=int8 requires a plain mesh, got \{'tp': 2\}"),
        ({"pod": {"workers": 2}}, NotPortedError,
         r"pod.workers>0 .* item 10a \(rest\)"),
        ({"device": {"tp": 3}}, NotPortedError,
         r"num_heads=4 is not divisible by device.tp=3.*10a \(rest\)"),
        ({"model": {"model_id": "Qwen/Qwen2.5-0.5B-Instruct"},
          "device": {"tp": 4}}, NotPortedError,
         r"num_heads=14 is not divisible by device.tp=4"),
        ({"model": {"model_id": "Qwen/Qwen2.5-7B-Instruct"},
          "device": {"tp": 7}}, NotPortedError,
         r"num_kv_heads=4 is not divisible by device.tp=7"),
        ({"device": {"dp": 2}}, NotPortedError, r"device.dp>1 .* item 10b"),
        # sp x tp serves since item 10d (rest)'s second part
        # (tests/test_torch_config.py test_composed_meshes_load); under it
        # speculation still refuses
        ({"device": {"sp": 2, "speculative_k": 2}}, NotPortedError,
         r"speculative decoding .* item 10d"),
        # speculation under an expert-parallel mesh
        ({"model": {"model_id": "tiny-moe"},
          "device": {"ep": 2, "speculative_k": 2}}, NotPortedError,
         r"speculative decoding .* item 10d"),
        ({"device": {"devices": ["cpu", "cpu", "cpu"]}}, ValueError,
         r"device.devices names 3 devices but device.tp is 2"),
    ],
    ids=["int8_kv", "host_swap", "speculation", "moe", "quantization",
         "pod", "heads", "heads_0.5b", "kv_heads_7b", "dp", "sp", "ep",
         "devices"],
)
def test_model_parallel_refusals(sections, error, match):
    model = {"model_id": "tiny-dense", **sections.pop("model", {})}
    device = {"device": "cpu", "tp": 2, **sections.pop("device", {})}
    with pytest.raises(error, match=match):
        load_config(model=model, device=device, **sections)


def test_engine_refuses_before_spawning_a_follower(monkeypatch, models):
    """tp 0 resolves at the engine (every visible device: one CPU here);
    a tp the config could not see is refused there, before any follower
    starts."""
    jtree, np_tree, ckpt = models["tiny-dense"]
    cfg = _config("tiny-dense", ckpt, tp=0)
    core = EngineCore(cfg, params=params_from_jax(np_tree, TINY_DENSE))
    assert core.get_stats()["mesh"]["tp"] == 1 and not core.mesh.followers
    core.close()
    spawned = []
    monkeypatch.setattr(Mesh, "spawn_followers",
                        lambda *a: spawned.append(a))
    cfg = _config("tiny-dense", ckpt, tp=0, kv_cache={"dtype": "int8"})
    with pytest.raises(ValueError, match="kv_cache.dtype=int8 requires"):
        EngineCore(cfg, devices=["cpu", "cpu"])
    assert not spawned


# ------------------------------------------------------------ recovery


def _supervised(models, name="tiny-dense"):
    _, _, ckpt = models[name]
    return EngineSupervisor(_config(name, ckpt))


def _stream_all(sup, prompts, tokens=12):
    params = SamplingParams(max_tokens=tokens, temperature=0.0)
    return [sup.submit_tokens(list(p), params) for p in prompts]


def _wait(seqs, timeout=120.0):
    deadline = time.monotonic() + timeout
    for s in seqs:
        assert s.done_event.wait(max(0.1, deadline - time.monotonic()))
        assert s.error is None, s.error
    return [list(s.generated_ids) for s in seqs]


@pytest.fixture
def drill(models):
    rng = np.random.default_rng(17)
    prompts = [rng.integers(3, 500, size=n).tolist() for n in (6, 9, 11)]
    sup = _supervised(models)
    sup.start()
    try:
        clean = _wait(_stream_all(sup, prompts))
        yield sup, prompts, clean
    finally:
        follower = [p for p in sup.core.mesh.followers]
        sup.close()
        assert all(_gone(p) for p in follower)


def test_follower_sigkill_mid_stream_rebuilds_and_resumes(drill):
    """The follower SIGKILLed once every stream has 3 tokens: rank 0's
    next collective raises on the closed peer, the supervisor contains
    the crash and rebuilds the group with a new follower, and every
    stream resumes to the clean run's tokens."""
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
    assert _wait(_stream_all(sup, prompts)) == clean


def test_rank0_fault_rebuilds_both_ranks_with_the_follower_kept(drill):
    """A ``decode_step`` fault on rank 0 (before the chunk is named to the
    follower): the rebuild is broadcast, so the same follower process
    frees and rebuilds its pool with its shard kept; the streams resume
    to the clean run's."""
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
    assert stats["steps"] > 0
    assert _wait(_stream_all(sup, prompts)) == clean


def test_no_follower_outlives_backend_shutdown(models):
    """The backend's shutdown stops the supervisor, the core and its
    followers, and destroys the process groups."""
    from vgate_tpu_torch.backends.torch_backend import TorchCUDABackend

    _, _, ckpt = models["tiny-dense"]
    backend = TorchCUDABackend()
    backend.load_model(_config("tiny-dense", ckpt))
    followers = list(backend.core.core.mesh.followers)
    assert len(followers) == 1 and followers[0].poll() is None
    out = backend.generate(["hello"], [SamplingParams(max_tokens=4,
                                                      temperature=0.0)])
    assert out[0].num_tokens == 4
    backend.shutdown()
    assert all(_gone(p, timeout=10) for p in followers)
    assert not torch.distributed.is_initialized()
