"""The port's weight quantization (ops/quant.py, the K4/K5 plain versions)
and its quantized serving engine vs the JAX package.

Inputs come from a numpy seed and go through both packages.  Tolerances:
``quantize_tensor``, ``quantize_stacked`` and ``pack_int4`` are compared
BIT FOR BIT (int8/uint8 values equal, f32 scales equal), and so are the
quantized parameter trees; the K4/K5 plain versions and
``weighted_einsum`` agree with the reference to atol = rtol = 2e-4 in
f32 (the Pallas kernels' own bound, tests/test_pallas_kernels.py) and
2e-2 with bf16 activations (one bf16 step of the output).  The engines
must be greedy token-identical.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from reference_uploads import private_uploads
from vgate_tpu.backends.base import SamplingParams as JSamplingParams
from vgate_tpu.config import load_config as j_load_config
from vgate_tpu.models import decoder as jdec
from vgate_tpu.models.specs import TINY_DENSE as J_TINY
from vgate_tpu.ops import quant as jq
from vgate_tpu.ops.pallas.quant_matmul import (
    int4_matmul_pallas,
    int8_matmul_pallas,
)
from vgate_tpu.runtime.engine_core import EngineCore as JEngineCore
from vgate_tpu.runtime.weights import load_or_init_params as j_init
from vgate_tpu_torch.backends.base import SamplingParams
from vgate_tpu_torch.config import load_config
from vgate_tpu_torch.models.specs import TINY_DENSE
from vgate_tpu_torch.ops import quant as tq
from vgate_tpu_torch.ops.kernels import quant_matmul
from vgate_tpu_torch.runtime.engine_core import EngineCore
from vgate_tpu_torch.runtime.weights import params_from_jax

F32_TOL = 2e-4
BF16_TOL = 2e-2


def _np(x):
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    if x.dtype == jnp.bfloat16:
        x = x.astype(jnp.float32)
    return np.asarray(x)


def _assert_weights_equal(t, j):
    assert type(t).__name__ == type(j).__name__
    for tpart, jpart in zip(t, j):
        assert str(tpart.dtype).split(".")[-1] == str(jpart.dtype)
        np.testing.assert_array_equal(tpart.numpy(), np.asarray(jpart))


# ------------------------------------------------------- quantizers


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape,scale", [((64, 128), 0.02), ((32, 48), 3.0)])
def test_quantize_tensor_is_bit_identical(bits, shape, scale):
    rng = np.random.default_rng(shape[0] + bits)
    w = (rng.normal(size=shape) * scale).astype(np.float32)
    w[:, 0] = 0.0  # an all-zero channel: scale 1e-8 / qmax
    _assert_weights_equal(tq.quantize_tensor(torch.from_numpy(w), bits),
                          jq.quantize_tensor(jnp.asarray(w), bits))


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_stacked_is_bit_identical(bits):
    rng = np.random.default_rng(bits)
    w = np.stack([rng.normal(size=(16, 24)) * 0.01,
                  rng.normal(size=(16, 24)) * 10.0,
                  rng.normal(size=(16, 24))]).astype(np.float32)
    t = tq.quantize_stacked(torch.from_numpy(w), bits)
    _assert_weights_equal(t, jq.quantize_stacked(jnp.asarray(w), bits))
    assert t.scale.shape == (3, 24)


def test_quantize_bf16_weights_is_bit_identical():
    rng = np.random.default_rng(11)
    w = (rng.normal(size=(2, 64, 32)) * 0.02).astype(np.float32)
    tw = torch.from_numpy(w).to(torch.bfloat16)
    jw = jnp.asarray(w).astype(jnp.bfloat16)
    for bits in (8, 4):
        _assert_weights_equal(tq.quantize_stacked(tw, bits),
                              jq.quantize_stacked(jw, bits))


def test_pack_int4_is_bit_identical_and_unpacks_exactly():
    rng = np.random.default_rng(3)
    vals = rng.integers(-7, 8, size=(6, 10, 32)).astype(np.int8)
    packed = tq.pack_int4(torch.from_numpy(vals))
    assert packed.dtype == torch.uint8 and packed.shape == (6, 5, 32)
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jq.pack_int4(jnp.asarray(vals))))
    np.testing.assert_array_equal(tq.unpack_int4(packed).numpy(), vals)
    with pytest.raises(ValueError, match="even"):
        tq.pack_int4(torch.zeros((3, 4), dtype=torch.int8))


# ---------------------------------------- K4 / K5 plain versions


def _weights(in_dim, out, bits, seed):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(in_dim, out)).astype(np.float32) * 0.05
    return (tq.quantize_tensor(torch.from_numpy(w), bits),
            jq.quantize_tensor(jnp.asarray(w), bits), rng)


@pytest.mark.parametrize(
    "lead,in_dim,out", [((4,), 64, 128), ((2, 8), 128, 64), ((5,), 256, 128)]
)
def test_int8_plain_matches_pallas_interpret(lead, in_dim, out):
    tw, jw, rng = _weights(in_dim, out, 8, 31)
    x = rng.normal(size=(*lead, in_dim)).astype(np.float32)
    got = quant_matmul.int8_matmul(torch.from_numpy(x), tw.q, tw.scale)
    expect = int8_matmul_pallas(jnp.asarray(x), jw.q, jw.scale,
                                interpret=True)
    assert got.shape == (*lead, out)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect),
                               atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize(
    "lead,in_dim,out", [((4,), 64, 128), ((2, 8), 64, 64), ((12,), 256, 128)]
)
def test_int4_plain_matches_pallas_interpret(lead, in_dim, out):
    tw, jw, rng = _weights(in_dim, out, 4, 37)
    x = rng.normal(size=(*lead, in_dim)).astype(np.float32)
    got = quant_matmul.int4_matmul(torch.from_numpy(x), tw.q_packed,
                                   tw.scale)
    expect = int4_matmul_pallas(jnp.asarray(x), jw.q_packed, jw.scale,
                                interpret=True)
    assert got.shape == (*lead, out)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect),
                               atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("bits", [8, 4])
def test_plain_bf16_in_f32_out_matches_pallas_interpret(bits):
    """The lm_head class: bf16 activations, f32 out, ragged rows; the
    scale multiplies the f32 sum before the cast in both."""
    tw, jw, rng = _weights(64, 128, bits, 3)
    x = rng.normal(size=(5, 64)).astype(np.float32)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    if bits == 8:
        got = quant_matmul.int8_matmul(tx, tw.q, tw.scale,
                                       out_dtype=torch.float32)
        expect = int8_matmul_pallas(jx, jw.q, jw.scale,
                                    out_dtype=jnp.float32, interpret=True)
    else:
        got = quant_matmul.int4_matmul(tx, tw.q_packed, tw.scale,
                                       out_dtype=torch.float32)
        expect = int4_matmul_pallas(jx, jw.q_packed, jw.scale,
                                    out_dtype=jnp.float32, interpret=True)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(expect),
                               atol=F32_TOL, rtol=F32_TOL)
    bf = (quant_matmul.int8_matmul(tx, tw.q, tw.scale) if bits == 8 else
          quant_matmul.int4_matmul(tx, tw.q_packed, tw.scale))
    assert bf.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(bf), np.asarray(expect), atol=BF16_TOL,
                               rtol=BF16_TOL)


# ------------------------------------------------- weighted_einsum


@pytest.mark.parametrize(
    "subscripts,weight,pref",
    [
        ("...d,dh->...h", "plain", None),
        ("...d,dh->...h", "int8", None),
        ("...d,dh->...h", "int4", None),
        ("...d,dv->...v", "int8", "f32"),
        ("...d,dv->...v", "int4", "f32"),
        ("bd,dh->bh", "int8", None),  # not the kernels' form: plain branch
        ("bd,dh->bh", "int4", None),
    ],
)
def test_weighted_einsum_matches_jax(subscripts, weight, pref):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 64)).astype(np.float32)
    w = (rng.normal(size=(64, 32)) * 0.02).astype(np.float32)
    tw, jw = torch.from_numpy(w), jnp.asarray(w)
    if weight != "plain":
        bits = 8 if weight == "int8" else 4
        tw, jw = tq.quantize_tensor(tw, bits), jq.quantize_tensor(jw, bits)
    got = tq.weighted_einsum(
        subscripts, torch.from_numpy(x), tw,
        preferred_element_type=torch.float32 if pref else None,
    )
    expect = jq.weighted_einsum(
        subscripts, jnp.asarray(x), jw,
        preferred_element_type=jnp.float32 if pref else None,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), atol=F32_TOL,
                               rtol=F32_TOL)


@pytest.mark.parametrize("bits", [8, 4])
def test_weighted_einsum_bf16_plain_branch_on_cpu(bits):
    """bf16 activations in a form the kernels do not take: the
    reference's plain branch (narrow ints cast to bf16, the bf16 scale
    multiplied into the bf16 output), within one bf16 step."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 3, 64)).astype(np.float32)
    w = (rng.normal(size=(64, 16)) * 0.1).astype(np.float32)
    got = tq.weighted_einsum(
        "bsd,dh->bsh", torch.from_numpy(x).to(torch.bfloat16),
        tq.quantize_tensor(torch.from_numpy(w), bits),
    )
    expect = jq.weighted_einsum(
        "bsd,dh->bsh", jnp.asarray(x).astype(jnp.bfloat16),
        jq.quantize_tensor(jnp.asarray(w), bits),
    )
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(expect), atol=BF16_TOL,
                               rtol=BF16_TOL)


# ------------------------------------------- parameter trees


@pytest.mark.parametrize("bits", [8, 4])
def test_params_from_jax_carries_a_quantized_tree(bits):
    """A quantized JAX tree carries over leaf for leaf (int8/uint8 values
    and f32 scales untouched), and the port's own quantize_decoder_params
    on the carried f32 tree gives the same tree bit for bit."""
    jparams = jdec.init_params(J_TINY, jax.random.PRNGKey(0), jnp.float32)
    jquant = jq.quantize_decoder_params(jparams, J_TINY, bits)
    carried = params_from_jax(jax.tree.map(np.asarray, jquant), TINY_DENSE)
    ours = tq.quantize_decoder_params(
        params_from_jax(jax.tree.map(np.asarray, jparams), TINY_DENSE),
        TINY_DENSE, bits,
    )
    for name in ("q", "k", "v", "o", "gate", "up", "down"):
        j = jquant["layers"][name]["w"]
        _assert_weights_equal(carried["layers"][name]["w"], j)
        _assert_weights_equal(ours["layers"][name]["w"], j)
    _assert_weights_equal(carried["lm_head"], jquant["lm_head"])
    _assert_weights_equal(ours["lm_head"], jquant["lm_head"])
    np.testing.assert_array_equal(ours["embed"].numpy(),
                                  np.asarray(jquant["embed"]))


def _qwen_state_dict(spec, seed=0):
    """HF ``Qwen2ForCausalLM`` names, linear weights [out, in]."""
    g = torch.Generator().manual_seed(seed)
    D, F = spec.hidden_size, spec.intermediate_size
    H, KV, hd = spec.num_heads, spec.num_kv_heads, spec.head_dim

    def w(*shape):
        return torch.randn(shape, generator=g) * 0.02

    sd = {"model.embed_tokens.weight": w(spec.vocab_size, D),
          "model.norm.weight": 1 + w(D),
          "lm_head.weight": w(spec.vocab_size, D)}
    for i in range(spec.num_layers):
        p = f"model.layers.{i}."
        sd[p + "input_layernorm.weight"] = 1 + w(D)
        sd[p + "post_attention_layernorm.weight"] = 1 + w(D)
        for name, out in (("q", H * hd), ("k", KV * hd), ("v", KV * hd)):
            sd[p + f"self_attn.{name}_proj.weight"] = w(out, D)
            sd[p + f"self_attn.{name}_proj.bias"] = w(out)
        sd[p + "self_attn.o_proj.weight"] = w(D, H * hd)
        sd[p + "mlp.gate_proj.weight"] = w(F, D)
        sd[p + "mlp.up_proj.weight"] = w(F, D)
        sd[p + "mlp.down_proj.weight"] = w(D, F)
    return sd


@pytest.mark.parametrize("quantization", ["int8", "int4"])
def test_params_from_getter_quantizes_a_dense_tree_while_loading(
        quantization):
    """A dense checkpoint with ``quantization`` is quantized a layer at
    a time as it loads: bit for bit the reference's tree from the same
    state dict, quantized afterwards."""
    from vgate_tpu.runtime.weights import (
        params_from_torch_state_dict as j_from_state_dict,
    )
    from vgate_tpu_torch.runtime.weights import params_from_getter

    assert TINY_DENSE.qkv_bias and not TINY_DENSE.tie_embeddings
    sd = _qwen_state_dict(TINY_DENSE)
    jquant = jq.quantize_decoder_params(
        jax.tree.map(jnp.asarray, j_from_state_dict(J_TINY, sd)), J_TINY,
        tq.BITS[quantization])
    got = params_from_getter(TINY_DENSE, lambda n: sd[n].detach(),
                             dtype=torch.float32, quantization=quantization)
    for name in ("q", "k", "v", "o", "gate", "up", "down"):
        _assert_weights_equal(got["layers"][name]["w"],
                              jquant["layers"][name]["w"])
    _assert_weights_equal(got["lm_head"], jquant["lm_head"])
    np.testing.assert_array_equal(got["layers"]["q"]["b"].numpy(),
                                  np.asarray(jquant["layers"]["q"]["b"]))


# ------------------------------------------------ the engines


class Pair:
    """A JAX engine and a port engine with one weight tree, the prefix
    cache on (COW at 2 tokens), a pool tight enough to preempt.

    The test drives each engine's tick itself, with no engine thread:
    every request of a wave is queued before the first tick, so
    admission, chunking and preemption follow the same event sequence
    in both engines whatever the machine's load (with threads, a busy
    host can split a wave across ticks in one engine and not the other,
    and a recompute at another point rounds differently)."""

    def __init__(self, model, kv_cache):
        model = {"model_id": "tiny-dense", "dtype": "float32",
                 "max_model_len": 96, **model}
        shapes = {"kv_num_pages": 40, "kv_page_size": 4,
                  "max_batch_slots": 3, "prefill_buckets": [8, 16, 32],
                  "prefix_cache": {"enabled": True, "cow_min_tokens": 2}}
        j_cfg = j_load_config(
            model={**model, "engine_type": "jax_tpu"}, kv_cache=kv_cache,
            tpu={"dp": 1, "tp": 1, "ep": 1, "sp": 1, "use_pallas": False,
                 **shapes},
            scheduler={"max_queue_size": 16}, integrity={"enabled": False},
            logging={"level": "ERROR"},
        )
        t_cfg = load_config(
            model={**model, "engine_type": "torch_cuda"}, kv_cache=kv_cache,
            device={"device": "cpu", **shapes},
            scheduler={"max_queue_size": 16}, logging={"level": "ERROR"},
        )
        jparams = j_init(J_TINY, None, np.float32)
        self.j = JEngineCore(j_cfg, params=jparams,
                             devices=jax.devices()[:1])
        self.t = EngineCore(
            t_cfg,
            params=params_from_jax(jax.tree.map(np.asarray, jparams),
                                   TINY_DENSE),
        )

    def wave(self, prompts, tokens):
        outs = []
        for core, sp in ((self.j, JSamplingParams), (self.t, SamplingParams)):
            params = sp(max_tokens=tokens, min_tokens=tokens,
                        temperature=0.0)
            # the JAX engine's page-table uploads without their race
            # (tests/reference_uploads.py)
            with private_uploads():
                seqs = [core.submit_tokens(list(p), params) for p in prompts]
                for _ in range(10_000):
                    if all(seq.done_event.is_set() for seq in seqs):
                        break
                    core._tick()
            assert all(seq.done_event.is_set() for seq in seqs)
            outs.append([list(s.generated_ids) for s in seqs])
        assert outs[1] == outs[0]
        return outs[1]


@pytest.mark.parametrize(
    "model,kv_cache",
    [({}, {"dtype": "int8"}),
     ({"quantization": "int8"}, {}),
     ({"quantization": "int4"}, {"dtype": "int8"})],
    ids=["int8_kv", "int8_weights", "int4_weights_int8_kv"],
)
def test_engine_token_identical_to_jax(model, kv_cache):
    """64 greedy tokens for a concurrent batch: a prefix hit, a
    copy-on-write divergence and a third prompt, in a 39-page pool that
    cannot hold all three to the end (preemption).  int8-KV runs are held
    to the reference's own int8 output, never to bf16 identity."""
    pair = Pair(model, kv_cache)
    rng = np.random.default_rng(23)
    base = rng.integers(3, TINY_DENSE.vocab_size, size=14).tolist()
    pair.wave([base], tokens=4)  # cold: the tree holds base's pages
    hit, cow, other = pair.wave(
        [base, base[:10] + [21, 22, 23, 24, 25],
         rng.integers(3, 500, size=13).tolist()],
        tokens=64,
    )
    assert len(hit) == len(cow) == len(other) == 64
    t = pair.t.get_stats()
    j = pair.j.get_stats()
    tpc, jpc = t["scheduler"]["prefix_cache"], j["scheduler"][
        "prefix_cache"]
    for key in ("hit_tokens", "cow_copies"):
        assert tpc[key] == jpc[key], key
    assert tpc["hit_tokens"] > 0 and tpc["cow_copies"] > 0
    assert t["scheduler"]["preemptions"] > 0
    assert t["scheduler"]["preemptions"] == j["scheduler"]["preemptions"]
    assert t["running"] == 0 and t["used_pages"] == 0
    assert t["kv_dtype"] == ("int8" if kv_cache else "f32")
    w = pair.t.params["layers"]["q"]["w"]
    if model:
        assert isinstance(w, tq.PackedQTensor if model["quantization"]
                          == "int4" else tq.QTensor)
