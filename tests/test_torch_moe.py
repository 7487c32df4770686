"""The port's MoE decoder (Mixtral family) vs the JAX package.

Inputs come from numpy seeds and go through both packages.  Tolerances:
``quantize_expert_stacked`` BIT FOR BIT (int8/uint8 values and f32
scales equal); ``_moe_mlp`` within 1e-5 in float32 (two frameworks' sum
orders), with plain, int8 and int4 experts, and one bf16 step of the
output with bf16 experts; forwards within 1e-4 in float32.  Most cases
use ``tiny-moe`` widened to 8 experts (top 2), whose capacity of about
T/2 DROPS tokens, which ``tiny-moe``'s 4 experts never do; the tests
check that tokens were dropped.  The engines must be greedy
token-identical, driven tick by tick by the test.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vgate_tpu.backends.base import SamplingParams as JSamplingParams
from vgate_tpu.config import load_config as j_load_config
from vgate_tpu.models import decoder as jdec
from vgate_tpu.models.specs import TINY_MOE as J_MOE
from vgate_tpu.ops import quant as jq
from vgate_tpu.runtime.engine_core import EngineCore as JEngineCore
from vgate_tpu.runtime.weights import load_or_init_params as j_init
from vgate_tpu.runtime.weights import (
    params_from_torch_state_dict as j_from_state_dict,
)
from vgate_tpu_torch.backends.base import SamplingParams
from vgate_tpu_torch.config import load_config
from vgate_tpu_torch.models import decoder as tdec
from vgate_tpu_torch.models.specs import TINY_MOE
from vgate_tpu_torch.ops import quant as tq
from vgate_tpu_torch.runtime.engine_core import EngineCore
from vgate_tpu_torch.runtime.weights import (
    params_from_jax,
    params_from_torch_state_dict,
)

# tiny-moe with 8 experts, top 2: capacity ~T/2, so tokens are dropped
J_MOE8 = dataclasses.replace(J_MOE, num_experts=8)
MOE8 = dataclasses.replace(TINY_MOE, num_experts=8)
SPECS = {"tiny-moe": (J_MOE, TINY_MOE), "e8": (J_MOE8, MOE8)}
F32_TOL = 1e-5
PS = 4


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


def _trees(jspec, tspec, bits=None, seed=0):
    """One JAX tree (quantized by the reference when ``bits``) and the
    port's copy of it."""
    jparams = jdec.init_params(jspec, jax.random.PRNGKey(seed), jnp.float32)
    if bits:
        jparams = jq.quantize_decoder_params(jparams, jspec, bits)
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams), tspec)


def _dropped(x, router, spec):
    """Assignments past their expert's capacity, by the reference's rule
    (numpy), for the flat tokens of ``x``."""
    xt = x.reshape(-1, x.shape[-1]).astype(np.float32)
    T, E, K = xt.shape[0], spec.num_experts, spec.experts_per_token
    capacity = max(4, int((T * K / E) * 2.0 + 0.5))
    top = np.argsort(-(xt @ router), axis=-1, kind="stable")[:, :K]
    counts = np.bincount(top.reshape(-1), minlength=E)
    return int(np.maximum(counts - capacity, 0).sum())


def _biased(router, x):
    """``router`` [D, E] pulled toward experts 0 and 1 for the tokens of
    ``x``, so more of them pick those two than their capacity takes."""
    sign = np.sign(x.reshape(-1, x.shape[-1]).mean(0))
    out = router.copy()
    out[:, 0] += 0.05 * sign
    out[:, 1] += 0.03 * sign
    return out


# ------------------------------------------------------- quantizers


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_expert_stacked_is_bit_identical(bits, dtype):
    rng = np.random.default_rng(bits)
    w = (rng.standard_normal((3, 4, 32, 24)) * 0.05).astype(np.float32)
    w[1, 2, :, 5] = 0.0  # an all-zero channel takes the 1e-8 floor
    tw = torch.from_numpy(w).to(getattr(torch, dtype))
    jw = jnp.asarray(w).astype(getattr(jnp, dtype))
    _assert_weights_equal(tq.quantize_expert_stacked(tw, bits),
                          jq.quantize_expert_stacked(jw, bits))


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_decoder_params_moe_branch_is_bit_identical(bits):
    """q/k/v/o per channel, gate/up/down per (expert, channel), the
    router and the embedding untouched."""
    jparams = jdec.init_params(J_MOE8, jax.random.PRNGKey(2), jnp.float32)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), MOE8)
    jquant = jq.quantize_decoder_params(jparams, J_MOE8, bits)
    ours = tq.quantize_decoder_params(tparams, MOE8, bits)
    for name in ("q", "k", "v", "o", "gate", "up", "down"):
        _assert_weights_equal(ours["layers"][name]["w"],
                              jquant["layers"][name]["w"])
    _assert_weights_equal(ours["lm_head"], jquant["lm_head"])
    np.testing.assert_array_equal(ours["layers"]["router"].numpy(),
                                  np.asarray(jquant["layers"]["router"]))


@pytest.mark.parametrize("quantization", [None, "int8", "int4"])
def test_init_params_quantizes_a_layer_at_a_time(quantization):
    """A MoE init with ``quantization`` equals drawing the whole tree and
    quantizing it afterwards (the draws are the same, a layer at a
    time), and its shapes are the reference's."""
    def init(q):
        gen = torch.Generator().manual_seed(3)
        return tdec.init_params(MOE8, gen, torch.float32, quantization=q)

    whole = init(None)
    got = init(quantization)
    if quantization:
        whole = tq.quantize_decoder_params(whole, MOE8,
                                           tq.BITS[quantization])
    for path, a, b in _leaf_pairs(got, whole):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    jtree = jdec.init_params(J_MOE8, jax.random.PRNGKey(0), jnp.float32)
    if quantization:
        jtree = jq.quantize_decoder_params(jtree, J_MOE8,
                                           tq.BITS[quantization])
    for path, a, b in _leaf_pairs(got, jtree):
        assert tuple(a.shape) == tuple(b.shape), path
    assert abs(float(init(None)["layers"]["gate"]["w"].std()) - 0.02) < 2e-3


def _leaf_pairs(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            yield from _leaf_pairs(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, tuple):
        assert type(a).__name__ == type(b).__name__, path
        for i, (x, y) in enumerate(zip(a, b)):
            yield f"{path}[{i}]", x, y
    else:
        yield path, a, b


# ------------------------------------------------------- the MoE layer


@pytest.mark.parametrize("bits", [None, 8, 4])
@pytest.mark.parametrize("spec", ["tiny-moe", "e8"])
def test_moe_mlp_matches_jax(spec, bits):
    """The dispatch, the expert products and the combine, float32,
    within 1e-5; with 8 experts the tokens overflow their experts'
    capacity (a router biased toward expert 0), so drops happen."""
    jspec, tspec = SPECS[spec]
    jparams, tparams = _trees(jspec, tspec, bits)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 16, tspec.hidden_size)).astype(np.float32)
    router = np.array(jparams["layers"]["router"][0])
    if spec == "e8":
        router = _biased(router, x)
        assert _dropped(x, router, tspec) > 0
    jl = jax.tree.map(lambda a: a[0], jparams["layers"])
    jl["router"] = jnp.asarray(router)
    tl = tdec.layer_params(tparams, 0)
    tl["router"] = torch.from_numpy(router)
    want = np.asarray(jdec._moe_mlp(jnp.asarray(x), jl, jspec))
    got = tdec._moe_mlp(torch.from_numpy(x), tl, tspec)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=F32_TOL)


def test_moe_mlp_bf16_experts_match_jax():
    """bf16 activations and bf16 expert weights (the batched product):
    within one bf16 step of the output, with tokens dropped."""
    jparams = jdec.init_params(J_MOE8, jax.random.PRNGKey(4), jnp.bfloat16)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), MOE8,
                              dtype=torch.bfloat16)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((4, 16, MOE8.hidden_size)).astype(np.float32)
    xb = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    router = np.asarray(jnp.asarray(_biased(
        _np(jparams["layers"]["router"][0]), xb)).astype(jnp.bfloat16)
        .astype(jnp.float32))
    assert _dropped(xb, router, MOE8) > 0
    jl = jax.tree.map(lambda a: a[0], jparams["layers"])
    jl["router"] = jnp.asarray(router).astype(jnp.bfloat16)
    tl = tdec.layer_params(tparams, 0)
    tl["router"] = torch.from_numpy(router).bfloat16()
    want = _np(jdec._moe_mlp(jnp.asarray(x).astype(jnp.bfloat16), jl,
                             J_MOE8))
    got = tdec._moe_mlp(torch.from_numpy(x).bfloat16(), tl, MOE8)
    assert got.dtype == torch.bfloat16
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=2 * scale * 2.0 ** -8, rtol=0)


def test_moe_mlp_ties_take_the_lower_expert():
    """Equal router probabilities: top-k takes the lower expert index,
    as ``lax.top_k`` does (a zero router makes every token a tie)."""
    jparams, tparams = _trees(J_MOE8, MOE8)
    jl = jax.tree.map(lambda a: a[0], jparams["layers"])
    jl["router"] = jnp.zeros_like(jl["router"])
    tl = tdec.layer_params(tparams, 0)
    tl["router"] = torch.zeros_like(tl["router"])
    x = np.random.default_rng(9).standard_normal(
        (2, 8, MOE8.hidden_size)).astype(np.float32)
    want = np.asarray(jdec._moe_mlp(jnp.asarray(x), jl, J_MOE8))
    got = tdec._moe_mlp(torch.from_numpy(x), tl, MOE8).numpy()
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)


# ------------------------------------------------------- the forwards


def _pools(spec, P):
    shape = (spec.num_layers, spec.num_kv_heads, P, PS, spec.head_dim)
    return np.zeros(shape, np.float32), np.zeros(shape, np.float32)


@pytest.mark.parametrize("bits", [None, 8, 4])
@pytest.mark.parametrize("spec", ["tiny-moe", "e8"])
def test_forwards_match_jax_at_padded_shapes(spec, bits):
    """The prompt pass over a padded [B, S] batch (pad rows compete for
    capacity), a suffix pass, and decode steps with an idle slot: the
    logits and the pools, float32."""
    jspec, tspec = SPECS[spec]
    jparams, tparams = _trees(jspec, tspec, bits, seed=5)
    rng = np.random.default_rng(1)
    B, S, pps = 2, 16, 10
    P = 1 + B * pps
    pt = (np.arange(B * pps, dtype=np.int32).reshape(B, pps) + 1)
    tokens = rng.integers(3, tspec.vocab_size, (B, S)).astype(np.int32)
    tokens[0, 9:] = 0  # the engine's pad token
    lens = np.array([9, 16], np.int32)
    k0, v0 = _pools(tspec, P)
    jl, jk, jv = jdec.prefill_forward(
        jparams, jspec, jnp.asarray(tokens), jnp.asarray(lens),
        jnp.asarray(k0), jnp.asarray(v0), jnp.asarray(pt[:, : S // PS]))
    tk, tv = torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy())
    tl = tdec.prefill_forward(
        tparams, tspec, torch.from_numpy(tokens), torch.from_numpy(lens),
        tk, tv, torch.from_numpy(pt[:, : S // PS]))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-4)

    # a suffix pass of 8 rows from position 16 (page-aligned)
    suffix = rng.integers(3, tspec.vocab_size, (B, 8)).astype(np.int32)
    prefix = np.array([16, 16], np.int32)
    slens = np.array([5, 8], np.int32)
    spt, cpt = pt[:, 4:6], pt[:, :6]
    jl, jk, jv = jdec.prefill_suffix_forward(
        jparams, jspec, jnp.asarray(suffix), jnp.asarray(prefix),
        jnp.asarray(slens), jk, jv, jnp.asarray(spt), jnp.asarray(cpt))
    tl = tdec.prefill_suffix_forward(
        tparams, tspec, torch.from_numpy(suffix), torch.from_numpy(prefix),
        torch.from_numpy(slens), tk, tv, torch.from_numpy(spt),
        torch.from_numpy(cpt))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)

    positions = prefix + slens
    nxt = np.argmax(np.asarray(jl), -1).astype(np.int32)
    for active in ([True, True], [True, False]):
        act = np.array(active)
        jl, jk, jv = jdec.decode_forward(
            jparams, jspec, jnp.asarray(nxt), jnp.asarray(positions), jk,
            jv, jnp.asarray(pt), active=jnp.asarray(act))
        tl = tdec.decode_forward(
            tparams, tspec, torch.from_numpy(nxt),
            torch.from_numpy(positions), tk, tv, torch.from_numpy(pt),
            active=torch.from_numpy(act))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-4)
        nxt = np.argmax(np.asarray(jl), -1).astype(np.int32)
        positions = positions + act.astype(np.int32)


# ------------------------------------------------------- weights


@pytest.mark.parametrize("bits", [None, 8, 4])
def test_params_from_jax_carries_a_moe_tree(bits):
    """Router, expert stacks and (quantized) their [L, E, out] scales
    carry over leaf for leaf."""
    jparams, tparams = _trees(J_MOE8, MOE8, bits)
    assert tuple(tparams["layers"]["router"].shape) == (2, 64, 8)
    for path, t, j in _leaf_pairs(tparams, jparams):
        if t.dtype in (torch.int8, torch.uint8):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        else:
            np.testing.assert_array_equal(_np(t), _np(j), err_msg=path)
    gate = tparams["layers"]["gate"]["w"]
    if bits:
        assert tuple(gate.scale.shape) == (2, 8, MOE8.intermediate_size)


def _mixtral_state_dict(spec, seed=0):
    """HF ``MixtralForCausalLM`` names, linear weights [out, in]."""
    g = torch.Generator().manual_seed(seed)
    D, F, E = spec.hidden_size, spec.intermediate_size, spec.num_experts
    H, KV, hd = spec.num_heads, spec.num_kv_heads, spec.head_dim

    def w(*shape):
        return torch.randn(shape, generator=g) * 0.02

    sd = {"model.embed_tokens.weight": w(spec.vocab_size, D),
          "model.norm.weight": 1 + w(D), "lm_head.weight": w(spec.vocab_size, D)}
    for i in range(spec.num_layers):
        p = f"model.layers.{i}."
        sd[p + "input_layernorm.weight"] = 1 + w(D)
        sd[p + "post_attention_layernorm.weight"] = 1 + w(D)
        sd[p + "self_attn.q_proj.weight"] = w(H * hd, D)
        sd[p + "self_attn.k_proj.weight"] = w(KV * hd, D)
        sd[p + "self_attn.v_proj.weight"] = w(KV * hd, D)
        sd[p + "self_attn.o_proj.weight"] = w(D, H * hd)
        sd[p + "block_sparse_moe.gate.weight"] = w(E, D)
        for e in range(E):
            q = f"{p}block_sparse_moe.experts.{e}."
            sd[q + "w1.weight"] = w(F, D)
            sd[q + "w2.weight"] = w(D, F)
            sd[q + "w3.weight"] = w(F, D)
    return sd


@pytest.mark.parametrize("quantization", [None, "int8", "int4"])
def test_params_from_getter_maps_mixtral_names(quantization):
    """The Mixtral names against the reference's
    ``params_from_torch_state_dict``; with ``quantization`` the tree
    quantized while it loads equals the reference's tree quantized
    afterwards, bit for bit."""
    sd = _mixtral_state_dict(MOE8)
    ref = j_from_state_dict(J_MOE8, sd)
    ours = params_from_torch_state_dict(MOE8, sd, dtype=torch.float32)
    for path, t, j in _leaf_pairs(ours, ref):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=path)
    if quantization:
        from vgate_tpu_torch.runtime.weights import params_from_getter

        bits = tq.BITS[quantization]
        jquant = jq.quantize_decoder_params(
            jax.tree.map(jnp.asarray, ref), J_MOE8, bits)
        got = params_from_getter(MOE8, lambda n: sd[n].detach(),
                                 dtype=torch.float32,
                                 quantization=quantization)
        for name in ("q", "o", "gate", "up", "down"):
            _assert_weights_equal(got["layers"][name]["w"],
                                  jquant["layers"][name]["w"])
        _assert_weights_equal(got["lm_head"], jquant["lm_head"])


def test_hf_mixtral_parity_through_state_dict():
    """The port's prompt pass against transformers' MixtralForCausalLM
    on ``tiny-moe`` (4 experts: no token is dropped, as in HF)."""
    transformers = pytest.importorskip("transformers")
    spec = TINY_MOE
    config = transformers.MixtralConfig(
        vocab_size=spec.vocab_size, hidden_size=spec.hidden_size,
        num_hidden_layers=spec.num_layers,
        num_attention_heads=spec.num_heads,
        num_key_value_heads=spec.num_kv_heads, head_dim=spec.head_dim,
        intermediate_size=spec.intermediate_size,
        num_local_experts=spec.num_experts,
        num_experts_per_tok=spec.experts_per_token,
        rope_theta=spec.rope_theta, rms_norm_eps=spec.rms_eps,
        tie_word_embeddings=False, sliding_window=None,
    )
    torch.manual_seed(0)
    model = transformers.MixtralForCausalLM(config).eval()
    params = params_from_torch_state_dict(spec, model.state_dict(),
                                          dtype=torch.float32)
    rng = np.random.default_rng(3)
    S = 12
    ids = rng.integers(3, spec.vocab_size, (1, S))
    with torch.no_grad():
        want = model(torch.from_numpy(ids)).logits[0, -1].numpy()
    k0, v0 = _pools(spec, 1 + S // PS)
    got = tdec.prefill_forward(
        params, spec, torch.from_numpy(ids.astype(np.int32)),
        torch.tensor([S], dtype=torch.int32), torch.from_numpy(k0),
        torch.from_numpy(v0),
        torch.arange(1, 1 + S // PS, dtype=torch.int32)[None])
    np.testing.assert_allclose(got[0].numpy(), want, atol=1e-4)


# ------------------------------------------------------- the engines


class Pair:
    """A JAX engine and a port engine with one ``tiny-moe`` tree, the
    prefix cache on (COW at 2 tokens), a pool tight enough to preempt.
    Each wave is queued whole, then the test ticks each engine to the
    end (no engine threads)."""

    def __init__(self, model, int8_native=False):
        model = {"model_id": "tiny-moe", "dtype": "float32",
                 "max_model_len": 96, **model}
        shapes = {"kv_num_pages": 40, "kv_page_size": PS,
                  "max_batch_slots": 3, "prefill_buckets": [8, 16, 32],
                  "prefix_cache": {"enabled": True, "cow_min_tokens": 2},
                  "int8_native": int8_native}
        j_cfg = j_load_config(
            model={**model, "engine_type": "jax_tpu"},
            tpu={"dp": 1, "tp": 1, "ep": 1, "sp": 1, "use_pallas": False,
                 **shapes},
            scheduler={"max_queue_size": 16}, integrity={"enabled": False},
            logging={"level": "ERROR"},
        )
        t_cfg = load_config(
            model={**model, "engine_type": "torch_cuda"},
            device={"device": "cpu", **shapes},
            scheduler={"max_queue_size": 16}, logging={"level": "ERROR"},
        )
        jparams = j_init(J_MOE, None, np.float32)
        self.j = JEngineCore(j_cfg, params=jparams,
                             devices=jax.devices()[:1])
        self.t = EngineCore(t_cfg, params=params_from_jax(
            jax.tree.map(np.asarray, jparams), TINY_MOE))

    def wave(self, prompts, tokens):
        outs = []
        for core, sp in ((self.j, JSamplingParams), (self.t, SamplingParams)):
            params = sp(max_tokens=tokens, min_tokens=tokens,
                        temperature=0.0)
            seqs = [core.submit_tokens(list(p), params) for p in prompts]
            for _ in range(10_000):
                if all(seq.done_event.is_set() for seq in seqs):
                    break
                core._tick()
            assert all(seq.done_event.is_set() for seq in seqs)
            outs.append([list(s.generated_ids) for s in seqs])
        assert outs[1] == outs[0]
        return outs[1]

    def stop(self):
        self.j.stop()
        self.t.stop()


@pytest.mark.parametrize(
    "model,int8_native",
    [({}, False), ({"quantization": "int8"}, False),
     ({"quantization": "int4"}, False), ({"quantization": "int8"}, True)],
    ids=["plain", "int8", "int4", "int8_native"],
)
def test_engine_token_identical_to_jax(model, int8_native):
    """48 greedy tokens for a concurrent batch: a prefix hit, a
    copy-on-write divergence and a third prompt in a pool that cannot
    hold all three to the end (preemption)."""
    pair = Pair(model, int8_native)
    try:
        rng = np.random.default_rng(29)
        base = rng.integers(3, TINY_MOE.vocab_size, size=14).tolist()
        pair.wave([base], tokens=4)
        hit, cow, other = pair.wave(
            [base, base[:10] + [21, 22, 23, 24, 25],
             rng.integers(3, 500, size=13).tolist()],
            tokens=48,
        )
        assert len(hit) == len(cow) == len(other) == 48
        t, j = pair.t.get_stats(), pair.j.get_stats()
        tpc, jpc = (t["scheduler"]["prefix_cache"],
                    j["scheduler"]["prefix_cache"])
        for key in ("hit_tokens", "cow_copies"):
            assert tpc[key] == jpc[key], key
        assert tpc["hit_tokens"] > 0 and tpc["cow_copies"] > 0
        assert t["scheduler"]["preemptions"] == j["scheduler"]["preemptions"]
        assert t["running"] == 0 and t["used_pages"] == 0
        assert pair.t.spec.int8_native == pair.j.spec.int8_native
        gate = pair.t.params["layers"]["gate"]["w"]
        if model:
            assert isinstance(gate, tq.PackedQTensor
                              if model["quantization"] == "int4"
                              else tq.QTensor)
            assert gate.scale.shape == (2, 4, TINY_MOE.intermediate_size)
    finally:
        pair.stop()
