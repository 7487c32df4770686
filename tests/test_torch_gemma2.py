"""The Gemma-2 family in the port vs the JAX package, on the CPU.

``tiny-gemma2`` (2 layers: layer 0 with a sliding window of 8, layer 1
global; softcaps 50/30; query scale 16^-0.5; head dim 32 so q_dim 128 !=
hidden 64; tied embeddings; GELU-tanh; unit-offset sandwich norms):

* the prompt pass, decode steps across the window and the suffix pass
  (aligned and copy-on-write) against the JAX forwards from one tree
  (``params_from_jax``), fp32, atol = rtol = 2e-5;
* HF ``Gemma2ForCausalLM`` parity through ``params_from_torch_state_dict``
  (the pattern of tests/test_model_parity.py, atol = rtol = 2e-4);
* ``_embed`` and ``rms_norm(unit_offset=True)`` in bf16, bit for bit;
* ``init_params`` and ``quantize_decoder_params`` on the Gemma layout;
* the port's ``EngineCore`` against the JAX ``EngineCore``: greedy
  token-identical over 64 tokens with a prefix hit, a copy-on-write
  divergence, chunked prefill and a preemption, with model-dtype pools
  and ``decode_block_slots`` 1 or 2, and with int8 weights + int8 KV.
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
from vgate_tpu.models.specs import GEMMA2_9B as J_GEMMA9B
from vgate_tpu.models.specs import TINY_GEMMA2 as J_SPEC
from vgate_tpu.ops import quant as jq
from vgate_tpu.ops.kv_quant import copy_page_prefix as j_copy_page_prefix
from vgate_tpu.ops.norms import rms_norm as j_rms_norm
from vgate_tpu.runtime.engine_core import EngineCore as JEngineCore
from vgate_tpu.runtime.weights import load_or_init_params as j_init
from vgate_tpu_torch.backends.base import SamplingParams
from vgate_tpu_torch.config import load_config
from vgate_tpu_torch.models import decoder as tdec
from vgate_tpu_torch.models.specs import GEMMA2_9B, TINY_GEMMA2 as SPEC
from vgate_tpu_torch.ops import quant as tq
from vgate_tpu_torch.ops.kv_quant import copy_page_prefix
from vgate_tpu_torch.ops.norms import rms_norm
from vgate_tpu_torch.runtime.engine_core import EngineCore
from vgate_tpu_torch.runtime.weights import (
    params_from_jax,
    params_from_torch_state_dict,
)

TOL = 2e-5
HF_TOL = 2e-4  # tests/test_model_parity.py's bound
PS = 4


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _params():
    params = jdec.init_params(J_SPEC, jax.random.PRNGKey(3), jnp.float32)
    return params, params_from_jax(jax.tree.map(np.asarray, params), SPEC)


def _pools(P, seed):
    rng = np.random.default_rng(seed)
    shape = (SPEC.num_layers, SPEC.num_kv_heads, P, PS, SPEC.head_dim)
    # nonzero content: a write that lands in the wrong slot shows
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


def _close(got, expect):
    np.testing.assert_allclose(np.asarray(got), np.asarray(expect), atol=TOL,
                               rtol=TOL)


# -------------------------------------------------------------- forwards


def test_prefill_and_decode_across_the_window_match_jax():
    """A 12-token prompt beside a 7-token one, then three decode steps
    (positions 12..14, beyond layer 0's window of 8; slot 1 idle on the
    last): logits and every written page."""
    jparams, tparams = _params()
    rng = np.random.default_rng(0)
    B, S, pps = 2, 16, 8
    tokens = rng.integers(3, SPEC.vocab_size, size=(B, S)).astype(np.int32)
    lens = np.array([12, 7], np.int32)
    pt = (np.arange(B * pps, dtype=np.int32).reshape(B, pps) + 1)
    k0, v0 = _pools(1 + B * pps, 1)
    j_logits, jk, jv = jdec.prefill_forward(
        jparams, J_SPEC, jnp.asarray(tokens), jnp.asarray(lens),
        jnp.asarray(k0), jnp.asarray(v0), jnp.asarray(pt[:, : S // PS]),
    )
    tk, tv = _t(k0.copy()), _t(v0.copy())
    t_logits = tdec.prefill_forward(
        tparams, SPEC, _t(tokens), _t(lens), tk, tv, _t(pt[:, : S // PS])
    )
    _close(t_logits, j_logits)
    positions = lens.copy()
    nxt = np.argmax(np.asarray(j_logits), axis=-1).astype(np.int32)
    for step, active in enumerate(([True, True], [True, True],
                                   [True, False])):
        act = np.array(active)
        j_logits, jk, jv = jdec.decode_forward(
            jparams, J_SPEC, jnp.asarray(nxt), jnp.asarray(positions), jk,
            jv, jnp.asarray(pt), active=jnp.asarray(act),
        )
        t_logits = tdec.decode_forward(
            tparams, SPEC, _t(nxt), _t(positions), tk, tv, _t(pt),
            active=_t(act),
        )
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                                   atol=TOL, rtol=TOL,
                                   err_msg=f"decode step {step}")
        nxt = np.argmax(np.asarray(j_logits), axis=-1).astype(np.int32)
        positions = positions + act.astype(np.int32)
    _close(tk[:, :, 1:], jk[:, :, 1:])
    _close(tv[:, :, 1:], jv[:, :, 1:])


def _both_prefill(jparams, tparams, tokens, pages, jk, jv, tk, tv):
    S = len(pages) * PS
    tok = np.zeros((1, S), np.int32)
    tok[0, : len(tokens)] = tokens
    sl = np.array([len(tokens)], np.int32)
    pt = np.array([pages], np.int32)
    _, jk, jv = jdec.prefill_forward(
        jparams, J_SPEC, jnp.asarray(tok), jnp.asarray(sl), jk, jv,
        jnp.asarray(pt),
    )
    tdec.prefill_forward(tparams, SPEC, _t(tok), _t(sl), tk, tv, _t(pt))
    return jk, jv


@pytest.mark.parametrize("unaligned", [False, True], ids=["aligned", "cow"])
def test_suffix_forward_matches_jax(unaligned):
    """A resident prefix of 12 tokens (aligned: 3 whole pages) or 10
    tokens (copy-on-write: 2 pages + 2 tokens copied into an own page),
    then a suffix pass of 10 tokens whose rows reach past the window."""
    jparams, tparams = _params()
    rng = np.random.default_rng(5 + unaligned)
    prompt = rng.integers(3, SPEC.vocab_size, size=22).tolist()
    k0, v0 = _pools(16, 6)
    jk, jv = jnp.asarray(k0), jnp.asarray(v0)
    tk, tv = _t(k0.copy()), _t(v0.copy())
    jk, jv = _both_prefill(jparams, tparams, prompt[:12], [3, 7, 1], jk, jv,
                           tk, tv)
    start = 10 if unaligned else 12
    if unaligned:
        jk = j_copy_page_prefix(jk, 1, 8, jnp.arange(PS) < 2)
        jv = j_copy_page_prefix(jv, 1, 8, jnp.arange(PS) < 2)
        copy_page_prefix(tk, 1, 8, 2)
        copy_page_prefix(tv, 1, 8, 2)
        own, ctx = [8, 9, 12, 5], [3, 7, 8, 9, 12, 5]
    else:
        own, ctx = [9, 12, 5, 4], [3, 7, 1, 9, 12, 5]
    S, suffix = 12, prompt[start:start + 10]
    tok = np.zeros((1, S), np.int32)
    tok[0, : len(suffix)] = suffix
    args = (tok, np.array([start], np.int32),
            np.array([len(suffix)], np.int32),
            np.array([own[: S // PS + unaligned]], np.int32),
            np.array([ctx + [0, 0]], np.int32))
    j_logits, jk, jv = jdec.prefill_suffix_forward(
        jparams, J_SPEC, *(jnp.asarray(a) for a in args[:3]), jk, jv,
        *(jnp.asarray(a) for a in args[3:]), unaligned=unaligned,
    )
    t_logits = tdec.prefill_suffix_forward(
        tparams, SPEC, *(_t(a) for a in args[:3]), tk, tv,
        *(_t(a) for a in args[3:]), unaligned=unaligned,
    )
    _close(t_logits, j_logits)
    _close(tk[:, :, 1:], jk[:, :, 1:])
    _close(tv[:, :, 1:], jv[:, :, 1:])


def _hf_gemma2():
    transformers = pytest.importorskip("transformers")
    config = transformers.Gemma2Config(
        vocab_size=SPEC.vocab_size, hidden_size=SPEC.hidden_size,
        num_hidden_layers=SPEC.num_layers, num_attention_heads=SPEC.num_heads,
        num_key_value_heads=SPEC.num_kv_heads, head_dim=SPEC.head_dim,
        intermediate_size=SPEC.intermediate_size, rope_theta=SPEC.rope_theta,
        rms_norm_eps=SPEC.rms_eps, attn_logit_softcapping=SPEC.attn_softcap,
        final_logit_softcapping=SPEC.final_softcap,
        query_pre_attn_scalar=SPEC.query_scale,
        sliding_window=SPEC.sliding_window,
        hidden_activation="gelu_pytorch_tanh", tie_word_embeddings=True,
        attention_bias=False,
        # eager: HF's sdpa path skips the attention-logit softcap
        attn_implementation="eager",
    )
    assert [t == "sliding_attention" for t in config.layer_types] == [
        w > 0 for w in SPEC.layer_windows
    ]
    torch.manual_seed(4)
    model = transformers.Gemma2ForCausalLM(config).eval()
    # HF initialises the norms at zero; give them content, so the unit
    # offset and every sandwich norm shows
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("norm.weight"):
                p.normal_(0.0, 0.1)
    return model


def test_hf_gemma2_parity_through_state_dict():
    """The prompt pass (lengths 12 and 7) and a decode step at position
    12, past the window, against HF's full forwards."""
    model = _hf_gemma2()
    params = params_from_torch_state_dict(SPEC, model.state_dict())
    rng = np.random.default_rng(4)
    rows = [rng.integers(2, SPEC.vocab_size, size=n).tolist()
            for n in (12, 7)]
    S, pps = 16, 5
    tokens = np.zeros((2, S), np.int32)
    for i, r in enumerate(rows):
        tokens[i, : len(r)] = r
    k, v = (torch.zeros(SPEC.num_layers, SPEC.num_kv_heads, 1 + 2 * pps, PS,
                        SPEC.head_dim) for _ in range(2))
    pt = torch.arange(2 * pps, dtype=torch.int32).reshape(2, pps) + 1
    logits = tdec.prefill_forward(
        params, SPEC, _t(tokens), torch.tensor([12, 7], dtype=torch.int32),
        k, v, pt[:, : S // PS],
    )
    extra = int(rng.integers(2, SPEC.vocab_size))
    step = tdec.decode_forward(
        params, SPEC, torch.tensor([extra, 5], dtype=torch.int32),
        torch.tensor([12, 7], dtype=torch.int32), k, v, pt,
        active=torch.tensor([True, False]),
    )
    with torch.no_grad():
        for i, r in enumerate(rows):
            ref = model(torch.tensor([r])).logits[0, -1].float()
            np.testing.assert_allclose(logits[i].numpy(), ref.numpy(),
                                       atol=HF_TOL, rtol=HF_TOL)
        ref = model(torch.tensor([rows[0] + [extra]])).logits[0, -1].float()
    np.testing.assert_allclose(step[0].numpy(), ref.numpy(), atol=HF_TOL,
                               rtol=HF_TOL)


# ------------------------------------------------- bf16 rounding, layout


def test_bf16_embed_scale_and_unit_offset_norm_are_bit_identical():
    """At Gemma-2-9B's width sqrt(3584) = 59.87 rounds to 59.75 in bf16
    BEFORE the multiply, and the norm adds the unit offset in fp32: the
    port's bf16 results equal the reference's bit for bit."""
    rng = np.random.default_rng(9)
    D = GEMMA2_9B.hidden_size
    table = rng.normal(size=(32, D)).astype(np.float32)
    tokens = rng.integers(0, 32, size=(3, 5)).astype(np.int32)
    got = tdec._embed({"embed": _t(table).bfloat16()}, GEMMA2_9B,
                      _t(tokens))
    expect = jdec._embed({"embed": jnp.asarray(table, jnp.bfloat16)},
                         J_GEMMA9B, jnp.asarray(tokens))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(expect.astype(jnp.float32)))
    assert float(torch.tensor(D ** 0.5, dtype=torch.bfloat16)) == 59.75
    x = (rng.normal(size=(4, D)) * 3).astype(np.float32)
    w = (rng.normal(size=(D,)) * 0.3).astype(np.float32)
    got = rms_norm(_t(x).bfloat16(), _t(w).bfloat16(), 1e-6,
                   unit_offset=True)
    expect = j_rms_norm(jnp.asarray(x, jnp.bfloat16),
                        jnp.asarray(w, jnp.bfloat16), 1e-6, True)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(expect.astype(jnp.float32)))


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


def test_init_params_gemma_layout():
    """The JAX tree's leaves and shapes (sandwich norms, no lm_head); the
    unit-offset norms start at zero (identity)."""
    gen = torch.Generator().manual_seed(0)
    ours = tdec.init_params(SPEC, gen, dtype=torch.float32)
    theirs, _ = _params()
    assert _shapes(ours) == _shapes(theirs)
    assert "lm_head" not in ours
    for name in ("input_norm", "post_norm", "pre_ffn_norm", "post_ffn_norm"):
        assert not ours["layers"][name].any()
    assert not ours["final_norm"].any()


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_decoder_params_leaves_embed_and_norms(bits):
    """The seven projections quantize bit for bit as the reference's;
    the tied embedding and every norm stay as they were."""
    jparams, tparams = _params()
    jquant = jq.quantize_decoder_params(jparams, J_SPEC, bits)
    kept = {name: tparams["layers"][name].clone() for name in (
        "input_norm", "post_norm", "pre_ffn_norm", "post_ffn_norm")}
    embed = tparams["embed"].clone()
    ours = tq.quantize_decoder_params(tparams, SPEC, bits)
    for name in ("q", "k", "v", "o", "gate", "up", "down"):
        for tpart, jpart in zip(ours["layers"][name]["w"],
                                jquant["layers"][name]["w"]):
            np.testing.assert_array_equal(tpart.numpy(), np.asarray(jpart))
    assert "lm_head" not in ours and "lm_head" not in jquant
    assert torch.equal(ours["embed"], embed)
    for name, before in kept.items():
        assert torch.equal(ours["layers"][name], before)
        np.testing.assert_array_equal(
            before.numpy(), np.asarray(jquant["layers"][name]))


# ------------------------------------------------------------ the engines


class Pair:
    """A JAX engine and a port engine on tiny-gemma2 with one weight
    tree: page size 4, the prefix cache on (COW at 2 tokens), chunked
    prefill at 8 tokens, 4 slots and a pool tight enough to preempt.

    The test queues every request of a wave, then drives both engines'
    tick itself (no engine thread), so admission, chunking and
    preemption follow the same events in both whatever the host's load
    (tests/test_torch_quant.py)."""

    def __init__(self, model, kv_cache, block_slots):
        model = {"model_id": "tiny-gemma2", "dtype": "float32",
                 "max_model_len": 96, **model}
        shapes = {"kv_num_pages": 40, "kv_page_size": PS,
                  "max_batch_slots": 4, "prefill_buckets": [8, 16, 32],
                  "prefill_chunk": 8, "decode_block_slots": block_slots,
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
        jparams = j_init(J_SPEC, None, np.float32)
        self.j = JEngineCore(j_cfg, params=jparams,
                             devices=jax.devices()[:1])
        self.t = EngineCore(
            t_cfg,
            params=params_from_jax(jax.tree.map(np.asarray, jparams), SPEC),
        )

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


@pytest.mark.parametrize(
    "model,kv_cache,block_slots",
    [({}, {}, 1), ({}, {}, 2),
     ({"quantization": "int8"}, {"dtype": "int8"}, 1)],
    ids=["pools_bs1", "pools_bs2", "int8_weights_int8_kv"],
)
def test_engine_token_identical_to_jax(monkeypatch, model, kv_cache,
                                       block_slots):
    """64 greedy tokens for a concurrent batch of prompts longer than the
    window: a prefix hit, a copy-on-write divergence and a third prompt,
    each over 8 tokens (chunked), in a 39-page pool that cannot hold all
    three to the end (preemption).  With ``decode_block_slots`` 2 every
    decode step goes through K6's wrapper (4 slots), never K1's."""
    calls = {"k1": 0, "k6": 0}
    for name, key in (("paged_decode_attention", "k1"),
                      ("paged_decode_attention_blocked", "k6")):
        def spy(*args, _real=getattr(tdec, name), _key=key, **kwargs):
            calls[_key] += 1
            return _real(*args, **kwargs)
        monkeypatch.setattr(tdec, name, spy)
    pair = Pair(model, kv_cache, block_slots)
    assert pair.t.spec.decode_block_slots == block_slots
    rng = np.random.default_rng(29)
    base = rng.integers(3, SPEC.vocab_size, size=14).tolist()
    pair.wave([base], tokens=4)  # cold and chunked: the tree holds base
    hit, cow, other = pair.wave(
        [base, base[:10] + [21, 22, 23, 24, 25],
         rng.integers(3, 500, size=13).tolist()],
        tokens=64,
    )
    assert len(hit) == len(cow) == len(other) == 64
    t, j = pair.t.get_stats(), pair.j.get_stats()
    tpc, jpc = t["scheduler"]["prefix_cache"], j["scheduler"]["prefix_cache"]
    for key in ("hit_tokens", "cow_copies"):
        assert tpc[key] == jpc[key], key
    assert tpc["hit_tokens"] > 0 and tpc["cow_copies"] > 0
    assert t["prefix_cache"]["chunked_prefills"] >= 2
    assert t["scheduler"]["preemptions"] > 0
    assert t["scheduler"]["preemptions"] == j["scheduler"]["preemptions"]
    assert t["running"] == 0 and t["used_pages"] == 0
    assert t["kv_dtype"] == ("int8" if kv_cache else "f32")
    steps = SPEC.num_layers * t["steps"]
    assert calls == ({"k1": 0, "k6": steps} if block_slots > 1
                     else {"k1": steps, "k6": 0})
    if model:
        assert isinstance(pair.t.params["layers"]["q"]["w"], tq.QTensor)
