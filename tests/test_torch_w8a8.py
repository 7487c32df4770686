"""The port's W8A8 / W4A8 (``device.int8_native``) vs the JAX package.

Inputs come from numpy seeds and go through both packages.  Tolerances:
the per-token activation quantization (``_quantize_activations``) and the
int32 accumulations of ``int8_native_partial`` are BIT FOR BIT (integer
sums are exact in both); ``int8_native_einsum`` and the forwards within
1e-4 in float32.  The engines must be greedy token-identical, driven tick
by tick by the test.
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
from vgate_tpu.models.specs import TINY_DENSE as J_DENSE
from vgate_tpu.models.specs import TINY_MOE as J_MOE
from vgate_tpu.ops import quant as jq
from vgate_tpu.runtime.engine_core import EngineCore as JEngineCore
from vgate_tpu.runtime.weights import load_or_init_params as j_init
from vgate_tpu_torch.backends.base import SamplingParams
from vgate_tpu_torch.config import load_config
from vgate_tpu_torch.models import decoder as tdec
from vgate_tpu_torch.models.specs import TINY_DENSE, TINY_MOE
from vgate_tpu_torch.ops import quant as tq
from vgate_tpu_torch.ops.kernels import quant_matmul
from vgate_tpu_torch.runtime.engine_core import EngineCore
from vgate_tpu_torch.runtime.weights import params_from_jax

PS = 4
SPECS = {"tiny-dense": (J_DENSE, TINY_DENSE), "tiny-moe": (J_MOE, TINY_MOE)}


def _weights(shape, bits, seed):
    w = (np.random.default_rng(seed).standard_normal(shape) * 0.05).astype(
        np.float32)
    quant = tq.quantize_tensor if len(shape) == 2 else tq.quantize_expert_stacked
    jquant = (jq.quantize_tensor if len(shape) == 2
              else jq.quantize_expert_stacked)
    if len(shape) == 3:  # one layer of experts: stacked as [1, E, in, out]
        tw = quant(torch.from_numpy(w)[None], bits)
        jw = jquant(jnp.asarray(w)[None], bits)
        tw = type(tw)(*(p[0] for p in tw))
        jw = type(jw)(*(p[0] for p in jw))
        return tw, jw
    return quant(torch.from_numpy(w), bits), jquant(jnp.asarray(w), bits)


def test_quantize_activations_is_bit_identical():
    """Per-row absmax scales and round half to even, including rows whose
    values land exactly on .5 steps, an all-zero row (the 1e-8 floor)
    and bf16 input."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 7, 48)).astype(np.float32)
    x[0, 0] = 0.0
    x[1, 0] = np.arange(48, dtype=np.float32) - 23.5  # halves after scaling
    x[1, 0, 0] = 127.0
    x[1, 1] = (np.arange(48) % 5 - 2.5).astype(np.float32)
    x[1, 1, 0] = 127.0
    for dtype in (np.float32, "bfloat16"):
        jx = jnp.asarray(x).astype(dtype)
        tx = torch.from_numpy(x).to(torch.float32 if dtype == np.float32
                                    else torch.bfloat16)
        jq_, js = jq._quantize_activations(jx)
        tq_, ts = tq._quantize_activations(tx)
        assert tq_.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tq_.numpy(), np.asarray(jq_))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize(
    "subscripts,xshape,wshape",
    [("...d,dh->...h", (3, 5, 64), (64, 96)),
     ("...f,fd->...d", (17, 128), (128, 64)),
     ("ecd,edf->ecf", (4, 6, 64), (4, 64, 128)),
     ("ecf,efd->ecd", (4, 6, 128), (4, 128, 64))],
    ids=["dense", "dense-17-rows", "expert-up", "expert-down"],
)
def test_int8_native_partial_is_bit_identical(subscripts, xshape, wshape,
                                              bits):
    """W8A8 (int8) and W4A8 (two nibble planes), dense and expert: the
    int32 accumulation times the activation scale, bit for bit; the
    dense int8 product also through ``int8_mm`` against numpy."""
    rng = np.random.default_rng(bits)
    x = rng.standard_normal(xshape).astype(np.float32)
    tw, jw = _weights(wshape, bits, seed=len(xshape))
    got = tq.int8_native_partial(subscripts, torch.from_numpy(x), tw)
    want = jq.int8_native_partial(subscripts, jnp.asarray(x), jw)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if bits == 8 and len(wshape) == 2:
        xq, _ = tq._quantize_activations(torch.from_numpy(x))
        acc = tq.int8_mm(xq, tw.q)
        assert acc.dtype == torch.int32
        np.testing.assert_array_equal(
            acc.numpy(), xq.numpy().astype(np.int64) @ tw.q.numpy())


@pytest.mark.parametrize("bits", [8, 4])
def test_int8_native_einsum_matches_jax(bits):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, 64)).astype(np.float32)
    tw, jw = _weights((64, 128), bits, seed=4)
    got = tq.int8_native_einsum("...d,dh->...h", torch.from_numpy(x), tw,
                                torch.float32)
    want = jq.int8_native_einsum("...d,dh->...h", jnp.asarray(x), jw,
                                 jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("bits", [8, 4])
def test_weighted_einsum_takes_w8a8_before_k4_k5(bits, monkeypatch):
    """With ``int8_native`` an eligible quantized contraction is the
    W8A8 product (K4/K5 are not called) and equals the reference's
    ``weighted_einsum(..., int8_native=True)``; without it K4/K5 run."""
    calls = []
    for name in ("int8_matmul", "int4_matmul"):
        real = getattr(quant_matmul, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*a, **kw)

        monkeypatch.setattr(quant_matmul, name, spy)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((6, 64)).astype(np.float32)
    tw, jw = _weights((64, 96), bits, seed=6)
    got = tq.weighted_einsum("...d,dh->...h", torch.from_numpy(x), tw,
                             int8_native=True)
    assert calls == []
    want = jq.weighted_einsum("...d,dh->...h", jnp.asarray(x), jw,
                              int8_native=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)
    tq.weighted_einsum("...d,dh->...h", torch.from_numpy(x), tw)
    assert calls == ["int8_matmul" if bits == 8 else "int4_matmul"]


def test_lm_head_never_takes_w8a8(monkeypatch):
    """``_logits`` keeps the lm_head on K4/K5 under ``int8_native``."""
    spec = dataclasses.replace(TINY_DENSE, int8_native=True)
    gen = torch.Generator().manual_seed(0)
    params = tq.quantize_decoder_params(
        tdec.init_params(spec, gen, torch.float32), spec, 8)
    seen = []
    real = tq.int8_native_einsum

    def spy(subscripts, x, w, out_dtype):
        seen.append(tuple(w.q.shape))
        return real(subscripts, x, w, out_dtype)

    monkeypatch.setattr(tq, "int8_native_einsum", spy)
    k4 = quant_matmul.int8_matmul.launches
    tdec._logits(params, spec, torch.randn(3, spec.hidden_size))
    assert seen == []
    tdec._finish_layer(torch.randn(3, spec.hidden_size),
                       torch.randn(3, spec.q_dim),
                       tdec.layer_params(params, 0), spec)
    assert len(seen) == 4  # o, gate, up, down
    assert quant_matmul.int8_matmul.launches == k4  # no card here


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("model", ["tiny-dense", "tiny-moe"])
def test_forwards_match_jax(model, bits):
    """Prompt pass and a decode step with ``int8_native`` on, float32."""
    jspec, tspec = SPECS[model]
    jspec = dataclasses.replace(jspec, int8_native=True)
    tspec = dataclasses.replace(tspec, int8_native=True)
    jparams = jq.quantize_decoder_params(
        jdec.init_params(jspec, jax.random.PRNGKey(1), jnp.float32), jspec,
        bits)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tspec)
    rng = np.random.default_rng(2)
    B, S, pps = 2, 16, 6
    pt = (np.arange(B * pps, dtype=np.int32).reshape(B, pps) + 1)
    tokens = rng.integers(3, tspec.vocab_size, (B, S)).astype(np.int32)
    lens = np.array([10, 16], np.int32)
    shape = (tspec.num_layers, tspec.num_kv_heads, 1 + B * pps, PS,
             tspec.head_dim)
    k0 = np.zeros(shape, np.float32)
    jl, jk, jv = jdec.prefill_forward(
        jparams, jspec, jnp.asarray(tokens), jnp.asarray(lens),
        jnp.asarray(k0), jnp.asarray(k0), jnp.asarray(pt[:, :4]))
    tk, tv = torch.zeros(shape), torch.zeros(shape)
    tl = tdec.prefill_forward(
        tparams, tspec, torch.from_numpy(tokens), torch.from_numpy(lens),
        tk, tv, torch.from_numpy(pt[:, :4]))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    nxt = np.argmax(np.asarray(jl), -1).astype(np.int32)
    jl, _, _ = jdec.decode_forward(
        jparams, jspec, jnp.asarray(nxt), jnp.asarray(lens), jk, jv,
        jnp.asarray(pt))
    tl = tdec.decode_forward(
        tparams, tspec, torch.from_numpy(nxt), torch.from_numpy(lens), tk,
        tv, torch.from_numpy(pt))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)


def test_int8_native_without_quantization_warns_and_stays_off(caplog):
    cfg = load_config(
        model={"model_id": "tiny-dense", "dtype": "float32",
               "max_model_len": 64},
        device={"device": "cpu", "kv_num_pages": 32, "kv_page_size": PS,
                "max_batch_slots": 2, "prefill_buckets": [8, 16],
                "int8_native": True},
        logging={"level": "WARNING"},
    )
    core = EngineCore(cfg)
    assert core.spec.int8_native is False
    assert any("int8_native has no effect" in r.getMessage()
               for r in caplog.records)


@pytest.mark.parametrize("quantization", ["int8", "int4"])
def test_dense_engine_token_identical_to_jax(quantization):
    """``tiny-dense`` with W8A8 / W4A8: 40 greedy tokens for a concurrent
    batch with a prefix hit and a copy-on-write divergence, each wave
    queued whole and both engines ticked by the test."""
    model = {"model_id": "tiny-dense", "dtype": "float32",
             "max_model_len": 96, "quantization": quantization}
    shapes = {"kv_num_pages": 64, "kv_page_size": PS, "max_batch_slots": 3,
              "prefill_buckets": [8, 16, 32], "int8_native": True,
              "prefix_cache": {"enabled": True, "cow_min_tokens": 2}}
    j = JEngineCore(
        j_load_config(
            model={**model, "engine_type": "jax_tpu"},
            tpu={"dp": 1, "tp": 1, "ep": 1, "sp": 1, "use_pallas": False,
                 **shapes},
            scheduler={"max_queue_size": 16}, integrity={"enabled": False},
            logging={"level": "ERROR"}),
        params=j_init(J_DENSE, None, np.float32), devices=jax.devices()[:1])
    t = EngineCore(
        load_config(model={**model, "engine_type": "torch_cuda"},
                    device={"device": "cpu", **shapes},
                    scheduler={"max_queue_size": 16},
                    logging={"level": "ERROR"}),
        params=params_from_jax(
            jax.tree.map(np.asarray, j_init(J_DENSE, None, np.float32)),
            TINY_DENSE))
    assert t.spec.int8_native and j.spec.int8_native
    rng = np.random.default_rng(31)
    base = rng.integers(3, TINY_DENSE.vocab_size, size=14).tolist()
    waves = [[base], [base, base[:10] + [21, 22, 23, 24, 25],
                      rng.integers(3, 500, size=13).tolist()]]
    try:
        for prompts, n in zip(waves, (4, 40)):
            outs = []
            for core, sp in ((j, JSamplingParams), (t, SamplingParams)):
                params = sp(max_tokens=n, min_tokens=n, temperature=0.0)
                seqs = [core.submit_tokens(list(p), params) for p in prompts]
                for _ in range(10_000):
                    if all(s.done_event.is_set() for s in seqs):
                        break
                    core._tick()
                outs.append([list(s.generated_ids) for s in seqs])
            assert outs[1] == outs[0]
        pc = t.get_stats()["scheduler"]["prefix_cache"]
        assert pc["hit_tokens"] > 0 and pc["cow_copies"] > 0
        assert t.get_stats()["used_pages"] == 0
    finally:
        j.stop()
        t.stop()


@pytest.mark.parametrize("bits", [8, 4])
def test_k_major_layout_keeps_the_values_and_the_sums(bits):
    """``k_major`` stores the narrow ints with the contracted dim
    contiguous (the layout the card's int8 product reads at full rate):
    the same values, the same W8A8 sums bit for bit, idempotent; the
    digest reads such a leaf in storage order without a copy; an
    engine's ``int8_native_layout`` leaves the lm_head row-major."""
    from vgate_tpu_torch.ops.kernels.leaf_digest import leaf_digest_plain

    gen = torch.Generator().manual_seed(bits)
    w = torch.randn((2, 4, 64, 32), generator=gen)
    qw = tq.quantize_expert_stacked(w, bits)
    km = tq.k_major(qw)
    assert km[0].stride(-2) == 1 and torch.equal(km[0], qw[0])
    assert tq.k_major(km) is km
    x = torch.randn((5, 64), generator=gen)
    one = [type(t)(*(p[1, 2] for p in t)) for t in (qw, km)]
    assert torch.equal(tq.int8_native_partial("...d,df->...f", x, one[0]),
                       tq.int8_native_partial("...d,df->...f", x, one[1]))
    assert leaf_digest_plain(km[0]) == leaf_digest_plain(
        km[0].transpose(-1, -2).contiguous())
    spec = dataclasses.replace(TINY_MOE, int8_native=True)
    params = tq.quantize_decoder_params(
        tdec.init_params(spec, torch.Generator().manual_seed(0),
                         torch.float32), spec, bits)
    tq.int8_native_layout(params)
    for name in ("q", "k", "v", "o", "gate", "up", "down"):
        assert params["layers"][name]["w"][0].stride(-2) == 1, name
    assert params["lm_head"][0].is_contiguous()


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("subscripts,xshape,wshape",
                         [("ecd,edf->ecf", (4, 6, 64), (4, 64, 128)),
                          ("ecf,efd->ecd", (4, 6, 128), (4, 128, 64))],
                         ids=["up", "down"])
def test_expert_einsum_w8a8_is_bit_identical(subscripts, xshape, wshape,
                                             bits):
    """The decoder's expert W8A8 (activations quantized once for all
    experts, then one expert at a time) against the reference's
    ``_expert_einsum(..., int8_native=True)``, bit for bit."""
    rng = np.random.default_rng(bits + 10)
    x = rng.standard_normal(xshape).astype(np.float32)
    tw, jw = _weights(wshape, bits, seed=3)
    got = tdec._expert_einsum(subscripts, torch.from_numpy(x), tw,
                              int8_native=True)
    want = jdec._expert_einsum(subscripts, jnp.asarray(x), jw,
                               int8_native=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
