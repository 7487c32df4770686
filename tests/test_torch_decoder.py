"""The port's dense decoder vs the JAX decoder, and vs HF transformers.

One JAX ``init_params`` tree (tiny-dense, fp32) is carried over with
``params_from_jax``; the prompt pass and two decode steps must give the
same logits (atol 1e-4, fp32 on the CPU) and write the same KV pages.
The HF pattern of tests/test_model_parity.py checks the port's forward
against ``Qwen2ForCausalLM`` through ``params_from_torch_state_dict``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vgate_tpu.models import decoder as jdec
from vgate_tpu.models.specs import TINY_DENSE as J_TINY
from vgate_tpu_torch.models import decoder as tdec
from vgate_tpu_torch.models.specs import TINY_DENSE
from vgate_tpu_torch.runtime.weights import (
    params_from_jax,
    params_from_torch_state_dict,
)

PS = 4
ATOL = 1e-4  # fp32 logits through 2 layers, two frameworks' op orders


def _jax_params():
    params = jdec.init_params(J_TINY, jax.random.PRNGKey(0), jnp.float32)
    return params, params_from_jax(
        jax.tree.map(np.asarray, params), TINY_DENSE
    )


def _pools(num_pages):
    shape = (TINY_DENSE.num_layers, TINY_DENSE.num_kv_heads, num_pages, PS,
             TINY_DENSE.head_dim)
    return np.zeros(shape, np.float32), np.zeros(shape, np.float32)


def _assert_pool(tpool, jpool, atol):
    """Every page but trash page 0 equals the reference's; on page 0 the
    port writes zeros (``ops/kv_quant.py`` ``kv_write``: the winner of
    duplicate trash writes is not fixed on the card), where the
    reference keeps the last duplicate written."""
    t, j = tpool.numpy(), np.asarray(jpool)
    np.testing.assert_allclose(t[:, :, 1:], j[:, :, 1:], atol=atol)
    assert not t[:, :, 0].any()


def test_params_from_jax_keeps_layout():
    jparams, tparams = _jax_params()
    assert tparams["layers"]["q"]["w"].shape == tuple(
        jparams["layers"]["q"]["w"].shape
    )
    np.testing.assert_array_equal(
        tparams["embed"].numpy(), np.asarray(jparams["embed"])
    )


def test_prefill_and_decode_match_jax():
    jparams, tparams = _jax_params()
    rng = np.random.default_rng(0)
    B, S = 2, 16
    tokens = rng.integers(3, TINY_DENSE.vocab_size, size=(B, S)).astype(
        np.int32
    )
    seq_lens = np.array([11, 16], np.int32)
    pps = 8  # pages per sequence: prompt pages + decode room
    P = 1 + B * pps
    page_tables = (np.arange(B * pps, dtype=np.int32).reshape(B, pps) + 1)
    k0, v0 = _pools(P)

    j_logits, jk, jv = jdec.prefill_forward(
        jparams, J_TINY, jnp.asarray(tokens), jnp.asarray(seq_lens),
        jnp.asarray(k0), jnp.asarray(v0),
        jnp.asarray(page_tables[:, : S // PS]),
    )
    tk, tv = torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy())
    t_logits = tdec.prefill_forward(
        tparams, TINY_DENSE, torch.from_numpy(tokens),
        torch.from_numpy(seq_lens), tk, tv,
        torch.from_numpy(page_tables[:, : S // PS]),
    )
    np.testing.assert_allclose(
        t_logits.numpy(), np.asarray(j_logits), atol=ATOL, rtol=0
    )
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL)

    # two decode steps from the prompt ends, slot 1 idle on step 2
    positions = seq_lens.copy()
    next_tok = np.argmax(np.asarray(j_logits), axis=-1).astype(np.int32)
    for step, active in enumerate(([True, True], [True, False])):
        act = np.array(active)
        j_logits, jk, jv = jdec.decode_forward(
            jparams, J_TINY, jnp.asarray(next_tok), jnp.asarray(positions),
            jk, jv, jnp.asarray(page_tables), active=jnp.asarray(act),
        )
        t_logits = tdec.decode_forward(
            tparams, TINY_DENSE, torch.from_numpy(next_tok),
            torch.from_numpy(positions), tk, tv,
            torch.from_numpy(page_tables), active=torch.from_numpy(act),
        )
        np.testing.assert_allclose(
            t_logits.numpy(), np.asarray(j_logits), atol=ATOL, rtol=0,
            err_msg=f"decode step {step}",
        )
        _assert_pool(tk, jk, ATOL)
        _assert_pool(tv, jv, ATOL)
        next_tok = np.argmax(np.asarray(j_logits), axis=-1).astype(np.int32)
        positions = positions + act.astype(np.int32)


def test_init_params_is_seeded_and_shaped():
    def init(seed):
        gen = torch.Generator().manual_seed(seed)
        return tdec.init_params(TINY_DENSE, gen, dtype=torch.float32)

    a, b, c = init(0), init(0), init(1)
    assert torch.equal(a["layers"]["q"]["w"], b["layers"]["q"]["w"])
    assert not torch.equal(a["layers"]["q"]["w"], c["layers"]["q"]["w"])
    _, ref = _jax_params()

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        return tuple(tree.shape)

    assert shapes(a) == shapes(ref)
    assert abs(float(a["layers"]["up"]["w"].std()) - 0.02) < 2e-3


def test_hf_qwen2_parity_through_state_dict():
    transformers = pytest.importorskip("transformers")
    config = transformers.Qwen2Config(
        vocab_size=TINY_DENSE.vocab_size,
        hidden_size=TINY_DENSE.hidden_size,
        num_hidden_layers=TINY_DENSE.num_layers,
        num_attention_heads=TINY_DENSE.num_heads,
        num_key_value_heads=TINY_DENSE.num_kv_heads,
        intermediate_size=TINY_DENSE.intermediate_size,
        rope_theta=TINY_DENSE.rope_theta,
        rms_norm_eps=TINY_DENSE.rms_eps,
        tie_word_embeddings=False,
        use_sliding_window=False,
    )
    torch.manual_seed(0)
    model = transformers.Qwen2ForCausalLM(config).eval()
    params = params_from_torch_state_dict(TINY_DENSE, model.state_dict())
    rows = [[5, 17, 33, 2, 9, 100, 7], [44, 3, 250, 6]]
    S = 8
    tokens = np.zeros((len(rows), S), np.int32)
    for i, r in enumerate(rows):
        tokens[i, : len(r)] = r
    seq_lens = torch.tensor([len(r) for r in rows], dtype=torch.int32)
    P = 1 + len(rows) * (S // PS)
    k, v = (torch.zeros(TINY_DENSE.num_layers, TINY_DENSE.num_kv_heads, P,
                        PS, TINY_DENSE.head_dim) for _ in range(2))
    pt = torch.arange(len(rows) * (S // PS), dtype=torch.int32).reshape(
        len(rows), S // PS
    ) + 1
    logits = tdec.prefill_forward(
        params, TINY_DENSE, torch.from_numpy(tokens), seq_lens, k, v, pt
    )
    with torch.no_grad():
        for i, r in enumerate(rows):
            ref = model(torch.tensor([r])).logits[0, -1].float()
            np.testing.assert_allclose(
                logits[i].numpy(), ref.numpy(), atol=1e-4, rtol=1e-4
            )
