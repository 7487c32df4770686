"""The port's plain ops vs the JAX ops, on the same numpy inputs.

fp32 tolerance 1e-6 for norms and rope; masks, sampling slices and greedy
ids must match exactly.  Sampled tokens cannot replay ``jax.random``
streams, so they are held to the masked distribution instead (a
chi-square test with a fixed generator).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vgate_tpu.ops import norms as jnorms
from vgate_tpu.ops import rope as jrope
from vgate_tpu.ops import sampling as jsamp
from vgate_tpu_torch.ops import norms, rope, sampling

TOL = 1e-6


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("unit_offset", [False, True])
def test_rms_norm_matches_jax(unit_offset):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32)
    w = rng.normal(size=(64,)).astype(np.float32)
    expect = jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6,
                             unit_offset)
    got = norms.rms_norm(_t(x), _t(w), 1e-6, unit_offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize(
    "scaling", [None, (8.0, 1.0, 4.0, 64)], ids=["plain", "llama31"]
)
def test_rope_matches_jax(scaling):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 4, 32)).astype(np.float32)
    pos = rng.integers(0, 300, size=(2, 7)).astype(np.int32)
    np.testing.assert_allclose(
        rope.rope_frequencies(32, 500000.0, scaling).numpy(),
        np.asarray(jrope.rope_frequencies(32, 500000.0, scaling)),
        atol=TOL, rtol=TOL,
    )
    expect = jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), 500000.0,
                              scaling)
    got = rope.apply_rope(_t(x), _t(pos), 500000.0, scaling)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), atol=1e-5,
                               rtol=TOL)


def _sampling_case(seed=2, B=6, V=1000):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(B, V)) * 3).astype(np.float32)
    temps = np.array([0.0, 0.5, 1.0, 1.3, 0.7, 1.0], np.float32)[:B]
    top_ps = np.array([1.0, 0.9, 0.5, 1.0, 0.99, 0.3], np.float32)[:B]
    top_ks = np.array([0, 0, 5, 40, 0, 300], np.int32)[:B]
    return logits, temps, top_ps, top_ks


def test_masked_scaled_matches_jax():
    logits, temps, top_ps, top_ks = _sampling_case()
    jv, ji, jm = jsamp._masked_scaled(
        jnp.asarray(logits), jnp.asarray(temps), jnp.asarray(top_ps),
        jnp.asarray(top_ks),
    )
    tv, ti, tm = sampling._masked_scaled(
        _t(logits), _t(temps), _t(top_ps), _t(top_ks)
    )
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # the eligibility mask is exact; eligible values to fp32 rounding
    np.testing.assert_array_equal(tm.numpy() > -1e29, np.asarray(jm) > -1e29)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=TOL)


def test_greedy_sample_matches_jax_argmax():
    logits, temps, top_ps, top_ks = _sampling_case()
    temps[:] = 0.0
    key = jax.random.PRNGKey(0)
    expect = jsamp.sample_tokens(
        jnp.asarray(logits), jnp.asarray(temps), jnp.asarray(top_ps),
        jnp.asarray(top_ks), key,
    )
    got = sampling.sample_tokens(_t(logits), _t(temps), _t(top_ps),
                                 _t(top_ks), torch.Generator())
    np.testing.assert_array_equal(got.numpy(), np.asarray(expect))
    fast = sampling.sample_tokens(_t(logits), _t(temps), _t(top_ps),
                                  _t(top_ks), all_greedy=True)
    np.testing.assert_array_equal(fast.numpy(), np.asarray(expect))


def test_argmax_ties_take_first_index_like_jax():
    logits = np.zeros((2, 50), np.float32)
    logits[0, [7, 3, 9]] = 5.0
    logits[1, [40, 41]] = 1.0
    expect = jnp.argmax(jnp.asarray(logits), axis=-1)
    got = sampling.sample_tokens(
        _t(logits), torch.zeros(2), torch.ones(2),
        torch.zeros(2, dtype=torch.int32), all_greedy=True,
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(expect))


def test_sampled_tokens_follow_masked_distribution():
    """Chi-square over 4000 draws of one row: counts must fit the
    softmax of the masked, temperature-scaled top-k slice."""
    rng = np.random.default_rng(3)
    V, N = 64, 4000
    row = (rng.normal(size=(V,)) * 1.5).astype(np.float32)
    logits = torch.from_numpy(np.tile(row, (N, 1)))
    temps = torch.full((N,), 0.8)
    top_ps = torch.full((N,), 0.95)
    top_ks = torch.full((N,), 10, dtype=torch.int32)
    gen = torch.Generator().manual_seed(1234)
    toks = sampling.sample_tokens(logits, temps, top_ps, top_ks, gen)
    _, idx, masked = sampling._masked_scaled(
        logits[:1], temps[:1], top_ps[:1], top_ks[:1]
    )
    probs = torch.softmax(masked[0].double(), -1).numpy()
    eligible = probs > 1e-12
    support = idx[0].numpy()[eligible]
    expect = probs[eligible] * N
    counts = np.array([(toks.numpy() == t).sum() for t in support])
    assert counts.sum() == N  # nothing sampled outside the mask
    chi2 = float(((counts - expect) ** 2 / expect).sum())
    dof = len(support) - 1
    # p < 1e-4 critical value is ~dof + 6*sqrt(2*dof) for small dof
    assert chi2 < dof + 6 * np.sqrt(2 * dof) + 10, (chi2, dof)


def test_seeded_rows_reproduce_across_batches():
    logits, temps, top_ps, top_ks = _sampling_case()
    seeds = torch.tensor([5, 5, 9, -1, 5, 3])
    steps = torch.tensor([0, 0, 4, 0, 1, 2])
    a = sampling.sample_tokens(_t(logits), _t(temps), _t(top_ps),
                               _t(top_ks), torch.Generator().manual_seed(1),
                               seeds=seeds, steps=steps)
    b = sampling.sample_tokens(_t(logits), _t(temps), _t(top_ps),
                               _t(top_ks), torch.Generator().manual_seed(2),
                               seeds=seeds, steps=steps)
    seeded = (seeds >= 0).numpy()
    np.testing.assert_array_equal(a.numpy()[seeded], b.numpy()[seeded])


def test_penalties_bias_and_stop_suppression_match_jax():
    rng = np.random.default_rng(4)
    B, V = 3, 40
    logits = rng.normal(size=(B, V)).astype(np.float32)
    counts = rng.integers(0, 3, size=(B, V)).astype(np.int32)
    freq = np.array([0.0, 0.5, 1.5], np.float32)
    pres = np.array([0.2, 0.0, 1.0], np.float32)
    np.testing.assert_allclose(
        sampling.apply_penalties(_t(logits), _t(counts), _t(freq),
                                 _t(pres)).numpy(),
        np.asarray(jsamp.apply_penalties(
            jnp.asarray(logits), jnp.asarray(counts), jnp.asarray(freq),
            jnp.asarray(pres))),
        atol=TOL,
    )
    ids = np.array([[1, 5, V], [V, V, V], [0, 0, 39]], np.int32)
    vals = np.array([[2.0, -100.0, 7.0], [1.0, 1.0, 1.0], [1.0, 2.0, 3.0]],
                    np.float32)
    np.testing.assert_allclose(
        sampling.apply_logit_bias(_t(logits), _t(ids), _t(vals)).numpy(),
        np.asarray(jsamp.apply_logit_bias(
            jnp.asarray(logits), jnp.asarray(ids), jnp.asarray(vals))),
        atol=TOL,
    )
    steps = np.array([0, 5, 1], np.int32)
    mins = np.array([2, 2, 0], np.int32)
    stop = np.array([[0, 3], [0, V], [7, V]], np.int32)
    np.testing.assert_array_equal(
        sampling.suppress_stop_tokens(_t(logits), _t(steps), _t(mins),
                                      _t(stop)).numpy(),
        np.asarray(jsamp.suppress_stop_tokens(
            jnp.asarray(logits), jnp.asarray(steps), jnp.asarray(mins),
            jnp.asarray(stop))),
    )
