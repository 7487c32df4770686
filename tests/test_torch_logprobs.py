"""The port's logprobs against the JAX package's (tests/test_logprobs.py).

``sample_tokens_with_logprobs`` is held to the JAX function on seeded
numpy logits, with and without penalties: the chosen logprob and the
top ids and logprobs are the log-softmax of the logits after penalties;
greedy rows draw the same token.  Engine pairs on ``tiny-dense`` in
float32 (the JAX engine on its jnp twins, the port on its plain
versions, one weight tree) serve greedy requests with ``top_logprobs``
0, 3 and 8 through a prompt pass, a prefix hit and a chunked prompt,
and through the decode chunks after each: tokens and top ids must be
equal and logprobs within ``atol 1e-4`` (float32 log-softmax, sums in
another order).  Requests without logprobs keep their outputs.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vgate_tpu.backends.base import SamplingParams as JSamplingParams
from vgate_tpu.config import load_config as j_load_config
from vgate_tpu.ops import sampling as jsampling
from vgate_tpu.runtime.engine_core import EngineCore as JEngineCore
from vgate_tpu.runtime.weights import load_or_init_params as j_init
from vgate_tpu_torch.backends.base import SamplingParams
from vgate_tpu_torch.config import load_config
from vgate_tpu_torch.models.specs import TINY_DENSE
from vgate_tpu_torch.ops import sampling
from vgate_tpu_torch.runtime.engine_core import EngineCore
from vgate_tpu_torch.runtime.weights import params_from_jax

LP_TOL = 1e-4


@pytest.mark.parametrize("penalties", [False, True])
def test_sampler_logprobs_match_jax(penalties):
    rng = np.random.default_rng(7)
    B, V = 6, 300
    logits = (rng.normal(size=(B, V)) * 3).astype(np.float32)
    temps = np.array([0, 0, 0, 0.9, 0.7, 1.2], np.float32)
    top_ps = np.array([1, 0.9, 1, 0.8, 1, 0.95], np.float32)
    top_ks = np.array([0, 0, 5, 0, 40, 0], np.int32)
    j_logits, t_logits = jnp.asarray(logits), torch.from_numpy(logits)
    if penalties:
        counts = rng.integers(0, 3, size=(B, V)).astype(np.int32)
        freq = rng.uniform(0, 1, B).astype(np.float32)
        pres = rng.uniform(0, 1, B).astype(np.float32)
        j_logits = jsampling.apply_penalties(
            j_logits, jnp.asarray(counts), jnp.asarray(freq),
            jnp.asarray(pres))
        t_logits = sampling.apply_penalties(
            t_logits, torch.from_numpy(counts), torch.from_numpy(freq),
            torch.from_numpy(pres))
    j_out = jsampling.sample_tokens_with_logprobs(
        j_logits, jnp.asarray(temps), jnp.asarray(top_ps),
        jnp.asarray(top_ks), jax.random.PRNGKey(3), num_top=8)
    t_out = sampling.sample_tokens_with_logprobs(
        t_logits, torch.from_numpy(temps), torch.from_numpy(top_ps),
        torch.from_numpy(top_ks), torch.Generator().manual_seed(3),
        num_top=8)
    j_tok, j_lp, j_ids, j_lps = (np.asarray(a) for a in j_out)
    t_tok, t_lp, t_ids, t_lps = (a.numpy() for a in t_out)
    # the reported distribution does not depend on the noise
    np.testing.assert_array_equal(t_ids, j_ids)
    np.testing.assert_allclose(t_lps, j_lps, atol=LP_TOL, rtol=0)
    # greedy rows draw the argmax in both; sampled rows draw other noise
    # (torch.Generator vs jax.random), so only their own consistency
    greedy = temps == 0
    np.testing.assert_array_equal(t_tok[greedy], j_tok[greedy])
    np.testing.assert_allclose(t_lp[greedy], j_lp[greedy], atol=LP_TOL,
                               rtol=0)
    ref = torch.log_softmax(t_logits.float(), -1).numpy()
    np.testing.assert_allclose(t_lp, ref[np.arange(B), t_tok], atol=LP_TOL,
                               rtol=0)
    # the logprobs variant draws what plain sampling draws from the noise
    plain = sampling.sample_tokens(
        t_logits, torch.from_numpy(temps), torch.from_numpy(top_ps),
        torch.from_numpy(top_ks), torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(plain.numpy(), t_tok)


MODEL = {"model_id": "tiny-dense", "dtype": "float32", "max_model_len": 96}
SHAPES = {"kv_num_pages": 96, "kv_page_size": 4, "max_batch_slots": 4,
          "prefill_buckets": [8, 16, 32], "prefill_chunk": 8,
          "prefix_cache": {"enabled": True, "cow_min_tokens": 2}}


@pytest.fixture(scope="module")
def weights():
    jparams = j_init(TINY_DENSE, None, np.float32)
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams),
                                    TINY_DENSE)


def _pair(weights, **shapes):
    jparams, tparams = weights
    shapes = {**SHAPES, **shapes}
    j = JEngineCore(
        j_load_config(
            model={**MODEL, "engine_type": "jax_tpu"},
            tpu={"dp": 1, "tp": 1, "ep": 1, "sp": 1, "use_pallas": False,
                 **shapes},
            scheduler={"max_queue_size": 16}, integrity={"enabled": False},
            logging={"level": "ERROR"},
        ),
        params=jparams, devices=jax.devices()[:1],
    )
    t = EngineCore(
        load_config(model={**MODEL, "engine_type": "torch_cuda"},
                    device={"device": "cpu", **shapes},
                    scheduler={"max_queue_size": 16},
                    logging={"level": "ERROR"}),
        params=tparams,
    )
    return j, t


def _wave(core, sp_cls, prompts, **kw):
    """Queue every prompt, then drive the engine's tick (no thread)."""
    seqs = [core.submit_tokens(list(p), sp_cls(**kw)) for p in prompts]
    for _ in range(10_000):
        if all(s.done_event.is_set() for s in seqs):
            break
        core._tick()
    assert all(s.done_event.is_set() for s in seqs)
    return seqs


def _same(t_seqs, j_seqs, top: int) -> None:
    for ts, js in zip(t_seqs, j_seqs):
        assert ts.generated_ids == js.generated_ids
        assert len(ts.logprob_data) == len(ts.generated_ids)
        for (t_lp, t_top), (j_lp, j_top), tid in zip(
                ts.logprob_data, js.logprob_data, ts.generated_ids):
            assert abs(t_lp - j_lp) <= LP_TOL
            assert [i for i, _ in t_top] == [i for i, _ in j_top]
            np.testing.assert_allclose([l for _, l in t_top],
                                       [l for _, l in j_top], atol=LP_TOL,
                                       rtol=0)
            assert len(t_top) == top
            if top:
                assert t_top[0][0] == tid  # greedy: the most likely


@pytest.mark.parametrize("top", [0, 3, 8])
def test_engine_logprobs_match_jax(weights, top):
    """A 13- and a 30-token prompt in one wave (both chunked at 8: a
    prompt pass per chunk), then a prefix hit (the first prompt again
    plus a tail: a suffix pass) beside a cold 3-token prompt (a prompt
    pass), 12 tokens each through decode chunks of 8, 2 and 1."""
    j, t = _pair(weights)
    rng = np.random.default_rng(top)
    cold = rng.integers(3, 500, size=13).tolist()
    long = rng.integers(3, 500, size=30).tolist()
    waves = [[cold, long], [cold + [7, 9, 11], [4, 5, 6]]]
    kw = dict(max_tokens=12, temperature=0.0, logprobs=True,
              top_logprobs=top)
    try:
        for prompts in waves:
            js = _wave(j, JSamplingParams, prompts, **kw)
            ts = _wave(t, SamplingParams, prompts, **kw)
            _same(ts, js, top)
        stats = t.get_stats()["prefix_cache"]
        assert stats["hit_tokens"] >= 12 and stats["chunked_prefills"] >= 1
    finally:
        j.stop()
        t.stop()


def test_requests_without_logprobs_keep_their_outputs(weights):
    """A wave where one row asks for logprobs (every pass and chunk then
    computes them) serves the other rows the tokens a wave without
    logprobs gives them, and gives them no logprob data."""
    _, tparams = weights
    cfg = load_config(model={**MODEL, "engine_type": "torch_cuda"},
                      device={"device": "cpu", **SHAPES,
                              "prefix_cache": False},
                      logging={"level": "ERROR"})
    prompts = ["first probe", "second probe here", "third"]
    plain = SamplingParams(max_tokens=10, temperature=0.0)
    with_lp = SamplingParams(max_tokens=10, temperature=0.0, logprobs=True,
                             top_logprobs=2)
    core = EngineCore(cfg, params=tparams)
    core.start()
    try:
        base = core.generate(prompts, [plain] * 3)
        mixed = core.generate(prompts, [with_lp, plain, plain])
    finally:
        core.stop()
    assert [r["token_ids"] for r in mixed] == [r["token_ids"] for r in base]
    assert all("logprobs" not in r for r in base + mixed[1:])
    entries = mixed[0]["logprobs"]
    assert len(entries) == mixed[0]["num_tokens"] == 10
    for entry, tid in zip(entries, mixed[0]["token_ids"]):
        assert entry["token_id"] == tid and entry["logprob"] <= 0.0
        assert [e["token_id"] for e in entry["top_logprobs"]][0] == tid
        assert isinstance(entry["token"], str)
