"""Speculative decoding in the port vs the JAX package: the drafters and
the acceptance count (runtime/speculative.py), the verify pass
(models/decoder.py ``spec_verify_forward``), the verify sampler
(ops/sampling.py ``verify_and_sample``) and the engine's speculative
tick (runtime/engine_core.py ``_tick_speculative``).

Inputs come from a numpy seed; weights go across with ``params_from_jax``.
Tolerances: the verify pass's fp32 logits within 1e-4 of the JAX pass
(the same fp32 sums in two frameworks' orders, two layers deep), its
pools equal on every written row (bit for bit on int8 and bf16 pools,
1e-6 on f32 pools); the verify pass against step-by-step decoding within
2e-4, as tests/test_speculative.py holds the reference.  Greedy engine
streams are token-identical: to the JAX speculative engine (both drive
``_tick`` from the test, each wave queued first) and to the port's plain
engine.  Sampled rows are held by distribution only (the port cannot
replay ``jax.random``): a chi-square test over 24,000 draws.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vgate_tpu.backends.base import SamplingParams as JSamplingParams
from vgate_tpu.config import load_config as j_load_config
from vgate_tpu.models import decoder as jdec
from vgate_tpu.models.specs import spec_for_model_id as j_spec_for
from vgate_tpu.ops import kv_quant as jkq
from vgate_tpu.runtime import speculative as jspec
from vgate_tpu.runtime.engine_core import EngineCore as JEngineCore
from vgate_tpu.runtime.weights import load_or_init_params as j_init
from vgate_tpu_torch.backends.base import SamplingParams
from vgate_tpu_torch.config import load_config
from vgate_tpu_torch.models import decoder as tdec
from vgate_tpu_torch.models.specs import spec_for_model_id
from vgate_tpu_torch.ops import kv_quant as tkq
from vgate_tpu_torch.ops.sampling import verify_and_sample
from vgate_tpu_torch.runtime import speculative as tspec
from vgate_tpu_torch.runtime.engine_core import EngineCore, rebuild_core
from vgate_tpu_torch.runtime.weights import params_from_jax


# ------------------------------------------------- drafter and counting

NGRAM_CASES = [
    ([5, 6, 9, 5, 6, 7, 5, 6], 3, 2),
    ([5, 6, 9, 5, 6, 7, 5, 6], 1, 2),
    ([1, 2, 3, 4], 3, 2),
    ([1, 2], 3, 2),
    ([], 3, 2),
    ([1, 2, 3], 0, 2),
    ([8, 9, 1, 8, 9], 4, 2),
    ([4, 4, 4, 4, 4], 3, 1),
    ([7, 1, 2, 3, 7, 1, 2], 2, 3),
]


@pytest.mark.parametrize("ids,k,ngram", NGRAM_CASES)
def test_ngram_draft_matches_reference(ids, k, ngram):
    assert tspec.ngram_draft(ids, k, ngram) == jspec.ngram_draft(
        ids, k, ngram
    )


def test_ngram_index_grows_like_the_reference():
    """The incremental index, fed a growing history, proposes what the
    reference's proposes at every length."""
    rng = np.random.default_rng(3)
    hist = rng.integers(0, 4, size=40).tolist()
    t, j = tspec.NgramIndex(2), jspec.NgramIndex(2)
    for n in range(len(hist) + 1):
        assert t.draft(hist[:n], 3) == j.draft(hist[:n], 3)
        assert t.n_indexed == j.n_indexed


@pytest.mark.parametrize("lens", [[4, 4, 4], [2, 4, 1], [1, 1, 1]])
def test_count_accepted_matches_reference(lens):
    model = np.asarray([[7, 8, 9, 1]] * 3, np.int32)
    toks = np.asarray([[0, 7, 8, 9], [0, 7, 5, 9], [0, 1, 8, 9]], np.int32)
    lens = np.asarray(lens, np.int32)
    got = tspec.count_accepted(
        torch.from_numpy(model), torch.from_numpy(toks),
        torch.from_numpy(lens),
    )
    want = jspec.count_accepted(
        jnp.asarray(model), jnp.asarray(toks), jnp.asarray(lens)
    )
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------- the verify pass

PS = 4


def _pools(kind, spec, P, rng):
    """K and V pools [L, KV, P, ps, hd] of random content in each
    package: f32, bf16, or int8 ``QuantPages``."""
    shape = (spec.num_layers, spec.num_kv_heads, P, PS, spec.head_dim)
    out = []
    for _ in range(2):
        vals = rng.normal(size=shape).astype(np.float32)
        if kind == "int8":
            q8, s = tkq.quantize(torch.from_numpy(vals))
            out.append((
                tkq.QuantPages(q8, s),
                jkq.QuantPages(jnp.asarray(q8.numpy()),
                               jnp.asarray(s.float().numpy(), jnp.bfloat16)),
            ))
        elif kind == "bf16":
            t = torch.from_numpy(vals).to(torch.bfloat16)
            out.append((t, jnp.asarray(t.float().numpy(), jnp.bfloat16)))
        else:
            out.append((torch.from_numpy(vals), jnp.asarray(vals)))
    return out


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _pool_parts(pool):
    return (pool.data, pool.scale) if hasattr(pool, "scale") else (pool,)


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("model", ["tiny-dense", "tiny-gemma2", "tiny-moe"])
def test_spec_verify_forward_matches_jax(model, kind):
    """Rows that start mid-page, input_lens below S, an inactive slot;
    Gemma-2's window of 8 on layer 0 and its softcaps.  The logits of
    every real row, and the pools on every page but the trash page."""
    spec, jspec_ = spec_for_model_id(model), j_spec_for(model)
    jparams = jdec.init_params(jspec_, jax.random.PRNGKey(1), jnp.float32)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), spec)
    rng = np.random.default_rng(11)
    B, S, width = 3, 4, 6
    P = 1 + B * width
    (tk, jk), (tv, jv) = _pools(kind, spec, P, rng)
    pt = (1 + np.arange(B * width, dtype=np.int32)).reshape(B, width)
    tokens = rng.integers(3, spec.vocab_size, size=(B, S)).astype(np.int32)
    pos0 = np.array([5, 13, 2], np.int32)
    lens = np.array([4, 2, 1], np.int32)
    active = np.array([True, True, False])
    jl, jk, jv = jdec.spec_verify_forward(
        jparams, jspec_, jnp.asarray(tokens), jnp.asarray(pos0),
        jnp.asarray(lens), jk, jv, jnp.asarray(pt),
        active=jnp.asarray(active),
    )
    tl = tdec.spec_verify_forward(
        tparams, spec, torch.from_numpy(tokens), torch.from_numpy(pos0),
        torch.from_numpy(lens), tk, tv, torch.from_numpy(pt),
        active=torch.from_numpy(active),
    )
    assert tl.dtype == torch.float32 and tl.shape == (B, S, spec.vocab_size)
    real = (np.arange(S)[None, :] < lens[:, None]) & active[:, None]
    np.testing.assert_allclose(tl.numpy()[real], np.asarray(jl)[real],
                               atol=1e-4, rtol=1e-4)
    for tpool, jpool in ((tk, jk), (tv, jv)):
        for tpart, jpart in zip(_pool_parts(tpool), _pool_parts(jpool)):
            got, want = _host(tpart)[:, :, 1:], _host(jpart)[:, :, 1:]
            if kind == "f32":
                np.testing.assert_allclose(got, want, atol=1e-6)
            else:
                np.testing.assert_array_equal(got, want)


def test_spec_verify_logits_match_stepwise_decode():
    """At every position the verify pass gives the logits of feeding the
    same tokens one decode step at a time (tests/test_speculative.py's
    check, on the port alone)."""
    spec = spec_for_model_id("tiny-dense")
    jparams = jdec.init_params(j_spec_for("tiny-dense"),
                               jax.random.PRNGKey(3), jnp.float32)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), spec)
    n_pages, B, S = 8, 2, 4
    P = 1 + B * n_pages
    shape = (spec.num_layers, spec.num_kv_heads, P, PS, spec.head_dim)
    kp, vp = torch.zeros(shape), torch.zeros(shape)
    pt = torch.from_numpy(
        (1 + np.arange(B * n_pages, dtype=np.int32)).reshape(B, n_pages)
    )
    rng = np.random.default_rng(9)
    prompt_lens = [6, 9]
    prompts = np.zeros((B, PS * 4), np.int32)
    for b, n in enumerate(prompt_lens):
        prompts[b, :n] = rng.integers(2, spec.vocab_size, size=n)
    tdec.prefill_forward(params, spec, torch.from_numpy(prompts),
                         torch.tensor(prompt_lens, dtype=torch.int32),
                         kp, vp, pt[:, :4])
    cand = torch.from_numpy(
        rng.integers(2, spec.vocab_size, size=(B, S)).astype(np.int32)
    )
    pos0 = torch.tensor(prompt_lens, dtype=torch.int32)
    active = torch.tensor([True, True])
    kv, vv = kp.clone(), vp.clone()
    ver = tdec.spec_verify_forward(params, spec, cand, pos0,
                                   torch.full((B,), S, dtype=torch.int32),
                                   kv, vv, pt, active=active)
    for j in range(S):
        step = tdec.decode_forward(params, spec, cand[:, j], pos0 + j,
                                   kp, vp, pt, active=active)
        np.testing.assert_allclose(ver[:, j].numpy(), step.numpy(),
                                   rtol=2e-4, atol=2e-4,
                                   err_msg=f"position {j}")


# -------------------------------------------------- the verify sampler


def _rows(R, value, dtype=torch.float32):
    return torch.full((R,), value, dtype=dtype)


def test_verify_greedy_rows_are_the_argmax():
    V, R = 8, 16
    rng = np.random.default_rng(4)
    logits = torch.from_numpy(rng.normal(size=(R, V)).astype(np.float32))
    am = logits.argmax(-1)
    draft = ((am + torch.arange(R) % 2) % V).to(torch.int32)  # half match
    for all_greedy in (False, True):
        toks, accept, _ = verify_and_sample(
            logits, draft, torch.zeros(R, dtype=torch.bool), _rows(R, 0.0),
            _rows(R, 1.0), _rows(R, 0, torch.int32), all_greedy=all_greedy,
        )
        np.testing.assert_array_equal(toks.numpy(), am.numpy())
        np.testing.assert_array_equal(accept.numpy(),
                                      (draft == am).numpy())


def test_verify_respects_the_top_k_mask():
    """With top_k 2 the distribution is the renormalized top two: a draft
    outside them is never accepted and emissions stay inside; a draft
    inside is accepted at its masked probability."""
    V, R = 10, 8192
    base = np.linspace(2.0, -2.0, V).astype(np.float32)
    logits = torch.from_numpy(np.broadcast_to(base, (R, V)).copy())
    masked_p = np.exp(base[:2]) / np.exp(base[:2]).sum()
    gen = torch.Generator().manual_seed(9)
    args = (torch.zeros(R, dtype=torch.bool), _rows(R, 1.0), _rows(R, 1.0),
            _rows(R, 2, torch.int32))
    toks, accept, _ = verify_and_sample(
        logits, _rows(R, 5, torch.int32), *args, generator=gen
    )
    assert not accept.any()
    assert set(np.unique(toks.numpy())) <= {0, 1}
    _, accept1, _ = verify_and_sample(
        logits, _rows(R, 1, torch.int32), *args, generator=gen
    )
    assert abs(float(accept1.float().mean()) - masked_p[1]) < 0.03


def _chi2(counts, p):
    expect = counts.sum() * p
    return float(((counts - expect) ** 2 / expect).sum())


# chi-square with 11 degrees of freedom, P(X > 31.26) = 0.001
CHI2_11_001 = 31.26


@pytest.mark.parametrize("bonus", [False, True])
def test_verify_samples_are_p_distributed(bonus):
    """Accept the draft with p(draft), else resample without it: every
    emitted token is p-distributed (chi-square over 24,000 rows, 12
    tokens); the acceptance rate is p(draft), a rejection never emits the
    draft, and bonus rows accept nothing."""
    V, R, draft = 12, 24000, 3
    base = np.linspace(1.0, -1.5, V).astype(np.float32)
    p = np.exp(base) / np.exp(base).sum()
    logits = torch.from_numpy(np.broadcast_to(base, (R, V)).copy())
    gen = torch.Generator().manual_seed(7 + bonus)
    toks, accept, _ = verify_and_sample(
        logits, _rows(R, draft, torch.int32),
        torch.full((R,), bonus, dtype=torch.bool), _rows(R, 1.0),
        _rows(R, 1.0), _rows(R, 0, torch.int32), generator=gen,
    )
    counts = np.bincount(toks.numpy(), minlength=V).astype(np.float64)
    assert _chi2(counts, p) < CHI2_11_001
    if bonus:
        assert not accept.any()
    else:
        assert abs(float(accept.float().mean()) - p[draft]) < 0.01
        assert not (toks[~accept] == draft).any()


def test_verify_seeded_rows_repeat():
    """A seeded row's acceptance and draw are functions of (seed, step):
    the same under another generator state, with logprobs the same."""
    V, R = 50, 6
    rng = np.random.default_rng(2)
    logits = torch.from_numpy(rng.normal(size=(R, V)).astype(np.float32))
    seeds = torch.tensor([42, 42, 7, -1, 42, 9])
    steps = torch.tensor([0, 1, 0, 0, 0, 3])
    args = (logits, logits.argmax(-1).to(torch.int32),
            torch.tensor([False, False, False, False, True, False]),
            _rows(R, 0.9), _rows(R, 0.95), _rows(R, 0, torch.int32))
    runs = [
        verify_and_sample(*args, generator=torch.Generator().manual_seed(g),
                          seeds=seeds, steps=steps, num_top=3)
        for g in (1, 2)
    ]
    seeded = seeds >= 0
    for a, b in zip(runs[0][:2], runs[1][:2]):
        assert torch.equal(a[seeded], b[seeded])
    assert torch.equal(runs[0][2][0][seeded], runs[1][2][0][seeded])
    lse = torch.logsumexp(logits, -1)
    np.testing.assert_allclose(
        runs[0][2][0].numpy(),
        (logits.gather(1, runs[0][0].long()[:, None])[:, 0] - lse).numpy(),
        atol=1e-5,
    )


# ------------------------------------------------------------- engines

MODEL = {"dtype": "float32", "max_model_len": 64}
SHAPES = {"kv_num_pages": 96, "kv_page_size": PS, "max_batch_slots": 4,
          "prefill_buckets": [8, 16, 32]}
RADIX = {"enabled": True, "cow_min_tokens": 2}


def _greedy(n, **kw):
    return dict(max_tokens=n, temperature=0.0, **kw)


def _drive(core, reqs, sp_cls):
    """Queue every request of the wave, then tick the engine to the end
    (no engine thread); returns the sequences."""
    seqs = [
        core.submit_tokens(list(p), sp_cls(**kw)) if isinstance(p, list)
        else core.submit_prompt(p, sp_cls(**kw))
        for p, kw in reqs
    ]
    for _ in range(10_000):
        if all(s.done_event.is_set() for s in seqs):
            break
        core._tick()
    assert all(s.done_event.is_set() for s in seqs)
    return seqs


class Engines:
    """A JAX speculative engine, the port's speculative engine and the
    port's plain engine over one weight tree (the JAX draft model's tree
    too, when there is one); ``wave`` serves the same requests on all
    three and checks the streams are equal."""

    def __init__(self, model_id="tiny-dense", k=3, ngram=2, draft=None,
                 kv_dtype="auto", prefix_cache=False):
        model = {**MODEL, "model_id": model_id}
        shapes = {**SHAPES, "prefix_cache": prefix_cache}
        spec_keys = {"speculative_k": k, "speculative_ngram": ngram,
                     "draft_window": 32}
        jmodel = {**model, "engine_type": "jax_tpu"}
        tmodel = {**model}
        if draft:
            jmodel["draft_model_id"] = tmodel["draft_model_id"] = draft
        common = dict(scheduler={"max_queue_size": 16},
                      kv_cache={"dtype": kv_dtype},
                      logging={"level": "ERROR"})
        j_cfg = j_load_config(
            model=jmodel,
            tpu={"dp": 1, "tp": 1, "ep": 1, "sp": 1, "use_pallas": False,
                 **shapes, **spec_keys},
            integrity={"enabled": False}, **common,
        )
        self.spec = spec_for_model_id(model_id)
        jparams = j_init(j_spec_for(model_id), None, np.float32)
        self.j = JEngineCore(j_cfg, params=jparams,
                             devices=jax.devices()[:1])

        def port(**dev):
            cfg = load_config(
                model=tmodel if dev else model,
                device={"device": "cpu", **shapes, **dev}, **common,
            )
            return EngineCore(cfg, params=params_from_jax(
                jax.tree.map(np.asarray, jparams), self.spec))

        self.t = port(**spec_keys)
        self.plain = port()
        if draft:
            self.t.draft_model.params = params_from_jax(
                jax.tree.map(np.asarray, self.j.draft_model.params),
                spec_for_model_id(draft),
            )

    def wave(self, reqs, plain=True):
        """Same token streams and finish reasons on every engine."""
        engines = [(self.j, JSamplingParams), (self.t, SamplingParams)]
        if plain:
            engines.append((self.plain, SamplingParams))
        outs = []
        for core, sp in engines:
            seqs = _drive(core, reqs, sp)
            outs.append([(list(s.generated_ids), s.finish_reason)
                         for s in seqs])
        for out in outs[1:]:
            assert out == outs[0]
        return outs[1]

    def spec_stats(self):
        t = self.t.get_stats()["speculative"]
        j = self.j.get_stats()["speculative"]
        for key in ("k", "drafter", "drafted", "accepted",
                    "acceptance_rate"):
            assert t[key] == j[key], key
        return t

    def stop(self):
        for core in (self.j, self.t, self.plain):
            core.stop()


REPEAT = [1, 2, 3, 1, 2, 3, 1, 2, 3, 1, 2, 3]
TEXTS = ["repeat repeat repeat repeat", "one two three four", "zzz"]


@pytest.fixture(scope="module")
def dense():
    e = Engines()
    yield e
    e.stop()


def test_ngram_engine_matches_jax_and_plain(dense):
    dense.wave([(p, _greedy(12)) for p in TEXTS] + [(REPEAT, _greedy(12))])
    stats = dense.spec_stats()
    assert stats["drafted"] > 0 and stats["rounds"] > 0


def test_exact_budgets_penalties_bias_and_min_tokens(dense):
    """Exact max_tokens under multi-token rounds, and every logit
    transform: penalties (the run's histogram position by position),
    logit bias and min-token stop suppression at every position."""
    eos = dense.t.tokenizer.eos_id
    out = dense.wave([
        (REPEAT, _greedy(7)),
        (REPEAT, _greedy(9, frequency_penalty=0.8, presence_penalty=0.4)),
        ("one two three four", _greedy(8, logit_bias={5: 4.0, 66: -100.0})),
        ([4, 9, 4, 9, 4, 9], _greedy(10, min_tokens=6,
                                     stop_token_ids=[eos, 9])),
        (REPEAT, _greedy(5)),
    ])
    assert [len(ids) for ids, _ in out][:3] == [7, 9, 8]
    assert len(out[4][0]) == 5
    dense.spec_stats()


def test_oracle_drafter_accepts_and_saves_rounds(dense):
    """A drafter that knows the plain engine's continuation: every round
    accepts its drafts: after the prompt pass's token, 11 take three
    rounds (3 + 3 + 2 drafts accepted, each with its bonus token), and
    the streams still equal the JAX engine's with the same oracle."""
    reqs = [(REPEAT, _greedy(12)), ("oracle probe", _greedy(12))]
    truth = {
        tuple(s.prompt_ids): list(s.generated_ids)
        for s in _drive(dense.plain, reqs, SamplingParams)
    }

    def oracle(seq, k):
        done = seq.num_generated
        return truth[tuple(seq.prompt_ids)][done : done + k]

    dense.t.drafter = dense.j.drafter = oracle
    try:
        before = (dense.t.total_spec_rounds, dense.t.total_spec_accepted)
        out = dense.wave(reqs, plain=False)
        rounds = dense.t.total_spec_rounds - before[0]
        accepted = dense.t.total_spec_accepted - before[1]
    finally:
        dense.t.drafter = dense.t._ngram_drafter
        dense.j.drafter = dense.j._ngram_drafter
    assert [ids for ids, _ in out] == list(truth.values())
    assert rounds == 3
    assert accepted == 2 * (3 + 3 + 2)


def test_seeded_sampled_stream_repeats_under_speculation(dense):
    """A seeded sampled request (logprobs on) drafts like any row (a
    drafter that always proposes, as tests/test_speculative.py's) and
    repeats on the port's speculative engine, with finite logprobs."""
    req = ("seeded spec repro probe probe probe",
           dict(max_tokens=12, temperature=0.8, seed=42, logprobs=True,
                top_logprobs=3))
    dense.t.drafter = lambda seq, k: [7] * k
    try:
        before = dense.t.total_spec_drafted
        runs = [_drive(dense.t, [req, (REPEAT, _greedy(4))], SamplingParams)
                for _ in range(2)]
        assert dense.t.total_spec_drafted > before
    finally:
        dense.t.drafter = dense.t._ngram_drafter
    a, b = runs[0][0], runs[1][0]
    assert list(a.generated_ids) == list(b.generated_ids)
    assert a.num_output_tokens == 12
    lps = [lp for lp, _ in a.logprob_data]
    assert len(lps) == 12 and np.isfinite(lps).all()
    assert lps == [lp for lp, _ in b.logprob_data]


def test_brownout_suspends_and_resumes_mid_stream(dense):
    """Suspension mid-stream hands the running sequences to the decode
    chunks (which must reload their state: the rounds moved positions),
    and resuming hands them back; the streams stay the plain engine's."""
    core = dense.t
    reqs = [(REPEAT, _greedy(30)), ("one two three four", _greedy(24))]
    want = [list(s.generated_ids)
            for s in _drive(dense.plain, reqs, SamplingParams)]
    seqs = [core.submit_tokens(list(p), SamplingParams(**kw))
            if isinstance(p, list)
            else core.submit_prompt(p, SamplingParams(**kw))
            for p, kw in reqs]
    chunks0, rounds0 = core.total_chunks, core.total_spec_rounds
    for _ in range(3):
        core._tick()
    core.set_spec_suspended(True)
    for _ in range(3):
        core._tick()
    assert core.total_chunks > chunks0
    rounds_mid = core.total_spec_rounds
    core.set_spec_suspended(False)
    for _ in range(10_000):
        if all(s.done_event.is_set() for s in seqs):
            break
        core._tick()
    assert core.total_spec_rounds > rounds_mid > rounds0
    assert [list(s.generated_ids) for s in seqs] == want
    assert core.get_stats()["speculative"]["suspended"] is False


def test_prefix_cache_and_int8_kv_match_jax():
    """The prefix cache on (a hit, then speculative rounds writing only
    the sequence's own pages) with int8 pools, held to the reference's
    own int8 output."""
    e = Engines(kv_dtype="int8", prefix_cache=RADIX)
    try:
        prompt = "shared prefix prompt body, shared prefix"
        first = e.wave([(prompt, _greedy(10))])
        again = e.wave([(prompt, _greedy(10)), (REPEAT, _greedy(8))])
        assert again[0] == first[0]
        e.spec_stats()
        assert e.t.get_stats()["used_pages"] == 0
    finally:
        e.stop()


def test_gemma2_window_matches_jax():
    e = Engines(model_id="tiny-gemma2")
    try:
        e.wave([(REPEAT + REPEAT, _greedy(16)), ("abc abc abc", _greedy(12))])
        e.spec_stats()
    finally:
        e.stop()


def test_moe_matches_jax():
    """``tiny-moe``: a verify pass routes its B x S candidate rows through
    the experts in one dispatch, as the reference's does."""
    e = Engines(model_id="tiny-moe")
    try:
        e.wave([(REPEAT + REPEAT, _greedy(16)), ("abc abc abc", _greedy(12))])
        e.spec_stats()
    finally:
        e.stop()


def test_draft_model_engine_matches_jax_and_plain():
    """tiny-dense drafting for itself (the JAX drafter's weights carried
    over): the streams equal both engines', and so do the drafts and the
    acceptance."""
    e = Engines(draft="tiny-dense")
    try:
        assert e.t.draft_model is not None
        e.wave([("one two three four", _greedy(12)), ("zzz", _greedy(12))])
        stats = e.spec_stats()
        assert stats["drafter"] == "draft-model:tiny-dense"
        assert stats["draft_calls"] > 0
        assert stats["acceptance_rate"] > 0.6, stats
    finally:
        e.stop()


def test_draft_model_drafter_matches_reference_standalone():
    """The drafter's scan (prompt passes over the window, the window
    shifting once full) proposes the reference's tokens."""
    from vgate_tpu.runtime.speculative import DraftModelDrafter as JDraft

    j = JDraft("tiny-dense", k_max=4, dtype=jnp.float32, window=8)
    t = tspec.DraftModelDrafter("tiny-dense", k_max=4, dtype=torch.float32,
                                window=8)
    t.params = params_from_jax(jax.tree.map(np.asarray, j.params),
                               spec_for_model_id("tiny-dense"))

    class _Seq:
        prompt_ids = [5, 9, 13, 40, 41]
        output_ids = [21]

    toks = t.draft_for(_Seq(), 4)
    assert toks == j.draft_for(_Seq(), 4)  # the window fills, then shifts
    assert t.draft_for(_Seq(), 0) == []
    assert t.draft_for(_Seq(), 2) == toks[:2]
    t.target_vocab = min(toks)  # ids past the target's vocab end it
    assert t.draft_for(_Seq(), 4) == []
    assert t.total_draft_calls == 3


def test_spec_state_survives_a_rebuild():
    """rebuild_core carries the brownout flag and drops the old core's
    speculative caches and draft model."""
    cfg = load_config(
        model={**MODEL, "model_id": "tiny-dense",
               "draft_model_id": "tiny-dense"},
        device={"device": "cpu", **SHAPES, "speculative_k": 2,
                "draft_window": 16},
        logging={"level": "ERROR"},
    )
    old = EngineCore(cfg)
    _drive(old, [(REPEAT, dict(max_tokens=6, temperature=0.0,
                               frequency_penalty=0.5))], SamplingParams)
    assert old._spec_pen is not None
    old.set_spec_suspended(True)
    new = rebuild_core(old, cfg)
    try:
        assert new.spec_suspended and new.spec_k == 2
        assert new.draft_model is not None
        assert old.draft_model is None and old._spec_pen is None
        assert new.get_stats()["speculative"]["suspended"] is True
    finally:
        new.stop()
