"""The port's EngineCore vs the JAX EngineCore on the CPU (tiny-dense).

Both engines get the same weights (the JAX ``init_params`` tree carried
over with ``params_from_jax``) and the same shape settings (the JAX
``tpu`` section is the port's ``device`` section).  Greedy decoding must
be token-identical, for a concurrent batch on fewer slots than prompts
and for a tight pool that forces preemption; no page may leak.
"""

import numpy as np
import pytest
import torch

import jax

from vgate_tpu.backends.base import SamplingParams as JSamplingParams
from vgate_tpu.config import load_config as j_load_config
from vgate_tpu.runtime.engine_core import EngineCore as JEngineCore
from vgate_tpu.runtime.weights import load_or_init_params as j_init
from vgate_tpu_torch.backends.base import SamplingParams
from vgate_tpu_torch.config import NotPortedError, load_config
from vgate_tpu_torch.engine import VGTEngine
from vgate_tpu_torch.models.specs import TINY_DENSE
from vgate_tpu_torch.runtime.engine_core import EngineCore
from vgate_tpu_torch.runtime.weights import params_from_jax

MODEL = {"model_id": "tiny-dense", "dtype": "float32", "max_model_len": 64}
SHAPES = {
    "kv_num_pages": 64,
    "kv_page_size": 4,
    "max_batch_slots": 4,
    "prefill_buckets": [8, 16, 32],
    "prefix_cache": False,
}
PROMPTS = [
    "alpha beta", "gamma", "delta epsilon zeta", "eta theta iota kappa",
    "lambda", "mu nu xi omicron pi rho",
]


def _configs(**shape_overrides):
    shapes = {**SHAPES, **shape_overrides}
    j_cfg = j_load_config(
        model={**MODEL, "engine_type": "jax_tpu"},
        tpu={"dp": 1, "tp": 1, "ep": 1, "sp": 1, "use_pallas": False,
             **shapes},
        scheduler={"max_queue_size": 16},
        integrity={"enabled": False},
        logging={"level": "WARNING"},
    )
    t_cfg = load_config(
        model={**MODEL, "engine_type": "torch_cuda"},
        device={"device": "cpu", **shapes},
        scheduler={"max_queue_size": 16},
        logging={"level": "WARNING"},
    )
    return j_cfg, t_cfg


def _engines(**shape_overrides):
    j_cfg, t_cfg = _configs(**shape_overrides)
    jparams = j_init(TINY_DENSE, None, np.float32)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), TINY_DENSE)
    j = JEngineCore(j_cfg, params=jparams, devices=jax.devices()[:1])
    t = EngineCore(t_cfg, params=tparams)
    return j, t


def _run(core, prompts, params):
    core.start()
    try:
        seqs = [core.submit_prompt(p, sp) for p, sp in zip(prompts, params)]
        for seq in seqs:
            assert seq.done_event.wait(timeout=300)
        return seqs
    finally:
        core.stop()


def test_greedy_concurrent_batch_token_identical():
    """6 prompts on 4 slots, 24 tokens each at page size 4: the batch
    crosses page boundaries and refills freed slots mid-decode."""
    j, t = _engines()
    jseqs = _run(j, PROMPTS, [JSamplingParams(max_tokens=24,
                                              temperature=0.0)] * 6)
    tseqs = _run(t, PROMPTS, [SamplingParams(max_tokens=24,
                                             temperature=0.0)] * 6)
    for js, ts in zip(jseqs, tseqs):
        assert ts.generated_ids == js.generated_ids
        assert ts.finish_reason == js.finish_reason
    stats = t.get_stats()
    assert stats["used_pages"] == 0
    assert stats["running"] == 0
    assert stats["admitted"] == stats["finished"] == len(PROMPTS)


def test_greedy_preemption_token_identical():
    """A pool too small for three growing sequences preempts one; the
    recompute path must reproduce the JAX engine's tokens exactly."""
    j, t = _engines(kv_num_pages=15, decode_chunk=1)
    prompts = ["preempt probe one", "preempt probe two", "preempt pr three"]
    jseqs = _run(j, prompts, [JSamplingParams(max_tokens=10,
                                              temperature=0.0)] * 3)
    tseqs = _run(t, prompts, [SamplingParams(max_tokens=10,
                                             temperature=0.0)] * 3)
    assert t.scheduler.total_preemptions >= 1
    assert t.scheduler.total_preemptions == j.scheduler.total_preemptions
    for js, ts in zip(jseqs, tseqs):
        assert ts.num_output_tokens == 10
        assert ts.generated_ids == js.generated_ids
    assert t.get_stats()["used_pages"] == 0


def test_sampled_requests_finish_and_seeds_reproduce():
    _, t = _engines()
    params = [
        SamplingParams(max_tokens=12, temperature=0.8, top_p=0.9, seed=7),
        SamplingParams(max_tokens=12, temperature=0.8, top_k=5),
        SamplingParams(max_tokens=12, temperature=0.0),
    ]
    first = _run(t, PROMPTS[:3], params)
    t2 = EngineCore(t.config, params=t.params)
    again = _run(t2, PROMPTS[:3], params)
    assert [s.num_output_tokens for s in first] == [12, 12, 12]
    assert first[0].generated_ids == again[0].generated_ids  # seeded
    assert first[2].generated_ids == again[2].generated_ids  # greedy


def test_vgt_engine_generate_batch_on_cpu():
    _, t_cfg = _configs()
    engine = VGTEngine(t_cfg)
    try:
        results = engine.generate_batch(
            PROMPTS[:3], [SamplingParams(max_tokens=6, temperature=0.0)] * 3
        )
        assert [r.num_tokens for r in results] == [6, 6, 6]
        assert all(r.finish_reason == "length" for r in results)
        single = engine.chat_completions("hello", max_tokens=4,
                                         temperature=0.0)
        assert single["num_tokens"] == 4
        core = engine.backend.core
        assert core.get_stats()["used_pages"] == 0
        assert core.device == torch.device("cpu")
    finally:
        engine.shutdown()


def test_logprobs_request_raises_typed_error():
    _, t = _engines()
    with pytest.raises(NotPortedError):
        t.submit_prompt("x", SamplingParams(max_tokens=2, logprobs=True))
