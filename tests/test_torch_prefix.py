"""The port's EngineCore with the prefix cache on vs the JAX EngineCore.

Both engines get the same weights (the JAX ``init_params`` tree carried
over with ``params_from_jax``), the same shape settings and the same
requests, in the same order; the JAX engine runs its jnp twins
(``use_pallas: False``), the port its plain versions.  Greedy output
must be token-identical, with equal prefix-cache hit tokens and COW
copies, and no page may stay in use after settle.  The scenarios are
those of tests/test_prefix_cache.py: a hit vs the cold output, a shared
prefix with divergent suffixes, identical prompts in one wave, a COW
partial page, multi-turn generated reuse and preemption under a tight
pool; plus chunked prefill and the flat hash-chain mode (``radix:
false``).
"""

import numpy as np
import pytest

import jax

from vgate_tpu.backends.base import SamplingParams as JSamplingParams
from vgate_tpu.config import load_config as j_load_config
from vgate_tpu.runtime.engine_core import EngineCore as JEngineCore
from vgate_tpu.runtime.weights import load_or_init_params as j_init
from vgate_tpu_torch.backends.base import SamplingParams
from vgate_tpu_torch.config import load_config
from vgate_tpu_torch.models.specs import TINY_DENSE
from vgate_tpu_torch.runtime.engine_core import EngineCore
from vgate_tpu_torch.runtime.weights import params_from_jax

PS = 4
MODEL = {"model_id": "tiny-dense", "dtype": "float32", "max_model_len": 96}
SHAPES = {
    "kv_num_pages": 96,
    "kv_page_size": PS,
    "max_batch_slots": 4,
    "prefill_buckets": [8, 16, 32],
}
# cow_min_tokens 8 can never fire at page size 4
RADIX = {"enabled": True, "cow_min_tokens": 2}


class Pair:
    """A JAX engine and a port engine with one weight tree; ``wave``
    submits the same requests to both and runs each to the end.

    The test drives each engine's tick itself, with no engine thread:
    every request of a wave is queued before the first tick, so
    admission, chunking and preemption follow the same event sequence
    in both engines whatever the machine's load (with threads, a busy
    host can split a wave across ticks in one engine and not the
    other)."""

    def __init__(self, prefix_cache=RADIX, model=None, **shapes):
        model = {**MODEL, **(model or {})}
        shapes = {**SHAPES, "prefix_cache": prefix_cache, **shapes}
        j_cfg = j_load_config(
            model={**model, "engine_type": "jax_tpu"},
            tpu={"dp": 1, "tp": 1, "ep": 1, "sp": 1, "use_pallas": False,
                 **shapes},
            scheduler={"max_queue_size": 16},
            integrity={"enabled": False},
            logging={"level": "ERROR"},
        )
        t_cfg = load_config(
            model={**model, "engine_type": "torch_cuda"},
            device={"device": "cpu", **shapes},
            scheduler={"max_queue_size": 16},
            logging={"level": "ERROR"},
        )
        jparams = j_init(TINY_DENSE, None, np.float32)
        self.j = JEngineCore(j_cfg, params=jparams,
                             devices=jax.devices()[:1])
        self.t = EngineCore(
            t_cfg,
            params=params_from_jax(jax.tree.map(np.asarray, jparams),
                                   TINY_DENSE),
        )

    def wave(self, prompts, max_tokens=8):
        """Token prompts (lists) or text prompts, submitted together to
        each engine; returns the port's generations after checking they
        equal the JAX engine's."""
        outs = []
        for core, sp in ((self.j, JSamplingParams), (self.t, SamplingParams)):
            params = sp(max_tokens=max_tokens, temperature=0.0)
            seqs = [
                core.submit_tokens(list(p), params) if isinstance(p, list)
                else core.submit_prompt(p, params)
                for p in prompts
            ]
            for _ in range(10_000):
                if all(seq.done_event.is_set() for seq in seqs):
                    break
                core._tick()
            assert all(seq.done_event.is_set() for seq in seqs)
            outs.append([list(s.generated_ids) for s in seqs])
        assert outs[1] == outs[0]
        return outs[1]

    def prefix_stats(self):
        """(port, JAX) scheduler prefix-cache blocks, after checking the
        counters the two engines share."""
        t = self.t.get_stats()["scheduler"]["prefix_cache"]
        j = self.j.get_stats()["scheduler"]["prefix_cache"]
        for key in ("hit_tokens", "hit_pages", "cow_copies", "mode"):
            assert t.get(key) == j.get(key), key
        return t, j

    def settle(self):
        """Equal prefix-cache counters, and nothing left in use."""
        self.prefix_stats()
        stats = self.t.get_stats()
        assert stats["running"] == 0
        assert stats["used_pages"] == 0
        assert stats["scheduler"]["waiting"] == 0

    def stop(self):
        self.j.stop()
        self.t.stop()


@pytest.fixture(scope="module")
def radix_pair():
    pair = Pair()
    yield pair
    pair.stop()


def test_hit_matches_cold_output(radix_pair):
    """The second identical prompt runs its suffix pass through the
    multi-token path and must repeat the cold output exactly."""
    base = " ".join(map(str, [7, 3, 9, 4, 11, 6, 2, 13, 5, 8, 12, 10, 14]))
    radix_pair.wave(["x"], max_tokens=1)
    [cold] = radix_pair.wave([base])
    hit0 = radix_pair.prefix_stats()[0]["hit_tokens"]
    [hit] = radix_pair.wave([base])
    assert radix_pair.prefix_stats()[0]["hit_tokens"] > hit0
    assert hit == cold
    radix_pair.settle()


def test_shared_prefix_divergent_suffixes(radix_pair):
    prefix = "alpha beta gamma delta epsilon zeta eta theta"
    hit0 = radix_pair.prefix_stats()[0]["hit_tokens"]
    [one] = radix_pair.wave([prefix + " one"])
    [two] = radix_pair.wave([prefix + " two"])
    assert radix_pair.prefix_stats()[0]["hit_tokens"] > hit0
    assert one != two or not one
    radix_pair.settle()


def test_identical_prompts_in_one_wave(radix_pair):
    """Two identical prompts admitted together: the second must not read
    pages whose writer was not enqueued yet, so both are right."""
    prompt = "wave one two three four five six seven eight nine"
    a, b = radix_pair.wave([prompt, prompt])
    assert a == b
    radix_pair.settle()


def test_cow_partial_page(radix_pair):
    """A prompt diverging inside a shared page copies the page's shared
    head (copy-on-write) and prefills from mid-page."""
    base = [7, 3, 9, 4, 11, 6, 2, 13, 5, 8, 12, 10, 14, 9]
    radix_pair.wave([base])
    cow0 = radix_pair.t.radix_cache.total_cow_copies
    radix_pair.wave([base[:10] + [21, 22, 23, 24]])  # 2 pages + 2 in-page
    assert radix_pair.t.radix_cache.total_cow_copies > cow0
    assert radix_pair.t.get_stats()["prefix_cache"]["cow_copies"] > cow0
    radix_pair.settle()


def test_multi_turn_generated_reuse(radix_pair):
    """Turn 2 re-sends turn 1's prompt and answer: the finished
    sequence's generated pages were indexed, so the hit reaches into
    the generated region."""
    t1 = [31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41]
    [answer] = radix_pair.wave([t1])
    hit0 = radix_pair.prefix_stats()[0]["hit_tokens"]
    radix_pair.wave([t1 + answer + [51, 52, 53, 54, 55]])
    hit = radix_pair.prefix_stats()[0]["hit_tokens"] - hit0
    assert hit > (len(t1) // PS) * PS
    radix_pair.settle()


def test_radix_stats_surface(radix_pair):
    t, _ = radix_pair.prefix_stats()
    assert t["mode"] == "radix" and t["inserted_pages"] > 0
    block = radix_pair.t.get_stats()["prefix_cache"]
    assert block["mode"] == "radix" and block["hit_tokens"] == t["hit_tokens"]


def test_preemption_under_a_tight_pool():
    """13 usable pages for 3 sequences needing ~15: preemption and
    eviction run with the prefix cache on, and both engines agree."""
    pair = Pair(kv_num_pages=14, max_batch_slots=3,
                model={"max_model_len": 64})
    try:
        pair.wave(["shared long prefix words " + tail
                   for tail in ("alpha", "beta", "gamma")], max_tokens=10)
        t, _ = pair.prefix_stats()
        sched = pair.t.get_stats()["scheduler"]
        assert sched["preemptions"] > 0 or t["evictions"] > 0
        assert (
            sched["preemptions"]
            == pair.j.get_stats()["scheduler"]["preemptions"]
        )
        pair.settle()
    finally:
        pair.stop()


def test_chunked_prefill():
    """prefill_chunk 8 at page size 4: a 30-token prompt runs three
    8-token passes and a final one; a second prompt sharing its first
    20 tokens hits the cache, then chunks from there."""
    pair = Pair(prefill_chunk=8)
    try:
        rng = np.random.default_rng(17)
        long = rng.integers(3, TINY_DENSE.vocab_size, size=30).tolist()
        pair.wave([long])
        block = pair.t.get_stats()["prefix_cache"]
        assert block["chunked_prefills"] == 1 and block["chunk_passes"] == 3
        other = long[:20] + rng.integers(3, 500, size=18).tolist()
        pair.wave([other])
        assert pair.prefix_stats()[0]["hit_tokens"] >= 20
        assert pair.t.get_stats()["prefix_cache"]["chunked_prefills"] == 2
        pair.settle()
    finally:
        pair.stop()


def test_flat_hash_chain_mode():
    """radix: false keeps the whole-page hash chain: hits are page
    aligned, nothing is copied on write."""
    pair = Pair(prefix_cache={"enabled": True, "radix": False})
    try:
        prefix = "alpha beta gamma delta epsilon zeta eta theta"
        [cold] = pair.wave([prefix + " one"])
        [hit] = pair.wave([prefix + " one"])
        pair.wave([prefix + " two", prefix + " three"])
        t, _ = pair.prefix_stats()
        assert t["mode"] == "flat" and t["hit_tokens"] > 0
        assert hit == cold
        assert pair.t.get_stats()["prefix_cache"]["cow_copies"] == 0
        pair.settle()
    finally:
        pair.stop()
