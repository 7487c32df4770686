"""The port engine's Prometheus series against the JAX engine's.

Both engines get one weight tree and the same waves, and the test
drives each engine's tick itself.  In one process the two packages
share the collectors (``metrics._safe_metric`` returns the collector
already registered), so each engine's series are read on its own:
counters as deltas around that engine's wave, gauges right after it
(before the other engine runs), and the pool's construction-time gauges
right after that engine is built.
"""

import numpy as np
import pytest
from prometheus_client import REGISTRY

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
MODEL = {"model_id": "tiny-dense", "dtype": "float32", "max_model_len": 64}
SHAPES = {
    "kv_num_pages": 64,
    "kv_page_size": PS,
    "max_batch_slots": 4,
    "prefill_buckets": [8, 16, 32],
    "decode_chunk": 4,
    "prefix_cache": {"enabled": True, "cow_min_tokens": 2},
}

# (name, labels) of the counters and histogram counts compared as deltas
COUNTERS = [
    ("vgt_prefix_hit_tokens_total", {}),
    ("vgt_prefix_hit_pages_total", {}),
    ("vgt_prefix_cow_copies_total", {}),
    ("vgt_preempted_sequences_total", {}),
    ("vgt_preempt_recompute_tokens_total", {}),
    ("vgt_cancelled_requests_total", {"reason": "deadline"}),
    ("vgt_engine_step_seconds_count", {"kind": "prefill"}),
    ("vgt_engine_step_seconds_count", {"kind": "decode"}),
]
# gauges read after a wave, and after the wave's first tick
GAUGES = [
    ("vgt_prefix_cached_pages", {}),
    ("vgt_engine_queue_depth", {}),
    ("vgt_active_sequences", {}),
    ("vgt_kv_pages_in_use", {}),
]
# set when the pool is built
POOL_GAUGES = [
    ("vgt_kv_pages_total", {}),
    ("vgt_kv_dtype", {"dtype": "f32"}),
    ("vgt_kv_dtype", {"dtype": "bf16"}),
]


def sample(name, labels):
    return REGISTRY.get_sample_value(name, labels) or 0.0


def read(series):
    return {(n, tuple(sorted(l.items()))): sample(n, l) for n, l in series}


class Engines:
    """A JAX engine and a port engine over one weight tree, each with
    the construction-time gauges read right after it was built."""

    def __init__(self, **shapes):
        shapes = {**SHAPES, **shapes}
        j_cfg = j_load_config(
            model={**MODEL, "engine_type": "jax_tpu"},
            tpu={"dp": 1, "tp": 1, "ep": 1, "sp": 1, "use_pallas": False,
                 **shapes},
            scheduler={"max_queue_size": 16},
            integrity={"enabled": False},
            logging={"level": "ERROR"},
        )
        t_cfg = load_config(
            model={**MODEL, "engine_type": "torch_cuda"},
            device={"device": "cpu", **shapes},
            scheduler={"max_queue_size": 16},
            logging={"level": "ERROR"},
        )
        jparams = j_init(TINY_DENSE, None, np.float32)
        self.j = JEngineCore(j_cfg, params=jparams,
                             devices=jax.devices()[:1])
        self.pool = {"j": read(POOL_GAUGES)}
        self.t = EngineCore(
            t_cfg,
            params=params_from_jax(jax.tree.map(np.asarray, jparams),
                                   TINY_DENSE),
        )
        self.pool["t"] = read(POOL_GAUGES)

    def wave(self, prompts, max_tokens=8, **kw):
        """The same wave on each engine in turn; returns, per engine, its
        tokens, its counter deltas, its gauges after the first tick and
        its gauges after the wave."""
        out = {}
        for name, core, sp in (("j", self.j, JSamplingParams),
                               ("t", self.t, SamplingParams)):
            params = sp(max_tokens=max_tokens, temperature=0.0, **kw)
            before = read(COUNTERS)
            seqs = [core.submit_tokens(list(p), params) for p in prompts]
            core._tick()
            first = read(GAUGES)
            for _ in range(10_000):
                if all(s.done_event.is_set() for s in seqs):
                    break
                core._tick()
            assert all(s.done_event.is_set() for s in seqs)
            after = read(COUNTERS)
            out[name] = {
                "tokens": [list(s.generated_ids) for s in seqs],
                "counters": {k: after[k] - before[k] for k in after},
                "first_tick": first,
                "gauges": read(GAUGES),
            }
        return out["j"], out["t"]

    def stop(self):
        self.j.stop()
        self.t.stop()


@pytest.fixture(scope="module")
def engines():
    pair = Engines()
    yield pair
    pair.stop()


PROMPTS = [
    [7, 3, 9, 4, 11, 6, 2, 13, 5, 8, 12, 10, 14],
    [7, 3, 9, 4, 11, 6, 2, 13, 21, 22, 23, 24, 25],
]


def test_pool_gauges_match(engines):
    assert engines.pool["t"] == engines.pool["j"]
    assert engines.pool["t"][("vgt_kv_pages_total", ())] == 63
    assert engines.pool["t"][("vgt_kv_dtype", (("dtype", "f32"),))] == 1


@pytest.mark.parametrize("turn", [0, 1])
def test_two_prompt_wave_series_match(engines, turn):
    """The same two-prompt greedy wave twice: the second turn hits the
    first's prefix pages."""
    j, t = engines.wave(PROMPTS)
    assert t["tokens"] == j["tokens"]
    assert t["counters"] == j["counters"]
    assert t["first_tick"] == j["first_tick"]
    assert t["gauges"] == j["gauges"]
    c = t["counters"]
    assert c[("vgt_engine_step_seconds_count", (("kind", "prefill"),))] == 2
    assert c[("vgt_engine_step_seconds_count", (("kind", "decode"),))] > 0
    assert t["first_tick"][("vgt_active_sequences", ())] == 2
    assert t["gauges"][("vgt_prefix_cached_pages", ())] > 0
    if turn == 1:
        assert c[("vgt_prefix_hit_tokens_total", ())] > 0
        assert c[("vgt_prefix_hit_pages_total", ())] > 0


def test_cow_copy_series_match(engines):
    """A prompt diverging inside a shared page copies its head."""
    base = [31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44]
    engines.wave([base])
    j, t = engines.wave([base[:10] + [51, 52, 53, 54]])
    assert t["tokens"] == j["tokens"]
    assert t["counters"] == j["counters"]
    assert t["counters"][("vgt_prefix_cow_copies_total", ())] == 1


def test_deadline_shed_series_match(engines):
    """A wave whose deadline has passed on arrival is shed from the
    waiting queue with no token generated."""
    j, t = engines.wave(PROMPTS, timeout_s=1e-9)
    assert t["counters"] == j["counters"]
    key = ("vgt_cancelled_requests_total", (("reason", "deadline"),))
    assert t["counters"][key] == 2
    assert t["gauges"] == j["gauges"]


def test_preemption_series_match():
    """A squeezed pool: three sequences needing more pages than the pool
    holds preempt and recompute in both engines alike."""
    pair = Engines(kv_num_pages=14, max_batch_slots=3,
                   prefix_cache=False)
    try:
        prompts = [[10 + i, 3, 9, 4, 11, 6, 2, 13, 5, 8, 12] for i in range(3)]
        j, t = pair.wave(prompts, max_tokens=16, min_tokens=16)
        assert t["tokens"] == j["tokens"]
        assert t["counters"] == j["counters"]
        assert t["gauges"] == j["gauges"]
        c = t["counters"]
        assert c[("vgt_preempted_sequences_total", ())] > 0
        assert c[("vgt_preempt_recompute_tokens_total", ())] > 0
    finally:
        pair.stop()


def snapshot():
    """Every sample of the ``vgt_`` series, by (sample name, labels)."""
    return {
        (s.name, tuple(sorted(s.labels.items()))): s.value
        for m in REGISTRY.collect() for s in m.samples
        if s.name.startswith("vgt_")
    }


class _Graph:
    def __init__(self, fn, watch):
        self.fn, self.watch = fn, watch

    def replay(self):
        self.watch.run(self.fn)


class MetricWatch:
    """A stand-in for the card's graph capture: like a graph, it runs
    the decode body at every replay (a capture only records it), and it
    records any series that changed while the body ran."""

    def __init__(self):
        self.runs, self.changed = 0, []

    def run(self, fn):
        before = snapshot()
        fn()
        after = snapshot()
        self.runs += 1
        self.changed += [k for k in after if after[k] != before.get(k)]

    def warmup(self, fn):
        fn()

    def capture(self, fn):
        return _Graph(fn, self)

    def pool_bytes(self):
        return 0


def test_no_series_changes_inside_a_captured_decode_body():
    """Every series is set on the host side of a readback: with each
    decode chunk run through a capture stand-in, no sample changes
    while a chunk body runs, and the tokens stay the JAX engine's."""
    from vgate_tpu_torch.runtime.decode_graph import DecodeGraphs

    pair = Engines()
    watch = MetricWatch()
    pair.t._graphs = DecodeGraphs(watch)
    pair.t.decode_graphs = True
    try:
        j, t = pair.wave(PROMPTS, max_tokens=12)
        assert t["tokens"] == j["tokens"]
        assert t["counters"] == j["counters"]
    finally:
        pair.stop()
    assert watch.runs >= 3
    assert watch.changed == []
