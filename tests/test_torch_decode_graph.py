"""The decode chunk body on static buffers and the graph host logic.

The body the port captures into a CUDA graph on the card
(``vgate_tpu_torch.runtime.engine_core._decode_chunk`` over a
``DecodeState``) runs eagerly here on ``tiny-dense`` in float32 and must
be greedy token-identical to the reference's jitted ``_decode_chunk``
(its jnp twins) on the same weights, pools and inputs, at chunk lengths
1, 2, 4 and 8, with and without penalties, logit bias and min-token
suppression; its logprobs variant matches the reference's within
``atol 1e-4`` (float32 sums in another order).  The graph cache is held
through a stand-in capture object (key, one capture per key, launch
counts taken out of the warm-up and the capture and added on every
replay), and two engine pairs drive whole waves with those inputs.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vgate_tpu.backends.base import SamplingParams as JSamplingParams
from vgate_tpu.config import load_config as j_load_config
from vgate_tpu.models.specs import TINY_DENSE as J_TINY_DENSE
from vgate_tpu.runtime.engine_core import (
    EngineCore as JEngineCore,
    _decode_chunk as j_decode_chunk,
)
from vgate_tpu.runtime.weights import load_or_init_params as j_init
from vgate_tpu_torch.backends.base import SamplingParams
from vgate_tpu_torch.config import load_config
from vgate_tpu_torch.models.specs import TINY_DENSE
from vgate_tpu_torch.ops.kernels import _build
from vgate_tpu_torch.ops.kernels.paged_decode import paged_decode_attention
from vgate_tpu_torch.ops.kernels.quant_matmul import int8_matmul
from vgate_tpu_torch.runtime import decode_graph
from vgate_tpu_torch.runtime.decode_graph import DecodeGraphs, DecodeState
from vgate_tpu_torch.runtime.engine_core import (
    LOGPROBS_K,
    EngineCore,
    _decode_chunk,
)
from vgate_tpu_torch.runtime.weights import params_from_jax

LP_TOL = 1e-4  # float32 log-softmax, sums in another order
B, PS, PPS, P = 4, 4, 8, 40
V = TINY_DENSE.vocab_size


@pytest.fixture(scope="module")
def weights():
    jparams = j_init(J_TINY_DENSE, None, np.float32)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), TINY_DENSE)
    return jparams, tparams


def _inputs(seed, penalties):
    """One decode batch: random pools (trash page 0 included), four
    slots (slot 2 inactive) at positions 5..28 over their own pages (the
    last reaches the table's end within a chunk), and
    with ``penalties`` per-row counts, frequency/presence penalties,
    logit bias (rows of different widths) and min-token floors over stop
    ids (padding id V)."""
    rng = np.random.default_rng(seed)
    L, KV, hd = TINY_DENSE.num_layers, TINY_DENSE.num_kv_heads, \
        TINY_DENSE.head_dim
    pools = [rng.normal(size=(L, KV, P, PS, hd)).astype(np.float32)
             for _ in range(2)]
    tables = (1 + np.arange(B * PPS, dtype=np.int32)).reshape(B, PPS)
    d = {
        "pools": pools,
        "tokens": rng.integers(2, V, B).astype(np.int32),
        "positions": np.array([5, 9, 3, 28], np.int32),
        "active": np.array([True, True, False, True]),
        "tables": tables,
        "steps": np.array([0, 3, 0, 1], np.int32),
        "counts": None, "bias": None, "min_tok": None,
    }
    if penalties:
        counts = np.zeros((B, V), np.int32)
        for b in range(B):
            counts[b, rng.integers(0, V, 6)] += 1
        d["counts"] = (counts, np.array([0.5, 0.0, 0.3, 1.2], np.float32),
                       np.array([0.2, 0.7, 0.0, 0.4], np.float32))
        ids = np.full((B, 3), V, np.int64)
        ids[0, :3] = [7, 8, 9]
        ids[3, :1] = [11]
        vals = np.zeros((B, 3), np.float32)
        vals[0, :3] = [5.0, -100.0, 2.0]
        vals[3, :1] = [8.0]
        d["bias"] = (ids, vals)
        stop = np.full((B, 2), V, np.int64)
        stop[:, 0] = 0  # eos
        stop[1, 1] = 3
        d["min_tok"] = (np.array([4, 6, 0, 2], np.int32), stop)
    return d


def _reference_chunk(jparams, d, num_steps, num_logprobs):
    ones = jnp.ones((B,), jnp.float32)
    kw = {}
    if d["counts"] is not None:
        counts, freq, pres = d["counts"]
        kw.update(counts=jnp.asarray(counts), freq_pens=jnp.asarray(freq),
                  pres_pens=jnp.asarray(pres),
                  bias_ids=jnp.asarray(d["bias"][0].astype(np.int32)),
                  bias_vals=jnp.asarray(d["bias"][1]),
                  min_toks=jnp.asarray(d["min_tok"][0]),
                  stop_id_mat=jnp.asarray(d["min_tok"][1].astype(np.int32)))
    out = j_decode_chunk(
        jparams, J_TINY_DENSE, jnp.asarray(d["tokens"]),
        jnp.asarray(d["positions"]), jnp.asarray(d["pools"][0]),
        jnp.asarray(d["pools"][1]), jnp.asarray(d["tables"]),
        jnp.asarray(d["active"]), jnp.zeros((B,), jnp.float32), ones,
        jnp.zeros((B,), jnp.int32), jax.random.PRNGKey(0),
        jnp.asarray(0, jnp.int32), num_steps=num_steps, use_pallas=False,
        max_position=PPS * PS - 1, steps=jnp.asarray(d["steps"]),
        num_logprobs=num_logprobs,
        all_greedy=num_logprobs == 0 and d["counts"] is None, **kw,
    )
    chunk_tokens, chunk_lp, tokens, positions = out[:4]
    return (np.asarray(chunk_tokens), chunk_lp and [np.asarray(a) for a in
                                                    chunk_lp],
            np.asarray(tokens), np.asarray(positions), out[6])


def _port_state(d):
    dev = torch.device("cpu")
    state = DecodeState(B, PPS, V, 8, LOGPROBS_K, dev)
    rows = {
        "temps": np.zeros((B,), np.float32), "top_ps": np.ones((B,),
                                                              np.float32),
        "top_ks": np.zeros((B,), np.int32), "seeds": np.full((B,), -1),
        "steps": d["steps"], "counts": None, "freq_pens": None,
        "pres_pens": None, "min_tok": d["min_tok"], "bias": d["bias"],
    }
    if d["counts"] is not None:
        rows.update(counts=d["counts"][0], freq_pens=d["counts"][1],
                    pres_pens=d["counts"][2])
    state.load(d["tokens"], d["positions"], d["active"], d["tables"], rows)
    return state


def _port_chunk(tparams, d, num_steps, num_logprobs, state=None):
    state = state or _port_state(d)
    pools = [torch.from_numpy(p.copy()) for p in d["pools"]]
    _decode_chunk(
        tparams, TINY_DENSE, state, *pools, torch.Generator(),
        num_steps=num_steps, max_position=PPS * PS - 1,
        all_greedy=num_logprobs == 0 and d["counts"] is None,
        num_logprobs=num_logprobs,
    )
    return state


@pytest.mark.parametrize("penalties", [False, True],
                         ids=["plain", "penalties-bias-min-tokens"])
@pytest.mark.parametrize("num_steps", [1, 2, 4, 8])
def test_chunk_body_matches_reference_chunk(weights, num_steps, penalties):
    """Greedy tokens of every step, the advanced tokens and positions
    (clamped at the table's end) and the counts equal the reference's."""
    jparams, tparams = weights
    d = _inputs(num_steps, penalties)
    ref_tokens, _, ref_last, ref_pos, ref_counts = _reference_chunk(
        jparams, d, num_steps, 0)
    state = _port_chunk(tparams, d, num_steps, 0)
    np.testing.assert_array_equal(
        state.out_tokens[:num_steps].numpy(), ref_tokens)
    np.testing.assert_array_equal(state.tokens.numpy(), ref_last)
    np.testing.assert_array_equal(state.positions.numpy(), ref_pos)
    np.testing.assert_array_equal(
        state.steps.numpy(), d["steps"] + num_steps * d["active"])
    if penalties:
        np.testing.assert_array_equal(state.counts.numpy(),
                                      np.asarray(ref_counts))


@pytest.mark.parametrize("penalties", [False, True],
                         ids=["plain", "penalties-bias-min-tokens"])
@pytest.mark.parametrize("num_steps", [1, 4])
def test_chunk_body_logprobs_match_reference(weights, num_steps, penalties):
    jparams, tparams = weights
    d = _inputs(10 + num_steps, penalties)
    ref_tokens, ref_lp, _, _, _ = _reference_chunk(
        jparams, d, num_steps, LOGPROBS_K)
    state = _port_chunk(tparams, d, num_steps, LOGPROBS_K)
    n = num_steps
    np.testing.assert_array_equal(state.out_tokens[:n].numpy(), ref_tokens)
    np.testing.assert_array_equal(state.out_top_ids[:n].numpy(), ref_lp[1])
    np.testing.assert_allclose(state.out_lp[:n].numpy(), ref_lp[0],
                               atol=LP_TOL, rtol=0)
    np.testing.assert_allclose(state.out_top_lps[:n].numpy(), ref_lp[2],
                               atol=LP_TOL, rtol=0)


def test_chunk_body_writes_only_static_buffers(weights):
    """Two chunks back to back on one state: the buffers keep their
    storage, and the second chunk continues from the first's end as one
    chunk of twice the length does."""
    _, tparams = weights
    d = _inputs(3, True)
    state = _port_state(d)
    ptrs = {n: getattr(state, n).data_ptr() for n in (
        "tokens", "positions", "steps", "counts", "out_tokens")}
    pools = [torch.from_numpy(p.copy()) for p in d["pools"]]
    firsts = []
    for _ in range(2):
        _decode_chunk(tparams, TINY_DENSE, state, *pools, torch.Generator(),
                      num_steps=2, max_position=PPS * PS - 1,
                      all_greedy=False)
        firsts.append(state.out_tokens[:2].clone())
    assert ptrs == {n: getattr(state, n).data_ptr() for n in ptrs}
    whole = _port_chunk(tparams, d, 4, 0)
    torch.testing.assert_close(torch.cat(firsts), whole.out_tokens[:4])
    torch.testing.assert_close(state.counts, whole.counts)


def test_scratch_state_leaves_the_live_state_alone(weights):
    """The warm-up's scratch copy: every slot inactive, what the body
    writes cloned, the inputs shared."""
    _, tparams = weights
    d = _inputs(4, True)
    state = _port_state(d)
    before = {n: getattr(state, n).clone() for n in (
        "tokens", "positions", "steps", "counts", "out_tokens")}
    scratch = state.scratch()
    assert not scratch.active.any() and state.active.any()
    assert scratch.page_tables is state.page_tables
    _port_chunk(tparams, d, 2, 0, state=scratch)
    for n, t in before.items():
        torch.testing.assert_close(getattr(state, n), t)
    # inactive slots neither advance nor count
    torch.testing.assert_close(scratch.positions, state.positions)
    torch.testing.assert_close(scratch.counts, state.counts)


def test_graph_key_names_every_static_input():
    state = _port_state(_inputs(0, False))
    assert state.key(8, True, 0) == (8, True, 0, False, 0, 0)
    assert state.key(4, False, LOGPROBS_K) == (4, False, 8, False, 0, 0)
    state = _port_state(_inputs(0, True))
    # bias width 3 and stop width 2 pad to powers of two
    assert state.key(8, False, 0) == (8, False, 0, True, 4, 2)
    assert state.bias()[0].shape == (B, 4)
    assert int(state.bias()[0][1, 0]) == V  # padding: dropped by the body
    assert [decode_graph._width(n) for n in (0, 1, 2, 3, 5, 8, 9)] == [
        0, 1, 2, 4, 8, 8, 16]


class StandIn:
    """A capture object as ``DecodeGraphs`` sees one, on the CPU: the
    warm-up and the capture run the body (as a capture runs its Python
    once), a replay runs nothing."""

    def __init__(self):
        self.calls = []

    def warmup(self, fn):
        self.calls.append("warmup")
        fn()

    def capture(self, fn):
        self.calls.append("capture")
        fn()
        return self

    def replay(self):
        self.calls.append("replay")

    def pool_bytes(self):
        return 0


def test_graph_cache_counts_launches_per_replay():
    """A step that launches K1 twice and K4 five times (counted as the
    wrappers count, through ``_build.count_launch``): neither the
    warm-up nor the capture counts, every replay adds the capture's
    launches, one capture per key."""
    def body():
        _build.count_launch(paged_decode_attention, 2)
        _build.count_launch(int8_matmul, 5)

    k1, k4 = paged_decode_attention.launches, int8_matmul.launches
    stand_in = StandIn()
    graphs = DecodeGraphs(stand_in)
    graphs.run(("a",), body, body)
    assert stand_in.calls == ["warmup", "capture", "replay"]
    assert (paged_decode_attention.launches, int8_matmul.launches) == (
        k1 + 2, k4 + 5)
    for _ in range(3):
        graphs.run(("a",), body, body)
    graphs.run(("b",), lambda: None, lambda: None)
    graphs.run(("b",), lambda: None, lambda: None)
    assert stand_in.calls.count("capture") == 2
    assert (paged_decode_attention.launches, int8_matmul.launches) == (
        k1 + 8, k4 + 20)
    assert graphs.stats()["captured"] == 2
    paged_decode_attention.launches, int8_matmul.launches = k1, k4


def test_no_garbage_collection_inside_a_capture():
    """The collector is off while a graph is captured (a collection there
    can invalidate the capture on the card), on again after it, also when
    the capture raises, and off still if it was off before."""
    import gc

    seen = []

    class Probe(StandIn):
        def capture(self, fn):
            seen.append(gc.isenabled())
            return super().capture(fn)

    class Failing(StandIn):
        def capture(self, fn):
            raise RuntimeError("capture failed")

    assert gc.isenabled()
    graphs = DecodeGraphs(Probe())
    graphs.run(("a",), lambda: None, lambda: seen.append(gc.isenabled()))
    assert seen == [True, False] and gc.isenabled()
    with pytest.raises(RuntimeError, match="capture failed"):
        DecodeGraphs(Failing()).run(("a",), lambda: None, lambda: None)
    assert gc.isenabled()
    gc.disable()
    try:
        graphs.run(("b",), lambda: None, lambda: None)
        assert not gc.isenabled()
    finally:
        gc.enable()


# ------------------------------------------------------------- engines

MODEL = {"model_id": "tiny-dense", "dtype": "float32", "max_model_len": 64}
SHAPES = {"kv_num_pages": 64, "kv_page_size": 4, "max_batch_slots": 4,
          "prefill_buckets": [8, 16, 32], "prefix_cache": False}


def _t_config(**shapes):
    return load_config(
        model={**MODEL, "engine_type": "torch_cuda"},
        device={"device": "cpu", **SHAPES, **shapes},
        scheduler={"max_queue_size": 16}, logging={"level": "ERROR"},
    )


def test_decode_graphs_on_the_cpu_raise(weights):
    _, tparams = weights
    with pytest.raises(ValueError, match="CUDA"):
        EngineCore(_t_config(), params=tparams, decode_graphs=True)
    core = EngineCore(_t_config(), params=tparams)
    assert core.decode_graphs is False
    assert core.get_stats()["decode_graphs"] is None


def test_refresh_page_tables_writes_in_place(weights):
    """A chunk in flight reads the page-table buffer it was enqueued
    with; a refresh writes the same storage (stream order keeps the
    chunk's reads first)."""
    _, tparams = weights
    core = EngineCore(_t_config(), params=tparams)
    params = SamplingParams(max_tokens=10, temperature=0.0)
    seq = core.submit_tokens([5, 6, 7], params)
    core._tick()  # prefill + the first chunk
    table = core._dec_state.page_tables
    ptr = table.data_ptr()
    seq.pages.append(63)
    core._refresh_page_tables([seq])
    assert core._dec_state.page_tables is table
    assert table.data_ptr() == ptr
    assert int(table[seq.slot, len(seq.pages) - 1]) == 63
    seq.pages.pop()  # never allocated: keep the allocator's books
    core.stop()


def _pair(jparams, tparams, **shapes):
    j_cfg = j_load_config(
        model={**MODEL, "engine_type": "jax_tpu"},
        tpu={"dp": 1, "tp": 1, "ep": 1, "sp": 1, "use_pallas": False,
             **SHAPES, **shapes},
        scheduler={"max_queue_size": 16}, integrity={"enabled": False},
        logging={"level": "ERROR"},
    )
    j = JEngineCore(j_cfg, params=jparams, devices=jax.devices()[:1])
    t = EngineCore(_t_config(**shapes), params=tparams)
    return j, t


def _wave(core, sp_cls, requests):
    """Queue every request, then drive the engine's tick (no thread)."""
    seqs = [core.submit_tokens(list(p), sp_cls(**kw)) for p, kw in requests]
    for _ in range(10_000):
        if all(s.done_event.is_set() for s in seqs):
            break
        core._tick()
    assert all(s.done_event.is_set() for s in seqs)
    return seqs


REQUESTS = [
    ([5, 6, 7], dict(max_tokens=20, temperature=0.0)),
    ([9, 3], dict(max_tokens=13, temperature=0.0, frequency_penalty=0.8,
                  presence_penalty=0.4)),
    ([12, 14, 16, 18, 20], dict(max_tokens=9, temperature=0.0,
                                logit_bias={30: 6.0, 31: -50.0, 2: 3.0})),
    ([40, 41], dict(max_tokens=17, temperature=0.0, min_tokens=12,
                    stop_token_ids=[7, 8])),
    ([70, 71, 72, 73], dict(max_tokens=11, temperature=0.0)),
]


@pytest.mark.parametrize("decode_chunk", [1, 2, 4, 8])
def test_engine_waves_with_every_optional_input(weights, decode_chunk):
    """Five greedy requests on four slots (penalties, logit bias,
    min-tokens with stop ids, plain): the port's static-buffer chunks
    reproduce the JAX engine's tokens at every chunk length."""
    jparams, tparams = weights
    j, t = _pair(jparams, tparams, decode_chunk=decode_chunk)
    try:
        js = _wave(j, JSamplingParams, REQUESTS)
        ts = _wave(t, SamplingParams, REQUESTS)
        assert [s.generated_ids for s in ts] == [s.generated_ids for s in js]
        assert t.get_stats()["used_pages"] == 0
    finally:
        j.stop()
        t.stop()
