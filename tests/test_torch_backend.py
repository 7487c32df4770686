"""The async surface of ``TorchCUDABackend`` on ``tiny-dense`` on the CPU,
as ``tests/test_jax_backend.py`` holds the reference's: concurrent
batches share one engine, streams join to the final text (with
logprobs), a cancel token aborts one row of a settled batch while the
others keep their tokens, the drain sweep settles waiting and running
sequences alike, and the gateway's batcher takes the settled path.

Every wait is on an event or a sequence's completion, never a sleep."""

import asyncio
import threading

import numpy as np
import pytest

from vgate_tpu_torch import faults
from vgate_tpu_torch.backends.base import SamplingParams
from vgate_tpu_torch.backends.torch_backend import TorchCUDABackend
from vgate_tpu_torch.config import load_config
from vgate_tpu_torch.lifecycle import CancelToken
from vgate_tpu_torch.runtime.engine_core import EngineCore

MODEL = {"model_id": "tiny-dense", "dtype": "float32", "max_model_len": 64,
         "engine_type": "torch_cuda"}
DEVICE = {
    "device": "cpu",
    "kv_num_pages": 64,
    "kv_page_size": 4,
    "max_batch_slots": 4,
    "prefill_buckets": [8, 16, 32],
    "prefix_cache": False,
    # two chunks in flight: an abort lands while a chunk holding the
    # aborted row is still to be read back
    "decode_pipeline": 2,
    "decode_chunk": 4,
}
PROMPTS = ["alpha beta", "gamma delta", "epsilon", "zeta eta theta"]


def _config(**device):
    return load_config(
        model=MODEL, device={**DEVICE, **device},
        scheduler={"max_queue_size": 16}, logging={"level": "WARNING"},
    )


@pytest.fixture(scope="module")
def backend():
    b = TorchCUDABackend()
    b.load_model(_config())
    yield b
    b.shutdown()


def _greedy(n, **kw):
    return SamplingParams(max_tokens=n, temperature=0.0, **kw)


def _settled(stats):
    """The engine holds nothing: no running sequence, no page in use."""
    return stats["running"] == 0 and stats["used_pages"] == 0


class _Watch:
    """While installed, ``hook(prompt, token)`` runs on the engine thread
    at each token of every sequence submitted through the core's
    ``submit_prompt`` (as a stream callback does), and each such
    sequence is kept in ``seqs`` by prompt."""

    def __init__(self, backend, hook):
        self.core, self.hook, self.seqs = backend.core, hook, {}

    def __enter__(self):
        plain = self.core.submit_prompt

        def submit_prompt(prompt, params, stream_cb=None, meta=None):
            def cb(token):
                if stream_cb is not None:
                    stream_cb(token)
                self.hook(prompt, token)

            seq = plain(prompt, params, stream_cb=cb, meta=meta)
            self.seqs[prompt] = seq
            return seq

        self.core.submit_prompt = submit_prompt
        return self

    def __exit__(self, *exc):
        del self.core.submit_prompt


def test_sync_generate_protocol(backend):
    params = _greedy(5)
    results = backend.generate(["one", "two"], [params, params])
    assert len(results) == 2
    for r in results:
        assert 1 <= r.num_tokens <= 5
        assert r.metrics["ttft"] > 0
        assert r.finish_reason in ("stop", "length")


async def test_generate_async_concurrent_interleaves(backend):
    """Three concurrent ``generate_async`` calls decode side by side in
    the one engine, with the tokens each gets alone."""
    alone = [backend.generate([p], [_greedy(16, min_tokens=16)])[0]
             for p in PROMPTS[:3]]
    running = []
    with _Watch(backend, lambda p, t: running.append(
            len(backend.core.scheduler.running))):
        out = await asyncio.gather(*(
            backend.generate_async([p], [_greedy(16, min_tokens=16)])
            for p in PROMPTS[:3]
        ))
    assert max(running) >= 2
    for (r,), a in zip(out, alone):
        assert r.token_ids == a.token_ids
        assert r.num_tokens == 16
    assert _settled(backend.get_stats())


def _stop_string(text):
    """The first two printable ASCII characters past the start of
    ``text`` (random weights decode to mostly other bytes)."""
    for i in range(1, len(text) - 1):
        pair = text[i : i + 2]
        if pair.isascii() and pair.isprintable():
            return pair
    raise AssertionError(f"no ASCII pair in {text!r}")


@pytest.mark.parametrize("case", ["plain", "stop", "logprobs"])
async def test_stream_async_deltas_join_to_final_text(backend, case):
    prompt = PROMPTS[1]
    kw = {"min_tokens": 12}
    if case == "stop":
        [free] = backend.generate([prompt], [_greedy(12)])
        kw = {"stop": [_stop_string(free.text)]}
    if case == "logprobs":
        kw.update(logprobs=True, top_logprobs=3)
    params = _greedy(12, **kw)
    [direct] = backend.generate([prompt], [params])
    pieces, finish, usage = [], [], []
    async for piece in backend.stream_async(
        prompt, params, on_finish=finish.append, on_usage=usage.append
    ):
        pieces.append(piece)
    if case == "logprobs":
        assert all(isinstance(p, dict) for p in pieces)
        text = "".join(p["text"] for p in pieces)
        entries = [e for p in pieces for e in p["logprobs"]]
        assert len(entries) == direct.num_tokens
        assert [e["token_id"] for e in entries] == direct.token_ids
        for e, d in zip(entries, direct.logprobs):
            assert len(e["top_logprobs"]) == 3
            assert e["logprob"] == pytest.approx(d["logprob"], abs=1e-5)
    else:
        assert all(isinstance(p, str) for p in pieces)
        text = "".join(pieces)
    assert text == direct.text
    assert finish == [direct.finish_reason]
    if case == "stop":
        assert finish == ["stop"] and kw["stop"][0] not in text
    assert usage == [{
        "prompt_tokens": direct.prompt_tokens,
        "completion_tokens": direct.num_tokens,
        "total_tokens": direct.prompt_tokens + direct.num_tokens,
    }]


class _ScriptedCore:
    """A core that delivers a fixed token stream to ``stream_cb`` from
    its own thread, with the byte tokenizer of tiny-dense."""

    def __init__(self, tokenizer, ids):
        self.tokenizer, self.ids = tokenizer, ids

    def submit_prompt(self, prompt, params, stream_cb=None, meta=None):
        from vgate_tpu_torch.runtime.sequence import Sequence

        seq = Sequence(prompt_ids=[1], params=params, stream_cb=stream_cb)

        def run():
            for t in self.ids:
                seq.append_token(t)
            seq.finish("length")

        threading.Thread(target=run, daemon=True).start()
        return seq

    def final_text(self, seq):
        return self.tokenizer.decode(seq.generated_ids)


async def test_stream_holds_back_an_incomplete_character(backend):
    """A character whose UTF-8 bytes arrive over several tokens decodes
    to U+FFFD until its last byte: the deltas hold that tail back and
    join to the final text (emitting it at once, as the reference does,
    would leave the U+FFFD in the stream)."""
    tok = backend.core.tokenizer
    ids = tok.encode("a€b😀")  # 1 + 3 + 1 + 4 bytes, one token each
    b = TorchCUDABackend()
    b.core = _ScriptedCore(tok, ids)
    pieces = [p async for p in b.stream_async("x", _greedy(len(ids)))]
    assert "".join(pieces) == "a€b😀"
    assert all("\ufffd" not in p for p in pieces)


async def test_cancel_token_aborts_one_row_of_a_settled_batch(backend):
    """Row 1's token fires after its first token: it settles "abort"
    with fewer tokens than its budget, its slot and pages are freed, and
    rows 0, 2 and 3 keep exactly the tokens of a run without the cancel
    (decode_pipeline 2: its tokens in the chunk still in flight are
    discarded at readback)."""
    params = [_greedy(32, min_tokens=32)] * 4
    baseline = await backend.generate_settled_async(PROMPTS, params)
    assert [r.finish_reason for r in baseline] == ["length"] * 4
    tokens = [None, CancelToken(), None, None]
    before = backend.get_stats()["scheduler"]["aborted"]

    def hook(prompt, token):
        if prompt == PROMPTS[1]:
            tokens[1].cancel("client_disconnect")

    with _Watch(backend, hook):
        out = await backend.generate_settled_async(
            PROMPTS, params, cancel_tokens=tokens
        )
    assert out[1].finish_reason == "abort"
    assert 1 <= out[1].num_tokens < 32
    assert out[1].token_ids == baseline[1].token_ids[: out[1].num_tokens]
    for i in (0, 2, 3):
        assert out[i].finish_reason == "length"
        assert out[i].token_ids == baseline[i].token_ids
    stats = backend.get_stats()
    assert stats["scheduler"]["aborted"] == before + 1
    assert _settled(stats)


async def test_cancelled_waiter_aborts_its_sequences(backend):
    """A task awaiting ``generate_settled_async`` that is cancelled (the
    client went away) request-aborts every sequence it holds."""
    started = threading.Event()
    seen = set()

    def hook(prompt, token):
        seen.add(prompt)
        if len(seen) == 2:
            started.set()

    loop = asyncio.get_running_loop()
    with _Watch(backend, hook) as watch:
        task = asyncio.ensure_future(backend.generate_settled_async(
            PROMPTS[:2], [_greedy(40, min_tokens=40)] * 2
        ))
        assert await loop.run_in_executor(None, started.wait, 60)
        task.cancel()
        with pytest.raises(asyncio.CancelledError):
            await task
    assert len(watch.seqs) == 2
    for seq in watch.seqs.values():
        assert await loop.run_in_executor(None, seq.done_event.wait, 60)
        assert seq.finish_reason == "abort"
    assert _settled(backend.get_stats())


async def test_abort_in_flight_settles_waiting_and_running(backend):
    """Six requests on four slots: when the running ones have a token,
    the drain sweep aborts all six, the two still waiting included; a
    request served after the sweep runs to its budget."""
    started = threading.Event()
    loop = asyncio.get_running_loop()
    prompts = PROMPTS + ["iota kappa", "lambda mu"]
    with _Watch(backend, lambda p, t: started.set()):
        task = asyncio.ensure_future(backend.generate_settled_async(
            prompts, [_greedy(40, min_tokens=40)] * 6
        ))
        assert await loop.run_in_executor(None, started.wait, 60)
        waiting = len(backend.core.scheduler.waiting)
        backend.abort_in_flight("drain")
        out = await task
    assert waiting == 2
    assert [r.finish_reason for r in out] == ["abort"] * 6
    assert sum(r.num_tokens == 0 for r in out) == 2
    assert _settled(backend.get_stats())
    [after] = await backend.generate_async(["after"], [_greedy(6, min_tokens=6)])
    assert after.finish_reason == "length" and after.num_tokens == 6


def test_signals_health_and_stats(backend):
    sig = backend.pressure_signals()
    for key in ("kv_free_ratio", "kv_truly_free_ratio",
                "prefix_cached_ratio"):
        assert 0.0 <= sig[key] <= 1.0
    assert sig["kv_dtype"] == "f32"
    health = backend.serving_health()
    assert health["state"] == "serving"
    assert health["alive"] and health["ready"]
    dev = backend.device_health()
    # supervised (recovery.enabled, the default): the core's block plus
    # the health state, as the reference's supervisor reports it
    assert dev == {"alive": True, "platform": "cpu", "device_kind": "cpu",
                   "num_devices": 1, "state": "serving"}
    stats = backend.get_stats()
    assert stats["kv_page_bytes"] == backend.core.geometry.page_bytes


def test_pressure_signals_keys_match_the_reference():
    """The same keys as the reference ``EngineCore.pressure_signals``
    (whose host-swap block is empty with swap off, as it is here)."""
    import jax

    from vgate_tpu.config import load_config as j_load_config
    from vgate_tpu.models.specs import TINY_DENSE
    from vgate_tpu.runtime.engine_core import EngineCore as JEngineCore
    from vgate_tpu.runtime.weights import load_or_init_params

    shapes = {k: v for k, v in DEVICE.items() if k != "device"}
    j_cfg = j_load_config(
        model={**MODEL, "engine_type": "jax_tpu"},
        tpu={"dp": 1, "tp": 1, "ep": 1, "sp": 1, "use_pallas": False,
             **shapes},
        integrity={"enabled": False}, logging={"level": "WARNING"},
    )
    j = JEngineCore(
        j_cfg, params=load_or_init_params(TINY_DENSE, None, np.float32),
        devices=jax.devices()[:1],
    )
    t = EngineCore(_config())
    assert set(t.pressure_signals()) == set(j.pressure_signals())
    assert t.pressure_signals()["kv_token_capacity"] == (
        j.pressure_signals()["kv_token_capacity"])


def test_set_prefix_insert_suspended_reaches_the_radix_tree():
    b = TorchCUDABackend()
    b.core = EngineCore(_config(prefix_cache=True))
    b.set_prefix_insert_suspended(True)
    assert b.core.radix_cache.insert_suspended is True
    b.set_prefix_insert_suspended(False)
    assert b.core.radix_cache.insert_suspended is False


def test_backend_generate_probes_the_fault_point(backend):
    faults.reset()
    faults.arm("backend_generate", mode="raise", times=1)
    try:
        with pytest.raises(faults.InjectedFault):
            backend.generate(["x"], [_greedy(2)])
    finally:
        faults.reset()


async def test_batcher_takes_the_settled_branch(backend):
    """The gateway's batcher sends the torch backend's batches through
    ``generate_settled_async``, with the requests' cancel tokens, and
    never through the sync ``generate`` hop."""
    from vgate_tpu_torch.batcher import RequestBatcher

    calls = []
    settled = backend.generate_settled_async

    async def spy(prompts, params, cancel_tokens=None, request_meta=None):
        calls.append((list(prompts), cancel_tokens))
        return await settled(prompts, params, cancel_tokens=cancel_tokens,
                             request_meta=request_meta)

    def no_sync(*a, **k):
        raise AssertionError("the batcher took the sync generate hop")

    class _Engine:
        pass

    engine = _Engine()
    engine.backend = backend
    config = load_config(
        model=MODEL, device=DEVICE,
        batch={"max_batch_size": 2, "max_wait_time_ms": 60_000.0},
        logging={"level": "WARNING"},
    )
    backend.generate_settled_async = spy
    backend.generate = no_sync
    batcher = RequestBatcher(engine, config)
    await batcher.start()
    try:
        token = CancelToken()
        out = await asyncio.gather(
            batcher.submit("batched one", max_tokens=4, temperature=0.0,
                           cancel_token=token),
            batcher.submit("batched two", max_tokens=4, temperature=0.0,
                           cancel_token=CancelToken()),
        )
    finally:
        await batcher.stop()
        del backend.generate_settled_async
        del backend.generate
    assert len(calls) == 1
    prompts, tokens = calls[0]
    assert sorted(prompts) == ["batched one", "batched two"]
    assert tokens is not None and token in tokens
    assert [r["num_tokens"] for r in out] == [4, 4]
