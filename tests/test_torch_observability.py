"""The port's observability (observability/flight.py, perf.py,
roofline.py, memtrace.py and the engine's hooks into them) against the
reference's, on the CPU.

Both engines serve the same wave on one weight tree, their ticks driven
by the test and bracketed by the perf recorder as each engine's loop
brackets them; the payloads the gateway serves (``/debug/flight``,
``/debug/requests``, ``/debug/perf``, the ``/stats`` blocks and a crash
snapshot) have the reference's keys, tick kinds and phase names, and
the perf phases sum to the tick wall.  ``stream_weight_bytes`` of the
port's tree equals the reference's on dense and quantized trees, and the
peak table has the H100's row.  The engine's phase spans reach the
in-memory span recorder with their request's trace context.
"""

import jax
import numpy as np
import pytest

from vgate_tpu.backends.base import SamplingParams as JSamplingParams
from vgate_tpu.config import load_config as j_load_config
from vgate_tpu.models.specs import TINY_DENSE as J_TINY
from vgate_tpu.observability import roofline as j_roofline
from vgate_tpu.ops.quant import quantize_decoder_params
from vgate_tpu.runtime.engine_core import EngineCore as JEngineCore
from vgate_tpu.runtime.weights import load_or_init_params as j_init
from vgate_tpu_torch import config as config_mod
from vgate_tpu_torch.backends.base import SamplingParams
from vgate_tpu_torch.config import load_config
from vgate_tpu_torch.models.specs import TINY_DENSE
from vgate_tpu_torch.observability import perf, roofline
from vgate_tpu_torch.observability.flight import FlightRecorder
from vgate_tpu_torch.observability.reqtrace import RequestMeta
from vgate_tpu_torch.runtime.engine_core import EngineCore
from vgate_tpu_torch.runtime.weights import params_from_jax

SHAPES = {"kv_num_pages": 64, "kv_page_size": 4, "max_batch_slots": 4,
          "prefill_buckets": [8, 16, 32], "prefix_cache": False}
MODEL = {"model_id": "tiny-dense", "dtype": "float32", "max_model_len": 64}


@pytest.fixture(autouse=True)
def _reset_port_config():
    config_mod.reset_config()
    yield
    config_mod.reset_config()


def _drive(core, seqs):
    """The loop's tick, bracketed by the perf recorder as ``_loop``
    brackets it, until ``seqs`` are done."""
    core._running = True
    for _ in range(5000):
        if all(s.done_event.is_set() for s in seqs):
            return
        core.perf.tick_begin()
        core.perf.tick_end(core._tick())
    raise AssertionError("the wave did not finish")


@pytest.fixture(scope="module")
def engines():
    tree = j_init(J_TINY, None, np.float32)
    j = JEngineCore(
        j_load_config(
            model={**MODEL, "engine_type": "jax_tpu"},
            tpu={"dp": 1, "tp": 1, "ep": 1, "sp": 1, "use_pallas": False,
                 **SHAPES},
            logging={"level": "ERROR"},
        ),
        params=tree, devices=jax.devices()[:1],
    )
    t = EngineCore(
        load_config(model=MODEL, device={"device": "cpu", **SHAPES},
                    logging={"level": "ERROR"}),
        params=params_from_jax(jax.tree.map(np.asarray, tree), TINY_DENSE),
    )
    seqs = {}
    for name, core, sp in (("jax", j, JSamplingParams),
                           ("port", t, SamplingParams)):
        params = [sp(max_tokens=9, temperature=0.0),
                  sp(max_tokens=5, temperature=0.0),
                  sp(max_tokens=12, temperature=0.7, seed=3)]
        wave = [core.submit_tokens(p, par, meta=RequestMeta(
            request_id=f"req-{i}")) for i, (p, par) in enumerate(zip(
                [[5, 9, 13], [7, 7, 1, 2, 8], [3, 1, 4, 1, 5, 9, 2, 6]],
                params))]
        _drive(core, wave)
        seqs[name] = wave
    yield {"jax": j, "port": t, "seqs": seqs}
    j.stop()
    t.stop()


def _keys(obj):
    """The key structure of a payload: dict keys (recursively, lists by
    their first element), not values."""
    if isinstance(obj, dict):
        return {k: _keys(v) for k, v in obj.items()}
    if isinstance(obj, list) and obj and isinstance(obj[0], dict):
        return [_keys(obj[0])]
    return None


def test_flight_payloads_have_the_reference_keys(engines):
    j, t = engines["jax"].flight, engines["port"].flight
    assert _keys(t.get_stats()) == _keys(j.get_stats())
    assert t.get_stats() == j.get_stats()  # counts of the same wave
    by_kind = lambda rec: {  # noqa: E731
        tick["kind"]: set(tick) for tick in rec.ticks(512)}
    jt, tt = by_kind(j), by_kind(t)
    # the reference's tick kinds (its "recompile" is the port's new
    # static key) with the fields each carries
    assert set(tt) == set(jt)
    for kind in jt:
        assert tt[kind] == jt[kind], kind
    jr, tr = j.requests(16), t.requests(16)
    assert [r["request_id"] for r in tr] == [r["request_id"] for r in jr]
    assert [set(r) for r in tr] == [set(r) for r in jr]
    assert [r["status"] for r in tr] == [r["status"] for r in jr]
    assert set(t.find_request("req-1")) == set(j.find_request("req-1"))
    assert _keys(t.crash_snapshot(RuntimeError("x"))) == \
        _keys(j.crash_snapshot(RuntimeError("x")))


def test_perf_payloads_have_the_reference_keys(engines):
    j, t = engines["jax"], engines["port"]
    js, ts = j.perf_snapshot(), t.perf_snapshot()
    assert set(ts) == set(js)
    for block in ("window", "totals", "last_tick", "roofline"):
        assert set(ts[block]) == set(js[block]), block
    assert set(ts["compile_ledger"][0]) == set(js["compile_ledger"][0])
    assert {e["program"] for e in ts["compile_ledger"]} == {
        e["program"] for e in js["compile_ledger"]}
    assert ts["totals"]["tokens"] == js["totals"]["tokens"]
    # the five phases sum to the tick wall by construction
    win = ts["window"]
    assert sum(win["phase_seconds"].values()) == pytest.approx(
        win["wall_s"], rel=1e-3, abs=1e-5)
    assert set(t.get_stats()["perf"]) == set(j.get_stats()["perf"])
    assert set(t.get_stats()["flight"]) == set(j.get_stats()["flight"])


def test_engine_stats_carry_the_reference_blocks(engines):
    j, t = engines["jax"].get_stats(), engines["port"].get_stats()
    for block in ("flight", "perf", "integrity"):
        assert block in t and block in j
        assert set(t[block]) == set(j[block]), block


def test_deadline_phases_name_the_reference_phases(engines):
    """The 504's ``phases`` breakdown (flight.phases_of) of a finished
    request names the same phases in both engines."""
    jp = engines["jax"].flight.phases_of(engines["seqs"]["jax"][0])
    tp = engines["port"].flight.phases_of(engines["seqs"]["port"][0])
    assert set(tp) == set(jp) and tp


@pytest.mark.parametrize("bits", [None, 8, 4])
def test_stream_weight_bytes_equal_the_reference(bits):
    tree = j_init(J_TINY, None, np.float32)
    if bits:
        tree = quantize_decoder_params(tree, J_TINY, bits=bits)
    port = params_from_jax(jax.tree.map(np.asarray, tree), TINY_DENSE)
    for tied in (False, True):
        assert roofline.stream_weight_bytes(port, tied) == \
            j_roofline.stream_weight_bytes(tree, tied)


def test_the_peak_table_has_the_h100_and_the_reference_rows():
    assert roofline.peaks_for("NVIDIA H100 80GB HBM3") == (989e12, 3350.0)
    for kind, peaks in j_roofline.DEVICE_PEAKS.items():
        assert roofline.peaks_for(kind) == peaks
    r = roofline.EngineRoofline(
        device_kind="NVIDIA H100 80GB HBM3", num_chips=1,
        num_params=7_615_616_512, weight_stream_bytes=14_141_238_272,
        kv_token_bytes=57_344)
    # 750 tok/s at 7B: 1.2 % of the bf16 peak; 14.1 GB in 10 ms: 42 %
    assert r.mfu(750.0) == pytest.approx(2 * 7_615_616_512 * 750 / 989e12)
    assert r.hbm_roofline_pct(14.141e9, 0.010) == pytest.approx(
        100 * 14.141e9 / 0.010 / 1e9 / 3350.0)


def test_perf_recorder_matches_the_reference_on_a_fake_clock():
    """The copy's window math on a pinned clock equals the reference's."""
    from vgate_tpu.observability import perf as j_perf

    out = []
    for mod, cfg in ((perf, load_config().observability),
                     (j_perf, j_load_config().observability)):
        now = [100.0]
        rec = mod.PerfRecorder(cfg, clock=lambda: now[0])
        for dispatch, device, detok, tokens in ((0.01, 0.02, 0.001, 4),
                                                (0.0, 0.03, 0.002, 8)):
            rec.tick_begin()
            rec.phase("dispatch", dispatch)
            rec.phase("device", device)
            rec.phase("detok", detok)
            rec.note_tokens(tokens)
            now[0] += 0.05
            rec.tick_end(True)
        rec.record_compile("decode", (8, True), 0.5, trigger="chunk")
        snap = rec.snapshot()
        for entry in snap["compile_ledger"]:
            entry.pop("first_t"), entry.pop("last_t")
        out.append(snap)
    assert out[0] == out[1]


def test_flight_recorder_rings_are_bounded():
    cfg = load_config(observability={"flight_ticks": 4,
                                     "flight_requests": 2}).observability
    rec = FlightRecorder(cfg)
    for i in range(10):
        rec.record_tick("decode", batch=i)
    assert [t["batch"] for t in rec.ticks(100)] == [6, 7, 8, 9]


def test_engine_phase_spans_reach_the_span_recorder():
    """With the flight recorder on, a request submitted with its trace
    context gets the engine's phase spans (queue, prefill, decode) as
    children of that context, in the in-memory recorder."""
    pytest.importorskip("opentelemetry.trace")
    from vgate_tpu_torch.observability.memtrace import MemorySpanRecorder
    from vgate_tpu_torch.tracing import capture_context, get_tracer

    recorder = MemorySpanRecorder().install()
    try:
        core = EngineCore(load_config(
            model=MODEL, device={"device": "cpu", **SHAPES},
            logging={"level": "ERROR"}))
        with get_tracer("test").start_as_current_span("http") as span:
            meta = RequestMeta(request_id="span-req",
                               trace_ctx=capture_context())
            trace_id = span.get_span_context().trace_id
        seq = core.submit_tokens([5, 9, 13], SamplingParams(
            max_tokens=4, temperature=0.0), meta=meta)
        _drive(core, [seq])
        names = {s.name for s in recorder.spans()
                 if s.trace_id_hex == format(trace_id, "032x")}
        assert {"engine.queue", "engine.prefill", "engine.decode"} <= names
    finally:
        recorder.uninstall()


def test_a_settled_sequence_does_not_keep_its_engine_alive():
    """The settle observer is the engine's bound method: once a sequence
    settles it lets go, so a caller that keeps the sequence does not keep
    the engine and its KV pool (the next engine sizes its pool from the
    free memory)."""
    import gc
    import weakref

    core = EngineCore(load_config(model=MODEL,
                                  device={"device": "cpu", **SHAPES},
                                  logging={"level": "ERROR"}))
    seq = core.submit_tokens([5, 9, 13], SamplingParams(
        max_tokens=3, temperature=0.0), meta=RequestMeta(request_id="r"))
    assert seq.on_settle is not None
    _drive(core, [seq])
    assert seq.on_settle is None
    alive = weakref.ref(core)
    core.stop()
    del core
    gc.collect()
    assert alive() is None
