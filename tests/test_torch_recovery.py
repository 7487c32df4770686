"""The port's supervised recovery (runtime/supervisor.py and the engine's
containment hooks) against the reference's, on the CPU.

Fast tier, no model: the watchdog's verdict, the restart budget and the
fatal classification equal the reference functions' on the same inputs;
the containment partition on a bare core (checkpoint, first entry only,
``max_resume_attempts``, aborted or unsupervised sequences, a stall
declared off the engine thread) and the replay policy on a fake core
(quarantined poison, the original prompt's fingerprint, a refused
resubmission), as tests/test_resume.py holds the reference's.

With the tiny-dense engine: a transient fault restarts the engine and it
serves again in the same process; resumed requests finish token-identical
to an undisturbed run; the restart budget lands in DEAD, also when a
rebuild itself raises; an unrecoverable fault goes straight to DEAD;
poison is quarantined; a request is given up on after
``max_resume_attempts``; a stall is detected and replayed.  Last, the
port's supervisor against the reference's on one weight tree, both
engines' ticks driven by the test: a crash after the first decode chunk,
the rebuild and the replay, the resumed greedy streams identical.
"""

import queue
import threading
import time
from collections import deque
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from vgate_tpu import errors as j_errors
from vgate_tpu import faults as j_faults
from vgate_tpu.backends.base import SamplingParams as JSamplingParams
from vgate_tpu.config import load_config as j_load_config
from vgate_tpu.runtime import supervisor as j_supervisor
from vgate_tpu.runtime.engine_core import EngineCore as JEngineCore
from vgate_tpu.runtime.weights import load_or_init_params as j_init
from vgate_tpu_torch import config as config_mod
from vgate_tpu_torch import faults
from vgate_tpu_torch.backends.base import SamplingParams
from vgate_tpu_torch.config import load_config
from vgate_tpu_torch.errors import (
    EngineDeadError,
    EngineRecoveringError,
    EngineStalledError,
    IntegrityError,
    PoisonRequestError,
    ResumeExhaustedError,
    RetryableError,
)
from vgate_tpu_torch.models.specs import TINY_DENSE
from vgate_tpu_torch.runtime import engine_core as port_engine_core
from vgate_tpu_torch.runtime import supervisor as port_supervisor
from vgate_tpu_torch.runtime.engine_core import EngineCore
from vgate_tpu_torch.runtime.sequence import Sequence, SeqStatus
from vgate_tpu_torch.runtime.supervisor import (
    EngineSupervisor,
    HealthState,
    classify_fatal,
    classify_heartbeat,
    restart_budget_remaining,
)
from vgate_tpu_torch.runtime.weights import params_from_jax


@pytest.fixture(autouse=True)
def _reset_port_state():
    """The port's own singletons (the conftest resets the reference's)."""
    config_mod.reset_config()
    faults.reset()
    yield
    faults.reset()
    config_mod.reset_config()


def greedy(max_tokens=8, **kw):
    return SamplingParams(max_tokens=max_tokens, temperature=0.0, **kw)


def wait_for(pred, timeout=60.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return False


# ---------------------------------------- the pure functions vs the reference


@pytest.mark.parametrize("beat,now,stall,grace", [
    ({"t": 0.0, "kind": "decode", "compiling": False}, 5.0, 2.5, 60.0),
    ({"t": 0.0, "kind": "decode", "compiling": False}, 2.0, 2.5, 60.0),
    ({"t": 0.0, "kind": "prefill", "compiling": True}, 30.0, 2.5, 60.0),
    ({"t": 0.0, "kind": "decode", "compiling": True}, 61.0, 2.5, 60.0),
    ({"t": 0.0, "kind": "tick"}, 99.0, 0.0, 60.0),
    (None, 99.0, 2.5, 60.0),
    ({}, 99.0, 2.5, 60.0),
])
def test_watchdog_verdict_matches_the_reference(beat, now, stall, grace):
    assert classify_heartbeat(beat, now, stall, grace) == \
        j_supervisor.classify_heartbeat(beat, now, stall, grace)


@pytest.mark.parametrize("times,now", [
    ([], 100.0), ([10.0, 50.0], 100.0), ([1.0, 2.0, 3.0, 4.0], 100.0),
    ([1.0, 290.0, 295.0], 300.0),
])
def test_restart_budget_matches_the_reference(times, now):
    rec = SimpleNamespace(restart_window_s=60.0, max_restarts=3)
    assert restart_budget_remaining(times, rec, now) == \
        j_supervisor.restart_budget_remaining(times, rec, now)


@pytest.mark.parametrize("make", [
    lambda e, f: f.InjectedFault("decode_step", kind="transient"),
    lambda e, f: f.InjectedFault("decode_step", kind="poison"),
    lambda e, f: f.InjectedFault("decode_step", kind="unrecoverable"),
    lambda e, f: f.InjectedFault("weight_corrupt", kind="corrupt"),
    lambda e, f: e.IntegrityError("flip", kind="checksum_mismatch"),
    lambda e, f: e.EngineStalledError("wedged", stalled_s=3.0,
                                      phase="decode"),
    lambda e, f: MemoryError("out of memory"),
    lambda e, f: RuntimeError("CUDA error: an illegal memory access"),
], ids=["transient", "poison", "unrecoverable", "injected-corrupt",
        "integrity", "stall", "memory", "runtime"])
def test_fatal_classification_matches_the_reference(make):
    from vgate_tpu_torch import errors

    assert classify_fatal(make(errors, faults)) == \
        j_supervisor.classify_fatal(make(j_errors, j_faults))


# ----------------------------------- containment partition (a bare core)


def _bare_core(resume=True, max_attempts=3, supervised=True):
    """An EngineCore shell with exactly the state containment touches:
    no device, no weights, no thread."""
    core = EngineCore.__new__(EngineCore)
    core.flight = SimpleNamespace(
        record_tick=lambda *a, **k: None,
        crash_snapshot=lambda exc=None: {"error": str(exc)},
        enabled=False,
    )
    core.scheduler = SimpleNamespace(
        running=[], waiting=deque(), slots=[None] * 4
    )
    core.geometry = SimpleNamespace(kv_dtype="f32")
    core._submit_q = queue.Queue()
    core._evac_q = queue.Queue()  # containment unblocks evacuate() callers
    core._pending_chunks = []
    core._checkpointed = []
    core._resume_losses = 0
    core._fatal = None
    core._fatal_suspects = []
    core._crash_snapshot = None
    core._running = True
    core._stalled = False
    core._resume_enabled = resume
    core._max_resume_attempts = max_attempts
    core.on_fatal = (lambda exc: None) if supervised else None
    core._heartbeat = {"t": time.monotonic(), "compiling": False}
    core._wakeup = threading.Event()
    core._contain_lock = threading.Lock()
    core._readback_lock = threading.Lock()
    core._containment_done = False
    return core


def _running_seq(prompt, tokens=()):
    seq = Sequence(prompt_ids=list(prompt), params=greedy(16))
    seq.status = SeqStatus.RUNNING
    seq.slot = 0
    for t in tokens:
        seq.append_token(t)
    return seq


def test_containment_checkpoints_resumable_sequences():
    core = _bare_core()
    running = _running_seq([1, 2, 3], tokens=(9,))
    waiting = Sequence(prompt_ids=[4, 5], params=greedy(4))
    queued = Sequence(prompt_ids=[6], params=greedy(4))
    core.scheduler.running.append(running)
    core.scheduler.waiting.append(waiting)
    core._submit_q.put(queued)
    epoch = running.preempt_count
    assert core._contain_fatal(RuntimeError("boom")) is True
    kept = core.take_checkpointed()
    assert kept == [running, waiting, queued]
    assert all(s.status is SeqStatus.WAITING for s in kept)
    assert running.prompt_ids == [1, 2, 3, 9]  # folded
    # the epoch a late readback of a stalled thread is checked against
    assert running.preempt_count == epoch + 1
    assert all(s.resume_count == 1 and s.kv_dtype == "f32" for s in kept)
    assert not running.done_event.is_set()  # still owed, not failed
    assert core._containment_done and not core._running
    assert core.take_checkpointed() == []


def test_containment_is_first_entry_only():
    fired = []
    core = _bare_core()
    core.on_fatal = fired.append
    seq = _running_seq([1, 2, 3], tokens=(9,))
    core.scheduler.running.append(seq)
    first = EngineStalledError("wedged", stalled_s=9.0, phase="decode")
    assert core.declare_stalled(first) is True
    assert core._contain_fatal(RuntimeError("woke into swept state")) \
        is False
    assert core._fatal is first and fired == [first]
    assert core.take_checkpointed() == [seq]


def test_containment_gives_up_after_max_resume_attempts():
    core = _bare_core(max_attempts=2)
    tired = _running_seq([1, 2, 3], tokens=(9,))
    tired.resume_count = 2
    fresh = _running_seq([4, 5, 6])
    core.scheduler.running.extend([tired, fresh])
    core._contain_fatal(RuntimeError("boom"))
    assert core.take_checkpointed() == [fresh]
    assert isinstance(tired.error, ResumeExhaustedError)
    assert tired.error.retry_after >= 1.0
    assert core.take_resume_losses() == 1 and core.take_resume_losses() == 0


def test_containment_does_not_checkpoint_aborted_or_unsupervised():
    core = _bare_core()
    gone = _running_seq([1, 2, 3])
    gone.request_abort()
    core.scheduler.running.append(gone)
    core._contain_fatal(RuntimeError("boom"))
    assert core.take_checkpointed() == []
    # supervised: the retryable type, the raw fault chained
    assert isinstance(gone.error, EngineRecoveringError)
    core = _bare_core(supervised=False)
    seq = _running_seq([1, 2, 3])
    core.scheduler.running.append(seq)
    core._contain_fatal(RuntimeError("boom"))
    assert core.take_checkpointed() == []
    assert type(seq.error) is RuntimeError  # unsupervised: the raw fault


def test_declare_stalled_contains_off_thread():
    core = _bare_core()
    seq = _running_seq([1, 2, 3], tokens=(7,))
    core.scheduler.running.append(seq)
    exc = EngineStalledError("wedged", stalled_s=9.0, phase="decode")
    caller = []
    t = threading.Thread(
        target=lambda: caller.append(core.declare_stalled(exc)))
    t.start()
    t.join()
    assert caller == [True]
    assert core._fatal is exc and core._stalled and not core._running
    assert core.take_checkpointed() == [seq]
    assert core.declare_stalled(exc) is False


# -------------------------------------------- replay policy (fake cores)


class _FakeReplayCore:
    def __init__(self, fail=False):
        self.submitted, self.ticks, self._fail = [], [], fail
        self.flight = SimpleNamespace(
            record_tick=lambda *a, **k: self.ticks.append(k))

    def submit_existing(self, seq):
        if self._fail:
            raise RuntimeError("submit refused")
        self.submitted.append(seq)


def _bare_supervisor(quarantine=()):
    sup = EngineSupervisor.__new__(EngineSupervisor)
    sup._lock = threading.RLock()
    sup._quarantine = set(quarantine)
    sup._restart_times = []
    sup._recovery = SimpleNamespace(backoff_base_s=0.25, backoff_cap_s=30.0)
    sup.total_resumed = 0
    sup.total_lost = 0
    sup._pending_resume = []
    sup.last_resume = None
    return sup


def test_replay_excludes_quarantined_poison():
    poison_ids = [3, 1, 666, 4]
    sup = _bare_supervisor({faults.fingerprint(poison_ids)})
    poison = Sequence(prompt_ids=list(poison_ids), params=greedy(8))
    innocent = Sequence(prompt_ids=[7, 8, 9], params=greedy(8))
    for s in (poison, innocent):
        s.prepare_resume()
    sup._pending_resume = [poison, innocent]
    core = _FakeReplayCore()
    sup._replay(core)
    assert core.submitted == [innocent]
    assert isinstance(poison.error, PoisonRequestError)
    assert sup.total_resumed == 1 and sup.total_lost == 1
    assert [t["seq_id"] for t in core.ticks] == [innocent.seq_id]
    assert core.ticks[0]["attempt"] == 1


def test_replay_quarantine_keys_on_original_prompt():
    poison_ids = [3, 1, 666, 4]
    sup = _bare_supervisor({faults.fingerprint(poison_ids)})
    seq = Sequence(prompt_ids=list(poison_ids), params=greedy(8))
    seq.status = SeqStatus.RUNNING
    seq.append_token(42)
    seq.prepare_resume()
    assert seq.prompt_ids != poison_ids
    sup._pending_resume = [seq]
    core = _FakeReplayCore()
    sup._replay(core)
    assert core.submitted == [] and isinstance(seq.error, PoisonRequestError)


def test_replay_resubmit_failure_fails_typed():
    sup = _bare_supervisor()
    seq = Sequence(prompt_ids=[1, 2], params=greedy(4))
    seq.prepare_resume()
    sup._pending_resume = [seq]
    sup._replay(_FakeReplayCore(fail=True))
    assert seq.status is SeqStatus.FAILED
    assert getattr(seq.error, "retry_after", None) is not None
    assert sup.total_lost == 1


def test_submit_existing_refuses_another_kv_format():
    core = _bare_core()
    core.flight.enabled = False
    seq = Sequence(prompt_ids=[1, 2], params=greedy(4))
    seq.kv_dtype = "int8"
    with pytest.raises(ValueError, match="kv dtype"):
        core.submit_existing(seq)


# ------------------------------------------ supervised tiny-dense engines


def rec_config(recovery=None, integrity=None, **device):
    rec = {"enabled": True, "max_restarts": 5, "restart_window_s": 120.0,
           "backoff_base_s": 0.02, "backoff_cap_s": 0.2,
           "degraded_probation_s": 0.25, "poison_threshold": 2}
    rec.update(recovery or {})
    return load_config(
        model={"model_id": "tiny-dense", "dtype": "float32",
               "max_model_len": 64},
        device={"device": "cpu", "kv_num_pages": 64, "kv_page_size": 4,
                "max_batch_slots": 4, "prefill_buckets": [8, 16, 32],
                "prefix_cache": False, **device},
        scheduler={"max_queue_size": 16},
        recovery=rec,
        integrity=integrity or {},
        logging={"level": "ERROR"},
    )


@pytest.fixture
def supervised():
    made = []

    def make(**kw):
        sup = EngineSupervisor(rec_config(**kw))
        sup.start()
        made.append(sup)
        return sup

    yield make
    for sup in made:
        sup.stop()


def generate_with_retry(sup, prompt, max_tokens=4, attempts=40):
    for _ in range(attempts):
        try:
            return sup.generate([prompt], [greedy(max_tokens)])[0]
        except RetryableError:
            time.sleep(0.05)
    raise AssertionError(f"request never succeeded: {prompt!r}")


def test_transient_fault_restarts_and_serves_again(supervised):
    """Fail-fast contract (``resume_in_flight`` off): the in-flight
    request fails retryable, the core is rebuilt with its weights kept,
    the states walk SERVING -> RECOVERING -> DEGRADED -> SERVING, and the
    next request succeeds in the same process."""
    sup = supervised(recovery={"resume_in_flight": False})
    assert sup.state is HealthState.SERVING
    params = sup.core.params
    faults.arm("decode_step", mode="raise", kind="transient", times=1)
    seq = sup.submit_tokens([5, 9, 13, 17, 21], greedy(30))
    assert seq.done_event.wait(60)
    assert isinstance(seq.error, EngineRecoveringError)
    assert wait_for(lambda: sup.state is HealthState.SERVING)
    assert sup.core.params is params  # weights kept
    out = generate_with_retry(sup, "after the crash")
    assert out["num_tokens"] >= 1
    h = sup.health()
    assert h["restarts"] == 1 and h["crashes"] == 1
    assert h["transitions"][:3] == [("serving", "recovering"),
                                    ("recovering", "degraded"),
                                    ("degraded", "serving")]
    assert sup.get_stats()["last_crash"]["classification"] == "transient"


def test_crash_replay_is_token_identical(supervised):
    """With ``resume_in_flight`` (the default) a crash after the first
    chunk checkpoints the requests and replays them into the rebuilt
    core: they complete, marked resumed, token-identical to an
    undisturbed run (fp32)."""
    sup = supervised()
    prompts = ["alpha beta gamma", "delta", "epsilon zeta eta theta"]
    clean = sup.generate(prompts, [greedy(24)] * 3)
    seqs = [sup.submit_prompt(p, greedy(24)) for p in prompts]
    assert wait_for(lambda: all(s.num_generated >= 2 for s in seqs))
    faults.arm("decode_step", mode="raise", times=1)
    for s in seqs:
        assert s.done_event.wait(60)
    assert [s.generated_ids for s in seqs] == [c["token_ids"]
                                               for c in clean]
    assert all(s.resume_count == 1 for s in seqs)
    h = sup.health()
    assert (h["restarts"], h["resumed"], h["lost"]) == (1, 3, 0)
    resume = sup.get_stats()["last_resume"]
    assert resume["checkpointed"] == 3 and resume["replayed"] == 3


def test_restart_budget_exhausted_lands_dead(supervised, monkeypatch):
    """Every rebuild raising (a CUDA context an illegal address poisoned
    would fail each one) burns the budget: the engine lands in DEAD
    without hanging, and the checkpointed work fails typed."""
    sup = supervised(recovery={"max_restarts": 2})
    calls = []

    def broken(*a, **k):
        calls.append(1)
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(port_supervisor, "rebuild_core", broken)
    faults.arm("decode_step", mode="raise", times=1)
    seq = sup.submit_tokens([5, 9, 13], greedy(30))
    assert seq.done_event.wait(60)
    assert wait_for(lambda: sup.state is HealthState.DEAD)
    assert len(calls) == 2
    assert isinstance(seq.error, EngineDeadError)
    h = sup.health()
    assert h["restarts_remaining"] == 0 and h["lost"] == 1
    assert not h["alive"] and not h["ready"]
    with pytest.raises(EngineDeadError):
        sup.submit_tokens([1, 2], greedy(2))


def test_unrecoverable_fault_goes_straight_to_dead(supervised):
    sup = supervised()
    faults.arm("decode_step", mode="raise", kind="unrecoverable", times=1)
    seq = sup.submit_tokens([5, 9, 13], greedy(30))
    assert seq.done_event.wait(60)
    assert wait_for(lambda: sup.state is HealthState.DEAD)
    assert sup.total_restarts == 0
    assert sup.get_stats()["last_crash"]["classification"] == \
        "unrecoverable"


def test_poison_request_is_quarantined(supervised):
    """A poison fault names its request: it is quarantined, fails 400 on
    the replay, and a client retry is refused at the gate; other traffic
    is served by the rebuilt core."""
    sup = supervised()
    poison = [11, 22, 33, 44]
    faults.arm("prefill", mode="raise", kind="poison", times=1,
               match=lambda payload: list(payload) == poison)
    seq = sup.submit_tokens(poison, greedy(8))
    assert seq.done_event.wait(60)
    assert isinstance(seq.error, PoisonRequestError)
    assert wait_for(lambda: sup.state is HealthState.DEGRADED)
    with pytest.raises(PoisonRequestError):
        sup.submit_tokens(poison, greedy(8))
    assert generate_with_retry(sup, "innocent")["num_tokens"] >= 1
    assert sup.health()["quarantined"] == 1


def test_repeat_offender_is_quarantined(supervised):
    """A request freshly submitted into ``poison_threshold`` crashes in a
    row is quarantined (the client kept resubmitting what kills the
    engine)."""
    sup = supervised(recovery={"resume_in_flight": False})
    prompt = [7, 7, 7, 7, 8]
    for _ in range(2):
        faults.arm("decode_step", mode="raise", times=1)
        seq = sup.submit_tokens(prompt, greedy(20))
        assert seq.done_event.wait(60)
        assert wait_for(lambda: sup.state is not HealthState.RECOVERING
                        and sup.core._fatal is None)
    with pytest.raises(PoisonRequestError):
        sup.submit_tokens(prompt, greedy(4))


def test_resume_exhausted_gives_up_typed(supervised):
    """A request that rode ``max_resume_attempts`` restarts is given up
    on with the typed retryable 503 and counted lost."""
    sup = supervised(recovery={"max_resume_attempts": 1})
    seq = sup.submit_tokens([4, 8, 15, 16, 23, 42], greedy(40))
    assert wait_for(lambda: seq.num_generated >= 2)
    faults.arm("decode_step", mode="raise", times=2)
    assert seq.done_event.wait(60)
    assert isinstance(seq.error, ResumeExhaustedError)
    assert wait_for(lambda: sup.health()["lost"] == 1)
    assert wait_for(lambda: sup.health()["restarts"] == 2)


def test_stall_watchdog_detects_and_replays(supervised):
    """A ``stall`` delay past ``step_stall_s``: the watchdog declares the
    engine wedged off its thread, the requests are checkpointed and
    replayed into a rebuilt core, and complete token-identical."""
    sup = supervised(recovery={"step_stall_s": 0.6,
                               "compile_grace_s": 600.0})
    prompts = ["one two", "three four five"]
    clean = sup.generate(prompts, [greedy(12)] * 2)
    faults.arm("stall", mode="delay", delay_s=2.0, times=1)
    out = sup.generate(prompts, [greedy(12)] * 2)
    assert [r["token_ids"] for r in out] == [c["token_ids"] for c in clean]
    assert all(r["metrics"].get("resumed") for r in out)
    h = sup.health()
    assert h["stalls"] == 1 and h["restarts"] == 1 and h["lost"] == 0
    stall = [t for t in sup.last_crash["ticks"] if t["kind"] == "stall"]
    assert stall and stall[0]["phase"] == "tick"


def test_weight_load_fault_fails_first_construction():
    faults.arm("weight_load", mode="raise", kind="transient", times=1)
    with pytest.raises(faults.InjectedFault):
        EngineSupervisor(rec_config())


def test_kept_weights_rebuild_refuses_a_flipped_tree(supervised):
    """``rebuild_core`` re-verifies a kept tree against its baseline: a
    flipped leaf raises ``IntegrityError`` (the supervisor escalates to
    a reload); ``reload_weights`` builds from the seed again."""
    from vgate_tpu_torch import integrity

    sup = supervised()
    core = sup.core
    core.stop()
    baseline = dict(core.integrity.verifier.baseline)
    leaf = dict(integrity.leaves_with_path(core.params))["['final_norm']"]
    integrity._bitflip_leaf(leaf)
    with pytest.raises(IntegrityError) as info:
        port_engine_core.rebuild_core(core, core.config)
    assert info.value.integrity_kind == "checksum_mismatch"
    assert info.value.detail["leaf"] == "['final_norm']"
    fresh = port_engine_core.rebuild_core(core, core.config,
                                          reload_weights=True)
    assert core.params is None and core.k_pages is None
    # the same seed: the reloaded tree is the boot tree, leaf for leaf
    assert fresh.integrity.verifier.baseline == baseline
    fresh.stop()


# ----------------------- the port's supervisor vs the reference's, driven


def _no_thread(cls):
    """``start`` that only marks the core running: the test drives the
    ticks."""
    return lambda self: setattr(self, "_running", True)


def _drive(core, seqs, until):
    for _ in range(10_000):
        if until():
            return
        core._tick()
    raise AssertionError("the engine did not get there")


def test_resumed_streams_match_the_reference_supervisor(monkeypatch):
    """One weight tree in both packages; each supervisor's engine serves
    three greedy requests, its decode step raises once after the first
    chunk, the test contains the fault as the loop would and runs the
    supervisor's crash handling (checkpoint, rebuild with the weights
    kept, replay), then drives the rebuilt core to the end.  The resumed
    streams are identical between the packages and to the undisturbed
    run, with one restart, three resumed and none lost in each."""
    monkeypatch.setattr(JEngineCore, "start", _no_thread(JEngineCore))
    monkeypatch.setattr(EngineCore, "start", _no_thread(EngineCore))
    tree = j_init(TINY_DENSE, None, np.float32)

    def port_load(spec, checkpoint_path, device, dtype, seed=0,
                  log_digests=False, quantization=None):
        return params_from_jax(jax.tree.map(np.asarray, tree), TINY_DENSE)

    monkeypatch.setattr(port_engine_core, "load_or_init_params", port_load)
    shapes = {"kv_num_pages": 64, "kv_page_size": 4, "max_batch_slots": 4,
              "prefill_buckets": [8, 16, 32], "prefix_cache": False}
    rec = {"backoff_base_s": 0.0, "backoff_cap_s": 0.0}
    j_sup = j_supervisor.EngineSupervisor(
        j_load_config(
            model={"model_id": "tiny-dense", "engine_type": "jax_tpu",
                   "dtype": "float32", "max_model_len": 64},
            tpu={"dp": 1, "tp": 1, "ep": 1, "sp": 1, "use_pallas": False,
                 **shapes},
            recovery=rec, logging={"level": "ERROR"},
        ),
        devices=jax.devices()[:1],
    )
    t_sup = EngineSupervisor(load_config(
        model={"model_id": "tiny-dense", "dtype": "float32",
               "max_model_len": 64},
        device={"device": "cpu", **shapes}, recovery=rec,
        logging={"level": "ERROR"},
    ))
    prompts = [[5, 9, 13, 17, 21], [3, 1, 4, 1, 5, 9, 2, 6], [8, 8, 2]]
    streams = {}
    for name, sup, sp, fmod in (("jax", j_sup, JSamplingParams, j_faults),
                                ("port", t_sup, SamplingParams, faults)):
        sup.core.start()
        params = sp(max_tokens=20, temperature=0.0)
        clean = [sup.submit_tokens(p, params) for p in prompts]
        _drive(sup.core, clean,
               lambda: all(s.done_event.is_set() for s in clean))
        seqs = [sup.submit_tokens(p, params) for p in prompts]
        _drive(sup.core, seqs, lambda: all(s.num_generated >= 2
                                           for s in seqs))
        fmod.arm("decode_step", mode="raise", times=1)
        try:
            _drive(sup.core, seqs, lambda: False)
        except fmod.InjectedFault as exc:
            sup.core._contain_fatal(exc)
        assert sup.state.value == "recovering"
        sup._handle_crash()
        _drive(sup.core, seqs,
               lambda: all(s.done_event.is_set() for s in seqs))
        h = sup.health()
        assert (h["restarts"], h["resumed"], h["lost"]) == (1, 3, 0)
        assert sup.state.value == "degraded"
        assert [s.generated_ids for s in seqs] == [s.generated_ids
                                                   for s in clean]
        streams[name] = [list(s.generated_ids) for s in seqs]
        sup.stop()
        fmod.reset()
    assert streams["port"] == streams["jax"]
