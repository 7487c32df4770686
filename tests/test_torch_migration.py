"""Planned live migration in the port — the host logic, no engine builds.

The cases of ``tests/test_migration.py`` and the dp cases of
``tests/test_resume.py``, run against the port's modules: the
``Sequence`` fold/epoch semantics of ``prepare_migrate``, the scheduler's
evacuate/bypass behavior, ``replay_into``'s migrate flavor, the kv-dtype
placement gate (both directions), the hysteresis/rate-limit rebalancing
policy on a fake clock (each decision also held to the reference's
policy fed the same signals), the dp=1 supervisor's refusal, the
evacuation command plumbing, the merged flight view, the structural
lock and the failover redistribution.  The engine-level cases are in
tests/test_torch_dp.py.
"""

import queue
import threading
import time
from types import SimpleNamespace

import pytest

from vgate_tpu.config import load_config as j_load_config
from vgate_tpu.runtime.dp_engine import RebalancePolicy as JRebalancePolicy
from vgate_tpu_torch import config as config_mod
from vgate_tpu_torch import faults, metrics
from vgate_tpu_torch.backends.base import SamplingParams
from vgate_tpu_torch.config import load_config
from vgate_tpu_torch.errors import (
    MigrationError,
    MigrationRefusedError,
    PoisonRequestError,
)
from vgate_tpu_torch.runtime.dp_engine import (
    RebalancePolicy,
    ReplicatedEngine,
    _MergedFlight,
    _structural,
    replica_devices,
)
from vgate_tpu_torch.runtime.engine_core import EngineCore, replay_into
from vgate_tpu_torch.runtime.kv_cache import PageAllocator
from vgate_tpu_torch.runtime.scheduler import Scheduler
from vgate_tpu_torch.runtime.sequence import Sequence, SeqStatus
from vgate_tpu_torch.runtime.supervisor import EngineSupervisor


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


# --------------------------------------------------- config and slices


def test_migration_section_has_the_reference_fields_and_defaults():
    port = load_config(model={"model_id": "tiny-dense"}).migration
    ref = j_load_config().migration
    assert vars(port) == ref.model_dump()
    over = {"rebalance_hold_s": 0.0, "max_moves_per_cycle": 5}
    assert load_config(model={"model_id": "tiny-dense"},
                       migration=over).migration.max_moves_per_cycle == 5
    with pytest.raises(TypeError, match="unknown key"):
        load_config(model={"model_id": "tiny-dense"},
                    migration={"nope": 1})


@pytest.mark.parametrize("device,expect", [
    ({"device": "cpu", "dp": 2}, [["cpu"], ["cpu"]]),
    ({"device": "cpu", "dp": 3}, [["cpu"], ["cpu"], ["cpu"]]),
    ({"dp": 2, "devices": ["cuda:0", "cuda:0"]}, [["cuda:0"], ["cuda:0"]]),
    ({"dp": 2, "devices": ["cuda:1", "cuda:0"]}, [["cuda:1"], ["cuda:0"]]),
])
def test_replica_slices_take_one_device_each(device, expect):
    """Replica i takes slice i of device.devices (a card named twice
    holds two replicas), or the CPU once a replica."""
    cfg = load_config(model={"model_id": "tiny-dense"}, device=device)
    assert replica_devices(cfg.device) == expect


@pytest.mark.parametrize("device,error,match", [
    ({"dp": 2, "tp": 2}, config_mod.NotPortedError,
     r"device.dp>1 .* queue 1, item 10b \(rest\)"),
    ({"dp": 2, "ep": 2}, config_mod.NotPortedError,
     r"queue 1, item 10b \(rest\)"),
    # sp serves since item 10d (rest)'s first part: dp x sp is a dp
    # replica that is itself a mesh (the test keeps its id)
    pytest.param({"dp": 2, "sp": 2}, config_mod.NotPortedError,
                 r"device.dp>1 .*device.sp .* queue 1, item 10b \(rest\)",
                 id="device2-NotPortedError-queue 1, item 10d"),
    # pp serves since item 10d's first part: dp x pp is a dp replica that
    # is itself a mesh (the test keeps its id)
    pytest.param({"dp": 2, "pp": 2}, config_mod.NotPortedError,
                 r"device.dp>1 .*device.pp .* queue 1, item 10b \(rest\)",
                 id="device3-NotPortedError-queue 1, item 10d"),
    ({"dp": 2, "devices": ["cpu", "cpu", "cpu"]}, ValueError,
     r"names 3 devices but device.dp is 2"),
    ({"dp": 0}, ValueError, r"device.dp must be >= 1"),
])
def test_dp_config_refusals(device, error, match):
    with pytest.raises(error, match=match):
        load_config(model={"model_id": "tiny-dense"}, device=device)


def test_dp_composes_with_the_host_swap_tier():
    """Each replica owns its pool and its host tier (the reference's
    plain-mesh check names dp as composing)."""
    cfg = load_config(model={"model_id": "tiny-dense"},
                      device={"device": "cpu", "dp": 2},
                      kv_cache={"host_swap_bytes": 1 << 20})
    assert cfg.device.dp == 2 and cfg.kv_cache.host_swap_bytes == 1 << 20


def test_a_core_refuses_a_dp_config():
    cfg = load_config(model={"model_id": "tiny-dense"},
                      device={"device": "cpu", "dp": 2})
    with pytest.raises(ValueError, match="ReplicatedEngine"):
        EngineCore(cfg)


# --------------------------------------------------- sequence semantics


def test_prepare_migrate_folds_without_spending_resume_budget():
    seq = Sequence(prompt_ids=[4, 5], params=greedy(8))
    seq.status = SeqStatus.RUNNING
    seq.slot = 1
    seq.pages = [3, 9]
    seq.append_token(11)
    old_epoch = seq.preempt_count
    seq.prepare_migrate()
    assert seq.status is SeqStatus.WAITING
    assert seq.prompt_ids == [4, 5, 11] and seq.output_ids == []
    assert seq.pages == [] and seq.slot is None
    assert seq.preempt_count == old_epoch + 1
    assert not seq.done_event.is_set()
    assert seq.migrate_count == 1
    assert seq.resume_count == 0


@pytest.mark.parametrize("fold", ["prepare_resume", "prepare_migrate"])
def test_a_fold_drops_the_source_trees_locks(fold):
    """A crash fold never releases the residency on the dying core, so
    the sequence still names that core's radix-tree path locks; the
    replay target's scheduler would unlock them in its own tree (its
    evictable count then exceeds its pages: negative used pages).  Both
    folds drop them."""
    seq = Sequence(prompt_ids=[4, 5, 6], params=greedy(8))
    seq.status = SeqStatus.RUNNING
    seq.pages = [3]
    seq.append_token(9)
    seq._radix_match = object()
    seq._radix_insert_node = object()
    seq._radix_probe_cache = ((4, 0, 1), (1, 4))
    getattr(seq, fold)()
    assert seq._radix_match is None and seq._radix_insert_node is None
    assert seq._radix_probe_cache is None


def test_resume_metrics_carries_both_flavors():
    seq = Sequence(prompt_ids=[1], params=greedy())
    assert seq.resume_metrics() == {}
    seq.migrate_count = 2
    assert seq.resume_metrics() == {"migrated": 2.0}
    seq.resume_count = 1
    assert seq.resume_metrics() == {"resumed": 1.0, "migrated": 2.0}


def test_checkpoint_round_trip_preserves_migrate_count():
    seq = Sequence(prompt_ids=[1, 2, 3], params=greedy(16))
    seq.append_token(7)
    seq.migrate_count = 1
    cp = seq.checkpoint()
    assert cp.migrate_count == 1
    restored = Sequence.from_checkpoint(cp)
    assert restored.migrate_count == 1
    assert seq.checkpoint_summary() == cp.as_dict()


# ----------------------------------------------------- scheduler pieces


def _scheduler(max_queue=2, num_pages=16):
    return Scheduler(
        allocator=PageAllocator(num_pages),
        max_slots=2,
        page_size=4,
        prefill_buckets=[8, 16],
        max_model_len=32,
        max_queue_size=max_queue,
    )


def test_scheduler_add_migrated_bypasses_queue_full():
    sched = _scheduler(max_queue=1)
    sched.add(Sequence(prompt_ids=[1, 2], params=greedy()))
    fresh = Sequence(prompt_ids=[3, 4], params=greedy())
    with pytest.raises(Exception):
        sched.add(fresh)
    moved = Sequence(prompt_ids=[5, 6], params=greedy())
    moved.migrate_count = 1
    sched.add(moved)
    assert moved in sched.waiting


def test_scheduler_evacuate_releases_without_settling():
    sched = _scheduler()
    sched.add(Sequence(prompt_ids=[1, 2, 3], params=greedy()))
    plan = sched.try_admit()
    seq = plan.seq
    assert seq.status is SeqStatus.RUNNING and seq.pages
    free_before = sched.allocator.num_free
    sched.evacuate(seq)
    assert sched.slots[plan.slot] is None
    assert sched.allocator.num_free > free_before
    assert not seq.done_event.is_set()
    assert sched.total_finished == 0 and sched.total_aborted == 0
    queued = Sequence(prompt_ids=[4, 5], params=greedy())
    sched.add(queued)
    sched.evacuate(queued)
    assert queued not in sched.waiting
    assert not queued.done_event.is_set()


# ------------------------------------------------- replay_into flavors


class _FakeReplayCore:
    def __init__(self, fail=False):
        self.fail = fail
        self.submitted = []
        self.ticks = []
        self.flight = SimpleNamespace(
            record_tick=lambda kind, **f: self.ticks.append((kind, f))
        )

    def submit_existing(self, seq):
        if self.fail:
            raise RuntimeError("refused")
        self.submitted.append(seq)


def _metric_value(counter):
    return counter._value.get()  # prometheus_client internal, test-only


def test_replay_into_migrate_kind_records_migrate_not_resume():
    core = _FakeReplayCore()
    seq = Sequence(prompt_ids=[1, 2], params=greedy())
    seq.prepare_migrate()
    before = _metric_value(metrics.RESUMED_SEQUENCES)
    outcome = replay_into(core, seq, set(), kind="migrate", reason="drain")
    assert outcome == "replayed"
    assert core.submitted == [seq]
    assert core.ticks and core.ticks[0][0] == "migrate"
    assert core.ticks[0][1]["reason"] == "drain"
    assert core.ticks[0][1]["attempt"] == 1
    assert _metric_value(metrics.RESUMED_SEQUENCES) == before


def test_replay_into_default_kind_still_counts_resume():
    core = _FakeReplayCore()
    seq = Sequence(prompt_ids=[1, 2], params=greedy())
    seq.prepare_resume()
    before = _metric_value(metrics.RESUMED_SEQUENCES)
    assert replay_into(core, seq, set()) == "replayed"
    assert core.ticks[0][0] == "resume"
    assert _metric_value(metrics.RESUMED_SEQUENCES) == before + 1


def test_replay_into_quarantine_applies_to_migration_too():
    core = _FakeReplayCore()
    seq = Sequence(prompt_ids=[1, 2], params=greedy())
    seq.prepare_migrate()
    fp = faults.fingerprint([1, 2])
    outcome = replay_into(core, seq, {fp}, kind="migrate")
    assert outcome == "quarantined"
    assert isinstance(seq.error, PoisonRequestError)


# ------------------------------------------- kv-dtype placement gate


def _bare_dp():
    return ReplicatedEngine.__new__(ReplicatedEngine)


def _fake_core(kv_dtype, fatal=None):
    return SimpleNamespace(
        _fatal=fatal,
        geometry=SimpleNamespace(kv_dtype=kv_dtype),
    )


@pytest.mark.parametrize("src,fleet", [("int8", "bf16"), ("bf16", "int8")])
def test_placement_refuses_a_source_into_another_kv_dtype(src, fleet):
    dp = _bare_dp()
    with pytest.raises(MigrationRefusedError) as exc:
        dp._check_placement(_fake_core(src), [_fake_core(fleet)])
    assert "kv-dtype mismatch" in str(exc.value)


def test_placement_filters_to_matching_dtype_targets():
    dp = _bare_dp()
    src = _fake_core("int8")
    match, mismatch = _fake_core("int8"), _fake_core("bf16")
    assert dp._check_placement(src, [mismatch, match]) == [match]


def test_placement_refuses_with_no_live_target():
    dp = _bare_dp()
    with pytest.raises(MigrationRefusedError) as exc:
        dp._check_placement(_fake_core("bf16"), [])
    assert "no eligible target" in str(exc.value)
    with pytest.raises(MigrationRefusedError):
        dp._check_placement(
            _fake_core("bf16"),
            [_fake_core("bf16", fatal=RuntimeError("dead"))],
        )


# ------------------------------------------------- rebalancing policy


HOT = {"kv_free_ratio": 0.05, "engine_queue_depth": 0}
IDLE = {"kv_free_ratio": 0.9, "engine_queue_depth": 0}
WARM = {"kv_free_ratio": 0.4, "engine_queue_depth": 1}


class _Policies:
    """The port's policy and the reference's on one fake clock: every
    ``observe`` feeds both the same signals and must decide alike."""

    def __init__(self, **overrides):
        self.clock = [0.0]
        tick = lambda: self.clock[0]  # noqa: E731
        self.port = RebalancePolicy(
            load_config(model={"model_id": "tiny-dense"},
                        migration=overrides).migration, clock=tick)
        self.ref = JRebalancePolicy(
            j_load_config(migration=overrides).migration, clock=tick)

    def at(self, t):
        self.clock[0] = float(t)
        return self

    def observe(self, signals):
        got = self.port.observe(signals)
        assert got == self.ref.observe(signals)
        return got

    def note_move_failed(self):
        self.port.note_move_failed()
        self.ref.note_move_failed()


def test_rebalance_policy_hysteresis_on_fake_clock():
    p = _Policies(rebalance_hold_s=10.0, rebalance_cooldown_s=30.0)
    sig = {0: HOT, 1: IDLE}
    assert p.at(0).observe(sig) is None
    assert p.at(9.9).observe(sig) is None
    assert p.at(10.1).observe(sig) == (0, 1)
    assert p.at(15.0).observe(sig) is None
    assert p.at(41.0).observe(sig) == (0, 1)


def test_rebalance_policy_never_flaps():
    p = _Policies(rebalance_hold_s=10.0, rebalance_cooldown_s=30.0)
    for t in range(0, 100, 5):
        sig = {0: HOT if (t // 5) % 2 == 0 else IDLE, 1: IDLE}
        assert p.at(t).observe(sig) is None


def test_rebalance_policy_requires_an_idle_target():
    p = _Policies(rebalance_hold_s=0.0)
    assert p.at(0).observe({0: HOT, 1: WARM}) is None
    assert p.at(1).observe({0: HOT, 1: IDLE}) == (0, 1)


def test_rebalance_policy_queue_depth_counts_as_hot():
    p = _Policies(rebalance_hold_s=0.0, hot_queue_depth=4)
    deep = {"kv_free_ratio": 0.8, "engine_queue_depth": 5}
    assert p.at(1).observe({0: deep, 1: IDLE}) == (0, 1)


def test_rebalance_policy_drops_state_for_absent_replicas():
    p = _Policies(rebalance_hold_s=10.0)
    p.at(0).observe({0: HOT, 1: IDLE})
    p.at(20).observe({1: IDLE})
    assert p.at(21).observe({0: HOT, 1: IDLE}) is None


def test_rebalance_failed_move_releases_cooldown():
    p = _Policies(rebalance_hold_s=10, rebalance_cooldown_s=300)
    decision = None
    for t in (6, 12, 18):
        decision = p.at(t).observe({0: HOT, 1: IDLE})
    assert decision == (0, 1)
    p.note_move_failed()
    assert p.at(24).observe({0: HOT, 1: IDLE}) == (0, 1)


# ------------------------------------------------- dp=1 refusal


def test_supervisor_refuses_evacuation():
    sup = EngineSupervisor.__new__(EngineSupervisor)
    with pytest.raises(MigrationRefusedError) as exc:
        sup.evacuate()
    assert "dp=1" in str(exc.value)


# --------------------------------------- evacuation command plumbing


def test_fail_pending_evacuations_unblocks_waiters():
    core = EngineCore.__new__(EngineCore)
    core._fatal = None
    core._evac_q = queue.Queue()
    core._wakeup = threading.Event()
    results = {}

    def call():
        try:
            core.evacuate(None, timeout=10.0)
        except RuntimeError as exc:
            results["error"] = exc

    t = threading.Thread(target=call)
    t.start()
    deadline = time.monotonic() + 5
    while core._evac_q.empty() and time.monotonic() < deadline:
        time.sleep(0.01)
    core._fail_pending_evacuations(RuntimeError("boom"))
    t.join(timeout=5)
    assert not t.is_alive()
    assert "unavailable for evacuation" in str(results["error"])


def test_merged_flight_records_pod_tick_once():
    from vgate_tpu_torch.observability.flight import FlightRecorder

    replicas = [SimpleNamespace(flight=FlightRecorder()) for _ in range(2)]
    merged = _MergedFlight(replicas)
    merged.record_tick("overload", level=3, prev=0)
    ticks = merged.ticks()
    assert [t["kind"] for t in ticks] == ["overload"]
    assert ticks[0]["level"] == 3
    assert ticks[0]["replica"] == 0
    assert merged.get_stats()["enabled"] is True
    assert len(merged.get_stats()["replicas"]) == 2


def test_evacuation_timeout_is_not_treated_as_replica_death():
    dp = _bare_dp()
    dp._mig = load_config(model={"model_id": "tiny-dense"}).migration

    class _TimingOutCore:
        _fatal = None

        def evacuate(self, seq_ids, reason, timeout):
            raise MigrationError("evacuation did not complete")

    with pytest.raises(MigrationError):
        dp._evacuate_all(_TimingOutCore(), "drain")


def test_cancelled_evacuation_is_never_executed():
    core = EngineCore.__new__(EngineCore)
    core._fatal = None
    core._evac_q = queue.Queue()
    core._wakeup = threading.Event()
    with pytest.raises(Exception) as exc:
        core.evacuate(None, timeout=0.05)
    assert "did not complete" in str(exc.value)
    assert core._evac_q.qsize() == 1
    core._process_evacuations()
    assert core._evac_q.qsize() == 0


def _placing_dp():
    dp = _bare_dp()
    dp.total_resumed = dp.total_migrated = dp.total_lost = 0
    dp.total_failovers = 0
    dp._quarantine = set()
    dp._recovery = SimpleNamespace(backoff_base_s=0.05, backoff_cap_s=0.2)
    dp._restart_times = []
    return dp


def _target(fatal=None):
    core = _FakeReplayCore()
    core._fatal = fatal
    core._running = True
    core.geometry = SimpleNamespace(kv_dtype=None)
    core.scheduler = SimpleNamespace(waiting=[], running=[])
    return core


def test_claim_dead_places_as_resume_not_migrate():
    dp = _placing_dp()
    target = _target()
    seq = Sequence(prompt_ids=[1, 2], params=greedy())
    seq.prepare_resume()
    moved, lost, _ = dp._place([seq], [target], "drain", 0, kind="resume")
    assert (moved, lost) == (1, 0)
    assert dp.total_resumed == 1
    assert dp.total_migrated == 0
    assert target.ticks[0][0] == "resume"


def test_rebalance_folds_victims_back_when_cold_dies():
    dp = _bare_dp()
    dp._mig = load_config(model={"model_id": "tiny-dense"}).migration
    dp.total_lost = 0
    dp._policy = RebalancePolicy(dp._mig)
    seq = Sequence(prompt_ids=[1, 2], params=greedy())
    seq.status = SeqStatus.RUNNING
    for t in range(dp._mig.min_generated_tokens):
        seq.append_token(t)
    hot = _target()
    hot.scheduler = SimpleNamespace(running=[seq], waiting=[])
    hot.evacuate = lambda ids, reason, timeout: [seq]
    cold = SimpleNamespace(
        _fatal=RuntimeError("died"),
        geometry=SimpleNamespace(kv_dtype=None),
    )
    assert dp._rebalance(hot, cold, 0) is None
    assert hot.submitted == [seq]
    assert dp.total_lost == 0
    assert not seq.done_event.is_set()
    assert dp._policy._last_move_t is None


# ------------------------------------- structural-op concurrency fixes


def test_alive_requires_running_loop():
    assert ReplicatedEngine._alive(SimpleNamespace(_fatal=None,
                                                   _running=True))
    assert not ReplicatedEngine._alive(SimpleNamespace(_fatal=None,
                                                       _running=False))
    assert not ReplicatedEngine._alive(
        SimpleNamespace(_fatal=RuntimeError("x"), _running=True))


def test_structural_ops_hold_the_lock_for_their_full_duration():
    for name in ("drain_replica", "undrain_replica", "add_replica",
                 "remove_replica"):
        assert hasattr(getattr(ReplicatedEngine, name), "__wrapped__")
    dp = _bare_dp()
    dp._structural_lock = threading.RLock()
    order = []

    @_structural
    def slow(self):
        order.append("slow-in")
        time.sleep(0.2)
        order.append("slow-out")

    @_structural
    def fast(self):
        order.append("fast-in")
        order.append("fast-out")

    t = threading.Thread(target=slow, args=(dp,))
    t.start()
    deadline = time.monotonic() + 2
    while "slow-in" not in order and time.monotonic() < deadline:
        time.sleep(0.005)
    fast(dp)
    t.join()
    assert order == ["slow-in", "slow-out", "fast-in", "fast-out"]


def test_health_gauge_counts_alive_draining_replica():
    dp = _bare_dp()
    dp._topology_lock = threading.RLock()
    dp.replicas = [SimpleNamespace(_fatal=None, _running=True)
                   for _ in range(2)]
    dp._draining = {0}
    dp._corrupt = set()
    dp._failover_enabled = True
    dp._restart_times = []
    dp._quarantine = set()
    dp._recovery = SimpleNamespace(restart_window_s=300.0, max_restarts=3)
    dp._integrity_cfg = SimpleNamespace(enabled=False)
    dp.total_failovers = dp.total_restarts = dp.total_stalls = 0
    dp.total_resumed = dp.total_migrated = dp.total_lost = 0
    h = dp.health()
    assert h["replicas_alive"] == 2
    assert h["replicas"][0]["state"] == "draining"
    assert h["state"] == "degraded"
    assert metrics.DP_REPLICAS_ALIVE._value.get() == 2


def test_place_folds_back_into_alive_source_when_targets_die():
    dp = _placing_dp()
    source = _target()
    dead_target = SimpleNamespace(
        _fatal=RuntimeError("died mid-drain"),
        _running=True,
        geometry=SimpleNamespace(kv_dtype=None),
    )
    seq = Sequence(prompt_ids=[1, 2], params=greedy())
    seq.prepare_migrate()
    moved, lost, requeued = dp._place(
        [seq], [dead_target], "drain", 0, fallback=source
    )
    assert (moved, lost, requeued) == (0, 0, 1)
    assert source.submitted == [seq]
    assert dp.total_lost == 0
    assert not seq.done_event.is_set()


def test_dead_source_gate_falls_back_when_listed_targets_are_dead():
    dp = _bare_dp()
    dp._topology_lock = threading.RLock()
    dead_src = SimpleNamespace(_fatal=RuntimeError("src"), _running=True)
    dead_sib = SimpleNamespace(_fatal=RuntimeError("sib"), _running=True)
    survivor = SimpleNamespace(_fatal=None, _running=True)
    dp.replicas = [dead_src, dead_sib, survivor]
    dp._draining = {2}
    calls = {}

    def fake_fallback(idx, core):
        calls["fallback"] = idx
        return [survivor]

    def fake_place(seqs, targets, reason, idx, kind, fallback=None):
        calls["targets"] = targets
        return 0, 0, 0

    dp._fallback_targets = fake_fallback
    dp._evacuate_all = lambda core, reason: ([], "resume")
    dp._place = fake_place
    dp._drain_and_place(0, "drain")
    assert calls["fallback"] == 0
    assert calls["targets"] == [survivor]


# --------------------------------- failover redistribution (test_resume)


def test_dp_redistribute_excludes_quarantined():
    """dp failover never hands a poison-quarantined request to a
    surviving replica, and the resume tick names the source replica."""
    eng = _placing_dp()
    survivor = _target()
    dead = SimpleNamespace(_fatal=RuntimeError("dead"))
    eng.replicas = [dead, survivor]
    eng._topology_lock = threading.RLock()
    eng._draining = set()
    eng._corrupt = set()
    poison_ids = [3, 1, 666, 4]
    eng._quarantine = {faults.fingerprint(poison_ids)}
    poison = Sequence(prompt_ids=list(poison_ids), params=greedy(8))
    innocent = Sequence(prompt_ids=[7, 8, 9], params=greedy(8))
    for s in (poison, innocent):
        s.prepare_resume()
    eng._redistribute(0, [poison, innocent])
    assert survivor.submitted == [innocent]
    assert isinstance(poison.error, PoisonRequestError)
    assert eng.total_lost == 1 and eng.total_resumed == 1
    assert survivor.ticks[0][1]["from_replica"] == 0
