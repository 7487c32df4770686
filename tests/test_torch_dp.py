"""The port's data-parallel engine against the reference's, on the CPU.

``vgate_tpu_torch/runtime/dp_engine.py`` ``ReplicatedEngine`` at dp=2
beside ``vgate_tpu/runtime/dp_engine.py``'s at dp=2 (two forced host
devices), one weight tree in both (the reference's seed-0 ``tiny-dense``
init, carried over with ``params_from_jax``).  No engine thread runs:
each replica's ``start`` only marks it running, and the test drives
every replica's ``_tick`` itself (the reference's inside
``private_uploads``), so both routers see the same loads at every
submission and a wave admits the same way in both packages.  An
operation that blocks on an engine thread (a drain's evacuation, a
rebalance) runs on a helper thread while the test ticks.

The cases of tests/test_dp_engine.py and the dp failover of
tests/test_resume.py: routing (the same replica for each request),
greedy identity with dp=1 and with the reference at dp=2, the stats
aggregate, prefix affinity, a drain with live migration then elastic
remove and add, a rebalance, routing around a dead replica, a crash's
failover and repair; then the backend at dp=2, the host swap tier under
dp, and the hazards of several cores in one process: a sibling's
teardown leaves cuBLAS's workspaces alone, launch counts add up over two
threads while one captures, and the collector stays off until the last
capture ends.
"""

import gc
import threading
import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from tests.reference_uploads import private_uploads
from vgate_tpu import faults as j_faults
from vgate_tpu.backends.base import SamplingParams as JSamplingParams
from vgate_tpu.config import load_config as j_load_config
from vgate_tpu.runtime.dp_engine import ReplicatedEngine as JReplicated
from vgate_tpu.runtime.engine_core import EngineCore as JEngineCore
from vgate_tpu.runtime.weights import load_or_init_params as j_init
from vgate_tpu_torch import config as config_mod
from vgate_tpu_torch import faults
from vgate_tpu_torch.backends.base import SamplingParams
from vgate_tpu_torch.config import load_config
from vgate_tpu_torch.models.specs import TINY_DENSE
from vgate_tpu_torch.ops.kernels import _build
from vgate_tpu_torch.ops.kernels.flash_prefill import flash_prefill_attention
from vgate_tpu_torch.ops.kernels.paged_decode import paged_decode_attention
from vgate_tpu_torch.runtime import engine_core as port_engine_core
from vgate_tpu_torch.runtime.decode_graph import DecodeGraphs
from vgate_tpu_torch.runtime.dp_engine import ReplicatedEngine
from vgate_tpu_torch.runtime.engine_core import EngineCore
from vgate_tpu_torch.runtime.weights import params_from_jax

MODEL = {"model_id": "tiny-dense", "dtype": "float32", "max_model_len": 64}
SHAPES = {"kv_num_pages": 64, "kv_page_size": 4, "max_batch_slots": 4,
          "prefill_buckets": [8, 16, 32], "prefix_cache": False}
TREE = j_init(TINY_DENSE, None, np.float32)
# the engine thread's start, which ``driven`` replaces while the module's
# driven engines live
THREADED_START = EngineCore.start


@pytest.fixture(scope="module")
def driven():
    """Both packages' cores start no thread, and the port's cores load
    the reference's tree."""
    patch = pytest.MonkeyPatch()
    mark = lambda self: setattr(self, "_running", True)  # noqa: E731
    patch.setattr(JEngineCore, "start", mark)
    patch.setattr(EngineCore, "start", mark)

    def port_load(spec, checkpoint_path, device, dtype, seed=0,
                  log_digests=False, quantization=None):
        return params_from_jax(jax.tree.map(np.asarray, TREE), TINY_DENSE)

    patch.setattr(port_engine_core, "load_or_init_params", port_load)
    yield
    patch.undo()


@pytest.fixture(autouse=True)
def _reset_port_state():
    config_mod.reset_config()
    faults.reset()
    yield
    faults.reset()
    j_faults.reset()
    config_mod.reset_config()


def _configs(dp=2, recovery=None, migration=None, **shapes):
    shapes = {**SHAPES, **shapes}
    common = dict(scheduler={"max_queue_size": 16},
                  recovery={"backoff_base_s": 0.0, "backoff_cap_s": 0.0,
                            **(recovery or {})},
                  migration=migration or {}, integrity={"enabled": False},
                  logging={"level": "ERROR"})
    j_cfg = j_load_config(
        model={**MODEL, "engine_type": "jax_tpu"},
        tpu={"dp": dp, "tp": 1, "ep": 1, "sp": 1, "num_devices": dp,
             "use_pallas": False, **shapes}, **common)
    t_cfg = load_config(model=MODEL, device={"device": "cpu", "dp": dp,
                                             **shapes}, **common)
    return j_cfg, t_cfg


class Engines:
    """The reference's dp engine ("jax") and the port's ("port") on one
    tree; ``wave`` submits the same requests to both and ticks them to
    the end, then checks equal streams and equal routing."""

    def __init__(self, dp=2, **kw):
        j_cfg, t_cfg = _configs(dp, **kw)
        self.e = {"jax": JReplicated(j_cfg, devices=jax.devices()[:dp]),
                  "port": ReplicatedEngine(t_cfg)}
        self.routes = {"jax": [], "port": []}
        for name, eng in self.e.items():
            for core in eng.replicas:
                core.start()
            real = eng._pick_replica

            def pick(prompt_ids=None, real=real, eng=eng, name=name):
                core = real(prompt_ids)
                self.routes[name].append(eng.replicas.index(core))
                return core

            eng._pick_replica = pick

    @staticmethod
    def tick(name, eng):
        """One tick of every live replica, between the perf recorder's
        marks as each engine loop sets them."""
        for core in list(eng.replicas):
            if core._running and core._fatal is None:
                core.perf.tick_begin()
                if name == "jax":
                    with private_uploads():
                        worked = core._tick()
                else:
                    worked = core._tick()
                core.perf.tick_end(worked)

    def drive(self, name, until, limit=20_000):
        for _ in range(limit):
            if until():
                return
            self.tick(name, self.e[name])
        raise AssertionError(f"{name}: the engines did not get there")

    def submit(self, name, prompts, max_tokens=8, min_tokens=0):
        sp = JSamplingParams if name == "jax" else SamplingParams
        params = sp(max_tokens=max_tokens, min_tokens=min_tokens,
                    temperature=0.0)
        return [self.e[name].submit_tokens(list(p), params)
                for p in prompts]

    def wave(self, prompts, max_tokens=8):
        out = {}
        for name in self.e:
            start = len(self.routes[name])
            seqs = self.submit(name, prompts, max_tokens)
            self.drive(name, lambda: all(s.done_event.is_set()
                                         for s in seqs))
            assert all(s.status.value == "finished" for s in seqs), (
                name, [(s.status, s.error) for s in seqs])
            out[name] = ([list(s.generated_ids) for s in seqs],
                         self.routes[name][start:])
        assert out["port"] == out["jax"]
        return out["port"]

    def while_ticking(self, name, fn):
        """``fn()`` on a helper thread while this thread ticks ``name``'s
        replicas (an evacuation waits for an engine tick)."""
        box = {}

        def run():
            try:
                box["out"] = fn()
            except BaseException as exc:  # re-raised on the test thread
                box["err"] = exc

        thread = threading.Thread(target=run)
        thread.start()
        while thread.is_alive():
            self.tick(name, self.e[name])
            thread.join(timeout=0.001)
        if "err" in box:
            raise box["err"]
        return box["out"]

    def stop(self):
        for eng in self.e.values():
            eng.stop()


def _prompts(seed, n, lo=5, hi=12):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, TINY_DENSE.vocab_size,
                         size=int(rng.integers(lo, hi))).tolist()
            for _ in range(n)]


@pytest.fixture(scope="module")
def pair(driven):
    engines = Engines()
    yield engines
    engines.stop()


# ----------------------------------------------------------- routing


def test_dp_engine_builds_one_device_replicas(pair):
    eng = pair.e["port"]
    assert len(eng.replicas) == 2
    assert eng.replicas[0] is not eng.replicas[1]
    assert eng.replicas[0].k_pages is not eng.replicas[1].k_pages
    for core in eng.replicas:
        assert core.mesh.shape["dp"] == 1 and core.mesh.num_devices == 1
        assert core.config.device.dp == 1 and core.shared_process
    assert eng._device_slices == [["cpu"], ["cpu"]]


def test_dp_routing_spreads_load_as_the_reference(pair):
    """Unrelated requests spread over both replicas, each request on
    the replica the reference's router picks, the streams equal."""
    streams, routes = pair.wave(_prompts(1, 6))
    assert sorted(set(routes)) == [0, 1]
    assert all(len(s) == 8 for s in streams)
    assert all(core.get_stats()["prefills"] > 0
               for core in pair.e["port"].replicas)


def test_dp_matches_single_engine_greedy(pair, driven):
    """Greedy output is replica-independent: one prompt four times over
    both replicas, and a dp=1 port engine, repeat the same stream."""
    prompt = _prompts(2, 1)[0]
    streams, routes = pair.wave([prompt] * 4)
    assert set(routes) == {0, 1}
    assert all(s == streams[0] for s in streams)
    _, t_cfg = _configs(dp=1)
    single = EngineCore(t_cfg)
    seq = single.submit_tokens(prompt, SamplingParams(max_tokens=8,
                                                      temperature=0.0))
    while not seq.done_event.is_set():
        single._tick()
    assert list(seq.generated_ids) == streams[0]
    single.stop()


def test_dp_stats_aggregate(pair):
    pair.wave(_prompts(3, 4))
    eng = pair.e["port"]
    stats = eng.get_stats()
    assert stats["dp"] == 2 and len(stats["replicas"]) == 2
    for key in ("prefills", "steps", "decode_tokens", "kv_pages_total"):
        assert stats[key] == sum(r[key] for r in stats["replicas"])
    assert stats["scheduler"]["admitted"] == sum(
        r["scheduler"]["admitted"] for r in stats["replicas"])
    assert stats["mesh"]["dp"] == 2
    assert stats["perf"]["enabled"] is True
    assert stats["perf"]["ticks"] == sum(r["perf"]["ticks"]
                                         for r in stats["replicas"])
    snap = eng.perf_snapshot()
    assert [r["replica"] for r in snap["replicas"]] == [0, 1]
    assert snap["totals"]["tokens"] > 0
    health = eng.device_health()
    assert health["alive"] is True and health["replicas"] == 2
    # the same keys as the reference's aggregate
    ref = pair.e["jax"].get_stats()
    assert set(ref) - {"mesh"} <= set(stats)
    assert stats["migration"] == ref["migration"]
    assert stats["failover"] == ref["failover"]


def test_dp_prefix_affinity_routing(driven):
    """Requests sharing a first page stick to one replica, whose private
    prefix cache the later ones hit; the same replica and the same hits
    as the reference."""
    engines = Engines(prefix_cache=True)
    try:
        shared = list(range(10, 26))
        admitted = {}
        for name, eng in engines.e.items():
            for i in range(4):
                [seq] = engines.submit(name, [shared + [100 + i]], 2)
                engines.drive(name, seq.done_event.is_set)
            admitted[name] = (
                [c.scheduler.total_admitted for c in eng.replicas],
                [c.scheduler.total_prefix_hit_tokens for c in eng.replicas],
            )
        assert admitted["port"] == admitted["jax"]
        assert sorted(admitted["port"][0]) == [0, 4]
        assert max(admitted["port"][1]) > 0
        assert len(set(engines.routes["port"])) == 1
    finally:
        engines.stop()


# --------------------------------------------------- planned migration


def test_dp_drain_live_migrates_then_elastic_remove_add(driven):
    """Drain replica 0 mid-decode: its resident moves to replica 1 with
    no failure (migrate_count 1, resume_count 0), the completion equals
    the reference's and an undisturbed run's; health is degraded with
    the drain's detail until undrain; then remove replica 0 (its
    resident migrates, its slice is banked) and add it back."""
    engines = Engines()
    try:
        prompt, mover_prompt = list(range(1, 9)), list(range(11, 19))
        streams = {}
        for name, eng in engines.e.items():
            sp = JSamplingParams if name == "jax" else SamplingParams
            long = sp(max_tokens=40, min_tokens=40, temperature=0.0)
            seq = eng.replicas[0].submit_tokens(prompt, long)
            engines.drive(name, lambda: seq.num_generated >= 4)
            out = engines.while_ticking(name,
                                        lambda: eng.drain_replica(0))
            assert out["migrated"] >= 1 and out["lost"] == 0, out
            engines.drive(name, seq.done_event.is_set)
            assert seq.status.value == "finished", seq.error
            assert (seq.migrate_count, seq.resume_count) == (1, 0)
            assert seq.resume_metrics() == {"migrated": 1.0}
            assert eng.replicas[1].scheduler.total_finished >= 1
            health = eng.health()
            assert health["state"] == "degraded"
            assert health["draining"] == [0]
            assert health["replicas"][0]["state"] == "draining"
            assert eng.get_stats()["migration"]["migrated"] >= 1
            ref = eng.replicas[1].submit_tokens(prompt, long)
            engines.drive(name, ref.done_event.is_set)
            assert list(ref.generated_ids) == list(seq.generated_ids)
            # new placements route around the draining replica
            [probe] = engines.submit(name, [[7, 7, 7]], 2)
            engines.drive(name, probe.done_event.is_set)
            assert eng.replicas[0].scheduler.total_admitted == 1
            eng.undrain_replica(0)
            assert eng.health()["state"] == "serving"
            mover = eng.replicas[0].submit_tokens(mover_prompt, long)
            engines.drive(name, lambda: mover.num_generated >= 4)
            removed = engines.while_ticking(name,
                                            lambda: eng.remove_replica(0))
            assert removed["dp"] == 1 and removed["migrated"] >= 1
            engines.drive(name, mover.done_event.is_set)
            assert mover.status.value == "finished", mover.error
            assert mover.migrate_count == 1
            assert len(eng.replicas) == 1
            assert eng.get_stats()["migration"]["free_slices"] == 1
            added = eng.add_replica()
            assert added["dp"] == 2 and len(eng.replicas) == 2
            assert eng.health()["state"] == "serving"
            [tail] = engines.submit(name, [[9, 8, 7, 6]], 2)
            engines.drive(name, tail.done_event.is_set)
            assert tail.status.value == "finished", tail.error
            streams[name] = [list(seq.generated_ids),
                             list(mover.generated_ids),
                             list(tail.generated_ids)]
        assert streams["port"] == streams["jax"]
    finally:
        engines.stop()


def test_dp_rebalance_moves_long_decode_off_pressured_replica(driven):
    """The policy moves the resident decode off a pressured replica to
    an idle sibling with no error, the cooldown holds the next tick, and
    the moved stream equals the reference's."""
    engines = Engines(migration={"rebalance_hold_s": 0.0,
                                 "rebalance_cooldown_s": 3600.0})
    try:
        streams = {}
        for name, eng in engines.e.items():
            eng.replicas[0].pressure_signals = lambda: {
                "kv_free_ratio": 0.02, "engine_queue_depth": 0}
            eng.replicas[1].pressure_signals = lambda: {
                "kv_free_ratio": 0.95, "engine_queue_depth": 0}
            sp = JSamplingParams if name == "jax" else SamplingParams
            seq = eng.replicas[0].submit_tokens(
                list(range(21, 29)),
                sp(max_tokens=40, min_tokens=40, temperature=0.0))
            engines.drive(name, lambda: seq.num_generated >= 10)
            moved = engines.while_ticking(name, eng.maybe_rebalance)
            assert moved is not None and moved["moved"] == 1, moved
            assert moved["lost"] == 0
            assert eng.maybe_rebalance() is None
            engines.drive(name, seq.done_event.is_set)
            assert seq.status.value == "finished", seq.error
            assert seq.migrate_count == 1
            assert eng.replicas[1].scheduler.total_finished >= 1
            assert eng.total_migrated == 1
            streams[name] = list(seq.generated_ids)
        assert streams["port"] == streams["jax"]
    finally:
        engines.stop()


# ------------------------------------------------- failure containment


def test_dp_routes_around_dead_replica(driven):
    """With repair off, requests ride the surviving replica; the device
    health is degraded but serving-capable, all-dead surfaces the
    fatal."""
    engines = Engines(recovery={"enabled": False})
    try:
        eng = engines.e["port"]
        eng.replicas[0]._fatal = RuntimeError("injected device loss")
        seqs = engines.submit("port", [[20 + i, 7, 9, 11, 13]
                                       for i in range(4)], 3)
        engines.drive("port", lambda: all(s.done_event.is_set()
                                          for s in seqs))
        assert all(s.num_output_tokens == 3 for s in seqs)
        assert eng.replicas[1].scheduler.total_admitted >= 4
        health = eng.device_health()
        assert health["alive"] and health["replicas_alive"] == 1
        eng.replicas[1]._fatal = RuntimeError("second loss")
        with pytest.raises(RuntimeError, match="engine is dead"):
            eng.submit_tokens([1, 2, 3, 4], SamplingParams(max_tokens=2))
        assert not eng.device_health()["alive"]
    finally:
        for core in engines.e["port"].replicas:
            core._fatal = None
        engines.stop()


def test_dp_failover_redistributes_and_recovers(driven):
    """A decode fault on replica 1: containment checkpoints its
    residents, the repair sweep replays them on replica 0 and rebuilds
    replica 1 (weights kept); health is degraded, then serving; every
    stream equals the undisturbed run's and the reference's."""
    engines = Engines()
    try:
        prompts = _prompts(5, 4)
        streams = {}
        for name, eng in engines.e.items():
            fmod = j_faults if name == "jax" else faults
            clean = engines.submit(name, prompts, 12)
            engines.drive(name, lambda: all(s.done_event.is_set()
                                            for s in clean))
            seqs = engines.submit(name, prompts, 12)
            engines.drive(name, lambda: all(s.num_generated >= 2
                                            for s in seqs))
            victim = eng.replicas[1]
            assert victim.scheduler.running
            fmod.arm("decode_step", mode="raise", times=1)
            try:
                for _ in range(100):
                    victim._tick()
            except fmod.InjectedFault as exc:
                victim._contain_fatal(exc)
            assert victim._fatal is not None
            assert eng.health()["state"] == "degraded"
            eng._sweep()  # redistribute; the rebuild is scheduled
            assert eng.total_failovers == 1 and eng.total_resumed >= 1
            eng._sweep()  # the backoff (0 s) is due: rebuild
            for thread in list(eng._rebuild_threads.values()):
                thread.join(timeout=120)
            assert eng.replicas[1] is not victim
            engines.drive(name, lambda: all(s.done_event.is_set()
                                            for s in seqs))
            assert all(s.status.value == "finished" for s in seqs), (
                name, [(s.status, s.error) for s in seqs])
            assert [s.generated_ids for s in seqs] == [
                s.generated_ids for s in clean]
            health = eng.health()
            assert health["state"] == "serving"
            assert (health["restarts"], health["lost"]) == (1, 0)
            assert health["replicas_alive"] == 2
            streams[name] = [list(s.generated_ids) for s in seqs]
        assert streams["port"] == streams["jax"]
    finally:
        engines.stop()


def test_dp_failover_with_the_prefix_cache_leaves_no_page_in_use(driven):
    """The same crash with the prefix cache on (the card's
    configuration): the resumed sequences carry no radix-tree lock of
    the dead replica into the survivor, whose pool settles with no page
    in use (the reference's survivor unlocks the dead tree's locks as
    its own and counts more free pages than it has); the resumed streams
    equal the undisturbed run's."""
    engines = Engines(prefix_cache=True)
    try:
        eng = engines.e["port"]
        shared = list(range(10, 30))
        prompts = [shared + p for p in _prompts(6, 4, 3, 6)]
        clean = engines.submit("port", prompts, 12)
        engines.drive("port", lambda: all(s.done_event.is_set()
                                          for s in clean))
        victim = eng.replicas[engines.routes["port"][-1]]
        seqs = [victim.submit_tokens(p, SamplingParams(max_tokens=12,
                                                       temperature=0.0))
                for p in prompts]
        engines.drive("port", lambda: all(s.num_generated >= 2
                                          for s in seqs))
        faults.arm("decode_step", mode="raise", times=1)
        try:
            for _ in range(100):
                victim._tick()
        except faults.InjectedFault as exc:
            victim._contain_fatal(exc)
        eng._sweep()
        eng._sweep()
        for thread in list(eng._rebuild_threads.values()):
            thread.join(timeout=120)
        engines.drive("port", lambda: all(s.done_event.is_set()
                                          for s in seqs))
        assert [s.generated_ids for s in seqs] == [s.generated_ids
                                                   for s in clean]
        assert eng.total_resumed == len(seqs)
        for core in eng.replicas:
            stats = core.get_stats()
            assert stats["used_pages"] == 0 and stats["running"] == 0
    finally:
        engines.stop()


# -------------------------------------------------- backend, host swap


def test_dp_backend_integration(monkeypatch):
    """TorchCUDABackend builds the replicated engine at dp > 1
    (unsupervised), and its engine threads serve a batch."""
    from vgate_tpu_torch.backends.torch_backend import TorchCUDABackend

    monkeypatch.setattr(EngineCore, "start", THREADED_START)

    _, cfg = _configs()
    backend = TorchCUDABackend()
    backend.load_model(cfg)
    try:
        assert isinstance(backend.core, ReplicatedEngine)
        results = backend.generate(["backend dp", "another one"],
                                   [SamplingParams(max_tokens=4)] * 2)
        assert all(r.num_tokens >= 1 for r in results)
        assert backend.serving_health()["dp"] == 2
    finally:
        backend.shutdown()


def test_dp_composes_with_the_host_swap_tier(driven):
    """Each replica owns its host swap tier beside its pool."""
    _, cfg = _configs(kv_num_pages=16)
    cfg.kv_cache.host_swap_bytes = 1 << 20
    eng = ReplicatedEngine(cfg)
    try:
        for core in eng.replicas:
            core.start()
        tiers = [core.kv_swap for core in eng.replicas]
        assert all(t is not None for t in tiers) and tiers[0] is not tiers[1]
        assert eng.pressure_signals()["kv_swap_enabled"] is True
        assert eng.get_stats()["kv_swap"]["budget_bytes"] == 2 << 20
    finally:
        eng.stop()


# ------------------------------------ several cores in one process


def test_a_siblings_teardown_leaves_cublas_workspaces_alone(monkeypatch):
    """cuBLAS's workspaces are process-wide and a live core's graphs
    bake them in: releasing one of two card cores' device state must
    not clear them, releasing the last one must (as a lone core's
    rebuild always did), and the survivor's pools and graphs stay."""
    cleared = []
    monkeypatch.setattr(torch._C, "_cuda_clearCublasWorkspaces",
                        lambda: cleared.append(1), raising=False)
    class Core(SimpleNamespace):
        __hash__ = object.__hash__

    cores = []
    for _ in range(2):
        core = Core(
            stream=object(), _graphs=None, k_pages="k", v_pages="v",
            _dec_state="state", _pending_chunks=[], _spec_pen=None,
            _spec_mt=None, draft_model=None, _ngram_drafter=None,
            kv_swap=None, scheduler=SimpleNamespace(swap=None),
            radix_cache=None, device=torch.device("cpu"),
        )
        cores.append(core)
    monkeypatch.setattr(port_engine_core, "_card_cores", set(cores))
    port_engine_core._release_device_state(cores[1])
    assert cleared == []
    assert (cores[0].k_pages, cores[0]._dec_state) == ("k", "state")
    assert cores[1].k_pages is None
    port_engine_core._release_device_state(cores[0])
    assert cleared == [1]


class _StandIn:
    """A capture object as ``DecodeGraphs`` sees one, on the CPU: the
    warm-up and the capture run the body; ``hold`` makes the capture
    wait on an event (so another thread's work falls inside it)."""

    def __init__(self, inside=None, release=None):
        self.inside = inside or threading.Event()
        self.release = release

    def warmup(self, fn):
        fn()

    def capture(self, fn):
        fn()
        self.inside.set()
        if self.release is not None:
            assert self.release.wait(10)
        return SimpleNamespace(replay=lambda: None)

    def pool_bytes(self):
        return 0


def test_launch_counts_add_up_over_two_threads_while_one_captures():
    """A core captures (its step counts K1 twice) while another core's
    thread serves prompt passes (K2 once each): the capture's and its
    warm-up's launches go to the capturing thread's tally, the other
    thread's reach K2's count, and each replay adds the capture's."""
    k1, k2 = paged_decode_attention.launches, flash_prefill_attention.launches
    inside, release = threading.Event(), threading.Event()
    graphs = DecodeGraphs(_StandIn(inside, release))

    def body():
        _build.count_launch(paged_decode_attention, 2)

    capturer = threading.Thread(
        target=lambda: graphs.run(("a",), body, body))
    capturer.start()
    assert inside.wait(10)
    for _ in range(50):
        _build.count_launch(flash_prefill_attention)
    release.set()
    capturer.join(10)
    for _ in range(3):
        graphs.run(("a",), body, body)
    assert flash_prefill_attention.launches - k2 == 50
    assert paged_decode_attention.launches - k1 == 2 * 4
    paged_decode_attention.launches, flash_prefill_attention.launches = k1, k2


def test_collection_stays_off_until_the_last_capture_ends():
    """Two cores capture at once: the first capture to end must not turn
    the collector back on inside the other's."""
    assert gc.isenabled()
    starts = [threading.Event(), threading.Event()]
    ends = [threading.Event(), threading.Event()]

    def capture(i):
        DecodeGraphs(_StandIn(starts[i], ends[i])).run(
            (i,), lambda: None, lambda: None)

    threads = [threading.Thread(target=capture, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    assert all(e.wait(10) for e in starts)
    assert not gc.isenabled()
    ends[0].set()
    threads[0].join(10)
    assert not gc.isenabled()
    ends[1].set()
    threads[1].join(10)
    assert gc.isenabled()
