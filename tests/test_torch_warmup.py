"""``EngineCore.warmup``: the port's walk against the JAX engine's.

The walk is recorded by replacing ``submit_tokens`` on each engine with
a recorder whose sequences are already done: every submission (tokens,
``max_tokens``, temperature) and every wait lands in one log, so a burst
shows as submissions with no wait between them.  The two logs must be
equal.  A real warm-up on the port then leaves the engine idle, in the
run state it found.
"""

import numpy as np
import pytest

import jax

from vgate_tpu.config import load_config as j_load_config
from vgate_tpu.runtime.engine_core import EngineCore as JEngineCore
from vgate_tpu.runtime.weights import load_or_init_params as j_init
from vgate_tpu_torch.config import load_config
from vgate_tpu_torch.models.specs import TINY_DENSE
from vgate_tpu_torch.runtime.engine_core import EngineCore
from vgate_tpu_torch.runtime.weights import params_from_jax

MODEL = {"model_id": "tiny-dense", "dtype": "float32", "max_model_len": 64}
SHAPES = {"kv_num_pages": 64, "kv_page_size": 4, "max_batch_slots": 4,
          "prefill_buckets": [8, 16, 32], "decode_chunk": 4}


class _Done:
    def __init__(self, log):
        self.log = log

    def wait(self, timeout=None):
        self.log.append("wait")
        return True


class _Seq:
    def __init__(self, log):
        self.done_event = _Done(log)


def walk(core, buckets):
    """The warm-up's submissions and waits, with the engine's own
    submission replaced by the recorder."""
    log = []

    def submit_tokens(tokens, params, *args, **kwargs):
        log.append((tuple(tokens), params.max_tokens, params.temperature))
        return _Seq(log)

    core.submit_tokens = submit_tokens
    try:
        core.warmup(buckets)
    finally:
        del core.submit_tokens
    return log


def configs(shapes):
    shapes = {**SHAPES, **shapes}
    j_cfg = j_load_config(
        model={**MODEL, "engine_type": "jax_tpu"},
        tpu={"dp": 1, "tp": 1, "ep": 1, "sp": 1, "use_pallas": False,
             **shapes},
        integrity={"enabled": False},
        logging={"level": "ERROR"},
    )
    t_cfg = load_config(
        model={**MODEL, "engine_type": "torch_cuda"},
        device={"device": "cpu", **shapes},
        logging={"level": "ERROR"},
    )
    return j_cfg, t_cfg


@pytest.mark.parametrize(
    "shapes, buckets",
    [
        ({}, None),
        ({}, [8, 16, 32]),
        ({"prefill_chunk": 8}, None),
        ({"prefill_chunk": 16, "prefill_batch_max": 2}, [8, 16]),
        ({"prefill_batch_max": 16, "max_batch_slots": 2,
          "decode_chunk": 1}, [16]),
    ],
    ids=["default", "three-buckets", "chunked", "chunked-two-buckets",
         "ladder-capped-by-slots"],
)
def test_warmup_submits_the_reference_walk(shapes, buckets):
    j_cfg, t_cfg = configs(shapes)
    jparams = j_init(TINY_DENSE, None, np.float32)
    j = JEngineCore(j_cfg, params=jparams, devices=jax.devices()[:1])
    t = EngineCore(t_cfg, params=params_from_jax(
        jax.tree.map(np.asarray, jparams), TINY_DENSE))
    try:
        expect = walk(j, buckets)
        got = walk(t, buckets)
    finally:
        j.stop()
        t.stop()
    assert got == expect
    assert got.count("wait") >= 2
    assert not t._running and not j._running


@pytest.mark.parametrize("running", [False, True],
                         ids=["stopped", "running"])
@pytest.mark.parametrize("prefill_chunk", [0, 8])
def test_warmup_leaves_the_engine_idle_in_its_run_state(running,
                                                        prefill_chunk):
    _, cfg = configs({"prefill_chunk": prefill_chunk})
    core = EngineCore(cfg)
    if running:
        core.start()
    try:
        seconds = core.warmup()
        assert seconds > 0
        assert core._running is running
        assert (core._thread is not None) is running
        stats = core.get_stats()
        assert stats["running"] == 0
        assert stats["scheduler"]["waiting"] == 0
        assert stats["used_pages"] == 0
        assert core._submit_q.empty()
        # the decode ladder ran: 2 * decode_chunk tokens, greedy and
        # sampled, and every prefill group of the first bucket
        assert stats["finished"] == stats["admitted"] >= 2 + 2
        assert stats["chunks"] >= 2
        if prefill_chunk:
            assert stats["prefix_cache"]["chunked_prefills"] == 1
    finally:
        core.stop()
