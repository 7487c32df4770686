"""The host-RAM KV swap tier on the port against the JAX engine.

* The executor (``engine_core._DeviceSwapExecutor``): a page round trip
  through host memory is bit-exact for f32, bf16 and int8 pools with
  their scales, across a chunk boundary, and writes the pools in place.
* Engines, with ticks driven by the test: under a squeezed pool the
  port with swap on resumes every preempted sequence by swap-in with
  zero recompute and the tokens of an unpressured JAX engine; the port
  with swap off recomputes, with the same tokens.  Radix demotion and
  promotion through the real executor give the JAX engine's tokens and
  page counts.
* The outward hooks: ``pressure_signals`` carries the reference's keys,
  and brownout L4 suspends demotions.
"""

import types

import numpy as np
import pytest
import torch

import jax

from vgate_tpu.backends.base import SamplingParams as JSamplingParams
from vgate_tpu.config import load_config as j_load_config
from vgate_tpu.runtime.engine_core import EngineCore as JEngineCore
from vgate_tpu.runtime.weights import load_or_init_params as j_init
from vgate_tpu_torch.backends.base import SamplingParams
from vgate_tpu_torch.config import load_config
from vgate_tpu_torch.models.specs import TINY_DENSE
from vgate_tpu_torch.ops.kv_quant import QuantPages
from vgate_tpu_torch.runtime.engine_core import (
    SWAP_CHUNK_PAGES,
    EngineCore,
    _DeviceSwapExecutor,
)
from vgate_tpu_torch.runtime.kv_cache import KVGeometry, make_kv_buffers
from vgate_tpu_torch.runtime.weights import params_from_jax

PS = 4


# ------------------------------------------------------------- executor


def random_pools(kv_dtype, num_pages=40, seed=0):
    """K and V pools of 2 layers, 2 heads, pages of 4 x 8, filled with
    random content (int8 pools with random data and scales)."""
    geometry = KVGeometry(
        num_layers=2, num_pages=num_pages, page_size=PS, kv_heads=2,
        head_dim=8, max_model_len=64, dtype_bytes=1 if kv_dtype == "int8"
        else torch.tensor([], dtype=kv_dtype).element_size(),
        scale_bytes=2 if kv_dtype == "int8" else 0,
        kv_dtype="int8" if kv_dtype == "int8" else "x",
    )
    gen = torch.Generator().manual_seed(seed)
    pools = make_kv_buffers(
        geometry, torch.int8 if kv_dtype == "int8" else kv_dtype,
        torch.device("cpu"),
    )
    for pool in pools:
        if isinstance(pool, QuantPages):
            pool.data.copy_(torch.randint(-127, 128, pool.data.shape,
                                          generator=gen))
            pool.scale.copy_(torch.rand(pool.scale.shape, generator=gen))
        else:
            pool.copy_(torch.randn(pool.shape, generator=gen))
    return pools


def bits(t):
    """The bytes of ``t``, for bit-for-bit comparisons."""
    return t.contiguous().view(torch.uint8)


def tensors(pool):
    return [pool.data, pool.scale] if isinstance(pool, QuantPages) \
        else [pool]


@pytest.mark.parametrize("n", [1, SWAP_CHUNK_PAGES, SWAP_CHUNK_PAGES + 1])
@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16, "int8"],
                         ids=["f32", "bf16", "int8"])
def test_executor_round_trip_is_bit_exact(kv_dtype, n):
    k, v = random_pools(kv_dtype)
    core = types.SimpleNamespace(k_pages=k, v_pages=v,
                                 device=torch.device("cpu"))
    ex = _DeviceSwapExecutor(core)
    before = [t.clone() for pool in (k, v) for t in tensors(pool)]
    ptrs = [t.data_ptr() for pool in (k, v) for t in tensors(pool)]
    src = list(range(1, 1 + n))
    dst = list(range(39, 39 - n, -1))  # other pages, in another order
    payload = ex.read_pages(src)
    assert len(payload) == -(-n // SWAP_CHUNK_PAGES)
    # the pages are overwritten before the swap-in, as a reused page is
    for t in (t for pool in (k, v) for t in tensors(pool)):
        t[:, :, src] = 0
    ex.write_pages(dst, payload)
    after = [t for pool in (k, v) for t in tensors(pool)]
    assert [t.data_ptr() for t in after] == ptrs
    untouched = sorted(set(range(40)) - set(src) - set(dst))
    for old, new in zip(before, after):
        assert torch.equal(bits(new[:, :, dst]), bits(old[:, :, src]))
        assert torch.equal(bits(new[:, :, untouched]),
                           bits(old[:, :, untouched]))


def test_executor_refuses_a_payload_that_does_not_fit():
    k, v = random_pools(torch.float32)
    ex = _DeviceSwapExecutor(types.SimpleNamespace(
        k_pages=k, v_pages=v, device=torch.device("cpu")))
    payload = ex.read_pages([1, 2, 3])
    with pytest.raises(ValueError, match="does not fit"):
        ex.write_pages([4, 5], payload)


# -------------------------------------------------------------- engines

MODEL = {"model_id": "tiny-dense", "dtype": "float32", "max_model_len": 96}


def shapes(num_pages):
    return {"kv_num_pages": num_pages, "kv_page_size": PS,
            "max_batch_slots": 4, "prefill_buckets": [8, 16, 32],
            "prefix_cache": {"enabled": True, "cow_min_tokens": 2}}


def j_engine(num_pages, host_swap_bytes, jparams, model=MODEL):
    cfg = j_load_config(
        model={**model, "engine_type": "jax_tpu"},
        kv_cache={"host_swap_bytes": host_swap_bytes},
        tpu={"dp": 1, "tp": 1, "ep": 1, "sp": 1, "num_devices": 1,
             "use_pallas": False, **shapes(num_pages)},
        scheduler={"max_queue_size": 16},
        integrity={"enabled": False},
        logging={"level": "ERROR"},
    )
    return JEngineCore(cfg, params=jparams, devices=jax.devices()[:1])


def t_engine(num_pages, host_swap_bytes, jparams, model=MODEL):
    cfg = load_config(
        model={**model, "engine_type": "torch_cuda"},
        kv_cache={"host_swap_bytes": host_swap_bytes},
        device={"device": "cpu", **shapes(num_pages)},
        scheduler={"max_queue_size": 16},
        logging={"level": "ERROR"},
    )
    return EngineCore(cfg, params=params_from_jax(
        jax.tree.map(np.asarray, jparams), TINY_DENSE))


def drive(core, prompts, params):
    """Queue the wave, then tick until every sequence settled."""
    seqs = [core.submit_tokens(list(p), params) for p in prompts]
    for _ in range(10_000):
        if all(s.done_event.is_set() for s in seqs):
            break
        core._tick()
    for s in seqs:
        assert s.done_event.is_set() and s.error is None, s.error
    return [list(s.generated_ids) for s in seqs]


@pytest.fixture(scope="module")
def jparams():
    return j_init(TINY_DENSE, None, np.float32)


def test_engine_swap_zero_recompute_token_identity(jparams):
    """Under forced KV pressure with the host pool on, preempted
    sequences resume by swap-in with zero recompute tokens and the
    greedy tokens of an unpressured JAX engine; the swap-off port
    engine preempts as well, pays recompute, and gives the same
    tokens."""
    prompts = [[7 + i, 3, 9, 4 + i, 11, 6, 2, 13 + i, 5, 8, 12, 10 + i]
               for i in range(4)]
    big = j_engine(200, 0, jparams)
    try:
        base = drive(big, prompts, JSamplingParams(
            max_tokens=40, temperature=0.0, min_tokens=40))
        assert big.scheduler.total_preemptions == 0
    finally:
        big.stop()
    params = SamplingParams(max_tokens=40, temperature=0.0, min_tokens=40)

    on = t_engine(40, 1 << 24, jparams)
    try:
        assert drive(on, prompts, params) == base
        st = on.get_stats()
        sched = st["scheduler"]
        assert sched["preemptions"] > 0, "pool was never squeezed"
        assert sched["swap_preempts"] == sched["preemptions"]
        assert sched["preempt_recompute_tokens"] == 0
        assert st["kv_swap"]["swap_in_pages"]["preempt"] > 0
        assert st["used_pages"] == 0
        assert st["kv_swap"]["swapped_seqs"] == 0
    finally:
        on.stop()

    off = t_engine(40, 0, jparams)
    try:
        assert drive(off, prompts, params) == base
        st = off.get_stats()
        assert st["scheduler"]["preemptions"] > 0
        assert st["scheduler"]["preempt_recompute_tokens"] > 0
        assert "kv_swap" not in st and off.kv_swap is None
    finally:
        off.stop()


def test_radix_demotion_and_promotion_match_jax(jparams):
    """A cached prefix is demoted to the host pool when later waves need
    its pages, then promoted back by a prompt that shares it: the port's
    tokens, hit tokens and page counts each way equal the JAX
    engine's."""
    model = {**MODEL, "max_model_len": 64}
    doc = [40 + (3 * i) % 50 for i in range(20)]
    waves = [
        [doc],
        [[90 - i, 4, 6, 8] + [30 + (7 * i + j) % 40 for j in range(16)]
         for i in range(3)],
        [doc[:16] + [71, 72, 73, 74]],
    ]
    got = {}
    for name, make, sp in (("j", j_engine, JSamplingParams),
                           ("t", t_engine, SamplingParams)):
        core = make(24, 1 << 24, jparams, model=model)
        try:
            params = sp(max_tokens=8, temperature=0.0, min_tokens=8)
            tokens = [drive(core, w, params) for w in waves]
            st = core.get_stats()
            sw = st["kv_swap"]
            got[name] = {
                "tokens": tokens,
                "hit_tokens": st["scheduler"]["prefix_cache"]["hit_tokens"],
                "swap_out": sw["swap_out_pages"],
                "swap_in": sw["swap_in_pages"],
                "discard": sw["discard_pages"],
            }
        finally:
            core.stop()
    assert got["t"] == got["j"]
    assert got["t"]["swap_out"]["prefix"] > 0
    assert got["t"]["swap_in"]["prefix"] > 0
    assert got["t"]["hit_tokens"] >= 16


def test_pressure_signals_carry_the_swap_block(jparams):
    j, t = j_engine(48, 1 << 20, jparams), t_engine(48, 1 << 20, jparams)
    try:
        sig_j, sig_t = j.pressure_signals(), t.pressure_signals()
        assert set(sig_t) == set(sig_j)
        for key in ("kv_swap_enabled", "kv_host_pool_bytes",
                    "kv_host_pool_budget_bytes", "kv_host_free_ratio",
                    "kv_swapped_seqs"):
            assert sig_t[key] == sig_j[key], key
    finally:
        j.stop()
        t.stop()


def test_engine_swap_off_pressure_signals_unchanged(jparams):
    core = t_engine(48, 0, jparams)
    try:
        sig = core.pressure_signals()
        assert "kv_swap_enabled" not in sig
        assert core.kv_swap is None
    finally:
        core.stop()


def test_brownout_l4_suspends_demotions(jparams):
    core = t_engine(48, 1 << 20, jparams)
    try:
        core.set_prefix_insert_suspended(True)
        assert core.kv_swap.demote_suspended
        assert core.radix_cache.insert_suspended
        assert core.kv_swap.demote_node(object(), [1, 2]) is None
        core.set_prefix_insert_suspended(False)
        assert not core.kv_swap.demote_suspended
    finally:
        core.stop()
