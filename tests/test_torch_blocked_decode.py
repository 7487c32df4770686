"""K6, the blocked paged decode, on the CPU: the port's wrapper
(``paged_decode_attention_blocked``, whose plain version is K1's
function, ops/attention.py ``paged_decode_attention``) against the
reference's Pallas ``paged_decode_attention_pallas_blocked`` in
interpret mode, on the cases of tests/test_pallas_kernels.py (mixed
lengths and chunk edges in one block, a window whose start differs per
slot, softcap, a layer-indexed pool, the ``B % block_slots`` dispatch)
and the int8-pool dispatch of tests/test_kv_quant.py.  fp32, atol = rtol
= 2e-5: the same function, sums in another order.  Also the wrapper's
dispatch on the CPU and its launch counters.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vgate_tpu.ops.kv_quant import QuantPages as JQuantPages
from vgate_tpu.ops.pallas.paged_attention import (
    paged_decode_attention_pallas,
    paged_decode_attention_pallas_blocked,
)
from vgate_tpu_torch.ops import kv_quant as tkq
from vgate_tpu_torch.ops.kernels import paged_decode

TOL = 2e-5


def make_case(B=4, H=8, KV=2, hd=128, ps=16, pages_per_seq=16, seed=0,
              lens=None, L=None):
    """numpy q, pools (with a leading [L] when ``L``), distinct shuffled
    pages and lengths: tests/test_pallas_kernels.py ``make_case``."""
    rng = np.random.default_rng(seed)
    P = 1 + B * pages_per_seq
    q = rng.normal(size=(B, H, hd)).astype(np.float32)
    shape = (KV, P, ps, hd) if L is None else (L, KV, P, ps, hd)
    k = rng.normal(size=shape).astype(np.float32)
    v = rng.normal(size=shape).astype(np.float32)
    pt = rng.permutation(np.arange(1, P))[: B * pages_per_seq].reshape(
        B, pages_per_seq
    ).astype(np.int32)
    if lens is None:
        lens = rng.integers(1, pages_per_seq * ps, size=B)
    return q, k, v, pt, np.asarray(lens, np.int32)


# (case kwargs, kernel kwargs, layer): the reference's blocked-kernel cases
CASES = {
    "random_lengths": (dict(B=4, seed=11), {}, None),
    "page_and_chunk_edges": (dict(B=4, lens=[1, 16, 255, 256], seed=12), {},
                             None),
    "per_slot_window_and_softcap": (
        dict(B=4, lens=[40, 200, 96, 130], seed=13),
        {"window": 64, "softcap": 30.0}, None),
    "layer_indexed_pool": (dict(B=2, lens=[33, 97], seed=14, L=3), {}, 1),
    "batch_not_divisible": (
        dict(B=3, H=8, KV=2, lens=[5, 60, 100], seed=16, pages_per_seq=8),
        {}, None),
    "gemma_shape_window_softcap_scale": (
        dict(B=4, H=4, KV=2, hd=256, lens=[3, 70, 130, 255], seed=17),
        {"window": 64, "softcap": 50.0, "scale": 1 / 16}, None),
}


@pytest.mark.parametrize("name", list(CASES))
def test_blocked_plain_matches_the_pallas_kernel(name):
    case, kw, layer = CASES[name]
    q, k, v, pt, lens = make_case(**case)
    jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pt),
             jnp.asarray(lens))
    jkw = dict(kw)
    if "window" in jkw:
        jkw["window"] = jnp.asarray(jkw["window"], jnp.int32)
    if layer is not None:
        jkw["layer"] = jnp.asarray(layer)
    expect = paged_decode_attention_pallas_blocked(
        *jargs, interpret=True, block_slots=2, **jkw
    )
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    if layer is not None:  # the port's forwards pass one layer's view
        tk, tv = tk[layer], tv[layer]
    before = (paged_decode.paged_decode_attention.launches,
              paged_decode.paged_decode_attention_blocked.launches)
    got = paged_decode.paged_decode_attention_blocked(
        torch.from_numpy(q), tk, tv, torch.from_numpy(pt),
        torch.from_numpy(lens), block_slots=2, **kw,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), atol=TOL,
                               rtol=TOL)
    # no kernel runs on the CPU, so no counter moves
    assert (paged_decode.paged_decode_attention.launches,
            paged_decode.paged_decode_attention_blocked.launches) == before


def _quant_case(B=4, H=8, KV=2, hd=128, ps=16, n=16, seed=5):
    """q and int8 K/V pools in both packages (tests/test_torch_kv_quant.py
    ``_quant_case``)."""
    rng = np.random.default_rng(seed)
    P = 1 + B * n
    pools = []
    for scale in (1.0, 0.7):
        vals = (rng.normal(size=(KV, P, ps, hd)) * scale).astype(np.float32)
        q8, s = tkq.quantize(torch.from_numpy(vals))
        pools.append((
            tkq.QuantPages(q8, s),
            JQuantPages(jnp.asarray(q8.numpy()),
                        jnp.asarray(s.float().numpy()).astype(jnp.bfloat16)),
        ))
    q = rng.normal(size=(B, H, hd)).astype(np.float32)
    pt = rng.permutation(np.arange(1, P))[: B * n].reshape(B, n).astype(
        np.int32
    )
    return q, pools[0], pools[1], pt


def test_blocked_on_int8_pools_takes_k1_int8():
    """int8 pools: the reference's blocked kernel falls back to its
    per-slot kernel, and the port's wrapper to K1's int8 mode (its plain
    version here); both agree."""
    q, (tk, jk), (tv, jv), pt = _quant_case()
    lens = np.array([3, 40, 64, 128], np.int32)
    jargs = (jnp.asarray(q), jk, jv, jnp.asarray(pt), jnp.asarray(lens))
    per_slot = paged_decode_attention_pallas(*jargs, interpret=True)
    blocked = paged_decode_attention_pallas_blocked(*jargs, interpret=True,
                                                    block_slots=2)
    got = paged_decode.paged_decode_attention_blocked(
        torch.from_numpy(q), tk, tv, torch.from_numpy(pt),
        torch.from_numpy(lens), block_slots=2,
    )
    np.testing.assert_allclose(np.asarray(blocked), np.asarray(per_slot),
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(blocked), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize(
    "B,block_slots,int8,to_k1",
    [(4, 2, False, False), (4, 4, False, False), (8, 8, False, False),
     (4, 1, False, True), (3, 2, False, True), (4, 2, True, True)],
    ids=["bs2", "bs4", "bs8", "bs1_is_k1", "b_not_divisible_is_k1",
         "int8_pool_is_k1_int8"],
)
def test_wrapper_dispatch_on_the_cpu(monkeypatch, B, block_slots, int8,
                                     to_k1):
    """The reference's dispatch: block_slots <= 1, B % block_slots != 0
    or an int8 pool go through K1's wrapper (which hands int8 pools to
    K1-int8); the rest take K6's path, on the CPU its plain version."""
    q, k, v, pt, lens = make_case(B=B, H=4, KV=2, hd=64, pages_per_seq=4,
                                  seed=B + block_slots)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    if int8:
        tk, tv = (tkq.QuantPages(*tkq.quantize(t)) for t in (tk, tv))
    calls = []
    real = paged_decode.paged_decode_attention

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(paged_decode, "paged_decode_attention", spy)
    got = paged_decode.paged_decode_attention_blocked(
        tq, tk, tv, torch.from_numpy(pt), torch.from_numpy(lens),
        window=20, block_slots=block_slots,
    )
    assert len(calls) == int(to_k1)
    expect = real(tq, tk, tv, torch.from_numpy(pt), torch.from_numpy(lens),
                  window=20)
    np.testing.assert_array_equal(got.numpy(), expect.numpy())
    assert paged_decode.paged_decode_attention_blocked.launches == 0
