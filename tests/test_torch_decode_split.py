"""The page-split decode's arithmetic on int8 pools, on the CPU.

K1-int8 (csrc/paged_decode.cu ``paged_decode_tc_kernel`` on int8 pools)
cuts each slot's live range into the chunks of its plan, reduces each
chunk to (m, l, acc) per query head with the scales folded as the TPU
kernel folds them (the K scale into the score before the softcap, the V
scale into the softmax weight after the row sum took it unweighted) and
merges the chunks in chunk order.  ``paged_decode.split_decode_plain``
models that in fp32; here it is held, on the same numpy-seeded inputs, to
the port's unsplit plain version (``ops/attention.py``, which dequantizes
first), to the reference's jnp twin and to its Pallas K1 in its int8 mode
in interpret mode: G 7 (Qwen2.5-7B's heads) and G 2 (Gemma-2-9B's), window
and softcap on and off, under K1's own plan at each shape and under plans
of one and of several tiles a chunk.  fp32, atol = rtol = 2e-5: the same
function, sums in another order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vgate_tpu.ops import attention as jatt
from vgate_tpu.ops import kv_quant as jkq
from vgate_tpu.ops.pallas.paged_attention import paged_decode_attention_pallas
from vgate_tpu_torch.ops import attention as tatt
from vgate_tpu_torch.ops import kv_quant as tkq
from vgate_tpu_torch.ops.kernels import paged_decode

TOL = 2e-5


def _case(G, hd, ps, lens, seed, KV=2):
    """q and int8 K/V pools (quantized by the port, bit-identical to the
    reference's quantize) in both packages, distinct shuffled pages."""
    rng = np.random.default_rng(seed)
    B = len(lens)
    pps = -(-max(lens) // ps) + 1
    P = 1 + B * pps
    pools = []
    for spread in (1.0, 0.6):
        vals = (rng.normal(size=(KV, P, ps, hd)) * spread).astype(np.float32)
        q8, s = tkq.quantize(torch.from_numpy(vals))
        pools.append((tkq.QuantPages(q8, s),
                      jkq.QuantPages(jnp.asarray(q8.numpy()),
                                     jnp.asarray(s.float().numpy()).astype(
                                         jnp.bfloat16))))
    q = rng.normal(size=(B, KV * G, hd)).astype(np.float32)
    pt = rng.permutation(np.arange(1, P))[: B * pps].reshape(B, pps).astype(
        np.int32)
    return q, pools[0], pools[1], pt, np.asarray(lens, np.int32)


# (name, G, hd, ps, lens): the 7B heads and Gemma-2-9B's, lengths across
# page and chunk edges
SHAPES = {
    "qwen_g7": (7, 128, 16, [1, 15, 16, 17, 100, 200]),
    "gemma_g2": (2, 256, 16, [1, 16, 33, 130, 255, 256]),
}
KWARGS = {
    "plain": {},
    "window": {"window": 40},
    "softcap": {"softcap": 30.0},
    "window_softcap_scale": {"window": 100, "softcap": 50.0,
                             "scale": 1 / 16},
}


def _plans(B, H, KV, hd, ps, pps, window):
    """K1's own plan at this shape, and plans of one and of three tiles a
    chunk over half-page tiles (many chunks a slot)."""
    own = paged_decode.decode_plan(B, H, KV, hd, ps, pps, window, 1, 132)
    bound = paged_decode.live_tiles_bound(ps, pps, window, ps // 2)
    cut = [paged_decode.DecodePlan(ps // 2, 2, ct, -(-bound // ct), 1, 0, 0,
                                   True) for ct in (1, 3)]
    return [own] + cut


@pytest.mark.parametrize("kw", list(KWARGS))
@pytest.mark.parametrize("shape", list(SHAPES))
def test_int8_split_matches_unsplit_twin_and_pallas(shape, kw):
    G, hd, ps, lens = SHAPES[shape]
    kwargs = KWARGS[kw]
    q, (tk, jk), (tv, jv), pt, sl = _case(G, hd, ps, lens, seed=len(kw) + G)
    B, H, _ = q.shape
    KV = H // G
    window = kwargs.get("window", 0)
    softcap = kwargs.get("softcap", 0.0)
    scale = kwargs.get("scale")
    tq, tpt, tsl = (torch.from_numpy(x) for x in (q, pt, sl))
    unsplit = tatt.paged_decode_attention(
        tq, tk, tv, tpt, tsl, softcap=softcap, window=window or None,
        scale=scale).numpy()
    jargs = (jnp.asarray(q), jk, jv, jnp.asarray(pt), jnp.asarray(sl))
    jw = jnp.asarray(window, jnp.int32) if window else None
    twin = np.asarray(jatt.paged_decode_attention(
        *jargs, softcap=softcap, window=jw, scale=scale))
    pallas = np.asarray(paged_decode_attention_pallas(
        *jargs, window=jw, interpret=True, softcap=softcap, scale=scale))
    for plan in _plans(B, H, KV, hd, ps, pt.shape[1], window):
        got = paged_decode.split_decode_plain(
            tq, tk, tv, tpt, tsl, plan, softcap=softcap, window=window,
            scale=scale).numpy()
        for expect in (unsplit, twin, pallas):
            np.testing.assert_allclose(got, expect, atol=TOL, rtol=TOL)


def test_int8_split_folds_the_scales_not_the_values():
    """Scales that differ token by token move the result exactly as the
    dequantized pools do: the split model on (int8, scale) equals the
    bf16-pool split model on the dequantized values."""
    q, (tk, _), (tv, _), pt, sl = _case(7, 128, 16, [3, 40, 77], seed=5)
    tq, tpt, tsl = (torch.from_numpy(x) for x in (q, pt, sl))
    plan = paged_decode.DecodePlan(8, 2, 2, 8, 1, 0, 0, True)
    got = paged_decode.split_decode_plain(tq, tk, tv, tpt, tsl, plan,
                                          softcap=20.0, window=30)
    deq = paged_decode.split_decode_plain(
        tq, tkq.dequantize(tk.data, tk.scale), tkq.dequantize(tv.data, tv.scale),
        tpt, tsl, plan, softcap=20.0, window=30)
    np.testing.assert_allclose(got.numpy(), deq.numpy(), atol=TOL, rtol=TOL)


def test_k1_int8_wrapper_on_the_cpu_takes_the_plain_version():
    """On CPU tensors the K1-int8 wrapper is the plain version and counts
    no launch (a CUDA tensor would launch the kernel or raise)."""
    q, (tk, _), (tv, _), pt, sl = _case(2, 64, 16, [1, 30], seed=7)
    tq, tpt, tsl = (torch.from_numpy(x) for x in (q, pt, sl))
    before = paged_decode.paged_decode_attention_int8.launches
    got = paged_decode.paged_decode_attention(tq, tk, tv, tpt, tsl)
    assert paged_decode.paged_decode_attention_int8.launches == before
    np.testing.assert_array_equal(
        got.numpy(), tatt.paged_decode_attention(tq, tk, tv, tpt, tsl).numpy())
