"""The port's attention vs the JAX twins and the Pallas kernels.

The cases are those of tests/test_pallas_kernels.py: ragged lengths,
page and chunk edges, GQA mapping, sliding window, softcap + scale,
q_offsets and the 1024 serving bucket.  Each plain torch function is
held against the jnp twin AND against the Pallas kernel run with
``interpret=True``, fp32 atol 2e-5 on the real rows.  On the CPU the
kernel wrappers take the plain path and launch nothing; the CUDA
kernels themselves are held to the plain versions on the card by
tests/test_torch_cuda_kernels.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vgate_tpu.ops import attention as jatt
from vgate_tpu.ops.pallas.flash_prefill import flash_prefill_attention_pallas
from vgate_tpu.ops.pallas.paged_attention import paged_decode_attention_pallas
from vgate_tpu_torch.ops import attention as tatt
from vgate_tpu_torch.ops.kernels import flash_prefill, paged_decode

ATOL = 2e-5


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, expect, mask=None, atol=ATOL):
    got, expect = np.asarray(got), np.asarray(expect)
    if mask is not None:
        got, expect = got[mask], expect[mask]
    np.testing.assert_allclose(got, expect, rtol=ATOL, atol=atol)


# ---------------------------------------------------------- paged decode

def decode_case(B=4, H=8, KV=2, hd=128, ps=16, pps=16, seed=0, lens=None):
    rng = np.random.default_rng(seed)
    P = 1 + B * pps
    q = rng.normal(size=(B, H, hd)).astype(np.float32)
    k = rng.normal(size=(KV, P, ps, hd)).astype(np.float32)
    v = rng.normal(size=(KV, P, ps, hd)).astype(np.float32)
    pt = rng.permutation(np.arange(1, P))[: B * pps].reshape(B, pps)
    pt = pt.astype(np.int32)
    if lens is None:
        lens = rng.integers(1, pps * ps, size=B)
    return q, k, v, pt, np.asarray(lens, np.int32)


def _decode_all(q, k, v, pt, lens, **kw):
    """(port plain, port wrapper, jnp twin, Pallas interpret)."""
    plain = tatt.paged_decode_attention(_t(q), _t(k), _t(v), _t(pt),
                                        _t(lens), **kw)
    jkw = dict(kw)
    if jkw.get("window") is not None:
        jkw["window"] = jnp.asarray(jkw["window"], jnp.int32)
    twin = jatt.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pt),
        jnp.asarray(lens), **jkw,
    )
    kern = paged_decode_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pt),
        jnp.asarray(lens), interpret=True, **jkw,
    )
    wkw = dict(kw)
    wkw["window"] = wkw.get("window") or 0
    wrapped = paged_decode.paged_decode_attention(
        _t(q), _t(k), _t(v), _t(pt), _t(lens), **wkw
    )
    return plain, wrapped, twin, kern


@pytest.mark.parametrize(
    "lens", [None, [1, 16, 17, 128], [255, 256, 200, 3]],
    ids=["random", "page_edges", "chunk_edges"],
)
def test_paged_decode_matches_twin_and_kernel(lens):
    case = decode_case(lens=lens, seed=1 if lens is None else 2)
    before = paged_decode.paged_decode_attention.launches
    plain, wrapped, twin, kern = _decode_all(*case)
    _close(plain, twin)
    _close(plain, kern)
    np.testing.assert_array_equal(wrapped.numpy(), plain.numpy())
    assert paged_decode.paged_decode_attention.launches == before


def test_paged_decode_gqa_group_mapping():
    plain, _, twin, kern = _decode_all(
        *decode_case(B=2, H=8, KV=4, pps=8, seed=3)
    )
    _close(plain, twin)
    _close(plain, kern)


@pytest.mark.parametrize("window", [16, 100, 130, 0])
def test_paged_decode_sliding_window(window):
    case = decode_case(lens=[200, 255, 64, 3], seed=5)
    plain, wrapped, twin, kern = _decode_all(*case, window=window)
    _close(plain, twin)
    _close(plain, kern)
    np.testing.assert_array_equal(wrapped.numpy(), plain.numpy())


def test_paged_decode_softcap_and_scale():
    plain, _, twin, kern = _decode_all(
        *decode_case(seed=6), softcap=50.0, scale=0.25
    )
    _close(plain, twin)
    _close(plain, kern)


def test_paged_decode_layer_indexed_pool():
    q, k, v, pt, lens = decode_case(B=2, H=4, KV=2, pps=4, seed=12,
                                    lens=[17, 55])
    rng = np.random.default_rng(13)
    ks = rng.normal(size=(3, *k.shape)).astype(np.float32)
    vs = rng.normal(size=(3, *v.shape)).astype(np.float32)
    for layer in range(3):
        got = tatt.paged_decode_attention(_t(q), _t(ks), _t(vs), _t(pt),
                                          _t(lens), layer=layer)
        expect = tatt.paged_decode_attention(_t(q), _t(ks[layer]),
                                             _t(vs[layer]), _t(pt), _t(lens))
        np.testing.assert_array_equal(got.numpy(), expect.numpy())


# --------------------------------------------------------- flash prefill

def prefill_case(B=2, S=256, H=4, KV=2, hd=128, seed=0, lens=None):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    if lens is None:
        lens = rng.integers(1, S + 1, size=B)
    return q, k, v, np.asarray(lens, np.int32)


def _real_rows(lens, S):
    return np.arange(S)[None, :] < np.asarray(lens)[:, None]


@pytest.mark.parametrize(
    "lens", [None, [1, 256], [255, 130]], ids=["random", "edges", "ragged"]
)
def test_flash_prefill_matches_oracle_twin_and_kernel(lens):
    q, k, v, sl = prefill_case(lens=lens, seed=7 if lens is None else 8)
    oracle = jatt.causal_prefill_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(sl)
    )
    kern = flash_prefill_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(sl),
        block_q=128, block_k=128, interpret=True,
    )
    before = flash_prefill.flash_prefill_attention.launches
    got = flash_prefill.flash_prefill_attention(_t(q), _t(k), _t(v), _t(sl))
    plain_full = tatt.causal_prefill_attention(_t(q), _t(k), _t(v), _t(sl))
    assert flash_prefill.flash_prefill_attention.launches == before
    _close(got, oracle)
    _close(got, kern)
    _close(plain_full, oracle)


def test_flash_prefill_serving_bucket_1024():
    q, k, v, sl = prefill_case(B=1, S=1024, H=2, KV=1, hd=64, seed=9,
                               lens=[900])
    oracle = jatt.causal_prefill_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(sl)
    )
    kern = flash_prefill_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(sl),
        interpret=True,
    )
    got = tatt.flash_prefill_attention(_t(q), _t(k), _t(v), _t(sl))
    _close(got, oracle)
    _close(got, kern)


def test_flash_prefill_gqa_and_q_offset():
    """A 128-row chunk at global offset 128 reproduces rows [128:256]."""
    q, k, v, sl = prefill_case(B=1, S=256, H=8, KV=4, seed=10, lens=[256])
    oracle = np.asarray(jatt.causal_prefill_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(sl)
    ))
    off = np.array([128], np.int32)
    kern = flash_prefill_attention_pallas(
        jnp.asarray(q[:, 128:]), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(sl), q_offsets=jnp.asarray(off), block_q=128,
        block_k=128, interpret=True,
    )
    twin = jatt.flash_prefill_attention(
        jnp.asarray(q[:, 128:]), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(sl), q_offset=jnp.asarray(off),
    )
    got = flash_prefill.flash_prefill_attention(
        _t(q[:, 128:].copy()), _t(k), _t(v), _t(sl), q_offsets=_t(off)
    )
    _close(got, oracle[:, 128:])
    _close(got, kern)
    _close(got, twin)


@pytest.mark.parametrize("window", [48, 200, 0])
def test_flash_prefill_window_softcap_scale(window):
    rng = np.random.default_rng(31)
    B, S, H, KV, hd = 2, 512, 4, 2, 128
    q = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    sl = np.array([301, 512], np.int32)
    kw = {} if window == 0 else {"softcap": 50.0, "scale": 0.05}
    w = jnp.asarray(window, jnp.int32)
    twin = jatt.flash_prefill_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(sl),
        block_k=128, window=w, **kw,
    )
    kern = flash_prefill_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(sl),
        block_q=128, block_k=128, interpret=True, window=w, **kw,
    )
    got = flash_prefill.flash_prefill_attention(
        _t(q), _t(k), _t(v), _t(sl), window=window, **kw
    )
    real = _real_rows(sl, S)  # padding rows are garbage by design
    _close(got, twin, real)
    _close(got, kern, real)
    full = tatt.causal_prefill_attention(_t(q), _t(k), _t(v), _t(sl),
                                         window=window, **kw)
    _close(full, twin, real)
