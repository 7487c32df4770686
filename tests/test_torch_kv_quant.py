"""The port's int8 KV pools (ops/kv_quant.py) vs the JAX package's.

Inputs come from a numpy seed and go through both packages.  Tolerances:
``quantize`` and every pool write are compared BIT FOR BIT (int8 data
equal, bf16 scales equal); the f32 attention twins on int8 pools agree
to atol = rtol = 2e-5 (the same f32 sums in two frameworks' orders, as
tests/test_kv_quant.py holds its Pallas kernels to); the quantized
decoder's logits to 1e-4 (fp32 through two layers).  The Pallas K1/K3
int8 modes run in interpret mode, as tests/test_kv_quant.py runs them.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vgate_tpu.models import decoder as jdec
from vgate_tpu.models.specs import TINY_DENSE as J_TINY
from vgate_tpu.models.specs import spec_for_model_id as j_spec
from vgate_tpu.ops import attention as jatt
from vgate_tpu.ops import kv_quant as jkq
from vgate_tpu.ops.pallas.paged_attention import (
    paged_decode_attention_pallas,
    paged_multitok_attention_pallas,
)
from vgate_tpu.runtime.kv_cache import auto_num_pages as j_auto_num_pages
from vgate_tpu_torch.models import decoder as tdec
from vgate_tpu_torch.models.specs import TINY_DENSE, spec_for_model_id
from vgate_tpu_torch.ops import attention as tatt
from vgate_tpu_torch.ops import kv_quant as tkq
from vgate_tpu_torch.ops.kernels import paged_decode, paged_multitok
from vgate_tpu_torch.runtime.kv_cache import (
    KVGeometry,
    auto_num_pages,
    make_kv_buffers,
)
from vgate_tpu_torch.runtime.weights import params_from_jax

ATOL = 2e-5


def _np(x):
    """A JAX or torch array as numpy; bf16 goes through f32 (exact)."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    if x.dtype == jnp.bfloat16:
        x = x.astype(jnp.float32)
    return np.asarray(x)


def _assert_pools_equal(tpool, jpool):
    np.testing.assert_array_equal(tpool.data.numpy(), np.asarray(jpool.data))
    np.testing.assert_array_equal(_np(tpool.scale), _np(jpool.scale))


def _empty_pools(shape):
    """A zeroed int8 pool (scales 1) in each package."""
    t = tkq.QuantPages(torch.zeros(shape, dtype=torch.int8),
                       torch.ones(shape[:-1], dtype=torch.bfloat16))
    j = jkq.QuantPages(jnp.zeros(shape, jnp.int8),
                       jnp.ones(shape[:-1], jnp.bfloat16))
    return t, j


# ------------------------------------------------------------- numerics


@pytest.mark.parametrize(
    "shape,scale,dtype",
    [((5, 7, 64), 3.0, np.float32), ((2, 3, 4, 128), 0.02, np.float32),
     ((4, 16), 40.0, "bfloat16"), ((3, 8, 16), 0.0, np.float32)],
)
def test_quantize_is_bit_identical(shape, scale, dtype):
    rng = np.random.default_rng(hash(shape) % 1000)
    x = (rng.normal(size=shape) * scale).astype(np.float32)
    x[..., 0, :] = 0.0  # an all-zero row: scale 1, dequant exactly 0
    jx = jnp.asarray(x)
    tx = torch.from_numpy(x)
    if dtype == "bfloat16":
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
        np.testing.assert_array_equal(_np(tx), _np(jx))
    tq, ts = tkq.quantize(tx)
    jq, js = jkq.quantize(jx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_np(ts), _np(js))
    np.testing.assert_array_equal(
        tkq.dequantize(tq, ts).numpy(), np.asarray(jkq.dequantize(jq, js))
    )


def _index_case(form, rng, KV=2, P=12, ps=4, hd=16, B=3):
    """(port idx, JAX idx, value [...]) for one write form; indices are
    distinct, so no duplicate write decides the result."""
    pages = rng.permutation(np.arange(1, P))
    if form == "prefill":  # whole pages: value [KV, B, n, ps, hd]
        pt = pages[: B * 2].reshape(B, 2)
        val = rng.normal(size=(KV, B, 2, ps, hd)) * 2.0
        idx = (slice(None), pt)
    elif form == "cow_scatter":  # per-token (page, slot): [KV, B, S, hd]
        S = 3
        pg = pages[:B][:, None].repeat(S, 1)
        slot = np.stack([np.arange(1, 1 + S)] * B)
        val = rng.normal(size=(KV, B, S, hd))
        idx = (slice(None), pg, slot)
    else:  # decode slot: [KV, B, hd]
        val = rng.normal(size=(KV, B, hd)) * 5.0
        idx = (slice(None), pages[:B], rng.integers(0, ps, size=B))
    val = val.astype(np.float32)

    def conv(ix, mod):
        return tuple(i if isinstance(i, slice) else mod(i) for i in ix)

    t_idx = conv(idx, lambda a: torch.from_numpy(np.asarray(a, np.int64)))
    j_idx = conv(idx, lambda a: jnp.asarray(a, jnp.int32))
    return t_idx, j_idx, val, (KV, P, ps, hd)


@pytest.mark.parametrize("form", ["prefill", "cow_scatter", "decode"])
def test_kv_write_then_gather_matches_jax(form):
    rng = np.random.default_rng(7)
    t_idx, j_idx, val, shape = _index_case(form, rng)
    tpool, jpool = _empty_pools(shape)
    tkq.kv_write(tpool, t_idx, torch.from_numpy(val))
    jpool = jkq.kv_write(jpool, j_idx, jnp.asarray(val))
    _assert_pools_equal(tpool, jpool)
    pt = np.arange(shape[1]).reshape(2, -1).astype(np.int32)
    np.testing.assert_array_equal(
        tkq.gather_pages(tpool, torch.from_numpy(pt)).numpy(),
        np.asarray(jkq.gather_pages(jpool, jnp.asarray(pt))),
    )


def test_kv_write_through_a_layer_view_lands_in_the_pool():
    """The port writes through ``pool[l]`` (views of data and scale);
    the reference writes the layer-indexed pool.  Same pool after."""
    rng = np.random.default_rng(8)
    t_idx, j_idx, val, shape = _index_case("decode", rng)
    L = 3
    tpool, jpool = _empty_pools((L, *shape))
    view = tpool[1]
    assert view.data.data_ptr() == tpool.data[1].data_ptr()
    tkq.kv_write(view, t_idx, torch.from_numpy(val))
    # the layer index and the advanced indices are apart: value [B, KV, hd]
    jpool = jkq.kv_write(jpool, (1, *j_idx),
                         jnp.asarray(val).transpose(1, 0, 2))
    _assert_pools_equal(tpool, jpool)
    pt = np.arange(1, 9).reshape(2, 4).astype(np.int32)
    np.testing.assert_array_equal(
        tkq.gather_pages(tpool, torch.from_numpy(pt), layer=1).numpy(),
        np.asarray(jkq.gather_pages(jpool, jnp.asarray(pt),
                                    layer=jnp.asarray(1))),
    )


@pytest.mark.parametrize("upto", [1, 3])
def test_copy_page_prefix_carries_the_scales(upto):
    rng = np.random.default_rng(9)
    t_idx, j_idx, val, shape = _index_case("prefill", rng)
    tpool, _ = _empty_pools((2, *shape))
    layers = []
    for l in range(2):
        tkq.kv_write(tpool[l], t_idx, torch.from_numpy(val * (l + 1)))
        layers.append(jkq.kv_write(_empty_pools(shape)[1], j_idx,
                                   jnp.asarray(val * (l + 1))))
    jpool = jkq.QuantPages(jnp.stack([p.data for p in layers]),
                           jnp.stack([p.scale for p in layers]))
    src, dst = int(t_idx[1][0, 0]), int(t_idx[1][1, 1])
    tkq.copy_page_prefix(tpool, src, dst, upto)
    jpool = jkq.copy_page_prefix(
        jpool, src, dst, jnp.arange(shape[2]) < upto
    )
    _assert_pools_equal(tpool, jpool)
    np.testing.assert_array_equal(
        _np(tpool.scale[..., dst, :upto]),
        _np(tpool.scale[..., src, :upto]),
    )


# ------------------------------------------------ pools and capacity


def test_make_kv_buffers_int8_pool_structure():
    geo = KVGeometry(
        num_layers=2, num_pages=6, page_size=4, kv_heads=2, head_dim=8,
        max_model_len=16, dtype_bytes=1, scale_bytes=2, kv_dtype="int8",
    )
    k, v = make_kv_buffers(geo, torch.int8, torch.device("cpu"))
    assert tkq.is_quantized(k) and tkq.is_quantized(v)
    assert k.shape == (2, 2, 6, 4, 8) and k.dtype == torch.int8
    assert k.scale.shape == (2, 2, 6, 4) and k.scale.dtype == torch.bfloat16
    assert bool((k.scale == 1).all()) and int(k.data.abs().max()) == 0
    assert float(tkq.gather_pages(k[0], torch.arange(6)[None]).abs().max()) \
        == 0.0
    assert tkq.dtype_short_name(torch.int8) == "int8"


@pytest.mark.parametrize(
    "model_id", ["Qwen/Qwen2.5-1.5B-Instruct", "Qwen/Qwen2.5-7B-Instruct"]
)
def test_auto_num_pages_int8_yields_at_least_1p9x(model_id):
    """One budget (16 GiB at 0.9, as tests/test_kv_quant.py) holds >= 1.9x
    the bf16 page count in int8 pools, page for page the reference's."""
    spec = spec_for_model_id(model_id)
    budget = 16 * 1024 ** 3 * 0.9
    counts = {}
    for name, db, sb in (("bf16", 2, 0), ("int8", 1, tkq.SCALE_BYTES)):
        counts[name] = auto_num_pages(
            spec, 32, 0.9, torch.device("cpu"), dtype_bytes=db,
            scale_bytes=sb, hard_cap=10 ** 9, budget_bytes=budget,
        )
        assert counts[name] == j_auto_num_pages(
            j_spec(model_id), page_size=32, hbm_utilization=0.9,
            device=SimpleNamespace(platform="tpu"), params_bytes=0,
            hbm_bytes=16 * 1024 ** 3, hard_cap=10 ** 9, dtype_bytes=db,
            scale_bytes=sb,
        )
    assert counts["int8"] / counts["bf16"] >= 1.9


# ------------------------------------ attention over int8 pools (K1, K3)


def _quant_case(B=4, H=8, KV=2, hd=128, ps=16, n=16, seed=3, L=None):
    """q and int8 K/V pools (written by the port's kv_write) in both
    packages, and a page table of distinct shuffled pages."""
    rng = np.random.default_rng(seed)
    P = 1 + B * n
    shape = (KV, P, ps, hd) if L is None else (L, KV, P, ps, hd)
    pools = []
    for scale in (1.0, 0.7):
        vals = (rng.normal(size=shape) * scale).astype(np.float32)
        q8, s = tkq.quantize(torch.from_numpy(vals))
        pools.append((
            tkq.QuantPages(q8, s),
            jkq.QuantPages(jnp.asarray(q8.numpy()),
                           jnp.asarray(s.float().numpy()).astype(
                               jnp.bfloat16)),
        ))
    q = rng.normal(size=(B, H, hd)).astype(np.float32)
    pt = rng.permutation(np.arange(1, P))[: B * n].reshape(B, n).astype(
        np.int32
    )
    return q, pools[0], pools[1], pt


@pytest.mark.parametrize("window,softcap", [(None, 0.0), (40, 0.0),
                                            (None, 30.0)])
def test_paged_decode_on_int8_pools_matches_jax(window, softcap):
    """The plain version of K1-int8 vs the reference's jnp twin, and vs
    its Pallas int8 mode in interpret mode; the K1 wrapper on the CPU
    takes the plain version and counts no launch."""
    q, (tk, jk), (tv, jv), pt = _quant_case()
    lens = np.array([1, 16, 17, 200], np.int32)
    kw = {"softcap": softcap}
    got = tatt.paged_decode_attention(
        torch.from_numpy(q), tk, tv, torch.from_numpy(pt),
        torch.from_numpy(lens), window=window, **kw,
    )
    jargs = (jnp.asarray(q), jk, jv, jnp.asarray(pt), jnp.asarray(lens))
    twin = jatt.paged_decode_attention(*jargs, window=window, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(twin), atol=ATOL,
                               rtol=ATOL)
    pallas = paged_decode_attention_pallas(*jargs, window=window,
                                           interpret=True, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=ATOL,
                               rtol=ATOL)
    before = paged_decode.paged_decode_attention_int8.launches
    wrapped = paged_decode.paged_decode_attention(
        torch.from_numpy(q), tk, tv, torch.from_numpy(pt),
        torch.from_numpy(lens), window=window or 0, **kw,
    )
    np.testing.assert_array_equal(wrapped.numpy(), got.numpy())
    assert paged_decode.paged_decode_attention_int8.launches == before


def test_paged_decode_on_layer_indexed_int8_pools():
    """Layer-indexed pools: the scale gather composes the layer index
    exactly like the data gather (the Pallas kernel's scale DMA)."""
    q, (tk, jk), (tv, jv), pt = _quant_case(B=2, n=8, L=3)
    lens = np.array([5, 100], np.int32)
    got = tatt.paged_decode_attention(
        torch.from_numpy(q), tk, tv, torch.from_numpy(pt),
        torch.from_numpy(lens), layer=1,
    )
    pallas = paged_decode_attention_pallas(
        jnp.asarray(q), jk, jv, jnp.asarray(pt), jnp.asarray(lens),
        layer=jnp.asarray(1), interpret=True,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=ATOL,
                               rtol=ATOL)
    np.testing.assert_allclose(
        got.numpy(),
        tatt.paged_decode_attention(
            torch.from_numpy(q), tk[1], tv[1], torch.from_numpy(pt),
            torch.from_numpy(lens),
        ).numpy(), atol=0, rtol=0,
    )


@pytest.mark.parametrize("pos0,lens", [([0, 5, 30, 100], [1, 3, 4, 2]),
                                       ([16, 3, 64, 0], [4, 4, 1, 4])])
def test_paged_suffix_on_int8_pools_matches_jax(pos0, lens):
    """The plain version of K3-int8 vs the reference's jnp twin and its
    Pallas int8 mode in interpret mode (rows past ``lens`` unspecified);
    unaligned starts are the copy-on-write suffix."""
    rng = np.random.default_rng(4)
    _, (tk, jk), (tv, jv), pt = _quant_case(seed=4)
    B, S, H, hd = 4, 4, 8, 128
    qs = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    p0 = np.asarray(pos0, np.int32)
    il = np.asarray(lens, np.int32)
    got = tatt.paged_suffix_attention(
        torch.from_numpy(qs), tk, tv, torch.from_numpy(pt),
        torch.from_numpy(p0), torch.from_numpy(p0 + il),
    ).numpy()
    jargs = (jnp.asarray(qs), jk, jv, jnp.asarray(pt))
    twin = np.asarray(jatt.paged_suffix_attention(
        *jargs, jnp.asarray(p0), jnp.asarray(p0 + il)
    ))
    pallas = np.asarray(paged_multitok_attention_pallas(
        *jargs, jnp.asarray(p0), jnp.asarray(il), interpret=True
    ))
    wrapped = paged_multitok.paged_multitok_attention(
        torch.from_numpy(qs), tk, tv, torch.from_numpy(pt),
        torch.from_numpy(p0), torch.from_numpy(il),
    ).numpy()
    for b in range(B):
        n = int(il[b])
        np.testing.assert_allclose(got[b, :n], twin[b, :n], atol=ATOL,
                                   rtol=ATOL)
        np.testing.assert_allclose(got[b, :n], pallas[b, :n], atol=ATOL,
                                   rtol=ATOL)
        np.testing.assert_array_equal(wrapped[b, :n], got[b, :n])


# ------------------------------------------- the decoder on int8 pools


def test_decoder_on_int8_pools_matches_jax():
    """A prompt pass, a copy-on-write suffix pass and two decode steps of
    tiny-dense (fp32) on int8 pools: the same logits (atol 1e-4) and the
    same pools, bit for bit, as the reference's decoder."""
    jparams = jdec.init_params(J_TINY, jax.random.PRNGKey(0), jnp.float32)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), TINY_DENSE)
    spec, ps = TINY_DENSE, 4
    shape = (spec.num_layers, spec.num_kv_heads, 20, ps, spec.head_dim)
    (tk, jk), (tv, jv) = _empty_pools(shape), _empty_pools(shape)
    rng = np.random.default_rng(5)
    tokens = rng.integers(3, spec.vocab_size, size=(1, 16)).astype(np.int32)
    lens = np.array([11], np.int32)
    pt = np.arange(1, 5, dtype=np.int32)[None]

    def t(a):
        return torch.from_numpy(np.asarray(a))

    jl, jk, jv = jdec.prefill_forward(
        jparams, J_TINY, jnp.asarray(tokens), jnp.asarray(lens), jk, jv,
        jnp.asarray(pt),
    )
    tl = tdec.prefill_forward(tparams, spec, t(tokens), t(lens), tk, tv,
                              t(pt))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    _assert_pools_equal(tk, jk)
    _assert_pools_equal(tv, jv)

    # copy-on-write: page 2's first 2 slots into page 5, suffix from pos 6
    keep = jnp.arange(ps) < 2
    jk = jkq.copy_page_prefix(jk, 2, 5, keep)
    jv = jkq.copy_page_prefix(jv, 2, 5, keep)
    tkq.copy_page_prefix(tk, 2, 5, 2)
    tkq.copy_page_prefix(tv, 2, 5, 2)
    suffix = rng.integers(3, spec.vocab_size, size=(1, 8)).astype(np.int32)
    args = dict(prefix=np.array([6], np.int32), n=np.array([7], np.int32),
                spt=np.array([[5, 6, 7]], np.int32),
                ctx=np.array([[1, 5, 6, 7]], np.int32))
    jl, jk, jv = jdec.prefill_suffix_forward(
        jparams, J_TINY, jnp.asarray(suffix), jnp.asarray(args["prefix"]),
        jnp.asarray(args["n"]), jk, jv, jnp.asarray(args["spt"]),
        jnp.asarray(args["ctx"]), unaligned=True,
    )[:3]
    tl = tdec.prefill_suffix_forward(
        tparams, spec, t(suffix), t(args["prefix"]), t(args["n"]), tk, tv,
        t(args["spt"]), t(args["ctx"]), unaligned=True,
    )
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    _assert_pools_equal(tk, jk)
    _assert_pools_equal(tv, jv)

    dpt = np.array([[1, 5, 6, 7, 8]], np.int32)
    tok = np.array([int(tl.argmax())], np.int32)
    for pos in (13, 14):
        jl, jk, jv = jdec.decode_forward(
            jparams, J_TINY, jnp.asarray(tok), jnp.asarray([pos]), jk, jv,
            jnp.asarray(dpt),
        )[:3]
        tl = tdec.decode_forward(tparams, spec, t(tok), t([pos]), tk, tv,
                                 t(dpt))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
        tok = np.array([int(tl.argmax())], np.int32)
    _assert_pools_equal(tk, jk)
    _assert_pools_equal(tv, jv)
