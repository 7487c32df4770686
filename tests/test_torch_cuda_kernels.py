"""The CUDA kernels of vgate_tpu_torch vs their plain versions, on a card.

Every test here is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is false: a CUDA kernel has no CPU mode
(the CPU tests hold the plain versions to the JAX package instead).
The file imports neither JAX nor ``vgate_tpu``, so it also runs on a
machine that has only PyTorch — without the JAX-importing conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Tolerance: bf16 kernel output vs the fp32 plain version on the same bf16
inputs, atol = rtol = 1e-2 — about one bf16 ulp of the output plus
reordered fp32 sums (and, in the tensor-core kernels, the softmax
weights rounded to bf16 before the PV product); f32 pools (paged decode
and the blocked decode), atol = rtol = 1e-4 — fp32 sums in another
order.  K6 is held to the plain version and to K1 on the same inputs.
The int8 pool modes (K1-int8, K3-int8) are held to the same 1e-2
against the plain version on the dequantized pools.  The dequant matmuls (K4, K5) with f32
out: atol = rtol = 1e-3 — bf16 x int8 products are exact in fp32, so
only the order of a few thousand fp32 additions differs.
"""

import numpy as np
import pytest
import torch

from vgate_tpu_torch.ops import attention as tatt
from vgate_tpu_torch.ops import kv_quant, quant
from vgate_tpu_torch.ops.kernels import (
    flash_prefill,
    paged_decode,
    paged_multitok,
    quant_matmul,
)

KERNEL_TOL = 1e-2
F32_TOL = 1e-4
QMM_F32_TOL = 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    return torch.device("cuda")


def _bf16(rng, shape, dev):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        dev, torch.bfloat16
    )


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 100])
def test_paged_decode_kernel_matches_plain_on_card(cuda, window):
    rng = np.random.default_rng(21)
    B, H, KV, hd, ps, pps = 8, 28, 4, 128, 32, 16
    P = 1 + B * pps
    q = _bf16(rng, (B, H, hd), cuda)
    k = _bf16(rng, (KV, P, ps, hd), cuda)
    v = _bf16(rng, (KV, P, ps, hd), cuda)
    pt = torch.from_numpy(
        rng.permutation(np.arange(1, P)).reshape(B, pps).astype(np.int32)
    ).to(cuda)
    lens = torch.tensor([1, 31, 32, 33, 64, 200, 511, 512],
                        dtype=torch.int32, device=cuda)
    before = paged_decode.paged_decode_attention.launches
    got = paged_decode.paged_decode_attention(q, k, v, pt, lens,
                                              window=window)
    torch.cuda.synchronize()
    assert paged_decode.paged_decode_attention.launches == before + 1
    expect = tatt.paged_decode_attention(
        q.float(), k.float(), v.float(), pt, lens,
        window=window if window else None,
    )
    torch.testing.assert_close(got.float(), expect, atol=KERNEL_TOL,
                               rtol=KERNEL_TOL)


@pytest.mark.cuda
def test_paged_decode_kernel_f32_pools_on_card(cuda):
    rng = np.random.default_rng(23)
    B, H, KV, hd, ps, pps = 4, 16, 2, 256, 16, 8
    P = 1 + B * pps
    f32 = lambda shape: torch.from_numpy(  # noqa: E731
        rng.normal(size=shape).astype(np.float32)).to(cuda)
    q, k, v = f32((B, H, hd)), f32((KV, P, ps, hd)), f32((KV, P, ps, hd))
    pt = torch.from_numpy(
        rng.permutation(np.arange(1, P)).reshape(B, pps).astype(np.int32)
    ).to(cuda)
    lens = torch.tensor([1, 16, 17, 128], dtype=torch.int32, device=cuda)
    got = paged_decode.paged_decode_attention(q, k, v, pt, lens)
    expect = tatt.paged_decode_attention(q, k, v, pt, lens)
    torch.testing.assert_close(got, expect, atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 200])
def test_flash_prefill_kernel_matches_plain_on_card(cuda, window):
    rng = np.random.default_rng(22)
    B, S, H, KV, hd = 2, 512, 28, 4, 128
    q = _bf16(rng, (B, S, H, hd), cuda)
    k = _bf16(rng, (B, S, KV, hd), cuda)
    v = _bf16(rng, (B, S, KV, hd), cuda)
    lens = torch.tensor([301, 512], dtype=torch.int32, device=cuda)
    before = flash_prefill.flash_prefill_attention.launches
    got = flash_prefill.flash_prefill_attention(q, k, v, lens,
                                                window=window)
    torch.cuda.synchronize()
    assert flash_prefill.flash_prefill_attention.launches == before + 1
    expect = tatt.flash_prefill_attention(
        q.float(), k.float(), v.float(), lens,
        window=window if window else None,
    )
    real = torch.arange(S, device=cuda)[None, :] < lens[:, None]
    torch.testing.assert_close(got.float()[real], expect[real],
                               atol=KERNEL_TOL, rtol=KERNEL_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("block_slots", [2, 8])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_blocked_decode_kernel_matches_plain_and_k1_on_card(cuda, dtype,
                                                            block_slots):
    """K6 at Gemma-2-9B's heads (hd 256, 16/8 heads: G 2), the window of
    4096 with slot lengths on both sides of its edge and mid-page starts,
    softcap 50 and scale 1/16, an idle slot on the trash page: against
    the plain version and against K1 on the same inputs."""
    rng = np.random.default_rng(25 + block_slots)
    B, H, KV, hd, ps, pps = 8, 16, 8, 256, 32, 160
    P = 1 + B * pps
    q, k, v = (_bf16(rng, shape, cuda).to(dtype)
               for shape in ((B, H, hd), (KV, P, ps, hd), (KV, P, ps, hd)))
    pt = torch.from_numpy(
        rng.permutation(np.arange(1, P)).reshape(B, pps).astype(np.int32)
    ).to(cuda)
    pt[0] = 0  # an idle slot reads only the trash page
    lens = torch.tensor([1, 33, 4095, 4096, 4097, 4111, 5000, 5120],
                        dtype=torch.int32, device=cuda)
    kw = {"window": 4096, "softcap": 50.0, "scale": 1 / 16}
    before = (paged_decode.paged_decode_attention.launches,
              paged_decode.paged_decode_attention_blocked.launches)
    got = paged_decode.paged_decode_attention_blocked(
        q, k, v, pt, lens, block_slots=block_slots, **kw)
    torch.cuda.synchronize()
    assert (paged_decode.paged_decode_attention.launches,
            paged_decode.paged_decode_attention_blocked.launches) == (
        before[0], before[1] + 1)
    tol = KERNEL_TOL if dtype == torch.bfloat16 else F32_TOL
    expect = tatt.paged_decode_attention(q.float(), k.float(), v.float(), pt,
                                         lens, **kw)
    torch.testing.assert_close(got.float(), expect, atol=tol, rtol=tol)
    k1 = paged_decode.paged_decode_attention(q, k, v, pt, lens, **kw)
    torch.testing.assert_close(got.float(), k1.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
def test_blocked_decode_dispatches_to_k1_on_card(cuda):
    """A batch block_slots does not divide, and an int8 pool, launch K1
    and K1-int8; K6's counter stays."""
    rng = np.random.default_rng(27)
    B, H, KV, hd, ps, pps = 6, 16, 8, 256, 16, 4
    P = 1 + B * pps
    q, k, v = (_bf16(rng, s, cuda)
               for s in ((B, H, hd), (KV, P, ps, hd), (KV, P, ps, hd)))
    pt = torch.from_numpy(
        rng.permutation(np.arange(1, P)).reshape(B, pps).astype(np.int32)
    ).to(cuda)
    lens = torch.tensor([1, 9, 16, 17, 40, 64], dtype=torch.int32,
                        device=cuda)
    k8 = _int8_pool(rng, (KV, P, ps, hd), cuda)
    v8 = _int8_pool(rng, (KV, P, ps, hd), cuda)
    wrappers = (paged_decode.paged_decode_attention,
                paged_decode.paged_decode_attention_int8,
                paged_decode.paged_decode_attention_blocked)
    before = [w.launches for w in wrappers]
    paged_decode.paged_decode_attention_blocked(q, k, v, pt, lens,
                                                block_slots=4)
    paged_decode.paged_decode_attention_blocked(q, k8, v8, pt, lens,
                                                block_slots=2)
    torch.cuda.synchronize()
    assert [w.launches for w in wrappers] == [
        before[0] + 1, before[1] + 1, before[2]]


# (hd, H, KV, ps, S, positions0, input_lens, kwargs): unaligned starts
# (copy-on-write suffixes), idle query tiles, page sizes 16 and 32
K3_CASES = [
    (64, 8, 2, 16, 128, [0, 37, 5], [128, 20, 1], {}),
    (128, 28, 4, 32, 256, [1024, 100, 0], [256, 70, 3], {"window": 300}),
    (256, 8, 2, 16, 64, [16, 3, 50], [60, 64, 7],
     {"softcap": 30.0, "scale": 0.1}),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(K3_CASES)))
def test_paged_multitok_kernel_matches_plain_on_card(cuda, case):
    hd, H, KV, ps, S, pos0, lens, kw = K3_CASES[case]
    kw = dict(kw)
    rng = np.random.default_rng(24 + case)
    B = len(pos0)
    ctx_pages = -(-(max(pos0) + S) // ps)
    P = 1 + B * ctx_pages
    q = _bf16(rng, (B, S, H, hd), cuda)
    k = _bf16(rng, (KV, P, ps, hd), cuda)
    v = _bf16(rng, (KV, P, ps, hd), cuda)
    pt = torch.from_numpy(
        rng.permutation(np.arange(1, P)).reshape(B, ctx_pages)
        .astype(np.int32)
    ).to(cuda)
    p0 = torch.tensor(pos0, dtype=torch.int32, device=cuda)
    il = torch.tensor(lens, dtype=torch.int32, device=cuda)
    before = paged_multitok.paged_multitok_attention.launches
    got = paged_multitok.paged_multitok_attention(q, k, v, pt, p0, il, **kw)
    torch.cuda.synchronize()
    assert paged_multitok.paged_multitok_attention.launches == before + 1
    assert bool(torch.isfinite(got).all())  # idle rows too
    window = kw.pop("window", None)
    expect = tatt.paged_suffix_attention(
        q.float(), k.float(), v.float(), pt, p0, p0 + il, window=window, **kw
    )
    real = torch.arange(S, device=cuda)[None, :] < il[:, None]
    torch.testing.assert_close(got.float()[real], expect[real],
                               atol=KERNEL_TOL, rtol=KERNEL_TOL)


# K2 and K3 at the edges of their Hopper tiles (128 query rows a CTA; 128
# keys a tile, 64 at hd 256): S off the tile, key lengths 1/127/128/129
# and below S, q_offsets and positions0 off 64, windows 1/127/129 and 4096
# over a 4,096-token prefix, groups 1/2/7/8, head dims 64/128/256.
# (hd, H, KV, S, Sk, seq_lens, q_offsets, kwargs)
K2_EDGE_CASES = [
    (64, 8, 8, 192, 192, [1, 127], None, {}),
    (128, 14, 2, 192, 192, [128, 129], None, {}),
    (256, 16, 2, 256, 256, [192, 256], None,
     {"window": 1, "softcap": 30.0, "scale": 0.1}),
    (128, 8, 4, 192, 229, [229, 200], [37, 8], {"window": 127}),
    (64, 4, 2, 320, 320, [320, 250], None, {"window": 129}),
    (256, 16, 8, 128, 4224, [4224, 4200], [4096, 4072],
     {"window": 4096, "softcap": 50.0, "scale": 1 / 16}),
]
# (hd, H, KV, ps, S, positions0, input_lens, kwargs, trash columns): idle
# 128-row tiles (input_lens < S), copy-on-write starts mid-page, page
# sizes 16 and 32, page tables padded with trash page 0
K3_EDGE_CASES = [
    (64, 8, 8, 16, 192, [0, 37, 5], [192, 127, 1], {}, 0),
    (128, 14, 2, 32, 256, [1024, 100, 0], [256, 129, 128], {"window": 127},
     3),
    (256, 16, 2, 16, 192, [16, 3, 50], [60, 192, 7],
     {"window": 1, "softcap": 30.0, "scale": 0.1}, 0),
    (128, 8, 4, 32, 512, [4096, 4100], [512, 300], {"window": 4096}, 0),
    (64, 8, 4, 32, 128, [20, 70, 4000], [128, 100, 1], {"window": 129}, 2),
]


def _thrice(fn):
    """Three launches of ``fn`` on the same inputs; a missing barrier wait
    shows as outputs that differ between runs."""
    runs = [fn() for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(runs[0], r) for r in runs[1:]), \
        "three runs on the same inputs differ"
    return runs[0]


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(K2_EDGE_CASES)))
def test_flash_prefill_kernel_tile_edges_on_card(cuda, case):
    hd, H, KV, S, Sk, lens, offs, kw = K2_EDGE_CASES[case]
    rng = np.random.default_rng(60 + case)
    B = len(lens)
    q = _bf16(rng, (B, S, H, hd), cuda)
    k = _bf16(rng, (B, Sk, KV, hd), cuda)
    v = _bf16(rng, (B, Sk, KV, hd), cuda)
    sl = torch.tensor(lens, dtype=torch.int32, device=cuda)
    off = (None if offs is None
           else torch.tensor(offs, dtype=torch.int32, device=cuda))
    got = _thrice(lambda: flash_prefill.flash_prefill_attention(
        q, k, v, sl, q_offsets=off, **kw))
    expect = tatt.flash_prefill_attention(
        q.float(), k.float(), v.float(), sl, q_offset=off,
        softcap=kw.get("softcap", 0.0), window=kw.get("window"),
        scale=kw.get("scale"),
    )
    pos = torch.arange(S, device=cuda)[None, :]
    if off is not None:
        pos = pos + off[:, None]
    real = pos < sl[:, None]  # rows whose own key is real
    torch.testing.assert_close(got.float()[real], expect[real],
                               atol=KERNEL_TOL, rtol=KERNEL_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(K3_EDGE_CASES)))
def test_paged_multitok_kernel_tile_edges_on_card(cuda, case):
    hd, H, KV, ps, S, pos0, lens, kw, trash = K3_EDGE_CASES[case]
    kw = dict(kw)
    rng = np.random.default_rng(70 + case)
    B = len(pos0)
    ctx_pages = -(-(max(pos0) + S) // ps)
    P = 1 + B * ctx_pages
    q = _bf16(rng, (B, S, H, hd), cuda)
    k = _bf16(rng, (KV, P, ps, hd), cuda)
    v = _bf16(rng, (KV, P, ps, hd), cuda)
    pt = np.concatenate([
        rng.permutation(np.arange(1, P)).reshape(B, ctx_pages),
        np.zeros((B, trash), np.int64),  # the bucketed width's padding
    ], axis=1)
    pt = torch.from_numpy(pt.astype(np.int32)).to(cuda)
    p0 = torch.tensor(pos0, dtype=torch.int32, device=cuda)
    il = torch.tensor(lens, dtype=torch.int32, device=cuda)
    got = _thrice(lambda: paged_multitok.paged_multitok_attention(
        q, k, v, pt, p0, il, **kw))
    assert bool(torch.isfinite(got).all())  # idle rows too
    window = kw.pop("window", None)
    expect = tatt.paged_suffix_attention(
        q.float(), k.float(), v.float(), pt, p0, p0 + il, window=window, **kw
    )
    real = torch.arange(S, device=cuda)[None, :] < il[:, None]
    torch.testing.assert_close(got.float()[real], expect[real],
                               atol=KERNEL_TOL, rtol=KERNEL_TOL)


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q = torch.zeros(2, 4, 128, dtype=torch.float16, device=cuda)
    pool = torch.zeros(2, 3, 16, 128, dtype=torch.float16, device=cuda)
    pt = torch.ones(2, 2, dtype=torch.int32, device=cuda)
    lens = torch.ones(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        paged_decode.paged_decode_attention(q, pool, pool, pt, lens)
    qb = torch.zeros(2, 8, 4, 48, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):  # head dim 48 is not instantiated
        flash_prefill.flash_prefill_attention(qb, qb[:, :, :2], qb[:, :, :2],
                                              lens)
    q3 = torch.zeros(2, 32, 8, 128, dtype=torch.bfloat16, device=cuda)
    pool3 = torch.zeros(2, 5, 16, 128, dtype=torch.bfloat16, device=cuda)
    for bad_q, bad_pool in (
        (q3.half(), pool3.half()),  # fp16 is not instantiated
        (q3[:, :24].contiguous(), pool3),  # S not a multiple of ps
        (q3[..., :48].contiguous(), pool3[..., :48].contiguous()),  # hd 48
        (torch.zeros(2, 32, 24, 128, dtype=torch.bfloat16, device=cuda),
         pool3),  # 12 query heads per kv head
        (torch.zeros(2, 48, 8, 128, dtype=torch.bfloat16, device=cuda),
         torch.zeros(2, 5, 24, 128, dtype=torch.bfloat16, device=cuda)),
        # page size 24: no TMA box of whole pages tiles a key tile
    ):
        with pytest.raises(ValueError):
            paged_multitok.paged_multitok_attention(
                bad_q, bad_pool, bad_pool, pt, lens, lens
            )


def _int8_pool(rng, shape, dev, L=None):
    """A QuantPages pool of quantized normal values ([L, ...] with L)."""
    full = shape if L is None else (L, *shape)
    vals = torch.from_numpy(rng.normal(size=full).astype(np.float32))
    q8, s = kv_quant.quantize(vals)
    return kv_quant.QuantPages(q8.to(dev), s.to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("hd,H,KV,kw", [
    (128, 28, 4, {}), (64, 8, 4, {"window": 40}),
    (256, 16, 2, {"softcap": 30.0, "scale": 0.1}),
])
def test_paged_decode_int8_kernel_matches_plain_on_card(cuda, hd, H, KV, kw):
    """K1-int8 on a layer view of [L]-pools: idle slot (length 1 on the
    trash page), unaligned lengths, window and softcap."""
    rng = np.random.default_rng(hd + H)
    B, ps, pps = 6, 16, 8
    P = 1 + B * pps
    k = _int8_pool(rng, (KV, P, ps, hd), cuda, L=2)[1]
    v = _int8_pool(rng, (KV, P, ps, hd), cuda, L=2)[1]
    q = _bf16(rng, (B, H, hd), cuda)
    pt = torch.from_numpy(
        rng.permutation(np.arange(1, P)).reshape(B, pps).astype(np.int32)
    ).to(cuda)
    pt[0] = 0  # an idle slot reads only the trash page
    lens = torch.tensor([1, 15, 16, 17, 100, 128], dtype=torch.int32,
                        device=cuda)
    before = (paged_decode.paged_decode_attention.launches,
              paged_decode.paged_decode_attention_int8.launches)
    got = paged_decode.paged_decode_attention(q, k, v, pt, lens, **kw)
    torch.cuda.synchronize()
    assert (paged_decode.paged_decode_attention.launches,
            paged_decode.paged_decode_attention_int8.launches) == (
        before[0], before[1] + 1)
    window = kw.pop("window", None)
    expect = tatt.paged_decode_attention(q.float(), k, v, pt, lens,
                                         window=window, **kw)
    torch.testing.assert_close(got.float(), expect, atol=KERNEL_TOL,
                               rtol=KERNEL_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(K3_CASES)))
def test_paged_multitok_int8_kernel_matches_plain_on_card(cuda, case):
    hd, H, KV, ps, S, pos0, lens, kw = K3_CASES[case]
    kw = dict(kw)
    rng = np.random.default_rng(44 + case)
    B = len(pos0)
    ctx_pages = -(-(max(pos0) + S) // ps)
    P = 1 + B * ctx_pages
    q = _bf16(rng, (B, S, H, hd), cuda)
    k = _int8_pool(rng, (KV, P, ps, hd), cuda, L=2)[0]
    v = _int8_pool(rng, (KV, P, ps, hd), cuda, L=2)[0]
    pt = torch.from_numpy(
        rng.permutation(np.arange(1, P)).reshape(B, ctx_pages)
        .astype(np.int32)
    ).to(cuda)
    p0 = torch.tensor(pos0, dtype=torch.int32, device=cuda)
    il = torch.tensor(lens, dtype=torch.int32, device=cuda)
    before = (paged_multitok.paged_multitok_attention.launches,
              paged_multitok.paged_multitok_attention_int8.launches)
    got = paged_multitok.paged_multitok_attention(q, k, v, pt, p0, il, **kw)
    torch.cuda.synchronize()
    assert (paged_multitok.paged_multitok_attention.launches,
            paged_multitok.paged_multitok_attention_int8.launches) == (
        before[0], before[1] + 1)
    assert bool(torch.isfinite(got).all())
    window = kw.pop("window", None)
    expect = tatt.paged_suffix_attention(q.float(), k, v, pt, p0, p0 + il,
                                         window=window, **kw)
    real = torch.arange(S, device=cuda)[None, :] < il[:, None]
    torch.testing.assert_close(got.float()[real], expect[real],
                               atol=KERNEL_TOL, rtol=KERNEL_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("rows", [1, 7, 32, 33, 200])
def test_quant_matmul_kernels_match_plain_on_card(cuda, bits, rows):
    """K4/K5 at ragged row counts (split k at small ones), bf16 and f32
    out, against their plain versions on the same inputs."""
    rng = np.random.default_rng(rows + bits)
    in_dim, out = 512, 192
    w = torch.from_numpy(rng.normal(size=(in_dim, out)).astype(np.float32))
    qw = quant.quantize_tensor(w * 0.05, bits)
    qw = type(qw)(*(t.to(cuda) for t in qw))
    x = _bf16(rng, (rows, in_dim), cuda)
    fn, plain, vals = (
        (quant_matmul.int8_matmul, quant_matmul.int8_matmul_plain, qw.q)
        if bits == 8 else
        (quant_matmul.int4_matmul, quant_matmul.int4_matmul_plain,
         qw.q_packed)
    )
    before = fn.launches
    for out_dtype, tol in ((torch.float32, QMM_F32_TOL),
                           (torch.bfloat16, KERNEL_TOL)):
        got = fn(x, vals, qw.scale, out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert got.dtype == out_dtype and got.shape == (rows, out)
        expect = plain(x, vals, qw.scale, out_dtype=torch.float32)
        torch.testing.assert_close(got.float(), expect, atol=tol, rtol=tol)
    assert fn.launches == before + 2
    # weighted_einsum takes the kernel for the decoder's form
    got = quant.weighted_einsum("...d,dh->...h", x[None], qw)
    assert fn.launches == before + 3 and got.shape == (1, rows, out)


@pytest.mark.cuda
def test_quant_matmul_refuses_what_the_kernels_do_not_take(cuda):
    x = torch.zeros(4, 96, dtype=torch.bfloat16, device=cuda)
    q = torch.zeros(96, 128, dtype=torch.int8, device=cuda)  # in % 64
    s = torch.ones(128, device=cuda)
    with pytest.raises(ValueError):
        quant_matmul.int8_matmul(x, q, s)
    x = torch.zeros(4, 128, dtype=torch.bfloat16, device=cuda)
    q = torch.zeros(128, 100, dtype=torch.int8, device=cuda)  # out % 64
    with pytest.raises(ValueError):
        quant_matmul.int8_matmul(x, q, torch.ones(100, device=cuda))
    with pytest.raises(ValueError):  # f16 activations
        quant_matmul.int4_matmul(
            x.half(), torch.zeros(64, 128, dtype=torch.uint8, device=cuda),
            torch.ones(128, device=cuda),
        )
    stacked = quant.quantize_stacked(torch.zeros(2, 128, 64, device=cuda))
    with pytest.raises(ValueError):  # no kernel for a stacked weight
        quant.weighted_einsum("lbd,ldh->lbh", x[None].expand(2, 4, 128),
                              stacked)
