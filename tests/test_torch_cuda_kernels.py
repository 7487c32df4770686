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
K1 and K1-int8 (the tensor-core page split) run on pools whose rows
outside every live range hold NaN (bf16) or NaN scales (int8) and are
held to the plain version on the same pools with those rows cleaned.
The int8 pool modes (K1-int8, K3-int8) are held to the same 1e-2
against the plain version on the dequantized pools.  The dequant matmuls (K4, K5) with f32
out: atol = rtol = 1e-3 — bf16 x int8 products are exact in fp32, so
only the order of a few thousand fp32 additions differs.
"""

import dataclasses

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
@pytest.mark.parametrize("block_slots", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_blocked_decode_splits_long_contexts_on_card(cuda, dtype,
                                                     block_slots):
    """K6's page split: 32 slots with contexts of many chunks, a window
    that starts mid-chunk and mid-page, slots shorter than a chunk and
    one on the trash page; held to the plain version and to K1, and
    bit-identical over three runs (block_slots 1 is K1 itself)."""
    rng = np.random.default_rng(40 + block_slots)
    B, H, KV, hd, ps, pps = 32, 16, 8, 256, 32, 160
    P = 1 + B * pps
    q, k, v = (_bf16(rng, shape, cuda).to(dtype)
               for shape in ((B, H, hd), (KV, P, ps, hd), (KV, P, ps, hd)))
    pt = torch.from_numpy(
        rng.permutation(np.arange(1, P)).reshape(B, pps).astype(np.int32)
    ).to(cuda)
    pt[0] = 0
    lens = torch.tensor(
        [1, 2, 31, 33, 64, 65, 100, 500, 777, 1023, 1024, 1025, 2000, 2047,
         2100, 2500, 3000, 3333, 4000, 4095, 4096, 4097, 4111, 4500, 4600,
         4700, 4800, 4900, 5000, 5050, 5100, 5120],
        dtype=torch.int32, device=cuda)
    kw = {"window": 1500, "softcap": 50.0, "scale": 1 / 16}
    plan = paged_decode.split_plan(B, H, KV, hd, ps, pps, 1500,
                                   max(block_slots, 2), q.element_size(),
                                   torch.cuda.get_device_properties(
                                       cuda).multi_processor_count)
    assert plan.max_chunks > 1  # the long slots split
    got = _thrice(lambda: paged_decode.paged_decode_attention_blocked(
        q, k, v, pt, lens, block_slots=block_slots, **kw))
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


# K3 and K3-int8 at the verify widths of speculative decoding (S = 1 ..
# k + 1 rows a slot, any S >= 1): Qwen2.5-7B's heads (H 28, KV 4, hd 128)
# on pages of 32, rows starting mid-page, ragged contexts, rows past
# input_lens, and the page table padded with trash page 0.
VERIFY_WIDTHS = [1, 2, 3, 4, 5, 7, 8, 9, 130]


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("S", VERIFY_WIDTHS)
def test_paged_multitok_at_verify_widths_on_card(cuda, S, int8):
    hd, H, KV, ps = 128, 28, 4, 32
    rng = np.random.default_rng(90 + S + 7 * int8)
    pos0 = [0, 37, 1000, 5, 2047 - S]
    lens = [S, max(1, S - 1), S, 1, S]
    B = len(pos0)
    ctx_pages = -(-(max(pos0) + S) // ps)
    P = 1 + B * ctx_pages
    q = _bf16(rng, (B, S, H, hd), cuda)
    if int8:
        k = _int8_pool(rng, (KV, P, ps, hd), cuda, L=2)[1]
        v = _int8_pool(rng, (KV, P, ps, hd), cuda, L=2)[1]
        kernel = paged_multitok.paged_multitok_attention_int8
        kf, vf = k, v
    else:
        k = _bf16(rng, (KV, P, ps, hd), cuda)
        v = _bf16(rng, (KV, P, ps, hd), cuda)
        kernel = paged_multitok.paged_multitok_attention
        kf, vf = k.float(), v.float()
    pt = np.concatenate([
        rng.permutation(np.arange(1, P)).reshape(B, ctx_pages),
        np.zeros((B, 2), np.int64),  # the bucketed width's padding
    ], axis=1)
    pt = torch.from_numpy(pt.astype(np.int32)).to(cuda)
    p0 = torch.tensor(pos0, dtype=torch.int32, device=cuda)
    il = torch.tensor(lens, dtype=torch.int32, device=cuda)
    before = kernel.launches
    got = _thrice(lambda: kernel(q, k, v, pt, p0, il))
    assert kernel.launches == before + 3
    assert got.shape == q.shape
    assert bool(torch.isfinite(got).all())  # rows past input_lens too
    expect = tatt.paged_suffix_attention(q.float(), kf, vf, pt, p0, p0 + il)
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
    # the int8 mode: page sizes 4 (a scale run of 8 bytes) and 24 (boxes
    # that do not tile a key tile)
    rng = np.random.default_rng(5)
    for ps in (4, 24):
        q8 = torch.zeros(2, 2 * ps, 8, 128, dtype=torch.bfloat16,
                         device=cuda)
        pool8 = _int8_pool(rng, (2, 5, ps, 128), cuda)
        assert not paged_multitok.tma_page_size(ps, 128, int8=True)
        with pytest.raises(ValueError):
            paged_multitok.paged_multitok_attention(
                q8, pool8, pool8, pt, lens, lens
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
@pytest.mark.parametrize("case", range(len(K3_EDGE_CASES)))
def test_paged_multitok_int8_kernel_tile_edges_on_card(cuda, case):
    """K3-int8 at K3's tile edges, on layer views of int8 pools, each case
    three times bit-identical (the widening barriers)."""
    hd, H, KV, ps, S, pos0, lens, kw, trash = K3_EDGE_CASES[case]
    kw = dict(kw)
    rng = np.random.default_rng(80 + case)
    B = len(pos0)
    ctx_pages = -(-(max(pos0) + S) // ps)
    P = 1 + B * ctx_pages
    q = _bf16(rng, (B, S, H, hd), cuda)
    k = _int8_pool(rng, (KV, P, ps, hd), cuda, L=2)[1]
    v = _int8_pool(rng, (KV, P, ps, hd), cuda, L=2)[1]
    pt = np.concatenate([
        rng.permutation(np.arange(1, P)).reshape(B, ctx_pages),
        np.zeros((B, trash), np.int64),  # the bucketed width's padding
    ], axis=1)
    pt = torch.from_numpy(pt.astype(np.int32)).to(cuda)
    p0 = torch.tensor(pos0, dtype=torch.int32, device=cuda)
    il = torch.tensor(lens, dtype=torch.int32, device=cuda)
    got = _thrice(lambda: paged_multitok.paged_multitok_attention_int8(
        q, k, v, pt, p0, il, **kw))
    assert bool(torch.isfinite(got).all())  # idle rows too
    window = kw.pop("window", None)
    expect = tatt.paged_suffix_attention(q.float(), k, v, pt, p0, p0 + il,
                                         window=window, **kw)
    real = torch.arange(S, device=cuda)[None, :] < il[:, None]
    torch.testing.assert_close(got.float()[real], expect[real],
                               atol=KERNEL_TOL, rtol=KERNEL_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,in_dim,out", [
    (1, 512, 192), (7, 3584, 512), (32, 1024, 576), (33, 512, 640),
    (127, 512, 192), (129, 1024, 448), (2047, 512, 384), (2048, 256, 768),
])
def test_int8_matmul_kernel_ragged_rows_on_card(cuda, rows, in_dim, out):
    """K4 at rows around its 64- and 128-row tiles and widths off its
    128- and 256-column tiles, with the plan the wrapper picks (k splits
    included), bf16 and f32 out, against the plain version."""
    rng = np.random.default_rng(rows + out)
    w = torch.from_numpy(rng.normal(size=(in_dim, out)).astype(np.float32))
    qw = quant.quantize_tensor(w * 0.05, 8)
    qw = type(qw)(*(t.to(cuda) for t in qw))
    x = _bf16(rng, (rows, in_dim), cuda)
    expect = quant_matmul.int8_matmul_plain(x, qw.q, qw.scale,
                                            out_dtype=torch.float32)
    for out_dtype, tol in ((torch.float32, QMM_F32_TOL),
                           (torch.bfloat16, KERNEL_TOL)):
        got = _thrice(lambda: quant_matmul.int8_matmul(
            x, qw.q, qw.scale, out_dtype=out_dtype))
        assert got.dtype == out_dtype and got.shape == (rows, out)
        torch.testing.assert_close(got.float(), expect, atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,in_dim,out", [
    (1, 512, 192), (7, 3584, 512), (32, 3648, 576), (33, 512, 640),
    (127, 3648, 192), (129, 1024, 448), (2047, 512, 384), (2048, 3648, 768),
])
def test_int4_matmul_kernel_ragged_rows_on_card(cuda, rows, in_dim, out):
    """K5 at rows around its 64- and 128-row tiles, widths off its 128-
    and 256-column tiles and an in_dim whose half is an odd number of
    32-row steps (3648: 57), with the plan the wrapper picks, bf16 and
    f32 out, against the plain version; bit-identical over three runs."""
    rng = np.random.default_rng(rows + out + 4)
    w = torch.from_numpy(rng.normal(size=(in_dim, out)).astype(np.float32))
    qw = quant.quantize_tensor(w * 0.05, 4)
    qw = type(qw)(*(t.to(cuda) for t in qw))
    x = _bf16(rng, (rows, in_dim), cuda)
    expect = quant_matmul.int4_matmul_plain(x, qw.q_packed, qw.scale,
                                            out_dtype=torch.float32)
    for out_dtype, tol in ((torch.float32, QMM_F32_TOL),
                           (torch.bfloat16, KERNEL_TOL)):
        got = _thrice(lambda: quant_matmul.int4_matmul(
            x, qw.q_packed, qw.scale, out_dtype=out_dtype))
        assert got.dtype == out_dtype and got.shape == (rows, out)
        torch.testing.assert_close(got.float(), expect, atol=tol, rtol=tol)


@pytest.mark.cuda
def test_engine_refuses_a_page_size_k3_does_not_take(cuda):
    """A CUDA engine at page size 4 with the prefix cache on is refused
    when it is built, not at its first prefix hit."""
    from vgate_tpu_torch.config import NotPortedError, load_config
    from vgate_tpu_torch.runtime.engine_core import EngineCore

    for kv_dtype in ("auto", "int8"):
        cfg = load_config(
            model={"model_id": "tiny-dense", "dtype": "bfloat16",
                   "max_model_len": 64},
            kv_cache={"dtype": kv_dtype},
            device={"device": "cuda", "kv_page_size": 4,
                    "kv_num_pages": 64, "max_batch_slots": 4},
            logging={"level": "WARNING"},
        )
        with pytest.raises(NotPortedError, match="K3"):
            EngineCore(cfg)


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


# K1 and K1-int8, the tensor-core page split: (pool, hd, G, ps) over
# G 1/2/4/7/8, hd 64/128/256, page sizes 16 and 32, and 12 (a scale row
# of 24 bytes: no bulk copy; tiles of 12 rows, not whole m16 steps)
K1_CASES = [(pool, hd, G, ps) for pool in ("bf16", "int8")
            for hd in (64, 128, 256) for G in (1, 2, 4, 7, 8)
            for ps in (16, 32)] + [
    (pool, hd, G, 12) for pool in ("bf16", "int8")
    for hd, G in ((64, 2), (128, 7), (256, 8))]
# per case: query scale, softcap and window (starting mid-chunk and
# mid-page), in turns
K1_KW = [{}, {"window": 300}, {"softcap": 30.0, "scale": 0.1},
         {"window": 100, "softcap": 50.0}]


def _k1_case(case, dev):
    """Six slots: idle (seq_len 0, on the trash page), one token, a
    partial page, past one page, and two of many chunks; every row of a
    slot's pages outside its live range (past seq_len, before the window
    start) holds NaN (bf16) or NaN scales (int8).  Returns the kernel's
    inputs, the same pools with those rows cleaned (zeros, scale 0) for
    the plain version, the lengths and the kwargs."""
    pool, hd, G, ps = K1_CASES[case]
    kw = dict(K1_KW[case % len(K1_KW)])
    rng = np.random.default_rng(100 + case)
    B, KV = 6, 2
    pps = -(-1300 // ps)
    P = 1 + B * pps
    lens = [0, 1, ps - 3, ps + 5, 777, pps * ps]
    q = _bf16(rng, (B, KV * G, hd), dev)
    pt_np = rng.permutation(np.arange(1, P)).reshape(B, pps).astype(np.int32)
    pt_np[0] = 0
    stale = np.zeros((P, ps), bool)  # (page, row) outside a live range
    for b, n in enumerate(lens):
        lo = max(n - kw["window"], 0) if "window" in kw else 0
        for pos in range(pps * ps):
            if not lo <= pos < n:
                stale[pt_np[b, pos // ps], pos % ps] = True
    for b, n in enumerate(lens):  # a live row on a shared page stays live
        lo = max(n - kw["window"], 0) if "window" in kw else 0
        for pos in range(lo, n):
            stale[pt_np[b, pos // ps], pos % ps] = False
    mask = torch.from_numpy(stale).to(dev)
    pt = torch.from_numpy(pt_np).to(dev)
    sl = torch.tensor(lens, dtype=torch.int32, device=dev)
    if pool == "bf16":
        k, v = (_bf16(rng, (KV, P, ps, hd), dev) for _ in range(2))
        clean = [t.masked_fill(mask[None, :, :, None], 0.0) for t in (k, v)]
        for t in (k, v):
            t.masked_fill_(mask[None, :, :, None], float("nan"))
    else:
        k, v = (_int8_pool(rng, (KV, P, ps, hd), dev) for _ in range(2))
        clean = [kv_quant.QuantPages(t.data, t.scale.masked_fill(
            mask[None], 0.0)) for t in (k, v)]
        for t in (k, v):
            t.scale.masked_fill_(mask[None], float("nan"))
    return q, k, v, clean, pt, sl, kw


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(K1_CASES)))
def test_k1_tensor_core_split_on_card(cuda, case):
    """K1 / K1-int8 against the plain version on the cleaned pools, three
    runs bit-identical; the idle slot comes out finite; the right counter
    counts each launch."""
    pool = K1_CASES[case][0]
    q, k, v, (kc, vc), pt, sl, kw = _k1_case(case, cuda)
    fn = (paged_decode.paged_decode_attention if pool == "bf16"
          else paged_decode.paged_decode_attention_int8)
    before = fn.launches
    got = _thrice(lambda: paged_decode.paged_decode_attention(
        q, k, v, pt, sl, **kw))
    assert fn.launches == before + 3
    assert bool(torch.isfinite(got).all())
    window = kw.pop("window", None)
    expect = tatt.paged_decode_attention(q.float(), kc, vc, pt, sl,
                                         window=window, **kw)
    live = sl > 0
    torch.testing.assert_close(got.float()[live], expect[live],
                               atol=KERNEL_TOL, rtol=KERNEL_TOL)



# ------------------------------------------------------- decode graphs

# tiny-dense widened to a head dim the kernels take (K1 and K2: 64, 128,
# 256; K4: widths in 64s): 2 layers, 4 query heads on 2 kv heads
CARD_SPEC = dict(hidden_size=256, num_heads=4, num_kv_heads=2,
                 head_dim=64, intermediate_size=256)


def _card_engine(kv_dtype="auto", block_slots=1, quantization=None,
                 decode_graphs=True, kv_num_pages=96, host_swap_bytes=0):
    import dataclasses

    from vgate_tpu_torch.config import load_config
    from vgate_tpu_torch.models.specs import TINY_DENSE
    from vgate_tpu_torch.runtime.engine_core import EngineCore

    cfg = load_config(
        model={"model_id": "tiny-dense", "dtype": "bfloat16",
               "max_model_len": 256, "quantization": quantization},
        kv_cache={"dtype": kv_dtype, "host_swap_bytes": host_swap_bytes},
        device={"device": "cuda", "kv_page_size": 16,
                "kv_num_pages": kv_num_pages,
                "max_batch_slots": 4, "prefill_buckets": [32, 64, 128],
                "prefix_cache": False, "decode_block_slots": block_slots},
        logging={"level": "WARNING"},
    )
    return EngineCore(cfg, spec=dataclasses.replace(TINY_DENSE, **CARD_SPEC),
                      decode_graphs=decode_graphs)


def _drive(core, requests):
    """Queue every request, then drive the engine's tick (no thread)."""
    from vgate_tpu_torch.backends.base import SamplingParams

    seqs = [core.submit_tokens(list(p), SamplingParams(**kw))
            for p, kw in requests]
    for _ in range(10_000):
        if all(s.done_event.is_set() for s in seqs):
            break
        core._tick()
    assert all(s.done_event.is_set() for s in seqs)
    torch.cuda.synchronize()
    return seqs


def _card_requests(seed, logprobs=True):
    """Six requests on four slots: greedy ones of 9..20 tokens, a seeded
    sampled one, and (with ``logprobs``) a greedy one asking for the top
    5 logprobs."""
    rng = np.random.default_rng(seed)
    prompt = lambda n: rng.integers(3, 500, size=n).tolist()  # noqa: E731
    greedy = dict(temperature=0.0)
    reqs = [(prompt(5), dict(max_tokens=20, **greedy)),
            (prompt(40), dict(max_tokens=13, **greedy)),
            (prompt(17), dict(max_tokens=9, **greedy)),
            (prompt(90), dict(max_tokens=17, temperature=0.8, top_p=0.9,
                              seed=11)),
            (prompt(3), dict(max_tokens=11, **greedy))]
    if logprobs:
        reqs.append((prompt(25), dict(max_tokens=15, logprobs=True,
                                      top_logprobs=5, **greedy)))
    return reqs


DECODE_WRAPPERS = {
    "K1": paged_decode.paged_decode_attention,
    "K1-int8": paged_decode.paged_decode_attention_int8,
    "K6": paged_decode.paged_decode_attention_blocked,
    "K4": quant_matmul.int8_matmul,
    "K5": quant_matmul.int4_matmul,
    "K2": flash_prefill.flash_prefill_attention,
}


def _served(core, requests, decode: str, quantized: bool):
    """Serve ``requests``; check the launches of every decode kernel and
    K2 are exact for the steps and prompt passes the engine counted."""
    before = {k: w.launches for k, w in DECODE_WRAPPERS.items()}
    stats0 = core.get_stats()
    seqs = _drive(core, requests)
    stats = core.get_stats()
    steps = stats["steps"] - stats0["steps"]
    passes = stats["prompt_passes"] - stats0["prompt_passes"]
    L = core.spec.num_layers
    got = {k: w.launches - before[k] for k, w in DECODE_WRAPPERS.items()}
    expect = {k: 0 for k in got}
    expect[decode] = L * steps
    expect["K2"] = L * passes
    if quantized:
        expect["K4"] = (7 * L + 1) * (steps + passes)
    assert steps > 0 and got == expect
    assert stats["used_pages"] == 0
    return seqs


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype,block_slots,quantization,decode", [
    ("auto", 1, None, "K1"),
    ("int8", 1, None, "K1-int8"),
    ("auto", 2, None, "K6"),
    ("int8", 2, None, "K1-int8"),  # K6 takes no int8 pools
    ("int8", 1, "int8", "K1-int8"),
])
def test_decode_graphs_match_the_eager_chunk_on_card(
        cuda, kv_dtype, block_slots, quantization, decode):
    """One engine serves the same requests with each chunk a graph
    replay, then with the same body eager: the greedy rows, the seeded
    sampled row and the logprobs row's top ids are identical, and every
    run's launch counts are exact (a replay counts its capture's
    launches; the warm-up and the capture count none)."""
    core = _card_engine(kv_dtype, block_slots, quantization)
    requests = _card_requests(block_slots + len(kv_dtype))
    runs = {}
    try:
        for graphs in (True, False):
            core.decode_graphs = graphs
            runs[graphs] = _served(core, requests, decode,
                                   quantization is not None)
        assert core.get_stats()["decode_graphs"]["captured"] >= 1
    finally:
        core.stop()
    for g, e in zip(runs[True], runs[False]):
        assert g.generated_ids == e.generated_ids
    g, e = runs[True][-1], runs[False][-1]
    assert [[i for i, _ in t] for _, t in g.logprob_data] == [
        [i for i, _ in t] for _, t in e.logprob_data]
    np.testing.assert_allclose([lp for lp, _ in g.logprob_data],
                               [lp for lp, _ in e.logprob_data],
                               atol=KERNEL_TOL, rtol=0)


@pytest.mark.cuda
def test_decode_graph_keys_replay_in_turns_on_card(cuda):
    """An all-greedy wave captures its keys, a wave with a logprobs row
    captures others; replayed in turns, both waves repeat every token and
    logprob, and nothing is captured again."""
    core = _card_engine()
    greedy = _card_requests(5, logprobs=False)[:3] + _card_requests(
        5, logprobs=False)[4:]
    mixed = _card_requests(6)
    try:
        first = [_served(core, greedy, "K1", False)]
        n_greedy = core.get_stats()["decode_graphs"]["captured"]
        first.append(_served(core, mixed, "K1", False))
        captured = core.get_stats()["decode_graphs"]["captured"]
        assert captured > n_greedy >= 1
        for _ in range(2):
            for wave, reqs in zip(first, (greedy, mixed)):
                again = _served(core, reqs, "K1", False)
                for a, b in zip(wave, again):
                    assert a.generated_ids == b.generated_ids
                    assert a.logprob_data == b.logprob_data
        assert core.get_stats()["decode_graphs"]["captured"] == captured
    finally:
        core.stop()


@pytest.mark.cuda
def test_workspace_refuses_to_grow_during_a_capture(cuda):
    """The kernels' shared scratch is sized before a capture; a call that
    would grow it inside one raises (the graph would keep addressing the
    freed block)."""
    from vgate_tpu_torch.ops.kernels import _build

    stream = torch.cuda.Stream()
    handle = stream.cuda_stream
    sized = _build.workspace(cuda, handle, 1024)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        assert _build.workspace(cuda, handle, 512) is sized
        sized.zero_()
        with pytest.raises(RuntimeError, match="during a CUDA graph capture"):
            _build.workspace(cuda, handle, 1 << 20)
    assert _build.workspace(cuda, handle, 1 << 20).numel() == 1 << 20


@pytest.mark.cuda
def test_graph_replays_draw_new_noise_from_the_engine_generator(cuda):
    """The capture registers the sampling generator with each graph: every
    replay draws new noise (as eager calls do), the same seed replays the
    same sequence, and eager draws between replays still advance it."""
    from vgate_tpu_torch.runtime.decode_graph import CudaCapture

    def draws(seed):
        gen = torch.Generator(device=cuda)
        gen.manual_seed(seed)
        out = torch.zeros(4, device=cuda, dtype=torch.float64)

        def body():
            out.copy_(torch.rand(4, generator=gen, device=cuda,
                                 dtype=torch.float64))

        cap = CudaCapture(cuda, gen)
        cap.warmup(body)
        graph = cap.capture(body)
        seen = []
        for i in range(3):
            graph.replay()
            seen.append(out.clone())
            if i == 1:
                seen.append(torch.rand(4, generator=gen, device=cuda,
                                       dtype=torch.float64))
        return torch.stack(seen).cpu()

    a = draws(1)
    assert len({tuple(r.tolist()) for r in a}) == len(a)
    torch.testing.assert_close(a, draws(1), atol=0, rtol=0)


# ------------------------------------------------- warm-up and host swap


@pytest.mark.cuda
def test_burst_after_warmup_captures_no_graph_on_card(cuda):
    """The warm-up captures the keys of a greedy and sampled burst: the
    burst that follows replays them and captures none."""
    core = _card_engine()
    try:
        assert core.warmup() > 0
        captured = core.get_stats()["decode_graphs"]["captured"]
        assert captured >= 2  # greedy and sampled chunk descents
        _served(core, _card_requests(7, logprobs=False), "K1", False)
        stats = core.get_stats()
        assert stats["decode_graphs"]["captured"] == captured
        assert stats["decode_graphs"]["replays"] == stats["chunks"]
    finally:
        core.stop()


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, "int8"],
                         ids=["bf16", "int8"])
def test_swap_round_trip_with_the_payload_freed_at_once_on_card(
        cuda, kv_dtype):
    """Pages swapped out to pinned memory and into other pages come back
    bit for bit, in place.  The payload is dropped as soon as the swap-in
    is enqueued (behind a sleeping kernel, so its copies have not run)
    and pinned blocks of the same sizes are taken and overwritten at
    once, then a second swap-out runs: the caching host allocator must
    not hand out a block whose copy is still pending."""
    import types

    from vgate_tpu_torch.runtime.engine_core import _DeviceSwapExecutor

    rng = np.random.default_rng(3)
    shape = (2, 2, 64, 16, 64)
    if kv_dtype == "int8":
        k, v = (_int8_pool(rng, shape[1:], cuda, L=shape[0])
                for _ in range(2))
        parts = [k.data, k.scale, v.data, v.scale]
    else:
        k, v = (_bf16(rng, shape, cuda) for _ in range(2))
        parts = [k, v]
    ex = _DeviceSwapExecutor(types.SimpleNamespace(
        k_pages=k, v_pages=v, device=cuda))
    ptrs = [t.data_ptr() for t in parts]
    src, dst = list(range(1, 18)), list(range(63, 46, -1))
    expect = [t[:, :, src].clone() for t in parts]
    payload = ex.read_pages(src)
    sizes = [(p.shape, p.dtype) for chunk in payload for p in chunk]
    assert all(p.is_pinned() for chunk in payload for p in chunk)
    for t in parts:
        t[:, :, dst] = 0
    torch.cuda._sleep(200_000_000)
    ex.write_pages(dst, payload)
    del payload
    taken = [torch.empty(shape, dtype=dtype, pin_memory=True)
             for shape, dtype in sizes]
    for t in taken:
        t.view(torch.uint8).fill_(0x5A)
    again = ex.read_pages(list(range(20, 37)))
    torch.cuda.synchronize()
    assert [t.data_ptr() for t in parts] == ptrs
    for t, e in zip(parts, expect):
        assert torch.equal(t[:, :, dst].contiguous().view(torch.uint8),
                           e.contiguous().view(torch.uint8))
    assert len(again) == 2 and len(taken) == len(sizes)


@pytest.mark.cuda
def test_graphed_decode_after_swap_in_matches_the_eager_chunk_on_card(cuda):
    """A squeezed pool with the host swap tier on: sequences preempted,
    parked in pinned memory and swapped back in decode through graph
    replays to the same tokens as the eager chunk body, with zero
    recompute, and launch counts exact."""
    core = _card_engine(kv_num_pages=20, host_swap_bytes=1 << 26)
    rng = np.random.default_rng(9)
    requests = [(rng.integers(3, 500, size=40).tolist(),
                 dict(max_tokens=60, min_tokens=60, temperature=0.0))
                for _ in range(4)]
    runs = {}
    try:
        for graphs in (True, False):
            core.decode_graphs = graphs
            stats0 = core.get_stats()["scheduler"]
            runs[graphs] = _served(core, requests, "K1", False)
            sched = core.get_stats()["scheduler"]
            preempts = sched["preemptions"] - stats0["preemptions"]
            swapped = sched["swap_preempts"] - stats0["swap_preempts"]
            assert preempts > 0 and swapped == preempts
            assert sched["preempt_recompute_tokens"] == 0
        stats = core.get_stats()
        assert stats["kv_swap"]["swap_in_pages"]["preempt"] > 0
        assert stats["kv_swap"]["used_bytes"] == 0
    finally:
        core.stop()
    for g, e in zip(runs[True], runs[False]):
        assert g.generated_ids == e.generated_ids


# ------------------------------------------------- integrity (item 7)

# (dtype, elements, start offset in elements): lengths that are not a
# multiple of the 16-byte vector or of the block, starts off the 16-byte
# boundary, and a 1 GiB bf16 leaf (512 Mi elements: a 7B embedding is
# 1.09 GB)
DIGEST_CASES = [
    (torch.float32, 1, 0), (torch.float32, 5, 1), (torch.float32, 4099, 3),
    (torch.bfloat16, 7, 0), (torch.bfloat16, 65521 * 3 + 5, 1),
    (torch.bfloat16, (1 << 20) + 9, 0), (torch.int8, 33, 0),
    (torch.int8, 1_000_003, 5), (torch.uint8, 257, 2),
    (torch.bfloat16, 1 << 29, 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(DIGEST_CASES)))
def test_leaf_digest_kernel_matches_plain_on_card(cuda, case):
    """The digest kernel equals its plain version on the same leaf, bit
    for bit (a wrapping uint32 sum: no tolerance), and a small leaf's
    digest equals the host digest of its copy."""
    from vgate_tpu_torch import integrity
    from vgate_tpu_torch.ops.kernels import leaf_digest as ld

    dtype, n, offset = DIGEST_CASES[case]
    gen = torch.Generator(device=cuda)
    gen.manual_seed(case)
    if dtype.is_floating_point:
        base = torch.randn(n + offset, generator=gen, device=cuda,
                           dtype=torch.float32).to(dtype)
    else:
        base = torch.randint(0, 256, (n + offset,), generator=gen,
                             device=cuda, dtype=torch.int32).to(torch.uint8)
        base = base.view(dtype)
    leaf = base[offset:]
    before = ld.leaf_digest.launches
    got = ld.leaf_digest(leaf)
    assert ld.leaf_digest.launches == before + 1
    assert got == ld.leaf_digest_plain(leaf)
    if n <= (1 << 21):
        assert got == integrity.host_leaf_digest(leaf.cpu())
    # into a device word, with no readback
    word = torch.zeros(1, dtype=torch.int32, device=cuda)
    assert ld.leaf_digest(leaf, out=word) is None
    assert int(word.item()) & 0xFFFFFFFF == got


@pytest.mark.cuda
def test_guard_flags_of_a_graph_replay_equal_the_eager_chunk_on_card(cuda):
    """The guard word each decode step writes inside the captured graph
    equals the eager chunk's on the same requests.  The saturation
    threshold is 0, so every word has its saturated bit (a graph that did
    not write them would leave zeros), and the scan's verdicts are
    recorded instead of raised."""
    core = _card_engine()
    core.config.integrity.saturate_threshold = 0.0
    words = {}

    def record(sampled, flags, rows, chunk):
        words.setdefault(core.decode_graphs, []).append(flags.copy())
        return []

    core.integrity.scan_decode = record
    requests = _card_requests(13, logprobs=False)
    try:
        runs = {}
        for graphs in (True, False):
            core.decode_graphs = graphs
            runs[graphs] = _served(core, requests, "K1", False)
    finally:
        core.stop()
    assert len(words[True]) == len(words[False]) > 0
    for g, e in zip(words[True], words[False]):
        np.testing.assert_array_equal(g, e)
    assert any(w.any() for w in words[True])
    for g, e in zip(runs[True], runs[False]):
        assert g.generated_ids == e.generated_ids


@pytest.mark.cuda
def test_rebuild_core_returns_memory_on_card(cuda):
    """A supervised rebuild gives back everything the old core held on
    the card but its weights: with both cores warmed and serving on
    their own threads, ``memory_allocated`` after the rebuild is within
    1 % of its value before, and the new pool has the old pool's pages."""
    import gc

    from vgate_tpu_torch.backends.base import SamplingParams
    from vgate_tpu_torch.runtime.engine_core import rebuild_core

    # the cuBLAS workspaces of the earlier tests' streams go first, as a
    # rebuild drops them all, so both counts hold this engine's alone
    torch._C._cuda_clearCublasWorkspaces()
    gc.collect()
    torch.cuda.empty_cache()
    core = _card_engine(kv_num_pages=20000)
    params = [SamplingParams(max_tokens=24, temperature=0.0)] * 4
    prompts = ["a b c", "d e f g", "h", "i j"]
    core.start()
    try:
        core.warmup()
        first = core.generate(prompts, params)
        torch.cuda.synchronize()
        gc.collect()
        before = torch.cuda.memory_allocated()
        pages = core.geometry.num_pages
        new = rebuild_core(core, core.config)
        new.start()
        again = new.generate(prompts, params)
        torch.cuda.synchronize()
        gc.collect()
        after = torch.cuda.memory_allocated()
        assert new.geometry.num_pages == pages
        assert abs(after - before) <= 0.01 * before, (before, after)
        assert [r["token_ids"] for r in again] == [
            r["token_ids"] for r in first]
        assert new.get_stats()["decode_graphs"]["captured"] >= 1
        new.stop()
    finally:
        core.stop()


# ------------------------------------------------- MoE experts and W8A8


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("C", [1, 16, 130])
def test_expert_einsum_runs_k4_k5_one_expert_at_a_time_on_card(cuda, bits,
                                                              C):
    """Quantized expert weights ``[E, in, out]``: ``_expert_einsum``
    launches K4 (int8) or K5 (int4) once an expert, on that expert's 2D
    weight and ``[out]`` scale, and equals the plain version of the same
    kernel on each expert's rows."""
    from vgate_tpu_torch.models import decoder as dec

    rng = np.random.default_rng(bits * 100 + C)
    E, D, F = 4, 256, 512
    w = torch.from_numpy(
        rng.normal(size=(1, E, D, F)).astype(np.float32) * 0.02).to(cuda)
    qw = quant.quantize_expert_stacked(w, bits)
    qw = type(qw)(*(part[0] for part in qw))
    x = _bf16(rng, (E, C, D), cuda)
    wrapper = quant_matmul.int8_matmul if bits == 8 else quant_matmul.int4_matmul
    plain = (quant_matmul.int8_matmul_plain if bits == 8
             else quant_matmul.int4_matmul_plain)
    before = wrapper.launches
    got = dec._expert_einsum("ecd,edf->ecf", x, qw)
    torch.cuda.synchronize()
    assert wrapper.launches == before + E
    assert got.shape == (E, C, F) and got.dtype == torch.bfloat16
    for e in range(E):
        expect = plain(x[e], qw[0][e], qw.scale[e], out_dtype=torch.float32)
        torch.testing.assert_close(got[e].float(), expect, atol=KERNEL_TOL,
                                   rtol=KERNEL_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 7, 16, 17, 32, 200])
def test_int8_product_matches_the_plain_int32_product_on_card(cuda, rows):
    """``int8_mm`` (``torch._int_mm`` with rows padded past 16), on a
    row-major weight and on one in ``k_major`` layout, equals the exact
    int32 product on the CPU, and the W8A8 and W4A8 partials
    and the weight quantizers on the card equal theirs on the CPU bit
    for bit."""
    rng = np.random.default_rng(rows)
    xq = torch.from_numpy(
        rng.integers(-127, 128, (rows, 512)).astype(np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (512, 384)).astype(np.int8))
    exact = xq.to(torch.int32) @ wq.to(torch.int32)
    got = quant.int8_mm(xq.to(cuda), wq.to(cuda))
    assert got.dtype == torch.int32 and got.shape == (rows, 384)
    assert torch.equal(got.cpu(), exact)
    # the W8A8 layout (the contracted dim contiguous)
    wk = wq.t().contiguous().t().to(cuda)
    assert torch.equal(quant.int8_mm(xq.to(cuda), wk).cpu(), exact)
    x = torch.from_numpy(rng.normal(size=(rows, 512)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(512, 384)).astype(np.float32))
    for bits in (8, 4):
        qw = quant.quantize_tensor(w, bits)
        on_card = quant.int8_native_partial(
            "...d,dh->...h", x.to(cuda), type(qw)(*(p.to(cuda) for p in qw)))
        assert torch.equal(on_card.cpu(),
                           quant.int8_native_partial("...d,dh->...h", x, qw))
    with pytest.raises(ValueError):
        quant.int8_mm(xq[:, :500].contiguous().to(cuda), wq[:500].to(cuda))
    # the quantizers divide as the reference does, on the card too
    for bits in (8, 4):
        for on_card, on_cpu in (
                (quant.quantize_tensor(w.to(cuda), bits),
                 quant.quantize_tensor(w, bits)),
                (quant.quantize_expert_stacked(w.reshape(2, 2, 128, 384)
                                               .to(cuda), bits),
                 quant.quantize_expert_stacked(w.reshape(2, 2, 128, 384),
                                               bits))):
            for a, b in zip(on_card, on_cpu):
                assert torch.equal(a.cpu(), b)


def _moe_card_engine(quantization, int8_native=False, decode_graphs=True):
    """A ``tiny-moe`` engine widened as ``CARD_SPEC`` with 8 experts
    (top 2: its decode steps and prompt passes drop tokens)."""
    import dataclasses

    from vgate_tpu_torch.config import load_config
    from vgate_tpu_torch.models.specs import TINY_MOE
    from vgate_tpu_torch.runtime.engine_core import EngineCore

    cfg = load_config(
        model={"model_id": "tiny-moe", "dtype": "bfloat16",
               "max_model_len": 256, "quantization": quantization},
        device={"device": "cuda", "kv_page_size": 16, "kv_num_pages": 96,
                "max_batch_slots": 4, "prefill_buckets": [32, 64, 128],
                "prefix_cache": False, "int8_native": int8_native},
        logging={"level": "WARNING"},
    )
    spec = dataclasses.replace(TINY_MOE, num_experts=8, **CARD_SPEC)
    return EngineCore(cfg, spec=spec, decode_graphs=decode_graphs)


@pytest.mark.cuda
@pytest.mark.parametrize("quantization,int8_native", [
    (None, False), ("int8", False), ("int4", False), ("int8", True),
])
def test_moe_decode_graphs_match_the_eager_chunk_on_card(cuda, quantization,
                                                         int8_native):
    """A MoE engine's decode chunks captured as graphs (the dispatch
    inside: sort, scatter, per-expert products, combine) repeat the same
    body run eagerly token for token; the launches are exact: K1 once a
    layer a step, K2 once a layer a prompt pass, and the dequant matmul
    4 + 3 x 8 times a layer plus the lm_head a pass (only the lm_head
    with ``int8_native``)."""
    core = _moe_card_engine(quantization, int8_native)
    requests = _card_requests(41, logprobs=False)
    wrappers = {"K1": paged_decode.paged_decode_attention,
                "K2": flash_prefill.flash_prefill_attention,
                "K4": quant_matmul.int8_matmul,
                "K5": quant_matmul.int4_matmul}
    L, E = core.spec.num_layers, core.spec.num_experts
    per_pass = 1 if int8_native else (4 + 3 * E) * L + 1
    mm = {"int8": "K4", "int4": "K5"}.get(quantization)
    runs = {}
    try:
        for graphs in (True, False):
            core.decode_graphs = graphs
            before = {k: w.launches for k, w in wrappers.items()}
            stats0 = core.get_stats()
            runs[graphs] = _drive(core, requests)
            stats = core.get_stats()
            steps = stats["steps"] - stats0["steps"]
            passes = stats["prompt_passes"] - stats0["prompt_passes"]
            got = {k: w.launches - before[k] for k, w in wrappers.items()}
            expect = {"K1": L * steps, "K2": L * passes, "K4": 0, "K5": 0}
            if mm:
                expect[mm] = per_pass * (steps + passes)
            assert steps > 0 and got == expect
            assert stats["used_pages"] == 0
        assert core.get_stats()["decode_graphs"]["captured"] >= 1
    finally:
        core.stop()
    for g, e in zip(runs[True], runs[False]):
        assert g.generated_ids == e.generated_ids


# --------------------------------------------------------------- the pod


@pytest.mark.cuda
def test_pod_with_a_handoff_streams_as_the_in_process_engine(cuda):
    """Two worker processes on the card, each in its own CUDA context,
    ``pod.roles`` [prefill, decode], Qwen2.5-0.5B (random weights, seed
    0): each prompt prefills on worker 0, its KV crosses to worker 1,
    and the greedy streams equal an in-process engine's on the same
    weights.  One prompt a pass (``prefill_batch_max`` 1), so a stream
    depends on its prompt alone."""
    from vgate_tpu_torch.backends.base import SamplingParams
    from vgate_tpu_torch.config import load_config
    from vgate_tpu_torch.runtime.engine_core import EngineCore
    from vgate_tpu_torch.runtime.pod_engine import PodEngine

    def config(**pod):
        return load_config(
            model={"model_id": "Qwen/Qwen2.5-0.5B-Instruct",
                   "dtype": "bfloat16", "max_model_len": 256},
            device={"device": "cuda", "kv_page_size": 16,
                    "max_batch_slots": 4, "prefill_buckets": [32, 64, 128],
                    "prefill_batch_max": 1},
            logging={"level": "WARNING"}, pod=pod,
        )

    rng = np.random.default_rng(43)
    prompts = [rng.integers(3, 5000, size=n).tolist() for n in (9, 40, 70)]
    params = SamplingParams(max_tokens=12, temperature=0.0)
    core = EngineCore(config())
    try:
        want = [s.generated_ids for s in _drive(
            core, [(p, dict(max_tokens=12, temperature=0.0))
                   for p in prompts])]
    finally:
        core.stop()
    del core
    torch.cuda.empty_cache()
    pod = PodEngine(config(workers=2, roles=["prefill", "decode"]))
    pod.start()
    try:
        got = []
        for p in prompts:
            seq = pod.submit_tokens(p, params)
            assert seq.done_event.wait(300)
            got.append(list(seq.generated_ids))
        assert got == want
        handoffs = pod.get_stats()["pod"]["handoffs"]
        assert handoffs["completed"] == len(prompts), handoffs
        launches = {w.idx: w.client.call("stats")["kernel_launches"]
                    for w in pod.workers}
        assert launches[0]["flash_prefill_attention"] > 0
        assert launches[1]["paged_decode_attention"] > 0
    finally:
        pod.stop()


# ----------------------------------------------- tp shard shapes (item 10a)

# a tp rank's heads of Qwen2.5-7B (28 query heads, 4 kv heads): 14/2 at
# tp 2, 7/1 at tp 4; ragged decode contexts 1..2048 on pages of 32
TP_DECODE_LENS = [1, 31, 32, 33, 64, 65, 100, 127, 128, 129, 255, 256, 257,
                  300, 511, 512, 513, 700, 1000, 1023, 1024, 1025, 1200,
                  1500, 1535, 1536, 1600, 1800, 2000, 2047, 2048, 2048]


@pytest.mark.cuda
@pytest.mark.parametrize("H,KV", [(14, 2), (7, 1)], ids=["tp2", "tp4"])
def test_k1_at_a_tp_ranks_heads_on_card(cuda, H, KV):
    """K1 at B 32, hd 128, pages of 32 and contexts 1..2048 on one rank's
    heads, against the plain version."""
    rng = np.random.default_rng(41)
    B, hd, ps, pps = 32, 128, 32, 64
    P = 1 + B * pps
    q = _bf16(rng, (B, H, hd), cuda)
    k = _bf16(rng, (KV, P, ps, hd), cuda)
    v = _bf16(rng, (KV, P, ps, hd), cuda)
    pt = torch.from_numpy(
        rng.permutation(np.arange(1, P)).reshape(B, pps).astype(np.int32)
    ).to(cuda)
    lens = torch.tensor(TP_DECODE_LENS, dtype=torch.int32, device=cuda)
    before = paged_decode.paged_decode_attention.launches
    got = _thrice(lambda: paged_decode.paged_decode_attention(q, k, v, pt,
                                                              lens))
    assert paged_decode.paged_decode_attention.launches == before + 3
    expect = tatt.paged_decode_attention(q.float(), k.float(), v.float(),
                                         pt, lens)
    torch.testing.assert_close(got.float(), expect, atol=KERNEL_TOL,
                               rtol=KERNEL_TOL)


@pytest.mark.cuda
def test_k2_at_a_tp_ranks_heads_on_card(cuda):
    """K2 at B 2, S 1024 on one tp=2 rank's 14/2 heads."""
    rng = np.random.default_rng(42)
    B, S, H, KV, hd = 2, 1024, 14, 2, 128
    q = _bf16(rng, (B, S, H, hd), cuda)
    k = _bf16(rng, (B, S, KV, hd), cuda)
    v = _bf16(rng, (B, S, KV, hd), cuda)
    lens = torch.tensor([1024, 777], dtype=torch.int32, device=cuda)
    before = flash_prefill.flash_prefill_attention.launches
    got = flash_prefill.flash_prefill_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert flash_prefill.flash_prefill_attention.launches == before + 1
    expect = tatt.flash_prefill_attention(q.float(), k.float(), v.float(),
                                          lens)
    real = torch.arange(S, device=cuda)[None, :] < lens[:, None]
    torch.testing.assert_close(got.float()[real], expect[real],
                               atol=KERNEL_TOL, rtol=KERNEL_TOL)


@pytest.mark.cuda
def test_k3_at_a_tp_ranks_heads_on_card(cuda):
    """K3 at B 4, S 512 over a 1,024-token prefix on one tp=2 rank's 14/2
    heads, pages of 32."""
    rng = np.random.default_rng(43)
    B, S, H, KV, hd, ps, prefix = 4, 512, 14, 2, 128, 32, 1024
    ctx_pages = (prefix + S) // ps
    P = 1 + B * ctx_pages
    q = _bf16(rng, (B, S, H, hd), cuda)
    k = _bf16(rng, (KV, P, ps, hd), cuda)
    v = _bf16(rng, (KV, P, ps, hd), cuda)
    pt = torch.from_numpy(
        rng.permutation(np.arange(1, P)).reshape(B, ctx_pages)
        .astype(np.int32)
    ).to(cuda)
    p0 = torch.full((B,), prefix, dtype=torch.int32, device=cuda)
    il = torch.tensor([512, 512, 300, 1], dtype=torch.int32, device=cuda)
    before = paged_multitok.paged_multitok_attention.launches
    got = paged_multitok.paged_multitok_attention(q, k, v, pt, p0, il)
    torch.cuda.synchronize()
    assert paged_multitok.paged_multitok_attention.launches == before + 1
    expect = tatt.paged_suffix_attention(q.float(), k.float(), v.float(),
                                         pt, p0, p0 + il)
    real = torch.arange(S, device=cuda)[None, :] < il[:, None]
    torch.testing.assert_close(got.float()[real], expect[real],
                               atol=KERNEL_TOL, rtol=KERNEL_TOL)


# ------------------------------------- ep and quantized shards (item 10c)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [16, 130])
def test_k4_on_an_ep_ranks_expert_shard_on_card(cuda, C):
    """An ep=2 rank's half of 8 int8 experts (quantized whole, then
    sharded): ``_expert_einsum`` launches K4 once a local expert and
    equals the plain version on each."""
    from vgate_tpu_torch.models import decoder as dec
    from vgate_tpu_torch.models.specs import TINY_MOE
    from vgate_tpu_torch.parallel.mesh import Mesh, MeshPlan
    from vgate_tpu_torch.parallel.sharding import shard_leaf

    rng = np.random.default_rng(200 + C)
    E, D, F = 8, 256, 512
    spec = dataclasses.replace(TINY_MOE, num_experts=E, hidden_size=D,
                               intermediate_size=F)
    w = torch.from_numpy(
        rng.normal(size=(1, E, D, F)).astype(np.float32) * 0.02).to(cuda)
    full = quant.quantize_expert_stacked(w, 8)
    mesh = Mesh(MeshPlan(1, 1, 2, 1, 1), ["cpu", "cpu"], rank=1)
    shard = shard_leaf(("layers", "gate", "w"), full, spec, mesh)
    assert shard.q.shape == (1, E // 2, D, F)
    torch.testing.assert_close(shard.scale, full.scale[:, E // 2:])
    qw = type(shard)(*(part[0] for part in shard))
    x = _bf16(rng, (E // 2, C, D), cuda)
    before = quant_matmul.int8_matmul.launches
    got = dec._expert_einsum("ecd,edf->ecf", x, qw)
    torch.cuda.synchronize()
    assert quant_matmul.int8_matmul.launches == before + E // 2
    for e in range(E // 2):
        expect = quant_matmul.int8_matmul_plain(x[e], qw.q[e], qw.scale[e],
                                                out_dtype=torch.float32)
        torch.testing.assert_close(got[e].float(), expect, atol=KERNEL_TOL,
                                   rtol=KERNEL_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 32, 200])
def test_k5_on_repacked_row_parallel_shards_on_card(cuda, rows):
    """A down projection quantized to int4 whole, then split over tp=2
    by rows (each shard repacked): K5 on each shard equals its plain
    version, and the two partial products sum to the whole product."""
    from vgate_tpu_torch.models.specs import TINY_DENSE
    from vgate_tpu_torch.parallel.mesh import Mesh, MeshPlan
    from vgate_tpu_torch.parallel.sharding import shard_leaf

    rng = np.random.default_rng(300 + rows)
    F, D = 1024, 256
    spec = dataclasses.replace(TINY_DENSE, hidden_size=D,
                               intermediate_size=F)
    w = torch.from_numpy(
        rng.normal(size=(1, F, D)).astype(np.float32) * 0.02).to(cuda)
    full = quant.quantize_stacked(w, 4)
    x = _bf16(rng, (rows, F), cuda)
    whole = quant_matmul.int4_matmul_plain(x, full.q_packed[0], full.scale[0],
                                           out_dtype=torch.float32)
    total = torch.zeros_like(whole)
    for rank in range(2):
        mesh = Mesh(MeshPlan(1, 1, 1, 1, 2), ["cpu", "cpu"], rank=rank)
        shard = shard_leaf(("layers", "down", "w"), full, spec, mesh)
        assert shard.q_packed.shape == (1, F // 4, D)
        torch.testing.assert_close(shard.scale, full.scale)
        xr = x[:, rank * F // 2:(rank + 1) * F // 2].contiguous()
        before = quant_matmul.int4_matmul.launches
        got = quant_matmul.int4_matmul(xr, shard.q_packed[0], shard.scale[0],
                                       out_dtype=torch.float32)
        torch.cuda.synchronize()
        assert quant_matmul.int4_matmul.launches == before + 1
        expect = quant_matmul.int4_matmul_plain(
            xr, shard.q_packed[0], shard.scale[0], out_dtype=torch.float32)
        torch.testing.assert_close(got, expect, atol=QMM_F32_TOL,
                                   rtol=QMM_F32_TOL)
        total += got
    torch.testing.assert_close(total, whole, atol=QMM_F32_TOL,
                               rtol=QMM_F32_TOL)
