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
only), atol = rtol = 1e-4 — fp32 sums in another order.
"""

import numpy as np
import pytest
import torch

from vgate_tpu_torch.ops import attention as tatt
from vgate_tpu_torch.ops.kernels import (
    flash_prefill,
    paged_decode,
    paged_multitok,
)

KERNEL_TOL = 1e-2
F32_TOL = 1e-4


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
    ):
        with pytest.raises(ValueError):
            paged_multitok.paged_multitok_attention(
                bad_q, bad_pool, bad_pool, pt, lens, lens
            )
