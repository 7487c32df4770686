"""Smoke test of vgate_tpu_torch on one NVIDIA card.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It (1) builds the hand-written CUDA kernels from vgate_tpu_torch/csrc
with nvcc, all sources at once; (2) holds every kernel against its plain
PyTorch version on the card at the shapes the main path gives it, and
times kernel, plain version and, where one exists, a single PyTorch
library call computing the same function; (3) serves chat requests
through ``VGTEngine`` with Qwen2.5-7B-Instruct at full width (random
weights from seed 0, bf16), first with the prefix cache off, then with
it on (radix tree, copy-on-write, generated-token reuse, chunked
prefill at 512), then quantized: int8 weights with int8 KV pools (the
burst and the prefix traffic), and int4 weights with int8 KV pools (the
burst), counting the kernel launches of each run; (4) checks the
served output, the prefix-cache counters, the exact launch counts of
the quantized runs and the model's logits (prompt pass, decode step,
suffix passes aligned and copy-on-write) against a plain full-sequence
forward.  It prints the card's name and power limit, one JSON line of
per-kernel numbers and, last, ``{"ok": true, "device": {...}}``.  Any
failed check exits non-zero; without a CUDA card it exits non-zero
before printing any result.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import subprocess
import sys
import time

import torch

MODEL = "Qwen/Qwen2.5-7B-Instruct"
H100_BYTES_PER_S = 3.35e12  # HBM3, SXM data sheet
H100_BF16_FLOPS = 989e12  # dense tensor-core bf16
H100_FP32_FLOPS = 67e12  # fp32 outside the tensor cores
KERNEL_TOL = 1e-2  # bf16 kernel vs fp32 plain on the same bf16 inputs
F32_TOL = 1e-4  # f32 kernel vs f32 plain: the same sums in another order
# K4/K5 with f32 out: bf16 x int narrow products are exact in fp32, so
# only the order of thousands of fp32 additions differs
QMM_F32_TOL = 1e-3


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0] if out else "unknown"


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, iters: int = 200) -> float:
    """Mean host time to enqueue one call of ``fn``, no sync inside the
    loop: where it exceeds the device time, a loop of such calls is held
    by the host, not by the card."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / iters * 1e6


def max_err(got: torch.Tensor, expect: torch.Tensor) -> float:
    check(bool(torch.isfinite(got).all()), "kernel output has NaN/Inf")
    return float((got.float() - expect.float()).abs().max())


def within(got, expect, what: str, tol: float = KERNEL_TOL) -> float:
    err = max_err(got, expect)
    ok = torch.allclose(got.float(), expect.float(), atol=tol, rtol=tol)
    check(ok, f"{what}: kernel disagrees with plain (max abs err {err})")
    return err


# ------------------------------------------------------------ kernel checks

def decode_inputs(B, H, KV, hd, ps, pps, lens, seed, dev,
                  dtype=torch.bfloat16):
    gen = torch.Generator(device=dev).manual_seed(seed)
    P = 1 + B * pps
    q = torch.randn(B, H, hd, generator=gen, device=dev).to(dtype)
    k = torch.randn(KV, P, ps, hd, generator=gen, device=dev).to(dtype)
    v = torch.randn(KV, P, ps, hd, generator=gen, device=dev).to(dtype)
    perm = torch.randperm(P - 1, generator=gen, device=dev) + 1
    pt = perm[: B * pps].reshape(B, pps).to(torch.int32)
    sl = torch.tensor(lens, dtype=torch.int32, device=dev)
    return q, k, v, pt, sl


# the main path's 32 decode slots at 7B: ragged contexts 1..2048
DECODE_LENS = [1, 31, 32, 33, 64, 65, 100, 127, 128, 129, 255, 256, 257, 300,
               511, 512, 513, 700, 1000, 1023, 1024, 1025, 1200, 1500, 1535,
               1536, 1600, 1800, 2000, 2047, 2048, 2048]


def check_paged_decode(dev) -> dict:
    from vgate_tpu_torch.ops import attention as plain
    from vgate_tpu_torch.ops.kernels.paged_decode import (
        paged_decode_attention as kernel,
    )

    # small cases: head dims 64/256, GQA groups, window, softcap + scale,
    # and the f32-pool mode
    for hd, H, KV, kw, dtype in (
        (64, 8, 4, {}, torch.bfloat16), (256, 16, 2, {}, torch.bfloat16),
        (128, 28, 4, {"window": 100}, torch.bfloat16),
        (128, 12, 2, {"softcap": 30.0, "scale": 0.1}, torch.bfloat16),
        (128, 28, 4, {}, torch.float32), (256, 16, 2, {}, torch.float32),
    ):
        q, k, v, pt, sl = decode_inputs(4, H, KV, hd, 16, 16,
                                        [1, 16, 17, 255], 11, dev, dtype)
        got = kernel(q, k, v, pt, sl, **kw)
        expect = plain.paged_decode_attention(
            q.float(), k.float(), v.float(), pt, sl, **kw
        )
        torch.cuda.synchronize()
        within(got, expect, f"paged decode hd={hd} H={H} KV={KV} {kw} "
               f"{dtype}", KERNEL_TOL if dtype == torch.bfloat16 else F32_TOL)

    # the main path's shape at 7B: 32 slots, ragged contexts 1..2048
    B, H, KV, hd, ps, pps = 32, 28, 4, 128, 32, 64
    lens = DECODE_LENS
    q, k, v, pt, sl = decode_inputs(B, H, KV, hd, ps, pps, lens, 12, dev)
    got = kernel(q, k, v, pt, sl)
    expect = plain.paged_decode_attention(q.float(), k.float(), v.float(),
                                          pt, sl)
    torch.cuda.synchronize()
    err = within(got, expect, "paged decode at 7B decode shapes")
    ms = time_ms(lambda: kernel(q, k, v, pt, sl), iters=50)
    plain_ms = time_ms(
        lambda: plain.paged_decode_attention(q, k, v, pt, sl), iters=5
    )
    live = sum(lens)
    nbytes = (
        2 * live * KV * hd * 2          # K and V of every live token
        + 2 * B * H * hd * 2            # q in, out
        + sum(math.ceil(n / ps) for n in lens) * 4 + B * 4  # tables, lens
    )
    flops = 4 * live * H * hd  # QK^T and PV, fp32 on the CUDA cores
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_FP32_FLOPS * 1e3
    return {
        "name": "paged_decode_attention",
        "route": "cuda",
        "source": "vgate_tpu_torch/csrc/paged_decode.cu",
        "replaces": "vgate_tpu/ops/pallas/paged_attention.py:299",
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
        "shape": f"B={B} H={H} KV={KV} hd={hd} ps={ps} ctx=1..2048",
    }


def prefill_inputs(B, S, H, KV, hd, seed, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, S, H, hd, generator=gen, device=dev).bfloat16()
    k = torch.randn(B, S, KV, hd, generator=gen, device=dev).bfloat16()
    v = torch.randn(B, S, KV, hd, generator=gen, device=dev).bfloat16()
    return q, k, v


def check_flash_prefill(dev) -> dict:
    from vgate_tpu_torch.ops import attention as plain
    from vgate_tpu_torch.ops.kernels.flash_prefill import (
        flash_prefill_attention as kernel,
    )

    # small cases: ragged lengths (real rows compared), head dims 64/256,
    # window + softcap + scale, and a q_offsets chunk
    for hd, H, KV, S, lens, kw in (
        (64, 8, 2, 128, [1, 100], {}),
        (256, 8, 4, 192, [150, 192], {}),
        (128, 8, 2, 512, [301, 512],
         {"window": 48, "softcap": 50.0, "scale": 0.05}),
    ):
        q, k, v = prefill_inputs(2, S, H, KV, hd, 21, dev)
        sl = torch.tensor(lens, dtype=torch.int32, device=dev)
        got = kernel(q, k, v, sl, **kw)
        expect = plain.flash_prefill_attention(
            q.float(), k.float(), v.float(), sl, **kw
        )
        torch.cuda.synchronize()
        real = torch.arange(S, device=dev)[None, :] < sl[:, None]
        within(got[real], expect[real], f"flash prefill hd={hd} {kw}")
    q, k, v = prefill_inputs(1, 256, 8, 4, 128, 22, dev)
    sl = torch.tensor([256], dtype=torch.int32, device=dev)
    off = torch.tensor([128], dtype=torch.int32, device=dev)
    got = kernel(q[:, 128:].contiguous(), k, v, sl, q_offsets=off)
    expect = plain.flash_prefill_attention(q.float(), k.float(), v.float(),
                                           sl)[:, 128:]
    torch.cuda.synchronize()
    within(got, expect, "flash prefill q_offsets")

    # the main path's bucket at 7B: B=2, S=1024, full rows (so one causal
    # library call computes the same function)
    B, S, H, KV, hd = 2, 1024, 28, 4, 128
    q, k, v = prefill_inputs(B, S, H, KV, hd, 23, dev)
    sl = torch.full((B,), S, dtype=torch.int32, device=dev)
    got = kernel(q, k, v, sl)
    expect = plain.flash_prefill_attention(q.float(), k.float(), v.float(),
                                           sl)
    torch.cuda.synchronize()
    err = within(got, expect, "flash prefill at 7B, bucket 1024")
    ms = time_ms(lambda: kernel(q, k, v, sl), iters=20)
    plain_ms = time_ms(
        lambda: plain.flash_prefill_attention(q, k, v, sl), iters=3
    )
    # library yardstick: causal SDPA on the same inputs, kv heads
    # expanded beforehand (the port never calls SDPA)
    qh = q.transpose(1, 2)
    kh = k.repeat_interleave(H // KV, dim=2).transpose(1, 2)
    vh = v.repeat_interleave(H // KV, dim=2).transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = sdpa(qh, kh, vh, is_causal=True).transpose(1, 2)
    torch.cuda.synchronize()
    within(got, lib, "flash prefill vs the library call")
    library_ms = time_ms(lambda: sdpa(qh, kh, vh, is_causal=True), iters=20)
    pairs = B * S * (S + 1) // 2  # (query, key) pairs under the diagonal
    flops = 4 * pairs * H * hd
    nbytes = B * S * (2 * H + 2 * KV) * hd * 2 + 2 * B * 4
    t_ops = flops / H100_BF16_FLOPS * 1e3
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    return {
        "name": "flash_prefill_attention",
        "route": "cuda",
        "source": "vgate_tpu_torch/csrc/flash_prefill.cu",
        "replaces": "vgate_tpu/ops/pallas/flash_prefill.py:127",
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms,
        "shape": f"B={B} S={S} H={H} KV={KV} hd={hd}",
    }


def suffix_inputs(B, S, H, KV, hd, ps, pos0, lens, seed, dev):
    """q, pools and a page table wide enough for every row's context
    (distinct shuffled pages per row, page 0 unused)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    ctx_pages = -(-(max(pos0) + S) // ps)
    P = 1 + B * ctx_pages
    q = torch.randn(B, S, H, hd, generator=gen, device=dev).bfloat16()
    k = torch.randn(KV, P, ps, hd, generator=gen, device=dev).bfloat16()
    v = torch.randn(KV, P, ps, hd, generator=gen, device=dev).bfloat16()
    perm = torch.randperm(P - 1, generator=gen, device=dev) + 1
    pt = perm[: B * ctx_pages].reshape(B, ctx_pages).to(torch.int32)
    p0 = torch.tensor(pos0, dtype=torch.int32, device=dev)
    il = torch.tensor(lens, dtype=torch.int32, device=dev)
    return q, k, v, pt, p0, il


def check_paged_multitok(dev) -> dict:
    from vgate_tpu_torch.ops import attention as plain
    from vgate_tpu_torch.ops.kernels.paged_multitok import (
        paged_multitok_attention as kernel,
    )

    # small ragged cases, real rows compared: unaligned positions0 (a
    # copy-on-write suffix starts mid-page), input_lens < S (idle query
    # tiles), hd 64/128/256, a window, softcap + scale, ps 16 and 32
    for hd, H, KV, ps, S, pos0, lens, kw in (
        (64, 8, 2, 16, 128, [0, 37, 5], [128, 20, 1], {}),
        (128, 28, 4, 32, 256, [1024, 100, 0], [256, 70, 3],
         {"window": 300}),
        (256, 8, 2, 16, 64, [16, 3, 50], [60, 64, 7],
         {"softcap": 30.0, "scale": 0.1}),
        (128, 28, 4, 32, 512, [690, 0], [512, 512], {}),
    ):
        q, k, v, pt, p0, il = suffix_inputs(len(pos0), S, H, KV, hd, ps,
                                            pos0, lens, 31, dev)
        got = kernel(q, k, v, pt, p0, il, **kw)
        expect = plain.paged_suffix_attention(
            q.float(), k.float(), v.float(), pt, p0, p0 + il,
            window=kw.get("window"), softcap=kw.get("softcap", 0.0),
            scale=kw.get("scale"),
        )
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), "K3 idle rows not finite")
        real = torch.arange(S, device=dev)[None, :] < il[:, None]
        within(got[real], expect[real],
               f"paged multitok hd={hd} ps={ps} pos0={pos0} {kw}")

    # the timing shape: 4 slots, 512 suffix rows over a 1024-token
    # resident prefix each (ctx 1536), 7B heads, ps 32
    B, S, H, KV, hd, ps, prefix = 4, 512, 28, 4, 128, 32, 1024
    q, k, v, pt, p0, il = suffix_inputs(B, S, H, KV, hd, ps, [prefix] * B,
                                        [S] * B, 32, dev)
    got = kernel(q, k, v, pt, p0, il)
    expect = plain.paged_suffix_attention(q.float(), k.float(), v.float(),
                                          pt, p0, p0 + il)
    torch.cuda.synchronize()
    err = within(got, expect, "paged multitok at the 7B suffix shape")
    ms = time_ms(lambda: kernel(q, k, v, pt, p0, il), iters=20)
    plain_ms = time_ms(
        lambda: plain.paged_suffix_attention(q, k, v, pt, p0, p0 + il),
        iters=3,
    )
    # library yardstick: K/V gathered to contiguous memory beforehand (not
    # timed), kv heads expanded, then ONE SDPA call whose lower-right
    # causal mask is exactly the suffix mask of full rows (the port never
    # calls SDPA)
    from torch.nn.attention.bias import causal_lower_right

    ctx = prefix + S
    kc = k[:, pt.long()].reshape(KV, B, ctx, hd).permute(1, 0, 2, 3)
    vc = v[:, pt.long()].reshape(KV, B, ctx, hd).permute(1, 0, 2, 3)
    kh = kc.repeat_interleave(H // KV, dim=1).contiguous()
    vh = vc.repeat_interleave(H // KV, dim=1).contiguous()
    qh = q.transpose(1, 2)
    mask = causal_lower_right(S, ctx)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = sdpa(qh, kh, vh, attn_mask=mask).transpose(1, 2)
    torch.cuda.synchronize()
    within(got, lib, "paged multitok vs the library call")
    library_ms = time_ms(lambda: sdpa(qh, kh, vh, attn_mask=mask), iters=20)
    # visible (query, key) pairs: row s sees prefix + s + 1 keys
    pairs = B * (S * (prefix + 1) + S * (S - 1) // 2)
    flops = 4 * pairs * H * hd
    nbytes = (2 * B * S * H * hd * 2          # q in, out
              + 2 * B * ctx * KV * hd * 2     # K and V of the live context
              + B * (ctx // ps) * 4 + 2 * B * 4)  # tables, positions, lens
    t_ops = flops / H100_BF16_FLOPS * 1e3
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    return {
        "name": "paged_multitok_attention",
        "route": "cuda",
        "source": "vgate_tpu_torch/csrc/paged_multitok.cu",
        "replaces": "vgate_tpu/ops/pallas/paged_attention.py:847",
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms,
        "shape": f"B={B} S={S} prefix={prefix} H={H} KV={KV} hd={hd} "
                 f"ps={ps}",
    }


def int8_pools(KV, P, ps, hd, seed, dev, L=None):
    """Two int8 ``QuantPages`` pools (K, V) of quantized normal values;
    with ``L`` they carry a leading layer dim."""
    from vgate_tpu_torch.ops.kv_quant import QuantPages, quantize

    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (KV, P, ps, hd) if L is None else (L, KV, P, ps, hd)
    return tuple(
        QuantPages(*quantize(torch.randn(shape, generator=gen, device=dev)))
        for _ in range(2)
    )


def dequantized(pool):
    from vgate_tpu_torch.ops.kv_quant import dequantize

    return dequantize(pool.data, pool.scale)


def check_paged_decode_int8(dev) -> dict:
    from vgate_tpu_torch.ops import attention as plain
    from vgate_tpu_torch.ops.kernels.paged_decode import (
        paged_decode_attention_int8 as kernel,
    )

    # small cases on layer views of [L]-pools: head dims 64/128/256, GQA
    # groups, window, softcap + scale, an idle slot on the trash page
    for hd, H, KV, kw in (
        (64, 8, 4, {}), (128, 28, 4, {"window": 100}),
        (256, 16, 2, {"softcap": 30.0, "scale": 0.1}),
    ):
        q, _, _, pt, sl = decode_inputs(4, H, KV, hd, 16, 16,
                                        [1, 16, 17, 255], 41, dev)
        pt[0] = 0
        kL, vL = int8_pools(KV, 1 + 4 * 16, 16, hd, 42, dev, L=3)
        got = kernel(q, kL[2], vL[2], pt, sl, **kw)
        expect = plain.paged_decode_attention(q.float(), kL[2], vL[2], pt, sl,
                                              **kw)
        torch.cuda.synchronize()
        within(got, expect, f"paged decode int8 hd={hd} H={H} {kw}")

    # the main path's shape at 7B: 32 slots, ragged contexts 1..2048
    B, H, KV, hd, ps, pps = 32, 28, 4, 128, 32, 64
    lens = DECODE_LENS
    q, _, _, pt, sl = decode_inputs(B, H, KV, hd, ps, pps, lens, 12, dev)
    k, v = int8_pools(KV, 1 + B * pps, ps, hd, 43, dev)
    got = kernel(q, k, v, pt, sl)
    expect = plain.paged_decode_attention(q.float(), k, v, pt, sl)
    torch.cuda.synchronize()
    err = within(got, expect, "paged decode int8 at 7B decode shapes")
    ms = time_ms(lambda: kernel(q, k, v, pt, sl), iters=50)
    plain_ms = time_ms(
        lambda: plain.paged_decode_attention(q, k, v, pt, sl), iters=5
    )
    live = sum(lens)
    nbytes = (
        2 * live * KV * (hd + 2)        # int8 K and V + their bf16 scales
        + 2 * B * H * hd * 2            # q in, out
        + sum(math.ceil(n / ps) for n in lens) * 4 + B * 4  # tables, lens
    )
    flops = 4 * live * H * hd  # QK^T and PV, fp32 on the CUDA cores
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_FP32_FLOPS * 1e3
    return {
        "name": "paged_decode_attention_int8",
        "route": "cuda",
        "source": "vgate_tpu_torch/csrc/paged_decode.cu",
        "replaces": "vgate_tpu/ops/pallas/paged_attention.py:299",
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
        "shape": f"B={B} H={H} KV={KV} hd={hd} ps={ps} ctx=1..2048, int8",
    }


def check_paged_multitok_int8(dev) -> dict:
    from vgate_tpu_torch.ops import attention as plain
    from vgate_tpu_torch.ops.kernels.paged_multitok import (
        paged_multitok_attention_int8 as kernel,
    )

    # small ragged cases on layer views, real rows compared: unaligned
    # positions0, input_lens < S, hd 64/128/256, window, softcap + scale
    for hd, H, KV, ps, S, pos0, lens, kw in (
        (64, 8, 2, 16, 128, [0, 37, 5], [128, 20, 1], {}),
        (128, 28, 4, 32, 256, [1024, 100, 0], [256, 70, 3],
         {"window": 300}),
        (256, 8, 2, 16, 64, [16, 3, 50], [60, 64, 7],
         {"softcap": 30.0, "scale": 0.1}),
    ):
        q, _, _, pt, p0, il = suffix_inputs(len(pos0), S, H, KV, hd, ps,
                                            pos0, lens, 51, dev)
        P = 1 + pt.numel()
        kL, vL = int8_pools(KV, P, ps, hd, 52, dev, L=2)
        got = kernel(q, kL[1], vL[1], pt, p0, il, **kw)
        expect = plain.paged_suffix_attention(
            q.float(), kL[1], vL[1], pt, p0, p0 + il,
            window=kw.get("window"), softcap=kw.get("softcap", 0.0),
            scale=kw.get("scale"),
        )
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), "K3-int8 idle rows not finite")
        real = torch.arange(S, device=dev)[None, :] < il[:, None]
        within(got[real], expect[real],
               f"paged multitok int8 hd={hd} ps={ps} pos0={pos0} {kw}")

    # the timing shape of K3: 4 slots, 512 rows over a 1024-token prefix
    B, S, H, KV, hd, ps, prefix = 4, 512, 28, 4, 128, 32, 1024
    q, _, _, pt, p0, il = suffix_inputs(B, S, H, KV, hd, ps, [prefix] * B,
                                        [S] * B, 32, dev)
    k, v = int8_pools(KV, 1 + pt.numel(), ps, hd, 53, dev)
    got = kernel(q, k, v, pt, p0, il)
    expect = plain.paged_suffix_attention(q.float(), k, v, pt, p0, p0 + il)
    torch.cuda.synchronize()
    err = within(got, expect, "paged multitok int8 at the 7B suffix shape")
    ms = time_ms(lambda: kernel(q, k, v, pt, p0, il), iters=20)
    plain_ms = time_ms(
        lambda: plain.paged_suffix_attention(q, k, v, pt, p0, p0 + il),
        iters=3,
    )
    # library yardstick: SDPA over the gathered, dequantized K/V in bf16
    # (gathered beforehand, not timed; the port never calls SDPA)
    from torch.nn.attention.bias import causal_lower_right

    ctx = prefix + S
    kd, vd = dequantized(k).bfloat16(), dequantized(v).bfloat16()
    kc = kd[:, pt.long()].reshape(KV, B, ctx, hd).permute(1, 0, 2, 3)
    vc = vd[:, pt.long()].reshape(KV, B, ctx, hd).permute(1, 0, 2, 3)
    kh = kc.repeat_interleave(H // KV, dim=1).contiguous()
    vh = vc.repeat_interleave(H // KV, dim=1).contiguous()
    qh = q.transpose(1, 2)
    mask = causal_lower_right(S, ctx)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = sdpa(qh, kh, vh, attn_mask=mask).transpose(1, 2)
    torch.cuda.synchronize()
    within(got, lib, "paged multitok int8 vs the library call")
    library_ms = time_ms(lambda: sdpa(qh, kh, vh, attn_mask=mask), iters=20)
    pairs = B * (S * (prefix + 1) + S * (S - 1) // 2)
    flops = 4 * pairs * H * hd
    nbytes = (2 * B * S * H * hd * 2          # q in, out
              + 2 * B * ctx * KV * (hd + 2)   # int8 K and V + scales
              + B * (ctx // ps) * 4 + 2 * B * 4)  # tables, positions, lens
    t_ops = flops / H100_BF16_FLOPS * 1e3
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    return {
        "name": "paged_multitok_attention_int8",
        "route": "cuda",
        "source": "vgate_tpu_torch/csrc/paged_multitok.cu",
        "replaces": "vgate_tpu/ops/pallas/paged_attention.py:847",
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms,
        "shape": f"B={B} S={S} prefix={prefix} H={H} KV={KV} hd={hd} "
                 f"ps={ps}, int8",
    }


def qmm_case(rows, in_dim, out_dim, bits, seed, dev):
    """bf16 activations and a quantized weight (QTensor/PackedQTensor)."""
    from vgate_tpu_torch.ops.quant import quantize_tensor

    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(rows, in_dim, generator=gen, device=dev).bfloat16()
    w = torch.randn(in_dim, out_dim, generator=gen, device=dev) * 0.02
    return x, quantize_tensor(w, bits)


def qmm_bound(rows, in_dim, out_dim, bits, out_bytes):
    """(bound ms, bound_by) of x [rows, in] @ W [in, out]: the narrow
    weight, its f32 scale, x and the output once; 2*r*in*out bf16 flops
    (the products run on the bf16 tensor cores)."""
    nbytes = (in_dim * out_dim * bits // 8 + out_dim * 4
              + rows * in_dim * 2 + rows * out_dim * out_bytes)
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = 2 * rows * in_dim * out_dim / H100_BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def check_quant_matmul(dev, bits: int) -> dict:
    """K4 (bits 8) or K5 (bits 4): rows 1/7/32/2048 at the 7B widths,
    bf16 and f32 out, against the plain version; a width off the tile
    must raise; timed at the decode shape (32 rows, 3584 x 18944), with
    the lm_head and a 2048-row prompt pass printed beside it."""
    from vgate_tpu_torch.ops.kernels import quant_matmul as qm

    if bits == 8:
        name, kernel, plain = "int8_matmul", qm.int8_matmul, \
            qm.int8_matmul_plain
        vals = lambda w: w.q  # noqa: E731
    else:
        name, kernel, plain = "int4_matmul", qm.int4_matmul, \
            qm.int4_matmul_plain
        vals = lambda w: w.q_packed  # noqa: E731
    for rows, in_dim, out_dim in ((1, 3584, 512), (7, 3584, 3584),
                                  (32, 18944, 3584), (2048, 3584, 512)):
        x, w = qmm_case(rows, in_dim, out_dim, bits, rows, dev)
        expect = plain(x, vals(w), w.scale, out_dtype=torch.float32)
        for out_dtype, tol in ((torch.float32, QMM_F32_TOL),
                               (torch.bfloat16, KERNEL_TOL)):
            got = kernel(x, vals(w), w.scale, out_dtype=out_dtype)
            torch.cuda.synchronize()
            check(got.dtype == out_dtype, f"{name} wrote {got.dtype}")
            within(got, expect, f"{name} rows={rows} {in_dim}x{out_dim} "
                   f"{out_dtype}", tol)
    x, w = qmm_case(4, 128, 96, bits, 1, dev)  # 96 is off the 64 tile
    try:
        kernel(x, vals(w), w.scale)
    except ValueError:
        pass
    else:
        fail(f"{name} took an output width off its tile")

    def timed(rows, in_dim, out_dim, out_dtype, seed):
        x, w = qmm_case(rows, in_dim, out_dim, bits, seed, dev)
        got = kernel(x, vals(w), w.scale, out_dtype=out_dtype)
        expect = plain(x, vals(w), w.scale, out_dtype=torch.float32)
        torch.cuda.synchronize()
        tol = QMM_F32_TOL if out_dtype == torch.float32 else KERNEL_TOL
        err = within(got, expect, f"{name} at {rows}x{in_dim}x{out_dim}", tol)
        ms = time_ms(lambda: kernel(x, vals(w), w.scale, out_dtype=out_dtype),
                     iters=20)
        plain_ms = time_ms(lambda: plain(x, vals(w), w.scale,
                                         out_dtype=out_dtype), iters=3)
        # library yardstick: one bf16 cuBLAS product on the dequantized
        # weight (made beforehand, not timed; the port never calls it)
        from vgate_tpu_torch.ops.quant import unpack_int4

        q = w.q if bits == 8 else unpack_int4(w.q_packed)
        wd = (q.float() * w.scale).bfloat16()
        def library():
            if out_dtype == torch.float32:
                return torch.mm(x, wd, out_dtype=out_dtype)
            return torch.mm(x, wd)

        library_ms = time_ms(library, iters=20)
        bound, by = qmm_bound(rows, in_dim, out_dim, bits,
                              4 if out_dtype == torch.float32 else 2)
        host = host_us(lambda: kernel(x, vals(w), w.scale,
                                      out_dtype=out_dtype))
        return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": by, "library_ms": library_ms,
                "host_us": host, "library_host_us": host_us(library)}

    main = timed(32, 3584, 18944, torch.bfloat16, 60)
    for rows, in_dim, out_dim, out_dtype in (
        (32, 3584, 152064, torch.float32), (2048, 3584, 18944, torch.bfloat16),
        (32, 18944, 3584, torch.bfloat16), (32, 3584, 512, torch.bfloat16),
    ):
        extra = timed(rows, in_dim, out_dim, out_dtype, 61)
        print(f"  {name} at {rows}x{in_dim}x{out_dim} "
              f"{str(out_dtype)[6:]}: " + json.dumps(extra), flush=True)
        torch.cuda.empty_cache()
    return {
        "name": name,
        "route": "cuda",
        "source": "vgate_tpu_torch/csrc/quant_matmul.cu",
        "replaces": "vgate_tpu/ops/pallas/quant_matmul.py:"
                    + ("156" if bits == 8 else "191"),
        **{k: v for k, v in main.items() if "host" not in k},
        "shape": f"R=32 in=3584 out=18944 bf16 out, host us per call "
                 f"{main['host_us']:.1f} "
                 f"(library {main['library_host_us']:.1f})",
    }


# ---------------------------------------------------------------- main path

def prompts():
    """8 chat prompts of 50..900 bytes (the byte tokenizer makes them
    50..900 tokens, spanning buckets 128..1024)."""
    words = ("the engine admits waiting prompts into free slots and "
             "decodes them in chunks while the pages grow ").split()
    out = []
    for i, n in enumerate((50, 120, 200, 333, 480, 610, 777, 900)):
        text, j = f"User {i}: ", i
        while len(text) < n:
            text += words[j % len(words)] + " "
            j += 3
        out.append(text[:n])
    return out


def reference_logits(params, spec, tokens, attn):
    """Last-token logits of a plain full-sequence forward: no KV pages,
    no kernels, the plain attention ``attn`` over the whole sequence."""
    from vgate_tpu_torch.models import decoder as dec
    from vgate_tpu_torch.ops.norms import rms_norm

    S = tokens.shape[1]
    pos = torch.arange(S, device=tokens.device)[None, :]
    sl = torch.tensor([S], dtype=torch.int32, device=tokens.device)
    x = dec._embed(params, tokens)
    for l in range(spec.num_layers):
        lp = dec.layer_params(params, l)
        q, k, v = dec._project_qkv(rms_norm(x, lp["input_norm"],
                                            spec.rms_eps), lp, spec)
        q, k = dec._rope(q, pos, spec), dec._rope(k, pos, spec)
        x = dec._finish_layer(x, attn(q, k, v, sl), lp, spec)
    return dec._logits(params, spec, x[:, -1])


@contextlib.contextmanager
def plain_matmuls():
    """The decoder's quantized projections through the plain versions of
    K4/K5 instead of the kernels, for the plain forwards the kernel path
    is held to (plain weights are unaffected)."""
    from vgate_tpu_torch.models import decoder as dec
    from vgate_tpu_torch.ops.kernels import quant_matmul as qm
    from vgate_tpu_torch.ops.quant import PackedQTensor, QTensor

    real = dec.weighted_einsum

    def plain(subscripts, x, w, preferred_element_type=None):
        out_dtype = preferred_element_type or x.dtype
        if isinstance(w, QTensor):
            return qm.int8_matmul_plain(x, w.q, w.scale, out_dtype)
        if isinstance(w, PackedQTensor):
            return qm.int4_matmul_plain(x, w.q_packed, w.scale, out_dtype)
        return real(subscripts, x, w, preferred_element_type)

    dec.weighted_einsum = plain
    try:
        yield
    finally:
        dec.weighted_einsum = real


def pooled_attention(base, pooled_from):
    """``base`` attention whose query rows from ``pooled_from`` on read
    quantized-then-dequantized K/V, as the kernel path's rows that read
    an int8 pool do (a decode step, a suffix pass); earlier rows attend
    the fresh K/V, as a prompt pass does."""
    from vgate_tpu_torch.ops.kv_quant import dequantize, quantize

    def attn(q, k, v, sl):
        out = base(q, k, v, sl)
        pooled = base(q, dequantize(*quantize(k)), dequantize(*quantize(v)),
                      sl)
        out[:, pooled_from:] = pooled[:, pooled_from:]
        return out

    return attn


class LogitsCheck:
    """Holds last-token logits of a kernel forward against a plain
    full-sequence forward.  bf16 through 28 layers is sensitive to
    rounding, so the tolerance is measured, not guessed: two plain
    attentions (fp32 vs bf16 probabilities before PV) give the noise
    floor, and the kernel path must stay within 3x that floor (and never
    be held to less than 4 bf16 steps of the largest logit).  The plain
    forwards of one sequence are computed once.  With int8 pools the
    rows that read the pool in the kernel path (from ``pooled_from``)
    attend quantized K/V in the plain forwards too; quantized weights go
    through the plain versions of K4/K5 there."""

    def __init__(self, core) -> None:
        self.core = core
        self.kv_int8 = core.geometry.kv_dtype == "int8"
        self.report: dict = {}
        self._refs: dict = {}

    def _plain(self, seq, pooled_from):
        from vgate_tpu_torch.ops.attention import (
            causal_prefill_attention,
            flash_prefill_attention,
        )

        if not self.kv_int8:
            pooled_from = None
        key = (tuple(seq[0].tolist()), pooled_from)
        if key not in self._refs:
            params, spec = self.core.params, self.core.spec
            attns = [causal_prefill_attention,
                     lambda q, k, v, sl: flash_prefill_attention(q, k, v, sl)]
            if pooled_from is not None:
                attns = [pooled_attention(a, pooled_from) for a in attns]
            with plain_matmuls():
                self._refs[key] = tuple(
                    reference_logits(params, spec, seq, a) for a in attns
                )
        return self._refs[key]

    def __call__(self, what: str, got, seq, pooled_from=None) -> int:
        """Compare ``got`` [1, V] with the plain forward over ``seq``
        [1, n]; returns the plain argmax."""
        ref, alt = self._plain(seq, pooled_from)
        check(bool(torch.isfinite(got).all()), f"{what} logits not finite")
        err = float((got - ref).abs().max())
        floor = float((alt - ref).abs().max())
        scale = float(ref.abs().max())
        top2 = ref.float().flatten().topk(2).values
        self.report[what] = {
            "max_abs_err": err, "plain_vs_plain": floor, "max_logit": scale,
            "same_argmax": int(got.argmax()) == int(ref.argmax()),
            "plain_top2_gap": float(top2[0] - top2[1]),
        }
        # the hidden state entering the lm_head is bf16: never ask for
        # less than a few bf16 steps at the largest logit
        ulp = 2.0 ** (math.floor(math.log2(scale)) - 7)
        tol = max(3 * floor, 4 * ulp)
        check(err <= tol,
              f"{what} logits off the plain forward: {self.report[what]}")
        # the argmax must agree unless the plain forward's top two logits
        # are closer than the tolerance (a near-tie either side may win)
        check(self.report[what]["same_argmax"]
              or self.report[what]["plain_top2_gap"] <= tol,
              f"{what} argmax differs from the plain forward's: "
              f"{self.report[what]}")
        return int(ref.argmax())


def empty_pools(core, num_pages: int):
    """Zeroed K/V pools like the engine's (int8 ``QuantPages`` for int8
    KV), ``num_pages`` pages."""
    import dataclasses

    from vgate_tpu_torch.runtime.kv_cache import make_kv_buffers

    geo = dataclasses.replace(core.geometry, num_pages=num_pages)
    return make_kv_buffers(geo, torch.bfloat16, core.device)


def prompt_tokens(core, text: str):
    ids = core.encode_prompt(text)
    return torch.tensor([ids], dtype=torch.int32, device=core.device)


def check_model_logits(core, text: str) -> dict:
    """The kernel forwards (a prompt pass, then one decode step) against
    a plain full-sequence forward on one prompt (see LogitsCheck)."""
    from vgate_tpu_torch.models.decoder import decode_forward, prefill_forward

    spec, dev, ps = core.spec, core.device, core.geometry.page_size
    seq = prompt_tokens(core, text)
    n = seq.shape[1]
    S = -(-n // 128) * 128
    kp, vp = empty_pools(core, 1 + S // ps + 1)
    pt = torch.arange(1, 2 + S // ps, dtype=torch.int32, device=dev)[None]
    tok = torch.zeros((1, S), dtype=torch.int32, device=dev)
    tok[:, :n] = seq
    sl = torch.tensor([n], dtype=torch.int32, device=dev)
    compare = LogitsCheck(core)
    with torch.no_grad():
        got = prefill_forward(core.params, spec, tok, sl, kp, vp,
                              pt[:, : S // ps])
        nxt = compare("prefill", got, seq)
        got = decode_forward(
            core.params, spec,
            torch.tensor([nxt], dtype=torch.int32, device=dev),
            torch.tensor([n], dtype=torch.int32, device=dev), kp, vp, pt,
        )
        nxt_t = torch.tensor([[nxt]], dtype=torch.int32, device=dev)
        compare("decode", got, torch.cat([seq, nxt_t], 1), pooled_from=n)
    return compare.report


def check_suffix_logits(core, text: str) -> dict:
    """The suffix pass against a plain full-sequence forward (see
    LogitsCheck): a prompt pass over the first half of the prompt, then
    ``prefill_suffix_forward`` (K3) over the rest, once from a page
    boundary and once from 20 tokens into a page after a copy-on-write
    ``copy_page_prefix`` of the shared page's head."""
    from vgate_tpu_torch.models.decoder import (
        prefill_forward,
        prefill_suffix_forward,
    )
    from vgate_tpu_torch.ops.kv_quant import copy_page_prefix

    spec, dev, ps = core.spec, core.device, core.geometry.page_size
    seq = prompt_tokens(core, text)
    n = seq.shape[1]
    bucket = lambda m: -(-m // 128) * 128  # noqa: E731
    P = 1 + 4 * (bucket(n) // ps + 1)
    kp, vp = empty_pools(core, P)
    free = iter(range(1, P))

    def take(count):
        return [next(free) for _ in range(count)]

    def i32(rows):
        return torch.tensor(rows, dtype=torch.int32, device=dev)

    compare = LogitsCheck(core)
    with torch.no_grad():
        for what, start in (("suffix", n // 2 // ps * ps),
                            ("cow_suffix", n // 2 // ps * ps + 20)):
            # the prompt pass that made positions [0, start) resident
            S = bucket(start)
            pages = take(S // ps)
            tok = torch.zeros((1, S), dtype=torch.int32, device=dev)
            tok[:, :start] = seq[:, :start]
            prefill_forward(core.params, spec, tok, i32([start]), kp, vp,
                            i32([pages]))
            shared = pages[: start // ps]
            unaligned = start % ps != 0
            S = bucket(n - start)
            own = take(S // ps + 1)
            if unaligned:
                src = pages[start // ps]
                copy_page_prefix(kp, src, own[0], start % ps)
                copy_page_prefix(vp, src, own[0], start % ps)
            tok = torch.zeros((1, S), dtype=torch.int32, device=dev)
            tok[:, : n - start] = seq[:, start:]
            got = prefill_suffix_forward(
                core.params, spec, tok, i32([start]), i32([n - start]), kp,
                vp, i32([own[: S // ps + int(unaligned)]]),
                i32([shared + own]), unaligned=unaligned,
            )
            compare(what, got, seq, pooled_from=start)
    return compare.report


def serve(engine, batch) -> tuple:
    t0 = time.perf_counter()
    results = engine.generate_batch(*batch)
    wall = time.perf_counter() - t0
    ttfts = sorted(r.metrics["ttft"] for r in results)
    decode_s = max(r.metrics["gen_time"] - r.metrics["ttft"]
                   for r in results)
    return results, {
        "wall_s": wall,
        "ttft_s_p50": ttfts[len(ttfts) // 2],
        "ttft_s_max": ttfts[-1],
        # tokens after the first, over the longest decode window
        "decode_tok_s": sum(r.num_tokens - 1 for r in results) / decode_s,
    }


def profile_burst(engine, batch) -> dict:
    """Where the time goes in one warm burst: the device's busy share
    (kernel time over wall time; one stream, so kernels do not overlap)
    and the kernels that take the most device time, from torch.profiler
    (CUPTI sees the engine thread's launches too)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.generate_batch(*batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            entry = kernels.setdefault(evt.name, [0, 0.0])
            entry[0] += 1
            entry[1] += evt.device_time_total / 1e3  # ms
    busy_ms = sum(ms for _, ms in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:8]
    return {
        "wall_ms": wall * 1e3,
        "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / (wall * 1e3),
        "device_ops": sum(n for n, _ in kernels.values()),
        "top": [{"name": name[:90], "count": n, "ms": ms}
                for name, (n, ms) in top],
    }


def kernel_wrappers() -> dict:
    from vgate_tpu_torch.ops.kernels.flash_prefill import (
        flash_prefill_attention,
    )
    from vgate_tpu_torch.ops.kernels.paged_decode import (
        paged_decode_attention,
        paged_decode_attention_int8,
    )
    from vgate_tpu_torch.ops.kernels.paged_multitok import (
        paged_multitok_attention,
        paged_multitok_attention_int8,
    )
    from vgate_tpu_torch.ops.kernels.quant_matmul import (
        int4_matmul,
        int8_matmul,
    )

    return {w.__name__: w for w in (paged_decode_attention,
                                    flash_prefill_attention,
                                    paged_multitok_attention,
                                    paged_decode_attention_int8,
                                    paged_multitok_attention_int8,
                                    int8_matmul, int4_matmul)}


def reset_launches() -> None:
    for wrapper in kernel_wrappers().values():
        wrapper.launches = 0


def read_launches() -> dict:
    return {name: w.launches for name, w in kernel_wrappers().items()}


def check_results(results, core, max_tokens: int = 32) -> None:
    for r in results:
        check(r.finish_reason in ("stop", "length"),
              f"finish reason {r.finish_reason!r}")
        check(1 <= r.num_tokens <= max_tokens, f"{r.num_tokens} tokens")
        if r.finish_reason == "length":
            check(r.num_tokens == max_tokens,
                  f"length finish before {max_tokens} tokens")
        check(all(0 <= t < core.spec.vocab_size for t in r.token_ids),
              "token id out of vocabulary")


def check_settled(core) -> dict:
    stats = core.get_stats()
    check(stats["used_pages"] == 0, f"{stats['used_pages']} pages leak")
    check(stats["running"] == 0, "sequences still running")
    check(stats["scheduler"]["waiting"] == 0, "sequences still waiting")
    return stats


def engine_config(model: str, device: str, quantization=None,
                  kv_dtype: str = "auto", **device_section):
    from vgate_tpu_torch.config import load_config

    return load_config(
        model={"model_id": model, "engine_type": "torch_cuda",
               "dtype": "bfloat16", "max_model_len": 2048,
               "quantization": quantization},
        kv_cache={"dtype": kv_dtype},
        device={"device": device, **device_section},
        logging={"level": "WARNING"},
    )


def start_engine(cfg, what: str):
    from vgate_tpu_torch.engine import VGTEngine

    t0 = time.perf_counter()
    engine = VGTEngine(cfg)
    core = engine.backend.core
    print(f"{what} engine up in {time.perf_counter() - t0:.1f} s: "
          f"{cfg.model.model_id}, {core.geometry.num_pages} KV pages",
          flush=True)
    return engine, core


def prefix_texts():
    """The prefix phase's traffic: a 700-byte system prompt (the byte
    tokenizer makes 1 byte 1 token), five user tails, a prompt that
    leaves the system prompt 20 tokens into its page 10 (copy-on-write at
    page size 32), and an unrelated 1,600-token prompt (chunked at 512:
    three 512-token passes and a final 64-token one)."""
    words = ("the gateway serves chat completions to many clients and the "
             "engine keeps their shared system prompt resident in pages "
             "of key value cache ").split()

    def text(head: str, n: int, stride: int) -> str:
        out, j = head, 0
        while len(out) < n:
            out += words[j % len(words)] + " "
            j += stride
        return out[:n]

    system = text("System: you are a careful assistant. ", 700, 1)
    tails = [text(f"\nUser {i}: please explain ", 40 + 7 * i, i + 2)
             for i in range(5)]
    cow = system[: 10 * 32 + 20] + "\nUser 9: a question of another kind."
    long = text("Document: ", 1600, 5)
    return system, tails, cow, long


def main_path(model: str = MODEL, device: str = "cuda",
              reference_prompts=()) -> dict:
    """The first path: a 9-request burst (8 greedy, 1 seeded sampled) on
    an engine with the prefix cache off, twice, then a profiled burst,
    then greedy streams of ``reference_prompts`` for the prefix phase to
    compare with."""
    from vgate_tpu_torch.backends.base import SamplingParams

    engine, core = start_engine(
        engine_config(model, device, prefix_cache=False), "prefix-off"
    )
    try:
        texts = prompts()
        greedy = [SamplingParams(max_tokens=32, temperature=0.0)] * 8
        sampled = SamplingParams(max_tokens=32, temperature=0.8, top_p=0.9,
                                 top_k=50, seed=1234)
        batch = (texts + [texts[3]], greedy + [sampled])
        reset_launches()
        results, cold = serve(engine, batch)
        launches = read_launches()
        if device == "cuda":
            for name in ("paged_decode_attention", "flash_prefill_attention"):
                check(launches[name] > 0,
                      f"{name} was not launched on the main path")
        check_results(results, core)
        # the same batch again (same bucket groups, so the same matmul
        # shapes): greedy rows and the seeded sampled row must repeat
        again, warm = serve(engine, batch)
        for a, b in zip(results, again):
            check(a.token_ids == b.token_ids,
                  "tokens differ between two identical runs")
        profile = profile_burst(engine, batch) if device == "cuda" else None
        reference = engine.generate_batch(
            list(reference_prompts), greedy[:1] * len(reference_prompts)
        )
        check_settled(core)
        return {
            "requests": len(results),
            "tokens": sum(r.num_tokens for r in results),
            "finish": [r.finish_reason for r in results],
            "cold": cold,
            "warm": warm,
            "logits": check_model_logits(core, texts[2]),
            "profile": profile,
            "launches": launches,
            "reference_streams": [r.token_ids for r in reference],
            "burst_streams": [r.token_ids for r in results],
        }
    finally:
        engine.shutdown()


def prefix_path(model: str = MODEL, device: str = "cuda",
                reference_streams=None) -> dict:
    """The reference's default configuration: prefix cache on (radix,
    copy-on-write, cow_min_tokens 8) and chunked prefill at 512.  Serves
    a shared system prompt with four user tails after a warm-up request,
    a second turn that re-sends turn 1's prompt and answer, a prompt
    diverging mid-page and a chunked 1,600-token prompt, then holds the
    suffix pass's logits to a plain forward.  Greedy streams are compared
    with the prefix-off engine's (``reference_streams``): bf16 matmuls
    round by shape, so the share that agrees is printed, not checked."""
    from vgate_tpu_torch.backends.base import SamplingParams

    engine, core = start_engine(
        engine_config(model, device, prefill_chunk=512), "prefix-on"
    )
    system, tails, cow, long = prefix_texts()
    greedy = SamplingParams(max_tokens=32, temperature=0.0)
    try:
        reset_launches()
        t0 = time.perf_counter()
        [first] = engine.generate_batch([system + tails[0]], [greedy])
        hits = engine.generate_batch([system + t for t in tails[1:]],
                                     [greedy] * 4)
        turn2 = core.submit_tokens(
            core.encode_prompt(system + tails[1]) + hits[0].token_ids
            + core.encode_prompt("\nUser 1: and the second point?"),
            greedy,
        )
        check(turn2.done_event.wait(600), "second turn did not finish")
        check(turn2.finish_reason in ("stop", "length"),
              f"second turn finish reason {turn2.finish_reason!r}")
        rest = engine.generate_batch([cow, long], [greedy] * 2)
        wall = time.perf_counter() - t0
        launches = read_launches()
        results = [first, *hits, *rest]
        check_results(results, core)
        stats = check_settled(core)
        pc = stats["prefix_cache"]
        if device == "cuda":
            # every prompt here is a hit or chunked, so K2 need not run
            for name in ("paged_decode_attention", "paged_multitok_attention"):
                check(launches[name] > 0,
                      f"{name} was not launched on the prefix path")
        check(pc["hit_tokens"] > 0, f"no prefix hit: {pc}")
        check(pc["cow_copies"] >= 1, f"no copy-on-write: {pc}")
        check(pc["chunked_prefills"] >= 1, f"no chunked prefill: {pc}")
        return {
            "requests": len(results) + 1,
            "wall_s": wall,
            "ttft_s_cold_first": first.metrics["ttft"],
            "ttft_s_hits": sorted(r.metrics["ttft"] for r in hits),
            "finish": [r.finish_reason for r in results]
            + [turn2.finish_reason],
            "prefix_cache": pc,
            "agreement_with_prefix_off": agreement(
                [r.token_ids for r in results], reference_streams
            ) if reference_streams else None,
            "launches": launches,
            "logits": check_suffix_logits(core, system + tails[0]),
        }
    finally:
        engine.shutdown()


def agreement(streams, reference_streams) -> dict:
    """How far two lists of greedy streams agree (printed, not checked:
    random weights make near-ties common, and any rounding difference
    can flip one)."""
    pairs = list(zip(streams, reference_streams))
    common = [next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                   min(len(a), len(b))) for a, b in pairs]
    return {
        "same_stream": f"{sum(a == b for a, b in pairs)}/{len(pairs)}",
        "same_first_token": f"{sum(c > 0 for c in common)}/{len(pairs)}",
        "common_prefix_tokens": common,
    }


def check_quant_launches(launches: dict, steps: int, bits: int,
                         layers: int) -> dict:
    """The exact launch counts of a quantized run: K2, K1-int8 and
    K3-int8 launch once per layer of each pass (prompt, decode step,
    suffix pass); the dequant matmul of ``bits`` launches 7 times per
    layer and once for the lm_head per pass (197 at 28 layers); no
    bf16-pool K1/K3 and no launch of the other matmul; one K1-int8 pass
    per decode step the engine counted."""
    per_pass = 7 * layers + 1
    attn = {name: launches[name] for name in (
        "flash_prefill_attention", "paged_decode_attention_int8",
        "paged_multitok_attention_int8")}
    for name, n in attn.items():
        check(n % layers == 0, f"{name}: {n} launches, not whole passes")
    passes = sum(attn.values()) // layers
    mine, other = (("int8_matmul", "int4_matmul") if bits == 8
                   else ("int4_matmul", "int8_matmul"))
    check(launches[mine] == per_pass * passes,
          f"{mine}: {launches[mine]} launches for {passes} passes, not "
          f"{per_pass} each")
    check(launches[other] == 0, f"{other} launched in the int{bits} phase")
    for name in ("paged_decode_attention", "paged_multitok_attention"):
        check(launches[name] == 0, f"bf16-pool {name} launched on int8 pools")
    check(attn["paged_decode_attention_int8"] == layers * steps,
          f"K1-int8 launched {attn['paged_decode_attention_int8']} times for "
          f"{steps} decode steps")
    check(attn["flash_prefill_attention"] > 0, "no prompt pass (K2)")
    return {"forward_passes": passes, "decode_steps": steps}


def page_capacity(core) -> dict:
    """Pages ``auto_num_pages`` gives for bf16 and for int8 pools at ONE
    budget: 0.9 of the card's memory less the loaded weights."""
    from vgate_tpu_torch.ops.kv_quant import SCALE_BYTES
    from vgate_tpu_torch.runtime.kv_cache import auto_num_pages

    weights = sum(t.numel() * t.element_size() for t in leaves(core.params))
    total = torch.cuda.get_device_properties(core.device).total_memory
    budget = 0.9 * total - weights
    pages = {
        name: auto_num_pages(core.spec, core.geometry.page_size, 0.9,
                             core.device, dtype_bytes=db, scale_bytes=sb,
                             hard_cap=1 << 30, budget_bytes=budget)
        for name, db, sb in (("bf16", 2, 0), ("int8", 1, SCALE_BYTES))
    }
    ratio = pages["int8"] / pages["bf16"]
    check(ratio >= 1.9, f"int8 pools hold only {ratio:.3f}x the bf16 pages")
    return {"budget_gb": budget / 1e9, "weights_gb": weights / 1e9,
            "pages": pages, "ratio": ratio}


def leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    elif isinstance(tree, tuple):  # QTensor / PackedQTensor
        yield from tree
    else:
        yield tree


def again_engine(core):
    """``generate_batch`` over an EngineCore, as ``VGTEngine`` offers it."""
    import types

    return types.SimpleNamespace(
        generate_batch=lambda texts, params: core.generate(texts, params)
    )


def quant_path(quantization: str, model: str = MODEL, device: str = "cuda",
               with_prefix_traffic: bool = True, bf16_streams=None) -> dict:
    """Quantized serving: ``quantization`` weights (int8 or int4) and
    int8 KV pools, prefix cache on, chunked prefill at 512.  Serves the
    9-request burst (cold prompts: K2, K1-int8 and K4/K5) and, with
    ``with_prefix_traffic``, the prefix phase's prompts (hits, COW,
    chunks: K3-int8), checks the exact launch counts and the logits
    against a plain forward of the same quantized weights, then serves
    the burst again on a fresh engine over the same weights and checks
    that it repeats every token."""
    from vgate_tpu_torch.backends.base import SamplingParams
    from vgate_tpu_torch.runtime.engine_core import EngineCore

    cfg = engine_config(model, device, quantization=quantization,
                        kv_dtype="int8", prefill_chunk=512)
    engine, core = start_engine(cfg, f"{quantization} weights + int8 KV")
    bits = 8 if quantization == "int8" else 4
    texts = prompts()
    greedy = SamplingParams(max_tokens=32, temperature=0.0)
    sampled = SamplingParams(max_tokens=32, temperature=0.8, top_p=0.9,
                             top_k=50, seed=1234)
    batch = (texts + [texts[3]], [greedy] * 8 + [sampled])
    out = {"kv_dtype": core.get_stats()["kv_dtype"]}
    try:
        check(out["kv_dtype"] == "int8", f"kv_dtype {out['kv_dtype']}")
        reset_launches()
        results, cold = serve(engine, batch)
        served = list(results)
        if with_prefix_traffic:
            system, tails, cow, long = prefix_texts()
            served += engine.generate_batch([system + tails[0]], [greedy])
            served += engine.generate_batch([system + t for t in tails[1:]],
                                            [greedy] * 4)
            served += engine.generate_batch([cow, long], [greedy] * 2)
        if device == "cuda":
            torch.cuda.synchronize()
        launches = read_launches()
        check_results(served, core)
        stats = check_settled(core)
        if device == "cuda":  # no kernel runs on the CPU
            out["launch_counts"] = check_quant_launches(
                launches, stats["steps"], bits, core.spec.num_layers)
            if with_prefix_traffic:
                check(launches["paged_multitok_attention_int8"] > 0,
                      "K3-int8 was not launched on the prefix traffic")
            out["capacity_at_one_budget"] = page_capacity(core)
        pc = stats["prefix_cache"]
        if with_prefix_traffic:
            check(pc["hit_tokens"] > 0, f"no prefix hit: {pc}")
            check(pc["cow_copies"] >= 1, f"no copy-on-write: {pc}")
            check(pc["chunked_prefills"] >= 1, f"no chunked prefill: {pc}")
        out.update({
            "requests": len(served),
            "cold_burst": cold,
            "prefix_cache": pc,
            "kv_pages": stats["kv_pages_total"],
            "kv_token_capacity": stats["kv_token_capacity"],
            "launches": launches,
        })
        if bf16_streams:
            out["agreement_with_bf16_burst"] = agreement(
                [r.token_ids for r in results[:8]], bf16_streams[:8])
        out["logits"] = check_model_logits(core, texts[2])
        if with_prefix_traffic:
            system, tails, _, _ = prefix_texts()
            out["logits"].update(check_suffix_logits(core,
                                                     system + tails[0]))
        params = core.params
    finally:
        engine.shutdown()
    del engine, core
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    # the same burst on a fresh engine over the same weights: the same
    # cold path, so every token must repeat (a second burst on the first
    # engine would hit its prefix cache and take another path)
    again = EngineCore(cfg, params=params)
    again.start()
    try:
        repeat = again.generate(*batch)
        if device == "cuda":
            # where the time goes in a warm burst (its prompts now hit)
            out["profile"] = profile_burst(again_engine(again), batch)
    finally:
        again.stop()
    for a, b in zip(results, repeat):
        check(a.token_ids == b["token_ids"],
              f"int{bits}: tokens differ between two identical bursts")
    del again, params
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def print_profile(what: str, card: str, profile: dict) -> None:
    print(f"profile of {what} on {card}: busy "
          f"{profile['device_busy_ms']:.1f} of {profile['wall_ms']:.1f} ms "
          f"wall ({100 * profile['device_busy_share']:.1f} %), "
          f"{profile['device_ops']} device ops", flush=True)
    for t in profile["top"]:
        print(f"  {t['ms']:9.2f} ms  {t['count']:6d}x  {t['name']}")


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs "
             "an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)

    from vgate_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    report = _build.build()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s "
          "(one nvcc per source, in parallel)", flush=True)
    for name, info in report.items():
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line.lower():
                print(f"  {name}: {line.strip()}")

    kernels = [check_paged_decode(dev), check_flash_prefill(dev),
               check_paged_multitok(dev)]
    torch.cuda.empty_cache()
    kernels += [check_paged_decode_int8(dev), check_paged_multitok_int8(dev)]
    torch.cuda.empty_cache()
    kernels += [check_quant_matmul(dev, 8), check_quant_matmul(dev, 4)]
    for k in kernels:
        print(f"kernel {k['name']} [{k['shape']}]: err {k['max_abs_err']:.3g}"
              f" ms {k['ms']:.4f} plain {k['plain_ms']:.4f} bound "
              f"{k['bound_ms']:.4f} ({k['bound_by']}) library "
              f"{k['library_ms']}", flush=True)
    torch.cuda.empty_cache()

    def memory(after: str) -> None:
        print(f"memory allocated after {after}: "
              f"{torch.cuda.memory_allocated() / 1e9:.2f} GB", flush=True)

    memory("the kernel checks")
    system, tails, cow, long = prefix_texts()
    served = main_path(
        reference_prompts=[system + t for t in tails] + [cow, long]
    )
    reference_streams = served.pop("reference_streams")
    bf16_burst = served.pop("burst_streams")
    profile = served.pop("profile")
    print(f"main path on {card}: " + json.dumps(served), flush=True)
    print_profile("one warm burst", card, profile)
    # each engine's pools were sized from free memory: release them
    # before the next engine sizes its own
    gc.collect()
    torch.cuda.empty_cache()
    memory("the prefix-off phase")
    prefix = prefix_path(reference_streams=reference_streams)
    print(f"prefix path on {card}: " + json.dumps(prefix), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    memory("the prefix phase")
    runs = [served, prefix]
    for quantization, traffic in (("int8", True), ("int4", False)):
        quant = quant_path(quantization, with_prefix_traffic=traffic,
                           bf16_streams=bf16_burst)
        qprofile = quant.pop("profile")
        print(f"{quantization} weights + int8 KV on {card}: "
              + json.dumps(quant), flush=True)
        print_profile(f"{quantization} weights, a warm burst", card,
                      qprofile)
        runs.append(quant)
        memory(f"the {quantization} phase")
    for k in kernels:
        # launches of every path, each counted from 0 just before it ran
        k["launches"] = sum(run["launches"].get(k["name"], 0)
                            for run in runs)
        del k["shape"]
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))


if __name__ == "__main__":
    main()
