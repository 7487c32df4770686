"""Smoke test of vgate_tpu_torch on one NVIDIA card.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It (1) builds the hand-written CUDA kernels from vgate_tpu_torch/csrc
with nvcc, all sources at once; (2) holds every kernel against its plain
PyTorch version on the card at the shapes the main path gives it, and
times kernel, plain version and, where one exists, a single PyTorch
library call computing the same function, and checks the host swap
tier's page round trip bit for bit; (3) serves chat requests through
``VGTEngine`` with Qwen2.5-7B-Instruct at full width (random weights
from seed 0, bf16), every engine warmed up first (``EngineCore.warmup``),
first with the prefix cache off, then a host-swap wave on a squeezed
pool over the same weights (swap on, then off), then with the prefix
cache on (radix tree, copy-on-write, generated-token reuse, chunked
prefill at 512), then quantized: int8 weights with int8 KV pools (the
burst and the prefix traffic), and int4 weights with int8 KV pools (the
burst), then Gemma-2-9B-it at full width (sliding window 4096 on even
layers, softcaps, hd 256) twice over the same weights: decode through
K1, then through K6 (``decode_block_slots`` 8), each serving the burst,
a 4,600-token chunked document beside 7 short requests and a second
turn that hits the document's pages; counting the kernel launches of
each run; (4) checks the served output, the prefix-cache counters, the
exact launch counts of the main path, the quantized and the Gemma runs,
that every decode chunk of every phase was the replay of a captured
CUDA graph, and the model's logits (prompt pass, decode step, suffix
passes aligned and copy-on-write; for Gemma a chunked document and a
decode step past the window) against a plain full-sequence forward;
(5) in the first phase, serves a request with logprobs (top 5) and
holds its prompt-pass and decode-step logprobs to the log-softmax of
the plain forward, and serves the burst once more on the same engine
with the chunk body run eagerly (every row must repeat), profiling a
warm burst each way; (6) after the host-swap phase, a recovery phase
on a supervised 7B engine: the checksum kernel against its plain
version and the host digest, a full checksum sweep, the perf snapshot of
a warm burst, then a crash, a stall, a weight corruption and a tripped
output guard, each recovered with every request resumed, and the
guard's cost; (7) speculative decoding at 7B over the main path's
weights (``speculative_k`` 4): a brownout-suspended burst through
graphed K1 chunks, then an oracle drafter (the plain streams as
drafts), prompt lookup on repetitive prompts, seeded sampled requests
served twice, one stream with and without speculation, and a second
engine drafting with Qwen2.5-0.5B-Instruct, each run's launches exact
(K3 = 28 x verify rounds, K1 none), after K3 and K3-int8 were held to
their plain version and timed at the verify widths (S 1..8); (8)
bge-base-en-v1.5 embeddings of 64 inputs over the three buckets against
a plain fp32 forward; (9) last, Mixtral-8x7B-Instruct at full width on
the one card with int8 weights, its experts included (quantized a layer
at a time as they are drawn), and a bf16 pool: the burst and the prefix
traffic, K4 launched exactly 897 times a forward pass (each expert's
gate, up and down one at a time), its logits held to a plain forward
over the same padded passes, then a W8A8 engine (``int8_native``) over
the same weights serving the burst with K4 on the lm_head alone, after
K4 and K5 were held to their plain versions and timed at the expert
shapes.  ``python3 chip_smoke.py mixtral`` runs the build and (9)
alone.  Each phase prints the graphs it captured, their
capture time and their memory pool's bytes.  It prints the card's
name and power limit, one JSON line of per-kernel numbers and, last,
``{"ok": true, "device": {...}}``.  Any
failed check exits non-zero; without a CUDA card it exits non-zero
before printing any result.
"""

from __future__ import annotations

import asyncio
import contextlib
import gc
import json
import math
import re
import subprocess
import sys
import threading
import time

import torch

MODEL = "Qwen/Qwen2.5-7B-Instruct"
H100_BYTES_PER_S = 3.35e12  # HBM3, SXM data sheet
H100_BF16_FLOPS = 989e12  # dense tensor-core bf16
H100_FP32_FLOPS = 67e12  # fp32 outside the tensor cores
H100_INT8_OPS = 1979e12  # dense tensor-core int8
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


def smi(query: str) -> str:
    """The first card's ``query`` fields as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0] if out else "unknown"


def card_line() -> str:
    return smi("name,power.limit")


def demangled(entry: str) -> str:
    """A kernel's name without namespaces and parameters, its template
    arguments kept (c++filt where the toolkit has it)."""
    try:
        entry = subprocess.run(["c++filt", entry], capture_output=True,
                               text=True, timeout=10).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return entry
    entry = entry.replace("(anonymous namespace)::", "").split("(")[0]
    end = entry.find("<") if "<" in entry else len(entry)
    scope = entry.rfind("::", 0, end)
    cut = max(scope + 2 if scope >= 0 else 0, entry.rfind(" ", 0, end) + 1)
    return entry[cut:]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events).  A
    sleeping kernel first holds the stream while the calls are enqueued
    (up to 100 us of host time each), so a call whose host time exceeds
    its device time is timed on the device, not on the host."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(iters * 200_000)  # ~100 us a call at 2 GHz
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


def thrice(fn, what: str):
    """Three launches of ``fn`` on the same inputs must give bit-identical
    outputs: a missing barrier wait shows as rows that change."""
    runs = [fn() for _ in range(3)]
    torch.cuda.synchronize()
    check(all(torch.equal(runs[0], r) for r in runs[1:]),
          f"{what}: three runs on the same inputs differ")
    return runs[0]


def attention_bound(pairs, H, hd, nbytes):
    """(flops, bound ms, bound_by) of an attention call over ``pairs``
    visible (query, key) pairs: 4 flops a pair, head and dim on the bf16
    tensor cores, ``nbytes`` moved once."""
    flops = 4 * pairs * H * hd
    t_ops = flops / H100_BF16_FLOPS * 1e3
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    return flops, max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                        else "bytes")


def print_timed(what: str, flops, bound, by, ms, library_ms, host, err):
    """One timed shape of K2 or K3: kernel ms, achieved TFLOP/s, share of
    the bound, the wrapper's host time a call, and kernel / library."""
    print(f"  {what}: " + json.dumps({
        "ms": ms, "bound_ms": bound, "bound_by": by,
        "library_ms": library_ms, "tflops": flops / ms / 1e9,
        "bound_share": bound / ms, "host_us": host,
        "vs_library": ms / library_ms, "max_abs_err": err,
    }), flush=True)


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


# the Gemma-2-9B phases' 32 decode slots: ragged contexts 1..8192, on
# both sides of the 4096 window and of page edges
GEMMA_DECODE_LENS = [1, 31, 32, 33, 100, 255, 256, 257, 511, 1000, 1024,
                     1500, 2047, 2048, 3000, 4000, 4095, 4096, 4097, 4111,
                     4128, 4500, 5000, 6000, 6143, 6144, 7000, 7500, 8000,
                     8191, 8192, 8192]


def decode_bound(lens, B, H, KV, hd, ps, window=0, kv_bytes=2.0):
    """(bound ms, bound_by) of one decode attention call: each slot's
    live K and V (the window's, with ``window``) read once at
    ``kv_bytes`` a value (int8: 1 + the bf16 scale's share), q in and
    out once, the page-table entries read and the lengths; 4 flops a
    (query head, key, dim) on the fp32 CUDA cores."""
    lo = [max(n - window, 0) if window else 0 for n in lens]
    live = sum(n - a for n, a in zip(lens, lo))
    pages = sum(math.ceil(n / ps) - a // ps for n, a in zip(lens, lo))
    nbytes = (2 * live * KV * hd * kv_bytes + 2 * B * H * hd * 2
              + pages * 4 + B * 4)
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = 4 * live * H * hd / H100_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def sdpa_decode(q, k, v, pt, sl, window=0, scale=None):
    """The library yardstick of decode attention: K/V gathered from the
    pages to contiguous memory beforehand (not timed), kv heads
    expanded, then ONE SDPA call per timing with a per-slot length (and
    window) mask over the table's whole width.  SDPA has no softcap.
    Returns (the call, its output).  The port never calls SDPA."""
    B, H, hd = q.shape
    KV, _, ps, _ = k.shape
    ctx = pt.shape[1] * ps
    kh, vh = (
        t[:, pt.long()].reshape(KV, B, ctx, hd).permute(1, 0, 2, 3)
        .repeat_interleave(H // KV, dim=1).contiguous()
        for t in (k, v)
    )
    t_pos = torch.arange(ctx, device=q.device)[None, :]
    valid = t_pos < sl[:, None]
    if window:
        valid &= t_pos >= (sl[:, None] - window)
    mask = valid[:, None, None, :]
    qh = q[:, :, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def call():
        return sdpa(qh, kh, vh, attn_mask=mask, scale=scale)

    return call, call()[:, :, 0]


# K1's edge cases, (hd, G, ps): G 1/2/4/7/8 at hd 64/128/256 with pages
# of 16 and 32, and pages of 12 (tiles that are not whole m16 steps; int8
# scale rows of 24 bytes, no bulk copy); the query scale, softcap and a
# window that starts mid-chunk and mid-page, in turns
K1_EDGE_CASES = [(hd, G, (16, 32)[(i + j) % 2])
                 for i, hd in enumerate((64, 128, 256))
                 for j, G in enumerate((1, 2, 4, 7, 8))] + [
    (64, 2, 12), (128, 7, 12), (256, 8, 12)]
K1_EDGE_KW = [{}, {"window": 300}, {"softcap": 30.0, "scale": 0.1},
              {"window": 100, "softcap": 50.0}]


def k1_edge_inputs(case, int8, dev):
    """Six slots: idle (seq_len 0, the trash page), one token, a partial
    page, past one page, and two of many chunks.  Every pool row outside
    the slots' live ranges holds NaN (bf16) or NaN scales (int8) in the
    kernel's pools and zeros (scale 0) in the plain version's."""
    hd, G, ps = K1_EDGE_CASES[case]
    kw = dict(K1_EDGE_KW[case % len(K1_EDGE_KW)])
    B, KV = 6, 2
    pps = -(-1300 // ps)
    P = 1 + B * pps
    lens = [0, 1, ps - 3, ps + 5, 777, pps * ps]
    q, k, v, pt, sl = decode_inputs(B, KV * G, KV, hd, ps, pps, lens,
                                    60 + case, dev)
    pt[0] = 0
    pos = torch.arange(pps * ps, device=dev)[None]
    lo = (sl - kw["window"]).clamp_min(0) if "window" in kw else 0 * sl
    live_pos = (pos >= lo[:, None]) & (pos < sl[:, None])
    pages = pt.long().repeat_interleave(ps, dim=1)
    rows = (pos % ps).expand(B, -1)
    stale = torch.ones(P, ps, dtype=torch.bool, device=dev)
    stale[pages[live_pos], rows[live_pos]] = False
    if int8:
        k, v = int8_pools(KV, P, ps, hd, 61 + case, dev)
        from vgate_tpu_torch.ops.kv_quant import QuantPages

        clean = [QuantPages(t.data, t.scale.masked_fill(stale[None], 0.0))
                 for t in (k, v)]
        for t in (k, v):
            t.scale.masked_fill_(stale[None], float("nan"))
    else:
        clean = [t.masked_fill(stale[None, :, :, None], 0.0) for t in (k, v)]
        for t in (k, v):
            t.masked_fill_(stale[None, :, :, None], float("nan"))
    what = (f"{'K1-int8' if int8 else 'K1'} edge hd={hd} G={G} ps={ps} "
            f"{kw}")
    return q, k, v, clean, pt, sl, kw, what


def check_k1_edges(dev, int8: bool) -> None:
    """K1 / K1-int8 on every edge case: three runs bit-identical, finite
    (the idle slot too), live slots within KERNEL_TOL of the plain version
    on the cleaned pools."""
    from vgate_tpu_torch.ops import attention as plain
    from vgate_tpu_torch.ops.kernels import paged_decode as pd

    kernel = pd.paged_decode_attention_int8 if int8 else \
        pd.paged_decode_attention
    for case in range(len(K1_EDGE_CASES)):
        q, k, v, (kc, vc), pt, sl, kw, what = k1_edge_inputs(case, int8, dev)
        got = thrice(lambda: kernel(q, k, v, pt, sl, **kw), what)
        check(bool(torch.isfinite(got).all()), f"{what}: output not finite")
        expect = plain.paged_decode_attention(
            q.float(), kc, vc, pt, sl, window=kw.get("window"),
            softcap=kw.get("softcap", 0.0), scale=kw.get("scale"))
        live = sl > 0
        within(got[live], expect[live], what)
        del q, k, v, kc, vc, got, expect


def time_k1(kernel, q, k, v, pt, sl, kw, bound, library_ms, what) -> float:
    """K1 (or K1-int8) at one shape: three readings (the median is the
    kernel's ms), the wrapper's host time a call and the plan, printed on
    a line of its own.  Returns the median."""
    from vgate_tpu_torch.ops.kernels import _build
    from vgate_tpu_torch.ops.kernels import paged_decode as pd

    runs = [time_ms(lambda: kernel(q, k, v, pt, sl, **kw), iters=50)
            for _ in range(3)]
    ms = sorted(runs)[1]
    B, H, hd = q.shape
    data = getattr(k, "data", k)
    KV, _, ps, _ = data.shape
    plan = pd.decode_plan(B, H, KV, hd, ps, pt.shape[1], kw.get("window", 0),
                          data.element_size(), _build.sm_count(q.device))
    print(f"  {kernel.__name__} at {what}: " + json.dumps({
        "ms": ms, "runs": runs, "bound_ms": bound, "bound_share": bound / ms,
        "library_ms": library_ms, "vs_library": ms / library_ms,
        "host_us": host_us(lambda: kernel(q, k, v, pt, sl, **kw)),
        "plan": plan._asdict()}), flush=True)
    return ms


def check_paged_decode(dev) -> dict:
    from vgate_tpu_torch.ops import attention as plain
    from vgate_tpu_torch.ops.kernels.paged_decode import (
        paged_decode_attention as kernel,
    )

    # small cases: head dims 64/256, GQA groups, window, softcap + scale,
    # and the f32-pool mode (K6's CUDA-core body at one slot a unit)
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
    check_k1_edges(dev, int8=False)

    # the main path's shape at 7B: 32 slots, ragged contexts 1..2048
    B, H, KV, hd, ps, pps = 32, 28, 4, 128, 32, 64
    lens = DECODE_LENS
    q, k, v, pt, sl = decode_inputs(B, H, KV, hd, ps, pps, lens, 12, dev)
    got = thrice(lambda: kernel(q, k, v, pt, sl),
                 "paged decode at 7B decode shapes")
    expect = plain.paged_decode_attention(q.float(), k.float(), v.float(),
                                          pt, sl)
    torch.cuda.synchronize()
    err = within(got, expect, "paged decode at 7B decode shapes")
    plain_ms = time_ms(
        lambda: plain.paged_decode_attention(q, k, v, pt, sl), iters=5
    )
    library, lib = sdpa_decode(q, k, v, pt, sl)
    torch.cuda.synchronize()
    within(got, lib, "paged decode vs the library call")
    library_ms = time_ms(library, iters=20)
    del library, lib
    bound, by = decode_bound(lens, B, H, KV, hd, ps)
    shape = f"B={B} H={H} KV={KV} hd={hd} ps={ps} ctx=1..2048"
    ms = time_k1(kernel, q, k, v, pt, sl, {}, bound, library_ms,
                 f"7b [{shape}]")
    return {
        "name": "paged_decode_attention",
        "route": "cuda",
        "source": "vgate_tpu_torch/csrc/paged_decode.cu",
        "replaces": "vgate_tpu/ops/pallas/paged_attention.py:299",
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": library_ms,
        "shape": shape,
    }


def prefill_inputs(B, S, H, KV, hd, seed, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, S, H, hd, generator=gen, device=dev).bfloat16()
    k = torch.randn(B, S, KV, hd, generator=gen, device=dev).bfloat16()
    v = torch.randn(B, S, KV, hd, generator=gen, device=dev).bfloat16()
    return q, k, v


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


def prefill_bound(B, S, H, KV, hd):
    """(flops, bound ms, bound_by) of K2 on B full rows of S tokens."""
    return attention_bound(B * S * (S + 1) // 2, H, hd,
                           B * S * (2 * H + 2 * KV) * hd * 2 + 2 * B * 4)


def time_prefill(q, k, v, sl, what, kw=None, library_scale=None,
                 with_plain=False) -> dict:
    """K2 on B full rows against the plain version and causal SDPA (kv
    heads expanded beforehand; the port never calls SDPA), timed; prints
    the shape's line and returns its numbers."""
    from vgate_tpu_torch.ops import attention as plain
    from vgate_tpu_torch.ops.kernels.flash_prefill import (
        flash_prefill_attention as kernel,
    )

    kw = kw or {}
    B, S, H, hd = q.shape
    KV = k.shape[2]
    got = kernel(q, k, v, sl, **kw)
    expect = plain.flash_prefill_attention(q.float(), k.float(), v.float(),
                                           sl, **kw)
    torch.cuda.synchronize()
    err = within(got, expect, f"flash prefill {what}")
    del expect
    qh = q.transpose(1, 2)
    kh = k.repeat_interleave(H // KV, dim=2).transpose(1, 2)
    vh = v.repeat_interleave(H // KV, dim=2).transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if not kw.get("softcap"):  # SDPA has no softcap
        lib = sdpa(qh, kh, vh, is_causal=True, scale=library_scale)
        torch.cuda.synchronize()
        within(got, lib.transpose(1, 2), f"flash prefill {what} vs SDPA")
        del lib
    ms = time_ms(lambda: kernel(q, k, v, sl, **kw), iters=50)
    library_ms = time_ms(lambda: sdpa(qh, kh, vh, is_causal=True,
                                      scale=library_scale), iters=50)
    host = host_us(lambda: kernel(q, k, v, sl, **kw))
    flops, bound, by = prefill_bound(B, S, H, KV, hd)
    print_timed(f"flash_prefill_attention at {what}", flops, bound, by, ms,
                library_ms, host, err)
    out = {"max_abs_err": err, "ms": ms, "bound_ms": bound, "bound_by": by,
           "library_ms": library_ms}
    if with_plain:
        out["plain_ms"] = time_ms(
            lambda: plain.flash_prefill_attention(q, k, v, sl, **kw),
            iters=3)
    return out


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
    # the tile edges, each case three times (bit-identical)
    for hd, H, KV, S, Sk, lens, offs, kw in K2_EDGE_CASES:
        gen = torch.Generator(device=dev).manual_seed(S + Sk + H)
        B = len(lens)
        q = torch.randn(B, S, H, hd, generator=gen, device=dev).bfloat16()
        k, v = (torch.randn(B, Sk, KV, hd, generator=gen, device=dev)
                .bfloat16() for _ in range(2))
        sl = torch.tensor(lens, dtype=torch.int32, device=dev)
        off = (None if offs is None
               else torch.tensor(offs, dtype=torch.int32, device=dev))
        what = f"flash prefill edge hd={hd} H={H} KV={KV} S={S} {lens} {kw}"
        got = thrice(lambda: kernel(q, k, v, sl, q_offsets=off, **kw), what)
        expect = plain.flash_prefill_attention(
            q.float(), k.float(), v.float(), sl, q_offset=off, **kw)
        pos = torch.arange(S, device=dev)[None, :]
        if off is not None:
            pos = pos + off[:, None]
        real = pos < sl[:, None]
        within(got[real], expect[real], what)

    # the main path's bucket at 7B: B=2, S=1024, full rows (so one causal
    # library call computes the same function); then the largest bucket
    B, S, H, KV, hd = 2, 1024, 28, 4, 128
    main = time_prefill(*prefill_inputs(B, S, H, KV, hd, 23, dev),
                        torch.full((B,), S, dtype=torch.int32, device=dev),
                        f"7b [B={B} S={S} H={H} KV={KV} hd={hd}]",
                        with_plain=True)
    time_prefill(*prefill_inputs(1, 2048, H, KV, hd, 24, dev),
                 torch.full((1,), 2048, dtype=torch.int32, device=dev),
                 f"7b [B=1 S=2048 H={H} KV={KV} hd={hd}]")
    torch.cuda.empty_cache()
    return {
        "name": "flash_prefill_attention",
        "route": "cuda",
        "source": "vgate_tpu_torch/csrc/flash_prefill.cu",
        "replaces": "vgate_tpu/ops/pallas/flash_prefill.py:127",
        **main,
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


def suffix_bound(B, S, prefix, ctx, H, KV, hd, ps, window=0):
    """(flops, bound ms, bound_by) of K3 on B slots of S full rows over a
    ``prefix``-token prefix: row s sees prefix + s + 1 keys (``window``
    of them on a sliding layer whose window they all exceed); the live
    context's K and V read once."""
    if window:
        pairs = B * S * window
    else:
        pairs = B * (S * (prefix + 1) + S * (S - 1) // 2)
    nbytes = (2 * B * S * H * hd * 2          # q in, out
              + 2 * B * ctx * KV * hd * 2     # K and V of the live context
              + B * (ctx // ps) * 4 + 2 * B * 4)  # tables, positions, lens
    return attention_bound(pairs, H, hd, nbytes)


def time_suffix(dev, B, S, H, KV, hd, ps, prefix, seed, what, kw=None,
                with_plain=False) -> dict:
    """K3 on B slots of S full rows over a ``prefix``-token prefix,
    against the plain version and one SDPA call on K/V gathered to
    contiguous memory beforehand (not timed; kv heads expanded; the port
    never calls SDPA), whose mask is the suffix mask; timed, printed."""
    from vgate_tpu_torch.ops import attention as plain
    from vgate_tpu_torch.ops.kernels.paged_multitok import (
        paged_multitok_attention as kernel,
    )

    kw = kw or {}
    window = kw.get("window", 0)
    q, k, v, pt, p0, il = suffix_inputs(B, S, H, KV, hd, ps, [prefix] * B,
                                        [S] * B, seed, dev)
    got = kernel(q, k, v, pt, p0, il, **kw)
    expect = plain.paged_suffix_attention(
        q.float(), k.float(), v.float(), pt, p0, p0 + il,
        window=window or None, softcap=kw.get("softcap", 0.0),
        scale=kw.get("scale"))
    torch.cuda.synchronize()
    err = within(got, expect, f"paged multitok {what}")
    del expect
    ctx = prefix + S
    kc, vc = (t[:, pt.long()].reshape(KV, B, ctx, hd).permute(1, 0, 2, 3)
              .repeat_interleave(H // KV, dim=1).contiguous() for t in (k, v))
    if window:
        rows = prefix + torch.arange(S, device=dev)[:, None]
        keys = torch.arange(ctx, device=dev)[None, :]
        mask = (keys <= rows) & (keys > rows - window)
    else:  # lower-right causal: the suffix mask of full rows
        from torch.nn.attention.bias import causal_lower_right

        mask = causal_lower_right(S, ctx)
    qh = q.transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    scale = kw.get("scale")
    if not kw.get("softcap"):  # SDPA has no softcap
        lib = sdpa(qh, kc, vc, attn_mask=mask, scale=scale)
        torch.cuda.synchronize()
        within(got, lib.transpose(1, 2), f"paged multitok {what} vs SDPA")
        del lib
    ms = time_ms(lambda: kernel(q, k, v, pt, p0, il, **kw), iters=50)
    library_ms = time_ms(lambda: sdpa(qh, kc, vc, attn_mask=mask,
                                      scale=scale), iters=20)
    host = host_us(lambda: kernel(q, k, v, pt, p0, il, **kw))
    del kc, vc
    flops, bound, by = suffix_bound(B, S, prefix, ctx, H, KV, hd, ps, window)
    print_timed(f"paged_multitok_attention at {what}", flops, bound, by, ms,
                library_ms, host, err)
    out = {"max_abs_err": err, "ms": ms, "bound_ms": bound, "bound_by": by,
           "library_ms": library_ms}
    if with_plain:
        out["plain_ms"] = time_ms(
            lambda: plain.paged_suffix_attention(
                q, k, v, pt, p0, p0 + il, window=window or None,
                softcap=kw.get("softcap", 0.0), scale=scale),
            iters=3)
    torch.cuda.empty_cache()
    return out


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
    # the tile edges, each case three times (bit-identical)
    for hd, H, KV, ps, S, pos0, lens, kw, trash in K3_EDGE_CASES:
        q, k, v, pt, p0, il = suffix_inputs(len(pos0), S, H, KV, hd, ps,
                                            pos0, lens, 33, dev)
        pt = torch.cat([pt, pt.new_zeros(pt.shape[0], trash)], dim=1)
        what = (f"paged multitok edge hd={hd} H={H} KV={KV} ps={ps} S={S} "
                f"pos0={pos0} lens={lens} {kw} trash={trash}")
        got = thrice(lambda: kernel(q, k, v, pt, p0, il, **kw), what)
        expect = plain.paged_suffix_attention(
            q.float(), k.float(), v.float(), pt, p0, p0 + il,
            window=kw.get("window"), softcap=kw.get("softcap", 0.0),
            scale=kw.get("scale"),
        )
        check(bool(torch.isfinite(got).all()), f"{what}: idle rows")
        real = torch.arange(S, device=dev)[None, :] < il[:, None]
        within(got[real], expect[real], what)

    # the timing shape: 4 slots, 512 suffix rows over a 1024-token
    # resident prefix each (ctx 1536), 7B heads, ps 32
    B, S, H, KV, hd, ps, prefix = 4, 512, 28, 4, 128, 32, 1024
    main = time_suffix(dev, B, S, H, KV, hd, ps, prefix, 32,
                       f"7b [B={B} S={S} prefix={prefix} H={H} KV={KV} "
                       f"hd={hd} ps={ps}]", with_plain=True)
    return {
        "name": "paged_multitok_attention",
        "route": "cuda",
        "source": "vgate_tpu_torch/csrc/paged_multitok.cu",
        "replaces": "vgate_tpu/ops/pallas/paged_attention.py:847",
        **main,
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
    check_k1_edges(dev, int8=True)

    # the main path's shape at 7B: 32 slots, ragged contexts 1..2048
    B, H, KV, hd, ps, pps = 32, 28, 4, 128, 32, 64
    lens = DECODE_LENS
    q, _, _, pt, sl = decode_inputs(B, H, KV, hd, ps, pps, lens, 12, dev)
    k, v = int8_pools(KV, 1 + B * pps, ps, hd, 43, dev)
    got = thrice(lambda: kernel(q, k, v, pt, sl),
                 "paged decode int8 at 7B decode shapes")
    expect = plain.paged_decode_attention(q.float(), k, v, pt, sl)
    torch.cuda.synchronize()
    err = within(got, expect, "paged decode int8 at 7B decode shapes")
    plain_ms = time_ms(
        lambda: plain.paged_decode_attention(q, k, v, pt, sl), iters=5
    )
    # library yardstick: SDPA over the gathered, dequantized K/V in bf16
    library, lib = sdpa_decode(q, dequantized(k).bfloat16(),
                               dequantized(v).bfloat16(), pt, sl)
    torch.cuda.synchronize()
    within(got, lib, "paged decode int8 vs the library call")
    library_ms = time_ms(library, iters=20)
    del library, lib
    # int8 K and V + their bf16 scales: (hd + 2) bytes a value row
    bound, by = decode_bound(lens, B, H, KV, hd, ps, kv_bytes=(hd + 2) / hd)
    ms = time_k1(kernel, q, k, v, pt, sl, {}, bound, library_ms,
                 f"7b [B={B} H={H} KV={KV} hd={hd} ps={ps} ctx=1..2048]")
    return {
        "name": "paged_decode_attention_int8",
        "route": "cuda",
        "source": "vgate_tpu_torch/csrc/paged_decode.cu",
        "replaces": "vgate_tpu/ops/pallas/paged_attention.py:299",
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": library_ms,
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
    # the tile edges of K3's, on int8 pools, each three times (bit-identical)
    for hd, H, KV, ps, S, pos0, lens, kw, trash in K3_EDGE_CASES:
        q, _, _, pt, p0, il = suffix_inputs(len(pos0), S, H, KV, hd, ps,
                                            pos0, lens, 54, dev)
        kL, vL = int8_pools(KV, 1 + pt.numel(), ps, hd, 55, dev, L=2)
        pt = torch.cat([pt, pt.new_zeros(pt.shape[0], trash)], dim=1)
        what = (f"paged multitok int8 edge hd={hd} H={H} KV={KV} ps={ps} "
                f"S={S} pos0={pos0} lens={lens} {kw} trash={trash}")
        got = thrice(lambda: kernel(q, kL[1], vL[1], pt, p0, il, **kw), what)
        expect = plain.paged_suffix_attention(
            q.float(), kL[1], vL[1], pt, p0, p0 + il,
            window=kw.get("window"), softcap=kw.get("softcap", 0.0),
            scale=kw.get("scale"),
        )
        check(bool(torch.isfinite(got).all()), f"{what}: idle rows")
        real = torch.arange(S, device=dev)[None, :] < il[:, None]
        within(got[real], expect[real], what)

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
    host = host_us(lambda: kernel(q, k, v, pt, p0, il))
    pairs = B * (S * (prefix + 1) + S * (S - 1) // 2)
    flops = 4 * pairs * H * hd
    nbytes = (2 * B * S * H * hd * 2          # q in, out
              + 2 * B * ctx * KV * (hd + 2)   # int8 K and V + scales
              + B * (ctx // ps) * 4 + 2 * B * 4)  # tables, positions, lens
    t_ops = flops / H100_BF16_FLOPS * 1e3
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    print_timed(f"paged_multitok_attention_int8 at 7b [B={B} S={S} "
                f"prefix={prefix} H={H} KV={KV} hd={hd} ps={ps}]", flops,
                max(t_bytes, t_ops),
                "operations" if t_ops >= t_bytes else "bytes", ms, library_ms,
                host, err)
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


# K3 and K3-int8 at the verify widths of speculative decoding: S = 1..k+1
# rows a slot (S 1/2/4/5 at k 4, and 8), one slot and 32, Qwen2.5-7B's
# heads on pages of 32, contexts ragged over 1..2048 tokens, every row
# starting mid-page
VERIFY_WIDTHS = (1, 2, 4, 5, 8)
VERIFY_BATCHES = (1, 32)


def verify_positions(B: int, S: int, seed: int) -> list:
    """positions0 of B verify rows: one slot at the longest context
    (2,048 tokens after the round), else contexts spread over 2..2048
    (positions0 + S), every row starting mid-page."""
    if B == 1:
        return [2048 - S]
    gen = torch.Generator().manual_seed(seed)
    pos = torch.randint(1, 2048 - S, (B,), generator=gen).tolist()
    pos[0], pos[-1] = 0, 2047 - S
    return [p if p % 32 else p + 1 for p in pos[:-1]] + pos[-1:]


def verify_bound(pos0, S, H, KV, hd, ps, kv_row_bytes):
    """(flops, bound ms, bound_by) of one verify call: row s of a slot
    sees positions0 + s + 1 keys; q read and the output written once,
    each slot's live K and V rows (``kv_row_bytes`` a row and head, the
    scale included on int8 pools) read once, the tables' live entries,
    positions0 and input_lens."""
    pairs = sum(S * (p + 1) + S * (S - 1) // 2 for p in pos0)
    ctx = sum(p + S for p in pos0)
    nbytes = (2 * len(pos0) * S * H * hd * 2
              + 2 * ctx * KV * kv_row_bytes
              + sum(-(-(p + S) // ps) for p in pos0) * 4
              + 2 * len(pos0) * 4)
    return attention_bound(pairs, H, hd, nbytes)


def sdpa_verify(q, kd, vd, pt, pos0, S, H, KV, hd, ps):
    """The library yardstick of a verify call: the slots' K/V gathered
    to contiguous memory beforehand (bf16, kv heads expanded; not
    timed), then one SDPA call.  One slot takes ``causal_lower_right``
    (its S rows end at its context's end); ragged slots a boolean mask
    (key t visible to row s of slot b iff t <= positions0[b] + s)."""
    from torch.nn.attention.bias import causal_lower_right

    B = q.shape[0]
    ctx = max(pos0) + S
    n_pages = -(-ctx // ps)
    kc, vc = (t[:, pt[:, :n_pages].long()].reshape(KV, B, n_pages * ps, hd)
              [:, :, :ctx].permute(1, 0, 2, 3)
              .repeat_interleave(H // KV, dim=1).contiguous()
              for t in (kd, vd))
    if B == 1:
        mask = causal_lower_right(S, ctx)
    else:
        rows = torch.tensor(pos0, device=q.device)[:, None] + torch.arange(
            S, device=q.device)[None, :]
        keys = torch.arange(ctx, device=q.device)
        mask = (keys[None, None, :] <= rows[:, :, None])[:, None]
    qh = q.transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return (lambda: sdpa(qh, kc, vc, attn_mask=mask)), kc, vc


def check_k3_verify_shapes(dev) -> dict:
    """K3 and K3-int8 at every verify shape: held to the plain version
    (real rows), timed beside their bound (bytes: the context's K and V
    at 3.35 TB/s), the plain version and SDPA on the gathered K/V.  A
    128-row query tile holds S <= 8 live rows here, so the kernel is
    expected far from the bound (ROADMAP queue 2)."""
    from vgate_tpu_torch.ops import attention as plain
    from vgate_tpu_torch.ops.kernels.paged_multitok import (
        paged_multitok_attention,
        paged_multitok_attention_int8,
    )

    H, KV, hd, ps = 28, 4, 128, 32
    rows = {}
    for int8 in (False, True):
        kernel = (paged_multitok_attention_int8 if int8
                  else paged_multitok_attention)
        mode = "int8" if int8 else "bf16"
        for B in VERIFY_BATCHES:
            for S in VERIFY_WIDTHS:
                pos0 = verify_positions(B, S, seed=B * 10 + S)
                lens = [S] * B
                lens[B // 2] = max(1, S - 1)  # a row past input_lens
                q, k, v, pt, p0, il = suffix_inputs(
                    B, S, H, KV, hd, ps, pos0, lens, 91 + S, dev)
                if int8:
                    k, v = int8_pools(KV, k.shape[1], ps, hd, 92 + S, dev)
                    kd, vd = dequantized(k).bfloat16(), dequantized(v).bfloat16()
                    kf, vf = k, v
                else:
                    kd, vd, kf, vf = k, v, k.float(), v.float()
                what = f"K3 verify {mode} [B={B} S={S}]"
                got = thrice(lambda: kernel(q, k, v, pt, p0, il), what)
                expect = plain.paged_suffix_attention(q.float(), kf, vf, pt,
                                                      p0, p0 + il)
                check(bool(torch.isfinite(got).all()), f"{what}: not finite")
                real = torch.arange(S, device=dev)[None, :] < il[:, None]
                err = within(got[real], expect[real], what)
                del expect
                il.fill_(S)  # timed with every row real
                lib, kc, vc = sdpa_verify(q, kd, vd, pt, pos0, S, H, KV, hd,
                                          ps)
                lib_err = max_err(kernel(q, k, v, pt, p0, il).float(),
                                  lib().transpose(1, 2).float())
                check(lib_err <= 2 * KERNEL_TOL,
                      f"{what}: {lib_err} from SDPA on the gathered K/V")
                ms = time_ms(lambda: kernel(q, k, v, pt, p0, il), iters=50)
                library_ms = time_ms(lib, iters=20)
                plain_ms = time_ms(
                    lambda: plain.paged_suffix_attention(
                        q, kf, vf, pt, p0, p0 + il), iters=3)
                del kc, vc
                flops, bound, by = verify_bound(pos0, S, H, KV, hd, ps,
                                                hd + 2 if int8 else 2 * hd)
                rows[f"{mode} B={B} S={S}"] = {
                    "ms": ms, "bound_ms": bound, "bound_by": by,
                    "plain_ms": plain_ms, "library_ms": library_ms,
                    "bound_share": bound / ms, "vs_library": ms / library_ms,
                    "max_abs_err": err,
                    "context_tokens": sum(p + S for p in pos0),
                }
                print(f"  {what}: " + json.dumps(rows[f"{mode} B={B} S={S}"]),
                      flush=True)
                torch.cuda.empty_cache()
    return rows


def check_paged_decode_blocked(dev) -> dict:
    """K6 against its plain version (K1's function) and against K1 on the
    same inputs: small cases, then contexts of many chunks at block_slots
    1-16 (three runs bit-identical), then the Gemma-2-9B serving shape,
    timed at block_slots 2, 4 and 8 beside K1 (the extra times, the bound
    shares and the split plans print on lines of their own)."""
    from vgate_tpu_torch.ops import attention as plain
    from vgate_tpu_torch.ops.kernels import paged_decode as pd

    kernel = pd.paged_decode_attention_blocked
    # small cases: head dims 64/128/256, groups 1/2/7/8, block_slots
    # 2/3/4/8/16 (3: two idle warps; 16: every warp walks two slots), one
    # block mixing the page and chunk edges 1/16/255/256, windows whose
    # start differs per slot in a block, softcap + scale, bf16 and f32,
    # slot 0 idle on the trash page
    edges = [1, 16, 255, 256]
    for hd, H, KV, bs, lens, kw, dtype in (
        (64, 8, 8, 2, edges, {}, torch.bfloat16),
        (128, 8, 4, 4, edges + [40, 200, 96, 130], {"window": 64},
         torch.bfloat16),
        (256, 14, 2, 8, edges + [40, 200, 96, 130],
         {"softcap": 30.0, "scale": 0.1}, torch.bfloat16),
        (64, 8, 4, 3, edges + [70, 130], {"window": 100}, torch.bfloat16),
        (128, 16, 8, 16, (edges + [40, 200, 96, 130]) * 2,
         {"window": 64, "softcap": 50.0}, torch.bfloat16),
        (128, 16, 2, 2, edges, {"window": 100, "softcap": 50.0,
                                "scale": 1 / 16}, torch.float32),
        (256, 16, 8, 4, edges + [40, 200, 96, 130], {"window": 64},
         torch.float32),
    ):
        B = len(lens)
        q, k, v, pt, sl = decode_inputs(B, H, KV, hd, 16, 16, lens, 13, dev,
                                        dtype)
        pt[0] = 0
        got = kernel(q, k, v, pt, sl, block_slots=bs, **kw)
        expect = plain.paged_decode_attention(
            q.float(), k.float(), v.float(), pt, sl, **kw)
        k1 = pd.paged_decode_attention(q, k, v, pt, sl, **kw)
        torch.cuda.synchronize()
        tol = KERNEL_TOL if dtype == torch.bfloat16 else F32_TOL
        what = f"blocked decode hd={hd} H={H} KV={KV} bs={bs} {kw} {dtype}"
        within(got, expect, what, tol)
        within(got, k1, what + " vs K1", KERNEL_TOL)

    # contexts of many chunks (the page split), a window that starts
    # mid-chunk and mid-page, slots shorter than a chunk, one on the trash
    # page; 32 slots at block_slots 1 (K1 itself), 2, 4, 8, 16; bf16 and
    # f32 pools
    B, H, KV, hd, ps, pps = 32, 16, 8, 256, 32, 160
    lens = [1, 2, 31, 33, 64, 65, 100, 500, 777, 1023, 1024, 1025, 2000,
            2047, 2100, 2500, 3000, 3333, 4000, 4095, 4096, 4097, 4111, 4500,
            4600, 4700, 4800, 4900, 5000, 5050, 5100, 5120]
    kw = {"window": 1500, "softcap": 50.0, "scale": 1 / 16}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, pt, sl = decode_inputs(B, H, KV, hd, ps, pps, lens, 17, dev,
                                        dtype)
        pt[0] = 0
        expect = plain.paged_decode_attention(
            q.float(), k.float(), v.float(), pt, sl, **kw)
        k1 = pd.paged_decode_attention(q, k, v, pt, sl, **kw)
        tol = KERNEL_TOL if dtype == torch.bfloat16 else F32_TOL
        for bs in (1, 2, 4, 8, 16):
            what = f"blocked decode, many chunks, bs={bs} {dtype}"
            got = thrice(lambda bs=bs: kernel(q, k, v, pt, sl, block_slots=bs,
                                              **kw), what)
            within(got, expect, what, tol)
            within(got, k1, what + " vs K1", KERNEL_TOL)
        del q, k, v, expect, k1, got
        torch.cuda.empty_cache()

    # the reference's dispatch: a batch block_slots does not divide goes
    # to K1, an int8 pool to K1-int8; K6's counter stays
    q, k, v, pt, sl = decode_inputs(6, 16, 8, 256, 16, 16,
                                    [1, 16, 17, 200, 255, 256], 14, dev)
    k8, v8 = int8_pools(8, k.shape[1], 16, 256, 15, dev)
    wrappers = (pd.paged_decode_attention, pd.paged_decode_attention_int8,
                kernel)
    before = [w.launches for w in wrappers]
    kernel(q, k, v, pt, sl, block_slots=4)
    kernel(q, k8, v8, pt, sl, block_slots=2)
    torch.cuda.synchronize()
    check([w.launches for w in wrappers]
          == [before[0] + 1, before[1] + 1, before[2]],
          "K6's dispatch to K1 / K1-int8 launched the wrong kernels")

    # the Gemma-2-9B serving shape: 32 slots, ragged contexts 1..8192, a
    # sliding layer (window 4096), softcap 50, query scale 256^-0.5
    B, H, KV, hd, ps, pps = 32, 16, 8, 256, 32, 256
    lens = GEMMA_DECODE_LENS
    kw = {"window": 4096, "softcap": 50.0, "scale": 1 / 16}
    q, k, v, pt, sl = decode_inputs(B, H, KV, hd, ps, pps, lens, 16, dev)
    got = thrice(lambda: kernel(q, k, v, pt, sl, block_slots=8, **kw),
                 "blocked decode at Gemma-2-9B decode shapes")
    expect = plain.paged_decode_attention(q.float(), k.float(), v.float(),
                                          pt, sl, **kw)
    k1 = pd.paged_decode_attention(q, k, v, pt, sl, **kw)
    torch.cuda.synchronize()
    err = within(got, expect, "blocked decode at Gemma-2-9B decode shapes")
    within(got, k1, "blocked decode vs K1 at Gemma-2-9B decode shapes")
    del expect
    # K6 at 2, 4, 8 slots a CTA and K1, three readings each in turns
    runs = {f"bs{bs}_ms": [] for bs in (2, 4, 8)}
    runs["k1_ms"] = []
    for _ in range(3):
        for bs in (2, 4, 8):
            runs[f"bs{bs}_ms"].append(time_ms(
                lambda bs=bs: kernel(q, k, v, pt, sl, block_slots=bs, **kw),
                iters=50))
        runs["k1_ms"].append(time_ms(
            lambda: pd.paged_decode_attention(q, k, v, pt, sl, **kw),
            iters=50))
    times = {name: sorted(r)[1] for name, r in runs.items()}
    k1_ms = times.pop("k1_ms")
    plain_ms = time_ms(
        lambda: plain.paged_decode_attention(q, k, v, pt, sl, **kw), iters=3
    )
    # the library yardstick takes the window mask but has no softcap
    library, lib = sdpa_decode(q, k, v, pt, sl, window=4096, scale=1 / 16)
    library_ms = time_ms(library, iters=20)
    del library, lib
    bound, by = decode_bound(lens, B, H, KV, hd, ps, window=4096)
    shape = (f"B={B} H={H} KV={KV} hd={hd} ps={ps} ctx=1..8192 "
             "window=4096 softcap=50 scale=1/16")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plans = {f"bs{bs}": pd.split_plan(B, H, KV, hd, ps, pps, 4096, bs, 2,
                                      sms)._asdict() for bs in (2, 4, 8)}
    print(f"  paged_decode_attention_blocked at gemma-2-9b [{shape}]: "
          + json.dumps({**times, "k1_ms": k1_ms, "bound_ms": bound,
                        "bound_share": {n: bound / t for n, t in
                                        times.items()},
                        "vs_library": times["bs8_ms"] / library_ms,
                        "vs_k1": times["bs8_ms"] / k1_ms,
                        "runs": runs,
                        "host_us": host_us(lambda: kernel(
                            q, k, v, pt, sl, block_slots=8, **kw)),
                        "k1_host_us": host_us(
                            lambda: pd.paged_decode_attention(
                                q, k, v, pt, sl, **kw)),
                        "split": plans}),
          flush=True)
    print(f"  paged_decode_attention at gemma-2-9b [{shape}]: "
          + json.dumps({"ms": k1_ms, "bound_ms": bound,
                        "bound_share": bound / k1_ms,
                        "library_ms": library_ms,
                        "vs_library": k1_ms / library_ms,
                        "vs_k6_bs2": k1_ms / times["bs2_ms"],
                        "host_us": host_us(
                            lambda: pd.paged_decode_attention(
                                q, k, v, pt, sl, **kw)),
                        "plan": pd.decode_plan(B, H, KV, hd, ps, pps, 4096,
                                               2, sms)._asdict(),
                        "max_abs_err_vs_k6": max_err(k1, got)}), flush=True)
    torch.cuda.empty_cache()
    return {
        "name": "paged_decode_attention_blocked",
        "route": "cuda",
        "source": "vgate_tpu_torch/csrc/paged_decode.cu",
        "replaces": "vgate_tpu/ops/pallas/paged_attention.py:610",
        "max_abs_err": err,
        "ms": times["bs8_ms"],
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": library_ms,
        "shape": shape + ", block_slots=8 (SDPA yardstick without softcap)",
    }


def gemma_kernel_shapes(dev) -> None:
    """K2 and K3 at Gemma-2-9B's serving shapes (hd 256, 16/8 heads,
    softcap 50, query scale 256^-0.5), checked against their plain
    versions, timed beside their bound and a library yardstick (SDPA,
    which has no softcap), each printed on a line of its own (K1's
    line prints with K6's check)."""
    H, KV, hd = 16, 8, 256
    cap = {"softcap": 50.0, "scale": 1 / 16}
    # K2: a 1024-token bucket of two full rows, global and sliding layers
    B, S = 2, 1024
    q, k, v = prefill_inputs(B, S, H, KV, hd, 71, dev)
    sl = torch.full((B,), S, dtype=torch.int32, device=dev)
    for window in (0, 4096):
        time_prefill(q, k, v, sl, f"gemma-2-9b [B={B} S={S} H={H} KV={KV} "
                     f"hd={hd} softcap=50 window={window}]",
                     kw={"window": window, **cap}, library_scale=1 / 16)
    del q, k, v
    # K3: 4 rows of a 512-token chunk over a 4,096-token prefix (ctx
    # 4,608) on a sliding layer: each row's first key lies mid-page
    B, S, ps, prefix, window = 4, 512, 32, 4096, 4096
    time_suffix(dev, B, S, H, KV, hd, ps, prefix, 72,
                f"gemma-2-9b [B={B} S={S} prefix={prefix} H={H} KV={KV} "
                f"hd={hd} ps={ps} softcap=50 window={window}]",
                kw={"window": window, **cap})


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


# the K4/K5 shapes the main path gives them at 7B: decode (32 slots) gate/
# up, down, k/v and the f32 lm_head; the prompt pass's gate/up and down
QMM_SHAPES = [
    (32, 3584, 18944, torch.bfloat16), (32, 18944, 3584, torch.bfloat16),
    (32, 3584, 512, torch.bfloat16), (32, 3584, 152064, torch.float32),
    (2048, 3584, 18944, torch.bfloat16), (2048, 18944, 3584, torch.bfloat16),
]
# (rows, in, out) held against the plain version, bf16 and f32 out: K4 and
# K5 at ragged rows around their 64- and 128-row tiles and widths off
# their 128- and 256-column tiles; K5 also at an in_dim whose half is an
# odd number of its 32-row steps (3648: 57)
QMM_CASES = {
    8: [(1, 3584, 512), (7, 3584, 3584), (32, 18944, 3584), (33, 3584, 576),
        (127, 3584, 512), (129, 3584, 640), (2047, 512, 3584),
        (2048, 3584, 512)],
    4: [(1, 3584, 512), (7, 3584, 3584), (32, 18944, 3584), (33, 3584, 576),
        (127, 3584, 512), (129, 3584, 640), (2047, 512, 3584),
        (2048, 3584, 512), (32, 3648, 512), (2047, 3648, 640)],
}


def check_quant_matmul(dev, bits: int) -> dict:
    """K4 (bits 8) or K5 (bits 4) against the plain version at
    ``QMM_CASES``, bf16 and f32 out; a width off the tile must raise;
    timed at every ``QMM_SHAPES`` shape three times, in turns with the
    library call (one line each: kernel, library, bound, rate, factor,
    host time a call, the plan); the first is the kernel's line."""
    from vgate_tpu_torch.ops.kernels import quant_matmul as qm
    from vgate_tpu_torch.ops.quant import unpack_int4

    if bits == 8:
        name, kernel, plain = "int8_matmul", qm.int8_matmul, \
            qm.int8_matmul_plain
        vals = lambda w: w.q  # noqa: E731
    else:
        name, kernel, plain = "int4_matmul", qm.int4_matmul, \
            qm.int4_matmul_plain
        vals = lambda w: w.q_packed  # noqa: E731
    for rows, in_dim, out_dim in QMM_CASES[bits]:
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

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lines = []
    for rows, in_dim, out_dim, out_dtype in QMM_SHAPES:
        x, w = qmm_case(rows, in_dim, out_dim, bits, 60, dev)
        run = lambda: kernel(x, vals(w), w.scale,  # noqa: E731
                             out_dtype=out_dtype)
        got = run()
        expect = plain(x, vals(w), w.scale, out_dtype=torch.float32)
        torch.cuda.synchronize()
        tol = QMM_F32_TOL if out_dtype == torch.float32 else KERNEL_TOL
        err = within(got, expect, f"{name} at {rows}x{in_dim}x{out_dim}", tol)
        del got, expect
        # library yardstick: one bf16 cuBLAS product on the dequantized
        # weight (made beforehand, not timed; the port never calls it)
        q = w.q if bits == 8 else unpack_int4(w.q_packed)
        wd = (q.float() * w.scale).bfloat16()
        del q

        def library():
            if out_dtype == torch.float32:
                return torch.mm(x, wd, out_dtype=out_dtype)
            return torch.mm(x, wd)

        # three readings of each, in turns in this one call
        ms, library_ms = [], []
        for _ in range(3):
            ms.append(time_ms(run, iters=20))
            library_ms.append(time_ms(library, iters=20))
        bound, by = qmm_bound(rows, in_dim, out_dim, bits,
                              4 if out_dtype == torch.float32 else 2)
        mid, lib_mid = sorted(ms)[1], sorted(library_ms)[1]
        flops = 2 * rows * in_dim * out_dim
        line = {
            "ms": mid, "ms_runs": ms, "library_ms": lib_mid,
            "library_ms_runs": library_ms, "bound_ms": bound,
            "bound_by": by, "max_abs_err": err,
            "tflops": flops / mid / 1e9,
            "weight_gb_s": in_dim * out_dim * bits / 8 / mid / 1e6,
            "bound_share": bound / mid, "vs_library": mid / lib_mid,
            "host_us": host_us(run), "library_host_us": host_us(library),
        }
        plan = qm.k4_plan if bits == 8 else qm.k5_plan
        line["plan"] = dict(zip(("config", "splits", "grid"),
                                plan(rows, in_dim, out_dim, sms)))
        if not lines:
            line["plain_ms"] = time_ms(
                lambda: plain(x, vals(w), w.scale, out_dtype=out_dtype),
                iters=3)
        print(f"  {name} at {rows}x{in_dim}x{out_dim} "
              f"{str(out_dtype)[6:]}: " + json.dumps(line), flush=True)
        lines.append(line)
        del x, w, wd
        torch.cuda.empty_cache()
    main = lines[0]
    return {
        "name": name,
        "route": "cuda",
        "source": "vgate_tpu_torch/csrc/dequant_matmul.cu",
        "replaces": "vgate_tpu/ops/pallas/quant_matmul.py:"
                    + ("156" if bits == 8 else "191"),
        **{k: main[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                "bound_by", "library_ms")},
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
    no kernels, the plain attention ``attn`` over the whole sequence with
    each layer's window, softcap and query scale."""
    from vgate_tpu_torch.models import decoder as dec

    S = tokens.shape[1]
    pos = torch.arange(S, device=tokens.device)[None, :]
    sl = torch.tensor([S], dtype=torch.int32, device=tokens.device)
    x = dec._embed(params, spec, tokens)
    for l in range(spec.num_layers):
        lp = dec.layer_params(params, l)
        q, k, v = dec.qkv(x, lp, spec, pos)
        attn_out = attn(q, k, v, sl, **dec.attn_options(spec, l))
        x = dec._finish_layer(x, attn_out, lp, spec)
    return dec._logits(params, spec, x[:, -1])


def staged_logits(params, spec, stages, attn):
    """Last-token logits of a plain forward that runs the kernel path's
    passes as they ran: ``stages`` is a list of ``(tokens [1, S], n,
    routes)``, each a pass over a padded batch of ``S`` rows whose first
    ``n`` are real, starting after the real tokens of the stages before
    it.  Each pass's queries attend the earlier passes' real keys and its
    own (causal, keys up to ``n``) through the plain ``attn``, and each
    pass's MLP sees its own ``[1, S]`` rows.  A MoE layer's capacity
    comes from that shape, so this is how a plain forward routes as the
    engine's prompt, suffix and decode passes do.  ``routes`` (a MoE
    pass's routing as the kernel pass chose it, one entry a layer, from
    ``recorded_routing``) is replayed in place of the plain forward's
    own, so a token that sits near a tie between two experts goes where
    the kernel path sent it and only the arithmetic differs."""
    from vgate_tpu_torch.models import decoder as dec

    dev = stages[0][0].device
    xs = [dec._embed(params, spec, t) for t, _, _ in stages]
    starts = [sum(n for _, n, _ in stages[:i]) for i in range(len(stages))]
    real = dec._route
    try:
        for l in range(spec.num_layers):
            lp = dec.layer_params(params, l)
            keys, values = [], []
            for i, ((tok, n, routes), P) in enumerate(zip(stages, starts)):
                S = tok.shape[1]
                pos = (P + torch.arange(S, device=dev))[None]
                q, k, v = dec.qkv(xs[i], lp, spec, pos)
                qf = torch.cat([q.new_zeros((1, P, *q.shape[2:])), q], 1)
                out = attn(qf, torch.cat(keys + [k], 1),
                           torch.cat(values + [v], 1),
                           torch.tensor([P + n], dtype=torch.int32,
                                        device=dev),
                           **dec.attn_options(spec, l))[:, P:]
                if routes is not None:
                    dec._route = replayed_route(routes[l])
                xs[i] = dec._finish_layer(xs[i], out, lp, spec)
                dec._route = real
                keys.append(k[:, :n])
                values.append(v[:, :n])
    finally:
        dec._route = real
    tok, n, _ = stages[-1]
    return dec._logits(params, spec, xs[-1][:, n - 1])


@contextlib.contextmanager
def recorded_routing():
    """Every MoE layer's routing (``decoder._route``: gate values and
    expert ids) while the block runs, in call order: a forward pass
    appends one entry a layer."""
    from vgate_tpu_torch.models import decoder as dec

    real, routes = dec._route, []

    def route(xt, router, k):
        out = real(xt, router, k)
        routes.append(out)
        return out

    dec._route = route
    try:
        yield routes
    finally:
        dec._route = real


def replayed_route(route):
    """A stand-in for ``decoder._route`` that returns ``route``, the
    routing recorded for the same rows (checked by shape)."""
    def fixed(xt, router, k):
        vals, idx = route
        check(tuple(idx.shape) == (xt.shape[0], k),
              f"replayed routing {tuple(idx.shape)} for {xt.shape[0]} rows")
        return vals, idx

    return fixed


def plain_w8a8(x, w, out_dtype):
    """W8A8 (W4A8 on a packed weight) computed apart from the port's
    code: each row of ``x`` quantized to int8 by its absmax / 127 with
    round half to even, its product with the weight's integers in fp64
    (exact: every sum stays below 2^53), times the row's scale and the
    weight's ``[out]`` scale, then the cast."""
    from vgate_tpu_torch.ops.quant import PackedQTensor, unpack_int4

    x32 = x.float()
    amax = x32.abs().amax(-1, keepdim=True).clamp(min=1e-8)
    x_scale = amax / torch.full_like(amax, 127.0)
    x_q = torch.clamp(torch.round(x32 / x_scale), -127, 127)
    q = unpack_int4(w.q_packed) if isinstance(w, PackedQTensor) else w.q
    acc = x_q.double() @ q.double()
    return (acc * x_scale.double() * w.scale.double()).to(out_dtype)


@contextlib.contextmanager
def plain_matmuls():
    """The decoder's quantized projections (MoE experts one at a time
    included) through the plain versions of K4/K5 instead of the
    kernels, and W8A8/W4A8 projections through ``plain_w8a8`` instead of
    the port's int8 products, for the plain forwards the kernel path is
    held to (plain weights are unaffected)."""
    from vgate_tpu_torch.models import decoder as dec
    from vgate_tpu_torch.ops.kernels import quant_matmul as qm
    from vgate_tpu_torch.ops.quant import PackedQTensor, QTensor

    real, real_experts = dec.weighted_einsum, dec.int8_native_experts

    def plain(subscripts, x, w, preferred_element_type=None,
              int8_native=False):
        out_dtype = preferred_element_type or x.dtype
        if int8_native and isinstance(w, (QTensor, PackedQTensor)):
            return plain_w8a8(x, w, out_dtype)
        if isinstance(w, QTensor):
            return qm.int8_matmul_plain(x, w.q, w.scale, out_dtype)
        if isinstance(w, PackedQTensor):
            return qm.int4_matmul_plain(x, w.q_packed, w.scale, out_dtype)
        return real(subscripts, x, w, preferred_element_type)

    def experts(subscripts, x, w):
        return torch.stack([
            plain_w8a8(x[e], type(w)(*(part[e] for part in w)), x.dtype)
            for e in range(x.shape[0])
        ])

    dec.weighted_einsum, dec.int8_native_experts = plain, experts
    try:
        yield
    finally:
        dec.weighted_einsum, dec.int8_native_experts = real, real_experts


def pooled_attention(base, pooled_from):
    """``base`` attention whose query rows from ``pooled_from`` on read
    quantized-then-dequantized K/V, as the kernel path's rows that read
    an int8 pool do (a decode step, a suffix pass); earlier rows attend
    the fresh K/V, as a prompt pass does."""
    from vgate_tpu_torch.ops.kv_quant import dequantize, quantize

    def attn(q, k, v, sl, **kw):
        out = base(q, k, v, sl, **kw)
        pooled = base(q, dequantize(*quantize(k)), dequantize(*quantize(v)),
                      sl, **kw)
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
    through the plain versions of K4/K5 there (``plain_matmuls``).  A
    MoE model's plain forwards run the kernel path's own passes with its
    routing replayed (``staged_logits``): otherwise a token near a tie
    between two experts goes to either in two forwards that differ only
    in rounding, and the floor grows to the size of the logits."""

    def __init__(self, core) -> None:
        self.core = core
        self.kv_int8 = core.geometry.kv_dtype == "int8"
        self.report: dict = {}
        self._refs: dict = {}

    def _plain(self, seq, pooled_from, stages=None):
        from vgate_tpu_torch.ops.attention import (
            causal_prefill_attention,
            flash_prefill_attention,
        )

        if not self.kv_int8:
            pooled_from = None
        key = (tuple(seq[0].tolist()), pooled_from)
        if stages is not None:
            key = tuple((tuple(t[0].tolist()), n) for t, n, _ in stages)
        if key not in self._refs:
            params, spec = self.core.params, self.core.spec
            attns = [causal_prefill_attention, flash_prefill_attention]
            if pooled_from is not None:
                attns = [pooled_attention(a, pooled_from) for a in attns]
            with plain_matmuls():
                self._refs[key] = tuple(
                    reference_logits(params, spec, seq, a) if stages is None
                    else staged_logits(params, spec, stages, a)
                    for a in attns
                )
        return self._refs[key]

    def __call__(self, what: str, got, seq, pooled_from=None,
                 stages=None) -> int:
        """Compare ``got`` [1, V] with the plain forward over ``seq``
        [1, n] (with ``stages``, the staged plain forward over the kernel
        path's own padded passes and routing, ``staged_logits``; bf16
        pools only); returns the plain argmax."""
        check(stages is None or not self.kv_int8,
              "staged plain forwards take bf16 pools")
        ref, alt = self._plain(seq, pooled_from, stages)
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
    # a MoE forward routes by the pass's padded shape: the plain forward
    # runs the same passes with the same routing (staged_logits)
    moe = spec.is_moe
    with torch.no_grad():
        with recorded_routing() as prompt_routes:
            got = prefill_forward(core.params, spec, tok, sl, kp, vp,
                                  pt[:, : S // ps])
        stages = [(tok, n, prompt_routes)]
        nxt = compare("prefill", got, seq, stages=stages if moe else None)
        with recorded_routing() as step_routes:
            got = decode_forward(
                core.params, spec,
                torch.tensor([nxt], dtype=torch.int32, device=dev),
                torch.tensor([n], dtype=torch.int32, device=dev), kp, vp,
                pt,
            )
        nxt_t = torch.tensor([[nxt]], dtype=torch.int32, device=dev)
        stages.append((nxt_t, 1, step_routes))
        compare("decode", got, torch.cat([seq, nxt_t], 1), pooled_from=n,
                stages=stages if moe else None)
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
            with recorded_routing() as routes:
                prefill_forward(core.params, spec, tok, i32([start]), kp,
                                vp, i32([pages]))
            stages = [(tok, start, routes)]
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
            with recorded_routing() as routes:
                got = prefill_suffix_forward(
                    core.params, spec, tok, i32([start]), i32([n - start]),
                    kp, vp, i32([own[: S // ps + int(unaligned)]]),
                    i32([shared + own]), unaligned=unaligned,
                )
            stages.append((tok, n - start, routes))
            compare(what, got, seq, pooled_from=start,
                    stages=stages if spec.is_moe else None)
    return compare.report


# served logprobs vs the log-softmax of a plain forward's logits: at
# least this (about one bf16 step of a logprob near -1), and at least 3x
# the two plain forwards' difference at the compared ids (the rule of
# LogitsCheck, restricted to those ids)
LOGPROB_TOL = 1e-2


def check_logprobs(engine, core, text: str) -> dict:
    """A greedy request with ``logprobs`` and ``top_logprobs`` 5 through
    ``VGTEngine``: the prompt pass's first token and one decode step (a
    graph replay on the card).  Each position's chosen logprob and top 5
    (ids and logprobs) are held to the log-softmax of a plain
    full-sequence forward's logits (``LogitsCheck``): the served top
    ids are the plain top 5 wherever the plain logprobs are further
    apart than the tolerance (a near-tie may go either way), and every
    served logprob is within the tolerance of the plain one at its id."""
    from vgate_tpu_torch.backends.base import SamplingParams

    sp = SamplingParams(max_tokens=2, temperature=0.0, logprobs=True,
                        top_logprobs=5)
    [r] = engine.generate_batch([text], [sp])
    check(r.logprobs is not None and len(r.logprobs) == r.num_tokens == 2,
          f"logprobs: {r.logprobs!r} for {r.num_tokens} tokens")
    seq = prompt_tokens(core, text)
    compare = LogitsCheck(core)
    report = {}
    for i, (what, entry) in enumerate(zip(("prefill", "decode"),
                                          r.logprobs)):
        ctx = seq if i == 0 else torch.cat(
            [seq, torch.tensor([[r.token_ids[0]]], dtype=seq.dtype,
                               device=seq.device)], 1)
        with torch.no_grad():
            ref, alt = compare._plain(ctx, None)
        plain = torch.log_softmax(ref.float(), -1)[0]
        other = torch.log_softmax(alt.float(), -1)[0]
        ids = [e["token_id"] for e in entry["top_logprobs"]]
        lps = torch.tensor([e["logprob"] for e in entry["top_logprobs"]])
        top = plain.topk(6)
        plain_ids, plain_top = top.indices.tolist(), top.values.cpu()
        compared = torch.tensor(sorted(set(ids + plain_ids)),
                                device=plain.device)
        floor = float((other - plain)[compared].abs().max())
        tol = max(LOGPROB_TOL, 3 * floor)
        at_ids = plain[torch.tensor(ids, device=plain.device)].cpu()
        err = {
            "chosen": abs(entry["logprob"] - float(plain[entry["token_id"]])),
            "top": float((lps - at_ids).abs().max()),
            "top_sorted": float((lps - plain_top[:5]).abs().max()),
        }
        gaps = (plain_top[:-1] - plain_top[1:]).tolist()
        # position j may differ only inside a near-tie with a neighbour
        id_ok = all(a == b or gaps[j] <= tol or (j and gaps[j - 1] <= tol)
                    for j, (a, b) in enumerate(zip(ids, plain_ids)))
        report[what] = {"max_abs_err": err, "plain_vs_plain": floor,
                        "tol": tol, "ids": ids,
                        "plain_ids": plain_ids[:5], "ids_match": id_ok}
        check(len(ids) == 5 and entry["token_id"] == r.token_ids[i],
              f"{what} logprob entry {entry}")
        check(max(err.values()) <= tol and id_ok,
              f"{what} logprobs off the plain forward's: {report[what]}")
    return report


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


def profile_burst(engine, batch, core) -> dict:
    """Where the time goes in one warm burst: the device's busy share
    (kernel time over wall time; one stream, so kernels do not overlap),
    its device ops over the decode steps ``core`` ran (prompt passes
    included), and the kernels that take the most device time, from
    torch.profiler (CUPTI sees the engine thread's launches, and each
    kernel node of a graph replay)."""
    from torch.profiler import ProfilerActivity, profile

    steps0 = core.get_stats()["steps"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.generate_batch(*batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    steps = core.get_stats()["steps"] - steps0
    kernels = {}
    graph_launches = 0
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            entry = kernels.setdefault(evt.name, [0, 0.0])
            entry[0] += 1
            entry[1] += evt.device_time_total / 1e3  # ms
        elif evt.name == "cudaGraphLaunch":
            graph_launches += 1
    busy_ms = sum(ms for _, ms in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:8]
    groups = {}
    for group, parts in PROFILE_GROUPS.items():
        hits = [v for name, v in kernels.items()
                if all(p in name for p in parts)]
        if hits:
            groups[group] = {"count": sum(n for n, _ in hits),
                             "ms": sum(ms for _, ms in hits)}
    return {
        "wall_ms": wall * 1e3,
        "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / (wall * 1e3),
        "device_ops": sum(n for n, _ in kernels.values()),
        "decode_steps": steps,
        "device_ops_per_step": sum(n for n, _ in kernels.values()) / steps,
        # decode chunks replayed as graphs (their kernels are counted by
        # name above, as CUPTI reports each node)
        "graph_launches": graph_launches,
        "top": [{"name": name[:90], "count": n, "ms": ms}
                for name, (n, ms) in top],
        "groups": groups,
    }


# kernel totals a profile reports by name: K4 and K5 on decode rows (the
# 64-row tile whose consumers split the columns) and on prompt rows, the
# split-k sums (K4's in the int8 phase, K5's in the int4 phase), K3-int8,
# K1 (and K1-int8) and its chunk merges where they launch apart, K6 and
# its chunk merges
PROFILE_GROUPS = {
    "int8_matmul decode rows": ("dequant_mm_kernel", "true, false>"),
    "int8_matmul prompt rows": ("dequant_mm_kernel", "false, false>"),
    "int4_matmul decode rows": ("dequant_mm_kernel", "true, true>"),
    "int4_matmul prompt rows": ("dequant_mm_kernel", "false, true>"),
    "split-k sums": ("(anonymous namespace)::reduce_kernel",),
    "paged_multitok_attention_int8": ("paged_multitok_i8_kernel",),
    "paged_decode_attention (K1, K1-int8)": ("paged_decode_tc_kernel",),
    "K1 chunk merges": ("split::tc_merge_kernel",),
    "paged_decode_attention_blocked (K6)": ("paged_decode_split_kernel",),
    "K6 chunk merges": ("split::merge_kernel",),
}


def kernel_wrappers() -> dict:
    from vgate_tpu_torch.ops.kernels.flash_prefill import (
        flash_prefill_attention,
    )
    from vgate_tpu_torch.ops.kernels.leaf_digest import leaf_digest
    from vgate_tpu_torch.ops.kernels.paged_decode import (
        paged_decode_attention,
        paged_decode_attention_blocked,
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
                                    int8_matmul, int4_matmul,
                                    paged_decode_attention_blocked,
                                    leaf_digest)}


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


def check_graphed(stats: dict, what: str, since=None) -> None:
    """Every decode chunk the engine dispatched (since the stats
    ``since``) was the replay of a captured graph."""
    g = stats["decode_graphs"]
    chunks, replays = stats["chunks"], g["replays"]
    if since is not None:
        chunks -= since["chunks"]
        replays -= since["decode_graphs"]["replays"]
    check(g["enabled"] and g["captured"] >= 1 and chunks > 0
          and replays == chunks,
          f"{what}: {replays} graph replays for {chunks} decode chunks")


def captures(core) -> list:
    """(key, seconds) of every decode graph ``core`` captured, in order
    (none on the CPU)."""
    return [] if core._graphs is None else core._graphs.capture_log


def new_captures(core, since: int) -> list:
    """The captures after the first ``since``, keys as lists: (chunk
    steps, all greedy, logprobs, penalties, bias width, stop width)."""
    return [{"key": list(key), "capture_s": sec}
            for key, sec in captures(core)[since:]]


def warm_up(core, what: str) -> dict:
    """``EngineCore.warmup`` right after an engine starts, as the
    reference's benchmark calls it before it measures.  Prints its
    seconds and the graphs it captured, then sets the launch counts to 0
    (the warm-up serves no request)."""
    n0 = len(captures(core))
    seconds = core.warmup()
    caught = new_captures(core, n0)
    report = {"warmup_s": seconds, "graphs_captured": len(caught),
              "capture_s": sum(c["capture_s"] for c in caught)}
    print(f"{what} warm-up: {seconds:.2f} s, {report['graphs_captured']} "
          f"decode graphs captured in {report['capture_s']:.2f} s",
          flush=True)
    reset_launches()
    return report


def check_settled(core) -> dict:
    stats = core.get_stats()
    check(stats["used_pages"] == 0, f"{stats['used_pages']} pages leak")
    check(stats["running"] == 0, "sequences still running")
    check(stats["scheduler"]["waiting"] == 0, "sequences still waiting")
    return stats


# ``EngineCore.pressure_signals`` keys, as the reference's: these with the
# host swap tier off, and its occupancy block too with it on
PRESSURE_KEYS = {"kv_free_ratio", "kv_truly_free_ratio",
                 "prefix_cached_ratio", "kv_token_capacity", "kv_dtype",
                 "engine_queue_depth", "running"}
SWAP_PRESSURE_KEYS = {"kv_swap_enabled", "kv_host_pool_bytes",
                      "kv_host_pool_budget_bytes", "kv_host_free_ratio",
                      "kv_swapped_seqs"}


class TokenWatch:
    """While installed, every sequence submitted through
    ``core.submit_prompt`` (the backend's calls included) also calls
    ``hook(prompt, token)`` at each of its tokens, on the engine thread
    inside readback (so the hook only sets events or fires tokens), and
    is kept in ``seqs`` by prompt, with the host times of its first and
    last token in ``first_t`` and ``last_t``."""

    def __init__(self, core, hook=None):
        self.core, self.hook, self.seqs = core, hook, {}
        self.first_t, self.last_t = {}, {}

    def __enter__(self):
        plain = self.core.submit_prompt

        def submit_prompt(prompt, params, stream_cb=None, meta=None):
            def cb(token):
                now = time.perf_counter()
                self.first_t.setdefault(prompt, now)
                self.last_t[prompt] = now
                if stream_cb is not None:
                    stream_cb(token)
                if self.hook is not None:
                    self.hook(prompt, token)

            seq = plain(prompt, params, stream_cb=cb, meta=meta)
            self.seqs[prompt] = seq
            return seq

        self.core.submit_prompt = submit_prompt
        return self

    def __exit__(self, *exc):
        del self.core.submit_prompt


def when_started(n: int, tokens: int = 1):
    """A token hook and the event it sets once ``n`` distinct prompts
    have ``tokens`` tokens each."""
    counts, started = {}, threading.Event()

    def hook(prompt, token):
        counts[prompt] = counts.get(prompt, 0) + 1
        if sum(c >= tokens for c in counts.values()) >= n:
            started.set()

    return hook, started


async def wait_event(event: threading.Event, what: str,
                     timeout: float = 600.0) -> None:
    loop = asyncio.get_running_loop()
    ok = await loop.run_in_executor(None, event.wait, timeout)
    check(ok, f"{what} did not happen within {timeout:.0f} s")


def check_phase_launches(core, stats0, launches, what: str,
                         prefix_cache: bool) -> dict:
    """A backend phase's launch counts: K1 once a layer for every decode
    step, K2 (and with the prefix cache, K3) once a layer for every
    prompt pass, every decode chunk a graph replay."""
    stats = core.get_stats()
    L = core.spec.num_layers
    steps = stats["steps"] - stats0["steps"]
    passes = stats["prompt_passes"] - stats0["prompt_passes"]
    graphs, graphs0 = stats["decode_graphs"], stats0["decode_graphs"]
    k1 = launches["paged_decode_attention"]
    k2 = launches["flash_prefill_attention"]
    k3 = launches["paged_multitok_attention"]
    check(steps > 0 and k1 == L * steps,
          f"{what}: {k1} K1 launches for {steps} decode steps of {L} layers")
    if prefix_cache:
        check(passes > 0 and k2 + k3 == L * passes,
              f"{what}: K2 {k2} + K3 {k3} launches for {passes} prompt "
              f"passes of {L} layers")
    else:
        check(passes > 0 and k2 == L * passes and k3 == 0,
              f"{what}: K2 {k2}, K3 {k3} launches for {passes} prompt "
              f"passes of {L} layers")
    check_graphed(stats, what, since=stats0)
    return {"decode_steps": steps, "prompt_passes": passes,
            "chunks": stats["chunks"] - stats0["chunks"],
            # the chunk keys this phase captured first (keys the warm-up
            # leaves cold, as the reference's: logprobs, penalties,
            # min-tokens), and their capture time (inside its requests)
            "graphs_captured": graphs["captured"] - graphs0["captured"],
            "capture_s": graphs["capture_s"] - graphs0["capture_s"],
            "captured_keys": new_captures(core, graphs0["captured"])}


def backend_settled_and_drain(engine, core, batch, results, device) -> dict:
    """The backend phase on the prefix-off engine, on one asyncio loop:
    the burst through one ``generate_settled_async`` call repeats the
    burst served through ``generate`` token for token; then 8 requests of
    256 tokens decode and ``abort_in_flight("drain")`` settles every one
    with "abort", no page leaks, and the burst served after the sweep
    repeats again."""
    from vgate_tpu_torch.backends.base import SamplingParams

    backend = engine.backend
    texts = prompts()
    long = SamplingParams(max_tokens=256, min_tokens=256, temperature=0.0)

    async def run() -> dict:
        settled = await backend.generate_settled_async(*batch)
        check(all(not isinstance(r, BaseException) for r in settled),
              f"settled burst failed: {settled}")
        check([r.token_ids for r in settled]
              == [r.token_ids for r in results],
              "the settled burst differs from the burst served by generate")
        # every request past its prompt pass and a decode chunk
        hook, started = when_started(len(texts), tokens=2)
        with TokenWatch(core, hook):
            task = asyncio.ensure_future(backend.generate_settled_async(
                texts, [long] * len(texts)))
            await wait_event(started, "8 requests decoding")
            backend.abort_in_flight("drain")
            swept = await task
        check([r.finish_reason for r in swept] == ["abort"] * len(texts),
              f"drain sweep finish reasons "
              f"{[r.finish_reason for r in swept]}")
        check(all(2 <= r.num_tokens < 256 for r in swept),
              f"drain sweep tokens {[r.num_tokens for r in swept]}")
        after_sweep = check_settled(core)
        again = await backend.generate_settled_async(*batch)
        check([r.token_ids for r in again]
              == [r.token_ids for r in results],
              "the burst served after the drain sweep differs")
        return {
            "settled_burst_rows": len(settled),
            "drain_sweep_tokens": [r.num_tokens for r in swept],
            "aborted": after_sweep["scheduler"]["aborted"],
        }

    reset_launches()
    stats0 = core.get_stats()
    out = asyncio.run(run())
    launches = read_launches()
    if device == "cuda":
        out["counts"] = check_phase_launches(
            core, stats0, launches, "backend phase, prefix-off engine",
            prefix_cache=False)
    check_settled(core)
    out["launches"] = launches
    return out


def backend_streams_cancel_signals(engine, core, device) -> dict:
    """The backend phase on the prefix-on engine, on one asyncio loop:
    8 concurrent ``stream_async`` calls (6 greedy, 1 seeded, 1 with
    logprobs and top 5), each stream's joined deltas equal to its
    sequence's final text, its usage to the sequence's counts and its
    logprob entries to its tokens; the time to each stream's first delta
    (random weights over a byte tokenizer: most ids decode to no text,
    so a stream may yield its first delta late, or none), to its first
    token, and the streams' decode tokens/s, with the graphs captured
    inside their window; the same 8 streams again on the same engine,
    which must capture none; one ``generate_settled_async``
    batch of 4 requests of 256 tokens with one cancelled by its
    ``CancelToken`` after its first token (it settles "abort" with fewer
    tokens, the others run to 256, the pages in use return to their
    count before the batch); then the pressure, health and device
    signals."""
    from vgate_tpu_torch.backends.base import SamplingParams
    from vgate_tpu_torch.lifecycle import CancelToken

    backend = engine.backend
    texts = prompts()
    greedy = SamplingParams(max_tokens=32, temperature=0.0)
    params = [greedy] * 6 + [
        SamplingParams(max_tokens=32, temperature=0.8, top_p=0.9, top_k=50,
                       seed=1234),
        SamplingParams(max_tokens=32, temperature=0.0, logprobs=True,
                       top_logprobs=5),
    ]

    async def stream(prompt, sp):
        pieces, usage, finish = [], [], []
        t0 = time.perf_counter()
        t_first = None
        async for piece in backend.stream_async(
            prompt, sp, on_usage=usage.append, on_finish=finish.append
        ):
            if t_first is None:
                t_first = time.perf_counter()
            pieces.append(piece)
        return {"pieces": pieces, "usage": usage, "finish": finish,
                "t0": t0, "t_first": t_first, "t_end": time.perf_counter()}

    async def streams_pass() -> dict:
        """The 8 streams at once, each checked against its sequence;
        returns the pass's times, its decode rate and the graphs
        captured inside it."""
        n0 = len(captures(core))
        with TokenWatch(core) as watch:
            streams = await asyncio.gather(
                *(stream(t, sp) for t, sp in zip(texts, params)))
        for text, sp, st in zip(texts, params, streams):
            seq = watch.seqs[text]
            pieces = st["pieces"]
            if sp.logprobs:
                check(all(isinstance(p, dict) for p in pieces),
                      "a logprobs stream yielded a bare delta")
                joined = "".join(p["text"] for p in pieces)
                entries = [e for p in pieces for e in p["logprobs"]]
                check(len(entries) == seq.num_output_tokens
                      and [e["token_id"] for e in entries]
                      == seq.generated_ids
                      and all(len(e["top_logprobs"]) == 5 for e in entries),
                      "streamed logprob entries do not match the tokens")
            else:
                joined = "".join(pieces)
            check(joined == core.final_text(seq),
                  "a stream's joined deltas differ from its final text")
            check(st["usage"] == [{
                "prompt_tokens": seq.orig_prompt_len,
                "completion_tokens": seq.num_output_tokens,
                "total_tokens": seq.orig_prompt_len + seq.num_output_tokens,
            }], f"stream usage {st['usage']}")
            check(st["finish"] == [seq.finish_reason]
                  and seq.finish_reason in ("stop", "length"),
                  f"stream finish {st['finish']}")
            check((st["t_first"] is None) == (not pieces), "delta times")
        delta = sorted(st["t_first"] - st["t0"] for st in streams
                       if st["t_first"] is not None)
        token = sorted(watch.first_t[t] - st["t0"]
                       for t, st in zip(texts, streams))
        decoded = sum(s.num_output_tokens - 1 for s in watch.seqs.values())
        decode_s = max(watch.last_t[t] - watch.first_t[t] for t in texts)
        caught = new_captures(core, n0)
        return {
            "streams": len(streams),
            "streams_with_a_delta": len(delta),
            "ttft_first_delta_s_p50": delta[len(delta) // 2] if delta
            else None,
            "ttft_first_delta_s_max": delta[-1] if delta else None,
            "ttft_first_token_s_p50": token[len(token) // 2],
            "ttft_first_token_s_max": token[-1],
            "decode_tok_s": decoded / decode_s,
            "tokens": [s.num_output_tokens for s in watch.seqs.values()],
            # captured inside the streams' window, and their seconds
            "graphs_captured_in_window": len(caught),
            "capture_s_in_window": sum(c["capture_s"] for c in caught),
            "captured_keys": caught,
        }

    async def run() -> dict:
        # the streams twice on one engine: the second pass finds every
        # key the first captured, and must capture none
        stream_report = {"first_pass": await streams_pass(),
                         "second_pass": await streams_pass()}
        check(stream_report["second_pass"]["graphs_captured_in_window"]
              == 0, "the second pass of the streams captured a graph")

        before = core.get_stats()
        tokens = [None, CancelToken(), None, None]
        target = texts[1]

        def cancel_after_first(prompt, token):
            if prompt == target:
                tokens[1].cancel("client_disconnect")

        long = SamplingParams(max_tokens=256, min_tokens=256,
                              temperature=0.0)
        with TokenWatch(core, cancel_after_first):
            out = await backend.generate_settled_async(
                texts[:4], [long] * 4, cancel_tokens=tokens)
        check(out[1].finish_reason == "abort"
              and 1 <= out[1].num_tokens < 256,
              f"cancelled row: {out[1].finish_reason}, "
              f"{out[1].num_tokens} tokens")
        for i in (0, 2, 3):
            check(out[i].finish_reason == "length"
                  and out[i].num_tokens == 256,
                  f"row {i} beside the cancel: {out[i].finish_reason}, "
                  f"{out[i].num_tokens} tokens")
        after = check_settled(core)
        check(after["used_pages"] == before["used_pages"],
              f"pages in use {before['used_pages']} -> "
              f"{after['used_pages']}")
        check(after["scheduler"]["aborted"]
              == before["scheduler"]["aborted"] + 1, "abort not counted")
        cancel_report = {
            "cancelled_tokens": out[1].num_tokens,
            "used_pages": after["used_pages"],
            "cached_pages": after["scheduler"]["prefix_cache"][
                "cached_pages"],
        }

        sig = backend.pressure_signals()
        check(set(sig) == PRESSURE_KEYS, f"pressure signal keys {set(sig)}")
        for key in ("kv_free_ratio", "kv_truly_free_ratio",
                    "prefix_cached_ratio"):
            check(0.0 <= sig[key] <= 1.0, f"{key} {sig[key]}")
        health = backend.serving_health()
        check(health["state"] == "serving" and health["alive"]
              and health["ready"], f"serving health {health}")
        dev = backend.device_health()
        if device == "cuda":
            check(dev["alive"] and dev["platform"] == "gpu"
                  and dev["device_kind"] == torch.cuda.get_device_name(0),
                  f"device health {dev}")
        return {"streams": stream_report, "cancellation": cancel_report,
                "pressure_signals": sig, "device_health": dev}

    reset_launches()
    stats0 = core.get_stats()
    out = asyncio.run(run())
    launches = read_launches()
    if device == "cuda":
        out["counts"] = check_phase_launches(
            core, stats0, launches, "backend phase, prefix-on engine",
            prefix_cache=True)
    out["launches"] = launches
    return out


def engine_config(model: str, device: str, quantization=None,
                  kv_dtype: str = "auto", host_swap_bytes: int = 0,
                  sections=None, **device_section):
    """The smoke's engine config; ``sections`` adds other config sections
    (recovery, integrity)."""
    from vgate_tpu_torch.config import load_config

    return load_config(
        model={"model_id": model, "engine_type": "torch_cuda",
               "dtype": "bfloat16", "max_model_len": 2048,
               "quantization": quantization},
        kv_cache={"dtype": kv_dtype, "host_swap_bytes": host_swap_bytes},
        device={"device": device, **device_section},
        logging={"level": "WARNING"},
        **(sections or {}),
    )


def start_engine(cfg, what: str):
    """A ``VGTEngine`` and the core its backend serves: the
    ``EngineSupervisor`` around the live ``EngineCore``
    (``recovery.enabled`` is on by default), which hands every read of an
    engine attribute to the live core; an attribute is set on the live
    core itself (``live_core``)."""
    from vgate_tpu_torch.engine import VGTEngine

    t0 = time.perf_counter()
    engine = VGTEngine(cfg)
    core = engine.backend.core
    print(f"{what} engine up in {time.perf_counter() - t0:.1f} s: "
          f"{cfg.model.model_id}, {core.geometry.num_pages} KV pages",
          flush=True)
    return engine, core


def live_core(core):
    """The live ``EngineCore`` of a supervised engine (or ``core``)."""
    return getattr(core, "core", core)


def check_no_guard_trips(core, what: str) -> dict:
    """Every decode chunk's guard words were 0 (a nonzero word trips a
    sentinel: a crash the supervisor would count) and no sentinel
    tripped; returns the engine's integrity block."""
    stats = core.get_stats()
    block = stats.get("integrity", {})
    check(block.get("sentinel_trips") == {},
          f"{what}: sentinel trips {block.get('sentinel_trips')}")
    sup = stats.get("supervisor")
    if sup is not None:
        check(sup["crashes"] == 0, f"{what}: {sup['crashes']} crashes")
    return block


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
              reference_prompts=(), swap_prompts=()) -> dict:
    """The first path: the engine's warm-up, then a 9-request burst (8
    greedy, 1 seeded sampled) on an engine with the prefix cache off,
    twice (the first must capture no graph), then a profiled burst, then
    greedy streams of ``reference_prompts`` for the prefix phase to
    compare with, and of ``swap_prompts`` (the host-swap phase's wave,
    unpressured here).  Returns the weight tree under ``params``."""
    from vgate_tpu_torch.backends.base import SamplingParams

    engine, core = start_engine(
        engine_config(model, device, prefix_cache=False), "prefix-off"
    )
    try:
        warmup = warm_up(core, "prefix-off engine")
        texts = prompts()
        greedy = [SamplingParams(max_tokens=32, temperature=0.0)] * 8
        sampled = SamplingParams(max_tokens=32, temperature=0.8, top_p=0.9,
                                 top_k=50, seed=1234)
        batch = (texts + [texts[3]], greedy + [sampled])
        reset_launches()
        stats0 = core.get_stats()
        n0 = len(captures(core))
        results, cold = serve(engine, batch)
        launches = read_launches()
        stats = core.get_stats()
        if device == "cuda":
            check(len(captures(core)) == n0,
                  f"the first burst after the warm-up captured "
                  f"{new_captures(core, n0)}")
            # every decode step replays K1 once a layer (a graph replay
            # counts its capture's launches), every prompt pass K2
            L = core.spec.num_layers
            steps = stats["steps"] - stats0["steps"]
            passes = stats["prompt_passes"] - stats0["prompt_passes"]
            for name, n in (("paged_decode_attention", steps),
                            ("flash_prefill_attention", passes)):
                check(n > 0 and launches[name] == L * n,
                      f"{name}: {launches[name]} launches for {n} passes "
                      f"of {L} layers on the main path")
            check_graphed(stats, "the main path", since=stats0)
        check_results(results, core)
        # the integrity guard ran in every chunk: no word was nonzero
        guard = check_no_guard_trips(core, "the main path")
        # the same batch again (same bucket groups, so the same matmul
        # shapes): greedy rows and the seeded sampled row must repeat
        again, warm = serve(engine, batch)
        for a, b in zip(results, again):
            check(a.token_ids == b.token_ids,
                  "tokens differ between two identical runs")
        logprobs = check_logprobs(engine, core, texts[2])
        profiles = None
        if device == "cuda":
            # the same engine with the same chunk body run eagerly: every
            # row (8 greedy, 1 seeded) must repeat; then a warm burst each
            # way under the profiler, in one call
            live_core(core).decode_graphs = False
            eager, _ = serve(engine, batch)
            for a, b in zip(results, eager):
                check(a.token_ids == b.token_ids,
                      "the eager burst differs from the graphed burst")
            profiles = {"eager": profile_burst(engine, batch, core)}
            live_core(core).decode_graphs = True
            profiles["graphed"] = profile_burst(engine, batch, core)
        reference = engine.generate_batch(
            list(reference_prompts), greedy[:1] * len(reference_prompts)
        )
        preempts = core.get_stats()["scheduler"]["preemptions"]
        swap_reference = engine.generate_batch(
            list(swap_prompts), [swap_params()] * len(swap_prompts))
        check(core.get_stats()["scheduler"]["preemptions"] == preempts,
              "the unpressured swap wave was preempted")
        check_settled(core)
        graphs = core.get_stats()["decode_graphs"]
        captured = new_captures(core, n0)
        backend = backend_settled_and_drain(engine, core, batch, results,
                                            device)
        return {
            "warmup": warmup,
            "integrity": guard,
            # keys captured after the warm-up (all of them keys the
            # reference's warm-up leaves cold too), with their seconds
            "captured_after_warmup": captured,
            "requests": len(results),
            "tokens": sum(r.num_tokens for r in results),
            "finish": [r.finish_reason for r in results],
            "cold": cold,
            "warm": warm,
            "logits": check_model_logits(core, texts[2]),
            "logprobs": logprobs,
            "decode_graphs": graphs,
            "profile": profiles,
            "launches": launches,
            "reference_streams": [r.token_ids for r in reference],
            "swap_reference_streams": [r.token_ids for r in swap_reference],
            "burst_streams": [r.token_ids for r in results],
            "backend": backend,
            "params": core.params,
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
        warmup = warm_up(core, "prefix-on engine")
        n0 = len(captures(core))
        stats0 = core.get_stats()
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
            check_graphed(stats, "the prefix path", since=stats0)
            # every prompt here is a hit or chunked, so K2 need not run
            for name in ("paged_decode_attention", "paged_multitok_attention"):
                check(launches[name] > 0,
                      f"{name} was not launched on the prefix path")
        check(pc["hit_tokens"] > 0, f"no prefix hit: {pc}")
        check(pc["cow_copies"] >= 1, f"no copy-on-write: {pc}")
        check(pc["chunked_prefills"] >= 1, f"no chunked prefill: {pc}")
        logits = check_suffix_logits(core, system + tails[0])
        captured = new_captures(core, n0)
        backend = backend_streams_cancel_signals(engine, core, device)
        return {
            "warmup": warmup,
            "captured_after_warmup": captured,
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
            "decode_graphs": stats["decode_graphs"],
            "launches": launches,
            "logits": logits,
            "backend": backend,
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
    """``generate_batch`` over a started EngineCore, as ``VGTEngine``
    offers it (through the backend that wraps the core)."""
    import types

    from vgate_tpu_torch.backends.torch_backend import TorchCUDABackend

    backend = TorchCUDABackend()
    backend.core = core
    return types.SimpleNamespace(generate_batch=backend.generate)


# the host-swap phase (Qwen2.5-7B bf16, prefix cache off): 8 prompts of
# 600 tokens decoding 256 each hold 19 pages (of 32 tokens) a sequence
# at admission and 27 at the end, so 176 allocatable pages take the wave
# but not its growth; 1 GiB of host memory holds ~585 pages of 1.835 MB
# (28 layers x K and V x 4 heads x 32 x 128 x 2 bytes)
SWAP_NUM_PAGES = 177
SWAP_HOST_BYTES = 1 << 30


def swap_params():
    from vgate_tpu_torch.backends.base import SamplingParams

    return SamplingParams(max_tokens=256, min_tokens=256, temperature=0.0)


def swap_texts(n: int = 8, length: int = 600):
    """The host-swap phase's wave: ``n`` distinct prompts of ``length``
    bytes (the byte tokenizer makes 1 byte 1 token)."""
    return [filler(f"Request {i}: ", length, i + 1) for i in range(n)]


def first_divergence(a, b) -> int:
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                min(len(a), len(b)))


class TransferTimer:
    """Times the swap executor's calls (``read_pages`` out, ``write_pages``
    in): the payload's bytes, each call's host seconds (a swap-in returns
    once its copies are enqueued; a swap-out waits for the chunk in
    flight first), and on the card the device time between CUDA events
    recorded on the engine stream just before and after the call (host
    work the stream waits for inside the call, such as a first pinned
    allocation, included)."""

    def __init__(self, executor, cuda: bool):
        self.cuda = cuda
        self.totals = {way: {"calls": 0, "bytes": 0, "wall_s": 0.0,
                             "events": []} for way in ("out", "in")}
        for way, name in (("out", "read_pages"), ("in", "write_pages")):
            setattr(executor, name, self._timed(way, getattr(executor, name)))

    def _timed(self, way, call):
        def timed(pages, *args):
            events = None
            if self.cuda:
                events = [torch.cuda.Event(enable_timing=True)
                          for _ in range(2)]
                events[0].record()
            t0 = time.perf_counter()
            out = call(pages, *args)
            tot = self.totals[way]
            tot["wall_s"] += time.perf_counter() - t0
            if events is not None:
                events[1].record()
                tot["events"].append(events)
            payload = out if way == "out" else args[0]
            tot["calls"] += 1
            tot["bytes"] += sum(t.numel() * t.element_size()
                                for chunk in payload for t in chunk)
            return out
        return timed

    def rates(self) -> dict:
        """GB/s each way, by host seconds and by device time."""
        if self.cuda:
            torch.cuda.synchronize()
        out = {}
        for way, t in self.totals.items():
            device_ms = sum(a.elapsed_time(b) for a, b in t["events"])
            out[way] = {
                "calls": t["calls"], "bytes": t["bytes"],
                "gb_s_host_wall": t["bytes"] / t["wall_s"] / 1e9
                if t["wall_s"] else None,
                "gb_s_device": t["bytes"] / device_ms / 1e6
                if device_ms else None,
            }
        return out


# the recovery phase (Qwen2.5-7B bf16, prefix cache off, supervised by
# default): a lowered stall limit for the stall drill and a restart budget
# for its four rebuilds, the canary fingerprint recorded at boot, and a
# sweep due every 2 s checking 64 leaves a tick (the reference's own
# integrity drill sets the same two), so a flipped leaf is found within
# seconds
RECOVERY_STALL_S = 5.0  # recovery.step_stall_s in this phase
RECOVERY_DELAY_S = 8.0  # the stall drill's delay, past that limit
RECOVERY_SECTIONS = {
    # no promotion back to SERVING inside the phase: each drill starts
    # from DEGRADED and must show recovering -> degraded
    "recovery": {"backoff_base_s": 0.05, "step_stall_s": RECOVERY_STALL_S,
                 "max_restarts": 8, "degraded_probation_s": 3600.0},
    "integrity": {"canary_record_on_start": True, "sweep_interval_s": 2.0,
                  "sweep_leaves_per_tick": 64},
    # the perf window read after the warm burst holds that burst alone
    # (not the warm-up's captures before it)
    "observability": {"perf_window_s": 2.0},
}
RECOVERY_TOKENS = 64
# leaves the digest kernel is held to its plain version and to the host
# digest on: the embedding, the lm_head (1.09 GB each at 7B), one norm
# and the stacked norms of the layers
DIGEST_LEAVES = ("['embed']", "['lm_head']", "['final_norm']",
                 "['layers']['input_norm']")
# the int8 phase's: one int8 weight and its scales
DIGEST_LEAVES_INT8 = ("['layers']['q']['w'].q", "['layers']['q']['w'].scale")


def check_digests(core, paths) -> dict:
    """The digest of each named leaf of the live tree by the kernel (a
    CPU leaf: the plain version), equal to the plain version on the same
    leaf and to ``host_leaf_digest`` of the leaf copied to the host."""
    from vgate_tpu_torch import integrity
    from vgate_tpu_torch.ops.kernels.leaf_digest import leaf_digest_plain

    leaves = dict(integrity.leaves_with_path(core.params))
    out = {}
    for path in paths:
        leaf = leaves[path]
        got = integrity.leaf_digest(leaf)
        plain = leaf_digest_plain(leaf)
        host = integrity.host_leaf_digest(leaf.cpu())
        check(got == plain == host,
              f"digest of {path}: kernel {got:#010x}, plain {plain:#010x}, "
              f"host {host:#010x}")
        out[path] = {"digest": f"{got:08x}", "shape": list(leaf.shape),
                     "dtype": str(leaf.dtype).replace("torch.", "")}
    return out


def tree_bytes(params) -> int:
    from vgate_tpu_torch import integrity

    return sum(t.numel() * t.element_size()
               for _, t in integrity.leaves_with_path(params))


def sweep_report(core, device: str) -> dict:
    """One full checksum sweep over the live tree (``verify_all``, the
    pass a weights-kept rebuild runs): seconds, GB/s and the share of
    the 3.35 TB/s bound.  It runs on this thread while the engine idles
    (its own idle sweeps may interleave)."""
    verifier = core.integrity.verifier
    nbytes = tree_bytes(core.params)
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    mismatch = verifier.verify_all(core.params)
    seconds = time.perf_counter() - t0
    check(mismatch is None, f"the sweep found a mismatch on a clean tree: "
          f"{mismatch}")
    return {"leaves": len(verifier.baseline), "bytes": nbytes,
            "seconds": seconds, "gb_s": nbytes / seconds / 1e9,
            "bound_s": nbytes / H100_BYTES_PER_S,
            "share_of_bound": nbytes / H100_BYTES_PER_S / seconds}


def digest_kernel_entry(core) -> dict:
    """The digest kernel's line of the kernels JSON, timed on the
    lm_head (1.09 GB): kernel and plain version on the same leaf (their
    digests are integers, equal or not: the error is 0), the bound by
    bytes (two 32-bit integer operations an element on the CUDA cores
    are far below it), no single PyTorch call computing the function."""
    from vgate_tpu_torch import integrity
    from vgate_tpu_torch.ops.kernels.leaf_digest import (
        leaf_digest,
        leaf_digest_plain,
    )

    leaf = dict(integrity.leaves_with_path(core.params))["['lm_head']"]
    got, plain = leaf_digest(leaf), leaf_digest_plain(leaf)
    check(got == plain, f"lm_head digest {got:#010x} vs plain {plain:#010x}")
    word = torch.empty(1, dtype=torch.int32, device=leaf.device)
    nbytes = leaf.numel() * leaf.element_size()
    ops = 2 * leaf.numel()
    bound_ms = 1e3 * max(nbytes / H100_BYTES_PER_S, ops / H100_FP32_FLOPS)
    return {
        "name": "leaf_digest", "route": "cuda",
        "source": "vgate_tpu_torch/csrc/leaf_digest.cu",
        # no TPU kernel: the reference's fused XLA reduction
        "replaces": "vgate_tpu/integrity.py:102",
        "max_abs_err": float(abs(got - plain)),
        "ms": time_ms(lambda: leaf_digest(leaf, out=word), iters=20),
        "plain_ms": time_ms(lambda: leaf_digest_plain(leaf), iters=2,
                            warmup=1),
        "bound_ms": bound_ms,
        "bound_by": ("bytes" if nbytes / H100_BYTES_PER_S
                     >= ops / H100_FP32_FLOPS else "operations"),
        "library_ms": None,
        "shape": f"lm_head {list(leaf.shape)} bf16, {nbytes / 1e9:.2f} GB",
    }


class Transitions:
    """The supervisor's state transitions with their host times, wrapped
    around ``EngineSupervisor._transition`` for the phase, and the parts
    of each rebuild (``rebuild_core``: the old core's stop, then the
    whole rebuild with the successor's warm-up) in ``rebuilds``; ``close``
    puts the module's ``rebuild_core`` back."""

    def __init__(self, sup):
        from vgate_tpu_torch.runtime import supervisor

        self.sup, self.log, self.rebuilds = sup, [], []
        self._module, self._plain_rebuild = supervisor, supervisor.rebuild_core
        plain = sup._transition

        def record(new):
            self.log.append((time.perf_counter(), new.value))
            plain(new)

        def rebuild(old, config, reload_weights=False):
            t0 = time.perf_counter()
            stop = old.stop

            def timed_stop():
                t = time.perf_counter()
                stop()
                entry["stop_s"] = time.perf_counter() - t

            entry = {"reload": reload_weights}
            old.stop = timed_stop
            self.rebuilds.append(entry)
            new = self._plain_rebuild(old, config,
                                      reload_weights=reload_weights)
            entry["rebuild_s"] = time.perf_counter() - t0
            return new

        sup._transition = record
        supervisor.rebuild_core = rebuild

    def close(self) -> None:
        self._module.rebuild_core = self._plain_rebuild

    def since(self, n: int) -> list:
        return [state for _, state in self.log[n:]]

    def first(self, state: str, n: int) -> float:
        return next(t for t, s in self.log[n:] if s == state)


def wait_for(cond, what: str, timeout: float = 300.0) -> None:
    deadline = time.perf_counter() + timeout
    while not cond():
        check(time.perf_counter() < deadline,
              f"{what} did not happen within {timeout:.0f} s")
        time.sleep(0.02)


def recovery_burst(engine, sup, batch, clean, arm, what: str) -> dict:
    """Serve ``batch`` with ``arm()`` called once the first decode chunk
    of any row has been read back (2 tokens), through the supervised
    backend, and check the supervisor brought every request to its
    ``RECOVERY_TOKENS`` with nothing lost, and the tokens each had at
    the checkpoint equal the ``clean`` run's.  Returns the drill's
    timings: containment (RECOVERING) to serving (DEGRADED), and each
    replayed request's first token after the containment."""
    h0 = sup.health()
    n0 = len(sup._watch.log)
    times = {}
    fired = threading.Event()

    def hook(prompt, token):
        times.setdefault(prompt, []).append(time.perf_counter())
        if not fired.is_set() and len(times[prompt]) >= 2:
            fired.set()
            arm()

    with TokenWatch(sup, hook) as watch:
        results, wall = serve(engine, batch)
    h = sup.health()
    check(h["lost"] == h0["lost"], f"{what}: {h['lost'] - h0['lost']} lost")
    check(h["resumed"] - h0["resumed"] == len(results),
          f"{what}: {h['resumed'] - h0['resumed']} of {len(results)} resumed")
    check(h["restarts"] == h0["restarts"] + 1,
          f"{what}: restarts {h0['restarts']} -> {h['restarts']}")
    check(sup._watch.since(n0) == ["recovering", "degraded"],
          f"{what}: transitions {sup._watch.since(n0)}")
    for r in results:
        check(r.num_tokens == RECOVERY_TOKENS and r.finish_reason == "length",
              f"{what}: {r.num_tokens} tokens, finish {r.finish_reason}")
        check(r.metrics.get("resumed"), f"{what}: a result not resumed")
    t_contained = sup._watch.first("recovering", n0)
    t_serving = sup._watch.first("degraded", n0)
    resume = sup.last_resume
    by_id = {s["seq_id"]: s["generated_tokens"] for s in resume["sequences"]}
    # the tokens each request had at the checkpoint must be the clean
    # run's; after it a prompt pass recomputes the KV in bf16 at another
    # shape, so agreement is printed, not checked
    kept = []
    for text, r, c in zip(batch[0], results, clean):
        n = by_id[watch.seqs[text].seq_id]
        check(r.token_ids[:n] == c.token_ids[:n],
              f"{what}: tokens before the checkpoint differ from the "
              "clean run")
        kept.append(n)
    ttft = sorted(
        next(t for t in times[text][n:] if t > t_contained) - t_contained
        for text, n in zip(batch[0], kept)
    )
    return {
        "wall_s": wall["wall_s"],
        "containment_to_serving_s": t_serving - t_contained,
        "tokens_at_checkpoint": kept,
        "replayed_first_token_s_p50": ttft[len(ttft) // 2],
        "replayed_first_token_s_max": ttft[-1],
        "agreement_after_checkpoint": agreement(
            [r.token_ids for r in results], [c.token_ids for c in clean]),
        "results": results,
    }


def guard_step_cost(core) -> dict:
    """What the guard adds to one decode step on the card: its kernels
    (``integrity.logit_guard`` over the ``[slots, vocab]`` f32 logits of
    a step, plus the copy into the flag buffer) by the profiler, and
    their device time by CUDA events."""
    from torch.profiler import ProfilerActivity, profile

    from vgate_tpu_torch import integrity

    logits = torch.randn(core.max_slots, core.spec.vocab_size,
                         device=core.device)
    flags = torch.empty(core.max_slots, dtype=torch.uint8,
                        device=core.device)
    threshold = core.config.integrity.saturate_threshold

    def step():
        flags.copy_(integrity.logit_guard(logits, threshold))

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    ops = sum(1 for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA)
    return {"device_ops": ops, "ms": time_ms(step, iters=50),
            "logits": list(logits.shape)}


def canary_ok(sup, context: str) -> dict:
    """The boot fingerprint verifies on the live core."""
    result = sup._canary.check(sup.core, context=context)
    check(result["ok"] and not result["recorded"],
          f"canary after {context}: {result}")
    return {k: result[k] for k in ("fingerprint", "latency_s")}


def recovery_path(model: str = MODEL, device: str = "cuda") -> dict:
    """Supervised recovery at 7B through the backend, on an engine whose
    weights are the main path's (random init from seed 0): the digest
    kernel on the tree's leaves and a full sweep; a clean warm burst of 8
    greedy requests x 64 tokens (exact K1/K2 launches, every guard word
    0, the perf snapshot's phases summing to its wall, MFU and the HBM
    roofline share at most 1.05); then four drills on the same burst,
    each checked for one restart, every request resumed and completed,
    nothing lost and the boot canary verifying afterwards: a crash
    (``decode_step`` raise after the first chunk; tokens before the
    checkpoint equal to the clean run's, the rebuilt pool's pages and
    ``memory_allocated`` back within 1 %), a stall (a ``stall`` delay
    past the lowered ``step_stall_s``), a corruption (``weight_corrupt``
    flips a leaf on the card; the sweep finds it, the weights are
    reloaded from the seed and the canary passes), and a tripped guard
    (``logit_corrupt``: a hard sentinel discards its chunk, a reload);
    last, the burst's device ops a step and decode tok/s with the guard
    on and, on a second engine over the same weights, off."""
    from vgate_tpu_torch import faults
    from vgate_tpu_torch.backends.base import SamplingParams
    from vgate_tpu_torch.runtime.engine_core import EngineCore

    t_phase = time.perf_counter()
    if device == "cuda":
        # every stream's cuBLAS workspace of the earlier phases goes, as
        # a rebuild drops them, so the pool is sized alike both times
        clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
        if clear is not None:
            clear()
        torch.cuda.empty_cache()
    cfg = engine_config(model, device, prefix_cache=False,
                        sections=RECOVERY_SECTIONS)
    engine, sup = start_engine(cfg, "recovery-phase")
    out = {}
    try:
        check(type(sup).__name__ == "EngineSupervisor",
              f"the backend serves a {type(sup).__name__}")
        sup._watch = Transitions(sup)
        boot = sup._canary.last
        check(boot is not None and boot["recorded"] and boot["ok"],
              f"boot canary {boot}")
        out["canary_boot"] = {k: boot[k] for k in ("fingerprint",
                                                    "latency_s")}
        out["warmup"] = warm_up(sup, "recovery-phase engine")
        tree0 = sup.core.integrity.verifier.baseline
        if device == "cuda":
            out["digests"] = check_digests(sup.core, DIGEST_LEAVES)
            out["sweep"] = sweep_report(sup.core, device)
            out["kernel"] = digest_kernel_entry(sup.core)
        texts = prompts()
        batch = (texts, [SamplingParams(max_tokens=RECOVERY_TOKENS,
                                        temperature=0.0)] * len(texts))
        # 1. the clean warm burst, with its launch counts
        reset_launches()
        stats0 = sup.core.get_stats()
        clean, clean_t = serve(engine, batch)
        launches = read_launches()
        stats = sup.core.get_stats()
        if device == "cuda":
            L = sup.core.spec.num_layers
            for name, n in (("paged_decode_attention",
                             stats["steps"] - stats0["steps"]),
                            ("flash_prefill_attention",
                             stats["prompt_passes"]
                             - stats0["prompt_passes"])):
                check(n > 0 and launches[name] == L * n,
                      f"recovery phase: {name}: {launches[name]} launches "
                      f"for {n} passes of {L} layers")
            check_graphed(stats, "the recovery phase", since=stats0)
        check_no_guard_trips(sup, "the clean burst")
        for r in clean:
            check(r.num_tokens == RECOVERY_TOKENS, f"{r.num_tokens} tokens")
        out["clean_burst"] = clean_t
        snap = sup.perf_snapshot()
        win = snap["window"]
        phases = sum(win["phase_seconds"].values())
        check(abs(phases - win["wall_s"]) <= 0.01 * win["wall_s"],
              f"perf phases {phases} s vs tick wall {win['wall_s']} s")
        check(win["mfu"] is None or win["mfu"] <= 1.05,
              f"decode MFU {win['mfu']}")
        check(win["hbm_roofline_pct"] is None
              or win["hbm_roofline_pct"] <= 105.0,
              f"HBM roofline {win['hbm_roofline_pct']} %")
        if device == "cuda":
            check(win["mfu"] is not None
                  and win["hbm_roofline_pct"] is not None,
                  f"no roofline for {snap['roofline']}")
        out["perf_snapshot"] = {
            "window": win, "roofline": snap["roofline"],
            "compile_ledger": snap["compile_ledger"][:12],
            "compile_ledger_entries": len(snap["compile_ledger"]),
        }
        mem0 = torch.cuda.memory_allocated() if device == "cuda" else 0
        pages0 = sup.core.geometry.num_pages
        # 2. a crash after the first chunk
        reset_launches()
        crash = recovery_burst(
            engine, sup, batch, clean,
            lambda: faults.arm("decode_step", "raise", times=1), "crash")
        crash.pop("results")
        crash["launches"] = read_launches()
        # the kept tree was verified and the new core's baseline taken on
        # the card
        check(device != "cuda" or crash["launches"]["leaf_digest"] > 0,
              "the rebuild launched no digest kernel")
        out["launches"] = {k: launches[k] + crash["launches"][k]
                           for k in launches}
        graphs = sup.core.get_stats()["decode_graphs"]
        crash["recapture"] = {
            "graphs": len(captures(sup.core)),
            "capture_s": sum(s for _, s in captures(sup.core)),
            "ledger": [e for e in sup.core.perf.compile_ledger()
                       if e["program"] == "decode"][:8],
        }
        check(graphs is None or graphs["captured"] >= 1,
              "the rebuilt core captured no graph")
        check(sup.core.geometry.num_pages == pages0,
              f"rebuilt pool {sup.core.geometry.num_pages} pages, was "
              f"{pages0}")
        if device == "cuda":
            gc.collect()
            mem = torch.cuda.memory_allocated()
            crash["memory_allocated_gb"] = [mem0 / 1e9, mem / 1e9]
            check(abs(mem - mem0) <= 0.01 * mem0,
                  f"memory allocated {mem0 / 1e9:.3f} GB before the crash, "
                  f"{mem / 1e9:.3f} GB after the rebuild")
        crash["canary"] = canary_ok(sup, "the crash rebuild")
        out["crash"] = crash
        # 3. a stall past the lowered limit, on other prompts: a request
        # freshly submitted into two crashes in a row is quarantined as
        # poison (recovery.poison_threshold)
        h0 = sup.health()
        n0 = len(sup._watch.log)
        faults.arm("stall", "delay", delay_s=RECOVERY_DELAY_S, times=1)
        t0 = time.perf_counter()
        stalled, stall_t = serve(
            engine, ([f"Stall drill. {t}" for t in texts], batch[1]))
        h = sup.health()
        check(h["stalls"] == h0["stalls"] + 1
              and h["restarts"] == h0["restarts"] + 1
              and h["lost"] == h0["lost"]
              and h["resumed"] == h0["resumed"] + len(stalled),
              f"stall drill: {h0} -> {h}")
        check(sup._watch.since(n0) == ["recovering", "degraded"],
              f"stall drill: transitions {sup._watch.since(n0)}")
        for r in stalled:
            check(r.num_tokens == RECOVERY_TOKENS,
                  f"stall drill: {r.num_tokens} tokens")
        out["stall"] = {
            "wall_s": stall_t["wall_s"],
            "declared_after_s": sup._watch.first("recovering", n0) - t0,
            "containment_to_serving_s": (sup._watch.first("degraded", n0)
                                         - sup._watch.first("recovering",
                                                            n0)),
            "stalls": h["stalls"], "restarts": h["restarts"],
            "canary": canary_ok(sup, "the stall rebuild"),
        }
        # 4. a corruption on the card, found by the sweep
        h0 = sup.health()
        n0 = len(sup._watch.log)
        faults.arm("weight_corrupt", "corrupt", times=1)
        wait_for(lambda: sup.health()["integrity"]["corrupt_reloads"]
                 == h0["integrity"]["corrupt_reloads"] + 1
                 and sup.state.value == "degraded", "the corruption reload")
        last = sup.last_integrity
        check(last["kind"] == "checksum_mismatch"
              and sup.last_crash["classification"] == "corrupt"
              and last["canary"]["ok"],
              f"corruption drill: {last}, {sup.last_crash['classification']}")
        check(sup._watch.since(n0) == ["recovering", "degraded"],
              f"corruption drill: transitions {sup._watch.since(n0)}")
        check(sup.core.integrity.verifier.baseline == tree0,
              "the reloaded tree's digests differ from the boot tree's")
        out["corruption"] = {
            "leaf": last["detail"].get("leaf"),
            "reload_to_serving_s": (sup._watch.first("degraded", n0)
                                    - sup._watch.first("recovering", n0)),
            "canary": canary_ok(sup, "the reload"),
        }
        # 5. a tripped guard discards its chunk: a hard sentinel, a reload
        h0 = sup.health()
        guard = recovery_burst(
            engine, sup, batch, clean,
            lambda: faults.arm("logit_corrupt", "corrupt", times=1),
            "tripped guard")
        guard.pop("results")
        last = sup.last_integrity
        check(str(last["kind"]).startswith("logit_")
              and sup.last_crash["classification"] == "corrupt"
              and sup.health()["integrity"]["corrupt_reloads"]
              == h0["integrity"]["corrupt_reloads"] + 1,
              f"tripped guard: {last}")
        guard["sentinel"] = last["kind"]
        guard["canary"] = canary_ok(sup, "the guard reload")
        out["tripped_guard"] = guard
        out["supervisor"] = {k: sup.health()[k] for k in (
            "state", "crashes", "restarts", "stalls", "resumed", "lost",
            "transitions")}
        # 6. the guard's cost: the same warm burst, guard on here, then off
        # on a second engine over the same weights
        if device == "cuda":
            on_t = serve(engine, batch)[1]
            cost = {"on": {**profile_burst(engine, batch, sup),
                           "decode_tok_s": on_t["decode_tok_s"]},
                    "guard_a_step": guard_step_cost(sup.core)}
        params = sup.core.params
    finally:
        faults.reset()
        if getattr(sup, "_watch", None) is not None:
            sup._watch.close()
            out["rebuilds"] = sup._watch.rebuilds
        engine.shutdown()
    del engine, sup
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
        off_cfg = engine_config(model, device, prefix_cache=False,
                                sections={"integrity": {"enabled": False}})
        off = EngineCore(off_cfg, params=params)
        off.start()
        try:
            warm_up(off, "guard-off engine")
            off_engine = again_engine(off)
            off_t = serve(off_engine, batch)[1]
            cost["off"] = {**profile_burst(off_engine, batch, off),
                           "decode_tok_s": off_t["decode_tok_s"]}
        finally:
            off.stop()
        for side in ("on", "off"):
            cost[side].pop("top")
        out["guard_cost"] = cost
        del off, off_engine
    del params
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def swap_path(params, reference_streams, model: str = MODEL,
              device: str = "cuda", texts=None,
              num_pages: int = SWAP_NUM_PAGES,
              host_bytes: int = SWAP_HOST_BYTES) -> dict:
    """The host KV swap tier at 7B, over the main path's weights: the
    swap wave (``swap_texts``, all queued as one) on an engine whose pool
    takes the wave but not its growth, with the host pool on, then with
    it off, each after its warm-up.  With swap on every preemption must
    park its pages and resume by swap-in with no recompute, no page or
    host byte may stay in use, every decode chunk must be a graph replay,
    and the streams must equal ``reference_streams`` (the same wave
    unpressured on the main path's engine).  Should they differ, a row
    that leaves the reference at its first token after a swap-in fails
    (the page round trip of the kernel checks is bit-exact); a row that
    leaves it at a step with no swap event is shape-dependent bf16
    rounding, and then the agreement is printed in place of the check.
    The swap-off engine must preempt and recompute."""
    from vgate_tpu_torch.runtime.engine_core import EngineCore

    texts = swap_texts() if texts is None else texts
    out = {"pcie_link": smi("pcie.link.gen.current,pcie.link.width.current")
           if device == "cuda" else None}
    for name, budget in (("swap_on", host_bytes), ("swap_off", 0)):
        cfg = engine_config(model, device, prefix_cache=False,
                            kv_num_pages=num_pages, host_swap_bytes=budget)
        core = EngineCore(cfg, params=params)
        core.start()
        try:
            run = {"warmup": warm_up(core, f"host-swap phase, {name}")}
            stats0 = core.get_stats()
            swap_ins, timer = {}, None
            if core.kv_swap is not None:
                timer = TransferTimer(core.kv_swap.executor,
                                      device == "cuda")
                plain = core.kv_swap.swap_in_seq

                def swap_in_seq(seq, pages, plain=plain):
                    # the token index the resumed row computes next
                    swap_ins.setdefault(seq.seq_id, []).append(
                        seq.num_generated)
                    return plain(seq, pages)

                core.kv_swap.swap_in_seq = swap_in_seq
            with TokenWatch(core) as watch:
                t0 = time.perf_counter()
                results = again_engine(core).generate_batch(
                    texts, [swap_params()] * len(texts))
                if device == "cuda":
                    torch.cuda.synchronize()
                run["wall_s"] = time.perf_counter() - t0
            launches = read_launches()
            check(all(r.num_tokens == 256 for r in results),
                  f"{name}: tokens {[r.num_tokens for r in results]}")
            stats = check_settled(core)
            sched = stats["scheduler"]
            run.update({
                key: sched[key] - stats0["scheduler"][key]
                for key in ("preemptions", "swap_preempts",
                            "preempt_recompute_tokens")
            })
            run.update({
                "decode_steps": stats["steps"] - stats0["steps"],
                "prompt_passes": stats["prompt_passes"]
                - stats0["prompt_passes"],
                "launches": launches,
            })
            check(run["preemptions"] > 0,
                  f"{name}: the pool of {num_pages} pages was never squeezed")
            if device == "cuda":
                run["counts"] = check_phase_launches(
                    core, stats0, launches, f"host-swap phase, {name}",
                    prefix_cache=False)
                # the wave's min-token keys are captured inside it (the
                # warm-up leaves them cold, as the reference's does)
                run["wall_s_less_captures"] = (
                    run["wall_s"] - run["counts"]["capture_s"])
            streams = [r.token_ids for r in results]
            run["agreement_with_unpressured"] = agreement(
                streams, reference_streams)
            if core.kv_swap is not None:
                kv = stats["kv_swap"]
                check(run["swap_preempts"] == run["preemptions"],
                      f"swap on: {run['swap_preempts']} of "
                      f"{run['preemptions']} preemptions swapped")
                check(run["preempt_recompute_tokens"] == 0,
                      f"swap on: {run['preempt_recompute_tokens']} "
                      "recompute tokens")
                check(kv["swap_in_pages"]["preempt"] > 0, f"no swap-in: {kv}")
                check(kv["used_bytes"] == 0,
                      f"{kv['used_bytes']} host pool bytes left in use")
                sig = core.pressure_signals()
                check(set(sig) == PRESSURE_KEYS | SWAP_PRESSURE_KEYS
                      and sig["kv_host_free_ratio"] == 1.0,
                      f"swap on: pressure signals {sig}")
                run["swap_out_pages"] = kv["swap_out_pages"]
                run["swap_in_pages"] = kv["swap_in_pages"]
                run["rates"] = timer.rates()
                if streams != reference_streams:
                    at_swap = []
                    for text, got, ref in zip(texts, streams,
                                              reference_streams):
                        d = first_divergence(got, ref)
                        if d < len(ref) and d in swap_ins.get(
                                watch.seqs[text].seq_id, ()):
                            at_swap.append(d)
                    check(not at_swap, "swap on: rows leave the "
                          f"unpressured streams at a swap-in: {at_swap}")
                    print("host-swap phase: the streams differ from the "
                          "unpressured ones at steps with no swap event "
                          "(bf16 rounding by shape); agreement "
                          + json.dumps(run["agreement_with_unpressured"]),
                          flush=True)
                run["token_identical_to_unpressured"] = (
                    streams == reference_streams)
            else:
                check(run["preempt_recompute_tokens"] > 0,
                      "swap off: no recompute tokens")
            out[name] = run
        finally:
            core.stop()
        del core
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    return out


def check_swap_round_trip(dev) -> dict:
    """The host swap tier's page round trip at the 7B layer geometry, on
    bf16 pools and on int8 pools with their scales: N pages (1, 16, and
    17, which crosses a chunk) swapped out to pinned memory and into
    other pages must come back bit for bit, into pools whose storage did
    not move."""
    import types

    from vgate_tpu_torch.ops.kv_quant import QuantPages, quantize
    from vgate_tpu_torch.runtime.engine_core import _DeviceSwapExecutor

    L, KV, P, ps, hd = 28, 4, 64, 32, 128
    out = {}
    gen = torch.Generator(device=dev).manual_seed(5)
    for kind in ("bf16", "int8"):
        pools = []
        for _ in range(2):
            vals = torch.randn((L, KV, P, ps, hd), generator=gen,
                               device=dev)
            pools.append(QuantPages(*quantize(vals)) if kind == "int8"
                         else vals.to(torch.bfloat16))
        parts = [t for pool in pools for t in (
            (pool.data, pool.scale) if kind == "int8" else (pool,))]
        ex = _DeviceSwapExecutor(types.SimpleNamespace(
            k_pages=pools[0], v_pages=pools[1], device=dev))
        timer = TransferTimer(ex, cuda=True)
        ptrs = [t.data_ptr() for t in parts]
        for n in (1, 16, 17):
            src = list(range(1, 1 + n))
            dst = list(range(P - 1, P - 1 - n, -1))
            expect = [t[:, :, src].clone() for t in parts]
            payload = ex.read_pages(src)
            check(all(t.is_pinned() for chunk in payload for t in chunk),
                  "a swap payload is not in pinned memory")
            for t in parts:
                t[:, :, dst] = 0
            ex.write_pages(dst, payload)
            del payload
            torch.cuda.synchronize()
            for t, e in zip(parts, expect):
                check(torch.equal(t[:, :, dst].contiguous().view(torch.uint8),
                                  e.contiguous().view(torch.uint8)),
                      f"{kind} swap round trip of {n} pages is not exact")
        check([t.data_ptr() for t in parts] == ptrs,
              f"{kind} pools moved in a swap")
        out[kind] = timer.rates()
        del pools, parts, ex, timer
    torch.cuda.empty_cache()
    return out


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
    out = {"warmup": warm_up(core, f"{quantization} weights + int8 KV")}
    bits = 8 if quantization == "int8" else 4
    texts = prompts()
    greedy = SamplingParams(max_tokens=32, temperature=0.0)
    sampled = SamplingParams(max_tokens=32, temperature=0.8, top_p=0.9,
                             top_k=50, seed=1234)
    batch = (texts + [texts[3]], [greedy] * 8 + [sampled])
    stats0 = core.get_stats()
    out["kv_dtype"] = stats0["kv_dtype"]
    try:
        check(out["kv_dtype"] == "int8", f"kv_dtype {out['kv_dtype']}")
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
            check_graphed(stats, f"the {quantization} phase", since=stats0)
            out["launch_counts"] = check_quant_launches(
                launches, stats["steps"] - stats0["steps"], bits,
                core.spec.num_layers)
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
            "decode_graphs": stats["decode_graphs"],
            "launches": launches,
        })
        if bf16_streams:
            out["agreement_with_bf16_burst"] = agreement(
                [r.token_ids for r in results[:8]], bf16_streams[:8])
        out["logits"] = check_model_logits(core, texts[2])
        if bits == 8:
            # the digest kernel on an int8 weight and its scales
            out["digests"] = check_digests(core, DIGEST_LEAVES_INT8)
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
        out["warmup_again"] = warm_up(again, f"{quantization} second engine")
        repeat = again_engine(again).generate_batch(*batch)
        if device == "cuda":
            # where the time goes in a warm burst (its prompts now hit)
            out["profile"] = profile_burst(again_engine(again), batch, again)
    finally:
        again.stop()
    for a, b in zip(results, repeat):
        check(a.token_ids == b.token_ids,
              f"int{bits}: tokens differ between two identical bursts")
    del again, params
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


# ------------------------------------------------- speculative decoding

SPEC_K = 4  # drafts a round: verify widths 1, 2, 4 and 5
SPEC_TOKENS = 64
DRAFT_MODEL = "Qwen/Qwen2.5-0.5B-Instruct"


def repetitive_texts(n: int = 8) -> list:
    """``n`` prompts that repeat a phrase: prompt lookup finds the
    n-gram at the end of each in its history."""
    phrases = ("the cat sat on the mat and ", "one two three four ",
               "red green blue ", "to be or not to be, ")
    return [(f"Item {i}: " + phrases[i % 4] * 40)[: 160 + 40 * i]
            for i in range(n)]


class OracleDrafter:
    """The drafter seam fed the plain engine's greedy continuation (as
    the reference's tests inject oracles): each call's (tokens generated
    so far, drafts) is recorded by prompt."""

    def __init__(self, truth: dict) -> None:
        self.truth = truth
        self.records: dict = {}

    def __call__(self, seq, k: int) -> list:
        key = tuple(seq.prompt_ids[: seq.orig_prompt_len])
        done = seq.num_generated
        draft = self.truth[key][done : done + k]
        self.records.setdefault(key, []).append((done, list(draft)))
        return draft


def acceptance_before_divergence(records, stream, plain) -> tuple:
    """(first divergence of ``stream`` from ``plain``, drafts proposed at
    positions before it, those accepted): a draft is accepted iff it and
    every draft before it in its round equal the stream's tokens."""
    div = first_divergence(stream, plain)
    drafted = accepted = 0
    for n, draft in records:
        run = 0
        while (run < len(draft) and n + run < len(stream)
               and stream[n + run] == draft[run]):
            run += 1
        for j in range(len(draft)):
            if n + j < div:
                drafted += 1
                accepted += j < run
    return div, drafted, accepted


def check_verify_logits(core, text: str, S: int = SPEC_K + 1) -> dict:
    """The verify pass (``spec_verify_forward``, K3 at S rows starting
    mid-page) against a plain full-sequence forward (see LogitsCheck): a
    prompt pass over ``text``, then one verify pass over the plain
    forward's greedy continuation; row j's logits against the plain
    forward over the prompt and the first j + 1 candidates."""
    from vgate_tpu_torch.models.decoder import (
        prefill_forward,
        spec_verify_forward,
    )

    spec, dev, ps = core.spec, core.device, core.geometry.page_size
    seq = prompt_tokens(core, text)
    n = seq.shape[1]
    bucket = -(-n // 128) * 128
    width = max(bucket, n + S) // ps + 1
    kp, vp = empty_pools(core, 1 + width)
    pt = torch.arange(1, 1 + width, dtype=torch.int32, device=dev)[None]
    tok = torch.zeros((1, bucket), dtype=torch.int32, device=dev)
    tok[:, :n] = seq

    def i32(values):
        return torch.tensor(values, dtype=torch.int32, device=dev)

    compare = LogitsCheck(core)
    with torch.no_grad():
        got = prefill_forward(core.params, spec, tok, i32([n]), kp, vp,
                              pt[:, : bucket // ps])
        cand = [compare("prefill", got, seq)]
        while len(cand) < S:  # the plain forward's greedy continuation
            ref, _ = compare._plain(torch.cat([seq, i32([cand])], 1), n)
            cand.append(int(ref.argmax()))
        got = spec_verify_forward(core.params, spec, i32([cand]), i32([n]),
                                  i32([S]), kp, vp, pt,
                                  active=torch.ones(1, dtype=torch.bool,
                                                    device=dev))
        for j in range(S):
            compare(f"verify row {j}", got[:, j],
                    torch.cat([seq, i32([cand[: j + 1]])], 1),
                    pooled_from=n)
    return compare.report


def spec_delta(core, stats0) -> dict:
    """The speculative counters since ``stats0``."""
    now, then = core.get_stats(), stats0
    d = {k: now["speculative"][k] - then["speculative"].get(k, 0)
         for k in ("drafted", "accepted", "rounds")}
    if "draft_calls" in now["speculative"]:
        d["draft_calls"] = (now["speculative"]["draft_calls"]
                            - then["speculative"]["draft_calls"])
    for k in ("prompt_passes", "steps", "chunks", "decode_tokens"):
        d[k] = now[k] - then[k]
    d["acceptance_rate"] = d["accepted"] / max(1, d["drafted"])
    # a slot's round appends its accepted drafts and one bonus token, so
    # the slot-rounds are the tokens less the accepted drafts
    d["tokens_per_slot_round"] = d["decode_tokens"] / max(
        1, d["decode_tokens"] - d["accepted"])
    return d


def check_spec_launches(core, delta, launches, what, draft=None) -> None:
    """While speculation runs: K3 = layers x verify rounds exactly (no
    suffix pass: the prefix cache is off), K1 never, K2 = layers x prompt
    passes, plus the draft model's layers x k_max x draft calls."""
    L = core.spec.num_layers
    k2 = L * delta["prompt_passes"]
    if draft is not None:
        k2 += draft.spec.num_layers * draft.k_max * delta["draft_calls"]
    want = {"paged_multitok_attention": L * delta["rounds"],
            "paged_decode_attention": 0, "flash_prefill_attention": k2}
    got = {name: launches[name] for name in want}
    check(delta["rounds"] > 0 and got == want,
          f"{what}: launches {got}, expected {want} ({delta})")


def spec_path(params, model: str = MODEL, device: str = "cuda",
              draft_model: str = DRAFT_MODEL) -> dict:
    """Speculative decoding at 7B over the main path's weights
    (``speculative_k`` 4, 2-gram prompt lookup, prefix cache off), driven
    through ``TorchCUDABackend`` after the engine's warm-up:
    (e) brownout first: suspended, 8 x 64 greedy tokens decode through
    graphed K1 chunks (the plain engine's streams); resumed,
    (a) the oracle drafter (those streams as drafts): the first tokens
    equal, acceptance >= 0.9 up to each stream's first divergence;
    (b) prompt lookup on repetitive prompts; (c) seeded sampled requests
    with logprobs, served twice; (f) one 128-token stream with and
    without speculation; then (d) a second engine drafting with
    ``draft_model`` (Qwen2.5-0.5B-Instruct, random init).  Launch counts
    are exact in every run; ``launches`` sums them over the phase."""
    from vgate_tpu_torch.backends.base import (
        GenerationResult,
        SamplingParams,
    )
    from vgate_tpu_torch.backends.torch_backend import TorchCUDABackend
    from vgate_tpu_torch.runtime.engine_core import EngineCore

    cuda = device == "cuda"
    out = {}

    def show(name):
        print(f"  speculative phase, {name}: " + json.dumps(out[name]),
              flush=True)
    total: dict = {}

    def add(launches):
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n
    cfg = engine_config(model, device, prefix_cache=False,
                        speculative_k=SPEC_K, speculative_ngram=2)
    core = EngineCore(cfg, params=params)
    core.start()
    backend = TorchCUDABackend()
    backend.core, backend._config = core, cfg
    try:
        out["warmup"] = warm_up(core, "speculative engine")
        texts = prompts()
        greedy = [SamplingParams(max_tokens=SPEC_TOKENS,
                                 temperature=0.0)] * len(texts)

        def run(what, batch, draft=None, spec=True):
            """One wave: text prompts through the backend, token prompts
            queued on the core as one wave (the backend takes text)."""
            reset_launches()
            stats0 = core.get_stats()
            t0 = time.perf_counter()
            if all(isinstance(p, str) for p in batch[0]):
                results = backend.generate(*batch)
            else:
                with core._submit_lock:
                    seqs = [core.submit_tokens(list(p), sp)
                            for p, sp in zip(*batch)]
                results = [GenerationResult(**core.result_dict(s))
                           for s in seqs]
            wall = time.perf_counter() - t0
            launches = read_launches()
            add(launches)
            delta = spec_delta(core, stats0)
            delta["wall_s"] = wall
            if cuda and spec:
                check_spec_launches(core, delta, launches, what, draft)
            check_results(results, core, batch[1][0].max_tokens)
            check_settled(core)
            return results, delta, launches, stats0

        # (e) brownout L3: the burst decodes through graphed K1 chunks
        backend.set_spec_suspended(True)
        plain, delta, launches, stats0 = run("suspended", (texts, greedy),
                                             spec=False)
        L = core.spec.num_layers
        if cuda:
            check(delta["rounds"] == 0 and
                  launches["paged_multitok_attention"] == 0 and
                  launches["paged_decode_attention"] == L * delta["steps"]
                  and launches["flash_prefill_attention"]
                  == L * delta["prompt_passes"],
                  f"suspended burst: launches {launches}, {delta}")
            check_graphed(core.get_stats(), "the suspended burst",
                          since=stats0)
        out["suspended"] = {**delta, "launches": launches}
        show("suspended")
        backend.set_spec_suspended(False)

        # (a) the oracle drafter
        ids = [tuple(core.encode_prompt(t)) for t in texts]
        truth = {i: r.token_ids for i, r in zip(ids, plain)}
        oracle = OracleDrafter(truth)
        core.drafter = oracle
        spec, delta, launches, _ = run("oracle drafter", (texts, greedy))
        firsts, divs, drafted, accepted = [], [], 0, 0
        for i, r, p in zip(ids, spec, plain):
            firsts.append(r.token_ids[0] == p.token_ids[0])
            div, d, a = acceptance_before_divergence(
                oracle.records.get(i, []), r.token_ids, p.token_ids)
            divs.append(div)
            drafted, accepted = drafted + d, accepted + a
        check(all(firsts), "a speculative stream's first token differs "
                           "from the plain engine's")
        before = accepted / max(1, drafted)
        check(drafted > 0 and before >= 0.9,
              f"oracle acceptance before divergence {before} "
              f"({accepted}/{drafted})")
        out["oracle"] = {
            **delta, "launches": launches,
            "acceptance_before_divergence": before,
            "first_divergence": divs,
            "streams_equal_plain": sum(r.token_ids == p.token_ids
                                       for r, p in zip(spec, plain)),
        }
        show("oracle")
        # the verify pass's logits against a plain forward
        out["verify_logits"] = check_verify_logits(core, texts[2])
        show("verify_logits")

        # (f) one 128-token stream at B = 1, without and with speculation
        one = [texts[4]], [SamplingParams(max_tokens=128, temperature=0.0)]
        backend.set_spec_suspended(True)
        [alone], _, _, _ = run("B=1 plain", one, spec=False)
        backend.set_spec_suspended(False)
        core.drafter = OracleDrafter(
            {tuple(core.encode_prompt(texts[4])): alone.token_ids})
        [fast], delta1, _, _ = run("B=1 oracle", one)

        def tok_s(r):
            return (r.num_tokens - 1) / (r.metrics["gen_time"]
                                         - r.metrics["ttft"])

        out["b1_latency"] = {
            "plain_tok_s": tok_s(alone), "speculative_tok_s": tok_s(fast),
            "rounds": delta1["rounds"],
            "acceptance_rate": delta1["acceptance_rate"],
            "first_divergence": first_divergence(fast.token_ids,
                                                 alone.token_ids),
        }
        show("b1_latency")

        # (b) prompt lookup on repetitive prompts: phrases repeated, and
        # prompts holding the model's own greedy continuation (a prompt,
        # its plain stream, the prompt again), where a random model's
        # output can recur
        core.drafter = core._ngram_drafter
        rep = [core.encode_prompt(t) for t in repetitive_texts(4)]
        rep += [list(i) + p.token_ids + list(i)
                for i, p in zip(ids[:4], plain[:4])]
        _, delta, launches, _ = run("n-gram drafting", (
            rep, [SamplingParams(max_tokens=SPEC_TOKENS,
                                 temperature=0.0)] * len(rep)))
        out["ngram"] = {**delta, "launches": launches}
        show("ngram")

        # (c) seeded sampled requests with logprobs, served twice
        sampled = [SamplingParams(max_tokens=32, temperature=0.7,
                                  seed=7 + i, logprobs=True, top_logprobs=5)
                   for i in range(4)]
        first, delta, _, _ = run("seeded sampled", (texts[:4], sampled))
        second, _, _, _ = run("seeded sampled, again", (texts[:4], sampled))
        for a, b in zip(first, second):
            check(a.token_ids == b.token_ids,
                  "a seeded sampled stream differs between two runs")
            lps = [e["logprob"] for e in a.logprobs]
            check(len(lps) == a.num_tokens and all(map(math.isfinite, lps)),
                  "seeded sampled logprobs not finite")
        out["sampled"] = {**delta, "repeat": True}
        show("sampled")
        out["stats"] = core.get_stats()["speculative"]
    finally:
        core.stop()
    del core, backend
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # (d) draft-model drafting on a second engine over the same weights
    cfg = engine_config(model, device, prefix_cache=False,
                        speculative_k=SPEC_K)
    cfg.model.draft_model_id = draft_model
    core = EngineCore(cfg, params=params)
    core.start()
    backend = TorchCUDABackend()
    backend.core, backend._config = core, cfg
    try:
        draft = core.draft_model
        out["draft_warmup"] = warm_up(core, "draft-model engine")
        plain_draft = draft.draft_for
        seconds = []

        def timed(seq, k):
            t0 = time.perf_counter()
            toks = plain_draft(seq, k)
            seconds.append(time.perf_counter() - t0)
            return toks

        core.drafter = timed
        reset_launches()
        stats0 = core.get_stats()
        batch = texts[:4], greedy[:4]
        t0 = time.perf_counter()
        results = backend.generate(*batch)
        wall = time.perf_counter() - t0
        launches = read_launches()
        add(launches)
        delta = spec_delta(core, stats0)
        if cuda:
            check_spec_launches(core, delta, launches, "draft-model drafting",
                                draft)
        check_results(results, core, SPEC_TOKENS)
        check_settled(core)
        out["draft_model"] = {
            **delta, "wall_s": wall, "launches": launches,
            "drafter_ms_per_call": 1e3 * sum(seconds) / max(1, len(seconds)),
            "drafter": core.get_stats()["speculative"]["drafter"],
            "window": draft.window,
        }
        show("draft_model")
    finally:
        core.stop()
    out["launches"] = total
    return out


# ---------------------------------------------------------- embeddings

EMBED_MODEL = "BAAI/bge-base-en-v1.5"
EMBED_TOL = 1e-2  # bf16 encoder vs the fp32 forward on the same weights


def embed_texts(n: int = 64) -> list:
    """``n`` inputs of 8 to 500 bytes (tokens, with the byte tokenizer)."""
    words = "the encoder pools the first token of every input ".split()
    out = []
    for i in range(n):
        length = 8 + (500 - 8) * i // (n - 1)
        text, j = "", i
        while len(text) < length:
            text += words[j % len(words)] + " "
            j += 1
        out.append(text[:length])
    return out


def embed_path(device: str = "cuda", model: str = EMBED_MODEL) -> dict:
    """bge-base-en-v1.5 at full width (random init from seed 0, bf16)
    behind ``TorchCUDABackend.embed``: 64 inputs of 8 to 500 tokens in
    three calls, one a bucket (32, 128, 512), each call twice (the second
    timed); the vectors held to a plain fp32 forward of the same weights
    on the card, every norm 1 within 1e-3."""
    from vgate_tpu_torch.backends.torch_backend import TorchCUDABackend
    from vgate_tpu_torch.config import load_config
    from vgate_tpu_torch.models.encoder import encode_forward

    cfg = load_config(model={"model_id": MODEL, "dtype": "bfloat16",
                             "embedding_model_id": model},
                      device={"device": device},
                      logging={"level": "WARNING"})
    backend = TorchCUDABackend()
    backend._config = cfg
    texts = embed_texts()
    groups = {32: [t for t in texts if len(t) + 2 <= 32],
              128: [t for t in texts if 32 < len(t) + 2 <= 128],
              512: [t for t in texts if len(t) + 2 > 128]}
    out = {"inputs": len(texts), "buckets": {}}
    vectors = []
    for bucket, group in groups.items():
        backend.embed(group)  # the first call builds the encoder
        t0 = time.perf_counter()
        vecs = backend.embed(group)
        ms = (time.perf_counter() - t0) * 1e3
        vectors += vecs
        out["buckets"][bucket] = {"inputs": len(group), "ms_per_batch": ms}
    emb = backend._embedder
    f32 = torch.utils._pytree.tree_map(lambda t: t.float(), emb.params)
    errs, norms = [], []
    for bucket, group in groups.items():
        ids = [emb.tokenizer.encode(t)[:510] for t in group]
        tokens = torch.zeros(len(ids), bucket, dtype=torch.int32)
        mask = torch.zeros_like(tokens)
        for row, seq in enumerate(ids):
            full = [emb.tokenizer.bos_id, *seq, emb.tokenizer.eos_id]
            tokens[row, : len(full)] = torch.tensor(full)
            mask[row, : len(full)] = 1
        with torch.no_grad():
            ref = encode_forward(f32, emb.spec, tokens.to(emb.device),
                                 mask.to(emb.device))
        got = torch.tensor(vectors[:len(group)], device=emb.device)
        vectors = vectors[len(group):]
        errs.append(float((got - ref).abs().max()))
        norms.append(float((got.norm(dim=-1) - 1).abs().max()))
    out["max_abs_err"], out["max_norm_err"] = max(errs), max(norms)
    check(out["max_abs_err"] <= EMBED_TOL,
          f"embeddings {out['max_abs_err']} from the fp32 forward")
    check(out["max_norm_err"] <= 1e-3,
          f"an embedding's norm is {out['max_norm_err']} from 1")
    out["dim"] = emb.spec.hidden_size
    return out


GEMMA = "google/gemma-2-9b-it"


def filler(head: str, n: int, stride: int) -> str:
    """``head`` then words of a fixed list, cut to ``n`` bytes (the byte
    tokenizer makes 1 byte 1 token)."""
    words = ("a long document about paged attention windows and the pages "
             "of key value cache that a sliding layer no longer reads "
             "while the global layers still do ").split()
    out, j = head, 0
    while len(out) < n:
        out += words[j % len(words)] + " "
        j += stride
    return out[:n]


def check_long_logits(core, text: str, chunk: int = 512) -> dict:
    """A document's chunked prompt pass and a decode step past the window
    against a plain full-sequence forward (see LogitsCheck): suffix
    passes of ``chunk`` tokens from position 0 (K3, as the engine runs a
    chunked prefill), the final pass's logits compared, then one decode
    step at position n in a batch of 8 rows (7 idle on the trash page),
    so ``decode_block_slots`` 8 runs K6 and 1 runs K1."""
    from vgate_tpu_torch.models.decoder import (
        decode_forward,
        prefill_suffix_forward,
    )

    spec, dev, ps = core.spec, core.device, core.geometry.page_size
    seq = prompt_tokens(core, text)
    n = seq.shape[1]
    width = -(-(n + 1) // ps)
    kp, vp = empty_pools(core, 1 + width)
    pages = torch.arange(1, 1 + width, dtype=torch.int32, device=dev)[None]

    def i32(rows):
        return torch.tensor(rows, dtype=torch.int32, device=dev)

    compare = LogitsCheck(core)
    with torch.no_grad():
        for start in range(0, n, chunk):
            m = min(chunk, n - start)
            S = -(-m // ps) * ps
            tok = torch.zeros((1, S), dtype=torch.int32, device=dev)
            tok[:, :m] = seq[:, start:start + m]
            got = prefill_suffix_forward(
                core.params, spec, tok, i32([start]), i32([m]), kp, vp,
                pages[:, start // ps:(start + S) // ps].contiguous(),
                pages[:, :-(-(start + S) // ps)].contiguous(),
            )
        nxt = compare("chunk_final", got, seq)
        B = 8
        table = torch.zeros((B, width), dtype=torch.int32, device=dev)
        table[0] = pages[0]
        active = torch.zeros(B, dtype=torch.bool, device=dev)
        active[0] = True
        got = decode_forward(
            core.params, spec, i32([nxt] + [0] * (B - 1)),
            i32([n] + [0] * (B - 1)), kp, vp, table, active=active,
        )
        compare("decode_past_window", got[:1],
                torch.cat([seq, i32([[nxt]])], 1))
    return compare.report


def gemma_config(model: str, device: str, block_slots: int):
    """Gemma-2 serving as the reference defaults it (prefix cache on) with
    chunked prefill at 512, its 8,192-token context, and
    ``decode_block_slots``.  The pool takes 0.85 of the card (not 0.9),
    leaving room for the plain full-sequence forwards the logits are
    held to."""
    from vgate_tpu_torch.config import load_config

    return load_config(
        model={"model_id": model, "engine_type": "torch_cuda",
               "dtype": "bfloat16", "max_model_len": 8192},
        device={"device": device, "prefill_chunk": 512,
                "decode_block_slots": block_slots, "hbm_utilization": 0.85},
        logging={"level": "WARNING"},
    )


def gemma_path(block_slots: int, model: str = GEMMA, device: str = "cuda",
               params=None) -> tuple:
    """Gemma-2 served with ``decode_block_slots`` ``block_slots``: through
    ``VGTEngine`` (its weights drawn from seed 0), or with ``params`` on a
    fresh ``EngineCore`` over those weights.  Serves the main path's
    9-request burst; a 4,600-token document (chunked at 512: 8 non-final
    passes and a final one; its later chunks and every decode step attend
    through the window) beside 7 short requests in one decode batch; and
    a second turn re-sending the document and its answer plus a tail (a
    prefix hit past the window).  Checks the exact launch counts, the
    prefix counters, that no page stays in use, and the logits of a
    prompt pass, of the document's final chunk and of a decode step past
    the window against plain forwards.  Returns (report, params)."""
    from vgate_tpu_torch.backends.base import SamplingParams
    from vgate_tpu_torch.runtime.engine_core import EngineCore

    cfg = gemma_config(model, device, block_slots)
    what = f"{model} decode_block_slots {block_slots}"
    if params is None:
        engine, core = start_engine(cfg, what)
        stop = engine.shutdown
    else:
        t0 = time.perf_counter()
        core = EngineCore(cfg, params=params)
        core.start()
        engine, stop = again_engine(core), core.stop
        print(f"{what} engine up in {time.perf_counter() - t0:.1f} s over "
              f"the same weights, {core.geometry.num_pages} KV pages",
              flush=True)
    warmup = warm_up(core, what)
    texts = prompts()
    greedy = SamplingParams(max_tokens=32, temperature=0.0)
    sampled = SamplingParams(max_tokens=32, temperature=0.8, top_p=0.9,
                             top_k=50, seed=1234)
    batch = (texts + [texts[3]], [greedy] * 8 + [sampled])
    doc = filler("Document: ", 4600, 7)
    shorts = [filler(f"Reader {i}: ", 60 + 20 * i, i + 1) for i in range(7)]
    out = {"kv_pages": core.geometry.num_pages, "warmup": warmup}
    stats0 = core.get_stats()
    try:
        t0 = time.perf_counter()
        burst, cold = serve(engine, batch)
        wave = engine.generate_batch([doc] + shorts, [greedy] * 8)
        hits_before = core.get_stats()["prefix_cache"]["hit_tokens"]
        turn2_ids = (core.encode_prompt(doc) + wave[0].token_ids
                     + core.encode_prompt("\nUser: and the last part?"))
        turn2 = core.submit_tokens(turn2_ids, greedy)
        check(turn2.done_event.wait(600), "second turn did not finish")
        check(turn2.finish_reason in ("stop", "length"),
              f"second turn finish reason {turn2.finish_reason!r}")
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        check_results(burst + wave, core)
        stats = check_settled(core)
        pc = stats["prefix_cache"]
        hit2 = pc["hit_tokens"] - hits_before
        check(hit2 > 4096, f"the second turn hit {hit2} tokens, not > 4096")
        check(pc["chunked_prefills"] >= 1, f"no chunked prefill: {pc}")
        L = core.spec.num_layers
        steps = stats["steps"] - stats0["steps"]
        passes = stats["prompt_passes"] - stats0["prompt_passes"]
        if device == "cuda":  # no kernel runs on the CPU
            check_graphed(stats, what, since=stats0)
            mine, other = ("paged_decode_attention_blocked",
                           "paged_decode_attention")
            if block_slots == 1:
                mine, other = other, mine
            check(launches[mine] == L * steps,
                  f"{mine}: {launches[mine]} launches for {steps} decode "
                  f"steps of {L} layers")
            check(launches[other] == 0, f"{other} launched in this phase")
            attn = (launches["flash_prefill_attention"]
                    + launches["paged_multitok_attention"])
            check(attn == L * passes,
                  f"K2 + K3: {attn} launches for {passes} prompt passes")
            for name in ("paged_decode_attention_int8",
                         "paged_multitok_attention_int8", "int8_matmul",
                         "int4_matmul"):
                check(launches[name] == 0, f"{name} launched on bf16")
        out.update({
            "wall_s": wall,
            "cold_burst": cold,
            "ttft_s_document": wave[0].metrics["ttft"],
            "ttft_s_second_turn": turn2.ttft,
            "decode_steps": steps,
            "prompt_passes": passes,
            "second_turn_hit_tokens": hit2,
            "prefix_cache": pc,
            "finish": [r.finish_reason for r in burst + wave]
            + [turn2.finish_reason],
            "decode_graphs": stats["decode_graphs"],
            "launches": launches,
            "first_tokens": [r.token_ids[0] for r in burst + wave]
            + [turn2.generated_ids[0]],
            "streams": [r.token_ids for r in burst + wave]
            + [list(turn2.generated_ids)],
        })
        if device == "cuda":
            out["profile"] = profile_burst(engine, batch, core)
            check_settled(core)
        out["logits"] = check_model_logits(core, texts[2])
        out["logits"].update(check_long_logits(core, doc))
        params = core.params
    finally:
        stop()
    # ``stop`` is bound to the engine: drop it too, so the pools go now
    del engine, core, stop
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return out, params


def phase_agreement(a: dict, b: dict) -> dict:
    """Phase A (K1) against phase B (K6): every first token must match
    where the two phases sent the same prompt (K2 and K3 are the same in
    both; the second turn's prompt carries the first turn's answer, so
    it is compared only when those answers agree).  How far the greedy
    streams agree is printed, not checked: K1 and K6 sum in another
    order."""
    n = len(a["first_tokens"]) - 1
    same_prompt = a["streams"][n - 7 - 1] == b["streams"][n - 7 - 1]
    upto = n + 1 if same_prompt else n
    check(a["first_tokens"][:upto] == b["first_tokens"][:upto],
          f"first tokens differ between the K1 and K6 phases: "
          f"{a['first_tokens']} vs {b['first_tokens']}")
    return {"first_tokens_compared": upto,
            **agreement(b["streams"], a["streams"])}


# ---------------------------------------------------------- Mixtral MoE

MIXTRAL = "mistralai/Mixtral-8x7B-Instruct-v0.1"
# K4 and K5 at Mixtral's expert shapes: the capacity of a decode step at
# 32 slots (16 rows) and of a 2 x 1,024-token prompt pass (1,024 rows),
# gate/up 4096 -> 14336 and down 14336 -> 4096
EXPERT_SHAPES = [(16, 4096, 14336), (16, 14336, 4096), (1024, 4096, 14336),
                 (1024, 14336, 4096)]
# (what, rows, in, out, out dtype): K4/K5 at the expert shapes, then at
# Mixtral's other projections: q/o and k/v at a decode step's 32 rows
# and a 2 x 1,024-token prompt pass's 2,048, and the f32 lm_head
MIXTRAL_QMM_SHAPES = (
    [("expert", r, i, o, torch.bfloat16) for r, i, o in EXPERT_SHAPES]
    + [("mixtral q/o", 32, 4096, 4096, torch.bfloat16),
       ("mixtral k/v", 32, 4096, 1024, torch.bfloat16),
       ("mixtral lm_head", 32, 4096, 32000, torch.float32),
       ("mixtral q/o", 2048, 4096, 4096, torch.bfloat16),
       ("mixtral k/v", 2048, 4096, 1024, torch.bfloat16)])


def check_mixtral_matmuls(dev) -> dict:
    """K4 (int8) and K5 (int4) at ``MIXTRAL_QMM_SHAPES``: held to the
    plain version (KERNEL_TOL, QMM_F32_TOL for f32 out), then timed three
    times in turns with the library yardstick (one bf16 ``torch.mm`` on
    the weight dequantized beforehand), with the bound; one line each."""
    from vgate_tpu_torch.ops.kernels import quant_matmul as qm
    from vgate_tpu_torch.ops.quant import unpack_int4

    out = {}
    for bits, name, kernel, plain in (
            (8, "int8_matmul", qm.int8_matmul, qm.int8_matmul_plain),
            (4, "int4_matmul", qm.int4_matmul, qm.int4_matmul_plain)):
        for label, rows, in_dim, out_dim, dtype in MIXTRAL_QMM_SHAPES:
            f32 = dtype == torch.float32
            what = (f"{name} at {label} {rows}x{in_dim}x{out_dim}"
                    + (" f32" if f32 else ""))
            x, w = qmm_case(rows, in_dim, out_dim, bits, 70, dev)
            vals = w.q if bits == 8 else w.q_packed
            run = lambda: kernel(x, vals, w.scale,  # noqa: E731
                                 out_dtype=dtype)
            got = run()
            expect = plain(x, vals, w.scale, out_dtype=torch.float32)
            torch.cuda.synchronize()
            check(got.dtype == dtype, f"{what} wrote {got.dtype}")
            err = within(got, expect, what,
                         QMM_F32_TOL if f32 else KERNEL_TOL)
            del got, expect
            q = w.q if bits == 8 else unpack_int4(w.q_packed)
            wd = (q.float() * w.scale).bfloat16()
            del q
            library = ((lambda: torch.mm(x, wd, out_dtype=dtype)) if f32
                       else (lambda: torch.mm(x, wd)))
            ms, library_ms = [], []
            for _ in range(3):
                ms.append(time_ms(run, iters=20))
                library_ms.append(time_ms(library, iters=20))
            bound, by = qmm_bound(rows, in_dim, out_dim, bits, 4 if f32 else 2)
            mid, lib_mid = sorted(ms)[1], sorted(library_ms)[1]
            line = {
                "ms": mid, "ms_runs": ms, "library_ms": lib_mid,
                "library_ms_runs": library_ms, "bound_ms": bound,
                "bound_by": by, "bound_share": bound / mid,
                "vs_library": mid / lib_mid, "max_abs_err": err,
                "weight_gb_s": in_dim * out_dim * bits / 8 / mid / 1e6,
                "plain_ms": time_ms(
                    lambda: plain(x, vals, w.scale, out_dtype=dtype),
                    iters=3),
            }
            print(f"  {what}: " + json.dumps(line), flush=True)
            out[what] = line
            del x, w, wd
            torch.cuda.empty_cache()
    out.update(check_w8a8_products(dev))
    return out


def mixtral_attention_shapes(dev) -> None:
    """K1, K2 and K3 at Mixtral-8x7B's shapes (32/8 heads, hd 128, pages
    of 32), each held to its plain version at KERNEL_TOL and timed beside
    its bound and library yardstick, a line each: K1 at the phase's 32
    slots with contexts 1..2048, K2 on a 2 x 1,024-token prompt pass, K3
    on 4 slots of a 512-token chunk over a 1,024-token prefix."""
    from vgate_tpu_torch.ops import attention as plain
    from vgate_tpu_torch.ops.kernels.paged_decode import (
        paged_decode_attention as k1,
    )

    H, KV, hd, ps = 32, 8, 128, 32
    B, pps = 32, 64
    q, k, v, pt, sl = decode_inputs(B, H, KV, hd, ps, pps, DECODE_LENS, 81,
                                    dev)
    shape = f"B={B} H={H} KV={KV} hd={hd} ps={ps} ctx=1..2048"
    got = thrice(lambda: k1(q, k, v, pt, sl), f"K1 at mixtral-8x7b {shape}")
    expect = plain.paged_decode_attention(q.float(), k.float(), v.float(),
                                          pt, sl)
    torch.cuda.synchronize()
    within(got, expect, f"paged decode at mixtral-8x7b [{shape}]")
    library, lib = sdpa_decode(q, k, v, pt, sl)
    torch.cuda.synchronize()
    within(got, lib, f"paged decode at mixtral-8x7b [{shape}] vs SDPA")
    library_ms = time_ms(library, iters=20)
    del library, lib, got, expect
    bound, _ = decode_bound(DECODE_LENS, B, H, KV, hd, ps)
    time_k1(k1, q, k, v, pt, sl, {}, bound, library_ms,
            f"mixtral-8x7b [{shape}]")
    del q, k, v
    B, S = 2, 1024
    time_prefill(*prefill_inputs(B, S, H, KV, hd, 82, dev),
                 torch.full((B,), S, dtype=torch.int32, device=dev),
                 f"mixtral-8x7b [B={B} S={S} H={H} KV={KV} hd={hd}]")
    B, S, prefix = 4, 512, 1024
    time_suffix(dev, B, S, H, KV, hd, ps, prefix, 83,
                f"mixtral-8x7b [B={B} S={S} prefix={prefix} H={H} KV={KV} "
                f"hd={hd} ps={ps}]")
    torch.cuda.empty_cache()


def check_w8a8_products(dev) -> dict:
    """The W8A8 int8 x int8 -> int32 product (``torch._int_mm``, a
    library call) at ``EXPERT_SHAPES``, on the weight as the port stores
    it (``[in, out]`` row-major) and on a column-major copy (in
    contiguous): both equal the exact product, each timed three times in
    turns, beside the bytes bound of the int8 weight."""
    from vgate_tpu_torch.ops.quant import int8_mm

    out = {}
    gen = torch.Generator(device=dev).manual_seed(71)
    for rows, in_dim, out_dim in EXPERT_SHAPES:
        what = f"W8A8 int8 product at expert {rows}x{in_dim}x{out_dim}"
        xq = torch.randint(-127, 128, (max(rows, 32), in_dim),
                           generator=gen, device=dev, dtype=torch.int8)
        xq[rows:] = 0
        wq = torch.randint(-127, 128, (in_dim, out_dim), generator=gen,
                           device=dev, dtype=torch.int8)
        wcol = wq.t().contiguous().t()
        row = lambda: int8_mm(xq[:rows], wq)  # noqa: E731
        col = lambda: torch._int_mm(xq, wcol)  # noqa: E731
        exact = bool(torch.equal(
            row()[:2].cpu(), xq[:2].cpu().int() @ wq.cpu().int()))
        check(exact, f"{what}: the int8 product is not the exact sum")
        try:
            same = bool(torch.equal(row(), col()[:rows]))
        except RuntimeError as exc:  # a layout the library refuses
            same, col = repr(exc)[:200], None
        row_ms, col_ms = [], []
        for _ in range(3):
            row_ms.append(time_ms(row, iters=20))
            if col is not None:
                col_ms.append(time_ms(col, iters=20))
        # the int8 weight and activations read once, the int32 out written
        t_bytes = (in_dim * out_dim + rows * in_dim + 4 * rows * out_dim) \
            / H100_BYTES_PER_S * 1e3
        t_ops = 2 * rows * in_dim * out_dim / H100_INT8_OPS * 1e3
        line = {"row_major_ms": sorted(row_ms)[1], "row_major_runs": row_ms,
                "col_major_ms": sorted(col_ms)[1] if col_ms else None,
                "col_major_runs": col_ms, "col_major_equal": same,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        print(f"  {what}: " + json.dumps(line), flush=True)
        out[what] = line
        del xq, wq, wcol
        torch.cuda.empty_cache()
    return out


def check_moe_launches(launches: dict, stats: dict, stats0: dict,
                       layers: int, per_pass: int, what: str) -> dict:
    """A MoE phase's exact launch counts on bf16 pools: K1 once a layer
    a decode step, K2 + K3 once a layer a prompt or suffix pass, K4
    ``per_pass`` times a forward pass (4 + 3 x experts a layer and the
    lm_head, or the lm_head alone under W8A8), nothing else."""
    steps = stats["steps"] - stats0["steps"]
    passes = stats["prompt_passes"] - stats0["prompt_passes"]
    k1 = launches["paged_decode_attention"]
    k2 = launches["flash_prefill_attention"]
    k3 = launches["paged_multitok_attention"]
    k4 = launches["int8_matmul"]
    check(steps > 0 and k1 == layers * steps,
          f"{what}: {k1} K1 launches for {steps} decode steps")
    check(passes > 0 and k2 + k3 == layers * passes,
          f"{what}: K2 {k2} + K3 {k3} launches for {passes} passes")
    check(k4 == per_pass * (steps + passes),
          f"{what}: {k4} K4 launches for {steps + passes} forward passes, "
          f"not {per_pass} each")
    for name in ("int4_matmul", "paged_decode_attention_int8",
                 "paged_multitok_attention_int8",
                 "paged_decode_attention_blocked"):
        check(launches[name] == 0, f"{what}: {name} launched")
    return {"decode_steps": steps, "prompt_passes": passes,
            "int8_matmul_per_pass": per_pass}


def check_moe_layer(core, rows=(32, 2048, -2048)) -> dict:
    """One MoE layer's products at full width on the engine's layer-0
    weights, on the same bf16 input of ``abs(rows)`` tokens (a decode
    step at 32 slots; a 2 x 1,024-token prompt pass; negative: the same
    pass whose second half repeats one row, as pad rows of one token do,
    so two experts get more than their capacity and tokens are dropped):
    ``_moe_mlp`` and the q/k/v and o projections as the engine runs them
    (K4 per expert, or with ``int8_native`` the W8A8 int8 products)
    against the same functions under ``plain_matmuls`` (K4's plain
    version; W8A8 as ``plain_w8a8``).  The router runs the same fp32 ops
    in both, so both route alike and drop the same tokens, and only the
    products differ: each output within 4 bf16 steps of its largest
    value.  This holds W8A8 tightly: end to end its per-token rounding
    of the activations makes the plain-vs-plain floor large."""
    from vgate_tpu_torch.models import decoder as dec
    from vgate_tpu_torch.ops.kernels import quant_matmul as qm

    spec, dev = core.spec, core.device
    lp = dec.layer_params(core.params, 0)
    gen = torch.Generator(device=dev).manual_seed(72)
    K, E = spec.experts_per_token, spec.num_experts
    i8 = spec.int8_native

    def forward(x):
        q, k, v = dec._project_qkv(x, lp, spec)
        o = dec.weighted_einsum("...h,hd->...d", x[:, :spec.q_dim],
                                lp["o"]["w"], int8_native=i8)
        return {"moe": dec._moe_mlp(x, lp, spec), "q": q, "k": k, "v": v,
                "o": o}

    out = {}
    for n in rows:
        T = abs(n)
        x = torch.randn((T, spec.hidden_size), generator=gen,
                        device=dev).bfloat16()
        if n < 0:
            x[T // 2:] = x[T // 2]
        before = qm.int8_matmul.launches
        with torch.no_grad():
            got = forward(x)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            launches = qm.int8_matmul.launches - before
            with plain_matmuls():
                ref = forward(x)
        capacity = max(4, int((T * K / E) * 2.0 + 0.5))
        top = torch.softmax(x.float() @ lp["router"].float(), -1).topk(K)
        counts = torch.bincount(top.indices.flatten(), minlength=E)
        dropped = int((counts - capacity).clamp(min=0).sum())
        what = f"rows {T}" + (", half repeated" if n < 0 else "")
        out[what] = {"capacity": capacity, "dropped_assignments": dropped,
                     "int8_matmul_launches": launches}
        for name in got:
            err = float((got[name].float() - ref[name].float()).abs().max())
            scale = float(ref[name].float().abs().max())
            tol = 4 * 2.0 ** (math.floor(math.log2(scale)) - 7)
            out[what][name] = {"max_abs_err": err, "tol": tol,
                               "max_value": scale}
            check(bool(torch.isfinite(got[name]).all()) and err <= tol,
                  f"MoE layer {name} at {what} off its plain version: "
                  f"{out[what][name]}")
        # (an expert takes every token when capacity >= T: no drop then)
        check(n > 0 or capacity >= T or dropped > 0,
              f"MoE layer at {what}: no token dropped")
        if dev.type == "cuda":
            # K4 once an expert's gate/up/down and once q/k/v/o; W8A8
            # runs none of them
            expect = 0 if i8 else 3 * E + 4
            check(launches == expect,
                  f"MoE layer at {what}: {launches} K4 launches, not "
                  f"{expect}")
    return out


def mixtral_config(model: str, device: str, int8_native: bool = False):
    """Mixtral with int8 weights (experts included) and a bf16 pool, the
    prefix cache on and chunked prefill at 512."""
    return engine_config(model, device, quantization="int8",
                         prefill_chunk=512, int8_native=int8_native)


def mixtral_path(model: str = MIXTRAL, device: str = "cuda") -> dict:
    """Mixtral-8x7B at full width on one card: int8 weights (its experts
    quantized a layer at a time as they are drawn from seed 0, so the
    bf16 tree never exists) and a bf16 pool.  The engine's warm-up, the
    9-request burst, the prefix phase's traffic (hits, copy-on-write and
    chunks through K3), exact launch counts (K4 897 a forward pass at 32
    layers, K1/K2/K3 32 a pass), every decode chunk a graph replay, the
    logits of a prompt pass, a decode step and two suffix passes against
    a plain forward over the same padded passes with the same routing
    (``staged_logits``), one layer's products at full width
    (``check_moe_layer``), a profile of a warm burst; then a second
    engine over the same weights with ``int8_native`` (W8A8: K4 runs
    only the lm_head) serving the burst, its logits held to a plain W8A8
    forward, its layer products to ``plain_w8a8``, and its streams
    compared with the first engine's (printed)."""
    from vgate_tpu_torch.backends.base import SamplingParams
    from vgate_tpu_torch.runtime.engine_core import EngineCore

    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine, core = start_engine(mixtral_config(model, device), "mixtral int8")
    out = {"init_s": time.perf_counter() - t0,
           "load_s": core.load_time_s, "kv_pages": core.geometry.num_pages}
    out["weights_gb"] = sum(t.numel() * t.element_size()
                            for t in leaves(core.params)) / 1e9
    if device == "cuda":
        out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["warmup"] = warm_up(core, "mixtral int8")
    texts = prompts()
    greedy = SamplingParams(max_tokens=32, temperature=0.0)
    sampled = SamplingParams(max_tokens=32, temperature=0.8, top_p=0.9,
                             top_k=50, seed=1234)
    batch = (texts + [texts[3]], [greedy] * 8 + [sampled])
    L, E = core.spec.num_layers, core.spec.num_experts
    stats0 = core.get_stats()
    try:
        results, cold = serve(engine, batch)
        system, tails, cow, long = prefix_texts()
        t0 = time.perf_counter()
        served = list(results)
        served += engine.generate_batch([system + tails[0]], [greedy])
        served += engine.generate_batch([system + t for t in tails[1:]],
                                        [greedy] * 4)
        served += engine.generate_batch([cow, long], [greedy] * 2)
        if device == "cuda":
            torch.cuda.synchronize()
        out["prefix_traffic_s"] = time.perf_counter() - t0
        launches = read_launches()
        check_results(served, core)
        stats = check_settled(core)
        pc = stats["prefix_cache"]
        check(pc["hit_tokens"] > 0, f"no prefix hit: {pc}")
        check(pc["cow_copies"] >= 1, f"no copy-on-write: {pc}")
        check(pc["chunked_prefills"] >= 1, f"no chunked prefill: {pc}")
        if device == "cuda":  # no kernel runs on the CPU
            check_graphed(stats, "the mixtral phase", since=stats0)
            out["launch_counts"] = check_moe_launches(
                launches, stats, stats0, L, (4 + 3 * E) * L + 1,
                "the mixtral phase")
            check(launches["paged_multitok_attention"] > 0,
                  "K3 was not launched on the prefix traffic")
        out.update({
            "requests": len(served),
            "cold_burst": cold,
            "prefix_cache": pc,
            "kv_token_capacity": stats["kv_token_capacity"],
            "decode_graphs": stats["decode_graphs"],
            "launches": launches,
        })
        out["logits"] = check_model_logits(core, texts[2])
        out["logits"].update(check_suffix_logits(core, system + tails[0]))
        out["moe_layer"] = check_moe_layer(core)
        if device == "cuda":
            out["capacity_at_one_budget"] = page_capacity(core)
            # a warm burst (its prompts now hit)
            out["profile"] = profile_burst(engine, batch, core)
        params = core.params
    finally:
        engine.shutdown()
    del engine, core
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    # W8A8 over the same weights, on a fresh engine
    t0 = time.perf_counter()
    w8 = EngineCore(mixtral_config(model, device, int8_native=True),
                    params=params)
    w8.start()
    w8_out = {"init_s": time.perf_counter() - t0,
              "kv_pages": w8.geometry.num_pages}
    try:
        check(w8.spec.int8_native, "int8_native is off on the W8A8 engine")
        w8_out["warmup"] = warm_up(w8, "mixtral W8A8")
        stats0 = w8.get_stats()
        w8_results, w8_cold = serve(again_engine(w8), batch)
        if device == "cuda":
            torch.cuda.synchronize()
        launches = read_launches()
        check_results(w8_results, w8)
        stats = check_settled(w8)
        if device == "cuda":
            check_graphed(stats, "the mixtral W8A8 phase", since=stats0)
            w8_out["launch_counts"] = check_moe_launches(
                launches, stats, stats0, L, 1, "the mixtral W8A8 phase")
        w8_out.update({
            "cold_burst": w8_cold,
            "decode_graphs": stats["decode_graphs"],
            "launches": launches,
            "agreement_with_dequant_engine": agreement(
                [r.token_ids for r in w8_results[:8]],
                [r.token_ids for r in results[:8]]),
            "logits": check_model_logits(w8, texts[2]),
            "moe_layer": check_moe_layer(w8),
        })
    finally:
        w8.stop()
    del w8, params
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    out["w8a8"] = w8_out
    return out


def print_mixtral(card: str, mixtral: dict) -> dict:
    """Print the Mixtral phase's lines (the int8 engine, its profile, the
    W8A8 engine); returns the report without the profile."""
    profile = mixtral.pop("profile", None)
    w8 = mixtral["w8a8"]
    shown = {k: v for k, v in mixtral.items() if k != "w8a8"}
    print(f"mixtral-8x7b int8 weights, bf16 KV on {card}: "
          + json.dumps(shown), flush=True)
    if profile is not None:
        print_profile("mixtral-8x7b int8, a warm burst", card, profile)
    print(f"mixtral-8x7b W8A8 (int8_native) on {card}: " + json.dumps(w8),
          flush=True)
    return mixtral


def print_profile(what: str, card: str, profile: dict) -> None:
    print(f"profile of {what} on {card}: busy "
          f"{profile['device_busy_ms']:.1f} of {profile['wall_ms']:.1f} ms "
          f"wall ({100 * profile['device_busy_share']:.1f} %), "
          f"{profile['device_ops']} device ops "
          f"({profile['device_ops_per_step']:.0f} a decode step over "
          f"{profile['decode_steps']}), {profile['graph_launches']} graph "
          "launches", flush=True)
    for t in profile["top"]:
        print(f"  {t['ms']:9.2f} ms  {t['count']:6d}x  {t['name']}")
    for group, t in profile["groups"].items():
        print(f"  total {group}: {t['ms']:.2f} ms over {t['count']} launches")


def print_recovery(card: str, recovery: dict) -> None:
    shown = {k: v for k, v in recovery.items()
             if k not in ("kernel", "guard_cost", "perf_snapshot")}
    print(f"recovery phase on {card}: " + json.dumps(shown), flush=True)
    print(f"recovery phase perf_snapshot after a warm burst on {card}: "
          + json.dumps(recovery["perf_snapshot"]), flush=True)
    cost = recovery.get("guard_cost")
    if cost is None:
        return
    for side in ("on", "off"):
        prof = cost[side]
        print(f"recovery phase, a warm burst with the integrity guard "
              f"{side}, on {card}: device ops a decode step "
              f"{prof['device_ops_per_step']:.1f}, decode "
              f"{prof['decode_tok_s']:.1f} tokens/s, busy "
              f"{prof['device_busy_ms']:.1f} of {prof['wall_ms']:.1f} ms",
              flush=True)
    step = cost["guard_a_step"]
    print(f"recovery phase, the integrity guard of one decode step on "
          f"{card}: {step['device_ops']} device ops, {step['ms']:.4f} ms "
          f"over logits {step['logits']}", flush=True)


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
        for entry, line in _build.ptxas_entries(info["ptxas"]):
            kernel_name = demangled(entry)
            print(f"  {name}: {kernel_name}: {line}")
            # K1's kernel must not spill (no instantiation does)
            if kernel_name.startswith("paged_decode_tc_kernel") and \
                    "spill" in line:
                check(re.search(r"\b0 bytes spill stores, 0 bytes spill "
                                r"loads", line) is not None,
                      f"{kernel_name} spills: {line}")

    if sys.argv[1:] == ["mixtral"]:
        # the Mixtral phase alone, after the build and K1-K5 at its
        # shapes (a shorter run while that phase is worked on)
        check_mixtral_matmuls(dev)
        mixtral_attention_shapes(dev)
        print_mixtral(card, mixtral_path())
        print(card_line())
        return
    if sys.argv[1:] == ["recovery"]:
        # the recovery phase alone, after the build (a shorter run while
        # that phase is worked on); with no argument every phase runs
        recovery = recovery_path()
        print_recovery(card, recovery)
        print(card_line())
        print(json.dumps({"kernels": [recovery["kernel"]]}))
        return
    kernels = [check_paged_decode(dev), check_flash_prefill(dev),
               check_paged_multitok(dev)]
    torch.cuda.empty_cache()
    kernels += [check_paged_decode_int8(dev), check_paged_multitok_int8(dev)]
    torch.cuda.empty_cache()
    # K3 and K3-int8 at the verify widths of speculative decoding
    verify = check_k3_verify_shapes(dev)
    print(f"K3 verify shapes on {card}: " + json.dumps(verify), flush=True)
    torch.cuda.empty_cache()
    kernels += [check_quant_matmul(dev, 8), check_quant_matmul(dev, 4)]
    torch.cuda.empty_cache()
    # K1-K5 at Mixtral-8x7B's shapes
    check_mixtral_matmuls(dev)
    mixtral_attention_shapes(dev)
    kernels.append(check_paged_decode_blocked(dev))
    gemma_kernel_shapes(dev)
    print("host swap page round trip at 7B (1, 16, 17 pages; bit-exact, "
          "pools in place): " + json.dumps(check_swap_round_trip(dev)),
          flush=True)
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
        reference_prompts=[system + t for t in tails] + [cow, long],
        swap_prompts=swap_texts(),
    )
    params = served.pop("params")
    swap_reference = served.pop("swap_reference_streams")
    reference_streams = served.pop("reference_streams")
    bf16_burst = served.pop("burst_streams")
    profiles = served.pop("profile")
    backend_a = served.pop("backend")
    print(f"main path on {card}: " + json.dumps(served), flush=True)
    print(f"backend phase, prefix-off engine, on {card}: "
          + json.dumps(backend_a), flush=True)
    # the same warm burst on one engine: each decode chunk eager, then
    # each a graph replay
    for how, profile in profiles.items():
        print_profile(f"one warm burst, {how} decode chunks", card, profile)
    # each engine's pools were sized from free memory: release them
    # before the next engine sizes its own
    gc.collect()
    torch.cuda.empty_cache()
    memory("the prefix-off phase")
    swap = swap_path(params, swap_reference)
    print(f"host-swap phase on {card}, PCIe link "
          f"{swap['pcie_link']}: " + json.dumps(swap), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    memory("the host-swap phase")
    # speculative decoding over the same weights
    spec = spec_path(params)
    print(f"speculative phase on {card}: " + json.dumps(spec), flush=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    memory("the speculative phase")
    embeddings = embed_path()
    print(f"embeddings phase on {card}: " + json.dumps(embeddings),
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    memory("the embeddings phase")
    # supervised recovery, integrity and the perf recorder at 7B
    recovery = recovery_path()
    print_recovery(card, recovery)
    kernels.append(recovery.pop("kernel"))
    memory("the recovery phase")
    prefix = prefix_path(reference_streams=reference_streams)
    backend_b = prefix.pop("backend")
    print(f"prefix path on {card}: " + json.dumps(prefix), flush=True)
    print(f"backend phase, prefix-on engine, on {card}: "
          + json.dumps(backend_b), flush=True)
    for which, st in backend_b["streams"].items():
        print(f"backend streams, {which}, on {card}: 8 concurrent "
              f"stream_async; time to the first delta p50 "
              f"{st['ttft_first_delta_s_p50']} s, max "
              f"{st['ttft_first_delta_s_max']} s "
              f"({st['streams_with_a_delta']} streams yielded text); to "
              f"the first token p50 {st['ttft_first_token_s_p50']:.4f} s, "
              f"max {st['ttft_first_token_s_max']:.4f} s; decode "
              f"{st['decode_tok_s']:.1f} tokens/s; "
              f"{st['graphs_captured_in_window']} graphs captured inside "
              f"the window ({st['capture_s_in_window']:.2f} s)", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    memory("the prefix phase")
    runs = [served, backend_a, swap["swap_on"], swap["swap_off"], spec,
            recovery, prefix, backend_b]
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
    # Gemma-2-9B: decode through K1 (phase A), then through K6 (phase B)
    # on a second engine over the same weights
    phases, params = {}, None
    for block_slots in (1, 8):
        phase, params = gemma_path(block_slots, params=params)
        gprofile = phase.pop("profile")
        shown = {k: v for k, v in phase.items()
                 if k not in ("streams", "first_tokens")}
        print(f"gemma-2-9b decode_block_slots {block_slots} on {card}: "
              + json.dumps(shown), flush=True)
        print_profile(f"gemma-2-9b decode_block_slots {block_slots}, a warm "
                      "burst", card, gprofile)
        phases[block_slots] = phase
        runs.append(phase)
        memory(f"the gemma-2-9b decode_block_slots {block_slots} phase")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    print("gemma-2-9b K1 phase vs K6 phase: "
          + json.dumps(phase_agreement(phases[1], phases[8])), flush=True)
    memory("the gemma-2-9b phases")
    mixtral = print_mixtral(card, mixtral_path())
    runs += [mixtral, mixtral["w8a8"]]
    memory("the mixtral phase")
    for k in kernels:
        # launches of every path, each counted from 0 just before it ran
        k["launches"] = sum(run["launches"].get(k["name"], 0)
                            for run in runs)
        check(k["launches"] > 0, f"{k['name']} was never launched")
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
