"""Smoke test of vgate_tpu_torch on one NVIDIA card.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It (1) builds the hand-written CUDA kernels from vgate_tpu_torch/csrc
with nvcc, all sources at once; (2) holds every kernel against its plain
PyTorch version on the card at the shapes the main path gives it, and
times kernel, plain version and, where one exists, a single PyTorch
library call computing the same function; (3) serves chat requests
through ``VGTEngine`` with Qwen2.5-7B-Instruct at full width (random
weights from seed 0, bf16, prefix cache off), counting the kernel
launches of that run; (4) checks the served output and the model's
logits against a plain full-sequence forward.  It prints the card's
name and power limit, one JSON line of per-kernel numbers and, last,
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero;
without a CUDA card it exits non-zero before printing any result.
"""

from __future__ import annotations

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
    lens = [1, 31, 32, 33, 64, 65, 100, 127, 128, 129, 255, 256, 257, 300,
            511, 512, 513, 700, 1000, 1023, 1024, 1025, 1200, 1500, 1535,
            1536, 1600, 1800, 2000, 2047, 2048, 2048]
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


def check_model_logits(core, text: str) -> dict:
    """The kernel forwards (a prompt pass, then one decode step) against
    a plain full-sequence forward on one prompt.  bf16 through 28 layers
    is sensitive to rounding, so the tolerance is measured, not guessed:
    two plain attentions (fp32 vs bf16 probabilities before PV) give the
    noise floor, and the kernel path must stay within 3x that floor (and
    never be held to less than 4 bf16 steps of the largest logit)."""
    from vgate_tpu_torch.models.decoder import decode_forward, prefill_forward
    from vgate_tpu_torch.ops.attention import (
        causal_prefill_attention,
        flash_prefill_attention,
    )

    spec, dev, ps = core.spec, core.device, core.geometry.page_size
    ids = core.encode_prompt(text)
    n = len(ids)
    S = -(-n // 128) * 128
    shape = (spec.num_layers, spec.num_kv_heads, 1 + S // ps + 1, ps,
             spec.head_dim)
    kp = torch.zeros(shape, dtype=torch.bfloat16, device=dev)
    vp = torch.zeros_like(kp)
    pt = torch.arange(1, 2 + S // ps, dtype=torch.int32, device=dev)[None]
    tok = torch.zeros((1, S), dtype=torch.int32, device=dev)
    tok[0, :n] = torch.tensor(ids, dtype=torch.int32, device=dev)
    sl = torch.tensor([n], dtype=torch.int32, device=dev)
    report = {}

    def compare(what, got, seq):
        ref = reference_logits(core.params, spec, seq,
                               causal_prefill_attention)
        alt = reference_logits(
            core.params, spec, seq,
            lambda q, k, v, sl: flash_prefill_attention(q, k, v, sl),
        )
        check(bool(torch.isfinite(got).all()), f"{what} logits not finite")
        err = float((got - ref).abs().max())
        floor = float((alt - ref).abs().max())
        scale = float(ref.abs().max())
        report[what] = {
            "max_abs_err": err, "plain_vs_plain": floor, "max_logit": scale,
            "same_argmax": int(got.argmax()) == int(ref.argmax()),
        }
        # logits come out of a bf16 matmul: never ask for less than a
        # few bf16 steps at the largest logit
        ulp = 2.0 ** (math.floor(math.log2(scale)) - 7)
        check(err <= max(3 * floor, 4 * ulp),
              f"{what} logits off the plain forward: {report[what]}")
        return int(ref.argmax())

    with torch.no_grad():
        got = prefill_forward(core.params, spec, tok, sl, kp, vp,
                              pt[:, : S // ps])
        nxt = compare("prefill", got, tok[:, :n])
        got = decode_forward(
            core.params, spec,
            torch.tensor([nxt], dtype=torch.int32, device=dev),
            torch.tensor([n], dtype=torch.int32, device=dev), kp, vp, pt,
        )
        nxt_t = torch.tensor([[nxt]], dtype=torch.int32, device=dev)
        compare("decode", got, torch.cat([tok[:, :n], nxt_t], 1))
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


def main_path(model: str = MODEL, device: str = "cuda") -> dict:
    from vgate_tpu_torch.backends.base import SamplingParams
    from vgate_tpu_torch.config import load_config
    from vgate_tpu_torch.engine import VGTEngine
    from vgate_tpu_torch.ops.kernels.flash_prefill import (
        flash_prefill_attention,
    )
    from vgate_tpu_torch.ops.kernels.paged_decode import (
        paged_decode_attention,
    )

    cfg = load_config(
        model={"model_id": model, "engine_type": "torch_cuda",
               "dtype": "bfloat16", "max_model_len": 2048},
        device={"device": device, "prefix_cache": False},
        logging={"level": "WARNING"},
    )
    t0 = time.perf_counter()
    engine = VGTEngine(cfg)
    core = engine.backend.core
    print(f"engine up in {time.perf_counter() - t0:.1f} s: {model}, "
          f"{core.geometry.num_pages} KV pages", flush=True)
    try:
        texts = prompts()
        greedy = [SamplingParams(max_tokens=32, temperature=0.0)] * 8
        sampled = SamplingParams(max_tokens=32, temperature=0.8, top_p=0.9,
                                 top_k=50, seed=1234)
        batch = (texts + [texts[3]], greedy + [sampled])
        paged_decode_attention.launches = 0
        flash_prefill_attention.launches = 0
        results, cold = serve(engine, batch)
        launches = {
            "paged_decode_attention": paged_decode_attention.launches,
            "flash_prefill_attention": flash_prefill_attention.launches,
        }
        for name, count in launches.items():
            check(count > 0, f"{name} was not launched on the main path")
        for r in results:
            check(r.finish_reason in ("stop", "length"),
                  f"finish reason {r.finish_reason!r}")
            check(1 <= r.num_tokens <= 32, f"{r.num_tokens} tokens")
            if r.finish_reason == "length":
                check(r.num_tokens == 32, "length finish before 32 tokens")
            check(all(0 <= t < core.spec.vocab_size for t in r.token_ids),
                  "token id out of vocabulary")
        # the same batch again (same bucket groups, so the same matmul
        # shapes): greedy rows and the seeded sampled row must repeat
        again, warm = serve(engine, batch)
        for a, b in zip(results, again):
            check(a.token_ids == b.token_ids,
                  "tokens differ between two identical runs")
        profile = profile_burst(engine, batch) if device == "cuda" else None
        stats = core.get_stats()
        check(stats["used_pages"] == 0, f"{stats['used_pages']} pages leak")
        check(stats["running"] == 0, "sequences still running")
        return {
            "requests": len(results),
            "tokens": sum(r.num_tokens for r in results),
            "finish": [r.finish_reason for r in results],
            "cold": cold,
            "warm": warm,
            "logits": check_model_logits(core, texts[2]),
            "profile": profile,
            "launches": launches,
        }
    finally:
        engine.shutdown()


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

    kernels = [check_paged_decode(dev), check_flash_prefill(dev)]
    for k in kernels:
        print(f"kernel {k['name']} [{k['shape']}]: err {k['max_abs_err']:.3g}"
              f" ms {k['ms']:.4f} plain {k['plain_ms']:.4f} bound "
              f"{k['bound_ms']:.4f} ({k['bound_by']}) library "
              f"{k['library_ms']}", flush=True)
    torch.cuda.empty_cache()

    served = main_path()
    profile = served.pop("profile")
    print(f"main path on {card}: " + json.dumps(served), flush=True)
    print(f"profile of one warm burst on {card}: busy "
          f"{profile['device_busy_ms']:.1f} of {profile['wall_ms']:.1f} ms "
          f"wall ({100 * profile['device_busy_share']:.1f} %), "
          f"{profile['device_ops']} device ops", flush=True)
    for t in profile["top"]:
        print(f"  {t['ms']:9.2f} ms  {t['count']:6d}x  {t['name']}")
    for k in kernels:
        k["launches"] = served["launches"][k["name"]]
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
