"""The mesh compositions on the card: the partial modes of K1, K2 and K3
on a tp rank's heads, and an sp = 2 x tp = 2 group.

Every test is marked ``cuda`` and skips where ``torch.cuda.is_available()``
is false.  The file imports neither JAX nor ``vgate_tpu``:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_compose.py

* K1-sp, K2-ring and K3-sp against their plain versions (ops/
  attention.py) at Qwen2.5-7B's heads on a tp rank (14/2 at tp 2, a GQA
  group of 7; 7/1 at tp 4) and Qwen2.5-0.5B's (7/1 at hd 64), three runs
  bit-identical, with PR 21's tolerances (tests/test_torch_cuda_sp.py
  ``_agree``);
* an sp = 2 x tp = 2 group of Qwen2.5-0.5B (24 layers, 7/1 heads a tp
  rank, hd 64, random weights from seed 0, bf16), four ranks on one
  card (gloo, eager chunks): its prompt-pass and decode-step logits
  against an sp = 1, tp = 1 core's, the step on the one-rank core's
  token, within 16 bf16 steps of the largest logit (the ring's folds and
  tp's partial sums each round in their own order), and over a wave each rank's launches exact (K1-sp 24 a decode
  step, K2-ring 24 x (r + 1) a ring pass on sp index r, none of K1, K2
  or K3), trash page 0 still zeros on every rank.
"""

import numpy as np
import pytest
import torch

import test_torch_cuda_sp as sp_card
from vgate_tpu_torch.backends.base import SamplingParams
from vgate_tpu_torch.ops import attention as plain
from vgate_tpu_torch.ops.kernels import launch_counts

# (H, KV, hd): Qwen2.5-7B's heads on a tp rank at tp 2 and 4, and
# Qwen2.5-0.5B's at tp 2
HEADS = [(14, 2, 128), (7, 1, 128), (7, 1, 64)]
HEAD_IDS = ["7b_14_2", "7b_7_1", "0.5b_7_1"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    return torch.device("cuda")


def _thrice(fn):
    runs = [fn() for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for r in runs[1:]
               for a, b in zip(runs[0], r)), "three runs differ"
    return runs[0]


@pytest.mark.cuda
@pytest.mark.parametrize("H,KV,hd", HEADS, ids=HEAD_IDS)
def test_k1_sp_at_a_tp_ranks_heads(cuda, H, KV, hd):
    from vgate_tpu_torch.ops.kernels.paged_decode import paged_decode_partial

    gen = torch.Generator(device=cuda).manual_seed(H)
    ps, pps = 32, 8
    q, k, v, pt, base = sp_card._shard(gen, cuda, 5, H, KV, hd, ps, pps, 64,
                                       [0.5, 0.0, 1.0, 0.5, 0.3])
    sl = torch.tensor([pps * ps, 30, 1, 0, 200], dtype=torch.int32,
                      device=cuda)
    got = _thrice(lambda: paged_decode_partial(q, k, v, pt, sl, base,
                                               window=100))
    local, owned = plain.local_pages(pt, base, 64)
    want = plain.partial_paged_attention(q.float(), k.float(), v.float(),
                                         local, owned, sl, window=100)
    sp_card._agree(got, want, f"K1-sp {H}/{KV}")
    assert (got[2][1] == 0).all()  # slot 1: no page on this rank


@pytest.mark.cuda
@pytest.mark.parametrize("H,KV,hd", HEADS, ids=HEAD_IDS)
def test_k2_ring_at_a_tp_ranks_heads(cuda, H, KV, hd):
    from vgate_tpu_torch.ops.kernels.flash_prefill import flash_prefill_partial

    gen = torch.Generator(device=cuda).manual_seed(H)
    B, n = 3, 320
    q = torch.randn(B, n, H, hd, generator=gen, device=cuda).bfloat16()
    k, v = (torch.randn(B, n, KV, hd, generator=gen, device=cuda).bfloat16()
            for _ in range(2))
    # the diagonal hop (ragged), an earlier rank's block, a padded block
    kl = torch.tensor([250, n, 0], dtype=torch.int32, device=cuda)
    off = torch.tensor([0, n, 0], dtype=torch.int32, device=cuda)
    got = _thrice(lambda: flash_prefill_partial(q, k, v, kl, off,
                                                softcap=30.0))
    want = plain.prefill_partial_attention(q.float(), k.float(), v.float(),
                                           kl, off, softcap=30.0)
    sp_card._agree(got, want, f"K2-ring {H}/{KV}")
    assert (got[2][2] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("H,KV,hd", HEADS, ids=HEAD_IDS)
def test_k3_sp_at_a_tp_ranks_heads(cuda, H, KV, hd):
    from vgate_tpu_torch.ops.kernels.paged_multitok import (
        paged_multitok_partial,
    )

    gen = torch.Generator(device=cuda).manual_seed(H + 1)
    B, S, ps, pps = 3, 128, 32, 10
    _, k, v, pt, base = sp_card._shard(gen, cuda, B, H, KV, hd, ps, pps, 64,
                                       [0.5, 0.0, 0.5])
    q = torch.randn(B, S, H, hd, generator=gen, device=cuda).bfloat16()
    p0 = torch.tensor([ps * 4, ps * 2, 0], dtype=torch.int32, device=cuda)
    il = torch.tensor([S, 70, 9], dtype=torch.int32, device=cuda)
    got = _thrice(lambda: paged_multitok_partial(q, k, v, pt, p0, il, base))
    local, owned = plain.local_pages(pt, base, 64)
    want = plain.partial_suffix_attention(q.float(), k.float(), v.float(),
                                          local, owned, p0, p0 + il)
    real = torch.arange(S, device=cuda)[None, :] < il[:, None]
    sp_card._agree(tuple(t[real] for t in got), tuple(t[real] for t in want),
                   f"K3-sp {H}/{KV}")


def _core(devices, tp=1):
    from vgate_tpu_torch.config import load_config
    from vgate_tpu_torch.runtime.engine_core import EngineCore

    cfg = load_config(
        model={"model_id": sp_card.MODEL, "dtype": "bfloat16",
               "max_model_len": 256},
        device={"device": "cuda", "kv_page_size": 16, "kv_num_pages": 128,
                "max_batch_slots": sp_card.SLOTS,
                "prefill_buckets": [32, 64, 128], "prefix_cache": False,
                "sp": len(devices) // tp, "tp": tp,
                "devices": devices if len(devices) > 1 else []},
        logging={"level": "WARNING"},
    )
    return EngineCore(cfg)


def _close(got, want, what):
    """Within 16 bf16 steps of the largest logit."""
    scale = float(want.abs().max())
    tol = 16 * 2.0 ** (np.floor(np.log2(scale)) - 7)
    err = float((got - want).abs().max())
    assert err <= tol, f"{what}: {err} off sp=1's (tolerance {tol})"


@pytest.mark.cuda
def test_sp2_x_tp2_on_one_card_matches_one_rank_with_exact_launches(cuda):
    from vgate_tpu_torch.models import decoder

    rng = np.random.default_rng(7)
    ids = rng.integers(3, 5000, size=45).tolist()
    prompts = [rng.integers(3, 5000, size=n).tolist() for n in (9, 17, 60)]
    ref = _core(["cuda:0"])
    try:
        want = sp_card._logits(ref, ids)
    finally:
        ref.close()
        del ref
        torch.cuda.empty_cache()
    core = _core(["cuda:0"] * 4, tp=2)
    try:
        mesh = core.mesh
        assert (mesh.sp, mesh.tp) == (2, 2) and not core.decode_graphs
        assert core.allocator.reserved == frozenset({0, 64})
        # a tp rank's kv head of its shard of the pages
        assert tuple(core.k_pages.shape[1:3]) == (1, 64)
        assert core.spec.num_heads == 7 and core.spec.num_kv_heads == 1
        # the step's token is the one-rank core's: at a near-tie the
        # group's own argmax could take another
        step_token = int(want[0].argmax())
        for got, w, what in zip(sp_card._logits(core, ids, step_token),
                                want, ("prompt pass", "decode step")):
            _close(got, w, what)
        launch_counts(reset=True)
        core.reset_follower_launches()
        s0 = core.get_stats()
        f0s = core.follower_stats()
        real, ring = decoder.sp_prefill_forward, []

        def recorded(params, spec, tok, *args, **kwargs):
            ring.append(int(tok.shape[0]))
            return real(params, spec, tok, *args, **kwargs)

        decoder.sp_prefill_forward = recorded
        try:
            core.start()
            seqs = [core.submit_tokens(p, SamplingParams(
                max_tokens=8, temperature=0.0)) for p in prompts]
            for s in seqs:
                assert s.done_event.wait(300), "a stream never finished"
            core.stop()
        finally:
            decoder.sp_prefill_forward = real
        assert all(s.error is None and len(s.generated_ids) == 8
                   for s in seqs)
        s1 = core.get_stats()
        fs = core.follower_stats()
        steps = s1["steps"] - s0["steps"]
        assert ring and s1["prompt_passes"] - s0["prompt_passes"] == len(ring)
        ranks = [(0, launch_counts())] + [(f["rank"], f["kernel_launches"])
                                          for f in fs]
        for rank, n in ranks:
            r = rank // 2 % 2  # the sp index
            assert (n["paged_decode_partial"], n["flash_prefill_partial"],
                    n["paged_multitok_partial"]) == (
                24 * steps, 24 * (r + 1) * len(ring), 0), rank
            assert (n["paged_decode_attention"], n["flash_prefill_attention"],
                    n["paged_multitok_attention"]) == (0, 0, 0), rank
        for f, f0 in zip(fs, f0s):
            assert f["steps"] - f0["steps"] == steps
            assert f["memory"]["trash_page_zero"], f["rank"]
        torch.cuda.synchronize()
        assert not core.k_pages[:, :, 0].any()
        assert not core.v_pages[:, :, 0].any()
    finally:
        core.close()
