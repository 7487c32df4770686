"""Sequence parallelism on the card: the partial modes of K1, K2 and K3
and an sp group (parallel/ring_attention.py, parallel/sp_decode.py).

Every test is marked ``cuda`` and skips where ``torch.cuda.is_available()``
is false (the two-card test also where one card is visible).  The file
imports neither JAX nor ``vgate_tpu``:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_sp.py

* K1-sp, K2-ring and K3-sp against their plain versions (ops/
  attention.py) on one sp rank's shard: every row's normalised output
  within bf16 rounding, m and l within fp32 ordering, and a row that
  sees no owned key exactly ``(0, -1e30, 0)``;
* an sp = 2 group of Qwen2.5-0.5B (24 layers, hd 64, random weights
  from seed 0, bf16) with both ranks on one card (gloo, eager chunks):
  its prompt-pass and decode-step logits against an sp = 1 core's, and
  over a wave each rank's launches exact (K1-sp 24 a decode step,
  K2-ring 24 x (r + 1) a ring pass, none of K1/K2/K3), trash page 0
  still zeros on both ranks;
* where two cards are visible, the same group one rank a card (NCCL):
  every decode chunk a graph replay on both ranks.
"""

import numpy as np
import pytest
import torch

from vgate_tpu_torch.backends.base import SamplingParams
from vgate_tpu_torch.ops import attention as plain
from vgate_tpu_torch.ops.kernels import launch_counts

MODEL = "Qwen/Qwen2.5-0.5B-Instruct"
SLOTS = 4
TOL = 1e-2  # bf16 kernel vs fp32 plain on the same bf16 inputs
ML_TOL = 1e-3  # m and l: fp32 sums of the same unrounded weights


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    return torch.device("cuda")


def _shard(gen, dev, B, H, KV, hd, ps, pps, shard, owned):
    """Rank 1's inputs of an sp = 2 group: q, its pool shard (local page
    0 zeros), global page tables over both shards (row b with a share
    ``owned[b]`` of its pages on rank 1), and its base."""
    q = torch.randn(B, H, hd, generator=gen, device=dev).bfloat16()
    k = torch.randn(KV, shard, ps, hd, generator=gen, device=dev).bfloat16()
    v = torch.randn(KV, shard, ps, hd, generator=gen, device=dev).bfloat16()
    k[:, 0] = 0
    v[:, 0] = 0
    mine = iter(range(shard + 1, 2 * shard))
    theirs = iter(range(1, shard))
    pt = torch.empty(B, pps, dtype=torch.int32)
    for b in range(B):
        pick = torch.rand(pps, generator=torch.Generator().manual_seed(b))
        for j in range(pps):
            pt[b, j] = next(mine) if pick[j] < owned[b] else next(theirs)
    return q, k, v, pt.to(dev), shard


def _agree(got, want, what):
    acc, m, l = got
    e_acc, e_m, e_l = want
    assert all(bool(torch.isfinite(t).all()) for t in got), what
    empty = e_l == 0
    assert torch.equal(l == 0, empty), what
    assert bool((acc[empty] == 0).all() and (m[empty] == -1e30).all()), what
    live = ~empty
    torch.testing.assert_close(m[live], e_m[live], atol=ML_TOL, rtol=ML_TOL)
    torch.testing.assert_close(l[live], e_l[live], atol=0, rtol=ML_TOL)
    out = acc / l.clamp_min(1e-30)[..., None]
    e_out = e_acc / e_l.clamp_min(1e-30)[..., None]
    torch.testing.assert_close(out[live], e_out[live], atol=TOL, rtol=TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("hd,H,KV,ps,kw", [
    (64, 8, 2, 16, {}), (128, 28, 4, 32, {"window": 40}),
    (256, 16, 8, 16, {"softcap": 30.0, "scale": 0.1})])
def test_k1_sp_matches_plain(cuda, hd, H, KV, ps, kw):
    from vgate_tpu_torch.ops.kernels.paged_decode import paged_decode_partial

    gen = torch.Generator(device=cuda).manual_seed(hd)
    pps = 8
    q, k, v, pt, base = _shard(gen, cuda, 4, H, KV, hd, ps, pps, 64,
                               [0.5, 0.0, 1.0, 0.5])
    sl = torch.tensor([pps * ps, 30, 1, 0], dtype=torch.int32, device=cuda)
    runs = [paged_decode_partial(q, k, v, pt, sl, base, **kw)
            for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for r in runs[1:]
               for a, b in zip(runs[0], r)), "three runs differ"
    local, owned = plain.local_pages(pt, base, 64)
    want = plain.partial_paged_attention(
        q.float(), k.float(), v.float(), local, owned, sl,
        window=kw.get("window", 0), softcap=kw.get("softcap", 0.0),
        scale=kw.get("scale"))
    _agree(runs[0], want, f"K1-sp hd={hd}")
    assert (runs[0][2][1] == 0).all()  # slot 1: no page on this rank


@pytest.mark.cuda
@pytest.mark.parametrize("hd,kw", [(64, {}), (128, {"window": 100}),
                                   (256, {"softcap": 30.0, "scale": 0.1})])
def test_k2_ring_matches_plain(cuda, hd, kw):
    from vgate_tpu_torch.ops.kernels.flash_prefill import flash_prefill_partial

    gen = torch.Generator(device=cuda).manual_seed(hd)
    B, n, H, KV = 3, 192, 8, 2
    q = torch.randn(B, n, H, hd, generator=gen, device=cuda).bfloat16()
    k, v = (torch.randn(B, n, KV, hd, generator=gen, device=cuda).bfloat16()
            for _ in range(2))
    # the diagonal hop (ragged), an earlier rank's block, a padded block
    kl = torch.tensor([150, n, 0], dtype=torch.int32, device=cuda)
    off = torch.tensor([0, n, 0], dtype=torch.int32, device=cuda)
    got = flash_prefill_partial(q, k, v, kl, off, **kw)
    want = plain.prefill_partial_attention(q.float(), k.float(), v.float(),
                                           kl, off, **kw)
    torch.cuda.synchronize()
    _agree(got, want, f"K2-ring hd={hd}")
    assert (got[2][2] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("hd,ps,kw", [(64, 16, {}), (128, 32, {"window": 70}),
                                      (256, 16, {"softcap": 30.0})])
def test_k3_sp_matches_plain(cuda, hd, ps, kw):
    from vgate_tpu_torch.ops.kernels.paged_multitok import (
        paged_multitok_partial,
    )

    gen = torch.Generator(device=cuda).manual_seed(hd + ps)
    B, S, H, KV, pps = 3, 64, 8, 2, 12
    _, k, v, pt, base = _shard(gen, cuda, B, H, KV, hd, ps, pps, 64,
                               [0.5, 0.0, 0.5])
    q = torch.randn(B, S, H, hd, generator=gen, device=cuda).bfloat16()
    p0 = torch.tensor([ps * 4, ps * 2, 0], dtype=torch.int32, device=cuda)
    il = torch.tensor([S, 40, 9], dtype=torch.int32, device=cuda)
    got = paged_multitok_partial(q, k, v, pt, p0, il, base, **kw)
    local, owned = plain.local_pages(pt, base, 64)
    want = plain.partial_suffix_attention(
        q.float(), k.float(), v.float(), local, owned, p0, p0 + il,
        window=kw.get("window", 0), softcap=kw.get("softcap", 0.0),
        scale=kw.get("scale"))
    torch.cuda.synchronize()
    real = torch.arange(S, device=cuda)[None, :] < il[:, None]
    _agree(tuple(t[real] for t in got), tuple(t[real] for t in want),
           f"K3-sp hd={hd} ps={ps}")


def _core(devices):
    from vgate_tpu_torch.config import load_config
    from vgate_tpu_torch.runtime.engine_core import EngineCore

    cfg = load_config(
        model={"model_id": MODEL, "dtype": "bfloat16", "max_model_len": 256},
        device={"device": "cuda", "kv_page_size": 16, "kv_num_pages": 128,
                "max_batch_slots": SLOTS, "prefill_buckets": [32, 64, 128],
                "prefix_cache": False, "sp": len(devices),
                "devices": devices if len(devices) > 1 else []},
        logging={"level": "WARNING"},
    )
    return EngineCore(cfg)


def _logits(core, ids, step_token=None):
    """A prompt pass of ``ids`` (one row, its pages on both shards) and
    one decode step, each named to the followers as the engine names its
    own: rank 0's logits of each, fp32 on the host.  The step's token is
    ``step_token``, else the prompt pass's argmax (two engines whose
    prompt logits differ by rounding may part there, at a near-tie)."""
    from vgate_tpu_torch.models.decoder import decode_forward, prefill_forward

    dev, ps = core.device, core.geometry.page_size
    n, S = len(ids), 64
    # every page taken, the row's on both shards (rank 1's from 64)
    taken = core.allocator.allocate(core.allocator.num_free)
    pages = [62, 63, 65, 66, 67]

    def up(a):
        return torch.from_numpy(a).to(dev)

    try:
        tok = np.zeros((1, S), np.int32)
        tok[0, :n] = ids
        sl = np.asarray([n], np.int32)
        pt = np.asarray([pages[:S // ps]], np.int32)
        with torch.no_grad(), core._program("prefill", tokens=tok,
                                            seq_lens=sl, page_tables=pt):
            prompt = prefill_forward(core.params, core.spec, up(tok), up(sl),
                                     core.k_pages, core.v_pages, up(pt))
        tokens = np.zeros(SLOTS, np.int32)
        tokens[0] = (int(prompt[0].argmax()) if step_token is None
                     else step_token)
        positions = np.zeros(SLOTS, np.int32)
        positions[0] = n
        active = np.arange(SLOTS) == 0
        table = np.zeros((SLOTS, core.geometry.pages_per_seq), np.int32)
        table[0, :len(pages)] = pages
        with core._program("decode_state", tokens=tokens,
                           positions=positions, active=active,
                           page_tables=table):
            pass
        with torch.no_grad(), core._program(
                "decode", key=None, num_steps=1, max_position=255,
                graphs=False):
            step = decode_forward(core.params, core.spec, up(tokens),
                                  up(positions), core.k_pages, core.v_pages,
                                  up(table), active=up(active))
            # the step's tokens, as the chunk body broadcasts what it
            # sampled (the followers wait for them)
            if core.mesh.num_devices > 1:
                core.mesh.broadcast(up(tokens))
        torch.cuda.synchronize()
    finally:
        core.allocator.release(taken)
    return prompt[0].float().cpu(), step[0].float().cpu()


def _close(got, want, what):
    """Within 8 bf16 steps of the largest logit: the ring folds per-block
    partials where K2 runs one online softmax."""
    scale = float(want.abs().max())
    tol = 8 * 2.0 ** (np.floor(np.log2(scale)) - 7)
    err = float((got - want).abs().max())
    assert err <= tol, f"{what}: {err} off sp=1's (tolerance {tol})"


def _check_group(devices, graphs):
    from vgate_tpu_torch.models import decoder

    rng = np.random.default_rng(7)
    ids = rng.integers(3, 5000, size=45).tolist()
    prompts = [rng.integers(3, 5000, size=n).tolist() for n in (9, 17, 60)]
    ref = _core(["cuda:0"])
    try:
        want = _logits(ref, ids)
    finally:
        ref.close()
        del ref
        torch.cuda.empty_cache()
    core = _core(devices)
    try:
        assert core.mesh.sp == 2 and core.decode_graphs is graphs
        assert core.allocator.reserved == frozenset({0, 64})
        assert core.k_pages.shape[2] == 64
        for got, w, what in zip(_logits(core, ids), want,
                                ("prompt pass", "decode step")):
            _close(got, w, what)
        launch_counts(reset=True)
        core.reset_follower_launches()
        s0 = core.get_stats()
        [f0] = core.follower_stats()
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
        [f1] = core.follower_stats()
        steps = s1["steps"] - s0["steps"]
        assert ring and s1["prompt_passes"] - s0["prompt_passes"] == len(ring)
        for rank, n in ((0, launch_counts()), (1, f1["kernel_launches"])):
            assert (n["paged_decode_partial"], n["flash_prefill_partial"],
                    n["paged_multitok_partial"]) == (
                24 * steps, 24 * (rank + 1) * len(ring), 0), rank
            assert (n["paged_decode_attention"], n["flash_prefill_attention"],
                    n["paged_multitok_attention"]) == (0, 0, 0), rank
        assert f1["steps"] - f0["steps"] == steps
        if graphs:
            chunks = s1["chunks"] - s0["chunks"]
            assert (s1["decode_graphs"]["replays"]
                    - s0["decode_graphs"]["replays"]) == chunks > 0
            assert (f1["decode_graphs"]["replays"]
                    - f0["decode_graphs"]["replays"]) == chunks
        torch.cuda.synchronize()
        assert not core.k_pages[:, :, 0].any()
        assert not core.v_pages[:, :, 0].any()
        assert f1["memory"]["trash_page_zero"]
    finally:
        core.close()


@pytest.mark.cuda
def test_sp2_on_one_card_matches_sp1_with_exact_launches(cuda):
    _check_group(["cuda:0", "cuda:0"], graphs=False)


@pytest.mark.cuda
def test_sp2_on_two_cards_over_nccl_replays_graphs(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards (one rank a card, NCCL)")
    _check_group(["cuda:0", "cuda:1"], graphs=True)
