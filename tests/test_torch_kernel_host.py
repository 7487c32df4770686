"""Host-side helpers of the port's CUDA kernels, on the CPU.

The kernels themselves run only on a card (tests/test_torch_cuda_kernels.py);
what their wrappers and the build decide on the host is plain Python and
is held here: which page sizes the paged multi-token kernel (K3) takes on
bf16 and int8 pools, the engine's refusal of the others when it is built,
how the dequant matmuls (K4, K5) plan their tiles, split and grid, how
the page-split decodes (K6, and K1 on the tensor cores) size their
tiles, stages, chunks, grid, shared memory and workspace and cut each
slot's live range into chunks (and that merging the chunks gives the
unsplit function, fp32, atol = rtol = 2e-5: the same sums in another
order), and how the build's ``ptxas -v`` log is attributed to entry
functions.
"""

import numpy as np
import pytest
import torch

from vgate_tpu_torch.config import NotPortedError
from vgate_tpu_torch.ops import attention
from vgate_tpu_torch.ops.kernels import (
    _build,
    paged_decode,
    paged_multitok,
    quant_matmul,
)

PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z6kernelILi128EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelILi128EEvv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Compiling entry function '_Z6kernelILi256EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelILi256EEvv
    24 bytes stack frame, 24 bytes spill stores, 32 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers
"""


def test_ptxas_lines_sit_under_their_entry():
    entries = _build.ptxas_entries(PTXAS_LOG)
    assert [e for e, _ in entries] == ["_Z6kernelILi128EEvv"] * 2 + [
        "_Z6kernelILi256EEvv"] * 2
    assert "0 bytes spill stores" in entries[0][1]
    assert "Used 168 registers" in entries[1][1]
    assert "24 bytes spill stores" in entries[2][1]
    assert _build.ptxas_entries("ptxas info    : 0 bytes gmem\n") == []


@pytest.mark.parametrize("hd,key_tile", [(64, 128), (128, 128), (256, 64)])
def test_key_tile_follows_the_head_dim(hd, key_tile):
    assert paged_multitok.key_tile(hd) == key_tile


@pytest.mark.parametrize("ps,hd,takes", [
    (16, 128, True), (32, 128, True), (8, 128, True), (128, 128, True),
    (256, 128, True), (16, 256, True), (32, 256, True), (64, 256, True),
    (128, 256, True), (4, 128, False), (24, 128, False), (48, 256, False),
    (96, 128, False),
])
def test_bf16_path_page_sizes(ps, hd, takes):
    """A key tile is whole TMA boxes of min(ps, kN) rows of one page."""
    assert paged_multitok.tma_page_size(ps, hd) is takes


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("hd,ps,takes", [
    (64, 4, False), (64, 8, True), (64, 16, True), (64, 24, False),
    (64, 32, True), (64, 128, True), (64, 192, False), (64, 256, True),
    (128, 4, False), (128, 8, True), (128, 32, True), (128, 96, False),
    (128, 384, True), (256, 4, False), (256, 16, True), (256, 48, False),
    (256, 64, True), (256, 192, True), (256, 200, False),
])
def test_page_sizes_of_both_pool_types(hd, ps, takes, int8):
    """bf16: TMA boxes in whole 8-row swizzle atoms; int8: bulk copies of
    hd-byte rows and 2-byte scales in 16-byte multiples -- both need a
    tile of whole boxes of min(ps, kN) rows of one page."""
    assert paged_multitok.tma_page_size(ps, hd, int8=int8) is takes
    assert (ps in paged_multitok.taken_page_sizes(hd, int8)) is takes


@pytest.mark.parametrize("kv_int8", [False, True])
@pytest.mark.parametrize("prefix_cache,chunk", [(True, 0), (False, 512),
                                                (True, 512)])
def test_engine_refuses_k3_page_sizes_on_cuda(kv_int8, prefix_cache, chunk):
    with pytest.raises(NotPortedError, match="K3") as err:
        paged_multitok.check_engine_page_size(
            "cuda", 4, 128, kv_int8, prefix_cache, chunk)
    pools = "int8" if kv_int8 else "bf16"
    assert f"{pools} pools" in str(err.value)
    assert "8, 16, 32, 64, 128" in str(err.value)


@pytest.mark.parametrize("kv_int8", [False, True])
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_engine_takes_k3_page_sizes_on_cuda(hd, kv_int8):
    paged_multitok.check_engine_page_size("cuda", 32, hd, kv_int8, True, 512)


@pytest.mark.parametrize("ps", [1, 3, 4, 24, 32, 100])
def test_engine_takes_every_page_size_on_the_cpu(ps):
    paged_multitok.check_engine_page_size("cpu", ps, 128, True, True, 512)


@pytest.mark.parametrize("ps", [4, 24])
def test_engine_without_k3_takes_any_page_size(ps):
    """Prefix cache off and no chunking: K3 never runs."""
    paged_multitok.check_engine_page_size("cuda", ps, 128, False, False, 0)


def _check_plan(rows, in_dim, out_dim, sms, plan=quant_matmul.k4_plan):
    config, splits, grid = plan(rows, in_dim, out_dim, sms)
    bm, bn = quant_matmul.K4_TILES[config]
    steps = in_dim // quant_matmul.TILE_IN
    units = -(-rows // bm) * -(-out_dim // bn) * splits
    assert (config == 0) is (rows <= 64)
    assert steps % splits == 0 and (splits == 1 or steps // splits >= 2)
    if config and splits > 1:  # prompt tiles split k only to fill the card
        assert -(-rows // bm) * -(-out_dim // bn) < sms
    assert 1 <= grid <= min(units, sms)
    return config, splits, grid, units


@pytest.mark.parametrize("rows,in_dim,out_dim,want", [
    # the smoke's shapes: decode rows split k to fill the card (the splits
    # measured fastest on an H100); the 2048-row passes take 128 x 256
    # tiles unsplit
    (32, 3584, 18944, (0, 7, 132)), (32, 18944, 3584, (0, 8, 112)),
    (32, 3584, 512, (0, 28, 56)), (32, 3584, 152064, (0, 2, 132)),
    (2048, 3584, 18944, (2, 1, 132)), (2048, 18944, 3584, (2, 1, 132)),
])
def test_k4_plan_at_the_main_path_shapes(rows, in_dim, out_dim, want):
    config, splits, grid, _ = _check_plan(rows, in_dim, out_dim, 132)
    assert (config, splits, grid) == want


@pytest.mark.parametrize("rows", [1, 7, 32, 33, 64, 65, 127, 128, 129,
                                  2047, 2048, 4096])
@pytest.mark.parametrize("in_dim,out_dim", [(512, 192), (3584, 18944),
                                            (18944, 3584), (3584, 512)])
def test_k4_plan_at_ragged_rows(rows, in_dim, out_dim):
    _, _, grid, units = _check_plan(rows, in_dim, out_dim, 132)
    # a card's worth of units fills every SM
    assert grid == min(units, 132)


def test_k4_plan_is_cached():
    """The wrapper asks per call: the plan is a lookup after the first."""
    quant_matmul.k4_plan.cache_clear()
    quant_matmul.k4_plan(32, 3584, 18944, 132)
    quant_matmul.k4_plan(32, 3584, 18944, 132)
    assert quant_matmul.k4_plan.cache_info().hits == 1


@pytest.mark.parametrize("rows,in_dim,out_dim,want", [
    # the smoke's shapes: decode rows take the 64 x 256 tile and split k
    # to fill the card (the plans timed on an H100); the 2048-row passes
    # take 128 x 256 tiles unsplit
    (32, 3584, 18944, (0, 7, 132)), (32, 18944, 3584, (0, 8, 112)),
    (32, 3584, 512, (0, 28, 56)), (32, 3584, 152064, (0, 2, 132)),
    (2048, 3584, 18944, (2, 1, 132)), (2048, 18944, 3584, (2, 1, 132)),
])
def test_k5_plan_at_the_main_path_shapes(rows, in_dim, out_dim, want):
    plan = _check_plan(rows, in_dim, out_dim, 132, quant_matmul.k5_plan)
    assert plan[:3] == want


@pytest.mark.parametrize("rows", [1, 7, 32, 33, 64, 65, 127, 128, 129,
                                  2047, 2048, 4096])
@pytest.mark.parametrize("in_dim,out_dim", [(512, 192), (3584, 18944),
                                            (18944, 3584), (3648, 512)])
def test_k5_plan_at_ragged_rows(rows, in_dim, out_dim):
    """K5 shares K4's tiles and its ``in / 64`` k steps (32 packed rows
    a step), including an in/2 that is an odd number of steps (3648)."""
    _, _, grid, units = _check_plan(rows, in_dim, out_dim, 132,
                                    quant_matmul.k5_plan)
    assert grid == min(units, 132)


def test_k5_plan_is_cached():
    quant_matmul.k5_plan.cache_clear()
    quant_matmul.k5_plan(32, 3584, 18944, 132)
    quant_matmul.k5_plan(32, 3584, 18944, 132)
    assert quant_matmul.k5_plan.cache_info().hits == 1


# ------------------------------------------------------ K6's split plan

# (name, B, H, KV, hd, ps, pps, window): the smoke's Gemma-2-9B decode
# (window and global layers), the 7B decode shape, small card cases
K6_SHAPES = [
    ("gemma_window", 32, 16, 8, 256, 32, 256, 4096),
    ("gemma_global", 32, 16, 8, 256, 32, 256, 0),
    ("qwen_7b", 32, 28, 4, 128, 32, 64, 0),
    ("small_hd64", 8, 8, 8, 64, 16, 16, 100),
    ("small_g7", 8, 14, 2, 256, 16, 16, 64),
]
GEMMA_LENS = [0, 1, 31, 32, 33, 100, 255, 256, 257, 511, 1000, 1024, 1500,
              2047, 2048, 3000, 4000, 4095, 4096, 4097, 4111, 4128, 4500,
              5000, 6000, 6143, 6144, 7000, 7500, 8000, 8191, 8192, 9000]


def _plans():
    for name, B, H, KV, hd, ps, pps, window in K6_SHAPES:
        for bs in (2, 4, 8, 16):
            if B % bs:
                continue
            for elem in (2, 4):
                yield (f"{name}-bs{bs}-{'f32' if elem == 4 else 'bf16'}",
                       (B, H, KV, hd, ps, pps, window, bs, elem, 132))


PLANS = dict(_plans())


@pytest.mark.parametrize("name", list(PLANS))
def test_split_plan_fits_the_card(name):
    B, H, KV, hd, ps, pps, window, bs, elem, sms = PLANS[name]
    plan = paged_decode.split_plan(*PLANS[name])
    T = plan.tile_rows
    assert ps % T == 0 and 2 * T * hd * elem <= paged_decode.STAGE_BYTES
    assert (T * hd * elem) % 16 == 0  # bulk copies of whole 16 bytes
    assert 2 <= plan.stages <= paged_decode.MAX_STAGES
    assert plan.smem <= 232448
    bound = paged_decode.live_tiles_bound(ps, pps, window, T)
    assert plan.max_chunks == -(-bound // plan.chunk_tiles)
    units = B // bs * KV * plan.max_chunks
    assert 1 <= plan.grid <= min(units, sms)
    G = H // KV
    want = B * KV * plan.max_chunks * G * (hd + 2)
    assert plan.workspace == (want if plan.max_chunks > 1 else 0)


@pytest.mark.parametrize("window", [0, 4096])
def test_split_plan_at_the_gemma_shape(window):
    """Gemma-2-9B decode (hd 256, bf16, 32-token pages): a page is a
    tile, the ring holds 6 of them, a chunk 8 of a slot's pages (fewer
    only where the blocks' live-range bound would leave fewer than two
    units a CTA: 16 slots a CTA on a window layer), and the grid fills
    the card."""
    bound = paged_decode.live_tiles_bound(32, 256, window, 32)
    for bs in (2, 4, 8, 16):
        plan = paged_decode.split_plan(32, 16, 8, 256, 32, 256, window, bs,
                                       2, 132)
        assert (plan.tile_rows, plan.stages) == (32, 6)
        assert plan.chunk_tiles == min(8, 32 // bs * 8 * bound // 264)
        assert 32 // bs * 8 * plan.max_chunks >= 2 * 132
        assert plan.grid == 132 and plan.smem + 1024 <= 233472


@pytest.mark.parametrize("name", list(PLANS))
def test_slot_chunks_cover_every_live_page_once(name):
    B, H, KV, hd, ps, pps, window, bs, elem, sms = PLANS[name]
    plan = paged_decode.split_plan(*PLANS[name])
    T = plan.tile_rows
    for seq_len in GEMMA_LENS + [pps * ps - 1, pps * ps, pps * ps + 5]:
        chunks = paged_decode.slot_chunks(seq_len, window, ps, pps, plan)
        sl = min(seq_len, pps * ps)
        lo = max(sl - window, 0) if window else 0
        assert 1 <= len(chunks) <= plan.max_chunks
        if sl == 0:
            assert chunks == [(0, 0)]
            continue
        tiles = [t for a, e in chunks for t in range(a, e)]
        # every live tile once, in order, and nothing else
        assert tiles == list(range(lo // T, -(-sl // T)))
        for a, e in chunks:
            assert e > a and a * T < sl  # no unit starts past seq_len
            assert e - a <= plan.chunk_tiles
        pages = sorted({t * T // ps for t in tiles})
        assert pages == list(range(lo // ps, -(-sl // ps)))


def _split_case(B, H, KV, hd, ps, pps, lens, seed):
    rng = np.random.default_rng(seed)
    P = 1 + B * pps
    q = torch.from_numpy(rng.normal(size=(B, H, hd)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(KV, P, ps, hd)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(KV, P, ps, hd)).astype(np.float32))
    pt = torch.from_numpy(rng.permutation(np.arange(1, P))[: B * pps]
                          .reshape(B, pps).astype(np.int32))
    return q, k, v, pt, torch.tensor(lens, dtype=torch.int32)


@pytest.mark.parametrize("chunk_tiles,kw", [
    (1, {}), (2, {"window": 40}), (3, {"softcap": 30.0, "scale": 0.1}),
    (1, {"window": 17, "softcap": 50.0}),
])
def test_split_then_merge_is_the_unsplit_function(chunk_tiles, kw):
    """K6's arithmetic: chunks reduced to (m, l, acc) and merged in chunk
    order equal the plain version, at chunk edges, mid-tile window
    starts and tiles of half a page."""
    B, H, KV, hd, ps, pps = 6, 8, 2, 64, 16, 8
    lens = [2, 1, 16, 17, 70, 128]
    q, k, v, pt, sl = _split_case(B, H, KV, hd, ps, pps, lens, chunk_tiles)
    plan = paged_decode.SplitPlan(tile_rows=8, stages=2,
                                  chunk_tiles=chunk_tiles,
                                  max_chunks=-(-16 // chunk_tiles), grid=1,
                                  workspace=0, smem=0)
    got = paged_decode.split_decode_plain(q, k, v, pt, sl, plan, **kw)
    expect = attention.paged_decode_attention(
        q, k, v, pt, sl, softcap=kw.get("softcap", 0.0),
        window=kw.get("window"), scale=kw.get("scale"))
    np.testing.assert_allclose(got.numpy(), expect.numpy(), atol=2e-5,
                               rtol=2e-5)


def test_split_then_merge_at_a_planned_shape():
    """The plan's own chunks at a small Gemma-like shape (hd 256, G 2,
    window) through the split model."""
    B, H, KV, hd, ps, pps = 4, 4, 2, 256, 16, 24
    lens = [3, 130, 255, 384]
    q, k, v, pt, sl = _split_case(B, H, KV, hd, ps, pps, lens, 9)
    plan = paged_decode.split_plan(B, H, KV, hd, ps, pps, 100, 2, 4, 4)
    assert plan.max_chunks > 1
    got = paged_decode.split_decode_plain(q, k, v, pt, sl, plan, window=100,
                                          softcap=50.0, scale=1 / 16)
    expect = attention.paged_decode_attention(q, k, v, pt, sl, window=100,
                                              softcap=50.0, scale=1 / 16)
    np.testing.assert_allclose(got.numpy(), expect.numpy(), atol=2e-5,
                               rtol=2e-5)


# ------------------------------------------------------- K1's decode plan

# the smoke's decode lengths: the 7B burst (32 slots, 1..2048) and the
# Gemma-2-9B burst (32 slots, 1..8192)
DECODE_LENS = [1, 31, 32, 33, 64, 65, 100, 127, 128, 129, 255, 256, 257, 300,
               511, 512, 513, 700, 1000, 1023, 1024, 1025, 1200, 1500, 1535,
               1536, 1600, 1800, 2000, 2047, 2048, 2048]
GEMMA_DECODE_LENS = [1, 31, 32, 33, 100, 255, 256, 257, 511, 1000, 1024,
                     1500, 2047, 2048, 3000, 4000, 4095, 4096, 4097, 4111,
                     4128, 4500, 5000, 6000, 6143, 6144, 7000, 7500, 8000,
                     8191, 8192, 8192]
# (name, B, H, KV, hd, ps, pps, window, lens)
K1_SHAPES = [
    ("qwen_7b", 32, 28, 4, 128, 32, 64, 0, DECODE_LENS),
    ("gemma_window", 32, 16, 8, 256, 32, 256, 4096, GEMMA_DECODE_LENS),
    ("gemma_global", 32, 16, 8, 256, 32, 256, 0, GEMMA_DECODE_LENS),
    ("small_ps12_g1", 6, 2, 2, 64, 12, 109, 0, [0, 1, 9, 17, 777, 1308]),
    ("small_ps16_g8", 6, 16, 2, 256, 16, 82, 300, [0, 1, 13, 21, 777, 1312]),
]


def _live_units(plan, lens, window, ps, pps, KV):
    return KV * sum(len(paged_decode.slot_chunks(n, window, ps, pps, plan))
                    for n in lens)


@pytest.mark.parametrize("elem", [2, 1], ids=["bf16", "int8"])
@pytest.mark.parametrize("shape", range(len(K1_SHAPES)))
def test_decode_plan_fits_the_card(shape, elem):
    """A tile divides the page and fits a stage, the ring holds 2 to 12
    stages, shared memory stays within the SM's, the workspace holds every
    chunk's partial, and the scale rows go by bulk copy exactly where a
    page's row of bf16 scales is whole 16 bytes."""
    _, B, H, KV, hd, ps, pps, window, _ = K1_SHAPES[shape]
    plan = paged_decode.decode_plan(B, H, KV, hd, ps, pps, window, elem, 132)
    T = plan.tile_rows
    assert ps % T == 0 and T <= paged_decode.TC_MAX_TILE_ROWS
    stage = paged_decode.tc_stage_bytes(hd, elem, T)
    assert stage <= paged_decode.TC_STAGE_BYTES and stage % 1024 == 0
    assert 2 <= plan.stages <= paged_decode.TC_MAX_STAGES
    assert plan.stages * stage < plan.smem <= 232448
    bound = paged_decode.live_tiles_bound(ps, pps, window, T)
    assert 1 <= plan.chunk_tiles <= paged_decode.TC_CHUNK_TILES
    # a unit's tiles go to different warps: each needs a stage of its own
    assert plan.chunk_tiles <= plan.stages
    assert plan.max_chunks == -(-bound // plan.chunk_tiles)
    assert 1 <= plan.grid <= min(B * KV * plan.max_chunks, 132)
    G = H // KV
    want = B * KV * plan.max_chunks * G * (hd + 2)
    assert plan.workspace == (want if plan.max_chunks > 1 else 0)
    # the in-kernel merge stages a slot's factors in the merge buffer
    assert G * (plan.max_chunks + 1) <= paged_decode.SPLIT_WARPS * G * (hd + 2)
    assert plan.scale_bulk is (elem == 1 and ps % 8 == 0)


@pytest.mark.parametrize("elem,stages", [(2, 11), (1, 12)])
def test_decode_plan_at_the_7b_shape(elem, stages):
    """Qwen2.5-7B decode (hd 128, G 7, pages of 32): a page is a tile,
    chunks of 8 tiles (256 tokens), and the smoke's lengths give at least
    three units a CTA; slots of one chunk write their output directly."""
    plan = paged_decode.decode_plan(32, 28, 4, 128, 32, 64, 0, elem, 132)
    assert (plan.tile_rows, plan.stages, plan.chunk_tiles) == (32, stages, 8)
    assert (plan.max_chunks, plan.grid) == (8, 132)
    units = _live_units(plan, DECODE_LENS, 0, 32, 64, 4)
    assert units >= 3 * 132
    one_chunk = [n for n in DECODE_LENS
                 if len(paged_decode.slot_chunks(n, 0, 32, 64, plan)) == 1]
    assert one_chunk == [n for n in DECODE_LENS if n <= 256]


@pytest.mark.parametrize("window", [0, 4096])
def test_decode_plan_at_the_gemma_shape(window):
    """Gemma-2-9B decode (hd 256, G 2, bf16): 32 KB stages, 6 of them, so
    chunks of 6 tiles (one stage a tile of a unit), and the smoke's
    lengths give many units a CTA."""
    plan = paged_decode.decode_plan(32, 16, 8, 256, 32, 256, window, 2, 132)
    assert (plan.tile_rows, plan.stages, plan.chunk_tiles) == (32, 6, 6)
    assert plan.grid == 132
    units = _live_units(plan, GEMMA_DECODE_LENS, window, 32, 256, 8)
    assert units >= 8 * 132


def test_decode_plan_is_cached():
    paged_decode.decode_plan.cache_clear()
    paged_decode.decode_plan(32, 28, 4, 128, 32, 64, 0, 2, 132)
    paged_decode.decode_plan(32, 28, 4, 128, 32, 64, 0, 2, 132)
    assert paged_decode.decode_plan.cache_info().hits == 1


@pytest.mark.parametrize("elem", [2, 1], ids=["bf16", "int8"])
@pytest.mark.parametrize("shape", range(len(K1_SHAPES)))
def test_slot_chunks_cover_every_live_page_once_under_k1(shape, elem):
    _, B, H, KV, hd, ps, pps, window, lens = K1_SHAPES[shape]
    plan = paged_decode.decode_plan(B, H, KV, hd, ps, pps, window, elem, 132)
    T = plan.tile_rows
    for seq_len in lens + [0, pps * ps - 1, pps * ps + 5]:
        chunks = paged_decode.slot_chunks(seq_len, window, ps, pps, plan)
        sl = min(seq_len, pps * ps)
        lo = max(sl - window, 0) if window else 0
        assert 1 <= len(chunks) <= plan.max_chunks
        if sl == 0:
            assert chunks == [(0, 0)]
            continue
        tiles = [t for a, e in chunks for t in range(a, e)]
        assert tiles == list(range(lo // T, -(-sl // T)))
        assert all(e - a <= plan.chunk_tiles for a, e in chunks)
        pages = sorted({t * T // ps for t in tiles})
        assert pages == list(range(lo // ps, -(-sl // ps)))
