"""Host-side helpers of the port's CUDA kernels, on the CPU.

The kernels themselves run only on a card (tests/test_torch_cuda_kernels.py);
what their wrappers and the build decide on the host is plain Python and
is held here: which page sizes the paged multi-token kernel (K3) takes on
bf16 and int8 pools, the engine's refusal of the others when it is built,
how the int8 matmul (K4) plans its tiles, split and grid, and how the
build's ``ptxas -v`` log is attributed to entry functions.
"""

import pytest

from vgate_tpu_torch.config import NotPortedError
from vgate_tpu_torch.ops.kernels import _build, paged_multitok, quant_matmul

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


def _check_plan(rows, in_dim, out_dim, sms):
    config, splits, grid = quant_matmul.k4_plan(rows, in_dim, out_dim, sms)
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
